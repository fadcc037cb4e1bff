"""The port's Schur KKT solve and serial Riccati recursion
(``aligator_tpu_torch.linalg.schur``, ``aligator_tpu_torch.gar.riccati``)
against the JAX package in float64, on ``gar.random_lqr_problem``
fixtures carried across through numpy. Tolerance 1e-9 (the reference's
KKT gate); both sides run the same fixed-pivot algorithm, so agreement is
at rounding level."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.scipy.linalg

from aligator_tpu import gar as JG
from aligator_tpu.gar import riccati as JR
from aligator_tpu.linalg import schur as JS

from aligator_tpu_torch.convert import lqr_from_numpy
from aligator_tpu_torch.gar import riccati as TR
from aligator_tpu_torch.gar.utils import lqr_kkt_error, lqr_kkt_residuals
from aligator_tpu_torch.linalg import schur as TS
from aligator_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)

TOL = 1e-9
_jit_solve = jax.jit(JR.solve, static_argnames=("refine_steps",))


def _lq(seed, nc=2, nth=0, N=9, nx=7, nu=3):
    return JG.random_lqr_problem(np.random.default_rng(seed), N=N, nx=nx, nu=nu,
                                 nc=nc, nth=nth)


def _to_torch(lq):
    arrays = {f.name: None if getattr(lq, f.name) is None
              else np.asarray(getattr(lq, f.name))
              for f in lq.__dataclass_fields__.values()}
    return lqr_from_numpy(arrays, device="cpu")


def _close(port, ref, tol=TOL, name=""):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=tol,
                               rtol=0, err_msg=name)


@pytest.mark.parametrize("m", [0, 2])
def test_schur_kkt_matches_jax(m):
    rng = np.random.default_rng(m)
    n, p = 4, 3
    W = rng.standard_normal((n, n))
    R = W @ W.T + np.eye(n)
    D = rng.standard_normal((m, n))
    b1, b2 = rng.standard_normal((n, p)), rng.standard_normal((m, p))
    mu = 1e-3
    k_j, z_j = JS.kkt_solve_refined(jnp.asarray(R), jnp.asarray(D), mu,
                                    jnp.asarray(b1), jnp.asarray(b2), refine_steps=1)
    t = lambda a: torch.as_tensor(a)[None]
    fac = TS.kkt_factor(t(R), t(D), torch.tensor([mu], dtype=torch.float64))
    k0, z0 = TS.kkt_solve(fac, t(b1), t(b2))
    k_t, z_t = TS.kkt_solve_refined(t(R), t(D), torch.tensor([mu], dtype=torch.float64),
                                    t(b1), t(b2), refine_steps=1)
    _close(k_t[0], k_j)
    _close(z_t[0], z_j)
    r1, r2 = TS.kkt_matvec(t(R), t(D), torch.tensor([mu], dtype=torch.float64), k0, z0)
    _close(r1[0], b1, 1e-9, "matvec of the unrefined solve")
    _close(r2[0], b2, 1e-9)


def test_schur_flags_indefinite_R_with_nan():
    R = torch.tensor([[[1.0, 2.0], [2.0, 1.0]]], dtype=torch.float64)
    fac = TS.kkt_factor(R, torch.zeros((1, 0, 2), dtype=torch.float64), 1e-3)
    assert torch.isnan(fac.chol_R[0][tuple(np.tril_indices(2))]).all()
    # JAX's factor: NaN on and below the diagonal, zero above
    ref = JS.kkt_factor(jnp.asarray(R[0].numpy()), jnp.zeros((0, 2), jnp.float64), 1e-3)
    np.testing.assert_array_equal(fac.chol_R[0].numpy(), np.asarray(ref.chol_R))


@pytest.mark.parametrize("lead", [(), (4,), (2, 3)], ids=str)
@pytest.mark.parametrize("n", [1, 22, 56])
@pytest.mark.parametrize("p", ["1", "n"])
def test_chol_solve_matches_cholesky_solve_and_jax(lead, n, p):
    """The solve on a Cholesky factor (two triangular solves) against
    ``torch.cholesky_solve`` and JAX's ``cho_solve``, to 1e-12 relative,
    counted once a call under ``linalg.chol_solve``."""
    rng = np.random.default_rng(n)
    W = rng.standard_normal(lead + (n, n))
    A = W @ np.swapaxes(W, -1, -2) / n + np.eye(n)
    b = rng.standard_normal(lead + (n, 1 if p == "1" else n))
    L = torch.linalg.cholesky(torch.as_tensor(A))
    before = prof.counters().get("linalg.chol_solve", 0)
    x = TS._chol_solve(L, torch.as_tensor(b))
    assert prof.counters()["linalg.chol_solve"] == before + 1
    scale = np.abs(x.numpy()).max()
    _close(x, torch.cholesky_solve(torch.as_tensor(b), L), 1e-12 * scale, "torch")
    _close(x, jax.scipy.linalg.cho_solve((jnp.asarray(L.numpy()), True), jnp.asarray(b)),
           1e-12 * scale, "jax")


def test_chol_solve_on_a_nan_factor_gives_nan():
    L = TS.cholesky(torch.tensor([[[1.0, 2.0], [2.0, 1.0]]], dtype=torch.float64))
    assert torch.isnan(TS._chol_solve(L, torch.ones((1, 2, 3), dtype=torch.float64))).all()


def test_initial_solve_counts_five_chol_solves():
    """R⁻¹G0ᵀ in the factor, then R and S in the solve and its refinement."""
    lq = _to_torch(_lq(3))
    gains, vms = TR.backward_sweep(TR.knots_of(lq), 1e-3)
    before = prof.counters().get("linalg.chol_solve", 0)
    TR.initial_solve(lq, vms, 0.0, 1, gains)
    assert prof.counters()["linalg.chol_solve"] == before + 5


@pytest.mark.parametrize("nc", [0, 2])
@pytest.mark.parametrize("mu", [1e-2, 1e-6])
def test_riccati_solve_matches_jax(nc, mu):
    lq = _lq(nc, nc=nc)
    xs, us, vs, lbds, fac = _jit_solve(lq, mu)
    txs, tus, tvs, tlbds, tfac = TR.solve(_to_torch(lq), mu)
    for name in ("kff", "zff", "yff", "K", "Z", "Acl"):
        _close(getattr(tfac.gains, name)[0], getattr(fac.gains, name), name=name)
    _close(tfac.vm.Vxx[0], fac.vm.Vxx, name="Vxx")
    _close(tfac.vm.vx[0], fac.vm.vx, name="vx")
    _close(tfac.x0[0], fac.x0, name="x0")
    for name, a, b in zip(("xs", "us", "vs", "lbds"), (txs, tus, tvs, tlbds),
                          (xs, us, vs, lbds)):
        _close(a[0], b, name=name)
    err = lqr_kkt_error(_to_torch(lq), txs, tus, tvs, tlbds, mu)
    assert float(err["max"][0]) < TOL


def test_riccati_theta_blocks_match_jax():
    lq = _lq(5, nc=2, nth=2)
    theta = np.array([0.3, -0.7])
    xs, us, vs, lbds, fac = _jit_solve(lq, 1e-3, theta=jnp.asarray(theta))
    txs, tus, tvs, tlbds, tfac = TR.solve(
        _to_torch(lq), 1e-3, theta=torch.as_tensor(theta)[None])
    for name, a, b in zip(("xs", "us", "vs", "lbds"), (txs, tus, tvs, tlbds),
                          (xs, us, vs, lbds)):
        _close(a[0], b, name=name)
    _close(tfac.th_grad[0], fac.th_grad, name="th_grad")
    _close(tfac.th_hess[0], fac.th_hess, name="th_hess")
    _close(tfac.x0_th[0], fac.x0_th, name="x0_th")


def test_riccati_batch_of_distinct_problems():
    """A batch of different problems solves row by row like the JAX
    package solves each of them."""
    lqs = [_lq(10 + i) for i in range(3)]
    tps = [_to_torch(lq) for lq in lqs]
    stacked = type(tps[0])(**{
        f: None if getattr(tps[0], f) is None
        else torch.cat([getattr(p, f) for p in tps]) for f in tps[0].__dataclass_fields__
    })
    mus = torch.tensor([1e-2, 1e-4, 1e-6], dtype=torch.float64)
    txs = TR.solve(stacked, mus)[0]
    for i, lq in enumerate(lqs):
        _close(txs[i], _jit_solve(lq, float(mus[i]))[0], name=f"problem {i}")


def test_kkt_residuals_match_jax():
    lq = _lq(7)
    rng = np.random.default_rng(7)
    N, nx, nu, nc = lq.horizon, lq.nx, lq.nu, lq.nc
    xs, us = rng.standard_normal((N + 1, nx)), rng.standard_normal((N + 1, nu))
    vs, lbds = rng.standard_normal((N + 1, nc)), rng.standard_normal((N + 1, nx))
    ref = JG.utils.lqr_kkt_residuals(lq, *(jnp.asarray(a) for a in (xs, us, vs, lbds)),
                                     mueq=1e-3)
    port = lqr_kkt_residuals(_to_torch(lq), *(torch.as_tensor(a)[None]
                                              for a in (xs, us, vs, lbds)), mueq=1e-3)
    for name in ("q", "r", "d", "f", "g0"):
        _close(getattr(port, name)[0], getattr(ref, name), name=name)
    err = JG.lqr_kkt_error(lq, *(jnp.asarray(a) for a in (xs, us, vs, lbds)), 1e-3)
    terr = lqr_kkt_error(_to_torch(lq), *(torch.as_tensor(a)[None]
                                          for a in (xs, us, vs, lbds)), 1e-3)
    for name in ("dyn", "cstr", "dual", "max"):
        assert abs(float(terr[name][0]) - float(err[name])) < TOL, name
