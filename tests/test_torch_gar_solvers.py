"""The port's LQ-solver layer against the JAX package in float64:
``linalg.block_tridiag``, ``gar.dense``, ``gar.stagedense``,
``gar.parallel`` and ``gar.assoc``, the rest of ``gar.utils`` and
``LQRProblem``'s methods. Three problems drawn by
``gar.random_lqr_problem`` from one numpy seed go through the vmapped JAX
function and, stacked as a batch of 3, through the port.

Tolerances are those of the JAX package's own tests of each solver
(``tests/test_gar_{parallel,assoc,stagedense}.py``), stated per test;
assoc comparisons are relative to the quantity's magnitude (its duals
scale like 1/µ), as there."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligator_tpu import gar as JG
from aligator_tpu.gar import assoc as JA
from aligator_tpu.gar import stagedense as JSD
from aligator_tpu.linalg import block_tridiag as JBT

from aligator_tpu_torch.convert import lqr_from_numpy
from aligator_tpu_torch.gar import assoc as TA
from aligator_tpu_torch.gar import parallel as TP
from aligator_tpu_torch.gar import riccati as TR
from aligator_tpu_torch.gar import stagedense as TSD
from aligator_tpu_torch.gar.dense import dense_solve
from aligator_tpu_torch.gar.utils import (
    lqr_dense_matrix,
    lqr_dense_solve,
    lqr_kkt_error,
    random_lqr_problem,
)
from aligator_tpu_torch.linalg import block_tridiag as TBT

torch.set_num_threads(1)

BATCH = 3


def _jax_batch(seed, N, nx, nu, nc=0, nth=0):
    """BATCH problems drawn one after another from one generator, stacked."""
    rng = np.random.default_rng(seed)
    probs = [JG.random_lqr_problem(rng, N=N, nx=nx, nu=nu, nc=nc, nth=nth)
             for _ in range(BATCH)]
    return jax.tree.map(lambda *a: jnp.stack(a), *probs)


@functools.partial(jax.jit, static_argnums=(0, 3, 4))
def _jvmap_impl(fn, lq, mu, rest, kw):
    return jax.vmap(lambda p, m: fn(p, m, *rest, **dict(kw)), in_axes=(0, None))(lq, mu)


def _jvmap(fn, lq, mu, *rest, **kw):
    """``fn(problem, µ, *rest, **kw)`` vmapped over the batch and jitted,
    with µ traced, so that one compile serves every µ."""
    return _jvmap_impl(fn, lq, jnp.asarray(mu, jnp.float64), rest, tuple(sorted(kw.items())))


def _to_torch(lq):
    return lqr_from_numpy({f: None if getattr(lq, f) is None else np.asarray(getattr(lq, f))
                           for f in lq.__dataclass_fields__}, device="cpu")


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(port, ref, tol, name=""):
    np.testing.assert_allclose(_np(port), _np(ref), atol=tol, rtol=0, err_msg=name)


def _close_scaled(port, ref, tol, name=""):
    """|port − ref| ≤ tol·max(1, max|ref|) (tests/test_gar_assoc.py)."""
    ref = _np(ref)
    if ref.size:
        scale = max(1.0, float(np.abs(ref).max()))
        _close(_np(port) / scale, ref / scale, tol, name)


def _close_traj(port, ref, tol, scaled=False):
    for name, a, b in zip(("xs", "us", "vs", "lbdas"), port, ref):
        (_close_scaled if scaled else _close)(a, b, tol, name)


# ---------------------------------------------------------------- problems


@pytest.mark.parametrize("nc, nth", [(0, 0), (3, 2)])
def test_random_lqr_problem_matches_jax(nc, nth):
    """Problem i of the port's batch is the JAX package's i-th draw: equal."""
    ref = _jax_batch(4, N=6, nx=5, nu=3, nc=nc, nth=nth)
    port = random_lqr_problem(np.random.default_rng(4), 6, 5, 3, nc=nc, nth=nth,
                              device="cpu", batch=BATCH)
    for f in ref.__dataclass_fields__:
        if getattr(ref, f) is None:
            assert getattr(port, f) is None, f
        else:
            np.testing.assert_array_equal(_np(getattr(port, f)), _np(getattr(ref, f)),
                                          err_msg=f)


def test_lqr_problem_methods_match_jax():
    """with_parameterization, knot and cycle_append, element by element."""
    draw = lambda seed: [JG.random_lqr_problem(g, N=5, nx=4, nu=2, nc=1)
                         for g in [np.random.default_rng(seed)] for _ in range(BATCH)]
    refs, news = draw(2), draw(9)
    port = random_lqr_problem(np.random.default_rng(2), 5, 4, 2, nc=1, device="cpu",
                              batch=BATCH)
    new = random_lqr_problem(np.random.default_rng(9), 5, 4, 2, nc=1, device="cpu",
                             batch=BATCH)
    par, knot, cyc = port.with_parameterization(3), port.knot(2), port.cycle_append(new.knot(4))
    assert par.Gv.shape == (BATCH, 6, 1, 3) and par.Gth.shape == (BATCH, 6, 3, 3)
    for i, (ref, new_i) in enumerate(zip(refs, news)):
        cyc_ref = ref.cycle_append(new_i.knot(4))
        par_ref, knot_ref = ref.with_parameterization(3), ref.knot(2)
        for f in ("Q", "S", "A", "f", "C", "d", "Gx", "Gth", "G0"):
            np.testing.assert_array_equal(_np(getattr(knot, f)[i]), _np(getattr(knot_ref, f)))
            np.testing.assert_array_equal(_np(getattr(cyc, f)[i]), _np(getattr(cyc_ref, f)))
            np.testing.assert_array_equal(_np(getattr(par, f)[i]), _np(getattr(par_ref, f)))
        np.testing.assert_array_equal(_np(par.Gv[i]), _np(par_ref.Gv))


# ----------------------------------------------------- block-tridiagonal


def test_block_tridiag_matches_jax():
    """The condensed system's shape: a zero leading block of size 2, then
    blocks of size 4. Solve, Schur blocks, product and refined solve
    against the JAX functions, 1e-10 (the same eliminations in f64)."""
    rng = np.random.default_rng(0)
    sizes = [2, 4, 4, 4, 4]
    diag = [np.zeros((BATCH, 2, 2))]
    for n in sizes[1:]:
        w = rng.standard_normal((BATCH, n, n))
        diag.append(w @ w.transpose(0, 2, 1) + n * np.eye(n))
    upper = [rng.standard_normal((BATCH, a, b)) for a, b in zip(sizes, sizes[1:])]
    rhs = [rng.standard_normal((BATCH, n)) for n in sizes]
    rhs_mat = [rng.standard_normal((BATCH, n, 3)) for n in sizes]
    t = lambda blocks: [torch.as_tensor(b) for b in blocks]
    j = lambda blocks, i: [jnp.asarray(b[i]) for b in blocks]
    got = {
        "solve": TBT.block_tridiag_solve(t(diag), t(upper), t(rhs)),
        "solve_mat": TBT.block_tridiag_solve(t(diag), t(upper), t(rhs_mat)),
        "schur": TBT.block_tridiag_schur(t(diag), t(upper)),
        "matmul": TBT.block_tridiag_matmul(t(diag), t(upper), t(rhs)),
        "refined": TBT.block_tridiag_solve_refined(t(diag), t(upper), t(rhs), 2),
    }
    for i in range(BATCH):
        want = {
            "solve": JBT.block_tridiag_solve(j(diag, i), j(upper, i), j(rhs, i)),
            "solve_mat": JBT.block_tridiag_solve(j(diag, i), j(upper, i), j(rhs_mat, i)),
            "schur": JBT.block_tridiag_schur(j(diag, i), j(upper, i)),
            "matmul": JBT.block_tridiag_matmul(j(diag, i), j(upper, i), j(rhs, i)),
            "refined": JBT.block_tridiag_solve_refined(j(diag, i), j(upper, i), j(rhs, i), 2),
        }
        for name, blocks in want.items():
            for k, b in enumerate(blocks):
                _close(got[name][k][i], b, 1e-10, f"{name} block {k}")


# ------------------------------------------------------------------ dense


def test_lqr_dense_matrix_and_solve_match_jax():
    """The assembled KKT matrix equals the JAX oracle's; its float64 solve
    matches to 1e-9 (the reference's KKT gate)."""
    rng = np.random.default_rng(5)
    refs = [JG.random_lqr_problem(rng, N=6, nx=4, nu=3, nc=2) for _ in range(BATCH)]
    port = random_lqr_problem(np.random.default_rng(5), 6, 4, 3, nc=2, device="cpu",
                              batch=BATCH)
    mu = 1e-3
    mat, rhs = lqr_dense_matrix(port, mu)
    sol = lqr_dense_solve(port, mu)
    for i, ref in enumerate(refs):
        mat_j, rhs_j = JG.lqr_dense_matrix(ref, mu)
        np.testing.assert_array_equal(_np(mat[i]), mat_j)
        np.testing.assert_array_equal(_np(rhs[i]), rhs_j)
        for name, a, b in zip(("xs", "us", "vs", "lbdas"), sol,
                              JG.utils.lqr_dense_solve(ref, mu)):
            _close(a[i], b, 1e-9, name)


def test_dense_solve_matches_jax():
    """tests/test_gar_parallel.py::test_dense_solver_matches_serial's
    problem; 1e-8 as there."""
    lq = _jax_batch(31, N=11, nx=6, nu=4, nc=3)
    mu = 1e-9
    ref = _jvmap(JG.dense_solve, lq, mu)
    _close_traj(dense_solve(_to_torch(lq), mu), ref, 1e-8)


# ------------------------------------------------------------- stagedense


@pytest.mark.parametrize("N", [1, 16])
@pytest.mark.parametrize("nc", [0, 3])
def test_stagedense_matches_jax(N, nc):
    """Trajectories and gains (the Gains view) to 1e-8, the tolerance of
    tests/test_gar_stagedense.py; the KKT residual ≤ 1e-9 there too."""
    lq = _jax_batch(10 + N + nc, N=N, nx=6, nu=4, nc=nc)
    mu = 1e-8
    ref = _jvmap(JSD.solve, lq, mu)
    port_lq = _to_torch(lq)
    xs, us, vs, lbds, fac = TSD.solve(port_lq, mu)
    _close_traj((xs, us, vs, lbds), ref[:4], 1e-8)
    for name in ("kff", "K", "zff", "Z", "yff", "Acl"):
        _close(getattr(fac.gains, name), getattr(ref[4].gains, name), 1e-8, name)
    assert float(lqr_kkt_error(port_lq, xs, us, vs, lbds, mu)["max"].max()) <= 1e-9


def test_stagedense_parametric_theta_matches_jax():
    """θ-gradient and Hessian of the value and the θ-shifted solve, 1e-8
    (tests/test_gar_stagedense.py::test_stagedense_parametric_theta)."""
    lq = _jax_batch(8, N=16, nx=5, nu=3, nc=2, nth=2)
    mu = 1e-9
    theta = np.random.default_rng(1).standard_normal((BATCH, 2))
    fac_j = _jvmap(JSD.backward, lq, mu)
    traj_j = jax.jit(jax.vmap(JSD.forward))(lq, fac_j, jnp.asarray(theta))
    port_lq = _to_torch(lq)
    fac_t = TSD.backward(port_lq, mu)
    traj_t = TSD.forward(port_lq, fac_t, torch.as_tensor(theta))
    for name in ("th_grad", "th_hess", "x0_th", "lbd0"):
        _close(getattr(fac_t, name), getattr(fac_j, name), 1e-8, name)
    _close_traj(traj_t, traj_j, 1e-8)


# --------------------------------------------------------------- parallel


@pytest.mark.parametrize("N, num_legs, tol", [
    (23, 2, 1e-8), (23, 4, 1e-8), (23, 8, 1e-8),
    # N + 1 not divisible by the legs: decoupled pad knots
    (22, 8, 1e-7), (25, 8, 1e-7),
])
def test_parallel_matches_jax(N, num_legs, tol):
    """tests/test_gar_parallel.py's problems and tolerances (1e-8; 1e-7 for
    uneven legs), against the JAX parallel solve and the port's serial one."""
    lq = _jax_batch(17 if N == 23 else 5, N=N, nx=6, nu=4, nc=3)
    mu = 1e-10
    ref = _jvmap(JG.parallel_solve, lq, mu, num_legs)
    port_lq = _to_torch(lq)
    out = TP.parallel_solve(port_lq, mu, num_legs)
    assert out[0].shape == (BATCH, N + 1, 6)
    _close_traj(out, ref, tol)
    _close_traj(out, TR.solve(port_lq, mu)[:4], tol)
    for a, b in zip(TP.make_parallel_solver(num_legs)(port_lq, mu), out):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_parallel_collapsed_gains_match_jax():
    """The collapsed stage-0 feedback equals the serial K₀/Z₀ and the JAX
    package's, 1e-7 (tests/test_gar_parallel.py::test_parallel_collapse_feedback);
    every other gain matches the JAX legs' to 1e-8."""
    lq = _jax_batch(7, N=23, nx=6, nu=4, nc=3)
    mu = 1e-10
    _, g_j = _jvmap(JG.parallel_solve, lq, mu, 4, return_gains=True)
    port_lq = _to_torch(lq)
    _, g_t = TP.parallel_solve(port_lq, mu, 4, return_gains=True)
    serial = TR.backward(port_lq, mu, refine_steps=2).gains
    for name in ("K", "Z"):
        _close(getattr(g_t, name)[:, 0], getattr(g_j, name)[:, 0], 1e-7, name)
        _close(getattr(g_t, name)[:, 0], getattr(serial, name)[:, 0], 1e-7, name)
    for name in g_t._fields:
        _close(getattr(g_t, name)[:, 1:], getattr(g_j, name)[:, 1:], 1e-8, name)


@pytest.mark.parametrize("num_legs", [3, 7, 4])
def test_parallel_nan_terminal_slots(num_legs):
    """With NaN in the unused terminal A, B, f, the JAX parallel solve
    returns NaN in every output (its mask-multiplies read them: reference
    behaviour, ROADMAP C6). 3 and 7 legs divide the 21 knots, so the
    θ-blocks read them; 4 legs need pad knots, so the padding reads them
    too. The port selects and stays finite, equal to
    both packages' parallel and serial solves of the problem with those
    slots zeroed (1e-8)."""
    lq = JG.random_lqr_problem(np.random.default_rng(0), 20, 4, 2, 2)
    lq = jax.tree.map(lambda a: a[None], lq)
    nan, zero = lq, lq
    for f in ("A", "B", "f"):
        a = getattr(lq, f)
        nan = nan.replace(**{f: a.at[:, -1].set(jnp.nan)})
        zero = zero.replace(**{f: a.at[:, -1].set(0.0)})
    mu = 1e-6
    run = lambda p: _jvmap(JG.parallel_solve, p, mu, num_legs)
    assert all(bool(jnp.isnan(a).any()) for a in run(nan))
    port = TP.parallel_solve(_to_torch(nan), mu, num_legs)
    assert all(bool(torch.isfinite(a).all()) for a in port)
    _close_traj(port, run(zero), 1e-8)
    _close_traj(port, _jvmap(JG.riccati_solve, zero, mu)[:4], 1e-8)
    _close_traj(port, TR.solve(_to_torch(zero), mu)[:4], 1e-8)


# ------------------------------------------------------------------ assoc


def _affine(m1, m2):
    return m2[0] @ m1[0], (m2[0] @ m1[1].unsqueeze(-1)).squeeze(-1) + m2[1]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 7, 8, 13])
def test_associative_scan_matches_a_fold(n, reverse):
    """The log-depth scan over a pytree (affine maps, which do not commute)
    equals the sequential fold to 1e-12, forward and from the end."""
    g = torch.Generator().manual_seed(n)
    M = torch.randn(2, n, 3, 3, generator=g, dtype=torch.float64) / 2
    c = torch.randn(2, n, 3, generator=g, dtype=torch.float64)
    fn = (lambda a, b: _affine(a, b)) if not reverse else (lambda a, b: _affine(b, a))
    got = TA.associative_scan(fn, (M, c), reverse=reverse)
    order = range(n - 1, -1, -1) if reverse else range(n)
    acc, want = None, {}
    for t in order:
        cur = (M[:, t], c[:, t])
        acc = cur if acc is None else (_affine(acc, cur) if not reverse else _affine(cur, acc))
        want[t] = acc
    for k in range(2):
        _close(got[k], torch.stack([want[t][k] for t in range(n)], dim=1), 1e-12)


@pytest.mark.parametrize("mu", [1e-2, 1e-6, 1e-11])
@pytest.mark.parametrize("nc", [0, 3])
def test_assoc_matches_jax(nc, mu):
    """tests/test_gar_assoc.py::test_assoc_matches_serial: trajectories to
    1e-8 and Vxx to 1e-6, relative to their magnitude, against the JAX
    assoc solve and the port's serial one."""
    lq = _jax_batch(42, N=23, nx=7, nu=3, nc=nc)
    ref = _jvmap(JA.solve, lq, mu)
    port_lq = _to_torch(lq)
    *traj, fac = TA.solve(port_lq, mu)
    _close_traj(traj, ref[:4], 1e-8, scaled=True)
    _close_traj(traj, TR.solve(port_lq, mu)[:4], 1e-8, scaled=True)
    _close_scaled(fac.vm.Vxx, ref[4].vm.Vxx, 1e-6, "Vxx")


def test_assoc_gains_match_jax():
    """tests/test_gar_assoc.py::test_assoc_gains_match_serial: 1e-8 relative."""
    lq = _jax_batch(3, N=17, nx=5, nu=2, nc=2)
    mu = 1e-8
    fac_j = _jvmap(JA.backward, lq, mu)
    fac_t = TA.backward(_to_torch(lq), mu)
    for name in ("K", "kff", "Z", "Acl"):
        _close_scaled(getattr(fac_t.gains, name), getattr(fac_j.gains, name), 1e-8, name)


def test_assoc_refinement_reaches_serial_accuracy():
    """tests/test_gar_assoc.py::test_assoc_refinement_reaches_serial_accuracy:
    at µ = 1e-11 one KKT-refinement round brings xs within 1e-9 of the
    serial solve and cuts the error by 100; the refined solve matches the
    JAX one to 1e-8 relative."""
    lq = _jax_batch(11, N=25, nx=6, nu=3, nc=2)
    mu = 1e-11
    port_lq = _to_torch(lq)
    xs0 = TA.solve(port_lq, mu, kkt_refine_steps=0)[0]
    *traj1, _ = TA.solve(port_lq, mu, kkt_refine_steps=1)
    xs_s = TR.solve(port_lq, mu)[0]
    err0, err1 = float((xs0 - xs_s).abs().max()), float((traj1[0] - xs_s).abs().max())
    assert err1 < 1e-9 and err1 < err0 * 1e-2
    ref = _jvmap(JA.solve, lq, mu, kkt_refine_steps=1)
    _close_traj(traj1, ref[:4], 1e-8, scaled=True)
