"""The talos walk (slice 2 of the port) against the JAX package, in
float64 on the CPU: the port's ``create_walk_problem`` solved by the
port's ProxDDP against ``jax.jit(proxddp_solve)`` on the JAX builder's
problem, xs and us to 1e-8 with equal ``conv`` and ``num_iters``, at
``create_walk_problem(1, 1)`` (N = 5, one stage per phase) and, in the
slow tier, at ``create_walk_problem(4, 2)`` (N = 14).

Also, at the walk's widths (nx = 56, nu = 22, nc = 0): the backward
kernel's plain version against the JAX Pallas kernel in interpret mode;
and the bench-widths case where the JAX kernel itself breaks (ROADMAP
§C, reference behaviour): at µ = 1e-6 the Pallas kernel's gains are
non-finite where the port's plain version's are finite.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligator_tpu import gar as JG
from aligator_tpu.gar import pallas_riccati as PR
from aligator_tpu.gar import riccati as JR
from aligator_tpu.solvers import ProxDDPSettings as JSettings
from aligator_tpu.solvers import proxddp_solve
from examples.talos_walk import create_walk_problem as jax_walk

import chip_smoke
from aligator_tpu_torch.convert import lqr_from_numpy
from aligator_tpu_torch.examples.talos_walk import create_walk_problem
from aligator_tpu_torch.gar import fused_riccati as FR
from aligator_tpu_torch.gar.riccati import knots_of
from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve as port_solve

torch.set_num_threads(1)

SETTINGS = dict(tol=1e-4, mu_init=1e-8, max_iters=30, riccati_refine=1)
TOL = 1e-8


def _solve_both(T_ss, T_ds):
    jp, _ = jax_walk(T_ss, T_ds, dtype=jnp.float64)
    s = JSettings(**SETTINGS)
    ref = jax.jit(lambda p: proxddp_solve(p, s))(jp)
    tp, _ = create_walk_problem(T_ss, T_ds, dtype=torch.float64, device="cpu")
    return ref, port_solve(tp, ProxDDPSettings(**SETTINGS)), tp


@pytest.fixture(scope="module")
def walk_f64():
    return _solve_both(1, 1)


def _check_walk(ref, res, N):
    assert res.xs.shape == (N + 1, 57) and res.us.shape == (N, 22)
    assert bool(res.conv) == bool(ref.conv) is True
    assert int(res.num_iters) == int(ref.num_iters)
    for name in ("xs", "us"):
        a, b = getattr(res, name).numpy(), np.asarray(getattr(ref, name))
        err = float(np.abs(a - b).max())
        assert err <= TOL * max(1.0, float(np.abs(b).max())), f"{name}: {err:.3e}"
    assert abs(float(res.traj_cost) - float(ref.traj_cost)) <= TOL * abs(float(ref.traj_cost))


def test_walk_problem_matches_jax_builder(walk_f64):
    """The stacked schedule: N, widths, the contact flags and swing
    targets of every stage, and x0."""
    _, _, tp = walk_f64
    jp, _ = jax_walk(1, 1, dtype=jnp.float64)
    assert (tp.nsteps, tp.ndx, tp.nu, tp.nc) == (jp.nsteps, jp.ndx, jp.nu, 0) == (5, 56, 22, 0)
    np.testing.assert_array_equal(tp.x0.numpy(), np.asarray(jp.x0))
    np.testing.assert_array_equal(tp.dynamics.ode.contacts.active[0].numpy(),
                                  np.asarray(jp.dynamics.ode.contacts.active))
    for k in (2, 3):
        np.testing.assert_allclose(tp.cost.components[k].residual.ref_p[0].numpy(),
                                   np.asarray(jp.cost.components[k].residual.ref_p),
                                   rtol=0, atol=1e-15)
        np.testing.assert_array_equal(tp.cost.weights[k][0].numpy(),
                                      np.asarray(jp.cost.weights[k]))


def test_walk_f64_matches_jax(walk_f64):
    ref, res, tp = walk_f64
    _check_walk(ref, res, tp.nsteps)


def test_walk_f64_fused_path_matches_serial(walk_f64):
    """lq_solver="pallas" (the kernels' plain versions on the CPU) gives the
    serial path's solve: same iterations, xs to 1e-8."""
    _, res, tp = walk_f64
    fused = port_solve(tp, ProxDDPSettings(lq_solver="pallas", **SETTINGS))
    assert bool(fused.conv) and int(fused.num_iters) == int(res.num_iters)
    assert float((fused.xs - res.xs).abs().max()) <= TOL


@pytest.mark.slow
def test_walk_small_f64_matches_jax():
    ref, res, tp = _solve_both(4, 2)
    _check_walk(ref, res, tp.nsteps)


def test_walk_entry_point_without_device_raises_on_a_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_walk_problem(1, 1)


# ---------------------------------------------------------------------------
# the backward kernel's plain version at the walk's widths
# ---------------------------------------------------------------------------

LQ_FIELDS = ("Q", "S", "R", "q", "r", "A", "B", "f", "C", "D", "d", "Gx", "Gu", "Gth",
             "gamma", "G0", "g0")


def _jax_knots(arrays, batch):
    """The JAX kernel's stacked knots of a batch of numpy problems."""
    probs = [JG.LQRProblem(**{f: jnp.asarray(arrays[f][b], jnp.float32) for f in LQ_FIELDS})
             for b in range(batch)]
    return jax.tree.map(lambda *a: jnp.stack(a), *[JR.knots_of(p) for p in probs])


@pytest.mark.parametrize("mu", [1e-8, 1e-2])
def test_k1_plain_version_at_walk_widths_matches_pallas(mu):
    """B = 2, N = 14, nx = 56, nu = 22, nc = 0 (chip_smoke's random LQ
    problems), float32, with test_gar_pallas.py's tolerances: gains 2e-4,
    Vxx and vx 1e-3."""
    arrays = chip_smoke.random_lq_arrays(np.random.default_rng(7), 2, 14, 56, 22, 0)
    mub = np.full(2, mu, np.float32)
    g_j, v_j = PR.backward_sweep_batched(_jax_knots(arrays, 2), jnp.asarray(mub))
    tp = lqr_from_numpy(arrays, device="cpu", dtype=torch.float32)
    g_t, v_t = FR.backward_sweep_batched(knots_of(tp), torch.as_tensor(mub))
    for name, tol in (("kff", 2e-4), ("yff", 2e-4), ("K", 2e-4), ("Acl", 2e-4)):
        np.testing.assert_allclose(getattr(g_t, name).numpy(), np.asarray(getattr(g_j, name)),
                                   rtol=0, atol=tol, err_msg=name)
    for name in ("Vxx", "vx"):
        np.testing.assert_allclose(getattr(v_t, name).numpy(), np.asarray(getattr(v_j, name)),
                                   rtol=0, atol=1e-3, err_msg=name)


class _FirstProblems:
    """A numpy Generator seen through ``chip_smoke.random_lq_arrays`` at a
    batch of ``keep``: each draw returns the first ``keep`` problems of a
    batch of ``batch`` and advances the stream past the rest in chunks,
    so the values are those of the full batch without holding it."""

    def __init__(self, rng, keep, batch):
        self.rng, self.keep, self.batch = rng, keep, batch

    def standard_normal(self, shape):
        assert shape[0] == self.keep
        head = self.rng.standard_normal(shape)
        rest = (self.batch - self.keep) * int(np.prod(shape[1:]))
        while rest > 0:
            n = min(rest, 1 << 22)
            self.rng.standard_normal(n)
            rest -= n
        return head


def test_k1_bench_case_mu_1e6_is_reference_behaviour():
    """ROADMAP §C: chip_smoke.kernels_phase's bench case (B = 256, N = 100,
    nx = 56, nu = nc = 22, seed 0 after the six small cases) at µ = 1e-6,
    first 2 problems. The JAX Pallas kernel (interpret mode, float32)
    returns non-finite gains there, so the port's kernel doing the same
    is the reference's behaviour; the serial recursion (the port's plain
    version) stays finite."""
    rng = np.random.default_rng(0)
    for nc in (2, 1, 0):
        for _ in (1e-2, 1e-6):
            chip_smoke.random_lq_arrays(rng, 4, 9, 7, 3, nc)
    arrays = chip_smoke.random_lq_arrays(_FirstProblems(rng, 2, chip_smoke.BATCH), 2,
                                         chip_smoke.NSTEPS, chip_smoke.NX, chip_smoke.NU,
                                         chip_smoke.NU)
    mub = np.full(2, 1e-6, np.float32)
    g_j, v_j = PR.backward_sweep_batched(_jax_knots(arrays, 2), jnp.asarray(mub))
    assert not np.isfinite(np.asarray(g_j.kff)).all(axis=(1, 2)).any()  # both problems
    tp = lqr_from_numpy(arrays, device="cpu", dtype=torch.float32)
    g_t, v_t = FR.backward_sweep_batched(knots_of(tp), torch.as_tensor(mub))
    assert bool(torch.isfinite(g_t.kff).all()) and bool(torch.isfinite(v_t.Vxx).all())
