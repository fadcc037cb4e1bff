"""The talos walk in float32 with the bench's cost normalization
(cost_scale = 1e-4, lq_refine_full = 1, dual tolerance 1e-4): the port's
solve through the fused path (the kernels' plain versions on the CPU)
and ``jax.jit(proxddp_solve)`` on the JAX builder's problem both
converge, with traj costs equal to 1e-3 relative (the gate of
tests/test_f32_accuracy.py), at ``create_walk_problem(1, 1)`` (N = 5)
and, in the slow tier, at ``create_walk_problem(4, 2)`` (N = 14). A
file of its own, so that its JAX compile runs beside the float64 one."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligator_tpu.solvers import ProxDDPSettings as JSettings
from aligator_tpu.solvers import proxddp_solve
from examples.talos_walk import create_walk_problem as jax_walk

from aligator_tpu_torch.examples.talos_walk import create_walk_problem
from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve as port_solve

torch.set_num_threads(1)

SETTINGS = dict(tol=1e-4, dual_tol=1e-4, mu_init=1e-8, max_iters=30, riccati_refine=1,
                cost_scale=1e-4, lq_refine_full=1)


def _solve_both(T_ss, T_ds):
    jp, _ = jax_walk(T_ss, T_ds, dtype=jnp.float32)
    s = JSettings(**SETTINGS)
    ref = jax.jit(lambda p: proxddp_solve(p, s))(jp)
    tp, _ = create_walk_problem(T_ss, T_ds, dtype=torch.float32, device="cpu")
    return ref, port_solve(tp, ProxDDPSettings(lq_solver="pallas", **SETTINGS))


def _check(ref, res):
    assert res.xs.dtype == torch.float32 and np.asarray(ref.xs).dtype == np.float32
    for r in (ref, res):
        assert bool(r.conv)
        assert float(r.prim_infeas) <= 1e-4 and float(r.dual_infeas) <= 1e-4
    c_ref, c = float(ref.traj_cost), float(res.traj_cost)
    assert abs(c - c_ref) <= 1e-3 * max(1.0, abs(c_ref)), (c, c_ref)


def test_walk_f32_converges_with_jax():
    _check(*_solve_both(1, 1))


@pytest.mark.slow
def test_walk_small_f32_converges_with_jax():
    _check(*_solve_both(4, 2))
