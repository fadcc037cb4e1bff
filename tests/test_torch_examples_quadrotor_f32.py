"""The quadrotor example's float32 batch (4 perturbed scenarios,
``test_torch_examples_quadrotor.quadrotor_batch``) through the fused LQ
path in both packages: the port's ``lq_solver="pallas"`` (the kernels'
plain versions on the CPU) against ``jax.vmap(proxddp_solve)`` through
the JAX Pallas kernels in interpret mode, as the JAX tests run them.
Every scenario converges in both, and the traj costs agree to 1e-3
relative (the float32 gate of tests/test_f32_accuracy.py).

The iteration counts are not compared with JAX's, and this file pins
why (ROADMAP §C, reference behaviour): in float32 the JAX package's own
fused and serial solves of these scenarios take different numbers of
iterations, the tol = 1e-3 exit reached after a rounding-dependent
stall, while their costs agree to 1e-3."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from aligator_tpu.solvers import ProxDDPSettings as JSettings
from aligator_tpu.solvers import proxddp_solve as jax_solve
from examples.quadrotor_obstacles import create_quadrotor_problem as jax_quad

from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve
from test_torch_examples_quadrotor import SETTINGS, quadrotor_batch

torch.set_num_threads(1)


def _jax_batch(lq_solver, x0s):
    jp = jax_quad(dtype=jnp.float32)[0]
    s = JSettings(lq_solver=lq_solver, **SETTINGS)
    return jax.jit(jax.vmap(lambda x0: jax_solve(jp.replace_x0(x0), s)))(jnp.asarray(x0s))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())


def test_quadrotor_f32_fused_batch_converges_with_jax():
    problem = quadrotor_batch(4)
    res = proxddp_solve(problem, ProxDDPSettings(lq_solver="pallas", **SETTINGS))
    ref = _jax_batch("pallas", problem.x0.numpy())
    assert np.asarray(ref.xs).dtype == np.float32 and res.xs.dtype == torch.float32
    assert bool(np.asarray(ref.conv).all()) and bool(res.conv.all())
    assert _rel(res.traj_cost.numpy(), ref.traj_cost) <= 1e-3

    # reference behaviour: JAX's fused and serial paths disagree on the
    # iteration counts, not on the solution
    ref_s = _jax_batch("serial", problem.x0.numpy())
    print(f"iterations: port fused {res.num_iters.tolist()}, JAX fused "
          f"{np.asarray(ref.num_iters).tolist()}, JAX serial {np.asarray(ref_s.num_iters).tolist()}"
          f"; traj cost rel diff port vs JAX fused {_rel(res.traj_cost.numpy(), ref.traj_cost):.3e}"
          f", JAX fused vs serial {_rel(ref.traj_cost, ref_s.traj_cost):.3e}")
    assert bool(np.asarray(ref_s.conv).all())
    assert np.asarray(ref.num_iters).tolist() != np.asarray(ref_s.num_iters).tolist()
    assert _rel(ref.traj_cost, ref_s.traj_cost) <= 1e-3
