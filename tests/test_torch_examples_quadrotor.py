"""The port's quadrotor example (an SE(3) free flyer past a convex mug
and a box pillar; N = 60, dt = 0.05) against the repository's JAX
example on the CPU.

In float64 it is solved to convergence with the JAX example's settings
and matches ``jax.jit(proxddp_solve)`` under ``test_torch_examples``'s
gates (equal ``conv`` and iterations, xs and us to 1e-9·max(1,
max|ref|)), with the outcomes tests/test_breadth_examples.py asserts:
the final position within 5e-2 of the target, every clearance at least
the margin less 2e-3.

In float32 a batch of 4 perturbed scenarios (``chip_smoke.walk_scenarios``:
x0's velocities + 0.01·N(0, 1) from default_rng(7)) is solved through
``lq_solver="pallas"`` (the fused kernels' plain versions on the CPU)
and through "serial", as ``chip_smoke.examples_phase`` runs 16 of them
on the card; the two agree as the walk's do (tests/test_torch_walk.py:
every scenario converges, equal iterations, xs to 1e-8)."""

import numpy as np
import torch

import chip_smoke
from aligator_tpu_torch.examples import quadrotor_obstacles as TQ
from aligator_tpu_torch.multibody.algorithms import frame_placement
from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve
from test_torch_examples import check_same_solve, solve_both

torch.set_num_threads(1)

SETTINGS = dict(tol=1e-3, mu_init=1e-2, max_iters=200)


def test_quadrotor_f64_matches_jax_and_flies_clear():
    from examples.quadrotor_obstacles import create_quadrotor_problem as jax_quad

    tp, model, base, geoms = TQ.create_quadrotor_problem(device="cpu")
    ref, res = solve_both(jax_quad()[0], tp, **SETTINGS)
    check_same_solve(ref, res, conv=True)
    pN = frame_placement(model, res.xs[-1][:model.nq], base).p
    assert float(torch.linalg.vector_norm(pN - pN.new_tensor(TQ.TARGET))) < 5e-2
    for c in TQ.min_clearances(model, res.xs, geoms):
        assert c >= TQ.MARGIN - 2e-3


def quadrotor_batch(batch, dtype=torch.float32):
    problem, model, _, _ = TQ.create_quadrotor_problem(dtype=dtype, device="cpu")
    return chip_smoke.walk_scenarios(problem, model, batch)


def test_quadrotor_f32_batch_fused_matches_serial():
    problem = quadrotor_batch(4)
    fused = proxddp_solve(problem, ProxDDPSettings(lq_solver="pallas", **SETTINGS))
    serial = proxddp_solve(problem, ProxDDPSettings(lq_solver="serial", **SETTINGS))
    assert fused.xs.dtype == torch.float32 and tuple(fused.xs.shape) == (4, 61, 13)
    assert bool(fused.conv.all()) and bool(serial.conv.all())
    assert fused.num_iters.tolist() == serial.num_iters.tolist()
    assert float((fused.xs - serial.xs).abs().max()) <= 1e-8
    # the scenarios differ from one another
    assert float((problem.x0[1:] - problem.x0[:1]).abs().max()) > 1e-3
    assert np.isfinite(fused.traj_cost.numpy()).all()
