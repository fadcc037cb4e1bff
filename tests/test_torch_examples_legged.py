"""The port's centroidal and kinodynamic examples (slice 6) against the
repository's JAX examples in float64 on the CPU (the solo jump's in
``test_torch_examples_jump.py``).

- The centroidal CoM shift (N = 30) is solved to convergence in both:
  equal ``conv`` and iterations (137), xs and us to 1e-9·max(1, max|ref|).
- The humanoid squat (kinodynamics, ndx = 56, nu = 28, N = 20) at its
  published size: the built problems are the same (``same_problem``), and
  one ``compute_derivatives`` at x0 and at a seeded trajectory is within
  1e-10·max(1, max|ref|) of the JAX pass (``jax.jit`` of that pass alone
  compiles in about two minutes, the whole solver in four).
- Its full solve against ``jax.jit(proxddp_solve)`` is in the slow tier
  (240 s of JAX on the CPU): equal iterations, 1e-9.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligator_tpu_torch.examples import centroidal as TC
from aligator_tpu_torch.examples import humanoid_squat as TH
from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve
from test_torch_contact_centroidal import check_derivs
from test_torch_examples import check_same_solve, same_problem, solve_both

torch.set_num_threads(1)

SQUAT_SETTINGS = dict(tol=1e-4, mu_init=1e-2, max_iters=100, cost_scale=1e-2)


def test_centroidal_matches_jax_and_keeps_its_cones():
    from examples.centroidal import create_centroidal_problem as jax_centroidal

    ref, res = solve_both(jax_centroidal(), TC.create_centroidal_problem(device="cpu"),
                          tol=1e-6, mu_init=1e-1, max_iters=200)
    check_same_solve(ref, res, conv=True)
    assert int(res.num_iters) == 137
    margin, fz_min = TC.cone_margin(res.us)
    print(f"centroidal: final CoM {res.xs[-1, :3].tolist()}, cone margin {margin:.4f}, "
          f"min f_z {fz_min:.1f} N, cost {float(res.traj_cost):.6f}")
    assert margin <= TC.MU and fz_min > 0.0
    assert float(torch.linalg.vector_norm(res.xs[-1, :3] - res.xs.new_tensor(TC.COM_REF))) < 0.1


def _squat():
    from examples.humanoid_squat import create_squat_problem as jax_squat

    return jax_squat()[0], TH.create_squat_problem(device="cpu")


def _derivs_at_x0_and_seeded(jp, tp, seed):
    """xs, us of two trajectories: x0 held with zero controls, and x0 ⊕
    0.05·N(0, 1) per knot with N(0, 1) controls."""
    rng = np.random.default_rng(seed)
    space, N = jp.space, jp.nsteps
    x0 = np.asarray(jp.x0)
    integ = jax.jit(space.integrate)
    seeded = np.stack([np.asarray(integ(jnp.asarray(x0), jnp.asarray(
        0.05 * rng.standard_normal(space.ndx)))) for _ in range(N + 1)])
    xs = np.stack([np.broadcast_to(x0, seeded.shape), seeded])
    us = np.stack([np.zeros((N, jp.nu)), rng.standard_normal((N, jp.nu))])
    return xs, us


def test_squat_problem_and_derivative_pass_match_jax():
    """The kinodynamic model with 3D contact forces in the problem's
    batched derivative pass at the squat's size."""
    jp, (tp, model, com0) = _squat()
    same_problem(jp, tp)
    assert (tp.nsteps, tp.ndx, tp.nu) == (20, 56, 28)
    err = check_derivs(jp, tp, *_derivs_at_x0_and_seeded(jp, tp, 0), 1e-10, "squat")
    print(f"squat: derivative pass max rel err {err:.3e}")


@pytest.mark.slow
def test_squat_solve_matches_jax():
    jp, (tp, model, com0) = _squat()
    ref, res = solve_both(jp, tp, **SQUAT_SETTINGS)
    check_same_solve(ref, res, conv=True)
    assert abs(TH.com_dip(model, res.xs, com0) - TH.DIP) < 5e-3
