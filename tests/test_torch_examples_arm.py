"""The port's UR5-class arm examples against the repository's JAX
examples in float64 on the CPU, at their published size (the 6R chain,
N = 40, dt = 0.02), solved to convergence with the JAX examples'
settings: equal ``conv`` and iterations, xs and us to 1e-9·max(1,
max|ref|) (``test_torch_examples.check_same_solve``); and the obstacle
example's physical outcome, the tool sphere's least clearance along the
path at least the margin less 2e-3 (tests/test_geometry_box.py). Solved
to convergence rather than capped at a few iterations: the iterates of
the first iterations differ between the packages by more than the
converged solutions do, the rounding of two summation orders amplified
by the conditioning of the Newton steps (the derivative passes agree to rounding), while the
converged solutions agree well inside the gate (``pytest -s`` prints the
errors)."""

import torch

from test_torch_examples import check_same_solve, solve_both

torch.set_num_threads(1)


def test_ur5_reach_matches_jax():
    from examples.ur5_reach import create_ur5_reach_problem as jax_reach

    from aligator_tpu_torch.examples.ur5_reach import create_ur5_reach_problem

    ref, res = solve_both(jax_reach()[0], create_ur5_reach_problem(device="cpu")[0], tol=1e-4,
                          mu_init=1e-2, max_iters=100)
    check_same_solve(ref, res, conv=True)


def test_ur5_obstacle_matches_jax_and_keeps_its_margin():
    from examples.ur5_obstacle import create_ur5_obstacle_problem as jax_obstacle

    from aligator_tpu_torch.examples.ur5_obstacle import (
        MARGIN,
        create_ur5_obstacle_problem,
        min_tool_obstacle_distance,
    )

    tp, model, _, geoms = create_ur5_obstacle_problem(device="cpu")
    ref, res = solve_both(jax_obstacle()[0], tp, tol=1e-4, mu_init=1e-2, max_iters=120)
    check_same_solve(ref, res, conv=True)
    assert min_tool_obstacle_distance(model, res.xs, geoms) >= MARGIN - 2e-3
