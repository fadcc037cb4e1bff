"""The talos walk solved by FDDP, the port against the JAX package in
float64 on the CPU: the port's ``create_walk_problem(1, 1)`` (N = 5, one
stage per contact phase, nx = 57, ndx = 56, nu = 22) through the port's
``fddp_solve`` against ``jax.jit(fddp_solve)`` on the JAX builder's
problem. xs, us and the gains to 1e-8·max(1, max|ref|), the cost to
1e-8 relative, equal ``conv`` and ``num_iters``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligator_tpu.solvers import FDDPSettings as JSettings
from aligator_tpu.solvers import fddp_solve as jfddp
from examples.talos_walk import create_walk_problem as jax_walk

from aligator_tpu_torch.examples.talos_walk import create_walk_problem
from aligator_tpu_torch.problem import evaluate
from aligator_tpu_torch.solvers import FDDPSettings, fddp_solve

torch.set_num_threads(1)

SETTINGS = dict(tol=1e-4, max_iters=100)
TOL = 1e-8


@pytest.fixture(scope="module")
def walk_fddp():
    jp, _ = jax_walk(1, 1, dtype=jnp.float64)
    s = JSettings(**SETTINGS)
    ref = jax.jit(lambda p: jfddp(p, s))(jp)
    tp, _ = create_walk_problem(1, 1, dtype=torch.float64, device="cpu")
    return ref, fddp_solve(tp, FDDPSettings(**SETTINGS)), tp


def test_walk_fddp_matches_jax(walk_fddp):
    ref, res, _ = walk_fddp
    assert res.xs.shape == (6, 57) and res.us.shape == (5, 22) and res.K.shape == (5, 22, 56)
    assert bool(res.conv) == bool(ref.conv) is True
    assert int(res.num_iters) == int(ref.num_iters)
    for name in ("xs", "us", "kff", "K"):
        a, b = getattr(res, name).numpy(), np.asarray(getattr(ref, name))
        err = float(np.abs(a - b).max())
        assert err <= TOL * max(1.0, float(np.abs(b).max())), f"{name}: {err:.3e}"
    assert abs(float(res.traj_cost) - float(ref.traj_cost)) <= TOL * abs(float(ref.traj_cost))


def test_walk_fddp_closes_the_gaps(walk_fddp):
    """At convergence the rollout is dynamically feasible: the defects are
    below the tolerance, as the JAX solve's infeasibility says."""
    ref, res, tp = walk_fddp
    d = evaluate(tp.replace_x0(tp.x0[None]), res.xs[None], res.us[None])
    assert float(d.dyn_defects.abs().max()) <= SETTINGS["tol"]
    assert float(res.prim_infeas) <= SETTINGS["tol"] and float(ref.prim_infeas) <= SETTINGS["tol"]
    np.testing.assert_allclose(float(res.prim_infeas), float(ref.prim_infeas), rtol=0,
                               atol=1e-10)
