"""Torque-limited pendulum swing-up on the port (counterpart of the
repository's ``examples/pendulum.py``).

State x = (θ, ω) with ẋ = (ω, −g·sin θ − b·ω + u), semi-implicit Euler,
the control bound |u| ≤ u_max as a ``ControlErrorResidual`` in a
``BoxConstraint``. u_max is below the static gravity torque, so the
swing-up pumps energy over several cycles; ProxDDP solves it with the
filter step acceptance and the nonlinear rollout.

Run on the card (or ``--device cpu``):

    python -m aligator_tpu_torch.examples.pendulum [--fddp] [--verbose]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from aligator_tpu_torch.constraints import BoxConstraint
from aligator_tpu_torch.costs import CostStack, QuadraticControlCost, QuadraticStateCost
from aligator_tpu_torch.dynamics.integrators import SemiImplEulerIntegrator
from aligator_tpu_torch.functions.basic import ControlErrorResidual
from aligator_tpu_torch.functions.custom import CustomODE
from aligator_tpu_torch.manifolds.vector import VectorSpace
from aligator_tpu_torch.problem import TrajOptProblem, build_problem
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.tree import tree_map


def _xdot(space, x, u):
    th, om = x[0], x[1]
    return torch.stack([om, -9.81 * torch.sin(th) + u[0] - 0.1 * om])


def create_pendulum_problem(nsteps: int = 60, dt: float = 0.05, u_max: float = 6.0,
                            u_weight: float = 1e-3, dtype=torch.float64,
                            device=None) -> TrajOptProblem:
    """g·L·m = 9.81 > u_max: the bound binds and forces energy pumping.
    ``u_max=None`` drops the bound; with ``nsteps=40, u_max=None,
    u_weight=1e-2`` this is the swing-up of tests/test_exact_hessian.py.
    Built on ``device`` (default: the card; raises without one)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    space = VectorSpace(2)
    target = t([np.pi, 0.0])
    dyn = SemiImplEulerIntegrator(ode=CustomODE(fn=_xdot), dt=t(dt))
    rcost = CostStack.create(
        (QuadraticStateCost(space, target, 1e-3 * t(np.eye(2))), 1.0),
        (QuadraticControlCost(t(np.zeros(1)), u_weight * t(np.eye(1))), 1.0),
    )
    tcost = QuadraticStateCost(space, target, 100.0 * t(np.eye(2)))
    shared = lambda obj: tree_map(lambda a: a.unsqueeze(0), obj)
    cstrs = () if u_max is None else (
        (shared(ControlErrorResidual(target=t(np.zeros(1)))),
         BoxConstraint(lower=(-u_max,), upper=(u_max,)), 1),)
    return build_problem(space, 1, nsteps, t(np.zeros(2)), shared(dyn), shared(rcost),
                         shared(tcost), constraints=cstrs, device=device, dtype=dtype)


def main():
    from aligator_tpu_torch.solvers import (
        FDDPSettings,
        ProxDDPSettings,
        fddp_solve,
        proxddp_solve,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fddp", action="store_true", help="solve with FDDP (no bounds)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    problem = create_pendulum_problem(device=args.device)
    if args.fddp:
        # FDDPSettings has no verbose field
        res = fddp_solve(problem, FDDPSettings(tol=1e-5, max_iters=200))
    else:
        res = proxddp_solve(problem, ProxDDPSettings(
            tol=1e-5, mu_init=1e-2, max_iters=400, sa_strategy="filter",
            rollout_type="nonlinear", verbose=args.verbose))
    print(f"converged: {bool(res.conv)}  iters: {int(res.num_iters)}  "
          f"cost: {float(res.traj_cost):.4f}")
    print(f"theta_N = {float(res.xs[-1, 0]):.4f} (target {np.pi:.4f})")
    print(f"max |u| = {float(res.us.abs().max()):.3f} (bound 6.0)")


if __name__ == "__main__":
    main()
