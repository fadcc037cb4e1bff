"""SE(2) car parking on the port (counterpart of the repository's
``examples/se2_car.py``): a unicycle-like car parks from (0.7, −0.1,
θ = 0.15355) at the origin on the SE(2) manifold, Euler integrator at
dt = 0.05, quadratic running and terminal costs. The car's velocity is
expressed in the body frame, ẋ_local = (v, 0, ω).

Run on the card (or ``--device cpu``):

    python -m aligator_tpu_torch.examples.se2_car
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from aligator_tpu_torch.costs import CostStack, QuadraticControlCost, QuadraticStateCost
from aligator_tpu_torch.dynamics.base import ODE
from aligator_tpu_torch.dynamics.integrators import EulerIntegrator
from aligator_tpu_torch.manifolds.lie import SE2
from aligator_tpu_torch.problem import TrajOptProblem, build_problem
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.tree import shared


@dataclasses.dataclass(frozen=True)
class CarDynamics(ODE):
    """Body-frame unicycle: tangent velocity (v, 0, ω) for u = (v, ω)."""

    def xdot(self, space, x, u):
        v, w = u[..., 0], u[..., 1]
        return torch.stack([v, torch.zeros_like(v), w], dim=-1)


def create_se2_problem(nsteps: int, dtype=torch.float64, device=None) -> TrajOptProblem:
    """Built on ``device`` (default: the card; raises without one)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    space, nu, timestep, theta = SE2(), 2, 0.05, 0.15355
    x0 = t([0.7, -0.1, np.cos(theta), np.sin(theta)])
    x_target = space.neutral(dtype, device)
    w_x = 0.01 * t(np.eye(space.ndx))
    rcost = CostStack.create(
        (QuadraticStateCost(space, x_target, w_x * timestep), 1.0),
        (QuadraticControlCost(t(np.zeros(nu)), t(np.eye(nu)) * timestep), 1.0),
    )
    term_cost = QuadraticStateCost(space, x_target, 10.0 * w_x)
    dyn = EulerIntegrator(ode=CarDynamics(), dt=t(timestep))
    return build_problem(space, nu, nsteps, x0, shared(dyn), shared(rcost), shared(term_cost),
                         device=device, dtype=dtype)


def main():
    from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    problem = create_se2_problem(nsteps=40, device=args.device)
    res = proxddp_solve(problem, ProxDDPSettings(tol=1e-6, mu_init=1e-2, max_iters=100))
    print(f"converged: {bool(res.conv)}  iters: {int(res.num_iters)}  "
          f"cost: {float(res.traj_cost):.6f}")
    print(f"prim: {float(res.prim_infeas):.3e}  dual: {float(res.dual_infeas):.3e}")
    print("final pose:", res.xs[-1].cpu().numpy())


if __name__ == "__main__":
    main()
