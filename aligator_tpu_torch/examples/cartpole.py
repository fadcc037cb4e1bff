"""Cartpole swing-up on the port (counterpart of the repository's
``examples/cartpole.py``): state x = (p, θ, ṗ, θ̇), a bounded cart force,
the pole swung from hanging (θ = 0) to upright (θ = π); the full cartpole
equations of motion, semi-implicit Euler.

Run on the card (or ``--device cpu``):

    python -m aligator_tpu_torch.examples.cartpole
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
from aligator_tpu_torch.utils.tree import shared

M_CART, M_POLE, L_POLE, G = 1.0, 0.3, 0.5, 9.81


def _xdot(space, x, u):
    """The pole's CoM at (p + l sin θ, −l cos θ), hanging at θ = 0:
    (M + m) p̈ + m l θ̈ cos θ − m l θ̇² sin θ = f and l θ̈ + p̈ cos θ + g sin θ = 0."""
    th, pd, thd = x[1], x[2], x[3]
    s, c = torch.sin(th), torch.cos(th)
    f = u[0]
    denom = M_CART + M_POLE * s * s
    pdd = (f + M_POLE * s * (G * c + L_POLE * thd * thd)) / denom
    thdd = (-f * c - M_POLE * L_POLE * thd * thd * s * c
            - (M_CART + M_POLE) * G * s) / (L_POLE * denom)
    return torch.stack([pd, thd, pdd, thdd])


def create_cartpole_problem(nsteps: int = 100, dt: float = 0.05, u_max: float = 5.0,
                            dtype=torch.float64, device=None) -> TrajOptProblem:
    """Built on ``device`` (default: the card; raises without one)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    space = VectorSpace(4)
    target = t([0.0, np.pi, 0.0, 0.0])
    rcost = CostStack.create(
        (QuadraticStateCost(space, target, t(np.diag([0.1, 1e-3, 1e-3, 1e-3])) * dt), 1.0),
        (QuadraticControlCost(t(np.zeros(1)), 1e-3 * t(np.eye(1)) * dt), 1.0),
    )
    tcost = QuadraticStateCost(space, target, t(np.diag([10.0, 100.0, 10.0, 10.0])))
    dyn = SemiImplEulerIntegrator(ode=CustomODE(fn=_xdot), dt=t(dt))
    cstrs = ((shared(ControlErrorResidual(target=t(np.zeros(1)))),
              BoxConstraint(lower=(-u_max,), upper=(u_max,)), 1),)
    return build_problem(space, 1, nsteps, t(np.zeros(4)), shared(dyn), shared(rcost),
                         shared(tcost), constraints=cstrs, device=device, dtype=dtype)


def main():
    from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    problem = create_cartpole_problem(device=args.device)
    # bang-bang solutions chatter at the active-set boundary: a loose tolerance
    res = proxddp_solve(problem, ProxDDPSettings(tol=1e-3, mu_init=1e-2, max_iters=300))
    print(f"converged: {bool(res.conv)}  iters: {int(res.num_iters)}  "
          f"cost: {float(res.traj_cost):.4f}")
    print(f"final pole angle: {float(res.xs[-1, 1]):.4f} rad (target π = {np.pi:.4f}), "
          f"max |u| = {float(res.us.abs().max()):.3f} (bound 5.0)")


if __name__ == "__main__":
    main()
