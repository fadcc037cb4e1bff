"""UR5 ballistic throw on the port (counterpart of the repository's
``examples/ur5_ballistic.py``): the arm carries a projectile in its tool
frame and releases it at t_release; the landing condition is the
closed-form ballistic image of the release state, a residual of that
stage's state alone, weighted at the release stage only (a per-stage
cost weight), with the effort bounded.

Run on the card (or ``--device cpu``):

    python -m aligator_tpu_torch.examples.ur5_ballistic
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch
from torch.func import jvp

from aligator_tpu_torch.constraints import BoxConstraint
from aligator_tpu_torch.costs import (
    CostStack,
    QuadraticControlCost,
    QuadraticResidualCost,
    QuadraticStateCost,
)
from aligator_tpu_torch.dynamics.integrators import SemiImplEulerIntegrator
from aligator_tpu_torch.dynamics.multibody import MultibodyFreeFwdDynamics, full_actuation
from aligator_tpu_torch.functions.base import UnaryFunction
from aligator_tpu_torch.functions.basic import ControlErrorResidual
from aligator_tpu_torch.multibody.algorithms import frame_placement
from aligator_tpu_torch.multibody.model import MultibodyModel
from aligator_tpu_torch.multibody.spaces import MultibodyPhaseSpace
from aligator_tpu_torch.multibody.urdf import load_ur5
from aligator_tpu_torch.problem import build_problem
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.tree import shared, static_field

TARGET = (1.6, -0.2, 0.0)  # ground target
T_FLY = 0.45  # s of free flight after the release
U_BOUND = 150.0  # N·m


@dataclasses.dataclass(frozen=True)
class BallisticLandingResidual(UnaryFunction):
    """r(x) = p_tool(q) + ṗ_tool(q, v)·t − ½ g t² ẑ − target: where a
    projectile released from the tool frame at this stage lands after the
    flight time t. ṗ is a JVP through the kinematics (fixed base: q̇ = v)."""

    model: MultibodyModel
    target: torch.Tensor
    t_fly: torch.Tensor
    frame_id: int = static_field()

    def value_x(self, x):
        nq = self.model.nq
        p, pdot = jvp(lambda qq: frame_placement(self.model, qq, self.frame_id).p,
                      (x[:nq],), (x[nq:],))
        g = -self.model.gravity[2:3]
        t = self.t_fly
        drop = torch.cat([p.new_zeros(2), 0.5 * g * t ** 2])
        return p + pdot * t - drop - self.target


def create_ballistic_problem(dt: float = 0.01, t_release: float = 0.6, tf: float = 1.0,
                             dtype=torch.float64, device=None):
    """(problem, model, release stage), built on ``device`` (default: the
    card; raises without one)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    model = load_ur5(dtype, device)
    space = MultibodyPhaseSpace(model)
    nv = nu = model.nv
    x0 = t(np.concatenate([[0.0, -1.2, 1.8, -0.6, -1.57, 0.0], np.zeros(nv)]))
    dyn = SemiImplEulerIntegrator(
        ode=MultibodyFreeFwdDynamics(model=model,
                                     actuation=full_actuation(model, dtype, device)),
        dt=t(dt))
    nsteps, k_rel = int(tf / dt), int(t_release / dt)
    land_res = BallisticLandingResidual(model=model, target=t(TARGET), t_fly=t(T_FLY),
                                        frame_id=model.frame_id("ee_link"))
    rcost = CostStack.create(
        (QuadraticStateCost(space, x0, t(np.diag(np.full(2 * nv, 1e-3)) * dt)), 1.0),
        (QuadraticControlCost(t(np.zeros(nu)), t(1e-5 * np.eye(nu) * dt)), 1.0),
        (QuadraticResidualCost(residual=land_res, W=t(np.eye(3))), 0.0),
    )
    term_cost = QuadraticStateCost(
        space, x0, t(np.diag(np.concatenate([np.full(nv, 1e-2), np.full(nv, 1.0)]))))
    problem = build_problem(
        space, nu, nsteps, x0, shared(dyn), shared(rcost), shared(term_cost),
        constraints=((shared(ControlErrorResidual(target=t(np.zeros(nu)))),
                      BoxConstraint(lower=(-U_BOUND,) * nu, upper=(U_BOUND,) * nu), nu),),
        device=device, dtype=dtype)
    # the landing residual weighs at the release stage only
    weights = list(problem.cost.weights)
    weights[2] = t((np.arange(nsteps) == k_rel).astype(float) * 1e5)[None]
    problem = problem.replace(cost=dataclasses.replace(problem.cost, weights=tuple(weights)))
    return problem, model, k_rel


def landing_miss(model, x_rel, dtype=torch.float64) -> float:
    """‖landing point − target‖ of a release from state ``x_rel``."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=x_rel.device)
    res = BallisticLandingResidual(model=model, target=t(TARGET), t_fly=t(T_FLY),
                                   frame_id=model.frame_id("ee_link"))
    return float(torch.linalg.vector_norm(res.value_x(x_rel)))


def main():
    from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    problem, model, k_rel = create_ballistic_problem(device=args.device)
    res = proxddp_solve(problem, ProxDDPSettings(tol=1e-4, mu_init=1e-2, max_iters=200))
    print(f"converged: {bool(res.conv)}  iters: {int(res.num_iters)}  "
          f"landing miss at release stage {k_rel}: {landing_miss(model, res.xs[k_rel]):.4f} m  "
          f"|u|max: {float(res.us.abs().max()):.1f}")


if __name__ == "__main__":
    main()
