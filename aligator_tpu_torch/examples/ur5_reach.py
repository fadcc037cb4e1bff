"""UR5-class reach on the port (counterpart of the repository's
``examples/ur5_reach.py``): the 6R sample chain brings its tool frame to
a target point; state and control regularization, a terminal
frame-translation cost.

Run on the card (or ``--device cpu``):

    python -m aligator_tpu_torch.examples.ur5_reach
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from aligator_tpu_torch.costs import (
    CostStack,
    QuadraticControlCost,
    QuadraticResidualCost,
    QuadraticStateCost,
)
from aligator_tpu_torch.dynamics.integrators import SemiImplEulerIntegrator
from aligator_tpu_torch.dynamics.multibody import MultibodyFreeFwdDynamics, full_actuation
from aligator_tpu_torch.functions.frames import FrameTranslationResidual
from aligator_tpu_torch.multibody.algorithms import frame_placement
from aligator_tpu_torch.multibody.model import build_serial_chain
from aligator_tpu_torch.multibody.spaces import MultibodyPhaseSpace
from aligator_tpu_torch.problem import build_problem
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.tree import shared


def arm_stage_costs(model, space, x0, target, dt, t):
    """The arm's running cost (state and control regularization) and its
    terminal cost (tool translation to ``target``, final velocity), the
    costs of the reach and obstacle examples."""
    nv = model.nv
    w_x = t(np.diag([0.1] * nv + [1.0] * nv) * 1e-2)
    rcost = CostStack.create(
        (QuadraticStateCost(space, x0, w_x * dt), 1.0),
        (QuadraticControlCost(t(np.zeros(nv)), t(1e-4 * np.eye(nv)) * dt), 1.0),
    )
    tool = model.frame_id("tool0")
    frame_res = FrameTranslationResidual(model=model, ref=t(target), frame_id=tool)
    term_cost = CostStack.create(
        (QuadraticResidualCost(residual=frame_res, W=100.0 * t(np.eye(3))), 1.0),
        (QuadraticStateCost(space, x0, t(np.diag([0.0] * nv + [1.0] * nv))), 0.1),
    )
    return rcost, term_cost, tool


def create_ur5_reach_problem(nsteps: int = 40, dt: float = 0.02, target=(0.4, 0.3, 0.4),
                             dtype=torch.float64, device=None):
    """(problem, model, tool frame id), built on ``device`` (default: the
    card; raises without one)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    model = build_serial_chain(n_links=6, dtype=dtype, device=device)
    space = MultibodyPhaseSpace(model)
    dyn = SemiImplEulerIntegrator(
        ode=MultibodyFreeFwdDynamics(model=model,
                                     actuation=full_actuation(model, dtype, device)),
        dt=t(dt))
    x0 = torch.cat([model.neutral_q(dtype, device), t(np.zeros(model.nv))])
    rcost, term_cost, tool = arm_stage_costs(model, space, x0, target, dt, t)
    problem = build_problem(space, model.nv, nsteps, x0, shared(dyn), shared(rcost),
                            shared(term_cost), device=device, dtype=dtype)
    return problem, model, tool


def main():
    from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    problem, model, tool = create_ur5_reach_problem(device=args.device)
    res = proxddp_solve(problem, ProxDDPSettings(tol=1e-4, mu_init=1e-2, max_iters=100))
    tip = frame_placement(model, res.xs[-1][:model.nq], tool).p
    print(f"converged: {bool(res.conv)}  iters: {int(res.num_iters)}  "
          f"cost: {float(res.traj_cost):.5f}")
    print("tool position:", tip.cpu().numpy(), " target: [0.4 0.3 0.4]")
    err = float(torch.linalg.vector_norm(tip - tip.new_tensor([0.4, 0.3, 0.4])))
    print(f"reach error: {err:.4f} m")


if __name__ == "__main__":
    main()
