"""Acrobot swing-up on the port (counterpart of the repository's
``examples/acrobot.py``): a planar double pendulum actuated at the elbow
only (a (nv = 2, nu = 1) actuation matrix), RK2 at dt = 0.01 over 1 s,
and a terminal equality constraint to the upright state.

Run on the card (or ``--device cpu``):

    python -m aligator_tpu_torch.examples.acrobot
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from aligator_tpu_torch.constraints import BoxConstraint, EqualityConstraint
from aligator_tpu_torch.costs import (
    ConstantCost,
    CostStack,
    QuadraticControlCost,
    QuadraticStateCost,
)
from aligator_tpu_torch.dynamics.integrators import RK2Integrator
from aligator_tpu_torch.dynamics.multibody import MultibodyFreeFwdDynamics
from aligator_tpu_torch.functions.basic import ControlErrorResidual, StateErrorResidual
from aligator_tpu_torch.multibody.model import build_serial_chain
from aligator_tpu_torch.multibody.spaces import MultibodyPhaseSpace
from aligator_tpu_torch.problem import build_problem
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.tree import shared

TIMESTEP = 0.01
TF = 1.0
UBOUND = 4.0  # N·m, the elbow torque bound


def create_acrobot_problem(bounds: bool = False, term_cstr: bool = True, dtype=torch.float64,
                           device=None):
    """(problem, model), built on ``device`` (default: the card; raises
    without one)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    model = build_serial_chain(n_links=2, link_length=0.35, link_mass=1.0,
                               axes=[(0, 1, 0), (0, 1, 0)], dtype=dtype, device=device)
    space = MultibodyPhaseSpace(model)
    nu = 1
    x0 = t(np.eye(space.nx)[0] * -1.0)
    # the chain's neutral configuration points up along +z: the upright state
    target = t(np.zeros(space.nx))
    dyn = RK2Integrator(ode=MultibodyFreeFwdDynamics(model=model, actuation=t([[0.0], [1.0]])),
                        dt=t(TIMESTEP))
    rcost = CostStack.create(
        (QuadraticStateCost(space, target, 1e-4 * t(np.eye(space.ndx)) * TIMESTEP), 1.0),
        (QuadraticControlCost(t(np.zeros(nu)), 1e-3 * t(np.eye(nu)) * TIMESTEP), 1.0),
    )
    term_cost = (ConstantCost(t(0.0)) if term_cstr
                 else QuadraticStateCost(space, target, 10.0 * t(np.eye(space.ndx))))
    cstrs = ((shared(ControlErrorResidual(target=t(np.zeros(nu)))),
              BoxConstraint(lower=(-UBOUND,) * nu, upper=(UBOUND,) * nu), nu),) if bounds else ()
    tcstrs = ((shared(StateErrorResidual(target=target, space=space)), EqualityConstraint(),
               space.ndx),) if term_cstr else ()
    problem = build_problem(space, nu, int(TF / TIMESTEP), x0, shared(dyn), shared(rcost),
                            shared(term_cost), constraints=cstrs, term_constraints=tcstrs,
                            device=device, dtype=dtype)
    return problem, model


def main():
    from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    problem, _ = create_acrobot_problem(term_cstr=True, device=args.device)
    res = proxddp_solve(problem, ProxDDPSettings(tol=1e-3, mu_init=1e-2, max_iters=200))
    print(f"converged: {bool(res.conv)}  iters: {int(res.num_iters)}  "
          f"cost: {float(res.traj_cost):.5f}  |xN - upright|: "
          f"{float(torch.linalg.vector_norm(res.xs[-1])):.2e}")


if __name__ == "__main__":
    main()
