"""Humanoid squat through the kinodynamic model on the port (counterpart
of the repository's ``examples/humanoid_squat.py``): the controls are
u = [contact forces (2 × 3D), joint accelerations a_j], and the
free-flyer acceleration follows from the centroidal momentum balance. The
talos-dimension humanoid dips its CoM by 5 cm with both feet in contact,
under a gravity-supporting force reference and a CoM-tracking cost
(ndx = 56, nu = 28, N = 20, Euler at dt = 0.05).

Run on the card (or ``--device cpu``):

    python -m aligator_tpu_torch.examples.humanoid_squat
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
from aligator_tpu_torch.dynamics.integrators import EulerIntegrator
from aligator_tpu_torch.dynamics.multibody import KinodynamicsFwdDynamics
from aligator_tpu_torch.functions.frames import CenterOfMassTranslationResidual
from aligator_tpu_torch.multibody.algorithms import com_position
from aligator_tpu_torch.multibody.model import build_humanoid, humanoid_half_sitting
from aligator_tpu_torch.multibody.spaces import MultibodyPhaseSpace
from aligator_tpu_torch.problem import build_problem
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.tree import shared

DIP = 0.05  # m


def create_squat_problem(nsteps: int = 20, dt: float = 0.05, dtype=torch.float64,
                         device=None):
    """(problem, model, initial CoM), built on ``device`` (default: the
    card; raises without one)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    eye = lambda n: torch.eye(n, dtype=dtype, device=device)
    model = build_humanoid(dtype, device)
    space = MultibodyPhaseSpace(model)
    nv = model.nv
    nk, fs = 2, 3
    nu = nk * fs + (nv - 6)
    q0 = humanoid_half_sitting(model, dtype, device)
    x0 = torch.cat([q0, q0.new_zeros(nv)])

    fids = (model.frame_id("left_sole"), model.frame_id("right_sole"))
    ode = KinodynamicsFwdDynamics(model=model, active=t(np.ones(nk)), frame_ids=fids,
                                  force_size=fs)
    dyn = EulerIntegrator(ode=ode, dt=t(dt))

    mass = float(model.mass.sum())
    com0 = com_position(model, q0)
    com_ref = com0 - t([0.0, 0.0, DIP])
    u_ref = t([0.0, 0.0, mass * 9.81 / 2] * nk + [0.0] * (nv - 6))
    w_u = t(np.diag([1e-5] * (nk * fs) + [1e-3] * (nv - 6)))
    com_res = CenterOfMassTranslationResidual(model=model, ref=com_ref)
    rcost = CostStack.create(
        (QuadraticResidualCost(residual=com_res, W=50.0 * eye(3)), 1.0),
        (QuadraticStateCost(space, x0, 1e-2 * eye(2 * nv)), 1.0),
        (QuadraticControlCost(u_ref, w_u), 1.0),
    )
    term_cost = CostStack.create(
        (QuadraticResidualCost(residual=com_res, W=500.0 * eye(3)), 1.0),
        (QuadraticStateCost(space, x0, t(np.diag([0.0] * nv + [1.0] * nv))), 1.0),
    )
    problem = build_problem(space, nu, nsteps, x0, shared(dyn), shared(rcost),
                            shared(term_cost), device=device, dtype=dtype)
    return problem, model, com0


def com_dip(model, xs, com0) -> float:
    """How far the CoM of the last state of xs (N + 1, nx) sits below
    ``com0``."""
    return float(com0[2] - com_position(model, xs[-1][:model.nq])[2])


def main():
    from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    problem, model, com0 = create_squat_problem(device=args.device)
    res = proxddp_solve(problem, ProxDDPSettings(tol=1e-4, mu_init=1e-2, max_iters=100,
                                                 cost_scale=1e-2))
    print(f"converged: {bool(res.conv)}  iters: {int(res.num_iters)}  "
          f"cost: {float(res.traj_cost):.4f}")
    print(f"CoM z: {float(com0[2]):.4f} -> {float(com0[2]) - com_dip(model, res.xs, com0):.4f} "
          f"(target dip {DIP:.3f} m)")


if __name__ == "__main__":
    main()
