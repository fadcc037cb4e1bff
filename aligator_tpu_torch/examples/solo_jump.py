"""Solo-12 quadruped jump on the port (counterpart of the repository's
``examples/solo_jump.py``): stance, then a flight phase with every
contact off, then the landing stance, on 3D point contacts at the four
feet with soft Baumgarte gains (Kp = 10, Kd = 6); state and control
regularization and phase-gated landing terms (the feet back at their
initial positions with zero velocity at the touchdown stage);
semi-implicit Euler at dt = 0.02 over tf = 0.9 s. nq = 19, nv = 18,
ndx = 36, nu = 12, N = 45.

The jump is one stacked problem: the contact phases are per-stage
``active`` leaves and the landing terms per-stage cost weights, stamped
as ``talos_walk.stamp_schedule`` stamps the walk's. Stage leaves have a
batch axis of 1: a batch of scenarios shares every leaf and differs only
in x0.

Run on the card (or ``--device cpu``):

    python -m aligator_tpu_torch.examples.solo_jump
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from aligator_tpu_torch.costs import (
    CostStack,
    QuadraticControlCost,
    QuadraticResidualCost,
    QuadraticStateCost,
)
from aligator_tpu_torch.dynamics.integrators import SemiImplEulerIntegrator
from aligator_tpu_torch.dynamics.multibody import (
    MultibodyConstraintFwdDynamics,
    floating_base_actuation,
)
from aligator_tpu_torch.functions.frames import FrameTranslationResidual, FrameVelocityResidual
from aligator_tpu_torch.multibody.algorithms import frame_placement
from aligator_tpu_torch.multibody.contact import anchor_at_configuration, make_contact_set
from aligator_tpu_torch.multibody.model import build_quadruped, quadruped_standing
from aligator_tpu_torch.multibody.spaces import MultibodyPhaseSpace
from aligator_tpu_torch.problem import TrajOptProblem, build_problem
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.tree import shared

FEET = ("fl_foot", "fr_foot", "hl_foot", "hr_foot")
SETTINGS = dict(tol=1e-3, mu_init=1e-2, max_iters=200)  # the example's own


def jump_schedule(nsteps: int, k0: int, k1: int, w_land_val: float):
    """Per-stage (active (N, 4), w_land (N,)): every foot in contact
    outside the flight stages [k0, k1); the landing weight at the
    touchdown stage min(k1, N − 1), 0 elsewhere."""
    ks = np.arange(nsteps)
    in_flight = ((ks >= k0) & (ks < k1)).astype(float)
    active = np.tile((1.0 - in_flight)[:, None], (1, len(FEET)))
    return active, (ks == min(k1, nsteps - 1)).astype(float) * w_land_val


def create_jump_problem(dt: float = 0.02, t_takeoff: float = 0.4, t_land: float = 0.6,
                        tf: float = 0.9, kp: float = 10.0, kd: float = 6.0,
                        w_land_val: float = 1e3, dtype=torch.float64, device=None):
    """(problem, model, (k0, k1)): the jump of N = tf/dt stages, takeoff at
    stage k0 and touchdown at k1, built on ``device`` (default: the card;
    raises without one)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    eye = lambda n: torch.eye(n, dtype=dtype, device=device)
    model = build_quadruped(dtype, device)
    space = MultibodyPhaseSpace(model)
    nv = model.nv
    nu = nv - 6
    q0 = quadruped_standing(model, dtype, device)
    x0 = torch.cat([q0, q0.new_zeros(nv)])

    # soft Baumgarte gains: at landing the feet re-anchor from mid-air, and
    # stiff correction blows up the line search's trial rollouts
    contacts = anchor_at_configuration(
        model, make_contact_set(model, tuple((f, 3) for f in FEET), kp=kp, kd=kd,
                                dtype=dtype, device=device), q0)
    nsteps = int(tf / dt)
    k0, k1 = int(t_takeoff / dt), int(t_land / dt)
    ode = MultibodyConstraintFwdDynamics(
        model=model, actuation=floating_base_actuation(model, dtype, device), contacts=contacts)
    dyn = SemiImplEulerIntegrator(ode=ode, dt=t(dt))

    w_x = np.full(space.ndx, 1e-2)
    w_x[:nv] = 1.0
    w_x[3:6] = 0.1
    w_x[nv:nv + 6] = 0.0
    foot_costs = []
    for f in FEET:
        fid = model.frame_id(f)
        foot_costs.append(QuadraticResidualCost(
            residual=FrameTranslationResidual(model=model, ref=frame_placement(model, q0, fid).p,
                                              frame_id=fid), W=eye(3)))
        foot_costs.append(QuadraticResidualCost(
            residual=FrameVelocityResidual(model=model, ref=t(np.zeros(6)), frame_id=fid),
            W=eye(6)))
    rcost = CostStack.create(
        (QuadraticStateCost(space, x0, t(np.diag(w_x) * dt)), 1.0),
        (QuadraticControlCost(t(np.zeros(nu)), t(0.1 * np.eye(nu) * dt)), 1.0),
        *[(fc, 1.0) for fc in foot_costs],
    )
    term_cost = QuadraticStateCost(
        space, x0, t(np.diag(np.concatenate([np.ones(nv), np.full(nv, 1e-2)]))))
    problem = build_problem(space, nu, nsteps, x0, shared(dyn), shared(rcost), shared(term_cost),
                            device=device, dtype=dtype)
    return stamp_schedule(problem, *jump_schedule(nsteps, k0, k1, w_land_val)), model, (k0, k1)


def stamp_schedule(problem: TrajOptProblem, active, w_land) -> TrajOptProblem:
    """Write the per-stage schedule into the stacked leaves: the contacts'
    ``active`` flags and the landing terms' weights (components 2 and up
    of the running cost)."""
    t = lambda a: torch.as_tensor(np.asarray(a)).to(problem.x0)[None]
    ode = problem.dynamics.ode
    dyn = dataclasses.replace(problem.dynamics, ode=dataclasses.replace(
        ode, contacts=ode.contacts.replace(active=t(active))))
    cost = problem.cost
    weights = cost.weights[:2] + (t(w_land),) * (len(cost.weights) - 2)
    return problem.replace(dynamics=dyn, cost=dataclasses.replace(cost, weights=weights))


def base_heights(xs) -> tuple:
    """(start, apex, end) of the base height along xs (..., N + 1, nx)."""
    z = xs[..., 2]
    return z[..., 0], z.max(-1).values, z[..., -1]


def main():
    from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    problem, model, _ = create_jump_problem(device=args.device)
    res = proxddp_solve(problem, ProxDDPSettings(**SETTINGS))
    z0, apex, zN = (float(v) for v in base_heights(res.xs))
    print(f"converged: {bool(res.conv)}  iters: {int(res.num_iters)}  "
          f"cost: {float(res.traj_cost):.4f}")
    print(f"base z: start {z0:.3f}  apex {apex:.3f}  end {zN:.3f}")


if __name__ == "__main__":
    main()
