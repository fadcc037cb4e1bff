"""Talos-class humanoid multi-contact walk on the port (counterpart of the
repository's ``examples/talos_walk.py``).

Contact phases [DS(T_ds), LEFT(T_ss), DS, RIGHT(T_ss), DS] (LEFT = left
foot in support, the right foot swings to a target whose height follows
a sine of apex 5 cm), 6D sole contacts with Baumgarte Kp = 100 / Kd = 50,
semi-implicit Euler at dt = 0.01, running cost CostStack{state (w_x),
control (1e-3), swing-foot placements (1e4)}, terminal state cost.
nq = 29, nv = 28, nu = 22.

The gait is one stacked problem: contact phases are per-stage ``active``
leaves and swing targets per-stage ``ref_p`` leaves and cost weights.
Stage leaves have a batch axis of 1: a batch of scenarios shares every
leaf and differs only in x0.

Run on the card (or ``--device cpu``):

    python -m portbench.reference.port.examples.talos_walk [--tss 20 --tds 10]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from portbench.reference.port.costs import (
    CostStack,
    QuadraticControlCost,
    QuadraticResidualCost,
    QuadraticStateCost,
)
from portbench.reference.port.dynamics.integrators import SemiImplEulerIntegrator
from portbench.reference.port.dynamics.multibody import (
    MultibodyConstraintFwdDynamics,
    floating_base_actuation,
)
from portbench.reference.port.functions.frames import FramePlacementResidual
from portbench.reference.port.multibody.algorithms import frame_placement
from portbench.reference.port.multibody.contact import anchor_at_configuration, make_contact_set
from portbench.reference.port.multibody.model import humanoid_half_sitting
from portbench.reference.port.multibody.spaces import MultibodyPhaseSpace
from portbench.reference.port.multibody.urdf import load_talos_like
from portbench.reference.port.problem import TrajOptProblem, build_problem
from portbench.reference.port.utils.device import resolve_device
from portbench.reference.port.utils.tree import shared

SWING_APEX = 0.05  # m


def _wx_diag(dtype=torch.float64, device=None) -> torch.Tensor:
    """The reference's w_x diagonal, as a (56, 56) matrix."""
    d = ([0, 0, 0, 10000, 10000, 10000]  # base position / orientation
         + [10] * 6 + [10] * 6  # legs
         + [1000, 1000]  # torso
         + [1] * 4 + [1] * 4  # arms
         + [100] * 6  # base velocity
         + [10, 10, 10, 10, 1, 1] * 2  # leg velocities
         + [1000, 1000]  # torso velocity
         + [10] * 4 + [10] * 4)  # arm velocities
    return torch.diag(torch.tensor(d, dtype=dtype, device=device))


def walk_phases(T_ss: int, T_ds: int):
    """Per-stage (lf_active, rf_active, w_swing_lf, w_swing_rf, z_offset)
    arrays of the DS/LEFT/DS/RIGHT/DS schedule."""
    lf, rf, wl, wr, dz = [], [], [], [], []

    def ds():
        for _ in range(T_ds):
            lf.append(1.0); rf.append(1.0); wl.append(0.0); wr.append(0.0); dz.append(0.0)

    def ss(support_left):
        for ts in range(1, T_ss + 1):
            lf.append(1.0 if support_left else 0.0)
            rf.append(0.0 if support_left else 1.0)
            wl.append(0.0 if support_left else 1.0)
            wr.append(1.0 if support_left else 0.0)
            dz.append(SWING_APEX * np.sin(ts * np.pi / T_ss))

    ds(); ss(True); ds(); ss(False); ds()
    return tuple(np.asarray(a) for a in (lf, rf, wl, wr, dz))


def create_walk_problem(T_ss: int = 20, T_ds: int = 10, dt: float = 0.01,
                        dtype=torch.float64, device=None):
    """(problem, model): the walk of N = 3·T_ds + 2·T_ss stages, built on
    ``device`` (default: the card; raises without one)."""
    device = resolve_device(device)
    model = load_talos_like(dtype, device)
    space = MultibodyPhaseSpace(model)
    nv = model.nv
    nu = nv - 6
    q0 = humanoid_half_sitting(model, dtype, device)
    x0 = torch.cat([q0, q0.new_zeros(nv)])

    contacts = anchor_at_configuration(
        model, make_contact_set(model, (("left_sole", 6), ("right_sole", 6)), kp=100.0,
                                kd=50.0, dtype=dtype, device=device), q0)
    lf, rf, wl, wr, dz = walk_phases(T_ss, T_ds)
    N = len(lf)
    ode = MultibodyConstraintFwdDynamics(
        model=model, actuation=floating_base_actuation(model, dtype, device), contacts=contacts)
    dyn = SemiImplEulerIntegrator(ode=ode, dt=torch.tensor(dt, dtype=dtype, device=device))

    eye = lambda n: torch.eye(n, dtype=dtype, device=device)
    w_x = _wx_diag(dtype, device)
    lf_id, rf_id = model.frame_id("left_sole"), model.frame_id("right_sole")
    LF0, RF0 = frame_placement(model, q0, lf_id), frame_placement(model, q0, rf_id)
    swing = [FramePlacementResidual(model=model, ref_R=M.R, ref_p=M.p, frame_id=fid)
             for M, fid in ((LF0, lf_id), (RF0, rf_id))]
    rcost = CostStack.create(
        (QuadraticStateCost(space, x0, w_x), 1.0),
        (QuadraticControlCost(q0.new_zeros(nu), 1e-3 * eye(nu)), 1.0),
        (QuadraticResidualCost(residual=swing[0], W=1e4 * eye(6)), 0.0),
        (QuadraticResidualCost(residual=swing[1], W=1e4 * eye(6)), 0.0),
    )
    term_cost = QuadraticStateCost(space, x0, w_x)
    problem = build_problem(space, nu, N, x0, shared(dyn), shared(rcost), shared(term_cost),
                            device=device, dtype=dtype)
    return stamp_schedule(problem, (lf, rf, wl, wr, dz), LF0.p, RF0.p), model


def stamp_schedule(problem: TrajOptProblem, phases, lf_p, rf_p) -> TrajOptProblem:
    """Write the per-stage schedule into the stacked leaves: the contact
    ``active`` flags, the swing targets (initial sole position, z raised
    by the phase's offset) and the swing costs' weights."""
    lf, rf, wl, wr, dz = phases
    N = problem.nsteps
    t = lambda a: torch.as_tensor(np.asarray(a)).to(problem.x0)[None]
    ode = problem.dynamics.ode
    dyn = dataclasses.replace(problem.dynamics, ode=dataclasses.replace(
        ode, contacts=ode.contacts.replace(active=t(np.stack([lf, rf], axis=1)))))

    def target(p0):
        ref = p0.expand(N, 3).clone()
        ref[:, 2] += t(dz)[0]
        return ref[None]

    cost = problem.cost
    comps, weights = list(cost.components), list(cost.weights)
    for k, p0, w in ((2, lf_p, wl), (3, rf_p, wr)):
        comps[k] = dataclasses.replace(
            comps[k], residual=dataclasses.replace(comps[k].residual, ref_p=target(p0)))
        weights[k] = t(w)
    cost = dataclasses.replace(cost, components=tuple(comps), weights=tuple(weights))
    return problem.replace(dynamics=dyn, cost=cost)


def main():
    from portbench.reference.port.solvers.proxddp import ProxDDPSettings, solve

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tss", type=int, default=20)
    ap.add_argument("--tds", type=int, default=10)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    problem, model = create_walk_problem(args.tss, args.tds, device=args.device)
    print(f"talos-walk problem: N={problem.nsteps}, ndx={problem.ndx}, nu={problem.nu}")
    res = solve(problem, ProxDDPSettings(tol=1e-4, mu_init=1e-8, max_iters=100))
    print(f"converged: {bool(res.conv)}  iters: {int(res.num_iters)}  "
          f"cost: {float(res.traj_cost):.4f}  prim: {float(res.prim_infeas):.2e}  "
          f"dual: {float(res.dual_infeas):.2e}")
    t_apex = args.tds + args.tss // 2
    z = float(frame_placement(model, res.xs[t_apex][:model.nq],
                              model.frame_id("right_sole")).p[2])
    print(f"right sole z at swing apex stage {t_apex}: {z:.4f} (target ≈ {SWING_APEX:.3f})")


if __name__ == "__main__":
    main()
