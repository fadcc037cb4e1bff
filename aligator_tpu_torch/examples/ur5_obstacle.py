"""UR5-class reach past a box obstacle on the port (counterpart of the
repository's ``examples/ur5_obstacle.py``): the 6R arm reaches a target
while its tool sphere keeps a margin from a box in the workspace, the
path constraint −(d(q) − margin) ≤ 0 as ``LinearFunctionComposition(−1)``
of a ``FrameCollisionResidual`` in a ``NegativeOrthant``.

Run on the card (or ``--device cpu``):

    python -m aligator_tpu_torch.examples.ur5_obstacle
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch.func import vmap

from aligator_tpu_torch.constraints import NegativeOrthant
from aligator_tpu_torch.dynamics.integrators import SemiImplEulerIntegrator
from aligator_tpu_torch.dynamics.multibody import MultibodyFreeFwdDynamics, full_actuation
from aligator_tpu_torch.examples.ur5_reach import arm_stage_costs
from aligator_tpu_torch.functions.basic import LinearFunctionComposition
from aligator_tpu_torch.functions.frames import FrameCollisionResidual
from aligator_tpu_torch.multibody.algorithms import frame_placement
from aligator_tpu_torch.multibody.geometry import GeomObject, pair_distance
from aligator_tpu_torch.multibody.model import build_serial_chain
from aligator_tpu_torch.multibody.spaces import MultibodyPhaseSpace
from aligator_tpu_torch.problem import build_problem
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.tree import shared

TARGET = (0.45, 0.25, 0.35)
BOX_CENTER = (0.57, 0.23, 0.70)  # directly on the unconstrained tool path
BOX_HALF = (0.08, 0.08, 0.08)
MARGIN = 0.02
TOOL_RADIUS = 0.04


def create_ur5_obstacle_problem(nsteps: int = 40, dt: float = 0.02, dtype=torch.float64,
                                device=None):
    """(problem, model, tool frame id, (tool sphere, box)), built on
    ``device`` (default: the card; raises without one)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    model = build_serial_chain(n_links=6, dtype=dtype, device=device)
    space = MultibodyPhaseSpace(model)
    dyn = SemiImplEulerIntegrator(
        ode=MultibodyFreeFwdDynamics(model=model,
                                     actuation=full_actuation(model, dtype, device)),
        dt=t(dt))
    x0 = torch.cat([model.neutral_q(dtype, device), t(np.zeros(model.nv))])
    rcost, term_cost, tool = arm_stage_costs(model, space, x0, TARGET, dt, t)
    tool_sphere = GeomObject(frame_id=tool, kind="sphere", radius=TOOL_RADIUS)
    obstacle = GeomObject(frame_id=-1, kind="box", half_extents=BOX_HALF, offset_p=BOX_CENTER)
    avoid = shared(LinearFunctionComposition(
        inner=FrameCollisionResidual(model=model, geom1=tool_sphere, geom2=obstacle),
        A=-t(np.eye(1)), b=t([MARGIN])))
    problem = build_problem(space, model.nv, nsteps, x0, shared(dyn), shared(rcost),
                            shared(term_cost), constraints=((avoid, NegativeOrthant(), 1),),
                            term_constraints=((avoid, NegativeOrthant(), 1),),
                            device=device, dtype=dtype)
    return problem, model, tool, (tool_sphere, obstacle)


def min_tool_obstacle_distance(model, xs, geoms) -> float:
    """The least tool-obstacle distance along a trajectory xs (N + 1, nx),
    every state in one batched evaluation."""
    return float(vmap(lambda x: pair_distance(model, x[:model.nq], *geoms))(xs).min())


def main():
    from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    problem, model, tool, geoms = create_ur5_obstacle_problem(device=args.device)
    res = proxddp_solve(problem, ProxDDPSettings(tol=1e-4, mu_init=1e-2, max_iters=120))
    tip = frame_placement(model, res.xs[-1][:model.nq], tool).p
    print(f"converged: {bool(res.conv)}  iters: {int(res.num_iters)}  "
          f"cost: {float(res.traj_cost):.5f}")
    err = float(torch.linalg.vector_norm(tip - tip.new_tensor(TARGET)))
    print(f"reach error: {err:.4f} m")
    print(f"min tool-obstacle distance along trajectory: "
          f"{min_tool_obstacle_distance(model, res.xs, geoms):.4f} m (margin {MARGIN:.3f})")


if __name__ == "__main__":
    main()
