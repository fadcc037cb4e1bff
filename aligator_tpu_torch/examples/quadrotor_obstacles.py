"""Quadrotor flight past convex obstacles on the port (counterpart of the
repository's ``examples/quadrotor_obstacles.py``): a bare free-flyer body
(state on SE(3) × R⁶), a 4-rotor thrust map (nu = 4 < nv = 6) with the
hover box on u, and collision constraints against a convex "mug" (an
octagonal prism of vertices) and a box pillar, through the Frank-Wolfe
distance of ``multibody.geometry``.

Run on the card (or ``--device cpu``):

    python -m aligator_tpu_torch.examples.quadrotor_obstacles
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch.func import vmap

from aligator_tpu_torch.constraints import BoxConstraint, NegativeOrthant
from aligator_tpu_torch.costs import (
    CostStack,
    QuadraticControlCost,
    QuadraticResidualCost,
    QuadraticStateCost,
)
from aligator_tpu_torch.dynamics.integrators import SemiImplEulerIntegrator
from aligator_tpu_torch.dynamics.multibody import MultibodyFreeFwdDynamics
from aligator_tpu_torch.functions.basic import ControlErrorResidual, LinearFunctionComposition
from aligator_tpu_torch.functions.frames import FrameCollisionResidual, FrameTranslationResidual
from aligator_tpu_torch.multibody.algorithms import frame_placement
from aligator_tpu_torch.multibody.geometry import GeomObject, pair_distance
from aligator_tpu_torch.multibody.model import build_serial_chain
from aligator_tpu_torch.multibody.spaces import MultibodyPhaseSpace
from aligator_tpu_torch.problem import build_problem
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.tree import shared

START = (0.0, 0.0, 1.0)
TARGET = (2.0, 0.0, 1.0)
MARGIN = 0.05
BODY_RADIUS = 0.25
ARM = 0.17  # rotor arm (m)
KM = 0.016  # yaw torque / thrust ratio

# the convex "mug" (an octagonal prism) in the corridor
_MUG = tuple(
    (0.12 * float(np.cos(a)), 0.12 * float(np.sin(a)), z)
    for z in (-0.18, 0.18)
    for a in np.linspace(0, 2 * np.pi, 8, endpoint=False)
)


def thrust_matrix(dtype=torch.float64, device=None) -> torch.Tensor:
    """The (nv = 6, nu = 4) generalized-force map: body-z thrust per rotor,
    X-configuration roll and pitch arms, alternating yaw drag."""
    Bm = np.zeros((6, 4))
    Bm[2, :] = 1.0
    Bm[3, :] = ARM * np.array([1.0, -1.0, 1.0, -1.0])
    Bm[4, :] = ARM * np.array([-1.0, -1.0, 1.0, 1.0])
    Bm[5, :] = KM * np.array([1.0, -1.0, -1.0, 1.0])
    return torch.as_tensor(Bm, dtype=dtype, device=device)


def create_quadrotor_problem(nsteps: int = 60, dt: float = 0.05, dtype=torch.float64,
                             device=None):
    """(problem, model, base frame id, (body, mug, pillar)), built on
    ``device`` (default: the card; raises without one)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    # a single free-flyer box body (n_links = 0): the airframe
    model = build_serial_chain(n_links=0, free_flyer=True, dtype=dtype, device=device)
    space = MultibodyPhaseSpace(model)
    nv, nu = model.nv, 4
    u_hover = float(model.mass[0]) * 9.81 / 4.0
    dyn = SemiImplEulerIntegrator(
        ode=MultibodyFreeFwdDynamics(model=model, actuation=thrust_matrix(dtype, device)),
        dt=t(dt))
    q0 = np.zeros(model.nq)
    q0[:3], q0[6] = START, 1.0
    x0 = t(np.concatenate([q0, np.zeros(nv)]))

    base = model.frame_id("tool0")
    w_x = np.concatenate([np.full(3, 1e-2), np.full(3, 1e-1), np.full(6, 1e-1)])
    rcost = CostStack.create(
        (QuadraticStateCost(space, x0, t(np.diag(w_x) * dt)), 1.0),
        (QuadraticControlCost(t(np.full(nu, u_hover)), t(1e-3 * np.eye(nu) * dt)), 1.0),
    )
    goal = FrameTranslationResidual(model=model, ref=t(TARGET), frame_id=base)
    term_cost = CostStack.create(
        (QuadraticResidualCost(residual=goal, W=50.0 * t(np.eye(3))), 1.0),
        (QuadraticStateCost(space, x0, t(np.diag([0.0] * 6 + [1.0] * 6))), 1.0),
    )
    body = GeomObject(frame_id=base, kind="sphere", radius=BODY_RADIUS,
                      offset_p=(0.0, 0.0, -0.1))
    mug = GeomObject(frame_id=-1, kind="convex", radius=0.0, vertices=_MUG,
                     offset_p=(1.0, 0.12, 1.0))
    pillar = GeomObject(frame_id=-1, kind="box", half_extents=(0.12, 0.3, 1.2),
                        offset_p=(1.45, -0.35, 1.2))

    def avoid(obstacle):
        return shared(LinearFunctionComposition(
            inner=FrameCollisionResidual(model=model, geom1=body, geom2=obstacle),
            A=-t(np.eye(1)), b=t([MARGIN])))

    problem = build_problem(
        space, nu, nsteps, x0, shared(dyn), shared(rcost), shared(term_cost),
        constraints=(
            (avoid(mug), NegativeOrthant(), 1),
            (avoid(pillar), NegativeOrthant(), 1),
            (shared(ControlErrorResidual(target=t(np.full(nu, u_hover)))),
             BoxConstraint(lower=(-u_hover,) * nu, upper=(2.0 * u_hover,) * nu), nu),
        ),
        device=device, dtype=dtype)
    return problem, model, base, (body, mug, pillar)


def min_clearances(model, xs, geoms) -> list:
    """[least body-mug distance, least body-pillar distance] along xs
    (N + 1, nx), every state in one batched evaluation."""
    body, mug, pillar = geoms
    return [float(vmap(lambda x: pair_distance(model, x[:model.nq], body, obs))(xs).min())
            for obs in (mug, pillar)]


def main():
    from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    problem, model, base, geoms = create_quadrotor_problem(device=args.device)
    res = proxddp_solve(problem, ProxDDPSettings(tol=1e-3, mu_init=1e-2, max_iters=200))
    pN = frame_placement(model, res.xs[-1][:model.nq], base).p
    clear = min_clearances(model, res.xs, geoms)
    print(f"converged: {bool(res.conv)}  iters: {int(res.num_iters)}  "
          f"final pos: {[round(float(v), 3) for v in pN]}  "
          f"min clearances (mug, pillar): {[round(c, 4) for c in clear]}")


if __name__ == "__main__":
    main()
