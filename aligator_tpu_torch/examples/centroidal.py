"""Centroidal CoM shift on the port (counterpart of the repository's
``examples/centroidal.py``): a 40 kg point-mass model on two contact
points shifts its CoM forward while its contact forces stay inside
quadratic friction cones; the controls are the stacked 3D contact forces
(ndx = 9, nu = 6, two cone constraints of 2 rows, N = 30, Euler at
dt = 0.05).

Run on the card (or ``--device cpu``):

    python -m aligator_tpu_torch.examples.centroidal
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from aligator_tpu_torch.constraints import NegativeOrthant
from aligator_tpu_torch.costs import CostStack, QuadraticControlCost, QuadraticResidualCost
from aligator_tpu_torch.dynamics.centroidal import CentroidalFwdDynamics, ContactMap
from aligator_tpu_torch.dynamics.integrators import EulerIntegrator
from aligator_tpu_torch.functions.centroidal import (
    CentroidalCoMResidual,
    CentroidalFrictionConeResidual,
    LinearMomentumResidual,
)
from aligator_tpu_torch.manifolds.vector import VectorSpace
from aligator_tpu_torch.problem import build_problem
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.tree import shared

MASS = 40.0
MU = 0.7
COM_REF = (0.05, 0.0, 0.78)


def create_centroidal_problem(nsteps: int = 30, dt: float = 0.05, dtype=torch.float64,
                              device=None):
    """The CoM-shift problem, built on ``device`` (default: the card;
    raises without one)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    eye = lambda n: torch.eye(n, dtype=dtype, device=device)
    cmap = ContactMap.create(("lf", "rf"), t([[0.0, 0.15, 0.0], [0.0, -0.15, 0.0]]),
                             dtype=dtype, device=device)
    ode = CentroidalFwdDynamics(contact_map=cmap, mass=t(MASS), gravity=t([0.0, 0.0, -9.81]),
                                force_size=3)
    dyn = EulerIntegrator(ode=ode, dt=t(dt))
    com_ref = t(COM_REF)
    cost = CostStack.create(
        (QuadraticResidualCost(residual=CentroidalCoMResidual(ref=com_ref), W=10.0 * eye(3)),
         1.0),
        (QuadraticResidualCost(residual=LinearMomentumResidual(ref=t(np.zeros(3))),
                               W=0.01 * eye(3)), 1.0),
        (QuadraticControlCost(t([0.0, 0.0, MASS * 9.81 / 2] * 2), 1e-4 * eye(6)), 1.0),
    )
    tcost = QuadraticResidualCost(residual=CentroidalCoMResidual(ref=com_ref), W=100.0 * eye(3))
    x0 = t([0.0, 0.0, 0.8, 0, 0, 0, 0, 0, 0])
    cones = tuple((shared(CentroidalFrictionConeResidual(mu=t(MU), epsilon=t(1e-9), k=k)),
                   NegativeOrthant(), 2) for k in range(2))
    return build_problem(VectorSpace(9), 6, nsteps, x0, shared(dyn), shared(cost),
                         shared(tcost), constraints=cones, device=device, dtype=dtype)


def cone_margin(us) -> tuple:
    """(max |f_t|/f_z, min f_z) over the controls (N, 6) of one solve: the
    friction-cone margin against µ, and the least normal force."""
    F = us.reshape(-1, 2, 3)
    fz = F[..., 2]
    tang = torch.linalg.vector_norm(F[..., :2], dim=-1)
    return float((tang / fz).max()), float(fz.min())


def main():
    from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    problem = create_centroidal_problem(device=args.device)
    res = proxddp_solve(problem, ProxDDPSettings(tol=1e-6, mu_init=1e-1, max_iters=200))
    margin, fz_min = cone_margin(res.us)
    print(f"converged: {bool(res.conv)}  iters: {int(res.num_iters)}  "
          f"cost: {float(res.traj_cost):.5f}")
    print(f"final CoM: {[round(float(v), 4) for v in res.xs[-1][:3]]}  (target {COM_REF})")
    print(f"friction-cone margin: max |f_t|/f_z = {margin:.3f} (mu = {MU}); "
          f"min f_z = {fz_min:.1f} N")


if __name__ == "__main__":
    main()
