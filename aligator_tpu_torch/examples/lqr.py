"""Linear quadratic regulator on the port (counterpart of the repository's
``examples/lqr.py``): nx = nu = 3, N = 20, optional control bounds ±0.18
and the terminal equality constraint x_N = 0.1·1.

Run on the card (or ``--device cpu``):

    python -m aligator_tpu_torch.examples.lqr [--bounds] [--term-cstr] [--verbose]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from aligator_tpu_torch.constraints import BoxConstraint, EqualityConstraint
from aligator_tpu_torch.costs import QuadraticCost
from aligator_tpu_torch.dynamics.linear import LinearDiscreteDynamics
from aligator_tpu_torch.functions.basic import ControlErrorResidual, StateErrorResidual
from aligator_tpu_torch.manifolds.vector import VectorSpace
from aligator_tpu_torch.problem import TrajOptProblem, build_problem
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.tree import shared


def create_lqr_problem(bounds: bool = False, term_cstr: bool = False, dtype=torch.float64,
                       device=None) -> TrajOptProblem:
    """Built on ``device`` (default: the card; raises without one)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    nx = nu = 3
    space = VectorSpace(nx)
    A = np.eye(nx)
    A[0, 1], A[1, 0] = -0.2, 0.2
    B = np.eye(nx)
    B[2, :] = 0.4
    dyn = LinearDiscreteDynamics(A=t(A), B=t(B), c=t([0.0, 0.0, 0.1]))
    R = 1e-2 * t(np.eye(nu))
    rcost = QuadraticCost.create(1e-2 * t(np.eye(nx)), R, N=1e-5 * t(np.eye(nx, nu)))
    tcost = QuadraticCost.create(t(np.zeros((nx, nx)) if term_cstr else np.eye(nx)), R)
    cstrs = ((shared(ControlErrorResidual(target=t(np.zeros(nu)))),
              BoxConstraint(lower=(-0.18,) * nu, upper=(0.18,) * nu), nu),) if bounds else ()
    tcstrs = ((shared(StateErrorResidual(target=t(0.1 * np.ones(nx)), space=space)),
               EqualityConstraint(), nx),) if term_cstr else ()
    return build_problem(space, nu, 20, t([0.2, 0.3, -0.1]), shared(dyn), shared(rcost),
                         shared(tcost), constraints=cstrs, term_constraints=tcstrs,
                         device=device, dtype=dtype)


def main():
    from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bounds", action="store_true")
    ap.add_argument("--term-cstr", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    problem = create_lqr_problem(args.bounds, args.term_cstr, device=args.device)
    res = proxddp_solve(problem, ProxDDPSettings(
        tol=1e-8, mu_init=2e-3 if args.bounds else 1e-7, max_iters=20, verbose=args.verbose))
    print(f"converged: {bool(res.conv)}  iters: {int(res.num_iters)}  "
          f"cost: {float(res.traj_cost):.6f}  prim: {float(res.prim_infeas):.2e}  "
          f"dual: {float(res.dual_infeas):.2e}")
    if args.bounds:
        print("max |u|:", float(res.us.abs().max()), "(bound 0.18)")
    if args.term_cstr:
        print("x_N:", res.xs[-1].cpu().numpy(), "(target 0.1)")


if __name__ == "__main__":
    main()
