"""Dense KKT solver for the constrained LQ problem (port of
``aligator_tpu.gar.dense``; ``lq_solver="dense_oracle"``): the monolithic
KKT system of each problem, assembled by ``gar.utils.lqr_dense_matrix``
and solved by a pivoted LU. Exact for every µ ≥ 0 and independent of the
Riccati recursions; its cost grows as the cube of the horizon, so it is
an oracle for small problems."""

from __future__ import annotations

import torch

from aligator_tpu_torch.gar.lqr_problem import LQRProblem
from aligator_tpu_torch.gar.utils import lqr_dense_matrix


def dense_solve(problem: LQRProblem, mueq=0.0):
    """→ (xs, us, vs, lbdas), each (B, N+1, ·); ``lbdas[:, 0]`` holds λ0
    zero-padded to nx. A singular system gives non-finite values (the LU
    is not checked, so the host never waits for the card)."""
    p = problem
    N, nx, nu, nc, nc0 = p.horizon, p.nx, p.nu, p.nc, p.nc0
    mat, rhs = lqr_dense_matrix(p, mueq)
    z = torch.linalg.solve_ex(mat, -rhs.unsqueeze(-1), check_errors=False)[0][..., 0]
    lbd0 = torch.nn.functional.pad(z[:, :nc0], (0, nx - nc0))
    # knot t's block [x, u, v, λ⁺] starts at nc0 + t·stride; the last
    # knot has no λ⁺, so pad z by nx to read all N+1 blocks at once
    stride = nx + nu + nc + nx
    blocks = torch.nn.functional.pad(z[:, nc0:], (0, nx)).reshape(p.batch, N + 1, stride)
    xs, us, vs = (blocks[..., :nx], blocks[..., nx : nx + nu],
                  blocks[..., nx + nu : nx + nu + nc])
    lbds = torch.cat([lbd0.unsqueeze(1), blocks[:, :N, nx + nu + nc :]], dim=1)
    return xs, us, vs, lbds
