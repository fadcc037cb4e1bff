"""Equilibrated SPD solves for the multibody linear algebra (port of
``aligator_tpu.linalg.spd``).

Talos-class mass matrices have cond(M) ≈ 3·10⁴, so a plain float32
Cholesky solve loses ~3 digits. Two cures, both cheap:

* Jacobi equilibration: solve (D M D)(D⁻¹x) = D b with D = diag(M)^{-1/2},
  a unit-diagonal matrix whose condition reflects coupling, not scale;
* one step of iterative refinement against the original M, reusing the
  factor.

Every function takes one matrix; batches go through ``torch.func.vmap``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SPDFactor(NamedTuple):
    chol: torch.Tensor  # (n, n) lower Cholesky factor of D M D
    scale: torch.Tensor  # (n,) the diagonal of D, diag(M)^{-1/2}
    M: torch.Tensor  # (n, n) the original matrix (for refinement)


def spd_factor(M: torch.Tensor) -> SPDFactor:
    """Jacobi-equilibrated Cholesky factorization of an SPD matrix."""
    s = torch.rsqrt(torch.diagonal(M, dim1=-2, dim2=-1))
    Ms = M * s[..., :, None] * s[..., None, :]
    return SPDFactor(chol=torch.linalg.cholesky(Ms), scale=s, M=M)


def _cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def spd_solve_factored(fac: SPDFactor, b: torch.Tensor, refine_steps: int = 1):
    """Solve M x = b given an :func:`spd_factor`; ``b`` is (n,) or (n, k)."""
    vec = b.dim() == 1
    B = b[:, None] if vec else b
    s = fac.scale[:, None]

    def base_solve(rhs):
        return s * _cho_solve(fac.chol, s * rhs)

    x = base_solve(B)
    for _ in range(refine_steps):
        x = x + base_solve(B - fac.M @ x)
    return x[:, 0] if vec else x


def spd_solve(M: torch.Tensor, b: torch.Tensor, refine_steps: int = 1):
    """Equilibrated and refined SPD solve in one call."""
    return spd_solve_factored(spd_factor(M), b, refine_steps)
