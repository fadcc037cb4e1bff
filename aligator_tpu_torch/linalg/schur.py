"""Fixed-pivot solver for the saddle-point KKT systems of the proximal
Riccati recursion (port of ``aligator_tpu.linalg.schur``):

    KKT = [[ R,  Dᵀ ]
           [ D, -µI ]]

With R ≻ 0 the dual Schur complement S = µI + D R⁻¹ Dᵀ is SPD, and

    z = S⁻¹ (D R⁻¹ b₁ - b₂),   k = R⁻¹ (b₁ - Dᵀ z).

All functions take arbitrary leading batch axes; ``mu`` is a scalar or a
tensor of the batch shape. An indefinite R is *detected*: its factor is
filled with NaN (as ``jnp.linalg.cholesky`` does), which the ProxDDP
solver answers by raising its regularization.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from aligator_tpu_torch.utils import profiling as prof
from aligator_tpu_torch.utils.device import scalar_like


class SaddleFactor(NamedTuple):
    chol_R: torch.Tensor  # (..., n, n) lower Cholesky of R
    chol_S: torch.Tensor  # (..., m, m) lower Cholesky of µI + D R⁻¹ Dᵀ
    D: torch.Tensor  # (..., m, n)
    RiDt: torch.Tensor  # (..., n, m) = R⁻¹ Dᵀ
    mu: torch.Tensor  # (..., 1, 1)


def _mu_b(mu, R: torch.Tensor) -> torch.Tensor:
    """µ as a (..., 1, 1) tensor broadcastable against R's batch."""
    mu = scalar_like(mu, R)
    return mu.reshape(mu.shape + (1, 1))


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor. Where A is not positive definite it is NaN on
    and below the diagonal and zero above, as ``jnp.linalg.cholesky``
    returns it (torch raises there; the solvers rely on the NaN). No host
    sync checks it."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, float("nan")).tril(), L)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ b by two triangular solves, L y = b then Lᵀ x = y (b (..., n,
    p)): LAPACK's potrs. On the card a batch runs as cuBLAS batched trsm,
    which allocates through the caching allocator and reads nothing back to
    the host (``torch.cholesky_solve`` there is MAGMA's batched potrs, which
    calls ``cudaMalloc``/``cudaFree`` and waits for the stream). A NaN factor
    gives NaN."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    prof.count("linalg.chol_solve")
    return cho_solve(L, b)


def kkt_factor(R: torch.Tensor, D: torch.Tensor, mu) -> SaddleFactor:
    """Factor ``[[R, Dᵀ], [D, -µI]]``; R (..., n, n) PD, D (..., m, n)."""
    n, m = R.shape[-1], D.shape[-2]
    mu = _mu_b(mu, R)
    chol_R = cholesky(R)
    if m > 0:
        RiDt = _chol_solve(chol_R, D.mT)
        eye = torch.eye(m, dtype=R.dtype, device=R.device)
        S = mu * eye + D @ RiDt
        chol_S = cholesky(0.5 * (S + S.mT))
    else:
        RiDt = R.new_zeros(R.shape[:-1] + (0,))
        chol_S = R.new_zeros(R.shape[:-2] + (0, 0))
    return SaddleFactor(chol_R, chol_S, D, RiDt, mu)


def kkt_solve(fac: SaddleFactor, b1: torch.Tensor, b2: torch.Tensor):
    """Solve ``[[R, Dᵀ], [D, -µI]] [k; z] = [b1; b2]``; b1 (..., n, p),
    b2 (..., m, p)."""
    Rib1 = _chol_solve(fac.chol_R, b1)
    if fac.D.shape[-2] == 0:
        return Rib1, b2
    z = _chol_solve(fac.chol_S, fac.D @ Rib1 - b2)
    return Rib1 - fac.RiDt @ z, z


def kkt_matvec(R, D, mu, k, z):
    """Apply ``[[R, Dᵀ], [D, -µI]]`` to ``[k; z]``."""
    return R @ k + D.mT @ z, D @ k - _mu_b(mu, R) * z


def kkt_solve_refined(
    R: torch.Tensor,
    D: torch.Tensor,
    mu,
    b1: torch.Tensor,
    b2: torch.Tensor,
    refine_steps: int = 1,
    fac: Optional[SaddleFactor] = None,
):
    """Factor (unless given), solve, then ``refine_steps`` rounds of
    iterative refinement reusing the factor."""
    if fac is None:
        fac = kkt_factor(R, D, mu)
    k, z = kkt_solve(fac, b1, b2)
    for _ in range(refine_steps):
        r1, r2 = kkt_matvec(R, D, fac.mu[..., 0, 0], k, z)
        dk, dz = kkt_solve(fac, b1 - r1, b2 - r2)
        k = k + dk
        z = z + dz
    return k, z
