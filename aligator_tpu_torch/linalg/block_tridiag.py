"""Symmetric block-tridiagonal algebra (port of
``aligator_tpu.linalg.block_tridiag``), batched over a leading axis B.

Used to solve the condensed KKT system that couples the legs of the
parallel Riccati solver. Blocks are Python lists (the number of legs is
small and fixed), each block a tensor with the batch as its leading axis;
block sizes may differ (the first block of the condensed system has size
nc0, the others nx). Elimination runs up-looking (last block first)
because the leading diagonal block of the condensed system is exactly zero
and becomes invertible only after absorbing its neighbour's Schur
complement.

Solves use ``torch.linalg.solve_ex`` without its error check: a singular
block gives non-finite values, as ``jnp.linalg.solve`` does, and the card
is never asked for the check's result (no host sync).
"""

from __future__ import annotations

from typing import List

import torch

Blocks = List[torch.Tensor]


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A⁻¹ b for A (B, n, n) and b (B, n) or (B, n, p)."""
    vec = b.dim() == A.dim() - 1
    x = torch.linalg.solve_ex(A, b.unsqueeze(-1) if vec else b, check_errors=False)[0]
    return x.squeeze(-1) if vec else x


def _mul(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M x for x a batch of vectors (B, n) or of matrices (B, n, p)."""
    if x.dim() == M.dim() - 1:
        return (M @ x.unsqueeze(-1)).squeeze(-1)
    return M @ x


def block_tridiag_solve(diag: Blocks, upper: Blocks, rhs: Blocks) -> Blocks:
    """Solve a symmetric block-tridiagonal system. ``diag[i]``:
    (B, n_i, n_i); ``upper[i]``: (B, n_i, n_{i+1}) superdiagonal blocks (the
    subdiagonal is ``upper[i]ᵀ``); ``rhs[i]``: (B, n_i) or (B, n_i, p)."""
    M = len(diag)
    assert len(upper) == M - 1 and len(rhs) == M
    dtil, btil = list(diag), list(rhs)
    for i in range(M - 2, -1, -1):
        u = upper[i]
        dtil[i] = dtil[i] - u @ _solve(dtil[i + 1], u.mT)
        btil[i] = btil[i] - _mul(u, _solve(dtil[i + 1], btil[i + 1]))
    xs = [_solve(dtil[0], btil[0])]
    for i in range(1, M):
        xs.append(_solve(dtil[i], btil[i] - _mul(upper[i - 1].mT, xs[i - 1])))
    return xs


def block_tridiag_schur(diag: Blocks, upper: Blocks) -> Blocks:
    """The up-looking Schur-complemented diagonal blocks D̃ᵢ of
    :func:`block_tridiag_solve`: the back-substitution is
    xᵢ = D̃ᵢ⁻¹(b̃ᵢ − uᵢ₋₁ᵀ xᵢ₋₁), so ∂xᵢ/∂xᵢ₋₁ = −D̃ᵢ⁻¹ uᵢ₋₁ᵀ."""
    dtil = list(diag)
    for i in range(len(diag) - 2, -1, -1):
        u = upper[i]
        dtil[i] = dtil[i] - u @ _solve(dtil[i + 1], u.mT)
    return dtil


def block_tridiag_matmul(diag: Blocks, upper: Blocks, x: Blocks) -> Blocks:
    """Apply the symmetric block-tridiagonal operator to blocked ``x``."""
    M = len(diag)
    out = []
    for i in range(M):
        y = _mul(diag[i], x[i])
        if i > 0:
            y = y + _mul(upper[i - 1].mT, x[i - 1])
        if i < M - 1:
            y = y + _mul(upper[i], x[i + 1])
        out.append(y)
    return out


def block_tridiag_solve_refined(diag: Blocks, upper: Blocks, rhs: Blocks,
                                refine_steps: int = 1) -> Blocks:
    """Solve, then ``refine_steps`` sweeps of iterative refinement."""
    xs = block_tridiag_solve(diag, upper, rhs)
    for _ in range(refine_steps):
        ax = block_tridiag_matmul(diag, upper, xs)
        dx = block_tridiag_solve(diag, upper, [b - a for b, a in zip(rhs, ax)])
        xs = [x + d for x, d in zip(xs, dx)]
    return xs
