"""The constrained LQ problem as a dataclass of horizon-stacked tensors.

Port of ``aligator_tpu.gar.lqr_problem``. Every field carries an explicit
leading BATCH axis (the JAX package gets it from ``jax.vmap``), then the
horizon axis (N+1 knots), padded to uniform (nx, nu, nc):

    min  Σ_t ½ xᵀQx + ½ uᵀRu + xᵀSu + qᵀx + rᵀu   (t = 0..N)
    s.t. A x_t + B u_t + f - x_{t+1} = 0            (t < N,  dual λ_{t+1})
         C x_t + D u_t + d - µ_eq v_t = 0           (dual v_t)
         G0 x_0 + g0 = 0                            (dual λ_0)

plus an optional linear θ-parameterization (size nth). Zero padding is
exact: a padded control slot with R=I, r=0, S=0, B=0, D=0 solves to u=0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class LQRProblem:
    """Stacked constrained-LQ problem, fields shaped (B, N+1, ...); ``A/B/f``
    at t = N exist for uniform shapes but are unused."""

    Q: torch.Tensor  # (B, N+1, nx, nx)
    S: torch.Tensor  # (B, N+1, nx, nu)
    R: torch.Tensor  # (B, N+1, nu, nu)
    q: torch.Tensor  # (B, N+1, nx)
    r: torch.Tensor  # (B, N+1, nu)
    A: torch.Tensor  # (B, N+1, nx, nx)
    B: torch.Tensor  # (B, N+1, nx, nu)
    f: torch.Tensor  # (B, N+1, nx)
    C: torch.Tensor  # (B, N+1, nc, nx)
    D: torch.Tensor  # (B, N+1, nc, nu)
    d: torch.Tensor  # (B, N+1, nc)
    Gx: torch.Tensor  # (B, N+1, nx, nth)
    Gu: torch.Tensor  # (B, N+1, nu, nth)
    Gth: torch.Tensor  # (B, N+1, nth, nth)
    gamma: torch.Tensor  # (B, N+1, nth)
    G0: torch.Tensor  # (B, nc0, nx)
    g0: torch.Tensor  # (B, nc0)
    # θ-coefficient of the constraint rows; None means all zeros
    Gv: Optional[torch.Tensor] = None  # (B, N+1, nc, nth)

    @property
    def batch(self) -> int:
        return self.Q.shape[0]

    @property
    def horizon(self) -> int:
        return self.Q.shape[1] - 1

    @property
    def nx(self) -> int:
        return self.Q.shape[-1]

    @property
    def nu(self) -> int:
        return self.R.shape[-1]

    @property
    def nc(self) -> int:
        return self.C.shape[-2]

    @property
    def nth(self) -> int:
        return self.Gth.shape[-1]

    @property
    def nc0(self) -> int:
        return self.G0.shape[-2]

    @property
    def dtype(self) -> torch.dtype:
        return self.Q.dtype

    @property
    def device(self) -> torch.device:
        return self.Q.device

    @property
    def Gv_or_zeros(self) -> torch.Tensor:
        if self.Gv is None:
            return self.Q.new_zeros(self.Q.shape[:2] + (self.nc, self.nth))
        return self.Gv

    def replace(self, **changes) -> "LQRProblem":
        return dataclasses.replace(self, **changes)

    def with_parameterization(self, nth: int) -> "LQRProblem":
        """A copy with zero θ-blocks of width ``nth``."""
        lead = self.Q.shape[:2]
        z = lambda *s: self.Q.new_zeros(lead + s)
        return self.replace(Gx=z(self.nx, nth), Gu=z(self.nu, nth), Gth=z(nth, nth),
                            gamma=z(nth), Gv=z(self.nc, nth))

    def knot(self, t: int) -> "LQRProblem":
        """Knot ``t`` of every problem: the stage fields lose the time
        axis, (B, ...); G0 and g0 are kept."""
        return self.replace(**{
            f: getattr(self, f)[:, t] for f in _STAGE_FIELDS
            if getattr(self, f) is not None})

    def cycle_append(self, knot: "LQRProblem") -> "LQRProblem":
        """Roll the horizon one step left and write ``knot`` (a problem of
        single knots, as :meth:`knot` gives) into the last slot: the
        receding-horizon shift of MPC."""
        shift = lambda f: torch.cat(
            [getattr(self, f)[:, 1:], getattr(knot, f).unsqueeze(1)], dim=1)
        return self.replace(**{f: shift(f) for f in _STAGE_FIELDS
                               if getattr(self, f) is not None})


_STAGE_FIELDS = ("Q", "S", "R", "q", "r", "A", "B", "f", "C", "D", "d",
                 "Gx", "Gu", "Gth", "gamma", "Gv")


def lqr_zeros(
    N: int,
    nx: int,
    nu: int,
    nc: int = 0,
    nth: int = 0,
    nc0: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
    batch: int = 1,
) -> LQRProblem:
    """All-zero problem with the given static dims (padded control slots
    R = I so the padding is exact)."""
    if nc0 is None:
        nc0 = nx
    L = N + 1

    def z(*s):
        return torch.zeros((batch,) + s, dtype=dtype, device=device)

    R = torch.eye(nu, dtype=dtype, device=device).expand(batch, L, nu, nu).clone()
    return LQRProblem(
        Q=z(L, nx, nx), S=z(L, nx, nu), R=R, q=z(L, nx), r=z(L, nu),
        A=z(L, nx, nx), B=z(L, nx, nu), f=z(L, nx),
        C=z(L, nc, nx), D=z(L, nc, nu), d=z(L, nc),
        Gx=z(L, nx, nth), Gu=z(L, nu, nth), Gth=z(L, nth, nth), gamma=z(L, nth),
        G0=z(nc0, nx), g0=z(nc0),
    )
