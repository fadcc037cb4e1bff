"""Tangent bundle TM of a base manifold (port of
``aligator_tpu.manifolds.tangent``). Points are (x_base, v) with
v ∈ R^{ndx_base}; the retraction acts on the base with the first slice and
additively on the fiber."""

from __future__ import annotations

import dataclasses

import torch

from aligator_tpu_torch.manifolds.base import Manifold
from aligator_tpu_torch.manifolds.product import block_diag


@dataclasses.dataclass(frozen=True)
class TangentBundle(Manifold):
    base: Manifold

    @property
    def nx(self) -> int:
        return self.base.nx + self.base.ndx

    @property
    def ndx(self) -> int:
        return 2 * self.base.ndx

    def _split(self, x):
        return x[..., :self.base.nx], x[..., self.base.nx:]

    def integrate(self, x, dv):
        xb, vb = self._split(x)
        nb = self.base.ndx
        return torch.cat([self.base.integrate(xb, dv[..., :nb]), vb + dv[..., nb:]], dim=-1)

    def difference(self, x0, x1):
        xb0, vb0 = self._split(x0)
        xb1, vb1 = self._split(x1)
        return torch.cat([self.base.difference(xb0, xb1), vb1 - vb0], dim=-1)

    def neutral(self, dtype=torch.float64, device=None):
        return torch.cat([self.base.neutral(dtype, device),
                          torch.zeros(self.base.ndx, dtype=dtype, device=device)])

    def is_normalized(self, x):
        return self.base.is_normalized(self._split(x)[0])

    def normalize(self, x):
        xb, vb = self._split(x)
        return torch.cat([self.base.normalize(xb), vb], dim=-1)

    def jintegrate(self, x, dv, arg):
        Jb = self.base.jintegrate(self._split(x)[0], dv[..., :self.base.ndx], arg)
        return block_diag(Jb, torch.eye(self.base.ndx, dtype=Jb.dtype, device=Jb.device))

    def jdifference(self, x0, x1, arg):
        Jb = self.base.jdifference(self._split(x0)[0], self._split(x1)[0], arg)
        eye = torch.eye(self.base.ndx, dtype=Jb.dtype, device=Jb.device)
        return block_diag(Jb, -eye if arg == 0 else eye)
