"""Euclidean vector space (port of ``aligator_tpu.manifolds.vector``)."""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.port.manifolds.base import Manifold


@dataclasses.dataclass(frozen=True)
class VectorSpace(Manifold):
    dim: int

    @property
    def nx(self) -> int:
        return self.dim

    @property
    def ndx(self) -> int:
        return self.dim

    def integrate(self, x, v):
        return x + v

    def difference(self, x0, x1):
        return x1 - x0

    def neutral(self, dtype=torch.float64, device=None):
        return torch.zeros(self.dim, dtype=dtype, device=device)

    def rand(self, generator, dtype=torch.float64, device=None):
        return torch.randn(self.dim, generator=generator, dtype=dtype, device=device)

    def jintegrate(self, x, v, arg):
        return torch.eye(self.dim, dtype=v.dtype, device=v.device)

    def jdifference(self, x0, x1, arg):
        eye = torch.eye(self.dim, dtype=x1.dtype, device=x1.device)
        return -eye if arg == 0 else eye

    def jintegrate_transport(self, x, v, J, arg):
        return J
