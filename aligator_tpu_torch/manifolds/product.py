"""Cartesian product of manifolds (port of
``aligator_tpu.manifolds.product``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from aligator_tpu_torch.manifolds.base import Manifold


def block_diag(*blocks: torch.Tensor) -> torch.Tensor:
    """Block-diagonal matrix of 2-D blocks (concatenations only, so it
    maps under ``torch.func.vmap``)."""
    ncol = sum(b.shape[-1] for b in blocks)
    rows, c = [], 0
    for b in blocks:
        n = b.shape[-1]
        rows.append(torch.nn.functional.pad(b, (c, ncol - c - n)))
        c += n
    return torch.cat(rows, dim=-2)


@dataclasses.dataclass(frozen=True)
class CartesianProduct(Manifold):
    components: Tuple[Manifold, ...]

    def __post_init__(self):
        # nested products are flattened, as the reference's left fold does
        flat = []
        for c in self.components:
            flat.extend(c.components if isinstance(c, CartesianProduct) else (c,))
        object.__setattr__(self, "components", tuple(flat))

    @property
    def nx(self) -> int:
        return sum(c.nx for c in self.components)

    @property
    def ndx(self) -> int:
        return sum(c.ndx for c in self.components)

    def _split(self, a, width):
        out, i = [], 0
        for c in self.components:
            n = width(c)
            out.append(a[..., i:i + n])
            i += n
        return out

    def _split_x(self, x):
        return self._split(x, lambda c: c.nx)

    def _split_v(self, v):
        return self._split(v, lambda c: c.ndx)

    def integrate(self, x, v):
        return torch.cat([c.integrate(a, b) for c, a, b in
                          zip(self.components, self._split_x(x), self._split_v(v))], dim=-1)

    def difference(self, x0, x1):
        return torch.cat([c.difference(a, b) for c, a, b in
                          zip(self.components, self._split_x(x0), self._split_x(x1))], dim=-1)

    def neutral(self, dtype=torch.float64, device=None):
        return torch.cat([c.neutral(dtype, device) for c in self.components], dim=-1)

    def is_normalized(self, x):
        ok = torch.ones((), dtype=torch.bool, device=x.device)
        for c, a in zip(self.components, self._split_x(x)):
            ok = ok & c.is_normalized(a)
        return ok

    def normalize(self, x):
        return torch.cat([c.normalize(a) for c, a in zip(self.components, self._split_x(x))],
                         dim=-1)

    def jintegrate(self, x, v, arg):
        return block_diag(*(c.jintegrate(a, b, arg) for c, a, b in
                            zip(self.components, self._split_x(x), self._split_v(v))))

    def jdifference(self, x0, x1, arg):
        return block_diag(*(c.jdifference(a, b, arg) for c, a, b in
                            zip(self.components, self._split_x(x0), self._split_x(x1))))
