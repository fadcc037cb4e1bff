"""Manifold (state-space) abstraction (port of
``aligator_tpu.manifolds.base``).

A manifold is a static (frozen-dataclass) object whose methods act on the
trailing axis of coordinate tensors. Jacobians on the manifold are
defined through tangent perturbations and default to
``torch.func.jacfwd`` of the chart maps, with closed forms in subclasses.
"""

from __future__ import annotations

import dataclasses
import torch
from torch.func import jacfwd


@dataclasses.dataclass(frozen=True)
class Manifold:
    """Base manifold. Subclasses define nx/ndx and the chart ops."""

    @property
    def nx(self) -> int:
        raise NotImplementedError

    @property
    def ndx(self) -> int:
        raise NotImplementedError

    def integrate(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """x ⊕ v."""
        raise NotImplementedError

    def difference(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        """x1 ⊖ x0 ∈ T_{x0}M."""
        raise NotImplementedError

    def neutral(self, dtype=torch.float64, device=None) -> torch.Tensor:
        raise NotImplementedError

    def rand(self, generator: torch.Generator, dtype=torch.float64,
             device=None) -> torch.Tensor:
        """Random point: integrate Gaussian noise at the neutral point."""
        v = torch.randn(self.ndx, generator=generator, dtype=dtype, device=device)
        return self.integrate(self.neutral(dtype, device), v)

    def is_normalized(self, x: torch.Tensor) -> torch.Tensor:
        return torch.ones((), dtype=torch.bool, device=x.device)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def interpolate(self, x0, x1, u):
        """x0 ⊕ u·(x1 ⊖ x0)."""
        return self.integrate(x0, u * self.difference(x0, x1))

    def jintegrate(self, x, v, arg: int) -> torch.Tensor:
        """(ndx, ndx) Jacobian of integrate w.r.t. arg ∈ {0, 1}."""
        z = torch.zeros(self.ndx, dtype=v.dtype, device=v.device)
        if arg == 0:
            fn = lambda d: self.difference(
                self.integrate(x, v), self.integrate(self.integrate(x, d), v))
        else:
            fn = lambda d: self.difference(self.integrate(x, v), self.integrate(x, v + d))
        return jacfwd(fn)(z)

    def jdifference(self, x0, x1, arg: int) -> torch.Tensor:
        z = torch.zeros(self.ndx, dtype=x0.dtype, device=x0.device)
        if arg == 0:
            fn = lambda d: self.difference(self.integrate(x0, d), x1)
        else:
            fn = lambda d: self.difference(x0, self.integrate(x1, d))
        return jacfwd(fn)(z)

    def jintegrate_transport(self, x, v, J, arg: int) -> torch.Tensor:
        return self.jintegrate(x, v, arg) @ J

    def tangent_space(self) -> "Manifold":
        from portbench.reference.port.manifolds.vector import VectorSpace

        return VectorSpace(self.ndx)

    def __mul__(self, other: "Manifold") -> "Manifold":
        from portbench.reference.port.manifolds.product import CartesianProduct

        return CartesianProduct((self, other))
