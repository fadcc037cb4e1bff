"""Stage functions (residuals), port of ``aligator_tpu.functions.base``.

A residual is a dataclass: tensor fields are its parameters (stackable
over the horizon, mapped over by ``torch.func.vmap``), fields declared
with ``static_field`` are configuration. Jacobians are taken in tangent
coordinates at a zero perturbation and default to ``torch.func.jacfwd``:

    Jx = ∂/∂δ r(x ⊕ δ, u) |_{δ=0}        Ju = ∂/∂δ r(x, u + δ) |_{δ=0}
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd

from aligator_tpu_torch.manifolds.base import Manifold


def tangent_jac_x(space: Manifold, fn, x, *args):
    """Jacobian of fn w.r.t. a tangent perturbation of x."""
    z = torch.zeros(space.ndx, dtype=torch.promote_types(x.dtype, torch.float32),
                    device=x.device)
    return jacfwd(lambda d: fn(space.integrate(x, d), *args))(z)


@dataclasses.dataclass(frozen=True)
class StageFunction:
    """Base residual r(x, u) ∈ R^nr; subclasses implement ``value``."""

    def value(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def jac_x(self, space: Manifold, x, u) -> torch.Tensor:
        return tangent_jac_x(space, lambda xx, uu: self.value(xx, uu), x, u)

    def jac_u(self, space: Manifold, x, u) -> torch.Tensor:
        return jacfwd(lambda uu: self.value(x, uu))(u)

    def value_and_jac_x(self, space: Manifold, x, u):
        """(value, jac_x) in one call; a subclass whose Jacobian comes from
        AD can return the value from the same pass."""
        return self.value(x, u), self.jac_x(space, x, u)


@dataclasses.dataclass(frozen=True)
class UnaryFunction(StageFunction):
    """f(x)-only residual; ``value`` ignores u."""

    def value_x(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def value(self, x, u):
        return self.value_x(x)

    def jac_u(self, space, x, u):
        nr = self.value(x, u).shape[-1]
        return torch.zeros((nr, u.shape[-1]), dtype=u.dtype, device=u.device)
