"""Dynamics abstractions (port of ``aligator_tpu.dynamics.base``).

The solver consumes the defect linearization: with d(x, u) =
f(x, u) ⊖ x_ref, the LQ dynamics row is A δx + B δu + d − δx' = 0 with
A, B the tangent Jacobians of d (``torch.func.jacfwd`` by default)."""

from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd

from aligator_tpu_torch.manifolds.base import Manifold


@dataclasses.dataclass(frozen=True)
class ExplicitDynamics:
    """Discrete dynamics x⁺ = forward(x, u)."""

    def forward(self, space: Manifold, x, u) -> torch.Tensor:
        raise NotImplementedError

    def defect(self, space: Manifold, x, u, x_ref) -> torch.Tensor:
        """f(x, u) ⊖ x_ref."""
        return space.difference(x_ref, self.forward(space, x, u))

    def defect_jacobians(self, space: Manifold, x, u, x_ref):
        """(A, B): tangent Jacobians of the defect w.r.t. (δx, δu)."""
        ndx = space.ndx
        z = torch.zeros(ndx + u.shape[-1], dtype=torch.promote_types(x.dtype, u.dtype),
                        device=x.device)

        def d(dz):
            return self.defect(space, space.integrate(x, dz[:ndx]), u + dz[ndx:], x_ref)

        J = jacfwd(d)(z)
        return J[:, :ndx], J[:, ndx:]


@dataclasses.dataclass(frozen=True)
class ODE:
    """Continuous dynamics ẋ = xdot(x, u) ∈ T_x M."""

    def xdot(self, space: Manifold, x, u) -> torch.Tensor:
        raise NotImplementedError
