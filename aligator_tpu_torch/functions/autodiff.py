"""Finite-difference derivative helpers (port of
``aligator_tpu.functions.autodiff``).

Wrap a residual, cost or explicit dynamics whose derivatives should come
from manifold-aware central differences rather than AD (black-box
callables that evaluate but do not differentiate cleanly). The stencil is
one batched evaluation over the tangent basis: ``torch.func.vmap`` over
the columns, as the JAX package's ``jax.vmap``, or a loop over them when
the dimension is at most 4 (the JAX package's choice, kept so the
columns are evaluated the same way)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.func import vmap

from aligator_tpu_torch.costs import Cost
from aligator_tpu_torch.dynamics.base import ExplicitDynamics
from aligator_tpu_torch.functions.base import StageFunction
from aligator_tpu_torch.manifolds.base import Manifold


def _fd_jacobian(f, dim: int, eps, dtype, device):
    """Central-difference Jacobian (m, dim) of f: R^dim → R^m over the
    basis scaled by ``eps``."""
    basis = torch.eye(dim, dtype=dtype, device=device) * eps

    def col(e):
        return (f(e) - f(-e)) / (2.0 * eps)

    if dim <= 4:
        return torch.stack([col(basis[k]) for k in range(dim)], dim=-1)
    return vmap(col)(basis).movedim(0, -1)


@dataclasses.dataclass(frozen=True)
class FiniteDifferenceHelper(StageFunction):
    """A residual whose value passes through and whose Jacobians are
    central differences on the manifold."""

    fn: Any
    eps: torch.Tensor

    def value(self, x, u):
        return self.fn.value(x, u)

    def jac_x(self, space: Manifold, x, u):
        return _fd_jacobian(lambda d: self.fn.value(space.integrate(x, d), u), space.ndx,
                            self.eps, x.dtype, x.device)

    def jac_u(self, space: Manifold, x, u):
        return _fd_jacobian(lambda d: self.fn.value(x, u + d), u.shape[-1], self.eps, u.dtype,
                            u.device)


@dataclasses.dataclass(frozen=True)
class DynamicsFiniteDifferenceHelper(ExplicitDynamics):
    """Explicit dynamics whose defect Jacobians are central differences
    on the manifold."""

    dyn: Any
    eps: torch.Tensor

    def forward(self, space, x, u):
        return self.dyn.forward(space, x, u)

    def defect_jacobians(self, space, x, u, x_ref):
        ndx = space.ndx

        def d(dz):
            return self.dyn.defect(space, space.integrate(x, dz[:ndx]), u + dz[ndx:], x_ref)

        J = _fd_jacobian(d, ndx + u.shape[-1], self.eps, torch.promote_types(x.dtype, u.dtype),
                         x.device)
        return J[:, :ndx], J[:, ndx:]


@dataclasses.dataclass(frozen=True)
class CostFiniteDifference(Cost):
    """A cost with central-difference gradients and Hessians (differences
    of the difference gradients, symmetrized)."""

    cost: Any
    eps: torch.Tensor

    def value(self, space, x, u):
        return self.cost.value(space, x, u)

    def gradients(self, space, x, u):
        ndx, nu = space.ndx, u.shape[-1]

        def fx(d):
            return self.cost.value(space, space.integrate(x, d[:ndx]), u + d[ndx:])

        basis = torch.eye(ndx + nu, dtype=torch.promote_types(x.dtype, u.dtype),
                          device=x.device) * self.eps
        g = vmap(lambda e: (fx(e) - fx(-e)) / (2.0 * self.eps))(basis)
        return g[:ndx], g[ndx:]

    def hessians(self, space, x, u):
        ndx, nu = space.ndx, u.shape[-1]

        def grad(d):
            gx, gu = self.gradients(space, space.integrate(x, d[:ndx]), u + d[ndx:])
            return torch.cat([gx, gu])

        H = _fd_jacobian(grad, ndx + nu, self.eps, torch.promote_types(x.dtype, u.dtype),
                         x.device)
        H = 0.5 * (H + H.mT)
        return H[:ndx, :ndx], H[:ndx, ndx:], H[ndx:, ndx:]
