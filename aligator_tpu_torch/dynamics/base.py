"""Dynamics abstractions (port of ``aligator_tpu.dynamics.base``).

The solver consumes the defect linearization: with d(x, u) =
f(x, u) ⊖ x_ref, the LQ dynamics row is A δx + B δu + d − δx' = 0 with
A, B the tangent Jacobians of d (``torch.func.jacfwd`` by default)."""

from __future__ import annotations

import contextlib
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


_VALUES_ONLY = [0]


@contextlib.contextmanager
def values_only():
    """A block that evaluates the dynamics for their values alone, under no
    forward-mode transform (a problem evaluation, a rollout). There the
    implicit steps of the multibody dynamics return their primal solve,
    the value the JAX package's custom JVP rules return, and skip the
    Newton correction that carries their tangent (about half of a contact
    step's work). A ``jacfwd`` or ``jvp`` through the dynamics inside the
    block would lose those tangents: code that takes one there wraps it in
    :func:`tangents_kept` (``ImplicitToExplicit``'s Newton solve)."""
    _VALUES_ONLY[0] += 1
    try:
        yield
    finally:
        _VALUES_ONLY[0] -= 1


@contextlib.contextmanager
def tangents_kept():
    """A block, inside :func:`values_only` or not, whose dynamics carry
    their tangents: for a ``jacfwd`` through the dynamics that a value
    itself needs."""
    saved, _VALUES_ONLY[0] = _VALUES_ONLY[0], 0
    try:
        yield
    finally:
        _VALUES_ONLY[0] = saved


def values_only_active() -> bool:
    return _VALUES_ONLY[0] > 0
