"""Basic residuals (port of ``aligator_tpu.functions.basic``): state and
control errors, linear functions, the control box, a linear map of
another residual and a row slice of one."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from portbench.reference.port.functions.base import StageFunction, UnaryFunction
from portbench.reference.port.manifolds.base import Manifold
from portbench.reference.port.utils.tree import static_field


@dataclasses.dataclass(frozen=True)
class StateErrorResidual(UnaryFunction):
    """r(x) = x ⊖ target (also the default initial-condition residual)."""

    target: torch.Tensor
    space: Manifold = static_field()

    def value_x(self, x):
        return self.space.difference(self.target, x)

    def jac_x(self, space, x, u):
        return self.space.jdifference(self.target, x, 1)


@dataclasses.dataclass(frozen=True)
class ControlErrorResidual(StageFunction):
    """r(x, u) = u − target."""

    target: torch.Tensor

    def value(self, x, u):
        return u - self.target

    def jac_x(self, space, x, u):
        return torch.zeros((u.shape[-1], space.ndx), dtype=u.dtype, device=u.device)

    def jac_u(self, space, x, u):
        return torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)


@dataclasses.dataclass(frozen=True)
class LinearFunction(StageFunction):
    """r(x, u) = A x + B u + c (A acts on tangent coordinates of vector
    states)."""

    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor

    def value(self, x, u):
        return self.A @ x + self.B @ u + self.c

    def jac_x(self, space, x, u):
        return self.A

    def jac_u(self, space, x, u):
        return self.B


@dataclasses.dataclass(frozen=True)
class ControlBoxFunction(StageFunction):
    """Two-sided control bounds as the residual r = [u − umax; umin − u] ≤ 0."""

    umin: torch.Tensor
    umax: torch.Tensor

    def value(self, x, u):
        return torch.cat([u - self.umax, self.umin - u], dim=-1)

    def jac_x(self, space, x, u):
        return torch.zeros((2 * u.shape[-1], space.ndx), dtype=u.dtype, device=u.device)

    def jac_u(self, space, x, u):
        eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
        return torch.cat([eye, -eye], dim=0)


@dataclasses.dataclass(frozen=True)
class LinearFunctionComposition(StageFunction):
    """r = A·f(x, u) + b."""

    inner: Any  # a StageFunction
    A: torch.Tensor
    b: torch.Tensor

    def value(self, x, u):
        return self.A @ self.inner.value(x, u) + self.b

    def jac_x(self, space, x, u):
        return self.A @ self.inner.jac_x(space, x, u)

    def jac_u(self, space, x, u):
        return self.A @ self.inner.jac_u(space, x, u)


@dataclasses.dataclass(frozen=True)
class FunctionSlice(StageFunction):
    """The rows ``rows`` (static) of another residual."""

    inner: Any
    rows: tuple = static_field()

    def value(self, x, u):
        return self.inner.value(x, u)[..., list(self.rows)]

    def jac_x(self, space, x, u):
        return self.inner.jac_x(space, x, u)[list(self.rows), :]

    def jac_u(self, space, x, u):
        return self.inner.jac_u(space, x, u)[list(self.rows), :]
