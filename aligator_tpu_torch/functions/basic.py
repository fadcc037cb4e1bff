"""Basic residuals on the main path (port of part of
``aligator_tpu.functions.basic``; the rest of that file waits in ROADMAP
queue A)."""

from __future__ import annotations

import dataclasses

import torch

from aligator_tpu_torch.functions.base import StageFunction, UnaryFunction
from aligator_tpu_torch.manifolds.base import Manifold
from aligator_tpu_torch.utils.tree import static_field


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
