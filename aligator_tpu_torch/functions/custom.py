"""User-defined models from plain Python callables (port of
``aligator_tpu.functions.custom``).

Wrap any torch callable; derivatives come from ``torch.func`` through the
base classes' defaults. ``params`` is an optional tree of tensors the
callable receives, so a custom model can be stacked over the horizon and
batched like the library's own (each leaf then carries the batch and time
axes, as every stage leaf does)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from aligator_tpu_torch.costs import Cost
from aligator_tpu_torch.dynamics.base import ODE, ExplicitDynamics
from aligator_tpu_torch.functions.base import StageFunction
from aligator_tpu_torch.utils.tree import static_field


def _call(fn, params, *args):
    return fn(*args) if params is None else fn(*args, params)


@dataclasses.dataclass(frozen=True)
class CustomResidual(StageFunction):
    """r(x, u[, params]) from a user callable."""

    params: Any = None
    fn: Callable = static_field(default=None)

    def value(self, x, u):
        return _call(self.fn, self.params, x, u)


@dataclasses.dataclass(frozen=True)
class CustomCost(Cost):
    """ℓ(space, x, u[, params]) from a user callable (scalar output)."""

    params: Any = None
    fn: Callable = static_field(default=None)

    def value(self, space, x, u):
        return _call(self.fn, self.params, space, x, u)


@dataclasses.dataclass(frozen=True)
class CustomDynamics(ExplicitDynamics):
    """x⁺ = f(space, x, u[, params]) from a user callable."""

    params: Any = None
    fn: Callable = static_field(default=None)

    def forward(self, space, x, u):
        return _call(self.fn, self.params, space, x, u)


@dataclasses.dataclass(frozen=True)
class CustomODE(ODE):
    """ẋ = f(space, x, u[, params]) from a user callable; compose with any
    integrator."""

    params: Any = None
    fn: Callable = static_field(default=None)

    def xdot(self, space, x, u):
        return _call(self.fn, self.params, space, x, u)
