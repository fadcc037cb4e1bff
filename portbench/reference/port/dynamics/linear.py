"""Linear dynamics (port of ``aligator_tpu.dynamics.linear``)."""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.port.dynamics.base import ExplicitDynamics, ODE


@dataclasses.dataclass(frozen=True)
class LinearDiscreteDynamics(ExplicitDynamics):
    """x⁺ = A x + B u + c on a vector space."""

    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor

    def forward(self, space, x, u):
        return self.A @ x + self.B @ u + self.c

    def defect_jacobians(self, space, x, u, x_ref):
        return self.A, self.B


@dataclasses.dataclass(frozen=True)
class LinearODE(ODE):
    """ẋ = A x + B u + c."""

    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor

    def xdot(self, space, x, u):
        return self.A @ x + self.B @ u + self.c
