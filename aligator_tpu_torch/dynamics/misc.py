"""Miscellaneous dynamics models (port of ``aligator_tpu.dynamics.misc``):
the wheeled inverted pendulum and the direct sum of two explicit dynamics
on a product manifold."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from aligator_tpu_torch.dynamics.base import ODE, ExplicitDynamics
from aligator_tpu_torch.utils.tree import static_field


@dataclasses.dataclass(frozen=True)
class WheeledInvertedPendulumDynamics(ODE):
    """A segway-style wheeled inverted pendulum: state x = (ṙ, φ̇, θ, θ̇, φ,
    px, py) ∈ R⁷, controls u = (r̈, φ̈)."""

    gravity: torch.Tensor
    length: torch.Tensor

    def xdot(self, space, x, u):
        rdot, phidot, theta, thetadot, phi = (x[..., k] for k in range(5))
        rddot, phiddot = u[..., 0], u[..., 1]
        return torch.stack([
            rddot,
            phiddot,
            thetadot,
            torch.sin(theta) * self.gravity / self.length
            - torch.cos(theta) * rddot / self.length,
            phidot,
            rdot * torch.cos(phi),
            rdot * torch.sin(phi),
        ], dim=-1)


@dataclasses.dataclass(frozen=True)
class DirectSumExplicitDynamics(ExplicitDynamics):
    """(f ⊕ g)(x, u) on a two-factor ``CartesianProduct``: each model acts
    on its slice of the state and of the control; ``nu1`` is f's control
    dimension."""

    f: Any
    g: Any
    nu1: int = static_field()

    def forward(self, space, x, u):
        s1, s2 = space.components
        x1, x2 = x[..., :s1.nx], x[..., s1.nx:]
        u1, u2 = u[..., :self.nu1], u[..., self.nu1:]
        return torch.cat([self.f.forward(s1, x1, u1), self.g.forward(s2, x2, u2)], dim=-1)
