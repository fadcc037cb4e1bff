"""Explicit integrators: discrete dynamics on a manifold from an ODE (port
of ``aligator_tpu.dynamics.integrators``). The defect Jacobians come from
forward-mode AD through the chart composition
(``ExplicitDynamics.defect_jacobians``)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from portbench.reference.port.dynamics.base import ExplicitDynamics


@dataclasses.dataclass(frozen=True)
class EulerIntegrator(ExplicitDynamics):
    """x⁺ = x ⊕ h·f(x, u)."""

    ode: Any
    dt: torch.Tensor

    def forward(self, space, x, u):
        return space.integrate(x, self.dt * self.ode.xdot(space, x, u))


@dataclasses.dataclass(frozen=True)
class SemiImplEulerIntegrator(ExplicitDynamics):
    """Velocity-first (symplectic) Euler on a phase space x = (q, v):
    v⁺ = v + h·a(x, u); q⁺ = q ⊕ h·v⁺. The space's tangent is (q, v)
    halves of ndx/2 each."""

    ode: Any
    dt: torch.Tensor

    def forward(self, space, x, u):
        nv = space.ndx // 2
        acc = self.ode.xdot(space, x, u)[..., nv:]
        v_new = x[..., space.nx - nv:] + self.dt * acc
        return space.integrate(x, torch.cat([self.dt * v_new, self.dt * acc], dim=-1))


@dataclasses.dataclass(frozen=True)
class RK2Integrator(ExplicitDynamics):
    """Midpoint Runge-Kutta 2: x_mid = x ⊕ (h/2)·f(x, u); x⁺ = x ⊕ h·f(x_mid, u)."""

    ode: Any
    dt: torch.Tensor

    def forward(self, space, x, u):
        x_mid = space.integrate(x, 0.5 * self.dt * self.ode.xdot(space, x, u))
        return space.integrate(x, self.dt * self.ode.xdot(space, x_mid, u))


@dataclasses.dataclass(frozen=True)
class RK4Integrator(ExplicitDynamics):
    """Classical RK4 on the manifold."""

    ode: Any
    dt: torch.Tensor

    def forward(self, space, x, u):
        h = self.dt
        f = lambda xx: self.ode.xdot(space, xx, u)
        k1 = f(x)
        k2 = f(space.integrate(x, 0.5 * h * k1))
        k3 = f(space.integrate(x, 0.5 * h * k2))
        k4 = f(space.integrate(x, h * k3))
        return space.integrate(x, (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4))
