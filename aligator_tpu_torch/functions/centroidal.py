"""Centroidal residual family (port of ``aligator_tpu.functions.centroidal``;
no rigid-body model needed): the CoM, linear and angular momentum errors,
the centroidal and angular accelerations, the friction and wrench cones
on the force inputs, and the wrapper that reads an (x, u)-residual as a
function of a combined state. The state is x = (c, h, L) ∈ R⁹ and the
controls stack per-contact forces."""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from aligator_tpu_torch.dynamics.centroidal import ContactMap, centroidal_xdot
from aligator_tpu_torch.functions.base import StageFunction, UnaryFunction
from aligator_tpu_torch.functions.contact import wrench_cone_matrix
from aligator_tpu_torch.utils.tree import static_field


@dataclasses.dataclass(frozen=True)
class CentroidalCoMResidual(UnaryFunction):
    """r = c − c_ref."""

    ref: torch.Tensor  # (3,)

    def value_x(self, x):
        return x[..., :3] - self.ref


@dataclasses.dataclass(frozen=True)
class LinearMomentumResidual(UnaryFunction):
    """r = h − h_ref."""

    ref: torch.Tensor

    def value_x(self, x):
        return x[..., 3:6] - self.ref


@dataclasses.dataclass(frozen=True)
class AngularMomentumResidual(UnaryFunction):
    """r = L − L_ref."""

    ref: torch.Tensor

    def value_x(self, x):
        return x[..., 6:9] - self.ref


@dataclasses.dataclass(frozen=True)
class CentroidalAccelerationResidual(StageFunction):
    """r = (Σ_active fᵢ)/m + g ∈ R³."""

    contact_map: ContactMap
    mass: torch.Tensor
    gravity: torch.Tensor
    force_size: int = static_field(default=3)

    def value(self, x, u):
        cm = self.contact_map
        F = u.reshape(*u.shape[:-1], cm.nk, self.force_size)
        f3 = F[..., :3] * cm.active[:, None]
        return f3.sum(-2) / self.mass + self.gravity


@dataclasses.dataclass(frozen=True)
class AngularAccelerationResidual(StageFunction):
    """r = Σ_active (pᵢ − c) × fᵢ (+ τᵢ) ∈ R³."""

    contact_map: ContactMap
    mass: torch.Tensor
    gravity: torch.Tensor
    force_size: int = static_field(default=3)

    def value(self, x, u):
        xdot = centroidal_xdot(self.mass, self.gravity, self.contact_map, self.force_size, x, u)
        return xdot[..., 6:9]


@dataclasses.dataclass(frozen=True)
class CentroidalFrictionConeResidual(StageFunction):
    """r ∈ R²: [−f_z + ε, ‖f_xy‖² − µ²f_z²] for the k-th 3D force (the
    quadratic cone form, unlike the multibody residual's)."""

    mu: torch.Tensor
    epsilon: torch.Tensor
    k: int = static_field(default=0)

    def value(self, x, u):
        f = u[..., self.k * 3:self.k * 3 + 3]
        return torch.stack([-f[..., 2] + self.epsilon,
                            f[..., 0] ** 2 + f[..., 1] ** 2 - (self.mu ** 2) * f[..., 2] ** 2],
                           dim=-1)


@functools.lru_cache(maxsize=None)
def _cone(mu: float, hL: float, hW: float, dtype, device) -> torch.Tensor:
    return wrench_cone_matrix(mu, hL, hW, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class CentroidalWrenchConeResidual(StageFunction):
    """r ∈ R¹⁷: the wrench-cone rows of ``wrench_cone_matrix`` on the k-th
    6D wrench input."""

    mu: float = static_field(default=0.7)
    hL: float = static_field(default=0.1)
    hW: float = static_field(default=0.05)
    k: int = static_field(default=0)

    def value(self, x, u):
        w = u[..., self.k * 6:self.k * 6 + 6]
        A = _cone(float(self.mu), float(self.hL), float(self.hW), w.dtype, w.device)
        return (A @ w[..., None])[..., 0]


@dataclasses.dataclass(frozen=True)
class CentroidalWrapperResidual(UnaryFunction):
    """A centroidal (x, u)-residual read as a unary function of a combined
    state z = (x_c, u_c), as kinodynamic formulations with forces in the
    state use it; ``nx_inner`` is the inner state width (9)."""

    wrapped: Any  # StageFunction
    nx_inner: int = static_field(default=9)

    def value_x(self, x):
        return self.wrapped.value(x[..., :self.nx_inner], x[..., self.nx_inner:])
