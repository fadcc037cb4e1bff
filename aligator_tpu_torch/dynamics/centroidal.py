"""Centroidal (point-mass Newton-Euler) dynamics (port of
``aligator_tpu.dynamics.centroidal``). The state x = (c, h, L) ∈ R⁹ holds
the CoM position, the linear momentum and the angular momentum; the
inputs stack per-contact forces (3) or wrenches (6):

    ċ = h/m,   ḣ = m·g + Σᵢ fᵢ,   L̇ = Σᵢ (pᵢ − c) × fᵢ (+ τᵢ for 6D)

Contact activity and positions live in a :class:`ContactMap` whose
tensors are leaves, so gait phases stack over the horizon. Jacobians come
from forward-mode AD."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from aligator_tpu_torch.dynamics.base import ODE
from aligator_tpu_torch.manifolds.lie import cross
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.tree import static_field


@dataclasses.dataclass(frozen=True)
class ContactMap:
    """Per-phase contact data: the names are static, the active flags and
    contact positions are leaves."""

    active: torch.Tensor  # (nk,) 0/1
    poses: torch.Tensor  # (nk, 3) contact points in the world
    names: Tuple[str, ...] = static_field()

    @property
    def nk(self) -> int:
        return len(self.names)

    def replace(self, **changes) -> "ContactMap":
        return dataclasses.replace(self, **changes)

    @classmethod
    def create(cls, names, poses, active=None, dtype=torch.float64, device=None):
        """A map on ``device`` (default: that of ``poses`` when it is a
        tensor, else the card); every contact active unless ``active`` is
        given."""
        names = tuple(names)
        if device is None:
            device = poses.device if isinstance(poses, torch.Tensor) else resolve_device()
        t = lambda a: torch.as_tensor(a).to(dtype=dtype, device=device)
        act = torch.ones(len(names), dtype=dtype, device=device) if active is None else t(active)
        return cls(active=act, poses=t(poses), names=names)


def centroidal_xdot(mass, gravity, cmap: ContactMap, force_size: int, x, forces):
    """The Newton-Euler law; ``forces`` is the stacked (nk·force_size,)
    force or wrench vector (the control, or a segment of the state)."""
    c, h = x[..., :3], x[..., 3:6]
    F = forces.reshape(*forces.shape[:-1], cmap.nk, force_size)
    f3 = F[..., :3] * cmap.active[:, None]
    dc = h / mass
    dh = mass * gravity + f3.sum(-2)
    arm = cmap.poses - c[..., None, :]
    dL = cross(arm, f3).sum(-2)
    if force_size == 6:
        dL = dL + (F[..., 3:] * cmap.active[:, None]).sum(-2)
    return torch.cat([dc, dh, dL], dim=-1)


@dataclasses.dataclass(frozen=True)
class CentroidalFwdDynamics(ODE):
    """ẋ = f(x, u) with u the stacked contact forces; state width 9,
    nu = nk · force_size."""

    contact_map: ContactMap
    mass: torch.Tensor
    gravity: torch.Tensor  # (3,)
    force_size: int = static_field(default=3)

    def xdot(self, space, x, u):
        return centroidal_xdot(self.mass, self.gravity, self.contact_map, self.force_size, x, u)


@dataclasses.dataclass(frozen=True)
class ContinuousCentroidalFwdDynamics(ODE):
    """The smooth-force variant: the forces are part of the state,
    x = (c, h, L, f₁…f_nk) ∈ R^{9 + nk·fs}, and the control is their rate:
    ẋ = (NewtonEuler(x), u)."""

    contact_map: ContactMap
    mass: torch.Tensor
    gravity: torch.Tensor
    force_size: int = static_field(default=3)

    def xdot(self, space, x, u):
        core = centroidal_xdot(self.mass, self.gravity, self.contact_map, self.force_size,
                               x[..., :9], x[..., 9:])
        return torch.cat([core, u], dim=-1)
