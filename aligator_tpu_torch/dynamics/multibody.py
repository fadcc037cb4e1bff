"""Multibody forward dynamics as ODEs on the phase space (port of
``aligator_tpu.dynamics.multibody``; ``KinodynamicsFwdDynamics`` waits
for the centroidal layer, ROADMAP A32)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from aligator_tpu_torch.dynamics.base import ODE
from aligator_tpu_torch.multibody.algorithms import fwd_dynamics
from aligator_tpu_torch.multibody.contact import constrained_dynamics
from aligator_tpu_torch.multibody.model import MultibodyModel
from aligator_tpu_torch.utils.tree import static_field


def _split(model: MultibodyModel, actuation, x, u):
    nq = model.nq
    return x[..., :nq], x[..., nq:], (actuation @ u[..., None])[..., 0]


@dataclasses.dataclass(frozen=True)
class MultibodyFreeFwdDynamics(ODE):
    """ẋ = (v, FD(q, v, B·u)) on the phase space; ``actuation`` is the
    (nv, nu) actuation matrix B."""

    model: MultibodyModel
    actuation: torch.Tensor

    def xdot(self, space, x, u):
        q, v, tau = _split(self.model, self.actuation, x, u)
        return torch.cat([v, fwd_dynamics(self.model, q, v, tau)], dim=-1)


@dataclasses.dataclass(frozen=True)
class MultibodyConstraintFwdDynamics(ODE):
    """Contact-constrained forward dynamics ẋ = (v, FDc(q, v, B·u));
    ``contacts`` is a :class:`~aligator_tpu_torch.multibody.contact.ContactSet`
    whose ``active`` flags are leaves, so contact phases stack over the
    horizon."""

    model: MultibodyModel
    actuation: torch.Tensor
    contacts: Any
    prox_sigma: float = static_field(default=1e-8)

    def xdot(self, space, x, u):
        q, v, tau = _split(self.model, self.actuation, x, u)
        a, _ = constrained_dynamics(self.model, self.contacts, q, v, tau, self.prox_sigma)
        return torch.cat([v, a], dim=-1)


def full_actuation(model: MultibodyModel, dtype=torch.float64, device=None) -> torch.Tensor:
    return torch.eye(model.nv, dtype=dtype, device=device)


def floating_base_actuation(model: MultibodyModel, dtype=torch.float64,
                            device=None) -> torch.Tensor:
    """Zero torque on the 6 free-flyer coordinates, identity elsewhere."""
    return torch.eye(model.nv, dtype=dtype, device=device)[:, 6:].contiguous()
