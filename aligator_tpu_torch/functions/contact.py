"""Contact-force residuals (port of ``aligator_tpu.functions.contact``):
force tracking, the friction cone of a point contact and the wrench cone
of a surface contact. Each reads λ(x, u) from the multiplier output of
the implicit contact step (``multibody.contact.contact_forces``), so its
Jacobians in x and u are those of that step."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from aligator_tpu_torch.functions.base import StageFunction
from aligator_tpu_torch.multibody.contact import contact_forces, contact_slice
from aligator_tpu_torch.multibody.model import MultibodyModel
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.tree import static_field


@dataclasses.dataclass(frozen=True)
class ContactForceResidual(StageFunction):
    """r = λ_contact(x, u) − f_ref."""

    model: MultibodyModel
    actuation: torch.Tensor  # (nv, nu)
    contacts: Any  # ContactSet
    fref: torch.Tensor  # (dim,)
    contact_name: str = static_field()

    def value(self, x, u):
        lam = contact_forces(self.model, self.contacts, self.actuation, x, u)
        return lam[contact_slice(self.contacts, self.contact_name)] - self.fref


@dataclasses.dataclass(frozen=True)
class MultibodyFrictionConeResidual(StageFunction):
    """r ∈ R²: [−λ_z, −µ·λ_z + √(λ_x² + λ_y² + eps)] ≤ 0 for a 3D contact;
    ``eps`` keeps the derivative finite at zero tangential force."""

    model: MultibodyModel
    actuation: torch.Tensor
    contacts: Any
    mu: torch.Tensor  # friction coefficient
    contact_name: str = static_field()
    eps: float = static_field(default=1e-12)

    def value(self, x, u):
        lam = contact_forces(self.model, self.contacts, self.actuation, x, u)
        f = lam[contact_slice(self.contacts, self.contact_name)]
        tangential = torch.sqrt(f[0] ** 2 + f[1] ** 2 + self.eps)
        return torch.stack([-f[2], -self.mu * f[2] + tangential])


def wrench_cone_matrix(mu: float, half_length: float, half_width: float,
                       dtype=torch.float64, device=None) -> torch.Tensor:
    """The 17×6 wrench cone of a rectangular surface contact, acting on
    λ = (f, τ) in the contact frame: unilaterality (1), the linearized
    Coulomb pyramid (4), the CoP box (4), the yaw-torque bounds (8). On
    ``device`` (default: the card; raises without one)."""
    hL, hW = half_length, half_width
    A = np.zeros((17, 6))
    A[0] = [0, 0, -1, 0, 0, 0]
    A[1] = [-1, 0, -mu, 0, 0, 0]
    A[2] = [1, 0, -mu, 0, 0, 0]
    A[3] = [0, -1, -mu, 0, 0, 0]
    A[4] = [0, 1, -mu, 0, 0, 0]
    A[5] = [0, 0, -hW, -1, 0, 0]
    A[6] = [0, 0, -hW, 1, 0, 0]
    A[7] = [0, 0, -hL, 0, -1, 0]
    A[8] = [0, 0, -hL, 0, 1, 0]
    A[9] = [-hW, -hL, -(hL + hW) * mu, mu, mu, -1]
    A[10] = [-hW, hL, -(hL + hW) * mu, mu, -mu, -1]
    A[11] = [hW, -hL, -(hL + hW) * mu, -mu, mu, -1]
    A[12] = [hW, hL, -(hL + hW) * mu, -mu, -mu, -1]
    A[13] = [hW, hL, -(hL + hW) * mu, mu, mu, 1]
    A[14] = [hW, -hL, -(hL + hW) * mu, mu, -mu, 1]
    A[15] = [-hW, hL, -(hL + hW) * mu, -mu, mu, 1]
    A[16] = [-hW, -hL, -(hL + hW) * mu, -mu, -mu, 1]
    return torch.as_tensor(A, dtype=dtype, device=resolve_device(device))


@dataclasses.dataclass(frozen=True)
class MultibodyWrenchConeResidual(StageFunction):
    """r = A_cone · λ_contact(x, u) ∈ R¹⁷ ≤ 0 for a 6D surface contact."""

    model: MultibodyModel
    actuation: torch.Tensor
    contacts: Any
    Acone: torch.Tensor  # (17, 6) from wrench_cone_matrix
    contact_name: str = static_field()

    def value(self, x, u):
        lam = contact_forces(self.model, self.contacts, self.actuation, x, u)
        return self.Acone @ lam[contact_slice(self.contacts, self.contact_name)]
