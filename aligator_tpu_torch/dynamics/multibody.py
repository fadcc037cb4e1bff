"""Multibody forward dynamics as ODEs on the phase space (port of
``aligator_tpu.dynamics.multibody``): free, contact-constrained and
kinodynamic."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.func import jacfwd, jvp

from aligator_tpu_torch.dynamics.base import ODE
from aligator_tpu_torch.manifolds.lie import cross
from aligator_tpu_torch.multibody.algorithms import (
    centroidal_momentum,
    com_position,
    forward_kinematics,
    fwd_dynamics,
)
from aligator_tpu_torch.multibody.contact import constrained_dynamics
from aligator_tpu_torch.multibody.model import MultibodyModel, configuration_integrate
from aligator_tpu_torch.multibody.spatial import SE3T, se3_mul
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


@dataclasses.dataclass(frozen=True)
class KinodynamicsFwdDynamics(ODE):
    """Kinodynamic model: the controls are u = [contact forces (nk·fs),
    joint accelerations a_j (nv − 6)], and the free-flyer acceleration
    follows from the centroidal momentum balance

        Ag·v̇ + Ȧg·v = ḣ_ext  ⇒  v̇_base = Ag[:, :6]⁻¹ (ḣ_ext − Ȧg v − Ag[:, 6:] a_j)

    with ḣ_ext = m·g + Σ of the active contact wrenches about the CoM.
    Ag = ∂h/∂v (``jacfwd``) and Ȧg·v (a ``jvp`` along q̇ = v) come from AD
    of :func:`centroidal_momentum`. The 6×6 solve goes through
    ``torch.linalg.inv``: under ``torch.func.vmap`` the forward-mode
    derivative of ``torch.linalg.solve`` comes out wrong, that of ``inv``
    right (as in ``dynamics/implicit.py``)."""

    model: MultibodyModel
    active: torch.Tensor  # (nk,) 0/1 contact flags (leaves: phases stack)
    frame_ids: Any = static_field()  # tuple of frame ids
    force_size: int = static_field(default=3)

    def xdot(self, space, x, u):
        model = self.model
        nq = model.nq
        nk, fs = len(self.frame_ids), self.force_size
        q, v = x[..., :nq], x[..., nq:]
        F = u[..., :nk * fs].reshape(nk, fs)
        aj = u[..., nk * fs:]

        com = com_position(model, q)
        Ag = jacfwd(lambda vv: centroidal_momentum(model, q, vv)[0])(v)
        Agdot_v = jvp(lambda t: centroidal_momentum(
            model, configuration_integrate(model, q, t * v), v)[0],
            (q.new_zeros(()),), (q.new_ones(()),))[1]

        # the external wrench about the CoM
        oM = forward_kinematics(model, q)
        lin = model.mass.sum() * model.gravity
        ang = q.new_zeros(3)
        for i, fid in enumerate(self.frame_ids):
            fr = model.frames[fid]
            M = se3_mul(oM[fr.parent_joint], SE3T(model.frame_R[fid], model.frame_p[fid]))
            fi = self.active[i] * F[i, :3]
            lin = lin + fi
            ang = ang + cross(M.p - com, fi)
            if fs == 6:
                ang = ang + self.active[i] * F[i, 3:]
        rhs = torch.cat([lin, ang]) - Agdot_v - Ag[:, 6:] @ aj
        base_acc = torch.linalg.inv(Ag[:, :6]) @ rhs
        return torch.cat([v, base_acc, aj], dim=-1)


def full_actuation(model: MultibodyModel, dtype=torch.float64, device=None) -> torch.Tensor:
    return torch.eye(model.nv, dtype=dtype, device=device)


def floating_base_actuation(model: MultibodyModel, dtype=torch.float64,
                            device=None) -> torch.Tensor:
    """Zero torque on the 6 free-flyer coordinates, identity elsewhere."""
    return torch.eye(model.nv, dtype=dtype, device=device)[:, 6:].contiguous()
