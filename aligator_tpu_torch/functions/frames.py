"""Frame task residuals on multibody states (port of
``aligator_tpu.functions.frames``): frame placement, translation,
velocity and relative pose, the swing-foot fly-high term, collision
distances, the centre of mass and its velocity, the DCM, the centroidal
momentum and its rate, and gravity compensation.

States are configurations q or phase-space states (q, v). Jacobians are
forward-mode AD through the kinematics; the frame residuals on the state
alone return their value and tangent Jacobian from one pass.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.func import jacfwd, jvp

from aligator_tpu_torch.functions.base import StageFunction, UnaryFunction
from aligator_tpu_torch.manifolds.lie import cross
from aligator_tpu_torch.multibody.algorithms import (
    centroidal_momentum,
    com_position,
    forward_kinematics,
    frame_placement,
    frame_velocity,
    gravity_torque,
)
from aligator_tpu_torch.multibody.geometry import pair_distance
from aligator_tpu_torch.multibody.model import MultibodyModel, configuration_integrate
from aligator_tpu_torch.multibody.spatial import SE3T, se3_inv, se3_log, se3_mul
from aligator_tpu_torch.utils.tree import static_field


@dataclasses.dataclass(frozen=True)
class _StateResidual(UnaryFunction):
    """A residual of the state whose value and tangent Jacobian come from
    one forward-mode pass (x ⊕ 0 = x exactly, so the value is the plain
    one)."""

    def value_and_jac_x(self, space, x, u):
        def f(d):
            r = self.value_x(space.integrate(x, d))
            return r, r

        J, r = jacfwd(f, has_aux=True)(x.new_zeros(space.ndx))
        return r, J


def _com_velocity(model: MultibodyModel, q, v):
    """d(com)/dt = J_com(q)·v, a JVP along the configuration flow."""
    t = q.new_zeros(1)
    return jvp(lambda s: com_position(model, configuration_integrate(model, q, s * v)),
               (t,), (torch.ones_like(t),))[1]


@dataclasses.dataclass(frozen=True)
class FramePlacementResidual(_StateResidual):
    """r = log6(M_ref⁻¹ · M_frame(q)) ∈ R⁶."""

    model: MultibodyModel
    ref_R: torch.Tensor  # (3, 3)
    ref_p: torch.Tensor  # (3,)
    frame_id: int = static_field()

    def value_x(self, x):
        M = frame_placement(self.model, x[..., :self.model.nq], self.frame_id)
        return se3_log(se3_mul(se3_inv(SE3T(self.ref_R, self.ref_p)), M))


@dataclasses.dataclass(frozen=True)
class FrameTranslationResidual(_StateResidual):
    """r = p_frame(q) − p_ref ∈ R³."""

    model: MultibodyModel
    ref: torch.Tensor  # (3,)
    frame_id: int = static_field()

    def value_x(self, x):
        return frame_placement(self.model, x[..., :self.model.nq], self.frame_id).p - self.ref


@dataclasses.dataclass(frozen=True)
class FrameVelocityResidual(_StateResidual):
    """r = v_frame(q, v) − v_ref ∈ R⁶, LOCAL convention (phase-space
    states)."""

    model: MultibodyModel
    ref: torch.Tensor  # (6,)
    frame_id: int = static_field()

    def value_x(self, x):
        nq = self.model.nq
        return frame_velocity(self.model, x[..., :nq], x[..., nq:], self.frame_id,
                              local=True) - self.ref


@dataclasses.dataclass(frozen=True)
class FrameEqualityResidual(_StateResidual):
    """The relative pose of two frames: r = log6(M_a(q)⁻¹ M_b(q))."""

    model: MultibodyModel
    frame_a: int = static_field()
    frame_b: int = static_field()

    def value_x(self, x):
        q = x[..., :self.model.nq]
        Ma = frame_placement(self.model, q, self.frame_a)
        Mb = frame_placement(self.model, q, self.frame_b)
        return se3_log(se3_mul(se3_inv(Ma), Mb))


@dataclasses.dataclass(frozen=True)
class FlyHighResidual(_StateResidual):
    """r = e^{−z_f·slope} · v_xy (the frame's linear velocity in
    world-aligned axes) ∈ R²: the swing-foot slip and height penalty."""

    model: MultibodyModel
    slope: torch.Tensor
    frame_id: int = static_field()

    def value_x(self, x):
        nq = self.model.nq
        q, v = x[..., :nq], x[..., nq:]
        M = frame_placement(self.model, q, self.frame_id)
        v_loc = frame_velocity(self.model, q, v, self.frame_id, local=True)
        v_lwa = (M.R @ v_loc[:3][..., None])[..., 0]
        return v_lwa[..., :2] * torch.exp(-M.p[..., 2:3] * self.slope)


@dataclasses.dataclass(frozen=True)
class FrameCollisionResidual(_StateResidual):
    """r = the signed distance of two attached collision primitives
    (:mod:`aligator_tpu_torch.multibody.geometry`)."""

    model: MultibodyModel
    geom1: Any = static_field()
    geom2: Any = static_field()

    def value_x(self, x):
        return pair_distance(self.model, x[..., :self.model.nq], self.geom1, self.geom2)[None]


@dataclasses.dataclass(frozen=True)
class CenterOfMassTranslationResidual(_StateResidual):
    """r = com(q) − c_ref."""

    model: MultibodyModel
    ref: torch.Tensor  # (3,)

    def value_x(self, x):
        return com_position(self.model, x[..., :self.model.nq]) - self.ref


@dataclasses.dataclass(frozen=True)
class CenterOfMassVelocityResidual(_StateResidual):
    """r = d(com)/dt − v_ref = J_com(q)·v − v_ref."""

    model: MultibodyModel
    ref: torch.Tensor  # (3,)

    def value_x(self, x):
        nq = self.model.nq
        return _com_velocity(self.model, x[..., :nq], x[..., nq:]) - self.ref


@dataclasses.dataclass(frozen=True)
class DCMPositionResidual(_StateResidual):
    """The divergent component of motion ξ = c + ċ/ω against a reference
    (ω² = g/z_c)."""

    model: MultibodyModel
    ref: torch.Tensor  # (3,)
    omega: torch.Tensor  # ()

    def value_x(self, x):
        nq = self.model.nq
        q, v = x[..., :nq], x[..., nq:]
        return com_position(self.model, q) + _com_velocity(self.model, q, v) / self.omega \
            - self.ref


@dataclasses.dataclass(frozen=True)
class CentroidalMomentumResidual(_StateResidual):
    """r = h(q, v) − h_ref ∈ R⁶."""

    model: MultibodyModel
    ref: torch.Tensor  # (6,)

    def value_x(self, x):
        nq = self.model.nq
        return centroidal_momentum(self.model, x[..., :nq], x[..., nq:])[0] - self.ref


@dataclasses.dataclass(frozen=True)
class CentroidalMomentumDerivativeResidual(StageFunction):
    """r = ḣ(q, u) = m·g + Σ of the active contact wrenches about the CoM,
    the contact forces read from the controls (kinodynamic
    formulations)."""

    model: MultibodyModel
    active: torch.Tensor  # (nk,)
    frame_ids: Any = static_field()
    force_size: int = static_field(default=3)

    def value(self, x, u):
        model = self.model
        q = x[..., :model.nq]
        nk, fs = len(self.frame_ids), self.force_size
        com = com_position(model, q)
        oM = forward_kinematics(model, q)
        lin = model.mass.sum() * model.gravity
        ang = q.new_zeros(3)
        F = u[..., :nk * fs].reshape(nk, fs)
        for i, fid in enumerate(self.frame_ids):
            fr = model.frames[fid]
            M = se3_mul(oM[fr.parent_joint], SE3T(model.frame_R[fid], model.frame_p[fid]))
            fi = self.active[i] * F[i, :3]
            lin = lin + fi
            ang = ang + cross(M.p - com, fi)
            if fs == 6:
                ang = ang + self.active[i] * F[i, 3:]
        return torch.cat([lin, ang])


@dataclasses.dataclass(frozen=True)
class GravityCompensationResidual(StageFunction):
    """r = B·u − g(q)."""

    model: MultibodyModel
    actuation: torch.Tensor  # (nv, nu)

    def value(self, x, u):
        q = x[..., :self.model.nq]
        return (self.actuation @ u[..., None])[..., 0] - gravity_torque(self.model, q)
