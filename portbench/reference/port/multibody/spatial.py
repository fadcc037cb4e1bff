"""Spatial (6D) rigid-body algebra in Pinocchio conventions (port of
``aligator_tpu.multibody.spatial``):

* motions and forces are (linear, angular) 6-vectors;
* a placement X = (R, p) maps local coordinates to the parent or world
  frame: x_world = R x_local + p;
* a body's spatial inertia is its mass m, CoM offset c (local) and
  rotational inertia I_c about the CoM.

Every function acts on the trailing axes, so leading axes broadcast.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.port.manifolds.lie import cross, skew, so3_left_jacobian_inv


class SE3T(NamedTuple):
    """Placement: rotation matrix R (…, 3, 3) and translation p (…, 3)."""

    R: torch.Tensor
    p: torch.Tensor


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def se3_mul(a: SE3T, b: SE3T) -> SE3T:
    """Compose placements: (a·b) x = a (b x)."""
    return SE3T(a.R @ b.R, a.p + _mv(a.R, b.p))


def se3_inv(a: SE3T) -> SE3T:
    Rt = a.R.mT
    return SE3T(Rt, -_mv(Rt, a.p))


def se3_act_motion(X: SE3T, m):
    """A motion (v, w) from X's local frame to its target frame."""
    Rv, Rw = _mv(X.R, m[..., :3]), _mv(X.R, m[..., 3:])
    return torch.cat([Rv + cross(X.p, Rw), Rw], dim=-1)


def se3_act_inv_motion(X: SE3T, m):
    """A motion from the target frame to X's local frame."""
    v, w = m[..., :3], m[..., 3:]
    Rt = X.R.mT
    return torch.cat([_mv(Rt, v - cross(X.p, w)), _mv(Rt, w)], dim=-1)


def se3_act_force(X: SE3T, f):
    """A force (f, n) from X's local frame to its target frame."""
    Rf, Rn = _mv(X.R, f[..., :3]), _mv(X.R, f[..., 3:])
    return torch.cat([Rf, Rn + cross(X.p, Rf)], dim=-1)


def motion_cross(m1, m2):
    """Motion × motion (spatial cross product)."""
    v1, w1 = m1[..., :3], m1[..., 3:]
    v2, w2 = m2[..., :3], m2[..., 3:]
    return torch.cat([cross(w1, v2) + cross(v1, w2), cross(w1, w2)], dim=-1)


def motion_cross_force(m, f):
    """Motion ×* force (dual cross product)."""
    v, w = m[..., :3], m[..., 3:]
    fl, n = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, fl), cross(w, n) + cross(v, fl)], dim=-1)


class Inertia(NamedTuple):
    """Spatial inertia: mass (…,), CoM offset c (…, 3), rotational inertia
    about the CoM I_c (…, 3, 3), all in the local (joint) frame."""

    mass: torch.Tensor
    com: torch.Tensor
    I_c: torch.Tensor

    def matrix(self) -> torch.Tensor:
        """Dense 6×6 spatial inertia ((lin, ang) ordering)."""
        m = self.mass[..., None, None]
        C = skew(self.com)
        Ct = C.mT
        I_o = self.I_c + m * (C @ Ct)  # parallel axis: I_c − m[c]×[c]×
        eye = torch.eye(3, dtype=self.com.dtype, device=self.com.device)
        top = torch.cat([m * eye, m * Ct], dim=-1)
        bot = torch.cat([m * C, I_o], dim=-1)
        return torch.cat([top, bot], dim=-2)


def inertia_mul(inertia_mat, m):
    """A dense 6×6 spatial inertia applied to a motion."""
    return _mv(inertia_mat, m)


def se3_adjoint(X: SE3T) -> torch.Tensor:
    """6×6 motion transform Ad_X, (lin, ang) ordering: [[R, [p]× R], [0, R]]."""
    top = torch.cat([X.R, skew(X.p) @ X.R], dim=-1)
    bot = torch.cat([torch.zeros_like(X.R), X.R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inertia_transform(inertia_mat, X: SE3T) -> torch.Tensor:
    """A 6×6 spatial inertia given in X's local frame, expressed in X's
    target frame: Ad_{X⁻¹}ᵀ · I_local · Ad_{X⁻¹}."""
    Ad_inv = se3_adjoint(se3_inv(X))
    return Ad_inv.mT @ inertia_mat @ Ad_inv


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation-matrix logarithm ω = log3(R), with finite derivatives at the
    identity. The θ/sin θ scale is expressed through cos θ behind two
    ``where`` guards: arccos has an infinite derivative at 1, which would
    otherwise poison the derivatives of frame residuals and contact errors.
    The series branch takes θ ≤ ~1.4e-3: its margin 1e-6 must exceed the
    dtype's spacing at 1.0, or float32 rounds 1 − margin to exactly 1 and
    the guard never fires at the identity (the float32 NaN the JAX package
    recorded). Valid for θ < π − ε."""
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1, keepdim=True)  # (…, 1): see lie.py
    cos_th = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    w_skew = 0.5 * (R - R.mT)  # sin θ · [axis]×
    w = torch.stack([w_skew[..., 2, 1], w_skew[..., 0, 2], w_skew[..., 1, 0]], dim=-1)
    near0 = cos_th >= 1.0 - 1e-6
    cos_safe = torch.where(near0, torch.zeros_like(cos_th), cos_th)
    th = torch.arccos(cos_safe)
    sin_safe = torch.where(near0, torch.ones_like(th), torch.sin(th))
    # θ/sin θ = 1 + θ²/6 + 7θ⁴/360 + …, with θ² ≈ 2(1 − cos θ)
    one_m_c = 1.0 - cos_th
    scale = torch.where(near0, 1.0 + one_m_c / 3.0 + 7.0 * one_m_c * one_m_c / 90.0,
                        th / sin_safe)
    return w * scale


def se3_log(X: SE3T) -> torch.Tensor:
    """log6 of a placement → (ρ, ω), with finite derivatives at the identity."""
    omega = so3_log(X.R)
    return torch.cat([_mv(so3_left_jacobian_inv(omega), X.p), omega], dim=-1)
