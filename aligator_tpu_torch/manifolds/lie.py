"""Lie-group manifolds SO(2), SO(3), SE(2), SE(3) (port of
``aligator_tpu.manifolds.lie``).

Coordinates:
  SO2: x = [cos θ, sin θ]                       (nx=2, ndx=1)
  SO3: x = quaternion [qx, qy, qz, qw]          (nx=4, ndx=3)
  SE2: x = [px, py, cos θ, sin θ]               (nx=4, ndx=3)
  SE3: x = [px, py, pz, qx, qy, qz, qw]         (nx=7, ndx=6), motion = (v, ω)

⊕/⊖ use the local (right-translation) convention: x ⊕ v = x·exp(v),
x1 ⊖ x0 = log(x0⁻¹ x1). Small-angle branches use the double-``where``
pattern (the unselected branch is fed a safe value), so forward-mode
derivatives stay finite at the identity. Scalars per point keep a
trailing axis of 1 (``keepdim``): under ``torch.func.jvp``, a 0-dim
tensor combined with a Python float gets a float64 tangent (torch 2.13),
which breaks float32 Jacobians.
"""

from __future__ import annotations

import dataclasses

import torch

from aligator_tpu_torch.manifolds.base import Manifold

_EPS2 = 1e-14  # squared-angle threshold for the Taylor branches


def _safe_sqrt(x2):
    return torch.sqrt(torch.where(x2 < _EPS2, torch.ones_like(x2), x2))


def cross(a, b):
    """a × b over the last axis, leading axes broadcast."""
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


# ---------------------------------------------------------------------------
# quaternion utilities (scalar-last [x, y, z, w])
# ---------------------------------------------------------------------------


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_exp(w):
    """exp: R³ (rotation vector) → unit quaternion."""
    a2 = (w * w).sum(-1, keepdim=True)
    a = _safe_sqrt(a2)
    small = a2 < _EPS2
    k = torch.where(small, 0.5 - a2 / 48.0, torch.sin(0.5 * a) / a)
    c = torch.where(small, 1.0 - a2 / 8.0, torch.cos(0.5 * a))
    return torch.cat([w * k, c], dim=-1)


def quat_log(q):
    """log: unit quaternion → rotation vector (shortest path)."""
    sign = torch.where(q[..., 3:] < 0.0, -torch.ones_like(q[..., 3:]),
                       torch.ones_like(q[..., 3:]))
    q = q * sign
    v, w = q[..., :3], q[..., 3:]
    n2 = (v * v).sum(-1, keepdim=True)
    n = _safe_sqrt(n2)
    theta = 2.0 * torch.atan2(n, w)
    small = n2 < _EPS2
    k = torch.where(small, 2.0 / w - 2.0 * n2 / (3.0 * w ** 3), theta / n)
    return v * k


def quat_rotate(q, p):
    """R(q) p for a unit quaternion q."""
    v, w = q[..., :3], q[..., 3:]
    t = 2.0 * cross(v, p)
    return p + w * t + cross(v, t)


def quat_to_mat(q):
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def skew(w):
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], dim=-2)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_left_jacobian(w):
    """V(ω) = I + (1-cosθ)/θ² [ω]× + (θ-sinθ)/θ³ [ω]×²."""
    t2 = (w * w).sum(-1, keepdim=True)
    t = _safe_sqrt(t2)
    small = t2 < _EPS2
    # the denominators are guarded too: a where does not stop a NaN
    # derivative of the unselected branch (0·inf = NaN)
    t2s = torch.where(small, torch.ones_like(t2), t2)
    c1 = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    c2 = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - torch.sin(t)) / (t2s * t))
    W = skew(w)
    return _eye3(w) + c1[..., None] * W + c2[..., None] * (W @ W)


def so3_left_jacobian_inv(w):
    """V(ω)⁻¹ = I − ½[ω]× + (1/θ² − (1+cosθ)/(2θ sinθ)) [ω]×²."""
    t2 = (w * w).sum(-1, keepdim=True)
    t = _safe_sqrt(t2)
    small = t2 < _EPS2
    one = torch.ones_like(t2)
    denom = torch.where(small, one, 2.0 * t * torch.sin(t))
    t2s = torch.where(small, one, t2)
    c = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                    1.0 / t2s - (1.0 + torch.cos(t)) / denom)
    W = skew(w)
    return _eye3(w) - 0.5 * W + c[..., None] * (W @ W)


# ---------------------------------------------------------------------------


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class SO2(Manifold):
    @property
    def nx(self) -> int:
        return 2

    @property
    def ndx(self) -> int:
        return 1

    def integrate(self, x, v):
        c, s = x[..., 0], x[..., 1]
        cv, sv = torch.cos(v[..., 0]), torch.sin(v[..., 0])
        return torch.stack([c * cv - s * sv, s * cv + c * sv], dim=-1)

    def difference(self, x0, x1):
        c0, s0 = x0[..., 0], x0[..., 1]
        c1, s1 = x1[..., 0], x1[..., 1]
        return torch.atan2(c0 * s1 - s0 * c1, c0 * c1 + s0 * s1)[..., None]

    def neutral(self, dtype=torch.float64, device=None):
        return torch.tensor([1.0, 0.0], dtype=dtype, device=device)

    def is_normalized(self, x):
        return ((x * x).sum(-1) - 1.0).abs() < 1e-6

    def normalize(self, x):
        return _unit(x)


@dataclasses.dataclass(frozen=True)
class SO3(Manifold):
    @property
    def nx(self) -> int:
        return 4

    @property
    def ndx(self) -> int:
        return 3

    def integrate(self, x, v):
        return quat_mul(x, quat_exp(v))

    def difference(self, x0, x1):
        return quat_log(quat_mul(quat_conj(x0), x1))

    def neutral(self, dtype=torch.float64, device=None):
        return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)

    def is_normalized(self, x):
        return ((x * x).sum(-1) - 1.0).abs() < 1e-6

    def normalize(self, x):
        return _unit(x)

    # closed-form Jacobians (local convention)
    def jintegrate(self, x, v, arg):
        if arg == 0:
            return quat_to_mat(quat_exp(v)).mT  # exp(-[v]×) = Ad_{exp(v)}⁻¹
        return so3_left_jacobian(-v)  # right Jacobian Jr(v) = Jl(-v)

    def jdifference(self, x0, x1, arg):
        d = self.difference(x0, x1)
        if arg == 1:
            return so3_left_jacobian_inv(-d)
        return -so3_left_jacobian_inv(d)


@dataclasses.dataclass(frozen=True)
class SE2(Manifold):
    @property
    def nx(self) -> int:
        return 4

    @property
    def ndx(self) -> int:
        return 3

    @staticmethod
    def _ab(w):
        """(a, b) of V(ω) = [[a, -b], [b, a]]: a = sinω/ω, b = (1-cosω)/ω;
        ω (…, 1)."""
        w2 = w * w
        small = w2 < _EPS2
        ws = torch.where(small, torch.ones_like(w), w)
        a = torch.where(small, 1.0 - w2 / 6.0, torch.sin(ws) / ws)
        b = torch.where(small, w / 2.0 - w2 * w / 24.0, (1.0 - torch.cos(ws)) / ws)
        return a, b

    @staticmethod
    def _rot(c, s, v):
        """[[c, -s], [s, c]] v over the last axis; c, s (…, 1)."""
        return torch.cat([c * v[..., :1] - s * v[..., 1:], s * v[..., :1] + c * v[..., 1:]],
                         dim=-1)

    def integrate(self, x, v):
        p, c, s = x[..., :2], x[..., 2:3], x[..., 3:4]
        rho, w = v[..., :2], v[..., 2:3]
        a, b = self._ab(w)
        p_new = p + self._rot(c, s, self._rot(a, b, rho))
        cw, sw = torch.cos(w), torch.sin(w)
        return torch.cat([p_new, c * cw - s * sw, s * cw + c * sw], dim=-1)

    def difference(self, x0, x1):
        p0, c0, s0 = x0[..., :2], x0[..., 2:3], x0[..., 3:4]
        p1, c1, s1 = x1[..., :2], x1[..., 2:3], x1[..., 3:4]
        w = torch.atan2(c0 * s1 - s0 * c1, c0 * c1 + s0 * s1)
        a, b = self._ab(w)
        # V⁻¹ R0ᵀ dp, V⁻¹ = [[a, b], [-b, a]] / (a² + b²)
        rho = self._rot(a, -b, self._rot(c0, -s0, p1 - p0)) / (a * a + b * b)
        return torch.cat([rho, w], dim=-1)

    def neutral(self, dtype=torch.float64, device=None):
        return torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=dtype, device=device)

    def is_normalized(self, x):
        return ((x[..., 2:] ** 2).sum(-1) - 1.0).abs() < 1e-6

    def normalize(self, x):
        return torch.cat([x[..., :2], _unit(x[..., 2:])], dim=-1)


@dataclasses.dataclass(frozen=True)
class SE3(Manifold):
    @property
    def nx(self) -> int:
        return 7

    @property
    def ndx(self) -> int:
        return 6

    def integrate(self, x, v):
        p, q = x[..., :3], x[..., 3:]
        rho, w = v[..., :3], v[..., 3:]
        t = (so3_left_jacobian(w) @ rho[..., None])[..., 0]
        return torch.cat([p + quat_rotate(q, t), quat_mul(q, quat_exp(w))], dim=-1)

    def difference(self, x0, x1):
        p0, q0 = x0[..., :3], x0[..., 3:]
        p1, q1 = x1[..., :3], x1[..., 3:]
        q0c = quat_conj(q0)
        w = quat_log(quat_mul(q0c, q1))
        p_rel = quat_rotate(q0c, p1 - p0)
        rho = (so3_left_jacobian_inv(w) @ p_rel[..., None])[..., 0]
        return torch.cat([rho, w], dim=-1)

    def neutral(self, dtype=torch.float64, device=None):
        return torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)

    def is_normalized(self, x):
        return ((x[..., 3:] ** 2).sum(-1) - 1.0).abs() < 1e-6

    def normalize(self, x):
        return torch.cat([x[..., :3], _unit(x[..., 3:])], dim=-1)
