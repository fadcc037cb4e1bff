"""Multibody model: kinematic tree of joints, body inertias and named
frames (port of ``aligator_tpu.multibody.model``).

The tree (joint types, parents, frame attachments) is static metadata;
placements and inertias are tensor leaves. Supported joints: revolute
(about a fixed local axis), prismatic, and free-flyer (floating base,
q = [p(3), quat(4)], local-frame velocity).

Joints that follow one another in the joint order and share a type form
a *run*; per-joint work that does not depend on the tree (joint
transforms, motion subspaces, chart maps) is done once per run on
stacked tensors, which keeps the number of torch operations per call
small.

``configuration_integrate`` and ``configuration_difference`` are the
port's names for the JAX package's ``spaces.integrate_configuration``
and its per-joint ``joint_integrate`` / ``joint_difference`` (one
operation set per run instead of one per joint).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from portbench.reference.port.manifolds.lie import SE3, quat_to_mat
from portbench.reference.port.utils.device import resolve_device
from portbench.reference.port.utils.tree import static_field


@dataclasses.dataclass(frozen=True)
class JointSpec:
    jtype: str  # "revolute" | "prismatic" | "freeflyer"
    axis: Optional[Tuple[float, float, float]] = None

    @property
    def nq(self) -> int:
        return {"revolute": 1, "prismatic": 1, "freeflyer": 7}[self.jtype]

    @property
    def nv(self) -> int:
        return {"revolute": 1, "prismatic": 1, "freeflyer": 6}[self.jtype]


@dataclasses.dataclass(frozen=True)
class FrameSpec:
    name: str
    parent_joint: int


class Run(NamedTuple):
    """Joints j0..j1-1, all of type ``jtype``, with coordinates q[q0:q1]
    and velocities v[v0:v1]."""

    jtype: str
    j0: int
    j1: int
    q0: int
    q1: int
    v0: int
    v1: int


@functools.lru_cache(maxsize=None)
def subtree_ends(parents: Tuple[int, ...]) -> Tuple[int, ...]:
    """End (exclusive) of each joint's subtree. Joints are numbered depth
    first, so the subtree of joint j is the range [j, end_j)."""
    nj = len(parents)
    ends = list(range(1, nj + 1))
    for i in range(nj - 1, -1, -1):
        if parents[i] >= 0:
            ends[parents[i]] = max(ends[parents[i]], ends[i])
    for j in range(nj):
        for k in range(j + 1, ends[j]):
            a = k
            while a > j:
                a = parents[a]
            if a != j:
                raise ValueError("joints must be numbered depth first")
    return tuple(ends)


@functools.lru_cache(maxsize=None)
def joint_runs(joints: Tuple[JointSpec, ...]) -> Tuple[Run, ...]:
    runs, q, v = [], 0, 0
    for i, spec in enumerate(joints):
        if runs and runs[-1].jtype == spec.jtype and spec.jtype != "freeflyer":
            r = runs[-1]
            runs[-1] = r._replace(j1=i + 1, q1=q + spec.nq, v1=v + spec.nv)
        else:
            runs.append(Run(spec.jtype, i, i + 1, q, q + spec.nq, v, v + spec.nv))
        q, v = q + spec.nq, v + spec.nv
    return tuple(runs)


@dataclasses.dataclass(frozen=True, eq=False)
class MultibodyModel:
    """Kinematic tree. Joint i's placement (jplace) is the fixed transform
    from its parent joint's frame to its own frame origin at q = 0.
    ``axis`` (nj, 3) holds each 1-dof joint's axis (zero for a free
    flyer), ``axis_K`` and ``axis_K2`` its cross-product matrix and that
    matrix squared, and ``subtree`` (nj, nj) is 1 where joint k is in the
    subtree of joint j: the static tree as tensors, made by :meth:`create`."""

    jplace_R: torch.Tensor  # (nj, 3, 3)
    jplace_p: torch.Tensor  # (nj, 3)
    mass: torch.Tensor  # (nj,)
    com: torch.Tensor  # (nj, 3)      body CoM in the joint frame
    inertia: torch.Tensor  # (nj, 3, 3) rotational inertia about the CoM
    frame_R: torch.Tensor  # (nf, 3, 3) frame placement in its joint's frame
    frame_p: torch.Tensor  # (nf, 3)
    gravity: torch.Tensor  # (3,)
    axis: torch.Tensor  # (nj, 3)
    axis_K: torch.Tensor  # (nj, 3, 3) [axis]×
    axis_K2: torch.Tensor  # (nj, 3, 3) [axis]×²
    subtree: torch.Tensor  # (nj, nj)
    joints: Tuple[JointSpec, ...] = static_field()
    parents: Tuple[int, ...] = static_field()  # -1 = world
    frames: Tuple[FrameSpec, ...] = static_field()

    @classmethod
    def create(cls, jplace_R, jplace_p, mass, com, inertia, frame_R, frame_p, gravity,
               joints, parents, frames, dtype=torch.float64, device=None):
        """A model from array-likes (numpy or torch) of the JAX model's
        leaves and its static tree; tensors go to ``device`` (default: the
        card; raises without one) and ``dtype``."""
        device = resolve_device(device)
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            device=device, dtype=dtype)
        axis = np.array([s.axis if s.axis is not None else (0.0, 0.0, 0.0)
                         for s in joints], dtype=np.float64)
        Kx = np.stack([np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]]) for x, y, z in axis])
        ends = subtree_ends(tuple(parents))
        sub = np.array([[float(j <= k < ends[j]) for k in range(len(ends))]
                        for j in range(len(ends))])
        return cls(jplace_R=t(jplace_R), jplace_p=t(jplace_p), mass=t(mass), com=t(com),
                   inertia=t(inertia), frame_R=t(frame_R), frame_p=t(frame_p),
                   gravity=t(gravity), axis=t(axis), axis_K=t(Kx),
                   axis_K2=t(Kx @ Kx), subtree=t(sub), joints=tuple(joints),
                   parents=tuple(parents), frames=tuple(frames))

    @property
    def njoints(self) -> int:
        return len(self.joints)

    @property
    def nq(self) -> int:
        return sum(j.nq for j in self.joints)

    @property
    def nv(self) -> int:
        return sum(j.nv for j in self.joints)

    @property
    def v_offsets(self) -> Tuple[int, ...]:
        return tuple(int(o) for o in np.cumsum([0] + [j.nv for j in self.joints])[:-1])

    @property
    def runs(self) -> Tuple[Run, ...]:
        return joint_runs(self.joints)

    def frame_id(self, name: str) -> int:
        for i, f in enumerate(self.frames):
            if f.name == name:
                return i
        raise KeyError(name)

    def neutral_q(self, dtype=torch.float64, device=None) -> torch.Tensor:
        parts = []
        for j in self.joints:
            parts += [0, 0, 0, 0, 0, 0, 1] if j.jtype == "freeflyer" else [0]
        return torch.tensor(parts, dtype=dtype, device=device)


def joint_transforms(model: MultibodyModel, q: torch.Tensor):
    """Per-joint local placements M_i = jplace_i ∘ Xj_i(q_i) as stacked
    (R (nj, 3, 3), p (nj, 3)), one batch of operations per run."""
    Rs, ps = [], []
    for r in model.runs:
        pR, pp = model.jplace_R[r.j0:r.j1], model.jplace_p[r.j0:r.j1]
        qr = q[r.q0:r.q1]
        if r.jtype == "freeflyer":
            R = pR @ quat_to_mat(qr[3:])[None]
            p = pp + (pR @ qr[:3, None])[..., 0]
        elif r.jtype == "revolute":
            # Rodrigues: exp(θ[a]×) = I + sin θ [a]× + (1 − cos θ)[a]×²
            th = qr[:, None, None]
            R = pR + pR @ (torch.sin(th) * model.axis_K[r.j0:r.j1]
                           + (1.0 - torch.cos(th)) * model.axis_K2[r.j0:r.j1])
            p = pp
        elif r.jtype == "prismatic":
            R = pR
            p = pp + (pR @ (model.axis[r.j0:r.j1] * qr[:, None])[..., None])[..., 0]
        else:  # pragma: no cover
            raise ValueError(r.jtype)
        Rs.append(R)
        ps.append(p)
    return torch.cat(Rs), torch.cat(ps)


def joint_motions(model: MultibodyModel, v: torch.Tensor) -> torch.Tensor:
    """S_i v_i of every joint, stacked (nj, 6), in the joints' local
    frames. ``v`` may carry leading axes: (..., nv) → (..., nj, 6)."""
    parts = []
    for r in model.runs:
        vr = v[..., r.v0:r.v1]
        if r.jtype == "freeflyer":
            parts.append(vr[..., None, :])
        else:
            m = model.axis[r.j0:r.j1] * vr[..., :, None]
            z = torch.zeros_like(m)
            parts.append(torch.cat([z, m] if r.jtype == "revolute" else [m, z], dim=-1))
    return torch.cat(parts, dim=-2)


def configuration_integrate(model: MultibodyModel, q, dq):
    """q ⊕ dq on the configuration manifold, one operation set per run."""
    parts = []
    for r in model.runs:
        qr, vr = q[..., r.q0:r.q1], dq[..., r.v0:r.v1]
        parts.append(SE3().integrate(qr, vr) if r.jtype == "freeflyer" else qr + vr)
    return torch.cat(parts, dim=-1)


def configuration_difference(model: MultibodyModel, q0, q1):
    parts = []
    for r in model.runs:
        a, b = q0[..., r.q0:r.q1], q1[..., r.q0:r.q1]
        parts.append(SE3().difference(a, b) if r.jtype == "freeflyer" else b - a)
    return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# model builders
# ---------------------------------------------------------------------------


def _box_inertia(m, lx, ly, lz):
    return m / 12.0 * np.diag([ly ** 2 + lz ** 2, lx ** 2 + lz ** 2, lx ** 2 + ly ** 2])


def build_serial_chain(n_links: int = 6, link_length: float = 0.3, link_mass: float = 1.5,
                       axes: Optional[list] = None, free_flyer: bool = False,
                       dtype=torch.float64, device=None) -> MultibodyModel:
    """A serial manipulator: ``n_links`` revolute joints about ``axes``
    (cycled; by default the UR5-like z, y, y, y, z, y), a tool frame
    ``tool0`` at the tip; with ``free_flyer`` the chain rides on a
    floating 8 kg box (``n_links=0, free_flyer=True`` is a bare rigid
    body, the quadrotor's airframe). The same model as the JAX package's
    ``build_serial_chain``, on ``device`` (default: the card; raises
    without one)."""
    if axes is None:
        axes = [(0, 0, 1), (0, 1, 0), (0, 1, 0), (0, 1, 0), (0, 0, 1), (0, 1, 0)]
    joints, parents, jp, mass, com, inert = [], [], [], [], [], []
    if free_flyer:
        joints.append(JointSpec("freeflyer"))
        parents.append(-1)
        jp.append(np.zeros(3))
        mass.append(8.0)
        com.append(np.zeros(3))
        inert.append(_box_inertia(8.0, 0.3, 0.3, 0.3))
    start = len(joints)
    for k in range(n_links):
        joints.append(JointSpec("revolute", tuple(axes[k % len(axes)])))
        parents.append(start + k - 1 if k > 0 else (0 if free_flyer else -1))
        jp.append(np.array([0.0, 0.0, link_length if k > 0 else 0.1]))
        mass.append(link_mass)
        com.append(np.array([0.0, 0.0, link_length / 2]))
        inert.append(_box_inertia(link_mass, 0.05, 0.05, link_length))
    return MultibodyModel.create(
        np.stack([np.eye(3)] * len(joints)), np.stack(jp), np.asarray(mass), np.stack(com),
        np.stack(inert), np.eye(3)[None], np.array([[0.0, 0.0, link_length]]),
        np.array([0.0, 0.0, -9.81]), joints, parents, (FrameSpec("tool0", len(joints) - 1),),
        dtype=dtype, device=device)


def build_humanoid(dtype=torch.float64, device=None) -> MultibodyModel:
    """Talos-dimension humanoid: a free flyer and 22 actuated joints (legs
    2×6, torso 2, arms 2×4), so nq = 29, nv = 28, nu = 22, in the
    reference's joint order (left leg, right leg, torso, left arm, right
    arm). Frames ``left_sole`` and ``right_sole`` under the ankle-roll
    joints and ``torso`` on the chest. The same model as the JAX
    package's ``build_humanoid``, on ``device`` (default: the card;
    raises without one)."""
    joints, parents, jR, jp, mass, com, inert = [], [], [], [], [], [], []

    def add(jtype, axis, parent, p, m, c_off, half_dims):
        joints.append(JointSpec(jtype, axis))
        parents.append(parent)
        jR.append(np.eye(3))
        jp.append(np.asarray(p, float))
        mass.append(m)
        com.append(np.asarray(c_off, float))
        inert.append(_box_inertia(m, *[2 * h for h in half_dims]))
        return len(joints) - 1

    Z, X, Y = (0, 0, 1), (1, 0, 0), (0, 1, 0)
    thigh, shin, ankle_h = 0.38, 0.38, 0.107
    pelvis = add("freeflyer", None, -1, (0, 0, 0), 14.0, (0, 0, 0.05), (0.12, 0.15, 0.1))

    def add_leg(side):
        s = 1.0 if side == "left" else -1.0
        hip_yaw = add("revolute", Z, pelvis, (0.0, s * 0.085, -0.1), 1.0, (0, 0, 0),
                      (0.04, 0.04, 0.04))
        hip_roll = add("revolute", X, hip_yaw, (0, 0, 0), 1.5, (0, 0, 0), (0.05, 0.05, 0.05))
        hip_pitch = add("revolute", Y, hip_roll, (0, 0, 0), 6.0, (0, 0, -thigh / 2),
                        (0.07, 0.07, thigh / 2))
        knee = add("revolute", Y, hip_pitch, (0, 0, -thigh), 4.0, (0, 0, -shin / 2),
                   (0.06, 0.06, shin / 2))
        ankle_pitch = add("revolute", Y, knee, (0, 0, -shin), 0.8, (0, 0, 0),
                          (0.04, 0.04, 0.04))
        return add("revolute", X, ankle_pitch, (0, 0, 0), 1.2, (0.02, 0, -ankle_h / 2),
                   (0.1, 0.06, ankle_h / 2))

    la = add_leg("left")
    ra = add_leg("right")
    torso_1 = add("revolute", Z, pelvis, (0, 0, 0.15), 2.0, (0, 0, 0.1), (0.1, 0.1, 0.1))
    torso_2 = add("revolute", Y, torso_1, (0, 0, 0.05), 17.0, (0, 0, 0.15), (0.15, 0.2, 0.25))

    def add_arm(side):
        s = 1.0 if side == "left" else -1.0
        sh_pitch = add("revolute", Y, torso_2, (0.0, s * 0.25, 0.25), 1.5, (0, 0, 0),
                       (0.05, 0.05, 0.05))
        sh_roll = add("revolute", X, sh_pitch, (0, 0, 0), 1.5, (0, 0, -0.12),
                      (0.05, 0.05, 0.12))
        sh_yaw = add("revolute", Z, sh_roll, (0, 0, -0.24), 1.0, (0, 0, -0.06),
                     (0.04, 0.04, 0.08))
        add("revolute", Y, sh_yaw, (0, 0, -0.12), 1.3, (0, 0, -0.12), (0.04, 0.04, 0.12))

    add_arm("left")
    add_arm("right")
    frames = (FrameSpec("left_sole", la), FrameSpec("right_sole", ra),
              FrameSpec("torso", torso_2))
    return MultibodyModel.create(
        np.stack(jR), np.stack(jp), np.asarray(mass), np.stack(com), np.stack(inert),
        np.stack([np.eye(3)] * 3),
        np.array([[0.0, 0.0, -ankle_h], [0.0, 0.0, -ankle_h], [0.0, 0.0, 0.3]]),
        np.array([0.0, 0.0, -9.81]), joints, parents, frames, dtype=dtype, device=device)


def humanoid_half_sitting(model: MultibodyModel, dtype=torch.float64,
                          device=None) -> torch.Tensor:
    """Half-sitting posture (bent knees, soles flat): the free flyer at
    standing height, hip_pitch −0.4 / knee 0.8 / ankle_pitch −0.4 per leg."""
    q = np.zeros(model.nq)
    thigh, shin, ankle_h = 0.38, 0.38, 0.107
    q[2] = 0.1 + thigh * np.cos(0.4) + shin * np.cos(0.4) + ankle_h
    q[6] = 1.0  # quaternion w
    for off in (7, 13):  # left and right leg: [yaw, roll, pitch, knee, ankle p, ankle r]
        q[off + 2] = -0.4
        q[off + 3] = 0.8
        q[off + 4] = -0.4
    return torch.tensor(q, dtype=dtype, device=device)


def build_quadruped(dtype=torch.float64, device=None) -> MultibodyModel:
    """Solo-12-class quadruped: a free flyer and 12 actuated joints (4 legs
    of [HAA (x roll), HFE (y pitch), KFE (y pitch)]), so nq = 19, nv = 18,
    nu = 12; frames ``{fl,fr,hl,hr}_foot`` at the lower-leg tips. The same
    model as the JAX package's ``build_quadruped``, on ``device`` (default:
    the card; raises without one)."""
    joints, parents, jp, mass, com, inert = [], [], [], [], [], []

    def add(jtype, axis, parent, p, m, c_off, half_dims):
        joints.append(JointSpec(jtype, axis))
        parents.append(parent)
        jp.append(np.asarray(p, float))
        mass.append(m)
        com.append(np.asarray(c_off, float))
        inert.append(_box_inertia(m, *[2 * h for h in half_dims]))
        return len(joints) - 1

    X, Y = (1, 0, 0), (0, 1, 0)
    upper, lower = 0.16, 0.16
    base = add("freeflyer", None, -1, (0, 0, 0), 1.2, (0, 0, 0), (0.17, 0.1, 0.04))

    def add_leg(fx, fy):
        haa = add("revolute", X, base, (fx * 0.19, fy * 0.1046, 0.0), 0.15, (0, 0, 0),
                  (0.03, 0.03, 0.03))
        hfe = add("revolute", Y, haa, (0, fy * 0.014, 0), 0.2, (0, 0, -upper / 2),
                  (0.03, 0.03, upper / 2))
        return add("revolute", Y, hfe, (0, 0, -upper), 0.1, (0, 0, -lower / 2),
                   (0.02, 0.02, lower / 2))

    legs = [add_leg(fx, fy) for fx, fy in ((+1, +1), (+1, -1), (-1, +1), (-1, -1))]
    frames = tuple(FrameSpec(f"{n}_foot", k) for n, k in zip(("fl", "fr", "hl", "hr"), legs))
    return MultibodyModel.create(
        np.stack([np.eye(3)] * len(joints)), np.stack(jp), np.asarray(mass), np.stack(com),
        np.stack(inert), np.stack([np.eye(3)] * 4), np.tile(np.array([[0.0, 0.0, -lower]]), (4, 1)),
        np.array([0.0, 0.0, -9.81]), joints, parents, frames, dtype=dtype, device=device)


def quadruped_standing(model: MultibodyModel, dtype=torch.float64,
                       device=None) -> torch.Tensor:
    """Solo standing posture: bent legs (HFE ±0.8, KFE ∓1.6, the front and
    hind knees folded inward), the base at the resulting height; on the
    model's device unless ``device`` is given."""
    q = np.zeros(model.nq)
    upper = lower = 0.16
    q[2] = upper * np.cos(0.8) + lower * np.cos(0.8)
    q[6] = 1.0  # quaternion w
    for i, off in enumerate(range(7, 7 + 12, 3)):  # legs fl, fr, hl, hr: [HAA, HFE, KFE]
        front = i < 2
        q[off + 1] = 0.8 if front else -0.8
        q[off + 2] = -1.6 if front else 1.6
    return torch.tensor(q, dtype=dtype, device=model.mass.device if device is None else device)
