"""URDF import and export: a URDF robot description as a MultibodyModel
and back (port of ``aligator_tpu.multibody.urdf``).

Conventions as in Pinocchio and the JAX package: every movable URDF joint
(revolute, continuous, prismatic, floating) becomes a model joint whose
frame is the child-link frame; fixed joints are welded, the child link's
inertia composed into the supporting joint's body and the link recorded
as a frame; with ``free_flyer=True`` a floating joint roots the robot;
every link gets a frame at its origin. Joints are numbered depth first
from the root. Mimic and planar joints are out of scope.
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from portbench.reference.port.multibody.model import (
    FrameSpec,
    JointSpec,
    MultibodyModel,
    build_humanoid,
)

_MOVABLE = {"revolute", "continuous", "prismatic", "floating"}


def _rpy_matrix(rpy: np.ndarray) -> np.ndarray:
    """URDF fixed-axis roll-pitch-yaw: R = Rz(y) @ Ry(p) @ Rx(r)."""
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _origin(elem: Optional[ET.Element]) -> tuple[np.ndarray, np.ndarray]:
    """(R, p) of an <origin xyz rpy> element (identity if absent)."""
    if elem is None:
        return np.eye(3), np.zeros(3)
    xyz = np.fromstring(elem.get("xyz", "0 0 0"), sep=" ")
    rpy = np.fromstring(elem.get("rpy", "0 0 0"), sep=" ")
    return _rpy_matrix(rpy), xyz


@dataclasses.dataclass
class _LinkInertia:
    """(m, com, I_c) in the link frame; I_c about the CoM."""

    mass: float
    com: np.ndarray
    I_c: np.ndarray

    @staticmethod
    def parse(link: ET.Element) -> "_LinkInertia":
        inl = link.find("inertial")
        if inl is None:
            return _LinkInertia(0.0, np.zeros(3), np.zeros((3, 3)))
        R, p = _origin(inl.find("origin"))
        mass = float(inl.find("mass").get("value"))
        ie = inl.find("inertia")
        g = lambda k: float(ie.get(k, "0"))
        I = np.array(
            [
                [g("ixx"), g("ixy"), g("ixz")],
                [g("ixy"), g("iyy"), g("iyz")],
                [g("ixz"), g("iyz"), g("izz")],
            ]
        )
        # URDF inertia is about the inertial-origin (the CoM), in
        # inertial-origin axes → rotate into link axes.
        return _LinkInertia(mass, p, R @ I @ R.T)

    def displaced(self, R: np.ndarray, p: np.ndarray) -> "_LinkInertia":
        """Express this inertia in a frame F where (R, p) places the link
        frame in F (x_F = R x_link + p)."""
        return _LinkInertia(self.mass, R @ self.com + p, R @ self.I_c @ R.T)

    def compose(self, other: "_LinkInertia") -> "_LinkInertia":
        """Sum of two inertias expressed in the same frame (Steiner)."""
        m = self.mass + other.mass
        if m == 0.0:
            return _LinkInertia(0.0, np.zeros(3), self.I_c + other.I_c)
        c = (self.mass * self.com + other.mass * other.com) / m

        def steiner(I_c, mi, ci):
            d = ci - c
            return I_c + mi * ((d @ d) * np.eye(3) - np.outer(d, d))

        return _LinkInertia(
            m, c, steiner(self.I_c, self.mass, self.com)
            + steiner(other.I_c, other.mass, other.com)
        )


@dataclasses.dataclass
class _UJoint:
    name: str
    jtype: str
    parent_link: str
    child_link: str
    R: np.ndarray
    p: np.ndarray
    axis: np.ndarray


def _parse(urdf: str) -> tuple[str, dict, list[_UJoint], str]:
    if "<" not in urdf:  # a path, not a document
        with open(urdf) as fh:
            urdf = fh.read()
    root = ET.fromstring(urdf)
    if root.tag != "robot":
        raise ValueError(f"expected <robot> root, got <{root.tag}>")
    links = {l.get("name"): _LinkInertia.parse(l) for l in root.findall("link")}
    joints = []
    children = set()
    for j in root.findall("joint"):
        jtype = j.get("type")
        if jtype not in _MOVABLE and jtype != "fixed":
            raise ValueError(f"unsupported joint type {jtype!r} ({j.get('name')})")
        R, p = _origin(j.find("origin"))
        ax = j.find("axis")
        axis = (
            np.fromstring(ax.get("xyz"), sep=" ")
            if ax is not None
            else np.array([1.0, 0.0, 0.0])
        )
        n = np.linalg.norm(axis)
        if n > 0:
            axis = axis / n
        parent = j.find("parent").get("link")
        child = j.find("child").get("link")
        joints.append(_UJoint(j.get("name"), jtype, parent, child, R, p, axis))
        children.add(child)
    roots = [name for name in links if name not in children]
    if len(roots) != 1:
        raise ValueError(f"expected exactly one root link, found {roots}")
    return root.get("name", "robot"), links, joints, roots[0]


def load_urdf(urdf: str, free_flyer: bool = False, dtype=torch.float64, device=None,
              gravity=(0.0, 0.0, -9.81)) -> MultibodyModel:
    """A :class:`MultibodyModel` from a URDF document or file path.
    ``free_flyer=True`` roots the robot on a floating joint. Frames are
    created for every link, named by the link name. ``device`` defaults to
    the card (raises without one)."""
    _, links, ujoints, root_link = _parse(urdf)
    by_parent: dict = {}
    for j in ujoints:
        by_parent.setdefault(j.parent_link, []).append(j)

    joints, parents, jR, jp, bodies, frames, f_R, f_p = [], [], [], [], [], [], [], []

    def walk(link: str, joint_idx: int, R: np.ndarray, p: np.ndarray):
        """Attach ``link`` (placed at (R, p) in joint ``joint_idx``'s
        frame) and recurse into its child joints."""
        if joint_idx >= 0:
            bodies[joint_idx] = bodies[joint_idx].compose(links[link].displaced(R, p))
            frames.append(FrameSpec(link, joint_idx))
            f_R.append(R)
            f_p.append(p)
        for uj in by_parent.get(link, ()):
            Rj, pj = R @ uj.R, R @ uj.p + p
            if uj.jtype == "fixed":
                walk(uj.child_link, joint_idx, Rj, pj)
                continue
            if uj.jtype == "floating":
                spec = JointSpec("freeflyer")
            elif uj.jtype == "prismatic":
                spec = JointSpec("prismatic", tuple(uj.axis))
            else:  # revolute | continuous
                spec = JointSpec("revolute", tuple(uj.axis))
            joints.append(spec)
            parents.append(joint_idx)
            jR.append(Rj)
            jp.append(pj)
            bodies.append(_LinkInertia(0.0, np.zeros(3), np.zeros((3, 3))))
            walk(uj.child_link, len(joints) - 1, np.eye(3), np.zeros(3))

    if free_flyer:
        joints.append(JointSpec("freeflyer"))
        parents.append(-1)
        jR.append(np.eye(3))
        jp.append(np.zeros(3))
        bodies.append(_LinkInertia(0.0, np.zeros(3), np.zeros((3, 3))))
        walk(root_link, 0, np.eye(3), np.zeros(3))
    else:
        # the root link is welded to the world, which carries its inertia
        walk(root_link, -1, np.eye(3), np.zeros(3))
    if not joints:
        raise ValueError("URDF contains no movable joints")
    return MultibodyModel.create(
        np.stack(jR), np.stack(jp), np.array([b.mass for b in bodies]),
        np.stack([b.com for b in bodies]), np.stack([b.I_c for b in bodies]),
        np.stack(f_R), np.stack(f_p), np.asarray(gravity, float), joints, parents, frames,
        dtype=dtype, device=device)


def _rpy_of(R: np.ndarray) -> np.ndarray:
    """ZYX Euler angles of a rotation: the inverse of :func:`_rpy_matrix`."""
    sy = -R[2, 0]
    cy = np.sqrt(max(R[0, 0] ** 2 + R[1, 0] ** 2, 1e-300))
    return np.array([np.arctan2(R[2, 1], R[2, 2]), np.arctan2(sy, cy),
                     np.arctan2(R[1, 0], R[0, 0])])


def model_to_urdf(model: MultibodyModel, name: str = "robot") -> str:
    """A :class:`MultibodyModel` as a URDF document, the loader's inverse:
    ``load_urdf(model_to_urdf(m))`` reproduces m's kinematics and
    inertias. Each joint becomes a revolute, prismatic or floating URDF
    joint whose child link carries its body's inertia (joint frame = link
    frame, CoM offset and inertia about the CoM in the joint's axes, as
    URDF's inertial element has them); each model frame becomes a fixed
    massless child link, so frame names survive the round trip. The
    document is the JAX package's ``model_to_urdf`` text for the same
    model."""
    host = lambda a: a.detach().cpu().double().numpy()
    mass, com, inert = host(model.mass), host(model.com), host(model.inertia)
    jR, jp, fR, fp = (host(model.jplace_R), host(model.jplace_p), host(model.frame_R),
                      host(model.frame_p))
    fmt = lambda v: " ".join(repr(float(x)) for x in np.atleast_1d(v))
    link_name = lambda i: f"link_{i}"
    out = [f'<robot name="{name}">', '  <link name="world_root"/>']
    for i, spec in enumerate(model.joints):
        jtype = {"freeflyer": "floating", "revolute": "revolute",
                 "prismatic": "prismatic"}[spec.jtype]
        parent = "world_root" if model.parents[i] < 0 else link_name(model.parents[i])
        I = inert[i]
        out += [
            f'  <link name="{link_name(i)}">',
            "    <inertial>",
            f'      <origin xyz="{fmt(com[i])}" rpy="0 0 0"/>',
            f'      <mass value="{repr(float(mass[i]))}"/>',
            f'      <inertia ixx="{repr(float(I[0, 0]))}" ixy="{repr(float(I[0, 1]))}" '
            f'ixz="{repr(float(I[0, 2]))}" iyy="{repr(float(I[1, 1]))}" '
            f'iyz="{repr(float(I[1, 2]))}" izz="{repr(float(I[2, 2]))}"/>',
            "    </inertial>",
            "  </link>",
            f'  <joint name="joint_{i}" type="{jtype}">',
            f'    <origin xyz="{fmt(jp[i])}" rpy="{fmt(_rpy_of(jR[i]))}"/>',
            f'    <parent link="{parent}"/>',
            f'    <child link="{link_name(i)}"/>',
        ]
        if spec.jtype == "revolute":
            out += [f'    <axis xyz="{fmt(np.asarray(spec.axis, float))}"/>',
                    '    <limit lower="-3.14159" upper="3.14159" effort="1000" '
                    'velocity="100"/>']
        elif spec.jtype == "prismatic":
            out += [f'    <axis xyz="{fmt(np.asarray(spec.axis, float))}"/>',
                    '    <limit lower="-10" upper="10" effort="1000" velocity="100"/>']
        out.append("  </joint>")
    for k, fr in enumerate(model.frames):
        out += [f'  <link name="{fr.name}"/>',
                f'  <joint name="frame_{fr.name}" type="fixed">',
                f'    <origin xyz="{fmt(fp[k])}" rpy="{fmt(_rpy_of(fR[k]))}"/>',
                f'    <parent link="{link_name(fr.parent_joint)}"/>',
                f'    <child link="{fr.name}"/>',
                "  </joint>"]
    out.append("</robot>")
    return "\n".join(out)


# the benchmark's frozen copy of the robot asset, beside this package
ASSETS = Path(__file__).resolve().parents[2] / "assets"
TALOS_LIKE_URDF = ASSETS / "talos_like.urdf"
UR5_URDF = ASSETS / "ur5.urdf"


def load_talos_like(dtype=torch.float64, device=None) -> MultibodyModel:
    """The talos-walk robot model, in the JAX package's order of choice:
    the URDF named by ``ALIGATOR_TPU_TALOS_URDF`` (a reduced Talos, with a
    free flyer added); else the repository's ``examples/assets/
    talos_like.urdf`` (the talos-dimension humanoid, its floating joint in
    the file); else :func:`build_humanoid`."""
    return load_urdf(str(TALOS_LIKE_URDF), dtype=dtype, device=device)


def load_ur5(dtype=torch.float64, device=None) -> MultibodyModel:
    """The UR5 of the repository's ``examples/assets/ur5.urdf``: nq = nv = 6,
    the tool frame ``ee_link``."""
    return load_urdf(str(UR5_URDF), dtype=dtype, device=device)
