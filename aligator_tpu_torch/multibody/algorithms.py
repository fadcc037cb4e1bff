"""Rigid-body algorithms (port of ``aligator_tpu.multibody.algorithms``):
forward kinematics, frame placements, velocities and Jacobians, RNEA and
its nonlinear-effect and gravity forms, CRBA, ABA, forward dynamics, the
centre of mass and the centroidal momentum.

The tree sweeps are Python loops over the static topology, one joint at
a time, as in the JAX package, each step one 6×6 product; what does not
depend on the order of the sweep (joint transforms and their 6×6 motion
transforms, motion subspaces, bias and inertia terms, composite
inertias) is computed for all joints at once. Eager torch pays per
operation, so the sweeps are written to issue few.

Forward dynamics differentiates by the implicit-function rule of the JAX
package's ``_fd_implicit`` custom JVP: with F(q, v, τ; a) = RNEA(q, v, a)
− τ, the tangent is δa = −M⁻¹ δF at fixed a. Here the rule is an
implicit step, a = a₀ − M⁻¹ (RNEA(q, v, a₀) − τ), where a₀ and the factor
of M are computed from detached inputs: forward-mode AD (``jacfwd``,
``jvp``) then sees exactly −M⁻¹ δF, and the value is a₀ after one more
refinement step, equal to the JAX value to rounding. The design needs no
``torch.autograd.Function``: with ``generate_vmap_rule`` such a function's
JVP comes out wrong under ``vmap(jacfwd(·))`` when the tangent is batched
at a level where the primal is not (torch 2.13), which is how the problem
layer differentiates the dynamics.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from aligator_tpu_torch.dynamics.base import values_only_active
from aligator_tpu_torch.linalg.spd import spd_factor, spd_solve, spd_solve_factored
from aligator_tpu_torch.manifolds.lie import cross, skew
from aligator_tpu_torch.multibody.model import (
    MultibodyModel,
    joint_motions,
    joint_transforms,
    subtree_ends,
)
from aligator_tpu_torch.multibody.spatial import (
    SE3T,
    Inertia,
    inertia_mul,
    inertia_transform,
    motion_cross,
    motion_cross_force,
    se3_act_force,
    se3_act_inv_motion,
    se3_act_motion,
    se3_mul,
)
from aligator_tpu_torch.utils.profiling import named_scope
from aligator_tpu_torch.utils.tree import detached


class Kinematics(NamedTuple):
    """Every joint's local placement M_i = (R_i, p_i) in its parent's frame
    and its 6×6 motion transform Xi_i = Ad(M_i⁻¹) (parent → joint
    coordinates; ``f @ Xi_i`` takes a force the other way)."""

    R: torch.Tensor  # (nj, 3, 3)
    p: torch.Tensor  # (nj, 3)
    Xi: torch.Tensor  # (nj, 6, 6)


def kinematics(model: MultibodyModel, q) -> Kinematics:
    R, p = joint_transforms(model, q)
    Rt = R.mT
    Xi = torch.cat([torch.cat([Rt, -Rt @ skew(p)], dim=-1),
                    torch.cat([torch.zeros_like(Rt), Rt], dim=-1)], dim=-2)
    return Kinematics(R, p, Xi)


def _placements(model: MultibodyModel, q) -> List[SE3T]:
    R, p = joint_transforms(model, q)
    return [SE3T(R[i], p[i]) for i in range(model.njoints)]


def _subspaces(model: MultibodyModel, like) -> List[torch.Tensor]:
    """Every joint's motion subspace S_i (6, nv_i), from one operation
    set per run."""
    out = []
    for r in model.runs:
        if r.jtype == "freeflyer":
            out.append(torch.eye(6, dtype=like.dtype, device=like.device))
            continue
        a = model.axis[r.j0:r.j1]
        z = torch.zeros_like(a)
        S = torch.cat([z, a] if r.jtype == "revolute" else [a, z], dim=-1)[..., None]
        out.extend(S.unbind(0))
    return out


def _tau_of(model: MultibodyModel, forces: List[torch.Tensor]) -> torch.Tensor:
    """Joint torques S_iᵀ f_i of every joint, stacked (nv,), one operation
    set per run."""
    F = torch.stack(forces, dim=-2)
    parts = []
    for r in model.runs:
        Fr = F[..., r.j0:r.j1, :]
        if r.jtype == "freeflyer":
            parts.append(Fr[..., 0, :])
        else:
            half = Fr[..., 3:] if r.jtype == "revolute" else Fr[..., :3]
            parts.append((half * model.axis[r.j0:r.j1]).sum(-1))
    return torch.cat(parts, dim=-1)


@functools.lru_cache(maxsize=None)
def _children(parents: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(i for i, p in enumerate(parents) if p == j)
                 for j in range(len(parents)))


def _chain(model: MultibodyModel, j: int) -> List[int]:
    """Joint j and its ancestors, root first."""
    out = []
    while j >= 0:
        out.append(j)
        j = model.parents[j]
    return out[::-1]


def forward_kinematics(model: MultibodyModel, q, K: Optional[Kinematics] = None
                       ) -> List[SE3T]:
    """World placements oMi of every joint frame."""
    R, p = joint_transforms(model, q) if K is None else (K.R, K.p)
    oM: List[SE3T] = [None] * model.njoints
    for i in range(model.njoints):
        Mi = SE3T(R[i], p[i])
        oM[i] = Mi if model.parents[i] < 0 else se3_mul(oM[model.parents[i]], Mi)
    return oM


def joint_placement(model: MultibodyModel, q, j: int, K: Optional[Kinematics] = None):
    """World placement of joint j, composed along its chain only."""
    R, p = joint_transforms(model, q) if K is None else (K.R, K.p)
    oM = None
    for i in _chain(model, j):
        Mi = SE3T(R[i], p[i])
        oM = Mi if oM is None else se3_mul(oM, Mi)
    return oM


def frame_placement(model: MultibodyModel, q, fid: int,
                    K: Optional[Kinematics] = None) -> SE3T:
    f = model.frames[fid]
    return se3_mul(joint_placement(model, q, f.parent_joint, K),
                   SE3T(model.frame_R[fid], model.frame_p[fid]))


def joint_velocities(model: MultibodyModel, K: Kinematics, v) -> List[torch.Tensor]:
    """LOCAL spatial velocity of every joint. ``v`` may carry leading axes
    (the map is linear in v, so a stack of basis vectors gives Jacobian
    columns)."""
    vJ = joint_motions(model, v).unbind(-2)
    XiT = K.Xi.mT.unbind(0)
    vels: List[torch.Tensor] = [None] * model.njoints
    for i in range(model.njoints):
        p = model.parents[i]
        vels[i] = vJ[i] if p < 0 else vels[p] @ XiT[i] + vJ[i]
    return vels


@named_scope("multibody.rnea")
def rnea(model: MultibodyModel, q, v, a, f_ext: Optional[list] = None,
         K: Optional[Kinematics] = None) -> torch.Tensor:
    """Inverse dynamics τ = ID(q, v, a) including gravity; ``f_ext`` is an
    optional per-joint list of external spatial forces in the joints'
    LOCAL frames (None where a joint has none). The sweeps carry one
    6×6 product per joint; the bias and inertia terms are computed for
    all joints at once."""
    nj = model.njoints
    K = kinematics(model, q) if K is None else K
    vJ, aJ = joint_motions(model, v), joint_motions(model, a)
    V = torch.stack(joint_velocities(model, K, v))
    bias = aJ + motion_cross(V, vJ)  # the cross term is exactly 0 at a root
    # gravity as the base "acceleration" −g (Featherstone's trick)
    a_base = torch.cat([-model.gravity, torch.zeros_like(model.gravity)])
    XiT, Xis, bias = K.Xi.mT.unbind(0), K.Xi.unbind(0), bias.unbind(0)
    accs: List[torch.Tensor] = [None] * nj
    for i in range(nj):
        p = model.parents[i]
        accs[i] = (a_base if p < 0 else accs[p]) @ XiT[i] + bias[i]
    I_all = Inertia(model.mass, model.com, model.inertia).matrix()
    F = inertia_mul(I_all, torch.stack(accs)) + motion_cross_force(V, inertia_mul(I_all, V))
    if f_ext is not None:
        zero = torch.zeros_like(F[0])
        F = F - torch.stack([zero if f is None else f for f in f_ext])
    forces = list(F.unbind(0))
    for i in range(nj - 1, -1, -1):
        p = model.parents[i]
        if p >= 0:
            forces[p] = forces[p] + forces[i] @ Xis[i]
    return _tau_of(model, forces)


@named_scope("multibody.crba")
def crba(model: MultibodyModel, q, K: Optional[Kinematics] = None) -> torch.Tensor:
    """Composite rigid-body algorithm: M(q) from composite inertias. No
    gravity term enters. Each subtree's composite is formed in the
    (m, c, I_c) form by parallel-axis terms about its own CoM (float32
    roundoff ~1e-6 relative), for all subtrees at once from the world
    placements; then one sweep carries each joint's subtree of composite
    forces up the tree as one block of columns, so M's block column of
    joint j is that block against S_j."""
    nj, nv = model.njoints, model.nv
    K = kinematics(model, q) if K is None else K
    oM = forward_kinematics(model, q, K)
    oR = torch.stack([M.R for M in oM])
    op = torch.stack([M.p for M in oM])
    m, Sm = model.mass, model.subtree
    cw = op + (oR @ model.com[..., None])[..., 0]
    msub = Sm @ m
    csub = (Sm @ (m[:, None] * cw)) / msub[:, None]
    d = cw[None] - csub[:, None]  # (nj, nj, 3): body k's CoM from subtree j's
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    steiner = ((oR @ model.inertia @ oR.mT)[None]
               + m[None, :, None, None] * ((d * d).sum(-1)[..., None, None] * eye
                                           - d[..., :, None] * d[..., None, :]))
    Isub = (Sm[..., None, None] * steiner).sum(1)
    Imat = Inertia(msub, (oR.mT @ (csub - op)[..., None])[..., 0],
                   oR.mT @ Isub @ oR).matrix()
    Ss = _subspaces(model, q)
    offs, ends, kids = model.v_offsets, subtree_ends(model.parents), _children(model.parents)
    Fsub: List[torch.Tensor] = [None] * nj
    cols: List[torch.Tensor] = [None] * nj
    for j in range(nj - 1, -1, -1):
        # composite forces per unit acceleration of every joint in j's subtree
        Fsub[j] = torch.cat([Imat[j] @ Ss[j]] + [K.Xi[c].mT @ Fsub[c] for c in kids[j]],
                            dim=-1)
        end = offs[ends[j]] if ends[j] < nj else nv
        cols[j] = torch.nn.functional.pad(Fsub[j].mT @ Ss[j], (0, 0, offs[j], nv - end))
    L = torch.cat(cols, dim=-1)  # block lower triangle and the diagonal blocks
    return torch.tril(L) + torch.tril(L, -1).mT


def mass_matrix_and_bias(model: MultibodyModel, q, v, K: Optional[Kinematics] = None):
    """(M(q) by CRBA, b(q, v) by one RNEA sweep)."""
    K = kinematics(model, q) if K is None else K
    return crba(model, q, K), rnea(model, q, v, torch.zeros_like(v), K=K)


@named_scope("multibody.aba")
def aba(model: MultibodyModel, q, v, tau) -> torch.Tensor:
    """Articulated-body algorithm (Featherstone): O(nv) forward dynamics,
    three sweeps over the static topology. Kept as an oracle for
    :func:`fwd_dynamics`."""
    nj = model.njoints
    Ms = _placements(model, q)
    Ss = _subspaces(model, q)
    I_all = Inertia(model.mass, model.com, model.inertia).matrix()
    vJ = joint_motions(model, v)
    a_base = torch.cat([-model.gravity, torch.zeros_like(model.gravity)])
    vels, cbias, IA, pA = [None] * nj, [None] * nj, [None] * nj, [None] * nj
    for i in range(nj):
        p = model.parents[i]
        if p < 0:
            v_i, c_i = vJ[i], torch.zeros_like(vJ[i])
        else:
            v_i = se3_act_inv_motion(Ms[i], vels[p]) + vJ[i]
            c_i = motion_cross(v_i, vJ[i])
        vels[i], cbias[i], IA[i] = v_i, c_i, I_all[i]
        pA[i] = motion_cross_force(v_i, inertia_mul(I_all[i], v_i))
    U, Dinv, u_ = [None] * nj, [None] * nj, [None] * nj
    offs = model.v_offsets
    for i in range(nj - 1, -1, -1):
        S = Ss[i]
        U[i] = IA[i] @ S
        Dinv[i] = torch.linalg.inv(S.mT @ U[i])
        u_[i] = tau[offs[i]:offs[i] + model.joints[i].nv] - S.mT @ pA[i]
        p = model.parents[i]
        if p >= 0:
            Ia = IA[i] - U[i] @ Dinv[i] @ U[i].mT
            pa = pA[i] + inertia_mul(Ia, cbias[i]) + U[i] @ (Dinv[i] @ u_[i])
            IA[p] = IA[p] + inertia_transform(Ia, Ms[i])
            pA[p] = pA[p] + se3_act_force(Ms[i], pa)
    accs, qdd = [None] * nj, [None] * nj
    for i in range(nj):
        p = model.parents[i]
        a_in = se3_act_inv_motion(Ms[i], a_base if p < 0 else accs[p]) + cbias[i]
        qdd[i] = Dinv[i] @ (u_[i] - U[i].mT @ a_in)
        accs[i] = a_in + Ss[i] @ qdd[i]
    return torch.cat(qdd)


def _fd_implicit(model: MultibodyModel, q, v, tau) -> torch.Tensor:
    """a = M⁻¹(τ − b) with the implicit-function tangent δa = −M⁻¹ δF,
    F = RNEA(q, v, a) − τ (see the module docstring)."""
    md, qd, vd = detached((model, q, v))
    M, b = mass_matrix_and_bias(md, qd, vd)
    fac = spd_factor(M)
    a0 = spd_solve_factored(fac, tau.detach() - b, refine_steps=1)
    if values_only_active():
        return a0
    return a0 - spd_solve_factored(fac, rnea(model, q, v, a0) - tau, refine_steps=1)


def fwd_dynamics(model: MultibodyModel, q, v, tau, f_ext: Optional[list] = None):
    """Forward dynamics a = M(q)⁻¹ (τ − b(q, v)) by an equilibrated
    Cholesky solve. Its derivatives follow the implicit-function rule (one
    RNEA tangent per direction) rather than differentiating the
    mass-matrix assembly. With ``f_ext`` (per-joint external forces in the
    joints' LOCAL frames, as :func:`rnea` takes them) the solve is plain,
    its derivatives AD through CRBA and the solve, as in the JAX package."""
    if f_ext is None:
        return _fd_implicit(model, q, v, tau)
    b = rnea(model, q, v, torch.zeros_like(v), f_ext=f_ext)
    return spd_solve(mass_matrix(model, q), tau - b, refine_steps=1)


def nonlinear_effects(model: MultibodyModel, q, v):
    """Coriolis and gravity torque b(q, v) = RNEA(q, v, 0)."""
    return rnea(model, q, v, torch.zeros_like(v))


def gravity_torque(model: MultibodyModel, q):
    z = q.new_zeros(model.nv)
    return rnea(model, q, z, z)


def mass_matrix(model: MultibodyModel, q) -> torch.Tensor:
    """M(q) by CRBA."""
    return crba(model, q)


def mass_matrix_rnea(model: MultibodyModel, q) -> torch.Tensor:
    """M(q) from unit-acceleration RNEA columns RNEA(q, 0, eⱼ) − RNEA(q, 0,
    0), mapped over the columns: an oracle for :func:`crba` (a difference
    of gravity-sized terms, so not for float32 compute)."""
    nv = model.nv
    accs = torch.cat([q.new_zeros(1, nv), torch.eye(nv, dtype=q.dtype, device=q.device)])
    out = vmap(lambda vv, aa: rnea(model, q, vv, aa))(q.new_zeros(nv + 1, nv), accs)
    M = (out[1:] - out[0]).mT
    return 0.5 * (M + M.mT)


def _world_coms(model: MultibodyModel, oM: List[SE3T]) -> torch.Tensor:
    """Every body's CoM in the world frame, (nj, 3)."""
    oR = torch.stack([M.R for M in oM])
    op = torch.stack([M.p for M in oM])
    return op + (oR @ model.com[..., None])[..., 0]


def _com(model: MultibodyModel, oM: List[SE3T]) -> torch.Tensor:
    return (model.mass[:, None] * _world_coms(model, oM)).sum(0) / model.mass.sum()


def com_position(model: MultibodyModel, q) -> torch.Tensor:
    """The robot's centre of mass in the world frame."""
    return _com(model, forward_kinematics(model, q))


def centroidal_momentum(model: MultibodyModel, q, v):
    """(h, com): the centroidal momentum h = (h_lin, h_ang) about the CoM in
    world-aligned axes, and the CoM. The momentum matrix Ag is ∂h/∂v
    (``jacfwd``)."""
    K = kinematics(model, q)
    oM = forward_kinematics(model, q, K)
    V = torch.stack(joint_velocities(model, K, v))
    I_all = Inertia(model.mass, model.com, model.inertia).matrix()
    oMs = SE3T(torch.stack([M.R for M in oM]), torch.stack([M.p for M in oM]))
    h_o = se3_act_force(oMs, inertia_mul(I_all, V)).sum(0)
    com = _com(model, oM)
    h_lin = h_o[:3]
    return torch.cat([h_lin, h_o[3:] - cross(com, h_lin)]), com


def frame_velocity(model: MultibodyModel, q, v, fid: int, local: bool = True):
    """Spatial velocity of frame ``fid``, in its own frame (LOCAL) or in
    the world frame (WORLD)."""
    vels = joint_velocities(model, kinematics(model, q), v)
    f = model.frames[fid]
    v_f = se3_act_inv_motion(SE3T(model.frame_R[fid], model.frame_p[fid]),
                             vels[f.parent_joint])
    if local:
        return v_f
    return se3_act_motion(frame_placement(model, q, fid), v_f)


def frame_jacobian_local(model: MultibodyModel, q, fid: int) -> torch.Tensor:
    """LOCAL frame Jacobian (6, nv): J v is the frame's spatial velocity in
    its own frame, by forward-mode AD of the velocity map."""
    return jacfwd(lambda vv: frame_velocity(model, q, vv, fid, local=True))(
        q.new_zeros(model.nv))
