"""Constrained (contact) rigid-body dynamics (port of
``aligator_tpu.multibody.contact``): the proximal KKT system

    [ M   Jᵀ ] [ a ]   [ τ − b(q, v) ]
    [ J  −σI ] [−λ ] = [ −γ          ]

solved by a Schur complement on the SPD mass matrix,
(J M⁻¹ Jᵀ + σI) λ = −(γ + J M⁻¹ (τ − b)), where γ stacks each contact's
acceleration drift J̇v plus the Baumgarte terms Kd·v_f + Kp·err.

Contacts carry an ``active`` flag as a tensor leaf: phase switches are
data, so one problem covers a whole gait and the flags stack over the
horizon. An inactive contact's rows and drift are masked to zero, which
makes its multiplier exactly 0 through the σ-regularized Schur system.

``contact_forces`` (λ for the force residuals), ``contact_slice`` and
``underactuated_constrained_inverse_dynamics`` (the static balance of
torques and contact forces) complete the JAX module's API.

Derivatives follow the JAX package's implicit rule ``_cd_implicit``
(implicit differentiation of the KKT system, reusing the factors of M and
G = J M⁻¹ Jᵀ + σI), written as an implicit step from a detached primal
solve, as ``algorithms._fd_implicit`` is.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
from torch.func import jvp

from aligator_tpu_torch.dynamics.base import values_only_active
from aligator_tpu_torch.linalg.spd import spd_factor, spd_solve_factored
from aligator_tpu_torch.multibody.algorithms import (
    Kinematics,
    fwd_dynamics,
    frame_placement,
    joint_velocities,
    kinematics,
    mass_matrix_and_bias,
    rnea,
)
from aligator_tpu_torch.multibody.model import MultibodyModel, configuration_integrate
from aligator_tpu_torch.multibody.spatial import (
    SE3T,
    se3_act_force,
    se3_act_inv_motion,
    so3_log,
)
from aligator_tpu_torch.utils.tree import detached, static_field


@dataclasses.dataclass(frozen=True)
class ContactSpec:
    """Static part of a rigid contact: its frame and dimension."""

    name: str
    frame_id: int
    dim: int = 6  # 3 (point) or 6 (surface)


@dataclasses.dataclass(frozen=True)
class ContactSet:
    """A stack of rigid contacts. Anchors, ``active`` flags and Baumgarte
    gains are tensor leaves (stackable over the horizon); frame bindings
    are static. All contacts use the LOCAL frame convention."""

    anchor_R: torch.Tensor  # (nk, 3, 3) anchor placements in the world
    anchor_p: torch.Tensor  # (nk, 3)
    active: torch.Tensor  # (nk,) 0/1
    kp: torch.Tensor  # (nk,) Baumgarte position gain
    kd: torch.Tensor  # (nk,) Baumgarte velocity gain
    specs: Tuple[ContactSpec, ...] = static_field()

    @property
    def nc(self) -> int:
        return sum(s.dim for s in self.specs)

    def replace(self, **changes) -> "ContactSet":
        return dataclasses.replace(self, **changes)


def make_contact_set(model: MultibodyModel, contacts, kp: float = 100.0, kd: float = 50.0,
                     anchors_R=None, anchors_p=None, dtype=torch.float64,
                     device=None) -> ContactSet:
    """``contacts`` is a tuple of (frame_name, dim). Anchors default to
    identity placements (see :func:`anchor_at_configuration`)."""
    specs = tuple(ContactSpec(name=n, frame_id=model.frame_id(n), dim=d) for n, d in contacts)
    nk = len(specs)
    t = lambda a: torch.as_tensor(a).to(dtype=dtype, device=device)
    return ContactSet(
        anchor_R=(torch.eye(3, dtype=dtype, device=device).expand(nk, 3, 3).clone()
                  if anchors_R is None else t(anchors_R)),
        anchor_p=(torch.zeros((nk, 3), dtype=dtype, device=device)
                  if anchors_p is None else t(anchors_p)),
        active=torch.ones(nk, dtype=dtype, device=device),
        kp=torch.full((nk,), kp, dtype=dtype, device=device),
        kd=torch.full((nk,), kd, dtype=dtype, device=device),
        specs=specs,
    )


def anchor_at_configuration(model: MultibodyModel, contacts: ContactSet, q) -> ContactSet:
    """Every contact anchored at its frame's placement in configuration q."""
    Ms = [frame_placement(model, q, s.frame_id) for s in contacts.specs]
    return contacts.replace(anchor_R=torch.stack([M.R for M in Ms]),
                            anchor_p=torch.stack([M.p for M in Ms]))


def _rows(cs: ContactSet, per_contact: torch.Tensor) -> torch.Tensor:
    """Per-contact values (nk,) broadcast to the stacked rows (nc,)."""
    return torch.cat([per_contact[k].expand(s.dim) for k, s in enumerate(cs.specs)])


def _frame_vels(model: MultibodyModel, cs: ContactSet, K: Kinematics, v) -> torch.Tensor:
    """LOCAL spatial velocities of the contact frames (..., nk, 6) from one
    sweep; ``v`` may carry leading axes."""
    vels = joint_velocities(model, K, v)
    out = []
    for s in cs.specs:
        iMf = SE3T(model.frame_R[s.frame_id], model.frame_p[s.frame_id])
        out.append(se3_act_inv_motion(iMf, vels[model.frames[s.frame_id].parent_joint]))
    return torch.stack(out, dim=-2)


def _stack_rows(cs: ContactSet, per_frame: torch.Tensor) -> torch.Tensor:
    """(..., nk, 6) → (..., nc): each contact's first ``dim`` rows."""
    return torch.cat([per_frame[..., k, :s.dim] for k, s in enumerate(cs.specs)], dim=-1)


def _stacked_contact_err(model: MultibodyModel, cs: ContactSet, q, K: Kinematics
                         ) -> torch.Tensor:
    """(nc,) placement errors against the anchors, in the contact frames:
    6D (R_fᵀ (p_f − p_anchor), log3(R_anchorᵀ R_f)); 3D the first part."""
    parts = []
    for k, s in enumerate(cs.specs):
        M = frame_placement(model, q, s.frame_id, K)
        rel_p = (M.R.mT @ (M.p - cs.anchor_p[k])[..., None])[..., 0]
        parts.append(rel_p if s.dim == 3 else
                     torch.cat([rel_p, so3_log(cs.anchor_R[k].mT @ M.R)]))
    return torch.cat(parts)


def _drift(model, cs, q, v, a=None):
    """Derivative of the stacked contact-frame velocities along the flow
    q̇ = v, v̇ = a (a = 0: the acceleration drift J̇v)."""
    dt = q.dtype

    def vel(t):
        vt = v if a is None else v + t * a
        K = kinematics(model, configuration_integrate(model, q, t * v))
        return _stack_rows(cs, _frame_vels(model, cs, K, vt))

    return jvp(vel, (q.new_zeros(()),), (torch.ones((), dtype=dt, device=q.device),))[1]


def _contact_rows(model: MultibodyModel, cs: ContactSet, q, v, K: Kinematics):
    """(J (nc, nv), γ (nc,)), LOCAL frame, masked by the active flags; J
    and the velocities from one sweep over [v; I] (the velocity map is
    linear in v), γ = J̇v + Kd·v_c + Kp·err."""
    V = torch.cat([v[None], torch.eye(model.nv, dtype=v.dtype, device=v.device)])
    rows = _stack_rows(cs, _frame_vels(model, cs, K, V))  # (1 + nv, nc)
    vc, J = rows[0], rows[1:].mT
    act = _rows(cs, cs.active)
    gamma = (_drift(model, cs, q, v) + _rows(cs, cs.kd) * vc
             + _rows(cs, cs.kp) * _stacked_contact_err(model, cs, q, K))
    return act[:, None] * J, act * gamma


def _contact_wrenches(model: MultibodyModel, cs: ContactSet, lam) -> List:
    """The multipliers as external forces on the joints (LOCAL joint
    frames; None where a joint carries no contact): RNEA with these
    forces subtracts Jᵀλ, the transpose of the contact-velocity map."""
    f_ext: List = [None] * model.njoints
    off = 0
    for k, s in enumerate(cs.specs):
        lk = lam[off:off + s.dim]
        off += s.dim
        f = cs.active[k] * (lk if s.dim == 6 else torch.cat([lk, torch.zeros_like(lk)]))
        iMf = SE3T(model.frame_R[s.frame_id], model.frame_p[s.frame_id])
        j = model.frames[s.frame_id].parent_joint
        fj = se3_act_force(iMf, f)
        f_ext[j] = fj if f_ext[j] is None else f_ext[j] + fj
    return f_ext


def _kkt_residual(prox_sigma, a, lam, model, cs: ContactSet, q, v, tau):
    """KKT residual F(θ; a, λ) of the proximal contact dynamics at fixed
    (a, λ), without forming J:

        F_top = RNEA(q, v, a) − Jᵀλ − τ        (Jᵀλ as contact forces in RNEA)
        F_bot = a_frame(q, v, a) + Kd·v_c + Kp·err + σλ
                                              (frame acceleration: a tangent
                                               along the flow)"""
    K = kinematics(model, q)
    top = rnea(model, q, v, a, f_ext=_contact_wrenches(model, cs, lam), K=K) - tau
    act = _rows(cs, cs.active)
    vc = _stack_rows(cs, _frame_vels(model, cs, K, v))
    bot = (act * (_drift(model, cs, q, v, a) + _rows(cs, cs.kd) * vc
                  + _rows(cs, cs.kp) * _stacked_contact_err(model, cs, q, K))
           + prox_sigma * lam)
    return top, bot


def _cd_primal(prox_sigma, model, contacts, q, v, tau):
    """Primal proximal contact solve; also returns the factors the
    tangent reuses. M and the Delassus operator G are both solved by
    equilibrated Cholesky with one refinement step."""
    K = kinematics(model, q)
    M, b = mass_matrix_and_bias(model, q, v, K)
    mfac = spd_factor(M)
    free = spd_solve_factored(mfac, tau - b, refine_steps=1)  # M⁻¹(τ − b)
    J, gamma = _contact_rows(model, contacts, q, v, K)
    MinvJt = spd_solve_factored(mfac, J.mT, refine_steps=1)  # (nv, nc)
    G = J @ MinvJt + prox_sigma * torch.eye(contacts.nc, dtype=q.dtype, device=q.device)
    gfac = spd_factor(0.5 * (G + G.mT))
    lam = spd_solve_factored(gfac, -(gamma + J @ free), refine_steps=1)
    return free + MinvJt @ lam, lam, mfac, gfac, J


def _cd_implicit(prox_sigma, model, contacts, q, v, tau):
    """(a, λ) with the implicit tangent of the KKT system

        [ M  −Jᵀ ] [δa]     [δF_top]
        [ J   σI ] [δλ] = − [δF_bot]

    solved by a Schur complement on M with the primal factors: one
    Newton step from the detached primal solution (a₀, λ₀) on the
    residual F, whose value is ~0 and whose tangent is δF."""
    a0, lam0, mfac, gfac, J = _cd_primal(prox_sigma, *detached((model, contacts, q, v, tau)))
    if values_only_active():
        return a0, lam0
    Ft, Fb = _kkt_residual(prox_sigma, a0, lam0, model, contacts, q, v, tau)
    dlam = spd_solve_factored(gfac, J @ spd_solve_factored(mfac, Ft, refine_steps=1) - Fb,
                              refine_steps=1)
    da = spd_solve_factored(mfac, J.mT @ dlam - Ft, refine_steps=1)
    return a0 + da, lam0 + dlam


def constrained_dynamics(model: MultibodyModel, contacts: ContactSet, q, v, tau,
                         prox_sigma: float = 1e-8):
    """Proximal constrained forward dynamics → (a, λ); λ (nc,) stacks each
    contact's force in its LOCAL frame."""
    if contacts.nc == 0:
        return fwd_dynamics(model, q, v, tau), q.new_zeros((0,))
    return _cd_implicit(prox_sigma, model, contacts, q, v, tau)


def contact_forces(model: MultibodyModel, contacts: ContactSet, actuation, x, u,
                   prox_sigma: float = 1e-8) -> torch.Tensor:
    """λ(x, u) of the contact dynamics for the force residuals: the
    multiplier output of the implicit contact step at τ = B·u."""
    nq = model.nq
    tau = (actuation @ u[..., None])[..., 0]
    return constrained_dynamics(model, contacts, x[..., :nq], x[..., nq:], tau, prox_sigma)[1]


def underactuated_constrained_inverse_dynamics(model: MultibodyModel, contacts: ContactSet,
                                               actuation, q, v):
    """Static torques and contact forces balancing the nonlinear effects:
    the minimum-norm least-squares solution of [B, −Jᵀ]·[u; λ] = nle(q, v).
    Returns (u, λ).

    The system is wide (nv rows, nu + nc columns) and so underdetermined.
    The JAX package takes ``jnp.linalg.lstsq``'s minimum-norm answer (an
    SVD); ``torch.linalg.lstsq`` on CUDA has only the full-rank ``gels``
    routine. The same answer on both devices comes from the pseudo-inverse
    (an SVD, singular values below max(m, n)·eps·σ_max dropped, as lstsq's
    default cut-off)."""
    b = rnea(model, q, v, torch.zeros_like(v))
    J, _ = _contact_rows(model, contacts, q, v, kinematics(model, q))
    W = torch.cat([actuation, -J.mT], dim=1)
    sol = torch.linalg.pinv(W) @ b
    nu = actuation.shape[1]
    return sol[:nu], sol[nu:]


def contact_slice(contacts: ContactSet, name: str) -> slice:
    """Row slice of contact ``name`` inside the stacked λ vector."""
    off = 0
    for s in contacts.specs:
        if s.name == name:
            return slice(off, off + s.dim)
        off += s.dim
    raise KeyError(name)
