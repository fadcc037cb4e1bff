"""Stagewise-dense Riccati solver (port of ``aligator_tpu.gar.stagedense``;
``lq_solver="stagedense"``), batched over a leading axis B.

Each stage solves its full symmetric indefinite KKT

    [[R,  Dᵀ,  Bᵀ,  0  ],   [u ]     [r ]
     [D, −µI,  0,   0  ], · [ν ]  = −[d ]
     [B,  0,   0,  −I  ],   [λ⁺]     [f ]
     [0,  0,  −I,  P⁺xx]]   [x⁺]     [p⁺x]

by a pivoted LU for the feedforwards (kff, zff, lff, yff), the state
feedbacks (K, Z, L, Y) and the θ-feedbacks, then updates the value model
Pxx = Q + S·K + Cᵀ·Z + Aᵀ·L, px = q + S·kff + Cᵀ·zff + Aᵀ·lff. No
µ-scaled Schur complement is formed, which makes it the robust choice for
ill-conditioned subproblems. The reverse scan over knots is a Python loop.
The LU is not checked (``solve_ex``): a singular stage gives non-finite
values and the host never waits for the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from aligator_tpu_torch.gar.lqr_problem import LQRProblem
from aligator_tpu_torch.gar.riccati import (
    CostToGo,
    Gains,
    Knot,
    _stack_time,
    _sym,
    batch_mu,
    knots_of,
    mv,
)
from aligator_tpu_torch.utils.profiling import named_scope
from aligator_tpu_torch.utils.tree import tree_map


class StageDenseFactor(NamedTuple):
    """Per-stage solved rows; (B, N+1, ...) when stacked. The terminal
    rows have lff = yff = L = Y = 0."""

    kff: torch.Tensor  # (..., nu)
    zff: torch.Tensor  # (..., nc)
    lff: torch.Tensor  # (..., nx)  next costate feedforward
    yff: torch.Tensor  # (..., nx)  next state feedforward
    K: torch.Tensor  # (..., nu, nx)
    Z: torch.Tensor  # (..., nc, nx)
    L: torch.Tensor  # (..., nx, nx)  next costate feedback
    Y: torch.Tensor  # (..., nx, nx)  next state feedback (closed-loop map)
    Kth: torch.Tensor  # (..., nu, nth)
    Zth: torch.Tensor  # (..., nc, nth)
    Lth: torch.Tensor  # (..., nx, nth)
    Yth: torch.Tensor  # (..., nx, nth)


@dataclasses.dataclass
class StageDenseFactors:
    """Backward-pass output (as ``riccati.RiccatiFactors``)."""

    factors: StageDenseFactor  # (B, N+1, ...)
    vm: CostToGo  # (B, N+1, ...)
    x0: torch.Tensor  # (B, nx)
    lbd0: torch.Tensor  # (B, nc0)
    x0_th: torch.Tensor  # (B, nx, nth)
    lbd0_th: torch.Tensor  # (B, nc0, nth)
    th_grad: torch.Tensor  # (B, nth)
    th_hess: torch.Tensor  # (B, nth, nth)

    @property
    def gains(self) -> Gains:
        """The serial solver's Gains view: (yff, Y) are (f + B·kff, A + B·K)."""
        f = self.factors
        return Gains(kff=f.kff, zff=f.zff, yff=f.yff, K=f.K, Z=f.Z, Acl=f.Y,
                     Kth=f.Kth, Zth=f.Zth, Yth=f.Yth)


def _lu_solve(kkt: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(kkt, rhs, check_errors=False)[0]


def _neg_mu_eye(mu: torch.Tensor, n: int, like: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    return -mu.reshape(mu.shape + (1, 1)) * eye


def _split(sol, nx):
    """Rows of a solved block → (feedforward, state feedback, θ-feedback)."""
    return sol[..., 0], sol[..., 1 : 1 + nx], sol[..., 1 + nx :]


def _terminal_solve(knot: Knot, mu: torch.Tensor):
    """The [[R, Dᵀ], [D, −µI]] system of the last knot."""
    nx, nu = knot.Q.shape[-1], knot.R.shape[-1]
    nc = knot.C.shape[-2]
    kkt = torch.cat([torch.cat([knot.R, knot.D.mT], dim=-1),
                     torch.cat([knot.D, _neg_mu_eye(mu, nc, knot.R)], dim=-1)], dim=-2)
    rhs = -torch.cat([torch.cat([knot.r.unsqueeze(-1), knot.S.mT, knot.Gu], dim=-1),
                      torch.cat([knot.d.unsqueeze(-1), knot.C, knot.Gv], dim=-1)], dim=-2)
    sol = _lu_solve(kkt, rhs)
    kff, K, Kth = _split(sol[..., :nu, :], nx)
    zff, Z, Zth = _split(sol[..., nu:, :], nx)

    Pxx = knot.Q + knot.S @ K + knot.C.mT @ Z
    px = knot.q + mv(knot.S, kff) + mv(knot.C.mT, zff)
    Pxt = knot.Gx + K.mT @ knot.Gu + Z.mT @ knot.Gv
    Ptt = knot.Gth + knot.Gu.mT @ Kth + knot.Gv.mT @ Zth
    pt = knot.gamma + mv(knot.Gu.mT, kff) + mv(knot.Gv.mT, zff)

    vm = CostToGo(Vxx=_sym(Pxx), vx=px, Vxt=Pxt, vt=pt, Vtt=_sym(Ptt))
    z_x, z_xx, z_xt = (torch.zeros_like(knot.f), torch.zeros_like(knot.A),
                       torch.zeros_like(knot.Gx))
    fac = StageDenseFactor(kff=kff, zff=zff, lff=z_x, yff=z_x, K=K, Z=Z, L=z_xx, Y=z_xx,
                           Kth=Kth, Zth=Zth, Lth=z_xt, Yth=z_xt)
    return vm, fac


def _stage_solve(knot: Knot, vn: CostToGo, mu: torch.Tensor):
    """The stage KKT in [u, ν, λ⁺, x⁺] given the next value model."""
    nx, nu = knot.Q.shape[-1], knot.R.shape[-1]
    nc, nth = knot.C.shape[-2], knot.Gth.shape[-1]
    z = lambda *s: knot.Q.new_zeros(knot.Q.shape[:-2] + s)
    m_eye = -torch.eye(nx, dtype=knot.Q.dtype, device=knot.Q.device).expand_as(knot.A)
    row = lambda *blocks: torch.cat(blocks, dim=-1)
    kkt = torch.cat([
        row(knot.R, knot.D.mT, knot.B.mT, z(nu, nx)),
        row(knot.D, _neg_mu_eye(mu, nc, knot.R), z(nc, nx), z(nc, nx)),
        row(knot.B, z(nx, nc), z(nx, nx), m_eye),
        row(z(nx, nu), z(nx, nc), m_eye, vn.Vxx),
    ], dim=-2)
    rhs = -torch.cat([
        row(knot.r.unsqueeze(-1), knot.S.mT, knot.Gu),
        row(knot.d.unsqueeze(-1), knot.C, knot.Gv),
        row(knot.f.unsqueeze(-1), knot.A, z(nx, nth)),
        row(vn.vx.unsqueeze(-1), z(nx, nx), vn.Vxt),
    ], dim=-2)
    sol = _lu_solve(kkt, rhs)
    iv, il, iy = nu, nu + nc, nu + nc + nx
    kff, K, Kth = _split(sol[..., :iv, :], nx)
    zff, Z, Zth = _split(sol[..., iv:il, :], nx)
    lff, L, Lth = _split(sol[..., il:iy, :], nx)
    yff, Y, Yth = _split(sol[..., iy:, :], nx)

    Pxx = knot.Q + knot.S @ K + knot.C.mT @ Z + knot.A.mT @ L
    px = knot.q + mv(knot.S, kff) + mv(knot.C.mT, zff) + mv(knot.A.mT, lff)
    Pxt = knot.Gx + K.mT @ knot.Gu + Z.mT @ knot.Gv + Y.mT @ vn.Vxt
    # the downstream θ-value (vn.vt, vn.Vtt) is accumulated, as in the
    # serial recursion
    Ptt = (knot.Gth + vn.Vtt + Kth.mT @ knot.Gu + knot.Gv.mT @ Zth
           + Yth.mT @ vn.Vxt)
    pt = (knot.gamma + vn.vt + mv(knot.Gu.mT, kff) + mv(knot.Gv.mT, zff)
          + mv(vn.Vxt.mT, yff))

    vm = CostToGo(Vxx=_sym(Pxx), vx=px, Vxt=Pxt, vt=pt, Vtt=_sym(Ptt))
    fac = StageDenseFactor(kff=kff, zff=zff, lff=lff, yff=yff, K=K, Z=Z, L=L, Y=Y,
                           Kth=Kth, Zth=Zth, Lth=Lth, Yth=Yth)
    return vm, fac


@named_scope("gar.stagedense.backward")
def backward(problem: LQRProblem, mueq, mudyn=0.0) -> StageDenseFactors:
    """Reverse loop of stage KKT solves, then the initial system
    [[Pxx₀, G0ᵀ], [G0, −mudyn·I]]."""
    knots = knots_of(problem)
    Bsz, L = knots.Q.shape[:2]
    mu = batch_mu(mueq, Bsz, knots.Q)
    at = lambda t: tree_map(lambda a: a[:, t], knots)
    vm, fac = _terminal_solve(at(L - 1), mu)
    vms, facs = [vm], [fac]
    for t in range(L - 2, -1, -1):
        vm, fac = _stage_solve(at(t), vm, mu)
        vms.append(vm)
        facs.append(fac)
    facs, vms = _stack_time(facs[::-1]), _stack_time(vms[::-1])

    nx, nc0, nth = problem.nx, problem.nc0, problem.nth
    Pxx0, px0, Pxt0 = vms.Vxx[:, 0], vms.vx[:, 0], vms.Vxt[:, 0]
    mudyn = batch_mu(mudyn, Bsz, knots.Q)
    kkt0 = torch.cat([torch.cat([Pxx0, problem.G0.mT], dim=-1),
                      torch.cat([problem.G0, _neg_mu_eye(mudyn, nc0, Pxx0)], dim=-1)],
                     dim=-2)
    rhs0 = -torch.cat([
        torch.cat([px0.unsqueeze(-1), Pxt0], dim=-1),
        torch.cat([problem.g0.unsqueeze(-1), problem.g0.new_zeros((Bsz, nc0, nth))],
                  dim=-1),
    ], dim=-2)
    sol0 = _lu_solve(kkt0, rhs0)
    x0, x0_th = sol0[:, :nx, 0], sol0[:, :nx, 1:]
    lbd0, lbd0_th = sol0[:, nx:, 0], sol0[:, nx:, 1:]
    return StageDenseFactors(
        factors=facs, vm=vms, x0=x0, lbd0=lbd0, x0_th=x0_th, lbd0_th=lbd0_th,
        th_grad=vms.vt[:, 0] + mv(Pxt0.mT, x0),
        th_hess=vms.Vtt[:, 0] + Pxt0.mT @ x0_th,
    )


def forward(problem: LQRProblem, factors: StageDenseFactors,
            theta: Optional[torch.Tensor] = None):
    """Forward loop: u, ν from (kff, K, Z, …) and λ⁺, x⁺ from the solved
    (lff, L) and (yff, Y) rows. → (xs, us, vs, lbdas), each (B, N+1, ·)."""
    nx, nc0 = problem.nx, problem.nc0
    th = theta if theta is not None else problem.Q.new_zeros(
        (problem.batch, problem.nth))
    x = factors.x0 + mv(factors.x0_th, th)
    lbd0 = factors.lbd0 + mv(factors.lbd0_th, th)
    f = factors.factors
    L = f.kff.shape[1]
    xs, us, vs = [], [], []
    lbds = [torch.nn.functional.pad(lbd0, (0, nx - nc0))]
    for t in range(L):
        ft = tree_map(lambda a: a[:, t], f)
        xs.append(x)
        us.append(ft.kff + mv(ft.K, x) + mv(ft.Kth, th))
        vs.append(ft.zff + mv(ft.Z, x) + mv(ft.Zth, th))
        if t < L - 1:
            lbds.append(ft.lff + mv(ft.L, x) + mv(ft.Lth, th))
            x = ft.yff + mv(ft.Y, x) + mv(ft.Yth, th)
    st = lambda seq: torch.stack(seq, dim=1)
    return st(xs), st(us), st(vs), st(lbds)


def solve(problem: LQRProblem, mueq, mudyn=0.0, theta: Optional[torch.Tensor] = None):
    """backward + forward → (xs, us, vs, lbdas, factors)."""
    factors = backward(problem, mueq, mudyn)
    xs, us, vs, lbds = forward(problem, factors, theta)
    return xs, us, vs, lbds, factors
