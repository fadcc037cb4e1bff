"""Serial proximal Riccati recursion (port of ``aligator_tpu.gar.riccati``).

The ``lax.scan`` over knots becomes a Python loop over t; every tensor
carries an explicit leading batch axis where the JAX package relies on
``jax.vmap``. This is the ``lq_solver="serial"`` path: it serves f64 and
the θ-parameterization (nth > 0), which the fused kernels do not.

Per-stage equations, given the next cost-to-go (V', v'):

    v⁺  = v' + V'·f
    Q̂ = Q + AᵀV'A    Ŝ = S + AᵀV'B    R̂ = R + BᵀV'B
    q̂ = q + Aᵀv⁺     r̂ = r + Bᵀv⁺
    [kff zff; K Z] = [[R̂, Dᵀ],[D, -µI]]⁻¹ [-r̂ -Ŝᵀ; -d -C]
    yff = f + B·kff     A_cl = A + B·K
    Vxx = Q̂ + Ŝ·K + Cᵀ·Z     vx = q̂ + Ŝ·kff + Cᵀ·zff
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from aligator_tpu_torch.gar.lqr_problem import LQRProblem
from aligator_tpu_torch.linalg.schur import kkt_factor, kkt_solve_refined
from aligator_tpu_torch.utils.device import scalar_like
from aligator_tpu_torch.utils.profiling import named_scope
from aligator_tpu_torch.utils.tree import tree_map


class Knot(NamedTuple):
    """Stage fields only (no G0/g0). Fields carry a leading batch axis and
    may be stacked over time (B, L, ...) or a single knot (B, ...)."""

    Q: torch.Tensor
    S: torch.Tensor
    R: torch.Tensor
    q: torch.Tensor
    r: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    f: torch.Tensor
    C: torch.Tensor
    D: torch.Tensor
    d: torch.Tensor
    Gx: torch.Tensor
    Gu: torch.Tensor
    Gth: torch.Tensor
    gamma: torch.Tensor
    Gv: torch.Tensor


def knots_of(problem: LQRProblem) -> Knot:
    return Knot(*(
        problem.Gv_or_zeros if f == "Gv" else getattr(problem, f)
        for f in Knot._fields
    ))


class CostToGo(NamedTuple):
    Vxx: torch.Tensor  # (..., nx, nx)
    vx: torch.Tensor  # (..., nx)
    Vxt: torch.Tensor  # (..., nx, nth)
    vt: torch.Tensor  # (..., nth)
    Vtt: torch.Tensor  # (..., nth, nth)


class Gains(NamedTuple):
    kff: torch.Tensor  # (..., nu)
    zff: torch.Tensor  # (..., nc)
    yff: torch.Tensor  # (..., nx)   closed-loop bias (zero at terminal)
    K: torch.Tensor  # (..., nu, nx)
    Z: torch.Tensor  # (..., nc, nx)
    Acl: torch.Tensor  # (..., nx, nx) closed-loop matrix (zero at terminal)
    Kth: torch.Tensor  # (..., nu, nth)
    Zth: torch.Tensor  # (..., nc, nth)
    Yth: torch.Tensor  # (..., nx, nth)


@dataclasses.dataclass
class RiccatiFactors:
    """Backward-pass output: stacked gains and cost-to-go (B, N+1, ...),
    the solved initial KKT and the θ-gradient/Hessian of the value."""

    gains: Gains
    vm: CostToGo
    x0: torch.Tensor  # (B, nx)
    lbd0: torch.Tensor  # (B, nc0)
    x0_th: torch.Tensor  # (B, nx, nth)
    lbd0_th: torch.Tensor  # (B, nc0, nth)
    th_grad: torch.Tensor  # (B, nth)
    th_hess: torch.Tensor  # (B, nth, nth)


def mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product M @ v."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.mT)


def batch_mu(mueq, B: int, like: torch.Tensor) -> torch.Tensor:
    """µ as a (B,) tensor (scalars are broadcast over the batch)."""
    mu = scalar_like(mueq, like)
    return mu.expand(B) if mu.dim() == 0 else mu


def _terminal_solve(knot: Knot, mueq, refine_steps: int):
    nx = knot.Q.shape[-1]
    fac = kkt_factor(knot.R, knot.D, mueq)
    b1 = -torch.cat([knot.r.unsqueeze(-1), knot.S.mT, knot.Gu], dim=-1)
    b2 = -torch.cat([knot.d.unsqueeze(-1), knot.C, knot.Gv], dim=-1)
    ksol, zsol = kkt_solve_refined(knot.R, knot.D, mueq, b1, b2,
                                   refine_steps=refine_steps, fac=fac)
    kff, K, Kth = ksol[..., 0], ksol[..., 1 : 1 + nx], ksol[..., 1 + nx :]
    zff, Z, Zth = zsol[..., 0], zsol[..., 1 : 1 + nx], zsol[..., 1 + nx :]

    Vxx = knot.Q + knot.S @ K + knot.C.mT @ Z
    vx = knot.q + mv(knot.S, kff) + mv(knot.C.mT, zff)
    Vxt = knot.Gx + K.mT @ knot.Gu + Z.mT @ knot.Gv
    Vtt = knot.Gth + knot.Gu.mT @ Kth + knot.Gv.mT @ Zth
    vt = knot.gamma + mv(knot.Gu.mT, kff) + mv(knot.Gv.mT, zff)

    vm = CostToGo(Vxx=_sym(Vxx), vx=vx, Vxt=Vxt, vt=vt, Vtt=_sym(Vtt))
    gains = Gains(
        kff=kff, zff=zff, yff=torch.zeros_like(knot.f),
        K=K, Z=Z, Acl=torch.zeros_like(knot.A),
        Kth=Kth, Zth=Zth, Yth=torch.zeros_like(knot.Gx),
    )
    return vm, gains


def _stage_solve(knot: Knot, vn: CostToGo, mueq, refine_steps: int):
    nx = knot.Q.shape[-1]
    vplus = vn.vx + mv(vn.Vxx, knot.f)
    AtV = knot.A.mT @ vn.Vxx
    BtV = knot.B.mT @ vn.Vxx

    Qhat = knot.Q + AtV @ knot.A
    Rhat = _sym(knot.R + BtV @ knot.B)
    Shat = knot.S + AtV @ knot.B
    qhat = knot.q + mv(knot.A.mT, vplus)
    rhat = knot.r + mv(knot.B.mT, vplus)
    Guhat = knot.Gu + knot.B.mT @ vn.Vxt

    fac = kkt_factor(Rhat, knot.D, mueq)
    b1 = -torch.cat([rhat.unsqueeze(-1), Shat.mT, Guhat], dim=-1)
    b2 = -torch.cat([knot.d.unsqueeze(-1), knot.C, knot.Gv], dim=-1)
    ksol, zsol = kkt_solve_refined(Rhat, knot.D, mueq, b1, b2,
                                   refine_steps=refine_steps, fac=fac)
    kff, K, Kth = ksol[..., 0], ksol[..., 1 : 1 + nx], ksol[..., 1 + nx :]
    zff, Z, Zth = zsol[..., 0], zsol[..., 1 : 1 + nx], zsol[..., 1 + nx :]

    yff = knot.f + mv(knot.B, kff)
    Acl = knot.A + knot.B @ K
    Yth = knot.B @ Kth

    Vxx = Qhat + Shat @ K + knot.C.mT @ Z
    vx = qhat + mv(Shat, kff) + mv(knot.C.mT, zff)

    vt = (knot.gamma + vn.vt + mv(knot.Gu.mT, kff) + mv(knot.Gv.mT, zff)
          + mv(vn.Vxt.mT, yff))
    Vxt = knot.Gx + K.mT @ knot.Gu + Z.mT @ knot.Gv + Acl.mT @ vn.Vxt
    Vtt = (knot.Gth + vn.Vtt + knot.Gu.mT @ Kth + knot.Gv.mT @ Zth
           + vn.Vxt.mT @ Yth)

    vm = CostToGo(Vxx=_sym(Vxx), vx=vx, Vxt=Vxt, vt=vt, Vtt=_sym(Vtt))
    gains = Gains(kff=kff, zff=zff, yff=yff, K=K, Z=Z, Acl=Acl,
                  Kth=Kth, Zth=Zth, Yth=Yth)
    return vm, gains


def _stack_time(items):
    return tree_map(lambda *xs: torch.stack(xs, dim=1), *items)


@named_scope("gar.riccati.backward_sweep")
def backward_sweep(knots: Knot, mueq, refine_steps: int = 1):
    """Riccati sweep over L stacked knots (B, L, ...): terminal solve on the
    last knot, then a reverse loop. Returns stacked (gains, cost-to-go)."""
    L = knots.Q.shape[1]
    mueq = batch_mu(mueq, knots.Q.shape[0], knots.Q)
    at = lambda t: tree_map(lambda a: a[:, t], knots)
    vm, g = _terminal_solve(at(L - 1), mueq, refine_steps)
    vms, gains = [vm], [g]
    for t in range(L - 2, -1, -1):
        vm, g = _stage_solve(at(t), vm, mueq, refine_steps)
        vms.append(vm)
        gains.append(g)
    return _stack_time(gains[::-1]), _stack_time(vms[::-1])


@named_scope("gar.riccati.forward_sweep")
def forward_sweep(gains: Gains, vms: CostToGo, x0, lbd0, theta):
    """Closed-loop forward rollout over the L knots of ``gains`` from
    (x0, λ0) (B, nx) and θ (B, nth). Returns (xs, us, vs, lbds), each
    (B, L, ·); lbds[:, 0] = λ0."""
    L = gains.K.shape[1]
    x = x0
    xs, us, vs, lbds = [], [], [], [lbd0]
    for t in range(L):
        u = gains.kff[:, t] + mv(gains.K[:, t], x) + mv(gains.Kth[:, t], theta)
        v = gains.zff[:, t] + mv(gains.Z[:, t], x) + mv(gains.Zth[:, t], theta)
        xs.append(x)
        us.append(u)
        vs.append(v)
        if t < L - 1:
            x = (gains.yff[:, t] + mv(gains.Acl[:, t], x)
                 + mv(gains.Yth[:, t], theta))
            lbds.append(vms.vx[:, t + 1] + mv(vms.Vxx[:, t + 1], x)
                        + mv(vms.Vxt[:, t + 1], theta))
    st = lambda seq: torch.stack(seq, dim=1)
    return st(xs), st(us), st(vs), st(lbds)


@named_scope("gar.initial_solve")
def initial_solve(problem: LQRProblem, vms: CostToGo, mudyn, refine_steps: int,
                  gains: Gains) -> RiccatiFactors:
    """The initial-stage KKT [[Vxx0, G0ᵀ],[G0, -mudyn·I]]·[x0; λ0] =
    [-vx0; -g0] and the θ-terms of the value (proximal-riccati.hxx:44-55)."""
    nth = problem.nth
    Vxx0, vx0, Vxt0 = vms.Vxx[:, 0], vms.vx[:, 0], vms.Vxt[:, 0]
    b1 = torch.cat([-vx0.unsqueeze(-1), -Vxt0], dim=-1)
    b2 = torch.cat(
        [-problem.g0.unsqueeze(-1), problem.g0.new_zeros(problem.g0.shape + (nth,))],
        dim=-1,
    )
    mudyn = scalar_like(mudyn, problem.Q)
    x_sol, l_sol = kkt_solve_refined(Vxx0, problem.G0, mudyn, b1, b2,
                                     refine_steps=refine_steps)
    x0, x0_th = x_sol[..., 0], x_sol[..., 1:]
    lbd0, lbd0_th = l_sol[..., 0], l_sol[..., 1:]
    return RiccatiFactors(
        gains=gains, vm=vms, x0=x0, lbd0=lbd0, x0_th=x0_th, lbd0_th=lbd0_th,
        th_grad=vms.vt[:, 0] + mv(Vxt0.mT, x0),
        th_hess=vms.Vtt[:, 0] + Vxt0.mT @ x0_th,
    )


def backward(problem: LQRProblem, mueq, mudyn=0.0, refine_steps: int = 1
             ) -> RiccatiFactors:
    """Backward Riccati sweep over the full horizon + initial-stage KKT."""
    gains, vms = backward_sweep(knots_of(problem), mueq, refine_steps)
    return initial_solve(problem, vms, mudyn, refine_steps, gains)


def initial_costate(problem: LQRProblem, factors: RiccatiFactors, th):
    """(x0, λ0 zero-padded to nx) of the forward sweep."""
    x0 = factors.x0 + mv(factors.x0_th, th)
    lbd0 = factors.lbd0 + mv(factors.lbd0_th, th)
    pad = problem.nx - problem.nc0
    return x0, torch.nn.functional.pad(lbd0, (0, pad))


def forward(problem: LQRProblem, factors: RiccatiFactors,
            theta: Optional[torch.Tensor] = None):
    """Closed-loop rollout → (xs, us, vs, lbdas), each (B, N+1, ·);
    ``lbdas[:, 0]`` holds λ0 zero-padded to nx (nc0 ≤ nx)."""
    th = theta if theta is not None else problem.Q.new_zeros(
        (problem.batch, problem.nth))
    x0, lbd0 = initial_costate(problem, factors, th)
    return forward_sweep(factors.gains, factors.vm, x0, lbd0, th)


def solve(problem: LQRProblem, mueq, mudyn=0.0,
          theta: Optional[torch.Tensor] = None, refine_steps: int = 1):
    """backward + forward. Returns (xs, us, vs, lbdas, factors)."""
    factors = backward(problem, mueq, mudyn, refine_steps)
    xs, us, vs, lbds = forward(problem, factors, theta)
    return xs, us, vs, lbds, factors
