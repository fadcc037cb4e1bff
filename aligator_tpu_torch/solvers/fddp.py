"""FDDP — feasible differential dynamic programming, batched (port of
``aligator_tpu.solvers.fddp``).

The JAX solver is written for one problem and batched with
``jax.vmap(solve)``. As in the port's ProxDDP, this module runs that
batched control flow over an explicit leading axis: the iteration loop and
the line-search loop run while any element is active, finished elements
are frozen by ``tree_where``, and the regularization and step size are
per-element (B,) tensors. Each element then matches ``jax.vmap(solve)``:
iterates, ``conv``, ``num_iters`` and the gains.

The pieces: the Gauss-Newton Q-recursion over the knots (``_backward``;
Cholesky of Quu, a non-SPD Quu giving NaN as JAX's Cholesky does, so the
trial is rejected by its non-finite cost without a host sync), the
gap-keeping closed-loop rollout (``_forward``: one dynamics step per knot,
the costs of the rolled-out trajectory in one pass after it) and the
Goldstein-style acceptance with the dec/inc regularization schedule. Each
``.any()`` of a loop test is a host sync.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.func import vmap

from aligator_tpu_torch.dynamics.base import values_only
from aligator_tpu_torch.gar.riccati import mv
from aligator_tpu_torch.linalg.schur import cholesky
from aligator_tpu_torch.linalg.spd import _cho_solve
from aligator_tpu_torch.problem import (
    TrajOptProblem,
    _vmap_batch,
    compute_derivatives,
    stage_at,
    stage_costs,
    us_default_init,
    xs_default_init,
)
from aligator_tpu_torch.utils.device import full_f32_matmuls
from aligator_tpu_torch.utils.profiling import named_scope
from aligator_tpu_torch.utils.tree import tree_map, tree_where


@dataclasses.dataclass(frozen=True)
class FDDPSettings:
    """Solver parameters; names and defaults as in the JAX package."""

    tol: float = 1e-6
    max_iters: int = 200
    reg_init: float = 1e-9
    reg_min: float = 1e-9
    reg_max: float = 1e9
    reg_dec_factor: float = 0.1
    reg_inc_factor: float = 10.0
    th_grad: float = 1e-12
    th_step_dec: float = 0.5
    th_step_inc: float = 0.01
    th_accept_step: float = 0.1
    th_accept_neg_step: float = 2.0
    ls_beta: float = 0.5  # contraction_min
    alpha_min: float = 2.0**-9
    ls_max_steps: int = 12


@dataclasses.dataclass
class FDDPResults:
    """Solver output; every field carries the batch axis (dropped again for
    an unbatched call)."""

    xs: torch.Tensor
    us: torch.Tensor
    conv: torch.Tensor
    prim_infeas: torch.Tensor
    dual_infeas: torch.Tensor
    traj_cost: torch.Tensor
    num_iters: torch.Tensor
    kff: torch.Tensor  # (B, N, nu) feedforward gains
    K: torch.Tensor  # (B, N, nu, ndx) feedback gains


class _BwdOut(NamedTuple):
    kff: torch.Tensor
    K: torch.Tensor
    Qu: torch.Tensor
    Quuk: torch.Tensor
    Vx: torch.Tensor
    Vxx: torch.Tensor
    ftVxx: torch.Tensor


def _b(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


def _sum(a: torch.Tensor) -> torch.Tensor:
    return a.flatten(1).sum(1)


def _gaps(problem: TrajOptProblem, xs, xnexts):
    """fs[:, 0] = x0 ⊖ xs[:, 0], fs[:, t+1] = xnext_t ⊖ xs[:, t+1] →
    (B, N+1, ndx)."""
    diff = vmap(problem.space.difference)
    f0 = diff(xs[:, 0], problem.x0)
    ftail = vmap(diff)(xs[:, 1:], xnexts)
    return torch.cat([f0.unsqueeze(1), ftail], dim=1)


@named_scope("fddp.backward")
def _backward(problem: TrajOptProblem, derivs, fs, preg):
    """The Q-recursion over t = N-1..0 for a batch (preg (B,)). Returns
    (_BwdOut stacked over the N knots, Vx, Vxx, ftVxx over N+1)."""
    N, ndx, nu = problem.nsteps, problem.ndx, problem.nu
    eye_x = torch.eye(ndx, dtype=fs.dtype, device=fs.device)
    eye_u = torch.eye(nu, dtype=fs.dtype, device=fs.device)
    p = preg.reshape(-1, 1, 1)

    VxxN = derivs.Lxx[:, N] + p * eye_x
    ftVxxN = mv(VxxN, fs[:, N])
    VxN = derivs.Lx[:, N] + ftVxxN
    Vx, Vxx = VxN, VxxN
    outs = []
    for t in reversed(range(N)):
        A, Bm = derivs.A[:, t], derivs.B[:, t]
        Qx = derivs.Lx[:, t] + mv(A.mT, Vx)
        Qu = derivs.Lu[:, t] + mv(Bm.mT, Vx)
        AtV, BtV = A.mT @ Vxx, Bm.mT @ Vxx
        Qxx = derivs.Lxx[:, t] + AtV @ A
        Qxu = derivs.Lxu[:, t] + AtV @ Bm
        Quu = derivs.Luu[:, t] + BtV @ Bm + p * eye_u
        Quu = 0.5 * (Quu + Quu.mT)
        L = cholesky(Quu)  # NaN where Quu is not SPD, as in JAX
        kff = -_cho_solve(L, Qu.unsqueeze(-1)).squeeze(-1)
        K = -_cho_solve(L, Qxu.mT)
        Quuk = mv(Quu, kff)
        Vx = Qx + mv(K.mT, Qu)
        Vxx = Qxx + Qxu @ K
        Vxx = 0.5 * (Vxx + Vxx.mT) + p * eye_x
        ftVxx = mv(Vxx, fs[:, t])
        Vx = Vx + ftVxx
        outs.append(_BwdOut(kff, K, Qu, Quuk, Vx, Vxx, ftVxx))
    outs = tree_map(lambda *xs: torch.stack(xs[::-1], dim=1), *outs)
    cat = lambda a, last: torch.cat([a, last.unsqueeze(1)], dim=1)
    return outs, cat(outs.Vx, VxN), cat(outs.Vxx, VxxN), cat(outs.ftVxx, ftVxxN)


@named_scope("fddp.forward")
def _forward(problem: TrajOptProblem, xs, us, fs, kff, K, alpha):
    """The gap-keeping closed-loop rollout at step sizes alpha (B,):
    → (xs_try, us_try, dxs, cost)."""
    space, N = problem.space, problem.nsteps

    def roll(dyn, xs, us, fs, kff, K, a):
        dx = a * fs[0]
        x = space.integrate(xs[0], dx)
        xs_try, us_try = [x], []
        for t in range(N):
            u = us[t] + a * kff[t] + K[t] @ dx
            x = space.integrate(stage_at(dyn, t).forward(space, x, u), (a - 1.0) * fs[t + 1])
            dx = space.difference(xs[t + 1], x)
            xs_try.append(x)
            us_try.append(u)
        return torch.stack(xs_try), torch.stack(us_try)

    with values_only():
        xs_try, us_try = _vmap_batch(roll, problem.dynamics, xs, us, fs, kff, K, alpha)
    dxs = vmap(vmap(space.difference))(xs, xs_try)
    return xs_try, us_try, dxs, stage_costs(problem, xs_try, us_try)


def solve(
    problem: TrajOptProblem,
    settings: FDDPSettings = FDDPSettings(),
    xs_init: Optional[torch.Tensor] = None,
    us_init: Optional[torch.Tensor] = None,
) -> FDDPResults:
    """Run FDDP on a batch of problems (x0 (B, nx)); an unbatched problem
    (x0 (nx,)) is solved as B = 1 and the batch axis dropped. Runs on the
    device of the problem's tensors; warm starts carry the batch axis."""
    full_f32_matmuls()
    if problem.x0.dim() == 1:
        add = lambda a: None if a is None else torch.as_tensor(a).unsqueeze(0)
        res = _solve_batched(problem.replace_x0(problem.x0.unsqueeze(0)), settings,
                             add(xs_init), add(us_init))
        return tree_map(lambda a: a[0], res)
    return _solve_batched(problem, settings, xs_init, us_init)


def _solve_batched(problem: TrajOptProblem, s: FDDPSettings, xs_init, us_init):
    N, nu, ndx = problem.nsteps, problem.nu, problem.ndx
    xs0 = xs_default_init(problem) if xs_init is None else torch.as_tensor(xs_init)
    us0 = us_default_init(problem) if us_init is None else torch.as_tensor(us_init)
    Bsz = xs0.shape[0]
    full = lambda v: xs0.new_full((Bsz,), v)
    bfalse = torch.zeros(Bsz, dtype=torch.bool, device=xs0.device)
    c = dict(
        xs=xs0, us=us0, cost=stage_costs(problem, xs0, us0), preg=full(s.reg_init),
        it=torch.zeros(Bsz, dtype=torch.int32, device=xs0.device), conv=bfalse,
        done=bfalse, prim=full(float("inf")), dual=full(float("inf")),
        kff=xs0.new_zeros((Bsz, N, nu)), K=xs0.new_zeros((Bsz, N, nu, ndx)),
    )

    def body(c, active):
        xs, us = c["xs"], c["us"]
        phi0 = stage_costs(problem, xs, us)
        derivs = compute_derivatives(problem, xs, us)
        xnexts = _vmap_batch(lambda d, x, u: d.forward(problem.space, x, u),
                             problem.dynamics, xs[:, :N], us, time=True)
        fs = _gaps(problem, xs, xnexts)
        prim = fs.abs().flatten(1).amax(1)
        outs, Vx_all, Vxx_all, ftVxx_all = _backward(problem, derivs, fs, c["preg"])
        dual = outs.Qu.abs().flatten(1).amax(1)
        conv_now = torch.maximum(prim, dual) < s.tol

        # expected-improvement pieces
        dg = _sum(outs.Qu * outs.kff) + _sum(Vx_all * fs)
        dq = _sum(outs.kff * outs.Quuk) - _sum(ftVxx_all * fs)

        def ls_try(alpha):
            xs_t, us_t, dxs, cost_t = _forward(problem, xs, us, fs, outs.kff, outs.K, alpha)
            dv = -_sum(dxs * ftVxx_all)
            d1, d2 = dg + dv, dq - 2.0 * dv
            dV_model = alpha * (d1 + 0.5 * d2 * alpha)
            dV_real = cost_t - phi0
            ok_descent = (dV_model < 0.0) & (
                (d1.abs() < s.th_grad) | (dV_real <= s.th_accept_step * dV_model))
            ok_ascent = (dV_model >= 0.0) & (dV_real <= s.th_accept_neg_step * dV_model)
            ok = torch.isfinite(cost_t) & (ok_descent | ok_ascent)
            return dict(xs=xs_t, us=us_t, cost=cost_t, d1=d1), ok

        # the full step first for every element, then backtrack
        one = torch.ones_like(phi0)
        trial, ok1 = ls_try(one)
        ls = dict(alpha=one, done=ok1, cnt=torch.zeros_like(c["it"]), **trial)
        while True:
            ls_active = active & ~ls["done"] & (ls["cnt"] < s.ls_max_steps)
            if not bool(ls_active.any()):
                break
            alpha_n = torch.clamp(ls["alpha"] * s.ls_beta, min=s.alpha_min)
            trial, ok = ls_try(alpha_n)
            new = dict(alpha=alpha_n, done=ok | (alpha_n <= s.alpha_min), cnt=ls["cnt"] + 1,
                       **trial)
            ls = tree_where(ls_active, new, ls)

        alpha_f = ls["alpha"]
        conv_grad = ls["d1"].abs() < s.th_grad
        preg = c["preg"]
        preg = torch.where(alpha_f > s.th_step_dec,
                           torch.clamp(preg * s.reg_dec_factor, min=s.reg_min), preg)
        inc = alpha_f <= s.th_step_inc
        preg = torch.where(inc, torch.clamp(preg * s.reg_inc_factor, max=s.reg_max), preg)
        fail_reg = inc & (preg >= s.reg_max)
        # on convergence by the criterion the current iterate is kept
        keep = lambda cur, new: torch.where(_b(conv_now, cur), cur, new)
        return dict(
            xs=keep(xs, ls["xs"]), us=keep(us, ls["us"]), cost=keep(c["cost"], ls["cost"]),
            preg=preg, it=c["it"] + 1, conv=c["conv"] | conv_now | conv_grad,
            done=conv_now | conv_grad | fail_reg, prim=prim, dual=dual,
            kff=outs.kff, K=outs.K,
        )

    while True:
        active = ~c["done"] & (c["it"] < s.max_iters)
        if not bool(active.any()):
            break
        c = tree_where(active, body(c, active), c)

    return FDDPResults(
        xs=c["xs"], us=c["us"], conv=c["conv"], prim_infeas=c["prim"],
        dual_infeas=c["dual"], traj_cost=c["cost"], num_iters=c["it"], kff=c["kff"],
        K=c["K"],
    )


fddp_solve = solve
