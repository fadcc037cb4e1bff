"""ProxDDP — proximal augmented-Lagrangian DDP, batched (port of the
default path of ``aligator_tpu.solvers.proxddp``).

The JAX solver is written for one problem and batched with
``jax.vmap(solve)``: each ``while_loop`` then runs until every element is
done and freezes finished elements by a select, and each ``cond`` becomes
a select. This port reproduces exactly that over an explicit leading
batch axis: Python loops run while ``(~done).any()``, every carried tensor
goes through ``tree_where(active, new, old)``, and step sizes, penalties,
regularizations and tolerances are per-element (B,) tensors. Elements then
match ``jax.vmap(proxddp_solve)`` one for one — iterates, ``conv`` and
iteration counts. Work whose result the select would discard is skipped
(a Newton step when no active element needs one). Each ``.any()`` is a
host sync, read through ``utils.profiling.host_flag``, which counts it at
its site.

Supported: every setting of the JAX solver on one device. The BCL outer
loop, the inner Newton loop, the regularization ladder; Armijo,
nonmonotone and filter step acceptance; linear and nonlinear rollouts
(the latter a closed-loop re-rollout of the dynamics through the LQ
solver's gains, one dynamics step per knot); Gauss-Newton and exact
Hessians (``problem.compute_vhp``); every single-device ``lq_solver``:
"serial", "pallas" (the JAX spelling, here the fused hand-written CUDA
kernels of ``gar.fused_riccati``, whose K1 gains the nonlinear rollout
reads), "parallel" with ``lq_num_legs``, "stagedense", "assoc" and
"dense_oracle"; ``riccati_refine``, ``cost_scale``, ``lq_refine_full``;
``verbose``, ``record_history``, ``record_iterates``, ``callback`` (for an
unbatched solve) and ``debug`` (``solve_checked``), whose host syncs are
taken only when the setting is on. The parallel solver's legs are split
over processes by ``lq_mesh`` (a ``distributed.SolverMesh``) along
``lq_axis_name``: every rank of that group then receives the same gathered
LQ direction, and its evaluations and derivatives are deterministic, so
the ranks make the same loop decisions and end bitwise equal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
from torch.func import vmap

from aligator_tpu_torch.dynamics.base import values_only
from aligator_tpu_torch.gar import assoc as _assoc
from aligator_tpu_torch.gar import fused_riccati as _fused
from aligator_tpu_torch.gar import riccati as _riccati
from aligator_tpu_torch.gar import stagedense as _stagedense
from aligator_tpu_torch.gar.dense import dense_solve
from aligator_tpu_torch.gar.parallel import parallel_solve
from aligator_tpu_torch.gar.lqr_problem import LQRProblem
from aligator_tpu_torch.gar.utils import lqr_kkt_residuals
from aligator_tpu_torch.problem import (
    ProblemData,
    ProblemDerivs,
    TrajOptProblem,
    _vmap_batch,
    compute_derivatives as _derivs_raw,
    compute_vhp,
    evaluate as _eval_raw,
    stage_at,
    us_default_init,
    xs_default_init,
)
from aligator_tpu_torch.solvers.linesearch import (
    FilterState,
    LinesearchOptions,
    armijo_run,
    filter_init,
    filter_run,
)
from aligator_tpu_torch.utils import logger
from aligator_tpu_torch.utils import profiling as prof
from aligator_tpu_torch.utils.device import full_f32_matmuls
from aligator_tpu_torch.utils.profiling import named_scope, span
from aligator_tpu_torch.utils.tree import tree_map, tree_where


@dataclasses.dataclass(frozen=True)
class ProxDDPSettings:
    """Solver parameters; names and defaults as in the JAX package."""

    tol: float = 1e-6
    dual_tol: Optional[float] = None
    mu_init: float = 0.01
    max_iters: int = 100
    max_al_iters: int = 100
    prim_alpha: float = 0.1
    prim_beta: float = 0.9
    dual_alpha: float = 1.0
    dual_beta: float = 1.0
    mu_update_factor: float = 0.01
    mu_lower_bound: float = 1e-8
    multiplier_update_mode: str = "newton"  # "newton"|"primal"|"primal_dual"
    reg_min: float = 1e-10
    reg_max: float = 1e9
    reg_init: float = 1e-9
    reg_inc_k: float = 10.0
    reg_inc_first_k: float = 100.0
    reg_dec_k: float = 1.0 / 3.0
    sa_strategy: str = "nonmonotone"  # "armijo" | "nonmonotone" | "filter"
    ls_interp: str = "cubic"
    ls_contraction_min: float = 0.5
    ls_contraction_max: float = 0.8
    armijo_c1: float = 1e-4
    alpha_min: float = 1e-6
    ls_beta: float = 0.5
    ls_max_steps: int = 25
    ls_avg_eta: float = 0.85
    filter_beta: float = 0.0  # filter margin
    filter_capacity: int = 64
    dphi_thresh: float = 1e-13
    rollout_type: str = "linear"  # "linear" | "nonlinear"
    hessian_approx: str = "gauss_newton"  # "gauss_newton" | "exact"
    verbose: bool = False  # print one row per Newton step (utils.logger)
    record_history: bool = False  # per-step scalars in results.history
    record_iterates: bool = False  # per-step xs/us/lams in results.history_*
    # callback(iter, xs, us, lams, prim, dual), numpy arrays, at every
    # inner-loop criterion evaluation; unbatched solves only
    callback: Any = None
    mu_dyn_scale: float = 0.1
    riccati_refine: int = 1
    lq_refine_full: int = 0
    cost_scale: float = 1.0
    # raise FloatingPointError naming the first NaN/Inf site (solve_checked)
    debug: bool = False
    # serial|parallel|stagedense|dense_oracle|assoc|pallas (the fused CUDA kernels)
    lq_solver: str = "serial"
    lq_num_legs: int = 0  # legs of the parallel solver; 0 = serial
    lq_mesh: Any = None  # distributed.SolverMesh: the parallel solver's legs over "t"
    lq_axis_name: str = "t"


LQ_SOLVERS = ("serial", "parallel", "stagedense", "dense_oracle", "assoc", "pallas")


def _is_parallel(s: ProxDDPSettings) -> bool:
    """As in the JAX package, "serial" with more than one leg means the
    parallel solver."""
    return s.lq_solver == "parallel" or (s.lq_solver == "serial" and s.lq_num_legs > 1)


def _check_supported(s: ProxDDPSettings) -> None:
    if s.lq_solver not in LQ_SOLVERS:
        raise ValueError(f"unknown lq_solver {s.lq_solver!r}")
    if ((_is_parallel(s) or s.lq_solver == "dense_oracle")
            and s.rollout_type == "nonlinear"):
        raise ValueError(
            "nonlinear rollout requires an LQ solver with gains "
            "(serial/pallas/assoc/stagedense); the parallel solver is restricted to "
            "linear rollouts, and the dense oracle forms no gains")
    if s.sa_strategy not in ("armijo", "nonmonotone", "filter"):
        raise ValueError(f"unknown sa_strategy {s.sa_strategy!r}")
    if s.rollout_type not in ("linear", "nonlinear"):
        raise ValueError(f"unknown rollout_type {s.rollout_type!r}")
    if s.hessian_approx not in ("gauss_newton", "exact"):
        raise ValueError(f"unknown hessian_approx {s.hessian_approx!r}")
    if s.multiplier_update_mode not in ("newton", "primal", "primal_dual"):
        raise ValueError(f"unknown multiplier_update_mode {s.multiplier_update_mode!r}")


class Multipliers(NamedTuple):
    lams_plus: torch.Tensor  # (B, N+1, ndx) [:, 0] = init-constraint estimate
    vs_plus: torch.Tensor  # (B, N, nc)
    vs_plus_term: torch.Tensor  # (B, nc_term)
    Lvs: torch.Tensor
    Lvs_term: torch.Tensor
    shifted: torch.Tensor
    shifted_term: torch.Tensor
    active: torch.Tensor
    active_term: torch.Tensor
    prim_infeas: torch.Tensor  # (B,)


class Point(NamedTuple):
    xs: torch.Tensor  # (B, N+1, nx)
    us: torch.Tensor  # (B, N, nu)
    vs: torch.Tensor  # (B, N, nc)
    vs_term: torch.Tensor  # (B, nc_term)
    lams: torch.Tensor  # (B, N+1, ndx)


@dataclasses.dataclass
class ProxDDPResults:
    """Solver output; every field carries the batch axis (dropped again
    for an unbatched call)."""

    xs: torch.Tensor
    us: torch.Tensor
    vs: torch.Tensor
    vs_term: torch.Tensor
    lams: torch.Tensor
    conv: torch.Tensor  # bool
    prim_infeas: torch.Tensor
    dual_infeas: torch.Tensor
    traj_cost: torch.Tensor
    merit_value: torch.Tensor
    num_iters: torch.Tensor  # int
    al_iter: torch.Tensor  # int
    mu_final: torch.Tensor
    # (B, max_iters, 7) [alpha, inner_crit, prim, dual, merit, mu, preg] per
    # Newton step when record_history, else (B, 0, 7)
    history: torch.Tensor
    # (B, max_iters, N+1, nx) / (B, max_iters, N, nu) / (B, max_iters, N+1,
    # ndx) when record_iterates, else with a 0 in place of max_iters
    history_xs: torch.Tensor
    history_us: torch.Tensor
    history_lams: torch.Tensor


@dataclasses.dataclass
class _State:
    pt: Point
    prev_vs: torch.Tensor
    prev_vs_term: torch.Tensor
    mu: torch.Tensor
    inner_tol: torch.Tensor
    prim_tol: torch.Tensor
    preg: torch.Tensor
    preg_last: torch.Tensor
    iters: torch.Tensor
    al_iter: torch.Tensor
    conv: torch.Tensor
    failed: torch.Tensor
    prim_infeas: torch.Tensor
    dual_infeas: torch.Tensor
    inner_crit: torch.Tensor
    traj_cost: torch.Tensor
    merit: torch.Tensor
    ls_avg: torch.Tensor
    ls_w: torch.Tensor
    filt: FilterState
    hist: torch.Tensor
    hist_xs: torch.Tensor
    hist_us: torch.Tensor
    hist_lams: torch.Tensor

    def replace(self, **changes) -> "_State":
        return dataclasses.replace(self, **changes)


def _problem_rows(problem: TrajOptProblem, idx: torch.Tensor) -> TrajOptProblem:
    """The problems of batch elements ``idx`` (M,), one per row: leaves
    shared by the batch stay shared, per-element leaves and x0 are taken at
    ``idx``."""
    rows = lambda t: tree_map(lambda a: a if a.shape[0] == 1 else a[idx], t)
    return problem.replace(
        x0=problem.x0[idx], dynamics=rows(problem.dynamics), cost=rows(problem.cost),
        term_cost=rows(problem.term_cost), constraints=rows(problem.constraints),
        term_constraints=rows(problem.term_constraints))


def _b(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-element (B,) values shaped to broadcast against ``like``."""
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


def _inf(a: torch.Tensor) -> torch.Tensor:
    """Per-element infinity norm over every non-batch axis."""
    if a[0].numel() == 0:
        return a.new_zeros(a.shape[0])
    return a.abs().flatten(1).amax(dim=1)


def _sq(a: torch.Tensor) -> torch.Tensor:
    return (a * a).flatten(1).sum(dim=1)


def _pad_time(a: torch.Tensor, head: bool) -> torch.Tensor:
    z = a.new_zeros(a[:, :1].shape)
    return torch.cat([z, a] if head else [a, z], dim=1)


def _tmv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Mᵀ v over leading axes: (..., i, j), (..., i) → (..., j)."""
    return (M.mT @ v.unsqueeze(-1)).squeeze(-1)


def _debug_check(site: str, mask: torch.Tensor, *arrays) -> None:
    """Raise where an element of ``mask`` holds a NaN or Inf in one of
    ``arrays``, naming the site as the JAX solver's debug mode does (a
    host sync, taken only when ``debug`` is set)."""
    for a in arrays:
        if a[0].numel() and not bool(torch.isfinite(a[mask]).all()):
            raise FloatingPointError(f"NaN/Inf detected at: {site}")


# ---------------------------------------------------------------------------


@named_scope("proxddp.multipliers")
def _compute_multipliers(problem: TrajOptProblem, s: ProxDDPSettings,
                         data: ProblemData, pt: Point, prev_vs, prev_vs_term, mu
                         ) -> Multipliers:
    mu_dyn = s.mu_dyn_scale * mu
    lam0_plus = pt.lams[:, 0] + data.init_err / _b(mu, data.init_err)
    lams_plus = torch.cat(
        [lam0_plus.unsqueeze(1),
         pt.lams[:, 1:] + data.dyn_defects / _b(mu_dyn, data.dyn_defects)], dim=1)

    sp, tp = problem.stage_set_product, problem.term_set_product
    mu3 = _b(mu, data.cstr_vals)
    shifted = data.cstr_vals + mu3 * prev_vs
    raw = sp.normal_cone_projection(shifted, mu3) if problem.nc else shifted
    active = sp.active_set(shifted, mu3) if problem.nc else shifted
    Lvs = raw - mu3 * pt.vs
    vs_plus = raw / mu3
    stage_infeas = raw - mu3 * prev_vs

    mu2 = _b(mu, data.term_cstr_vals)
    shifted_t = data.term_cstr_vals + mu2 * prev_vs_term
    raw_t = tp.normal_cone_projection(shifted_t, mu2) if problem.nc_term else shifted_t
    active_t = tp.active_set(shifted_t, mu2) if problem.nc_term else shifted_t
    Lvs_t = raw_t - mu2 * pt.vs_term
    vs_plus_t = raw_t / mu2
    term_infeas = raw_t - mu2 * prev_vs_term

    prim_infeas = torch.maximum(
        torch.maximum(_inf(stage_infeas), _inf(term_infeas)),
        torch.maximum(_inf(data.dyn_defects), _inf(data.init_err)),
    )
    return Multipliers(
        lams_plus=lams_plus, vs_plus=vs_plus, vs_plus_term=vs_plus_t, Lvs=Lvs,
        Lvs_term=Lvs_t, shifted=shifted, shifted_term=shifted_t, active=active,
        active_term=active_t, prim_infeas=prim_infeas,
    )


def _merit(s: ProxDDPSettings, data: ProblemData, mult: Multipliers, mu):
    """The AL merit function per element."""
    mu_dyn = s.mu_dyn_scale * mu
    pen = 0.5 * mu * _sq(mult.lams_plus[:, 0])
    pen = pen + 0.5 * mu_dyn * _sq(mult.lams_plus[:, 1:])
    pen = pen + 0.5 * mu * (_sq(mult.vs_plus) + _sq(mult.vs_plus_term))
    return data.traj_cost + pen


@named_scope("proxddp.lagrangian")
def _lagrangian_derivs(problem: TrajOptProblem, derivs: ProblemDerivs, lams, vs,
                       vs_term):
    """→ (Lxs (B, N+1, ndx), Lus (B, N, nu))."""
    init = _tmv(derivs.G0, lams[:, 0]).unsqueeze(1)
    Lxs = derivs.Lx + torch.cat(
        [init, init.new_zeros((init.shape[0], problem.nsteps, init.shape[-1]))], dim=1)
    Lxs = Lxs + _pad_time(_tmv(derivs.A, lams[:, 1:]), head=False)
    Lus = derivs.Lu + _tmv(derivs.B, lams[:, 1:])
    Lxs = Lxs + _pad_time(-lams[:, 1:], head=True)
    if problem.nc:
        Lxs = Lxs + _pad_time(_tmv(derivs.Cx, vs), head=False)
        Lus = Lus + _tmv(derivs.Cu, vs)
    if problem.nc_term:
        term = _tmv(derivs.Cx_term, vs_term).unsqueeze(1)
        Lxs = Lxs + torch.cat(
            [term.new_zeros((term.shape[0], problem.nsteps, term.shape[-1])), term], dim=1)
    return Lxs, Lus


def _criterion(data: ProblemData, Lxs, Lus, mult: Multipliers):
    rx = _inf(Lxs)
    ru = _inf(Lus)
    rd = torch.maximum(_inf(data.dyn_defects), _inf(data.init_err))
    rc = torch.maximum(_inf(mult.Lvs), _inf(mult.Lvs_term))
    inner_crit = torch.maximum(torch.maximum(rx, ru), torch.maximum(rd, rc))
    return inner_crit, torch.maximum(rx, ru)


@named_scope("proxddp.lq_update")
def _build_lq(problem: TrajOptProblem, data: ProblemData, derivs: ProblemDerivs,
              mult: Multipliers, Lxs, Lus, mu, preg, vhp=None) -> LQRProblem:
    """Projected Jacobians + the LQ subproblem, stacked over knots 0..N
    (terminal control slot = exact padding R = I). ``vhp`` optionally
    carries the exact second-order terms (Hxx, Hxu, Huu)."""
    N = problem.nsteps
    ndx, nu, nc, nct = problem.ndx, problem.nu, problem.nc, problem.nc_term
    ncp = max(nc, nct)
    Bsz = Lxs.shape[0]
    dt, dev = Lxs.dtype, Lxs.device
    eye_x = torch.eye(ndx, dtype=dt, device=dev)
    eye_u = torch.eye(nu, dtype=dt, device=dev)
    z = lambda *s: torch.zeros((Bsz,) + s, dtype=dt, device=dev)

    if nc:
        inactive = 1.0 - mult.active
        Lv_mu = mult.Lvs / _b(mu, mult.Lvs)
        corr_x = _tmv(derivs.Cx, inactive * Lv_mu)
        Cx_p = mult.active.unsqueeze(-1) * derivs.Cx
        Cu_p = mult.active.unsqueeze(-1) * derivs.Cu
    else:
        corr_x = z(N, ndx)
        Cx_p, Cu_p = derivs.Cx, derivs.Cu
    if nct:
        inactive_t = 1.0 - mult.active_term
        corr_xN = _tmv(derivs.Cx_term, inactive_t * (mult.Lvs_term / _b(mu, mult.Lvs_term)))
        CxN_p = mult.active_term.unsqueeze(-1) * derivs.Cx_term
    else:
        corr_xN = z(ndx)
        CxN_p = derivs.Cx_term

    Lxx, Lxu, Luu = derivs.Lxx, derivs.Lxu, derivs.Luu
    if vhp is not None:
        Lxx, Lxu, Luu = Lxx + vhp[0], Lxu + vhp[1], Luu + vhp[2]
    p3 = preg.reshape(Bsz, 1, 1, 1)
    Q = Lxx + p3 * eye_x
    R = torch.cat([Luu + p3 * eye_u, eye_u.expand(Bsz, 1, nu, nu)], dim=1)
    S = torch.cat([Lxu, z(1, ndx, nu)], dim=1)
    q = torch.cat([Lxs[:, :N] + corr_x, (Lxs[:, N] + corr_xN).unsqueeze(1)], dim=1)
    r = torch.cat([Lus, z(1, nu)], dim=1)
    A = torch.cat([derivs.A, z(1, ndx, ndx)], dim=1)
    B = torch.cat([derivs.B, z(1, ndx, nu)], dim=1)
    f = torch.cat([data.dyn_defects, z(1, ndx)], dim=1)

    rows = lambda a: torch.nn.functional.pad(a, (0, 0, 0, ncp - a.shape[-2]))
    if nc:
        C_body, D_body = rows(Cx_p), rows(Cu_p)
        d_body = torch.nn.functional.pad(mult.Lvs, (0, ncp - nc))
    else:
        C_body, D_body, d_body = z(N, ncp, ndx), z(N, ncp, nu), z(N, ncp)
    if nct:
        C_term = rows(CxN_p).unsqueeze(1)
        d_term = torch.nn.functional.pad(mult.Lvs_term, (0, ncp - nct)).unsqueeze(1)
    else:
        C_term, d_term = z(1, ncp, ndx), z(1, ncp)
    L = N + 1
    return LQRProblem(
        Q=Q, S=S, R=R, q=q, r=r, A=A, B=B, f=f,
        C=torch.cat([C_body, C_term], dim=1),
        D=torch.cat([D_body, z(1, ncp, nu)], dim=1),
        d=torch.cat([d_body, d_term], dim=1),
        Gx=z(L, ndx, 0), Gu=z(L, nu, 0), Gth=z(L, 0, 0), gamma=z(L, 0),
        G0=derivs.G0, g0=data.init_err,
    )


def _solve_lq_once(s: ProxDDPSettings, lq: LQRProblem, mu):
    """One LQ solve → ((dxs, dus, dvs, dlams), gains or None), by
    ``s.lq_solver``. The gains (``gar.riccati.Gains``, (B, N+1, ...)) are
    what a nonlinear rollout reads: those of the serial recursion, assoc,
    stagedense, or K1's for "pallas"; parallel and the dense oracle form
    none."""
    with span("proxddp.riccati"):
        if _is_parallel(s):
            return parallel_solve(lq, mu, max(s.lq_num_legs, 2), mesh=s.lq_mesh,
                                  axis_name=s.lq_axis_name,
                                  refine_steps=s.riccati_refine), None
        if s.lq_solver == "dense_oracle":
            return dense_solve(lq, mu), None
        if s.lq_solver == "stagedense":
            *sol, factors = _stagedense.solve(lq, mu)
        elif s.lq_solver == "assoc":
            *sol, factors = _assoc.solve(lq, mu, refine_steps=s.riccati_refine)
        else:
            mod = _fused if s.lq_solver == "pallas" else _riccati
            factors = mod.backward(lq, mu, refine_steps=s.riccati_refine)
            sol = mod.forward(lq, factors)
        return tuple(sol), factors.gains


def _solve_lq(s: ProxDDPSettings, lq: LQRProblem, mu):
    """LQ direction and gains, with optional full-KKT iterative refinement
    of the direction: the residual is accumulated in float64 and the
    correction solved in the working precision by the same LQ solver
    (K δ = −res, new = old + δ)."""
    sol, gains = _solve_lq_once(s, lq, mu)
    if s.lq_refine_full > 0:
        dt, hi = lq.dtype, torch.float64
        lq_hi = tree_map(lambda a: a.to(hi), lq)
        for _ in range(s.lq_refine_full):
            with span("proxddp.riccati.full_refine"):
                res = lqr_kkt_residuals(lq_hi, *(a.to(hi) for a in sol),
                                        mueq=mu.to(hi))
                res_lq = lq.replace(q=res.q.to(dt), r=res.r.to(dt), d=res.d.to(dt),
                                    f=res.f.to(dt), g0=res.g0.to(dt))
                corr, _ = _solve_lq_once(s, res_lq, mu)
            sol = tuple(a + c for a, c in zip(sol, corr))
    return sol, gains


# ---------------------------------------------------------------------------


def _as_batch(v, B: int, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor) and v.device == like.device:
        t = v.to(like.dtype)
    else:
        with prof.host_sync("as_batch"):  # a pageable copy to the device
            t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return t.expand(B).clone() if t.dim() == 0 else t


@named_scope("proxddp.solve")
def solve(
    problem: TrajOptProblem,
    settings: ProxDDPSettings = ProxDDPSettings(),
    xs_init: Optional[torch.Tensor] = None,
    us_init: Optional[torch.Tensor] = None,
    vs_init: Optional[torch.Tensor] = None,
    lams_init: Optional[torch.Tensor] = None,
    mu_init=None,
    tol=None,
) -> ProxDDPResults:
    """Run ProxDDP on a batch of problems (x0 (B, nx)); an unbatched
    problem (x0 (nx,)) is solved as B = 1 and the batch axis dropped.
    Runs on the device of the problem's tensors. Warm starts carry the
    batch axis; ``mu_init``/``tol`` may be scalars or (B,) tensors.
    ``force_initial_condition`` semantics: xs[0] is pinned to x0."""
    _check_supported(settings)
    full_f32_matmuls()
    if problem.x0.dim() == 1:
        add = lambda a: None if a is None else torch.as_tensor(a).unsqueeze(0)
        res = _solve_batched(
            problem.replace_x0(problem.x0.unsqueeze(0)), settings, add(xs_init),
            add(us_init), add(vs_init), add(lams_init), mu_init, tol)
        return tree_map(lambda a: a[0], res)
    if settings.callback is not None:
        raise ValueError("callback observes one solve: pass an unbatched problem "
                         "(x0 of shape (nx,))")
    return _solve_batched(problem, settings, xs_init, us_init, vs_init, lams_init,
                          mu_init, tol)


def solve_checked(problem: TrajOptProblem, settings: ProxDDPSettings = ProxDDPSettings(),
                  **kwargs) -> ProxDDPResults:
    """``solve`` in debug mode: raises ``FloatingPointError("NaN/Inf
    detected at: <site>")`` at the first NaN- or Inf-poisoned site (problem
    evaluation, derivatives, multiplier estimates, the LQ direction)
    instead of reporting conv=False. Each check is a host sync."""
    return solve(problem, dataclasses.replace(settings, debug=True), **kwargs)


def _solve_batched(problem, s, xs_init, us_init, vs_init, lams_init, mu_init, tol):
    N = problem.nsteps
    nc, nct, ndx = problem.nc, problem.nc_term, problem.ndx
    x0 = problem.x0
    Bsz = x0.shape[0]

    xs0 = xs_default_init(problem) if xs_init is None else torch.as_tensor(xs_init)
    us0 = us_default_init(problem) if us_init is None else torch.as_tensor(us_init)
    xs0 = torch.cat([x0.unsqueeze(1), xs0[:, 1:]], dim=1)
    dt, dev = xs0.dtype, xs0.device

    g0 = s.cost_scale
    vs0 = (xs0.new_zeros((Bsz, N, nc)) if vs_init is None
           else torch.as_tensor(vs_init) * g0)
    vsT0 = xs0.new_zeros((Bsz, nct))
    lams0 = (xs0.new_zeros((Bsz, N + 1, ndx)) if lams_init is None
             else torch.as_tensor(lams_init) * g0)

    target_tol = _as_batch(s.tol if tol is None else tol, Bsz, xs0)
    target_dual = (_as_batch(s.dual_tol, Bsz, xs0) if s.dual_tol is not None
                   else target_tol)

    def tols_on_failure(mu):
        arg = torch.clamp(mu, max=0.99)
        return arg ** s.prim_alpha, arg ** s.dual_alpha  # (prim_tol, inner_tol)

    mu_init = torch.clamp(_as_batch(s.mu_init if mu_init is None else mu_init, Bsz, xs0),
                          min=s.mu_lower_bound)
    prim_tol0, inner_tol0 = tols_on_failure(mu_init)
    zero = xs0.new_zeros(Bsz)
    izero = torch.zeros(Bsz, dtype=torch.int32, device=dev)
    bfalse = torch.zeros(Bsz, dtype=torch.bool, device=dev)
    n_hist = s.max_iters if s.record_history else 0
    n_iter = s.max_iters if s.record_iterates else 0
    st = _State(
        pt=Point(xs=xs0, us=us0, vs=vs0, vs_term=vsT0, lams=lams0),
        prev_vs=vs0, prev_vs_term=vsT0, mu=mu_init,
        inner_tol=torch.maximum(inner_tol0, target_dual),
        prim_tol=torch.maximum(prim_tol0, target_tol),
        preg=torch.full((Bsz,), s.reg_init, dtype=dt, device=dev), preg_last=zero,
        iters=izero, al_iter=izero, conv=bfalse, failed=bfalse,
        prim_infeas=zero, dual_infeas=zero, inner_crit=zero, traj_cost=zero,
        merit=zero, ls_avg=zero, ls_w=zero,
        filt=filter_init(s.filter_capacity, Bsz, dt, dev),
        hist=xs0.new_zeros((Bsz, n_hist, 7)),
        hist_xs=xs0.new_zeros((Bsz, n_iter) + xs0.shape[1:]),
        hist_us=xs0.new_zeros((Bsz, n_iter) + us0.shape[1:]),
        hist_lams=xs0.new_zeros((Bsz, n_iter) + lams0.shape[1:]),
    )

    # internal cost normalization (ProxDDPSettings.cost_scale): cost values,
    # gradients and Hessians are scaled; results are unscaled on return
    def evaluate(xs, us, prob=problem):
        data = _eval_raw(prob, xs, us)
        if g0 != 1.0:
            data = data._replace(costs=data.costs * g0, term_cost=data.term_cost * g0)
        return data

    def compute_derivatives(xs, us):
        d = _derivs_raw(problem, xs, us)
        if g0 != 1.0:
            d = d._replace(Lx=d.Lx * g0, Lu=d.Lu * g0, Lxx=d.Lxx * g0,
                           Lxu=d.Lxu * g0, Luu=d.Luu * g0)
        return d

    def eval_point(pt: Point, prev_vs, prev_vs_term, mu, prob=problem):
        with span("proxddp.evaluate"):
            data = evaluate(pt.xs, pt.us, prob)
            mult = _compute_multipliers(prob, s, data, pt, prev_vs, prev_vs_term, mu)
            return data, mult, _merit(s, data, mult, mu)

    integrate = vmap(vmap(problem.space.integrate))

    def try_step(pt: Point, dpt: Point, alpha):
        """Manifold step x ⊕ α dx with dxs[:, 0] = 0 (initial condition)."""
        xs = integrate(pt.xs, _b(alpha, dpt.xs) * dpt.xs)
        xs = torch.cat([pt.xs[:, :1], xs[:, 1:]], dim=1)
        return Point(
            xs=xs,
            us=pt.us + _b(alpha, pt.us) * dpt.us,
            vs=pt.vs + _b(alpha, pt.vs) * dpt.vs,
            vs_term=pt.vs_term + _b(alpha, pt.vs_term) * dpt.vs_term,
            lams=pt.lams + _b(alpha, pt.lams) * dpt.lams,
        )

    @named_scope("proxddp.rollout")
    def try_step_nonlinear(pt: Point, dpt: Point, gains, alpha, prob=problem):
        """Closed-loop re-rollout of the dynamics through the LQ gains, one
        step per knot, dx measured against the current iterate (dxs[:, 0] =
        0); λ stepped linearly."""
        space = problem.space

        def roll(dyn, xs, us, vs, kff, K, zff, Z, a):
            x = xs[0]
            xs_t, us_t, vs_t = [x], [], []
            for t in range(N):
                dx = space.difference(xs[t], x)
                u = us[t] + a * kff[t] + K[t] @ dx
                vs_t.append(vs[t] + a * zff[t, :nc] + Z[t, :nc] @ dx)
                x = stage_at(dyn, t).forward(space, x, u)
                xs_t.append(x)
                us_t.append(u)
            return (torch.stack(xs_t), torch.stack(us_t), torch.stack(vs_t),
                    space.difference(xs[N], x))

        with values_only():
            xs, us, vs, dxN = _vmap_batch(roll, prob.dynamics, pt.xs, pt.us, pt.vs,
                                          gains.kff, gains.K, gains.zff, gains.Z, alpha)
        vs_term = (pt.vs_term + _b(alpha, pt.vs_term) * gains.zff[:, N, :nct]
                   + _riccati.mv(gains.Z[:, N, :nct], dxN))
        return Point(xs=xs, us=us, vs=vs, vs_term=vs_term,
                     lams=pt.lams + _b(alpha, pt.lams) * dpt.lams)

    ls_opts = LinesearchOptions(
        armijo_c1=s.armijo_c1, alpha_min=s.alpha_min, max_num_steps=s.ls_max_steps,
        contraction_min=s.ls_contraction_min, contraction_max=s.ls_contraction_max,
        interp_type="bisection" if s.sa_strategy == "nonmonotone" else s.ls_interp,
        beta_dec=s.ls_beta,
    )

    def newton_step(st: _State, data, mult, derivs, Lxs_c, Lus_c, stepping):
        preg = torch.where(
            st.preg_last == 0.0,
            torch.full_like(st.preg, max(s.reg_init, s.reg_min)),
            torch.clamp(st.preg_last * s.reg_dec_k, min=s.reg_min),
        )
        # exact Hessian: weighted by the current (Newton) duals
        vhp = (compute_vhp(problem, st.pt.xs, st.pt.us, st.pt.lams, st.pt.vs,
                           st.pt.vs_term) if s.hessian_approx == "exact" else None)
        lq = _build_lq(problem, data, derivs, mult, Lxs_c, Lus_c, st.mu, preg, vhp=vhp)
        (dxs, dus_full, dvs_full, dlams), gains = _solve_lq(s, lq, st.mu)
        if s.debug:
            _debug_check("Riccati backward/forward (LQ direction)", stepping,
                         dxs, dus_full, dlams)
        m0 = _pad_time(dxs.new_ones((Bsz, N, 1)), head=True)  # zero row 0
        dxs = dxs * m0
        dlams = dlams * m0
        dpt = Point(xs=dxs, us=dus_full[:, :N], vs=dvs_full[:, :N, :nc],
                    vs_term=dvs_full[:, N, :nct], lams=dlams)

        # directional derivative with the AL multiplier estimates
        Lxs_p, Lus_p = _lagrangian_derivs(problem, derivs, mult.lams_plus,
                                          mult.vs_plus, mult.vs_plus_term)
        dphi0 = (Lxs_p * dpt.xs).flatten(1).sum(1) + (Lus_p * dpt.us).flatten(1).sum(1)
        # ascent ⇒ indefinite model: the merit linesearches reject the step
        # and escalate preg; the filter rejects only non-finite trials
        ascent = dphi0 >= 0.0
        bad_dir = ascent if s.sa_strategy != "filter" else torch.zeros_like(ascent)
        exit_dphi = (~ascent) & (-dphi0 <= s.dphi_thresh)

        phi0 = st.merit
        ls_avg = (s.ls_avg_eta * st.ls_w * st.ls_avg + phi0) / (s.ls_avg_eta * st.ls_w + 1.0)
        ls_w = s.ls_avg_eta * st.ls_w + 1.0

        def ls_eval(alpha):
            if s.rollout_type == "nonlinear":
                pt_t = try_step_nonlinear(st.pt, dpt, gains, alpha)
            else:
                pt_t = try_step(st.pt, dpt, alpha)
            data_t, mult_t, phi_t = eval_point(pt_t, st.prev_vs, st.prev_vs_term, st.mu)
            return phi_t, (pt_t, data_t, mult_t)

        def ls_eval_rows(idx, alpha):
            """ls_eval of elements ``idx`` at their own steps ``alpha``, one
            row each."""
            rows = lambda t: tree_map(lambda a: a[idx], t)
            prob = _problem_rows(problem, idx)
            if s.rollout_type == "nonlinear":
                pt_t = try_step_nonlinear(rows(st.pt), rows(dpt), rows(gains), alpha, prob)
            else:
                pt_t = try_step(rows(st.pt), rows(dpt), alpha)
            data_t, mult_t, phi_t = eval_point(pt_t, rows(st.prev_vs), rows(st.prev_vs_term),
                                               st.mu[idx], prob)
            return phi_t, (pt_t, data_t, mult_t)

        with span("proxddp.linesearch"):
            if s.sa_strategy == "filter":
                def pair_eval(alpha):
                    phi_t, payload = ls_eval(alpha)
                    return phi_t, payload[2].prim_infeas, payload

                alpha_f, phi_f, (pt_f, data_f, mult_f), filt_f = filter_run(
                    pair_eval, st.filt, ls_opts, beta=s.filter_beta)
            else:
                phi_ref = ls_avg if s.sa_strategy == "nonmonotone" else phi0
                alpha_f, phi_f, (pt_f, data_f, mult_f) = armijo_run(
                    ls_eval, phi0, dphi0, ls_opts, phi_ref=phi_ref, phi_eval_rows=ls_eval_rows)
                filt_f = st.filt

        # accept unless a rejected direction or non-finite merit: then
        # revert and escalate
        ok = torch.isfinite(phi_f) & (~bad_dir)
        pt_f = tree_where(ok, pt_f, st.pt)
        data_f = tree_where(ok, data_f, data)
        mult_f = tree_where(ok, mult_f, mult)
        phi_f = torch.where(ok, phi_f, st.merit)
        alpha_f = torch.where(ok, alpha_f, torch.zeros_like(alpha_f))

        hit_min = (alpha_f <= s.alpha_min) | ~ok
        preg_next = torch.where(
            hit_min,
            torch.where(st.preg_last == 0.0, preg * s.reg_inc_first_k, preg * s.reg_inc_k),
            preg,
        )
        fail_reg = hit_min & (preg >= s.reg_max)

        if s.verbose:
            for b in stepping.nonzero().flatten().tolist():
                logger.print_row(st.iters[b], alpha_f[b], st.inner_crit[b],
                                 mult_f.prim_infeas[b], st.dual_infeas[b], preg[b],
                                 dphi0[b], phi_f[b], phi_f[b] - phi0[b], st.al_iter[b],
                                 st.mu[b])
        # the row of this step (clamped: a row is written only where the
        # step is taken, and there iters < max_iters)
        row = (torch.arange(Bsz, device=dev), st.iters.long().clamp(max=s.max_iters - 1))
        hist, hist_xs, hist_us, hist_lams = st.hist, st.hist_xs, st.hist_us, st.hist_lams
        if s.record_history:
            hist = hist.index_put(row, torch.stack([
                alpha_f, st.inner_crit, mult_f.prim_infeas, st.dual_infeas, phi_f, st.mu,
                preg], dim=-1))
        if s.record_iterates:
            hist_xs = hist_xs.index_put(row, pt_f.xs)
            hist_us = hist_us.index_put(row, pt_f.us)
            hist_lams = hist_lams.index_put(row, pt_f.lams)
        st = st.replace(
            pt=pt_f, traj_cost=data_f.traj_cost, merit=phi_f,
            prim_infeas=mult_f.prim_infeas, preg=preg_next, preg_last=preg_next,
            ls_avg=ls_avg, ls_w=ls_w, filt=filt_f, hist=hist, hist_xs=hist_xs,
            hist_us=hist_us, hist_lams=hist_lams, iters=st.iters + 1,
            failed=st.failed | fail_reg,
        )
        return st, data_f, mult_f, exit_dphi

    def inner_iteration(st: _State, data, mult, active):
        """One Newton iteration; the step is skipped (selected away) where
        the subproblem criterion already passes."""
        with span("proxddp.derivatives"):
            derivs = compute_derivatives(st.pt.xs, st.pt.us)
        if s.debug:
            _debug_check("problem evaluation at accepted iterate (dynamics rollout / cost)",
                         active, st.pt.xs, data.traj_cost, data.dyn_defects)
            _debug_check("problem derivatives (dynamics/cost Jacobians)", active,
                         derivs.A, derivs.B, derivs.Lx)
            _debug_check("AL multiplier estimates (computeMultipliers)", active,
                         mult.lams_plus, mult.vs_plus)
        Lxs_c, Lus_c = _lagrangian_derivs(problem, derivs, st.pt.lams, st.pt.vs,
                                          st.pt.vs_term)
        # force_initial_condition: zero row 0 (a multiply, as in the JAX solver)
        Lxs_c = Lxs_c * _pad_time(Lxs_c.new_ones((Bsz, N, 1)), head=True)
        inner_crit, dual_infeas = _criterion(data, Lxs_c, Lus_c, mult)
        converged = (dual_infeas <= target_dual) & (mult.prim_infeas <= target_tol)
        exit_ok = (inner_crit <= st.inner_tol) | converged
        st = st.replace(inner_crit=inner_crit, dual_infeas=dual_infeas, conv=converged)
        if s.callback is not None:
            host = lambda a: a[0].detach().cpu().numpy()
            s.callback(host(st.iters), host(st.pt.xs), host(st.pt.us), host(st.pt.lams),
                       host(mult.prim_infeas), host(dual_infeas))
        no_step = (st, data, mult, torch.ones_like(exit_ok))
        stepping = active & ~exit_ok
        if not prof.host_flag(stepping.any(), "newton_step"):
            return no_step
        stepped = newton_step(st, data, mult, derivs, Lxs_c, Lus_c, stepping)
        return tree_where(exit_ok, no_step, stepped)

    def inner_loop(st: _State, outer_active):
        data, mult, phi = eval_point(st.pt, st.prev_vs, st.prev_vs_term, st.mu)
        st = st.replace(merit=phi, traj_cost=data.traj_cost, prim_infeas=mult.prim_infeas)
        # elements the outer loop will discard start (and stay) exited
        exited = ~outer_active
        carry = (st, data, mult, exited)
        while True:
            st, data, mult, exited = carry
            active = (~exited) & (~st.failed) & (st.iters < s.max_iters)
            if not prof.host_flag(active.any(), "inner_loop"):
                break
            carry = tree_where(active, inner_iteration(st, data, mult, active), carry)
        return st.replace(failed=st.failed | (~exited & (st.iters >= s.max_iters))), mult

    def on_success(st: _State, mult: Multipliers, loop_mask):
        arg = torch.clamp(st.mu, max=0.99)
        tbody = lambda tols: (tols[0] * arg ** s.prim_beta, tols[1] * arg ** s.dual_beta)
        tols = tbody((st.prim_tol, st.inner_tol))
        while True:
            go = loop_mask & (st.inner_crit < tols[1])
            if not prof.host_flag(go.any(), "al_tolerance"):
                break
            tols = tree_where(go, tbody(tols), tols)
        conv = (st.dual_infeas <= target_dual) & (st.prim_infeas <= target_tol)
        if s.multiplier_update_mode == "newton":
            new_vs, new_vs_term = st.pt.vs, st.pt.vs_term
        elif s.multiplier_update_mode == "primal":
            new_vs, new_vs_term = mult.vs_plus, mult.vs_plus_term
        else:  # "primal_dual"
            new_vs = 2.0 * mult.vs_plus - st.pt.vs
            new_vs_term = 2.0 * mult.vs_plus_term - st.pt.vs_term
        return st.replace(prev_vs=new_vs, prev_vs_term=new_vs_term, prim_tol=tols[0],
                          inner_tol=tols[1], conv=st.conv | conv)

    def on_failure(st: _State):
        mu_n = torch.clamp(st.mu * s.mu_update_factor, min=s.mu_lower_bound)
        prim_tol, inner_tol = tols_on_failure(mu_n)
        # reset the penalty to mu_init once it bottoms out
        mu_n = torch.where(mu_n <= s.mu_lower_bound * (1.0 + 1e-12), mu_init, mu_n)
        return st.replace(mu=mu_n, prim_tol=prim_tol, inner_tol=inner_tol)

    def outer_body(st: _State, active):
        st, mult = inner_loop(st, active)
        st = st.replace(ls_avg=torch.zeros_like(st.ls_avg),
                        ls_w=torch.zeros_like(st.ls_w))
        success = st.prim_infeas <= st.prim_tol
        with span("proxddp.al_update"):
            st = tree_where(success, on_success(st, mult, active & success), on_failure(st))
        return st.replace(
            inner_tol=torch.maximum(st.inner_tol, 0.01 * target_dual),
            prim_tol=torch.maximum(st.prim_tol, target_tol),
            al_iter=st.al_iter + 1,
        )

    while True:
        active = ((st.al_iter < s.max_al_iters) & (st.iters < s.max_iters)
                  & (~st.conv) & (~st.failed))
        if not prof.host_flag(active.any(), "outer_loop"):
            break
        st = tree_where(active, outer_body(st, active), st)

    inv_g = 1.0 / s.cost_scale
    return ProxDDPResults(
        xs=st.pt.xs, us=st.pt.us, vs=st.pt.vs * inv_g, vs_term=st.pt.vs_term * inv_g,
        lams=st.pt.lams * inv_g, conv=st.conv, prim_infeas=st.prim_infeas,
        dual_infeas=st.dual_infeas, traj_cost=st.traj_cost * inv_g,
        merit_value=st.merit, num_iters=st.iters, al_iter=st.al_iter, mu_final=st.mu,
        history=st.hist, history_xs=st.hist_xs, history_us=st.hist_us,
        history_lams=st.hist_lams,
    )


proxddp_solve = solve
proxddp_solve_checked = solve_checked
