"""Trajectory-optimization problem layer (port of ``aligator_tpu.problem``).

A problem is ONE homogeneous stage specification whose tensor parameters
are stacked over the horizon (leading time axis N), plus a terminal cost
and constraint stack and an initial condition. Per-stage evaluation is
``torch.func.vmap`` over time, nested in a vmap over the batch of
problems: trajectories carry a leading batch axis B. Every tensor of the
stage and terminal objects carries a leading batch axis too, broadcast as
torch broadcasts: of length 1 where the batch shares it, of length B where
each element has its own. Stage leaves are then (1 or B, N, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.func import hessian, vmap

from aligator_tpu_torch.constraints import ConstraintSet, ConstraintSetProduct
from aligator_tpu_torch.dynamics.base import values_only
from aligator_tpu_torch.functions.basic import StateErrorResidual
from aligator_tpu_torch.manifolds.base import Manifold
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.profiling import named_scope, span
from aligator_tpu_torch.utils.tree import (
    static_field,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


@dataclasses.dataclass(frozen=True)
class TrajOptProblem:
    """Stacked trajectory-optimization problem. Stage objects have tensor
    leaves (1 or B, nsteps, ...), terminal objects (1 or B, ...); the
    initial condition is the residual x ⊖ x0."""

    x0: torch.Tensor  # (B, nx)
    dynamics: Any
    cost: Any
    term_cost: Any
    constraints: Tuple[Any, ...]
    term_constraints: Tuple[Any, ...]

    space: Manifold = static_field()
    nu: int = static_field()
    nsteps: int = static_field()
    constraint_sets: Tuple[ConstraintSet, ...] = static_field()
    constraint_dims: Tuple[int, ...] = static_field()
    term_sets: Tuple[ConstraintSet, ...] = static_field()
    term_dims: Tuple[int, ...] = static_field()

    @property
    def ndx(self) -> int:
        return self.space.ndx

    @property
    def nc(self) -> int:
        return sum(self.constraint_dims)

    @property
    def nc_term(self) -> int:
        return sum(self.term_dims)

    @property
    def stage_set_product(self) -> ConstraintSetProduct:
        return ConstraintSetProduct(sets=self.constraint_sets, dims=self.constraint_dims)

    @property
    def term_set_product(self) -> ConstraintSetProduct:
        return ConstraintSetProduct(sets=self.term_sets, dims=self.term_dims)

    def replace(self, **changes) -> "TrajOptProblem":
        return dataclasses.replace(self, **changes)

    def replace_x0(self, x0) -> "TrajOptProblem":
        return self.replace(x0=x0)


def tile_stage(obj, nsteps: int):
    """Broadcast a time-invariant stage object to the horizon (a view: no
    copy); the time axis goes after the batch axis."""
    return tree_map(
        lambda a: a.unsqueeze(1).expand(a.shape[0], nsteps, *a.shape[1:]), obj)


def build_problem(
    space: Manifold,
    nu: int,
    nsteps: int,
    x0,
    dynamics,
    cost,
    term_cost,
    constraints: Sequence[Tuple[Any, ConstraintSet, int]] = (),
    term_constraints: Sequence[Tuple[Any, ConstraintSet, int]] = (),
    tile: bool = True,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> TrajOptProblem:
    """Constructor. ``constraints`` entries are (residual, set, nr). With
    ``tile`` stage objects are time-invariant and tiled to the horizon.
    Object leaves carry a leading batch axis of 1 (shared) or B. Every
    tensor is
    moved to ``device`` (default: the GPU; raises without one) and cast to
    ``dtype`` (default: that of the dynamics' tensors). ``x0`` is (nx,) or
    (B, nx)."""
    device = resolve_device(device)
    if dtype is None:
        leaves = tree_leaves(dynamics)
        dtype = leaves[0].dtype if leaves else torch.as_tensor(x0).dtype
    mv = lambda o: tree_map(lambda a: a.to(device=device, dtype=dtype), o)
    t = (lambda o: tile_stage(mv(o), nsteps)) if tile else mv
    x0 = torch.as_tensor(x0).to(device=device, dtype=dtype)
    return TrajOptProblem(
        x0=x0,
        dynamics=t(dynamics),
        cost=t(cost),
        term_cost=mv(term_cost),
        constraints=tuple(t(f) for f, _, _ in constraints),
        term_constraints=tuple(mv(f) for f, _, _ in term_constraints),
        space=space,
        nu=nu,
        nsteps=nsteps,
        constraint_sets=tuple(s for _, s, _ in constraints),
        constraint_dims=tuple(n for _, _, n in constraints),
        term_sets=tuple(s for _, s, _ in term_constraints),
        term_dims=tuple(n for _, _, n in term_constraints),
    )


# ---------------------------------------------------------------------------
# evaluation & derivative passes
# ---------------------------------------------------------------------------


class ProblemData(NamedTuple):
    """Values of every problem term along a batch of trajectories."""

    costs: torch.Tensor  # (B, N) running costs
    term_cost: torch.Tensor  # (B,)
    init_err: torch.Tensor  # (B, ndx)
    dyn_defects: torch.Tensor  # (B, N, ndx)
    cstr_vals: torch.Tensor  # (B, N, nc)
    term_cstr_vals: torch.Tensor  # (B, nc_term)

    @property
    def traj_cost(self):
        return self.costs.sum(-1) + self.term_cost


class ProblemDerivs(NamedTuple):
    Lx: torch.Tensor  # (B, N+1, ndx) (terminal in last row)
    Lu: torch.Tensor  # (B, N, nu)
    Lxx: torch.Tensor  # (B, N+1, ndx, ndx)
    Lxu: torch.Tensor  # (B, N, ndx, nu)
    Luu: torch.Tensor  # (B, N, nu, nu)
    A: torch.Tensor  # (B, N, ndx, ndx)
    B: torch.Tensor  # (B, N, ndx, nu)
    Cx: torch.Tensor  # (B, N, nc, ndx)
    Cu: torch.Tensor  # (B, N, nc, nu)
    Cx_term: torch.Tensor  # (B, nc_term, ndx)
    G0: torch.Tensor  # (B, ndx, ndx)


def _stage_cstr_values(cstrs, x, u):
    if not cstrs:
        return x.new_zeros((0,))
    return torch.cat([f.value(x, u) for f in cstrs], dim=-1)


def _vmap_batch(fn, objs, *args, time: bool = False):
    """Map ``fn(objs, *args)`` over the batch (and over time first when
    ``time``): the port's counterpart of the JAX package's per-stage
    ``jax.vmap`` inside the bench's ``jax.vmap(solve)``. A leaf of ``objs``
    with a batch axis of length 1 is shared by every element; ``args``
    always carry the batch (then time) axes."""
    shared = [a.shape[0] == 1 for a in tree_leaves(objs)]
    leaves = [a[0] if sh else a for a, sh in zip(tree_leaves(objs), shared)]
    n = len(leaves)

    def flat(*xs):
        return fn(tree_unflatten(objs, xs[:n]), *xs[n:])

    if time:
        flat = vmap(flat, in_dims=(0,) * (n + len(args)))
    obj_dims = tuple(None if sh else 0 for sh in shared)
    return vmap(flat, in_dims=obj_dims + (0,) * len(args))(*leaves, *args)


@named_scope("problem.evaluate")
def evaluate(problem: TrajOptProblem, xs: torch.Tensor, us: torch.Tensor) -> ProblemData:
    """Costs, dynamics defects and constraints along (xs (B, N+1, nx),
    us (B, N, nu))."""
    space = problem.space
    N = problem.nsteps

    def stage(objs, x, u, x_next):
        dyn, cost, cstrs = objs
        return (cost.value(space, x, u), dyn.defect(space, x, u, x_next),
                _stage_cstr_values(cstrs, x, u))

    with values_only():
        costs, defects, cstr_vals = _vmap_batch(
            stage, (problem.dynamics, problem.cost, problem.constraints),
            xs[:, :N], us, xs[:, 1:], time=True,
        )

    def terminal(objs, x):
        tcost, tcstrs = objs
        u0 = x.new_zeros(problem.nu)
        return tcost.value(space, x, u0), _stage_cstr_values(tcstrs, x, u0)

    term_c, term_cv = _vmap_batch(
        terminal, (problem.term_cost, problem.term_constraints), xs[:, N],
    )
    init_err = vmap(space.difference)(problem.x0, xs[:, 0])
    return ProblemData(costs=costs, term_cost=term_c, init_err=init_err,
                       dyn_defects=defects, cstr_vals=cstr_vals,
                       term_cstr_vals=term_cv)


@named_scope("problem.derivatives")
def compute_derivatives(problem: TrajOptProblem, xs: torch.Tensor,
                        us: torch.Tensor) -> ProblemDerivs:
    """First/second-order derivative pass (Gauss-Newton cost Hessians)."""
    space = problem.space
    N = problem.nsteps
    ndx, nu = space.ndx, problem.nu

    def cstr_jacs(cstrs, x, u):
        if cstrs:
            return (torch.cat([f.jac_x(space, x, u) for f in cstrs], dim=0),
                    torch.cat([f.jac_u(space, x, u) for f in cstrs], dim=0))
        return x.new_zeros((0, ndx)), x.new_zeros((0, nu))

    def stage(objs, x, u, x_next):
        dyn, cost, cstrs = objs
        with span("problem.derivatives.cost"):
            Lx, Lu, Lxx, Lxu, Luu = cost.derivatives(space, x, u)
        with span("problem.derivatives.dynamics"):
            A, B = dyn.defect_jacobians(space, x, u, x_next)
        with span("problem.derivatives.constraints"):
            Cx, Cu = cstr_jacs(cstrs, x, u)
        return Lx, Lu, Lxx, Lxu, Luu, A, B, Cx, Cu

    Lx, Lu, Lxx, Lxu, Luu, A, B, Cx, Cu = _vmap_batch(
        stage, (problem.dynamics, problem.cost, problem.constraints),
        xs[:, :N], us, xs[:, 1:], time=True,
    )

    def terminal(objs, x):
        tcost, tcstrs = objs
        u0 = x.new_zeros(nu)
        LxN, _, LxxN, _, _ = tcost.derivatives(space, x, u0)
        CxN, _ = cstr_jacs(tcstrs, x, u0)
        return LxN, LxxN, CxN

    LxN, LxxN, CxN = _vmap_batch(
        terminal, (problem.term_cost, problem.term_constraints), xs[:, N],
    )
    G0 = vmap(lambda x, x0: StateErrorResidual(target=x0, space=space).jac_x(
        space, x, x.new_zeros(nu)))(xs[:, 0], problem.x0)
    return ProblemDerivs(
        Lx=torch.cat([Lx, LxN.unsqueeze(1)], dim=1), Lu=Lu,
        Lxx=torch.cat([Lxx, LxxN.unsqueeze(1)], dim=1), Lxu=Lxu, Luu=Luu,
        A=A, B=B, Cx=Cx, Cu=Cu, Cx_term=CxN, G0=G0,
    )


@named_scope("problem.vhp")
def compute_vhp(problem: TrajOptProblem, xs: torch.Tensor, us: torch.Tensor,
                lams: torch.Tensor, vs: torch.Tensor, vs_term: torch.Tensor):
    """Second-order terms of the Lagrangian beyond the Gauss-Newton model:
    per stage, ``torch.func.hessian`` of λ_{t+1}·defect + cost + v·c in
    tangent coordinates, minus the cost's own (Gauss-Newton) Hessian, under
    a vmap over time and batch. Returns (Hxx (B, N+1, ndx, ndx), Hxu (B, N,
    ndx, nu), Huu (B, N, nu, nu)); Hxx[:, 0] also carries the initial
    constraint's term and Hxx[:, N] the terminal cost's and constraints'."""
    space = problem.space
    N, ndx, nu = problem.nsteps, space.ndx, problem.nu

    def stage(objs, x, u, x_next, lam_next, v):
        dyn, cost, cstrs = objs

        def weighted(z):
            xp, up = space.integrate(x, z[:ndx]), u + z[ndx:]
            s = lam_next @ dyn.defect(space, xp, up, x_next) + cost.value(space, xp, up)
            if problem.nc:
                s = s + v @ _stage_cstr_values(cstrs, xp, up)
            return s

        H = hessian(weighted)(x.new_zeros(ndx + nu))
        Lxx, Lxu, Luu = cost.hessians(space, x, u)
        return H[:ndx, :ndx] - Lxx, H[:ndx, ndx:] - Lxu, H[ndx:, ndx:] - Luu

    Hxx, Hxu, Huu = _vmap_batch(
        stage, (problem.dynamics, problem.cost, problem.constraints),
        xs[:, :N], us, xs[:, 1:], lams[:, 1:], vs, time=True,
    )

    def terminal(objs, x, v):
        tcost, tcstrs = objs
        u0 = x.new_zeros(nu)

        def weighted(dx):
            xp = space.integrate(x, dx)
            s = tcost.value(space, xp, u0)
            if problem.nc_term:
                s = s + v @ _stage_cstr_values(tcstrs, xp, u0)
            return s

        return hessian(weighted)(x.new_zeros(ndx)) - tcost.hessians(space, x, u0)[0]

    HxxN = _vmap_batch(terminal, (problem.term_cost, problem.term_constraints),
                       xs[:, N], vs_term)

    def initial(x, x0, lam0):
        return hessian(lambda dx: lam0 @ space.difference(x0, space.integrate(x, dx)))(
            x.new_zeros(ndx))

    Hxx0 = vmap(initial)(xs[:, 0], problem.x0, lams[:, 0])
    Hxx = torch.cat([Hxx[:, :1] + Hxx0.unsqueeze(1), Hxx[:, 1:], HxxN.unsqueeze(1)], dim=1)
    return Hxx, Hxu, Huu


def stage_at(obj, t: int):
    """The stage-``t`` slice of a stacked object inside a function that
    ``_vmap_batch`` maps over the batch alone (leaves (N, ...) there). The
    closed-loop rollouts run their loop over time inside such a function:
    one vmap per rollout, not one per step."""
    return tree_map(lambda a: a[t], obj)


def stage_costs(problem: TrajOptProblem, xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """The trajectory cost alone (no dynamics, no constraints) of each
    element: Σ_t ℓ_t(x_t, u_t) + ℓ_N(x_N) → (B,)."""
    space = problem.space
    N = problem.nsteps
    costs = _vmap_batch(lambda c, x, u: c.value(space, x, u), problem.cost,
                        xs[:, :N], us, time=True)
    term = _vmap_batch(lambda c, x: c.value(space, x, x.new_zeros(problem.nu)),
                       problem.term_cost, xs[:, N])
    return costs.sum(-1) + term


def rollout(problem: TrajOptProblem, x0: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """Open-loop rollout of the dynamics; x0 (B, nx), us (B, N, nu) →
    xs (B, N+1, nx)."""
    space = problem.space

    def roll(dyn, x, us):
        xs = [x]
        for t in range(problem.nsteps):
            xs.append(stage_at(dyn, t).forward(space, xs[-1], us[t]))
        return torch.stack(xs)

    with values_only():
        return _vmap_batch(roll, problem.dynamics, x0, us)


def xs_default_init(problem: TrajOptProblem) -> torch.Tensor:
    """Constant x0 over the horizon: (B, N+1, nx)."""
    x0 = problem.x0
    return x0.unsqueeze(1).expand(x0.shape[0], problem.nsteps + 1, x0.shape[-1]).clone()


def us_default_init(problem: TrajOptProblem) -> torch.Tensor:
    x0 = problem.x0
    return x0.new_zeros((x0.shape[0], problem.nsteps, problem.nu))
