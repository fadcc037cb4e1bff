"""MPC runtime: receding-horizon cycling and warm starts over a batch of
controllers (port of ``aligator_tpu.mpc``). With stacked stage leaves a
"cycle" is a ``torch.roll`` over the time axis; an MPC step is shift →
warm-start → solve, batched over the leading axis."""

from __future__ import annotations

from typing import NamedTuple

import torch

from aligator_tpu_torch.problem import TrajOptProblem, us_default_init, xs_default_init
from aligator_tpu_torch.solvers import proxddp
from aligator_tpu_torch.solvers.proxddp import ProxDDPSettings
from aligator_tpu_torch.utils.profiling import named_scope
from aligator_tpu_torch.utils.tree import tree_map


def _set_last(a: torch.Tensor, new: torch.Tensor, axis: int) -> torch.Tensor:
    """Copy of ``a`` with index -1 along the time ``axis`` replaced."""
    out = a.clone()
    out.select(axis, -1).copy_(new)
    return out


@named_scope("mpc.cycle")
def cycle_problem(problem: TrajOptProblem, new_stage=None,
                  new_constraints=None) -> TrajOptProblem:
    """Shift the horizon one stage left; the vacated last slot takes
    ``new_stage`` = (dynamics, cost) objects with a batch axis and no time
    axis (default: the old first stage, the circular behaviour)."""
    ax = 1  # stage leaves are (1 or B, N, ...)
    roll = lambda obj: tree_map(lambda a: torch.roll(a, -1, dims=ax), obj)
    dyn = roll(problem.dynamics)
    cost = roll(problem.cost)
    cstrs = tuple(roll(c) for c in problem.constraints)
    put = lambda obj, new: tree_map(lambda a, n: _set_last(a, n, ax), obj, new)
    if new_stage is not None:
        dyn = put(dyn, new_stage[0])
        cost = put(cost, new_stage[1])
    if new_constraints is not None:
        cstrs = tuple(put(c, n) for c, n in zip(cstrs, new_constraints))
    return problem.replace(dynamics=dyn, cost=cost, constraints=cstrs)


class MPCState(NamedTuple):
    """Warm-start carry between MPC steps, batched."""

    xs: torch.Tensor  # (B, N+1, nx)
    us: torch.Tensor  # (B, N, nu)
    vs: torch.Tensor  # (B, N, nc)
    lams: torch.Tensor  # (B, N+1, ndx)


@named_scope("mpc.shift")
def shift_warm_start(state: MPCState) -> MPCState:
    """Rotate the previous solution one stage left, duplicating the tail."""
    return MPCState(*(
        torch.cat([a[:, 1:], a[:, -1:]], dim=1) for a in state
    ))


@named_scope("mpc.step")
def mpc_step(problem: TrajOptProblem, settings: ProxDDPSettings,
             x_measured: torch.Tensor, state: MPCState, cycle: bool = True):
    """One receding-horizon step for a batch of controllers: (optionally)
    cycle the problem, pin the measured states (B, nx), warm-start from the
    shifted previous solution, solve. Returns (u_apply (B, nu), new_state,
    results, problem)."""
    if cycle:
        problem = cycle_problem(problem)
        state = shift_warm_start(state)
    problem = problem.replace(x0=x_measured)
    res = proxddp.solve(problem, settings, xs_init=state.xs, us_init=state.us,
                        vs_init=state.vs, lams_init=state.lams)
    new_state = MPCState(xs=res.xs, us=res.us, vs=res.vs, lams=res.lams)
    return res.us[:, 0], new_state, res, problem


def init_mpc_state(problem: TrajOptProblem) -> MPCState:
    xs = xs_default_init(problem)
    B = xs.shape[0]
    return MPCState(
        xs=xs,
        us=us_default_init(problem),
        vs=xs.new_zeros((B, problem.nsteps, problem.nc)),
        lams=xs.new_zeros((B, problem.nsteps + 1, problem.ndx)),
    )
