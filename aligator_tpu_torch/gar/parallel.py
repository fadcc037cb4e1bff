"""Parallel proximal Riccati solver by partitioned condensing (port of
``aligator_tpu.gar.parallel``; ``lq_solver="parallel"``).

The horizon is split into J legs. Each leg but the last is parameterized
by its boundary costate θ (Gx = Aᵀ, Gu = Bᵀ, γ = f on its last knot) and
solved by the serial Riccati sweep; a symmetric block-tridiagonal
*condensed* system in the splitting variables [λ0, x_beg₀, θ₀, …,
x_beg_{J−1}] then ties the legs together, and each leg rolls forward from
its solved entry state. The legs of all B problems run as one batch of
B·J through ``gar.riccati.backward_sweep`` / ``forward_sweep``, so a
solve takes about N/J + J dependent steps where the serial sweep takes N.

With a ``distributed.SolverMesh`` the legs are split over the processes
of its "t" axis, as the JAX package splits them over devices with
``shard_map``: rank r of a t group of T runs the sweeps of legs
[r·J/T, (r+1)·J/T) of every problem, the legs' first-knot summaries are
all-gathered and the condensed system solved on every rank, replicated,
and the forward sweep's outputs are all-gathered back, so that every rank
returns what the unsharded solve returns.
"""

from __future__ import annotations

import torch

from aligator_tpu_torch.distributed import all_gather_cat
from aligator_tpu_torch.gar.lqr_problem import LQRProblem
from aligator_tpu_torch.gar.riccati import (
    CostToGo,
    Gains,
    Knot,
    backward_sweep,
    batch_mu,
    forward_sweep,
    knots_of,
)
from aligator_tpu_torch.linalg.block_tridiag import (
    block_tridiag_schur,
    block_tridiag_solve_refined,
)
from aligator_tpu_torch.utils.profiling import named_scope
from aligator_tpu_torch.utils.tree import tree_map


def _pad_problem(problem: LQRProblem, num_legs: int) -> LQRProblem:
    """Append decoupled knots (Q = R = I, everything else zero) so that J
    divides N+1; they solve to x = u = 0. The original terminal knot
    becomes an interior stage, so its unused A, B, f are replaced by zeros
    — selected, not multiplied by a mask, so that whatever those slots
    hold (NaN included) is never read."""
    N1 = problem.horizon + 1
    pad = (-N1) % num_legs
    if pad == 0:
        return problem
    p = problem
    Bsz, nx, nu, nc, nth = p.batch, p.nx, p.nu, p.nc, p.nth
    z = lambda *s: p.Q.new_zeros((Bsz, pad) + s)
    eye = lambda n: torch.eye(n, dtype=p.dtype, device=p.device).expand(Bsz, pad, n, n)
    cat = lambda a, tail: torch.cat([a, tail], dim=1)
    # the terminal slot and the pad knots: zero dynamics
    dyn = lambda a, *s: torch.cat([a[:, : N1 - 1], p.Q.new_zeros((Bsz, pad + 1) + s)],
                                  dim=1)
    return p.replace(
        Q=cat(p.Q, eye(nx)), S=cat(p.S, z(nx, nu)), R=cat(p.R, eye(nu)),
        q=cat(p.q, z(nx)), r=cat(p.r, z(nu)),
        A=dyn(p.A, nx, nx), B=dyn(p.B, nx, nu), f=dyn(p.f, nx),
        C=cat(p.C, z(nc, nx)), D=cat(p.D, z(nc, nu)), d=cat(p.d, z(nc)),
        Gx=cat(p.Gx, z(nx, nth)), Gu=cat(p.Gu, z(nu, nth)),
        Gth=cat(p.Gth, z(nth, nth)), gamma=cat(p.gamma, z(nth)),
        Gv=None if p.Gv is None else cat(p.Gv, z(nc, nth)),
    )


def _theta_augmented_legs(problem: LQRProblem, num_legs: int,
                          owned: slice = slice(None)) -> Knot:
    """Split the (padded) horizon into J legs of L = (N+1)/J knots and put
    the boundary-costate parameterization (θ-width nx) on the last knot
    of each leg but the last → the ``owned`` legs of every problem, knots
    shaped (B·J_owned, L, ...), problem-major."""
    J = num_legs
    N1 = problem.horizon + 1
    assert N1 % J == 0, "call _pad_problem first"
    L = N1 // J
    Bsz, nx = problem.batch, problem.nx
    t = torch.arange(N1, device=problem.device)
    bmask = ((t + 1) % L == 0) & (t != N1 - 1)
    sel = lambda a: torch.where(bmask.reshape((N1,) + (1,) * (a.dim() - 2)), a,
                                torch.zeros((), dtype=a.dtype, device=a.device))
    knots = knots_of(problem)._replace(
        Gx=sel(problem.A.mT), Gu=sel(problem.B.mT), gamma=sel(problem.f),
        Gth=problem.Q.new_zeros((Bsz, N1, nx, nx)),
        Gv=problem.Q.new_zeros((Bsz, N1, problem.nc, nx)),
    )
    return tree_map(
        lambda a: a.reshape((Bsz, J, L) + a.shape[2:])[:, owned].reshape((-1, L) + a.shape[2:]),
        knots)


def _condensed_blocks(problem: LQRProblem, summ, num_legs: int):
    """The condensed symmetric block-tridiagonal system in [λ0, x_beg₀,
    θ₀, x_beg₁, θ₁, …, x_beg_{J−1}], batched over B; ``summ`` holds each
    leg's cost-to-go at its first knot, shaped (B, J, ...). mudyn = 0."""
    J = num_legs
    nx, nc0 = problem.nx, problem.nc0
    eye = torch.eye(nx, dtype=problem.dtype, device=problem.device)
    diag = [problem.Q.new_zeros((problem.batch, nc0, nc0)), summ.Vxx[:, 0]]
    sup = [problem.G0]
    rhs = [-problem.g0, -summ.vx[:, 0]]
    for i in range(J - 1):
        sup.append(summ.Vxt[:, i])
        diag.append(summ.Vtt[:, i])
        rhs.append(-summ.vt[:, i])
        sup.append(-eye.expand(problem.batch, nx, nx))
        diag.append(summ.Vxx[:, i + 1])
        rhs.append(-summ.vx[:, i + 1])
    return diag, sup, rhs


@named_scope("gar.parallel.solve")
def parallel_solve(problem: LQRProblem, mueq, num_legs: int, mesh=None,
                   axis_name: str = "t", refine_steps: int = 1,
                   condensed_refine: int = 2, return_gains: bool = False):
    """Solve by partitioned condensing over ``num_legs`` legs; uneven
    horizons are padded with decoupled knots and the outputs cut back.
    → (xs, us, vs, lbdas) as the serial solver gives them. With
    ``return_gains`` also the stacked per-stage ``Gains`` (B, N+1, ...),
    whose stage-0 feedback is *collapsed*: the boundary-costate feedback
    Kth is folded into K through the condensed system's sensitivity
    ∂θ₀/∂x₀ = −D̃₂⁻¹·Vxt₀ᵀ, an MPC-ready (kff, K) at the deployed stage.
    ``mueq`` is a scalar or (B,).

    With ``mesh`` (a ``distributed.SolverMesh``) the legs are split over
    ``mesh``'s ``axis_name`` group, whose ranks must all pass the same
    problem; ``num_legs`` must be a multiple of the group's size."""
    J = num_legs
    Bsz, nx, nc0 = problem.batch, problem.nx, problem.nc0
    N1 = problem.horizon + 1
    T, rank = (1, 0) if mesh is None else (mesh.shape[axis_name], mesh.coords[axis_name])
    if J % T != 0:
        raise ValueError(f"num_legs={J} is not a multiple of the size {T} of the mesh "
                         f"axis {axis_name!r}")
    Jo = J // T  # legs of each problem that this rank sweeps
    owned = slice(rank * Jo, (rank + 1) * Jo)
    gather = ((lambda pieces: pieces) if mesh is None
              else (lambda pieces: all_gather_cat(pieces, mesh, axis_name)))
    mu = batch_mu(mueq, Bsz, problem.Q).repeat_interleave(Jo)

    padded = _pad_problem(problem, J)
    legs = _theta_augmented_legs(padded, J, owned)
    gains, vms = backward_sweep(legs, mu, refine_steps)
    summ = CostToGo(*gather([a[:, 0].reshape((Bsz, Jo) + a.shape[2:]) for a in vms]))

    diag, sup, rhs = _condensed_blocks(padded, summ, J)
    sol = block_tridiag_solve_refined(diag, sup, rhs, refine_steps=condensed_refine)

    lbd0 = torch.nn.functional.pad(sol[0], (0, nx - nc0))
    x_begs = torch.stack([sol[2 * i + 1] for i in range(J)], dim=1)
    lbd_begs = torch.stack([lbd0] + [sol[2 * i] for i in range(1, J)], dim=1)
    thetas = torch.stack([sol[2 * (i + 1)] for i in range(J - 1)]
                         + [lbd0.new_zeros((Bsz, nx))], dim=1)
    flat = lambda a: a[:, owned].reshape((Bsz * Jo,) + a.shape[2:])
    xs, us, vs, lbds = forward_sweep(gains, vms, flat(x_begs), flat(lbd_begs),
                                     flat(thetas))
    # (B·Jo, L, ...) → (B, Jo·L, ...), gathered to (B, J·L, ...), cut to N+1
    unleg = lambda a: a.reshape((Bsz, Jo * a.shape[1]) + a.shape[2:])
    out = tuple(a[:, :N1] for a in gather([unleg(a) for a in (xs, us, vs, lbds)]))
    if not return_gains:
        return out

    flat_gains = Gains(*(a[:, :N1] for a in gather([unleg(a) for a in gains])))
    if J > 1:
        dtil = block_tridiag_schur(diag, sup)
        # ∂θ₀/∂x₀ from the up-looking elimination
        dth_dx0 = -torch.linalg.solve_ex(dtil[2], summ.Vxt[:, 0].mT,
                                         check_errors=False)[0]
        stage0 = lambda M, Mth: torch.cat(
            [(M[:, 0] + Mth[:, 0] @ dth_dx0).unsqueeze(1), M[:, 1:]], dim=1)
        flat_gains = flat_gains._replace(K=stage0(flat_gains.K, flat_gains.Kth),
                                         Z=stage0(flat_gains.Z, flat_gains.Zth))
    return out, flat_gains


def make_parallel_solver(num_legs: int, mesh=None, axis_name: str = "t",
                         refine_steps: int = 1, condensed_refine: int = 2):
    """``solve(problem, mueq) -> (xs, us, vs, lbdas)`` over ``num_legs``
    legs, split over ``mesh``'s ``axis_name`` group when a mesh is given."""

    def solve(problem: LQRProblem, mueq):
        return parallel_solve(problem, mueq, num_legs, mesh=mesh, axis_name=axis_name,
                              refine_steps=refine_steps,
                              condensed_refine=condensed_refine)

    return solve
