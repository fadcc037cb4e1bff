"""Log-depth Riccati solve by associative scans (port of
``aligator_tpu.gar.assoc``; ``lq_solver="assoc"``), batched over a leading
axis B with time as axis 1.

1. **Penalize and eliminate.** With µ > 0 the constraint row
   ``Cx + Du + d = µv`` is the stationarity condition of the penalty
   ``‖Cx + Du + d‖²/(2µ)``, so each knot folds its constraints into its
   cost and, with u eliminated, becomes a conditional value function
   F_t(x, z) = ½xᵀJx + ηᵀx + ½‖z − A_e x − b_e‖²_{C_e⁺}, the element
   e_t = (A_e, b_e, C_e, η, J).
2. **Suffix scan.** Composition (F₁ ∘ F₂)(x, z) = min_y F₁(x, y) + F₂(y, z)
   is associative (``_combine``); a reverse associative scan gives every
   cost-to-go V_t(x) = ½xᵀJ_t x + η_tᵀx in O(log N) rounds.
3. **Gains and rollout.** Given every V_{t+1}, the stage KKT solves are
   independent and run as one batch over the horizon; the closed-loop
   rollout x_{t+1} = Acl_t x_t + yff_t is a forward associative scan of
   affine maps.

The penalty form loses ~ε/µ of accuracy, so the solution is polished by
``kkt_refine_steps`` rounds of full-KKT refinement; in float32 this makes
the path a tool for µ ≥ 1e-4. µ > 0 is required and θ-blocks are ignored.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from aligator_tpu_torch.gar.lqr_problem import LQRProblem
from aligator_tpu_torch.gar.riccati import (
    CostToGo,
    Knot,
    RiccatiFactors,
    _stage_solve,
    _sym,
    _terminal_solve,
    batch_mu,
    initial_solve,
    knots_of,
    mv,
)
from aligator_tpu_torch.gar.utils import lqr_kkt_residuals
from aligator_tpu_torch.linalg.schur import cholesky
from aligator_tpu_torch.utils.profiling import named_scope
from aligator_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """a₀ b₀ a₁ b₁ … along ``axis``; ``a`` has as many elements as ``b`` or
    one more."""
    nb = b.shape[axis]
    head = torch.stack([a.narrow(axis, 0, nb), b], dim=axis + 1).flatten(axis, axis + 1)
    if a.shape[axis] == nb:
        return head
    return torch.cat([head, a.narrow(axis, nb, 1)], dim=axis)


def associative_scan(fn: Callable, elems, reverse: bool = False, axis: int = 1):
    """Inclusive scan of the associative ``fn`` over ``axis`` of a pytree of
    tensors, in O(log n) rounds of batched ``fn`` calls. The rounds pair
    elements in the odd/even order of ``jax.lax.associative_scan``, so
    rounding follows the JAX package. With ``reverse`` the scan runs from
    the end: ``fn(a, b)`` then gets in ``a`` the composite of later
    elements."""
    leaves = tree_leaves(elems)
    if reverse:
        leaves = [x.flip(axis) for x in leaves]

    def combine(a, b):
        return tree_leaves(fn(tree_unflatten(elems, a), tree_unflatten(elems, b)))

    def sl(x, start, stop=None, step=1):
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(start, stop, step)
        return x[tuple(idx)]

    def scan(xs):
        n = xs[0].shape[axis]
        if n < 2:
            return xs
        odd = scan(combine([sl(x, 0, n - 1, 2) for x in xs], [sl(x, 1, None, 2) for x in xs]))
        left = [sl(o, 0, -1) for o in odd] if n % 2 == 0 else odd
        even = combine(left, [sl(x, 2, None, 2) for x in xs])
        even = [torch.cat([sl(x, 0, 1), e], dim=axis) for x, e in zip(xs, even)]
        return [_interleave(e, o, axis) for e, o in zip(even, odd)]

    out = scan(leaves)
    if reverse:
        out = [x.flip(axis) for x in out]
    return tree_unflatten(elems, out)


class _Element(NamedTuple):
    """Conditional value function F(x, z) (module docstring)."""

    A: torch.Tensor  # (..., nx, nx)
    b: torch.Tensor  # (..., nx)
    C: torch.Tensor  # (..., nx, nx)  PSD, possibly singular
    eta: torch.Tensor  # (..., nx)
    J: torch.Tensor  # (..., nx, nx)  PSD


def _penalized_knot(knot: Knot, mu: torch.Tensor) -> Knot:
    """Fold the µ-regularized constraint rows into the stage cost; ``mu``
    broadcasts against the knots' leading axes."""
    inv = (1.0 / mu).unsqueeze(-1).unsqueeze(-1)
    Ct, Dt = inv * knot.C.mT, inv * knot.D.mT  # scaled first, as in the JAX package
    return knot._replace(
        Q=knot.Q + Ct @ knot.C,
        S=knot.S + Ct @ knot.D,
        R=knot.R + Dt @ knot.D,
        q=knot.q + mv(Ct, knot.d),
        r=knot.r + mv(Dt, knot.d),
    )


def _cho(knot: Knot):
    """R̃⁻¹(·) by Cholesky (NaN where R̃ is not positive definite)."""
    Rc = cholesky(_sym(knot.R))
    return lambda rhs: torch.cholesky_solve(rhs, Rc)


def _stage_element(knot: Knot) -> _Element:
    """Eliminate u from one penalized stage (complete the square)."""
    solve = _cho(knot)
    RiSt = solve(knot.S.mT)
    Rir = solve(knot.r.unsqueeze(-1)).squeeze(-1)
    RiBt = solve(knot.B.mT)
    A_e = knot.A - knot.B @ RiSt
    b_e = knot.f - mv(knot.B, Rir)
    C_e = knot.B @ RiBt
    J_e = knot.Q - knot.S @ RiSt
    eta_e = knot.q - mv(knot.S, Rir)
    return _Element(A=A_e, b=b_e, C=_sym(C_e), eta=eta_e, J=_sym(J_e))


def _terminal_element(knot: Knot) -> _Element:
    """The terminal cost as an element with a vacuous z slot (A = b = C =
    0); the padded terminal control is still minimized over."""
    solve = _cho(knot)
    J_e = knot.Q - knot.S @ solve(knot.S.mT)
    eta_e = knot.q - mv(knot.S, solve(knot.r.unsqueeze(-1)).squeeze(-1))
    return _Element(A=torch.zeros_like(knot.Q), b=torch.zeros_like(knot.q),
                    C=torch.zeros_like(knot.Q), eta=eta_e, J=_sym(J_e))


def _combine(e1: _Element, e2: _Element) -> _Element:
    """(F₁ ∘ F₂)(x, z) = min_y F₁(x, y) + F₂(y, z), e1 earlier in time.
    Only M = I + C₁J₂ is inverted (nonsingular for PSD C₁, J₂), by an LU
    that is not checked; I + J₂C₁ = Mᵀ, solved with the same factors."""
    nx = e1.A.shape[-1]
    M = torch.eye(nx, dtype=e1.A.dtype, device=e1.A.device) + e1.C @ e2.J
    LU, piv, _ = torch.linalg.lu_factor_ex(M, check_errors=False)
    msolve = lambda rhs: torch.linalg.lu_solve(LU, piv, rhs)
    mtsolve = lambda rhs: torch.linalg.lu_solve(LU, piv, rhs, adjoint=True)
    col = lambda v: v.unsqueeze(-1)

    MiA1 = msolve(e1.A)
    Mib = msolve(col(e1.b - mv(e1.C, e2.eta))).squeeze(-1)
    A = e2.A @ MiA1
    b = mv(e2.A, Mib) + e2.b
    C = e2.A @ msolve(e1.C) @ e2.A.mT + e2.C
    eta = mv(e1.A.mT, mtsolve(col(e2.eta + mv(e2.J, e1.b))).squeeze(-1)) + e1.eta
    J = e1.A.mT @ mtsolve(e2.J) @ e1.A + e1.J
    return _Element(A=A, b=b, C=_sym(C), eta=eta, J=_sym(J))


def _combine_rev(a: _Element, b: _Element) -> _Element:
    """The reverse scan's operator: ``a`` is the composite of later
    elements, ``b`` the earlier one, so compose b ∘ a."""
    return _combine(b, a)


def cost_to_go_scan(knots: Knot, mueq) -> CostToGo:
    """Every cost-to-go V_t (t = 0..N), (B, N+1, ...), in O(log N) rounds."""
    Bsz, N1 = knots.Q.shape[:2]
    mu = batch_mu(mueq, Bsz, knots.Q)
    pk = _penalized_knot(knots, mu.unsqueeze(-1))
    elems = _stage_element(tree_map(lambda a: a[:, : N1 - 1], pk))
    term = _terminal_element(tree_map(lambda a: a[:, N1 - 1], pk))
    elems = tree_map(lambda a, t: torch.cat([a, t.unsqueeze(1)], dim=1), elems, term)
    suffix = associative_scan(_combine_rev, elems, reverse=True)
    nth = knots.Gth.shape[-1]
    z = lambda *s: knots.Q.new_zeros((Bsz, N1) + s)
    return CostToGo(Vxx=suffix.J, vx=suffix.eta, Vxt=z(knots.Q.shape[-1], nth),
                    vt=z(nth), Vtt=z(nth, nth))


@named_scope("gar.assoc.backward")
def backward(problem: LQRProblem, mueq, mudyn=0.0, refine_steps: int = 1
             ) -> RiccatiFactors:
    """Suffix-scan cost-to-go, then the serial recursion's stage KKT solves
    for all knots at once, then the initial KKT."""
    knots = knots_of(problem)
    Bsz, N1 = knots.Q.shape[:2]
    mu = batch_mu(mueq, Bsz, knots.Q)
    vms = cost_to_go_scan(knots, mu)
    inner = tree_map(lambda a: a[:, : N1 - 1], knots)
    vn = tree_map(lambda a: a[:, 1:], vms)
    _, gains_s = _stage_solve(inner, vn, mu.unsqueeze(-1), refine_steps)
    _, gains_T = _terminal_solve(tree_map(lambda a: a[:, N1 - 1], knots), mu, refine_steps)
    gains = tree_map(lambda g, gn: torch.cat([g, gn.unsqueeze(1)], dim=1), gains_s, gains_T)
    return initial_solve(problem, vms, mudyn, refine_steps, gains)


def _affine_combine(m1, m2):
    """m2 ∘ m1 for affine maps m = (M, c): x ↦ Mx + c; m1 earlier."""
    M1, c1 = m1
    M2, c2 = m2
    return M2 @ M1, mv(M2, c1) + c2


def forward(problem: LQRProblem, factors: RiccatiFactors,
            theta: Optional[torch.Tensor] = None):
    """The rollout as a forward associative scan of the N transition maps,
    then u, v, λ pointwise. → (xs, us, vs, lbdas), each (B, N+1, ·)."""
    del theta  # the assoc path carries no θ-blocks
    g, vm = factors.gains, factors.vm
    N1 = g.K.shape[1]
    Mp, cp = associative_scan(_affine_combine, (g.Acl[:, : N1 - 1], g.yff[:, : N1 - 1]))
    x0 = factors.x0
    xs = torch.cat([x0.unsqueeze(1), mv(Mp, x0.unsqueeze(1)) + cp], dim=1)
    us = mv(g.K, xs) + g.kff
    vs = mv(g.Z, xs) + g.zff
    lbd0 = torch.nn.functional.pad(factors.lbd0, (0, problem.nx - problem.nc0))
    lbds = torch.cat([lbd0.unsqueeze(1), mv(vm.Vxx[:, 1:], xs[:, 1:]) + vm.vx[:, 1:]],
                     dim=1)
    return xs, us, vs, lbds


def solve(problem: LQRProblem, mueq, mudyn=0.0, theta: Optional[torch.Tensor] = None,
          refine_steps: int = 1, kkt_refine_steps: int = 1):
    """Log-depth backward + forward, then ``kkt_refine_steps`` rounds of
    full-KKT refinement: the KKT residual is itself an LQ problem with the
    same matrices, whose log-depth solve is the correction. Each round
    multiplies the error by ~ε/µ. → (xs, us, vs, lbdas, factors)."""
    factors = backward(problem, mueq, mudyn, refine_steps)
    xs, us, vs, lbds = forward(problem, factors, theta)
    for _ in range(kkt_refine_steps):
        res = lqr_kkt_residuals(problem, xs, us, vs, lbds, mueq=mueq)
        dxs, dus, dvs, dlbds = forward(res, backward(res, mueq, mudyn, refine_steps), theta)
        xs, us, vs, lbds = xs + dxs, us + dus, vs + dvs, lbds + dlbds
    return xs, us, vs, lbds, factors
