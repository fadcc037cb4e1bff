"""Step acceptance: backtracking Armijo with safeguarded interpolation, its
nonmonotone (Zhang-Hager) use through ``phi_ref``, and the (merit,
infeasibility) filter (port of ``aligator_tpu.solvers.linesearch``).

Batched: α, φ and every payload leaf carry a leading batch axis. The JAX
``lax.while_loop`` under ``jax.vmap`` runs until every element is done,
freezing each finished element by a select; these loops do exactly that
with ``tree_where``. Bisection, whose trial steps are known in advance,
evaluates several trials of the pending elements per call instead, as
rows (``_backtrack_rows``). A non-finite merit fails the acceptance test
and the backtracking continues. The filter's pair list is a fixed-capacity masked
array per element.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from aligator_tpu_torch.utils.tree import tree_map, tree_where


@dataclasses.dataclass(frozen=True)
class LinesearchOptions:
    armijo_c1: float = 1e-4
    alpha_min: float = 1e-6
    max_num_steps: int = 25
    contraction_min: float = 0.5
    contraction_max: float = 0.8
    interp_type: str = "cubic"  # "bisection" | "quadratic" | "cubic"
    beta_dec: float = 0.5


def _interp_next_alpha(opts, alpha, phi_a, prev_alpha, prev_phi, prev_valid,
                       phi0, dphi0):
    """Safeguarded interpolation step: the minimizer of a quadratic through
    (φ0, φ'0, φ(α)) or a cubic adding the previous sample, clamped to
    [c_min·α, c_max·α]; NaN → c_min·α. All arguments are (B,)."""
    lo = opts.contraction_min * alpha
    hi = opts.contraction_max * alpha
    qa = (phi_a - phi0 - alpha * dphi0) / (alpha * alpha)
    a_quad = -dphi0 / (2.0 * qa)
    quad_eval = lambda a: qa * a * a + dphi0 * a + phi0

    if opts.interp_type == "quadratic":
        use_cubic = torch.zeros_like(prev_valid)
    else:
        use_cubic = prev_valid & ((prev_alpha - alpha).abs() > 1e-14)

    a0, a1 = alpha, prev_alpha
    r0 = phi_a - phi0 - dphi0 * a0
    r1 = prev_phi - phi0 - dphi0 * a1
    det = a0 * a0 * a1 * a1 * (a0 - a1)
    det_safe = torch.where(det.abs() < 1e-30, torch.ones_like(det), det)
    c3 = (r0 * a1 * a1 - r1 * a0 * a0) / det_safe
    c2 = (r1 * a0 * a0 * a0 - r0 * a1 * a1 * a1) / det_safe
    disc = c2 * c2 - 3.0 * c3 * dphi0
    c3_safe = torch.where(c3.abs() < 1e-30, torch.ones_like(c3), c3)
    a_cubic = (-c2 + torch.sqrt(torch.clamp(disc, min=0.0))) / (3.0 * c3_safe)
    cubic_ok = (det.abs() >= 1e-30) & (c3.abs() >= 1e-30) & (disc >= 0.0)
    cubic_eval = lambda a: ((c3 * a + c2) * a + dphi0) * a + phi0

    use_cubic = use_cubic & cubic_ok
    anext = torch.where(use_cubic, a_cubic, a_quad)
    poly_eval = lambda a: torch.where(use_cubic, cubic_eval(a), quad_eval(a))
    outside = (anext > hi) | (anext < lo)
    edge = torch.where(poly_eval(lo) < poly_eval(hi), lo, hi)
    anext = torch.where(outside, edge, anext)
    return torch.where(torch.isfinite(anext), anext, opts.contraction_min * alpha)


def armijo_run(
    phi_eval: Callable[[torch.Tensor], Tuple[torch.Tensor, object]],
    phi0: torch.Tensor,
    dphi0: torch.Tensor,
    opts: LinesearchOptions,
    phi_ref: Optional[torch.Tensor] = None,
    phi_eval_rows: Optional[Callable] = None,
):
    """Backtracking Armijo with safeguarded interpolation over a batch.

    ``phi_eval(alpha (B,)) -> (phi (B,), payload)``; a non-finite φ rejects
    the trial. ``phi_ref`` overrides the acceptance reference (the
    Zhang-Hager average for the nonmonotone variant). Returns
    ``(alpha, phi, payload)`` of the accepted (or last) trial per element.

    Bisection, whose trial steps do not depend on the merit values, needs
    ``phi_eval_rows(idx (M,), alpha (M,)) -> (phi (M,), payload)`` (trial
    steps of chosen elements, one row each) and evaluates several trials
    of the elements not yet accepted per call: see :func:`_backtrack_rows`.
    The interpolating variants evaluate the whole batch at each trial.
    """
    if phi_ref is None:
        phi_ref = phi0
    one = torch.ones_like(phi0)
    phi1, payload1 = phi_eval(one)
    ok1 = torch.isfinite(phi1) & (phi1 - phi_ref <= opts.armijo_c1 * one * dphi0)
    if opts.interp_type == "bisection":
        if phi_eval_rows is None:
            raise ValueError("bisection backtracking needs phi_eval_rows")
        return _backtrack_rows(phi_eval_rows, one, phi1, payload1, ok1, phi_ref, dphi0, opts)
    c = dict(alpha=one, phi=phi1, payload=payload1, prev_alpha=one, prev_phi=phi1,
             prev_valid=torch.zeros_like(ok1), done=ok1,
             cnt=torch.zeros_like(phi0, dtype=torch.int32))
    while True:
        active = (~c["done"]) & (c["cnt"] < opts.max_num_steps)
        if not bool(active.any()):
            break
        alpha_n = _interp_next_alpha(
            opts, c["alpha"], c["phi"], c["prev_alpha"], c["prev_phi"],
            c["prev_valid"], phi0, dphi0,
        )
        alpha_n = torch.clamp(alpha_n, min=opts.alpha_min)
        phi_n, payload_n = phi_eval(alpha_n)
        ok = torch.isfinite(phi_n) & (phi_n - phi_ref <= opts.armijo_c1 * alpha_n * dphi0)
        # a non-finite trial is no interpolation sample: keep the previous one
        finite = torch.isfinite(phi_n)
        new = dict(
            alpha=alpha_n,
            phi=torch.where(finite, phi_n, c["phi"]),
            payload=tree_where(finite, payload_n, c["payload"]),
            prev_alpha=torch.where(finite, c["alpha"], c["prev_alpha"]),
            prev_phi=torch.where(finite, c["phi"], c["prev_phi"]),
            prev_valid=c["prev_valid"] | finite,
            done=ok | (alpha_n <= opts.alpha_min),
            cnt=c["cnt"] + 1,
        )
        c = tree_where(active, new, c)
    return c["alpha"], c["phi"], c["payload"]


def _bisection_steps(opts: LinesearchOptions, like: torch.Tensor) -> torch.Tensor:
    """The trial steps after the full one, as the backtracking loop makes
    them (α ← max(β·α, α_min) until α ≤ α_min or ``max_num_steps``), in
    ``like``'s dtype, on the host."""
    a, steps = torch.ones((), dtype=like.dtype), []
    while len(steps) < opts.max_num_steps:
        a = torch.clamp(opts.beta_dec * a, min=opts.alpha_min)
        steps.append(a)
        if bool(a <= opts.alpha_min):
            break
    return torch.stack(steps) if steps else like.new_zeros((0,)).cpu()


# Rows per call of the bisection backtracking beyond the batch's own: the
# jump's 16 scenarios, all backtracking to α_min (20 trials), take one call.
ROWS_PER_CALL = 512


def _backtrack_rows(phi_eval_rows, one, phi1, payload1, ok1, phi_ref, dphi0, opts):
    """The bisection backtracking of :func:`armijo_run` after its full
    step. An element's trial steps do not depend on its merit values, so
    each call evaluates the next ⌊R / pending⌋ trials (at least one) of
    every element not yet accepted, one row each, R = max(B,
    ``ROWS_PER_CALL``), and the elements that accept leave before the next
    call. A loop over the trials evaluates B rows per call; here a call
    holds at most R rows and advances every pending element by at least
    one trial, so there are no more calls than that loop makes. Each
    element ends at its first accepted trial (or its last), with φ and
    payload of the last finite trial up to it (else the full step's)."""
    steps = _bisection_steps(opts, phi1).to(phi1.device)
    K, R = steps.shape[0], max(phi1.shape[0], ROWS_PER_CALL)
    alpha, phi, payload = one.clone(), phi1, payload1
    pending = torch.nonzero(~ok1).flatten()
    k0 = 0
    while pending.numel() and k0 < K:
        n = pending.shape[0]
        w = min(max(1, R // n), K - k0)
        trial = steps[k0:k0 + w]
        idx, a = pending.repeat_interleave(w), trial.repeat(n)
        phi_r, payload_r = phi_eval_rows(idx, a)
        finite = torch.isfinite(phi_r)
        ok = finite & (phi_r - phi_ref[idx] <= opts.armijo_c1 * a * dphi0[idx])
        finite, ok = finite.reshape(n, w), ok.reshape(n, w)
        k = torch.arange(w, device=phi1.device)
        stop = torch.where(ok, k, w).min(dim=1).values  # w: none accepted here
        upto = stop.clamp(max=w - 1)
        last_finite = torch.where(finite & (k <= upto[:, None]), k, -1).max(dim=1).values
        has = last_finite >= 0
        take = pending[has]
        src = (torch.arange(n, device=phi1.device) * w + last_finite)[has]

        def put(full, part):
            out = full.clone()
            out[take] = part[src]
            return out

        phi, payload = put(phi, phi_r), tree_map(put, payload, payload_r)
        alpha[pending] = trial[upto]
        pending = pending[stop == w]
        k0 += w
    return alpha, phi, payload


# ---------------------------------------------------------------------------
# Filter strategy: a fixed-capacity masked pair list per element
# ---------------------------------------------------------------------------


class FilterState(NamedTuple):
    """(merit, infeasibility) pairs with a validity mask, per element."""

    phis: torch.Tensor  # (B, K)
    hs: torch.Tensor  # (B, K)
    valid: torch.Tensor  # (B, K) bool
    count: torch.Tensor  # (B,) int32, round-robin insertion cursor


def filter_init(capacity: int, batch: int, dtype=torch.float64, device=None) -> FilterState:
    z = torch.zeros((batch, capacity), dtype=dtype, device=device)
    return FilterState(phis=z, hs=z.clone(),
                       valid=torch.zeros((batch, capacity), dtype=torch.bool, device=device),
                       count=torch.zeros(batch, dtype=torch.int32, device=device))


def _filter_acceptable(fs: FilterState, phi, h, beta):
    """The pair (phi, h) (each (B,)) is blocked where some valid element
    dominates it with margin β·h_el → (B,) bool."""
    margin = beta * fs.hs
    blocked = (fs.valid & (fs.phis + margin <= phi.unsqueeze(-1))
               & (fs.hs + margin <= h.unsqueeze(-1)))
    return ~blocked.any(-1)


def _filter_insert(fs: FilterState, phi, h) -> FilterState:
    """Remove the pairs that (phi, h) dominates, then store it in the first
    free slot, or at the cursor ``count % capacity`` when none is free."""
    cap = fs.valid.shape[-1]
    dominated = fs.valid & (phi.unsqueeze(-1) <= fs.phis) & (h.unsqueeze(-1) <= fs.hs)
    valid = fs.valid & ~dominated
    idx = torch.arange(cap, device=valid.device)
    first_free = torch.where(valid, cap, idx).amin(-1)
    slot = torch.where(valid.all(-1), fs.count.long() % cap, first_free)
    at = idx == slot.unsqueeze(-1)
    return FilterState(
        phis=torch.where(at, phi.unsqueeze(-1), fs.phis),
        hs=torch.where(at, h.unsqueeze(-1), fs.hs),
        valid=valid | at,
        count=fs.count + 1,
    )


def filter_run(
    pair_eval: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor, object]],
    fs: FilterState,
    opts: LinesearchOptions,
    beta: float = 0.0,
):
    """Halve α until the trial pair is acceptable to the filter (or α
    reaches ``alpha_min``), then insert the last trial's pair, per element.

    ``pair_eval(alpha (B,)) -> (phi (B,), h (B,), payload)``. Returns
    ``(alpha, phi, payload, new_filter_state)``.
    """
    one = torch.ones_like(fs.phis[:, 0])
    phi1, h1, payload1 = pair_eval(one)
    acceptable = lambda phi, h: (torch.isfinite(phi) & torch.isfinite(h)
                                 & _filter_acceptable(fs, phi, h, beta))
    c = dict(alpha=one, phi=phi1, h=h1, payload=payload1, done=acceptable(phi1, h1),
             cnt=torch.zeros_like(fs.count))
    while True:
        active = (~c["done"]) & (c["cnt"] < opts.max_num_steps)
        if not bool(active.any()):
            break
        alpha_n = torch.clamp(0.5 * c["alpha"], min=opts.alpha_min)
        phi_n, h_n, payload_n = pair_eval(alpha_n)
        new = dict(alpha=alpha_n, phi=phi_n, h=h_n, payload=payload_n,
                   done=acceptable(phi_n, h_n) | (alpha_n <= opts.alpha_min),
                   cnt=c["cnt"] + 1)
        c = tree_where(active, new, c)
    return c["alpha"], c["phi"], c["payload"], _filter_insert(fs, c["phi"], c["h"])
