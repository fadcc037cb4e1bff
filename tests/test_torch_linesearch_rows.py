"""The bisection backtracking of ``solvers.linesearch.armijo_run`` (the
trials after the full step of the elements not yet accepted, evaluated as
rows, at most max(B, ``ROWS_PER_CALL``) of them per call) against a loop
that evaluates the whole batch at every trial: the same step, merit and
payload per element, bit for bit, on random merit curves with non-finite
trials, and through ProxDDP on the solo jump (float64 and the fused
float32 path) and the quadrotor (the linear and the nonlinear rollout), a
few iterations each. Also: there are no more calls than the loop makes,
and with the rows per call capped below the pending trials a call holds
at most max(B, cap) rows."""

import numpy as np
import pytest
import torch

import chip_smoke
from aligator_tpu_torch.examples import quadrotor_obstacles as TQ
from aligator_tpu_torch.examples import solo_jump as TJ
from aligator_tpu_torch.solvers import proxddp as P
from aligator_tpu_torch.solvers.linesearch import LinesearchOptions, armijo_run
from aligator_tpu_torch.solvers.proxddp import ProxDDPSettings, solve
from aligator_tpu_torch.utils.tree import tree_where

torch.set_num_threads(1)


def loop_bisection(phi_eval, phi0, dphi0, opts, phi_ref=None, calls=None):
    """The reference: α ← max(β·α, α_min) for every element not yet done,
    the whole batch evaluated at each trial, until each accepts, reaches
    α_min or takes ``max_num_steps`` trials; φ and payload of the last
    finite trial (else the full step's)."""
    if phi_ref is None:
        phi_ref = phi0
    alpha = torch.ones_like(phi0)
    phi, payload = phi_eval(alpha)
    done = torch.isfinite(phi) & (phi - phi_ref <= opts.armijo_c1 * alpha * dphi0)
    for _ in range(opts.max_num_steps):
        if bool(done.all()):
            break
        a_n = torch.clamp(opts.beta_dec * alpha, min=opts.alpha_min)
        phi_n, payload_n = phi_eval(a_n)
        if calls is not None:
            calls.append(phi0.shape[0])
        finite = torch.isfinite(phi_n)
        ok = finite & (phi_n - phi_ref <= opts.armijo_c1 * a_n * dphi0)
        active = ~done
        alpha = torch.where(active, a_n, alpha)
        phi = torch.where(active & finite, phi_n, phi)
        payload = tree_where(active & finite, payload_n, payload)
        done = done | (active & (ok | (a_n <= opts.alpha_min)))
    return alpha, phi, payload


@pytest.mark.parametrize("seed", range(4))
def test_rows_match_the_loop_on_random_merits(seed):
    """φ_b(α) = φ0_b + d_b·α + c_b·α² with c_b large for some elements (many
    halvings), non-finite beyond a per-element α for others, and one
    element whose steps all fail (it ends at α_min)."""
    g = torch.Generator().manual_seed(seed)
    B = 12
    phi0 = torch.randn(B, generator=g, dtype=torch.float64)
    dphi0 = -torch.rand(B, generator=g, dtype=torch.float64) - 0.1
    curv = torch.rand(B, generator=g, dtype=torch.float64) * torch.tensor(
        [1e-3, 1.0, 1e2, 1e5] * 3, dtype=torch.float64)
    curv[-1] = 1e30
    nan_above = torch.where(torch.arange(B) % 3 == 0, torch.rand(B, generator=g).double(),
                            torch.full((B,), 2.0, dtype=torch.float64))
    payload_w = torch.randn(B, 3, generator=g, dtype=torch.float64)

    def phi_at(b, a):
        v = phi0[b] + dphi0[b] * a + curv[b] * a * a
        return torch.where(a > nan_above[b], torch.full_like(v, float("nan")), v)

    def phi_eval(a):
        b = torch.arange(B)
        return phi_at(b, a), (payload_w * a[:, None], a * 2.0)

    def phi_eval_rows(idx, a):
        return phi_at(idx, a), (payload_w[idx] * a[:, None], a * 2.0)

    rows_per_call, loop_calls = [], []

    def counted_rows(idx, a):
        rows_per_call.append(idx.shape[0])
        return phi_eval_rows(idx, a)

    opts = LinesearchOptions(interp_type="bisection")
    ref = loop_bisection(phi_eval, phi0, dphi0, opts, calls=loop_calls)
    got = armijo_run(phi_eval, phi0, dphi0, opts, phi_eval_rows=counted_rows)
    for a, b in zip(torch.utils._pytree.tree_leaves(ref), torch.utils._pytree.tree_leaves(got)):
        torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True)
    assert float(got[0][-1]) == pytest.approx(1e-6, rel=1e-6)  # the failing element
    assert len(rows_per_call) <= len(loop_calls)


@pytest.mark.parametrize("rows", [4, 12])
def test_rows_per_call_are_capped(monkeypatch, rows):
    """With the cap R below the pending elements' trials, each call holds at
    most max(B, R) rows, and the result is the loop's."""
    import aligator_tpu_torch.solvers.linesearch as L

    monkeypatch.setattr(L, "ROWS_PER_CALL", rows)
    B = 6
    phi0 = torch.zeros(B, dtype=torch.float64)
    dphi0 = -torch.ones(B, dtype=torch.float64)
    curv = torch.tensor([1e-3, 1e2, 1e4, 1e6, 1e30, 3.0], dtype=torch.float64)
    phi_at = lambda b, a: phi0[b] + dphi0[b] * a + curv[b] * a * a
    sizes = []

    def phi_eval_rows(idx, a):
        sizes.append(idx.shape[0])
        return phi_at(idx, a), a * 3.0

    opts = LinesearchOptions(interp_type="bisection")
    ref = loop_bisection(lambda a: (phi_at(torch.arange(B), a), a * 3.0), phi0, dphi0, opts)
    got = armijo_run(lambda a: (phi_at(torch.arange(B), a), a * 3.0), phi0, dphi0, opts,
                     phi_eval_rows=phi_eval_rows)
    for a, b in zip(ref, got):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert max(sizes) <= max(B, rows) and len(sizes) > 1


def test_bisection_needs_rows():
    one = torch.ones(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="phi_eval_rows"):
        armijo_run(lambda a: (a, a), one, -one, LinesearchOptions(interp_type="bisection"))


def _both(problem, settings):
    """The solve with the rows (the default) and with the loop; checks
    that some element backtracked through the rows."""
    orig, row_calls = P.armijo_run, []

    def counted(*a, phi_eval_rows=None, **k):
        def rows(idx, alpha):
            row_calls.append(idx.shape[0])
            return phi_eval_rows(idx, alpha)
        return orig(*a, phi_eval_rows=rows, **k)

    P.armijo_run = counted
    try:
        res = solve(problem, settings)
        P.armijo_run = lambda *a, phi_eval_rows=None, **k: loop_bisection(*a, **k)
        ref = solve(problem, settings)
    finally:
        P.armijo_run = orig
    assert row_calls, "no element backtracked"
    return res, ref


@pytest.mark.parametrize("case", ["jump_f64", "jump_f32_fused", "quadrotor",
                                  "quadrotor_nonlinear"])
def test_rows_match_the_loop_in_proxddp(case):
    if case.startswith("quadrotor"):
        q = TQ.create_quadrotor_problem(device="cpu")
        problem = chip_smoke.walk_scenarios(q[0], q[1], 2)
        settings = ProxDDPSettings(tol=1e-3, mu_init=1e-2, max_iters=6,
                                   rollout_type="nonlinear" if case.endswith("nonlinear")
                                   else "linear")
    else:
        dtype = torch.float64 if case == "jump_f64" else torch.float32
        p, m, _ = TJ.create_jump_problem(dtype=dtype, device="cpu")
        problem = chip_smoke.walk_scenarios(p, m, 2)
        settings = ProxDDPSettings(lq_solver="pallas" if case.endswith("fused") else "serial",
                                   **{**TJ.SETTINGS, "max_iters": 4, "record_history": True})
    res, ref = _both(problem, settings)
    assert res.num_iters.tolist() == ref.num_iters.tolist()
    for name in ("xs", "us", "lams", "vs", "history"):
        np.testing.assert_array_equal(getattr(res, name).numpy(), getattr(ref, name).numpy())
