"""The port's tracing (``aligator_tpu_torch.utils.profiling``) on the CPU:
the span log stays empty and enters no profiler range without a profiler,
fills under one with parents, call ids and stamps on the profiler's own
clock, changes no result, and counts each host sync of the solver's loops;
and ``portbench/spans.py`` reads such a log over a traced window."""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aligator_tpu_torch.convert import problem_from_numpy
from aligator_tpu_torch.mpc import init_mpc_state, mpc_step
from aligator_tpu_torch.solvers import ProxDDPSettings
from aligator_tpu_torch.solvers.proxddp import solve
from aligator_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

NX = NU = 3
N = 8


def _problem(batch=3):
    rng = np.random.default_rng(5)
    return problem_from_numpy(
        np.eye(NX) * 1.02, rng.standard_normal((NX, NU)), 0.01 * rng.standard_normal(NX),
        0.1 * np.eye(NX), 0.01 * np.eye(NU), np.eye(NX), rng.standard_normal((batch, NX)),
        N, np.full(NU, -0.18), np.full(NU, 0.18), device="cpu", dtype=torch.float64)


SETTINGS = ProxDDPSettings(lq_solver="pallas", max_iters=6, max_al_iters=3)


def _traced(fn):
    P.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, P.spans(), prof


def test_log_stays_empty_without_a_profiler_and_fills_under_one(monkeypatch):
    P.reset()
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: entered.append(name) or real(name, *a))
    solve(_problem(), SETTINGS)
    assert P.spans() == [] and entered == []  # no range entered, nothing logged
    assert P.counters()["proxddp.host_sync.outer_loop"] >= 2  # counters stay on
    _, log, _ = _traced(lambda: solve(_problem(), SETTINGS))
    names = {r.name for r in log}
    assert {"proxddp.solve", "proxddp.derivatives", "problem.derivatives.cost",
            "problem.derivatives.dynamics", "problem.derivatives.constraints",
            "gar.initial_solve", "proxddp.linesearch", "proxddp.al_update",
            P.SYNC} <= names
    assert entered.count("proxddp.solve") == 1 and all(r.end_ns >= r.start_ns for r in log)


def test_parents_call_ids_and_self_time_in_an_mpc_step():
    problem = _problem()
    (_, _, res, _), log, _ = _traced(
        lambda: mpc_step(problem, SETTINGS, problem.x0, init_mpc_state(problem)))
    root = log[0]
    assert root.name == "mpc.step" and root.parent is None and root.index == 0
    assert [r for r in log if r.parent is None] == [root]
    assert {r.call for r in log} == {0}
    by = {r.index: r for r in log}
    for name in ("mpc.cycle", "mpc.shift", "proxddp.solve"):
        (r,) = [r for r in log if r.name == name]
        assert r.parent == 0
    for r in log[1:]:  # each inside its parent
        p = by[r.parent]
        assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    solve_rec = next(r for r in log if r.name == "proxddp.solve")
    assert all(by[r.parent].name == "proxddp.solve" for r in log
               if r.name in ("proxddp.derivatives", "proxddp.al_update"))
    # self time: the duration less its children's
    from portbench.spans import Log, breakdown

    kids = sum(r.end_ns - r.start_ns for r in log if r.parent == solve_rec.index)
    b = breakdown(Log(spans=log, calls=1, gaps=[], w0=root.start_ns / 1e3,
                      w1=root.end_ns / 1e3))
    assert b["self_ms"]["proxddp.solve"] == pytest.approx(
        (solve_rec.end_ns - solve_rec.start_ns - kids) / 1e6, abs=1e-9)
    assert all(v >= 0 for v in b["self_ms"].values())


def test_stamps_lie_on_the_profilers_clock():
    """Each span's stamps against its own torch.profiler range, over 120
    spans after a warm-up span."""

    def spans():
        with P.span("tracing.warmup"):
            pass
        for _ in range(120):
            with P.span("tracing.probe"):
                torch.ones(4).add_(1.0)

    _, log, prof = _traced(spans)
    mine = [r for r in log if r.name == "tracing.probe"]
    ranges = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "tracing.probe" and e.is_user_annotation()),
                    key=lambda e: e.start_ns())
    assert len(mine) == len(ranges) == 120
    d = np.array([abs(e.start_ns() - r.start_ns) for r, e in zip(mine, ranges)]
                 + [abs(r.end_ns - e.end_ns()) for r, e in zip(mine, ranges)]) / 1e3
    assert np.median(d) <= 20.0 and np.percentile(d, 95) <= 100.0, (np.median(d), d.max())


def test_results_are_bitwise_equal_with_the_profiler_on_and_off():
    problem = _problem()
    fields = ("xs", "us", "lams", "num_iters")
    off = solve(problem, SETTINGS)
    on, _, _ = _traced(lambda: solve(problem, SETTINGS))
    assert all(torch.equal(getattr(off, f), getattr(on, f)) for f in fields)
    state = init_mpc_state(problem)
    step = lambda: mpc_step(problem, SETTINGS, problem.x0 + 0.01, state)
    (_, s_off, r_off, _), ((_, s_on, r_on, _), _, _) = step(), _traced(step)
    assert all(torch.equal(getattr(r_off, f), getattr(r_on, f)) for f in fields)
    assert all(torch.equal(a, b) for a, b in zip(s_off, s_on))


@pytest.mark.parametrize("sa_strategy", ["nonmonotone", "armijo", "filter"])
def test_sync_count_equals_the_loops_checks(sa_strategy):
    """Each loop of the solver reads its flag once a turn and once to leave:
    the outer loop once more than its AL updates, the inner loop once a
    Newton iteration and once an AL turn, the Newton step once an
    iteration; every count has its sync span."""
    s = ProxDDPSettings(lq_solver="pallas", max_iters=6, max_al_iters=3,
                        sa_strategy=sa_strategy)
    _, log, _ = _traced(lambda: solve(_problem(), s))
    c = P.counters()
    n = lambda name: sum(r.name == name for r in log)
    site = lambda k: c.get(P.SYNC_COUNTER + k, 0)
    assert site("outer_loop") == n("proxddp.al_update") + 1
    assert site("inner_loop") == n("proxddp.derivatives") + n("proxddp.al_update")
    assert site("newton_step") == n("proxddp.derivatives")
    assert site("al_tolerance") >= n("proxddp.al_update")
    ls = n("proxddp.linesearch")
    assert ls > 0
    if sa_strategy == "nonmonotone":  # bisection rows: the steps' copy, then the rows
        assert site("ls_steps") == ls and site("ls_rows") >= ls
    else:
        assert site("armijo" if sa_strategy == "armijo" else "filter") >= ls
    syncs = [r for r in log if r.name == P.SYNC]
    assert sum(r.attrs["n"] for r in syncs) == sum(
        v for k, v in c.items() if k.startswith(P.SYNC_COUNTER))
    for r in syncs:
        assert c[P.SYNC_COUNTER + r.attrs["site"]] > 0


# --- portbench/spans.py on a synthetic traced window -------------------------

def _rec(name, start_us, end_us, parent, index, thread=1, **attrs):
    return P.Span(name, int(start_us * 1e3), int(end_us * 1e3), parent,
                  index if parent is None else parent, thread, attrs, index)


def _record(kernels, window_us, calls):
    trace = types.SimpleNamespace(kernels=[("k", a, b, ()) for a, b in kernels],
                                  window_us=window_us)
    return types.SimpleNamespace(trace=trace,
                                 window=types.SimpleNamespace(latencies=[0.1] * calls))


def test_portbench_spans_read_a_synthetic_window(monkeypatch):
    from portbench import spans as S

    # window [1000, 2000] µs: kernels busy 1100-1200, 1500-1600, 1900-2000
    rec = _record([(1100, 1200), (1500, 1600), (1900, 2000)], 1000.0, 2)
    log = [
        _rec("proxddp.solve", 500, 900, None, 0),  # before the window: left out
        _rec("proxddp.solve", 1050, 1450, None, 1),
        _rec("problem.derivatives", 1150, 1300, 1, 2),  # idle 1200-1300
        _rec(S.SYNC, 1400, 1420, 1, 3, site="outer_loop", n=1),
        _rec("gar.initial_solve", 1420, 1440, 1, 4),
        _rec("proxddp.solve", 1460, 1850, None, 5),
        _rec("problem.derivatives", 1550, 1700, 5, 6),  # idle 1600-1700
        _rec(S.SYNC, 1800, 1810, 5, 7, site="ls_rows", n=2),
    ]
    w = S.window_log(rec, log)
    assert (w.w0, w.w1, w.calls) == (1000.0, 2000.0, 2)
    assert [r.index for r in w.spans] == [1, 2, 3, 4, 5, 6, 7]
    assert w.gaps == [(1000.0, 1100.0), (1200.0, 1500.0), (1600.0, 1900.0)]
    monkeypatch.setattr(S, "_program_log", lambda: log)
    assert S.host_syncs(rec) == 1.5
    assert S.sync_wait_ms(rec) == pytest.approx(0.015)
    assert S.initial_solve_ms(rec) == pytest.approx(0.01)
    assert S.derivs_idle_ms(rec) == pytest.approx(0.1)  # 200 µs of idle over 2 calls
    assert S.cycle_ms(rec) == 0.0
    # idle a call by the innermost span: 700 µs of gaps over 2 calls
    want = {"proxddp.solve": 0.17, "problem.derivatives": 0.1, S.OUTSIDE: 0.055,
            S.SYNC: 0.015, "gar.initial_solve": 0.01}
    assert S.idle_by_span(w) == pytest.approx(want)
    b = S.breakdown(w)
    assert b["host_ms"]["proxddp.solve"] == pytest.approx(0.395)
    assert b["self_ms"]["proxddp.solve"] == pytest.approx(0.22)
    assert b["idle_ms"] == pytest.approx(0.35)
    # no reading: a root too many, a call too many, or no log (a program without one)
    assert S.window_log(rec, log + [_rec("mpc.step", 1860, 1890, None, 8)]) is None
    assert S.window_log(_record([(1100, 1200)], 1000.0, 3), log) is None
    monkeypatch.setattr(S, "_program_log", lambda: [])
    assert S.host_syncs(rec) is None and S.derivs_idle_ms(rec) is None
