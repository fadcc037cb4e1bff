"""The port's own spans over a traced window: the readers of the metrics
that the program's span log (``aligator_tpu_torch.utils.profiling``)
feeds, and a breakdown of one traced window by span:

    python3 -m portbench.spans --workload <cell> --seed <n>

on a machine with the card. The log stamps each span with
``time.time_ns()``, the clock of torch.profiler's events, so a span lines
up with the kernels of the same trace. The window is placed from the trace
(the last kernel's end, back by the window's length); a span belongs to it
where it starts inside. Every reader returns None where the log has nothing
for the window (a program without the log, the control's copy), and where
the log's root spans (one ``proxddp.solve`` or ``mpc.step`` a call) do not
number the window's calls.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from portbench.trace import _gaps

SYNC = "proxddp.sync"
OUTSIDE = "(outside the port's spans)"


def _program_log() -> list:
    try:
        from aligator_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without the span log
        return []
    return spans()


@dataclass
class Log:
    """The records of one window on the window's thread; times in µs."""

    spans: list  # the profiling.Span records
    calls: int
    gaps: list  # (start, end) of the device's idle intervals
    w0: float
    w1: float

    def named(self, *names) -> list:
        return [r for r in self.spans if r.name in names]

    def ms_per_call(self, *names) -> float:
        """Host ms a call inside the spans ``names`` (summed: none nests in another)."""
        return sum(r.end_ns - r.start_ns for r in self.named(*names)) / self.calls / 1e6


def _us(r) -> tuple:
    return r.start_ns / 1e3, r.end_ns / 1e3


def window_log(rec, records=None):
    """The log over ``rec``'s traced window, or None (see the module's
    docstring). ``records`` stand in for the program's log in tests."""
    tr = rec.trace
    if tr is None or not tr.kernels:
        return None
    records = _program_log() if records is None else records
    w1 = max(k[2] for k in tr.kernels)
    w0 = w1 - tr.window_us
    inside = [r for r in records if r.end_ns is not None and w0 <= r.start_ns / 1e3 <= w1]
    roots = [r for r in inside if r.parent is None]
    calls = len(rec.window.latencies)
    if not roots or len(roots) != calls or len({r.thread for r in roots}) != 1:
        return None
    kernels = sorted((max(k[1], w0), min(k[2], w1)) for k in tr.kernels)
    return Log(spans=[r for r in inside if r.thread == roots[0].thread], calls=calls,
               gaps=_gaps(kernels, w0, w1), w0=w0, w1=w1)


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> float:
    """Total length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms(log: Log, name: str) -> float:
    """Device idle ms a call while the host is inside a ``name`` span."""
    return _overlap(log.gaps, _union(_us(r) for r in log.named(name))) / log.calls / 1e3


def innermost(log: Log) -> list:
    """(start, end, name) pieces covering the window, each named by the
    innermost span open over it (``OUTSIDE`` where none is)."""
    out, stack, t = [], [], log.w0

    def upto(x):
        nonlocal t
        while stack and _us(stack[-1])[1] <= x:
            top = stack.pop()
            out.append((t, _us(top)[1], top.name))
            t = max(t, _us(top)[1])
        out.append((t, x, stack[-1].name if stack else OUTSIDE))
        t = max(t, x)

    for r in sorted(log.spans, key=lambda r: (r.start_ns, -r.end_ns)):
        upto(_us(r)[0])
        stack.append(r)
    upto(log.w1)
    return [p for p in out if p[1] > p[0]]


def idle_by_span(log: Log) -> dict:
    """Device idle ms a call, by the innermost span open over it."""
    ends = [b for _, b in log.gaps]
    acc = {}
    for a, b, name in innermost(log):
        i, us = bisect.bisect_right(ends, a), 0.0
        while i < len(log.gaps) and log.gaps[i][0] < b:
            us += min(b, log.gaps[i][1]) - max(a, log.gaps[i][0])
            i += 1
        if us > 0:
            acc[name] = acc.get(name, 0.0) + us / log.calls / 1e3
    return dict(sorted(acc.items(), key=lambda kv: -kv[1]))


def _read(fn):
    def read(rec):
        log = window_log(rec)
        return None if log is None else fn(log)

    return read


host_syncs = _read(lambda log: sum(r.attrs["n"] for r in log.named(SYNC)) / log.calls)
sync_wait_ms = _read(lambda log: log.ms_per_call(SYNC))
derivs_idle_ms = _read(lambda log: idle_ms(log, "problem.derivatives"))
initial_solve_ms = _read(lambda log: log.ms_per_call("gar.initial_solve"))
cycle_ms = _read(lambda log: log.ms_per_call("mpc.cycle", "mpc.shift"))


def breakdown(log: Log) -> dict:
    """Host ms a call in each span name, self ms a call (less its children),
    and device idle ms a call by innermost span."""
    total, child = {}, {}
    names = {r.index: r.name for r in log.spans}
    for r in log.spans:
        total[r.name] = total.get(r.name, 0) + r.end_ns - r.start_ns
        if r.parent in names:
            child[names[r.parent]] = child.get(names[r.parent], 0) + r.end_ns - r.start_ns
    per = lambda ns: ns / log.calls / 1e6
    return {"calls": log.calls,
            "host_ms": {k: per(v) for k, v in sorted(total.items(), key=lambda kv: -kv[1])},
            "self_ms": {k: per(v - child.get(k, 0)) for k, v in total.items()},
            "idle_ms_by_innermost": idle_by_span(log),
            "idle_ms": sum(b - a for a, b in log.gaps) / log.calls / 1e3}


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from portbench.core import cell, data, manifest
    from portbench.run import Record, lq_shape, prepare_process
    from portbench.systems import Program
    from portbench.window import Mix

    ap = argparse.ArgumentParser(description="One traced window of a cell, by the port's spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    prepare_process()
    if not torch.cuda.is_available():
        print("spans: no CUDA card")
        return 3
    w = cell(manifest(), args.workload)
    sizes, dev = data("configs", w["config"]), torch.device("cuda", 0)
    mix = Mix(Program(w["config"], sizes, dev), sizes, data("traffic", w["traffic"]),
              args.seed, dev)
    mix.setup()
    win = mix.run(0.0, True)
    log = window_log(Record(setup_s=0.0, window=win,
                            lq=lq_shape(mix.problem, mix.settings_dict, mix.batch)))
    if log is None:
        print("spans: the log does not cover the window")
        return 1
    print(json.dumps({"cell": args.workload, "seed": args.seed, **breakdown(log)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
