"""Read one traced window from torch.profiler's raw events, in memory.

The pattern is the repository's ``trace_device``: the kernels come from the
profiler's raw kineto events (building its event tree costs minutes at 10⁵
kernels), the device's busy time is the union of their intervals, and 256
spin kernels go first and are left out, since once a process has taken
large traces the first kernels of a trace are missing from it. Beside that,
the window is marked by a range of its own, each kernel is tied to the host
range it was launched in (by its correlation id), and each idle gap of the
device is named by the innermost host operation running at its midpoint.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import torch

WINDOW = "portbench.window"
SPIN = "spin_kernel"


@dataclass
class Trace:
    window_us: float  # the traced window on the host's clock
    busy_us: float  # union of the device's kernel intervals inside it
    kernels: list  # (name, start_us, end_us, launch range names)
    gaps: list = field(default_factory=list)  # (host op name, idle µs)

    def time_us(self, pred) -> tuple:
        """(device µs, kernel count) of the kernels whose name satisfies pred."""
        sel = [k for k in self.kernels if pred(k[0])]
        return sum(k[2] - k[1] for k in sel), len(sel)

    def in_range(self, name: str) -> list:
        return [k for k in self.kernels if name in k[3]]

    def outside_range(self, name: str) -> list:
        return [k for k in self.kernels if name not in k[3]]


def _union(spans) -> float:
    busy, cur_s, cur_e = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return busy + cur_e - cur_s


def _gaps(spans, w0, w1) -> list:
    """(start, end) of the device's idle intervals inside [w0, w1]."""
    out, cur = [], w0
    for a, b in spans:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        out.append((cur, w1))
    return out


def trace_window(fn, ranges=("proxddp.derivatives", "portbench.sample")) -> Trace:
    """Run ``fn`` once under torch.profiler (host and device) and read it.
    Each kernel carries the names of those ``ranges`` its launch fell in."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(256):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    win = [e for e in host if e.name() == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} window ranges")
    w0, w1 = win[0].start_ns() / 1e3, win[0].end_ns() / 1e3
    main_tid = win[0].start_thread_id()

    spans_by = {r: sorted((e.start_ns() / 1e3, e.end_ns() / 1e3) for e in host
                          if e.is_user_annotation() and e.name() == r) for r in ranges}
    starts_by = {r: [s for s, _ in v] for r, v in spans_by.items()}
    # the host time of each launch, by correlation id (runtime calls carry one)
    launch_at = {}
    for e in host:
        c = e.correlation_id()
        if c and not e.is_user_annotation():
            launch_at.setdefault(c, e.start_ns() / 1e3)

    def within(r, t):
        i = bisect.bisect_right(starts_by[r], t) - 1
        return i >= 0 and spans_by[r][i][1] >= t

    kernels = []
    for e in events:
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or SPIN in e.name()):
            continue
        s, t = e.start_ns() / 1e3, e.end_ns() / 1e3
        if t < w0 or s > w1:
            continue
        at = launch_at.get(e.correlation_id())
        tags = tuple(r for r in ranges if at is not None and within(r, at))
        kernels.append((e.name(), s, t, tags))
    if not kernels:
        return Trace(window_us=w1 - w0, busy_us=0.0, kernels=[])
    spans = sorted((max(k[1], w0), min(k[2], w1)) for k in kernels)
    gaps = _gaps(spans, w0, w1)

    # the innermost host operation of the window's thread at each gap's midpoint
    ops = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name()) for e in host
                 if e.start_thread_id() == main_tid and e.name() != WINDOW
                 and e.end_ns() / 1e3 >= w0 and e.start_ns() / 1e3 <= w1)
    named, stack, i = [], [], 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while i < len(ops) and ops[i][0] <= mid:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        named.append((stack[-1][2] if stack else "host (between operations)", b - a))
    return Trace(window_us=w1 - w0, busy_us=_union(spans), kernels=kernels, gaps=named)


def top(pairs, n: int = 10) -> list:
    """The n largest (name, µs) sums by name, as (name, seconds)."""
    acc = {}
    for name, us in pairs:
        acc[name] = acc.get(name, 0.0) + us
    best = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], us / 1e6] for name, us in best]


def breakdown(tr: Trace) -> dict:
    return {"device_ops": top((k[0], k[2] - k[1]) for k in tr.kernels),
            "idle_gaps": top(tr.gaps)}

