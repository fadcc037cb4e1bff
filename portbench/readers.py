"""The arithmetic of the metrics' readers (each metric's file under
``metrics/`` names one of these). A reader returns None where its run has
nothing to read; the harness then leaves the metric out of the line."""

from __future__ import annotations

import torch

from portbench.roofline import backward_cost, bound_ms, forward_cost
from portbench.window import SAMPLE

K1, K2 = "riccati_backward", "riccati_forward"


def calls(rec) -> int:
    return len(rec.window.latencies)


def setup_s(rec):
    """Seconds from the process's start to the window's."""
    return rec.setup_s


def solves_per_s(rec):
    """Instances solved in the window over the window's time."""
    return rec.window.solved / rec.window.window_s


def step_ms(rec):
    """The window's time over the steps it completed."""
    return rec.window.window_s / calls(rec) * 1e3


def idle_share(rec):
    """% of the traced window in which no kernel ran on the device."""
    tr = rec.trace
    if tr is None or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)


def k1_roofline(rec):
    """% of K1's bound (from its shapes) over K1's device time a launch."""
    tr = rec.trace
    us, n = tr.time_us(lambda s: K1 in s) if tr is not None else (0.0, 0)
    if n == 0:
        return None
    q = rec.lq
    bound, _ = bound_ms(*backward_cost(q["B"], q["L"], q["nx"], q["nu"], q["nc"], q["refine"]))
    return 100.0 * bound / (us / n / 1e3)


def k2_roofline(rec):
    """% of K2's bound over K2's device time a sweep (the sweeps counted by
    the port's wrapper: the nx = 56 pair launches two kernels a sweep)."""
    tr = rec.trace
    sweeps = rec.window.counters.get("k2_sweeps", 0)
    us, n = tr.time_us(lambda s: K2 in s) if tr is not None else (0.0, 0)
    if n == 0 or sweeps == 0:
        return None
    q = rec.lq
    bound, _ = bound_ms(*forward_cost(q["B"], q["L"], q["nx"], q["nu"], q["nc"]))
    return 100.0 * bound / (us / sweeps / 1e3)


def derivs_device_ms(rec):
    """Device ms a call of the kernels launched inside the solver's
    ``proxddp.derivatives`` range (the problem's derivative pass)."""
    tr = rec.trace
    if tr is None:
        return None
    ks = tr.in_range("proxddp.derivatives")
    if not ks:
        return None
    return sum(k[2] - k[1] for k in ks) / calls(rec) / 1e3


def kernels_per_call(rec):
    """Device operations a call, the benchmark's own sampling left out."""
    tr = rec.trace
    if tr is None or not tr.kernels:
        return None
    return len(tr.outside_range(SAMPLE)) / calls(rec)


def iters_per_solve(rec):
    """The mean iteration count over every instance of the window."""
    if not rec.window.iters:
        return None
    return float(torch.cat(rec.window.iters).double().mean())
