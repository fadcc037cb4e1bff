"""Whether the window's outputs are correct: the sampled rows of the
program's calls against the reference's copy, run once the window has
closed, on the same inputs. The calls compared are drawn from the seed;
what the reference runs for them is the traffic kind's (``traffic/<kind>.py``,
``numbers``).

Each number compared is the worst over the sampled instances: for each
field (xs, us, vs, lams) the largest gap over the reference's largest
magnitude, the cost's gap, the primal infeasibility of the program's
trajectory as the reference evaluates it, and the count of instances whose
iteration count or convergence flag differs from the reference's.
"""

from __future__ import annotations

import math

import torch

from portbench.systems import DTYPES, Reference

FIELDS = ("xs", "us", "vs", "lams")


def _gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """Per instance max|p - r| / max|r|, the worst over the instances."""
    p, r = p.to(torch.float64).flatten(1), r.to(torch.float64).flatten(1)
    num = (p - r).abs().amax(dim=1)
    den = r.abs().amax(dim=1).clamp(min=1e-30)
    worst = (num / den).max()
    return float(worst) if bool(torch.isfinite(worst)) else math.inf


def compare(prog: dict, res, problem, ref) -> dict:
    """Numbers of one batch of sampled instances: ``prog`` holds the
    program's fields, ``res`` is the reference ``ref``'s results on
    ``problem``."""
    out = {f"{f}_gap": _gap(prog[f], getattr(res, f)) for f in FIELDS
           if getattr(res, f)[0].numel()}
    cp, cr = prog["traj_cost"].to(torch.float64), res.traj_cost.to(torch.float64)
    gap = ((cp - cr).abs() / cr.abs().clamp(min=1.0)).max()
    out["cost_gap"] = float(gap) if bool(torch.isfinite(gap)) else math.inf
    # the primal infeasibility of the program's trajectory, as the reference
    # evaluates it: dynamics defects and the initial condition
    xs, us = prog["xs"].to(res.xs.dtype), prog["us"].to(res.us.dtype)
    data = ref.module("problem").evaluate(problem, xs, us)
    prim = torch.maximum(data.dyn_defects.abs().flatten(1).amax(1), data.init_err.abs().amax(1))
    out["prim_infeas"] = float(prim.max()) if bool(torch.isfinite(prim).all()) else math.inf
    out["iters_differ"] = int((prog["num_iters"].cpu() != res.num_iters.cpu()).sum())
    out["conv_differ"] = int((prog["conv"].cpu() != res.conv.cpu()).sum())
    return out


def cat(samples: list) -> dict:
    return {k: torch.cat([s[k] for s in samples]) for k in samples[0]}


def worst(parts: list) -> dict:
    return {k: max(p[k] for p in parts) for k in parts[0]}


def reference_numbers(mix, win, sample_calls: int, dtype: str = "float64") -> dict:
    """The numbers compared for one window, with the reference in ``dtype``:
    ``sample_calls`` of the window's calls, drawn from the seed."""
    ref = Reference(mix.sizes["name"], mix.sizes, mix.device, dtype=DTYPES[dtype])
    calls = list(range(win.first, len(win.samples)))
    pick = torch.randperm(len(calls), generator=mix.host_gen)[:sample_calls].tolist()
    return mix.kind.numbers(mix, ref, win, sorted(calls[i] for i in pick))


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that
    ``limits`` names: each at or under its limit (a number missing or not
    finite is not correct)."""
    shown, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        shown[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, shown
