"""The ``solve`` kind: back-to-back batched ``proxddp.solve`` calls, each
on a new draw of the batch's initial states from the seed's stream.

Its traffic file gives ``batch``, ``disturbance``, ``warmup_calls`` (their
samples are dropped), ``sample_rows``, ``sample_calls`` and ``trace_calls``.
The reference solves the sampled instances of the sampled calls from their
own initial states, in one batch."""

from __future__ import annotations

from portbench.check import FIELDS, cat, compare


def setup(mix):
    for _ in range(mix.traffic["warmup_calls"]):
        mix.call()
    mix.out.samples.clear()
    mix.out.iters.clear()


def before(mix, rows) -> dict:
    return {}


def step(mix, z):
    solver = mix.sys.module("solvers.proxddp")
    return solver.solve(mix.problem.replace_x0(mix.base + z), mix.settings)


def after(mix, res, rows) -> dict:
    return {**{f: getattr(res, f)[rows] for f in FIELDS}, "num_iters": res.num_iters[rows],
            "conv": res.conv[rows], "traj_cost": res.traj_cost[rows]}


def solved(mix, res) -> int:
    """Every instance, or those converged where the configuration counts them."""
    return int(res.conv.sum()) if mix.sizes["counts_converged"] else mix.batch


def numbers(mix, ref, win, chosen: list) -> dict:
    prog = cat([win.samples[k] for k in chosen])
    problem = ref.problem(mix.inputs, prog["noise"].shape[0])
    problem = problem.replace_x0(problem.x0 + prog["noise"].to(ref.dtype))
    res = ref.module("solvers.proxddp").solve(problem, ref.settings(mix.settings_dict))
    return compare(prog, res, problem, ref)
