"""The ``mpc`` kind: a closed loop of batched ``mpc_step`` calls (cycle,
shift, warm start, solve), each on a new draw of the measured states.

Its traffic file gives ``batch``, ``disturbance``, ``settle_steps`` (made in
set-up; the first of them is compared too), ``sample_rows``,
``sample_calls`` and ``trace_calls``. A sampled step keeps, at its rows,
the state it was given and the state it carried on. The reference makes the
first step from its own initial state, and each sampled step k on its own
problem cycled k times from the program's state given to that step,
shifting it itself: the warm start carried between steps is checked there,
and the start by the first step."""

from __future__ import annotations

from portbench.check import FIELDS, compare, worst


def setup(mix):
    mix.state = mix.sys.module("mpc").init_mpc_state(mix.problem)
    for _ in range(mix.traffic["settle_steps"]):
        mix.call()


def before(mix, rows) -> dict:
    return {f"in_{f}": getattr(mix.state, f)[rows] for f in FIELDS}


def step(mix, z):
    _, mix.state, res, mix.problem = mix.sys.module("mpc").mpc_step(
        mix.problem, mix.settings, mix.base + z, mix.state)
    return res


def after(mix, res, rows) -> dict:
    """The state carried to the next step, and the step's flags."""
    return {**{f: getattr(mix.state, f)[rows] for f in FIELDS},
            "num_iters": res.num_iters[rows], "conv": res.conv[rows],
            "traj_cost": res.traj_cost[rows]}


def solved(mix, res) -> int:
    return mix.batch


def numbers(mix, ref, win, chosen: list) -> dict:
    mpc = ref.module("mpc")
    settings = ref.settings(mix.settings_dict)
    base = ref.problem(mix.inputs, win.samples[0]["rows"].numel())
    parts, done, cur = [], 0, base
    for k in [0] + [k for k in chosen if k > 0]:
        s = win.samples[k]
        for _ in range(k - done):
            cur = mpc.cycle_problem(cur)
        done = k
        x = base.x0 + s["noise"].to(ref.dtype)
        state = (mpc.init_mpc_state(cur) if k == 0 else
                 mpc.MPCState(**{f: s[f"in_{f}"].to(ref.dtype) for f in FIELDS}))
        _, _, res, stepped = mpc.mpc_step(cur, settings, x, state)
        parts.append(compare(s, res, stepped, ref))
    return worst(parts)
