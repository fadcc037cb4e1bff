"""The reference's frozen copy against the port at a tiny size on the CPU,
in float64: the same solves and MPC steps give the same iterates. Only this
test imports both."""

import pytest
import torch

from portbench.core import data, load
from portbench.systems import Program, Reference
from portbench.window import Mix

CPU = torch.device("cpu")
TINY = {"lqr56": {"nsteps": 12}, "talos_walk": {"T_ss": 2, "T_ds": 2, "nsteps": 10}}
FIELDS = ("xs", "us", "vs", "lams", "num_iters", "conv")


def _sizes(config):
    return {**data("configs", config), **TINY[config], "dtype": "float64"}


def _same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype == torch.bool or not x.is_floating_point():
            assert torch.equal(x, y), f
        else:
            torch.testing.assert_close(x, y, rtol=1e-9, atol=1e-10, msg=f)


@pytest.mark.parametrize("config", ["lqr56", "talos_walk"])
def test_solve_matches_the_port(config):
    sizes = _sizes(config)
    traffic = {"kind": "solve", "batch": 3, "disturbance": 0.05, "sample_rows": 3,
               "warmup_calls": 0}
    prog, ref = Program(config, sizes, CPU), Reference(config, sizes, CPU)
    mp, mr = Mix(prog, sizes, traffic, 7, CPU), Mix(ref, sizes, traffic, 7, CPU)
    mp.setup()
    mr.setup()
    torch.testing.assert_close(mp.base, mr.base, rtol=0, atol=0)
    z = load("configs", config).noise(sizes, mp.gen, 3, 0.05, CPU).double()
    _same(prog.module("solvers.proxddp").solve(mp.problem.replace_x0(mp.base + z), mp.settings),
          ref.module("solvers.proxddp").solve(mr.problem.replace_x0(mr.base + z), mr.settings))


@pytest.mark.parametrize("config", ["lqr56", "talos_walk"])
def test_mpc_steps_match_the_port(config):
    sizes = _sizes(config)
    traffic = {"kind": "mpc", "batch": 2, "disturbance": 0.05, "sample_rows": 2,
               "settle_steps": 0}
    prog, ref = Program(config, sizes, CPU), Reference(config, sizes, CPU)
    mp, mr = Mix(prog, sizes, traffic, 8, CPU), Mix(ref, sizes, traffic, 8, CPU)
    mp.setup()
    mr.setup()
    for _ in range(3):
        z = load("configs", config).noise(sizes, mp.gen, 2, 0.05, CPU).double()
        up, mp.state, rp, mp.problem = prog.module("mpc").mpc_step(
            mp.problem, mp.settings, mp.base + z, mp.state)
        ur, mr.state, rr, mr.problem = ref.module("mpc").mpc_step(
            mr.problem, mr.settings, mr.base + z, mr.state)
        torch.testing.assert_close(up, ur, rtol=1e-9, atol=1e-10)
        _same(rp, rr)
