"""Runs of each cell on the CPU with the port broken under the timed path:
the comparison with the reference must come out not correct, with the
cell's own limits, where the sound run comes out correct. The runs keep the
cell's rows and calls sampled; the walk keeps its batch at a tiny horizon,
lqr56 its horizon at a batch of 16 (1024 instances of N = 100 do not fit a
test's memory; ``test_every_call_samples_every_block`` holds the sampling at
1024).

Faults planted: an answer altered where it is produced (the controls moved
by 1 % of their largest magnitude); half of the batch left out (its rows
returned as the initial guess); an MPC step that returns the state it was
given, unchanged."""

import dataclasses

import pytest
import torch

from portbench.core import data, manifest
from portbench.run import run_cell
from portbench.systems import Program
from portbench.window import block_rows

CPU = torch.device("cpu")
TINY = {"lqr56": {}, "talos_walk": {"T_ss": 2, "T_ds": 2, "nsteps": 10}}
BATCH = {"lqr56": 16}
CELLS = [w["name"] for w in manifest()["workloads"]]


def altered(res):
    return dataclasses.replace(res, us=res.us + 0.01 * res.us.abs().max())


def half_left_out(res):
    h = res.xs.shape[0] // 2
    xs, us, vs, lams = (a.clone() for a in (res.xs, res.us, res.vs, res.lams))
    xs[h:] = res.xs[h:, :1]
    us[h:], vs[h:], lams[h:] = 0.0, 0.0, 0.0
    return dataclasses.replace(res, xs=xs, us=us, vs=vs, lams=lams)


class _Wrapped:
    """A module of the port with one function broken."""

    def __init__(self, mod, fault):
        self._mod, self._fault = mod, fault

    def __getattr__(self, key):
        return getattr(self._mod, key)


class _Solver(_Wrapped):
    def solve(self, problem, settings):
        return self._fault(self._mod.solve(problem, settings))


class _Mpc(_Wrapped):
    def mpc_step(self, problem, settings, x, state):
        _, new, res, problem = self._mod.mpc_step(problem, settings, x, state)
        if self._fault == "unchanged":
            return state.us[:, 0], state, res, problem
        res = self._fault(res)
        new = type(new)(xs=res.xs, us=res.us, vs=res.vs, lams=res.lams)
        return res.us[:, 0], new, res, problem


class Broken(Program):
    def __init__(self, fault, *a):
        super().__init__(*a)
        self.fault = fault

    def module(self, name):
        mod = super().module(name)
        wrap = {"solvers.proxddp": _Solver, "mpc": _Mpc}.get(name)
        return wrap(mod, self.fault) if wrap else mod


def _run(name, system=None):
    w = next(w for w in manifest()["workloads"] if w["name"] == name)
    sizes = {**data("configs", w["config"]), **TINY[w["config"]]}
    # the cell's rows and calls sampled; a window of one or two calls
    traffic = {**data("traffic", w["traffic"]), "trace_calls": 1}
    traffic["batch"] = BATCH.get(w["config"], traffic["batch"])
    traffic["settle_steps"] = min(traffic.get("settle_steps", 1), 2)
    out, _ = run_cell(name, 2 ** 31 + 12345, 1e-9, False, device=CPU,
                      system=system and system(w["config"], sizes), sizes=sizes,
                      traffic=traffic)
    return out["correct"], out["checks"]


FAULTS = {"altered": altered, "half_left_out": half_left_out, "unchanged": "unchanged"}
CASES = [(c, f) for c in CELLS for f in FAULTS if f != "unchanged" or ".mpc." in c]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    ok, checks = _run(name)
    assert ok, checks


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_caught(name, fault):
    ok, checks = _run(name, lambda cfg, sizes: Broken(FAULTS[fault], cfg, sizes, CPU))
    assert not ok, checks


@pytest.mark.parametrize("name", CELLS)
def test_every_call_samples_every_block(name):
    """At the cell's batch and sample_rows, each call's rows fall one in
    each block of the batch (so in both halves), and differ from call to call."""
    t = data("traffic", next(w for w in manifest()["workloads"]
                             if w["name"] == name)["traffic"])
    b, n = t["batch"], t["sample_rows"]
    assert n >= 2
    gen = torch.Generator().manual_seed(2 ** 31 + 77)
    draws = [block_rows(b, n, gen) for _ in range(200)]
    for rows in draws:
        assert rows.tolist() == sorted(set(rows.tolist())) and 0 <= rows.min() < rows.max() < b
        assert (rows * n // b).tolist() == list(range(n))
        assert (rows < b // 2).any() and (rows >= b // 2).any()
    assert len({tuple(r.tolist()) for r in draws}) > 100


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_half_batch_fault_is_caught_on_card(card, name):
    """The half-batch fault at the cell's own size, batch and sampling, on
    the card; a window of one call (the mpc cells after their settle steps)."""
    w = next(w for w in manifest()["workloads"] if w["name"] == name)
    sizes = data("configs", w["config"])
    broken = Broken(half_left_out, w["config"], sizes, card)
    out, _ = run_cell(name, 2 ** 31 + 4242, 1e-9, False, device=card, system=broken)
    assert not out["correct"], out["checks"]
