"""The general driver of a traffic mix: set-up, warm-up and the measured
window. A mix is a data file ``traffic/<mix>.json``; its ``kind`` names the
module ``traffic/<kind>.py`` that makes one call of that kind (``solve``:
a batched ``proxddp.solve``; ``mpc``: a batched ``mpc_step`` of a closed
loop), warms it up, keeps a call's sampled outputs and compares them with
the reference. A new kind is a new file there.

Every call is timed on the host's clock up to ``torch.cuda.synchronize()``.
Around each call the outputs of a few rows are kept (inside a range of
their own, which the traced metrics leave out), for the comparison with the
reference after the window: one row in each of ``sample_rows`` equal blocks
of the batch, at offsets drawn from the seed anew for every call, so that
every part of the batch is sampled in every call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from portbench.core import load
from portbench.trace import trace_window

SAMPLE = "portbench.sample"


@dataclass
class Window:
    kind: str
    batch: int
    latencies: list = field(default_factory=list)  # s per call
    window_s: float = 0.0
    attempted: int = 0
    solved: int = 0
    iters: list = field(default_factory=list)  # (B,) num_iters per call
    samples: list = field(default_factory=list)  # per call (warm-up or settle calls first)
    first: int = 0  # index in samples of the window's first call
    counters: dict = field(default_factory=dict)  # the program's, over the window
    trace: object = None


def block_rows(batch: int, n: int, gen: torch.Generator) -> torch.Tensor:
    """One row in each of ``n`` equal blocks of ``range(batch)``, at an
    offset drawn from ``gen`` within its block."""
    n = min(n, batch)
    starts = torch.arange(n) * batch // n
    sizes = torch.arange(1, n + 1) * batch // n - starts
    return starts + (torch.rand(n, generator=gen, dtype=torch.float64) * sizes).long()


class Mix:
    """One cell's traffic on one system: ``setup`` then ``run``."""

    def __init__(self, system, sizes: dict, traffic: dict, seed: int, device):
        self.sys, self.sizes, self.traffic, self.device = system, sizes, traffic, device
        self.kind = load("traffic", traffic["kind"])
        self.batch, self.scale = traffic["batch"], traffic["disturbance"]
        key = seed % (2 ** 63)
        # inputs and draws from the seed: one stream on the card, one on the host
        self.gen = torch.Generator(device=device).manual_seed(key)
        self.host_gen = torch.Generator().manual_seed(key)
        self.settings_dict = sizes[f"{traffic['kind']}_settings"]
        self.cfg = load("configs", sizes["name"])
        self.out = Window(kind=traffic["kind"], batch=self.batch)

    def setup(self):
        """Inputs, the problem, the kind's warm-up (or settle) calls: every
        shape of the window runs once."""
        self.inputs = self.cfg.inputs(self.sizes, self.gen, self.device)
        self.problem = self.sys.problem(self.inputs, self.batch)
        self.base = self.problem.x0.clone()
        self.settings = self.sys.settings(self.settings_dict)
        self.kind.setup(self)
        self._sync()
        self.out.first = len(self.out.samples)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self):
        """One timed call of the kind on a new draw: (seconds, instances solved)."""
        z = self.cfg.noise(self.sizes, self.gen, self.batch, self.scale, self.device)
        rows = block_rows(self.batch, self.traffic["sample_rows"], self.host_gen)
        with torch.profiler.record_function(SAMPLE):
            rows = rows.to(self.device)
            kept = self.kind.before(self, rows)
        t0 = time.perf_counter()
        res = self.kind.step(self, z)
        self._sync()
        lat = time.perf_counter() - t0
        with torch.profiler.record_function(SAMPLE):
            self.out.samples.append({"rows": rows, "noise": z[rows], **kept,
                                     **self.kind.after(self, res, rows)})
            if hasattr(res, "num_iters"):
                self.out.iters.append(res.num_iters.clone())
            solved = self.kind.solved(self, res)
        return lat, solved

    def run(self, seconds: float, traced: bool):
        """The measured window: calls until ``seconds`` have passed (the
        last call ends the window), or with ``traced`` the traffic's
        ``trace_calls`` calls under the profiler."""
        before = self.sys.counters()

        def body():
            t0 = time.perf_counter()
            while True:
                lat, solved = self.call()
                self.out.latencies.append(lat)
                self.out.attempted += self.batch
                self.out.solved += solved
                done = time.perf_counter() - t0
                if (len(self.out.latencies) >= self.traffic["trace_calls"] if traced
                        else done >= seconds):
                    break
            self.out.window_s = time.perf_counter() - t0

        if traced:
            self.out.trace = trace_window(body)
        else:
            body()
        after = self.sys.counters()
        self.out.counters = {k: after[k] - before[k] for k in after}
        return self.out
