"""One run of one cell of the port's benchmark:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. It loads the cell's configuration, traffic mix and limits by the names
in BENCHMARK.json, builds the inputs from the seed, warms up the cell's
shapes (set-up), drives the window, compares the sampled outputs with the
reference, and prints one JSON line last on standard output: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics read from a
traced window (``--trace 1``). Without enough CUDA cards, or with JAX or
the JAX package loaded once the window has closed, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

from portbench.core import CHECKOUT, cell, data, forbidden_loaded, load, manifest, metrics_of  # noqa: E402,E501

import torch  # noqa: E402

from portbench.check import reference_numbers, verdict  # noqa: E402
from portbench.trace import breakdown  # noqa: E402
from portbench.window import Mix  # noqa: E402


class Refused(Exception):
    """The run cannot give a result (no card, a forbidden module)."""


@dataclass
class Record:
    """What a metric's reader sees of one run."""

    setup_s: float
    window: object  # window.Window
    lq: dict  # the LQ knots' shape: B, L, nx, nu, nc, refine

    @property
    def trace(self):
        return self.window.trace


def lq_shape(problem, settings: dict, batch: int) -> dict:
    return dict(B=batch, L=problem.nsteps + 1, nx=problem.ndx, nu=problem.nu,
                nc=max(problem.nc, problem.nc_term), refine=settings.get("riccati_refine", 1))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             system=None, sizes=None, traffic=None, limits=None, t_start=T_START) -> tuple:
    """(the printed line's object, every number the comparison computed).
    ``device``, ``system``, ``sizes``, ``traffic`` and ``limits`` stand in
    for the card, the port and the cell's files in the benchmark's readings
    and tests."""
    man = manifest()
    w = cell(man, name)
    sizes = sizes or data("configs", w["config"])
    traffic = traffic or data("traffic", w["traffic"])
    spec = data("limits", name)
    limits = limits if limits is not None else spec["limits"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
            raise Refused(f"the cell needs {w['chips']} CUDA card(s); "
                          f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    if system is None:
        from portbench.systems import Program

        system = Program(w["config"], sizes, device)
    mix = Mix(system, sizes, traffic, seed, device)
    mix.setup()
    setup_s = time.perf_counter() - t_start
    win = mix.run(seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec = Record(setup_s=setup_s, window=win,
                 lq=lq_shape(mix.problem, mix.settings_dict, mix.batch))
    mix.problem = mix.state = None  # the program's state, freed before the reference
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = reference_numbers(mix, win, traffic["sample_calls"], spec["reference"])
    correct, shown = verdict(numbers, limits)

    metrics = {}
    for m in metrics_of(man, "per_layer" if trace else "end_to_end", name):
        value = load("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": w["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": win.attempted,
           "failed": win.attempted - win.solved, "metrics": metrics, "device": dev}
    if trace and win.trace is not None:
        dev["busy_s"] = win.trace.busy_us / 1e6
        dev["window_s"] = win.trace.window_us / 1e6
        out["breakdown"] = breakdown(win.trace)
    found = forbidden_loaded()  # whatever the port or the reference loaded
    if found:
        raise Refused(f"modules loaded in the benchmark's process: {found}")
    out["checks"] = shown
    return out, numbers


def prepare_process() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's own kernels build into build/kernels there); the configuration's
    own robot model; one host thread, for steadier windows."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("ALIGATOR_TPU_TALOS_URDF", None)
    torch.set_num_threads(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_process()
    try:
        out, _ = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
