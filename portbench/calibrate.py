"""The readings that the limits of a cell are set from, in one process:

    python3 -m portbench.calibrate --workload <cell> --seconds <s> \
        --seeds <n> ... [--control-seeds <n> ...] [--out <file>]

For each of ``--seeds`` it makes a run of the cell on the port, with a
window of ``--seconds``, and prints the numbers compared (the lower
readings come from these). For each of ``--control-seeds`` it makes the
same run with the control in the port's place: the reference's copy in
float32 with TF32 products (the precision below the configuration's
float32 with TF32 off), whose numbers give the upper readings. Each run
prints one JSON line; ``--out`` appends them to a file too.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

from portbench.core import cell, data, manifest
from portbench.run import prepare_process, run_cell
from portbench.systems import Reference


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings for a cell's limits.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    prepare_process()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    w = cell(manifest(), args.workload)
    sizes = data("configs", w["config"])
    dev = torch.device("cuda", 0)
    none = {}  # no limits: every number the comparison computes is printed
    runs = [("program", s) for s in args.seeds] + [("control", s) for s in args.control_seeds]
    for who, seed in runs:
        system = (Reference(w["config"], sizes, dev, dtype=torch.float32, tf32=True)
                  if who == "control" else None)
        t0 = time.perf_counter()
        try:
            out, numbers = run_cell(args.workload, seed, args.seconds, False, system=system,
                                    limits=none, t_start=t0)
            line = {"cell": args.workload, "system": who, "seed": seed, "numbers": numbers,
                    "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                    "attempted": out["attempted"], "failed": out["failed"],
                    "memory_peak_bytes": out["device"]["memory_peak_bytes"]}
        except Exception as e:  # a control that crashes has failed: record it
            line = {"cell": args.workload, "system": who, "seed": seed, "error": repr(e)}
        line["wall_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
