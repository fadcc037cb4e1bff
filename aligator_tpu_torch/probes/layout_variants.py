"""The layout probe's kernels at other tile and strip sizes, timed side by
side on the card.

A variant is ``csrc/layout_probe.cu`` with some of its ``constexpr int
kName = N;`` constants set otherwise (``--set kMmWarps=1,kTrEl=4``: warps
per block of the products, outputs per thread of the transpose; the
source's own comments say what each constant sizes). Every variant is built
by nvcc, all at once, into ``build/kernels/variants/``, then in turn put
in place of the built probe library, each probe held against its plain
version at both repeat counts and timed by its median slope
(``layout_probe.median_slope``), after the instructions in its kernels'
loops (``sass_loops``). The source as it is (``base``) runs first and
last, so that drift over the run shows.

Run on a machine with a CUDA card::

    python -m aligator_tpu_torch.probes.layout_variants --set kMmWarps=1
        [--set kTrEl=4,kBcStrip=8 ...] [--probes P1a P1b ...]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import torch

from aligator_tpu_torch.probes import layout_probe as LP
from aligator_tpu_torch.probes import sass_loops as SL
from aligator_tpu_torch.utils import cuda_build
from aligator_tpu_torch.utils.device import full_f32_matmuls

SOURCE = cuda_build.CSRC / "layout_probe.cu"
VARIANT_DIR = cuda_build.BUILD_DIR / "variants"


def variant_source(changes: Dict[str, int]) -> str:
    """The probe's source with each named constant set to its value."""
    src = SOURCE.read_text()
    for name, value in changes.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         src)
        if n != 1:
            raise ValueError(f"{name} is not a constant of {SOURCE.name}")
    return src


def build(variants: List[Dict[str, int]]) -> List[Path]:
    """One library per variant, compiled in parallel (each distinct source
    once)."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    libs, procs = [], {}
    for changes in variants:
        src = variant_source(changes)
        digest = hashlib.sha256((src + " ".join(cuda_build.NVCC_FLAGS)).encode()).hexdigest()[:12]
        so = VARIANT_DIR / f"layout_probe-{digest}.so"
        libs.append(so)
        if so.exists() or so in procs:
            continue
        cu = so.with_suffix(".cu")
        cu.write_text(src)
        procs[so] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for so, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {so.with_suffix('.cu')}:\n{log}")
    return libs


@contextlib.contextmanager
def in_place_of_the_probe(so: Path):
    """The wrappers of ``layout_probe`` launch this library's kernels."""
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in cuda_build.SIGNATURES["layout_probe"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    prev = cuda_build._LIBS.get("layout_probe")
    cuda_build._LIBS["layout_probe"] = lib
    try:
        yield
    finally:
        if prev is None:
            cuda_build._LIBS.pop("layout_probe")
        else:
            cuda_build._LIBS["layout_probe"] = prev


def _parse(spec: str) -> Dict[str, int]:
    return {k: int(v) for k, v in (item.split("=") for item in spec.split(","))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--set", action="append", default=[], metavar="kName=N[,kName=N]")
    ap.add_argument("--probes", nargs="*", help="tags, e.g. P1a P1f (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the layout probe's variants need a CUDA card")
    full_f32_matmuls()
    variants = [{}] + [_parse(s) for s in args.set] + [{}]
    names = ["base"] + args.set + ["base"]
    libs = build(variants)
    dev = torch.device("cuda")
    table = [p for p in LP.probes() if not args.probes or p.tag in args.probes]
    inputs = {p.tag: LP.make_inputs(p.shapes, dev) for p in table}
    per = {}
    for name, so in zip(names, libs):
        for line in SL.lines(SL.report(SL.cuobjdump(so))):
            print(f"variant {name} {line}")
        with in_place_of_the_probe(so):
            for p in table:
                LP.check(p, inputs[p.tag])
                s = LP.median_slope(p.kernel, inputs[p.tag], p.reps)
                per.setdefault(p.tag, []).append(s["per_s"])
                print(f"variant {name} {p.tag} {p.name}: {s['per_s'] * 1e6:.6f} us/construct, "
                      f"spread {100 * s['spread']:.1f} % over {len(s['slopes'])} slopes",
                      flush=True)
    for p in table:
        print(f"variants {p.tag}: " + ", ".join(
            f"{n} {t * 1e6:.6f}" for n, t in zip(names, per[p.tag])) + " us/construct; "
            f"bound {p.bound_s * 1e6:.6f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
