"""Where a knot of the backward Riccati kernel (K1) spends its time, on the
card.

Builds an instrumented copy of ``csrc/riccati_backward.cu`` (or of another
source with the same C entry points, such as an earlier version of it):
after every ``__syncthreads()`` of the time loop, thread 0 of each block
reads ``clock64()`` and adds the cycles since its previous stamp to that
barrier's counter, in shared memory; the counters of every block go to a
device array read back after one sweep. Phase k is the stretch of the
loop body that ends at its k-th barrier (the last phase runs to the end of
the body). Prints the cycles per knot of each phase, averaged over the
blocks, with its share, at the bench widths (nx = 56, nu = nc = 22),
N = 100, B = 256 and 64. The stamps cost time of their own (registers,
one shared-memory add per barrier), so the instrumented sweep is timed
beside the split; the kernel's own times are chip_smoke.py's.

Run on a machine with a CUDA card::

    python -m aligator_tpu_torch.probes.k1_phases [--source FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import torch

from aligator_tpu_torch.utils import cuda_build

NX, NU, NC, NSTEPS = 56, 22, 22, 100
MAX_PHASES = 64
LOOP = "for (int t = L - 1; t >= 0; --t) {"
_I, _P = ctypes.c_int, ctypes.c_void_p


def instrument(src: str) -> tuple[str, int]:
    """The source with a stamp after every barrier of the time loop and one
    at the end of the loop body; returns it and the number of phases."""
    start = src.index(LOOP)
    depth, i = 0, start + len(LOOP) - 1
    while True:  # the loop body's closing brace
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            break
        i += 1
    body = src[start:i]
    n = len(re.findall(r"__syncthreads\(\);", body))
    if n + 1 > MAX_PHASES:
        raise ValueError(f"{n} barriers in the time loop; at most {MAX_PHASES - 1}")
    k = iter(range(n))
    body = re.sub(r"__syncthreads\(\);", lambda m: f"{m.group(0)} K1_STAMP({next(k)});", body)
    body += f"  K1_STAMP({n});\n  "
    after = src[i:]
    # write the counters out where the kernel returns: after the loop
    after = after.replace("}", "}\n  __syncthreads();\n  if (threadIdx.x < %d) "
                          "k1_prof[blockIdx.x * %d + threadIdx.x] = k1_acc[threadIdx.x];"
                          % (n + 1, MAX_PHASES), 1)
    head = src[:start] + (
        "__shared__ long long k1_acc[%d];\n  if (threadIdx.x < %d) k1_acc[threadIdx.x] = 0;\n"
        "  __syncthreads();\n  long long k1_last = clock64();\n  " % (MAX_PHASES, MAX_PHASES))
    out = head + body + after
    out = out.replace("#include <cuda_runtime.h>\n", (
        "#include <cuda_runtime.h>\n"
        "__device__ long long k1_prof[8192 * %d];\n"
        "#define K1_STAMP(p) if (threadIdx.x == 0) { long long c_ = clock64();"
        " k1_acc[p] += c_ - k1_last; k1_last = c_; }\n" % MAX_PHASES), 1)
    out += ("\nextern \"C\" int k1_prof_read(long long* h, int n) {\n"
            "  return (int)cudaMemcpyFromSymbol(h, k1_prof, n * sizeof(long long));\n}\n")
    return out, n + 1


def build(src_path: Path) -> tuple[ctypes.CDLL, int]:
    code, phases = instrument(src_path.read_text())
    digest = hashlib.sha256(code.encode()).hexdigest()[:12]
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda_build.BUILD_DIR / f"k1_phases-{digest}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(code)
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on the instrumented source:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.riccati_backward_f32.argtypes = [_P] * 20 + [_I] * 6 + [_P]
    lib.riccati_backward_f32.restype = _I
    lib.k1_prof_read.argtypes = [_P, _I]
    lib.k1_prof_read.restype = _I
    return lib, phases


def _knots(B: int, dev, gen):
    """Random well-posed knots at the bench widths; the kernel's time does
    not depend on the values."""
    L = NSTEPS + 1

    def spd(n):
        w = torch.randn(B, L, n, n, device=dev, generator=gen)
        return w @ w.mT / n + torch.eye(n, device=dev)

    r = lambda *s: 0.1 * torch.randn(B, L, *s, device=dev, generator=gen)
    A = torch.eye(NX, device=dev) + r(NX, NX) / NX ** 0.5
    D = torch.eye(NC, NU, device=dev) + r(NC, NU)
    return [spd(NX), r(NX, NU), spd(NU), r(NX), r(NU), A, r(NX, NU), r(NX), r(NC, NX), D,
            r(NC)]


def split(lib, phases: int, B: int, dev, gen) -> tuple[float, list]:
    """(ms of one instrumented sweep, mean cycles per knot of each phase)."""
    ins = [a.contiguous() for a in _knots(B, dev, gen)]
    mu = torch.full((B,), 1e-2, device=dev)
    L = NSTEPS + 1
    shapes = [(NU, NX), (NC, NX), (NU,), (NC,), (NX,), (NX, NX), (NX, NX), (NX,)]
    outs = [torch.empty((B, L) + s, device=dev) for s in shapes]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = lib.riccati_backward_f32(*(a.data_ptr() for a in ins), mu.data_ptr(),
                                       *(o.data_ptr() for o in outs), B, L, NX, NU, NC, 1,
                                       stream)
        if err != 0:
            raise RuntimeError(f"instrumented kernel launch failed: cudaError {err}")

    launch()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        launch()
    e1.record()
    torch.cuda.synchronize()
    h = (ctypes.c_longlong * (B * MAX_PHASES))()
    if lib.k1_prof_read(ctypes.addressof(h), B * MAX_PHASES) != 0:
        raise RuntimeError("reading the phase counters failed")
    per_block = [h[b * MAX_PHASES:b * MAX_PHASES + phases] for b in range(B)]
    mean = [sum(c[p] for c in per_block) / B / L for p in range(phases)]
    return e0.elapsed_time(e1) / 5, mean


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, default=cuda_build.CSRC / "riccati_backward.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_phases: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lib, phases = build(args.source)
    gen = torch.Generator(device=dev).manual_seed(0)
    for B in (256, 64):
        ms, cyc = split(lib, phases, B, dev, gen)
        total = sum(cyc)
        print(f"K1 phases, {args.source.name}, B={B} N={NSTEPS}: instrumented sweep {ms:.4f} ms, "
              f"{total:.0f} cycles per knot")
        print("  " + "  ".join(f"[{p}] {c:.0f} {100 * c / total:.1f}%" for p, c in enumerate(cyc)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
