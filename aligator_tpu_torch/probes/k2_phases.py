"""Where a step of the forward kernel's chain (K2's small kernel) spends its
time, on the card.

Builds an instrumented copy of ``csrc/riccati_forward.cu`` (or of another
source with the same C entry points): in ``riccati_forward_small``, lane 0
of the chain reads ``clock64()`` after each part of a step and adds the
cycles since its previous stamp to that part's counter, and so does the
producer's lane 0 around its wait for a free slot and its copies; the
counters of every block go to a device array read back after the sweeps.
Prints, at the widths, horizon and batches asked for, the cycles per step
of each part averaged over the blocks, beside the instrumented sweep's
time (the stamps cost a little; the kernel's own times are
``probes.k2_split``'s and chip_smoke.py's).

Run on a machine with a CUDA card::

    python -m aligator_tpu_torch.probes.k2_phases [--source FILE]
        [--case NX NU NC N B ...] [--copy C]

``--rows 0`` leaves u, v and λ out (the chain and the copies alone).
``--copy``: 0 bulk copies (default where 16 bytes may be copied), 4, 2 or
1 cp.async copies of that many floats. Without ``--case``: the
quadrotor's widths (12, 4, 6; N = 60, B = 16), the solo jump's (36, 12,
0; N = 45, B = 16) and the bench widths (56, 22, 22; N = 100, B = 1).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
from pathlib import Path

import torch

from aligator_tpu_torch.gar import fused_riccati as FR
from aligator_tpu_torch.probes.k2_split import random_gains
from aligator_tpu_torch.utils import cuda_build

CASES = ((12, 4, 6, 60, 16), (36, 12, 0, 45, 16), (56, 22, 22, 100, 1))
SLOTS = 16  # counters per block
# (anchor line in the source, part it closes, stamping thread: "chain" lane
# 0 or the "producer"'s lane 0), inserted after the anchor
STAMPS = (
    ("      const float v = y + ((a0 + a1) + (a2 + a3));\n", "x_t's loads and the dot product",
     "chain"),
    ("      if (jn == 0) mbar_wait(full + cn, phn);\n", "the wait for a new chunk's copies",
     "chain"),
    ("      chain_sync<kCW>();\n",
     "x's stores, the next row and yff loaded, the chain's barrier", "chain"),
    ("        if (j == m - 1) mbar_arrive(empty + c);                 // the chain is done with c\n"
     "      }\n", "lane 0's arrivals", "chain"),
    ("      if (k0 >= S) mbar_wait_idle(empty + c, ph ^ 1u);\n",
     "the producer's wait for a free chunk", "producer"),
    ("      issue(k0, c);\n", "the producer's copies of a chunk", "producer"),
)
CHAIN_LOOP = "    for (int t = 0; t < steps; ++t) {\n"
CHAIN_END = "      c = cn;\n      ph = phn;\n    }\n"
PRODUCER_LOOP = "    for (; k0 < L; k0 += m) {\n"
PRODUCER_END = "        c = 0;\n        ph ^= 1u;\n      }\n    }\n"
_P, _I = ctypes.c_void_p, ctypes.c_int


def instrument(src: str) -> str:
    """The source with the stamps of STAMPS, the counters written out where
    each loop ends, and a C entry that reads them."""
    who = {"chain": "0", "producer": "32 * kCW"}
    for i, (anchor, _, role) in enumerate(STAMPS):
        if src.count(anchor) < 1:
            raise ValueError(f"anchor not found: {anchor!r}")
        src = src.replace(anchor, anchor + f"      K2_STAMP({who[role]}, {i});\n", 1)
    for loop, end, role in ((CHAIN_LOOP, CHAIN_END, "chain"),
                            (PRODUCER_LOOP, PRODUCER_END, "producer")):
        if loop not in src or end not in src:
            raise ValueError(f"the {role}'s loop was not found")
        src = src.replace(loop, "    long long k2_last = clock64();\n" + loop, 1)
        src = src.replace(end, end + (
            "    if (threadIdx.x == %s)\n"
            "      for (int i_ = 0; i_ < %d; ++i_)\n"
            "        if (k2_acc[i_]) k2_prof[blockIdx.x * %d + i_] = k2_acc[i_];\n"
            % (who[role], len(STAMPS), SLOTS)), 1)
    head = "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
    if head not in src:
        raise ValueError("the small kernel's head was not found")
    src = src.replace(head, head + "  long long k2_acc[%d] = {};\n" % len(STAMPS), 1)
    src = src.replace("#include <cuda_runtime.h>\n", (
        "#include <cuda_runtime.h>\n"
        "__device__ long long k2_prof[8192 * %d];\n"
        "#define K2_STAMP(w, p) if (threadIdx.x == (w)) { long long c_ = clock64();"
        " k2_acc[p] += c_ - k2_last; k2_last = c_; }\n" % SLOTS), 1)
    return src + ("\nextern \"C\" int k2_prof_read(long long* h, int n) {\n"
                  "  return (int)cudaMemcpyFromSymbol(h, k2_prof, n * sizeof(long long));\n}\n"
                  "extern \"C\" int k2_prof_clear(int n) {\n"
                  "  static long long z[8192 * %d];\n"
                  "  return (int)cudaMemcpyToSymbol(k2_prof, z, n * sizeof(long long));\n}\n"
                  % SLOTS)


def build(src_path: Path):
    code = instrument(src_path.read_text())
    digest = hashlib.sha256(code.encode()).hexdigest()[:12]
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda_build.BUILD_DIR / f"k2_phases-{digest}.cu"
    cu.write_text(code)
    so = cu.with_suffix(".so")
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on the instrumented source:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in cuda_build.SIGNATURES["riccati_forward"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.k2_prof_read.argtypes = [_P, _I]
    lib.k2_prof_read.restype = _I
    lib.k2_prof_clear.argtypes = [_I]
    lib.k2_prof_clear.restype = _I
    return lib, r.stdout + r.stderr


def split(lib, nx, nu, nc, N, B, copy, dev, rows: int = 1) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    g, v, x0, l0 = random_gains(gen, B, N, nx, nu, nc, dev)
    L = N + 1
    plan = FR.forward_plan(nx, B)
    if plan.kernel == "pair":  # nx = 56: the small kernel's class 64
        plan = FR.ForwardPlan("small", 64)
    vec = FR.forward_copy(nx, FR._rowwise_ptrs(g, v))
    if copy is None or (copy or 4) > vec:  # the wrapper's method, or one the inputs allow
        copy = 0 if vec == 4 else vec
    outs = [torch.empty((B, L, n), device=dev) for n in (nx, nu, nc, nx)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a.data_ptr() for a in (g.Acl, g.yff, x0, g.K, g.Z, v.Vxx, g.kff, g.zff, v.vx, l0,
                                   *outs)]

    def launch():
        err = lib.riccati_forward_small_f32(*ptrs, B, L, nx, nu, nc, plan.code, copy, rows,
                                            stream)
        if err != 0:
            raise RuntimeError(f"instrumented launch failed: cudaError {err}")

    launch()
    torch.cuda.synchronize()
    lib.k2_prof_clear(B * SLOTS)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    launch()
    e1.record()
    torch.cuda.synchronize()
    h = (ctypes.c_longlong * (B * SLOTS))()
    if lib.k2_prof_read(ctypes.addressof(h), B * SLOTS) != 0:
        raise RuntimeError("reading the counters failed")
    per = [sum(h[b * SLOTS + i] for b in range(B)) / B for i in range(len(STAMPS))]
    steps = max(L - 1, 1)
    out = dict(nx=nx, nu=nu, nc=nc, N=N, B=B, plan=str(plan), copy=copy,
               ms=e0.elapsed_time(e1), ring=FR.forward_occupancy(nx, nu, nc, L, B),
               parts={name: per[i] / (steps if role == "chain" else L)
                      for i, (_, name, role) in enumerate(STAMPS)})
    print(f"nx={nx} nu={nu} nc={nc} N={N} B={B} ({plan}, copy {copy}, rows {rows}, ring "
          f"{out['ring']}): "
          f"instrumented sweep {out['ms']:.4f} ms; cycles per step (chain) or per knot "
          f"(producer):", flush=True)
    for name, c in out["parts"].items():
        print(f"  {c:9.1f}  {name}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, default=cuda_build.CSRC / "riccati_forward.cu")
    ap.add_argument("--case", nargs=5, type=int, action="append",
                    metavar=("NX", "NU", "NC", "N", "B"))
    ap.add_argument("--copy", type=int, default=None)
    ap.add_argument("--rows", type=int, default=1, help="0: the chain alone (u, v, λ left out)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_phases: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    lib, log = build(args.source)
    fn = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif ("registers" in line or "spill" in line) and "riccati_forward_small" in fn:
            print(f"  ptxas {fn[-40:]}: {line.strip()}")
    for c in args.case or CASES:
        split(lib, *c, args.copy, dev, args.rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
