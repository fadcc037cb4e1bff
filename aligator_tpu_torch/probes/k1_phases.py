"""Where a knot of the backward Riccati kernel (K1) spends its time, on the
card.

Builds an instrumented copy of ``csrc/riccati_backward.cu`` (or of another
source with the same C entry points, such as an earlier version of it):
after every barrier of every kernel's time loop (``__syncthreads()``, the
source's own ``bar_sync<…>()`` and ``team_sync<…>()``, and the cluster
barrier's wait), thread 0 of each block reads
``clock64()`` and adds the cycles since its previous stamp to that
barrier's counter, in shared memory; the counters of every block, with the
index and number of phases of the loop that ran, go to a device array read back
after the sweeps. Phase k is the stretch of the loop body that ends at its
k-th barrier (the last phase runs to the end of the body); each is printed
with the source line of the barrier that ends it. A barrier that a knot
skips (``if (nc > 0)``) leaves its cycles to the next stamp. Prints the
cycles per knot of each phase, averaged over the blocks, with its share,
at the widths, horizon and batches asked for (default: the bench widths
nx = 56, nu = nc = 22, N = 100, B = 256 and 64), and the ptxas report of
the instrumented build. The stamps cost time of their own (registers, one
shared-memory add per barrier), so the instrumented sweep is timed beside
the split; the kernel's own times are chip_smoke.py's. ``--min-threads`` runs
the same widths again with the small-width kernel's classes given at least
T threads per block, to see what more warps per problem would buy;
``--cluster C`` runs the compiled widths' kernel with C blocks per problem
(1 without a cluster, 2, 4 or 8 a thread-block cluster; 0, the default,
the size the C entry picks), each phase averaged over every block of every
cluster.

Run on a machine with a CUDA card::

    python -m aligator_tpu_torch.probes.k1_phases [--source FILE]
        [--widths NX NU NC [--widths NX NU NC ...]] [--steps N [N ...]]
        [--batch B [B ...]] [--min-threads T [T ...]] [--cluster C [C ...]]

e.g. the solo jump's and the quadrotor's widths in one build:
``--widths 36 12 0 --widths 12 4 6 --steps 45 60 --batch 16 256``.
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

BENCH = (56, 22, 22)
NSTEPS = 100
BATCHES = (256, 64)
MAX_PHASES = 64  # counters per block; the last two slots: the loop's index and phase count
LOOP = "for (int t = L - 1; t >= 0; --t) {"
BARRIER = re.compile(
    r"(?:__syncthreads\(\)|bar_sync<[^>]*>\(\)|team_sync<[^>]*>\(\)|"
    r"cg::cluster_group::barrier_wait\(\));")
_I, _P = ctypes.c_int, ctypes.c_void_p


def _closing(src: str, open_at: int) -> int:
    """Index of the brace that closes the one at ``open_at``."""
    depth = 0
    for i in range(open_at, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return i
    raise ValueError("unbalanced braces")


def _instrument_loop(src: str, start: int, index: int) -> tuple[str, list]:
    """The source from ``start`` (the header of time loop number ``index``)
    to the end, with that loop instrumented, and the source line of each
    phase's closing barrier (None for the end of the body)."""
    end = _closing(src, start + len(LOOP) - 1)
    body = src[start:end]
    first_line = src.count("\n", 0, start) + 1
    stamps = list(BARRIER.finditer(body))
    n = len(stamps)
    if n + 1 > MAX_PHASES - 2:
        raise ValueError(f"{n} barriers in a time loop; at most {MAX_PHASES - 3}")
    lines = [first_line + body.count("\n", 0, m.start()) for m in stamps] + [None]
    k = iter(range(n))
    body = BARRIER.sub(lambda m: f"{m.group(0)} K1_STAMP({next(k)});", body)
    body += f"  K1_STAMP({n});\n  "
    # the counters go out where the loop ends
    tail = ("}\n  __syncthreads();\n  for (int i_ = threadIdx.x; i_ < %d; i_ += blockDim.x) "
            "k1_prof[blockIdx.x * %d + i_] = k1_acc[i_];\n  if (threadIdx.x == 0) {\n"
            "    k1_prof[blockIdx.x * %d + %d] = %d;\n    k1_prof[blockIdx.x * %d + %d] = %d;\n  }"
            % (n + 1, MAX_PHASES, MAX_PHASES, MAX_PHASES - 2, index, MAX_PHASES,
               MAX_PHASES - 1, n + 1))
    head = ("__shared__ long long k1_acc[%d];\n  for (int i_ = threadIdx.x; i_ < %d; "
            "i_ += blockDim.x) k1_acc[i_] = 0;\n  __syncthreads();\n  "
            "long long k1_last = clock64();\n  " % (MAX_PHASES, MAX_PHASES))
    return head + body + tail + src[end + 1:], lines


def instrument(src: str) -> tuple[str, list]:
    """The source with a stamp after every barrier of every time loop and
    one at the end of each loop body; returns it and, for each loop in
    source order, the source lines of its phases' closing barriers."""
    starts = [m.start() for m in re.finditer(re.escape(LOOP), src)]
    if not starts:
        raise ValueError("no time loop found")
    loops = []
    for index, start in reversed(list(enumerate(starts))):  # earlier offsets hold
        rest, lines = _instrument_loop(src, start, index)
        src = src[:start] + rest
        loops.insert(0, lines)
    out = src.replace("#include <cuda_runtime.h>\n", (
        "#include <cuda_runtime.h>\n"
        "__device__ long long k1_prof[8192 * %d];\n"
        "#define K1_STAMP(p) if (threadIdx.x == 0) { long long c_ = clock64();"
        " k1_acc[p] += c_ - k1_last; k1_last = c_; }\n" % MAX_PHASES), 1)
    out += ("\nextern \"C\" int k1_prof_read(long long* h, int n) {\n"
            "  return (int)cudaMemcpyFromSymbol(h, k1_prof, n * sizeof(long long));\n}\n")
    return out, loops


# The class choice of the small-width kernel (csrc/riccati_backward.cu
# `variant_of`), where --min-threads puts a floor on its threads.
CLASS_THREADS = "  for (int t : kClassThreads)\n    if (t >= tiles) {"


def with_min_threads(src: str, floor: int) -> str:
    """The source with every small-width class given at least ``floor``
    threads per block (the widths' class otherwise)."""
    if CLASS_THREADS not in src:
        raise ValueError("the source has no small-width class choice to change")
    floored = CLASS_THREADS.replace("t >= tiles", f"t >= tiles && t >= {floor}")
    return src.replace(CLASS_THREADS, floored)


def build(src_path: Path, floors=(None,)) -> list:
    """For each threads floor (None: the source's own classes), the
    instrumented library, each loop's phase lines and nvcc's log; the
    builds run in parallel."""
    jobs = []
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for floor in floors:
        src = src_path.read_text()
        code, loops = instrument(src if floor is None else with_min_threads(src, floor))
        digest = hashlib.sha256(code.encode()).hexdigest()[:12]
        cu = cuda_build.BUILD_DIR / f"k1_phases-{digest}.cu"
        cu.write_text(code)
        so = cu.with_suffix(".so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((proc, so, loops))
    out = []
    for proc, so, loops in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the instrumented source:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.riccati_backward_f32.argtypes = [_P] * 20 + [_I] * 7 + [_P]
        lib.riccati_backward_f32.restype = _I
        lib.riccati_backward_variant.argtypes = [_I] * 3
        lib.riccati_backward_variant.restype = _I
        lib.riccati_backward_cluster.argtypes = [_I] * 5
        lib.riccati_backward_cluster.restype = _I
        lib.k1_prof_read.argtypes = [_P, _I]
        lib.k1_prof_read.restype = _I
        out.append((lib, loops, log))
    return out


def _knots(B: int, L: int, nx: int, nu: int, nc: int, dev, gen):
    """Random well-posed knots at these widths; the kernel's time does not
    depend on the values."""

    def spd(n):
        w = torch.randn(B, L, n, n, device=dev, generator=gen)
        return w @ w.mT / n + torch.eye(n, device=dev)

    r = lambda *s: 0.1 * torch.randn(B, L, *s, device=dev, generator=gen)
    A = torch.eye(nx, device=dev) + r(nx, nx) / nx ** 0.5
    D = torch.eye(nc, nu, device=dev) + r(nc, nu)
    return [spd(nx), r(nx, nu), spd(nu), r(nx), r(nu), A, r(nx, nu), r(nx), r(nc, nx), D,
            r(nc)]


def split(lib, widths, N: int, B: int, dev, gen, cluster: int = 0) -> tuple[float, int, list]:
    """(ms of one instrumented sweep, the index of the time loop that ran,
    its mean cycles per knot in each phase, over every block of the launch:
    ``cluster`` blocks per problem, 0 for the C entry's choice)."""
    nx, nu, nc = widths
    L = N + 1
    ins = [a.contiguous() for a in _knots(B, L, nx, nu, nc, dev, gen)]
    mu = torch.full((B,), 1e-2, device=dev)
    shapes = [(nu, nx), (nc, nx), (nu,), (nc,), (nx,), (nx, nx), (nx, nx), (nx,)]
    outs = [torch.empty((B, L) + s, device=dev) for s in shapes]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = lib.riccati_backward_f32(*(a.data_ptr() for a in ins), mu.data_ptr(),
                                       *(o.data_ptr() for o in outs), B, L, nx, nu, nc, 1,
                                       cluster, stream)
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
    blocks = B * (cluster or lib.riccati_backward_cluster(nx, nu, nc, B, 0))
    h = (ctypes.c_longlong * (blocks * MAX_PHASES))()
    if lib.k1_prof_read(ctypes.addressof(h), blocks * MAX_PHASES) != 0:
        raise RuntimeError("reading the phase counters failed")
    index, phases = h[MAX_PHASES - 2], h[MAX_PHASES - 1]
    per_block = [h[b * MAX_PHASES:b * MAX_PHASES + phases] for b in range(blocks)]
    mean = [sum(c[p] for c in per_block) / blocks / L for p in range(phases)]
    return e0.elapsed_time(e1) / 5, index, mean


def _label(mangled: str) -> str:
    """kernel<args> from a mangled kernel or device function name."""
    m = re.search(r"(riccati_backward_\w+?|warp_spd_inverse\w*?)I((?:Lin?\d+E)+)E", mangled)
    if not m:
        return mangled[:60]
    args = [v.replace("n", "-") for v in re.findall(r"Li(n?\d+)E", m.group(2))]
    return f"{m.group(1)}<{', '.join(args)}>"


def print_ptxas(log: str) -> None:
    """Registers and spills of each function of the instrumented build."""
    fn = ""
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)", line)
        if m:
            fn = _label(m.group(1))
        elif "registers" in line or "spill" in line:
            print(f"  ptxas (instrumented) {fn}: {line.strip()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, default=cuda_build.CSRC / "riccati_backward.cu")
    ap.add_argument("--widths", type=int, nargs=3, action="append", metavar=("NX", "NU", "NC"),
                    help="the knot's widths (more than once: each in turn, one build)")
    ap.add_argument("--steps", type=int, nargs="+", default=[NSTEPS],
                    help="N (the sweep has N + 1 knots): one value, or one for each --widths")
    ap.add_argument("--batch", type=int, nargs="+", default=BATCHES)
    ap.add_argument("--min-threads", type=int, nargs="+", default=[], metavar="T",
                    help="also run the small-width kernel with at least T threads per block "
                         "(one instrumented build each)")
    ap.add_argument("--cluster", type=int, nargs="+", default=[0], metavar="C",
                    help="blocks per problem at the compiled widths: 1, 2, 4, 8, or 0 for "
                         "the C entry's choice (each in turn)")
    args = ap.parse_args(argv)
    widths = args.widths or [list(BENCH)]
    if len(args.steps) not in (1, len(widths)):
        ap.error("--steps takes one value or one for each --widths")
    steps = args.steps * len(widths) if len(args.steps) == 1 else args.steps
    if not torch.cuda.is_available():
        print("k1_phases: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    floors = [None] + args.min_threads
    for floor, (lib, loops, log) in zip(floors, build(args.source, floors)):
        name = args.source.name + ("" if floor is None else f", threads >= {floor}")
        if floor is None:
            print_ptxas(log)
        for w, N in zip(widths, steps):
            report(lib, loops, name, tuple(w), N, args.batch, dev, args.cluster)
    return 0


def report(lib, loops, source: str, widths: tuple, N: int, batches, dev, clusters=(0,)) -> None:
    """Prints the split at these widths and horizon at each batch size and
    cluster size (the small widths take 1 or 0 only)."""
    nx, nu, nc = widths
    variant = lib.riccati_backward_variant(nx, nu, nc)
    gen = torch.Generator(device=dev).manual_seed(0)
    for B in batches:
        for cluster in clusters if variant in (1, 2) else (0,):
            cs = cluster or lib.riccati_backward_cluster(nx, nu, nc, B, 0)
            ms, loop, cyc = split(lib, widths, N, B, dev, gen, cs)
            total = sum(cyc)
            lines = loops[loop]
            print(f"K1 phases, {source}, nx={nx} nu={nu} nc={nc} (variant {variant}, cluster "
                  f"{cs}, time loop {loop}), B={B} N={N}: instrumented sweep {ms:.4f} ms, "
                  f"{ms / (N + 1) * 1e3:.2f} us per knot, {total:.0f} cycles per knot")
            print("  " + "  ".join(
                f"[{p}{'' if ln is None else f' :{ln}'}] {c:.0f} {100 * c / total:.1f}%"
                for p, (c, ln) in enumerate(zip(cyc, lines))))


if __name__ == "__main__":
    sys.exit(main())
