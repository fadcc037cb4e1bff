"""Layout probe: the backward Riccati kernel's building blocks, timed on
the card (counterpart of ``scripts/probe_mosaic.py``).

The JAX script sends six Pallas bodies at seven shapes through one
``pl.pallas_call`` (``_time_one``) to time the Mosaic lowerings of the
TPU kernel's batch-in-lanes layout. Here each body is a hand-written CUDA
kernel for Hopper in ``csrc/layout_probe.cu`` with a plain torch version
beside it (``*_ref``). For i < rep, in float32, summed into zeros:

* ``batched_mm``: ``acc += bmm(a + i, b)`` (``k_batched_mm``, two shapes);
* ``shared_mm``: ``acc += (a + i) @ b`` (``k_shared_mm``);
* ``transpose``: ``acc += (x + i).permute(1, 2, 0)`` (``k_transpose``);
* ``bcast_fma``: ``acc += (a + i)[:, None, :] * b`` (``k_bcast_fma``);
* ``slab_reduce``: ``acc += (b + i).sum(0)`` (``k_slab_reduce``);
* ``lanes_apply``: ``acc += Y`` with ``Y[j] = Σ_k (L + i)[j, k] ⊙ B[k]``
  over the lane axis, L (R, R, TB) with R = 24 (``k_lanes_apply``).

Each launch repeats its construct ``rep`` times; the slope of the time
over two repeat counts is the cost of one construct, free of launch and
readback overhead (the JAX script's method, with CUDA events in place of
the host clock); a kernel's time is the median of ``SLOPES`` slopes, with
their spread. The products run on the tensor cores in error-compensated
3×TF32 (``csrc/layout_probe.cu``), so a construct's least time is the
larger of its product's three TF32 passes at the tensor cores' rate and
its float32 instructions (adds, multiplies and FMAs, one each) at the
float32 pipe's issue rate (``Probe.bound_s``); ``Probe.old_bound_s``
keeps the earlier bound, operations over the float32 FMA rate. Each wrapper takes its plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises. Unlike the
JAX script, which prints FAIL and goes on, a probe that fails to build,
to launch or to match its plain version raises.

Run on a machine with a CUDA card:
``python -m aligator_tpu_torch.probes.layout_probe``.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from aligator_tpu_torch.utils import cuda_build
from aligator_tpu_torch.utils.device import full_f32_matmuls

TB, R, C = 128, 24, 57  # probe_mosaic.py:34
# Calls between the two events of one timing. A construct of the fastest
# bodies takes a few nanoseconds, so 50 more repeats move a launch by well
# under a microsecond: many calls average the launches' jitter out.
TIMED_CALLS = 400
SLOPES = 3         # a kernel's time: the median of this many slopes,
MAX_SLOPES = 9     # or of up to this many while they spread by more than
MAX_SPREAD = 0.10  # this share of their median
# The plain versions and library loops issue up to 4 launches per construct:
# 2 calls at rep 60 stay within the stream's queue (about a thousand launches)
QUEUED_CALLS = 2
SPIN_CYCLES_PER_S = 2e9  # the H100's SM clock is at most 1.98 GHz
# Kernel against plain version: max|Δ| ≤ TOL_PER_REP · rep · max|plain|.
# Each repeat adds float32 sums of up to 56 products taken in another
# order, and with fused multiply-adds, than the plain version's calls.
TOL_PER_REP = 1e-5
# H100 SXM at its 700 W limit (NVIDIA's data sheet): dense TF32 on the
# tensor cores; float32 outside them, an FMA counted as two operations;
# and the float32 pipe's issue rate, one add, multiply or FMA a lane a
# cycle on 132 SMs of 128 lanes at 1.98 GHz.
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12
F32_INSTR_PER_S = 132 * 128 * 1.98e9
TF32_PASSES = 3  # hi·hi′ + hi·lo′ + lo·hi′

_SRC = "scripts/probe_mosaic.py"


# ---------------------------------------------------------------------------
# Plain torch versions (what each Pallas body computes)
# ---------------------------------------------------------------------------


def batched_mm_ref(a: torch.Tensor, b: torch.Tensor, rep: int) -> torch.Tensor:
    acc = a.new_zeros(a.shape[0], a.shape[1], b.shape[2])
    for i in range(rep):
        acc = acc + torch.bmm(a + float(i), b)
    return acc


def shared_mm_ref(a: torch.Tensor, b: torch.Tensor, rep: int) -> torch.Tensor:
    acc = a.new_zeros(a.shape[0], b.shape[1])
    for i in range(rep):
        acc = acc + (a + float(i)) @ b
    return acc


def transpose_ref(x: torch.Tensor, rep: int) -> torch.Tensor:
    acc = x.new_zeros(x.shape[1], x.shape[2], x.shape[0])
    for i in range(rep):
        acc = acc + (x + float(i)).permute(1, 2, 0)
    return acc


def bcast_fma_ref(a: torch.Tensor, b: torch.Tensor, rep: int) -> torch.Tensor:
    acc = torch.zeros_like(b)
    for i in range(rep):
        acc = acc + (a + float(i))[:, None, :] * b
    return acc


def slab_reduce_ref(b: torch.Tensor, rep: int) -> torch.Tensor:
    acc = b.new_zeros(b.shape[1:])
    for i in range(rep):
        acc = acc + (b + float(i)).sum(0)
    return acc


def lanes_apply_ref(L: torch.Tensor, B: torch.Tensor, rep: int) -> torch.Tensor:
    _lanes_shapes(L, B)
    acc = B.new_zeros(R, B.shape[1], B.shape[2])
    for i in range(rep):
        acc = acc + ((L + float(i))[:, :, None, :] * B[None]).sum(1)
    return acc


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, the CUDA kernel otherwise
# ---------------------------------------------------------------------------


def _shape(name: str, t: torch.Tensor, want: Sequence[int]) -> None:
    if tuple(t.shape) != tuple(want):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(want)}")


def _lanes_shapes(L: torch.Tensor, B: torch.Tensor) -> None:
    # k_lanes_apply loops over the module-level R (probe_mosaic.py:106)
    _shape("L", L, (R, R, L.shape[-1]))
    _shape("B", B, (R, B.shape[1], L.shape[-1]))


def _launch(wrapper, plain, c_name, inputs, out_shape, dims, rep):
    dev = inputs[0].device
    if dev.type == "cpu":
        return plain(*inputs, rep)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in inputs:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{c_name}: inputs must be contiguous float32 on {dev}")
    if rep < 0:
        raise ValueError("rep must be >= 0")
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    fn = getattr(cuda_build.load("layout_probe"), c_name)
    with torch.cuda.device(dev):  # launch on the tensors' card
        err = fn(*(t.data_ptr() for t in inputs), out.data_ptr(), *dims, int(rep),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{c_name} kernel launch failed: cudaError {err}")
    wrapper.launches += 1
    return out


def batched_mm(a: torch.Tensor, b: torch.Tensor, rep: int) -> torch.Tensor:
    """Σ_{i<rep} bmm(a + i, b) for a (nb, m, k), b (nb, k, n)."""
    nb, m, k = a.shape
    n = b.shape[2]
    _shape("b", b, (nb, k, n))
    return _launch(batched_mm, batched_mm_ref, "probe_batched_mm_f32", (a, b),
                   (nb, m, n), (nb, m, k, n), rep)


def shared_mm(a: torch.Tensor, b: torch.Tensor, rep: int) -> torch.Tensor:
    """Σ_{i<rep} (a + i) @ b for a (m, k), b (k, n)."""
    m, k = a.shape
    n = b.shape[1]
    _shape("b", b, (k, n))
    return _launch(shared_mm, shared_mm_ref, "probe_shared_mm_f32", (a, b),
                   (m, n), (m, k, n), rep)


def transpose(x: torch.Tensor, rep: int) -> torch.Tensor:
    """Σ_{i<rep} (x + i).permute(1, 2, 0) for x (TB, R, C)."""
    tb, r, c = x.shape
    return _launch(transpose, transpose_ref, "probe_transpose_f32", (x,),
                   (r, c, tb), (tb, r, c), rep)


def bcast_fma(a: torch.Tensor, b: torch.Tensor, rep: int) -> torch.Tensor:
    """Σ_{i<rep} (a + i)[:, None, :] * b for a (R, TB), b (R, C, TB)."""
    r, c, tb = b.shape
    _shape("a", a, (r, tb))
    return _launch(bcast_fma, bcast_fma_ref, "probe_bcast_fma_f32", (a, b),
                   (r, c, tb), (r, c, tb), rep)


def slab_reduce(b: torch.Tensor, rep: int) -> torch.Tensor:
    """Σ_{i<rep} (b + i).sum(0) for b (R, C, TB)."""
    r, c, tb = b.shape
    return _launch(slab_reduce, slab_reduce_ref, "probe_slab_reduce_f32", (b,),
                   (c, tb), (r, c, tb), rep)


def lanes_apply(L: torch.Tensor, B: torch.Tensor, rep: int) -> torch.Tensor:
    """Σ_{i<rep} Y_i, Y_i[j] = Σ_k (L + i)[j, k] ⊙ B[k], for L (24, 24, TB)
    and B (24, C, TB)."""
    _lanes_shapes(L, B)
    _, c, tb = B.shape
    return _launch(lanes_apply, lanes_apply_ref, "probe_lanes_apply_f32", (L, B),
                   (R, c, tb), (c, tb), rep)


for _w in (batched_mm, shared_mm, transpose, bcast_fma, slab_reduce, lanes_apply):
    _w.launches = 0


# ---------------------------------------------------------------------------
# The probes at the JAX script's shapes, and the slope timing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Probe:
    tag: str                   # P1a..P1g
    name: str                  # the JAX script's probe name
    kernel: Callable           # the wrapper: kernel(*inputs, rep)
    plain: Callable            # its plain version, called the same way
    library: Callable          # one construct by PyTorch calls: library(inputs, i)
    shapes: Tuple[Tuple[int, ...], ...]
    reps: Tuple[int, int]      # the two repeat counts of the slope
    replaces: str              # file:line of the Pallas body
    flops: int                 # operations of one construct (an FMA two)
    nbytes: int                # one launch: inputs read once, output written once
    instructions: int          # float32 adds, multiplies and FMAs of one construct
    tf32_flops: int = 0        # its product's 2·m·k·n, taken TF32_PASSES times

    @property
    def bound_s(self) -> float:
        """Least seconds of one construct: its product's TF32 passes on the
        tensor cores or its float32 instructions on the float32 pipe,
        whichever takes longer."""
        return max(TF32_PASSES * self.tf32_flops / TF32_FLOP_PER_S,
                   self.instructions / F32_INSTR_PER_S)

    @property
    def old_bound_s(self) -> float:
        """The bound before the products moved to the tensor cores: all
        operations over the float32 FMA rate."""
        return self.flops / F32_FLOP_PER_S


def _product(tag, name, kernel, plain, library, nb, m, k, n, reps, line, b_each):
    """A product probe: nb products (a + i) @ b of (m, k) @ (k, n), b one
    per product or (``b_each`` False) one for all. Its float32
    instructions: the offset, one add per element of a, and the
    accumulation, one add per output."""
    shapes = ((nb, m, k), (nb, k, n)) if nb > 1 else ((m, k), (k, n))
    adds = nb * m * k + nb * m * n
    b_elems = nb * k * n if b_each else k * n
    return Probe(tag, name, kernel, plain, library, shapes, reps, f"{_SRC}:{line}",
                 2 * nb * m * k * n + adds, 4 * (nb * m * k + b_elems + nb * m * n),
                 adds, 2 * nb * m * k * n)


def probes() -> List[Probe]:
    """The seven probes of ``probe_mosaic.py:132-150``. Operations of one
    construct: a product 2·m·k·n, the offset one add per element of the
    first operand, the reduction and the accumulation one add per element
    they produce. Its float32 instructions count an add, a multiply and
    an FMA one each (a product's multiply-adds run on the tensor cores)."""
    M, K, N = 1536, 56, 78
    slab = R * C * TB
    return [
        _product("P1a", "bmm_16x(24x24@24x57)", batched_mm, batched_mm_ref,
                 lambda x, i: torch.bmm(x[0] + i, x[1]), 16, 24, 24, 57, (4, 20), 112, True),
        _product("P1b", "bmm_16x(56x56@56x78)", batched_mm, batched_mm_ref,
                 lambda x, i: torch.bmm(x[0] + i, x[1]), 16, 56, 56, 78, (4, 20), 112, True),
        _product("P1c", f"shared_mm_({M}x{K}@{K}x{N})", shared_mm, shared_mm_ref,
                 lambda x, i: (x[0] + i) @ x[1], 1, M, K, N, (10, 60), 123, False),
        # offset and accumulation: an add each per element
        Probe("P1d", "transpose_(TB,R,C)->(R,C,TB)", transpose, transpose_ref,
              lambda x, i: (x[0] + i).permute(1, 2, 0).contiguous(), ((TB, R, C),),
              (10, 60), f"{_SRC}:71", 2 * slab, 4 * 2 * slab, 2 * slab),
        # the offset an add per element of a, then an FMA per element of b
        Probe("P1e", "bcast_fma", bcast_fma, bcast_fma_ref,
              lambda x, i: (x[0] + i)[:, None, :] * x[1], ((R, TB), (R, C, TB)),
              (10, 60), f"{_SRC}:79", R * TB + 2 * slab, 4 * (R * TB + 2 * slab),
              R * TB + slab),
        # the offset an add per element, the sum over r and the
        # accumulation together an add per element
        Probe("P1f", "slab_reduce", slab_reduce, slab_reduce_ref,
              lambda x, i: (x[0] + i).sum(0), ((R, C, TB),), (10, 60),
              f"{_SRC}:89", 2 * slab, 4 * (slab + C * TB), 2 * slab),
        # the offset an add per element of L, R FMAs per output, the
        # accumulation an add per output
        Probe("P1g", "lanes_apply_RxRxTB", lanes_apply, lanes_apply_ref,
              lambda x, i: torch.einsum("jkl,kcl->jcl", x[0] + i, x[1]),
              ((R, R, TB), (R, C, TB)), (10, 60), f"{_SRC}:97",
              2 * R * slab + R * R * TB + slab, 4 * (R * R * TB + 2 * slab),
              R * R * TB + R * slab + slab),
    ]


def make_inputs(shapes, device) -> List[torch.Tensor]:
    """float32 inputs as ``_time_one`` makes them: each one from a fresh
    ``np.random.default_rng(0)``."""
    return [torch.as_tensor(np.random.default_rng(0).standard_normal(s),
                            dtype=torch.float32).to(device) for s in shapes]


def time_one(fn: Callable, rep: int, inputs, calls: int = TIMED_CALLS) -> float:
    """Mean seconds per call of ``fn(*inputs, rep)`` on the card: one
    warm-up call, then ``calls`` calls between two CUDA events.

    The host takes longer to issue a call (tens of µs) than a probe kernel
    runs, so a spin on the card first holds the stream while the host
    queues the timed calls: the card then runs them back to back and the
    events time the card, not the host's dispatch."""
    fn(*inputs, rep)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*inputs, rep)
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * (2 * calls * issue_s + 1e-3)))
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(calls):
        fn(*inputs, rep)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) * 1e-3 / calls


def slope(fn: Callable, inputs, reps, calls: int = TIMED_CALLS) -> dict:
    """Seconds per construct: (t_hi − t_lo)/(rep_hi − rep_lo). The host is
    shared, so a slope ≤ 0 is measured once more; both are kept."""
    tries = []
    for _ in range(2):
        t_lo = time_one(fn, reps[0], inputs, calls)
        t_hi = time_one(fn, reps[1], inputs, calls)
        tries.append(((t_hi - t_lo) / (reps[1] - reps[0]), t_lo))
        if tries[-1][0] > 0:
            break
    return dict(per_s=tries[-1][0], launch_s=tries[-1][1],
                first_per_s=tries[0][0] if len(tries) > 1 else None)


def median_slope(fn: Callable, inputs, reps) -> dict:
    """The median of ``SLOPES`` slopes, or of more (up to ``MAX_SLOPES``)
    while their spread, (max − min)/median, exceeds ``MAX_SPREAD``."""
    runs = [slope(fn, inputs, reps) for _ in range(SLOPES)]
    while True:
        per = sorted(r["per_s"] for r in runs)
        med = per[len(per) // 2]
        spread = (per[-1] - per[0]) / med if med > 0 else float("inf")
        if spread <= MAX_SPREAD or len(runs) >= MAX_SLOPES:
            break
        runs += [slope(fn, inputs, reps) for _ in range(2)]
    return dict(per_s=med, spread=spread, slopes=[r["per_s"] for r in runs],
                launch_s=sorted(r["launch_s"] for r in runs)[len(runs) // 2],
                first_per_s=next((r["first_per_s"] for r in runs
                                  if r["first_per_s"] is not None), None))


def probe(name: str, fn: Callable, inputs, reps) -> dict:
    """The kernel's median slope, printed in the JAX script's line format
    with the slopes' spread."""
    s = median_slope(fn, inputs, reps)
    again = ("" if s["first_per_s"] is None else
             f" [a slope {s['first_per_s'] * 1e6:.6f} us <= 0, measured again]")
    print(f"PROBE {name}: OK  {s['per_s'] * 1e6:.6f} us/construct "
          f"(launch {s['launch_s'] * 1e3:.6f} ms @rep{reps[0]}; median of "
          f"{len(s['slopes'])} slopes, spread {100 * s['spread']:.1f} %){again}", flush=True)
    return s


def check(p: Probe, inputs) -> Tuple[float, float]:
    """The kernel against its plain version at both repeat counts; raises
    on a mismatch, returns the largest absolute error and the largest
    share of its gate."""
    worst = share = 0.0
    for rep in p.reps:
        got = p.kernel(*inputs, rep)
        want = p.plain(*inputs, rep)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = TOL_PER_REP * rep * float(want.abs().max())
        if not err <= tol:
            raise RuntimeError(f"probe {p.tag} {p.name} rep={rep}: max|Δ| {err} > {tol}")
        worst, share = max(worst, err), max(share, err / tol)
    return worst, share


def run(device="cuda") -> List[dict]:
    """Every probe on the card: checked against its plain version, then
    the kernel's median slope (printed as a PROBE line), and the slopes of
    the plain version and of its library calls in a Python loop
    (QUEUED_CALLS calls each, so that the card, not the host, is
    timed)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the layout probe times kernels on a CUDA card")
    results = []
    for p in probes():
        inputs = make_inputs(p.shapes, dev)
        err, share = check(p, inputs)
        kern = probe(p.name, p.kernel, inputs, p.reps)
        results.append(dict(probe=p, max_abs_err=err, gate_share=share, kernel=kern,
                            plain=slope(p.plain, inputs, p.reps, QUEUED_CALLS),
                            library=slope(_library_loop(p.library), inputs, p.reps,
                                          QUEUED_CALLS)))
    return results


def _library_loop(library: Callable) -> Callable:
    """``rep`` constructs by the library calls, one Python turn each."""
    def loop(*args):
        *inputs, rep = args
        for i in range(rep):
            library(inputs, float(i))
    return loop


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the layout probe needs a CUDA card")
    full_f32_matmuls()
    log = cuda_build.build_all().get("layout_probe", "")
    for line in log.splitlines():  # ptxas: each kernel's registers and spills
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(line.strip())
    print(f"card: {torch.cuda.get_device_name(0)}")
    run("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
