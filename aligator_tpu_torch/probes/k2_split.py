"""Where the forward Riccati kernel (K2) spends its time, on the card.

For each case (state, control and constraint widths, horizon, batch) it
draws random forward inputs from a seed (a stable closed loop, as
chip_smoke.py's ``random_gains``) and, for the kernel that
``fused_riccati.forward_plan`` picks and, at nx = 56 (the pair), the
small kernel's class 64 too, holds the sweep
against its plain version (gate 1e-4·max(1, max|·|)) and times with CUDA
events, after a spin that holds the stream while the host queues the
calls:

* the sweep as ``fused_riccati.forward_sweep_batched`` launches it;
* its parts alone (``fused_riccati.forward_parts``): for the pair the
  state chain and the u/v/λ rows, for the small kernel the same launch
  with the rows left out (the chain and the copies); for the small kernel
  where 16 bytes may be copied, the sweep and the chain again by the other
  copy method (cp.async of 16 bytes instead of bulk copies);
* the rows' library yardstick, one ``torch.baddbmm`` of the offsets and
  [K; Z; Vxx] against xs over the B·L knots (timed here only), and the
  plain version;

beside the bytes bound of each (every input read once, every output
written once, over 3.35 TB/s), in ms and in µs a knot of one problem,
with the small kernel's ring (knots, shared memory) and the ptxas lines of
the build. Exits non-zero if a sweep disagrees with its plain version.

Run on a machine with a CUDA card::

    python -m aligator_tpu_torch.probes.k2_split [--case NX NU NC N B ...]
        [--reps R] [--out FILE]

Without ``--case``: the quadrotor's widths (12, 4, 6; N = 60, B = 16), the
solo jump's (36, 12, 0; N = 45, B = 16), the lq long row (56, 22, 22;
N = 2048, B = 1), the talos walk's (56, 22, 0; N = 195, B = 16 and 1) and
the lqr56 bench (56, 22, 22; N = 100, B = 1, 16, 32, 64, 128 and 256).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from aligator_tpu_torch.gar import fused_riccati as FR
from aligator_tpu_torch.utils import cuda_build

HBM_BYTES_PER_S = 3.35e12
SPIN_CYCLES_PER_S = 2e9
CASES = (
    ("quadrotor", 12, 4, 6, 60, 16),
    ("jump", 36, 12, 0, 45, 16),
    ("lq long", 56, 22, 22, 2048, 1),
    ("walk", 56, 22, 0, 195, 16),
    ("walk mpc", 56, 22, 0, 195, 1),
) + tuple(("bench", 56, 22, 22, 100, B) for B in (1, 16, 32, 64, 128, 256))
GATE = 1e-4


def random_gains(gen, B, N, nx, nu, nc, dev):
    """Forward-sweep inputs: Acl = 0.9·I + 0.05·randn/√nx, K, Z and Vxx
    randn/√nx, the offsets, x0 and λ0 randn."""
    L = N + 1
    r = lambda *shape, scale=1.0: scale * torch.randn(*shape, device=dev, generator=gen)
    s = nx ** -0.5
    Acl = 0.9 * torch.eye(nx, device=dev) + r(B, L, nx, nx, scale=0.05 * s)
    g, v = FR._pack(r(B, L, nu), r(B, L, nc), r(B, L, nx), r(B, L, nu, nx, scale=s),
                    r(B, L, nc, nx, scale=s), Acl, r(B, L, nx, nx, scale=s), r(B, L, nx))
    return g, v, r(B, nx), r(B, nx)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` on the card, the stream held by a spin
    while the host queues the calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * (2 * reps * issue_s + 1e-3)))
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def halves_bytes(B, L, nx, nu, nc):
    """Bytes of the chain (Acl, yff, x0 in, xs out) and of the rows (K, Z,
    Vxx, the offsets, λ0 and xs in; u, v, λ out)."""
    chain = 4.0 * B * (L * (nx * nx + 2 * nx) + nx)
    rows = 4.0 * B * (L * (nu * nx + nc * nx + nx * nx + 2 * (nu + nc + nx) + nx) + nx)
    return chain, rows


def sweep_bytes(B, L, nx, nu, nc):
    knot_in = nu * nx + nc * nx + 2 * nx * nx + nu + nc + 2 * nx
    return 4.0 * B * (L * (knot_in + 2 * nx + nu + nc) + 2 * nx)


def max_rel_err(out, ref) -> float:
    """The largest error of the four outputs over their gates' scales."""
    return max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
               for a, b in zip(out, ref) if b.numel())


def time_plan(plan, g, v, x0, l0, reps, L) -> dict:
    out = dict(plan=str(plan))
    res = FR.forward_sweep_batched(g, v, x0, l0, plan=plan)
    torch.cuda.synchronize()
    out["rel_err"] = max_rel_err(res, FR.forward_sweep_batched_ref(g, v, x0, l0))
    out["sweep_ms"] = cuda_ms(lambda: FR.forward_sweep_batched(g, v, x0, l0, plan=plan), reps)
    _, _, parts = FR.forward_parts(g, v, x0, l0, plan)
    for name, fn in parts.items():
        if name != "sweep":
            out[f"{name}_ms"] = cuda_ms(fn, reps)
    if plan.kernel == "small" and FR.forward_copy(g.K.shape[-1], FR._rowwise_ptrs(g, v)) == 4:
        # cp.async copies of 16 bytes where bulk copies may be made
        outs, _, alt = FR.forward_parts(g, v, x0, l0, plan, bulk=False)
        alt["sweep"]()
        torch.cuda.synchronize()
        out["cp_async_rel_err"] = max_rel_err(outs, FR.forward_sweep_batched_ref(g, v, x0, l0))
        out["cp_async_sweep_ms"] = cuda_ms(alt["sweep"], reps)
        out["cp_async_chain_ms"] = cuda_ms(alt["chain"], reps)
    for k in ("sweep", "chain", "rows"):
        if f"{k}_ms" in out:
            out[f"{k}_us_per_knot"] = out[f"{k}_ms"] / L * 1e3
    return out


def split(label, nx, nu, nc, N, B, reps, dev, seed=0) -> dict:
    gen = torch.Generator(device=dev).manual_seed(seed)
    g, v, x0, l0 = random_gains(gen, B, N, nx, nu, nc, dev)
    L = N + 1
    plan = FR.forward_plan(nx, B)
    plans = [plan]
    if nx == FR.FORWARD_BENCH_NX:
        plans.append(FR.ForwardPlan("small", 64))
    vec = FR.forward_copy(nx, FR._rowwise_ptrs(g, v))
    cb, rb = halves_bytes(B, L, nx, nu, nc)
    out = dict(case=label, nx=nx, nu=nu, nc=nc, N=N, B=B, vec=vec, plan=str(plan),
               sweep_bound_ms=sweep_bytes(B, L, nx, nu, nc) / HBM_BYTES_PER_S * 1e3,
               chain_bound_ms=cb / HBM_BYTES_PER_S * 1e3,
               rows_bound_ms=rb / HBM_BYTES_PER_S * 1e3,
               ring=FR.forward_occupancy(nx, nu, nc, L, B))
    out["by_plan"] = [time_plan(p, g, v, x0, l0, reps, L) for p in plans]
    xs = FR.forward_sweep_batched(g, v, x0, l0)[0]
    M = torch.cat([g.K, g.Z, v.Vxx], 2).reshape(B * L, nu + nc + nx, nx)
    off = torch.cat([g.kff, g.zff, v.vx], 2).reshape(B * L, nu + nc + nx, 1)
    xv = xs.reshape(B * L, nx, 1)
    out["rows_library_ms"] = cuda_ms(lambda: torch.baddbmm(off, M, xv), reps)
    out["plain_ms"] = cuda_ms(lambda: FR.forward_sweep_batched_ref(g, v, x0, l0), 2)
    print(f"{label} nx={nx} nu={nu} nc={nc} N={N} B={B} (copies of {4 * vec} B; ring "
          f"{out['ring']}): bound {out['sweep_bound_ms']:.5f} ms (chain "
          f"{out['chain_bound_ms']:.5f}, rows {out['rows_bound_ms']:.5f}); rows yardstick "
          f"torch.baddbmm {out['rows_library_ms']:.4f} ms; plain version {out['plain_ms']:.3f} ms",
          flush=True)
    for r in out["by_plan"]:
        parts = ", ".join(f"{k[:-3]} {r[k]:.4f} ms ({r[k[:-3] + '_us_per_knot']:.3f} us a knot)"
                          for k in ("chain_ms", "rows_ms") if k in r)
        alt = "; ".join(f"{m} copies: sweep {r[m + '_sweep_ms']:.4f} ms, chain "
                        f"{r[m + '_chain_ms']:.4f} ms, max err {r[m + '_rel_err']:.3e}"
                        for m in ("cp_async",) if m + "_sweep_ms" in r)
        print(f"  {r['plan']}: sweep {r['sweep_ms']:.4f} ms ({r['sweep_us_per_knot']:.3f} us a "
              f"knot); {parts}; max err {r['rel_err']:.3e} of max(1, max|plain|)"
              f"{'; ' + alt if alt else ''}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", nargs=5, type=int, action="append", metavar=("NX", "NU", "NC",
                                                                             "N", "B"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_split: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    for src, log in cuda_build.build_all().items():
        if src == "riccati_forward":
            fn = ""
            for line in log.splitlines():
                if "Compiling entry function" in line or "Function properties for" in line:
                    fn = line.split("'")[1] if "'" in line else line
                elif "registers" in line or "spill" in line:
                    print(f"  ptxas {fn}: {line.strip()}")
    cases = [(f"case {i}", *c) for i, c in enumerate(args.case)] if args.case else CASES
    results = [split(*c, args.reps, dev) for c in cases]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, results=results), f, indent=1)
    worst = max(v for c in results for r in c["by_plan"] for k, v in r.items()
                if k.endswith("rel_err"))
    print(f"worst error {worst:.3e} (gate {GATE:g})")
    return 0 if worst <= GATE else 1


if __name__ == "__main__":
    raise SystemExit(main())
