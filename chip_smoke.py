"""GPU smoke run of the PyTorch/CUDA port (``aligator_tpu_torch``).

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``aligator_tpu_torch/csrc`` (nvcc,
sm_90a, into ``build/kernels``), holds each kernel against its plain
torch version on the card (every instantiation of K1 and K2, K2 at each
copy width), times K1 and K2 at B = 256 and 64 and K2's two halves
beside their bounds, runs the layout probe (the port of
``scripts/probe_mosaic.py``: each probe body against its plain version,
then timed per construct beside its library call), drives the main path
— the batched ProxDDP solve of the lqr56 box-constrained LQR (B = 256,
N = 100, 2 iterations, float32) and three MPC steps — through the
kernels, checks the results, and prints one JSON line of kernel reports
and a final status line. Any failed check raises, and the script exits
non-zero (the one exception, K1's recorded fault at µ = 1e-6, is printed
with its verdict; see ``K1_KNOWN_FAULTS``); without a CUDA device it exits
non-zero before doing anything.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from aligator_tpu_torch.convert import lqr_from_numpy, problem_from_numpy
from aligator_tpu_torch.gar import fused_riccati as FR
from aligator_tpu_torch.gar.riccati import knots_of
from aligator_tpu_torch.gar.utils import lqr_kkt_error
from aligator_tpu_torch.mpc import init_mpc_state, mpc_step
from aligator_tpu_torch.probes import layout_probe as LP
from aligator_tpu_torch.solvers.proxddp import ProxDDPSettings, solve
from aligator_tpu_torch.utils import cuda_build
from aligator_tpu_torch.utils.device import full_f32_matmuls

# lqr56: Talos-reduced widths of the flagship bench (bench.py:44-48)
NX, NU, NSTEPS, SOLVER_ITERS = 56, 22, 100, 2
BATCH, MPC_BATCH, MPC_STEPS = 256, 64, 3
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores (the kernels use plain FMA)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def lqr_bench_arrays(nx: int = NX, nu: int = NU, seed: int = 0) -> dict:
    """The bench's box-constrained LQR (bench.py:61-82) as numpy arrays:
    A = I + 0.05·randn/√nx, B = randn/√nx, c = 0.01·randn, Q = R = 0.01·I,
    Qf = I, |u| ≤ 0.5, x0 = 0.1·randn."""
    rng = np.random.default_rng(seed)
    A = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx)) / np.sqrt(nx)
    B = rng.standard_normal((nx, nu)) / np.sqrt(nx)
    c = 0.01 * rng.standard_normal(nx)
    x0 = 0.1 * rng.standard_normal(nx)
    return dict(A=A, B=B, c=c, Q=0.01 * np.eye(nx), R=0.01 * np.eye(nu),
                Qf=np.eye(nx), x0=x0, lower=np.full(nu, -0.5),
                upper=np.full(nu, 0.5))


def batch_x0(batch: int, nx: int = NX, seed: int = 1) -> np.ndarray:
    """The bench's batch of initial states (bench.py:108-109)."""
    return 0.1 * np.random.default_rng(seed).standard_normal((batch, nx))


def random_lq_arrays(rng, batch, N, nx, nu, nc) -> dict:
    """A batch of well-posed random constrained LQ problems (the shape of
    gar.random_lqr_problem with strict constraints; A = I + small noise so
    the cost-to-go stays bounded over long horizons). The unused terminal
    A, B, f are NaN: the kernels must never read them."""
    L = N + 1

    def spd(n):
        w = rng.standard_normal((batch, L, n, n))
        return w @ np.swapaxes(w, -1, -2) / n + np.eye(n)

    Q, R = spd(nx), spd(nu)
    S = 0.1 * rng.standard_normal((batch, L, nx, nu))
    A = np.eye(nx) + 0.05 * rng.standard_normal((batch, L, nx, nx)) / np.sqrt(nx)
    B = rng.standard_normal((batch, L, nx, nu)) / np.sqrt(nx)
    C = 0.5 * rng.standard_normal((batch, L, nc, nx))
    D = np.eye(nc, nu) + 0.1 * rng.standard_normal((batch, L, nc, nu))
    d = 0.1 * rng.standard_normal((batch, L, nc))
    C[:, 0] = D[:, 0] = d[:, 0] = C[:, N] = d[:, N] = 0.0
    R[:, N], S[:, N], D[:, N] = np.eye(nu), 0.0, 0.0
    r = rng.standard_normal((batch, L, nu))
    r[:, N] = 0.0
    A[:, N] = B[:, N] = np.nan
    f = 0.1 * rng.standard_normal((batch, L, nx))
    f[:, N] = np.nan
    z = lambda *s: np.zeros((batch,) + s)
    return dict(Q=Q, S=S, R=R, q=rng.standard_normal((batch, L, nx)), r=r, A=A,
                B=B, f=f, C=C, D=D, d=d, Gx=z(L, nx, 0), Gu=z(L, nu, 0),
                Gth=z(L, 0, 0), gamma=z(L, 0), G0=-np.tile(np.eye(nx), (batch, 1, 1)),
                g0=rng.standard_normal((batch, nx)))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events, after
    one warm-up call). A K2 sweep at B = 64 runs shorter than its wrapper
    takes to issue, so a spin on the card holds the stream while the host
    queues the timed calls, as the layout probe's ``time_one`` does: the
    events then time the card, not the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(LP.SPIN_CYCLES_PER_S * (2 * reps * issue_s + 1e-3)))
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def backward_cost(B, L, nx, nu, nc, refine):
    """(bytes, flops) the backward sweep needs: every knot field read once,
    every output written once; the arithmetic of the kernel per knot (the
    terminal knot skips the A/B products)."""
    m = nx + 1
    knot_in = nx * nx * 2 + nx * nu * 2 + nu * nu + nc * nx + nc * nu + 2 * nx + nu + nc
    knot_out = nu * nx + nc * nx + 2 * nx * nx + nu + nc + 2 * nx
    solve = 2 * nu * nu * m + 4 * nu * nc * m + 2 * nc * nc * m
    kkt = (nu ** 3 / 3 + 2 * nu * nu * nc + 2 * nc * nc * nu + nc ** 3 / 3
           + (1 + refine) * solve + refine * (2 * nu * nu + 4 * nu * nc) * m)
    hats = (2 * nx * nx + 4 * nx ** 3 + 4 * nu * nx * nx + 2 * nx * nu * nu
            + 2 * nx * nx + 2 * nx * nu)
    out = 2 * nx * nu * m + 2 * nx * (nu + nc) * m
    flops = B * (L * (kkt + out) + (L - 1) * hats)
    return 4.0 * B * (L * (knot_in + knot_out) + 1), flops


def forward_cost(B, L, nx, nu, nc):
    knot_in = nu * nx + nc * nx + 2 * nx * nx + nu + nc + 2 * nx
    knot_out = 2 * nx + nu + nc
    return 4.0 * B * (L * (knot_in + knot_out) + 2 * nx), 2.0 * B * L * (nu + nc + 2 * nx) * nx


def bound_ms(nbytes, flops):
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def ptx_label(name: str) -> str:
    """A short name for a mangled kernel or device function of the port's
    sources: its identifier (past the file-local namespaces) and integer
    template arguments."""
    if not name.startswith("_ZN"):
        return name[:60]
    pos = 3
    while True:
        m = re.match(r"\d+", name[pos:])
        if not m:
            return name[:60]
        n = int(m.group(0))
        ident = name[pos + len(m.group(0)):pos + len(m.group(0)) + n]
        pos += len(m.group(0)) + n
        if not ident.startswith(("_INTERNAL_", "_GLOBAL__N_")):
            break
    args = re.match(r"I((?:Lin?\d+E)+)E", name[pos:])
    if args:
        vals = [v.replace("n", "-") for v in re.findall(r"Li(n?\d+)E", args.group(1))]
        ident += "<" + ", ".join(vals) + ">"
    return ident


def print_ptxas(logs: dict) -> None:
    """Registers and spills of every kernel and device function, by name."""
    for src, log in logs.items():
        fn = ""
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)", line)
            if m:
                fn = ptx_label(m.group(1))
            elif "registers" in line or "spill" in line:
                print(f"  {src} {fn}: {line.strip()}")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def tol(ref, atol, mode) -> float:
    """The gate of a kernel check: ``atol`` at the small widths ("abs"),
    1e-4·max|ref| at the bench widths ("rel")."""
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    return atol if mode == "abs" else 1e-4 * max(scale, 1.0)


def check_k2(label, g, v, x0, l0, mode, seen) -> dict:
    """K2 against its plain version on the same inputs; records the
    instantiation and copy width in ``seen``."""
    seen.add(FR.forward_plan(g, v))
    fk = FR.forward_sweep_batched(g, v, x0, l0)
    torch.cuda.synchronize()
    fp = FR.forward_sweep_batched_ref(g, v, x0, l0)
    errs = {}
    for name, a, b in zip(("xs", "us", "vs", "lbds"), fk, fp):
        errs[name] = max_err(a, b)
        check(errs[name] <= tol(b, 1e-3, mode), f"K2 {name} {label}: {errs[name]}")
    return errs


def random_gains(gen, B, N, nx, nu, nc, dev):
    """Forward-sweep inputs drawn at random: Acl = 0.9·I + 0.05·randn/√nx
    (a stable closed loop over long horizons), K, Z and Vxx randn/√nx,
    the offsets randn."""
    L = N + 1
    r = lambda *shape, scale=1.0: scale * torch.randn(*shape, device=dev, generator=gen)
    s = nx ** -0.5
    Acl = 0.9 * torch.eye(nx, device=dev) + r(B, L, nx, nx, scale=0.05 * s)
    g, v = FR._pack(r(B, L, nu), r(B, L, nc), r(B, L, nx), r(B, L, nu, nx, scale=s),
                    r(B, L, nc, nx, scale=s), Acl, r(B, L, nx, nx, scale=s), r(B, L, nx))
    return g, v, r(B, nx), r(B, nx)


def offset_copy(t, k: int):
    """A contiguous copy of ``t`` that starts ``k`` floats into its storage,
    4·k bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    out = buf[k:].view(t.shape)
    out.copy_(t)
    return out


def forward_halves_cost(B, L, nx, nu, nc):
    """Bytes of each half of K2 (every input read once, every output
    written once): the chain reads Acl, yff, x0 and writes xs; the rows
    read K, Z, Vxx, kff, zff, vx, lbd0 and xs back, and write us, vs,
    lbds."""
    chain = 4.0 * B * (L * (nx * nx + 2 * nx) + nx)
    rows = 4.0 * B * (L * (nu * nx + nc * nx + nx * nx + 2 * (nu + nc + nx) + nx) + nx)
    return chain, rows


def k2_halves(g, v, x0, l0):
    """Times of K2's chain and rows kernels alone, their bytes bounds, and
    the rows' library yardstick: one torch.baddbmm of the offsets and
    [K; Z; Vxx] against xs over the B·L knots (timed here only)."""
    Bsz, L, nu, nx = g.K.shape
    nc = g.Z.shape[-2]
    (xs, *_), (chain, rows) = FR.forward_halves(g, v, x0, l0)
    chain_ms, rows_ms = cuda_ms(chain, 20), cuda_ms(rows, 20)
    M = torch.cat([g.K, g.Z, v.Vxx], 2).reshape(Bsz * L, nu + nc + nx, nx)
    off = torch.cat([g.kff, g.zff, v.vx], 2).reshape(Bsz * L, nu + nc + nx, 1)
    xv = xs.reshape(Bsz * L, nx, 1)
    lib_ms = cuda_ms(lambda: torch.baddbmm(off, M, xv), 20)
    cb, rb = forward_halves_cost(Bsz, L, nx, nu, nc)
    out = dict(chain_ms=chain_ms, chain_bound_ms=cb / HBM_BYTES_PER_S * 1e3, rows_ms=rows_ms,
               rows_bound_ms=rb / HBM_BYTES_PER_S * 1e3, rows_library_ms=lib_ms)
    print(f"K2 halves B={Bsz} L={L}: chain {chain_ms:.4f} ms (bound {out['chain_bound_ms']:.4f} "
          f"ms, {cb / 1e9:.4f} GB), rows {rows_ms:.4f} ms (bound {out['rows_bound_ms']:.4f} ms, "
          f"{rb / 1e9:.4f} GB), rows library torch.baddbmm {lib_ms:.4f} ms; "
          f"{'x'.join(map(str, FR.forward_plan(g, v)))}")
    return out


# A fault of K1 recorded in ROADMAP §C: at the bench widths and µ = 1e-6
# its explicit inverse R̂⁻¹ loses its definiteness in float32, the
# elimination of S = µI + D·R̂⁻¹·Dᵀ meets a non-positive pivot, and the gains
# come out NaN where the plain version's are finite. The case runs under
# the same gate and prints its verdict; a failure there is reported, not
# raised, so that the rest of the run is still checked.
K1_KNOWN_FAULTS = {(NX, NU, NU, 1e-6): "C5"}


def kernels_phase(dev):
    """K1 and K2 against their plain versions on the card. Returns the
    per-kernel report at the bench widths."""
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    # (B, N, nx, nu, nc, µ, tolerance mode): the small cases carry
    # test_gar_pallas.py's float32 tolerances (gains 2e-4, Vxx 1e-3, xs
    # 1e-3), as absolute errors, at nc = nu - 1, nc < nu - 1 and nc = 0 and
    # at both of its µ; they run K1's instantiation for widths read at
    # launch. At the bench widths (the instantiation with compiled widths;
    # N = 100, entries of Vxx up to ~1e3) the same float32 rounding
    # accumulates over 100 steps, so the bound is relative to the largest
    # entry of each output: 1e-4·max|·| (~840 ulp), at µ = 1e-6 as at 1e-2.
    cases = [(4, 9, 7, 3, nc, mu, "abs") for nc in (2, 1, 0) for mu in (1e-2, 1e-6)]
    cases += [(BATCH, NSTEPS, NX, NU, NU, mu, "rel") for mu in (1e-6, 1e-2)]
    reports, variants, k2_seen = [], set(), set()
    for Bsz, N, nx, nu, nc, mu_val, mode in cases:
        lq = lqr_from_numpy(random_lq_arrays(rng, Bsz, N, nx, nu, nc), device=dev,
                            dtype=torch.float32)
        knots = knots_of(lq)
        mu = torch.full((Bsz,), mu_val, device=dev)
        variants.add(FR.backward_variant(nx, nu, nc))
        gk, vk = FR.backward_sweep_batched(knots, mu)
        torch.cuda.synchronize()
        gp, vp = FR.backward_sweep_batched_ref(knots, mu)
        x0 = torch.randn(Bsz, nx, device=dev, generator=gen)
        l0 = torch.randn(Bsz, nx, device=dev, generator=gen)

        errs_b, failed = {}, []
        fault = K1_KNOWN_FAULTS.get((nx, nu, nc, mu_val))
        for name, atol in (("kff", 2e-4), ("zff", 2e-4), ("yff", 2e-4), ("K", 2e-4),
                           ("Z", 2e-4), ("Acl", 2e-4), ("Vxx", 1e-3), ("vx", 1e-3)):
            a, b = (getattr(gk, name), getattr(gp, name)) if hasattr(gk, name) else (
                getattr(vk, name), getattr(vp, name))
            check(bool(torch.isfinite(b).all()), f"plain K1 {name} finite at mu={mu_val:g}")
            errs_b[name] = max_err(a, b)
            ok = errs_b[name] <= tol(b, atol, mode)
            if fault is None:
                check(ok, f"K1 {name} B={Bsz} nc={nc} mu={mu_val:g}: {errs_b[name]}")
            elif not ok:
                failed.append(f"{name} ({int((~torch.isfinite(a)).sum())} non-finite)")
        if fault is not None:
            bad = int((~torch.isfinite(gk.kff)).flatten(1).any(1).sum())
            print(f"K1 at B={Bsz} N={N} nx={nx} nu={nu} nc={nc} mu={mu_val:g} "
                  f"{'FAILS' if failed else 'passes'} its gate (1e-4·max|·|)"
                  f"{' on ' + ', '.join(failed) if failed else ''}; problems with a "
                  f"non-finite kff {bad} of {Bsz}; plain version max|Vxx| "
                  f"{float(vp.Vxx.abs().max()):.4g}, max|kff| {float(gp.kff.abs().max()):.4g}: "
                  f"fault {fault}, ROADMAP §C")
        errs_f = check_k2(f"B={Bsz} nc={nc}", gp, vp, x0, l0, mode, k2_seen)
        print(f"kernels B={Bsz} N={N} nx={nx} nu={nu} nc={nc} mu={mu_val:g} (K1 "
              f"{FR.backward_variant(nx, nu, nc)} widths, K2 "
              f"{'x'.join(map(str, FR.forward_plan(gp, vp)))}): K1 max abs err "
              f"{json.dumps(errs_b)}; K2 max abs err {json.dumps(errs_f)}")
        reports.append(dict(lq=lq, knots=knots, mu=mu, gp=gp, vp=vp, x0=x0, l0=l0,
                            err_b=max(errs_b.values()), err_f=max(errs_f.values()),
                            dims=(Bsz, N + 1, nx, nu, nc)))

    check(variants == {"bench", "runtime"}, f"both K1 instantiations checked: {variants}")

    # K2 alone: the talos walk's widths (nc = 0, N = 195), the bench case's
    # first 8 problems copied 4 B and 8 B past a 16-byte boundary, odd and
    # wide nx at widths read at launch (random gains, stable closed loop)
    report = reports[-1]
    gp, vp, x0, l0 = (report[k] for k in ("gp", "vp", "x0", "l0"))
    for k in (1, 2):
        g8, v8 = (type(t)(*(offset_copy(a[:8].contiguous(), k) for a in t)) for t in (gp, vp))
        errs = check_k2(f"offset {4 * k} B", g8, v8, x0[:8].contiguous(), l0[:8].contiguous(),
                        "rel", k2_seen)
        print(f"kernels K2 B=8 L={NSTEPS + 1} nx={NX} nu={NU} nc={NU}, every input {4 * k} B "
              f"past a 16-byte boundary ({'x'.join(map(str, FR.forward_plan(g8, v8)))}): K2 max "
              f"abs err {json.dumps(errs)}")
    for Bsz, N, nx, nu, nc, mode in ((16, 195, NX, NU, 0, "rel"), (8, NSTEPS, 71, NU, NU, "rel"),
                                     (8, NSTEPS, 84, NU, NU, "rel"), (4, 30, 112, 3, 2, "abs")):
        g, v, gx0, gl0 = random_gains(gen, Bsz, N, nx, nu, nc, dev)
        errs = check_k2(f"nx={nx} nc={nc} N={N}", g, v, gx0, gl0, mode, k2_seen)
        print(f"kernels K2 B={Bsz} N={N} nx={nx} nu={nu} nc={nc} "
              f"({'x'.join(map(str, FR.forward_plan(g, v)))}): K2 max abs err {json.dumps(errs)}")
    want = {("bench", 4), ("bench", 2), ("bench", 1), ("runtime", 4), ("runtime", 1)}
    check(want <= k2_seen, f"K2 instantiations and copy widths checked: {sorted(k2_seen)}")

    # KKT residual of the fused solve on the first small problem, at
    # test_gar_pallas.py's float32 gate (5e-4)
    lq, mu = reports[0]["lq"], reports[0]["mu"]
    xs, us, vs, lbds, _ = FR.solve(lq, mu)
    kkt = float(lqr_kkt_error(lq, xs, us, vs, lbds, mu)["max"].max())
    print(f"fused solve KKT residual max {kkt:.3e}")
    check(kkt < 5e-4, "fused solve KKT residual")
    Bsz, L, nx, nu, nc = report["dims"]
    per_sm = FR.backward_blocks_per_sm(nx, nu, nc)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"K1 occupancy at nx={nx} nu={nu} nc={nc}: {per_sm} blocks per SM "
          f"({FR._backward_smem_bytes(nx, nu, nc)} B of shared memory per block), "
          f"{per_sm * n_sm} resident blocks on {n_sm} SMs for B={Bsz}")
    k2_per_sm, k2_smem = FR.forward_chain_occupancy(nx)
    print(f"K2 chain occupancy at nx={nx}: {k2_per_sm} blocks per SM ({k2_smem} B of "
          f"shared memory per block), {k2_per_sm * n_sm} resident blocks on {n_sm} SMs "
          f"for B={Bsz}")
    check(k2_per_sm >= 2, "two K2 chain blocks fit on an SM")

    # times at the bench widths: kernel vs plain version on the same inputs
    kn, mu = report["knots"], report["mu"]
    k1_ms = cuda_ms(lambda: FR.backward_sweep_batched(kn, mu), 10)
    k1_plain = cuda_ms(lambda: FR.backward_sweep_batched_ref(kn, mu), 2)
    k2_ms = cuda_ms(lambda: FR.forward_sweep_batched(gp, vp, x0, l0), 20)
    k2_plain = cuda_ms(lambda: FR.forward_sweep_batched_ref(gp, vp, x0, l0), 3)
    b1, by1 = bound_ms(*backward_cost(Bsz, L, nx, nu, nc, 1))
    b2, by2 = bound_ms(*forward_cost(Bsz, L, nx, nu, nc))
    # both at the MPC batch: the first MPC_BATCH problems of the same inputs
    kn64 = type(kn)(*(a[:MPC_BATCH].contiguous() for a in kn))
    k1_ms64 = cuda_ms(lambda: FR.backward_sweep_batched(kn64, mu[:MPC_BATCH]), 10)
    b1_64, _ = bound_ms(*backward_cost(MPC_BATCH, L, nx, nu, nc, 1))
    g64, v64 = (type(t)(*(a[:MPC_BATCH] for a in t)) for t in (gp, vp))
    x64, l64 = x0[:MPC_BATCH], l0[:MPC_BATCH]
    k2_ms64 = cuda_ms(lambda: FR.forward_sweep_batched(g64, v64, x64, l64), 20)
    b2_64, _ = bound_ms(*forward_cost(MPC_BATCH, L, nx, nu, nc))
    print(f"bench widths B={Bsz} L={L}: K1 {k1_ms:.4f} ms (plain {k1_plain:.3f} ms, "
          f"bound {b1:.4f} ms by {by1}); K2 {k2_ms:.4f} ms (plain {k2_plain:.3f} ms, "
          f"bound {b2:.4f} ms by {by2})")
    print(f"bench widths B={MPC_BATCH} L={L}: K1 {k1_ms64:.4f} ms (bound {b1_64:.4f} ms); "
          f"K2 {k2_ms64:.4f} ms (bound {b2_64:.4f} ms)")
    halves = k2_halves(gp, vp, x0, l0)
    halves64 = k2_halves(g64, v64, x64, l64)
    return [
        dict(name="riccati_backward", route="cuda",
             source="aligator_tpu_torch/csrc/riccati_backward.cu",
             replaces="aligator_tpu/gar/pallas_riccati.py:225",
             max_abs_err=report["err_b"], ms=k1_ms, plain_ms=k1_plain,
             bound_ms=b1, bound_by=by1, library_ms=None,
             ms_b64=k1_ms64, bound_ms_b64=b1_64),
        dict(name="riccati_forward", route="cuda",
             source="aligator_tpu_torch/csrc/riccati_forward.cu",
             replaces="aligator_tpu/gar/pallas_riccati.py:549",
             max_abs_err=report["err_f"], ms=k2_ms, plain_ms=k2_plain,
             bound_ms=b2, bound_by=by2, library_ms=None,
             ms_b64=k2_ms64, bound_ms_b64=b2_64, kernels_per_launch=2,
             **halves, rows_library_call="torch.baddbmm(offsets, [K; Z; Vxx], xs) "
             "over the B*L knots, rows half only",
             halves_b64=halves64),
    ]


def probe_phase(dev):
    """P1, the layout probe (``scripts/probe_mosaic.py``; on no solver
    path): each body against its plain version at the probe's shapes and
    both repeat counts, then timed per construct, with its plain version
    and its library calls, by the slope over the repeat counts. Bound of
    one construct: its operations over the float32 FMA rate (its operands
    are on chip after the launch's first read); beside it the bytes bound
    of one launch, every input read once and the output written once."""
    rows = []
    for r in LP.run(dev):
        p = r["probe"]
        ms = {k: r[k]["per_s"] * 1e3 for k in ("kernel", "plain", "library")}
        bound = p.flops / F32_FLOP_PER_S * 1e3
        launch_bytes_ms = p.nbytes / HBM_BYTES_PER_S * 1e3
        print(f"probe {p.tag} {p.name}: per construct kernel {ms['kernel'] * 1e3:.6f} us, "
              f"plain {ms['plain'] * 1e3:.6f} us, library {ms['library'] * 1e3:.6f} us, "
              f"bound {bound * 1e3:.6f} us ({p.flops} operations); launch @rep"
              f"{p.reps[0]} {r['kernel']['launch_s'] * 1e3:.6f} ms, bytes bound "
              f"{launch_bytes_ms * 1e3:.6f} us ({p.nbytes} B); max abs err "
              f"{r['max_abs_err']:.3e}")
        rows.append(dict(
            name=p.name, tag=p.tag, route="cuda",
            source="aligator_tpu_torch/csrc/layout_probe.cu", replaces=p.replaces,
            max_abs_err=r["max_abs_err"], ms=ms["kernel"], plain_ms=ms["plain"],
            bound_ms=bound, bound_by="operations", library_ms=ms["library"],
            per="construct", launch_ms=r["kernel"]["launch_s"] * 1e3,
            launch_bytes_bound_ms=launch_bytes_ms))
    return rows


def bench_settings(lq_solver: str, **kw) -> ProxDDPSettings:
    """bench.py:103-107: fixed 2-iteration batched solves."""
    base = dict(tol=1e-7, mu_init=1e-2, max_iters=SOLVER_ITERS,
                max_al_iters=SOLVER_ITERS, lq_solver=lq_solver)
    base.update(kw)
    return ProxDDPSettings(**base)


def counted() -> dict:
    """Each kernel row's wrapper, whose ``launches`` counts its launches
    (both bmm probes share ``batched_mm``)."""
    return {"riccati_backward": FR.backward_sweep_batched,
            "riccati_forward": FR.forward_sweep_batched,
            **{p.name: p.kernel for p in LP.probes()}}


def reset_counts():
    for w in counted().values():
        w.launches = 0


def read_counts() -> dict:
    return {name: w.launches for name, w in counted().items()}


def slice_phase(dev):
    """The main path: lqr56 / N = 100 / B = 256, two ProxDDP iterations
    through the kernels, against the serial torch path on the card."""
    arr = lqr_bench_arrays()
    x0s = batch_x0(BATCH)
    problem = problem_from_numpy(
        arr["A"], arr["B"], arr["c"], arr["Q"], arr["R"], arr["Qf"], x0s, NSTEPS,
        arr["lower"], arr["upper"], device=dev, dtype=torch.float32)

    reset_counts()
    res = solve(problem, bench_settings("pallas"))
    torch.cuda.synchronize()
    launches = read_counts()
    k1, k2 = launches["riccati_backward"], launches["riccati_forward"]
    n_iters = int(res.num_iters.max())
    print(f"slice: launches {json.dumps(launches)}, iterations "
          f"max {n_iters}, prim_infeas max {float(res.prim_infeas.max()):.3e}")
    check(k1 == k2 >= n_iters >= 1, "kernel launch counts")
    check(tuple(res.xs.shape) == (BATCH, NSTEPS + 1, NX)
          and bool(torch.isfinite(res.xs).all()) and bool(torch.isfinite(res.us).all()),
          "slice outputs finite, of the expected shape")

    res_s = solve(problem, bench_settings("serial"))
    torch.cuda.synchronize()
    dx, du = max_err(res.xs, res_s.xs), max_err(res.us, res_s.us)
    print(f"slice: fused vs serial on the card: max|dxs| {dx:.3e} max|dus| {du:.3e}")
    # float32, two Cholesky orders over N = 100 steps; |x| ~ 0.3, |u| ~ 0.5
    check(dx < 1e-3 and du < 1e-3, "fused vs serial solve")
    check(bool((res.num_iters == res_s.num_iters).all()), "iteration counts agree")

    # host-clock rates of whole solves, in turns; the median of 3 each
    rates = {}
    for name in ("pallas", "serial") * 3:
        t0 = time.perf_counter()
        solve(problem, bench_settings(name))
        torch.cuda.synchronize()
        rates.setdefault(name, []).append(BATCH / (time.perf_counter() - t0))
    print(f"slice: solves/s fused {rates['pallas']} (median "
          f"{float(np.median(rates['pallas'])):.1f}), serial {rates['serial']} "
          f"(median {float(np.median(rates['serial'])):.1f})")
    profile_solve(problem)

    # a small 2-iteration solve on the card against the CPU float64 solve
    small = lqr_bench_arrays(8, 4, seed=0)
    xs_small = batch_x0(4, 8)
    build = lambda d, dt: problem_from_numpy(
        small["A"], small["B"], small["c"], small["Q"], small["R"], small["Qf"],
        xs_small, 10, small["lower"], small["upper"], device=d, dtype=dt)
    r_gpu = solve(build(dev, torch.float32), bench_settings("pallas"))
    r_cpu = solve(build("cpu", torch.float64), bench_settings("serial"))
    ds = max_err(r_gpu.xs.double().cpu(), r_cpu.xs)
    print(f"small solve card f32 vs CPU f64: max|dxs| {ds:.3e}")
    check(ds < 1e-4, "small solve against the CPU float64 reference")
    return launches


def profile_solve(problem):
    """Where the fused solve's time goes: one solve traced by
    torch.profiler, the device's busy and idle share of its wall time, and
    the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(problem, bench_settings("pallas"))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events, without the record_function ranges mirrored there
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print("profile: the profiler recorded no device time (not measured)")
        return
    # device busy time = the union of the kernels' intervals
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile: traced solve wall {wall_us / 1e3:.3f} ms, {len(kernels)} device "
          f"kernels, sum of kernel times {sum(by_name.values()) / 1e3:.3f} ms, device "
          f"busy (union) {busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}")
    for name, us in top:
        print(f"  {us / 1e3:9.3f} ms  {name[:90]}")


def mpc_phase(dev):
    arr = lqr_bench_arrays()
    x0s = batch_x0(MPC_BATCH, seed=3)
    problem = problem_from_numpy(
        arr["A"], arr["B"], arr["c"], arr["Q"], arr["R"], arr["Qf"], x0s, NSTEPS,
        arr["lower"], arr["upper"], device=dev, dtype=torch.float32)
    # bench.py:449-452: the lqr56 MPC cycle settings
    settings = bench_settings("pallas", tol=1e-5)
    state = init_mpc_state(problem)
    rng = np.random.default_rng(3)
    reset_counts()
    lats, per_step = [], []
    for _ in range(MPC_STEPS):
        x = torch.as_tensor(0.1 * rng.standard_normal((MPC_BATCH, NX)),
                            dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        u, state, res, problem = mpc_step(problem, settings, x, state)
        torch.cuda.synchronize()
        lats.append((time.perf_counter() - t0) * 1e3)
        per_step.append(read_counts()["riccati_backward"] - sum(per_step))
        check(tuple(u.shape) == (MPC_BATCH, NU) and bool(torch.isfinite(u).all()),
              "MPC control finite, of the expected shape")
        check(bool(torch.isfinite(state.xs).all()), "MPC warm start finite")
    counts = read_counts()
    k1, k2 = counts["riccati_backward"], counts["riccati_forward"]
    print(f"mpc: {MPC_STEPS} steps at B={MPC_BATCH}, step ms {lats}, launches "
          f"K1={k1} K2={k2} (K1 per step {per_step})")
    check(k1 == k2 >= MPC_STEPS, "MPC kernel launch counts")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    full_f32_matmuls()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__} (CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    print_ptxas(logs)

    kernels = kernels_phase(dev) + probe_phase(dev)
    launches = slice_phase(dev)
    mpc_phase(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
