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
kernels, then the LQ solvers behind ``lq_solver`` (parallel, stagedense,
assoc, the dense oracle: each against the serial recursion in float64,
the bench solve through each, and one problem at N = 2048 through each
beside the fused kernels), then the second path: the talos walk at its published size
(N = 195, 16 perturbed scenarios, float32, solved to convergence through
K1's walk instantiation and K2, against the serial path and a float64
solve on the card) and its MPC cycle at B = 1; then the solvers of slice
4: the lqr56 chain without its box by FDDP and by fused ProxDDP, the
walk's 16 scenarios by FDDP in float64 and by fused ProxDDP with the
nonlinear rollout through K1's gains, and the pendulum example's FDDP,
filter + nonlinear + box and exact-Hessian solves on the card against the
CPU (both in a child process beside the walk's solves); then the examples
of slice 5: the quadrotor (an SE(3) free flyer past a convex mug and a
box pillar, N = 60) as 16 perturbed scenarios in float32 through K1's
instantiation for widths read at launch and K2 (nx = 12, nu = 4, nc = 6),
against the serial path, a float64 solve and its physical outcomes, and
the seven other examples (the LQR, the SE(2) car, the cartpole, the
acrobot, the UR5 reach, obstacle and ballistic throw) in float64 on the
card against the CPU (child processes beside the solvers phase); then the
legged family of slice 6: the solo-12 jump (N = 45, a flight phase with
every contact off) as 16 perturbed scenarios in float32 through K1 and
K2 at nx = 36, nu = 12, nc = 0 (every kernel call held to its plain
version, and each knot to its own step by its backward error in
float64), against the serial path, a float64 solve and the jump's
outcome; the humanoid squat (kinodynamics) and the centroidal CoM shift
in float64 on the card against the CPU, with the minimum-norm static
balance of the quadruped and the humanoid; and the jump exported as a
JSON spec and rebuilt on the card (child processes too). It
checks the results and prints one JSON line of kernel reports and a
final status line. Any
failed check raises, and the script exits non-zero (the one exception,
K1 at the bench widths and µ = 1e-6, where the JAX Pallas kernel fails
too, is printed with its verdict; see ``K1_REFERENCE_BEHAVIOUR``);
without a CUDA device it exits non-zero before doing anything.
"""

from __future__ import annotations

import contextlib
import json
import multiprocessing
import re
import subprocess
import sys
import time

import numpy as np
import torch

from aligator_tpu_torch.convert import lqr_from_numpy, problem_from_numpy
from aligator_tpu_torch.dynamics.multibody import floating_base_actuation
from aligator_tpu_torch.examples import centroidal as TC
from aligator_tpu_torch.examples import humanoid_squat as TH
from aligator_tpu_torch.examples import quadrotor_obstacles as TQ
from aligator_tpu_torch.examples import solo_jump as TJ
from aligator_tpu_torch.examples import talos_walk as TW
from aligator_tpu_torch.examples.pendulum import create_pendulum_problem
from aligator_tpu_torch.gar import assoc as GA
from aligator_tpu_torch.gar import dense as GD
from aligator_tpu_torch.gar import fused_riccati as FR
from aligator_tpu_torch.gar import parallel as GP
from aligator_tpu_torch.gar import riccati as GR
from aligator_tpu_torch.gar import stagedense as GSD
from aligator_tpu_torch.gar.riccati import knots_of
from aligator_tpu_torch.gar.utils import lqr_kkt_error
from aligator_tpu_torch.io import problem_from_spec, problem_to_spec
from aligator_tpu_torch.mpc import init_mpc_state, mpc_step
from aligator_tpu_torch.multibody.algorithms import frame_placement
from aligator_tpu_torch.multibody.contact import (
    anchor_at_configuration,
    make_contact_set,
    underactuated_constrained_inverse_dynamics,
)
from aligator_tpu_torch.multibody.model import (
    build_humanoid,
    build_quadruped,
    humanoid_half_sitting,
    quadruped_standing,
)
from aligator_tpu_torch.multibody.urdf import model_to_urdf
from aligator_tpu_torch.problem import compute_derivatives, us_default_init, xs_default_init
from aligator_tpu_torch.probes import layout_probe as LP
from aligator_tpu_torch.solvers import fddp as FD
from aligator_tpu_torch.solvers.fddp import FDDPSettings, fddp_solve
from aligator_tpu_torch.solvers.proxddp import ProxDDPSettings, solve
from aligator_tpu_torch.utils import cuda_build
from aligator_tpu_torch.utils.device import full_f32_matmuls
from aligator_tpu_torch.utils.tree import tree_map

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


def check_k1(label, knots, mu) -> tuple:
    """K1 against its plain version on the same inputs under the
    bench-widths gate 1e-4·max|·|: (kernel gains, plain gains, plain
    values, max abs err per output)."""
    gk, vk = FR.backward_sweep_batched(knots, mu)
    torch.cuda.synchronize()
    gp, vp = FR.backward_sweep_batched_ref(knots, mu)
    errs = {}
    for name in ("kff", "yff", "K", "Acl", "Vxx", "vx"):
        a, b = (getattr(gk, name), getattr(gp, name)) if hasattr(gk, name) else (
            getattr(vk, name), getattr(vp, name))
        errs[name] = max_err(a, b)
        check(errs[name] <= tol(b, 0.0, "rel"), f"K1 {label} {name}: {errs[name]}")
    return gk, gp, vp, errs


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


# K1 at the bench widths and µ = 1e-6: its explicit inverse R̂⁻¹ loses its
# definiteness in float32, the elimination of S = µI + D·R̂⁻¹·Dᵀ meets a
# non-positive pivot, and the gains come out NaN where the plain version
# (the serial Cholesky recursion) is finite. The JAX Pallas kernel fails
# on the same input (tests/test_torch_walk.py; ROADMAP §C lists it as
# reference behaviour). The case runs under the same gate and prints its
# verdict; a failure there is reported, not raised.
K1_REFERENCE_BEHAVIOUR = {(NX, NU, NU, 1e-6): "reference behaviour (the TPU kernel fails here too)"}


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
        known = K1_REFERENCE_BEHAVIOUR.get((nx, nu, nc, mu_val))
        for name, atol in (("kff", 2e-4), ("zff", 2e-4), ("yff", 2e-4), ("K", 2e-4),
                           ("Z", 2e-4), ("Acl", 2e-4), ("Vxx", 1e-3), ("vx", 1e-3)):
            a, b = (getattr(gk, name), getattr(gp, name)) if hasattr(gk, name) else (
                getattr(vk, name), getattr(vp, name))
            check(bool(torch.isfinite(b).all()), f"plain K1 {name} finite at mu={mu_val:g}")
            errs_b[name] = max_err(a, b)
            ok = errs_b[name] <= tol(b, atol, mode)
            if known is None:
                check(ok, f"K1 {name} B={Bsz} nc={nc} mu={mu_val:g}: {errs_b[name]}")
            elif not ok:
                failed.append(f"{name} ({int((~torch.isfinite(a)).sum())} non-finite)")
        if known is not None:
            bad = int((~torch.isfinite(gk.kff)).flatten(1).any(1).sum())
            print(f"K1 at B={Bsz} N={N} nx={nx} nu={nu} nc={nc} mu={mu_val:g} "
                  f"{'FAILS' if failed else 'passes'} its gate (1e-4·max|·|)"
                  f"{' on ' + ', '.join(failed) if failed else ''}; problems with a "
                  f"non-finite kff {bad} of {Bsz}; plain version max|Vxx| "
                  f"{float(vp.Vxx.abs().max()):.4g}, max|kff| {float(gp.kff.abs().max()):.4g}: "
                  f"{known}, ROADMAP §C")
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


def trace_device(fn, host_ops: bool = True):
    """Run ``fn`` once under torch.profiler: (host wall µs, the device
    kernels, their busy time as the union of their intervals in µs, device
    time by kernel name). Empty when the profiler records no device time.
    ``host_ops=False`` records the device side only, for runs of ~10⁵
    kernels whose host operations would swamp the trace. The kernels are
    read from the profiler's raw events: building its event tree costs
    minutes at ~10⁵–10⁶ kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        # once the process has taken large traces, the first kernels of a
        # trace are missing from it, 2 to 16 of them as seen on an H100
        # (K1, the second kernel of the fused row at B = 1, N = 2048, among
        # them, with or without a 1 s pause first): 256 spin kernels go
        # first and are left out
        for _ in range(256):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events, without the record_function ranges mirrored there
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
               and "spin_kernel" not in e.name()]
    if not kernels:
        return wall_us, [], 0.0, {}
    spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3) for e in kernels)
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
        by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e3
    return wall_us, kernels, busy, by_name


def profile_solve(problem):
    """Where the fused solve's time goes: one solve traced by
    torch.profiler, the device's busy and idle share of its wall time, and
    the kernels that took the most device time."""
    wall_us, kernels, busy, by_name = trace_device(
        lambda: solve(problem, bench_settings("pallas")))
    if not kernels:
        print("profile: the profiler recorded no device time (not measured)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile: traced solve wall {wall_us / 1e3:.3f} ms, {len(kernels)} device "
          f"kernels, sum of kernel times {sum(by_name.values()) / 1e3:.3f} ms, device "
          f"busy (union) {busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}")
    for name, us in top:
        print(f"  {us / 1e3:9.3f} ms  {name[:90]}")


# The LQ-solver layer (gar.parallel, gar.stagedense, gar.assoc, gar.dense):
# f64 exactness at the lqr56 widths, the bench sweep of bench.py:49-53
# (PARALLEL_LEGS = 4), and one long-horizon problem at B = 1.
LQ_EXACT_BATCH, LQ_EXACT_LEGS, LQ_EXACT_MUS = 4, (2, 4, 8), (1e-2, 1e-6)
LQ_LONG_N, LQ_LONG_LEGS, LQ_LONG_MU = 2048, (8, 32), 1e-2


def lq_solvers(legs) -> dict:
    """name → solve(lq, µ) → (xs, us, vs, lbdas), for every LQ solver of
    the port but the fused one."""
    return {"serial": lambda lq, mu: GR.solve(lq, mu)[:4],
            **{f"parallel J={J}": (lambda lq, mu, J=J: GP.parallel_solve(lq, mu, J))
               for J in legs},
            "stagedense": lambda lq, mu: GSD.solve(lq, mu)[:4],
            "assoc": lambda lq, mu: GA.solve(lq, mu)[:4]}


def rel_err(out, ref) -> float:
    """max over (xs, us, vs, λs) of max|Δ| / max|ref|; inf when non-finite."""
    errs = []
    for a, b in zip(out, ref):
        if not bool(torch.isfinite(a).all()):
            return float("inf")
        errs.append(max_err(a, b) / max(float(b.abs().max()), 1e-30) if b.numel() else 0.0)
    return max(errs)


def count_syncs(fn):
    """(result of fn, the host syncs torch flags while fn runs, their
    Python call sites)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    return out, len(syncs), sorted({f"{w.filename.split('/')[-1]}:{w.lineno}" for w in syncs})


def lq_phase(dev):
    """The LQ solvers behind ProxDDP's ``lq_solver``, on the card: each
    against the serial recursion in float64, the bench's batched solve
    through each (float32, gated against the fused solve), and a single
    long-horizon problem through each with its wall, kernels, busy time
    and host syncs (the fused row there goes through K1 and K2)."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(21)
    # float64 exactness: max|Δ| ≤ 1e-8·max|·| against the serial recursion
    lq = lqr_from_numpy(random_lq_arrays(rng, LQ_EXACT_BATCH, NSTEPS, NX, NU, NU), device=dev)
    small = lqr_from_numpy(random_lq_arrays(rng, LQ_EXACT_BATCH, 9, 7, 3, 2), device=dev)
    check(lq.dtype == torch.float64, "float64 LQs")
    for mu in LQ_EXACT_MUS:
        solvers = lq_solvers(LQ_EXACT_LEGS)
        ref = solvers.pop("serial")(lq, mu)
        errs = {name: rel_err(fn(lq, mu), ref) for name, fn in solvers.items()}
        errs["dense_oracle (N=9, nx=7)"] = rel_err(GD.dense_solve(small, mu),
                                                   GR.solve(small, mu)[:4])
        print(f"lq f64: B={LQ_EXACT_BATCH} N={NSTEPS} nx={NX} nu={NU} nc={NU} mu={mu:g}, "
              f"max|d|/max|.| against serial: {json.dumps(errs)}")
        for name, e in errs.items():
            # the assoc penalty form loses ~eps/mu: gated at mu = 1e-2 only
            if name != "assoc" or mu >= 1e-2:
                check(e <= 1e-8, f"lq f64 {name} mu={mu:g}: {e}")

    # the bench configuration through each solver, gated against the fused
    arr = lqr_bench_arrays(NX, NU)
    problem = problem_from_numpy(
        arr["A"], arr["B"], arr["c"], arr["Q"], arr["R"], arr["Qf"], batch_x0(BATCH, NX),
        NSTEPS, arr["lower"], arr["upper"], device=dev, dtype=torch.float32)
    rows = {"fused": bench_settings("pallas"), "serial": bench_settings("serial"),
            "parallel J=4": bench_settings("parallel", lq_num_legs=4),
            "stagedense": bench_settings("stagedense"), "assoc": bench_settings("assoc")}
    fused = solve(problem, rows["fused"])
    rates = {}
    for name, settings in rows.items():
        res = solve(problem, settings)
        rel = float(((res.traj_cost - fused.traj_cost).abs()
                     / fused.traj_cost.abs().clamp(min=1.0)).max())
        same = bool((res.num_iters == fused.num_iters).all())
        check(bool(torch.isfinite(res.xs).all()) and rel <= 1e-3 and same,
              f"lq bench {name}: traj cost rel {rel:.3e}, equal iterations {same}")
        rate = []
        for _ in range(3):
            t0 = time.perf_counter()
            solve(problem, settings)
            torch.cuda.synchronize()
            rate.append(BATCH / (time.perf_counter() - t0))
        rates[name] = float(np.median(rate))
        print(f"lq bench: {name}: B={BATCH} N={NSTEPS} {SOLVER_ITERS} iterations, traj cost "
              f"rel to fused {rel:.3e}, solves/s {[round(r, 1) for r in rate]} (median "
              f"{rates[name]:.1f})")

    # one problem, a long horizon: wall, device kernels and busy time, syncs
    lq = lqr_from_numpy(random_lq_arrays(rng, 1, LQ_LONG_N, NX, NU, NU), device=dev,
                        dtype=torch.float32)
    mu = LQ_LONG_MU
    solvers = lq_solvers(LQ_LONG_LEGS)
    del solvers["stagedense"]  # O(N) like serial, and not the question here
    solvers["pallas"] = lambda lq, mu: FR.forward(lq, FR.backward(lq, mu))
    reset_counts()
    ref, table = None, {}
    for name, fn in solvers.items():
        run = lambda: fn(lq, mu)
        out = run()  # the result, and a warm-up: one-time set-ups are not counted
        _, syncs, where = count_syncs(run)
        ref = out if name == "serial" else ref
        err = rel_err(out, ref)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        # serial issues ~10⁶ host operations, which would swamp the trace
        _, kern, busy, by_name = trace_device(run, host_ops=name != "serial")
        ours = sorted(n for n in by_name if "riccati" in n)
        # a trace of the fused row that holds no K1 has not seen the sweep
        seen = bool(kern) and (name != "pallas" or any("backward" in n for n in ours))
        table[name] = dict(wall_ms=float(np.median(walls)), kernels=len(kern) if kern else None,
                           busy_ms=busy / 1e3 if seen else None, syncs=syncs, err=err)
        print(f"lq long: {name}: B=1 N={LQ_LONG_N} nx={NX} nu={NU} nc={NU} mu={mu:g}, wall ms "
              f"{[round(w, 3) for w in walls]} (median {table[name]['wall_ms']:.3f}), device "
              f"kernels {len(kern) if kern else 'not measured'}, busy ms "
              f"{'%.3f' % (busy / 1e3) if seen else 'not measured'}"
              f"{f' (the trace holds {ours})' if name == 'pallas' else ''}, host syncs "
              f"{syncs} {where}, max|d|/max|.| against serial {err:.3e}")
        check(err <= 1e-3, f"lq long {name} against serial: {err}")
    launches = read_counts()
    k1, k2 = launches["riccati_backward"], launches["riccati_forward"]
    check(k1 >= 1 and k2 >= 1, "the long-horizon fused row went through K1 and K2")
    # K1 and K2 alone at that shape, beside their bounds
    knots = knots_of(lq)
    mu_t = torch.full((1,), mu, device=dev)
    g, v = FR.backward_sweep_batched(knots, mu_t)
    x0 = torch.zeros(1, NX, device=dev)
    k1_ms = cuda_ms(lambda: FR.backward_sweep_batched(knots, mu_t), 3)
    k2_ms = cuda_ms(lambda: FR.forward_sweep_batched(g, v, x0, x0), 10)
    b1, by1 = bound_ms(*backward_cost(1, LQ_LONG_N + 1, NX, NU, NU, 1))
    b2, by2 = bound_ms(*forward_cost(1, LQ_LONG_N + 1, NX, NU, NU))
    print(f"lq long: K1 alone at B=1 L={LQ_LONG_N + 1} {k1_ms:.4f} ms (bound {b1:.4f} ms by "
          f"{by1}, {k1_ms / (LQ_LONG_N + 1) * 1e3:.2f} us per knot); K2 {k2_ms:.4f} ms (bound "
          f"{b2:.4f} ms by {by2}); launches in the comparison K1={k1} K2={k2}")
    print(f"lq long summary: {json.dumps(table)}")
    print(f"lq phase: {time.perf_counter() - t_phase:.1f} s")


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


# The talos walk (bench.py:317-437): T_ss = 60, T_ds = 25, so N = 195;
# nq = 29, nv = 28, ndx = 56, nu = 22, nc = 0; 16 scenarios whose joint
# velocities are perturbed by 0.01·N(0, 1) from default_rng(7).
WALK_TSS, WALK_TDS, WALK_BATCH = 60, 25, 16
WALK_SETTINGS = dict(tol=1e-4, dual_tol=1e-4, mu_init=1e-8, max_iters=40, riccati_refine=1,
                     cost_scale=1e-4, lq_refine_full=1)
WALK_MPC_SETTLE, WALK_MPC_STEPS = 3, 5


def walk_scenarios(problem, model, batch: int = WALK_BATCH):
    """The walk's 16 scenarios: x0 with the joint velocities perturbed by
    0.01·N(0, 1) from default_rng(7) (bench.py:335-340); the first
    ``batch`` of them for another batch size."""
    dv = 0.01 * np.random.default_rng(7).standard_normal((batch, model.nv)).astype(np.float32)
    x0 = problem.x0.cpu().numpy()
    x0s = np.concatenate([np.tile(x0[:model.nq], (batch, 1)), x0[model.nq:] + dv], axis=1)
    return problem.replace_x0(torch.as_tensor(x0s, dtype=problem.x0.dtype,
                                              device=problem.x0.device))


def k1_walk_check(dev):
    """K1's walk instantiation <56, 22, 0> against its plain version at the
    walk's batch and horizon (B = 16, N = 195), at the walk's µ_init and
    at 1e-2, under the bench-widths gate 1e-4·max|·|; then K1 and K2 timed
    there and K1 at the MPC batch B = 1, each beside its bound."""
    Bsz, N, nx, nu, nc = WALK_BATCH, 2 * WALK_TSS + 3 * WALK_TDS, NX, NU, 0
    check(FR.backward_variant(nx, nu, nc) == "walk", "the walk's widths take K1's walk "
          "instantiation")
    lq = lqr_from_numpy(random_lq_arrays(np.random.default_rng(5), Bsz, N, nx, nu, nc),
                        device=dev, dtype=torch.float32)
    knots = knots_of(lq)
    gains, errs = {}, {}
    for mu_val in (1e-8, 1e-2):
        mu = torch.full((Bsz,), mu_val, device=dev)
        gk, gp, vp, e = check_k1(f"walk mu={mu_val:g}", knots, mu)
        gains[mu_val], errs[mu_val] = (gk, gp, vp), e
        print(f"kernels K1 walk widths B={Bsz} N={N} nx={nx} nu={nu} nc={nc} mu={mu_val:g} "
              f"({FR.backward_variant(nx, nu, nc)}): max abs err {json.dumps(e)}")
    dk = max_err(gains[1e-8][0].kff, gains[1e-2][0].kff)
    dK = max_err(gains[1e-8][0].K, gains[1e-2][0].K)
    print(f"K1 walk widths: with nc = 0, mu from 1e-8 to 1e-2 moves kff by {dk:.3e} and K by "
          f"{dK:.3e} (max |kff| {float(gains[1e-2][0].kff.abs().max()):.4g})")
    _, gp, vp = gains[1e-8]
    mu = torch.full((Bsz,), 1e-8, device=dev)
    L = N + 1
    k1_ms = cuda_ms(lambda: FR.backward_sweep_batched(knots, mu), 10)
    k1_plain = cuda_ms(lambda: FR.backward_sweep_batched_ref(knots, mu), 2)
    kn1 = type(knots)(*(a[:1].contiguous() for a in knots))
    k1_ms1 = cuda_ms(lambda: FR.backward_sweep_batched(kn1, mu[:1]), 10)
    gen = torch.Generator(device=dev).manual_seed(5)
    x0 = torch.randn(Bsz, nx, device=dev, generator=gen)
    l0 = torch.randn(Bsz, nx, device=dev, generator=gen)
    errs_f = check_k2(f"walk B={Bsz}", gp, vp, x0, l0, "rel", set())
    k2_ms = cuda_ms(lambda: FR.forward_sweep_batched(gp, vp, x0, l0), 20)
    k2_plain = cuda_ms(lambda: FR.forward_sweep_batched_ref(gp, vp, x0, l0), 3)
    b1, by1 = bound_ms(*backward_cost(Bsz, L, nx, nu, nc, 1))
    b1_1, by1_1 = bound_ms(*backward_cost(1, L, nx, nu, nc, 1))
    b2, by2 = bound_ms(*forward_cost(Bsz, L, nx, nu, nc))
    per_sm = FR.backward_blocks_per_sm(nx, nu, nc)
    print(f"walk widths B={Bsz} L={L}: K1 {k1_ms:.4f} ms (plain {k1_plain:.3f} ms, bound "
          f"{b1:.4f} ms by {by1}, {k1_ms / b1:.1f}x; {k1_ms / L * 1e3:.2f} us per knot; "
          f"{per_sm} blocks per SM); K1 at B=1 {k1_ms1:.4f} ms (bound {b1_1:.4f} ms by "
          f"{by1_1}); K2 {k2_ms:.4f} ms (plain {k2_plain:.3f} ms, bound {b2:.4f} ms by {by2}); "
          f"K2 max abs err {json.dumps(errs_f)}")
    return [
        dict(name="riccati_backward_walk", route="cuda",
             source="aligator_tpu_torch/csrc/riccati_backward.cu",
             replaces="aligator_tpu/gar/pallas_riccati.py:225",
             instantiation="riccati_backward_kernel<56, 22, 0>", path="talos walk",
             max_abs_err=max(max(e.values()) for e in errs.values()), ms=k1_ms,
             plain_ms=k1_plain, bound_ms=b1, bound_by=by1, library_ms=None,
             ms_b1=k1_ms1, bound_ms_b1=b1_1),
        dict(name="riccati_forward_walk", route="cuda",
             source="aligator_tpu_torch/csrc/riccati_forward.cu",
             replaces="aligator_tpu/gar/pallas_riccati.py:549", path="talos walk",
             max_abs_err=max(errs_f.values()), ms=k2_ms, plain_ms=k2_plain, bound_ms=b2,
             bound_by=by2, library_ms=None),
    ]


def walk_phase(dev):
    """The talos walk at its published size through the port's entry
    points: 16 scenarios solved fused to convergence, against the serial
    path and a float64 solve on the card; the traced kernel count of one
    derivative pass; one capped solve traced for the device's share; the
    MPC cycle at B = 1. Returns K1's and K2's launches per fused solve and
    the fused solve's traj costs."""
    t_phase = time.perf_counter()
    problem, model = TW.create_walk_problem(WALK_TSS, WALK_TDS, dtype=torch.float32,
                                            device=dev)
    nv, nq, N = model.nv, model.nq, problem.nsteps
    x0 = problem.x0.cpu().numpy()
    prob16 = walk_scenarios(problem, model)
    fused = ProxDDPSettings(lq_solver="pallas", **WALK_SETTINGS)

    reset_counts()
    t0 = time.perf_counter()
    res = solve(prob16, fused)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts()
    k1, k2 = counts["riccati_backward"], counts["riccati_forward"]
    iters = res.num_iters.tolist()
    print(f"walk: N={N} nx={problem.space.nx} ndx={problem.ndx} nu={problem.nu} "
          f"B={WALK_BATCH}; fused solve (first call {first_s:.2f} s): conv "
          f"{int(res.conv.sum())}/{WALK_BATCH}, iterations {iters}, prim max "
          f"{float(res.prim_infeas.max()):.3e}, dual max {float(res.dual_infeas.max()):.3e}, "
          f"K1 launches {k1}, K2 launches {k2}")
    check(tuple(res.xs.shape) == (WALK_BATCH, N + 1, nq + nv)
          and bool(torch.isfinite(res.xs).all()), "walk xs finite, of the expected shape")
    check(bool(res.conv.all()), "every walk scenario converges")
    check(float(res.prim_infeas.max()) <= 1e-4 and float(res.dual_infeas.max()) <= 1e-4,
          "walk prim and dual <= 1e-4")
    check(k1 == k2 >= max(iters) >= 1, "walk kernel launch counts")

    res_s = solve(prob16, ProxDDPSettings(lq_solver="serial", **WALK_SETTINGS))
    torch.cuda.synchronize()
    rel = ((res.traj_cost - res_s.traj_cost).abs()
           / res_s.traj_cost.abs().clamp(min=1.0)).max()
    print(f"walk: fused vs serial on the card: traj cost max rel diff {float(rel):.3e}, "
          f"iterations {iters} vs {res_s.num_iters.tolist()}, max|dxs| "
          f"{max_err(res.xs, res_s.xs):.3e}")
    check(bool(res_s.conv.all()), "every serial walk scenario converges")
    check(float(rel) <= 1e-3, "walk fused vs serial traj cost to 1e-3")
    check(bool((res.num_iters == res_s.num_iters).all()), "walk iteration counts agree")

    p64, _ = TW.create_walk_problem(WALK_TSS, WALK_TDS, dtype=torch.float64, device=dev)
    p64 = p64.replace_x0(prob16.x0[:1].to(torch.float64))
    r64 = solve(p64, ProxDDPSettings(lq_solver="serial", **WALK_SETTINGS))
    c32, c64 = float(res.traj_cost[0]), float(r64.traj_cost[0])
    print(f"walk: scenario 0 float32 fused traj cost {c32:.6f} vs float64 serial {c64:.6f} "
          f"(rel {abs(c32 - c64) / max(1.0, abs(c64)):.3e}; f64 conv {bool(r64.conv[0])}, "
          f"iterations {int(r64.num_iters[0])})")
    check(abs(c32 - c64) <= 1e-3 * max(1.0, abs(c64)), "walk f32 vs f64 traj cost to 1e-3")
    t_apex = WALK_TDS + WALK_TSS // 2
    z = float(frame_placement(model, res.xs[0, t_apex, :nq], model.frame_id("right_sole")).p[2])
    print(f"walk: right sole z at swing apex stage {t_apex}: {z:.4f} m (target "
          f"{TW.SWING_APEX:.3f} m)")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        solve(prob16, fused)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"walk: fused solve of {WALK_BATCH} scenarios wall ms {walls} (median "
          f"{float(np.median(walls)):.1f}), {max(iters)} iterations, K1 {k1} and K2 {k2} "
          f"launches per solve")

    xs, us = xs_default_init(prob16), us_default_init(prob16)
    compute_derivatives(prob16, xs, us)
    _, kern, busy, _ = trace_device(lambda: compute_derivatives(prob16, xs, us))
    print(f"walk: one compute_derivatives call at B={WALK_BATCH}, N={N}: {len(kern)} device "
          f"kernels, device busy {busy / 1e3:.3f} ms")
    capped = ProxDDPSettings(lq_solver="pallas", **{**WALK_SETTINGS, "max_iters": 3})
    wall_us, kern, busy, by_name = trace_device(lambda: solve(prob16, capped))
    if kern:
        k1_us = sum(v for n, v in by_name.items() if "riccati_backward" in n)
        k2_us = sum(v for n, v in by_name.items() if "riccati_forward" in n)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        print(f"walk profile (a solve capped at 3 iterations): wall {wall_us / 1e3:.1f} ms, "
              f"{len(kern)} device kernels, sum of kernel times "
              f"{sum(by_name.values()) / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle "
              f"share {1 - busy / wall_us:.3f}; K1 {k1_us / 1e3:.3f} ms, K2 "
              f"{k2_us / 1e3:.3f} ms ({(k1_us + k2_us) / max(busy, 1.0):.3f} of busy)")
        for name, us in top:
            print(f"  {us / 1e3:9.3f} ms  {name[:90]}")
    else:
        print("walk profile: the profiler recorded no device time (not measured)")

    # the talos MPC cycle (bench.py:380-437): B = 1, 2 iterations, 2 AL turns
    p1 = problem.replace_x0(problem.x0[None])
    mpc_settings = ProxDDPSettings(lq_solver="pallas", **{**WALK_SETTINGS, "max_iters": 2,
                                                          "max_al_iters": 2})
    state = init_mpc_state(p1)
    rng = np.random.default_rng(11)
    x = p1.x0
    for _ in range(WALK_MPC_SETTLE):
        u, state, r, p1 = mpc_step(p1, mpc_settings, x, state)
    torch.cuda.synchronize()
    lats, prims, duals, per_step = [], [], [], []
    for _ in range(WALK_MPC_STEPS):
        dvs = 0.005 * rng.standard_normal(nv).astype(np.float32)
        x = torch.as_tensor(np.concatenate([x0[:nq], x0[nq:] + dvs])[None], device=dev)
        reset_counts()
        t0 = time.perf_counter()
        u, state, r, p1 = mpc_step(p1, mpc_settings, x, state)
        torch.cuda.synchronize()
        lats.append((time.perf_counter() - t0) * 1e3)
        c = read_counts()
        per_step.append((c["riccati_backward"], c["riccati_forward"]))
        prims.append(float(r.prim_infeas[0]))
        duals.append(float(r.dual_infeas[0]))
        check(tuple(u.shape) == (1, problem.nu) and bool(torch.isfinite(u).all()),
              "walk MPC control finite, of the expected shape")
    print(f"walk mpc: {WALK_MPC_SETTLE} settle + {WALK_MPC_STEPS} timed steps at B=1, step ms "
          f"{[round(v, 1) for v in lats]} (median {float(np.median(lats)):.1f}), prim "
          f"{prims}, dual {duals}, (K1, K2) launches per step {per_step}")
    check(all(a == b >= 1 for a, b in per_step), "walk MPC kernel launch counts")
    print(f"walk phase: {time.perf_counter() - t_phase:.1f} s")
    return {"riccati_backward_walk": k1, "riccati_forward_walk": k2}, res.traj_cost


# Slice 4: FDDP, and ProxDDP's filter, nonlinear rollout and exact Hessian.
# The pendulum example's solves (examples/pendulum.py:66-80) and the exact
# Hessian swing-up of tests/test_exact_hessian.py:95-103, each held against
# the same solve on the CPU: (builder keywords, solve).
PENDULUM_CASES = {
    "fddp": ({}, lambda p: fddp_solve(p, FDDPSettings(tol=1e-5, max_iters=200))),
    "proxddp filter+nonlinear+box": ({}, lambda p: solve(p, ProxDDPSettings(
        tol=1e-5, mu_init=1e-2, max_iters=400, sa_strategy="filter",
        rollout_type="nonlinear"))),
    "proxddp exact hessian": (dict(nsteps=40, u_max=None, u_weight=1e-2), lambda p: solve(
        p, ProxDDPSettings(hessian_approx="exact", tol=1e-3, mu_init=1e-2, max_iters=80,
                           rollout_type="nonlinear"))),
}
WALK_FDDP = FDDPSettings(tol=1e-4, max_iters=100)


def pendulum_solves(device) -> dict:
    """Each pendulum case solved on ``device`` (float64): name → (xs, us,
    conv, iterations, seconds) as numpy arrays and numbers."""
    out = {}
    for name, (kw, run) in PENDULUM_CASES.items():
        problem = create_pendulum_problem(dtype=torch.float64, device=device, **kw)
        t0 = time.perf_counter()
        res = run(problem)
        if device != "cpu":
            torch.cuda.synchronize()
        out[name] = (res.xs.cpu().numpy(), res.us.cpu().numpy(), bool(res.conv),
                     int(res.num_iters), time.perf_counter() - t0)
    return out


def walk_fddp(dev) -> dict:
    """The walk's 16 scenarios by FDDP in float64: the solve, its line-search
    rollouts, and one rollout traced for its device kernels."""
    problem, model = TW.create_walk_problem(WALK_TSS, WALK_TDS, dtype=torch.float64,
                                            device=dev)
    walk64 = walk_scenarios(problem, model)
    N, ndx, nu = problem.nsteps, problem.ndx, problem.nu
    with counting_calls(FD, "_forward") as rollouts:
        t0 = time.perf_counter()
        res = fddp_solve(walk64, WALK_FDDP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    zeros = lambda *s: torch.zeros((WALK_BATCH,) + s, dtype=torch.float64, device=dev)
    _, kern, busy, _ = trace_device(lambda: FD._forward(
        walk64, res.xs, res.us, zeros(N + 1, ndx), zeros(N, nu), zeros(N, nu, ndx),
        torch.ones(WALK_BATCH, dtype=torch.float64, device=dev)), host_ops=False)
    return dict(N=N, iters=res.num_iters.tolist(), conv=res.conv.tolist(),
                prim=float(res.prim_infeas.max()), dual=float(res.dual_infeas.max()),
                finite=bool(torch.isfinite(res.xs).all() and torch.isfinite(res.us).all()),
                wall=wall, rollouts=rollouts[0], kernels=len(kern), busy_ms=busy / 1e3,
                traj_cost=res.traj_cost.cpu().numpy())


def _walk_fddp_child(conn) -> None:
    conn.send(walk_fddp(torch.device("cuda")))
    conn.close()


def _pendulum_child(conn) -> None:
    """The pendulum cases on the CPU, then on the card, in a child process
    that runs beside the walk's solves in the parent (each side is bound
    by its host thread)."""
    torch.set_num_threads(1)
    conn.send((pendulum_solves("cpu"), pendulum_solves(torch.device("cuda"))))
    conn.close()


@contextlib.contextmanager
def spawned(targets: dict):
    """Start ``target(conn, *args)`` of each entry name → (target, args) in
    a spawned child process; yields name → the receiving end of its pipe,
    and stops every child on the way out."""
    ctx = multiprocessing.get_context("spawn")
    children, pipes = [], {}
    try:
        for name, (target, args) in targets.items():
            recv, send = ctx.Pipe(duplex=False)
            children.append(ctx.Process(target=target, args=(send, *args), daemon=True))
            children[-1].start()
            pipes[name] = recv
        yield pipes
    finally:
        for child in children:
            if child.is_alive():
                child.terminate()
            child.join()


@contextlib.contextmanager
def counting_calls(module, name: str):
    """Count the calls of ``module.name`` (looked up at call time) while
    the block runs; yields a one-element list holding the count."""
    orig, box = getattr(module, name), [0]

    def wrapped(*args, **kwargs):
        box[0] += 1
        return orig(*args, **kwargs)

    setattr(module, name, wrapped)
    try:
        yield box
    finally:
        setattr(module, name, orig)


def _eta(res, den):
    """max over the trailing axes of |res| / den (componentwise), NaN where
    res is not finite; the leading (B, L) kept."""
    if not res[0, 0].numel():
        return res.new_zeros(res.shape[:2])
    e = res.abs() / den.clamp(min=1e-300)
    e = e.flatten(2).amax(2)
    fin = torch.isfinite(res).flatten(2).all(2)
    return torch.where(fin, e, torch.full_like(e, float("nan")))


def k1_backward_error(knots, mu, g, v, spectrum: bool = True):
    """(B, L) componentwise backward error of each knot of a backward sweep's
    outputs (g, v), in float64 from its own cost-to-go at the next knot:
    the KKT residual [R̂ Dᵀ; D −µI]·[k z] + [r̂ Ŝᵀ; d C], and Vxx, vx, Acl,
    yff against the recursion's formulas, each entry over the sum of the
    magnitudes of its terms (R̂ = R + BᵀV'B counted as |R| + |B|ᵀ|V'||B|,
    and so on). A correct float32 step is at the rounding of its terms
    however ill-conditioned the recursion, up to the condition number κ of
    the R̂ that it inverts; NaN where the outputs or V' are not finite.
    Returns (that error, λmin / λmax of each R̂ (B, L), negative where R̂
    is not positive definite, NaN where it is not finite; None without
    ``spectrum``). θ terms are absent (nth = 0 on the fused path)."""
    up = lambda t: tree_map(lambda a: a.double(), t)
    k, g, v = up(knots), up(g), up(v)
    a = lambda t: t.abs()
    T = lambda t: t.mT
    nxt = lambda t: torch.cat([t[:, 1:], torch.zeros_like(t[:, :1])], 1)  # 0 past the end
    Vn, vn = nxt(v.Vxx), nxt(v.vx)
    mv_ = lambda M, x: (M @ x[..., None])[..., 0]
    vplus = vn + mv_(Vn, k.f)
    vplus_a = a(vn) + mv_(a(Vn), a(k.f))
    R = k.R + T(k.B) @ Vn @ k.B
    R_a = a(k.R) + T(a(k.B)) @ a(Vn) @ a(k.B)
    S = k.S + T(k.A) @ Vn @ k.B
    S_a = a(k.S) + T(a(k.A)) @ a(Vn) @ a(k.B)
    Q = k.Q + T(k.A) @ Vn @ k.A
    Q_a = a(k.Q) + T(a(k.A)) @ a(Vn) @ a(k.A)
    q, q_a = k.q + mv_(T(k.A), vplus), a(k.q) + mv_(T(a(k.A)), vplus_a)
    r, r_a = k.r + mv_(T(k.B), vplus), a(k.r) + mv_(T(a(k.B)), vplus_a)
    Kt = torch.cat([g.kff[..., None], g.K], -1)  # (B, L, nu, 1 + nx)
    Zt = torch.cat([g.zff[..., None], g.Z], -1)
    b1, b1_a = torch.cat([r[..., None], T(S)], -1), torch.cat([r_a[..., None], T(S_a)], -1)
    b2 = torch.cat([k.d[..., None], k.C], -1)
    m = mu.double()[:, None, None, None]
    res = [(R @ Kt + T(k.D) @ Zt + b1, R_a @ a(Kt) + T(a(k.D)) @ a(Zt) + b1_a),
           (k.D @ Kt - m * Zt + b2, a(k.D) @ a(Kt) + m * a(Zt) + a(b2)),
           (v.Vxx - 0.5 * ((Q + S @ g.K + T(k.C) @ g.Z) + T(Q + S @ g.K + T(k.C) @ g.Z)),
            Q_a + S_a @ a(g.K) + T(a(k.C)) @ a(g.Z) + T(Q_a + S_a @ a(g.K) + T(a(k.C)) @ a(g.Z))),
           ((v.vx - q - mv_(S, g.kff) - mv_(T(k.C), g.zff))[..., None],
            (q_a + mv_(S_a, a(g.kff)) + mv_(T(a(k.C)), a(g.zff)))[..., None])]
    stage = [(g.Acl - k.A - k.B @ g.K, a(k.A) + a(k.B) @ a(g.K)),
             ((g.yff - k.f - mv_(k.B, g.kff))[..., None],
              (a(k.f) + mv_(a(k.B), a(g.kff)))[..., None])]
    eta = torch.stack([_eta(r_, d_) for r_, d_ in res], -1).amax(-1)
    last = torch.stack([_eta(r_, d_) for r_, d_ in stage], -1).amax(-1)
    eta = torch.cat([torch.maximum(eta[:, :-1], last[:, :-1]), eta[:, -1:]], 1)
    # the terminal knot has Acl = 0 and yff = 0
    eta[:, -1] = torch.maximum(eta[:, -1], (g.Acl[:, -1].flatten(1).abs().amax(1)
                                            + g.yff[:, -1].abs().amax(1)))
    ok = torch.isfinite(torch.cat([Vn.flatten(2), vn], -1)).all(-1)
    nan = torch.full_like(eta, float("nan"))
    eta = torch.where(ok, eta, nan)
    if not spectrum:
        return eta, None
    fin = torch.isfinite(R).flatten(2).all(2)
    ev = torch.linalg.eigvalsh(torch.where(fin[..., None, None], R, torch.eye(
        R.shape[-1], dtype=R.dtype, device=R.device).expand_as(R)))
    return eta, torch.where(fin, ev[..., 0] / ev[..., -1].abs().clamp(min=1e-300), nan)


def k2_backward_error(gains, vms, x0, lbd0, out):
    """(B, L) componentwise backward error of each step of a forward sweep's
    outputs (xs, us, vs, λs), in float64 from its own state: x⁺ = yff +
    Acl x, u = kff + K x, v = zff + Z x, λ⁺ = vx⁺ + Vxx⁺ x⁺, each entry over
    the sum of the magnitudes of its terms; NaN where not finite."""
    up = lambda t: tree_map(lambda a: a.double(), t)
    g, vm, (xs, us, vs, ls) = up(gains), up(vms), up(out)
    a = lambda t: t.abs()
    mv_ = lambda M, x: (M @ x[..., None])[..., 0]
    res = [((xs[:, 0] - x0.double())[:, None, :, None], a(x0.double())[:, None, :, None]),
           ((ls[:, 0] - lbd0.double())[:, None, :, None], a(lbd0.double())[:, None, :, None]),
           ((us - g.kff - mv_(g.K, xs))[..., None], (a(g.kff) + mv_(a(g.K), a(xs)))[..., None]),
           ((vs - g.zff - mv_(g.Z, xs))[..., None], (a(g.zff) + mv_(a(g.Z), a(xs)))[..., None])]
    nxt = [((xs[:, 1:] - g.yff[:, :-1] - mv_(g.Acl[:, :-1], xs[:, :-1]))[..., None],
            (a(g.yff[:, :-1]) + mv_(a(g.Acl[:, :-1]), a(xs[:, :-1])))[..., None]),
           ((ls[:, 1:] - vm.vx[:, 1:] - mv_(vm.Vxx[:, 1:], xs[:, 1:]))[..., None],
            (a(vm.vx[:, 1:]) + mv_(a(vm.Vxx[:, 1:]), a(xs[:, 1:])))[..., None])]
    eta = torch.stack([_eta(r_, d_).expand(xs.shape[:2]) for r_, d_ in res], -1).amax(-1)
    step = torch.stack([_eta(r_, d_) for r_, d_ in nxt], -1).amax(-1)
    return torch.cat([torch.maximum(eta[:, :-1], step), eta[:, -1:]], 1)


@contextlib.contextmanager
def kernels_held_to_plain(log: list, backward_error: bool = False):
    """While the block runs, every K1 and K2 launch through the fused
    wrappers is followed by the plain version on the same inputs (not
    counted as a launch); ``log`` gets one (kernel, max over outputs of
    max|Δ| / max(1, max|plain|) over the problems whose plain outputs are
    finite, problems whose plain outputs are not, those of them whose
    kernel outputs are not either, seconds of the plain version) per call:
    where the float32 recursion breaks down on finite inputs (ROADMAP C5,
    C13) both results are meaningless and the solver rejects the step.

    With ``backward_error`` the entry ends with a dict of numpy arrays:
    ``kernel`` and ``plain`` (B, L), each knot's backward error of the
    kernel's and of the plain version's outputs (``k1_backward_error``,
    ``k2_backward_error``; NaN where not finite), ``kp`` (B,), the kernel
    against the plain version per problem as max over outputs of max|Δ| /
    max(1, max|plain|), inf where either is not finite, and for K1
    ``ratio`` (B, L), λmin / λmax of R̂ at each knot of the kernel's sweep,
    and its width ``nu``. The launch counts carry over to the wrappers."""
    orig_b, orig_f = FR.backward_sweep_batched, FR.forward_sweep_batched

    def rel(pairs):
        """(max over outputs of max|Δ| / max(1, max|plain|) over the problems
        whose plain outputs are all finite, the problems whose plain
        outputs are not, those of them whose kernel outputs are not
        either)."""
        pairs = [(a.flatten(1), b.flatten(1)) for a, b in pairs]
        ok = torch.stack([torch.isfinite(b).all(1) for _, b in pairs]).all(0)
        k_bad = torch.stack([~torch.isfinite(a).all(1) for a, _ in pairs]).any(0)
        worst = 0.0
        for a, b in pairs:
            if b.numel() and bool(ok.any()):
                worst = max(worst, max_err(a[ok], b[ok]) / max(1.0, float(b[ok].abs().max())))
        return worst, int((~ok).sum()), int((~ok & k_bad).sum())

    def per_problem(pairs):
        errs = []
        for a, b in pairs:
            a, b = a.flatten(1).double(), b.flatten(1).double()
            if b.shape[1]:
                fin = torch.isfinite(a).all(1) & torch.isfinite(b).all(1)
                e = (a - b).abs().amax(1) / b.abs().amax(1).clamp(min=1.0)
                errs.append(torch.where(fin, e, torch.full_like(e, float("inf"))))
        return torch.stack(errs).amax(0).cpu().numpy()

    def plain(fn, *args):
        """fn(*args) and the seconds it took, the stream drained around it."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    fields = lambda g, v: [getattr(g, n) for n in g._fields] + [getattr(v, n) for n in v._fields]

    def held_b(knots, mu, refine_steps=1):
        g, v = orig_b(knots, mu, refine_steps)
        (gp, vp), secs = plain(FR.backward_sweep_batched_ref, knots, mu, refine_steps)
        entry = ("K1", *rel(zip(fields(g, v), fields(gp, vp))), secs)
        if backward_error:
            eta, ratio = k1_backward_error(knots, mu, g, v)
            entry += (dict(kernel=eta.cpu().numpy(), ratio=ratio.cpu().numpy(),
                           nu=knots.R.shape[-1],
                           plain=k1_backward_error(knots, mu, gp, vp, False)[0].cpu().numpy(),
                           kp=per_problem(zip(fields(g, v), fields(gp, vp)))),)
        log.append(entry)
        return g, v

    def held_f(gains, vms, x0, lbd0):
        out = orig_f(gains, vms, x0, lbd0)
        ref, secs = plain(FR.forward_sweep_batched_ref, gains, vms, x0, lbd0)
        entry = ("K2", *rel(zip(out, ref)), secs)
        if backward_error:
            entry += (dict(kernel=k2_backward_error(gains, vms, x0, lbd0, out).cpu().numpy(),
                           plain=k2_backward_error(gains, vms, x0, lbd0, ref).cpu().numpy(),
                           kp=per_problem(zip(out, ref))),)
        log.append(entry)
        return out

    held_b.launches, held_f.launches = orig_b.launches, orig_f.launches
    FR.backward_sweep_batched, FR.forward_sweep_batched = held_b, held_f
    try:
        yield log
    finally:
        orig_b.launches, orig_f.launches = held_b.launches, held_f.launches
        FR.backward_sweep_batched, FR.forward_sweep_batched = orig_b, orig_f


def median_rate(fn, batch: int) -> list:
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates.append(batch / (time.perf_counter() - t0))
    return rates


def rel_gap(a, b) -> float:
    """max |a − b| / max(1, |b|) over a batch of traj costs."""
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


def solvers_phase(dev, walk_cost) -> None:
    """FDDP and ProxDDP's filter, nonlinear rollout and exact Hessian on
    the card: (1) the lqr56 chain without its box by FDDP and by fused
    ProxDDP (K1 <56, 22, 0> and K2); (2) the talos walk's 16 scenarios by
    FDDP in float64; (3) the walk by fused ProxDDP with the nonlinear
    rollout reading K1's gains; (4) the pendulum cases on the card against
    the CPU. (1) runs alone. Each of (2)-(4) is bound by the host thread
    that issues its kernels, so (2) and (4) run in child processes beside
    (3): the card is shared by three processes, and those three walls are
    contended, those of runs side by side."""
    t_phase = time.perf_counter()
    lqr56_chain(dev)
    with spawned({"walk fddp": (_walk_fddp_child, ()),
                  "pendulum": (_pendulum_child, ())}) as pipes:
        _solvers_phase(dev, walk_cost, pipes)
    print(f"solvers phase: {time.perf_counter() - t_phase:.1f} s")


def lqr56_chain(dev) -> None:
    """The lqr56 chain without its box (bench-lqr) by FDDP and by fused
    ProxDDP, after K1 <56, 22, 0> and K2 are held against their plain
    versions at the chain's shape."""
    arr = lqr_bench_arrays()
    chain = problem_from_numpy(arr["A"], arr["B"], arr["c"], arr["Q"], arr["R"], arr["Qf"],
                               batch_x0(BATCH), NSTEPS, device=dev, dtype=torch.float32)
    check(FR.backward_variant(NX, NU, 0) == "walk", "the chain takes K1's <56, 22, 0>")
    f_set = FDDPSettings(tol=1e-5, max_iters=50)
    p_set = ProxDDPSettings(tol=1e-5, mu_init=1e-7, max_iters=40, lq_solver="pallas")
    lq = lqr_from_numpy(random_lq_arrays(np.random.default_rng(9), BATCH, NSTEPS, NX, NU, 0),
                        device=dev, dtype=torch.float32)
    knots = knots_of(lq)
    gen = torch.Generator(device=dev).manual_seed(9)
    x0 = torch.randn(BATCH, NX, device=dev, generator=gen)
    l0 = torch.randn(BATCH, NX, device=dev, generator=gen)
    for mu_val in (p_set.mu_init, 1e-2):
        mu = torch.full((BATCH,), mu_val, device=dev)
        _, gp, vp, e1 = check_k1(f"chain mu={mu_val:g}", knots, mu)
        e2 = check_k2(f"chain mu={mu_val:g}", gp, vp, x0, l0, "rel", set())
        print(f"fddp: kernels at the chain's shape B={BATCH} N={NSTEPS} nx={NX} nu={NU} nc=0 "
              f"mu={mu_val:g}: K1 ({FR.backward_variant(NX, NU, 0)}) max abs err "
              f"{json.dumps(e1)}; K2 max abs err {json.dumps(e2)}")

    res_f = fddp_solve(chain, f_set)
    reset_counts()
    res_p = solve(chain, p_set)
    torch.cuda.synchronize()
    k1, k2 = read_counts()["riccati_backward"], read_counts()["riccati_forward"]
    dx = max_err(res_f.xs, res_p.xs) / float(res_p.xs.abs().max())
    du = max_err(res_f.us, res_p.us) / float(res_p.us.abs().max())
    rows = {}
    for name, fn, res in (("fddp", lambda: fddp_solve(chain, f_set), res_f),
                          ("proxddp fused", lambda: solve(chain, p_set), res_p)):
        rates = median_rate(fn, BATCH)
        _, kern, _, _ = trace_device(fn, host_ops=False)
        rows[name] = dict(iterations=int(res.num_iters.max()),
                          solves_per_s=float(np.median(rates)), kernels=len(kern) or None)
        print(f"fddp: lqr56 chain B={BATCH} N={NSTEPS} nc=0 f32, {name}: conv "
              f"{int(res.conv.sum())}/{BATCH}, iterations {rows[name]['iterations']}, "
              f"solves/s {[round(r, 1) for r in rates]} (median "
              f"{rows[name]['solves_per_s']:.1f}, alone on the card), device kernels per solve "
              f"{rows[name]['kernels'] or 'not measured'}")
    print(f"fddp: lqr56 chain, FDDP vs fused ProxDDP max|dxs|/max|xs| {dx:.3e}, max|dus|/max|us| "
          f"{du:.3e}; the fused solve launched K1 {k1} and K2 {k2} times")
    check(bool(res_f.conv.all()) and bool(res_p.conv.all()), "lqr56 chain: both converge")
    check(dx <= 1e-4 and du <= 1e-4, "lqr56 chain: FDDP and fused ProxDDP agree to 1e-4")
    check(k1 >= 1 and k2 >= 1, "lqr56 chain: the fused solve went through K1 and K2")


def _solvers_phase(dev, walk_cost, pipes) -> None:
    # (3) the walk by fused ProxDDP with the nonlinear rollout through K1's gains
    walk32 = walk_scenarios(*TW.create_walk_problem(WALK_TSS, WALK_TDS, dtype=torch.float32,
                                                    device=dev))
    nl = ProxDDPSettings(lq_solver="pallas", rollout_type="nonlinear", **WALK_SETTINGS)
    reset_counts()
    t0 = time.perf_counter()
    res = solve(walk32, nl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = read_counts()["riccati_backward"], read_counts()["riccati_forward"]
    gap = rel_gap(res.traj_cost, walk_cost)
    print(f"solvers: talos walk, fused ProxDDP with the nonlinear rollout: conv "
          f"{int(res.conv.sum())}/{WALK_BATCH}, iterations {res.num_iters.tolist()}, prim max "
          f"{float(res.prim_infeas.max()):.3e}, dual max {float(res.dual_infeas.max()):.3e}, "
          f"wall {wall:.1f} s (beside the two children), K1 {k1} and K2 {k2} launches per "
          f"solve, traj cost max rel gap to the linear rollout's {gap:.3e}")
    check(bool(res.conv.all()), "every walk scenario converges with the nonlinear rollout")
    check(float(res.prim_infeas.max()) <= 1e-4 and float(res.dual_infeas.max()) <= 1e-4,
          "nonlinear-rollout walk prim and dual <= 1e-4")
    check(gap <= 1e-3, "nonlinear vs linear rollout traj cost to 1e-3")
    check(k1 >= 1 and k2 >= 1, "the nonlinear-rollout walk went through K1 and K2")

    # (2) the talos walk by FDDP in float64 (the child process's result)
    check(pipes["walk fddp"].poll(1200), "the walk FDDP solve of the child process finished")
    w = pipes["walk fddp"].recv()
    gap = rel_gap(torch.as_tensor(w["traj_cost"], dtype=torch.float32, device=dev), walk_cost)
    print(f"fddp: talos walk N={w['N']} B={WALK_BATCH} f64, tol {WALK_FDDP.tol:g}: conv "
          f"{sum(w['conv'])}/{WALK_BATCH}, iterations {w['iters']}, prim max {w['prim']:.3e}, "
          f"dual max {w['dual']:.3e}, wall {w['wall']:.1f} s (beside the nonlinear-rollout "
          f"solve), {w['rollouts']} line-search rollouts over {max(w['iters'])} iterations "
          f"({w['rollouts'] / max(max(w['iters']), 1):.2f} per iteration), one rollout "
          f"{w['kernels'] or 'not measured'} device kernels (busy {w['busy_ms']:.1f} ms), traj "
          f"cost max rel gap to walk_phase's fused ProxDDP {gap:.3e}")
    check(w["finite"], "walk FDDP iterates finite")
    check(all(w["conv"]), "every walk scenario converges under FDDP")

    # (4) the pendulum cases on the card against the CPU (float64)
    t0 = time.perf_counter()
    check(pipes["pendulum"].poll(900), "the pendulum solves of the child process finished")
    cpu, card = pipes["pendulum"].recv()
    print(f"solvers: pendulum results waited for {time.perf_counter() - t0:.1f} s")
    for name, (xs, us, conv, n_it, secs) in card.items():
        xs_c, us_c, conv_c, n_it_c, secs_c = cpu[name]
        ex = float(np.abs(xs - xs_c).max()) / max(1.0, float(np.abs(xs_c).max()))
        eu = float(np.abs(us - us_c).max()) / max(1.0, float(np.abs(us_c).max()))
        print(f"solvers: pendulum {name}: card conv {conv}, iterations {n_it}, {secs:.1f} s; "
              f"CPU conv {conv_c}, iterations {n_it_c}, {secs_c:.1f} s; max|dxs| {ex:.3e}, "
              f"max|dus| {eu:.3e} (relative to max(1, max|.|))")
        check(conv and conv_c, f"pendulum {name} converges on the card and the CPU")
        check(ex <= 1e-9 and eu <= 1e-9, f"pendulum {name} card vs CPU to 1e-9")


# Slice 5: the manipulator, free-flyer and small-robot examples. (a) The
# quadrotor (examples/quadrotor_obstacles.py: N = 60, dt = 0.05, the mug,
# the pillar and the hover box on u; ndx = 12, nu = 4, nc = 6) as a batch
# of 16 perturbed scenarios in float32 through the fused kernels; (b) the
# other seven examples at their published sizes with the JAX examples'
# settings, float64, each on the card and on the CPU (child processes).
QUAD_BATCH = 16
QUAD_SETTINGS = dict(tol=1e-3, mu_init=1e-2, max_iters=200)
EXAMPLES = {  # name → (create_* keywords, ProxDDPSettings of the example's main)
    "lqr": (dict(bounds=True), dict(tol=1e-8, mu_init=2e-3, max_iters=20)),
    "se2_car": (dict(nsteps=40), dict(tol=1e-6, mu_init=1e-2, max_iters=100)),
    "cartpole": ({}, dict(tol=1e-3, mu_init=1e-2, max_iters=300)),
    "acrobot": (dict(term_cstr=True), dict(tol=1e-3, mu_init=1e-2, max_iters=200)),
    "ur5_reach": ({}, dict(tol=1e-4, mu_init=1e-2, max_iters=100)),
    "ur5_obstacle": ({}, dict(tol=1e-4, mu_init=1e-2, max_iters=120)),
    "ur5_ballistic": ({}, dict(tol=1e-4, mu_init=1e-2, max_iters=200)),
}


# card vs CPU: 1e-9·max(1, max|·|), but the acrobot's 200 iterations
# amplify rounding to ~1e-9 between any two correct solves (ROADMAP C9:
# the port against JAX on the CPU, the card against the CPU): 1e-8 there
EXAMPLE_TOL = {"acrobot": 1e-8}


def example_solves(names, device) -> dict:
    """Each named example built and solved on ``device`` in float64: name →
    (xs, us, conv, iterations, seconds, outcomes) as numpy arrays, numbers
    and a dict of the outcomes the JAX tests assert."""
    import importlib

    out = {}
    for name in names:
        mod = importlib.import_module(f"aligator_tpu_torch.examples.{name}")
        create = next(getattr(mod, n) for n in dir(mod) if n.startswith("create_"))
        kw, settings = EXAMPLES[name]
        built = create(device=device, **kw)
        problem = built[0] if isinstance(built, tuple) else built
        t0 = time.perf_counter()
        res = solve(problem, ProxDDPSettings(**settings))
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        outcomes = {}
        if name == "ur5_obstacle":
            outcomes["min_clearance"] = mod.min_tool_obstacle_distance(built[1], res.xs, built[3])
        elif name == "ur5_ballistic":
            outcomes["landing_miss"] = mod.landing_miss(built[1], res.xs[built[2]])
            outcomes["max_abs_u"] = float(res.us.abs().max())
        elif name == "acrobot":
            outcomes["norm_xN"] = float(torch.linalg.vector_norm(res.xs[-1]))
        out[name] = (res.xs.cpu().numpy(), res.us.cpu().numpy(), bool(res.conv),
                     int(res.num_iters), secs, outcomes)
    return out


def _examples_child(conn, names, device) -> None:
    """Examples solved in a child process beside the parent's phases (each
    side is bound by its host thread)."""
    torch.set_num_threads(1)
    conn.send(example_solves(names, device if device == "cpu" else torch.device(device)))
    conn.close()




def k_quad_check(dev):
    """K1 (its instantiation for widths read at launch) and K2 at the
    quadrotor's widths, B = 16, N = 60, nx = 12, nu = 4, nc = 6: against
    their plain versions under the gate 1e-4·max|·| at µ = 1e-2 (the
    solve's µ_init) and 1e-4, then timed beside their bounds."""
    Bsz, N, nx, nu, nc = QUAD_BATCH, 60, 12, 4, 6
    variant = FR.backward_variant(nx, nu, nc)
    check(variant == "runtime", f"the quadrotor's widths take K1's runtime instantiation: {variant}")
    lq = lqr_from_numpy(random_lq_arrays(np.random.default_rng(13), Bsz, N, nx, nu, nc),
                        device=dev, dtype=torch.float32)
    knots = knots_of(lq)
    gen = torch.Generator(device=dev).manual_seed(13)
    x0 = torch.randn(Bsz, nx, device=dev, generator=gen)
    l0 = torch.randn(Bsz, nx, device=dev, generator=gen)
    errs_b, errs_f = {}, {}
    for mu_val in (1e-2, 1e-4):
        mu = torch.full((Bsz,), mu_val, device=dev)
        _, gp, vp, e1 = check_k1(f"quadrotor mu={mu_val:g}", knots, mu)
        e2 = check_k2(f"quadrotor mu={mu_val:g}", gp, vp, x0, l0, "rel", set())
        errs_b[mu_val], errs_f[mu_val] = e1, e2
        print(f"kernels K1 quadrotor widths B={Bsz} N={N} nx={nx} nu={nu} nc={nc} "
              f"mu={mu_val:g} ({variant}): max abs err {json.dumps(e1)}; K2 "
              f"({'x'.join(map(str, FR.forward_plan(gp, vp)))}) max abs err {json.dumps(e2)}")
    mu = torch.full((Bsz,), 1e-2, device=dev)
    gp, vp = FR.backward_sweep_batched_ref(knots, mu)
    L = N + 1
    k1_ms = cuda_ms(lambda: FR.backward_sweep_batched(knots, mu), 20)
    k1_plain = cuda_ms(lambda: FR.backward_sweep_batched_ref(knots, mu), 3)
    k2_ms = cuda_ms(lambda: FR.forward_sweep_batched(gp, vp, x0, l0), 20)
    k2_plain = cuda_ms(lambda: FR.forward_sweep_batched_ref(gp, vp, x0, l0), 3)
    b1, by1 = bound_ms(*backward_cost(Bsz, L, nx, nu, nc, 1))
    b2, by2 = bound_ms(*forward_cost(Bsz, L, nx, nu, nc))
    print(f"quadrotor widths B={Bsz} L={L}: K1 {k1_ms:.4f} ms (plain {k1_plain:.3f} ms, bound "
          f"{b1:.4f} ms by {by1}, {k1_ms / b1:.1f}x; {k1_ms / L * 1e3:.2f} us per knot); K2 "
          f"{k2_ms:.4f} ms (plain {k2_plain:.3f} ms, bound {b2:.4f} ms by {by2}, "
          f"{k2_ms / b2:.1f}x)")
    return [
        dict(name="riccati_backward_quadrotor", route="cuda",
             source="aligator_tpu_torch/csrc/riccati_backward.cu",
             replaces="aligator_tpu/gar/pallas_riccati.py:225",
             instantiation="riccati_backward_kernel, widths read at launch",
             path="quadrotor_obstacles",
             max_abs_err=max(max(e.values()) for e in errs_b.values()), ms=k1_ms,
             plain_ms=k1_plain, bound_ms=b1, bound_by=by1, library_ms=None),
        dict(name="riccati_forward_quadrotor", route="cuda",
             source="aligator_tpu_torch/csrc/riccati_forward.cu",
             replaces="aligator_tpu/gar/pallas_riccati.py:549", path="quadrotor_obstacles",
             max_abs_err=max(max(e.values()) for e in errs_f.values()), ms=k2_ms,
             plain_ms=k2_plain, bound_ms=b2, bound_by=by2, library_ms=None),
    ]


def quadrotor_solves(dev, part: str) -> dict:
    """(a) The quadrotor's 16 scenarios, as numpy arrays and numbers (it
    runs in two child processes). ``part="fused"``: in float32 through
    the fused kernels, K1 and K2 launches counted around that solve alone
    and each call held to the plain versions, the scenarios' outcomes, the
    fused solve's wall (median of 3) and one traced derivative pass;
    ``part="reference"``: the same scenarios through the serial path in
    float32 and in float64."""
    full_f32_matmuls()
    problem, model, base, geoms = TQ.create_quadrotor_problem(dtype=torch.float32, device=dev)
    prob16 = walk_scenarios(problem, model, QUAD_BATCH)
    fused = ProxDDPSettings(lq_solver="pallas", **QUAD_SETTINGS)
    host = lambda r: dict(conv=r.conv.cpu().numpy(), iters=r.num_iters.cpu().numpy(),
                          cost=r.traj_cost.double().cpu().numpy(),
                          prim=float(r.prim_infeas.max()), dual=float(r.dual_infeas.max()),
                          finite=bool(torch.isfinite(r.xs).all()), shape=tuple(r.xs.shape))
    if part == "reference":
        p64 = TQ.create_quadrotor_problem(dtype=torch.float64, device=dev)[0]
        return dict(serial=host(solve(prob16, ProxDDPSettings(lq_solver="serial",
                                                              **QUAD_SETTINGS))),
                    f64=host(solve(p64.replace_x0(prob16.x0.double()),
                                   ProxDDPSettings(lq_solver="serial", **QUAD_SETTINGS))))
    reset_counts()
    t0 = time.perf_counter()
    with kernels_held_to_plain([]) as held:
        res = solve(prob16, fused)
        torch.cuda.synchronize()
    out = dict(first_s=time.perf_counter() - t0, counts=read_counts(), fused=host(res),
               held=held, N=problem.nsteps, nx=problem.space.nx, ndx=problem.ndx,
               nu=problem.nu, nc=problem.nc)
    # every scenario's end point and least clearances (mug, pillar)
    pN = torch.stack([frame_placement(model, x[-1, :model.nq], base).p for x in res.xs])
    out["miss"] = torch.linalg.vector_norm(pN - pN.new_tensor(TQ.TARGET), dim=-1).cpu().numpy()
    out["clearances"] = np.array([TQ.min_clearances(model, x, geoms) for x in res.xs])
    out["pN0"] = pN[0].cpu().numpy()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        solve(prob16, fused)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["walls_ms"] = walls
    xs, us = xs_default_init(prob16), us_default_init(prob16)
    compute_derivatives(prob16, xs, us)
    _, kern, busy, _ = trace_device(lambda: compute_derivatives(prob16, xs, us))
    out["deriv_kernels"], out["deriv_busy_ms"] = len(kern), busy / 1e3
    return out


def _quadrotor_child(conn, device, part) -> None:
    conn.send(quadrotor_solves(torch.device(device), part))
    conn.close()


# (a) on the card, its fused and its reference solves side by side; the
# CPU solves of all seven, the card's acrobot (200 iterations) alone, the
# card's six others
EXAMPLE_CHILDREN = {
    "quadrotor fused": (_quadrotor_child, ("cuda", "fused")),
    "quadrotor reference": (_quadrotor_child, ("cuda", "reference")),
    "examples cpu": (_examples_child, (tuple(EXAMPLES), "cpu")),
    "examples card acrobot": (_examples_child, (("acrobot",), "cuda")),
    "examples card": (_examples_child, (tuple(n for n in EXAMPLES if n != "acrobot"), "cuda")),
}


def quadrotor_report(q) -> dict:
    """Prints and checks (a); returns K1's and K2's launches in the fused
    solve."""
    f, sr, f64 = q["fused"], q["serial"], q["f64"]
    k1, k2 = q["counts"]["riccati_backward"], q["counts"]["riccati_forward"]
    iters = f["iters"].tolist()
    print(f"quadrotor: N={q['N']} nx={q['nx']} ndx={q['ndx']} nu={q['nu']} nc={q['nc']} "
          f"B={QUAD_BATCH} f32; fused solve (first call {q['first_s']:.2f} s): conv "
          f"{int(f['conv'].sum())}/{QUAD_BATCH}, iterations {iters}, prim max {f['prim']:.3e}, "
          f"dual max {f['dual']:.3e}, K1 launches {k1}, K2 launches {k2}")
    check(f["shape"] == (QUAD_BATCH, q["N"] + 1, q["nx"]) and f["finite"],
          "quadrotor xs finite, of the expected shape")
    check(bool(f["conv"].all()), "every quadrotor scenario converges through the kernels")
    check(k1 == k2 >= max(iters) >= 1, "quadrotor kernel launch counts")
    held = q["held"]
    worst = {k: max((e for n, e, *_ in held if n == k), default=float("nan"))
             for k in ("K1", "K2")}
    print(f"quadrotor: the fused solve's {len(held)} kernel calls held to the plain versions on "
          f"the same inputs: max over calls of max|d|/max(1, max|plain|) K1 {worst['K1']:.3e}, "
          f"K2 {worst['K2']:.3e}")
    check(sum(n == "K1" for n, *_ in held) == k1 and sum(n == "K2" for n, *_ in held) == k2,
          "every quadrotor kernel call held to its plain version")
    check(worst["K1"] <= 1e-4 and worst["K2"] <= 1e-4,
          "the quadrotor's K1 and K2 calls agree with their plain versions to 1e-4")
    broken = sum(c for _, _, c, *_ in held)
    check(broken == 0, f"the plain versions' outputs are finite in every quadrotor problem-call "
          f"({broken} are not)")
    gap = lambda a, b: np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    g_s, g_64, g_s64 = gap(f["cost"], sr["cost"]), gap(f["cost"], f64["cost"]), gap(
        sr["cost"], f64["cost"])
    print(f"quadrotor: serial f32 iterations {sr['iters'].tolist()} (equal to the fused in "
          f"{int((f['iters'] == sr['iters']).sum())}/{QUAD_BATCH}), conv "
          f"{int(sr['conv'].sum())}/{QUAD_BATCH}; serial f64 iterations {f64['iters'].tolist()}, "
          f"conv {int(f64['conv'].sum())}/{QUAD_BATCH}")
    print(f"quadrotor: traj cost fused f32 {np.round(f['cost'], 6).tolist()}, serial f32 "
          f"{np.round(sr['cost'], 6).tolist()}, serial f64 {np.round(f64['cost'], 6).tolist()}")
    print(f"quadrotor: traj cost diff per scenario (relative to max(1, |.|)), fused f32 vs serial "
          f"f32 {[float('%.3e' % v) for v in g_s]} (median {float(np.median(g_s)):.3e}), fused "
          f"f32 vs serial f64 {[float('%.3e' % v) for v in g_64]} (median "
          f"{float(np.median(g_64)):.3e}), serial f32 vs serial f64 "
          f"{[float('%.3e' % v) for v in g_s64]}")
    check(bool(sr["conv"].all()) and bool(f64["conv"].all()),
          "every quadrotor scenario converges serial in f32 and in f64")
    # a scenario may converge to another local optimum in float32 (ROADMAP
    # C10): the costs agree to 1e-3 in the median scenario
    check(float(np.median(g_s)) <= 1e-3, "quadrotor fused vs serial traj cost to 1e-3 (median)")
    check(float(np.median(g_64)) <= 1e-3, "quadrotor f32 fused vs f64 traj cost to 1e-3 (median)")
    clear = q["clearances"]
    print(f"quadrotor: scenario 0 final position {[round(float(v), 4) for v in q['pN0']]}; over "
          f"the {QUAD_BATCH} scenarios the largest distance to the target "
          f"{float(q['miss'].max()):.4f} m, least clearances (mug, pillar) "
          f"{[round(float(c), 5) for c in clear.min(0)]} (margin {TQ.MARGIN})")
    check(float(q["miss"].max()) < 5e-2, "every quadrotor scenario ends within 5e-2 of the target")
    check(float(clear.min()) >= TQ.MARGIN - 2e-3, "every quadrotor scenario keeps its clearances")
    print(f"quadrotor: fused solve of {QUAD_BATCH} scenarios wall ms "
          f"{[round(w, 1) for w in q['walls_ms']]} (median {float(np.median(q['walls_ms'])):.1f}, "
          f"beside the solvers phase), {max(iters)} iterations, K1 {k1} and K2 {k2} launches "
          f"per solve; one compute_derivatives call at B={QUAD_BATCH}, N={q['N']}: "
          f"{q['deriv_kernels']} device kernels, device busy {q['deriv_busy_ms']:.3f} ms")
    return {"riccati_backward_quadrotor": k1, "riccati_forward_quadrotor": k2}


def examples_phase(pipes):
    """(a) and (b) from their child processes: the quadrotor's report, then
    the seven other examples' card and CPU solves held against each other
    (equal conv and iterations, xs and us to 1e-9·max(1, max|·|)) and
    against the JAX tests' physical outcomes. Returns the quadrotor's
    K1 and K2 launches."""
    t0 = time.perf_counter()
    results = {}
    for name in EXAMPLE_CHILDREN:
        check(pipes[name].poll(900), f"the {name} child process finished")
        results[name] = pipes[name].recv()
    print(f"examples: child results waited for {time.perf_counter() - t0:.1f} s")
    launches = quadrotor_report({**results["quadrotor fused"], **results["quadrotor reference"]})
    cpu = results["examples cpu"]
    card = {**results["examples card"], **results["examples card acrobot"]}
    for name in EXAMPLES:
        xs, us, conv, n_it, secs, out = card[name]
        xs_c, us_c, conv_c, n_it_c, secs_c, out_c = cpu[name]
        ex = float(np.abs(xs - xs_c).max()) / max(1.0, float(np.abs(xs_c).max()))
        eu = float(np.abs(us - us_c).max()) / max(1.0, float(np.abs(us_c).max()))
        print(f"examples: {name} f64: card conv {conv}, iterations {n_it}, {secs:.1f} s; CPU conv "
              f"{conv_c}, iterations {n_it_c}, {secs_c:.1f} s; max|dxs| {ex:.3e}, max|dus| "
              f"{eu:.3e} (relative to max(1, max|.|)); outcomes card {json.dumps(out)}, CPU "
              f"{json.dumps(out_c)}")
        check(conv and conv_c, f"example {name} converges on the card and the CPU")
        check(n_it == n_it_c, f"example {name}: equal iterations on the card and the CPU")
        tol_x = EXAMPLE_TOL.get(name, 1e-9)
        check(ex <= tol_x and eu <= tol_x, f"example {name} card vs CPU to {tol_x:g}")
    check(card["ur5_obstacle"][5]["min_clearance"] >= 0.02 - 2e-3,
          "ur5_obstacle keeps its margin")
    check(card["ur5_ballistic"][5]["landing_miss"] < 1e-2
          and card["ur5_ballistic"][5]["max_abs_u"] <= 150.0 + 1e-6,
          "ur5_ballistic lands on target within its effort bound")
    check(card["acrobot"][5]["norm_xN"] < 1e-3, "acrobot reaches the upright state")
    return launches


# Slice 6: the legged and centroidal family. (a) The solo-12 jump
# (examples/solo_jump.py: N = 45, dt = 0.02, a flight phase with every
# contact off; nx = 37, ndx = 36, nu = 12, nc = 0) as 16 perturbed
# scenarios in float32 through K1 (widths read at launch) and K2 (nx read
# at launch), against the serial path in float32 and in float64; (b) the
# humanoid squat (kinodynamics) and the centroidal CoM shift in float64 on
# the card against the CPU, and the minimum-norm static balance of the
# two wide systems; (c) the jump through the spec path, exported, sent
# through JSON and rebuilt on the card.
JUMP_BATCH = 16
JUMP_TIMED_ITERS = 10  # iterations of each unheld solve timed for the jump's wall
BACKWARD_TOL = 1e-5  # a knot's backward error in float32 (the plain version's ~3e-7)
PIVOT_TOL = 1e-5  # λmin / λmax of R̂ at which a float32 step may break down
LEGGED_EXAMPLES = {  # name → (module, ProxDDPSettings of the example's main)
    "humanoid_squat": (TH, dict(tol=1e-4, mu_init=1e-2, max_iters=100, cost_scale=1e-2)),
    "centroidal": (TC, dict(tol=1e-6, mu_init=1e-1, max_iters=200)),
}


def k_jump_check(dev):
    """K1 (its instantiation for widths read at launch) and K2 at the
    jump's widths, B = 16, N = 45, nx = 36, nu = 12, nc = 0: against their
    plain versions under the gate 1e-4·max|·| at µ = 1e-2 (the solve's
    µ_init) and 1e-4, then timed beside their bounds."""
    Bsz, N, nx, nu, nc = JUMP_BATCH, 45, 36, 12, 0
    variant = FR.backward_variant(nx, nu, nc)
    check(variant == "runtime", f"the jump's widths take K1's runtime instantiation: {variant}")
    lq = lqr_from_numpy(random_lq_arrays(np.random.default_rng(17), Bsz, N, nx, nu, nc),
                        device=dev, dtype=torch.float32)
    knots = knots_of(lq)
    gen = torch.Generator(device=dev).manual_seed(17)
    x0 = torch.randn(Bsz, nx, device=dev, generator=gen)
    l0 = torch.randn(Bsz, nx, device=dev, generator=gen)
    errs_b, errs_f = {}, {}
    for mu_val in (1e-2, 1e-4):
        mu = torch.full((Bsz,), mu_val, device=dev)
        _, gp, vp, e1 = check_k1(f"jump mu={mu_val:g}", knots, mu)
        e2 = check_k2(f"jump mu={mu_val:g}", gp, vp, x0, l0, "rel", set())
        errs_b[mu_val], errs_f[mu_val] = e1, e2
        print(f"kernels K1 jump widths B={Bsz} N={N} nx={nx} nu={nu} nc={nc} mu={mu_val:g} "
              f"({variant}): max abs err {json.dumps(e1)}; K2 "
              f"({'x'.join(map(str, FR.forward_plan(gp, vp)))}) max abs err {json.dumps(e2)}")
    mu = torch.full((Bsz,), 1e-2, device=dev)
    gp, vp = FR.backward_sweep_batched_ref(knots, mu)
    L = N + 1
    k1_ms = cuda_ms(lambda: FR.backward_sweep_batched(knots, mu), 20)
    k1_plain = cuda_ms(lambda: FR.backward_sweep_batched_ref(knots, mu), 3)
    k2_ms = cuda_ms(lambda: FR.forward_sweep_batched(gp, vp, x0, l0), 20)
    k2_plain = cuda_ms(lambda: FR.forward_sweep_batched_ref(gp, vp, x0, l0), 3)
    b1, by1 = bound_ms(*backward_cost(Bsz, L, nx, nu, nc, 1))
    b2, by2 = bound_ms(*forward_cost(Bsz, L, nx, nu, nc))
    print(f"jump widths B={Bsz} L={L}: K1 {k1_ms:.4f} ms (plain {k1_plain:.3f} ms, bound "
          f"{b1:.4f} ms by {by1}, {k1_ms / b1:.1f}x; {k1_ms / L * 1e3:.2f} us per knot; "
          f"{FR.backward_blocks_per_sm(nx, nu, nc)} blocks per SM); K2 {k2_ms:.4f} ms (plain "
          f"{k2_plain:.3f} ms, bound {b2:.4f} ms by {by2}, {k2_ms / b2:.1f}x)")
    return [
        dict(name="riccati_backward_solo", route="cuda",
             source="aligator_tpu_torch/csrc/riccati_backward.cu",
             replaces="aligator_tpu/gar/pallas_riccati.py:225",
             instantiation="riccati_backward_kernel, widths read at launch", path="solo_jump",
             max_abs_err=max(max(e.values()) for e in errs_b.values()), ms=k1_ms,
             plain_ms=k1_plain, bound_ms=b1, bound_by=by1, library_ms=None),
        dict(name="riccati_forward_solo", route="cuda",
             source="aligator_tpu_torch/csrc/riccati_forward.cu",
             replaces="aligator_tpu/gar/pallas_riccati.py:549", path="solo_jump",
             max_abs_err=max(max(e.values()) for e in errs_f.values()), ms=k2_ms,
             plain_ms=k2_plain, bound_ms=b2, bound_by=by2, library_ms=None),
    ]


def jump_solves(dev, part: str) -> dict:
    """(a) The jump's 16 scenarios, as numpy arrays and numbers; each part
    runs in a child process of its own. ``"held"``: in float32 through the
    fused kernels, K1 and K2 launches counted around that solve alone and
    each call held to the plain versions and checked knot by knot, the base
    heights of every scenario, then the wall of three solves unheld, capped
    at ``JUMP_TIMED_ITERS`` iterations, and one traced derivative pass;
    ``"serial"`` and ``"f64"``: the same scenarios through the serial path
    in float32 and in float64."""
    full_f32_matmuls()
    problem, model, _ = TJ.create_jump_problem(dtype=torch.float32, device=dev)
    prob16 = walk_scenarios(problem, model, JUMP_BATCH)

    def host(r):
        z0, apex, zN = (v.double().cpu().numpy() for v in TJ.base_heights(r.xs))
        return dict(conv=r.conv.cpu().numpy(), iters=r.num_iters.cpu().numpy(),
                    cost=r.traj_cost.double().cpu().numpy(), prim=r.prim_infeas.cpu().numpy(),
                    dual=r.dual_infeas.cpu().numpy(), finite=bool(torch.isfinite(r.xs).all()),
                    shape=tuple(r.xs.shape), z0=z0, apex=apex, zN=zN)

    def timed(p, settings):
        t0 = time.perf_counter()
        r = solve(p, settings)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    fused = ProxDDPSettings(lq_solver="pallas", **TJ.SETTINGS)
    if part == "serial":
        r, secs = timed(prob16, ProxDDPSettings(lq_solver="serial", **TJ.SETTINGS))
        return dict(serial=host(r), serial_s=secs)
    if part == "f64":
        p64 = TJ.create_jump_problem(dtype=torch.float64, device=dev)[0]
        r, secs = timed(p64.replace_x0(prob16.x0.double()),
                        ProxDDPSettings(lq_solver="serial", **TJ.SETTINGS))
        return dict(f64=host(r), f64_s=secs)
    reset_counts()
    with kernels_held_to_plain([], backward_error=True) as held:
        res, secs = timed(prob16, fused)
    out = dict(held_s=secs, plain_s=sum(e[4] for e in held), counts=read_counts(),
               fused=host(res), held=held,
               N=problem.nsteps, nx=problem.space.nx, ndx=problem.ndx, nu=problem.nu,
               nc=problem.nc)
    capped = ProxDDPSettings(lq_solver="pallas",
                             **{**TJ.SETTINGS, "max_iters": JUMP_TIMED_ITERS})
    runs = [timed(prob16, capped) for _ in range(3)]
    out["timed_s"] = [secs for _, secs in runs]
    out["timed_iters"] = [int(r.num_iters.max()) for r, _ in runs]
    xs, us = xs_default_init(prob16), us_default_init(prob16)
    compute_derivatives(prob16, xs, us)
    _, kern, busy, _ = trace_device(lambda: compute_derivatives(prob16, xs, us))
    out["deriv_kernels"], out["deriv_busy_ms"] = len(kern), busy / 1e3
    return out


def _jump_child(conn, device, part) -> None:
    conn.send(jump_solves(torch.device(device), part))
    conn.close()


def legged_solves(device) -> dict:
    """(b) The squat and the centroidal shift built and solved on
    ``device`` in float64, and the static balance of the two wide systems:
    name → numpy arrays and numbers."""
    out = {}
    for name, (mod, settings) in LEGGED_EXAMPLES.items():
        create = next(getattr(mod, n) for n in dir(mod) if n.startswith("create_"))
        built = create(device=device)
        problem = built[0] if isinstance(built, tuple) else built
        t0 = time.perf_counter()
        res = solve(problem, ProxDDPSettings(**settings))
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if name == "humanoid_squat":
            outcome = {"dip": TH.com_dip(built[1], res.xs, built[2])}
        else:
            margin, fz_min = TC.cone_margin(res.us)
            outcome = {"cone_margin": margin, "min_fz": fz_min,
                       "com_N": res.xs[-1, :3].tolist()}
        out[name] = (res.xs.cpu().numpy(), res.us.cpu().numpy(), bool(res.conv),
                     int(res.num_iters), secs, outcome)
    for robot in ("quadruped", "humanoid"):
        if robot == "quadruped":
            model = build_quadruped(device=device)
            q0 = quadruped_standing(model)
            feet = tuple((f, 3) for f in TJ.FEET)
        else:
            model = build_humanoid(device=device)
            q0 = humanoid_half_sitting(model, device=device)
            feet = (("left_sole", 6), ("right_sole", 6))
        cs = anchor_at_configuration(model, make_contact_set(model, feet, device=device), q0)
        act = floating_base_actuation(model, device=device)
        u, lam = underactuated_constrained_inverse_dynamics(model, cs, act, q0,
                                                            q0.new_zeros(model.nv))
        out[f"balance {robot}"] = (u.cpu().numpy(), lam.cpu().numpy(), act.shape[0],
                                   act.shape[1] + lam.shape[0])
    return out


def _legged_child(conn, device) -> None:
    torch.set_num_threads(1)
    conn.send(legged_solves(device if device == "cpu" else torch.device(device)))
    conn.close()


# (a) in three children beside the solvers phase (each solve is bound by
# its host thread): the held solve and the two references. A solve is 200
# iterations (ROADMAP C13); three more for a median of walls do not fit the
# run's time limit.
LEGGED_CHILDREN = {
    "jump held": (_jump_child, ("cuda", "held")),
    "jump serial": (_jump_child, ("cuda", "serial")),
    "jump f64": (_jump_child, ("cuda", "f64")),
    "legged cpu": (_legged_child, ("cpu",)),
    "legged card": (_legged_child, ("cuda",)),
}


def same_problem(a, b) -> bool:
    """Equal horizon, widths, constraint stacks and x0."""
    return ((a.nsteps, a.ndx, a.nu, a.nc, a.nc_term, a.constraint_dims)
            == (b.nsteps, b.ndx, b.nu, b.nc, b.nc_term, b.constraint_dims)
            and [type(s).__name__ for s in a.constraint_sets]
            == [type(s).__name__ for s in b.constraint_sets]
            and bool(torch.equal(a.x0, b.x0)))


def jump_spec_check(dev) -> None:
    """(c) The jump in float64 on the card, exported by ``problem_to_spec``
    (the quadruped as a URDF document), sent through JSON and rebuilt by
    ``problem_from_spec`` on the card: the same problem, the same contact
    schedule and landing weights, and one derivative pass at x0 and at a
    seeded trajectory within 1e-12·max(1, max|·|)."""
    direct, model, _ = TJ.create_jump_problem(dtype=torch.float64, device=dev)
    model_spec = {"type": "urdf", "path": model_to_urdf(model, "solo")}
    t0 = time.perf_counter()
    text = json.dumps(problem_to_spec(direct, model_spec=model_spec))
    rebuilt = problem_from_spec(text, dtype=torch.float64, device=dev)
    secs = time.perf_counter() - t0
    check(same_problem(direct, rebuilt), "the spec-rebuilt jump is the same problem")
    check(torch.equal(direct.dynamics.ode.contacts.active, rebuilt.dynamics.ode.contacts.active),
          "the spec-rebuilt jump has the same contact schedule")
    check(all(torch.equal(a.expand_as(b), b) for a, b in
              zip(rebuilt.cost.weights, direct.cost.weights)),
          "the spec-rebuilt jump has the same landing weights")
    gen = torch.Generator(device=dev).manual_seed(19)
    x0 = direct.x0[None]
    seeded = direct.space.integrate(
        x0.expand(direct.nsteps + 1, -1),
        0.05 * torch.randn(direct.nsteps + 1, direct.ndx, device=dev, dtype=torch.float64,
                           generator=gen))
    xs = torch.stack([x0.expand(direct.nsteps + 1, -1), seeded])
    us = torch.stack([torch.zeros(direct.nsteps, direct.nu, device=dev, dtype=torch.float64),
                      torch.randn(direct.nsteps, direct.nu, device=dev, dtype=torch.float64,
                                  generator=gen)])
    two = lambda p: p.replace_x0(p.x0.expand(2, -1))
    d1, d2 = compute_derivatives(two(direct), xs, us), compute_derivatives(two(rebuilt), xs, us)
    err = max(max_err(getattr(d2, n), getattr(d1, n))
              / max(1.0, float(getattr(d1, n).abs().max()) if getattr(d1, n).numel() else 0.0)
              for n in d1._fields)
    print(f"legged spec: the jump exported to {len(text)} bytes of JSON and rebuilt on the card "
          f"in {secs:.2f} s; same problem; derivative pass at x0 and a seeded trajectory, max "
          f"over outputs of max|d|/max(1, max|.|) {err:.3e}")
    check(err <= 1e-12, "the spec-rebuilt jump's derivative pass to 1e-12")


def held_stats(held, name: str) -> dict:
    """Kernel ``name``'s held calls (``kernels_held_to_plain(...,
    backward_error=True)``) summed up: the knots checked (finite) and the
    largest backward error of the kernel's and of the plain version's, and
    the kernel's over its bound; the problem-calls whose outputs are not
    finite, by side; for K1 the largest λmin / λmax of R̂ at a breakdown of
    the kernel's (its last knot, in time, that is not finite); and the
    agreement of kernel and plain version per problem-call (within 1e-4,
    worst where both are finite)."""
    ent = [e[5] for e in held if e[0] == name]
    ek, ep = (np.stack([e[k] for e in ent]) for k in ("kernel", "plain"))  # (calls, B, L)
    kp = np.stack([e["kp"] for e in ent])
    kfin, pfin = ~np.isnan(ek).any(2), ~np.isnan(ep).any(2)
    top = lambda a: float(a.max()) if a.size else 0.0
    out = dict(
        calls=len(ent), knot_calls=int(ek.size), checked=int((~np.isnan(ek)).sum()),
        eta_max=top(ek[~np.isnan(ek)]), eta_plain_max=top(ep[~np.isnan(ep)]),
        problem_calls=int(kfin.size),
        both_bad=int((~kfin & ~pfin).sum()), plain_only_bad=int((kfin & ~pfin).sum()),
        kernel_only_bad=int((~kfin & pfin).sum()), kp_within=int((kp <= 1e-4).sum()),
        kp_max=top(kp[np.isfinite(kp)]))
    chk, bound = ~np.isnan(ek), np.full_like(ek, BACKWARD_TOL)
    if name == "K1":
        ratio = np.stack([e["ratio"] for e in ent])
        with np.errstate(divide="ignore", invalid="ignore"):
            kappa = np.where(ratio > 0, 1.0 / ratio, np.inf)
        # a step through R̂⁻¹ in float32 is good to ~nu·u·κ(R̂), u = 2⁻²⁴
        bound = np.maximum(bound, ent[0]["nu"] * 2.0 ** -24 * kappa)
        L = ek.shape[2]
        t_bad = L - 1 - np.argmax(np.isnan(ek)[:, :, ::-1], axis=2)  # last knot not finite
        piv = np.take_along_axis(ratio, t_bad[..., None], 2)[..., 0][~kfin]
        out.update(pivot_max=top(piv), pivot_kernel_only_max=top(
                       np.take_along_axis(ratio, t_bad[..., None], 2)[..., 0][~kfin & pfin]),
                   eta_max_kappa_le_1e3=top(ek[chk & (kappa <= 1e3)]),
                   kappa_max_checked=top(kappa[chk & np.isfinite(kappa)]))
    out["eta_over_bound_max"] = top(ek[chk] / bound[chk])
    return out


def jump_report(q) -> dict:
    """Prints and checks (a); returns K1's and K2's launches in the fused
    solve."""
    f, sr, f64 = q["fused"], q["serial"], q["f64"]
    k1, k2 = q["counts"]["riccati_backward"], q["counts"]["riccati_forward"]
    iters = f["iters"].tolist()
    print(f"legged: solo jump N={q['N']} nx={q['nx']} ndx={q['ndx']} nu={q['nu']} nc={q['nc']} "
          f"B={JUMP_BATCH} f32; fused solve ({q['held_s']:.1f} s, each kernel call held to its "
          f"plain version, {q['plain_s']:.1f} s of it, and checked knot by knot): conv "
          f"{f['conv'].astype(int).tolist()}, iterations {iters} (batch {max(iters)}), prim max "
          f"{float(f['prim'].max()):.3e}, dual max {float(f['dual'].max()):.3e}, K1 launches "
          f"{k1}, K2 launches {k2}")
    check(f["shape"] == (JUMP_BATCH, q["N"] + 1, q["nx"]) and f["finite"],
          "jump xs finite, of the expected shape")
    check(k1 == k2 >= max(iters) >= 1, "jump kernel launch counts")
    held = q["held"]
    check(sum(n == "K1" for n, *_ in held) == k1 and sum(n == "K2" for n, *_ in held) == k2,
          "every jump kernel call held to its plain version")
    # The jump's float32 LQ chain is ill-conditioned: the kernel and the
    # plain version, both float32, part far and break down on the same
    # inputs, as the JAX kernel does (ROADMAP C13). So their agreement is
    # printed, and each finite knot of each call is held instead to its own
    # step: its backward error in float64 from its own next cost-to-go, at
    # float32 rounding for a correct step, up to κ(R̂) where R̂ is near
    # singular.
    for name in ("K1", "K2"):
        st = held_stats(held, name)
        print(f"legged: jump {name} held calls: {json.dumps(st)}")
        check(st["eta_over_bound_max"] <= 1.0, f"every finite knot of the jump's {name} calls "
              f"has a backward error within max({BACKWARD_TOL:g}, nu·u·κ(R̂)) (K1) or "
              f"{BACKWARD_TOL:g} (K2): largest {st['eta_max']:.3e}, {st['eta_over_bound_max']:.3f} "
              f"of its bound; the plain version's {st['eta_plain_max']:.3e}; {st['checked']} of "
              f"{st['knot_calls']} knot-calls checked")
    st = held_stats(held, "K1")
    check(st["pivot_max"] <= PIVOT_TOL, f"K1 breaks down on the jump only where R̂ is "
          f"numerically singular (λmin/λmax ≤ {PIVOT_TOL:g} at each breakdown; largest "
          f"{st['pivot_max']:.3e})")
    gap = lambda a, b: np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    g_s, g_64 = gap(f["cost"], sr["cost"]), gap(f["cost"], f64["cost"])
    print(f"legged: jump serial f32 ({q['serial_s']:.1f} s) conv "
          f"{sr['conv'].astype(int).tolist()}, iterations {sr['iters'].tolist()}; serial f64 "
          f"({q['f64_s']:.1f} s) conv {f64['conv'].astype(int).tolist()}, iterations "
          f"{f64['iters'].tolist()}")
    print(f"legged: jump traj cost fused f32 {np.round(f['cost'], 6).tolist()}, serial f32 "
          f"{np.round(sr['cost'], 6).tolist()}, serial f64 {np.round(f64['cost'], 6).tolist()}")
    print(f"legged: jump traj cost diff (relative to max(1, |.|)) fused f32 vs serial f32 "
          f"{[float('%.3e' % v) for v in g_s]} (median {float(np.median(g_s)):.3e}), fused f32 "
          f"vs serial f64 {[float('%.3e' % v) for v in g_64]} (median "
          f"{float(np.median(g_64)):.3e})")
    # in float32 the batch stops unconverged at 200 iterations, in the JAX
    # package too (ROADMAP C13): the costs of two unconverged iterates are
    # printed, and the jump is gated on its outcome in every scenario
    rise, drift = f["apex"] - f["z0"], np.abs(f["zN"] - f["z0"])
    print(f"legged: jump base z per scenario: start {np.round(f['z0'], 4).tolist()}, apex "
          f"{np.round(f['apex'], 4).tolist()}, end {np.round(f['zN'], 4).tolist()}; least rise "
          f"{float(rise.min()):.4f} m (> 0.04), largest end drift {float(drift.max()):.4f} m "
          f"(< 0.08)")
    check(bool((rise > 0.04).all()), "every jump scenario rises more than 0.04 m")
    check(bool((drift < 0.08).all()), "every jump scenario lands within 0.08 m of its start")
    walls = q["timed_s"]
    print(f"legged: fused solve of {JUMP_BATCH} jump scenarios unheld, capped at "
          f"{JUMP_TIMED_ITERS} iterations ({q['timed_iters']}): wall s "
          f"{[round(w, 2) for w in walls]} (median {float(np.median(walls)):.2f}, "
          f"{float(np.median(walls)) / JUMP_TIMED_ITERS:.3f} s per iteration, beside the "
          f"solvers phase); {max(iters)} iterations, K1 {k1} and K2 {k2} launches per "
          f"solve; one compute_derivatives call at B={JUMP_BATCH}, N={q['N']}: "
          f"{q['deriv_kernels']} device kernels, device busy {q['deriv_busy_ms']:.3f} ms")
    return {"riccati_backward_solo": k1, "riccati_forward_solo": k2}


def legged_phase(pipes) -> dict:
    """(a) and (b) from their child processes, checked; returns K1's and
    K2's launches in the jump's fused solve."""
    t0 = time.perf_counter()
    results = {}
    for name in LEGGED_CHILDREN:
        check(pipes[name].poll(1100), f"the {name} child process finished")
        results[name] = pipes[name].recv()
    print(f"legged: child results waited for {time.perf_counter() - t0:.1f} s")
    launches = jump_report({**results["jump held"], **results["jump serial"],
                            **results["jump f64"]})
    cpu, card = results["legged cpu"], results["legged card"]
    for name in LEGGED_EXAMPLES:
        xs, us, conv, n_it, secs, out = card[name]
        xs_c, us_c, conv_c, n_it_c, secs_c, out_c = cpu[name]
        ex = float(np.abs(xs - xs_c).max()) / max(1.0, float(np.abs(xs_c).max()))
        eu = float(np.abs(us - us_c).max()) / max(1.0, float(np.abs(us_c).max()))
        print(f"legged: {name} f64: card conv {conv}, iterations {n_it}, {secs:.1f} s; CPU conv "
              f"{conv_c}, iterations {n_it_c}, {secs_c:.1f} s; max|dxs| {ex:.3e}, max|dus| "
              f"{eu:.3e} (relative to max(1, max|.|)); outcomes card {json.dumps(out)}, CPU "
              f"{json.dumps(out_c)}")
        check(conv and conv_c, f"{name} converges on the card and the CPU")
        check(n_it == n_it_c, f"{name}: equal iterations on the card and the CPU")
        check(ex <= 1e-9 and eu <= 1e-9, f"{name} card vs CPU to 1e-9")
    check(abs(card["humanoid_squat"][5]["dip"] - TH.DIP) < 5e-3,
          "the squat dips its CoM by 0.05 m within 5 mm")
    check(card["centroidal"][5]["cone_margin"] <= TC.MU,
          "the centroidal shift keeps its forces in the friction cone")
    for robot in ("quadruped", "humanoid"):
        u, lam, rows, cols = card[f"balance {robot}"]
        u_c, lam_c = cpu[f"balance {robot}"][:2]
        sol, sol_c = np.concatenate([u, lam]), np.concatenate([u_c, lam_c])
        err = float(np.abs(sol - sol_c).max()) / max(1.0, float(np.abs(sol_c).max()))
        print(f"legged: static balance of the {robot} ({rows} x {cols} system, minimum norm) "
              f"card vs CPU max|d|/max(1, max|.|) {err:.3e}")
        check(err <= 1e-10, f"the {robot}'s static balance on the card equals the CPU's")
    return launches


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

    t_run = time.perf_counter()
    kernels = kernels_phase(dev) + k1_walk_check(dev) + probe_phase(dev)
    print(f"kernel and probe phases: {time.perf_counter() - t_run:.1f} s")
    t0 = time.perf_counter()
    launches = slice_phase(dev)
    print(f"slice phase: {time.perf_counter() - t0:.1f} s")
    lq_phase(dev)
    t0 = time.perf_counter()
    mpc_phase(dev)
    print(f"mpc phase: {time.perf_counter() - t0:.1f} s")
    walk_launches, walk_cost = walk_phase(dev)
    launches.update(walk_launches)
    # K1 and K2 at the quadrotor's widths alone on the card; then the
    # examples' solves in child processes beside the solvers phase
    kernels += k_quad_check(dev)
    # the legged path: K1 and K2 at the jump's widths and the spec path alone
    # on the card; then its solves in child processes beside the others
    kernels += k_jump_check(dev)
    jump_spec_check(dev)
    t0 = time.perf_counter()
    with spawned({**EXAMPLE_CHILDREN, **LEGGED_CHILDREN}) as pipes:
        solvers_phase(dev, walk_cost)
        launches.update(examples_phase(pipes))
        t1 = time.perf_counter()
        launches.update(legged_phase(pipes))
        print(f"legged phase: {time.perf_counter() - t1:.1f} s after the examples phase, "
              f"{time.perf_counter() - t0:.1f} s from the children's start")
    print(f"solvers, examples and legged phases: {time.perf_counter() - t0:.1f} s")
    print(f"all phases: {time.perf_counter() - t_run:.1f} s")
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
