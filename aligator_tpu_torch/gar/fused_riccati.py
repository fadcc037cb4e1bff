"""Fused proximal Riccati sweeps: one kernel launch per sweep for a whole
batch of problems (port of ``aligator_tpu.gar.pallas_riccati``).

Two hand-written CUDA kernels for Hopper (``sm_90a``) carry this module:

* ``csrc/riccati_backward.cu`` — the reverse-time sweep t = N..0, one
  thread block per problem, the cost-to-go kept in shared memory between
  steps (replaces the Pallas ``_backward_kernel``);
* ``csrc/riccati_forward.cu`` — the closed-loop rollout in two kernels
  (replaces ``_forward_kernel``): the state chain x⁺ = yff + Acl x, one
  block per problem, the next knots' Acl and yff copied ahead by cp.async
  into a ring in shared memory; then u, v and λ of every knot from the
  stored states, over a grid of (knot chunk, problem).

The public API matches the JAX module: ``backward_sweep_batched``,
``forward_sweep_batched``, ``backward``, ``forward`` and ``solve``. An
explicit leading batch axis replaces the ``custom_vmap`` rules, and the
small initial-stage KKT solve stays in torch. Scope as in the JAX module:
nth = 0; the kernels take float32 only.

Each wrapper takes its plain torch version (``*_ref``: the serial
recursion of ``gar.riccati``) only for tensors that lie on the CPU. For CUDA tensors it launches
the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import functools

import torch

from aligator_tpu_torch.gar import riccati as _riccati
from aligator_tpu_torch.gar.lqr_problem import LQRProblem
from aligator_tpu_torch.gar.riccati import (
    CostToGo,
    Gains,
    Knot,
    RiccatiFactors,
    batch_mu,
    initial_costate,
    initial_solve,
    knots_of,
)
from aligator_tpu_torch.linalg.schur import cholesky
from aligator_tpu_torch.utils import cuda_build
from aligator_tpu_torch.utils.profiling import named_scope

# A block may use at most this much dynamic shared memory on an H100.
MAX_SMEM_BYTES = 232448

_KNOT_SHAPES = {
    "Q": ("nx", "nx"), "S": ("nx", "nu"), "R": ("nu", "nu"), "q": ("nx",),
    "r": ("nu",), "A": ("nx", "nx"), "B": ("nx", "nu"), "f": ("nx",),
    "C": ("nc", "nx"), "D": ("nc", "nu"), "d": ("nc",),
}
_GAIN_SHAPES = {
    "K": ("nu", "nx"), "Z": ("nc", "nx"), "Acl": ("nx", "nx"),
    "Vxx": ("nx", "nx"), "kff": ("nu",), "zff": ("nc",), "yff": ("nx",),
    "vx": ("nx",),
}


def _check_kernel_args(named: dict, Bsz: int, L: int, dims: dict, shapes: dict,
                       device: torch.device) -> None:
    """Device, dtype, shape and contiguity checks before any pointer
    reaches the kernel."""
    for name, a in named.items():
        want = (Bsz, L) + tuple(dims[s] for s in shapes[name])
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, expected {device}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got {a.dtype}")
        if tuple(a.shape) != want:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {want}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _vec_check(name, a, shape, device):
    if a.device != device or a.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 on {device}")
    if tuple(a.shape) != shape or not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous of shape {shape}")


def _pack(kff, zff, yff, K, Z, Acl, Vxx, vx):
    """(Gains, CostToGo) with the zero-width θ-blocks of nth = 0."""
    z = lambda *s: K.new_zeros(K.shape[:2] + s)
    nu, nx, nc = K.shape[-2], K.shape[-1], Z.shape[-2]
    gains = Gains(kff=kff, zff=zff, yff=yff, K=K, Z=Z, Acl=Acl,
                  Kth=z(nu, 0), Zth=z(nc, 0), Yth=z(nx, 0))
    return gains, CostToGo(Vxx=Vxx, vx=vx, Vxt=z(nx, 0), vt=z(0), Vtt=z(0, 0))


# ---------------------------------------------------------------------------
# Backward sweep
# ---------------------------------------------------------------------------


def backward_sweep_batched_ref(knots: Knot, mueq: torch.Tensor,
                               refine_steps: int = 1):
    """Plain torch version of the backward kernel: the serial recursion of
    ``gar.riccati`` at nth = 0, which like the kernel never reads the
    terminal knot's A, B and f."""
    return _riccati.backward_sweep(knots, mueq, refine_steps)


def _spd_inv(A: torch.Tensor) -> torch.Tensor:
    """A⁻¹ of the symmetrized A; NaN where A is not positive definite (the
    kernel inverts by elimination and poisons a non-positive pivot)."""
    A = 0.5 * (A + A.mT)
    return torch.cholesky_inverse(cholesky(A))


def kkt_inverse_solve_ref(R: torch.Tensor, D: torch.Tensor, mu, b1: torch.Tensor,
                          b2: torch.Tensor, refine_steps: int = 1):
    """The backward kernel's KKT solve in plain torch, in the kernel's
    order: the explicit inverse T of ``[[R, Dᵀ], [D, -µI]]``,

        T = [[R⁻¹ - U (R⁻¹Dᵀ)ᵀ, U], [Uᵀ, -S⁻¹]],
        S = sym(µI + D R⁻¹Dᵀ),  U = R⁻¹Dᵀ S⁻¹,

    then sol = T·rhs and ``refine_steps`` rounds of sol += T·(rhs - KKT·sol).
    Same contract as ``linalg.schur.kkt_solve_refined``: R (..., n, n),
    D (..., m, n), b1 (..., n, p), b2 (..., m, p); returns (k, z). R is
    symmetrized first, as the kernel does. The tests and chip_smoke.py
    hold this formulation against the Cholesky path."""
    nu, nc = R.shape[-1], D.shape[-2]
    mu = torch.as_tensor(mu, dtype=R.dtype, device=R.device)
    mu = mu.reshape(mu.shape + (1, 1))
    R = 0.5 * (R + R.mT)
    Rinv = _spd_inv(R)
    if nc > 0:
        eye = torch.eye(nc, dtype=R.dtype, device=R.device)
        RiDt = Rinv @ D.mT
        Sinv = _spd_inv(mu * eye + D @ RiDt)
        U = RiDt @ Sinv
        T = torch.cat([torch.cat([Rinv - U @ RiDt.mT, U], -1),
                       torch.cat([U.mT, -Sinv], -1)], -2)
        KKT = torch.cat([torch.cat([R, D.mT], -1),
                         torch.cat([D, (-mu * eye).expand(D.shape[:-1] + (nc,))], -1)], -2)
    else:
        T, KKT = Rinv, R
    rhs = torch.cat([b1, b2], -2)
    sol = T @ rhs
    for _ in range(refine_steps):
        sol = sol + T @ (rhs - KKT @ sol)
    return sol[..., :nu, :], sol[..., nu:, :]


@functools.lru_cache(maxsize=None)
def _backward_smem_bytes(nx: int, nu: int, nc: int) -> int:
    return cuda_build.load("riccati_backward").riccati_backward_smem_bytes(nx, nu, nc)


@functools.lru_cache(maxsize=None)
def _backward_variant(nx: int, nu: int, nc: int) -> int:
    return cuda_build.load("riccati_backward").riccati_backward_variant(nx, nu, nc)


def backward_variant(nx: int, nu: int, nc: int) -> str:
    """Which instantiation of the backward kernel serves these dims, widths
    fixed at compile time: ``"bench"`` (nx = 56, nu = nc = 22) or ``"walk"``
    (nx = 56, nu = 22, nc = 0, the talos walk); or ``"runtime"`` (widths
    read at launch)."""
    v = _backward_variant(nx, nu, nc)
    if v < 0:
        raise ValueError(f"dims nx={nx}, nu={nu}, nc={nc} are outside the backward kernel")
    return {1: "bench", 2: "walk"}.get(v, "runtime")


def backward_blocks_per_sm(nx: int, nu: int, nc: int) -> int:
    """Blocks of the backward kernel that one SM of the current card holds
    at once at these dims (its occupancy, from the CUDA runtime)."""
    n = cuda_build.load("riccati_backward").riccati_backward_blocks_per_sm(nx, nu, nc)
    if n < 0:
        raise RuntimeError(f"riccati_backward occupancy query failed: cudaError {-n}")
    return n


@named_scope("gar.fused.backward")
def backward_sweep_batched(knots: Knot, mueq: torch.Tensor, refine_steps: int = 1):
    """Fused backward sweep over a batch of stacked knot sets.

    knots: Knot with leading axes (B, N+1); mueq: (B,) or a scalar.
    Returns (Gains, CostToGo) with leading axes (B, N+1). nth must be 0.
    CPU tensors go through the plain version; CUDA tensors launch
    ``csrc/riccati_backward.cu``.
    """
    if knots.Gth.shape[-1] != 0:
        raise NotImplementedError(
            "fused riccati: θ-blocks (nth > 0) use gar.riccati (the serial path)")
    if knots.Q.device.type == "cpu":
        return backward_sweep_batched_ref(knots, mueq, refine_steps)
    if knots.Q.device.type != "cuda":
        raise ValueError(f"unsupported device {knots.Q.device}")
    Bsz, L = knots.Q.shape[:2]
    nx, nu, nc = knots.Q.shape[-1], knots.R.shape[-1], knots.C.shape[-2]
    if nu < 1:
        raise ValueError("the backward kernel needs nu >= 1")
    dims = dict(nx=nx, nu=nu, nc=nc)
    named = {f: getattr(knots, f) for f in _KNOT_SHAPES}
    _check_kernel_args(named, Bsz, L, dims, _KNOT_SHAPES, knots.Q.device)
    mu = batch_mu(mueq, Bsz, knots.Q).contiguous()
    _vec_check("mueq", mu, (Bsz,), knots.Q.device)

    if _backward_variant(nx, nu, nc) < 0:
        raise ValueError(
            f"dims nx={nx}, nu={nu}, nc={nc}: the backward kernel takes nu, nc <= 32 "
            f"and nx <= 84 (one tile of Q̂ per thread)")
    smem = _backward_smem_bytes(nx, nu, nc)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"dims nx={nx}, nu={nu}, nc={nc} need {smem} bytes of shared "
            f"memory per block; the kernel allows {MAX_SMEM_BYTES}")
    outs = {
        name: torch.empty((Bsz, L) + tuple(dims[s] for s in shape),
                          dtype=torch.float32, device=knots.Q.device)
        for name, shape in _GAIN_SHAPES.items()
    }
    fn = cuda_build.load("riccati_backward").riccati_backward_f32
    order_out = ("K", "Z", "kff", "zff", "yff", "Acl", "Vxx", "vx")
    with torch.cuda.device(knots.Q.device):  # launch on the tensors' card
        err = fn(
            *(named[f].data_ptr() for f in _KNOT_SHAPES), mu.data_ptr(),
            *(outs[n].data_ptr() for n in order_out),
            Bsz, L, nx, nu, nc, int(refine_steps),
            torch.cuda.current_stream(knots.Q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"riccati_backward kernel launch failed: cudaError {err}")
    backward_sweep_batched.launches += 1
    return _pack(outs["kff"], outs["zff"], outs["yff"], outs["K"], outs["Z"],
                 outs["Acl"], outs["Vxx"], outs["vx"])


backward_sweep_batched.launches = 0


# ---------------------------------------------------------------------------
# Forward sweep
# ---------------------------------------------------------------------------


def forward_sweep_batched_ref(gains: Gains, vms: CostToGo, x0: torch.Tensor,
                              lbd0: torch.Tensor):
    """Plain torch version of the forward kernels: the serial rollout of
    ``gar.riccati`` with a zero-width θ."""
    return _riccati.forward_sweep(gains, vms, x0, lbd0, x0.new_zeros((x0.shape[0], 0)))


# The forward kernels' instantiations: nx = 56 compiled in, or nx read at
# launch up to FORWARD_MAX_NX (a ring of four knots of Acl in shared memory).
FORWARD_BENCH_NX = 56
FORWARD_MAX_NX = 112


def forward_variant(nx: int, ptrs) -> tuple:
    """Which instantiation of the forward kernels serves state width ``nx``,
    and the width of their copies in floats: ``("bench", w)`` for nx = 56
    (compiled in; nu and nc only count rows and are read at launch) or
    ``("runtime", w)`` for any other nx up to 112. ``w`` is 4 (16-byte
    copies) where nx % 4 == 0 and every address in ``ptrs`` (those of the
    inputs the kernels copy by rows: K, Z, Acl, Vxx, yff) is 16-byte
    aligned, else 2 (8 bytes) or 1."""
    if not 1 <= nx <= FORWARD_MAX_NX:
        raise ValueError(f"nx={nx}: the forward kernels take 1 <= nx <= {FORWARD_MAX_NX}")
    vec = next(w for w in (4, 2, 1)
               if nx % w == 0 and all(p % (4 * w) == 0 for p in ptrs))
    return ("bench" if nx == FORWARD_BENCH_NX else "runtime"), vec


def forward_plan(gains: Gains, vms: CostToGo) -> tuple:
    """``forward_variant`` of these inputs (the outputs are fresh
    allocations, aligned for any width; the kernels' entry points check
    them too)."""
    rowwise = (gains.K, gains.Z, gains.Acl, vms.Vxx, gains.yff)
    return forward_variant(gains.K.shape[-1], [a.data_ptr() for a in rowwise if a.numel()])


def forward_chain_occupancy(nx: int) -> tuple:
    """(blocks per SM, bytes of shared memory per block) of the forward
    chain kernel at state width ``nx`` on the current card."""
    variant = int(forward_variant(nx, ())[0] == "bench")
    lib = cuda_build.load("riccati_forward")
    n = lib.riccati_forward_chain_blocks_per_sm(nx, variant)
    if n < 0:
        raise RuntimeError(f"riccati_forward occupancy query failed: cudaError {-n}")
    return n, lib.riccati_forward_chain_smem_bytes(nx, variant)


def forward_halves(gains: Gains, vms: CostToGo, x0: torch.Tensor, lbd0: torch.Tensor):
    """The two kernel launches of one forward sweep of CUDA tensors.

    Checks the arguments and allocates the outputs; returns
    ``(outs, (chain, rows))``: outs = (xs, us, vs, lbds), and two callables
    that launch, on the current stream, the chain (xs) and then the rows
    (us, vs, lbds from xs). Each raises if its launch is refused."""
    Bsz, L, nu, nx = gains.K.shape
    nc = gains.Z.shape[-2]
    dev = x0.device
    dims = dict(nx=nx, nu=nu, nc=nc)
    named = dict(K=gains.K, Z=gains.Z, Acl=gains.Acl, Vxx=vms.Vxx,
                 kff=gains.kff, zff=gains.zff, yff=gains.yff, vx=vms.vx)
    _check_kernel_args(named, Bsz, L, dims, _GAIN_SHAPES, dev)
    _vec_check("x0", x0, (Bsz, nx), dev)
    _vec_check("lbd0", lbd0, (Bsz, nx), dev)
    xs, us, vs, lbds = outs = tuple(
        torch.empty((Bsz, L, n), dtype=torch.float32, device=dev) for n in (nx, nu, nc, nx))
    name, vec = forward_plan(gains, vms)
    variant = int(name == "bench")
    lib = cuda_build.load("riccati_forward")
    p = lambda *ts: tuple(t.data_ptr() for t in ts)

    def launch(half, fn, *args):
        with torch.cuda.device(dev):  # launch on the tensors' card
            err = fn(*args, variant, vec, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"riccati_forward {half} kernel launch failed: cudaError {err}")

    chain = lambda: launch(
        "chain", lib.riccati_forward_chain_f32,
        *p(named["Acl"], named["yff"], x0, xs), Bsz, L, nx)
    rows = lambda: launch(
        "rows", lib.riccati_forward_rows_f32,
        *p(named["K"], named["Z"], named["Vxx"], named["kff"], named["zff"], named["vx"],
           lbd0, xs, us, vs, lbds), Bsz, L, nx, nu, nc)
    return outs, (chain, rows)


@named_scope("gar.fused.forward")
def forward_sweep_batched(gains: Gains, vms: CostToGo, x0: torch.Tensor,
                          lbd0: torch.Tensor):
    """Fused closed-loop forward rollout.

    gains/vms: leading axes (B, N+1); x0, lbd0: (B, nx) (λ0 already
    zero-padded to nx). Returns (xs, us, vs, lbds), each (B, N+1, ·).
    CPU tensors go through the plain version; CUDA tensors launch the two
    kernels of ``csrc/riccati_forward.cu``, and ``launches`` counts sweeps.
    """
    if x0.device.type == "cpu":
        return forward_sweep_batched_ref(gains, vms, x0, lbd0)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    outs, halves = forward_halves(gains, vms, x0, lbd0)
    for launch in halves:
        launch()
    forward_sweep_batched.launches += 1
    return outs


forward_sweep_batched.launches = 0


# ---------------------------------------------------------------------------
# Problem-level entry points (mirror gar.riccati.backward / forward)
# ---------------------------------------------------------------------------


def backward(problem: LQRProblem, mueq, mudyn=0.0, refine_steps: int = 1
             ) -> RiccatiFactors:
    """Fused backward sweep + the small initial-stage KKT solve in torch
    (nth == 0 only)."""
    knots = Knot(*(a.contiguous() for a in knots_of(problem)))
    gains, vms = backward_sweep_batched(knots, mueq, refine_steps)
    return initial_solve(problem, vms, mudyn, refine_steps, gains)


def forward(problem: LQRProblem, factors: RiccatiFactors, theta=None):
    """Fused forward rollout (nth == 0 only)."""
    th = problem.Q.new_zeros((problem.batch, 0))
    x0, lbd0 = initial_costate(problem, factors, th)
    return forward_sweep_batched(factors.gains, factors.vm, x0.contiguous(),
                                 lbd0.contiguous())


def solve(problem: LQRProblem, mueq, mudyn=0.0, refine_steps: int = 1):
    """backward + forward. Returns (xs, us, vs, lbdas, factors)."""
    factors = backward(problem, mueq, mudyn, refine_steps)
    xs, us, vs, lbds = forward(problem, factors)
    return xs, us, vs, lbds, factors
