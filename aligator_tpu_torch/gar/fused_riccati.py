"""Fused proximal Riccati sweeps: one kernel launch per sweep for a whole
batch of problems (port of ``aligator_tpu.gar.pallas_riccati``).

Two hand-written CUDA kernels for Hopper (``sm_90a``) carry this module:

* ``csrc/riccati_backward.cu`` — the reverse-time sweep t = N..0, one
  thread block per problem, or at the compiled widths and small batches one
  thread-block cluster of 2, 4 or 8 blocks per problem, the cost-to-go kept
  in shared memory between steps (replaces the Pallas ``_backward_kernel``);
* ``csrc/riccati_forward.cu`` — the closed-loop rollout (replaces
  ``_forward_kernel``): one launch a sweep and one block a problem, the
  state chain x⁺ = yff + Acl x on the fewest warps that hold its rows, the
  knots' gains copied ahead into a ring in shared memory and u, v and λ
  computed by the other warps a few knots behind (``forward_plan``'s small
  kernel); at nx = 56 a pair of kernels (the chain, then the rows over a
  grid of (knot chunk, problem)).

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
from typing import NamedTuple

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
from aligator_tpu_torch.utils import profiling as prof
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


@functools.lru_cache(maxsize=None)
def _backward_cluster(nx: int, nu: int, nc: int, batch: int, device: int) -> int:
    """The cluster size the C entry takes for this launch on that card."""
    with torch.cuda.device(device):
        return cuda_build.load("riccati_backward").riccati_backward_cluster(nx, nu, nc, batch, 0)


# The backward kernel's small-width classes (csrc/riccati_backward.cu): the
# threads of a block and the rows of its Gauss-Jordan chain.
BACKWARD_THREADS = (32, 64, 128, 256)
BACKWARD_CHAINS = (8, 16, 32)
BACKWARD_MAX_NX = 84  # one tile of Q̂ per thread of 256
_COMPILED = {(56, 22, 22): "bench", (56, 22, 0): "walk"}
# The compiled widths' cluster sizes (blocks per problem), and those the
# plan takes: the sizes that chip_smoke.py's k1_cluster_check measured
# faster than one block per problem at every batch the card held them at
# (on an H100 80GB HBM3 at 700.00 W: the bench's widths 0.98, 0.93 and
# 0.91 of one block at 2, 4 and 8, the walk's 1.05, 0.96 and 0.96; PERF.md
# §6 names the runs; csrc riccati_backward.cu `kClusterTaken` holds the
# same).
BACKWARD_CLUSTERS = (1, 2, 4, 8)
BACKWARD_CLUSTER_SIZES = {"bench": (1, 2, 4, 8), "walk": (1, 4, 8)}


class BackwardPlan(NamedTuple):
    """An instantiation of the backward kernel: ``kernel`` is "bench" or
    "walk" (``riccati_backward_kernel`` with those widths compiled in, 256
    threads, a chain of 22) or "small" (``riccati_backward_small<threads,
    chain>``, widths read at launch); ``cluster`` the blocks per problem
    (a thread-block cluster of 2, 4 or 8 at the compiled widths, else 1)."""

    kernel: str
    threads: int
    chain: int
    cluster: int = 1

    @property
    def code(self) -> int:
        """What the C entry ``riccati_backward_variant`` returns for it."""
        return {"bench": 1, "walk": 2}.get(self.kernel, 100 * self.threads + self.chain)

    def __str__(self) -> str:
        return (f"small<{self.threads}, {self.chain}>" if self.kernel == "small"
                else self.kernel)


def _r4(n: int) -> int:
    return (n + 3) & ~3


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def backward_tiles(nx: int, nu: int, nc: int) -> dict:
    """The 4 × 4 tiles of each pass of a knot of the backward kernel, as
    ``csrc/riccati_backward.cu`` lays them out: ``"w"`` Wᵀ = V·[A | f | B]
    over the rows of A, ``"hats"`` H = W·[A | f | B] (``"q"`` of them the
    tiles of Q̂|q̂, each kept by its own thread), ``"solve"`` the KKT
    solve."""
    m, cB = nx + 1, _r4(nx + 1)
    ldM = _r4(cB + nu)
    nt = _cdiv(nx, 4)
    nq = nt * (nt + 1) // 2 + nx // 4
    hats = nq + nt * ((ldM - cB) // 4) + _cdiv(nu, 4) * ((ldM - (nx & ~3)) // 4)
    return dict(w=nt * (ldM // 4), hats=hats, q=nq, solve=_cdiv(nu + nc, 4) * _cdiv(m, 4))


def backward_cluster(kernel: str, batch: int, sms: int = 0, held: dict | None = None) -> int:
    """Blocks per problem: the largest of the kernel's
    ``BACKWARD_CLUSTER_SIZES`` whose ``batch`` clusters the card holds at
    once, one block to an SM: ``held[C]`` clusters of C where the card's own
    count is given (``backward_held``; an H100 holds 15 clusters of 8 and 30
    of 4, as clusters live within a GPC), else sms // C; 1 for the
    small-width classes."""
    fits = held if held is not None else {c: sms // c for c in BACKWARD_CLUSTERS}
    return max(c for c in BACKWARD_CLUSTER_SIZES.get(kernel, (1,))
               if c == 1 or batch <= fits.get(c, 0))


def backward_plan(nx: int, nu: int, nc: int, batch: int = 1, sms: int = 0,
                  held: dict | None = None) -> BackwardPlan:
    """Which instantiation of the backward kernel serves these widths, for
    ``batch`` problems on a card of ``sms`` SMs, or one that holds
    ``held[C]`` clusters of C at once (neither: no cluster): the
    compiled bench (56, 22, 22) or walk (56, 22, 0) widths, with
    ``backward_cluster`` blocks per problem, else the small-width class with
    the fewest threads of ``BACKWARD_THREADS`` that give every tile of a
    knot's largest pass (Wᵀ, the hats or the solve) its own thread (256 past
    that) and the shortest chain of ``BACKWARD_CHAINS`` that holds
    max(nu, nc). Raises ``ValueError`` for widths the kernel does not take:
    nu outside 1..32, nc outside 0..32, nx outside 0..84. The C entries
    ``riccati_backward_variant`` and ``riccati_backward_cluster`` answer
    ``.code`` and ``.cluster`` (the latter asked with 0 SMs counts the
    card's own ``held``, as a launch does); chip_smoke.py holds them
    together."""
    if not (1 <= nu <= 32 and 0 <= nc <= 32):
        raise ValueError(f"nu={nu}, nc={nc}: the backward kernel takes 1 <= nu <= 32 and "
                         f"0 <= nc <= 32 (a factor's rows are a warp's lanes)")
    if not 0 <= nx <= BACKWARD_MAX_NX:
        raise ValueError(f"nx={nx}: the backward kernel takes nx <= {BACKWARD_MAX_NX} "
                         f"(one tile of Q̂ per thread)")
    name = _COMPILED.get((nx, nu, nc))
    if name:
        return BackwardPlan(name, 256, 22, backward_cluster(name, batch, sms, held))
    t = backward_tiles(nx, nu, nc)
    tiles = max(t["w"], t["hats"], t["solve"])
    threads = next((n for n in BACKWARD_THREADS if n >= tiles), BACKWARD_THREADS[-1])
    chain = next(c for c in BACKWARD_CHAINS if c >= max(nu, nc))
    return BackwardPlan("small", threads, chain)


def backward_variant(nx: int, nu: int, nc: int) -> str:
    """The name of the instantiation of the backward kernel that the C
    entry picks for these dims: ``"bench"`` (nx = 56, nu = nc = 22),
    ``"walk"`` (nx = 56, nu = 22, nc = 0), both with their widths compiled
    in, or ``"small<threads, chain>"`` (widths read at launch)."""
    v = _backward_variant(nx, nu, nc)
    if v < 0:
        raise ValueError(f"dims nx={nx}, nu={nu}, nc={nc} are outside the backward kernel")
    if v <= 2:
        return {1: "bench", 2: "walk"}[v]
    return str(BackwardPlan("small", v // 100, v % 100))


def backward_blocks_per_sm(nx: int, nu: int, nc: int) -> int:
    """Blocks of the backward kernel that one SM of the current card holds
    at once at these dims (its occupancy, from the CUDA runtime)."""
    n = cuda_build.load("riccati_backward").riccati_backward_blocks_per_sm(nx, nu, nc)
    if n < 0:
        raise RuntimeError(f"riccati_backward occupancy query failed: cudaError {-n}")
    return n


def backward_max_clusters(nx: int, nu: int, nc: int, cluster: int) -> int:
    """Clusters of ``cluster`` blocks of the backward kernel that the current
    card holds at once at these dims (``cudaOccupancyMaxActiveClusters``;
    1: blocks without a cluster)."""
    n = cuda_build.load("riccati_backward").riccati_backward_max_clusters(nx, nu, nc, cluster)
    if n < 0:
        raise RuntimeError(f"riccati_backward cluster occupancy query failed: cudaError {-n}")
    return n


def backward_held(nx: int, nu: int, nc: int) -> dict:
    """``backward_plan``'s ``held`` on the current card: clusters of each size
    it holds at once at these compiled widths."""
    return {c: backward_max_clusters(nx, nu, nc, c) for c in BACKWARD_CLUSTERS}


@named_scope("gar.fused.backward")
def backward_sweep_batched(knots: Knot, mueq: torch.Tensor, refine_steps: int = 1,
                           cluster: int = 0):
    """Fused backward sweep over a batch of stacked knot sets.

    knots: Knot with leading axes (B, N+1); mueq: (B,) or a scalar.
    Returns (Gains, CostToGo) with leading axes (B, N+1). nth must be 0.
    CPU tensors go through the plain version; CUDA tensors launch
    ``csrc/riccati_backward.cu``. ``cluster`` sets the blocks per problem
    at the compiled widths (1, 2, 4 or 8; 0, the default, takes
    ``backward_plan``'s, which the C entry computes alike);
    ``last_cluster`` records the size of the latest launch and the counter
    ``gar.k1.cluster<C>`` the launches at each size.
    """
    if cluster not in (0,) + BACKWARD_CLUSTERS:
        raise ValueError(f"cluster={cluster}: the backward kernel takes 1, 2, 4 or 8 blocks per "
                         f"problem (0: the plan's)")
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

    variant = _backward_variant(nx, nu, nc)
    if variant < 0:
        raise ValueError(
            f"dims nx={nx}, nu={nu}, nc={nc}: the backward kernel takes nu, nc <= 32 "
            f"and nx <= 84 (one tile of Q̂ per thread)")
    if cluster > 1 and variant > 2:
        raise ValueError(f"cluster={cluster}: the backward kernel takes clusters at the compiled "
                         f"widths only, one block per problem at nx={nx}, nu={nu}, nc={nc}")
    dev_index = knots.Q.device.index
    if dev_index is None:
        dev_index = torch.cuda.current_device()
    cs = cluster or _backward_cluster(nx, nu, nc, Bsz, dev_index)
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
            Bsz, L, nx, nu, nc, int(refine_steps), cs,
            torch.cuda.current_stream(knots.Q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"riccati_backward kernel launch failed (cluster of {cs}): "
                           f"cudaError {err}")
    backward_sweep_batched.launches += 1
    backward_sweep_batched.last_cluster = cs
    prof.count(f"gar.k1.cluster{cs}")
    prof.annotate(cluster=cs)
    return _pack(outs["kff"], outs["zff"], outs["yff"], outs["K"], outs["Z"],
                 outs["Acl"], outs["Vxx"], outs["vx"])


backward_sweep_batched.launches = 0
backward_sweep_batched.last_cluster = 0


# ---------------------------------------------------------------------------
# Forward sweep
# ---------------------------------------------------------------------------


def forward_sweep_batched_ref(gains: Gains, vms: CostToGo, x0: torch.Tensor,
                              lbd0: torch.Tensor):
    """Plain torch version of the forward kernels: the serial rollout of
    ``gar.riccati`` with a zero-width θ."""
    return _riccati.forward_sweep(gains, vms, x0, lbd0, x0.new_zeros((x0.shape[0], 0)))


# The forward kernel's plan (csrc/riccati_forward.cu): the small kernel, one
# launch a sweep and one block a problem, in the least class of
# FORWARD_CLASSES that holds nx, or at nx = 56 the pair of kernels (the
# chain, then the rows), which chip_smoke.py's `k2 small:` lines measured
# faster there than the small kernel at every batch from 1 to 256 (PERF.md
# §6).
FORWARD_BENCH_NX = 56
FORWARD_MAX_NX = 112
FORWARD_CLASSES = (16, 32, 64, 112)


class ForwardPlan(NamedTuple):
    """A kernel of the forward sweep: ``"pair"`` (a chain kernel, then a
    rows kernel, at nx = 56) or ``"small"`` (``riccati_forward_small<nxc>``)."""

    kernel: str
    nxc: int = 0

    @property
    def code(self) -> int:
        """What the C entry ``riccati_forward_plan`` returns for it."""
        return 1 if self.kernel == "pair" else self.nxc

    def __str__(self) -> str:
        return "pair" if self.kernel == "pair" else f"small<{self.nxc}>"


def forward_plan(nx: int, batch: int = 1) -> ForwardPlan:
    """Which kernel serves a forward sweep at state width ``nx`` for
    ``batch`` problems (nu and nc only count rows): the pair at nx = 56,
    else the small kernel's least class that holds nx; the batch changes
    neither. Raises ``ValueError`` outside 1 <= nx <= 112. The C entry
    ``riccati_forward_plan`` answers ``.code``."""
    if not 1 <= nx <= FORWARD_MAX_NX:
        raise ValueError(f"nx={nx}: the forward kernels take 1 <= nx <= {FORWARD_MAX_NX}")
    if nx == FORWARD_BENCH_NX:
        return ForwardPlan("pair")
    return ForwardPlan("small", next(c for c in FORWARD_CLASSES if c >= nx))


def forward_copy(nx: int, ptrs) -> int:
    """The copy method of the forward kernels, in floats: 4 (16 bytes; the
    small kernel's 1-D bulk copies) where nx % 4 == 0 and every address in
    ``ptrs`` (those of the inputs copied by rows: K, Z, Acl, Vxx, yff) is
    16-byte aligned, else 2 (cp.async of 8 bytes) or 1 (4 bytes)."""
    return next(w for w in (4, 2, 1) if nx % w == 0 and all(p % (4 * w) == 0 for p in ptrs))


def forward_variant(nx: int, ptrs, batch: int = 1) -> tuple:
    """``(str(forward_plan(nx, batch)), forward_copy(nx, ptrs))``."""
    return str(forward_plan(nx, batch)), forward_copy(nx, ptrs)


def _rowwise_ptrs(gains: Gains, vms: CostToGo) -> list:
    rowwise = (gains.K, gains.Z, gains.Acl, vms.Vxx, gains.yff)
    return [a.data_ptr() for a in rowwise if a.numel()]


def forward_choice(gains: Gains, vms: CostToGo) -> tuple:
    """``forward_variant`` of these inputs (the outputs are fresh
    allocations, aligned for any width; the entry points check them too)."""
    Bsz, _, _, nx = gains.K.shape
    return forward_variant(nx, _rowwise_ptrs(gains, vms), Bsz)


def forward_occupancy(nx: int, nu: int, nc: int, L: int, batch: int) -> dict:
    """The plan's kernel at these dims on the current card: blocks per SM,
    bytes of shared memory per block and (the small kernel) its ring: the
    chunks, the knots a chunk, and whether K, Z and Vxx go through it."""
    lib = cuda_build.load("riccati_forward")
    n = lib.riccati_forward_blocks_per_sm(nx, nu, nc, L, batch)
    if n < 0:
        raise RuntimeError(f"riccati_forward occupancy query failed: cudaError {-n}")
    ring = lib.riccati_forward_small_stages(nx, nu, nc, L, batch)
    return dict(blocks_per_sm=n, smem=lib.riccati_forward_smem_bytes(nx, nu, nc, L, batch),
                chunks=abs(ring) // 100, chunk=abs(ring) % 100, staged=ring > 0)


def forward_parts(gains: Gains, vms: CostToGo, x0: torch.Tensor, lbd0: torch.Tensor,
                  plan: ForwardPlan | None = None, bulk: bool = True):
    """The launches of one forward sweep of CUDA tensors.

    Checks the arguments and allocates the outputs; returns ``(outs, plan,
    parts)``: outs = (xs, us, vs, lbds), the plan (``forward_plan``'s unless
    one is given) and a dict of callables that launch on the current
    stream: for the pair ``"chain"`` (xs) and ``"rows"`` (us, vs, lbds from
    xs), run in that order; for the small kernel ``"sweep"`` (all four) and
    ``"chain"`` (the same launch with u, v and λ left unwritten, to time the
    chain alone). Where its copies may be 16 bytes, the small kernel's
    producer issues 1-D bulk copies, measured 1.5–2.5× faster than cp.async
    copies of 16 bytes by its 32 lanes (PERF.md §6); ``bulk=False``
    takes the latter, to time them. Each raises if its launch is refused."""
    Bsz, L, nu, nx = gains.K.shape
    nc = gains.Z.shape[-2]
    dev = x0.device
    dims = dict(nx=nx, nu=nu, nc=nc)
    named = dict(K=gains.K, Z=gains.Z, Acl=gains.Acl, Vxx=vms.Vxx,
                 kff=gains.kff, zff=gains.zff, yff=gains.yff, vx=vms.vx)
    _check_kernel_args(named, Bsz, L, dims, _GAIN_SHAPES, dev)
    _vec_check("x0", x0, (Bsz, nx), dev)
    _vec_check("lbd0", lbd0, (Bsz, nx), dev)
    plan = plan or forward_plan(nx, Bsz)
    if plan.kernel == "pair" and nx != FORWARD_BENCH_NX:
        raise ValueError(f"nx={nx}: the pair of forward kernels takes nx = 56 only")
    vec = forward_copy(nx, _rowwise_ptrs(gains, vms))
    xs, us, vs, lbds = outs = tuple(
        torch.empty((Bsz, L, n), dtype=torch.float32, device=dev) for n in (nx, nu, nc, nx))
    lib = cuda_build.load("riccati_forward")
    p = lambda *ts: tuple(t.data_ptr() for t in ts)

    def launch(part, fn, *args):
        with torch.cuda.device(dev):  # launch on the tensors' card
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"riccati_forward {part} launch ({plan}) failed: cudaError {err}")

    if plan.kernel == "pair":
        parts = dict(
            chain=lambda: launch("chain", lib.riccati_forward_chain_f32,
                                 *p(named["Acl"], named["yff"], x0, xs), Bsz, L, nx, vec),
            rows=lambda: launch("rows", lib.riccati_forward_rows_f32,
                                *p(named["K"], named["Z"], named["Vxx"], named["kff"],
                                   named["zff"], named["vx"], lbd0, xs, us, vs, lbds),
                                Bsz, L, nx, nu, nc, vec))
    else:
        copy = 0 if bulk and vec == 4 else vec
        # the pointers are taken at each launch: the closures keep the tensors alive
        small = lambda part, rows: launch(
            part, lib.riccati_forward_small_f32,
            *p(named["Acl"], named["yff"], x0, named["K"], named["Z"], named["Vxx"],
               named["kff"], named["zff"], named["vx"], lbd0, xs, us, vs, lbds),
            Bsz, L, nx, nu, nc, plan.code, copy, rows)
        parts = dict(sweep=lambda: small("sweep", 1), chain=lambda: small("chain", 0))
    return outs, plan, parts


@named_scope("gar.fused.forward")
def forward_sweep_batched(gains: Gains, vms: CostToGo, x0: torch.Tensor,
                          lbd0: torch.Tensor, plan: ForwardPlan | None = None):
    """Fused closed-loop forward rollout.

    gains/vms: leading axes (B, N+1); x0, lbd0: (B, nx) (λ0 already
    zero-padded to nx). Returns (xs, us, vs, lbds), each (B, N+1, ·).
    CPU tensors go through the plain version; CUDA tensors launch
    ``csrc/riccati_forward.cu``: ``forward_plan``'s kernel, or ``plan``.
    ``launches`` counts sweeps and ``last_plan`` is the latest sweep's; the
    counter ``gar.k2.<plan>`` counts the sweeps of each kernel.
    """
    if x0.device.type == "cpu":
        return forward_sweep_batched_ref(gains, vms, x0, lbd0)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    outs, plan, parts = forward_parts(gains, vms, x0, lbd0, plan)
    if plan.kernel == "pair":
        parts["chain"]()
        parts["rows"]()
    else:
        parts["sweep"]()
    forward_sweep_batched.launches += 1
    forward_sweep_batched.last_plan = plan
    prof.count(f"gar.k2.{plan}")
    prof.annotate(kernel=str(plan))
    return outs


forward_sweep_batched.launches = 0
forward_sweep_batched.last_plan = None


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
