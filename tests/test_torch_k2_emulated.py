"""The forward Riccati kernel K2's CUDA source (``csrc/riccati_forward.cu``)
run on the CPU: compiled by g++ against an emulation of the CUDA built-ins
(``tests/cuda_emulation.py``: mbarriers, 1-D bulk copies and cp.async
copies that land only when their barrier completes, named barriers) and
held against its plain version (``fused_riccati.forward_sweep_batched_ref``):
the small kernel in each class on both sides of its boundaries, by bulk
copies and by cp.async copies of 16, 8 and 4 bytes, at nc = 0, at L = 1
and 2, with a ring shorter than the horizon (warps at random speeds) and
with K, Z and Vxx read from device memory; the pair at nx = 56 and the
small kernel forced there; the plan's C
entry ``riccati_forward_plan`` against ``fused_riccati.forward_plan`` at
every width; and the launches the kernel refuses. The card runs the same
checks in chip_smoke.py; here they catch an indexing, barrier or copy
fault without one. Skipped where there is no g++.

Gate: the float32 sums are taken in another order than the plain
version's (four partial sums a row in the chain, four lanes a row in the
rows), so each output is held to 2e-5·max(1, max|·|), ~170 ulp of the
largest entry, as tests/test_torch_forward.py holds the plain version to
the Pallas kernel.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

import cuda_emulation as E

from aligator_tpu_torch.gar import fused_riccati as FR
from aligator_tpu_torch.probes import k2_phases, k2_split
from aligator_tpu_torch.utils import cuda_build

torch.set_num_threads(1)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SMALL = ("riccati_forward_small_f32", [_P] * 14 + [_I] * 8 + [_P], _I)
_CHAIN = ("riccati_forward_chain_f32", [_P] * 4 + [_I] * 4 + [_P], _I)
_ROWS = ("riccati_forward_rows_f32", [_P] * 11 + [_I] * 6 + [_P], _I)
_PLAN = ("riccati_forward_plan", [_I] * 2, _I)
_STAGES = ("riccati_forward_small_stages", [_I] * 5, _I)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if E.compiler() is None:
        pytest.skip("no g++ to compile the emulated kernel")
    so = E.build(cuda_build.CSRC / "riccati_forward.cu", tmp_path_factory.mktemp("k2emu"))
    lib = ctypes.CDLL(str(so))
    for name, args, res in (_SMALL, _CHAIN, _ROWS, _PLAN, _STAGES):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = res
    lib.emu_set_seed.argtypes = [ctypes.c_uint]
    return lib


@pytest.fixture
def seeded(lib):
    """Warps at random speeds (``cuda_emulation``'s seeded schedule) while
    the test runs, so that they drift apart as they may on the card."""
    lib.emu_set_seed(12345)
    yield lib
    lib.emu_set_seed(0)


def _offset(a: torch.Tensor, k: int) -> torch.Tensor:
    """A contiguous copy of ``a`` starting ``k`` floats into its storage."""
    buf = torch.empty(a.numel() + k, dtype=a.dtype)
    out = buf[k:].view(a.shape)
    out.copy_(a)
    return out


def _gains(B, N, nx, nu, nc, seed, k=0):
    """Random float32 forward inputs (a stable closed loop, the terminal
    knot's Acl and yff NaN: the kernel must never read them), each gain
    ``k`` floats past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    L, s = N + 1, nx ** -0.5
    r = lambda *shape, scale=1.0: torch.as_tensor(
        (scale * rng.standard_normal(shape)).astype(np.float32))
    Acl = 0.9 * torch.eye(nx) + r(B, L, nx, nx, scale=0.05 * s)
    yff = r(B, L, nx)
    Acl[:, -1] = yff[:, -1] = float("nan")
    t = [r(B, L, nu), r(B, L, nc), yff, r(B, L, nu, nx, scale=s), r(B, L, nc, nx, scale=s),
         Acl, r(B, L, nx, nx, scale=s), r(B, L, nx)]
    g, v = FR._pack(*(_offset(a, k) for a in t))
    return g, v, r(B, nx), r(B, nx)


def _run(lib, g, v, x0, l0, plan, rows=1, bulk=False):
    """The emulated sweep: the small kernel of class code ``plan`` (0: the
    plan's own; its copies bulk where ``bulk`` and 16 bytes may be copied),
    or the pair for plan 1. Returns (err, outs)."""
    Bsz, L, nu, nx = g.K.shape
    nc = g.Z.shape[-2]
    vec = FR.forward_copy(nx, FR._rowwise_ptrs(g, v))
    outs = tuple(torch.full((Bsz, L, n), float("nan")) for n in (nx, nu, nc, nx))
    p = lambda *ts: [t.data_ptr() for t in ts]
    xs, us, vs, lbds = outs
    if plan == 1:
        err = lib.riccati_forward_chain_f32(*p(g.Acl, g.yff, x0, xs), Bsz, L, nx, vec, None)
        err = err or lib.riccati_forward_rows_f32(
            *p(g.K, g.Z, v.Vxx, g.kff, g.zff, v.vx, l0, xs, us, vs, lbds), Bsz, L, nx, nu, nc,
            vec, None)
    else:
        err = lib.riccati_forward_small_f32(
            *p(g.Acl, g.yff, x0, g.K, g.Z, v.Vxx, g.kff, g.zff, v.vx, l0, xs, us, vs, lbds),
            Bsz, L, nx, nu, nc, plan, 0 if bulk and vec == 4 else vec, rows, None)
    return err, outs


def _check(out, g, v, x0, l0):
    ref = FR.forward_sweep_batched_ref(g, v, x0, l0)
    for name, a, b in zip(("xs", "us", "vs", "lbds"), out, ref):
        assert a.shape == b.shape, name
        if not b.numel():
            continue
        assert bool(torch.isfinite(a).all()), name
        gate = 2e-5 * max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= gate, name
    assert torch.equal(out[3][:, 0], l0)


# (B, N, nx, nu, nc, offset in floats, plan): each class on both sides of
# its boundaries, by bulk copies (k = 0, nx % 4 == 0) and by cp.async of 16,
# 8 (k = 2 or nx % 4 == 2) and 4 bytes (odd nx, k = 1); chunks of one knot
# and of several
CASES = [
    (2, 5, 12, 4, 6, 0, "small<16>"),        # the quadrotor
    (2, 5, 36, 12, 0, 0, "small<64>"),       # the solo jump
    (2, 4, 1, 1, 0, 0, "small<16>"),
    (2, 4, 16, 3, 2, 0, "small<16>"),
    (2, 4, 17, 3, 2, 0, "small<32>"),
    (2, 4, 32, 5, 0, 2, "small<32>"),
    (1, 3, 33, 2, 3, 1, "small<64>"),
    (1, 3, 64, 4, 4, 0, "small<64>"),
    (1, 2, 65, 3, 1, 0, "small<112>"),
    (1, 2, 112, 3, 2, 0, "small<112>"),
    (1, 2, 71, 22, 22, 0, "small<112>"),
    (3, 6, 7, 3, 2, 0, "small<16>"),
    (2, 0, 12, 4, 6, 0, "small<16>"),        # L = 1
    (2, 1, 36, 12, 0, 0, "small<64>"),       # L = 2
    (2, 1, 13, 4, 0, 1, "small<16>"),
    (2, 40, 12, 4, 6, 0, "small<16>"),       # chunks of 2 knots, the last one short
    (1, 22, 36, 12, 0, 2, "small<64>"),
]


@pytest.mark.parametrize("B, N, nx, nu, nc, k, plan", CASES)
def test_emulated_small_kernel_matches_its_plain_version(lib, B, N, nx, nu, nc, k, plan):
    assert str(FR.forward_plan(nx, B)) == plan
    g, v, x0, l0 = _gains(B, N, nx, nu, nc, seed=nx + 100 * nu + 10000 * nc + k, k=k)
    for bulk in (False, True):  # the same where 16 bytes may not be copied
        faults = lib.emu_faults()
        err, out = _run(lib, g, v, x0, l0, 0, bulk=bulk)
        assert err == 0
        assert lib.emu_faults() == faults, "a copy misaligned or never waited for, or a deadlock"
        _check(out, g, v, x0, l0)


@pytest.mark.parametrize("nx, nu, nc, N, staged", [
    (12, 4, 6, 200, True), (36, 12, 0, 40, True), (55, 22, 22, 40, True),
    (112, 30, 30, 12, False)])
def test_emulated_small_kernel_short_ring_and_unstaged_rows(seeded, nx, nu, nc, N, staged):
    """A ring shorter than the horizon, its slots refilled and their
    barriers cycled through both parities, with the warps at random speeds
    (the quadrotor's widths at N = 200, the jump's and nx = 55 at N = 40,
    six knots in the ring at the latter, fewer than the rows warps), and
    widths where two knots of K, Z and Vxx do not fit in shared memory (the
    rows read them from device memory)."""
    lib = seeded
    ring = lib.riccati_forward_small_stages(nx, nu, nc, N + 1, 1)
    chunks, chunk = abs(ring) // 100, abs(ring) % 100
    assert chunks >= 2 and chunks * chunk < N + 1
    assert (ring > 0) == staged
    g, v, x0, l0 = _gains(1, N, nx, nu, nc, seed=nx)
    for bulk in (False, True):
        faults = lib.emu_faults()
        err, out = _run(lib, g, v, x0, l0, 0, bulk=bulk)
        assert err == 0 and lib.emu_faults() == faults
        _check(out, g, v, x0, l0)


@pytest.mark.parametrize("nc, k", [(22, 0), (0, 2)], ids=["bench", "walk-8B"])
def test_emulated_pair_and_forced_small_kernel_at_nx_56(lib, nc, k):
    """The pair, the plan at nx = 56, at the bench and the walk's widths
    (the latter 8 bytes past a 16-byte boundary), and the small kernel's
    class 64 forced at the same inputs (bulk and cp.async copies); the
    chain alone (rows 0) gives the same xs bits as the whole sweep."""
    g, v, x0, l0 = _gains(2, 4, 56, 22, nc, seed=5 + nc, k=k)
    assert FR.forward_plan(56, 2).kernel == "pair"
    for plan, bulk in ((1, False), (64, False), (64, True)):
        faults = lib.emu_faults()
        err, out = _run(lib, g, v, x0, l0, plan, bulk=bulk)
        assert err == 0 and lib.emu_faults() == faults, plan
        _check(out, g, v, x0, l0)
    err, chain = _run(lib, g, v, x0, l0, 64, rows=0)
    assert err == 0
    assert torch.equal(chain[0], _run(lib, g, v, x0, l0, 64)[1][0])


def test_emulated_refusals(lib):
    """Launches the kernel refuses: bulk or 16-byte copies off a 16-byte
    boundary, 8-byte copies off an 8-byte boundary or at odd nx, a class that does not hold nx,
    nx outside 1..112, and the pair at nx != 56; the wrapper's plan refuses
    the same widths."""
    g, v, x0, l0 = _gains(1, 2, 12, 4, 6, seed=1, k=1)
    Bsz, L, nu, nx = g.K.shape
    outs = tuple(torch.zeros((Bsz, L, n)) for n in (nx, nu, 6, nx))
    p = lambda *ts: [t.data_ptr() for t in ts]
    args = p(g.Acl, g.yff, x0, g.K, g.Z, v.Vxx, g.kff, g.zff, v.vx, l0, *outs)
    small = lambda nx_, plan, vec: lib.riccati_forward_small_f32(
        *args, Bsz, L, nx_, nu, 6, plan, vec, 1, None)
    assert small(12, 0, 0) != 0       # misaligned for bulk copies
    assert small(12, 0, 4) != 0       # misaligned for 16-byte copies
    assert small(12, 0, 2) != 0       # 4 bytes past a boundary: not 8-byte aligned
    assert small(12, 32, 1) != 0      # class 32 does not hold nx = 12
    assert small(12, 56, 1) != 0
    assert small(113, 0, 1) != 0
    assert small(0, 0, 1) != 0
    assert lib.riccati_forward_chain_f32(*p(g.Acl, g.yff, x0, outs[0]), 1, L, 12, 1, None) != 0
    g7, v7, x7, l7 = _gains(1, 2, 7, 3, 0, seed=2)
    o7 = tuple(torch.zeros((1, 3, n)) for n in (7, 3, 0, 7))
    assert lib.riccati_forward_small_f32(
        *p(g7.Acl, g7.yff, x7, g7.K, g7.Z, v7.Vxx, g7.kff, g7.zff, v7.vx, l7, *o7),
        1, 3, 7, 3, 0, 0, 2, 1, None) != 0  # 8-byte copies at odd nx
    assert lib.riccati_forward_small_f32(
        *p(g7.Acl, g7.yff, x7, g7.K, g7.Z, v7.Vxx, g7.kff, g7.zff, v7.vx, l7, *o7),
        1, 3, 7, 3, 0, 0, 0, 1, None) != 0  # bulk copies at nx % 4 != 0
    for nx_ in (0, 113):
        with pytest.raises(ValueError, match="1 <= nx <= 112"):
            FR.forward_plan(nx_, 1)


def test_c_entry_agrees_with_forward_plan(lib):
    """riccati_forward_plan and forward_plan name the same kernel, or both
    refuse, at every nx in 0..113 and batches 1, 16, 64 and 256."""
    for nx in range(114):
        for B in (1, 16, 64, 256):
            try:
                want = FR.forward_plan(nx, B).code
            except ValueError:
                want = -1
            assert lib.riccati_forward_plan(nx, B) == want, (nx, B)


def test_phases_probe_instruments_the_small_kernel(tmp_path):
    """The K2 phase probe's copy of the source (a stamp after each part of
    the chain's step and around the producer's wait and copies, the
    counters written out where each loop ends) compiles under the
    emulation, its sweep still matches the plain version, and every part's
    counter of every block comes back filled; both probes refuse to run
    without a card."""
    if E.compiler() is None:
        pytest.skip("no g++ to compile the emulated kernel")
    code = k2_phases.instrument((cuda_build.CSRC / "riccati_forward.cu").read_text())
    assert code.count("K2_STAMP(") == len(k2_phases.STAMPS) + 1  # the stamps, the macro
    cu = tmp_path / "riccati_forward.cu"
    cu.write_text(code)
    lib = ctypes.CDLL(str(E.build(cu, tmp_path)))
    for name, args, res in (_SMALL, _CHAIN, _ROWS, _PLAN, _STAGES):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = res
    lib.k2_prof_read.argtypes = [ctypes.c_void_p, _I]
    lib.k2_prof_clear.argtypes = [_I]
    lib.k2_prof_clear(2 * k2_phases.SLOTS)
    g, v, x0, l0 = _gains(2, 30, 12, 4, 6, seed=9)
    err, out = _run(lib, g, v, x0, l0, 0, bulk=True)
    assert err == 0
    _check(out, g, v, x0, l0)
    h = (ctypes.c_longlong * (2 * k2_phases.SLOTS))()
    assert lib.k2_prof_read(ctypes.addressof(h), 2 * k2_phases.SLOTS) == 0
    for b in range(2):
        assert all(h[b * k2_phases.SLOTS + i] > 0 for i in range(len(k2_phases.STAMPS))), b
    for probe in (k2_phases, k2_split):
        if not torch.cuda.is_available():
            with pytest.raises(SystemExit, match="no CUDA device"):
                probe.main([])


def test_wrapper_raises_on_a_refused_launch(lib, monkeypatch):
    """The wrapper's launches through the emulated library: a class that does
    not hold nx is refused by the C entry and raises, the pair at nx != 56
    raises before any launch, and the plan's own launch runs; no path falls
    back to the plain version."""
    monkeypatch.setitem(cuda_build._LIBS, "riccati_forward", lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    g, v, x0, l0 = _gains(2, 3, 12, 4, 6, seed=4)
    _, _, parts = FR.forward_parts(g, v, x0, l0, FR.ForwardPlan("small", 32))
    with pytest.raises(RuntimeError, match="cudaError"):
        parts["sweep"]()
    with pytest.raises(ValueError, match="nx = 56 only"):
        FR.forward_parts(g, v, x0, l0, FR.ForwardPlan("pair"))
    out, plan, parts = FR.forward_parts(g, v, x0, l0)
    assert str(plan) == "small<16>"
    parts["sweep"]()
    _check(out, g, v, x0, l0)
