"""The layout probe's CUDA source (``csrc/layout_probe.cu``) run on the CPU:
compiled by g++ against an emulation of the CUDA built-ins
(``tests/cuda_emulation.py``; its ``mma_tf32_m16n8k8`` rounds each input
as ``cvt.rna.tf32`` does, lays the fragments out as the PTX ISA does for
m16n8k8 ``.tf32`` and sums in float32) and held against the plain
versions (``layout_probe.*_ref``) with the card's gate,
``TOL_PER_REP``·rep·max|plain|, at rep 1 and 3: each body at small and
ragged shapes (rows, columns and depth off the tiles, fewer rows than
lanes) and at P1a's own shape. One case shows why the products take
three TF32 passes: at P1b's shape the same kernel with the low halves
dropped, one TF32 pass, misses the gate that the three passes meet.
chip_smoke.py holds the kernels on the card at the probe's shapes.
Skipped where there is no g++."""

import ctypes

import numpy as np
import pytest
import torch

import cuda_emulation as E

from aligator_tpu_torch.probes import layout_probe as LP
from aligator_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

SOURCE = cuda_build.CSRC / "layout_probe.cu"
# the split of x into TF32 halves; "lo = 0" leaves one pass, hi·hi′
LOW_HALF = "  lo = trunc_tf32(x - hi);\n"


def _load(so):
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in cuda_build.SIGNATURES["layout_probe"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if E.compiler() is None:
        pytest.skip("no g++ to compile the emulated kernel")
    return _load(E.build(SOURCE, tmp_path_factory.mktemp("probeemu")))


@pytest.fixture(scope="module")
def one_pass(tmp_path_factory):
    """The same source with the low halves dropped: one TF32 pass."""
    if E.compiler() is None:
        pytest.skip("no g++ to compile the emulated kernel")
    src = SOURCE.read_text()
    assert src.count(LOW_HALF) == 1
    d = tmp_path_factory.mktemp("probeemu1")
    cu = d / "layout_probe.cu"
    cu.write_text(src.replace(LOW_HALF, "  lo = 0.f;\n"))
    return _load(E.build(cu, d))


def _inputs(shapes, seed=0):
    return [torch.as_tensor(np.random.default_rng(seed + i).standard_normal(s),
                            dtype=torch.float32) for i, s in enumerate(shapes)]


# body -> (C entry, plain version, output shape and dims from the inputs)
BODIES = {
    "batched_mm": ("probe_batched_mm_f32", LP.batched_mm_ref,
                   lambda a, b: ((a.shape[0], a.shape[1], b.shape[2]),
                                 (a.shape[0], a.shape[1], a.shape[2], b.shape[2]))),
    "shared_mm": ("probe_shared_mm_f32", LP.shared_mm_ref,
                  lambda a, b: ((a.shape[0], b.shape[1]), (a.shape[0], a.shape[1], b.shape[1]))),
    "transpose": ("probe_transpose_f32", LP.transpose_ref,
                  lambda x: ((x.shape[1], x.shape[2], x.shape[0]), tuple(x.shape))),
    "bcast_fma": ("probe_bcast_fma_f32", LP.bcast_fma_ref,
                  lambda a, b: (tuple(b.shape), tuple(b.shape))),
    "slab_reduce": ("probe_slab_reduce_f32", LP.slab_reduce_ref,
                    lambda b: (tuple(b.shape[1:]), tuple(b.shape))),
    "lanes_apply": ("probe_lanes_apply_f32", LP.lanes_apply_ref,
                    lambda L, B: (tuple(B.shape), tuple(B.shape[1:]))),
}

# (body, input shapes): small and ragged shapes, then P1a's own
CASES = [
    ("batched_mm", [(2, 5, 6), (2, 6, 7)]),
    ("batched_mm", [(3, 20, 13), (3, 13, 11)]),
    ("batched_mm", [(16, 24, 24), (16, 24, 57)]),   # P1a
    ("batched_mm", [(10, 100, 9), (10, 9, 70)]),    # > 4·132 tiles: two a warp
    ("shared_mm", [(12, 6), (6, 5)]),
    ("shared_mm", [(40, 17), (17, 19)]),
    ("transpose", [(8, 4, 5)]),
    ("transpose", [(7, 3, 5)]),
    ("bcast_fma", [(4, 8), (4, 5, 8)]),
    ("bcast_fma", [(3, 7), (3, 6, 7)]),
    ("slab_reduce", [(4, 5, 8)]),
    ("slab_reduce", [(24, 5, 8)]),
    ("slab_reduce", [(2, 3, 7)]),
    ("slab_reduce", [(9, 3, 7)]),
    ("lanes_apply", [(LP.R, LP.R, 8), (LP.R, 5, 8)]),
    ("lanes_apply", [(LP.R, LP.R, 3), (LP.R, 6, 3)]),
]


def _run(lib, body, inputs, rep):
    c_name, _, dims_of = BODIES[body]
    out_shape, dims = dims_of(*inputs)
    out = torch.full(out_shape, float("nan"))
    faults = lib.emu_faults()
    err = getattr(lib, c_name)(*(t.data_ptr() for t in inputs), out.data_ptr(), *dims, rep,
                               None)
    assert err == 0
    assert lib.emu_faults() == faults, "a warp deadlocked at a shuffle or an mma"
    return out


def _gate(got, want, rep):
    """max|Δ| and the card's gate TOL_PER_REP·rep·max|plain|."""
    return float((got - want).abs().max()), LP.TOL_PER_REP * rep * float(want.abs().max())


@pytest.mark.parametrize("rep", [1, 3])
@pytest.mark.parametrize("body, shapes", CASES,
                         ids=[f"{b}-{'x'.join(map(str, s[0]))}" for b, s in CASES])
def test_emulated_body_matches_its_plain_version(lib, body, shapes, rep):
    inputs = _inputs(shapes)
    got = _run(lib, body, inputs, rep)
    want = BODIES[body][1](*inputs, rep)
    err, gate = _gate(got, want, rep)
    assert err <= gate, (err, gate)


def test_one_tf32_pass_misses_the_gate_that_three_meet(lib, one_pass):
    """P1b's shape, 16 × (56 × 56 @ 56 × 78), at its lower repeat count:
    three passes within the gate, one pass (hi·hi′ alone) outside it."""
    p = LP.probes()[1]
    inputs = LP.make_inputs(p.shapes, "cpu")
    rep = p.reps[0]
    want = LP.batched_mm_ref(*inputs, rep)
    err3, gate = _gate(_run(lib, "batched_mm", inputs, rep), want, rep)
    err1, _ = _gate(_run(one_pass, "batched_mm", inputs, rep), want, rep)
    assert err3 <= gate < err1, (err3, gate, err1)


def test_emulated_launches_refuse_what_the_kernels_do_not_take(lib):
    """A product deeper than 64 and a slab of more than 48 rows."""
    a, b = _inputs([(1, 16, 65), (1, 65, 8)])
    out = torch.empty(1, 16, 8)
    assert lib.probe_batched_mm_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(), 1, 16, 65, 8,
                                    1, None) != 0
    (s,) = _inputs([(49, 2, 4)])
    out = torch.empty(2, 4)
    assert lib.probe_slab_reduce_f32(s.data_ptr(), out.data_ptr(), 49, 2, 4, 1, None) != 0
