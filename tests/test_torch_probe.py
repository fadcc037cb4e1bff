"""The port's layout probe (``aligator_tpu_torch.probes.layout_probe``)
against the Pallas bodies of ``scripts/probe_mosaic.py``, which run here
in interpret mode on the CPU. The same float32 inputs, made from a seed
with numpy, go through each body and its plain torch version at
rep ∈ {1, 3} and small shapes (TB = 8, C = 5, R = 4, and R = 24 where
``k_lanes_apply`` loops over the module-level R). Tolerance: rtol 1e-5
and atol 1e-4·rep (float32 sums taken in another order). The CUDA kernels
themselves are held against the plain versions on the card by
``chip_smoke.py``."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from aligator_tpu_torch.probes import layout_probe as LP
from aligator_tpu_torch.probes import sass_loops as SL

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "probe_mosaic.py")
TB, C, RS = 8, 5, 4

# case -> (Pallas body, plain version, wrapper, input shapes, output shape)
CASES = {
    "P1a": ("k_batched_mm", LP.batched_mm_ref, LP.batched_mm,
            [(2, 24, 24), (2, 24, 57)], (2, 24, 57)),
    "P1b": ("k_batched_mm", LP.batched_mm_ref, LP.batched_mm,
            [(2, 56, 56), (2, 56, 78)], (2, 56, 78)),
    "P1c": ("k_shared_mm", LP.shared_mm_ref, LP.shared_mm, [(12, 6), (6, 5)], (12, 5)),
    "P1d": ("k_transpose", LP.transpose_ref, LP.transpose, [(TB, RS, C)], (RS, C, TB)),
    "P1e": ("k_bcast_fma", LP.bcast_fma_ref, LP.bcast_fma,
            [(RS, TB), (RS, C, TB)], (RS, C, TB)),
    "P1f": ("k_slab_reduce", LP.slab_reduce_ref, LP.slab_reduce, [(RS, C, TB)], (C, TB)),
    "P1g": ("k_lanes_apply", LP.lanes_apply_ref, LP.lanes_apply,
            [(LP.R, LP.R, TB), (LP.R, C, TB)], (LP.R, C, TB)),
}


@pytest.fixture(scope="module")
def probe_mosaic():
    """scripts/probe_mosaic.py as a module (``scripts/`` is no package).
    Importing it sets jax_compilation_cache_dir; the old value is put back."""
    prev = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("probe_mosaic", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
    return mod


def _inputs(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("rep", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_pallas_body(probe_mosaic, case, rep):
    body, plain, _, shapes, out_shape = CASES[case]
    arrays = _inputs(shapes)
    ref = pl.pallas_call(functools.partial(getattr(probe_mosaic, body), rep=rep),
                         out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
                         interpret=True)(*(jnp.asarray(a) for a in arrays))
    got = plain(*(torch.as_tensor(a) for a in arrays), rep)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4 * rep)


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_takes_plain_version_on_cpu(case):
    _, plain, wrapper, shapes, out_shape = CASES[case]
    inputs = [torch.as_tensor(a) for a in _inputs(shapes, seed=1)]
    before = wrapper.launches
    got = wrapper(*inputs, 3)
    assert tuple(got.shape) == out_shape
    assert torch.equal(got, plain(*inputs, 3))
    assert wrapper.launches == before  # no kernel launched
    with pytest.raises(ValueError):
        wrapper(*(t.to("meta") for t in inputs), 3)


def test_probe_table_points_at_the_pallas_bodies():
    """Seven probes, each row's ``replaces`` naming the line of its body."""
    with open(SCRIPT) as f:
        lines = f.read().splitlines()
    table = LP.probes()
    assert [p.tag for p in table] == sorted(CASES)
    for p in table:
        path, line = p.replaces.rsplit(":", 1)
        assert path == "scripts/probe_mosaic.py"
        assert lines[int(line) - 1].startswith(f"def {CASES[p.tag][0]}("), p.tag
        assert p.reps[0] < p.reps[1] and p.flops > 0 and p.nbytes > 0


def test_main_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        LP.main()


# tag -> (float32 instructions of one construct, its product's 2·m·k·n,
# the new and the old bound in µs to four decimals); slab = R·C·TB
_SLAB = LP.R * LP.C * LP.TB
BOUNDS = {
    "P1a": (16 * 24 * 24 + 16 * 24 * 57, 2 * 16 * 24 * 24 * 57, 0.0064, 0.0161),
    "P1b": (16 * 56 * 56 + 16 * 56 * 78, 2 * 16 * 56 * 56 * 78, 0.0474, 0.1186),
    "P1c": (1536 * 56 + 1536 * 78, 2 * 1536 * 56 * 78, 0.0813, 0.2033),
    "P1d": (2 * _SLAB, 0, 0.0105, 0.0052),
    "P1e": (LP.R * LP.TB + _SLAB, 0, 0.0053, 0.0053),
    "P1f": (2 * _SLAB, 0, 0.0105, 0.0052),
    "P1g": (LP.R * LP.R * LP.TB + LP.R * _SLAB + _SLAB, 0, 0.1331, 0.1292),
}


@pytest.mark.parametrize("tag", sorted(BOUNDS))
def test_probe_bound_counts_instructions_and_tensor_core_passes(tag):
    """A product's bound is its three TF32 passes at 495 TFLOP/s or its
    adds (the offset, one per element of a; the accumulation, one per
    output) at the float32 pipe's issue rate, 132·128·1.98e9 a second,
    whichever is longer; the other bodies' their adds, multiplies and
    FMAs, one instruction each. The old bound, operations over 67 TFLOP/s,
    stays beside it."""
    p = {p.tag: p for p in LP.probes()}[tag]
    instructions, tf32_flops, new_us, old_us = BOUNDS[tag]
    assert (p.instructions, p.tf32_flops) == (instructions, tf32_flops)
    want = max(3 * tf32_flops / 495e12, instructions / (132 * 128 * 1.98e9))
    assert p.bound_s == pytest.approx(want, rel=1e-12)
    assert round(p.bound_s * 1e6, 4) == new_us
    assert round(p.old_bound_s * 1e6, 4) == old_us


SASS = """
\t\tFunction : _ZN12_GLOBAL__N_19mm_kernelILi7EEEvPKfS2_Pfiiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0010*/                   FADD R2, R3, R4 ;        /* 0x0 */
        /*0020*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;   /* 0x0 */
        /*0030*/               @P0 FFMA R5, R6, R7, R5 ;    /* 0x0 */
        /*0040*/                   SHFL.BFLY PT, R9, R8, 0x8, 0x1f ;   /* 0x0 */
        /*0050*/              @!P1 BRA 0x20 ;               /* 0x0 */
        /*0060*/                   FMUL R2, R2, R2 ;        /* 0x0 */
        /*0070*/                   EXIT ;                   /* 0x0 */
        /*0080*/                   BRA 0x80;                /* 0x0 */
"""


def test_sass_loops_counts_each_loop_by_opcode():
    """A branch backwards closes a loop from its target to itself; the
    kernel's closing branch to itself is no loop."""
    (row,) = SL.report(SASS)
    assert row["function"] == "mm_kernel<7>" and row["instructions"] == 9
    (loop,) = row["loops"]
    assert (loop["first"], loop["last"], loop["instructions"]) == (0x20, 0x50, 4)
    assert [loop[op] for op in SL.OPS] == [1, 1, 0, 0, 1]
