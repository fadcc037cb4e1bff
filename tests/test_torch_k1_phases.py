"""The K1 phase probe (``aligator_tpu_torch.probes.k1_phases``) on the CPU:
its instrumentation of the kernel source and its refusal to run without a
card. The instrumented kernel itself builds and runs only on the card."""

import torch

from aligator_tpu_torch.probes import k1_phases as K
from aligator_tpu_torch.utils import cuda_build


def test_every_barrier_of_the_time_loop_gets_a_stamp():
    src = (cuda_build.CSRC / "riccati_backward.cu").read_text()
    loop = src[src.index(K.LOOP):src.index("// Host side:")]
    barriers = loop.count("__syncthreads();")
    out, phases = K.instrument(src)
    assert phases == barriers + 1
    assert out.count("K1_STAMP(") == phases + 1  # the stamps and the macro
    # the probe adds one barrier before the loop and one after it
    assert "k1_prof_read" in out
    assert out.count("__syncthreads();") == src.count("__syncthreads();") + 2


def test_main_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        return
    assert K.main([]) == 1
