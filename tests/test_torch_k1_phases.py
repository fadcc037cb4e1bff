"""The K1 phase probe (``aligator_tpu_torch.probes.k1_phases``) on the CPU:
its instrumentation of the kernel source (the three kernels' time loops,
their ``__syncthreads`` and ``bar_sync`` barriers and the cluster
barrier's wait, an earlier source with one loop), its options and its
refusal to run without a card, and the same refusal of the cluster-barrier
probe. The instrumented kernels themselves build and run only on the
card."""

import re

import pytest
import torch

from aligator_tpu_torch.probes import k1_phases as K
from aligator_tpu_torch.utils import cuda_build

_SRC = (cuda_build.CSRC / "riccati_backward.cu").read_text()


def _loop_bodies(src):
    out = []
    for m in re.finditer(re.escape(K.LOOP), src):
        end = K._closing(src, m.start() + len(K.LOOP) - 1)
        out.append(src[m.start():end])
    return out


def test_every_barrier_of_the_time_loop_gets_a_stamp():
    bodies = _loop_bodies(_SRC)
    assert len(bodies) == 3  # the compiled widths' kernel, the small widths', the cluster variant
    barriers = [len(K.BARRIER.findall(b)) for b in bodies]
    out, loops = K.instrument(_SRC)
    assert [len(lines) for lines in loops] == [n + 1 for n in barriers]
    assert out.count("K1_STAMP(") == sum(barriers) + len(bodies) + 1  # the stamps, the macro
    assert "k1_prof_read" in out
    # the probe adds one barrier before each loop and one after it
    assert out.count("__syncthreads();") == _SRC.count("__syncthreads();") + 2 * len(bodies)
    assert out.count("bar_sync<NT>();") == _SRC.count("bar_sync<NT>();")
    # each loop writes its index and its phase count where it ends
    for index, lines in enumerate(loops):
        assert f"k1_prof[blockIdx.x * {K.MAX_PHASES} + {K.MAX_PHASES - 2}] = {index};" in out
        assert f"k1_prof[blockIdx.x * {K.MAX_PHASES} + {K.MAX_PHASES - 1}] = {len(lines)};" in out


def test_phase_lines_name_the_source_barriers():
    """Each phase but the last ends at a line of the original source that
    holds a barrier of that loop, in order; the last runs to the body's
    end."""
    src_lines = _SRC.splitlines()
    _, loops = K.instrument(_SRC)
    small = loops[1]
    assert small[-1] is None
    assert all(K.BARRIER.search(src_lines[ln - 1]) for ln in small[:-1])
    assert small[:-1] == sorted(small[:-1])
    assert all(K.BARRIER.search(src_lines[ln - 1]) for ln in loops[0][:-1])


def test_a_source_with_one_time_loop():
    """An earlier version with one kernel (as PR 12's source was) gets one
    instrumented loop."""
    src = ("#include <cuda_runtime.h>\n__global__ void k(int L) {\n  "
           + K.LOOP + "\n    __syncthreads();\n    if (L) { __syncthreads(); }\n  }\n}\n")
    out, loops = K.instrument(src)
    assert loops == [[4, 5, None]]
    assert out.count("K1_STAMP(") == 4
    assert out.index("k1_prof[blockIdx.x") > out.index("K1_STAMP(2)")


def test_a_source_without_a_time_loop_is_refused():
    with pytest.raises(ValueError, match="no time loop"):
        K.instrument("#include <cuda_runtime.h>\n__global__ void k() {}\n")


def test_random_knots_at_the_widths_asked_for():
    gen = torch.Generator().manual_seed(0)
    ks = K._knots(2, 4, 12, 4, 6, "cpu", gen)
    shapes = [(12, 12), (12, 4), (4, 4), (12,), (4,), (12, 12), (12, 4), (12,), (6, 12), (6, 4),
              (6,)]
    assert [tuple(a.shape) for a in ks] == [(2, 4) + s for s in shapes]
    R = ks[2]
    assert bool((torch.linalg.eigvalsh(R) > 0).all())  # R positive definite


def test_main_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        return
    assert K.main([]) == 1
    assert K.main(["--widths", "36", "12", "0", "--steps", "45", "--batch", "16", "256"]) == 1


def test_the_cluster_variants_barriers_get_stamps():
    """The cluster variant's loop (the third) stamps its block barriers and
    the waits of its cluster barriers, and `--cluster` takes sizes."""
    cluster_loop = _loop_bodies(_SRC)[2]
    waits = cluster_loop.count("cg::cluster_group::barrier_wait();")
    assert waits == 2  # V before the knot, rhs before [Vxx | vx]
    _, loops = K.instrument(_SRC)
    assert len(loops[2]) == len(K.BARRIER.findall(cluster_loop)) + 1
    assert len(K.BARRIER.findall(cluster_loop)) == cluster_loop.count("__syncthreads();") + waits
    if not torch.cuda.is_available():
        assert K.main(["--cluster", "1", "4", "--batch", "1"]) == 1


def test_cluster_barrier_probe_without_a_card_exits_non_zero():
    from aligator_tpu_torch.probes import cluster_barrier as CB

    assert len(CB.MODES) == 12 and "cudaLaunchAttributeClusterDimension" in CB.SOURCE
    if not torch.cuda.is_available():
        assert CB.main(["--clusters", "2"]) == 1


def test_widths_take_three_numbers():
    with pytest.raises(SystemExit):
        K.main(["--widths", "36", "12"])


def test_steps_take_one_value_or_one_per_widths():
    with pytest.raises(SystemExit):
        K.main(["--widths", "36", "12", "0", "--widths", "12", "4", "6", "--steps", "45", "60",
                "1"])


def test_min_threads_puts_a_floor_on_the_small_classes():
    out = K.with_min_threads(_SRC, 64)
    assert out.count("t >= tiles && t >= 64") == 1
    assert out.replace("t >= tiles && t >= 64", "t >= tiles") == _SRC
    with pytest.raises(ValueError, match="class choice"):
        K.with_min_threads("#include <cuda_runtime.h>\n", 64)


def test_ptxas_labels():
    assert K._label("_ZN12_GLOBAL__N_122riccati_backward_smallILi32ELi8EEEvNS_5KnotsE") == \
        "riccati_backward_small<32, 8>"
    assert K._label("_ZN3_GN23riccati_backward_kernelILin1ELin1ELin1EEEvNS_5KnotsE") == \
        "riccati_backward_kernel<-1, -1, -1>"
