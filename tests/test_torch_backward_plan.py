"""Which instantiation of the backward Riccati kernel K1 serves which widths
(``fused_riccati.backward_plan``), on the CPU.

The plan is pure Python; the C entry ``riccati_backward_variant`` of
``csrc/riccati_backward.cu`` answers the same (``BackwardPlan.code``), and
chip_smoke.py holds the two together at every width on the card. Here the
plan is held to the repository's widths, to the class boundaries (the
chain at nu or nc = 8|9, 16|17, 32; the threads where nx steps from 4k to
4k + 1), to the refusals, to an independent count of a knot's tiles, and
to the classes that the kernel source instantiates; and its cluster size
(the blocks per problem at the compiled widths) to the batch and the SMs,
to its cap, and to the sizes the kernel source takes and launches.
"""

import re

import pytest
import torch

from aligator_tpu_torch.gar import fused_riccati as FR
from aligator_tpu_torch.utils import cuda_build

torch.set_num_threads(1)


@pytest.mark.parametrize("name, widths, want", [
    ("quadrotor", (12, 4, 6), "small<32, 8>"),
    ("solo jump", (36, 12, 0), "small<128, 16>"),
    ("talos walk", (56, 22, 0), "walk"),
    ("lqr56 bench", (56, 22, 22), "bench"),
    ("ur5", (12, 6, 0), "small<32, 8>"),
    ("humanoid squat", (56, 28, 0), "small<256, 32>"),
    ("centroidal shift", (9, 6, 4), "small<32, 8>"),
    ("lqr example", (4, 2, 0), "small<32, 8>"),
])
def test_plan_at_the_repository_widths(name, widths, want):
    plan = FR.backward_plan(*widths)
    assert str(plan) == want, name
    if plan.kernel == "small":
        assert plan.code == 100 * plan.threads + plan.chain
    else:
        assert (plan.threads, plan.chain) == (256, 22)
        assert plan.code == {"bench": 1, "walk": 2}[plan.kernel]


def test_centroidal_cone_rows_are_its_nc():
    """The centroidal shift's two friction cones give nc = 4 rows at
    ndx = 9, nu = 6: the widths of the case above."""
    from aligator_tpu_torch.examples.centroidal import create_centroidal_problem

    p = create_centroidal_problem(device="cpu")
    assert (p.ndx, p.nu, p.nc) == (9, 6, 4)


@pytest.mark.parametrize("n, chain", [(1, 8), (8, 8), (9, 16), (16, 16), (17, 32), (32, 32)])
@pytest.mark.parametrize("which", ["nu", "nc"])
def test_chain_class_boundaries(n, chain, which):
    nu, nc = (n, 0) if which == "nu" else (1, n)
    assert FR.backward_plan(12, nu, nc).chain == chain


def _tiles_by_enumeration(nx, nu, nc):
    """A knot's 4 × 4 tiles counted from the entries each pass writes, in
    the kernel's column layout [A | f | 0 | B] (B from column r4(nx + 1))."""
    cB = (nx + 1 + 3) // 4 * 4
    cols_m = list(range(nx + 1)) + list(range(cB, cB + nu))  # A, f, B
    w = {(r // 4, c // 4) for r in range(nx) for c in cols_m}
    q = {(a // 4, c // 4) for a in range(nx) for c in range(a + 1)}
    q |= {(a // 4, nx // 4) for a in range(nx)}
    s = {(a // 4, c // 4) for a in range(nx) for c in range(cB, cB + nu)}
    r = {(a // 4, c // 4) for a in range(cB, cB + nu) for c in [nx] + list(range(cB, cB + nu))}
    sol = {(i // 4, j // 4) for i in range(nu + nc) for j in range(nx + 1)}
    return dict(w=len(w), hats=len(q) + len(s) + len(r), q=len(q), solve=len(sol))


@pytest.mark.parametrize("nu, nc", [(1, 0), (4, 6), (12, 0), (22, 22), (32, 32), (9, 17)])
def test_tile_counts_match_an_enumeration(nu, nc):
    for nx in range(1, FR.BACKWARD_MAX_NX + 1):
        got = FR.backward_tiles(nx, nu, nc)
        want = _tiles_by_enumeration(nx, nu, nc)
        assert {k: got[k] for k in want} == want, nx


@pytest.mark.parametrize("nu, nc", [(1, 0), (4, 6), (12, 0), (16, 16), (32, 0), (32, 32)])
def test_thread_classes_as_nx_steps_from_4k_to_4k_plus_1(nu, nc):
    """At nx = 4k and 4k + 1 up to 84, the class holds the fewest threads
    of 32, 64, 128, 256 that give every tile of the largest pass its own
    thread (256 past that), never fewer than the Q̂ tiles it keeps in
    registers, and never shrinks as nx grows."""
    prev = 0
    for k in range(1, 22):
        for nx in (4 * k, 4 * k + 1):
            if nx > FR.BACKWARD_MAX_NX:
                continue
            plan = FR.backward_plan(nx, nu, nc)
            if plan.kernel != "small":
                continue
            t = FR.backward_tiles(nx, nu, nc)
            need = max(t["w"], t["hats"], t["solve"])
            smaller = [n for n in FR.BACKWARD_THREADS if n < plan.threads]
            assert plan.threads >= min(need, 256) and plan.threads >= t["q"]
            assert all(n < need for n in smaller)
            assert plan.threads >= prev
            prev = plan.threads


def test_the_quadrotor_is_one_warp_and_the_jump_four():
    assert FR.backward_plan(12, 4, 6).threads == 32
    assert FR.backward_plan(36, 12, 0).threads == 128
    # the jump's largest pass, Wᵀ over the rows of A, fits four warps
    assert FR.backward_tiles(36, 12, 0)["w"] == 117


@pytest.mark.parametrize("widths", [(12, 33, 0), (12, 4, 33), (85, 4, 0), (12, 0, 0),
                                    (-1, 4, 0), (12, 4, -1)])
def test_refusals(widths):
    with pytest.raises(ValueError):
        FR.backward_plan(*widths)


def test_widest_accepted_widths():
    assert str(FR.backward_plan(84, 32, 32)) == "small<256, 32>"
    assert str(FR.backward_plan(84, 1, 0)) == "small<256, 8>"
    assert FR.backward_tiles(84, 32, 32)["q"] <= 256  # one Q̂ tile per thread
    assert FR.backward_tiles(85, 1, 0)["q"] > 256


def test_kernel_source_instantiates_every_class():
    """The classes of the plan are those the kernel source declares and
    instantiates, each once."""
    src = (cuda_build.CSRC / "riccati_backward.cu").read_text()
    threads = re.search(r"kClassThreads\[\] = \{([^}]*)\}", src).group(1)
    chains = re.search(r"kClassChains\[\] = \{([^}]*)\}", src).group(1)
    assert tuple(int(v) for v in threads.split(",")) == FR.BACKWARD_THREADS
    assert tuple(int(v) for v in chains.split(",")) == FR.BACKWARD_CHAINS
    made = re.findall(r"small_kernel<(\d+), (\d+)>\(\)", src)
    assert sorted((int(t), int(c)) for t, c in made) == sorted(
        (t, c) for t in FR.BACKWARD_THREADS for c in FR.BACKWARD_CHAINS)
    assert re.search(r"nx == 56 && nu == 22 && nc == 22\) return 1", src)
    assert re.search(r"nx == 56 && nu == 22 && nc == 0\) return 2", src)


def test_plan_prints_as_the_variant_names():
    assert str(FR.BackwardPlan("small", 64, 16)) == "small<64, 16>"
    assert FR.BackwardPlan("small", 64, 16).code == 6416
    assert str(FR.BackwardPlan("walk", 256, 22)) == "walk"


# the sizes of 1, 2, 4, 8 with B·C <= 132 (one SM per block of an H100)
_FIT_132 = {1: (1, 2, 4, 8), 16: (1, 2, 4, 8), 33: (1, 2, 4), 64: (1, 2), 66: (1, 2), 67: (1,),
            128: (1,), 256: (1,)}


@pytest.mark.parametrize("B", sorted(_FIT_132))
@pytest.mark.parametrize("kernel, widths", [("bench", (56, 22, 22)), ("walk", (56, 22, 0))])
def test_cluster_by_batch_at_132_sms(kernel, widths, B):
    """The compiled widths take the largest of their sizes whose blocks each
    get an SM of 132: the MPC regime (B = 1) the most, the full card 1."""
    plan = FR.backward_plan(*widths, batch=B, sms=132)
    assert plan.kernel == kernel
    assert plan.cluster == max(set(_FIT_132[B]) & set(FR.BACKWARD_CLUSTER_SIZES[kernel]))
    assert plan.cluster == 1 or B * plan.cluster <= 132
    assert plan.code == {"bench": 1, "walk": 2}[kernel]  # the instantiation is the same


def test_the_plans_sizes():
    """One block per problem always, every size one the kernel launches; the
    MPC regime (B = 1) takes 8 blocks at both widths, the walk's 16
    scenarios 4 (8 do not fit), the lqr56 MPC batch (64) 2 at the bench's
    widths and 1 at the walk's (2 blocks were slower there on an H100,
    PERF.md §6)."""
    for kernel in ("bench", "walk"):
        sizes = FR.BACKWARD_CLUSTER_SIZES[kernel]
        assert 1 in sizes and set(sizes) <= set(FR.BACKWARD_CLUSTERS)
    for widths in ((56, 22, 22), (56, 22, 0)):
        assert FR.backward_plan(*widths, batch=1, held=_HELD_H100).cluster == 8
        assert FR.backward_plan(*widths, batch=16, held=_HELD_H100).cluster == 4
    assert FR.backward_plan(56, 22, 22, batch=64, held=_HELD_H100).cluster == 2
    assert FR.backward_plan(56, 22, 0, batch=64, held=_HELD_H100).cluster == 1


# clusters of 1, 2, 4, 8 blocks (116 KB or more of shared memory each) that
# an H100's 132 SMs hold at once, as cudaOccupancyMaxActiveClusters gives it
# (PERF.md §6): a cluster lives within one GPC
_HELD_H100 = {1: 132, 2: 66, 4: 30, 8: 15}


@pytest.mark.parametrize("B, fit", [(1, 8), (15, 8), (16, 4), (30, 4), (31, 2), (33, 2),
                                    (64, 2), (66, 2), (67, 1), (256, 1)])
def test_cluster_by_the_clusters_the_card_holds(B, fit):
    """Counted by the clusters the card holds at once: 16 problems do not fit
    16 clusters of 8 on an H100 (15), nor 31 to 33 problems clusters of 4
    (30), where B·C <= 132 would let them."""
    for kernel, widths in (("bench", (56, 22, 22)), ("walk", (56, 22, 0))):
        plan = FR.backward_plan(*widths, batch=B, held=_HELD_H100)
        sizes = FR.BACKWARD_CLUSTER_SIZES[kernel]
        assert plan.cluster == max(c for c in sizes if c <= fit)
        assert plan.cluster == 1 or B <= _HELD_H100[plan.cluster]


@pytest.mark.parametrize("B", [1, 16, 64, 256, 1024])
@pytest.mark.parametrize("widths", [(12, 4, 6), (36, 12, 0), (84, 32, 32), (56, 28, 0),
                                    (56, 22, 21)])
def test_small_width_classes_take_no_cluster(widths, B):
    assert FR.backward_plan(*widths, batch=B, sms=132).cluster == 1
    assert FR.backward_plan(*widths, batch=B, held=_HELD_H100).cluster == 1


def test_cluster_sizes_and_no_cluster_without_sms():
    """Only the widths' sizes at any batch or SM count; without an SM count
    (the plan's default) no cluster."""
    for kernel, widths in (("bench", (56, 22, 22)), ("walk", (56, 22, 0))):
        sizes = FR.BACKWARD_CLUSTER_SIZES[kernel]
        for sms in (1, 8, 114, 132, 1000, 10 ** 6):
            for B in (1, 2, 16, 64):
                c = FR.backward_plan(*widths, batch=B, sms=sms).cluster
                assert c in sizes
                assert c == 1 or B * c <= sms
        assert FR.backward_plan(*widths).cluster == 1
        assert FR.backward_plan(*widths, batch=1, sms=10 ** 6).cluster == max(sizes)


def test_kernel_source_takes_and_launches_the_plans_clusters():
    """The sizes of the plan are those the kernel source declares;
    the compiled widths launch their cluster variant with the cluster
    attribute through cudaLaunchKernelEx, both widths instantiated."""
    src = (cuda_build.CSRC / "riccati_backward.cu").read_text()
    sizes = re.search(r"kClusters\[\] = \{([^}]*)\}", src).group(1)
    assert tuple(int(v) for v in sizes.split(",")) == FR.BACKWARD_CLUSTERS
    taken = re.search(r"kClusterTaken\[2\]\[4\] = \{\{([^}]*)\}, \{([^}]*)\}\}", src)
    for kernel, row in zip(("bench", "walk"), taken.groups()):
        flags = [v.strip() == "true" for v in row.split(",")]
        assert tuple(c for c, f in zip(FR.BACKWARD_CLUSTERS, flags) if f) == \
            FR.BACKWARD_CLUSTER_SIZES[kernel]
    assert "cudaLaunchAttributeClusterDimension" in src
    assert re.search(r"attr\[0\]\.val\.clusterDim\.x = cs;", src)
    assert re.search(r"cudaLaunchKernelEx\(&cfg, riccati_backward_cluster<NX, NU, NC>", src)
    assert "cudaOccupancyMaxActiveClusters" in src  # a launch counts the clusters held
    for widths in ("56, 22, 22", "56, 22, 0"):
        assert f"riccati_backward_cluster<{widths}>" in src
        assert f"riccati_backward_kernel<{widths}>" in src


def test_cluster_argument_is_checked():
    """The wrapper refuses a cluster size the kernel never takes, on any
    device; on the CPU it runs the plain version whatever the size."""
    import numpy as np

    import chip_smoke
    from aligator_tpu_torch.convert import lqr_from_numpy
    from aligator_tpu_torch.gar.riccati import knots_of

    arrays = chip_smoke.random_lq_arrays(np.random.default_rng(0), 1, 2, 3, 2, 1)
    arrays["A"][:, -1] = arrays["B"][:, -1] = arrays["f"][:, -1] = 0.0
    knots = knots_of(lqr_from_numpy(arrays, device="cpu"))
    mu = torch.full((1,), 1e-2, dtype=torch.float64)
    for bad in (3, 16, -1):
        with pytest.raises(ValueError, match="cluster"):
            FR.backward_sweep_batched(knots, mu, cluster=bad)
    g0, _ = FR.backward_sweep_batched(knots, mu)
    g2, _ = FR.backward_sweep_batched(knots, mu, cluster=2)
    assert torch.equal(g0.K, g2.K)
