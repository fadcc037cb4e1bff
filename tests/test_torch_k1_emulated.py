"""The backward Riccati kernel K1's CUDA source (``csrc/riccati_backward.cu``)
run on the CPU: compiled by g++ against an emulation of the CUDA built-ins
(``tests/cuda_emulation.py``) and held against its plain version
(``fused_riccati.backward_sweep_batched_ref``) at the widths of each
instantiation, the compiled bench and walk widths and small-width classes
from one warp to 256 threads, with the terminal knot's A, B, f NaN (the
kernel must never read them); the compiled widths' cluster variant at
2, 4 and 8 blocks per problem (the emulation runs a cluster's blocks at
once), against the plain version, against the kernel without a cluster
(1e-5 relative) and against itself at another batch (bitwise); and its C
entries ``riccati_backward_variant`` and ``riccati_backward_cluster`` held
to ``fused_riccati.backward_plan`` at every width. The card runs the same
checks in chip_smoke.py; here they catch an indexing or barrier fault
without one. Skipped where there is no g++.

Each output is gated at the larger of test_gar_pallas.py's float32
tolerances (gains 2e-4, Vxx and vx 1e-3) and 1e-4·max|·| (the bench
widths' gate), as chip_smoke.py gates the class boundaries.
"""

import ctypes

import numpy as np
import pytest
import torch

import cuda_emulation as E

from aligator_tpu_torch.convert import lqr_from_numpy
from aligator_tpu_torch.gar import fused_riccati as FR
from aligator_tpu_torch.gar.riccati import knots_of
from aligator_tpu_torch.utils import cuda_build

torch.set_num_threads(1)
_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if E.compiler() is None:
        pytest.skip("no g++ to compile the emulated kernel")
    so = E.build(cuda_build.CSRC / "riccati_backward.cu", tmp_path_factory.mktemp("k1emu"))
    lib = ctypes.CDLL(str(so))
    lib.riccati_backward_f32.argtypes = [_P] * 20 + [_I] * 7 + [_P]
    lib.riccati_backward_f32.restype = _I
    lib.riccati_backward_variant.argtypes = [_I] * 3
    lib.riccati_backward_variant.restype = _I
    lib.riccati_backward_cluster.argtypes = [_I] * 5
    lib.riccati_backward_cluster.restype = _I
    return lib


def _random_arrays(B, N, nx, nu, nc, seed):
    """Well-posed random constrained LQs as numpy arrays
    (chip_smoke.random_lq_arrays's draws from ``default_rng(seed)``), the
    terminal A, B, f NaN."""
    rng = np.random.default_rng(seed)
    L = N + 1

    def spd(n):
        w = rng.standard_normal((B, L, n, n))
        return w @ np.swapaxes(w, -1, -2) / n + np.eye(n)

    Q, R = spd(nx), spd(nu)
    S = 0.1 * rng.standard_normal((B, L, nx, nu))
    A = np.eye(nx) + 0.05 * rng.standard_normal((B, L, nx, nx)) / np.sqrt(nx)
    Bm = rng.standard_normal((B, L, nx, nu)) / np.sqrt(nx)
    C = 0.5 * rng.standard_normal((B, L, nc, nx))
    D = np.eye(nc, nu) + 0.1 * rng.standard_normal((B, L, nc, nu))
    d = 0.1 * rng.standard_normal((B, L, nc))
    C[:, 0] = D[:, 0] = d[:, 0] = C[:, N] = d[:, N] = 0.0
    R[:, N], S[:, N], D[:, N] = np.eye(nu), 0.0, 0.0
    r = rng.standard_normal((B, L, nu))
    r[:, N] = 0.0
    A[:, N] = Bm[:, N] = np.nan
    f = 0.1 * rng.standard_normal((B, L, nx))
    f[:, N] = np.nan
    z = lambda *s: np.zeros((B,) + s)
    return dict(Q=Q, S=S, R=R, q=rng.standard_normal((B, L, nx)), r=r, A=A, B=Bm, f=f, C=C,
                D=D, d=d, Gx=z(L, nx, 0), Gu=z(L, nu, 0), Gth=z(L, 0, 0), gamma=z(L, 0),
                G0=-np.tile(np.eye(nx), (B, 1, 1)), g0=rng.standard_normal((B, nx)))


def _random_lq(B, N, nx, nu, nc, seed, dtype=torch.float32):
    """The knots of ``_random_arrays``'s problems."""
    return knots_of(lqr_from_numpy(_random_arrays(B, N, nx, nu, nc, seed), device="cpu",
                                   dtype=dtype))


def _run(lib, knots, mu, refine_steps, cluster=0):
    Bsz, L = knots.Q.shape[:2]
    nx, nu, nc = knots.Q.shape[-1], knots.R.shape[-1], knots.C.shape[-2]
    dims = dict(nx=nx, nu=nu, nc=nc)
    outs = {n: torch.full((Bsz, L) + tuple(dims[s] for s in shape), float("nan"))
            for n, shape in FR._GAIN_SHAPES.items()}
    named = [getattr(knots, f).contiguous() for f in FR._KNOT_SHAPES]
    order = ("K", "Z", "kff", "zff", "yff", "Acl", "Vxx", "vx")
    err = lib.riccati_backward_f32(*(a.data_ptr() for a in named), mu.data_ptr(),
                                   *(outs[n].data_ptr() for n in order), Bsz, L, nx, nu, nc,
                                   refine_steps, cluster, None)
    assert err == 0
    return outs


def _check_against_plain(out, knots, mus, refine):
    gp, vp = FR.backward_sweep_batched_ref(knots, mus, refine)
    for name, atol in (("kff", 2e-4), ("zff", 2e-4), ("yff", 2e-4), ("K", 2e-4), ("Z", 2e-4),
                       ("Acl", 2e-4), ("Vxx", 1e-3), ("vx", 1e-3)):
        ref = getattr(gp, name) if hasattr(gp, name) else getattr(vp, name)
        if not ref.numel():
            continue
        assert bool(torch.isfinite(out[name]).all()), name
        gate = max(atol, 1e-4 * max(float(ref.abs().max()), 1.0))
        assert float((out[name] - ref).abs().max()) <= gate, name


@pytest.mark.parametrize("B, N, nx, nu, nc, mu, refine, plan", [
    (2, 5, 12, 4, 6, 1e-2, 1, "small<32, 8>"),      # the quadrotor
    (2, 5, 12, 4, 6, 1e-4, 1, "small<32, 8>"),
    (2, 5, 36, 12, 0, 1e-2, 1, "small<128, 16>"),   # the solo jump
    (2, 5, 36, 12, 0, 1e-6, 1, "small<128, 16>"),
    (2, 4, 7, 3, 2, 1e-6, 1, "small<32, 8>"),       # chip_smoke's small cases
    (2, 4, 7, 3, 0, 1e-2, 0, "small<32, 8>"),
    (2, 4, 7, 3, 2, 1e-2, 2, "small<32, 8>"),
    (2, 3, 9, 6, 4, 1e-2, 1, "small<32, 8>"),       # the centroidal shift
    (1, 3, 13, 9, 9, 1e-2, 1, "small<64, 16>"),
    (1, 3, 5, 17, 17, 1e-2, 1, "small<64, 32>"),
    (1, 3, 11, 1, 32, 1e-2, 1, "small<32, 32>"),
    (1, 2, 30, 1, 0, 1e-2, 1, "small<128, 8>"),
    (1, 2, 41, 1, 1, 1e-6, 1, "small<256, 8>"),
    (1, 2, 84, 32, 0, 1e-2, 1, "small<256, 32>"),   # the widest nx
    (1, 2, 56, 22, 22, 1e-2, 1, "bench"),
    (1, 2, 56, 22, 0, 1e-8, 1, "walk"),
])
def test_emulated_kernel_matches_its_plain_version(lib, B, N, nx, nu, nc, mu, refine, plan):
    assert str(FR.backward_plan(nx, nu, nc)) == plan
    knots = _random_lq(B, N, nx, nu, nc, seed=nx + 100 * nu + 10000 * nc)
    mus = torch.full((B,), mu)
    faults = lib.emu_faults()
    out = _run(lib, knots, mus, refine)
    assert lib.emu_faults() == faults, "a cp.async was misaligned or never waited for"
    _check_against_plain(out, knots, mus, refine)


@pytest.fixture(scope="module")
def one_block(lib):
    """The compiled widths without a cluster and with a cluster of 2 on the
    cluster cases' inputs (B = 2, N = 3): {widths: (knots, µ, outputs at
    C = 1, at C = 2)}."""
    runs = {}
    for nx, nu, nc, mu in ((56, 22, 22, 1e-2), (56, 22, 0, 1e-8)):
        knots = _random_lq(2, 3, nx, nu, nc, seed=7 + nc)
        mus = torch.full((2,), mu)
        runs[(nx, nu, nc)] = (knots, mus, _run(lib, knots, mus, 1, cluster=1),
                              _run(lib, knots, mus, 1, cluster=2))
    return runs


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("cluster", [2, 4, 8])
@pytest.mark.parametrize("widths", [(56, 22, 22), (56, 22, 0)], ids=["bench", "walk"])
def test_emulated_cluster_matches_plain_one_block_and_itself(lib, one_block, widths, cluster):
    """A cluster of 2, 4 or 8 blocks per problem at the compiled widths (B =
    2, N = 3, the terminal A, B, f NaN): the plain version's gates, within
    1e-5·max|·| of the kernel without a cluster, the same bits as a cluster
    of 2 (each entry is formed alike at every size), and the first problem
    the same bits when it runs alone (B = 1)."""
    knots, mus, base, two = one_block[widths]
    faults = lib.emu_faults()
    out = two if cluster == 2 else _run(lib, knots, mus, 1, cluster=cluster)
    first = _run(lib, type(knots)(*(a[:1].contiguous() for a in knots)), mus[:1], 1, cluster)
    assert lib.emu_faults() == faults, "a copy or a load from another block went astray"
    _check_against_plain(out, knots, mus, 1)
    for name, a in out.items():
        if a.numel():
            scale = max(float(base[name].abs().max()), 1.0)
            assert float((a - base[name]).abs().max()) <= 1e-5 * scale, name
        assert _same_bits(a, two[name]), name
        assert _same_bits(first[name], a[:1]), name


def test_emulated_cluster_launch_refusals(lib):
    """Cluster sizes the kernel does not take: 3, 16, and any above 1 at a
    small width; the plan's own size (0) at a small width is 1."""
    knots = _random_lq(1, 2, 12, 4, 6, seed=3)
    mus = torch.full((1,), 1e-2)
    for widths, cluster in (((56, 22, 0), 3), ((56, 22, 22), 16), ((12, 4, 6), 2)):
        k = knots if widths == (12, 4, 6) else _random_lq(1, 2, *widths, seed=3)
        with pytest.raises(AssertionError):
            _run(lib, k, mus, 1, cluster=cluster)
    _check_against_plain(_run(lib, knots, mus, 1, cluster=0), knots, mus, 1)


def test_c_entry_cluster_agrees_with_backward_plan(lib):
    """riccati_backward_cluster and backward_plan(...).cluster give the same
    blocks per problem at the compiled widths for every batch up to 1024 on
    cards of 132 (an H100's), 114 and 8 SMs, and 1 at every other width
    at B = 1, 16, 64 and 256."""
    for sms in (132, 114, 8):
        for widths in ((56, 22, 22), (56, 22, 0), (12, 4, 6)):
            for B in range(1, 1025):
                want = FR.backward_plan(*widths, batch=B, sms=sms).cluster
                assert lib.riccati_backward_cluster(*widths, B, sms) == want, (widths, B, sms)
    for nx in range(0, 85, 3):
        for nu in range(1, 33, 3):
            for nc in range(0, 33, 4):
                for B in (1, 16, 64, 256):
                    want = FR.backward_plan(nx, nu, nc, batch=B, sms=132).cluster
                    got = lib.riccati_backward_cluster(nx, nu, nc, B, 132)
                    assert got == want, (nx, nu, nc, B)


def test_c_entry_agrees_with_backward_plan(lib):
    """riccati_backward_variant and backward_plan name the same
    instantiation, or both refuse, at nx 0..85, nu and nc 0..33."""
    for nx in range(86):
        for nu in range(34):
            for nc in range(34):
                try:
                    want = FR.backward_plan(nx, nu, nc).code
                except ValueError:
                    want = -1
                got = lib.riccati_backward_variant(nx, nu, nc)
                assert (got < 0) == (want < 0) and (want < 0 or got == want), (nx, nu, nc)


def _finite(a):
    """Per problem: every entry of every knot finite."""
    a = np.asarray(a)
    return np.isfinite(a).all(axis=tuple(range(1, a.ndim)))


def _rel_err(a, ref):
    """Per problem: max|a − ref| / max|ref| over the gains K and kff."""
    def per_problem(x):
        return x.reshape(x.shape[0], -1).max(axis=1)

    return np.stack([per_problem(np.abs(np.asarray(a[n], np.float64) - ref[n]))
                     / per_problem(np.abs(ref[n])) for n in ("K", "kff")]).max(axis=0)


@pytest.mark.parametrize("nx, nu, seed", [(8, 32, 0), (20, 17, 1)])
def test_emulated_small_class_at_mu_1e6_is_reference_behaviour(lib, nx, nu, seed):
    """ROADMAP C16: the small classes at nu = nc = 17 (``small<64, 32>``
    at nx = 20) and 32 (``small<128, 32>`` at nx = 8), µ = 1e-6, B = 4,
    N = 6, float32. The JAX Pallas kernel (interpret mode) loses its gains
    there as the port's kernel does (the explicit inverse's cancellation,
    C5): both break down (NaN) on some problems where the plain recursion
    stays finite. Where the port's kernel breaks down and the JAX kernel
    does not, the JAX kernel's gains are no closer to the float64 solution
    than 10× the plain recursion's error; where both are finite, the
    port's gains are within 10× of the JAX kernel's error. A port fault
    would be the JAX kernel finite and close to the plain recursion where
    the port breaks down."""
    import jax
    import jax.numpy as jnp

    from aligator_tpu import gar as JG
    from aligator_tpu.gar import pallas_riccati as PR
    from aligator_tpu.gar import riccati as JR

    B, mu = 4, 1e-6
    arrays = _random_arrays(B, 6, nx, nu, nu, seed)
    probs = [JG.LQRProblem(**{f: jnp.asarray(a[b], jnp.float32) for f, a in arrays.items()})
             for b in range(B)]
    jknots = jax.tree.map(lambda *a: jnp.stack(a), *[JR.knots_of(p) for p in probs])
    gj, _ = PR.backward_sweep_batched(jknots, jnp.full((B,), mu, jnp.float32))
    knots = _random_lq(B, 6, nx, nu, nu, seed)
    mus = torch.full((B,), mu)
    port = _run(lib, knots, mus, 1)
    plain, _ = FR.backward_sweep_batched_ref(knots, mus)
    exact, _ = FR.backward_sweep_batched_ref(_random_lq(B, 6, nx, nu, nu, seed, torch.float64),
                                             mus.double())
    ref = {n: getattr(exact, n).numpy() for n in ("K", "kff")}
    jax_gains = {n: np.asarray(getattr(gj, n)) for n in ("K", "kff")}
    port_gains = {n: port[n].numpy() for n in ("K", "kff")}
    plain_gains = {n: getattr(plain, n).numpy() for n in ("K", "kff")}
    fin_j = _finite(jax_gains["K"]) & _finite(jax_gains["kff"])
    fin_p = _finite(port_gains["K"]) & _finite(port_gains["kff"])
    assert _finite(plain_gains["K"]).all() and _finite(plain_gains["kff"]).all()
    assert not fin_p.all()
    e_plain, e_jax, e_port = (_rel_err(g, ref) for g in (plain_gains, jax_gains, port_gains))
    for b in range(B):
        if fin_j[b] and not fin_p[b]:
            assert e_jax[b] >= 10 * e_plain[b], (b, e_jax[b], e_plain[b])
        if fin_j[b] and fin_p[b]:
            assert e_port[b] <= 10 * e_jax[b], (b, e_port[b], e_jax[b])
    if nu == 32:
        assert not fin_j.any()  # the JAX kernel breaks down on every problem
