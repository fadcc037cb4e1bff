"""The host side of the forward sweep K2 (``fused_riccati.forward_variant``
and ``forward_sweep_batched``) on the CPU.

``forward_variant`` picks the kernel (``forward_plan``: the small kernel's
class, or the pair of chain and rows kernels at nx = 56) and the copy method
(``forward_copy``: 16-byte bulk copies, or cp.async of 8 or 4 bytes) from
the state width, the batch and the arrays' addresses; here it is held to
the alignment rules of ``csrc/riccati_forward.cu``. ``forward_sweep_batched``
takes its plain version for CPU tensors; it is held against the JAX
``forward_sweep_batched`` (the Pallas kernel in interpret mode, as
tests/test_torch_fused_riccati.py runs it) on random float32 gains, at
nc = 0, at the bench widths and at the quadrotor's and the solo jump's. Both sides compute the same products in
float32 in different orders; over N = 5 steps of a stable closed loop
(|x| < 10) they agree to 2e-5·max(1, max|·|), ~170 ulp of the largest
entry."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aligator_tpu.gar import pallas_riccati as PR
from aligator_tpu.gar import riccati as JR

from aligator_tpu_torch.gar import fused_riccati as FR

torch.set_num_threads(1)


def _offset_copy(t, k):
    """A contiguous copy of t that starts k floats into its storage."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype)
    out = buf[k:].view(t.shape)
    out.copy_(t)
    return out


def _rowwise(nx, nu, nc, k, B=2, L=3):
    """The addresses of K, Z, Acl, Vxx and yff, each array k floats past an
    aligned allocation, and of a fresh xs; Z is left out at nc = 0, where
    it is empty."""
    shapes = [(B, L, nu, nx), (B, L, nc, nx), (B, L, nx, nx), (B, L, nx, nx), (B, L, nx)]
    arrays = [_offset_copy(torch.zeros(s), k) for s in shapes]
    xs = torch.empty((B, L, nx))
    return [a.data_ptr() for a in arrays + [xs] if a.numel()]


@pytest.mark.parametrize("nc", [0, 22])
@pytest.mark.parametrize("nx, k, want", [
    (56, 0, ("pair", 4)), (56, 1, ("pair", 1)), (56, 2, ("pair", 2)), (56, 3, ("pair", 1)), (7, 0, ("small<16>", 1)), (7, 2, ("small<16>", 1)),
    (71, 0, ("small<112>", 1)), (71, 1, ("small<112>", 1)),
])
def test_forward_variant_alignment(nx, k, want, nc):
    """16-byte copies need nx % 4 == 0 and every row-wise array 16-byte
    aligned; 8-byte copies nx even and 8-byte alignment; else 4 bytes. The
    kernel follows nx and the batch alone (nu and nc only count rows)."""
    assert FR.forward_variant(nx, _rowwise(nx, 22, nc, k)) == want


@pytest.mark.parametrize("k, want", [(0, ("small<64>", 4)), (1, ("small<64>", 1)),
                                     (2, ("small<64>", 2))])
def test_forward_plan_reads_the_inputs(k, want):
    """forward_choice hands the gains' own addresses and batch to
    forward_variant."""
    a, _, _ = _gains(2, 3, 36, 12, 0, seed=0)
    t = {n: _offset_copy(torch.as_tensor(v), k) for n, v in a.items()}
    g, v = FR._pack(t["kff"], t["zff"], t["yff"], t["K"], t["Z"], t["Acl"], t["Vxx"], t["vx"])
    assert FR.forward_choice(g, v) == want


def test_forward_variant_widths():
    """Each nx takes the least class that holds it, nx = 56 the pair, at
    every batch."""
    assert FR.forward_variant(84, [0, 16, 32]) == ("small<112>", 4)
    assert FR.forward_variant(14, [0, 8]) == ("small<16>", 2)
    assert FR.forward_variant(56, [0, 8]) == ("pair", 2)
    assert FR.forward_variant(112, []) == ("small<112>", 4)
    want = {1: 16, 16: 16, 17: 32, 32: 32, 33: 64, 55: 64, 57: 64, 64: 64, 65: 112, 112: 112}
    for B in (1, 16, 256):
        assert FR.forward_plan(56, B) == FR.ForwardPlan("pair") and FR.ForwardPlan("pair").code == 1
        for nx, nxc in want.items():
            plan = FR.forward_plan(nx, B)
            assert (plan.kernel, plan.nxc, plan.code, str(plan)) == (
                "small", nxc, nxc, f"small<{nxc}>"), nx
    for nx in (0, 113):
        with pytest.raises(ValueError, match="1 <= nx <= 112"):
            FR.forward_variant(nx, [])


def _gains(B, N, nx, nu, nc, seed):
    """Random float32 forward inputs as numpy arrays: Acl = 0.9·I +
    0.05·randn/√nx (a stable closed loop), K, Z, Vxx randn/√nx, offsets
    and x0, lbd0 randn."""
    rng = np.random.default_rng(seed)
    L, s = N + 1, nx ** -0.5
    r = lambda *shape, scale=1.0: (scale * rng.standard_normal(shape)).astype(np.float32)
    a = dict(kff=r(B, L, nu), zff=r(B, L, nc), yff=r(B, L, nx), K=r(B, L, nu, nx, scale=s),
             Z=r(B, L, nc, nx, scale=s),
             Acl=(0.9 * np.eye(nx) + r(B, L, nx, nx, scale=0.05 * s)).astype(np.float32),
             Vxx=r(B, L, nx, nx, scale=s), vx=r(B, L, nx))
    return a, r(B, nx), r(B, nx)


@pytest.mark.parametrize("nx, nu, nc", [(7, 3, 0), (56, 22, 22), (56, 22, 0), (12, 4, 6),
                                        (36, 12, 0)])
def test_forward_sweep_matches_pallas(nx, nu, nc):
    B, N = 4, 5
    a, x0, l0 = _gains(B, N, nx, nu, nc, seed=nx + nc)
    z = lambda *s: np.zeros((B, N + 1) + s, np.float32)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    gj = JR.Gains(kff=j["kff"], zff=j["zff"], yff=j["yff"], K=j["K"], Z=j["Z"], Acl=j["Acl"],
                  Kth=jnp.asarray(z(nu, 0)), Zth=jnp.asarray(z(nc, 0)),
                  Yth=jnp.asarray(z(nx, 0)))
    vj = JR.CostToGo(Vxx=j["Vxx"], vx=j["vx"], Vxt=jnp.asarray(z(nx, 0)),
                     vt=jnp.asarray(z(0)), Vtt=jnp.asarray(z(0, 0)))
    out_j = PR.forward_sweep_batched(gj, vj, jnp.asarray(x0), jnp.asarray(l0))
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    gt, vt = FR._pack(t["kff"], t["zff"], t["yff"], t["K"], t["Z"], t["Acl"], t["Vxx"],
                      t["vx"])
    out_t = FR.forward_sweep_batched(gt, vt, torch.as_tensor(x0), torch.as_tensor(l0))
    for name, p, r in zip(("xs", "us", "vs", "lbds"), out_t, out_j):
        r = np.asarray(r)
        assert p.shape == r.shape, name
        tol = 2e-5 * max(1.0, float(np.abs(r).max(initial=0.0)))
        np.testing.assert_allclose(p.numpy(), r, atol=tol, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out_t[3][:, 0].numpy(), l0)
