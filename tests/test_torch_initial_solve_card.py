"""The initial KKT solve (``gar.riccati.initial_solve``) on the card: one
fused backward at the lqr56 widths (nx 56, nu 22, nc 22, B = 1024,
N = 100) under ``torch.profiler``, whose ``gar.initial_solve`` range must
hold no device allocation and no host wait, and whose x0, λ0 match the
solve through ``torch.cholesky_solve``. It imports no JAX, so on a machine
with a card it runs without the suite's conftest:

    python -m pytest tests/test_torch_initial_solve_card.py -q -m card --noconftest
"""

import pytest
import torch

from aligator_tpu_torch.gar import fused_riccati as FR
from aligator_tpu_torch.gar import riccati as TR
from aligator_tpu_torch.gar.lqr_problem import LQRProblem
from aligator_tpu_torch.linalg import schur as TS

# runtime calls that allocate outside the caching allocator or wait for the card
_FORBIDDEN = ("cudaMalloc", "cudaFree", "cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


@pytest.fixture
def card():
    """The first CUDA card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", 0)


def _lq56(dev, batch=1024, N=100, nx=56, nu=22, nc=22, seed=0) -> LQRProblem:
    """Well-posed random constrained LQ problems drawn on the card (the shape
    of ``chip_smoke.random_lq_arrays``), float32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    L = N + 1
    rn = lambda *s: torch.randn((batch, L) + s, generator=g, device=dev)
    eye = lambda n, m=None: torch.eye(n, n if m is None else m, device=dev)

    def spd(n):
        w = rn(n, n)
        return w @ w.mT / n + eye(n)

    Q, R = spd(nx), spd(nu)
    S = 0.1 * rn(nx, nu)
    A = eye(nx) + 0.05 * rn(nx, nx) / nx ** 0.5
    B = rn(nx, nu) / nx ** 0.5
    C, D, d = 0.5 * rn(nc, nx), eye(nc, nu) + 0.1 * rn(nc, nu), 0.1 * rn(nc)
    C[:, 0] = D[:, 0] = d[:, 0] = C[:, N] = d[:, N] = 0.0
    R[:, N], S[:, N], D[:, N] = eye(nu), 0.0, 0.0
    r = rn(nu)
    r[:, N] = 0.0
    z = lambda *s: torch.zeros((batch,) + s, device=dev)
    return LQRProblem(Q=Q, S=S, R=R, q=rn(nx), r=r, A=A, B=B, f=0.1 * rn(nx), C=C, D=D,
                      d=d, Gx=z(L, nx, 0), Gu=z(L, nu, 0), Gth=z(L, 0, 0), gamma=z(L, 0),
                      G0=-eye(nx).expand(batch, nx, nx).contiguous(),
                      g0=torch.randn((batch, nx), generator=g, device=dev))


def _blocking(name: str) -> bool:
    return name.startswith(_FORBIDDEN) or (name.startswith("cudaMemcpy")
                                           and "Async" not in name)


@pytest.mark.card
def test_initial_solve_neither_allocates_nor_waits(card, monkeypatch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lq = _lq56(card)
    mu = torch.full((lq.batch,), 1e-2, device=card)
    for _ in range(2):
        FR.backward(lq, mu)
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fac = FR.backward(lq, mu)
        torch.cuda.synchronize(card)
    host = [e for e in p.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]
    (rng,) = [e for e in host if e.name() == "gar.initial_solve"]
    inside = [e.name() for e in host
              if rng.start_ns() <= e.start_ns() <= rng.end_ns() and e.name().startswith("cuda")]
    assert "cudaLaunchKernel" in inside, "the trace holds no runtime calls"
    assert not [n for n in inside if _blocking(n)], sorted(set(inside))

    monkeypatch.setattr(TS, "_chol_solve", lambda L, b: torch.cholesky_solve(b, L))
    old = TR.initial_solve(lq, fac.vm, 0.0, 1, fac.gains)
    for name in ("x0", "lbd0"):
        new, ref = getattr(fac, name), getattr(old, name)
        assert float((new - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), name
