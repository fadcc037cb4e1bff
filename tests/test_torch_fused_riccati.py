"""The port's fused Riccati path (``aligator_tpu_torch.gar.fused_riccati``)
in float32 against the JAX Pallas kernels run in interpret mode, as
tests/test_gar_pallas.py runs them, on a batch of 4 problems. Here on the
CPU the port takes the kernels' plain torch versions; the CUDA kernels
themselves are held against the same plain versions on the card by
chip_smoke.py. Tolerances are test_gar_pallas.py's: gains 2e-4, Vxx 1e-3,
x0 1e-4, xs 1e-3, KKT 5e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligator_tpu import gar as JG
from aligator_tpu.gar import pallas_riccati as PR
from aligator_tpu.gar import riccati as JR

from aligator_tpu_torch.convert import lqr_from_numpy
from aligator_tpu_torch.gar import fused_riccati as FR
from aligator_tpu_torch.gar.riccati import Knot, knots_of
from aligator_tpu_torch.gar.utils import lqr_kkt_error

torch.set_num_threads(1)

BATCH = 4


def _batch(nc=2, N=9, nx=7, nu=3):
    """B random f32 problems: the JAX stacked knots and the port's batched
    LQRProblem built from the same numpy arrays."""
    lqs = [JG.random_lqr_problem(np.random.default_rng(s), N=N, nx=nx, nu=nu, nc=nc,
                                 dtype=jnp.float32) for s in range(BATCH)]
    jk = jax.tree.map(lambda *a: jnp.stack(a), *[JR.knots_of(p) for p in lqs])
    arrays = {
        f: np.stack([np.asarray(getattr(p, f)) for p in lqs])
        for f in ("Q", "S", "R", "q", "r", "A", "B", "f", "C", "D", "d",
                  "Gx", "Gu", "Gth", "gamma", "G0", "g0")
    }
    return lqs, jk, lqr_from_numpy(arrays, device="cpu")


def _close(port, ref, tol, name=""):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=tol, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("mu", [1e-2, 1e-6])
def test_fused_backward_matches_pallas(mu):
    _, jk, tp = _batch()
    mub = np.full(BATCH, mu, np.float32)
    g_j, v_j = PR.backward_sweep_batched(jk, jnp.asarray(mub))
    g_t, v_t = FR.backward_sweep_batched(knots_of(tp), torch.as_tensor(mub))
    for name in ("kff", "zff", "yff", "K", "Z", "Acl"):
        _close(getattr(g_t, name), getattr(g_j, name), 2e-4, name)
    _close(v_t.Vxx, v_j.Vxx, 1e-3, "Vxx")
    _close(v_t.vx, v_j.vx, 1e-3, "vx")


def test_fused_forward_matches_pallas():
    _, jk, tp = _batch()
    mub = np.full(BATCH, 1e-3, np.float32)
    g_j, v_j = PR.backward_sweep_batched(jk, jnp.asarray(mub))
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((BATCH, 7)).astype(np.float32)
    l0 = rng.standard_normal((BATCH, 7)).astype(np.float32)
    out_j = PR.forward_sweep_batched(g_j, v_j, jnp.asarray(x0), jnp.asarray(l0))
    g_t, v_t = FR.backward_sweep_batched(knots_of(tp), torch.as_tensor(mub))
    out_t = FR.forward_sweep_batched(g_t, v_t, torch.as_tensor(x0), torch.as_tensor(l0))
    for name, a, b in zip(("xs", "us", "vs", "lbds"), out_t, out_j):
        _close(a, b, 1e-3, name)


@pytest.mark.parametrize("nc", [2, 0])
def test_fused_solve_matches_pallas(nc):
    """Problem-level solve (kernel sweeps + the torch initial-stage KKT)
    against the vmapped JAX solve, which the custom_vmap rule routes
    through one batched interpret-mode kernel per sweep."""
    lqs, _, tp = _batch(nc=nc)
    mu = 1e-4

    def one(p):
        xs, us, vs, lbds, fac = PR.solve(p, mu)
        return xs, us, vs, lbds, fac.x0

    jsolve = jax.jit(jax.vmap(one))
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *lqs)
    xs_j, us_j, vs_j, lb_j, x0_j = jsolve(stacked)
    xs, us, vs, lbds, fac = FR.solve(tp, mu)
    _close(fac.x0, x0_j, 1e-4, "x0")
    for name, a, b in zip(("xs", "us", "vs", "lbds"), (xs, us, vs, lbds),
                          (xs_j, us_j, vs_j, lb_j)):
        _close(a, b, 1e-3, name)
    assert float(lqr_kkt_error(tp, xs, us, vs, lbds, mu)["max"].max()) < 5e-4


def test_plain_version_matches_serial_riccati_f64():
    """The plain versions repeat the serial recursion's arithmetic: in
    float64 they agree with gar.riccati to rounding."""
    from aligator_tpu_torch.gar import riccati as TR

    _, _, tp = _batch()
    tp = tp.replace(**{f: getattr(tp, f).double() for f in tp.__dataclass_fields__
                       if getattr(tp, f) is not None})
    ref = TR.solve(tp, 1e-3)
    port = FR.solve(tp, 1e-3)
    for a, b in zip(port[:4], ref[:4]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12, rtol=0)


def test_launch_counters_stay_zero_on_cpu():
    FR.backward_sweep_batched.launches = 0
    FR.forward_sweep_batched.launches = 0
    _, _, tp = _batch()
    FR.solve(tp, 1e-3)
    assert FR.backward_sweep_batched.launches == 0
    assert FR.forward_sweep_batched.launches == 0


def test_theta_blocks_are_rejected():
    _, _, tp = _batch()
    k = knots_of(tp)
    k = k._replace(Gth=torch.zeros(k.Gth.shape[:2] + (1, 1)))
    with pytest.raises(NotImplementedError, match="nth > 0"):
        FR.backward_sweep_batched(Knot(*k), torch.full((BATCH,), 1e-3))


def test_entry_point_without_device_raises_on_a_cpu_only_host():
    """With no GPU, an entry point whose device is unset raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    lqs, _, _ = _batch()
    arrays = {f: np.asarray(getattr(lqs[0], f)) for f in ("Q", "S", "R", "q", "r",
              "A", "B", "f", "C", "D", "d", "Gx", "Gu", "Gth", "gamma", "G0", "g0")}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lqr_from_numpy(arrays)
    assert lqr_from_numpy(arrays, device="cpu").Q.device.type == "cpu"
