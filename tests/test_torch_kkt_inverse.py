"""The backward kernel's KKT solve through the explicit inverse T, in plain
torch (``gar.fused_riccati.kkt_inverse_solve_ref``), against the JAX
reference kernel's ``_kkt_solve_T`` and against the port's Cholesky path
``linalg.schur.kkt_solve_refined``, in float32 on the CPU, at µ down to
1e-6 and at the bench widths nu = nc = 22. It checks the conditioning of
the formulation; the CUDA kernel itself is held against the serial
recursion on the card by chip_smoke.py. Tolerance: test_gar_pallas.py's
2e-4 (absolute) on the gains."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aligator_tpu.gar import pallas_riccati as PR

from aligator_tpu_torch.gar import fused_riccati as FR
from aligator_tpu_torch.linalg import schur

torch.set_num_threads(1)

BATCH = 4
MUS = [1e-2, 1e-4, 1e-6]
GAIN_TOL = 2e-4


def _system(nu, nc, m, seed=0):
    """R̂-like SPD blocks, constraint Jacobians D = I + noise (as the card
    checks make them) and right-hand sides, float32."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((BATCH, nu, nu))
    R = W @ np.swapaxes(W, -1, -2) / nu + np.eye(nu)
    D = np.eye(nc, nu) + 0.1 * rng.standard_normal((BATCH, nc, nu))
    b1 = rng.standard_normal((BATCH, nu, m))
    b2 = rng.standard_normal((BATCH, nc, m))
    return [a.astype(np.float32) for a in (R, D, b1, b2)]


def _port(R, D, mu, b1, b2, refine_steps=1):
    t = [torch.as_tensor(a) for a in (R, D, b1, b2)]
    mub = torch.full((BATCH,), mu, dtype=torch.float32)
    return FR.kkt_inverse_solve_ref(t[0], t[1], mub, t[2], t[3], refine_steps)


@pytest.mark.parametrize("mu", MUS)
@pytest.mark.parametrize("nu,nc,m", [(3, 1, 8), (3, 3, 8), (22, 22, 57)])
def test_matches_jax_kkt_solve_T(mu, nu, nc, m):
    """Same formulation as the Pallas kernel's solve, on the same inputs
    (its padded row layout: k in rows [0, nu), z in rows [nus, nus + nc))."""
    R, D, b1, b2 = _system(nu, nc, m)
    nus = max(nu, nc)
    rhs = np.zeros((BATCH, 2 * nus, m), np.float32)
    rhs[:, :nu], rhs[:, nus:nus + nc] = b1, b2
    sol = np.asarray(PR._kkt_solve_T(
        jnp.asarray(R), jnp.asarray(np.swapaxes(D, -1, -2)),
        jnp.full((BATCH,), mu, jnp.float32), jnp.asarray(rhs), 1, nus))
    k, z = _port(R, D, mu, b1, b2)
    np.testing.assert_allclose(k.numpy(), sol[:, :nu], atol=GAIN_TOL, rtol=0)
    np.testing.assert_allclose(z.numpy(), sol[:, nus:nus + nc], atol=GAIN_TOL, rtol=0)


@pytest.mark.parametrize("mu", MUS)
@pytest.mark.parametrize("nu,nc,m", [(3, 0, 8), (3, 3, 8), (22, 22, 57)])
def test_matches_cholesky_path(mu, nu, nc, m):
    """Against the two-factor Schur solve with one refinement step, both in
    float32; the explicit inverse loses no accuracy at these conditions."""
    R, D, b1, b2 = _system(nu, nc, m, seed=1)
    k, z = _port(R, D, mu, b1, b2)
    t = [torch.as_tensor(a) for a in (R, D, b1, b2)]
    k_ref, z_ref = schur.kkt_solve_refined(t[0], t[1], torch.full((BATCH,), mu), t[2], t[3],
                                           refine_steps=1)
    np.testing.assert_allclose(k.numpy(), k_ref.numpy(), atol=GAIN_TOL, rtol=0)
    np.testing.assert_allclose(z.numpy(), z_ref.numpy(), atol=GAIN_TOL, rtol=0)


def test_refinement_step_lowers_the_residual():
    """At µ = 1e-6 and the bench widths, one refinement step brings the
    float32 KKT residual down, as the kernel relies on."""
    R, D, b1, b2 = _system(22, 22, 57, seed=2)
    t = [torch.as_tensor(a).double() for a in (R, D, b1, b2)]

    def residual(refine_steps):
        k, z = _port(R, D, 1e-6, b1, b2, refine_steps)
        r1, r2 = schur.kkt_matvec(t[0], t[1], 1e-6, k.double(), z.double())
        return max(float((r1 - t[2]).abs().max()), float((r2 - t[3]).abs().max()))

    assert residual(1) < residual(0)


def test_indefinite_block_gives_nan():
    """A non-positive definite R̂ poisons the solution with NaN, the signal
    on which the solver raises its regularization."""
    R = -np.tile(np.eye(3, dtype=np.float32), (BATCH, 1, 1))
    _, D, b1, b2 = _system(3, 1, 8)
    k, z = _port(R, D, 1e-2, b1, b2)
    assert bool(torch.isnan(k).all()) and bool(torch.isnan(z).all())
