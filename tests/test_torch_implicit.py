"""Implicit dynamics of the port (``dynamics/implicit.py``) against the JAX
package in float64 on the CPU: the fixed-count Newton solve, the implicit
midpoint rule against the analytic discretization of a linear ODE (as
tests/test_implicit.py checks the JAX one), and the derivatives of
``ImplicitToExplicit.forward``, whose implicit step must give the
Jacobians that JAX's ``custom_root`` gives by the implicit-function
theorem: alone under ``jacfwd`` and inside the problem's derivative pass
(``vmap`` over time of ``jacfwd``), to 1e-10·max(1, max|ref|)."""

import numpy as np
import torch
from torch.func import jacfwd

import jax
import jax.numpy as jnp

from aligator_tpu import costs as JC
from aligator_tpu import manifolds as JM
from aligator_tpu.dynamics import LinearODE as JLinearODE
from aligator_tpu.dynamics import implicit as JI
from aligator_tpu.functions import custom as JCustom
from aligator_tpu.problem import build_problem as jbuild
from aligator_tpu.problem import compute_derivatives as jderivs

from aligator_tpu_torch import costs as TC
from aligator_tpu_torch import manifolds as TM
from aligator_tpu_torch.dynamics import LinearODE as TLinearODE
from aligator_tpu_torch.dynamics import implicit as TI
from aligator_tpu_torch.functions import custom as TCustom
from aligator_tpu_torch.problem import build_problem as tbuild
from aligator_tpu_torch.problem import compute_derivatives as tderivs
from aligator_tpu_torch.utils.tree import shared

torch.set_num_threads(1)

JAC = 1e-10


def _close(port, ref, tol, what=""):
    ref = np.asarray(ref)
    port = port.detach().numpy()
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = float(np.abs(port - ref).max())
    scale = max(1.0, float(np.abs(ref).max()))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e}·{scale:.3g}"


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def test_newton_raphson_matches_jax():
    jfn = lambda z: jnp.stack([z[0] ** 2 - 2.0, z[0] * z[1] - 3.0])
    tfn = lambda z: torch.stack([z[0] ** 2 - 2.0, z[0] * z[1] - 3.0])
    for iters in (3, 20):
        zj = JI.newton_raphson(jfn, jnp.asarray([1.0, 1.0]), iters=iters)
        zt = TI.newton_raphson(tfn, _t([1.0, 1.0]), iters=iters)
        _close(zt, zj, 1e-14, f"iters={iters}")
    np.testing.assert_allclose(zt.numpy(), [np.sqrt(2.0), 3.0 / np.sqrt(2.0)], rtol=1e-12)


def _linear_ode(rng, nx=4, nu=2):
    A = rng.standard_normal((nx, nx)) * 0.5
    B = rng.standard_normal((nx, nu))
    return A, B


def test_midpoint_matches_analytic_linear_discretization_and_jax():
    """(I − h/2 A) x⁺ = (I + h/2 A) x + h B u for ẋ = A x + B u; and the
    residual and forward against the JAX classes."""
    rng = np.random.default_rng(0)
    nx, nu, h = 4, 2, 0.1
    A, B = _linear_ode(rng, nx, nu)
    tdyn = TI.MidpointIntegratorExplicit(TLinearODE(A=_t(A), B=_t(B), c=_t(np.zeros(nx))), h,
                                         newton_iters=10)
    jdyn = JI.MidpointIntegratorExplicit(JLinearODE(A=jnp.asarray(A), B=jnp.asarray(B),
                                                    c=jnp.zeros(nx)), h, newton_iters=10)
    x, u = rng.standard_normal(nx), rng.standard_normal(nu)
    ts, js = TM.VectorSpace(nx), JM.VectorSpace(nx)
    xn = tdyn.forward(ts, _t(x), _t(u))
    rhs = (np.eye(nx) + h / 2 * A) @ x + h * B @ u
    np.testing.assert_allclose(xn.numpy(), np.linalg.solve(np.eye(nx) - h / 2 * A, rhs),
                               atol=1e-12, rtol=0)
    _close(xn, jdyn.forward(js, jnp.asarray(x), jnp.asarray(u)), 1e-13, "forward")
    xr = rng.standard_normal(nx)
    _close(tdyn.impl.residual(ts, _t(x), _t(u), _t(xr)),
           jdyn.impl.residual(js, jnp.asarray(x), jnp.asarray(u), jnp.asarray(xr)), 1e-13,
           "residual")


def _pendulum_xdot(xp, stack):
    """A damped pendulum on SE(2) × R... kept simple: ẋ of (θ, ω, p) with
    a nonlinear coupling, written once for both packages."""
    return lambda space, x, u: stack([x[1], -9.81 * xp.sin(x[0]) - 0.2 * x[1] + u[0],
                                      xp.cos(x[0]) * x[1] + u[1]])


def _nonlinear_pair(dt=0.05, iters=8):
    jode = JCustom.CustomODE(fn=_pendulum_xdot(jnp, jnp.stack))
    tode = TCustom.CustomODE(fn=_pendulum_xdot(torch, torch.stack))
    return (JI.MidpointIntegratorExplicit(jode, dt, newton_iters=iters),
            TI.MidpointIntegratorExplicit(tode, dt, newton_iters=iters))


def test_implicit_to_explicit_jacobians_match_custom_root():
    """jacfwd of forward w.r.t. (x, u) against jax.jacfwd through
    ``jax.lax.custom_root``, at a point where the step is far from linear;
    and the same through the wrapper's defect Jacobians."""
    rng = np.random.default_rng(1)
    jdyn, tdyn = _nonlinear_pair()
    js, ts = JM.VectorSpace(3), TM.VectorSpace(3)
    x, u = np.array([2.5, -1.3, 0.4]), rng.standard_normal(2)
    _close(tdyn.forward(ts, _t(x), _t(u)), jdyn.forward(js, jnp.asarray(x), jnp.asarray(u)),
           1e-13, "forward")
    jx = jax.jacfwd(lambda xx: jdyn.forward(js, xx, jnp.asarray(u)))(jnp.asarray(x))
    ju = jax.jacfwd(lambda uu: jdyn.forward(js, jnp.asarray(x), uu))(jnp.asarray(u))
    _close(jacfwd(lambda xx: tdyn.forward(ts, xx, _t(u)))(_t(x)), jx, JAC, "d/dx")
    _close(jacfwd(lambda uu: tdyn.forward(ts, _t(x), uu))(_t(u)), ju, JAC, "d/du")
    xr = rng.standard_normal(3)
    for name, port, ref in zip("AB", tdyn.defect_jacobians(ts, _t(x), _t(u), _t(xr)),
                               jdyn.defect_jacobians(js, jnp.asarray(x), jnp.asarray(u),
                                                     jnp.asarray(xr))):
        _close(port, ref, JAC, name)


def test_implicit_dynamics_in_the_problem_derivative_pass():
    """A stacked problem with the implicit midpoint dynamics: the port's
    compute_derivatives (vmap over batch and time of jacfwd through the
    implicit step) against the JAX package's, on a batch of 2
    trajectories."""
    rng = np.random.default_rng(2)
    N, nx, nu, B = 6, 3, 2, 2
    jdyn, tdyn = _nonlinear_pair()
    W, Wu = np.diag([1.0, 0.5, 0.2]), 0.1 * np.eye(nu)
    tgt = np.array([np.pi, 0.0, 0.0])
    jspace, tspace = JM.VectorSpace(nx), TM.VectorSpace(nx)
    jcost = JC.CostStack.create((JC.QuadraticStateCost(jspace, jnp.asarray(tgt), W), 1.0),
                                (JC.QuadraticControlCost(jnp.zeros(nu), Wu), 1.0))
    tcost = TC.CostStack.create((TC.QuadraticStateCost(tspace, _t(tgt), _t(W)), 1.0),
                                (TC.QuadraticControlCost(_t(np.zeros(nu)), _t(Wu)), 1.0))
    jterm = JC.QuadraticStateCost(jspace, jnp.asarray(tgt), 10 * W)
    tterm = TC.QuadraticStateCost(tspace, _t(tgt), _t(10 * W))
    x0 = np.array([0.3, 0.1, 0.0])
    jp = jbuild(jspace, nu, N, jnp.asarray(x0), jdyn, jcost, jterm)
    tp = tbuild(tspace, nu, N, _t(x0)[None].expand(B, nx), shared(tdyn), shared(tcost),
                shared(tterm), device="cpu", dtype=torch.float64)
    xs = rng.standard_normal((B, N + 1, nx))
    us = rng.standard_normal((B, N, nu))
    td = tderivs(tp, _t(xs), _t(us))
    for b in range(B):
        jd = jderivs(jp, jnp.asarray(xs[b]), jnp.asarray(us[b]))
        for name in ("A", "B", "Lx", "Lxx"):
            _close(getattr(td, name)[b], getattr(jd, name), JAC, f"{name}[{b}]")
