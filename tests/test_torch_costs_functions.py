"""The rest of the modelling library (slice 5 of the port) against the JAX
package in float64 on the CPU: the constant, log-barrier and direct-sum
costs, the L1 penalty set, the linear, control-box, composition and slice
residuals, the finite-difference helpers and the miscellaneous dynamics.
Values, gradients and Hessians (or values and Jacobians) on inputs drawn
from a numpy seed agree to 1e-12·max(1, max|ref|): the same arithmetic on
both sides. The finite-difference helpers difference values (and the
Hessian differences the differenced gradients), so a rounding difference
of the values is divided by the step: their step is 1e-3, where that
stays under the same gate."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aligator_tpu import constraints as JS
from aligator_tpu import costs as JC
from aligator_tpu import functions as JF
from aligator_tpu import manifolds as JM
from aligator_tpu.dynamics import EulerIntegrator as JEuler
from aligator_tpu.dynamics import misc as JMisc
from aligator_tpu.functions import custom as JCustom
from aligator_tpu.costs import jsl_block_diag as j_block_diag

from aligator_tpu_torch import constraints as TS
from aligator_tpu_torch import costs as TC
from aligator_tpu_torch import functions as TF
from aligator_tpu_torch import manifolds as TM
from aligator_tpu_torch.dynamics import EulerIntegrator as TEuler
from aligator_tpu_torch.dynamics import misc as TMisc
from aligator_tpu_torch.functions import custom as TCustom

torch.set_num_threads(1)

TOL = 1e-12


def _close(port, ref, tol=TOL, what=""):
    ref = np.asarray(ref)
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} > {tol:.0e}·{scale:.3g}"


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _j(a):
    return jnp.asarray(np.asarray(a, dtype=np.float64))


def _point(rng, space_pair, nu):
    """(x numpy, u numpy): a random point of the (JAX) space and control."""
    js, _ = space_pair
    x = np.asarray(js.integrate(js.neutral(), jnp.asarray(rng.standard_normal(js.ndx))))
    return x, rng.standard_normal(nu)


def _check_cost(jc, tc, spaces, x, u, what):
    js, ts = spaces
    _close(tc.value(ts, _t(x), _t(u)), jc.value(js, _j(x), _j(u)), what=f"{what} value")
    for name, port, ref in zip(("Lx", "Lu"), tc.gradients(ts, _t(x), _t(u)),
                               jc.gradients(js, _j(x), _j(u))):
        _close(port, ref, what=f"{what} {name}")
    for name, port, ref in zip(("Lxx", "Lxu", "Luu"), tc.hessians(ts, _t(x), _t(u)),
                               jc.hessians(js, _j(x), _j(u))):
        _close(port, ref, what=f"{what} {name}")


def _check_function(jf, tf, spaces, x, u, what):
    js, ts = spaces
    _close(tf.value(_t(x), _t(u)), jf.value(_j(x), _j(u)), what=f"{what} value")
    _close(tf.jac_x(ts, _t(x), _t(u)), jf.jac_x(js, _j(x), _j(u)), what=f"{what} Jx")
    _close(tf.jac_u(ts, _t(x), _t(u)), jf.jac_u(js, _j(x), _j(u)), what=f"{what} Ju")
    r, J = tf.value_and_jac_x(ts, _t(x), _t(u))
    _close(r, jf.value(_j(x), _j(u)), what=f"{what} value_and_jac_x value")
    _close(J, jf.jac_x(js, _j(x), _j(u)), what=f"{what} value_and_jac_x Jx")


SE2 = (JM.SE2(), TM.SE2())
NU = 3


def _linear(rng, nr, ndx, nu, c_shift=0.0):
    A, B = rng.standard_normal((nr, ndx)), rng.standard_normal((nr, nu))
    c = rng.standard_normal(nr) + c_shift
    return (JF.LinearFunction(A=_j(A), B=_j(B), c=_j(c)),
            TF.LinearFunction(A=_t(A), B=_t(B), c=_t(c)))


def _nonlinear_fn(xp):
    """A residual R^4 × R^3 → R^3 through a user callable (x an SE(2)
    point), written once for both packages."""
    return lambda x, u: xp.sin(x[:3]) * u[0] + x[1:4] * u[1] ** 2 + xp.cos(u[2]) * x[0]


def _nonlinear_pair():
    return (JCustom.CustomResidual(fn=_nonlinear_fn(jnp)),
            TCustom.CustomResidual(fn=_nonlinear_fn(torch)))


def _costs(rng):
    """name → (JAX cost, port cost, spaces, x, u)."""
    out = {}
    x, u = _point(rng, SE2, NU)
    c = rng.standard_normal()
    out["constant"] = (JC.ConstantCost(_j(c)), TC.ConstantCost(_t(c)), SE2, x, u)
    # log-residual cost on a residual kept positive (c shifted by +20)
    jl, tl = _linear(rng, 4, 4, NU, c_shift=20.0)
    w = rng.uniform(0.5, 2.0, 4)
    out["log_residual"] = (JC.LogResidualCost(residual=jl, weights=_j(w)),
                           TC.LogResidualCost(residual=tl, weights=_t(w)), SE2, x, u)
    # relaxed barrier with the threshold inside the residual's range: both branches
    jl, tl = _linear(rng, 6, 4, NU)
    r = np.asarray(jl.value(_j(x), _j(u)))
    thr = float(np.median(np.abs(r)))
    out["relaxed_log_barrier"] = (
        JC.RelaxedLogBarrierCost(residual=jl, weights=_j(w[:1].repeat(6)), threshold=_j(thr)),
        TC.RelaxedLogBarrierCost(residual=tl, weights=_t(w[:1].repeat(6)), threshold=_t(thr)),
        SE2, x, u)
    # direct sum on SE(2) × R²: (state + control costs on the first factor
    # with nu1 = 2) ⊕ (a quadratic residual cost of a linear function)
    prod = (JM.CartesianProduct((JM.SE2(), JM.VectorSpace(2))),
            TM.CartesianProduct((TM.SE2(), TM.VectorSpace(2))))
    xs, us = _point(rng, prod, NU)
    tgt = np.asarray(JM.SE2().integrate(JM.SE2().neutral(), jnp.asarray([0.3, -0.2, 0.5])))
    W, Wu = np.diag(rng.uniform(1, 2, 3)), np.diag(rng.uniform(1, 2, 2))
    j1 = JC.CostStack.create((JC.QuadraticStateCost(JM.SE2(), _j(tgt), _j(W)), 1.0),
                             (JC.QuadraticControlCost(_j(np.zeros(2)), _j(Wu)), 0.5))
    t1 = TC.CostStack.create((TC.QuadraticStateCost(TM.SE2(), _t(tgt), _t(W)), 1.0),
                             (TC.QuadraticControlCost(_t(np.zeros(2)), _t(Wu)), 0.5))
    jl, tl = _linear(rng, 3, 2, 1)
    W2 = np.diag(rng.uniform(1, 2, 3))
    out["direct_sum"] = (
        JC.DirectSumCost(c1=j1, c2=JC.QuadraticResidualCost(residual=jl, W=_j(W2)), nu1=2),
        TC.DirectSumCost(c1=t1, c2=TC.QuadraticResidualCost(residual=tl, W=_t(W2)), nu1=2),
        prod, xs, us)
    return out


@pytest.mark.parametrize("name", ["constant", "log_residual", "relaxed_log_barrier",
                                  "direct_sum"])
def test_costs_match_jax(name):
    jc, tc, spaces, x, u = _costs(np.random.default_rng(0))[name]
    _check_cost(jc, tc, spaces, x, u, name)


def test_block_diag_matches_jax():
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((3, 2)), rng.standard_normal((2, 4))
    _close(TC.jsl_block_diag(_t(a), _t(b)), j_block_diag(_j(a), _j(b)))


def test_l1_penalty_matches_jax():
    z = np.random.default_rng(2).standard_normal((3, 5, 4))
    jset, tset = JS.L1Penalty(scale=0.7), TS.L1Penalty(scale=0.7)
    for mu in (0.3, 1.5):
        for method in ("projection", "normal_cone_projection", "active_set",
                       "moreau_envelope"):
            _close(getattr(tset, method)(_t(z), mu), getattr(jset, method)(_j(z), mu),
                   what=f"{method} mu={mu}")
        zp = np.asarray(jset.projection(_j(z), mu))
        _close(tset.evaluate(_t(zp)), jset.evaluate(_j(zp)), what="evaluate")


def _functions(rng):
    jl, tl = _linear(rng, 5, 3, NU)
    lo, hi = -rng.uniform(0.1, 1, NU), rng.uniform(0.1, 1, NU)
    jn, tn = _nonlinear_pair()
    A, b = rng.standard_normal((2, 3)), rng.standard_normal(2)
    tgt = np.asarray(JM.SE2().integrate(JM.SE2().neutral(), jnp.asarray([0.1, 0.4, -0.3])))
    js_err = JF.StateErrorResidual(target=_j(tgt), space=JM.SE2())
    ts_err = TF.StateErrorResidual(target=_t(tgt), space=TM.SE2())
    return {
        "linear": (jl, tl),
        "control_box": (JF.ControlBoxFunction(umin=_j(lo), umax=_j(hi)),
                        TF.ControlBoxFunction(umin=_t(lo), umax=_t(hi))),
        "composition_nonlinear": (JF.LinearFunctionComposition(inner=jn, A=_j(A), b=_j(b)),
                                  TF.LinearFunctionComposition(inner=tn, A=_t(A), b=_t(b))),
        "composition_state_error": (
            JF.LinearFunctionComposition(inner=js_err, A=_j(A), b=_j(b)),
            TF.LinearFunctionComposition(inner=ts_err, A=_t(A), b=_t(b))),
        "slice": (JF.FunctionSlice(inner=jn, rows=(2, 0)), TF.FunctionSlice(inner=tn, rows=(2, 0))),
        "slice_of_linear": (JF.FunctionSlice(inner=jl, rows=(1, 3, 4)),
                            TF.FunctionSlice(inner=tl, rows=(1, 3, 4))),
    }


@pytest.mark.parametrize("name", ["linear", "control_box", "composition_nonlinear",
                                  "composition_state_error", "slice", "slice_of_linear"])
def test_functions_match_jax(name):
    rng = np.random.default_rng(3)
    jf, tf = _functions(rng)[name]
    x, u = _point(rng, SE2, NU)
    spaces = SE2 if name not in ("linear", "slice_of_linear") else (JM.VectorSpace(3),
                                                                    TM.VectorSpace(3))
    if name in ("linear", "slice_of_linear"):
        x = rng.standard_normal(3)
    _check_function(jf, tf, spaces, x, u, name)


EPS = 1e-3


@pytest.mark.parametrize("space", ["se2", "vector5"])
def test_finite_difference_helper_matches_jax(space):
    """Both branches of ``_fd_jacobian``: ndx = 3 (a loop over the columns)
    and ndx = 5 (a vmap over them)."""
    rng = np.random.default_rng(4)
    if space == "se2":
        spaces, (jn, tn) = SE2, _nonlinear_pair()
        x, u = _point(rng, SE2, NU)
    else:
        spaces = (JM.VectorSpace(5), TM.VectorSpace(5))
        jn, tn = _linear(rng, 4, 5, NU)
        x, u = rng.standard_normal(5), rng.standard_normal(NU)
    jf = JF.FiniteDifferenceHelper(fn=jn, eps=_j(EPS))
    tf = TF.FiniteDifferenceHelper(fn=tn, eps=_t(EPS))
    _check_function(jf, tf, spaces, x, u, f"fd helper {space}")


def _car_xdot(xp, stack):
    return lambda space, x, u: stack([u[0] * xp.cos(u[1]), u[0] * xp.sin(u[1]) * 0.5, u[1]])


def test_dynamics_finite_difference_matches_jax():
    rng = np.random.default_rng(5)
    jd = JEuler(ode=JCustom.CustomODE(fn=_car_xdot(jnp, jnp.stack)), dt=_j(0.1))
    td = TEuler(ode=TCustom.CustomODE(fn=_car_xdot(torch, torch.stack)), dt=_t(0.1))
    jfd = JF.DynamicsFiniteDifferenceHelper(dyn=jd, eps=_j(EPS))
    tfd = TF.DynamicsFiniteDifferenceHelper(dyn=td, eps=_t(EPS))
    x, u = _point(rng, SE2, 2)
    xr, _ = _point(rng, SE2, 2)
    js, ts = SE2
    _close(tfd.forward(ts, _t(x), _t(u)), jfd.forward(js, _j(x), _j(u)), what="forward")
    for name, port, ref in zip("AB", tfd.defect_jacobians(ts, _t(x), _t(u), _t(xr)),
                               jfd.defect_jacobians(js, _j(x), _j(u), _j(xr))):
        _close(port, ref, what=name)


def test_cost_finite_difference_matches_jax():
    rng = np.random.default_rng(6)
    jc, tc, spaces, x, u = _costs(rng)["log_residual"]
    _check_cost(JF.CostFiniteDifference(cost=jc, eps=_j(EPS)),
                TF.CostFiniteDifference(cost=tc, eps=_t(EPS)), spaces, x, u, "cost fd")


def test_wheeled_inverted_pendulum_matches_jax():
    rng = np.random.default_rng(7)
    jo = JMisc.WheeledInvertedPendulumDynamics(gravity=_j(9.81), length=_j(0.7))
    to = TMisc.WheeledInvertedPendulumDynamics(gravity=_t(9.81), length=_t(0.7))
    spaces = (JM.VectorSpace(7), TM.VectorSpace(7))
    x, u = rng.standard_normal(7), rng.standard_normal(2)
    _close(to.xdot(spaces[1], _t(x), _t(u)), jo.xdot(spaces[0], _j(x), _j(u)), what="xdot")
    jd, td = JEuler(ode=jo, dt=_j(0.05)), TEuler(ode=to, dt=_t(0.05))
    xr = rng.standard_normal(7)
    for name, port, ref in zip("AB", td.defect_jacobians(spaces[1], _t(x), _t(u), _t(xr)),
                               jd.defect_jacobians(spaces[0], _j(x), _j(u), _j(xr))):
        _close(port, ref, what=name)


def test_direct_sum_dynamics_matches_jax():
    rng = np.random.default_rng(8)
    prod = (JM.CartesianProduct((JM.SE2(), JM.VectorSpace(7))),
            TM.CartesianProduct((TM.SE2(), TM.VectorSpace(7))))
    jcar = JEuler(ode=JCustom.CustomODE(fn=_car_xdot(jnp, jnp.stack)), dt=_j(0.1))
    tcar = TEuler(ode=TCustom.CustomODE(fn=_car_xdot(torch, torch.stack)), dt=_t(0.1))
    jwip = JEuler(ode=JMisc.WheeledInvertedPendulumDynamics(gravity=_j(9.81), length=_j(0.7)),
                  dt=_j(0.05))
    twip = TEuler(ode=TMisc.WheeledInvertedPendulumDynamics(gravity=_t(9.81), length=_t(0.7)),
                  dt=_t(0.05))
    jd = JMisc.DirectSumExplicitDynamics(f=jcar, g=jwip, nu1=2)
    td = TMisc.DirectSumExplicitDynamics(f=tcar, g=twip, nu1=2)
    x, u = _point(rng, prod, 4)
    xr, _ = _point(rng, prod, 4)
    _close(td.forward(prod[1], _t(x), _t(u)), jd.forward(prod[0], _j(x), _j(u)), what="fwd")
    for name, port, ref in zip("AB", td.defect_jacobians(prod[1], _t(x), _t(u), _t(xr)),
                               jd.defect_jacobians(prod[0], _j(x), _j(u), _j(xr))):
        _close(port, ref, what=name)


def test_functions_package_exports_the_jax_names_of_this_slice():
    """Every name of ``aligator_tpu.functions`` outside its contact and
    centroidal families (ROADMAP A32) is exported by the port's."""
    import aligator_tpu.functions.centroidal as jcen
    import aligator_tpu.functions.contact as jcon

    later = {n for m in (jcen, jcon) for n in dir(m)}
    want = {n for n in JF.__all__ if n not in later}
    assert want and not {n for n in want if not hasattr(TF, n)}
