"""The port's batched FDDP (``aligator_tpu_torch.solvers.fddp``) against
``jax.jit(jax.vmap(fddp_solve))`` on the JAX package's own FDDP fixtures,
the port's filter strategy against the JAX ``filter_run``, and the port's
custom models and pendulum example against the JAX ones.

FDDP: B = 3 initial states per fixture (the 3×3 LQR of tests/test_fddp.py,
its RK2 pendulum swing-up, the SE(2) car of tests/test_se2_car.py), in
float64: xs, us, gains and the reported infeasibilities and cost to
1e-10·max(1, max|ref|), equal ``conv`` and ``num_iters``; the LQR in
float32 to 1e-5. ``_backward`` alone to 1e-12, and a Quu that is not SPD
gives NaN there and a rejected trial in the solve, as in JAX. Filter and
models: 1e-12 (the same arithmetic on both sides)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligator_tpu import costs as JC
from aligator_tpu import manifolds as JM
from aligator_tpu.dynamics import EulerIntegrator as JEuler
from aligator_tpu.dynamics import RK2Integrator as JRK2
from aligator_tpu.functions import custom as JF
from aligator_tpu.problem import ProblemDerivs as JDerivs
from aligator_tpu.problem import build_problem as jbuild
from aligator_tpu.problem import compute_derivatives as jderivs
from aligator_tpu.problem import evaluate as jevaluate
from aligator_tpu.solvers import FDDPSettings as JSettings
from aligator_tpu.solvers import fddp_solve as jfddp
from aligator_tpu.solvers import linesearch as JL
from aligator_tpu.solvers.fddp import _backward as jbackward
from examples.pendulum import create_pendulum_problem as jax_pendulum
from examples.se2_car import create_se2_problem as jax_se2

from aligator_tpu_torch import costs as TC
from aligator_tpu_torch.constraints import EqualityConstraint
from aligator_tpu_torch.convert import problem_from_numpy
from aligator_tpu_torch.dynamics import EulerIntegrator, RK2Integrator
from aligator_tpu_torch.examples.pendulum import create_pendulum_problem
from aligator_tpu_torch.functions import custom as TF
from aligator_tpu_torch.manifolds import VectorSpace
from aligator_tpu_torch.manifolds.lie import SE2
from aligator_tpu_torch.problem import ProblemDerivs, build_problem, compute_derivatives, evaluate
from aligator_tpu_torch.solvers import FDDPSettings, fddp_solve
from aligator_tpu_torch.solvers import linesearch as TL
from aligator_tpu_torch.solvers.fddp import _backward
from aligator_tpu_torch.utils.tree import tree_map

torch.set_num_threads(1)

B = 3
TOL = 1e-10
_shared = lambda obj: tree_map(lambda a: a.unsqueeze(0), obj)


# --- the JAX fixtures and their port counterparts ----------------------------

def _lqr_arrays():
    """tests/test_fddp.py:26-38."""
    A = np.eye(3)
    A[0, 1], A[1, 0] = -0.2, 0.2
    Bm = np.eye(3)
    Bm[2, :] = 0.4
    return dict(A=A, B=Bm, c=np.array([0.0, 0.0, 0.1]), Q=1e-2 * np.eye(3),
                R=1e-2 * np.eye(3), Qf=np.eye(3))


def _lqr(dtype):
    f = _lqr_arrays()
    a = lambda v: jnp.asarray(v, dtype)
    from aligator_tpu.dynamics import LinearDiscreteDynamics
    jp = jbuild(JM.VectorSpace(3), 3, 20, a([0.2, 0.3, -0.1]),
                LinearDiscreteDynamics(A=a(f["A"]), B=a(f["B"]), c=a(f["c"])),
                JC.QuadraticCost.create(a(f["Q"]), a(f["R"])),
                JC.QuadraticCost.create(a(f["Qf"]), a(f["R"])))
    x0s = np.array([0.2, 0.3, -0.1]) + 0.1 * np.random.default_rng(0).standard_normal((B, 3))
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    tp = problem_from_numpy(f["A"], f["B"], f["c"], f["Q"], f["R"], f["Qf"], x0s, 20,
                            device="cpu", dtype=tdt)
    return jp, tp, x0s


def _pendulum_xdot(space, x, u, p):
    m, l, b = p[0], p[1], p[2]
    th, om = x[0], x[1]
    sin = torch.sin if isinstance(x, torch.Tensor) else jnp.sin
    acc = (u[0] - b * om - m * 9.81 * l * sin(th)) / (m * l ** 2)
    stack = torch.stack if isinstance(x, torch.Tensor) else jnp.stack
    return stack([om, acc])


def _pendulum_rk2():
    """tests/test_fddp.py:55-82 (its PendulumODE as a custom ODE with
    params (m, l, b) = (1, 0.7, 0.1))."""
    params = np.array([1.0, 0.7, 0.1])
    jspace = JM.VectorSpace(2)
    x_tar = np.array([np.pi, 0.0])
    jp = jbuild(
        jspace, 1, 60, jnp.zeros(2),
        JRK2(ode=JF.CustomODE(fn=_pendulum_xdot, params=jnp.asarray(params)),
             dt=jnp.asarray(0.05)),
        JC.CostStack.create(
            (JC.QuadraticStateCost(jspace, jnp.asarray(x_tar), 1e-3 * jnp.eye(2)), 1.0),
            (JC.QuadraticControlCost(jnp.zeros(1), 1e-3 * jnp.eye(1)), 1.0)),
        JC.QuadraticStateCost(jspace, jnp.asarray(x_tar), 10.0 * jnp.eye(2)))
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))
    space = VectorSpace(2)
    x0s = 0.1 * np.random.default_rng(1).standard_normal((B, 2))
    tp = build_problem(
        space, 1, 60, t(x0s),
        _shared(RK2Integrator(ode=TF.CustomODE(fn=_pendulum_xdot, params=t(params)),
                              dt=t(0.05))),
        _shared(TC.CostStack.create(
            (TC.QuadraticStateCost(space, t(x_tar), 1e-3 * t(np.eye(2))), 1.0),
            (TC.QuadraticControlCost(t(np.zeros(1)), 1e-3 * t(np.eye(1))), 1.0))),
        _shared(TC.QuadraticStateCost(space, t(x_tar), 10.0 * t(np.eye(2)))),
        device="cpu")
    return jp, tp, x0s


def _car_xdot(space, x, u):
    v, w = u[0], u[1]
    return torch.stack([v, torch.zeros_like(v), w])


def _se2_car():
    """examples/se2_car.py at N = 40 (tests/test_se2_car.py:57), the body
    frame unicycle as a custom ODE."""
    jp = jax_se2(40)
    space = SE2()
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))
    w_x, dt = 0.01 * np.eye(3), 0.05
    target = np.array([0.0, 0.0, 1.0, 0.0])
    th = 0.15355 + 0.1 * np.arange(B)
    x0s = np.stack([0.7 + 0.05 * np.arange(B), np.full(B, -0.1), np.cos(th), np.sin(th)], 1)
    tp = build_problem(
        space, 2, 40, t(x0s),
        _shared(EulerIntegrator(ode=TF.CustomODE(fn=_car_xdot), dt=t(dt))),
        _shared(TC.CostStack.create(
            (TC.QuadraticStateCost(space, t(target), t(w_x * dt)), 1.0),
            (TC.QuadraticControlCost(t(np.zeros(2)), t(np.eye(2) * dt)), 1.0))),
        _shared(TC.QuadraticStateCost(space, t(target), t(10.0 * w_x))),
        device="cpu")
    return jp, tp, x0s


FIXTURES = {
    "lqr": (lambda: _lqr(jnp.float64), dict(tol=1e-8, max_iters=50)),
    "pendulum_rk2": (_pendulum_rk2, dict(tol=1e-5, max_iters=200)),
    "se2_car": (_se2_car, dict(tol=1e-8, max_iters=200)),
}


def _jax_vmap(jp, x0s, settings):
    fn = jax.jit(jax.vmap(lambda x0: jfddp(jp.replace_x0(x0), settings)))
    return fn(jnp.asarray(x0s, jp.x0.dtype))


def _compare(res_t, res_j, tol, names=("xs", "us", "kff", "K", "prim_infeas",
                                         "dual_infeas", "traj_cost")):
    for name in names:
        ref = np.asarray(getattr(res_j, name))
        err = np.abs(getattr(res_t, name).numpy() - ref)
        assert np.nanmax(err, initial=0.0) <= tol * max(1.0, np.nanmax(np.abs(ref))), name
        np.testing.assert_array_equal(np.isnan(err), np.isnan(ref), err_msg=name)
    for name in ("conv", "num_iters"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                      np.asarray(getattr(res_j, name)), err_msg=name)


# --- FDDP against jax.vmap(fddp_solve) ----------------------------------------

@pytest.mark.parametrize("name", list(FIXTURES))
def test_fddp_f64_matches_jax_vmap(name):
    build, kw = FIXTURES[name]
    jp, tp, x0s = build()
    res_j = _jax_vmap(jp, x0s, JSettings(**kw))
    res_t = fddp_solve(tp, FDDPSettings(**kw))
    assert np.asarray(res_j.conv).all()
    _compare(res_t, res_j, TOL)


def test_fddp_f32_lqr_matches_jax_vmap():
    jp, tp, x0s = _lqr(jnp.float32)
    kw = dict(tol=1e-5, max_iters=50)
    res_j = _jax_vmap(jp, x0s.astype(np.float32), JSettings(**kw))
    res_t = fddp_solve(tp, FDDPSettings(**kw))
    assert res_t.xs.dtype == torch.float32
    _compare(res_t, res_j, 1e-5, names=("xs", "us"))


def test_fddp_unbatched_is_a_batch_of_one():
    _, tp, x0s = _lqr(jnp.float64)
    s = FDDPSettings(tol=1e-8, max_iters=50)
    one = fddp_solve(tp.replace_x0(tp.x0[0]), s)
    many = fddp_solve(tp, s)
    assert one.xs.shape == (21, 3) and one.conv.dim() == 0
    # a batch of one goes through the same vmaps as a batch of three
    np.testing.assert_allclose(one.xs.numpy(), many.xs[0].numpy(), rtol=0, atol=1e-14)
    assert int(one.num_iters) == int(many.num_iters[0])


def _random_derivs(rng, N, ndx, nu, spd_u=True):
    def spd(*shape):
        w = rng.standard_normal(shape)
        return w @ np.swapaxes(w, -1, -2) / shape[-1] + np.eye(shape[-1])

    Luu = spd(B, N, nu, nu)
    if not spd_u:
        Luu[:, N // 2] = -1e3 * np.eye(nu)  # Quu not SPD at one knot
    return dict(
        Lx=rng.standard_normal((B, N + 1, ndx)), Lu=rng.standard_normal((B, N, nu)),
        Lxx=spd(B, N + 1, ndx, ndx), Lxu=0.1 * rng.standard_normal((B, N, ndx, nu)),
        Luu=Luu, A=np.eye(ndx) + 0.1 * rng.standard_normal((B, N, ndx, ndx)),
        B=rng.standard_normal((B, N, ndx, nu)), Cx=np.zeros((B, N, 0, ndx)),
        Cu=np.zeros((B, N, 0, nu)), Cx_term=np.zeros((B, 0, ndx)),
        G0=-np.tile(np.eye(ndx), (B, 1, 1)))


@pytest.mark.parametrize("spd_u", [True, False], ids=["spd", "not_spd"])
def test_backward_matches_jax(spd_u):
    """The Q-recursion alone on random derivatives at B = 3, N = 20; with a
    negative-definite Luu at one knot, Quu is not SPD there and the gains
    are NaN from that knot back to t = 0, in both packages."""
    jp, tp, _ = _lqr(jnp.float64)
    rng = np.random.default_rng(7)
    d = _random_derivs(rng, 20, 3, 3, spd_u)
    fs = rng.standard_normal((B, 21, 3))
    preg = np.array([1e-9, 1e-3, 1.0])
    outs, Vx, Vxx, ftVxx = _backward(tp, ProblemDerivs(**{k: torch.as_tensor(v)
                                                          for k, v in d.items()}),
                                     torch.as_tensor(fs), torch.as_tensor(preg))
    jfn = jax.jit(lambda dd, f, p: jbackward(jp, JDerivs(**dd), f, p))
    for b in range(B):
        j_outs, j_Vx, j_Vxx, j_ft = jfn({k: v[b] for k, v in d.items()}, fs[b], preg[b])
        for name, port, ref in [(f, getattr(outs, f)[b], getattr(j_outs, f))
                                for f in j_outs._fields] + [
                ("Vx", Vx[b], j_Vx), ("Vxx", Vxx[b], j_Vxx), ("ftVxx", ftVxx[b], j_ft)]:
            ref = np.asarray(ref)
            np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                                       atol=1e-12 * max(1.0, np.nanmax(np.abs(ref))),
                                       err_msg=name)
            np.testing.assert_array_equal(np.isnan(port.numpy()), np.isnan(ref), err_msg=name)
        if not spd_u:
            assert np.isnan(np.asarray(j_outs.kff)[:11]).all()
            assert np.isfinite(np.asarray(j_outs.kff)[11:]).all()


def test_non_spd_quu_rejects_the_trial_as_jax():
    """A negative control weight makes every Quu indefinite: the gains are
    NaN, every trial of the line search has a non-finite cost and is
    rejected, the regularization climbs until it fails. Both packages
    agree on the counts and the outcome element by element."""
    f = _lqr_arrays()
    f["R"] = -10.0 * np.eye(3)
    from aligator_tpu.dynamics import LinearDiscreteDynamics
    jp = jbuild(JM.VectorSpace(3), 3, 20, jnp.zeros(3),
                LinearDiscreteDynamics(A=jnp.asarray(f["A"]), B=jnp.asarray(f["B"]),
                                       c=jnp.asarray(f["c"])),
                JC.QuadraticCost.create(f["Q"], f["R"]), JC.QuadraticCost.create(f["Qf"], f["R"]))
    x0s = 0.1 * np.random.default_rng(3).standard_normal((B, 3))
    tp = problem_from_numpy(f["A"], f["B"], f["c"], f["Q"], f["R"], f["Qf"], x0s, 20,
                            device="cpu")
    kw = dict(tol=1e-8, max_iters=40)
    res_j = _jax_vmap(jp, x0s, JSettings(**kw))
    res_t = fddp_solve(tp, FDDPSettings(**kw))
    assert not np.asarray(res_j.conv).any()
    assert np.isnan(np.asarray(res_j.kff)).any()
    _compare(res_t, res_j, TOL)


# --- the filter strategy against JAX ------------------------------------------

def _jfilter(phis, hs, valid, count):
    return JL.FilterState(phis=jnp.asarray(phis), hs=jnp.asarray(hs),
                          valid=jnp.asarray(valid), count=jnp.asarray(count, jnp.int32))


def _check_filter(port: TL.FilterState, refs):
    for b, ref in enumerate(refs):
        for name in ("phis", "hs", "valid", "count"):
            np.testing.assert_array_equal(getattr(port, name)[b].numpy(),
                                          np.asarray(getattr(ref, name)), err_msg=name)


def test_filter_accept_and_insert_match_jax():
    """tests/test_linesearch.py:107-121 batched, plus the slot rules: the
    first free slot after an eviction, and the cursor count % capacity
    when the filter is full."""
    cap = 3
    seq = [  # per element: pairs inserted in turn
        [(1.0, 1.0), (0.5, 0.5), (2.0, 0.1)],  # eviction: slot 0 freed and reused
        [(1.0, 3.0), (2.0, 2.0), (3.0, 1.0), (2.5, 1.5), (0.5, 4.0)],  # full: cursor
        [(1.0, 1.0), (0.5, 2.0), (2.0, 0.5), (0.9, 0.9)],  # evicts the first, keeps two
    ]
    fs = TL.filter_init(cap, B, torch.float64)
    js = [JL.filter_init(cap, jnp.float64) for _ in range(B)]
    for k in range(max(map(len, seq))):
        pairs = [s[min(k, len(s) - 1)] for s in seq]
        phi = torch.tensor([p[0] for p in pairs], dtype=torch.float64)
        h = torch.tensor([p[1] for p in pairs], dtype=torch.float64)
        for beta in (0.0, 0.1):
            acc = TL._filter_acceptable(fs, phi, h, beta)
            for b in range(B):
                assert bool(acc[b]) == bool(JL._filter_acceptable(
                    js[b], jnp.asarray(pairs[b][0]), jnp.asarray(pairs[b][1]), beta))
        fs = TL._filter_insert(fs, phi, h)
        js = [JL._filter_insert(j, jnp.asarray(p[0]), jnp.asarray(p[1]))
              for j, p in zip(js, pairs)]
        _check_filter(fs, js)
    assert bool(fs.valid[1].all()) and int(fs.count[1]) == 5


def test_filter_run_matches_jax():
    """tests/test_linesearch.py:124-140 batched: element 0 backtracks once
    to an acceptable pair, element 1 accepts the full step, element 2
    never finds an acceptable pair and stops at alpha_min."""
    fs = TL.filter_init(8, B, torch.float64)
    fs = TL._filter_insert(fs, torch.ones(B, dtype=torch.float64),
                           torch.ones(B, dtype=torch.float64))
    jfs = JL._filter_insert(JL.filter_init(8, jnp.float64), jnp.asarray(1.0), jnp.asarray(1.0))
    offs = [0.0, -2.0, 5.0]

    def pair(a, off, lib):
        c = lambda v: lib.asarray(v, dtype=a.dtype)
        phi = lib.where(a > 0.75, c(2.0 + off), c(0.5 + max(off, 0.0)))
        h = lib.where(a > 0.75, c(2.0 + off), c(0.7 + max(off, 0.0)))
        return phi, h

    def port_eval(a):
        phi, h = zip(*(pair(a[b], offs[b], torch) for b in range(B)))
        return torch.stack(phi), torch.stack(h), {"a": a}

    opts = TL.LinesearchOptions(alpha_min=1e-3)
    alpha, phi, payload, fs2 = TL.filter_run(port_eval, fs, opts, beta=0.0)
    jopts = JL.LinesearchOptions(alpha_min=1e-3)
    refs = []
    for b in range(B):
        ja, jphi, jpay, jfs2 = JL.filter_run(
            lambda a, b=b: (*pair(a, offs[b], jnp), a), jfs, jopts, beta=0.0)
        np.testing.assert_allclose(float(alpha[b]), float(ja), rtol=0, atol=1e-12)
        np.testing.assert_allclose(float(phi[b]), float(jphi), rtol=0, atol=1e-12)
        np.testing.assert_allclose(float(payload["a"][b]), float(jpay), rtol=0, atol=1e-12)
        refs.append(jfs2)
    _check_filter(fs2, refs)
    assert float(alpha[0]) == 0.5 and float(alpha[1]) == 1.0 and float(alpha[2]) <= 1e-3


# --- custom models and the pendulum example ------------------------------------

def _custom_problems():
    """A problem made of CustomDynamics, CustomCost and a CustomResidual
    equality constraint, each with params, in both packages."""
    N, p_dyn, p_cost, p_res = 6, 0.7, 1.3, 0.4

    def dyn(space, x, u, p):
        lib = torch if isinstance(x, torch.Tensor) else jnp
        return x + 0.1 * p * lib.tanh(u) + 0.05 * lib.sin(x)

    def cost(space, x, u, p):
        lib = torch if isinstance(x, torch.Tensor) else jnp
        return p * (x * x).sum() + lib.cos(u).sum() + 0.1 * (x[0] * u[1]) ** 2

    def res(x, u, p):
        return x[:2] * p - u[:2] ** 3

    tt = lambda v: torch.tensor([v], dtype=torch.float64)
    tcstr = (_shared(TF.CustomResidual(fn=res, params=torch.tensor(p_res, dtype=torch.float64))),
             EqualityConstraint(), 2)
    tp = build_problem(
        VectorSpace(3), 3, N, torch.tensor([0.3, -0.2, 0.1], dtype=torch.float64),
        TF.CustomDynamics(fn=dyn, params=tt(p_dyn)), TF.CustomCost(fn=cost, params=tt(p_cost)),
        TF.CustomCost(fn=cost, params=tt(2 * p_cost)), constraints=(tcstr,), device="cpu")
    from aligator_tpu.constraints import EqualityConstraint as JEq
    jp = jbuild(
        JM.VectorSpace(3), 3, N, jnp.asarray([0.3, -0.2, 0.1]),
        JF.CustomDynamics(fn=dyn, params=jnp.asarray(p_dyn)),
        JF.CustomCost(fn=cost, params=jnp.asarray(p_cost)),
        JF.CustomCost(fn=cost, params=jnp.asarray(2 * p_cost)),
        constraints=((JF.CustomResidual(fn=res, params=jnp.asarray(p_res)), JEq(), 2),))
    return jp, tp


def _compare_passes(jp, tp, seed):
    rng = np.random.default_rng(seed)
    N, nx, nu = tp.nsteps, tp.space.nx, tp.nu
    xs = rng.standard_normal((N + 1, nx))
    us = rng.standard_normal((N, nu))
    d_t = evaluate(tp.replace_x0(tp.x0.expand(1, nx)), torch.as_tensor(xs)[None],
                   torch.as_tensor(us)[None])
    d_j = jevaluate(jp, jnp.asarray(xs), jnp.asarray(us))
    for name in d_j._fields:
        np.testing.assert_allclose(getattr(d_t, name)[0].numpy(),
                                   np.asarray(getattr(d_j, name)), rtol=0, atol=1e-12,
                                   err_msg=name)
    g_t = compute_derivatives(tp.replace_x0(tp.x0.expand(1, nx)), torch.as_tensor(xs)[None],
                              torch.as_tensor(us)[None])
    g_j = jderivs(jp, jnp.asarray(xs), jnp.asarray(us))
    for name in g_j._fields:
        np.testing.assert_allclose(getattr(g_t, name)[0].numpy(),
                                   np.asarray(getattr(g_j, name)), rtol=0, atol=1e-12,
                                   err_msg=name)


def test_custom_models_match_jax():
    _compare_passes(*_custom_problems(), seed=5)


def test_pendulum_example_problem_matches_jax():
    """The port's ``create_pendulum_problem`` against the JAX example's:
    the evaluation and derivative passes at a random point (N = 60)."""
    jp = jax_pendulum()
    tp = create_pendulum_problem(device="cpu")
    assert (tp.nsteps, tp.nu, tp.nc) == (jp.nsteps, jp.nu, jp.nc) == (60, 1, 1)
    _compare_passes(jp, tp, seed=9)


def test_pendulum_example_fddp_matches_jax():
    """The example's FDDP solve (its settings without the ``verbose`` the
    JAX example passes to FDDPSettings, which has no such field) against
    ``jax.jit(fddp_solve)``."""
    kw = dict(tol=1e-5, max_iters=200)
    with pytest.raises(TypeError, match="verbose"):
        JSettings(verbose=False, **kw)
    ref = jax.jit(lambda p: jfddp(p, JSettings(**kw)))(jax_pendulum())
    res = fddp_solve(create_pendulum_problem(device="cpu"), FDDPSettings(**kw))
    assert bool(ref.conv)
    _compare(res, ref, TOL)


def test_spd_factor_not_positive_definite_is_nan_as_jax():
    """A trial state can make the contact dynamics' matrix indefinite: the
    factor is NaN in both packages (JAX's Cholesky), so the trial's cost is
    non-finite and the line search rejects it, rather than an exception."""
    from aligator_tpu.linalg.spd import spd_factor as jspd
    from aligator_tpu_torch.linalg.spd import spd_factor

    Ms = np.stack([np.array([[4.0, 1.0], [1.0, 3.0]]), np.array([[1.0, 2.0], [2.0, 1.0]])])
    port = torch.func.vmap(lambda m: spd_factor(m).chol)(torch.as_tensor(Ms))
    ref = jax.vmap(lambda m: jspd(m).chol)(jnp.asarray(Ms))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=1e-15)
    assert np.isnan(port[1].numpy()[np.tril_indices(2)]).all() and np.isfinite(port[0].numpy()).all()
