"""The port's batched ProxDDP solve (``aligator_tpu_torch.solvers``) against
``jax.jit(jax.vmap(proxddp_solve))`` on a small box-constrained LQR
(nx = nu = 3, N = 20, B = 4), and against the independent C++ box-QP
oracle of tests/test_cross_validation.py.

The port reproduces the batched control flow of the vmapped JAX solver
(loops run until every element is done, finished elements frozen by a
select), so in float64 every element matches to rounding: xs/us/lams at
1e-7 with equal ``conv`` and iteration counts. With the fused path in
float32 the two sides round differently (plain torch versions here, the
Pallas kernels in interpret mode there): 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligator_tpu import constraints as JS
from aligator_tpu import costs as JC
from aligator_tpu import manifolds as JM
from aligator_tpu.dynamics import LinearDiscreteDynamics
from aligator_tpu.functions import ControlErrorResidual
from aligator_tpu.problem import build_problem
from aligator_tpu.solvers import ProxDDPSettings as JSettings
from aligator_tpu.solvers import proxddp_solve

from aligator_tpu_torch.convert import problem_from_numpy
from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve as port_solve

torch.set_num_threads(1)

NX = NU = 3
N = 20
BATCH = 4


def _fixture(seed, bound=0.18):
    """tests/test_cross_validation.py:24-35."""
    rng = np.random.default_rng(seed)
    A = np.eye(NX) * 1.02
    B = rng.standard_normal((NX, NU))
    c = 0.01 * rng.standard_normal(NX)
    x0 = rng.standard_normal(NX)
    return dict(A=A, B=B, c=c, Q=0.1 * np.eye(NX), R=0.01 * np.eye(NU),
                Qf=np.eye(NX), x0=x0, lower=np.full(NU, -bound),
                upper=np.full(NU, bound))


def _jax_problem(f, dtype):
    a = lambda v: jnp.asarray(v, dtype)
    return build_problem(
        JM.VectorSpace(NX), NU, N, a(f["x0"]),
        LinearDiscreteDynamics(A=a(f["A"]), B=a(f["B"]), c=a(f["c"])),
        JC.QuadraticCost.create(a(f["Q"]), a(f["R"])),
        JC.QuadraticCost.create(a(f["Qf"]), a(f["R"])),
        constraints=((ControlErrorResidual(target=jnp.zeros(NU, dtype)),
                      JS.BoxConstraint(lower=tuple(f["lower"]),
                                       upper=tuple(f["upper"])), NU),),
    )


def _jax_vmap_solve(f, x0s, settings, dtype):
    problem = _jax_problem(f, dtype)
    fn = jax.jit(jax.vmap(lambda x0: proxddp_solve(problem.replace_x0(x0), settings)))
    return fn(jnp.asarray(x0s, dtype))


def _port_problem(f, x0s, dtype):
    return problem_from_numpy(f["A"], f["B"], f["c"], f["Q"], f["R"], f["Qf"], x0s,
                              N, f["lower"], f["upper"], device="cpu", dtype=dtype)


def _x0s(dtype=np.float64):
    return np.random.default_rng(42).standard_normal((BATCH, NX)).astype(dtype)


def _compare(res_t, res_j, tol, counts=True):
    for name in ("xs", "us", "lams", "vs"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(),
                                   np.asarray(getattr(res_j, name)), atol=tol, rtol=0,
                                   err_msg=name)
    if counts:
        for name in ("conv", "num_iters", "al_iter"):
            np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                          np.asarray(getattr(res_j, name)), err_msg=name)


@pytest.mark.parametrize("sa_strategy", ["nonmonotone", "armijo"])
def test_proxddp_f64_serial_matches_jax_vmap(sa_strategy):
    """nonmonotone (the default) backtracks by bisection; armijo takes the
    safeguarded cubic interpolation of linesearch.py."""
    f = _fixture(0)
    kw = dict(tol=1e-8, mu_init=1e-2, max_iters=30, sa_strategy=sa_strategy)
    res_j = _jax_vmap_solve(f, _x0s(), JSettings(**kw), jnp.float64)
    res_t = port_solve(_port_problem(f, _x0s(), torch.float64), ProxDDPSettings(**kw))
    # the batch mixes a converged element and ones that hit max_iters
    assert np.asarray(res_j.conv).any() and not np.asarray(res_j.conv).all()
    _compare(res_t, res_j, 1e-7)
    np.testing.assert_allclose(res_t.traj_cost.numpy(), np.asarray(res_j.traj_cost),
                               rtol=1e-9)


def test_proxddp_f32_pallas_matches_jax_vmap():
    f = _fixture(3)
    kw = dict(tol=1e-5, mu_init=1e-2, max_iters=15, lq_solver="pallas")
    x0s = _x0s(np.float32)
    res_j = _jax_vmap_solve(f, x0s, JSettings(**kw), jnp.float32)
    res_t = port_solve(_port_problem(f, x0s, torch.float32), ProxDDPSettings(**kw))
    _compare(res_t, res_j, 1e-4, counts=False)
    np.testing.assert_array_equal(res_t.conv.numpy(), np.asarray(res_j.conv))


def test_proxddp_matches_independent_boxqp_oracle():
    """The three oracle fixtures solved as ONE batch whose dynamics differ
    per element (a ``batched`` problem), each held to the exact optimum of
    the C++ active-set box-QP solver at 5e-7."""
    from baseline_cpu import boxqp_lqr_solve_cpp

    seeds = (0, 3, 11)
    fs = [_fixture(s) for s in seeds]
    st = lambda k: np.stack([f[k] for f in fs])
    problem = problem_from_numpy(st("A"), st("B"), st("c"), fs[0]["Q"], fs[0]["R"],
                                 fs[0]["Qf"], st("x0"), N, fs[0]["lower"],
                                 fs[0]["upper"], device="cpu")
    res = port_solve(problem, ProxDDPSettings(tol=1e-10, mu_init=1e-2, max_iters=60))
    assert bool(res.conv.all())
    for i, f in enumerate(fs):
        xs_ref, us_ref = boxqp_lqr_solve_cpp(f["A"], f["B"], f["c"], f["Q"], f["R"],
                                             f["Qf"], f["x0"], f["lower"], f["upper"], N)
        np.testing.assert_allclose(res.us[i].numpy(), us_ref, atol=5e-7)
        np.testing.assert_allclose(res.xs[i].numpy(), xs_ref, atol=5e-7)
        sat_ref = np.abs(np.abs(us_ref) - 0.18) < 1e-9
        sat = np.abs(np.abs(res.us[i].numpy()) - 0.18) < 1e-6
        assert (sat == sat_ref).all()


def test_unbatched_call_is_a_batch_of_one():
    f = _fixture(0)
    s = ProxDDPSettings(tol=1e-8, mu_init=1e-2, max_iters=10)
    one = port_solve(_port_problem(f, f["x0"], torch.float64), s)
    many = port_solve(_port_problem(f, f["x0"][None], torch.float64), s)
    assert one.xs.shape == (N + 1, NX) and one.conv.dim() == 0
    np.testing.assert_array_equal(one.xs.numpy(), many.xs[0].numpy())


def test_cost_scale_and_full_refinement_keep_the_optimum():
    """cost_scale rescales the internal problem and lq_refine_full adds
    float64-residual refinement rounds: the converged optimum is the same
    (in problem units), on both LQ paths."""
    f = _fixture(11)
    problem = _port_problem(f, f["x0"][None], torch.float64)
    base = port_solve(problem, ProxDDPSettings(tol=1e-10, mu_init=1e-2, max_iters=60))
    for lq_solver in ("serial", "pallas"):
        res = port_solve(problem, ProxDDPSettings(
            tol=1e-10, mu_init=1e-2, max_iters=60, cost_scale=0.5, lq_refine_full=1,
            lq_solver=lq_solver))
        assert bool(res.conv.all())
        np.testing.assert_allclose(res.xs.numpy(), base.xs.numpy(), atol=1e-7)
        np.testing.assert_allclose(res.lams.numpy(), base.lams.numpy(), atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(multiplier_update_mode="primal"),
    dict(multiplier_update_mode="primal_dual"),
    # armijo with a contraction range down to 0.1 backtracks through the
    # interpolation on fixture 0: the two rules' iterates differ by 0.26
    dict(sa_strategy="armijo", ls_interp="quadratic", ls_contraction_min=0.1),
    dict(sa_strategy="armijo", ls_interp="bisection", ls_contraction_min=0.1),
    dict(riccati_refine=0),
    dict(riccati_refine=2),
    dict(cost_scale=0.5, lq_refine_full=1),
    dict(mu_dyn_scale=1.0),
    dict(dual_tol=1e-4),
    # the LQ solvers: "serial" with lq_num_legs > 1 means "parallel"
    dict(lq_solver="parallel", lq_num_legs=2),
    dict(lq_solver="parallel", lq_num_legs=4),
    dict(lq_solver="serial", lq_num_legs=4),
    dict(lq_solver="stagedense"),
    dict(lq_solver="assoc"),
    dict(lq_solver="dense_oracle"),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_proxddp_f64_settings_match_jax_vmap(kw):
    """Settings beside the defaults, each against the vmapped JAX solve in
    float64: iterates to 1e-12, equal conv, num_iters and al_iter. Every LQ
    solver runs the JAX package's algorithm in the same order, so 1e-12
    holds for each of them too."""
    f = _fixture(0)
    base = dict(tol=1e-8, mu_init=1e-2, max_iters=30, **kw)
    res_j = _jax_vmap_solve(f, _x0s(), JSettings(**base), jnp.float64)
    res_t = port_solve(_port_problem(f, _x0s(), torch.float64), ProxDDPSettings(**base))
    _compare(res_t, res_j, 1e-12)


@pytest.mark.parametrize("kw, item", [
    (dict(sa_strategy="filter"), "A26"),
    (dict(rollout_type="nonlinear"), "A27"),
    (dict(hessian_approx="exact"), "A25"),
    (dict(record_history=True), "A30"),
    (dict(lq_mesh=object()), "A19b"),
])
def test_unported_settings_raise(kw, item):
    f = _fixture(0)
    with pytest.raises(NotImplementedError, match=item):
        port_solve(_port_problem(f, _x0s(), torch.float64), ProxDDPSettings(**kw))
