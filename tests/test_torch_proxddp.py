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

import re

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
    dict(sa_strategy="filter"),
    # the nonlinear rollout through each solver that forms gains ("pallas":
    # K1's plain version on the CPU, the Pallas kernel in interpret mode)
    dict(rollout_type="nonlinear"),
    dict(rollout_type="nonlinear", lq_solver="assoc"),
    dict(rollout_type="nonlinear", lq_solver="stagedense"),
    dict(rollout_type="nonlinear", lq_solver="pallas"),
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
    (dict(sa_strategy="filter", filter_beta=0.1, filter_capacity=2), "A26"),
    (dict(rollout_type="nonlinear", sa_strategy="armijo"), "A27"),
    (dict(hessian_approx="exact"), "A25"),
    (dict(record_history=True, record_iterates=True), "A30"),
])
def test_unported_settings_raise(kw, item):
    """No setting is left unported: those of A25, A26, A27 and A30, which
    raised until they were ported, run and match the vmapped JAX solve in
    float64 (1e-12, equal counters; the recorded history too). Legs over
    several processes (``lq_mesh``, A19b) are held against the JAX
    package's mesh solves in tests/test_torch_distributed.py."""
    f = _fixture(0)
    base = dict(tol=1e-8, mu_init=1e-2, max_iters=30, **kw)
    res_j = _jax_vmap_solve(f, _x0s(), JSettings(**base), jnp.float64)
    res_t = port_solve(_port_problem(f, _x0s(), torch.float64), ProxDDPSettings(**base))
    _compare(res_t, res_j, 1e-12)
    for name in ("history", "history_xs", "history_us", "history_lams"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(),
                                   np.asarray(getattr(res_j, name)), rtol=0, atol=1e-12,
                                   err_msg=name)


def test_record_history_and_iterates_match_jax_vmap():
    """History rows [alpha, inner_crit, prim, dual, merit, mu, preg] and the
    iterate trace per Newton step, (B, max_iters, ...), zero past each
    element's last step; the last recorded iterate is the solution."""
    f = _fixture(0)
    kw = dict(tol=1e-8, mu_init=1e-2, max_iters=30, record_history=True,
              record_iterates=True)
    res_j = _jax_vmap_solve(f, _x0s(), JSettings(**kw), jnp.float64)
    res_t = port_solve(_port_problem(f, _x0s(), torch.float64), ProxDDPSettings(**kw))
    _compare(res_t, res_j, 1e-12)
    assert tuple(res_t.history.shape) == (BATCH, 30, 7)
    assert tuple(res_t.history_xs.shape) == (BATCH, 30, N + 1, NX)
    for name in ("history", "history_xs", "history_us", "history_lams"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(),
                                   np.asarray(getattr(res_j, name)), rtol=0, atol=1e-12,
                                   err_msg=name)
    k = res_t.num_iters.numpy()
    b = int(np.argmin(k))
    np.testing.assert_array_equal(res_t.history_xs[b, k[b] - 1].numpy(), res_t.xs[b].numpy())
    assert float(res_t.history_xs[b, k[b]:].abs().max()) == 0.0


def test_callback_and_verbose_match_jax():
    """An unbatched solve: the callback sees the same sequence of (iter,
    prim, dual) and iterates as the JAX solve's, and the verbose table has
    the same rows. A batched solve with a callback is refused."""
    f = _fixture(0)
    seen = {"jax": [], "port": []}
    make = lambda key: (lambda it, xs, us, lams, prim, dual: seen[key].append(
        (int(it), float(prim), float(dual), np.array(xs))))
    kw = dict(tol=1e-8, mu_init=1e-2, max_iters=30, verbose=True)
    import io
    from contextlib import redirect_stdout

    out = {}
    for key in ("jax", "port"):
        buf = io.StringIO()
        with redirect_stdout(buf):
            if key == "jax":
                problem = _jax_problem(f, jnp.float64)
                s = JSettings(callback=make(key), **kw)
                res_j = jax.jit(lambda p: proxddp_solve(p, s))(problem)
                jax.effects_barrier()
            else:
                res_t = port_solve(_port_problem(f, f["x0"], torch.float64),
                                   ProxDDPSettings(callback=make(key), **kw))
        out[key] = [line.split() for line in buf.getvalue().splitlines()
                    if line.strip() and line.split()[0].isdigit()]
    assert bool(res_t.conv) == bool(res_j.conv) and int(res_t.num_iters) == int(res_j.num_iters)
    assert len(seen["port"]) == len(seen["jax"]) >= int(res_j.num_iters)
    for (it_t, p_t, d_t, x_t), (it_j, p_j, d_j, x_j) in zip(seen["port"], seen["jax"]):
        assert it_t == it_j
        np.testing.assert_allclose([p_t, d_t], [p_j, d_j], rtol=1e-9, atol=1e-14)
        np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-12)
    assert len(out["port"]) == len(out["jax"]) == int(res_j.num_iters)
    for row_t, row_j in zip(out["port"], out["jax"]):
        # iter, aliter exact; alpha, inner_crit, prim, dual, preg, merit, mu to
        # their printed digits; dphi0 and dM are differences near convergence
        assert (row_t[0], row_t[9]) == (row_j[0], row_j[9])
        for col in (1, 2, 3, 4, 5, 7, 10):
            np.testing.assert_allclose(float(row_t[col]), float(row_j[col]), rtol=2e-2)
    with pytest.raises(ValueError, match="unbatched"):
        port_solve(_port_problem(f, _x0s(), torch.float64),
                   ProxDDPSettings(callback=make("port"), **kw))


def _debug_problems(poison):
    """tests/test_debug_mode.py:24-37 in both packages."""
    rng = np.random.default_rng(0)
    ndx, nu, n = 4, 2, 8
    A = np.eye(ndx) * 0.9
    if poison:
        A[0, 0] = np.nan
    Bm = rng.standard_normal((ndx, nu)) / np.sqrt(ndx)
    x0 = 0.1 * rng.standard_normal(ndx)
    jp = build_problem(JM.VectorSpace(ndx), nu, n, jnp.asarray(x0),
                       LinearDiscreteDynamics(A=jnp.asarray(A), B=jnp.asarray(Bm),
                                              c=jnp.zeros(ndx)),
                       JC.QuadraticCost.create(0.1 * jnp.eye(ndx), 0.1 * jnp.eye(nu)),
                       JC.QuadraticCost.create(jnp.eye(ndx), 0.1 * jnp.eye(nu)))
    tp = problem_from_numpy(A, Bm, np.zeros(ndx), 0.1 * np.eye(ndx), 0.1 * np.eye(nu),
                            np.eye(ndx), x0, n, device="cpu")
    return jp, tp


def test_solve_checked_matches_jax():
    """The poisoned problem raises at the same site as the JAX
    ``solve_checked``; the plain solve only reports conv=False. On the clean
    problem the checked solve equals the plain one and the JAX solve."""
    from jax.experimental import checkify
    from aligator_tpu.solvers import proxddp_solve_checked as jax_checked
    from aligator_tpu_torch.solvers import proxddp_solve_checked

    jp, tp = _debug_problems(poison=True)
    s = dict(tol=1e-6, mu_init=1e-2, max_iters=5)
    with pytest.raises(checkify.JaxRuntimeError) as ej:
        jax_checked(jp, JSettings(**s))
    site = re.search(r"NaN/Inf detected at: ([^\n]*?\))", str(ej.value)).group(1)
    with pytest.raises(FloatingPointError, match=re.escape(f"NaN/Inf detected at: {site}")):
        proxddp_solve_checked(tp, ProxDDPSettings(**s))
    assert not bool(port_solve(tp, ProxDDPSettings(**s)).conv)

    jp, tp = _debug_problems(poison=False)
    s = dict(tol=1e-6, mu_init=1e-2, max_iters=20)
    res = proxddp_solve_checked(tp, ProxDDPSettings(**s))
    plain = port_solve(tp, ProxDDPSettings(**s))
    ref = jax_checked(jp, JSettings(**s))
    assert bool(res.conv) and int(res.num_iters) == int(ref.num_iters)
    np.testing.assert_array_equal(res.xs.numpy(), plain.xs.numpy())
    np.testing.assert_allclose(res.xs.numpy(), np.asarray(ref.xs), rtol=0, atol=1e-12)


def _exact_hessian_problems(N):
    """tests/test_exact_hessian.py:23-43 in both packages (the JAX one is
    that test's own builder, the port's its example pendulum without the
    bound, at that test's control weight)."""
    from test_exact_hessian import _pendulum_problem as jax_pendulum
    from aligator_tpu_torch.examples.pendulum import create_pendulum_problem

    return jax_pendulum(N), create_pendulum_problem(N, u_max=None, u_weight=1e-2,
                                                    device="cpu")


def test_compute_vhp_matches_jax():
    from aligator_tpu.problem import compute_vhp as jvhp
    from aligator_tpu_torch.problem import compute_vhp

    jp, tp = _exact_hessian_problems(6)
    rng = np.random.default_rng(3)
    xs, us, lams = (rng.standard_normal(s) for s in ((7, 2), (6, 1), (7, 2)))
    ref = jax.jit(lambda *a: jvhp(jp, *a))(xs, us, lams, np.zeros((6, 0)), np.zeros(0))
    out = compute_vhp(tp.replace_x0(tp.x0[None]), *(torch.as_tensor(a)[None]
                      for a in (xs, us, lams, np.zeros((6, 0)), np.zeros(0))))
    for name, a, b in zip(("Hxx", "Hxu", "Huu"), out, ref):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=0, atol=1e-12,
                                   err_msg=name)
    assert float(np.abs(np.asarray(ref[0])).max()) > 1e-2  # the sin term is seen


def test_exact_hessian_solve_matches_jax():
    """tests/test_exact_hessian.py:95-103: the swing-up with the exact
    Hessian and the nonlinear rollout, unbatched, against jax.jit."""
    jp, tp = _exact_hessian_problems(40)
    kw = dict(hessian_approx="exact", tol=1e-3, mu_init=1e-2, max_iters=80,
              rollout_type="nonlinear")
    ref = jax.jit(lambda p: proxddp_solve(p, JSettings(**kw)))(jp)
    res = port_solve(tp, ProxDDPSettings(**kw))
    assert bool(ref.conv)
    for name in ("conv", "num_iters", "al_iter"):
        assert int(getattr(res, name)) == int(getattr(ref, name)), name
    for name in ("xs", "us", "lams"):
        np.testing.assert_allclose(getattr(res, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
