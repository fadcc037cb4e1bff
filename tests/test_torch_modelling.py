"""The port's modelling layer (manifolds, residuals, constraint sets,
costs, dynamics, the problem's evaluation and derivative passes) against
the JAX package in float64, and its autodiff defaults (torch.func
jacfwd/grad/hessian) against the closed forms the main-path classes
override them with. Tolerance 1e-12: the same arithmetic on both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligator_tpu import constraints as JS
from aligator_tpu import costs as JC
from aligator_tpu import manifolds as JM
from aligator_tpu.dynamics import LinearDiscreteDynamics as JLin
from aligator_tpu.functions import ControlErrorResidual as JCtrl
from aligator_tpu.problem import build_problem as jbuild
from aligator_tpu.problem import compute_derivatives as jderivs
from aligator_tpu.problem import evaluate as jevaluate
from aligator_tpu.problem import rollout as jrollout

from aligator_tpu_torch import constraints as TS
from aligator_tpu_torch.convert import problem_from_numpy
from aligator_tpu_torch.costs import Cost, QuadraticCost
from aligator_tpu_torch.dynamics import ExplicitDynamics, LinearDiscreteDynamics
from aligator_tpu_torch.functions import (
    ControlErrorResidual,
    StageFunction,
    StateErrorResidual,
)
from aligator_tpu_torch.manifolds import Manifold, VectorSpace
from aligator_tpu_torch.problem import compute_derivatives, evaluate, rollout

torch.set_num_threads(1)

TOL = 1e-12
NX, NU, N, B = 5, 3, 6, 3


def _close(port, ref, tol=TOL, name=""):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=tol, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("name", ["box", "orthant", "equality", "product"])
def test_constraint_sets_match_jax(name):
    lo, hi = (-0.5, -0.1, 0.0, -1.0), (0.5, 0.2, 0.3, 1.0)
    sets = {
        "box": (TS.BoxConstraint(lower=lo, upper=hi), JS.BoxConstraint(lower=lo, upper=hi)),
        "orthant": (TS.NegativeOrthant(), JS.NegativeOrthant()),
        "equality": (TS.EqualityConstraint(), JS.EqualityConstraint()),
        "product": (
            TS.ConstraintSetProduct(sets=(TS.BoxConstraint(lower=lo[:2], upper=hi[:2]),
                                          TS.NegativeOrthant()), dims=(2, 2)),
            JS.ConstraintSetProduct(sets=(JS.BoxConstraint(lower=lo[:2], upper=hi[:2]),
                                          JS.NegativeOrthant()), dims=(2, 2)),
        ),
    }
    t_set, j_set = sets[name]
    z = np.random.default_rng(0).standard_normal((B, 7, 4))
    mu = 0.3
    for method in ("projection", "normal_cone_projection", "active_set",
                   "moreau_envelope"):
        _close(getattr(t_set, method)(torch.as_tensor(z), mu),
               getattr(j_set, method)(jnp.asarray(z), mu), name=method)


def _quad(rng):
    W = rng.standard_normal((NX, NX))
    Wu = rng.standard_normal((NU, NU))
    return dict(Wx=W @ W.T, Wu=Wu @ Wu.T, qx=rng.standard_normal(NX),
                qu=rng.standard_normal(NU), N=rng.standard_normal((NX, NU)), c=0.7)


def test_quadratic_cost_matches_jax_and_its_autodiff_default():
    rng = np.random.default_rng(1)
    p = _quad(rng)
    tc = QuadraticCost.create(**{k: torch.as_tensor(v, dtype=torch.float64)
                                 for k, v in p.items()})
    jc = JC.QuadraticCost.create(**{k: jnp.asarray(v) for k, v in p.items()})
    x, u = rng.standard_normal(NX), rng.standard_normal(NU)
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    ts, js = VectorSpace(NX), JM.VectorSpace(NX)
    _close(tc.value(ts, tx, tu), jc.value(js, jnp.asarray(x), jnp.asarray(u)), 1e-11)
    for port, ref in zip(tc.gradients(ts, tx, tu) + tc.hessians(ts, tx, tu),
                         jc.gradients(js, x, u) + jc.hessians(js, x, u)):
        _close(port, ref)
    # the base class's torch.func grad/hessian agree with the closed forms
    for ad, closed in zip(Cost.gradients(tc, ts, tx, tu) + Cost.hessians(tc, ts, tx, tu),
                          tc.gradients(ts, tx, tu) + tc.hessians(ts, tx, tu)):
        np.testing.assert_allclose(ad.numpy(), closed.numpy(), atol=1e-11, rtol=0)


def test_residual_and_dynamics_autodiff_defaults_match_closed_forms():
    rng = np.random.default_rng(2)
    space = VectorSpace(NX)
    x, u, xn = (torch.as_tensor(rng.standard_normal(n)) for n in (NX, NU, NX))
    ctrl = ControlErrorResidual(target=torch.as_tensor(rng.standard_normal(NU)))
    _close(StageFunction.jac_x(ctrl, space, x, u), ctrl.jac_x(space, x, u).numpy())
    _close(StageFunction.jac_u(ctrl, space, x, u), ctrl.jac_u(space, x, u).numpy())
    state = StateErrorResidual(target=xn, space=space)
    _close(StageFunction.jac_x(state, space, x, u), state.jac_x(space, x, u).numpy())
    _close(Manifold.jdifference(space, x, xn, 0), space.jdifference(x, xn, 0).numpy())
    _close(Manifold.jintegrate(space, x, xn, 1), space.jintegrate(x, xn, 1).numpy())
    dyn = LinearDiscreteDynamics(A=torch.as_tensor(rng.standard_normal((NX, NX))),
                                 B=torch.as_tensor(rng.standard_normal((NX, NU))),
                                 c=torch.as_tensor(rng.standard_normal(NX)))
    for ad, closed in zip(ExplicitDynamics.defect_jacobians(dyn, space, x, u, xn),
                          dyn.defect_jacobians(space, x, u, xn)):
        _close(ad, closed.numpy())


def _problems(rng):
    A = np.eye(NX) + 0.1 * rng.standard_normal((NX, NX))
    Bm = rng.standard_normal((NX, NU))
    c = 0.1 * rng.standard_normal(NX)
    Q, R, Qf = 0.1 * np.eye(NX), 0.01 * np.eye(NU), np.eye(NX)
    x0s = rng.standard_normal((B, NX))
    lo, hi = -0.3 * np.ones(NU), 0.4 * np.ones(NU)
    jp = jbuild(JM.VectorSpace(NX), NU, N, jnp.asarray(x0s[0]),
                JLin(A=jnp.asarray(A), B=jnp.asarray(Bm), c=jnp.asarray(c)),
                JC.QuadraticCost.create(jnp.asarray(Q), jnp.asarray(R)),
                JC.QuadraticCost.create(jnp.asarray(Qf), jnp.asarray(R)),
                constraints=((JCtrl(target=jnp.zeros(NU)),
                              JS.BoxConstraint(lower=tuple(lo), upper=tuple(hi)), NU),))
    tp = problem_from_numpy(A, Bm, c, Q, R, Qf, x0s, N, lo, hi, device="cpu")
    return jp, tp, x0s


def test_problem_passes_match_jax():
    rng = np.random.default_rng(3)
    jp, tp, x0s = _problems(rng)
    xs = rng.standard_normal((B, N + 1, NX))
    us = rng.standard_normal((B, N, NU))
    ev = jax.vmap(lambda x0, x, u: jevaluate(jp.replace_x0(x0), x, u))
    dv = jax.vmap(lambda x0, x, u: jderivs(jp.replace_x0(x0), x, u))
    args = (jnp.asarray(x0s), jnp.asarray(xs), jnp.asarray(us))
    d_j, g_j = ev(*args), dv(*args)
    d_t = evaluate(tp, torch.as_tensor(xs), torch.as_tensor(us))
    g_t = compute_derivatives(tp, torch.as_tensor(xs), torch.as_tensor(us))
    for name in d_t._fields:
        _close(getattr(d_t, name), getattr(d_j, name), 1e-11, name)
    # per element (ProblemData.traj_cost of JAX sums everything it holds)
    _close(d_t.traj_cost, d_j.costs.sum(-1) + d_j.term_cost, 1e-11, "traj_cost")
    for name in g_t._fields:
        _close(getattr(g_t, name), getattr(g_j, name), name=name)
    xs_j = jax.vmap(lambda x0, u: jrollout(jp, x0, u))(jnp.asarray(x0s), jnp.asarray(us))
    _close(rollout(tp, torch.as_tensor(x0s), torch.as_tensor(us)), xs_j, 1e-11, "rollout")
