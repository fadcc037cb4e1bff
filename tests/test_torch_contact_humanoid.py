"""The humanoid's part of the legged modelling layer (slice 6) against
the JAX package in float64 on the CPU, beside
``test_torch_contact_centroidal.py``: the force and wrench-cone residuals
of a sole contact (value, Jacobians in x and u), and
``KinodynamicsFwdDynamics`` with 6D wrenches through the problem's batched
derivative pass (``vmap`` of ``jacfwd``, the path where
``torch.linalg.solve``'s forward derivative goes wrong), 1e-10·max(1,
max|ref|)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aligator_tpu import multibody as JMB
from aligator_tpu.dynamics import multibody as JDM

from aligator_tpu_torch import multibody as TMB
from aligator_tpu_torch.dynamics import multibody as TDM
from test_torch_contact_centroidal import TOL, _standing, check_contact_residuals, check_derivs, t64

torch.set_num_threads(1)


@pytest.mark.parametrize("robot", ["humanoid"])
def test_contact_residuals_match_jax(robot):
    """The force residual and the wrench cone on the humanoid's left sole."""
    check_contact_residuals(robot)


def _kino_problems(N=3):
    """A short problem on the humanoid with the kinodynamic ODE (Euler, 6D
    contact wrenches, the right sole inactive) in both packages: (JAX
    problem, port problem, JAX space)."""
    from aligator_tpu import costs as JC
    from aligator_tpu.dynamics import EulerIntegrator as JEuler
    from aligator_tpu.problem import build_problem as jbuild

    from aligator_tpu_torch import costs as TC
    from aligator_tpu_torch.dynamics import EulerIntegrator as TEuler
    from aligator_tpu_torch.problem import build_problem as tbuild
    from aligator_tpu_torch.utils.tree import shared

    jm, tm, q0, _ = _standing("humanoid")
    nv, nk, fs = jm.nv, 2, 6
    nu = nk * fs + nv - 6
    fids = (jm.frame_id("left_sole"), jm.frame_id("right_sole"))
    active = np.array([1.0, 0.0])
    jode = JDM.KinodynamicsFwdDynamics(model=jm, active=jnp.asarray(active), frame_ids=fids,
                                       force_size=fs)
    tode = TDM.KinodynamicsFwdDynamics(model=tm, active=t64(active), frame_ids=fids,
                                       force_size=fs)
    jspace, tspace = JMB.MultibodyPhaseSpace(jm), TMB.MultibodyPhaseSpace(tm)
    x0 = np.concatenate([q0, np.zeros(nv)])
    W = np.eye(nu)
    jcost = JC.QuadraticControlCost(jnp.zeros(nu), jnp.asarray(W))
    tcost = TC.QuadraticControlCost(t64(np.zeros(nu)), t64(W))
    jterm = JC.QuadraticStateCost(jspace, jnp.asarray(x0), jnp.eye(2 * nv))
    tterm = TC.QuadraticStateCost(tspace, t64(x0), torch.eye(2 * nv, dtype=torch.float64))
    jp = jbuild(jspace, nu, N, jnp.asarray(x0), JEuler(ode=jode, dt=jnp.asarray(0.05)),
                jcost, jterm)
    tp = tbuild(tspace, nu, N, t64(x0), shared(TEuler(ode=tode, dt=t64(0.05))), shared(tcost),
                shared(tterm), device="cpu", dtype=torch.float64)
    return jp, tp, jspace


def test_kinodynamics_in_the_derivative_pass_matches_jax():
    """6D contact wrenches, one contact active (the squat's 3D forces are
    held in ``test_torch_examples_legged.py``): the defects (xdot through
    Euler) and A, B of the problem's batched derivative pass (``vmap`` over
    batch and time of ``jacfwd`` through the nested ``jacfwd`` / ``jvp`` of
    the momentum matrix and the 6×6 solve) at two seeded trajectories."""
    jp, tp, jspace = _kino_problems()
    rng = np.random.default_rng(5)
    N, nu = tp.nsteps, tp.nu
    x0 = np.asarray(jp.x0)
    xs = np.stack([np.stack([np.asarray(jspace.integrate(
        jnp.asarray(x0), jnp.asarray(0.1 * rng.standard_normal(jspace.ndx))))
        for _ in range(N + 1)]) for _ in range(2)])
    us = rng.standard_normal((2, N, nu))
    err = check_derivs(jp, tp, xs, us, TOL, "kinodynamics")
    print(f"kinodynamics fs=6: derivative pass max rel err {err:.3e}")
