"""The rest of the multibody layer of the port (slice 5) against the JAX
package in float64 on the CPU: ``build_serial_chain``, the algorithms
added in this slice (nonlinear effects, gravity torque, the RNEA mass
matrix, the centre of mass, the centroidal momentum, frame velocities and
Jacobians, forward dynamics with external forces), ``model_to_urdf`` and
``load_ur5``.

Models are built by the JAX package and carried to the port through
``convert.multibody_model_from_numpy``: the 6-link serial chain, a
3-link chain on a free flyer, the UR5 and the talos-dimension humanoid.
Values agree to 1e-10·max(1, max|ref|), Jacobians to 1e-10. The JAX side
runs eagerly."""

import numpy as np
import pytest
import torch
from torch.func import jacfwd

import jax
import jax.numpy as jnp

from aligator_tpu.multibody import algorithms as JA
from aligator_tpu.multibody import model as JMM
from aligator_tpu.multibody import urdf as JU
from aligator_tpu.multibody.spaces import MultibodyPhaseSpace as JPhase

from aligator_tpu_torch.convert import MULTIBODY_LEAVES
from aligator_tpu_torch.multibody import algorithms as TA
from aligator_tpu_torch.multibody import model as TMM
from aligator_tpu_torch.multibody import urdf as TU
from aligator_tpu_torch.multibody.spaces import MultibodyPhaseSpace as TPhase
from test_torch_frames_geometry import JAC, JAX_MODELS, VAL, _close, _robot, _t, port_model

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=list(JAX_MODELS))
def robot(request):
    return _robot(request.param)


# ---------------------------------------------------------------------------
# the model builder and the algorithms
# ---------------------------------------------------------------------------


def _tree(m):
    """A model's static tree as plain tuples (the two packages' JointSpec
    and FrameSpec are distinct classes)."""
    return (tuple((j.jtype, None if j.axis is None else tuple(float(a) for a in j.axis))
                  for j in m.joints), tuple(m.parents),
            tuple((f.name, f.parent_joint) for f in m.frames))


@pytest.mark.parametrize("kw", [dict(n_links=6), dict(n_links=0, free_flyer=True),
                                dict(n_links=2, link_length=0.35, link_mass=1.0,
                                     axes=[(0, 1, 0), (0, 1, 0)]),
                                dict(n_links=3, free_flyer=True)],
                         ids=["ur5_like", "quadrotor_body", "acrobot", "ff_chain"])
def test_build_serial_chain_matches_jax(kw):
    jm, tm = JMM.build_serial_chain(**kw), TMM.build_serial_chain(device="cpu", **kw)
    assert _tree(tm) == _tree(jm)
    for k in MULTIBODY_LEAVES:
        np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)),
                                      err_msg=k)


def test_algorithms_match_jax(robot):
    jm, tm, x, fid = robot
    q, v = x[:jm.nq], x[jm.nq:]
    tq, tv = _t(q), _t(v)
    jq, jv = jnp.asarray(q), jnp.asarray(v)
    _close(TA.nonlinear_effects(tm, tq, tv), JA.nonlinear_effects(jm, jq, jv), VAL, "nle")
    _close(TA.gravity_torque(tm, tq), JA.gravity_torque(jm, jq), VAL, "gravity")
    _close(TA.mass_matrix_rnea(tm, tq), JA.mass_matrix_rnea(jm, jq), VAL, "M rnea")
    _close(TA.mass_matrix(tm, tq), JA.mass_matrix(jm, jq), VAL, "M")
    _close(TA.com_position(tm, tq), JA.com_position(jm, jq), VAL, "com")
    h_t, c_t = TA.centroidal_momentum(tm, tq, tv)
    h_j, c_j = JA.centroidal_momentum(jm, jq, jv)
    _close(h_t, h_j, VAL, "h")
    _close(c_t, c_j, VAL, "com of centroidal_momentum")
    for local in (True, False):
        _close(TA.frame_velocity(tm, tq, tv, fid, local=local),
               JA.frame_velocity(jm, jq, jv, fid, local=local), VAL, f"v_frame local={local}")
    _close(TA.frame_jacobian_local(tm, tq, fid), JA.frame_jacobian_local(jm, jq, fid), JAC,
           "J_frame")


@pytest.mark.parametrize("name", ["chain3_ff", "ur5"])
def test_fwd_dynamics_with_external_forces_matches_jax(name):
    """``f_ext`` on two joints (local wrenches), value and Jacobian w.r.t.
    the configuration's tangent."""
    jm, tm, x, _ = _robot(name)
    rng = np.random.default_rng(1)
    q, v = x[:jm.nq], x[jm.nq:]
    tau = rng.standard_normal(jm.nv)
    f = rng.standard_normal((2, 6))
    picks = (1, jm.njoints - 1)
    jf = [jnp.asarray(f[picks.index(i)]) if i in picks else None for i in range(jm.njoints)]
    tf = [_t(f[picks.index(i)]) if i in picks else None for i in range(jm.njoints)]
    _close(TA.fwd_dynamics(tm, _t(q), _t(v), _t(tau), f_ext=tf),
           JA.fwd_dynamics(jm, jnp.asarray(q), jnp.asarray(v), jnp.asarray(tau), f_ext=jf),
           VAL, "a")
    jsp, tsp = JPhase(jm), TPhase(tm)
    jx = jax.jacfwd(lambda d: JA.fwd_dynamics(
        jm, jsp.integrate(jnp.asarray(x), d)[:jm.nq], jnp.asarray(v), jnp.asarray(tau),
        f_ext=jf))(jnp.zeros(jsp.ndx))
    tx = jacfwd(lambda d: TA.fwd_dynamics(
        tm, tsp.integrate(_t(x), d)[:tm.nq], _t(v), _t(tau), f_ext=tf))(torch.zeros(tsp.ndx,
                                                                              dtype=torch.float64))
    _close(tx, jx, JAC, "da/dx")


# ---------------------------------------------------------------------------
# URDF export and the UR5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["humanoid", "chain3_ff", "ur5"])
def test_model_to_urdf_matches_jax_and_round_trips(which):
    jm = JAX_MODELS[which]()
    tm = port_model(jm)
    text = TU.model_to_urdf(tm, name=which)
    assert text == JU.model_to_urdf(jm, name=which)
    back = TU.load_urdf(text, device="cpu")
    assert (back.joints, back.parents) == (tm.joints, tm.parents)
    for k in ("jplace_p", "mass", "com", "inertia"):
        _close(getattr(back, k), getattr(tm, k).numpy(), 1e-12, k)
    q = np.asarray(JPhase(jm).integrate(JPhase(jm).neutral(), jnp.asarray(
        0.3 * np.random.default_rng(3).standard_normal(jm.nv * 2))))[:jm.nq]
    for fr in tm.frames:
        _close(TA.frame_placement(back, _t(q), back.frame_id(fr.name)).p,
               TA.frame_placement(tm, _t(q), tm.frame_id(fr.name)).p.numpy(), 1e-12, fr.name)


def test_load_ur5_matches_jax():
    jm, tm = JU.load_ur5(), TU.load_ur5(device="cpu")
    assert (tm.nq, tm.nv, tm.njoints) == (jm.nq, jm.nv, jm.njoints) == (6, 6, 6)
    assert _tree(tm) == _tree(jm)
    assert tm.frame_id("ee_link") == jm.frame_id("ee_link")
    for k in MULTIBODY_LEAVES:
        np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)),
                                      err_msg=k)
