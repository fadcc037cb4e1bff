"""The frame residuals and the collision geometry of the port (slice 5)
against the JAX package in float64 on the CPU: every residual of
``functions/frames.py`` (value, value and Jacobian from one pass, and
the Jacobians) on the 6-link serial chain and the UR5 of
``examples/assets/ur5.urdf`` (the humanoid's run in
``test_torch_frames_humanoid.py``), and every primitive pair of
``multibody.geometry.pair_distance`` with its Jacobian on a 3-link chain.

Models are built by the JAX package and carried to the port through
``convert.multibody_model_from_numpy``. Values agree to
1e-10·max(1, max|ref|) and Jacobians to 1e-10 as well, 1e-9 for the
Frank-Wolfe pairs (a 48-step iteration). The JAX side runs eagerly."""

import numpy as np
import pytest
import torch
from torch.func import jacfwd

import jax
import jax.numpy as jnp

from aligator_tpu.functions import frames as JFr
from aligator_tpu.multibody import algorithms as JA
from aligator_tpu.multibody import geometry as JG
from aligator_tpu.multibody import model as JMM
from aligator_tpu.multibody import urdf as JU
from aligator_tpu.multibody.spaces import MultibodyPhaseSpace as JPhase

from aligator_tpu_torch.convert import MULTIBODY_LEAVES, multibody_model_from_numpy
from aligator_tpu_torch.functions import frames as TFr
from aligator_tpu_torch.multibody import geometry as TG
from aligator_tpu_torch.multibody.spaces import MultibodyPhaseSpace as TPhase

torch.set_num_threads(1)

VAL, JAC, FW = 1e-10, 1e-10, 1e-9


def _close(port, ref, tol, what=""):
    ref = np.asarray(ref)
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} > {tol:.0e}·{scale:.3g}"


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def port_model(jm):
    return multibody_model_from_numpy(
        {k: np.asarray(getattr(jm, k)) for k in MULTIBODY_LEAVES},
        [(j.jtype, j.axis) for j in jm.joints], jm.parents,
        [(f.name, f.parent_joint) for f in jm.frames], device="cpu")


JAX_MODELS = {
    "chain6": lambda: JMM.build_serial_chain(n_links=6),
    "chain3_ff": lambda: JMM.build_serial_chain(n_links=3, free_flyer=True),
    "ur5": lambda: JU.load_ur5(),
    "humanoid": lambda: JMM.build_humanoid(),
}


def _robot(name, seed=0):
    """(JAX model, port model, x as numpy (q, v) away from neutral, the
    frame the residuals use)."""
    jm = JAX_MODELS[name]()
    rng = np.random.default_rng(seed)
    space = JPhase(jm)
    x = np.asarray(space.integrate(space.neutral(), jnp.asarray(0.4 * rng.standard_normal(
        space.ndx))))
    frame = {"chain6": "tool0", "chain3_ff": "tool0", "ur5": "ee_link",
             "humanoid": "right_sole"}[name]
    return jm, port_model(jm), x, jm.frame_id(frame)


@pytest.fixture(scope="module", params=["chain6", "ur5"])
def robot(request):
    return _robot(request.param)


# ---------------------------------------------------------------------------
# the frame residuals
# ---------------------------------------------------------------------------


def _residuals(jm, tm, fid, rng):
    """name → (JAX residual, port residual, takes u)."""
    nf = len(jm.frames)
    other = (fid + nf - 1) % nf if nf > 1 else fid
    ref3, ref6 = rng.standard_normal(3), rng.standard_normal(6)
    R = np.asarray(JA.frame_placement(jm, jnp.asarray(np.asarray(jm.neutral_q())), fid).R)
    nk, fs = 2, 3
    active = np.array([1.0, 0.0])
    act = rng.standard_normal((jm.nv, 6))
    sl = 0.7
    return {
        "placement": (JFr.FramePlacementResidual(model=jm, ref_R=jnp.asarray(R),
                                                 ref_p=jnp.asarray(ref3), frame_id=fid),
                      TFr.FramePlacementResidual(model=tm, ref_R=_t(R), ref_p=_t(ref3),
                                                 frame_id=fid), False),
        "translation": (JFr.FrameTranslationResidual(model=jm, ref=jnp.asarray(ref3),
                                                     frame_id=fid),
                        TFr.FrameTranslationResidual(model=tm, ref=_t(ref3), frame_id=fid),
                        False),
        "velocity": (JFr.FrameVelocityResidual(model=jm, ref=jnp.asarray(ref6), frame_id=fid),
                     TFr.FrameVelocityResidual(model=tm, ref=_t(ref6), frame_id=fid), False),
        "equality": (JFr.FrameEqualityResidual(model=jm, frame_a=fid, frame_b=other),
                     TFr.FrameEqualityResidual(model=tm, frame_a=fid, frame_b=other), False),
        "fly_high": (JFr.FlyHighResidual(model=jm, slope=jnp.asarray(sl), frame_id=fid),
                     TFr.FlyHighResidual(model=tm, slope=_t(sl), frame_id=fid), False),
        "com_translation": (JFr.CenterOfMassTranslationResidual(model=jm, ref=jnp.asarray(ref3)),
                            TFr.CenterOfMassTranslationResidual(model=tm, ref=_t(ref3)), False),
        "com_velocity": (JFr.CenterOfMassVelocityResidual(model=jm, ref=jnp.asarray(ref3)),
                         TFr.CenterOfMassVelocityResidual(model=tm, ref=_t(ref3)), False),
        "dcm": (JFr.DCMPositionResidual(model=jm, ref=jnp.asarray(ref3),
                                        omega=jnp.asarray(3.2)),
                TFr.DCMPositionResidual(model=tm, ref=_t(ref3), omega=_t(3.2)), False),
        "centroidal_momentum": (JFr.CentroidalMomentumResidual(model=jm, ref=jnp.asarray(ref6)),
                                TFr.CentroidalMomentumResidual(model=tm, ref=_t(ref6)), False),
        "centroidal_momentum_derivative": (
            JFr.CentroidalMomentumDerivativeResidual(model=jm, active=jnp.asarray(active),
                                                     frame_ids=(fid, other), force_size=fs),
            TFr.CentroidalMomentumDerivativeResidual(model=tm, active=_t(active),
                                                     frame_ids=(fid, other), force_size=fs),
            True),
        "gravity_compensation": (
            JFr.GravityCompensationResidual(model=jm, actuation=jnp.asarray(act)),
            TFr.GravityCompensationResidual(model=tm, actuation=_t(act)), True),
        "collision": (
            JFr.FrameCollisionResidual(model=jm, geom1=JG.GeomObject(frame_id=fid, radius=0.05),
                                       geom2=JG.GeomObject(frame_id=-1, kind="box",
                                                           half_extents=(0.1, 0.2, 0.1),
                                                           offset_p=(0.3, 0.2, 0.4))),
            TFr.FrameCollisionResidual(model=tm, geom1=TG.GeomObject(frame_id=fid, radius=0.05),
                                       geom2=TG.GeomObject(frame_id=-1, kind="box",
                                                           half_extents=(0.1, 0.2, 0.1),
                                                           offset_p=(0.3, 0.2, 0.4))),
            False),
    }


RESIDUALS = ("placement", "translation", "velocity", "equality", "fly_high",
             "com_translation", "com_velocity", "dcm", "centroidal_momentum",
             "centroidal_momentum_derivative", "gravity_compensation", "collision")


@pytest.mark.parametrize("name", RESIDUALS)
def test_frame_residuals_match_jax(robot, name):
    check_residual(robot, name)


def check_residual(robot, name):
    jm, tm, x, fid = robot
    rng = np.random.default_rng(2)
    jr, tr, with_u = _residuals(jm, tm, fid, rng)[name]
    nu = 6 if with_u else 3
    u = rng.standard_normal(nu)
    jsp, tsp = JPhase(jm), TPhase(tm)
    jx, ju = jnp.asarray(x), jnp.asarray(u)
    ref = jr.value(jx, ju)
    _close(tr.value(_t(x), _t(u)), ref, VAL, f"{name} value")
    ref_jx = jr.jac_x(jsp, jx, ju)
    r, J = tr.value_and_jac_x(tsp, _t(x), _t(u))
    _close(r, ref, VAL, f"{name} value (value_and_jac_x)")
    _close(J, ref_jx, JAC, f"{name} Jx")
    _close(tr.jac_x(tsp, _t(x), _t(u)), ref_jx, JAC, f"{name} Jx (jac_x)")
    _close(tr.jac_u(tsp, _t(x), _t(u)), jr.jac_u(jsp, jx, ju), JAC, f"{name} Ju")


# ---------------------------------------------------------------------------
# the collision geometry
# ---------------------------------------------------------------------------

_HULL = tuple((0.1 * np.cos(a), 0.08 * np.sin(a), z) for z in (-0.05, 0.07)
              for a in np.linspace(0, 2 * np.pi, 6, endpoint=False))


def _geoms(mod):
    """The primitives of the pair tests, attached to the chain's frame 0
    (its tip) or fixed in the world, built with the module ``mod``."""
    G = mod.GeomObject
    return {
        "sphere": G(frame_id=0, kind="sphere", radius=0.05, offset_p=(0.02, 0.0, 0.01)),
        "capsule": G(frame_id=0, kind="capsule", radius=0.04, half_length=0.12,
                     offset_p=(0.0, 0.03, 0.0)),
        "convex": G(frame_id=0, kind="convex", radius=0.01, vertices=_HULL),
        "box": G(frame_id=0, kind="box", half_extents=(0.05, 0.07, 0.04)),
        "w_sphere": G(frame_id=-1, kind="sphere", radius=0.1, offset_p=(0.4, -0.3, 0.9)),
        "w_capsule": G(frame_id=-1, kind="capsule", radius=0.05, half_length=0.3,
                       offset_p=(-0.35, 0.25, 0.6)),
        "w_box": G(frame_id=-1, kind="box", half_extents=(0.1, 0.15, 0.2),
                   offset_p=(0.45, 0.35, 0.5)),
        "w_convex": G(frame_id=-1, kind="convex", radius=0.0, vertices=_HULL,
                      offset_p=(-0.3, -0.4, 0.7)),
        "ground": G(frame_id=-1, kind="halfspace", offset_p=(0.0, 0.0, -0.2)),
    }


PAIRS = [("sphere", "w_sphere"), ("sphere", "w_capsule"), ("capsule", "w_capsule"),
         ("capsule", "w_sphere"), ("sphere", "w_box"), ("w_box", "sphere"),
         ("capsule", "w_box"), ("sphere", "ground"), ("capsule", "ground"), ("box", "ground"),
         ("convex", "ground"), ("convex", "w_sphere"), ("sphere", "w_convex"),
         ("convex", "w_box"), ("box", "w_box"), ("capsule", "w_convex"), ("convex", "w_convex")]


@pytest.fixture(scope="module")
def chain():
    jm = JMM.build_serial_chain(n_links=3, link_length=0.4)
    return jm, port_model(jm)


@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_pair_distance_and_jacobian_match_jax(chain, pair):
    jm, tm = chain
    jg, tg = _geoms(JG), _geoms(TG)
    q = np.array([0.3, -0.7, 0.9])
    a, b = pair
    d_j = JG.pair_distance(jm, jnp.asarray(q), jg[a], jg[b])
    d_t = TG.pair_distance(tm, _t(q), tg[a], tg[b])
    fw = "convex" in a + b or (a.endswith("box") and b.endswith("box"))
    tol = FW if fw else JAC
    _close(d_t, d_j, VAL if not fw else FW, "distance")
    g_j = jax.jacfwd(lambda qq: JG.pair_distance(jm, qq, jg[a], jg[b]))(jnp.asarray(q))
    g_t = jacfwd(lambda qq: TG.pair_distance(tm, qq, tg[a], tg[b]))(_t(q))
    _close(g_t, g_j, tol, "d distance / dq")


def test_unsupported_pair_raises(chain):
    _, tm = chain
    tg = _geoms(TG)
    with pytest.raises(NotImplementedError):
        TG.pair_distance(tm, torch.zeros(tm.nq, dtype=torch.float64), tg["ground"],
                         TG.GeomObject(frame_id=0, kind="halfspace"))


# touching and degenerate configurations, where the eps-guarded norms and
# the clamps' ties decide the derivatives: a sphere on a box face, a
# sphere centred on a box edge, concentric spheres, coincident capsules
TOUCHING = {
    "sphere_on_box_face": (dict(kind="sphere", radius=0.05),
                           dict(kind="box", half_extents=(0.1, 0.1, 0.1), offset_p=(0.0, 0.0, 0.25))),
    "sphere_on_box_edge": (dict(kind="sphere", radius=0.05),
                           dict(kind="box", half_extents=(0.1, 0.1, 0.1), offset_p=(0.1, 0.0, 0.3))),
    "concentric_spheres": (dict(kind="sphere", radius=0.05),
                           dict(kind="sphere", radius=0.1, offset_p=(0.0, 0.0, 0.4))),
    "coincident_capsules": (dict(kind="capsule", radius=0.05, half_length=0.1),
                            dict(kind="capsule", radius=0.05, half_length=0.1,
                                 offset_p=(0.0, 0.0, 0.4))),
}


@pytest.mark.parametrize("case", list(TOUCHING))
def test_touching_configurations_match_jax(case):
    """A free-flying link whose tool frame sits at (0, 0, 0.4) at the
    neutral configuration, against a primitive fixed in the world: the
    avoidance constraint margin − d as the examples build it
    (``LinearFunctionComposition`` of a ``FrameCollisionResidual``), its
    value and Jacobian against the JAX package's."""
    from aligator_tpu.functions.basic import LinearFunctionComposition as JLFC
    from aligator_tpu_torch.functions.basic import LinearFunctionComposition as TLFC

    jm = JMM.build_serial_chain(n_links=1, free_flyer=True)
    tm = port_model(jm)
    a, b = TOUCHING[case]
    fid = jm.frame_id("tool0")
    jr = JLFC(inner=JFr.FrameCollisionResidual(model=jm, geom1=JG.GeomObject(frame_id=fid, **a),
                                               geom2=JG.GeomObject(frame_id=-1, **b)),
              A=-jnp.eye(1), b=jnp.asarray([0.02]))
    tr = TLFC(inner=TFr.FrameCollisionResidual(model=tm, geom1=TG.GeomObject(frame_id=fid, **a),
                                               geom2=TG.GeomObject(frame_id=-1, **b)),
              A=-torch.eye(1, dtype=torch.float64), b=_t([0.02]))
    jsp, tsp = JPhase(jm), TPhase(tm)
    x = np.asarray(jsp.neutral())
    u = np.zeros(1)
    _close(tr.value(_t(x), _t(u)), jr.value(jnp.asarray(x), jnp.asarray(u)), VAL, "value")
    ref = jr.jac_x(jsp, jnp.asarray(x), jnp.asarray(u))
    assert np.isfinite(np.asarray(ref)).all()
    _close(tr.jac_x(tsp, _t(x), _t(u)), ref, JAC, "Jx")
    _close(tr.value_and_jac_x(tsp, _t(x), _t(u))[1], ref, JAC, "Jx (one pass)")
