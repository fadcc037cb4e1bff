"""The port's multibody layer against the JAX package, module by module,
in float64 on the CPU: Lie groups and products, the equilibrated SPD
solve, RNEA / CRBA / ABA / forward and contact dynamics, frame
placements, the phase space, the frame residual and the four costs of
the talos walk. The robot is the talos-dimension humanoid, built by
``build_humanoid`` and loaded from the repository's URDF (the walk's
model), carried from the JAX model to the port by
``multibody_model_from_numpy``; the inputs come from a numpy seed. Values
agree to 1e-10·max(1, max|ref|) and the Jacobians through the implicit
rules to 1e-8·max(1, max|ref|).

The JAX references run eagerly (jit would compile each one for tens of
seconds): the algorithms' values are checked on both models, the
Jacobians, the phase space and the costs on the URDF model only."""

import numpy as np
import pytest
import torch
from torch.func import jacfwd

import jax
import jax.numpy as jnp

from aligator_tpu import costs as JC
from aligator_tpu import manifolds as JM
from aligator_tpu.functions.frames import FramePlacementResidual as JFrameRes
from aligator_tpu.linalg import spd as JSPD
from aligator_tpu.multibody import algorithms as JA
from aligator_tpu.multibody import contact as JCt
from aligator_tpu.multibody import model as JMM
from aligator_tpu.multibody.spaces import MultibodyConfiguration as JConfig
from aligator_tpu.multibody.spaces import MultibodyPhaseSpace as JPhase
from aligator_tpu.multibody.urdf import load_talos_like as jax_load_talos_like

from aligator_tpu_torch import costs as TC
from aligator_tpu_torch import manifolds as TM
from aligator_tpu_torch.convert import MULTIBODY_LEAVES, multibody_model_from_numpy
from aligator_tpu_torch.functions.frames import FramePlacementResidual as TFrameRes
from aligator_tpu_torch.linalg import spd as TSPD
from aligator_tpu_torch.manifolds.lie import SE3 as TSE3, quat_exp as t_quat_exp
from aligator_tpu_torch.manifolds.lie import quat_to_mat as t_quat_to_mat
from aligator_tpu_torch.multibody import algorithms as TA
from aligator_tpu_torch.multibody import contact as TCt
from aligator_tpu_torch.multibody.model import build_humanoid
from aligator_tpu_torch.multibody.spaces import MultibodyPhaseSpace as TPhase
from aligator_tpu_torch.multibody.spatial import so3_log
from aligator_tpu_torch.multibody.urdf import TALOS_LIKE_URDF, load_talos_like, load_urdf
from aligator_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

VAL, JAC = 1e-10, 1e-8
MODELS = ("humanoid", "talos_urdf")


def _close(port, ref, tol, what=""):
    ref = np.asarray(ref)
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} > {tol:.0e}·{scale:.3g}"


def _t(a):
    return torch.as_tensor(np.asarray(a))


def port_model(jm):
    return multibody_model_from_numpy(
        {k: np.asarray(getattr(jm, k)) for k in MULTIBODY_LEAVES},
        [(j.jtype, j.axis) for j in jm.joints], jm.parents,
        [(f.name, f.parent_joint) for f in jm.frames], device="cpu")


def port_contacts(cs):
    return TCt.ContactSet(
        *(_t(getattr(cs, k)) for k in ("anchor_R", "anchor_p", "active", "kp", "kd")),
        specs=tuple(TCt.ContactSpec(s.name, s.frame_id, s.dim) for s in cs.specs))


def _robot(name):
    """(JAX model, port model, inputs): a configuration perturbed from the
    half-sitting posture, v, a, τ, and the two sole contacts anchored at
    the posture with the right one inactive."""
    jm = JMM.build_humanoid() if name == "humanoid" else jax_load_talos_like()
    rng = np.random.default_rng(0)
    q0 = JMM.humanoid_half_sitting(jm)
    q = np.asarray(JConfig(jm).integrate(q0, jnp.asarray(0.3 * rng.standard_normal(jm.nv))))
    v, a, tau = (rng.standard_normal(jm.nv) for _ in range(3))
    cs = JCt.anchor_at_configuration(
        jm, JCt.make_contact_set(jm, (("left_sole", 6), ("right_sole", 6))), q0)
    cs = cs.replace(active=jnp.asarray([1.0, 0.0]))
    return dict(jm=jm, tm=port_model(jm), q=q, v=v, a=a, tau=tau, cs=cs,
                tcs=port_contacts(cs))


@pytest.fixture(scope="module", params=MODELS)
def robot(request):
    return _robot(request.param)


@pytest.fixture(scope="module")
def talos():
    return _robot("talos_urdf")


ALGOS = {
    "rnea": (lambda m, r: JA.rnea(m, r["q"], r["v"], r["a"]),
             lambda m, r: TA.rnea(m, _t(r["q"]), _t(r["v"]), _t(r["a"]))),
    "crba": (lambda m, r: JA.crba(m, r["q"]), lambda m, r: TA.crba(m, _t(r["q"]))),
    "aba": (lambda m, r: JA.aba(m, r["q"], r["v"], r["tau"]),
            lambda m, r: TA.aba(m, _t(r["q"]), _t(r["v"]), _t(r["tau"]))),
    "fwd_dynamics": (lambda m, r: JA.fwd_dynamics(m, r["q"], r["v"], r["tau"]),
                     lambda m, r: TA.fwd_dynamics(m, _t(r["q"]), _t(r["v"]), _t(r["tau"]))),
    "frame_placement": (
        lambda m, r: tuple(JA.frame_placement(m, r["q"], m.frame_id("right_sole"))),
        lambda m, r: tuple(TA.frame_placement(m, _t(r["q"]), m.frame_id("right_sole")))),
    "constrained_dynamics": (
        lambda m, r: JCt.constrained_dynamics(m, r["cs"], r["q"], r["v"], r["tau"]),
        lambda m, r: TCt.constrained_dynamics(m, r["tcs"], _t(r["q"]), _t(r["v"]),
                                              _t(r["tau"]))),
}


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_algorithm_matches_jax(robot, name):
    jfn, tfn = ALGOS[name]
    ref, out = jfn(robot["jm"], robot), tfn(robot["tm"], robot)
    if not isinstance(ref, tuple):
        ref, out = (ref,), (out,)
    for k, (a, b) in enumerate(zip(out, ref)):
        _close(a, b, VAL, f"{name}[{k}]")


def test_mass_matrix_agrees_with_aba(robot):
    """CRBA's M against the articulated-body algorithm: M·ABA(q, v, τ) + b = τ."""
    tm, q, v, tau = robot["tm"], _t(robot["q"]), _t(robot["v"]), _t(robot["tau"])
    M, b = TA.mass_matrix_and_bias(tm, q, v)
    _close(M @ TA.aba(tm, q, v, tau) + b, robot["tau"], VAL, "M·a + b")


@pytest.mark.parametrize("name", ["fwd_dynamics", "constrained_dynamics"])
def test_implicit_jacobians_match_jax(talos, name):
    """jacfwd through the implicit rules, w.r.t. a tangent of q on the
    configuration manifold, v and τ."""
    jm, tm, r = talos["jm"], talos["tm"], talos
    if name == "fwd_dynamics":
        jf = lambda q, v, t: JA.fwd_dynamics(jm, q, v, t)
        tf = lambda q, v, t: TA.fwd_dynamics(tm, q, v, t)
    else:
        jf = lambda q, v, t: jnp.concatenate(JCt.constrained_dynamics(jm, r["cs"], q, v, t))
        tf = lambda q, v, t: torch.cat(TCt.constrained_dynamics(tm, r["tcs"], q, v, t))
    jcfg = JConfig(jm)
    from aligator_tpu_torch.multibody.spaces import MultibodyConfiguration

    tcfg = MultibodyConfiguration(tm)
    z = np.zeros(jm.nv)
    ref = jax.jacfwd(lambda d, v, t: jf(jcfg.integrate(jnp.asarray(r["q"]), d), v, t),
                     argnums=(0, 1, 2))(jnp.asarray(z), jnp.asarray(r["v"]),
                                        jnp.asarray(r["tau"]))
    out = jacfwd(lambda d, v, t: tf(tcfg.integrate(_t(r["q"]), d), v, t),
                 argnums=(0, 1, 2))(_t(z), _t(r["v"]), _t(r["tau"]))
    for wrt, a, b in zip(("q", "v", "tau"), out, ref):
        _close(a, b, JAC, f"d{name}/d{wrt}")


def test_phase_space_matches_jax(talos):
    """MultibodyPhaseSpace: integrate, difference and both Jacobians of each."""
    jsp, tsp = JPhase(talos["jm"]), TPhase(talos["tm"])
    rng = np.random.default_rng(1)
    x0 = np.concatenate([talos["q"], talos["v"]])
    dx = 0.4 * rng.standard_normal(jsp.ndx)
    x1 = np.asarray(jsp.integrate(jnp.asarray(x0), jnp.asarray(dx)))
    _close(tsp.integrate(_t(x0), _t(dx)), x1, VAL, "integrate")
    _close(tsp.difference(_t(x0), _t(x1)), jsp.difference(x0, x1), VAL, "difference")
    for arg in (0, 1):
        _close(tsp.jintegrate(_t(x0), _t(dx), arg), jsp.jintegrate(x0, dx, arg), VAL,
               f"jintegrate {arg}")
        _close(tsp.jdifference(_t(x0), _t(x1), arg), jsp.jdifference(x0, x1, arg), VAL,
               f"jdifference {arg}")


COSTS = ("state", "control", "frame", "stack")


def _costs(jm, tm, q0, x_ref):
    """The four costs of the walk's stages, built alike in both packages."""
    fid = jm.frame_id("right_sole")
    M = JA.frame_placement(jm, jnp.asarray(q0), fid)
    jsp, tsp = JPhase(jm), TPhase(tm)
    nu = jm.nv - 6
    wx = np.diag(np.linspace(1.0, 100.0, jsp.ndx))
    wu, wf = 1e-3 * np.eye(nu), 1e4 * np.eye(6)
    jres = JFrameRes(model=jm, ref_R=M.R, ref_p=M.p + jnp.asarray([0.0, 0.0, 0.05]),
                     frame_id=fid)
    tres = TFrameRes(model=tm, ref_R=_t(M.R), ref_p=_t(M.p) + _t([0.0, 0.0, 0.05]),
                     frame_id=fid)
    j = dict(state=JC.QuadraticStateCost(jsp, jnp.asarray(x_ref), jnp.asarray(wx)),
             control=JC.QuadraticControlCost(jnp.zeros(nu), jnp.asarray(wu)),
             frame=JC.QuadraticResidualCost(residual=jres, W=jnp.asarray(wf)))
    t = dict(state=TC.QuadraticStateCost(tsp, _t(x_ref), _t(wx)),
             control=TC.QuadraticControlCost(torch.zeros(nu, dtype=torch.float64), _t(wu)),
             frame=TC.QuadraticResidualCost(residual=tres, W=_t(wf)))
    j["stack"] = JC.CostStack.create((j["state"], 1.0), (j["control"], 1.0), (j["frame"], 0.5))
    t["stack"] = TC.CostStack.create((t["state"], 1.0), (t["control"], 1.0), (t["frame"], 0.5))
    return jsp, tsp, j, t, jres, tres


@pytest.mark.parametrize("kind", COSTS)
def test_cost_matches_jax(talos, kind):
    jm, tm = talos["jm"], talos["tm"]
    rng = np.random.default_rng(2)
    q0 = np.asarray(JMM.humanoid_half_sitting(jm))
    x = np.concatenate([talos["q"], talos["v"]])
    x_ref = np.concatenate([q0, np.zeros(jm.nv)])
    u = rng.standard_normal(jm.nv - 6)
    jsp, tsp, jc, tc, _, _ = _costs(jm, tm, q0, x_ref)
    jc, tc = jc[kind], tc[kind]
    _close(tc.value(tsp, _t(x), _t(u)), jc.value(jsp, x, u), VAL, "value")
    for k, (a, b) in enumerate(zip(tc.gradients(tsp, _t(x), _t(u)), jc.gradients(jsp, x, u))):
        _close(a, b, VAL, f"gradient {k}")
    for k, (a, b) in enumerate(zip(tc.hessians(tsp, _t(x), _t(u)), jc.hessians(jsp, x, u))):
        _close(a, b, VAL, f"hessian {k}")
    for k, (a, b) in enumerate(zip(tc.derivatives(tsp, _t(x), _t(u)),
                                   (*jc.gradients(jsp, x, u), *jc.hessians(jsp, x, u)))):
        _close(a, b, VAL, f"derivatives {k}")


def test_frame_placement_residual_matches_jax(talos):
    jm, tm = talos["jm"], talos["tm"]
    q0 = np.asarray(JMM.humanoid_half_sitting(jm))
    x = np.concatenate([talos["q"], talos["v"]])
    jsp, tsp, _, _, jres, tres = _costs(jm, tm, q0, x)
    u = np.zeros(jm.nv - 6)
    _close(tres.value(_t(x), _t(u)), jres.value(x, u), VAL, "value")
    _close(tres.jac_x(tsp, _t(x), _t(u)), jres.jac_x(jsp, x, u), VAL, "jac_x")
    r, J = tres.value_and_jac_x(tsp, _t(x), _t(u))
    _close(r, jres.value(x, u), VAL, "value (fused)")
    _close(J, jres.jac_x(jsp, x, u), VAL, "jac_x (fused)")


def test_urdf_and_builder_models_match_jax():
    """The port loads the same URDF asset and builds the same humanoid as
    the JAX package: every leaf and the static tree agree."""
    for jm, tm in ((jax_load_talos_like(), load_talos_like(device="cpu")),
                   (JMM.build_humanoid(), build_humanoid(device="cpu"))):
        assert [(j.jtype, j.axis) for j in jm.joints] == [(j.jtype, j.axis) for j in tm.joints]
        assert tuple(jm.parents) == tm.parents
        assert [(f.name, f.parent_joint) for f in jm.frames] == [
            (f.name, f.parent_joint) for f in tm.frames]
        for k in MULTIBODY_LEAVES:
            _close(getattr(tm, k), getattr(jm, k), 1e-15, k)


def test_model_builders_default_to_the_card(monkeypatch):
    """With ``device=None`` each builder asks ``resolve_device`` for the
    card, so on a box without a GPU it raises the same RuntimeError and
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        resolve_device(None)
    for build in (load_talos_like, build_humanoid,
                  lambda: load_urdf(str(TALOS_LIKE_URDF))):
        with pytest.raises(RuntimeError) as got:
            build()
        assert str(got.value) == str(want.value)


LIE = {"SO2": (JM.SO2(), TM.SO2()), "SO3": (JM.SO3(), TM.SO3()),
       "SE2": (JM.SE2(), TM.SE2()), "SE3": (JM.SE3(), TM.SE3()),
       "SO3xR2": (JM.SO3() * JM.VectorSpace(2), TM.SO3() * TM.VectorSpace(2)),
       "TSE3": (JM.TangentBundle(JM.SE3()), TM.TangentBundle(TM.SE3()))}


@pytest.mark.parametrize("name", sorted(LIE))
def test_manifold_matches_jax(name):
    jsp, tsp = LIE[name]
    assert (tsp.nx, tsp.ndx) == (jsp.nx, jsp.ndx)
    rng = np.random.default_rng(3)
    x0 = np.asarray(jsp.integrate(jsp.neutral(), jnp.asarray(rng.standard_normal(jsp.ndx))))
    dx = 0.7 * rng.standard_normal(jsp.ndx)
    x1 = np.asarray(jsp.integrate(jnp.asarray(x0), jnp.asarray(dx)))
    _close(tsp.neutral(), jsp.neutral(), VAL, "neutral")
    _close(tsp.integrate(_t(x0), _t(dx)), x1, VAL, "integrate")
    _close(tsp.difference(_t(x0), _t(x1)), jsp.difference(x0, x1), VAL, "difference")
    for arg in (0, 1):
        _close(tsp.jintegrate(_t(x0), _t(dx), arg), jsp.jintegrate(x0, dx, arg), VAL,
               f"jintegrate {arg}")
        _close(tsp.jdifference(_t(x0), _t(x1), arg), jsp.jdifference(x0, x1, arg), VAL,
               f"jdifference {arg}")


def test_spd_solve_matches_jax():
    rng = np.random.default_rng(4)
    W = rng.standard_normal((9, 9)) * np.logspace(-1, 1, 9)  # cond(M) ~ 1e4, as a talos M
    M = W @ W.T + 1e-3 * np.eye(9)
    for b in (rng.standard_normal(9), rng.standard_normal((9, 3))):
        _close(TSPD.spd_solve(_t(M), _t(b)), JSPD.spd_solve(jnp.asarray(M), jnp.asarray(b)),
               VAL, f"spd_solve {b.shape}")


@pytest.mark.parametrize("theta", [0.0, 1e-4])
def test_so3_log_tangent_finite_in_float32(theta):
    """The double-where guard of so3_log: at R = I and near it, the
    forward-mode tangent in float32 is finite and equals the rotation
    direction (log3(exp(s·w)) = s·w)."""
    w = torch.tensor([0.3, -0.5, 0.8], dtype=torch.float32)
    w = w / w.norm()
    R = lambda s: t_quat_to_mat(t_quat_exp(s * w))
    val, tan = torch.func.jvp(lambda s: so3_log(R(s)), (torch.tensor(theta),),
                              (torch.tensor(1.0),))
    assert torch.isfinite(val).all() and torch.isfinite(tan).all()
    assert float((tan - w).abs().max()) < 1e-3
    J = jacfwd(lambda d: so3_log(R(torch.tensor(theta)) @ t_quat_to_mat(t_quat_exp(d))))(
        torch.zeros(3))
    assert torch.isfinite(J).all()


def test_se3_integrate_matches_quaternion_chain():
    """SE3 ⊕ through the port's closed forms: zero tangent is the exact
    identity map (the frame residual's fused value relies on it)."""
    x = torch.tensor([0.1, -0.2, 0.3, 0.0, 0.6, 0.0, 0.8], dtype=torch.float64)
    assert torch.equal(TSE3().integrate(x, torch.zeros(6, dtype=torch.float64)), x)


INTEGRATORS = ("EulerIntegrator", "SemiImplEulerIntegrator", "RK2Integrator", "RK4Integrator")


@pytest.mark.parametrize("name", INTEGRATORS)
def test_integrator_matches_jax(name):
    """The integrators on ẋ = A x + B u + c over R⁴ (a phase space of two
    coordinates for the semi-implicit one): x⁺ and the defect Jacobians."""
    import aligator_tpu.dynamics as JD
    import aligator_tpu_torch.dynamics as TD

    rng = np.random.default_rng(5)
    A, B, c = rng.standard_normal((4, 4)), rng.standard_normal((4, 2)), rng.standard_normal(4)
    x, u, x_ref = rng.standard_normal(4), rng.standard_normal(2), rng.standard_normal(4)
    jdyn = getattr(JD, name)(ode=JD.LinearODE(A=jnp.asarray(A), B=jnp.asarray(B),
                                              c=jnp.asarray(c)), dt=jnp.asarray(0.05))
    tdyn = getattr(TD, name)(ode=TD.LinearODE(A=_t(A), B=_t(B), c=_t(c)), dt=_t(0.05))
    jsp, tsp = JM.VectorSpace(4), TM.VectorSpace(4)
    _close(tdyn.forward(tsp, _t(x), _t(u)), jdyn.forward(jsp, x, u), VAL, "forward")
    for k, (a, b) in enumerate(zip(tdyn.defect_jacobians(tsp, _t(x), _t(u), _t(x_ref)),
                                   jdyn.defect_jacobians(jsp, x, u, x_ref))):
        _close(a, b, VAL, f"defect jacobian {k}")


def test_free_fwd_dynamics_matches_jax(talos):
    """MultibodyFreeFwdDynamics: ẋ = (v, FD(q, v, B·u)) with the floating
    base unactuated."""
    from aligator_tpu.dynamics.multibody import MultibodyFreeFwdDynamics as JFree
    from aligator_tpu.dynamics.multibody import floating_base_actuation as j_act
    from aligator_tpu_torch.dynamics.multibody import MultibodyFreeFwdDynamics as TFree
    from aligator_tpu_torch.dynamics.multibody import floating_base_actuation as t_act

    jm, tm = talos["jm"], talos["tm"]
    x = np.concatenate([talos["q"], talos["v"]])
    u = talos["tau"][6:]
    ref = JFree(model=jm, actuation=j_act(jm)).xdot(JPhase(jm), x, u)
    out = TFree(model=tm, actuation=t_act(tm)).xdot(TPhase(tm), _t(x), _t(u))
    _close(out, ref, VAL, "xdot")


@pytest.mark.parametrize("name", ["SO2", "SO3", "SE2", "SE3"])
def test_lie_normalize_matches_jax(name):
    jsp, tsp = LIE[name]
    rng = np.random.default_rng(6)
    x = np.asarray(jsp.integrate(jsp.neutral(), jnp.asarray(rng.standard_normal(jsp.ndx))))
    x2 = x.copy()
    x2[-2:] *= 1.5  # scale the rotation part off the unit circle / sphere
    _close(tsp.normalize(_t(x2)), jsp.normalize(x2), VAL, "normalize")
    assert bool(tsp.is_normalized(_t(x))) and not bool(tsp.is_normalized(_t(x2)))
