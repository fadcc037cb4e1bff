"""The legged and centroidal modelling layer of the port (slice 6) against
the JAX package in float64 on the CPU: the quadruped builders (exact),
``contact_forces``, ``contact_slice`` and the minimum-norm
``underactuated_constrained_inverse_dynamics`` on the two wide systems
(the quadruped's 18 × 24, the humanoid's 28 × 34), every contact and
centroidal residual's value and Jacobians in x and u, the centroidal
ODEs. The humanoid's contact residuals and ``KinodynamicsFwdDynamics``
through the problem's batched derivative pass are held in
``test_torch_contact_humanoid.py`` (files of their own, so that their JAX
compilations, a minute or two each, run side by side).

Values and Jacobians agree to 1e-10·max(1, max|ref|). The JAX side is
``jax.jit``-compiled per function."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligator_tpu import multibody as JMB
from aligator_tpu.dynamics import centroidal as JCD
from aligator_tpu.dynamics import multibody as JDM
from aligator_tpu.functions import centroidal as JFC
from aligator_tpu.functions import contact as JFK
from aligator_tpu.manifolds import VectorSpace as JVec
from aligator_tpu.multibody import contact as JCT
from aligator_tpu.multibody import model as JMM

from aligator_tpu_torch import multibody as TMB
from aligator_tpu_torch.convert import MULTIBODY_LEAVES
from aligator_tpu_torch.dynamics import centroidal as TCD
from aligator_tpu_torch.dynamics import multibody as TDM
from aligator_tpu_torch.functions import centroidal as TFC
from aligator_tpu_torch.functions import contact as TFK
from aligator_tpu_torch.manifolds import VectorSpace as TVec
from aligator_tpu_torch.multibody import contact as TCT
from aligator_tpu_torch.multibody import model as TMM

torch.set_num_threads(1)

TOL = 1e-10


def close(port, ref, tol, what=""):
    """max|port − ref| ≤ tol·max(1, max|ref|); returns the relative error."""
    ref = np.asarray(ref)
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    err = float(np.abs(port - ref).max()) / scale if ref.size else 0.0
    assert err <= tol, f"{what}: max abs err {err:.3e}·{scale:.3g} > {tol:.0e}"
    return err


def t64(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def check_derivs(jp, tp, xs, us, tol, what=""):
    """One ``compute_derivatives`` and one ``evaluate`` of the JAX problem
    ``jp`` at each trajectory of (xs (B, N+1, nx), us (B, N, nu)) against
    the port problem ``tp``'s batched pass; returns the largest relative
    error."""
    from aligator_tpu.problem import compute_derivatives as jderivs
    from aligator_tpu.problem import evaluate as jeval

    from aligator_tpu_torch.problem import compute_derivatives as tderivs
    from aligator_tpu_torch.problem import evaluate as teval

    if tp.x0.dim() == 1:
        tp = tp.replace_x0(tp.x0.expand(xs.shape[0], -1))
    td, tv = tderivs(tp, t64(xs), t64(us)), teval(tp, t64(xs), t64(us))
    jd_fn = jax.jit(lambda p, x, u: (jderivs(p, x, u), jeval(p, x, u)))
    worst = 0.0
    for b in range(xs.shape[0]):
        jd, jv = jd_fn(jp, jnp.asarray(xs[b]), jnp.asarray(us[b]))
        for name in jd._fields:
            worst = max(worst, close(getattr(td, name)[b], getattr(jd, name), tol,
                                     f"{what} {name}[{b}]"))
        for name in ("costs", "term_cost", "dyn_defects", "cstr_vals", "term_cstr_vals"):
            worst = max(worst, close(getattr(tv, name)[b], getattr(jv, name), tol,
                                     f"{what} {name}[{b}]"))
    return worst


# ---------------------------------------------------------------------------
# the quadruped builders and the contact helpers
# ---------------------------------------------------------------------------


def test_quadruped_builders_match_jax_exactly():
    jm, tm = JMM.build_quadruped(), TMM.build_quadruped(device="cpu")
    assert (tm.nq, tm.nv) == (jm.nq, jm.nv) == (19, 18)
    assert [(j.jtype, j.axis) for j in tm.joints] == [(j.jtype, j.axis) for j in jm.joints]
    assert tm.parents == tuple(jm.parents)
    assert [(f.name, f.parent_joint) for f in tm.frames] == [
        (f.name, f.parent_joint) for f in jm.frames]
    for name in MULTIBODY_LEAVES:
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(TMM.quadruped_standing(tm).numpy(),
                                  np.asarray(JMM.quadruped_standing(jm)))


def _standing(robot):
    """(JAX model, port model, q0, contacts as (name, dim) pairs)."""
    if robot == "quadruped":
        jm, tm = JMM.build_quadruped(), TMM.build_quadruped(device="cpu")
        q0 = np.asarray(JMM.quadruped_standing(jm))
        feet = tuple((f, 3) for f in ("fl_foot", "fr_foot", "hl_foot", "hr_foot"))
    else:
        jm, tm = JMM.build_humanoid(), TMM.build_humanoid(device="cpu")
        q0 = np.asarray(JMM.humanoid_half_sitting(jm))
        feet = (("left_sole", 6), ("right_sole", 6))
    return jm, tm, q0, feet


def _contacts(jm, tm, q0, feet, active=None):
    jc = JMB.anchor_at_configuration(jm, JMB.make_contact_set(jm, feet, kp=10.0, kd=6.0),
                                     jnp.asarray(q0))
    tc = TMB.anchor_at_configuration(tm, TMB.make_contact_set(tm, feet, kp=10.0, kd=6.0,
                                                              device="cpu"), t64(q0))
    if active is not None:
        jc = jc.replace(active=jnp.asarray(active, jnp.float64))
        tc = tc.replace(active=t64(active))
    return jc, tc


@pytest.mark.parametrize("robot,shape", [("quadruped", (18, 24)), ("humanoid", (28, 34))])
def test_underactuated_inverse_dynamics_is_the_minimum_norm_solution(robot, shape):
    """The wide systems W = [B, −Jᵀ]: the port's pseudo-inverse answer
    equals JAX's ``lstsq`` (SVD, minimum norm), balances the nonlinear
    effects, and is orthogonal to W's null space (minimum norm)."""
    jm, tm, q0, feet = _standing(robot)
    jc, tc = _contacts(jm, tm, q0, feet)
    jact, tact = JDM.floating_base_actuation(jm), TDM.floating_base_actuation(tm, device="cpu")
    v0 = 0.1 * np.random.default_rng(0).standard_normal(jm.nv)
    ju, jl = JCT.underactuated_constrained_inverse_dynamics(jm, jc, jact, jnp.asarray(q0),
                                                            jnp.asarray(v0))
    tu, tl = TCT.underactuated_constrained_inverse_dynamics(tm, tc, tact, t64(q0), t64(v0))
    close(tu, ju, TOL, "u")
    close(tl, jl, TOL, "lambda")
    J, _ = TCT._contact_rows(tm, tc, t64(q0), t64(v0), TCT.kinematics(tm, t64(q0)))
    W = torch.cat([tact, -J.mT], dim=1)
    assert tuple(W.shape) == shape
    sol = torch.cat([tu, tl])
    b = TCT.rnea(tm, t64(q0), t64(v0), torch.zeros(tm.nv, dtype=torch.float64))
    close(W @ sol - b, np.zeros(shape[0]), 1e-9, "balance")
    # minimum norm: sol lies in the row space of W
    null = torch.linalg.svd(W).Vh[shape[0]:]
    close(null @ sol, np.zeros(shape[1] - shape[0]), 1e-9, "null-space component")


def test_contact_forces_and_slices_match_jax():
    jm, tm, q0, feet = _standing("quadruped")
    jc, tc = _contacts(jm, tm, q0, feet, active=[1.0, 0.0, 1.0, 1.0])
    rng = np.random.default_rng(1)
    x = np.concatenate([q0, 0.2 * rng.standard_normal(jm.nv)])
    u = rng.standard_normal(jm.nv - 6)
    jact, tact = JDM.floating_base_actuation(jm), TDM.floating_base_actuation(tm, device="cpu")
    jl = JCT.contact_forces(jm, jc, jact, jnp.asarray(x), jnp.asarray(u))
    tl = TCT.contact_forces(tm, tc, tact, t64(x), t64(u))
    close(tl, jl, TOL, "lambda")
    assert float(tl[3:6].abs().max()) == 0.0  # the inactive contact's force is exactly 0
    for name, _ in feet:
        assert TCT.contact_slice(tc, name) == JCT.contact_slice(jc, name)
    with pytest.raises(KeyError):
        TCT.contact_slice(tc, "nose")


# ---------------------------------------------------------------------------
# residuals: value and Jacobians in x and u
# ---------------------------------------------------------------------------


def _check_residuals(pairs, jspace, tspace, x, u):
    """Value, jac_x and jac_u of each port residual of ``pairs`` (name →
    (JAX residual, port residual)) against one compiled JAX pass: the
    values of all of them and the Jacobian of their concatenation in
    (δx, δu)."""
    ndx = jspace.ndx
    xj, uj = jnp.asarray(x), jnp.asarray(u)
    f = lambda z: jnp.concatenate([jr.value(jspace.integrate(xj, z[:ndx]), uj + z[ndx:])
                                   for jr, _ in pairs.values()])
    jv, J = jax.jit(lambda z: (f(z), jax.jacfwd(f)(z)))(jnp.zeros(ndx + len(u)))
    off = 0
    for what, (_, tr) in pairs.items():
        v = tr.value(t64(x), t64(u))
        rows = slice(off, off + v.shape[0])
        off += v.shape[0]
        close(v, jv[rows], TOL, f"{what} value")
        close(tr.jac_x(tspace, t64(x), t64(u)), J[rows, :ndx], TOL, f"{what} jac_x")
        close(tr.jac_u(tspace, t64(x), t64(u)), J[rows, ndx:], TOL, f"{what} jac_u")
    assert off == jv.shape[0]


def _contact_residuals(robot, jact, tact):
    """name → (JAX residual, port residual) on the first contact of the
    robot: the force residual and the friction cone (quadruped, point
    contacts, the second foot inactive) or the wrench cone (humanoid,
    soles); ``jact``/``tact`` the actuation matrices."""
    jm, tm, q0, feet = _standing(robot)
    active = [1.0, 0.0, 1.0, 1.0] if robot == "quadruped" else None
    jc, tc = _contacts(jm, tm, q0, feet, active)
    name, dim = feet[0]
    J = dict(model=jm, actuation=jact, contacts=jc, contact_name=name)
    T = dict(model=tm, actuation=tact, contacts=tc, contact_name=name)
    fref = np.linspace(-1.0, 2.0, dim)
    out = {"force": (JFK.ContactForceResidual(fref=jnp.asarray(fref), **J),
                     TFK.ContactForceResidual(fref=t64(fref), **T))}
    if dim == 3:
        out["friction_cone"] = (JFK.MultibodyFrictionConeResidual(mu=jnp.asarray(0.7), **J),
                                TFK.MultibodyFrictionConeResidual(mu=t64(0.7), **T))
    else:
        out["wrench_cone"] = (
            JFK.MultibodyWrenchConeResidual(Acone=JFK.wrench_cone_matrix(0.7, 0.1, 0.05), **J),
            TFK.MultibodyWrenchConeResidual(
                Acone=TFK.wrench_cone_matrix(0.7, 0.1, 0.05, device="cpu"), **T))
    return out


def check_contact_residuals(robot):
    """The robot's contact residuals (``_contact_residuals``) at a state
    near its standing posture against one compiled JAX pass."""
    jm, tm, q0, _ = _standing(robot)
    res = _contact_residuals(robot, JDM.floating_base_actuation(jm),
                             TDM.floating_base_actuation(tm, device="cpu"))
    rng = np.random.default_rng(2)
    jspace = JMB.MultibodyPhaseSpace(jm)
    x = np.asarray(jspace.integrate(jnp.concatenate([jnp.asarray(q0), jnp.zeros(jm.nv)]),
                                    jnp.asarray(0.1 * rng.standard_normal(2 * jm.nv))))
    u = rng.standard_normal(jm.nv - 6)
    _check_residuals(res, jspace, TMB.MultibodyPhaseSpace(tm), x, u)


@pytest.mark.parametrize("robot", ["quadruped"])
def test_contact_residuals_match_jax(robot):
    """The force residual and the friction cone on the quadruped's point
    contacts (the humanoid's sole residuals: ``test_torch_contact_humanoid.py``):
    they read λ from the implicit contact step, so their Jacobians in x and
    u are λ's, whose derivative only the acceleration output had had
    checked before."""
    check_contact_residuals(robot)


def test_wrench_cone_matrix_matches_jax():
    for mu, hl, hw in ((0.7, 0.1, 0.05), (0.4, 0.12, 0.07)):
        np.testing.assert_array_equal(
            TFK.wrench_cone_matrix(mu, hl, hw, device="cpu").numpy(),
            np.asarray(JFK.wrench_cone_matrix(mu, hl, hw)))


def _cmap(rng, nk):
    poses = rng.standard_normal((nk, 3))
    active = (np.arange(nk) % 3 != 1).astype(float)
    return (JCD.ContactMap.create(tuple(f"c{k}" for k in range(nk)), jnp.asarray(poses),
                                  active=jnp.asarray(active)),
            TCD.ContactMap.create(tuple(f"c{k}" for k in range(nk)), t64(poses),
                                  active=t64(active)))


CENTROIDAL = ["com", "linear_momentum", "angular_momentum", "acceleration3",
              "acceleration6", "angular_acceleration3", "angular_acceleration6",
              "friction_cone", "wrench_cone", "wrapper"]


def _centroidal_residual(name, rng):
    """(JAX residual, port residual, nx, nu)."""
    nk = 3
    jcm, tcm = _cmap(rng, nk)
    ref = rng.standard_normal(3)
    m, g = 40.0, np.array([0.0, 0.0, -9.81])
    if name in ("com", "linear_momentum", "angular_momentum"):
        cls = {"com": "CentroidalCoMResidual", "linear_momentum": "LinearMomentumResidual",
               "angular_momentum": "AngularMomentumResidual"}[name]
        return (getattr(JFC, cls)(ref=jnp.asarray(ref)), getattr(TFC, cls)(ref=t64(ref)),
                9, 3 * nk)
    if name.startswith(("acceleration", "angular_acceleration")):
        fs = int(name[-1])
        cls = ("CentroidalAccelerationResidual" if name.startswith("acc")
               else "AngularAccelerationResidual")
        return (getattr(JFC, cls)(contact_map=jcm, mass=jnp.asarray(m), gravity=jnp.asarray(g),
                                  force_size=fs),
                getattr(TFC, cls)(contact_map=tcm, mass=t64(m), gravity=t64(g), force_size=fs),
                9, fs * nk)
    if name == "friction_cone":
        return (JFC.CentroidalFrictionConeResidual(mu=jnp.asarray(0.7), epsilon=jnp.asarray(1e-9),
                                                   k=1),
                TFC.CentroidalFrictionConeResidual(mu=t64(0.7), epsilon=t64(1e-9), k=1), 9, 3 * nk)
    if name == "wrench_cone":
        return (JFC.CentroidalWrenchConeResidual(mu=0.6, hL=0.12, hW=0.07, k=1),
                TFC.CentroidalWrenchConeResidual(mu=0.6, hL=0.12, hW=0.07, k=1), 9, 6 * nk)
    inner_j = JFC.AngularAccelerationResidual(contact_map=jcm, mass=jnp.asarray(m),
                                              gravity=jnp.asarray(g), force_size=3)
    inner_t = TFC.AngularAccelerationResidual(contact_map=tcm, mass=t64(m), gravity=t64(g),
                                              force_size=3)
    return (JFC.CentroidalWrapperResidual(wrapped=inner_j),
            TFC.CentroidalWrapperResidual(wrapped=inner_t), 9 + 3 * nk, 2)


@pytest.mark.parametrize("name", CENTROIDAL)
def test_centroidal_residuals_match_jax(name):
    rng = np.random.default_rng(3)
    jr, tr, nx, nu = _centroidal_residual(name, rng)
    x, u = rng.standard_normal(nx), rng.standard_normal(nu)
    _check_residuals({name: (jr, tr)}, JVec(nx), TVec(nx), x, u)


@pytest.mark.parametrize("variant", ["centroidal3", "centroidal6", "continuous3",
                                     "continuous6"])
def test_centroidal_odes_match_jax(variant):
    """xdot and its Jacobians in x and u (the ODE's own jacfwd)."""
    rng = np.random.default_rng(4)
    nk, fs = 2, int(variant[-1])
    jcm, tcm = _cmap(rng, nk)
    kw_j = dict(contact_map=jcm, mass=jnp.asarray(40.0), gravity=jnp.asarray([0.0, 0.0, -9.81]),
                force_size=fs)
    kw_t = dict(contact_map=tcm, mass=t64(40.0), gravity=t64([0.0, 0.0, -9.81]), force_size=fs)
    if variant.startswith("centroidal"):
        jo, to, nx = JCD.CentroidalFwdDynamics(**kw_j), TCD.CentroidalFwdDynamics(**kw_t), 9
    else:
        jo, to = (JCD.ContinuousCentroidalFwdDynamics(**kw_j),
                  TCD.ContinuousCentroidalFwdDynamics(**kw_t))
        nx = 9 + nk * fs
    nu = nk * fs
    x, u = rng.standard_normal(nx), rng.standard_normal(nu)
    jfn = jax.jit(lambda x, u: (jo.xdot(None, x, u), jax.jacfwd(jo.xdot, 1)(None, x, u),
                                jax.jacfwd(jo.xdot, 2)(None, x, u)))
    jv, jjx, jju = jfn(jnp.asarray(x), jnp.asarray(u))
    tx, tu = t64(x), t64(u)
    close(to.xdot(None, tx, tu), jv, TOL, "xdot")
    close(torch.func.jacfwd(lambda xx: to.xdot(None, xx, tu))(tx), jjx, TOL, "d xdot / dx")
    close(torch.func.jacfwd(lambda uu: to.xdot(None, tx, uu))(tu), jju, TOL, "d xdot / du")


# ---------------------------------------------------------------------------
# the kinodynamic model through the problem's derivative pass
# ---------------------------------------------------------------------------


def test_jax_public_names_are_exported_by_the_port():
    """Every name of the JAX package's ``functions``, ``dynamics`` and
    ``multibody`` ``__all__`` is exported by the port's subpackage of the
    same name (the centroidal ODEs live in ``dynamics.centroidal`` in both
    packages), and ``io`` has both spec functions."""
    import importlib

    for sub in ("functions", "dynamics", "multibody"):
        jmod = importlib.import_module(f"aligator_tpu.{sub}")
        tmod = importlib.import_module(f"aligator_tpu_torch.{sub}")
        missing = [n for n in jmod.__all__ if not hasattr(tmod, n)]
        assert not missing, f"{sub}: {missing}"
    for name in ("ContactMap", "centroidal_xdot", "CentroidalFwdDynamics",
                 "ContinuousCentroidalFwdDynamics"):
        assert hasattr(TCD, name)
    assert hasattr(TDM, "KinodynamicsFwdDynamics")
    from aligator_tpu_torch import io as tio

    assert callable(tio.problem_from_spec) and callable(tio.problem_to_spec)
