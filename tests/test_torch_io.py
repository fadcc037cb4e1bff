"""The port's problem specs (``aligator_tpu_torch.io``, slice 6) against the
JAX package's ``aligator_tpu.io`` in float64 on the CPU.

- For each branch of the schema (spaces, integrator schemes and ODEs,
  residuals, constraint sets, costs, per-stage values), the same spec
  dict through both packages' ``problem_from_spec`` gives the same
  problem: equal horizon, widths, constraint stacks and x0, every leaf
  equal to the JAX leaf (the port's with its batch axis of 1), to
  1e-13·max(1, |·|); and one ``compute_derivatives`` pass agrees with the
  JAX pass to 1e-12. For the residuals that read λ from the contact
  dynamics and for the kinodynamic ODE, the port's spec-built problem has
  the derivative pass of the same problem built by hand in the port
  (1e-12): their JAX passes, a minute or two of compilation each, are
  held to the port's in ``test_torch_contact_centroidal.py``.
- The port's ``problem_to_spec`` equals the JAX package's on the same
  example problem after a JSON round trip, and the port's spec of the
  solo jump rebuilds it: the leaves are equal and the derivative passes
  agree to 1e-12.
- Exporting a ``CustomODE``, and a per-stage value in x0, raise in both.
- The implicit midpoint rule over the multibody ODEs (free and contact
  dynamics): the rollout, a values-only evaluation as the solvers' line
  searches run it, equals the JAX rollout to 1e-12, and the free
  dynamics' spec through the derivative and evaluation pass above.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligator_tpu import io as jio

from aligator_tpu_torch import io as tio
from aligator_tpu_torch.convert import MULTIBODY_LEAVES
from aligator_tpu_torch.manifolds.base import Manifold
from aligator_tpu_torch.multibody.model import MultibodyModel

from test_torch_contact_centroidal import check_derivs, close, t64
from test_torch_examples import same_problem

torch.set_num_threads(1)

LEAF, DERIV = 1e-13, 1e-12


def same_tree(j, t, batch: bool, path="problem"):
    """The port object ``t`` holds the JAX object ``j``'s classes, static
    fields and leaves (``batch``: the port's leaves carry a leading batch
    axis of 1)."""
    if isinstance(t, torch.Tensor):
        a = t.detach().cpu().numpy()
        if batch:
            assert a.shape[:1] == (1,), (path, a.shape)
            a = a[0]
        close(a, np.asarray(j), LEAF, path)
    elif isinstance(t, Manifold):
        assert (type(t).__name__, t.nx, t.ndx) == (type(j).__name__, j.nx, j.ndx), path
    elif dataclasses.is_dataclass(t) and not isinstance(t, type):
        assert type(t).__name__ == type(j).__name__, (path, type(t), type(j))
        for f in dataclasses.fields(t):
            if f.name.startswith("_") or (isinstance(t, MultibodyModel) and f.name not in
                                          MULTIBODY_LEAVES + ("joints", "parents", "frames")):
                continue
            same_tree(getattr(j, f.name), getattr(t, f.name), batch, f"{path}.{f.name}")
    elif isinstance(t, (tuple, list)):
        assert len(t) == len(j), path
        for k, (jj, tt) in enumerate(zip(j, t)):
            same_tree(jj, tt, batch, f"{path}[{k}]")
    elif callable(t):
        assert callable(j), path
    else:
        assert t == j, (path, t, j)


def same_built(jp, tp):
    """``same_problem`` and every leaf equal."""
    same_problem(jp, tp)
    for name in ("dynamics", "cost", "constraints"):
        same_tree(getattr(jp, name), getattr(tp, name), True, name)
    for name in ("term_cost", "term_constraints"):
        same_tree(getattr(jp, name), getattr(tp, name), True, name)


def trajectories(jp, seed=0, batch=2):
    """(xs, us) numpy: ``batch`` trajectories around x0, each state
    x0 ⊕ 0.1·N(0, 1), controls N(0, 1)."""
    rng = np.random.default_rng(seed)
    space, N = jp.space, jp.nsteps
    integ = jax.jit(space.integrate)
    x0 = jnp.asarray(jp.x0)
    xs = np.stack([np.stack([np.asarray(integ(x0, jnp.asarray(
        0.1 * rng.standard_normal(space.ndx)))) for _ in range(N + 1)]) for _ in range(batch)])
    return xs, rng.standard_normal((batch, N, jp.nu))


def both(spec):
    """The spec (as JSON) through both packages' ``problem_from_spec``."""
    text = json.dumps(spec)
    return jio.problem_from_spec(text), tio.problem_from_spec(text, device="cpu")


# ---------------------------------------------------------------------------
# specs, one per group of branches
# ---------------------------------------------------------------------------


def _eye(n, s=1.0):
    return (s * np.eye(n)).tolist()


def linear_spec():
    """vector space, linear_discrete, quadratic (with N), quad_state, and
    constraints on every set: box on control_error, equality on a linear
    residual, l1 on state_error, negative_orthant at the end."""
    rng = np.random.default_rng(0)
    return {
        "space": {"type": "vector", "dim": 3}, "nu": 2, "nsteps": 6, "x0": [0.2, 0.3, -0.1],
        "dynamics": {"type": "linear_discrete", "A": (np.eye(3) + 0.1 * rng.standard_normal(
            (3, 3))).tolist(), "B": rng.standard_normal((3, 2)).tolist(), "c": [0.0, 0.0, 0.1]},
        "cost": {"type": "quadratic", "Wx": _eye(3, 0.1), "Wu": _eye(2, 0.01),
                 "N": (0.01 * rng.standard_normal((3, 2))).tolist()},
        "term_cost": {"type": "quad_state", "target": [0.0, 0.1, 0.0], "W": _eye(3)},
        "constraints": [
            {"residual": {"type": "control_error", "target": [0.0, 0.0]},
             "set": {"type": "box", "lower": [-0.2, -0.3], "upper": [0.2, 0.3]}},
            {"residual": {"type": "linear", "A": rng.standard_normal((1, 3)).tolist(),
                          "B": rng.standard_normal((1, 2)).tolist(), "c": [0.05]},
             "set": {"type": "equality"}, "nr": 1},
            {"residual": {"type": "state_error", "target": {"per_stage": (
                0.1 * rng.standard_normal((6, 3))).tolist()}},
             "set": {"type": "l1", "scale": 0.5}},
        ],
        "term_constraints": [
            {"residual": {"type": "state_error", "target": [1.0, 1.0, 1.0]},
             "set": {"type": "negative_orthant"}, "nr": 3}],
    }


def scheme_spec(scheme):
    """A linear ODE on R⁴ (a phase space (q, v) ∈ R² × R², for the
    semi-implicit scheme) through each integrator scheme."""
    return {
        "space": {"type": "vector", "dim": 4}, "nu": 2, "nsteps": 6,
        "x0": [0.2, 0.3, -0.1, 0.05],
        "dynamics": {"type": "integrator", "scheme": scheme, "dt": 0.1,
                     "ode": {"type": "linear", "A": (np.eye(4, k=2) - 0.5 * np.eye(4)).tolist(),
                             "B": [[0.0, 0.0], [0.0, 0.0], [1.0, 0.0], [0.5, 0.5]],
                             "c": [0.0, 0.0, 0.0, 0.1]}},
        "cost": {"type": "quad_control", "target": [0.1, 0.0], "W": _eye(2)},
        "term_cost": {"type": "quad_state", "target": [0.0, 0.1, 0.0, 0.0], "W": _eye(4)},
    }


def lie_spec(space, per_stage=True):
    """so2, so3, se2, se3 spaces: quad_state costs (with a per-stage target
    and control weight unless ``per_stage`` is false) and a linear ODE
    (ẋ ∈ T_x M of width ndx, read off x's nx coordinates); se2 the unicycle
    ODE (the SE(2) car) instead."""
    nx, ndx = {"so2": (2, 1), "so3": (4, 3), "se2": (4, 3), "se3": (7, 6)}[space]
    x0 = {"so2": [1.0, 0.0], "so3": [0.0, 0.0, 0.0, 1.0], "se2": [0.7, -0.1, 1.0, 0.0],
          "se3": [0.1, 0.2, 0.3, 0.0, 0.0, 0.0, 1.0]}[space]
    rng = np.random.default_rng(1)
    N = 5
    targets = [x0] * N
    ode = ({"type": "unicycle"} if space == "se2" else
           {"type": "linear", "A": (0.1 * rng.standard_normal((ndx, nx))).tolist(),
            "B": rng.standard_normal((ndx, 2)).tolist(), "c": [0.0] * ndx})
    return {
        "space": {"type": space}, "nu": 2, "nsteps": N, "x0": x0,
        "dynamics": {"type": "integrator", "scheme": "euler", "dt": 0.05, "ode": ode},
        "cost": {"type": "stack", "components": [
            [{"type": "quad_state", "target": {"per_stage": targets} if per_stage else x0,
              "W": _eye(ndx, 0.1)}, 1.0],
            [{"type": "quad_control", "target": [0.0, 0.0], "W": _eye(2, 0.01)},
             {"per_stage": np.linspace(0.5, 1.0, N).tolist()} if per_stage else 0.75]]},
        "term_cost": {"type": "quad_state", "target": x0, "W": _eye(ndx)},
    }


def centroidal_spec(kind, fs):
    """The centroidal ODEs, a per-stage contact schedule, and every
    centroidal residual (CoM, momenta, accelerations, cones; the wrench
    cone and the wrapper on 6D wrenches)."""
    N, nk = 6, 2
    nu = nk * fs
    nx = 9 if kind == "centroidal" else 9 + nu
    active = np.ones((N, nk))
    active[2:4, 1] = 0.0
    cmap = {"names": ["lf", "rf"], "poses": [[0.0, 0.15, 0.0], [0.0, -0.15, 0.0]],
            "active": {"per_stage": active.tolist()}}
    x0 = [0.0, 0.0, 0.8] + [0.0] * (nx - 3)
    quad = lambda res, n, w=1.0: [{"type": "quad_residual", "residual": res, "W": _eye(n, w)},
                                  1.0]
    cone = ({"type": "centroidal_friction_cone", "mu": 0.7, "epsilon": 1e-9, "k": 1}, 2)
    if fs == 6:
        cone = ({"type": "centroidal_wrench_cone", "mu": 0.6, "half_length": 0.1,
                 "half_width": 0.05, "k": 1}, 17)
    return {
        "space": {"type": "vector", "dim": nx}, "nu": nu, "nsteps": N, "x0": x0,
        "dynamics": {"type": "integrator", "scheme": "euler", "dt": 0.05,
                     "ode": {"type": kind, "mass": 40.0, "gravity": [0.0, 0.0, -9.81],
                             "force_size": fs, "contact_map": cmap}},
        "cost": {"type": "stack", "components": [
            quad({"type": "centroidal_com", "ref": [0.05, 0.0, 0.78]}, 3, 10.0),
            quad({"type": "linear_momentum", "ref": [0.0] * 3}, 3, 0.1),
            quad({"type": "angular_momentum", "ref": [0.0] * 3}, 3, 0.1),
            quad({"type": "centroidal_acceleration", "mass": 40.0,
                  "gravity": [0.0, 0.0, -9.81], "contact_map": cmap, "force_size": fs}, 3),
            [{"type": "quad_control", "target": ([0.0, 0.0, 196.2] + [0.0] * (fs - 3)) * nk,
              "W": _eye(nu, 1e-4)}, 1.0]]},
        "term_cost": {"type": "quad_residual",
                      "residual": {"type": "centroidal_com", "ref": [0.05, 0.0, 0.78]},
                      "W": _eye(3, 100.0)},
        "constraints": [{"residual": {"type": "centroidal_friction_cone", "mu": 0.7,
                                      "epsilon": 1e-9, "k": 0}, "set":
                         {"type": "negative_orthant"}, "nr": 2},
                        {"residual": cone[0], "set": {"type": "negative_orthant"},
                         "nr": cone[1]}],
    }


def serial_chain_spec():
    """serial_chain model, multibody_phase space, multibody_free_fwd, and
    the frame residuals on the state: translation, placement, velocity,
    fly-high, CoM, CoM velocity, centroidal momentum; a collision
    constraint (sphere on the tool against a world box)."""
    N, nv = 4, 3
    x0 = [0.1, -0.2, 0.3] + [0.0] * nv
    quad = lambda res, n: [{"type": "quad_residual", "residual": res, "W": _eye(n)}, 0.5]
    return {
        "model": {"type": "serial_chain", "n_links": 3},
        "space": {"type": "multibody_phase"}, "nu": nv, "nsteps": N, "x0": x0,
        "dynamics": {"type": "integrator", "scheme": "semi_euler", "dt": 0.02,
                     "ode": {"type": "multibody_free_fwd", "actuation": "full"}},
        "cost": {"type": "stack", "components": [
            [{"type": "quad_state", "target": x0, "W": _eye(2 * nv, 1e-2)}, 1.0],
            [{"type": "quad_control", "target": [0.0] * nv, "W": _eye(nv, 1e-3)}, 1.0],
            quad({"type": "frame_translation", "frame": "tool0",
                  "ref": {"per_stage": [[0.3, 0.1, 0.5 + 0.01 * k] for k in range(N)]}}, 3),
            quad({"type": "frame_placement", "frame": "tool0", "ref_R": _eye(3),
                  "ref_p": [0.3, 0.1, 0.5]}, 6),
            quad({"type": "frame_velocity", "frame": "tool0", "ref": [0.0] * 6}, 6),
            quad({"type": "fly_high", "frame": "tool0", "slope": 2.0}, 2),
            quad({"type": "com_translation", "ref": [0.0, 0.0, 0.3]}, 3),
            quad({"type": "com_velocity", "ref": [0.0] * 3}, 3),
            quad({"type": "centroidal_momentum", "ref": [0.0] * 6}, 6)]},
        "term_cost": {"type": "quad_residual", "residual": {
            "type": "frame_translation", "frame": "tool0", "ref": [0.4, 0.3, 0.4]},
            "W": _eye(3, 100.0)},
        "constraints": [{"residual": {"type": "frame_collision",
                                      "geom1": {"frame": "tool0", "kind": "sphere",
                                                "radius": 0.05},
                                      "geom2": {"frame": None, "kind": "box",
                                                "half_extents": [0.1, 0.2, 0.1],
                                                "offset_p": [0.3, 0.2, 0.4]}},
                         "set": {"type": "negative_orthant"}, "nr": 1}],
    }


def midpoint_multibody_spec(contact):
    """The implicit midpoint rule over a multibody ODE: the 3-link chain's
    free dynamics, or its contact dynamics with the tool held at its x0
    placement by a 3D point contact. dt = 0.1 and a large start velocity
    make ẋ vary enough over the step that the Newton solve needs the
    derivative of ẋ in x: without it (a chord iteration) its 8 steps stop
    far above rounding."""
    N, nv = 4, 3
    q0 = [0.4, -0.6, 0.9]
    x0 = q0 + [2.0, -1.5, 1.0]
    ode = {"type": "multibody_free_fwd", "actuation": "full"}
    if contact:
        ode = {"type": "multibody_constraint_fwd", "actuation": "full",
               "contacts": {"frames": [["tool0", 3]], "kp": 10.0, "kd": 6.0, "anchor_q": q0}}
    return {
        "model": {"type": "serial_chain", "n_links": 3},
        "space": {"type": "multibody_phase"}, "nu": nv, "nsteps": N, "x0": x0,
        "dynamics": {"type": "integrator", "scheme": "midpoint", "dt": 0.1, "ode": ode},
        "cost": {"type": "quad_control", "target": [0.0] * nv, "W": _eye(nv, 1e-3)},
        "term_cost": {"type": "quad_state", "target": x0, "W": _eye(2 * nv)},
    }


def humanoid_contact_spec():
    """The humanoid (``load_talos_like``) with the kinodynamic ODE and a
    per-stage contact schedule, the centroidal-momentum-rate cost, and
    the force, friction-cone and wrench-cone residuals of a 6D sole
    contact as constraints (their torques τ = u: nu = nv = 28)."""
    from aligator_tpu.multibody.model import build_humanoid, humanoid_half_sitting

    q0 = np.asarray(humanoid_half_sitting(build_humanoid()))
    nv, nk, fs, N = 28, 2, 3, 3
    nu = nk * fs + nv - 6
    x0 = np.concatenate([q0, np.zeros(nv)]).tolist()
    active = np.ones((N, nk))
    active[1, 1] = 0.0
    contacts = {"frames": [["left_sole", 6], ["right_sole", 6]], "kp": 10.0, "kd": 6.0,
                "anchor_q": q0.tolist()}
    cres = lambda t, **kw: {"residual": {"type": t, "contacts": contacts,
                                         "actuation": "full", "contact": "left_sole",
                                         **kw}}
    return {
        "model": {"type": "humanoid"}, "space": {"type": "multibody_phase"}, "nu": nu,
        "nsteps": N, "x0": x0,
        "dynamics": {"type": "integrator", "scheme": "euler", "dt": 0.05,
                     "ode": {"type": "kinodynamics", "frames": ["left_sole", "right_sole"],
                             "force_size": fs, "active": {"per_stage": active.tolist()}}},
        "cost": {"type": "stack", "components": [
            [{"type": "quad_control", "target": [0.0] * nu, "W": _eye(nu, 1e-3)}, 1.0],
            [{"type": "quad_residual", "residual": {
                "type": "centroidal_momentum_derivative", "frames": ["left_sole", "right_sole"],
                "active": [1.0, 1.0], "force_size": fs}, "W": _eye(6, 1e-2)}, 1.0]]},
        "term_cost": {"type": "quad_state", "target": x0, "W": _eye(2 * nv)},
        "constraints": [
            {**cres("contact_force", fref=[0.0, 0.0, 300.0, 0.0, 0.0, 0.0]),
             "set": {"type": "equality"}, "nr": 6},
            {**cres("friction_cone", mu=0.6), "set": {"type": "negative_orthant"}, "nr": 2},
            {**cres("wrench_cone", mu=0.7, half_length=0.1, half_width=0.05),
             "set": {"type": "negative_orthant"}, "nr": 17}],
    }


SPECS = {
    "linear": linear_spec,
    **{f"scheme_{s}": (lambda s=s: scheme_spec(s))
       for s in ("euler", "semi_euler", "rk2", "rk4", "midpoint")},
    **{f"space_{s}": (lambda s=s: lie_spec(s)) for s in ("so2", "so3", "se3")},
    # the JAX package cannot build the unicycle with per-stage values (below)
    "space_se2_unicycle": lambda: lie_spec("se2", per_stage=False),
    "centroidal": lambda: centroidal_spec("centroidal", 3),
    "continuous_centroidal_6d": lambda: centroidal_spec("continuous_centroidal", 6),
    "serial_chain_frames": serial_chain_spec,
    "midpoint_multibody_free": lambda: midpoint_multibody_spec(False),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_spec_builds_the_same_problem_in_both_packages(name):
    jp, tp = both(SPECS[name]())
    same_built(jp, tp)
    xs, us = trajectories(jp)
    err = check_derivs(jp, tp, xs, us, DERIV, name)
    print(f"{name}: derivative pass max rel err {err:.3e}")


@pytest.mark.parametrize("contact", [False, True], ids=["free", "contact"])
def test_midpoint_multibody_rollout_matches_jax(contact):
    """The rollout (values alone, as the solvers' line search runs it)
    through the implicit midpoint rule over the multibody ODEs equals the
    JAX rollout: the Newton solve inside it keeps the tangent of ẋ,
    1e-12·max(1, |·|)."""
    from aligator_tpu.problem import rollout as jroll

    from aligator_tpu_torch.problem import rollout as troll

    jp, tp = both(midpoint_multibody_spec(contact))
    us = 0.5 * np.random.default_rng(1).standard_normal((2, jp.nsteps, jp.nu))
    xs_t = troll(tp.replace_x0(tp.x0.expand(2, -1)), tp.x0.expand(2, -1), t64(us))
    jr = jax.jit(jroll)
    for b in range(2):
        close(xs_t[b], jr(jp, jnp.asarray(jp.x0), jnp.asarray(us[b])), DERIV, f"xs[{b}]")


def _hand_built_humanoid_contact_problem():
    """The problem of ``humanoid_contact_spec`` built by hand in the port."""
    from aligator_tpu_torch import constraints as TS
    from aligator_tpu_torch import costs as TC
    from aligator_tpu_torch.dynamics import EulerIntegrator
    from aligator_tpu_torch.dynamics.multibody import KinodynamicsFwdDynamics, full_actuation
    from aligator_tpu_torch.functions import contact as FK
    from aligator_tpu_torch.functions.frames import CentroidalMomentumDerivativeResidual
    from aligator_tpu_torch.multibody import anchor_at_configuration, make_contact_set
    from aligator_tpu_torch.multibody.model import humanoid_half_sitting
    from aligator_tpu_torch.multibody.spaces import MultibodyPhaseSpace
    from aligator_tpu_torch.multibody.urdf import load_talos_like
    from aligator_tpu_torch.problem import build_problem
    from aligator_tpu_torch.utils.tree import shared

    model = load_talos_like(device="cpu")
    space = MultibodyPhaseSpace(model)
    q0 = humanoid_half_sitting(model)
    nv, N = model.nv, 3
    nu = 6 + nv - 6
    x0 = torch.cat([q0, q0.new_zeros(nv)])
    fids = (model.frame_id("left_sole"), model.frame_id("right_sole"))
    active = torch.ones(N, 2, dtype=torch.float64)
    active[1, 1] = 0.0
    ode = KinodynamicsFwdDynamics(model=model, active=active[0], frame_ids=fids, force_size=3)
    cs = anchor_at_configuration(model, make_contact_set(
        model, (("left_sole", 6), ("right_sole", 6)), kp=10.0, kd=6.0, device="cpu"), q0)
    kw = dict(model=model, actuation=full_actuation(model, device="cpu"), contacts=cs,
              contact_name="left_sole")
    eye = lambda n, s=1.0: s * torch.eye(n, dtype=torch.float64)
    cost = TC.CostStack.create(
        (TC.QuadraticControlCost(torch.zeros(nu, dtype=torch.float64), eye(nu, 1e-3)), 1.0),
        (TC.QuadraticResidualCost(residual=CentroidalMomentumDerivativeResidual(
            model=model, active=torch.ones(2, dtype=torch.float64), frame_ids=fids,
            force_size=3), W=eye(6, 1e-2)), 1.0))
    cstrs = ((FK.ContactForceResidual(fref=t64([0.0, 0.0, 300.0, 0.0, 0.0, 0.0]), **kw),
              TS.EqualityConstraint(), 6),
             (FK.MultibodyFrictionConeResidual(mu=t64(0.6), **kw), TS.NegativeOrthant(), 2),
             (FK.MultibodyWrenchConeResidual(Acone=FK.wrench_cone_matrix(0.7, 0.1, 0.05,
                                                                         device="cpu"), **kw),
              TS.NegativeOrthant(), 17))
    p = build_problem(space, nu, N, x0, shared(EulerIntegrator(ode=ode, dt=t64(0.05))),
                      shared(cost), shared(TC.QuadraticStateCost(space, x0, eye(2 * nv))),
                      constraints=tuple((shared(f), st, n) for f, st, n in cstrs),
                      device="cpu", dtype=torch.float64)
    dyn = p.dynamics
    return p.replace(dynamics=dataclasses.replace(dyn, ode=dataclasses.replace(
        dyn.ode, active=active[None])))


def test_contact_and_kinodynamic_spec_builds_the_same_problem():
    """The humanoid spec with the kinodynamic ODE and the sole's contact
    residuals: the port's and the JAX package's builds hold the same
    leaves, and the port's build has the derivative pass of the same
    problem built by hand in the port (1e-12). (The JAX pass of these
    residuals and this ODE is held to the port's in
    ``test_torch_contact_centroidal.py``.)"""
    from aligator_tpu_torch.problem import compute_derivatives

    jp, tp = both(humanoid_contact_spec())
    same_built(jp, tp)
    hand = _hand_built_humanoid_contact_problem()
    same_problem(jp, hand)
    xs, us = trajectories(jp, batch=1)
    b = lambda p: p.replace_x0(p.x0.expand(1, -1))
    d1, d2 = compute_derivatives(b(hand), t64(xs), t64(us)), compute_derivatives(
        b(tp), t64(xs), t64(us))
    for name in d1._fields:
        close(getattr(d2, name), getattr(d1, name).numpy(), DERIV, name)


def test_unicycle_with_per_stage_values_is_reference_behaviour():
    """The JAX ``problem_from_spec`` raises on a spec that holds the
    unicycle ODE and any per-stage value: it stamps the full parse into
    the tiled one with ``jax.tree.map``, whose two ``CustomODE``s hold
    different closures as static data. The port's stamp maps the leaves
    only: it builds the problem, equal (its per-stage targets all equal
    x0, its weights a ramp) to the JAX build of the same spec with stage
    0's values, apart from the ramp."""
    spec = lie_spec("se2")
    with pytest.raises(ValueError, match="Mismatch custom dataclass node data"):
        jio.problem_from_spec(json.dumps(spec))
    tp = tio.problem_from_spec(json.dumps(spec), device="cpu")
    jp = jio.problem_from_spec(json.dumps(lie_spec("se2", per_stage=False)))
    same_tree(jp.dynamics, tp.dynamics, True, "dynamics")
    same_tree(jp.cost.components, tp.cost.components, True, "cost")
    np.testing.assert_array_equal(tp.cost.weights[1][0].numpy(), np.linspace(0.5, 1.0, 5))


def test_per_stage_values_where_they_are_never_stamped_raise():
    spec = linear_spec()
    spec["x0"] = {"per_stage": [spec["x0"]] * spec["nsteps"]}
    for pkg, kw in ((jio, {}), (tio, {"device": "cpu"})):
        with pytest.raises(ValueError, match="per_stage"):
            pkg.problem_from_spec(spec, **kw)
    spec = linear_spec()
    spec["term_cost"]["target"] = {"per_stage": [[0.0] * 3] * spec["nsteps"]}
    with pytest.raises(ValueError, match="per_stage"):
        tio.problem_from_spec(spec, device="cpu")


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def _numbers(a):
    """``a`` as a float array if it is a number or a nested list of them."""
    try:
        return np.asarray(a, dtype=np.float64)
    except (TypeError, ValueError):
        return None


def same_spec(a, b, path="spec"):
    """Two specs equal, numbers to 1e-12·max(1, |·|)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            same_spec(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, float, int)) and not isinstance(a, bool) and \
            _numbers(a) is not None:
        close(_numbers(b), _numbers(a), 1e-12, path)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            same_spec(x, y, f"{path}[{k}]")
    else:
        assert a == b, (path, a, b)


def _examples(name):
    """(JAX problem, port problem, model spec) of an example."""
    if name == "lqr":
        from examples.lqr import create_lqr_problem as J

        from aligator_tpu_torch.examples.lqr import create_lqr_problem as T

        return J(True, False), T(True, False, device="cpu"), None
    if name == "centroidal":
        from examples.centroidal import create_centroidal_problem as J

        from aligator_tpu_torch.examples.centroidal import create_centroidal_problem as T

        return J(), T(device="cpu"), None
    if name == "ur5_reach":
        from examples.ur5_reach import create_ur5_reach_problem as J

        from aligator_tpu_torch.examples.ur5_reach import create_ur5_reach_problem as T

        return J()[0], T(device="cpu")[0], {"type": "serial_chain", "n_links": 6}
    if name == "talos_walk":
        from examples.talos_walk import create_walk_problem as J

        from aligator_tpu_torch.examples.talos_walk import create_walk_problem as T

        return J(2, 1)[0], T(2, 1, device="cpu")[0], {"type": "humanoid"}
    if name == "humanoid_squat":
        from examples.humanoid_squat import create_squat_problem as J

        from aligator_tpu_torch.examples.humanoid_squat import create_squat_problem as T

        return J()[0], T(device="cpu")[0], {"type": "humanoid"}
    from examples.solo_jump import create_jump_problem as J

    from aligator_tpu_torch.examples.solo_jump import create_jump_problem as T

    return J()[0], T(device="cpu")[0], quadruped_model_spec()


def quadruped_model_spec():
    """The quadruped as a URDF document model spec (the schema has no
    quadruped type; both packages' ``load_urdf`` read a document)."""
    from aligator_tpu_torch.multibody.model import build_quadruped
    from aligator_tpu_torch.multibody.urdf import model_to_urdf

    return {"type": "urdf", "path": model_to_urdf(build_quadruped(device="cpu"), "solo")}


@pytest.mark.parametrize("name", ["lqr", "centroidal", "ur5_reach", "talos_walk",
                                  "humanoid_squat", "solo_jump"])
def test_problem_to_spec_matches_jax(name):
    """The port's spec of an example equals the JAX package's spec of the
    same example after a JSON round trip."""
    jp, tp, model_spec = _examples(name)
    js = json.loads(json.dumps(jio.problem_to_spec(jp, model_spec=model_spec)))
    ts = json.loads(json.dumps(tio.problem_to_spec(tp, model_spec=model_spec)))
    same_spec(js, ts)


def test_solo_jump_spec_rebuilds_the_jump():
    """The port's spec of the solo jump (its per-stage contact schedule and
    landing weights, the quadruped as a URDF document) rebuilds it in the
    port, equal to the JAX package's rebuild of the same JSON, and with
    the derivative pass of the directly built jump at x0 and a seeded
    trajectory to 1e-12."""
    from aligator_tpu_torch.examples.solo_jump import create_jump_problem
    from aligator_tpu_torch.problem import compute_derivatives

    tp, model, _ = create_jump_problem(device="cpu")
    text = json.dumps(tio.problem_to_spec(tp, model_spec=quadruped_model_spec()))
    jp2, tp2 = jio.problem_from_spec(text), tio.problem_from_spec(text, device="cpu")
    same_built(jp2, tp2)
    same_problem(jp2, tp)
    np.testing.assert_array_equal(tp2.dynamics.ode.contacts.active.numpy(),
                                  tp.dynamics.ode.contacts.active.numpy())
    for w2, w in zip(tp2.cost.weights, tp.cost.weights):
        np.testing.assert_array_equal(w2.expand_as(w).numpy(), w.numpy())
    xs, us = trajectories(jp2, batch=1)
    xs = np.concatenate([np.broadcast_to(np.asarray(jp2.x0), xs.shape), xs])
    us = np.concatenate([np.zeros_like(us), us])
    b = lambda p: p.replace_x0(p.x0.expand(2, -1))
    d1 = compute_derivatives(b(tp), t64(xs), t64(us))
    d2 = compute_derivatives(b(tp2), t64(xs), t64(us))
    for name in d1._fields:
        close(getattr(d2, name), getattr(d1, name).numpy(), DERIV, name)


def test_custom_ode_export_raises_in_both():
    """The unicycle ODE builds from the schema as a ``CustomODE`` (a Python
    callable), which neither package can export."""
    jp, tp = both(lie_spec("se2", per_stage=False))
    for pkg, p in ((jio, jp), (tio, tp)):
        with pytest.raises(ValueError, match="CustomODE"):
            pkg.problem_to_spec(p)


def test_midpoint_export_raises_in_both():
    """The midpoint scheme builds from the schema, but neither exporter
    names it: ``MidpointIntegratorExplicit`` is a function returning an
    ``ImplicitToExplicit`` (ROADMAP C11)."""
    jp, tp = both(scheme_spec("midpoint"))
    for pkg, p in ((jio, jp), (tio, tp)):
        with pytest.raises(ValueError, match="cannot export dynamics ImplicitToExplicit"):
            pkg.problem_to_spec(p)

