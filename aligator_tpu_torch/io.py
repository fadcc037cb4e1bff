"""Problem specifications (port of ``aligator_tpu.io``): build a problem
from a plain dict or JSON spec, and export a problem back to one. A spec
written by the JAX package's ``problem_to_spec`` builds the same problem
here, and the other way round; arrays are nested lists.

Schema (all keys lowercase; the JAX package's, copied here):
    {"model": MODEL?,            # multibody model, referenced by space/dyn/res
     "space": {"type": "vector", "dim": 3} | {"type": "se2"} | {"type": "se3"}
            | {"type": "so2"} | {"type": "so3"}
            | {"type": "multibody_phase"},          # phase space of "model"
     "nu": 2, "nsteps": 20, "x0": [...],
     "dynamics": {"type": "linear_discrete", "A": [[..]], "B": [[..]], "c": [..]}
               | {"type": "integrator", "scheme": "euler|semi_euler|rk2|rk4|midpoint",
                  "dt": 0.01, "ode": ODE},
     "cost": COST, "term_cost": COST,
     "constraints": [{"residual": RES, "set": SET, "nr": n}, ...],
     "term_constraints": [...]}
    MODEL = {"type": "serial_chain", "n_links": 6}
          | {"type": "humanoid"}                     # load_talos_like
          | {"type": "urdf", "path": "robot.urdf" | "<robot ...>", ["free_flyer": false]}
    ODE  = {"type": "linear", "A":.., "B":.., "c":..}
         | {"type": "unicycle"}                      # the se2-car body-frame ODE
         | {"type": "multibody_free_fwd",
            "actuation": "full" | "floating_base"}   # uses "model"
         | {"type": "multibody_constraint_fwd",      # contact dynamics
            "actuation": "full" | "floating_base",
            "contacts": CONTACTS}
         | {"type": "kinodynamics", "frames": ["left_sole", ..],
            "force_size": 3|6, "active": [..]}
         | {"type": "centroidal" | "continuous_centroidal",
            "mass": m, "gravity": [0,0,-9.81], "force_size": 3|6,
            "contact_map": CMAP}
    CONTACTS = {"frames": [["left_sole", 6], ..], "kp": 100.0, "kd": 50.0,
                ["anchor_q": [..]],               # anchor placements at q
                ["anchor_R": [..], "anchor_p": [..]],
                ["active": [..] | PER_STAGE]}     # 0/1 flags
    CMAP = {"names": [..], "poses": [[..]], ["active": [..] | PER_STAGE]}
    COST = {"type": "quadratic", "Wx":.., "Wu":.., ["N":..]}
         | {"type": "quad_state", "target":.., "W":..}
         | {"type": "quad_control", "target":.., "W":..}
         | {"type": "quad_residual", "residual": RES, "W":..}
         | {"type": "stack", "components": [[COST, weight | PER_STAGE], ...]}
    RES  = {"type": "state_error", "target": [..]}
         | {"type": "control_error", "target": [..]}
         | {"type": "linear", "A":.., "B":.., "c":..}
         | {"type": "frame_translation", "frame": "tool0", "ref": [..]}
         | {"type": "frame_placement", "frame": "..", "ref_R": [[..]], "ref_p": [..]}
         | {"type": "frame_velocity", "frame": "..", "ref": [..6..]}
         | {"type": "fly_high", "frame": "..", "slope": s}
         | {"type": "com_translation", "ref": [..3..]}
         | {"type": "com_velocity", "ref": [..3..]}
         | {"type": "centroidal_momentum", "ref": [..6..]}
         | {"type": "centroidal_momentum_derivative", "frames": [..],
            "active": [..], "force_size": 3|6}
         | {"type": "contact_force", "contacts": CONTACTS, "actuation": "..",
            "contact": "left_sole", "fref": [..]}
         | {"type": "friction_cone", "contacts": CONTACTS, "actuation": "..",
            "contact": "..", "mu": 0.7}
         | {"type": "wrench_cone", "contacts": CONTACTS, "actuation": "..",
            "contact": "..", "mu": 0.7, "half_length": 0.1, "half_width": 0.05}
         | {"type": "centroidal_com", "ref": [..3..]}          # centroidal state
         | {"type": "linear_momentum", "ref": [..3..]}
         | {"type": "angular_momentum", "ref": [..3..]}
         | {"type": "centroidal_acceleration", "mass":, "gravity":,
            "contact_map": CMAP, "force_size": 3|6}
         | {"type": "centroidal_friction_cone", "mu":, "epsilon":, "k": 0}
         | {"type": "centroidal_wrench_cone", "mu":, "half_length":,
            "half_width":, "k": 0}
         | {"type": "frame_collision", "geom1": GEOM, "geom2": GEOM}
    GEOM = {"frame": "tool0" | null,      # null/absent = world-fixed
            "kind": "sphere|capsule|box|convex|halfspace",
            ["radius":], ["half_length":], ["offset_p": [..3..]],
            ["half_extents": [..3..]], ["vertices": [[..3..], ..]]}
    SET  = {"type": "equality"} | {"type": "negative_orthant"}
         | {"type": "box", "lower": [..], "upper": [..]}
         | {"type": "l1", "scale": s}

Per-stage values (a contact schedule, swing targets, phase-gated cost
weights): any array value may be wrapped as
    PER_STAGE = {"per_stage": [v_0, v_1, ... v_{N-1}]}
The problem is built from stage 0's value, and the whole (N, ...) array
is then stamped into the stacked stage leaves (1, N, ...).

Arrays become tensors of ``dtype`` on ``device`` (default: the card;
raises without one). A problem exports only where every leaf is shared
by the batch (a batch axis of 1) and x0 is one state; the multibody
model is not exported: ``problem_to_spec`` takes its ``model_spec``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import numpy as np
import torch

from aligator_tpu_torch import constraints as S
from aligator_tpu_torch import costs as C
from aligator_tpu_torch import manifolds as M
from aligator_tpu_torch.problem import TrajOptProblem, build_problem
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.tree import shared, tree_map


@dataclasses.dataclass
class _Ctx:
    """Parse context. ``mode`` says how {"per_stage": ...} values resolve:
    "first" → stage 0's value (to build the tiled problem), "full" → the
    whole (N, ...) array (to stamp it). ``nsteps`` checks the lengths of
    per-stage lists; ``where`` names a position that is never stamped
    (x0, term_cost, term_constraints), where a per-stage value is an
    error rather than silently dropped."""

    dtype: Any
    device: Any
    mode: str = "first"
    model: Any = None
    has_per_stage: bool = False
    nsteps: Optional[int] = None
    where: Optional[str] = None


def _arr(v, ctx: _Ctx) -> torch.Tensor:
    if isinstance(v, dict) and "per_stage" in v:
        if ctx.where is not None:
            raise ValueError(
                f"'per_stage' is not allowed in {ctx.where}: these values apply to a "
                "single (initial or terminal) node, never to the running stages, and "
                "would be silently ignored")
        full = torch.as_tensor(np.asarray(v["per_stage"], dtype=np.float64)).to(
            dtype=ctx.dtype, device=ctx.device)
        if ctx.nsteps is not None and full.shape[0] != ctx.nsteps:
            raise ValueError(f"per_stage list has {full.shape[0]} entries, expected "
                             f"nsteps={ctx.nsteps}")
        ctx.has_per_stage = True
        return full if ctx.mode == "full" else full[0]
    return torch.as_tensor(np.asarray(v, dtype=np.float64)).to(dtype=ctx.dtype,
                                                               device=ctx.device)


def _need_model(ctx: _Ctx, what: str):
    if ctx.model is None:
        raise ValueError(f"{what} needs a top-level 'model'")
    return ctx.model


def _model_from_spec(m: dict, dtype, device):
    from aligator_tpu_torch.multibody.model import build_serial_chain
    from aligator_tpu_torch.multibody.urdf import load_talos_like, load_urdf

    t = m["type"]
    if t == "serial_chain":
        return build_serial_chain(n_links=int(m["n_links"]), dtype=dtype, device=device)
    if t == "humanoid":
        # the talos walk's model, as both packages' examples load it
        return load_talos_like(dtype, device)
    if t == "urdf":
        return load_urdf(m["path"], free_flyer=bool(m.get("free_flyer", False)), dtype=dtype,
                         device=device)
    raise ValueError(f"unknown model type {t!r}")


def _space_from_spec(sp: dict, model=None):
    t = sp["type"]
    if t == "vector":
        return M.VectorSpace(int(sp["dim"]))
    simple = {"se2": M.SE2, "se3": M.SE3, "so2": M.SO2, "so3": M.SO3}
    if t in simple:
        return simple[t]()
    if t == "multibody_phase":
        from aligator_tpu_torch.multibody.spaces import MultibodyPhaseSpace

        if model is None:
            raise ValueError("multibody_phase space needs a top-level 'model'")
        return MultibodyPhaseSpace(model)
    raise ValueError(f"unknown space type {t!r}")


def _actuation_from_spec(name: str, ctx: _Ctx):
    from aligator_tpu_torch.dynamics.multibody import floating_base_actuation, full_actuation

    model = _need_model(ctx, "multibody actuation")
    make = full_actuation if name == "full" else floating_base_actuation
    return make(model, ctx.dtype, ctx.device)


def _contacts_from_spec(c: dict, ctx: _Ctx):
    """CONTACTS → a multibody ContactSet (contact dynamics, force residuals)."""
    from aligator_tpu_torch.multibody.contact import anchor_at_configuration, make_contact_set

    model = _need_model(ctx, "a contact set")
    cs = make_contact_set(model, tuple((str(n), int(d)) for n, d in c["frames"]),
                          kp=float(c.get("kp", 100.0)), kd=float(c.get("kd", 50.0)),
                          dtype=ctx.dtype, device=ctx.device)
    if "anchor_q" in c:
        cs = anchor_at_configuration(model, cs, _arr(c["anchor_q"], ctx))
    for key in ("anchor_R", "anchor_p", "active"):
        if key in c:
            cs = cs.replace(**{key: _arr(c[key], ctx)})
    return cs


def _contact_map_from_spec(c: dict, ctx: _Ctx):
    from aligator_tpu_torch.dynamics.centroidal import ContactMap

    cm = ContactMap.create(tuple(c["names"]), _arr(c["poses"], ctx), dtype=ctx.dtype,
                           device=ctx.device)
    if "active" in c:
        cm = cm.replace(active=_arr(c["active"], ctx))
    return cm


def _residual_from_spec(r: dict, space, ctx: _Ctx):
    from aligator_tpu_torch.functions import basic as B
    from aligator_tpu_torch.functions import centroidal as FC
    from aligator_tpu_torch.functions import contact as FK
    from aligator_tpu_torch.functions import frames as FR

    t = r["type"]
    a = lambda key: _arr(r[key], ctx)
    if t == "state_error":
        return B.StateErrorResidual(target=a("target"), space=space)
    if t == "control_error":
        return B.ControlErrorResidual(target=a("target"))
    if t == "linear":
        return B.LinearFunction(A=a("A"), B=a("B"), c=a("c"))
    if t in ("frame_translation", "frame_placement", "frame_velocity", "fly_high"):
        model = _need_model(ctx, f"{t} residual")
        fid = model.frame_id(r["frame"])
        if t == "frame_translation":
            return FR.FrameTranslationResidual(model=model, ref=a("ref"), frame_id=fid)
        if t == "frame_velocity":
            return FR.FrameVelocityResidual(model=model, ref=a("ref"), frame_id=fid)
        if t == "fly_high":
            return FR.FlyHighResidual(model=model, slope=_arr(r.get("slope", 1.0), ctx),
                                      frame_id=fid)
        return FR.FramePlacementResidual(model=model, ref_R=a("ref_R"), ref_p=a("ref_p"),
                                         frame_id=fid)
    if t in ("com_translation", "com_velocity", "centroidal_momentum"):
        cls = {"com_translation": FR.CenterOfMassTranslationResidual,
               "com_velocity": FR.CenterOfMassVelocityResidual,
               "centroidal_momentum": FR.CentroidalMomentumResidual}[t]
        return cls(model=_need_model(ctx, f"{t} residual"), ref=a("ref"))
    if t == "centroidal_momentum_derivative":
        model = _need_model(ctx, f"{t} residual")
        return FR.CentroidalMomentumDerivativeResidual(
            model=model, active=a("active"),
            frame_ids=tuple(model.frame_id(n) for n in r["frames"]),
            force_size=int(r.get("force_size", 3)))
    if t in ("contact_force", "friction_cone", "wrench_cone"):
        kw = dict(model=_need_model(ctx, f"{t} residual"),
                  actuation=_actuation_from_spec(r.get("actuation", "floating_base"), ctx),
                  contacts=_contacts_from_spec(r["contacts"], ctx),
                  contact_name=str(r["contact"]))
        if t == "contact_force":
            return FK.ContactForceResidual(fref=a("fref"), **kw)
        if t == "friction_cone":
            return FK.MultibodyFrictionConeResidual(mu=_arr(r.get("mu", 0.7), ctx), **kw)
        return FK.MultibodyWrenchConeResidual(
            Acone=FK.wrench_cone_matrix(float(r.get("mu", 0.7)),
                                        float(r.get("half_length", 0.1)),
                                        float(r.get("half_width", 0.05)),
                                        dtype=ctx.dtype, device=ctx.device), **kw)
    if t in ("centroidal_com", "linear_momentum", "angular_momentum"):
        cls = {"centroidal_com": FC.CentroidalCoMResidual,
               "linear_momentum": FC.LinearMomentumResidual,
               "angular_momentum": FC.AngularMomentumResidual}[t]
        return cls(ref=a("ref"))
    if t == "centroidal_acceleration":
        return FC.CentroidalAccelerationResidual(
            contact_map=_contact_map_from_spec(r["contact_map"], ctx), mass=a("mass"),
            gravity=a("gravity"), force_size=int(r.get("force_size", 3)))
    if t == "centroidal_friction_cone":
        return FC.CentroidalFrictionConeResidual(
            mu=_arr(r.get("mu", 0.7), ctx), epsilon=_arr(r.get("epsilon", 1e-9), ctx),
            k=int(r.get("k", 0)))
    if t == "centroidal_wrench_cone":
        return FC.CentroidalWrenchConeResidual(
            mu=float(r.get("mu", 0.7)), hL=float(r.get("half_length", 0.1)),
            hW=float(r.get("half_width", 0.05)), k=int(r.get("k", 0)))
    if t == "frame_collision":
        model = _need_model(ctx, "frame_collision residual")
        return FR.FrameCollisionResidual(model=model, geom1=_geom_from_spec(r["geom1"], model),
                                         geom2=_geom_from_spec(r["geom2"], model))
    raise ValueError(f"unknown residual type {t!r}")


def _geom_from_spec(g: dict, model):
    from aligator_tpu_torch.multibody.geometry import GeomObject

    frame = g.get("frame")
    kw = dict(frame_id=-1 if frame is None else model.frame_id(frame),
              kind=str(g.get("kind", "sphere")), radius=float(g.get("radius", 0.05)),
              half_length=float(g.get("half_length", 0.0)),
              offset_p=tuple(g.get("offset_p", (0.0, 0.0, 0.0))),
              half_extents=tuple(g.get("half_extents", (0.0, 0.0, 0.0))))
    if "vertices" in g:
        kw["vertices"] = tuple(tuple(v) for v in g["vertices"])
    return GeomObject(**kw)


def _geom_to_spec(g, model) -> dict:
    out = {"frame": None if g.frame_id < 0 else model.frames[g.frame_id].name,
           "kind": g.kind, "radius": float(g.radius), "half_length": float(g.half_length),
           "offset_p": list(g.offset_p), "half_extents": list(g.half_extents)}
    if g.vertices is not None:
        out["vertices"] = [list(v) for v in g.vertices]
    return out


def _set_from_spec(s: dict):
    t = s["type"]
    if t == "equality":
        return S.EqualityConstraint()
    if t == "negative_orthant":
        return S.NegativeOrthant()
    if t == "box":
        return S.BoxConstraint(lower=tuple(s["lower"]), upper=tuple(s["upper"]))
    if t == "l1":
        return S.L1Penalty(scale=float(s.get("scale", 1.0)))
    raise ValueError(f"unknown set type {t!r}")


def _cost_from_spec(c: dict, space, ctx: _Ctx):
    t = c["type"]
    if t == "quadratic":
        return C.QuadraticCost.create(_arr(c["Wx"], ctx), _arr(c["Wu"], ctx),
                                      N=_arr(c["N"], ctx) if "N" in c else None)
    if t == "quad_state":
        return C.QuadraticStateCost(space, _arr(c["target"], ctx), _arr(c["W"], ctx))
    if t == "quad_control":
        return C.QuadraticControlCost(_arr(c["target"], ctx), _arr(c["W"], ctx))
    if t == "quad_residual":
        return C.QuadraticResidualCost(residual=_residual_from_spec(c["residual"], space, ctx),
                                       W=_arr(c["W"], ctx))
    if t == "stack":
        return C.CostStack.create(*[(_cost_from_spec(cc, space, ctx), _arr(w, ctx))
                                    for cc, w in c["components"]])
    raise ValueError(f"unknown cost type {t!r}")


def _unicycle_xdot(space, x, u):
    """The se2 car's body-frame ODE: forward speed u₀, turn rate u₁."""
    v, w = u[..., 0], u[..., 1]
    return torch.stack([v, torch.zeros_like(v), w], dim=-1)


def _ode_from_spec(o: dict, ctx: _Ctx):
    from aligator_tpu_torch.dynamics import centroidal as DC
    from aligator_tpu_torch.dynamics import multibody as DM
    from aligator_tpu_torch.dynamics.linear import LinearODE

    t = o["type"]
    if t == "linear":
        return LinearODE(A=_arr(o["A"], ctx), B=_arr(o["B"], ctx), c=_arr(o["c"], ctx))
    if t == "unicycle":
        from aligator_tpu_torch.functions.custom import CustomODE

        return CustomODE(fn=_unicycle_xdot)
    if t == "multibody_free_fwd":
        return DM.MultibodyFreeFwdDynamics(
            model=_need_model(ctx, "multibody_free_fwd ode"),
            actuation=_actuation_from_spec(o.get("actuation", "full"), ctx))
    if t == "multibody_constraint_fwd":
        return DM.MultibodyConstraintFwdDynamics(
            model=_need_model(ctx, "multibody_constraint_fwd ode"),
            actuation=_actuation_from_spec(o.get("actuation", "floating_base"), ctx),
            contacts=_contacts_from_spec(o["contacts"], ctx))
    if t == "kinodynamics":
        model = _need_model(ctx, "kinodynamics ode")
        fids = tuple(model.frame_id(n) for n in o["frames"])
        return DM.KinodynamicsFwdDynamics(
            model=model, active=_arr(o.get("active", [1.0] * len(fids)), ctx), frame_ids=fids,
            force_size=int(o.get("force_size", 3)))
    if t in ("centroidal", "continuous_centroidal"):
        cls = (DC.CentroidalFwdDynamics if t == "centroidal"
               else DC.ContinuousCentroidalFwdDynamics)
        return cls(contact_map=_contact_map_from_spec(o["contact_map"], ctx),
                   mass=_arr(o["mass"], ctx),
                   gravity=_arr(o.get("gravity", [0.0, 0.0, -9.81]), ctx),
                   force_size=int(o.get("force_size", 3)))
    raise ValueError(f"unknown ode type {t!r}")


def _dynamics_from_spec(d: dict, ctx: _Ctx):
    from aligator_tpu_torch import dynamics as D

    t = d["type"]
    if t == "linear_discrete":
        return D.LinearDiscreteDynamics(A=_arr(d["A"], ctx), B=_arr(d["B"], ctx),
                                        c=_arr(d["c"], ctx))
    if t == "integrator":
        ode = _ode_from_spec(d["ode"], ctx)
        dt = _arr(d["dt"], ctx)
        make = {"euler": D.EulerIntegrator, "semi_euler": D.SemiImplEulerIntegrator,
                "rk2": D.RK2Integrator, "rk4": D.RK4Integrator}
        scheme = d.get("scheme", "euler")
        if scheme == "midpoint":
            return D.MidpointIntegratorExplicit(ode, dt)
        return make[scheme](ode=ode, dt=dt)
    raise ValueError(f"unknown dynamics type {t!r}")


def _merge_per_stage(tiled, full):
    """Stamp per-stage leaves into the tiled stage objects: a leaf of the
    full parse whose shape is the tiled leaf's without its batch axis,
    (N, ...), is a per-stage array and replaces the tile; every other
    leaf keeps it."""
    return tree_map(lambda t, f: f[None] if f.shape == t.shape[1:] else t, tiled, full)


def problem_from_spec(spec: dict | str, dtype=torch.float64, device=None) -> TrajOptProblem:
    """A problem from a spec dict or JSON string, its tensors of ``dtype``
    on ``device`` (default: the card; raises without one). Every object's
    leaves are shared by the batch (a batch axis of 1)."""
    if isinstance(spec, str):
        spec = json.loads(spec)
    device = resolve_device(device)
    model = _model_from_spec(spec["model"], dtype, device) if "model" in spec else None
    nu, nsteps = int(spec["nu"]), int(spec["nsteps"])
    ctx = _Ctx(dtype=dtype, device=device, model=model, nsteps=nsteps)
    space = _space_from_spec(spec["space"], model)
    dyn = _dynamics_from_spec(spec["dynamics"], ctx)
    cost = _cost_from_spec(spec["cost"], space, ctx)
    tcost = _cost_from_spec(spec["term_cost"], space, dataclasses.replace(ctx, where="term_cost"))

    def cstr_list(key, c):
        out = []
        for e in spec.get(key, []):
            res = _residual_from_spec(e["residual"], space, c)
            tgt = e["residual"].get("target")
            if isinstance(tgt, dict) and "per_stage" in tgt:
                tgt = tgt["per_stage"][0]  # the residual's width from one stage's value
            nr = int(e.get("nr") or (len(tgt) if tgt is not None else 0))
            if nr == 0:
                raise ValueError("constraint entry needs 'nr' or a 'target'")
            out.append((res, _set_from_spec(e["set"]), nr))
        return tuple(out)

    cstrs = cstr_list("constraints", ctx)
    tcstrs = cstr_list("term_constraints", dataclasses.replace(ctx, where="term_constraints"))
    problem = build_problem(
        space, nu, nsteps, _arr(spec["x0"], dataclasses.replace(ctx, where="x0")),
        shared(dyn), shared(cost), shared(tcost),
        constraints=tuple((shared(f), s, n) for f, s, n in cstrs),
        term_constraints=tuple((shared(f), s, n) for f, s, n in tcstrs),
        device=device, dtype=dtype)
    if ctx.has_per_stage:
        # second pass: the full (N, ...) arrays, stamped into the stage leaves
        fctx = _Ctx(dtype=dtype, device=device, mode="full", model=model, nsteps=nsteps)
        problem = problem.replace(
            dynamics=_merge_per_stage(problem.dynamics,
                                      _dynamics_from_spec(spec["dynamics"], fctx)),
            cost=_merge_per_stage(problem.cost, _cost_from_spec(spec["cost"], space, fctx)),
            constraints=tuple(_merge_per_stage(t, f[0]) for t, f in
                              zip(problem.constraints, cstr_list("constraints", fctx))))
    return problem


# ---------------------------------------------------------------------------
# export: problem → spec. Coverage mirrors the importer's schema; a CustomODE
# (a Python callable) or a class outside the schema raises.
# ---------------------------------------------------------------------------


def _host(leaf) -> np.ndarray:
    """A leaf without its batch axis, on the host: the batch must share it."""
    a = leaf.detach().cpu().numpy()
    if a.ndim == 0 or a.shape[0] != 1:
        raise ValueError(f"cannot export a leaf of shape {tuple(a.shape)}: a spec holds "
                         "leaves shared by the batch (a batch axis of 1)")
    return a[0]


def _unstage(leaf, nsteps: int):
    """A stacked stage leaf (1, N, ...) exports as its stage-0 value where
    it is the same at every stage, else as {"per_stage": [...]}; a terminal
    leaf (nsteps = 0) as its value."""
    a = _host(leaf)
    if a.ndim >= 1 and a.shape[0] == nsteps:
        if bool(np.all(a == a[0])):
            return a[0].tolist()
        return {"per_stage": a.tolist()}
    return a.tolist()


def _first_stage(leaf, trailing: int) -> np.ndarray:
    """One stage's value of a leaf that must not vary: its last
    ``trailing`` axes at the first index of the others."""
    a = leaf.detach().cpu().numpy()
    return a.reshape((-1,) + a.shape[a.ndim - trailing:])[0]


def _space_to_spec(space):
    name = type(space).__name__
    if name == "VectorSpace":
        return {"type": "vector", "dim": int(space.ndx)}
    if name in ("SE2", "SE3", "SO2", "SO3"):
        return {"type": name.lower()}
    if name == "TangentBundle" and type(getattr(space, "base", None)).__name__ == \
            "MultibodyConfiguration":
        return {"type": "multibody_phase"}
    raise ValueError(f"cannot export space {name}")


def _actuation_to_spec(act, model):
    a = _first_stage(act, 2)
    nv = model.nv
    if a.shape == (nv, nv) and np.allclose(a, np.eye(nv)):
        return "full"
    fb = np.zeros((nv, nv - 6))
    fb[6:, :] = np.eye(nv - 6)
    if a.shape == (nv, nv - 6) and np.allclose(a, fb):
        return "floating_base"
    raise ValueError("cannot export a non-standard actuation matrix")


def _contacts_to_spec(cs, nsteps: int) -> dict:
    return {"frames": [[s.name, int(s.dim)] for s in cs.specs],
            "kp": float(cs.kp.reshape(-1)[0]), "kd": float(cs.kd.reshape(-1)[0]),
            "anchor_R": _unstage(cs.anchor_R, nsteps), "anchor_p": _unstage(cs.anchor_p, nsteps),
            "active": _unstage(cs.active, nsteps)}


def _contact_map_to_spec(cm, nsteps: int) -> dict:
    return {"names": list(cm.names), "poses": _unstage(cm.poses, nsteps),
            "active": _unstage(cm.active, nsteps)}


def _residual_to_spec(r, nsteps: int):
    name = type(r).__name__
    u = lambda v: _unstage(v, nsteps)
    frame = lambda fid: r.model.frames[fid].name
    simple = {"StateErrorResidual": ("state_error", "target"),
              "ControlErrorResidual": ("control_error", "target"),
              "CenterOfMassTranslationResidual": ("com_translation", "ref"),
              "CenterOfMassVelocityResidual": ("com_velocity", "ref"),
              "CentroidalMomentumResidual": ("centroidal_momentum", "ref"),
              "CentroidalCoMResidual": ("centroidal_com", "ref"),
              "LinearMomentumResidual": ("linear_momentum", "ref"),
              "AngularMomentumResidual": ("angular_momentum", "ref")}
    if name in simple:
        kind, key = simple[name]
        return {"type": kind, key: u(getattr(r, key))}
    if name == "LinearFunction":
        return {"type": "linear", "A": u(r.A), "B": u(r.B), "c": u(r.c)}
    if name == "FrameTranslationResidual":
        return {"type": "frame_translation", "frame": frame(r.frame_id), "ref": u(r.ref)}
    if name == "FramePlacementResidual":
        return {"type": "frame_placement", "frame": frame(r.frame_id), "ref_R": u(r.ref_R),
                "ref_p": u(r.ref_p)}
    if name == "FrameVelocityResidual":
        return {"type": "frame_velocity", "frame": frame(r.frame_id), "ref": u(r.ref)}
    if name == "FlyHighResidual":
        return {"type": "fly_high", "frame": frame(r.frame_id), "slope": u(r.slope)}
    if name == "CentroidalFrictionConeResidual":
        return {"type": "centroidal_friction_cone", "mu": u(r.mu), "epsilon": u(r.epsilon),
                "k": int(r.k)}
    if name == "CentroidalWrenchConeResidual":
        return {"type": "centroidal_wrench_cone", "mu": float(r.mu), "half_length": float(r.hL),
                "half_width": float(r.hW), "k": int(r.k)}
    if name == "CentroidalMomentumDerivativeResidual":
        return {"type": "centroidal_momentum_derivative",
                "frames": [frame(f) for f in r.frame_ids], "active": u(r.active),
                "force_size": int(r.force_size)}
    if name == "CentroidalAccelerationResidual":
        return {"type": "centroidal_acceleration", "mass": u(r.mass), "gravity": u(r.gravity),
                "force_size": int(r.force_size),
                "contact_map": _contact_map_to_spec(r.contact_map, nsteps)}
    if name in ("ContactForceResidual", "MultibodyFrictionConeResidual",
                "MultibodyWrenchConeResidual"):
        base = {"contacts": _contacts_to_spec(r.contacts, nsteps),
                "actuation": _actuation_to_spec(r.actuation, r.model),
                "contact": r.contact_name}
        if name == "ContactForceResidual":
            return {"type": "contact_force", "fref": u(r.fref), **base}
        if name == "MultibodyFrictionConeResidual":
            return {"type": "friction_cone", "mu": u(r.mu), **base}
        # the residual holds only the 17×6 matrix: (mu, hL, hW) are read off
        # its fixed rows and the rebuild checked; another matrix raises
        from aligator_tpu_torch.functions.contact import wrench_cone_matrix

        stages = r.Acone.detach().cpu().numpy().reshape(-1, 17, 6)
        if not np.all(stages == stages[0]):
            raise ValueError("cannot export a per-stage wrench-cone Acone")
        A = stages[0]
        mu, hW, hL = float(-A[1, 2]), float(-A[5, 2]), float(-A[7, 2])
        if not np.allclose(A, wrench_cone_matrix(mu, hL, hW, device="cpu").numpy()):
            raise ValueError("cannot export a non-standard wrench-cone Acone")
        return {"type": "wrench_cone", "mu": mu, "half_length": hL, "half_width": hW, **base}
    if name == "FrameCollisionResidual":
        return {"type": "frame_collision", "geom1": _geom_to_spec(r.geom1, r.model),
                "geom2": _geom_to_spec(r.geom2, r.model)}
    raise ValueError(f"cannot export residual {name}")


def _set_to_spec(s):
    name = type(s).__name__
    if name == "EqualityConstraint":
        return {"type": "equality"}
    if name == "NegativeOrthant":
        return {"type": "negative_orthant"}
    if name == "BoxConstraint":
        return {"type": "box", "lower": list(s.lower), "upper": list(s.upper)}
    if name == "L1Penalty":
        return {"type": "l1", "scale": float(s.scale)}
    raise ValueError(f"cannot export constraint set {name}")


def _cost_to_spec(c, nsteps: int):
    name = type(c).__name__
    u = lambda v: _unstage(v, nsteps)
    if name == "QuadraticCost":
        out = {"type": "quadratic", "Wx": u(c.Wx), "Wu": u(c.Wu)}
        if c.N.numel() and bool(c.N.ne(0).any()):
            out["N"] = u(c.N)
        return out
    if name == "QuadraticResidualCost":
        # the JAX package's quad_state and quad_control are this class too
        return {"type": "quad_residual", "residual": _residual_to_spec(c.residual, nsteps),
                "W": u(c.W)}
    if name == "CostStack":
        return {"type": "stack", "components": [[_cost_to_spec(cc, nsteps), u(w)]
                                                for cc, w in zip(c.components, c.weights)]}
    raise ValueError(f"cannot export cost {name}")


def _ode_to_spec(ode, nsteps: int):
    name = type(ode).__name__
    u = lambda v: _unstage(v, nsteps)
    if name == "LinearODE":
        return {"type": "linear", "A": u(ode.A), "B": u(ode.B), "c": u(ode.c)}
    if name == "MultibodyFreeFwdDynamics":
        return {"type": "multibody_free_fwd",
                "actuation": _actuation_to_spec(ode.actuation, ode.model)}
    if name == "MultibodyConstraintFwdDynamics":
        return {"type": "multibody_constraint_fwd",
                "actuation": _actuation_to_spec(ode.actuation, ode.model),
                "contacts": _contacts_to_spec(ode.contacts, nsteps)}
    if name == "KinodynamicsFwdDynamics":
        return {"type": "kinodynamics", "frames": [ode.model.frames[f].name
                                                    for f in ode.frame_ids],
                "force_size": int(ode.force_size), "active": u(ode.active)}
    if name in ("CentroidalFwdDynamics", "ContinuousCentroidalFwdDynamics"):
        return {"type": "centroidal" if name == "CentroidalFwdDynamics"
                else "continuous_centroidal",
                "mass": u(ode.mass), "gravity": u(ode.gravity),
                "force_size": int(ode.force_size),
                "contact_map": _contact_map_to_spec(ode.contact_map, nsteps)}
    raise ValueError(f"cannot export ode {name} (CustomODE callables are not serializable)")


def _dynamics_to_spec(dyn, nsteps: int):
    name = type(dyn).__name__
    u = lambda v: _unstage(v, nsteps)
    if name == "LinearDiscreteDynamics":
        return {"type": "linear_discrete", "A": u(dyn.A), "B": u(dyn.B), "c": u(dyn.c)}
    schemes = {"EulerIntegrator": "euler", "SemiImplEulerIntegrator": "semi_euler",
               "RK2Integrator": "rk2", "RK4Integrator": "rk4"}
    if name in schemes:
        return {"type": "integrator", "scheme": schemes[name], "dt": u(dyn.dt),
                "ode": _ode_to_spec(dyn.ode, nsteps)}
    raise ValueError(f"cannot export dynamics {name}")


def problem_to_spec(problem: TrajOptProblem, model_spec: Optional[dict] = None) -> dict:
    """A JSON-able spec of ``problem`` (the inverse of
    :func:`problem_from_spec`). ``model_spec`` must be given when the
    problem holds a multibody model: models come from URDFs or builders,
    and their arrays are not exported. Raises ``ValueError`` for a part
    outside the schema (a ``CustomODE``, say), a leaf that differs across
    the batch, or a batch of different initial states."""
    N = problem.nsteps
    x0 = problem.x0.detach().cpu().numpy()
    if x0.ndim == 2:
        if not np.all(x0 == x0[0]):
            raise ValueError("cannot export a batch of different initial states")
        x0 = x0[0]
    spec: dict = {
        "space": _space_to_spec(problem.space), "nu": int(problem.nu), "nsteps": int(N),
        "x0": x0.tolist(), "dynamics": _dynamics_to_spec(problem.dynamics, N),
        "cost": _cost_to_spec(problem.cost, N), "term_cost": _cost_to_spec(problem.term_cost, 0),
    }
    if model_spec is not None:
        spec["model"] = model_spec
    for key, fns, sets, dims, n in (
            ("constraints", problem.constraints, problem.constraint_sets,
             problem.constraint_dims, N),
            ("term_constraints", problem.term_constraints, problem.term_sets,
             problem.term_dims, 0)):
        entries = [{"residual": _residual_to_spec(fn, n), "set": _set_to_spec(st), "nr": int(nr)}
                   for fn, st, nr in zip(fns, sets, dims)]
        if entries:
            spec[key] = entries
    return spec
