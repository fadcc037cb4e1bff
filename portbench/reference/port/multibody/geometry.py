"""Minimal differentiable collision geometry (port of
``aligator_tpu.multibody.geometry``).

Primitive pairs in closed form, with eps-guarded norms so that distances
keep finite derivatives at touching configurations:

* sphere/sphere, sphere/capsule, capsule/capsule by the clamped
  segment-segment closest points;
* sphere/box by the exact box SDF; capsule/box by the SDF minimized along
  the segment with a 32-step ternary search;
* anything/halfspace (sphere, capsule, box, convex);
* convex/anything (vertex clouds; box/box too, by its corners): a 48-step
  Frank-Wolfe on the Minkowski difference finds the separating direction
  n̂, and the distance is re-evaluated in the dual support form
  d = min⟨n̂, W₁⟩ − max⟨n̂, W₂⟩. For overlapping hulls that form goes
  negative (an underestimate: conservative for avoidance).

The minimizers (the segment parameter t*, the direction n̂) come from
loops on detached inputs, and the distance is evaluated again at them
with live inputs: by Danskin's theorem its derivative is then the
derivative of the minimum, which is what the JAX package's
``stop_gradient`` arranges. Both loops keep the JAX package's iteration
counts, so the results match; each step is a few small tensor operations,
and under the problem's ``vmap`` a step is a few kernels for the whole
batch and horizon.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from portbench.reference.port.multibody.algorithms import frame_placement
from portbench.reference.port.multibody.model import MultibodyModel
from portbench.reference.port.multibody.spatial import SE3T
from portbench.reference.port.utils.tree import detached

TERNARY_ITERS = 32
FRANK_WOLFE_ITERS = 48
_CORNER_SIGNS = [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]


@dataclasses.dataclass(frozen=True)
class GeomObject:
    """A primitive attached to a model frame at a fixed local offset.

    ``kind`` ∈ {"sphere", "capsule", "box", "convex", "halfspace"}:
    capsules run along their local z axis over ±``half_length``; boxes are
    axis-aligned in the (offset) frame with ``half_extents``; a convex
    primitive is the hull of ``vertices`` (local frame, a tuple of
    triples) inflated by ``radius``; a halfspace is {x : n·(x − o) ≤ 0}
    with n the frame's z axis. ``frame_id = -1`` fixes the primitive in
    the world (a static obstacle, the ground)."""

    frame_id: int
    kind: str = "sphere"
    radius: float = 0.05
    half_length: float = 0.0
    offset_p: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    half_extents: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    vertices: Optional[Tuple[Tuple[float, float, float], ...]] = None
    _tensors: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                       compare=False, hash=False)

    def const(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The static field ``name`` (or "corner_signs") as a tensor of
        ``like``'s dtype and device, made once per dtype and device: no
        copy from the host on every evaluation."""
        key = (name, like.dtype, like.device)
        if key not in self._tensors:
            value = _CORNER_SIGNS if name == "corner_signs" else getattr(self, name)
            self._tensors[key] = torch.tensor(value, dtype=like.dtype, device=like.device)
        return self._tensors[key]


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _safe_norm(v, eps=1e-12):
    return torch.sqrt((v * v).sum(-1, keepdim=True) + eps)


def _center(M: SE3T, g: GeomObject):
    return M.p + _mv(M.R, g.const("offset_p", M.p))


def _segment_endpoints(M: SE3T, obj: GeomObject):
    c = _center(M, obj)
    if obj.kind == "sphere":
        return c, c
    axis = M.R[..., :, 2]
    return c - obj.half_length * axis, c + obj.half_length * axis


def _seg_seg_closest(p1, q1, p2, q2):
    """Closest-point distance of the segments [p1, q1] and [p2, q2]
    (Ericson, Real-Time Collision Detection §5.1.9, clamped quadratic)."""
    d1, d2, r = q1 - p1, q2 - p2, p1 - p2
    dot = lambda a, b: (a * b).sum(-1, keepdim=True)
    a = dot(d1, d1) + 1e-12
    e = dot(d2, d2) + 1e-12
    f, c, b = dot(d2, r), dot(d1, r), dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > 1e-12,
                    torch.clamp((b * f - c * e) / torch.clamp(denom, min=1e-12), 0.0, 1.0),
                    torch.zeros_like(denom))
    t_cl = torch.clamp((b * s + f) / e, 0.0, 1.0)
    s = torch.clamp((b * t_cl - c) / a, 0.0, 1.0)
    return _safe_norm((p1 + s * d1) - (p2 + t_cl * d2))


def _box_sdf_local(u, h):
    """Exact signed distance of a point ``u`` (box frame) to a box of
    half-extents ``h``: ‖max(|u| − h, 0)‖ + min(max(|u| − h), 0)."""
    qv = u.abs() - h
    return _safe_norm(torch.clamp(qv, min=0.0)) + torch.clamp(qv.amax(-1, keepdim=True),
                                                               max=0.0)


def _point_box_distance(p, Mb: SE3T, box: GeomObject):
    u = _mv(Mb.R.mT, p - _center(Mb, box))
    return _box_sdf_local(u, box.const("half_extents", p))


def _segment_box_distance(p1, q1, Mb: SE3T, box: GeomObject, iters: int = TERNARY_ITERS):
    """min over t ∈ [0, 1] of the box SDF at p1 + t·(q1 − p1): the
    minimizer t* by ternary search on detached inputs, the SDF evaluated
    again at t* (Danskin)."""
    p1d, q1d, Mbd = detached((p1, q1, Mb))
    dd = q1d - p1d
    f = lambda t: _point_box_distance(p1d + t * dd, Mbd, box)
    lo, hi = p1d.new_zeros(1), p1d.new_ones(1)
    for _ in range(iters):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        go_left = f(m1) <= f(m2)
        lo, hi = torch.where(go_left, lo, m1), torch.where(go_left, m2, hi)
    t_star = 0.5 * (lo + hi)
    return _point_box_distance(p1 + t_star * (q1 - p1), Mb, box)


def _box_corners(Mb: SE3T, box: GeomObject):
    signs = box.const("corner_signs", Mb.p)
    return _center(Mb, box) + (signs * box.const("half_extents", Mb.p)) @ Mb.R.mT  # (8, 3)


def _vertex_cloud(M: SE3T, g: GeomObject):
    """World-frame vertices of a convex-capable primitive: a convex hull's
    vertices, a box's 8 corners, a capsule's 2 segment ends, a sphere's
    centre (the caller adds ``radius`` as a sphere sweep)."""
    if g.kind == "convex":
        if g.vertices is None:
            raise ValueError("convex GeomObject needs 'vertices'")
        V = g.const("vertices", M.p) + g.const("offset_p", M.p)
        return M.p + V @ M.R.mT
    if g.kind == "box":
        return _box_corners(M, g)
    return torch.stack(_segment_endpoints(M, g), dim=0)


def _fw_direction(W1, W2, iters: int = FRANK_WOLFE_ITERS):
    """Frank-Wolfe on ½‖a − b‖² over (a, b) ∈ conv(W1) × conv(W2) with the
    exact line search of the quadratic, a fixed count of steps; returns
    the unit separating direction. Call it on detached clouds."""
    a, b = W1.mean(0), W2.mean(0)
    # a row by index_select: under vmap a cloud may be unbatched (fixed in
    # the world) while the index is batched, which plain indexing refuses
    row = lambda W, i: torch.index_select(W, 0, i.reshape(1))[0]
    for _ in range(iters):
        g = a - b
        da = a - row(W1, torch.argmin(W1 @ g))
        db = b - row(W2, torch.argmax(W2 @ g))
        s = da - db
        gamma = torch.clamp((s * g).sum(-1, keepdim=True) / ((s * s).sum(-1, keepdim=True)
                                                             + 1e-12), 0.0, 1.0)
        a, b = a - gamma * da, b - gamma * db
    x = a - b
    return x / _safe_norm(x)


def _convex_pair_distance(W1, W2, r1, r2):
    """Support-function distance of two world vertex clouds swept by
    spheres of radii r1, r2, at the Frank-Wolfe direction n̂ (detached)."""
    n = _fw_direction(W1.detach(), W2.detach())
    return (W1 @ n).amin(-1, keepdim=True) - (W2 @ n).amax(-1, keepdim=True) - r1 - r2


def _halfspace_info(Mh: SE3T, hs: GeomObject):
    return _center(Mh, hs), Mh.R[..., :, 2]


_RANK = {"sphere": 0, "capsule": 0, "box": 1, "convex": 1, "halfspace": 2}
_SEGLIKE = ("sphere", "capsule")


def pair_distance(model: MultibodyModel, q: torch.Tensor, g1: GeomObject,
                  g2: GeomObject) -> torch.Tensor:
    """Signed distance of two attached primitives (negative: penetration),
    a 0-dim tensor. Supported pairs: {sphere, capsule} × {sphere, capsule,
    box, convex, halfspace}, box or convex × {box, convex, halfspace}, in
    either order."""
    # the distances keep a trailing axis of 1 until here: under
    # torch.func.jvp a 0-dim tensor combined with a Python float (a
    # radius) gets a float64 tangent (manifolds/lie.py)
    return _pair_distance(model, q, g1, g2)[..., 0]


def _pair_distance(model, q, g1: GeomObject, g2: GeomObject) -> torch.Tensor:
    kinds = (g1.kind, g2.kind)

    def placement(g: GeomObject) -> SE3T:
        if g.frame_id < 0:  # fixed in the world
            return SE3T(torch.eye(3, dtype=q.dtype, device=q.device), q.new_zeros(3))
        return frame_placement(model, q, g.frame_id)

    # canonical order: segment-like first, then box and convex, halfspace last
    if _RANK[g1.kind] > _RANK[g2.kind]:
        g1, g2 = g2, g1
    M1, M2 = placement(g1), placement(g2)

    if g1.kind in _SEGLIKE and g2.kind in _SEGLIKE:
        p1, q1 = _segment_endpoints(M1, g1)
        p2, q2 = _segment_endpoints(M2, g2)
        return _seg_seg_closest(p1, q1, p2, q2) - g1.radius - g2.radius
    if g1.kind in _SEGLIKE and g2.kind == "box":
        p1, q1 = _segment_endpoints(M1, g1)
        if g1.kind == "sphere":
            return _point_box_distance(p1, M2, g2) - g1.radius
        return _segment_box_distance(p1, q1, M2, g2) - g1.radius
    if g1.kind != "halfspace" and g2.kind == "halfspace":
        o, n = _halfspace_info(M2, g2)
        r = g1.radius if g1.kind != "box" else 0.0
        return ((_vertex_cloud(M1, g1) - o) @ n).amin(-1, keepdim=True) - r
    if "convex" in kinds or (g1.kind == "box" and g2.kind == "box"):
        r1 = g1.radius if g1.kind != "box" else 0.0
        r2 = g2.radius if g2.kind != "box" else 0.0
        return _convex_pair_distance(_vertex_cloud(M1, g1), _vertex_cloud(M2, g2), r1, r2)
    raise NotImplementedError(
        f"unsupported geometry pair {kinds}: model the robot side with "
        "spheres/capsules/convex hulls and keep boxes/halfspaces for the environment")
