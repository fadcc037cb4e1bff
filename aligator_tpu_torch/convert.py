"""Build the port's objects from numpy arrays — the counterpart of carrying
weights across: a caller flattens its (JAX or other) objects to numpy and
the port never sees a foreign type. Both functions default to the GPU and
raise without one unless ``device="cpu"`` is passed."""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from aligator_tpu_torch.constraints import BoxConstraint
from aligator_tpu_torch.costs import QuadraticCost
from aligator_tpu_torch.dynamics.linear import LinearDiscreteDynamics
from aligator_tpu_torch.functions.basic import ControlErrorResidual
from aligator_tpu_torch.gar.lqr_problem import LQRProblem
from aligator_tpu_torch.manifolds.vector import VectorSpace
from aligator_tpu_torch.multibody.model import FrameSpec, JointSpec, MultibodyModel
from aligator_tpu_torch.problem import TrajOptProblem, build_problem
from aligator_tpu_torch.utils.device import resolve_device
from aligator_tpu_torch.utils.tree import shared

_LQR_FIELDS = ("Q", "S", "R", "q", "r", "A", "B", "f", "C", "D", "d",
               "Gx", "Gu", "Gth", "gamma", "G0", "g0", "Gv")


def lqr_from_numpy(arrays: Mapping[str, np.ndarray], device=None,
                   dtype: Optional[torch.dtype] = None) -> LQRProblem:
    """An ``LQRProblem`` from its fields as numpy arrays. Single-problem
    arrays (Q of shape (N+1, nx, nx)) get a batch axis of 1; batched arrays
    are taken as they are. ``Gv`` may be missing or None."""
    device = resolve_device(device)
    unbatched = np.ndim(arrays["Q"]) == 3

    def conv(a):
        t = torch.as_tensor(np.array(a), device=device)
        t = t.to(dtype) if dtype is not None else t
        return t.unsqueeze(0) if unbatched else t

    return LQRProblem(**{
        f: conv(arrays[f]) for f in _LQR_FIELDS if arrays.get(f) is not None
    })


def problem_from_numpy(A, B, c, Q, R, Qf, x0, N: int, lower=None, upper=None,
                       device=None, dtype: Optional[torch.dtype] = None
                       ) -> TrajOptProblem:
    """The LQR-class problem of the bench and the entry point: linear
    dynamics x⁺ = A x + B u + c, running cost ½xᵀQx + ½uᵀRu, terminal cost
    ½xᵀQf x + ½uᵀRu, and — when ``lower``/``upper`` are given — the box
    lower ≤ u ≤ upper as a ``ControlErrorResidual`` in a ``BoxConstraint``.
    ``x0`` is (nx,) or (B, nx). A, B, c of shapes (B, nx, nx), (B, nx, nu),
    (B, nx) make a problem whose dynamics differ per batch element; the
    other arrays are shared by the batch."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.array(a), device=device)
    A, B, c = t(A), t(B), t(c)
    dyn = LinearDiscreteDynamics(A=A, B=B, c=c)
    if A.dim() == 2:
        dyn = shared(dyn)
    nx, nu = A.shape[-1], B.shape[-1]
    dt = dtype or A.dtype
    constraints = ()
    if lower is not None:
        box = BoxConstraint(lower=tuple(float(v) for v in lower),
                            upper=tuple(float(v) for v in upper))
        target = torch.zeros((1, nu), dtype=dt, device=device)
        constraints = ((ControlErrorResidual(target=target), box, nu),)
    return build_problem(
        VectorSpace(nx), nu, N, t(x0), dyn,
        shared(QuadraticCost.create(t(Q), t(R))),
        shared(QuadraticCost.create(t(Qf), t(R))),
        constraints=constraints, device=device, dtype=dt,
    )


MULTIBODY_LEAVES = ("jplace_R", "jplace_p", "mass", "com", "inertia", "frame_R", "frame_p",
                    "gravity")


def multibody_model_from_numpy(arrays: Mapping[str, np.ndarray], joints: Sequence,
                               parents: Sequence[int], frames: Sequence, device=None,
                               dtype: Optional[torch.dtype] = None) -> MultibodyModel:
    """The port's :class:`MultibodyModel` from a model's leaves as numpy
    arrays (``MULTIBODY_LEAVES``) and its static tree: ``joints`` as
    (jtype, axis) pairs, ``parents`` as joint indices (-1 for the world),
    ``frames`` as (name, parent_joint) pairs. ``dtype`` defaults to that
    of ``arrays["mass"]``."""
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, dtype=np.asarray(arrays["mass"]).dtype)).dtype
    return MultibodyModel.create(
        *(arrays[k] for k in MULTIBODY_LEAVES),
        joints=tuple(JointSpec(jtype, None if axis is None else tuple(float(a) for a in axis))
                     for jtype, axis in joints),
        parents=tuple(int(p) for p in parents),
        frames=tuple(FrameSpec(name, int(j)) for name, j in frames),
        dtype=dtype, device=device)
