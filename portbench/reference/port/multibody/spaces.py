"""Multibody configuration and phase-space manifolds (port of
``aligator_tpu.multibody.spaces``)."""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.port.manifolds.base import Manifold
from portbench.reference.port.manifolds.product import block_diag
from portbench.reference.port.manifolds.tangent import TangentBundle
from portbench.reference.port.multibody.model import (
    MultibodyModel,
    configuration_difference,
    configuration_integrate,
)


@dataclasses.dataclass(frozen=True, eq=False)
class MultibodyConfiguration(Manifold):
    """Configuration space Q of a kinematic tree (nq coordinates, nv
    tangent). Its maps read only the static joint specs of ``model``; two
    spaces are equal only if they are the same object."""

    model: MultibodyModel

    @property
    def nx(self) -> int:
        return self.model.nq

    @property
    def ndx(self) -> int:
        return self.model.nv

    def integrate(self, x, v):
        return configuration_integrate(self.model, x, v)

    def difference(self, x0, x1):
        return configuration_difference(self.model, x0, x1)

    def neutral(self, dtype=torch.float64, device=None):
        return self.model.neutral_q(dtype, device)

    def normalize(self, x):
        parts = []
        for r in self.model.runs:
            qr = x[..., r.q0:r.q1]
            if r.jtype == "freeflyer":
                quat = qr[..., 3:]
                qr = torch.cat([qr[..., :3],
                                quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)],
                               dim=-1)
            parts.append(qr)
        return torch.cat(parts, dim=-1)

    def _jac(self, one_dof, ff):
        """Block-diagonal Jacobian: ``ff()`` for a free flyer (the base
        class's AD on SE(3) alone), ±I for each run of 1-dof joints."""
        blocks = []
        for r in self.model.runs:
            blocks.append(ff(r) if r.jtype == "freeflyer" else one_dof(r.v1 - r.v0))
        return block_diag(*blocks)

    def jintegrate(self, x, v, arg):
        from portbench.reference.port.manifolds.lie import SE3

        eye = lambda n: torch.eye(n, dtype=v.dtype, device=v.device)
        return self._jac(eye, lambda r: Manifold.jintegrate(
            SE3(), x[..., r.q0:r.q1], v[..., r.v0:r.v1], arg))

    def jdifference(self, x0, x1, arg):
        from portbench.reference.port.manifolds.lie import SE3

        sign = -1.0 if arg == 0 else 1.0
        eye = lambda n: sign * torch.eye(n, dtype=x0.dtype, device=x0.device)
        return self._jac(eye, lambda r: Manifold.jdifference(
            SE3(), x0[..., r.q0:r.q1], x1[..., r.q0:r.q1], arg))


def MultibodyPhaseSpace(model: MultibodyModel) -> TangentBundle:
    """Phase space TQ = (q, v), the tangent bundle of the configuration
    space."""
    return TangentBundle(MultibodyConfiguration(model))
