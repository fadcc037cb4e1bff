"""Frame task residuals on multibody states (port of part of
``aligator_tpu.functions.frames``: ``FramePlacementResidual``; the other
frame residuals wait in ROADMAP queue A)."""

from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd

from aligator_tpu_torch.functions.base import UnaryFunction
from aligator_tpu_torch.multibody.algorithms import frame_placement
from aligator_tpu_torch.multibody.model import MultibodyModel
from aligator_tpu_torch.multibody.spatial import SE3T, se3_inv, se3_log, se3_mul
from aligator_tpu_torch.utils.tree import static_field


@dataclasses.dataclass(frozen=True)
class FramePlacementResidual(UnaryFunction):
    """r = log6(M_ref⁻¹ · M_frame(q)) ∈ R⁶, for configuration or
    phase-space states. Its Jacobian is the base class's forward-mode AD
    through the kinematic chain of the frame."""

    model: MultibodyModel
    ref_R: torch.Tensor  # (3, 3)
    ref_p: torch.Tensor  # (3,)
    frame_id: int = static_field()

    def value_x(self, x):
        M = frame_placement(self.model, x[..., :self.model.nq], self.frame_id)
        return se3_log(se3_mul(se3_inv(SE3T(self.ref_R, self.ref_p)), M))

    def value_and_jac_x(self, space, x, u):
        """The residual and its tangent Jacobian from one forward-mode pass
        (x ⊕ 0 = x exactly, so the value is the plain one)."""
        z = x.new_zeros(space.ndx)

        def f(d):
            r = self.value_x(space.integrate(x, d))
            return r, r

        J, r = jacfwd(f, has_aux=True)(z)
        return r, J
