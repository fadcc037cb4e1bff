"""Residual function library (port of ``aligator_tpu.functions``; its
contact and centroidal families wait in ROADMAP A32)."""

from aligator_tpu_torch.functions.autodiff import (
    CostFiniteDifference,
    DynamicsFiniteDifferenceHelper,
    FiniteDifferenceHelper,
)
from aligator_tpu_torch.functions.base import (
    StageFunction,
    UnaryFunction,
    tangent_jac_x,
)
from aligator_tpu_torch.functions.basic import (
    ControlBoxFunction,
    ControlErrorResidual,
    FunctionSlice,
    LinearFunction,
    LinearFunctionComposition,
    StateErrorResidual,
)
from aligator_tpu_torch.functions.frames import (
    CenterOfMassTranslationResidual,
    CenterOfMassVelocityResidual,
    CentroidalMomentumDerivativeResidual,
    CentroidalMomentumResidual,
    DCMPositionResidual,
    FlyHighResidual,
    FrameCollisionResidual,
    FrameEqualityResidual,
    FramePlacementResidual,
    FrameTranslationResidual,
    FrameVelocityResidual,
    GravityCompensationResidual,
)
