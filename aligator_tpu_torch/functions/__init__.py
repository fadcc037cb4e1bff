"""Residual function library (port of ``aligator_tpu.functions``): every
name the JAX package exports, the contact and centroidal families
included."""

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
from aligator_tpu_torch.functions.centroidal import (
    AngularAccelerationResidual,
    AngularMomentumResidual,
    CentroidalAccelerationResidual,
    CentroidalCoMResidual,
    CentroidalFrictionConeResidual,
    CentroidalWrapperResidual,
    CentroidalWrenchConeResidual,
    LinearMomentumResidual,
)
from aligator_tpu_torch.functions.contact import (
    ContactForceResidual,
    MultibodyFrictionConeResidual,
    MultibodyWrenchConeResidual,
    wrench_cone_matrix,
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
