from aligator_tpu_torch.functions.base import (
    StageFunction,
    UnaryFunction,
    tangent_jac_x,
)
from aligator_tpu_torch.functions.basic import (
    ControlErrorResidual,
    StateErrorResidual,
)
from aligator_tpu_torch.functions.frames import FramePlacementResidual
