"""GAR — the constrained linear-quadratic subproblem layer (port of
``aligator_tpu.gar``): the LQ problem as batched horizon-stacked tensors,
the serial proximal Riccati recursion and the fused CUDA sweeps."""

from aligator_tpu_torch.gar.lqr_problem import LQRProblem, lqr_zeros
from aligator_tpu_torch.gar.riccati import (
    RiccatiFactors,
    backward,
    forward,
    solve as riccati_solve,
)
from aligator_tpu_torch.gar.utils import lqr_kkt_error, lqr_kkt_residuals
from aligator_tpu_torch.gar.fused_riccati import (
    backward as fused_backward,
    forward as fused_forward,
    solve as fused_solve,
)
