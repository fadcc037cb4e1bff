"""GAR — the constrained linear-quadratic subproblem layer (port of
``aligator_tpu.gar``): the LQ problem as batched horizon-stacked tensors,
the serial proximal Riccati recursion, the fused CUDA sweeps, and the
parallel (partitioned-condensing), stagewise-dense, associative-scan and
dense-KKT solvers."""

from aligator_tpu_torch.gar.lqr_problem import LQRProblem, lqr_zeros
from aligator_tpu_torch.gar.riccati import (
    RiccatiFactors,
    backward,
    forward,
    solve as riccati_solve,
)
from aligator_tpu_torch.gar.utils import (
    lqr_dense_matrix,
    lqr_kkt_error,
    lqr_kkt_residuals,
    random_lqr_problem,
)
from aligator_tpu_torch.gar.parallel import make_parallel_solver, parallel_solve
from aligator_tpu_torch.gar.dense import dense_solve
from aligator_tpu_torch.gar.stagedense import (
    StageDenseFactors,
    solve as stagedense_solve,
)
from aligator_tpu_torch.gar.assoc import solve as assoc_solve
from aligator_tpu_torch.gar.fused_riccati import (
    backward as fused_backward,
    forward as fused_forward,
    solve as fused_solve,
)
