from aligator_tpu_torch.solvers.linesearch import LinesearchOptions, armijo_run
from aligator_tpu_torch.solvers.proxddp import (
    ProxDDPResults,
    ProxDDPSettings,
    proxddp_solve,
)
