from aligator_tpu_torch.solvers.fddp import FDDPResults, FDDPSettings, fddp_solve
from aligator_tpu_torch.solvers.linesearch import (
    FilterState,
    LinesearchOptions,
    armijo_run,
    filter_init,
    filter_run,
)
from aligator_tpu_torch.solvers.proxddp import (
    ProxDDPResults,
    ProxDDPSettings,
    proxddp_solve,
    proxddp_solve_checked,
)
