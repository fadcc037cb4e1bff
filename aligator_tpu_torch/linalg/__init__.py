from aligator_tpu_torch.linalg.schur import (
    SaddleFactor,
    kkt_factor,
    kkt_matvec,
    kkt_solve,
    kkt_solve_refined,
)
from aligator_tpu_torch.linalg.spd import (
    SPDFactor,
    spd_factor,
    spd_solve,
    spd_solve_factored,
)
from aligator_tpu_torch.linalg.block_tridiag import (
    block_tridiag_matmul,
    block_tridiag_solve,
)
