from aligator_tpu_torch.linalg.schur import (
    SaddleFactor,
    kkt_factor,
    kkt_matvec,
    kkt_solve,
    kkt_solve_refined,
)
