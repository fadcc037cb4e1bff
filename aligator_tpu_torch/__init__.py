"""aligator_tpu_torch — the PyTorch/CUDA port of ``aligator_tpu``.

Batched constrained trajectory optimization (ProxDDP over box-constrained
LQR-class problems, the proximal Riccati recursion and the MPC step) in
PyTorch, with the fused Riccati sweeps as hand-written CUDA kernels for
Hopper (``csrc/``). Every tensor carries an explicit leading batch axis
where the JAX package uses ``jax.vmap``.

The package imports ``torch`` and ``numpy`` only: never ``jax`` and
nothing of ``aligator_tpu``. Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from aligator_tpu_torch import gar as gar
from aligator_tpu_torch import linalg as linalg
from aligator_tpu_torch import utils as utils

__version__ = "0.1.0"
