from aligator_tpu_torch.manifolds.base import Manifold
from aligator_tpu_torch.manifolds.vector import VectorSpace
