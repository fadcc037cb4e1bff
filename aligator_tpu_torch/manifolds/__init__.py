from aligator_tpu_torch.manifolds.base import Manifold
from aligator_tpu_torch.manifolds.lie import SE2, SE3, SO2, SO3
from aligator_tpu_torch.manifolds.product import CartesianProduct
from aligator_tpu_torch.manifolds.tangent import TangentBundle
from aligator_tpu_torch.manifolds.vector import VectorSpace
