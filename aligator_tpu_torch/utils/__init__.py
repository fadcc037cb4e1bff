from aligator_tpu_torch.utils.device import full_f32_matmuls, resolve_device
from aligator_tpu_torch.utils.profiling import named_scope
from aligator_tpu_torch.utils.tree import (
    static_field,
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_where,
)
