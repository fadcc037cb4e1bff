"""Utilities: device policy, the iteration logger, profiling scopes and
tree helpers. The plotting helpers (``utils.plotting``) are imported on
their own, as in the JAX package, so that matplotlib stays optional."""

from aligator_tpu_torch.utils.device import full_f32_matmuls, resolve_device
from aligator_tpu_torch.utils.logger import print_headline, print_row
from aligator_tpu_torch.utils.profiling import named_scope
from aligator_tpu_torch.utils.tree import (
    static_field,
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_where,
)
