from aligator_tpu_torch.dynamics.base import ODE, ExplicitDynamics
from aligator_tpu_torch.dynamics.linear import LinearDiscreteDynamics, LinearODE
