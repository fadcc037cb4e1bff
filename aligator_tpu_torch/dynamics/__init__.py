from aligator_tpu_torch.dynamics.base import ODE, ExplicitDynamics
from aligator_tpu_torch.dynamics.implicit import (
    ImplicitDynamics,
    ImplicitToExplicit,
    MidpointIntegrator,
    MidpointIntegratorExplicit,
    newton_raphson,
)
from aligator_tpu_torch.dynamics.integrators import (
    EulerIntegrator,
    RK2Integrator,
    RK4Integrator,
    SemiImplEulerIntegrator,
)
from aligator_tpu_torch.dynamics.linear import LinearDiscreteDynamics, LinearODE
from aligator_tpu_torch.dynamics.misc import (
    DirectSumExplicitDynamics,
    WheeledInvertedPendulumDynamics,
)
