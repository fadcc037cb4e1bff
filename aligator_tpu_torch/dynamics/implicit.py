"""Implicit (DAE) dynamics (port of ``aligator_tpu.dynamics.implicit``):
residual models r(x, u, x⁺) = 0, the implicit midpoint rule, a
fixed-count Newton solve, and a wrapper exposing implicit dynamics as
explicit ones.

The JAX package's wrapper solves the residual under ``jax.lax.custom_root``
so that derivatives follow the implicit-function theorem. Here that rule
is an implicit step, as ``multibody.algorithms._fd_implicit`` writes its
own: the Newton solve runs on detached inputs, then a Newton step
s = J⁻¹ g(dz₀) is formed with the Jacobian of the residual detached and
the residual itself on the live inputs, and dz = dz₀ − (s − s̄) with s̄ the
detached s. Its value is dz₀, the JAX solve's own (also where the fixed
Newton count leaves a residual), and under ``torch.func.jacfwd`` /
``vmap`` its tangent is −J⁻¹ ∂g/∂θ · δθ: the implicit-function theorem's.
No ``torch.autograd.Function`` is used (ROADMAP A14: with
``generate_vmap_rule`` its JVP comes out wrong under ``vmap(jacfwd(·))``).
Nor is ``torch.linalg.solve``: under ``vmap`` its forward-mode derivative
comes out wrong too, NaN or wrong values (torch 2.13, batched or
unbatched matrix); the solves go through the explicit inverse of the
small Newton matrix, whose derivative under ``vmap`` is right.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.func import jacfwd

from aligator_tpu_torch.dynamics.base import ExplicitDynamics, tangents_kept
from aligator_tpu_torch.manifolds.base import Manifold
from aligator_tpu_torch.utils.tree import detached, static_field


@dataclasses.dataclass(frozen=True)
class ImplicitDynamics:
    """Discrete implicit dynamics r(x, u, x⁺) = 0 ∈ R^ndx."""

    def residual(self, space: Manifold, x, u, x_next) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class MidpointIntegrator(ImplicitDynamics):
    """The implicit midpoint rule on a manifold (symplectic, second order):
    r = (x⁺ ⊖ x)/h − ẋ(x ⊕ ½(x⁺ ⊖ x), u)."""

    ode: Any
    dt: torch.Tensor

    def residual(self, space, x, u, x_next):
        dx = space.difference(x, x_next)
        x_mid = space.integrate(x, 0.5 * dx)
        return dx / self.dt - self.ode.xdot(space, x_mid, u)


def _solve(J, r):
    """J⁻¹ r for a small square J, by the explicit inverse (see the module
    docstring)."""
    return torch.linalg.inv(J) @ r


def newton_raphson(fn, z0, iters: int = 10):
    """Fixed-count dense Newton z ← z − (∂fn/∂z)⁻¹ fn(z)."""
    z = z0
    for _ in range(iters):
        z = z - _solve(jacfwd(fn)(z), fn(z))
    return z


@dataclasses.dataclass(frozen=True)
class ImplicitToExplicit(ExplicitDynamics):
    """Implicit dynamics as x⁺ = forward(x, u): Newton on the residual in
    tangent coordinates around a predictor (explicit Euler when the model
    wraps an ODE), with implicit-function-theorem derivatives (see the
    module docstring)."""

    impl: ImplicitDynamics
    newton_iters: int = static_field(default=8)

    def forward(self, space, x, u):
        if hasattr(self.impl, "ode") and hasattr(self.impl, "dt"):
            x_guess = space.integrate(x, self.impl.dt * self.impl.ode.xdot(space, x, u))
        else:
            x_guess = x
        impl_d, x_d, u_d, xg_d = detached((self.impl, x, u, x_guess))

        def g_d(dz):
            return impl_d.residual(space, x_d, u_d, space.integrate(xg_d, dz))

        z0 = torch.zeros(space.ndx, dtype=torch.promote_types(x.dtype, u.dtype),
                         device=x.device)
        with tangents_kept():  # the Newton matrix is ∂g/∂dz through ẋ
            dz0 = newton_raphson(g_d, z0, self.newton_iters)
            J = jacfwd(g_d)(dz0)
        r = self.impl.residual(space, x, u, space.integrate(x_guess, dz0))
        step = _solve(J, r)
        return space.integrate(x_guess, dz0 - (step - step.detach()))


def MidpointIntegratorExplicit(ode, dt, newton_iters: int = 8):
    """The implicit midpoint rule packaged as explicit dynamics; a number
    ``dt`` becomes a float64 tensor (``build_problem`` casts it to the
    problem's dtype)."""
    dt = dt if isinstance(dt, torch.Tensor) else torch.tensor(dt, dtype=torch.float64)
    return ImplicitToExplicit(impl=MidpointIntegrator(ode=ode, dt=dt), newton_iters=newton_iters)
