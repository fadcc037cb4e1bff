"""Cost library (port of ``aligator_tpu.costs``): quadratic costs,
residual (Gauss-Newton) costs with their state and control forms,
constants, log barriers, direct sums and weighted stacks.

Costs are dataclasses whose tensor fields are weights (stackable over the
horizon). Gradients and Hessians are taken w.r.t. tangent perturbations:
``torch.func.grad``/``hessian`` by default, closed forms where the class
is quadratic.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
from torch.func import grad, hessian

from aligator_tpu_torch.manifolds.base import Manifold
from aligator_tpu_torch.manifolds.product import block_diag
from aligator_tpu_torch.utils.tree import static_field


@dataclasses.dataclass(frozen=True)
class Cost:
    """Base cost ℓ(x, u)."""

    def value(self, space: Manifold, x, u) -> torch.Tensor:
        raise NotImplementedError

    def _tangent_fn(self, space: Manifold, x, u):
        def g(dz):
            dx, du = dz[: space.ndx], dz[space.ndx :]
            return self.value(space, space.integrate(x, dx), u + du)

        return g

    def _zero_tangent(self, space, x, u):
        dt = torch.promote_types(x.dtype, u.dtype)
        return torch.zeros(space.ndx + u.shape[-1], dtype=dt, device=x.device)

    def gradients(self, space: Manifold, x, u):
        """(Lx (ndx,), Lu (nu,)) — tangent-space gradient."""
        g = grad(self._tangent_fn(space, x, u))(self._zero_tangent(space, x, u))
        return g[: space.ndx], g[space.ndx :]

    def derivatives(self, space: Manifold, x, u):
        """(Lx, Lu, Lxx, Lxu, Luu) in one call: what the problem layer
        asks for, so a cost can share work between the two orders."""
        return (*self.gradients(space, x, u), *self.hessians(space, x, u))

    def hessians(self, space: Manifold, x, u):
        """(Lxx, Lxu, Luu) — exact tangent-space Hessian blocks."""
        ndx = space.ndx
        H = hessian(self._tangent_fn(space, x, u))(self._zero_tangent(space, x, u))
        return H[:ndx, :ndx], H[:ndx, ndx:], H[ndx:, ndx:]


@dataclasses.dataclass(frozen=True)
class QuadraticCost(Cost):
    """½ xᵀWx x + ½ uᵀWu u + xᵀN u + qxᵀx + quᵀu + c (vector-space states).
    Gradients and Hessians are the closed forms, identical to AD's."""

    Wx: torch.Tensor
    Wu: torch.Tensor
    qx: torch.Tensor
    qu: torch.Tensor
    N: torch.Tensor
    c: torch.Tensor

    @classmethod
    def create(cls, Wx, Wu, qx=None, qu=None, N=None, c=0.0):
        Wx = torch.as_tensor(Wx)
        Wu = torch.as_tensor(Wu, dtype=Wx.dtype, device=Wx.device)
        nx, nu = Wx.shape[-1], Wu.shape[-1]
        t = lambda a: torch.as_tensor(a, dtype=Wx.dtype, device=Wx.device)
        return cls(
            Wx=Wx,
            Wu=Wu,
            qx=Wx.new_zeros(nx) if qx is None else t(qx),
            qu=Wx.new_zeros(nu) if qu is None else t(qu),
            N=Wx.new_zeros((nx, nu)) if N is None else t(N),
            c=t(c),
        )

    def value(self, space, x, u):
        return (0.5 * x @ self.Wx @ x + 0.5 * u @ self.Wu @ u + x @ self.N @ u
                + self.qx @ x + self.qu @ u + self.c)

    def gradients(self, space, x, u):
        return (self.Wx @ x + self.N @ u + self.qx,
                self.Wu @ u + self.N.T @ x + self.qu)

    def hessians(self, space, x, u):
        return self.Wx, self.N, self.Wu


@dataclasses.dataclass(frozen=True)
class QuadraticResidualCost(Cost):
    """½ ‖r(x, u)‖²_W with the Gauss-Newton Hessian JᵀWJ."""

    residual: Any  # a StageFunction
    W: torch.Tensor

    def value(self, space, x, u):
        r = self.residual.value(x, u)
        return 0.5 * r @ self.W @ r

    def gradients(self, space, x, u):
        return self.derivatives(space, x, u)[:2]

    def hessians(self, space, x, u):
        return self.derivatives(space, x, u)[2:]

    def derivatives(self, space, x, u):
        r, Jx = self.residual.value_and_jac_x(space, x, u)
        Ju = self.residual.jac_u(space, x, u)
        Wr, WJx, WJu = self.W @ r, self.W @ Jx, self.W @ Ju
        return Jx.mT @ Wr, Ju.mT @ Wr, Jx.mT @ WJx, Jx.mT @ WJu, Ju.mT @ WJu


def QuadraticStateCost(space: Manifold, target, W) -> QuadraticResidualCost:
    """½‖x ⊖ x_ref‖²_W."""
    from aligator_tpu_torch.functions.basic import StateErrorResidual

    return QuadraticResidualCost(
        residual=StateErrorResidual(target=torch.as_tensor(target), space=space),
        W=torch.as_tensor(W))


def QuadraticControlCost(target, W) -> QuadraticResidualCost:
    """½‖u − u_ref‖²_W."""
    from aligator_tpu_torch.functions.basic import ControlErrorResidual

    return QuadraticResidualCost(residual=ControlErrorResidual(target=torch.as_tensor(target)),
                                 W=torch.as_tensor(W))


@dataclasses.dataclass(frozen=True)
class ConstantCost(Cost):
    """A fixed value; zero gradients and Hessians."""

    const: torch.Tensor

    def value(self, space, x, u):
        return self.const

    def gradients(self, space, x, u):
        return x.new_zeros(space.ndx), x.new_zeros(u.shape[-1])

    def hessians(self, space, x, u):
        ndx, nu = space.ndx, u.shape[-1]
        return x.new_zeros((ndx, ndx)), x.new_zeros((ndx, nu)), x.new_zeros((nu, nu))


@dataclasses.dataclass(frozen=True)
class LogResidualCost(Cost):
    """−Σ wᵢ log rᵢ(x, u); derivatives by the base class's AD."""

    residual: Any
    weights: torch.Tensor

    def value(self, space, x, u):
        return -(self.weights * torch.log(self.residual.value(x, u))).sum(-1)


@dataclasses.dataclass(frozen=True)
class RelaxedLogBarrierCost(Cost):
    """Relaxed log barrier: −w log r for r ≥ δ, and below the threshold δ
    the quadratic extension w(½(((r − 2δ)/δ)² − 1) − log δ)."""

    residual: Any
    weights: torch.Tensor
    threshold: torch.Tensor

    def value(self, space, x, u):
        r = self.residual.value(x, u)
        d = self.threshold
        sq = (r - 2.0 * d) / d
        below = self.weights * (0.5 * (sq * sq - 1.0) - torch.log(d))
        above = -self.weights * torch.log(torch.maximum(r, d))
        return torch.where(r < d, below, above).sum(-1)


def jsl_block_diag(a, b):
    """The block-diagonal matrix [[a, 0], [0, b]] of two 2-D blocks."""
    return block_diag(a, b)


@dataclasses.dataclass(frozen=True)
class DirectSumCost(Cost):
    """ℓ₁(x₁, u₁) + ℓ₂(x₂, u₂) on a two-factor ``CartesianProduct`` state;
    the control splits at ``nu1``."""

    c1: Any
    c2: Any
    nu1: int = static_field(default=0)

    def _split(self, space, x, u):
        s1, s2 = space.components
        return (s1, x[..., :s1.nx], u[..., :self.nu1],
                s2, x[..., s1.nx:], u[..., self.nu1:])

    def value(self, space, x, u):
        s1, x1, u1, s2, x2, u2 = self._split(space, x, u)
        return self.c1.value(s1, x1, u1) + self.c2.value(s2, x2, u2)

    def gradients(self, space, x, u):
        s1, x1, u1, s2, x2, u2 = self._split(space, x, u)
        g1x, g1u = self.c1.gradients(s1, x1, u1)
        g2x, g2u = self.c2.gradients(s2, x2, u2)
        return torch.cat([g1x, g2x], dim=-1), torch.cat([g1u, g2u], dim=-1)

    def hessians(self, space, x, u):
        s1, x1, u1, s2, x2, u2 = self._split(space, x, u)
        H1 = self.c1.hessians(s1, x1, u1)
        H2 = self.c2.hessians(s2, x2, u2)
        return tuple(jsl_block_diag(a, b) for a, b in zip(H1, H2))


@dataclasses.dataclass(frozen=True)
class CostStack(Cost):
    """Weighted sum of costs. The components are a tuple of fixed length;
    the weights are tensor leaves (per stage once stacked)."""

    components: Tuple[Any, ...]
    weights: Tuple[Any, ...]

    @classmethod
    def create(cls, *pairs):
        comps, w = zip(*pairs) if pairs else ((), ())
        return cls(components=tuple(comps),
                   weights=tuple(torch.as_tensor(x, dtype=torch.float64) for x in w))

    def value(self, space, x, u):
        total = 0.0
        for c, w in zip(self.components, self.weights):
            total = total + w * c.value(space, x, u)
        return total

    def gradients(self, space, x, u):
        return self.derivatives(space, x, u)[:2]

    def hessians(self, space, x, u):
        return self.derivatives(space, x, u)[2:]

    def derivatives(self, space, x, u):
        out = (0.0,) * 5
        for c, w in zip(self.components, self.weights):
            out = tuple(a + w * b for a, b in zip(out, c.derivatives(space, x, u)))
        return out
