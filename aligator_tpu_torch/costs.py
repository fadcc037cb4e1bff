"""Cost library (port of part of ``aligator_tpu.costs``: ``Cost`` and
``QuadraticCost``; the residual, log-barrier, direct-sum and stack costs
wait in ROADMAP queue A).

Costs are dataclasses whose tensor fields are weights (stackable over the
horizon). Gradients and Hessians are taken w.r.t. tangent perturbations:
``torch.func.grad``/``hessian`` by default, closed forms where the class
is quadratic.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import grad, hessian

from aligator_tpu_torch.manifolds.base import Manifold


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
