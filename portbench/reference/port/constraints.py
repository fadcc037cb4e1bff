"""Constraint sets (port of ``aligator_tpu.constraints``).

Sets are stateless frozen dataclasses with elementwise torch methods on
the trailing axis; the prox parameter µ is an explicit argument. The
active set is a float mask (1.0 = active), so Jacobian masking is a
broadcast multiply.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    """Base set; methods act on the trailing axis of z."""

    def evaluate(self, zproj: torch.Tensor) -> torch.Tensor:
        """Nonsmooth penalty at the projected point (0 for indicators)."""
        return zproj.new_zeros(zproj.shape[:-1])

    def projection(self, z: torch.Tensor, mu) -> torch.Tensor:
        raise NotImplementedError

    def normal_cone_projection(self, z: torch.Tensor, mu) -> torch.Tensor:
        return z - self.projection(z, mu)

    def active_set(self, z: torch.Tensor, mu) -> torch.Tensor:
        raise NotImplementedError

    def apply_normal_jacobian_mask(self, z, J, mu):
        return self.active_set(z, mu)[..., None] * J

    def moreau_envelope(self, zin, mu):
        """M_{µg}(z) = g(prox(z)) + 1/(2µ)‖z − prox(z)‖²."""
        zproj = self.normal_cone_projection(zin, mu)
        return self.evaluate(zin - zproj) + 0.5 / mu * (zproj * zproj).sum(-1)


@dataclasses.dataclass(frozen=True)
class EqualityConstraint(ConstraintSet):
    """{0}."""

    def projection(self, z, mu):
        return torch.zeros_like(z)

    def normal_cone_projection(self, z, mu):
        return z

    def active_set(self, z, mu):
        return torch.ones_like(z)


@dataclasses.dataclass(frozen=True)
class NegativeOrthant(ConstraintSet):
    """h ≤ 0."""

    def projection(self, z, mu):
        return torch.clamp(z, max=0.0)

    def normal_cone_projection(self, z, mu):
        return torch.clamp(z, min=0.0)

    def active_set(self, z, mu):
        return (z > 0.0).to(z.dtype)


@dataclasses.dataclass(frozen=True)
class BoxConstraint(ConstraintSet):
    """z ∈ [lower, upper]; the bounds are static tuples, made into tensors
    once per dtype and device (not on every projection)."""

    lower: tuple
    upper: tuple
    _tensors: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False, compare=False)

    def _bounds(self, z):
        key = (z.dtype, z.device)
        if key not in self._tensors:
            self._tensors[key] = (
                torch.tensor(self.lower, dtype=z.dtype, device=z.device),
                torch.tensor(self.upper, dtype=z.dtype, device=z.device))
        return self._tensors[key]

    def projection(self, z, mu):
        lo, hi = self._bounds(z)
        return torch.minimum(torch.maximum(z, lo), hi)

    def active_set(self, z, mu):
        lo, hi = self._bounds(z)
        return ((z > hi) | (z < lo)).to(z.dtype)


@dataclasses.dataclass(frozen=True)
class L1Penalty(ConstraintSet):
    """The composite penalty λ‖r‖₁ through its soft-thresholding prox;
    ``scale`` is the weight λ: prox_{µλ|·|}(z) = sign(z)·max(|z| − µλ, 0)."""

    scale: float = 1.0

    def evaluate(self, zproj):
        return self.scale * zproj.abs().sum(-1)

    def projection(self, z, mu):
        return torch.sign(z) * torch.clamp(z.abs() - mu * self.scale, min=0.0)

    def active_set(self, z, mu):
        return (z.abs() <= mu * self.scale).to(z.dtype)


@dataclasses.dataclass(frozen=True)
class ConstraintSetProduct(ConstraintSet):
    """Cartesian product of sets acting on contiguous slices of the
    stacked multiplier vector; ``dims`` are static."""

    sets: tuple
    dims: tuple

    def _split(self, z):
        out, i = [], 0
        for n in self.dims:
            out.append(z[..., i : i + n])
            i += n
        return out

    def evaluate(self, zproj):
        return sum(s.evaluate(zz) for s, zz in zip(self.sets, self._split(zproj)))

    def projection(self, z, mu):
        return torch.cat(
            [s.projection(zz, mu) for s, zz in zip(self.sets, self._split(z))], -1)

    def normal_cone_projection(self, z, mu):
        return torch.cat(
            [s.normal_cone_projection(zz, mu)
             for s, zz in zip(self.sets, self._split(z))], -1)

    def active_set(self, z, mu):
        return torch.cat(
            [s.active_set(zz, mu) for s, zz in zip(self.sets, self._split(z))], -1)
