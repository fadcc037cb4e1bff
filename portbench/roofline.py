"""The least time the card could take for K1 (the fused backward Riccati
sweep) and K2 (the fused forward sweep), from their shapes alone.

A frozen copy of the repository's cost functions of the two sweeps: every
knot field read once, every output written once, and the arithmetic of the
sweep per knot (the terminal knot skips the A/B products). The bound is the
larger of the bytes over the HBM bandwidth and the float32 operations over
the float32 rate outside the tensor cores (the kernels use plain FMA), at the
published peaks of one H100 SXM (NVIDIA's data sheet, 700 W).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def backward_cost(B, L, nx, nu, nc, refine):
    """(bytes, flops) of K1 over B problems of L knots."""
    m = nx + 1
    knot_in = nx * nx * 2 + nx * nu * 2 + nu * nu + nc * nx + nc * nu + 2 * nx + nu + nc
    knot_out = nu * nx + nc * nx + 2 * nx * nx + nu + nc + 2 * nx
    solve = 2 * nu * nu * m + 4 * nu * nc * m + 2 * nc * nc * m
    kkt = (nu ** 3 / 3 + 2 * nu * nu * nc + 2 * nc * nc * nu + nc ** 3 / 3
           + (1 + refine) * solve + refine * (2 * nu * nu + 4 * nu * nc) * m)
    hats = (2 * nx * nx + 4 * nx ** 3 + 4 * nu * nx * nx + 2 * nx * nu * nu
            + 2 * nx * nx + 2 * nx * nu)
    out = 2 * nx * nu * m + 2 * nx * (nu + nc) * m
    flops = B * (L * (kkt + out) + (L - 1) * hats)
    return 4.0 * B * (L * (knot_in + knot_out) + 1), flops


def forward_cost(B, L, nx, nu, nc):
    """(bytes, flops) of one K2 sweep over B problems of L knots."""
    knot_in = nu * nx + nc * nx + 2 * nx * nx + nu + nc + 2 * nx
    knot_out = 2 * nx + nu + nc
    return 4.0 * B * (L * (knot_in + knot_out) + 2 * nx), 2.0 * B * L * (nu + nc + 2 * nx) * nx


def bound_ms(nbytes, flops):
    """(milliseconds, "bytes" or "operations"): the larger of the two."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")
