"""The frozen cost functions of K1 and K2 against hand counts at the lqr56
widths (nx = 56, nu = nc = 22, N = 100, one refinement step)."""

import pytest

from portbench.roofline import backward_cost, bound_ms, forward_cost


def test_k1_bound_at_b256():
    ms, by = bound_ms(*backward_cost(256, 101, 56, 22, 22, 1))
    assert by == "operations" and ms == pytest.approx(0.816, abs=5e-4)


def test_k2_bound_at_b256():
    ms, by = bound_ms(*forward_cost(256, 101, 56, 22, 22))
    assert by == "bytes" and ms == pytest.approx(0.279, abs=5e-4)


def test_k2_bytes_by_hand():
    # a knot reads K, Z (22×56 each), Acl and Vxx (56×56 each), kff, zff, yff, vx
    # and writes x, λ, u, v: (2·22·56 + 2·56² + 2·22 + 2·56 + 2·56 + 22 + 22) floats
    per_knot = 2 * 22 * 56 + 2 * 56 * 56 + 22 + 22 + 2 * 56 + 2 * 56 + 22 + 22
    nbytes, _ = forward_cost(1, 101, 56, 22, 22)
    assert nbytes == 4.0 * (101 * per_knot + 2 * 56)


def test_costs_scale_with_the_batch():
    for cost in (lambda B: backward_cost(B, 196, 56, 22, 0, 1),
                 lambda B: forward_cost(B, 196, 56, 22, 0)):
        b1, f1 = cost(1)
        b64, f64 = cost(64)
        assert b64 == pytest.approx(64 * b1) and f64 == pytest.approx(64 * f1)
