"""The talos walk built by the reference's copy (its own URDF copy, contact
set, schedule and costs) for a batch of x0."""

from __future__ import annotations

from portbench.reference.port.examples.talos_walk import create_walk_problem


def problem(sizes: dict, inp: dict, batch: int, dtype, device):
    prob, _ = create_walk_problem(sizes["T_ss"], sizes["T_ds"], dtype=dtype, device=device)
    return prob.replace_x0(prob.x0.expand(batch, -1).clone())
