"""talos_walk: the Talos-class humanoid walk on 6D sole contacts (upstream
bench/talos-walk.cpp, T_ss = 60, T_ds = 25, N = 195), built by the port's
``examples.talos_walk``. A batch of scenarios shares every stage leaf and
differs in x0: the half-sitting state with its joint velocities disturbed
by a draw from the run's seed."""

from __future__ import annotations

import torch


def inputs(sizes: dict, gen: torch.Generator, device) -> dict:
    return {}


def noise(sizes: dict, gen: torch.Generator, batch: int, scale: float, device) -> torch.Tensor:
    """(batch, nq + nv) float32: zero on the configuration, scale·N(0, 1) on
    the velocities."""
    nq, nv = sizes["nq"], sizes["nv"]
    dv = scale * torch.randn((batch, nv), generator=gen, device=device)
    return torch.cat([dv.new_zeros(batch, nq), dv], dim=1)


def program_problem(sizes: dict, inp: dict, batch: int, dtype, device):
    from aligator_tpu_torch.examples.talos_walk import create_walk_problem

    problem, _ = create_walk_problem(sizes["T_ss"], sizes["T_ds"], dtype=dtype, device=device)
    return problem.replace_x0(problem.x0.expand(batch, -1).clone())
