"""The lqr56 problem built by the reference's copy from the benchmark's inputs."""

from __future__ import annotations

import torch

from portbench.core import load
from portbench.reference.port.convert import problem_from_numpy


def problem(sizes: dict, inp: dict, batch: int, dtype, device):
    a = load("configs", "lqr56").arrays(sizes, inp)
    return problem_from_numpy(a["A"], a["B"], a["c"], a["Q"], a["R"], a["Qf"],
                              torch.zeros(batch, sizes["nx"], dtype=torch.float64).numpy(),
                              sizes["nsteps"], a["lower"], a["upper"], device=device,
                              dtype=dtype)
