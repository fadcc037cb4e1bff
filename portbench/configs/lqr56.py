"""lqr56: the box-constrained LQR at Talos widths (upstream bench/lqr.cpp,
the repository's bench.py:44-82). The dynamics A, B, c, shared by the
batch, are drawn once from the configuration's fixed key, as bench.py
draws them from its seed 0: they are the model, and the work of a solve
depends on them (its line search). The run's seed draws the initial (or
measured) states of every call."""

from __future__ import annotations

import math

import torch


def inputs(sizes: dict, gen: torch.Generator, device) -> dict:
    """A = I + 0.05·randn/√nx, B = randn/√nx, c = 0.01·randn, in float64,
    from the key ``dynamics_key`` (not the run's stream ``gen``)."""
    nx, nu = sizes["nx"], sizes["nu"]
    gen = torch.Generator(device=device).manual_seed(sizes["dynamics_key"])
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=torch.float64, device=device)
    return dict(A=torch.eye(nx, dtype=torch.float64, device=device) + 0.05 * rnd(nx, nx)
                / math.sqrt(nx), B=rnd(nx, nu) / math.sqrt(nx), c=0.01 * rnd(nx))


def noise(sizes: dict, gen: torch.Generator, batch: int, scale: float, device) -> torch.Tensor:
    """(batch, nx) float32: the initial (or measured) states themselves."""
    return scale * torch.randn((batch, sizes["nx"]), generator=gen, device=device)


def arrays(sizes: dict, inp: dict) -> dict:
    """The problem's arrays as numpy, for either side's builder."""
    nx, nu, box = sizes["nx"], sizes["nu"], sizes["box"]
    eye = lambda n: torch.eye(n, dtype=torch.float64)
    return dict(A=inp["A"].cpu().numpy(), B=inp["B"].cpu().numpy(), c=inp["c"].cpu().numpy(),
                Q=(0.01 * eye(nx)).numpy(), R=(0.01 * eye(nu)).numpy(), Qf=eye(nx).numpy(),
                lower=[-box] * nu, upper=[box] * nu)


def program_problem(sizes: dict, inp: dict, batch: int, dtype, device):
    """The port's problem for ``batch`` instances (x0 zero: each call sets its own)."""
    from aligator_tpu_torch.convert import problem_from_numpy

    a = arrays(sizes, inp)
    return problem_from_numpy(a["A"], a["B"], a["c"], a["Q"], a["R"], a["Qf"],
                              torch.zeros(batch, sizes["nx"], dtype=torch.float64).numpy(),
                              sizes["nsteps"], a["lower"], a["upper"], device=device,
                              dtype=dtype)
