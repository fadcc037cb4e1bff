"""The systems a window can drive: the port (the program under test) and
the reference's copy put in its place (the control, or the reference
itself). Both build the configuration's problem from the benchmark's inputs
and hand out their modules by the port's own names (``"mpc"``,
``"solvers.proxddp"``, ``"problem"``, ...), so that a traffic kind drives
either through the same calls."""

from __future__ import annotations

import importlib

import torch

from portbench.core import load

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Program:
    """``aligator_tpu_torch``. ``module`` is looked up at each call, so that
    a test can put a broken module in its place."""

    name = "program"
    overrides: dict = {}  # settings the system imposes on the configuration's

    def __init__(self, config: str, sizes: dict, device):
        from aligator_tpu_torch.gar import fused_riccati

        self.cfg, self.sizes, self.device = load("configs", config), sizes, device
        self.dtype = DTYPES[sizes["dtype"]]
        self._fused = fused_riccati

    def module(self, name: str):
        return importlib.import_module(f"aligator_tpu_torch.{name}")

    def problem(self, inp: dict, batch: int):
        return self.cfg.program_problem(self.sizes, inp, batch, self.dtype, self.device)

    def settings(self, d: dict):
        return self.module("solvers.proxddp").ProxDDPSettings(**{**d, **self.overrides})

    def counters(self) -> dict:
        """The fused sweeps' launch counters (K1, K2)."""
        return {"k1_launches": self._fused.backward_sweep_batched.launches,
                "k2_sweeps": self._fused.forward_sweep_batched.launches}


class _Precise:
    """A module of the reference's copy whose functions set the system's
    precision before they run (a control's TF32 must not leak into, or
    miss, any of its products)."""

    def __init__(self, mod, before):
        self._mod, self._before = mod, before

    def __getattr__(self, key):
        value = getattr(self._mod, key)
        if not callable(value) or isinstance(value, type):
            return value

        def call(*a, **kw):
            self._before()
            return value(*a, **kw)

        return call


class Reference:
    """The reference's frozen copy: the serial Riccati recursion, in
    ``dtype``; ``tf32`` lets float32 products run in TF32 (the control)."""

    overrides = {"lq_solver": "serial"}

    def __init__(self, config: str, sizes: dict, device, dtype=torch.float64,
                 tf32: bool = False):
        self.builder, self.sizes, self.device = load("reference", config), sizes, device
        self.dtype, self.tf32 = dtype, tf32
        self.name = f"reference {str(dtype).split('.')[-1]}{' tf32' if tf32 else ''}"

    def _precision(self):
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def module(self, name: str):
        mod = importlib.import_module(f"portbench.reference.port.{name}")
        return _Precise(mod, self._precision)

    def problem(self, inp: dict, batch: int):
        self._precision()  # the problem's own products (placements) too
        return self.builder.problem(self.sizes, inp, batch, self.dtype, self.device)

    def settings(self, d: dict):
        return self.module("solvers.proxddp").ProxDDPSettings(**{**d, **self.overrides})

    def counters(self) -> dict:
        return {}
