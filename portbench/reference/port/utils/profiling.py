"""Profiler zones.

The JAX package labels its hot functions with ``jax.named_scope``; here
the same names become ``torch.profiler.record_function`` ranges, which
show up in ``torch.profiler`` traces (CPU ops and the CUDA kernels they
launch). With no profiler active a range costs a few microseconds.
"""

from __future__ import annotations

import functools

import torch


def named_scope(name: str):
    """Decorator: run ``f`` inside ``torch.profiler.record_function(name)``."""

    def deco(f):
        @functools.wraps(f)
        def g(*args, **kwargs):
            with torch.profiler.record_function(name):
                return f(*args, **kwargs)

        return g

    return deco
