"""The port's tracing: profiler ranges, a span log on the profiler's clock,
and counters.

The JAX package labels its hot functions with ``jax.named_scope``; here the
same names (``named_scope``, ``span``) become
``torch.profiler.record_function`` ranges, which show up in
``torch.profiler`` traces (host operations and the CUDA kernels they
launch). While a profiler collects, each span also appends a record to an
in-memory log (``spans()``): its name, start and end in Unix-epoch
nanoseconds from ``time.time_ns()`` (the clock torch.profiler stamps its
events with, so the records line up with the device trace), the index of
the enclosing span on the same thread, the call it belongs to (the index
of the outermost enclosing span: ``mpc.step`` or ``proxddp.solve`` on the
solver's path) and its attributes. With no profiler collecting a span is
one flag read: no range, no record, no device work.

Counters (``count``, ``counters()``) are always on. ``host_flag`` and
``host_sync`` mark the places where the host waits for the device: each
counts ``proxddp.host_sync.<site>`` and, while a profiler collects, logs a
``proxddp.sync`` span around the wait. ``docs/profiling.md`` lists every
span, attribute and counter of the port.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from dataclasses import dataclass
from typing import Optional

import torch

SYNC = "proxddp.sync"
SYNC_COUNTER = "proxddp.host_sync."

_recording = torch.autograd._profiler_enabled  # per thread, like the ranges
_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_log: list = []
_counts: dict = {}
_open = threading.local()  # .stack: this thread's open records, innermost last


@dataclass
class Span:
    """One record of the log; ``end_ns`` is None while the span is open."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]  # log index of the enclosing span on the thread
    call: int  # log index of the outermost enclosing span (its own for a root)
    thread: int
    attrs: dict
    index: int  # its own place in the log


def _stack() -> list:
    st = getattr(_open, "stack", None)
    if st is None:
        st = _open.stack = []
    return st


class _Range:
    """A profiler range and its log record (built only while recording)."""

    __slots__ = ("name", "attrs", "rec", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        start = time.time_ns()
        with _lock:
            i = len(_log)
            parent = stack[-1] if stack else None
            self.rec = Span(self.name, start, None, None if parent is None else parent.index,
                            i if parent is None else parent.call, threading.get_ident(),
                            self.attrs, i)
            _log.append(self.rec)
        stack.append(self.rec)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.rec.end_ns = time.time_ns()
        _stack().pop()
        return False


def span(name: str, **attrs):
    """Context manager: a range ``name`` with ``attrs`` in the log while a
    profiler collects, nothing otherwise."""
    return _Range(name, attrs) if _recording() else _OFF


def named_scope(name: str):
    """Decorator: run ``f`` inside ``span(name)``."""

    def deco(f):
        @functools.wraps(f)
        def g(*args, **kwargs):
            if not _recording():
                return f(*args, **kwargs)
            with _Range(name, {}):
                return f(*args, **kwargs)

        return g

    return deco


def annotate(**attrs) -> None:
    """Add ``attrs`` to the innermost open span of this thread (while a
    profiler collects)."""
    if _recording():
        stack = _stack()
        if stack:
            stack[-1].attrs.update(attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def host_sync(site: str, n: int = 1):
    """Context manager around a statement that makes the host wait for the
    device ``n`` times (a host read, a boolean mask, a pageable copy):
    counts them under ``proxddp.host_sync.<site>`` and spans the wait."""
    count(SYNC_COUNTER + site, n)
    return span(SYNC, site=site, n=n)


def host_flag(t: torch.Tensor, site: str) -> bool:
    """``bool(t)``, one host sync counted at ``site``."""
    with host_sync(site):
        return bool(t)


def spans() -> list:
    """The log: every ``Span`` recorded since the last ``reset``, in order
    of entry (a record's ``index`` is its place here)."""
    with _lock:
        return list(_log)


def counters() -> dict:
    """A copy of every counter."""
    with _lock:
        return dict(_counts)


def reset() -> None:
    """Empty the log and the counters (call it outside any span)."""
    with _lock:
        _log.clear()
        _counts.clear()

