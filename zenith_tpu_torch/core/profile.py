"""Profiling hooks (reference zenith-core/src/profile.rs:1-4 + the
``#[profiling::function]`` annotations sprinkled across the reference;
torch port of zenith_tpu/core/profile.py).

``initialize(trace_dir=...)`` starts a ``torch.profiler`` trace of the host
and, where there is one, the CUDA device (written as a Chrome trace on
``shutdown``); ``session()`` profiles a block without writing a trace and
yields the profiler, for reading ``key_averages()`` in a measurement.
While either is active, ``scope(name)`` / ``@profiled`` annotate host spans
with ``torch.profiler.record_function`` plus an NVTX range on CUDA, so graph
build / compile / submit phases and every render-graph node show up beside
the device timeline.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Any, Callable, Iterator

_active_trace_dir: str | None = None
_profiler = None


def _start(cpu: bool = True):
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU] if cpu else []
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    return prof


def initialize(trace_dir: str | None = None) -> None:
    """Start profiling. No-op unless ``trace_dir`` is given (reference
    profile.rs disables puffin the same way)."""
    global _active_trace_dir, _profiler
    if trace_dir is None:
        return
    _profiler = _start()
    _active_trace_dir = trace_dir


@contextlib.contextmanager
def session(cpu: bool = True) -> Iterator[Any]:
    """Profile the enclosed block (host spans, scopes and CUDA kernels)
    without writing a trace; yields the ``torch.profiler.profile``, whose
    ``events()`` / ``key_averages()`` are complete once the block exits.
    ``cpu=False`` records the CUDA kernels only, which slows the host far
    less (no per-operator events)."""
    global _profiler
    if _profiler is not None:
        raise RuntimeError("a profiling session is already active")
    _profiler = prof = _start(cpu)
    try:
        yield prof
    finally:
        _profiler = None
        prof.__exit__(None, None, None)


def shutdown() -> None:
    global _active_trace_dir, _profiler
    if _active_trace_dir is not None:
        _profiler.__exit__(None, None, None)
        os.makedirs(_active_trace_dir, exist_ok=True)
        _profiler.export_chrome_trace(os.path.join(_active_trace_dir, "trace.json"))
        _profiler = None
        _active_trace_dir = None


@contextlib.contextmanager
def scope(name: str) -> Iterator[None]:
    """Named host-side span (analog of ``profiling::scope!``)."""
    if _profiler is None:
        yield
        return
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def profiled(fn: Callable[..., Any]) -> Callable[..., Any]:
    """Decorator analog of ``#[profiling::function]``."""

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        with scope(fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapper
