"""Profiling hooks (reference zenith-core/src/profile.rs:1-4 + the
``#[profiling::function]`` annotations sprinkled across the reference;
torch port of zenith_tpu/core/profile.py).

``initialize(trace_dir=...)`` starts a ``torch.profiler`` trace of the host
and, where there is one, the CUDA device (written as a Chrome trace on
``shutdown``), and ``scope(name)`` / ``@profiled`` annotate host spans with
``torch.profiler.record_function`` plus an NVTX range on CUDA, so graph
build / compile / submit phases show up beside the device timeline.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Any, Callable, Iterator

_active_trace_dir: str | None = None
_profiler = None


def initialize(trace_dir: str | None = None) -> None:
    """Start profiling. No-op unless ``trace_dir`` is given (reference
    profile.rs disables puffin the same way)."""
    global _active_trace_dir, _profiler
    if trace_dir is None:
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _profiler = torch.profiler.profile(activities=activities)
    _profiler.__enter__()
    _active_trace_dir = trace_dir


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
    if _active_trace_dir is None:
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
