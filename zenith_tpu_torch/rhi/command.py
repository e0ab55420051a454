"""Command recording, immediate submission, uploads, deferred release
(torch port of zenith_tpu/rhi/command.py).

API parity with zenith-rhi's command/upload/defer_release modules, re-based
on what these objects mean under PyTorch:

- ``CommandEncoder`` (reference command.rs:92-249): recording is running
  tensor ops on the device's stream; the encoder is a thin façade used by
  lambda-node closures for parity with the reference's escape hatch
  (``encoder.custom(fn)``). Draw recording lives on the graphic-node
  context (rendergraph.GraphicNodeExecutionContext).
- ``CommandPool`` (command.rs:14-75): a stats-carrying stub so engine-level
  code matches the reference's per-frame pool reset flow.
- ``ImmediateCommandEncoder`` (command.rs:253-305): one-shot submit +
  blocking wait → run a function now and synchronize the device.
- ``UploadPool`` (upload.rs): the pool keeps the enqueue/flush shape; a
  flush copies the host arrays onto the device.
- ``DeferRelease`` (defer_release.rs): N-frame-delayed destruction is the
  caching allocator's job; the queue keeps LastFreedStats-style counters
  for the 1 Hz log line (main_loop.rs:146-162 parity).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from zenith_tpu_torch.rhi.device import NUM_BACK_BUFFERS, RenderDevice
from zenith_tpu_torch.rhi.resource import Buffer, BufferDesc, BufferUsage, Texture


class CommandPool:
    """(command.rs:14-75) Tracks resets for stats parity."""

    def __init__(self, device: RenderDevice, name: str = "pool"):
        self.device = device
        self.name = name
        self.resets = 0

    def reset(self) -> None:
        self.resets += 1


class CommandEncoder:
    """Traced-compute façade (command.rs:92-249)."""

    def __init__(self, device: RenderDevice):
        self.device = device
        self._recorded: List[Callable[..., Any]] = []

    def custom(self, fn: Callable[..., Any]) -> Any:
        """The reference's raw escape hatch (command.rs:237-242): run an
        arbitrary function on the device now."""
        return fn(self.device)


class ImmediateCommandEncoder:
    """One-shot submit + wait (command.rs:253-305)."""

    def __init__(self, device: RenderDevice, queue: Any = None):
        self.device = device

    def submit_and_wait(self, record_fn: Callable[[CommandEncoder], Any]) -> Any:
        encoder = CommandEncoder(self.device)
        out = record_fn(encoder)
        self.device.wait_until_idle()
        return out


class UploadPool:
    """Batched host→device uploads (upload.rs:55-192).

    The staging buffer + barrier dance dissolves; ``enqueue_copy`` collects
    host arrays and ``flush`` copies them onto the device, returning fresh
    Buffers.
    """

    def __init__(self, device: RenderDevice, capacity_bytes: int = 64 << 20):
        self.device = device
        self.capacity_bytes = capacity_bytes
        self._pending: List[tuple] = []
        self._pending_bytes = 0

    def enqueue_copy(self, name: str, data: np.ndarray,
                     usage: BufferUsage = BufferUsage.STORAGE) -> None:
        data = np.asarray(data)
        if self._pending_bytes + data.nbytes > self.capacity_bytes:
            self.flush()
        self._pending.append((name, data, usage))
        self._pending_bytes += data.nbytes

    def flush(self, immediate: "Optional[ImmediateCommandEncoder]" = None,
              device: "Optional[RenderDevice]" = None) -> "Dict[str, Buffer]":
        """(upload.rs:92-176) copy everything pending; blocking, like the
        reference's immediate submit."""
        if not self._pending:
            return {}
        dev = self.device.device
        arrays = [torch.from_numpy(np.ascontiguousarray(d)).to(dev)
                  for _, d, _ in self._pending]
        self.device.wait_until_idle()
        out: Dict[str, Buffer] = {}
        for (name, data, usage), arr in zip(self._pending, arrays):
            desc = BufferDesc(name, tuple(data.shape), str(data.dtype), usage)
            out[name] = Buffer(desc, arr)
            self.device.stats.uploads += 1
            self.device.stats.upload_bytes += data.nbytes
        self._pending.clear()
        self._pending_bytes = 0
        return out

    def upload_buffer(self, name: str, data: np.ndarray,
                      usage: BufferUsage = BufferUsage.STORAGE) -> Buffer:
        """(upload.rs:179-192) convenience single upload."""
        self.enqueue_copy(name, data, usage)
        return self.flush()[name]


@dataclass
class LastFreedStats:
    """(defer_release.rs:36-46) names + counts for the 1 Hz HUD line."""

    buffers: int = 0
    textures: int = 0
    pools: int = 0
    names: "List[str]" = field(default_factory=list)


class DeferReleaseQueue:
    """(defer_release.rs) N-buffered release bookkeeping. Actual memory
    lifetime is the caching allocator's; dropping the Python reference after
    the delay mirrors the reference's safety contract and feeds the stats
    log."""

    def __init__(self, num_frames: int = NUM_BACK_BUFFERS):
        self.num_frames = num_frames
        self._slots: List[List[Any]] = [[] for _ in range(num_frames)]
        self._frame = 0
        self.last_freed = LastFreedStats()

    def defer(self, resource: Any) -> None:
        self._slots[self._frame].append(resource)

    def begin_frame(self) -> LastFreedStats:
        """Advance to the next slot, dropping what was deferred N frames ago
        (device.rs:185-215 flow)."""
        self._frame = (self._frame + 1) % self.num_frames
        released = self._slots[self._frame]
        stats = LastFreedStats()
        for r in released:
            name = getattr(r, "name", type(r).__name__)
            stats.names.append(str(name))
            if isinstance(r, Buffer):
                stats.buffers += 1
            elif isinstance(r, Texture):
                stats.textures += 1
            else:
                stats.pools += 1
        self._slots[self._frame] = []
        self.last_freed = stats
        return stats
