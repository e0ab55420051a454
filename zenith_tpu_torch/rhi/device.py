"""Device discovery and the render-device facade (torch port of
zenith_tpu/rhi/device.py).

Mirrors zenith-rhi/src/core.rs + device.rs:

- `RhiCore` (core.rs:58-114): holds the explicit ``torch.device`` the
  program renders on. There is no global default device: the caller names
  it, and asking for CUDA where there is none raises.
- `RenderDevice` (device.rs:76-359): frame-slot counter (begin/end_frame),
  per-frame stats, submission (running the frame function enqueues its
  kernels on the current stream), uploads onto the device.

What dissolves: memory-type selection, fences/semaphores (CUDA events in
the swapchain take their place), defer-release (the caching allocator),
barriers (stream order).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from zenith_tpu_torch.core import log
from zenith_tpu_torch.rhi.resource import Buffer, BufferUsage, ResourceCache

logger = log.get(__name__)

# Triple buffering, matching the reference (zenith-rhi/src/lib.rs:26).
NUM_BACK_BUFFERS = 3


@dataclass
class PhysicalDevice:
    """The compute device a RenderDevice drives (reference core.rs:26-55)."""

    device: torch.device

    @property
    def name(self) -> str:
        if self.device.type == "cuda":
            return f"cuda:{torch.cuda.get_device_name(self.device)}"
        return str(self.device)


def select_physical_device(device: "torch.device | str") -> PhysicalDevice:
    """Check that ``device`` exists and wrap it (reference core.rs:349-395)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device} (cuda or cpu)")
    return PhysicalDevice(device)


class RhiCore:
    """Runtime entry point (reference core.rs:58-114) for one explicit
    device."""

    def __init__(self, device: "torch.device | str") -> None:
        self.physical = select_physical_device(device)
        logger.info("RhiCore: device=%s", self.physical.name)

    def create_render_device(self) -> "RenderDevice":
        return RenderDevice(self.physical)


@dataclass
class FrameStats:
    """Per-second stats feed (reference main_loop.rs:146-162 + device.rs
    LastFreedStats). Tracks what the 1 Hz log line prints."""

    frame_index: int = 0
    submits: int = 0
    uploads: int = 0
    upload_bytes: int = 0


class RenderDevice:
    """The logical device (reference device.rs:76-359)."""

    def __init__(self, physical: PhysicalDevice):
        self.physical = physical
        self.device: torch.device = physical.device
        self._frame_counter = 0
        self._current_frame = 0  # slot in [0, NUM_BACK_BUFFERS)
        self.stats = FrameStats()
        self.resource_cache = ResourceCache(self.device)

    # -- frame lifecycle (device.rs:185-215) --------------------------------

    @property
    def current_frame(self) -> int:
        return self._current_frame

    @property
    def frame_counter(self) -> int:
        return self._frame_counter

    def begin_frame(self) -> int:
        """Start a frame slot. Backpressure comes from the swapchain, which
        waits on the readback of the frame presented NUM_BACK_BUFFERS ago."""
        self.stats.frame_index = self._frame_counter
        return self._current_frame

    def end_frame(self) -> None:
        self._frame_counter += 1
        self._current_frame = self._frame_counter % NUM_BACK_BUFFERS

    # -- submission ----------------------------------------------------------

    def submit(self, fn, *args, **kwargs):
        """Run a frame function: its kernels are enqueued on the current
        stream and the call returns without waiting (queue_submit2 analog,
        device.rs:297-338)."""
        self.stats.submits += 1
        return fn(*args, **kwargs)

    def wait_until_idle(self) -> None:
        """Block until all enqueued work on the device completes."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- debug names (reference device.rs:16-68) ------------------------------

    def set_debug_name(self, obj: Any, name: str) -> Any:
        """Attach a debug name to any RHI object (device.rs:16-68)."""
        try:
            obj.debug_name = name
        except AttributeError:
            object.__setattr__(obj, "debug_name", name)
        return obj

    # -- uploads (the UploadPool analog, reference upload.rs) ----------------

    def upload_buffer(self, name: str, data: np.ndarray,
                      usage: BufferUsage = BufferUsage.STORAGE) -> Buffer:
        """Host→device upload onto this device."""
        buf = Buffer.from_numpy(name, data, usage, device=self.device)
        self.stats.uploads += 1
        self.stats.upload_bytes += np.asarray(data).nbytes
        return buf

    def put(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), device=self.device)
