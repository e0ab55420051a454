"""Swapchain: N-deep framebuffer ring + async host readback (torch port of
zenith_tpu/rhi/swapchain.py).

Mirrors zenith-rhi/src/swapchain.rs:

- Vulkan: acquire_next_image waits the slot's in-flight fence
  (swapchain.rs:210-231); present submits with semaphores (244-264).
- Here: `present` encodes the linear framebuffer to the swapchain format on
  the device, starts a non-blocking copy into a pinned host buffer and
  records a CUDA event behind it; `acquire_next_image` waits on the event
  of the frame presented NUM_BACK_BUFFERS ago (same backpressure). The
  completed host frame is delivered to an `on_present` sink (PNG dump,
  parity harness) — the analog of the OS compositor. On a CPU device the
  copy is synchronous and there are no events.

Config mirrors SwapchainConfig (swapchain.rs:62-78): preferred format
BGRA8_SRGB; present mode MAILBOX (free-running) or FIFO (paced to
refresh_rate).
"""

from __future__ import annotations

import enum
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from zenith_tpu_torch.core import log
from zenith_tpu_torch.rhi.device import NUM_BACK_BUFFERS, RenderDevice
from zenith_tpu_torch.rhi.formats import Format, encode_present
from zenith_tpu_torch.rhi.resource import Texture, TextureDesc, TextureUsage

logger = log.get(__name__)


class PresentMode(enum.Enum):
    MAILBOX = "mailbox"  # free-running, lowest latency (preferred, swapchain.rs:74)
    FIFO = "fifo"  # paced to refresh_rate


@dataclass
class SwapchainConfig:
    """(reference swapchain.rs:62-78)"""

    width: int = 1920
    height: int = 1080
    format: Format = Format.BGRA8_SRGB
    present_mode: PresentMode = PresentMode.MAILBOX
    num_images: int = NUM_BACK_BUFFERS
    refresh_rate: float = 60.0
    # Host-readback cadence: deliver every Nth presented frame to the
    # on_present sink (1 = every frame). Device-side rendering/encoding is
    # unaffected; this only throttles the device→host copy. 0 = never read
    # back: pure fencing (`flush()` delivers nothing, `Window.last_frame`
    # stays None).
    readback_interval: int = 1

    def __post_init__(self) -> None:
        if self.readback_interval < 0:
            raise ValueError(
                "readback_interval must be >= 0 (0 = never read back); "
                f"got {self.readback_interval}"
            )


@dataclass
class _PendingFrame:
    frame_counter: int
    host: torch.Tensor  # pinned host buffer, copy in flight
    event: "Optional[torch.cuda.Event]"  # recorded behind the copy (CUDA)
    t_present: float


class Swapchain:
    """Framebuffer ring with async present (reference swapchain.rs:81-475)."""

    def __init__(
        self,
        device: RenderDevice,
        config: SwapchainConfig,
        on_present: "Optional[Callable[[np.ndarray, int], None]]" = None,
    ):
        self.device = device
        self.config = config
        self.on_present = on_present
        self._image_index = 0
        self._pending: List[_PendingFrame] = []
        self._fences: list = []  # device-side frames-in-flight events
        self._free_host: Dict[Tuple, List[torch.Tensor]] = {}
        self.pace_stride = int(os.environ.get("ZENITH_PACE_STRIDE", "128"))
        self._frame_counter = 0
        self._last_present_time: Optional[float] = None
        self.suboptimal = False
        self._warned_stale = False
        self._textures = self._make_textures(config.width, config.height)

    def _make_textures(self, width: int, height: int) -> "list[Texture]":
        # Device-side swapchain images are linear float; the sRGB encode
        # happens at present (encode_present).
        return [
            Texture(
                TextureDesc(
                    f"swapchain.{i}", width, height, Format.RGBA32F,
                    TextureUsage.COLOR_ATTACHMENT | TextureUsage.TRANSFER_SRC,
                ),
                device=self.device.device,
            )
            for i in range(self.config.num_images)
        ]

    @property
    def extent(self) -> "tuple[int, int]":
        return (self.config.width, self.config.height)

    def acquire_next_image(self) -> "tuple[int, Texture]":
        """Return (image_index, texture). Blocks only when NUM_BACK_BUFFERS
        read-backs are already in flight — the reference's in-flight-fence
        wait (swapchain.rs:210-231)."""
        while len(self._pending) >= self.config.num_images:
            self._deliver(self._pending.pop(0))
        idx = self._image_index
        return idx, self._textures[idx]

    def present(
        self, rendered: torch.Tensor, pre_encoded: "Optional[bool]" = None
    ) -> None:
        """Encode + start the async readback; advances the ring
        (reference swapchain.rs:243-264).

        ``pre_encoded=True`` marks ``rendered`` as ALREADY encoded to the
        swapchain format; the default infers it from the dtype (uint8 ⇒
        pre-encoded).

        Trap (warned once under validation, swapchain.py:152-164): a
        pre-encoded present leaves the swapchain slot holding the PREVIOUS
        frame's linear contents, so a LOAD-op graph reading the swapchain
        image afterwards sees a stale frame. Keep the linear surface as a
        graph-managed resource in that case."""
        if pre_encoded is None:
            pre_encoded = rendered.dtype == torch.uint8
        if pre_encoded:
            from zenith_tpu_torch.core import validate

            if validate.enabled() and not self._warned_stale:
                self._warned_stale = True
                logger.warning(
                    "[validate] pre-encoded present: swapchain slot %d keeps its previous "
                    "LINEAR contents — a LOAD-op graph reading the swapchain image next "
                    "frame sees a stale frame. Use a graph-managed linear resource for "
                    "feedback loops.", self._image_index)
        if not pre_encoded:
            # Keep the device-resident rendered image bound to the slot so
            # LOAD-op graphs can read last frame's contents.
            self._textures[self._image_index] = (
                self._textures[self._image_index].with_array(rendered)
            )
        cuda = rendered.device.type == "cuda"
        interval = self.config.readback_interval
        if interval > 0 and self._frame_counter % interval == 0:
            encoded = rendered if pre_encoded else encode_present(rendered, self.config.format)
            host = self._host_buffer(tuple(encoded.shape), encoded.dtype, cuda)
            host.copy_(encoded, non_blocking=cuda)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
            self._pending.append(
                _PendingFrame(self._frame_counter, host, event, time.perf_counter())
            )
        # Device-side frames-in-flight fence (device.rs:185-193 analog): an
        # event every pace_stride frames, waiting on the oldest once more
        # than two are outstanding.
        if cuda and self._frame_counter % self.pace_stride == 0:
            fence = torch.cuda.Event()
            fence.record()
            self._fences.append(fence)
            if len(self._fences) > 2:
                self._fences.pop(0).synchronize()
        self._frame_counter += 1
        self._image_index = (self._image_index + 1) % self.config.num_images
        if self.config.present_mode == PresentMode.FIFO:
            self._pace()

    def flush(self) -> None:
        """Drain all in-flight frames (used at shutdown / for readback tests)."""
        while self._pending:
            self._deliver(self._pending.pop(0))

    def resize(self, width: int, height: int) -> None:
        """(reference swapchain.rs:275-324) drain + rebuild images; the
        frame counter keeps running across resizes."""
        self.flush()
        self.config.width = width
        self.config.height = height
        self._image_index = 0
        self.suboptimal = False
        self._free_host.clear()
        self._textures = self._make_textures(width, height)

    # -- internals -----------------------------------------------------------

    def _host_buffer(self, shape: Tuple, dtype: torch.dtype, pinned: bool) -> torch.Tensor:
        free = self._free_host.get((shape, dtype))
        if free:
            return free.pop()
        return torch.empty(shape, dtype=dtype, pin_memory=pinned)

    def _deliver(self, frame: _PendingFrame) -> None:
        if frame.event is not None:
            frame.event.synchronize()
        if self.on_present is not None:
            self.on_present(frame.host.numpy().copy(), frame.frame_counter)
        self._free_host.setdefault((tuple(frame.host.shape), frame.host.dtype), []).append(frame.host)

    def _pace(self) -> None:
        period = 1.0 / self.config.refresh_rate
        now = time.perf_counter()
        if self._last_present_time is not None:
            sleep_for = self._last_present_time + period - now
            if sleep_for > 0:
                time.sleep(sleep_for)
                now = time.perf_counter()
        self._last_present_time = now
