"""Engine loop (reference zenith/src/main_loop.rs; torch port of
zenith_tpu/main_loop.py).

The winit ApplicationHandler becomes a plain frame loop over a headless
Window: pump events → tick (dt + 1 Hz stats log, main_loop.rs:140-174) →
render → repeat. Continuous redraw (ControlFlow::Poll parity) until the
window closes or a frame budget runs out.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from zenith_tpu_torch.app import RenderableApp
from zenith_tpu_torch.core import log
from zenith_tpu_torch.core.events import CloseRequested, Resized
from zenith_tpu_torch.engine import Engine
from zenith_tpu_torch.window import Window

logger = log.get(__name__)


class EngineLoop:
    """(main_loop.rs:11-85)"""

    def __init__(self, app: RenderableApp, window: Optional[Window] = None,
                 device: "torch.device | str" = "cuda"):
        self.app = app
        self.window = window or Window()
        self.device = torch.device(device)
        self.engine: Optional[Engine] = None
        self._last_tick: Optional[float] = None
        self._stats_window_start = 0.0
        self._stats_frames = 0
        self.frames_rendered = 0
        # Apps set this (usually in prepare) to get 1 Hz hot-reload polling.
        self.asset_manager = None
        import os

        # The 1 Hz bin-overflow read (and adaptive budget growth) waits for
        # the device — opt-in only (see tick()).
        self._stats_sync = os.environ.get("ZENITH_STATS_SYNC", "0") not in (
            "", "0", "false"
        )

    def _resumed(self) -> None:
        """(main_loop.rs:21-62) create engine + app.prepare."""
        self.engine = Engine(self.window, device=self.device)
        self.app.prepare(self.engine.render_device, self.window)

    def run(self, max_frames: Optional[int] = None,
            frame_callback=None, final: bool = True) -> None:
        """Run until close / max_frames. ``frame_callback(frame, window)``,
        if given, runs before each frame's event pump — the hook scripted
        front-ends use to feed input events (a human-at-the-controls
        stand-in).

        ``final=False`` makes the call RESUMABLE: the end-of-session tail
        (the one-shot bin-overflow read and engine shutdown/flush) is
        skipped; call run() again to continue, or once more with
        ``final=True`` to end the session."""
        if self.engine is None:
            self._resumed()
        self._last_tick = time.perf_counter()
        self._stats_window_start = self._last_tick
        while not self.window.closed:
            if max_frames is not None and self.frames_rendered >= max_frames:
                break
            if frame_callback is not None:
                frame_callback(self.frames_rendered, self.window)
            self._pump_events()
            if self.window.closed:
                break
            self._tick()
            self.engine.render(self.app)
            self.frames_rendered += 1
        if not final:
            return
        # End-of-run overflow check: with ZENITH_STATS_SYNC off the 1 Hz
        # read is disabled, so one read here keeps dropped triangles from
        # ending a run silently.
        if not self._stats_sync and self.engine.last_retired is not None:
            overflow = int(self.engine.last_retired.bin_overflow)
            if overflow > 0:
                logger.warning(
                    "bin overflow on the final frame (%d entries dropped — "
                    "visible holes likely). Re-run with ZENITH_STATS_SYNC=1 "
                    "to enable live detection + adaptive budget growth, or "
                    "raise SceneObject.entry_budget.",
                    overflow,
                )
        self.engine.shutdown()

    def _pump_events(self) -> None:
        for event in self.window.drain_window_events():
            if isinstance(event, CloseRequested):
                self.window.request_close()
                continue
            if isinstance(event, Resized):
                self.engine.resize(event.width, event.height)
                self.app.resize(event.width, event.height)
                continue
            self.app.on_window_event(event)
        for event in self.window.drain_device_events():
            self.app.on_device_event(event)

    def _tick(self) -> None:
        """dt + 1 Hz stats line (main_loop.rs:140-174)."""
        now = time.perf_counter()
        # Clamp dt so compile stalls / debugger pauses don't teleport
        # animation state (standard game-loop hygiene).
        dt = min(now - self._last_tick, 0.1)
        self._last_tick = now
        self._stats_frames += 1
        window = now - self._stats_window_start
        if window >= 1.0:
            fps = self._stats_frames / window
            # Reading the overflow counter waits for the frame, so the 1 Hz
            # read — and with it adaptive budget growth — is OPT-IN via
            # ZENITH_STATS_SYNC=1.
            overflow = None
            if self._stats_sync and self.engine.last_retired is not None:
                overflow = int(self.engine.last_retired.bin_overflow)
            logger.info(
                "FPS: %.1f | pipelines: %d | frame functions: %d | "
                "bin overflow: %s",
                fps,
                self.engine.pipeline_cache_size,
                self.engine.frame_program_count,
                "async-off" if overflow is None else overflow,
            )
            if overflow is not None and overflow > 0:
                # Perf/correctness hazard, like the reference's ALL_COMMANDS
                # barrier warning (graph.rs:383-385): triangles were dropped.
                # Adaptive response: double the budgets and recompile once.
                self.engine.grow_entry_budget()
            self._stats_window_start = now
            self._stats_frames = 0
            if self.asset_manager is not None:
                try:
                    reloaded = self.asset_manager.poll_hot_reload()
                    if reloaded:
                        # Retained frame programs bake build-time imports
                        # and captures; a reloaded asset must force the
                        # rebuild path or the screen never updates.
                        self.engine.invalidate_retained()
                except Exception:
                    logger.exception("hot-reload poll failed")
        self.engine.tick(dt)
        self.app.tick(dt)
