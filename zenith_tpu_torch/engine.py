"""Engine — owns device, swapchain, caches; drives the frame
(reference zenith/src/engine.rs; torch port of zenith_tpu/engine.py).

Frame flow (engine.rs:88-112):
  begin_frame → new builder → app.render (declares nodes) → build →
  compile (structure-cached frame function) → execute (enqueues the frame's
  kernels) → present (async readback ring) → end_frame.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from zenith_tpu_torch.app import RenderableApp, RenderContext
from zenith_tpu_torch.core import log
from zenith_tpu_torch.rendergraph import (
    CompileOptions,
    RenderGraphBuilder,
    RetiredRenderGraph,
    frame_program_cache_size,
)
from zenith_tpu_torch.rhi.device import RenderDevice, RhiCore
from zenith_tpu_torch.rhi.pipeline import PipelineCache
from zenith_tpu_torch.rhi.swapchain import Swapchain, SwapchainConfig
from zenith_tpu_torch.window import Window

logger = log.get(__name__)


class Engine:
    """(engine.rs:10-23, 26-82)"""

    def __init__(
        self,
        window: Window,
        swapchain_config: Optional[SwapchainConfig] = None,
        compile_options: CompileOptions = CompileOptions(),
        device: "torch.device | str" = "cuda",
    ):
        self.window = window
        core = RhiCore(device)
        self.render_device: RenderDevice = core.create_render_device()
        config = swapchain_config or SwapchainConfig(
            width=window.width,
            height=window.height,
            readback_interval=int(os.environ.get("ZENITH_READBACK_INTERVAL", "1")),
        )
        self.swapchain = Swapchain(self.render_device, config, on_present=window.present)
        self.pipeline_cache = PipelineCache()
        self.compile_options = compile_options
        self.last_retired: Optional[RetiredRenderGraph] = None
        # Retained-mode state: (compiled graph, swapchain output handle),
        # kept only for apps that implement update_dynamics().
        self._retained: Optional[tuple] = None
        self._elapsed = 0.0
        logger.info(
            "Engine up: %s, %dx%d %s",
            self.render_device.physical.name,
            config.width,
            config.height,
            config.format,
        )

    # -- stats (engine.rs:136-147) ---------------------------------------------

    @property
    def pipeline_cache_size(self) -> int:
        return len(self.pipeline_cache)

    @property
    def frame_program_count(self) -> int:
        return frame_program_cache_size()

    @property
    def elapsed(self) -> float:
        return self._elapsed

    def tick(self, delta_time: float) -> None:
        self._elapsed += delta_time

    def invalidate_retained(self) -> None:
        """Drop the retained compiled graph (hot-reload, external structure
        change) so the next frame takes the rebuild path."""
        self._retained = None

    def grow_entry_budget(self) -> int:
        """Double every draw's entry budget (called by the loop when a frame
        reports bin overflow — dropped triangles). Changes the structure key,
        so the next frame compiles one larger program variant and the cycle
        converges, exactly like pipeline-cache misses."""
        from dataclasses import replace

        new_scale = self.compile_options.budget_scale * 2
        self.compile_options = replace(
            self.compile_options, budget_scale=new_scale
        )
        self._retained = None  # must recompile at the new budget
        logger.warning(
            "bin overflow: growing entry budgets ×%d (recompiling)", new_scale
        )
        return new_scale

    # -- frame (engine.rs:88-112) ------------------------------------------------

    def render(self, app: RenderableApp) -> None:
        device = self.render_device
        device.begin_frame()

        # RETAINED MODE (beyond the reference's per-frame rebuild): an app
        # that implements update_dynamics() re-runs the previously compiled
        # frame function with fresh per-frame values, skipping render/build/
        # compile. Constraints: graph structure must be static, and
        # attachments must not LOAD frame N-1 swapchain contents (the import
        # is from build time).
        update_dynamics = getattr(app, "update_dynamics", None)
        if self._retained is not None and update_dynamics is not None:
            dyn = update_dynamics()
            if dyn is not None:
                compiled, handle, requested = self._retained
                self.swapchain.acquire_next_image()  # ring backpressure
                self.last_retired = compiled.execute(device, dynamics=dyn)
                self._deliver_outputs(app, compiled, requested)
                if handle is not None:
                    compiled.present(self.swapchain, handle)
                device.end_frame()
                return

        image_index, swap_texture = self.swapchain.acquire_next_image()
        builder = RenderGraphBuilder()
        context = RenderContext(builder, swap_texture, self.swapchain.extent)
        app.render(context)

        graph = builder.build()
        compiled = graph.compile(device, self.pipeline_cache, self.compile_options)
        self.last_retired = compiled.execute(device)
        self._deliver_outputs(app, compiled, context.requested_outputs)

        # Present: the app's declared present source (PresentEncode output)
        # wins; otherwise find the imported swapchain texture that some node
        # wrote (the reference splits nodes at the first swapchain write,
        # graph.rs:156-180; here we just fetch its final value).
        outputs = compiled._outputs or {}
        handle = None
        if context.present_source is not None:
            if str(context.present_source.id) in outputs:
                handle = context.present_source
            else:
                logger.warning(
                    "present_from(#%d): resource is not a frame output — "
                    "did you forget builder.export()? Falling back to the "
                    "swapchain texture.",
                    context.present_source.id,
                )
        if handle is None:
            for rid, st in enumerate(graph.resources):
                if st.imported is swap_texture:
                    if str(rid) in outputs:
                        from zenith_tpu_torch.rendergraph.resource import (
                            RenderGraphResource,
                        )

                        handle = RenderGraphResource(rid, "texture")
                    break
        if handle is not None:
            compiled.present(self.swapchain, handle)
        if update_dynamics is not None:
            self._retained = (compiled, handle, dict(context.requested_outputs))
        device.end_frame()

    @staticmethod
    def _deliver_outputs(app, compiled, requested) -> None:
        """Hand requested exported values back to the app (cross-frame
        feedback: TAA history, auto-exposure state) — device tensors, no
        host sync."""
        if not requested:
            return
        cb = getattr(app, "on_frame_outputs", None)
        if cb is None:
            logger.warning(
                "request_output(%s) but the app defines no on_frame_outputs "
                "hook — feedback values dropped", sorted(requested)
            )
            return
        values = {}
        for name, res in requested.items():
            try:
                values[name] = compiled.value(res)
            except KeyError:
                logger.warning(
                    "request_output('%s'): resource #%d is not a frame "
                    "output — did you forget builder.export()? Dropped.",
                    name, res.id,
                )
        if values:
            cb(values)

    def resize(self, width: int, height: int) -> None:
        """(engine.rs:114-133)"""
        self.window.width = width
        self.window.height = height
        self.swapchain.resize(width, height)
        self._retained = None  # structure changed; rebuild next frame

    def shutdown(self) -> None:
        self.swapchain.flush()
