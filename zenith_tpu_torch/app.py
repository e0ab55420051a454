"""App lifecycle traits (reference zenith/src/app.rs:9-53; torch port of
zenith_tpu/app.py)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Tuple

from zenith_tpu_torch.core.cli import EngineArgs as Args
from zenith_tpu_torch.core.events import DeviceEvent, WindowEvent
from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.rhi.resource import Texture

if TYPE_CHECKING:
    from zenith_tpu_torch.rhi.device import RenderDevice
    from zenith_tpu_torch.window import Window


class RenderContext:
    """Per-frame view passed to App.render (app.rs:17-47): the graph builder
    plus the swapchain texture for this frame slot and the surface extent."""

    def __init__(self, builder: RenderGraphBuilder, swapchain_texture: Texture,
                 extent: "Tuple[int, int]"):
        self._builder = builder
        self._swapchain_texture = swapchain_texture
        self._extent = extent
        self.present_source = None  # set via present_from()
        self.requested_outputs = {}  # name -> resource (request_output)

    @property
    def extent(self) -> "Tuple[int, int]":
        return self._extent

    def swapchain_texture(self) -> Texture:
        return self._swapchain_texture

    def builder(self) -> RenderGraphBuilder:
        return self._builder

    def present_from(self, resource) -> None:
        """Present this frame from a graph-created (and exported) resource
        instead of the imported swapchain texture — e.g. the output of a
        ``PresentEncode`` node, which folds the sRGB swapchain encode into
        the frame program (one dispatch per frame)."""
        self.present_source = resource

    def request_output(self, name: str, resource) -> None:
        """Cross-frame feedback: after execute, the engine hands this
        EXPORTED resource's final device value back through
        ``app.on_frame_outputs({name: array})`` — device-resident round
        trip (no host readback) for temporal state like the TAA history
        surface or the auto-exposure scalar. Works on both the rebuild and
        retained paths."""
        self.requested_outputs[name] = resource


class App:
    """Base lifecycle (app.rs:9-28)."""

    def __init__(self, args: Args):
        self.args = args

    def on_window_event(self, event: WindowEvent) -> None:
        pass

    def on_device_event(self, event: DeviceEvent) -> None:
        pass

    def tick(self, delta_time: float) -> None:
        pass


class RenderableApp(App):
    """Renderable lifecycle (app.rs:30-53)."""

    def prepare(self, render_device: "RenderDevice", window: "Window") -> None:
        pass

    def resize(self, width: int, height: int) -> None:
        pass

    def render(self, context: RenderContext) -> None:
        raise NotImplementedError

    # Optional retained-mode hook (beyond the reference): return a
    # {dynamic_name: value} dict of this frame's per-frame values and the
    # engine re-runs the cached frame function without rebuilding the graph. Return None to
    # force the rebuild path (e.g. when graph structure changed). Apps that
    # don't define this method get the reference-parity rebuild-every-frame
    # flow. Constraints: static graph structure; attachments must not LOAD
    # previous swapchain contents.
    update_dynamics = None

    # Optional cross-frame feedback hook: called after each execute with
    # {name: device_array} for every resource the app registered via
    # RenderContext.request_output. Values are device tensors — feed them
    # straight back in as next frame's dynamics (TAA history, auto-exposure
    # state); fetching them to host would stall the pipeline.
    on_frame_outputs = None
