"""FlyApp: an input-driven fly camera over the sandbox scene (torch port of
zenith_tpu/sandbox/fly.py).

Exercises the input stack end to end through the engine loop: the
InputActionMapper's WASD/QE axes and the CameraController's mouse look.
Headless: events come from the window's event queue, here synthesized by
``scripted_flight``, which replays a WASD + mouse path. The scene is
build_scene's cerberus without point lights, drawn by the forward shadow
renderer.

Run on the card (from the repository's root, for the baked cerberus):

    python -m zenith_tpu_torch.sandbox.fly --frames 240 --out fly.png
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from zenith_tpu_torch.app import Args, RenderableApp, RenderContext
from zenith_tpu_torch.core.camera import Camera, CameraController
from zenith_tpu_torch.core.events import (
    ElementState,
    KeyboardInput,
    KeyCode,
    MouseButton,
    MouseInput,
    MouseMotion,
)
from zenith_tpu_torch.core.input import InputActionMapper
from zenith_tpu_torch.core.mathtypes import Degree
from zenith_tpu_torch.rhi import TextureDesc


class FlyApp(RenderableApp):
    """The fly camera (fly.py:41-106): WASD + QE, mouse look while the
    left button is held, Escape quits."""

    def __init__(self, args: Args):
        super().__init__(args)
        self.renderer = None
        self.camera: Optional[Camera] = None
        self.controller = CameraController(mouse_sensitivity=0.4)
        self.mapper = InputActionMapper()
        self.mapper.register_axis("forward", [KeyCode.KEY_W], [KeyCode.KEY_S], 0.5)
        self.mapper.register_axis("right", [KeyCode.KEY_D], [KeyCode.KEY_A], 0.5)
        self.mapper.register_axis("up", [KeyCode.KEY_E], [KeyCode.KEY_Q], 0.5)
        self.mapper.register_action("quit", [KeyCode.ESCAPE])
        self._window = None

    def prepare(self, render_device, window) -> None:
        from zenith_tpu_torch.renderer import ForwardShadowRenderer
        from zenith_tpu_torch.sandbox.scene import build_scene

        scene = build_scene(render_device, 0, np.random.default_rng(42))
        self.renderer = ForwardShadowRenderer(scene)
        self.camera = Camera(fov_y=Degree(40.0), aspect_ratio=window.width / max(window.height, 1))
        self.camera.set_position(np.array([0.0, -160.0, 30.0], np.float32))
        self.controller.move_speed = 60.0
        self._window = window

    def on_window_event(self, event) -> None:
        self.mapper.on_window_event(event)
        self.controller.on_window_event(event)

    def on_device_event(self, event) -> None:
        self.controller.on_device_event(event)

    def tick(self, delta_time: float) -> None:
        self.mapper.tick(delta_time)
        if self.mapper.is_action_just_pressed("quit"):
            self._window.request_close()
        self.controller.update_cameras(
            delta_time, self.mapper.get_axis("forward"), self.mapper.get_axis("right"),
            self.mapper.get_axis("up"), [self.camera])

    def render(self, context: RenderContext) -> None:
        width, height = context.extent
        if width == 0 or height == 0:
            return
        builder = context.builder()
        out = builder.import_resource(context.swapchain_texture())
        depth = builder.create(TextureDesc.depth("fly.depth", width, height))
        self.renderer.render_to(builder, out, depth, self.camera)


def scripted_flight(frame: int, window) -> None:
    """The synthesized pilot (fly.py:109-121): fly forward, mouse-look,
    strafe."""
    if frame == 0:
        window.push_window_event(KeyboardInput(KeyCode.KEY_W, ElementState.PRESSED))
        window.push_window_event(MouseInput(MouseButton.LEFT, ElementState.PRESSED))
    if 40 <= frame < 120:
        window.push_device_event(MouseMotion(dx=1.2, dy=-0.15))
    if frame == 120:
        window.push_window_event(KeyboardInput(KeyCode.KEY_W, ElementState.RELEASED))
        window.push_window_event(KeyboardInput(KeyCode.KEY_D, ElementState.PRESSED))
    if frame == 200:
        window.push_window_event(KeyboardInput(KeyCode.KEY_D, ElementState.RELEASED))


def main() -> None:
    """``python -m zenith_tpu_torch.sandbox.fly [--frames N] [--out PNG]
    [--width W] [--height H]`` on the card: the scripted flight; ``--serve
    [PORT] [--target-fps F] [--no-adaptive]`` flies interactively behind the
    viewer (``viewer.serve_loop``) instead."""
    from zenith_tpu_torch import asset
    from zenith_tpu_torch.core import log, profile
    from zenith_tpu_torch.core.cli import EngineArgs
    from zenith_tpu_torch.main_loop import EngineLoop
    from zenith_tpu_torch.window import Window

    parser = argparse.ArgumentParser("zenith-sandbox fly")
    parser.add_argument("--frames", type=int, default=240)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--readback-interval", type=int, default=1)
    parser.add_argument(
        "--serve", type=int, nargs="?", const=8089, default=None,
        metavar="PORT",
        help="serve an interactive browser viewer on PORT (default 8089) "
        "instead of replaying the scripted flight",
    )
    parser.add_argument(
        "--fps-cap", type=float, default=60.0,
        help="frame pacing for --serve (the stream can't use more)",
    )
    parser.add_argument(
        "--target-fps", type=float, default=30.0,
        help="adaptive-stream FPS target for --serve (dynamic resolution "
        "holds this through the readback; see viewer.AdaptiveStream)",
    )
    parser.add_argument(
        "--no-adaptive", action="store_true",
        help="serve at the fixed window resolution (no dynamic resolution)",
    )
    known, rest = parser.parse_known_args()
    os.environ.setdefault("ZENITH_READBACK_INTERVAL", str(known.readback_interval))

    window = Window(width=known.width, height=known.height, title="fly")
    args = EngineArgs.parse_args(rest)
    profile.initialize()
    log.initialize(args.log_level.to_logging_level())
    asset.initialize()

    app = FlyApp(args)
    loop = EngineLoop(app, window=window, device="cuda")
    if known.serve is not None:
        from zenith_tpu_torch.viewer import serve_loop

        print("flying — WASD/QE + click-to-look, Esc quits")
        serve_loop(loop, port=known.serve, fps_cap=known.fps_cap,
                   adaptive=not known.no_adaptive,
                   target_fps=known.target_fps)
    else:
        loop.run(max_frames=known.frames, frame_callback=scripted_flight)
    if known.out and window.last_frame is not None:
        window.write_png(known.out, window.last_frame)
        print(f"wrote {known.out}")
    print(f"rendered {loop.frames_rendered} frames; camera at "
          f"{np.round(app.camera.location, 1)}")


if __name__ == "__main__":
    main()
