"""TriangleApp — full-pipeline demo
(reference zenith-sandbox/examples/triangle.rs; torch port of
zenith_tpu/sandbox/triangle.py).

Run (needs CUDA):  python -m zenith_tpu_torch.sandbox.triangle --frames 120 --out tri.png
"""

from __future__ import annotations

import argparse
from typing import Optional

from zenith_tpu_torch.app import Args, RenderableApp, RenderContext
from zenith_tpu_torch.renderer import TriangleRenderer


class TriangleApp(RenderableApp):
    def __init__(self, args: Args):
        super().__init__(args)
        self.triangle_renderer: Optional[TriangleRenderer] = None

    def prepare(self, render_device, window) -> None:
        """(triangle.rs:20-23)"""
        self.triangle_renderer = TriangleRenderer(render_device)

    def render(self, context: RenderContext) -> None:
        """(triangle.rs:25-43)"""
        width, height = context.extent
        if width == 0 or height == 0:
            return
        output = context.swapchain_texture()
        builder = context.builder()
        out = builder.import_resource(output)
        self.triangle_renderer.render_to(builder, out, width, height)

    def update_dynamics(self):
        """Auto-retained execution (engine.py): the only per-frame value is
        the time uniform — frames 2+ skip render_to/build/compile entirely
        and re-run the cached frame function with a fresh time."""
        if self.triangle_renderer is None:
            return None
        return self.triangle_renderer.frame_dynamics()


def main() -> None:
    from zenith_tpu_torch.launch import launch
    from zenith_tpu_torch.window import Window

    parser = argparse.ArgumentParser("zenith-sandbox triangle")
    parser.add_argument("--frames", type=int, default=120)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--readback-interval", type=int, default=1,
                        help="deliver every Nth frame to the host sink")
    parser.add_argument(
        "--serve", type=int, nargs="?", const=8089, default=None,
        metavar="PORT",
        help="interactive browser viewer on PORT (default 8089); "
        "runs until closed unless --frames is also given",
    )
    parser.add_argument("--fps-cap", type=float, default=60.0,
                        help="frame pacing for --serve")
    known, rest = parser.parse_known_args()
    import os
    os.environ.setdefault("ZENITH_READBACK_INTERVAL", str(known.readback_interval))

    window = Window(width=known.width, height=known.height, title="triangle")
    loop = launch(TriangleApp, argv=rest, window=window,
                  max_frames=None if known.serve is not None else known.frames,
                  serve=known.serve, fps_cap=known.fps_cap, device="cuda")
    if known.out and window.last_frame is not None:
        window.write_png(known.out, window.last_frame)
        print(f"wrote {known.out}")
    print(f"rendered {loop.frames_rendered} frames, presented {window.presented_frames}")


if __name__ == "__main__":
    main()
