"""The benchmark's plain reference renderer: plain PyTorch and NumPy, which
imports neither the program under test nor JAX. Each configuration names a
scene module here (``sandbox``, ``terrain``) that builds the scene from the
same inputs the harness hands the program and gives each frame's camera;
``deferred.render`` draws the frame."""

from __future__ import annotations

import importlib


def render_frame(scene_module: str, argv: "list[str]", inputs: dict, frame: int, device,
                 precision: str = "reference", scene=None, exposure_prev=None):
    """(the presented frame ``frame`` (0-based, every frame the program
    rendered counted) as (H, W, 4) uint8 BGRA, the scene (pass it back to
    skip the build for the next frame), the frame's adapted exposure or
    None). A scene with eye adaptation adapts from ``exposure_prev``
    (None: the first frame's exposure)."""
    from reference import deferred

    mod = importlib.import_module(f"reference.{scene_module}")
    if scene is None:
        scene = mod.build(argv, inputs)
    cam = mod.camera(argv, inputs, frame)
    img, ev = deferred.render(scene, cam, inputs["width"], inputs["height"], device, precision,
                              frame=frame, exposure_prev=exposure_prev, dt=inputs["dt"])
    return img, scene, (None if ev is None else float(ev))
