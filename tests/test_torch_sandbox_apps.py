"""The port's fly and mesh apps and SceneApp's screen-space flags:

- ``FlyApp``'s scripted flight (``scripted_flight`` feeding the app's event
  handlers, ticked at a fixed 1/60 s) leaves the camera where the
  reference's does, bit for bit: the flight is host code, so no JAX frame;
  the app also renders through the engine loop over the baked cerberus;
- ``MeshApp``: ``frame_camera`` equals the reference's, and a frame through
  ``launch`` from the repository's baked cache equals ``MeshRenderer``
  drawn directly with the same camera, bit for bit;
- ``SceneApp --mode deferred`` with ``--ssao --contact-shadows --ssr --fog
  --sky --flare --decals 8`` builds each pass and renders a 128×64 frame
  that differs from the frame without them.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from zenith_tpu_torch.core.cli import EngineArgs
from zenith_tpu_torch.engine import Engine
from zenith_tpu_torch.window import Window

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
W, H = 128, 64
FEATURES = ["--ssao", "--contact-shadows", "--ssr", "--fog", "--sky", "--flare", "--decals", "8"]


@pytest.fixture(autouse=True)
def _baked_cerberus(monkeypatch):
    """Both packages load cerberus from the repository's baked cache."""
    from zenith_tpu_torch import asset

    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("ZENITH_CACHE", str(ROOT / "cache"))
    monkeypatch.delenv("ZENITH_CONTENT", raising=False)
    monkeypatch.delenv("ZENITH_ORBIT_START", raising=False)
    monkeypatch.delenv("ZENITH_ORBIT_SPEED", raising=False)
    asset.initialize()


def _fly(pkg, frames):
    """Fly the scripted flight through ``pkg``'s FlyApp and input stack,
    without a device: the camera prepare() sets up, events pumped as the
    engine loop pumps them, ticks of 1/60 s."""
    import importlib

    fly = importlib.import_module(f"{pkg}.sandbox.fly")
    cli = importlib.import_module(f"{pkg}.core.cli")
    cam_mod = importlib.import_module(f"{pkg}.core.camera")
    math_mod = importlib.import_module(f"{pkg}.core.mathtypes")
    win_mod = importlib.import_module(f"{pkg}.window")

    app = fly.FlyApp(cli.EngineArgs.parse_args([]))
    window = win_mod.Window(width=1280, height=720, title="fly")
    app.camera = cam_mod.Camera(fov_y=math_mod.Degree(40.0), aspect_ratio=1280 / 720)
    app.camera.set_position(np.array([0.0, -160.0, 30.0], np.float32))
    app.controller.move_speed = 60.0
    app._window = window
    for f in range(frames):
        fly.scripted_flight(f, window)
        for event in window.drain_window_events():
            app.on_window_event(event)
        for event in window.drain_device_events():
            app.on_device_event(event)
        app.tick(1 / 60)
    cam = app.camera
    return (np.asarray(cam.location, np.float64), float(cam._yaw), float(cam._pitch),
            np.asarray(cam.render_view_projection, np.float64))


@pytest.mark.parametrize("frames", [1, 60, 130, 240])
def test_scripted_flight_pose_equals_the_reference(frames):
    port, ref = _fly("zenith_tpu_torch", frames), _fly("zenith_tpu", frames)
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1:3] == ref[1:3]
    np.testing.assert_array_equal(port[3], ref[3])
    if frames > 1:
        assert np.linalg.norm(port[0] - np.array([0.0, -160.0, 30.0])) > 1.0


def test_fly_app_renders_through_the_engine_loop():
    from zenith_tpu_torch.main_loop import EngineLoop
    from zenith_tpu_torch.sandbox.fly import FlyApp, scripted_flight

    window = Window(width=W, height=H, title="fly")
    app = FlyApp(EngineArgs.parse_args([]))
    loop = EngineLoop(app, window=window, device="cpu")
    loop.run(max_frames=3, frame_callback=scripted_flight)
    assert loop.frames_rendered == 3
    assert window.last_frame[..., :3].std() > 1.0
    assert app.renderer.scene.objects[0].name == "cerberus"


def test_frame_camera_equals_the_reference():
    from zenith_tpu.sandbox.mesh import frame_camera as jframe
    from zenith_tpu_torch.sandbox.mesh import frame_camera

    rng = np.random.default_rng(4)
    lo = rng.uniform(-50, 0, 3).astype(np.float32)
    hi = (lo + rng.uniform(1, 80, 3)).astype(np.float32)
    cam, model = frame_camera(lo, hi, 16 / 9)
    jcam, jmodel = jframe(lo, hi, 16 / 9)
    np.testing.assert_array_equal(model, jmodel)
    np.testing.assert_array_equal(np.asarray(cam.location), np.asarray(jcam.location))
    np.testing.assert_array_equal(np.asarray(cam.render_view_projection),
                                  np.asarray(jcam.render_view_projection))


def test_mesh_app_frame_equals_mesh_renderer_drawn_directly():
    from zenith_tpu_torch.launch import launch
    from zenith_tpu_torch.rendergraph import RenderGraphBuilder
    from zenith_tpu_torch.rhi import Format, PipelineCache, Texture, TextureDesc, encode_present
    from zenith_tpu_torch.sandbox import mesh as tmesh
    from zenith_tpu_torch.sandbox.scene import default_content_root

    assert tmesh.default_content_root() == default_content_root() == str(ROOT)
    window = Window(width=W, height=H, title="mesh")
    loop = launch(tmesh.MeshApp, argv=[], window=window, max_frames=2, device="cpu")
    app = loop.app
    assert loop.frames_rendered == 2 and window.last_frame[..., :3].std() > 1.0
    r = app.mesh_renderer
    assert r.num_triangles > 30000  # cerberus, from the baked cache
    engine = loop.engine
    tex = Texture(TextureDesc.color("swap", W, H, Format.RGBA32F), device="cpu")
    builder = RenderGraphBuilder()
    out = builder.import_resource(tex)
    depth = builder.create(TextureDesc.depth("d", W, H))
    r.render_to(builder, out, depth, app.camera)
    builder.export(out)
    compiled = builder.build().compile(engine.render_device, PipelineCache(),
                                       engine.compile_options)
    compiled.execute(engine.render_device)
    direct = encode_present(compiled.value(out), Format.BGRA8_SRGB).numpy()
    np.testing.assert_array_equal(window.last_frame, direct)


def _scene_frame(*flags):
    from zenith_tpu_torch.sandbox.scene import SceneApp

    engine = Engine(Window(width=W, height=H, title="t"), device="cpu")
    app = SceneApp(EngineArgs(app_args=["--mode", "deferred", "--lights", "2", *flags]))
    app.prepare(engine.render_device, engine.window)
    app.tick(0.016)
    engine.render(app)
    app.tick(0.016)
    engine.render(app)  # the retained path, with every pass's dynamics
    engine.shutdown()
    return app, np.asarray(engine.window.last_frame)


def test_scene_app_feature_flags_build_and_render():
    app, frame = _scene_frame(*FEATURES)
    r, scene = app.renderer, app.renderer.scene
    assert r.ssao is not None and r.ssao.radius == 6.0
    assert scene.sun.contact_shadows and scene.atmosphere is not None and scene.skybox is None
    assert len(scene.decals) == 8 and scene.sun.direction == (0.8, -0.55, 0.1)
    assert app.ssr is not None and app.fog is not None and app.flare is not None
    dyn = app.update_dynamics()
    assert {"def.atmo", "ssr.params", "fog.params", "flare.sun_uv"} <= set(dyn)
    assert frame.shape == (H, W, 4) and np.isfinite(frame.astype(np.float64)).all()
    _, plain = _scene_frame()
    assert (frame != plain).any(-1).mean() > 0.2
