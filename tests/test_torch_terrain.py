"""The port's terrain flyover (sandbox/terrain.py) against the reference's:
the heightmap, mesh and albedo generators bit-equal; ``TerrainApp`` through
``launch`` on the CPU at ``--grid 48`` (4,418 triangles) and 128×64 against
the JAX app's frame after the same two frames; the contact-shadow and
no-sky variants on the port; the interactive take-over of
tests/test_interactive_takeover.py for the port's TerrainApp and SceneApp;
and ``--serve``, which raises naming ROADMAP item 23.

Tolerance: the presented frame (BGRA8 sRGB) ≤ 1 LSB with < 1% of values
differing, the reference's own golden tolerance. The JAX frame is rendered
once, in a module fixture.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from zenith_tpu_torch.core.camera import Camera
from zenith_tpu_torch.core.cli import EngineArgs
from zenith_tpu_torch.core.events import (
    ElementState,
    KeyboardInput,
    KeyCode,
    MouseButton,
    MouseInput,
    MouseMotion,
)
from zenith_tpu_torch.core.mathtypes import Degree
from zenith_tpu_torch.launch import launch
from zenith_tpu_torch.sandbox import terrain as tterrain
from zenith_tpu_torch.window import Window

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
W, H = 128, 64
GRID = ["--", "--grid", "48"]


@pytest.fixture(autouse=True)
def _orbit_env(monkeypatch):
    monkeypatch.delenv("ZENITH_ORBIT_START", raising=False)
    monkeypatch.delenv("ZENITH_ORBIT_SPEED", raising=False)


def _lsb(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("n, seed", [(96, 3), (48, 7), (33, 11)])
def test_generators_equal_the_reference(n, seed):
    from zenith_tpu.sandbox import terrain as jterrain

    h = tterrain.fbm_heightmap(n, seed=seed)
    np.testing.assert_array_equal(h, jterrain.fbm_heightmap(n, seed=seed))
    for a, b in zip(tterrain.terrain_mesh(h, 100.0, 30.0), jterrain.terrain_mesh(h, 100.0, 30.0)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tterrain.terrain_albedo(h, 50.0, size=64),
                                  jterrain.terrain_albedo(h, 50.0, size=64))


def test_default_albedo_equals_the_reference():
    from zenith_tpu.sandbox import terrain as jterrain

    h = tterrain.fbm_heightmap(64, seed=7)
    np.testing.assert_array_equal(tterrain.terrain_albedo(h, 70.0), jterrain.terrain_albedo(h, 70.0))


def _port_frame(*flags):
    window = Window(width=W, height=H, title="t")
    loop = launch(tterrain.TerrainApp, argv=[*GRID, *flags], window=window, max_frames=2,
                  device="cpu")
    return loop, np.asarray(window.last_frame)


@pytest.fixture(scope="module")
def jax_frame():
    from zenith_tpu.launch import launch as jlaunch
    from zenith_tpu.sandbox.terrain import TerrainApp as JTerrainApp
    from zenith_tpu.window import Window as JWindow

    window = JWindow(width=W, height=H, title="t")
    loop = jlaunch(JTerrainApp, argv=GRID, window=window, max_frames=2)
    assert loop.app.tri_count == 2 * 47 * 47
    return np.asarray(window.last_frame)


@pytest.fixture(scope="module")
def port_frame():
    return _port_frame()


def test_terrain_app_frame_matches_the_reference(jax_frame, port_frame):
    loop, frame = port_frame
    assert loop.app.tri_count == 2 * 47 * 47 and loop.frames_rendered == 2
    assert frame.shape == (H, W, 4) and frame[..., :3].std() > 1.0  # terrain + sky
    mx, frac = _lsb(frame, jax_frame)
    assert mx <= 1 and frac < 0.01, (mx, frac)


def test_terrain_app_renders_the_atmosphere_and_its_options(port_frame):
    loop, frame = port_frame
    scene = loop.app.renderer.scene
    assert scene.atmosphere is not None and scene.skybox is None
    assert scene.objects[0].bin_capacity == 4096 and scene.objects[0].entry_budget == 1 << 20
    assert scene.sun.shadow_map_size == 2048 and not scene.sun.contact_shadows
    _, contact = _port_frame("--contact-shadows")
    _, flat = _port_frame("--no-sky")
    assert np.isfinite(contact.astype(np.float64)).all()
    assert (contact != frame).any() and (flat != frame).any()
    # The contact march only darkens.
    assert contact[..., :3].astype(int).sum() < frame[..., :3].astype(int).sum()


def test_serve_raises_naming_the_viewer_item(monkeypatch):
    """``--serve`` reaches the viewer's serve_loop through launch (which
    used to raise naming ROADMAP item 23). serve_loop and the engine loop
    are stubbed: the test checks the wiring, not a served session."""
    import zenith_tpu_torch.launch as launch_mod
    from zenith_tpu_torch import viewer

    calls = []

    class _Loop:
        def __init__(self, app, window=None, device="cuda"):
            self.app, self.window, self.device = app, window, device
            self.frames_rendered = 0

    monkeypatch.setattr(launch_mod, "EngineLoop", _Loop)
    monkeypatch.setattr(viewer, "serve_loop", lambda loop, **kw: calls.append((loop, kw)))
    monkeypatch.setattr(sys, "argv", ["terrain", "--serve", "--frames", "1", "--fps-cap", "24"])
    tterrain.main()
    (loop, kw), = calls
    assert isinstance(loop.app, tterrain.TerrainApp) and loop.device == "cuda"
    assert kw == {"port": 8089, "fps_cap": 24.0, "max_frames": None}


class _FakeWindow:
    def __init__(self):
        self.closed = False

    def request_close(self):
        self.closed = True


def _prep(app):
    """What prepare() would set for the interactive branch."""
    app.camera = Camera(fov_y=Degree(40.0), aspect_ratio=16 / 9)
    app.camera.set_position(np.array([0.0, -160.0, 30.0], np.float32))
    app._window = _FakeWindow()
    return app


def _apps():
    from zenith_tpu_torch.sandbox.scene import SceneApp

    return [("scene", _prep(SceneApp(EngineArgs.parse_args([])))),
            ("terrain", _prep(tterrain.TerrainApp(EngineArgs.parse_args([]))))]


@pytest.mark.parametrize("name,app", _apps())
class TestTakeover:
    """tests/test_interactive_takeover.py on the port's apps."""

    def test_starts_scripted(self, name, app):
        assert not app._interactive
        orbit0 = app.orbit
        app.tick(1 / 60)
        assert app.orbit != orbit0

    def test_input_takes_over_and_flies(self, name, app):
        app.on_window_event(KeyboardInput(KeyCode.KEY_W, ElementState.PRESSED))
        assert app._interactive
        pos0 = np.array(app.camera.location, np.float32)
        orbit0 = app.orbit
        for _ in range(30):
            app.tick(1 / 60)
        assert app.orbit == orbit0
        assert np.linalg.norm(np.array(app.camera.location) - pos0) > 1.0

    def test_mouse_look_requires_grab(self, name, app):
        app.on_window_event(MouseInput(MouseButton.LEFT, ElementState.PRESSED))
        assert app._interactive
        yaw0 = float(app.camera._yaw)
        app.on_device_event(MouseMotion(dx=300.0, dy=0.0))
        for _ in range(10):
            app.tick(1 / 60)
        assert float(app.camera._yaw) != yaw0

    def test_escape_closes_window(self, name, app):
        app.on_window_event(KeyboardInput(KeyCode.ESCAPE, ElementState.PRESSED))
        app.on_window_event(KeyboardInput(KeyCode.ESCAPE, ElementState.RELEASED))
        app.tick(1 / 60)
        assert app._window.closed
