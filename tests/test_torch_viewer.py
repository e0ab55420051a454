"""The port's interactive HTTP viewer (zenith_tpu_torch/viewer.py): the 19
cases of tests/test_viewer.py on the port (the wire contract without a
browser: input POSTed as JSON lands in the Window's queues as typed
events, frames come back over /frame and the MJPEG /stream, and the
adaptive stream's controller), plus parity with the reference package:

- ``keycode_from_js`` and ``decode_event`` give the reference's events for
  every contract code and wire message (compared by their fields);
- ``AdaptiveStream``'s rung ladder and its decisions equal the
  reference's under the same injected clock (the rung and quality after
  every present);
- ``encode_jpeg`` returns the reference's bytes and MIME for the same frame;
- one ``launch(TriangleApp, serve=0, device="cpu")`` run whose client reads
  two /stream parts, and ``probe_transport`` on the CPU.

Everything is host code: the comparisons are exact.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from zenith_tpu_torch import viewer as viewer_mod
from zenith_tpu_torch.core.events import (
    CloseRequested,
    ElementState,
    KeyboardInput,
    KeyCode,
    MouseButton,
    MouseInput,
    MouseMotion,
    Resized,
)
from zenith_tpu_torch.viewer import ViewerServer, decode_event, keycode_from_js
from zenith_tpu_torch.window import Window

torch.set_num_threads(1)


@pytest.fixture()
def served():
    window = Window(width=64, height=32, title="t")
    viewer = ViewerServer(window, port=0).start()
    yield window, viewer
    viewer.stop()


def _url(viewer, path):
    return viewer.url.rstrip("/") + path


def _post(viewer, path, payload):
    req = urllib.request.Request(
        _url(viewer, path), data=json.dumps(payload).encode(), method="POST"
    )
    with urllib.request.urlopen(req, timeout=5) as resp:
        return resp.status, json.loads(resp.read())


# -- tests/test_viewer.py::TestWireDecode ---------------------------------------


def test_js_keymap_covers_contract():
    assert keycode_from_js("KeyW") is KeyCode.KEY_W
    assert keycode_from_js("ShiftLeft") is KeyCode.SHIFT_LEFT
    assert keycode_from_js("ArrowUp") is KeyCode.ARROW_UP
    assert keycode_from_js("F13") is None  # outside the contract


def test_decode_key():
    ev = decode_event({"type": "key", "code": "KeyW", "state": "down"})
    assert ev == KeyboardInput(KeyCode.KEY_W, ElementState.PRESSED)
    ev = decode_event({"type": "key", "code": "KeyW", "state": "down", "repeat": True})
    assert ev.repeat
    ev = decode_event({"type": "key", "code": "KeyW", "state": "up"})
    assert ev.state is ElementState.RELEASED


def test_decode_button_motion_resize_close():
    assert decode_event(
        {"type": "button", "button": 0, "state": "down"}
    ) == MouseInput(MouseButton.LEFT, ElementState.PRESSED)
    m = decode_event({"type": "motion", "dx": 1.5, "dy": -0.25})
    assert m == MouseMotion(dx=1.5, dy=-0.25)
    assert decode_event({"type": "resize", "width": 800, "height": 600}) == Resized(800, 600)
    assert isinstance(decode_event({"type": "close"}), CloseRequested)


def test_decode_unknown_is_none():
    assert decode_event({"type": "key", "code": "F13", "state": "down"}) is None
    assert decode_event({"type": "gamepad"}) is None
    assert decode_event({}) is None


# -- TestEventsEndpoint -------------------------------------------------------------


def test_events_land_typed_in_window_queue(served):
    window, viewer = served
    status, body = _post(viewer, "/events", [
        {"type": "key", "code": "KeyW", "state": "down"},
        {"type": "button", "button": 0, "state": "down"},
        {"type": "motion", "dx": 2.0, "dy": 1.0},
        {"type": "key", "code": "F13", "state": "down"},  # dropped
    ])
    assert status == 200 and body["accepted"] == 3
    assert window.drain_window_events() == [
        KeyboardInput(KeyCode.KEY_W, ElementState.PRESSED),
        MouseInput(MouseButton.LEFT, ElementState.PRESSED),
    ]
    assert window.drain_device_events() == [MouseMotion(dx=2.0, dy=1.0)]


def test_close_event_reaches_queue(served):
    window, viewer = served
    _post(viewer, "/events", [{"type": "close"}])
    assert isinstance(window.drain_window_events()[0], CloseRequested)


def test_bad_json_is_400(served):
    _window, viewer = served
    req = urllib.request.Request(_url(viewer, "/events"), data=b"{nope", method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=5)
    assert exc.value.code == 400


# -- TestFrameDelivery -------------------------------------------------------------------


def _present(window, seed=0):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 255, (window.height, window.width, 4), dtype=np.uint8)
    window.present(frame, window.presented_frames)
    return frame


def test_frame_endpoint_encodes_latest_present(served):
    window, viewer = served
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(_url(viewer, "/frame"), timeout=5)
    assert exc.value.code == 503  # nothing presented yet
    frame = _present(window)
    with urllib.request.urlopen(_url(viewer, "/frame"), timeout=5) as resp:
        assert resp.status == 200
        mime = resp.headers["Content-Type"]
        data = resp.read()
    assert mime in ("image/jpeg", "image/png") and len(data) > 100
    magic = {b"\xff\xd8": "image/jpeg", b"\x89P": "image/png"}
    assert magic[data[:2]] == mime
    # /frame is the encode of the last presented frame.
    assert (data, mime) == viewer_mod.encode_jpeg(frame, viewer.quality)


def test_stats_endpoint(served):
    window, viewer = served
    _present(window)
    with urllib.request.urlopen(_url(viewer, "/stats"), timeout=5) as resp:
        stats = json.loads(resp.read())
    assert stats == {
        "presented_frames": 1, "width": 64, "height": 32, "closed": False,
        "quality": 85,
    }


def test_stream_yields_multipart_frames(served):
    window, viewer = served
    _present(window)

    def keep_presenting():
        for i in range(20):
            _present(window, seed=i + 1)
            time.sleep(0.01)

    t = threading.Thread(target=keep_presenting, daemon=True)
    t.start()
    with urllib.request.urlopen(_url(viewer, "/stream"), timeout=5) as resp:
        assert "multipart/x-mixed-replace" in resp.headers["Content-Type"]
        blob = resp.read(40000)
    t.join()
    assert blob.count(b"--zenithframe") >= 1
    assert b"Content-Type: image/" in blob


def test_present_hook_chains():
    seen = []
    window = Window(width=8, height=8, on_present=lambda img, i: seen.append(i))
    viewer = ViewerServer(window, port=0).start()
    try:
        window.present(np.zeros((8, 8, 4), np.uint8), 7)
        assert seen == [7]
        assert viewer.wait_frame(0, timeout=1.0) == 1
    finally:
        viewer.stop()


# -- TestAdaptiveStream -------------------------------------------------------------------
# Time is injected by monkeypatching time.perf_counter so the hysteresis
# windows are deterministic.


def _make(monkeypatch, target=30.0, view=(1280, 720), mod=viewer_mod, window_cls=Window):
    clock = [1000.0]
    monkeypatch.setattr(mod.time, "perf_counter", lambda: clock[0])
    window = window_cls(width=view[0], height=view[1], title="t")
    adaptive = mod.AdaptiveStream(window, target_fps=target)
    return adaptive, window, clock


def _run_frames(adaptive, clock, fps, seconds, trace=None):
    dt = 1.0 / fps
    end = clock[0] + seconds
    while clock[0] < end:
        clock[0] += dt
        adaptive.note_present()
        if trace is not None:
            q = adaptive.viewer.quality if adaptive.viewer is not None else None
            trace.append((adaptive.rung, q, round(adaptive.measured_fps, 6)))


def test_rung_ladder_preserves_aspect_and_dedups(monkeypatch):
    adaptive, _, _ = _make(monkeypatch)
    assert adaptive.rungs[0] == (1280, 720)
    aspect = 1280 / 720
    for w, h in adaptive.rungs:
        assert w % 8 == 0 and h % 8 == 0
        assert abs(w / h - aspect) < 0.06
    assert len(adaptive.rungs) == len(set(adaptive.rungs))
    assert sorted(adaptive.rungs, reverse=True) == adaptive.rungs


def test_pick_initial_from_probe(monkeypatch):
    adaptive, window, _ = _make(monkeypatch, target=30.0)
    # 720p too slow (50 ms > 30 ms budget), the next rung fits.
    probe = {adaptive.rungs[0]: {"ms": 50.0}, adaptive.rungs[1]: {"ms": 20.0}}
    w, h = adaptive.pick_initial(probe)
    assert (w, h) == adaptive.rungs[1]
    ev = window.drain_window_events()
    assert ev and ev[-1] == Resized(w, h)


def test_pick_initial_all_slow_lands_bottom(monkeypatch):
    adaptive, _, _ = _make(monkeypatch)
    probe = {wh: {"ms": 500.0} for wh in adaptive.rungs}
    assert adaptive.pick_initial(probe) == adaptive.rungs[-1]


def test_sustained_shortfall_steps_down(monkeypatch):
    adaptive, window, clock = _make(monkeypatch, target=30.0)
    adaptive._apply()
    window.drain_window_events()
    _run_frames(adaptive, clock, fps=15.0, seconds=6.0)
    assert adaptive.rung >= 1
    assert any(isinstance(e, Resized) for e in window.drain_window_events())


def test_headroom_steps_up_after_hold(monkeypatch):
    adaptive, window, clock = _make(monkeypatch, target=30.0)
    adaptive.rung = 2
    adaptive._apply()
    window.drain_window_events()
    # 60 FPS at rung 2: the pixel-scaled prediction clears the target.
    _run_frames(adaptive, clock, fps=60.0, seconds=8.0)
    assert adaptive.rung < 2
    assert any(isinstance(e, Resized) for e in window.drain_window_events())


def test_failed_rung_is_not_reentered_soon(monkeypatch):
    adaptive, window, clock = _make(monkeypatch, target=30.0)
    # State after falling off rung 0: it failed just now.
    adaptive._failed_at[0] = clock[0]
    adaptive.rung = 1
    adaptive._apply()
    window.drain_window_events()
    # Plenty of headroom, but rung 0 just failed: hold for 20 s.
    _run_frames(adaptive, clock, fps=60.0, seconds=8.0)
    assert adaptive.rung == 1
    _run_frames(adaptive, clock, fps=60.0, seconds=15.0)
    assert adaptive.rung == 0


def test_bottom_rung_degrades_quality_then_recovers(monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(viewer_mod.time, "perf_counter", lambda: clock[0])
    window = Window(width=256, height=144, title="t")
    server = ViewerServer(window, port=0)  # not started; quality holder
    adaptive = viewer_mod.AdaptiveStream(window, target_fps=30.0, viewer=server)
    adaptive.rung = len(adaptive.rungs) - 1
    adaptive._apply()
    base_q = server.quality
    _run_frames(adaptive, clock, fps=12.0, seconds=8.0)
    assert server.quality < base_q
    _run_frames(adaptive, clock, fps=40.0, seconds=10.0)
    assert server.quality == base_q


def test_stats_reports_adaptive_state(served):
    window, viewer = served
    viewer.adaptive = viewer_mod.AdaptiveStream(window, target_fps=30.0, viewer=viewer)
    with urllib.request.urlopen(_url(viewer, "/stats"), timeout=5) as r:
        stats = json.loads(r.read())
    assert stats["view_width"] == 64 and stats["view_height"] == 32
    assert "rung" in stats and "fps" in stats


# -- parity with the reference package --------------------------------------------


def _fields(ev):
    """A typed event as comparable plain data (enum members by name)."""
    if ev is None:
        return None
    import dataclasses

    return (type(ev).__name__, tuple(
        getattr(v, "name", v) for v in dataclasses.astuple(ev)))


WIRE = [
    *({"type": "key", "code": code, "state": st, "repeat": rep}
      for code in [*viewer_mod._JS_KEYMAP, "F13", ""] for st in ("down", "up")
      for rep in (False, True)),
    *({"type": "button", "button": b, "state": st} for b in (0, 1, 2, 3) for st in ("down", "up")),
    {"type": "motion", "dx": 1.5, "dy": -0.25}, {"type": "motion"},
    {"type": "resize", "width": 800, "height": 600}, {"type": "close"},
    {"type": "gamepad"}, {},
]


def test_wire_decode_equals_the_reference():
    from zenith_tpu import viewer as ref

    assert list(viewer_mod._JS_KEYMAP) == list(ref._JS_KEYMAP)
    for code in [*ref._JS_KEYMAP, "F13", "KeyZ"]:
        got, want = keycode_from_js(code), ref.keycode_from_js(code)
        assert (got and got.name) == (want and want.name)
    for msg in WIRE:
        assert _fields(decode_event(msg)) == _fields(ref.decode_event(msg)), msg


@pytest.mark.parametrize("view", [(1280, 720), (1920, 1080), (64, 32)])
def test_adaptive_ladder_and_decisions_equal_the_reference(monkeypatch, view):
    """The same present cadence (shortfall, headroom, bottom-rung quality
    fall and recovery) under the same clock: the port's rung, quality and
    measured FPS after every present equal the reference's."""
    from zenith_tpu import viewer as ref
    from zenith_tpu.window import Window as RefWindow

    traces = []
    for mod, window_cls, server_cls in ((viewer_mod, Window, ViewerServer),
                                        (ref, RefWindow, ref.ViewerServer)):
        clock = [1000.0]
        monkeypatch.setattr(mod.time, "perf_counter", lambda: clock[0])
        window = window_cls(width=view[0], height=view[1], title="t")
        server = server_cls(window, port=0)  # not started; quality holder
        adaptive = mod.AdaptiveStream(window, target_fps=30.0, viewer=server)
        probe = {wh: {"ms": 20.0 + 40.0 * (len(adaptive.rungs) - i)}
                 for i, wh in enumerate(adaptive.rungs)}
        trace = [tuple(adaptive.rungs), adaptive.pick_initial(probe)]
        for fps, secs in ((14.0, 12.0), (9.0, 10.0), (45.0, 12.0), (70.0, 30.0)):
            _run_frames(adaptive, clock, fps, secs, trace)
        trace.append([(type(e).__name__, e.width, e.height)
                      for e in window.drain_window_events()])
        traces.append(trace)
    assert traces[0] == traces[1]


def test_encode_jpeg_equals_the_reference():
    from zenith_tpu import viewer as ref

    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 255, (24, 40, 4), dtype=np.uint8),
              rng.uniform(0.0, 1.2, (16, 32, 4)).astype(np.float32)]
    for frame in frames:
        for quality in (50, 85):
            assert viewer_mod.encode_jpeg(frame, quality) == ref.encode_jpeg(frame, quality)


def test_probe_transport_on_the_cpu():
    probe = viewer_mod.probe_transport([(64, 32), (32, 16)], frames=4, device="cpu")
    assert set(probe) == {(64, 32), (32, 16)}
    for row in probe.values():
        assert set(row) == {"readback_ms", "jpeg_ms", "ms"}
        assert row["readback_ms"] >= 0.0 and row["jpeg_ms"] > 0.0


def test_launch_serves_the_triangle_app_over_a_stream():
    """launch(TriangleApp, serve=0) on the CPU: a client reads two /stream
    parts while the loop renders, then closes it with a close event; the
    loop ends by itself and leaves no HTTP thread alive."""
    from zenith_tpu_torch.launch import launch
    from zenith_tpu_torch.sandbox.triangle import TriangleApp

    window = Window(width=64, height=32, title="t")
    parts: list = []
    started = threading.Event()
    orig_start = ViewerServer.start

    def client(viewer):
        with urllib.request.urlopen(_url(viewer, "/stream"), timeout=30) as resp:
            blob = b""
            while blob.count(b"--zenithframe") < 3:
                chunk = resp.read1(65536)
                if not chunk:
                    break
                blob += chunk
        for part in blob.split(b"--zenithframe")[1:3]:
            head, _, body = part.partition(b"\r\n\r\n")
            n = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
            parts.append((head, body[:n]))
        _post(viewer, "/events", [{"type": "close"}])

    def start(self):
        out = orig_start(self)
        threading.Thread(target=client, args=(self,), daemon=True).start()
        started.set()
        return out

    ViewerServer.start = start
    try:
        loop = launch(TriangleApp, argv=[], window=window, serve=0, fps_cap=240.0,
                      max_frames=2000, device="cpu")
    finally:
        ViewerServer.start = orig_start
    assert started.is_set() and len(parts) == 2
    for head, body in parts:
        mime = "image/jpeg" if body[:2] == b"\xff\xd8" else "image/png"
        assert f"Content-Type: {mime}".encode() in head
    assert window.closed and loop.frames_rendered < 2000
    assert not any(t.name == "zenith-viewer" and t.is_alive() for t in threading.enumerate())
