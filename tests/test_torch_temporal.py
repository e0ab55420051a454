"""The temporal passes in the port (renderer/taa.py, renderer/motion_blur.py
and the engine's request_output feedback) against the reference package
on the same numpy-seeded inputs (the velocity plane is
test_torch_velocity.py's).

Tolerances: the Halton sequence, the jittered camera matrix and the
velocity dilation equal the reference's; the TAA and motion-blur resolves
atol 1e-5 (tests/test_taa.py:105, :139, :168). The SPMD cases
(test_taa.py:273, test_motion_blur.py:197; tests/test_torch_spmd_twins.py): each node
over 8 row bands, the reference's atol 1e-5 against single-device and
against the JAX 8-device frame.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_shadow_frames import cameras
from zenith_tpu_torch.renderer import DeferredRenderer, MotionBlur, PostProcess, TemporalAA
from zenith_tpu_torch.renderer.motion_blur import dilate_velocity, motion_blur_resolve
from zenith_tpu_torch.renderer.taa import halton, jitter_sequence, taa_resolve

torch.set_num_threads(1)
W, H = 128, 64


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def test_halton_and_jitter_sequence_equal_the_reference():
    from zenith_tpu.renderer import taa as ref

    assert [halton(i, b) for i in range(1, 40) for b in (2, 3, 5)] == \
        [ref.halton(i, b) for i in range(1, 40) for b in (2, 3, 5)]
    assert jitter_sequence(16) == ref.jitter_sequence(16)


def test_jittered_camera_equals_the_reference():
    from zenith_tpu.renderer import TemporalAA as JTAA

    jcam, cam = cameras(45.0, W / H, (3.0, -60.0, 25.0), 0.2, -0.25)
    taa, jtaa = TemporalAA(), JTAA()
    for _ in range(10):
        taa.jitter_camera(cam, W, H)
        jtaa.jitter_camera(jcam, W, H)
        np.testing.assert_array_equal(cam.render_view_projection, jcam.render_view_projection)
        np.testing.assert_array_equal(cam.render_view_projection_unjittered,
                                      jcam.render_view_projection_unjittered)
    assert not np.array_equal(cam.render_view_projection, cam.render_view_projection_unjittered)


def _resolve_inputs(rng, h=40, w=56):
    """A frame, a history, world positions on a tilted plane (a quarter of
    them background), a view-projection and the same one moved."""
    _, cam = cameras(50.0, w / h, (2.0, -30.0, 12.0), 0.1, -0.3)
    vp = cam.render_view_projection_unjittered
    inv = np.linalg.inv(vp.astype(np.float64))
    ys, xs = np.mgrid[0:h, 0:w]
    ndc = np.stack([(xs + 0.5) / w * 2 - 1, (ys + 0.5) / h * 2 - 1,
                    np.full(xs.shape, 0.004), np.ones(xs.shape)], -1)
    p = ndc @ inv.T
    world = (p[..., :3] / p[..., 3:]).astype(np.float32)
    depth = np.full((h, w), 0.004, np.float32)
    depth[: h // 4] = 0.0
    cam.set_position(np.array([4.0, -28.0, 12.5], np.float32))
    prev_vp = cam.render_view_projection_unjittered
    cur = rng.uniform(0.0, 3.0, (h, w, 4)).astype(np.float32)
    hist = rng.uniform(0.0, 3.0, (h, w, 4)).astype(np.float32)
    return cur, hist, world, depth, prev_vp


def test_taa_resolve_matches_the_reference(rng):
    from zenith_tpu.renderer.taa import taa_resolve as ref

    cur, hist, world, depth, prev_vp = _resolve_inputs(rng)
    for valid in (0.0, 1.0):
        got = taa_resolve(*(torch.from_numpy(x) for x in (cur, hist, world, depth, prev_vp)),
                          torch.tensor(valid)).numpy()
        want = np.asarray(jax.jit(ref)(cur, hist, world, depth, prev_vp, np.float32(valid)))
        np.testing.assert_allclose(got, want, atol=1e-5)
        if valid == 0.0:
            np.testing.assert_array_equal(got, cur)
    assert np.abs(got - cur).max() > 0.1
    # The 3x3 clamp does not wrap: a bright column at the right edge never
    # reaches the left edge's history clamp.
    edge = cur.copy()
    edge[:, -1, :3] = 50.0
    got = taa_resolve(*(torch.from_numpy(x) for x in (edge, hist, world, depth, prev_vp)),
                      torch.tensor(1.0)).numpy()
    assert got[:, 0, :3].max() < 4.0


@pytest.mark.parametrize("jitter,dilate", [(False, 0), (True, 1)])
def test_motion_blur_resolve_matches_the_reference(rng, jitter, dilate):
    from zenith_tpu.renderer.motion_blur import motion_blur_resolve as ref

    cur, _, world, depth, prev_vp = _resolve_inputs(rng)
    params = np.array([1.0, 12.0, 0.0, 0.0], np.float32)
    got = motion_blur_resolve(*(torch.from_numpy(x) for x in (cur, world, depth, prev_vp,
                                                              params)), 8, jitter, dilate).numpy()
    want = np.asarray(jax.jit(lambda *a: ref(*a, 8, jitter, dilate))(cur, world, depth, prev_vp,
                                                                      params))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - cur).max() > 0.1


def test_dilate_velocity_equals_the_reference(rng):
    from zenith_tpu.renderer.motion_blur import dilate_velocity as ref

    vx, vy = (rng.normal(size=(23, 31)).astype(np.float32) for _ in range(2))
    for r in (1, 2):
        got = dilate_velocity(torch.from_numpy(vx), torch.from_numpy(vy), r)
        want = jax.jit(lambda a, b: ref(a, b, r))(vx, vy)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


class _TemporalApp:
    """A deferred app with TAA, motion blur and auto-exposure, its state
    fed back through request_output / on_frame_outputs."""

    def __init__(self, retained: bool):
        self.retained = retained
        self.seen = []

    def prepare(self, render_device, window):
        from zenith_tpu_torch.sandbox.scene import golden_scene

        self.scene, self.camera = golden_scene(render_device, num_lights=2)
        self.renderer = DeferredRenderer(self.scene, velocity=True)
        self.taa, self.mblur = TemporalAA(), MotionBlur()
        self.post = PostProcess(auto_exposure=True)
        self.x = 0.0

    def tick(self, dt):
        self.x += 1.5
        self.camera.set_position(np.array([self.x, -60.0, 25.0], np.float32))
        self.taa.jitter_camera(self.camera, W, H)
        self.post.set_delta_time(dt)

    def update_dynamics(self):
        if not self.retained:
            return None
        d = self.renderer.frame_dynamics(self.camera, include_models=True)
        for part in (self.taa.frame_dynamics(self.camera), self.post.frame_dynamics(),
                     self.mblur.frame_dynamics(self.camera)):
            d.update(part)
        return d

    def render(self, context):
        from zenith_tpu_torch.rhi import Format, TextureDesc

        b = context.builder()
        out = b.import_resource(context.swapchain_texture())
        hdr, t, m = (b.create(TextureDesc.color(n, W, H, Format.RGBA32F))
                     for n in ("hdr", "taa", "mblur"))
        self.renderer.render_to(b, hdr, self.camera, W, H)
        self.taa.render_to(b, hdr, t, self.camera, W, H, self.renderer.gbuffer_handles)
        context.request_output("taa.history", t)
        self.mblur.render_to(b, t, m, self.camera, self.renderer.gbuffer_handles)
        self.post.render_to(b, m, out)
        context.request_output("post.ae", self.post.exposure_out)

    def on_frame_outputs(self, outputs):
        self.seen.append({k: (torch.Tensor if isinstance(v, torch.Tensor) else type(v),
                              tuple(v.shape)) for k, v in outputs.items()})
        self.taa.feedback(outputs["taa.history"])
        self.post.feedback(outputs["post.ae"])


@pytest.mark.parametrize("retained", [False, True])
def test_request_output_round_trips_with_one_compile(monkeypatch, retained):
    """Three frames through the engine, rebuilt or retained: TAA's history
    and the exposure come back as device tensors every frame and feed the
    next, and one frame function serves all three (frame 0's host
    placeholders share the fed-back tensors' shapes and dtypes)."""
    from zenith_tpu_torch.engine import Engine
    from zenith_tpu_torch.rendergraph import graph
    from zenith_tpu_torch.window import Window

    builds = []
    orig = graph.RenderGraph._build_frame_fn
    monkeypatch.setattr(graph.RenderGraph, "_build_frame_fn",
                        lambda self, *a: builds.append(1) or orig(self, *a))
    graph.clear_frame_program_cache()
    engine = Engine(Window(width=W, height=H, title="t"), device="cpu")
    app = _TemporalApp(retained)
    app.prepare(engine.render_device, engine.window)
    history = []
    for _ in range(3):
        app.tick(0.016)
        engine.render(app)
        history.append(app.taa._history)
    engine.shutdown()
    assert len(builds) == 1
    assert app.seen == [{"taa.history": (torch.Tensor, (H, W, 4)),
                         "post.ae": (torch.Tensor, (1,))}] * 3
    assert app.taa._history is not None and app.post._ae_state is not None
    assert len({id(h) for h in history}) == 3 and not torch.equal(history[1], history[2])


def _temporal_planes(h2, w2):
    """The SPMD cases' generated inputs: a patterned HDR frame over a world
    plane at z = 0 spanning the view."""
    from test_torch_spmd_twins import grid

    rows, cols = grid(h2, w2)
    base = 0.3 + 0.5 * np.sin(rows * 0.11) * np.cos(cols * 0.07)
    wx = (cols / w2 - 0.5) * 60.0
    wy = (rows / h2 - 0.5) * 30.0 + 10.0
    z = np.zeros_like(wx)
    return {"hdr": np.stack([base, 1.0 - base, base * 0.5, np.ones_like(base)], -1),
            "gpos": np.stack([wx, wy, z, z], -1), "gdep": np.full((h2, w2), 0.5, np.float32)}


def _spmd_camera(pkg, h2, w2, x=0.0, yaw=0.0):
    camera, mt = pkg.mod("core.camera"), pkg.mod("core.mathtypes")
    cam = camera.Camera(fov_y=mt.Degree(40.0), aspect_ratio=w2 / h2)
    cam.set_position(np.array([x, -40.0, 10.0], np.float32))
    cam.set_yaw_pitch(mt.Radians(yaw), mt.Radians(-0.2))
    return cam


def test_spmd_taa_node_sharded_matches_single(cpu_devices):
    """The TAA node over 8 row bands: reprojection gathers run on the
    gathered full surfaces and the band slices back."""
    from test_torch_spmd_twins import triplet

    h2, w2 = 256, 128
    history = np.random.default_rng(5).uniform(0, 1, (h2, w2, 4)).astype(np.float32)

    def add(pkg, builder, h):
        import jax.numpy as jnp

        taa = pkg.mod("renderer").TemporalAA()
        taa.feedback(jnp.asarray(history) if pkg.is_ref else torch.from_numpy(history))
        taa._hw = (h2, w2)  # seed so the feedback survives render_to
        out = builder.create(pkg.mod("rhi").TextureDesc.color("taa.out", w2, h2))
        taa.render_to(builder, h["hdr"], out, _spmd_camera(pkg, h2, w2), w2, h2,
                      {"pos": h["gpos"], "depth": h["gdep"]})
        return [out]

    (img1,), (img8,), (jimg,) = triplet(_temporal_planes(h2, w2), add)
    assert img1[..., :3].std() > 0.01
    np.testing.assert_allclose(img8, img1, atol=1e-5)
    np.testing.assert_allclose(img8, jimg, atol=1e-5)


def test_spmd_motion_blur_node_sharded_matches_single(cpu_devices):
    """The motion-blur node over 8 row bands, after a one-frame camera move
    (real velocity): streak taps on the gathered full surfaces."""
    from test_torch_spmd_twins import triplet

    h2, w2 = 256, 128

    def add(pkg, builder, h):
        mb = pkg.mod("renderer").MotionBlur(strength=1.0, max_radius=24.0)
        mb._observe_camera(_spmd_camera(pkg, h2, w2))
        out = builder.create(pkg.mod("rhi").TextureDesc.color("mb.out", w2, h2))
        mb.render_to(builder, h["hdr"], out, _spmd_camera(pkg, h2, w2, x=3.0, yaw=0.05),
                     {"pos": h["gpos"], "depth": h["gdep"]})
        return [out, h["hdr"]]

    (img1, src1), (img8, _), (jimg, _) = triplet(_temporal_planes(h2, w2), add)
    assert np.abs(img1[..., :3] - src1[..., :3]).max() > 1e-3  # the blur moved energy
    np.testing.assert_allclose(img8, img1, atol=1e-5)
    np.testing.assert_allclose(img8, jimg, atol=1e-5)
