"""The port's forward shadow renderer (BASELINE config #3) against the
reference's, on tests/test_renderers.py's scene (a cube over a ground quad,
a sun with a 128² shadow map) at 128×64 with 8×128 tiles, carried across by
zenith_tpu_torch.interop.

The JAX frames (each computed once for the module, the reference's Pallas
raster in interpret mode) are the plain scene at 1× and in wireframe, and
the scene with an instanced cube ring at 4× with ``sample_shading`` off:
its ``forward`` node's batched draw shades per sample (as the reference's
batch does in either mode) and its ``forward.inst`` node LOADs those
per-sample planes and shades once per pixel. The port renders the same
frames; the checks of test_renderers.py's TestForwardShadow
and TestWireframe (both renderers) run on the port's frames, and retained
``frame_dynamics`` re-runs the cached frame function.

Tolerance: the frame encoded as RGBA8 sRGB ≤ 1 LSB with < 1% of values
differing (the reference's own golden tolerance): the near-clipped ground
quad's positions differ by FMA contraction (ROADMAP §3), and the lighting
follows them. In the wireframe frame up to 0.1% of the pixels (8) may
differ by more: a one-pixel line whose centre lies on a pixel row has its
rectangle's borders on pixel centres, and there coverage follows the last
bit of the setup, which XLA's contraction moves.
"""

import dataclasses

import numpy as np
import pytest
import torch

from zenith_tpu_torch import interop
from zenith_tpu_torch.core.camera import Camera as TCamera
from zenith_tpu_torch.core.mathtypes import Degree, Radians
from zenith_tpu_torch.rendergraph import CompileOptions as TOptions
from zenith_tpu_torch.rendergraph import RenderGraphBuilder as TBuilder
from zenith_tpu_torch.renderer import DeferredRenderer as TDeferred
from zenith_tpu_torch.renderer import ForwardShadowRenderer as TForward
from zenith_tpu_torch.rhi import Format as TFormat
from zenith_tpu_torch.rhi import PipelineCache as TCache
from zenith_tpu_torch.rhi import RhiCore as TCore
from zenith_tpu_torch.rhi import TextureDesc as TTex
from zenith_tpu_torch.rhi import encode_present

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 64
RING = np.array([[-9.0, -3.0, 0.0], [9.0, -2.0, 0.0], [0.0, -10.0, 0.0]], np.float32)
# (name, instanced scene, renderer keywords) of the JAX frames.
FRAMES = {
    "1x": (False, {}),
    "wireframe": (False, dict(wireframe=True)),
    "4x-instanced-shade-once": (True, dict(msaa=4, sample_shading=False)),
}


def _camera(cls=TCamera):
    cam = cls(fov_y=Degree(45.0), aspect_ratio=W / H)
    cam.set_position(np.array([0.0, -60.0, 25.0], np.float32))
    cam.set_yaw_pitch(Radians(0.0), Radians(-0.25))
    return cam


def _jax_scene(instanced):
    from test_renderers import build_test_scene

    from zenith_tpu.renderer import SceneObject
    from zenith_tpu.rhi import RhiCore

    device = RhiCore().create_render_device()
    scene = build_test_scene(device)
    if instanced:
        rocks = SceneObject.cube(device, "rocks", size=5.0, z0=0.0,
                                 base_color=(0.2, 0.5, 0.9, 1.0), instance_offsets=RING)
        scene = dataclasses.replace(scene, objects=[*scene.objects, rocks])
    return scene


def _jax_frame(scene, kw):
    from test_renderers import make_camera

    from zenith_tpu.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu.renderer import ForwardShadowRenderer
    from zenith_tpu.rhi import Format, PipelineCache, RhiCore, TextureDesc, encode_present as enc

    device = RhiCore().create_render_device()
    builder = RenderGraphBuilder()
    color = builder.create(TextureDesc.color("rt", W, H))
    depth = builder.create(TextureDesc.depth("ds", W, H))
    builder.export(color)
    ForwardShadowRenderer(scene, **kw).render_to(builder, color, depth, make_camera())
    compiled = builder.build().compile(device, PipelineCache(), CompileOptions(tile_h=8,
                                                                               tile_w=128))
    compiled.execute(device)
    return np.asarray(enc(compiled.value(color), Format.RGBA8_SRGB))


def _port_graph(renderer, camera, clear_color=None):
    device = TCore(CPU).create_render_device()
    builder = TBuilder()
    color = builder.create(TTex.color("rt", W, H))
    depth = builder.create(TTex.depth("ds", W, H))
    builder.export(color)
    kw = {} if clear_color is None else dict(clear_color=clear_color)
    renderer.render_to(builder, color, depth, camera, **kw)
    compiled = builder.build().compile(device, TCache(), TOptions(tile_h=8, tile_w=128))
    compiled.execute(device)
    return compiled, color, device


def _port_hdr(renderer, camera=None, clear_color=None):
    compiled, color, _ = _port_graph(renderer, camera or _camera(), clear_color)
    return compiled.value(color).numpy()


def _encode(hdr):
    return encode_present(torch.from_numpy(hdr), TFormat.RGBA8_SRGB).numpy()


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene) for the plain and the instanced scene."""
    out = {}
    for instanced in (False, True):
        js = _jax_scene(instanced)
        out[instanced] = (js, interop.scene_from(js, CPU))
    return out


@pytest.fixture(scope="module")
def jax_frames(scenes):
    return {name: _jax_frame(scenes[inst][0], kw) for name, (inst, kw) in FRAMES.items()}


@pytest.fixture(scope="module")
def port_frames(scenes):
    frames = {name: _port_hdr(TForward(scenes[inst][1], **kw))
              for name, (inst, kw) in FRAMES.items()}
    frames["4x-instanced"] = _port_hdr(TForward(scenes[True][1], msaa=4))
    return frames


def _lsb(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def test_interop_carries_the_instanced_scene(scenes):
    js, ts = scenes[True]
    assert [o.name for o in ts.objects] == [o.name for o in js.objects]
    np.testing.assert_array_equal(ts.objects[-1].instance_offsets, RING)
    assert ts.objects[-1].instance_count == 3
    np.testing.assert_array_equal(ts.objects[0].vertex_buffer.array.numpy(),
                                  np.asarray(js.objects[0].vertex_buffer.array))


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_matches_the_reference(name, jax_frames, port_frames):
    img = _encode(port_frames[name])
    assert img.shape == jax_frames[name].shape == (H, W, 4)
    mx, frac = _lsb(img, jax_frames[name])
    if name == "wireframe":
        over = np.abs(img.astype(np.int16) - jax_frames[name].astype(np.int16)).max(-1) > 1
        assert frac < 0.01 and int(over.sum()) <= 8, (mx, frac, int(over.sum()))
    else:
        assert mx <= 1 and frac < 0.01, (mx, frac)


def test_shade_once_differs_from_per_sample_only_at_silhouettes(port_frames):
    """The instanced node's draw_indexed shades once per pixel with
    sample_shading off; the batched plain draw shades per sample either way."""
    a, b = port_frames["4x-instanced"], port_frames["4x-instanced-shade-once"]
    differs = np.abs(a - b).max(axis=-1) > 1e-6
    assert 0 < differs.mean() < 0.05


# tests/test_renderers.py::TestForwardShadow on the port.

def _px_of(cam, world):
    clip = cam.render_view_projection @ np.array([*world, 1.0], np.float32)
    ndc = clip[:3] / clip[3]
    return int((ndc[1] + 1) * 0.5 * H), int((ndc[0] + 1) * 0.5 * W)


def test_shadow_darkens_occluded_ground(port_frames):
    img, cam = port_frames["1x"], _camera()
    sy, sx = _px_of(cam, (0.0, 0.0, 0.0))
    ly, lx = _px_of(cam, (40.0, 0.0, 0.0))
    assert img[ly, lx, :3].sum() > img[sy, sx, :3].sum() * 1.5


def test_cube_visible_and_background_clear(scenes):
    img = _port_hdr(TForward(scenes[False][1]), clear_color=(0, 0, 1, 1))
    np.testing.assert_allclose(img[2, 2, :3], [0, 0, 1], atol=1e-5)
    center = img[H // 2, W // 2, :3]
    assert center[0] > center[2]


def test_forward_msaa_softens_silhouettes_only(scenes, port_frames):
    img1 = port_frames["1x"]
    img4 = _port_hdr(TForward(scenes[False][1], msaa=4))
    assert np.isfinite(img4).all()
    changed = np.abs(img4[..., :3] - img1[..., :3]).max(axis=-1) > 5e-3
    assert changed.any() and changed.mean() < 0.15


# tests/test_renderers.py::TestWireframe on the port.

def test_forward_wireframe_outlines_only(scenes):
    scene = scenes[False][1]
    filled = _port_hdr(TForward(scene), clear_color=(0, 0, 1, 1))
    wire = _port_hdr(TForward(scene, wireframe=True), clear_color=(0, 0, 1, 1))
    filled_cube = (filled[..., 0] > filled[..., 2]).sum()
    wire_cube = (wire[..., 0] > wire[..., 2]).sum()
    assert 0 < wire_cube < 0.6 * filled_cube, (wire_cube, filled_cube)
    c = wire[H // 2, W // 2, :3]
    assert c[2] > c[0]


def test_deferred_wireframe_outlines_only():
    from zenith_tpu_torch.sandbox.scene import golden_scene

    scene, cam = golden_scene(TCore(CPU).create_render_device(), num_lights=2)
    scene = dataclasses.replace(scene, skybox=None)

    def render(renderer):
        device = TCore(CPU).create_render_device()
        builder = TBuilder()
        color = builder.create(TTex.color("rt", W, H))
        builder.export(color)
        renderer.render_to(builder, color, cam, W, H)
        compiled = builder.build().compile(device, TCache(), TOptions(tile_h=8, tile_w=128))
        compiled.execute(device)
        return compiled.value(color).numpy()

    filled, wire = render(TDeferred(scene)), render(TDeferred(scene, wireframe=True))
    filled_lum, wire_lum = filled[..., :3].sum(-1), wire[..., :3].sum(-1)
    bg = filled_lum[2, 2]
    filled_cov = (filled_lum > bg + 0.05).sum()
    wire_cov = (wire_lum > bg + 0.05).sum()
    assert 0 < wire_cov < 0.6 * filled_cov, (wire_cov, filled_cov)


def test_retained_frame_dynamics_rerun_the_cached_frame(scenes):
    """``frame_dynamics`` (with ``include_models``) re-runs the compiled
    frame function at a new camera and moved objects: the same frame as a
    rebuild there."""
    scene = dataclasses.replace(scenes[True][1], objects=list(scenes[True][1].objects))
    renderer = TForward(scene, msaa=4)
    compiled, color, device = _port_graph(renderer, _camera())
    cam2 = _camera()
    cam2.set_position(np.array([6.0, -55.0, 22.0], np.float32))
    moved = dataclasses.replace(scene.objects[0],
                                model_matrix=np.asarray(scene.objects[0].model_matrix) @
                                np.diag([1.0, 1.0, 1.2, 1.0]).astype(np.float32))
    renderer.scene.objects[0] = moved
    dyn = renderer.frame_dynamics(cam2, include_models=True)
    assert set(dyn) == {"fwd.view_proj", "fwd.camera_pos", "fwd.models"}
    compiled.execute(device, dynamics=dyn)
    retained = compiled.value(color).numpy()
    rebuilt = _port_hdr(TForward(scene, msaa=4), cam2)
    np.testing.assert_array_equal(retained, rebuilt)
