"""The port's deferred scene (shadow → batched G-buffer → tiled lighting →
skybox → bloom + ACES) against the reference package's on the scene of
tests/test_golden.py: build_test_scene(num_lights=8) with a 16² sky cube at
128×64 with 8×128 tiles, carried across by zenith_tpu_torch.interop.

Tolerances: the encoded frame ≤ 1 LSB with < 1% of values differing, against
the JAX frame and against tests/golden/deferred_scene_128x64.npy (the
reference's own golden tolerance). G-buffer coverage, albedo and normals
exact; depth atol 1e-6. World positions atol 0.05 units: on the 200-unit
ground quad, near-clipped behind the camera, the port's raster rounds every
product (as the TPU kernel does) where XLA's CPU backend contracts
multiply-adds into FMAs (ROADMAP §3); against a float64 ray cast the port's
ground positions are within 0.05 and the reference's within 0.01. The HDR
lighting follows those positions: rtol 1e-2 / atol 1e-3.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from zenith_tpu_torch import interop
from zenith_tpu_torch.rendergraph import CompileOptions as TOptions
from zenith_tpu_torch.renderer import DeferredRenderer as TDeferred
from zenith_tpu_torch.rhi import Format as TFormat, RhiCore as TCore, encode_present
from zenith_tpu_torch.sandbox.scene import deferred_frame, golden_scene

torch.set_num_threads(1)
GOLDEN = Path(__file__).parent / "golden" / "deferred_scene_128x64.npy"
PLANES = ("albedo", "normal", "pos", "depth", "hdr")
CPU = torch.device("cpu")


def _jax_frame():
    """The reference frame of test_golden.py, with the G-buffer planes and
    the HDR lighting output kept."""
    from test_renderers import H, OPTS, W, build_test_scene, make_camera

    from zenith_tpu.renderer import DeferredRenderer, PostProcess
    from zenith_tpu.rendergraph import RenderGraphBuilder
    from zenith_tpu.rhi import Format, PipelineCache, RhiCore, TextureDesc
    from zenith_tpu.rhi import encode_present as jencode
    from zenith_tpu.sandbox.scene import sky_cube_texture

    device = RhiCore().create_render_device()
    scene = dataclasses.replace(build_test_scene(device, num_lights=8),
                                skybox=sky_cube_texture(16))
    renderer = DeferredRenderer(scene)
    builder = RenderGraphBuilder()
    hdr = builder.create(TextureDesc.color("hdr", W, H, Format.RGBA32F))
    out = builder.create(TextureDesc.color("ldr", W, H, Format.RGBA32F))
    builder.export(out)
    renderer.render_to(builder, hdr, make_camera(), W, H)
    PostProcess().render_to(builder, hdr, out)
    handles = dict(renderer.gbuffer_handles, hdr=hdr)
    for name in PLANES:
        builder.export(handles[name])
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    planes = {k: np.asarray(compiled.value(handles[k])) for k in PLANES}
    return scene, np.asarray(jencode(compiled.value(out), Format.RGBA8_SRGB)), planes


def _port_frame(scene, camera):
    device = TCore(CPU).create_render_device()
    renderer = TDeferred(scene)
    compiled, out, hdr, _ = deferred_frame(
        device, renderer, camera, 128, 64, TOptions(tile_h=8, tile_w=128),
        exports=PLANES)
    handles = dict(renderer.gbuffer_handles, hdr=hdr)
    planes = {k: compiled.value(handles[k]).numpy() for k in PLANES}
    return encode_present(compiled.value(out), TFormat.RGBA8_SRGB).numpy(), planes


@pytest.fixture(scope="module")
def frames():
    jscene, jimg, jplanes = _jax_frame()
    _, cam = golden_scene(TCore(CPU).create_render_device())
    timg, tplanes = _port_frame(interop.scene_from(jscene, CPU), cam)
    return {"jax": (jimg, jplanes), "port": (timg, tplanes), "camera": cam}


def _lsb(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("against", ["jax-frame", "golden"])
def test_frame_matches(frames, against):
    timg = frames["port"][0]
    ref = frames["jax"][0] if against == "jax-frame" else np.load(GOLDEN)
    assert timg.shape == ref.shape == (64, 128, 4) and timg.dtype == np.uint8
    mx, frac = _lsb(timg, ref)
    assert mx <= 1 and frac < 0.01, (mx, frac)


@pytest.mark.parametrize("plane, atol", [("albedo", 0.0), ("normal", 0.0), ("pos", 0.05),
                                         ("depth", 1e-6)])
def test_gbuffer_planes_match(frames, plane, atol):
    t, j = frames["port"][1][plane], frames["jax"][1][plane]
    t = t.reshape(j.shape)
    tcov = frames["port"][1]["depth"] > 0
    jcov = frames["jax"][1]["depth"].reshape(tcov.shape) > 0
    np.testing.assert_array_equal(tcov, jcov)
    assert tcov.mean() > 0.3
    np.testing.assert_allclose(t, j, atol=atol, rtol=0)


def test_ground_positions_against_a_float64_ray_cast(frames):
    """Where the ground (z = 0) is drawn, the G-buffer world position is the
    camera ray's hit with the plane, computed here in float64."""
    cam, pos = frames["camera"], frames["port"][1]["pos"]
    h, w = pos.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w]
    ndc = np.stack([(xs + 0.5) / w * 2 - 1, (ys + 0.5) / h * 2 - 1,
                    np.full(xs.shape, 0.5), np.ones(xs.shape)], -1)
    p = ndc @ np.asarray(cam.render_inv_view_projection, np.float64).T
    eye = np.asarray(cam.location, np.float64)
    d = p[..., :3] / p[..., 3:4] - eye
    hit = eye + (-eye[2] / d[..., 2])[..., None] * d
    ground = (np.abs(pos[..., 2]) < 1e-3) & (frames["port"][1]["depth"] > 0)
    assert ground.sum() > 1000
    np.testing.assert_allclose(pos[..., :3][ground], hit[ground], atol=0.05, rtol=0)


def test_hdr_lighting_matches(frames):
    t, j = frames["port"][1]["hdr"], frames["jax"][1]["hdr"]
    np.testing.assert_allclose(t, j, rtol=1e-2, atol=1e-3)
    assert t[..., :3].max() > 0.5  # lit, not the flat ambient


def test_the_chip_smoke_scene_is_the_golden_scene(frames):
    """sandbox.scene.golden_scene (chip_smoke.py's phase 6) builds the same scene as
    the interop copy of the reference's: the same frame, bit for bit."""
    scene, cam = golden_scene(TCore(CPU).create_render_device())
    img, planes = _port_frame(scene, cam)
    np.testing.assert_array_equal(img, frames["port"][0])
    np.testing.assert_array_equal(planes["hdr"], frames["port"][1]["hdr"])


def test_scene_tables_and_static_batch_match_the_reference():
    from test_renderers import build_test_scene

    from zenith_tpu.renderer.forward import sun_view_projection as jsvp
    from zenith_tpu.renderer.static_batch import StaticGeometryCache as JCache
    from zenith_tpu.rhi import RhiCore
    from zenith_tpu.renderer.scene import SpotLight as JSpot
    from zenith_tpu_torch.renderer.forward import sun_view_projection as tsvp
    from zenith_tpu_torch.renderer.static_batch import StaticGeometryCache as TCache

    jscene = build_test_scene(RhiCore().create_render_device(), num_lights=5)
    jscene.spot_lights = [JSpot(position=(1, 2, 3), direction=(0, 1, -1)),
                          JSpot(position=(-4, 0, 9), inner_deg=10, outer_deg=30)]
    tscene = interop.scene_from(jscene, CPU)
    for name in ("point_light_arrays", "spot_light_arrays"):
        for a, b in zip(getattr(tscene, name)(), getattr(jscene, name)()):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsvp(tscene.sun), jsvp(jscene.sun))
    jgeo = JCache().get(jscene.objects, [0, 1])
    tgeo = TCache().get(tscene.objects, [0, 1])
    assert tgeo.ranges == jgeo.ranges
    assert tgeo.__zenith_capture_key__() == jgeo.__zenith_capture_key__()
    np.testing.assert_array_equal(tgeo.vb.array.numpy(), np.asarray(jgeo.vb.array))
    np.testing.assert_array_equal(tgeo.ib.array.numpy(), np.asarray(jgeo.ib.array))
    assert TCache().get(tscene.objects, [0]) is None  # one draw: no batching


def test_post_matches_the_reference_at_odd_sizes():
    import jax.numpy as jnp

    from zenith_tpu.renderer.post import tone_and_bloom as jtb
    from zenith_tpu_torch.renderer.post import tone_and_bloom as ttb

    hdr = np.random.default_rng(3).uniform(0, 4, (37, 51, 4)).astype(np.float32)
    np.testing.assert_allclose(ttb(torch.from_numpy(hdr)).numpy(),
                               np.asarray(jtb(jnp.asarray(hdr))), atol=1e-6)


def test_unported_branches_name_their_roadmap_item():
    from zenith_tpu_torch.renderer import PointLight, PostProcess, SceneObject
    from zenith_tpu_torch.rhi import Texture

    device = TCore(CPU).create_render_device()
    scene, _ = golden_scene(device)
    tex = Texture.from_numpy("t", np.ones((2, 2, 4), np.float32), TFormat.RGBA32F, device=CPU)
    quad = SceneObject.quad(device, "q", base_color_texture=tex)
    # Textured opaque materials are ported (item 13): the renderer builds its
    # base atlas on the scene's device.
    textured = TDeferred(dataclasses.replace(scene, objects=[quad]))
    assert textured.textured and textured._atlases["BaseAtlas"].texture.array.device == CPU
    # The id buffer, skins and morphs are ported (item 21.9): they build,
    # and a morphed (or skinned) object must be opaque and untextured, as
    # the reference asserts (deferred.py:727-735, 771-780).
    with pytest.raises(ValueError, match="plain opaque untextured"):
        TDeferred(dataclasses.replace(scene, objects=[dataclasses.replace(
            quad, base_color_texture=None, translucent=True, morph_deltas=quad.vertex_buffer)]))
    assert TDeferred(scene, id_buffer=True).id_buffer
    # The velocity plane is ported (item 21.6): explicit, and automatic for
    # device-resident instance offsets (tests/test_torch_temporal.py).
    assert TDeferred(scene, velocity=True).velocity
    assert TDeferred(dataclasses.replace(scene, objects=[dataclasses.replace(
        quad, base_color_texture=None, instance_offsets=torch.zeros((2, 3)))])).velocity
    # SSAO is ported (item 21's single-target passes): True takes the
    # default options.
    from zenith_tpu_torch.renderer import SSAOOptions

    assert isinstance(TDeferred(scene, ssao=True).ssao, SSAOOptions)
    assert TDeferred(scene).ssao is None
    # The wireframe view (item 19) is ported: the G-buffer pass draws LINEs.
    wire = TDeferred(scene, wireframe=True)
    from zenith_tpu_torch.rhi.state import PolygonMode

    assert wire._gbuffer_state.rasterization.polygon_mode == PolygonMode.LINE
    from zenith_tpu_torch.rendergraph import RenderGraphBuilder
    from zenith_tpu_torch.rhi import TextureDesc

    def nodes(**kw):
        builder = RenderGraphBuilder()
        out = builder.create(TextureDesc.color("o", 128, 64))
        TDeferred(dataclasses.replace(scene, **kw)).render_to(
            builder, out, golden_scene(device)[1], 128, 64)
        return [n.name for n in builder.nodes]

    # Ported since (item 21.3): shadow-casting point lights, cascades and
    # variance shadows build their nodes (their frames: tests/test_torch_
    # omni.py, test_torch_csm.py, test_torch_vsm.py); so does the image-based
    # light (item 21.4, tests/test_torch_ibl.py).
    assert "omni0.f5" in nodes(point_lights=[PointLight((0, 0, 5), cast_shadows=True)])
    assert "shadow.c2" in nodes(sun=dataclasses.replace(scene.sun, cascades=3))
    assert "shadow" in nodes(sun=dataclasses.replace(scene.sun, soft_shadows=True))
    from zenith_tpu_torch.renderer import EnvironmentLight

    env = EnvironmentLight.from_cube_pixels("e", np.ones((6, 8, 8, 4), np.float32), num_mips=2,
                                            samples=4, device=CPU)
    assert "lighting" in nodes(environment=env)
    from zenith_tpu_torch.renderer import SceneObject as TObject
    from zenith_tpu_torch.sandbox.scene import morphing_blob, skinned_tube

    animated = [TObject.from_mesh(device, skinned_tube(bones=3, rings=4, sides=6), "tube"),
                TObject.from_mesh(device, morphing_blob(rings=4, sides=6), "blob")]
    names = nodes(objects=list(scene.objects) + animated)
    assert {"shadow.skin", "shadow.morph", "gbuffer.skin", "gbuffer.morph"} <= set(names)
    # The bloom mip chain and FXAA are ported (item 21.5).
    assert PostProcess(bloom_mips=3).bloom_mips == 3
    assert PostProcess(fxaa=True).fxaa
