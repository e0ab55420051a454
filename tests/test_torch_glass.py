"""The port's glass node (translucent objects drawn after lighting) against
the reference package's, in both modes: ``glass_mode="kernel"`` (the in-order
blend kernel's path, K5; on the CPU its plain version against the Pallas
kernel in interpret mode) and ``"peel"`` (depth peeling over K4 with the
glass atlas sampled per pixel), on the scene of tests/test_glass_peel.py (one
standing pane over a ground quad, 128×96, 16×64 tiles) and on three
overlapping tinted panes under a sun, untextured and with a checker texture
on two of them.

Tolerances: the HDR frame atol 1e-5 + rtol 1e-5 (XLA's CPU backend contracts
multiply-adds into FMAs, the port rounds every product: ROADMAP §3); the
encoded frame ≤ 1 LSB with < 1% of values differing. The scenes are carried
across by zenith_tpu_torch.interop.
"""

import dataclasses

import numpy as np
import pytest
import torch

from zenith_tpu_torch import interop
from zenith_tpu_torch.rendergraph import CompileOptions as TOptions
from zenith_tpu_torch.rendergraph import RenderGraphBuilder as TBuilder
from zenith_tpu_torch.renderer import DeferredRenderer as TDeferred
from zenith_tpu_torch.rhi import Format as TFormat
from zenith_tpu_torch.rhi import PipelineCache as TCache
from zenith_tpu_torch.rhi import RhiCore as TCore
from zenith_tpu_torch.rhi import TextureDesc as TTextureDesc
from zenith_tpu_torch.rhi import encode_present as tencode

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 96
ROT = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)


def _checker(n=32):
    yy, xx = np.mgrid[0:n, 0:n]
    c = ((xx // 2 + yy // 2) % 2).astype(np.float32)
    return np.stack([c, 1.0 - c, np.full_like(c, 0.5), np.full_like(c, 0.8)], -1)


def _jax_scene(device, kind):
    """(scene, camera) of the reference package."""
    from zenith_tpu.core.camera import Camera
    from zenith_tpu.core.mathtypes import Degree
    from zenith_tpu.renderer.scene import DirectionalLight, Scene, SceneObject
    from zenith_tpu.rhi import Format
    from zenith_tpu.rhi.resource import Texture

    tex = None
    if "textured" in kind:
        tex = Texture.from_numpy("glass.checker", _checker(), Format.RGBA32F)
    panes = []
    for k, (dy, tint) in enumerate([(0.0, (1.0, 1.0, 1.0, 0.6)), (-6.0, (0.4, 0.7, 1.0, 0.35)),
                                    (4.0, (1.0, 0.5, 0.4, 0.45))]):
        pane = SceneObject.quad(device, f"pane{k}", size=30.0 - 6 * k, z=0.0, base_color=tint,
                                translucent=True,
                                base_color_texture=tex if k != 1 else None)
        trans = np.eye(4, dtype=np.float32)
        trans[:3, 3] = (3.0 * k, dy, 0.0)
        pane.model_matrix = trans @ ROT
        panes.append(pane)
    if "one-pane" in kind:
        panes = panes[:1]
    ground = SceneObject.quad(device, "ground", size=120.0, z=-12.0,
                              base_color=(0.25, 0.25, 0.25, 1.0))
    sun = None
    if "sun" in kind:
        sun = DirectionalLight(direction=(0.3, -0.5, 0.8), intensity=2.0, cast_shadows=False)
    cam = Camera(fov_y=Degree(45.0), aspect_ratio=W / H)
    cam.set_position(np.array([0.0, -30.0, 5.0], np.float32))
    return Scene(objects=[ground, *panes], sun=sun, ambient=(1.0, 1.0, 1.0)), cam


def _jax_frame(kind, mode):
    import jax.numpy as jnp

    from zenith_tpu.renderer import DeferredRenderer
    from zenith_tpu.rendergraph import RenderGraphBuilder
    from zenith_tpu.rendergraph.graph import CompileOptions
    from zenith_tpu.rhi import Format, PipelineCache, RhiCore, TextureDesc, encode_present

    device = RhiCore().create_render_device()
    scene, cam = _jax_scene(device, kind)
    r = DeferredRenderer(scene, shadows=False, glass_mode=mode, glass_peel_layers=3)
    builder = RenderGraphBuilder()
    out = builder.create(TextureDesc.color("hdr", W, H))
    r.render_to(builder, out, cam, W, H)
    builder.export(out)
    compiled = builder.build().compile(device, PipelineCache(),
                                       CompileOptions(tile_h=16, tile_w=64))
    retired = compiled.execute(device)
    hdr = compiled.value(out)
    enc = encode_present(jnp.clip(hdr, 0.0, 1.0), Format.RGBA8_SRGB)
    return scene, cam, r.glass_peel, np.asarray(hdr), np.asarray(enc), int(retired.bin_overflow)


def _port_frame(jscene, jcam, mode):
    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree

    device = TCore(CPU).create_render_device()
    scene = interop.scene_from(jscene, CPU)
    cam = Camera(fov_y=Degree(45.0), aspect_ratio=W / H)
    cam.set_position(np.asarray(jcam.location, np.float32))
    r = TDeferred(scene, shadows=False, glass_mode=mode, glass_peel_layers=3)
    builder = TBuilder()
    out = builder.create(TTextureDesc.color("hdr", W, H))
    r.render_to(builder, out, cam, W, H)
    builder.export(out)
    compiled = builder.build().compile(device, TCache(), TOptions(tile_h=16, tile_w=64))
    retired = compiled.execute(device)
    hdr = compiled.value(out)
    enc = tencode(torch.clamp(hdr, 0.0, 1.0), TFormat.RGBA8_SRGB)
    return r.glass_peel, hdr.numpy(), enc.numpy(), int(retired.bin_overflow)


CASES = [
    ("one-pane", "kernel"),
    ("one-pane", "peel"),
    ("one-pane textured", "auto"),
    ("one-pane textured", "kernel"),
    ("three-panes sun", "kernel"),
    ("three-panes sun textured", "kernel"),
    ("three-panes sun textured", "peel"),
]


@pytest.mark.parametrize("kind, mode", CASES, ids=[f"{k.replace(' ', '-')}-{m}" for k, m in CASES])
def test_glass_frame_matches_the_reference(kind, mode):
    jscene, jcam, jpeel, jhdr, jenc, jover = _jax_frame(kind, mode)
    tpeel, thdr, tenc, tover = _port_frame(jscene, jcam, mode)
    assert tpeel == jpeel == (mode == "peel" or (mode == "auto" and "textured" in kind))
    assert tover == jover == 0
    # The glass really drew: the centre of the image is not the ground's grey.
    assert np.abs(thdr[40:56, 56:72, :3] - 0.25).max() > 4e-3
    np.testing.assert_allclose(thdr, jhdr, atol=1e-5, rtol=1e-5)
    d = np.abs(tenc.astype(np.int16) - jenc.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


def test_peel_drops_and_counts_layers_beyond_its_depth():
    """Three overlapping panes through two peel layers: the farthest is
    dropped where all three overlap, and those pixels are counted into
    bin_overflow, as in the reference."""
    from zenith_tpu.renderer import DeferredRenderer
    from zenith_tpu.rendergraph import RenderGraphBuilder
    from zenith_tpu.rendergraph.graph import CompileOptions
    from zenith_tpu.rhi import PipelineCache, RhiCore, TextureDesc

    jdev = RhiCore().create_render_device()
    jscene, jcam = _jax_scene(jdev, "three-panes")
    r = DeferredRenderer(jscene, shadows=False, glass_mode="peel", glass_peel_layers=2)
    builder = RenderGraphBuilder()
    out = builder.create(TextureDesc.color("hdr", W, H))
    r.render_to(builder, out, jcam, W, H)
    builder.export(out)
    compiled = builder.build().compile(jdev, PipelineCache(), CompileOptions(tile_h=16, tile_w=64))
    jover = int(compiled.execute(jdev).bin_overflow)
    jhdr = np.asarray(compiled.value(out))

    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree

    device = TCore(CPU).create_render_device()
    cam = Camera(fov_y=Degree(45.0), aspect_ratio=W / H)
    cam.set_position(np.asarray(jcam.location, np.float32))
    tr = TDeferred(interop.scene_from(jscene, CPU), shadows=False, glass_mode="peel",
                   glass_peel_layers=2)
    tb = TBuilder()
    tout = tb.create(TTextureDesc.color("hdr", W, H))
    tr.render_to(tb, tout, cam, W, H)
    tb.export(tout)
    tc = tb.build().compile(device, TCache(), TOptions(tile_h=16, tile_w=64))
    tover = int(tc.execute(device).bin_overflow)
    assert tover == jover > 0
    np.testing.assert_allclose(tc.value(tout).numpy(), jhdr, atol=1e-5, rtol=1e-5)


def test_glass_renderer_rejects_what_is_not_ported():
    """The renderer's options and shaders are checked: an unknown
    glass_mode is refused; a textured opaque object beside glass turns the
    G-buffer's textured mode on, textured glass alone turns on only the
    glass shader's textured variant; the glass shader is kernel-safe with
    device source, and a shader given device source without kernel_safe is
    refused."""
    from zenith_tpu_torch.renderer import Scene, SceneObject
    from zenith_tpu_torch.rhi import Shader, Texture

    device = TCore(CPU).create_render_device()
    pane = SceneObject.quad(device, "pane", translucent=True, base_color=(1, 1, 1, 0.5))
    ground = SceneObject.quad(device, "ground")
    with pytest.raises(ValueError, match="glass_mode"):
        TDeferred(Scene(objects=[ground, pane]), glass_mode="sorted")
    tex = Texture.from_numpy("t", np.ones((2, 2, 4), np.float32), TFormat.RGBA32F,
                             device="cpu")
    textured = TDeferred(Scene(objects=[dataclasses.replace(ground, base_color_texture=tex),
                                        pane]))
    assert textured.textured and not textured.glass_textured
    glass_only = TDeferred(Scene(objects=[ground, dataclasses.replace(pane,
                                                                      base_color_texture=tex)]))
    assert glass_only.glass_textured and not glass_only.textured
    r = TDeferred(Scene(objects=[ground, pane]))
    assert r.glass_fs.kernel_safe and "zn_fragment" in r.glass_fs.device_source
    with pytest.raises(ValueError, match="kernel_safe"):
        Shader.fragment("f", lambda v, r, b: None, device_source="x")
