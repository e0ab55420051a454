"""The HUD overlay in the port (renderer/hud.py) against the reference
package: twins of tests/test_hud.py's nine non-SPMD cases (the host bitfont,
the composite node, text changes without a new frame function, SceneApp
--hud, and the bin-overflow bar read from the device counter) and its two
SPMD cases (the overlay over 8 row bands; the bar on a mesh, from the
overflow summed over the bands).

Tolerances: the bitmaps equal; the composited frames atol 1e-6 against the
reference's graph on the same fill (the same float32 operations); the
overflow bar's pixels equal; the banded overlay the reference's atol 1e-6
against single-device and the JAX 8-device frame.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from zenith_tpu_torch.renderer.hud import GLYPH_H, GLYPH_W, HudOverlay, render_text_bitmap

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
W, H = 128, 64


def test_known_glyph_pixels():
    from zenith_tpu.renderer.hud import render_text_bitmap as ref

    bm = render_text_bitmap("I", max_chars=1, scale=1)
    np.testing.assert_array_equal(bm, ref("I", max_chars=1, scale=1))
    assert bm.shape == (GLYPH_H, GLYPH_W)
    # 'I': top and bottom bars of 3 + 5 column pixels = 11 set pixels.
    assert bm.sum() == 11 and bm[1, 2] == 1.0


def test_scale_and_padding():
    from zenith_tpu.renderer.hud import render_text_bitmap as ref

    bm = render_text_bitmap("AB", max_chars=4, scale=2)
    np.testing.assert_array_equal(bm, ref("AB", max_chars=4, scale=2))
    assert bm.shape == (GLYPH_H * 2, GLYPH_W * 2 * 4)
    assert bm[:, GLYPH_W * 2 * 2:].sum() == 0  # characters beyond the text are blank
    assert bm.sum() == 4 * render_text_bitmap("AB", max_chars=4, scale=1).sum()


def test_lowercase_and_unknown():
    from zenith_tpu.renderer.hud import render_text_bitmap as ref

    text = "fps 60.5% (ok) ~"
    np.testing.assert_array_equal(render_text_bitmap(text, 16, 1), ref(text, 16, 1))
    np.testing.assert_array_equal(render_text_bitmap("abc", 3, 1), render_text_bitmap("ABC", 3, 1))
    assert render_text_bitmap("~", max_chars=1, scale=1).sum() == 0


def test_set_text_caches():
    hud = HudOverlay(max_chars=8)
    hud.set_text("FPS 60")
    a = hud._bitmap
    hud.set_text("FPS 60")
    assert hud._bitmap is a  # the same object: no second rasterization
    hud.set_text("FPS 61")
    assert hud._bitmap is not a


def _port_run(hud, draw=None, mesh_n=None):
    """A 0.25 fill (or ``draw``'s node), then the overlay; the LDR frame
    (over ``mesh_n`` row bands when given)."""
    from zenith_tpu_torch.parallel import default_mesh
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.rhi import PipelineCache, RhiCore, TextureDesc

    device = RhiCore(CPU).create_render_device()
    builder = RenderGraphBuilder()
    ldr = builder.create(TextureDesc.color("ldr", W, H))
    if draw is None:
        gen = builder.add_lambda_node("fill")
        dst = gen.write(ldr)
        gen.execute(lambda ctx: ctx.set(dst, torch.full((H // ctx.num_shards, W, 4), 0.25)))
    else:
        draw(builder, ldr)
    hud.render_to(builder, ldr)
    builder.export(ldr)
    mesh = None if mesh_n is None else default_mesh(mesh_n, device="cpu")
    compiled = builder.build().compile(device, PipelineCache(),
                                       CompileOptions(tile_h=8, tile_w=128, mesh=mesh))
    compiled.execute(device)
    return compiled.value(ldr).numpy()


def _jax_run(hud, overflow_budget=None, mesh_n=None):
    """The reference's graph: the 0.25 fill, or the overflow test's spam
    draw at ``overflow_budget``, then its overlay with the same settings
    (over ``mesh_n`` row bands of the virtual CPU devices when given)."""
    import jax.numpy as jnp

    from zenith_tpu.parallel import default_mesh

    from zenith_tpu.renderer.hud import HudOverlay as JHud
    from zenith_tpu.rendergraph import RenderGraphBuilder
    from zenith_tpu.rendergraph.graph import CompileOptions
    from zenith_tpu.rhi import PipelineCache, RhiCore, TextureDesc

    device = RhiCore().create_render_device()
    builder = RenderGraphBuilder()
    ldr = builder.create(TextureDesc.color("ldr", W, H))
    if overflow_budget is None:
        gen = builder.add_lambda_node("fill")
        dst = gen.write(ldr)
        gen.execute(lambda ctx: ctx.set(dst, jnp.full((H // ctx.num_shards, W, 4), 0.25,
                                                      jnp.float32)))
    else:
        _spam_draw(builder, ldr, overflow_budget, port=False)
    jhud = JHud(max_chars=hud.max_chars, scale=hud.scale, margin=hud.margin,
                overflow_indicator=hud.overflow_indicator)
    jhud.set_text(hud._text)
    jhud.render_to(builder, ldr)
    builder.export(ldr)
    mesh = None if mesh_n is None else default_mesh(mesh_n, backend="cpu")
    compiled = builder.build().compile(device, PipelineCache(),
                                       CompileOptions(tile_h=8, tile_w=128, mesh=mesh))
    compiled.execute(device)
    return np.asarray(compiled.value(ldr))


def test_overlay_composites_in_corner_only():
    hud = HudOverlay(max_chars=8, scale=1, margin=8)
    hud.set_text("FPS 123")
    out = _port_run(hud)
    np.testing.assert_allclose(out, _jax_run(hud), atol=1e-6)
    bh, bw = hud.bitmap_shape
    box = out[8:8 + bh, 8:8 + bw, :3]
    assert (box != 0.25).any()  # the text and the dimmed box
    np.testing.assert_allclose(out[8 + bh + 2:, :, :3], 0.25, atol=1e-6)
    assert np.all(out[..., 3] == out[0, 0, 3])  # alpha untouched
    assert box.max() > 0.9 and box.min() < 0.25 - 0.05  # white text, dimmed backdrop


def test_text_change_never_recompiles():
    from zenith_tpu_torch.rendergraph.graph import (
        clear_frame_program_cache,
        frame_program_cache_size,
    )

    clear_frame_program_cache()
    hud = HudOverlay(max_chars=8, scale=1)
    hud.set_text("FRAME 1")
    a = _port_run(hud)
    hud.set_text("FRAME 2")
    b = _port_run(hud)
    assert frame_program_cache_size() == 1
    assert np.abs(a - b).max() > 0.0  # the text changed
    # A margin beyond the frame's height: the window's start clamps, as the
    # reference's dynamic_slice does, and the overlay leaves the frame.
    far = HudOverlay(max_chars=8, scale=1, margin=80)
    far.set_text("FRAME 3")
    np.testing.assert_allclose(_port_run(far), _jax_run(far), atol=1e-6)


def test_scene_hud_one_program(monkeypatch):
    """SceneApp --hud: the FPS text changes every frame, yet one frame
    function serves the run (the bitmap is a dynamic)."""
    from zenith_tpu_torch import asset
    from zenith_tpu_torch.launch import launch
    from zenith_tpu_torch.rendergraph.graph import (
        clear_frame_program_cache,
        frame_program_cache_size,
    )
    from zenith_tpu_torch.sandbox.scene import SceneApp
    from zenith_tpu_torch.window import Window

    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("ZENITH_CACHE", str(ROOT / "cache"))
    monkeypatch.delenv("ZENITH_CONTENT", raising=False)
    asset.initialize()
    clear_frame_program_cache()
    window = Window(width=W, height=H, title="t")
    loop = launch(SceneApp, argv=["--", "--mode", "deferred", "--lights", "4", "--hud"],
                  window=window, max_frames=4, device="cpu")
    assert frame_program_cache_size() == 1
    assert loop.app.hud._text.startswith("FPS") and "OBJ 2" in loop.app.hud._text
    frame = np.asarray(window.last_frame)
    assert frame[8:20, 8:60, :3].std() > 1.0  # the HUD box differs from below it


def _spam_draw(builder, ldr, budget, port=True):
    """test_hud.py's overflow scene: 300 coincident full-screen triangles
    over a 0.25 clear, drawn with entry budget ``budget`` (8 cannot hold
    300 entries x 8 tiles: bin overflow)."""
    if port:
        from zenith_tpu_torch.rhi import (
            Buffer,
            ColorAttachmentDesc,
            CullMode,
            GraphicShaderInput,
            RasterizationState,
            Shader,
            VertexLayout,
            attr,
        )
        from zenith_tpu_torch.rhi.state import GraphicPipelineState

        xp = torch
        kw = dict(device=CPU)
    else:
        import jax.numpy as xp

        from zenith_tpu.rhi import (
            Buffer,
            ColorAttachmentDesc,
            CullMode,
            GraphicShaderInput,
            RasterizationState,
            Shader,
            VertexLayout,
            attr,
        )
        from zenith_tpu.rhi.state import GraphicPipelineState

        kw = {}
    tri = np.array([[-3, -3, 0.5], [3, -3, 0.5], [0, 3, 0.5]], np.float32)
    vbr = builder.import_resource(Buffer.from_numpy("ovf.vb", np.tile(tri, (300, 1)), **kw))
    ibr = builder.import_resource(Buffer.from_numpy("ovf.ib", np.arange(900, dtype=np.int32),
                                                    **kw))

    def vs(attrs, res):
        pos = attrs["position"]
        return {"position": xp.concatenate([pos, xp.ones_like(pos[:, :1])], 1)}

    def fs(varyings, res, builtins):
        h, w = builtins.depth.shape
        return xp.full((h, w, 4), 0.25, dtype=xp.float32)

    node = builder.add_graphic_node("spam")
    vba, iba = node.read(vbr), node.read(ibr)
    rt = node.write(ldr)
    si = GraphicShaderInput(Shader.vertex("ovf.vs", vs, inputs=[attr("position", 3)]),
                            Shader.fragment("ovf.fs", fs),
                            VertexLayout.from_fields(("position", 3)))
    state = GraphicPipelineState(rasterization=RasterizationState(cull_mode=CullMode.NONE))
    with node.pipeline(si, state) as binder:
        binder.push_color(rt, ColorAttachmentDesc(clear_value=(0.25, 0.25, 0.25, 1)))
    node.execute(lambda ctx: ctx.draw_indexed(vba, iba, entry_budget=budget))


def _overflow_run(overflow, indicator=True, mesh_n=None):
    hud = HudOverlay(max_chars=8, scale=1, margin=8, overflow_indicator=indicator)
    hud.set_text("FPS 1")
    img = _port_run(hud, lambda b, ldr: _spam_draw(b, ldr, 8 if overflow else 65536), mesh_n)
    bh, _ = hud.bitmap_shape
    return hud, img, img[8 + bh + 2:8 + bh + 2 + max(2, bh // 4), 8:, :3]


def test_overflow_draws_red_bar():
    hud, img, bar = _overflow_run(overflow=True)
    red = (bar[..., 0] > 0.9) & (bar[..., 1] < 0.3)  # strong R, suppressed G and B
    assert red.any()
    np.testing.assert_allclose(img, _jax_run(hud, overflow_budget=8), atol=1e-6)


def test_no_overflow_no_bar():
    _, _, bar = _overflow_run(overflow=False)
    np.testing.assert_allclose(bar, 0.25, atol=1e-6)


def test_indicator_off_untouched_even_on_overflow():
    _, _, bar = _overflow_run(overflow=True, indicator=False)
    np.testing.assert_allclose(bar, 0.25, atol=1e-6)


def test_spmd_matches_single_device(cpu_devices):
    """The overlay spans several 8-row bands (margin 8, height 16): the
    padded window composite tiles exactly."""
    def hud():
        h = HudOverlay(max_chars=10, scale=2, margin=8)
        h.set_text("SPMD 8X")
        return h

    img1 = _port_run(hud())
    img8 = _port_run(hud(), mesh_n=8)
    np.testing.assert_allclose(img8, img1, atol=1e-6)
    np.testing.assert_allclose(img8, _jax_run(hud(), mesh_n=8), atol=1e-6)


def test_spmd_bar_shows_on_mesh(cpu_devices):
    """Under a row-band mesh the indicator reads the overflow total summed
    over the bands, so every band composites the bar. (No frame equality:
    an overflowing draw drops records, and which ones depends on each
    band's binning.)"""
    _hud, _img, bar = _overflow_run(overflow=True, mesh_n=8)
    red = (bar[..., 0] > 0.9) & (bar[..., 1] < 0.3)
    assert red.any()
