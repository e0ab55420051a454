"""The port's depth peeling against the reference package's (mirrors
tests/test_depth_peel.py at its size, 128×32 with 8×128 tiles): the plain
version of kernel K4 (``raster_segmented(z_bound=…)``) against the Pallas peel
kernel in interpret mode on the same bins, and the ``peel_layers`` branch of
``draw_indexed_batch`` with a fragment shader that samples a texture per pixel.

Tolerances: coverage and the dropped-layer count equal; z and the attribute
planes atol 1e-5 (XLA's CPU backend contracts the reference kernel's
multiply-adds into FMAs, the port rounds each product; ROADMAP §3); colours
atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zenith_tpu.ops.draw as jdraw
import zenith_tpu_torch.ops.draw as tdraw
from zenith_tpu.ops import TileGrid as JGrid
from zenith_tpu.ops import bin_segmented as jbin
from zenith_tpu.ops import raster_segmented as jraster
from zenith_tpu.ops import setup_with_attrs as jsetup
from zenith_tpu.ops.sampling import sample_2d as jsample
from zenith_tpu.rhi import pipeline as jpipe, shader as jshader, state as jstate
from zenith_tpu.rhi.formats import Format as JFormat
from zenith_tpu.rhi.sampler import SamplerConfig as JSampler
from zenith_tpu_torch.interop import bins_from_numpy
from zenith_tpu_torch.ops import TileGrid as TGrid
from zenith_tpu_torch.ops.raster import raster_segmented as traster
from zenith_tpu_torch.ops.sampling import sample_2d as tsample
from zenith_tpu_torch.rhi import pipeline as tpipe, shader as tshader, state as tstate
from zenith_tpu_torch.rhi.formats import Format as TFormat
from zenith_tpu_torch.rhi.sampler import SamplerConfig as TSampler

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 32
JG = JGrid(width=W, height=H, tile_h=8, tile_w=128)
TG = TGrid(width=W, height=H, tile_h=8, tile_w=128)


def _overlapping(seed, nt=16):
    """Well-shaped overlapping triangles with a colour varying."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, (nt, 1)) + np.array([0.0, 2.1, 4.2])
    rad = rng.uniform(0.4, 0.9, (nt, 1))
    ctr = rng.uniform(-0.5, 0.5, (nt, 1, 2))
    xy = (ctr + rad[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)).reshape(-1, 2)
    nv = 3 * nt
    w = rng.uniform(0.8, 1.5, (nv, 1))
    z = rng.uniform(0.05, 0.95, (nv, 1))
    clip = np.concatenate([xy * w, z * w, w], 1).astype(np.float32)
    return clip, np.arange(nv, dtype=np.int32).reshape(nt, 3), \
        rng.uniform(0, 1, (nv, 3)).astype(np.float32)


@jax.jit
def _reference_bins(clip, idx, vary):
    """The reference's setup and binning, compiled as one function (both
    peel rasters read these bins)."""
    rec, corner = jsetup(clip, idx, vary, W, H, cull_mode=jstate.CullMode.NONE)
    return jbin(rec, corner, JG)


@pytest.mark.parametrize("compare, write", [("GREATER", True), ("GREATER_OR_EQUAL", False),
                                            ("LESS", True), ("LESS_OR_EQUAL", True)])
def test_raster_segmented_peel_matches_the_reference(compare, write):
    """Three chained peels: each pass is bounded by the depth the pass before
    resolved (the first by no bound), in both packages on the same bins."""
    jb = _reference_bins(*_overlapping(4))
    tb = bins_from_numpy([np.asarray(f) for f in jb], CPU)
    far = 0.0 if compare.startswith("GREATER") else 1.0
    init = np.full((H, W), far, np.float32)
    jbound = tbound = None
    covered = []
    for layer in range(3):
        # The overflow probe's state on the last pass: depth write off.
        w_on = write and layer < 2
        jz, jacc = jraster(jb, JG, jnp.asarray(init), compare_op=jstate.CompareOp[compare],
                           depth_write=w_on, z_bound=jbound)
        tz, tacc = traster(tb, TG, torch.from_numpy(init), compare_op=tstate.CompareOp[compare],
                           depth_write=w_on, z_bound=tbound)
        np.testing.assert_array_equal(tacc.numpy()[-1] > 0, np.asarray(jacc)[-1] > 0)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5)
        np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), atol=1e-5)
        covered.append(int((tacc.numpy()[-1] > 0).sum()))
        # Each package peels behind its own depth: a pass rejects the
        # fragment that made the bound only because it recomputes that depth
        # to the same bits, which holds within a package, not across them.
        jbound, tbound = jz, tz
    if write:
        assert covered[0] > covered[1] > covered[2] > 0  # deeper layers shrink


def test_peel_bound_rejects_what_it_cannot_order():
    clip, idx, vary = _overlapping(4, nt=2)
    from zenith_tpu_torch.ops.binning import bin_segmented
    from zenith_tpu_torch.ops.geometry import setup_with_attrs

    rec, corner = setup_with_attrs(torch.from_numpy(clip), torch.from_numpy(idx),
                                   torch.from_numpy(vary), W, H)
    bins = bin_segmented(rec, corner, TG)
    z0 = torch.zeros((H, W))
    with pytest.raises(ValueError, match="ordering depth compare"):
        traster(bins, TG, z0, compare_op=tstate.CompareOp.EQUAL, z_bound=z0)
    with pytest.raises(ValueError, match="requires the depth test"):
        traster(bins, TG, z0, depth_test=False, z_bound=z0)
    with pytest.raises(ValueError, match="cannot combine with stencil"):
        traster(bins, TG, z0, z_bound=z0, stencil_front=tstate.StencilOpState())


def _pipelines():
    """tests/test_depth_peel.py's pipeline in both packages (reference,
    port): src-alpha-over blending, depth GREATER with writes off, a fragment
    shader that samples ``Tex`` per pixel (nearest) and tints by BaseColor."""
    out = []
    for pm, sm, st, fmt, sample, sampler, cat in (
        (jpipe, jshader, jstate, JFormat, jsample, JSampler, jnp.concatenate),
        (tpipe, tshader, tstate, TFormat, tsample, TSampler, torch.cat),
    ):
        def fs(v, res, b, sample=sample, sampler=sampler, cat=cat):
            t = sample(res["Tex"], v["uv"], sampler.nearest())
            c = res["BaseColor"]
            return cat([t[..., :3] * c[..., :3], c[..., 3:4] + 0.0 * t[..., :1]], -1)

        def vs(a, res, cat=cat):
            p = a["position"]
            return {"position": cat([p, 0.0 * p[:, :1] + 1.0], 1), "uv": a["uv"]}

        over = st.ColorAttachmentDesc(
            blend_enable=True, src_color_blend=st.BlendFactor.SRC_ALPHA,
            dst_color_blend=st.BlendFactor.ONE_MINUS_SRC_ALPHA,
            src_alpha_blend=st.BlendFactor.ONE,
            dst_alpha_blend=st.BlendFactor.ONE_MINUS_SRC_ALPHA)
        ds = st.DepthStencilDesc(depth_test_enable=True, depth_write_enable=False,
                                 depth_compare_op=st.CompareOp.GREATER)
        out.append(pm.GraphicPipeline(pm.GraphicPipelineDesc(
            shader_input=pm.GraphicShaderInput(
                sm.Shader.vertex("peel.vs", vs),
                sm.Shader.fragment("peel.fs", fs,
                                   bindings=[sm.texture2d("Tex"), sm.uniform("BaseColor")]),
                st.VertexLayout.from_fields(("position", 3), ("uv", 2))),
            state=st.GraphicPipelineState(
                rasterization=st.RasterizationState(cull_mode=st.CullMode.NONE),
                depth_stencil=ds),
            attachments=st.GraphicPipelineAttachments(
                color_formats=(fmt.RGBA32F,), depth_format=fmt.D32F),
            color_attachment_descs=(over,), depth_attachment_desc=ds,
        )))
    return out


def _quad(z, x0=-0.8, y0=-0.8, x1=0.8, y1=0.8):
    vb = np.array([[x0, y0, z, 0.0, 0.0], [x1, y0, z, 1.0, 0.0], [x1, y1, z, 1.0, 1.0],
                   [x0, y1, z, 0.0, 1.0]], np.float32)
    return vb, np.array([0, 1, 2, 0, 2, 3], np.int32)


def _checker(n=16):
    yy, xx = np.mgrid[0:n, 0:n]
    c = ((xx + yy) % 2).astype(np.float32)
    return np.stack([c, 1.0 - c, np.full_like(c, 0.5), np.ones_like(c)], -1)


def _peeled(layers, zs, alphas, depth=0.0, offsets=None, reference=True):
    """The same peeled batch through both packages → (reference colour,
    port colour, reference dropped count, port dropped count, port depth);
    the reference's values are None without ``reference``."""
    jp, tp = _pipelines()
    tex = _checker()
    bg = np.random.default_rng(8).uniform(0, 1, (H, W, 4)).astype(np.float32)
    z0 = np.full((H, W), depth, np.float32)
    offsets = offsets or [0.0] * len(zs)
    host = [(*_quad(z, x0=-0.8 + dx, x1=0.8 + dx), np.array([1.0, 0.9, 0.8, a], np.float32))
            for z, a, dx in zip(zs, alphas, offsets)]
    def jfn(bg, z0, jtex, verts):
        # One texture object: a binding shared by every draw.
        cols, _, st = jdraw.draw_indexed_batch(
            [bg], z0, jp, [(vb, jnp.asarray(ib), {"Tex": jtex, "BaseColor": c})
                           for (vb, c), (_, ib, _) in zip(verts, host)],
            JG, per_draw_uniforms=("BaseColor",), peel_layers=layers)
        return cols, st.bin_overflow

    jc, jover = [None], None
    if reference:
        jc, jover = jax.jit(jfn)(jnp.asarray(bg), jnp.asarray(z0), jnp.asarray(tex),
                                 [(jnp.asarray(vb), jnp.asarray(c)) for vb, _, c in host])
    ttex = torch.from_numpy(tex)
    tc, td, tst = tdraw.draw_indexed_batch(
        [torch.from_numpy(bg)], torch.from_numpy(z0), tp,
        [(torch.from_numpy(vb), torch.from_numpy(ib),
          {"Tex": ttex, "BaseColor": torch.from_numpy(c)}) for vb, ib, c in host], TG,
        per_draw_uniforms=("BaseColor",), peel_layers=layers)
    return (None if jover is None else np.asarray(jc[0]), tc[0].numpy(),
            None if jover is None else int(jover), int(tst.bin_overflow), td.numpy())


@pytest.mark.parametrize("layers, zs, dropped", [
    (2, [0.5], False),
    (3, [0.5, 0.7, 0.3], False),  # scrambled submission: peeling orders by depth
    (2, [0.2, 0.3, 0.5, 0.7, 0.9], True),  # deeper layers dropped and counted
    (5, [0.9, 0.2, 0.7, 0.3, 0.5], False),
], ids=["one-layer", "three-scrambled", "five-through-two", "five-through-five"])
def test_peeled_batch_matches_the_reference(layers, zs, dropped):
    offsets = [0.05 * k for k in range(len(zs))]
    jcol, tcol, jover, tover, tdepth = _peeled(layers, zs, [0.5] * len(zs), offsets=offsets)
    np.testing.assert_allclose(tcol, jcol, atol=1e-5)
    assert tover == jover and (tover > 0) == dropped
    np.testing.assert_array_equal(tdepth, 0.0)  # depth write off keeps the depth
    interior = tcol[8:24, 40:90]
    assert interior[..., 0].max() - interior[..., 0].min() > 0.3  # the checker, per pixel


def test_peel_respects_the_opaque_depth():
    """Fragments behind the depth buffer never contribute: of layers at 0.4
    and 0.8 over an opaque 0.6 only the nearer one blends."""
    jcol, tcol, jover, tover, _ = _peeled(2, [0.4, 0.8], [0.5, 0.5], depth=0.6)
    np.testing.assert_allclose(tcol, jcol, atol=1e-5)
    # The nearer layer alone, through the port (held to the reference above).
    one = _peeled(2, [0.8], [0.5], depth=0.6, reference=False)[1]
    np.testing.assert_allclose(tcol, one, atol=1e-5)
    assert tover == jover == 0


def test_peel_and_blend_batches_reject_what_they_cannot_draw():
    _, tp = _pipelines()
    vb, ib = _quad(0.5)
    draw = (torch.from_numpy(vb), torch.from_numpy(ib),
            {"Tex": torch.from_numpy(_checker()), "BaseColor": torch.ones(4)})
    bg, z0 = [torch.zeros((H, W, 4))], torch.zeros((H, W))
    with pytest.raises(ValueError, match="at least 1"):
        tdraw.draw_indexed_batch(bg, z0, tp, [draw], TG, peel_layers=0)
    # Blending across several draws without peeling needs a kernel-safe
    # shader; the message names both ways out.
    with pytest.raises(ValueError, match="kernel_safe=True.*peel_layers"):
        tdraw.draw_indexed_batch(bg, z0, tp, [draw, draw], TG)
    opaque = tpipe.GraphicPipeline(tpipe.GraphicPipelineDesc(
        shader_input=tp.desc.shader_input, state=tp.desc.state,
        attachments=tp.desc.attachments))
    with pytest.raises(ValueError, match="requires a blending pipeline"):
        tdraw.draw_indexed_batch(bg, z0, opaque, [draw], TG, peel_layers=2)
