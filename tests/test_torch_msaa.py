"""The port's multisampling against the reference's.

``TestShadeOncePerPixel`` holds the port to the checks of
tests/test_msaa_per_pixel.py::TestShadeOncePerPixel. The parity tests draw
the same numpy-seeded triangles through both packages' ``draw_indexed``
shading once per pixel at 2× and per sample at 8×, and through
``draw_indexed_batch`` under 4× (plain, stencil, depth peel and in-order
blend), with the
reference compiled by ``jax.jit`` (its Pallas rasters in interpret mode,
once per sample). The graph tests hold the port's resolve (the colour mean
of the samples) and its per-sample LOAD of a later MSAA node
(test_torch_forward.py holds a graph that LOADs per-sample planes against
the reference's).

Tolerances: per-sample coverage exact; colours and depth atol 1e-5 (XLA's
CPU backend contracts the reference's multiply-adds into FMAs, the port
rounds each product: test_torch_raster_compare.py); stencil planes exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zenith_tpu.ops.draw as jdraw
import zenith_tpu_torch.ops.draw as tdraw
from zenith_tpu.ops import TileGrid as JGrid
from zenith_tpu.rhi import pipeline as jpipe, shader as jshader, state as jstate
from zenith_tpu.rhi.formats import Format as JFormat
from zenith_tpu_torch.ops import TileGrid as TGrid
from zenith_tpu_torch.rhi import pipeline as tpipe, shader as tshader, state as tstate
from zenith_tpu_torch.rhi.formats import Format as TFormat

torch.set_num_threads(1)
W, H = 128, 32
JG = JGrid(width=W, height=H, tile_h=8, tile_w=128)
TG = TGrid(width=W, height=H, tile_h=8, tile_w=128)
J = (jpipe, jshader, jstate, JFormat, jnp.concatenate)
T = (tpipe, tshader, tstate, TFormat, torch.cat)

# The reference test's triangle, position (3) and colour (3) per vertex.
VB = np.array([[-0.6, -0.7, 0.5, 1.0, 0.2, 0.1],
               [0.7, -0.1, 0.5, 0.2, 1.0, 0.1],
               [-0.1, 0.8, 0.5, 0.1, 0.2, 1.0]], np.float32)
IB = np.array([0, 1, 2], np.int32)


def _pipeline(mods, samples, sample_shading=True, blend=None, stencil=False, alpha=1.0,
              kernel_safe=False, compare="GREATER"):
    pm, sm, st, fmt, cat = mods

    def vs(attrs, res):
        p = attrs["position"]
        return {"position": cat([p, 0.0 * p[:, :1] + 1.0], 1), "color": attrs["color"]}

    def fs(v, res, b):
        c = v["color"]
        return cat([c, 0.0 * c[..., :1] + alpha], -1)

    ds = st.DepthStencilDesc(depth_test_enable=True, depth_write_enable=blend is None,
                             depth_compare_op=st.CompareOp[compare], depth_clear_value=0.0)
    if stencil:
        face = st.StencilOpState(compare_op=st.CompareOp.NOT_EQUAL,
                                 pass_op=st.StencilOp.INCREMENT_AND_WRAP,
                                 depth_fail_op=st.StencilOp.INVERT, reference=2)
        ds = st.DepthStencilDesc(depth_test_enable=True, depth_write_enable=True,
                                 depth_compare_op=st.CompareOp.GREATER, stencil_test_enable=True,
                                 stencil_front=face, stencil_back=face)
    cdesc = st.ColorAttachmentDesc(clear_value=(0, 0, 0, 1))
    if blend:
        cdesc = st.ColorAttachmentDesc(
            blend_enable=True, src_color_blend=st.BlendFactor.SRC_ALPHA,
            dst_color_blend=st.BlendFactor.ONE_MINUS_SRC_ALPHA,
            src_alpha_blend=st.BlendFactor.ONE, dst_alpha_blend=st.BlendFactor.ONE_MINUS_SRC_ALPHA)
    return pm.GraphicPipeline(pm.GraphicPipelineDesc(
        shader_input=pm.GraphicShaderInput(
            sm.Shader.vertex("mp.vs", vs),
            sm.Shader.fragment("mp.fs", fs, kernel_safe=kernel_safe),
            st.VertexLayout.from_fields(("position", 3), ("color", 3))),
        state=st.GraphicPipelineState(
            rasterization=st.RasterizationState(cull_mode=st.CullMode.NONE),
            depth_stencil=ds,
            multisample=st.MultisampleState(samples=samples, sample_shading=sample_shading)),
        attachments=st.GraphicPipelineAttachments(
            color_formats=(fmt.RGBA32F,), depth_format=fmt.D32F,
            stencil_format=fmt.S8 if stencil else None),
        color_attachment_descs=(cdesc,), depth_attachment_desc=ds,
    ))


def _planes(samples, seed=3):
    """Per-sample starting colour (S, H, W, 4) and depth (S, H, W), or the
    single-sample planes, numpy-seeded."""
    rng = np.random.default_rng(seed)
    lead = (samples,) if samples > 1 else ()
    return (rng.uniform(0, 1, lead + (H, W, 4)).astype(np.float32),
            rng.uniform(0.0, 0.3, lead + (H, W)).astype(np.float32))


def _port_draw(samples, sample_shading=True, colors=None, depth=None):
    c0, z0 = _planes(samples) if colors is None else (colors, depth)
    cols, dep, _ = tdraw.draw_indexed([torch.from_numpy(c0)], torch.from_numpy(z0),
                                      _pipeline(T, samples, sample_shading), torch.from_numpy(VB),
                                      torch.from_numpy(IB), {}, TG)
    return cols[0].numpy(), dep.numpy()


def _resolve(img):
    return img.mean(axis=0) if img.ndim == 4 else img


class TestShadeOncePerPixel:
    """tests/test_msaa_per_pixel.py::TestShadeOncePerPixel on the port."""

    @staticmethod
    def _render(samples, sample_shading=True):
        lead = (samples,) if samples > 1 else ()
        img, _ = _port_draw(samples, sample_shading, np.zeros(lead + (H, W, 4), np.float32),
                            np.zeros(lead + (H, W), np.float32))
        return _resolve(img)

    def test_interior_bit_equal_to_1x(self):
        one, per_pixel = self._render(1), self._render(4, sample_shading=False)
        interior = (per_pixel[..., 3] > 0.999) & (one[..., 3] > 0.999)
        assert interior.sum() > 200
        np.testing.assert_array_equal(per_pixel[interior], one[interior])

    def test_edges_coverage_antialiased(self):
        one, per_pixel = self._render(1), self._render(4, sample_shading=False)
        partial = (per_pixel[..., 3] > 0.1) & (per_pixel[..., 3] < 0.9)
        assert partial.sum() > 10
        assert not ((one[..., 3] > 0.01) & (one[..., 3] < 0.99)).any()

    def test_close_to_supersampled(self):
        diff = np.abs(self._render(4, True) - self._render(4, False))
        assert np.median(diff) < 1e-3
        assert diff.max() <= 0.75 + 1e-6
        assert (diff.max(axis=-1) > 0.25).mean() < 0.01

    def test_8x_runs(self):
        out = self._render(8, sample_shading=False)
        assert out.shape == (H, W, 4)
        assert (out[..., 3] > 0.999).sum() > 200

    def test_graph_level_per_pixel_msaa(self):
        img = _graph(passes=1, sample_shading=False, samples=4)
        assert img.shape == (H, W, 4)
        assert (img[..., 3] > 0.999).sum() > 200


def _assert_frames(t_img, t_z, j_img, j_z):
    np.testing.assert_allclose(t_img, j_img, atol=1e-5)
    np.testing.assert_allclose(t_z, j_z, atol=1e-5)


@pytest.mark.parametrize("samples, sample_shading", [(2, False), (8, True)])
def test_draw_indexed_matches_the_reference(samples, sample_shading):
    c0, z0 = _planes(samples)
    jp = _pipeline(J, samples, sample_shading)

    def jfn(c, z):
        cols, dep, _ = jdraw.draw_indexed([c], z, jp, jnp.asarray(VB), jnp.asarray(IB), {}, JG)
        return cols[0], dep

    j_img, j_z = (np.asarray(a) for a in jax.jit(jfn)(jnp.asarray(c0), jnp.asarray(z0)))
    t_img, t_z = _port_draw(samples, sample_shading)
    assert t_img.shape == (samples, H, W, 4) and t_z.shape == (samples, H, W)
    np.testing.assert_array_equal(t_z != z0, j_z != z0)  # per-sample coverage
    _assert_frames(t_img, t_z, j_img, j_z)


def _batch_draws(seed=21, nt=6):
    """Overlapping triangles as three draws of two (vb, ib) each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        xy = rng.uniform(-0.9, 0.9, (6, 2))
        z = rng.uniform(0.2, 0.9, (6, 1))
        col = rng.uniform(0.1, 1.0, (6, 3))
        out.append((np.concatenate([xy, z, col], 1).astype(np.float32),
                    np.arange(6, dtype=np.int32)))
    return out


@pytest.mark.parametrize("mode", ["plain", "stencil", "peel", "blend"])
def test_draw_indexed_batch_matches_the_reference_at_4x(mode):
    samples = 4
    kw = dict(stencil=mode == "stencil")
    if mode in ("peel", "blend"):
        kw.update(blend=True, alpha=0.6, kernel_safe=mode == "blend")
    jp, tp = _pipeline(J, samples, **kw), _pipeline(T, samples, **kw)
    c0, z0 = _planes(samples, seed=4)
    s0 = np.random.default_rng(5).integers(0, 4, (samples, H, W)).astype(np.int32)
    draws = _batch_draws()
    extra = dict(peel_layers=1) if mode == "peel" else {}  # the probe pass is K4

    def jfn(c, z, s):
        cols, dep, st = jdraw.draw_indexed_batch(
            [c], z, jp, [(jnp.asarray(v), jnp.asarray(i), {}) for v, i in draws], JG,
            stencil=s if mode == "stencil" else None, **extra)
        return cols[0], dep, st.stencil if mode == "stencil" else z, st.bin_overflow

    j_img, j_z, j_s, j_over = (np.asarray(a) for a in jax.jit(jfn)(
        jnp.asarray(c0), jnp.asarray(z0), jnp.asarray(s0)))
    cols, dep, st = tdraw.draw_indexed_batch(
        [torch.from_numpy(c0)], torch.from_numpy(z0), tp,
        [(torch.from_numpy(v), torch.from_numpy(i), {}) for v, i in draws], TG,
        stencil=torch.from_numpy(s0) if mode == "stencil" else None, **extra)
    t_img, t_z = cols[0].numpy(), dep.numpy()
    assert t_img.shape == (samples, H, W, 4)
    _assert_frames(t_img, t_z, j_img, j_z)
    assert int(st.bin_overflow) == int(j_over)
    if mode == "stencil":
        np.testing.assert_array_equal(st.stencil.numpy(), j_s)
        assert not np.array_equal(j_s, s0)


def _graph(passes=2, sample_shading=True, lambda_between=False, samples=2):
    """A ``samples``× MSAA graph of the port: node ``a`` clears and draws the
    triangle; with ``passes`` 2, node ``b`` LOADs colour and depth and draws
    a second, overlapping triangle (after a lambda node that rewrites the
    colour unchanged when ``lambda_between``). Returns the resolved colour."""
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.rhi import PipelineCache, RhiCore, TextureDesc

    st = tstate
    device = RhiCore("cpu").create_render_device()
    pipe = _pipeline(T, samples, sample_shading)
    si = pipe.desc.shader_input
    builder = RenderGraphBuilder()
    vb = builder.import_resource(device.upload_buffer("vb", VB))
    ib = builder.import_resource(device.upload_buffer("ib", IB))
    vb2 = builder.import_resource(device.upload_buffer(
        "vb2", VB[:, [1, 0, 2, 5, 4, 3]] * [1, 1, 1.2, 1, 1, 1]))
    color = builder.create(TextureDesc.color("rt", W, H))
    depth = builder.create(TextureDesc.depth("ds", W, H))
    builder.export(color)
    node = builder.add_graphic_node("a")
    vba, iba = node.read(vb), node.read(ib)
    rt, dsw = node.write(color), node.write(depth)
    with node.pipeline(si, pipe.desc.state) as binder:
        binder.push_color(rt, st.ColorAttachmentDesc(clear_value=(0, 0, 0, 0)))
        binder.set_depth(dsw, pipe.desc.depth_attachment_desc)
    node.execute(lambda ctx: ctx.draw_indexed(vba, iba, {}))
    if lambda_between:
        lam = builder.add_lambda_node("copy")
        c_in = lam.read(color)
        c_out = lam.write(color)
        lam.execute(lambda ctx: ctx.set(c_out, ctx.get(c_in) * 1.0))
    if passes == 2:
        node = builder.add_graphic_node("b")
        vbb, ibb = node.read(vb2), node.read(ib)
        node.read(color)
        node.read(depth)
        rt, dsw = node.write(color), node.write(depth)
        import dataclasses

        with node.pipeline(si, pipe.desc.state) as binder:
            binder.push_color(rt, st.ColorAttachmentDesc(load_op=st.LoadOp.LOAD))
            binder.set_depth(dsw, dataclasses.replace(pipe.desc.depth_attachment_desc,
                                                      depth_load_op=st.LoadOp.LOAD))
        node.execute(lambda ctx: ctx.draw_indexed(vbb, ibb, {}))
    compiled = builder.build().compile(device, PipelineCache(),
                                       CompileOptions(tile_h=8, tile_w=128))
    compiled.execute(device)
    return np.asarray(compiled.value(color))


def test_graph_resolves_colour_by_the_mean_of_the_samples():
    """One MSAA node: the stored colour is the mean of the draw's samples
    (the same draw through draw_indexed), exactly."""
    img = _graph(passes=1)
    cols, _, _ = tdraw.draw_indexed([torch.zeros((2, H, W, 4))], torch.zeros((2, H, W)),
                                    _pipeline(T, 2), torch.from_numpy(VB),
                                    torch.from_numpy(IB), {}, TG)
    np.testing.assert_array_equal(img, cols[0].mean(dim=0).numpy())
    partial = (img[..., 3] > 0.1) & (img[..., 3] < 0.9)
    assert partial.sum() > 10


def test_a_later_msaa_node_loads_the_per_sample_planes():
    """Node ``b`` continues from node ``a``'s per-sample planes; a lambda
    write in between drops them, and ``b`` then starts from the broadcast
    resolve, which differs at ``a``'s silhouette. (The reference's graph
    does the same: test_torch_forward.py holds a 4x frame whose
    forward.inst node LOADs forward's planes against it.)"""
    persisted = _graph()
    broadcast = _graph(lambda_between=True)
    differs = np.abs(persisted - broadcast).max(axis=-1) > 1e-4
    assert 0 < differs.sum() < 0.1 * H * W
