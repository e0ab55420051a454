"""Fixed-function state on the port (tests/test_fixedfunc.py's eighteen
cases): triangle-strip decode with primitive restart and its winding,
depth bias (constant, slope, off by default), depth clamp of out-of-range
z, the isotropic and anisotropic sampling footprints, the pipeline's
sample-count and stencil-format checks, and multisampling: partial edge
coverage at 4×, finer coverage at 8× and a two-node MSAA chain equal to
one node.

Each case asserts on the port what the reference's asserts on its own
package, at its sizes (128×32, 8×128 tiles). The multisampled renders are
module-scoped fixtures, rendered once for the cases that share them.
test_torch_textured.py holds the anisotropic cases' sampling against the
reference's, test_torch_draw.py and test_torch_lines_points.py the strip
and list draws, test_torch_msaa.py the MSAA paths.

Tolerances: the reference's own.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from zenith_tpu_torch.ops import (
    TileGrid,
    bin_segmented,
    corner_attributes,
    raster_segmented,
    setup_triangles,
    setup_with_attrs,
)
from zenith_tpu_torch.ops.draw import assemble_triangles
from zenith_tpu_torch.ops.sampling import sample_texture
from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
from zenith_tpu_torch.rhi import (
    Buffer,
    ColorAttachmentDesc,
    Format,
    GraphicShaderInput,
    PipelineCache,
    RhiCore,
    Shader,
    TextureDesc,
    VertexLayout,
)
from zenith_tpu_torch.rhi.pipeline import GraphicPipeline, GraphicPipelineDesc
from zenith_tpu_torch.rhi.sampler import SamplerConfig
from zenith_tpu_torch.rhi.state import (
    CompareOp,
    CullMode,
    DepthStencilDesc,
    GraphicPipelineAttachments,
    GraphicPipelineState,
    InputAssemblyState,
    LoadOp,
    MultisampleState,
    PrimitiveTopology,
    RasterizationState,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 32
GRID = TileGrid(width=W, height=H, tile_h=8, tile_w=128)
OPTS = CompileOptions(tile_h=8, tile_w=128)

STRIP = InputAssemblyState(topology=PrimitiveTopology.TRIANGLE_STRIP)
STRIP_RESTART = InputAssemblyState(topology=PrimitiveTopology.TRIANGLE_STRIP,
                                   primitive_restart=True)


def _idx(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32)


class TestTriangleStrip:
    def test_list_passthrough(self):
        tris = assemble_triangles(_idx([0, 1, 2, 2, 1, 3]), InputAssemblyState())
        np.testing.assert_array_equal(tris.numpy(), [[0, 1, 2], [2, 1, 3]])

    def test_strip_decode_winding(self):
        # Vulkan rule: even i → (i, i+1, i+2); odd i → (i+1, i, i+2).
        tris = assemble_triangles(_idx([0, 1, 2, 3, 4]), STRIP).numpy()
        np.testing.assert_array_equal(tris, [[0, 1, 2], [2, 1, 3], [2, 3, 4]])

    def test_restart_splits_and_resets_parity(self):
        # Strip [0 1 2 3] | restart | [4 5 6 7]: the second strip's first
        # triangle is even-parity again; triangles touching the restart
        # collapse to (0, 0, 0).
        tris = assemble_triangles(_idx([0, 1, 2, 3, -1, 4, 5, 6, 7]), STRIP_RESTART).numpy()
        expected = [[0, 1, 2], [2, 1, 3], [0, 0, 0], [0, 0, 0], [0, 0, 0], [4, 5, 6], [6, 5, 7]]
        np.testing.assert_array_equal(tris, expected)

    def test_without_restart_flag_sentinel_is_literal(self):
        # primitive_restart off: -1 is an ordinary (bogus) index.
        tris = assemble_triangles(_idx([0, 1, 2, -1]), STRIP).numpy()
        np.testing.assert_array_equal(tris, [[0, 1, 2], [2, 1, -1]])

    def test_strip_render_equals_list_render(self):
        """A strip draw covers the same pixels as the equivalent triangle
        list (same winding, so the same culling)."""
        verts = np.array([[-0.8, -0.8], [-0.8, 0.8], [0.0, -0.8], [0.0, 0.8], [0.8, -0.8]],
                         np.float32)
        clip = torch.from_numpy(np.concatenate([verts, np.full((5, 1), 0.5), np.ones((5, 1))],
                                               axis=1).astype(np.float32))

        def cover(idx_tris):
            idx_tris = idx_tris.to(torch.int32)
            records = setup_triangles(clip, idx_tris, W, H, cull_mode=CullMode.BACK)
            corner = corner_attributes(records, idx_tris, torch.zeros((5, 0)))
            bins = bin_segmented(records, corner, GRID)
            z, acc = raster_segmented(bins, GRID, torch.zeros((H, W)),
                                      compare_op=CompareOp.GREATER)
            return (acc[-1] > 0).numpy()

        strip_tris = assemble_triangles(torch.arange(5, dtype=torch.int32), STRIP)
        list_tris = _idx([[0, 1, 2], [2, 1, 3], [2, 3, 4]])
        np.testing.assert_array_equal(cover(strip_tris), cover(list_tris))
        assert cover(list_tris).sum() > 100  # nontrivial, not all culled


class TestDepthBias:
    def _z_at_center(self, depth_bias=None, z0=0.5, slope=False):
        zs = np.array([z0, z0 + (0.2 if slope else 0.0), z0], np.float32)
        clip = torch.tensor([[-0.9, -0.9, zs[0], 1.0], [0.9, -0.9, zs[1], 1.0],
                             [0.0, 0.9, zs[2], 1.0]], dtype=torch.float32)
        records, corner = setup_with_attrs(clip, _idx([[0, 1, 2]]), torch.zeros((3, 0)), W, H,
                                           cull_mode=CullMode.NONE, depth_bias=depth_bias)
        bins = bin_segmented(records, corner, GRID)
        z, _ = raster_segmented(bins, GRID, torch.zeros((H, W)), compare_op=CompareOp.GREATER)
        return float(z[H // 2, W // 2])

    def test_constant_bias_offsets_depth(self):
        base = self._z_at_center()
        # 2^20 ULPs at z ≈ 0.5 (r = 2^-24 there): bias = 1/16.
        biased = self._z_at_center(depth_bias=(2.0**20, 0.0))
        assert biased > base
        np.testing.assert_allclose(biased - base, 2.0**20 * 2.0**-24, rtol=1e-3)

    def test_slope_bias_scales_with_gradient(self):
        flat_delta = self._z_at_center(depth_bias=(0.0, 1.0)) - self._z_at_center()
        # Flat triangle: dz/dx = dz/dy = 0, so the slope bias is a no-op.
        assert abs(flat_delta) < 1e-7
        sloped_base = self._z_at_center(slope=True)
        sloped = self._z_at_center(depth_bias=(0.0, 1.0), slope=True)
        assert sloped - sloped_base > 1e-5

    def test_disabled_in_state_means_none(self):
        # draw_indexed applies a bias only when depth_bias_enable is set.
        assert not RasterizationState().depth_bias_enable


class TestDepthClamp:
    def test_out_of_range_z_clamps_instead_of_discarding(self):
        # A triangle entirely past the far plane (z = 1.5 > 1).
        clip = torch.tensor([[-0.9, -0.9, 1.5, 1.0], [0.9, -0.9, 1.5, 1.0],
                             [0.0, 0.9, 1.5, 1.0]], dtype=torch.float32)

        def run(clamp):
            records, corner = setup_with_attrs(clip, _idx([[0, 1, 2]]), torch.zeros((3, 0)), W,
                                               H, cull_mode=CullMode.NONE, depth_clamp=clamp)
            bins = bin_segmented(records, corner, GRID)
            z, acc = raster_segmented(bins, GRID, torch.full((H, W), -1.0),
                                      compare_op=CompareOp.GREATER, depth_clamp=clamp)
            return z.numpy(), (acc[-1] > 0).numpy()

        z_off, cov_off = run(False)
        assert not cov_off.any()  # discarded without clamp
        z_on, cov_on = run(True)
        assert cov_on.sum() > 100
        np.testing.assert_allclose(z_on[cov_on], 1.0, atol=1e-6)  # clamped


class TestAnisotropic:
    def _checker(self, n=64):
        # 8-texel cells: sample points must not all land on cell boundaries.
        yy, xx = np.mgrid[0:n, 0:n]
        c = ((xx // 8 + yy // 8) % 2).astype(np.float32)
        return np.stack([c, c, c], axis=-1)

    def _mips(self, base):
        mips = [torch.from_numpy(base)]
        cur = base
        while min(cur.shape[:2]) > 1:
            hh, ww = cur.shape[0] // 2, cur.shape[1] // 2
            cur = cur[: hh * 2, : ww * 2].reshape(hh, 2, ww, 2, -1).mean((1, 3))
            mips.append(torch.from_numpy(cur.astype(np.float32)))
        return tuple(mips)

    def test_isotropic_footprint_matches_trilinear(self):
        mips = self._mips(self._checker())
        u = (np.arange(16, dtype=np.float32) + 0.5) / 16
        uv = torch.from_numpy(np.stack(np.meshgrid(u, u), axis=-1))
        tri = sample_texture(mips, uv, SamplerConfig.linear()).numpy()
        aniso = sample_texture(mips, uv, SamplerConfig.anisotropic(4.0)).numpy()
        # An isotropic UV grid: ratio 1, so every probe coincides with trilinear.
        np.testing.assert_allclose(aniso[1:, 1:], tri[1:, 1:], atol=1e-5)

    def test_anisotropic_footprint_sharper_than_trilinear(self):
        mips = self._mips(self._checker())
        # Stretched footprint: u minified 8×, v 1:1; trilinear blurs to the
        # major axis, anisotropic keeps the v detail.
        u = (np.arange(8, dtype=np.float32) + 0.5) / 8
        v = (np.arange(32, dtype=np.float32) + 0.5) / (32 * 4)
        uv = torch.from_numpy(np.stack(np.meshgrid(u, v, indexing="xy"), axis=-1))
        tri = sample_texture(mips, uv, SamplerConfig.linear()).numpy()
        aniso = sample_texture(mips, uv, SamplerConfig.anisotropic(8.0)).numpy()
        assert np.isfinite(aniso).all()
        assert aniso[1:, 1:].std() > tri[1:, 1:].std()


class TestStateValidation:
    def _mk_pipeline(self, state):
        vs = Shader.vertex("vs", lambda attrs, res: {"position": attrs["position"]})
        return GraphicPipeline(GraphicPipelineDesc(
            shader_input=GraphicShaderInput(vs, None, None), state=state,
            attachments=GraphicPipelineAttachments(color_formats=(Format.RGBA32F,))))

    def test_unsupported_sample_count_raises(self):
        with pytest.raises(NotImplementedError, match="multisampling"):
            self._mk_pipeline(GraphicPipelineState(multisample=MultisampleState(samples=3)))

    def test_supported_sample_counts_ok(self):
        for n in (1, 2, 4, 8):
            self._mk_pipeline(GraphicPipelineState(multisample=MultisampleState(samples=n)))

    def test_stencil_without_format_raises(self):
        state = GraphicPipelineState(depth_stencil=DepthStencilDesc().stencil_write(1))
        with pytest.raises(ValueError, match="stencil"):
            self._mk_pipeline(state)

    def test_default_state_ok(self):
        self._mk_pipeline(GraphicPipelineState())


VS = Shader.vertex("vs", lambda attrs, res: {"position": attrs["position"]})
POS_LAYOUT = VertexLayout.from_fields(("position", 4))


def _solid_fs(name, col):
    return Shader.fragment(
        name, lambda varyings, res, b: torch.tensor(col, dtype=torch.float32)
        .expand(*b.depth.shape, 4))


FS_WHITE = _solid_fs("fs", (1.0, 1.0, 1.0, 1.0))
# A thin sliver maximizes partially covered edge pixels; TRI_B crosses it
# nearer the camera (reverse-Z GREATER).
TRI_A = np.array([[-0.9, -0.85, 0.5, 1.0], [0.9, -0.62, 0.5, 1.0], [-0.9, -0.7, 0.5, 1.0]],
                 np.float32)
TRI_B = np.array([[-0.9, -0.65, 0.7, 1], [0.9, -0.85, 0.7, 1], [0.9, -0.7, 0.7, 1]], np.float32)


def render_sliver(samples: int) -> np.ndarray:
    """TestMSAA._render: the sliver at ``samples`` per pixel, resolved."""
    device = RhiCore(CPU).create_render_device()
    vb = Buffer.from_numpy("sliver.vb", TRI_A, device=CPU)
    ib = Buffer.from_numpy("sliver.ib", np.array([0, 1, 2], np.int32), device=CPU)
    builder = RenderGraphBuilder()
    vbr, ibr = builder.import_resource(vb), builder.import_resource(ib)
    out = builder.create(TextureDesc.color("rt", W, H))
    dep = builder.create(TextureDesc.depth("ds", W, H))
    builder.export(out)
    node = builder.add_graphic_node("sliver")
    vba, iba = node.read(vbr), node.read(ibr)
    rt, dsw = node.write(out), node.write(dep)
    state = GraphicPipelineState(rasterization=RasterizationState(cull_mode=CullMode.NONE),
                                 multisample=MultisampleState(samples=samples))
    with node.pipeline(GraphicShaderInput(VS, FS_WHITE, POS_LAYOUT), state) as binder:
        binder.push_color(rt, ColorAttachmentDesc(clear_value=(0, 0, 0, 1)))
        binder.set_depth(dsw, DepthStencilDesc().reverse_z())
    node.execute(lambda ctx: ctx.draw_indexed(vba, iba))
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    return compiled.value(out).numpy()


def render_chain(split_nodes: bool) -> np.ndarray:
    """TestMSAACrossNode._build: both slivers under 4× MSAA, in one node or
    in two (the second LOADs colour and depth)."""
    device = RhiCore(CPU).create_render_device()
    vba = Buffer.from_numpy("a.vb", TRI_A, device=CPU)
    vbb = Buffer.from_numpy("b.vb", TRI_B, device=CPU)
    ib = Buffer.from_numpy("t.ib", np.array([0, 1, 2], np.int32), device=CPU)
    state = GraphicPipelineState(rasterization=RasterizationState(cull_mode=CullMode.NONE),
                                 depth_stencil=DepthStencilDesc().reverse_z(),
                                 multisample=MultisampleState(samples=4))
    builder = RenderGraphBuilder()
    handle_of = {id(vba): builder.import_resource(vba), id(vbb): builder.import_resource(vbb)}
    ri = builder.import_resource(ib)
    out = builder.create(TextureDesc.color("rt", W, H))
    dep = builder.create(TextureDesc.depth("ds", W, H))
    builder.export(out)

    def add_node(name, vbs, first):
        node = builder.add_graphic_node(name)
        accesses = [(node.read(handle_of[id(v)]), node.read(ri)) for v in vbs]
        rt, ds = node.write(out), node.write(dep)
        with node.pipeline(GraphicShaderInput(VS, FS_WHITE, POS_LAYOUT), state) as binder:
            if first:
                binder.push_color(rt, ColorAttachmentDesc(clear_value=(0, 0, 0, 1)))
                binder.set_depth(ds, DepthStencilDesc().reverse_z())
            else:
                binder.push_color(rt, ColorAttachmentDesc(load_op=LoadOp.LOAD))
                binder.set_depth(ds, replace(DepthStencilDesc().reverse_z(),
                                             depth_load_op=LoadOp.LOAD))

        def record(ctx, accesses=accesses):
            for va, ia in accesses:
                ctx.draw_indexed(va, ia)

        node.execute(record)

    if split_nodes:
        add_node("pass1", [vba], first=True)
        add_node("pass2", [vbb], first=False)
    else:
        add_node("both", [vba, vbb], first=True)
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    return compiled.value(out).numpy()


@pytest.fixture(scope="module")
def slivers():
    return {n: render_sliver(n)[..., 0] for n in (1, 4, 8)}


class TestMSAA:
    """Multisampling (Vulkan standard sample positions, spec 25.3): one
    shared binning, per-sample raster and shade, averaged resolve."""

    def test_msaa_produces_partial_edge_coverage(self, slivers):
        img1, img4 = slivers[1], slivers[4]
        # Single-sample: strictly binary coverage.
        assert set(np.round(np.unique(img1), 6)) <= {0.0, 1.0}
        # 4×: fractional coverage along the sliver's edges.
        partial = ((img4 > 0.1) & (img4 < 0.9)).sum()
        assert partial > 20, f"only {partial} partially covered pixels"
        # The same geometry: coverage masses agree within a pixel row.
        assert abs(img4.sum() - img1.sum()) / max(img1.sum(), 1) < 0.2

    def test_msaa8_edge_coverage_finer_than_4x(self, slivers):
        """8×: more coverage levels along the sliver edge than 4×."""
        img4, img8 = slivers[4], slivers[8]
        levels4 = np.unique(np.round(img4, 4))
        levels8 = np.unique(np.round(img8, 4))
        assert len(levels8) > len(levels4) >= 3
        assert abs(img8.sum() - img4.sum()) / max(img4.sum(), 1) < 0.1


class TestMSAACrossNode:
    """Per-sample attachments persist across nodes: a two-node MSAA chain
    (node 2 LOADs colour and depth) matches drawing both triangles in one
    node, which only holds if the per-sample planes survive the node
    boundary."""

    def test_two_node_msaa_chain_matches_single_node(self):
        single = render_chain(split_nodes=False)
        split = render_chain(split_nodes=True)
        vals = single[..., 0]
        assert ((vals > 0.1) & (vals < 0.9)).sum() > 20  # really multisampled
        np.testing.assert_allclose(split, single, atol=1e-6)
