"""The port's render graph (zenith_tpu_torch/rendergraph): twins of the 22
cases of tests/test_rendergraph.py that run against the port (builder API,
compile caching, node execution order, dynamics, load/store semantics,
multi-pass dataflow, validation, capture keys, the LRU, the present
encode, retained execution, push constants), on CPU tensors. The 23rd,
the validate-mode capture self-check, is tests/test_torch_validate.py's.
The triangle frame is also held against the reference's frame of the same
graph (atol 1e-6).

Tolerances: the reference test's own.
"""

import numpy as np
import pytest

import torch

from zenith_tpu_torch.rendergraph import (
    CompileOptions,
    RenderGraphBuilder,
    clear_frame_program_cache,
    frame_program_cache_size,
)
from zenith_tpu_torch.rhi import (
    Buffer,
    BufferDesc,
    ColorAttachmentDesc,
    CullMode,
    Format,
    GraphicShaderInput,
    PipelineCache,
    RasterizationState,
    RhiCore,
    Shader,
    Texture,
    TextureDesc,
    VertexLayout,
    uniform,
)
from zenith_tpu_torch.rhi.state import DepthStencilDesc, GraphicPipelineState

W, H = 128, 32
OPTS = CompileOptions(tile_h=8, tile_w=128, bin_capacity=16)


CPU = torch.device("cpu")
torch.set_num_threads(1)


@pytest.fixture
def device():
    return RhiCore(CPU).create_render_device()


@pytest.fixture
def pcache():
    return PipelineCache()


def make_triangle_shaders():
    def vs(attrs, res):
        pos = attrs["position"]
        n = pos.shape[0]
        return {
            "position": torch.cat([pos, torch.ones((n, 1))], 1),
            "color": attrs["color"],
        }

    def fs(varyings, res, builtins):
        t = res["Time"]
        c = varyings["color"]
        animated = c * (0.5 + 0.5 * torch.sin(t * 3.0 + c * 6.28))
        return torch.cat([animated, torch.ones_like(c[..., :1])], -1)

    layout = VertexLayout.from_fields(("position", 3), ("color", 3))
    return (
        Shader.vertex("tri.vs", vs),
        Shader.fragment("tri.ps", fs, bindings=[uniform("Time")]),
        layout,
    )


TRI_VS, TRI_FS, TRI_LAYOUT = make_triangle_shaders()
TRI_VB = np.array(
    [
        [0.0, 0.5, 0.0, 1.0, 0.0, 0.0],
        [-0.5, -0.5, 0.0, 0.0, 1.0, 0.0],
        [0.5, -0.5, 0.0, 0.0, 0.0, 1.0],
    ],
    np.float32,
)
TRI_IB = np.array([0, 1, 2], np.int32)


def build_triangle_graph(vb, ib, output_tex, t):
    builder = RenderGraphBuilder()
    vbr = builder.import_resource(vb)
    ibr = builder.import_resource(ib)
    out = builder.import_resource(output_tex)
    builder.set_dynamic("time", t)

    node = builder.add_graphic_node("triangle")
    vba = node.read(vbr)
    iba = node.read(ibr)
    rt = node.write(out)
    shader = GraphicShaderInput(TRI_VS, TRI_FS, TRI_LAYOUT)
    state = GraphicPipelineState(
        rasterization=RasterizationState(cull_mode=CullMode.NONE)
    )
    with node.pipeline(shader, state) as binder:
        binder.push_color(rt, ColorAttachmentDesc(clear_value=(0.1, 0.1, 0.1, 1.0)))

    def record(ctx):
        ctx.bind("Time", ctx.dynamic("time"))
        ctx.draw_indexed(vba, iba)

    node.execute(record)
    return builder.build(), out


class TestLambdaClear:
    def test_clear_screen(self, device, pcache):
        """SimpleApp parity (zenith-sandbox/src/main.rs): lambda node clears
        the imported swapchain texture to blue."""
        tex = Texture(TextureDesc.color("swap", W, H), device=CPU)
        builder = RenderGraphBuilder()
        out = builder.import_resource(tex)
        node = builder.add_lambda_node("clear")
        oa = node.write(out)

        def record(ctx):
            from zenith_tpu_torch.ops import clear_color

            ctx.set(oa, clear_color(H, W, (0.2, 0.3, 0.8, 1.0), CPU))

        node.execute(record)
        graph = builder.build()
        compiled = graph.compile(device, pcache, OPTS)
        compiled.execute(device)
        img = np.asarray(compiled.value(out))
        np.testing.assert_allclose(img[0, 0], [0.2, 0.3, 0.8, 1.0], atol=1e-6)

    def test_undeclared_write_rejected(self, device, pcache):
        tex = Texture(TextureDesc.color("swap", W, H), device=CPU)
        builder = RenderGraphBuilder()
        out = builder.import_resource(tex)
        node = builder.add_lambda_node("bad")
        oa = node.read(out)  # read, not write

        def record(ctx):
            ctx.set(oa, torch.zeros((H, W, 4)))

        node.execute(record)
        with pytest.raises(ValueError, match="without"):
            builder.build().compile(device, pcache, OPTS).execute(device)


class TestTriangleGraph:
    def test_renders_and_caches(self, device, pcache):
        clear_frame_program_cache()
        vb = Buffer.from_numpy("tri.vb", TRI_VB, device=CPU)
        ib = Buffer.from_numpy("tri.ib", TRI_IB, device=CPU)
        tex = Texture(TextureDesc.color("swap", W, H), device=CPU)

        graph, out = build_triangle_graph(vb, ib, tex, 1.0)
        compiled = graph.compile(device, pcache, OPTS)
        compiled.execute(device)
        img1 = np.asarray(compiled.value(out))
        assert frame_program_cache_size() == 1
        # Background cleared to 0.1 linear.
        np.testing.assert_allclose(img1[0, 0], [0.1, 0.1, 0.1, 1.0], atol=1e-6)
        # Triangle interior shaded (center-bottom region).
        assert img1[int(0.6 * H), W // 2, :3].sum() > 0.35
        # The reference's graph renders the same frame.
        import test_rendergraph as ref_tests
        from zenith_tpu.rhi import Buffer as JBuffer, PipelineCache as JCache
        from zenith_tpu.rhi import RhiCore as JCore, Texture as JTexture

        jdev = JCore().create_render_device()
        jgraph, jout = ref_tests.build_triangle_graph(
            JBuffer.from_numpy("tri.vb", TRI_VB), JBuffer.from_numpy("tri.ib", TRI_IB),
            JTexture(ref_tests.TextureDesc.color("swap", W, H)), 1.0)
        jcompiled = jgraph.compile(jdev, JCache(), ref_tests.OPTS)
        jcompiled.execute(jdev)
        np.testing.assert_allclose(img1, np.asarray(jcompiled.value(jout)), atol=1e-6)

        # Rebuild (as the engine does every frame) with a new time: structure
        # hit, no retrace; different pixels.
        graph2, out2 = build_triangle_graph(vb, ib, tex, 2.5)
        compiled2 = graph2.compile(device, pcache, OPTS)
        compiled2.execute(device)
        img2 = np.asarray(compiled2.value(out2))
        assert frame_program_cache_size() == 1  # structure cache hit
        assert pcache.stats.hits >= 1
        assert not np.allclose(img1, img2)  # animation moved

    def test_equals_direct_draw(self, device, pcache):
        """Graph execution == calling ops.draw_indexed directly."""
        from zenith_tpu_torch.ops import TileGrid, clear_color, draw_indexed
        from zenith_tpu_torch.rhi import (
            GraphicPipelineAttachments,
            GraphicPipelineDesc,
        )

        vb = Buffer.from_numpy("tri.vb", TRI_VB, device=CPU)
        ib = Buffer.from_numpy("tri.ib", TRI_IB, device=CPU)
        tex = Texture(TextureDesc.color("swap", W, H), device=CPU)
        graph, out = build_triangle_graph(vb, ib, tex, 1.25)
        compiled = graph.compile(device, pcache, OPTS)
        compiled.execute(device)
        img_graph = np.asarray(compiled.value(out))

        desc = GraphicPipelineDesc(
            shader_input=GraphicShaderInput(TRI_VS, TRI_FS, TRI_LAYOUT),
            state=GraphicPipelineState(
                rasterization=RasterizationState(cull_mode=CullMode.NONE)
            ),
            attachments=GraphicPipelineAttachments(color_formats=(Format.RGBA32F,)),
            color_attachment_descs=(
                ColorAttachmentDesc(clear_value=(0.1, 0.1, 0.1, 1.0)),
            ),
        )
        pipe = PipelineCache().get_or_create(desc)
        grid = TileGrid(width=W, height=H, tile_h=8, tile_w=128)
        colors = [clear_color(H, W, (0.1, 0.1, 0.1, 1.0), CPU)]
        colors, _, _ = draw_indexed(
            colors, None, pipe, vb.array, ib.array,
            {"Time": torch.tensor(1.25)}, grid, bin_capacity=16,
        )
        np.testing.assert_allclose(img_graph, np.asarray(colors[0]), atol=1e-6)


class TestMultiPass:
    def test_two_pass_dataflow(self, device, pcache):
        """Pass 1 renders to an offscreen target; pass 2 (lambda) reads it
        and writes a transformed copy — inter-pass dataflow with no explicit
        sync, all inside one jitted program."""
        vb = Buffer.from_numpy("tri.vb", TRI_VB, device=CPU)
        ib = Buffer.from_numpy("tri.ib", TRI_IB, device=CPU)

        builder = RenderGraphBuilder()
        vbr = builder.import_resource(vb)
        ibr = builder.import_resource(ib)
        offscreen = builder.create(TextureDesc.color("offscreen", W, H))
        final = builder.create(TextureDesc.color("final", W, H))
        builder.export(final)
        builder.set_dynamic("time", 0.0)

        node = builder.add_graphic_node("tri")
        vba, iba = node.read(vbr), node.read(ibr)
        rt = node.write(offscreen)
        with node.pipeline(
            GraphicShaderInput(TRI_VS, TRI_FS, TRI_LAYOUT),
            GraphicPipelineState(
                rasterization=RasterizationState(cull_mode=CullMode.NONE)
            ),
        ) as binder:
            binder.push_color(rt, ColorAttachmentDesc(clear_value=(0, 0, 0, 1)))

        def record(ctx):
            ctx.bind("Time", ctx.dynamic("time"))
            ctx.draw_indexed(vba, iba)

        node.execute(record)

        post = builder.add_lambda_node("invert")
        src = post.read(offscreen)
        dst = post.write(final)

        def record_post(ctx):
            img = ctx.get(src)
            inverted = torch.cat([1.0 - img[..., :3], img[..., 3:]], -1)
            ctx.set(dst, inverted)

        post.execute(record_post)

        graph = builder.build()
        compiled = graph.compile(device, pcache, OPTS)
        compiled.execute(device)
        img = np.asarray(compiled.value(final))
        # Background black → inverted to white.
        np.testing.assert_allclose(img[0, 0, :3], 1.0, atol=1e-6)

    def test_depth_attachment_across_draws(self, device, pcache):
        """Two draws in one node share the depth buffer: the near triangle
        occludes the far one regardless of draw order."""

        def flat_vs(attrs, res):
            p = attrs["position"]
            return {
                "position": torch.cat([p, torch.ones((p.shape[0], 1))], 1),
                "color": attrs["color"],
            }

        def flat_fs(varyings, res, builtins):
            c = varyings["color"]
            return torch.cat([c, torch.ones_like(c[..., :1])], -1)

        layout = VertexLayout.from_fields(("position", 3), ("color", 3))
        vs = Shader.vertex("flat.vs", flat_vs)
        fs = Shader.fragment("flat.ps", flat_fs)

        def tri_buf(z, color):
            return np.array(
                [
                    [0.0, -0.5, z] + color,
                    [0.5, 0.5, z] + color,
                    [-0.5, 0.5, z] + color,
                ],
                np.float32,
            )

        near = Buffer.from_numpy("near", tri_buf(0.8, [0.0, 1.0, 0.0]), device=CPU)
        far = Buffer.from_numpy("far", tri_buf(0.2, [1.0, 0.0, 0.0]), device=CPU)
        ib = Buffer.from_numpy("ib", TRI_IB, device=CPU)

        builder = RenderGraphBuilder()
        nearr, farr, ibr = (
            builder.import_resource(near),
            builder.import_resource(far),
            builder.import_resource(ib),
        )
        color = builder.create(TextureDesc.color("rt", W, H))
        depth = builder.create(TextureDesc.depth("ds", W, H))
        builder.export(color)

        node = builder.add_graphic_node("scene")
        na, fa, ia = node.read(nearr), node.read(farr), node.read(ibr)
        rt = node.write(color)
        ds = node.write(depth)
        with node.pipeline(
            GraphicShaderInput(vs, fs, layout),
            GraphicPipelineState(
                rasterization=RasterizationState(cull_mode=CullMode.NONE)
            ),
        ) as binder:
            binder.push_color(rt, ColorAttachmentDesc(clear_value=(0, 0, 0, 1)))
            binder.set_depth(ds, DepthStencilDesc().reverse_z())

        def record(ctx):
            ctx.draw_indexed(na, ia)  # near drawn FIRST
            ctx.draw_indexed(fa, ia)  # far second — must not overwrite

        node.execute(record)

        compiled = builder.build().compile(device, pcache, OPTS)
        compiled.execute(device)
        img = np.asarray(compiled.value(color))
        np.testing.assert_allclose(img[H // 2, W // 2, :3], [0, 1, 0], atol=1e-5)


class TestValidation:
    def test_incomplete_node_skipped(self, device, pcache):
        tex = Texture(TextureDesc.color("swap", W, H), device=CPU)
        builder = RenderGraphBuilder()
        out = builder.import_resource(tex)
        node = builder.add_lambda_node("noop")  # no execute() closure
        node.write(out)
        compiled = builder.build().compile(device, pcache, OPTS)
        compiled.execute(device)  # must not raise

    def test_undeclared_dynamic_raises(self, device, pcache):
        tex = Texture(TextureDesc.color("swap", W, H), device=CPU)
        builder = RenderGraphBuilder()
        out = builder.import_resource(tex)
        node = builder.add_lambda_node("bad")
        oa = node.write(out)

        def record(ctx):
            ctx.set(oa, torch.zeros((H, W, 4)) + ctx.dynamic("missing"))

        node.execute(record)
        with pytest.raises(KeyError, match="missing"):
            builder.build().compile(device, pcache, OPTS).execute(device)


class TestCacheKeyCaptures:
    def test_different_closure_constants_do_not_alias(self, device, pcache):
        """Two graphs with identical structure but different captured
        trace-shaping constants (entry_budget here) must compile to distinct
        frame programs — closure captures are part of the structure key."""
        clear_frame_program_cache()
        vb = Buffer.from_numpy("tri.vb", TRI_VB, device=CPU)
        ib = Buffer.from_numpy("tri.ib", TRI_IB, device=CPU)
        tex = Texture(TextureDesc.color("swap", W, H), device=CPU)

        def build(budget):
            builder = RenderGraphBuilder()
            vbr = builder.import_resource(vb)
            ibr = builder.import_resource(ib)
            out = builder.import_resource(tex)
            builder.set_dynamic("time", 0.0)
            node = builder.add_graphic_node("triangle")
            vba, iba = node.read(vbr), node.read(ibr)
            rt = node.write(out)
            shader = GraphicShaderInput(TRI_VS, TRI_FS, TRI_LAYOUT)
            state = GraphicPipelineState(
                rasterization=RasterizationState(cull_mode=CullMode.NONE)
            )
            with node.pipeline(shader, state) as binder:
                binder.push_color(rt, ColorAttachmentDesc())

            def record(ctx):
                ctx.bind("Time", ctx.dynamic("time"))
                ctx.draw_indexed(vba, iba, entry_budget=budget)

            node.execute(record)
            return builder.build()

        build(8192).compile(device, pcache, OPTS).execute(device)
        assert frame_program_cache_size() == 1
        build(16384).compile(device, pcache, OPTS).execute(device)
        assert frame_program_cache_size() == 2  # no alias
        build(8192).compile(device, pcache, OPTS).execute(device)
        assert frame_program_cache_size() == 2  # still cached

    def test_container_captures_hash_contents(self, device, pcache):
        """Two same-length captured containers with different VALUES must
        produce different frame programs (round-1 hole: containers were
        hashed by len only, aliasing e.g. two scenes with equal object
        counts but different per-object budgets)."""
        clear_frame_program_cache()
        tex = Texture(TextureDesc.color("swap", W, H), device=CPU)

        def build(cfg):
            builder = RenderGraphBuilder()
            out = builder.import_resource(tex)
            node = builder.add_lambda_node("fill")
            oa = node.write(out)

            def record(ctx):
                # cfg values shape the traced constants.
                v = sum(c["gain"] for c in cfg)
                ctx.set(oa, torch.full((H, W, 4), float(v)))

            node.execute(record)
            return builder.build()

        cfg_a = [{"gain": 1.0}, {"gain": 2.0}]
        cfg_b = [{"gain": 1.0}, {"gain": 5.0}]  # same len, different content
        ca = build(cfg_a).compile(device, pcache, OPTS)
        ca.execute(device)
        assert frame_program_cache_size() == 1
        cb = build(cfg_b).compile(device, pcache, OPTS)
        cb.execute(device)
        assert frame_program_cache_size() == 2, (
            "same-length containers with different contents aliased to one "
            "frame program"
        )
        build(cfg_a).compile(device, pcache, OPTS).execute(device)
        assert frame_program_cache_size() == 2  # revisit hits the cache

    def test_nested_and_np_captures(self, device, pcache):
        """Nested containers and small host numpy arrays hash by content."""
        import numpy as np

        clear_frame_program_cache()
        tex = Texture(TextureDesc.color("swap", W, H), device=CPU)

        def build(nested):
            builder = RenderGraphBuilder()
            out = builder.import_resource(tex)
            node = builder.add_lambda_node("fill")
            oa = node.write(out)

            def record(ctx):
                v = float(np.sum(nested["lights"][0]["pos"]))
                ctx.set(oa, torch.full((H, W, 4), v))

            node.execute(record)
            return builder.build()

        a = {"lights": [{"pos": np.array([1.0, 2.0, 3.0])}]}
        b = {"lights": [{"pos": np.array([1.0, 2.0, 4.0])}]}
        build(a).compile(device, pcache, OPTS).execute(device)
        build(b).compile(device, pcache, OPTS).execute(device)
        assert frame_program_cache_size() == 2
        build(a).compile(device, pcache, OPTS).execute(device)
        assert frame_program_cache_size() == 2


class TestValidateMode:
    """ZENITH_VALIDATE=1 — the Vulkan-validation-layer analog
    (core.rs:15-16,180-198): static hazard warnings + traced NaN screening."""

    def test_read_before_write_warns(self, device, pcache, monkeypatch, caplog):
        import logging

        monkeypatch.setenv("ZENITH_VALIDATE", "1")
        clear_frame_program_cache()
        builder = RenderGraphBuilder()
        never_written = builder.create(TextureDesc.color("ghost", W, H))
        out = builder.import_resource(Texture(TextureDesc.color("swap", W, H), device=CPU))
        node = builder.add_lambda_node("reader")
        ra = node.read(never_written)
        oa = node.write(out)

        def record(ctx):
            ctx.set(oa, ctx.get(ra))

        node.execute(record)
        with caplog.at_level(logging.WARNING):
            builder.build().compile(device, pcache, OPTS)
        assert any("before any node wrote it" in r.message for r in caplog.records)

    def test_nan_screening_counts(self, device, pcache, monkeypatch):
        import numpy as np

        monkeypatch.setenv("ZENITH_VALIDATE", "1")
        clear_frame_program_cache()
        vb = Buffer.from_numpy("tri.vb", TRI_VB, device=CPU)
        ib = Buffer.from_numpy("tri.ib", TRI_IB, device=CPU)
        tex = Texture(TextureDesc.color("swap", W, H), device=CPU)
        builder = RenderGraphBuilder()
        vbr, ibr = builder.import_resource(vb), builder.import_resource(ib)
        out = builder.import_resource(tex)
        builder.set_dynamic("time", 0.0)
        node = builder.add_graphic_node("nan-shader")
        vba, iba = node.read(vbr), node.read(ibr)
        rt = node.write(out)

        def bad_fs(varyings, res, builtins):
            c = varyings["color"]
            # 0/0 NaNs over the covered area.
            return torch.cat([c * (c - c) / (c - c), torch.ones_like(c[..., :1])], -1)

        shader = GraphicShaderInput(
            TRI_VS, Shader.fragment("bad.fs", bad_fs), TRI_LAYOUT
        )
        state = GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE)
        )
        with node.pipeline(shader, state) as binder:
            binder.push_color(rt, ColorAttachmentDesc())

        def record(ctx):
            ctx.draw_indexed(vba, iba)

        node.execute(record)
        compiled = builder.build().compile(device, pcache, OPTS)
        retired = compiled.execute(device)
        nans = int(np.asarray(compiled._stats.nan_pixels))
        assert nans > 0  # the screen caught the shader's NaNs

        # And with validation off, the same graph reports zero (no screening)
        monkeypatch.setenv("ZENITH_VALIDATE", "0")
        clear_frame_program_cache()
        compiled = builder.build().compile(device, pcache, OPTS)
        compiled.execute(device)
        assert int(np.asarray(compiled._stats.nan_pixels)) == 0


class TestFrameProgramLRU:
    def test_cache_evicts_least_recently_used(self, device, pcache):
        """The frame-program cache is LRU-bounded: structure churn (e.g. a
        resolution sweep) cannot grow it past the limit."""
        from zenith_tpu_torch.rendergraph import set_frame_program_cache_limit

        clear_frame_program_cache()
        set_frame_program_cache_limit(3)
        try:
            def build(w):
                builder = RenderGraphBuilder()
                out = builder.create(TextureDesc.color("rt", w, 8))
                builder.export(out)
                node = builder.add_lambda_node("fill")
                dst = node.write(out)
                node.execute(lambda ctx: ctx.set(
                    dst, torch.ones((8, w, 4))))
                c = builder.build().compile(device, pcache, OPTS)
                c.execute(device)
                return c

            for w in (8, 16, 24, 32, 40):  # 5 distinct structures
                build(w)
            assert frame_program_cache_size() == 3
            # Most-recent structures still hit (no growth on re-touch).
            build(40)
            assert frame_program_cache_size() == 3
        finally:
            set_frame_program_cache_limit(256)
            clear_frame_program_cache()


class TestPresentEncode:
    def test_encode_node_matches_present_encode(self, device, pcache):
        """PresentEncode folds the sRGB swapchain encode into the frame
        program; its output must equal encode_present of the linear image,
        and Swapchain.present must pass pre-encoded uint8 frames through."""
        from zenith_tpu_torch.renderer import PresentEncode
        from zenith_tpu_torch.rhi import Format
        from zenith_tpu_torch.rhi.formats import encode_present

        clear_frame_program_cache()
        builder = RenderGraphBuilder()
        lin = builder.create(TextureDesc.color("lin", W, H))
        enc = builder.create(TextureDesc.color("enc", W, H, Format.BGRA8_SRGB))
        builder.export(lin)
        builder.export(enc)

        node = builder.add_lambda_node("gen")
        dst = node.write(lin)

        def record(ctx):
            g = torch.linspace(0.0, 1.5, W)
            img = g[None, :, None].expand(H, W, 4)
            ctx.set(dst, img)

        node.execute(record)
        PresentEncode(Format.BGRA8_SRGB).render_to(builder, lin, enc)

        compiled = builder.build().compile(device, pcache, OPTS)
        compiled.execute(device)
        lin_v = compiled.value(lin)
        enc_v = np.asarray(compiled.value(enc))
        assert enc_v.dtype == np.uint8
        ref = np.asarray(encode_present(lin_v, Format.BGRA8_SRGB))
        np.testing.assert_array_equal(enc_v, ref)

        # Swapchain passthrough: pre-encoded frames skip the encode jit.
        from zenith_tpu_torch.rhi.swapchain import Swapchain, SwapchainConfig

        got = []
        sc = Swapchain(
            device,
            SwapchainConfig(width=W, height=H),
            on_present=lambda frame, idx: got.append(frame),
        )
        sc.acquire_next_image()
        sc.present(torch.from_numpy(enc_v))
        sc.flush()
        np.testing.assert_array_equal(got[0], enc_v)


class TestRetainedExecute:
    def test_retained_dynamics_override_matches_rebuild(self, device, pcache):
        """Retained mode: execute(dynamics=...) re-runs the SAME compiled
        program with new per-frame values — output must equal a full
        rebuild at that value, with zero extra frame programs."""
        clear_frame_program_cache()
        vb = Buffer.from_numpy("tri.vb", TRI_VB, device=CPU)
        ib = Buffer.from_numpy("tri.ib", TRI_IB, device=CPU)
        tex = Texture(TextureDesc.color("swap", W, H), device=CPU)

        graph, out = build_triangle_graph(vb, ib, tex, np.float32(1.0))
        compiled = graph.compile(device, pcache, OPTS)
        compiled.execute(device)
        np.asarray(compiled.value(out))

        compiled.execute(device, dynamics={"time": np.float32(2.5)})
        img_retained = np.asarray(compiled.value(out))
        assert frame_program_cache_size() == 1

        graph2, out2 = build_triangle_graph(vb, ib, tex, np.float32(2.5))
        compiled2 = graph2.compile(device, pcache, OPTS)
        compiled2.execute(device)
        img_rebuilt = np.asarray(compiled2.value(out2))
        assert frame_program_cache_size() == 1  # same structure
        np.testing.assert_array_equal(img_retained, img_rebuilt)

    def test_retained_rejects_signature_changes(self, device, pcache):
        vb = Buffer.from_numpy("tri.vb", TRI_VB, device=CPU)
        ib = Buffer.from_numpy("tri.ib", TRI_IB, device=CPU)
        tex = Texture(TextureDesc.color("swap", W, H), device=CPU)
        graph, out = build_triangle_graph(vb, ib, tex, np.float32(1.0))
        compiled = graph.compile(device, pcache, OPTS)
        compiled.execute(device)
        with pytest.raises(KeyError, match="not declared"):
            compiled.execute(device, dynamics={"nope": 1.0})
        with pytest.raises(ValueError, match="signature"):
            compiled.execute(
                device, dynamics={"time": np.zeros((4,), np.float32)}
            )


class TestCaptureMemoDepth:
    def test_deep_stub_does_not_alias_shallow_capture(self):
        """The per-compile memo must not reuse a depth-truncated stub
        (stored when an object was reached past the recursion cap) for the
        same object captured directly at shallow depth."""
        from zenith_tpu_torch.rendergraph.graph import _capture_key

        x = np.array([1.0, 2.0], np.float32)
        deep = [[[[[x]]]]]  # x is reached at depth 5 -> 'cap-deep' stub

        memo = {}
        _capture_key(deep, memo=memo)
        shallow_after_deep = _capture_key(x, memo=memo)
        shallow_fresh = _capture_key(x, memo={})
        assert shallow_after_deep == shallow_fresh
        assert shallow_fresh[0] == "cap-np"  # content, not a stub


class TestPushConstants:
    """cmd push_constants parity (reference command.rs; slot reflected from
    SPIR-V in shader.rs:380-413, layout range pipeline.rs:111-131)."""

    @staticmethod
    def _build(record_fn, fs_bindings):
        from zenith_tpu_torch.rhi import push_constant  # noqa: F401 (re-export)

        def vs(attrs, res):
            pos = attrs["position"]
            n = pos.shape[0]
            return {
                "position": torch.cat([pos, torch.ones((n, 1))], 1),
                "color": attrs["color"],
            }

        def fs(varyings, res, builtins):
            tint = res["Tint"]
            c = varyings["color"] * tint[:3]
            return torch.cat([c, torch.ones_like(c[..., :1])], -1)

        shader = GraphicShaderInput(
            Shader.vertex("pc.vs", vs),
            Shader.fragment("pc.ps", fs, bindings=fs_bindings),
            TRI_LAYOUT,
        )
        vb = Buffer.from_numpy("tri.vb", TRI_VB, device=CPU)
        ib = Buffer.from_numpy("tri.ib", TRI_IB, device=CPU)
        tex = Texture(TextureDesc.color("swap", W, H), device=CPU)
        builder = RenderGraphBuilder()
        vbr, ibr = builder.import_resource(vb), builder.import_resource(ib)
        out = builder.import_resource(tex)
        node = builder.add_graphic_node("pc")
        vba, iba = node.read(vbr), node.read(ibr)
        rt = node.write(out)
        state = GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE)
        )
        with node.pipeline(shader, state) as binder:
            binder.push_color(
                rt, ColorAttachmentDesc(clear_value=(0.0, 0.0, 0.0, 1.0))
            )
        node.execute(lambda ctx: record_fn(ctx, vba, iba))
        return builder.build(), out

    def test_routes_value_to_declared_slot(self, device, pcache):
        from zenith_tpu_torch.rhi import push_constant

        def record(ctx, vba, iba):
            ctx.push_constants(np.array([0.0, 1.0, 0.0, 1.0], np.float32))
            ctx.draw_indexed(vba, iba)

        graph, out = self._build(record, [push_constant("Tint")])
        compiled = graph.compile(device, pcache, OPTS)
        compiled.execute(device)
        img = np.asarray(compiled.value(out))
        inner = img[int(0.6 * H), W // 2]
        assert inner[1] > 0.05  # green channel survives the tint
        assert inner[0] == 0.0 and inner[2] == 0.0  # red/blue zeroed

    def test_no_declared_slot_raises(self, device, pcache):
        from zenith_tpu_torch.rhi import uniform as u
        from zenith_tpu_torch.rhi.shader import BindingError

        def record(ctx, vba, iba):
            ctx.push_constants(np.zeros(4, np.float32))
            ctx.draw_indexed(vba, iba)

        graph, _ = self._build(record, [u("Tint")])
        with pytest.raises(BindingError, match="no push_constant"):
            graph.compile(device, pcache, OPTS).execute(device)

    def test_two_slots_rejected(self, device, pcache):
        from zenith_tpu_torch.rhi import push_constant
        from zenith_tpu_torch.rhi.shader import BindingError

        def record(ctx, vba, iba):
            ctx.push_constants(np.zeros(4, np.float32))
            ctx.draw_indexed(vba, iba)

        graph, _ = self._build(
            record, [push_constant("Tint"), push_constant("Other")]
        )
        with pytest.raises(BindingError, match="one range"):
            graph.compile(device, pcache, OPTS).execute(device)

    def test_vulkan_size_guarantee_enforced(self, device, pcache):
        from zenith_tpu_torch.rhi import push_constant
        from zenith_tpu_torch.rhi.shader import BindingError

        def record(ctx, vba, iba):
            ctx.push_constants(np.zeros(33, np.float32))  # 132 bytes
            ctx.draw_indexed(vba, iba)

        graph, _ = self._build(record, [push_constant("Tint")])
        with pytest.raises(BindingError, match="128"):
            graph.compile(device, pcache, OPTS).execute(device)
