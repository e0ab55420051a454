"""The render graph's sub-resource views in the port — render-to-mip,
render-to-layer, buffer ranges, mip chains on layered and 3D textures and
the render-to-mip bloom chain — against the reference package: twins of
the twelve tests of tests/test_subresource.py. Each case builds the same
graph in both packages (the same shaders written in jnp and in torch) and
asserts the reference test's own checks on the port's result, then that
the two results are equal (exactly, or for the bloom frames at the golden
tolerance: the tonemapped frame encoded ≤ 1 LSB with < 1% of values
differing; depth at atol 1e-6, since XLA's CPU backend contracts the
reference's depth interpolation into FMAs and the port rounds each
product, ROADMAP §3 "FMA": measured 1.5e-7 on 9.6% of the cascade's
pixels).

Also here: a previous frame's export held across a retained frame stays
as it was (layer and range writes make new tensors), and a clear or LOAD
of one layer leaves the other layers alone.
"""

import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")

TRI_VB = np.array([[-0.9, -0.9, 0.5, 1.0, 0.0, 0.0],
                   [0.9, -0.9, 0.5, 1.0, 0.0, 0.0],
                   [0.0, 0.9, 0.5, 1.0, 0.0, 0.0]], np.float32)
TRI_IB = np.array([0, 1, 2], np.int32)


def _jax():
    import jax.numpy as jnp

    import zenith_tpu.rendergraph as rg
    import zenith_tpu.renderer as rr
    import zenith_tpu.rhi as rhi
    import zenith_tpu.rhi.state as st
    from zenith_tpu.ops.sampling import sample_cube
    from zenith_tpu.rendergraph.graph import frame_program_cache_size

    def vs(attrs, res):
        p = attrs["position"]
        return {"position": jnp.concatenate([p, jnp.ones((p.shape[0], 1), jnp.float32)], axis=1),
                "color": attrs["color"]}

    def fs(varyings, res, builtins):
        c = varyings["color"]
        return jnp.concatenate([c, jnp.ones_like(c[..., :1])], axis=-1)

    return types.SimpleNamespace(
        rg=rg, rr=rr, rhi=rhi, st=st, vs=vs, fs=fs, sample_cube=sample_cube,
        cache_size=frame_program_cache_size,
        device=lambda: rhi.RhiCore().create_render_device(),
        full=lambda shape, v: jnp.full(shape, v, jnp.float32),
        const=lambda a: jnp.asarray(a),
        np=np.asarray)


def _port():
    import zenith_tpu_torch.rendergraph as rg
    import zenith_tpu_torch.renderer as rr
    import zenith_tpu_torch.rhi as rhi
    import zenith_tpu_torch.rhi.state as st
    from zenith_tpu_torch.ops.sampling import sample_cube
    from zenith_tpu_torch.rendergraph.graph import frame_program_cache_size

    def vs(attrs, res):
        p = attrs["position"]
        return {"position": torch.cat([p, torch.ones_like(p[:, :1])], dim=1),
                "color": attrs["color"]}

    def fs(varyings, res, builtins):
        c = varyings["color"]
        return torch.cat([c, torch.ones_like(c[..., :1])], dim=-1)

    return types.SimpleNamespace(
        rg=rg, rr=rr, rhi=rhi, st=st, vs=vs, fs=fs, sample_cube=sample_cube,
        cache_size=frame_program_cache_size,
        device=lambda: rhi.RhiCore(CPU).create_render_device(),
        full=lambda shape, v: torch.full(shape, v, dtype=torch.float32),
        const=lambda a: torch.from_numpy(np.array(a)),
        np=lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t))


PACKAGES = {}


def _pkgs():
    if not PACKAGES:
        PACKAGES["jax"] = _jax()
        PACKAGES["port"] = _port()
    return PACKAGES


def _shaders(P, with_fs=True):
    layout = P.st.VertexLayout.from_fields(("position", 3), ("color", 3))
    vs = P.rhi.Shader.vertex("sub.vs", P.vs, inputs=[P.rhi.attr("position", 3),
                                                     P.rhi.attr("color", 3)])
    fs = P.rhi.Shader.fragment("sub.fs", P.fs) if with_fs else None
    return P.rhi.GraphicShaderInput(vs, fs, layout)


def _state(P):
    return P.st.GraphicPipelineState(
        rasterization=P.st.RasterizationState(cull_mode=P.st.CullMode.NONE))


def _triangle(P, device, builder, node):
    vb = device.upload_buffer("vb", TRI_VB)
    ib = device.upload_buffer("ib", TRI_IB)
    vbh, ibh = builder.import_resource(vb), builder.import_resource(ib)
    return node.read(vbh), node.read(ibh)


def _levels(P, value):
    return [P.np(v) for v in value] if isinstance(value, tuple) else P.np(value)


def _both(build):
    """``build(P)`` → {name: value} in each package, as numpy."""
    out = {}
    for name, P in _pkgs().items():
        res = build(P)
        out[name] = {k: _levels(P, v) for k, v in res.items()}
    return out["port"], out["jax"]


def _assert_equal(port, ref, atol=0.0):
    assert port.keys() == ref.keys()
    for k in port:
        a, b = port[k], ref[k]
        pairs = zip(a, b) if isinstance(a, list) else [(a, b)]
        assert not isinstance(a, list) or len(a) == len(b)
        for x, y in pairs:
            np.testing.assert_allclose(x, y, rtol=0, atol=atol, err_msg=k)


# -- TestRenderToMip ----------------------------------------------------------


def test_graphic_node_renders_into_mip1():
    def build(P):
        device = P.device()
        builder = P.rg.RenderGraphBuilder()
        tex = builder.create(P.rhi.TextureDesc("mips", 256, 128, P.rhi.Format.RGBA32F,
                                               mip_levels=3))
        builder.export(tex)
        node = builder.add_graphic_node("to_mip1")
        vba, iba = _triangle(P, device, builder, node)
        rt = node.write(tex, mip=1)  # a 128x64 surface
        with node.pipeline(_shaders(P), _state(P)) as binder:
            binder.push_color(rt, P.rhi.ColorAttachmentDesc(clear_value=(0, 0, 1, 1)))
        node.execute(lambda ctx: ctx.draw_indexed(vba, iba, {}))
        compiled = builder.build().compile(device, P.rhi.PipelineCache(),
                                           P.rg.CompileOptions(tile_h=8, tile_w=128))
        compiled.execute(device)
        return {"chain": compiled.value(tex)}

    port, ref = _both(build)
    m0, m1, m2 = port["chain"]
    assert (m0.shape, m1.shape, m2.shape) == ((128, 256, 4), (64, 128, 4), (32, 64, 4))
    assert m1[32, 64, 0] == pytest.approx(1.0)  # the triangle
    assert m1[2, 2, 2] == pytest.approx(1.0)  # the blue clear
    assert m0.max() == 0.0 and m2.max() == 0.0
    _assert_equal(port, ref)


def test_lambda_mip_read_write_roundtrip():
    def build(P):
        device = P.device()
        builder = P.rg.RenderGraphBuilder()
        tex = builder.create(P.rhi.TextureDesc("mips", 64, 64, P.rhi.Format.RGBA32F,
                                               mip_levels=2))
        builder.export(tex)
        node = builder.add_lambda_node("fill")
        w0, w1 = node.write(tex, mip=0), node.write(tex, mip=1)

        def record(ctx):
            ctx.set(w0, P.full((64, 64, 4), 0.25))
            ctx.set(w1, P.full((32, 32, 4), 0.5))

        node.execute(record)
        node2 = builder.add_lambda_node("check")
        r1 = node2.read(tex, mip=1)
        out = builder.create(P.rhi.TextureDesc.color("out", 32, 32))
        builder.export(out)
        dst = node2.write(out)
        node2.execute(lambda ctx: ctx.set(dst, ctx.get(r1) * 2.0))
        compiled = builder.build().compile(device, P.rhi.PipelineCache())
        compiled.execute(device)
        return {"out": compiled.value(out), "chain": compiled.value(tex)}

    port, ref = _both(build)
    assert port["out"][0, 0, 0] == pytest.approx(1.0)
    _assert_equal(port, ref)


# -- TestRenderToLayer --------------------------------------------------------


def test_cube_face_render_and_sample():
    def build(P):
        device = P.device()
        builder = P.rg.RenderGraphBuilder()
        cube = builder.create(P.rhi.TextureDesc.new_cube("cube", 64, P.rhi.Format.RGBA32F))
        builder.export(cube)
        node = builder.add_graphic_node("to_face")
        vba, iba = _triangle(P, device, builder, node)
        rt = node.write(cube, layer=2)  # face 2 is +Y
        with node.pipeline(_shaders(P), _state(P)) as binder:
            binder.push_color(rt, P.rhi.ColorAttachmentDesc(clear_value=(0, 1, 0, 1)))
        node.execute(lambda ctx: ctx.draw_indexed(vba, iba, {}))
        out = builder.create(P.rhi.TextureDesc.color("sample.out", 8, 8))
        builder.export(out)
        node2 = builder.add_lambda_node("sample")
        cube_in = node2.read(cube)
        dst = node2.write(out)
        dirs = np.broadcast_to(np.float32([0.0, 1.0, 0.0]), (8, 8, 3))
        node2.execute(lambda ctx: ctx.set(dst, P.sample_cube(ctx.get(cube_in), P.const(dirs))))
        compiled = builder.build().compile(device, P.rhi.PipelineCache(),
                                           P.rg.CompileOptions(tile_h=8, tile_w=128))
        compiled.execute(device)
        return {"cube": compiled.value(cube), "sampled": compiled.value(out)}

    port, ref = _both(build)
    cube = port["cube"]
    assert cube.shape == (6, 64, 64, 4)
    assert cube[2, 32, 32, 0] == pytest.approx(1.0)
    assert cube[0].max() == 0.0 and cube[5].max() == 0.0
    assert port["sampled"][4, 4, 0] == pytest.approx(1.0, abs=1e-3)
    _assert_equal(port, ref)


def test_layer_depth_attachment():
    def build(P):
        device = P.device()
        builder = P.rg.RenderGraphBuilder()
        cascades = builder.create(P.rhi.TextureDesc.new_2d_array("cascades", 128, 32, 2,
                                                                 P.rhi.Format.D32F))
        builder.export(cascades)
        node = builder.add_graphic_node("cascade1")
        vba, iba = _triangle(P, device, builder, node)
        ds = node.write(cascades, layer=1)
        with node.pipeline(_shaders(P, with_fs=False), _state(P)) as binder:
            binder.set_depth(ds, P.st.DepthStencilDesc(
                depth_test_enable=True, depth_write_enable=True,
                depth_compare_op=P.st.CompareOp.GREATER, depth_clear_value=0.0))
        node.execute(lambda ctx: ctx.draw_indexed(vba, iba, {}))
        compiled = builder.build().compile(device, P.rhi.PipelineCache(),
                                           P.rg.CompileOptions(tile_h=8, tile_w=128))
        compiled.execute(device)
        return {"layers": compiled.value(cascades)}

    port, ref = _both(build)
    val = port["layers"]
    assert val.shape == (2, 32, 128, 1)
    assert val[1].max() == pytest.approx(0.5)  # the triangle's depth
    assert val[0].max() == 0.0  # the untouched cascade
    _assert_equal(port, ref, atol=1e-6)


# -- TestBufferRange ----------------------------------------------------------


def test_lambda_buffer_range_read_write():
    def build(P):
        device = P.device()
        builder = P.rg.RenderGraphBuilder()
        buf = builder.create(P.rhi.BufferDesc("ranges", (16,), "float32"))
        builder.export(buf)
        node = builder.add_lambda_node("fill")
        head, tail = node.write(buf, brange=(0, 4)), node.write(buf, brange=(12, 4))

        def record(ctx):
            ctx.set(head, P.full((4,), 1.0))
            ctx.set(tail, P.full((4,), 2.0))

        node.execute(record)
        node2 = builder.add_lambda_node("read")
        mid = node2.read(buf, brange=(2, 12))
        out = builder.create(P.rhi.BufferDesc("out", (12,), "float32"))
        builder.export(out)
        dst = node2.write(out)
        node2.execute(lambda ctx: ctx.set(dst, ctx.get(mid)))
        compiled = builder.build().compile(device, P.rhi.PipelineCache())
        compiled.execute(device)
        return {"out": compiled.value(out)}

    port, ref = _both(build)
    val = port["out"]
    np.testing.assert_allclose(val[:2], [1.0, 1.0])
    np.testing.assert_allclose(val[2:10], 0.0)
    np.testing.assert_allclose(val[10:], [2.0, 2.0])
    _assert_equal(port, ref)


# -- TestBloomMipChain --------------------------------------------------------


def _bloom(P, hdr_np, post):
    device = P.device()
    h, w = hdr_np.shape[:2]
    builder = P.rg.RenderGraphBuilder()
    hdr = builder.create(P.rhi.TextureDesc.color("hdr", w, h))
    out = builder.create(P.rhi.TextureDesc.color("ldr", w, h))
    builder.export(out)
    node = builder.add_lambda_node("seed")
    dst = node.write(hdr)
    node.execute(lambda ctx: ctx.set(dst, P.const(hdr_np)))
    post.render_to(builder, hdr, out)
    compiled = builder.build().compile(device, P.rhi.PipelineCache())
    compiled.execute(device)
    return compiled.value(out)


def _assert_golden(a, b):
    ea = np.round(np.clip(a, 0.0, 1.0) * 255.0).astype(np.int16)
    eb = np.round(np.clip(b, 0.0, 1.0) * 255.0).astype(np.int16)
    d = np.abs(ea - eb)
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (int(d.max()), float((d > 0).mean()))


def test_bloom_via_mips_runs_and_matches_single_node_shape():
    h, w = 64, 128
    hdr_np = np.zeros((h, w, 4), np.float32)
    hdr_np[20:30, 40:60, :3] = 5.0  # a bright blob
    hdr_np[..., 3] = 1.0

    def build(P):
        return {"mips": _bloom(P, hdr_np, P.rr.PostProcess(bloom_mips=3)),
                "single": _bloom(P, hdr_np, P.rr.PostProcess())}

    port, ref = _both(build)
    mips, single = port["mips"], port["single"]
    assert mips.shape == single.shape == (h, w, 4)
    assert mips[25, 70, 0] > 0.0  # bloom spills right of the blob
    assert 0.0 <= mips.min() and mips.max() <= 1.0
    assert mips[25, 50, 0] > 0.9 and single[25, 50, 0] > 0.9
    for k in ("mips", "single"):
        _assert_golden(port[k], ref[k])
        np.testing.assert_allclose(port[k], ref[k], atol=1e-5)


def test_bloom_mips_odd_dimensions():
    """A 68-row chain reaches an odd level (68 → 34 → 17 → 8): the
    upsample-accumulate edge-pads."""
    h, w = 68, 136

    def build(P):
        return {"img": _bloom(P, np.full((h, w, 4), 3.0, np.float32),
                              P.rr.PostProcess(bloom_mips=3))}

    port, ref = _both(build)
    assert port["img"].shape == (h, w, 4) and np.isfinite(port["img"]).all()
    _assert_golden(port["img"], ref["img"])
    np.testing.assert_allclose(port["img"], ref["img"], atol=1e-5)


def test_mip_chain_structure_caches():
    def build(P):
        device = P.device()
        post = P.rr.PostProcess(bloom_mips=2)
        h, w = 32, 64

        def graph():
            builder = P.rg.RenderGraphBuilder()
            hdr = builder.create(P.rhi.TextureDesc.color("hdr", w, h))
            out = builder.create(P.rhi.TextureDesc.color("ldr", w, h))
            builder.export(out)
            node = builder.add_lambda_node("seed")
            dst = node.write(hdr)
            node.execute(lambda ctx: ctx.set(dst, P.full((h, w, 4), 1.0)))
            post.render_to(builder, hdr, out)
            return builder.build()

        pcache = P.rhi.PipelineCache()
        c1 = graph().compile(device, pcache)
        n = P.cache_size()
        c2 = graph().compile(device, pcache)
        assert P.cache_size() == n  # a structure hit
        assert c2._fn is c1._fn
        c2.execute(device)
        return {"nodes": np.array([nd.name == "post.down2" for nd in c2._graph.nodes])}

    port, ref = _both(build)
    assert port["nodes"].any()
    _assert_equal(port, ref)


# -- TestMipPlusLayer ---------------------------------------------------------


def test_layered_mip_chain_materializes():
    def build(P):
        device = P.device()
        builder = P.rg.RenderGraphBuilder()
        tex = builder.create(P.rhi.TextureDesc("lmips", 64, 32, P.rhi.Format.RGBA32F,
                                               mip_levels=3, array_layers=4))
        builder.export(tex)
        node = builder.add_lambda_node("touch")
        wr = node.write(tex, mip=0, layer=0)
        node.execute(lambda ctx: ctx.set(wr, P.full((32, 64, 4), 1.0)))
        compiled = builder.build().compile(device, P.rhi.PipelineCache())
        compiled.execute(device)
        return {"chain": compiled.value(tex)}

    port, ref = _both(build)
    assert [m.shape for m in port["chain"]] == [(4, 32, 64, 4), (4, 16, 32, 4), (4, 8, 16, 4)]
    _assert_equal(port, ref)


def test_3d_mip_chain_materializes():
    def build(P):
        device = P.device()
        builder = P.rg.RenderGraphBuilder()
        tex = builder.create(P.rhi.TextureDesc("vmips", 32, 16, P.rhi.Format.RGBA32F,
                                               mip_levels=2, depth=8))
        builder.export(tex)
        node = builder.add_lambda_node("fill")
        w1 = node.write(tex, mip=1)
        node.execute(lambda ctx: ctx.set(w1, P.full((4, 8, 16, 4), 0.5)))
        compiled = builder.build().compile(device, P.rhi.PipelineCache())
        compiled.execute(device)
        return {"chain": compiled.value(tex)}

    port, ref = _both(build)
    m0, m1 = port["chain"]
    assert m0.shape == (8, 16, 32, 4) and m0.max() == 0.0
    assert m1.shape == (4, 8, 16, 4) and m1.min() == pytest.approx(0.5)
    _assert_equal(port, ref)


def test_lambda_mip_layer_roundtrip():
    def build(P):
        device = P.device()
        builder = P.rg.RenderGraphBuilder()
        tex = builder.create(P.rhi.TextureDesc("ml", 32, 32, P.rhi.Format.RGBA32F,
                                               mip_levels=2, array_layers=3))
        builder.export(tex)
        node = builder.add_lambda_node("fill")
        wr = node.write(tex, mip=1, layer=2)
        node.execute(lambda ctx: ctx.set(wr, P.full((16, 16, 4), 2.0)))
        node2 = builder.add_lambda_node("read")
        r = node2.read(tex, mip=1, layer=2)
        out = builder.create(P.rhi.TextureDesc.color("out", 16, 16))
        builder.export(out)
        dst = node2.write(out)
        node2.execute(lambda ctx: ctx.set(dst, ctx.get(r) * 0.5))
        compiled = builder.build().compile(device, P.rhi.PipelineCache())
        compiled.execute(device)
        return {"chain": compiled.value(tex), "out": compiled.value(out)}

    port, ref = _both(build)
    m1 = port["chain"][1]
    assert m1[2].min() == pytest.approx(2.0)  # the written layer
    assert m1[0].max() == 0.0 and m1[1].max() == 0.0  # untouched layers
    assert port["chain"][0].max() == 0.0  # the untouched level
    assert port["out"][0, 0, 0] == pytest.approx(1.0)
    _assert_equal(port, ref)


def test_graphic_node_renders_into_mip_layer():
    def build(P):
        device = P.device()
        builder = P.rg.RenderGraphBuilder()
        tex = builder.create(P.rhi.TextureDesc("env", 256, 128, P.rhi.Format.RGBA32F,
                                               mip_levels=2, array_layers=2))
        builder.export(tex)
        node = builder.add_graphic_node("to_mip1_layer1")
        vba, iba = _triangle(P, device, builder, node)
        rt = node.write(tex, mip=1, layer=1)  # a 128x64 surface
        with node.pipeline(_shaders(P), _state(P)) as binder:
            binder.push_color(rt, P.rhi.ColorAttachmentDesc(clear_value=(0, 0, 1, 1)))
        node.execute(lambda ctx: ctx.draw_indexed(vba, iba, {}))
        compiled = builder.build().compile(device, P.rhi.PipelineCache(),
                                           P.rg.CompileOptions(tile_h=8, tile_w=128))
        compiled.execute(device)
        return {"chain": compiled.value(tex)}

    port, ref = _both(build)
    m0, m1 = port["chain"]
    assert m0.shape == (2, 128, 256, 4) and m0.max() == 0.0
    assert m1.shape == (2, 64, 128, 4)
    assert m1[0].max() == 0.0  # the untouched layer of the same level
    assert m1[1, 32, 64, 0] == pytest.approx(1.0)
    assert m1[1, 2, 2, 2] == pytest.approx(1.0)
    _assert_equal(port, ref)


# -- the port's own aliasing and LOAD rules -----------------------------------


def _layered_graph(P, load_second: bool):
    """Layer 0 of a 3-layer colour array cleared red by a graphic node, layer
    1 drawn (cleared or LOADed), and an export of the whole array."""
    device = P.device()
    builder = P.rg.RenderGraphBuilder()
    arr = builder.create(P.rhi.TextureDesc.new_2d_array("arr", 128, 32, 3,
                                                        P.rhi.Format.RGBA32F))
    builder.export(arr)
    seed = builder.add_lambda_node("seed")
    sw = seed.write(arr)
    seed.execute(lambda ctx: ctx.set(sw, P.full((3, 32, 128, 4), 0.25)))
    node = builder.add_graphic_node("layer0")
    w0 = node.write(arr, layer=0)
    with node.pipeline(_shaders(P), _state(P)) as binder:
        binder.push_color(w0, P.rhi.ColorAttachmentDesc(clear_value=(1, 0, 0, 1)))
    node.execute(lambda ctx: None)
    node = builder.add_graphic_node("layer1")
    vba, iba = _triangle(P, device, builder, node)
    node.read(arr)
    w1 = node.write(arr, layer=1)
    load = P.rhi.LoadOp.LOAD if load_second else P.rhi.LoadOp.CLEAR
    with node.pipeline(_shaders(P), _state(P)) as binder:
        binder.push_color(w1, P.rhi.ColorAttachmentDesc(clear_value=(0, 0, 1, 1),
                                                        load_op=load))
    node.execute(lambda ctx: ctx.draw_indexed(vba, iba, {}))
    compiled = builder.build().compile(device, P.rhi.PipelineCache(),
                                       P.rg.CompileOptions(tile_h=8, tile_w=128))
    compiled.execute(device)
    return compiled, arr


@pytest.mark.parametrize("load_second", [False, True], ids=["clear", "load"])
def test_a_layer_clear_or_load_leaves_the_other_layers(load_second):
    def build(P):
        compiled, arr = _layered_graph(P, load_second)
        return {"arr": compiled.value(arr)}

    port, ref = _both(build)
    val = port["arr"]
    np.testing.assert_array_equal(val[0], np.broadcast_to(np.float32([1, 0, 0, 1]), (32, 128, 4)))
    np.testing.assert_array_equal(val[2], 0.25)  # never attached
    corner = [0.25] * 4 if load_second else [0.0, 0.0, 1.0, 1.0]
    np.testing.assert_array_equal(val[1, 1, 1], corner)  # LOADed or cleared
    assert val[1, 16, 64, 0] == 1.0  # the triangle
    _assert_equal(port, ref)


def test_an_export_held_across_a_retained_frame_is_unchanged():
    """Layer writes splice into a new tensor: the export of frame 1, held
    by the caller, keeps its values while frame 2 re-runs the same frame
    function."""
    compiled, arr = _layered_graph(_port(), True)
    held = compiled.value(arr)
    copy = held.clone()
    compiled.execute()
    again = compiled.value(arr)
    assert again is not held and again.data_ptr() != held.data_ptr()
    torch.testing.assert_close(held, copy, rtol=0, atol=0)
    torch.testing.assert_close(again, copy, rtol=0, atol=0)
