"""The port's SPMD runtime and sort-first parallel rendering
(zenith_tpu_torch/parallel, rendergraph CompileOptions(mesh=)) against the
reference package on the same numpy-seeded inputs: the light cases of
tests/test_parallel.py (the row-sharded step, the banded bloom, the post
node through the graph, the binary-swap compositor) and the runtime's
collectives. The heavy graph frames of test_parallel.py are
test_torch_parallel_frames.py's.

The port runs on ``default_mesh(8, device="cpu")`` (8 shards, one thread
each, on the CPU) and the reference on ``default_mesh(8, backend="cpu")``
(the 8 virtual CPU devices of tests/conftest.py). Each case holds the
port's banded result against the port's single-device one at the
reference's own tolerance, and against the JAX 8-device result.

Tolerances: the collectives exact (they move and add values in rank
order, psum of integer-valued floats); the binary swap bit-equal to the
all_gather compositor and to JAX's (it only selects values); the banded
bloom and the post node bit-equal to single-device as the reference
asserts (atol 1e-6: the halo wraps as the rolls do) and atol 1e-6 to JAX's
(the same float32 ops; XLA's FMA contraction moves nothing here at 1e-6);
the row-sharded triangles: the reference's oracle tolerances (depth atol
1e-4, colour 2e-3) and JAX's bands at atol 1e-5 (depth) and 1e-5
(colour), the interpolation rounded apart from XLA's contracted one.
"""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_reference import render_reference
from zenith_tpu_torch.parallel import default_mesh, make_row_sharded_frame, spmd
from zenith_tpu_torch.parallel.spmd import P
from zenith_tpu_torch.rhi import (
    ColorAttachmentDesc,
    CullMode,
    Format,
    GraphicPipelineAttachments,
    GraphicPipelineDesc,
    GraphicShaderInput,
    PipelineCache,
    RasterizationState,
    RhiCore,
    Shader,
    VertexLayout,
)
from zenith_tpu_torch.rhi.state import DepthStencilDesc, GraphicPipelineState

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 64  # 8 shards x 8-row bands


def _vs(attrs, res):
    p = attrs["position"]
    return {"position": torch.cat([p, torch.ones_like(p[:, :1])], 1), "color": attrs["color"]}


def _fs(varyings, res, builtins):
    c = varyings["color"]
    return torch.cat([c, torch.ones_like(c[..., :1])], -1)


def make_pipeline(depth=True):
    """tests/test_parallel.py::make_pipeline on the port."""
    layout = VertexLayout.from_fields(("position", 3), ("color", 3))
    state = GraphicPipelineState(
        rasterization=RasterizationState(cull_mode=CullMode.NONE),
        depth_stencil=DepthStencilDesc().reverse_z() if depth else DepthStencilDesc(),
    )
    desc = GraphicPipelineDesc(
        shader_input=GraphicShaderInput(Shader.vertex("p.vs", _vs), Shader.fragment("p.fs", _fs),
                                        layout),
        state=state,
        attachments=GraphicPipelineAttachments(
            color_formats=(Format.RGBA32F,), depth_format=Format.D32F if depth else None),
        color_attachment_descs=(ColorAttachmentDesc(),),
    )
    return PipelineCache().get_or_create(desc)


def _jax_mesh(n=8):
    from zenith_tpu.parallel import default_mesh as ref_mesh

    return ref_mesh(n, backend="cpu")


# -- the runtime ---------------------------------------------------------------------


def _jax_collective(fn, x):
    from jax.sharding import PartitionSpec as JP

    return np.asarray(jax.jit(jax.shard_map(fn, mesh=_jax_mesh(), in_specs=JP("rows"),
                                            out_specs=JP("rows"), check_vma=False))(x))


def _port_collective(fn, x):
    return spmd.shard_map(fn, default_mesh(8, device="cpu"), in_specs=P("rows"),
                          out_specs=P("rows"))(torch.from_numpy(x)).full().numpy()


COLLECTIVES = {
    "ppermute": (lambda x, a: jax.lax.ppermute(x, a, [(i, (i + 3) % 8) for i in range(8)]),
                 lambda x, a: spmd.ppermute(x, a, [(i, (i + 3) % 8) for i in range(8)])),
    "ppermute_partial": (lambda x, a: jax.lax.ppermute(x, a, [(0, 5), (5, 2)]),
                         lambda x, a: spmd.ppermute(x, a, [(0, 5), (5, 2)])),
    "all_gather_tiled": (lambda x, a: jax.lax.all_gather(x, a, axis=0, tiled=True)[None],
                         lambda x, a: spmd.all_gather(x, a, axis=0, tiled=True)[None]),
    "all_gather_stacked": (lambda x, a: jax.lax.all_gather(x, a, axis=1),
                           lambda x, a: spmd.all_gather(x, a, axis=1)),
    "psum": (lambda x, a: jax.lax.psum(x, a), lambda x, a: spmd.psum(x, a)),
    "pmean": (lambda x, a: jax.lax.pmean(x, a), lambda x, a: spmd.pmean(x, a)),
    "axis_index": (lambda x, a: x + jax.lax.axis_index(a) * jax.lax.axis_size(a),
                   lambda x, a: x + spmd.axis_index(a) * spmd.axis_size(a)),
}


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collectives_equal_jax_lax(cpu_devices, name):
    """Each collective over 8 shards equals jax.lax's over the 8 CPU
    devices (integer-valued floats, so every sum is exact)."""
    jfn, tfn = COLLECTIVES[name]
    x = np.random.default_rng(5).integers(-50, 50, (8, 3, 4)).astype(np.float32)
    want = _jax_collective(lambda v: jfn(v, "rows"), jnp.asarray(x))
    got = _port_collective(lambda v: tfn(v, "rows"), x)
    np.testing.assert_array_equal(got, want)


def test_a_raising_shard_ends_shard_map_without_a_hang():
    """Shard 3 raises before the first collective, the others wait in it:
    shard_map re-raises shard 3's exception within seconds (the barrier
    is aborted, not timed out), and the next call on the same workers runs;
    the workers persist, one thread a shard, and a nested call raises."""
    def body(x):
        if spmd.axis_index("rows") == 3:
            raise ZeroDivisionError("shard 3 failed")
        return spmd.psum(x, "rows")

    mesh = default_mesh(8, device="cpu")
    run = spmd.shard_map(body, mesh, in_specs=P("rows"), out_specs=P())
    t0 = time.perf_counter()
    with pytest.raises(ZeroDivisionError, match="shard 3 failed"):
        run(torch.zeros(8, 2))
    assert time.perf_counter() - t0 < 5.0
    ok = spmd.shard_map(lambda x: spmd.psum(x, "rows"), mesh, in_specs=P("rows"), out_specs=P())
    assert torch.equal(ok(torch.ones(8, 2)), torch.full((1, 2), 8.0))
    workers = [t for t in threading.enumerate() if t.name.startswith("zenith-shard-")]
    assert len(workers) >= 8 and all(t.daemon for t in workers)
    nested = spmd.shard_map(lambda x: ok(x), mesh, in_specs=P("rows"), out_specs=P())
    with pytest.raises(RuntimeError, match="inside shard_map"):
        nested(torch.ones(8, 2))


def test_blend_builds_of_different_shaders_run_in_parallel(monkeypatch):
    """load_blend_kernel holds a lock per (shader, layout), not one for the
    process: two threads asking for different shaders build at once, two
    asking for the same one build it once, one after the other."""
    from zenith_tpu_torch.ops import runtime

    active, most, builds = [0], [0], []
    lock = threading.Lock()

    def fake_build(source, layout):
        if (source, tuple(layout)) in runtime._blend_libs:  # as _load_blend_kernel checks
            return source
        with lock:
            active[0] += 1
            most[0] = max(most[0], active[0])
        time.sleep(0.2)
        with lock:
            active[0] -= 1
            builds.append(source)
        runtime._blend_libs[(source, tuple(layout))] = source
        return source

    monkeypatch.setattr(runtime, "_load_blend_kernel", fake_build)
    monkeypatch.setattr(runtime, "_blend_libs", {})

    def race(sources):
        threads = [threading.Thread(target=runtime.load_blend_kernel, args=(s, [("c", 3)]))
                   for s in sources]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    race(["shader a", "shader b"])
    assert most[0] == 2 and sorted(builds) == ["shader a", "shader b"]
    most[0] = 0
    builds.clear()
    monkeypatch.setattr(runtime, "_blend_libs", {})
    race(["shader c", "shader c"])
    assert most[0] == 1 and builds == ["shader c"]


def test_default_mesh_needs_the_cuda_devices_it_names(monkeypatch):
    """No silent fallback: default_mesh(n) takes n CUDA devices or raises;
    device= puts n shards on one device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        default_mesh(2)
    mesh = default_mesh(4, device="cpu")
    assert mesh.shape["rows"] == 4 and mesh.devices == (CPU,) * 4
    same = default_mesh(4, device="cpu")
    assert mesh == same and hash(mesh) == hash(same)
    from zenith_tpu.parallel import __all__ as ref_all
    from zenith_tpu_torch.parallel import __all__ as port_all

    assert port_all == ref_all


def test_graph_modes_and_mesh_limits_raise():
    """parallel="sort_last"/"auto" compile and run on the mesh and report
    each node's mode (a depth-writing GREATER node takes sort-last when
    asked, a colour-only one stays banded); an unknown mode, an attachment
    height that does not tile the mesh (banded: mesh size x tile_h;
    sort-last: mesh size) and a render-to-mip target under a mesh raise
    ValueError."""
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.rhi import TextureDesc

    device = RhiCore(CPU).create_render_device()
    mesh = default_mesh(8, device="cpu")

    def graph(h, mip_levels=1, mip=0, depth=False):
        pipe = make_pipeline(depth=depth)
        b = RenderGraphBuilder()
        desc = TextureDesc.color("rt", W, h)
        if mip_levels > 1:
            desc = TextureDesc("rt", W, h, desc.format, mip_levels=mip_levels)
        rt = b.create(desc)
        b.export(rt)
        node = b.add_graphic_node("n")
        w_ = node.write(rt, mip=mip) if mip else node.write(rt)
        ds = node.write(b.create(TextureDesc.depth("ds", W, h))) if depth else None
        with node.pipeline(pipe.desc.shader_input, pipe.desc.state) as binder:
            binder.push_color(w_, ColorAttachmentDesc())
            if depth:
                binder.set_depth(ds, pipe.desc.state.depth_stencil)
        node.execute(lambda ctx: None)
        return b.build(), rt

    for mode, modes in (("sort_last", {"n": "sort_last"}), ("auto", {"n": "sort_first"})):
        for depth in (False, True):
            g, rt = graph(H, depth=depth)
            c = g.compile(device, PipelineCache(), CompileOptions(tile_h=8, mesh=mesh,
                                                                  parallel=mode))
            c.execute(device)
            assert g.parallel_modes == (modes if depth else {"n": "sort_first"})
            assert c.value(rt).shape == (H, W, 4)
    with pytest.raises(ValueError, match="expected one of"):
        graph(H)[0].compile(device, PipelineCache(), CompileOptions(mesh=mesh, parallel="rows"))
    with pytest.raises(ValueError, match="must divide by mesh size 8 x tile_h 8"):
        c = graph(72)[0].compile(device, PipelineCache(), CompileOptions(tile_h=8, mesh=mesh))
        c.execute(device)
    with pytest.raises(ValueError, match="must divide by mesh size 8 for the sort-last"):
        c = graph(60, depth=True)[0].compile(device, PipelineCache(),
                                          CompileOptions(tile_h=8, mesh=mesh,
                                                         parallel="sort_last"))
        c.execute(device)
    with pytest.raises(ValueError, match="render-to-mip"):
        c = graph(128, mip_levels=2, mip=1)[0].compile(device, PipelineCache(),
                                                    CompileOptions(tile_h=8, mesh=mesh))
        c.execute(device)


# -- tests/test_parallel.py: TestRowSharded -------------------------------------------


def _scene(rng):
    nv = 30
    pos = rng.uniform(-1.1, 1.1, size=(nv, 2))
    zz = rng.uniform(0.1, 0.9, size=(nv, 1))
    colors = rng.uniform(0, 1, size=(nv, 3))
    vb = np.concatenate([pos, zz, colors], axis=1).astype(np.float32)
    ib = rng.integers(0, nv, size=(14, 3)).astype(np.int32)
    return vb, ib


def test_eight_device_band_render_matches_oracle(cpu_devices, rng):
    from test_parallel import make_pipeline as ref_pipeline

    from zenith_tpu.parallel import make_row_sharded_frame as ref_step

    vb, ib = _scene(rng)
    step = make_row_sharded_frame(default_mesh(8, device="cpu"), make_pipeline(depth=True), W, H,
                                  clear_color=(0, 0, 0, 1), tile_h=8, bin_capacity=32)
    color_s, depth_s = step(torch.from_numpy(vb), torch.from_numpy(ib), {})
    color, depth = color_s.full().numpy(), depth_s.full().numpy()
    assert color.shape == (H, W, 4)

    # Oracle: single-device reference rasterization of the same scene.
    nv = vb.shape[0]
    clip = np.concatenate([vb[:, :2], vb[:, 2:3], np.ones((nv, 1), np.float32)], axis=1)
    ref = render_reference(clip, ib, W, H, cull="none", varyings={"c": vb[:, 3:6]})
    covered = ref["tri"] >= 0
    np.testing.assert_allclose(depth, ref["z"], atol=1e-4)
    np.testing.assert_allclose(color[covered][:, :3], ref["c"][covered], atol=2e-3)
    np.testing.assert_allclose(color[~covered][:, :3], 0.0, atol=1e-6)

    # The JAX 8-device step on the same inputs.
    jstep = ref_step(_jax_mesh(), ref_pipeline(depth=True), W, H, clear_color=(0, 0, 0, 1),
                     tile_h=8, bin_capacity=32, interpret=True)
    jc, jd = jstep(jnp.asarray(vb), jnp.asarray(ib), {})
    np.testing.assert_allclose(depth, np.asarray(jd), atol=1e-5)
    np.testing.assert_allclose(color, np.asarray(jc), atol=1e-5)


def test_output_is_sharded_across_devices(cpu_devices):
    step = make_row_sharded_frame(default_mesh(8, device="cpu"), make_pipeline(depth=False),
                                  W, H, use_depth=False, tile_h=8)
    vb = np.array([[0.0, -0.9, 0.5, 1, 0, 0], [0.9, 0.9, 0.5, 0, 1, 0],
                   [-0.9, 0.9, 0.5, 0, 0, 1]], np.float32)
    ib = np.array([[0, 1, 2]], np.int32)
    color, _ = step(torch.from_numpy(vb), torch.from_numpy(ib), {})
    # The result lives as 8 row bands, one a shard (here all on the CPU).
    assert len(color.shards) == 8
    assert all(s.shape == (H // 8, W, 4) for s in color.shards)
    full = color.full().numpy()
    # The triangle spans several bands contiguously (no band seams):
    # the centre column is covered from near-top to near-bottom.
    covered = full[..., :3].sum(-1) > 0
    rows = np.where(covered[:, W // 2])[0]
    assert rows.max() - rows.min() + 1 == len(rows)
    assert len(rows) > H // 2

    from test_parallel import make_pipeline as ref_pipeline

    from zenith_tpu.parallel import make_row_sharded_frame as ref_step

    jstep = ref_step(_jax_mesh(), ref_pipeline(depth=False), W, H, use_depth=False, tile_h=8,
                     interpret=True)
    jc, _ = jstep(jnp.asarray(vb), jnp.asarray(ib), {})
    assert len(jc.sharding.device_set) == 8
    np.testing.assert_allclose(full, np.asarray(jc), atol=1e-5)


# -- TestBandedPost -------------------------------------------------------------------------


def test_banded_bloom_matches_single(cpu_devices, rng):
    from jax.sharding import PartitionSpec as JP

    from zenith_tpu.renderer.post import tone_and_bloom_banded as ref_banded
    from zenith_tpu_torch.renderer.post import tone_and_bloom, tone_and_bloom_banded

    h2, w2 = 256, 128  # 8 shards x 32-row bands (>= BLOOM_HALO)
    hdr = rng.uniform(0.0, 1.0, size=(h2, w2, 4)).astype(np.float32)
    hdr[..., :3] *= 4.0  # HDR range so the bright pass fires
    single = tone_and_bloom(torch.from_numpy(hdr)).numpy()
    out = spmd.shard_map(lambda x: tone_and_bloom_banded(x, "rows"),
                         default_mesh(8, device="cpu"), in_specs=P("rows"),
                         out_specs=P("rows"))(torch.from_numpy(hdr))
    assert len(out.shards) == 8
    got = out.full().numpy()
    np.testing.assert_allclose(got, single, atol=1e-6)
    want = jax.jit(jax.shard_map(lambda x: ref_banded(x, "rows"), mesh=_jax_mesh(),
                                 in_specs=JP("rows"), out_specs=JP("rows")))(jnp.asarray(hdr))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def _post_node_frame(pkg, mesh):
    """test_post_node_sharded_through_engine's graph in ``pkg``: a
    band-local generator node writes the HDR attachment from global rows,
    the post node runs banded (halo exchange) under a mesh."""
    import importlib

    rg = importlib.import_module(f"{pkg}.rendergraph")
    rhi = importlib.import_module(f"{pkg}.rhi")
    post = importlib.import_module(f"{pkg}.renderer").PostProcess()
    jax_side = pkg == "zenith_tpu"
    if jax_side:
        from zenith_tpu.rendergraph.graph import clear_frame_program_cache

        clear_frame_program_cache()
        device = rhi.RhiCore().create_render_device()
    else:
        device = rhi.RhiCore(CPU).create_render_device()
    h2, w2 = 256, 128
    builder = rg.RenderGraphBuilder()
    hdr = builder.create(rhi.TextureDesc.color("hdr", w2, h2))
    out = builder.create(rhi.TextureDesc.color("post.out", w2, h2))
    builder.export(out)
    gen = builder.add_lambda_node("gen")
    hdr_w = gen.write(hdr)

    def record_gen(ctx):
        # Band-local procedural HDR from GLOBAL rows/cols.
        bh = h2 // ctx.num_shards
        if jax_side:
            xp, row0 = jnp, 0
            if ctx.sharded:
                row0 = jax.lax.axis_index(ctx.shard_axis) * bh
            rows = row0 + jnp.arange(bh, dtype=jnp.float32)[:, None]
            cols = jnp.arange(w2, dtype=jnp.float32)[None, :]
        else:
            xp, row0 = torch, 0
            if ctx.sharded:
                row0 = spmd.axis_index(ctx.shard_axis) * bh
            rows = row0 + torch.arange(bh, dtype=torch.float32)[:, None]
            cols = torch.arange(w2, dtype=torch.float32)[None, :]
        base = 0.4 + 2.5 * xp.exp(-((rows - 97.0) ** 2 + (cols - 41.0) ** 2) / 400.0)
        ctx.set(hdr_w, xp.stack([base, base * 0.5, 3.0 - base, xp.ones_like(base)], -1))

    gen.execute(record_gen)
    post.render_to(builder, hdr, out)
    compiled = builder.build().compile(device, rhi.PipelineCache(),
                                       rg.CompileOptions(tile_h=8, tile_w=128, mesh=mesh))
    compiled.execute(device)
    return np.asarray(compiled.value(out))


def test_post_node_sharded_through_engine(cpu_devices):
    """Full graph path: the band-local generator node, the post node's
    halo-exchange path under CompileOptions(mesh), equal to single-device
    and to the JAX 8-device frame."""
    img1 = _post_node_frame("zenith_tpu_torch", None)
    img8 = _post_node_frame("zenith_tpu_torch", default_mesh(8, device="cpu"))
    assert img1[..., :3].std() > 0.01  # bloom actually did something
    np.testing.assert_allclose(img8, img1, atol=1e-6)
    np.testing.assert_allclose(img8, _post_node_frame("zenith_tpu", _jax_mesh()), atol=1e-6)


# -- TestBinarySwapCompositor -------------------------------------------------------------------


def _composite(fn, z_np, c_np, port=True):
    n = z_np.shape[0]

    def body(z, c):
        return fn(c[0], z[0], "rows")  # each shard gets its own (1, h, w) plane

    if port:
        run = spmd.shard_map(body, default_mesh(n, device="cpu"), in_specs=(P("rows"), P("rows")),
                             out_specs=(P(), P()))
        c, z = run(torch.from_numpy(z_np), torch.from_numpy(c_np))
        return c.numpy(), z.numpy()
    from jax.sharding import PartitionSpec as JP

    c, z = jax.jit(jax.shard_map(body, mesh=_jax_mesh(n), in_specs=(JP("rows"), JP("rows")),
                                 out_specs=(JP(), JP()), check_vma=False))(
        jnp.asarray(z_np), jnp.asarray(c_np))
    return np.asarray(c), np.asarray(z)


@pytest.mark.parametrize("n, h, w", [(8, 32, 64), (3, 30, 16)], ids=["ties", "non_power_of_two"])
def test_binary_swap_bit_equal_to_all_gather(cpu_devices, rng, n, h, w):
    """composite_depth (binary swap) is bit-equal to the all_gather
    compositor, equal-z ties resolving to the lowest rank (quantized
    depths force them); a non-power-of-two mesh takes the all_gather
    path. Both equal the reference's compositors on the same planes."""
    from zenith_tpu.parallel import sharding as ref_sharding
    from zenith_tpu_torch.parallel.sharding import composite_depth, composite_depth_all_gather

    z_np = rng.uniform(0.0, 1.0, size=(n, h, w)).astype(np.float32)
    if n == 8:
        z_np = np.round(z_np * 4) / 4.0  # quantized: plenty of exact ties
    c_np = rng.uniform(0, 1, size=(n, h, w, 4)).astype(np.float32)
    c_ref, z_ref = _composite(composite_depth_all_gather, z_np, c_np)
    c_bs, z_bs = _composite(composite_depth, z_np, c_np)
    np.testing.assert_array_equal(z_bs, z_ref)
    np.testing.assert_array_equal(c_bs, c_ref)
    jc, jz = _composite(ref_sharding.composite_depth, z_np, c_np, port=False)
    np.testing.assert_array_equal(z_bs, jz)
    np.testing.assert_array_equal(c_bs, jc)
    if n == 8:
        zmax = z_np.max(axis=0)
        assert ((z_np == zmax[None]).sum(axis=0) > 1).any()  # ties occurred


@pytest.mark.parametrize("band_output", [False, True])
@pytest.mark.parametrize("n", [8, 3])
def test_composite_depth_planes_equals_the_reference(cpu_devices, rng, n, band_output):
    """composite_depth_planes (z, then submission order, then rank) on
    quantized depths and orders equals the reference's, per shard."""
    from jax.sharding import PartitionSpec as JP

    from zenith_tpu.parallel.sharding import composite_depth_planes as ref_planes
    from zenith_tpu_torch.parallel import composite_depth_planes

    h, w = (32, 16) if n == 8 else (30, 16)
    z_np = (np.round(rng.uniform(0, 1, (n, h, w)) * 3) / 3).astype(np.float32)
    o_np = rng.integers(0, 3, (n, h, w)).astype(np.int32)
    c_np = rng.uniform(0, 1, (n, h, w, 4)).astype(np.float32)

    def body(xp_planes):
        def f(z, o, c):
            ps, zz, oo = xp_planes([c[0]], z[0], o[0], "rows", band_output=band_output)
            return ps[0][None], zz[None], oo[None]
        return f

    got = spmd.shard_map(body(composite_depth_planes), default_mesh(n, device="cpu"),
                         in_specs=(P("rows"),) * 3, out_specs=(P("rows"),) * 3)(
        *(torch.from_numpy(a) for a in (z_np, o_np, c_np)))
    want = jax.jit(jax.shard_map(body(ref_planes), mesh=_jax_mesh(n), in_specs=(JP("rows"),) * 3,
                                 out_specs=(JP("rows"),) * 3, check_vma=False))(
        *(jnp.asarray(a) for a in (z_np, o_np, c_np)))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.full().numpy(), np.asarray(wnt))


def test_halo_exchange_rows_equals_a_roll(rng):
    """halo_exchange_rows extends each band by its neighbours' rows,
    wrapping at the ends: band r's extension is rows of torch.roll of the
    whole surface."""
    from zenith_tpu_torch.parallel import halo_exchange_rows

    full = torch.from_numpy(rng.uniform(0, 1, (64, 8, 3)).astype(np.float32))
    ext = spmd.shard_map(lambda b: halo_exchange_rows(b, "rows", 3),
                         default_mesh(8, device="cpu"), in_specs=P("rows"), out_specs=None)(full)
    for r, band in enumerate(ext):
        want = torch.roll(full, 3 - 8 * r, dims=0)[:14]
        assert torch.equal(band, want)
