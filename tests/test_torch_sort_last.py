"""tests/test_sort_last.py on the port: CompileOptions(parallel="sort_last")
shards the triangles of the eligible graphic nodes over
``default_mesh(8, device="cpu")``, each shard rasterizes its slice at full
resolution, and the binary-swap depth composite lands the result in the
row-band layout the downstream nodes read.

Every case draws the same numpy-seeded geometry in both packages and holds
the port's sort-last frame against

- the port's single-device frame, at the reference's tolerance: colour at
  most 0.2% of pixels off by > 1e-3, depth 1e-5 at the same share, and
  ``assert_allclose(atol=1e-6)`` where the reference uses it (the equal-z
  ties, the MSAA chain);
- the JAX package's single-device frame at the same tolerance, and, in
  ``test_matches_single_device`` and ``test_equal_z_ties_resolve_in_draw_order``
  (where cross-shard order is under test), its sort-last frame over the
  reference's 8 virtual CPU devices.

The geometry reaches both graphs as imported buffers, so a JAX frame of
the same structure and shapes reuses its compiled program (the reference's
own cases clear the cache because they capture it in closures). Three
cases beyond the reference's run on the port alone: the two equal-z draws
on different shards, where only the submission-order plane can pick the
first draw (the frame is known: all red); each shard's triangle slice; and
a node that draws nothing, or only padding, reaching the composite.

The harness here (``ns_of``, ``frame``, ``single_node``, ``tri_vb``,
``assert_images_match``) is shared with test_torch_parallel_auto.py.
"""

from __future__ import annotations

import importlib
from dataclasses import replace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")
PORT, REF = "zenith_tpu_torch", "zenith_tpu"
W, H = 128, 64  # 8 shards x 8-row bands


# -- the harness ------------------------------------------------------------------------


class _Ns:
    """A package's rhi, state and rendergraph modules and its shaders (one
    set per package: the reference keys frame programs by shader identity)."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        self.is_ref = pkg == REF
        self.rhi = importlib.import_module(f"{pkg}.rhi")
        self.st = importlib.import_module(f"{pkg}.rhi.state")
        self.rg = importlib.import_module(f"{pkg}.rendergraph")
        self.layout = self.rhi.VertexLayout.from_fields(("position", 3), ("color", 3))
        if self.is_ref:
            import jax.numpy as jnp

            cat = jnp.concatenate

            def ones(p):
                return jnp.ones((p.shape[0], 1), jnp.float32)

            def rgba(c, a):
                return cat([c, jnp.full_like(c[..., :1], a)], -1)

            def const(v, b):
                return jnp.broadcast_to(jnp.asarray(v), b.depth.shape + (4,))
        else:
            cat = torch.cat

            def ones(p):
                return torch.ones((p.shape[0], 1), dtype=torch.float32, device=p.device)

            def rgba(c, a):
                return cat([c, torch.full_like(c[..., :1], a)], -1)

            def const(v, b):
                return torch.tensor(v, dtype=torch.float32, device=b.depth.device).expand(
                    tuple(b.depth.shape) + (4,))

        def vs(attrs, res):
            p = attrs["position"]
            return {"position": cat([p, ones(p)], 1), "color": attrs["color"]}

        def vs_inst(attrs, res):
            p = attrs["position"] + attrs["offset"]
            return {"position": cat([p, ones(p)], 1), "color": attrs["color"]}

        shader = self.rhi.Shader
        self.vs = shader.vertex("sl.vs", vs)
        self.fs = shader.fragment("sl.fs", lambda v, r, b: rgba(v["color"], 1.0))
        self.vs_inst = shader.vertex("sl.inst.vs", vs_inst)
        self.fs_glass = shader.fragment("sl.glass.fs", lambda v, r, b: rgba(v["color"], 0.5))
        self.vs_msaa = shader.vertex("slm.vs", lambda attrs, res: {"position": attrs["position"]})
        self.fs_msaa = shader.fragment("slm.fs", lambda v, r, b: const((1.0, 0.5, 0.25, 1.0), b))

    def buffer(self, name, arr):
        kw = {} if self.is_ref else {"device": CPU}
        return self.rhi.Buffer.from_numpy(name, np.ascontiguousarray(arr), **kw)

    def opaque_state(self, samples: int = 1):
        rhi = self.rhi
        kw = {"multisample": rhi.MultisampleState(samples=samples)} if samples > 1 else {}
        return self.st.GraphicPipelineState(
            rasterization=rhi.RasterizationState(cull_mode=rhi.CullMode.NONE),
            depth_stencil=self.st.DepthStencilDesc().reverse_z(), **kw)

    def add_opaque(self, builder, name, color, depth, record, vs=None, clear=True,
                   samples: int = 1):
        """One opaque node over ``color``/``depth`` (reverse-Z, GREATER),
        cleared or LOADed; returns the node builder."""
        rhi, st = self.rhi, self.st
        node = builder.add_graphic_node(name)
        rt, ds = node.write(color), node.write(depth)
        layout = self.layout if samples == 1 else rhi.VertexLayout.from_fields(("position", 4))
        si = rhi.GraphicShaderInput(vs or (self.vs if samples == 1 else self.vs_msaa),
                                    self.fs if samples == 1 else self.fs_msaa, layout)
        with node.pipeline(si, self.opaque_state(samples)) as binder:
            if clear:
                binder.push_color(rt, rhi.ColorAttachmentDesc(clear_value=(0, 0, 0, 1)))
                binder.set_depth(ds, st.DepthStencilDesc().reverse_z())
            else:
                binder.push_color(rt, rhi.ColorAttachmentDesc(load_op=st.LoadOp.LOAD))
                binder.set_depth(ds, replace(st.DepthStencilDesc().reverse_z(),
                                             depth_load_op=st.LoadOp.LOAD))
        node.execute(record)
        return node


_NS: dict = {}


def ns_of(pkg: str) -> _Ns:
    if pkg not in _NS:
        _NS[pkg] = _Ns(pkg)
    return _NS[pkg]


def frame(pkg: str, build, mesh_n=None, parallel: str = "sort_first"):
    """Run one frame of the graph ``build(ns, builder)`` declares (it
    returns the handles to read) in ``pkg``: single-device, or over an
    ``mesh_n``-shard CPU mesh with ``parallel``. Returns (arrays, graph)."""
    ns = ns_of(pkg)
    if ns.is_ref:
        from zenith_tpu.parallel import default_mesh as ref_mesh

        device = ns.rhi.RhiCore().create_render_device()
        mesh = ref_mesh(mesh_n, backend="cpu") if mesh_n else None
    else:
        from zenith_tpu_torch.parallel import default_mesh
        from zenith_tpu_torch.rendergraph.graph import clear_frame_program_cache

        clear_frame_program_cache()
        device = ns.rhi.RhiCore(CPU).create_render_device()
        mesh = default_mesh(mesh_n, device="cpu") if mesh_n else None
    builder = ns.rg.RenderGraphBuilder()
    outs = build(ns, builder)
    for o in outs:
        builder.export(o)
    graph = builder.build()
    options = ns.rg.CompileOptions(tile_h=8, tile_w=128, mesh=mesh, parallel=parallel)
    compiled = graph.compile(device, ns.rhi.PipelineCache(), options)
    compiled.execute(device)
    return [np.asarray(compiled.value(o)) for o in outs], graph


def single_node(draws, hint=None, batch: bool = False, inst=None):
    """The reference's one-node graph (``_render_graph``): a colour and a
    depth target, one opaque node drawing each (vb, ib) of ``draws`` in
    order (as one batched draw with ``batch``; instanced with ``inst`` =
    per-instance offsets), optionally band-hinted. Exports (colour, depth)."""

    def build(ns, builder):
        color = builder.create(ns.rhi.TextureDesc.color("rt", W, H))
        depth = builder.create(ns.rhi.TextureDesc.depth("ds", W, H))
        bufs = [(builder.import_resource(ns.buffer(f"vb{i}", vb)),
                 builder.import_resource(ns.buffer(f"ib{i}", ib)))
                for i, (vb, ib) in enumerate(draws)]
        holder = {}

        def record(ctx):
            acc = holder["acc"]
            if batch:
                ctx.draw_indexed_batch([(va, ia, {}) for va, ia in acc])
            elif inst is not None:
                va, ia = acc[0]
                ctx.draw_indexed(va, ia, instance_count=len(inst),
                                 instance_data={"offset": ctx.dynamic("inst")})
            else:
                for va, ia in acc:
                    ctx.draw_indexed(va, ia)

        if inst is not None:
            builder.set_dynamic("inst", np.asarray(inst, np.float32))
        node = ns.add_opaque(builder, "scene", color, depth, record,
                             vs=ns.vs_inst if inst is not None else None)
        holder["acc"] = [(node.read(v), node.read(i)) for v, i in bufs]
        if hint is not None:
            node.set_band_hint(hint)
        return color, depth

    return build


def tri_vb(rng, nv, y_range=(-1.0, 1.0)):
    pos = rng.uniform(-1.0, 1.0, size=(nv, 2)).astype(np.float32)
    pos[:, 1] = rng.uniform(y_range[0], y_range[1], size=nv)
    zz = rng.uniform(0.1, 0.9, size=(nv, 1)).astype(np.float32)
    col = rng.uniform(0, 1, size=(nv, 3)).astype(np.float32)
    return np.concatenate([pos, zz.reshape(-1, 1), col], axis=1).astype(np.float32)


def assert_images_match(a, b, tol=1e-3, frac=0.0):
    """The reference's check: at most ``frac`` of pixels off by > ``tol``."""
    diff = np.abs(a - b).max(axis=-1) if a.ndim == 3 else np.abs(a - b)
    assert (diff > tol).mean() <= frac, (
        f"{(diff > tol).mean():.4%} pixels differ (max {diff.max()})")


def sort_last_triplet(build, jax_mesh_n=None):
    """(port single-device, port sort-last, JAX single-device or, with
    ``jax_mesh_n``, JAX sort-last) outputs of one graph, and the port's
    sort-last graph (for ``parallel_modes``)."""
    one, _ = frame(PORT, build)
    eight, graph = frame(PORT, build, 8, "sort_last")
    ref, _ = frame(REF, build, jax_mesh_n, "sort_last" if jax_mesh_n else "sort_first")
    return one, eight, ref, graph


def _hold(one, eight, ref):
    """Colour and depth of the sort-last frame against both references."""
    for other in (one, ref):
        assert_images_match(eight[0], other[0], frac=0.002)
        assert_images_match(eight[1], other[1], tol=1e-5, frac=0.002)


# -- TestSortLastGraph ---------------------------------------------------------------------


def test_matches_single_device(cpu_devices, rng):
    vb = tri_vb(rng, 48)
    ib = rng.integers(0, 48, size=(30, 3)).astype(np.int32)  # 30 % 8 != 0
    one, eight, ref8, graph = sort_last_triplet(single_node([(vb, ib)]), jax_mesh_n=8)
    assert graph.parallel_modes == {"scene": "sort_last"}
    assert one[0][..., :3].std() > 0.01  # something rendered
    _hold(one, eight, ref8)
    ref1, _ = frame(REF, single_node([(vb, ib)]))
    assert_images_match(eight[0], ref1[0], frac=0.002)
    assert_images_match(eight[1], ref1[1], tol=1e-5, frac=0.002)


def test_worst_case_band_imbalance(cpu_devices, rng):
    """All geometry inside the top band: sort-first would leave 7 of 8
    shards idle; sort-last renders the same image."""
    vb = tri_vb(rng, 60, y_range=(-1.0, -0.76))  # top 12% of the frame
    ib = rng.integers(0, 60, size=(40, 3)).astype(np.int32)
    one, eight, ref, _ = sort_last_triplet(single_node([(vb, ib)]))
    assert (one[1] > 0).any()  # geometry landed
    _hold(one, eight, ref)


def _quad(color, z=0.5):
    v = np.array([[-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z]], np.float32)
    return np.concatenate([v, np.tile(np.asarray(color, np.float32), (4, 1))], 1)


QUAD_IB = np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def test_equal_z_ties_resolve_in_draw_order(cpu_devices):
    """Two coplanar full-screen quads at the same depth, drawn red then
    green: strict GREATER lets the first draw win every pixel, on one
    device and through the sort-last composite."""
    build = single_node([(_quad((1, 0, 0)), QUAD_IB), (_quad((0, 1, 0)), QUAD_IB)])
    one, eight, ref8, _ = sort_last_triplet(build, jax_mesh_n=8)
    np.testing.assert_allclose(
        one[0][..., :3], np.broadcast_to([1.0, 0, 0], one[0][..., :3].shape), atol=1e-6)
    np.testing.assert_allclose(eight[0], one[0], atol=1e-6)
    np.testing.assert_allclose(eight[0], ref8[0], atol=1e-6)


def test_equal_z_ties_across_shards_resolve_in_draw_order(cpu_devices):
    """The red quad's two triangles land on shards 6 and 7 and the green
    one's on shards 0 and 1 (the other slots are degenerate), so rank
    order alone would pick green: only the submission-order plane, stamped
    from each draw's depth change, keeps red, as on one device."""
    degenerate = np.zeros((6, 3), np.int32)
    red = (_quad((1, 0, 0)), np.concatenate([degenerate, QUAD_IB]))
    green = (_quad((0, 1, 0)), np.concatenate([QUAD_IB, degenerate]))
    build = single_node([red, green])
    one, _ = frame(PORT, build)
    eight, _ = frame(PORT, build, 8, "sort_last")
    np.testing.assert_allclose(
        one[0][..., :3], np.broadcast_to([1.0, 0, 0], one[0][..., :3].shape), atol=1e-6)
    np.testing.assert_allclose(eight[0], one[0], atol=1e-6)


def test_batched_draws(cpu_devices, rng):
    vb_a = tri_vb(rng, 24)
    vb_b = tri_vb(rng, 24)
    ib = rng.integers(0, 24, size=(12, 3)).astype(np.int32)
    one, eight, ref, _ = sort_last_triplet(single_node([(vb_a, ib), (vb_b, ib)], batch=True))
    _hold(one, eight, ref)


def test_instanced_draw(cpu_devices, rng):
    base = tri_vb(rng, 12)
    ib = rng.integers(0, 12, size=(6, 3)).astype(np.int32)
    offsets = np.array([[-0.4, -0.4, 0.0], [0.4, 0.4, 0.1]], np.float32)
    one, eight, ref, _ = sort_last_triplet(single_node([(base, ib)], inst=offsets))
    assert_images_match(eight[0], one[0], frac=0.002)
    assert_images_match(eight[0], ref[0], frac=0.002)


def _opaque_then(rng, add_second):
    """The reference's two-node graphs: a sort-last opaque node, then
    ``add_second(ns, builder, color, depth)``, which returns the handle to
    export."""
    vb = tri_vb(rng, 36)
    ib = rng.integers(0, 36, size=(16, 3)).astype(np.int32)

    def build(ns, builder):
        color = builder.create(ns.rhi.TextureDesc.color("rt", W, H))
        depth = builder.create(ns.rhi.TextureDesc.depth("ds", W, H))
        va_h = builder.import_resource(ns.buffer("vb", vb))
        ia_h = builder.import_resource(ns.buffer("ib", ib))
        holder = {}
        node = ns.add_opaque(builder, "opaque", color, depth,
                             lambda ctx: ctx.draw_indexed(*holder["acc"]))
        holder["acc"] = (node.read(va_h), node.read(ia_h))
        return (add_second(ns, builder, color, depth),)

    return build


def _glass(ns, builder, color, depth):
    """A translucent full-width quad over the middle of the frame, blended
    over the opaque result (depth test on, write off): not eligible."""
    rhi, st = ns.rhi, ns.st
    gq = np.array([[-0.9, -0.4, 0.8, 0.2, 0.4, 1.0], [0.9, -0.4, 0.8, 0.2, 0.4, 1.0],
                   [0.9, 0.4, 0.8, 0.2, 0.4, 1.0], [-0.9, 0.4, 0.8, 0.2, 0.4, 1.0]],
                  np.float32)
    gv = builder.import_resource(ns.buffer("gq", gq))
    gi = builder.import_resource(ns.buffer("gib", QUAD_IB))
    glass = builder.add_graphic_node("glass")
    glass.read(color)
    glass.read(depth)
    va, ia = glass.read(gv), glass.read(gi)
    rt2, ds2 = glass.write(color), glass.write(depth)
    blend = rhi.ColorAttachmentDesc(
        blend_enable=True,
        src_color_blend=st.BlendFactor.SRC_ALPHA,
        dst_color_blend=st.BlendFactor.ONE_MINUS_SRC_ALPHA,
        src_alpha_blend=st.BlendFactor.ONE,
        dst_alpha_blend=st.BlendFactor.ONE_MINUS_SRC_ALPHA,
        load_op=st.LoadOp.LOAD,
    )
    glass_depth = replace(
        st.DepthStencilDesc(depth_test_enable=True, depth_write_enable=False,
                            depth_compare_op=st.CompareOp.GREATER),
        depth_load_op=st.LoadOp.LOAD)
    state = st.GraphicPipelineState(
        rasterization=rhi.RasterizationState(cull_mode=rhi.CullMode.NONE))
    with glass.pipeline(rhi.GraphicShaderInput(ns.vs, ns.fs_glass, ns.layout), state) as b:
        b.push_color(rt2, blend)
        b.set_depth(ds2, glass_depth)
    glass.execute(lambda ctx: ctx.draw_indexed(va, ia))
    return color


def test_blended_node_falls_back_banded(cpu_devices, rng):
    """A sort-last opaque node, then a blended node (not eligible), which
    takes the banded path over the composited result."""
    one, eight, ref, graph = sort_last_triplet(_opaque_then(rng, _glass))
    assert graph.parallel_modes == {"opaque": "sort_last", "glass": "sort_first"}
    assert one[0][..., :3].std() > 0.01
    assert_images_match(eight[0], one[0], frac=0.002)
    assert_images_match(eight[0], ref[0], frac=0.002)


def _post(ns, builder, color, depth):
    """A band-local lambda (sqrt of the clamped colour) over the composite."""
    out = builder.create(ns.rhi.TextureDesc.color("post", W, H))
    post = builder.add_lambda_node("post")
    src, dst = post.read(color), post.write(out)
    if ns.is_ref:
        import jax.numpy as jnp

        post.execute(lambda ctx: ctx.set(dst, jnp.sqrt(jnp.clip(ctx.get(src), 0.0, 1.0))))
    else:
        post.execute(lambda ctx: ctx.set(dst, torch.sqrt(torch.clamp(ctx.get(src), 0.0, 1.0))))
    return out


def test_post_lambda_consumes_banded_composite(cpu_devices, rng):
    """Sort-last node -> banded result -> a band-local post lambda."""
    one, eight, ref, _ = sort_last_triplet(_opaque_then(rng, _post))
    assert_images_match(eight[0], one[0], frac=0.002)
    assert_images_match(eight[0], ref[0], frac=0.002)


# -- TestSortLastMsaa -------------------------------------------------------------------


def _msaa_chain(ns, builder):
    """Two thin slivers crossing in an X at different depths, drawn by two
    4x MSAA nodes (the second LOADs colour and depth): fractional edge
    coverage everywhere, and the deeper sliver must lose where they cross,
    per sample through the composite."""
    tri_a = np.array([[-0.95, -0.95, 0.5, 1], [0.95, 0.95, 0.5, 1], [-0.95, -0.80, 0.5, 1]],
                     np.float32)
    tri_b = np.array([[-0.95, 0.95, 0.7, 1], [0.95, -0.95, 0.7, 1], [0.95, -0.80, 0.7, 1]],
                     np.float32)
    ra = builder.import_resource(ns.buffer("slma.vb", tri_a))
    rb = builder.import_resource(ns.buffer("slmb.vb", tri_b))
    ri = builder.import_resource(ns.buffer("slm.ib", np.array([0, 1, 2], np.int32)))
    out = builder.create(ns.rhi.TextureDesc.color("slm.rt", W, H))
    dep = builder.create(ns.rhi.TextureDesc.depth("slm.ds", W, H))
    for name, vh, first in (("pass1", ra, True), ("pass2", rb, False)):
        holder = {}
        node = ns.add_opaque(builder, name, out, dep,
                             lambda ctx, h=holder: ctx.draw_indexed(*h["acc"]),
                             clear=first, samples=4)
        holder["acc"] = (node.read(vh), node.read(ri))
    return (out,)


def test_msaa_chain_sort_last_matches_single(cpu_devices):
    one, eight, ref, graph = sort_last_triplet(_msaa_chain)
    # Both passes take sort-last (MSAA does not disqualify).
    assert graph.parallel_modes == {"pass1": "sort_last", "pass2": "sort_last"}
    vals = one[0][..., 0]
    edge = ((vals > 0.1) & (vals < 0.9)).sum()
    assert edge > 50, f"only {edge} fractional-coverage pixels"
    np.testing.assert_allclose(eight[0], one[0], atol=1e-6)
    np.testing.assert_allclose(eight[0], ref[0], atol=1e-6)


# -- the mesh limits of a sort-last node --------------------------------------------------


def test_sort_last_draws_only_its_triangle_slice(cpu_devices):
    """Each shard draws ceil(T/n) triangles from rank * per, the tail padded
    with the first triple; a strip draws replicated. The slices together
    are the index buffer in order."""
    from zenith_tpu_torch.parallel import spmd

    seen = {}

    def record(ctx):
        ib = torch.arange(30, dtype=torch.int32).reshape(10, 3)
        seen[spmd.axis_index(ctx.shard_axis)] = ctx._shard_ib(ib)
        ctx.draw_indexed(ctx.dynamic("vb"), ib[:1])

    def build(ns, builder):
        builder.set_dynamic("vb", tri_vb(np.random.default_rng(0), 30))
        color = builder.create(ns.rhi.TextureDesc.color("rt", W, H))
        depth = builder.create(ns.rhi.TextureDesc.depth("ds", W, H))
        ns.add_opaque(builder, "scene", color, depth, record)
        return (color,)

    frame(PORT, build, 8, "sort_last")
    per = 2  # ceil(10 / 8)
    assert sorted(seen) == list(range(8))
    joined = torch.cat([seen[r] for r in range(8)])
    assert all(seen[r].shape == (per, 3) for r in range(8))
    np.testing.assert_array_equal(joined[:10].numpy(), np.arange(30).reshape(10, 3))
    np.testing.assert_array_equal(joined[10:].numpy(), np.tile([[0, 1, 2]], (6, 1)))


@pytest.mark.parametrize("nodes", [1, 2])
def test_every_shard_reaches_the_composite(cpu_devices, monkeypatch, nodes):
    """A sort-last node that records no draw, and a one-triangle node whose
    seven other slots are padding (the same triangle again), composite on
    every shard: the frame equals the single-device one, and a shard that
    skipped a collective would fail the shortened rendezvous wait."""
    from zenith_tpu_torch.parallel import spmd

    monkeypatch.setattr(spmd, "DEFAULT_TIMEOUT_S", 60.0)
    vb = _quad((0.2, 0.4, 0.6))

    def build(ns, builder):
        color = builder.create(ns.rhi.TextureDesc.color("rt", W, H))
        depth = builder.create(ns.rhi.TextureDesc.depth("ds", W, H))
        va_h = builder.import_resource(ns.buffer("vb", vb))
        ia_h = builder.import_resource(ns.buffer("ib", QUAD_IB[:1]))
        holder = {}
        ns.add_opaque(builder, "empty", color, depth, lambda ctx: None)
        if nodes == 2:
            node = ns.add_opaque(builder, "one_tri", color, depth,
                                 lambda ctx: ctx.draw_indexed(*holder["acc"]), clear=False)
            holder["acc"] = (node.read(va_h), node.read(ia_h))
        return color, depth

    one, _ = frame(PORT, build)
    eight, graph = frame(PORT, build, 8, "sort_last")
    assert set(graph.parallel_modes.values()) == {"sort_last"}
    np.testing.assert_array_equal(eight[0], one[0])
    np.testing.assert_array_equal(eight[1], one[1])


def test_bin_overflow_sums_over_the_shards(cpu_devices):
    """Each shard bins its own triangles at full resolution; the frame's
    bin_overflow (what the engine's budget growth reads) is the shards'
    sum."""
    from zenith_tpu_torch.parallel import spmd

    vb = tri_vb(np.random.default_rng(5), 48)
    # 512 triangles a shard over 8 tiles: more (tile, record) pairs than the
    # nine 128-entry blocks a budget of 4 rounds up to.
    ib = np.random.default_rng(6).integers(0, 48, size=(4096, 3)).astype(np.int32)
    per_shard = {}

    def build(ns, builder):
        color = builder.create(ns.rhi.TextureDesc.color("rt", W, H))
        depth = builder.create(ns.rhi.TextureDesc.depth("ds", W, H))
        va_h = builder.import_resource(ns.buffer("vb", vb))
        ia_h = builder.import_resource(ns.buffer("ib", ib))
        holder = {}

        def record(ctx):
            ctx.draw_indexed(*holder["acc"], entry_budget=4)
            per_shard[spmd.axis_index(ctx.shard_axis)] = int(ctx.stats[-1])

        node = ns.add_opaque(builder, "scene", color, depth, record)
        holder["acc"] = (node.read(va_h), node.read(ia_h))
        return (color,)

    ns = ns_of(PORT)
    from zenith_tpu_torch.parallel import default_mesh

    builder = ns.rg.RenderGraphBuilder()
    (color,) = build(ns, builder)
    builder.export(color)
    device = ns.rhi.RhiCore(CPU).create_render_device()
    compiled = builder.build().compile(device, ns.rhi.PipelineCache(), ns.rg.CompileOptions(
        tile_h=8, mesh=default_mesh(8, device="cpu"), parallel="sort_last"))
    retired = compiled.execute(device)
    assert sorted(per_shard) == list(range(8)) and all(v > 0 for v in per_shard.values())
    assert int(retired.bin_overflow) == sum(per_shard.values())
