"""The port's stencil paths against the reference package's (mirrors
tests/test_stencil.py at its sizes, 128×32 with 8×128 tiles): the plain
version of kernel K3 (``raster_segmented`` with stencil state) against the
Pallas stencil kernel in interpret mode on the same bins, the stencil
branches of ``draw_indexed`` and ``draw_indexed_batch``, and a two-pass
masked draw through a stencil attachment of the render graph.

Tolerances: stencil planes and coverage equal; z and the attribute planes
atol 1e-5 (XLA's CPU backend contracts the reference kernel's multiply-adds
into FMAs, the port rounds each product; ROADMAP §3); colours atol 1e-5.
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
from zenith_tpu.ops import corner_attributes as jcorner
from zenith_tpu.ops import raster_segmented as jraster
from zenith_tpu.ops import setup_triangles as jsetup
from zenith_tpu.rhi import pipeline as jpipe, shader as jshader, state as jstate
from zenith_tpu.rhi.formats import Format as JFormat
from zenith_tpu_torch.interop import bins_from_numpy, stencil_state_from
from zenith_tpu_torch.ops import TileGrid as TGrid
from zenith_tpu_torch.ops.raster import raster_segmented as traster
from zenith_tpu_torch.rhi import pipeline as tpipe, shader as tshader, state as tstate
from zenith_tpu_torch.rhi.formats import Format as TFormat

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 32
JG = JGrid(width=W, height=H, tile_h=8, tile_w=128)
TG = TGrid(width=W, height=H, tile_h=8, tile_w=128)


def face(st, fail="KEEP", passed="KEEP", dfail="KEEP", cmp="NEVER", cmask=0xFF, wmask=0xFF,
         ref=0):
    """A StencilOpState of package ``st`` from enum names."""
    return st.StencilOpState(
        fail_op=st.StencilOp[fail], pass_op=st.StencilOp[passed],
        depth_fail_op=st.StencilOp[dfail], compare_op=st.CompareOp[cmp],
        compare_mask=cmask, write_mask=wmask, reference=ref)


def ndc_tri(verts2d, z=0.5, w=1.0):
    return np.array([[x * w, y * w, z * w, w] for x, y in verts2d], np.float32)


def random_tris(seed, nv, nt):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 1.0, size=(nv, 2))
    zz = rng.uniform(0.1, 0.9, size=(nv, 1))
    clip = np.concatenate([pos, zz, np.ones((nv, 1))], 1).astype(np.float32)
    return clip, rng.integers(0, nv, size=(nt, 3)).astype(np.int32)


STACKED = np.concatenate([ndc_tri([(-0.8, -0.8), (0.8, -0.8), (0.0, 0.8)], z=0.9),
                          ndc_tri([(-0.8, -0.8), (0.8, -0.8), (0.0, 0.8)], z=0.1)])
ONE = ndc_tri([(0.0, -0.8), (0.7, 0.7), (-0.7, 0.7)])
RANDOM_INIT = np.random.default_rng(5).integers(0, 256, size=(H, W)).astype(np.int32)

# name: (clip, idx, front kwargs, back kwargs or None, init stencil, depth compare, depth write
#        [, init z: 0.0 unless given])
RASTER_CASES = {
    "replace-marks-coverage": (ONE, [[0, 1, 2]], dict(passed="REPLACE", cmp="ALWAYS", ref=7),
                               None, None, "GREATER", True),
    "increment-wrap-counts-overlaps": (*random_tris(1, 24, 14),
                                       dict(passed="INCREMENT_AND_WRAP", cmp="ALWAYS"),
                                       None, None, "ALWAYS", True),
    "depth-fail-op-fires": (STACKED, [[0, 1, 2], [3, 4, 5]],
                            dict(passed="REPLACE", dfail="INCREMENT_AND_CLAMP", cmp="ALWAYS",
                                 ref=9), None, None, "GREATER", True),
    "fail-op-and-masks": (ONE, [[0, 1, 2]],
                          dict(fail="ZERO", passed="INVERT", cmp="LESS", cmask=0x0F, wmask=0x3C,
                               ref=5), None, RANDOM_INIT, "GREATER", True),
    "faces-differ": (*random_tris(2, 18, 10),
                     dict(passed="INCREMENT_AND_CLAMP", cmp="ALWAYS"),
                     dict(passed="REPLACE", cmp="ALWAYS", ref=100), None, "ALWAYS", True),
    "faces-differ-every-op": (*random_tris(3, 30, 20),
                              dict(fail="DECREMENT_AND_CLAMP", passed="INCREMENT_AND_WRAP",
                                   dfail="INVERT", cmp="GREATER_OR_EQUAL", cmask=0x3F,
                                   wmask=0xF3, ref=0x21),
                              dict(fail="DECREMENT_AND_WRAP", passed="ZERO", dfail="REPLACE",
                                   cmp="NOT_EQUAL", cmask=0xF0, wmask=0x7E, ref=0x5A),
                              RANDOM_INIT, "GREATER", False, 0.5),
    "invert-all-eight-bits": (*random_tris(4, 18, 8), dict(passed="INVERT", cmp="ALWAYS"),
                              None, RANDOM_INIT, "ALWAYS", True),
}


@jax.jit
def _bins_of(clip, idx):
    records = jsetup(clip, idx, W, H, cull_mode=jstate.CullMode.NONE)
    corner = jcorner(records, idx, jnp.zeros((clip.shape[0], 0), jnp.float32))
    return jbin(records, corner, JG)


def _reference_bins(clip, idx):
    """The reference's setup and binning of a case, compiled as one
    function (both rasters read these bins)."""
    return _bins_of(jnp.asarray(clip), jnp.asarray(idx, jnp.int32))


@pytest.mark.parametrize("case", list(RASTER_CASES))
def test_raster_segmented_stencil_matches_the_reference(case):
    clip, idx, front, back, init, compare, write, *rest = RASTER_CASES[case]
    z0 = np.full((H, W), rest[0] if rest else 0.0, np.float32)
    jb = _reference_bins(clip, idx)
    init = np.zeros((H, W), np.int32) if init is None else init
    jfront = face(jstate, **front)
    jback = None if back is None else face(jstate, **back)
    jz, jacc, js = jraster(jb, JG, jnp.asarray(z0), depth_write=write,
                           compare_op=jstate.CompareOp[compare], init_stencil=jnp.asarray(init),
                           stencil_front=jfront, stencil_back=jback)
    tz, tacc, ts = traster(
        bins_from_numpy([np.asarray(f) for f in jb], CPU), TG, torch.from_numpy(z0),
        depth_write=write, compare_op=tstate.CompareOp[compare],
        init_stencil=torch.from_numpy(init), stencil_front=stencil_state_from(jfront),
        stencil_back=None if jback is None else stencil_state_from(jback))
    assert ts.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tacc.numpy()[-1] > 0, np.asarray(jacc)[-1] > 0)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), atol=1e-5)
    assert not np.array_equal(ts.numpy(), init)  # the draw really wrote the plane


def _pipelines(front, back, write=True, compare="GREATER"):
    """The same stencil-testing pipeline in both packages (reference, port):
    position + colour vertices, the fragment colour scaled by a per-draw
    Gain."""
    out = []
    for pm, sm, st, fmt in ((jpipe, jshader, jstate, JFormat), (tpipe, tshader, tstate, TFormat)):
        ds = st.DepthStencilDesc(
            depth_test_enable=True, depth_write_enable=write,
            depth_compare_op=st.CompareOp[compare], stencil_test_enable=True,
            stencil_front=face(st, **front), stencil_back=face(st, **(back or front)),
            stencil_clear_value=3)
        out.append(pm.GraphicPipeline(pm.GraphicPipelineDesc(
            shader_input=pm.GraphicShaderInput(
                sm.Shader.vertex("st.vs", lambda a, r: {"position": a["position"],
                                                        "color": a["color"]}),
                sm.Shader.fragment("st.fs", lambda v, r, b: v["color"] * r["Gain"],
                                   bindings=[sm.uniform("Gain")]),
                st.VertexLayout.from_fields(("position", 4), ("color", 4))),
            state=st.GraphicPipelineState(
                rasterization=st.RasterizationState(cull_mode=st.CullMode.NONE),
                depth_stencil=ds),
            attachments=st.GraphicPipelineAttachments(
                color_formats=(fmt.RGBA32F,), depth_format=fmt.D32F, stencil_format=fmt.S8),
        )))
    return out


def _draw(seed, nt=6):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, (nt, 1)) + np.array([0.0, 2.1, 4.2]) * rng.choice([-1, 1], (nt, 1))
    rad = rng.uniform(0.3, 0.7, (nt, 1))
    ctr = rng.uniform(-0.6, 0.6, (nt, 1, 2))
    xy = (ctr + rad[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)).reshape(-1, 2)
    nv = 3 * nt
    z = rng.uniform(0.1, 0.9, (nv, 1))
    vb = np.concatenate([xy, z, np.ones((nv, 1)), rng.uniform(0, 1, (nv, 4))], 1).astype(np.float32)
    return vb, np.arange(nv, dtype=np.int32).reshape(nt, 3), rng.uniform(0.5, 1, 4).astype(np.float32)


FRONT = dict(passed="INCREMENT_AND_WRAP", dfail="INVERT", cmp="ALWAYS", wmask=0x3F)
BACK = dict(fail="ZERO", passed="REPLACE", dfail="DECREMENT_AND_CLAMP", cmp="LESS_OR_EQUAL",
            cmask=0x0F, ref=2)


@pytest.mark.parametrize("given", [False, True], ids=["default-plane", "given-plane"])
def test_draw_indexed_stencil_matches_the_reference(given):
    jp, tp = _pipelines(FRONT, BACK)
    vb, ib, gain = _draw(11)
    bg = np.random.default_rng(1).uniform(0, 1, (H, W, 4)).astype(np.float32)
    z0 = np.full((H, W), 0.3, np.float32)
    sten = RANDOM_INIT if given else None

    def jfn(bg, z0, vb, ib, gain, sten):
        cols, depth, st = jdraw.draw_indexed([bg], z0, jp, vb, ib, {"Gain": gain}, JG,
                                             stencil=sten)
        return cols, depth, st.stencil

    jc, jd, jsten = jax.jit(jfn)(jnp.asarray(bg), jnp.asarray(z0), jnp.asarray(vb),
                                 jnp.asarray(ib), jnp.asarray(gain),
                                 None if sten is None else jnp.asarray(sten))
    tc, td, tst = tdraw.draw_indexed(
        [torch.from_numpy(bg)], torch.from_numpy(z0), tp, torch.from_numpy(vb),
        torch.from_numpy(ib), {"Gain": torch.from_numpy(gain)}, TG,
        stencil=None if sten is None else torch.from_numpy(sten))
    np.testing.assert_array_equal(tst.stencil.numpy(), np.asarray(jsten))
    np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc[0]), atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    if not given:  # untouched pixels keep the pipeline's stencil clear value
        assert (tst.stencil.numpy() == 3).any() and (tst.stencil.numpy() != 3).any()


def test_draw_indexed_batch_stencil_matches_the_reference():
    """Three draws through one stencil-tested raster pass (K3's path): the
    stencil state machine runs across the draws in submission order."""
    jp, tp = _pipelines(FRONT, BACK, write=False, compare="GREATER_OR_EQUAL")
    draws = [_draw(s) for s in (21, 22, 23)]
    bg = np.zeros((H, W, 4), np.float32)
    z0 = np.full((H, W), 0.2, np.float32)

    def jfn(bg, z0, jdraws, sten):
        cols, depth, st = jdraw.draw_indexed_batch(
            [bg], z0, jp, [(vb, ib, {"Gain": g}) for vb, ib, g in jdraws], JG,
            per_draw_uniforms=("Gain",), stencil=sten)
        return cols, depth, st.stencil, st.bin_overflow

    jc, jd, jsten, jover = jax.jit(jfn)(
        jnp.asarray(bg), jnp.asarray(z0),
        [(jnp.asarray(vb), jnp.asarray(ib), jnp.asarray(g)) for vb, ib, g in draws],
        jnp.asarray(RANDOM_INIT))
    tc, td, tst = tdraw.draw_indexed_batch(
        [torch.from_numpy(bg)], torch.from_numpy(z0), tp,
        [(torch.from_numpy(vb), torch.from_numpy(ib), {"Gain": torch.from_numpy(g)})
         for vb, ib, g in draws], TG,
        per_draw_uniforms=("Gain",), stencil=torch.from_numpy(RANDOM_INIT))
    np.testing.assert_array_equal(tst.stencil.numpy(), np.asarray(jsten))
    np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc[0]), atol=1e-5)
    np.testing.assert_array_equal(td.numpy(), z0)  # depth write off
    assert int(tst.bin_overflow) == int(jover) == 0


def _masked_graph(pkg):
    """tests/test_stencil.py's two-pass masked draw through the render graph
    of ``pkg`` ("jax" or "torch"): pass 1 marks a triangle in a stencil-only
    node, pass 2 draws a red full-screen quad gated on stencil == 1.
    Returns (colour, stencil) as numpy."""
    if pkg == "jax":
        from zenith_tpu import rendergraph as rg, rhi
        xp_full = lambda b: jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0, 1.0]), b.depth.shape + (4,))
        mk = lambda name, arr: rhi.Buffer.from_numpy(name, arr)
        st = jstate
    else:
        from zenith_tpu_torch import rendergraph as rg, rhi
        xp_full = lambda b: torch.tensor([1.0, 0.0, 0.0, 1.0]).expand(b.depth.shape + (4,))
        mk = lambda name, arr: rhi.Buffer.from_numpy(name, arr, device=CPU)
        st = tstate
    device = rhi.RhiCore().create_render_device() if pkg == "jax" else \
        rhi.RhiCore(CPU).create_render_device()
    layout = st.VertexLayout.from_fields(("position", 4))
    vs = rhi.Shader.vertex("vs", lambda attrs, res: {"position": attrs["position"]})
    fs_red = rhi.Shader.fragment("fs_red", lambda v, r, b: xp_full(b))
    tri = np.array([[0.0, -0.5, 0.5, 1.0], [0.5, 0.5, 0.5, 1.0], [-0.5, 0.5, 0.5, 1.0]], np.float32)
    quad = np.array([[-2, -2, 0.6, 1.0], [2, -2, 0.6, 1.0], [2, 2, 0.6, 1.0], [-2, 2, 0.6, 1.0]],
                    np.float32)
    builder = rg.RenderGraphBuilder()
    v1 = builder.import_resource(mk("tri.vb", tri))
    i1 = builder.import_resource(mk("tri.ib", np.array([0, 1, 2], np.int32)))
    v2 = builder.import_resource(mk("quad.vb", quad))
    i2 = builder.import_resource(mk("quad.ib", np.array([0, 1, 2, 0, 2, 3], np.int32)))
    color = builder.create(rhi.TextureDesc.color("out", W, H))
    sten = builder.create(rhi.TextureDesc.stencil("mask", W, H))
    builder.export(color)
    builder.export(sten)
    raster = st.RasterizationState(cull_mode=st.CullMode.NONE)

    node = builder.add_graphic_node("mark")
    v1a, i1a, sa = node.read(v1), node.read(i1), node.write(sten)
    with node.pipeline(rhi.GraphicShaderInput(vs, None, layout), st.GraphicPipelineState(
            rasterization=raster, depth_stencil=st.DepthStencilDesc().stencil_write(1))) as binder:
        binder.set_stencil(sa)
    node.execute(lambda ctx: ctx.draw_indexed(v1a, i1a))

    node = builder.add_graphic_node("gated")
    v2a, i2a = node.read(v2), node.read(i2)
    node.read(sten)
    ca, sa2 = node.write(color), node.write(sten)
    with node.pipeline(rhi.GraphicShaderInput(vs, fs_red, layout), st.GraphicPipelineState(
            rasterization=raster, depth_stencil=st.DepthStencilDesc().stencil_mask(1))) as binder:
        binder.push_color(ca, rhi.ColorAttachmentDesc(clear_value=(0, 0, 0, 1)))
        binder.set_stencil(sa2)
    node.execute(lambda ctx: ctx.draw_indexed(v2a, i2a))

    compiled = builder.build().compile(device, rhi.PipelineCache(),
                                       rg.CompileOptions(tile_h=8, tile_w=128))
    compiled.execute(device)
    return np.asarray(compiled.value(color)), np.asarray(compiled.value(sten))


def test_stencil_attachment_through_the_render_graph_matches_the_reference():
    jcol, jsten = _masked_graph("jax")
    tcol, tsten = _masked_graph("torch")
    np.testing.assert_array_equal(tsten, jsten)
    np.testing.assert_allclose(tcol, jcol, atol=1e-6)
    inside = tsten == 1
    assert 100 < inside.sum() < W * H // 2
    np.testing.assert_allclose(tcol[inside][:, 0], 1.0, atol=1e-6)
    np.testing.assert_allclose(tcol[~inside][:, 0], 0.0, atol=1e-6)
