"""The port's draw_indexed against the reference's on the same numpy-seeded
draws: triangle lists over a depth attachment, triangle strips with
primitive restart, instancing with per-instance data, blending with a write
mask, and a draw split into primitive parts.

Tolerances: coverage (which pixels changed) exact; colors atol 1e-5; depth
atol 1e-5 — not 1e-6, because XLA's CPU backend contracts the reference
kernel's edge and depth multiply-adds into FMAs while the port rounds each
product (see test_torch_raster_compare.py); the bin overflow count exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zenith_tpu.ops.draw as jdraw_mod
from np_reference import render_reference
import zenith_tpu_torch.ops.draw as tdraw_mod
from zenith_tpu.ops import TileGrid as JGrid
from zenith_tpu.rhi import pipeline as jpipe, shader as jshader, state as jstate
from zenith_tpu.rhi.formats import Format as JFormat
from zenith_tpu_torch.ops import TileGrid as TGrid
from zenith_tpu_torch.rhi import pipeline as tpipe, shader as tshader, state as tstate
from zenith_tpu_torch.rhi.formats import Format as TFormat

torch.set_num_threads(1)
W, H = 128, 64
JG = JGrid(W, H, 8, 128)
TG = TGrid(W, H, 8, 128)


# Shaders: the same math written once per framework.
def _jvs(attrs, res):
    p = attrs["position"]
    off = attrs.get("offset", jnp.zeros((p.shape[0], 4), jnp.float32))
    return {"position": p + off, "color": attrs["color"] * res["Tint"]}


def _tvs(attrs, res):
    p = attrs["position"]
    off = attrs.get("offset", torch.zeros((p.shape[0], 4)))
    return {"position": p + off, "color": attrs["color"] * res["Tint"]}


def _jfs(v, res, b):
    c = v["color"]
    return jnp.concatenate([c, 0.25 + 0.5 * c[..., :1]], -1)


def _tfs(v, res, b):
    c = v["color"]
    return torch.cat([c, 0.25 + 0.5 * c[..., :1]], -1)


def _pipelines(topology="TRIANGLE_LIST", restart=False, blend=False, depth=True,
               write_mask=(True, True, True, True)):
    out = []
    for pm, sm, st, fmt, vs, fs in (
        (jpipe, jshader, jstate, JFormat, _jvs, _jfs),
        (tpipe, tshader, tstate, TFormat, _tvs, _tfs),
    ):
        cdesc = st.ColorAttachmentDesc(write_mask=write_mask)
        if blend:
            cdesc = st.ColorAttachmentDesc(
                blend_enable=True,
                src_color_blend=st.BlendFactor.SRC_ALPHA,
                dst_color_blend=st.BlendFactor.ONE_MINUS_SRC_ALPHA,
                write_mask=write_mask,
            )
        ds = st.DepthStencilDesc().reverse_z() if depth else st.DepthStencilDesc()
        out.append(pm.GraphicPipeline(pm.GraphicPipelineDesc(
            shader_input=pm.GraphicShaderInput(
                sm.Shader.vertex("draw.vs", vs, bindings=[sm.uniform("Tint")]),
                sm.Shader.fragment("draw.fs", fs),
                st.VertexLayout.from_fields(("position", 4), ("color", 3)),
            ),
            state=st.GraphicPipelineState(
                input_assembly=st.InputAssemblyState(
                    topology=st.PrimitiveTopology[topology], primitive_restart=restart
                ),
                rasterization=st.RasterizationState(cull_mode=st.CullMode.NONE),
                depth_stencil=ds,
            ),
            attachments=st.GraphicPipelineAttachments(
                color_formats=(fmt.RGBA32F,), depth_format=fmt.D32F if depth else None
            ),
            color_attachment_descs=(cdesc,),
        )))
    return out


def _vertices(seed, nv):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.7, 1.6, (nv, 1))
    xy = rng.uniform(-1.1, 1.1, (nv, 2)) * w
    z = rng.uniform(0.05, 0.95, (nv, 1)) * w
    col = rng.uniform(0.0, 1.0, (nv, 3))
    return np.concatenate([xy, z, w, col], axis=1).astype(np.float32)


def _run(pipes, vb, ib, depth=True, **kw):
    rng = np.random.default_rng(99)
    bg = rng.uniform(0, 1, (H, W, 4)).astype(np.float32)
    z0 = np.full((H, W), 0.02, np.float32)
    tint = np.array([0.9, 1.0, 0.8], np.float32)
    jp, tp = pipes
    jk = {k: v for k, v in kw.items()}
    tk = dict(kw)
    if "instance_data" in kw:
        tk["instance_data"] = {k: torch.from_numpy(v) for k, v in kw["instance_data"].items()}
    def jdraw(c, d, v, i, t):
        colors, dep, stats = jdraw_mod.draw_indexed(c, d, jp, v, i, {"Tint": t}, JG, **jk)
        return colors, dep, stats.bin_overflow

    jc, jd, jover = jax.jit(jdraw)([jnp.asarray(bg)], jnp.asarray(z0) if depth else None,
                                   jnp.asarray(vb), jnp.asarray(ib), jnp.asarray(tint))
    tc, td, ts = tdraw_mod.draw_indexed(
        [torch.from_numpy(bg)], torch.from_numpy(z0) if depth else None, tp,
        torch.from_numpy(vb), torch.from_numpy(ib), {"Tint": torch.from_numpy(tint)}, TG, **tk,
    )
    jcol, tcol = np.asarray(jc[0]), tc[0].numpy()
    np.testing.assert_array_equal(np.any(tcol != bg, -1), np.any(jcol != bg, -1))  # coverage
    np.testing.assert_allclose(tcol, jcol, atol=1e-5)
    if depth:
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    assert int(ts.bin_overflow) == int(jover)
    assert np.any(tcol != bg)  # the draw really drew
    return tcol


@pytest.mark.parametrize("depth", [True, False], ids=["depth", "no-depth"])
def test_triangle_list(depth):
    vb = _vertices(1, 45)
    ib = np.random.default_rng(2).integers(0, 45, (30, 3)).astype(np.int32)
    _run(_pipelines(depth=depth), vb, ib, depth=depth)


def test_triangle_strip_with_primitive_restart():
    vb = _vertices(3, 24)
    ib = np.array([0, 1, 2, 3, 4, -1, 5, 6, 7, 8, 9, 10, -1, 11, 12, 13, -1, -1, 14, 15, 16,
                   17, 18, 19, 20, 21, 22, 23], np.int32)
    _run(_pipelines("TRIANGLE_STRIP", restart=True), vb, ib)
    # Without restart the same indices (restart value dropped) decode as one strip.
    _run(_pipelines("TRIANGLE_STRIP"), vb, ib[ib >= 0])


def test_instancing_with_instance_data():
    vb = np.array([[-0.3, -0.6, 0.5, 1.0, 1, 0, 0], [0.3, 0.6, 0.5, 1.0, 0, 1, 0],
                   [-0.3, 0.6, 0.4, 1.0, 0, 0, 1], [0.2, -0.5, 0.3, 0.8, 1, 1, 0],
                   [0.6, 0.5, 0.6, 1.2, 0, 1, 1], [-0.1, 0.4, 0.2, 0.9, 1, 0, 1]], np.float32)
    ib = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    n = 4
    offs = np.zeros((n, 4), np.float32)
    # Offsets off the pixel grid: an edge exactly through a pixel centre is
    # where XLA's FMA contraction and the exactly rounded port may differ
    # (the port follows the float64 oracle there, checked below).
    offs[:, 0] = [-0.4873, -0.1621, 0.1789, 0.5137]
    offs[:, 2] = np.linspace(0.0, 0.2, n)
    col = _run(_pipelines(), vb, ib, instance_count=n, instance_data={"offset": offs})
    clip = np.concatenate([vb[:, :4] + o for o in offs])
    tris = np.concatenate([ib + vb.shape[0] * i for i in range(n)])
    ref = render_reference(clip, tris, W, H, cull="none", compare="greater", depth_clear=0.02)
    bg = np.random.default_rng(99).uniform(0, 1, (H, W, 4)).astype(np.float32)
    np.testing.assert_array_equal(np.any(col != bg, -1), ref["tri"] >= 0)


def test_blending_and_write_mask():
    vb = _vertices(6, 30)
    ib = np.random.default_rng(7).integers(0, 30, (20, 3)).astype(np.int32)
    _run(_pipelines(blend=True, write_mask=(True, False, True, True)), vb, ib)


def test_split_into_primitive_parts_matches_unsplit(monkeypatch):
    """Above MAX_PRIMS_PER_PART a draw splits into sequential parts; the
    result equals one pass (draw.py:68-78 semantics), here forced small."""
    vb = _vertices(8, 60)
    ib = np.random.default_rng(9).integers(0, 60, (40, 3)).astype(np.int32)
    whole = _run(_pipelines(), vb, ib)
    monkeypatch.setattr(tdraw_mod, "MAX_PRIMS_PER_PART", 7)
    monkeypatch.setattr(tdraw_mod, "MAX_RECORDS_PER_RASTER", 20)
    _, tp = _pipelines()
    rng = np.random.default_rng(99)
    bg = rng.uniform(0, 1, (H, W, 4)).astype(np.float32)
    tc, td, _ = tdraw_mod.draw_indexed(
        [torch.from_numpy(bg)], torch.full((H, W), 0.02), tp, torch.from_numpy(vb),
        torch.from_numpy(ib), {"Tint": torch.tensor([0.9, 1.0, 0.8])}, TG,
    )
    np.testing.assert_array_equal(tc[0].numpy(), whole)  # bit-equal


def test_unported_draw_modes_name_their_roadmap_item():
    """Line topologies (ROADMAP item 19) are ported: a line list draws its
    three segments (test_torch_lines_points.py holds them to the
    reference); an odd index count is refused."""
    vb = torch.from_numpy(_vertices(1, 6))
    _, tp = _pipelines("LINE_LIST")
    cols, _, _ = tdraw_mod.draw_indexed([torch.zeros((H, W, 4))], None, tp, vb,
                                        torch.arange(6, dtype=torch.int32),
                                        {"Tint": torch.ones(3)}, TG)
    assert int((cols[0][..., 3] > 0).sum()) > 20
    with pytest.raises(ValueError, match="even index count"):
        tdraw_mod.draw_indexed([torch.zeros((H, W, 4))], None, tp, vb,
                               torch.arange(5, dtype=torch.int32), {"Tint": torch.ones(3)}, TG)
