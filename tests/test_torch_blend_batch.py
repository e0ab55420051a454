"""The port's in-order blending against the reference package's (mirrors
tests/test_blend_batch.py and tests/test_blend_stencil.py at their size, 128×32
with 8×128 tiles): the plain versions of kernels K5 and K6
(``raster_segmented_blend`` without and with stencil state) against the Pallas
blend kernels in interpret mode on the same bins, and ``draw_indexed_batch``'s
blend branch (``_draw_batch_blend``: uniforms as constant columns, the draw
id, facing, an instanced draw) with and without the stencil test.

Tolerances: z atol 1e-5 and stencil planes equal; colours atol 1e-5 (the
reference's own tolerance between its batched and its sequential blending,
tests/test_blend_batch.py:131-133; XLA's CPU backend contracts multiply-adds
into FMAs, the port rounds each product; ROADMAP §3).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zenith_tpu.ops.draw as jdraw
import zenith_tpu_torch.ops.draw as tdraw
from zenith_tpu.ops import TileGrid as JGrid
from zenith_tpu.ops import bin_segmented as jbin
from zenith_tpu.ops import blend as jblend
from zenith_tpu.ops import setup_with_attrs as jsetup
from zenith_tpu.ops.raster import raster_segmented_blend as jraster_blend
from zenith_tpu.rhi import pipeline as jpipe, shader as jshader, state as jstate
from zenith_tpu.rhi.formats import Format as JFormat
from zenith_tpu_torch.interop import bins_from_numpy, stencil_state_from
from zenith_tpu_torch.ops import TileGrid as TGrid
from zenith_tpu_torch.ops.raster import raster_segmented_blend as traster_blend
from zenith_tpu_torch.rhi import pipeline as tpipe, shader as tshader, state as tstate
from zenith_tpu_torch.rhi.formats import Format as TFormat

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 32
JG = JGrid(width=W, height=H, tile_h=8, tile_w=128)
TG = TGrid(width=W, height=H, tile_h=8, tile_w=128)

OVER = dict(blend_enable=True, src_color_blend="SRC_ALPHA", dst_color_blend="ONE_MINUS_SRC_ALPHA",
            src_alpha_blend="ONE", dst_alpha_blend="ONE_MINUS_SRC_ALPHA")
# Every factor and op the over operator leaves out, under a write mask.
ODD = dict(blend_enable=True, src_color_blend="ONE_MINUS_DST_ALPHA", dst_color_blend="SRC_COLOR",
           color_blend_op="REVERSE_SUBTRACT", src_alpha_blend="DST_ALPHA", dst_alpha_blend="ONE",
           alpha_blend_op="MAX", write_mask=(True, True, False, True))
MINMAX = dict(blend_enable=True, src_color_blend="DST_COLOR", dst_color_blend="ONE_MINUS_DST_COLOR",
              color_blend_op="MIN", src_alpha_blend="ONE_MINUS_SRC_COLOR", dst_alpha_blend="ZERO",
              alpha_blend_op="SUBTRACT")


def color_desc(st, spec):
    kw = {}
    for k, v in spec.items():
        if k.endswith("_blend"):
            kw[k] = st.BlendFactor[v]
        elif k.endswith("_op"):
            kw[k] = st.BlendOp[v]
        else:
            kw[k] = v
    return st.ColorAttachmentDesc(**kw)


def face(st, fail="KEEP", passed="KEEP", dfail="KEEP", cmp="NEVER", cmask=0xFF, wmask=0xFF,
         ref=0):
    return st.StencilOpState(
        fail_op=st.StencilOp[fail], pass_op=st.StencilOp[passed],
        depth_fail_op=st.StencilOp[dfail], compare_op=st.CompareOp[cmp],
        compare_mask=cmask, write_mask=wmask, reference=ref)


def _triangles(seed, nt):
    """Well-shaped overlapping triangles of both windings, RGBA per vertex."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, (nt, 1)) + np.array([0.0, 2.1, 4.2]) * rng.choice([-1, 1], (nt, 1))
    rad = rng.uniform(0.35, 0.8, (nt, 1))
    ctr = rng.uniform(-0.5, 0.5, (nt, 1, 2))
    xy = (ctr + rad[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)).reshape(-1, 2)
    nv = 3 * nt
    w = rng.uniform(0.8, 1.5, (nv, 1))
    z = rng.uniform(0.05, 0.95, (nv, 1))
    clip = np.concatenate([xy * w, z * w, w], 1).astype(np.float32)
    rgba = np.concatenate([rng.uniform(0, 1.5, (nv, 3)), rng.uniform(0.2, 0.7, (nv, 1))], 1)
    return clip, np.arange(nv, dtype=np.int32).reshape(nt, 3), rgba.astype(np.float32)


FRONT = dict(passed="INCREMENT_AND_WRAP", dfail="INVERT", cmp="GREATER_OR_EQUAL", cmask=0x0F,
             wmask=0x3F, ref=9)
BACK = dict(fail="DECREMENT_AND_CLAMP", passed="REPLACE", cmp="NOT_EQUAL", cmask=0x03, ref=0x42)


@jax.jit
def _reference_bins(clip, idx, rgba):
    """The reference's setup and binning, compiled as one function (both
    blend rasters read these bins)."""
    rec, corner = jsetup(clip, idx, rgba, W, H, cull_mode=jstate.CullMode.NONE)
    return jbin(rec, corner, JG)


@pytest.mark.parametrize("spec, write, stencil", [
    (OVER, False, False), (ODD, True, False), (MINMAX, False, False),
    (OVER, False, True), (ODD, True, True),
], ids=["K5-over", "K5-odd-depth-write", "K5-minmax", "K6-over", "K6-odd-depth-write"])
def test_raster_segmented_blend_matches_the_reference(spec, write, stencil):
    """The same bins through both blend rasters, with the shader "the RGBA
    varying" written for each package's shade_blend contract."""
    clip, idx, rgba = _triangles(5, 14)
    jb = _reference_bins(clip, idx, rgba)
    rng = np.random.default_rng(6)
    z0 = rng.uniform(0.0, 0.5, (H, W)).astype(np.float32)
    c0 = rng.uniform(0.0, 2.0, (H, W, 4)).astype(np.float32)
    s0 = rng.integers(0, 256, (H, W)).astype(np.int32)
    jdesc, tdesc = color_desc(jstate, spec), color_desc(tstate, spec)

    def j_shade_blend(planes, passed, x, y, zpx, c_planes):
        iw = planes[-1]
        ok = iw > 0.0
        inv = jnp.where(ok, 1.0 / jnp.where(ok, iw, 1.0), 0.0)
        src = jnp.stack([planes[k] * inv for k in range(4)], axis=-1)
        out = jblend.blend_colors(jnp.stack(c_planes, axis=-1), src, jdesc, (0.0,) * 4)
        return tuple(jnp.where(passed, out[..., k], c_planes[k]) for k in range(4))

    fs = tshader.Shader.fragment("rgba.fs", lambda v, r, b: v["rgba"], kernel_safe=True)
    t_shade_blend = tdraw.make_shade_blend(fs, [("rgba", 4), ("__front", 1)], tdesc, (0.0,) * 4,
                                           (W, H))
    jkw, tkw = {}, {}
    if stencil:
        jf, jbk = face(jstate, **FRONT), face(jstate, **BACK)
        jkw = dict(init_stencil=jnp.asarray(s0), stencil_front=jf, stencil_back=jbk)
        tkw = dict(init_stencil=torch.from_numpy(s0), stencil_front=stencil_state_from(jf),
                   stencil_back=stencil_state_from(jbk))
    jout = jraster_blend(jb, JG, jnp.asarray(z0), jnp.asarray(c0), j_shade_blend,
                         depth_write=write, compare_op=jstate.CompareOp.GREATER, **jkw)
    tout = traster_blend(bins_from_numpy([np.asarray(f) for f in jb], CPU), TG,
                         torch.from_numpy(z0), torch.from_numpy(c0), t_shade_blend,
                         depth_write=write, compare_op=tstate.CompareOp.GREATER, **tkw)
    assert len(tout) == len(jout) == (3 if stencil else 2)
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), atol=1e-5)
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), atol=1e-5)
    assert np.abs(tout[1].numpy() - c0).max() > 0.1  # something was blended
    if stencil:
        np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
        assert not np.array_equal(tout[2].numpy(), s0)
    if not write:
        np.testing.assert_array_equal(tout[0].numpy(), z0)


def _pipelines(spec=OVER, stencil=None, kernel_safe=True, instanced=False):
    """The same blending pipeline in both packages (reference, port): RGBA
    vertices (optionally offset per instance), a kernel-safe fragment shader
    that tints by a per-draw uniform, darkens back faces and brightens with
    the draw id."""
    out = []
    for pm, sm, st, fmt, xp in ((jpipe, jshader, jstate, JFormat, jnp),
                                (tpipe, tshader, tstate, TFormat, torch)):
        where = jnp.where if xp is jnp else torch.where
        stack = (lambda xs: jnp.stack(xs, -1)) if xp is jnp else (lambda xs: torch.stack(xs, -1))

        def vs(a, res):
            p = a["position"]
            if "offset" in a:
                p = p + a["offset"]
            return {"position": p, "rgba": a["rgba"]}

        def fs(v, res, b, where=where, stack=stack):
            c, t = v["rgba"], res["Tint"]
            one = 0.0 * c[..., 0] + 1.0
            k = where(b.front_facing, one, 0.6 * one) * (1.0 + 0.25 * b.draw_id)
            return stack([c[..., 0] * t[..., 0] * k, c[..., 1] * t[..., 1] * k,
                          c[..., 2] * t[..., 2] * k, c[..., 3] * t[..., 3]])

        ds = st.DepthStencilDesc(depth_test_enable=True, depth_write_enable=False,
                                 depth_compare_op=st.CompareOp.GREATER)
        if stencil is not None:
            ds = st.DepthStencilDesc(
                depth_test_enable=True, depth_write_enable=False,
                depth_compare_op=st.CompareOp.GREATER, stencil_test_enable=True,
                stencil_front=face(st, **stencil[0]), stencil_back=face(st, **stencil[1]),
                stencil_clear_value=2)
        inputs = [sm.attr("position", 4), sm.attr("rgba", 4)]
        if instanced:
            inputs.append(sm.attr("offset", 4, per_instance=True))
        out.append(pm.GraphicPipeline(pm.GraphicPipelineDesc(
            shader_input=pm.GraphicShaderInput(
                sm.Shader.vertex("bb.vs", vs, inputs=inputs),
                sm.Shader.fragment("bb.fs", fs, bindings=[sm.uniform("Tint")],
                                   kernel_safe=kernel_safe),
                st.VertexLayout.from_fields(("position", 4), ("rgba", 4))),
            state=st.GraphicPipelineState(
                rasterization=st.RasterizationState(cull_mode=st.CullMode.NONE),
                depth_stencil=ds),
            attachments=st.GraphicPipelineAttachments(
                color_formats=(fmt.RGBA32F,), depth_format=fmt.D32F,
                stencil_format=fmt.S8 if stencil is not None else None),
            color_attachment_descs=(color_desc(st, spec),), depth_attachment_desc=ds,
        )))
    return out


def _run_both(jp, tp, n_draws, seed, instanced_at=None, stencil=None, order=None):
    rng = np.random.default_rng(seed)
    host = []
    for d in range(n_draws):
        clip, idx, rgba = _triangles(seed * 10 + d, 4)
        tint = rng.uniform(0.4, 1.0, 4).astype(np.float32)
        host.append((np.concatenate([clip, rgba], 1), idx, tint))
    if order is not None:
        host = [host[i] for i in order]
    offs = np.zeros((3, 4), np.float32)
    offs[:, 0] = [-0.31, 0.05, 0.28]
    bg = rng.uniform(0, 1, (H, W, 4)).astype(np.float32)
    z0 = np.full((H, W), 0.1, np.float32)

    def draws(arr):
        out = []
        for d, (vb, ib, tint) in enumerate(host):
            res = {"Tint": arr(tint)}
            if instanced_at is None:
                out.append((arr(vb), arr(ib), res))
            else:
                inst = {"instance_count": 3, "instance_data": {"offset": arr(offs)}} \
                    if d == instanced_at else \
                    {"instance_count": 1, "instance_data": {"offset": arr(offs[:1] * 0)}}
                out.append((arr(vb), arr(ib), res, inst))
        return out

    jdraws = draws(jnp.asarray)

    def jfn(bg, z0, sten):
        cols, depth, st = jdraw.draw_indexed_batch([bg], z0, jp, jdraws, JG, stencil=sten)
        return cols, depth, st.bin_overflow, st.stencil

    # The reference compiled as one function, as its frames are.
    jc, jd, jover, jsten = jax.jit(jfn)(jnp.asarray(bg), jnp.asarray(z0),
                                        None if stencil is None else jnp.asarray(stencil))
    jst = types.SimpleNamespace(bin_overflow=jover, stencil=jsten)
    tc, td, tst = tdraw.draw_indexed_batch(
        [torch.from_numpy(bg)], torch.from_numpy(z0), tp, draws(torch.from_numpy), TG,
        stencil=None if stencil is None else torch.from_numpy(stencil))
    np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc[0]), atol=1e-5)
    np.testing.assert_array_equal(td.numpy(), z0)
    assert int(tst.bin_overflow) == int(jst.bin_overflow) == 0
    assert np.abs(tc[0].numpy() - bg).max() > 0.1
    return tc[0].numpy(), tst, jst


@pytest.mark.parametrize("spec", [OVER, ODD], ids=["over", "odd"])
def test_blend_batch_matches_the_reference(spec):
    jp, tp = _pipelines(spec)
    _run_both(jp, tp, 3, seed=1)


def test_blend_batch_respects_submission_order():
    jp, tp = _pipelines()
    fwd, _, _ = _run_both(jp, tp, 3, seed=2)
    rev, _, _ = _run_both(jp, tp, 3, seed=2, order=(2, 1, 0))
    assert np.abs(fwd - rev).max() > 1e-3  # src-alpha over depends on the order


def test_blend_batch_with_an_instanced_draw_matches_the_reference():
    jp, tp = _pipelines(instanced=True)
    _run_both(jp, tp, 3, seed=3, instanced_at=1)


@pytest.mark.parametrize("given", [False, True], ids=["default-plane", "given-plane"])
def test_blend_batch_with_stencil_matches_the_reference(given):
    """K6's path: the stencil state machine and the blending run per fragment
    in submission order across the draws."""
    jp, tp = _pipelines(stencil=(FRONT, BACK))
    sten = np.random.default_rng(4).integers(0, 256, (H, W)).astype(np.int32) if given else None
    _, tst, jst = _run_both(jp, tp, 3, seed=4, stencil=sten)
    np.testing.assert_array_equal(tst.stencil.numpy(), np.asarray(jst.stencil))
    assert tst.stencil.dtype == torch.int32
    if not given:
        assert (tst.stencil.numpy() == 2).any() and (tst.stencil.numpy() != 2).any()


def test_blend_batch_rejects_what_it_cannot_draw():
    """Several blended draws need a kernel-safe shader (or peeling); a single
    one keeps the winner-resolve path; every fragment binding must be bound."""
    from zenith_tpu_torch.rhi.shader import BindingError

    jp, tp = _pipelines(kernel_safe=False)
    clip, idx, rgba = _triangles(7, 2)
    vb = torch.from_numpy(np.concatenate([clip, rgba], 1))
    draw = (vb, torch.from_numpy(idx), {"Tint": torch.ones(4)})
    bg, z0 = [torch.zeros((H, W, 4))], torch.zeros((H, W))
    with pytest.raises(ValueError, match="KERNEL-SAFE"):
        tdraw.draw_indexed_batch(bg, z0, tp, [draw, draw], TG)
    one, _, _ = tdraw.draw_indexed_batch(bg, z0, tp, [draw], TG)
    jone = jax.jit(lambda vb, ib: jdraw.draw_indexed_batch(
        [jnp.zeros((H, W, 4))], jnp.zeros((H, W)), jp, [(vb, ib, {"Tint": jnp.ones(4)})],
        JG)[0])(jnp.asarray(vb.numpy()), jnp.asarray(idx))
    np.testing.assert_allclose(one[0].numpy(), np.asarray(jone[0]), atol=1e-5)
    _, safe = _pipelines()
    with pytest.raises(BindingError, match="Tint"):
        tdraw.draw_indexed_batch(bg, z0, safe, [(vb, torch.from_numpy(idx), {}), draw], TG)
