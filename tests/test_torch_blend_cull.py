"""K5 and K6's culled walk on the CPU.

The blend kernels skip, per warp, every entry whose per-row pixel rectangle
(SegmentedBins.rect) misses the warp's pixels, as K1 does. The plain blend
walk with each rank's coverage masked by its rows' rectangles
(test_torch_raster_cull.culled, a CPU model of that cull) must be bit-equal
to the unculled plain K5 and K6 in z, colour and stencil: on overlapping
translucent triangles, exact duplicates submitted later (depth-EQUAL ties),
near-clipped triangles reaching far off-screen, needles and corners on
sample points, at sample offsets (0.5, 0.5) and (0.9375, 0.0625). Blend
states: src-alpha over with depth writes off, and reverse-subtract / max
under a write mask with depth writes on; K6 with a read-only stencil mask
and with stencil writes, both with faces that differ. Last, the K5/K6
wrappers refuse bins without rectangles and sample offsets outside [0, 1)²
before they build or launch. Tolerance: exact throughout.
"""

from unittest import mock

import numpy as np
import pytest
import torch
from test_torch_raster_cull import GRID, H, W, culled, near_clipped, sample_edges, slivers

from zenith_tpu_torch.ops import raster as raster_mod
from zenith_tpu_torch.ops.binning import bin_segmented
from zenith_tpu_torch.ops.draw import make_shade_blend
from zenith_tpu_torch.ops.geometry import setup_with_attrs
from zenith_tpu_torch.ops.raster import raster_segmented_blend
from zenith_tpu_torch.rhi import Shader
from zenith_tpu_torch.rhi.state import (
    BlendFactor,
    BlendOp,
    ColorAttachmentDesc,
    CompareOp,
    CullMode,
    StencilOp,
    StencilOpState,
)

torch.set_num_threads(1)
LAYOUT = [("color", 4), ("__front", 1)]  # the record columns, 1/w not included
OFFSETS = [(0.5, 0.5), (0.9375, 0.0625)]


def _fs(varyings, res, builtins):
    """Vertex colour, darker on back faces."""
    c = varyings["color"]
    k = torch.where(builtins.front_facing, 1.0, 0.6)[..., None]
    return torch.cat([c[..., :3] * k, c[..., 3:]], dim=-1)


FS = Shader.fragment("cull.fs", _fs)
OVER = ColorAttachmentDesc(blend_enable=True, src_color_blend=BlendFactor.SRC_ALPHA,
                           dst_color_blend=BlendFactor.ONE_MINUS_SRC_ALPHA,
                           src_alpha_blend=BlendFactor.ONE,
                           dst_alpha_blend=BlendFactor.ONE_MINUS_SRC_ALPHA)
ODD = ColorAttachmentDesc(blend_enable=True, src_color_blend=BlendFactor.ONE_MINUS_DST_ALPHA,
                          dst_color_blend=BlendFactor.SRC_COLOR,
                          color_blend_op=BlendOp.REVERSE_SUBTRACT,
                          src_alpha_blend=BlendFactor.DST_ALPHA, dst_alpha_blend=BlendFactor.ONE,
                          alpha_blend_op=BlendOp.MAX, write_mask=(True, True, False, True))


def _overlapping(rng, offset):
    """Large translucent triangles over the whole surface, mixed winding."""
    nt = 24
    px = rng.uniform(-0.3, 1.3, (nt, 3, 2)) * [W, H]
    z = np.repeat(rng.uniform(0.1, 0.9, (nt, 1)), 3, 1)
    ndc = px / [W / 2, H / 2] - 1.0
    return np.concatenate([ndc, z[..., None], np.ones((nt, 3, 1))], -1).reshape(-1, 4)


def _bins(offset):
    """Overlapping, near-clipped, sliver and sample-edge triangles, then a
    quarter of them again (exact duplicates: depth-EQUAL ties), with RGBA
    vertex colours (alpha 0.1-0.6), through the port's setup and binning."""
    clip = np.concatenate([f(np.random.default_rng(k), np.asarray(offset)) for k, f in
                           enumerate((_overlapping, near_clipped, slivers, sample_edges))])
    idx = np.arange(clip.shape[0]).reshape(-1, 3)
    dup = idx[np.random.default_rng(7).choice(idx.shape[0], idx.shape[0] // 4, replace=False)]
    idx = torch.from_numpy(np.concatenate([idx, dup]).astype(np.int32))
    rng = np.random.default_rng(8)
    color = np.concatenate([rng.uniform(0, 1.5, (clip.shape[0], 3)),
                            rng.uniform(0.1, 0.6, (clip.shape[0], 1))], 1)
    rec, corner = setup_with_attrs(torch.from_numpy(clip).float(), idx,
                                   torch.from_numpy(color).float(), W, H, cull_mode=CullMode.NONE)
    bins = bin_segmented(rec, corner, GRID, entry_budget=GRID.num_tiles * rec.rast16.shape[0])
    assert int(bins.overflow) == 0
    return bins


CASES = {
    # name: (colour attachment, compare, depth write, stencil faces)
    "over-no-depth-write": (OVER, CompareOp.GREATER, False, None),
    "revsub-max-masked-depth-write": (ODD, CompareOp.GREATER_OR_EQUAL, True, None),
    "stencil-mask-faces-differ": (
        OVER, CompareOp.GREATER, False,
        (StencilOpState(compare_op=CompareOp.EQUAL, compare_mask=0x01, reference=1),
         StencilOpState(compare_op=CompareOp.NOT_EQUAL, compare_mask=0x01, reference=1))),
    "stencil-write-faces-differ": (
        OVER, CompareOp.GREATER_OR_EQUAL, True,
        (StencilOpState(pass_op=StencilOp.INCREMENT_AND_CLAMP, depth_fail_op=StencilOp.INVERT,
                        compare_op=CompareOp.GREATER, write_mask=0x7F, reference=6),
         StencilOpState(fail_op=StencilOp.DECREMENT_AND_WRAP, pass_op=StencilOp.INCREMENT_AND_WRAP,
                        compare_op=CompareOp.GREATER_OR_EQUAL, compare_mask=0x0F, reference=3))),
}


@pytest.mark.parametrize("offset", OFFSETS, ids=["centre", "skewed"])
@pytest.mark.parametrize("case", list(CASES))
def test_culled_blend_walk_equals_plain(case, offset):
    cdesc, compare, write, faces = CASES[case]
    bins = _bins(offset)
    rng = np.random.default_rng(11)
    z0 = np.where(np.arange(W) < W // 2, 0.5, rng.uniform(0, 1, (H, W))).astype(np.float32)
    bg = torch.from_numpy(rng.uniform(0, 2, (H, W, 4)).astype(np.float32))
    kw = dict(compare_op=compare, depth_write=write, sample_offset=offset)
    if faces is not None:
        kw.update(init_stencil=torch.from_numpy(rng.integers(0, 4, (H, W)).astype(np.int32)),
                  stencil_front=faces[0], stencil_back=faces[1])
    shade_blend = make_shade_blend(FS, LAYOUT, cdesc, (0.0, 0.0, 0.0, 0.0), (W, H))

    def run():
        return raster_segmented_blend(bins, GRID, torch.from_numpy(z0), bg, shade_blend, **kw)

    full = run()
    stats = {}
    with culled(bins, stats):
        cull = run()
    assert stats["dropped"] > stats["pairs"] // 4  # the model really culls
    for a, b in zip(full, cull):
        assert torch.equal(a, b)
    drawn = (full[1] != bg).any(-1)
    assert int(drawn.sum()) > H * W // 4
    if faces is not None:
        assert not torch.equal(full[2], kw["init_stencil"]) or not write
    if write:
        assert not torch.equal(full[0], torch.from_numpy(z0))


@pytest.mark.parametrize("offset", [None, (2.5, 0.5), (0.5, -1.5), (1.0, 0.0), (0.5, 0.99999999)],
                         ids=["no-rects", "x-2.5", "y-minus-1.5", "x-1", "y-rounds-to-1"])
@pytest.mark.parametrize("name", ["K5", "K6"])
def test_blend_kernels_refuse_what_the_rects_do_not_hold(name, offset):
    """Bins without rectangles (as interop.bins_from_numpy makes), or a
    sample offset outside [0, 1)² (as float32), are refused before a build
    or a launch; the plain version takes both."""
    bins = _bins((0.5, 0.5))
    if offset is None:
        bins, offset, match = bins._replace(rect=None), (0.5, 0.5), "per-row pixel rectangles"
    else:
        match = f"{name} culls .* sample offset in"
    z = torch.zeros((GRID.tiles_y * GRID.tile_h, GRID.tiles_x * GRID.tile_w))
    color = torch.zeros((*z.shape, 4))
    sten = torch.zeros(z.shape, dtype=torch.int32) if name == "K6" else None
    faces = (StencilOpState(), StencilOpState()) if name == "K6" else None
    with mock.patch.object(raster_mod, "load_blend_kernel", side_effect=AssertionError(name)):
        with pytest.raises(ValueError, match=match):
            raster_mod._raster_blend_cuda(bins, GRID, z, color, sten, faces, CompareOp.GREATER,
                                          False, False, offset, FS, LAYOUT, OVER)
    shade_blend = make_shade_blend(FS, LAYOUT, OVER, (0.0, 0.0, 0.0, 0.0), (W, H))
    out = raster_segmented_blend(bins, GRID, z[:H, :W], color[:H, :W], shade_blend,
                                 sample_offset=offset)
    assert out[1].shape == (H, W, 4)
