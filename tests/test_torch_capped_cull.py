"""The per-slot pixel rectangles of the port's capped binning
(TileBins.rect), which K7 and K8 use to cull, on the CPU.

K7 (visibility_pass) and K8 (raster_interp_pass) skip, per warp, every
record whose rectangle misses the warp's pixels. That is exact only if
every fragment the coverage test accepts lies inside its slot's rectangle.
The scenes are test_torch_raster_cull.py's (crowded small triangles,
near-clipped triangles whose AABBs reach far off-screen, needles and
slivers, corners on sample points), at pixel centres, the only sample
point the capped passes use. Checked: each live slot carries its record's
``pixel_rects`` rectangle and each pad slot the empty one; every fragment
of the plain capped walk (ops/raster.py::_TileWalk.capped) lies inside its
slot's rectangle; the plain walk with coverage masked by the rectangles (a
CPU model of the culled kernels) is bit-equal to the plain K7 and K8 for
the eight compares, with and without depth writes; and the kernels refuse
bins without rectangles, or with a table of the wrong shape, type or
alignment, before they build or launch. Tolerance: exact throughout.
"""

import types
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_raster_cull import (
    GRID,
    H,
    HP,
    W,
    WP,
    _inside,
    _pixels,
    crowded,
    culled,
    near_clipped,
    sample_edges,
    slivers,
)
from zenith_tpu_torch.interop import tile_bins_from_numpy
from zenith_tpu_torch.ops import raster as raster_mod
from zenith_tpu_torch.ops.binning import bin_triangles, pixel_rects, tile_overlap
from zenith_tpu_torch.ops.geometry import setup_with_attrs
from zenith_tpu_torch.ops.raster import K_BLOCK, raster_interp_pass, visibility_pass
from zenith_tpu_torch.ops.runtime import round_up
from zenith_tpu_torch.rhi.state import CompareOp, CullMode

torch.set_num_threads(1)
CPU = torch.device("cpu")
CENTRE = np.asarray((0.5, 0.5))
SCENES = {"crowded": crowded, "near-clipped": near_clipped, "slivers": slivers,
          "sample-edges": sample_edges}
EMPTY = torch.tensor([0, 0, -1, -1], dtype=torch.int32)


def _bins(clip, seed, k=None, a=3):
    """(records, capped bins, corner data) of clip positions (N, 4); ``k``
    defaults to a capacity that drops nothing."""
    nv = clip.shape[0]
    idx = torch.arange(nv, dtype=torch.int32).reshape(-1, 3)
    vary = torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, (nv, a))).float()
    rec, corner = setup_with_attrs(torch.from_numpy(clip).float(), idx, vary, W, H,
                                   cull_mode=CullMode.NONE)
    if k is None:
        k = round_up(int(tile_overlap(rec, GRID).sum(1).max()), K_BLOCK)
    return rec, bin_triangles(rec, GRID, k), corner


def _scene(name, seed=3):
    return _bins(SCENES[name](np.random.default_rng(seed), CENTRE), seed + 1)


@pytest.mark.parametrize("k", [None, 16], ids=["uncapped", "k16"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_rect_is_the_slots_records_rectangle(scene, k):
    rec, bins, _ = _scene(scene) if k is None else _bins(
        SCENES[scene](np.random.default_rng(3), CENTRE), 4, k)
    t, cap = bins.binned_slot.shape
    assert bins.rect.dtype == torch.int32 and bins.rect.shape == (t, cap, 4)
    live = torch.arange(cap)[None, :] < bins.counts[:, None].long()
    slot = bins.binned_slot
    assert bool((slot[live] >= 0).all()) and bool((slot[~live] == -1).all())
    assert torch.equal(bins.rect[live], pixel_rects(rec, GRID)[slot[live].long()])
    assert bool((bins.rect[~live] == EMPTY).all())
    rl = bins.rect[live]
    assert bool((rl[:, :2] >= 0).all() and (rl[:, 2] < WP).all() and (rl[:, 3] < HP).all())
    assert bool((rl[:, 0] <= rl[:, 2]).all() and (rl[:, 1] <= rl[:, 3]).all())
    if k is not None:
        assert int(bins.overflow) > 0 or scene in ("slivers", "sample-edges")


@pytest.mark.parametrize("scene", list(SCENES))
def test_rect_holds_every_covered_fragment_of_the_capped_walk(scene):
    _, bins, _ = _scene(scene)
    t, k = bins.binned_slot.shape
    walk = raster_mod._TileWalk.capped(bins.binned_rast.reshape(t * k, -1), bins.counts, GRID,
                                       CPU)
    rect = bins.rect.reshape(t * k, 4)
    gx, gy = _pixels(walk)
    covered = outside = 0
    for j, (m, c) in enumerate(walk.ranks()):
        cov = raster_mod._fragments(c, walk.x[:m], walk.y[:m], False)[0]
        covered += int(cov.sum())
        outside += int((cov & ~_inside(rect[walk.table[:m, j]], gx[:m], gy[:m])).sum())
    assert covered > 100  # the scene really covers fragments
    assert outside == 0


@pytest.fixture(scope="module")
def mixed():
    """Crowded, near-clipped, sliver and sample-point triangles in one draw
    (every second triangle of each scene, to keep the plain walk short),
    with a seed plane half of which some fragments tie exactly."""
    parts = []
    for k, f in enumerate(SCENES.values()):
        clip = f(np.random.default_rng(k), CENTRE)
        parts.append(clip.reshape(-1, 3, 4)[::2].reshape(-1, 4))
    rec, bins, corner = _bins(np.concatenate(parts), 9)
    assert int(bins.overflow) == 0 and int(bins.counts.max()) > 2 * K_BLOCK
    z = np.random.default_rng(13).uniform(0.0, 1.0, (H, W)).astype(np.float32)
    z[:, : W // 2] = 0.5
    return bins, bins.gather_corner_data(corner), torch.from_numpy(z)


@pytest.mark.parametrize("depth_write", [True, False], ids=["write", "no-write"])
@pytest.mark.parametrize("compare", list(CompareOp), ids=[op.name for op in CompareOp])
def test_culled_capped_walk_equals_plain(mixed, compare, depth_write):
    bins, attr, z0 = mixed
    s0 = torch.full((H, W), -1, dtype=torch.int32)
    kw = dict(compare_op=compare, depth_write=depth_write)

    def both():
        return (*visibility_pass(bins, GRID, z0, s0, **kw),
                *raster_interp_pass(bins, attr, GRID, z0, **kw))

    full = both()
    stats = {}
    t, k = bins.binned_slot.shape
    with culled(types.SimpleNamespace(rect=bins.rect.reshape(t * k, 4)), stats):
        cull = both()
    assert stats["dropped"] > stats["pairs"] // 4  # the model really culls
    for a, b in zip(full, cull):
        assert torch.equal(a, b)
    z7, slot, z8, acc = full
    assert torch.equal(z7, z8) and torch.equal(slot >= 0, acc[-1] > 0)
    if compare not in (CompareOp.NEVER, CompareOp.EQUAL):
        assert int((slot >= 0).sum()) > 100


def test_kernels_check_the_rect_table():
    """K7 and K8 refuse, before they build or launch, capped bins without
    rectangles (those of ``interop.tile_bins_from_numpy`` among them) and
    rectangle or row tables of the wrong shape, type or alignment."""
    _, bins, corner = _scene("crowded")
    attr = bins.gather_corner_data(corner)
    z = torch.zeros((HP, WP))
    slot = torch.full((HP, WP), -1, dtype=torch.int32)
    assert raster_mod._check_capped_rects(bins, z, "K7") is bins.rect

    def misaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16
        return out

    bad = {
        "needs the bins' per-slot pixel rectangles": [
            bins._replace(rect=None),
            tile_bins_from_numpy([np.asarray(f) for f in bins[:4]], "cpu")],
        "rectangle table": [
            bins._replace(rect=bins.rect[:, :-K_BLOCK].contiguous()),
            bins._replace(rect=bins.rect.reshape(-1, 4)),
            bins._replace(rect=bins.rect.to(torch.int64)),
            bins._replace(rect=bins.rect.transpose(0, 1).contiguous().transpose(0, 1)),
            bins._replace(rect=misaligned(bins.rect))],
        "16-byte-aligned raster rows": [bins._replace(binned_rast=misaligned(bins.binned_rast))],
    }
    cmp = CompareOp.GREATER
    for match, cases in bad.items():
        for b in cases:
            calls = {
                "K7": lambda b=b: raster_mod._visibility_cuda(b, GRID, z, slot, cmp, True),
                "K8": lambda b=b: raster_mod._interp_cuda(b, attr, GRID, z, torch.zeros(
                    (attr.shape[-1] // 3, HP, WP)), cmp, True),
            }
            for name, call in calls.items():
                with mock.patch.object(raster_mod, "load_kernels",
                                       side_effect=AssertionError(name)):
                    with pytest.raises(ValueError, match=f"{name} .*{match}"):
                        call()
            # The plain versions ignore the table.
            assert visibility_pass(b, GRID, z[:H, :W], slot[:H, :W])[1].shape == (H, W)
