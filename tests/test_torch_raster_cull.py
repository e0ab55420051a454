"""The per-row pixel rectangles of the port's binning (SegmentedBins.rect),
which K1, K3 and K4 use to cull, on the CPU.

The kernels skip, per warp, every entry whose rectangle misses the warp's
pixels. That is exact only if every fragment the coverage test accepts lies
inside its row's rectangle. The fragments here come from the plain walk's
own functions (ops/raster.py::_TileWalk and _fragments) on numpy-seeded
scenes: crowded small triangles, near-clipped triangles whose AABBs reach
far off-screen, needles and slivers, edges through sample points on the
rectangle's border, and coordinates around 1e5 px, with the depth clamp off
and on and three sample offsets. Then: padding and invalid rows carry empty
rectangles and every rectangle lies inside the padded surface; and the plain
walk with coverage masked by the rectangles (a CPU model of the culled
kernels) is bit-equal to the unculled plain walk for the eight compares,
with and without depth writes, and for the stencil (faces that differ) and
peel variants; so is the plain version itself, which resolves the
fragments over the rectangles at once where it can
(ops/raster.py::_resolve_fragments). Last, K1, K3 and K4 refuse a sample offset outside [0, 1)²,
which the rectangles do not cover. Tolerance: exact throughout.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from zenith_tpu_torch.ops import raster as raster_mod
from zenith_tpu_torch.ops.binning import TileGrid, bin_segmented, pixel_rects
from zenith_tpu_torch.ops.geometry import setup_with_attrs
from zenith_tpu_torch.ops.raster import raster_segmented
from zenith_tpu_torch.rhi.state import CompareOp, CullMode, StencilOp, StencilOpState

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 64
GRID = TileGrid(W, H, 8, 32)
HP, WP = GRID.tiles_y * GRID.tile_h, GRID.tiles_x * GRID.tile_w
OFFSETS = [(0.5, 0.5), (0.0, 0.0), (0.9375, 0.0625)]


def _clip(px, z, w=None):
    """Pixel coordinates (N, 2), depth (N,) and w (N,) → clip positions
    (N, 4) that the viewport maps back onto those pixels (W/2 and H/2 are
    powers of two, so lattice points land exactly)."""
    w = np.ones(px.shape[0]) if w is None else w
    ndc = px / [W / 2, H / 2] - 1.0
    return np.concatenate([ndc * w[:, None], (z * w)[:, None], w[:, None]], 1)


def crowded(rng, offset):
    """Three quarters tiny triangles crowding one corner, the rest small,
    mid-size and surface-wide (test_torch_binning.py's random scene)."""
    nt = 300
    centres = rng.uniform(-1.0, 1.0, (nt, 1, 2))
    centres[: 3 * nt // 4] = rng.uniform(-1.0, -0.8, (3 * nt // 4, 1, 2))
    size = rng.choice([0.05, 0.4, 2.5], p=[0.6, 0.3, 0.1], size=(nt, 1, 1))
    size[: 3 * nt // 4] = 0.02
    xy = (centres + rng.uniform(-1, 1, (nt, 3, 2)) * size).reshape(-1, 2)
    z = rng.uniform(-0.2, 1.2, 3 * nt)
    return np.concatenate([xy, z[:, None], np.ones((3 * nt, 1))], 1)


def near_clipped(rng, offset):
    """Triangles with one or two corners beyond the near plane (z > w) and a
    small w on another, so the clipped triangles reach thousands of pixels
    off-screen."""
    nt = 160
    px = rng.uniform(-0.2, 1.2, (3 * nt, 2)) * [W, H]
    z = rng.uniform(0.1, 0.9, 3 * nt)
    w = rng.uniform(0.5, 2.0, 3 * nt)
    tri = np.arange(nt)[: nt // 2] * 3
    z[tri] = rng.uniform(1.1, 3.0, tri.shape[0])  # beyond the near plane
    z[tri[::2] + 1] = rng.uniform(1.1, 3.0, tri[::2].shape[0])
    w[tri + 2] = rng.uniform(0.02, 0.1, tri.shape[0])
    px[tri + 2] = rng.uniform(-40, 40, (tri.shape[0], 2)) * [W, H]
    return _clip(px, z, w)


def slivers(rng, offset):
    """Needles 20-200 px long and 0.02-0.6 px thick at random angles, and
    along the axes and the diagonals."""
    nt = 200
    p0 = rng.uniform(0, 1, (nt, 2)) * [W, H]
    ang = rng.uniform(0, 2 * np.pi, nt)
    ang[::4] = rng.choice([0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4], nt // 4)
    d = np.stack([np.cos(ang), np.sin(ang)], 1)
    p1 = p0 + d * rng.uniform(20, 200, (nt, 1))
    p2 = (p0 + p1) / 2 + d[:, ::-1] * [1, -1] * rng.uniform(0.02, 0.6, (nt, 1))
    px = np.stack([p0, p1, p2], 1).reshape(-1, 2)
    return _clip(px, rng.uniform(0.1, 0.9, 3 * nt))


def sample_edges(rng, offset):
    """Triangles whose corners lie on sample points (pixel + offset): axis-
    aligned right triangles and random ones, so edges run through sample
    points, the AABB's extremes among them."""
    nt = 160
    base = rng.integers(-4, [W + 4, H + 4], (nt, 2)).astype(np.float64) + offset
    legs = rng.integers(1, 24, (nt, 2)) * rng.choice([-1, 1], (nt, 2))
    right = np.stack([base, base + legs * [1, 0], base + legs * [0, 1]], 1)
    other = base[:, None, :] + rng.integers(-20, 21, (nt, 3, 2))
    px = np.where((np.arange(nt) % 2 == 0)[:, None, None], right, other).reshape(-1, 2)
    return _clip(px, rng.uniform(0.1, 0.9, 3 * nt))


def far(rng, offset):
    """Triangles with one or two corners around 1e5 px off-screen and the
    others on it."""
    nt = 120
    px = rng.uniform(0, 1, (nt, 3, 2)) * [W, H]
    far_pt = rng.uniform(0.8e5, 1.2e5, (nt, 2)) * rng.choice([-1, 1], (nt, 2))
    px[:, 0] = far_pt
    px[::2, 1] = -far_pt[::2, ::-1]
    return _clip(px.reshape(-1, 2), rng.uniform(0.1, 0.9, 3 * nt))


SCENES = {"crowded": crowded, "near-clipped": near_clipped, "slivers": slivers,
          "sample-edges": sample_edges, "far": far}


def _bins(scene, seed, offset, clamp, a=2):
    """(records, bins) of ``scene`` through the port's setup and binning."""
    clip = SCENES[scene](np.random.default_rng(seed), np.asarray(offset))
    nv = clip.shape[0]
    idx = torch.arange(nv, dtype=torch.int32).reshape(-1, 3)
    vary = torch.from_numpy(np.random.default_rng(seed + 1).uniform(0, 1, (nv, a))).float()
    rec, corner = setup_with_attrs(torch.from_numpy(clip).float(), idx, vary, W, H,
                                   cull_mode=CullMode.NONE, depth_clamp=clamp)
    r = rec.rast16.shape[0]
    bins = bin_segmented(rec, corner, GRID, entry_budget=GRID.num_tiles * r)
    assert int(bins.overflow) == 0
    return rec, bins


def _pixels(walk):
    """Integer pixel coordinates of the walk's tiles: ((T, 1, tw), (T, th, 1))."""
    col = torch.arange(walk.tw)[None, None, :]
    row = torch.arange(walk.th)[None, :, None]
    return ((walk.order % walk.tx_n)[:, None, None] * walk.tw + col,
            (walk.order // walk.tx_n)[:, None, None] * walk.th + row)


def _inside(rect, x, y):
    return ((x >= rect[:, 0, None, None]) & (x <= rect[:, 2, None, None])
            & (y >= rect[:, 1, None, None]) & (y <= rect[:, 3, None, None]))


@pytest.mark.parametrize("clamp", [False, True], ids=["reject", "clamp"])
@pytest.mark.parametrize("offset", OFFSETS, ids=["centre", "corner", "skewed"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_rect_holds_every_covered_fragment(scene, offset, clamp):
    rec, bins = _bins(scene, 3, offset, clamp)
    walk = raster_mod._TileWalk.segmented(bins, GRID, CPU, offset)
    gx, gy = _pixels(walk)
    covered = outside = 0
    for j, (m, c) in enumerate(walk.ranks()):
        cov = raster_mod._fragments(c, walk.x[:m], walk.y[:m], clamp)[0]
        rect = bins.rect[walk.table[:m, j]]
        covered += int(cov.sum())
        outside += int((cov & ~_inside(rect, gx[:m], gy[:m])).sum())
    assert covered > 100  # the scene really covers fragments
    assert outside == 0


@pytest.mark.parametrize("scene", list(SCENES))
def test_rects_empty_for_padding_and_invalid_and_inside_surface(scene):
    rec, bins = _bins(scene, 5, (0.5, 0.5), False)
    rect = bins.rect
    assert rect.dtype == torch.int32 and rect.shape == (bins.rast_pad.shape[0], 4)
    chunk = rect.shape[0] // bins.blk_count.shape[0]
    live = (torch.arange(chunk)[None, :] < bins.blk_count[:, None].long()).reshape(-1)
    empty = torch.tensor([0, 0, -1, -1], dtype=torch.int32)
    assert bool((rect[~live] == empty).all())
    rl = rect[live]
    assert bool((rl[:, 0] <= rl[:, 2]).all() and (rl[:, 1] <= rl[:, 3]).all())
    assert bool((rl[:, :2] >= 0).all() and (rl[:, 2] < WP).all() and (rl[:, 3] < HP).all())
    per_rec = pixel_rects(rec, GRID)
    assert bool((per_rec[~rec.valid] == empty).all())
    if scene in ("near-clipped", "far"):
        # Clamping really happened: AABBs reach past the padded surface.
        a = rec.aabb[rec.valid]
        assert bool(((a[:, 0] < -1) | (a[:, 2] > WP) | (a[:, 1] < -1) | (a[:, 3] > HP)).any())


@contextlib.contextmanager
def culled(bins, stats):
    """The plain walk with every rank's coverage masked by its rows'
    rectangles: what the kernels' cull does, on the CPU. ``stats`` counts
    the (entry, pixel) pairs tested and those the rectangles drop."""
    real_ranks, real_fragments = raster_mod._TileWalk.ranks, raster_mod._fragments
    current = {}

    def ranks(walk):
        for j, (m, c) in enumerate(real_ranks(walk)):
            current["rect"] = bins.rect[walk.table[:m, j]]
            yield m, c

    def fragments(c, xm, ym, clamp):
        cov, *rest = real_fragments(c, xm, ym, clamp)
        keep = _inside(current["rect"], torch.floor(xm), torch.floor(ym))
        stats["pairs"] = stats.get("pairs", 0) + keep.expand_as(cov).numel()
        stats["dropped"] = stats.get("dropped", 0) + int((~keep.expand_as(cov)).sum())
        return (cov & keep, *rest)

    with mock.patch.object(raster_mod._TileWalk, "ranks", ranks), \
            mock.patch.object(raster_mod, "_fragments", fragments):
        yield


def _scene_bins(offset=(0.9375, 0.0625), clamp=False):
    """Crowded, near-clipped and sliver triangles in one draw."""
    clip = np.concatenate([f(np.random.default_rng(k), np.asarray(offset))
                           for k, f in enumerate((crowded, near_clipped, slivers))])
    nv = clip.shape[0]
    vary = torch.from_numpy(np.random.default_rng(9).uniform(0, 1, (nv, 3))).float()
    rec, corner = setup_with_attrs(torch.from_numpy(clip).float(),
                                   torch.arange(nv, dtype=torch.int32).reshape(-1, 3), vary, W, H,
                                   cull_mode=CullMode.NONE, depth_clamp=clamp)
    return bin_segmented(rec, corner, GRID, entry_budget=GRID.num_tiles * rec.rast16.shape[0])


def _init_z(seed=13):
    z = np.random.default_rng(seed).uniform(0.0, 1.0, (H, W)).astype(np.float32)
    z[:, : W // 2] = 0.5
    return torch.from_numpy(z)


def _assert_culled_equal(bins, offset, **kw):
    """The plain version, the unculled rank walk (bins without rectangles
    take it) and the culled walk model agree bit for bit."""
    full = raster_segmented(bins, GRID, _init_z(), sample_offset=offset, **kw)
    walked = raster_segmented(bins._replace(rect=None), GRID, _init_z(), sample_offset=offset,
                              **kw)
    stats = {}
    with culled(bins, stats):
        cull = raster_segmented(bins._replace(rect=None), GRID, _init_z(), sample_offset=offset,
                                **kw)
    assert stats["dropped"] > stats["pairs"] // 4  # the model really culls
    for a, b, c in zip(full, walked, cull):
        assert torch.equal(a, b) and torch.equal(b, c)
    return full


@pytest.mark.parametrize("depth_write", [True, False], ids=["write", "no-write"])
@pytest.mark.parametrize("compare", list(CompareOp), ids=[op.name for op in CompareOp])
def test_culled_walk_equals_plain(compare, depth_write):
    offset = (0.9375, 0.0625)
    full = _assert_culled_equal(_scene_bins(offset), offset, compare_op=compare,
                                depth_write=depth_write)
    if compare not in (CompareOp.NEVER, CompareOp.EQUAL):
        assert int((full[1][-1] > 0).sum()) > 100


def test_culled_walk_equals_plain_with_depth_clamp():
    _assert_culled_equal(_scene_bins((0.5, 0.5), clamp=True), (0.5, 0.5),
                         compare_op=CompareOp.GREATER, depth_clamp=True)


@pytest.mark.parametrize("masked", [False, True], ids=["stencil-write", "stencil-masked"])
def test_culled_stencil_walk_equals_plain(masked):
    """K3's model: faces that differ, ops that fire on stencil fail, depth
    fail and pass, under write masks; or a read-only compare mask."""
    bins = _scene_bins()
    if masked:
        front = StencilOpState(compare_op=CompareOp.EQUAL, reference=0x21, compare_mask=0x3F,
                               write_mask=0x00)
        back = StencilOpState(compare_op=CompareOp.NOT_EQUAL, reference=0x05, compare_mask=0x0F,
                              write_mask=0x00)
    else:
        front = StencilOpState(compare_op=CompareOp.ALWAYS, pass_op=StencilOp.REPLACE,
                               depth_fail_op=StencilOp.INCREMENT_AND_WRAP, reference=0x5A,
                               write_mask=0xF3)
        back = StencilOpState(compare_op=CompareOp.GREATER, fail_op=StencilOp.INVERT,
                              pass_op=StencilOp.DECREMENT_AND_CLAMP, reference=0x80,
                              write_mask=0xBF)
    s0 = torch.from_numpy(np.random.default_rng(17).integers(0, 256, (H, W)).astype(np.int32))
    full = _assert_culled_equal(bins, (0.9375, 0.0625), compare_op=CompareOp.GREATER,
                                init_stencil=s0, stencil_front=front, stencil_back=back)
    assert not torch.equal(full[2], s0) or masked


@pytest.mark.parametrize("compare", [CompareOp.LESS, CompareOp.GREATER_OR_EQUAL])
def test_culled_peel_walk_equals_plain(compare):
    """K4's model: the second layer behind the first, resolved by the plain
    walk."""
    offset = (0.9375, 0.0625)
    bins = _scene_bins(offset)
    clear = torch.full((H, W), 1.0 if compare == CompareOp.LESS else 0.0)
    z1, _ = raster_segmented(bins, GRID, clear, compare_op=compare, sample_offset=offset)
    full = raster_segmented(bins, GRID, clear, compare_op=compare, sample_offset=offset,
                            z_bound=z1)
    walk_bins = bins._replace(rect=None)
    walked = raster_segmented(walk_bins, GRID, clear, compare_op=compare, sample_offset=offset,
                              z_bound=z1)
    stats = {}
    with culled(bins, stats):
        cull = raster_segmented(walk_bins, GRID, clear, compare_op=compare,
                                sample_offset=offset, z_bound=z1)
    assert stats["dropped"] > stats["pairs"] // 4
    assert all(torch.equal(a, b) and torch.equal(b, c) for a, b, c in zip(full, walked, cull))
    assert int((full[1][-1] > 0).sum()) > 100  # a second layer exists


@pytest.mark.parametrize("offset", [(2.5, 0.5), (0.5, -1.5), (1.0, 0.0), (0.5, 0.99999999)],
                         ids=["x-2.5", "y-minus-1.5", "x-1", "y-rounds-to-1"])
def test_kernels_refuse_offsets_the_rects_do_not_hold(offset):
    """The rectangles hold a record's coverage only for sample offsets in
    [0, 1)² (as float32), so K1, K3 and K4 refuse any other before they
    build or launch; the plain version takes any offset."""
    _, bins = _bins("crowded", 5, (0.5, 0.5), False)
    z = _init_z()
    cmp = CompareOp.GREATER
    calls = {
        "K1": lambda: raster_mod._raster_segmented_cuda(bins, GRID, z, None, cmp, True, False,
                                                        offset),
        "K3": lambda: raster_mod._raster_stencil_cuda(bins, GRID, z, None, None, None, None, cmp,
                                                      True, False, offset),
        "K4": lambda: raster_mod._raster_peel_cuda(bins, GRID, z, None, z, CompareOp.LESS, cmp,
                                                   True, False, offset),
    }
    for name, call in calls.items():
        with mock.patch.object(raster_mod, "load_kernels", side_effect=AssertionError(name)):
            with pytest.raises(ValueError, match=f"{name} culls .* sample offset in"):
                call()
    rows = bins.rast_pad
    chunk = rows.shape[0] // bins.blk_count.shape[0]
    for ok in OFFSETS:
        assert raster_mod._check_rects(bins, rows, chunk, z, ok, "K1") is bins.rect
    z_plain, _ = raster_segmented(bins, GRID, z, compare_op=cmp, sample_offset=offset)
    assert z_plain.shape == z.shape
