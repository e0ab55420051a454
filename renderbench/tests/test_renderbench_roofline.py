"""The yardstick's arithmetic on small hand-made bins: fragments, bytes,
operations and bounds of K1 and K2, and the busy time of device spans."""

from collections import namedtuple

import pytest
import torch

import roofline

Bins = namedtuple("Bins", "rast_pad blk_count blk_tile_y blk_tile_x")
Grid = namedtuple("Grid", "width height tile_h tile_w tiles_x tiles_y")


def edge_row(corners, zs, a_n=1):
    """One bin row for a screen-space triangle: the three edge functions
    (inside positive) with their top-left flags, the inverse area, the
    corner depths, then 3·a_n attribute columns."""
    (x0, y0), (x1, y1), (x2, y2) = corners
    sx, sy = [x0, x1, x2], [y0, y1, y2]
    det = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    s = 1.0 if det > 0 else -1.0
    row = []
    flags = []
    for a, b in ((0, 1), (1, 2), (2, 0)):
        ea = (sy[a] - sy[b]) * s
        eb = (sx[b] - sx[a]) * s
        row += [ea, eb, -(ea * sx[a] + eb * sy[a])]
        dx, dy = (sx[b] - sx[a]) * s, (sy[b] - sy[a]) * s
        flags.append(1.0 if (dy < 0 or (dy == 0 and dx > 0)) else 0.0)
    return row + flags + [1.0 / abs(det)] + list(zs) + [0.0] * (3 * a_n)


def make_bins(rows, tiles, per=4):
    """Blocks of ``per`` rows, one block per (tile_y, tile_x, rows) entry."""
    width = len(rows[0][0])
    pad, count, ty, tx = [], [], [], []
    for (y, x), block in zip(tiles, rows):
        pad += block + [[0.0] * width] * (per - len(block))
        count.append(len(block))
        ty.append(y)
        tx.append(x)
    return Bins(torch.tensor(pad, dtype=torch.float32), torch.tensor(count, dtype=torch.int32),
                torch.tensor(ty, dtype=torch.int32), torch.tensor(tx, dtype=torch.int32))


GRID = Grid(width=16, height=8, tile_h=8, tile_w=8, tiles_x=2, tiles_y=1)
TRI = [(0.0, 0.0), (6.0, 0.0), (0.0, 6.0)]


@pytest.mark.parametrize("order", [(0, 1, 2), (0, 2, 1)])
def test_fragments_of_a_right_triangle(order):
    """Pixel centres strictly inside x + y < 6 count (15); the six on the
    hypotenuse, a right edge, do not: whichever way the triangle winds."""
    corners = [TRI[i] for i in order]
    bins = make_bins([[edge_row(corners, (0.5, 0.5, 0.5))]], [(0, 0)])
    assert roofline.count_fragments(bins, GRID) == 15


def test_fragments_outside_the_depth_range_and_the_image():
    inside = edge_row(TRI, (0.5, 0.5, 0.5))
    behind = edge_row(TRI, (1.5, 1.5, 1.5))
    # The second tile's entry lies left of its own pixels: no fragment.
    bins = make_bins([[inside, behind], [inside]], [(0, 0), (0, 1)])
    assert roofline.count_fragments(bins, GRID) == 15
    clipped = Grid(width=3, height=8, tile_h=8, tile_w=8, tiles_x=1, tiles_y=1)
    assert roofline.count_fragments(make_bins([[inside]], [(0, 0)]), clipped) == 5 + 4 + 3


def test_input_bytes_count_live_rows_and_tables():
    row = edge_row(TRI, (0.5, 0.5, 0.5), a_n=2)
    bins = make_bins([[row, row], [row]], [(0, 0), (0, 1)], per=4)
    assert roofline.input_bytes(bins) == 4 * (3 * len(row) + 4 * 2)


def test_k1_bound_bytes_and_operations():
    row = edge_row(TRI, (0.5, 0.5, 0.5), a_n=2)
    bins = make_bins([[row]], [(0, 0)])
    ms, by, frags = roofline.k1_bound(bins, GRID, covered_px=15)
    assert frags == 15
    nbytes = roofline.input_bytes(bins) + 4 * (8 * 16) * (2 + 2)
    ops = 15 * roofline.K1_OPS_PER_FRAGMENT + 15 * 2 * roofline.K1_OPS_PER_PIXEL_PLANE
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / roofline.PEAK_BYTES_PER_S * 1e3)
    assert ops / roofline.PEAK_FP32_PER_S < nbytes / roofline.PEAK_BYTES_PER_S


def test_k2_lit_pairs_and_bound():
    depth = torch.tensor([[1.0, 0.5], [0.0, 0.2]])
    pos = torch.zeros((2, 2, 4))
    pos[0, 0, :3] = torch.tensor([0.0, 0.0, 0.0])
    pos[0, 1, :3] = torch.tensor([3.0, 0.0, 0.0])
    pos[1, 0, :3] = torch.tensor([0.0, 0.0, 0.0])  # uncovered
    pos[1, 1, :3] = torch.tensor([0.0, 5.0, 0.0])
    lights = torch.tensor([[0.0, 0.0, 0.0, 4.0], [10.0, 0.0, 0.0, 8.0]])
    # Light 0 reaches the pixels at 0 and 3 (not 5); light 1 the one at 3.
    assert roofline.k2_lit_pairs(depth, pos, lights) == 3
    ms, by = roofline.k2_bound(1080, 1920, 100, 31_323_652)
    assert by == "operations"
    assert ms == pytest.approx(31_323_652 * 128 / 67e12 * 1e3)
    ms, by = roofline.k2_bound(1080, 1920, 100, 0)
    assert by == "bytes"
    assert ms == pytest.approx(4 * (16 * 1080 * 1920 + 1600) / 3.35e12 * 1e3)


def test_union_of_spans():
    assert roofline.union_us([]) == 0.0
    assert roofline.union_us([(0, 10), (5, 15), (20, 30), (22, 25)]) == 25.0
    assert roofline.union_us([(3, 4), (0, 1)]) == 2.0


def test_bound_takes_the_larger_side():
    assert roofline.bound(3.35e12, 0.0) == (1e3, "bytes")
    assert roofline.bound(0.0, 67e12) == (1e3, "operations")
