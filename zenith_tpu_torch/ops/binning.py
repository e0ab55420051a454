"""Tile binning: triangle records → per-tile candidate lists (torch port
of zenith_tpu/ops/binning.py).

``bin_segmented`` (every draw) matches the reference entry for entry, so
bins compare across the two packages layout for layout: the three span
tiers, one global (tile, record) lexicographic order, CHUNK-aligned blocks
with per-block routing (``blk_tile_y``/``blk_tile_x``/``blk_count``/
``blk_init``) and the same overflow count. ``bin_triangles`` is the capped
binning of the second raster path (``raster.visibility_pass``,
``raster.raster_interp_pass``): per tile the first ``k`` overlapping records
in record order, the rest counted as overflow.

Deliberate divergences (ROADMAP §3): the reference clamps the entry budget
to what v5e SMEM can route and grows the chunk for huge budgets
(``RASTER_SMEM_BUDGET``, ``entry_chunk_for``, ``max_budget_for``); the port
keeps ``ENTRY_CHUNK`` fixed and takes the budget as given. The reference's
``jax.lax.top_k`` picks tied spans by lowest index; the port gets the same
pick from a stable descending sort, so mid/huge-tier overflow drops the same
records. Both binnings add a trailing field beside the reference's, the
kernels' cull aid: each row's or slot's pixel rectangle (``rect``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from zenith_tpu_torch.ops.geometry import TriangleRecords
from zenith_tpu_torch.ops.runtime import cdiv

ENTRY_CHUNK = 128  # entries per kernel block


@dataclass(frozen=True)
class TileGrid:
    """Static tiling configuration (part of the frame-function key)."""

    width: int
    height: int
    tile_h: int = 32
    tile_w: int = 128

    @property
    def tiles_x(self) -> int:
        return cdiv(self.width, self.tile_w)

    @property
    def tiles_y(self) -> int:
        return cdiv(self.height, self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


class TileBins(NamedTuple):
    """Per-tile candidate lists of a fixed capacity K (``bin_triangles``).

    ``rect`` is the kernels' cull aid, not part of the reference's layout:
    per slot its record's ``pixel_rects`` rectangle (x0, y0, x1, y1), empty
    (0, 0, -1, -1) for pad slots. K7 and K8 need it on CUDA tensors; the
    plain versions ignore it."""

    binned_rast: torch.Tensor  # (T, K, 16) f32 — gathered raster records (pad 0)
    binned_slot: torch.Tensor  # (T, K) i32 — global record indices (pad -1)
    counts: torch.Tensor  # (T,) i32 — live entries, at most K
    overflow: torch.Tensor  # () i32 — records dropped by the K cap
    rect: Optional[torch.Tensor] = None  # (T, K, 4) i32 — per-slot pixel rectangle

    def gather_corner_data(self, corner_data: torch.Tensor) -> torch.Tensor:
        """Per-record corner data, flat (R, 3·D) or (R, 3, D), in per-tile
        order (T, K, 3·D) for the interp pass (binning.py:60-71); pad slots
        are 0, so their iw is 0 and they never win a pixel."""
        r = corner_data.shape[0]
        flat = corner_data.reshape(r, -1)
        g = flat[torch.clamp(self.binned_slot, 0, r - 1).to(torch.int64)]
        return g.masked_fill_(self.binned_slot[..., None] < 0, 0.0)


class SegmentedBins(NamedTuple):
    """Per-tile variable-length candidate segments, block-aligned for the
    segmented raster kernel (no per-tile capacity cap).

    A tile's blocks are consecutive and each holds at least one entry;
    blocks with ``blk_count`` 0 are dead and lie past every live block.
    ``rect`` is the kernels' cull aid, not part of the reference's layout:
    per row an inclusive pixel rectangle (x0, y0, x1, y1) that holds every
    pixel the row's triangle can cover, empty (0, 0, -1, -1) for padding
    rows. K1, K3 and K4 need it on CUDA tensors; the plain versions ignore
    it."""

    blk_tile_y: torch.Tensor  # (B,) i32
    blk_tile_x: torch.Tensor  # (B,) i32
    blk_count: torch.Tensor  # (B,) i32 — live entries in this block
    blk_init: torch.Tensor  # (B,) i32 — 1 on a tile's first block
    rast_pad: torch.Tensor  # (B*CHUNK, 16 + D) f32 — merged rast16 | corner rows
    attr_pad: torch.Tensor  # (0,) f32 — folded into rast_pad, as in the reference
    overflow: torch.Tensor  # () i32 — entries dropped (budget/span caps)
    rect: Optional[torch.Tensor] = None  # (B*CHUNK, 4) i32 — per-row pixel rectangle


def _top_k_indices(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values, ties by lowest index — the order
    ``jax.lax.top_k`` guarantees (``torch.topk`` promises none)."""
    return torch.sort(values, descending=True, stable=True).indices[:k]


def _tile_ranges(records: TriangleRecords, grid: TileGrid):
    """Each record's conservative tile rectangle from its AABB, clipped to
    the grid: (tx0, tx1, ty0, ty1), each (R,) i32."""
    xmin, ymin, xmax, ymax = (records.aabb[:, i] for i in range(4))

    def tiles(v, size, n):
        return torch.clamp(torch.floor(v / size), 0, n - 1).to(torch.int32)

    return (tiles(xmin, grid.tile_w, grid.tiles_x), tiles(xmax, grid.tile_w, grid.tiles_x),
            tiles(ymin, grid.tile_h, grid.tiles_y), tiles(ymax, grid.tile_h, grid.tiles_y))


def pixel_rects(records: TriangleRecords, grid: TileGrid) -> torch.Tensor:
    """Each record's inclusive pixel rectangle (R, 4) i32: x0, y0, x1, y1.

    It holds every pixel whose sample point, for any offset in [0, 1)²,
    lies within one pixel of the record's vertex AABB: floor/ceil of the
    AABB widened by one pixel, clamped to the padded surface before the
    int cast (a near-clipped record's AABB reaches far outside it). A
    sample point inside the triangle lies inside its AABB; coverage beyond
    it could come only from the rounding of the edge coefficients, orders
    of magnitude below a pixel at the coordinates a valid record has.
    Invalid records get the empty rectangle (0, 0, -1, -1)."""
    return _or_empty(_pixel_boxes(records, grid), records.valid)


def _pixel_boxes(records: TriangleRecords, grid: TileGrid) -> torch.Tensor:
    """``pixel_rects`` without the validity mask."""
    hp, wp = grid.tiles_y * grid.tile_h, grid.tiles_x * grid.tile_w
    box = torch.cat([torch.floor(records.aabb[:, :2]) - 1.0,
                     torch.ceil(records.aabb[:, 2:]) + 1.0], dim=1)
    box[:, 0::2].clamp_(0, wp - 1)
    box[:, 1::2].clamp_(0, hp - 1)
    return box.to(torch.int32)


def _or_empty(rect: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``rect`` (..., 4) where ``keep`` (...), else the empty rectangle
    (0, 0, -1, -1)."""
    empty = torch.zeros_like(rect)
    empty[..., 2:] = -1
    return torch.where(keep[..., None], rect, empty)


def _row_rects(records: TriangleRecords, grid: TileGrid, rec_l: torch.Tensor,
               src_ok: torch.Tensor) -> torch.Tensor:
    """The rectangle of each binned row's record (12 launches); padding rows
    get the empty one. Binned rows only hold valid records."""
    return _or_empty(_pixel_boxes(records, grid)[rec_l], src_ok)


def tile_overlap(records: TriangleRecords, grid: TileGrid) -> torch.Tensor:
    """The (T, R) mask of valid records whose tile rectangle holds each
    tile; its row sums are the per-tile counts before any cap."""
    t = grid.num_tiles
    tx0, tx1, ty0, ty1 = _tile_ranges(records, grid)
    tile = torch.arange(t, dtype=torch.int32, device=records.aabb.device)
    tile_tx = (tile % grid.tiles_x)[:, None]
    tile_ty = (tile // grid.tiles_x)[:, None]
    return (records.valid[None, :] & (tile_tx >= tx0[None, :]) & (tile_tx <= tx1[None, :])
            & (tile_ty >= ty0[None, :]) & (tile_ty <= ty1[None, :]))


def bin_triangles(records: TriangleRecords, grid: TileGrid, k: int) -> TileBins:
    """Bin valid records into per-tile lists of capacity ``k``
    (binning.py:398-438): the first ``k`` overlapping records of each tile
    in record order (an ascending sort of the masked record indices), pad
    slots -1 with zero rows; ``overflow`` counts the records past ``k``.
    Builds the dense (T, R) mask and sorts it row by row. Beyond the
    reference's fields, each slot carries its record's ``pixel_rects``
    rectangle (``rect``), gathered like the rows; pad slots get the empty
    one."""
    r = records.rast16.shape[0]
    t = grid.num_tiles
    dev = records.rast16.device
    mask = tile_overlap(records, grid)
    counts = mask.sum(dim=1).to(torch.int32)
    overflow = torch.clamp(counts - k, min=0).sum().to(torch.int32)

    order = torch.arange(r, dtype=torch.int32, device=dev)[None, :]
    keys = torch.where(mask, order, torch.full_like(order, r))
    del mask
    packed = torch.sort(keys, dim=1).values[:, :k]  # (T, min(k, R))
    del keys
    if packed.shape[1] < k:  # fewer records than the capacity: sentinel pads
        packed = torch.cat([packed, torch.full((t, k - packed.shape[1]), r, dtype=torch.int32,
                                               device=dev)], dim=1)
    pad = packed >= r
    slot = torch.where(pad, torch.full_like(packed, -1), packed)
    rec = torch.clamp(packed, 0, r - 1).to(torch.int64)
    binned_rast = records.rast16[rec]
    binned_rast.masked_fill_(pad[..., None], 0.0)
    rect = _or_empty(_pixel_boxes(records, grid)[rec], ~pad)
    return TileBins(binned_rast, slot, torch.clamp(counts, max=k), overflow, rect)


def bin_segmented(
    records: TriangleRecords,
    corner_data: torch.Tensor,  # (R, 3·(A+2)) flat, from the geometry stage
    grid: TileGrid,
    span_cap: int = 4,
    mid_cap: int = 4096,
    mid_span: int = 32,
    huge_cap: int = 256,
    entry_budget: "int | None" = None,
    budget_scale: int = 1,
) -> SegmentedBins:
    """Exact, uncapped-per-tile binning in three span tiers
    (binning.py:160-395): records spanning ≤ span_cap tiles expand at width
    span_cap; up to mid_cap records spanning ≤ mid_span tiles are compacted
    then expanded at width mid_span; up to huge_cap larger records take a
    dense per-tile mask. All tiers merge in one (tile, record) sort, which
    keeps submission order within every tile. ``entry_budget`` bounds the
    (tile, record) pairs per draw (default 2×R, min 8192); overflow is
    counted. Beyond the reference's fields, each row carries its record's
    ``pixel_rects`` rectangle (``rect``), gathered like the rows."""
    r = records.rast16.shape[0]
    t = grid.num_tiles
    tiles_x = grid.tiles_x
    dev = records.rast16.device
    rast16 = records.rast16
    valid = records.valid
    corner_flat = corner_data.reshape(r, -1)

    if entry_budget is None:
        entry_budget = max(2 * r, 8192)
    entry_budget = int(entry_budget) * max(int(budget_scale), 1)
    chunk = ENTRY_CHUNK
    # +T: every tile rounds its segment up to a whole block.
    b_max = cdiv(entry_budget, chunk) + t

    def i32(x):
        return x.to(torch.int32)

    tx0, tx1, ty0, ty1 = _tile_ranges(records, grid)
    sx = tx1 - tx0 + 1
    sy = ty1 - ty0 + 1
    span = sx * sy

    small = valid & (span <= span_cap)
    mid = valid & (span > span_cap) & (span <= mid_span)
    huge = valid & (span > mid_span)

    def expand(tx0_, ty0_, sx_, span_, live, width):
        """(K, width) tile/valid expansion of per-record tile rectangles;
        dy = floor(j / sx) in f32, as the reference computes it."""
        jj = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
        jf = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
        dy = i32(torch.floor(jf / sx_[:, None].to(torch.float32)))
        ty_e = ty0_[:, None] + dy
        tx_e = tx0_[:, None] + (jj - dy * sx_[:, None])
        tile_e = ty_e * tiles_x + tx_e
        ev = live[:, None] & (jj < span_[:, None])
        return tile_e, ev

    # Tier 1: every record, narrow width.
    tile_small, ev_small = expand(tx0, ty0, sx, span, small, span_cap)
    rec_small = torch.arange(r, dtype=torch.int32, device=dev)[:, None].expand(r, span_cap)

    zero = torch.zeros_like(span)
    # Tier 2: compact mid-span records, then expand wide.
    k_mid = min(mid_cap, r)
    midx = _top_k_indices(torch.where(mid, span, zero), k_mid)
    mvalid = mid[midx]
    mid_dropped = mid.sum() - mvalid.sum()
    tile_mid, ev_mid = expand(tx0[midx], ty0[midx], sx[midx], span[midx], mvalid, mid_span)
    rec_mid = i32(midx)[:, None].expand(k_mid, mid_span)

    # Tier 3: huge records → dense per-tile mask over the top huge_cap.
    hidx = _top_k_indices(torch.where(huge, span, zero), min(huge_cap, r))
    hvalid = huge[hidx]
    huge_dropped = huge.sum() - hvalid.sum()
    t_ids = torch.arange(t, dtype=torch.int32, device=dev)
    t_ty = t_ids // tiles_x
    t_tx = t_ids % tiles_x
    hmask = (
        hvalid[:, None]
        & (t_tx[None, :] >= tx0[hidx][:, None])
        & (t_tx[None, :] <= tx1[hidx][:, None])
        & (t_ty[None, :] >= ty0[hidx][:, None])
        & (t_ty[None, :] <= ty1[hidx][:, None])
    )  # (H, T)
    tile_huge = t_ids[None, :].expand(hmask.shape)
    rec_huge = i32(hidx)[:, None].expand(hmask.shape)

    # Merge + lexicographic (tile, record) order: one stable sort on the
    # int64 key tile·R + rec. Invalid entries get tile = t (sort last).
    big = torch.full_like(tile_small, t)
    tiles_all = torch.cat([
        torch.where(ev_small, tile_small, big).reshape(-1),
        torch.where(ev_mid, tile_mid, torch.full_like(tile_mid, t)).reshape(-1),
        torch.where(hmask, tile_huge, torch.full_like(tile_huge, t)).reshape(-1),
    ])
    recs_all = torch.cat([rec_small.reshape(-1), rec_mid.reshape(-1), rec_huge.reshape(-1)])
    key = tiles_all.to(torch.int64) * max(r, 1) + recs_all.to(torch.int64)
    order = torch.sort(key, stable=True).indices
    tiles_sorted = tiles_all[order].contiguous()
    recs_sorted = recs_all[order]

    # Per-tile segments + block table. Tiles with no candidates get no
    # blocks: the raster pass updates pre-seeded outputs in place.
    seg_off = i32(torch.searchsorted(
        tiles_sorted, torch.arange(t + 1, dtype=torch.int32, device=dev)
    ))
    counts = seg_off[1:] - seg_off[:-1]
    n_blocks = -(-counts // chunk)
    blk_off = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=dev),
        i32(torch.cumsum(n_blocks, 0)),
    ])
    total_blocks = blk_off[-1]
    block_overflow = torch.clamp(total_blocks - b_max, min=0)

    b = torch.arange(b_max, dtype=torch.int32, device=dev)
    tile_of_b = i32(torch.clamp(
        torch.searchsorted(blk_off, b, right=True) - 1, 0, t - 1
    ))
    # Dead blocks (past the real total) route to the LAST LIVE tile with
    # count 0, so a walk over a tile's blocks passes them harmlessly.
    live_b = b < total_blocks
    last_live_tile = torch.amax(torch.where(counts > 0, t_ids, torch.zeros_like(t_ids)))
    tile_of_b = torch.where(live_b, tile_of_b, last_live_tile)
    tile_of_b_l = tile_of_b.to(torch.int64)
    j_b = b - blk_off[tile_of_b_l]
    cnt_tile = counts[tile_of_b_l]
    blk_count = i32(torch.where(
        live_b, torch.clamp(cnt_tile - j_b * chunk, 0, chunk), torch.zeros_like(b)
    ))
    # First live block of each tile initializes the tile; an empty draw
    # still initializes block 0.
    blk_init = i32(((j_b == 0) & live_b) | ((b == 0) & (total_blocks == 0)))

    # Block-aligned entry gather: record index per padded row.
    lane = torch.arange(chunk, dtype=torch.int32, device=dev)[None, :]
    src_b = (seg_off[tile_of_b_l] + j_b * chunk)[:, None] + lane
    src_ok = (lane < blk_count[:, None]).reshape(-1)
    src = src_b.reshape(-1)
    n_sorted = recs_sorted.shape[0]
    rec_idx = torch.where(
        src_ok,
        recs_sorted[torch.clamp(src, 0, n_sorted - 1).to(torch.int64)],
        torch.zeros_like(src),
    )

    # One merged (rast16 | corner-data) row per entry.
    merged = torch.cat([rast16, corner_flat.to(torch.float32)], dim=1)
    rec_l = rec_idx.to(torch.int64)
    rows = merged[rec_l]
    rows = torch.where(src_ok[:, None], rows, torch.zeros_like(rows))
    rect = _row_rects(records, grid, rec_l, src_ok)

    overflow = huge_dropped + mid_dropped + block_overflow * chunk
    return SegmentedBins(
        t_ty[tile_of_b_l],
        t_tx[tile_of_b_l],
        blk_count,
        blk_init,
        rows,
        torch.zeros((0,), dtype=torch.float32, device=dev),
        i32(overflow),
        rect,
    )
