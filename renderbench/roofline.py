"""The benchmark's yardstick for the raster and lighting kernels: the least
time the chip could take for the work a call's inputs need, and the busy
time of a set of device spans. Frozen here from the port's on-card check
script (``chip_smoke.py``: ``union_us``, ``bound``, ``count_fragments``,
``input_bytes``, ``k1_bound``, ``k2_lit_pairs``, ``k2_bound``), so that a
later change to the program cannot change how it is measured.

Bounds are the larger of bytes over the memory rate and float32 operations
over the float32 peak, counting the work the inputs need (fragments, lit
light-pixel pairs, the bins' live rows), not what the tiling makes the
kernels do."""

from __future__ import annotations

# Published H100 SXM peaks (NVIDIA's data sheet): device memory 3.35 TB/s,
# float32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# float32 operations K1 needs per fragment (an entry's pixel inside its
# triangle and depth range): three edge functions (12), the top-left tests
# (6), barycentrics (3), depth (5), range and depth compares (3); and per
# covered output pixel, the winner's a_n attribute planes (5 each). K2 per
# lit (light, pixel) pair: the light vector and window (~25), the GGX BRDF
# (~60), the cone (~14) and the weighted sum (~29).
K1_OPS_PER_FRAGMENT = 29
K1_OPS_PER_PIXEL_PLANE = 5
K2_OPS_PER_LIT_PAIR = 128


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(spans):
        if cur_e is None or a > cur_e:
            total += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def bound(nbytes: float, ops: float) -> "tuple[float, str]":
    """(least time in ms, what bounds it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def count_fragments(bins, grid, sample_offset=(0.5, 0.5), chunk: int = 2048) -> int:
    """The fragments of these bins: image pixels of an entry's tile that its
    triangle covers (edge functions with the top-left rule, as the
    rasterizer evaluates them from the entry's row) inside the depth range
    [0, 1]. Tensor ops on the bins' device, ``chunk`` entries at a time.

    A bin row holds the three edge functions (a, b, c) × 3, the three
    top-left flags, the inverse area and the three corner depths in its
    first 16 columns."""
    import torch

    rows = bins.rast_pad
    dev = rows.device
    nb = bins.blk_count.shape[0]
    per = rows.shape[0] // max(nb, 1)
    lane = torch.arange(per, device=dev)
    live = lane[None, :] < bins.blk_count.to(torch.int64)[:, None]
    ent_row = (torch.arange(nb, device=dev)[:, None] * per + lane[None, :])[live]
    ent_ty = bins.blk_tile_y.to(torch.int64)[:, None].expand(nb, per)[live]
    ent_tx = bins.blk_tile_x.to(torch.int64)[:, None].expand(nb, per)[live]
    th, tw = grid.tile_h, grid.tile_w
    col = torch.arange(tw, device=dev)[None, None, :]
    row = torch.arange(th, device=dev)[None, :, None]
    total = 0
    for s in range(0, ent_row.shape[0], chunk):
        c = rows[ent_row[s:s + chunk]][:, :16, None, None]
        px = ent_tx[s:s + chunk, None, None] * tw + col
        py = ent_ty[s:s + chunk, None, None] * th + row
        x = px.to(torch.float32) + sample_offset[0]
        y = py.to(torch.float32) + sample_offset[1]
        e01 = c[:, 0] * x + c[:, 1] * y + c[:, 2]
        e12 = c[:, 3] * x + c[:, 4] * y + c[:, 5]
        e20 = c[:, 6] * x + c[:, 7] * y + c[:, 8]
        cov = (((e01 > 0) | ((e01 == 0) & (c[:, 9] > 0)))
               & ((e12 > 0) | ((e12 == 0) & (c[:, 10] > 0)))
               & ((e20 > 0) | ((e20 == 0) & (c[:, 11] > 0))))
        z = (e12 * c[:, 12]) * c[:, 13] + (e20 * c[:, 12]) * c[:, 14] + (e01 * c[:, 12]) * c[:, 15]
        cov = cov & (z >= 0) & (z <= 1) & (px < grid.width) & (py < grid.height)
        total += int(cov.sum())
    return total


def input_bytes(bins) -> int:
    """The bytes of these bins a raster kernel must read: the rows of the
    live entries (a block's padding is never loaded) and the four routing
    tables."""
    live = int(bins.blk_count.sum())
    return 4 * (live * bins.rast_pad.shape[1] + 4 * bins.blk_count.shape[0])


def k1_bound(bins, grid, covered_px: int) -> "tuple[float, str, int]":
    """K1's bound on these bins: the live rows, the routing tables and the z
    plane read once; z and the a_n attribute planes written once; the edge
    and depth work of each fragment, and the winner's attributes at each of
    the ``covered_px`` pixels the pass covers. Returns (ms, what bounds it,
    fragments)."""
    a_n = (bins.rast_pad.shape[1] - 16) // 3
    hp, wp = grid.tiles_y * grid.tile_h, grid.tiles_x * grid.tile_w
    nbytes = input_bytes(bins) + 4 * (hp * wp + hp * wp + a_n * hp * wp)
    frags = count_fragments(bins, grid)
    ops = frags * K1_OPS_PER_FRAGMENT + covered_px * a_n * K1_OPS_PER_PIXEL_PLANE
    return (*bound(nbytes, ops), frags)


def k2_lit_pairs(depth, pos_emissive, lights, chunk: int = 8) -> int:
    """The (light, pixel) pairs these inputs light: covered pixels (depth >
    0) closer to the light than its radius. ``lights`` rows start with
    position and radius."""
    p = pos_emissive[..., :3][depth > 0]
    total = 0
    for s in range(0, lights.shape[0], chunk):
        lt = lights[s:s + chunk]
        d2 = ((p[None] - lt[:, None, :3]) ** 2).sum(-1)
        total += int((d2 < (lt[:, 3:4] ** 2)).sum())
    return total


def k2_bound(h: int, w: int, num_lights: int, lit_pairs: int) -> "tuple[float, str]":
    """K2's bound: three (H, W, 4) planes, the depth and the (L, 16) light
    table read once, the (H, W, 3) output written once; the BRDF work of
    each lit (light, pixel) pair."""
    nbytes = 4 * (3 * 4 * h * w + h * w + 16 * num_lights + 3 * h * w)
    return bound(nbytes, lit_pairs * K2_OPS_PER_LIT_PAIR)
