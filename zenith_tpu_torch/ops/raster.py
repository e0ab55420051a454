"""Segmented raster pass over kernel K1 (torch port of
zenith_tpu/ops/raster.py::raster_segmented, plain branch).

For CUDA tensors ``raster_segmented`` launches K1, the hand-written CUDA
kernel in ``zenith_tpu_torch/csrc/raster.cu`` (its source note says what it
replaces and how it is laid out). For CPU tensors it runs
``_raster_segmented_torch``, the plain PyTorch version of the same
computation, which is also the kernel's oracle on the card. There is no
fallback between the two: a CUDA tensor launches the kernel or raises.

Triangles are processed strictly in submission order within a tile, so
depth-EQUAL ties and depth-write-off overdraw resolve exactly as a GPU's
fixed-function pipeline would.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from zenith_tpu_torch.ops.binning import SegmentedBins, TileGrid
from zenith_tpu_torch.ops.runtime import load_kernels, on_cuda
from zenith_tpu_torch.rhi.state import CompareOp

# Kernel encoding of the depth compare (csrc/raster.cu depth_compare).
_COMPARE_CODE = {
    CompareOp.NEVER: 0,
    CompareOp.LESS: 1,
    CompareOp.EQUAL: 2,
    CompareOp.LESS_OR_EQUAL: 3,
    CompareOp.GREATER: 4,
    CompareOp.NOT_EQUAL: 5,
    CompareOp.GREATER_OR_EQUAL: 6,
    CompareOp.ALWAYS: 7,
}

_MAX_TILE_PIXELS = 4096  # csrc/raster.cu: 256 threads x 16 pixels


def _compare(op: CompareOp, new: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    if op == CompareOp.NEVER:
        return torch.zeros_like(new, dtype=torch.bool)
    if op == CompareOp.LESS:
        return new < cur
    if op == CompareOp.EQUAL:
        return new == cur
    if op == CompareOp.LESS_OR_EQUAL:
        return new <= cur
    if op == CompareOp.GREATER:
        return new > cur
    if op == CompareOp.NOT_EQUAL:
        return new != cur
    if op == CompareOp.GREATER_OR_EQUAL:
        return new >= cur
    return torch.ones_like(new, dtype=torch.bool)


def raster_segmented(
    bins: SegmentedBins,
    grid: TileGrid,
    init_z: torch.Tensor,
    depth_test: bool = True,
    depth_write: bool = True,
    compare_op: CompareOp = CompareOp.GREATER,
    depth_clamp: bool = False,
    init_stencil: Optional[torch.Tensor] = None,
    stencil_front=None,
    stencil_back=None,
    sample_offset: "tuple[float, float]" = (0.5, 0.5),
    z_bound: Optional[torch.Tensor] = None,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Segmented-binning raster pass → (z (H, W), acc (A+2, H, W)).

    Tiles with no entries keep their seed: ``z`` starts as a copy of
    ``init_z`` and ``acc`` as zeros, and the pass updates both in place."""
    if z_bound is not None:
        raise NotImplementedError(
            "depth peeling (kernel K4) is not ported yet (ROADMAP item 20: "
            "translucency)"
        )
    if stencil_front is not None or init_stencil is not None:
        raise NotImplementedError(
            "the stencil raster (kernel K3) is not ported yet (ROADMAP item "
            "17: stencil)"
        )
    h, w = grid.height, grid.width
    th, tw = grid.tile_h, grid.tile_w
    hp, wp = grid.tiles_y * th, grid.tiles_x * tw
    d = bins.rast_pad.shape[-1] - 16
    if d % 3:
        raise ValueError(f"corner data has {d} columns, not 3 corners' worth")
    a_n = d // 3

    z = F.pad(init_z.to(torch.float32), (0, wp - w, 0, hp - h)).contiguous()
    if z.data_ptr() == init_z.data_ptr():
        z = z.clone()
    acc = torch.zeros((a_n, hp, wp), dtype=torch.float32, device=z.device)

    compare = compare_op if depth_test else CompareOp.ALWAYS
    write = depth_write and depth_test
    if on_cuda(z):
        _raster_segmented_cuda(bins, grid, z, acc, compare, write, depth_clamp, sample_offset)
    else:
        _raster_segmented_torch(bins, grid, z, acc, compare, write, depth_clamp, sample_offset)
    return z[:h, :w], acc[:, :h, :w]


raster_segmented.launches = 0  # K1 launches (counted in _raster_segmented_cuda)


def raster_segmented_blend(*args, **kwargs):
    """The in-order blending raster (kernels K5/K6, raster.py:766-985)."""
    raise NotImplementedError(
        "the blending raster (kernels K5/K6) is not ported yet (ROADMAP item "
        "20: translucency)"
    )


def _raster_segmented_cuda(bins, grid, z, acc, compare, write, clamp, sample_offset) -> None:
    """Launch K1 on the current stream; updates ``z`` and ``acc`` in place."""
    th, tw = grid.tile_h, grid.tile_w
    if th * tw > _MAX_TILE_PIXELS:
        raise ValueError(f"K1 takes tiles of at most {_MAX_TILE_PIXELS} pixels, got {th}x{tw}")
    routing = [bins.blk_tile_y, bins.blk_tile_x, bins.blk_count, bins.blk_init]
    rows = bins.rast_pad
    for t in routing:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != z.device:
            raise ValueError("K1 routing tables must be contiguous int32 on the z device")
    if rows.dtype != torch.float32 or not rows.is_contiguous() or rows.device != z.device:
        raise ValueError("K1 rows must be contiguous float32 on the z device")
    num_blocks = bins.blk_count.shape[0]
    chunk = rows.shape[0] // max(num_blocks, 1)
    a_n = acc.shape[0]
    lib = load_kernels()
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = lib.zn_raster_segmented(
        *[t.data_ptr() for t in routing],
        rows.data_ptr(), z.data_ptr(), acc.data_ptr(),
        num_blocks, chunk, rows.shape[1], a_n, z.shape[1], z.shape[0],
        th, tw, _COMPARE_CODE[compare], int(write), int(clamp),
        ctypes.c_float(sample_offset[0]), ctypes.c_float(sample_offset[1]),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    raster_segmented.launches += 1


def _raster_segmented_torch(bins, grid, z, acc, compare, write, clamp, sample_offset) -> None:
    """Plain PyTorch version of K1: walks entry rank j = 0, 1, … within
    each tile, vectorised across the tiles that still have an entry at rank
    j. Same rounded operations in the same order as the reference kernel,
    so the result is the kernel's bit for bit. Updates ``z``/``acc``."""
    dev = z.device
    th, tw = grid.tile_h, grid.tile_w
    ty_n, tx_n = grid.tiles_y, grid.tiles_x
    t = ty_n * tx_n
    a_n = acc.shape[0]
    rows = bins.rast_pad
    nb = bins.blk_count.shape[0]
    chunk = rows.shape[0] // max(nb, 1)

    # Entry table: per tile, its row indices in submission order.
    b = torch.arange(nb, device=dev)
    init = bins.blk_init.to(torch.int64) == 1
    first = torch.cummax(torch.where(init, b, torch.zeros_like(b)), 0).values
    tile_b = bins.blk_tile_y.to(torch.int64) * tx_n + bins.blk_tile_x.to(torch.int64)
    lane = torch.arange(chunk, device=dev)[None, :]
    live = lane < bins.blk_count.to(torch.int64)[:, None]
    ent_tile = tile_b[:, None].expand(nb, chunk)[live]
    ent_rank = ((b - first)[:, None] * chunk + lane)[live]
    ent_row = (b[:, None] * chunk + lane)[live]
    n_t = torch.bincount(ent_tile, minlength=t)
    max_n = int(n_t.max()) if t else 0
    if max_n == 0:
        return
    table = torch.full((t, max_n), -1, dtype=torch.int64, device=dev)
    table[ent_tile, ent_rank] = ent_row

    # Tiles by entry count, descending: the tiles active at rank j are a
    # prefix of this order.
    order = torch.sort(n_t, descending=True, stable=True).indices
    active = (n_t[order][None, :] > torch.arange(max_n, device=dev)[:, None]).sum(1).tolist()
    table = table[order]
    col = torch.arange(tw, device=dev)[None, None, :]
    row = torch.arange(th, device=dev)[None, :, None]
    x = ((order % tx_n)[:, None, None] * tw + col).to(torch.float32) + sample_offset[0]
    y = ((order // tx_n)[:, None, None] * th + row).to(torch.float32) + sample_offset[1]

    zt = z.view(ty_n, th, tx_n, tw).permute(0, 2, 1, 3).reshape(t, th, tw)[order]
    at = acc.view(a_n, ty_n, th, tx_n, tw).permute(1, 3, 0, 2, 4).reshape(t, a_n, th, tw)[order]

    for j, m in enumerate(active):
        r = rows[table[:m, j]]  # (m, 16 + 3·a_n)
        c = r[:, :, None, None]
        xm, ym = x[:m], y[:m]
        e01 = c[:, 0] * xm + c[:, 1] * ym + c[:, 2]
        e12 = c[:, 3] * xm + c[:, 4] * ym + c[:, 5]
        e20 = c[:, 6] * xm + c[:, 7] * ym + c[:, 8]
        cov = (
            ((e01 > 0.0) | ((e01 == 0.0) & (c[:, 9] > 0.0)))
            & ((e12 > 0.0) | ((e12 == 0.0) & (c[:, 10] > 0.0)))
            & ((e20 > 0.0) | ((e20 == 0.0) & (c[:, 11] > 0.0)))
        )
        inv_det = c[:, 12]
        w0 = e12 * inv_det
        w1 = e20 * inv_det
        w2 = e01 * inv_det
        zpx = w0 * c[:, 13] + w1 * c[:, 14] + w2 * c[:, 15]
        if clamp:
            zpx = torch.clamp(zpx, 0.0, 1.0)
        else:
            cov = cov & (zpx >= 0.0) & (zpx <= 1.0)
        zcur = zt[:m]
        passed = cov & _compare(compare, zpx, zcur)
        if write:
            zt[:m] = torch.where(passed, zpx, zcur)
        c0 = c[:, 16:16 + a_n]  # (m, a_n, 1, 1): the three corners' columns
        c1 = c[:, 16 + a_n:16 + 2 * a_n]
        c2 = c[:, 16 + 2 * a_n:16 + 3 * a_n]
        plane = w0[:, None] * c0 + w1[:, None] * c1 + w2[:, None] * c2
        at[:m] = torch.where(passed[:, None], plane, at[:m])

    zt_full = torch.empty_like(zt)
    zt_full[order] = zt
    at_full = torch.empty_like(at)
    at_full[order] = at
    z.copy_(zt_full.view(ty_n, tx_n, th, tw).permute(0, 2, 1, 3).reshape(z.shape))
    acc.copy_(at_full.view(ty_n, tx_n, a_n, th, tw).permute(2, 0, 3, 1, 4).reshape(acc.shape))
