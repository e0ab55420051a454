"""Raster passes over the hand-written kernels K1 and K3-K8 (torch port of
zenith_tpu/ops/raster.py).

``raster_segmented`` resolves one winning fragment per pixel: plain (K1), with
a stencil plane (K3) or with a depth-peel bound plane (K4).
``raster_segmented_blend`` shades and blends every passing fragment in
submission order against carried colour planes (K5), optionally with the
stencil plane (K6). ``visibility_pass`` (K7) and ``raster_interp_pass`` (K8)
are the reference's second, independently structured path over the capped
bins of ``binning.bin_triangles``: per pixel the winning record's slot, or
its interpolated planes. For CUDA tensors each launches its kernel
(``zenith_tpu_torch/csrc/raster.cu``, ``raster_blend.cu`` and
``raster_capped.cu``; their source notes say what they replace and how they
are laid out). For CPU tensors each runs the plain PyTorch version beside it
(``_raster_segmented_torch``, ``_raster_blend_torch``, ``_visibility_torch``,
``_interp_torch``), which is also the kernel's oracle on the card. There is
no fallback between the two: a CUDA tensor launches the kernel or raises.
The plain versions walk each tile's entries rank by rank, as the kernels
do; without stencil, bins that carry their pixel rectangles resolve the
same fragments at once instead (``_resolve_fragments``, bit-equal to the
walk). The card's checks give the plain version bins without rectangles,
so that the oracle culls nothing.

Agreement of kernel and plain version on the card: z, coverage, stencil,
slot and the attribute planes of K1, K3, K4, K7 and K8 are bit-equal; the
colour of K5 and K6 holds to atol 1e-5 + rtol 1e-5 (the shader and the
blend equation are compiled with FMA contraction off, so in practice they
agree to the last bit; the tolerance is the reference's own between its
batched and its sequential blending).

Triangles are processed strictly in submission order within a tile, so
depth-EQUAL ties, depth-write-off overdraw and order-dependent blending
resolve exactly as a GPU's fixed-function pipeline would.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from zenith_tpu_torch.ops.binning import ENTRY_CHUNK, SegmentedBins, TileBins, TileGrid
from zenith_tpu_torch.ops.runtime import count_launch, load_blend_kernel, load_kernels, on_cuda
from zenith_tpu_torch.rhi.state import (
    BlendFactor,
    BlendOp,
    ColorAttachmentDesc,
    CompareOp,
    StencilOp,
    StencilOpState,
)

# Kernel encoding of the depth compare (csrc/raster_common.cuh depth_compare).
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
# Kernel encodings of the stencil ops (raster_common.cuh stencil_apply) and of
# the blend equation (raster_blend.cu BlendState).
_STENCIL_OP_CODE = {op: i for i, op in enumerate(StencilOp)}
_BLEND_FACTOR_CODE = {f: i for i, f in enumerate(BlendFactor)}
_BLEND_OP_CODE = {op: i for i, op in enumerate(BlendOp)}


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


def _stencil_apply(op: StencilOp, s: torch.Tensor, reference: int) -> torch.Tensor:
    """One VkStencilOp over an int32 stencil plane (8-bit semantics)."""
    if op == StencilOp.KEEP:
        return s
    if op == StencilOp.ZERO:
        return torch.zeros_like(s)
    if op == StencilOp.REPLACE:
        return torch.full_like(s, reference & 0xFF)
    if op == StencilOp.INCREMENT_AND_CLAMP:
        return torch.clamp(s + 1, max=255)
    if op == StencilOp.DECREMENT_AND_CLAMP:
        return torch.clamp(s - 1, min=0)
    if op == StencilOp.INVERT:
        return ~s & 0xFF
    if op == StencilOp.INCREMENT_AND_WRAP:
        return (s + 1) & 0xFF
    if op == StencilOp.DECREMENT_AND_WRAP:
        return (s - 1) & 0xFF
    raise ValueError(op)


def _stencil_face_test(face: StencilOpState, cov: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The stencil test of one face: ``reference & compare_mask`` against
    ``stored & compare_mask``."""
    ref_m = (face.reference & face.compare_mask) & 0xFF
    s_m = s & (face.compare_mask & 0xFF)
    return cov & _compare(face.compare_op, torch.full_like(s_m, ref_m), s_m)


def _stencil_face_update(face: StencilOpState, cov, spass, dpass, s):
    """Post-test stencil write for one face state (Vulkan 27.19): stencil
    fail → fail_op, depth fail → depth_fail_op, pass → pass_op, each under
    write_mask."""
    ref = face.reference
    out = s
    out = torch.where(cov & ~spass, _stencil_apply(face.fail_op, s, ref), out)
    out = torch.where(spass & ~dpass, _stencil_apply(face.depth_fail_op, s, ref), out)
    out = torch.where(dpass, _stencil_apply(face.pass_op, s, ref), out)
    wmask = face.write_mask & 0xFF
    if wmask == 0xFF:
        return out
    return (s & ~wmask) | (out & wmask)


def _stencil_step(front, back, is_front, cov, depth_ok, s):
    """Stencil test → depth test → stencil write for one rank of fragments;
    ``is_front`` (broadcastable bool) picks the face when the two differ.
    Returns (dpass, new stencil)."""
    if front == back:
        spass = _stencil_face_test(front, cov, s)
        dpass = spass & depth_ok
        return dpass, _stencil_face_update(front, cov, spass, dpass, s)
    spass_f = _stencil_face_test(front, cov, s)
    spass_b = _stencil_face_test(back, cov, s)
    dpass = torch.where(is_front, spass_f, spass_b) & depth_ok
    snew_f = _stencil_face_update(front, cov, spass_f, dpass, s)
    snew_b = _stencil_face_update(back, cov, spass_b, dpass, s)
    return dpass, torch.where(is_front, snew_f, snew_b)


def _face_codes(front: StencilOpState, back: StencilOpState):
    """The two faces as the 14 host ints the stencil kernels take."""
    vals = []
    for f in (front, back):
        vals += [_COMPARE_CODE[f.compare_op], _STENCIL_OP_CODE[f.fail_op],
                 _STENCIL_OP_CODE[f.depth_fail_op], _STENCIL_OP_CODE[f.pass_op],
                 int(f.reference), int(f.compare_mask), int(f.write_mask)]
    return (ctypes.c_int * 14)(*vals)


def _bound_op(compare_op: CompareOp) -> CompareOp:
    """The depth-peel bound compare: the strict opposite of the depth
    compare."""
    if compare_op in (CompareOp.GREATER, CompareOp.GREATER_OR_EQUAL):
        return CompareOp.LESS
    if compare_op in (CompareOp.LESS, CompareOp.LESS_OR_EQUAL):
        return CompareOp.GREATER
    raise ValueError(
        f"depth peeling needs an ordering depth compare (GREATER/GEQ/LESS/LEQ), got {compare_op}"
    )


def _pad_plane(t: torch.Tensor, h: int, w: int, hp: int, wp: int, dtype) -> torch.Tensor:
    """``t`` (H, W) as a fresh contiguous (hp, wp) plane of ``dtype``."""
    out = F.pad(t.to(dtype), (0, wp - w, 0, hp - h)).contiguous()
    return out.clone() if out.data_ptr() == t.data_ptr() else out


def raster_segmented(
    bins: SegmentedBins,
    grid: TileGrid,
    init_z: torch.Tensor,
    depth_test: bool = True,
    depth_write: bool = True,
    compare_op: CompareOp = CompareOp.GREATER,
    depth_clamp: bool = False,
    init_stencil: Optional[torch.Tensor] = None,
    stencil_front: Optional[StencilOpState] = None,
    stencil_back: Optional[StencilOpState] = None,
    sample_offset: "tuple[float, float]" = (0.5, 0.5),
    z_bound: Optional[torch.Tensor] = None,
) -> "tuple[torch.Tensor, ...]":
    """Segmented-binning raster pass → (z (H, W), acc (A+2, H, W)), plus the
    updated (H, W) int32 stencil plane when ``stencil_front`` is given.

    Tiles with no entries keep their seed: ``z`` starts as a copy of
    ``init_z`` and ``acc`` as zeros, and the pass updates both in place.

    ``z_bound`` switches on depth peeling: fragments not strictly behind the
    bound plane (the previous peel's resolved depth) are rejected before the
    depth test, so the pass resolves the next-nearest layer. It needs an
    ordering depth compare with the depth test on and cannot combine with
    stencil; fragments exactly at the bound are rejected."""
    h, w = grid.height, grid.width
    th, tw = grid.tile_h, grid.tile_w
    hp, wp = grid.tiles_y * th, grid.tiles_x * tw
    d = bins.rast_pad.shape[-1] - 16
    if d % 3:
        raise ValueError(f"corner data has {d} columns, not 3 corners' worth")
    a_n = d // 3

    z = _pad_plane(init_z, h, w, hp, wp, torch.float32)
    acc = torch.zeros((a_n, hp, wp), dtype=torch.float32, device=z.device)

    compare = compare_op if depth_test else CompareOp.ALWAYS
    write = depth_write and depth_test
    if z_bound is not None:
        if stencil_front is not None:
            raise ValueError("depth peeling cannot combine with stencil")
        if not depth_test:
            raise ValueError("depth peeling requires the depth test")
        bound_op = _bound_op(compare_op)
        bound = _pad_plane(z_bound, h, w, hp, wp, torch.float32)
        if on_cuda(z):
            _raster_peel_cuda(bins, grid, z, acc, bound, bound_op, compare, write,
                              depth_clamp, sample_offset)
        else:
            _raster_segmented_torch(bins, grid, z, acc, compare, write, depth_clamp,
                                    sample_offset, z_bound=bound, bound_op=bound_op)
        return z[:h, :w], acc[:, :h, :w]
    if stencil_front is not None:
        back = stencil_back if stencil_back is not None else stencil_front
        if init_stencil is None:
            init_stencil = torch.zeros((h, w), dtype=torch.int32, device=z.device)
        sten = _pad_plane(init_stencil, h, w, hp, wp, torch.int32)
        if on_cuda(z):
            _raster_stencil_cuda(bins, grid, z, acc, sten, stencil_front, back, compare, write,
                                 depth_clamp, sample_offset)
        else:
            _raster_segmented_torch(bins, grid, z, acc, compare, write, depth_clamp,
                                    sample_offset, stencil=sten, faces=(stencil_front, back))
        return z[:h, :w], acc[:, :h, :w], sten[:h, :w]
    if on_cuda(z):
        _raster_segmented_cuda(bins, grid, z, acc, compare, write, depth_clamp, sample_offset)
    else:
        _raster_segmented_torch(bins, grid, z, acc, compare, write, depth_clamp, sample_offset)
    return z[:h, :w], acc[:, :h, :w]


# Launches of K1, K3 and K4, each counted where its kernel is launched.
raster_segmented.launches = 0
raster_segmented.stencil_launches = 0
raster_segmented.peel_launches = 0


def raster_segmented_blend(
    bins: SegmentedBins,
    grid: TileGrid,
    init_z: torch.Tensor,  # (H, W)
    init_color: torch.Tensor,  # (H, W, 4)
    shade_blend: Callable,
    depth_test: bool = True,
    depth_write: bool = False,
    compare_op: CompareOp = CompareOp.GREATER,
    depth_clamp: bool = False,
    sample_offset: "tuple[float, float]" = (0.5, 0.5),
    init_stencil: Optional[torch.Tensor] = None,
    stencil_front: Optional[StencilOpState] = None,
    stencil_back: Optional[StencilOpState] = None,
    fragment_shader=None,
    attr_layout=None,
    color_desc: Optional[ColorAttachmentDesc] = None,
) -> "tuple[torch.Tensor, ...]":
    """Order-correct blending raster pass → (z (H, W), color (H, W, 4)), plus
    the updated stencil plane when ``stencil_front`` is given.

    ``shade_blend(planes, passed, x, y, zpx, color)`` is the plain version's
    shader + blend step (ops.draw.make_shade_blend builds it): ``planes``
    (M, A+2, th, tw) interpolated attr·(1/w) planes of M tiles' fragments at
    one rank, ``passed`` (M, th, tw), ``color`` (M, th, tw, 4) → new colour.
    CUDA tensors do not use it: they need the kernel-safe
    ``fragment_shader`` with its device source, the ``attr_layout`` of the
    record columns (1/w not included) and the ``color_desc`` whose blend
    equation applies, and launch K5 (K6 with stencil) compiled for that
    shader. Like K1 they cull by the bins' per-row pixel rectangles, so they
    need ``SegmentedBins.rect`` and a sample offset in [0, 1)²."""
    h, w = grid.height, grid.width
    th, tw = grid.tile_h, grid.tile_w
    hp, wp = grid.tiles_y * th, grid.tiles_x * tw
    compare = compare_op if depth_test else CompareOp.ALWAYS
    write = depth_write and depth_test

    z = _pad_plane(init_z, h, w, hp, wp, torch.float32)
    color = F.pad(init_color.to(torch.float32), (0, 0, 0, wp - w, 0, hp - h)).contiguous()
    if color.data_ptr() == init_color.data_ptr():
        color = color.clone()
    sten = faces = None
    if stencil_front is not None:
        faces = (stencil_front, stencil_back if stencil_back is not None else stencil_front)
        if init_stencil is None:
            init_stencil = torch.zeros((h, w), dtype=torch.int32, device=z.device)
        sten = _pad_plane(init_stencil, h, w, hp, wp, torch.int32)

    if on_cuda(z):
        _raster_blend_cuda(bins, grid, z, color, sten, faces, compare, write, depth_clamp,
                           sample_offset, fragment_shader, attr_layout, color_desc)
    else:
        _raster_blend_torch(bins, grid, z, color, sten, faces, compare, write, depth_clamp,
                            sample_offset, shade_blend)
    if sten is not None:
        return z[:h, :w], color[:h, :w], sten[:h, :w]
    return z[:h, :w], color[:h, :w]


# Launches of K5 and K6.
raster_segmented_blend.launches = 0
raster_segmented_blend.stencil_launches = 0


# Records per k-block of the reference's capped-bin kernels: a bin capacity
# is a multiple of it (raster.py:1445).
K_BLOCK = 8


def _capped_planes(bins: TileBins, grid: TileGrid, init_z: torch.Tensor):
    """The checks of both capped-bin passes, then z padded to whole tiles."""
    t, k = bins.binned_rast.shape[:2]
    if k % K_BLOCK:
        raise ValueError(f"bin capacity {k} must be a multiple of {K_BLOCK}")
    if t != grid.num_tiles:
        raise ValueError(f"the bins hold {t} tiles, the grid has {grid.num_tiles}")
    hp, wp = grid.tiles_y * grid.tile_h, grid.tiles_x * grid.tile_w
    return _pad_plane(init_z, grid.height, grid.width, hp, wp, torch.float32)


def visibility_pass(
    bins: TileBins,
    grid: TileGrid,
    init_z: torch.Tensor,  # (H, W)
    init_slot: torch.Tensor,  # (H, W) i32
    depth_test: bool = True,
    depth_write: bool = True,
    compare_op: CompareOp = CompareOp.GREATER,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Capped-bin visibility (K7; raster.py:1425-1501) → (z (H, W), slot
    (H, W) i32): each tile's first ``counts[t]`` records in order, and per
    pixel the global record index of the last one that passed (``init_slot``
    where none did). Vulkan semantics: with the depth test off the compare
    is ALWAYS and depth is never written (spec 27.18)."""
    h, w = grid.height, grid.width
    z = _capped_planes(bins, grid, init_z)
    slot = _pad_plane(init_slot, h, w, z.shape[0], z.shape[1], torch.int32)
    compare = compare_op if depth_test else CompareOp.ALWAYS
    write = depth_write and depth_test
    if on_cuda(z):
        _visibility_cuda(bins, grid, z, slot, compare, write)
    else:
        _visibility_torch(bins, grid, z, slot, compare, write)
    return z[:h, :w], slot[:h, :w]


def raster_interp_pass(
    bins: TileBins,
    binned_attr: torch.Tensor,  # (T, K, 3·a_n) from bins.gather_corner_data
    grid: TileGrid,
    init_z: torch.Tensor,  # (H, W)
    depth_test: bool = True,
    depth_write: bool = True,
    compare_op: CompareOp = CompareOp.GREATER,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Capped-bin rasterization with in-pass interpolation (K8;
    raster.py:233-308) → (z (H, W), acc (a_n, H, W)): K7's walk, keeping
    the last passing record's a_n perspective planes ``w0·c0 + w1·c1 +
    w2·c2`` instead of its slot. ``acc[-1]`` is the interpolated 1/w, zero
    (with every plane) where nothing passed.

    Like K1, both passes cull by pixel rectangles on CUDA tensors, so they
    need ``TileBins.rect`` (``binning.bin_triangles`` builds it)."""
    h, w = grid.height, grid.width
    z = _capped_planes(bins, grid, init_z)
    if binned_attr.shape[-1] % 3:
        raise ValueError(f"corner data has {binned_attr.shape[-1]} columns, not 3 corners' worth")
    acc = torch.zeros((binned_attr.shape[-1] // 3, *z.shape), dtype=torch.float32,
                      device=z.device)
    compare = compare_op if depth_test else CompareOp.ALWAYS
    write = depth_write and depth_test
    if on_cuda(z):
        _interp_cuda(bins, binned_attr, grid, z, acc, compare, write)
    else:
        _interp_torch(bins, binned_attr, grid, z, acc, compare, write)
    return z[:h, :w], acc[:, :h, :w]


# Launches of K7 and K8.
visibility_pass.launches = 0
raster_interp_pass.launches = 0


def _check_inputs(bins, z, what: str):
    """(routing tables, rows, num_blocks, chunk) after the checks every
    raster kernel makes of its inputs."""
    routing = [bins.blk_tile_y, bins.blk_tile_x, bins.blk_count, bins.blk_init]
    rows = bins.rast_pad
    for t in routing:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != z.device:
            raise ValueError(f"{what} routing tables must be contiguous int32 on the z device")
    if rows.dtype != torch.float32 or not rows.is_contiguous() or rows.device != z.device:
        raise ValueError(f"{what} rows must be contiguous float32 on the z device")
    num_blocks = bins.blk_count.shape[0]
    return routing, rows, num_blocks, rows.shape[0] // max(num_blocks, 1)


def _check_rects(bins, rows, chunk, z, sample_offset, what: str) -> torch.Tensor:
    """The bins' per-row pixel rectangles after the checks K1 and K3-K6
    make: bins that ``bin_segmented`` did not build carry none, and the
    kernels do not run without their cull. The rectangles hold every pixel
    a record covers only for a sample offset in [0, 1)² (as the kernel
    rounds it, to float32). Blocks hold at most ``ENTRY_CHUNK`` entries
    (the kernels' staging buffers)."""
    if not all(0.0 <= ctypes.c_float(o).value < 1.0 for o in sample_offset):
        raise ValueError(f"{what} culls by pixel rectangles that hold a record's coverage only "
                         f"for a sample offset in [0, 1)^2, got {tuple(sample_offset)}")
    if chunk > ENTRY_CHUNK:
        raise ValueError(f"{what} takes blocks of at most {ENTRY_CHUNK} entries, got {chunk}")
    rect = bins.rect
    if rect is None:
        raise ValueError(f"{what} needs the bins' per-row pixel rectangles (SegmentedBins.rect, "
                         f"built by binning.bin_segmented); these bins have none")
    if (rect.dtype != torch.int32 or not rect.is_contiguous() or rect.device != z.device
            or rect.shape != (rows.shape[0], 4) or rect.data_ptr() % 16):
        raise ValueError(f"{what} takes a contiguous 16-byte-aligned ({rows.shape[0]}, 4) int32 "
                         f"rectangle table on the z device")
    return rect


def _raster_stencil_cuda(bins, grid, z, acc, sten, front, back, compare, write, clamp,
                         sample_offset) -> None:
    """Launch K3 on the current stream; updates ``z``, ``acc`` and ``sten``
    in place."""
    routing, rows, num_blocks, chunk = _check_inputs(bins, z, "K3")
    rect = _check_rects(bins, rows, chunk, z, sample_offset, "K3")
    if sten.dtype != torch.int32 or not sten.is_contiguous() or sten.shape != z.shape:
        raise ValueError("K3 takes a contiguous int32 stencil plane of z's shape")
    lib = load_kernels()
    err = lib.zn_raster_segmented_stencil(
        *[t.data_ptr() for t in routing],
        rows.data_ptr(), rect.data_ptr(), z.data_ptr(), acc.data_ptr(), sten.data_ptr(),
        num_blocks, chunk, rows.shape[1], acc.shape[0], z.shape[1], z.shape[0],
        grid.tile_h, grid.tile_w, _COMPARE_CODE[compare], int(write), int(clamp),
        ctypes.c_float(sample_offset[0]), ctypes.c_float(sample_offset[1]),
        _face_codes(front, back),
        ctypes.c_void_p(torch.cuda.current_stream(z.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {err}")
    count_launch(raster_segmented, "stencil_launches")


def _raster_peel_cuda(bins, grid, z, acc, bound, bound_op, compare, write, clamp,
                      sample_offset) -> None:
    """Launch K4 on the current stream; updates ``z`` and ``acc`` in place."""
    routing, rows, num_blocks, chunk = _check_inputs(bins, z, "K4")
    rect = _check_rects(bins, rows, chunk, z, sample_offset, "K4")
    if bound.dtype != torch.float32 or not bound.is_contiguous() or bound.shape != z.shape:
        raise ValueError("K4 takes a contiguous float32 bound plane of z's shape")
    lib = load_kernels()
    err = lib.zn_raster_segmented_peel(
        *[t.data_ptr() for t in routing],
        rows.data_ptr(), rect.data_ptr(), z.data_ptr(), acc.data_ptr(), bound.data_ptr(),
        num_blocks, chunk, rows.shape[1], acc.shape[0], z.shape[1], z.shape[0],
        grid.tile_h, grid.tile_w, _COMPARE_CODE[compare], int(write), int(clamp),
        ctypes.c_float(sample_offset[0]), ctypes.c_float(sample_offset[1]),
        _COMPARE_CODE[bound_op],
        ctypes.c_void_p(torch.cuda.current_stream(z.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"K4 launch failed: CUDA error {err}")
    count_launch(raster_segmented, "peel_launches")


def _raster_blend_cuda(bins, grid, z, color, sten, faces, compare, write, clamp,
                       sample_offset, fragment_shader, attr_layout, color_desc) -> None:
    """Launch K5 (K6 with a stencil plane) compiled for ``fragment_shader``
    on the current stream; updates ``z``, ``color`` (and ``sten``) in place."""
    name = "K6" if sten is not None else "K5"
    routing, rows, num_blocks, chunk = _check_inputs(bins, z, name)
    rect = _check_rects(bins, rows, chunk, z, sample_offset, name)
    if fragment_shader is None or attr_layout is None or color_desc is None:
        raise ValueError(f"{name} needs the fragment shader, the attribute layout and the "
                         f"colour attachment's blend state")
    if not getattr(fragment_shader, "kernel_safe", False) or not fragment_shader.device_source:
        raise RuntimeError(
            f"fragment shader {fragment_shader.name!r} has no device source: a kernel-safe "
            f"shader draws through the blend kernel on CUDA tensors only with "
            f"Shader.fragment(..., kernel_safe=True, device_source=<CUDA text of zn_fragment>)"
        )
    a_n = sum(ch for _, ch in attr_layout) + 1
    if rows.shape[1] != 16 + 3 * a_n:
        raise ValueError(f"{name}: rows have {rows.shape[1]} columns, the layout needs "
                         f"{16 + 3 * a_n}")
    if not color.is_contiguous() or color.shape != (*z.shape, 4) or color.data_ptr() % 16:
        raise ValueError(f"{name} takes a contiguous 16-byte-aligned (H, W, 4) colour image")
    lib = load_blend_kernel(fragment_shader.device_source, attr_layout)
    mask = sum(1 << k for k in range(4) if color_desc.write_mask[k])
    blend = (ctypes.c_int * 8)(
        int(color_desc.blend_enable),
        _BLEND_FACTOR_CODE[color_desc.src_color_blend], _BLEND_FACTOR_CODE[color_desc.dst_color_blend],
        _BLEND_OP_CODE[color_desc.color_blend_op],
        _BLEND_FACTOR_CODE[color_desc.src_alpha_blend], _BLEND_FACTOR_CODE[color_desc.dst_alpha_blend],
        _BLEND_OP_CODE[color_desc.alpha_blend_op], mask,
    )
    head = [*[t.data_ptr() for t in routing], rows.data_ptr(), rect.data_ptr(), z.data_ptr(),
            color.data_ptr()]
    tail = [num_blocks, chunk, rows.shape[1], z.shape[1], grid.tile_h, grid.tile_w,
            _COMPARE_CODE[compare], int(write), int(clamp),
            ctypes.c_float(sample_offset[0]), ctypes.c_float(sample_offset[1]), blend]
    stream = ctypes.c_void_p(torch.cuda.current_stream(z.device).cuda_stream)
    if sten is None:
        err = lib.zn_raster_blend(*head, *tail, stream)
    else:
        if sten.dtype != torch.int32 or not sten.is_contiguous() or sten.shape != z.shape:
            raise ValueError("K6 takes a contiguous int32 stencil plane of z's shape")
        err = lib.zn_raster_blend_stencil(*head, sten.data_ptr(), *tail, _face_codes(*faces),
                                          stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    if sten is None:
        count_launch(raster_segmented_blend)
    else:
        count_launch(raster_segmented_blend, "stencil_launches")


def _raster_segmented_cuda(bins, grid, z, acc, compare, write, clamp, sample_offset) -> None:
    """Launch K1 on the current stream; updates ``z`` and ``acc`` in place."""
    th, tw = grid.tile_h, grid.tile_w
    routing, rows, num_blocks, chunk = _check_inputs(bins, z, "K1")
    rect = _check_rects(bins, rows, chunk, z, sample_offset, "K1")
    a_n = acc.shape[0]
    lib = load_kernels()
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = lib.zn_raster_segmented(
        *[t.data_ptr() for t in routing],
        rows.data_ptr(), rect.data_ptr(), z.data_ptr(), acc.data_ptr(),
        num_blocks, chunk, rows.shape[1], a_n, z.shape[1], z.shape[0],
        th, tw, _COMPARE_CODE[compare], int(write), int(clamp),
        ctypes.c_float(sample_offset[0]), ctypes.c_float(sample_offset[1]),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    count_launch(raster_segmented)


def _capped_inputs(bins: TileBins, z: torch.Tensor, what: str, *extra):
    """(T, K) of capped bins after the checks K7 and K8 make of their
    inputs: the counts and ``extra`` tensors contiguous on the z device,
    counts int32, rows float32, and the slots' pixel rectangles
    (``_check_capped_rects``)."""
    for t, dtype in ((bins.counts, torch.int32), (bins.binned_rast, torch.float32), *extra):
        if t.dtype != dtype or not t.is_contiguous() or t.device != z.device:
            raise ValueError(f"{what} takes contiguous {dtype} bins on the z device")
    _check_capped_rects(bins, z, what)
    return bins.binned_rast.shape[:2]


def _check_capped_rects(bins: TileBins, z: torch.Tensor, what: str) -> torch.Tensor:
    """The capped bins' per-slot pixel rectangles after the checks K7 and
    K8 make: bins that ``bin_triangles`` did not build carry none, and the
    kernels do not run without their cull. They stage rows and rectangles
    with 16-byte copies, so both tables must be 16-byte aligned."""
    rect = bins.rect
    if rect is None:
        raise ValueError(f"{what} needs the bins' per-slot pixel rectangles (TileBins.rect, "
                         f"built by binning.bin_triangles); these bins have none")
    shape = (*bins.binned_rast.shape[:2], 4)
    if (rect.dtype != torch.int32 or not rect.is_contiguous() or rect.device != z.device
            or rect.shape != shape or rect.data_ptr() % 16):
        raise ValueError(f"{what} takes a contiguous 16-byte-aligned {shape} int32 rectangle "
                         f"table on the z device")
    if bins.binned_rast.data_ptr() % 16:
        raise ValueError(f"{what} takes 16-byte-aligned raster rows")
    return rect


def _visibility_cuda(bins, grid, z, slot, compare, write) -> None:
    """Launch K7 on the current stream; updates ``z`` and ``slot`` in place."""
    t, k = _capped_inputs(bins, z, "K7", (bins.binned_slot, torch.int32))
    err = load_kernels().zn_visibility(
        bins.counts.data_ptr(), bins.binned_rast.data_ptr(), bins.rect.data_ptr(),
        bins.binned_slot.data_ptr(), z.data_ptr(), slot.data_ptr(), t, k, grid.tiles_x,
        z.shape[1], grid.tile_h, grid.tile_w, _COMPARE_CODE[compare], int(write),
        ctypes.c_void_p(torch.cuda.current_stream(z.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"K7 launch failed: CUDA error {err}")
    count_launch(visibility_pass)


def _interp_cuda(bins, binned_attr, grid, z, acc, compare, write) -> None:
    """Launch K8 on the current stream; updates ``z`` in place and writes
    ``acc`` (zero-filled by the caller) where a record won."""
    t, k = _capped_inputs(bins, z, "K8", (binned_attr, torch.float32))
    if binned_attr.shape[:2] != (t, k):
        raise ValueError(f"K8: corner data {tuple(binned_attr.shape)} is not laid out as the "
                         f"bins' {t} x {k} slots")
    err = load_kernels().zn_raster_interp(
        bins.counts.data_ptr(), bins.binned_rast.data_ptr(), bins.rect.data_ptr(),
        binned_attr.data_ptr(), z.data_ptr(), acc.data_ptr(), t, k, acc.shape[0], grid.tiles_x,
        z.shape[1], z.shape[0], grid.tile_h, grid.tile_w, _COMPARE_CODE[compare], int(write),
        ctypes.c_void_p(torch.cuda.current_stream(z.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"K8 launch failed: CUDA error {err}")
    count_launch(raster_interp_pass)


class _TileWalk:
    """The rank-by-rank walk the plain versions share: entry rank j = 0, 1, …
    within each tile, vectorised across the tiles that still have an entry
    at rank j (tiles sorted by entry count, so they are a prefix)."""

    def __init__(self, rows, n_t, table, grid, device, sample_offset):
        """``rows`` (N, D) the entries' rows, ``n_t`` (T,) entries per tile,
        ``table`` (T, >= max n_t) the row index of each (tile, rank)."""
        dev = device
        self.th, self.tw = th, tw = grid.tile_h, grid.tile_w
        self.ty_n, self.tx_n = ty_n, tx_n = grid.tiles_y, grid.tiles_x
        self.t = t = ty_n * tx_n
        self.rows = rows
        self.max_n = max_n = int(n_t.max()) if t else 0
        if max_n == 0:
            return
        # Tiles by entry count, descending: the tiles active at rank j are a
        # prefix of this order.
        self.order = order = torch.sort(n_t, descending=True, stable=True).indices
        self.active = (n_t[order][None, :]
                       > torch.arange(max_n, device=dev)[:, None]).sum(1).tolist()
        self.table = table[order, :max_n]
        col = torch.arange(tw, device=dev)[None, None, :]
        row = torch.arange(th, device=dev)[None, :, None]
        self.x = ((order % tx_n)[:, None, None] * tw + col).to(torch.float32) + sample_offset[0]
        self.y = ((order // tx_n)[:, None, None] * th + row).to(torch.float32) + sample_offset[1]

    @classmethod
    def segmented(cls, bins: SegmentedBins, grid, device, sample_offset) -> "_TileWalk":
        """The walk over segmented bins' blocks."""
        dev = device
        t = grid.num_tiles
        rows = bins.rast_pad
        nb = bins.blk_count.shape[0]
        chunk = rows.shape[0] // max(nb, 1)
        # Entry table: per tile, its row indices in submission order.
        b = torch.arange(nb, device=dev)
        init = bins.blk_init.to(torch.int64) == 1
        first = torch.cummax(torch.where(init, b, torch.zeros_like(b)), 0).values
        tile_b = bins.blk_tile_y.to(torch.int64) * grid.tiles_x + bins.blk_tile_x.to(torch.int64)
        lane = torch.arange(chunk, device=dev)[None, :]
        live = lane < bins.blk_count.to(torch.int64)[:, None]
        ent_tile = tile_b[:, None].expand(nb, chunk)[live]
        ent_rank = ((b - first)[:, None] * chunk + lane)[live]
        ent_row = (b[:, None] * chunk + lane)[live]
        n_t = torch.bincount(ent_tile, minlength=t)
        table = torch.full((t, int(n_t.max()) if t else 0), -1, dtype=torch.int64, device=dev)
        table[ent_tile, ent_rank] = ent_row
        return cls(rows, n_t, table, grid, dev, sample_offset)

    @classmethod
    def capped(cls, rows: torch.Tensor, counts: torch.Tensor, grid, device) -> "_TileWalk":
        """The walk over capped bins: ``rows`` (T·K, D) tile-major, the first
        ``counts[t]`` of each tile's K live, at pixel centres."""
        k = rows.shape[0] // max(grid.num_tiles, 1)
        table = (torch.arange(grid.num_tiles, device=device)[:, None] * k
                 + torch.arange(k, device=device)[None, :])
        return cls(rows, counts.to(torch.int64), table, grid, device, (0.5, 0.5))

    def tiles(self, plane: torch.Tensor) -> torch.Tensor:
        """(hp, wp) → (T, th, tw) in walk order; (C, hp, wp) → (T, C, th, tw)."""
        if plane.ndim == 2:
            tiled = plane.view(self.ty_n, self.th, self.tx_n, self.tw).permute(0, 2, 1, 3)
            return tiled.reshape(self.t, self.th, self.tw)[self.order]
        c = plane.shape[0]
        tiled = plane.view(c, self.ty_n, self.th, self.tx_n, self.tw).permute(1, 3, 0, 2, 4)
        return tiled.reshape(self.t, c, self.th, self.tw)[self.order]

    def store(self, tiled: torch.Tensor, plane: torch.Tensor) -> None:
        """The inverse of ``tiles``: write walk-ordered tiles back to ``plane``."""
        full = torch.empty_like(tiled)
        full[self.order] = tiled
        if plane.ndim == 2:
            plane.copy_(full.view(self.ty_n, self.tx_n, self.th, self.tw)
                        .permute(0, 2, 1, 3).reshape(plane.shape))
        else:
            c = plane.shape[0]
            plane.copy_(full.view(self.ty_n, self.tx_n, c, self.th, self.tw)
                        .permute(2, 0, 3, 1, 4).reshape(plane.shape))

    def ranks(self):
        """Yields (m, c) per rank: the m active tiles' rows as (m, D, 1, 1)."""
        for j, m in enumerate(self.active):
            yield m, self.rows[self.table[:m, j]][:, :, None, None]


def _fragments(c, xm, ym, clamp):
    """Coverage, barycentrics·inv_det and depth of one rank of entries: the
    kernels' rounded operations in the same order. → (cov, w0, w1, w2, zpx)."""
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
    return cov, w0, w1, w2, zpx


def _planes(c, w0, w1, w2, a_n):
    """The a_n interpolated attr·(1/w) planes of one rank: (m, a_n, th, tw)."""
    c0 = c[:, 16:16 + a_n]  # (m, a_n, 1, 1): the three corners' columns
    c1 = c[:, 16 + a_n:16 + 2 * a_n]
    c2 = c[:, 16 + 2 * a_n:16 + 3 * a_n]
    return w0[:, None] * c0 + w1[:, None] * c1 + w2[:, None] * c2


def _raster_segmented_torch(bins, grid, z, acc, compare, write, clamp, sample_offset,
                            stencil=None, faces=None, z_bound=None, bound_op=None) -> None:
    """Plain PyTorch version of K1, and with ``stencil``/``faces`` of K3,
    with ``z_bound``/``bound_op`` of K4: the same rounded operations in the
    same order as the kernels, so the result is theirs bit for bit. Updates
    ``z``, ``acc`` (and ``stencil``) in place.

    Without stencil the only order dependence is which fragment each pixel
    keeps, so where the bins carry their pixel rectangles (and the sample
    offset lies in [0, 1)², as the kernels require) the fragments are
    evaluated at once over those rectangles and resolved per pixel
    (``_resolve_fragments``); otherwise, and with stencil, the pass walks the
    tiles' entries rank by rank (``_walk_raster``)."""
    walk = _TileWalk.segmented(bins, grid, z.device, sample_offset)
    if (stencil is None and bins.rect is not None
            and all(0.0 <= o < 1.0 for o in sample_offset)
            and not (write and compare == CompareOp.NOT_EQUAL)):
        _resolve_fragments(walk, bins.rect, grid, z, acc, compare, write, clamp,
                           sample_offset, z_bound, bound_op)
        return
    _walk_raster(walk, z, acc, compare, write, clamp, stencil, faces, z_bound, bound_op)


# Fragments evaluated together by _resolve_fragments (bounds its memory),
# and the side of the pixel blocks it culls by the edge functions.
_FRAGMENT_CHUNK = 1 << 20
_BLOCK = 8


def _resolve_fragments(walk, rect, grid, z, acc, compare, write, clamp, sample_offset,
                       z_bound=None, bound_op=None) -> None:
    """The rank walk's result without walking the ranks. Each entry's
    fragments are evaluated over its row's pixel rectangle (which holds every
    pixel the kernels let it cover) with ``_fragments``' operations; then per
    pixel the fragment the walk would keep is chosen: with the depth written
    under an ordering compare, the first (strict compare) or last (or-equal)
    entry at the extreme depth, if that depth passes against the plane's;
    otherwise the last entry that passes against the fixed plane. The
    winner's depth and planes are recomputed from its own row, so the values
    are the walk's bit for bit. Updates ``z`` and ``acc`` (padded planes) in
    place."""
    if walk.max_n == 0:
        return
    dev = z.device
    th, tw = grid.tile_h, grid.tile_w
    wp = z.shape[1]
    a_n = acc.shape[0]
    ti, rank = torch.nonzero(walk.table >= 0, as_tuple=True)
    row = walk.table[ti, rank]
    tile = walk.order[ti]
    tx0 = (tile % grid.tiles_x) * tw
    ty0 = (tile // grid.tiles_x) * th
    box = rect[row].to(torch.int64)
    x0 = torch.maximum(box[:, 0], tx0)
    y0 = torch.maximum(box[:, 1], ty0)
    bw = torch.clamp(torch.minimum(box[:, 2], tx0 + tw - 1) - x0 + 1, min=0)
    bh = torch.clamp(torch.minimum(box[:, 3], ty0 + th - 1) - y0 + 1, min=0)
    # Each entry's box in blocks of _BLOCK² pixels; a block stays unless
    # one edge function is negative at every sample point of it, with a
    # margin far above the rounding of its evaluation, so the pixel test
    # below still decides every fragment.
    nbx, nby = (bw + _BLOCK - 1) // _BLOCK, (bh + _BLOCK - 1) // _BLOCK
    nb = nbx * nby
    eb = torch.repeat_interleave(torch.arange(nb.shape[0], device=dev), nb)
    kb = torch.arange(eb.shape[0], device=dev) - (torch.cumsum(nb, 0) - nb)[eb]
    bx0 = x0[eb] + _BLOCK * (kb % nbx[eb])
    by0 = y0[eb] + _BLOCK * (kb // nbx[eb])
    bx1 = torch.minimum(bx0 + _BLOCK, x0[eb] + bw[eb])
    by1 = torch.minimum(by0 + _BLOCK, y0[eb] + bh[eb])
    edges = walk.rows[row[eb], :9].double()
    xs = (bx0.double() + sample_offset[0], bx1.double() - 1.0 + sample_offset[0])
    ys = (by0.double() + sample_offset[1], by1.double() - 1.0 + sample_offset[1])
    keep = torch.ones_like(eb, dtype=torch.bool)
    for i in (0, 3, 6):
        a, b, c = edges[:, i], edges[:, i + 1], edges[:, i + 2]
        e_max = c + torch.maximum(a * xs[0], a * xs[1]) + torch.maximum(b * ys[0], b * ys[1])
        size = c.abs() + a.abs() * torch.maximum(xs[0].abs(), xs[1].abs()) \
            + b.abs() * torch.maximum(ys[0].abs(), ys[1].abs())
        keep &= ~(e_max < -1e-5 * size)
    row, rank = row[eb][keep], rank[eb][keep]
    x0, y0 = bx0[keep], by0[keep]
    bw, bh = (bx1 - bx0)[keep], (by1 - by0)[keep]
    area = bw * bh
    ends = torch.cumsum(area, 0)

    ordered = write and compare in (CompareOp.GREATER, CompareOp.GREATER_OR_EQUAL,
                                    CompareOp.LESS, CompareOp.LESS_OR_EQUAL)
    high = compare in (CompareOp.GREATER, CompareOp.GREATER_OR_EQUAL)
    pick_first = ordered and compare in (CompareOp.GREATER, CompareOp.LESS)
    z_flat = z.view(-1)
    bound_flat = z_bound.reshape(-1) if z_bound is not None else None
    npix = z_flat.numel()
    # Coverage and depth read the 16 raster columns, laid out column by column.
    cols16 = walk.rows[:, :16].T.contiguous()
    kept_pix, kept_z, kept_rank = [], [], []
    e0 = 0
    n_e = area.shape[0]
    while e0 < n_e:
        # Entries [e0, e1) hold at most _FRAGMENT_CHUNK fragments (or one entry).
        base = int(ends[e0 - 1]) if e0 else 0
        e1 = max(int(torch.searchsorted(ends, base + _FRAGMENT_CHUNK, right=True)), e0 + 1)
        a = area[e0:e1]
        n_f = int(ends[e1 - 1]) - base
        ent = torch.repeat_interleave(torch.arange(e0, e1, device=dev), a)
        e0 = e1
        if n_f == 0:
            continue
        k = torch.arange(n_f, device=dev) - (ends[ent] - area[ent] - base)
        px = x0[ent] + k % bw[ent]
        py = y0[ent] + k // bw[ent]
        xm = px.to(torch.float32) + sample_offset[0]
        ym = py.to(torch.float32) + sample_offset[1]
        cov, _, _, _, zpx = _fragments(cols16[:, row[ent]].T, xm, ym, clamp)
        pix = py * wp + px
        if bound_flat is not None:
            cov = cov & _compare(bound_op, zpx, bound_flat[pix])
        if ordered:
            cov = cov & ~torch.isnan(zpx)  # a NaN depth passes no ordering compare
            kept_z.append(zpx[cov])
        else:
            # The plane is fixed: without writes, or where a pass writes only
            # what it compared equal to, or under ALWAYS / NEVER.
            cov = cov & _compare(compare, zpx, z_flat[pix])
        kept_pix.append(pix[cov])
        kept_rank.append(rank[ent][cov])
    if not kept_pix:
        return
    pix, rank_f = torch.cat(kept_pix), torch.cat(kept_rank)
    if ordered:
        zf = torch.cat(kept_z)
        best = torch.full((npix,), -torch.inf if high else torch.inf, device=dev)
        best = best.scatter_reduce(0, pix, zf, "amax" if high else "amin", include_self=True)
        eq = zf == best[pix]
        none = walk.max_n if pick_first else -1
        key = torch.full((npix,), none, dtype=torch.int64, device=dev).scatter_reduce(
            0, pix[eq], rank_f[eq], "amin" if pick_first else "amax", include_self=True)
        has = (key != none) & _compare(compare, best, z_flat)
    else:
        key = torch.full((npix,), -1, dtype=torch.int64, device=dev).scatter_reduce(
            0, pix, rank_f, "amax", include_self=True)
        has = key >= 0
    sel = torch.nonzero(has, as_tuple=True)[0]
    if sel.numel() == 0:
        return
    px, py = sel % wp, sel // wp
    tile_of = (py // th) * grid.tiles_x + px // tw
    pos = torch.empty_like(walk.order)
    pos[walk.order] = torch.arange(walk.order.shape[0], device=dev)
    c = walk.rows[walk.table[pos[tile_of], key[sel]]]
    xm = px.to(torch.float32) + sample_offset[0]
    ym = py.to(torch.float32) + sample_offset[1]
    _, w0, w1, w2, zpx = _fragments(c, xm, ym, clamp)
    if write:
        z_flat[sel] = zpx
    acc.view(a_n, -1)[:, sel] = _planes(c, w0, w1, w2, a_n).T


def _walk_raster(walk, z, acc, compare, write, clamp, stencil=None, faces=None, z_bound=None,
                 bound_op=None) -> None:
    """The walk of ``_raster_segmented_torch`` over any ``_TileWalk`` (the
    plain K8 walks capped bins with it)."""
    a_n = acc.shape[0]
    if walk.max_n == 0:
        return
    zt, at = walk.tiles(z), walk.tiles(acc)
    st = walk.tiles(stencil) if stencil is not None else None
    bt = walk.tiles(z_bound) if z_bound is not None else None
    for m, c in walk.ranks():
        cov, w0, w1, w2, zpx = _fragments(c, walk.x[:m], walk.y[:m], clamp)
        if bt is not None:
            cov = cov & _compare(bound_op, zpx, bt[:m])  # strictly behind the previous peel
        zcur = zt[:m]
        depth_ok = _compare(compare, zpx, zcur)
        if st is not None:
            # The front flag rides the second-to-last attribute column
            # (front·iw at corner 0; iw > 0 always).
            passed, st[:m] = _stencil_step(faces[0], faces[1], c[:, 16 + a_n - 2] > 0.0,
                                           cov, depth_ok, st[:m])
        else:
            passed = cov & depth_ok
        if write:
            zt[:m] = torch.where(passed, zpx, zcur)
        at[:m] = torch.where(passed[:, None], _planes(c, w0, w1, w2, a_n), at[:m])
    walk.store(zt, z)
    walk.store(at, acc)
    if st is not None:
        walk.store(st, stencil)


def _raster_blend_torch(bins, grid, z, color, stencil, faces, compare, write, clamp,
                        sample_offset, shade_blend) -> None:
    """Plain PyTorch version of K5, and with ``stencil``/``faces`` of K6:
    per rank, every fragment is shaded and blended and the result selected
    where the fragment passed (the kernels shade only those; the values are
    the same). Updates ``z``, ``color`` (hp, wp, 4) (and ``stencil``) in
    place."""
    a_n = (bins.rast_pad.shape[-1] - 16) // 3
    walk = _TileWalk.segmented(bins, grid, z.device, sample_offset)
    if walk.max_n == 0:
        return
    zt = walk.tiles(z)
    ct = walk.tiles(color.permute(2, 0, 1).contiguous()).permute(0, 2, 3, 1).contiguous()
    st = walk.tiles(stencil) if stencil is not None else None
    for m, c in walk.ranks():
        xm, ym = walk.x[:m], walk.y[:m]
        cov, w0, w1, w2, zpx = _fragments(c, xm, ym, clamp)
        zcur = zt[:m]
        depth_ok = _compare(compare, zpx, zcur)
        if st is not None:
            passed, st[:m] = _stencil_step(faces[0], faces[1], c[:, 16 + a_n - 2] > 0.0,
                                           cov, depth_ok, st[:m])
        else:
            passed = cov & depth_ok
        if write:
            zt[:m] = torch.where(passed, zpx, zcur)
        ct[:m] = shade_blend(_planes(c, w0, w1, w2, a_n), passed, xm.expand_as(zpx),
                             ym.expand_as(zpx), zpx, ct[:m])
    walk.store(zt, z)
    planes = torch.empty((4, *z.shape), dtype=torch.float32, device=z.device)
    walk.store(ct.permute(0, 3, 1, 2).contiguous(), planes)
    color.copy_(planes.permute(1, 2, 0))
    if st is not None:
        walk.store(st, stencil)


def _visibility_torch(bins, grid, z, slot, compare, write) -> None:
    """Plain PyTorch version of K7: the rounded operations of K1's walk over
    the capped bins, carrying the winning record's slot. Updates ``z`` and
    ``slot`` in place."""
    t, k = bins.binned_rast.shape[:2]
    walk = _TileWalk.capped(bins.binned_rast.reshape(t * k, -1), bins.counts, grid, z.device)
    if walk.max_n == 0:
        return
    ids = bins.binned_slot.reshape(-1)
    zt, st = walk.tiles(z), walk.tiles(slot)
    for j, (m, c) in enumerate(walk.ranks()):
        cov, _, _, _, zpx = _fragments(c, walk.x[:m], walk.y[:m], False)
        zcur = zt[:m]
        passed = cov & _compare(compare, zpx, zcur)
        if write:
            zt[:m] = torch.where(passed, zpx, zcur)
        st[:m] = torch.where(passed, ids[walk.table[:m, j]][:, None, None], st[:m])
    walk.store(zt, z)
    walk.store(st, slot)


def _interp_torch(bins, binned_attr, grid, z, acc, compare, write) -> None:
    """Plain PyTorch version of K8: K1's plain walk over the capped bins'
    rows (rast16 | corner data). Updates ``z`` and ``acc`` in place."""
    t, k = bins.binned_rast.shape[:2]
    rows = torch.cat([bins.binned_rast, binned_attr.to(torch.float32)], dim=-1).reshape(t * k, -1)
    _walk_raster(_TileWalk.capped(rows, bins.counts, grid, z.device), z, acc, compare, write,
                 False)
