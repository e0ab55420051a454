"""Texture sampling — the sampler hardware of the Vulkan pipeline (torch port
of zenith_tpu/ops/sampling.py: the layered, cube and shadow-compare paths).

Dense gather-based sampling over per-pixel UV images, interpreting
SamplerConfig (zenith_tpu_torch.rhi.sampler). Vulkan texel conventions:
unnormalized coords x = u*W - 0.5; bilinear weights from the fractional
part; wrap applied per tap on texel indices.

Not ported yet: ``sample_2d``, the mip functions, ``sample_cube_lod`` and
``sample_3d`` (ROADMAP items 13 and 21), and ``sample_shadow_pcf_layered``
(item 21).
"""

from __future__ import annotations

from typing import Optional

import torch

from zenith_tpu_torch.rhi.sampler import AddressMode, Filter, SamplerConfig
from zenith_tpu_torch.rhi.state import CompareOp


def _wrap_indices(i: torch.Tensor, n: int,
                  mode: AddressMode) -> "tuple[torch.Tensor, Optional[torch.Tensor]]":
    """Wrap integer texel indices (sampling.py:25-38); returns (indices,
    in-bounds mask), the mask None where every index is in bounds."""
    if mode == AddressMode.REPEAT:
        return torch.remainder(i, n), None
    if mode == AddressMode.MIRRORED_REPEAT:
        period = 2 * n
        m = torch.remainder(i, period)
        return torch.where(m >= n, period - 1 - m, m), None
    if mode == AddressMode.CLAMP_TO_EDGE:
        return torch.clamp(i, 0, n - 1), None
    # CLAMP_TO_BORDER
    return torch.clamp(i, 0, n - 1), (i >= 0) & (i < n)


def _border(sampler: SamplerConfig, c: int, like: torch.Tensor) -> torch.Tensor:
    """The border colour as a (c,) tensor made by fills (no host copy)."""
    out = torch.empty((c,), dtype=torch.float32, device=like.device)
    for k, v in enumerate(sampler.border_color.value[:c]):
        out[k].fill_(float(v))
    return out


def _apply_border(texels, okx, oky, sampler: SamplerConfig) -> torch.Tensor:
    ok = okx if oky is None else (oky if okx is None else okx & oky)
    if ok is None:
        return texels
    return torch.where(ok[..., None], texels, _border(sampler, texels.shape[-1], texels))


def _fetch(tex: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
           sampler: SamplerConfig) -> torch.Tensor:
    """Gather texels at integer coords with wrap + border handling
    (sampling.py:41-53). tex: (H, W, C); ix/iy: (...,) int → (..., C)."""
    h, w = tex.shape[0], tex.shape[1]
    jx, okx = _wrap_indices(ix, w, sampler.address_mode_u)
    jy, oky = _wrap_indices(iy, h, sampler.address_mode_v)
    flat = (jy * w + jx).reshape(-1)
    texels = tex.reshape(h * w, -1)[flat].reshape(ix.shape + (tex.shape[-1],))
    return _apply_border(texels, okx, oky, sampler)


def _fetch_rows(sheet: torch.Tensor, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Gather texels from a (Rows, W, C) sheet at precomputed indices."""
    w = sheet.shape[1]
    flat = (row * w + col).reshape(-1)
    t = sheet.reshape(-1, sheet.shape[-1])[flat]
    return t.reshape(row.shape + (sheet.shape[-1],))


def sample_2d_array(
    tex: torch.Tensor,  # (L, H, W, C)
    uv: torch.Tensor,  # (..., 2)
    layer: torch.Tensor,  # (...,) float or int layer index
    sampler: SamplerConfig = SamplerConfig(),
) -> torch.Tensor:
    """Layered-2D sample (sampling.py:252-296): the layer index is rounded
    (half to even) and clamped, then filtered in-plane like a 2D sample."""
    layers, h, w, c = tex.shape
    li = torch.clamp(torch.round(layer.to(torch.float32)).to(torch.int64), 0, layers - 1)
    sheet = tex.reshape(layers * h, w, c)
    u = uv[..., 0] * w
    v = uv[..., 1] * h
    if sampler.mag_filter == Filter.NEAREST:
        jx, okx = _wrap_indices(torch.floor(u).to(torch.int64), w, sampler.address_mode_u)
        jy, oky = _wrap_indices(torch.floor(v).to(torch.int64), h, sampler.address_mode_v)
        return _apply_border(_fetch_rows(sheet, li * h + jy, jx), okx, oky, sampler)
    x = u - 0.5
    y = v - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)

    def tap(ix, iy):
        jx, okx = _wrap_indices(ix, w, sampler.address_mode_u)
        jy, oky = _wrap_indices(iy, h, sampler.address_mode_v)
        return _apply_border(_fetch_rows(sheet, li * h + jy, jx), okx, oky, sampler)

    t00, t10 = tap(x0, y0), tap(x0 + 1, y0)
    t01, t11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def cube_direction_to_face_uv(d: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """Direction (..., 3) → (face (...,) i32, uv (..., 2)) per the Vulkan
    cube-map face selection rules, face order +X -X +Y -Y +Z -Z
    (sampling.py:307-332)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)

    x_major = (ax >= ay) & (ax >= az)
    y_major = (~x_major) & (ay >= az)

    def pick(a, b):  # integer per-branch face ids as tensors
        return torch.where(a, torch.zeros_like(x, dtype=torch.int32),
                           torch.ones_like(x, dtype=torch.int32)) + b

    face = torch.where(
        x_major, pick(x > 0, 0),
        torch.where(y_major, pick(y > 0, 2), pick(z > 0, 4)),
    )

    ma = torch.where(x_major, ax, torch.where(y_major, ay, az))
    ma = torch.clamp(ma, min=1e-20)
    # Per-face (sc, tc) numerators (Vulkan 16.5.4 table).
    sc = torch.where(
        x_major, torch.where(x > 0, -z, z),
        torch.where(y_major, x, torch.where(z > 0, x, -x)),
    )
    tc = torch.where(
        x_major, -y, torch.where(y_major, torch.where(y > 0, z, -z), -y)
    )
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)
    return face, torch.stack([u, v], dim=-1)


def sample_cube(
    tex: torch.Tensor,  # (6, S, S, C), faces +X -X +Y -Y +Z -Z
    directions: torch.Tensor,  # (..., 3), need not be normalized
    sampler: SamplerConfig = SamplerConfig(),
) -> torch.Tensor:
    """Cube-map sample by direction (sampling.py:335-352). Faces are
    filtered independently with clamp-to-edge at the seams."""
    face, uv = cube_direction_to_face_uv(directions)
    clamped = SamplerConfig(
        mag_filter=sampler.mag_filter,
        min_filter=sampler.min_filter,
        mipmap_mode=sampler.mipmap_mode,
        address_mode_u=AddressMode.CLAMP_TO_EDGE,
        address_mode_v=AddressMode.CLAMP_TO_EDGE,
        border_color=sampler.border_color,
    )
    return sample_2d_array(tex, uv, face, clamped)


_COMPARE = {
    CompareOp.GREATER_OR_EQUAL: lambda a, b: a >= b,
    CompareOp.GREATER: lambda a, b: a > b,
    CompareOp.LESS_OR_EQUAL: lambda a, b: a <= b,
    CompareOp.LESS: lambda a, b: a < b,
}


def sample_shadow_pcf(
    shadow_depth: torch.Tensor,  # (H, W) depth map
    uv: torch.Tensor,  # (..., 2)
    ref_z: torch.Tensor,  # (...,) reference depth to compare
    sampler: SamplerConfig = SamplerConfig.shadow_pcf(),
) -> torch.Tensor:
    """2×2 PCF compare sample → light visibility in [0, 1]
    (sampling.py:416-453): each bilinear tap is compared against ref_z,
    then the binary results are bilinearly weighted."""
    h, w = shadow_depth.shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    cmp = _COMPARE[sampler.compare_op]
    tex = shadow_depth[..., None]

    def tap(ix, iy):
        d = _fetch(tex, ix, iy, sampler)[..., 0]
        return cmp(ref_z, d).to(torch.float32)

    t00, t10 = tap(x0, y0), tap(x0 + 1, y0)
    t01, t11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy
