"""Texture sampling — the sampler hardware of the Vulkan pipeline (torch port
of zenith_tpu/ops/sampling.py: the single-level, trilinear, layered, cube and
shadow-compare paths, the explicit-LOD cube, volume and layered
shadow-compare samplers, and anisotropic filtering).

Dense gather-based sampling over per-pixel UV images, interpreting
SamplerConfig (zenith_tpu_torch.rhi.sampler). Vulkan texel conventions:
unnormalized coords x = u*W - 0.5; bilinear weights from the fractional
part; wrap applied per tap on texel indices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from zenith_tpu_torch.rhi.sampler import AddressMode, Filter, MipmapMode, SamplerConfig
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


def sample_2d(
    tex: torch.Tensor,  # (H, W, C) linear float
    uv: torch.Tensor,  # (..., 2)
    sampler: SamplerConfig = SamplerConfig(),
) -> torch.Tensor:
    """Single-level sample, the mag-filter path (sampling.py:56-84).
    Returns (..., C)."""
    h, w = tex.shape[0], tex.shape[1]
    u = uv[..., 0] * w
    v = uv[..., 1] * h
    if sampler.mag_filter == Filter.NEAREST:
        return _fetch(tex, torch.floor(u).to(torch.int64), torch.floor(v).to(torch.int64),
                      sampler)
    x = u - 0.5
    y = v - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    t00 = _fetch(tex, x0, y0, sampler)
    t10 = _fetch(tex, x0 + 1, y0, sampler)
    t01 = _fetch(tex, x0, y0 + 1, sampler)
    t11 = _fetch(tex, x0 + 1, y0 + 1, sampler)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


class PackedMips(NamedTuple):
    """A full mip pyramid flattened for per-pixel LOD gathers."""

    texels: torch.Tensor  # (total, C)
    offsets: torch.Tensor  # (L,) int64
    widths: torch.Tensor  # (L,) int64
    heights: torch.Tensor  # (L,) int64

    @property
    def num_levels(self) -> int:
        return self.offsets.shape[0]


def pack_mips(mips: "list[torch.Tensor]") -> PackedMips:
    """Flatten mip levels into one texel table (sampling.py:100-115). The
    small level tables are made by fills: no host copy, so no sync inside a
    frame."""
    dev = mips[0].device
    n = len(mips)
    offsets, widths, heights = (torch.empty((n,), dtype=torch.int64, device=dev)
                                for _ in range(3))
    off = 0
    flats = []
    for k, lvl in enumerate(mips):
        h, w = int(lvl.shape[0]), int(lvl.shape[1])
        offsets[k].fill_(off)
        widths[k].fill_(w)
        heights[k].fill_(h)
        flats.append(lvl.reshape(h * w, -1))
        off += h * w
    return PackedMips(torch.cat(flats, dim=0).to(torch.float32), offsets, widths, heights)


def _sample_level(packed: PackedMips, uv: torch.Tensor, level: torch.Tensor,
                  sampler: SamplerConfig) -> torch.Tensor:
    """Bilinear sample at a per-pixel integer mip level (sampling.py:118-151)."""
    w = packed.widths[level]
    h = packed.heights[level]
    off = packed.offsets[level]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)

    def fetch(ix, iy):
        # Wrap per level dims (a per-pixel n: arithmetic wrap).
        if sampler.address_mode_u == AddressMode.REPEAT:
            jx = torch.remainder(ix, w)
        else:
            jx = torch.minimum(torch.clamp(ix, min=0), w - 1)
        if sampler.address_mode_v == AddressMode.REPEAT:
            jy = torch.remainder(iy, h)
        else:
            jy = torch.minimum(torch.clamp(iy, min=0), h - 1)
        flat = (off + jy * w + jx).reshape(-1)
        return packed.texels[flat].reshape(ix.shape + (packed.texels.shape[-1],))

    t00, t10 = fetch(x0, y0), fetch(x0 + 1, y0)
    t01, t11 = fetch(x0, y0 + 1), fetch(x0 + 1, y0 + 1)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def screen_space_lod(uv: torch.Tensor, tex_w: int, tex_h: int) -> torch.Tensor:
    """Per-pixel LOD from neighbour differences of a dense (H, W, 2) UV
    image, the quad-derivative analog (sampling.py:154-163)."""
    du_dx = uv - torch.roll(uv, 1, dims=1)
    du_dy = uv - torch.roll(uv, 1, dims=0)
    rx = torch.sqrt((du_dx[..., 0] * tex_w) ** 2 + (du_dx[..., 1] * tex_h) ** 2)
    ry = torch.sqrt((du_dy[..., 0] * tex_w) ** 2 + (du_dy[..., 1] * tex_h) ** 2)
    rho = torch.maximum(rx, ry)
    return torch.log2(torch.clamp(rho, min=1e-8))


def sample_2d_lod(
    packed: PackedMips,
    uv: torch.Tensor,
    lod: torch.Tensor,
    sampler: SamplerConfig = SamplerConfig(),
) -> torch.Tensor:
    """Trilinear (or nearest-mip) sample with per-pixel LOD
    (sampling.py:166-185)."""
    lmax = packed.num_levels - 1
    lod = torch.clamp(lod + sampler.mip_lod_bias, sampler.min_lod,
                      min(sampler.max_lod, lmax))
    if sampler.mipmap_mode == MipmapMode.NEAREST:
        return _sample_level(packed, uv, torch.round(lod).to(torch.int64), sampler)
    l0f = torch.floor(lod)
    frac = (lod - l0f)[..., None]
    l0 = l0f.to(torch.int64)
    l1 = torch.clamp(l0 + 1, max=lmax)
    s0 = _sample_level(packed, uv, l0, sampler)
    s1 = _sample_level(packed, uv, l1, sampler)
    return s0 * (1 - frac) + s1 * frac


def sample_2d_aniso(
    packed: PackedMips,
    uv: torch.Tensor,  # (H, W, 2) dense UV image (derivatives required)
    sampler: SamplerConfig,
    tex_w: int,
    tex_h: int,
) -> torch.Tensor:
    """Anisotropic filtering (sampling.py:188-222): N trilinear probes spread
    along the major axis of the pixel's UV footprint, the hardware's
    approximation of the EWA ellipse. LOD comes from the minor axis
    (rho_major / ratio). ``torch.roll`` wraps round the image's edges as
    ``jnp.roll`` does, so the first row and column see the last."""
    ddx = uv - torch.roll(uv, 1, dims=1)  # UV change per screen-x step
    ddy = uv - torch.roll(uv, 1, dims=0)
    scale = torch.empty((2,), dtype=torch.float32, device=uv.device)
    scale[0].fill_(float(tex_w))
    scale[1].fill_(float(tex_h))
    px = torch.linalg.vector_norm(ddx * scale, dim=-1)
    py = torch.linalg.vector_norm(ddy * scale, dim=-1)
    major_is_x = px >= py
    vmaj = torch.where(major_is_x[..., None], ddx, ddy)  # UV-space major axis
    rho_maj = torch.clamp(torch.maximum(px, py), min=1e-8)
    rho_min = torch.clamp(torch.minimum(px, py), min=1e-8)
    ratio = torch.clamp(rho_maj / rho_min, 1.0, float(sampler.max_anisotropy))
    lod = torch.log2(torch.clamp(rho_maj / ratio, min=1e-8))

    # Static probe count; the probes bunch together (toward plain trilinear)
    # as the per-pixel ratio shrinks below the cap.
    s = max(2, int(round(float(sampler.max_anisotropy))))
    spread = (1.0 - 1.0 / ratio)[..., None]  # total extent the probes cover
    acc = None
    for i in range(s):
        t = (i + 0.5) / s - 0.5
        tap = sample_2d_lod(packed, uv + vmaj * (t * spread), lod, sampler)
        acc = tap if acc is None else acc + tap
    return acc / s


def sample_texture(
    tex,  # (H, W, C) tensor | tuple of mip tensors (graph import of a mipped Texture)
    uv: torch.Tensor,  # (H, W, 2) dense UV image (fragment-stage varying)
    sampler: SamplerConfig = SamplerConfig(),
) -> torch.Tensor:
    """Sample a bound texture resource inside a fragment shader
    (sampling.py:225-249). Accepts what ``ctx.get`` yields for an imported
    texture: a plain tensor (single level) or a tuple of mip tensors, which
    take trilinear filtering with the screen-space-derivative LOD of the
    dense UV image. Samplers with ``anisotropy_enable`` take the multi-probe
    anisotropic path (which needs the dense UV image)."""
    levels = list(tex) if isinstance(tex, (tuple, list)) else [tex]
    h0, w0 = levels[0].shape[0], levels[0].shape[1]
    if sampler.anisotropy_enable and uv.ndim == 3:
        return sample_2d_aniso(pack_mips(levels), uv, sampler, w0, h0)
    if len(levels) == 1 or sampler.mipmap_mode is None:
        return sample_2d(levels[0], uv, sampler)
    lod = screen_space_lod(uv, w0, h0)
    return sample_2d_lod(pack_mips(levels), uv, lod, sampler)


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


def sample_cube_lod(
    levels,  # sequence of (6, S_m, S_m, C) cube mips
    directions: torch.Tensor,  # (..., 3), need not be normalized
    lod: torch.Tensor,  # (...,) float mip level
    sampler: SamplerConfig = SamplerConfig(),
) -> torch.Tensor:
    """Cube sample with an explicit per-pixel LOD (textureLod on a cube,
    sampling.py:355-384): every level is sampled and blended with the tent
    weight max(0, 1 - |lod - m|), at most two of them non-zero, which is
    trilinear filtering across the levels."""
    face, uv = cube_direction_to_face_uv(directions)
    clamped = SamplerConfig(
        mag_filter=sampler.mag_filter,
        min_filter=sampler.min_filter,
        address_mode_u=AddressMode.CLAMP_TO_EDGE,
        address_mode_v=AddressMode.CLAMP_TO_EDGE,
        border_color=sampler.border_color,
    )
    lod = torch.clamp(lod + sampler.mip_lod_bias, 0.0, float(len(levels) - 1))
    acc = None
    for m, tex in enumerate(levels):
        w = torch.clamp(1.0 - torch.abs(lod - m), 0.0, 1.0)[..., None]
        tap = sample_2d_array(tex, uv, face, clamped) * w
        acc = tap if acc is None else acc + tap
    return acc


def sample_3d(
    tex: torch.Tensor,  # (D, H, W, C)
    uvw: torch.Tensor,  # (..., 3)
    sampler: SamplerConfig = SamplerConfig(),
) -> torch.Tensor:
    """Volume sample (sampling.py:387-413): linear across the two nearest
    depth slices, each filtered in-plane (the nearest slice under NEAREST)."""
    d = tex.shape[0]
    zc = uvw[..., 2] * d
    if sampler.mag_filter == Filter.NEAREST:
        iz = torch.floor(zc).to(torch.int64)
        iz = torch.remainder(iz, d) if sampler.address_mode_w == AddressMode.REPEAT \
            else torch.clamp(iz, 0, d - 1)
        return sample_2d_array(tex, uvw[..., :2], iz, sampler)
    z = zc - 0.5
    z0 = torch.floor(z)
    fz = (z - z0)[..., None]
    z0 = z0.to(torch.int64)
    if sampler.address_mode_w == AddressMode.REPEAT:
        za, zb = torch.remainder(z0, d), torch.remainder(z0 + 1, d)
    else:
        za, zb = torch.clamp(z0, 0, d - 1), torch.clamp(z0 + 1, 0, d - 1)
    s0 = sample_2d_array(tex, uvw[..., :2], za, sampler)
    s1 = sample_2d_array(tex, uvw[..., :2], zb, sampler)
    return s0 * (1 - fz) + s1 * fz


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


def sample_shadow_pcf_layered(
    shadow_layers: torch.Tensor,  # (L, H, W) or (L, H, W, 1) depth layers
    layer: torch.Tensor,  # (...,) integer per-pixel layer index in [0, L)
    uv: torch.Tensor,  # (..., 2)
    ref_z: torch.Tensor,  # (...,) reference depth to compare
    sampler: SamplerConfig = SamplerConfig.shadow_pcf(),
) -> torch.Tensor:
    """2×2 PCF compare sample from one layer of a depth array texture,
    chosen per pixel (sampling.py:456-502): the cascades of renderer.csm
    and the cube faces of renderer.omni. The taps gather from the flattened
    (L·H·W) stack at a per-pixel layer base, as many gathers as the
    single-layer PCF."""
    if shadow_layers.ndim == 4:
        shadow_layers = shadow_layers[..., 0]
    n_layers, h, w = shadow_layers.shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    cmp = _COMPARE[sampler.compare_op]
    flat = shadow_layers.reshape(-1)
    base = torch.clamp(layer.to(torch.int64), 0, n_layers - 1) * (h * w)
    border = float(sampler.border_color.value[0])

    def tap(ix, iy):
        jx, okx = _wrap_indices(ix, w, sampler.address_mode_u)
        jy, oky = _wrap_indices(iy, h, sampler.address_mode_v)
        d = flat[(base + jy * w + jx).reshape(-1)].reshape(ix.shape)
        ok = okx if oky is None else (oky if okx is None else okx & oky)
        if ok is not None:
            d = torch.where(ok, d, torch.full_like(d, border))
        return cmp(ref_z, d).to(torch.float32)

    t00, t10 = tap(x0, y0), tap(x0 + 1, y0)
    t01, t11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy
