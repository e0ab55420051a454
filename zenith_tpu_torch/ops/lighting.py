"""Tiled deferred point/spot-light accumulation over kernel K2 (torch port
of zenith_tpu/ops/lighting.py).

For CUDA tensors ``accumulate_point_lights`` launches K2, the hand-written
CUDA kernel in ``zenith_tpu_torch/csrc/lighting.cu`` (its source note says
what it replaces and what bounds it). For CPU tensors it runs
``_accumulate_point_lights_torch``, the plain PyTorch version of the same
computation, which is also the kernel's oracle on the card. There is no
fallback between the two: a CUDA tensor launches the kernel or raises.

Both cull per framebuffer region: each region takes the world-space AABB
of its covered pixels (depth > 0), culls every light by a sphere-vs-AABB
test, and sums the Cook-Torrance GGX BRDF × inverse square × distance window
× spot cone of the lights that hit, in light order. The plain version's
regions are the reference's (tile_h, tile_w) tiles; the kernel's are its
own ``KERNEL_CULL`` regions, whatever the tiles: a light beyond its radius
from a region adds 0 to every pixel of it, so any conservative cull gives
the same sum up to rounding (csrc/lighting.cu says why).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from zenith_tpu_torch.ops.runtime import cdiv, count_launch, load_kernels, on_cuda

KERNEL_CULL = (16, 16)  # the kernel's cull region, (rows, columns): csrc/lighting.cu kSubH x kSubW
_BIG = 3.0e38
_INV_PI = 1.0 / math.pi


def _ggx_point_light(nx, ny, nz, vx, vy, vz, lx, ly, lz, ar, ag, ab, metallic, roughness):
    """Cook-Torrance GGX for one light direction on component planes
    (lighting.py:34-68; mirrors renderer.deferred._ggx_brdf)."""
    hx, hy, hz = lx + vx, ly + vy, lz + vz
    hn = torch.rsqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-16))
    hx, hy, hz = hx * hn, hy * hn, hz * hn

    ndl = torch.clamp(nx * lx + ny * ly + nz * lz, min=0.0)
    ndv = torch.clamp(nx * vx + ny * vy + nz * vz, min=1e-4)
    ndh = torch.clamp(nx * hx + ny * hy + nz * hz, min=0.0)
    vdh = torch.clamp(vx * hx + vy * hy + vz * hz, min=0.0)

    a = torch.clamp(roughness * roughness, min=1e-3)
    a2 = a * a
    denom = ndh * ndh * (a2 - 1.0) + 1.0
    d = a2 / torch.clamp(math.pi * denom * denom, min=1e-8)

    k = (roughness + 1.0) * (roughness + 1.0) / 8.0
    g = (ndv / (ndv * (1 - k) + k)) * (ndl / torch.clamp(ndl * (1 - k) + k, min=1e-8))

    f0r = 0.04 * (1.0 - metallic) + ar * metallic
    f0g = 0.04 * (1.0 - metallic) + ag * metallic
    f0b = 0.04 * (1.0 - metallic) + ab * metallic
    fres = torch.pow(1.0 - vdh, 5.0)
    fr = f0r + (1.0 - f0r) * fres
    fg = f0g + (1.0 - f0g) * fres
    fb = f0b + (1.0 - f0b) * fres

    spec_s = d * g / torch.clamp(4.0 * ndv * ndl, min=1e-4)
    out_r = ((1.0 - fr) * (1.0 - metallic) * ar * _INV_PI + spec_s * fr) * ndl
    out_g = ((1.0 - fg) * (1.0 - metallic) * ag * _INV_PI + spec_s * fg) * ndl
    out_b = ((1.0 - fb) * (1.0 - metallic) * ab * _INV_PI + spec_s * fb) * ndl
    return out_r, out_g, out_b


def light_table(
    light_pos: torch.Tensor,  # (L, 3)
    light_color: torch.Tensor,  # (L, 3)
    light_radius: torch.Tensor,  # (L,)
    spot_params: "Optional[torch.Tensor]" = None,  # (L, 5): dir3 cos_inner cos_outer
) -> torch.Tensor:
    """The (L, 16) light rows both versions read (lighting.py:191-219):
    px py pz radius cr cg cb spot dx dy dz cos_outer inv_cone pad pad pad.
    Built with tensor ops on the lights' device (no host read)."""
    l = light_pos.shape[0]
    pos = light_pos.to(torch.float32).reshape(l, 3)
    col = light_color.to(torch.float32).reshape(l, 3)
    rad = light_radius.to(torch.float32).reshape(l, 1)
    zeros = torch.zeros((l, 1), dtype=torch.float32, device=pos.device)
    if spot_params is None:
        return torch.cat([pos, rad, col, zeros, zeros.expand(l, 8)], dim=1).contiguous()
    sp = spot_params.to(torch.float32).reshape(l, 5)
    d = sp[:, :3]
    is_spot = (torch.linalg.vector_norm(d, dim=1, keepdim=True) > 1e-6).to(torch.float32)
    inv_cone = 1.0 / torch.clamp(sp[:, 3:4] - sp[:, 4:5], min=1e-4)
    return torch.cat(
        [pos, rad, col, is_spot, d, sp[:, 4:5], inv_cone, zeros.expand(l, 3)], dim=1
    ).contiguous()


def accumulate_point_lights(
    albedo_metal: torch.Tensor,  # (H, W, 4)
    normal_rough: torch.Tensor,  # (H, W, 4)
    pos_emissive: torch.Tensor,  # (H, W, 4)
    depth: torch.Tensor,  # (H, W) coverage: > 0
    camera_pos: torch.Tensor,  # (3,)
    light_pos: torch.Tensor,  # (L, 3)
    light_color: torch.Tensor,  # (L, 3)
    light_radius: torch.Tensor,  # (L,)
    tile_h: int = 16,
    tile_w: int = 128,
    spot_params: "Optional[torch.Tensor]" = None,  # (L, 5): dir3 ci co
) -> torch.Tensor:
    """Tile-culled point/spot-light sum → (H, W, 3) linear radiance
    (lighting.py:164-260). ``spot_params`` rows are (dir_x, dir_y, dir_z,
    cos_inner, cos_outer); a row of zeros marks a point light."""
    h, w = depth.shape
    l = light_pos.shape[0]
    if l == 0:
        return torch.zeros((h, w, 3), dtype=torch.float32, device=depth.device)
    lights = light_table(light_pos, light_color, light_radius, spot_params)
    cam = camera_pos.to(torch.float32).reshape(3)
    if on_cuda(depth):
        return _accumulate_point_lights_cuda(
            albedo_metal, normal_rough, pos_emissive, depth, cam, lights, tile_h, tile_w
        )
    return _accumulate_point_lights_torch(
        albedo_metal, normal_rough, pos_emissive, depth, cam, lights, tile_h, tile_w
    )


accumulate_point_lights.launches = 0  # K2 launches (counted in _accumulate_point_lights_cuda)


def _accumulate_point_lights_cuda(am, nr, pe, depth, cam, lights, tile_h, tile_w):
    """Launch K2 on the current stream → (H, W, 3). The kernel culls its own
    ``KERNEL_CULL`` regions: ``tile_h`` and ``tile_w`` only shape the plain
    version's cull."""
    h, w = depth.shape
    dev = depth.device
    planes = []
    for name, t in (("albedo_metal", am), ("normal_rough", nr), ("pos_emissive", pe)):
        if tuple(t.shape) != (h, w, 4) or t.device != dev:
            raise ValueError(f"K2: {name} must be ({h}, {w}, 4) on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
        planes.append(t.to(torch.float32).contiguous())
    z = depth.to(torch.float32).contiguous()
    if cam.device != dev or lights.device != dev:
        raise ValueError("K2: camera and lights must be on the G-buffer's device")
    if not lights.is_contiguous() or lights.data_ptr() % 16:
        raise ValueError("K2 takes a contiguous 16-byte-aligned (L, 16) light table")
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.zn_tiled_lights(
        planes[0].data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(), z.data_ptr(),
        lights.data_ptr(), cam.data_ptr(), out.data_ptr(),
        lights.shape[0], h, w, stream,
    )
    if err != 0:
        raise RuntimeError(f"K2 launch failed: CUDA error {err}")
    count_launch(accumulate_point_lights)
    return out


def _tile_hits(covered, wx, wy, wz, lights) -> torch.Tensor:
    """(T, L) bool: light l may touch tile t — the squared distance from the
    light to the world AABB of the tile's covered pixels is within its
    radius² (lighting.py:88-122). Tiles with no covered pixel hit nothing."""
    big = torch.full_like(wx, _BIG)

    def box(v):
        return (torch.where(covered, v, big).amin(dim=1)[:, None],
                torch.where(covered, v, -big).amax(dim=1)[:, None])

    dist2 = torch.zeros((covered.shape[0], lights.shape[0]), dtype=torch.float32,
                        device=covered.device)
    for axis, v in enumerate((wx, wy, wz)):
        lo, hi = box(v)
        p = lights[None, :, axis]
        dd = torch.clamp(torch.maximum(lo - p, p - hi), min=0.0)
        dist2 = dist2 + dd * dd
    return (dist2 <= lights[None, :, 3] * lights[None, :, 3]) & covered.any(dim=1)[:, None]


def _tiles(img: torch.Tensor, tile_h: int, tile_w: int) -> torch.Tensor:
    """(H, W[, C]) → (C, tiles, tile_h·tile_w) float32, zero-padded to whole
    tiles (lighting.py:224-238), tiles in row-major order."""
    img = img.to(torch.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ty, tx = cdiv(h, tile_h), cdiv(w, tile_w)
    p = torch.zeros((ty * tile_h, tx * tile_w, c), dtype=torch.float32, device=img.device)
    p[:h, :w] = img
    p = p.view(ty, tile_h, tx, tile_w, c).permute(4, 0, 2, 1, 3)
    return p.reshape(c, ty * tx, tile_h * tile_w)


def tile_light_hits(depth: torch.Tensor, pos_emissive: torch.Tensor, lights: torch.Tensor,
                    tile_h: int = 16, tile_w: int = 128) -> torch.Tensor:
    """The (tiles, L) cull decisions both versions make: how much work this
    frame's G-buffer and light table ask for."""
    pet = _tiles(pos_emissive[..., :3], tile_h, tile_w)
    covered = _tiles(depth, tile_h, tile_w)[0] > 0.0
    return _tile_hits(covered, pet[0], pet[1], pet[2], lights)


def _accumulate_point_lights_torch(am, nr, pe, depth, cam, lights, tile_h, tile_w):
    """Plain PyTorch version of K2: the same per-tile AABB cull and the same
    sum in light order, vectorised over tiles (a light adds exactly zero to
    every pixel of a tile it does not hit)."""
    h, w = depth.shape
    dev = depth.device
    ty, tx = cdiv(h, tile_h), cdiv(w, tile_w)
    hp, wp = ty * tile_h, tx * tile_w
    amt, nrt, pet = (_tiles(t, tile_h, tile_w) for t in (am, nr, pe))
    covered = _tiles(depth, tile_h, tile_w)[0] > 0.0  # (T, P)
    wx, wy, wz = pet[0], pet[1], pet[2]
    hits = _tile_hits(covered, wx, wy, wz, lights)  # (T, L)

    nx, ny, nz, rough = nrt[0], nrt[1], nrt[2], nrt[3]
    ar, ag, ab, metal = amt[0], amt[1], amt[2], amt[3]
    vx, vy, vz = cam[0] - wx, cam[1] - wy, cam[2] - wz
    vn = torch.rsqrt(torch.clamp(vx * vx + vy * vy + vz * vz, min=1e-16))
    vx, vy, vz = vx * vn, vy * vn, vz * vn

    out = torch.zeros((3,) + covered.shape, dtype=torch.float32, device=dev)
    for li in range(lights.shape[0]):
        row = lights[li]
        px, py, pz, radius = row[0], row[1], row[2], row[3]
        hit = hits[:, li:li + 1]

        tx_, ty_, tz_ = px - wx, py - wy, pz - wz
        d2 = torch.clamp(tx_ * tx_ + ty_ * ty_ + tz_ * tz_, min=1e-8)
        dist = torch.sqrt(d2)
        inv = 1.0 / dist
        lxp, lyp, lzp = tx_ * inv, ty_ * inv, tz_ * inv
        att = 1.0 / torch.clamp(d2, min=1e-8)
        q = dist / radius
        q2 = q * q
        win = torch.clamp(1.0 - q2 * q2, 0.0, 1.0)
        win = win * win
        br, bg, bb = _ggx_point_light(nx, ny, nz, vx, vy, vz, lxp, lyp, lzp,
                                      ar, ag, ab, metal, rough)
        cosang = -(lxp * row[8] + lyp * row[9] + lzp * row[10])
        t = torch.clamp((cosang - row[11]) * row[12], 0.0, 1.0)
        cone = 1.0 + row[7] * (t * t - 1.0)
        wgt = torch.where(covered, att * win * cone, torch.zeros_like(att))
        for c, b in enumerate((br, bg, bb)):
            out[c] = torch.where(hit, out[c] + b * row[4 + c] * wgt, out[c])

    out = out.view(3, ty, tx, tile_h, tile_w).permute(1, 3, 2, 4, 0).reshape(hp, wp, 3)
    return out[:h, :w].contiguous()
