"""Plain PyTorch shading, sampling, post and present encode: the rest of
the reference frame after the raster. Float32 throughout, as the scenes
state; each function says what it computes. Nothing here imports the
program under test."""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)), min=1e-20)


# -- texture sampling ---------------------------------------------------------

def bilinear(tex: torch.Tensor, uv: torch.Tensor, wrap: str) -> torch.Tensor:
    """Bilinear sample of an (H, W, C) image at uv (..., 2), texel centres
    at +0.5; ``wrap`` is "repeat" or "clamp"."""
    h, w = tex.shape[0], tex.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0f)[..., None], (y - y0f)[..., None]
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)

    def fix(i, n):
        return torch.remainder(i, n) if wrap == "repeat" else torch.clamp(i, 0, n - 1)

    flat = tex.reshape(h * w, -1)

    def tap(ix, iy):
        return flat[(fix(iy, h) * w + fix(ix, w)).reshape(-1)].reshape(ix.shape + (-1,))

    top = tap(x0, y0) * (1 - fx) + tap(x0 + 1, y0) * fx
    bot = tap(x0, y0 + 1) * (1 - fx) + tap(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def trilinear(levels: "list[torch.Tensor]", uv: torch.Tensor, lod: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a mip chain (repeat addressing) at a per-pixel
    LOD, clamped to the chain."""
    lmax = len(levels) - 1
    lod = torch.clamp(lod, 0.0, float(lmax))
    l0 = torch.floor(lod)
    frac = (lod - l0)[..., None]
    l0 = l0.to(torch.int64)
    l1 = torch.clamp(l0 + 1, max=lmax)
    out0 = torch.zeros(uv.shape[:-1] + (levels[0].shape[-1],), dtype=F32, device=uv.device)
    out1 = torch.zeros_like(out0)
    for m, lvl in enumerate(levels):
        s = bilinear(lvl, uv, "repeat")
        out0 = torch.where((l0 == m)[..., None], s, out0)
        out1 = torch.where((l1 == m)[..., None], s, out1)
    return out0 * (1 - frac) + out1 * frac


def screen_lod(uv: torch.Tensor, tex_w: int, tex_h: int) -> torch.Tensor:
    """log2 of the larger screen-space UV footprint, from the differences to
    the previous column and row (wrapping round the image's edge)."""
    ddx = uv - torch.roll(uv, 1, dims=1)
    ddy = uv - torch.roll(uv, 1, dims=0)
    rx = torch.sqrt((ddx[..., 0] * tex_w) ** 2 + (ddx[..., 1] * tex_h) ** 2)
    ry = torch.sqrt((ddy[..., 0] * tex_w) ** 2 + (ddy[..., 1] * tex_h) ** 2)
    return torch.log2(torch.clamp(torch.maximum(rx, ry), min=1e-8))


def cube_face_uv(d: torch.Tensor):
    """Vulkan cube-map face selection: (face (...,), uv (..., 2)), faces
    +X -X +Y -Y +Z -Z."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    xm = (ax >= ay) & (ax >= az)
    ym = ~xm & (ay >= az)
    face = torch.where(xm, torch.where(x > 0, 0, 1),
                       torch.where(ym, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)))
    ma = torch.clamp(torch.where(xm, ax, torch.where(ym, ay, az)), min=1e-20)
    sc = torch.where(xm, torch.where(x > 0, -z, z),
                     torch.where(ym, x, torch.where(z > 0, x, -x)))
    tc = torch.where(xm, -y, torch.where(ym, torch.where(y > 0, z, -z), -y))
    return face, torch.stack([0.5 * (sc / ma + 1.0), 0.5 * (tc / ma + 1.0)], -1)


def sample_cube(faces: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Bilinear cube sample, each face clamped at its edges."""
    face, uv = cube_face_uv(d)
    out = torch.zeros(d.shape[:-1] + (faces.shape[-1],), dtype=F32, device=d.device)
    for f in range(6):
        out = torch.where((face == f)[..., None], bilinear(faces[f], uv, "clamp"), out)
    return out


def shadow_pcf(depth: torch.Tensor, uv: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """2×2 percentage-closer filter: each of the four bilinear taps (clamped
    at the edge) is lit where ``ref <= texel``, the results weighted
    bilinearly."""
    h, w = depth.shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    flat = depth.reshape(-1)

    def tap(ix, iy):
        d = flat[(torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1)).reshape(-1)]
        return (ref <= d.reshape(ix.shape)).to(F32)

    top = tap(x0, y0) * (1 - fx) + tap(x0 + 1, y0) * fx
    bot = tap(x0, y0 + 1) * (1 - fx) + tap(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


# -- lighting -----------------------------------------------------------------

def ggx(n, v, l, albedo, metallic, roughness):
    """Cook-Torrance: Trowbridge-Reitz NDF, Smith-Schlick G, Schlick F,
    Lambert diffuse; times N·L."""
    h = normalize(l + v)
    ndl = torch.clamp(torch.sum(n * l, -1, keepdim=True), min=0.0)
    ndv = torch.clamp(torch.sum(n * v, -1, keepdim=True), min=1e-4)
    ndh = torch.clamp(torch.sum(n * h, -1, keepdim=True), min=0.0)
    vdh = torch.clamp(torch.sum(v * h, -1, keepdim=True), min=0.0)
    a = torch.clamp(roughness * roughness, min=1e-3)
    a2 = a * a
    den = ndh * ndh * (a2 - 1.0) + 1.0
    d = a2 / torch.clamp(math.pi * den * den, min=1e-8)
    k = (roughness + 1.0) ** 2 / 8.0
    g = (ndv / (ndv * (1 - k) + k)) * (ndl / torch.clamp(ndl * (1 - k) + k, min=1e-8))
    f0 = 0.04 * (1.0 - metallic) + albedo * metallic
    f = f0 + (1.0 - f0) * torch.pow(1.0 - vdh, 5.0)
    spec = d * g * f / torch.clamp(4.0 * ndv * ndl, min=1e-4)
    return ((1.0 - f) * (1.0 - metallic) * albedo / math.pi + spec) * ndl


def point_lights(albedo, metallic, n, roughness, world, covered, cam, lights):
    """Σ over point lights of GGX × 1/d² × (1 - (d/r)⁴)², densely, in light
    order. ``lights``: (L, 7) rows px py pz radius cr cg cb (colour times
    intensity)."""
    v = normalize(cam - world)
    out = torch.zeros_like(world)
    for row in lights:
        to_l = row[:3] - world
        d2 = torch.clamp(torch.sum(to_l * to_l, -1, keepdim=True), min=1e-8)
        dist = torch.sqrt(d2)
        l = to_l / dist
        q = dist / row[3]
        win = torch.clamp(1.0 - (q * q) ** 2, 0.0, 1.0) ** 2
        out = out + ggx(n, v, l, albedo, metallic, roughness) * row[4:7] * (win / d2)
    return torch.where(covered, out, torch.zeros_like(out))


def view_rays(inv_vp: torch.Tensor, cam: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Per-pixel world-space rays (not normalised) through each pixel
    centre at NDC depth 0.5."""
    dev = inv_vp.device
    nx = (torch.arange(w, dtype=F32, device=dev) + 0.5) / w * 2 - 1
    ny = (torch.arange(h, dtype=F32, device=dev) + 0.5) / h * 2 - 1
    px = nx[None, :].expand(h, w)
    py = ny[:, None].expand(h, w)
    ndc = torch.stack([px, py, torch.full_like(px, 0.5), torch.ones_like(px)], -1)
    p = ndc.reshape(-1, 4) @ inv_vp.T
    p = p.reshape(h, w, 4)
    return p[..., :3] / p[..., 3:4] - cam


# -- post and present ---------------------------------------------------------

_GAUSS9 = (0.0162162, 0.0540541, 0.1216216, 0.1945946, 0.2270270,
           0.1945946, 0.1216216, 0.0540541, 0.0162162)


def luma(rgb):
    return rgb[..., 0:1] * 0.2126 + rgb[..., 1:2] * 0.7152 + rgb[..., 2:3] * 0.0722


def bloom_aces(hdr: torch.Tensor, threshold: float = 1.0, strength: float = 0.35) -> torch.Tensor:
    """Bloom (bright pass, half-size, two 9-tap gaussian passes per axis
    that wrap round the edge, nearest upsample) added to the HDR colour,
    then the Narkowicz ACES curve, clamped to [0, 1]."""
    rgb = hdr[..., :3]
    h, w = rgb.shape[0], rgb.shape[1]
    lm = luma(rgb)
    bright = rgb * torch.clamp(lm - threshold, min=0.0) / torch.clamp(lm, min=1e-4)
    hh, ww = h & ~1, w & ~1
    half = bright[:hh, :ww].reshape(hh // 2, 2, ww // 2, 2, 3).mean(dim=(1, 3))
    for _ in range(2):
        for axis in (0, 1):
            acc = torch.zeros_like(half)
            for i, wt in enumerate(_GAUSS9):
                acc = acc + torch.roll(half, i - 4, dims=axis) * float(np.float32(wt))
            half = acc
    up = half.repeat_interleave(2, 0).repeat_interleave(2, 1)
    if up.shape[0] < h or up.shape[1] < w:
        up = torch.nn.functional.pad(up.permute(2, 0, 1)[None],
                                     (0, w - up.shape[1], 0, h - up.shape[0]),
                                     mode="replicate")[0].permute(1, 2, 0)
    x = rgb + up[:h, :w] * strength
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    mapped = torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)
    return torch.cat([mapped, hdr[..., 3:4]], -1)


def encode_bgra8_srgb(ldr: torch.Tensor) -> torch.Tensor:
    """Linear RGBA → sRGB-encoded BGRA8 (alpha linear), round to nearest."""
    x = torch.clamp(ldr[..., :3], 0.0, 1.0)
    srgb = torch.where(x <= 0.0031308, x * 12.92, 1.055 * torch.pow(x, 1.0 / 2.4) - 0.055)
    out = torch.cat([srgb.flip(-1), torch.clamp(ldr[..., 3:4], 0.0, 1.0)], -1)
    return torch.round(out * 255.0).to(torch.uint8)
