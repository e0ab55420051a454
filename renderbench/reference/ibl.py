"""Split-sum image-based lighting of the reference: the environment's
diffuse irradiance as 9 spherical-harmonic coefficients (Ramamoorthi &
Hanrahan 2001), its specular term as a GGX-prefiltered cube mip chain
(Karis 2013: importance sampling over Hammersley points, N = V = R), and
the analytic environment BRDF (Karis's mobile fit)."""

from __future__ import annotations

import numpy as np
import torch

from reference import shade

F32 = torch.float32

_FACE_BASIS = np.asarray([
    [[1, 0, 0], [0, 0, -1], [0, -1, 0]],
    [[-1, 0, 0], [0, 0, 1], [0, -1, 0]],
    [[0, 1, 0], [1, 0, 0], [0, 0, 1]],
    [[0, -1, 0], [1, 0, 0], [0, 0, -1]],
    [[0, 0, 1], [1, 0, 0], [0, -1, 0]],
    [[0, 0, -1], [-1, 0, 0], [0, -1, 0]],
], np.float32)
SH_C = np.asarray([0.282095, 0.488603, 0.488603, 0.488603,
                   1.092548, 1.092548, 0.315392, 1.092548, 0.546274], np.float32)
SH_A_OVER_PI = np.asarray([1.0, 2.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0,
                           0.25, 0.25, 0.25, 0.25, 0.25], np.float32)


def face_directions(size: int) -> np.ndarray:
    """(6, S, S, 3) unit directions through the face texel centres."""
    t = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    sc = np.broadcast_to(t[None, :], (size, size))
    tc = np.broadcast_to(t[:, None], (size, size))
    d = (_FACE_BASIS[:, None, None, 0] + sc[None, ..., None] * _FACE_BASIS[:, None, None, 1]
         + tc[None, ..., None] * _FACE_BASIS[:, None, None, 2])
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def texel_solid_angles(size: int) -> np.ndarray:
    def area(x, y):
        return np.arctan2(x * y, np.sqrt(x * x + y * y + 1.0))
    e = np.arange(size + 1, dtype=np.float64) / size * 2.0 - 1.0
    x0, x1 = e[:-1][None, :], e[1:][None, :]
    y0, y1 = e[:-1][:, None], e[1:][:, None]
    return (area(x1, y1) - area(x0, y1) - area(x1, y0) + area(x0, y0)).astype(np.float32)


def sh9(cube: np.ndarray) -> np.ndarray:
    """(9, 3) radiance projection of a (6, S, S, C) cube, float32."""
    cube = np.asarray(cube, np.float32)
    d = face_directions(cube.shape[1])
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    basis = np.stack([np.full_like(x, SH_C[0]), SH_C[1] * y, SH_C[2] * z, SH_C[3] * x,
                      SH_C[4] * x * y, SH_C[5] * y * z, SH_C[6] * (3.0 * z * z - 1.0),
                      SH_C[7] * x * z, SH_C[8] * (x * x - y * y)], axis=-1)
    rad = cube[..., :3] * texel_solid_angles(cube.shape[1])[None, :, :, None]
    return (basis.reshape(-1, 9).T @ rad.reshape(-1, 3)).astype(np.float32)


def eval_sh9(sh: torch.Tensor, n: torch.Tensor, matmul) -> torch.Tensor:
    """E(n)/π from the coefficients at unit normals, clamped at 0."""
    c = [float(v) for v in SH_C]
    a = [float(v) for v in SH_A_OVER_PI]
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    cols = [torch.full_like(x, c[0]), c[1] * y, c[2] * z, c[3] * x, c[4] * x * y,
            c[5] * y * z, c[6] * (3.0 * z * z - 1.0), c[7] * x * z, c[8] * (x * x - y * y)]
    basis = torch.stack([col * w for col, w in zip(cols, a)], -1)
    out = matmul(basis.reshape(-1, 9), sh).reshape(n.shape[:-1] + (3,))
    return torch.clamp(out, min=0.0)


def hammersley(count: int) -> np.ndarray:
    i = np.arange(count, dtype=np.uint32)
    b = ((i << np.uint32(16)) | (i >> np.uint32(16))) & np.uint32(0xFFFFFFFF)
    b = ((b & np.uint32(0x55555555)) << np.uint32(1)) | ((b & np.uint32(0xAAAAAAAA)) >> np.uint32(1))
    b = ((b & np.uint32(0x33333333)) << np.uint32(2)) | ((b & np.uint32(0xCCCCCCCC)) >> np.uint32(2))
    b = ((b & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | ((b & np.uint32(0xF0F0F0F0)) >> np.uint32(4))
    b = ((b & np.uint32(0x00FF00FF)) << np.uint32(8)) | ((b & np.uint32(0xFF00FF00)) >> np.uint32(8))
    return np.stack([i.astype(np.float64) / count, b.astype(np.float64) * 2.3283064365386963e-10],
                    axis=-1).astype(np.float32)


def ggx_half_vectors(xi: np.ndarray, roughness: float) -> np.ndarray:
    a = max(roughness * roughness, 1e-4)
    phi = 2.0 * np.pi * xi[:, 0]
    cos_t = np.sqrt((1.0 - xi[:, 1]) / (1.0 + (a * a - 1.0) * xi[:, 1]))
    sin_t = np.sqrt(np.maximum(1.0 - cos_t * cos_t, 0.0))
    return np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], -1).astype(np.float32)


def prefilter(cube: torch.Tensor, num_mips: int = 5, samples: int = 64) -> "list[torch.Tensor]":
    """Mip m (size S/2^m) is the cube convolved with the GGX lobe at
    roughness m/(num_mips-1); mip 0 is the cube. Samples accumulate in
    order; each world half-vector hx·t + hy·b + hz·n takes its last
    product and sum in one rounding, as a fused multiply-add does (a tap
    near a cube edge turns on it)."""
    size, chans, dev = int(cube.shape[1]), int(cube.shape[-1]), cube.device
    xi = hammersley(samples)
    out = [cube]
    for m in range(1, num_mips):
        sm = size >> m
        n = torch.from_numpy(np.ascontiguousarray(face_directions(sm).reshape(-1, 3))).to(dev)
        up = torch.zeros_like(n)
        up[:, 2] = 1.0
        side = torch.zeros_like(n)
        side[:, 0] = 1.0
        helper = torch.where(torch.abs(n[:, 2:3]) < 0.999, up, side)
        t = torch.linalg.cross(helper, n)
        t = t / torch.linalg.norm(t, dim=-1, keepdim=True)
        b = torch.linalg.cross(n, t)
        hv = ggx_half_vectors(xi, m / (num_mips - 1))
        color = torch.zeros((n.shape[0], chans), dtype=F32, device=dev)
        weight = torch.zeros((n.shape[0], 1), dtype=F32, device=dev)
        for k in range(samples):
            hx, hy, hz = (float(v) for v in hv[k])
            h = (hz * n.double() + (hx * t + hy * b).double()).to(F32)
            ndh = torch.sum(n * h, -1, keepdim=True)
            l = 2.0 * ndh * h - n
            ndl = torch.clamp(torch.sum(n * l, -1, keepdim=True), min=0.0)
            color = color + shade.sample_cube(cube, l)[..., :chans] * ndl
            weight = weight + ndl
        out.append((color / torch.clamp(weight, min=1e-6)).reshape(6, sm, sm, chans))
    return out


def sample_cube_lod(levels: "list[torch.Tensor]", d: torch.Tensor, lod: torch.Tensor):
    """Trilinear across the cube's levels at an explicit LOD: each level
    weighted by max(0, 1 - |lod - m|)."""
    lod = torch.clamp(lod, 0.0, float(len(levels) - 1))
    acc = None
    for m, lvl in enumerate(levels):
        w = torch.clamp(1.0 - torch.abs(lod - m), 0.0, 1.0)[..., None]
        tap = shade.sample_cube(lvl, d) * w
        acc = tap if acc is None else acc + tap
    return acc


def env_brdf(ndv: torch.Tensor, roughness: torch.Tensor):
    """(scale, bias) with specular ≈ prefiltered · (F0 · scale + bias)."""
    rx = roughness * -1.0 + 1.0
    ry = roughness * -0.0275 + 0.0425
    rz = roughness * -0.572 + 1.04
    rw = roughness * 0.022 - 0.04
    a004 = torch.minimum(rx * rx, torch.exp2(-9.28 * ndv)) * rx + ry
    return (torch.clamp(a004 * -1.04 + rz, 0.0, 1.0),
            torch.clamp(a004 * 1.04 + rw, 0.0, 1.0))
