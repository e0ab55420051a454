"""Image-based lighting — environment-map preintegration for the PBR
resolve, the split-sum approximation (torch port of zenith_tpu/ops/ibl.py).

- ``irradiance_sh9``: diffuse irradiance projected onto 9 spherical-
  harmonic coefficients (Ramamoorthi & Hanrahan 2001), evaluated per pixel
  in the lighting resolve by ``eval_irradiance_sh9``.
- ``prefilter_ggx``: the specular prefiltered mip chain, each mip the
  environment convolved with the GGX lobe of increasing roughness by
  importance sampling (Karis 2013), over Hammersley points.
- ``env_brdf_approx``: the analytic split-sum BRDF term (the Karis "mobile"
  fit of the 2D LUT).

The face directions, solid angles, Hammersley points, GGX half-vectors and
the host SH projection are NumPy (copies of the reference's); the rest is
torch on the cube's device.
"""

from __future__ import annotations

import numpy as np
import torch

from zenith_tpu_torch.ops.sampling import sample_cube
from zenith_tpu_torch.rhi.sampler import SamplerConfig

# Vulkan cube face order: +X -X +Y -Y +Z -Z (sampling.cube_direction_to_face_uv).
# Rows: direction = axis + (2u-1)*du + (2v-1)*dv, normalized.
_FACE_BASIS = np.asarray(
    [
        # axis          du (sc)         dv (tc)
        [[1, 0, 0],     [0, 0, -1],     [0, -1, 0]],   # +X
        [[-1, 0, 0],    [0, 0, 1],      [0, -1, 0]],   # -X
        [[0, 1, 0],     [1, 0, 0],      [0, 0, 1]],    # +Y
        [[0, -1, 0],    [1, 0, 0],      [0, 0, -1]],   # -Y
        [[0, 0, 1],     [1, 0, 0],      [0, -1, 0]],   # +Z
        [[0, 0, -1],    [-1, 0, 0],     [0, -1, 0]],   # -Z
    ],
    np.float32,
)


def cube_face_directions(size: int) -> np.ndarray:
    """(6, S, S, 3) unit directions at face texel centres (host constant;
    the inverse of ``sampling.cube_direction_to_face_uv``)."""
    t = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    sc = np.broadcast_to(t[None, :], (size, size))
    tc = np.broadcast_to(t[:, None], (size, size))
    dirs = (
        _FACE_BASIS[:, None, None, 0]
        + sc[None, ..., None] * _FACE_BASIS[:, None, None, 1]
        + tc[None, ..., None] * _FACE_BASIS[:, None, None, 2]
    )
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def cube_texel_solid_angles(size: int) -> np.ndarray:
    """(S, S) solid angle of each face texel (the same for all six faces):
    ω = AE(x1,y1) − AE(x0,y1) − AE(x1,y0) + AE(x0,y0)."""

    def area(x, y):
        return np.arctan2(x * y, np.sqrt(x * x + y * y + 1.0))

    e = np.arange(size + 1, dtype=np.float64) / size * 2.0 - 1.0
    x0, x1 = e[:-1][None, :], e[1:][None, :]
    y0, y1 = e[:-1][:, None], e[1:][:, None]
    w = area(x1, y1) - area(x0, y1) - area(x1, y0) + area(x0, y0)
    return w.astype(np.float32)


# Real SH basis constants (l ≤ 2) and the cosine-lobe convolution weights
# Â_l = (π, 2π/3, π/4) folded with 1/π, so evaluation yields the Lambertian
# radiance factor directly (outgoing = albedo * eval).
_SH_C = np.asarray(
    [0.282095, 0.488603, 0.488603, 0.488603,
     1.092548, 1.092548, 0.315392, 1.092548, 0.546274],
    np.float32,
)
_SH_A_OVER_PI = np.asarray(
    [1.0, 2.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0,
     0.25, 0.25, 0.25, 0.25, 0.25],
    np.float32,
)


def _sh9_basis(d: torch.Tensor, weights=None) -> torch.Tensor:
    """(..., 3) unit directions → (..., 9) real SH basis values, each
    times ``weights[i]`` where given (Python floats: no host copy)."""
    c = [float(v) for v in _SH_C]
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    cols = [torch.full_like(x, c[0]),
            c[1] * y, c[2] * z, c[3] * x,
            c[4] * x * y, c[5] * y * z,
            c[6] * (3.0 * z * z - 1.0),
            c[7] * x * z, c[8] * (x * x - y * y)]
    if weights is not None:
        cols = [col * float(w) for col, w in zip(cols, weights)]
    return torch.stack(cols, dim=-1)


def irradiance_sh9(cube: torch.Tensor) -> torch.Tensor:
    """Project environment radiance onto 9 SH coefficients → (9, 3) on the
    cube's device. ``cube`` is a (6, S, S, C≥3) linear-radiance cube map;
    one (9, 6S²) @ (6S², 3) product."""
    size = cube.shape[1]
    dev = cube.device
    dirs = torch.from_numpy(cube_face_directions(size)).to(dev)
    dw = torch.from_numpy(cube_texel_solid_angles(size)).to(dev)
    basis = _sh9_basis(dirs)  # (6, S, S, 9)
    rad = cube[..., :3] * dw[None, :, :, None]  # radiance · dω
    return basis.reshape(-1, 9).T @ rad.reshape(-1, 3)


def eval_irradiance_sh9(sh: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(9, 3) coefficients + (..., 3) unit normals → (..., 3) Lambertian
    radiance factor E(n)/π (multiply by albedo for outgoing radiance)."""
    basis = _sh9_basis(n, _SH_A_OVER_PI)  # (..., 9)
    return torch.clamp(basis @ sh, min=0.0)


def irradiance_sh9_host(cube: np.ndarray) -> np.ndarray:
    """NumPy twin of ``irradiance_sh9`` for host-resident pixels → (9, 3)
    float32, so the coefficients of a host environment ride as a host
    dynamic with no read from the device."""
    cube = np.asarray(cube, np.float32)
    size = cube.shape[1]
    d = cube_face_directions(size)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    basis = np.stack(
        [np.full_like(x, _SH_C[0]),
         _SH_C[1] * y, _SH_C[2] * z, _SH_C[3] * x,
         _SH_C[4] * x * y, _SH_C[5] * y * z,
         _SH_C[6] * (3.0 * z * z - 1.0),
         _SH_C[7] * x * z, _SH_C[8] * (x * x - y * y)],
        axis=-1,
    )
    dw = cube_texel_solid_angles(size)
    rad = cube[..., :3] * dw[None, :, :, None]
    return (basis.reshape(-1, 9).T @ rad.reshape(-1, 3)).astype(np.float32)


def _hammersley(count: int) -> np.ndarray:
    """(K, 2) Hammersley low-discrepancy points (van der Corput base 2)."""
    i = np.arange(count, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << np.uint32(16)) | (bits >> np.uint32(16))) & np.uint32(0xFFFFFFFF)
    bits = ((bits & np.uint32(0x55555555)) << np.uint32(1)) | (
        (bits & np.uint32(0xAAAAAAAA)) >> np.uint32(1))
    bits = ((bits & np.uint32(0x33333333)) << np.uint32(2)) | (
        (bits & np.uint32(0xCCCCCCCC)) >> np.uint32(2))
    bits = ((bits & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | (
        (bits & np.uint32(0xF0F0F0F0)) >> np.uint32(4))
    bits = ((bits & np.uint32(0x00FF00FF)) << np.uint32(8)) | (
        (bits & np.uint32(0xFF00FF00)) >> np.uint32(8))
    return np.stack(
        [i.astype(np.float64) / count, bits.astype(np.float64) * 2.3283064365386963e-10],
        axis=-1,
    ).astype(np.float32)


def _ggx_importance_dirs(xi: np.ndarray, roughness: float) -> np.ndarray:
    """(K, 2) points → (K, 3) GGX half-vectors in tangent space (+Z normal)."""
    a = max(roughness * roughness, 1e-4)
    phi = 2.0 * np.pi * xi[:, 0]
    cos_t = np.sqrt((1.0 - xi[:, 1]) / (1.0 + (a * a - 1.0) * xi[:, 1]))
    sin_t = np.sqrt(np.maximum(1.0 - cos_t * cos_t, 0.0))
    return np.stack(
        [sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], axis=-1
    ).astype(np.float32)


def _half_vector_fma(h_tan: np.ndarray, t: torch.Tensor, b: torch.Tensor,
                     n: torch.Tensor) -> torch.Tensor:
    """One GGX half-vector in world space, hx·t + hy·b + hz·n, rounded as
    XLA's CPU ``jit`` rounds the reference's compiled loop body: the first
    two products and their sum in float32, the last product added to them
    in one fused multiply-add (emulated in float64). Rounded op by op, a
    few texels of the rough mips sent a tap across a cube edge (up to 0.48
    apart on a random cube); this order matched the reference on every
    texel of four random cubes (16² to 32², 8 to 64 samples)."""
    hx, hy, hz = (float(v) for v in h_tan)
    return (hz * n.double() + (hx * t + hy * b).double()).to(torch.float32)


def prefilter_ggx(cube: torch.Tensor, num_mips: int = 5,
                  samples: int = 64) -> "list[torch.Tensor]":
    """GGX-prefiltered specular mip chain (split-sum term 1) on the cube's
    device: mip m (size S/2^m) is the environment convolved with the GGX
    lobe at roughness m/(num_mips−1) under N = V = R; mip 0 is the cube
    itself. The samples accumulate one after another in the reference's
    order (its ``fori_loop``), each half-vector rounded as the reference's
    compiled loop rounds it (``_half_vector_fma``). Returns ``num_mips`` tensors
    [(6, S_m, S_m, C), ...]."""
    size = int(cube.shape[1])
    chans = int(cube.shape[-1])
    if num_mips < 2 or size >> (num_mips - 1) < 4:
        raise ValueError(f"cube size {size} too small for {num_mips} mips")
    dev = cube.device
    xi = _hammersley(samples)
    out = [cube]
    lin = SamplerConfig.linear()
    for m in range(1, num_mips):
        roughness = m / (num_mips - 1)
        sm = size >> m
        n = torch.from_numpy(np.ascontiguousarray(cube_face_directions(sm).reshape(-1, 3))).to(dev)
        # Per-direction tangent frame (branchless up-vector selection).
        up = torch.zeros_like(n)
        up[:, 2] = 1.0
        side = torch.zeros_like(n)
        side[:, 0] = 1.0
        helper = torch.where(torch.abs(n[:, 2:3]) < 0.999, up, side)
        t = torch.linalg.cross(helper, n)
        t = t / torch.linalg.norm(t, dim=-1, keepdim=True)
        b = torch.linalg.cross(n, t)
        h_tan = _ggx_importance_dirs(xi, roughness)  # (K, 3) host
        color = torch.zeros((n.shape[0], chans), dtype=torch.float32, device=dev)
        weight = torch.zeros((n.shape[0], 1), dtype=torch.float32, device=dev)
        for k in range(samples):
            h = _half_vector_fma(h_tan[k], t, b, n)
            ndh = torch.sum(n * h, dim=-1, keepdim=True)
            l = 2.0 * ndh * h - n  # reflect V(=N) about H
            ndl = torch.clamp(torch.sum(n * l, dim=-1, keepdim=True), min=0.0)
            tap = sample_cube(cube, l, lin)[..., :chans]
            color = color + tap * ndl
            weight = weight + ndl
        out.append((color / torch.clamp(weight, min=1e-6)).reshape(6, sm, sm, chans))
    return out


def env_brdf_approx(ndv: torch.Tensor, roughness: torch.Tensor):
    """Analytic split-sum environment BRDF (the Karis "mobile" polynomial
    fit of the 2D LUT): returns (scale, bias) such that specular ≈
    prefiltered · (F0 · scale + bias)."""
    rx = roughness * -1.0 + 1.0
    ry = roughness * -0.0275 + 0.0425
    rz = roughness * -0.572 + 1.04
    rw = roughness * 0.022 - 0.04
    a004 = torch.minimum(rx * rx, torch.exp2(-9.28 * ndv)) * rx + ry
    # The raw fit strays a few 1e-3 outside [0, 1] at the corners of the
    # domain; clamp to the physical range of the split-sum integral.
    scale = torch.clamp(a004 * -1.04 + rz, 0.0, 1.0)
    bias = torch.clamp(a004 * 1.04 + rw, 0.0, 1.0)
    return scale, bias
