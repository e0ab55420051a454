"""Screen-space ambient occlusion over the deferred G-buffer (torch port of
zenith_tpu/ops/ssao.py).

The Alchemy-AO estimator over the G-buffer's world positions and normals:
one nearest-texel gather of the position and depth planes per hemisphere
tap, a per-pixel kernel rotation from an integer coordinate hash, and a
separable depth-gated blur of shifted adds. The lighting resolve multiplies
its ambient term by the blurred factor.

``_pixel_hash_bits`` is the dither source every screen-space march of the
port shares (contact shadows, SSR, volumetric fog). It is uint32 arithmetic
in the reference; torch has no full uint32 arithmetic, so it runs on int64
with each product kept below 2**63 and masked to 32 bits, which gives the
reference's bits exactly.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


def hemisphere_kernel(samples: int, seed: int = 11) -> np.ndarray:
    """(K, 3) tangent-space sample offsets in the +Z hemisphere, scaled to
    cluster toward the origin (ssao.py:34-44)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(samples, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.12  # keep off the tangent plane
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    # Accelerating radius: sample i sits at lerp(0.1, 1, (i/K)^2).
    t = (np.arange(samples) + 0.5) / samples
    scale = 0.1 + 0.9 * t * t
    return (v * scale[:, None]).astype(np.float32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and a constant ``c``
    in [0, 2**32): the constant is split into 16-bit halves so that no
    partial product reaches 2**49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _pixel_hash_bits(h: int, w: int, row0=0, seed=None, *,
                     device: "torch.device | str") -> torch.Tensor:
    """(H, W) int32 integer-coordinate hash, low 16 bits uniform
    (ssao.py:47-60): the shared screen-space dither source. ``row0`` offsets
    to global rows, ``seed`` (an int or an integer tensor on ``device``)
    remixes per frame. Bit for bit the reference's uint32 values. Python
    ints enter as scalars, so the hash copies nothing from the host; the
    device has no default, so that no caller computes on the host by
    omission."""
    ys = (torch.arange(h, dtype=torch.int64, device=device) + row0) & _MASK32
    xs = torch.arange(w, dtype=torch.int64, device=device)
    n = (_mul32(ys, 374761393)[:, None] + _mul32(xs, 668265263)[None, :]) & _MASK32
    if isinstance(seed, torch.Tensor):
        n = (n + _mul32(seed.to(torch.int64) & _MASK32, 2654435761)) & _MASK32
    elif seed is not None:
        n = (n + ((int(seed) & _MASK32) * 2654435761 & _MASK32)) & _MASK32
    n = _mul32(n ^ (n >> 13), 1274126177)
    n = n ^ (n >> 16)
    return (n & 0xFFFF).to(torch.int32)


def _pixel_hash_angle(h: int, w: int, row0=0, *,
                      device: "torch.device | str") -> torch.Tensor:
    """(H, W) per-pixel rotation angle from the coordinate hash
    (ssao.py:63-67)."""
    return _pixel_hash_bits(h, w, row0, device=device).to(torch.float32) * (
        2.0 * np.pi / 65536.0
    )


def ssao_occlusion(
    world_pos: torch.Tensor,  # (H, W, 3) G-buffer world positions
    normal: torch.Tensor,  # (H, W, 3) world normals (unit)
    depth: torch.Tensor,  # (H, W) reverse-Z depth (0 = background)
    view_proj: torch.Tensor,  # (4, 4) camera view-projection
    kernel: np.ndarray,  # (K, 3) hemisphere_kernel output
    radius: float = 4.0,
    bias: float = 0.04,
    intensity: float = 1.0,
    tap_pos: "torch.Tensor | None" = None,
    tap_depth: "torch.Tensor | None" = None,
    row0: "torch.Tensor | int" = 0,
) -> torch.Tensor:
    """Raw (noisy) AO factor in [0, 1], 1 = fully open (ssao.py:70-155).
    Background pixels (depth == 0) stay 1. ``radius``/``bias`` are
    world-space; ``tap_pos``/``tap_depth`` are the planes the taps read
    (default: the centre planes) and ``row0`` their first global row."""
    if tap_pos is None:
        tap_pos = world_pos
    if tap_depth is None:
        tap_depth = depth
    h, w = depth.shape
    full_h = tap_depth.shape[0]
    dev = depth.device
    n = normal
    # Per-pixel tangent frame, rotated by the coordinate hash.
    ang = _pixel_hash_angle(h, w, row0, device=dev)
    # The helper axis: +Z unless the normal is near it, then +X (built
    # channel by channel from scalars: no host constant reaches the card).
    near_z = torch.abs(n[..., 2]) < 0.95
    helper = torch.stack([torch.where(near_z, 0.0, 1.0), torch.zeros_like(n[..., 0]),
                          torch.where(near_z, 1.0, 0.0)], dim=-1)
    t = torch.linalg.cross(helper, n, dim=-1)
    t = t / torch.clamp(torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True)), min=1e-8)
    b = torch.linalg.cross(n, t, dim=-1)
    ca, sa = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    t_r = t * ca + b * sa
    b_r = -t * sa + b * ca

    flat_pos = tap_pos.reshape(-1, 3)
    flat_depth = tap_depth.reshape(-1)
    eps = 0.01 * radius * radius
    occ = torch.zeros((h, w), dtype=torch.float32, device=dev)
    valid = torch.zeros((h, w), dtype=torch.float32, device=dev)
    ones = torch.ones_like(world_pos[..., :1])
    for k in range(kernel.shape[0]):
        kx, ky, kz = (float(v) for v in kernel[k])
        off = (t_r * kx + b_r * ky + n * kz) * radius
        p = world_pos + off
        # Project the hemisphere point to place the tap on screen.
        clip = torch.cat([p, ones], dim=-1) @ view_proj.T
        cw = torch.clamp(clip[..., 3], min=1e-6)
        sx = (clip[..., 0] / cw * 0.5 + 0.5) * w
        sy = (clip[..., 1] / cw * 0.5 + 0.5) * full_h  # global screen row
        ix = torch.clamp(sx.to(torch.int32), 0, w - 1)
        iy = torch.clamp(sy.to(torch.int32), 0, full_h - 1)
        onscreen = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < full_h) & (clip[..., 3] > 0)
        # One nearest-texel gather per tap.
        flat = (iy * w + ix).reshape(-1).long()
        tap = flat_pos[flat].reshape(h, w, 3)
        tdep = flat_depth[flat].reshape(h, w)
        covered = tdep > 0.0
        # Alchemy estimator on the actual surface point under the tap.
        v = tap - world_pos
        vv = torch.sum(v * v, dim=-1)
        vn = torch.sum(v * n, dim=-1)
        contrib = torch.clamp(vn - bias, min=0.0) / (vv + eps)
        # Normalized by the kernel radius so ``intensity`` is dimensionless.
        contrib = contrib * radius
        occ = occ + torch.where(onscreen & covered, contrib, torch.zeros_like(contrib))
        valid = valid + onscreen.to(torch.float32)
    ao = 1.0 - intensity * occ / torch.clamp(valid, min=1.0)
    ao = torch.clamp(ao, 0.0, 1.0)
    return torch.where(depth > 0.0, ao, torch.ones_like(ao))


def ssao_blur(
    ao: torch.Tensor,  # (H, W)
    depth: torch.Tensor,  # (H, W) reverse-Z (edge guide)
    taps: int = 4,
    depth_tol: float = 5e-4,
) -> torch.Tensor:
    """Separable depth-gated blur of shifted adds (ssao.py:158-180): a
    neighbour contributes only where its reverse-Z depth is within
    ``depth_tol`` of the centre's."""

    def pass_axis(x, axis):
        acc = x
        wacc = torch.ones_like(x)
        for d in range(1, taps + 1):
            for s in (-d, d):
                nd = torch.roll(depth, s, dims=axis)
                na = torch.roll(x, s, dims=axis)
                wgt = (torch.abs(nd - depth) < depth_tol).to(torch.float32)
                acc = acc + na * wgt
                wacc = wacc + wgt
        return acc / wacc

    return pass_axis(pass_axis(ao, axis=1), axis=0)


__all__ = ["hemisphere_kernel", "ssao_blur", "ssao_occlusion"]
