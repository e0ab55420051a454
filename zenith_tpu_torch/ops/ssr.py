"""Screen-space reflections over the deferred G-buffer (torch port of
zenith_tpu/ops/ssr.py).

The ray march samples one packed (H·W, 4) world-position + depth plane,
one 4-channel gather a step, and tests hits in world space (radial camera
distances of the ray point and the tapped surface point). Steps are
quadratically spaced and phase-dithered per pixel with the SSAO coordinate
hash; a short bisection refines the hit; the hit colour is one bilinear HDR
fetch, gated by a nearest normal fetch that rejects back-facing hits.
Roughness fades the effect out by ``max_roughness``; misses contribute
nothing. Gathers a pixel: steps + refine + 4 + 1 (21 at the 12/4 defaults).
"""

from __future__ import annotations

import numpy as np
import torch

from zenith_tpu_torch.ops.screentrace import pack_tap_plane, project_to_screen, tap_radial_gap
from zenith_tpu_torch.ops.ssao import _pixel_hash_angle

# World-space hit bias against self-intersection at the ray origin, and the
# screen-edge fade band as a fraction of the viewport.
_HIT_BIAS = 0.05
_EDGE_BAND = 0.08


def ssr_reflect(
    hdr: torch.Tensor,  # (H, W, 4) lit scene colour
    albedo_metal: torch.Tensor,  # (H, W, 4) G-buffer albedo + metallic
    normal_rough: torch.Tensor,  # (H, W, 4) G-buffer normal + roughness
    world_pos: torch.Tensor,  # (H, W, 3) G-buffer world positions
    depth: torch.Tensor,  # (H, W) reverse-Z depth (0 = background)
    cam_pos: torch.Tensor,  # (3,) camera world position
    view_proj: torch.Tensor,  # (4, 4) camera view-projection
    params: torch.Tensor,  # (4,): strength, max_distance, thickness, max_rough
    steps: int = 12,
    refine: int = 4,
    jitter: bool = True,
) -> torch.Tensor:
    """One SSR resolve (ssr.py:50-196): reflect → march → refine → fetch →
    Fresnel-weighted add. Returns (H, W, 4); alpha passes through."""
    h, w = depth.shape
    dev = depth.device
    rgb = hdr[..., :3]
    strength = params[0]
    max_dist = torch.clamp(params[1], min=1e-3)
    thickness = torch.clamp(params[2], min=1e-3)
    max_rough = torch.clamp(params[3], min=1e-3)

    albedo = albedo_metal[..., :3]
    metallic = albedo_metal[..., 3:4]
    n = normal_rough[..., :3]
    roughness = normal_rough[..., 3:4]
    covered = depth > 0.0

    to_cam = cam_pos - world_pos
    v = to_cam / torch.clamp(torch.sqrt(torch.sum(to_cam * to_cam, dim=-1, keepdim=True)),
                             min=1e-8)
    ndv = torch.clamp(torch.sum(n * v, dim=-1, keepdim=True), min=1e-4)
    r = 2.0 * ndv * n - v  # unit: the view vector mirrored about n

    rough_fade = torch.clamp(1.0 - roughness[..., 0] / max_rough, 0.0, 1.0)
    if jitter:
        phase = _pixel_hash_angle(h, w, device=dev) * (0.5 / np.pi)  # [0, 1)
    else:
        phase = torch.full((h, w), 0.5, dtype=torch.float32, device=dev)

    flat_pd = pack_tap_plane(world_pos, depth)
    flat_rgb = rgb.reshape(-1, 3)
    flat_n = n.reshape(-1, 3)

    def march_state(q):
        """Whether the ray point ``q`` is behind visible geometry, and by
        how much (one gather)."""
        sx, sy, inside, idx = project_to_screen(q, view_proj, h, w)
        s_dep, gap = tap_radial_gap(flat_pd, idx, q, cam_pos, (h, w))
        behind = inside & (s_dep > 0.0) & (gap > _HIT_BIAS)
        return behind, gap

    # Coarse march: the first step whose ray point falls behind geometry
    # within ``thickness`` becomes the hit bracket [t_lo, t_hi].
    found = torch.zeros((h, w), dtype=torch.bool, device=dev)
    t_lo = torch.zeros((h, w), dtype=torch.float32, device=dev)
    t_hi = torch.zeros((h, w), dtype=torch.float32, device=dev)
    prev_t = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for i in range(steps):
        s = (i + phase) / steps
        t = max_dist * (s * s)
        behind, gap = march_state(world_pos + r * t[..., None])
        hit = behind & (gap < thickness)
        new = hit & (~found)
        t_lo = torch.where(new, prev_t, t_lo)
        t_hi = torch.where(new, t, t_hi)
        found = found | hit
        prev_t = t

    # Bisection inside the bracket (no thickness test: the bracket already
    # straddles the surface).
    for _ in range(refine):
        tm = 0.5 * (t_lo + t_hi)
        behind, _ = march_state(world_pos + r * tm[..., None])
        t_hi = torch.where(behind, tm, t_hi)
        t_lo = torch.where(behind, t_lo, tm)

    # Final fetch at the refined hit.
    q = world_pos + r * t_hi[..., None]
    sx, sy, inside, idx_near = project_to_screen(q, view_proj, h, w)
    n_hit = flat_n[idx_near].reshape(h, w, 3)
    facing = torch.sum(n_hit * r, dim=-1) < 0.0  # the hit surface faces the ray

    x0 = torch.clamp(torch.floor(sx).to(torch.int32), 0, w - 1)
    y0 = torch.clamp(torch.floor(sy).to(torch.int32), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = torch.clamp(sx - x0.to(torch.float32), 0.0, 1.0)[..., None]
    fy = torch.clamp(sy - y0.to(torch.float32), 0.0, 1.0)[..., None]

    def fetch(iy, ix):
        return flat_rgb[(iy * w + ix).reshape(-1).long()].reshape(h, w, 3)

    c00, c01 = fetch(y0, x0), fetch(y0, x1)
    c10, c11 = fetch(y1, x0), fetch(y1, x1)
    refl = (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy

    # Weights: Schlick Fresnel over the surface's own F0 times the fade
    # chain (hit validity, roughness, screen edge, march distance).
    f0 = 0.04 * (1.0 - metallic) + albedo * metallic
    x = 1.0 - ndv
    x2 = x * x
    fresnel = f0 + (1.0 - f0) * (x * (x2 * x2))

    u = (sx + 0.5) / w
    vv = (sy + 0.5) / h
    edge = (torch.clamp(torch.minimum(u, 1.0 - u) / _EDGE_BAND, 0.0, 1.0)
            * torch.clamp(torch.minimum(vv, 1.0 - vv) / _EDGE_BAND, 0.0, 1.0))
    dist_fade = torch.clamp(1.0 - t_hi / max_dist, 0.0, 1.0)
    weight = ((found & inside & facing & covered).to(torch.float32)
              * rough_fade * edge * dist_fade * strength)[..., None]

    out_rgb = rgb + refl * fresnel * weight
    return torch.cat([out_rgb, hdr[..., 3:4]], dim=-1)
