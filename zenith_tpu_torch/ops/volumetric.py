"""Volumetric sun scattering: height fog and shadow-marched light shafts
(torch port of zenith_tpu/ops/volumetric.py).

One mechanism for both effects: march K steps from the camera toward each
pixel's surface (or ``max_dist`` for sky pixels), accumulating Beer-Lambert
transmittance through an exponential height-fog density and in-scattering
the sun where the shadow map says the step point is lit. K nearest
shadow-map gathers a pixel, no screen-plane gather; a Henyey-Greenstein
phase toward the sun and an isotropic ambient in-scatter. All tuning rides
one packed (8,) dynamic.
"""

from __future__ import annotations

import numpy as np
import torch

from zenith_tpu_torch.ops.ssao import _pixel_hash_angle


def volumetric_sun(
    hdr: torch.Tensor,  # (H, W, 4) lit scene colour
    world_pos: torch.Tensor,  # (H, W, 3) G-buffer world positions
    depth: torch.Tensor,  # (H, W) reverse-Z depth (0 = background)
    cam_pos: torch.Tensor,  # (3,) camera world position
    view_dirs: torch.Tensor,  # (H, W, 3) per-pixel unit view ray
    sun_dir: torch.Tensor,  # (3,) unit direction toward the sun
    sun_color: torch.Tensor,  # (3,) sun radiance
    params: torch.Tensor,  # (8,) density, height, falloff, g, max_dist, boost, ambient, _
    shadow_map: "torch.Tensor | None" = None,  # (Hs, Ws) reverse-Z light depth
    light_vp: "torch.Tensor | None" = None,  # (4, 4) sun view-projection
    shadow_bias: "torch.Tensor | float" = 0.0,
    steps: int = 16,
    jitter: bool = True,
    row0: "torch.Tensor | int" = 0,
) -> torch.Tensor:
    """One volumetric resolve (volumetric.py:32-125). Returns (H, W, 4);
    alpha passes through. Without a shadow map every step is lit: pure
    analytic height fog, no gather."""
    h, w = depth.shape
    dev = depth.device
    rgb = hdr[..., :3]
    density = params[0]
    h0 = params[1]
    inv_hfall = 1.0 / torch.clamp(params[2], min=1e-3)
    g = torch.clamp(params[3], -0.95, 0.95)
    max_dist = torch.clamp(params[4], min=1e-3)
    sun_boost = params[5]
    ambient = params[6]

    covered = depth > 0.0
    rel = world_pos - cam_pos
    surf_d = torch.sqrt(torch.sum(rel * rel, dim=-1))
    t_end = torch.where(covered, torch.minimum(surf_d, max_dist), max_dist)

    if jitter:
        phase = _pixel_hash_angle(h, w, row0, device=dev) * (0.5 / np.pi)  # [0, 1)
    else:
        phase = torch.full((h, w), 0.5, dtype=torch.float32, device=dev)

    # Henyey-Greenstein toward the sun (4π folded into sun_boost).
    cos_t = torch.sum(view_dirs * sun_dir, dim=-1)
    g2 = g * g
    hg = (1.0 - g2) / torch.clamp(torch.pow(1.0 + g2 - 2.0 * g * cos_t, 1.5), min=1e-4)

    shafts = shadow_map is not None and light_vp is not None
    if shafts:
        hs, ws = shadow_map.shape
        flat_sm = shadow_map.reshape(-1)

    dt = t_end / steps  # (H, W) per-pixel step length
    trans = torch.ones((h, w), dtype=torch.float32, device=dev)
    inscatter = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    ones = torch.ones_like(world_pos[..., :1])
    for k in range(steps):
        t = (k + phase) * dt
        q = cam_pos + view_dirs * t[..., None]
        rho = density * torch.exp(-torch.clamp(q[..., 2] - h0, min=0.0) * inv_hfall)
        if shafts:
            clip = torch.cat([q, ones], dim=-1) @ light_vp.T
            cw = torch.clamp(clip[..., 3], min=1e-6)
            u = clip[..., 0] / cw * 0.5 + 0.5
            v = clip[..., 1] / cw * 0.5 + 0.5
            inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
            ix = torch.clamp((u * ws).to(torch.int32), 0, ws - 1)
            iy = torch.clamp((v * hs).to(torch.int32), 0, hs - 1)
            d = flat_sm[(iy * ws + ix).reshape(-1).long()].reshape(h, w)
            lit = torch.where(inside, clip[..., 2] - shadow_bias >= d,
                              torch.ones_like(inside)).to(torch.float32)
        else:
            lit = 1.0
        a = rho * dt  # optical depth of this segment
        seg_t = torch.exp(-a)
        # Energy-conserving segment in-scatter: (1 − e^{−ρΔt}) of the
        # segment's incident light scatters toward the eye.
        scat = (1.0 - seg_t) * trans
        inscatter = inscatter + scat[..., None] * (
            (lit * hg * sun_boost)[..., None] * sun_color + ambient * sun_color
        )
        trans = trans * seg_t

    out_rgb = rgb * trans[..., None] + inscatter
    return torch.cat([out_rgb, hdr[..., 3:4]], dim=-1)
