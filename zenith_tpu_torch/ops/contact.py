"""Screen-space contact shadows for the sun (torch port of
zenith_tpu/ops/contact.py).

A short march from each shaded pixel toward the sun over the G-buffer's
world positions closes the light leak that the shadow map's resolution and
bias open where geometry meets the ground. The same design as the SSR
march: one packed world-position + depth tap plane (one 4-channel gather a
step), a per-pixel phase from the SSAO coordinate hash, linear steps.
"""

from __future__ import annotations

import numpy as np
import torch

from zenith_tpu_torch.ops.screentrace import pack_tap_plane, project_to_screen, tap_radial_gap
from zenith_tpu_torch.ops.ssao import _pixel_hash_angle

# Self-intersection guard (world units, camera-radial): the marched point
# must be this far behind the tapped surface before it counts as occluded.
_HIT_BIAS = 0.08


def contact_shadow_factor(
    world_pos: torch.Tensor,  # (H, W, 3) G-buffer positions
    depth: torch.Tensor,  # (H, W) reverse-Z depth (0 = bg)
    tap_pos: torch.Tensor,  # (Hf, Wf, 3) the positions the taps read
    tap_depth: torch.Tensor,  # (Hf, Wf) the depth the taps read
    sun_dir: torch.Tensor,  # (3,) unit, toward the sun
    cam_pos: torch.Tensor,  # (3,) camera world position
    view_proj: torch.Tensor,  # (4, 4)
    strength: float = 1.0,
    max_dist: float = 2.0,
    thickness: float = 0.6,
    steps: int = 8,
    row0=0,
) -> torch.Tensor:
    """(H, W) visibility in [1-strength, 1]: 1 = lit, lower = contact-
    occluded (contact.py:33-81)."""
    h, w = depth.shape
    hf, wf = tap_depth.shape
    covered = depth > 0.0
    phase = _pixel_hash_angle(h, w, row0, device=depth.device) * (0.5 / np.pi)  # [0, 1)
    flat_pd = pack_tap_plane(tap_pos, tap_depth)

    occluded = torch.zeros((h, w), dtype=torch.bool, device=depth.device)
    for i in range(steps):
        # (i + phase)/steps spans [0, max_dist) exactly: the phase is the
        # in-step offset.
        t = max_dist * (i + phase) / steps
        q = world_pos + sun_dir * t[..., None]
        _, _, inside, idx = project_to_screen(q, view_proj, hf, wf)
        s_dep, gap = tap_radial_gap(flat_pd, idx, q, cam_pos, (h, w))
        occluded = occluded | (inside & (s_dep > 0.0) & (gap > _HIT_BIAS) & (gap < thickness))

    vis = torch.full_like(phase, 1.0 - strength)
    return torch.where(occluded & covered, vis, torch.ones_like(vis))
