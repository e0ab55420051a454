"""Shared screen-space ray-march primitives of SSR and contact shadows
(torch port of zenith_tpu/ops/screentrace.py).

Both marches step a world-space ray, project each step point through the
camera view-projection, and compare camera-radial distances against one
packed (H·W, 4) world-position + depth tap plane: one 4-channel gather per
step. The projection convention (the pixel-centre −0.5 offset, the
``cw > 1e-4`` behind-camera guard) and the radial-gap compare live here
once, for ops/ssr.py and ops/contact.py.
"""

from __future__ import annotations

import torch


def pack_tap_plane(pos: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(Hf, Wf, 3) world positions ++ (Hf, Wf) depth → (Hf·Wf, 4)."""
    return torch.cat([pos, depth[..., None]], dim=-1).reshape(-1, 4)


def project_to_screen(q: torch.Tensor, view_proj: torch.Tensor, h: int, w: int):
    """World points (..., 3) → pixel-centre float coords, validity, and the
    nearest flat tap index into an (h, w) surface (screentrace.py:26-48).

    Returns ``(sx, sy, inside, idx)``: ``inside`` is False behind the camera
    (clip w ≤ 1e-4) or outside the viewport; ``idx`` (int64) is clamped so
    that gathers stay in range for invalid lanes too (the caller masks them
    with ``inside``)."""
    clip = torch.cat([q, torch.ones_like(q[..., :1])], dim=-1) @ view_proj.T
    cw = clip[..., 3]
    ok = cw > 1e-4
    cwc = torch.clamp(cw, min=1e-4)
    sx = (clip[..., 0] / cwc * 0.5 + 0.5) * w - 0.5
    sy = (clip[..., 1] / cwc * 0.5 + 0.5) * h - 0.5
    inside = ok & (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    ix = torch.clamp(torch.floor(sx + 0.5).to(torch.int32), 0, w - 1)
    iy = torch.clamp(torch.floor(sy + 0.5).to(torch.int32), 0, h - 1)
    return sx, sy, inside, (iy * w + ix).reshape(-1).long()


def tap_radial_gap(flat_pd: torch.Tensor, idx: torch.Tensor, q: torch.Tensor,
                   cam_pos: torch.Tensor, shape: "tuple[int, int]"):
    """Nearest tap of the packed plane (screentrace.py:51-61): returns
    ``(s_dep, gap)`` where ``gap`` is how far, camera-radially in world
    units, the ray point ``q`` sits behind the tapped visible surface
    (positive = occluded side)."""
    h, w = shape
    tap = flat_pd[idx].reshape(h, w, 4)
    s_pos, s_dep = tap[..., :3], tap[..., 3]
    dq = q - cam_pos
    ds = s_pos - cam_pos
    return s_dep, torch.sqrt(torch.sum(dq * dq, dim=-1)) - torch.sqrt(torch.sum(ds * ds, dim=-1))
