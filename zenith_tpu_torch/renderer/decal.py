"""Deferred decals: projected surface details applied to the G-buffer
between the geometry and lighting passes (torch port of
zenith_tpu/renderer/decal.py).

The G-buffer already holds dense world positions, so a decal is elementwise
math over planes: one 3×4 transform into the decal's unit box, a clip, a
fade against steep surfaces and a blend into the albedo, in a lambda node
("decals") before the lighting resolve, so decals receive the full PBR
lighting and shadows. The transforms ride a per-frame (D, 3, 4) dynamic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class Decal:
    """One projected decal box (decal.py:37-87). ``forward`` is the
    projection direction (into the receiving surface), ``up`` picks the V
    axis of the decal image; ``size`` = (width, height, depth) full extents
    in world units. ``texture`` is an RGBA Texture whose alpha masks the
    blend; without one the decal is a solid ``color`` with a soft
    rounded-box falloff. ``normal_fade`` is the cos-angle threshold below
    which surfaces facing away from the projection stop receiving the decal
    (0 disables)."""

    name: str
    position: "tuple" = (0.0, 0.0, 0.0)
    size: "tuple" = (4.0, 4.0, 2.0)
    forward: "tuple" = (0.0, 0.0, -1.0)
    up: "tuple" = (0.0, 1.0, 0.0)
    texture: "Optional[object]" = None  # rhi Texture (RGBA)
    color: "tuple" = (1.0, 1.0, 1.0, 1.0)
    normal_fade: float = 0.35

    def world_to_decal(self) -> np.ndarray:
        """(3, 4) matrix mapping world points into normalized decal-local
        coords: the unit box [-0.5, 0.5]^3 covers the decal volume."""
        f = np.asarray(self.forward, np.float64)
        f = f / max(np.linalg.norm(f), 1e-12)
        u = np.asarray(self.up, np.float64)
        u = u - f * float(u @ f)
        n = np.linalg.norm(u)
        if n < 1e-6:  # up ∥ forward: pick any perpendicular
            u = np.array([1.0, 0.0, 0.0]) if abs(f[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
            u = u - f * float(u @ f)
            n = np.linalg.norm(u)
        u = u / n
        # U (image right) = forward × up: the default down-projection with
        # up=+y reads U=+x, V=+y.
        r = np.cross(f, u)
        rot = np.stack([r, u, f])  # rows = decal axes
        scale = 1.0 / np.maximum(np.asarray(self.size, np.float64), 1e-12)
        m = rot * scale[:, None]
        t = -m @ np.asarray(self.position, np.float64)
        return np.concatenate([m, t[:, None]], axis=1).astype(np.float32)


def stacked_decal_mats(decals: "list[Decal]") -> np.ndarray:
    """(D, 3, 4) world→decal transforms: the per-frame dynamic."""
    return np.stack([d.world_to_decal() for d in decals])


def stacked_decal_colors(decals: "list[Decal]") -> np.ndarray:
    """(D, 4) tint colours: a per-frame dynamic (alpha = opacity)."""
    return np.stack([np.asarray(d.color, np.float32) for d in decals])


def apply_decal(albedo_rgb, world_pos, normal, mat, color, tex, normal_fade: float):
    """Blend one decal into the albedo plane (decal.py:100-139): dense
    (H, W, C) planes, ``mat`` (3, 4), ``color`` (4,), ``tex`` an (H, W, 4)
    texture array or mip tuple, or None."""
    hom = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])], dim=-1)
    local = hom @ mat.T  # (H, W, 3), in the unit box when inside
    inside = torch.all(torch.abs(local) <= 0.5, dim=-1)

    if tex is not None:
        from zenith_tpu_torch.ops.sampling import sample_texture
        from zenith_tpu_torch.rhi.sampler import SamplerConfig

        uv = torch.stack([local[..., 0] + 0.5, 0.5 - local[..., 1]], dim=-1)
        # Clamped: outside pixels still flow through the sampler (dense
        # plane), their contribution is masked by ``inside``.
        uv = torch.clamp(uv, 0.0, 1.0)
        texel = sample_texture(tex, uv, SamplerConfig.linear())
        rgb = texel[..., :3] * color[:3]
        a = texel[..., 3] * color[3]
    else:
        # Procedural solid decal: soft rounded-box falloff.
        edge = 1.0 - torch.amax(torch.abs(local[..., :2]) * 2.0, dim=-1)
        rgb = color[:3].expand(albedo_rgb.shape)
        a = torch.clamp(edge * 4.0, 0.0, 1.0) * color[3]

    if normal_fade > 0.0:
        # mat row 2 = the forward axis scaled by 1/depth; renormalized it is
        # the projection direction.
        row = mat[2, :3]
        fwd = row / torch.clamp(torch.sqrt(torch.sum(row * row)), min=1e-12)
        align = torch.sum(normal * (-fwd), dim=-1)
        a = a * torch.clamp(align / normal_fade, 0.0, 1.0)

    a = torch.where(inside, a, torch.zeros_like(a))[..., None]
    return albedo_rgb * (1.0 - a) + rgb * a
