"""Varying finalize (torch port of zenith_tpu/ops/shade.py::finalize_attrs).

The raster pass leaves attr·(1/w) planes plus the interpolated 1/w plane;
dividing by the latter gives perspective-correct varyings per pixel, with
no gathers.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from zenith_tpu_torch.rhi.shader import FragmentBuiltins


def finalize_attrs(
    z: torch.Tensor,  # (H, W) resolved depth
    acc: torch.Tensor,  # (A+1, H, W) from raster_segmented
    attr_layout: "list[tuple[str, int]]",  # (name, channels) in packing order
) -> "Tuple[Dict[str, torch.Tensor], torch.Tensor, FragmentBuiltins]":
    """Divide the attr·(1/w) planes by the 1/w plane (shade.py:26-58)."""
    h, w = z.shape
    iw = acc[-1]
    mask = iw > 0.0
    one = torch.ones_like(iw)
    inv = torch.where(mask, 1.0 / torch.where(mask, iw, one), torch.zeros_like(iw))

    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, channels in attr_layout:
        planes = acc[offset: offset + channels] * inv[None]
        out[name] = torch.movedim(planes, 0, -1)  # (H, W, C)
        offset += channels

    x = (torch.arange(w, dtype=torch.float32, device=z.device)[None, :] + 0.5).expand(h, w)
    y = (torch.arange(h, dtype=torch.float32, device=z.device)[:, None] + 0.5).expand(h, w)
    front = out.pop("__front", None)
    builtins = FragmentBuiltins(
        frag_coord=torch.stack([x, y], dim=-1),
        depth=z,
        front_facing=(front[..., 0] > 0.5) if front is not None else mask,
        resolution=(w, h),
    )
    return out, mask, builtins
