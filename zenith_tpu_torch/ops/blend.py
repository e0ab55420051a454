"""Output-merger stage: blending + write masks + clears (torch port of
zenith_tpu/ops/blend.py).

Interprets ColorAttachmentDesc (reference pipeline.rs:337-412) on dense
(H, W, 4) linear float images.
"""

from __future__ import annotations

import numpy as np
import torch

from zenith_tpu_torch.rhi.state import BlendFactor, BlendOp, ColorAttachmentDesc


def clear_color(height: int, width: int, value, device: torch.device) -> torch.Tensor:
    # One fill per channel: no host→device copy, so no sync inside a frame.
    out = torch.empty((height, width, 4), dtype=torch.float32, device=device)
    for k, v in enumerate(np.broadcast_to(np.asarray(value, np.float32), (4,))):
        out[..., k].fill_(float(v))
    return out


def clear_depth(height: int, width: int, value: float, device: torch.device) -> torch.Tensor:
    return torch.full((height, width), value, dtype=torch.float32, device=device)


def _factor(f: BlendFactor, src: torch.Tensor, dst: torch.Tensor, constants) -> torch.Tensor:
    """Blend factor as a broadcastable (H, W, 4) tensor."""
    ones = torch.ones_like(src)
    sa = src[..., 3:4].expand(src.shape)
    da = dst[..., 3:4].expand(dst.shape)
    return {
        BlendFactor.ZERO: lambda: torch.zeros_like(src),
        BlendFactor.ONE: lambda: ones,
        BlendFactor.SRC_COLOR: lambda: src,
        BlendFactor.ONE_MINUS_SRC_COLOR: lambda: ones - src,
        BlendFactor.DST_COLOR: lambda: dst,
        BlendFactor.ONE_MINUS_DST_COLOR: lambda: ones - dst,
        BlendFactor.SRC_ALPHA: lambda: sa,
        BlendFactor.ONE_MINUS_SRC_ALPHA: lambda: ones - sa,
        BlendFactor.DST_ALPHA: lambda: da,
        BlendFactor.ONE_MINUS_DST_ALPHA: lambda: ones - da,
    }[f]()


def _blend_op(op: BlendOp, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return {
        BlendOp.ADD: lambda: a + b,
        BlendOp.SUBTRACT: lambda: a - b,
        BlendOp.REVERSE_SUBTRACT: lambda: b - a,
        BlendOp.MIN: lambda: torch.minimum(a, b),
        BlendOp.MAX: lambda: torch.maximum(a, b),
    }[op]()


def blend_colors(
    dst: torch.Tensor,  # (..., 4)
    src: torch.Tensor,  # (..., 4)
    desc: ColorAttachmentDesc,
    blend_constants=(0.0, 0.0, 0.0, 0.0),
) -> torch.Tensor:
    """The blend equation + static write mask, without coverage masking."""
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    if desc.blend_enable:
        scf = _factor(desc.src_color_blend, src, dst, blend_constants)
        dcf = _factor(desc.dst_color_blend, src, dst, blend_constants)
        saf = _factor(desc.src_alpha_blend, src, dst, blend_constants)
        daf = _factor(desc.dst_alpha_blend, src, dst, blend_constants)
        rgb = _blend_op(
            desc.color_blend_op,
            src[..., :3] * scf[..., :3],
            dst[..., :3] * dcf[..., :3],
        )
        alpha = _blend_op(
            desc.alpha_blend_op,
            src[..., 3:4] * saf[..., 3:4],
            dst[..., 3:4] * daf[..., 3:4],
        )
        out = torch.cat([rgb, alpha], dim=-1)
    else:
        out = src

    if not all(desc.write_mask):
        out = torch.cat(
            [
                out[..., k:k + 1] if desc.write_mask[k] else dst[..., k:k + 1]
                for k in range(4)
            ],
            dim=-1,
        )
    return out


def apply_color_output(
    dst: torch.Tensor,  # (H, W, 4) current attachment contents
    src: torch.Tensor,  # (H, W, 4) fragment shader output (linear)
    mask: torch.Tensor,  # (H, W) bool coverage
    desc: ColorAttachmentDesc,
    blend_constants=(0.0, 0.0, 0.0, 0.0),
) -> torch.Tensor:
    """Blend + write-mask covered pixels of src over dst (Vulkan output
    merger semantics, in linear space)."""
    out = blend_colors(dst, src, desc, blend_constants)
    return torch.where(mask[..., None], out, dst.to(torch.float32))
