"""Varying resolution (torch port of zenith_tpu/ops/shade.py).

``finalize_attrs``: the raster pass leaves attr·(1/w) planes plus the
interpolated 1/w plane; dividing by the latter gives perspective-correct
varyings per pixel, with no gathers. ``resolve_varyings`` is the capped-bin
path's other route: from a visibility buffer of record slots it gathers each
pixel's record and vertices and interpolates them there. ``dfdx`` / ``dfdy``
are the screen-space derivatives of dense fragment planes and
``perturb_normal`` applies a tangent-space normal map without vertex
tangents (the textured G-buffer's normal map).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from zenith_tpu_torch.ops import geometry as g
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


def resolve_varyings(
    slot_img: torch.Tensor,  # (H, W) i32 — record index, -1 = background
    rast16: torch.Tensor,  # (R, 16)
    shade16: torch.Tensor,  # (R, 16)
    tri_id: torch.Tensor,  # (R,) i32
    indices: torch.Tensor,  # (T, 3)
    varyings: "Dict[str, torch.Tensor]",  # name → (Nv, C) vertex-stage outputs
) -> "Tuple[Dict[str, torch.Tensor], torch.Tensor, FragmentBuiltins]":
    """Interpolate vertex-stage outputs at every covered pixel of a slot
    image (shade.py:59-141): the record's screen barycentrics at the pixel
    centre, weighted by its corners' 1/w and renormalised, then composed
    with the corners' original-triangle barycentrics, so near clipping is
    invisible. Returns ({name: (H, W, C)}, coverage (H, W) bool, builtins).
    Per-pixel gathers of records and vertices."""
    h, w = slot_img.shape
    dev = slot_img.device
    mask = slot_img >= 0
    s = torch.clamp(slot_img, min=0).reshape(-1).to(torch.int64)
    rec = rast16[s].reshape(h, w, 16)
    sh = shade16[s].reshape(h, w, 16)

    x = (torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5).expand(h, w)
    y = (torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5).expand(h, w)
    e01 = rec[..., g.RAST_A01] * x + rec[..., g.RAST_B01] * y + rec[..., g.RAST_C01]
    e12 = rec[..., g.RAST_A12] * x + rec[..., g.RAST_B12] * y + rec[..., g.RAST_C12]
    e20 = rec[..., g.RAST_A20] * x + rec[..., g.RAST_B20] * y + rec[..., g.RAST_C20]
    inv_det = rec[..., g.RAST_INV_DET]
    # Screen-space sub-triangle barycentrics (w_k = weight of corner k).
    w0 = e12 * inv_det
    w1 = e20 * inv_det
    w2 = e01 * inv_det
    z = w0 * rec[..., g.RAST_Z0] + w1 * rec[..., g.RAST_Z1] + w2 * rec[..., g.RAST_Z2]

    # Perspective correction: weight the corners by 1/w and renormalise.
    pw0 = w0 * sh[..., g.SHADE_IW0]
    pw1 = w1 * sh[..., g.SHADE_IW1]
    pw2 = w2 * sh[..., g.SHADE_IW2]
    denom = pw0 + pw1 + pw2
    denom = torch.where(torch.abs(denom) > 1e-20, denom, torch.ones_like(denom))
    pw0, pw1, pw2 = pw0 / denom, pw1 / denom, pw2 / denom
    # Compose with the corners' original-triangle barycentrics.
    a = pw0 * sh[..., g.SHADE_B0X] + pw1 * sh[..., g.SHADE_B1X] + pw2 * sh[..., g.SHADE_B2X]
    b = pw0 * sh[..., g.SHADE_B0Y] + pw1 * sh[..., g.SHADE_B1Y] + pw2 * sh[..., g.SHADE_B2Y]
    c = 1.0 - a - b

    tri = indices.to(torch.int64)[tri_id.to(torch.int64)[s]]  # (H·W, 3)
    out: Dict[str, torch.Tensor] = {}
    for name, v in varyings.items():
        v = v.to(torch.float32)
        v0, v1, v2 = (v[tri[:, i]].reshape(h, w, -1) for i in range(3))
        out[name] = a[..., None] * v0 + b[..., None] * v1 + c[..., None] * v2

    builtins = FragmentBuiltins(
        frag_coord=torch.stack([x, y], dim=-1),
        depth=z,
        front_facing=sh[..., g.SHADE_FRONT] > 0.5,
        resolution=(w, h),
    )
    return out, mask, builtins


# ---------------------------------------------------------------------------
# Screen-space derivatives + derivative-based tangent frames (shade.py:144-199)
# ---------------------------------------------------------------------------


def dfdx(img: torch.Tensor) -> torch.Tensor:
    """Screen-space x derivative of a dense (H, W, ...) fragment plane — the
    dFdx/ddx analog (forward difference, last column repeated)."""
    d = img[:, 1:] - img[:, :-1]
    return torch.cat([d, d[:, -1:]], dim=1)


def dfdy(img: torch.Tensor) -> torch.Tensor:
    """Screen-space y derivative (dFdy analog)."""
    d = img[1:] - img[:-1]
    return torch.cat([d, d[-1:]], dim=0)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def perturb_normal(
    n: torch.Tensor,  # (H, W, 3) geometric world normal (normalized)
    world_pos: torch.Tensor,  # (H, W, 3)
    uv: torch.Tensor,  # (H, W, 2)
    normal_sample: torch.Tensor,  # (H, W, 3) tangent-space map in [0, 1]
) -> torch.Tensor:
    """Apply a tangent-space normal map WITHOUT vertex tangents
    (shade.py:163-199): the cotangent frame is rebuilt per pixel from
    screen-space derivatives of world position and UV (Schüler, "Normal
    Mapping Without Precomputed Tangents"), Gram-Schmidt against the
    interpolated normal. Where the frame degenerates (the uv determinant or
    a frame vector vanishes, as at silhouettes) the geometric normal is
    kept."""
    dp1 = dfdx(world_pos)
    dp2 = dfdy(world_pos)
    du1 = dfdx(uv)
    du2 = dfdy(uv)
    det = du1[..., 0:1] * du2[..., 1:2] - du2[..., 0:1] * du1[..., 1:2]
    ok = torch.abs(det) > 1e-12
    r = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                    torch.zeros_like(det))
    t = (dp1 * du2[..., 1:2] - dp2 * du1[..., 1:2]) * r
    b = (dp2 * du1[..., 0:1] - dp1 * du2[..., 0:1]) * r
    # Gram-Schmidt against the interpolated normal.
    t = t - n * torch.sum(n * t, dim=-1, keepdim=True)
    t_len = _norm(t)
    t = t / torch.clamp(t_len, min=1e-8)
    b = b - n * torch.sum(n * b, dim=-1, keepdim=True)
    b = b - t * torch.sum(t * b, dim=-1, keepdim=True)
    b_len = _norm(b)
    b = b / torch.clamp(b_len, min=1e-8)
    nm = normal_sample * 2.0 - 1.0
    out = t * nm[..., 0:1] + b * nm[..., 1:2] + n * nm[..., 2:3]
    out = out / torch.clamp(_norm(out), min=1e-8)
    # Degenerate frames (t or b vanished) fall back to the geometric normal.
    good = (t_len > 1e-6) & (b_len > 1e-6)
    return torch.where(good, out, n)
