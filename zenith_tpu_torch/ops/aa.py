"""Post-process anti-aliasing, FXAA-class and gather-free (torch port of
zenith_tpu/ops/aa.py).

The edge direction is quantized to the four axes a shift reaches
(horizontal, vertical, two diagonals), so every tap is a ``torch.roll``.
Rolls wrap around the image borders, as the reference's ``jnp.roll`` does.
Per pixel:

1. a luma contrast gate (absolute + relative threshold, as FXAA),
2. the gradient from the 4-neighbourhood → an edge-direction bin,
3. a blend toward the two neighbours along the edge (neutral on straight
   edges, whose along-edge neighbours equal the centre),
4. FXAA's subpixel term: a lowpass blend toward the 4-neighbourhood mean,
   weighted by |lumaAvg − lumaCentre|² / range².
"""

from __future__ import annotations

import torch

_LUMA = (0.299, 0.587, 0.114)  # FXAA's perceptual luma weights


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    out = img
    if dy:
        out = torch.roll(out, dy, dims=0)
    if dx:
        out = torch.roll(out, dx, dims=1)
    return out


def post_aa(
    rgb: torch.Tensor,  # (H, W, C>=3) tonemapped LDR, linear values in [0,1]
    threshold: float = 0.0625,
    rel_threshold: float = 0.125,
    strength: float = 1.0,
) -> torch.Tensor:
    """Anti-alias the LDR image; returns the same shape (alpha untouched)."""
    c = rgb[..., :3]
    lum = c[..., 0] * _LUMA[0] + c[..., 1] * _LUMA[1] + c[..., 2] * _LUMA[2]

    l_up, l_dn = _shift(lum, 1, 0), _shift(lum, -1, 0)
    l_lf, l_rt = _shift(lum, 0, 1), _shift(lum, 0, -1)
    lmin = torch.minimum(torch.minimum(torch.minimum(l_up, l_dn),
                                       torch.minimum(l_lf, l_rt)), lum)
    lmax = torch.maximum(torch.maximum(torch.maximum(l_up, l_dn),
                                       torch.maximum(l_lf, l_rt)), lum)
    rng = lmax - lmin
    active = rng >= torch.clamp(rel_threshold * lmax, min=threshold)

    # Gradient of luma; the edge runs perpendicular to it.
    gx = l_rt - l_lf
    gy = l_dn - l_up
    ax, ay = torch.abs(gx), torch.abs(gy)
    horiz_edge = ay >= 2.0 * ax
    vert_edge = ax >= 2.0 * ay
    diag_main = gx * gy > 0  # gradient along +x+y → edge along +x-y

    c_up, c_dn = _shift(c, 1, 0), _shift(c, -1, 0)
    c_lf, c_rt = _shift(c, 0, 1), _shift(c, 0, -1)
    c_ul, c_dr = _shift(c, 1, 1), _shift(c, -1, -1)
    c_ur, c_dl = _shift(c, 1, -1), _shift(c, -1, 1)

    along_h = 0.5 * (c_lf + c_rt)
    along_v = 0.5 * (c_up + c_dn)
    # Edge along +x-y ⇒ the neighbours are up-right and down-left.
    along_d1 = 0.5 * (c_ur + c_dl)
    along_d2 = 0.5 * (c_ul + c_dr)
    along = torch.where(
        horiz_edge[..., None], along_h,
        torch.where(vert_edge[..., None], along_v,
                    torch.where(diag_main[..., None], along_d1, along_d2)),
    )

    # Directional term: a fixed modest pull toward the along-edge mean.
    d = 0.25 * strength
    directional = c * (1.0 - d) + along * d

    # Subpixel term: the centre's departure from its 4-neighbourhood mean
    # relative to the local range, squared (FXAA's subpixel quality curve).
    l_avg = 0.25 * (l_up + l_dn + l_lf + l_rt)
    lowpass = 0.25 * (c_up + c_dn + c_lf + c_rt)
    subpix = torch.clamp(torch.abs(l_avg - lum) / torch.clamp(rng, min=1e-6), 0.0, 1.0)
    s = (strength * 0.75 * subpix * subpix)[..., None]

    smoothed = directional * (1.0 - s) + lowpass * s
    out = torch.where(active[..., None], smoothed, c)
    if rgb.shape[-1] > 3:
        return torch.cat([out, rgb[..., 3:]], dim=-1)
    return out
