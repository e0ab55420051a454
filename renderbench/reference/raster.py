"""Plain fixed-function rasterizer in PyTorch: the reference's raster.

The conventions are those of the repository's NumPy oracle
(``tests/np_reference.py``): Vulkan viewport transform, y-down framebuffer, pixel
centres at +0.5, the top-left fill rule, submission-order depth updates,
perspective-correct interpolation, depth range [0, 1]. The structure is the
brute-force one of that oracle, vectorised: every triangle's pixel bounding
box is expanded into (triangle, pixel) pairs in float64, with no binning
and no tiling. Unlike the NumPy oracle it clips against the plane
``w - z > 1e-5`` (the near plane of a reverse-Z projection), because the
benchmark's scenes have geometry behind the camera.

Nothing here imports the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

W_EPS = 1e-5
# (triangle, pixel) pairs expanded at once.
PAIR_CHUNK = 1 << 23


@dataclass
class Pass:
    """One depth pass over a framebuffer: the depth plane, the winning
    draw's index and the interpolated varyings of the winners."""

    z: torch.Tensor  # (H, W) float64
    draw: torch.Tensor  # (H, W) int64, -1 where no fragment won
    varyings: Optional[torch.Tensor]  # (H, W, C) float64, 0 where none won


def new_pass(width: int, height: int, clear_z: float, channels: int,
             device) -> Pass:
    f64 = torch.float64
    return Pass(
        z=torch.full((height, width), clear_z, dtype=f64, device=device),
        draw=torch.full((height, width), -1, dtype=torch.int64, device=device),
        varyings=(torch.zeros((height, width, channels), dtype=f64, device=device)
                  if channels else None),
    )


def _clip(corners: torch.Tensor, attrs: Optional[torch.Tensor]):
    """Sutherland-Hodgman against ``w - z > W_EPS`` → (tri corners
    (R, 3, 4), attrs (R, 3, C) | None, source index (R,)). A triangle with
    one corner behind the plane becomes two."""
    t = corners.shape[0]
    d = corners[..., 3] - corners[..., 2]
    inside = d > W_EPS
    n_in = inside.sum(dim=1)
    payload = corners if attrs is None else torch.cat([corners, attrs], dim=-1)
    src = torch.arange(t, device=corners.device)

    keep = n_in == 3
    out_p = [payload[keep]]
    out_s = [src[keep]]

    def isect(p_in, p_out, d_in, d_out):
        tt = ((d_in - W_EPS) / (d_in - d_out))[:, None]
        return p_in + (p_out - p_in) * tt

    # Rotate each clipped triangle so that the lone corner (inside for one,
    # outside for two) comes first; the winding is kept.
    for count in (1, 2):
        sel = n_in == count
        if not bool(sel.any()):
            continue
        p, dd, ins = payload[sel], d[sel], inside[sel]
        lone = ins if count == 1 else ~ins
        first = torch.argmax(lone.to(torch.int8), dim=1)
        idx = (first[:, None] + torch.arange(3, device=p.device)[None, :]) % 3
        p = torch.take_along_dim(p, idx[:, :, None], dim=1)
        dd = torch.take_along_dim(dd, idx, dim=1)
        s = src[sel]
        if count == 1:
            a = p[:, 0]
            b = isect(p[:, 0], p[:, 1], dd[:, 0], dd[:, 1])
            c = isect(p[:, 0], p[:, 2], dd[:, 0], dd[:, 2])
            out_p.append(torch.stack([a, b, c], 1))
            out_s.append(s)
        else:
            # Corner 0 is outside, 1 and 2 inside: a quad 1, 2, c20, c01.
            c01 = isect(p[:, 1], p[:, 0], dd[:, 1], dd[:, 0])
            c20 = isect(p[:, 2], p[:, 0], dd[:, 2], dd[:, 0])
            out_p.append(torch.stack([c01, p[:, 1], p[:, 2]], 1))
            out_p.append(torch.stack([c01, p[:, 2], c20], 1))
            out_s.extend([s, s])
    p = torch.cat(out_p)
    s = torch.cat(out_s)
    # Keep submission order: the clipped parts of a triangle stay where the
    # triangle was.
    order = torch.argsort(s, stable=True)
    p, s = p[order], s[order]
    return p[..., :4], (p[..., 4:] if attrs is not None else None), s


def draw(target: Pass, clip: torch.Tensor, tris: torch.Tensor, draw_ids: torch.Tensor,
         varyings: Optional[torch.Tensor], *, compare: str, cull: str) -> None:
    """Rasterize ``tris`` (T, 3) over the clip-space corners ``clip`` (N, 4)
    into ``target`` in submission order. ``draw_ids`` (T,) is written where a
    triangle wins; ``varyings`` (N, C) are interpolated perspective-correct.
    ``compare`` is "less" or "greater" (strict: an earlier fragment of equal
    depth wins); ``cull`` is "none" or "back" (counter-clockwise fronts in
    the y-down framebuffer)."""
    dev = target.z.device
    f64 = torch.float64
    h, w = target.z.shape
    clip = clip.to(f64)
    tris = tris.to(torch.int64)
    corners = clip[tris.reshape(-1)].reshape(-1, 3, 4)
    attrs = None
    if varyings is not None:
        attrs = varyings.to(f64)[tris.reshape(-1)].reshape(-1, 3, varyings.shape[1])
    corners, attrs, src = _clip(corners, attrs)
    did = draw_ids.to(dev)[src]

    iw = 1.0 / corners[..., 3]
    sx = (corners[..., 0] * iw + 1.0) * 0.5 * w
    sy = (corners[..., 1] * iw + 1.0) * 0.5 * h
    sz = corners[..., 2] * iw
    det = (sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0]) \
        - (sx[:, 2] - sx[:, 0]) * (sy[:, 1] - sy[:, 0])
    is_cw = det > 0
    ok = det != 0
    if cull == "back":
        ok = ok & ~is_cw
    # Pixel-centre bounding boxes, clamped to the framebuffer.
    x0 = torch.clamp(torch.ceil(sx.min(1).values - 0.5), 0, w).to(torch.int64)
    x1 = torch.clamp(torch.floor(sx.max(1).values - 0.5), -1, w - 1).to(torch.int64)
    y0 = torch.clamp(torch.ceil(sy.min(1).values - 0.5), 0, h).to(torch.int64)
    y1 = torch.clamp(torch.floor(sy.max(1).values - 0.5), -1, h - 1).to(torch.int64)
    bw = torch.clamp(x1 - x0 + 1, min=0)
    bh = torch.clamp(y1 - y0 + 1, min=0)
    area = torch.where(ok, bw * bh, torch.zeros_like(bw))
    live = torch.nonzero(area > 0)[:, 0]
    if live.numel() == 0:
        return

    s = torch.where(is_cw, 1.0, -1.0).to(f64)
    edges = []
    for a, b in ((0, 1), (1, 2), (2, 0)):
        ea = (sy[:, a] - sy[:, b]) * s
        eb = (sx[:, b] - sx[:, a]) * s
        ec = -(ea * sx[:, a] + eb * sy[:, a])
        dx = (sx[:, b] - sx[:, a]) * s
        dy = (sy[:, b] - sy[:, a]) * s
        tl = (dy < 0) | ((dy == 0) & (dx > 0))
        edges.append((ea, eb, ec, tl))
    inv_det = 1.0 / torch.abs(det)

    # Fragments that beat the target's depth, gathered chunk by chunk:
    # (pixel, z, submission index, barycentrics).
    keep_pix, keep_z, keep_i, keep_b = [], [], [], []
    cum = torch.cumsum(area[live], 0)
    start = 0
    while start < live.numel():
        base = int(cum[start - 1]) if start > 0 else 0
        stop = int(torch.searchsorted(cum, torch.tensor(base + PAIR_CHUNK, device=dev),
                                      right=True))
        stop = max(stop, start + 1)
        idx = live[start:stop]
        cnt = area[idx]
        rep = torch.repeat_interleave(idx, cnt)
        first = torch.cumsum(cnt, 0) - cnt
        k = torch.arange(rep.numel(), device=dev) - torch.repeat_interleave(first, cnt)
        px = x0[rep] + k % bw[rep]
        py = y0[rep] + k // bw[rep]
        xf = px.to(f64) + 0.5
        yf = py.to(f64) + 0.5
        cov = torch.ones_like(xf, dtype=torch.bool)
        ev = []
        for ea, eb, ec, tl in edges:
            e = ea[rep] * xf + eb[rep] * yf + ec[rep]
            cov &= (e > 0) | ((e == 0) & tl[rep])
            ev.append(e)
        e01, e12, e20 = ev
        idt = inv_det[rep]
        b0, b1, b2 = e12 * idt, e20 * idt, e01 * idt
        z = b0 * sz[rep, 0] + b1 * sz[rep, 1] + b2 * sz[rep, 2]
        cov &= (z >= 0.0) & (z <= 1.0)
        pix = py * w + px
        prior = target.z.reshape(-1)[pix]
        cov &= (z < prior) if compare == "less" else (z > prior)
        sel = torch.nonzero(cov)[:, 0]
        keep_pix.append(pix[sel])
        keep_z.append(z[sel])
        keep_i.append(rep[sel])
        keep_b.append(torch.stack([b0[sel], b1[sel], b2[sel]], 1))
        start = stop
    pix = torch.cat(keep_pix)
    if pix.numel() == 0:
        return
    z = torch.cat(keep_z)
    tri = torch.cat(keep_i)
    bary = torch.cat(keep_b)

    # The nearest fragment per pixel; of equal depths the first submitted.
    npx = h * w
    best = torch.full((npx,), float("inf") if compare == "less" else float("-inf"),
                      dtype=f64, device=dev)
    best.scatter_reduce_(0, pix, z, reduce="amin" if compare == "less" else "amax")
    at_best = z == best[pix]
    first_i = torch.full((npx,), tri.numel() + len(src), dtype=torch.int64, device=dev)
    first_i.scatter_reduce_(0, pix[at_best], tri[at_best], reduce="amin")
    win = at_best & (tri == first_i[pix])
    pix, z, tri, bary = pix[win], z[win], tri[win], bary[win]

    target.z.reshape(-1)[pix] = z
    target.draw.reshape(-1)[pix] = did[tri]
    if target.varyings is not None and attrs is not None:
        pw = bary * iw[tri]
        pw = pw / pw.sum(1, keepdim=True)
        val = (pw[:, :, None] * attrs[tri]).sum(1)
        target.varyings.reshape(npx, -1)[pix] = val
