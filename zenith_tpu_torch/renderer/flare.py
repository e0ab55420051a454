"""Lens flare: procedural ghosts, halo and anamorphic streak added to the HDR
frame before tonemapping (torch port of zenith_tpu/renderer/flare.py).

Per pixel, distance falloffs around a handful of points mirrored across the
screen centre: a fixed loop of elementwise gaussian lobes, no geometry. The
sun's screen position is host math riding a per-frame dynamic. Occlusion
reads the HDR frame's mean luminance in a small window at the sun pixel:
the window's start is a device value, so the window is gathered with index
arithmetic on the card (slicing at it would need a host read, which a
retained frame must not make).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from zenith_tpu_torch.parallel import spmd
from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.rendergraph.resource import RenderGraphResource

# Per-ghost (offset scale, size, rgb tint): alternating warm/cool ghosts
# marching through the screen centre away from the sun.
_GHOSTS = (
    (-0.42, 0.030, (1.0, 0.55, 0.35)),
    (-0.80, 0.055, (0.45, 0.75, 1.0)),
    (-1.25, 0.040, (1.0, 0.85, 0.45)),
    (-1.70, 0.090, (0.55, 0.45, 1.0)),
    (0.45, 0.028, (0.55, 1.0, 0.65)),
    (0.85, 0.060, (1.0, 0.5, 0.65)),
)


@dataclass
class LensFlare:
    """Config and per-frame host state for the flare node (flare.py:47-137).
    ``intensity`` scales everything; ``halo_radius`` is the ring's radius as
    a fraction of the screen height; ``streak`` scales the horizontal line
    through the sun; ``occlusion`` enables the HDR brightness probe
    (``probe_lo``/``probe_hi`` are its smoothstep band in scene luminance,
    ``probe_px`` its window's side)."""

    intensity: float = 0.12
    halo_radius: float = 0.42
    streak: float = 0.6
    occlusion: bool = True
    probe_lo: float = 0.35
    probe_hi: float = 1.2
    probe_px: int = 8

    def __zenith_capture_key__(self):
        return ("LensFlare", self.intensity, self.halo_radius, self.streak,
                self.occlusion, self.probe_lo, self.probe_hi, self.probe_px)

    def sun_dynamics(self, camera, sun_dir) -> dict:
        """Per-frame dynamics: the sun's screen position (u, v in [0, 1],
        v = 0 at the top) and a host visibility factor (0 with the sun
        behind the camera, fading as it leaves the frame). ``sun_dir``
        points toward the sun."""
        d = np.asarray(sun_dir, np.float64)
        d = d / max(np.linalg.norm(d), 1e-12)
        # A point far along the sun direction, projected like any vertex.
        p = np.asarray(camera.location, np.float64) + d * 1e4
        clip = np.asarray(camera.render_view_projection, np.float64) @ np.array([*p, 1.0])
        vis = 0.0
        uv = np.array([0.5, 0.5], np.float64)
        if clip[3] > 1e-6:
            ndc = clip[:3] / clip[3]
            uv = np.array([(ndc[0] + 1.0) * 0.5, (ndc[1] + 1.0) * 0.5])
            # Fade over the outer 30% beyond each edge.
            margin = 0.3
            fx = np.clip((margin + min(uv[0], 1.0 - uv[0])) / margin, 0.0, 1.0)
            fy = np.clip((margin + min(uv[1], 1.0 - uv[1])) / margin, 0.0, 1.0)
            vis = float(fx * fy)
        return {"flare.sun_uv": uv.astype(np.float32), "flare.vis": np.float32(vis)}

    def render_to(self, builder: RenderGraphBuilder, hdr: RenderGraphResource,
                  sun_color=(1.0, 1.0, 1.0)) -> None:
        """Rewrite the HDR texture in place (read → add flare → write), after
        the scene renderer and before PostProcess; the caller merges
        ``sun_dynamics(camera, sun.direction)`` into the frame's dynamics."""
        node = builder.add_lambda_node("flare")
        src = node.read(hdr)
        dst = node.write(hdr)
        cfg = self
        col = np.asarray(sun_color, np.float32)

        def record(ctx):
            img = ctx.get(src)
            sun_uv = ctx.dynamic("flare.sun_uv")
            vis = ctx.dynamic("flare.vis")
            row0 = 0
            full_h = img.shape[0]
            psum_axis = None
            if ctx.sharded and ctx.num_shards > 1:
                full_h = img.shape[0] * ctx.num_shards
                row0 = spmd.axis_index(ctx.shard_axis) * img.shape[0]
                psum_axis = ctx.shard_axis
            if cfg.occlusion:
                vis = vis * _probe_visibility(img[..., :3], sun_uv, cfg, row0, full_h,
                                              psum_axis)
            out_rgb = _apply_flare(img[..., :3], sun_uv, vis, col, cfg, row0, full_h)
            ctx.set(dst, torch.cat([out_rgb, img[..., 3:]], dim=-1))

        node.execute(record)


def _probe_visibility(rgb: torch.Tensor, sun_uv: torch.Tensor, cfg: LensFlare, row0=0,
                      full_h: "int | None" = None, psum_axis=None) -> torch.Tensor:
    """Mean luminance of a probe_px² window at the sun pixel, smoothstepped
    to [0, 1] (flare.py:140-172). The window's start is clamped as the
    reference clamps it and the window is gathered by index, so any sun
    position runs the same frame function without a host read. Under SPMD
    each band sums the window rows it owns and one scalar ``psum``
    combines them."""
    h, w = rgb.shape[0], rgb.shape[1]
    if full_h is None:
        full_h = h
    k = cfg.probe_px
    dev = rgb.device
    cx = torch.clamp((sun_uv[0] * w).to(torch.int32) - k // 2, 0, w - k)
    gy = torch.clamp((sun_uv[1] * full_h).to(torch.int32) - k // 2, 0, full_h - k)
    luma = rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722
    # Rows of the window outside this plane (a band of a taller surface)
    # read zero, as the reference's k-padded plane gives them.
    ks = torch.arange(k, device=dev)
    rows = gy - row0 + ks
    cols = cx + ks
    row_ok = (rows >= 0) & (rows < h)
    win = luma[torch.clamp(rows, 0, h - 1).long()][:, cols.long()]
    total = torch.sum(torch.where(row_ok[:, None], win, torch.zeros_like(win)))
    if psum_axis is not None:
        total = spmd.psum(total, psum_axis)
    mean = total / float(k * k)
    t = torch.clamp((mean - cfg.probe_lo) / max(cfg.probe_hi - cfg.probe_lo, 1e-6), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _apply_flare(rgb: torch.Tensor, sun_uv: torch.Tensor, vis, sun_color, cfg: LensFlare,
                 row0, full_h: int) -> torch.Tensor:
    """Add ghosts, halo and streak to the (H, W, 3) plane (flare.py:175-218),
    in v-normalized units (x scaled by the aspect) so lobes stay round."""
    hb, w = rgb.shape[0], rgb.shape[1]
    dev = rgb.device
    inv_h = 1.0 / float(full_h)
    ys = (row0 + torch.arange(hb, dtype=torch.float32, device=dev) + 0.5) * inv_h
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / float(w)
    aspect = float(w) / float(full_h)
    px = xs[None, :] * aspect
    py = ys[:, None]
    sx = sun_uv[0] * aspect
    sy = sun_uv[1]
    c0x, c0y = 0.5 * aspect, 0.5  # screen centre

    def tint(x, c):
        """``x[..., None] * c`` for a constant colour, channel by channel
        (no host constant reaches the card)."""
        return torch.stack([x * float(np.float32(v)) for v in c], dim=-1)

    # Ghost axis: sun → centre, ghosts at fixed multiples along it.
    ax, ay = c0x - sx, c0y - sy
    flare = torch.zeros_like(rgb)
    for off, size, col in _GHOSTS:
        gx = c0x + ax * off
        gy = c0y + ay * off
        dx, dy = px - gx, py - gy
        d2 = dx * dx + dy * dy
        lobe = torch.exp(-d2 / (2.0 * size * size))
        flare = flare + tint(lobe, col)

    # Halo: a thin ring around the screen centre, brightest with the sun
    # off-centre.
    ex, ey = px - c0x, py - c0y
    dc = torch.sqrt(ex * ex + ey * ey)
    rr = dc - cfg.halo_radius
    ring = torch.exp(-(rr * rr) / (2.0 * 0.02 ** 2))
    halo_gain = torch.clamp(torch.sqrt(ax * ax + ay * ay) * 2.0, 0.0, 1.0)
    flare = flare + tint((0.6 * halo_gain) * ring, (0.55, 0.7, 1.0))

    # Anamorphic streak: a horizontal line through the sun.
    if cfg.streak > 0.0:
        ly, lx = py - sy, px - sx
        line = torch.exp(-(ly * ly) / (2.0 * 0.004 ** 2)) * torch.exp(
            -(lx * lx) / (2.0 * 0.35 ** 2))
        flare = flare + tint(cfg.streak * line, (0.45, 0.65, 1.0))

    gain = flare * (cfg.intensity * vis)
    return rgb + torch.stack([gain[..., c] * float(np.float32(v))
                              for c, v in enumerate(sun_color)], dim=-1)
