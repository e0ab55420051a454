"""Depth of field (torch port of zenith_tpu/renderer/dof.py): the mip-blur
formulation.

1. a small blur pyramid of the scene colour (2× box downsample, then the
   separable 9-tap gaussian of the post chain);
2. every level upsampled back to full resolution (repeats + crops);
3. per pixel, the circle of confusion from the G-buffer's view distance
   blends the levels with tent weights max(0, 1 − |lod − m|): at most two
   non-zero levels, all elementwise.

The focus parameters ride one packed dynamic, so racking focus never builds
a new frame function. Under an SPMD mesh the pyramid's blur crosses band
rows, so a band gathers the whole surface, computes and slices back.
"""

from __future__ import annotations

import numpy as np
import torch

from zenith_tpu_torch.parallel import spmd

from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.rendergraph.resource import RenderGraphResource
from zenith_tpu_torch.renderer.post import _blur_axis, _downsample2, _upsample2


def _blur_levels(rgb: torch.Tensor, levels: int) -> "list[torch.Tensor]":
    h, w = rgb.shape[0], rgb.shape[1]
    out = [rgb]
    cur = rgb
    for _ in range(levels - 1):
        cur = _downsample2(cur)
        cur = _blur_axis(_blur_axis(cur, 0), 1)
        out.append(_upsample2(cur, h, w))
    return out


def dof_blend(hdr: torch.Tensor, view_dist: torch.Tensor, params: torch.Tensor,
              levels: int = 4) -> torch.Tensor:
    """Per-pixel level blend by circle of confusion (dof.py:45-66).
    ``hdr`` (H, W, 4); ``view_dist`` (H, W), the camera-to-surface distance
    (0 = sky); ``params`` (4,): focus distance, focal range, strength, pad."""
    rgb = hdr[..., :3]
    pyramid = _blur_levels(rgb, levels)
    focus = params[0]
    frange = torch.clamp(params[1], min=1e-3)
    strength = params[2]
    # The sky (distance 0) focuses at infinity: a huge distance.
    d = torch.where(view_dist > 0.0, view_dist, torch.full_like(view_dist, 1e6))
    coc = torch.abs(d - focus) / (torch.abs(d) + frange)
    lod = torch.clamp(coc * strength * (levels - 1), 0.0, levels - 1.0)
    acc = torch.zeros_like(rgb)
    for m, lvl in enumerate(pyramid):
        wgt = torch.clamp(1.0 - torch.abs(lod - m), min=0.0)[..., None]
        acc = acc + lvl * wgt
    return torch.cat([acc, hdr[..., 3:4]], dim=-1)


class DepthOfField:
    """Declares the DoF node between the scene (or TAA) output and post
    (dof.py:69-144). The parameters ride a packed (4,) dynamic: change the
    fields (or call ``focus_at``) and the next frame racks focus with the
    same frame function."""

    def __init__(self, focus_distance: float = 170.0, focal_range: float = 40.0,
                 strength: float = 1.0, levels: int = 4):
        self.focus_distance = float(focus_distance)
        self.focal_range = float(focal_range)
        self.strength = float(strength)
        self.levels = int(levels)

    def __zenith_capture_key__(self):
        return ("DepthOfField", self.levels)

    def focus_at(self, distance: float) -> None:
        self.focus_distance = float(distance)

    def _params(self) -> np.ndarray:
        return np.asarray([self.focus_distance, self.focal_range, self.strength, 0.0],
                          np.float32)

    def frame_dynamics(self) -> dict:
        """Retained-mode per-frame values (focus racking)."""
        return {"dof.params": self._params()}

    def render_to(self, builder: RenderGraphBuilder, hdr_input: RenderGraphResource,
                  output: RenderGraphResource, gbuffer: dict) -> RenderGraphResource:
        """``gbuffer``: DeferredRenderer.gbuffer_handles (its ``pos`` and
        ``depth`` planes); reads the ``def.camera_pos`` dynamic."""
        builder.set_dynamic("dof.params", self._params())
        node = builder.add_lambda_node("dof")
        src = node.read(hdr_input)
        p_in = node.read(gbuffer["pos"])
        d_in = node.read(gbuffer["depth"])
        dst = node.write(output)
        levels = self.levels

        def record(ctx):
            hdr = ctx.get(src)
            banded = ctx.sharded and ctx.num_shards > 1
            cam = ctx.dynamic("def.camera_pos")
            params = ctx.dynamic("dof.params")

            def dist_of(pos_plane, depth_plane):
                dist = torch.linalg.vector_norm(pos_plane[..., :3] - cam, dim=-1)
                return torch.where(depth_plane > 0.0, dist, torch.zeros_like(dist))

            if banded:
                # The pyramid's blur crosses band rows: gather, compute,
                # slice back (the thin-band post pattern).
                full = dof_blend(ctx.get_full(src),
                                 dist_of(ctx.get_full(p_in), ctx.get_full(d_in)),
                                 params, levels)
                y0 = spmd.axis_index(ctx.shard_axis) * hdr.shape[0]
                out = full[y0:y0 + hdr.shape[0]]
            else:
                out = dof_blend(hdr, dist_of(ctx.get(p_in), ctx.get(d_in)), params, levels)
            ctx.set(dst, out)

        node.execute(record)
        return output
