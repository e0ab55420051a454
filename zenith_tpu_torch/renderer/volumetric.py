"""Volumetric fog / sun-shaft node over the deferred pipeline (torch port of
zenith_tpu/renderer/volumetric.py).

Reads the lit HDR and the G-buffer position and depth planes and, where the
deferred renderer published its sun shadow map
(``gbuffer_handles["sun_shadow"]``), marches that map for light shafts
(ops/volumetric.py). With shafts on, the node reads the ``def.light_vp`` /
``def.shadow_bias`` dynamics the deferred renderer set on the same builder:
the view-projection that rendered the map. Its own per-frame values ride
``fog.*`` dynamics, so a scene without a sun still gets height fog.
"""

from __future__ import annotations

import numpy as np
import torch

from zenith_tpu_torch.core import mathtypes as m
from zenith_tpu_torch.ops.volumetric import volumetric_sun
from zenith_tpu_torch.parallel import spmd
from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.rendergraph.resource import RenderGraphResource


def view_rays(inv_vp: torch.Tensor, cam: torch.Tensor, h: int, w: int,
              row0: int = 0, full_h: "int | None" = None) -> torch.Tensor:
    """(H, W, 3) per-pixel view rays from the inverse view-projection (not
    normalized): the NDC point at depth 0.5 of each pixel centre, minus the
    camera. ``row0``/``full_h`` place a row band in the frame."""
    dev = inv_vp.device
    ndc_x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * 2 - 1
    ndc_y = ((row0 + torch.arange(h, dtype=torch.float32, device=dev) + 0.5)
             / (full_h or h) * 2 - 1)
    px = ndc_x[None, :].expand(h, w)
    py = ndc_y[:, None].expand(h, w)
    ndc = torch.stack([px, py, torch.full_like(px, 0.5), torch.ones_like(px)], -1)
    p = ndc @ inv_vp.T
    return p[..., :3] / p[..., 3:4] - cam


class VolumetricFog:
    """Declares the volumetric node (volumetric.py:29-162; sandbox/scene.py
    ``--fog``). Per frame the app calls ``render_to(builder, hdr, out,
    camera, gbuffer, sun=scene.sun)`` after the deferred renderer (and
    SSR); retained mode merges ``frame_dynamics(camera)``."""

    def __init__(self, density: float = 0.0035, height: float = 0.0,
                 height_falloff: float = 45.0, anisotropy: float = 0.6,
                 max_distance: float = 400.0, sun_boost: float = 0.9,
                 ambient: float = 0.08, steps: int = 16,
                 jitter: bool = True, shafts: bool = True):
        self.density = float(density)
        self.height = float(height)
        self.height_falloff = float(height_falloff)
        self.anisotropy = float(anisotropy)
        self.max_distance = float(max_distance)
        self.sun_boost = float(sun_boost)
        self.ambient = float(ambient)
        self.steps = int(steps)
        self.jitter = bool(jitter)
        self.shafts = bool(shafts)
        self._sun = None  # observed at render_to / frame_dynamics

    def __zenith_capture_key__(self):
        return ("VolumetricFog", self.steps, self.jitter, self.shafts)

    def _params(self) -> np.ndarray:
        return np.asarray([self.density, self.height, self.height_falloff,
                           self.anisotropy, self.max_distance, self.sun_boost,
                           self.ambient, 0.0], np.float32)

    @staticmethod
    def _sun_values(sun) -> "tuple[np.ndarray, np.ndarray]":
        if sun is None:
            return (np.asarray([0.0, 0.0, 1.0], np.float32),
                    np.asarray([1.0, 1.0, 1.0], np.float32))
        return (m.normalize(np.asarray(sun.direction, np.float32)),
                np.asarray(sun.color, np.float32) * sun.intensity)

    def frame_dynamics(self, camera, sun=None) -> dict:
        """Retained-mode per-frame values (merge into update_dynamics)."""
        sdir, scol = self._sun_values(sun if sun is not None else self._sun)
        return {
            "fog.inv_vp": np.asarray(camera.render_inv_view_projection, np.float32),
            "fog.cam_pos": np.asarray(camera.location, np.float32),
            "fog.sun_dir": sdir,
            "fog.sun_color": scol,
            "fog.params": self._params(),
        }

    def render_to(self, builder: RenderGraphBuilder, hdr_input: RenderGraphResource,
                  output: RenderGraphResource, camera, gbuffer: dict,
                  sun=None) -> RenderGraphResource:
        self._sun = sun
        for name, value in self.frame_dynamics(camera, sun).items():
            builder.set_dynamic(name, value)
        node = builder.add_lambda_node("fog")
        src = node.read(hdr_input)
        p_in = node.read(gbuffer["pos"])
        d_in = node.read(gbuffer["depth"])
        sm_in = (node.read(gbuffer["sun_shadow"])
                 if self.shafts and "sun_shadow" in gbuffer else None)
        dst = node.write(output)
        steps, jitter = self.steps, self.jitter

        def record(ctx):
            dep = ctx.get(d_in)
            cam = ctx.dynamic("fog.cam_pos")
            h, w = dep.shape
            full_h, row0 = h, 0
            if ctx.sharded and ctx.num_shards > 1:
                full_h = h * ctx.num_shards
                row0 = spmd.axis_index(ctx.shard_axis) * h
            # Per-pixel unit view rays over the band's global rows.
            dirs = view_rays(ctx.dynamic("fog.inv_vp"), cam, h, w, row0, full_h)
            dirs = dirs / torch.clamp(torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True)),
                                      min=1e-8)
            if sm_in is not None:
                # Marched taps land anywhere on the small map: gather it
                # whole. The screen planes stay on the band.
                sm = ctx.get_full(sm_in)
                lvp = ctx.dynamic("def.light_vp")
                bias = ctx.dynamic("def.shadow_bias")
            else:
                sm, lvp, bias = None, None, 0.0
            ctx.set(dst, volumetric_sun(
                ctx.get(src), ctx.get(p_in)[..., :3], dep, cam, dirs,
                ctx.dynamic("fog.sun_dir"), ctx.dynamic("fog.sun_color"),
                ctx.dynamic("fog.params"), shadow_map=sm, light_vp=lvp, shadow_bias=bias,
                steps=steps, jitter=jitter, row0=row0,
            ))

        node.execute(record)
        return output
