"""Forward-renderer helpers the deferred renderer shares (torch port of the
parts of zenith_tpu/renderer/forward.py that deferred.py imports): the sun's
orthographic light camera, the shadow vertex stages, the shadow compare
sampler and the per-frame camera dynamics.

``ForwardShadowRenderer`` itself (BASELINE.md config #3) is not ported yet
(ROADMAP item 14).
"""

from __future__ import annotations

import numpy as np
import torch

from zenith_tpu_torch.core import mathtypes as m
from zenith_tpu_torch.renderer.scene import DirectionalLight
from zenith_tpu_torch.rhi.sampler import AddressMode, BorderColor, SamplerConfig
from zenith_tpu_torch.rhi.state import CompareOp


def sun_view_projection(sun: DirectionalLight) -> np.ndarray:
    """Orthographic light camera looking along -direction at the origin
    (forward.py:53-70), memoized per sun field values."""
    d = tuple(float(x) for x in np.asarray(sun.direction).reshape(-1))
    key = (d, float(sun.shadow_near), float(sun.shadow_far),
           float(sun.shadow_extent))
    cached = getattr(sun, "_svp_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    out = _sun_view_projection(sun)
    object.__setattr__(sun, "_svp_cache", (key, out))
    return out


def _sun_view_projection(sun: DirectionalLight) -> np.ndarray:
    d = m.normalize(np.asarray(sun.direction, np.float32))
    eye = d * (0.5 * (sun.shadow_near + sun.shadow_far))
    up = np.array([0, 0, 1], np.float32)
    if abs(float(np.dot(d, up))) > 0.95:
        up = np.array([0, 1, 0], np.float32)
    view = m.look_to_rh(eye, -d, up)
    e = sun.shadow_extent
    proj = m.orthographic_rh(-e, e, -e, e, sun.shadow_near, sun.shadow_far)
    # Same Vulkan Y flip as the main camera (render and sample agree).
    return (m.VULKAN_Y_FLIP @ proj @ view).astype(np.float32)


def _homogeneous(pos: torch.Tensor) -> torch.Tensor:
    return torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)


def _shadow_vs(attrs, res):
    world = _homogeneous(attrs["position"]) @ res["Model"].T
    return {"position": world @ res["LightViewProj"].T}


def _shadow_inst_vs(attrs, res):
    world = _homogeneous(attrs["position"]) @ res["Model"].T
    world_pos = world[:, :3] + attrs["inst_offset"]
    clip_hom = torch.cat([world_pos, world[:, 3:4]], dim=1)
    return {"position": clip_hom @ res["LightViewProj"].T}


_SHADOW_SAMPLER = SamplerConfig(
    address_mode_u=AddressMode.CLAMP_TO_EDGE,
    address_mode_v=AddressMode.CLAMP_TO_EDGE,
    compare_enable=True,
    compare_op=CompareOp.LESS_OR_EQUAL,
    border_color=BorderColor.OPAQUE_WHITE,
)


def _camera_dynamics(prefix: str, camera, want_inv_vp: bool) -> dict:
    vp = np.asarray(camera.render_view_projection, np.float32)
    d = {
        f"{prefix}.view_proj": vp,
        f"{prefix}.camera_pos": np.asarray(camera.location, np.float32),
    }
    if want_inv_vp:
        d[f"{prefix}.inv_vp"] = camera.render_inv_view_projection
    return d
