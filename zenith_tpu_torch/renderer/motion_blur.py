"""Camera and object motion blur over the deferred pipeline (torch port of
zenith_tpu/renderer/motion_blur.py), on TAA's reprojection:

- No velocity pass: the per-pixel velocity is the pixel minus the previous
  frame's screen position of the same surface point under the previous
  unjittered view-projection (the G-buffer's world positions, or with the
  velocity plane the previous ones, so object motion streaks too).
- The resolve gathers N nearest taps along the velocity streak, centred on
  the pixel (±v/2), with an optional per-pixel hash phase (ops.ssao's
  coordinate hash) that trades banding for noise.
- The speed is clamped to ``max_radius`` pixels and scaled by
  ``strength``; both ride a packed (4,) dynamic.
- With the velocity plane, dominant-velocity dilation (``dilate_velocity``)
  lets a moving silhouette smear over the background behind it.
"""

from __future__ import annotations

import numpy as np
import torch

from zenith_tpu_torch.ops.ssao import _pixel_hash_angle
from zenith_tpu_torch.parallel import spmd
from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.rendergraph.resource import RenderGraphResource
from zenith_tpu_torch.renderer.taa import (
    CameraHistory,
    _edge_pad,
    _warn_without_velocity,
    reproject,
)


def dilate_velocity(vx: torch.Tensor, vy: torch.Tensor,
                    radius: int = 1) -> "tuple[torch.Tensor, torch.Tensor]":
    """Dominant-velocity dilation: each pixel takes the velocity of the
    fastest pixel in its (2r+1)² neighbourhood (edge-clamped shifts)."""
    h, w = vx.shape
    speed2 = vx * vx + vy * vy
    pv = _edge_pad(torch.stack([vx, vy, speed2], -1), radius)
    best_vx, best_vy, best_s = vx, vy, speed2
    for dy in range(2 * radius + 1):
        for dx in range(2 * radius + 1):
            if dy == radius and dx == radius:
                continue
            n = pv[dy:dy + h, dx:dx + w]
            take = n[..., 2] > best_s
            best_vx = torch.where(take, n[..., 0], best_vx)
            best_vy = torch.where(take, n[..., 1], best_vy)
            best_s = torch.maximum(best_s, n[..., 2])
    return best_vx, best_vy


def motion_blur_resolve(
    hdr: torch.Tensor,  # (H, W, 4) scene colour (post-TAA, pre-tonemap)
    world_pos: torch.Tensor,  # (H, W, 3) world positions (the previous ones with velocity)
    depth: torch.Tensor,  # (H, W) reverse-Z depth (0 = background)
    prev_vp: torch.Tensor,  # (4, 4) the previous frame's unjittered view-projection
    params: torch.Tensor,  # (4,): strength, max_radius_px, pad, pad
    samples: int = 8,
    jitter: bool = True,
    dilate: int = 0,  # dominant-velocity dilation radius (px)
) -> torch.Tensor:
    """One motion-blur resolve: reproject → clamp the velocity → an N-tap
    streak average. Returns the blurred (H, W, 4) colour."""
    h, w = depth.shape
    rgb = hdr[..., :3]
    strength = params[0]
    max_radius = torch.clamp(params[1], min=0.0)

    clip, sx, sy, xs, ys = reproject(world_pos, prev_vp, h, w)
    covered = (depth > 0.0) & (clip[..., 3] > 0.0)

    # Velocity in pixels: where the point was → where it is.
    zero = torch.zeros_like(sx)
    vx = torch.where(covered, xs - sx, zero) * strength
    vy = torch.where(covered, ys - sy, zero) * strength
    speed = torch.sqrt(vx * vx + vy * vy)
    scale = torch.where(speed > max_radius, max_radius / torch.clamp(speed, min=1e-6),
                        torch.ones_like(speed))
    vx = vx * scale
    vy = vy * scale
    if dilate > 0:
        vx, vy = dilate_velocity(vx, vy, dilate)

    # A centred streak, offsets in (-1/2, +1/2] of the velocity; taps round
    # half up (floor(x + 0.5)).
    if jitter:
        phase = _pixel_hash_angle(h, w, device=hdr.device) * (0.5 / np.pi)  # [0, 1)
    else:
        phase = 0.5
    flat = rgb.reshape(-1, 3)
    acc = torch.zeros_like(rgb)
    for i in range(samples):
        t = (i + phase) / samples - 0.5
        tx = torch.clamp(torch.floor(xs + vx * t + 0.5).to(torch.int64), 0, w - 1)
        ty = torch.clamp(torch.floor(ys + vy * t + 0.5).to(torch.int64), 0, h - 1)
        acc = acc + flat[(ty * w + tx).reshape(-1)].reshape(h, w, 3)
    out_rgb = acc * (1.0 / samples)
    return torch.cat([out_rgb, hdr[..., 3:4]], dim=-1)


class MotionBlur:
    """Declares the motion-blur node between the scene (or TAA) output and
    post (sandbox/scene.py ``--motion-blur``). Per frame the app calls
    ``render_to(builder, hdr, out, camera, gbuffer)`` after TAA; retained,
    it merges ``frame_dynamics(camera)`` (the previous view-projection and
    the shutter values; no surface crosses frames)."""

    def __init__(self, strength: float = 1.0, max_radius: float = 32.0,
                 samples: int = 8, jitter: bool = True, dilate: int = 1):
        self.strength = float(strength)
        self.max_radius = float(max_radius)
        self.samples = int(samples)
        self.jitter = bool(jitter)
        # Dominant-velocity dilation radius, applied only with the velocity
        # plane (object motion needs silhouette smear).
        self.dilate = int(dilate)
        self._camera = CameraHistory()

    def __zenith_capture_key__(self):
        return ("MotionBlur", self.samples, self.jitter, self.dilate)

    def reset(self) -> None:
        """Drop the view-projection history (resize, scene cut)."""
        self._camera.reset()

    def _params(self) -> np.ndarray:
        return np.asarray([self.strength, self.max_radius, 0.0, 0.0], np.float32)

    def _observe_camera(self, camera) -> np.ndarray:
        """Its own history, so TAA and blur together each see a one-frame lag."""
        return self._camera.observe(camera)

    def frame_dynamics(self, camera) -> dict:
        """Retained-mode per-frame values (merge into update_dynamics)."""
        return {"mblur.prev_vp": self._observe_camera(camera), "mblur.params": self._params()}

    def render_to(
        self,
        builder: RenderGraphBuilder,
        hdr_input: RenderGraphResource,
        output: RenderGraphResource,
        camera,
        gbuffer: dict,  # DeferredRenderer.gbuffer_handles
    ) -> RenderGraphResource:
        builder.set_dynamic("mblur.prev_vp", self._observe_camera(camera))
        builder.set_dynamic("mblur.params", self._params())
        node = builder.add_lambda_node("motion_blur")
        src = node.read(hdr_input)
        has_vel = "prev_pos" in gbuffer
        _warn_without_velocity(self, gbuffer, "motion blur")
        p_in = node.read(gbuffer["prev_pos"] if has_vel else gbuffer["pos"])
        d_in = node.read(gbuffer["depth"])
        dst = node.write(output)
        samples = self.samples
        jitter = self.jitter
        dilate = self.dilate if has_vel else 0

        def record(ctx):
            hdr = ctx.get(src)
            prev_vp = ctx.dynamic("mblur.prev_vp")
            params = ctx.dynamic("mblur.params")
            if ctx.sharded and ctx.num_shards > 1:
                # Streak taps land anywhere on screen: run on the gathered
                # full surfaces, slice the band back (the TAA pattern).
                full = motion_blur_resolve(
                    ctx.get_full(src), ctx.get_full(p_in)[..., :3], ctx.get_full(d_in),
                    prev_vp, params, samples, jitter, dilate)
                y0 = spmd.axis_index(ctx.shard_axis) * hdr.shape[0]
                out = full[y0:y0 + hdr.shape[0]]
            else:
                out = motion_blur_resolve(
                    hdr, ctx.get(p_in)[..., :3], ctx.get(d_in),
                    prev_vp, params, samples, jitter, dilate)
            ctx.set(dst, out)

        node.execute(record)
        return output
