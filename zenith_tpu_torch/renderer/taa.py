"""Temporal anti-aliasing over the deferred pipeline (torch port of
zenith_tpu/renderer/taa.py).

- The camera projection is jittered by a Halton(2,3) sub-pixel sequence
  (``Camera.set_jitter``, a translation after the projection), so the
  jitter is a dynamic.
- Reprojection needs no motion-vector pass: the G-buffer's world positions
  (or, with ``DeferredRenderer(velocity=True)``, the previous frame's
  world positions of the ``g.prev`` plane) go through the previous
  unjittered view-projection to the pixel they came from.
- The history is fetched bilinearly (4 gathers) and clamped to the current
  frame's 3×3 neighbourhood, built from edge-clamped shifts (no wrap).
- The blend is inverse-luminance weighted (Karis).

The history travels on the engine's feedback path: the TAA output is
exported, ``RenderContext.request_output("taa.history", ...)`` hands the
device tensor back through ``app.on_frame_outputs``, and the next frame
feeds it in as a dynamic. A ``taa.valid`` scalar, chosen on the host from
whether history exists, gates frame 0, so one frame function serves every
frame.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from zenith_tpu_torch.core import log as _log
from zenith_tpu_torch.core import validate as _validate
from zenith_tpu_torch.parallel import spmd
from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.rendergraph.resource import RenderGraphResource
from zenith_tpu_torch.renderer.post import _luma

logger = _log.get(__name__)


def halton(index: int, base: int) -> float:
    """Low-discrepancy Halton sample in [0, 1) (1-indexed)."""
    f, r = 1.0, 0.0
    while index > 0:
        f /= base
        r += f * (index % base)
        index //= base
    return r


def jitter_sequence(length: int = 8) -> "list[tuple[float, float]]":
    """Halton(2,3) sub-pixel offsets in [-0.5, 0.5) pixels."""
    return [(halton(i + 1, 2) - 0.5, halton(i + 1, 3) - 0.5) for i in range(length)]


def _edge_pad(img: torch.Tensor, r: int) -> torch.Tensor:
    """(H, W, C) → (H + 2r, W + 2r, C), borders repeated (jnp.pad "edge")."""
    return F.pad(img.permute(2, 0, 1)[None], (r, r, r, r), mode="replicate")[0].permute(1, 2, 0)


def reproject(world_pos: torch.Tensor, prev_vp: torch.Tensor, h: int, w: int):
    """(clip, sx, sy, xs, ys): this pixel's surface point through the
    previous view-projection, in the rasterizer's NDC→pixel convention,
    beside the pixel's own coordinates (taa.py:92-107)."""
    p = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])], dim=-1)
    clip = p @ prev_vp.T
    cw = torch.clamp(clip[..., 3], min=1e-6)
    sx = (clip[..., 0] / cw * 0.5 + 0.5) * w - 0.5
    sy = (clip[..., 1] / cw * 0.5 + 0.5) * h - 0.5
    dev = world_pos.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    return clip, sx, sy, xs, ys


def taa_resolve(
    cur: torch.Tensor,  # (H, W, 4) this frame's HDR colour (jittered render)
    history: torch.Tensor,  # (H, W, 4) accumulated history
    world_pos: torch.Tensor,  # (H, W, 3) G-buffer world positions
    depth: torch.Tensor,  # (H, W) reverse-Z depth (0 = background)
    prev_vp: torch.Tensor,  # (4, 4) the previous frame's unjittered view-projection
    valid: torch.Tensor,  # scalar: 0 on the first frame (history undefined)
    alpha: float = 0.125,
) -> torch.Tensor:
    """One TAA resolve: reproject → clamp → blend. Returns the resolved
    (H, W, 4) colour, both this frame's output and the next history."""
    h, w = depth.shape
    rgb = cur[..., :3]

    # The 3×3 neighbourhood bounds, from edge-clamped shifts: a wrapping
    # roll would clamp border pixels against the opposite edge.
    padded = _edge_pad(rgb, 1)
    nmin = rgb
    nmax = rgb
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            r = padded[dy:dy + h, dx:dx + w]
            nmin = torch.minimum(nmin, r)
            nmax = torch.maximum(nmax, r)

    clip, sx, sy, xs, ys = reproject(world_pos, prev_vp, h, w)
    covered = depth > 0.0
    # Background (sky) pixels: zero motion; the clamp absorbs the drift.
    sx = torch.where(covered, sx, xs)
    sy = torch.where(covered, sy, ys)
    onscreen = ((sx >= 0.0) & (sx <= w - 1.0) & (sy >= 0.0) & (sy <= h - 1.0)
                & ((clip[..., 3] > 0.0) | ~covered))

    # Bilinear history fetch: 4 gathers.
    x0 = torch.clamp(torch.floor(sx).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(sy).to(torch.int64), 0, h - 2)
    fx = torch.clamp(sx - x0.to(torch.float32), 0.0, 1.0)[..., None]
    fy = torch.clamp(sy - y0.to(torch.float32), 0.0, 1.0)[..., None]
    flat = history[..., :3].reshape(-1, 3)

    def gather(yy, xx):
        return flat[(yy * w + xx).reshape(-1)].reshape(h, w, 3)

    h00 = gather(y0, x0)
    h01 = gather(y0, x0 + 1)
    h10 = gather(y0 + 1, x0)
    h11 = gather(y0 + 1, x0 + 1)
    hist = (h00 * (1 - fx) + h01 * fx) * (1 - fy) + (h10 * (1 - fx) + h11 * fx) * fy
    hist = torch.minimum(torch.maximum(hist, nmin), nmax)

    # Inverse-luminance weights keep HDR fireflies from strobing.
    wc = alpha / (1.0 + _luma(rgb))
    wh = (1.0 - alpha) / (1.0 + _luma(hist))
    blended = (rgb * wc + hist * wh) / (wc + wh)

    use_hist = (valid > 0.0) & onscreen
    out_rgb = torch.where(use_hist[..., None], blended, rgb)
    return torch.cat([out_rgb, cur[..., 3:4]], dim=-1)


def _warn_without_velocity(owner, gbuffer, what: str) -> None:
    """Under validation, warn once when an animated scene runs a temporal
    pass without the velocity plane."""
    if (getattr(gbuffer, "animated_without_velocity", False) and "prev_pos" not in gbuffer
            and _validate.enabled() and not getattr(owner, "_warned_no_velocity", False)):
        owner._warned_no_velocity = True
        logger.warning(
            "[validate] %s on an ANIMATED scene without the per-draw velocity plane: "
            "moving objects reproject with the static-world assumption. Construct "
            "DeferredRenderer(velocity=True) (automatic for device-resident instance "
            "offsets).", what)


class CameraHistory:
    """The previous frame's unjittered view-projection: rolls prev ← last
    ← current only when the camera's matrix value changed, so calling it
    twice in a frame rolls once (taa.py:199-211)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._prev_vp = None
        self._last_vp = None

    def observe(self, camera) -> np.ndarray:
        cur = np.asarray(camera.render_view_projection_unjittered, np.float32)
        if self._last_vp is None:
            self._last_vp = cur.copy()
            self._prev_vp = self._last_vp
        elif not np.array_equal(cur, self._last_vp):
            self._prev_vp = self._last_vp
            self._last_vp = cur.copy()
        return self._prev_vp


class TemporalAA:
    """Declares the TAA node and owns its cross-frame state.

    Per frame the app calls (sandbox/scene.py ``--taa``):

    1. ``jitter_camera(camera, w, h)`` in ``tick``: advances the Halton
       sequence and sets the camera's sub-pixel jitter.
    2. ``render_to(builder, hdr, out, camera, w, h, gbuffer)`` in
       ``render``, after the deferred renderer and before post; exports
       ``out``.
    3. ``context.request_output("taa.history", out)`` and, in
       ``on_frame_outputs``, ``feedback(tensor)``: the resolved frame
       returns as the next history, on the device.
    """

    def __init__(self, alpha: float = 0.125, sequence_length: int = 8):
        self.alpha = float(alpha)
        self._seq = jitter_sequence(sequence_length)
        self._frame = 0
        self._history = None  # (H, W, 4) device tensor | None
        self._camera = CameraHistory()
        self._hw = None

    def jitter_camera(self, camera, width: int, height: int) -> None:
        ox, oy = self._seq[self._frame % len(self._seq)]
        camera.set_jitter(2.0 * ox / max(width, 1), 2.0 * oy / max(height, 1))
        self._frame += 1

    def reset(self) -> None:
        """Drop the history (resize, scene cut)."""
        self._history = None
        self._camera.reset()

    def feedback(self, history: torch.Tensor) -> None:
        """Engine feedback: this frame's resolved output → the next history."""
        self._history = history

    def _observe_camera(self, camera) -> np.ndarray:
        return self._camera.observe(camera)

    def frame_dynamics(self, camera) -> dict:
        """Retained-mode per-frame values (merge into update_dynamics);
        idempotent within a frame."""
        d = {
            "taa.prev_vp": self._observe_camera(camera),
            "taa.valid": np.float32(0.0 if self._history is None else 1.0),
        }
        if self._history is not None:
            d["taa.history"] = self._history
        return d

    def render_to(
        self,
        builder: RenderGraphBuilder,
        hdr_input: RenderGraphResource,
        output: RenderGraphResource,
        camera,
        width: int,
        height: int,
        gbuffer: dict,
    ) -> RenderGraphResource:
        if self._hw != (height, width):
            self.reset()
            self._hw = (height, width)
        valid = self._history is not None
        # Frame 0's history is a host array of the fed-back tensor's shape
        # and dtype, so both frames share one frame function.
        history = self._history if valid else np.zeros((height, width, 4), np.float32)
        builder.set_dynamic("taa.history", history)
        builder.set_dynamic("taa.prev_vp", self._observe_camera(camera))
        builder.set_dynamic("taa.valid", np.float32(1.0 if valid else 0.0))

        node = builder.add_lambda_node("taa")
        src = node.read(hdr_input)
        # With the velocity plane, reproject through the previous world
        # positions (moving objects land where they were); without it, the
        # static-world assumption.
        _warn_without_velocity(self, gbuffer, "TAA")
        p_in = node.read(gbuffer.get("prev_pos", gbuffer["pos"]))
        d_in = node.read(gbuffer["depth"])
        dst = node.write(output)
        alpha = self.alpha

        def record(ctx):
            cur = ctx.get(src)
            if ctx.sharded and ctx.num_shards > 1:
                # Reprojection gathers land anywhere on screen: run on the
                # gathered full surfaces, slice the band back (the history
                # dynamic is replicated already).
                full = taa_resolve(
                    ctx.get_full(src), ctx.dynamic("taa.history"),
                    ctx.get_full(p_in)[..., :3], ctx.get_full(d_in),
                    ctx.dynamic("taa.prev_vp"), ctx.dynamic("taa.valid"), alpha)
                y0 = spmd.axis_index(ctx.shard_axis) * cur.shape[0]
                out = full[y0:y0 + cur.shape[0]]
            else:
                out = taa_resolve(
                    cur, ctx.dynamic("taa.history"), ctx.get(p_in)[..., :3],
                    ctx.get(d_in), ctx.dynamic("taa.prev_vp"), ctx.dynamic("taa.valid"), alpha)
            ctx.set(dst, out)

        node.execute(record)
        builder.export(output)
        return output
