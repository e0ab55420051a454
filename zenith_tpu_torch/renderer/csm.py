"""Cascaded shadow maps: per-frame camera-frustum-fit light cameras (a
copy of zenith_tpu/renderer/csm.py, host NumPy only).

The single-map sun shadow (renderer/forward.py sun_view_projection) covers
a fixed world extent, so either the texel density is poor up close or the
far scene falls outside the map. CSM splits the camera frustum into N
depth slices, fits an orthographic light camera snugly around each slice,
renders N depth maps (N layers of one depth ARRAY texture, through the
render graph's render-to-layer writes), and picks the layer per pixel at
shading time.

- All fitting is tiny host-side NumPy (8 corners × N slices); the results
  ride the frame function as dynamics — (N,4,4) light VPs, (N,) split
  distances, (N,) per-cascade normal offsets — so camera motion never
  rebuilds it.
- Per-pixel cascade selection is dense math (a sum of compares); the PCF
  taps gather from the flattened (N·S·S) layer stack with a per-pixel
  layer base offset (ops.sampling.sample_shadow_pcf_layered), as many
  gathers as a single shadow map.
- Texel snapping: each cascade's ortho window translation is quantized to
  shadow-texel increments, so a moving camera doesn't make static shadow
  edges shimmer (the standard CSM stabilization).
"""

from __future__ import annotations

import math

import numpy as np

from zenith_tpu_torch.core import mathtypes as m


def cascade_split_distances(
    near: float, far: float, n: int, lam: float = 0.7
) -> np.ndarray:
    """Far edge of each of the ``n`` slices: the standard mix of uniform
    and logarithmic splits (lam=1 → fully logarithmic)."""
    out = []
    for i in range(1, n + 1):
        t = i / n
        uni = near + (far - near) * t
        log = near * (far / near) ** t
        out.append((1.0 - lam) * uni + lam * log)
    return np.asarray(out, np.float32)


def _frustum_slice_corners(camera, d0: float, d1: float) -> np.ndarray:
    """(8, 3) world corners of the camera frustum between view distances
    d0 and d1 (derived from the camera basis + projection tangents — no
    matrix inverse needed)."""
    proj = camera.projection
    tan_x = 1.0 / float(proj[0, 0])
    tan_y = 1.0 / float(proj[1, 1])
    pos = camera.location.astype(np.float64)
    fwd = camera.forward.astype(np.float64)
    right = camera.right.astype(np.float64)
    up = camera.up.astype(np.float64)
    corners = []
    for d in (d0, d1):
        c = pos + fwd * d
        ex = right * (tan_x * d)
        ey = up * (tan_y * d)
        for sx in (-1.0, 1.0):
            for sy in (-1.0, 1.0):
                corners.append(c + ex * sx + ey * sy)
    return np.asarray(corners)


def fit_cascades(sun, camera, n: int, *,
                 near: "float | None" = None,
                 max_distance: "float | None" = None,
                 lam: "float | None" = None):
    """Fit ``n`` light cameras around the camera frustum slices.

    Returns (vps (N,4,4) float32, splits (N,) float32 view-space far edges,
    normal_offsets (N,) float32). ``sun`` supplies direction, map size, the
    caster margin and the split lambda; ``camera`` the frustum (and, by
    default, the near plane — the first slice must start AT the camera near
    or close-up pixels fall outside every cascade and silently unshadow).

    Each window is fit around the slice's BOUNDING SPHERE, not its AABB:
    the window size is then constant for a given slice regardless of camera
    ROTATION, which makes the texel snap exact — the ortho scale never
    changes, so quantizing the window origin to texel steps moves sampling
    by whole texels on BOTH axes (the AABB fit's max-extent snap still
    shimmered on the minor axis whenever ext_x != ext_y).
    """
    near = float(camera.z_near if near is None else near)
    far = float(max_distance if max_distance is not None else sun.shadow_far)
    lam = float(sun.cascade_lambda if lam is None else lam)
    # Split SCHEDULE from a clamped near (a centimeter-scale camera near
    # would collapse the log splits onto the camera's nose), but slice 0 is
    # FIT from the true camera near so close-up pixels stay covered.
    splits = cascade_split_distances(max(near, 1.0), far, n, lam)

    d = m.normalize(np.asarray(sun.direction, np.float32)).astype(np.float64)
    up = np.array([0.0, 0.0, 1.0])
    if abs(float(np.dot(d, up))) > 0.95:
        up = np.array([0.0, 1.0, 0.0])
    # One shared light ROTATION (view from the origin): per-cascade windows
    # are pure translations/extents inside it, which makes texel snapping
    # meaningful frame-to-frame.
    view = m.look_to_rh(np.zeros(3, np.float32), (-d).astype(np.float32),
                        up.astype(np.float32)).astype(np.float64)

    vps = np.empty((n, 4, 4), np.float32)
    noffs = np.empty((n,), np.float32)
    d0 = near
    size = float(sun.shadow_map_size)
    for k in range(n):
        d1 = float(splits[k])
        corners = _frustum_slice_corners(camera, d0, d1)
        # Bounding sphere (mean-center; within a few % of minimal for
        # frustum slices) — radius depends only on the slice SHAPE, so the
        # window never breathes as the camera turns.
        center = corners.mean(axis=0)
        radius = float(np.linalg.norm(corners - center, axis=1).max())
        hom = np.concatenate([center, [1.0]])
        c_ls = (hom @ view.T)[:3]
        # The window must be EXACTLY `size` texels wide so the snap step
        # equals the projection's texel (win/size); otherwise the snap
        # moves sampling by size/(size±1) texels — never integer — and the
        # shimmer returns. texel = 2r/(size-1) makes win = size·texel cover
        # the sphere even after flooring lo by up to one texel.
        texel = 2.0 * radius / (size - 1.0)
        lo_x = math.floor((c_ls[0] - radius) / texel) * texel
        lo_y = math.floor((c_ls[1] - radius) / texel) * texel
        win = size * texel
        # Light-space z: RH looking down -z → visible depths are negative z;
        # near/far planes pulled back by the caster margin so geometry
        # between the slice and the light still occludes.
        near_l = -(c_ls[2] + radius) - float(sun.cascade_margin)
        far_l = -(c_ls[2] - radius) + 1.0
        proj = m.orthographic_rh(
            float(lo_x), float(lo_x + win), float(lo_y), float(lo_y + win),
            float(near_l), float(far_l),
        ).astype(np.float64)
        vps[k] = (m.VULKAN_Y_FLIP @ proj @ view).astype(np.float32)
        # Normal-offset: 1.5 texels of THIS cascade's world-space texel.
        noffs[k] = 1.5 * win / size
        d0 = d1
    return vps, splits, noffs
