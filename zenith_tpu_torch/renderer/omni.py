"""Omnidirectional (cube) shadow maps for point lights (a copy of
zenith_tpu/renderer/omni.py; host NumPy, and ``omni_reference_z`` on either
NumPy arrays or torch tensors).

Six depth faces around the light, rendered with render-to-layer writes
into one cube depth texture, sampled at shading time by direction through
the same layered compare-PCF the cascades use (face = layer).

The face matrices are built directly from the Vulkan cube-map face basis
(16.5.4 — the same table ops.sampling.cube_direction_to_face_uv uses), so
"project with face k's matrix" and "select face+uv from a direction" are
exact inverses by construction:

    clip = [ u_axis·(p−L),  v_axis·(p−L),  zscale·w − zbias,  w ]
    w    = fwd·(p−L)                    (the AXIS distance)
    z/w  = far·(w−near) / (w·(far−near))   — regular (non-reverse) [0,1]

Depth stays the raster z (no distance-writing fragment pass); the sampler
converts the surface's axis distance to reference z analytically and the
2x2 compare-PCF does the rest. All six faces share near/far, so one
formula serves every face.
"""

from __future__ import annotations

import numpy as np

# Per-face (forward, u_axis, v_axis) — ∂direction/∂u and ∂direction/∂v of
# the Vulkan 16.5.4 face table (order +X -X +Y -Y +Z -Z).
_FACE_BASIS = (
    ((1, 0, 0), (0, 0, -1), (0, -1, 0)),
    ((-1, 0, 0), (0, 0, 1), (0, -1, 0)),
    ((0, 1, 0), (1, 0, 0), (0, 0, 1)),
    ((0, -1, 0), (1, 0, 0), (0, 0, -1)),
    ((0, 0, 1), (1, 0, 0), (0, -1, 0)),
    ((0, 0, -1), (-1, 0, 0), (0, -1, 0)),
)


def omni_face_matrices(light_pos, near: float, far: float) -> np.ndarray:
    """(6, 4, 4) float32 view-projections, one per cube face."""
    eye = np.asarray(light_pos, np.float64).reshape(3)
    zs = far / (far - near)
    zb = far * near / (far - near)
    out = np.empty((6, 4, 4), np.float32)
    for k, (fwd, ua, va) in enumerate(_FACE_BASIS):
        fwd = np.asarray(fwd, np.float64)
        ua = np.asarray(ua, np.float64)
        va = np.asarray(va, np.float64)
        m = np.zeros((4, 4), np.float64)
        m[0, :3] = ua
        m[0, 3] = -ua @ eye
        m[1, :3] = va
        m[1, 3] = -va @ eye
        m[2, :3] = zs * fwd
        m[2, 3] = -zs * (fwd @ eye) - zb
        m[3, :3] = fwd
        m[3, 3] = -fwd @ eye
        out[k] = m.astype(np.float32)
    return out


def omni_reference_z(axis_distance, near: float, far: float):
    """Analytic z(d) for the face projection above, on a NumPy array or a
    torch tensor. Clamped below at ``near`` (closer fragments project
    behind the near plane; treat them as at-near)."""
    floor = near * 1.0001
    if isinstance(axis_distance, np.ndarray):
        d = np.maximum(axis_distance, floor)
    else:
        d = axis_distance.clamp(min=floor)
    return far * (d - near) / (d * (far - near))
