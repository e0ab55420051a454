"""Camera and light matrices of the reference, in float32 NumPy as a
real-time renderer's host computes them: a right-handed Z-up world, an
infinite-far reverse-Z perspective with a [0, 1] depth range, the Vulkan Y
flip, and a yaw/pitch camera whose basis is the rotation of a Z-then-X
(yaw, pitch) quaternion. The inverse view-projection is worked out in
float64 from the rigid view and the projection, then rounded."""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32
Y_FLIP = np.diag([1.0, -1.0, 1.0, 1.0]).astype(F32)
NEAR = 0.1


def _unit(v: np.ndarray) -> np.ndarray:
    n = math.sqrt(float(np.dot(v, v)))
    return v / n if n > 0 else v


def _cross(a, b) -> np.ndarray:
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], dtype=F32)


def look_to(eye, direction, up) -> np.ndarray:
    f = _unit(np.asarray(direction, F32))
    s = _unit(_cross(f, np.asarray(up, F32)))
    u = _cross(s, f)
    m = np.eye(4, dtype=F32)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3] = -float(np.dot(eye, s))
    m[1, 3] = -float(np.dot(eye, u))
    m[2, 3] = float(np.dot(eye, f))
    return m


def perspective_reverse_z(fov_y_deg: float, aspect: float, near: float = NEAR) -> np.ndarray:
    f = 1.0 / math.tan(0.5 * math.radians(fov_y_deg))
    m = np.zeros((4, 4), F32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 3] = near
    m[3, 2] = -1.0
    return m


def orthographic(e: float, near: float, far: float) -> np.ndarray:
    m = np.eye(4, dtype=F32)
    m[0, 0] = 2.0 / (e + e)
    m[1, 1] = 2.0 / (e + e)
    m[2, 2] = -1.0 / (far - near)
    m[0, 3] = -(e - e) / (e + e)
    m[1, 3] = -(e - e) / (e + e)
    m[2, 3] = -near / (far - near)
    return m


def _basis(yaw: float, pitch: float) -> np.ndarray:
    """The rotation matrix (float32) of yaw about Z then pitch about X."""
    hz, hx = 0.5 * yaw, 0.5 * pitch
    cz, sz, cx, sx = math.cos(hz), math.sin(hz), math.cos(hx), math.sin(hx)
    x, y, z, w = (float(c) for c in np.array([cz * sx, sz * sx, sz * cx, cz * cx], F32))
    m = np.eye(4, dtype=F32)
    m[0, 0] = 1 - 2 * (y * y + z * z)
    m[0, 1] = 2 * (x * y - z * w)
    m[0, 2] = 2 * (x * z + y * w)
    m[1, 0] = 2 * (x * y + z * w)
    m[1, 1] = 1 - 2 * (x * x + z * z)
    m[1, 2] = 2 * (y * z - x * w)
    m[2, 0] = 2 * (x * z - y * w)
    m[2, 1] = 2 * (y * z + x * w)
    m[2, 2] = 1 - 2 * (x * x + y * y)
    return m


class Camera:
    """A yaw/pitch camera: ``view_proj`` maps world to clip space (Y flip
    included) and ``inv_view_proj`` back."""

    def __init__(self, position, yaw: float, pitch: float, fov_y_deg: float, aspect: float):
        self.position = np.asarray(position, F32).copy()
        self.forward = np.ascontiguousarray(_basis(yaw, pitch)[:3, 1])
        view = look_to(self.position, self.forward, np.array([0.0, 0.0, 1.0], F32))
        proj = perspective_reverse_z(fov_y_deg, aspect)
        self.view_proj = (Y_FLIP @ proj @ view).astype(F32)
        inv_fp = np.linalg.inv((Y_FLIP @ proj).astype(np.float64))
        v = view.astype(np.float64)
        inv_v = np.eye(4)
        inv_v[:3, :3] = v[:3, :3].T
        inv_v[:3, 3] = -v[:3, :3].T @ v[:3, 3]
        self.inv_view_proj = (inv_v @ inv_fp).astype(F32)


def sun_view_proj(direction, extent: float, near: float, far: float) -> np.ndarray:
    """Orthographic light camera looking along -direction at the origin
    from the middle of its depth range."""
    d = _unit(np.asarray(direction, F32))
    eye = d * (0.5 * (near + far))
    up = np.array([0, 0, 1], F32)
    if abs(float(np.dot(d, up))) > 0.95:
        up = np.array([0, 1, 0], F32)
    view = look_to(eye, -d, up)
    return (Y_FLIP @ orthographic(extent, near, far) @ view).astype(F32)
