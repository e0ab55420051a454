"""Angle newtypes and 3D math helpers.

Mirrors the reference's math module (zenith-core/src/math.rs:6-69 — Degree /
Radians newtypes with clamp/lerp and mutual conversion) plus the subset of
glam matrix/quaternion math the reference camera relies on
(zenith-core/src/camera.rs:50,120,125):

- ``perspective_infinite_reverse_rh`` — infinite far plane, reverse-Z (depth
  1.0 at the near plane, 0.0 at infinity), Vulkan/DX clip-space depth [0, 1].
- ``look_to_rh`` — right-handed view matrix from eye position + direction.
- ``quat_from_euler_zxy`` — intrinsic Z→X→Y euler (yaw, pitch, roll-free).

All matrices are row-major numpy ``float32`` arrays applied to column
vectors: ``clip = M @ v``; compose as ``proj @ view``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def _lerp(a: float, b: float, s: float) -> float:
    return a + (b - a) * s


@dataclass(frozen=True, slots=True)
class Radians:
    """An angle in radians (reference zenith-core/src/math.rs:40-69)."""

    value: float = 0.0

    def to_degree(self) -> "Degree":
        return Degree(math.degrees(self.value))

    def clamp(self, lo: "Radians | float", hi: "Radians | float") -> "Radians":
        lo = lo.value if isinstance(lo, Radians) else lo
        hi = hi.value if isinstance(hi, Radians) else hi
        return Radians(min(max(self.value, lo), hi))

    def lerp(self, other: "Radians", s: float) -> "Radians":
        return Radians(_lerp(self.value, other.value, s))

    def __add__(self, other: "Radians") -> "Radians":
        return Radians(self.value + other.value)

    def __sub__(self, other: "Radians") -> "Radians":
        return Radians(self.value - other.value)

    def __neg__(self) -> "Radians":
        return Radians(-self.value)

    def __mul__(self, s: float) -> "Radians":
        return Radians(self.value * s)

    __rmul__ = __mul__

    def __float__(self) -> float:
        return float(self.value)


@dataclass(frozen=True, slots=True)
class Degree:
    """An angle in degrees (reference zenith-core/src/math.rs:6-38)."""

    value: float = 0.0

    def to_radians(self) -> Radians:
        return Radians(math.radians(self.value))

    def clamp(self, lo: "Degree | float", hi: "Degree | float") -> "Degree":
        lo = lo.value if isinstance(lo, Degree) else lo
        hi = hi.value if isinstance(hi, Degree) else hi
        return Degree(min(max(self.value, lo), hi))

    def lerp(self, other: "Degree", s: float) -> "Degree":
        return Degree(_lerp(self.value, other.value, s))

    def __add__(self, other: "Degree") -> "Degree":
        return Degree(self.value + other.value)

    def __sub__(self, other: "Degree") -> "Degree":
        return Degree(self.value - other.value)

    def __neg__(self) -> "Degree":
        return Degree(-self.value)

    def __mul__(self, s: float) -> "Degree":
        return Degree(self.value * s)

    __rmul__ = __mul__

    def __float__(self) -> float:
        return float(self.value)


def as_radians(angle: "Radians | Degree | float") -> float:
    """Coerce an angle-like value to a plain float in radians."""
    if isinstance(angle, Degree):
        return angle.to_radians().value
    if isinstance(angle, Radians):
        return angle.value
    return float(angle)


# ---------------------------------------------------------------------------
# Vectors
# ---------------------------------------------------------------------------


def vec3(x: float, y: float, z: float) -> np.ndarray:
    return np.array([x, y, z], dtype=np.float32)


def normalize(v: np.ndarray) -> np.ndarray:
    # math.sqrt(dot) instead of np.linalg.norm: norm's generic machinery
    # costs ~8 µs per call and this runs several times per frame in the
    # camera path.
    n = math.sqrt(float(np.dot(v, v)))
    return v / n if n > 0 else v


def cross3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """3-vector cross product, inlined — np.cross's generic moveaxis path
    costs ~25 µs per call, which dominated the per-frame camera math."""
    return np.array(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ],
        dtype=np.float32,
    )


# ---------------------------------------------------------------------------
# Quaternions — (x, y, z, w) layout
# ---------------------------------------------------------------------------

QUAT_IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)


def quat_from_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    half = 0.5 * angle
    s = math.sin(half)
    a = normalize(np.asarray(axis, dtype=np.float32))
    return np.array([a[0] * s, a[1] * s, a[2] * s, math.cos(half)], dtype=np.float32)


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dtype=np.float32,
    )


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector v by quaternion q (q * v * q^-1)."""
    qv = np.asarray(q[:3], dtype=np.float32)
    w = float(q[3])
    t = 2.0 * cross3(qv, v)
    return (v + w * t + cross3(qv, t)).astype(np.float32)


def quat_from_euler_zxy(z: float, x: float, y: float) -> np.ndarray:
    """Intrinsic Z→X→Y euler angles to quaternion (glam EulerRot::ZXY).

    The reference camera uses this with (yaw, pitch, 0) to eliminate roll
    (zenith-core/src/camera.rs:120).

    The y == 0 fast path is the closed-form qz·qx product (the camera's
    per-frame case — four trig calls, no intermediate quats):

    >>> a = quat_from_euler_zxy(0.7, -0.3, 0.0)
    >>> qz = quat_from_axis_angle(vec3(0, 0, 1), 0.7)
    >>> qx = quat_from_axis_angle(vec3(1, 0, 0), -0.3)
    >>> qy = quat_from_axis_angle(vec3(0, 1, 0), 0.0)
    >>> bool(np.allclose(a, quat_mul(quat_mul(qz, qx), qy)))
    True
    """
    if y == 0.0:
        hz, hx = 0.5 * z, 0.5 * x
        cz, sz = math.cos(hz), math.sin(hz)
        cx, sx = math.cos(hx), math.sin(hx)
        return np.array(
            [cz * sx, sz * sx, sz * cx, cz * cx], dtype=np.float32
        )
    qz = quat_from_axis_angle(vec3(0, 0, 1), z)
    qx = quat_from_axis_angle(vec3(1, 0, 0), x)
    qy = quat_from_axis_angle(vec3(0, 1, 0), y)
    return quat_mul(quat_mul(qz, qx), qy)


# ---------------------------------------------------------------------------
# Matrices — row-major (4, 4) float32, column-vector convention
# ---------------------------------------------------------------------------


def mat4_identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


# The standard Vulkan clip-space correction: glam/GL-style projections put
# +Y up in clip space, Vulkan NDC puts +Y down. Engines bake this flip into
# the projection (the reference's only shipped demo bypasses the camera, so
# it never had to). Note the flip mirrors screen-space winding: pipelines
# using flipped matrices keep glTF's COUNTER_CLOCKWISE front faces.
VULKAN_Y_FLIP = np.diag([1.0, -1.0, 1.0, 1.0]).astype(np.float32)


def perspective_infinite_reverse_rh(
    fov_y: "Radians | Degree | float", aspect_ratio: float, z_near: float
) -> np.ndarray:
    """Infinite-far reverse-Z RH perspective (glam semantics).

    Maps view-space z = -z_near → NDC depth 1.0 and z = -inf → 0.0; clip
    space depth range [0, 1] (Vulkan). Used by the reference camera
    (zenith-core/src/camera.rs:50,60).
    """
    f = 1.0 / math.tan(0.5 * as_radians(fov_y))
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect_ratio
    m[1, 1] = f
    m[2, 3] = z_near
    m[3, 2] = -1.0
    return m


def look_to_rh(eye: np.ndarray, direction: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Right-handed view matrix looking along ``direction`` from ``eye``
    (glam Mat4::look_to_rh; reference zenith-core/src/camera.rs:125)."""
    f = normalize(np.asarray(direction, dtype=np.float32))
    s = normalize(cross3(f, np.asarray(up, dtype=np.float32)))
    u = cross3(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -float(np.dot(eye, s))
    m[1, 3] = -float(np.dot(eye, u))
    m[2, 3] = float(np.dot(eye, f))
    return m


def orthographic_rh(
    left: float, right: float, bottom: float, top: float, near: float, far: float
) -> np.ndarray:
    """RH orthographic projection with [0, 1] clip-space depth (glam
    Mat4::orthographic_rh). Used by shadow-map passes."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -1.0 / (far - near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -near / (far - near)
    return m


def mat4_from_quat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = (float(c) for c in q)
    m = np.eye(4, dtype=np.float32)
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


def mat4_translation(t: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def mat4_scale(s: "np.ndarray | float") -> np.ndarray:
    s = np.asarray(s, dtype=np.float32)
    if s.ndim == 0:
        s = np.array([s, s, s], dtype=np.float32)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def transform_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    v = m @ np.append(np.asarray(p, dtype=np.float32), np.float32(1.0))
    return (v[:3] / v[3]).astype(np.float32)
