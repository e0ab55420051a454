"""The port's core/mathtypes.py against the reference package: twins of
tests/test_math.py's cases on the port's module (a copy of the reference's
NumPy code: angle types, glam-compatible matrices and quaternions, values
derived by hand from glam's semantics, zenith-core/src/math.rs and
camera.rs), and seeded inputs through both packages' functions, their
results equal.
"""

import math

import numpy as np
import pytest

from zenith_tpu_torch.core import mathtypes as m
from zenith_tpu_torch.core.mathtypes import Degree, Radians


class TestAngles:
    def test_conversion_roundtrip(self):
        assert Degree(180.0).to_radians().value == pytest.approx(math.pi)
        assert Radians(math.pi / 2).to_degree().value == pytest.approx(90.0)

    def test_arithmetic_and_clamp(self):
        a = Radians(1.0) + Radians(0.5)
        assert a.value == pytest.approx(1.5)
        assert (a - Radians(2.0)).value == pytest.approx(-0.5)
        assert (-a).value == pytest.approx(-1.5)
        assert (a * 2.0).value == pytest.approx(3.0)
        assert a.clamp(Radians(0.0), Radians(1.0)).value == pytest.approx(1.0)
        assert Degree(50.0).clamp(0.0, 45.0).value == pytest.approx(45.0)

    def test_lerp(self):
        assert Degree(0.0).lerp(Degree(10.0), 0.25).value == pytest.approx(2.5)


class TestPerspective:
    def test_infinite_reverse_rh_depth_mapping(self):
        near = 0.1
        proj = m.perspective_infinite_reverse_rh(Radians(math.pi / 2), 1.0, near)
        # View space looks down -Z (RH): the near plane is z = -near.
        p_near = proj @ np.array([0, 0, -near, 1], dtype=np.float32)
        assert p_near[2] / p_near[3] == pytest.approx(1.0)  # reverse-Z: near → 1
        p_far = proj @ np.array([0, 0, -1e6, 1], dtype=np.float32)
        assert p_far[2] / p_far[3] == pytest.approx(0.0, abs=1e-6)  # ∞ → 0

    def test_fov_scaling(self):
        proj = m.perspective_infinite_reverse_rh(Radians(math.pi / 2), 2.0, 0.1)
        # tan(45°) = 1 ⇒ f = 1; x scaled by 1/aspect.
        assert proj[0, 0] == pytest.approx(0.5)
        assert proj[1, 1] == pytest.approx(1.0)
        assert proj[3, 2] == pytest.approx(-1.0)


class TestLookTo:
    def test_identity_when_looking_down_negative_z(self):
        # Looking along -Z with +Y up from origin is the identity view.
        view = m.look_to_rh(m.vec3(0, 0, 0), m.vec3(0, 0, -1), m.vec3(0, 1, 0))
        np.testing.assert_allclose(view, np.eye(4), atol=1e-6)

    def test_translation(self):
        view = m.look_to_rh(m.vec3(1, 2, 3), m.vec3(0, 0, -1), m.vec3(0, 1, 0))
        p = view @ np.array([1, 2, 3, 1], dtype=np.float32)
        np.testing.assert_allclose(p[:3], 0.0, atol=1e-6)

    def test_zenith_world_basis(self):
        # Z-up world, camera at origin looking along +Y (the reference's
        # default forward): view space must map forward → -Z, right(+X) → +X,
        # up(+Z) → +Y.
        view = m.look_to_rh(m.vec3(0, 0, 0), m.vec3(0, 1, 0), m.vec3(0, 0, 1))
        fwd = view @ np.array([0, 1, 0, 0], dtype=np.float32)
        np.testing.assert_allclose(fwd[:3], [0, 0, -1], atol=1e-6)
        right = view @ np.array([1, 0, 0, 0], dtype=np.float32)
        np.testing.assert_allclose(right[:3], [1, 0, 0], atol=1e-6)
        up = view @ np.array([0, 0, 1, 0], dtype=np.float32)
        np.testing.assert_allclose(up[:3], [0, 1, 0], atol=1e-6)


class TestQuat:
    def test_axis_angle_rotation(self):
        q = m.quat_from_axis_angle(m.vec3(0, 0, 1), math.pi / 2)
        v = m.quat_rotate(q, m.vec3(1, 0, 0))
        np.testing.assert_allclose(v, [0, 1, 0], atol=1e-6)

    def test_euler_zxy_yaw(self):
        # Pure yaw (about Z, zenith's up): forward +Y rotates toward -X.
        q = m.quat_from_euler_zxy(math.pi / 2, 0.0, 0.0)
        v = m.quat_rotate(q, m.vec3(0, 1, 0))
        np.testing.assert_allclose(v, [-1, 0, 0], atol=1e-6)

    def test_euler_zxy_pitch(self):
        # Pure pitch (about X): forward +Y rotates toward +Z (looking up).
        q = m.quat_from_euler_zxy(0.0, math.pi / 2, 0.0)
        v = m.quat_rotate(q, m.vec3(0, 1, 0))
        np.testing.assert_allclose(v, [0, 0, 1], atol=1e-6)

    def test_composition_order(self):
        # ZXY with both yaw and pitch: apply qz * qx to forward.
        yaw, pitch = 0.3, 0.2
        q = m.quat_from_euler_zxy(yaw, pitch, 0.0)
        expected = m.quat_rotate(
            m.quat_from_axis_angle(m.vec3(0, 0, 1), yaw),
            m.quat_rotate(m.quat_from_axis_angle(m.vec3(1, 0, 0), pitch), m.vec3(0, 1, 0)),
        )
        np.testing.assert_allclose(
            m.quat_rotate(q, m.vec3(0, 1, 0)), expected, atol=1e-6
        )


class TestOrtho:
    def test_depth_range(self):
        proj = m.orthographic_rh(-1, 1, -1, 1, 0.0, 10.0)
        p0 = proj @ np.array([0, 0, -0.0, 1], dtype=np.float32)
        assert p0[2] == pytest.approx(0.0)
        # RH [0,1] depth: z = -near → 0, z = -far → 1.
        p1 = proj @ np.array([0, 0, -10.0, 1], dtype=np.float32)
        assert p1[2] == pytest.approx(1.0)


def test_port_functions_equal_the_reference(rng):
    """Seeded inputs through both packages' functions: equal results."""
    from zenith_tpu.core import mathtypes as ref

    for _ in range(20):
        axis = m.normalize(rng.normal(size=3).astype(np.float32))
        angle = float(rng.uniform(-3, 3))
        v = rng.normal(size=3).astype(np.float32)
        eye, fwd, up = (rng.normal(size=3).astype(np.float32) for _ in range(3))
        q = m.quat_from_axis_angle(axis, angle)
        cases = [
            (q, ref.quat_from_axis_angle(axis, angle)),
            (m.quat_rotate(q, v), ref.quat_rotate(q, v)),
            (m.quat_mul(q, q), ref.quat_mul(q, q)),
            (m.quat_from_euler_zxy(angle, 0.5 * angle, -angle),
             ref.quat_from_euler_zxy(angle, 0.5 * angle, -angle)),
            (m.mat4_from_quat(q), ref.mat4_from_quat(q)),
            (m.look_to_rh(eye, fwd, up), ref.look_to_rh(eye, fwd, up)),
            (m.perspective_infinite_reverse_rh(abs(angle) + 0.1, 1.7, 0.1),
             ref.perspective_infinite_reverse_rh(abs(angle) + 0.1, 1.7, 0.1)),
            (m.transform_point(m.mat4_translation(v), eye),
             ref.transform_point(ref.mat4_translation(v), eye)),
            (m.cross3(v, eye), ref.cross3(v, eye)),
        ]
        for got, want in cases:
            np.testing.assert_array_equal(got, want)
