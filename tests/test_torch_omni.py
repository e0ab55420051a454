"""Omni (cube) shadow maps in the port (renderer/omni.py, the six
``omni{i}.f{k}`` render-to-layer nodes per shadow-casting point light and
the lighting node's dense term with cube PCF) against the reference
package: twins of tests/test_omni_shadow.py (the face matrices invert the
face selection, the reference z, the blocker's umbra beside the kernel
path) and one frame of that scene at 128×64 against the JAX frame, its
light's radius cut to 55 so that every lit pixel reads the -Z face.

The radius cut keeps the frame off a fault of the reference (ROADMAP §3):
its near clip keeps z ≤ w, the near plane of the reverse-Z camera, which
for the faces' regular [0, 1] z is the far plane, so a caster crossing a
face's plane through the light (the ground, on the four side faces) is
rasterized with w clamped to 1e-5. Those depths are ill-conditioned, and
the two packages' roundings move them apart (measured on the 200-unit
light: faces 0-3 differ on 15-16% of their texels, and 3.5% of the
frame's values by up to 66 LSB); faces 4-5 agree.

Tolerances: the face matrices equal the reference's exactly (the same
NumPy code); the reference's own atol 1e-5 / 0.02 on the geometry and
the unoccluded pixels; the frame ≤ 1 LSB with < 1% of values differing.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_shadow_frames import CPU, cameras, jax_frame, lsb, port_frame
from zenith_tpu_torch import interop
from zenith_tpu_torch.ops.sampling import cube_direction_to_face_uv
from zenith_tpu_torch.renderer.omni import omni_face_matrices, omni_reference_z

torch.set_num_threads(1)


def test_matrices_invert_face_uv_selection():
    """Projecting a point with the matrix of the face that
    cube_direction_to_face_uv selects gives the table's uv and the analytic
    z of its axis distance."""
    from zenith_tpu.renderer.omni import omni_face_matrices as ref_faces

    rng = np.random.default_rng(1234)
    light = np.array([3.0, -2.0, 5.0])
    near, far = 0.3, 60.0
    vps = omni_face_matrices(light, near, far)
    np.testing.assert_array_equal(vps, ref_faces(light, near, far))
    dirs = rng.normal(size=(512, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts = light + dirs * rng.uniform(1.0, 50.0, (512, 1))
    face, uv = cube_direction_to_face_uv(torch.from_numpy(pts - light))
    face, uv = face.numpy(), uv.numpy()
    hom = np.concatenate([pts, np.ones((512, 1))], 1)
    for k in range(6):
        sel = face == k
        assert sel.any()
        clip = hom[sel] @ vps[k].astype(np.float64).T
        ndc = clip[:, :3] / clip[:, 3:4]
        np.testing.assert_allclose(ndc[:, 0] * 0.5 + 0.5, uv[sel][:, 0], atol=1e-5)
        np.testing.assert_allclose(ndc[:, 1] * 0.5 + 0.5, uv[sel][:, 1], atol=1e-5)
        axis_d = np.abs(pts[sel] - light).max(axis=1)
        np.testing.assert_allclose(ndc[:, 2], omni_reference_z(axis_d, near, far), atol=1e-5)
        torch.testing.assert_close(omni_reference_z(torch.from_numpy(axis_d), near, far),
                                   torch.from_numpy(omni_reference_z(axis_d, near, far)))


def test_reference_z_monotonic_in_range():
    z = omni_reference_z(torch.linspace(0.4, 59.0, 64), 0.3, 60.0).numpy()
    assert np.all(np.diff(z) > 0) and z[0] > 0.0 and z[-1] < 1.0


def _jax_scene(cast_shadows, radius=200.0, intensity=4000.0):
    """The reference test's scene: a ground quad, a blocker cube and one
    point light above it, no sun."""
    from zenith_tpu.renderer import PointLight, Scene, SceneObject
    from zenith_tpu.rhi import RhiCore

    device = RhiCore().create_render_device()
    ground = SceneObject.quad(device, "ground", size=120.0, z=0.0,
                              base_color=(0.7, 0.7, 0.7, 1.0))
    blocker = SceneObject.cube(device, "blocker", size=10.0, z0=12.0,
                               base_color=(0.6, 0.3, 0.3, 1.0))
    light = PointLight(position=(0.0, 0.0, 40.0), color=(1.0, 1.0, 1.0), intensity=intensity,
                       radius=radius, cast_shadows=cast_shadows, shadow_map_size=128)
    return Scene(objects=[ground, blocker], sun=None, point_lights=[light],
                 ambient=(0.05, 0.05, 0.05))


def _cams(w, h):
    return cameras(45.0, w / h, (0.0, -90.0, 55.0), 0.0, -math.atan2(50.0, 90.0))


@pytest.fixture(scope="module")
def port_frames():
    _, cam = _cams(256, 128)
    return {cast: port_frame(interop.scene_from(_jax_scene(cast), CPU), cam, 256, 128,
                             retained_check=cast, shadows=False)
            for cast in (False, True)}


def test_blocker_casts_shadow_rest_matches(port_frames):
    """Twin of TestSceneOmni::test_blocker_casts_shadow_rest_matches: an
    umbra under the blocker, and the unoccluded pixels of the dense
    cube-PCF path equal the kernel path's."""
    lit, shadowed = port_frames[False], port_frames[True]
    assert np.isfinite(shadowed).all()
    diff = lit[..., :3].sum(-1) - shadowed[..., :3].sum(-1)
    assert diff.max() > 0.5
    unoccluded = diff < 0.02
    assert unoccluded.mean() > 0.5
    np.testing.assert_allclose(lit[unoccluded], shadowed[unoccluded], atol=0.02)


def test_omni_frame_matches_the_jax_frame():
    from zenith_tpu_torch.renderer import DeferredRenderer

    # Lit ground within 37.7 units of the point under the light, blocker
    # included: all of it inside the -Z face's 45-degree cone.
    jscene = _jax_scene(True, radius=55.0, intensity=2500.0)
    jcam, cam = _cams(128, 64)
    ref = jax_frame(jscene, jcam, 128, 64, shadows=False)
    scene = interop.scene_from(jscene, CPU)
    port = port_frame(scene, cam, 128, 64, shadows=False)
    mx, frac = lsb(port, ref)
    assert mx <= 1 and frac < 0.01, (mx, frac)
    unshadowed = port_frame(interop.scene_from(_jax_scene(False, 55.0, 2500.0), CPU), cam, 128,
                            64, shadows=False)
    assert (unshadowed[..., :3] - port[..., :3]).max() > 0.1  # the umbra is in the frame
    # The shadow-casting light leaves K2's table.
    assert scene.light_partition()[0].shape[0] == 0
    assert "omni0.f5" in _node_names(DeferredRenderer(scene, shadows=False), cam)


def _node_names(renderer, cam):
    from zenith_tpu_torch.rendergraph import RenderGraphBuilder
    from zenith_tpu_torch.rhi import TextureDesc

    builder = RenderGraphBuilder()
    renderer.render_to(builder, builder.create(TextureDesc.color("o", 8, 8)), cam, 8, 8)
    return [n.name for n in builder.nodes]
