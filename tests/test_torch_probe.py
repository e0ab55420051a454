"""The reflection probe in the port (renderer/probe.py) against the
reference package (tests/test_probe.py): its six face cameras, and a 16²
capture of the same scene in both, carried across by
``interop.scene_from``.

Tolerances: the face cameras equal the reference's; the captured faces
≤ 1 LSB with < 1% of values differing (the golden tolerance), the
prefiltered mips rtol 1e-3 (tests/test_ibl.py:117-120) + atol 1e-4.
"""

import numpy as np
import pytest
import torch

from test_torch_shadow_frames import CPU, lsb
from zenith_tpu_torch import interop
from zenith_tpu_torch.ops.sampling import cube_direction_to_face_uv
from zenith_tpu_torch.rhi import RhiCore

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def test_probe_face_cameras_match_the_reference(rng):
    from zenith_tpu.renderer.probe import _ProbeCamera as JProbeCamera

    from zenith_tpu_torch.renderer.probe import _ProbeCamera

    eye = np.array([2.0, -1.0, 3.0])
    dirs = rng.normal(size=(256, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts = eye + dirs * rng.uniform(1.0, 30.0, (256, 1))
    face, uv = cube_direction_to_face_uv(torch.from_numpy(pts - eye))
    face, uv = face.numpy(), uv.numpy()
    hom = np.concatenate([pts, np.ones((256, 1))], 1)
    for k in range(6):
        cam, ref = _ProbeCamera(k, eye), JProbeCamera(k, eye)
        for name in ("render_view_projection", "render_inv_view_projection", "location",
                     "forward"):
            np.testing.assert_array_equal(getattr(cam, name), getattr(ref, name))
        sel = face == k
        clip = hom[sel] @ cam.render_view_projection.astype(np.float64).T
        assert np.all(clip[:, 3] > 0)
        ndc = clip[:, :2] / clip[:, 3:4]
        np.testing.assert_allclose(ndc[:, 0] * 0.5 + 0.5, uv[sel][:, 0], atol=2e-4)
        np.testing.assert_allclose(ndc[:, 1] * 0.5 + 0.5, uv[sel][:, 1], atol=2e-4)


def test_probe_capture_matches_the_reference():
    """test_probe.py's red wall at +X of the probe, over a ground, captured
    at 16² in both packages: the faces (mip 0) ≤ 1 LSB with < 1% of values
    differing, the prefiltered mips rtol 1e-3 + atol 1e-4 (over the faces'
    own rounding), and no host copy of the port's result. The probe sits
    off the wall's axis: from the axis the wall's diagonal edge runs through
    pixel centres, where the reference's FMA-contracted edge functions
    leave holes the port does not (ROADMAP §3, "FMA")."""
    from zenith_tpu.renderer import Scene as JScene, SceneObject as JObject
    from zenith_tpu.renderer import capture_reflection_probe as jcapture
    from zenith_tpu.rhi import RhiCore as JCore

    from zenith_tpu_torch.renderer import capture_reflection_probe

    jdev = JCore().create_render_device()
    wall = JObject.quad(jdev, "wall", size=60.0, z=0.0, base_color=(0.9, 0.05, 0.05, 1.0),
                        emissive=(2.0, 0.1, 0.1))
    rot = np.array([[0, 0, -1, 0], [0, 1, 0, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float32)
    trans = np.eye(4, dtype=np.float32)
    trans[0, 3] = 25.0
    wall.model_matrix = (trans @ rot).astype(np.float32)
    ground = JObject.quad(jdev, "ground", size=80.0, z=-6.0, base_color=(0.3, 0.5, 0.2, 1.0))
    jscene = JScene(objects=[wall, ground], sun=None, point_lights=[], ambient=(0.6, 0.6, 0.6))
    eye = (0.0, 1.3, 0.7)
    ref = jcapture(jdev, jscene, eye, size=16, num_mips=3, samples=16)
    env = capture_reflection_probe(RhiCore(CPU).create_render_device(),
                                   interop.scene_from(jscene, CPU), eye, size=16,
                                   num_mips=3, samples=16)
    assert isinstance(env.sh9, torch.Tensor) and env.num_mips == 3
    faces = env.texture.mips[0].numpy()
    mx, frac = lsb(faces.reshape(6 * 16, 16, 4), np.asarray(ref.texture.mips[0]).reshape(-1, 16, 4))
    assert mx <= 1 and frac < 0.01, (mx, frac)
    assert faces[0, ..., 0].mean() > 3.0 * faces[0, ..., 2].mean()  # the red wall at +X
    for got, want in zip(env.texture.mips[1:], ref.texture.mips[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(env.sh9.numpy(), np.asarray(ref.sh9), atol=1e-4)
