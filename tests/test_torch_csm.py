"""Cascaded shadow maps in the port (renderer/csm.py, the ``shadow.c{k}``
render-to-layer nodes and the lighting node's cascade selection) against
the reference package: twins of tests/test_csm.py (the split schedule, the
fit, texel snapping, the cascaded cerberus scene with its retained frame),
and one cascaded deferred frame of test_renderers.py's scene (two
cascades, two point lights) at 128×64 against the JAX frame.

Tolerances: the fits equal the reference's exactly (the same NumPy code);
the frame ≤ 1 LSB with < 1% of values differing (the golden tolerance).
"""

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_shadow_frames import CPU, cameras, jax_frame, lsb, port_frame
from zenith_tpu_torch import interop
from zenith_tpu_torch.renderer.csm import (
    _frustum_slice_corners,
    cascade_split_distances,
    fit_cascades,
)
from zenith_tpu_torch.renderer.scene import DirectionalLight

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _camera():
    return cameras(40.0, 2.0, (30.0, -80.0, 20.0), 0.4, -0.15)


def test_splits_monotonic_between_uniform_and_log():
    from zenith_tpu.renderer.csm import cascade_split_distances as ref_splits

    near, far, n = 1.0, 400.0, 4
    s = cascade_split_distances(near, far, n, lam=0.7)
    np.testing.assert_array_equal(s, ref_splits(near, far, n, lam=0.7))
    assert s.shape == (4,) and np.all(np.diff(s) > 0) and abs(s[-1] - far) < 1e-3
    uni = cascade_split_distances(near, far, n, lam=0.0)
    log = cascade_split_distances(near, far, n, lam=1.0)
    assert np.all(s[:-1] <= uni[:-1] + 1e-4) and np.all(s[:-1] >= log[:-1] - 1e-4)
    np.testing.assert_allclose(log, near * (far / near) ** (np.arange(1, 5) / 4), rtol=1e-5)


def test_slice_corners_inside_each_cascade():
    """Every frustum-slice corner lands inside its cascade's NDC box; the
    fit equals the reference's."""
    from zenith_tpu.renderer.csm import fit_cascades as ref_fit
    from zenith_tpu.renderer.scene import DirectionalLight as JLight

    jcam, cam = _camera()
    vps, splits, noffs = fit_cascades(DirectionalLight(cascades=3), cam, 3)
    for got, want in zip((vps, splits, noffs), ref_fit(JLight(cascades=3), jcam, 3)):
        np.testing.assert_array_equal(got, want)
    assert vps.shape == (3, 4, 4) and splits.shape == (3,) and noffs.shape == (3,)
    assert noffs[0] < noffs[1] < noffs[2]
    d0 = 1.0
    for k in range(3):
        corners = _frustum_slice_corners(cam, d0, float(splits[k]))
        clip = np.concatenate([corners, np.ones((8, 1))], axis=1) @ vps[k].astype(np.float64).T
        ndc = clip[:, :3] / clip[:, 3:4]
        assert np.all(np.abs(ndc[:, :2]) <= 1.0 + 1e-3), (k, ndc)
        assert np.all((ndc[:, 2] >= -1e-4) & (ndc[:, 2] <= 1.0 + 1e-4))
        d0 = float(splits[k])


def _texel_phase(vp, p=np.array([5.0, 7.0, 0.0, 1.0]), size=512):
    a = p @ vp.astype(np.float64).T
    return ((a[:2] / a[3] * 0.5 + 0.5) * size) % 1.0


def test_texel_snap_stabilizes_translation():
    sun = DirectionalLight(cascades=2, shadow_map_size=512)
    _, cam = _camera()
    vps0, _, _ = fit_cascades(sun, cam, 2)
    cam.set_position(cam.location + np.float32([0.008, 0.006, 0.0]))
    vps1, _, _ = fit_cascades(sun, cam, 2)
    for k in range(2):
        np.testing.assert_allclose(_texel_phase(vps0[k]), _texel_phase(vps1[k]), atol=1e-3)


def test_fixed_point_texel_phase_invariant_under_camera_motion():
    sun = DirectionalLight(cascades=2, shadow_map_size=512)
    fracs = []
    for step in range(6):
        _, cam = _camera()
        cam.set_position(cam.location + np.float32([2.37, 1.91, 0.0]) * step)
        fracs.append(_texel_phase(fit_cascades(sun, cam, 2)[0][1]))
    for f in fracs[1:]:
        np.testing.assert_allclose(f, fracs[0], atol=2e-3)


@pytest.fixture
def _baked_cerberus(monkeypatch):
    from zenith_tpu_torch import asset

    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("ZENITH_CACHE", str(ROOT / "cache"))
    monkeypatch.delenv("ZENITH_CONTENT", raising=False)
    asset.initialize()


def test_cascaded_scene_shadows_and_retained(_baked_cerberus):
    """Twin of TestSceneCSM::test_cascaded_scene_shadows_and_retained on the
    port: build_scene's cerberus at 256x128 with three cascades; the
    retained re-run reproduces the frame, the image agrees with the single
    map overall, and the cascades darken pixels against no shadows."""
    from zenith_tpu_torch.rhi import RhiCore
    from zenith_tpu_torch.sandbox.scene import build_scene

    device = RhiCore(CPU).create_render_device()
    _, cam = cameras(35.0, 2.0, (0.0, -170.0, 25.0), 0.0, -math.atan2(20.0, 170.0))

    def render(cascades, shadows=True, retained_check=False):
        scene = build_scene(device, 0, np.random.default_rng(3), skybox=False)
        scene.sun = dataclasses.replace(scene.sun, cascades=cascades)
        return port_frame(scene, cam, 256, 128, retained_check=retained_check,
                          shadows=shadows)

    img3 = render(3, retained_check=True)
    assert np.isfinite(img3).all()
    img1 = render(1)
    assert np.mean(np.abs(img3[..., :3] - img1[..., :3])) < 0.05
    img_ns = render(1, shadows=False)
    assert ((img_ns[..., :3] - img3[..., :3]) > 0.05).any()


def test_cascaded_frame_matches_the_jax_frame():
    from test_renderers import H, W, build_test_scene

    from zenith_tpu.rhi import RhiCore

    jscene = build_test_scene(RhiCore().create_render_device(), num_lights=2)
    jscene.sun = dataclasses.replace(jscene.sun, cascades=2)
    jcam, cam = cameras(45.0, W / H, (0.0, -60.0, 25.0), 0.0, -0.25)
    ref = jax_frame(jscene, jcam, W, H)
    port = port_frame(interop.scene_from(jscene, CPU), cam, W, H, retained_check=True)
    mx, frac = lsb(port, ref)
    assert mx <= 1 and frac < 0.01, (mx, frac)
    # The cascades shadow the ground: the frame differs from the unshadowed one.
    unshadowed = port_frame(interop.scene_from(jscene, CPU), cam, W, H, shadows=False)
    assert (unshadowed[..., :3] - port[..., :3]).max() > 0.05
