"""Variance shadow maps in the port (ops/vsm.py and the lighting node's
soft-shadow branch) against the reference package: twins of
tests/test_vsm.py (the moments, the blur, Chebyshev's penumbra, the soft
cerberus scene), the moments and the visibility against the reference's
functions compiled with ``jax.jit``, and one soft-shadowed frame of
test_renderers.py's scene at 128×64 against the JAX frame.

Tolerances: the moments and visibility at atol 1e-6 (the blur's adds and
divides, the bilinear fetch's weights round apart where XLA fuses them);
the frame ≤ 1 LSB with < 1% of values differing.
"""

import dataclasses
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_shadow_frames import CPU, cameras, jax_frame, lsb, port_frame
from zenith_tpu_torch import interop
from zenith_tpu_torch.ops.vsm import depth_to_moments, sample_vsm

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def test_constant_depth_has_zero_variance_and_full_light():
    m = depth_to_moments(torch.full((32, 32), 0.5), taps=2)
    np.testing.assert_allclose(m[..., 0].numpy(), 0.5, atol=1e-6)
    np.testing.assert_allclose(m[..., 1].numpy(), 0.25, atol=1e-6)
    uv = torch.full((4, 4, 2), 0.5)
    np.testing.assert_allclose(sample_vsm(m, uv, torch.full((4, 4), 0.5)).numpy(), 1.0)
    np.testing.assert_allclose(sample_vsm(m, uv, torch.full((4, 4), 0.9)).numpy(), 0.0,
                               atol=1e-3)


def test_blur_softens_an_edge():
    depth = torch.ones((32, 32))
    depth[:, :16] = 0.3
    ramp = depth_to_moments(depth, taps=3)[16, 12:20, 0].numpy()
    assert np.all(np.diff(ramp) > 0) and ramp[0] < 0.45 and ramp[-1] > 0.85


def test_chebyshev_penumbra_between_zero_and_one():
    depth = torch.ones((64, 64))
    depth[:, :32] = 0.3
    m = depth_to_moments(depth, taps=4)
    us = np.linspace(0.4, 0.6, 33, dtype=np.float32)
    uv = torch.from_numpy(np.stack([us, np.full_like(us, 0.5)], -1))
    lit = sample_vsm(m, uv, torch.full((33,), 0.6)).numpy()
    assert lit.min() < 0.05 and lit.max() > 0.95
    assert ((lit > 0.05) & (lit < 0.95)).sum() >= 3


@pytest.mark.parametrize("taps, channel", [(3, False), (1, True)])
def test_moments_and_visibility_equal_the_reference(taps, channel):
    from zenith_tpu.ops import vsm as ref

    rng = np.random.default_rng(17)
    depth = rng.uniform(0.2, 1.0, (40, 48)).astype(np.float32)
    depth[:, :20] = 0.3
    if channel:
        depth = depth[..., None]
    uv = rng.uniform(-0.1, 1.1, (16, 24, 2)).astype(np.float32)
    ref_z = rng.uniform(0.2, 1.0, (16, 24)).astype(np.float32)
    want_m, want = jax.jit(lambda d, u, r: (lambda m: (m, ref.sample_vsm(m, u, r, 2e-5, 0.3)))(
        ref.depth_to_moments(d, taps=taps)))(depth, uv, ref_z)
    m = depth_to_moments(torch.from_numpy(depth), taps=taps)
    np.testing.assert_allclose(m.numpy(), np.asarray(want_m), rtol=0, atol=1e-6)
    got = sample_vsm(m, torch.from_numpy(uv), torch.from_numpy(ref_z), 2e-5, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_soft_shadow_renders_and_widens_penumbra(monkeypatch):
    """Twin of TestSceneVSM::test_soft_shadow_renders_and_widens_penumbra on
    the port: build_scene's cerberus at 256x128."""
    from zenith_tpu_torch import asset
    from zenith_tpu_torch.rhi import RhiCore
    from zenith_tpu_torch.sandbox.scene import build_scene

    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("ZENITH_CACHE", str(ROOT / "cache"))
    monkeypatch.delenv("ZENITH_CONTENT", raising=False)
    asset.initialize()
    device = RhiCore(CPU).create_render_device()
    _, cam = cameras(35.0, 2.0, (0.0, -170.0, 25.0), 0.0, -math.atan2(20.0, 170.0))

    def render(soft):
        scene = build_scene(device, 0, np.random.default_rng(3), skybox=False)
        if soft:
            scene.sun = dataclasses.replace(scene.sun, soft_shadows=True, vsm_blur=4)
        return port_frame(scene, cam, 256, 128, retained_check=soft)

    hard, soft = render(False), render(True)
    assert np.isfinite(soft).all()
    assert np.mean(np.abs(soft[..., :3] - hard[..., :3])) < 0.05

    def penumbra_count(img):
        lum = img[..., :3].sum(-1)
        lo, hi = np.percentile(lum, [10, 70])
        return ((lum > lo + 0.1 * (hi - lo)) & (lum < hi - 0.3 * (hi - lo))).sum()

    assert penumbra_count(soft) > penumbra_count(hard)


def test_soft_shadowed_frame_matches_the_jax_frame():
    from test_renderers import H, W, build_test_scene

    from zenith_tpu.rhi import RhiCore

    jscene = build_test_scene(RhiCore().create_render_device(), num_lights=2)
    jscene.sun = dataclasses.replace(jscene.sun, soft_shadows=True, vsm_blur=2)
    jcam, cam = cameras(45.0, W / H, (0.0, -60.0, 25.0), 0.0, -0.25)
    ref = jax_frame(jscene, jcam, W, H)
    port = port_frame(interop.scene_from(jscene, CPU), cam, W, H)
    mx, frac = lsb(port, ref)
    assert mx <= 1 and frac < 0.01, (mx, frac)
    hard = port_frame(interop.scene_from(build_test_scene(RhiCore().create_render_device(),
                                                          num_lights=2), CPU), cam, W, H)
    assert np.abs(hard - port).max() > 1e-3  # the soft branch ran
