"""The image-based light in the port (ops/ibl.py, renderer/environment.py
and the deferred renderer's split-sum ambient) against the reference
package: the same numpy-seeded inputs through both (the reflection probe
is test_torch_probe.py's).

Tolerances: the host tables (face directions, solid angles, Hammersley
points, GGX half-vectors, the host SH projection) equal the reference's
(the same NumPy code); the SH projection and evaluation atol 1e-5; the
prefilter's mip 0 equal and mips 1-2 rtol 1e-3 (tests/test_ibl.py:117-120:
the reference's loop body is compiled and XLA contracts its multiply-adds,
the port rounds each product); the env BRDF atol 1e-6; the frames ≤ 1 LSB
with < 1% of values differing (the golden tolerance).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_shadow_frames import CPU, cameras, jax_frame, lsb, port_frame
from zenith_tpu_torch import interop
from zenith_tpu_torch.ops import ibl
from zenith_tpu_torch.ops.sampling import cube_direction_to_face_uv, sample_cube
from zenith_tpu_torch.renderer import DeferredRenderer, EnvironmentLight
from zenith_tpu_torch.rhi import RhiCore

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _cube(rng, size=8):
    return rng.uniform(0.0, 2.0, size=(6, size, size, 4)).astype(np.float32)


def test_host_tables_equal_the_reference():
    from zenith_tpu.ops import ibl as ref

    for size in (4, 16):
        np.testing.assert_array_equal(ibl.cube_face_directions(size),
                                      ref.cube_face_directions(size))
        np.testing.assert_array_equal(ibl.cube_texel_solid_angles(size),
                                      ref.cube_texel_solid_angles(size))
    xi = ibl._hammersley(32)
    np.testing.assert_array_equal(xi, ref._hammersley(32))
    for r in (0.0, 0.5, 1.0):
        np.testing.assert_array_equal(ibl._ggx_importance_dirs(xi, r),
                                      ref._ggx_importance_dirs(xi, r))
    cube = _cube(np.random.default_rng(1))
    np.testing.assert_array_equal(ibl.irradiance_sh9_host(cube), ref.irradiance_sh9_host(cube))
    # The directions round-trip through the port's face selection.
    dirs = torch.from_numpy(ibl.cube_face_directions(8).reshape(-1, 3))
    face, uv = cube_direction_to_face_uv(dirs)
    np.testing.assert_array_equal(face.numpy().reshape(6, 8, 8),
                                  np.broadcast_to(np.arange(6)[:, None, None], (6, 8, 8)))


def test_sh_projection_and_evaluation_match_the_reference(rng):
    from zenith_tpu.ops import ibl as ref

    cube = _cube(rng)
    sh = ibl.irradiance_sh9(torch.from_numpy(cube))
    np.testing.assert_allclose(sh.numpy(), ibl.irradiance_sh9_host(cube), atol=1e-5)
    np.testing.assert_allclose(sh.numpy(), np.asarray(jax.jit(ref.irradiance_sh9)(cube)),
                               atol=1e-5)
    n = rng.normal(size=(40, 24, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    got = ibl.eval_irradiance_sh9(sh, torch.from_numpy(n)).numpy()
    want = np.asarray(jax.jit(ref.eval_irradiance_sh9)(np.asarray(sh), n))
    np.testing.assert_allclose(got, want, atol=1e-5)
    # A constant environment evaluates back to the constant.
    const = np.zeros((6, 16, 16, 4), np.float32)
    const[..., :3] = (0.25, 0.5, 1.0)
    e = ibl.eval_irradiance_sh9(torch.from_numpy(ibl.irradiance_sh9_host(const)),
                                torch.from_numpy(n)).numpy()
    np.testing.assert_allclose(e, np.broadcast_to([0.25, 0.5, 1.0], e.shape), rtol=2e-3)


def test_prefilter_matches_the_reference(rng):
    from zenith_tpu.ops import ibl as ref

    cube = rng.uniform(size=(6, 16, 16, 4)).astype(np.float32)
    mips = ibl.prefilter_ggx(torch.from_numpy(cube), num_mips=3, samples=16)
    want = ref.prefilter_ggx(cube, num_mips=3, samples=16)
    assert [tuple(m.shape) for m in mips] == [(6, 16, 16, 4), (6, 8, 8, 4), (6, 4, 4, 4)]
    np.testing.assert_array_equal(mips[0].numpy(), cube)
    for got, ref_mip in zip(mips[1:], want[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_mip), rtol=1e-3)
    with pytest.raises(ValueError):
        ibl.prefilter_ggx(torch.from_numpy(cube), num_mips=4)


def test_env_brdf_matches_the_reference():
    from zenith_tpu.ops import ibl as ref

    ndv = np.linspace(0.0, 1.0, 33, dtype=np.float32)[:, None]
    r = np.linspace(0.0, 1.0, 17, dtype=np.float32)[None, :]
    ndv, r = np.broadcast_arrays(ndv, r)
    got = ibl.env_brdf_approx(torch.from_numpy(ndv.copy()), torch.from_numpy(r.copy()))
    want = jax.jit(ref.env_brdf_approx)(ndv, r)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_environment_light_from_host_and_device_cubes(rng):
    from zenith_tpu.renderer import EnvironmentLight as JEnv

    pixels = _cube(rng, 16)
    env = EnvironmentLight.from_cube_pixels("e", pixels, num_mips=3, samples=8, intensity=2.0,
                                            device=CPU)
    ref = JEnv.from_cube_pixels("e", pixels, num_mips=3, samples=8, intensity=2.0)
    assert isinstance(env.sh9, np.ndarray) and env.sh9.dtype == np.float32
    np.testing.assert_array_equal(env.sh9, ref.sh9)
    assert env.num_mips == 3 and env.texture.desc.array_layers == 6
    assert env.texture.mips[2].shape == (6, 4, 4, 4)
    np.testing.assert_array_equal(env.texture.host_pixels, ref.texture.host_pixels)
    for got, want in zip(env.texture.mips, ref.texture.mips):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3)
    # A device cube keeps its SH on the device.
    dev_env = EnvironmentLight.from_device_cube("d", torch.from_numpy(pixels), num_mips=2,
                                                samples=8)
    assert isinstance(dev_env.sh9, torch.Tensor)
    np.testing.assert_allclose(dev_env.sh9.numpy(), ibl.irradiance_sh9_host(pixels), atol=1e-5)
    with pytest.raises(ValueError):
        EnvironmentLight.from_device_cube("bad", torch.zeros((5, 8, 8, 4)))
    # from_texture preintegrates a cube texture's host pixels.
    from zenith_tpu_torch.rhi import Format, Texture

    tex = Texture.from_numpy_layers("sky", pixels, Format.RGBA32F, cube=True, device=CPU)
    np.testing.assert_array_equal(EnvironmentLight.from_texture(tex, num_mips=2, samples=4).sh9,
                                  ibl.irradiance_sh9_host(pixels))


def _ibl_scene():
    """test_renderers.py's scene with two point lights, a metal cube and the
    sandbox sky's environment in place of the flat ambient and skybox."""
    from test_renderers import build_test_scene

    from zenith_tpu.renderer import EnvironmentLight as JEnv
    from zenith_tpu.rhi import RhiCore as JCore
    from zenith_tpu.sandbox.scene import sky_cube_pixels

    jscene = build_test_scene(JCore().create_render_device(), num_lights=2)
    cube = jscene.objects[0]
    jscene.objects[0] = dataclasses.replace(cube, metallic=0.8, roughness=0.3)
    jscene.environment = JEnv.from_cube_pixels("sky.env", sky_cube_pixels(16), num_mips=3,
                                               samples=16)
    return jscene


def test_ibl_frame_matches_the_jax_frame():
    from test_renderers import H, W

    jscene = _ibl_scene()
    jcam, cam = cameras(45.0, W / H, (0.0, -60.0, 25.0), 0.0, -0.25)
    ref = jax_frame(jscene, jcam, W, H)
    scene = interop.scene_from(jscene, CPU)
    assert scene.environment is not None and scene.skybox is None
    port = port_frame(scene, cam, W, H, retained_check=True)
    mx, frac = lsb(port, ref)
    assert mx <= 1 and frac < 0.01, (mx, frac)
    # The environment is the background and lights the scene: the frame
    # differs from the flat-ambient one.
    flat = port_frame(dataclasses.replace(scene, environment=None), cam, W, H)
    assert np.abs(flat[..., :3] - port[..., :3]).max() > 0.05
    np.testing.assert_allclose(port[1, 1, :3], sample_cube(
        scene.environment.texture.mips[0], torch.from_numpy(
            _pixel_ray(cam, 1, 1, W, H)))[0, :3].numpy(), atol=1e-5)


def test_environment_is_one_import_and_replaces_the_atmosphere():
    """The environment cube is the lighting's IBL and its sky in one
    imported resource, and no atmosphere dynamic is declared beside it
    (reference deferred.py:1179-1180, 2006-2015)."""
    from zenith_tpu_torch.ops.atmosphere import Atmosphere
    from zenith_tpu_torch.rendergraph import RenderGraphBuilder
    from zenith_tpu_torch.rhi import TextureDesc

    from zenith_tpu_torch.sandbox.scene import golden_scene, sky_cube_pixels

    scene, cam = golden_scene(RhiCore(CPU).create_render_device())
    scene.skybox = None
    scene.environment = EnvironmentLight.from_cube_pixels("sky.env", sky_cube_pixels(16),
                                                          num_mips=2, samples=4, device=CPU)
    scene.atmosphere = Atmosphere()
    builder = RenderGraphBuilder()
    DeferredRenderer(scene).render_to(builder, builder.create(TextureDesc.color("o", 128, 64)),
                                      cam, 128, 64)
    env_imports = [st for st in builder.resources if st.imported is scene.environment.texture]
    assert len(env_imports) == 1
    assert "def.env_sh" in builder.dynamics and "def.atmo" not in builder.dynamics
    assert "def.ambient" not in builder.dynamics


def _pixel_ray(cam, x, y, w, h):
    ndc = np.array([(x + 0.5) / w * 2 - 1, (y + 0.5) / h * 2 - 1, 0.5, 1.0], np.float32)
    p = ndc @ cam.render_inv_view_projection.T
    return (p[:3] / p[3] - cam.location)[None].astype(np.float32)
