"""Cube, 2D-array and 3D textures in the port (rhi/resource.py descriptors
and uploads, ops/sampling.py's layered, cube and volume samplers): twins of
tests/test_texture_types.py, each case on the port and, where it samples,
the reference's sampler on the same numpy-seeded inputs beside it.

Tolerances: the reference test's own (atol 1e-6 on texels, 1e-5 on the
face colours, 0.05 on the seam arc); port and reference samples atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenith_tpu_torch.ops.sampling import (
    cube_direction_to_face_uv,
    sample_2d_array,
    sample_3d,
    sample_cube,
)
from zenith_tpu_torch.rhi.formats import Format
from zenith_tpu_torch.rhi.resource import Texture, TextureDesc
from zenith_tpu_torch.rhi.sampler import SamplerConfig

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ref_sampler(cfg: SamplerConfig):
    """The reference's SamplerConfig with the same fields."""
    from zenith_tpu.rhi.sampler import AddressMode, Filter, MipmapMode
    from zenith_tpu.rhi.sampler import SamplerConfig as JSampler

    return JSampler(mag_filter=Filter(cfg.mag_filter.value),
                    min_filter=Filter(cfg.min_filter.value),
                    mipmap_mode=MipmapMode(cfg.mipmap_mode.value),
                    address_mode_u=AddressMode(cfg.address_mode_u.value),
                    address_mode_v=AddressMode(cfg.address_mode_v.value),
                    address_mode_w=AddressMode(cfg.address_mode_w.value))


class TestDescsAndUpload:
    def test_3d_desc_shape(self):
        d = TextureDesc.new_3d("vol", 16, 8, 4, Format.RGBA32F)
        assert d.device_shape() == (4, 8, 16, 4)

    def test_cube_desc_shape(self):
        d = TextureDesc.new_cube("sky", 32, Format.RGBA32F)
        assert d.array_layers == 6
        assert d.device_shape() == (6, 32, 32, 4)

    def test_array_desc_shape(self):
        d = TextureDesc.new_2d_array("arr", 16, 8, 5, Format.RGBA32F)
        assert d.device_shape() == (5, 8, 16, 4)

    def test_upload_layers_and_volume(self, rng):
        stack = rng.uniform(0, 1, (5, 8, 16, 4)).astype(np.float32)
        t = Texture.from_numpy_layers("arr", stack, Format.RGBA32F, device=CPU)
        assert tuple(t.array.shape) == (5, 8, 16, 4) and t.array.device == CPU
        np.testing.assert_allclose(t.array.numpy(), stack)

        cube = rng.uniform(0, 1, (6, 8, 8, 4)).astype(np.float32)
        t = Texture.from_numpy_layers("sky", cube, Format.RGBA32F, cube=True, device=CPU)
        assert t.desc.array_layers == 6

        vol = rng.uniform(0, 1, (4, 8, 16, 4)).astype(np.float32)
        t = Texture.from_numpy_3d("vol", vol, Format.RGBA32F, device=CPU)
        assert t.desc.depth == 4
        np.testing.assert_array_equal(t.array.numpy(), vol)


class TestArraySampling:
    def test_nearest_layer_texel(self, rng):
        from zenith_tpu.ops.sampling import sample_2d_array as ref

        tex = rng.uniform(0, 1, (4, 8, 16, 3)).astype(np.float32)
        # The centre of each texel of each layer → exact texels.
        u = (np.arange(16) + 0.5) / 16
        v = (np.arange(8) + 0.5) / 8
        uv = np.stack(np.meshgrid(u, v), axis=-1).astype(np.float32)  # (8, 16, 2)
        for layer in range(4):
            lay = np.full((8, 16), float(layer), np.float32)
            got = sample_2d_array(_t(tex), _t(uv), _t(lay), SamplerConfig.nearest()).numpy()
            np.testing.assert_allclose(got, tex[layer], atol=1e-6)
            want = ref(jnp.asarray(tex), jnp.asarray(uv), jnp.asarray(lay),
                       _ref_sampler(SamplerConfig.nearest()))
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)

    def test_layer_rounds_and_clamps(self, rng):
        tex = rng.uniform(0, 1, (3, 4, 4, 1)).astype(np.float32)
        uv = torch.tensor([[0.5, 0.5]])

        def at(layer):
            return sample_2d_array(_t(tex), uv, torch.tensor([layer]),
                                   SamplerConfig.nearest()).numpy()[0]

        assert np.allclose(at(-2.0), tex[0, 2, 2])
        assert np.allclose(at(9.0), tex[2, 2, 2])
        assert np.allclose(at(1.4), tex[1, 2, 2])

    def test_bilinear_within_layer(self):
        # A 2x2 layer: sampling dead centre averages all four texels.
        tex = np.zeros((2, 2, 2, 1), np.float32)
        tex[1, :, :, 0] = [[0.0, 1.0], [1.0, 0.0]]
        got = sample_2d_array(_t(tex), torch.tensor([[0.5, 0.5]]), torch.tensor([1.0]),
                              SamplerConfig.linear().clamped())
        np.testing.assert_allclose(got.numpy()[0, 0], 0.5, atol=1e-6)


class TestCubeSampling:
    def test_face_selection_axes(self):
        dirs = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                             [0, 0, -1]], dtype=torch.float32)
        face, uv = cube_direction_to_face_uv(dirs)
        np.testing.assert_array_equal(face.numpy(), [0, 1, 2, 3, 4, 5])
        # Axis-aligned directions hit every face dead centre.
        np.testing.assert_allclose(uv.numpy(), 0.5, atol=1e-6)

    def test_face_colors_roundtrip(self):
        s = 8
        tex = np.zeros((6, s, s, 3), np.float32)
        for f in range(6):
            tex[f, :, :, f % 3] = (f // 3) + 1.0  # unique per face
        dirs = np.array([[1, 0.1, -0.2], [-1, 0.2, 0.1], [0.1, 1, 0.2], [-0.2, -1, 0.1],
                         [0.2, 0.1, 1], [0.1, -0.2, -1]], np.float32)
        got = sample_cube(_t(tex), _t(dirs)).numpy()
        for f in range(6):
            expected = np.zeros(3)
            expected[f % 3] = (f // 3) + 1.0
            np.testing.assert_allclose(got[f], expected, atol=1e-5)

    def test_continuity_across_edge(self):
        """A smooth function baked into the cube reads back smoothly across
        a face boundary (no seam beyond filter error), as the reference's
        sampler reads it."""
        from zenith_tpu.ops.sampling import sample_cube as ref

        s = 32
        faces = []
        u = (np.arange(s) + 0.5) / s * 2 - 1
        uu, vv = np.meshgrid(u, u)
        one = np.ones_like(uu)
        for d in ([one, -vv, -uu], [-one, -vv, uu], [uu, one, vv], [uu, -one, -vv],
                  [uu, -vv, one], [-uu, -vv, -one]):
            d = np.stack(d, -1)
            faces.append((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
        tex = np.stack(faces)
        # March a great arc crossing from +X into +Z.
        ts = np.linspace(-0.3, 0.3, 64)
        dirs = np.stack([np.cos(ts + np.pi / 4), np.zeros_like(ts), np.sin(ts + np.pi / 4)],
                        -1).astype(np.float32)
        got = sample_cube(_t(tex), _t(dirs)).numpy()
        assert np.linalg.norm(got - dirs, axis=-1).max() < 0.05
        np.testing.assert_allclose(got, np.asarray(ref(jnp.asarray(tex), jnp.asarray(dirs))),
                                   atol=1e-6)


class TestVolumeSampling:
    def test_trilinear_between_slices(self):
        tex = np.zeros((2, 4, 4, 1), np.float32)
        tex[1] = 1.0
        got = sample_3d(_t(tex), torch.tensor([[0.5, 0.5, 0.5]]),
                        SamplerConfig.linear().clamped())
        np.testing.assert_allclose(got.numpy()[0, 0], 0.5, atol=1e-6)

    def test_nearest_slice(self, rng):
        from zenith_tpu.ops.sampling import sample_3d as ref

        vol = rng.uniform(0, 1, (4, 4, 8, 2)).astype(np.float32)
        for zi in range(4):
            uvw = np.array([[(3 + 0.5) / 8, (1 + 0.5) / 4, (zi + 0.5) / 4]], np.float32)
            got = sample_3d(_t(vol), _t(uvw), SamplerConfig.nearest()).numpy()
            np.testing.assert_allclose(got[0], vol[zi, 1, 3], atol=1e-6)
            want = ref(jnp.asarray(vol), jnp.asarray(uvw), _ref_sampler(SamplerConfig.nearest()))
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
