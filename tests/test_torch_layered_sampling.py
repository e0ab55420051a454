"""The layered, explicit-LOD cube and volume samplers of the port
(``ops.sampling.sample_shadow_pcf_layered``, ``sample_cube_lod``,
``sample_3d``) against the reference's functions on the same numpy-seeded
inputs, compiled with ``jax.jit`` as the reference's frames compile them;
twins of tests/test_texture_types.py::TestVolumeSampling and of
tests/test_csm.py::TestLayeredPCF.

Tolerance: atol 1e-6 throughout. The PCF compares the same texels; its
bilinear weights, like the filtered samplers', round apart where XLA's CPU
backend fuses them into FMAs (measured 6e-8 on 1% of the PCF values).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from zenith_tpu_torch.ops import sampling as ts
from zenith_tpu_torch.renderer.forward import _SHADOW_SAMPLER
from zenith_tpu_torch.rhi.sampler import AddressMode, Filter, SamplerConfig

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jsampler(s: SamplerConfig):
    """The reference's SamplerConfig with the same fields."""
    import dataclasses
    import importlib

    from zenith_tpu.rhi.state import CompareOp

    js = importlib.import_module("zenith_tpu.rhi.sampler")
    enums = {"mag_filter": js.Filter, "min_filter": js.Filter, "mipmap_mode": js.MipmapMode,
             "address_mode_u": js.AddressMode, "address_mode_v": js.AddressMode,
             "address_mode_w": js.AddressMode, "compare_op": CompareOp,
             "border_color": js.BorderColor}
    return js.SamplerConfig(**{
        f.name: enums[f.name][getattr(s, f.name).name] if f.name in enums
        else getattr(s, f.name) for f in dataclasses.fields(s)})


SHADOW = SamplerConfig.shadow_pcf()
BORDER_SHADOW = dataclasses.replace(_SHADOW_SAMPLER, address_mode_u=AddressMode.CLAMP_TO_BORDER,
                                    address_mode_v=AddressMode.CLAMP_TO_BORDER)


@pytest.mark.parametrize("sampler", [SHADOW, BORDER_SHADOW], ids=["clamped", "border"])
@pytest.mark.parametrize("channel", [False, True], ids=["LHW", "LHW1"])
def test_layered_pcf_equals_the_reference(sampler, channel):
    from zenith_tpu.ops.sampling import sample_shadow_pcf_layered

    rng = np.random.default_rng(5)
    layers = rng.uniform(0.2, 0.9, (3, 32, 48)).astype(np.float32)
    if channel:
        layers = layers[..., None]
    layer = rng.integers(-1, 4, (16, 24)).astype(np.int32)  # clamped to [0, L)
    uv = rng.uniform(-0.1, 1.1, (16, 24, 2)).astype(np.float32)
    ref_z = rng.uniform(0.1, 1.0, (16, 24)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, k, u, r: sample_shadow_pcf_layered(
        a, k, u, r, _jsampler(sampler)))(layers, layer, uv, ref_z))
    got = ts.sample_shadow_pcf_layered(_t(layers), _t(layer), _t(uv), _t(ref_z), sampler)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_layered_pcf_matches_single_layer_pcf():
    """Twin of TestLayeredPCF::test_matches_single_layer_pcf: each layer
    selected everywhere equals the single-map PCF of that layer."""
    rng = np.random.default_rng(1234)
    depth = [rng.uniform(0.2, 0.9, (32, 32)).astype(np.float32) for _ in range(2)]
    uv = _t(rng.uniform(0.0, 1.0, (8, 8, 2)).astype(np.float32))
    ref = _t(rng.uniform(0.1, 1.0, (8, 8)).astype(np.float32))
    for k, d in enumerate(depth):
        got = ts.sample_shadow_pcf_layered(_t(np.stack(depth)), torch.full((8, 8), k), uv,
                                           ref, _SHADOW_SAMPLER)
        want = ts.sample_shadow_pcf(_t(d), uv, ref, _SHADOW_SAMPLER)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_layered_pcf_mixed_layer_selection():
    """Twin of TestLayeredPCF::test_mixed_layer_selection."""
    layers = _t(np.stack([np.zeros((16, 16), np.float32), np.ones((16, 16), np.float32)]))
    k = _t(np.repeat(np.array([[0], [1]], np.int32), 8, axis=0).repeat(16, axis=1))
    lit = ts.sample_shadow_pcf_layered(layers, k, torch.full((16, 16, 2), 0.5),
                                       torch.full((16, 16), 0.5), _SHADOW_SAMPLER).numpy()
    assert np.all(lit[:8] == 0.0) and np.all(lit[8:] == 1.0)


@pytest.mark.parametrize("bias", [0.0, 0.75])
def test_cube_lod_equals_the_reference(bias):
    from zenith_tpu.ops.sampling import sample_cube_lod

    rng = np.random.default_rng(9)
    levels = [rng.uniform(0, 2, (6, s, s, 3)).astype(np.float32) for s in (16, 8, 4, 2)]
    dirs = rng.normal(size=(12, 20, 3)).astype(np.float32)
    lod = rng.uniform(-0.5, 4.0, (12, 20)).astype(np.float32)
    sampler = dataclasses.replace(SamplerConfig.linear(), mip_lod_bias=bias)
    want = np.asarray(jax.jit(lambda lv, d, l: sample_cube_lod(lv, d, l, _jsampler(sampler)))(
        levels, dirs, lod))
    got = ts.sample_cube_lod([_t(x) for x in levels], _t(dirs), _t(lod), sampler).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_cube_lod_at_integer_levels_is_the_level():
    rng = np.random.default_rng(2)
    levels = [_t(rng.uniform(0, 1, (6, s, s, 4)).astype(np.float32)) for s in (8, 4)]
    dirs = _t(rng.normal(size=(5, 7, 3)).astype(np.float32))
    for m in (0, 1):
        got = ts.sample_cube_lod(levels, dirs, torch.full((5, 7), float(m)))
        np.testing.assert_array_equal(got.numpy(), ts.sample_cube(levels[m], dirs).numpy())


VOLUME_SAMPLERS = {
    "linear-clamped": SamplerConfig.linear().clamped(),
    "linear-repeat": SamplerConfig.linear(),
    "nearest": SamplerConfig.nearest(),
    "nearest-clamped": SamplerConfig.nearest().clamped(),
}


@pytest.mark.parametrize("name", sorted(VOLUME_SAMPLERS))
def test_sample_3d_equals_the_reference(name):
    from zenith_tpu.ops.sampling import sample_3d

    sampler = VOLUME_SAMPLERS[name]
    rng = np.random.default_rng(13)
    vol = rng.uniform(0, 1, (5, 6, 8, 2)).astype(np.float32)
    uvw = rng.uniform(-0.3, 1.3, (9, 11, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, u: sample_3d(v, u, _jsampler(sampler)))(vol, uvw))
    got = ts.sample_3d(_t(vol), _t(uvw), sampler).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_volume_trilinear_between_slices():
    """Twin of TestVolumeSampling::test_trilinear_between_slices."""
    tex = np.zeros((2, 4, 4, 1), np.float32)
    tex[1] = 1.0
    got = ts.sample_3d(_t(tex), torch.tensor([[0.5, 0.5, 0.5]]),
                       SamplerConfig.linear().clamped())
    np.testing.assert_allclose(got.numpy()[0, 0], 0.5, atol=1e-6)


def test_volume_nearest_slice():
    """Twin of TestVolumeSampling::test_nearest_slice."""
    vol = np.random.default_rng(1234).uniform(0, 1, (4, 4, 8, 2)).astype(np.float32)
    for zi in range(4):
        uvw = torch.tensor([[(3 + 0.5) / 8, (1 + 0.5) / 4, (zi + 0.5) / 4]])
        got = ts.sample_3d(_t(vol), uvw, SamplerConfig.nearest())
        np.testing.assert_allclose(got.numpy()[0], vol[zi, 1, 3], atol=1e-6)
    assert VOLUME_SAMPLERS["nearest"].mag_filter == Filter.NEAREST
