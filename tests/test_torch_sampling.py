"""The port's sampling (zenith_tpu_torch.ops.sampling) against the
reference's (zenith_tpu.ops.sampling) on the same numpy-seeded textures,
coordinates and directions.

Tolerances: cube face selection exact and face uv atol 1e-6 (one division
and one multiply-add per coordinate); filtered samples atol 1e-5 (bilinear
weights rounded in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import importlib

import zenith_tpu.ops.sampling as js
import zenith_tpu_torch.ops.sampling as ts
from zenith_tpu.rhi.state import CompareOp as JCompare
from zenith_tpu_torch.rhi.state import CompareOp as TCompare

# (``rhi.sampler`` is also the name of a binding helper in both packages'
# ``rhi`` namespaces, so the modules are fetched by their full names.)
jsam = importlib.import_module("zenith_tpu.rhi.sampler")
tsam = importlib.import_module("zenith_tpu_torch.rhi.sampler")

torch.set_num_threads(1)


def _directions(rng, n=4000):
    d = rng.normal(size=(n, 3))
    # Axis-aligned, edge and corner directions: the face-selection ties.
    special = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                        [1, 1, 0], [1, -1, 0], [0, 1, 1], [0, -1, -1], [1, 0, 1], [-1, 0, -1],
                        [1, 1, 1], [-1, -1, -1], [1, -1, 1], [2, 2, 1]], np.float64)
    return np.concatenate([d, special, special * 1e-3]).astype(np.float32)


def test_cube_direction_to_face_uv():
    d = _directions(np.random.default_rng(1))
    jf, juv = js.cube_direction_to_face_uv(jnp.asarray(d))
    tf, tuv = ts.cube_direction_to_face_uv(torch.from_numpy(d))
    assert tf.dtype == torch.int32
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), atol=1e-6)


@pytest.mark.parametrize("filt", ["LINEAR", "NEAREST"])
def test_sample_cube(filt):
    rng = np.random.default_rng(2)
    tex = rng.uniform(0, 4, (6, 16, 16, 4)).astype(np.float32)
    d = _directions(rng).reshape(42, 96, 3)
    jcfg = jsam.SamplerConfig(mag_filter=jsam.Filter[filt], min_filter=jsam.Filter[filt])
    tcfg = tsam.SamplerConfig(mag_filter=tsam.Filter[filt], min_filter=tsam.Filter[filt])
    ref = np.asarray(js.sample_cube(jnp.asarray(tex), jnp.asarray(d), jcfg))
    got = ts.sample_cube(torch.from_numpy(tex), torch.from_numpy(d), tcfg).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("mode", ["REPEAT", "MIRRORED_REPEAT", "CLAMP_TO_EDGE",
                                  "CLAMP_TO_BORDER"])
@pytest.mark.parametrize("filt", ["LINEAR", "NEAREST"])
def test_sample_2d_array(mode, filt):
    rng = np.random.default_rng(3)
    tex = rng.uniform(0, 1, (3, 8, 12, 4)).astype(np.float32)
    uv = rng.uniform(-1.5, 2.5, (32, 48, 2)).astype(np.float32)
    layer = rng.uniform(-0.7, 2.7, (32, 48)).astype(np.float32)

    def cfg(mod):
        return mod.SamplerConfig(mag_filter=mod.Filter[filt], min_filter=mod.Filter[filt],
                                 address_mode_u=mod.AddressMode[mode],
                                 address_mode_v=mod.AddressMode[mode],
                                 border_color=mod.BorderColor.OPAQUE_WHITE)

    ref = np.asarray(js.sample_2d_array(jnp.asarray(tex), jnp.asarray(uv), jnp.asarray(layer),
                                        cfg(jsam)))
    got = ts.sample_2d_array(torch.from_numpy(tex), torch.from_numpy(uv),
                             torch.from_numpy(layer), cfg(tsam)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("op", ["LESS_OR_EQUAL", "GREATER"])
@pytest.mark.parametrize("mode", ["CLAMP_TO_EDGE", "CLAMP_TO_BORDER"])
def test_sample_shadow_pcf(op, mode):
    rng = np.random.default_rng(4)
    depth = rng.uniform(0, 1, (32, 32)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (24, 40, 2)).astype(np.float32)
    ref_z = rng.uniform(0, 1, (24, 40)).astype(np.float32)

    def cfg(mod, cmp):
        return mod.SamplerConfig(address_mode_u=mod.AddressMode[mode],
                                 address_mode_v=mod.AddressMode[mode],
                                 compare_enable=True, compare_op=cmp[op],
                                 border_color=mod.BorderColor.OPAQUE_WHITE)

    ref = np.asarray(js.sample_shadow_pcf(jnp.asarray(depth), jnp.asarray(uv),
                                          jnp.asarray(ref_z), cfg(jsam, JCompare)))
    got = ts.sample_shadow_pcf(torch.from_numpy(depth), torch.from_numpy(uv),
                               torch.from_numpy(ref_z), cfg(tsam, TCompare)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert 0.0 < got.mean() < 1.0
