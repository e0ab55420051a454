"""The port's texture atlas and its single-level, trilinear and anisotropic
sampling against the reference package's, on numpy-seeded textures and UV
images.

Tolerances: the atlas sheet, its mips and its UV transforms equal (both
packages pack on the host with numpy); samples atol 1e-6 (the same float32
taps and weights; XLA may contract the bilinear blend into FMAs).
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenith_tpu.ops import sampling as jsampling
from zenith_tpu.rhi import atlas as jatlas
from zenith_tpu.rhi.formats import Format as JFormat
from zenith_tpu.rhi.resource import Texture as JTexture
from zenith_tpu_torch.ops import sampling as tsampling
from zenith_tpu_torch.rhi import atlas as tatlas
from zenith_tpu_torch.rhi.formats import Format as TFormat
from zenith_tpu_torch.rhi.resource import Texture as TTexture

torch.set_num_threads(1)
# (rhi.sampler the module, not the binding declaration rhi exports as `sampler`.)
jsampler = importlib.import_module("zenith_tpu.rhi.sampler")
tsampler = importlib.import_module("zenith_tpu_torch.rhi.sampler")


def _textures(seed, sizes):
    rng = np.random.default_rng(seed)
    pix = [None if s is None else rng.uniform(0, 1, (*s, 4)).astype(np.float32) for s in sizes]
    j = [None if p is None else JTexture.from_numpy(f"t{k}", p, JFormat.RGBA32F)
         for k, p in enumerate(pix)]
    t = [None if p is None else TTexture.from_numpy(f"t{k}", p, TFormat.RGBA32F, device="cpu")
         for k, p in enumerate(pix)]
    return j, t


@pytest.mark.parametrize("sizes, kw", [
    ([(64, 64), (64, 64)], {}),
    ([(20, 33), None, (7, 5), (32, 32), None], {}),
    ([(16, 16), (9, 30), None], dict(gutter=4, mip_levels=3)),
    ([None], dict(fallback=(0.5, 0.5, 1.0, 1.0), mip_levels=1)),
], ids=["two-full-cells", "mixed-with-fallbacks", "gutter-and-levels", "fallback-only"])
def test_build_atlas_matches_the_reference(sizes, kw):
    jt, tt = _textures(3, sizes)
    ja = jatlas.build_atlas("atlas", jt, **kw)
    # With no texture to take the device from, the port must be told it.
    tkw = kw if any(t is not None for t in tt) else dict(kw, device="cpu")
    ta = tatlas.build_atlas("atlas", tt, **tkw)
    np.testing.assert_array_equal(ta.transforms, ja.transforms)
    assert ta.texture.desc.mip_levels == ja.texture.desc.mip_levels
    assert (ta.texture.desc.width, ta.texture.desc.height) == \
        (ja.texture.desc.width, ja.texture.desc.height)
    np.testing.assert_array_equal(ta.texture.array.numpy(), np.asarray(ja.texture.array))
    jm, tm = ja.texture.mips or [ja.texture.array], ta.texture.mips or [ta.texture.array]
    assert len(jm) == len(tm)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_build_atlas_takes_the_device_of_its_first_texture():
    _, tt = _textures(4, [None, (8, 8)])
    assert tatlas.build_atlas("a", tt).texture.array.device == tt[1].array.device
    assert tatlas.build_atlas("a", tt, device="meta").texture.array.device.type == "meta"
    with pytest.raises(ValueError, match="no device"):
        tatlas.build_atlas("a", [None, None])


def _sampler(mod, name, address="REPEAT"):
    cfg = getattr(mod.SamplerConfig, name)()
    return dataclasses.replace(cfg, address_mode_u=mod.AddressMode[address],
                               address_mode_v=mod.AddressMode[address])


@pytest.mark.parametrize("address", ["REPEAT", "MIRRORED_REPEAT", "CLAMP_TO_EDGE",
                                     "CLAMP_TO_BORDER"])
@pytest.mark.parametrize("filt", ["linear", "nearest"])
def test_sample_2d_matches_the_reference(filt, address):
    rng = np.random.default_rng(9)
    tex = rng.uniform(0, 1, (13, 21, 4)).astype(np.float32)
    uv = rng.uniform(-0.7, 1.7, (37, 29, 2)).astype(np.float32)
    j = jsampling.sample_2d(jnp.asarray(tex), jnp.asarray(uv), _sampler(jsampler, filt, address))
    t = tsampling.sample_2d(torch.from_numpy(tex), torch.from_numpy(uv),
                            _sampler(tsampler, filt, address))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


@pytest.mark.parametrize("sampler", ["linear", "nearest"])
def test_sample_texture_over_an_atlas_matches_the_reference(sampler):
    """What the peeled glass shader does: a dense UV image through a cell's
    transform, sampled from the mipped atlas with the screen-space LOD
    (trilinear, or nearest-mip), and from its level 0 alone."""
    jt, tt = _textures(5, [(64, 64), None, (40, 24)])
    ja, ta = jatlas.build_atlas("a", jt), tatlas.build_atlas("a", tt)
    assert ta.texture.mips is not None and len(ta.texture.mips) > 1
    h, w = 48, 96
    ys, xs = np.mgrid[0:h, 0:w]
    # A perspective-like UV ramp: the footprint grows down the image, so
    # the LOD crosses several levels.
    u = (xs / w) ** 1.5
    v = (ys / h) * (0.3 + 2.5 * xs / w)
    uv = np.stack([u, np.clip(v, 0, 1)], -1).astype(np.float32)
    for cell in (0, 2):
        uvx = ja.transforms[cell]
        auv = np.stack([uvx[2] + uv[..., 0] * uvx[0], uvx[3] + uv[..., 1] * uvx[1]], -1)
        jout = jsampling.sample_texture(tuple(ja.texture.mips), jnp.asarray(auv),
                                        _sampler(jsampler, sampler, "CLAMP_TO_EDGE"))
        tout = tsampling.sample_texture(tuple(ta.texture.mips), torch.from_numpy(auv),
                                        _sampler(tsampler, sampler, "CLAMP_TO_EDGE"))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-6)
        lod = tsampling.screen_space_lod(torch.from_numpy(auv), ta.texture.desc.width,
                                         ta.texture.desc.height)
        assert float(lod.max()) > 1.5 and float(lod.min()) < 0.5  # several levels
        j0 = jsampling.sample_texture(ja.texture.mips[0], jnp.asarray(auv))
        t0 = tsampling.sample_texture(ta.texture.mips[0], torch.from_numpy(auv))
        np.testing.assert_allclose(t0.numpy(), np.asarray(j0), atol=1e-6)


def test_anisotropic_sampling_over_an_atlas_matches_the_reference():
    """An anisotropic sampler takes the multi-probe path (sample_2d_aniso)
    over a mipped atlas cell, as in the reference; atol 1e-5 (a sum of
    trilinear probes, each within 1e-6)."""
    jt, tt = _textures(6, [(64, 64), (32, 48)])
    ja, ta = jatlas.build_atlas("a", jt), tatlas.build_atlas("a", tt)
    ys, xs = np.mgrid[0:40, 0:64]
    uv = np.stack([(xs / 64) ** 1.5, np.clip((ys / 40) * (0.3 + 2.5 * xs / 64), 0, 1)], -1)
    uvx = ja.transforms[1]
    auv = np.stack([uvx[2] + uv[..., 0] * uvx[0], uvx[3] + uv[..., 1] * uvx[1]],
                   -1).astype(np.float32)
    for cap in (4.0, 16.0):
        j = jsampling.sample_texture(tuple(ja.texture.mips), jnp.asarray(auv),
                                     jsampler.SamplerConfig.anisotropic(cap))
        t = tsampling.sample_texture(tuple(ta.texture.mips), torch.from_numpy(auv),
                                     tsampler.SamplerConfig.anisotropic(cap))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
        tri = tsampling.sample_texture(tuple(ta.texture.mips), torch.from_numpy(auv))
        assert not torch.equal(t, tri)  # the probes, not trilinear
