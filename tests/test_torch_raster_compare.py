"""K1's plain PyTorch version against the reference's raster_segmented (the
Pallas kernel in interpret mode) for all eight depth compares, with depth
write on and off, on identical bins.

The scene is numpy-seeded: random triangles over a random seed depth
plane, exact duplicates (equal-z ties, where submission order decides),
near-clipped triangles and a tile with more than one block of entries.

Tolerances: coverage exact; z and attribute planes atol 1e-5. Not 1e-6
for z: XLA's CPU backend contracts the reference kernel's multiply-adds
into FMAs, while the port rounds every product as the NumPy oracle does
(and as K1 on the card does, bit for bit); on edge functions near
cancellation that moves z by up to 4.1e-6 on this scene.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenith_tpu.ops import TileGrid as JGrid, bin_segmented as jbin
from zenith_tpu.ops import raster_segmented as jraster, setup_with_attrs as jsetup
from zenith_tpu.rhi.state import CompareOp as JCompare, CullMode as JCull
from zenith_tpu_torch.interop import bins_from_numpy
from zenith_tpu_torch.ops import TileGrid, raster_segmented
from zenith_tpu_torch.rhi.state import CompareOp

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 32
JGRID = JGrid(W, H, 8, 128)
GRID = TileGrid(W, H, 8, 128)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(2024)
    nt = 170
    nv = 3 * nt
    centers = rng.uniform(-1.0, 1.0, (nt, 1, 2))
    centers[:110] = rng.uniform(-0.95, -0.75, (110, 1, 2))  # > 128 entries in tile 0
    size = np.where(np.arange(nt)[:, None, None] < 110, 0.15, 0.6)
    xy = (centers + rng.uniform(-1, 1, (nt, 3, 2)) * size).reshape(nv, 2)
    z = rng.uniform(0.1, 0.9, (nv, 1))
    w = np.ones((nv, 1))
    z[-9:] = 1.5  # three triangles cross the near plane
    clip = np.concatenate([xy * w, z * w, w], axis=1).astype(np.float32)
    idx = np.arange(nv, dtype=np.int32).reshape(nt, 3)
    idx[1::7] = idx[0::7][: idx[1::7].shape[0]]  # exact duplicates: equal-z ties
    vary = rng.uniform(0, 1, (nv, 1)).astype(np.float32)
    rec, corner = jsetup(jnp.asarray(clip), jnp.asarray(idx), jnp.asarray(vary), W, H,
                         cull_mode=JCull.NONE)
    bins = jax.jit(functools.partial(jbin, grid=JGRID))(rec, corner)
    assert int(np.asarray(bins.blk_count).max()) == 128  # a tile spans blocks
    init = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    init[:, : W // 2] = 0.5  # a plane some fragments tie with exactly
    return bins, init


@pytest.mark.parametrize("depth_write", [True, False], ids=["write", "no-write"])
@pytest.mark.parametrize("op", [op.name for op in CompareOp])
def test_plain_k1_matches_reference_kernel(scene, op, depth_write):
    bins, init = scene
    fn = jax.jit(functools.partial(
        jraster, grid=JGRID, compare_op=JCompare[op], depth_write=depth_write
    ))
    jz, jacc = (np.asarray(a) for a in fn(bins, init_z=jnp.asarray(init)))
    tz, tacc = raster_segmented(
        bins_from_numpy([np.asarray(f) for f in bins], CPU), GRID, torch.from_numpy(init),
        compare_op=CompareOp[op], depth_write=depth_write,
    )
    tz, tacc = tz.numpy(), tacc.numpy()
    np.testing.assert_array_equal(tacc[-1] > 0, jacc[-1] > 0)  # coverage: exact
    np.testing.assert_allclose(tz, jz, atol=1e-5)
    np.testing.assert_allclose(tacc, jacc, atol=1e-5)
