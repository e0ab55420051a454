"""The port's bin_segmented against the reference's, fed the same records.

Both binners get the reference's TriangleRecords and corner data (through
zenith_tpu_torch.interop), so any difference is the binner's. Tolerance:
exact everywhere — routing tables, block counts, init flags, the gathered
rows (copies of the same floats) and the overflow count.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenith_tpu.ops.binning import TileGrid as JGrid, bin_segmented as jbin
from zenith_tpu.ops.geometry import setup_with_attrs as jsetup
from zenith_tpu.rhi.state import CullMode
from zenith_tpu_torch.interop import records_from_numpy
from zenith_tpu_torch.ops.binning import TileGrid as TGrid, bin_segmented as tbin

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 64
TILE = (8, 32)  # 8 x 4 tiles: span tiers are reachable at test size


@jax.jit
def _reference_records(clip, idx, vary):
    # The reference's setup compiled as one function (both binners read the
    # records it makes).
    return jsetup(clip, idx, vary, W, H, cull_mode=CullMode.NONE)


def _records(clip, idx, nv):
    vary = np.linspace(0.0, 1.0, nv * 2, dtype=np.float32).reshape(nv, 2)
    return _reference_records(jnp.asarray(clip), jnp.asarray(idx), jnp.asarray(vary))


def _random_scene(seed, nt=400):
    rng = np.random.default_rng(seed)
    nv = 3 * nt
    # Mostly small triangles (1-4 tiles), some mid (5-32 tiles), a few that
    # span the whole surface (huge tier). Three quarters are tiny and crowd
    # into one tile, which then holds several blocks of ENTRY_CHUNK entries.
    crowd = 3 * nt // 4
    centers = rng.uniform(-1.0, 1.0, (nt, 1, 2))
    centers[:crowd] = rng.uniform(-1.0, -0.8, (crowd, 1, 2))
    size = rng.choice([0.05, 0.4, 2.5], p=[0.6, 0.3, 0.1], size=(nt, 1, 1))
    size[:crowd] = 0.02
    xy = (centers + rng.uniform(-1, 1, (nt, 3, 2)) * size).reshape(nv, 2)
    z = rng.uniform(0.1, 0.9, (nv, 1))
    clip = np.concatenate([xy, z, np.ones((nv, 1))], axis=1).astype(np.float32)
    idx = np.arange(nv, dtype=np.int32).reshape(nt, 3)
    return clip, idx, nv


def _tied_mid_scene(n=12):
    """n identical mid-span triangles (all the same span): with mid_cap < n
    the tier keeps the lowest-index ones, as jax.lax.top_k does."""
    tri = np.array([[-0.6, -0.6], [0.6, -0.6], [-0.6, 0.6]], np.float32)
    xy = np.tile(tri, (n, 1))
    clip = np.concatenate(
        [xy, np.full((3 * n, 1), 0.5), np.ones((3 * n, 1))], axis=1
    ).astype(np.float32)
    return clip, np.arange(3 * n, dtype=np.int32).reshape(n, 3), 3 * n


def _compare(rec, corner, **kw):
    jg = JGrid(W, H, *TILE)
    tg = TGrid(W, H, *TILE)
    jb = jax.jit(functools.partial(jbin, grid=jg, **kw))(rec, corner)
    trec = records_from_numpy([np.asarray(f) for f in rec], CPU)
    tb = tbin(trec, torch.from_numpy(np.array(corner)), tg, **kw)
    for name in ("blk_tile_y", "blk_tile_x", "blk_count", "blk_init", "rast_pad"):
        np.testing.assert_array_equal(
            getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name
        )
    assert tb.attr_pad.numel() == 0
    assert int(tb.overflow) == int(jb.overflow)
    return jb, tb


@pytest.mark.parametrize(
    "seed, kw",
    [
        (0, {}),
        (1, {"entry_budget": 1}),  # budget overflow: blocks past b_max drop
        (2, {"span_cap": 2, "mid_span": 8, "huge_cap": 3}),  # huge-tier drops
        (3, {"entry_budget": 0, "budget_scale": 2}),
    ],
    ids=["default", "budget-overflow", "huge-cap", "tiny-budget"],
)
def test_bin_segmented_matches_reference(seed, kw):
    clip, idx, nv = _random_scene(seed)
    rec, corner = _records(clip, idx, nv)
    jb, _ = _compare(rec, corner, **kw)
    if kw.get("entry_budget") is not None or "huge_cap" in kw:
        assert int(jb.overflow) > 0  # the case really overflows


def test_tied_spans_past_mid_cap_drop_the_same_records():
    clip, idx, nv = _tied_mid_scene()
    rec, corner = _records(clip, idx, nv)
    jb, tb = _compare(rec, corner, mid_cap=5)
    assert int(tb.overflow) == 7  # 12 tied mid records, 5 kept


def test_empty_draw_initializes_block_zero():
    clip, idx, nv = _random_scene(4, nt=8)
    clip[:, 2] = 2.0  # every vertex beyond the far plane: nothing is valid
    rec, corner = _records(clip, idx, nv)
    _, tb = _compare(rec, corner)
    assert int(tb.blk_count.sum()) == 0 and int(tb.blk_init[0]) == 1
