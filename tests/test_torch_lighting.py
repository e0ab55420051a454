"""K2's plain PyTorch version (zenith_tpu_torch.ops.lighting) against the
reference kernel (zenith_tpu.ops.lighting, Pallas in interpret mode on the
CPU) on the same numpy-seeded G-buffers and light tables.

Tolerance: atol 2e-4 / rtol 2e-3, the reference's own tolerance for its
kernel against a dense per-light loop (tests/test_lighting.py): both sides
sum the same terms in the same light order, but XLA fuses and contracts the
float32 arithmetic differently from PyTorch's one-op-at-a-time rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zenith_tpu_torch.ops.lighting as tl
from test_lighting import make_gbuffer
from zenith_tpu.ops.lighting import accumulate_point_lights as jax_lights

torch.set_num_threads(1)
CAM = np.array([0.0, -30.0, 10.0], np.float32)


def _lights(rng, n, lo_r=3.0, hi_r=15.0, far=False):
    pos = (rng.uniform(500, 600, (n, 3)) if far else rng.uniform(-25, 25, (n, 3)))
    return (pos.astype(np.float32), rng.uniform(0.5, 8.0, (n, 3)).astype(np.float32),
            rng.uniform(lo_r, hi_r, (n,)).astype(np.float32))


def _spots(rng, n, every=2):
    params = np.zeros((n, 5), np.float32)
    for i in range(0, n, every):
        d = rng.normal(size=3)
        params[i, :3] = d / np.linalg.norm(d)
        params[i, 3] = np.cos(np.radians(15.0))
        params[i, 4] = np.cos(np.radians(28.0))
    return params


def _both(gbuf, lights, spot=None, tile=(16, 128)):
    am, nr, pe, depth = gbuf
    lp, lc, lr = lights
    args = (am, nr, pe, depth, CAM, lp, lc, lr)
    ref = np.asarray(jax_lights(*map(jnp.asarray, args), tile_h=tile[0], tile_w=tile[1],
                                spot_params=None if spot is None else jnp.asarray(spot)))
    got = tl.accumulate_point_lights(
        *map(torch.from_numpy, args), tile_h=tile[0], tile_w=tile[1],
        spot_params=None if spot is None else torch.from_numpy(spot)).numpy()
    assert got.shape == ref.shape == depth.shape + (3,)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)
    return got, ref


CASES = {
    # name: (G-buffer size, number of lights, spot table, far lights, tile)
    "points": ((64, 256), 12, None, False, (16, 128)),
    "spots": ((64, 256), 8, "half", False, (16, 128)),
    "point-rows-in-spot-table": ((64, 256), 6, "zeros", False, (16, 128)),
    "far-lights-all-culled": ((64, 256), 8, None, True, (16, 128)),
    "ragged-size": ((50, 200), 10, "half", False, (16, 128)),
    "ragged-size-8x128-tiles": ((37, 150), 9, None, False, (8, 128)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_the_reference_kernel(case, monkeypatch):
    import test_lighting

    (h, w), n, spot, far, tile = CASES[case]
    monkeypatch.setattr(test_lighting, "H", h)
    monkeypatch.setattr(test_lighting, "W", w)
    rng = np.random.default_rng(sum(map(ord, case)))
    gbuf = make_gbuffer(rng)
    lights = _lights(rng, n, far=far)
    params = {None: None, "half": _spots(rng, n), "zeros": np.zeros((n, 5), np.float32)}[spot]
    got, ref = _both(gbuf, lights, params, tile)
    if far:
        np.testing.assert_array_equal(got, 0.0)
        hits = tl.tile_light_hits(torch.from_numpy(gbuf[3]), torch.from_numpy(gbuf[2]),
                                  tl.light_table(*map(torch.from_numpy, lights)))
        assert not bool(hits.any())
    else:
        assert got.max() > 0.01  # lights actually landed
    if spot == "zeros":
        # Zero cone rows are point lights: the same bits as the pure table.
        pure = tl.accumulate_point_lights(*map(torch.from_numpy, gbuf + (CAM,) + lights))
        np.testing.assert_array_equal(got, pure.numpy())


def test_zero_lights_return_zeros_without_a_launch():
    am, nr, pe, depth = make_gbuffer(np.random.default_rng(5))
    before = tl.accumulate_point_lights.launches
    empty = np.zeros((0, 3), np.float32)
    args = (am, nr, pe, depth, CAM, empty, empty, np.zeros((0,), np.float32))
    got = tl.accumulate_point_lights(*map(torch.from_numpy, args))
    ref = np.asarray(jax_lights(*map(jnp.asarray, args)))
    assert got.shape == ref.shape == depth.shape + (3,)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert tl.accumulate_point_lights.launches == before


def test_light_table_layout_matches_the_reference_rows():
    """(L, 16) rows: px py pz radius cr cg cb spot dx dy dz cos_outer
    inv_cone pad pad pad (lighting.py:191-219)."""
    rng = np.random.default_rng(8)
    lp, lc, lr = _lights(rng, 5)
    spot = _spots(rng, 5)
    t = tl.light_table(*map(torch.from_numpy, (lp, lc, lr, spot))).numpy()
    np.testing.assert_array_equal(t[:, :3], lp)
    np.testing.assert_array_equal(t[:, 3], lr)
    np.testing.assert_array_equal(t[:, 4:7], lc)
    np.testing.assert_array_equal(t[:, 7], [1, 0, 1, 0, 1])
    np.testing.assert_array_equal(t[:, 8:11], spot[:, :3])
    np.testing.assert_array_equal(t[:, 11], spot[:, 4])
    np.testing.assert_allclose(t[:, 12], 1.0 / np.maximum(spot[:, 3] - spot[:, 4], 1e-4),
                               rtol=1e-6)
    np.testing.assert_array_equal(t[:, 13:], 0.0)


def test_a_cuda_tensor_takes_the_kernel_route_or_raises(monkeypatch):
    """No fallback: where the tensors are on the card the wrapper launches
    K2 or raises (here: no nvcc, so the build raises), whatever the tiles:
    the kernel culls its own KERNEL_CULL regions."""
    am, nr, pe, depth = make_gbuffer(np.random.default_rng(6))
    lp, lc, lr = _lights(np.random.default_rng(7), 3)
    monkeypatch.setattr(tl, "on_cuda", lambda t: True)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tl, "load_kernels", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        tl.accumulate_point_lights(*map(torch.from_numpy, (am, nr, pe, depth, CAM, lp, lc, lr)))
    with pytest.raises(RuntimeError, match="nvcc"):
        tl.accumulate_point_lights(*map(torch.from_numpy, (am, nr, pe, depth, CAM, lp, lc, lr)),
                                   tile_h=32, tile_w=128)


def _surface_gbuffer(rng, h, w):
    """A G-buffer of a gently curved surface seen from above: world
    positions that vary smoothly with the pixel (so a small region's AABB is
    small and the region cull differs from the tile cull), random normals,
    albedo and roughness, and uncovered pixels: a 16x32 hole (whole cull
    regions with no covered pixel) and scattered ones."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    world = np.stack([x * 0.25 - 15.0, y * 0.25 - 8.0, 2.0 * np.sin(x / 17.0) * np.cos(y / 11.0)],
                     -1)
    nrm = rng.normal(size=(h, w, 3)) * 0.3 + [0.0, 0.0, 1.0]
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    am = np.concatenate([rng.uniform(0.1, 1.0, (h, w, 3)), rng.uniform(0, 1, (h, w, 1))], -1)
    nr = np.concatenate([nrm, rng.uniform(0.05, 1.0, (h, w, 1))], -1)
    pe = np.concatenate([world, rng.uniform(0, 1, (h, w, 1))], -1)
    depth = (rng.uniform(0, 1, (h, w)) > 0.1).astype(np.float64) * 0.5
    depth[16:32, 16:48] = 0.0
    return tuple(a.astype(np.float32) for a in (am, nr, pe, depth))


def _hard_spots(rng, n):
    """Spots aimed at the surface, cycling through four cones (inner, outer
    degrees): soft (15, 28); hard-edged (20, 20); inverted (30, 20), which
    the table clamps to the same hard edge; narrow (12, 12.5)."""
    d = rng.normal(size=(n, 3)) * 0.4
    d[:, 2] = -1.0
    cones = np.radians([(15.0, 28.0), (20.0, 20.0), (30.0, 20.0), (12.0, 12.5)])
    return np.concatenate([d / np.linalg.norm(d, axis=1, keepdims=True),
                           np.cos(cones[np.arange(n) % 4])], axis=1).astype(np.float32)


CULL_CASES = {
    # name: (G-buffer size, spot table)
    "points": ((64, 128), None),
    "hard-edged-spots": ((64, 128), "hard"),
    "mixed-point-spot-ragged-size": ((50, 120), "mixed"),
}


@pytest.mark.parametrize("case", list(CULL_CASES))
def test_kernel_cull_regions_match_the_reference_tiles(case):
    """The kernel culls KERNEL_CULL regions, not the reference's 16x128
    tiles: the plain version with the kernel's regions as its tiles matches
    the reference kernel at 16x128 (Pallas, interpret mode), and every
    region's hits are among its tile's."""
    (h, w), spot = CULL_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    am, nr, pe, depth = _surface_gbuffer(rng, h, w)
    n = 12
    lp = np.stack([rng.uniform(-15, 17, n), rng.uniform(-8, 8, n), rng.uniform(1.0, 5.0, n)],
                  -1).astype(np.float32)
    lc = rng.uniform(0.5, 8.0, (n, 3)).astype(np.float32)
    lr = rng.uniform(2.0, 7.0, (n,)).astype(np.float32)
    if spot == "mixed":
        params = np.zeros((n, 5), np.float32)
        params[::2, :3] = (0.0, 0.0, -1.0)
        params[::2, 3], params[::2, 4] = np.cos(np.radians(18.0)), np.cos(np.radians(26.0))
    else:
        params = _hard_spots(rng, n) if spot == "hard" else None
    ref = np.asarray(jax_lights(*map(jnp.asarray, (am, nr, pe, depth, CAM, lp, lc, lr)),
                                tile_h=16, tile_w=128,
                                spot_params=None if params is None else jnp.asarray(params)))
    t = {k: torch.from_numpy(v) for k, v in dict(am=am, nr=nr, pe=pe, depth=depth, cam=CAM,
                                                   lp=lp, lc=lc, lr=lr).items()}
    table = tl.light_table(t["lp"], t["lc"], t["lr"],
                           None if params is None else torch.from_numpy(params))
    sub_h, sub_w = tl.KERNEL_CULL
    got = tl._accumulate_point_lights_torch(t["am"], t["nr"], t["pe"], t["depth"], t["cam"],
                                            table, sub_h, sub_w).numpy()
    assert got.shape == ref.shape == (h, w, 3)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)
    assert got.max() > 0.01
    np.testing.assert_array_equal(got[depth == 0], 0.0)

    tile = tl.tile_light_hits(t["depth"], t["pe"], table, 16, 128)  # (tiles, L)
    sub = tl.tile_light_hits(t["depth"], t["pe"], table, sub_h, sub_w)  # (regions, L)
    sy, sx = np.divmod(np.arange(sub.shape[0]), -(-w // sub_w))
    owner = (sy * sub_h // 16) * -(-w // 128) + (sx * sub_w // 128)
    assert not bool((sub & ~tile[torch.from_numpy(owner)]).any())
    assert int(sub.sum()) < int(tile[torch.from_numpy(owner)].sum())  # the finer cull culls more
    empty = ~(t["depth"] > 0)
    regions_empty = [bool(empty[y:y + sub_h, x:x + sub_w].all())
                     for y in range(0, h, sub_h) for x in range(0, w, sub_w)]
    assert any(regions_empty) and not bool(sub[torch.tensor(regions_empty)].any())
