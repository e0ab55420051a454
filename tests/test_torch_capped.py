"""The port's capped-bin raster path — setup_triangles → bin_triangles →
visibility_pass / raster_interp_pass → resolve_varyings / finalize_attrs —
against the NumPy oracle (the cases of tests/test_raster.py) and against the
reference package, at 128x32 with 8x128 tiles, on numpy-seeded inputs. On
CPU tensors the two passes run their plain PyTorch versions (the kernels K7
and K8 run on the card, in chip_smoke.py).

Tolerances: coverage, record slots, counts, overflow, masks and ids exact;
against the oracle z atol 1e-5 (one triangle) / 1e-4 (random scenes) and
varyings atol 2e-3 / 1e-4, the reference's own (test_raster.py). Against
the reference package: records, corner data and binned rows atol 1e-6 (as
tests/test_torch_geometry.py); z and attribute planes of the passes atol
1e-5 (XLA's CPU backend contracts the Pallas kernels' multiply-adds into
FMAs, the port rounds every product, as tests/test_torch_raster_compare.py
explains). The setup parity tests run the reference's near clip under
``jax.jit``, as inside its compiled frame, where XLA contracts its lerp
into a fused multiply-add, which is how the port's clip rounds it; the rest
of the reference's setup runs op by op, rounding every product as the port
does (ROADMAP §3, "FMA").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_reference import render_reference
from zenith_tpu.ops import TileGrid as JGrid
from zenith_tpu.ops import bin_triangles as jbin, corner_attributes as jcorner
from zenith_tpu.ops import clip_near_w as jclip, setup_triangles as jsetup
from zenith_tpu.ops import geometry as jgeo
from zenith_tpu.ops import raster_interp_pass as jinterp, visibility_pass as jvis
from zenith_tpu.rhi.state import CompareOp as JCompare, CullMode as JCull
from zenith_tpu_torch.interop import tile_bins_from_numpy
from zenith_tpu_torch.ops import (
    TileGrid,
    bin_segmented,
    bin_triangles,
    clip_near_w,
    corner_attributes,
    finalize_attrs,
    raster_interp_pass,
    raster_segmented,
    resolve_varyings,
    setup_triangles,
    setup_with_attrs,
    visibility_pass,
)
from zenith_tpu_torch.rhi.state import CompareOp, CullMode, FrontFace

torch.set_num_threads(1)
W, H = 128, 32
GRID = TileGrid(W, H, 8, 128)
JGRID = JGrid(W, H, 8, 128)


def ndc_tri(verts2d, z=0.5, w=1.0):
    """Clip coords from NDC xy pairs at constant depth and w."""
    return np.array([[x * w, y * w, z * w, w] for x, y in verts2d], np.float32)


def records_of(clip, idx, cull=CullMode.NONE, front=FrontFace.COUNTER_CLOCKWISE):
    return setup_triangles(torch.from_numpy(np.asarray(clip, np.float32)),
                           torch.from_numpy(np.asarray(idx, np.int32)), W, H,
                           cull_mode=cull, front_face=front)


def run_raster(clip, idx, cull=CullMode.NONE, front=FrontFace.COUNTER_CLOCKWISE,
               compare=CompareOp.GREATER, depth_test=True, depth_write=True, depth_clear=0.0,
               capacity=64):
    """The visibility path → (z, original triangle id, slot, records)."""
    records = records_of(clip, idx, cull, front)
    bins = bin_triangles(records, GRID, capacity)
    z, slot = visibility_pass(
        bins, GRID, torch.full((H, W), depth_clear), torch.full((H, W), -1, dtype=torch.int32),
        depth_test=depth_test, depth_write=depth_write, compare_op=compare,
    )
    tri = torch.where(slot >= 0, records.tri_id[slot.clamp(min=0).long()], -1)
    return z.numpy(), tri.numpy(), slot, records


def run_interp(clip, idx, vary, compare=CompareOp.GREATER, capacity=64):
    """The forward-interpolating path → (z, {name: (H, W, C)}, mask)."""
    records = records_of(clip, idx)
    flat = torch.from_numpy(np.concatenate(list(vary.values()), axis=1))
    corner = corner_attributes(records, torch.from_numpy(np.asarray(idx, np.int32)), flat)
    bins = bin_triangles(records, GRID, capacity)
    z, acc = raster_interp_pass(bins, bins.gather_corner_data(corner), GRID,
                                torch.zeros((H, W)), compare_op=compare)
    layout = [(k, v.shape[1]) for k, v in vary.items()] + [("__front", 1)]
    out, mask, _ = finalize_attrs(z, acc, layout)
    return z.numpy(), {k: v.numpy() for k, v in out.items()}, mask.numpy()


def random_clip(rng, nv, w_range=(0.8, 3.0)):
    pos = rng.uniform(-1.1, 1.1, size=(nv, 2))
    zz = rng.uniform(0.1, 0.9, size=(nv, 1))
    ww = rng.uniform(*w_range, size=(nv, 1))
    return np.concatenate([pos * ww, zz * ww, ww], axis=1).astype(np.float32)


PX, PY = 2.0 / W, 2.0 / H
QUAD_IDX = np.array([[0, 1, 2], [0, 2, 3]])
COVERAGE = {
    "single-triangle": (ndc_tri([(0.0, -0.8), (0.7, 0.7), (-0.7, 0.7)]), np.array([[0, 1, 2]]),
                        CompareOp.GREATER),
    # Quad split along a diagonal: every covered pixel owned exactly once.
    "shared-edge": (ndc_tri([(-0.8, -0.8), (0.8, -0.8), (0.8, 0.8), (-0.8, 0.8)]), QUAD_IDX,
                    CompareOp.ALWAYS),
    # Edges exactly through pixel centres: the top-left rule decides.
    "top-left-rule": (ndc_tri([(-1 + 8.5 * PX, -1 + 4.5 * PY), (-1 + 40.5 * PX, -1 + 4.5 * PY),
                               (-1 + 40.5 * PX, -1 + 20.5 * PY), (-1 + 8.5 * PX, -1 + 20.5 * PY)]),
                      QUAD_IDX, CompareOp.ALWAYS),
}


@pytest.mark.parametrize("case", list(COVERAGE))
def test_coverage_matches_oracle(case):
    clip, idx, compare = COVERAGE[case]
    z, tri, _, _ = run_raster(clip, idx, compare=compare)
    ref = render_reference(clip, idx, W, H, cull="none", compare=compare.name.lower())
    np.testing.assert_array_equal(tri, ref["tri"])
    covered = tri >= 0
    if case == "single-triangle":
        np.testing.assert_allclose(z, ref["z"], atol=1e-5)
        assert covered.sum() > 50
    else:  # the union is a solid rectangle: no gap and no double ownership
        ys, xs = np.where(covered)
        solid = np.zeros_like(covered)
        solid[ys.min():ys.max() + 1, xs.min():xs.max() + 1] = True
        np.testing.assert_array_equal(covered, solid)


NEAR = ndc_tri([(0.0, -0.5), (0.5, 0.5), (-0.5, 0.5)], z=0.8)
FAR = ndc_tri([(0.0, -0.6), (0.6, 0.6), (-0.6, 0.6)], z=0.2)
TWO = np.array([[0, 1, 2], [3, 4, 5]])


@pytest.mark.parametrize("case", ["near-last", "near-first", "equal-z-later-wins",
                                  "write-off", "test-off"])
def test_depth(case):
    kw = {}
    if case == "near-last":
        clip, centre = np.concatenate([FAR, NEAR]), 1
    elif case == "near-first":
        clip, centre = np.concatenate([NEAR, FAR]), 0
    elif case == "equal-z-later-wins":
        clip, centre = np.concatenate([NEAR, NEAR]), 1
        kw = dict(compare=CompareOp.GREATER_OR_EQUAL)
    elif case == "write-off":
        # Write off: the far triangle still passes against the clear 0 and,
        # drawn last, owns the pixel; z is never written.
        clip, centre = np.concatenate([NEAR, FAR]), 1
        kw = dict(depth_write=False)
    else:
        clip, centre = NEAR, 0
        kw = dict(depth_test=False, depth_clear=0.25)
    idx = TWO[:clip.shape[0] // 3]
    z, tri, _, _ = run_raster(clip, idx, **kw)
    assert tri[H // 2, W // 2] == centre
    if case in ("near-last", "near-first", "write-off"):
        ref = render_reference(clip, idx, W, H, cull="none",
                               depth_write=kw.get("depth_write", True))
        np.testing.assert_array_equal(tri, ref["tri"])
    if case == "write-off":
        np.testing.assert_array_equal(z, np.zeros_like(z))
    if case == "test-off":
        assert (tri >= 0).any()
        np.testing.assert_allclose(z, 0.25)


CW = ndc_tri([(0.0, 0.5), (-0.5, -0.5), (0.5, -0.5)])  # det > 0: back-facing under CCW


@pytest.mark.parametrize("cull, front, drawn", [
    (CullMode.BACK, FrontFace.COUNTER_CLOCKWISE, False),
    (CullMode.BACK, FrontFace.CLOCKWISE, True),
    (CullMode.FRONT, FrontFace.CLOCKWISE, False),
], ids=["back-culled", "back-is-front", "front-culled"])
def test_culling(cull, front, drawn):
    _, tri, _, _ = run_raster(CW, np.array([[0, 1, 2]]), cull=cull, front=front)
    assert (tri >= 0).any() == drawn


def test_many_random_triangles_match_oracle(rng):
    nv = 60
    clip = np.concatenate([rng.uniform(-1.2, 1.2, size=(nv, 2)),
                           rng.uniform(0.05, 0.95, size=(nv, 1)), np.ones((nv, 1))],
                          axis=1).astype(np.float32)
    idx = rng.integers(0, nv, size=(40, 3)).astype(np.int32)
    z, tri, _, _ = run_raster(clip, idx)
    ref = render_reference(clip, idx, W, H, cull="none")
    np.testing.assert_array_equal(tri, ref["tri"])
    np.testing.assert_allclose(z, ref["z"], atol=1e-4)


def test_capacity_independence_and_overflow(rng):
    nv = 30
    clip = np.concatenate([rng.uniform(-1, 1, size=(nv, 2)), np.full((nv, 1), 0.5),
                           np.ones((nv, 1))], axis=1).astype(np.float32)
    idx = rng.integers(0, nv, size=(16, 3)).astype(np.int32)
    z1, tri1, _, _ = run_raster(clip, idx, capacity=32)
    z2, tri2, _, _ = run_raster(clip, idx, capacity=256)
    np.testing.assert_array_equal(tri1, tri2)
    np.testing.assert_array_equal(z1, z2)
    # 20 coincident full-screen triangles at capacity 8: 12 dropped per tile.
    full = np.concatenate([ndc_tri([(-2, -2), (4, -2), (-2, 4)])] * 20)
    bins = bin_triangles(records_of(full, np.arange(60).reshape(20, 3)), GRID, 8)
    assert int(bins.overflow) == 12 * GRID.num_tiles
    assert bins.counts.tolist() == [8] * GRID.num_tiles


def test_clip_near_w_cases():
    # One vertex behind the eye: the visible part survives with sane depth.
    clip = np.array([[0.0, -0.5, 0.5, 1.0], [0.5, 0.5, 0.5, 1.0], [0.0, 0.0, -0.5, -1.0]],
                    np.float32)
    z, tri, _, _ = run_raster(clip, np.array([[0, 1, 2]]))
    assert (tri >= 0).any()
    zc = z[tri >= 0]
    assert np.isfinite(zc).all() and (zc >= 0).all() and (zc <= 1).all()
    eye = torch.eye(3)[None]
    # Fully inside: unchanged, one record.
    corners = torch.from_numpy(ndc_tri([(0.0, -0.5), (0.5, 0.5), (-0.5, 0.5)]))[None]
    out_c, out_b, valid = clip_near_w(corners, eye)
    assert valid.tolist() == [True, False]
    np.testing.assert_allclose(out_c[0].numpy(), corners[0].numpy(), atol=1e-6)
    np.testing.assert_array_equal(out_b[0].numpy(), eye[0].numpy())
    # Fully behind: dropped.
    behind = torch.tensor([[[0, 0, 0, -1.0], [1, 0, 0, -1.0], [0, 1, 0, -1.0]]])
    assert clip_near_w(behind, eye)[2].tolist() == [False, False]


def test_clip_near_w_matches_the_reference(rng):
    """One or two corners beyond the near plane: the clipped corners and
    their original-triangle barycentrics."""
    t = 24
    w = rng.uniform(0.5, 2.0, (t, 3, 1))
    z = rng.uniform(0.1, 0.9, (t, 3, 1)) * w
    z[:8, 0] = w[:8, 0] * 1.5
    z[8:16, :2] = w[8:16, :2] * 1.7
    corners = np.concatenate([rng.uniform(-1, 1, (t, 3, 2)) * w, z, w], -1).astype(np.float32)
    obary = np.broadcast_to(np.eye(3, dtype=np.float32), (t, 3, 3))
    jc, jb, jv = (np.asarray(a) for a in jax.jit(jclip)(jnp.asarray(corners), jnp.asarray(obary)))
    tc, tb, tv = clip_near_w(torch.from_numpy(corners), torch.from_numpy(obary.copy()))
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert jv[t:].sum() == 8  # the two-corners-inside case makes a second triangle
    np.testing.assert_allclose(tc.numpy()[jv], jc[jv], atol=1e-6)
    np.testing.assert_allclose(tb.numpy()[jv], jb[jv], atol=1e-6)


def test_forward_interp_matches_oracle(rng):
    nv = 24
    clip = random_clip(rng, nv)
    idx = rng.integers(0, nv, size=(12, 3)).astype(np.int32)
    vary = {"c": rng.uniform(0, 1, size=(nv, 3)).astype(np.float32)}
    z, out, mask = run_interp(clip, idx, vary)
    ref = render_reference(clip, idx, W, H, cull="none", varyings=vary)
    np.testing.assert_array_equal(mask, ref["tri"] >= 0)
    np.testing.assert_allclose(z, ref["z"], atol=1e-4)
    np.testing.assert_allclose(out["c"][mask], ref["c"][mask], atol=2e-3)
    # Depth occlusion through the planes: the near (green) triangle wins.
    vary = {"c": np.array([[1, 0, 0]] * 3 + [[0, 1, 0]] * 3, np.float32)}
    _, out, _ = run_interp(np.concatenate([FAR, NEAR]), TWO, vary)
    np.testing.assert_allclose(out["c"][H // 2, W // 2], [0, 1, 0], atol=1e-5)


def test_resolve_varyings_is_perspective_correct():
    # A floor quad receding in depth: w differs per vertex.
    clip = np.array([[-0.9, 0.9, 0.5, 1.0], [0.9, 0.9, 0.5, 1.0], [3.6, -3.6, 2.0, 4.0],
                     [-3.6, -3.6, 2.0, 4.0]], np.float32)
    vary = {"t": np.array([[0.0], [0.0], [1.0], [1.0]], np.float32)}
    _, _, slot, records = run_raster(clip, QUAD_IDX)
    out, mask, builtins = resolve_varyings(
        slot, records.rast16, records.shade16, records.tri_id,
        torch.from_numpy(QUAD_IDX.astype(np.int32)),
        {k: torch.from_numpy(v) for k, v in vary.items()})
    ref = render_reference(clip, QUAD_IDX, W, H, cull="none", varyings=vary)
    m = mask.numpy()
    np.testing.assert_array_equal(m, ref["tri"] >= 0)
    np.testing.assert_allclose(out["t"].numpy()[m], ref["t"][m], atol=1e-4)
    np.testing.assert_allclose(builtins.depth.numpy()[m], ref["z"][m], atol=1e-5)
    # At the screen-space midpoint the value leans to the near end
    # (analytically 0.2), well below the affine 0.5.
    rows = np.where(m[:, W // 2])[0]
    assert out["t"].numpy()[rows[len(rows) // 2], W // 2, 0] < 0.45


def near_scene(seed, nv=40, nt=25):
    """test_raster.py's fused-setup scene: some vertices beyond the depth
    range, one behind the near plane."""
    rng = np.random.default_rng(seed)
    ww = rng.uniform(0.5, 3.0, size=(nv, 1))
    clip = np.concatenate([rng.uniform(-1.3, 1.3, size=(nv, 2)) * ww,
                           rng.uniform(-0.2, 1.1, size=(nv, 1)) * ww, ww],
                          axis=1).astype(np.float32)
    clip[0] = [0.1, 0.1, 2.0, 1.0]  # z > w: clipped
    idx = rng.integers(0, nv, size=(nt, 3)).astype(np.int32)
    idx[:4, 0] = 0
    vary = rng.uniform(0, 1, size=(nv, 5)).astype(np.float32)
    return clip, idx, vary


def test_setup_with_attrs_equals_setup_triangles_with_corner_attributes():
    clip, idx, vary = near_scene(1234)
    t_clip, t_idx, t_vary = (torch.from_numpy(a) for a in (clip, idx, vary))
    rec_old = setup_triangles(t_clip, t_idx, W, H, cull_mode=CullMode.NONE)
    corner_old = corner_attributes(rec_old, t_idx, t_vary)
    rec_new, corner_new = setup_with_attrs(t_clip, t_idx, t_vary, W, H, cull_mode=CullMode.NONE)
    v = rec_new.valid.numpy()
    np.testing.assert_array_equal(rec_old.valid.numpy(), v)
    assert v[idx.shape[0]:].any()  # a clipped triangle split in two
    # The same rounded setup arithmetic: the raster records are equal.
    np.testing.assert_array_equal(rec_old.rast16.numpy(), rec_new.rast16.numpy())
    np.testing.assert_allclose(corner_old.numpy()[v], corner_new.numpy()[v], atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("cull, near_clip", [("NONE", True), ("BACK", True), ("NONE", False)],
                         ids=["clip", "cull-back", "no-near-clip"])
def test_setup_and_binning_match_the_reference(cull, near_clip, monkeypatch):
    monkeypatch.setattr(jgeo, "clip_near_w", jax.jit(jclip, static_argnames="w_eps"))
    clip, idx, vary = near_scene(7, nv=60, nt=48)
    jr = jsetup(jnp.asarray(clip), jnp.asarray(idx), W, H, cull_mode=JCull[cull],
                near_clip=near_clip)
    tr = setup_triangles(torch.from_numpy(clip), torch.from_numpy(idx), W, H,
                         cull_mode=CullMode[cull], near_clip=near_clip)
    valid = np.asarray(jr.valid)
    np.testing.assert_array_equal(tr.valid.numpy(), valid)
    np.testing.assert_array_equal(tr.tri_id.numpy(), np.asarray(jr.tri_id))
    np.testing.assert_array_equal(tr.rast16.numpy()[:, 9:12], np.asarray(jr.rast16)[:, 9:12])
    np.testing.assert_allclose(tr.rast16.numpy(), np.asarray(jr.rast16), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tr.shade16.numpy()[valid], np.asarray(jr.shade16)[valid],
                               rtol=1e-6, atol=1e-6)
    jc = np.array(jcorner(jr, jnp.asarray(idx), jnp.asarray(vary)))
    tc = corner_attributes(tr, torch.from_numpy(idx), torch.from_numpy(vary)).numpy()
    assert tc.shape == jc.shape
    np.testing.assert_allclose(tc[valid], jc[valid], rtol=1e-6, atol=1e-6)
    for k in (8, 64):  # overflowing and not
        jb = jbin(jr, JGRID, k)
        tb = bin_triangles(tr, GRID, k)
        np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
        np.testing.assert_array_equal(tb.binned_slot.numpy(), np.asarray(jb.binned_slot))
        assert int(tb.overflow) == int(jb.overflow)
        np.testing.assert_allclose(tb.binned_rast.numpy(), np.asarray(jb.binned_rast),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tb.gather_corner_data(torch.from_numpy(jc)).numpy(),
                                   np.asarray(jb.gather_corner_data(jnp.asarray(jc))))
    assert int(jb.overflow) == 0 and int(jbin(jr, JGRID, 8).overflow) > 0


@pytest.fixture(scope="module")
def pass_scene():
    """The reference's records, corner data and bins of a numpy-seeded scene:
    random triangles over a random seed plane, exact duplicates submitted
    later (equal-z ties) and near-clipped triangles."""
    rng = np.random.default_rng(2024)
    nt = 40
    nv = 3 * nt
    xy = (rng.uniform(-1, 1, (nt, 1, 2)) + rng.uniform(-1, 1, (nt, 3, 2)) * 0.5).reshape(nv, 2)
    z = rng.uniform(0.1, 0.9, (nv, 1))
    w = rng.uniform(0.7, 2.0, (nv, 1))
    z[-6] = z[-3] = z[-2] = 1.5  # beyond the near plane: one and two corners clipped
    clip = np.concatenate([xy * w, z * w, w], axis=1).astype(np.float32)
    idx = np.arange(nv, dtype=np.int32).reshape(nt, 3)
    idx[1::7] = idx[0::7][: idx[1::7].shape[0]]
    vary = rng.uniform(0, 1, (nv, 1)).astype(np.float32)

    @jax.jit
    def reference(clip, idx, vary):
        # Setup, binning and corner data compiled as one function (both
        # packages' passes read what it makes).
        rec = jsetup(clip, idx, W, H, cull_mode=JCull.NONE)
        bins = jbin(rec, JGRID, 32)
        return rec.valid, bins, bins.gather_corner_data(jcorner(rec, idx, vary))

    valid, bins, attr = reference(jnp.asarray(clip), jnp.asarray(idx), jnp.asarray(vary))
    assert int(np.asarray(valid)[nt:].sum()) == 1  # the one-corner case made a second record
    assert int(bins.overflow) == 0 and int(np.asarray(bins.counts).max()) > 16
    init = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    init[:, : W // 2] = 0.5  # a plane some fragments tie with exactly
    return bins, np.array(attr), init


@pytest.mark.parametrize("op, depth_write",
                         [(op.name, i % 2 == 0) for i, op in enumerate(CompareOp)],
                         ids=[f"{op.name}-{'write' if i % 2 == 0 else 'no-write'}"
                              for i, op in enumerate(CompareOp)])
def test_plain_passes_match_the_reference_kernels(pass_scene, op, depth_write):
    """visibility_pass and raster_interp_pass (plain versions) against the
    Pallas kernels in interpret mode, on the reference's bins."""
    bins, attr, init = pass_scene
    init_s = np.full((H, W), -1, np.int32)

    def reference(b, a, z0, s0):
        kw = dict(compare_op=JCompare[op], depth_write=depth_write)
        return jvis(b, JGRID, z0, s0, **kw), jinterp(b, a, JGRID, z0, **kw)

    (jz, js), (jz2, jacc) = jax.tree_util.tree_map(np.asarray, jax.jit(reference)(
        bins, jnp.asarray(attr), jnp.asarray(init), jnp.asarray(init_s)))
    tbins = tile_bins_from_numpy([np.asarray(f) for f in bins], "cpu")
    tkw = dict(compare_op=CompareOp[op], depth_write=depth_write)
    tz, ts = visibility_pass(tbins, GRID, torch.from_numpy(init), torch.from_numpy(init_s), **tkw)
    tz2, tacc = raster_interp_pass(tbins, torch.from_numpy(attr), GRID, torch.from_numpy(init),
                                   **tkw)
    np.testing.assert_array_equal(ts.numpy(), js)  # slots: exact
    np.testing.assert_array_equal(tacc.numpy()[-1] > 0, jacc[-1] > 0)  # coverage: exact
    np.testing.assert_array_equal(tacc.numpy()[-1] > 0, js >= 0)
    np.testing.assert_allclose(tz.numpy(), jz, atol=1e-5)
    np.testing.assert_allclose(tz2.numpy(), jz2, atol=1e-5)
    np.testing.assert_allclose(tacc.numpy(), jacc, atol=1e-5)
    if op not in ("NEVER", "EQUAL"):  # nothing lies exactly on the seed plane
        assert (js >= 0).sum() > 100


def test_plain_interp_equals_plain_segmented_raster(rng):
    """Three-way agreement inside the port: the plain K8 over capped bins is
    the plain K1 over segmented bins of the same records, bit for bit, and
    the plain K7's z and coverage are K8's."""
    nv = 90
    clip = random_clip(rng, nv, (0.7, 2.0))
    clip[:6, 2] = clip[:6, 3] * 1.4  # near-clipped corners
    idx = rng.integers(0, nv, size=(60, 3)).astype(np.int32)
    idx[30:40] = idx[:10]  # duplicates: equal-z ties
    vary = rng.uniform(-1, 1, (nv, 4)).astype(np.float32)
    records = records_of(clip, idx)
    corner = corner_attributes(records, torch.from_numpy(idx), torch.from_numpy(vary))
    cbins = bin_triangles(records, GRID, 64)
    sbins = bin_segmented(records, corner, GRID)
    assert int(cbins.overflow) == 0 and int(sbins.overflow) == 0
    init = torch.from_numpy(rng.uniform(0, 1, (H, W)).astype(np.float32))
    for compare in (CompareOp.GREATER, CompareOp.LESS_OR_EQUAL):
        z8, acc8 = raster_interp_pass(cbins, cbins.gather_corner_data(corner), GRID, init,
                                      compare_op=compare)
        z1, acc1 = raster_segmented(sbins, GRID, init, compare_op=compare)
        z7, slot = visibility_pass(cbins, GRID, init, torch.full((H, W), -1, dtype=torch.int32),
                                   compare_op=compare)
        assert torch.equal(z8, z1) and torch.equal(acc8, acc1)
        assert torch.equal(z7, z8) and torch.equal(slot >= 0, acc8[-1] > 0)
        assert int((slot >= 0).sum()) > 500


def test_cpu_tensors_take_the_plain_versions_and_capacity_is_checked():
    records = records_of(NEAR, np.array([[0, 1, 2]]))
    corner = corner_attributes(records, torch.tensor([[0, 1, 2]]), torch.ones((3, 2)))
    before = (visibility_pass.launches, raster_interp_pass.launches)
    bins = bin_triangles(records, GRID, 8)
    init_z, init_s = torch.zeros((H, W)), torch.full((H, W), -1, dtype=torch.int32)
    _, slot = visibility_pass(bins, GRID, init_z, init_s)
    raster_interp_pass(bins, bins.gather_corner_data(corner), GRID, init_z)
    assert (slot >= 0).any()
    assert (visibility_pass.launches, raster_interp_pass.launches) == before
    odd = bin_triangles(records, GRID, 12)
    with pytest.raises(ValueError, match="multiple of 8"):
        visibility_pass(odd, GRID, init_z, init_s)
    with pytest.raises(ValueError, match="multiple of 8"):
        raster_interp_pass(odd, odd.gather_corner_data(corner), GRID, init_z)
