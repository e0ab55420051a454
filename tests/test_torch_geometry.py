"""The port's triangle setup (zenith_tpu_torch.ops.geometry) against the
reference package's, on the same numpy-seeded inputs.

The reference's near clip (``_clip_payload``) runs under ``jax.jit``, as
inside its compiled frame, where XLA contracts the lerp into a fused
multiply-add, which is how the port's clip rounds it; the rest of the
reference's setup runs op by op, rounding every product as the port does
(ROADMAP §3, "FMA").

Tolerances: masks, flags and ids exact; float columns of the records and
the corner data atol 1e-6 (both sides round the same float32 operations;
the slack covers XLA's CPU fusion of the 1/w and viewport arithmetic).
"""

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenith_tpu.ops import geometry as jgeo
from zenith_tpu.rhi.state import CullMode as JCull, FrontFace as JFront
from zenith_tpu_torch.ops import geometry as tgeo
from zenith_tpu_torch.rhi.state import CullMode as TCull, FrontFace as TFront

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 64


@pytest.fixture(autouse=True)
def _compiled_clip(monkeypatch):
    monkeypatch.setattr(jgeo, "_clip_payload",
                        jax.jit(jgeo._clip_payload, static_argnames=("w_eps", "clamp_z")))


def _scene(seed, nv=48, nt=40, near=True):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 2.0, (nv, 1))
    xy = rng.uniform(-1.3, 1.3, (nv, 2)) * w
    z = rng.uniform(0.02, 0.98, (nv, 1)) * w
    if near:
        # A quarter of the vertices sit behind the near plane (z > w) or
        # behind the eye (w < 0), so setup clips into one or two triangles.
        k = nv // 4
        z[:k] = w[:k] * rng.uniform(1.05, 2.0, (k, 1))
        w[k:k + 3] = -w[k:k + 3]
    clip = np.concatenate([xy, z, w], axis=1).astype(np.float32)
    idx = rng.integers(0, nv, (nt, 3)).astype(np.int32)
    vary = rng.uniform(-1.0, 1.0, (nv, 4)).astype(np.float32)
    return clip, idx, vary


def _both(clip, idx, vary, **kw):
    jkw = dict(kw)
    tkw = dict(kw)
    if "cull_mode" in kw:
        jkw["cull_mode"] = JCull[kw["cull_mode"]]
        tkw["cull_mode"] = TCull[kw["cull_mode"]]
    if "front_face" in kw:
        jkw["front_face"] = JFront[kw["front_face"]]
        tkw["front_face"] = TFront[kw["front_face"]]
    jr, jc = jgeo.setup_with_attrs(jnp.asarray(clip), jnp.asarray(idx), jnp.asarray(vary), W, H, **jkw)
    tr, tc = tgeo.setup_with_attrs(
        torch.from_numpy(clip), torch.from_numpy(idx), torch.from_numpy(vary), W, H, **tkw
    )
    return jr, jc, tr, tc


def _check(jr, jc, tr, tc):
    valid = np.asarray(jr.valid)
    np.testing.assert_array_equal(tr.valid.numpy(), valid)  # exact
    np.testing.assert_array_equal(tr.tri_id.numpy(), np.asarray(jr.tri_id))  # exact
    rast_j = np.asarray(jr.rast16)
    rast_t = tr.rast16.numpy()
    # Top-left flags: exact.
    np.testing.assert_array_equal(rast_t[:, 9:12], rast_j[:, 9:12])
    np.testing.assert_allclose(rast_t, rast_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tr.shade16.numpy(), np.asarray(jr.shade16), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tr.aabb.numpy()[valid], np.asarray(jr.aabb)[valid], rtol=1e-6, atol=1e-6)
    # Corner data (R, 3·(A+2)) — the flat layout kernel K1 reads.
    assert tc.shape == jc.shape
    np.testing.assert_allclose(tc.numpy()[valid], np.asarray(jc)[valid], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_setup_with_attrs_near_clipping_matches_reference(seed):
    clip, idx, vary = _scene(seed)
    jr, jc, tr, tc = _both(clip, idx, vary, cull_mode="NONE")
    _check(jr, jc, tr, tc)
    # The scene really exercises the two-triangle clip case.
    assert np.asarray(jr.valid)[idx.shape[0]:].any()


@pytest.mark.parametrize(
    "kw",
    [
        {"cull_mode": "BACK"},
        {"cull_mode": "FRONT", "front_face": "CLOCKWISE"},
        {"cull_mode": "NONE", "depth_clamp": True},
        {"cull_mode": "NONE", "depth_bias": (4.0, 1.5)},
        {"cull_mode": "NONE", "viewport": (0, 16, W, 2 * H)},
    ],
    ids=["cull-back", "cull-front-cw", "depth-clamp", "depth-bias", "viewport"],
)
def test_setup_with_attrs_state_matches_reference(kw):
    clip, idx, vary = _scene(7)
    jr, jc, tr, tc = _both(clip, idx, vary, **kw)
    _check(jr, jc, tr, tc)


def test_triangle_facing_matches_reference():
    clip, idx, _ = _scene(3, near=False)
    for ff in ("CLOCKWISE", "COUNTER_CLOCKWISE"):
        jf, jd = jgeo.triangle_facing(jnp.asarray(clip), jnp.asarray(idx), JFront[ff])
        tf, td = tgeo.triangle_facing(torch.from_numpy(clip), torch.from_numpy(idx), TFront[ff])
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_transform_vertices_matches_reference():
    rng = np.random.default_rng(5)
    pos = rng.uniform(-2, 2, (33, 3)).astype(np.float32)
    mvp = rng.uniform(-1, 1, (4, 4)).astype(np.float32)
    j = np.asarray(jgeo.transform_vertices(jnp.asarray(pos), jnp.asarray(mvp)))
    t = tgeo.transform_vertices(torch.from_numpy(pos), torch.from_numpy(mvp)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)  # 4-term dot products


def test_lines_and_points_name_their_roadmap_item():
    """Line and point setup (ROADMAP item 19) are ported: two records per
    segment or point (test_torch_lines_points.py holds them to the
    reference)."""
    clip = torch.tensor([[-0.5, -0.5, 0.5, 1.0], [0.5, 0.25, 0.5, 1.0]])
    vary = torch.ones((2, 3))
    rec, corner = tgeo.setup_lines_with_attrs(clip, torch.tensor([[0, 1]]), vary, 64, 32)
    assert rec.rast16.shape == (2, 16) and bool(rec.valid.all())
    assert corner.shape == (2, 3 * (3 + 2))
    rec, corner = tgeo.setup_points_with_attrs(clip, torch.tensor([0, 1]), vary, 64, 32)
    assert rec.rast16.shape == (4, 16) and bool(rec.valid.all())
