"""The port's lines, points and polygon modes against the reference's.

The cases of tests/test_lines_points.py hold the port's ``draw_indexed`` to
the reference's own checks, one by one. ``test_frames_match_reference``
draws seeded sets of segments, strips, sized points and wireframe and point
-mode triangles through both packages (the reference compiled with
``jax.jit``, as a frame is; its Pallas raster in interpret mode) and holds
the frames together; the record tests hold ``setup_lines_with_attrs`` and
``setup_points_with_attrs`` to the reference's.

Tolerances: coverage (which pixels a draw wrote) exact; colours and depth
atol 1e-5 (XLA's CPU backend contracts the reference's multiply-adds into
FMAs, the port rounds each product: test_torch_raster_compare.py); records
bit-equal against the reference run op by op, and atol 1e-5 + rtol 1e-5
against its compiled form where segments are near-clipped (the port rounds
the clip's lerp as the FMA, the rest op by op).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zenith_tpu.ops.draw as jdraw
import zenith_tpu.ops.geometry as jgeo
import zenith_tpu_torch.ops.draw as tdraw
import zenith_tpu_torch.ops.geometry as tgeo
from zenith_tpu.ops import TileGrid as JGrid
from zenith_tpu.rhi import pipeline as jpipe, shader as jshader, state as jstate
from zenith_tpu.rhi.formats import Format as JFormat
from zenith_tpu_torch.ops import TileGrid as TGrid
from zenith_tpu_torch.rhi import pipeline as tpipe, shader as tshader, state as tstate
from zenith_tpu_torch.rhi.formats import Format as TFormat

torch.set_num_threads(1)
W, H = 128, 32
JG = JGrid(width=W, height=H, tile_h=8, tile_w=128)
TG = TGrid(width=W, height=H, tile_h=8, tile_w=128)


def _ndc_x(sx):
    return 2.0 * sx / W - 1.0


def _ndc_y(sy):
    return 2.0 * sy / H - 1.0


def _vert(sx, sy, z=0.5, w=1.0, rgba=(1, 1, 1, 1)):
    return [_ndc_x(sx) * w, _ndc_y(sy) * w, z * w, w, *rgba]


def _vs(attrs, res):
    return {"position": attrs["position"], "color": attrs["color"]}


def _vs_pointsize(attrs, res):
    return {"position": attrs["position"], "color": attrs["color"],
            "point_size": attrs["color"][:, 3:4] * 0.0 + 3.0}


def _fs(varyings, res, builtins):
    return varyings["color"]


def _pipeline(pm, sm, st, fmt, topology="LINE_LIST", polygon_mode="FILL", line_width=1.0,
              cull="NONE", point_size_vs=False, restart=False):
    return pm.GraphicPipeline(pm.GraphicPipelineDesc(
        shader_input=pm.GraphicShaderInput(
            sm.Shader.vertex("lp.vs", _vs_pointsize if point_size_vs else _vs),
            sm.Shader.fragment("lp.fs", _fs),
            st.VertexLayout.from_fields(("position", 4), ("color", 4)),
        ),
        state=st.GraphicPipelineState(
            input_assembly=st.InputAssemblyState(
                topology=st.PrimitiveTopology[topology], primitive_restart=restart),
            rasterization=st.RasterizationState(
                cull_mode=st.CullMode[cull], polygon_mode=st.PolygonMode[polygon_mode],
                line_width=line_width),
            depth_stencil=st.DepthStencilDesc().reverse_z(),
        ),
        attachments=st.GraphicPipelineAttachments(
            color_formats=(fmt.RGBA32F,), depth_format=fmt.D32F),
        color_attachment_descs=(st.ColorAttachmentDesc(clear_value=(0, 0, 0, 0)),),
    ))


def _render(verts, indices, entry_budget=None, **kw):
    """The port's frame → (image (H, W, 4), depth (H, W)) as numpy."""
    tp = _pipeline(tpipe, tshader, tstate, TFormat, **kw)
    tc, tz, _ = tdraw.draw_indexed(
        [torch.zeros((H, W, 4))], torch.zeros((H, W)), tp,
        torch.tensor(np.asarray(verts, np.float32)), torch.tensor(indices, dtype=torch.int32),
        {}, TG, entry_budget=entry_budget)
    return tc[0].numpy(), tz.numpy()


def _seeded_vertices(seed, n, near_clipped=0):
    """``n`` clip-space vertices over and around the surface, the first
    ``near_clipped`` of them behind the near plane (z > w)."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.7, 1.6, (n, 1))
    xy = rng.uniform(-1.15, 1.15, (n, 2)) * w
    z = rng.uniform(0.05, 0.95, (n, 1)) * w
    z[:near_clipped] = 1.3 * w[:near_clipped]
    rgba = np.concatenate([rng.uniform(0.05, 1.0, (n, 3)), np.ones((n, 1))], 1)
    return np.concatenate([xy, z, w, rgba], 1).astype(np.float32)


def _frame_case(case):
    """(vertices, indices, pipeline keywords, entry budget) of one seeded
    frame of test_frames_match_reference."""
    if case == "line_list":
        v = _seeded_vertices(11, 48, near_clipped=4)
        return v, np.random.default_rng(12).permutation(48), dict(line_width=2.0), None
    if case == "line_strip_restart":
        idx = np.arange(40)
        idx[[9, 23]] = -1
        return (_seeded_vertices(13, 40), idx,
                dict(topology="LINE_STRIP", restart=True, line_width=1.5), None)
    if case == "points_sized":
        return (_seeded_vertices(14, 60), np.arange(60),
                dict(topology="POINT_LIST", point_size_vs=True), None)
    if case == "wire_line_cull":
        return (_seeded_vertices(15, 36, near_clipped=3), np.arange(36),
                dict(topology="TRIANGLE_LIST", polygon_mode="LINE", cull="BACK"), None)
    assert case == "wire_point"
    return (_seeded_vertices(16, 24), np.arange(24),
            dict(topology="TRIANGLE_LIST", polygon_mode="POINT", point_size_vs=True), 8192)


@pytest.mark.parametrize("case", ["line_list", "line_strip_restart", "points_sized",
                                  "wire_line_cull", "wire_point"])
def test_frames_match_reference(case):
    verts, indices, kw, budget = _frame_case(case)
    indices = np.asarray(indices, np.int32)
    jp = _pipeline(jpipe, jshader, jstate, JFormat, **kw)

    def jfn(vb, ib):
        c, d, _ = jdraw.draw_indexed([jnp.zeros((H, W, 4), jnp.float32)],
                                     jnp.zeros((H, W), jnp.float32), jp, vb, ib, {}, JG,
                                     entry_budget=budget)
        return c[0], d

    jc, jz = (np.asarray(a) for a in jax.jit(jfn)(jnp.asarray(verts), jnp.asarray(indices)))
    img, z = _render(verts, indices, entry_budget=budget, **kw)
    assert (img[..., 3] > 0.0).sum() > 50
    np.testing.assert_array_equal(img[..., 3] > 0.0, jc[..., 3] > 0.0)
    np.testing.assert_allclose(img, jc, atol=1e-5)
    np.testing.assert_allclose(z, jz, atol=1e-5)


@pytest.mark.parametrize("topology,restart,indices,expect", [
    ("LINE_LIST", False, [0, 1, 2, 3], [[0, 1], [2, 3]]),
    ("LINE_STRIP", False, [0, 1, 2], [[0, 1], [1, 2]]),
    ("LINE_STRIP", True, [0, 1, -1, 2, 3], [[0, 1], [0, 0], [0, 0], [2, 3]]),
])
def test_assemble_lines(topology, restart, indices, expect):
    ia_t = tstate.InputAssemblyState(topology=tstate.PrimitiveTopology[topology],
                                     primitive_restart=restart)
    ia_j = jstate.InputAssemblyState(topology=jstate.PrimitiveTopology[topology],
                                     primitive_restart=restart)
    segs = tdraw.assemble_lines(torch.tensor(indices, dtype=torch.int32), ia_t).numpy()
    np.testing.assert_array_equal(segs, expect)
    np.testing.assert_array_equal(
        segs, np.asarray(jdraw.assemble_lines(jnp.asarray(indices, jnp.int32), ia_j)))


def test_horizontal_exact_coverage():
    img, _ = _render([_vert(4, 8), _vert(12, 8)], [0, 1], line_width=2.0)
    expected = np.zeros((H, W), bool)
    expected[7:9, 4:12] = True
    np.testing.assert_array_equal(img[..., 0] > 0.5, expected)


def test_vertical_exact_coverage():
    img, _ = _render([_vert(20, 4), _vert(20, 28)], [0, 1], line_width=2.0)
    expected = np.zeros((H, W), bool)
    expected[4:28, 19:21] = True
    np.testing.assert_array_equal(img[..., 0] > 0.5, expected)


def test_diagonal_coverage_scales_with_length():
    img, _ = _render([_vert(10, 5), _vert(100, 25)], [0, 1])
    n = (img[..., 0] > 0.5).sum()
    length = np.hypot(90, 20)
    assert 0.7 * length <= n <= 1.5 * length, n


def test_depth_interpolates_along_line():
    _, z = _render([_vert(4, 8, z=0.8), _vert(12, 8, z=0.4)], [0, 1], line_width=2.0)
    for col in (4, 7, 11):
        t = (col + 0.5 - 4.0) / 8.0
        np.testing.assert_allclose(z[8, col], 0.8 + t * (0.4 - 0.8), atol=1e-5)


def test_perspective_correct_attr_along_line():
    img, _ = _render([_vert(4, 8, w=1.0, rgba=(0, 1, 1, 1)),
                      _vert(100, 8, w=4.0, rgba=(1, 1, 1, 1))], [0, 1], line_width=2.0)
    mid = img[8, 52, 0]
    t = (52.5 - 4.0) / 96.0
    np.testing.assert_allclose(mid, (t / 4.0) / ((1 - t) / 1.0 + t / 4.0), atol=0.02)
    assert abs(mid - t) > 0.05


def test_line_strip_restart_renders_two_segments():
    img, _ = _render([_vert(4, 8), _vert(12, 8), _vert(4, 20), _vert(12, 20)],
                     [0, 1, -1, 2, 3], topology="LINE_STRIP", line_width=2.0, restart=True)
    expected = np.zeros((H, W), bool)
    expected[7:9, 4:12] = True
    expected[19:21, 4:12] = True
    np.testing.assert_array_equal(img[..., 0] > 0.5, expected)


def test_near_clipped_line_stays_finite():
    img, z = _render([_vert(64, 16, z=0.5, w=1.0), [0.5, 0.0, 0.5, -1.0, 1, 1, 1, 1]],
                     [0, 1], line_width=2.0)
    assert np.isfinite(img).all() and np.isfinite(z).all()
    assert (img[..., 0] > 0.5).sum() > 0


def test_zero_length_line_draws_nothing():
    img, _ = _render([_vert(20, 16), _vert(20, 16)], [0, 1], line_width=4.0)
    assert (img[..., 0] > 0.0).sum() == 0


def test_point_default_size_one_pixel():
    img, _ = _render([_vert(20.5, 16.5)], [0], topology="POINT_LIST")
    expected = np.zeros((H, W), bool)
    expected[16, 20] = True
    np.testing.assert_array_equal(img[..., 0] > 0.5, expected)


def test_point_size_from_vertex_shader():
    img, _ = _render([_vert(20.5, 16.5)], [0], topology="POINT_LIST", point_size_vs=True)
    expected = np.zeros((H, W), bool)
    expected[15:18, 19:22] = True
    np.testing.assert_array_equal(img[..., 0] > 0.5, expected)


def test_point_behind_camera_culled():
    img, _ = _render([[0.0, 0.0, 0.5, -1.0, 1, 1, 1, 1]], [0], topology="POINT_LIST")
    assert (img[..., 0] > 0.0).sum() == 0


TRI = [_vert(20, 26, rgba=(1, 0, 0, 1)), _vert(100, 26, rgba=(1, 0, 0, 1)),
       _vert(60, 5, rgba=(1, 0, 0, 1))]


@pytest.fixture(scope="module")
def wire():
    """The wireframe triangle, rendered once for the module's checks."""
    img, _ = _render(TRI, [0, 1, 2], topology="TRIANGLE_LIST", polygon_mode="LINE")
    return img[..., 0] > 0.5


def test_wireframe_outlines_not_interior(wire):
    img, _ = _render(TRI, [0, 1, 2], topology="TRIANGLE_LIST")
    filled = img[..., 0] > 0.5
    assert 0 < wire.sum() < 0.5 * filled.sum()
    assert filled[20, 60] and not wire[20, 60]


def test_wire_pixels_near_triangle_edges(wire):
    ys, xs = np.nonzero(wire)
    pts = np.stack([xs + 0.5, ys + 0.5], axis=1)
    corners = np.array([[20, 26], [100, 26], [60, 5]], np.float64)
    dmin = np.full(len(pts), np.inf)
    for i in range(3):
        a, b = corners[i], corners[(i + 1) % 3]
        ab = b - a
        t = np.clip(((pts - a) @ ab) / (ab @ ab), 0, 1)
        dmin = np.minimum(dmin, np.linalg.norm(pts - (a + t[:, None] * ab), axis=1))
    assert dmin.max() < 1.5, dmin.max()


def test_wireframe_backface_culled():
    img, _ = _render(TRI, [0, 2, 1], topology="TRIANGLE_LIST", polygon_mode="LINE", cull="BACK")
    img_ok, _ = _render(TRI, [0, 1, 2], topology="TRIANGLE_LIST", polygon_mode="LINE",
                        cull="BACK")
    assert ((img_ok[..., 0] > 0.5).sum() == 0) != ((img[..., 0] > 0.5).sum() == 0)


def test_point_polygon_mode_renders_corners():
    # POINT mode emits 6 records a triangle against an estimate of 2
    # (the reference's est_factor, ROADMAP §3): an explicit budget.
    img, _ = _render(TRI, [0, 1, 2], entry_budget=8192, topology="TRIANGLE_LIST",
                     polygon_mode="POINT", point_size_vs=True)
    cover = img[..., 0] > 0.5
    for cx, cy in ((20, 26), (100, 26), (60, 5)):
        assert cover[cy, cx] or cover[cy - 1, cx] or cover[cy, cx - 1], (cx, cy)
    assert not cover[20, 60]
    assert cover.sum() <= 3 * 16


def _segment_scene(seed, n, clipped):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.6, 1.8, (2 * n, 1))
    xy = rng.uniform(-1.2, 1.2, (2 * n, 2)) * w
    z = rng.uniform(0.05, 0.95, (2 * n, 1)) * w
    clip = np.concatenate([xy, z, w], 1)
    if clipped:
        clip[1::4, 2] = clip[1::4, 3] * 1.4  # beyond the near plane (z > w)
    vary = rng.uniform(-1, 1, (2 * n, 3))
    sizes = rng.uniform(0.5, 6.0, (2 * n,))
    return (clip.astype(np.float32), vary.astype(np.float32), sizes.astype(np.float32),
            rng.permutation(2 * n).reshape(n, 2).astype(np.int32))


def _assert_records(t_out, j_out, atol):
    (t_rec, t_corner), (j_rec, j_corner) = t_out, j_out
    for name, tf, jf in zip(tgeo.TriangleRecords._fields, t_rec, j_rec):
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=atol, rtol=atol,
                                   err_msg=name)
    np.testing.assert_allclose(t_corner.numpy(), np.asarray(j_corner), atol=atol, rtol=atol)


@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("line_width", [1.0, 2.5])
def test_line_records_match(clipped, line_width):
    clip, vary, _, segs = _segment_scene(3, 40, clipped)
    t_out = tgeo.setup_lines_with_attrs(torch.from_numpy(clip), torch.from_numpy(segs),
                                        torch.from_numpy(vary), W, H, line_width=line_width)
    fn = lambda c, s, v: jgeo.setup_lines_with_attrs(c, s, v, W, H, line_width=line_width)
    j_out = (jax.jit(fn) if clipped else fn)(jnp.asarray(clip), jnp.asarray(segs),
                                             jnp.asarray(vary))
    _assert_records(t_out, j_out, 1e-5 if clipped else 0.0)


@pytest.mark.parametrize("with_sizes", [False, True])
def test_point_records_match(with_sizes):
    clip, vary, sizes, segs = _segment_scene(5, 40, clipped=True)
    idx = segs.reshape(-1)
    valid = np.arange(idx.shape[0]) % 3 != 0
    t_out = tgeo.setup_points_with_attrs(
        torch.from_numpy(clip), torch.from_numpy(idx), torch.from_numpy(vary), W, H,
        point_sizes=torch.from_numpy(sizes) if with_sizes else None,
        pt_valid=torch.from_numpy(valid))
    j_out = jgeo.setup_points_with_attrs(
        jnp.asarray(clip), jnp.asarray(idx), jnp.asarray(vary), W, H,
        point_sizes=jnp.asarray(sizes) if with_sizes else None, pt_valid=jnp.asarray(valid))
    _assert_records(t_out, j_out, 0.0)
