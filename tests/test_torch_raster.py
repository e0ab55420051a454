"""K1's plain PyTorch version (zenith_tpu_torch.ops.raster on CPU tensors)
against the independent NumPy oracle, on the cases tests/test_raster.py pins
for the reference: top-left rule, shared edges, depth order, equal-z
later-wins, depth write off, depth test off, random scenes — plus depth
clamp against the reference's raster_segmented.

Tolerances: triangle ownership and coverage exact; z atol 1e-5 against the
float64 oracle (1e-4 for the random scene, as in test_raster.py), 1e-6
against the reference raster; attribute planes atol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_reference import render_reference
from zenith_tpu.ops import TileGrid as JGrid, bin_segmented as jbin
from zenith_tpu.ops import raster_segmented as jraster, setup_with_attrs as jsetup
from zenith_tpu.rhi.state import CullMode as JCull
from zenith_tpu_torch.interop import bins_from_numpy
from zenith_tpu_torch.ops import TileGrid, bin_segmented, raster_segmented, setup_with_attrs
from zenith_tpu_torch.ops.raster import raster_segmented_blend
from zenith_tpu_torch.rhi.state import CompareOp, CullMode

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 32
GRID = TileGrid(width=W, height=H, tile_h=8, tile_w=128)


def ndc_tri(verts2d, z=0.5, w=1.0):
    return np.array([[x * w, y * w, z * w, w] for x, y in verts2d], np.float32)


def run_port(clip, indices, compare=CompareOp.GREATER, depth_test=True,
             depth_write=True, depth_clear=0.0):
    """setup → bin → K1 (plain version) with the triangle index as the one
    varying; returns (z, owning triangle id or -1)."""
    indices = np.asarray(indices).reshape(-1, 3)
    flat = np.asarray(clip, np.float32)[indices.reshape(-1)]
    ids = np.repeat(np.arange(indices.shape[0], dtype=np.float32), 3)[:, None]
    rec, corner = setup_with_attrs(
        torch.from_numpy(flat), torch.arange(flat.shape[0]).reshape(-1, 3),
        torch.from_numpy(ids), W, H, cull_mode=CullMode.NONE,
    )
    bins = bin_segmented(rec, corner, GRID)
    init_z = torch.full((H, W), depth_clear, dtype=torch.float32)
    z, acc = raster_segmented(bins, GRID, init_z, depth_test=depth_test,
                              depth_write=depth_write, compare_op=compare)
    mask = acc[-1] > 0
    tri = torch.where(mask, torch.round(acc[0] / torch.where(mask, acc[-1], 1.0)),
                      torch.full_like(acc[0], -1.0))
    return z.numpy(), tri.numpy().astype(np.int32)


def test_single_triangle_matches_oracle():
    clip = ndc_tri([(0.0, -0.8), (0.7, 0.7), (-0.7, 0.7)], z=0.5)
    idx = np.array([[0, 1, 2]])
    z, tri = run_port(clip, idx)
    ref = render_reference(clip, idx, W, H, cull="none")
    np.testing.assert_array_equal(tri, ref["tri"])
    np.testing.assert_allclose(z, ref["z"], atol=1e-5)
    assert (tri >= 0).sum() > 50


def test_shared_edge_no_double_no_gap():
    quad = ndc_tri([(-0.8, -0.8), (0.8, -0.8), (0.8, 0.8), (-0.8, 0.8)], z=0.5)
    idx = np.array([[0, 1, 2], [0, 2, 3]])
    z, tri = run_port(quad, idx, compare=CompareOp.ALWAYS)
    ref = render_reference(quad, idx, W, H, cull="none", compare="always")
    np.testing.assert_array_equal(tri, ref["tri"])
    covered = tri >= 0
    ys, xs = np.where(covered)
    solid = np.zeros_like(covered)
    solid[ys.min(): ys.max() + 1, xs.min(): xs.max() + 1] = True
    np.testing.assert_array_equal(covered, solid)


def test_top_left_rule_on_pixel_center_edges():
    px, py = 2.0 / W, 2.0 / H
    quad = ndc_tri(
        [
            (-1 + 8 * px + px / 2, -1 + 4 * py + py / 2),
            (-1 + 40 * px + px / 2, -1 + 4 * py + py / 2),
            (-1 + 40 * px + px / 2, -1 + 20 * py + py / 2),
            (-1 + 8 * px + px / 2, -1 + 20 * py + py / 2),
        ],
        z=0.5,
    )
    idx = np.array([[0, 1, 2], [0, 2, 3]])
    _, tri = run_port(quad, idx, compare=CompareOp.ALWAYS)
    ref = render_reference(quad, idx, W, H, cull="none", compare="always")
    np.testing.assert_array_equal(tri, ref["tri"])


@pytest.mark.parametrize("order, near_id", [([0, 1], 1), ([1, 0], 0)])
def test_reverse_z_greater_near_wins(order, near_id):
    near = ndc_tri([(0.0, -0.5), (0.5, 0.5), (-0.5, 0.5)], z=0.8)
    far = ndc_tri([(0.0, -0.6), (0.6, 0.6), (-0.6, 0.6)], z=0.2)
    clip = np.concatenate([[far, near][i] for i in order])
    idx = np.array([[0, 1, 2], [3, 4, 5]])
    _, tri = run_port(clip, idx)
    ref = render_reference(clip, idx, W, H, cull="none")
    np.testing.assert_array_equal(tri, ref["tri"])
    assert tri[H // 2, W // 2] == near_id


def test_equal_z_later_submission_wins():
    a = ndc_tri([(0.0, -0.5), (0.5, 0.5), (-0.5, 0.5)], z=0.5)
    _, tri = run_port(np.concatenate([a, a]), np.array([[0, 1, 2], [3, 4, 5]]),
                      compare=CompareOp.GREATER_OR_EQUAL)
    assert tri[H // 2, W // 2] == 1


def test_depth_write_off_tests_against_initial():
    near = ndc_tri([(0.0, -0.5), (0.5, 0.5), (-0.5, 0.5)], z=0.8)
    far = ndc_tri([(0.0, -0.6), (0.6, 0.6), (-0.6, 0.6)], z=0.2)
    clip = np.concatenate([near, far])
    idx = np.array([[0, 1, 2], [3, 4, 5]])
    z, tri = run_port(clip, idx, depth_write=False)
    ref = render_reference(clip, idx, W, H, cull="none", depth_write=False)
    np.testing.assert_array_equal(tri, ref["tri"])
    assert tri[H // 2, W // 2] == 1
    np.testing.assert_array_equal(z, np.zeros_like(z))


def test_depth_test_disabled_never_writes():
    clip = ndc_tri([(0.0, -0.5), (0.5, 0.5), (-0.5, 0.5)], z=0.8)
    z, tri = run_port(clip, np.array([[0, 1, 2]]), depth_test=False, depth_clear=0.25)
    assert (tri >= 0).any()
    np.testing.assert_allclose(z, 0.25)


@pytest.mark.parametrize("compare", ["greater", "less_or_equal", "not_equal"])
def test_many_random_triangles_match_oracle(rng, compare):
    nv = 60
    pos = rng.uniform(-1.2, 1.2, size=(nv, 2))
    zz = rng.uniform(0.05, 0.95, size=(nv, 1))
    clip = np.concatenate([pos, zz, np.ones((nv, 1))], axis=1).astype(np.float32)
    idx = rng.integers(0, nv, size=(40, 3)).astype(np.int32)
    z, tri = run_port(clip, idx, compare=CompareOp(compare), depth_clear=0.5)
    ref = render_reference(clip, idx, W, H, cull="none", compare=compare, depth_clear=0.5)
    np.testing.assert_array_equal(tri, ref["tri"])
    np.testing.assert_allclose(z, ref["z"], atol=1e-4)


def test_depth_clamp_matches_reference_raster():
    """Fragments outside [0, 1] clamp instead of being rejected; the port and
    the reference kernel get identical bins."""
    rng = np.random.default_rng(11)
    nv = 30
    clip = np.concatenate(
        [rng.uniform(-1.2, 1.2, (nv, 2)), rng.uniform(-0.6, 1.6, (nv, 1)), np.ones((nv, 1))],
        axis=1,
    ).astype(np.float32)
    idx = rng.integers(0, nv, (16, 3)).astype(np.int32)
    vary = rng.uniform(0, 1, (nv, 2)).astype(np.float32)
    jgrid = JGrid(W, H, 8, 128)

    @jax.jit
    def reference_bins(clip, idx, vary):
        # Setup and binning compiled as one function (both rasters read the
        # bins it makes).
        rec, corner = jsetup(clip, idx, vary, W, H, cull_mode=JCull.NONE, depth_clamp=True)
        return jbin(rec, corner, jgrid, entry_budget=256)

    jb = reference_bins(jnp.asarray(clip), jnp.asarray(idx), jnp.asarray(vary))
    init = rng.uniform(0, 1, (H, W)).astype(np.float32)
    fn = jax.jit(functools.partial(jraster, grid=jgrid, depth_clamp=True))
    jz, jacc = (np.asarray(a) for a in fn(jb, init_z=jnp.asarray(init)))
    tz, tacc = raster_segmented(bins_from_numpy([np.asarray(f) for f in jb], CPU), GRID,
                                torch.from_numpy(init), depth_clamp=True)
    np.testing.assert_array_equal(tacc.numpy()[-1] > 0, jacc[-1] > 0)
    np.testing.assert_allclose(tz.numpy(), jz, atol=1e-6)
    np.testing.assert_allclose(tacc.numpy(), jacc, atol=1e-5)
    assert (tz.numpy() == 1.0).any()  # something really clamped


def test_cpu_tensors_take_the_plain_version_and_unported_branches_raise():
    before = raster_segmented.launches
    clip = ndc_tri([(0.0, -0.8), (0.7, 0.7), (-0.7, 0.7)])
    run_port(clip, np.array([[0, 1, 2]]))
    assert raster_segmented.launches == before  # the kernel counter is CUDA-only
    rec, corner = setup_with_attrs(
        torch.from_numpy(clip), torch.tensor([[0, 1, 2]]), torch.zeros((3, 1)), W, H
    )
    bins = bin_segmented(rec, corner, GRID)
    z0 = torch.zeros((H, W))
    # The stencil, peel and blend branches run their plain versions too, and
    # count no launch of their kernels either.
    from zenith_tpu_torch.ops.draw import make_shade_blend
    from zenith_tpu_torch.rhi.shader import Shader
    from zenith_tpu_torch.rhi.state import ColorAttachmentDesc, StencilOp, StencilOpState

    mark = StencilOpState(pass_op=StencilOp.REPLACE, compare_op=CompareOp.ALWAYS, reference=1)
    z, acc, sten = raster_segmented(bins, GRID, z0, stencil_front=mark)
    assert sten.dtype == torch.int32 and torch.equal(sten == 1, acc[-1] > 0)
    z1, acc1 = raster_segmented(bins, GRID, z0, z_bound=z)  # nothing lies behind the one layer
    assert not (acc1[-1] > 0).any()
    with pytest.raises(ValueError, match="cannot combine with stencil"):
        raster_segmented(bins, GRID, z0, z_bound=z, stencil_front=mark)
    fs = Shader.fragment("white", lambda v, r, b: torch.ones(b.depth.shape + (4,)),
                         kernel_safe=True)
    shade_blend = make_shade_blend(fs, [("c", 1), ("__front", 1)], ColorAttachmentDesc(),
                                   (0.0,) * 4, (W, H))
    _, color = raster_segmented_blend(bins, GRID, z0, torch.zeros((H, W, 4)), shade_blend)
    assert torch.equal(color[..., 0] == 1.0, acc[-1] > 0)
    assert (raster_segmented.stencil_launches, raster_segmented.peel_launches,
            raster_segmented_blend.launches, raster_segmented_blend.stencil_launches) == (0,) * 4
