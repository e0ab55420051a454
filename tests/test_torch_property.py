"""The random state sweeps of tests/test_property.py and
tests/test_property_matrix.py on the port, against the same numpy oracle
(tests/np_reference.py, a brute-force rasterizer with no binning or
tiling).

test_property.py draws random combinations of cull mode, depth compare,
depth write and strip decode (8 seeds); test_property_matrix.py widens them
to topology (list, strip, strip with primitive restart), cull mode × front
face, all eight depth compares × write, stencil (off, one face, two faces
with random ops, reference and masks) and the sample position on the 1/16
lattice (24 seeds), and draws 12 random blend equations (factors × ops ×
write mask) through ``apply_color_output`` against a numpy statement of
the Vulkan blend equation. Every seed and every draw is the reference's;
each goes through the port's ``setup_triangles`` → ``corner_attributes`` →
``bin_segmented`` → ``raster_segmented`` (the plain version of K1, K3 with
stencil, on CPU tensors).

Tolerances: the reference's own: coverage and stencil exact, z atol 1e-4,
the interpolated varyings atol 2e-3, blended colour atol 1e-5.

``property_case``, ``matrix_case`` and ``blend_case`` build the draws from
numpy alone, so chip_smoke.py runs the same draws through the kernels on
the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from np_reference import render_reference
from zenith_tpu_torch.ops import (
    TileGrid,
    apply_color_output,
    bin_segmented,
    corner_attributes,
    raster_segmented,
    setup_triangles,
)
from zenith_tpu_torch.ops.draw import assemble_triangles
from zenith_tpu_torch.rhi.state import (
    BlendFactor,
    BlendOp,
    ColorAttachmentDesc,
    CompareOp,
    CullMode,
    FrontFace,
    InputAssemblyState,
    PrimitiveTopology,
    StencilOp,
    StencilOpState,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 64
GRID = TileGrid(width=W, height=H, tile_h=8, tile_w=128)

CULL_NAMES = {CullMode.NONE: "none", CullMode.BACK: "back", CullMode.FRONT: "front"}
FRONT_NAMES = {FrontFace.COUNTER_CLOCKWISE: "ccw", FrontFace.CLOCKWISE: "cw"}
# test_property.py's dimensions.
PROPERTY_CULLS = [CullMode.NONE, CullMode.BACK, CullMode.FRONT]
PROPERTY_COMPARES = [CompareOp.GREATER, CompareOp.LESS, CompareOp.GREATER_OR_EQUAL,
                     CompareOp.ALWAYS]
# test_property_matrix.py's.
COMPARES = list(CompareOp)
STENCIL_OPS = list(StencilOp)
STENCIL_COMPARES = [CompareOp.ALWAYS, CompareOp.EQUAL, CompareOp.NOT_EQUAL, CompareOp.LESS,
                    CompareOp.GREATER_OR_EQUAL, CompareOp.NEVER]
PROPERTY_SEEDS = range(8)
MATRIX_SEEDS = range(24)
BLEND_SEEDS = range(12)


def _strip(strip: np.ndarray, restart: bool) -> np.ndarray:
    ia = InputAssemblyState(topology=PrimitiveTopology.TRIANGLE_STRIP,
                            primitive_restart=restart)
    return assemble_triangles(torch.from_numpy(strip), ia).numpy()


def property_case(seed: int) -> dict:
    """test_property.py's draw for ``seed`` (0-7): clip-space positions
    strictly in front (w = 1), 3 varyings, a triangle list or a strip."""
    rng = np.random.default_rng(1000 + seed)
    use_strip = seed % 4 == 3
    nv = 36
    pos = rng.uniform(-1.2, 1.2, size=(nv, 2))
    zz = rng.uniform(0.05, 0.95, size=(nv, 1))
    clip = np.concatenate([pos, zz, np.ones((nv, 1))], axis=1).astype(np.float32)
    vary = rng.uniform(0, 1, size=(nv, 3)).astype(np.float32)
    if use_strip:
        tris = _strip(rng.integers(0, nv, size=(20,)).astype(np.int32), False)
    else:
        tris = rng.integers(0, nv, size=(14, 3)).astype(np.int32)
    return dict(
        clip=clip, tris=tris, vary=vary, cull=PROPERTY_CULLS[seed % 3],
        front=FrontFace.COUNTER_CLOCKWISE, compare=PROPERTY_COMPARES[(seed * 3) % 4],
        depth_write=bool(seed % 2), offset=(0.5, 0.5), front_st=None, back_st=None,
        stencil_init=0, label=f"property seed={seed} strip={use_strip}")


def rand_face(rng) -> StencilOpState:
    """A random stencil face: ops, compare, masks and reference."""
    return StencilOpState(
        fail_op=STENCIL_OPS[rng.integers(len(STENCIL_OPS))],
        pass_op=STENCIL_OPS[rng.integers(len(STENCIL_OPS))],
        depth_fail_op=STENCIL_OPS[rng.integers(len(STENCIL_OPS))],
        compare_op=STENCIL_COMPARES[rng.integers(len(STENCIL_COMPARES))],
        compare_mask=int(rng.integers(0, 256)),
        write_mask=int(rng.integers(1, 256)),
        reference=int(rng.integers(0, 256)),
    )


def matrix_case(seed: int) -> dict:
    """test_property_matrix.py's draw for ``seed`` (0-23): every dimension
    drawn from one generator in the reference's order."""
    rng = np.random.default_rng(3000 + seed)
    dims = {
        "topology": ["list", "strip", "strip_restart"][rng.integers(3)],
        "cull": list(CULL_NAMES)[rng.integers(3)],
        "front": list(FRONT_NAMES)[rng.integers(2)],
        "compare": COMPARES[rng.integers(len(COMPARES))],
        "depth_write": bool(rng.integers(2)),
        "stencil": ["off", "one_face", "two_face"][rng.integers(3)],
        "offset": ((0.5, 0.5) if rng.integers(2) == 0
                   else (float(rng.integers(1, 16)) / 16.0, float(rng.integers(1, 16)) / 16.0)),
    }
    nv = 36
    pos = rng.uniform(-1.2, 1.2, size=(nv, 2))
    zz = rng.uniform(0.05, 0.95, size=(nv, 1))
    clip = np.concatenate([pos, zz, np.ones((nv, 1))], axis=1).astype(np.float32)
    vary = rng.uniform(0, 1, size=(nv, 3)).astype(np.float32)
    if dims["topology"] == "list":
        tris = rng.integers(0, nv, size=(14, 3)).astype(np.int32)
    else:
        strip = rng.integers(0, nv, size=(22,)).astype(np.int32)
        restart = dims["topology"] == "strip_restart"
        if restart:
            strip[rng.integers(3, 19, size=2)] = -1
        tris = _strip(strip, restart)
    front_st = back_st = None
    stencil_init = int(rng.integers(0, 256))
    if dims["stencil"] != "off":
        front_st = rand_face(rng)
        back_st = rand_face(rng) if dims["stencil"] == "two_face" else front_st
    return dict(
        clip=clip, tris=tris, vary=vary, cull=dims["cull"], front=dims["front"],
        compare=dims["compare"], depth_write=dims["depth_write"], offset=dims["offset"],
        front_st=front_st, back_st=back_st, stencil_init=stencil_init,
        label=f"matrix seed={3000 + seed} dims={dims}")


def _face_dict(st: StencilOpState) -> dict:
    return {"compare": st.compare_op.value, "reference": st.reference,
            "compare_mask": st.compare_mask, "write_mask": st.write_mask,
            "fail_op": st.fail_op.value, "pass_op": st.pass_op.value,
            "depth_fail_op": st.depth_fail_op.value}


def oracle(case: dict) -> dict:
    """np_reference.render_reference of a case at 128×64."""
    stencil = None
    if case["front_st"] is not None:
        stencil = {"front": _face_dict(case["front_st"]), "back": _face_dict(case["back_st"]),
                   "init": case["stencil_init"]}
    return render_reference(
        case["clip"], case["tris"], W, H, cull=CULL_NAMES[case["cull"]],
        front_face=FRONT_NAMES[case["front"]], depth_test=True,
        depth_write=case["depth_write"], compare=case["compare"].value,
        varyings={"c": case["vary"]}, sample_offset=case["offset"], stencil=stencil)


def bins_of(case: dict, grid: TileGrid, device=CPU):
    """The port's setup, corner attributes and segmented binning of a case."""
    clip, tris, vary = (torch.from_numpy(case[k]).to(device) for k in ("clip", "tris", "vary"))
    records = setup_triangles(clip, tris, grid.width, grid.height, cull_mode=case["cull"],
                              front_face=case["front"])
    return bin_segmented(records, corner_attributes(records, tris, vary), grid)


def raster_case(case: dict, bins, grid: TileGrid, device=CPU):
    """``raster_segmented`` of a case on its bins → (z, acc, stencil or None)."""
    h, w = grid.height, grid.width
    kw = dict(depth_test=True, depth_write=case["depth_write"], compare_op=case["compare"],
              sample_offset=case["offset"])
    z0 = torch.zeros((h, w), dtype=torch.float32, device=device)
    if case["front_st"] is None:
        z, acc = raster_segmented(bins, grid, z0, **kw)
        return z, acc, None
    init = torch.full((h, w), case["stencil_init"], dtype=torch.int32, device=device)
    return raster_segmented(bins, grid, z0, init_stencil=init, stencil_front=case["front_st"],
                            stencil_back=case["back_st"], **kw)


def assert_matches_oracle(case: dict, z, acc, sten, ref: dict) -> None:
    """The reference's assertions: z atol 1e-4, coverage and stencil exact,
    varyings atol 2e-3 where covered."""
    label = case["label"]
    z, acc = np.asarray(z), np.asarray(acc)
    np.testing.assert_allclose(z, ref["z"], atol=1e-4, err_msg=f"depth mismatch: {label}")
    covered = ref["tri"] >= 0
    iw = acc[-1]
    np.testing.assert_array_equal(iw > 0, covered, err_msg=f"coverage mismatch: {label}")
    if sten is not None:
        np.testing.assert_array_equal(np.asarray(sten), ref["stencil"],
                                      err_msg=f"stencil mismatch: {label}")
    if covered.any():
        interp = acc[:3] / np.maximum(iw, 1e-12)
        got = np.moveaxis(interp, 0, -1)[covered]
        np.testing.assert_allclose(got, ref["c"][covered], atol=2e-3,
                                   err_msg=f"varying mismatch: {label}")


def _check(case: dict) -> None:
    z, acc, sten = raster_case(case, bins_of(case, GRID), GRID)
    assert_matches_oracle(case, z.numpy(), acc.numpy(),
                          None if sten is None else sten.numpy(), oracle(case))


@pytest.mark.parametrize("seed", PROPERTY_SEEDS)
def test_random_state_combination_matches_oracle(seed):
    _check(property_case(seed))


@pytest.mark.parametrize("seed", MATRIX_SEEDS)
def test_matrix(seed):
    _check(matrix_case(seed))


# -- dimension 7: random blend equations vs an independent numpy oracle ------


def _np_factor(name, src, dst):
    s_a, d_a = src[..., 3:4], dst[..., 3:4]
    return {
        "zero": np.zeros_like(src),
        "one": np.ones_like(src),
        "src_color": src,
        "one_minus_src_color": 1.0 - src,
        "dst_color": dst,
        "one_minus_dst_color": 1.0 - dst,
        "src_alpha": np.broadcast_to(s_a, src.shape),
        "one_minus_src_alpha": np.broadcast_to(1.0 - s_a, src.shape),
        "dst_alpha": np.broadcast_to(d_a, src.shape),
        "one_minus_dst_alpha": np.broadcast_to(1.0 - d_a, src.shape),
    }[name]


def _np_blend_op(name, a, b):
    return {"add": a + b, "subtract": a - b, "reverse_subtract": b - a,
            "min": np.minimum(a, b), "max": np.maximum(a, b)}[name]


def blend_desc(rng) -> ColorAttachmentDesc:
    """A random blend equation and write mask, drawn in the reference's
    order."""
    factors, ops = list(BlendFactor), list(BlendOp)
    return ColorAttachmentDesc(
        blend_enable=True,
        src_color_blend=factors[rng.integers(len(factors))],
        dst_color_blend=factors[rng.integers(len(factors))],
        src_alpha_blend=factors[rng.integers(len(factors))],
        dst_alpha_blend=factors[rng.integers(len(factors))],
        color_blend_op=ops[rng.integers(len(ops))],
        alpha_blend_op=ops[rng.integers(len(ops))],
        write_mask=tuple(bool(b) for b in rng.integers(0, 2, size=4)),
    )


def blend_case(seed: int):
    """test_property_matrix.py::test_random_blend_equation's draw for
    ``seed`` (0-11 there; any seed here): (desc, src, dst, mask)."""
    rng = np.random.default_rng(7000 + seed)
    desc = blend_desc(rng)
    src = rng.uniform(0, 1, size=(8, 16, 4)).astype(np.float32)
    dst = rng.uniform(0, 1, size=(8, 16, 4)).astype(np.float32)
    mask = rng.integers(0, 2, size=(8, 16)).astype(bool)
    return desc, src, dst, mask


def np_blend(desc: ColorAttachmentDesc, src, dst, mask) -> np.ndarray:
    """The Vulkan blend equation (spec 28.1) with the write mask, in numpy."""
    f = {k: _np_factor(getattr(desc, k).value, src, dst)
         for k in ("src_color_blend", "dst_color_blend", "src_alpha_blend", "dst_alpha_blend")}
    rgb = _np_blend_op(desc.color_blend_op.value, src[..., :3] * f["src_color_blend"][..., :3],
                       dst[..., :3] * f["dst_color_blend"][..., :3])
    alpha = _np_blend_op(desc.alpha_blend_op.value, src[..., 3:4] * f["src_alpha_blend"][..., 3:4],
                         dst[..., 3:4] * f["dst_alpha_blend"][..., 3:4])
    ref = np.concatenate([rgb, alpha], axis=-1)
    for k in range(4):
        if not desc.write_mask[k]:
            ref[..., k] = dst[..., k]
    return np.where(mask[..., None], ref, dst)


@pytest.mark.parametrize("seed", BLEND_SEEDS)
def test_random_blend_equation(seed):
    """Random (factors × ops × write mask) through apply_color_output vs an
    independent numpy statement of the Vulkan blend equation (spec 28.1)."""
    desc, src, dst, mask = blend_case(seed)
    got = apply_color_output(torch.from_numpy(dst), torch.from_numpy(src),
                             torch.from_numpy(mask), desc, (0.0, 0.0, 0.0, 0.0)).numpy()
    np.testing.assert_allclose(got, np_blend(desc, src, dst, mask), atol=1e-5,
                               err_msg=f"blend mismatch: seed={7000 + seed} desc={desc}")
