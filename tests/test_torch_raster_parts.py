"""Sequential raster parts on the port (tests/test_raster_parts.py's seven
cases): a draw whose records exceed ``ops.draw.MAX_RECORDS_PER_RASTER``
bins and rasters in contiguous record ranges with z, stencil and colour
threaded through, and a draw above ``MAX_PRIMS_PER_PART`` triangles sets
up its geometry in contiguous primitive ranges. Either split must be
bit-equal to the unsplit render.

As the reference does, the caps are monkeypatched tiny (64 records, 16
primitives) so that a 96-triangle soup of random overlapping triangles
splits; each case renders the soup through the port's render graph at
128×64 (8×128 tiles) unsplit and split: opaque depth write, the batch
path, stencil (INCREMENT_AND_CLAMP on pass), 4× MSAA with sample shading,
the batched blend (src-alpha over, depth write off), the primitive-level
split, and the primitive-level split through the batch and blend paths.

The reference's stencil and blend states draw nothing, in the reference
package as in the port: the stencil state's depth clears to 1.0 under
GREATER, and the blend state LOADs a depth plane nothing wrote, which holds
that clear value. Their splits compare cleared frames. The twin keeps
them and adds a drawing variant of each (an overdraw limiter over a
reverse-Z clear; the same blend over a depth plane cleared to 0.0), and
checks that each split happened and that each other render drew.
No JAX program is built: test_torch_draw.py, test_torch_stencil.py,
test_torch_msaa.py and test_torch_blend_batch.py hold the unsplit paths
against the reference package.

Tolerance: bit-equal, the reference's.

``render_soup`` and ``SPLIT_CASES`` build the renders from numpy and the
port alone, so chip_smoke.py runs the same splits through the kernels on
the card.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from zenith_tpu_torch.ops import draw as draw_mod
from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
from zenith_tpu_torch.rhi import (
    Buffer,
    ColorAttachmentDesc,
    CompareOp,
    CullMode,
    GraphicShaderInput,
    PipelineCache,
    RasterizationState,
    RhiCore,
    Shader,
    TextureDesc,
    VertexLayout,
)
from zenith_tpu_torch.rhi.state import (
    DepthStencilDesc,
    GraphicPipelineState,
    LoadOp,
    MultisampleState,
    StencilOp,
    StencilOpState,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 64
OPTS = CompileOptions(tile_h=8, tile_w=128)
# The caps the reference's test sets.
SPLIT_RECORDS = 64
SPLIT_PRIMS = 16


def _vs(attrs, res):
    p = attrs["position"]
    return {"position": torch.cat([p, torch.ones_like(p[:, :1])], 1), "rgba": attrs["rgba"]}


def _fs(varyings, res, builtins):
    return varyings["rgba"]


LAYOUT = VertexLayout.from_fields(("position", 3), ("rgba", 4))
VS = Shader.vertex("p.vs", _vs)
FS = Shader.fragment("p.fs", _fs)


def tri_soup(n: int, seed: int = 7, alpha: float = 1.0) -> np.ndarray:
    """n random overlapping triangles with varied depths (position3+rgba4)."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-0.9, 0.9, (n, 2))
    verts = []
    for i in range(n):
        ang = rng.uniform(0, 2 * np.pi, 3)
        rad = rng.uniform(0.15, 0.5, 3)
        z = rng.uniform(0.05, 0.95)
        rgba = (*rng.uniform(0.1, 1.0, 3), alpha)
        for a, r in zip(ang, rad):
            verts.append([center[i, 0] + r * np.cos(a), center[i, 1] + r * np.sin(a), z, *rgba])
    return np.asarray(verts, np.float32)


def render_soup(state: GraphicPipelineState, n_tris: int = 96, alpha: float = 1.0,
                batch: bool = False, device=CPU, fs: Shader = FS) -> dict:
    """The soup through one graphic node of the render graph → {"color",
    "depth"} as numpy arrays (the reference test's ``_render``)."""
    render_device = RhiCore(device).create_render_device()
    vb = Buffer.from_numpy("soup", tri_soup(n_tris, alpha=alpha), device=device)
    ib = Buffer.from_numpy("ib", np.arange(3 * n_tris, dtype=np.int32), device=device)

    builder = RenderGraphBuilder()
    vb_r, ib_r = builder.import_resource(vb), builder.import_resource(ib)
    # MSAA is pipeline state; the attachments stay 1x descs.
    color = builder.create(TextureDesc.color("rt", W, H))
    depth = builder.create(TextureDesc.depth("ds", W, H))
    with_stencil = state.depth_stencil.stencil_test_enable
    sten = builder.create(TextureDesc.stencil("st", W, H)) if with_stencil else None
    builder.export(color)
    builder.export(depth)

    node = builder.add_graphic_node("soup")
    va, ia = node.read(vb_r), node.read(ib_r)
    rt, ds = node.write(color), node.write(depth)
    sa = node.write(sten) if with_stencil else None
    with node.pipeline(GraphicShaderInput(VS, fs, LAYOUT), state) as b:
        desc = ColorAttachmentDesc(clear_value=(0, 0, 0, 1))
        b.push_color(rt, desc if alpha >= 1.0 else desc.translucent())
        b.set_depth(ds, state.depth_stencil)
        if with_stencil:
            b.set_stencil(sa)
    if batch:
        node.execute(lambda ctx, va=va, ia=ia: ctx.draw_indexed_batch([(va, ia, {})]))
    else:
        node.execute(lambda ctx, va=va, ia=ia: ctx.draw_indexed(va, ia))

    compiled = builder.build().compile(render_device, PipelineCache(), OPTS)
    compiled.execute(render_device)
    return {"color": compiled.value(color).cpu().numpy(),
            "depth": compiled.value(depth).cpu().numpy()}


OPAQUE = GraphicPipelineState(rasterization=RasterizationState(cull_mode=CullMode.NONE),
                              depth_stencil=DepthStencilDesc().reverse_z())
_STEN = StencilOpState(fail_op=StencilOp.KEEP, pass_op=StencilOp.INCREMENT_AND_CLAMP,
                       depth_fail_op=StencilOp.KEEP, compare_op=CompareOp.ALWAYS)
STENCIL = GraphicPipelineState(
    rasterization=RasterizationState(cull_mode=CullMode.NONE),
    depth_stencil=DepthStencilDesc(depth_test_enable=True, depth_write_enable=True,
                                   depth_compare_op=CompareOp.GREATER, stencil_test_enable=True,
                                   stencil_front=_STEN, stencil_back=_STEN))
# The reference's stencil state clears depth to 1.0 under GREATER, so no
# fragment passes and its split compares two cleared frames (as it does in
# the reference package); the twin adds an overdraw limiter that draws
# (reverse-Z clear, pass while the stencil is below 2), whose colour depends
# on the stencil threaded across parts.
_LIMIT = StencilOpState(pass_op=StencilOp.INCREMENT_AND_CLAMP, compare_op=CompareOp.GREATER,
                        reference=2)
STENCIL_LIMIT = GraphicPipelineState(
    rasterization=RasterizationState(cull_mode=CullMode.NONE),
    depth_stencil=DepthStencilDesc(depth_test_enable=True, depth_write_enable=True,
                                   depth_compare_op=CompareOp.GREATER, depth_clear_value=0.0,
                                   stencil_test_enable=True, stencil_front=_LIMIT,
                                   stencil_back=_LIMIT))
MSAA = GraphicPipelineState(rasterization=RasterizationState(cull_mode=CullMode.NONE),
                            depth_stencil=DepthStencilDesc().reverse_z(),
                            multisample=MultisampleState(samples=4, sample_shading=True))
BLEND = GraphicPipelineState(
    rasterization=RasterizationState(cull_mode=CullMode.NONE),
    depth_stencil=DepthStencilDesc(depth_test_enable=True, depth_write_enable=False,
                                   depth_compare_op=CompareOp.GREATER,
                                   depth_load_op=LoadOp.LOAD))
BLEND_KW = dict(alpha=0.5, batch=True, n_tris=48)
# The reference's blend state LOADs a depth plane nothing wrote, which holds
# the clear value 1.0, so its blend cases draw nothing either; the twin adds
# the same blend over a depth plane cleared to 0.0, where every fragment
# blends in submission order.
BLEND_DRAWN = GraphicPipelineState(
    rasterization=RasterizationState(cull_mode=CullMode.NONE),
    depth_stencil=DepthStencilDesc(depth_test_enable=True, depth_write_enable=False,
                                   depth_compare_op=CompareOp.GREATER, depth_clear_value=0.0))
# The reference's states under which no fragment passes the depth test.
DRAWS_NOTHING = (STENCIL, BLEND)

# name: (the cap split, [(state, render keywords), ...]), in the reference's
# order.
SPLIT_CASES = {
    "opaque": ("records", [(OPAQUE, {})]),
    "batch path": ("records", [(OPAQUE, dict(batch=True))]),
    "stencil": ("records", [(STENCIL, {}), (STENCIL_LIMIT, {})]),
    "msaa": ("records", [(MSAA, dict(n_tris=48))]),
    "blend batch": ("records", [(BLEND, BLEND_KW), (BLEND_DRAWN, BLEND_KW)]),
    "prim level": ("prims", [(OPAQUE, {})]),
    "prim level batch and blend": ("prims", [(OPAQUE, dict(batch=True)), (BLEND, BLEND_KW),
                                             (BLEND_DRAWN, BLEND_KW)]),
}


@contextlib.contextmanager
def split_caps(which: str):
    """``ops.draw``'s record or primitive cap set to the reference test's
    value, restored on the way out; yields the counts of the parts each
    draw made (bin parts for "records", geometry parts for "prims")."""
    name, value = (("MAX_RECORDS_PER_RASTER", SPLIT_RECORDS) if which == "records"
                   else ("MAX_PRIMS_PER_PART", SPLIT_PRIMS))
    real = {"records": draw_mod._bin_parts, "prims": draw_mod._geo_specs}[which]
    parts = []

    def counted(*args, **kw):
        out = real(*args, **kw)
        parts.append(len(out.parts) if which == "records" else len(out))
        return out

    saved = getattr(draw_mod, name)
    setattr(draw_mod, name, value)
    setattr(draw_mod, real.__name__, counted)
    try:
        yield parts
    finally:
        setattr(draw_mod, name, saved)
        setattr(draw_mod, real.__name__, real)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_render_is_bit_equal_to_the_unsplit_render(case):
    """test_opaque_split_bit_equal, test_batch_path_split_bit_equal,
    test_stencil_split_bit_equal, test_msaa_split_bit_equal,
    test_blend_batch_split_bit_equal, test_prim_level_split_bit_equal and
    test_prim_split_batch_and_blend, in that order."""
    which, renders = SPLIT_CASES[case]
    for state, kw in renders:
        full = render_soup(state, **kw)
        with split_caps(which) as parts:
            split = render_soup(state, **kw)
        assert parts and max(parts) > 1, f"{case}: the draw did not split ({parts})"
        if all(state is not s for s in DRAWS_NOTHING):
            assert (full["color"][..., :3] > 0).any(), f"{case}: nothing drawn"
        assert set(full) == set(split)
        for k in full:
            np.testing.assert_array_equal(full[k], split[k],
                                          err_msg=f"output {k} differs under split")
