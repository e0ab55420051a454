"""Translucency end to end on the port (tests/test_blend_e2e.py's one
case): the ``ColorAttachmentDesc.translucent()`` preset through a
two-node render graph at 128×32 (8×128 tiles): an opaque red triangle,
then a translucent node with the depth test on and depth writes off that
draws a blue pane in front of it and a green one behind it.

The case asserts on the port what the reference's asserts: blue at alpha
0.5 over red with SRC_ALPHA / DST_ALPHA blending gives (1, 0, 0.5) at the
centre, the green pane is depth-tested away there and shows elsewhere.
test_torch_blend_batch.py holds the port's blend paths against the
reference package's, so no JAX frame is built here.

Tolerance: the reference's (atol 1e-5).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
from zenith_tpu_torch.rhi import (
    Buffer,
    ColorAttachmentDesc,
    CompareOp,
    CullMode,
    GraphicShaderInput,
    LoadOp,
    PipelineCache,
    RasterizationState,
    RhiCore,
    Shader,
    TextureDesc,
    VertexLayout,
)
from zenith_tpu_torch.rhi.state import DepthStencilDesc, GraphicPipelineState

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 32
OPTS = CompileOptions(tile_h=8, tile_w=128)


def _vs(attrs, res):
    p = attrs["position"]
    return {"position": torch.cat([p, torch.ones_like(p[:, :1])], 1), "rgba": attrs["rgba"]}


def _fs(varyings, res, builtins):
    return varyings["rgba"]


LAYOUT = VertexLayout.from_fields(("position", 3), ("rgba", 4))
VS = Shader.vertex("b.vs", _vs)
FS = Shader.fragment("b.fs", _fs)


def tri_buf(z, rgba, scale=0.5, dx=0.0):
    return np.array([[dx, -scale, z, *rgba], [dx + scale, scale, z, *rgba],
                     [dx - scale, scale, z, *rgba]], np.float32)


def test_src_alpha_blend_over_opaque():
    device = RhiCore(CPU).create_render_device()
    opaque = Buffer.from_numpy("opq", tri_buf(0.5, (1.0, 0.0, 0.0, 1.0), 0.7), device=CPU)
    glass = Buffer.from_numpy("gls", tri_buf(0.8, (0.0, 0.0, 1.0, 0.5), 0.4), device=CPU)
    # Offset left, so part of it sticks out from behind the opaque triangle.
    behind = Buffer.from_numpy("bhd", tri_buf(0.2, (0.0, 1.0, 0.0, 0.5), 0.3, dx=-0.75),
                               device=CPU)
    ib = Buffer.from_numpy("ib", np.array([0, 1, 2], np.int32), device=CPU)

    builder = RenderGraphBuilder()
    opq_r, gls_r, bhd_r, ib_r = (builder.import_resource(b) for b in (opaque, glass, behind, ib))
    color = builder.create(TextureDesc.color("rt", W, H))
    depth = builder.create(TextureDesc.depth("ds", W, H))
    builder.export(color)

    node = builder.add_graphic_node("opaque")
    oa, ia = node.read(opq_r), node.read(ib_r)
    rt, ds = node.write(color), node.write(depth)
    state_opaque = GraphicPipelineState(rasterization=RasterizationState(cull_mode=CullMode.NONE))
    with node.pipeline(GraphicShaderInput(VS, FS, LAYOUT), state_opaque) as b:
        b.push_color(rt, ColorAttachmentDesc(clear_value=(0, 0, 0, 1)))
        b.set_depth(ds, DepthStencilDesc().reverse_z())
    node.execute(lambda ctx, oa=oa, ia=ia: ctx.draw_indexed(oa, ia, bin_capacity=8))

    # The translucent pass: test on, write off, the translucent() preset
    # (DST_ALPHA for the destination colour: additive-over at dst alpha 1).
    node2 = builder.add_graphic_node("translucent")
    ga, ia2, ba = node2.read(gls_r), node2.read(ib_r), node2.read(bhd_r)
    rt2, ds2 = node2.write(color), node2.write(depth)
    trans_state = GraphicPipelineState(
        rasterization=RasterizationState(cull_mode=CullMode.NONE),
        depth_stencil=DepthStencilDesc(depth_test_enable=True, depth_write_enable=False,
                                       depth_compare_op=CompareOp.GREATER,
                                       depth_load_op=LoadOp.LOAD))
    with node2.pipeline(GraphicShaderInput(VS, FS, LAYOUT), trans_state) as b:
        b.push_color(rt2, ColorAttachmentDesc().translucent().load_input())
        b.set_depth(ds2, trans_state.depth_stencil)

    def record2(ctx):
        ctx.draw_indexed(ga, ia2, bin_capacity=8)  # in front of the opaque one: blends
        ctx.draw_indexed(ba, ia2, bin_capacity=8)  # behind it: depth-tested away there

    node2.execute(record2)
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    img = compiled.value(color).numpy()

    center = img[H // 2, W // 2]
    # rgb = 0.5·blue + 1.0·red → (1, 0, 0.5).
    np.testing.assert_allclose(center[:3], [1.0, 0.0, 0.5], atol=1e-5)
    assert center[1] == pytest.approx(0.0, abs=1e-5)  # no green through the centre
    assert (img[..., 1] > 0.05).any()  # green shows where only background lies
