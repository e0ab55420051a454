"""Textured and instanced translucency on the port
(tests/test_glass_textured.py's seven cases): texture content reaches the
in-order blend path by vertex-rate sampling (the interpolated tint
varying), and instanced translucent draws ride the blend batch's per-draw
instancing. Through the port's DeferredRenderer at 128×96 (16×64 tiles):
a constant glass texture equals the untextured pane of the product
colour, a gradient texture varies across the pane, two textured panes in
one batched blend draw composite in submission order, an instanced pane
equals separate panes, and instanced textured panes both show the
texture; through ``ops.draw.draw_indexed_batch`` at 128×32: one instanced
blended draw equals its instances drawn as separate draws, and an
instanced opaque batch draw equals the triangle drawn once.

Each case asserts on the port what the reference's asserts.
test_torch_glass.py holds the port's glass frames (textured glass
included, in kernel, peel and auto modes) against the reference
package's, and test_torch_blend_batch.py the instanced blend batch, so no
JAX frame is built here.

Tolerances: the reference's own.
"""

from __future__ import annotations

import numpy as np
import torch

from zenith_tpu_torch.core.camera import Camera
from zenith_tpu_torch.core.mathtypes import Degree
from zenith_tpu_torch.ops.binning import TileGrid
from zenith_tpu_torch.ops.draw import draw_indexed_batch
from zenith_tpu_torch.renderer import DeferredRenderer
from zenith_tpu_torch.renderer.scene import DirectionalLight, Scene, SceneObject
from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.rendergraph.graph import CompileOptions
from zenith_tpu_torch.rhi import (
    ColorAttachmentDesc,
    Format,
    GraphicPipelineAttachments,
    GraphicShaderInput,
    PipelineCache,
    RhiCore,
    Shader,
    TextureDesc,
    attr,
)
from zenith_tpu_torch.rhi.pipeline import GraphicPipeline, GraphicPipelineDesc
from zenith_tpu_torch.rhi.resource import Texture
from zenith_tpu_torch.rhi.state import (
    CompareOp,
    CullMode,
    DepthStencilDesc,
    GraphicPipelineState,
    RasterizationState,
    VertexLayout,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 96


def _camera():
    cam = Camera(fov_y=Degree(45.0), aspect_ratio=W / H)
    cam.set_position(np.array([0.0, -30.0, 5.0], np.float32))
    return cam


def _render(device, scene):
    r = DeferredRenderer(scene, shadows=False)
    builder = RenderGraphBuilder()
    out = builder.create(TextureDesc.color("hdr", W, H))
    r.render_to(builder, out, _camera(), W, H)
    builder.export(out)
    compiled = builder.build().compile(device, PipelineCache(),
                                       CompileOptions(tile_h=16, tile_w=64))
    compiled.execute(device)
    return compiled.value(out).numpy()


def _const_tex(name, rgba):
    px = np.broadcast_to(np.asarray(rgba, np.float32), (4, 4, 4)).copy()
    return Texture.from_numpy(name, px, Format.RGBA32F, device=CPU)


def _moved(m03=0.0, m13=0.0):
    m = np.eye(4, dtype=np.float32)
    m[0, 3], m[1, 3] = m03, m13
    return m


def _sun():
    return DirectionalLight(cast_shadows=False)


class TestTexturedGlass:
    def test_constant_texture_equals_scaled_base_color(self):
        """A constant glass texture blends exactly like an untextured pane
        whose base colour is the componentwise product (vertex-rate sampling
        of a constant is exact)."""
        device = RhiCore(CPU).create_render_device()
        base, texc = (0.5, 0.6, 0.7, 0.5), (0.8, 0.4, 0.2, 1.0)

        def scene(textured: bool):
            floor = SceneObject.cube(device, "floor", size=6.0)
            pane = SceneObject.cube(device, "pane", size=8.0)
            pane.model_matrix = _moved(m13=-8.0)  # between the camera and the floor
            pane.translucent = True
            if textured:
                pane.base_color = base
                pane.base_color_texture = _const_tex("glass.const", texc)
            else:
                pane.base_color = tuple(b * t for b, t in zip(base, texc))
            return Scene(objects=[floor, pane], sun=_sun())

        a = _render(device, scene(True))
        b = _render(device, scene(False))
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() < 1e-4
        floor_only = _render(device, Scene(objects=[SceneObject.cube(device, "floor", size=6.0)],
                                           sun=_sun()))
        assert np.abs(a - floor_only).max() > 0.01  # the glass covers pixels

    def test_gradient_texture_varies_across_pane(self):
        """A horizontal gradient texture shows across the glass: the tint
        varying interpolates the per-vertex samples."""
        device = RhiCore(CPU).create_render_device()
        grad = np.ones((4, 64, 4), np.float32)
        grad[..., 0] = np.linspace(0.0, 1.0, 64)[None, :]
        grad[..., 1] = 0.0
        grad[..., 2] = 0.0
        floor = SceneObject.cube(device, "floor", size=6.0)
        pane = SceneObject.cube(device, "pane", size=8.0)
        pane.model_matrix = _moved(m13=-8.0)
        pane.translucent = True
        pane.base_color = (1.0, 1.0, 1.0, 0.9)
        pane.base_color_texture = Texture.from_numpy("glass.grad", grad, Format.RGBA32F,
                                                     device=CPU)
        img = _render(device, Scene(objects=[floor, pane], sun=_sun()))
        assert np.isfinite(img).all()
        reds = img[H // 2][:, 0]  # red rises left to right on the pane's rows
        assert reds.max() - reds.min() > 0.05

    def test_two_textured_panes_blend_in_submission_order(self):
        """Two overlapping textured panes in one batched blend draw
        composite in submission order, each with its own texture."""
        device = RhiCore(CPU).create_render_device()

        def scene(swap: bool):
            floor = SceneObject.cube(device, "floor", size=6.0)
            p1 = SceneObject.cube(device, "p1", size=8.0)
            p2 = SceneObject.cube(device, "p2", size=8.0)
            for p, dy, col in ((p1, -6.0, (1.0, 0.2, 0.2, 0.6)),
                               (p2, -10.0, (0.2, 0.2, 1.0, 0.6))):
                p.model_matrix = _moved(m13=dy)
                p.translucent = True
                p.base_color = (1.0, 1.0, 1.0, 0.6)
                p.base_color_texture = _const_tex(f"t.{p.name}", col)
            return Scene(objects=[floor, p2, p1] if swap else [floor, p1, p2], sun=_sun())

        a = _render(device, scene(False))
        b = _render(device, scene(True))
        # Glass does not write depth, so both panes render; the order
        # changes the composite where they overlap.
        assert np.abs(a - b).max() > 1e-3


class TestInstancedGlass:
    def test_instanced_pane_matches_separate_objects(self):
        device = RhiCore(CPU).create_render_device()

        def scene_instanced():
            floor = SceneObject.cube(device, "floor", size=6.0)
            pane = SceneObject.cube(device, "pane", size=4.0)
            pane.model_matrix = _moved(m13=-8.0)
            pane.translucent = True
            pane.base_color = (0.3, 0.9, 0.4, 0.55)
            pane.instance_offsets = np.array([[-4.0, 0.0, 0.0], [4.0, 0.0, 0.0]], np.float32)
            return Scene(objects=[floor, pane], sun=_sun())

        def scene_separate():
            objs = [SceneObject.cube(device, "floor", size=6.0)]
            for k, dx in enumerate((-4.0, 4.0)):
                p = SceneObject.cube(device, f"pane{k}", size=4.0)
                p.translucent = True
                p.base_color = (0.3, 0.9, 0.4, 0.55)
                p.model_matrix = _moved(m03=dx, m13=-8.0)
                objs.append(p)
            return Scene(objects=objs, sun=_sun())

        a = _render(device, scene_instanced())
        b = _render(device, scene_separate())
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1e-4)

    def test_instanced_textured_glass(self):
        """Instancing and texturing compose: both panes show the texture."""
        device = RhiCore(CPU).create_render_device()
        floor = SceneObject.cube(device, "floor", size=6.0)
        pane = SceneObject.cube(device, "pane", size=4.0)
        pane.model_matrix = _moved(m13=-8.0)
        pane.translucent = True
        pane.base_color = (1.0, 1.0, 1.0, 0.6)
        pane.base_color_texture = _const_tex("t.inst", (1.0, 0.1, 0.1, 1.0))
        pane.instance_offsets = np.array([[-4.0, 0.0, 0.0], [4.0, 0.0, 0.0]], np.float32)
        img = _render(device, Scene(objects=[floor, pane], sun=_sun()))
        assert np.isfinite(img).all()
        assert img[:, : W // 2, 0].max() > 0.1 and img[:, W // 2:, 0].max() > 0.1


class TestOpsInstancedBlend:
    GRID = TileGrid(width=128, height=32, tile_h=8, tile_w=128)

    def test_instanced_blend_equals_expanded_draws(self):
        """One instanced blended draw equals the same geometry submitted as
        per-instance draws (records concatenate in instance order)."""
        layout = VertexLayout.from_fields(("position", 3), ("rgba", 4))

        def vs(attrs, res):
            moved = attrs["position"] + attrs["inst_offset"]
            return {"position": torch.cat([moved, torch.ones_like(moved[:, :1])], 1),
                    "rgba": attrs["rgba"]}

        def vs_plain(attrs, res):
            p = attrs["position"]
            return {"position": torch.cat([p, torch.ones_like(p[:, :1])], 1),
                    "rgba": attrs["rgba"]}

        vsd = Shader.vertex("ti.vs", vs, inputs=[attr("position", 3), attr("rgba", 4),
                                                 attr("inst_offset", 3, per_instance=True)])
        vsd_plain = Shader.vertex("ti.plain.vs", vs_plain,
                                  inputs=[attr("position", 3), attr("rgba", 4)])
        fsd = Shader.fragment("ti.fs", lambda varyings, res, b: varyings["rgba"],
                              kernel_safe=True)

        def pipe(v):
            ds = DepthStencilDesc(depth_test_enable=True, depth_write_enable=False,
                                  depth_compare_op=CompareOp.GREATER)
            return GraphicPipeline(GraphicPipelineDesc(
                shader_input=GraphicShaderInput(v, fsd, layout),
                state=GraphicPipelineState(
                    rasterization=RasterizationState(cull_mode=CullMode.NONE),
                    depth_stencil=ds),
                attachments=GraphicPipelineAttachments(color_formats=(Format.RGBA32F,),
                                                       depth_format=Format.D32F),
                color_attachment_descs=(ColorAttachmentDesc().translucent(),),
                depth_attachment_desc=ds,
            ))

        tri = torch.tensor([[0.0, -0.5, 0.5, 1, 0, 0, 0.6], [0.5, 0.5, 0.5, 1, 0, 0, 0.6],
                            [-0.5, 0.5, 0.5, 1, 0, 0, 0.6]])
        ib = torch.tensor([0, 1, 2], dtype=torch.int32)
        offs = np.array([[-0.2, 0.0, 0.0], [0.2, 0.1, 0.0]], np.float32)

        def run(pipeline, draws):
            colors, _d, _s = draw_indexed_batch([torch.zeros((32, 128, 4))],
                                                torch.zeros((32, 128)), pipeline, draws,
                                                self.GRID)
            return colors[0].numpy()

        instanced = run(pipe(vsd), [(tri, ib, {}, {"instance_count": 2, "instance_data": {
            "inst_offset": torch.from_numpy(offs)}})])
        expanded = []
        for k in range(2):
            moved = tri.clone()
            moved[:, :3] += torch.from_numpy(offs[k])
            expanded.append((moved, ib, {}))
        np.testing.assert_allclose(instanced, run(pipe(vsd_plain), expanded), atol=1e-5)

    def test_instanced_non_blend_batch_supported(self):
        """An instanced opaque batch draw (both instances coincide, no
        instance data) equals the triangle drawn once."""
        layout = VertexLayout.from_fields(("position", 3))

        def vs(attrs, res):
            p = attrs["position"]
            return {"position": torch.cat([p, torch.ones_like(p[:, :1])], 1)}

        def fs(varyings, res, builtins):
            hh, ww = builtins.depth.shape
            return torch.full((hh, ww, 4), 0.5)

        pipe = GraphicPipeline(GraphicPipelineDesc(
            shader_input=GraphicShaderInput(
                Shader.vertex("nb.vs", vs, inputs=[attr("position", 3)]),
                Shader.fragment("nb.fs", fs), layout),
            state=GraphicPipelineState(),
            attachments=GraphicPipelineAttachments(color_formats=(Format.RGBA32F,)),
            color_attachment_descs=(ColorAttachmentDesc(),),
        ))
        tri = torch.tensor([[0.0, -0.5, 0.5], [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5]])
        ib = torch.tensor([0, 1, 2], dtype=torch.int32)
        out_inst, _d, _s = draw_indexed_batch(
            [torch.zeros((32, 128, 4))], None, pipe,
            [(tri, ib, {}, {"instance_count": 2, "instance_data": {}})], self.GRID)
        out_one, _d, _s = draw_indexed_batch([torch.zeros((32, 128, 4))], None, pipe,
                                             [(tri, ib, {})], self.GRID)
        np.testing.assert_allclose(out_inst[0].numpy(), out_one[0].numpy(), atol=1e-6)
