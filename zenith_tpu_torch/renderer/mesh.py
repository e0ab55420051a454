"""MeshRenderer — textured forward pass with depth + Blinn-Phong (torch port
of zenith_tpu/renderer/mesh.py).

BASELINE.md config #2: "Textured mesh (cerberus) + depth test + Blinn-Phong,
single forward pass". The feature-renderer shape of TriangleRenderer (owns
buffers and shaders, declares one graph node via render_to) with a camera, a
depth attachment, a directional light and an optional base-colour texture.
Its one ``draw_indexed`` rasterizes through kernel K1.

Winding: with the Vulkan clip-space Y flip baked into the camera's
render_view_projection, glTF meshes keep their COUNTER_CLOCKWISE front faces
with BACK culling.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from zenith_tpu_torch.asset.render_types import Mesh as MeshAsset, Vertex as VERTEX_LAYOUT
from zenith_tpu_torch.core.camera import Camera
from zenith_tpu_torch.ops.sampling import sample_2d
from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.rendergraph.resource import RenderGraphResource
from zenith_tpu_torch.rhi import (
    BufferUsage,
    ColorAttachmentDesc,
    CullMode,
    FrontFace,
    GraphicShaderInput,
    RasterizationState,
    Shader,
    Texture,
    attr,
    sampler as sampler_binding,
    texture2d,
    uniform,
)
from zenith_tpu_torch.rhi.device import RenderDevice
from zenith_tpu_torch.rhi.sampler import SamplerConfig
from zenith_tpu_torch.rhi.state import DepthStencilDesc, GraphicPipelineState


def _vs(attrs, res):
    """World-space mesh through the camera (infinite reverse-Z)."""
    pos = attrs["position"]
    model = res["Model"]  # (4, 4)
    hom = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
    world = hom @ model.T
    return {
        "position": world @ res["ViewProj"].T,
        "world_pos": world[:, :3],
        # Normal matrix approximated by the model rotation (uniform scale).
        "normal": attrs["normal"] @ model[:3, :3].T,
        "uv": attrs["tex_coord"],
    }


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-8)


def _make_fs(textured: bool):
    def fs(varyings, res, builtins):
        """Blinn-Phong (mesh.py:68-102): ambient + diffuse + specular from
        one directional light, albedo = base-colour factor × the optional
        texture."""
        n = _normalize(varyings["normal"])
        # Two-sided normal flip for back faces.
        n = torch.where(builtins.front_facing[..., None], n, -n)

        light_dir = res["LightDir"]  # (3,) direction TOWARD the light
        light_color = res["LightColor"]
        ambient = res["Ambient"]
        albedo = res["BaseColor"][:3].expand(n.shape)
        if textured:
            albedo = albedo * sample_2d(res["BaseColorTex"], varyings["uv"],
                                        res["BaseColorSampler"])[..., :3]

        l = light_dir / torch.linalg.vector_norm(light_dir)
        ndotl = torch.clamp(torch.sum(n * l, dim=-1, keepdim=True), min=0.0)
        v = _normalize(res["CameraPos"] - varyings["world_pos"])
        h = _normalize(l + v)
        spec = torch.pow(torch.clamp(torch.sum(n * h, dim=-1, keepdim=True), min=0.0), 32.0)
        color = albedo * (ambient + light_color * ndotl) + light_color * spec * 0.25
        return torch.cat([color, torch.ones_like(color[..., :1])], dim=-1)

    return fs


class MeshRenderer:
    """Forward Blinn-Phong renderer for one mesh asset (mesh.py:105-214)."""

    def __init__(
        self,
        device: RenderDevice,
        mesh: MeshAsset,
        base_color_factor=(1.0, 1.0, 1.0, 1.0),
        base_color_texture: "Optional[Texture]" = None,
        model_matrix: "Optional[np.ndarray]" = None,
        bin_capacity: int = 1024,
    ):
        self.vertex_buffer = device.upload_buffer(f"{mesh.url}.vb", mesh.vertices,
                                                  BufferUsage.VERTEX)
        self.index_buffer = device.upload_buffer(f"{mesh.url}.ib", mesh.indices,
                                                 BufferUsage.INDEX)
        self.base_color_factor = np.asarray(base_color_factor, np.float32)
        self.base_color_texture = base_color_texture
        self.model_matrix = (np.asarray(model_matrix, np.float32) if model_matrix is not None
                             else np.eye(4, dtype=np.float32))
        self.bin_capacity = bin_capacity
        self.num_triangles = mesh.num_triangles

        textured = base_color_texture is not None
        bindings = [
            uniform("Model"), uniform("ViewProj"), uniform("LightDir"),
            uniform("LightColor"), uniform("Ambient"), uniform("CameraPos"),
            uniform("BaseColor"),
        ]
        if textured:
            bindings += [texture2d("BaseColorTex"), sampler_binding("BaseColorSampler")]
        self.vertex_shader = Shader.vertex(
            "mesh.vs", _vs, bindings=[uniform("Model"), uniform("ViewProj")],
            inputs=[attr("position", 3), attr("normal", 3), attr("tex_coord", 2)],
        )
        self.fragment_shader = Shader.fragment("mesh.fs", _make_fs(textured), bindings=bindings)
        self._textured = textured

    def render_to(
        self,
        builder: RenderGraphBuilder,
        output: RenderGraphResource,
        depth: RenderGraphResource,
        camera: Camera,
        light_dir=(0.3, -0.5, 0.8),
        light_color=(1.0, 1.0, 1.0),
        ambient=(0.08, 0.08, 0.1),
        clear_color=(0.05, 0.06, 0.08, 1.0),
        load_color: bool = False,
    ) -> None:
        vb = builder.import_resource(self.vertex_buffer)
        ib = builder.import_resource(self.index_buffer)
        tex = builder.import_resource(self.base_color_texture) if self._textured else None

        builder.set_dynamic("mesh.model", self.model_matrix)
        builder.set_dynamic("mesh.view_proj", camera.render_view_projection)
        builder.set_dynamic("mesh.camera_pos", camera.location)
        builder.set_dynamic("mesh.light_dir", np.asarray(light_dir, np.float32))
        builder.set_dynamic("mesh.light_color", np.asarray(light_color, np.float32))
        builder.set_dynamic("mesh.ambient", np.asarray(ambient, np.float32))
        builder.set_dynamic("mesh.base_color", self.base_color_factor)

        node = builder.add_graphic_node("mesh.forward")
        vba = node.read(vb)
        iba = node.read(ib)
        texa = node.read(tex) if tex is not None else None
        rt = node.write(output)
        ds = node.write(depth)

        shader = GraphicShaderInput(self.vertex_shader, self.fragment_shader, VERTEX_LAYOUT)
        state = GraphicPipelineState(
            rasterization=RasterizationState(
                cull_mode=CullMode.BACK, front_face=FrontFace.COUNTER_CLOCKWISE
            )
        )
        color_desc = ColorAttachmentDesc(clear_value=tuple(clear_color))
        if load_color:
            color_desc = color_desc.load_input()
        with node.pipeline(shader, state) as binder:
            binder.push_color(rt, color_desc)
            binder.set_depth(ds, DepthStencilDesc().reverse_z())

        bin_capacity = self.bin_capacity

        def record(ctx):
            ctx.bind("Model", ctx.dynamic("mesh.model"))
            ctx.bind("ViewProj", ctx.dynamic("mesh.view_proj"))
            ctx.bind("CameraPos", ctx.dynamic("mesh.camera_pos"))
            ctx.bind("LightDir", ctx.dynamic("mesh.light_dir"))
            ctx.bind("LightColor", ctx.dynamic("mesh.light_color"))
            ctx.bind("Ambient", ctx.dynamic("mesh.ambient"))
            ctx.bind("BaseColor", ctx.dynamic("mesh.base_color"))
            if texa is not None:
                ctx.bind("BaseColorTex", ctx.get(texa))
                ctx.bind("BaseColorSampler", SamplerConfig.linear())
            ctx.draw_indexed(vba, iba, bin_capacity=bin_capacity)

        node.execute(record)
