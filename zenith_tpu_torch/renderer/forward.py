"""Forward renderer with a shadow-map pass — BASELINE.md config #3,
"Multi-pass rendergraph: shadow-map pass + forward lit pass" (torch port of
zenith_tpu/renderer/forward.py).

Graph nodes:
1. ``shadow``: depth only, every plain object from the sun's orthographic
   camera in one batched draw over kernel K1 (regular Z, LESS, cleared to
   1.0); ``shadow.inst`` LOADs it and adds the instanced objects, one
   instanced ``draw_indexed`` each.
2. ``forward``: Blinn-Phong over the main camera with reverse-Z depth, each
   fragment sampling the shadow map with 2×2 PCF, bias and normal offset.
   ``msaa`` > 1 rasterizes it once per sample (K1 at each standard
   position) and the graph resolves it for its consumers; ``wireframe``
   draws it in LINE polygon mode. ``forward.inst`` LOADs colour and depth
   (per sample under MSAA) and adds the instanced objects.

The shadow map is read by the forward node directly: the stream orders the
passes. Under an SPMD mesh both forward nodes read it whole
(``ctx.get_full``). The ``forward`` node carries the band hint of the
``auto`` mode (``scene.band_hint_for``), evaluated only by such a compile.

The module also holds the helpers the deferred renderer shares: the sun's
light camera, the shadow vertex stages, the shadow compare sampler and the
per-frame camera dynamics.
"""

from __future__ import annotations

from dataclasses import replace as _dc_replace

import numpy as np
import torch

from zenith_tpu_torch.asset.render_types import Vertex as VERTEX_LAYOUT
from zenith_tpu_torch.core import mathtypes as m
from zenith_tpu_torch.core.camera import Camera
from zenith_tpu_torch.ops.sampling import sample_shadow_pcf
from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.rendergraph.resource import RenderGraphResource
from zenith_tpu_torch.renderer.scene import DirectionalLight, Scene, band_hint_for, stacked_models
from zenith_tpu_torch.renderer.static_batch import StaticGeometryCache
from zenith_tpu_torch.rhi import (
    ColorAttachmentDesc,
    CullMode,
    FrontFace,
    GraphicShaderInput,
    RasterizationState,
    Shader,
    TextureDesc,
    attr,
    texture2d,
    uniform,
)
from zenith_tpu_torch.rhi.sampler import AddressMode, BorderColor, SamplerConfig
from zenith_tpu_torch.rhi.state import (
    CompareOp,
    DepthStencilDesc,
    GraphicPipelineState,
    LoadOp,
    MultisampleState,
    PolygonMode,
)


def sun_view_projection(sun: DirectionalLight) -> np.ndarray:
    """Orthographic light camera looking along -direction at the origin
    (forward.py:53-70), memoized per sun field values."""
    d = tuple(float(x) for x in np.asarray(sun.direction).reshape(-1))
    key = (d, float(sun.shadow_near), float(sun.shadow_far),
           float(sun.shadow_extent))
    cached = getattr(sun, "_svp_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    out = _sun_view_projection(sun)
    object.__setattr__(sun, "_svp_cache", (key, out))
    return out


def _sun_view_projection(sun: DirectionalLight) -> np.ndarray:
    d = m.normalize(np.asarray(sun.direction, np.float32))
    eye = d * (0.5 * (sun.shadow_near + sun.shadow_far))
    up = np.array([0, 0, 1], np.float32)
    if abs(float(np.dot(d, up))) > 0.95:
        up = np.array([0, 1, 0], np.float32)
    view = m.look_to_rh(eye, -d, up)
    e = sun.shadow_extent
    proj = m.orthographic_rh(-e, e, -e, e, sun.shadow_near, sun.shadow_far)
    # Same Vulkan Y flip as the main camera (render and sample agree).
    return (m.VULKAN_Y_FLIP @ proj @ view).astype(np.float32)


def _homogeneous(pos: torch.Tensor) -> torch.Tensor:
    return torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)


def _shadow_vs(attrs, res):
    world = _homogeneous(attrs["position"]) @ res["Model"].T
    return {"position": world @ res["LightViewProj"].T}


def _forward_vs(attrs, res):
    world = _homogeneous(attrs["position"]) @ res["Model"].T
    return {
        "position": world @ res["ViewProj"].T,
        "world_pos": world[:, :3],
        "normal": attrs["normal"] @ res["Model"][:3, :3].T,
        "uv": attrs["tex_coord"],
    }


def _shadow_inst_vs(attrs, res):
    world = _homogeneous(attrs["position"]) @ res["Model"].T
    world_pos = world[:, :3] + attrs["inst_offset"]
    clip_hom = torch.cat([world_pos, world[:, 3:4]], dim=1)
    return {"position": clip_hom @ res["LightViewProj"].T}


def _forward_inst_vs(attrs, res):
    """Instanced forward vertex stage: a per-instance world-space offset."""
    world = _homogeneous(attrs["position"]) @ res["Model"].T
    world_pos = world[:, :3] + attrs["inst_offset"]
    clip_hom = torch.cat([world_pos, world[:, 3:4]], dim=1)
    return {
        "position": clip_hom @ res["ViewProj"].T,
        "world_pos": world_pos,
        "normal": attrs["normal"] @ res["Model"][:3, :3].T,
        "uv": attrs["tex_coord"],
    }


def _normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


def _forward_fs(varyings, res, builtins):
    """Blinn-Phong under the sun with PCF shadows (forward.py:133-171)."""
    n = _normalize(varyings["normal"])
    n = torch.where(builtins.front_facing[..., None], n, -n)
    world = varyings["world_pos"]

    light = res["LightDir"]
    light = light / torch.linalg.vector_norm(light)
    ndotl = torch.clamp(torch.sum(n * light, dim=-1, keepdim=True), min=0.0)

    # Shadow test: project into the light's clip space, offset along the
    # normal by about a shadow texel (normal-offset sampling removes acne on
    # faces steep in light space, where a constant bias cannot).
    sample_pos = world + n * res["ShadowNormalOffset"]
    hom = torch.cat([sample_pos, torch.ones_like(world[..., :1])], dim=-1)
    light_clip = hom @ res["LightViewProj"].T  # orthographic: w == 1
    uv = torch.stack([(light_clip[..., 0] + 1.0) * 0.5, (light_clip[..., 1] + 1.0) * 0.5], -1)
    ref = light_clip[..., 2] - res["ShadowBias"]
    lit = sample_shadow_pcf(res["ShadowMap"], uv, ref, _SHADOW_SAMPLER)
    # Outside the shadow frustum: fully lit.
    inside = ((uv[..., 0] >= 0.0) & (uv[..., 0] <= 1.0)
              & (uv[..., 1] >= 0.0) & (uv[..., 1] <= 1.0))
    lit = torch.where(inside, lit, torch.ones_like(lit))[..., None]

    v = _normalize(res["CameraPos"] - world)
    h = _normalize(light + v)
    spec = torch.pow(torch.clamp(torch.sum(n * h, dim=-1, keepdim=True), min=0.0), 32.0)

    albedo = res["BaseColor"][..., :3].expand(n.shape)
    direct = res["LightColor"] * ndotl * lit
    color = albedo * (res["Ambient"] + direct) + res["LightColor"] * spec * 0.25 * lit
    return torch.cat([color, torch.ones_like(color[..., :1])], dim=-1)


# PCF compare for regular-Z shadow maps: a fragment is lit when its light
# depth (minus bias) is <= the stored nearest-occluder depth.
_SHADOW_SAMPLER = SamplerConfig(
    address_mode_u=AddressMode.CLAMP_TO_EDGE,
    address_mode_v=AddressMode.CLAMP_TO_EDGE,
    compare_enable=True,
    compare_op=CompareOp.LESS_OR_EQUAL,
    border_color=BorderColor.OPAQUE_WHITE,
)


class ForwardShadowRenderer:
    """Shadow pass + forward lit pass over a Scene (forward.py:187-544)."""

    def __init__(self, scene: Scene, wireframe: bool = False, msaa: int = 1,
                 sample_shading: bool = True):
        """``msaa``: the lit pass's sample count (1/2/4/8); the shadow pass
        stays single-sample, and consumers read the resolved surface.
        ``sample_shading`` is MultisampleState's: the batched plain draw
        shades per sample either way, the instanced draws shade once per
        pixel when it is off."""
        self.scene = scene
        self.wireframe = wireframe
        self.msaa = msaa
        self._static_cache = StaticGeometryCache()
        self.shadow_vs = Shader.vertex(
            "shadow.vs", _shadow_vs,
            bindings=[uniform("Model"), uniform("LightViewProj")],
            inputs=[attr("position", 3)],
        )
        self.forward_vs = Shader.vertex(
            "forward.vs", _forward_vs,
            bindings=[uniform("Model"), uniform("ViewProj")],
            inputs=[attr("position", 3), attr("normal", 3), attr("tex_coord", 2)],
        )
        self.shadow_inst_vs = Shader.vertex(
            "fwd.shadow.inst.vs", _shadow_inst_vs,
            bindings=[uniform("Model"), uniform("LightViewProj")],
            inputs=[attr("position", 3), attr("inst_offset", 3, per_instance=True)],
        )
        self.forward_inst_vs = Shader.vertex(
            "forward.inst.vs", _forward_inst_vs,
            bindings=[uniform("Model"), uniform("ViewProj")],
            inputs=[attr("position", 3), attr("normal", 3), attr("tex_coord", 2),
                    attr("inst_offset", 3, per_instance=True)],
        )
        self.forward_fs = Shader.fragment(
            "forward.fs", _forward_fs,
            bindings=[
                uniform("LightDir"), uniform("LightColor"), uniform("Ambient"),
                uniform("CameraPos"), uniform("BaseColor"),
                uniform("LightViewProj"), uniform("ShadowBias"),
                uniform("ShadowNormalOffset"), texture2d("ShadowMap"),
            ],
        )
        # Frame-invariant pipeline inputs, built once: render_to runs every
        # frame, and the same desc objects keep the structure key and the
        # pipeline cache on their identity fast paths.
        self._shadow_si = GraphicShaderInput(self.shadow_vs, None, VERTEX_LAYOUT)
        self._shadow_inst_si = GraphicShaderInput(self.shadow_inst_vs, None, VERTEX_LAYOUT)
        self._forward_si = GraphicShaderInput(self.forward_vs, self.forward_fs, VERTEX_LAYOUT)
        self._forward_inst_si = GraphicShaderInput(
            self.forward_inst_vs, self.forward_fs, VERTEX_LAYOUT)
        self._shadow_state = GraphicPipelineState(
            rasterization=RasterizationState(
                cull_mode=CullMode.NONE, front_face=FrontFace.CLOCKWISE)
        )
        # The wireframe view puts the lit pass alone in LINE polygon mode
        # (the shadow pass stays FILL, so shadows stay solid); the lines go
        # through the same lit fragment shader.
        self._forward_state = GraphicPipelineState(
            rasterization=RasterizationState(
                cull_mode=CullMode.BACK, front_face=FrontFace.COUNTER_CLOCKWISE,
                polygon_mode=PolygonMode.LINE if wireframe else PolygonMode.FILL,
            ),
            multisample=MultisampleState(samples=msaa, sample_shading=sample_shading),
        )
        self._shadow_depth = DepthStencilDesc(
            depth_test_enable=True,
            depth_write_enable=True,
            depth_compare_op=CompareOp.LESS,
            depth_clear_value=1.0,
        )
        self._shadow_depth_load = _dc_replace(self._shadow_depth, depth_load_op=LoadOp.LOAD)
        self._forward_depth = DepthStencilDesc().reverse_z()
        self._forward_depth_load = _dc_replace(self._forward_depth, depth_load_op=LoadOp.LOAD)
        self._ca_load = ColorAttachmentDesc(load_op=LoadOp.LOAD)

    def frame_dynamics(self, camera: Camera, include_models: bool = False) -> dict:
        """Per-frame dynamic values for RETAINED execution (everything else
        this renderer declares is static per scene). Pass
        ``include_models=True`` when objects move or toggle
        ``SceneObject.visible`` between retained frames."""
        d = _camera_dynamics("fwd", camera, want_inv_vp=False)
        if include_models:
            d["fwd.models"] = stacked_models(self.scene.objects)
        return d

    def render_to(
        self,
        builder: RenderGraphBuilder,
        output: RenderGraphResource,
        depth: RenderGraphResource,
        camera: Camera,
        clear_color=(0.05, 0.06, 0.08, 1.0),
    ) -> None:
        scene = self.scene
        sun = scene.sun or DirectionalLight(cast_shadows=False)
        size = sun.shadow_map_size

        builder.set_dynamic("fwd.view_proj", camera.render_view_projection)
        builder.set_dynamic("fwd.camera_pos", camera.location)
        builder.set_dynamic("fwd.light_vp", sun_view_projection(sun))
        builder.set_dynamic("fwd.light_dir", m.normalize(np.asarray(sun.direction, np.float32)))
        builder.set_dynamic("fwd.light_color", np.asarray(sun.color, np.float32) * sun.intensity)
        builder.set_dynamic("fwd.ambient", np.asarray(scene.ambient, np.float32))
        builder.set_dynamic("fwd.shadow_bias", np.float32(sun.shadow_bias))
        builder.set_dynamic("fwd.shadow_noffs", np.float32(sun.effective_normal_offset))
        # One dynamic per field, stacked over the objects; the record
        # closures take their draw's row.
        builder.set_dynamic("fwd.models", stacked_models(scene.objects))
        builder.set_dynamic("fwd.base_colors",
                            np.stack([o.base_color_array() for o in scene.objects]))
        for obj in scene.objects:
            if obj.instance_offsets is not None:
                # Device-resident offsets pass through untouched (a host copy
                # would wait for the card every frame).
                offs = obj.instance_offsets
                builder.set_dynamic(f"fwd.inst.{obj.name}",
                                    offs if isinstance(offs, torch.Tensor)
                                    else np.asarray(offs, np.float32))
        objects = scene.objects
        plain_ix = [i for i, o in enumerate(objects) if o.instance_offsets is None]
        inst_ix = [i for i, o in enumerate(objects) if o.instance_offsets is not None]

        # Static batching (renderer/static_batch.py): the plain draws share
        # one concatenated buffer pair.
        static_geo = self._static_cache.get(objects, plain_ix)
        per_obj_ix = inst_ix if static_geo is not None else plain_ix + inst_ix
        handles = {
            i: (builder.import_resource(objects[i].vertex_buffer),
                builder.import_resource(objects[i].index_buffer))
            for i in per_obj_ix
        }
        if static_geo is not None:
            s_vb_h = builder.import_resource(static_geo.vb)
            s_ib_h = builder.import_resource(static_geo.ib)

        def geometry_reads(node):
            if static_geo is None:
                return {i: (node.read(handles[i][0]), node.read(handles[i][1]))
                        for i in plain_ix}, None
            return None, (node.read(s_vb_h), node.read(s_ib_h))

        def plain_draws(ctx, accesses, s_acc, extra):
            """(vb, ib, res) per plain object: static-batch slices or
            per-object buffers; ``extra(i)`` adds the per-draw uniforms."""
            models = ctx.dynamic("fwd.models")
            if static_geo is not None:
                vb_all, ib_all = ctx.get(s_acc[0]), ctx.get(s_acc[1])
                return [
                    (vb_all[vo:vo + vc], ib_all[io_:io_ + ic], {"Model": models[i], **extra(i)})
                    for i, (vo, vc, io_, ic) in zip(plain_ix, static_geo.ranges)
                ]
            return [(accesses[i][0], accesses[i][1], {"Model": models[i], **extra(i)})
                    for i in plain_ix]

        def instanced_draws(ctx, accesses, extra):
            """One instanced draw_indexed per instanced object."""
            models = ctx.dynamic("fwd.models")
            for i in inst_ix:
                obj = objects[i]
                ctx.draw_indexed(
                    accesses[i][0], accesses[i][1], {"Model": models[i], **extra(i)},
                    instance_count=obj.instance_count,
                    instance_data={"inst_offset": ctx.dynamic(f"fwd.inst.{obj.name}")},
                )

        shadow_map = builder.create(TextureDesc.depth("sun.shadow", size, size))

        # -- node 1: shadow (depth only) ------------------------------------
        node = builder.add_graphic_node("shadow")
        accesses, s_acc = geometry_reads(node)
        sm = node.write(shadow_map)
        with node.pipeline(self._shadow_si, self._shadow_state) as binder:
            binder.set_depth(sm, self._shadow_depth)

        def record_shadow(ctx, accesses=accesses, s_acc=s_acc):
            ctx.bind("LightViewProj", ctx.dynamic("fwd.light_vp"))
            if plain_ix:  # an all-instanced scene clears only
                ctx.draw_indexed_batch(plain_draws(ctx, accesses, s_acc, lambda i: {}))

        node.execute(record_shadow)

        if inst_ix:
            node = builder.add_graphic_node("shadow.inst")
            sh_inst_acc = {i: (node.read(handles[i][0]), node.read(handles[i][1]))
                           for i in inst_ix}
            node.read(shadow_map)
            sm2 = node.write(shadow_map)
            with node.pipeline(self._shadow_inst_si, self._shadow_state) as binder:
                binder.set_depth(sm2, self._shadow_depth_load)

            def record_shadow_inst(ctx):
                ctx.bind("LightViewProj", ctx.dynamic("fwd.light_vp"))
                instanced_draws(ctx, sh_inst_acc, lambda i: {})

            node.execute(record_shadow_inst)

        def bind_lighting(ctx, sm_read):
            ctx.bind("ViewProj", ctx.dynamic("fwd.view_proj"))
            ctx.bind("CameraPos", ctx.dynamic("fwd.camera_pos"))
            ctx.bind("LightDir", ctx.dynamic("fwd.light_dir"))
            ctx.bind("LightColor", ctx.dynamic("fwd.light_color"))
            ctx.bind("Ambient", ctx.dynamic("fwd.ambient"))
            ctx.bind("LightViewProj", ctx.dynamic("fwd.light_vp"))
            ctx.bind("ShadowBias", ctx.dynamic("fwd.shadow_bias"))
            ctx.bind("ShadowNormalOffset", ctx.dynamic("fwd.shadow_noffs"))
            ctx.bind("ShadowMap", ctx.get_full(sm_read))
            bcs = ctx.dynamic("fwd.base_colors")
            return lambda i: {"BaseColor": bcs[i]}

        # -- node 2: forward lit --------------------------------------------
        node2 = builder.add_graphic_node("forward")
        # The SPMD auto-decomposition hint, lazy (forward.py:438-443).
        node2.set_band_hint(lambda objs=objects, ixs=tuple(plain_ix), cam=camera:
                            band_hint_for(objs, ixs, cam))
        accesses2, s_acc2 = geometry_reads(node2)
        sm_read = node2.read(shadow_map)
        rt = node2.write(output)
        ds = node2.write(depth)
        with node2.pipeline(self._forward_si, self._forward_state) as binder:
            binder.push_color(rt, ColorAttachmentDesc(clear_value=tuple(clear_color)))
            binder.set_depth(ds, self._forward_depth)

        def record_forward(ctx, accesses=accesses2, s_acc=s_acc2):
            material = bind_lighting(ctx, sm_read)
            if plain_ix:  # an all-instanced scene clears only
                ctx.draw_indexed_batch(plain_draws(ctx, accesses, s_acc, material),
                                       per_draw_uniforms=("BaseColor",))

        node2.execute(record_forward)

        if inst_ix:
            node3 = builder.add_graphic_node("forward.inst")
            fw_inst_acc = {i: (node3.read(handles[i][0]), node3.read(handles[i][1]))
                           for i in inst_ix}
            sm_read3 = node3.read(shadow_map)
            node3.read(output)
            node3.read(depth)
            rt3 = node3.write(output)
            ds3 = node3.write(depth)
            with node3.pipeline(self._forward_inst_si, self._forward_state) as binder:
                binder.push_color(rt3, self._ca_load)
                binder.set_depth(ds3, self._forward_depth_load)

            def record_forward_inst(ctx):
                instanced_draws(ctx, fw_inst_acc, bind_lighting(ctx, sm_read3))

            node3.execute(record_forward_inst)


def _camera_dynamics(prefix: str, camera, want_inv_vp: bool) -> dict:
    vp = np.asarray(camera.render_view_projection, np.float32)
    d = {
        f"{prefix}.view_proj": vp,
        f"{prefix}.camera_pos": np.asarray(camera.location, np.float32),
    }
    if want_inv_vp:
        d[f"{prefix}.inv_vp"] = camera.render_inv_view_projection
    return d
