"""Deferred shading — BASELINE.md config #4/#5: G-buffer + lighting with ~100
point lights and a Cook-Torrance GGX BRDF (torch port of
zenith_tpu/renderer/deferred.py, the branches the default scene takes).

Node ``shadow`` (graphic, depth only): the sun's shadow map, every plain
opaque object in one batched draw over kernel K1.

Node ``gbuffer`` (graphic, MRT, one batched draw over K1):
  - albedo+metallic   (RGBA32F: rgb albedo, a metallic)
  - normal+roughness  (RGBA32F: xyz world normal, w roughness)
  - world-pos+emissive-luma (RGBA32F)
  plus reverse-Z depth.

Node ``lighting`` (lambda): full-screen PBR resolve — flat ambient, the sun
with 2×2 PCF shadows, the point/spot-light sum over the tiled kernel K2
(ops.lighting), and the cube-map skybox (or a constant background) where no
surface was drawn.

Not ported yet; each raises NotImplementedError naming its ROADMAP item:
textured materials (atlases, item 13); instanced, skinned and morphed
objects, decals, SSAO, shadow-casting point lights, cascades, VSM, contact
shadows, image-based light, the atmosphere, the velocity plane and the id
buffer (item 21); translucent objects (item 20); the wireframe view
(item 19).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from zenith_tpu_torch.asset.render_types import Vertex as VERTEX_LAYOUT
from zenith_tpu_torch.core import mathtypes as m
from zenith_tpu_torch.core.camera import Camera
from zenith_tpu_torch.ops.lighting import accumulate_point_lights
from zenith_tpu_torch.ops.sampling import sample_cube, sample_shadow_pcf
from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.rendergraph.resource import RenderGraphResource
from zenith_tpu_torch.renderer.forward import (
    _SHADOW_SAMPLER,
    _camera_dynamics,
    _shadow_vs,
    sun_view_projection,
)
from zenith_tpu_torch.renderer.scene import Scene, stacked_models
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
    uniform,
)
from zenith_tpu_torch.rhi.state import (
    CompareOp,
    DepthStencilDesc,
    GraphicPipelineState,
)

class GBufferHandles(dict):
    """The G-buffer plane handles published for screen-space consumers,
    plus advisory flags (deferred.py:68-76)."""

    animated_without_velocity: bool = False


def _unported(what: str, item: int, name: str) -> NotImplementedError:
    return NotImplementedError(
        f"DeferredRenderer: {what} is not ported yet (ROADMAP item {item}: {name})"
    )


def _gbuffer_vs(attrs, res):
    """Plain G-buffer vertex stage (deferred.py:86-99, velocity off)."""
    pos = attrs["position"]
    hom = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
    world = hom @ res["Model"].T
    return {
        "position": world @ res["ViewProj"].T,
        "world_pos": world[:, :3],
        "normal": attrs["normal"] @ res["Model"][:3, :3].T,
        "uv": attrs["tex_coord"],
    }


def _normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


def _gbuffer_fs(varyings, res, builtins):
    """G-buffer fragment stage: deferred.py:276-374's
    ``_make_gbuffer_fs(textured=False)``, with no velocity or id plane."""
    n = _normalize(varyings["normal"])
    n = torch.where(builtins.front_facing[..., None], n, -n)
    # Shape-generic uniform access: (4,) per-draw vectors when drawn
    # individually, dense (H, W, 4) planes under draw_indexed_batch.
    base = res["BaseColor"]
    mat = res["MatParams"]  # (metallic, roughness, emissive_luma, _)
    albedo = base[..., :3].expand(n.shape)
    metallic = mat[..., 0:1].expand(n[..., :1].shape)
    roughness = mat[..., 1:2].expand(n[..., :1].shape)
    emissive = mat[..., 2:3].expand(n[..., :1].shape)
    # MRT outputs in attachment order (draw maps dict keys sorted).
    return {
        "0_albedo": torch.cat([albedo, metallic], dim=-1),
        "1_normal": torch.cat([n, roughness], dim=-1),
        "2_pos": torch.cat([varyings["world_pos"], emissive], dim=-1),
    }


def _ggx_brdf(n, v, l, albedo, metallic, roughness):
    """Cook-Torrance GGX (Trowbridge-Reitz NDF, Smith-Schlick G, Schlick F),
    deferred.py:524-546."""
    h = _normalize(l + v)
    ndl = torch.clamp(torch.sum(n * l, dim=-1, keepdim=True), min=0.0)
    ndv = torch.clamp(torch.sum(n * v, dim=-1, keepdim=True), min=1e-4)
    ndh = torch.clamp(torch.sum(n * h, dim=-1, keepdim=True), min=0.0)
    vdh = torch.clamp(torch.sum(v * h, dim=-1, keepdim=True), min=0.0)

    a = torch.clamp(roughness * roughness, min=1e-3)
    a2 = a * a
    denom = ndh * ndh * (a2 - 1.0) + 1.0
    d = a2 / torch.clamp(math.pi * denom * denom, min=1e-8)

    k = (roughness + 1.0) ** 2 / 8.0
    g = (ndv / (ndv * (1 - k) + k)) * (ndl / torch.clamp(ndl * (1 - k) + k, min=1e-8))

    f0 = 0.04 * (1.0 - metallic) + albedo * metallic
    f = f0 + (1.0 - f0) * torch.pow(1.0 - vdh, 5.0)

    spec = d * g * f / torch.clamp(4.0 * ndv * ndl, min=1e-4)
    kd = (1.0 - f) * (1.0 - metallic)
    return (kd * albedo / math.pi + spec) * ndl


class DeferredRenderer:
    """G-buffer + PBR lighting over a Scene (deferred.py:568)."""

    def __init__(self, scene: Scene, shadows: bool = True,
                 wireframe: bool = False,
                 ssao=False,
                 winding_flip: bool = False,
                 id_buffer: bool = False,
                 velocity: "bool | None" = None,
                 glass_mode: str = "auto",
                 glass_peel_layers: int = 4):
        self.scene = scene
        objs = scene.objects
        if any(o.base_color_texture is not None or o.normal_texture is not None
               or o.mra_texture is not None or o.emissive_texture is not None
               for o in objs):
            raise _unported("textured materials", 13, "sample_2d, mips and rhi/atlas.py")
        if wireframe:
            raise _unported("the wireframe view (LINE polygon mode)", 19,
                            "lines, points and polygon modes")
        # velocity=None resolves to off: animated content (skins, morphs,
        # device-resident instance offsets) is not ported (_check_objects).
        for what, on in (("SSAO", ssao), ("the velocity plane", velocity),
                         ("the object-id buffer", id_buffer)):
            if on:
                raise _unported(what, 21, "screen-space and lighting features")
        self._check_objects(objs)
        self.shadows = shadows and scene.sun is not None and scene.sun.cast_shadows
        self._static_cache = StaticGeometryCache()

        self.gbuffer_vs = Shader.vertex(
            "gbuffer.vs", _gbuffer_vs,
            bindings=[uniform("Model"), uniform("ViewProj")],
            inputs=[attr("position", 3), attr("normal", 3), attr("tex_coord", 2)],
        )
        self.gbuffer_fs = Shader.fragment(
            "gbuffer.fs", _gbuffer_fs,
            bindings=[uniform("BaseColor"), uniform("MatParams")],
        )
        self.shadow_vs = Shader.vertex(
            "shadow.vs", _shadow_vs,
            bindings=[uniform("Model"), uniform("LightViewProj")],
            inputs=[attr("position", 3)],
        )
        # Frame-invariant pipeline inputs, built ONCE: render_to runs every
        # frame, and reusing the same desc objects keeps the structure key
        # and the pipeline cache on their identity fast paths.
        self._shadow_si = GraphicShaderInput(self.shadow_vs, None, VERTEX_LAYOUT)
        self._gbuffer_si = GraphicShaderInput(self.gbuffer_vs, self.gbuffer_fs, VERTEX_LAYOUT)
        self._shadow_state = GraphicPipelineState(
            rasterization=RasterizationState(
                cull_mode=CullMode.NONE, front_face=FrontFace.CLOCKWISE
            )
        )
        # winding_flip: cube-face probe cameras are reflections, which
        # invert screen-space winding (deferred.py:832-835).
        self._gbuffer_state = GraphicPipelineState(
            rasterization=RasterizationState(
                cull_mode=CullMode.BACK,
                front_face=(FrontFace.CLOCKWISE if winding_flip
                            else FrontFace.COUNTER_CLOCKWISE),
            )
        )
        self._shadow_depth = DepthStencilDesc(
            depth_test_enable=True,
            depth_write_enable=True,
            depth_compare_op=CompareOp.LESS,
            depth_clear_value=1.0,
        )
        self._gbuffer_depth = DepthStencilDesc().reverse_z()
        self._ca_clear0 = ColorAttachmentDesc(clear_value=(0, 0, 0, 0))
        self._ca_clear01 = ColorAttachmentDesc(clear_value=(0, 0, 0, 1))

    @staticmethod
    def _check_objects(objs) -> None:
        for o in objs:
            if o.translucent:
                raise _unported(f"translucent object {o.name!r} (the glass node)", 20,
                                "translucency")
            for what, on in (("instanced", o.instance_offsets is not None),
                             ("skinned", o.skin is not None),
                             ("morphed", o.morph_deltas is not None)):
                if on:
                    raise _unported(f"{what} object {o.name!r}", 21,
                                    "screen-space and lighting features")

    def _check_scene(self, scene: Scene) -> None:
        sun = scene.sun
        if scene.environment is not None:
            raise _unported("the image-based light (environment)", 21, "ibl/environment/probe")
        if scene.skybox is None and scene.atmosphere is not None:
            raise _unported("the procedural atmosphere", 21, "atmosphere sky")
        if scene.decals:
            raise _unported("decals", 21, "decals")
        if any(pl.cast_shadows for pl in scene.point_lights):
            raise _unported("shadow-casting point lights (omni shadows)", 21, "omni")
        if self.shadows:
            for what, on in (("cascaded shadow maps", int(sun.cascades) > 1),
                             ("variance (soft) shadows", sun.soft_shadows)):
                if on:
                    raise _unported(what, 21, "csm, omni, vsm")
        if sun is not None and sun.contact_shadows:
            raise _unported("contact shadows", 21, "ssao, contact")

    def frame_dynamics(self, camera: Camera, include_models: bool = False) -> dict:
        """Per-frame dynamic values for RETAINED execution
        (deferred.py:1061-1130). Pass ``include_models=True`` when objects
        move or toggle ``SceneObject.visible`` between retained frames."""
        d = _camera_dynamics("def", camera, want_inv_vp=self.scene.skybox is not None)
        if include_models:
            d["def.models"] = stacked_models(self.scene.objects)
        return d

    def render_to(
        self,
        builder: RenderGraphBuilder,
        output: RenderGraphResource,
        camera: Camera,
        width: int,
        height: int,
        background=(0.02, 0.025, 0.035),
    ) -> None:
        scene = self.scene
        sun = scene.sun
        self._check_scene(scene)
        pl_pos, pl_col, pl_rad, _omni = scene.light_partition()
        sl_pos, sl_col, sl_rad, sl_params = scene.spot_light_arrays()
        has_spots = sl_pos.shape[0] > 0
        if has_spots:
            # One merged table through ONE tiled-culling kernel pass:
            # points first (zero cone params = point), spots appended.
            spot_params = np.concatenate([
                np.zeros((pl_pos.shape[0], 5), np.float32), sl_params
            ])
            pl_pos = np.concatenate([pl_pos, sl_pos])
            pl_col = np.concatenate([pl_col, sl_col])
            pl_rad = np.concatenate([pl_rad, sl_rad])
            builder.set_dynamic("def.sl_params", spot_params)

        builder.set_dynamic("def.view_proj", camera.render_view_projection)
        builder.set_dynamic("def.camera_pos", camera.location)
        if scene.skybox is not None:
            builder.set_dynamic("def.inv_vp", camera.render_inv_view_projection)
        builder.set_dynamic("def.ambient", np.asarray(scene.ambient, np.float32))
        builder.set_dynamic("def.background", np.asarray(background, np.float32))
        if pl_pos.shape[0]:
            builder.set_dynamic("def.pl_pos", pl_pos)
            builder.set_dynamic("def.pl_col", pl_col)
            builder.set_dynamic("def.pl_rad", pl_rad)
        if sun is not None:
            builder.set_dynamic(
                "def.sun_dir", m.normalize(np.asarray(sun.direction, np.float32))
            )
            builder.set_dynamic(
                "def.sun_color", np.asarray(sun.color, np.float32) * sun.intensity
            )
        if self.shadows:
            builder.set_dynamic("def.shadow_bias", np.float32(sun.shadow_bias))
            builder.set_dynamic("def.light_vp", sun_view_projection(sun))
            builder.set_dynamic(
                "def.shadow_noffs", np.float32(sun.effective_normal_offset)
            )
        # One dynamic per FIELD, not per object×field; record closures take
        # their draw's row.
        builder.set_dynamic("def.models", stacked_models(scene.objects))
        builder.set_dynamic("def.base_colors", np.stack(
            [o.base_color_array() for o in scene.objects]
        ))
        builder.set_dynamic("def.mats", np.stack(
            [o.mat_params_array() for o in scene.objects]
        ))
        # Only plain opaque objects are ported: every object is in the
        # reference's plain draw class (deferred.py:1292-1310).
        self._check_objects(scene.objects)
        plain_ix = list(range(len(scene.objects)))

        # Static batching: all plain opaque draws share ONE concatenated
        # vertex/index buffer pair, imported once per frame.
        static_geo = self._static_cache.get(scene.objects, plain_ix)
        per_obj_ix = [] if static_geo is not None else plain_ix
        handles = {
            i: (
                builder.import_resource(scene.objects[i].vertex_buffer),
                builder.import_resource(scene.objects[i].index_buffer),
            )
            for i in per_obj_ix
        }
        if static_geo is not None:
            s_vb_h = builder.import_resource(static_geo.vb)
            s_ib_h = builder.import_resource(static_geo.ib)

        g_albedo = builder.create(TextureDesc.color("g.albedo", width, height))
        g_normal = builder.create(TextureDesc.color("g.normal", width, height))
        g_pos = builder.create(TextureDesc.color("g.pos", width, height))
        g_depth = builder.create(TextureDesc.depth("g.depth", width, height))

        def plain_draws(ctx, accesses, s_acc, extra):
            """(vb, ib, res) per plain object: static-batch slices or
            per-object buffers; ``extra(i)`` adds the per-draw uniforms."""
            models = ctx.dynamic("def.models")
            if static_geo is not None:
                vb_all, ib_all = ctx.get(s_acc[0]), ctx.get(s_acc[1])
                return [
                    (vb_all[vo:vo + vc], ib_all[io_:io_ + ic], {"Model": models[i], **extra(i)})
                    for i, (vo, vc, io_, ic) in zip(plain_ix, static_geo.ranges)
                ]
            return [(accesses[i][0], accesses[i][1], {"Model": models[i], **extra(i)})
                    for i in plain_ix]

        def geometry_reads(node):
            if static_geo is None:
                return {i: (node.read(handles[i][0]), node.read(handles[i][1]))
                        for i in plain_ix}, None
            return None, (node.read(s_vb_h), node.read(s_ib_h))

        # -- node: the sun's shadow map (n_casc == 1) -------------------------
        sm_handle = None
        if self.shadows:
            smsz = sun.shadow_map_size
            sm_handle = builder.create(TextureDesc.depth("sun.shadow", smsz, smsz))
            node = builder.add_graphic_node("shadow")
            accesses, s_acc = geometry_reads(node)
            sm = node.write(sm_handle)
            with node.pipeline(self._shadow_si, self._shadow_state) as binder:
                binder.set_depth(sm, self._shadow_depth)

            def record_shadow(ctx, accesses=accesses, s_acc=s_acc):
                ctx.bind("LightViewProj", ctx.dynamic("def.light_vp"))
                if not plain_ix:
                    return
                ctx.draw_indexed_batch(plain_draws(ctx, accesses, s_acc, lambda i: {}))

            node.execute(record_shadow)

        # -- node: G-buffer (MRT) ---------------------------------------------
        node = builder.add_graphic_node("gbuffer")
        accesses, s_acc = geometry_reads(node)
        a_rt = node.write(g_albedo)
        n_rt = node.write(g_normal)
        p_rt = node.write(g_pos)
        ds = node.write(g_depth)
        with node.pipeline(self._gbuffer_si, self._gbuffer_state) as binder:
            binder.push_color(a_rt, self._ca_clear0)
            binder.push_color(n_rt, self._ca_clear01)
            binder.push_color(p_rt, self._ca_clear0)
            binder.set_depth(ds, self._gbuffer_depth)

        def record_gbuffer(ctx, accesses=accesses, s_acc=s_acc):
            ctx.bind("ViewProj", ctx.dynamic("def.view_proj"))
            bcs = ctx.dynamic("def.base_colors")
            mats = ctx.dynamic("def.mats")
            if plain_ix:
                draws = plain_draws(ctx, accesses, s_acc,
                                    lambda i: {"BaseColor": bcs[i], "MatParams": mats[i]})
                ctx.draw_indexed_batch(draws, per_draw_uniforms=("BaseColor", "MatParams"))

        node.execute(record_gbuffer)

        # -- node: lighting resolve (lambda, full-screen) ----------------------
        sky_handle = (
            builder.import_resource(scene.skybox) if scene.skybox is not None else None
        )
        node = builder.add_lambda_node("lighting")
        a_in = node.read(g_albedo)
        n_in = node.read(g_normal)
        p_in = node.read(g_pos)
        d_in = node.read(g_depth)
        sm_in = node.read(sm_handle) if sm_handle is not None else None
        sky_in = node.read(sky_handle) if sky_handle is not None else None
        out_w = node.write(output)
        num_lights = pl_pos.shape[0]
        shadows = self.shadows
        has_sun = sun is not None

        def record_lighting(ctx):
            albedo_metal = ctx.get(a_in)
            normal_rough = ctx.get(n_in)
            pos_emi = ctx.get(p_in)
            depth = ctx.get(d_in)

            albedo = albedo_metal[..., :3]
            metallic = albedo_metal[..., 3:4]
            n = normal_rough[..., :3]
            roughness = normal_rough[..., 3:4]
            world = pos_emi[..., :3]
            emissive = pos_emi[..., 3:4]
            covered = (depth > 0.0)[..., None]

            cam_pos = ctx.dynamic("def.camera_pos")
            v = _normalize(cam_pos - world)
            color = ctx.dynamic("def.ambient") * albedo + emissive * albedo

            if has_sun:
                l = ctx.dynamic("def.sun_dir")
                contrib = _ggx_brdf(n, v, l.expand(n.shape), albedo, metallic,
                                    roughness) * ctx.dynamic("def.sun_color")
                if shadows:
                    sample_pos = world + n * ctx.dynamic("def.shadow_noffs")
                    hom = torch.cat([sample_pos, torch.ones_like(world[..., :1])], dim=-1)
                    lclip = hom @ ctx.dynamic("def.light_vp").T
                    uv = torch.stack(
                        [(lclip[..., 0] + 1) * 0.5, (lclip[..., 1] + 1) * 0.5], -1
                    )
                    ref = lclip[..., 2] - ctx.dynamic("def.shadow_bias")
                    lit = sample_shadow_pcf(ctx.get_full(sm_in), uv, ref, _SHADOW_SAMPLER)
                    inside = (
                        (uv[..., 0] >= 0) & (uv[..., 0] <= 1)
                        & (uv[..., 1] >= 0) & (uv[..., 1] <= 1)
                    )
                    contrib = contrib * torch.where(inside, lit, torch.ones_like(lit))[..., None]
                color = color + contrib

            if num_lights:
                # Tiled light culling over kernel K2 (ops.lighting).
                color = color + accumulate_point_lights(
                    albedo_metal,
                    normal_rough,
                    pos_emi,
                    depth,
                    cam_pos,
                    ctx.dynamic("def.pl_pos"),
                    ctx.dynamic("def.pl_col"),
                    ctx.dynamic("def.pl_rad"),
                    spot_params=ctx.dynamic("def.sl_params") if has_spots else None,
                )

            if sky_in is not None:
                # Per-pixel view rays for the background, cube-sampled
                # (texture.rs:94-105).
                hh, ww = depth.shape
                dev = depth.device
                ndc_x = (torch.arange(ww, dtype=torch.float32, device=dev) + 0.5) / ww * 2 - 1
                ndc_y = (torch.arange(hh, dtype=torch.float32, device=dev) + 0.5) / hh * 2 - 1
                px = ndc_x[None, :].expand(hh, ww)
                py = ndc_y[:, None].expand(hh, ww)
                ndc = torch.stack(
                    [px, py, torch.full_like(px, 0.5), torch.ones_like(px)], -1
                )
                p = ndc @ ctx.dynamic("def.inv_vp").T
                dirs = p[..., :3] / p[..., 3:4] - cam_pos
                bg = sample_cube(ctx.get(sky_in), dirs)[..., :3]
            else:
                bg = ctx.dynamic("def.background").expand(color.shape)
            rgb = torch.where(covered, color, bg)
            ctx.set(out_w, torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1))

        node.execute(record_lighting)

        # Screen-space consumers declared after this renderer read this
        # frame's G-buffer planes through these handles.
        self.gbuffer_handles = GBufferHandles({
            "albedo": g_albedo,
            "normal": g_normal,
            "pos": g_pos,
            "depth": g_depth,
        })
        if self.shadows:
            self.gbuffer_handles["sun_shadow"] = sm_handle
