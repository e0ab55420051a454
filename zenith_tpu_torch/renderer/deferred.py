"""Deferred shading — BASELINE.md config #4/#5: G-buffer + lighting with ~100
point lights and a Cook-Torrance GGX BRDF (torch port of
zenith_tpu/renderer/deferred.py, the branches the default scene takes).

Node ``shadow`` (graphic, depth only): the sun's shadow map, every plain
opaque object in one batched draw over kernel K1; ``shadow.inst`` LOADs it
and adds each instanced object, one instanced draw each. With
``sun.cascades`` = N > 1 the map is a depth array of N layers, fit to the
camera's frustum slices every frame (renderer.csm), and each layer is
rendered by its own ``shadow.c{k}`` and ``shadow.inst.c{k}`` nodes through
the render graph's render-to-layer writes.

Nodes ``omni{i}.f{k}`` (graphic, depth only): the six cube faces of each
shadow-casting point light (renderer.omni), the plain opaque objects drawn
into one layer of a cube depth texture each.

Nodes ``shadow.skin`` and ``shadow.morph`` (and ``.c{k}`` per cascade):
the skinned and morphed objects' own depth passes, LOADing the map.

Node ``gbuffer`` (graphic, MRT, one batched draw over K1):
  - albedo+metallic   (RGBA32F: rgb albedo, a metallic)
  - normal+roughness  (RGBA32F: xyz world normal, w roughness)
  - world-pos+emissive-luma (RGBA32F)
  - with the velocity plane, the previous frame's world position (``g.prev``)
  - with ``id_buffer``, the 1-based object index (``g.id``, R32F; 0 where
    nothing opaque was drawn), the picking plane that ``pick`` reads
  plus reverse-Z depth. ``gbuffer.inst`` LOADs the planes and adds each
  instanced object (the per-instance ``inst_offset`` attribute; every copy
  writes its object's id); ``gbuffer.skin`` adds the skinned objects
  (linear-blend skinning by the per-frame joint palette, a dynamic, in the
  vertex stage over the SkinnedVertex layout) and ``gbuffer.morph`` the
  morphed ones (the base position plus the weighted POSITION deltas). Textured
  materials are sampled from one atlas per map type (base colour, normal,
  metallic-roughness, emissive; rhi.atlas) with a per-draw UV transform; the normal map bends the normal through the
  derivative-built tangent frame (ops.shade.perturb_normal).

Node ``decals`` (lambda, when the scene holds decals): projected decals
rewrite the G-buffer albedo before lighting (renderer.decal).

Node ``ssao`` (lambda, with ``ssao=``): the ambient-occlusion factor from the
G-buffer (ops.ssao), blurred, into an R32F plane.

Node ``lighting`` (lambda): full-screen PBR resolve — flat ambient, or with
``scene.environment`` the split-sum image-based light (SH diffuse and the
prefiltered cube's specular, ops.ibl), times the AO factor; the sun with
2×2 PCF shadows (per pixel from its cascade's layer under CSM; variance
soft shadows, ops.vsm, with ``soft_shadows`` and one cascade) and optional screen-space contact shadows (ops.contact), the
point/spot-light sum over the tiled kernel K2 (ops.lighting), each
shadow-casting point light densely with cube PCF visibility, and, where no
surface was drawn, the cube-map skybox, the procedural atmosphere
(ops.atmosphere) or a constant background; the environment cube is the
skybox when the scene sets none.

Node ``glass`` (graphic, after lighting, when the scene holds translucent
objects): one batched blended draw over the lit HDR frame, depth-tested
against the G-buffer depth with depth writes off. ``glass_mode="kernel"``
takes the in-order blend kernel K5 with the kernel-safe glass shader (texture
content, if any, sampled at the vertices); ``"peel"`` takes depth peeling
over K4 with the glass atlas sampled per pixel; ``"auto"`` picks peel for
textured glass.

``wireframe=True`` draws the G-buffer pass in LINE polygon mode (the
shadow pass stays FILL): the edges get the full deferred lighting.

``velocity`` adds the per-draw velocity plane: every G-buffer draw also
transforms its vertices by the previous frame's model matrix, joint
palette, morph weights and instance offsets, and the fourth MRT plane
keeps the previous world position, which TAA and motion blur reproject
with. ``None`` turns it on for skins, morphs and device-resident instance
offsets.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from zenith_tpu_torch.asset.render_types import SkinnedVertex as SKINNED_LAYOUT
from zenith_tpu_torch.asset.render_types import Vertex as VERTEX_LAYOUT
from zenith_tpu_torch.core import mathtypes as m
from zenith_tpu_torch.core.camera import Camera
from zenith_tpu_torch.ops.atmosphere import sky_radiance
from zenith_tpu_torch.ops.contact import contact_shadow_factor
from zenith_tpu_torch.ops.ibl import env_brdf_approx, eval_irradiance_sh9
from zenith_tpu_torch.ops.lighting import accumulate_point_lights
from zenith_tpu_torch.ops.ssao import hemisphere_kernel, ssao_blur, ssao_occlusion
from zenith_tpu_torch.ops.shade import perturb_normal
from zenith_tpu_torch.core import log
from zenith_tpu_torch.core import validate as _validate
from zenith_tpu_torch.ops.sampling import (
    cube_direction_to_face_uv,
    sample_2d,
    sample_cube,
    sample_cube_lod,
    sample_shadow_pcf,
    sample_shadow_pcf_layered,
    sample_texture,
)
from zenith_tpu_torch.ops.vsm import depth_to_moments, sample_vsm
from zenith_tpu_torch.parallel import spmd
from zenith_tpu_torch.parallel.sharding import halo_exchange_rows
from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.rendergraph.resource import RenderGraphResource
from zenith_tpu_torch.renderer.csm import fit_cascades
from zenith_tpu_torch.renderer.decal import apply_decal, stacked_decal_colors, stacked_decal_mats
from zenith_tpu_torch.renderer.forward import (
    _SHADOW_SAMPLER,
    _camera_dynamics,
    _normalize,
    _shadow_inst_vs,
    _shadow_vs,
    sun_view_projection,
)
from zenith_tpu_torch.renderer.omni import omni_face_matrices, omni_reference_z
from zenith_tpu_torch.renderer.scene import Scene, band_hint_for, stacked_models
from zenith_tpu_torch.renderer.volumetric import view_rays
from zenith_tpu_torch.renderer.static_batch import StaticGeometryCache
from zenith_tpu_torch.rhi import (
    BlendFactor,
    ColorAttachmentDesc,
    CullMode,
    Format,
    FrontFace,
    GraphicShaderInput,
    LoadOp,
    RasterizationState,
    SamplerConfig,
    Shader,
    Texture,
    TextureDesc,
    attr,
    storage,
    texture2d,
    uniform,
)
from zenith_tpu_torch.rhi.atlas import build_atlas
from zenith_tpu_torch.rhi.state import (
    CompareOp,
    DepthStencilDesc,
    GraphicPipelineState,
    PolygonMode,
)

logger = log.get(__name__)


class GBufferHandles(dict):
    """The G-buffer plane handles published for screen-space consumers,
    plus advisory flags (deferred.py:68-76)."""

    animated_without_velocity: bool = False


def _offsets_value(offsets):
    """Instance offsets as a dynamic: a tensor passes through (no read of
    the device), host values become a float32 array."""
    if isinstance(offsets, torch.Tensor):
        return offsets
    return np.asarray(offsets, np.float32)


def _make_gbuffer_vs(velocity: bool):
    """Plain G-buffer vertex stage (deferred.py:79-100). ``velocity`` adds
    the ``prev_pos`` varying: the same vertex transformed by the previous
    frame's model matrix (the per-draw ``PrevModel``)."""

    def _gbuffer_vs(attrs, res):
        pos = attrs["position"]
        hom = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
        world = hom @ res["Model"].T
        out = {
            "position": world @ res["ViewProj"].T,
            "world_pos": world[:, :3],
            "normal": attrs["normal"] @ res["Model"][:3, :3].T,
            "uv": attrs["tex_coord"],
        }
        if velocity:
            out["prev_pos"] = (hom @ res["PrevModel"].T)[:, :3]
        return out

    return _gbuffer_vs


def _make_gbuffer_inst_vs(velocity: bool):
    """Instanced G-buffer vertex stage (deferred.py:103-130): the
    per-instance world-space offset ``inst_offset``, an instance-rate
    vertex attribute (ops.draw instance_data). ``velocity`` adds the
    instance-rate ``prev_inst_offset`` and the ``prev_pos`` varying."""

    def _gbuffer_inst_vs(attrs, res):
        pos = attrs["position"]
        hom = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
        world = hom @ res["Model"].T
        world_pos = world[:, :3] + attrs["inst_offset"]
        clip_hom = torch.cat([world_pos, world[:, 3:4]], dim=1)
        out = {
            "position": clip_hom @ res["ViewProj"].T,
            "world_pos": world_pos,
            "normal": attrs["normal"] @ res["Model"][:3, :3].T,
            "uv": attrs["tex_coord"],
        }
        if velocity:
            pw = hom @ res["PrevModel"].T
            out["prev_pos"] = pw[:, :3] + attrs["prev_inst_offset"]
        return out

    return _gbuffer_inst_vs


# Frame-invariant instances: the constructor picks by mode, so the
# structure key sees the same function objects every frame.
_gbuffer_vs = _make_gbuffer_vs(False)
_gbuffer_inst_vs = _make_gbuffer_inst_vs(False)


def _skin_blend(attrs, res):
    """Linear-blend skinning (deferred.py:138-161): each vertex's 4 joint
    matrices gathered from the (J, 4, 4) ``Joints`` palette (the joint
    indices ride as float32) and blended by weight over the whole vertex
    buffer. Returns (skinned homogeneous positions (N, 4), skinned normals
    (N, 3))."""
    pos = attrs["position"]
    n = pos.shape[0]
    jidx = attrs["joints"].to(torch.int64)
    w = attrs["weights"]
    flat = res["Joints"].reshape(-1, 16)
    hom = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
    nrm = attrs["normal"]
    p_acc = torch.zeros_like(hom)
    n_acc = torch.zeros_like(nrm)
    for k in range(4):
        mk = flat[jidx[:, k]].reshape(n, 4, 4)
        p_acc = p_acc + w[:, k:k + 1] * torch.einsum("nj,nij->ni", hom, mk)
        n_acc = n_acc + w[:, k:k + 1] * torch.einsum("nj,nij->ni", nrm, mk[:, :3, :3])
    return p_acc, n_acc


def _morph_weights(obj) -> np.ndarray:
    """(T,) weights for the MorphWeights uniform (zeros: the base shape)."""
    if obj.morph_weights is not None:
        return np.ascontiguousarray(obj.morph_weights, np.float32)
    return np.zeros((obj.morph_deltas.shape[0],), np.float32)


def _joint_palette(obj) -> np.ndarray:
    """(J, 4, 4) palette for the Joints uniform: the object's animated
    matrices, or identities (the bind pose) before any is sampled."""
    if obj.joint_matrices is not None:
        return np.ascontiguousarray(obj.joint_matrices, np.float32)
    return np.broadcast_to(np.eye(4, dtype=np.float32), (obj.skin.num_joints, 4, 4)).copy()


def _make_gbuffer_skin_vs(velocity: bool):
    """Skinned G-buffer vertex stage (deferred.py:188-212). ``velocity``
    also skins the vertex by the previous frame's palette (``PrevJoints``)
    and model matrix."""

    def _gbuffer_skin_vs(attrs, res):
        skinned, snrm = _skin_blend(attrs, res)
        world = skinned @ res["Model"].T
        out = {
            "position": world @ res["ViewProj"].T,
            "world_pos": world[:, :3],
            "normal": snrm @ res["Model"][:3, :3].T,
            "uv": attrs["tex_coord"],
        }
        if velocity:
            prev_skinned, _ = _skin_blend(attrs, {"Joints": res["PrevJoints"]})
            out["prev_pos"] = (prev_skinned @ res["PrevModel"].T)[:, :3]
        return out

    return _gbuffer_skin_vs


def _shadow_skin_vs(attrs, res):
    skinned, _ = _skin_blend(attrs, res)
    return {"position": (skinned @ res["Model"].T) @ res["LightViewProj"].T}


def _morphed_position(attrs, res):
    """The base position plus Σ wₜ·deltaₜ (deferred.py:225-232): one
    (T) × (T, N, 3) contraction; the base normals are kept (a
    small-deformation approximation)."""
    return attrs["position"] + torch.einsum("t,tnc->nc", res["MorphWeights"],
                                            res["MorphDeltas"])


def _make_gbuffer_morph_vs(velocity: bool):
    """Morph-target G-buffer vertex stage (deferred.py:235-265).
    ``velocity`` also blends the base position by the previous frame's
    weights (``PrevMorphWeights``) and model matrix."""

    def _gbuffer_morph_vs(attrs, res):
        pos = _morphed_position(attrs, res)
        hom = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
        world = hom @ res["Model"].T
        out = {
            "position": world @ res["ViewProj"].T,
            "world_pos": world[:, :3],
            "normal": attrs["normal"] @ res["Model"][:3, :3].T,
            "uv": attrs["tex_coord"],
        }
        if velocity:
            ppos = _morphed_position(attrs, {"MorphWeights": res["PrevMorphWeights"],
                                             "MorphDeltas": res["MorphDeltas"]})
            phom = torch.cat([ppos, torch.ones_like(ppos[:, :1])], dim=1)
            out["prev_pos"] = (phom @ res["PrevModel"].T)[:, :3]
        return out

    return _gbuffer_morph_vs


def _shadow_morph_vs(attrs, res):
    pos = _morphed_position(attrs, res)
    hom = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
    return {"position": (hom @ res["Model"].T) @ res["LightViewProj"].T}


_gbuffer_skin_vs = _make_gbuffer_skin_vs(False)
_gbuffer_morph_vs = _make_gbuffer_morph_vs(False)


# Atlas binding name -> its per-draw UV-transform uniform name (each map
# type has its own atlas cell layout, hence its own transform).
_UVX_NAME = {
    "BaseAtlas": "UvxBase",
    "NormalAtlas": "UvxNormal",
    "MraAtlas": "UvxMra",
    "EmissiveAtlas": "UvxEmissive",
}


def _make_gbuffer_fs(textured: bool, use_normal: bool = False,
                     use_mra: bool = False, use_emissive: bool = False,
                     id_out: bool = False, prev_out: bool = False):
    """G-buffer fragment stage (deferred.py:276-374). ``prev_out`` adds the
    fourth plane, the interpolated ``prev_pos`` varying (the velocity
    plane); ``id_out`` the id plane, the per-draw ``ObjectId`` uniform. Textured mode samples one
    atlas per map type with a per-draw UV transform: base colour; glTF metallic-roughness
    (B=metallic, G=roughness); the tangent-space normal map through the
    derivative-built frame (no vertex tangents); emissive as luma."""

    def _gbuffer_fs(varyings, res, builtins):
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
        if textured:
            uv = varyings["uv"]
            lin = SamplerConfig.linear()

            def atlas_uv(x):
                # x: (4,) or per-draw (H, W, 4) plane — su, sv, ou, ov.
                return torch.stack([x[..., 2] + uv[..., 0] * x[..., 0],
                                    x[..., 3] + uv[..., 1] * x[..., 1]], dim=-1)

            albedo = albedo * sample_texture(res["BaseAtlas"], atlas_uv(res["UvxBase"]),
                                             lin)[..., :3]
            if use_mra:
                mra = sample_texture(res["MraAtlas"], atlas_uv(res["UvxMra"]), lin)
                metallic = metallic * mra[..., 2:3]
                roughness = roughness * mra[..., 1:2]
            if use_normal:
                nm = sample_texture(res["NormalAtlas"], atlas_uv(res["UvxNormal"]),
                                    lin)[..., :3]
                n = perturb_normal(n, varyings["world_pos"], uv, nm)
            if use_emissive:
                em = sample_texture(res["EmissiveAtlas"], atlas_uv(res["UvxEmissive"]),
                                    lin)[..., :3]
                emissive = emissive * (em[..., 0:1] * 0.2126 + em[..., 1:2] * 0.7152
                                       + em[..., 2:3] * 0.0722)
        # MRT outputs in attachment order (draw maps dict keys sorted).
        out = {
            "0_albedo": torch.cat([albedo, metallic], dim=-1),
            "1_normal": torch.cat([n, roughness], dim=-1),
            "2_pos": torch.cat([varyings["world_pos"], emissive], dim=-1),
        }
        if prev_out:
            prev = varyings["prev_pos"]
            out["3_prev"] = torch.cat([prev, torch.ones_like(prev[..., :1])], dim=-1)
        if id_out:
            # A (1,) vector drawn alone, an (H, W, 1) plane under
            # draw_indexed_batch.
            out["4_id"] = res["ObjectId"][..., 0:1].expand(n[..., :1].shape)
        return out

    return _gbuffer_fs


def _make_glass_vs(textured: bool, instanced: bool):
    """Translucent (glass) vertex stage (deferred.py:377-419).

    ``textured``: samples the per-draw ``GlassTex`` AT THE VERTICES and emits
    the sampled RGBA as a ``tint`` varying. This is how texture content
    reaches the kernel-safe blend fragment shader: the in-order blend kernel
    cannot gather, but it interpolates varyings. Sampling is level-0 bilinear
    (no screen-space derivatives exist at vertex rate).

    ``instanced``: adds the per-instance ``inst_offset`` attribute."""

    def _glass_vs(attrs, res):
        pos = attrs["position"]
        hom = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
        world = hom @ res["Model"].T
        if instanced:
            clip_hom = torch.cat([world[:, :3] + attrs["inst_offset"], world[:, 3:4]], dim=1)
        else:
            clip_hom = world
        out = {
            "position": clip_hom @ res["ViewProj"].T,
            "normal": attrs["normal"] @ res["Model"][:3, :3].T,
        }
        if textured:
            tex = res["GlassTex"]
            lvl0 = tex[0] if isinstance(tex, (tuple, list)) else tex
            out["tint"] = sample_2d(lvl0, attrs["tex_coord"], SamplerConfig.linear())
        return out

    return _glass_vs


def _glass_lambert(varyings, res):
    """(shade, r, g, b, a): the component-wise lambert tint both glass
    fragment stages share; two-sided panes take |N·L| (abs before any
    clamp)."""
    n = varyings["normal"]
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    inv = 1.0 / torch.sqrt(nx * nx + ny * ny + nz * nz + 1e-8)
    l = res["SunDir"]
    ndl = torch.abs((nx * l[..., 0] + ny * l[..., 1] + nz * l[..., 2]) * inv)
    c = res["BaseColor"]
    shade = 0.35 + 0.65 * ndl
    return shade, c[..., 0], c[..., 1], c[..., 2], c[..., 3].expand(shade.shape)


def _make_glass_fs(textured: bool):
    def _glass_fs(varyings, res, builtins):
        """Kernel-safe translucent shading (deferred.py:422-445): only
        elementwise ops over the varyings and uniforms. Texture content
        arrives pre-sampled in the interpolated ``tint`` varying. This is the
        plain version of ``glass_device_source``."""
        shade, r, g, b, a = _glass_lambert(varyings, res)
        if textured:
            t = varyings["tint"]
            r, g, b = r * t[..., 0], g * t[..., 1], b * t[..., 2]
            a = a * t[..., 3]
        return torch.stack([r * shade, g * shade, b * shade, a], dim=-1)

    return _glass_fs


def glass_device_source(textured: bool) -> str:
    """``_make_glass_fs(textured)`` as the CUDA text of ``zn_fragment`` (see
    rhi.shader.Shader.device_source): the same operations in the same order,
    compiled without FMA contraction."""
    tint = """
  const float* t = a + ZN_V_tint;
  r = r * t[0];
  g = g * t[1];
  b = b * t[2];
  al = al * t[3];""" if textured else ""
    return f"""
__device__ __forceinline__ void zn_fragment(const float* a, float frag_x, float frag_y,
                                            float depth, bool front_facing, float draw_id,
                                            float* rgba) {{
  const float* n = a + ZN_V_normal;
  const float* l = a + ZN_U_SunDir;
  const float* c = a + ZN_U_BaseColor;
  const float inv = 1.0f / sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2] + 1e-8f);
  const float ndl = fabsf((n[0] * l[0] + n[1] * l[1] + n[2] * l[2]) * inv);
  const float shade = 0.35f + 0.65f * ndl;
  float r = c[0], g = c[1], b = c[2], al = c[3];{tint}
  rgba[0] = r * shade;
  rgba[1] = g * shade;
  rgba[2] = b * shade;
  rgba[3] = al;
}}
"""


def _make_glass_peel_vs(instanced: bool):
    """Translucent vertex stage for the depth-peeled path (deferred.py:448-471):
    emits the raw ``uv`` varying; the peel layers shade at full fragment
    rate, so the texture is sampled per pixel."""

    def _vs(attrs, res):
        pos = attrs["position"]
        hom = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
        world = hom @ res["Model"].T
        if instanced:
            clip_hom = torch.cat([world[:, :3] + attrs["inst_offset"], world[:, 3:4]], dim=1)
        else:
            clip_hom = world
        return {
            "position": clip_hom @ res["ViewProj"].T,
            "normal": attrs["normal"] @ res["Model"][:3, :3].T,
            "uv": attrs["tex_coord"],
        }

    return _vs


def _glass_peel_fs(varyings, res, builtins):
    """Fragment-rate translucent shading (deferred.py:474-502; depth-peel
    layers shade densely): samples the glass atlas per pixel with the
    per-draw UV transform. Same lambert-tint lighting as _make_glass_fs."""
    shade, r, g, b, a = _glass_lambert(varyings, res)
    uv = varyings["uv"]
    uvx = res["UvxGlass"]  # (4,) or per-draw (H, W, 4) plane
    auv = torch.stack(
        [uvx[..., 2] + uv[..., 0] * uvx[..., 0], uvx[..., 3] + uv[..., 1] * uvx[..., 1]],
        dim=-1,
    )
    t = sample_texture(res["GlassAtlas"], auv, SamplerConfig.linear())
    r, g, b = r * t[..., 0], g * t[..., 1], b * t[..., 2]
    a = a * t[..., 3]
    return torch.stack([r * shade, g * shade, b * shade, a], dim=-1)


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


class SSAOOptions:
    """Screen-space ambient-occlusion settings (ops.ssao; deferred.py:549-564).
    ``radius`` and ``bias`` are world-space; tune radius to the scene scale."""

    def __init__(self, samples: int = 12, radius: float = 4.0,
                 bias: float = 0.04, intensity: float = 1.0,
                 blur_taps: int = 4, depth_tol: float = 5e-4):
        self.samples = int(samples)
        self.radius = float(radius)
        self.bias = float(bias)
        self.intensity = float(intensity)
        self.blur_taps = int(blur_taps)
        self.depth_tol = float(depth_tol)

    def __zenith_capture_key__(self):
        return ("ssao-opts", self.samples, self.radius, self.bias,
                self.intensity, self.blur_taps, self.depth_tol)


class DeferredRenderer:
    """G-buffer + PBR lighting over a Scene (deferred.py:568)."""

    def __init__(self, scene: Scene, shadows: bool = True,
                 wireframe: bool = False,
                 ssao: "bool | SSAOOptions" = False,
                 winding_flip: bool = False,
                 id_buffer: bool = False,
                 velocity: "bool | None" = None,
                 glass_mode: str = "auto",
                 glass_peel_layers: int = 4):
        self.scene = scene
        objs = scene.objects
        self.wireframe = wireframe
        self._check_objects(objs)
        # Per-draw velocity (deferred.py:580-605): every G-buffer draw also
        # transforms its vertices by the previous frame's model matrix, joint
        # palette, morph weights and instance offsets and writes the previous
        # world position into a fourth plane (g.prev). velocity=None is
        # automatic: on when the scene holds motion the camera-only
        # reprojection cannot represent (skins, morphs, device-resident
        # instance offsets). The renderer rolls the previous transforms itself.
        self.scene_animated = any(
            o.skin is not None or o.morph_deltas is not None
            or isinstance(o.instance_offsets, torch.Tensor) for o in objs)
        if velocity is None:
            velocity = self.scene_animated
        self.velocity = bool(velocity)
        self._prev_motion: "dict | None" = None  # rolled previous transforms
        self._last_motion: "dict | None" = None  # the latest observed values
        # The object-id plane (deferred.py:606-616): every opaque G-buffer
        # draw writes its 1-based object index into an R32F plane, which
        # render_to exports and publishes as ``id_resource``; ``pick`` maps a
        # pixel back to its object. Glass draws after lighting and never
        # writes it.
        self.id_buffer = bool(id_buffer)
        self.id_resource: "RenderGraphResource | None" = None
        if ssao is True:
            ssao = SSAOOptions()
        self.ssao: "SSAOOptions | None" = ssao or None
        self.shadows = shadows and scene.sun is not None and scene.sun.cast_shadows
        self._static_cache = StaticGeometryCache()

        self._init_atlases(objs)
        vel = self.velocity
        prev_u = [uniform("PrevModel")] if vel else []
        self.gbuffer_vs = Shader.vertex(
            "gbuffer.vel.vs" if vel else "gbuffer.vs",
            _make_gbuffer_vs(True) if vel else _gbuffer_vs,
            bindings=[uniform("Model"), uniform("ViewProj")] + prev_u,
            inputs=[attr("position", 3), attr("normal", 3), attr("tex_coord", 2)],
        )
        oid_u = [uniform("ObjectId")] if self.id_buffer else []
        self.gbuffer_fs = Shader.fragment(
            "gbuffer.vel.fs" if vel else "gbuffer.fs",
            _make_gbuffer_fs(self.textured, self.use_normal, self.use_mra, self.use_emissive,
                             id_out=self.id_buffer, prev_out=vel),
            bindings=[uniform("BaseColor"), uniform("MatParams")] + oid_u
            + [texture2d(name) for name in self._atlases]
            + [uniform(_UVX_NAME[name]) for name in self._atlases],
        )
        self.shadow_vs = Shader.vertex(
            "shadow.vs", _shadow_vs,
            bindings=[uniform("Model"), uniform("LightViewProj")],
            inputs=[attr("position", 3)],
        )
        # Instanced variants (deferred.py:703-717): the same stages plus the
        # per-instance inst_offset attribute.
        self.gbuffer_inst_vs = Shader.vertex(
            "gbuffer.inst.vel.vs" if vel else "gbuffer.inst.vs",
            _make_gbuffer_inst_vs(True) if vel else _gbuffer_inst_vs,
            bindings=[uniform("Model"), uniform("ViewProj")] + prev_u,
            inputs=[attr("position", 3), attr("normal", 3), attr("tex_coord", 2),
                    attr("inst_offset", 3, per_instance=True)]
            + ([attr("prev_inst_offset", 3, per_instance=True)] if vel else []),
        )
        self.shadow_inst_vs = Shader.vertex(
            "shadow.inst.vs", _shadow_inst_vs,
            bindings=[uniform("Model"), uniform("LightViewProj")],
            inputs=[attr("position", 3), attr("inst_offset", 3, per_instance=True)],
        )
        self._init_animated(objs, vel, prev_u, oid_u)
        # Frame-invariant pipeline inputs, built ONCE: render_to runs every
        # frame, and reusing the same desc objects keeps the structure key
        # and the pipeline cache on their identity fast paths.
        self._shadow_si = GraphicShaderInput(self.shadow_vs, None, VERTEX_LAYOUT)
        self._gbuffer_si = GraphicShaderInput(self.gbuffer_vs, self.gbuffer_fs, VERTEX_LAYOUT)
        self._shadow_inst_si = GraphicShaderInput(self.shadow_inst_vs, None, VERTEX_LAYOUT)
        self._gbuffer_inst_si = GraphicShaderInput(self.gbuffer_inst_vs, self.gbuffer_fs,
                                                   VERTEX_LAYOUT)
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
                polygon_mode=PolygonMode.LINE if wireframe else PolygonMode.FILL,
            )
        )
        self._shadow_depth = DepthStencilDesc(
            depth_test_enable=True,
            depth_write_enable=True,
            depth_compare_op=CompareOp.LESS,
            depth_clear_value=1.0,
        )
        self._shadow_depth_load = dataclasses.replace(self._shadow_depth,
                                                      depth_load_op=LoadOp.LOAD)
        self._gbuffer_depth = DepthStencilDesc().reverse_z()
        self._gbuffer_depth_load = dataclasses.replace(self._gbuffer_depth,
                                                       depth_load_op=LoadOp.LOAD)
        self._ca_clear0 = ColorAttachmentDesc(clear_value=(0, 0, 0, 0))
        self._ca_clear01 = ColorAttachmentDesc(clear_value=(0, 0, 0, 1))
        self._ca_load = ColorAttachmentDesc(load_op=LoadOp.LOAD)
        self._init_glass(objs, glass_mode, glass_peel_layers)

    def _init_animated(self, objs, vel: bool, prev_u: list, oid_u: list) -> None:
        """The skinned and morphed objects' stages and pipeline inputs
        (deferred.py:719-820): skins over the SkinnedVertex layout with a
        (J, 4, 4) ``Joints`` palette, morphs over the plain layout with the
        (T, N, 3) ``MorphDeltas`` buffer and the (T,) ``MorphWeights``; both
        shade with the untextured G-buffer fragment stage."""
        self.has_skinned = any(o.skin is not None for o in objs)
        self.has_morphs = any(o.morph_deltas is not None for o in objs)
        fs = _make_gbuffer_fs(False, id_out=self.id_buffer, prev_out=vel)
        fs_bindings = [uniform("BaseColor"), uniform("MatParams")] + oid_u
        if self.has_skinned:
            skin_vs = Shader.vertex(
                "gbuffer.skin.vel.vs" if vel else "gbuffer.skin.vs",
                _make_gbuffer_skin_vs(True) if vel else _gbuffer_skin_vs,
                bindings=[uniform("Model"), uniform("ViewProj"), uniform("Joints")]
                + (prev_u + [uniform("PrevJoints")] if vel else []),
                inputs=[attr("position", 3), attr("normal", 3), attr("tex_coord", 2),
                        attr("joints", 4), attr("weights", 4)],
            )
            shadow_vs = Shader.vertex(
                "shadow.skin.vs", _shadow_skin_vs,
                bindings=[uniform("Model"), uniform("LightViewProj"), uniform("Joints")],
                inputs=[attr("position", 3), attr("normal", 3), attr("joints", 4),
                        attr("weights", 4)],
            )
            skin_fs = Shader.fragment("gbuffer.skin.vel.fs" if vel else "gbuffer.skin.fs", fs,
                                      bindings=fs_bindings)
            self._shadow_skin_si = GraphicShaderInput(shadow_vs, None, SKINNED_LAYOUT)
            self._gbuffer_skin_si = GraphicShaderInput(skin_vs, skin_fs, SKINNED_LAYOUT)
        if self.has_morphs:
            morph_vs = Shader.vertex(
                "gbuffer.morph.vel.vs" if vel else "gbuffer.morph.vs",
                _make_gbuffer_morph_vs(True) if vel else _gbuffer_morph_vs,
                bindings=[uniform("Model"), uniform("ViewProj"), uniform("MorphWeights"),
                          storage("MorphDeltas")]
                + (prev_u + [uniform("PrevMorphWeights")] if vel else []),
                inputs=[attr("position", 3), attr("normal", 3), attr("tex_coord", 2)],
            )
            shadow_vs = Shader.vertex(
                "shadow.morph.vs", _shadow_morph_vs,
                bindings=[uniform("Model"), uniform("LightViewProj"), uniform("MorphWeights"),
                          storage("MorphDeltas")],
                inputs=[attr("position", 3)],
            )
            morph_fs = Shader.fragment("gbuffer.morph.vel.fs" if vel else "gbuffer.morph.fs",
                                       fs, bindings=fs_bindings)
            self._shadow_morph_si = GraphicShaderInput(shadow_vs, None, VERTEX_LAYOUT)
            self._gbuffer_morph_si = GraphicShaderInput(morph_vs, morph_fs, VERTEX_LAYOUT)

    def _init_atlases(self, objs) -> None:
        """Textured mode (deferred.py:623-667): the material textures are
        packed into one atlas per map type at construction, on the scene's
        device, so fragments sample each map once with a per-draw UV
        transform. Objects without a map get a fallback cell (white,
        flat normal, white MRA, black emissive), so mixed scenes share one
        pipeline. The atlases snapshot the textures: after swapping one,
        rebuild the renderer.

        The reference turns textured mode on for a textured translucent
        object too, and its opaque pass then samples the white fallback
        cells, which is the untextured result; the port turns it on only
        when an opaque object carries a map (ROADMAP §3, "Glass"). The
        atlases are built over every object, as the reference's are."""
        self.textured = any(
            not o.translucent and any(t is not None for t in (
                o.base_color_texture, o.normal_texture, o.mra_texture, o.emissive_texture))
            for o in objs)
        self.use_normal = self.textured and any(o.normal_texture is not None for o in objs)
        self.use_mra = self.textured and any(o.mra_texture is not None for o in objs)
        self.use_emissive = self.textured and any(o.emissive_texture is not None for o in objs)
        self._atlases: dict = {}
        if not self.textured:
            return
        device = objs[0].vertex_buffer.array.device
        self._atlases["BaseAtlas"] = build_atlas(
            "atlas.base", [o.base_color_texture for o in objs],
            fallback=(1.0, 1.0, 1.0, 1.0), device=device)
        if self.use_normal:
            self._atlases["NormalAtlas"] = build_atlas(
                "atlas.normal", [o.normal_texture for o in objs],
                fallback=(0.5, 0.5, 1.0, 1.0), mip_levels=1, device=device)
        if self.use_mra:
            self._atlases["MraAtlas"] = build_atlas(
                "atlas.mra", [o.mra_texture for o in objs],
                fallback=(1.0, 1.0, 1.0, 1.0), device=device)
        if self.use_emissive:
            self._atlases["EmissiveAtlas"] = build_atlas(
                "atlas.emissive", [o.emissive_texture for o in objs],
                fallback=(0.0, 0.0, 0.0, 1.0), device=device)

    def _init_glass(self, objs, glass_mode: str, glass_peel_layers: int) -> None:
        """The translucent (glass) pass (deferred.py:864-977): drawn after
        the lighting resolve, standard src-alpha-over blending, depth-tested
        against the G-buffer depth with writes off. Two paths:

        "kernel": the in-order blend kernel. Exact submission-order blending
          for any overlap depth, but its kernel-safe fragment shader cannot
          gather: texture content arrives at vertex rate (_make_glass_vs).
        "peel": depth peeling (ops.draw peel_layers): K bounded winner-resolve
          passes shaded at full fragment rate (per-pixel atlas sampling) and
          composited back to front. Exact for ≤K overlapping translucent
          fragments per pixel (dropped deeper layers count into bin overflow).
        "auto" picks peel for textured glass and kernel otherwise."""
        self.has_translucents = any(o.translucent for o in objs)
        if not self.has_translucents:
            return
        self.glass_textured = any(
            o.translucent and o.base_color_texture is not None for o in objs)
        self.glass_instanced = any(
            o.translucent and o.instance_offsets is not None for o in objs)
        if glass_mode not in ("auto", "kernel", "peel"):
            raise ValueError(f"glass_mode must be 'auto', 'kernel' or 'peel', got {glass_mode!r}")
        self.glass_peel = glass_mode == "peel" or (glass_mode == "auto" and self.glass_textured)
        self.glass_peel_layers = int(glass_peel_layers)
        gt, gi = self.glass_textured, self.glass_instanced
        device = next(o for o in objs if o.translucent).vertex_buffer.array.device
        inst_input = [attr("inst_offset", 3, per_instance=True)] if gi else []
        if self.glass_peel:
            self._glass_atlas = build_atlas(
                "atlas.glass", [o.base_color_texture for o in objs if o.translucent],
                fallback=(1.0, 1.0, 1.0, 1.0), device=device,
            )
            self.glass_vs = Shader.vertex(
                f"glass.peel{'.inst' if gi else ''}.vs", _make_glass_peel_vs(gi),
                bindings=[uniform("Model"), uniform("ViewProj")],
                inputs=[attr("position", 3), attr("normal", 3), attr("tex_coord", 2)]
                + inst_input,
            )
            self.glass_fs = Shader.fragment(
                "glass.peel.fs", _glass_peel_fs,
                bindings=[uniform("BaseColor"), uniform("SunDir"), uniform("UvxGlass"),
                          texture2d("GlassAtlas")],
            )
        else:
            if gt and _validate.enabled():
                logger.warning(
                    "[validate] textured glass on the blend-kernel path samples at "
                    "vertex rate (Gouraud), wrong for texture frequencies above the "
                    "mesh tessellation. Use DeferredRenderer(glass_mode='peel') (the "
                    "'auto' default) for per-pixel-correct sampling."
                )
            if gt:
                # Untextured translucents drawn through the textured glass
                # pipeline sample a shared 1x1 white texture.
                self._white_glass_tex = Texture.from_numpy(
                    "glass.white", np.ones((1, 1, 4), np.float32), Format.RGBA32F,
                    device=device)
            self.glass_vs = Shader.vertex(
                f"glass{'.tex' if gt else ''}{'.inst' if gi else ''}.vs",
                _make_glass_vs(gt, gi),
                bindings=[uniform("Model"), uniform("ViewProj")]
                + ([texture2d("GlassTex")] if gt else []),
                inputs=[attr("position", 3), attr("normal", 3)]
                + ([attr("tex_coord", 2)] if gt else []) + inst_input,
            )
            self.glass_fs = Shader.fragment(
                "glass.tex.fs" if gt else "glass.fs", _make_glass_fs(gt),
                bindings=[uniform("BaseColor"), uniform("SunDir")],
                kernel_safe=True, device_source=glass_device_source(gt),
            )
        self._glass_si = GraphicShaderInput(self.glass_vs, self.glass_fs, VERTEX_LAYOUT)
        self._glass_state = GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE),
        )
        self._glass_over = ColorAttachmentDesc(
            blend_enable=True,
            src_color_blend=BlendFactor.SRC_ALPHA,
            dst_color_blend=BlendFactor.ONE_MINUS_SRC_ALPHA,
            src_alpha_blend=BlendFactor.ONE,
            dst_alpha_blend=BlendFactor.ONE_MINUS_SRC_ALPHA,
            load_op=LoadOp.LOAD,
        )
        self._glass_depth = DepthStencilDesc(
            depth_test_enable=True,
            depth_write_enable=False,
            depth_compare_op=CompareOp.GREATER,
            depth_load_op=LoadOp.LOAD,
        )

    @staticmethod
    def _check_objects(objs) -> None:
        """Skinned and morphed objects draw through their own untextured
        opaque pipelines (deferred.py:727-735, 771-780): neither instanced,
        translucent nor textured, and not both."""
        for o in objs:
            if (o.skin is not None or o.morph_deltas is not None) and (
                    o.instance_offsets is not None or o.translucent
                    or o.base_color_texture is not None
                    or (o.skin is not None and o.morph_deltas is not None)):
                raise ValueError(f"DeferredRenderer: {o.name!r}: skinned and morphed objects "
                                 "are plain opaque untextured objects, one or the other")

    def _atmosphere(self):
        """The scene's procedural sky, where no skybox or environment cube
        overrides it (deferred.py:1070-1072)."""
        scene = self.scene
        if scene.skybox is None and scene.environment is None:
            return scene.atmosphere
        return None

    @staticmethod
    def _motion_same(a, b) -> bool:
        """Value equality of one motion entry (deferred.py:987-995). Tensors
        compare by identity: comparing a CUDA tensor's values would read
        the device every frame, and a caller that moves device-resident
        offsets replaces the tensor each step, so identity is the change
        signal."""
        if a is b:
            return True
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            return False
        return a.shape == b.shape and np.array_equal(a, b)

    def _observe_motion(self) -> dict:
        """Roll prev ← last ← current per-draw transforms (velocity mode,
        deferred.py:997-1036): the stacked model matrices, each skinned
        object's palette, each morphed object's weights and each instanced
        object's offsets. Value-keyed and idempotent within a frame, so
        update_dynamics followed by a rebuild cannot roll twice. Returns
        {key: previous value}; a key whose shape changed falls back to its
        current value (zero velocity for one frame)."""
        objs = self.scene.objects
        cur = {"models": stacked_models(objs)}
        for o in objs:
            if o.skin is not None:
                cur[f"joints.{o.name}"] = _joint_palette(o)
            if o.morph_deltas is not None:
                cur[f"mweights.{o.name}"] = _morph_weights(o)
            if o.instance_offsets is not None:
                cur[f"inst.{o.name}"] = o.instance_offsets
        last = self._last_motion
        if last is None:
            self._last_motion = cur
            self._prev_motion = cur
        elif set(cur) != set(last) or any(not self._motion_same(cur[k], last[k]) for k in cur):
            self._prev_motion = last
            self._last_motion = cur
        prev = self._prev_motion
        out = {}
        for k, v in cur.items():
            pv = prev.get(k, v)
            if tuple(getattr(pv, "shape", ())) != tuple(getattr(v, "shape", ())):
                pv = v
            out[k] = pv
        return out

    def _motion_dynamics(self) -> dict:
        """The velocity mode's dynamics ({name: previous value}), shared by
        render_to and frame_dynamics."""
        mo = self._observe_motion()
        d = {"def.prev_models": mo["models"]}
        for k, v in mo.items():
            if k != "models":
                kind, name = k.split(".", 1)
                d[f"def.prev_{kind}.{name}"] = _offsets_value(v)
        return d

    def reset_motion(self) -> None:
        """Drop the previous-transform history (a scene cut, a teleport):
        the next frame renders with zero per-draw velocity."""
        self._prev_motion = None
        self._last_motion = None

    def frame_dynamics(self, camera: Camera, include_models: bool = False) -> dict:
        """Per-frame dynamic values for RETAINED execution
        (deferred.py:1061-1130). Pass ``include_models=True`` when objects
        move or toggle ``SceneObject.visible`` between retained frames."""
        atmo = self._atmosphere()
        d = _camera_dynamics("def", camera,
                             want_inv_vp=(self.scene.skybox is not None
                                          or self.scene.environment is not None
                                          or atmo is not None))
        if atmo is not None:
            d["def.atmo"] = atmo.packed(float(camera.location[2]))
        sun = self.scene.sun
        if self.shadows and int(sun.cascades) > 1:
            # The cascade fits follow the camera.
            vps, splits, noffs = fit_cascades(sun, camera, int(sun.cascades))
            d["def.light_vp"] = vps
            d["def.casc_splits"] = splits
            d["def.camera_fwd"] = camera.forward
            d["def.shadow_noffs"] = noffs
        # Shadow-casting point lights may move between retained frames.
        d.update(self._omni_dynamics())
        d.update(self._animation_dynamics())
        if include_models:
            d["def.models"] = stacked_models(self.scene.objects)
        if self.velocity:
            d.update(self._motion_dynamics())
        if include_models or self.velocity:
            # Instanced objects may move their instances too (the reference
            # refreshes them only with its velocity plane).
            for o in self.scene.objects:
                if o.instance_offsets is not None:
                    d[f"def.inst.{o.name}"] = _offsets_value(o.instance_offsets)
        return d

    def _animation_dynamics(self) -> dict:
        """Each skinned object's joint palette and each morphed object's
        weights (deferred.py:1093-1098): animation is a change of values."""
        d = {}
        for o in self.scene.objects:
            if o.skin is not None:
                d[f"def.joints.{o.name}"] = _joint_palette(o)
            if o.morph_deltas is not None:
                d[f"def.mweights.{o.name}"] = _morph_weights(o)
        return d

    def pick(self, id_plane, x: int, y: int):
        """The SceneObject at framebuffer pixel (x, y) (y = 0 at the top) of
        an id plane (a readback of ``id_resource``, (H, W, 1) or (H, W), a
        numpy array or a tensor: only that pixel is read), or None for the
        background and for ids outside the scene (deferred.py:1132-1150).
        Needs ``id_buffer=True``."""
        if not self.id_buffer:
            raise ValueError("pick() needs DeferredRenderer(id_buffer=True)")
        v = int(round(float(id_plane[int(y), int(x)].reshape(-1)[0])))
        if 1 <= v <= len(self.scene.objects):
            return self.scene.objects[v - 1]
        return None

    def _omni_dynamics(self) -> dict:
        """The face matrices, position and colour of each shadow-casting
        point light (deferred.py:1097-1112, 1216-1230)."""
        d = {}
        omni = [pl for pl in self.scene.point_lights if pl.cast_shadows]
        for li, pl in enumerate(omni):
            d[f"def.omni{li}.vps"] = omni_face_matrices(pl.position, pl.shadow_near, pl.radius)
            d[f"def.omni{li}.pos"] = np.asarray(pl.position, np.float32)
            d[f"def.omni{li}.col"] = np.asarray(pl.color, np.float32) * pl.intensity
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
        env = scene.environment
        # Shadow-casting point lights leave K2's table and shade densely with
        # cube-PCF visibility (renderer.omni).
        pl_pos, pl_col, pl_rad, omni_lights = scene.light_partition()
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

        atmo = self._atmosphere()
        builder.set_dynamic("def.view_proj", camera.render_view_projection)
        builder.set_dynamic("def.camera_pos", camera.location)
        if scene.skybox is not None or env is not None or atmo is not None:
            builder.set_dynamic("def.inv_vp", camera.render_inv_view_projection)
        if atmo is not None:
            builder.set_dynamic("def.atmo", atmo.packed(float(camera.location[2])))
            if sun is None:
                # The sky still needs a sun direction to scatter from.
                builder.set_dynamic("def.sun_dir", np.asarray([0.0, 0.0, 1.0], np.float32))
        if env is not None:
            # A host environment's SH is a host array, a probe's a device
            # tensor: neither is read back.
            builder.set_dynamic("def.env_sh", env.sh9)
        else:
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
        for name, value in self._omni_dynamics().items():
            builder.set_dynamic(name, value)
        n_casc = max(1, int(sun.cascades)) if self.shadows else 1
        if self.shadows:
            builder.set_dynamic("def.shadow_bias", np.float32(sun.shadow_bias))
            if n_casc > 1:
                # Cascaded shadow maps (renderer.csm): the camera-frustum fits
                # are per-frame values and ride dynamics.
                vps, splits, noffs = fit_cascades(sun, camera, n_casc)
                builder.set_dynamic("def.light_vp", vps)  # (N, 4, 4)
                builder.set_dynamic("def.casc_splits", splits)  # (N,)
                builder.set_dynamic("def.camera_fwd", camera.forward)
                builder.set_dynamic("def.shadow_noffs", noffs)  # (N,)
            else:
                builder.set_dynamic("def.light_vp", sun_view_projection(sun))
                builder.set_dynamic(
                    "def.shadow_noffs", np.float32(sun.effective_normal_offset)
                )
        # One dynamic per FIELD, not per object×field; record closures take
        # their draw's row.
        builder.set_dynamic("def.models", stacked_models(scene.objects))
        if self.velocity:
            for k, v in self._motion_dynamics().items():
                builder.set_dynamic(k, v)
        builder.set_dynamic("def.base_colors", np.stack(
            [o.base_color_array() for o in scene.objects]
        ))
        builder.set_dynamic("def.mats", np.stack(
            [o.mat_params_array() for o in scene.objects]
        ))
        for aname, a in self._atlases.items():
            builder.set_dynamic(f"def.uvx.{aname}", a.transforms)
        for name, value in self._animation_dynamics().items():
            builder.set_dynamic(name, value)
        if self.id_buffer:
            # The 1-based object ids, one row a draw (a dynamic: no host
            # constant reaches the device inside the frame).
            builder.set_dynamic("def.oids", np.arange(
                1, len(scene.objects) + 1, dtype=np.float32)[:, None])
        # The reference's draw classes (deferred.py:1292-1310): plain opaque
        # objects share the batched passes; instanced, skinned and morphed
        # objects draw through their own nodes (their vertex stages
        # differ); translucent objects skip the opaque passes (shadow +
        # G-buffer) and draw in the glass node after lighting.
        objects = scene.objects
        plain_ix = [i for i, o in enumerate(objects)
                    if not o.translucent and o.instance_offsets is None and o.skin is None
                    and o.morph_deltas is None]
        inst_ix = [i for i, o in enumerate(objects)
                   if not o.translucent and o.instance_offsets is not None]
        trans_ix = [i for i, o in enumerate(objects) if o.translucent]
        skin_ix = [i for i, o in enumerate(objects) if o.skin is not None]
        morph_ix = [i for i, o in enumerate(objects) if o.morph_deltas is not None]
        if trans_ix and not getattr(self, "has_translucents", False):
            raise ValueError("the scene gained translucent objects after the renderer "
                             "was built: rebuild the DeferredRenderer")
        for o in objects:
            if o.instance_offsets is not None:
                builder.set_dynamic(f"def.inst.{o.name}", _offsets_value(o.instance_offsets))
        if trans_ix:
            if self.glass_peel:
                builder.set_dynamic("def.uvx.glass", self._glass_atlas.transforms)
            if self.glass_instanced:
                builder.set_dynamic("def.inst.zero", np.zeros((1, 3), np.float32))
            if sun is None:
                builder.set_dynamic("def.glass_sun_dir", np.array([0.0, 0.0, 1.0], np.float32))

        # Static batching: all plain opaque draws share ONE concatenated
        # vertex/index buffer pair, imported once per frame. Translucent
        # objects keep per-object buffers.
        static_geo = self._static_cache.get(scene.objects, plain_ix)
        per_obj_ix = inst_ix + trans_ix + skin_ix + morph_ix
        if static_geo is None:
            per_obj_ix = plain_ix + per_obj_ix
        handles = {
            i: (
                builder.import_resource(scene.objects[i].vertex_buffer),
                builder.import_resource(scene.objects[i].index_buffer),
            )
            for i in per_obj_ix
        }
        morph_handles = {i: builder.import_resource(objects[i].morph_deltas) for i in morph_ix}
        if static_geo is not None:
            s_vb_h = builder.import_resource(static_geo.vb)
            s_ib_h = builder.import_resource(static_geo.ib)
        # Material atlases: imported once, shared by every draw (rhi.atlas).
        atlas_handles = {name: builder.import_resource(a.texture)
                         for name, a in self._atlases.items()}

        g_id = None
        if self.id_buffer:
            # Exported: an app pulls it back with context.request_output (or
            # reads compiled.value) and maps pixels with ``pick``.
            g_id = builder.create(TextureDesc.color("g.id", width, height, Format.R32F))
            builder.export(g_id)
            self.id_resource = g_id
        g_albedo = builder.create(TextureDesc.color("g.albedo", width, height))
        g_normal = builder.create(TextureDesc.color("g.normal", width, height))
        g_pos = builder.create(TextureDesc.color("g.pos", width, height))
        g_prev = (builder.create(TextureDesc.color("g.prev", width, height))
                  if self.velocity else None)
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

        def animated_draws(ctx, accesses, ixs, extra, prev=False):
            """One batched draw of the skinned (``Joints``) or morphed
            (``MorphWeights``, ``MorphDeltas``) objects ``ixs``; ``prev``
            adds the previous palette or weights (the velocity plane)."""
            models = ctx.dynamic("def.models")
            draws = []
            for i in ixs:
                obj = objects[i]
                res = {"Model": models[i], **extra(i)}
                if obj.skin is not None:
                    res["Joints"] = ctx.dynamic(f"def.joints.{obj.name}")
                    if prev:
                        res["PrevJoints"] = ctx.dynamic(f"def.prev_joints.{obj.name}")
                else:
                    res["MorphWeights"] = ctx.dynamic(f"def.mweights.{obj.name}")
                    res["MorphDeltas"] = ctx.get(accesses[i][2])
                    if prev:
                        res["PrevMorphWeights"] = ctx.dynamic(f"def.prev_mweights.{obj.name}")
                draws.append((accesses[i][0], accesses[i][1], res))
            return draws

        def object_reads(node, ixs):
            """(vb, ib[, morph deltas]) reads of per-object buffers."""
            return {i: (node.read(handles[i][0]), node.read(handles[i][1]))
                    + ((node.read(morph_handles[i]),) if i in morph_handles else ())
                    for i in ixs}

        def instanced_draws(ctx, accesses, extra, prev=False):
            """One instanced draw_indexed per instanced object; ``prev``
            adds the previous offsets (the velocity plane)."""
            models = ctx.dynamic("def.models")
            for i in inst_ix:
                obj = objects[i]
                idata = {"inst_offset": ctx.dynamic(f"def.inst.{obj.name}")}
                if prev:
                    idata["prev_inst_offset"] = ctx.dynamic(f"def.prev_inst.{obj.name}")
                ctx.draw_indexed(
                    accesses[i][0], accesses[i][1], {"Model": models[i], **extra(i)},
                    instance_count=obj.instance_count, instance_data=idata,
                )

        def shadow_node(name, depth_handle, layer, matrix):
            """A depth-only pass of the plain opaque objects into the shadow
            map, or into one of its layers; ``matrix(ctx)`` gives the light's
            view-projection."""
            node = builder.add_graphic_node(name)
            accesses, s_acc = geometry_reads(node)
            sm = node.write(depth_handle, layer=layer)
            with node.pipeline(self._shadow_si, self._shadow_state) as binder:
                binder.set_depth(sm, self._shadow_depth)

            def record_shadow(ctx, accesses=accesses, s_acc=s_acc):
                ctx.bind("LightViewProj", matrix(ctx))
                if not plain_ix:  # an all-instanced scene clears only
                    return
                ctx.draw_indexed_batch(plain_draws(ctx, accesses, s_acc, lambda i: {}))

            node.execute(record_shadow)

        # -- nodes: the sun's shadow map, one layer per cascade ---------------
        # n_casc == 1: one fixed-extent map. n_casc > 1: one depth array
        # texture, each layer rendered by its own nodes (deferred.py:1380-1475).
        sm_handle = None
        if self.shadows:
            smsz = sun.shadow_map_size
            if n_casc > 1:
                sm_handle = builder.create(TextureDesc.new_2d_array(
                    "sun.shadow", smsz, smsz, n_casc, Format.D32F))
            else:
                sm_handle = builder.create(TextureDesc.depth("sun.shadow", smsz, smsz))
            for k in range(n_casc):
                layer = None if n_casc == 1 else k
                suffix = "" if n_casc == 1 else f".c{k}"

                def light_vp(ctx, k=k):
                    lvp = ctx.dynamic("def.light_vp")
                    return lvp if n_casc == 1 else lvp[k]

                shadow_node(f"shadow{suffix}", sm_handle, layer, light_vp)
                if inst_ix:
                    node = builder.add_graphic_node(f"shadow.inst{suffix}")
                    inst_acc = {i: (node.read(handles[i][0]), node.read(handles[i][1]))
                                for i in inst_ix}
                    node.read(sm_handle)
                    sm = node.write(sm_handle, layer=layer)
                    with node.pipeline(self._shadow_inst_si, self._shadow_state) as binder:
                        binder.set_depth(sm, self._shadow_depth_load)

                    def record_shadow_inst(ctx, light_vp=light_vp, inst_acc=inst_acc):
                        ctx.bind("LightViewProj", light_vp(ctx))
                        instanced_draws(ctx, inst_acc, lambda i: {})

                    node.execute(record_shadow_inst)
                # The skinned and the morphed objects' own depth passes
                # (deferred.py:1480-1560).
                for kind, ixs in (("skin", skin_ix), ("morph", morph_ix)):
                    if not ixs:
                        continue
                    node = builder.add_graphic_node(f"shadow.{kind}{suffix}")
                    anim_acc = object_reads(node, ixs)
                    node.read(sm_handle)
                    sm = node.write(sm_handle, layer=layer)
                    with node.pipeline(getattr(self, f"_shadow_{kind}_si"),
                                       self._shadow_state) as binder:
                        binder.set_depth(sm, self._shadow_depth_load)

                    def record_shadow_anim(ctx, light_vp=light_vp, anim_acc=anim_acc, ixs=ixs):
                        ctx.bind("LightViewProj", light_vp(ctx))
                        ctx.draw_indexed_batch(animated_draws(ctx, anim_acc, ixs, lambda i: {}))

                    node.execute(record_shadow_anim)

        # -- nodes: the cube faces of each shadow-casting point light ---------
        # Six render-to-layer depth passes of the plain opaque objects per
        # light (deferred.py:1553-1604).
        omni_handles = []
        for li, pl in enumerate(omni_lights):
            cube = builder.create(TextureDesc.new_cube(
                f"omni{li}.shadow", pl.shadow_map_size, Format.D32F))
            for fk in range(6):
                shadow_node(f"omni{li}.f{fk}", cube, fk,
                            lambda ctx, li=li, fk=fk: ctx.dynamic(f"def.omni{li}.vps")[fk])
            omni_handles.append(cube)

        # -- node: G-buffer (MRT) ---------------------------------------------
        node = builder.add_graphic_node("gbuffer")
        # The SPMD auto-decomposition hint (deferred.py:1608-1613): lazy, so
        # the AABB projections run only when a compile is in auto mode.
        node.set_band_hint(lambda objs=objects, ixs=tuple(plain_ix), cam=camera:
                           band_hint_for(objs, ixs, cam))
        accesses, s_acc = geometry_reads(node)
        atlas_accesses = {name: node.read(h) for name, h in atlas_handles.items()}
        a_rt = node.write(g_albedo)
        n_rt = node.write(g_normal)
        p_rt = node.write(g_pos)
        v_rt = node.write(g_prev) if g_prev is not None else None
        i_rt = node.write(g_id) if g_id is not None else None
        ds = node.write(g_depth)
        with node.pipeline(self._gbuffer_si, self._gbuffer_state) as binder:
            binder.push_color(a_rt, self._ca_clear0)
            binder.push_color(n_rt, self._ca_clear01)
            binder.push_color(p_rt, self._ca_clear0)
            if v_rt is not None:
                binder.push_color(v_rt, self._ca_clear0)
            if i_rt is not None:
                binder.push_color(i_rt, self._ca_clear0)
            binder.set_depth(ds, self._gbuffer_depth)

        id_u = ("ObjectId",) if g_id is not None else ()
        per_draw = ("BaseColor", "MatParams") + id_u + tuple(
            _UVX_NAME[a] for a in atlas_accesses)

        velocity = self.velocity

        def materials(ctx, atlases):
            """``material(i)``: the per-draw uniforms of object i (with the
            velocity plane its previous model matrix, with the id plane its
            id too)."""
            for name, acc in atlases.items():
                ctx.bind(name, ctx.get(acc))
            bcs = ctx.dynamic("def.base_colors")
            mats = ctx.dynamic("def.mats")
            prevs = ctx.dynamic("def.prev_models") if velocity else None
            oids = ctx.dynamic("def.oids") if id_u else None
            uvx = {name: ctx.dynamic(f"def.uvx.{name}") for name in atlases}

            def material(i):
                res = {"BaseColor": bcs[i], "MatParams": mats[i]}
                if prevs is not None:
                    res["PrevModel"] = prevs[i]
                if oids is not None:
                    res["ObjectId"] = oids[i]
                for name, table in uvx.items():
                    res[_UVX_NAME[name]] = table[i]
                return res

            return material

        def record_gbuffer(ctx, accesses=accesses, s_acc=s_acc):
            ctx.bind("ViewProj", ctx.dynamic("def.view_proj"))
            material = materials(ctx, atlas_accesses)
            if plain_ix:  # an all-instanced scene clears only
                ctx.draw_indexed_batch(plain_draws(ctx, accesses, s_acc, material),
                                       per_draw_uniforms=per_draw)

        node.execute(record_gbuffer)

        def gbuffer_load_node(name, si):
            """A G-buffer node that LOADs every plane and adds to it."""
            node = builder.add_graphic_node(name)
            planes = [h for h in (g_albedo, g_normal, g_pos, g_prev, g_id) if h is not None]
            for h in planes + [g_depth]:
                node.read(h)
            writes = [node.write(h) for h in planes]
            dw = node.write(g_depth)
            with node.pipeline(si, self._gbuffer_state) as binder:
                for w_ in writes:
                    binder.push_color(w_, self._ca_load)
                binder.set_depth(dw, self._gbuffer_depth_load)
            return node

        if inst_ix:
            node = gbuffer_load_node("gbuffer.inst", self._gbuffer_inst_si)
            inst_acc = {i: (node.read(handles[i][0]), node.read(handles[i][1]))
                        for i in inst_ix}
            inst_atlas = {name: node.read(h) for name, h in atlas_handles.items()}

            def record_gbuffer_inst(ctx):
                ctx.bind("ViewProj", ctx.dynamic("def.view_proj"))
                instanced_draws(ctx, inst_acc, materials(ctx, inst_atlas), prev=velocity)

            node.execute(record_gbuffer_inst)

        # The skinned and the morphed objects (deferred.py:1780-1890).
        for kind, ixs in (("skin", skin_ix), ("morph", morph_ix)):
            if not ixs:
                continue
            node = gbuffer_load_node(f"gbuffer.{kind}", getattr(self, f"_gbuffer_{kind}_si"))
            anim_acc = object_reads(node, ixs)

            def record_gbuffer_anim(ctx, anim_acc=anim_acc, ixs=ixs):
                ctx.bind("ViewProj", ctx.dynamic("def.view_proj"))
                ctx.draw_indexed_batch(
                    animated_draws(ctx, anim_acc, ixs, materials(ctx, {}), prev=velocity),
                    per_draw_uniforms=("BaseColor", "MatParams") + id_u)

            node.execute(record_gbuffer_anim)

        # -- node: decals (lambda; renderer.decal) -----------------------------
        # Projected decals rewrite the G-buffer albedo before SSAO and
        # lighting, so they receive the full PBR shading and shadows.
        if scene.decals:
            builder.set_dynamic("def.decal_mats", stacked_decal_mats(scene.decals))
            builder.set_dynamic("def.decal_cols", stacked_decal_colors(scene.decals))
            dnode = builder.add_lambda_node("decals")
            d_tex_acc = [dnode.read(builder.import_resource(d.texture))
                         if d.texture is not None else None for d in scene.decals]
            da_in = dnode.read(g_albedo)
            dp_in = dnode.read(g_pos)
            dn_in = dnode.read(g_normal)
            da_out = dnode.write(g_albedo)
            d_fades = [float(d.normal_fade) for d in scene.decals]

            def record_decals(ctx):
                am = ctx.get(da_in)
                pos = ctx.get(dp_in)[..., :3]
                nrm = ctx.get(dn_in)[..., :3]
                mats = ctx.dynamic("def.decal_mats")
                cols = ctx.dynamic("def.decal_cols")
                rgb = am[..., :3]
                for k, acc in enumerate(d_tex_acc):
                    tex = ctx.get(acc) if acc is not None else None
                    rgb = apply_decal(rgb, pos, nrm, mats[k], cols[k], tex, d_fades[k])
                ctx.set(da_out, torch.cat([rgb, am[..., 3:]], dim=-1))

            dnode.execute(record_decals)

        # -- node: SSAO (lambda, full-screen; ops.ssao) ------------------------
        ao_handle = None
        if self.ssao is not None:
            opts = self.ssao
            kern = hemisphere_kernel(opts.samples)  # tiny (K, 3) host constant
            ao_handle = builder.create(TextureDesc.color("ssao.ao", width, height, Format.R32F))
            anode = builder.add_lambda_node("ssao")
            ao_n_in = anode.read(g_normal)
            ao_p_in = anode.read(g_pos)
            ao_d_in = anode.read(g_depth)
            ao_w = anode.write(ao_handle)

            def record_ssao(ctx):
                dep = ctx.get(ao_d_in)
                banded = ctx.sharded and ctx.num_shards > 1
                tap_pos = tap_depth = None
                row0 = 0
                if banded:
                    # Taps land anywhere on screen: read them from the
                    # gathered full surfaces.
                    tap_pos = ctx.get_full(ao_p_in)[..., :3]
                    tap_depth = ctx.get_full(ao_d_in)
                    row0 = spmd.axis_index(ctx.shard_axis) * dep.shape[0]
                raw = ssao_occlusion(
                    ctx.get(ao_p_in)[..., :3], ctx.get(ao_n_in)[..., :3], dep,
                    ctx.dynamic("def.view_proj"), kern, radius=opts.radius, bias=opts.bias,
                    intensity=opts.intensity, tap_pos=tap_pos, tap_depth=tap_depth, row0=row0,
                )
                taps = opts.blur_taps
                if banded and dep.shape[0] >= taps:
                    # The vertical blur taps cross band boundaries: ring halo
                    # exchange (the bloom scheme), then crop: bit-equal to
                    # the single-device blur.
                    bh = dep.shape[0]
                    ao = ssao_blur(halo_exchange_rows(raw, ctx.shard_axis, taps),
                                   halo_exchange_rows(dep, ctx.shard_axis, taps),
                                   taps=taps, depth_tol=opts.depth_tol)[taps:taps + bh]
                else:
                    ao = ssao_blur(raw, dep, taps=taps, depth_tol=opts.depth_tol)
                ctx.set(ao_w, ao[..., None])

            anode.execute(record_ssao)

        # -- node: lighting resolve (lambda, full-screen) ----------------------
        # The environment's prefiltered cube doubles as the skybox unless the
        # scene sets one: one import, one read (deferred.py:2006-2015).
        env_handle = builder.import_resource(env.texture) if env is not None else None
        if scene.skybox is not None:
            sky_handle = builder.import_resource(scene.skybox)
        else:
            sky_handle = env_handle
        node = builder.add_lambda_node("lighting")
        a_in = node.read(g_albedo)
        n_in = node.read(g_normal)
        p_in = node.read(g_pos)
        d_in = node.read(g_depth)
        sm_in = node.read(sm_handle) if sm_handle is not None else None
        omni_in = [node.read(h) for h in omni_handles]
        omni_params = [(float(pl.shadow_near), float(pl.radius), float(pl.shadow_bias))
                       for pl in omni_lights]
        ao_in = node.read(ao_handle) if ao_handle is not None else None
        env_in = node.read(env_handle) if env_handle is not None else None
        if sky_handle is None:
            sky_in = None
        elif sky_handle is env_handle:
            sky_in = env_in  # the shared texture, read once
        else:
            sky_in = node.read(sky_handle)
        out_w = node.write(output)
        num_lights = pl_pos.shape[0]
        shadows = self.shadows
        has_sun = sun is not None
        # Variance soft shadows take the single map only (deferred.py:2039-2043).
        soft_shadows = bool(shadows and n_casc == 1 and sun.soft_shadows)
        vsm_blur = int(sun.vsm_blur) if soft_shadows else 0
        vsm_bleed = float(sun.vsm_bleed_reduction) if soft_shadows else 0.0
        contact_cfg = (
            (float(sun.contact_strength), float(sun.contact_distance),
             float(sun.contact_thickness), int(sun.contact_steps))
            if has_sun and getattr(sun, "contact_shadows", False) else None
        )

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
            # SSAO attenuates the ambient term (flat or image-based) only;
            # direct light keeps its shadow-map visibility.
            ao = ctx.get(ao_in)[..., 0:1] if ao_in is not None else None
            if env_in is not None:
                # Split-sum IBL (ops.ibl, deferred.py:2075-2100): SH diffuse
                # and the prefiltered GGX specular with the analytic env
                # BRDF replace the flat ambient term.
                levels = ctx.get(env_in)
                if not isinstance(levels, (tuple, list)):
                    levels = (levels,)
                irr = eval_irradiance_sh9(ctx.dynamic("def.env_sh"), n)
                f0 = 0.04 * (1.0 - metallic) + albedo * metallic
                ndv = torch.clamp(torch.sum(n * v, dim=-1, keepdim=True), min=1e-4)
                refl = 2.0 * ndv * n - v
                pre = sample_cube_lod(levels, refl, roughness[..., 0] * (len(levels) - 1))[..., :3]
                scale, bias = env_brdf_approx(ndv, roughness)
                ambient = albedo * (1.0 - metallic) * irr + pre * (f0 * scale + bias)
            else:
                ambient = ctx.dynamic("def.ambient") * albedo
            if ao is not None:
                ambient = ambient * ao
            color = ambient + emissive * albedo

            if has_sun:
                l = ctx.dynamic("def.sun_dir")
                contrib = _ggx_brdf(n, v, l.expand(n.shape), albedo, metallic,
                                    roughness) * ctx.dynamic("def.sun_color")
                if shadows and n_casc > 1:
                    # Cascade selection (deferred.py:2118-2160): the view
                    # distance against the split edges (a sum of compares),
                    # the pixel's light VP picked by a where over the N
                    # cascades, and the PCF taps from the pixel's layer.
                    lvps = ctx.dynamic("def.light_vp")  # (N, 4, 4)
                    splits = ctx.dynamic("def.casc_splits")  # (N,)
                    dist = torch.sum((world - cam_pos) * ctx.dynamic("def.camera_fwd"), dim=-1)
                    k_idx = torch.zeros(dist.shape, dtype=torch.int64, device=dist.device)
                    for i in range(n_casc - 1):
                        k_idx = k_idx + (dist > splits[i]).to(torch.int64)
                    noff_px = ctx.dynamic("def.shadow_noffs")[k_idx][..., None]
                    sample_pos = world + n * noff_px
                    hom = torch.cat([sample_pos, torch.ones_like(world[..., :1])], dim=-1)
                    lclip = torch.zeros_like(hom)
                    for i in range(n_casc):
                        lclip = torch.where((k_idx == i)[..., None], hom @ lvps[i].T, lclip)
                    uv = torch.stack(
                        [(lclip[..., 0] + 1) * 0.5, (lclip[..., 1] + 1) * 0.5], -1
                    )
                    ref = lclip[..., 2] - ctx.dynamic("def.shadow_bias")
                    lit = sample_shadow_pcf_layered(ctx.get(sm_in), k_idx, uv, ref,
                                                    _SHADOW_SAMPLER)
                    # Beyond the last split, or off every map: lit.
                    inside = (
                        (uv[..., 0] >= 0) & (uv[..., 0] <= 1)
                        & (uv[..., 1] >= 0) & (uv[..., 1] <= 1)
                        & (dist <= splits[n_casc - 1])
                    )
                    contrib = contrib * torch.where(inside, lit, torch.ones_like(lit))[..., None]
                elif shadows:
                    sample_pos = world + n * ctx.dynamic("def.shadow_noffs")
                    hom = torch.cat([sample_pos, torch.ones_like(world[..., :1])], dim=-1)
                    lclip = hom @ ctx.dynamic("def.light_vp").T
                    uv = torch.stack(
                        [(lclip[..., 0] + 1) * 0.5, (lclip[..., 1] + 1) * 0.5], -1
                    )
                    ref = lclip[..., 2] - ctx.dynamic("def.shadow_bias")
                    if soft_shadows:
                        # VSM (ops.vsm, deferred.py:2165-2180): the moments
                        # are derived and blurred from the depth map here,
                        # then one bilinear fetch.
                        moments = depth_to_moments(ctx.get_full(sm_in), taps=vsm_blur)
                        lit = sample_vsm(moments, uv, ref, bleed_reduction=vsm_bleed)
                    else:
                        lit = sample_shadow_pcf(ctx.get_full(sm_in), uv, ref, _SHADOW_SAMPLER)
                    inside = (
                        (uv[..., 0] >= 0) & (uv[..., 0] <= 1)
                        & (uv[..., 1] >= 0) & (uv[..., 1] <= 1)
                    )
                    contrib = contrib * torch.where(inside, lit, torch.ones_like(lit))[..., None]
                if contact_cfg is not None:
                    # Contact shadows: a short G-buffer march toward the sun
                    # (ops.contact) closes the shadow map's bias leak.
                    c_str, c_dist, c_thick, c_steps = contact_cfg
                    row0 = 0
                    tap_p, tap_d = world, depth
                    if ctx.sharded and ctx.num_shards > 1:
                        # The march reaches across bands: taps read the
                        # gathered full surfaces.
                        row0 = spmd.axis_index(ctx.shard_axis) * depth.shape[0]
                        tap_p = ctx.get_full(p_in)[..., :3]
                        tap_d = ctx.get_full(d_in)
                    cvis = contact_shadow_factor(
                        world, depth, tap_p, tap_d, l, cam_pos, ctx.dynamic("def.view_proj"),
                        strength=c_str, max_dist=c_dist, thickness=c_thick, steps=c_steps,
                        row0=row0,
                    )
                    contrib = contrib * cvis[..., None]
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

            # Shadow-casting point lights (deferred.py:2233-2262): the dense
            # BRDF with the kernel's distance window, times cube-PCF
            # visibility from the light's faces.
            for li, (o_near, o_far, o_bias) in enumerate(omni_params):
                to_l = ctx.dynamic(f"def.omni{li}.pos") - world
                d2 = torch.clamp(torch.sum(to_l * to_l, dim=-1), min=1e-8)
                dist = torch.sqrt(d2)
                ldir = to_l / dist[..., None]
                win = torch.clamp(1.0 - (dist / o_far) ** 4, 0.0, 1.0) ** 2
                contrib = _ggx_brdf(n, v, ldir, albedo, metallic, roughness) \
                    * ctx.dynamic(f"def.omni{li}.col") * (win / d2)[..., None]
                l2f = -to_l
                face, uv = cube_direction_to_face_uv(l2f)
                zref = omni_reference_z(torch.amax(torch.abs(l2f), dim=-1) - o_bias, o_near, o_far)
                vis = sample_shadow_pcf_layered(ctx.get(omni_in[li]), face, uv, zref,
                                                _SHADOW_SAMPLER)
                vis = torch.where(dist < o_far, vis, torch.ones_like(vis))
                color = color + contrib * vis[..., None]

            if sky_in is not None or atmo is not None:
                # Per-pixel view rays for the background: cube-sample them
                # (texture.rs:94-105) or feed the procedural atmosphere's
                # march (ops.atmosphere).
                hh, ww = depth.shape
                full_h, row0 = hh, 0
                if ctx.sharded and ctx.num_shards > 1:
                    full_h = hh * ctx.num_shards
                    row0 = spmd.axis_index(ctx.shard_axis) * hh
                dirs = view_rays(ctx.dynamic("def.inv_vp"), cam_pos, hh, ww, row0, full_h)
                if sky_in is not None:
                    sky = ctx.get(sky_in)
                    if isinstance(sky, (tuple, list)):
                        sky = sky[0]  # the environment's level 0
                    bg = sample_cube(sky, dirs)[..., :3]
                else:
                    rays = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True))
                    bg = sky_radiance(rays, ctx.dynamic("def.sun_dir"), ctx.dynamic("def.atmo"),
                                      atmo)
            else:
                bg = ctx.dynamic("def.background").expand(color.shape)
            rgb = torch.where(covered, color, bg)
            ctx.set(out_w, torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1))

        node.execute(record_lighting)

        # -- node: glass (translucent forward pass over the lit HDR) -----------
        if trans_ix:
            gnode = builder.add_graphic_node("glass")
            g_acc = {i: (gnode.read(handles[i][0]), gnode.read(handles[i][1]))
                     for i in trans_ix}
            glass_tex_acc = {}
            glass_atlas_acc = None
            if self.glass_peel:
                glass_atlas_acc = gnode.read(builder.import_resource(self._glass_atlas.texture))
            elif self.glass_textured:
                for i in trans_ix:
                    t = objects[i].base_color_texture or self._white_glass_tex
                    glass_tex_acc[i] = gnode.read(builder.import_resource(t))
            gnode.read(output)
            gnode.read(g_depth)
            out_rt = gnode.write(output)
            out_ds = gnode.write(g_depth)
            with gnode.pipeline(self._glass_si, self._glass_state) as binder:
                binder.push_color(out_rt, self._glass_over)
                binder.set_depth(out_ds, self._glass_depth)
            glass_textured = self.glass_textured
            glass_instanced = self.glass_instanced
            glass_peel = self.glass_peel
            peel_layers = self.glass_peel_layers

            def record_glass(ctx):
                ctx.bind("ViewProj", ctx.dynamic("def.view_proj"))
                sun_dir = ctx.dynamic("def.sun_dir" if has_sun else "def.glass_sun_dir")
                models = ctx.dynamic("def.models")
                bcs = ctx.dynamic("def.base_colors")
                atlas_val = ctx.get(glass_atlas_acc) if glass_peel else None
                glass_uvx = ctx.dynamic("def.uvx.glass") if glass_peel else None
                draws = []
                for k, i in enumerate(trans_ix):
                    obj = objects[i]
                    vba, iba = g_acc[i]
                    res = {
                        "Model": models[i],
                        "ViewProj": ctx.dynamic("def.view_proj"),
                        "BaseColor": bcs[i],
                        "SunDir": sun_dir,
                    }
                    if glass_peel:
                        # Atlas cell transform of this translucent (k-th in
                        # scene order: the atlas was built over the same
                        # filtered order).
                        res["GlassAtlas"] = atlas_val
                        res["UvxGlass"] = glass_uvx[k]
                    elif glass_textured:
                        res["GlassTex"] = ctx.get(glass_tex_acc[i])
                    if glass_instanced:
                        # One pipeline for the whole batch: non-instanced
                        # translucents draw as a single zero-offset instance.
                        instanced = obj.instance_offsets is not None
                        inst = {
                            "instance_count": obj.instance_count if instanced else 1,
                            "instance_data": {"inst_offset": ctx.dynamic(
                                f"def.inst.{obj.name}" if instanced else "def.inst.zero")},
                        }
                        draws.append((vba, iba, res, inst))
                    else:
                        draws.append((vba, iba, res))
                if glass_peel:
                    ctx.draw_indexed_batch(
                        draws, per_draw_uniforms=("BaseColor", "UvxGlass"),
                        peel_layers=peel_layers,
                    )
                else:
                    ctx.draw_indexed_batch(draws)

            gnode.execute(record_glass)

        # Screen-space consumers declared after this renderer read this
        # frame's G-buffer planes through these handles.
        self.gbuffer_handles = GBufferHandles({
            "albedo": g_albedo,
            "normal": g_normal,
            "pos": g_pos,
            "depth": g_depth,
        })
        self.gbuffer_handles.animated_without_velocity = self.scene_animated and not self.velocity
        if g_prev is not None:
            # The velocity plane: TAA and motion blur reproject with it.
            self.gbuffer_handles["prev_pos"] = g_prev
        if self.shadows:
            self.gbuffer_handles["sun_shadow"] = sm_handle
