"""Host arrays → the port's tensors.

The reference package's results reach the port as numpy arrays (buffer
contents, ``TriangleRecords``, ``SegmentedBins``, ``TileBins``, stencil
planes and face states, scene objects, light tables, 2D and cube textures,
materials, the sky, decals, environments, skins and animation clips, the
screen-space passes' settings, the post and temporal passes' settings and
state, depth of field, the HUD and the particle system's state);
these helpers turn them into the port's tensors and objects on a given
device, field for field, so the same inputs can be fed to both
implementations. They read the reference's objects by attribute name
and ``np.asarray`` only, so the port still imports nothing of it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from zenith_tpu_torch.ops.binning import SegmentedBins, TileBins
from zenith_tpu_torch.ops.geometry import TriangleRecords
from zenith_tpu_torch.rhi.formats import Format
from zenith_tpu_torch.rhi.resource import Buffer, BufferUsage, Texture, TextureDesc, TextureUsage


def to_tensor(array: Any, device: "torch.device | str") -> torch.Tensor:
    """Any array-like (numpy, or anything ``np.asarray`` takes) → a tensor
    with the same dtype and contents on ``device``."""
    return torch.from_numpy(np.array(array, copy=True)).to(device)


def records_from_numpy(records: Any, device: "torch.device | str") -> TriangleRecords:
    """A (rast16, shade16, tri_id, valid, aabb) tuple of arrays → records."""
    return TriangleRecords(*[to_tensor(f, device) for f in records])


def bins_from_numpy(bins: Any, device: "torch.device | str") -> SegmentedBins:
    """The seven fields of a SegmentedBins, as arrays → SegmentedBins."""
    return SegmentedBins(*[to_tensor(f, device) for f in bins])


def tile_bins_from_numpy(bins: Any, device: "torch.device | str") -> TileBins:
    """The four fields of a TileBins (capped bins), as arrays → TileBins."""
    return TileBins(*[to_tensor(f, device) for f in bins])


def buffer_from(buffer: Any, device: "torch.device | str") -> Buffer:
    """A buffer with ``.desc.name``, ``.desc.usage`` and ``.array`` → the
    port's Buffer with the same name, contents and usage flags."""
    usage = BufferUsage(int(buffer.desc.usage.value))
    return Buffer.from_numpy(buffer.desc.name, np.array(buffer.array, copy=True), usage,
                             device=torch.device(device))


def cube_texture_from(texture: Any, device: "torch.device | str") -> Texture:
    """A cube-map texture (6, S, S, C) linear float → the port's cube Texture."""
    return Texture.from_numpy_layers(texture.desc.name, np.asarray(texture.array, np.float32),
                                     Format.RGBA32F, cube=True, device=torch.device(device))


def texture_from(texture: Any, device: "torch.device | str") -> Texture:
    """A 2D texture (H, W, C) → the port's Texture with the same name and
    linear float pixels, and its mip chain where it has one."""
    device = torch.device(device)
    mips = getattr(texture, "mips", None)
    if not mips:
        return Texture.from_numpy(texture.desc.name, np.asarray(texture.host_linear(), np.float32),
                                  Format.RGBA32F, device=device)
    levels = [to_tensor(np.asarray(m, np.float32), device) for m in mips]
    desc = TextureDesc(texture.desc.name, texture.desc.width, texture.desc.height,
                       Format.RGBA32F, TextureUsage.SAMPLED, mip_levels=len(levels))
    return Texture(desc, levels[0], mips=levels,
                   host_pixels=np.asarray(texture.host_linear(), np.float32))


def material_from(material: Any):
    """A baked material (factors and up to four TextureAssets) → the port's
    ``asset.Material`` with the same URL, factors and pixels."""
    from zenith_tpu_torch.asset import AssetUrl, Material, TextureAsset, TextureFormat

    def tex(t):
        return None if t is None else TextureAsset(
            AssetUrl(str(t.url)), np.array(t.pixels, copy=True), TextureFormat(t.format.value))

    return Material(
        AssetUrl(str(material.url)),
        base_color_factor=material.base_color_factor,
        metallic_factor=material.metallic_factor,
        roughness_factor=material.roughness_factor,
        emissive_factor=material.emissive_factor,
        **{slot: tex(getattr(material, slot)) for slot in Material._TEX_SLOTS},
    )


def stencil_state_from(face: Any):
    """A per-face stencil state (ops and compare as enums with ``.name``;
    masks and reference as ints) → the port's StencilOpState."""
    from zenith_tpu_torch.rhi.state import CompareOp, StencilOp, StencilOpState

    return StencilOpState(
        fail_op=StencilOp[face.fail_op.name], pass_op=StencilOp[face.pass_op.name],
        depth_fail_op=StencilOp[face.depth_fail_op.name],
        compare_op=CompareOp[face.compare_op.name], compare_mask=int(face.compare_mask),
        write_mask=int(face.write_mask), reference=int(face.reference),
    )


_OBJECT_FIELDS = ("base_color", "metallic", "roughness", "emissive", "bin_capacity",
                  "entry_budget", "visible", "tri_count")


_TEXTURE_FIELDS = ("base_color_texture", "normal_texture", "mra_texture", "emissive_texture")


def skin_from(skin: Any):
    """A joint hierarchy (inverse binds, parents, rest pose, pre-matrices)
    → the port's ``Skin`` with the same arrays."""
    from zenith_tpu_torch.asset.render_types import Skin

    return Skin(*(np.asarray(getattr(skin, k)) for k in (
        "inverse_bind", "parents", "rest_t", "rest_r", "rest_s", "pre")))


def clip_from(clip: Any):
    """An animation clip → the port's ``AnimationClip``, channel for channel."""
    from zenith_tpu_torch.asset.render_types import AnimationChannel, AnimationClip

    return AnimationClip(clip.name, [
        AnimationChannel(ch.joint, ch.path, np.asarray(ch.times), np.asarray(ch.values),
                         getattr(ch, "interpolation", "LINEAR")) for ch in clip.channels],
        clip.duration)


def _host_or_none(value: Any):
    return None if value is None else np.asarray(value, np.float32)


def scene_object_from(obj: Any, device: "torch.device | str"):
    """A scene object (buffers, model matrix, material factors, instance
    offsets, skin, palette and clips, morph deltas and weights) → the
    port's SceneObject with the same numbers and its four material
    textures (mips included); per-frame values (offsets, palette, weights)
    cross as host arrays."""
    from zenith_tpu_torch.renderer.scene import SceneObject

    kwargs = {k: getattr(obj, k) for k in _OBJECT_FIELDS}
    if getattr(obj, "bounds", None) is not None:
        kwargs["bounds"] = np.asarray(obj.bounds, np.float32)
    for k in _TEXTURE_FIELDS:
        t = getattr(obj, k)
        kwargs[k] = None if t is None else texture_from(t, device)
    return SceneObject(
        name=obj.name,
        vertex_buffer=buffer_from(obj.vertex_buffer, device),
        index_buffer=buffer_from(obj.index_buffer, device),
        model_matrix=np.asarray(obj.model_matrix, np.float32),
        translucent=bool(obj.translucent),
        instance_offsets=_host_or_none(obj.instance_offsets),
        skin=None if obj.skin is None else skin_from(obj.skin),
        joint_matrices=_host_or_none(obj.joint_matrices),
        clips=None if not obj.clips else [clip_from(c) for c in obj.clips],
        morph_deltas=(None if obj.morph_deltas is None
                      else buffer_from(obj.morph_deltas, device)),
        morph_weights=_host_or_none(obj.morph_weights),
        **kwargs,
    )


def _copy_dataclass(cls, src):
    """``cls`` built from the same-named fields of ``src``."""
    import dataclasses

    return cls(**{f.name: getattr(src, f.name) for f in dataclasses.fields(cls)})


def atmosphere_from(atmosphere: Any):
    """A procedural-sky config → the port's ``Atmosphere``, field for field."""
    from zenith_tpu_torch.ops.atmosphere import Atmosphere

    return _copy_dataclass(Atmosphere, atmosphere)


def decal_from(decal: Any, device: "torch.device | str"):
    """A decal (box, projection, colour, fade, optional texture) → the
    port's ``Decal``, its texture on ``device``."""
    import dataclasses

    from zenith_tpu_torch.renderer.decal import Decal

    return dataclasses.replace(
        _copy_dataclass(Decal, decal),
        texture=None if decal.texture is None else texture_from(decal.texture, device))


def ssao_options_from(options: Any):
    """SSAO settings → the port's ``SSAOOptions`` with the same fields."""
    from zenith_tpu_torch.renderer.deferred import SSAOOptions

    return SSAOOptions(samples=options.samples, radius=options.radius, bias=options.bias,
                       intensity=options.intensity, blur_taps=options.blur_taps,
                       depth_tol=options.depth_tol)


def ssr_from(ssr: Any):
    """Screen-space-reflection settings → the port's ``ScreenSpaceReflections``."""
    from zenith_tpu_torch.renderer.ssr import ScreenSpaceReflections

    return ScreenSpaceReflections(steps=ssr.steps, refine=ssr.refine,
                                  max_distance=ssr.max_distance, thickness=ssr.thickness,
                                  strength=ssr.strength, max_roughness=ssr.max_roughness,
                                  jitter=ssr.jitter)


def fog_from(fog: Any):
    """Volumetric-fog settings → the port's ``VolumetricFog``."""
    from zenith_tpu_torch.renderer.volumetric import VolumetricFog

    return VolumetricFog(density=fog.density, height=fog.height,
                         height_falloff=fog.height_falloff, anisotropy=fog.anisotropy,
                         max_distance=fog.max_distance, sun_boost=fog.sun_boost,
                         ambient=fog.ambient, steps=fog.steps, jitter=fog.jitter,
                         shafts=fog.shafts)


def flare_from(flare: Any):
    """Lens-flare settings → the port's ``LensFlare``, field for field."""
    from zenith_tpu_torch.renderer.flare import LensFlare

    return _copy_dataclass(LensFlare, flare)


def environment_from(env: Any, device: "torch.device | str"):
    """An environment light (a mipped cube texture and its (9, 3) SH) →
    the port's ``EnvironmentLight`` with the same mips on ``device`` and the
    same coefficients as a host array."""
    from zenith_tpu_torch.renderer.environment import EnvironmentLight, _cube_texture

    mips = [to_tensor(np.asarray(m, np.float32), device) for m in env.texture.mips]
    host = getattr(env.texture, "host_pixels", None)
    tex = _cube_texture(env.texture.desc.name, mips,
                        None if host is None else np.asarray(host, np.float32))
    return EnvironmentLight(tex, np.asarray(env.sh9, np.float32))


def color_grade_from(grade: Any):
    """A colour grade → the port's ``ColorGrade`` with the same knobs."""
    from zenith_tpu_torch.renderer.post import ColorGrade

    return ColorGrade(exposure_ev=grade.exposure_ev, contrast=grade.contrast,
                      saturation=grade.saturation, temperature=grade.temperature,
                      tint=grade.tint, vignette=grade.vignette)


def film_from(film: Any):
    """Film effects → the port's ``FilmEffects``, its grain seed included."""
    from zenith_tpu_torch.renderer.post import FilmEffects

    out = FilmEffects(chromatic_aberration=film.chromatic_aberration, sharpen=film.sharpen,
                      grain=film.grain, grain_response=film.grain_response)
    out._seed = int(film._seed)
    return out


def post_process_from(post: Any):
    """A post chain's settings (bloom, tonemap, FXAA, auto-exposure, grade,
    film) → the port's ``PostProcess``; the adapted-exposure state and the
    frame delta cross as well (the state as a host array)."""
    from zenith_tpu_torch.renderer.post import PostProcess

    out = PostProcess(
        bloom_threshold=post.bloom_threshold, bloom_strength=post.bloom_strength,
        tonemap=post.tonemap, bloom_mips=post.bloom_mips, fxaa=post.fxaa,
        auto_exposure=post.auto_exposure, exposure_key=post.exposure_key,
        adapt_speed=post.adapt_speed, exposure_min=post.exposure_min,
        exposure_max=post.exposure_max,
        grade=None if post.grade is None else color_grade_from(post.grade),
        film=None if post.film is None else film_from(post.film))
    out._dt = float(post._dt)
    if post._ae_state is not None:
        out._ae_state = np.asarray(post._ae_state, np.float32)
    return out


def temporal_aa_from(taa: Any):
    """TAA's settings and jitter position → the port's ``TemporalAA``."""
    from zenith_tpu_torch.renderer.taa import TemporalAA

    out = TemporalAA(alpha=taa.alpha, sequence_length=len(taa._seq))
    out._frame = int(taa._frame)
    return out


def motion_blur_from(blur: Any):
    """Motion-blur settings → the port's ``MotionBlur``."""
    from zenith_tpu_torch.renderer.motion_blur import MotionBlur

    return MotionBlur(strength=blur.strength, max_radius=blur.max_radius,
                      samples=blur.samples, jitter=blur.jitter, dilate=blur.dilate)


def depth_of_field_from(dof: Any):
    """Depth-of-field settings → the port's ``DepthOfField``."""
    from zenith_tpu_torch.renderer.dof import DepthOfField

    return DepthOfField(focus_distance=dof.focus_distance, focal_range=dof.focal_range,
                        strength=dof.strength, levels=dof.levels)


def hud_from(hud: Any):
    """A HUD overlay (settings and text) → the port's ``HudOverlay`` with
    the same bitmap."""
    from zenith_tpu_torch.renderer.hud import HudOverlay

    out = HudOverlay(max_chars=hud.max_chars, scale=hud.scale, color=hud.color,
                     background=hud.background, margin=hud.margin,
                     overflow_indicator=hud.overflow_indicator)
    out.set_text(hud._text)
    return out


def particle_system_from(psys: Any, device: "torch.device | str"):
    """A particle system (count, emitter, sim settings, state, positions and
    tick) → the port's ``ParticleSystem`` with its state on ``device``."""
    from zenith_tpu_torch.renderer.particles import ParticleSystem

    out = ParticleSystem(psys.count, emitter=np.asarray(psys.emitter, np.float32),
                         device=device, **psys.sim_kwargs)
    out._state = to_tensor(np.asarray(psys._state, np.float32), device)
    out._positions = to_tensor(np.asarray(psys.positions, np.float32), device)
    out._tick = int(psys._tick)
    return out


def scene_from(scene: Any, device: "torch.device | str"):
    """A scene (objects with their instance offsets, the sun with its
    contact-shadow, cascade and soft-shadow fields, point lights with their
    cube-shadow fields, spot lights, ambient, skybox, environment,
    atmosphere, decals) → the port's Scene on ``device`` with the same
    numbers. The lights are copied field for field, so every shadow setting
    crosses."""
    from zenith_tpu_torch.renderer.scene import DirectionalLight, PointLight, Scene, SpotLight

    return Scene(
        objects=[scene_object_from(o, device) for o in scene.objects],
        sun=None if scene.sun is None else _copy_dataclass(DirectionalLight, scene.sun),
        point_lights=[_copy_dataclass(PointLight, pl) for pl in scene.point_lights],
        spot_lights=[_copy_dataclass(SpotLight, sl) for sl in scene.spot_lights],
        ambient=tuple(scene.ambient),
        skybox=None if scene.skybox is None else cube_texture_from(scene.skybox, device),
        decals=[decal_from(d, device) for d in scene.decals],
        environment=(None if scene.environment is None
                      else environment_from(scene.environment, device)),
        atmosphere=None if scene.atmosphere is None else atmosphere_from(scene.atmosphere),
    )
