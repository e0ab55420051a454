"""Scene description shared by the feature renderers (torch port of
zenith_tpu/renderer/scene.py).

The minimal object/light model of BASELINE.md configs #3-#5: drawables with
mesh buffers, transforms and PBR material factors; a sun, point and spot
lights; ambient light and an optional cube-map skybox. Buffers live on the
render device's ``torch.device``; everything else is host NumPy that the
renderers send as per-frame dynamics. ``band_hint_for`` projects the
objects' bounds to screen rows for the SPMD ``auto`` decomposition.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from zenith_tpu_torch.asset.render_types import Mesh as MeshAsset
from zenith_tpu_torch.rhi import BufferUsage, Format, Texture
from zenith_tpu_torch.rhi.device import RenderDevice
from zenith_tpu_torch.rhi.resource import Buffer


@dataclass
class SceneObject:
    """One drawable: mesh buffers + transform + PBR material factors."""

    name: str
    vertex_buffer: Buffer
    index_buffer: Buffer
    model_matrix: np.ndarray
    base_color: "tuple" = (1.0, 1.0, 1.0, 1.0)
    metallic: float = 0.0
    roughness: float = 0.6
    emissive: "tuple" = (0.0, 0.0, 0.0)
    base_color_texture: "Optional[Texture]" = None
    # Full PBR material texture set (reference render.rs:135-176 bakes all
    # four; the deferred renderer samples them via per-map atlases):
    # normal = tangent-space RGB (0.5,0.5,1 = flat), mra = glTF
    # metallic-roughness (B=metallic, G=roughness, R=occlusion), emissive RGB.
    normal_texture: "Optional[Texture]" = None
    mra_texture: "Optional[Texture]" = None
    emissive_texture: "Optional[Texture]" = None
    bin_capacity: int = 1024
    # tile×record pair budget for the segmented binner; None → 2×records.
    # Raise when the frame-stats bin-overflow counter fires (close-ups bin
    # each triangle into many tiles).
    entry_budget: "Optional[int]" = None
    # Instanced rendering (vkCmdDrawIndexed instanceCount): (I, 3) world
    # translations, one per instance. The renderers draw the object once
    # with instance_count=I; the vertex stage adds the per-instance offset.
    instance_offsets: "Optional[np.ndarray]" = None
    # Translucent objects draw AFTER the lighting resolve through the
    # order-correct in-kernel blend path (ops.raster._segmented_blend_kernel)
    # with src-alpha-over blending; base_color's alpha is the opacity.
    translucent: bool = False
    # Show/hide WITHOUT recompiling: visibility rides the per-frame model-
    # matrix dynamic (hidden → zero matrix → every triangle lands at
    # clip-space w=0 and the near clipper rejects it), so toggling changes
    # nothing in the frame function's structure — the cached one is reused. Hidden
    # objects cast no shadows either (the shadow pass shares the matrix).
    # NOTE: this is a VALUE change, deliberately absent from the capture
    # key, so toggling it reuses the cached frame function.
    visible: bool = True
    # Skeletal skinning: a Skin (asset.render_types) marks the vertex
    # buffer as SkinnedVertex layout (16 floats: +joints/weights); the
    # deferred renderer draws the object through its skinned pipelines.
    # ``joint_matrices`` is the per-frame (J,4,4) palette (world @
    # inverse_bind, renderer/animation.AnimationPlayer), a dynamic value:
    # animating it never builds a new frame function.
    skin: "Optional[object]" = None
    joint_matrices: "Optional[np.ndarray]" = None
    # AnimationClips carried from the mesh asset (renderer/animation.py
    # samples one into joint_matrices or morph_weights each frame).
    clips: "Optional[list]" = None
    # Morph targets: a (T, N, 3) POSITION-delta rhi Buffer (imported once)
    # and the per-frame (T,) weights (a dynamic);
    # pos' = pos + Σ w_t · delta_t in the vertex stage.
    morph_deltas: "Optional[Buffer]" = None
    morph_weights: "Optional[np.ndarray]" = None
    # Object-space AABB ((2, 3) min/max) + triangle count: performance
    # metadata for the SPMD auto-decomposition (parallel="auto" band
    # hints — renderers project these per frame). from_mesh/quad populate
    # them; objects built from raw device buffers may leave them unset
    # (such draws hint full-extent, which never tips the choice).
    bounds: "Optional[np.ndarray]" = None
    tri_count: int = 0

    @property
    def instance_count(self) -> int:
        return 1 if self.instance_offsets is None else len(self.instance_offsets)

    def base_color_array(self) -> np.ndarray:
        """float32 base color, cached by value (the per-frame np.asarray
        of a tuple measured on the host path)."""
        key = tuple(map(float, self.base_color))
        cache = self.__dict__.get("_bc_cache")
        if cache is not None and cache[0] == key:
            return cache[1]
        arr = np.asarray(key, np.float32)
        self.__dict__["_bc_cache"] = (key, arr)
        return arr

    def mat_params_array(self) -> np.ndarray:
        """(metallic, roughness, emissive_luma, 0) float32, cached by
        value."""
        em = tuple(map(float, np.atleast_1d(np.asarray(self.emissive))))
        key = (float(self.metallic), float(self.roughness), em)
        cache = self.__dict__.get("_mat_cache")
        if cache is not None and cache[0] == key:
            return cache[1]
        lum = sum(em) / max(len(em), 1)
        arr = np.asarray(
            [key[0], key[1], lum, 0.0], np.float32
        )
        self.__dict__["_mat_cache"] = (key, arr)
        return arr

    def __zenith_capture_key__(self):
        """Structure-shaping fields only (the render-graph capture-key protocol,
        rendergraph.graph._capture_key). The np arrays (model_matrix,
        instance_offsets) and material VALUES ride through builder dynamics
        in every framework renderer, so only their shapes + the scalar
        fields that a custom closure could bake are keyed — this runs every
        frame, and content-walking the arrays cost a measurable slice of
        the host frame budget."""
        return (
            "scene-obj", self.name,
            ("b", self.vertex_buffer.desc.shape, self.index_buffer.desc.shape),
            self.bin_capacity, self.entry_budget,
            None if self.instance_offsets is None
            else tuple(self.instance_offsets.shape),
            self.translucent,
            None if self.skin is None else int(self.skin.num_joints),
            None if self.morph_deltas is None
            else tuple(self.morph_deltas.shape),
            self.base_color_texture is not None,
            self.normal_texture is not None,
            self.mra_texture is not None,
            self.emissive_texture is not None,
            float(self.metallic), float(self.roughness),
            tuple(map(float, self.base_color)),
            tuple(map(float, self.emissive)),
        )

    @staticmethod
    def from_mesh(device: RenderDevice, mesh: MeshAsset, name: str,
                  model_matrix: "Optional[np.ndarray]" = None, **kwargs) -> "SceneObject":
        pos = np.asarray(mesh.vertices, np.float32)[:, :3]
        kwargs.setdefault("bounds", np.stack([pos.min(0), pos.max(0)]))
        kwargs.setdefault(
            "tri_count", int(np.asarray(mesh.indices).size) // 3
        )
        skinned = mesh.is_skinned
        return SceneObject(
            name=name,
            vertex_buffer=device.upload_buffer(
                f"{name}.vb", mesh.skinned_vertices() if skinned else mesh.vertices,
                BufferUsage.VERTEX),
            index_buffer=device.upload_buffer(f"{name}.ib", mesh.indices, BufferUsage.INDEX),
            model_matrix=(np.asarray(model_matrix, np.float32)
                          if model_matrix is not None else np.eye(4, dtype=np.float32)),
            skin=mesh.skin if skinned else None,
            clips=list(mesh.clips) or None,
            morph_deltas=(
                device.upload_buffer(f"{name}.morph", mesh.morph_deltas, BufferUsage.STORAGE)
                if mesh.morph_deltas is not None else None),
            **kwargs,
        )

    @staticmethod
    def from_mesh_with_material(
        device: RenderDevice, mesh: MeshAsset, material, name: str,
        model_matrix: "Optional[np.ndarray]" = None, **kwargs,
    ) -> "SceneObject":
        """A SceneObject from a baked ``asset.Material`` (scene.py:195-236):
        the factors and the full texture set (render.rs:135-176: base
        colour, metallic-roughness, normal, emissive) uploaded onto
        ``device``'s torch device. Colour and emissive maps decode as sRGB
        with mips; normal and metallic-roughness data is linear (glTF 2.0
        §3.9.3) whatever the 8-bit container, and the normal map gets no
        mips."""

        def upload(tex_asset, srgb: bool, generate_mips: bool = True):
            if tex_asset is None:
                return None
            fmt = tex_asset.format.device_format
            if not srgb and fmt == Format.RGBA8_SRGB:
                fmt = Format.RGBA8_UNORM
            return Texture.from_numpy(str(tex_asset.url), tex_asset.pixels, fmt,
                                      generate_mips=generate_mips, device=device.device)

        return SceneObject.from_mesh(
            device, mesh, name, model_matrix=model_matrix,
            base_color=material.base_color_factor,
            metallic=material.metallic_factor,
            roughness=material.roughness_factor,
            emissive=material.emissive_factor,
            base_color_texture=upload(material.base_color_texture, srgb=True),
            normal_texture=upload(material.normal_texture, srgb=False, generate_mips=False),
            mra_texture=upload(material.metallic_roughness_texture, srgb=False),
            emissive_texture=upload(material.emissive_texture, srgb=True),
            **kwargs,
        )

    @staticmethod
    def cube(device: RenderDevice, name: str, size: float = 10.0,
             z0: float = 0.0, **kwargs) -> "SceneObject":
        """Axis-aligned cube (z-up world) sitting on z = z0, outward
        normals, wound for the glTF pipeline state (CCW fronts)."""
        s = size * 0.5
        cz = z0 + s
        faces = [
            ((0, 0, 1), [(-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]),
            ((0, 0, -1), [(-s, s, -s), (s, s, -s), (s, -s, -s), (-s, -s, -s)]),
            ((1, 0, 0), [(s, -s, -s), (s, s, -s), (s, s, s), (s, -s, s)]),
            ((-1, 0, 0), [(-s, s, -s), (-s, -s, -s), (-s, -s, s), (-s, s, s)]),
            ((0, 1, 0), [(s, s, -s), (-s, s, -s), (-s, s, s), (s, s, s)]),
            ((0, -1, 0), [(-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s)]),
        ]
        verts, idx = [], []
        uv = [(0, 0), (1, 0), (1, 1), (0, 1)]
        for n, corners in faces:
            base = len(verts)
            for (x, y, zc), (u, v) in zip(corners, uv):
                verts.append([x, y, zc + cz, *n, u, v])
            idx += [base, base + 1, base + 2, base, base + 2, base + 3]
        v = np.asarray(verts, np.float32)
        return SceneObject(
            name=name,
            vertex_buffer=device.upload_buffer(
                f"{name}.vb", v, BufferUsage.VERTEX
            ),
            index_buffer=device.upload_buffer(
                f"{name}.ib", np.asarray(idx, np.int32), BufferUsage.INDEX
            ),
            model_matrix=np.eye(4, dtype=np.float32),
            bin_capacity=64,
            **kwargs,
        )

    @staticmethod
    def quad(device: RenderDevice, name: str, size: float = 200.0,
             z: float = 0.0, **kwargs) -> "SceneObject":
        """A ground plane in the z-up world, facing +Z."""
        s = size * 0.5
        verts = np.array(
            [
                # position            normal       uv
                [-s, -s, z, 0, 0, 1, 0, 0],
                [s, -s, z, 0, 0, 1, 1, 0],
                [s, s, z, 0, 0, 1, 1, 1],
                [-s, s, z, 0, 0, 1, 0, 1],
            ],
            np.float32,
        )
        # Wound so the +Z face is front under the glTF pipeline state
        # (COUNTER_CLOCKWISE fronts with the Vulkan Y flip baked into the
        # camera matrices; this ordering is CCW seen from +Z in the y-up
        # sense, which lands CCW on screen after the flip).
        idx = np.array([0, 1, 2, 0, 2, 3], np.int32)
        kwargs.setdefault(
            "bounds", np.stack([verts[:, :3].min(0), verts[:, :3].max(0)])
        )
        kwargs.setdefault("tri_count", 2)
        return SceneObject(
            name=name,
            vertex_buffer=device.upload_buffer(f"{name}.vb", verts, BufferUsage.VERTEX),
            index_buffer=device.upload_buffer(f"{name}.ib", idx, BufferUsage.INDEX),
            model_matrix=np.eye(4, dtype=np.float32),
            bin_capacity=64,
            **kwargs,
        )


_ZERO_MODEL = np.zeros((4, 4), np.float32)


def stacked_models(objects: "list[SceneObject]") -> np.ndarray:
    """(N, 4, 4) per-frame model-matrix dynamic: hidden objects contribute
    the zero matrix (see SceneObject.visible)."""
    return np.stack([
        np.asarray(o.model_matrix, np.float32) if o.visible else _ZERO_MODEL
        for o in objects
    ])


def band_hint_for(objects, ixs, camera) -> list:
    """Screen-row occupancy spans for CompileOptions(parallel="auto")
    (scene.py:318-360): one (tri_count, y0, y1) per drawn object, y0/y1
    fractional screen rows in [0, 1], from its AABB corners projected
    through the camera. An object without bounds, an instanced one, or one
    crossing the near plane hints the full extent, which never tips the
    choice toward sort-last. Host NumPy only; renderers pass it lazily
    (GraphicNodeBuilder.set_band_hint), so it runs only when a compile is in
    auto mode."""
    vp = np.asarray(camera.render_view_projection, np.float32)
    out = []
    for i in ixs:
        o = objects[i]
        tri = int(getattr(o, "tri_count", 0) or 0)
        if tri <= 0 or not o.visible:
            continue
        b = getattr(o, "bounds", None)
        if b is None or o.instance_offsets is not None:
            out.append((tri * max(1, getattr(o, "instance_count", 1) or 1), 0.0, 1.0))
            continue
        lo, hi = np.asarray(b[0]), np.asarray(b[1])
        corners = np.array(
            [[x, y, z, 1.0]
             for x in (lo[0], hi[0])
             for y in (lo[1], hi[1])
             for z in (lo[2], hi[2])],
            np.float32,
        )
        clip = corners @ (vp @ np.asarray(o.model_matrix, np.float32)).T
        w = clip[:, 3]
        if np.any(w <= 1e-6):
            out.append((tri, 0.0, 1.0))
            continue
        y = clip[:, 1] / w
        y0 = float(np.clip((y.min() + 1.0) * 0.5, 0.0, 1.0))
        y1 = float(np.clip((y.max() + 1.0) * 0.5, 0.0, 1.0))
        out.append((tri, y0, y1))
    return out


@dataclass
class DirectionalLight:
    direction: "tuple" = (0.3, -0.5, 0.8)  # direction TOWARD the light
    color: "tuple" = (1.0, 1.0, 1.0)
    intensity: float = 3.0
    cast_shadows: bool = True
    shadow_map_size: int = 1024
    shadow_extent: float = 120.0  # ortho half-extent in world units
    shadow_near: float = 1.0
    shadow_far: float = 400.0
    shadow_bias: float = 2e-3
    # Normal-offset shadow sampling: world-space offset along the surface
    # normal before projecting into light space — the robust fix for acne on
    # surfaces steep in light space. None → 1.5 shadow texels.
    shadow_normal_offset: "float | None" = None
    # Cascaded shadow maps (renderer/csm.py; deferred renderer only):
    # cascades > 1 renders N camera-frustum-fit depth layers instead of the
    # one fixed-extent map; shadow_far bounds the shadowed view distance.
    cascades: int = 1
    cascade_lambda: float = 0.7  # uniform↔logarithmic split mix
    cascade_margin: float = 150.0  # out-of-slice caster pull-back (world)
    # Soft shadows via variance shadow maps (ops/vsm.py; deferred, single
    # map): the depth map's moments are gaussian-blurred (pure rolls) and
    # sampled with Chebyshev visibility — penumbra width follows vsm_blur.
    soft_shadows: bool = False
    vsm_blur: int = 3  # moment-blur radius in shadow texels per box pass
    vsm_bleed_reduction: float = 0.4
    # Screen-space contact shadows (ops/contact.py; deferred only): a
    # short G-buffer ray march toward the sun closes the shadow-map bias
    # leak where geometry meets the ground. Knobs are structure
    # constants like every other sun field (changing them rebuilds the
    # frame function).
    contact_shadows: bool = False
    contact_strength: float = 0.85
    contact_distance: float = 3.0  # march range, world units
    contact_thickness: float = 1.0  # occluder thickness window
    contact_steps: int = 8

    @property
    def effective_normal_offset(self) -> float:
        if self.shadow_normal_offset is not None:
            return self.shadow_normal_offset
        return 1.5 * (2.0 * self.shadow_extent) / self.shadow_map_size


@dataclass
class PointLight:
    position: "tuple"
    color: "tuple" = (1.0, 1.0, 1.0)
    intensity: float = 100.0
    radius: float = 50.0  # influence cutoff
    # Omnidirectional shadows (renderer/omni.py; deferred renderer only):
    # six depth faces around the light, far plane = radius. Shadowed
    # lights shade through the dense path (cube PCF per pixel) instead of
    # the tiled kernel — keep their count small. Casters: plain opaque
    # objects (the static batch), like most engines' local-light shadows.
    cast_shadows: bool = False
    shadow_map_size: int = 256
    shadow_near: float = 0.3
    shadow_bias: float = 0.05  # world-space, along the face axis


@dataclass
class SpotLight:
    """Cone light: a point light times a smooth angular falloff between
    the inner (full intensity) and outer (zero) cone angles. Rides the
    same tiled-culling kernel as point lights (ops.lighting)."""

    position: "tuple"
    direction: "tuple" = (0.0, 0.0, -1.0)  # beam axis, away from the light
    color: "tuple" = (1.0, 1.0, 1.0)
    intensity: float = 100.0
    radius: float = 50.0  # influence cutoff
    inner_deg: float = 18.0
    outer_deg: float = 26.0


@dataclass
class Scene:
    objects: "list[SceneObject]" = field(default_factory=list)
    sun: "Optional[DirectionalLight]" = None
    point_lights: "list[PointLight]" = field(default_factory=list)
    spot_lights: "list[SpotLight]" = field(default_factory=list)
    ambient: "tuple" = (0.03, 0.03, 0.04)
    skybox: "Optional[object]" = None  # cube-map Texture (6, S, S, C)
    # Image-based light (renderer.environment.EnvironmentLight). When set,
    # the deferred resolve replaces the flat ``ambient`` term with SH
    # diffuse + prefiltered GGX specular, and (unless ``skybox`` is also
    # set) uses the environment cube as the background.
    environment: "Optional[object]" = None
    # Projected decals (renderer.decal.Decal; deferred renderer only):
    # blended into the G-buffer albedo before the lighting resolve, so they
    # are lit and shadowed like any surface detail. Moving one is a dynamic
    # (no recompile); adding/removing one recompiles like a draw-list change.
    decals: "list" = field(default_factory=list)
    # Procedural sky (ops.atmosphere.Atmosphere; deferred renderer only):
    # single-scatter Rayleigh+Mie background computed from the per-pixel
    # view ray and the sun direction. Lowest background priority: an
    # explicit ``skybox`` or ``environment`` cube wins.
    atmosphere: "Optional[object]" = None

    def point_light_arrays(self) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
        """(L, 3) positions, (L, 3) colors·intensity, (L,) radii.

        Cached per light-ELEMENT identity (a tuple of the PointLight
        object ids) — this is called every frame by the renderers, and
        rebuilding (100, 3) arrays from the dataclass list cost a
        measurable slice of the per-frame host budget. Replacing the list
        or any element invalidates; mutating a PointLight's FIELDS in
        place does not — call ``invalidate_light_cache`` then.

        The cache holds strong references to the keyed PointLight objects:
        ids are only unique among LIVE objects (CPython recycles freed
        slots), so an id-tuple key alone could false-hit after dropping old
        lights and allocating new ones.
        """
        cache = getattr(self, "_pl_cache", None)
        key = tuple(map(id, self.point_lights))  # map(): ~2x the genexpr
        if cache is not None and cache[0] == key:
            return cache[1]
        if not self.point_lights:
            arrays = (
                np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.float32),
                np.zeros((0,), np.float32),
            )
        else:
            pos = np.array([pl.position for pl in self.point_lights], np.float32)
            col = np.array(
                [np.asarray(pl.color, np.float32) * pl.intensity
                 for pl in self.point_lights],
                np.float32,
            )
            rad = np.array([pl.radius for pl in self.point_lights], np.float32)
            arrays = (pos, col, rad)
        object.__setattr__(
            self, "_pl_cache", (key, arrays, list(self.point_lights))
        )
        return arrays

    def spot_light_arrays(self):
        """(S,3) positions, (S,3) colors·intensity, (S,) radii, (S,5)
        cone params (unit dir xyz, cos inner, cos outer) — cached like
        point_light_arrays."""
        cache = getattr(self, "_sl_cache", None)
        key = tuple(map(id, self.spot_lights))
        if cache is not None and cache[0] == key:
            return cache[1]
        if not self.spot_lights:
            arrays = (
                np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.float32),
                np.zeros((0,), np.float32),
                np.zeros((0, 5), np.float32),
            )
        else:
            import math as _math

            pos = np.array([sl.position for sl in self.spot_lights], np.float32)
            col = np.array(
                [np.asarray(sl.color, np.float32) * sl.intensity
                 for sl in self.spot_lights],
                np.float32,
            )
            rad = np.array([sl.radius for sl in self.spot_lights], np.float32)
            params = np.zeros((len(self.spot_lights), 5), np.float32)
            for i, sl in enumerate(self.spot_lights):
                d = np.asarray(sl.direction, np.float64)
                d = d / max(float(np.linalg.norm(d)), 1e-8)
                params[i, :3] = d
                params[i, 3] = _math.cos(_math.radians(sl.inner_deg))
                params[i, 4] = _math.cos(_math.radians(sl.outer_deg))
            arrays = (pos, col, rad, params)
        object.__setattr__(
            self, "_sl_cache", (key, arrays, list(self.spot_lights))
        )
        return arrays

    def light_partition(self):
        """(unshadowed pos/col/rad arrays, shadow-casting PointLight list)
        — the deferred renderer's per-frame split, cached per light-element
        identity like point_light_arrays (scanning 100 lights' fields per
        frame measured on the host path)."""
        cache = getattr(self, "_part_cache", None)
        key = tuple(map(id, self.point_lights))
        if cache is not None and cache[0] == key:
            return cache[1]
        pos, col, rad = self.point_light_arrays()
        omni = [pl for pl in self.point_lights if pl.cast_shadows]
        if omni:
            keep = np.asarray(
                [not pl.cast_shadows for pl in self.point_lights], bool
            )
            pos, col, rad = pos[keep], col[keep], rad[keep]
        result = (pos, col, rad, omni)
        object.__setattr__(
            self, "_part_cache", (key, result, list(self.point_lights))
        )
        return result

    def invalidate_light_cache(self) -> None:
        object.__setattr__(self, "_pl_cache", None)
        object.__setattr__(self, "_sl_cache", None)
        object.__setattr__(self, "_part_cache", None)
