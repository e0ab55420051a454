"""The reference's deferred frame: a sun shadow map, a G-buffer, PBR
lighting with PCF sun shadows and point lights, the sky, bloom + ACES and
the sRGB BGRA8 present, all in plain PyTorch from a scene description.

``precision="tf32"`` is the control: every matrix product of the frame
(vertex, normal, light-space and view-ray transforms) takes operands
rounded to TF32, the precision a float32 matrix product drops to with
TF32 on; the normal reference transforms geometry in float64 and shades in
float32."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from reference import atmosphere, ibl, post, raster, shade
from reference.camera import Camera, sun_view_proj

F32, F64 = torch.float32, torch.float64


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits), to nearest even."""
    bits = x.to(F32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(F32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str, dtype=F32) -> torch.Tensor:
    if precision == "tf32":
        return to_tf32(a) @ to_tf32(b)
    return a.to(dtype) @ b.to(dtype)


@dataclass
class Obj:
    """One drawable: (N, 8) vertices (position, normal, uv), (T, 3)
    triangles, its model matrix, instance offsets (I, 3) or None, and its
    material: base colour, metallic, roughness, emissive luma, and an
    optional mip chain of linear RGBA levels with its atlas transform
    (su, sv, ou, ov)."""

    vertices: np.ndarray
    tris: np.ndarray
    model: np.ndarray
    base_color: tuple
    metallic: float
    roughness: float
    emissive: float = 0.0
    offsets: Optional[np.ndarray] = None
    levels: Optional[list] = None
    uv_transform: Optional[tuple] = None


@dataclass
class Sun:
    direction: tuple
    intensity: float
    map_size: int
    extent: float
    near: float = 1.0
    far: float = 400.0
    bias: float = 2e-3
    color: tuple = (1.0, 1.0, 1.0)

    @property
    def normal_offset(self) -> float:
        return 1.5 * (2.0 * self.extent) / self.map_size


@dataclass
class Scene:
    objects: list
    sun: Sun
    ambient: tuple
    lights: np.ndarray  # (L, 7): position, radius, colour × intensity
    sky_cube: Optional[np.ndarray] = None  # (6, S, S, 4) linear
    atmosphere: bool = False
    fov_y_deg: float = 35.0
    # The split-sum environment (a (6, S, S, 4) linear cube): its SH
    # irradiance and prefiltered levels replace the flat ambient, its level
    # 0 is the background.
    environment: Optional[np.ndarray] = None
    post: dict = field(default_factory=dict)
    _env: dict = field(default_factory=dict, repr=False)

    def env_levels(self, dev):
        """The prefiltered levels on ``dev`` and the SH coefficients,
        worked out once."""
        if dev not in self._env:
            cube = torch.from_numpy(np.ascontiguousarray(self.environment)).to(dev)
            self._env[dev] = (ibl.prefilter(cube), torch.from_numpy(ibl.sh9(self.environment)).to(dev))
        return self._env[dev]


def _draw_order(scene: Scene) -> list:
    """Plain objects first (one batch), then the instanced ones, each in
    scene order: the renderer's pass order."""
    plain = [i for i, o in enumerate(scene.objects) if o.offsets is None]
    inst = [i for i, o in enumerate(scene.objects) if o.offsets is not None]
    return plain + inst


def _geometry(obj: Obj, vp: np.ndarray, dev, precision: str):
    """(clip (M, 4), varyings (M, 8): world xyz, normal xyz, uv) of every
    vertex of every instance, and the (T·I, 3) triangles, instance-major."""
    v = torch.as_tensor(obj.vertices, device=dev)
    gdt = F32 if precision == "tf32" else F64
    hom = torch.cat([v[:, :3], torch.ones_like(v[:, :1])], 1).to(gdt)
    model = torch.as_tensor(np.asarray(obj.model, np.float32), device=dev)
    world = matmul(hom, model.T, precision, gdt)
    normal = matmul(v[:, 3:6].to(gdt), model[:3, :3].T, precision, gdt)
    uv = v[:, 6:8].to(gdt)
    tris = torch.as_tensor(obj.tris, dtype=torch.int64, device=dev)
    n = v.shape[0]
    if obj.offsets is not None:
        offs = torch.as_tensor(np.asarray(obj.offsets, np.float32), device=dev).to(gdt)
        k = offs.shape[0]
        wpos = (world[None, :, :3] + offs[:, None, :]).reshape(-1, 3)
        w4 = world[:, 3:4].repeat(k, 1)
        world = torch.cat([wpos, w4], 1)
        normal = normal.repeat(k, 1)
        uv = uv.repeat(k, 1)
        tris = (tris[None] + n * torch.arange(k, device=dev)[:, None, None]).reshape(-1, 3)
    vpt = torch.as_tensor(vp, device=dev)
    clip = matmul(world, (vpt.to(F32) if precision == "tf32" else vpt).T, precision, gdt)
    vary = torch.cat([world[:, :3], normal, uv], 1)
    return clip, vary, tris


def render(scene: Scene, camera: Camera, width: int, height: int, device,
           precision: str = "reference", frame: int = 0, exposure_prev=None,
           dt: float = 1.0 / 60.0):
    """(the presented frame (H, W, 4) uint8 BGRA, the frame's adapted
    exposure or None). ``frame`` is the frame's index from 0 (the film
    grain's seed); ``exposure_prev`` the exposure the frame adapts from
    (None on the first)."""
    dev = torch.device(device)
    sun = scene.sun
    light_vp = sun_view_proj(sun.direction, sun.extent, sun.near, sun.far)
    order = _draw_order(scene)

    # Shadow pass: depth only, LESS against a 1.0 clear, no culling.
    shadow = raster.new_pass(sun.map_size, sun.map_size, 1.0, 0, dev)
    for i in order:
        clip, _, tris = _geometry(scene.objects[i], light_vp, dev, precision)
        ids = torch.full((tris.shape[0],), i, dtype=torch.int64, device=dev)
        raster.draw(shadow, clip, tris, ids, None, compare="less", cull="none")
        del clip, tris

    # G-buffer pass: reverse Z (GREATER against a 0 clear), back faces
    # culled, counter-clockwise fronts.
    gb = raster.new_pass(width, height, 0.0, 8, dev)
    for i in order:
        clip, vary, tris = _geometry(scene.objects[i], camera.view_proj, dev, precision)
        ids = torch.full((tris.shape[0],), i, dtype=torch.int64, device=dev)
        raster.draw(gb, clip, tris, ids, vary, compare="greater", cull="back")
        del clip, vary, tris

    depth = gb.z.to(F32)
    covered = (depth > 0.0)[..., None]
    did = torch.clamp(gb.draw, min=0)
    vary = gb.varyings.to(F32)
    world = vary[..., :3]
    n = shade.normalize(vary[..., 3:6])

    objs = scene.objects
    base = torch.tensor([list(o.base_color)[:3] for o in objs], dtype=F32, device=dev)[did]
    mats = torch.tensor([[o.metallic, o.roughness, o.emissive] for o in objs],
                        dtype=F32, device=dev)[did]
    albedo = base
    for i, o in enumerate(objs):
        if o.levels is None:
            continue
        su, sv, ou, ov = o.uv_transform
        mine = (gb.draw == i)[..., None]
        uv = vary[..., 6:8]
        auv = torch.stack([ou + uv[..., 0] * su, ov + uv[..., 1] * sv], -1)
        auv = torch.where(mine, auv, torch.zeros_like(auv))
        levels = [torch.as_tensor(lv, device=dev) for lv in o.levels]
        lod = shade.screen_lod(auv, levels[0].shape[1], levels[0].shape[0])
        tex = shade.trilinear(levels, auv, lod)[..., :3]
        albedo = torch.where(mine, albedo * tex, albedo)
    albedo = torch.where(covered, albedo, torch.zeros_like(albedo))
    metallic = mats[..., 0:1]
    roughness = mats[..., 1:2]
    emissive = torch.where(covered, mats[..., 2:3], torch.zeros_like(mats[..., 2:3]))

    cam = torch.as_tensor(camera.position, dtype=F32, device=dev)
    v = shade.normalize(cam - world)
    if scene.environment is not None:
        levels, sh = scene.env_levels(dev)
        irr = ibl.eval_sh9(sh, n, lambda a, b: matmul(a, b, precision))
        f0 = 0.04 * (1.0 - metallic) + albedo * metallic
        ndv = torch.clamp(torch.sum(n * v, -1, keepdim=True), min=1e-4)
        refl = 2.0 * ndv * n - v
        pre = ibl.sample_cube_lod(levels, refl, roughness[..., 0] * (len(levels) - 1))[..., :3]
        scale, bias = ibl.env_brdf(ndv, roughness)
        ambient = albedo * (1.0 - metallic) * irr + pre * (f0 * scale + bias)
    else:
        ambient = torch.tensor(scene.ambient, dtype=F32, device=dev) * albedo
    color = ambient + emissive * albedo

    l_dir = np.asarray(sun.direction, np.float32)
    l_dir = torch.tensor(l_dir / np.float32(np.sqrt(np.dot(l_dir, l_dir))), device=dev)
    sun_col = torch.tensor(np.asarray(sun.color, np.float32) * np.float32(sun.intensity),
                           device=dev)
    contrib = shade.ggx(n, v, l_dir.expand(n.shape), albedo, metallic, roughness) * sun_col
    spos = world + n * float(np.float32(sun.normal_offset))
    hom = torch.cat([spos, torch.ones_like(spos[..., :1])], -1)
    lvp = torch.as_tensor(light_vp, dtype=F32, device=dev)
    lclip = matmul(hom.reshape(-1, 4), lvp.T, precision).reshape(hom.shape)
    suv = torch.stack([(lclip[..., 0] + 1) * 0.5, (lclip[..., 1] + 1) * 0.5], -1)
    ref = lclip[..., 2] - float(np.float32(sun.bias))
    lit = shade.shadow_pcf(shadow.z.to(F32), suv, ref)
    inside = (suv[..., 0] >= 0) & (suv[..., 0] <= 1) & (suv[..., 1] >= 0) & (suv[..., 1] <= 1)
    contrib = contrib * torch.where(inside, lit, torch.ones_like(lit))[..., None]
    color = color + contrib
    if scene.lights.shape[0]:
        lights = torch.as_tensor(scene.lights, dtype=F32, device=dev)
        color = color + shade.point_lights(albedo, metallic, n, roughness, world, covered,
                                           cam, lights)

    inv_vp = torch.as_tensor(camera.inv_view_proj, dtype=F32, device=dev)
    if precision == "tf32":
        rays = _view_rays_tf32(inv_vp, cam, height, width)
    else:
        rays = shade.view_rays(inv_vp, cam, height, width)
    sky_cube = scene.sky_cube if scene.sky_cube is not None else scene.environment
    if sky_cube is not None:
        bg = shade.sample_cube(torch.as_tensor(sky_cube, device=dev), rays)[..., :3]
    else:
        unit = rays / torch.sqrt(torch.sum(rays * rays, -1, keepdim=True))
        bg = atmosphere.sky(unit, l_dir, float(np.float32(camera.position[2])))
    rgb = torch.where(covered, color, bg)
    hdr = torch.cat([rgb, torch.ones_like(rgb[..., :1])], -1)
    ldr, ev = post.chain(hdr, scene.post, frame, exposure_prev, dt)
    return shade.encode_bgra8_srgb(ldr), ev


def _view_rays_tf32(inv_vp, cam, h, w):
    dev = inv_vp.device
    nx = (torch.arange(w, dtype=F32, device=dev) + 0.5) / w * 2 - 1
    ny = (torch.arange(h, dtype=F32, device=dev) + 0.5) / h * 2 - 1
    px = nx[None, :].expand(h, w)
    py = ny[:, None].expand(h, w)
    ndc = torch.stack([px, py, torch.full_like(px, 0.5), torch.ones_like(px)], -1)
    p = matmul(ndc.reshape(-1, 4), inv_vp.T, "tf32").reshape(h, w, 4)
    return p[..., :3] / p[..., 3:4] - cam
