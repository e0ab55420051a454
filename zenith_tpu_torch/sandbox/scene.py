"""The sandbox scene (torch port of zenith_tpu/sandbox/scene.py): the
gradient sky cube map, the procedural material textures, and the deferred
scene and frame function that the card and the tests drive.

``build_scene`` loads the cerberus glTF through the asset manager, as the
reference does: the glTF and its textures are not in this repository, but
its baked mesh and material are (``cache/mesh/cerberus``), and the manager
loads them from there when run from the repository's root; it raises where
neither is found. ``build_standin_scene`` builds the same scene with the
cerberus mesh replaced by ``standin_mesh``, a procedural mesh of its size;
both share ``_sandbox_scene``. ``deferred_frame`` is bench.py::bench_scene's frame
function. ``golden_scene`` is the scene of tests/test_golden.py (the
reference's tests/test_renderers.py::build_test_scene with a sky cube).

``SceneApp`` is the reference's scene app in forward mode (config #3: the
sun's shadow pass and the forward lit pass, with ``--msaa``,
``--wireframe``, ``--instances`` and ``--gun-instances``) and deferred mode
(config #5, with the glass, textured, wireframe and screen-space options,
instancing, ``--cascades N``, ``--point-shadows``, ``--soft-shadows``,
``--bloom-mips N``, the image-based light, the probe, the post extras, the
temporal passes, ``--dof``, ``--hud``, ``--particles N``, ``--skinned``,
``--morph`` and ``--pick``), auto-retained; ``skinned_tube`` and
``morphing_blob`` are its procedural animated meshes. Run it on the card:

    python -m zenith_tpu_torch.sandbox.scene --frames 60 --out scene.png -- --mode forward --msaa 4

``feature_golden_scene`` builds the screen-space feature frames of
tests/test_golden_features.py (SSR, fog, sky, flare, contact shadows,
decals). The other sandbox apps are ``sandbox/terrain.py``, ``fly.py`` and
``mesh.py``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from pathlib import Path

import numpy as np
import torch

from zenith_tpu_torch.app import Args, RenderableApp, RenderContext
from zenith_tpu_torch.core import log
from zenith_tpu_torch.asset import AssetUrl, Mesh
from zenith_tpu_torch.core.events import (
    DeviceEvent,
    KeyboardInput,
    KeyCode,
    MouseInput,
    WindowEvent,
)
from zenith_tpu_torch.rhi import Format, Texture

logger = log.get(__name__)

GOLDEN_W, GOLDEN_H = 128, 64
YUP_TO_ZUP = np.array(
    [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32
)


def skinned_tube(bones: int = 5, rings: int = 24, sides: int = 16,
                 radius: float = 4.0, height: float = 42.0):
    """Procedural skinned cylinder ("tentacle"): a bone chain along +Z,
    each vertex weighted between its two nearest joints, plus a waving
    AnimationClip (per-joint X-axis rotation keyframes with a phase
    offset), as scene.py:108-182 builds it: the skinning pipeline with no
    content dependency."""
    from zenith_tpu_torch.asset import AssetUrl
    from zenith_tpu_torch.asset.render_types import (
        AnimationChannel,
        AnimationClip,
        Mesh as MeshAsset,
        Skin,
    )

    # Geometry: rings+1 circles of `sides` vertices.
    verts = []
    jw = []
    seg = height / (bones - 1)
    for r in range(rings + 1):
        z = height * r / rings
        v = r / rings
        for s in range(sides):
            a = 2 * math.pi * s / sides
            nx, ny = math.cos(a), math.sin(a)
            verts.append([radius * nx, radius * ny, z, nx, ny, 0.0,
                          s / sides, v])
            f = min(z / seg, bones - 1 - 1e-4)
            j0 = int(f)
            w1 = f - j0
            jw.append([j0, min(j0 + 1, bones - 1), 0, 0,
                       1.0 - w1, w1, 0.0, 0.0])
    tris = []
    for r in range(rings):
        for s in range(sides):
            a0 = r * sides + s
            a1 = r * sides + (s + 1) % sides
            b0 = a0 + sides
            b1 = a1 + sides
            tris += [[a0, a1, b0], [a1, b1, b0]]

    # Bone chain: joint k at world z = k·seg; locals are pure +Z offsets.
    rest_t = np.zeros((bones, 3), np.float32)
    rest_t[1:, 2] = seg
    rest_r = np.tile(np.asarray([0, 0, 0, 1], np.float32), (bones, 1))
    rest_s = np.ones((bones, 3), np.float32)
    inv_bind = np.stack([np.eye(4, dtype=np.float32) for _ in range(bones)])
    for k in range(bones):
        inv_bind[k, 2, 3] = -k * seg
    skin = Skin(inv_bind, np.arange(-1, bones - 1, dtype=np.int32),
                rest_t, rest_r, rest_s)

    # Wave clip: X-axis rotation keyframes, phase-shifted down the chain.
    duration = 2.0
    keys = np.linspace(0.0, duration, 17).astype(np.float32)
    channels = []
    for k in range(1, bones):
        amp = 0.35
        ang = amp * np.sin(2 * np.pi * keys / duration + 0.8 * k)
        quats = np.stack([
            np.sin(ang / 2), np.zeros_like(ang), np.zeros_like(ang),
            np.cos(ang / 2),
        ], axis=1).astype(np.float32)
        channels.append(AnimationChannel(k, "rotation", keys, quats))
    clip = AnimationClip("wave", channels, duration)

    return MeshAsset(
        AssetUrl("procedural/tentacle"),
        np.asarray(verts, np.float32),
        np.asarray(tris, np.int32),
        skin_vertex_data=np.asarray(jw, np.float32),
        skin=skin,
        clips=[clip],
    )


def morphing_blob(rings: int = 24, sides: int = 32, radius: float = 9.0):
    """Procedural morph-target demo: a UV sphere with two POSITION-delta
    targets (a polar spike and an equatorial bulge) and a looping
    "pulse" weights clip, as scene.py:185-242 builds it: the morph pipeline
    with no content dependency."""
    from zenith_tpu_torch.asset import AssetUrl
    from zenith_tpu_torch.asset.render_types import (
        AnimationChannel,
        AnimationClip,
        Mesh as MeshAsset,
    )

    verts = []
    for r in range(rings + 1):
        theta = math.pi * r / rings  # 0 at +Z pole
        for s in range(sides):
            phi = 2 * math.pi * s / sides
            nx = math.sin(theta) * math.cos(phi)
            ny = math.sin(theta) * math.sin(phi)
            nz = math.cos(theta)
            verts.append([radius * nx, radius * ny, radius * nz,
                          nx, ny, nz, s / sides, r / rings])
    v = np.asarray(verts, np.float32)
    tris = []
    for r in range(rings):
        for s in range(sides):
            a0 = r * sides + s
            a1 = r * sides + (s + 1) % sides
            b0 = a0 + sides
            b1 = a1 + sides
            if r > 0:
                tris.append([a0, a1, b0])
            if r < rings - 1:
                tris.append([a1, b1, b0])
    n_verts = v.shape[0]
    nrm = v[:, 3:6]
    z = v[:, 2] / radius
    # Target 0: polar spike (outward push, concentrated at the +Z pole).
    spike = nrm * (radius * 0.9 * np.clip(z, 0.0, 1.0) ** 4)[:, None]
    # Target 1: equatorial bulge (radial push where |z| is small).
    radial = np.concatenate([v[:, :2], np.zeros((n_verts, 1), np.float32)], 1)
    rn = np.linalg.norm(radial, axis=1, keepdims=True)
    radial = radial / np.where(rn > 1e-6, rn, 1.0)
    bulge = radial * (radius * 0.45 * np.exp(-(z * 2.2) ** 2))[:, None]
    deltas = np.stack([spike, bulge]).astype(np.float32)

    times = np.array([0.0, 0.75, 1.5, 2.25, 3.0], np.float32)
    weights = np.array(
        [[0, 0], [1, 0], [0, 0], [0, 1], [0, 0]], np.float32
    )
    clip = AnimationClip("pulse", [
        AnimationChannel(-1, "weights", times, weights)
    ], 3.0)
    return MeshAsset(
        AssetUrl("procedural/blob"),
        v, np.asarray(tris, np.int32),
        morph_deltas=deltas, clips=[clip],
    )


def sky_cube_pixels(size: int = 64) -> np.ndarray:
    """Procedural gradient sky (6, S, S, 4) linear radiance: zenith→horizon
    gradient with a warm sun glow."""
    u = (np.arange(size, dtype=np.float32) + 0.5) / size * 2 - 1
    uu, vv = np.meshgrid(u, u)
    ones = np.ones_like(uu)
    # Direction per texel per face (+X -X +Y -Y +Z -Z, Vulkan 16.5.4).
    face_dirs = [
        np.stack([ones, -vv, -uu], -1),
        np.stack([-ones, -vv, uu], -1),
        np.stack([uu, ones, vv], -1),
        np.stack([uu, -ones, -vv], -1),
        np.stack([uu, -vv, ones], -1),
        np.stack([-uu, -vv, -ones], -1),
    ]
    sun_dir = np.array([0.35, -0.3, 0.88], np.float32)
    sun_dir /= np.linalg.norm(sun_dir)
    zenith = np.array([0.18, 0.32, 0.62], np.float32)
    horizon = np.array([0.55, 0.62, 0.75], np.float32)
    below = np.array([0.12, 0.11, 0.10], np.float32)
    faces = []
    for d in face_dirs:
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        up = np.clip(d[..., 2:3], 0.0, 1.0)
        sky = horizon + (zenith - horizon) * np.sqrt(up)
        col = np.where(d[..., 2:3] >= 0.0, sky, below)
        glow = np.clip(np.sum(d * sun_dir, axis=-1, keepdims=True), 0, 1) ** 64
        col = col + glow * np.array([3.0, 2.6, 2.0], np.float32)
        faces.append(
            np.concatenate([col, np.ones_like(up)], -1).astype(np.float32)
        )
    return np.stack(faces)


def sky_cube_texture(size: int = 64, *, device: "torch.device | str") -> Texture:
    """The procedural sky as a cube-map Texture on ``device`` (reference
    texture.rs:94-105)."""
    return Texture.from_numpy_layers(
        "sky", sky_cube_pixels(size), Format.RGBA32F, cube=True, device=torch.device(device)
    )


def default_content_root() -> str:
    """The root holding ``content/``: ZENITH_CONTENT, else the working
    directory (sandbox/mesh.py:29-37 of the reference)."""
    return os.environ.get("ZENITH_CONTENT") or str(Path.cwd())


def checker_texture(size: int = 512, cells: int = 16, a=(200, 202, 208),
                    b=(90, 94, 104), *, device: "torch.device | str") -> Texture:
    """Procedural sRGB checker with a full mip chain (scene.py:46-56)."""
    yy, xx = np.mgrid[0:size, 0:size]
    cell = ((yy // (size // cells) + xx // (size // cells)) % 2).astype(np.uint8)
    px = np.empty((size, size, 4), np.uint8)
    for c in range(3):
        px[..., c] = np.where(cell == 0, a[c], b[c])
    px[..., 3] = 255
    return Texture.from_numpy("checker", px, Format.RGBA8_SRGB, generate_mips=True,
                              device=torch.device(device))


def bump_normal_texture(size: int = 256, bumps: int = 10, *,
                        device: "torch.device | str") -> Texture:
    """Tangent-space normal map, a grid of spherical bumps, linear
    RGBA8_UNORM without mips (scene.py:59-81)."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    fx = (xs / size * bumps) % 1.0 - 0.5
    fy = (ys / size * bumps) % 1.0 - 0.5
    r2 = fx * fx + fy * fy
    br = 0.4
    inside = r2 < br * br
    nz = np.sqrt(np.clip(br * br - r2, 0.0, None))
    n = np.stack([np.where(inside, -fx, 0.0), np.where(inside, -fy, 0.0),
                  np.where(inside, nz, 1.0)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    px = np.concatenate([((n * 0.5 + 0.5) * 255).astype(np.uint8),
                         np.full((size, size, 1), 255, np.uint8)], axis=-1)
    return Texture.from_numpy("bumps", px, Format.RGBA8_UNORM, device=torch.device(device))


def mra_stripe_texture(size: int = 256, stripes: int = 8, *,
                       device: "torch.device | str") -> Texture:
    """glTF metallic-roughness map (B=metallic, G=roughness): alternating
    rough-dielectric / polished-metal stripes, linear, no mips
    (scene.py:84-95)."""
    ys = np.mgrid[0:size, 0:size][0]
    band = ((ys * stripes) // size) % 2 == 0
    px = np.zeros((size, size, 4), np.uint8)
    px[..., 0] = 255  # occlusion (unused) = 1
    px[..., 1] = np.where(band, 230, 60)  # roughness
    px[..., 2] = np.where(band, 0, 255)  # metallic
    px[..., 3] = 255
    return Texture.from_numpy("mra.stripes", px, Format.RGBA8_UNORM, device=torch.device(device))


def brushed_texture(size: int = 256, rng=None, *, device: "torch.device | str") -> Texture:
    """Procedural brushed-metal stripes, sRGB with mips (scene.py:98-107).
    Draws ``size`` + ``size``² uniforms from ``rng``."""
    rng = rng or np.random.default_rng(7)
    rows = rng.uniform(0.75, 1.0, size=(size, 1)).astype(np.float32)
    field = np.repeat(rows, size, axis=1)
    field += rng.uniform(-0.03, 0.03, size=(size, size)).astype(np.float32)
    val = np.clip(field * 255, 0, 255).astype(np.uint8)
    px = np.stack([val, val, val, np.full_like(val, 255)], axis=-1)
    return Texture.from_numpy("brushed", px, Format.RGBA8_SRGB, generate_mips=True,
                              device=torch.device(device))


def cube_mesh(size: float = 10.0, z0: float = 10.0) -> Mesh:
    """Axis-aligned cube as a Mesh (z-up world), the same vertices and
    winding as the reference's tests/test_renderers.py::make_cube."""
    s = size / 2.0
    cz = z0 + s
    faces, idx = [], []
    defs = [
        ((0, 0, 1), [(-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]),
        ((0, 0, -1), [(-s, s, -s), (s, s, -s), (s, -s, -s), (-s, -s, -s)]),
        ((1, 0, 0), [(s, -s, -s), (s, s, -s), (s, s, s), (s, -s, s)]),
        ((-1, 0, 0), [(-s, s, -s), (-s, -s, -s), (-s, -s, s), (-s, s, s)]),
        ((0, 1, 0), [(s, s, -s), (-s, s, -s), (-s, s, s), (s, s, s)]),
        ((0, -1, 0), [(-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s)]),
    ]
    for f, (n, quad) in enumerate(defs):
        base = 4 * f
        for px, py, pz in quad:
            faces.append([px, py, pz + cz, *n, 0.0, 0.0])
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return Mesh(AssetUrl("test/cube.mesh"), np.asarray(faces, np.float32), np.asarray(idx, np.int32))


def golden_scene(render_device, num_lights: int = 8, sky_size: int = 16):
    """tests/test_golden.py's deferred scene: the reference's
    build_test_scene (a cube over a ground quad, a sun with a 128² shadow
    map, ``num_lights`` point lights on a ring) with a ``sky_size`` sky cube,
    and its 128x64 camera. Returns (scene, camera)."""
    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree, Radians
    from zenith_tpu_torch.renderer import DirectionalLight, PointLight, Scene, SceneObject

    cube = SceneObject.from_mesh(
        render_device, cube_mesh(size=14.0, z0=8.0), "cube",
        base_color=(0.8, 0.2, 0.2, 1.0), metallic=0.0, roughness=0.5, bin_capacity=64,
    )
    ground = SceneObject.quad(render_device, "ground", size=200.0, z=0.0,
                              base_color=(0.4, 0.4, 0.4, 1.0), roughness=0.9)
    lights = [
        PointLight(position=(20.0 * math.cos(a), 20.0 * math.sin(a), 12.0),
                   color=(1.0, 0.8, 0.5), intensity=300.0, radius=60.0)
        for a in np.linspace(0, 2 * math.pi, num_lights, endpoint=False)
    ]
    scene = Scene(
        objects=[cube, ground],
        sun=DirectionalLight(direction=(0.05, -0.05, 1.0), intensity=2.5,
                             shadow_map_size=128, shadow_extent=60.0),
        point_lights=lights,
        ambient=(0.05, 0.05, 0.05),
    )
    scene = dataclasses.replace(
        scene, skybox=sky_cube_texture(sky_size, device=render_device.device))
    cam = Camera(fov_y=Degree(45.0), aspect_ratio=GOLDEN_W / GOLDEN_H)
    cam.set_position(np.array([0.0, -60.0, 25.0], np.float32))
    cam.set_yaw_pitch(Radians(0.0), Radians(-0.25))
    return scene, cam


# The screen-space feature frames of tests/test_golden_features.py that the
# port renders, each pinned by tests/golden/feat_<name>_128x64.npy.
FEATURE_GOLDENS = ("ssr", "fog", "sky", "flare", "contact", "decals", "film")


def feature_golden_scene(render_device, cfg: str):
    """tests/test_golden_features.py::_render's scene and graph for the
    feature ``cfg`` (one of FEATURE_GOLDENS, or "base": the same scene with
    no feature): golden_scene's cube over the ground with eight point lights
    and a 16² sky cube; "ssr" swaps the ground for a glossy mirror quad,
    "sky" replaces the sky cube with the procedural atmosphere and "sky" and
    "flare" drop the sun toward the horizon, "contact" turns on the sun's
    contact shadows, "decals" adds two solid decals, "film" runs the post
    with the film effects (aberration, sharpen, grain). Returns (scene, camera,
    declare), where ``declare(builder, width, height)`` declares the frame
    (the deferred renderer, SSR, fog or flare, PostProcess into an RGBA32F
    target) on ``builder`` and returns the target's handle."""
    from zenith_tpu_torch.renderer import (
        Atmosphere,
        Decal,
        DeferredRenderer,
        FilmEffects,
        LensFlare,
        PostProcess,
        SceneObject,
        ScreenSpaceReflections,
        VolumetricFog,
    )
    from zenith_tpu_torch.rhi import TextureDesc

    if cfg not in FEATURE_GOLDENS + ("base",):
        raise ValueError(f"no feature golden {cfg!r}: the goldens are {FEATURE_GOLDENS}")
    scene, cam = golden_scene(render_device)
    if cfg == "ssr":
        # A smooth receiver whose reflection rays hit on-screen geometry.
        mirror = SceneObject.quad(render_device, "mirror", size=200.0, z=0.0,
                                  base_color=(0.6, 0.6, 0.65, 1.0), metallic=0.8,
                                  roughness=0.1)
        scene = dataclasses.replace(scene, objects=[scene.objects[0], mirror])
    if cfg in ("flare", "sky"):
        # The sun low on the horizon, so the flare and the sky are in frame.
        scene.sun = dataclasses.replace(scene.sun, direction=(0.8, -0.55, 0.1))
    if cfg == "contact":
        scene.sun = dataclasses.replace(scene.sun, contact_shadows=True)
    if cfg == "sky":
        scene = dataclasses.replace(scene, skybox=None)
        scene.atmosphere = Atmosphere()
    if cfg == "decals":
        scene.decals.append(Decal(name="splat0", position=(0.0, -20.0, 0.1),
                                  size=(22.0, 22.0, 4.0), color=(0.9, 0.25, 0.2, 0.85)))
        scene.decals.append(Decal(name="splat1", position=(18.0, 0.0, 0.1),
                                  size=(14.0, 14.0, 4.0), color=(0.2, 0.4, 0.9, 0.7)))
    renderer = DeferredRenderer(scene)

    def declare(builder, width: int, height: int):
        hdr = builder.create(TextureDesc.color("hdr", width, height, Format.RGBA32F))
        out = builder.create(TextureDesc.color("ldr", width, height, Format.RGBA32F))
        renderer.render_to(builder, hdr, cam, width, height)
        post_in = hdr
        if cfg == "ssr":
            ssr_out = builder.create(TextureDesc.color("ssr", width, height, Format.RGBA32F))
            ScreenSpaceReflections().render_to(builder, post_in, ssr_out, cam,
                                               renderer.gbuffer_handles)
            post_in = ssr_out
        if cfg == "fog":
            fog_out = builder.create(TextureDesc.color("fog", width, height, Format.RGBA32F))
            VolumetricFog().render_to(builder, post_in, fog_out, cam, renderer.gbuffer_handles,
                                      sun=scene.sun)
            post_in = fog_out
        if cfg == "flare":
            flare = LensFlare()
            for k, v in flare.sun_dynamics(cam, scene.sun.direction).items():
                builder.set_dynamic(k, v)
            flare.render_to(builder, post_in, sun_color=(1.0, 0.92, 0.8))
        post = PostProcess(film=FilmEffects(chromatic_aberration=2.5, sharpen=0.4, grain=0.035)
                           if cfg == "film" else None)
        post.render_to(builder, post_in, out)
        return out

    return scene, cam, declare


def feature_golden_frame(render_device, cfg: str, options=None):
    """One frame of ``feature_golden_scene(render_device, cfg)`` at 128×64
    with test_golden_features.py's 8×128 tiles (or ``options``), encoded as
    the golden is (RGBA8 sRGB): a (64, 128, 4) uint8 tensor on the device."""
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.rhi import PipelineCache, encode_present

    _, _, declare = feature_golden_scene(render_device, cfg)
    builder = RenderGraphBuilder()
    out = declare(builder, GOLDEN_W, GOLDEN_H)
    builder.export(out)
    compiled = builder.build().compile(render_device, PipelineCache(),
                                       options or CompileOptions(tile_h=8, tile_w=128))
    compiled.execute(render_device)
    return encode_present(compiled.value(out), Format.RGBA8_SRGB)


def emissive_pixels(size: int = 64) -> np.ndarray:
    """A procedural emissive map (size, size, 4) sRGB uint8: warm glowing
    rings on black (the full-material-set golden scene's panel)."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    r = np.hypot(xs - size / 2 + 0.5, ys - size / 2 + 0.5) / size
    glow = (np.cos(r * 6.0 * math.pi) * 0.5 + 0.5) * (r < 0.5)
    px = np.zeros((size, size, 4), np.uint8)
    px[..., 0] = (255 * glow).astype(np.uint8)
    px[..., 1] = (160 * glow).astype(np.uint8)
    px[..., 2] = (60 * glow).astype(np.uint8)
    px[..., 3] = 255
    return px


def textured_golden_scene(render_device, full_material: bool = False):
    """tests/test_golden.py::_render_textured_frame's scene: a
    brushed-textured panel (``brushed_texture(64)`` from ``default_rng(7)``)
    over a checker-textured ground (``checker_texture(64, 8)``) under a sun,
    and its 128x64 camera. ``full_material`` adds the rest of the material
    set: the 64² bump normal map and MRA stripes on the ground and a 64²
    emissive map (emissive factor 2) on the panel. Returns (scene, camera)."""
    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree, Radians
    from zenith_tpu_torch.renderer import DirectionalLight, Scene, SceneObject

    dev = render_device.device
    full = dict(normal_texture=bump_normal_texture(64, 8, device=dev),
                mra_texture=mra_stripe_texture(64, 8, device=dev)) if full_material else {}
    ground = SceneObject.quad(render_device, "ground", size=200.0, z=0.0,
                              base_color=(0.9, 0.9, 0.95, 1.0), roughness=0.9,
                              base_color_texture=checker_texture(64, 8, device=dev), **full)
    glow = dict(emissive=(2.0, 2.0, 2.0), emissive_texture=Texture.from_numpy(
        "emissive.rings", emissive_pixels(64), Format.RGBA8_SRGB, generate_mips=True,
        device=dev)) if full_material else {}
    panel = SceneObject.quad(render_device, "panel", size=30.0, z=12.0,
                             base_color=(0.9, 0.6, 0.4, 1.0), metallic=0.6, roughness=0.4,
                             base_color_texture=brushed_texture(
                                 64, rng=np.random.default_rng(7), device=dev), **glow)
    scene = Scene(
        objects=[panel, ground],
        sun=DirectionalLight(direction=(0.05, -0.05, 1.0), intensity=2.5,
                             shadow_map_size=128, shadow_extent=60.0),
        ambient=(0.05, 0.05, 0.05),
    )
    cam = Camera(fov_y=Degree(45.0), aspect_ratio=GOLDEN_W / GOLDEN_H)
    cam.set_position(np.array([0.0, -60.0, 25.0], np.float32))
    cam.set_yaw_pitch(Radians(0.0), Radians(-0.25))
    return scene, cam


def standin_mesh() -> Mesh:
    """A procedural stand-in for the cerberus mesh, in the Vertex layout and
    glTF's y-up frame, with about cerberus's counts (33.5k triangles, 27k
    vertices): a smooth barrel (a cylinder grid, shared vertices) over a
    flat-shaded receiver (a subdivided box, 4 vertices per quad)."""
    verts, idx = [], []
    # Barrel along +x: 48 segments around, 280 rings, seam duplicated.
    nu, nv, radius, x0, x1, yc = 48, 280, 3.5, -20.0, 90.0, 5.0
    a = np.linspace(0.0, 2 * np.pi, nu + 1)
    xs = np.linspace(x0, x1, nv)
    xx, aa = np.meshgrid(xs, a, indexing="ij")  # (nv, nu + 1)
    ny, nz = np.cos(aa), np.sin(aa)
    grid = np.stack([xx, yc + radius * ny, radius * nz, np.zeros_like(xx), ny, nz,
                     xx / (x1 - x0), aa / (2 * np.pi)], -1).reshape(-1, 8)
    verts.append(grid)
    r, c = np.meshgrid(np.arange(nv - 1), np.arange(nu), indexing="ij")
    v00 = r * (nu + 1) + c
    v01, v10, v11 = v00 + 1, v00 + (nu + 1), v00 + (nu + 1) + 1
    idx.append(np.stack([v00, v11, v10, v00, v01, v11], -1).reshape(-1, 3))
    base = grid.shape[0]
    # Receiver: a 50 x 18 x 8 box, each face cut into ~0.92-unit quads.
    half = np.array([25.0, 9.0, 4.0])
    for axis in range(3):
        u_ax, v_ax = [k for k in range(3) if k != axis]
        nu_q = int(np.ceil(2 * half[u_ax] / 0.92))
        nv_q = int(np.ceil(2 * half[v_ax] / 0.92))
        us = np.linspace(-half[u_ax], half[u_ax], nu_q + 1)
        vs = np.linspace(-half[v_ax], half[v_ax], nv_q + 1)
        for sign in (1.0, -1.0):
            normal = np.zeros(3)
            normal[axis] = sign
            for i in range(nu_q):
                for j in range(nv_q):
                    quad = []
                    for du, dv in ((0, 0), (1, 0), (1, 1), (0, 1)):
                        p = np.zeros(3)
                        p[axis] = sign * half[axis]
                        p[u_ax], p[v_ax] = us[i + du], vs[j + dv]
                        quad.append([*p, *normal, du, dv])
                    verts.append(np.asarray(quad))
                    # Outward winding: swap the diagonal order on the
                    # faces whose (u, v, n) frame is left-handed.
                    flip = (sign < 0) != (axis == 1)
                    tri = [[0, 2, 1], [0, 3, 2]] if flip else [[0, 1, 2], [0, 2, 3]]
                    idx.append(base + np.asarray(tri))
                    base += 4
    v = np.concatenate(verts).astype(np.float32)
    return Mesh(AssetUrl("procedural/cerberus-standin"), v, np.concatenate(idx).astype(np.int32))


def glass_checker_texture(device: "torch.device | str") -> Texture:
    """build_scene's 64² two-tone checker for the textured glass panes."""
    yy, xx = np.mgrid[0:64, 0:64]
    c = ((xx // 4 + yy // 4) % 2).astype(np.float32)
    px = np.stack([0.4 + 0.6 * c, 1.0 - 0.5 * c, np.full_like(c, 0.8), np.ones_like(c)],
                  axis=-1).astype(np.float32)
    return Texture.from_numpy("pane.checker", px, Format.RGBA32F, device=torch.device(device))


def build_scene(render_device, num_lights: int, rng: np.random.Generator,
                textured: bool = False, skybox: bool = True,
                glass: bool = False, glass_textured: bool = False,
                instances: int = 0, gun_instances: int = 0, ibl: bool = False,
                skinned: bool = False, morph: bool = False):
    """zenith_tpu/sandbox/scene.py::build_scene (scene.py:289-470): loads
    ``mesh/cerberus/scene.gltf`` through the AssetManager (content root
    ``default_content_root()``, cache ZENITH_CACHE or ``cache``: a baked
    cache is loaded when the source is absent) and builds the sandbox scene
    around its first mesh. Raises where neither the content nor its baked
    cache is found, as the reference does. ``instances`` adds the ring of
    instanced rocks, ``gun_instances`` draws the cerberus as one instanced
    draw of that many copies; ``ibl`` lights the scene with the sky cube's
    split-sum environment (SH diffuse and the prefiltered specular, which
    also serves as the background) in place of the flat ambient and the
    skybox; ``skinned`` adds the waving ``skinned_tube`` beside the gun and
    ``morph`` the pulsing ``morphing_blob`` on its other side. Returns the
    Scene."""
    from zenith_tpu_torch.asset import AssetManager, registry

    mgr = AssetManager(root=default_content_root(),
                       cache_dir=os.environ.get("ZENITH_CACHE", "cache"))
    collection = mgr.request_load("mesh/cerberus/scene.gltf").get()
    mesh = registry().get(AssetUrl(collection.mesh_urls[0]), Mesh)
    scene = _sandbox_scene(render_device, mesh, num_lights, rng, textured, skybox and not ibl,
                           glass, glass_textured, instances, gun_instances, skinned, morph)
    if ibl:
        from zenith_tpu_torch.renderer import EnvironmentLight

        scene.environment = EnvironmentLight.from_cube_pixels(
            "sky.env", sky_cube_pixels(), num_mips=5, samples=64, device=render_device.device)
    return scene


def build_standin_scene(render_device, num_lights: int, rng: np.random.Generator,
                        glass: bool = False, glass_textured: bool = False,
                        textured: bool = False):
    """``build_scene``'s deferred scene (skybox on) with the cerberus mesh
    replaced by ``standin_mesh``. Returns (scene, mesh)."""
    mesh = standin_mesh()
    return _sandbox_scene(render_device, mesh, num_lights, rng, textured, True, glass,
                          glass_textured), mesh


def _sandbox_scene(render_device, mesh: Mesh, num_lights: int, rng: np.random.Generator,
                   textured: bool, skybox: bool, glass: bool, glass_textured: bool,
                   instances: int = 0, gun_instances: int = 0, skinned: bool = False,
                   morph: bool = False):
    """build_scene's scene around ``mesh``: the same material and model
    centring, the 400-unit ground quad, ``num_lights`` point lights placed as
    build_scene places them, the sun with a 1024² shadow map over a 90-unit
    extent, and a 64² sky cube when ``skybox``. ``textured`` gives the mesh
    the brushed texture and the ground the checker, bump normal and MRA maps
    with build_scene's textured factors; the brushed texture draws from
    ``rng`` before the lights, in build_scene's order. ``glass`` adds the two
    standing translucent panes in front of the mesh (drawn by the deferred
    renderer's glass node), ``glass_textured`` gives them the 64² checker.
    ``gun_instances`` > 0 draws the mesh as that many instanced copies on a
    ring (the geometry-scaling configuration: 30 copies of cerberus are ~1M
    submitted triangles); ``instances`` > 0 adds one instanced draw of that
    many 9-unit rocks around it, placed from ``rng`` after the lights;
    ``skinned`` and ``morph`` add the tentacle and the blob after them
    (scene.py:422-445)."""
    from zenith_tpu_torch.core import mathtypes as m
    from zenith_tpu_torch.renderer import DirectionalLight, PointLight, Scene, SceneObject

    dev = render_device.device
    bmin = mesh.vertices[:, :3].min(axis=0)
    bmax = mesh.vertices[:, :3].max(axis=0)
    model = YUP_TO_ZUP @ m.mat4_translation(-0.5 * (bmin + bmax))
    corners = np.stack(np.meshgrid(*zip(bmin, bmax), indexing="ij"), -1).reshape(-1, 3)
    z_min = min(float(m.transform_point(model, c)[2]) for c in corners)
    gun_offsets = None
    gun_budget = 16 * mesh.num_triangles
    if gun_instances > 0:
        ring = float(np.linalg.norm(bmax - bmin)) * 1.1
        offs = [[0.0, 0.0, 0.0]]
        for i in range(1, gun_instances):
            a = 2 * math.pi * i / gun_instances
            r = ring * (1.0 + 0.15 * ((i * 7) % 3))
            offs.append([r * math.cos(a), r * math.sin(a), 2.0 * ((i * 5) % 4)])
        gun_offsets = np.asarray(offs, np.float32)
        gun_budget = None  # the default, 2x the records, scales with the copies
    gun = SceneObject.from_mesh(
        render_device, mesh, "cerberus", model_matrix=model,
        base_color=(0.62, 0.57, 0.55, 1.0), metallic=0.85, roughness=0.45,
        entry_budget=gun_budget,
        base_color_texture=brushed_texture(rng=rng, device=dev) if textured else None,
        instance_offsets=gun_offsets,
    )
    ground = SceneObject.quad(
        render_device, "ground", size=400.0, z=z_min - 2.0,
        base_color=(0.9, 0.9, 0.95, 1.0) if textured else (0.28, 0.3, 0.33, 1.0),
        metallic=0.6 if textured else 0.0,  # modulated by the MRA map
        roughness=0.9,
        base_color_texture=checker_texture(device=dev) if textured else None,
        normal_texture=bump_normal_texture(device=dev) if textured else None,
        mra_texture=mra_stripe_texture(device=dev) if textured else None,
    )
    lights = []
    radius_xy = float(np.linalg.norm(bmax - bmin)) * 0.7
    for i in range(num_lights):
        ang = 2 * math.pi * i / max(num_lights, 1)
        r = radius_xy * (0.4 + 0.6 * rng.uniform())
        hue = rng.uniform(0, 1)
        col = np.array(
            [abs(math.sin(hue * math.pi * 2)), abs(math.sin((hue + 1 / 3) * math.pi * 2)),
             abs(math.sin((hue + 2 / 3) * math.pi * 2))], np.float32,
        )
        lights.append(PointLight(
            position=(r * math.cos(ang), r * math.sin(ang), z_min + 4.0 + 20.0 * rng.uniform()),
            color=tuple(col), intensity=400.0 + 600.0 * rng.uniform(), radius=60.0,
        ))
    objects = [gun, ground]
    if glass:
        glass_tex = glass_checker_texture(dev) if glass_textured else None
        span = float(np.linalg.norm(bmax - bmin))
        for gi, (dx, tint) in enumerate([(-0.4 * span, (0.4, 0.7, 1.0, 0.35)),
                                         (0.4 * span, (1.0, 0.5, 0.4, 0.45))]):
            pane = SceneObject.quad(render_device, f"pane{gi}", size=span * 0.6, z=0.0,
                                    base_color=tint, translucent=True,
                                    base_color_texture=glass_tex)
            # Stand the quad up (rotate about X) and place it.
            trans = m.mat4_translation(
                np.array([dx, -0.4 * span, z_min + 0.4 * span], np.float32))
            pane.model_matrix = (trans @ YUP_TO_ZUP).astype(np.float32)
            objects.append(pane)
    if instances > 0:
        ring = float(np.linalg.norm(bmax - bmin)) * 0.9
        offs = []
        for i in range(instances):
            a = 2 * math.pi * i / instances + 0.35
            r = ring * (0.8 + 0.5 * rng.uniform())
            offs.append([r * math.cos(a), r * math.sin(a), z_min - 2.0])
        objects.append(SceneObject.cube(
            render_device, "rocks", size=9.0, z0=0.0, base_color=(0.35, 0.33, 0.3, 1.0),
            roughness=0.85, instance_offsets=np.asarray(offs, np.float32)))
    span = float(np.linalg.norm(bmax - bmin))
    if skinned:
        # A waving skinned tentacle beside the gun (AnimationPlayer drives
        # its palette).
        objects.append(SceneObject.from_mesh(
            render_device, skinned_tube(), "tentacle",
            model_matrix=m.mat4_translation(np.array([-0.75 * span, 0.25 * span, z_min],
                                                     np.float32)),
            base_color=(0.45, 0.75, 0.5, 1.0), metallic=0.1, roughness=0.5))
    if morph:
        # A pulsing morph-target blob on the other side.
        objects.append(SceneObject.from_mesh(
            render_device, morphing_blob(), "blob",
            model_matrix=m.mat4_translation(np.array([0.8 * span, 0.3 * span, z_min + 10.0],
                                                     np.float32)),
            base_color=(0.8, 0.55, 0.3, 1.0), metallic=0.2, roughness=0.35))
    return Scene(
        objects=objects,
        sun=DirectionalLight(direction=(0.35, -0.3, 0.88), intensity=2.5,
                             shadow_map_size=1024, shadow_extent=90.0),
        point_lights=lights,
        ambient=(0.02, 0.02, 0.03),
        skybox=sky_cube_texture(64, device=dev) if skybox else None,
    )


def orbit_camera(camera, orbit: float) -> None:
    """bench.py::bench_scene's camera orbit: radius 170, height 25."""
    from zenith_tpu_torch.core.mathtypes import Radians

    camera.set_position(np.array([math.sin(orbit) * 170.0, -math.cos(orbit) * 170.0, 25.0],
                                 np.float32))
    camera.set_yaw_pitch(Radians(orbit), Radians(-math.atan2(20.0, 170.0)))


def deferred_frame(render_device, renderer, camera, width: int, height: int, options,
                   present_format=None, exports=(), pipeline_cache=None):
    """One frame of the deferred path as bench.py::bench_scene's frame
    function builds it: rebuild → DeferredRenderer.render_to → PostProcess
    → PresentEncode(present_format) when given → compile → execute.
    ``exports`` names G-buffer planes (or "hdr") to keep. Returns
    (compiled graph, the frame's output handle, the HDR handle, retired)."""
    from zenith_tpu_torch.rendergraph import RenderGraphBuilder
    from zenith_tpu_torch.renderer import PostProcess, PresentEncode
    from zenith_tpu_torch.rhi import PipelineCache, TextureDesc

    builder = RenderGraphBuilder()
    hdr = builder.create(TextureDesc.color("scene.hdr", width, height, Format.RGBA32F))
    out = builder.create(TextureDesc.color("scene.out", width, height, Format.RGBA32F))
    renderer.render_to(builder, hdr, camera, width, height)
    PostProcess().render_to(builder, hdr, out)
    final = out
    if present_format is not None:
        final = builder.create(TextureDesc.color("scene.enc", width, height, present_format))
        PresentEncode(present_format).render_to(builder, out, final)
    builder.export(final)
    for name in exports:
        builder.export(hdr if name == "hdr" else renderer.gbuffer_handles[name])
    compiled = builder.build().compile(render_device, pipeline_cache or PipelineCache(), options)
    retired = compiled.execute(render_device)
    return compiled, final, hdr, retired


def _scene_app_parser():
    """SceneApp's arguments (the reference's, scene.py:477-638)."""
    import argparse

    p = argparse.ArgumentParser("scene-app")
    p.add_argument("--mode", choices=["forward", "deferred"], default="deferred")
    p.add_argument("--lights", type=int, default=100)
    p.add_argument("--no-post", action="store_true")
    p.add_argument("--textured", action="store_true")
    p.add_argument("--bloom-mips", type=int, default=0,
                   help="bloom over a downsampled mip chain; 0 = single-node bloom")
    p.add_argument("--glass", action="store_true",
                   help="two translucent panes through the in-order blend kernel")
    p.add_argument("--glass-textured", action="store_true",
                   help="checker-textured panes (auto-selects the depth-peeled glass path)")
    p.add_argument("--glass-mode", choices=["auto", "kernel", "peel"], default="auto")
    p.add_argument("--spots", type=int, default=0,
                   help="N coloured spot lights aimed at the ground (deferred mode)")
    p.add_argument("--gun-instances", type=int, default=0,
                   help="instanced cerberus copies (30 ~= 1M submitted triangles)")
    p.add_argument("--instances", type=int, default=0,
                   help="N instanced rocks around the gun (one draw)")
    p.add_argument("--wireframe", action="store_true",
                   help="LINE polygon mode on the lit / G-buffer pass")
    p.add_argument("--msaa", type=int, default=1, choices=[1, 2, 4, 8],
                   help="multisampling on the forward lit pass (forward mode only)")
    p.add_argument("--retained", action="store_true",
                   help="(the default) build the graph once, re-execute with fresh dynamics")
    p.add_argument("--no-retained", action="store_true",
                   help="rebuild the graph every frame")
    p.add_argument("--ssao", action="store_true",
                   help="screen-space ambient occlusion on the ambient term (deferred mode)")
    p.add_argument("--contact-shadows", action="store_true",
                   help="screen-space contact shadows: a short march toward the sun "
                        "(deferred mode)")
    p.add_argument("--ssr", action="store_true",
                   help="screen-space reflections on smooth surfaces (deferred mode)")
    p.add_argument("--fog", action="store_true",
                   help="volumetric height fog + sun shafts from the shadow map (deferred mode)")
    p.add_argument("--sky", action="store_true",
                   help="procedural atmosphere sky (deferred); drops the sun toward the horizon")
    p.add_argument("--flare", action="store_true",
                   help="lens flare on the HDR frame (drops the sun toward the horizon)")
    p.add_argument("--decals", type=int, default=0,
                   help="N projected decals stamped in a ring on the ground (deferred mode)")
    p.add_argument("--cascades", type=int, default=1,
                   help="N > 1: cascaded shadow maps for the sun (deferred mode)")
    p.add_argument("--soft-shadows", action="store_true",
                   help="variance shadow maps (soft penumbrae) for the sun (deferred mode, "
                        "one cascade)")
    p.add_argument("--point-shadows", action="store_true",
                   help="one shadow-casting point light with a cube shadow map (deferred mode)")
    p.add_argument("--ibl", action="store_true",
                   help="image-based light from the procedural sky (SH diffuse + prefiltered "
                        "GGX specular; deferred mode)")
    p.add_argument("--probe", action="store_true",
                   help="reflection probe: capture the scene into a cube map on the device, "
                        "preintegrate it and light with it (deferred mode)")
    p.add_argument("--fxaa", action="store_true",
                   help="FXAA-class post AA on the tonemapped output")
    p.add_argument("--grade", action="store_true",
                   help="colour grade (white balance, contrast, saturation, vignette)")
    p.add_argument("--film", action="store_true",
                   help="film effects: chromatic aberration, sharpen, grain")
    p.add_argument("--auto-exposure", action="store_true",
                   help="eye adaptation fed back on the device across frames")
    p.add_argument("--taa", action="store_true",
                   help="temporal AA: jittered projection + reprojected history (deferred mode)")
    p.add_argument("--velocity", action="store_true",
                   help="the per-draw velocity G-buffer plane (automatic for device-resident "
                        "instance offsets)")
    p.add_argument("--motion-blur", action="store_true",
                   help="camera and object motion blur (deferred mode)")
    p.add_argument("--dof", action="store_true",
                   help="depth of field (mip-blend bokeh; the focus rides a dynamic)")
    p.add_argument("--hud", action="store_true",
                   help="on-screen FPS and object count, a host-rasterized bitfont riding a "
                        "dynamic, with the bin-overflow bar")
    p.add_argument("--particles", type=int, default=0,
                   help="N sparks simulated on the device (a compute node and an instanced "
                        "draw; deferred mode)")
    p.add_argument("--skinned", action="store_true",
                   help="a waving skinned tentacle (joint palettes ride dynamics; deferred mode)")
    p.add_argument("--morph", action="store_true",
                   help="a pulsing morph-target blob (weights ride dynamics; deferred mode)")
    p.add_argument("--pick", action="store_true",
                   help="object picking: export the G-buffer id plane and log the object under "
                        "the screen centre when it changes (deferred mode)")
    return p


class SceneApp(RenderableApp):
    """The sandbox scene app (sandbox/scene.py:474-1173): forward mode
    (config #3: ForwardShadowRenderer, ``--msaa``, ``--wireframe``,
    ``--instances``, ``--gun-instances``) or deferred mode (config #5:
    DeferredRenderer with ``--lights``, ``--spots``, ``--textured``,
    ``--glass``, ``--wireframe``, ``--ssao``, ``--contact-shadows``,
    ``--decals N``, ``--sky``, ``--instances``, ``--gun-instances``,
    ``--cascades N``, ``--point-shadows``, ``--soft-shadows``, ``--ibl``,
    ``--probe``, ``--velocity``, ``--skinned``, ``--morph``,
    ``--particles N``, ``--pick``, then the ``--ssr`` and ``--fog``
    passes) over build_scene's cerberus scene, ``--flare`` on the HDR
    frame, then ``--taa``, ``--motion-blur`` and ``--dof``, bloom + ACES
    post (over a mip chain with ``--bloom-mips N``; ``--auto-exposure``,
    ``--grade``, ``--fxaa``, ``--film``) unless ``--no-post``, the
    ``--hud`` last, an orbit camera that the first input event hands to fly
    controls, and auto-retained execution. TAA's history, the adapted
    exposure and the particle state return through ``on_frame_outputs``,
    as does the id plane, of which ``--pick`` reads the centre pixel."""

    def __init__(self, args: Args):
        super().__init__(args)
        ns, _ = _scene_app_parser().parse_known_args(args.app_args)
        self.mode = ns.mode
        deferred = ns.mode == "deferred"
        self.textured = ns.textured and deferred
        self.glass = (ns.glass or ns.glass_textured) and deferred
        self.glass_textured = ns.glass_textured and deferred
        self.glass_mode = ns.glass_mode
        self.spots = ns.spots if deferred else 0
        self.instances = ns.instances
        self.gun_instances = ns.gun_instances
        self.wireframe = ns.wireframe
        self.msaa = ns.msaa
        self.bloom_mips = ns.bloom_mips
        self.num_lights = ns.lights if deferred else 0
        self.post_enabled = not ns.no_post
        self.ssao = ns.ssao and deferred
        self.contact_shadows = ns.contact_shadows and deferred
        self.n_decals = ns.decals if deferred else 0
        self.use_sky = ns.sky and deferred
        self.use_flare = ns.flare
        self.use_ssr = ns.ssr and deferred
        self.use_fog = ns.fog and deferred
        self.cascades = ns.cascades
        self.soft_shadows = ns.soft_shadows and deferred
        self.point_shadows = ns.point_shadows and deferred
        self.ibl = ns.ibl and deferred
        self.use_probe = ns.probe and deferred
        self.fxaa = ns.fxaa
        self.auto_exposure = ns.auto_exposure
        self.use_grade = ns.grade
        self.use_film = ns.film
        self.use_taa = ns.taa and deferred
        self.use_mblur = ns.motion_blur and deferred
        # --velocity forces the plane on; otherwise the renderer decides
        # (on for device-resident instance offsets).
        self.use_velocity = True if (ns.velocity and deferred) else None
        self.skinned = ns.skinned and deferred
        self.morph = ns.morph and deferred
        self.n_particles = ns.particles if deferred else 0
        self.use_hud = ns.hud
        self.use_pick = ns.pick and deferred
        self.use_dof = ns.dof and deferred
        self.hud = None
        self._hud_fps = 0.0
        self._picked_name: "str | None" = None
        self.dof = None
        self.psys = None
        self._dt = 1.0 / 60.0
        self._players = []  # (AnimationPlayer, SceneObject)
        self._morphers = []  # (AnimationClip, SceneObject)
        self._anim_t = 0.0
        self.taa = None
        self.mblur = None
        self.flare = None
        self.ssr = None
        self.fog = None
        self._sun_dir = (0.35, -0.3, 0.88)
        # Auto-retained by default: every per-frame value rides a dynamic, so
        # the engine re-runs the cached frame function; a structural scene
        # edit calls mark_structure_dirty() and the next frame rebuilds.
        self.retained = not ns.no_retained
        self._structure_dirty = False
        self.renderer = None
        self.post = None
        self.camera = None
        # ZENITH_ORBIT_START pins the camera's initial orbit angle (rad).
        self.orbit = float(os.environ.get("ZENITH_ORBIT_START", "0.0"))
        self._radius = 120.0
        self._height = 20.0
        # The first real input event switches the scripted orbit to fly
        # controls.
        from zenith_tpu_torch.core.camera import CameraController
        from zenith_tpu_torch.core.input import InputActionMapper

        self.controller = CameraController(mouse_sensitivity=0.4)
        self.controller.move_speed = 60.0
        self.mapper = InputActionMapper()
        self.mapper.register_axis("forward", [KeyCode.KEY_W], [KeyCode.KEY_S], 0.5)
        self.mapper.register_axis("right", [KeyCode.KEY_D], [KeyCode.KEY_A], 0.5)
        self.mapper.register_axis("up", [KeyCode.KEY_E], [KeyCode.KEY_Q], 0.5)
        self.mapper.register_action("quit", [KeyCode.ESCAPE])
        self._interactive = False
        self._window = None
        self._extent = (0, 0)

    def prepare(self, render_device, window) -> None:
        from zenith_tpu_torch.core.camera import Camera
        from zenith_tpu_torch.core.mathtypes import Degree
        from zenith_tpu_torch.renderer import (
            Atmosphere,
            ColorGrade,
            Decal,
            DeferredRenderer,
            DepthOfField,
            FilmEffects,
            ForwardShadowRenderer,
            LensFlare,
            MotionBlur,
            ParticleSystem,
            PointLight,
            PostProcess,
            SceneObject,
            ScreenSpaceReflections,
            SpotLight,
            SSAOOptions,
            TemporalAA,
            VolumetricFog,
        )

        rng = np.random.default_rng(42)
        scene = build_scene(render_device, self.num_lights, rng, textured=self.textured,
                            instances=self.instances, gun_instances=self.gun_instances,
                            glass=self.glass, glass_textured=self.glass_textured, ibl=self.ibl,
                            skinned=self.skinned, morph=self.morph)
        palette = [(1.0, 0.2, 0.15, 0.85), (0.2, 0.9, 1.0, 0.85),
                   (1.0, 0.8, 0.2, 0.85), (0.6, 0.3, 1.0, 0.85)]
        for k in range(self.n_decals):
            a = 2.0 * math.pi * k / self.n_decals
            # A deep box, so the down-projection reaches the ground plane.
            scene.decals.append(Decal(f"mark{k}", position=(85.0 * math.cos(a),
                                                            85.0 * math.sin(a), 0.0),
                                      size=(26.0, 26.0, 120.0), color=palette[k % len(palette)]))
        if self.use_probe:
            from zenith_tpu_torch.renderer import capture_reflection_probe

            # Captured above the ground near the gun before the probe
            # becomes the scene's own environment (after the decals, before
            # the extra lights, as the reference); its level 0 is the sky.
            scene.environment = capture_reflection_probe(render_device, scene,
                                                         (0.0, -30.0, 25.0), size=64)
            scene.skybox = None
        for i in range(self.spots):
            a = 2 * math.pi * i / self.spots + 0.8
            hue = [(3.0, 0.6, 0.5), (0.5, 3.0, 0.8), (0.6, 0.9, 3.0)][i % 3]
            scene.spot_lights.append(SpotLight(
                position=(60.0 * math.cos(a), 60.0 * math.sin(a), 45.0),
                direction=(0.25 * math.cos(a + 2), 0.25 * math.sin(a + 2), -1.0),
                color=hue, intensity=1800.0, radius=130.0, inner_deg=14.0, outer_deg=22.0,
            ))
        if self.point_shadows:
            scene.point_lights.append(PointLight(
                position=(-35.0, -25.0, 30.0), color=(1.0, 0.8, 0.55), intensity=2500.0,
                radius=160.0, cast_shadows=True, shadow_map_size=256))
        if self.n_particles > 0:
            # Sparks: the sim's positions, device tensors, are the instanced
            # draw's offsets (the previous frame's step).
            self.psys = ParticleSystem(self.n_particles, emitter=(40.0, 30.0, 3.0),
                                       device=render_device.device)
            scene.objects.append(SceneObject.cube(
                render_device, "sparks", size=1.0, z0=-0.5, base_color=(1.0, 0.75, 0.3, 1.0),
                roughness=0.4, emissive=(4.0, 2.4, 0.8), instance_offsets=self.psys.positions))
        if self.skinned or self.morph:
            from zenith_tpu_torch.renderer.animation import AnimationPlayer

            for obj in scene.objects:
                if self.skinned and obj.skin is not None and obj.clips:
                    player = AnimationPlayer(obj.skin, obj.clips[0])
                    obj.joint_matrices = player.joint_matrices(0.0)
                    self._players.append((player, obj))
                if self.morph and obj.morph_deltas is not None and obj.clips:
                    self._morphers.append((obj.clips[0], obj))
        if self.cascades > 1 and scene.sun is not None:
            scene.sun = dataclasses.replace(scene.sun, cascades=self.cascades)
        if self.soft_shadows and scene.sun is not None:
            scene.sun = dataclasses.replace(scene.sun, soft_shadows=True)
        if self.contact_shadows and scene.sun is not None:
            scene.sun = dataclasses.replace(scene.sun, contact_shadows=True)
        if self.mode == "deferred":
            self.renderer = DeferredRenderer(
                scene, wireframe=self.wireframe,
                ssao=SSAOOptions(radius=6.0) if self.ssao else False,
                id_buffer=self.use_pick, velocity=self.use_velocity, glass_mode=self.glass_mode)
        else:
            self.renderer = ForwardShadowRenderer(scene, wireframe=self.wireframe, msaa=self.msaa)
        grade = (ColorGrade(exposure_ev=0.15, contrast=1.08, saturation=1.12, temperature=0.35,
                            tint=-0.05, vignette=0.45) if self.use_grade else None)
        film = (FilmEffects(chromatic_aberration=2.5, sharpen=0.4, grain=0.035)
                if self.use_film else None)
        self.post = (PostProcess(bloom_mips=self.bloom_mips, fxaa=self.fxaa,
                                 auto_exposure=self.auto_exposure, grade=grade, film=film)
                     if self.post_enabled else None)
        if (self.use_sky or self.use_flare) and scene.sun is not None:
            # Sunset: the sun drops toward the horizon so that it enters the
            # orbit camera's 35-degree frame.
            scene.sun = dataclasses.replace(scene.sun, direction=(0.8, -0.55, 0.1))
            self._sun_dir = scene.sun.direction
        if self.use_sky and scene.environment is None:
            # The procedural sky replaces the demo cube skybox.
            scene.skybox = None
            scene.atmosphere = Atmosphere()
        if self.use_flare and self.post is not None and scene.sun is not None:
            self.flare = LensFlare()
        if self.use_ssr:
            self.ssr = ScreenSpaceReflections()
        if self.use_fog:
            self.fog = VolumetricFog()
        if self.use_hud:
            from zenith_tpu_torch.renderer.hud import HudOverlay

            self.hud = HudOverlay(max_chars=24, scale=2, overflow_indicator=True)
            self.hud.set_text("FPS ----")
        if self.use_dof:
            self.dof = DepthOfField(focus_distance=170.0, focal_range=30.0, strength=1.4)
        self.camera = Camera(fov_y=Degree(35.0), aspect_ratio=window.width / max(window.height, 1))
        if self.use_taa:
            self.taa = TemporalAA()
        if self.use_mblur:
            self.mblur = MotionBlur(strength=1.0, max_radius=32.0)
        self._extent = (window.width, window.height)
        self._window = window
        self._radius = 170.0
        self._height = 25.0
        self._update_camera()

    def on_window_event(self, event: WindowEvent) -> None:
        if isinstance(event, (KeyboardInput, MouseInput)):
            self._interactive = True
        self.mapper.on_window_event(event)
        self.controller.on_window_event(event)

    def on_device_event(self, event: DeviceEvent) -> None:
        self.controller.on_device_event(event)

    def resize(self, width: int, height: int) -> None:
        self._extent = (width, height)
        if self.taa is not None:
            self.taa.reset()  # the history's shape changes; the jitter scale follows
        if self.mblur is not None:
            self.mblur.reset()

    def tick(self, delta_time: float) -> None:
        if self._interactive:
            self.mapper.tick(delta_time)
            if self.mapper.is_action_just_pressed("quit") and self._window is not None:
                self._window.request_close()
            self.controller.update_cameras(
                delta_time, self.mapper.get_axis("forward"), self.mapper.get_axis("right"),
                self.mapper.get_axis("up"), [self.camera])
        else:
            self.orbit += delta_time * float(os.environ.get("ZENITH_ORBIT_SPEED", "0.4"))
            self._update_camera()
        if self.taa is not None:
            self.taa.jitter_camera(self.camera, *self._extent)
        if self.post is not None and self.post.auto_exposure:
            self.post.set_delta_time(delta_time)
        self._anim_t += delta_time
        self._dt = delta_time
        if self.hud is not None and delta_time > 0.0:
            # Exponentially smoothed FPS; set_text caches, so the bitmap is
            # rasterized again only when the string changes.
            inst = 1.0 / delta_time
            self._hud_fps = (inst if self._hud_fps == 0.0
                             else self._hud_fps + 0.05 * (inst - self._hud_fps))
            n_obj = len(self.renderer.scene.objects) if self.renderer is not None else 0
            self.hud.set_text(f"FPS {self._hud_fps:5.0f}  OBJ {n_obj}")
        if self.psys is not None:
            for obj in self.renderer.scene.objects:
                if obj.name == "sparks":
                    obj.instance_offsets = self.psys.positions
        for player, obj in self._players:
            obj.joint_matrices = player.joint_matrices(self._anim_t)
        if self._morphers:
            from zenith_tpu_torch.renderer.animation import sample_morph_weights

            for clip, obj in self._morphers:
                obj.morph_weights = sample_morph_weights(clip, self._anim_t,
                                                         obj.morph_deltas.shape[0])

    def _update_camera(self) -> None:
        from zenith_tpu_torch.core.mathtypes import Radians

        x = math.sin(self.orbit) * self._radius
        y = -math.cos(self.orbit) * self._radius
        self.camera.set_position(np.array([x, y, self._height], np.float32))
        pitch = -math.atan2(self._height - 5.0, self._radius)
        self.camera.set_yaw_pitch(Radians(self.orbit), Radians(pitch))

    def mark_structure_dirty(self) -> None:
        """Call after a structural scene edit (an object added or removed, a
        classifying field flipped, a texture swapped): the next
        update_dynamics returns None once, which sends that frame through
        the rebuild path and caches the new frame function. Value changes
        (transforms, visibility, materials, lights) ride dynamics."""
        self._structure_dirty = True

    def update_dynamics(self):
        """Auto-retained hook (engine.py): this frame's per-frame values, or
        None (the rebuild path) with --no-retained or after
        mark_structure_dirty()."""
        if not self.retained or self.renderer is None:
            return None
        if self._structure_dirty:
            self._structure_dirty = False
            return None
        d = (self.renderer.frame_dynamics(self.camera, include_models=True)
             if self.mode == "deferred" else self.renderer.frame_dynamics(self.camera))
        if self.taa is not None:
            d.update(self.taa.frame_dynamics(self.camera))
        if self.post is not None:
            d.update(self.post.frame_dynamics())
        if self.mblur is not None:
            d.update(self.mblur.frame_dynamics(self.camera))
        if self.ssr is not None:
            d.update(self.ssr.frame_dynamics(self.camera))
        if self.fog is not None:
            d.update(self.fog.frame_dynamics(self.camera))
        if self.dof is not None:
            d.update(self.dof.frame_dynamics())
        if self.flare is not None:
            d.update(self.flare.sun_dynamics(self.camera, self._sun_dir))
        if self.hud is not None:
            d.update(self.hud.frame_dynamics())
        if self.psys is not None:
            d.update(self.psys.frame_dynamics(self._dt))
        return d

    def on_frame_outputs(self, outputs) -> None:
        """Engine feedback (request_output): the particle state, TAA's
        history and the adapted exposure for the next frame, device tensors
        all; with ``--pick``, the object under the screen centre, read from
        the id plane's one pixel after the frame."""
        if self.psys is not None and "psys.state" in outputs:
            self.psys.feedback(outputs["psys.state"], outputs["psys.pos"])
        if self.use_pick and "object_id" in outputs:
            ids = outputs["object_id"]
            obj = self.renderer.pick(ids, ids.shape[1] // 2, ids.shape[0] // 2)
            name = obj.name if obj is not None else None
            if name != self._picked_name:
                self._picked_name = name
                logger.info("pick: the screen centre is over %s", name or "<background>")
        if self.taa is not None and "taa.history" in outputs:
            self.taa.feedback(outputs["taa.history"])
        if self.post is not None and "post.ae" in outputs:
            self.post.feedback(outputs["post.ae"])

    def render(self, context: RenderContext) -> None:
        from zenith_tpu_torch.rhi import TextureDesc

        width, height = context.extent
        if width == 0 or height == 0:
            return
        builder = context.builder()
        out = builder.import_resource(context.swapchain_texture())
        # The ordered chain of passes after the scene render (scene.py:
        # 1058-1173): SSR, fog, TAA, motion blur, DoF, each (name, stage,
        # exports its output); the flare adds in place after SSR and fog,
        # before TAA, then post, then the HUD over the LDR frame.
        chain = []
        if self.ssr is not None:
            chain.append(("ssr", lambda src, dst: self.ssr.render_to(
                builder, src, dst, self.camera, self.renderer.gbuffer_handles), False))
        if self.fog is not None:
            chain.append(("fog", lambda src, dst: self.fog.render_to(
                builder, src, dst, self.camera, self.renderer.gbuffer_handles,
                sun=self.renderer.scene.sun), False))
        if self.taa is not None:
            def taa_stage(src, dst):
                self.taa.render_to(builder, src, dst, self.camera, width, height,
                                   self.renderer.gbuffer_handles)
                context.request_output("taa.history", dst)
            chain.append(("taa", taa_stage, True))
        if self.mblur is not None:
            chain.append(("mblur", lambda src, dst: self.mblur.render_to(
                builder, src, dst, self.camera, self.renderer.gbuffer_handles), False))
        if self.dof is not None:
            chain.append(("dof", lambda src, dst: self.dof.render_to(
                builder, src, dst, self.renderer.gbuffer_handles), False))
        target = out
        if chain or self.post is not None:
            target = builder.create(TextureDesc.color("scene.hdr", width, height, Format.RGBA32F))
        if self.mode == "deferred":
            self.renderer.render_to(builder, target, self.camera, width, height)
            if self.use_pick:
                context.request_output("object_id", self.renderer.id_resource)
        else:
            depth = builder.create(TextureDesc.depth("scene.depth", width, height))
            self.renderer.render_to(builder, target, depth, self.camera)
        if self.psys is not None:
            state_h, pos_h = self.psys.sim_to(builder, self._dt)
            context.request_output("psys.state", state_h)
            context.request_output("psys.pos", pos_h)
        flare_after = sum(1 for name, _, _ in chain if name in ("ssr", "fog"))
        for i, (name, render_stage, exports) in enumerate(chain):
            if i == flare_after:
                self._flare(builder, target)
            # A stage that exports its output writes the swapchain only when
            # nothing composites onto it afterwards.
            last_writer = (i == len(chain) - 1 and self.post is None
                           and not (exports and self.hud is not None))
            dst = out if last_writer else builder.create(
                TextureDesc.color(f"scene.{name}", width, height, Format.RGBA32F))
            render_stage(target, dst)
            target = dst
        if flare_after == len(chain):
            self._flare(builder, target)
        if self.post is not None:
            self.post.render_to(builder, target, out)
            target = out
            if self.post.exposure_out is not None:
                context.request_output("post.ae", self.post.exposure_out)
        if self.hud is not None:
            # Over the final LDR image; it bridges a stage's private output
            # to the swapchain.
            self.hud.render_to(builder, out, source=target if target is not out else None)

    def _flare(self, builder, target) -> None:
        """The lens flare, in place on the HDR ``target``."""
        if self.flare is None:
            return
        for k, v in self.flare.sun_dynamics(self.camera, self._sun_dir).items():
            builder.set_dynamic(k, v)
        self.flare.render_to(builder, target, sun_color=(1.0, 0.92, 0.8))


def main() -> None:
    """``python -m zenith_tpu_torch.sandbox.scene [--frames N] [--out PNG]
    [--width W] [--height H] -- [SceneApp flags]`` on the card."""
    import argparse

    from zenith_tpu_torch.launch import launch
    from zenith_tpu_torch.window import Window

    parser = argparse.ArgumentParser("zenith-sandbox scene")
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--readback-interval", type=int, default=1)
    parser.add_argument(
        "--serve", type=int, nargs="?", const=8089, default=None,
        metavar="PORT",
        help="interactive browser viewer on PORT (default 8089); "
        "runs until closed unless --frames is also given",
    )
    parser.add_argument("--fps-cap", type=float, default=60.0,
                        help="frame pacing for --serve")
    known, rest = parser.parse_known_args()
    os.environ.setdefault("ZENITH_READBACK_INTERVAL", str(known.readback_interval))

    window = Window(width=known.width, height=known.height, title="scene")
    loop = launch(SceneApp, argv=rest, window=window,
                  max_frames=None if known.serve is not None else known.frames,
                  serve=known.serve, fps_cap=known.fps_cap, device="cuda")
    if known.out and window.last_frame is not None:
        window.write_png(known.out, window.last_frame)
        print(f"wrote {known.out}")
    print(f"rendered {loop.frames_rendered} frames")


if __name__ == "__main__":
    main()
