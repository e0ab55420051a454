"""The sandbox scene (BASELINE.md config #5) as the reference builds it:
the baked cerberus mesh, read from its raw file, on the 400-unit ground
with 100 point lights, the sun's 1024² shadow map over a 90-unit extent
and a 64² procedural sky cube; ``--gun-instances N`` draws the mesh as N
instanced copies on a ring and ``--instances N`` adds a ring of 9-unit
rocks; ``--ibl`` lights it with the sky's split-sum environment, and
``--fxaa``, ``--grade``, ``--film`` and ``--auto-exposure`` add the post
stages with the app's settings. The lights and rocks are drawn from ``default_rng(42)``, the
scene's own fixed stream. The camera orbits at radius 170 and height 25,
its phase advanced by 0.4 rad/s of frame time."""

from __future__ import annotations

import argparse
import math

import numpy as np

from reference.camera import Camera
from reference.deferred import Obj, Scene, Sun

MESH_FILE = "cache/mesh/cerberus/scene_0_0.mesh"
YUP_TO_ZUP = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64)
ORBIT_SPEED = 0.4


def parse(argv: "list[str]") -> argparse.Namespace:
    """The flags this reference renders; any other flag is refused, so a
    cell never runs against a reference that ignores part of its frame."""
    p = argparse.ArgumentParser("sandbox-reference")
    p.add_argument("--mode", choices=["deferred"], default="deferred")
    p.add_argument("--lights", type=int, default=100)
    p.add_argument("--gun-instances", type=int, default=0)
    p.add_argument("--instances", type=int, default=0)
    p.add_argument("--ibl", action="store_true")
    p.add_argument("--fxaa", action="store_true")
    p.add_argument("--grade", action="store_true")
    p.add_argument("--film", action="store_true")
    p.add_argument("--auto-exposure", action="store_true")
    return p.parse_args(argv)


def sky_cube(size: int = 64) -> np.ndarray:
    """(6, S, S, 4) linear radiance: a zenith-to-horizon gradient, a dark
    ground below the horizon and a warm sun glow; faces +X -X +Y -Y +Z -Z."""
    u = (np.arange(size, dtype=np.float32) + 0.5) / size * 2 - 1
    uu, vv = np.meshgrid(u, u)
    ones = np.ones_like(uu)
    dirs = [np.stack([ones, -vv, -uu], -1), np.stack([-ones, -vv, uu], -1),
            np.stack([uu, ones, vv], -1), np.stack([uu, -ones, -vv], -1),
            np.stack([uu, -vv, ones], -1), np.stack([-uu, -vv, -ones], -1)]
    sun = np.array([0.35, -0.3, 0.88], np.float32)
    sun /= np.linalg.norm(sun)
    zenith = np.array([0.18, 0.32, 0.62], np.float32)
    horizon = np.array([0.55, 0.62, 0.75], np.float32)
    below = np.array([0.12, 0.11, 0.10], np.float32)
    faces = []
    for d in dirs:
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        up = np.clip(d[..., 2:3], 0.0, 1.0)
        col = np.where(d[..., 2:3] >= 0.0, horizon + (zenith - horizon) * np.sqrt(up), below)
        glow = np.clip(np.sum(d * sun, axis=-1, keepdims=True), 0, 1) ** 64
        col = col + glow * np.array([3.0, 2.6, 2.0], np.float32)
        faces.append(np.concatenate([col, np.ones_like(up)], -1).astype(np.float32))
    return np.stack(faces)


def _quad(size: float, z: float):
    s = size * 0.5
    v = np.array([[-s, -s, z, 0, 0, 1, 0, 0], [s, -s, z, 0, 0, 1, 1, 0],
                  [s, s, z, 0, 0, 1, 1, 1], [-s, s, z, 0, 0, 1, 0, 1]], np.float32)
    return v, np.array([[0, 1, 2], [0, 2, 3]], np.int64)


def _cube(size: float, z0: float):
    s = size * 0.5
    cz = z0 + s
    faces = [((0, 0, 1), [(-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]),
             ((0, 0, -1), [(-s, s, -s), (s, s, -s), (s, -s, -s), (-s, -s, -s)]),
             ((1, 0, 0), [(s, -s, -s), (s, s, -s), (s, s, s), (s, -s, s)]),
             ((-1, 0, 0), [(-s, s, -s), (-s, -s, -s), (-s, -s, s), (-s, s, s)]),
             ((0, 1, 0), [(s, s, -s), (-s, s, -s), (-s, s, s), (s, s, s)]),
             ((0, -1, 0), [(-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s)])]
    verts, idx = [], []
    for n, corners in faces:
        b = len(verts)
        for (x, y, z), (u, v) in zip(corners, [(0, 0), (1, 0), (1, 1), (0, 1)]):
            verts.append([x, y, z + cz, *n, u, v])
        idx += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
    return np.asarray(verts, np.float32), np.asarray(idx, np.int64)


def build(argv: "list[str]", inputs: dict) -> Scene:
    ns = parse(argv)
    with np.load(MESH_FILE, allow_pickle=False) as data:
        vertices = data["vertices"].astype(np.float32)
        tris = data["indices"].astype(np.int64).reshape(-1, 3)
    bmin = vertices[:, :3].min(0).astype(np.float64)
    bmax = vertices[:, :3].max(0).astype(np.float64)
    t = np.eye(4)
    t[:3, 3] = -0.5 * (bmin + bmax)
    model = (YUP_TO_ZUP @ t).astype(np.float32)
    corners = np.stack(np.meshgrid(*zip(bmin, bmax), indexing="ij"), -1).reshape(-1, 3)
    z_min = min(float((model.astype(np.float64) @ np.append(c, 1.0))[2]) for c in corners)
    span = float(np.linalg.norm(bmax - bmin))
    rng = np.random.default_rng(42)

    offsets = None
    if ns.gun_instances > 0:
        ring = span * 1.1
        offs = [[0.0, 0.0, 0.0]]
        for i in range(1, ns.gun_instances):
            a = 2 * math.pi * i / ns.gun_instances
            r = ring * (1.0 + 0.15 * ((i * 7) % 3))
            offs.append([r * math.cos(a), r * math.sin(a), 2.0 * ((i * 5) % 4)])
        offsets = np.asarray(offs, np.float32)
    gun = Obj(vertices, tris, model, (0.62, 0.57, 0.55), 0.85, 0.45, offsets=offsets)
    gv, gt = _quad(400.0, z_min - 2.0)
    ground = Obj(gv, gt, np.eye(4, dtype=np.float32), (0.28, 0.3, 0.33), 0.0, 0.9)

    lights = []
    radius_xy = span * 0.7
    for i in range(ns.lights):
        ang = 2 * math.pi * i / max(ns.lights, 1)
        r = radius_xy * (0.4 + 0.6 * rng.uniform())
        hue = rng.uniform(0, 1)
        col = np.array([abs(math.sin(hue * math.pi * 2)),
                        abs(math.sin((hue + 1 / 3) * math.pi * 2)),
                        abs(math.sin((hue + 2 / 3) * math.pi * 2))], np.float32)
        z = z_min + 4.0 + 20.0 * rng.uniform()
        intensity = 400.0 + 600.0 * rng.uniform()
        lights.append([r * math.cos(ang), r * math.sin(ang), z, 60.0,
                       *(col * np.float32(intensity))])
    objects = [gun, ground]
    if ns.instances > 0:
        ring = span * 0.9
        offs = []
        for i in range(ns.instances):
            a = 2 * math.pi * i / ns.instances + 0.35
            r = ring * (0.8 + 0.5 * rng.uniform())
            offs.append([r * math.cos(a), r * math.sin(a), z_min - 2.0])
        cv, ct = _cube(9.0, 0.0)
        objects.append(Obj(cv, ct, np.eye(4, dtype=np.float32), (0.35, 0.33, 0.3), 0.0, 0.85,
                           offsets=np.asarray(offs, np.float32)))
    post = {"fxaa": ns.fxaa, "auto_exposure": ns.auto_exposure}
    if ns.grade:
        # exposure_ev, contrast, saturation, temperature, tint, vignette.
        post["grade"] = [0.15, 1.08, 1.12, 0.35, -0.05, 0.45, 0.0]
    if ns.film:
        post["film"] = {"chromatic_aberration": 2.5, "sharpen": 0.4, "grain": 0.035,
                        "grain_response": 0.8}
    return Scene(
        objects=objects,
        sun=Sun(direction=(0.35, -0.3, 0.88), intensity=2.5, map_size=1024, extent=90.0),
        ambient=(0.02, 0.02, 0.03),
        lights=np.asarray(lights, np.float32).reshape(-1, 7),
        # With --ibl the sky lights the scene (SH diffuse, a 5-level GGX
        # prefilter of 64 samples) and is the background.
        sky_cube=None if ns.ibl else sky_cube(64),
        environment=sky_cube(64) if ns.ibl else None,
        fov_y_deg=35.0,
        post=post,
    )


def camera(argv: "list[str]", inputs: dict, frame: int) -> Camera:
    """The camera of frame ``frame`` (0-based): the orbit phase starts at
    ``inputs["orbit_start"]`` and every frame first advances it by one
    fixed ``dt`` of 0.4 rad/s, summed as the app sums it."""
    orbit = float(inputs["orbit_start"])
    for _ in range(frame + 1):
        orbit += inputs["dt"] * ORBIT_SPEED
    radius, height = 170.0, 25.0
    pos = [math.sin(orbit) * radius, -math.cos(orbit) * radius, height]
    pitch = -math.atan2(height - 5.0, radius)
    return Camera(pos, orbit, pitch, 35.0, inputs["width"] / max(inputs["height"], 1))
