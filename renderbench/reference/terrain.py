"""The terrain flyover as the reference builds it: an fbm value-noise
heightmap (its lattice drawn from the terrain seed) as one grid mesh of
2(N-1)² triangles, a height- and slope-coloured sRGB albedo whose linear
values sit in a one-cell atlas with a box-filtered mip chain, the sun's
2048² shadow map, the procedural atmosphere, bloom + ACES. The camera
orbits at 0.55 of the extent, 1.6 × the height scale up, pitched down by
0.28 rad, its phase advanced by 0.1 rad/s of frame time."""

from __future__ import annotations

import argparse
import math

import numpy as np

from reference.camera import Camera
from reference.deferred import Obj, Scene, Sun

ORBIT_SPEED = 0.1


def parse(argv: "list[str]") -> argparse.Namespace:
    p = argparse.ArgumentParser("terrain-reference")
    p.add_argument("--grid", type=int, default=768)
    p.add_argument("--extent", type=float, default=400.0)
    p.add_argument("--zscale", type=float, default=70.0)
    p.add_argument("--seed", type=int, default=7)
    return p.parse_args(argv)


def fbm_heightmap(n: int, seed: int, octaves: int = 6) -> np.ndarray:
    """(n, n) fractal value noise in [0, 1]: smoothstep-interpolated
    lattices of doubling frequency and halving amplitude, normalised, then
    raised to the power 1.6."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, n), np.float64)
    amp, freq, total = 1.0, 4, 0.0
    for _ in range(octaves):
        g = rng.random((freq + 1, freq + 1))
        t = np.linspace(0.0, freq, n, endpoint=False)
        i = np.minimum(t.astype(np.int64), freq - 1)
        f = t - i
        f = f * f * (3.0 - 2.0 * f)
        gy0 = g[i, :][:, i] * (1 - f[:, None]) + g[i + 1, :][:, i] * f[:, None]
        gy1 = g[i, :][:, i + 1] * (1 - f[:, None]) + g[i + 1, :][:, i + 1] * f[:, None]
        out += amp * (gy0 * (1 - f[None, :]) + gy1 * f[None, :])
        total += amp
        amp *= 0.5
        freq *= 2
    return ((out / total) ** 1.6).astype(np.float32)


def grid_mesh(height: np.ndarray, extent: float, zscale: float):
    """(V, 8) vertices (position, central-difference normal, uv) and
    (T, 3) triangles of the heightmap grid."""
    n = height.shape[0]
    xs = np.linspace(-extent, extent, n, dtype=np.float32)
    px, py = np.meshgrid(xs, xs, indexing="xy")
    z = height * zscale
    cell = 2.0 * extent / (n - 1)
    nrm = np.stack([-np.gradient(z, cell, axis=1), -np.gradient(z, cell, axis=0),
                    np.ones_like(z)], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    uv = np.stack(np.meshgrid(np.linspace(0, 1, n, dtype=np.float32),
                              np.linspace(0, 1, n, dtype=np.float32), indexing="xy"), -1)
    verts = np.concatenate([np.stack([px, py, z], -1), nrm.astype(np.float32), uv],
                           -1).reshape(-1, 8).astype(np.float32)
    idx = np.arange(n * n, dtype=np.int64).reshape(n, n)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    return verts, np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)])


def albedo_u8(height: np.ndarray, zscale: float, size: int = 1024) -> np.ndarray:
    """(size, size, 4) sRGB uint8: grass on low flats, rock on slopes, snow
    above the snowline, with a fixed texel variation."""
    n = height.shape[0]
    ii = np.minimum((np.arange(size) * n) // size, n - 1)
    h = height[ii, :][:, ii]
    gy, gx = np.gradient(h * zscale)
    slope = np.sqrt(gx * gx + gy * gy)
    grass, rock = np.array([0.20, 0.34, 0.12]), np.array([0.38, 0.33, 0.30])
    snow = np.array([0.92, 0.93, 0.95])
    steep = np.clip(slope * 6.0, 0.0, 1.0)[..., None]
    high = np.clip((h - 0.55) * 8.0, 0.0, 1.0)[..., None]
    col = grass * (1 - steep) + rock * steep
    col = col * (1 - high) + snow * high * (1 - steep * 0.6)
    col *= (0.92 + 0.16 * np.random.default_rng(3).random((size, size, 1)))
    rgba = np.concatenate([np.clip(col, 0, 1), np.ones((size, size, 1))], -1)
    return (rgba * 255).astype(np.uint8)


def srgb_decode(u8: np.ndarray) -> np.ndarray:
    x = u8.astype(np.float32) / 255.0
    rgb = np.clip(x[..., :3], 0.0, 1.0)
    rgb = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    return np.concatenate([rgb.astype(np.float32), x[..., 3:]], -1).astype(np.float32)


def atlas_levels(linear: np.ndarray):
    """One texture alone in a power-of-two atlas cell: its levels (box
    filtered, down to a quarter of the cell's bit length) and its uv
    transform with the half-texel inset."""
    h, w = linear.shape[:2]
    levels = [linear.astype(np.float32)]
    cur = levels[0]
    for _ in range(max(1, min(w, h).bit_length() - 2) - 1):
        hh, ww = cur.shape[0] // 2, cur.shape[1] // 2
        cur = cur[:hh * 2, :ww * 2].reshape(hh, 2, ww, 2, 4).mean(axis=(1, 3))
        levels.append(np.ascontiguousarray(cur, np.float32))
    return levels, ((w - 1) / w, (h - 1) / h, 0.5 / w, 0.5 / h)


def build(argv: "list[str]", inputs: dict) -> Scene:
    ns = parse(argv)
    height = fbm_heightmap(ns.grid, seed=ns.seed)
    verts, tris = grid_mesh(height, ns.extent, ns.zscale)
    levels, uvx = atlas_levels(srgb_decode(albedo_u8(height, ns.zscale)))
    terrain = Obj(verts, tris, np.eye(4, dtype=np.float32), (1.0, 1.0, 1.0), 0.0, 0.9,
                  levels=levels, uv_transform=uvx)
    return Scene(
        objects=[terrain],
        sun=Sun(direction=(0.45, -0.35, 0.55), intensity=3.0, map_size=2048,
                extent=ns.extent * 1.2, far=1200.0),
        ambient=(0.03, 0.03, 0.04),
        lights=np.zeros((0, 7), np.float32),
        atmosphere=True,
        fov_y_deg=45.0,
    )


def camera(argv: "list[str]", inputs: dict, frame: int) -> Camera:
    ns = parse(argv)
    orbit = float(inputs["orbit_start"])
    for _ in range(frame + 1):
        orbit += ORBIT_SPEED * inputs["dt"]
    r = ns.extent * 0.55
    pos = [math.sin(orbit) * r, -math.cos(orbit) * r, ns.zscale * 1.6]
    return Camera(pos, orbit, -0.28, 45.0, inputs["width"] / max(inputs["height"], 1))
