#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (zenith_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the zenith_tpu package, and fails (exit code
other than 0, no result line) on the first phase that fails:

1. device and build: checks the card, prints its name and power limit, and
   builds every kernel from zenith_tpu_torch/csrc/ (timed);
2. K1 against its plain PyTorch version, on the card: at the triangle demo's
   own 1920x1080 inputs and on a numpy-seeded 1080p stress draw (tens of
   thousands of triangles, tiles with more than one block of entries,
   mid- and huge-span records, near-clipped triangles, exact equal-z ties)
   for all eight depth compares. z, coverage and the attribute planes must
   be bit-equal; the card's binning must equal the CPU binning, overflow
   count included. Both versions are timed with CUDA events (median);
3. the golden frame: the triangle graph of tests/test_golden.py rendered on
   the card must match tests/golden/triangle_128x32_t1_25.npy (<= 1 LSB,
   < 1% of pixels differing);
4. the triangle's main path: the triangle app through zenith_tpu_torch.launch
   at 1920x1080 for 120 frames, on the rebuild and the auto-retained paths.
   K1 must launch at least once per frame, the last frame must equal the
   frame rendered on the card through the plain raster at the same time, and
   a retained run of the frame function must make no host sync;
5. K2 against its plain PyTorch version on the card, on the 1080p G-buffer
   of phase 7's scene with its 100 point lights, with a mixed point/spot
   table and with a table of spots with hard and narrow cone edges (atol
   2e-4 / rtol 2e-3), with the counts of hit (tile, light) pairs and of lit
   (light, pixel) pairs; K1 bit-equal to its plain version on that frame's
   shadow and G-buffer passes. Both kernels (each K1 pass) and their plain
   versions are timed (CUDA events, median) and set beside their bound on
   the H100, which counts the work these inputs need (K1's fragments, K2's
   lit pairs);
6. the deferred golden: tests/test_golden.py's scene (8 point lights, a 16²
   sky cube, 128x64, 8x128 tiles) rendered through the port on the card
   must match tests/golden/deferred_scene_128x64.npy (<= 1 LSB, < 1% of
   values differing);
7. the deferred main path: bench.py::bench_scene's frame function (rebuild →
   DeferredRenderer.render_to → PostProcess → PresentEncode(BGRA8_SRGB),
   camera orbit at radius 170, fov 35°) at 1920x1080 for 120 frames, on
   zenith_tpu/sandbox/scene.py::build_scene's settings with the cerberus
   mesh replaced by a procedural stand-in of its size
   (zenith_tpu_torch/sandbox/scene.py::build_standin_scene). Each
   frame must run K1 at least twice (shadow, G-buffer) and K2 at least once,
   with no bin overflow; the last frame must match the same frame through
   both plain versions (<= 1 LSB, < 1% of values); a retained frame must
   make no host sync. It prints FPS, frame time p50/p99, and from
   torch.profiler the kernel launches, device time (per render-graph node)
   and device-busy share per frame.

The line before the last is a JSON object listing each kernel of the main
paths with its launches there, its largest difference from the plain
version, its time, the plain version's, its bound and what bounds it; the
last line is the device record.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent
W, H = 1920, 1080
FRAMES = 120
DEFERRED_FRAMES = 120
PROFILED_FRAMES = 10


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def stress_scene(seed: int = 7):
    """A 1080p stress draw: (clip (Nv, 4), indices (T, 3), colors (Nv, 3))."""
    rng = np.random.default_rng(seed)

    def tris(n, centre_lo, centre_hi, size_px):
        c = rng.uniform(centre_lo, centre_hi, (n, 1, 2))
        off = rng.uniform(-1.0, 1.0, (n, 3, 2)) * (np.asarray(size_px)[..., None, None] / [W, H])
        return (c + off).reshape(-1, 2)

    parts = [
        tris(22000, -1.0, 1.0, rng.uniform(3, 24, 22000)),  # small: 1-4 tiles
        tris(6000, [-0.9, -0.9], [-0.8, -0.8], np.full(6000, 4.0)),  # crowded tiles
        tris(1500, -0.8, 0.8, rng.uniform(300, 900, 1500)),  # mid span
        tris(120, -0.2, 0.2, np.full(120, 5000.0)),  # huge span
    ]
    xy = np.concatenate(parts)
    nv = xy.shape[0]
    w = rng.uniform(0.5, 2.0, (nv, 1))
    z = rng.uniform(0.02, 0.98, (nv, 1))
    # Near-clipped: 300 triangles with one or two corners beyond the near
    # plane (z > w), which setup clips into one or two triangles.
    clipped = rng.choice(nv // 3, 300, replace=False) * 3
    z[clipped] = rng.uniform(1.1, 3.0, (300, 1))
    z[clipped[:150] + 1] = rng.uniform(1.1, 3.0, (150, 1))
    clip = np.concatenate([xy * w, z * w, w], axis=1).astype(np.float32)
    idx = np.arange(nv, dtype=np.int64).reshape(-1, 3)
    # Exact duplicates submitted later: equal-z ties that order decides.
    dup = idx[rng.choice(idx.shape[0], 2000, replace=False)]
    idx = np.concatenate([idx, dup]).astype(np.int32)
    colors = rng.uniform(0.0, 1.0, (nv, 3)).astype(np.float32)
    return clip, idx, colors


def lsb_diff(a: np.ndarray, b: np.ndarray) -> "tuple[int, float]":
    """(max |a - b| in LSB, share of channel values that differ)."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


# Published H100 SXM peaks (NVIDIA's data sheet) used for the bounds:
# device memory 3.35 TB/s, fp32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# fp32 operations K1 needs per fragment (an entry's pixel inside its
# triangle and depth range): three edge functions (12), the top-left tests
# (6), barycentrics (3), depth (5), range and depth compares (3); and per
# covered output pixel, the winner's a_n attribute planes (5 each). K2 per
# lit (light, pixel) pair, a covered pixel closer to the light than its
# radius: the light vector and window (~25), the GGX BRDF (~60), the cone
# (~14) and the weighted sum (~29). Counted from csrc/raster.cu and
# csrc/lighting.cu. Work that yields nothing (pixels outside the triangle,
# uncovered or out of range) is not counted: the bound is what these inputs
# need, not what the tiling makes the kernels do.
K1_OPS_PER_FRAGMENT = 29
K1_OPS_PER_PIXEL_PLANE = 5
K2_OPS_PER_LIT_PAIR = 128


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(spans):
        if cur_e is None or a > cur_e:
            total += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def bound(nbytes: float, ops: float) -> "tuple[float, str]":
    """(least time in ms, what bounds it): the larger of bytes over the
    memory rate and operations over the fp32 peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_fragments(bins, grid, sample_offset=(0.5, 0.5), chunk: int = 4096) -> int:
    """The fragments of these bins: over every entry, the image pixels of its
    tile that its triangle covers (edge functions with the top-left rule, as
    K1 evaluates them) inside the depth range [0, 1]. Tensor ops on the bins'
    device, ``chunk`` entries at a time."""
    import torch

    rows = bins.rast_pad
    dev = rows.device
    nb = bins.blk_count.shape[0]
    per = rows.shape[0] // max(nb, 1)
    lane = torch.arange(per, device=dev)
    live = lane[None, :] < bins.blk_count.to(torch.int64)[:, None]
    ent_row = (torch.arange(nb, device=dev)[:, None] * per + lane[None, :])[live]
    ent_ty = bins.blk_tile_y.to(torch.int64)[:, None].expand(nb, per)[live]
    ent_tx = bins.blk_tile_x.to(torch.int64)[:, None].expand(nb, per)[live]
    th, tw = grid.tile_h, grid.tile_w
    col = torch.arange(tw, device=dev)[None, None, :]
    row = torch.arange(th, device=dev)[None, :, None]
    total = 0
    for s in range(0, ent_row.shape[0], chunk):
        c = rows[ent_row[s:s + chunk], :16][:, :, None, None]
        px = ent_tx[s:s + chunk, None, None] * tw + col
        py = ent_ty[s:s + chunk, None, None] * th + row
        x = px.to(torch.float32) + sample_offset[0]
        y = py.to(torch.float32) + sample_offset[1]
        e01 = c[:, 0] * x + c[:, 1] * y + c[:, 2]
        e12 = c[:, 3] * x + c[:, 4] * y + c[:, 5]
        e20 = c[:, 6] * x + c[:, 7] * y + c[:, 8]
        cov = (((e01 > 0) | ((e01 == 0) & (c[:, 9] > 0)))
               & ((e12 > 0) | ((e12 == 0) & (c[:, 10] > 0)))
               & ((e20 > 0) | ((e20 == 0) & (c[:, 11] > 0))))
        z = (e12 * c[:, 12]) * c[:, 13] + (e20 * c[:, 12]) * c[:, 14] + (e01 * c[:, 12]) * c[:, 15]
        cov = cov & (z >= 0) & (z <= 1) & (px < grid.width) & (py < grid.height)
        total += int(cov.sum())
    return total


def k1_bound(bins, grid, covered_px: int) -> "tuple[float, str, int]":
    """K1's bound on these bins: rows, routing tables and the z plane read
    once; z and the a_n attribute planes written once; the edge and depth
    work of each fragment, and the winner's attributes at each of the
    ``covered_px`` pixels the pass covers. Returns (ms, what bounds it,
    fragments)."""
    a_n = (bins.rast_pad.shape[1] - 16) // 3
    hp, wp = grid.tiles_y * grid.tile_h, grid.tiles_x * grid.tile_w
    nb = bins.blk_count.shape[0]
    nbytes = 4 * (bins.rast_pad.numel() + 4 * nb + hp * wp + hp * wp + a_n * hp * wp)
    frags = k1_fragments(bins, grid)
    ops = frags * K1_OPS_PER_FRAGMENT + covered_px * a_n * K1_OPS_PER_PIXEL_PLANE
    return (*bound(nbytes, ops), frags)


def k2_lit_pairs(depth, pos_emissive, lights, chunk: int = 8) -> int:
    """The (light, pixel) pairs these inputs light: covered pixels (depth > 0)
    closer to the light than its radius, where the window is not 0."""
    p = pos_emissive[..., :3][depth > 0]  # (N, 3)
    total = 0
    for s in range(0, lights.shape[0], chunk):
        lt = lights[s:s + chunk]
        d2 = ((p[None] - lt[:, None, :3]) ** 2).sum(-1)
        total += int((d2 < (lt[:, 3:4] ** 2)).sum())
    return total


def cone_edge_pixels(bad, pos_emissive, lights, limit: int = 65536) -> int:
    """How many of the (first ``limit``) pixels in ``bad`` lie within a
    spot's radius and inside its cone's edge (0 < t < 1), where the cone
    factor moves fastest with the light direction."""
    p = pos_emissive[..., :3][bad][:limit]  # (N, 3)
    v = lights[None, :, :3] - p[:, None, :]  # (N, L, 3)
    d2 = (v * v).sum(-1)
    cosang = -(v * lights[None, :, 8:11]).sum(-1) / d2.sqrt()
    t = (cosang - lights[None, :, 11]) * lights[None, :, 12]
    edge = (t > 0) & (t < 1) & (lights[None, :, 7] > 0) & (d2 < lights[None, :, 3] ** 2)
    return int(edge.any(1).sum())


def k2_bound(h: int, w: int, num_lights: int, lit_pairs: int) -> "tuple[float, str]":
    """K2's bound: three (H, W, 4) planes, the depth and the light table
    read once, the (H, W, 3) output written once; the BRDF work of each lit
    (light, pixel) pair."""
    nbytes = 4 * (3 * 4 * h * w + h * w + 16 * num_lights + 3 * h * w)
    return bound(nbytes, lit_pairs * K2_OPS_PER_LIT_PAIR)


def deferred_phases(dev, card: str, plain_k1) -> dict:
    """Phases 5-7: K2 against its plain version, the deferred golden, and
    the deferred main path at 1920x1080. Returns the kernel records."""
    import torch

    from zenith_tpu_torch.core import profile
    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree
    from zenith_tpu_torch.ops import draw as draw_mod
    from zenith_tpu_torch.ops import lighting as lighting_mod
    from zenith_tpu_torch.ops import raster as raster_mod
    from zenith_tpu_torch.ops.lighting import accumulate_point_lights, light_table
    from zenith_tpu_torch.ops.raster import raster_segmented
    from zenith_tpu_torch.rendergraph import CompileOptions
    from zenith_tpu_torch.renderer import DeferredRenderer
    from zenith_tpu_torch.rhi import Format, PipelineCache, RhiCore, encode_present
    from zenith_tpu_torch.sandbox.scene import (
        GOLDEN_H,
        GOLDEN_W,
        build_standin_scene,
        deferred_frame,
        golden_scene,
        orbit_camera,
    )

    device = RhiCore(dev).create_render_device()

    def plain_k2(am, nr, pe, depth, cam, lights, tile_h, tile_w):
        return lighting_mod._accumulate_point_lights_torch(am, nr, pe, depth, cam, lights,
                                                           tile_h, tile_w)

    # -- the sandbox scene at 1080p (phases 5 and 7) -------------------------
    scene, mesh = build_standin_scene(device, 100, np.random.default_rng(42))
    renderer = DeferredRenderer(scene)
    camera = Camera(fov_y=Degree(35.0), aspect_ratio=W / H)
    options = CompileOptions()  # 32x128 tiles, as bench.py uses
    print(f"phase 5: scene: stand-in mesh {mesh.num_triangles} triangles, "
          f"{mesh.num_vertices} vertices + ground; {len(scene.point_lights)} point lights; "
          f"sun shadow map {scene.sun.shadow_map_size}^2; sky cube 64^2")

    # One frame whose G-buffer is kept; K1's inputs are recorded on the way.
    k1_calls = []
    real_raster = draw_mod.raster_segmented

    def recording_raster(bins, grid, init_z, **kw):
        k1_calls.append((bins, grid, init_z.clone(), kw))
        return real_raster(bins, grid, init_z, **kw)

    orbit_camera(camera, 0.3)
    with mock.patch.object(draw_mod, "raster_segmented", recording_raster):
        compiled, _, hdr, _ = deferred_frame(device, renderer, camera, W, H, options,
                                             exports=("albedo", "normal", "pos", "depth"))
    g = {k: compiled.value(renderer.gbuffer_handles[k]) for k in ("albedo", "normal", "pos", "depth")}
    torch.cuda.synchronize()
    check(len(k1_calls) == 2, f"the 1080p frame ran K1 {len(k1_calls)} times, not 2 (shadow, gbuffer)")
    covered_px = int((g["depth"] > 0).sum())
    check(covered_px > W * H // 8, f"the scene covers only {covered_px} of {W * H} pixels")

    # K1 at the deferred path's own inputs: bit-equal, each pass timed.
    k1_err, k1_pass = 0.0, {}
    for (bins, grid, init_z, kw), label in zip(k1_calls, ("shadow", "gbuffer")):
        k = raster_segmented(bins, grid, init_z, **kw)
        with mock.patch.object(raster_mod, "_raster_segmented_cuda", plain_k1):
            p = raster_segmented(bins, grid, init_z, **kw)
        torch.cuda.synchronize()
        check(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]),
              f"K1 differs from its plain version on the {label} pass")
        k1_err = max(k1_err, (k[0] - p[0]).abs().max().item(), (k[1] - p[1]).abs().max().item())
        pass_cov = int((k[1][-1] > 0).sum())
        t_k = cuda_ms(lambda: raster_segmented(bins, grid, init_z, **kw), reps=20, warmup=2)
        with mock.patch.object(raster_mod, "_raster_segmented_cuda", plain_k1):
            t_p = cuda_ms(lambda: raster_segmented(bins, grid, init_z, **kw), reps=3)
        b_ms, b_by, frags = k1_bound(bins, grid, pass_cov)
        k1_pass[label] = (t_k, t_p, b_ms, b_by)
        print(f"phase 5: K1 {label} pass {grid.width}x{grid.height}: "
              f"{int(bins.blk_count.sum())} entries in {bins.blk_count.shape[0]} blocks, "
              f"{frags} fragments, {pass_cov} px covered, a_n {k[1].shape[0]}: bit-equal to "
              f"the plain version; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); no one-call PyTorch equivalent [{card}]")
    k1_ms, k1_plain_ms, k1_bound_ms, k1_bound_by = k1_pass["gbuffer"]

    # -- 5. K2 against its plain version on the 1080p G-buffer ----------------
    pl_pos, pl_col, pl_rad, _ = scene.light_partition()
    lp, lc, lr = (torch.from_numpy(a).to(dev) for a in (pl_pos, pl_col, pl_rad))
    n_l = lp.shape[0]
    cam_pos = torch.from_numpy(np.asarray(camera.location, np.float32)).to(dev)
    mixed = np.zeros((n_l, 5), np.float32)
    mixed[::2, :3] = (0.0, 0.0, -1.0)  # every other light a downward spot
    mixed[::2, 3], mixed[::2, 4] = np.cos(np.radians(18.0)), np.cos(np.radians(26.0))
    # Every light a spot aimed below the horizon, cycling through four cones
    # (inner, outer degrees): soft (15, 28); hard-edged (20, 20); inverted
    # (30, 20), which the table clamps to the same hard edge; narrow
    # (12, 12.5). A hard edge multiplies the rounding of the cone's cosine by
    # 1e4 (inv_cone = 1 / max(cos_inner - cos_outer, 1e-4)).
    rng = np.random.default_rng(5)
    d = rng.normal(size=(n_l, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    cones = np.radians([(15.0, 28.0), (20.0, 20.0), (30.0, 20.0), (12.0, 12.5)])
    hard = np.concatenate([d / np.linalg.norm(d, axis=1, keepdims=True),
                           np.cos(cones[np.arange(n_l) % 4])], axis=1).astype(np.float32)
    tables = (("points", None), ("mixed point/spot", mixed), ("hard-edged spots", hard))
    k2_err, k2 = 0.0, None
    tiles = -(-H // 16) * -(-W // 128)
    for label, sp in tables:
        sp = None if sp is None else torch.from_numpy(sp).to(dev)
        args = (g["albedo"], g["normal"], g["pos"], g["depth"], cam_pos, lp, lc, lr)
        out_k = accumulate_point_lights(*args, spot_params=sp)
        with mock.patch.object(lighting_mod, "_accumulate_point_lights_cuda", plain_k2):
            out_p = accumulate_point_lights(*args, spot_params=sp)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out_k).all()), f"K2 {label}: non-finite output")
        err = (out_k - out_p).abs()
        k2_err = max(k2_err, err.max().item())
        table = light_table(lp, lc, lr, sp)
        hits = int(lighting_mod.tile_light_hits(g["depth"], g["pos"], table).sum())
        lit = k2_lit_pairs(g["depth"], g["pos"], table)
        bad = ~torch.isclose(out_k, out_p, atol=2e-4, rtol=2e-3).all(-1)
        n_bad = int(bad.sum())
        print(f"phase 5: K2 {label} 1080p: {hits} hit (tile, light) pairs of {tiles} x "
              f"{n_l} = {tiles * n_l}, {lit} lit (light, pixel) pairs; max |kernel - plain| "
              f"{err.max().item():.3e} (max value {out_p.abs().max().item():.3f}); "
              f"{n_bad} pixels beyond atol 2e-4 / rtol 2e-3")
        if n_bad:
            edge = cone_edge_pixels(bad, g["pos"], table)
            fail(f"K2 {label}: {n_bad} pixels differ from the plain version beyond atol 2e-4 / "
                 f"rtol 2e-3, {edge} of them inside a spot's cone edge (0 < t < 1)")
        if sp is None:
            k_ms = cuda_ms(lambda: accumulate_point_lights(*args), reps=50, warmup=3)
            with mock.patch.object(lighting_mod, "_accumulate_point_lights_cuda", plain_k2):
                p_ms = cuda_ms(lambda: accumulate_point_lights(*args), reps=5)
            b_ms, b_by = k2_bound(H, W, n_l, lit)
            print(f"phase 5: K2 points 1080p: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}); no one-call PyTorch equivalent [{card}]")
            k2 = {"name": "K2 tiled point lights (_tiled_lights_kernel)", "route": "cuda",
                  "source": "zenith_tpu_torch/csrc/lighting.cu",
                  "replaces": "zenith_tpu/ops/lighting.py:71", "launches": 0,
                  "max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                  "bound_by": b_by, "library_ms": None}
    k2["max_abs_err"] = k2_err

    # -- 6. the deferred golden on the card ------------------------------------
    gscene, gcam = golden_scene(device)
    k1_before, k2_before = raster_segmented.launches, accumulate_point_lights.launches
    compiled, out, _, _ = deferred_frame(device, DeferredRenderer(gscene), gcam, GOLDEN_W,
                                         GOLDEN_H, CompileOptions(tile_h=8, tile_w=128))
    img = encode_present(compiled.value(out), Format.RGBA8_SRGB).cpu().numpy()
    check(raster_segmented.launches - k1_before == 2 and
          accumulate_point_lights.launches - k2_before == 1,
          "golden: the frame did not run K1 twice and K2 once")
    golden = np.load(REPO / "tests" / "golden" / "deferred_scene_128x64.npy")
    mx, frac = lsb_diff(img, golden)
    print(f"phase 6: deferred golden 128x64 (8 lights, 16^2 sky): max LSB diff {mx}, "
          f"{frac * 100:.3f}% values differ")
    check(mx <= 1 and frac < 0.01, "deferred golden frame drifted")

    # -- 7. the deferred main path at 1920x1080 ---------------------------------
    cache = PipelineCache()
    bgra = Format.BGRA8_SRGB

    def frame(orbit):
        orbit_camera(camera, orbit)
        return deferred_frame(device, renderer, camera, W, H, options, present_format=bgra,
                              pipeline_cache=cache)

    frame(0.0)  # warm-up (builds the frame function)
    torch.cuda.synchronize()
    raster_segmented.launches = 0
    accumulate_point_lights.launches = 0
    ends, overflows, per_frame = [], [], []
    t0 = time.perf_counter()
    for i in range(DEFERRED_FRAMES):
        k1_start, k2_start = raster_segmented.launches, accumulate_point_lights.launches
        compiled, enc, _, retired = frame(0.3 + i * 0.004)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        overflows.append(retired.bin_overflow)
        per_frame.append((raster_segmented.launches - k1_start,
                          accumulate_point_lights.launches - k2_start))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_launches, k2_launches = raster_segmented.launches, accumulate_point_lights.launches
    k2["launches"] = k2_launches
    check(all(a >= 2 and b >= 1 for a, b in per_frame),
          f"a frame ran K1 fewer than 2 or K2 fewer than 1 times: {sorted(set(per_frame))}")
    total_overflow = int(torch.stack(overflows).sum())
    check(total_overflow == 0, f"bin overflow {total_overflow} over {DEFERRED_FRAMES} frames")
    frame_ms = np.array([ends[i - 1].elapsed_time(ends[i]) for i in range(1, len(ends))])
    last = compiled.value(enc).cpu().numpy()
    check(last.shape == (H, W, 4) and last.dtype == np.uint8, f"frame is {last.shape} {last.dtype}")
    check(last[..., :3].std() > 1.0, "flat 1080p frame")
    print(f"phase 7: {DEFERRED_FRAMES} frames at {W}x{H}: {DEFERRED_FRAMES / wall:.2f} FPS; "
          f"frame time p50 {np.percentile(frame_ms, 50):.3f} ms, p99 "
          f"{np.percentile(frame_ms, 99):.3f} ms (CUDA events between frame ends); "
          f"K1 {k1_launches} and K2 {k2_launches} launches ({sorted(set(per_frame))} per "
          f"frame), bin overflow 0 [{card}]")

    # The last frame against the same frame through both plain versions.
    orbit_camera(camera, 0.3 + (DEFERRED_FRAMES - 1) * 0.004)
    with mock.patch.object(raster_mod, "_raster_segmented_cuda", plain_k1), \
            mock.patch.object(lighting_mod, "_accumulate_point_lights_cuda", plain_k2):
        pc, penc, _, _ = deferred_frame(device, renderer, camera, W, H, options,
                                        present_format=bgra, pipeline_cache=cache)
        ref = pc.value(penc).cpu().numpy()
    mx, frac = lsb_diff(last, ref)
    print(f"phase 7: last frame vs the plain-path frame: max LSB diff {mx}, "
          f"{frac * 100:.4f}% values differ")
    check(mx <= 1 and frac < 0.01, "the last frame differs from the plain-path frame")

    # The deferred frame function makes no host sync (CUDA-graph ready).
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        compiled.execute(device, dynamics=renderer.frame_dynamics(camera))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("phase 7: a retained deferred frame at 1080p made no host sync")

    # Where the time goes. Kernels only (little host slow-down): device time,
    # launches, the busy share and the heaviest kernels per frame. Then host
    # operators too, for each render-graph node's share of the kernel time.
    # A one-frame session first keeps the profiler's start-up out of both.
    nodes = ("shadow", "gbuffer", "lighting", "post", "present.encode")
    with profile.session(cpu=False):
        frame(0.3)
        torch.cuda.synchronize()
    for cpu in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile.session(cpu=cpu) as prof:
            for i in range(PROFILED_FRAMES):
                frame(0.3 + i * 0.004)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_FRAMES
        events = prof.events()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = {(e.time_range.start, e.time_range.end, e.name) for e in kernels}
        kernel_ms = sum(b - a for a, b, _ in spans) / 1e3 / PROFILED_FRAMES
        busy_ms = union_us([(a, b) for a, b, _ in spans]) / 1e3 / PROFILED_FRAMES
        line = (f"phase 7: profile ({'host operators + kernels' if cpu else 'kernels only'}) "
                f"of {PROFILED_FRAMES} frames: {len(spans) / PROFILED_FRAMES:.0f} kernel "
                f"launches, {kernel_ms:.3f} ms kernel time, device busy {busy_ms:.3f} ms = "
                f"{busy_ms / wall_ms * 100:.1f}% of {wall_ms:.2f} ms wall per frame; "
                f"unprofiled frame time p50 {np.percentile(frame_ms, 50):.3f} ms")
        if cpu:
            node_ms = {n: sum(e.device_time_total for e in events if e.name == n) / 1e3
                       / PROFILED_FRAMES for n in nodes}
            total = sum(node_ms.values()) or 1.0
            line += "; kernel time by node " + ", ".join(
                f"{n} {v:.3f} ms ({v / total * 100:.1f}%)" for n, v in node_ms.items())
        else:
            by_name = {}
            for a, b, name in spans:
                t, c = by_name.get(name, (0.0, 0))
                by_name[name] = (t + (b - a), c + 1)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
            line += "; heaviest kernels per frame: " + "; ".join(
                f"{name[:60]} {t / 1e3 / PROFILED_FRAMES:.3f} ms x{c / PROFILED_FRAMES:.0f}"
                for name, (t, c) in top)
        print(line + f" [{card}]")
    return {"k1": {"ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms,
                   "bound_by": k1_bound_by, "max_abs_err": k1_err},
            "k1_launches": k1_launches, "k2": k2}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a CUDA card")
    if not (REPO / "zenith_tpu_torch" / "csrc").is_dir():
        fail(f"{REPO} holds no zenith_tpu_torch package: run from a checkout")
    sys.path.insert(0, str(REPO))

    from zenith_tpu_torch.ops import raster as raster_mod
    from zenith_tpu_torch.ops import runtime
    from zenith_tpu_torch.ops.binning import TileGrid, bin_segmented
    from zenith_tpu_torch.ops.geometry import setup_with_attrs
    from zenith_tpu_torch.ops.raster import raster_segmented
    from zenith_tpu_torch.rhi.state import CompareOp, CullMode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 1. device and build --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi unavailable (rc {smi.returncode})"
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    fresh = not runtime.library_path().exists()
    t0 = time.perf_counter()
    so = runtime.build_kernels()
    runtime.load_kernels()
    print(f"phase 1: {'built' if fresh else 'reused'} {so.relative_to(REPO)} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc per source in parallel + link + load)")
    log_path = so.with_suffix(".log")
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    def plain(bins, grid, z, acc, compare, write, clamp, off):
        raster_mod._raster_segmented_torch(bins, grid, z, acc, compare, write, clamp, off)

    def both(bins, grid, init_z, **kw):
        """(kernel result, plain result) on the same inputs; the plain run
        does not go through the kernel counter."""
        k = raster_segmented(bins, grid, init_z, **kw)
        with mock.patch.object(raster_mod, "_raster_segmented_cuda", plain):
            p = raster_segmented(bins, grid, init_z, **kw)
        return k, p

    max_err = 0.0

    def compare_exact(k, p, what):
        nonlocal max_err
        (kz, kacc), (pz, pacc) = k, p
        torch.cuda.synchronize()
        check(torch.isfinite(kz).all().item() and torch.isfinite(kacc).all().item(),
              f"{what}: non-finite kernel output")
        err = max((kz - pz).abs().max().item(), (kacc - pacc).abs().max().item())
        max_err = max(max_err, err)
        check(torch.equal(kacc[-1] > 0, pacc[-1] > 0), f"{what}: coverage differs")
        check(torch.equal(kz, pz), f"{what}: z differs (max {err})")
        check(torch.equal(kacc, pacc), f"{what}: attribute planes differ (max {err})")
        return int((kacc[-1] > 0).sum().item())

    grid = TileGrid(W, H)  # 32 x 128 tiles, as the engine uses

    # -- 2a. K1 at the main path's own inputs: the demo triangle at 1080p -----
    from zenith_tpu_torch.renderer.triangle import _vs

    tri_vb = torch.tensor([[0.0, 0.5, 0.0, 1.0, 0.0, 0.0], [-0.5, -0.5, 0.0, 0.0, 1.0, 0.0],
                           [0.5, -0.5, 0.0, 0.0, 0.0, 1.0]], device=dev)
    vs_out = _vs({"position": tri_vb[:, :3], "color": tri_vb[:, 3:]}, None)
    rec, corner = setup_with_attrs(vs_out["position"], torch.tensor([[0, 1, 2]], device=dev),
                                   vs_out["color"], W, H, cull_mode=CullMode.NONE)
    tri_bins = bin_segmented(rec, corner, grid, entry_budget=None)
    z0 = torch.zeros((H, W), device=dev)
    demo = dict(depth_test=False, depth_write=False)  # the demo's pipeline state
    covered = compare_exact(*both(tri_bins, grid, z0, **demo), "demo triangle")
    check(covered > 100000, f"demo triangle covers only {covered} pixels")
    k_ms = cuda_ms(lambda: raster_segmented(tri_bins, grid, z0, **demo), reps=50, warmup=3)
    with mock.patch.object(raster_mod, "_raster_segmented_cuda", plain):
        p_ms = cuda_ms(lambda: raster_segmented(tri_bins, grid, z0, **demo), reps=10)
    print(f"phase 2a: K1 demo triangle 1080p ({tri_bins.blk_count.shape[0]} blocks, "
          f"{covered} px): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms [{card}]")

    # -- 2b. K1 on the 1080p stress draw, all eight compares -----------------
    clip, idx, colors = stress_scene()
    t_clip, t_idx, t_col = (torch.from_numpy(a).to(dev) for a in (clip, idx, colors))
    rec, corner = setup_with_attrs(t_clip, t_idx, t_col, W, H, cull_mode=CullMode.NONE)
    bins = bin_segmented(rec, corner, grid)
    # The same draw binned on the CPU must give the same layout and overflow.
    c_rec, c_corner = setup_with_attrs(torch.from_numpy(clip), torch.from_numpy(idx),
                                       torch.from_numpy(colors), W, H, cull_mode=CullMode.NONE)
    c_bins = bin_segmented(c_rec, c_corner, grid)
    for name in ("blk_tile_y", "blk_tile_x", "blk_count", "blk_init", "rast_pad"):
        check(torch.equal(getattr(bins, name).cpu(), getattr(c_bins, name)),
              f"stress: card and CPU binning differ in {name}")
    check(int(bins.overflow) == int(c_bins.overflow), "stress: overflow counts differ")
    counts = bins.blk_count
    n_valid = int(rec.valid.sum())
    tiles_multi = int(((bins.blk_init == 0) & (counts > 0)).sum())
    print(f"phase 2b: stress draw {idx.shape[0]} triangles -> {n_valid} valid records "
          f"(near-clip second halves {int(rec.valid[idx.shape[0]:].sum())}), "
          f"{int(counts.sum())} entries in {counts.shape[0]} blocks, "
          f"{tiles_multi} continuation blocks, overflow {int(bins.overflow)}")
    check(tiles_multi > 0, "stress: no tile holds more than one block")
    check(int(rec.valid[idx.shape[0]:].sum()) > 0, "stress: no near-clipped triangle")
    rng = np.random.default_rng(11)
    init = torch.from_numpy(rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)).to(dev)
    init[:, : W // 2] = 0.5
    configs = [dict(compare_op=op, depth_write=(i % 2 == 0)) for i, op in enumerate(CompareOp)]
    configs += [dict(compare_op=CompareOp.GREATER_OR_EQUAL, depth_write=True),
                dict(compare_op=CompareOp.GREATER, depth_clamp=True)]
    for cfg in configs:
        cov = compare_exact(*both(bins, grid, init, **cfg), f"stress {cfg}")
        print(f"  bit-equal: {cfg['compare_op'].name:<17} write={cfg.get('depth_write', True)!s:<5} "
              f"clamp={cfg.get('depth_clamp', False)!s:<5} covered {cov}")
    s_cov = int((raster_segmented(bins, grid, init)[1][-1] > 0).sum())
    s_ms = cuda_ms(lambda: raster_segmented(bins, grid, init), reps=20, warmup=2)
    with mock.patch.object(raster_mod, "_raster_segmented_cuda", plain):
        s_plain_ms = cuda_ms(lambda: raster_segmented(bins, grid, init), reps=3)
    print(f"phase 2b: K1 stress 1080p GREATER: kernel {s_ms:.4f} ms, plain {s_plain_ms:.4f} ms "
          f"[{card}]")

    # -- 3. the golden frame ---------------------------------------------------
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.renderer.triangle import VERTEX_LAYOUT
    from zenith_tpu_torch.rhi import (
        ColorAttachmentDesc,
        Format,
        GraphicShaderInput,
        PipelineCache,
        RasterizationState,
        RhiCore,
        Shader,
        Texture,
        TextureDesc,
        encode_present,
        uniform,
    )
    from zenith_tpu_torch.rhi.state import GraphicPipelineState
    from zenith_tpu_torch.renderer import triangle as tri_mod

    device = RhiCore(dev).create_render_device()
    vb = device.upload_buffer("tri.vb", tri_vb.cpu().numpy())
    ib = device.upload_buffer("tri.ib", np.array([0, 1, 2], np.int32))
    tex = Texture(TextureDesc.color("swap", 128, 32), device=dev)
    builder = RenderGraphBuilder()
    vbr, ibr, out = (builder.import_resource(r) for r in (vb, ib, tex))
    builder.set_dynamic("time", 1.25)
    node = builder.add_graphic_node("triangle")
    vba, iba, rt = node.read(vbr), node.read(ibr), node.write(out)
    shader = GraphicShaderInput(Shader.vertex("tri.vs", tri_mod._vs),
                                Shader.fragment("tri.ps", tri_mod._fs, bindings=[uniform("Time")]),
                                VERTEX_LAYOUT)
    state = GraphicPipelineState(rasterization=RasterizationState(cull_mode=CullMode.NONE))
    with node.pipeline(shader, state) as binder:
        binder.push_color(rt, ColorAttachmentDesc(clear_value=(0.1, 0.1, 0.1, 1.0)))

    def record(ctx):
        ctx.bind("Time", ctx.dynamic("time"))
        ctx.draw_indexed(vba, iba)

    node.execute(record)
    before = raster_segmented.launches
    compiled = builder.build().compile(device, PipelineCache(),
                                       CompileOptions(tile_h=8, tile_w=128, bin_capacity=16))
    compiled.execute(device)
    img = encode_present(compiled.value(out), Format.RGBA8_SRGB).cpu().numpy()
    check(raster_segmented.launches > before, "golden: K1 was not launched")
    golden = np.load(REPO / "tests" / "golden" / "triangle_128x32_t1_25.npy")
    diff = np.abs(img.astype(np.int16) - golden.astype(np.int16))
    print(f"phase 3: golden 128x32 t=1.25: max LSB diff {diff.max()}, "
          f"{(diff > 0).mean() * 100:.3f}% pixels differ")
    check(diff.max() <= 1 and (diff > 0).mean() < 0.01, "golden frame drifted")

    # -- 4. the main path: the triangle app through launch at 1080p ----------
    from zenith_tpu_torch.launch import launch
    from zenith_tpu_torch.sandbox.triangle import TriangleApp
    from zenith_tpu_torch.window import Window

    class RebuildTriangleApp(TriangleApp):
        update_dynamics = None  # the reference-parity rebuild-every-frame path

    results = {}
    raster_segmented.launches = 0
    main_launches = 0
    for label, app_cls in (("rebuild", RebuildTriangleApp), ("retained", TriangleApp)):
        stamps = []
        window = Window(width=W, height=H, title="triangle",
                        on_present=lambda img, i: stamps.append(time.perf_counter()))
        start = raster_segmented.launches
        t0 = time.perf_counter()
        loop = launch(app_cls, argv=["--log-level", "warn"], window=window,
                      max_frames=FRAMES, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = raster_segmented.launches - start
        main_launches += n
        check(loop.frames_rendered == FRAMES, f"{label}: rendered {loop.frames_rendered} frames")
        check(n >= FRAMES, f"{label}: K1 launched {n} times in {FRAMES} frames")
        check(window.last_frame is not None and window.last_frame.shape == (H, W, 4),
              f"{label}: no 1080p frame presented")
        steady = (len(stamps) - 11) / (stamps[-1] - stamps[10])
        results[label] = (loop, window, wall, steady, n)
        print(f"phase 4: {label}: {FRAMES} frames at {W}x{H}, K1 launches {n}, "
              f"{FRAMES / wall:.1f} FPS over the whole run, {steady:.1f} FPS after frame 10 "
              f"(readback every frame) [{card}]")
    main_launches_read = raster_segmented.launches
    check(main_launches_read == main_launches, "launch counter changed outside the runs")

    # The last frame against the same frame through the plain raster.
    for label, (loop, window, *_rest) in results.items():
        renderer = loop.app.triangle_renderer
        t_last = renderer.last_time_s
        tex = Texture(TextureDesc.color("swap", W, H), device=dev)
        builder = RenderGraphBuilder()
        out = builder.import_resource(tex)
        renderer.render_to(builder, out, W, H, time_s=t_last)
        compiled = builder.build().compile(device, PipelineCache(), CompileOptions())
        with mock.patch.object(raster_mod, "_raster_segmented_cuda", plain):
            compiled.execute(device)
        linear = compiled.value(out)
        check(bool(torch.isfinite(linear).all()), f"{label}: non-finite plain frame")
        ref = encode_present(linear, Format.BGRA8_SRGB).cpu().numpy()
        check(np.array_equal(ref, window.last_frame),
              f"{label}: last frame differs from the plain-path frame at t={t_last}")
        check(window.last_frame[..., :3].std() > 1.0, f"{label}: flat frame")
        print(f"phase 4: {label}: last frame (t={float(t_last):.4f} s) equals the plain-path frame")

    # The frame function makes no host sync (what CUDA-graph capture needs):
    # one retained run of the last graph under CUDA's sync-debug mode.
    compiled.execute(device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        compiled.execute(device, dynamics=renderer.frame_dynamics(0.5))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("phase 4: a retained frame-function run at 1080p made no host sync")

    rebuild_fps, retained_fps = results["rebuild"][3], results["retained"][3]
    print(f"summary: rebuild {rebuild_fps:.1f} FPS, retained {retained_fps:.1f} FPS, "
          f"K1 stress {s_ms:.4f} ms vs plain {s_plain_ms:.4f} ms [{card}]")
    tri_bound = k1_bound(tri_bins, grid, covered)
    stress_bound = k1_bound(bins, grid, s_cov)
    print(f"  K1 bound: demo triangle {tri_bound[0]:.4f} ms ({tri_bound[1]}; {tri_bound[2]} "
          f"fragments), stress draw {stress_bound[0]:.4f} ms ({stress_bound[1]}; "
          f"{stress_bound[2]} fragments) [H100 SXM peaks: 3.35 TB/s, "
          f"67 TFLOP/s fp32]")

    deferred = deferred_phases(dev, card, plain)
    k1_def = deferred["k1"]
    kernels = [{
        "name": "K1 segmented raster (_segmented_kernel)",
        "route": "cuda",
        "source": "zenith_tpu_torch/csrc/raster.cu",
        "replaces": "zenith_tpu/ops/raster.py:311",
        "launches": main_launches + deferred["k1_launches"],
        "max_abs_err": max(max_err, k1_def["max_abs_err"]),
        "ms": k1_def["ms"],
        "plain_ms": k1_def["plain_ms"],
        "bound_ms": k1_def["bound_ms"],
        "bound_by": k1_def["bound_by"],
        "library_ms": None,
    }, deferred["k2"]]
    print(f"  launches on the main paths: K1 {main_launches} (triangle, phase 4) + "
          f"{deferred['k1_launches']} (deferred, phase 7); K2 {deferred['k2']['launches']} "
          f"(deferred, phase 7)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
