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
4. the main path: the triangle app through zenith_tpu_torch.launch at
   1920x1080 for 120 frames, on the rebuild and the auto-retained paths.
   K1 must launch at least once per frame, the last frame must equal the
   frame rendered on the card through the plain raster at the same time, and
   a retained run of the frame function must make no host sync.

The line before the last is a JSON object listing each kernel of the path
with its launches in the main-path run, its largest difference from the
plain version, and both times; the last line is the device record.
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
          f"{time.perf_counter() - t0:.1f} s (nvcc + load)")

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
    kernels = [{
        "name": "K1 segmented raster (_segmented_kernel)",
        "route": "cuda",
        "source": "zenith_tpu_torch/csrc/raster.cu",
        "replaces": "zenith_tpu/ops/raster.py:311",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]
    print(f"summary: rebuild {rebuild_fps:.1f} FPS, retained {retained_fps:.1f} FPS, "
          f"K1 stress {s_ms:.4f} ms vs plain {s_plain_ms:.4f} ms [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
