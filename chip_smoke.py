#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (zenith_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the zenith_tpu package, and fails (exit code
other than 0, no result line) on the first phase that fails:

1. device and build: checks the card, prints its name and power limit, and
   builds every kernel from zenith_tpu_torch/csrc/ and the blend kernel of
   each fragment shader the script draws with, every nvcc at once (timed),
   with the compiler's registers, spills and shared memory for each kernel
   (K1 is raster_segmented_kernel<0>, K3 <1>, K4 <2>). A later phase
   whose draw compiles a blend kernel anew fails: the kernel reported here
   would not be the one it ran;
2. K1 against its plain PyTorch version, on the card: at the triangle demo's
   own 1920x1080 inputs and on a numpy-seeded 1080p stress draw (tens of
   thousands of triangles, tiles with more than one block of entries,
   mid- and huge-span records, near-clipped triangles, exact equal-z ties)
   for all eight depth compares; then on a cull-stress draw at sample
   offset (0.9375, 0.0625) for all eight compares: near-clipped triangles
   whose AABBs reach surfaces off-screen, needles and slivers, and corners on
   sample points, whose edges run through samples at the border of K1's
   per-entry pixel rectangle. z, coverage and the attribute planes must be
   bit-equal (the plain version does not cull, so this holds the rectangles
   too); the card's binning must equal the CPU binning, overflow count
   included. Both versions are timed with CUDA events (median), beside K1's
   time at the same input before its redesign (PERF.md §6) and the largest
   number of entries a tile holds;
3. the golden frame: the triangle graph of tests/test_golden.py rendered on
   the card must match tests/golden/triangle_128x32_t1_25.npy (<= 1 LSB,
   < 1% of pixels differing);
4. the triangle's main path: the triangle app through zenith_tpu_torch.launch
   at 1920x1080 for 30 frames, on the rebuild and the auto-retained paths.
   K1 must launch at least once per frame, the last frame must equal the
   frame rendered on the card through the plain raster at the same time, and
   a retained run of the frame function must make no host sync;
5. K2 against its plain PyTorch version on the card, on the 1080p G-buffer
   of phase 7's scene with its 100 point lights, with a mixed point/spot
   table, with a table of spots with hard and narrow cone edges, with all
   100 lights crowded within 4 units of one surface point (the densest
   cull regions K2 can meet) and on the G-buffer cut to a ragged 1918x1078
   (atol 2e-4 / rtol 2e-3), with the hits per 16x128 tile (the plain
   version's cull) and per 16x16 region (the kernel's), mean and max, and
   the lit (light, pixel) pairs; K1 bit-equal to its plain version on that
   frame's shadow and G-buffer passes. Both kernels (each K1 pass) and
   their plain versions are timed (CUDA events, median) and set beside
   their bound on the H100, which counts the work these inputs need (K1's
   fragments, K2's lit pairs), and beside their times before their
   redesigns, K1's with each pass's largest tile;
6. the deferred golden: tests/test_golden.py's scene (8 point lights, a 16²
   sky cube, 128x64, 8x128 tiles) rendered through the port on the card
   must match tests/golden/deferred_scene_128x64.npy (<= 1 LSB, < 1% of
   values differing);
7. the deferred main path: bench.py::bench_scene's frame function (rebuild →
   DeferredRenderer.render_to → PostProcess → PresentEncode(BGRA8_SRGB),
   camera orbit at radius 170, fov 35°) at 1920x1080 for 30 frames, on
   zenith_tpu/sandbox/scene.py::build_scene's settings with the cerberus
   mesh replaced by a procedural stand-in of its size
   (zenith_tpu_torch/sandbox/scene.py::build_standin_scene). Each
   frame must run K1 at least twice (shadow, G-buffer) and K2 at least once,
   with no bin overflow; the last frame must match the same frame through
   both plain versions (<= 1 LSB, < 1% of values); a retained frame must
   make no host sync. It prints FPS, frame time p50/p99, and from
   torch.profiler the kernel launches, device time (per render-graph node,
   and K1's and K2's own) and device-busy share per frame, and whether the
   frame is host-bound
   (the device idle more than 20% of the unprofiled p50 frame), and what
   the per-row rectangles cost the frame's host: frames that compute them
   against frames that replay them (A B B A, bit-equal);
8. K3 (raster + stencil) against its plain version on the 1080p stress
   draw: a stencil-write draw (faces that differ, REPLACE,
   INCREMENT_AND_WRAP, INVERT as the depth-fail op, write masks 0xF3 / 0xBF)
   and then a stencil-masked draw over its stencil plane (compare masks,
   fail, depth-fail and pass ops). z, planes and stencil bit-equal;
9. K4 (raster + peel bound) on the stress draw: peel layers 2 and 3 chained
   behind K1's layer 1, and the overflow probe (depth write off). Bit-equal;
10. K5 and K6 (in-order shade and blend, K6 with stencil) on 8 draws of 32
    screen-sized translucent triangles each (256 triangles, the most the
    huge-span tier bins at once; mixed winding, a per-draw uniform, the draw
    id), through draw_indexed_batch with a kernel-safe shader and its device
    source: src-alpha over with depth writes off; a reverse-subtract / max
    equation under a write mask with depth writes on; K6 with a read-only
    stencil mask whose faces differ, and as an overdraw limiter that writes
    the stencil. z and stencil bit-equal, colour within atol 1e-5 + rtol
    1e-5 of the plain version; each timed beside its time before the
    redesign. Then (10b) the four cases again on phase 2c's cull
    stress drawn translucent at sample offset (0.9375, 0.0625), where K5
    and K6's per-entry rectangle cull must drop nothing: z and stencil
    bit-equal, colour within atol 1e-5 + rtol 1e-5;
11. the deferred main path with build_scene's two glass panes at 1920x1080,
    100 lights, 20 frames per mode: glass_mode="kernel" (K5, the glass
    shader's device source) and glass_mode="peel" with the 64² checker and 4
    layers (K1 for layer 1, K4 for layers 2-4 and the probe). Each frame
    must launch K1, K2 and K5 or K4 the expected number of times with no bin
    overflow and no shader build; the last frame must match the same frame
    through every plain version (<= 1 LSB, < 1% of values) and differ from
    the frame without panes; a retained frame must make no host sync. The
    panes stand side by side, so one more frame per mode has one pane moved
    half over the other: that frame against the plain-path frame, its K5
    call, and its four K4 calls (a second layer, nothing deeper), against
    their plain versions. K5 and K4 are then held against their plain
    versions, and timed, at the glass node's own inputs (where K4's layers
    must be empty), and one frame draws textured glass in kernel mode (the
    textured shader's device source), its K5 call and the frame held against
    the plain versions;
12. a stencil-attachment frame at 1920x1080 through the render graph: a
    stencil-only node marks a triangle (K3), a second node draws a quad
    with interpolated vertex colours through the mask (K3), a third blends
    two of phase 10's draws through it (K6); stencil plane equal to, colour
    within atol 1e-5 + rtol 1e-5 of, the plain path; nothing drawn outside
    the mask. Both K3 calls and the K6 call are then held against their
    plain versions, and timed, at the frame's own inputs;
13. the capped-bin path (setup_triangles + corner_attributes →
    bin_triangles → visibility_pass (K7) / raster_interp_pass (K8) →
    resolve_varyings / finalize_attrs) through the public API, on the 1080p
    stress draw and on phase 7's geometry with world position and normal as
    varyings, seen by the camera of phase 7's first timed frame (1920x1080,
    510 tiles) and by the sun (the 1024² shadow map, 256 tiles), each at a
    capacity that drops nothing, then on the stress draw at capacity 64.
    K7 and K8 bit-equal to their plain versions; K8 bit-equal to K1 on the
    segmented bins of the same records, and timed beside it (wrapper call
    and device time; K7 and K8 walk K1's culled sub-regions over the capped
    layout, so their device time over K1's shows what the layout costs);
    K7's z equal to K8's, its slots set exactly where K8's 1/w plane is;
    resolve_varyings over K7's slots within atol 2e-3 + rtol 1e-4 of
    finalize_attrs over K8's planes; at capacity 64 the card's binning
    (overflow included) equal to the CPU's. Then (13f) phase 2c's
    near-clipped and sliver triangles with the other corners on pixel
    centres through the capped-bin path, where the per-slot rectangle cull
    must drop nothing: K7's z and slots and K8's z and planes bit-equal to
    their plain versions for all eight compares, and once at 64x128 tiles
    (8,192 pixels a tile);
14. textured materials end to end: (14a) build_scene's textured deferred
    scene (the stand-in mesh with the brushed texture, the ground with the
    checker, bump normal and MRA maps through the G-buffer's material
    atlases) at 1920x1080 with 100 lights and phase 7's camera orbit, 20
    frames: each frame must run K1 twice and K2 once with no bin overflow,
    the last frame must match the plain-path frame (<= 1 LSB, < 1% of
    values); K2 and K1's passes timed as bare launches (CUDA events), and a
    torch.profiler breakdown (launches, kernel and gather time, idle share)
    printed only where the profiler recorded the expected K1 and K2
    launches; (14b) tests/test_golden.py's textured frame on the card must
    match tests/golden/textured_scene_128x64.npy and its plain-path frame,
    and the same scene with the full material set (bump normal and MRA on
    the ground, emissive rings on the panel) its plain-path frame (<= 1
    LSB); (14c) a glTF written to a temporary content root (data-URI
    buffer, no images) is baked through the AssetManager and loaded again
    from its cache without a rebake, a Material of four numpy-made maps
    goes through SceneObject.from_mesh_with_material onto the card, and a
    deferred frame and a MeshRenderer frame of it at 1920x1080 must each
    match their plain-path frames (<= 1 LSB);
15. the forward shadow renderer (config #3), MSAA, lines and points:
    (15a) launch(SceneApp, argv=["--mode", "forward", ...]) at 1920x1080 over
    build_scene's cerberus from the repository's cache, 30 frames each at
    --msaa 1, 4 and 8, --wireframe, --msaa 4 --instances 64 and the same with
    ForwardShadowRenderer(sample_shading=False): K1 must launch 2, 1+S, 2,
    2+2S and 2+S+(S+1) times a frame with no bin overflow, and the last frame
    must equal its plain-path frame (the plain K1 as it runs for bins with
    rectangles: the per-pixel resolve); FPS, p50/p99 and a profile of 10
    frames each, and a retained shade-once frame must make no host sync;
    (15b) K1 at the eight 8x sample positions on phase 2c's cull stress
    (GREATER with writes, LESS_OR_EQUAL without) bit-equal to its unculled
    plain version, and K3, K4 (3 peel layers) and K5 under 4x MSAA through
    draw_indexed_batch on two of phase 10's translucent stress draws: z and
    stencil bit-equal, colour within atol 1e-5 + rtol 1e-5 of the plain
    path; (15c) a 10,000-segment line list, a line strip with restart,
    20,000 points sized by the vertex shader and the deferred wireframe view
    of phase 7's scene at 1080p, each against its plain path;
16. the terrain flyover and the single-target screen-space passes:
    (16a) launch(TerrainApp) at 1920x1080 at its defaults (a 768x768 grid,
    1,176,578 triangles in one draw, a 2048² shadow map, the textured
    G-buffer, the atmosphere sky, bloom + ACES), 30 frames, then 30 with
    --contact-shadows: K1 2 and K2 0 launches a frame, no bin overflow, the
    last frame equal to its plain-path frame (the per-pixel resolve), a
    retained frame without host sync, FPS, p50/p99 and a profile (device
    time, launches and idle share a frame, kernel time and launches by
    node); K1 on the terrain's own shadow and G-buffer records bit-equal to
    its unculled plain walk, with entries, largest tile, fragments, device
    time and bound; (16b) the six feature goldens of
    tests/test_golden_features.py (SSR, fog, sky, flare, contact, decals)
    through sandbox.scene.feature_golden_scene on the card, <= 1 LSB and
    < 1% of values, each golden differing from the base frame; (16c)
    SceneApp --mode deferred --ssao --contact-shadows --ssr --fog --sky
    --flare --decals 8 over the baked cerberus at 1080p, 30 frames: K1 2 and
    K2 1 a frame, the last frame against the plain path, a retained frame
    without host sync, a profile; (16d) FlyApp's scripted flight (60 frames
    at 1280x720, K1 2 a frame) and MeshApp (30 frames at 1080p, K1 1 a
    frame), each last frame against its plain path;
17. deferred instancing, the render graph's sub-resource views and the
    layered shadows: (17a) SceneApp --mode deferred --gun-instances 30
    --instances 64 over the baked cerberus at 1920x1080 (1,006,292
    triangles submitted to each pass), 30 frames: K1 6 and K2 1 a frame
    (the count the node structure predicts), no bin overflow, K1 on every
    pass of a still frame bit-equal to its unculled plain walk, the still
    frame against the same scene drawn as 95 separate objects (<= 1 LSB,
    < 1% of values, but for silhouette pixels on at most 0.05% of the
    frame, where the two vertex paths round positions apart); (17b) the
    same with --cascades 3 --point-shadows --bloom-mips 5: K1 18 and K2 1 a
    frame, K1 bit-equal to the unculled walk on every pass into the three
    cascade layers and the six cube faces, the bin overflow of each pass
    printed (only the cascades' instanced passes may overflow), K2 on the
    100 unshadowed lights against its plain version; (17c) with
    --soft-shadows (VSM); each with its last frame against the plain path,
    a retained frame without host sync and a profile; (17d) the
    sub-resource graphs (a cube face rendered and sampled, a layer of a
    depth array, render-to-mip, buffer ranges, a layered mip chain, the
    bloom chain) on the card against the same code on the CPU.
18. the image-based light, the rest of the post chain and the temporal
    passes, through SceneApp --mode deferred at 1920x1080 over the baked
    cerberus with 100 point lights: (18a) --ibl --fxaa --grade --film
    --auto-exposure, 30 frames, K1 2 and K2 1 a frame, the adapted exposure
    fed back on the device every frame and printed at frames 1, 10 and 30;
    (18b) --taa --velocity --motion-blur --instances 64, 30 frames, K1 4
    and K2 1 a frame, K1 on one jittered frame's G-buffer passes bit-equal
    to its unculled walk, then the rocks' offsets as a CUDA tensor replaced
    every frame (the velocity plane on by default) through retained frames
    without host sync; (18c) --probe: the capture timed, K1 on a 64² probe
    face (8x64 tiles, mirrored winding) bit-equal to its unculled walk, 30
    frames; each with one frame function for all frames, the kernel and
    the plain path from reset through the same 8 frames (one Halton cycle;
    the temporal state makes the next frame differ) or the last frame
    against the plain path, a retained frame without host sync and a
    profile; (18d) the film golden on the card.
19. depth of field, the HUD, particles, skinning, morph targets and
    picking, through SceneApp --mode deferred at 1920x1080 with 100 point
    lights: (19a) --dof --hud --pick, the focus racked and the HUD text
    changed every frame, K1 2 and K2 1 a frame, the object under the screen
    centre printed; (19b) --skinned --morph --particles 128 --velocity
    --taa, K1 8 and K2 1 a frame, K1 on the skinned and the sparks'
    G-buffer passes bit-equal to its unculled walk, the fed-back particle
    state equal to a plain-path replay's; (19c) README.md's "everything at
    once" (--taa --cascades 3 --auto-exposure --skinned --morph --spots 3
    --particles 128 --grade --dof --soft-shadows) + --hud --pick, K1 16 and
    K2 1 a frame; 30 frames each with one frame function, the last frame
    against the plain path (19b-c from a reset through 4 frames), a
    retained frame without host sync and a profile.
20. the interactive viewer and sort-first SPMD on one card. (20a) FlyApp at
    1280x720 served (zenith_tpu_torch.viewer) to a client thread over
    loopback: (i) the fixed resolution, the delivered FPS of the /stream
    parts with their bytes and encoder, /frame the encode of a presented
    frame; (ii) launch(FlyApp, serve=0) with the adaptive stream at a 30 FPS
    target, its transport probe per rung and the rung it settles on; (iii)
    KeyW held 1 s moves the camera forward and a close event ends the loop;
    every part parses and no thread is left. (20b) SceneApp --mode deferred
    at 1920x1088 through an Engine given CompileOptions(mesh=
    default_mesh(4, device="cuda:0")) (4 bands of 272 rows, one thread a
    shard), 20 frames beside the same app single-device: K1 8 and K2 4 a
    frame, each band's K1 bit-equal to its unculled walk, each band's K2
    within atol 2e-4 / rtol 2e-3, the HDR and the presented frames against
    single-device within the reference's band-offset tolerance; then 5
    frames with every screen-space, temporal and post flag within
    FEATURE_LIMIT, the runtime's collectives counted, beside the same app
    with its row offset stuck at rank 0, which the check must refuse, and
    with its halo short by 2 rows, which no frame-level check sees. (20c)
    make_row_sharded_frame and make_sort_last_frame on phase 7's stand-in
    mesh at 1920x1088 against the single-device draw (sort-last
    bit-equal), composite_depth bit-equal to composite_depth_all_gather
    with forced ties, halo_exchange_rows equal to torch.roll, and the
    banded bloom bit-equal to the whole-surface one on shared inputs,
    refused with a halo short by 2 rows. (20d) the glass frame in bands,
    K5 once per band, each band's call against its plain version. (20e)
    sort-last and auto SPMD through the render graph, 4 shards on cuda:0
    at 1920x1088: SceneApp --mode forward over the baked cerberus, 20
    frames each single-device, sort-first and parallel="sort_last" (K1 2, 8
    and 8 a frame; FPS, launches, kernel time and idle share from a
    profile); each node's mode (the shadow pass banded, the lit pass
    sort-last); each shard's K1 on the lit pass (full-height bins of a
    quarter of the triangles) bit-equal to its unculled plain walk and to
    its plain version, timed against its bound; the lit pass's colour and
    depth against single-device at test_sort_last.py's tolerance (<= 0.2%
    of pixels off by > 1e-3, depth 1e-5), the presented frames within the
    band-offset tolerance; then parallel="auto" on three cerberus copies
    (100,629 triangles, over AUTO_SL_MIN_TRIS): in the top quarter of the
    rows the lit pass resolves to sort-last, spread over the height to
    sort-first, the shadow pass to sort-first, each held as before.
21. the reference's random state sweeps and split draws (the draws of
    tests/test_torch_property.py and tests/test_torch_raster_parts.py, the
    port's twins of test_property.py, test_property_matrix.py and
    test_raster_parts.py). (21a) the 32 sweep draws (topology, cull x
    winding, all eight depth compares x write, one- and two-face stencil
    with random ops and masks, sample offsets on the 1/16 lattice) through
    K1, or K3 with stencil, at 128x64 with 8x128 tiles within the
    reference's tolerances of tests/np_reference.py (coverage and stencil
    exact, z 1e-4, varyings 2e-3) and bit-equal to the plain versions, and
    the same clip-space draws at 1920x1080 bit-equal to the plain
    versions; (21b) test_property_matrix.py's 12 blend equations, and more
    seeds until all ten factor codes and five ops are drawn in a written
    channel, each a translucent draw of 48 random triangles over a random
    HDR target at 128x64 and 1920x1080 through K5, six also with a random
    two-face stencil through K6: z and stencil bit-equal, colour within
    atol 1e-5 + rtol 1e-5; (21c) the seven splits (ops.draw's record cap
    64 and primitive cap 16, restored in a finally) bit-equal to the
    unsplit renders through K1, K3, K5 and K1 at each of 4 MSAA samples.
    Negative controls: a plain K3 with two stencil ops swapped and a plain
    K5 with the SRC/DST alpha factors swapped must be caught.

Every kernel and its plain version are timed with CUDA events (median; a
plain version that runs for seconds twice, not warmed up) and set beside
their bound on the H100: the larger of the bytes that must move (the live
rows of the bins, not their padding; each plane read or written once) over
3.35 TB/s and the fp32 operations these inputs need over 67 TFLOP/s.

The line before the last is a JSON object listing each kernel (K1-K8) with
its launches on the main paths (phases 4, 7, 11-21), its largest
difference from the plain version, its time, the plain version's, its bound
and what bounds it, and the inputs these were taken at; the last line is the
device record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent
W, H = 1920, 1080
# Frames per run: phases 4, 7, 11 and 14a run half their former frames, and
# each profile 4 frames (10 before), which keeps the script, phase 17
# included, under ten minutes (most of a profile's cost is processing its
# events).
FRAMES = 30
DEFERRED_FRAMES = 30
GLASS_FRAMES = 20
PROFILED_FRAMES = 4
# Frames per run of phase 7's A/B of the per-row rectangles' host cost.
RECT_FRAMES = 30


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


def device_ms(fn, part: str, reps: int = 10) -> float:
    """Device time in ms per call of ``fn`` spent in the kernels whose name
    holds ``part`` (torch.profiler, kernels only, after one untimed call):
    the kernel alone, where ``cuda_ms`` times the whole wrapper call."""
    import torch

    from zenith_tpu_torch.core import profile

    fn()
    torch.cuda.synchronize()
    with profile.session(cpu=False) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = {(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and part in e.name}
    return sum(b - a for a, b in spans) / 1e3 / reps


def kernel_ms(launch, reset, reps: int = 10) -> float:
    """Device time in ms of one bare kernel launch (median, after one
    untimed launch): CUDA events recorded just before and after ``launch``,
    queued behind a spin kernel, so that the card runs event, kernel and
    event back to back whatever the host's enqueue time. ``reset`` restores
    the kernel's in-place inputs before each launch. Phase 13 uses it where
    torch.profiler, late in this long process, recorded none or only some of
    a session's launches."""
    import torch

    times = []
    for i in range(reps + 1):
        reset()
        torch.cuda._sleep(1 << 20)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        if i:
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


# Phase 2c's sample offset, and the lattice of sample points that clip
# coordinates reach exactly at 1920x1080 with it: x = 15 m + 0.9375 (NDC
# (16 m + 1) / 1024 - 1), y = 135 t + 59.0625 (NDC (16 t + 7) / 64 - 1).
# Phase 13f's lattice of pixel centres: x = 15 m + 7.5 (NDC (8 m + 1) / 512
# - 1), y = 135 t + 67.5 (NDC (2 t + 1) / 8 - 1).
CULL_OFFSET = (0.9375, 0.0625)
CULL_LATTICE = (0.9375, 59.0625)
CENTRE_LATTICE = (7.5, 67.5)


def cull_stress_scene(seed: int = 19, lattice=CULL_LATTICE):
    """Phase 2c's draw, which K1's per-entry rectangle cull must survive:
    near-clipped triangles whose clipped AABBs reach thousands of pixels
    off-screen, needles and slivers 20-600 px long and 0.02-0.6 px thick,
    and triangles with corners on the sample points of ``lattice`` (x = 15 m
    + lattice[0], y = 135 t + lattice[1]; axis-aligned right triangles and
    others), whose edges run through sample points at the AABB's border.
    (clip (Nv, 4), indices (T, 3), colors (Nv, 3))."""
    rng = np.random.default_rng(seed)

    def clip_of(px, z, w):
        ndc = px / [W / 2, H / 2] - 1.0
        return np.concatenate([ndc * w[:, None], (z * w)[:, None], w[:, None]], 1)

    n = 300  # near-clipped: two corners beyond the near plane, the third far off-screen
    px = rng.uniform(-0.1, 1.1, (n, 3, 2)) * [W, H]
    z = rng.uniform(0.02, 0.3, (n, 3))
    w = rng.uniform(0.5, 2.0, (n, 3))
    z[:, :2] = rng.uniform(1.02, 1.3, (n, 2))
    px[:, 2] = rng.uniform(2.0, 30.0, (n, 2)) * rng.choice([-1.0, 1.0], (n, 2)) * [W, H]
    near = clip_of(px.reshape(-1, 2), z.reshape(-1), w.reshape(-1))
    n = 2000  # needles and slivers, a quarter along the axes and diagonals
    p0 = rng.uniform(0, 1, (n, 2)) * [W, H]
    ang = rng.uniform(0, 2 * np.pi, n)
    ang[::4] = rng.choice([0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4], n // 4)
    d = np.stack([np.cos(ang), np.sin(ang)], 1)
    p1 = p0 + d * rng.uniform(20, 600, (n, 1))
    p2 = (p0 + p1) / 2 + d[:, ::-1] * [1, -1] * rng.uniform(0.02, 0.6, (n, 1))
    sliver = clip_of(np.stack([p0, p1, p2], 1).reshape(-1, 2), rng.uniform(0.05, 0.95, 3 * n),
                     np.ones(3 * n))
    n = 1000  # corners on sample points
    m = rng.integers(-1, W // 15 + 1, (n, 3))
    t = rng.integers(-1, H // 135 + 1, (n, 3))
    t[::2, 1], m[::2, 2] = t[::2, 0], m[::2, 0]  # right triangles with axis-aligned legs
    corners = np.stack([15 * m + lattice[0], 135 * t + lattice[1]], -1).reshape(-1, 2)
    on_samples = clip_of(corners, rng.uniform(0.05, 0.95, 3 * n), np.ones(3 * n))
    clip = np.concatenate([near, sliver, on_samples]).astype(np.float32)
    idx = np.arange(clip.shape[0], dtype=np.int32).reshape(-1, 3)
    colors = rng.uniform(0.0, 1.0, (clip.shape[0], 3)).astype(np.float32)
    return clip, idx, colors


# Times before the redesigns, at the same inputs (PERF.md §6: the ranges of
# the CUDA-event medians this script printed then, NVIDIA H100 80GB HBM3,
# 700.00 W), before each kernel's redesign.
BEFORE_MS = {"demo triangle": "0.1383-0.2149", "stress draw": "7.2051-7.7017",
             "shadow": "8.4931-8.6090", "gbuffer": "2.9762-3.1871",
             "phase 13 stress draw": "7.4799-7.8775",
             "phase 13 G-buffer view": "3.1655-3.1865",
             "phase 13 shadow view": "8.5905-9.0006",
             "K7 phase 13 stress draw": "7.4309-8.0370",
             "K7 phase 13 G-buffer view": "3.0261-3.3645",
             "K7 phase 13 shadow view": "8.7382-9.2380",
             "K8 phase 13 stress draw": "7.4610-8.0626",
             "K8 phase 13 G-buffer view": "3.0404-3.2448",
             "K8 phase 13 shadow view": "8.8297-9.3389",
             "K2 points": "0.6655-0.7781 (device time 0.590-0.610 a frame)",
             "K5 glass panes": "0.7039-1.6772", "K5 stress": "5.8463-7.4725",
             "K6 stencil frame": "1.6896-2.0003", "K6 stress": "9.9293-10.2265"}


def tile_entries(bins, grid) -> int:
    """The largest number of entries any one tile holds."""
    import torch

    tile = bins.blk_tile_y.long() * grid.tiles_x + bins.blk_tile_x.long()
    per_tile = torch.zeros(grid.num_tiles, dtype=torch.int64, device=tile.device)
    return int(per_tile.index_add_(0, tile, bins.blk_count.long()).max())


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


def count_fragments(bins, grid, passes=None, sample_offset=(0.5, 0.5),
                    chunk: int = 2048) -> "tuple[int, int]":
    """(fragments, passing fragments) of these bins. A fragment is an image
    pixel of an entry's tile that its triangle covers (edge functions with
    the top-left rule, as the rasterizers evaluate them) inside the depth
    range [0, 1]. ``passes(rows, zpx, py, px)`` says which fragments pass the
    tests that do not depend on the walk (a depth test with depth writes off,
    a read-only stencil mask); without it every fragment counts as passing.
    Tensor ops on the bins' device, ``chunk`` entries at a time."""
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
    total = passing = 0
    for s in range(0, ent_row.shape[0], chunk):
        full = rows[ent_row[s:s + chunk]]
        c = full[:, :16, None, None]
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
        if passes is not None:
            ok = passes(full, z, py.clamp(max=grid.height - 1).expand_as(z),
                        px.clamp(max=grid.width - 1).expand_as(z))
            passing += int((cov & ok).sum())
    return total, (passing if passes is not None else total)


def k1_fragments(bins, grid) -> int:
    return count_fragments(bins, grid)[0]


def input_bytes(bins) -> int:
    """The bytes of these bins a raster kernel must read: the rows of the
    live entries (a block's rows are padded to a fixed length; the padding
    is never loaded and is not counted) and the four routing tables."""
    live = int(bins.blk_count.sum())
    return 4 * (live * bins.rast_pad.shape[1] + 4 * bins.blk_count.shape[0])


def k1_bound(bins, grid, covered_px: int) -> "tuple[float, str, int]":
    """K1's bound on these bins: the live rows, the routing tables and the z
    plane read once; z and the a_n attribute planes written once (the planes
    are the function's output, zero where nothing is covered, so every value
    of them is written whatever the coverage); the edge and depth work of
    each fragment, and the winner's attributes at each of the ``covered_px``
    pixels the pass covers. Returns (ms, what bounds it, fragments)."""
    a_n = (bins.rast_pad.shape[1] - 16) // 3
    hp, wp = grid.tiles_y * grid.tile_h, grid.tiles_x * grid.tile_w
    nbytes = input_bytes(bins) + 4 * (hp * wp + hp * wp + a_n * hp * wp)
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


def plain_k2(am, nr, pe, depth, cam, lights, tile_h, tile_w):
    """K2's plain version, in the launcher's place (the counter stays put)."""
    from zenith_tpu_torch.ops import lighting as lighting_mod

    return lighting_mod._accumulate_point_lights_torch(am, nr, pe, depth, cam, lights,
                                                       tile_h, tile_w)


def deferred_phases(dev, card: str, plain_k1) -> dict:
    """Phases 5-7: K2 against its plain version, the deferred golden, and
    the deferred main path at 1920x1080. Returns the kernel records."""
    import torch

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
              f"largest tile {tile_entries(bins, grid)} entries, {frags} fragments, {pass_cov} "
              f"px covered, a_n {k[1].shape[0]}: bit-equal to the plain version; kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}); before the "
              f"redesign {BEFORE_MS[label]} ms; no one-call PyTorch equivalent [{card}]")
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
    # The densest case for the kernel's cull: all the lights within 4 units
    # of the surface point seen at the centre of the frame, so the regions
    # there each hit (nearly) every light.
    covered = g["depth"] > 0
    ys, xs = torch.nonzero(covered, as_tuple=True)
    near = torch.argmin((ys - H // 2) ** 2 + (xs - W // 2) ** 2)
    centre = g["pos"][ys[near], xs[near], :3]
    lp_dense = centre + torch.from_numpy(
        np.random.default_rng(13).uniform(-4.0, 4.0, (n_l, 3)).astype(np.float32)).to(dev)
    full = (g["albedo"], g["normal"], g["pos"], g["depth"])
    ragged = tuple(t[:H - 2, :W - 2].contiguous() for t in full)  # 1918x1078
    # More lights than the kernel tests in one pass (256): the scene's, the
    # crowded ones and the scene's again, in that order.
    many = (torch.cat([lp, lp_dense, lp]), torch.cat([lc, lc, lc]), torch.cat([lr, lr, lr]))
    tables = (("points", full, (lp, lc, lr), None), ("mixed point/spot", full, (lp, lc, lr), mixed),
              ("hard-edged spots", full, (lp, lc, lr), hard),
              ("light-dense", full, (lp_dense, lc, lr), None),
              ("points, ragged surface", ragged, (lp, lc, lr), None),
              ("300 lights", full, many, None))
    sub_h, sub_w = lighting_mod.KERNEL_CULL
    k2_err, k2 = 0.0, None
    for label, planes, (pos, col, rad), sp in tables:
        sp = None if sp is None else torch.from_numpy(sp).to(dev)
        hh, ww = planes[3].shape
        n_l = pos.shape[0]
        args = (*planes, cam_pos, pos, col, rad)
        out_k = accumulate_point_lights(*args, spot_params=sp)
        with mock.patch.object(lighting_mod, "_accumulate_point_lights_cuda", plain_k2):
            out_p = accumulate_point_lights(*args, spot_params=sp)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out_k).all()), f"K2 {label}: non-finite output")
        err = (out_k - out_p).abs()
        k2_err = max(k2_err, err.max().item())
        table = light_table(pos, col, rad, sp)
        tile_hits = lighting_mod.tile_light_hits(planes[3], planes[2], table).sum(1)
        sub_hits = lighting_mod.tile_light_hits(planes[3], planes[2], table, sub_h, sub_w).sum(1)
        lit = k2_lit_pairs(planes[3], planes[2], table)
        bad = ~torch.isclose(out_k, out_p, atol=2e-4, rtol=2e-3).all(-1)
        n_bad = int(bad.sum())
        print(f"phase 5: K2 {label} {ww}x{hh}: hits per 16x128 tile mean "
              f"{tile_hits.float().mean().item():.2f} max {int(tile_hits.max())} "
              f"({int(tile_hits.sum())} of {tile_hits.numel()} x {n_l}); hits per "
              f"{sub_h}x{sub_w} cull region (the kernel's) mean "
              f"{sub_hits.float().mean().item():.2f} max {int(sub_hits.max())} "
              f"({int(sub_hits.sum())} of {sub_hits.numel()} x {n_l}); {lit} lit (light, pixel) "
              f"pairs; max |kernel - plain| {err.max().item():.3e} (max value "
              f"{out_p.abs().max().item():.3f}); {n_bad} pixels beyond atol 2e-4 / rtol 2e-3")
        if n_bad:
            edge = cone_edge_pixels(bad, planes[2], table)
            fail(f"K2 {label}: {n_bad} pixels differ from the plain version beyond atol 2e-4 / "
                 f"rtol 2e-3, {edge} of them inside a spot's cone edge (0 < t < 1)")
        if label in ("points", "light-dense"):
            k_ms = cuda_ms(lambda: accumulate_point_lights(*args), reps=50, warmup=3)
            with mock.patch.object(lighting_mod, "_accumulate_point_lights_cuda", plain_k2):
                p_ms = cuda_ms(lambda: accumulate_point_lights(*args), reps=5)
            b_ms, b_by = k2_bound(hh, ww, n_l, lit)
            dev_ms = device_ms(lambda: accumulate_point_lights(*args), "tiled_lights_kernel")
            before = (f"; before the redesign {BEFORE_MS['K2 points']} ms" if label == "points"
                      else "")
            print(f"phase 5: K2 {label} {ww}x{hh}: kernel {k_ms:.4f} ms (wrapper call; the "
                  f"kernel alone {dev_ms:.4f} ms of device time), plain {p_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}){before}; no one-call PyTorch equivalent [{card}]")
            if label == "points":
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

    rect_host_cost(frame, card)
    profile_frames(frame, ("shadow", "gbuffer", "lighting", "post", "present.encode"),
                   "phase 7", card, frame_ms,
                   watch=("tiled_lights_kernel", "raster_segmented_kernel"),
                   expect={"raster_segmented_kernel": 2, "tiled_lights_kernel": 1})
    return {"k1": {"ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms,
                   "bound_by": k1_bound_by, "max_abs_err": k1_err},
            "k1_launches": k1_launches, "k2": k2}


# fp32 operations per fragment beyond K1's 29, counted from
# csrc/raster_common.cuh and csrc/raster_blend.cu. K3: the stencil test, op
# and masked write (two ANDs, a compare, an op, a merge: 8). K4: the bound
# compare (1). K5/K6 per shaded fragment (one that passes its tests): the a_n
# planes (5 each), 1/w (one divide) and the finalize (a_n products), the
# shader's own operations, and the blend equation (factors, products, ops and
# write mask: 20).
K3_OPS_PER_FRAGMENT = K1_OPS_PER_FRAGMENT + 8
K4_OPS_PER_FRAGMENT = K1_OPS_PER_FRAGMENT + 1
BLEND_OPS = 20
GLASS_SHADER_OPS = 24
STRESS_SHADER_OPS = 12

# (tile, record) pairs the translucent stress may bin: every one of its 256
# triangles (all the huge-span tier holds in one binning) can reach every one
# of the 510 tiles of a 1080p frame.
STRESS_ENTRY_BUDGET = 256 * 510

STRESS_FS_CUDA = """
__device__ __forceinline__ void zn_fragment(const float* a, float frag_x, float frag_y,
                                            float depth, bool front_facing, float draw_id,
                                            float* rgba) {
  const float* c = a + ZN_V_color;
  const float* g = a + ZN_U_Gain;
  const float shade = front_facing ? 1.0f : 0.6f;
  const float k = shade * (1.0f + 0.125f * draw_id);
  rgba[0] = c[0] * g[0] * k;
  rgba[1] = c[1] * g[1] * k;
  rgba[2] = c[2] * g[2] * k;
  rgba[3] = c[3] * g[3];
}
"""
# The record columns of three of the four blend shaders the script builds
# ahead (SOUP_LAYOUT, phase 21's, is the fourth; the 1/w column not
# included), in the order draw._batch_records lays them out. Phases 10-12
# and 21 fail if a draw's own layout misses these builds.
STRESS_LAYOUT = [("color", 4), ("__draw_id", 1), ("__u_Gain", 4), ("__front", 1)]
GLASS_LAYOUT = [("normal", 3), ("__draw_id", 1), ("__u_BaseColor", 4), ("__u_SunDir", 3),
                ("__front", 1)]
GLASS_TEX_LAYOUT = [("normal", 3), ("tint", 4), *GLASS_LAYOUT[1:]]


def stress_fs(varyings, res, builtins):
    """The plain version of STRESS_FS_CUDA: vertex colour times a per-draw
    gain, darker on back faces, brighter with the draw id."""
    import torch

    c, g = varyings["color"], res["Gain"]
    one = torch.ones_like(c[..., 0])
    shade = torch.where(builtins.front_facing, one, 0.6 * one)
    k = shade * (1.0 + 0.125 * builtins.draw_id)
    return torch.stack([c[..., 0] * g[..., 0] * k, c[..., 1] * g[..., 1] * k,
                        c[..., 2] * g[..., 2] * k, c[..., 3] * g[..., 3]], dim=-1)


def translucent_stress(dev, n_draws: int = 8, quads: int = 16, seed: int = 23):
    """Many overlapping translucent quads at 1080p: ``n_draws`` draws of
    ``quads`` screen-sized quads each (flat depth, mixed winding, random
    colour and alpha per vertex), each draw with its own Gain.
    Returns [(vb (Nv, 8), ib (T, 3), {"Gain": (4,)})] on ``dev``."""
    import torch

    rng = np.random.default_rng(seed)
    draws = []
    for _ in range(n_draws):
        ctr = rng.uniform(-0.6, 0.6, (quads, 1, 2))
        half = rng.uniform(0.4, 1.0, (quads, 1, 2))
        corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)[None]
        xy = ctr + half * corners  # (quads, 4, 2)
        z = np.broadcast_to(rng.uniform(0.1, 0.9, (quads, 1, 1)), (quads, 4, 1))
        col = np.concatenate([rng.uniform(0.0, 1.5, (quads, 4, 3)),
                              rng.uniform(0.1, 0.5, (quads, 4, 1))], -1)
        vb = np.concatenate([xy, z, np.ones((quads, 4, 1)), col], -1).reshape(-1, 8)
        base = 4 * np.arange(quads)[:, None]
        tri_a = base + np.array([0, 1, 2])
        tri_b = base + np.array([0, 2, 3])
        flip = rng.uniform(size=quads) < 0.5  # back faces
        tri_a[flip] = tri_a[flip][:, ::-1]
        tri_b[flip] = tri_b[flip][:, ::-1]
        ib = np.stack([tri_a, tri_b], 1).reshape(-1, 3)
        gain = rng.uniform(0.5, 1.0, 4)
        draws.append((torch.from_numpy(vb.astype(np.float32)).to(dev),
                      torch.from_numpy(ib.astype(np.int32)).to(dev),
                      {"Gain": torch.from_numpy(gain.astype(np.float32)).to(dev)}))
    return draws


def blend_bound(bins, grid, shaded: int, frags: int, shader_ops: int, stencil: bool):
    """K5's (K6's with ``stencil``) bound: live rows and routing tables read once;
    the z, colour (and stencil) planes read and written once; the edge and
    depth work of each fragment and the interpolation, shader and blend of
    each shaded one."""
    a_n = (bins.rast_pad.shape[1] - 16) // 3
    hp, wp = grid.tiles_y * grid.tile_h, grid.tiles_x * grid.tile_w
    planes = 2 * (1 + 4 + (1 if stencil else 0)) * hp * wp
    nbytes = input_bytes(bins) + 4 * planes
    per_frag = K3_OPS_PER_FRAGMENT if stencil else K1_OPS_PER_FRAGMENT
    per_shaded = 5 * a_n + 1 + a_n + shader_ops + BLEND_OPS
    return bound(nbytes, frags * per_frag + shaded * per_shaded)


def ptxas_lines(log_path) -> "list[str]":
    """The compiler's report: each kernel's name, then its registers and
    spills."""
    out = []
    for ln in Path(log_path).read_text().splitlines():
        entry = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)(?:IL[ib](\d)E)?", ln)
        if entry:
            out.append(entry.group(1) + (f"<{entry.group(2)}>:" if entry.group(2) else ":"))
        elif "registers" in ln or "spill" in ln:
            out.append(ln.replace("ptxas info    :", "").strip())
    return out


def rect_host_cost(frame, card: str) -> None:
    """What the per-row rectangles (binning._row_rects) cost the deferred
    frame's host. At one camera, frames that compute them, as every frame
    does, run interleaved (A B B A) with frames that replay the rectangles a
    recorded frame computed: the same values, none of their launches. The
    replayed frame must equal the computed one bit for bit."""
    import itertools

    import torch

    from zenith_tpu_torch.ops import binning as binning_mod

    recorded = []
    real_row_rects = binning_mod._row_rects

    def recording(*args):
        recorded.append(real_row_rects(*args))
        return recorded[-1]

    with mock.patch.object(binning_mod, "_row_rects", recording):
        compiled, enc, _, _ = frame(0.3)
        computed_img = compiled.value(enc).cpu().numpy()
    replay = itertools.cycle(recorded)

    def run(replayed: bool) -> "tuple[float, np.ndarray]":
        patch = (mock.patch.object(binning_mod, "_row_rects", lambda *a: next(replay))
                 if replayed else contextlib.nullcontext())
        with patch:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(RECT_FRAMES):
                compiled, enc, _, _ = frame(0.3)
            img = compiled.value(enc).cpu().numpy()
        return (time.perf_counter() - t0) * 1e3 / RECT_FRAMES, img

    ms = {False: [], True: []}
    for replayed in (False, True, True, False):
        t, img = run(replayed)
        check(np.array_equal(img, computed_img),
              f"a frame with {'replayed' if replayed else 'computed'} rectangles differs")
        ms[replayed].append(t)
    a, b = np.mean(ms[False]), np.mean(ms[True])
    print(f"phase 7: per-row rectangles ({len(recorded)} binning._row_rects calls a frame, "
          f"12 launches each): computed {ms[False][0]:.3f} / {ms[False][1]:.3f} ms a frame, "
          f"replayed {ms[True][0]:.3f} / {ms[True][1]:.3f} ms (A B B A, {RECT_FRAMES} frames "
          f"each, one camera, wall clock): host cost {a - b:.3f} ms a frame "
          f"({(a - b) / a * 100:.2f}%); replayed frames bit-equal [{card}]")


def launches_under(event) -> int:
    """The kernel launches (``cudaLaunchKernel`` / ``cuLaunchKernel``
    calls) recorded under a host event of torch.profiler, at any depth."""
    n, stack = 0, list(event.cpu_children)
    while stack:
        child = stack.pop()
        n += child.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
        stack.extend(child.cpu_children)
    return n


def profile_frames(frame, nodes, tag: str, card: str, frame_ms, watch, expect,
                   frames: int = PROFILED_FRAMES) -> None:
    """Where the time goes. Kernels only (little host slow-down): device
    time, launches, the busy share, the heaviest kernels per frame and the
    device time of each kernel named in ``watch`` (a part of its name). Then
    host operators too, for each render-graph node's share of the kernel
    time. A one-frame session first keeps the profiler's start-up out of
    both. ``expect`` maps a part of a kernel's name to its launches a frame:
    where the profiler recorded another count (late in this process it has
    lost launches), the session's numbers are not printed. ``frames``
    frames are profiled a session."""
    import torch

    from zenith_tpu_torch.core import profile

    with profile.session(cpu=False):
        frame(0.3)
        torch.cuda.synchronize()
    for cpu in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile.session(cpu=cpu) as prof:
            for i in range(frames):
                frame(0.3 + i * 0.004)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
        events = prof.events()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = {(e.time_range.start, e.time_range.end, e.name) for e in kernels}
        seen = {part: sum(part in name for _, _, name in spans) for part in expect}
        lost = {part: n for part, n in seen.items() if n != expect[part] * frames}
        if lost:
            print(f"{tag}: the profiler recorded "
                  + ", ".join(f"{n} {part} launches (not {expect[part] * frames})"
                              for part, n in lost.items())
                  + f" in {frames} frames: its device times are not measured "
                  f"({'host operators + kernels' if cpu else 'kernels only'}) [{card}]")
            continue
        kernel_ms = sum(b - a for a, b, _ in spans) / 1e3 / frames
        busy_ms = union_us([(a, b) for a, b, _ in spans]) / 1e3 / frames
        p50 = np.percentile(frame_ms, 50)
        line = (f"{tag}: profile ({'host operators + kernels' if cpu else 'kernels only'}) "
                f"of {frames} frames: {len(spans) / frames:.0f} kernel "
                f"launches, {kernel_ms:.3f} ms kernel time, device busy {busy_ms:.3f} ms = "
                f"{busy_ms / wall_ms * 100:.1f}% of {wall_ms:.2f} ms wall per frame; "
                f"unprofiled frame time p50 {p50:.3f} ms")
        if not cpu:
            # The kernels-only profile barely slows the kernels: their time
            # against the unprofiled frame says which side sets the pace.
            idle = max(0.0, 1.0 - busy_ms / p50)
            line += (f", device idle {idle * 100:.1f}% of it: "
                     f"{'host-bound' if idle > 0.2 else 'device-bound'}")
        if cpu:
            node_ms = {n: sum(e.device_time_total for e in events if e.name == n) / 1e3
                       / frames for n in nodes}
            total = sum(node_ms.values()) or 1.0
            line += "; kernel time by node " + ", ".join(
                f"{n} {v:.3f} ms ({v / total * 100:.1f}%)" for n, v in node_ms.items())
            node_launches = {n: sum(launches_under(e) for e in events if e.name == n)
                             / frames for n in nodes}
            line += "; kernel launches by node " + ", ".join(
                f"{n} {v:.0f}" for n, v in node_launches.items())
        else:
            by_name = {}
            for a, b, name in spans:
                t, c = by_name.get(name, (0.0, 0))
                by_name[name] = (t + (b - a), c + 1)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
            line += "; heaviest kernels per frame: " + "; ".join(
                f"{name[:60]} {t / 1e3 / frames:.3f} ms x{c / frames:.0f}"
                for name, (t, c) in top)
            for part in watch:
                t = sum(b - a for a, b, name in spans if part in name) / 1e3 / frames
                c = sum(part in name for _, _, name in spans) / frames
                line += f"; {part} {t:.4f} ms x{c:.0f} per frame"
        print(line + f" [{card}]")


# The plain versions of K3, K4 and K5/K6, in the launchers' places (the
# counters stay put).
def plain_k3(b, g, z, acc, sten, front, back, compare, write, clamp, off):
    from zenith_tpu_torch.ops import raster as raster_mod

    raster_mod._raster_segmented_torch(b, g, z, acc, compare, write, clamp, off,
                                       stencil=sten, faces=(front, back))


def plain_k4(b, g, z, acc, bnd, bound_op, compare, write, clamp, off):
    from zenith_tpu_torch.ops import raster as raster_mod

    # Bins without rectangles take the rank walk, which culls nothing.
    raster_mod._raster_segmented_torch(b._replace(rect=None), g, z, acc, compare, write,
                                       clamp, off, z_bound=bnd, bound_op=bound_op)


def plain_k56(b, g, z, color, sten, faces, compare, write, clamp, off, fs, layout, cdesc):
    from zenith_tpu_torch.ops import draw as draw_mod
    from zenith_tpu_torch.ops import raster as raster_mod

    shade_blend = draw_mod.make_shade_blend(fs, layout, cdesc, (0.0, 0.0, 0.0, 0.0),
                                            (g.width, g.height))
    raster_mod._raster_blend_torch(b, g, z, color, sten, faces, compare, write, clamp, off,
                                   shade_blend)


@contextlib.contextmanager
def plain_versions(plain_k1):
    """Every raster kernel's and K2's plain version in its launcher's place
    (the launch counters stay put); ``plain_k1`` is K1's."""
    from zenith_tpu_torch.ops import lighting as lighting_mod
    from zenith_tpu_torch.ops import raster as raster_mod

    with contextlib.ExitStack() as stack:
        for mod, name, fn in ((raster_mod, "_raster_segmented_cuda", plain_k1),
                              (raster_mod, "_raster_stencil_cuda", plain_k3),
                              (raster_mod, "_raster_peel_cuda", plain_k4),
                              (raster_mod, "_raster_blend_cuda", plain_k56),
                              (lighting_mod, "_accumulate_point_lights_cuda", plain_k2)):
            stack.enter_context(mock.patch.object(mod, name, fn))
        yield


def resolve_k1(b, g, z, acc, compare, write, clamp, off):
    """K1's plain version as it runs for bins with rectangles (the per-pixel
    resolve, bit-equal to the rank walk): fast enough for whole 1080p frames
    of a million triangles. Phases 15-18 hold K1 itself against the
    unculled walk on their own passes."""
    from zenith_tpu_torch.ops import raster as raster_mod

    raster_mod._raster_segmented_torch(b, g, z, acc, compare, write, clamp, off)


def resolved_plain_path():
    """``plain_versions`` with ``resolve_k1`` as K1's: the plain path of the
    whole frames in phases 15-18."""
    return plain_versions(resolve_k1)


def sync_free(engine, app, tag, what="a retained frame"):
    """Run ``engine``'s retained frame once more with host syncs made errors."""
    import torch

    compiled = engine._retained[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        compiled.execute(engine.render_device, dynamics=app.update_dynamics())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"{tag}: {what} made no host sync")


def translucency_phases(dev, card: str, stress, plain_k1) -> "tuple[list, dict]":
    """Phases 8-12: K3-K6 against their plain versions at 1920x1080, the
    deferred main path with glass in both modes, and a stencil-attachment
    frame through the render graph. ``stress`` is phase 2b's (bins, grid,
    init z). Returns (the records of K3-K6, the launches of K1 and K2 on
    these paths)."""
    import torch

    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree
    from zenith_tpu_torch.ops import draw as draw_mod
    from zenith_tpu_torch.ops import runtime
    from zenith_tpu_torch.ops.binning import TileGrid, bin_segmented, tile_overlap
    from zenith_tpu_torch.ops.geometry import setup_with_attrs
    from zenith_tpu_torch.ops.lighting import accumulate_point_lights
    from zenith_tpu_torch.ops.raster import raster_segmented, raster_segmented_blend
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.renderer import DeferredRenderer
    from zenith_tpu_torch.rhi import (
        BlendFactor,
        BlendOp,
        Buffer,
        ColorAttachmentDesc,
        Format,
        GraphicShaderInput,
        LoadOp,
        PipelineCache,
        RasterizationState,
        RhiCore,
        Shader,
        TextureDesc,
        uniform,
    )
    from zenith_tpu_torch.rhi import pipeline as pipe
    from zenith_tpu_torch.rhi.state import (
        CompareOp,
        CullMode,
        DepthStencilDesc,
        GraphicPipelineAttachments,
        GraphicPipelineState,
        StencilOp,
        StencilOpState,
        VertexLayout,
    )
    from zenith_tpu_torch.sandbox.scene import build_standin_scene, deferred_frame, orbit_camera

    bins, grid, init = stress
    hp, wp = grid.tiles_y * grid.tile_h, grid.tiles_x * grid.tile_w
    rng = np.random.default_rng(29)

    def plain_path():
        return plain_versions(plain_k1)

    def both(fn):
        """(kernel result, plain result) of ``fn()``, synchronised."""
        k = fn()
        with plain_path():
            p = fn()
        torch.cuda.synchronize()
        return k, p

    def exact(k, p, what, names):
        for a, b, name in zip(k, p, names):
            check(torch.equal(a, b), f"{what}: {name} differs from the plain version "
                  f"(max {(a.float() - b.float()).abs().max().item():.3e})")

    def timed(fn, reps=10):
        """(kernel ms, plain ms): medians by CUDA events; the plain version
        runs for seconds, so it is timed twice, not warmed up."""
        k_ms = cuda_ms(fn, reps=reps, warmup=2)
        with plain_path():
            p_ms = cuda_ms(fn, reps=2, warmup=0)
        return k_ms, p_ms

    def record(name, num, source, replaces, shape, err, k_ms, p_ms, b_ms, b_by):
        return {"name": f"K{num} {name}", "route": "cuda",
                "source": f"zenith_tpu_torch/csrc/{source}",
                "replaces": f"zenith_tpu/ops/raster.py:{replaces}", "launches": 0,
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None, "shape": shape}

    def kept(v):
        return v.clone() if torch.is_tensor(v) else v

    @contextlib.contextmanager
    def recording():
        """The inputs of every K3, K4, K5 and K6 wrapper call that ops.draw
        makes inside, by kernel: (bins, grid, z, keywords) for K3 and K4,
        (bins, grid, z, colour, shade_blend, keywords) for K5 and K6."""
        calls = {"K3": [], "K4": [], "K5": [], "K6": []}
        real_raster, real_blend = draw_mod.raster_segmented, draw_mod.raster_segmented_blend

        def raster(b, g, z, **kw):
            key = ("K4" if kw.get("z_bound") is not None
                   else "K3" if kw.get("stencil_front") is not None else None)
            if key:
                calls[key].append((b, g, z.clone(), {k: kept(v) for k, v in kw.items()}))
            return real_raster(b, g, z, **kw)

        def blend(b, g, z, c, shade_blend, **kw):
            key = "K6" if kw.get("stencil_front") is not None else "K5"
            calls[key].append((b, g, z.clone(), c.clone(), shade_blend,
                               {k: kept(v) for k, v in kw.items()}))
            return real_blend(b, g, z, c, shade_blend, **kw)

        with mock.patch.object(draw_mod, "raster_segmented", raster), \
                mock.patch.object(draw_mod, "raster_segmented_blend", blend):
            yield calls

    def replay(call):
        """The wrapper call that ``recording`` kept, as a function."""
        if len(call) == 4:
            b, g, z, kw = call
            return lambda: raster_segmented(b, g, z, **kw)
        b, g, z, c, shade_blend, kw = call
        return lambda: raster_segmented_blend(b, g, z, c, shade_blend, **kw)

    blend_err = {5: 0.0, 6: 0.0}

    def hold_blend(num, what, call):
        """A recorded K5 / K6 call against its plain version: z (and stencil)
        bit-equal, colour within atol 1e-5 + rtol 1e-5. Returns (kernel
        result, plain result, max colour error)."""
        k, p = both(replay(call))
        check(bool(torch.isfinite(k[1]).all()), f"K{num} {what}: non-finite colour")
        exact((k[0], *k[2:]), (p[0], *p[2:]), f"K{num} {what}", ("z", "stencil"))
        err = (k[1] - p[1]).abs()
        blend_err[num] = max(blend_err[num], err.max().item())
        bad = int((err > 1e-5 + 1e-5 * p[1].abs()).sum())
        check(bad == 0, f"K{num} {what}: {bad} colour values beyond atol 1e-5 + rtol 1e-5 of "
              f"the plain version (max {err.max().item():.3e})")
        return k, p, err.max().item()

    # Every fragment shader these phases draw with was compiled in phase 1.
    builds_at_start = runtime.shader_builds

    def no_new_build(where):
        check(runtime.shader_builds == builds_at_start,
              f"{where}: a blend kernel was compiled here, so the layout phase 1 built for "
              f"is not the one the draw uses")

    a_n = (bins.rast_pad.shape[1] - 16) // 3
    plane_bytes = 4 * hp * wp
    frags = k1_fragments(bins, grid)

    # -- 8. K3 on the stress draw: a stencil-write, then a stencil-masked draw --
    s0 = torch.from_numpy(rng.integers(0, 256, (H, W)).astype(np.int32)).to(dev)
    write_front = StencilOpState(pass_op=StencilOp.REPLACE,
                                 depth_fail_op=StencilOp.INCREMENT_AND_WRAP,
                                 compare_op=CompareOp.ALWAYS, write_mask=0xF3, reference=0x5A)
    write_back = StencilOpState(pass_op=StencilOp.INCREMENT_AND_WRAP,
                                depth_fail_op=StencilOp.INVERT,
                                compare_op=CompareOp.ALWAYS, write_mask=0xBF)
    mask_front = StencilOpState(fail_op=StencilOp.DECREMENT_AND_CLAMP,
                                pass_op=StencilOp.INCREMENT_AND_CLAMP,
                                depth_fail_op=StencilOp.ZERO, compare_op=CompareOp.LESS,
                                compare_mask=0x0F, reference=0x05)
    mask_back = StencilOpState(fail_op=StencilOp.ZERO, pass_op=StencilOp.KEEP,
                               depth_fail_op=StencilOp.DECREMENT_AND_WRAP,
                               compare_op=CompareOp.NOT_EQUAL, compare_mask=0xF0,
                               write_mask=0x7E, reference=0x20)

    def k3_write():
        return raster_segmented(bins, grid, init, init_stencil=s0, stencil_front=write_front,
                                stencil_back=write_back)

    k, p = both(k3_write)
    exact(k, p, "K3 stencil write", ("z", "planes", "stencil"))
    s1 = k[2]
    check(not torch.equal(s1, s0), "K3 stencil write left the stencil plane unchanged")

    def k3_masked():
        return raster_segmented(bins, grid, init, init_stencil=s1, stencil_front=mask_front,
                                stencil_back=mask_back, compare_op=CompareOp.GREATER_OR_EQUAL,
                                depth_write=False)

    km, pm = both(k3_masked)
    exact(km, pm, "K3 stencil-masked draw", ("z", "planes", "stencil"))
    open_cov = int((raster_segmented(bins, grid, init, compare_op=CompareOp.GREATER_OR_EQUAL,
                                     depth_write=False)[1][-1] > 0).sum())
    mask_cov = int((km[1][-1] > 0).sum())
    check(0 < mask_cov < open_cov, f"K3: the mask passed {mask_cov} of {open_cov} pixels")
    k3_ms, k3_plain = timed(k3_write)
    cov3 = int((k[1][-1] > 0).sum())
    k3_b, k3_by = bound(
        input_bytes(bins) + (4 + a_n) * plane_bytes,
        frags * K3_OPS_PER_FRAGMENT + cov3 * a_n * K1_OPS_PER_PIXEL_PLANE)
    print(f"phase 8: K3 stress 1080p ({int(bins.blk_count.sum())} entries, {frags} fragments): "
          f"stencil write (faces differ, REPLACE / INCREMENT_AND_WRAP / INVERT, write masks "
          f"0xF3 / 0xBF) and stencil-masked draw (LESS under mask 0x0F / NOT_EQUAL under 0xF0, "
          f"fail, depth-fail and pass ops; {mask_cov} of {open_cov} px pass) bit-equal to the "
          f"plain version in z, planes and stencil; write pass kernel {k3_ms:.4f} ms, plain "
          f"{k3_plain:.4f} ms, bound {k3_b:.4f} ms ({k3_by}); no one-call PyTorch equivalent "
          f"[{card}]")
    k3 = record("segmented raster + stencil (_segmented_stencil_kernel)", 3, "raster.cu", 1025,
                "stress draw 1080p, stencil write", 0.0, k3_ms, k3_plain, k3_b, k3_by)

    # -- 9. K4 on the stress draw: two chained peels and the overflow probe ----
    def peel_chain(b, g, z0, what):
        """Layer 1 is K1's; layers 2, 3 and the probe are K4's, each bounded
        by the layer before. Returns the last bound."""
        bound_z = raster_segmented(b, g, z0)[0]
        for layer in (2, 3):
            def run(bz=bound_z):
                return raster_segmented(b, g, z0, z_bound=bz)
            k, p = both(run)
            exact(k, p, f"K4 {what} layer {layer}", ("z", "planes"))
            check(int((k[1][-1] > 0).sum()) > 0, f"K4 {what} layer {layer} is empty")
            bound_z = k[0]

        def probe(bz=bound_z):
            return raster_segmented(b, g, z0, z_bound=bz, depth_write=False)
        k, p = both(probe)
        exact(k, p, f"K4 {what} probe", ("z", "planes"))
        return bound_z, int((k[1][-1] > 0).sum())

    _, deeper = peel_chain(bins, grid, init, "stress")
    layer1 = raster_segmented(bins, grid, init)[0]

    def k4_stress():
        return raster_segmented(bins, grid, init, z_bound=layer1)

    k4s_ms, k4s_plain = timed(k4_stress)
    cov4 = int((k4_stress()[1][-1] > 0).sum())
    k4s_b, k4s_by = bound(
        input_bytes(bins) + (3 + a_n) * plane_bytes,
        frags * K4_OPS_PER_FRAGMENT + cov4 * a_n * K1_OPS_PER_PIXEL_PLANE)
    print(f"phase 9: K4 stress 1080p: peel layers 2 and 3 and the probe (depth write off; "
          f"{deeper} px hold a deeper layer) bit-equal to the plain version; layer 2 kernel "
          f"{k4s_ms:.4f} ms, plain {k4s_plain:.4f} ms, bound {k4s_b:.4f} ms ({k4s_by}) [{card}]")

    # -- 10. K5 and K6 on many overlapping translucent quads --------------------
    layout = VertexLayout.from_fields(("position", 4), ("color", 4))
    vs = Shader.vertex("stress.vs", lambda attrs, res: {"position": attrs["position"],
                                                       "color": attrs["color"]})
    fs = Shader.fragment("stress.fs", stress_fs, bindings=[uniform("Gain")], kernel_safe=True,
                         device_source=STRESS_FS_CUDA)
    over = ColorAttachmentDesc(blend_enable=True, src_color_blend=BlendFactor.SRC_ALPHA,
                               dst_color_blend=BlendFactor.ONE_MINUS_SRC_ALPHA,
                               src_alpha_blend=BlendFactor.ONE,
                               dst_alpha_blend=BlendFactor.ONE_MINUS_SRC_ALPHA)
    odd = ColorAttachmentDesc(blend_enable=True, src_color_blend=BlendFactor.ONE_MINUS_DST_ALPHA,
                              dst_color_blend=BlendFactor.SRC_COLOR,
                              color_blend_op=BlendOp.REVERSE_SUBTRACT,
                              src_alpha_blend=BlendFactor.DST_ALPHA,
                              dst_alpha_blend=BlendFactor.ONE, alpha_blend_op=BlendOp.MAX,
                              write_mask=(True, True, False, True))
    mask_ro_front = StencilOpState(compare_op=CompareOp.EQUAL, compare_mask=0x01, reference=1)
    mask_ro_back = StencilOpState(compare_op=CompareOp.NOT_EQUAL, compare_mask=0x01, reference=1)
    limit_front = StencilOpState(pass_op=StencilOp.INCREMENT_AND_CLAMP,
                                 depth_fail_op=StencilOp.INVERT, compare_op=CompareOp.GREATER,
                                 write_mask=0x7F, reference=6)
    limit_back = StencilOpState(fail_op=StencilOp.DECREMENT_AND_WRAP,
                                pass_op=StencilOp.INCREMENT_AND_WRAP,
                                compare_op=CompareOp.GREATER_OR_EQUAL, compare_mask=0x0F,
                                reference=3)

    def blend_pipeline(cdesc, ds):
        return pipe.GraphicPipeline(pipe.GraphicPipelineDesc(
            shader_input=GraphicShaderInput(vs, fs, layout),
            state=GraphicPipelineState(
                rasterization=RasterizationState(cull_mode=CullMode.NONE), depth_stencil=ds),
            attachments=GraphicPipelineAttachments(
                color_formats=(Format.RGBA32F,), depth_format=Format.D32F,
                stencil_format=Format.S8 if ds.stencil_test_enable else None),
            color_attachment_descs=(cdesc,),
        ))

    draws = translucent_stress(dev)
    n_tri = sum(d[1].shape[0] for d in draws)
    bg = torch.from_numpy(rng.uniform(0.0, 4.0, (H, W, 4)).astype(np.float32)).to(dev)
    sten0 = torch.from_numpy(rng.integers(0, 4, (H, W)).astype(np.int32)).to(dev)
    translucent = DepthStencilDesc(depth_test_enable=True, depth_write_enable=False,
                                   depth_compare_op=CompareOp.GREATER)
    writing = DepthStencilDesc(depth_test_enable=True, depth_write_enable=True,
                               depth_compare_op=CompareOp.GREATER_OR_EQUAL)

    def with_stencil(ds, front, back):
        return dataclasses.replace(ds, stencil_test_enable=True, stencil_front=front,
                                   stencil_back=back)

    def check_blend(num, what, k, p):
        """z (and stencil) bit-equal; colour within atol 1e-5 + rtol 1e-5."""
        (kc, kz, ks), (pc, pz, ps) = k, p
        check(bool(torch.isfinite(kc[0]).all()), f"K{num} {what}: non-finite colour")
        exact((kz,), (pz,), f"K{num} {what}", ("z",))
        if ks.stencil is not None:
            exact((ks.stencil,), (ps.stencil,), f"K{num} {what}", ("stencil",))
        err = (kc[0] - pc[0]).abs()
        blend_err[num] = max(blend_err[num], err.max().item())
        bad = int((err > 1e-5 + 1e-5 * pc[0].abs()).sum())
        check(bad == 0, f"K{num} {what}: {bad} colour values beyond atol 1e-5 + rtol 1e-5 of "
              f"the plain version (max {err.max().item():.3e})")
        return err.max().item()

    cases = [
        (5, "src-alpha over, depth write off", over, translucent, None),
        (5, "reverse-subtract / max, write mask RGA, depth write on", odd, writing, None),
        (6, "over, read-only stencil mask (faces differ)", over,
         with_stencil(translucent, mask_ro_front, mask_ro_back), sten0),
        (6, "over, overdraw limiter (INCREMENT_AND_CLAMP / INVERT / wrap ops)", over,
         with_stencil(writing, limit_front, limit_back), sten0),
    ]
    stress_blend = {}
    for num, what, cdesc, ds, sten in cases:
        pl = blend_pipeline(cdesc, ds)

        def run(pl=pl, sten=sten):
            return draw_mod.draw_indexed_batch([bg], init, pl, draws, grid, stencil=sten,
                                               entry_budget=STRESS_ENTRY_BUDGET)

        with recording() as calls:
            k = run()
        no_new_build(f"K{num} stress")
        with plain_path():
            p = run()
        torch.cuda.synchronize()
        err = check_blend(num, what, k, p)
        check(not torch.equal(k[0][0], bg), f"K{num} {what}: nothing was drawn")
        check(int(k[2].bin_overflow) == 0, f"K{num} {what}: bin overflow")
        print(f"phase 10: K{num} stress 1080p, {what}: z{' and stencil' if sten is not None else ''}"
              f" bit-equal, colour max |kernel - plain| {err:.3e} (values up to "
              f"{p[0][0].abs().max().item():.3f})")
        if num not in stress_blend:
            check(len(calls[f"K{num}"]) == 1, f"K{num} stress made {len(calls[f'K{num}'])} "
                  f"blend passes, not 1")
            stress_blend[num] = (calls[f"K{num}"][0], ds)
    blend_records = {}
    for num, (call, ds) in stress_blend.items():
        b, g = call[0], call[1]
        run = replay(call)
        front_col = 16 + (b.rast_pad.shape[1] - 16) // 3 - 2

        def passes(rows, zpx, py, px, ds=ds):
            ok = zpx > init[py, px]
            if ds.stencil_test_enable:
                s = sten0[py, px] & 1
                is_front = (rows[:, front_col] > 0)[:, None, None]
                ok = ok & torch.where(is_front, s == 1, s != 1)
            return ok

        n_frag, n_shaded = count_fragments(b, g, passes)
        k_ms, p_ms = timed(run, reps=5)
        dev_ms = device_ms(run, "raster_blend_kernel", reps=5)
        b_ms, b_by = blend_bound(b, g, n_shaded, n_frag, STRESS_SHADER_OPS, num == 6)
        print(f"phase 10: K{num} stress 1080p ({len(draws)} draws, {n_tri} triangles, "
              f"{int(b.blk_count.sum())} entries, {n_frag} fragments, {n_shaded} shaded, up to "
              f"{int(b.blk_count.sum()) // (g.tiles_x * g.tiles_y)} entries a tile on average): "
              f"kernel {k_ms:.4f} ms (wrapper call; the kernel alone {dev_ms:.4f} ms of device "
              f"time), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); before the redesign "
              f"{BEFORE_MS[f'K{num} stress']} ms; no one-call PyTorch equivalent [{card}]")
        blend_records[num] = (k_ms, p_ms, b_ms, b_by)

    def print_ptxas(tag, call):
        """The compiler's report of the blend kernel this recorded call ran."""
        kw = call[5]
        lib = runtime.load_blend_kernel(kw["fragment_shader"].device_source, kw["attr_layout"])
        no_new_build(f"ptxas report ({tag})")
        for ln in ptxas_lines(lib.log_path):
            print(f"  ptxas ({tag}): {ln}")

    print_ptxas("stress shader", stress_blend[5][0])

    # -- 10b. K5 and K6's cull on phase 2c's hard cases --------------------------
    # Phase 2c's records (near-clipped triangles reaching far off-screen,
    # needles and slivers, corners on sample points) drawn translucent with
    # the stress shader's columns, at sample offset CULL_OFFSET.
    c_clip, c_idx, c_col = cull_stress_scene()
    nv = c_clip.shape[0]
    c_rng = np.random.default_rng(31)
    per_tri = np.concatenate([np.arange(nv // 3)[:, None] % 8,  # __draw_id
                              c_rng.uniform(0.5, 1.0, (nv // 3, 4))], 1)  # __u_Gain
    vary = np.concatenate([c_col, c_rng.uniform(0.1, 0.6, (nv, 1)), np.repeat(per_tri, 3, 0)],
                          1).astype(np.float32)
    c_rec, c_corner = setup_with_attrs(
        *(torch.from_numpy(a).to(dev) for a in (c_clip, c_idx, vary)), W, H,
        cull_mode=CullMode.NONE)

    def cull_bins(g):
        entries = int(tile_overlap(c_rec, g).sum())
        b = bin_segmented(c_rec, c_corner, g, mid_cap=8192, huge_cap=4096, entry_budget=entries)
        check(int(b.overflow) == 0, "blend cull stress: the binning dropped entries")
        check(b.rast_pad.shape[1] == 16 + 3 * (sum(ch for _, ch in STRESS_LAYOUT) + 1),
              "blend cull stress: the records do not carry the stress shader's columns")
        return b, entries

    # 8x32 tiles too: a tile is half a 16x16 sub-region, so half of each
    # CTA's warps own no pixel of it.
    small = TileGrid(W, H, 8, 32)
    c_bins = {grid: cull_bins(grid), small: cull_bins(small)}
    cull_cases = [
        (5, "src-alpha over, depth write off", over, CompareOp.GREATER, False, None, grid),
        (5, "reverse-subtract / max, write mask RGA, depth write on", odd,
         CompareOp.GREATER_OR_EQUAL, True, None, grid),
        (6, "over, read-only stencil mask (faces differ)", over, CompareOp.GREATER, False,
         (mask_ro_front, mask_ro_back), grid),
        (6, "over, overdraw limiter", over, CompareOp.GREATER_OR_EQUAL, True,
         (limit_front, limit_back), grid),
        (6, "over, overdraw limiter, 8x32 tiles", over, CompareOp.GREATER_OR_EQUAL, True,
         (limit_front, limit_back), small),
    ]
    for num, what, cdesc, cmp, write, faces, cgrid in cull_cases:
        cb, c_entries = c_bins[cgrid]
        kw = dict(compare_op=cmp, depth_write=write, sample_offset=CULL_OFFSET,
                  fragment_shader=fs, attr_layout=STRESS_LAYOUT, color_desc=cdesc)
        if faces is not None:
            kw.update(init_stencil=sten0, stencil_front=faces[0], stencil_back=faces[1])

        def run(kw=kw, cb=cb, cgrid=cgrid):
            return raster_segmented_blend(cb, cgrid, init, bg, None, **kw)

        k, p = both(run)
        no_new_build(f"K{num} cull stress")
        check(bool(torch.isfinite(k[1]).all()), f"K{num} cull stress {what}: non-finite colour")
        exact((k[0], *k[2:]), (p[0], *p[2:]), f"K{num} cull stress {what}", ("z", "stencil"))
        err = (k[1] - p[1]).abs()
        blend_err[num] = max(blend_err[num], err.max().item())
        bad = int((err > 1e-5 + 1e-5 * p[1].abs()).sum())
        check(bad == 0, f"K{num} cull stress {what}: {bad} colour values beyond atol 1e-5 + "
              f"rtol 1e-5 of the plain version (max {err.max().item():.3e})")
        drawn = int((k[1] != bg).any(-1).sum())
        check(drawn > 10000, f"K{num} cull stress {what}: only {drawn} px drawn")
        print(f"phase 10b: K{num} cull stress 1080p, offset {CULL_OFFSET}, {what}: "
              f"{c_entries} entries, {drawn} px drawn; z{' and stencil' if faces else ''} "
              f"bit-equal, colour max |kernel - plain| {err.max().item():.3e} [{card}]")

    # -- 11. the deferred main path with glass, in both modes ------------------
    device = RhiCore(dev).create_render_device()
    camera = Camera(fov_y=Degree(35.0), aspect_ratio=W / H)
    options = CompileOptions()
    bgra = Format.BGRA8_SRGB
    counters = {
        "K1": (raster_segmented, "launches"), "K2": (accumulate_point_lights, "launches"),
        "K3": (raster_segmented, "stencil_launches"), "K4": (raster_segmented, "peel_launches"),
        "K5": (raster_segmented_blend, "launches"),
        "K6": (raster_segmented_blend, "stencil_launches"),
    }

    def read_counts():
        return {k: getattr(fn, name) for k, (fn, name) in counters.items()}

    def zero_counts():
        for fn, name in counters.values():
            setattr(fn, name, 0)

    path_launches = {k: 0 for k in counters}
    glass_inputs = {}
    modes = (("kernel", False, {"K1": 2, "K2": 1, "K5": 1}),
             ("peel", True, {"K1": 3, "K2": 1, "K4": 4}))
    for mode, textured, expect in modes:
        scene, _ = build_standin_scene(device, 100, np.random.default_rng(42), glass=True,
                                       glass_textured=textured)
        renderer = DeferredRenderer(scene, glass_mode=mode, glass_peel_layers=4)
        cache = PipelineCache()

        def frame(orbit, renderer=renderer, cache=cache):
            orbit_camera(camera, orbit)
            return deferred_frame(device, renderer, camera, W, H, options, present_format=bgra,
                                  pipeline_cache=cache)

        # Warm-up: builds the frame function and (kernel mode) finds the
        # glass shader's kernel; the frame's K4 / K5 inputs are kept.
        with recording() as calls:
            frame(0.3)
        torch.cuda.synchronize()
        no_new_build(f"glass {mode} warm-up")
        glass_inputs[mode] = calls["K5"] if mode == "kernel" else calls["K4"]

        zero_counts()
        ends, overflows, per_frame = [], [], []
        t0 = time.perf_counter()
        for i in range(GLASS_FRAMES):
            start = read_counts()
            compiled, enc, _, retired = frame(0.3 + i * 0.004)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
            overflows.append(retired.bin_overflow)
            now = read_counts()
            per_frame.append({k: now[k] - start[k] for k in now})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        for k in counts:
            path_launches[k] += counts[k]
        no_new_build(f"glass {mode} timed frames")
        for k, n in expect.items():
            check(all(f[k] == n for f in per_frame),
                  f"glass {mode}: {k} launched {sorted({f[k] for f in per_frame})} times a "
                  f"frame, not {n}")
        total_overflow = int(torch.stack(overflows).sum())
        check(total_overflow == 0, f"glass {mode}: bin overflow {total_overflow}")
        frame_ms = np.array([ends[i - 1].elapsed_time(ends[i]) for i in range(1, len(ends))])
        last = compiled.value(enc).cpu().numpy()
        check(last.shape == (H, W, 4) and last.dtype == np.uint8, f"frame is {last.shape}")
        print(f"phase 11: glass {mode} ({'64^2 checker, 4 layers' if textured else 'untextured'}"
              f"): {GLASS_FRAMES} frames at {W}x{H}, 100 lights, 2 panes: "
              f"{GLASS_FRAMES / wall:.2f} FPS; frame time p50 {np.percentile(frame_ms, 50):.3f} "
              f"ms, p99 {np.percentile(frame_ms, 99):.3f} ms; launches per frame "
              + ", ".join(f"{k} {n}" for k, n in expect.items())
              + f"; bin overflow 0; no shader build in the timed frames [{card}]")

        # The last frame against the same frame through every plain version,
        # and against the frame without the panes (the glass really drew).
        orbit_camera(camera, 0.3 + (GLASS_FRAMES - 1) * 0.004)
        with plain_path():
            pc, penc, _, _ = deferred_frame(device, renderer, camera, W, H, options,
                                            present_format=bgra, pipeline_cache=cache)
            ref = pc.value(penc).cpu().numpy()
        mx, frac = lsb_diff(last, ref)
        print(f"phase 11: glass {mode}: last frame vs the plain-path frame: max LSB diff {mx}, "
              f"{frac * 100:.4f}% values differ")
        check(mx <= 1 and frac < 0.01, f"glass {mode}: the last frame differs from the "
              f"plain-path frame")
        bare = dataclasses.replace(scene, objects=scene.objects[:2])
        bc, benc, _, _ = deferred_frame(device, DeferredRenderer(bare), camera, W, H, options,
                                        present_format=bgra)
        changed = float((bc.value(benc).cpu().numpy() != last).any(-1).mean())
        check(changed > 0.02, f"glass {mode}: the panes changed only {changed * 100:.2f}% of "
              f"the pixels")
        print(f"phase 11: glass {mode}: the panes change {changed * 100:.2f}% of the pixels")

        # The panes stand side by side, so no pixel of the frames above holds
        # two glass layers. One more frame with the second pane moved to the
        # middle and nearer the camera, half over the first: pixels with two
        # layers, which order (K5) or the second peel (K4) must resolve.
        pane = scene.objects[3]
        home = pane.model_matrix
        shift = np.eye(4, dtype=np.float32)
        shift[:2, 3] = (-home[0, 3], -0.5 * home[0, 3])
        pane.model_matrix = shift @ home
        try:
            with recording() as calls:
                oc, oenc, _, oret = deferred_frame(device, renderer, camera, W, H, options,
                                                   present_format=bgra, pipeline_cache=cache)
            lapped = oc.value(oenc).cpu().numpy()
            with plain_path():
                pc, penc, _, _ = deferred_frame(device, renderer, camera, W, H, options,
                                                present_format=bgra, pipeline_cache=cache)
                ref = pc.value(penc).cpu().numpy()
        finally:
            pane.model_matrix = home
        check(int(oret.bin_overflow) == 0, f"glass {mode}, overlapping panes: bin overflow")
        mx, frac = lsb_diff(lapped, ref)
        check(mx <= 1 and frac < 0.01, f"glass {mode}, overlapping panes: the frame differs "
              f"from the plain-path frame (max LSB diff {mx}, {frac * 100:.4f}% of values)")
        check(bool((lapped != last).any()), f"glass {mode}: moving a pane changed nothing")
        if mode == "kernel":
            check(len(calls["K5"]) == 1, "overlapping panes: not one K5 pass")
            hold_blend(5, "overlapping panes", calls["K5"][0])
            what = "K5 z bit-equal and colour within tolerance of its plain version"
        else:
            check(len(calls["K4"]) == 4, "overlapping panes: not four K4 passes")
            layer_px = []
            for i, call in enumerate(calls["K4"]):
                k, p = both(replay(call))
                exact(k, p, f"K4 overlapping panes pass {i + 2}", ("z", "planes"))
                layer_px.append(int((k[1][-1] > 0).sum()))
            check(layer_px[0] > 1000 and layer_px[1:] == [0, 0, 0],
                  f"overlapping panes: layers 2-4 and the probe hold {layer_px} px; expected a "
                  f"second layer and nothing deeper")
            what = (f"K4's layer 2 holds {layer_px[0]} px, layers 3-4 and the probe none, all "
                    f"bit-equal to the plain version")
        print(f"phase 11: glass {mode}, one pane moved half over the other: frame vs the "
              f"plain-path frame max LSB diff {mx}, {frac * 100:.4f}% values differ; {what}")

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            compiled.execute(device, dynamics=renderer.frame_dynamics(camera))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print(f"phase 11: glass {mode}: a retained frame at 1080p made no host sync")
        profile_frames(frame, ("shadow", "gbuffer", "lighting", "glass", "post",
                               "present.encode"), f"phase 11: glass {mode}", card, frame_ms,
                       watch=("tiled_lights_kernel", "raster_segmented_kernel",
                              "raster_blend_kernel"),
                       # K1, K4 (peel) and K3 are instances of one template.
                       expect={"raster_segmented_kernel": sum(
                           n for k, n in expect.items() if k in ("K1", "K3", "K4")),
                               "tiled_lights_kernel": 1,
                               "raster_blend_kernel": expect.get("K5", 0)})

    # K5 at the glass node's own inputs: the panes over the lit HDR frame.
    check(len(glass_inputs["kernel"]) == 1, "the kernel-mode glass node made "
          f"{len(glass_inputs['kernel'])} blend passes, not 1")
    b, g, z = glass_inputs["kernel"][0][:3]
    glass_k5 = replay(glass_inputs["kernel"][0])
    k, p, err = hold_blend(5, "glass panes", glass_inputs["kernel"][0])
    n_frag, n_shaded = count_fragments(b, g, lambda rows, zpx, py, px: zpx > z[py, px])
    k5_ms, k5_plain = timed(glass_k5)
    k5_dev = device_ms(glass_k5, "raster_blend_kernel")
    k5_b, k5_by = blend_bound(b, g, n_shaded, n_frag, GLASS_SHADER_OPS, False)
    a_glass = (b.rast_pad.shape[1] - 16) // 3
    print(f"phase 11: K5 glass panes 1080p over the lit HDR frame ({int(b.blk_count.sum())} "
          f"entries, {n_frag} fragments, {n_shaded} shaded, a_n {a_glass}): z bit-equal, colour "
          f"max |kernel - plain| {err:.3e} (values up to "
          f"{p[1].abs().max().item():.3f}); kernel {k5_ms:.4f} ms (wrapper call; the kernel "
          f"alone {k5_dev:.4f} ms of device time), plain {k5_plain:.4f} ms, bound {k5_b:.4f} ms "
          f"({k5_by}); before the redesign {BEFORE_MS['K5 glass panes']} ms; no one-call PyTorch "
          f"equivalent [{card}]")
    print_ptxas("glass shader", glass_inputs["kernel"][0])

    # K4 at the peel-mode glass node's own inputs (layers 2-4 and the probe).
    check(len(glass_inputs["peel"]) == 4, "the peel-mode glass node made "
          f"{len(glass_inputs['peel'])} bounded passes, not 4")
    k4_glass = None
    for i, call in enumerate(glass_inputs["peel"]):
        b4, g4 = call[0], call[1]
        run = replay(call)
        k, p = both(run)
        exact(k, p, f"K4 glass panes pass {i + 2}", ("z", "planes"))
        cov = int((k[1][-1] > 0).sum())
        check(cov == 0, f"K4 glass panes pass {i + 2} holds {cov} px, but the panes stand side "
              f"by side: no pixel has a second glass layer")
        if i == 0:
            n_frag = k1_fragments(b4, g4)
            a4 = k[1].shape[0]
            t_k, t_p = timed(run)
            b_ms, b_by = bound(
                input_bytes(b4) + (3 + a4) * plane_bytes,
                n_frag * K4_OPS_PER_FRAGMENT + cov * a4 * K1_OPS_PER_PIXEL_PLANE)
            k4_glass = (t_k, t_p, b_ms, b_by)
            print(f"phase 11: K4 glass panes 1080p, layer 2 ({int(b4.blk_count.sum())} entries, "
                  f"{n_frag} fragments, {cov} px in the layer, a_n {a4}): bit-equal; kernel "
                  f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}); no one-call "
                  f"PyTorch equivalent [{card}]")
    print("phase 11: K4 glass panes: layers 2-4 and the probe bit-equal to the plain version and "
          "empty, as side-by-side panes make them (a non-empty layer: the overlapping panes "
          "above and phase 9)")

    # The textured glass shader in kernel mode (the tint varying, sampled at
    # the vertices): one 1080p frame, its K5 call against the plain version.
    scene_t, _ = build_standin_scene(device, 100, np.random.default_rng(42), glass=True,
                                     glass_textured=True)
    renderer_t = DeferredRenderer(scene_t, glass_mode="kernel")
    orbit_camera(camera, 0.3)
    with recording() as calls:
        tc, tenc, _, tret = deferred_frame(device, renderer_t, camera, W, H, options,
                                           present_format=bgra)
    tex_frame = tc.value(tenc).cpu().numpy()
    no_new_build("textured glass, kernel mode")
    check(int(tret.bin_overflow) == 0, "textured glass, kernel mode: bin overflow")
    check(len(calls["K5"]) == 1, "textured glass, kernel mode: not one K5 pass")
    check(("tint", 4) in calls["K5"][0][5]["attr_layout"],
          "textured glass, kernel mode: the records carry no tint column")
    _, p, err = hold_blend(5, "textured glass panes", calls["K5"][0])
    with plain_path():
        pc, penc, _, _ = deferred_frame(device, renderer_t, camera, W, H, options,
                                        present_format=bgra)
        ref = pc.value(penc).cpu().numpy()
    mx, frac = lsb_diff(tex_frame, ref)
    check(mx <= 1 and frac < 0.01, f"textured glass, kernel mode: the frame differs from the "
          f"plain-path frame (max LSB diff {mx}, {frac * 100:.4f}% of values)")
    print(f"phase 11: textured glass in kernel mode (64^2 checker sampled at the vertices, a_n "
          f"{(calls['K5'][0][0].rast_pad.shape[1] - 16) // 3}): K5 z bit-equal, colour max "
          f"|kernel - plain| {err:.3e} (values up to {p[1].abs().max().item():.3f}); frame vs "
          f"the plain-path frame max LSB diff {mx}, {frac * 100:.4f}% values differ")
    print_ptxas("textured glass shader", calls["K5"][0])

    # -- 12. a stencil-attachment frame through the render graph ----------------
    # Node "mark" writes a mask (stencil only), node "gated" draws a quad
    # through it (K3 twice), node "tinted" blends the translucent stress
    # draws through the same mask (K6).
    pos_layout = VertexLayout.from_fields(("position", 4))
    pos_vs = Shader.vertex("mask.vs", lambda attrs, res: {"position": attrs["position"]})

    def gated_fs(varyings, res, builtins):
        c = varyings["color"]  # interpolated: K3's attribute planes reach the frame
        return torch.cat([c[..., :3], torch.ones_like(c[..., :1])], dim=-1)

    tri = np.array([[0.0, -0.5, 0.5, 1.0], [0.5, 0.5, 0.5, 1.0], [-0.5, 0.5, 0.5, 1.0]],
                   np.float32)
    quad = np.array([[-2, -2, 0.6, 1.0, 1.0, 0.2, 0.1, 1.0], [2, -2, 0.6, 1.0, 0.5, 0.9, 0.3, 1.0],
                     [2, 2, 0.6, 1.0, 0.25, 0.4, 1.0, 1.0], [-2, 2, 0.6, 1.0, 0.75, 0.6, 0.0, 1.0]],
                    np.float32)
    buffers = [Buffer.from_numpy("tri.vb", tri, device=dev),
               Buffer.from_numpy("tri.ib", np.array([0, 1, 2], np.int32), device=dev),
               Buffer.from_numpy("quad.vb", quad, device=dev),
               Buffer.from_numpy("quad.ib", np.array([0, 1, 2, 0, 2, 3], np.int32), device=dev)]

    def stencil_frame():
        builder = RenderGraphBuilder()
        v1, i1, v2, i2 = (builder.import_resource(r) for r in buffers)
        color = builder.create(TextureDesc.color("out", W, H))
        sten = builder.create(TextureDesc.stencil("mask", W, H))
        builder.export(color)
        builder.export(sten)
        raster = RasterizationState(cull_mode=CullMode.NONE)

        node = builder.add_graphic_node("mark")
        v1a, i1a, sa = node.read(v1), node.read(i1), node.write(sten)
        with node.pipeline(GraphicShaderInput(pos_vs, None, pos_layout), GraphicPipelineState(
                rasterization=raster, depth_stencil=DepthStencilDesc().stencil_write(1))) as bd:
            bd.set_stencil(sa)
        node.execute(lambda ctx: ctx.draw_indexed(v1a, i1a))

        node = builder.add_graphic_node("gated")
        v2a, i2a = node.read(v2), node.read(i2)
        node.read(sten)
        ca, sa2 = node.write(color), node.write(sten)
        with node.pipeline(
                GraphicShaderInput(vs, Shader.fragment("gated.fs", gated_fs), layout),
                GraphicPipelineState(rasterization=raster,
                                     depth_stencil=DepthStencilDesc().stencil_mask(1))) as bd:
            bd.push_color(ca, ColorAttachmentDesc(clear_value=(0, 0, 0, 1)))
            bd.set_stencil(sa2)
        node.execute(lambda ctx: ctx.draw_indexed(v2a, i2a))

        node = builder.add_graphic_node("tinted")
        node.read(color)
        node.read(sten)
        cb, sb = node.write(color), node.write(sten)
        with node.pipeline(
                GraphicShaderInput(vs, fs, layout),
                GraphicPipelineState(rasterization=raster,
                                     depth_stencil=DepthStencilDesc().stencil_mask(1))) as bd:
            bd.push_color(cb, dataclasses.replace(over, load_op=LoadOp.LOAD))
            bd.set_stencil(sb)
        node.execute(lambda ctx: ctx.draw_indexed_batch(draws[:2],
                                                        entry_budget=STRESS_ENTRY_BUDGET))

        compiled = builder.build().compile(device, PipelineCache(), options)
        compiled.execute(device)
        return compiled.value(color), compiled.value(sten)

    zero_counts()
    with recording() as calls:
        k_col, k_sten = stencil_frame()
    counts = read_counts()
    no_new_build("stencil frame")
    with plain_path():
        p_col, p_sten = stencil_frame()
    torch.cuda.synchronize()
    check(counts["K3"] == 2 and counts["K6"] == 1,
          f"the stencil frame launched K3 {counts['K3']} and K6 {counts['K6']} times, not 2 and 1")
    for k in counts:
        path_launches[k] += counts[k]
    exact((k_sten,), (p_sten,), "stencil frame", ("stencil plane",))
    err = (k_col - p_col).abs().max().item()
    blend_err[6] = max(blend_err[6], err)
    check(bool(torch.isclose(k_col, p_col, atol=1e-5, rtol=1e-5).all()),
          f"stencil frame: colour differs from the plain path (max {err:.3e})")
    marked = k_sten == 1
    n_marked = int(marked.sum())
    check(100000 < n_marked < W * H // 2, f"stencil frame: the mask marks {n_marked} pixels")
    check(bool((k_col[..., 3][~marked] == 1.0).all() and (k_col[..., 0][~marked] == 0.0).all()),
          "stencil frame: something was drawn outside the mask")
    check(bool((k_col[..., 0][marked] > 0.0).all()), "stencil frame: the mask was not filled")
    print(f"phase 12: stencil-attachment frame at {W}x{H} through the render graph (mark -> "
          f"gated quad -> blended batch through the mask): K3 launched 2 times, K6 once; "
          f"{n_marked} px marked, nothing drawn outside; stencil equal to and colour within "
          f"atol 1e-5 + rtol 1e-5 (max {err:.3e}) of the plain path")

    # K3 and K6 at that frame's own inputs, against their plain versions.
    check(len(calls["K3"]) == 2 and len(calls["K6"]) == 1,
          f"the stencil frame's draws made {len(calls['K3'])} K3 and {len(calls['K6'])} K6 "
          f"calls, not 2 and 1")
    for call, node in zip(calls["K3"], ("mark", "gated")):
        k, p = both(replay(call))
        exact(k, p, f"K3 stencil frame, node {node}", ("z", "planes", "stencil"))
    b3, g3 = calls["K3"][1][0], calls["K3"][1][1]
    a3, cov3p = k[1].shape[0], int((k[1][-1] > 0).sum())
    check(cov3p == n_marked, f"K3 gated quad covers {cov3p} px, the mask marks {n_marked}")
    check(not torch.equal(k[1][0], k[1][1]) and float(k[1][:3].abs().max()) > 0,
          "K3 gated quad: the colour planes are empty or all alike")
    frag3 = k1_fragments(b3, g3)
    k3p_ms, k3p_plain = timed(replay(calls["K3"][1]))
    k3p_b, k3p_by = bound(input_bytes(b3) + (4 + a3) * plane_bytes,
                          frag3 * K3_OPS_PER_FRAGMENT + cov3p * a3 * K1_OPS_PER_PIXEL_PLANE)
    print(f"phase 12: K3 at the gated node's inputs ({int(b3.blk_count.sum())} entries, {frag3} "
          f"fragments, {cov3p} px pass the mask, a_n {a3}): both K3 calls bit-equal to the "
          f"plain version in z, planes and stencil; kernel {k3p_ms:.4f} ms, plain "
          f"{k3p_plain:.4f} ms, bound {k3p_b:.4f} ms ({k3p_by}); no one-call PyTorch "
          f"equivalent [{card}]")
    k3.update(shape="stencil frame 1080p, full-screen quad through the mask", ms=k3p_ms,
              plain_ms=k3p_plain, bound_ms=k3p_b, bound_by=k3p_by)

    call6 = calls["K6"][0]
    b6, g6, kw6 = call6[0], call6[1], call6[5]
    check(not kw6["depth_test"], "the tinted node was expected to draw without a depth test")
    _, p6, err6 = hold_blend(6, "stencil frame, node tinted", call6)
    mask6 = kw6["init_stencil"]
    frag6, shaded6 = count_fragments(b6, g6, lambda rows, zpx, py, px: mask6[py, px] == 1)
    k6p_ms, k6p_plain = timed(replay(call6))
    k6p_dev = device_ms(replay(call6), "raster_blend_kernel")
    k6p_b, k6p_by = blend_bound(b6, g6, shaded6, frag6, STRESS_SHADER_OPS, True)
    print(f"phase 12: K6 at the tinted node's inputs ({int(b6.blk_count.sum())} entries, "
          f"{frag6} fragments, {shaded6} shaded through the mask): z and stencil bit-equal, "
          f"colour max |kernel - plain| {err6:.3e} (values up to "
          f"{p6[1].abs().max().item():.3f}); kernel {k6p_ms:.4f} ms (wrapper call; the kernel "
          f"alone {k6p_dev:.4f} ms of device time), plain {k6p_plain:.4f} ms, bound "
          f"{k6p_b:.4f} ms ({k6p_by}); before the redesign {BEFORE_MS['K6 stencil frame']} ms; no "
          f"one-call PyTorch equivalent [{card}]")

    k4 = record("segmented raster + peel bound (_segmented_peel_kernel)", 4, "raster.cu", 410,
                "glass panes 1080p, peel layer 2", 0.0, *k4_glass)
    k5 = record("in-order shade + blend (_segmented_blend_kernel)", 5, "raster_blend.cu", 515,
                "glass panes 1080p over the lit HDR frame", blend_err[5], k5_ms, k5_plain, k5_b,
                k5_by)
    k6 = record("in-order shade + blend + stencil (_segmented_blend_stencil_kernel)", 6,
                "raster_blend.cu", 627, "stencil frame 1080p, 64 translucent triangles "
                "through the mask", blend_err[6], k6p_ms, k6p_plain, k6p_b, k6p_by)
    records = [k3, k4, k5, k6]
    for rec, key in zip(records, ("K3", "K4", "K5", "K6")):
        rec["launches"] = path_launches[key]
        check(rec["launches"] > 0, f"{key} was launched no time on a main path")
    print(f"summary: stress inputs (phases 8-10): K3 {k3_ms:.4f} ms, K4 layer 2 {k4s_ms:.4f} ms, "
          f"K5 {blend_records[5][0]:.4f} ms, K6 {blend_records[6][0]:.4f} ms; the kernels line "
          f"below takes K3-K6 at the main paths' own inputs (phases 11-12) [{card}]")
    return records, {"K1": path_launches["K1"], "K2": path_launches["K2"]}


# Phase 13. K7 and K8 do K1's per-fragment work (29 operations); per covered
# pixel K8 writes the winner's a_n planes (5 operations each, as K1), K7 one
# slot (no arithmetic). Counted from csrc/raster_capped.cu.
K7_OPS_PER_FRAGMENT = K1_OPS_PER_FRAGMENT
CAPPED_OVERFLOW_K = 64  # phase 13e: the stress draw at a capacity that drops records


def capped_blocks(bins, grid):
    """Capped bins in the block layout count_fragments reads: one block of K
    rows per tile, live as far as the tile's count."""
    import types

    import torch

    t, k = bins.binned_rast.shape[:2]
    tiles = torch.arange(t, dtype=torch.int32, device=bins.counts.device)
    return types.SimpleNamespace(rast_pad=bins.binned_rast.reshape(t * k, 16),
                                 blk_count=bins.counts, blk_tile_y=tiles // grid.tiles_x,
                                 blk_tile_x=tiles % grid.tiles_x)


def deferred_geometry(dev):
    """Phase 7's geometry: the stand-in mesh and the ground in world space
    (what the G-buffer vertex stage computes), with the camera's
    view-projection at phase 7's first timed frame and the sun's. Returns
    (pos (Nv, 3), normal (Nv, 3), indices (T, 3), camera VP, sun VP, shadow
    map size)."""
    import torch

    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree
    from zenith_tpu_torch.ops.geometry import transform_vertices
    from zenith_tpu_torch.renderer.forward import sun_view_projection
    from zenith_tpu_torch.rhi import RhiCore
    from zenith_tpu_torch.sandbox.scene import build_standin_scene, orbit_camera

    scene, _ = build_standin_scene(RhiCore(dev).create_render_device(), 100,
                                   np.random.default_rng(42))
    camera = Camera(fov_y=Degree(35.0), aspect_ratio=W / H)
    orbit_camera(camera, 0.3)
    pos, nrm, idx, base = [], [], [], 0
    for obj in scene.objects:
        vb = obj.vertex_buffer.array.reshape(-1, 8)
        model = torch.from_numpy(np.asarray(obj.model_matrix, np.float32)).to(dev)
        pos.append(transform_vertices(vb[:, :3], model)[:, :3])
        nrm.append(vb[:, 3:6] @ model[:3, :3].T)
        idx.append(obj.index_buffer.array.reshape(-1, 3).to(torch.int64) + base)
        base += vb.shape[0]
    return (torch.cat(pos), torch.cat(nrm), torch.cat(idx).to(torch.int32),
            camera.render_view_projection, sun_view_projection(scene.sun),
            scene.sun.shadow_map_size)


def capped_phase(dev, card: str, stress) -> "list[dict]":
    """Phase 13: the capped-bin path (setup_triangles → bin_triangles →
    visibility_pass / raster_interp_pass → resolve_varyings /
    finalize_attrs) at full width, on the 1080p stress draw and on phase 7's
    geometry seen by the camera (1920x1080) and by the sun (the 1024² shadow
    map), each with a capacity that drops nothing, and on the stress draw at
    capacity 64. Returns the records of K7 and K8."""
    import torch

    from zenith_tpu_torch.ops import raster as raster_mod
    from zenith_tpu_torch.ops.binning import (
        TileGrid,
        bin_segmented,
        bin_triangles,
        tile_overlap,
    )
    from zenith_tpu_torch.ops.geometry import (
        corner_attributes,
        setup_triangles,
        transform_vertices,
    )
    from zenith_tpu_torch.ops.raster import (
        K_BLOCK,
        raster_interp_pass,
        raster_segmented,
        visibility_pass,
    )
    from zenith_tpu_torch.ops.runtime import round_up
    from zenith_tpu_torch.ops.shade import finalize_attrs, resolve_varyings
    from zenith_tpu_torch.rhi.state import CompareOp, CullMode, FrontFace

    t0 = time.perf_counter()
    clip, idx, colors = (torch.from_numpy(a).to(dev) for a in stress)
    torch.cuda.reset_peak_memory_stats(dev)
    pos, nrm, gidx, cam_vp, sun_vp, smsz = deferred_geometry(dev)
    world = {"pos": pos, "normal": nrm}
    views = {  # name: (clip, indices, varyings, grid, setup state, compare, clear)
        "stress draw": (clip, idx, {"color": colors}, TileGrid(W, H), {}, CompareOp.GREATER,
                        0.0),
        "G-buffer view": (transform_vertices(pos, torch.from_numpy(cam_vp).to(dev)), gidx,
                          world, TileGrid(W, H),
                          dict(cull_mode=CullMode.BACK, front_face=FrontFace.COUNTER_CLOCKWISE),
                          CompareOp.GREATER, 0.0),
        "shadow view": (transform_vertices(pos, torch.from_numpy(sun_vp).to(dev)), gidx, world,
                        TileGrid(smsz, smsz), dict(front_face=FrontFace.CLOCKWISE),
                        CompareOp.LESS, 1.0),
    }

    def path(name, k=None):
        """The capped-bin API path on one view, as a user calls it."""
        vclip, vidx, vary, g, state, cmp, clear = views[name]
        rec = setup_triangles(vclip, vidx, g.width, g.height,
                              **{"cull_mode": CullMode.NONE, **state})
        corner = corner_attributes(rec, vidx, torch.cat(list(vary.values()), dim=1))
        if k is None:  # a capacity that drops nothing
            k = round_up(int(tile_overlap(rec, g).sum(1).max()), K_BLOCK)
        bins = bin_triangles(rec, g, k)
        attr = bins.gather_corner_data(corner)
        z0 = torch.full((g.height, g.width), clear, device=dev)
        s0 = torch.full((g.height, g.width), -1, dtype=torch.int32, device=dev)
        z7, slot = visibility_pass(bins, g, z0, s0, compare_op=cmp)
        z8, acc = raster_interp_pass(bins, attr, g, z0, compare_op=cmp)
        layout = [(n, v.shape[1]) for n, v in vary.items()] + [("__front", 1)]
        fin, fmask, _ = finalize_attrs(z8, acc, layout)
        res, rmask, _ = resolve_varyings(slot, rec.rast16, rec.shade16, rec.tri_id, vidx, vary)
        return dict(rec=rec, corner=corner, bins=bins, attr=attr, z0=z0, s0=s0, z7=z7,
                    slot=slot, z8=z8, acc=acc, fin=fin, fmask=fmask, res=res, rmask=rmask,
                    k=k, grid=g, cmp=cmp)

    # The main path: every view through the API, the counts read around it.
    torch.cuda.synchronize()
    visibility_pass.launches = 0
    raster_interp_pass.launches = 0
    runs = {name: path(name) for name in views}
    runs["stress draw, K 64"] = path("stress draw", k=CAPPED_OVERFLOW_K)
    torch.cuda.synchronize()
    launches = {"K7": visibility_pass.launches, "K8": raster_interp_pass.launches}
    check(launches == {"K7": len(runs), "K8": len(runs)},
          f"the capped-bin path launched K7 and K8 {launches} times, not {len(runs)} each")
    peak = torch.cuda.max_memory_allocated(dev)

    def plain():
        """K7 and K8 replaced by their plain versions (the counts stay put)."""
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(raster_mod, "_visibility_cuda",
                                              raster_mod._visibility_torch))
        stack.enter_context(mock.patch.object(raster_mod, "_interp_cuda",
                                              raster_mod._interp_torch))
        return stack

    err = {"K7": 0.0, "K8": 0.0}
    records = {}
    for name, r in runs.items():
        bins, g, cmp, a_n = r["bins"], r["grid"], r["cmp"], r["acc"].shape[0]
        hp, wp = g.tiles_y * g.tile_h, g.tiles_x * g.tile_w
        live = int(bins.counts.sum())
        bin_bytes = sum(t.numel() * t.element_size()
                        for t in (bins.binned_rast, bins.binned_slot, r["attr"]))
        overflow = int(bins.overflow)

        def k8_call(r=r):
            return raster_interp_pass(r["bins"], r["attr"], r["grid"], r["z0"], compare_op=r["cmp"])

        def k7_call(r=r):
            return visibility_pass(r["bins"], r["grid"], r["z0"], r["s0"], compare_op=r["cmp"])

        # a. K8 against its plain version; c. K7 against its plain version,
        # and against K8.
        with plain():
            pz7, pslot = k7_call()
            pz8, pacc = k8_call()
        torch.cuda.synchronize()
        err["K8"] = max(err["K8"], (r["z8"] - pz8).abs().max().item(),
                        (r["acc"] - pacc).abs().max().item())
        err["K7"] = max(err["K7"], (r["z7"] - pz7).abs().max().item(),
                        float((r["slot"] - pslot).abs().max()))
        check(torch.equal(r["z8"], pz8) and torch.equal(r["acc"], pacc),
              f"{name}: K8 differs from its plain version")
        check(torch.equal(r["z7"], pz7) and torch.equal(r["slot"], pslot),
              f"{name}: K7 differs from its plain version")
        covered = r["acc"][-1] > 0
        check(torch.equal(r["z7"], r["z8"]) and torch.equal(r["slot"] >= 0, covered),
              f"{name}: K7's z or coverage differs from K8's")
        n_cov = int(covered.sum())
        check(n_cov > 1000, f"{name}: only {n_cov} px covered")
        # d. resolve_varyings over K7's slots against finalize_attrs over K8's
        # planes.
        check(torch.equal(r["fmask"], r["rmask"]), f"{name}: the two resolves' coverage differs")
        worst = []
        for v, fin in r["fin"].items():
            res = r["res"][v]
            m = r["fmask"]
            d = (fin[m] - res[m]).abs()
            worst.append(f"{v} {d.max().item():.3e} (values up to {res[m].abs().max().item():.1f})")
            check(bool(torch.isclose(fin[m], res[m], atol=2e-3, rtol=1e-4).all()),
                  f"{name}: resolve_varyings and finalize_attrs differ in {v} beyond atol 2e-3 "
                  f"+ rtol 1e-4 (max {d.max().item():.3e})")
        line = (f"phase 13: {name} {g.width}x{g.height}: {int(r['rec'].valid.sum())} valid "
                f"records, K {r['k']}, {live} live entries, overflow {overflow}, bins "
                f"{bin_bytes / 2**20:.1f} MiB (rows, slots, corner data), a_n {a_n}, {n_cov} px "
                f"covered; K7 and K8 bit-equal to their plain versions, K7's z and coverage "
                f"K8's; resolve_varyings vs finalize_attrs max |diff| " + ", ".join(worst))
        if name == "stress draw, K 64":
            # e. overflow: the card's binning equals the CPU's.
            vclip, vidx, _, _, state, _, _ = views["stress draw"]
            crec = setup_triangles(vclip.cpu(), vidx.cpu(), g.width, g.height,
                                   cull_mode=CullMode.NONE, **state)
            cb = bin_triangles(crec, g, CAPPED_OVERFLOW_K)
            for f in ("binned_rast", "binned_slot", "counts", "overflow"):
                check(torch.equal(getattr(bins, f).cpu(), getattr(cb, f)),
                      f"{name}: the card's and the CPU's binning differ in {f}")
            check(overflow > 0, f"{name}: no record was dropped")
            print(line + f"; binning equal to the CPU's, overflow included [{card}]")
            continue
        # b. K8 against K1 on the segmented bins of the same records.
        check(overflow == 0, f"{name}: the capped bins dropped {overflow} records")
        entries = int(tile_overlap(r["rec"], g).sum())
        sbins = bin_segmented(r["rec"], r["corner"], g, mid_cap=8192, huge_cap=4096,
                              entry_budget=entries)
        check(int(sbins.overflow) == 0 and int(sbins.blk_count.sum()) == live,
              f"{name}: the segmented bins dropped entries")
        z1, acc1 = raster_segmented(sbins, g, r["z0"], compare_op=cmp)
        torch.cuda.synchronize()
        check(torch.equal(z1, r["z8"]) and torch.equal(acc1, r["acc"]),
              f"{name}: K8 differs from K1 on the same records")

        def k1_call(sbins=sbins, r=r):
            return raster_segmented(sbins, r["grid"], r["z0"], compare_op=r["cmp"])

        t8 = cuda_ms(k8_call, reps=10, warmup=2)
        t7 = cuda_ms(k7_call, reps=10, warmup=2)
        t1 = cuda_ms(k1_call, reps=10, warmup=2)
        # The kernels alone: bare launches on the padded planes, z reset
        # before each (depth writes on, as in the calls above); then K7 over
        # these tiles with no record in any, so that every CTA returns at
        # once: what the CTAs of empty tiles cost.
        zp0 = raster_mod._pad_plane(r["z0"], g.height, g.width, hp, wp, torch.float32)
        zp, sp = zp0.clone(), torch.full_like(zp0, -1, dtype=torch.int32)
        accp = torch.zeros((a_n, hp, wp), device=dev)
        dead = bins._replace(counts=torch.zeros_like(bins.counts))

        def reset():
            zp.copy_(zp0)

        d8 = kernel_ms(lambda: raster_mod._interp_cuda(bins, r["attr"], g, zp, accp, cmp, True),
                       reset)
        d7 = kernel_ms(lambda: raster_mod._visibility_cuda(bins, g, zp, sp, cmp, True), reset)
        d1 = kernel_ms(lambda: raster_mod._raster_segmented_cuda(sbins, g, zp, accp, cmp, True,
                                                                 False, (0.5, 0.5)), reset)
        d0 = kernel_ms(lambda: raster_mod._visibility_cuda(dead, g, zp, sp, cmp, True), reset)
        with plain():
            p8 = cuda_ms(k8_call, reps=2, warmup=0)
            p7 = cuda_ms(k7_call, reps=2, warmup=0)
        frags = count_fragments(capped_blocks(bins, g), g)[0]
        b8 = bound(4 * (live * (16 + 3 * a_n) + bins.counts.numel() + (2 + a_n) * hp * wp),
                   frags * K1_OPS_PER_FRAGMENT + n_cov * a_n * K1_OPS_PER_PIXEL_PLANE)
        b7 = bound(4 * (live * 17 + bins.counts.numel() + 4 * hp * wp),
                   frags * K7_OPS_PER_FRAGMENT)
        print(line + f"; K8 bit-equal to K1 on the segmented bins of the same records. "
              f"{frags} fragments, largest tile {tile_entries(sbins, g)} entries: "
              f"K8 {t8:.4f} ms (device {d8:.4f} ms; plain {p8:.4f} ms, bound {b8[0]:.4f} ms, "
              f"{b8[1]}; before the redesign {BEFORE_MS[f'K8 phase 13 {name}']} ms), "
              f"K7 {t7:.4f} ms (device {d7:.4f} ms; plain {p7:.4f} ms, bound {b7[0]:.4f} ms, "
              f"{b7[1]}; before the redesign {BEFORE_MS[f'K7 phase 13 {name}']} ms), K1 on the "
              f"same records {t1:.4f} ms (device {d1:.4f} ms; before its redesign "
              f"{BEFORE_MS[f'phase 13 {name}']} ms): device time K7/K1 {d7 / d1:.2f}, K8/K1 "
              f"{d8 / d1:.2f}; K7 with every tile empty ({bins.counts.numel()} x 16 CTAs "
              f"that return at once) {d0:.4f} ms device; no one-call PyTorch equivalent "
              f"[{card}]")
        records[name] = {"K7": (t7, d7, p7, *b7), "K8": (t8, d8, p8, *b8)}

    # f. the cull's hard cases through the capped path, all eight compares,
    # then at 64x128 tiles (8,192 px a tile).
    f_err = cull_stress_capped(dev, card)
    err = {key: max(err[key], f_err[key]) for key in err}
    print(f"phase 13: capped-bin path: K7 and K8 launched {launches['K7']} times each on the "
          f"path; peak device memory {peak / 2**30:.2f} GiB; {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    out = []
    for key, name, line in (("K7", "capped-bin visibility (_visibility_kernel)", 61),
                            ("K8", "capped-bin interpolation (_interp_kernel)", 153)):
        ms, dev_ms, plain_ms, b_ms, b_by = records["G-buffer view"][key]
        out.append({"name": f"{key} {name}", "route": "cuda",
                    "source": "zenith_tpu_torch/csrc/raster_capped.cu",
                    "replaces": f"zenith_tpu/ops/raster.py:{line}", "launches": launches[key],
                    "max_abs_err": err[key], "ms": ms, "device_ms": dev_ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None, "shape": "deferred scene geometry, G-buffer view 1080p"})
    return out


def cull_stress_capped(dev, card: str) -> dict:
    """Phase 13f: phase 2c's near-clipped and sliver triangles, with the
    corners of the rest on pixel centres, through the capped-bin path: K7's
    z and slots and K8's z and planes bit-equal to their plain versions for
    all eight compares (depth writes on and off in turn) at 32x128 tiles,
    then with GREATER at 64x128 tiles, above the 4,096-pixel tile the
    kernels took before their redesign. Returns the largest differences."""
    import torch

    from zenith_tpu_torch.ops import raster as raster_mod
    from zenith_tpu_torch.ops.binning import TileGrid, bin_triangles, tile_overlap
    from zenith_tpu_torch.ops.geometry import corner_attributes, setup_triangles
    from zenith_tpu_torch.ops.raster import K_BLOCK, raster_interp_pass, visibility_pass
    from zenith_tpu_torch.ops.runtime import round_up
    from zenith_tpu_torch.rhi.state import CompareOp, CullMode

    clip, idx, colors = (torch.from_numpy(a).to(dev)
                         for a in cull_stress_scene(lattice=CENTRE_LATTICE))
    rec = setup_triangles(clip, idx, W, H, cull_mode=CullMode.NONE)
    corner = corner_attributes(rec, idx, colors)
    aabb = rec.aabb[rec.valid]
    far_out = int(((aabb[:, 0] < -W) | (aabb[:, 2] > 2 * W) | (aabb[:, 1] < -H)
                   | (aabb[:, 3] > 2 * H)).sum())
    check(far_out > 0, "phase 13f: no record reaches far outside the surface")
    rng = np.random.default_rng(31)
    init = torch.from_numpy(rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)).to(dev)
    init[:, : W // 2] = 0.5  # a plane some fragments tie with exactly
    s0 = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    err = {"K7": 0.0, "K8": 0.0}
    cases = {TileGrid(W, H): [(op, i % 2 == 0) for i, op in enumerate(CompareOp)],
             TileGrid(W, H, 64, 128): [(CompareOp.GREATER, True)]}
    for g, states in cases.items():
        k = round_up(int(tile_overlap(rec, g).sum(1).max()), K_BLOCK)
        bins = bin_triangles(rec, g, k)
        attr = bins.gather_corner_data(corner)
        for op, write in states:
            kw = dict(compare_op=op, depth_write=write)

            def both():
                return (*visibility_pass(bins, g, init, s0, **kw),
                        *raster_interp_pass(bins, attr, g, init, **kw))

            kern = both()
            with mock.patch.object(raster_mod, "_visibility_cuda", raster_mod._visibility_torch), \
                    mock.patch.object(raster_mod, "_interp_cuda", raster_mod._interp_torch):
                ref = both()
            torch.cuda.synchronize()
            (z7, slot, z8, acc), (pz7, pslot, pz8, pacc) = kern, ref
            what = f"phase 13f: {op.name} write={write} at {g.tile_h}x{g.tile_w} tiles"
            err["K7"] = max(err["K7"], (z7 - pz7).abs().max().item(),
                            float((slot - pslot).abs().max()))
            err["K8"] = max(err["K8"], (z8 - pz8).abs().max().item(),
                            (acc - pacc).abs().max().item())
            check(torch.equal(z7, pz7) and torch.equal(slot, pslot),
                  f"{what}: K7 differs from its plain version")
            check(torch.equal(z8, pz8) and torch.equal(acc, pacc),
                  f"{what}: K8 differs from its plain version")
            n_cov = int((slot >= 0).sum())
            check(op in (CompareOp.NEVER, CompareOp.EQUAL) or n_cov > 1000,
                  f"{what}: only {n_cov} px covered")
            print(f"  bit-equal: {op.name:<17} write={write!s:<5} {g.tile_h}x{g.tile_w} tiles, "
                  f"K {k}, covered {n_cov}")
    print(f"phase 13f: cull stress through the capped-bin path at {W}x{H}, corners on pixel "
          f"centres: {int(rec.valid.sum())} valid records ({far_out} with an AABB more than a "
          f"surface off-screen); K7 and K8 bit-equal to their plain versions for all eight "
          f"compares at 32x128 tiles and at 64x128 [{card}]")
    return err


TEXTURED_FRAMES = 20


def plate_gltf(path: Path, n: int = 96) -> None:
    """A glTF of a wavy square plate (n x n quads, 40 units wide, z up, with
    normals and texture coordinates), its buffer a data URI and no images:
    what phase 14c bakes through the asset manager."""
    import base64

    g = np.linspace(-20.0, 20.0, n + 1, dtype=np.float32)
    xx, yy = np.meshgrid(g, g, indexing="xy")
    zz = 1.5 * np.sin(xx / 4.0) * np.cos(yy / 5.0)
    dzdx = 1.5 / 4.0 * np.cos(xx / 4.0) * np.cos(yy / 5.0)
    dzdy = -1.5 / 5.0 * np.sin(xx / 4.0) * np.sin(yy / 5.0)
    nrm = np.stack([-dzdx, -dzdy, np.ones_like(zz)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pos = np.stack([xx, yy, zz], -1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([(xx + 20) / 40, (yy + 20) / 40], -1).reshape(-1, 2).astype(np.float32)
    r, c = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    v00 = r * (n + 1) + c
    idx = np.stack([v00, v00 + 1, v00 + n + 2, v00, v00 + n + 2, v00 + n + 1],
                   -1).reshape(-1).astype(np.uint32)
    parts = [pos, nrm.reshape(-1, 3).astype(np.float32), uv, idx]
    blob, views, accessors = b"", [], []
    for arr, (ctype, atype) in zip(parts, [(5126, "VEC3"), (5126, "VEC3"), (5126, "VEC2"),
                                           (5125, "SCALAR")]):
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": arr.nbytes})
        accessors.append({"bufferView": len(views) - 1, "componentType": ctype,
                          "count": int(arr.shape[0]), "type": atype})
        blob += arr.tobytes()
    doc = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
           "nodes": [{"mesh": 0}],
           "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                                      "TEXCOORD_0": 2},
                                       "indices": 3, "material": 0}]}],
           "materials": [{"pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.85, 0.8, 1.0],
                                                   "metallicFactor": 0.8,
                                                   "roughnessFactor": 0.7},
                          "emissiveFactor": [1.5, 1.5, 1.5]}],
           "accessors": accessors, "bufferViews": views,
           "buffers": [{"byteLength": len(blob), "uri": "data:application/octet-stream;base64,"
                        + base64.b64encode(blob).decode()}]}
    path.write_text(json.dumps(doc))


def material_pixels(seed: int = 31) -> dict:
    """Phase 14c's four maps as uint8 RGBA pixels made with numpy: a base
    colour of random blocks, a tangent-space normal map of random tilts, MRA
    stripes (G roughness, B metallic) and the emissive rings."""
    from zenith_tpu_torch.sandbox.scene import emissive_pixels

    rng = np.random.default_rng(seed)
    base = np.repeat(np.repeat(rng.integers(60, 250, (16, 16, 4)), 16, 0), 16, 1)
    base[..., 3] = 255
    tilt = np.repeat(np.repeat(rng.uniform(-0.5, 0.5, (8, 8, 2)), 16, 0), 16, 1)
    nrm = np.concatenate([tilt, np.ones_like(tilt[..., :1])], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normal = np.concatenate([(nrm * 0.5 + 0.5) * 255, np.full_like(nrm[..., :1], 255)], -1)
    rows = np.arange(128)[:, None] // 16 % 2 == 0
    mra = np.zeros((128, 128, 4))
    mra[..., 0], mra[..., 3] = 255, 255
    mra[..., 1] = np.where(rows, 230, 60)
    mra[..., 2] = np.where(rows, 0, 255)
    return {"base_color_texture": base.astype(np.uint8), "normal_texture": normal.astype(np.uint8),
            "metallic_roughness_texture": mra.astype(np.uint8),
            "emissive_texture": emissive_pixels(64)}


def textured_phases(dev, card: str, plain_k1) -> dict:
    """Phase 14: textured materials end to end. (14a) The textured deferred
    scene at 1920x1080; (14b) the textured golden and its full material set;
    (14c) a glTF baked through the asset manager into a deferred frame and a
    MeshRenderer frame. Returns K1's and K2's launches on 14a's main path."""
    import tempfile

    import torch

    from zenith_tpu_torch import asset
    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree, Radians
    from zenith_tpu_torch.ops import draw as draw_mod
    from zenith_tpu_torch.ops import lighting as lighting_mod
    from zenith_tpu_torch.ops import raster as raster_mod
    from zenith_tpu_torch.ops.lighting import accumulate_point_lights
    from zenith_tpu_torch.ops.raster import raster_segmented
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.renderer import (
        DeferredRenderer,
        DirectionalLight,
        MeshRenderer,
        PointLight,
        Scene,
        SceneObject,
    )
    from zenith_tpu_torch.rhi import Format, PipelineCache, RhiCore, Texture, TextureDesc
    from zenith_tpu_torch.rhi import encode_present
    from zenith_tpu_torch.sandbox.scene import (
        GOLDEN_H,
        GOLDEN_W,
        build_standin_scene,
        deferred_frame,
        orbit_camera,
        textured_golden_scene,
    )

    device = RhiCore(dev).create_render_device()
    bgra = Format.BGRA8_SRGB

    @contextlib.contextmanager
    def plain_path():
        with mock.patch.object(raster_mod, "_raster_segmented_cuda", plain_k1), \
                mock.patch.object(lighting_mod, "_accumulate_point_lights_cuda", plain_k2):
            yield

    def launches():
        return raster_segmented.launches, accumulate_point_lights.launches

    # -- 14a. the textured deferred scene at 1920x1080 -------------------------
    scene, mesh = build_standin_scene(device, 100, np.random.default_rng(42), textured=True)
    renderer = DeferredRenderer(scene)
    check(renderer.textured and set(renderer._atlases) == {"BaseAtlas", "NormalAtlas",
                                                           "MraAtlas"},
          f"textured scene: atlases {sorted(renderer._atlases)}")
    check(all(a.texture.array.device.type == "cuda" for a in renderer._atlases.values()),
          "textured scene: an atlas is not on the card")
    camera = Camera(fov_y=Degree(35.0), aspect_ratio=W / H)
    options = CompileOptions()
    cache = PipelineCache()

    def frame(orbit):
        orbit_camera(camera, orbit)
        return deferred_frame(device, renderer, camera, W, H, options, present_format=bgra,
                              pipeline_cache=cache)

    # Warm-up (builds the frame function); K1's and K2's inputs are kept.
    k1_calls = []
    real_raster = draw_mod.raster_segmented

    def recording_raster(bins, grid, init_z, **kw):
        k1_calls.append((bins, grid, init_z.clone(), kw))
        return real_raster(bins, grid, init_z, **kw)

    orbit_camera(camera, 0.3)
    with mock.patch.object(draw_mod, "raster_segmented", recording_raster):
        compiled, _, _, _ = deferred_frame(device, renderer, camera, W, H, options,
                                           exports=("albedo", "normal", "pos", "depth"),
                                           pipeline_cache=cache)
    gplanes = [compiled.value(renderer.gbuffer_handles[k])
               for k in ("albedo", "normal", "pos", "depth")]
    torch.cuda.synchronize()
    check(len(k1_calls) == 2, f"textured frame: K1 ran {len(k1_calls)} times, not 2")
    frame(0.3)
    torch.cuda.synchronize()

    raster_segmented.launches = 0
    accumulate_point_lights.launches = 0
    ends, overflows, per_frame = [], [], []
    t0 = time.perf_counter()
    for i in range(TEXTURED_FRAMES):
        k1_start, k2_start = launches()
        compiled, enc, _, retired = frame(0.3 + i * 0.004)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        overflows.append(retired.bin_overflow)
        k1_now, k2_now = launches()
        per_frame.append((k1_now - k1_start, k2_now - k2_start))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_path, k2_path = launches()
    check(all(f == (2, 1) for f in per_frame),
          f"textured frames ran (K1, K2) {sorted(set(per_frame))} times a frame, not (2, 1)")
    total_overflow = int(torch.stack(overflows).sum())
    check(total_overflow == 0, f"textured frames: bin overflow {total_overflow}")
    frame_ms = np.array([ends[i - 1].elapsed_time(ends[i]) for i in range(1, len(ends))])
    last = compiled.value(enc).cpu().numpy()
    check(last.shape == (H, W, 4) and last.dtype == np.uint8, f"frame is {last.shape}")
    check(last[..., :3].std() > 1.0, "flat textured frame")
    print(f"phase 14a: textured deferred scene ({mesh.num_triangles}-triangle stand-in, "
          f"brushed 256^2; ground checker 512^2, bump normal and MRA 256^2; 100 lights) "
          f"{TEXTURED_FRAMES} frames at {W}x{H}: {TEXTURED_FRAMES / wall:.2f} FPS; frame time "
          f"p50 {np.percentile(frame_ms, 50):.3f} ms, p99 {np.percentile(frame_ms, 99):.3f} ms "
          f"(CUDA events between frame ends); K1 {k1_path} and K2 {k2_path} launches (2 and 1 "
          f"a frame); bin overflow 0 [{card}]")

    orbit_camera(camera, 0.3 + (TEXTURED_FRAMES - 1) * 0.004)
    with plain_path():
        pc, penc, _, _ = deferred_frame(device, renderer, camera, W, H, options,
                                        present_format=bgra, pipeline_cache=cache)
        ref = pc.value(penc).cpu().numpy()
    mx, frac = lsb_diff(last, ref)
    print(f"phase 14a: last frame vs the plain-path frame: max LSB diff {mx}, "
          f"{frac * 100:.4f}% values differ")
    check(mx <= 1 and frac < 0.01, "the textured frame differs from the plain-path frame")

    # The lighting pass's kernel and K1's passes, bare launches by CUDA events.
    pl_pos, pl_col, pl_rad, _ = scene.light_partition()
    lights = [torch.from_numpy(a).to(dev) for a in (pl_pos, pl_col, pl_rad)]
    cam_pos = torch.from_numpy(np.asarray(camera.location, np.float32)).to(dev)
    k2_ms = kernel_ms(lambda: accumulate_point_lights(*gplanes, cam_pos, *lights),
                      lambda: None)
    k1_ms = [kernel_ms(lambda c=c: raster_segmented(c[0], c[1], c[2], **c[3]), lambda: None)
             for c in k1_calls]
    print(f"phase 14a: device time by CUDA events round the bare launch: K2 (the lighting "
          f"pass) {k2_ms:.4f} ms, K1 shadow pass {k1_ms[0]:.4f} ms, G-buffer pass "
          f"{k1_ms[1]:.4f} ms [{card}]")
    profile_frames(frame, ("shadow", "gbuffer", "lighting", "post", "present.encode"),
                   "phase 14a", card, frame_ms,
                   watch=("tiled_lights_kernel", "raster_segmented_kernel", "gather"),
                   expect={"raster_segmented_kernel": 2, "tiled_lights_kernel": 1})

    # -- 14b. the textured golden on the card, then the full material set -----
    gopts = CompileOptions(tile_h=8, tile_w=128)
    for full in (False, True):
        gscene, gcam = textured_golden_scene(device, full_material=full)
        grenderer = DeferredRenderer(gscene)
        before = launches()
        compiled, out, _, _ = deferred_frame(device, grenderer, gcam, GOLDEN_W, GOLDEN_H, gopts)
        img = encode_present(compiled.value(out), Format.RGBA8_SRGB).cpu().numpy()
        check(launches()[0] - before[0] == 2, "textured golden: K1 did not run twice")
        with plain_path():
            pc, pout, _, _ = deferred_frame(device, grenderer, gcam, GOLDEN_W, GOLDEN_H, gopts)
            pimg = encode_present(pc.value(pout), Format.RGBA8_SRGB).cpu().numpy()
        pmx, pfrac = lsb_diff(img, pimg)
        check(pmx <= 1 and pfrac < 0.01, f"textured golden (full={full}) differs from the "
              f"plain-path frame")
        if not full:
            golden = np.load(REPO / "tests" / "golden" / "textured_scene_128x64.npy")
            mx, frac = lsb_diff(img, golden)
            print(f"phase 14b: textured golden 128x64 (brushed panel, checker ground): max LSB "
                  f"diff {mx}, {frac * 100:.3f}% values differ; vs the plain-path frame {pmx} "
                  f"LSB [{card}]")
            check(mx <= 1 and frac < 0.01, "textured golden frame drifted")
        else:
            check(set(grenderer._atlases) == {"BaseAtlas", "NormalAtlas", "MraAtlas",
                                              "EmissiveAtlas"}, "full material set: atlases")
            print(f"phase 14b: full material set 128x64 (+ bump normal and MRA on the ground, "
                  f"emissive rings on the panel): vs the plain-path frame max LSB diff {pmx}, "
                  f"{pfrac * 100:.3f}% values differ [{card}]")

    # -- 14c. the asset pipeline into a frame -----------------------------------
    from zenith_tpu_torch.asset import AssetManager, AssetUrl, Material, Mesh, TextureAsset

    asset.initialize()
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        (root / "content" / "plate").mkdir(parents=True)
        plate_gltf(root / "content" / "plate" / "plate.gltf")
        mgr = AssetManager(root=root)
        t0 = time.perf_counter()
        col = mgr.request_load("plate/plate.gltf").get()
        bake_s = time.perf_counter() - t0
        manifest = root / "cache" / "plate" / "plate.mscl"
        stamp = manifest.stat().st_mtime_ns
        asset.registry().clear()
        t0 = time.perf_counter()
        col = mgr.request_load("plate/plate.gltf").get()
        load_s = time.perf_counter() - t0
        check(manifest.stat().st_mtime_ns == stamp, "asset: the second load rebaked")
        mesh = asset.registry().get(AssetUrl(col.mesh_urls[0]), Mesh)
        baked = asset.registry().get(AssetUrl(col.material_urls[0]), Material)
    check(mesh is not None and mesh.num_triangles == 2 * 96 * 96, "asset: the plate mesh")
    px = material_pixels()
    material = Material(baked.url, baked.base_color_factor, baked.metallic_factor,
                        baked.roughness_factor, baked.emissive_factor,
                        **{slot: TextureAsset(AssetUrl(f"plate/{slot}.tex"), p)
                           for slot, p in px.items()})
    plate = SceneObject.from_mesh_with_material(device, mesh, material, "plate")
    for name in ("base_color_texture", "normal_texture", "mra_texture", "emissive_texture"):
        check(getattr(plate, name).array.device.type == "cuda", f"asset: {name} not on the card")
    ground = SceneObject.quad(device, "ground", size=120.0, z=-3.0,
                              base_color=(0.3, 0.32, 0.35, 1.0), roughness=0.9)
    rng = np.random.default_rng(3)
    pscene = Scene(objects=[plate, ground],
                   sun=DirectionalLight(direction=(0.3, -0.4, 0.85), intensity=2.5,
                                        shadow_map_size=1024, shadow_extent=40.0),
                   point_lights=[PointLight(position=tuple(rng.uniform([-20, -20, 2], [20, 20, 8])),
                                            color=tuple(rng.uniform(0.3, 1.0, 3)),
                                            intensity=300.0, radius=25.0) for _ in range(16)],
                   ambient=(0.03, 0.03, 0.04))
    pcam = Camera(fov_y=Degree(45.0), aspect_ratio=W / H)
    pcam.set_position(np.array([0.0, -45.0, 28.0], np.float32))
    pcam.set_yaw_pitch(Radians(0.0), Radians(-0.55))
    prenderer = DeferredRenderer(pscene)
    before = launches()
    compiled, enc, _, retired = deferred_frame(device, prenderer, pcam, W, H, CompileOptions(),
                                               present_format=bgra)
    img = compiled.value(enc).cpu().numpy()
    after = launches()
    check((after[0] - before[0], after[1] - before[1]) == (2, 1),
          "asset frame: K1 / K2 did not run 2 / 1 times")
    check(int(retired.bin_overflow) == 0, "asset frame: bin overflow")
    with plain_path():
        pc, penc, _, _ = deferred_frame(device, prenderer, pcam, W, H, CompileOptions(),
                                        present_format=bgra)
        ref = pc.value(penc).cpu().numpy()
    mx, frac = lsb_diff(img, ref)
    check(mx <= 1 and frac < 0.01, "asset frame differs from the plain-path frame")
    check(img[..., :3].std() > 1.0, "asset frame is flat")
    print(f"phase 14c: glTF plate ({mesh.num_triangles} triangles, data-URI buffer) baked in "
          f"{bake_s * 1e3:.1f} ms, loaded from the cache in {load_s * 1e3:.1f} ms (no rebake); "
          f"material with four numpy-made maps through from_mesh_with_material; deferred frame "
          f"at {W}x{H} (16 lights): vs the plain-path frame max LSB diff {mx}, "
          f"{frac * 100:.4f}% values differ [{card}]")

    mrenderer = MeshRenderer(device, mesh, base_color_factor=baked.base_color_factor,
                             base_color_texture=Texture.from_numpy(
                                 "plate.base", px["base_color_texture"], Format.RGBA8_SRGB,
                                 device=dev))

    def mesh_frame():
        builder = RenderGraphBuilder()
        color = builder.create(TextureDesc.color("mesh.color", W, H, Format.RGBA32F))
        depth = builder.create(TextureDesc.depth("mesh.depth", W, H))
        mrenderer.render_to(builder, color, depth, pcam)
        builder.export(color)
        c = builder.build().compile(device, PipelineCache(), CompileOptions())
        c.execute(device)
        return encode_present(c.value(color), Format.RGBA8_SRGB).cpu().numpy()

    before = launches()[0]
    img = mesh_frame()
    check(launches()[0] - before == 1, "MeshRenderer frame: K1 did not run once")
    with plain_path():
        ref = mesh_frame()
    mx, frac = lsb_diff(img, ref)
    check(mx <= 1 and frac < 0.01, "MeshRenderer frame differs from the plain-path frame")
    check(img[..., :3].std() > 1.0, "MeshRenderer frame is flat")
    print(f"phase 14c: MeshRenderer frame of the baked plate at {W}x{H} (one draw_indexed, "
          f"K1 once): vs the plain-path frame max LSB diff {mx}, {frac * 100:.4f}% values "
          f"differ [{card}]")
    return {"K1": k1_path, "K2": k2_path}


FORWARD_FRAMES = 30


def forward_phases(dev, card: str, plain_k1, cull) -> dict:
    """Phase 15: (15a) config #3, the forward shadow renderer, through
    SceneApp and launch at 1920x1080 over build_scene's cerberus from the
    repository's cache: 1x, 4x, 8x, wireframe, 64 instanced rocks at 4x, and
    the same with shade-once MSAA; (15b) K1 at the eight 8x sample positions
    on phase 2c's cull stress, and K3, K4 and K5 under 4x MSAA through
    draw_indexed_batch; (15c) lines, points and the deferred wireframe view
    at 1080p. ``cull`` is phase 2c's (bins, init z, compare_exact, both).
    Returns the kernels' launches on these paths."""
    import torch

    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree
    from zenith_tpu_torch.engine import Engine
    from zenith_tpu_torch.launch import launch
    from zenith_tpu_torch.ops import draw as draw_mod
    from zenith_tpu_torch.ops import raster as raster_mod
    from zenith_tpu_torch.ops.binning import TileGrid
    from zenith_tpu_torch.ops.raster import raster_segmented, raster_segmented_blend
    from zenith_tpu_torch.rendergraph import CompileOptions
    from zenith_tpu_torch.renderer import DeferredRenderer, ForwardShadowRenderer
    from zenith_tpu_torch.rhi import (
        BlendFactor,
        ColorAttachmentDesc,
        Format,
        GraphicShaderInput,
        RhiCore,
        Shader,
        uniform,
    )
    from zenith_tpu_torch.rhi import pipeline as pipe
    from zenith_tpu_torch.rhi.state import (
        CompareOp,
        CullMode,
        DepthStencilDesc,
        GraphicPipelineAttachments,
        GraphicPipelineState,
        InputAssemblyState,
        MultisampleState,
        PrimitiveTopology,
        RasterizationState,
        StencilOp,
        StencilOpState,
        VertexLayout,
    )
    from zenith_tpu_torch.sandbox.scene import (
        SceneApp,
        build_standin_scene,
        deferred_frame,
        orbit_camera,
    )
    from zenith_tpu_torch.window import Window

    launches = {"K1": 0, "K3": 0, "K4": 0, "K5": 0}

    def counters():
        return (raster_segmented.launches, raster_segmented.stencil_launches,
                raster_segmented.peel_launches, raster_segmented_blend.launches)

    def zero_counters():
        raster_segmented.launches = raster_segmented.stencil_launches = 0
        raster_segmented.peel_launches = raster_segmented_blend.launches = 0

    def add_launches():
        for name, n in zip(("K1", "K3", "K4", "K5"), counters()):
            launches[name] += n

    def plain_path():
        return plain_versions(plain_k1)

    # -- 15a. config #3 through SceneApp at 1920x1080 ------------------------
    class ShadeOnceApp(SceneApp):
        """SceneApp whose forward renderer shades once per pixel under MSAA."""

        def prepare(self, render_device, window):
            super().prepare(render_device, window)
            self.renderer = ForwardShadowRenderer(self.renderer.scene, msaa=4,
                                                  sample_shading=False)

    # (label, app, flags, K1 launches a frame): the shadow pass, the lit
    # pass once per sample; with instances the shadow.inst pass and the
    # instanced lit pass once per sample (shade-once: one more at the
    # pixel centre).
    runs = [("1x", SceneApp, ["--msaa", "1"], 2),
            ("4x", SceneApp, ["--msaa", "4"], 1 + 4),
            ("8x", SceneApp, ["--msaa", "8"], 1 + 8),
            ("wireframe", SceneApp, ["--wireframe"], 2),
            ("4x, 64 instanced rocks", SceneApp, ["--msaa", "4", "--instances", "64"], 2 + 2 * 4),
            ("4x, 64 instanced rocks, shade once", ShadeOnceApp,
             ["--msaa", "4", "--instances", "64"], 2 + 4 + (4 + 1))]
    log = []
    real_render = Engine.render

    def render(engine, app):
        before = raster_segmented.launches
        real_render(engine, app)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        log.append((raster_segmented.launches - before, engine.last_retired.bin_overflow, ev))

    for label, app_cls, flags, per_frame in runs:
        log.clear()
        window = Window(width=W, height=H, title="scene")
        zero_counters()
        t0 = time.perf_counter()
        with mock.patch.object(Engine, "render", render):
            loop = launch(app_cls, argv=["--log-level", "warn", "--mode", "forward", *flags],
                          window=window, max_frames=FORWARD_FRAMES, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        add_launches()
        n = raster_segmented.launches
        check(loop.frames_rendered == FORWARD_FRAMES,
              f"15a {label}: rendered {loop.frames_rendered} frames")
        seen = sorted({k for k, _, _ in log})
        check(seen == [per_frame], f"15a {label}: K1 launched {seen} times a frame, not "
              f"{per_frame}")
        overflow = int(torch.stack([o for _, o, _ in log]).sum())
        check(overflow == 0, f"15a {label}: bin overflow {overflow}")
        app = loop.app
        check(app.renderer.msaa == (8 if "8x" in label else 4 if "4x" in label else 1),
              f"15a {label}: renderer at {app.renderer.msaa} samples")
        last = window.last_frame
        check(last is not None and last.shape == (H, W, 4) and last[..., :3].std() > 1.0,
              f"15a {label}: no 1080p frame presented")
        frame_ms = np.array([log[i - 1][2].elapsed_time(log[i][2]) for i in range(1, len(log))])
        steady = frame_ms[4:]
        print(f"phase 15a: SceneApp --mode forward {' '.join(flags)} ({label}) at {W}x{H}: "
              f"{FORWARD_FRAMES} frames in {wall:.2f} s with the build; steady "
              f"{1e3 / np.mean(steady):.2f} FPS, frame time p50 {np.percentile(steady, 50):.3f} "
              f"ms, p99 {np.percentile(steady, 99):.3f} ms (CUDA events between frame ends, "
              f"frames 5-{FORWARD_FRAMES}); K1 {n} launches ({per_frame} a frame); bin overflow "
              f"0, entry budgets not grown (budget scale "
              f"{CompileOptions().budget_scale}) [{card}]")
        # The last frame again through the plain version of K1 (no tick: the
        # same camera), on the rebuild path.
        app.retained = False
        pwindow = Window(width=W, height=H, title="plain")
        with mock.patch.object(raster_mod, "_raster_segmented_cuda", resolve_k1):
            engine = Engine(pwindow, device=dev)
            engine.render(app)
            engine.shutdown()
        mx, frac = lsb_diff(last, pwindow.last_frame)
        print(f"phase 15a: {label}: last frame vs the plain-path frame: max LSB diff {mx}, "
              f"{frac * 100:.4f}% values differ")
        check(mx <= 1 and frac < 0.01, f"15a {label}: the last frame differs from the "
              "plain-path frame")
        app.retained = True
        engine = Engine(Window(width=W, height=H, title="profile"), device=dev)

        def frame(_t, engine=engine, app=app):
            app.tick(0.004)
            engine.render(app)

        frame(0.0)
        if label.endswith("shade once"):
            compiled = engine._retained[0]
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                compiled.execute(engine.render_device, dynamics=app.update_dynamics())
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            print(f"phase 15a: {label}: a retained frame at 1080p made no host sync")
        nodes = ("shadow", "shadow.inst", "forward", "forward.inst", "post")
        profile_frames(frame, nodes if "instanced" in label else nodes[::2],
                       f"phase 15a: {label}", card, frame_ms[4:],
                       watch=("raster_segmented_kernel", "gather"),
                       expect={"raster_segmented_kernel": per_frame})
        engine.shutdown()

    # -- 15b. the kernels at the standard sample positions --------------------
    c_bins, c_init, compare_exact, both = cull
    grid = TileGrid(W, H)
    zero_counters()
    for off in draw_mod.SAMPLE_POSITIONS[8]:
        for cfg in (dict(compare_op=CompareOp.GREATER, depth_write=True),
                    dict(compare_op=CompareOp.LESS_OR_EQUAL, depth_write=False)):
            compare_exact(*both(c_bins, grid, c_init, sample_offset=off, **cfg),
                          f"15b cull stress at {off} {cfg['compare_op'].name}")
    add_launches()
    print(f"phase 15b: K1 on phase 2c's cull stress at the eight 8x positions "
          f"{draw_mod.SAMPLE_POSITIONS[8]}, GREATER with depth writes and LESS_OR_EQUAL "
          f"without: bit-equal to the plain version [{card}]")

    layout = VertexLayout.from_fields(("position", 4), ("color", 4))
    vs = Shader.vertex("stress.vs", lambda attrs, res: {"position": attrs["position"],
                                                       "color": attrs["color"]})
    safe_fs = Shader.fragment("stress.fs", stress_fs, bindings=[uniform("Gain")],
                              kernel_safe=True, device_source=STRESS_FS_CUDA)
    dense_fs = Shader.fragment("stress.dense.fs", stress_fs, bindings=[uniform("Gain")])
    over = ColorAttachmentDesc(blend_enable=True, src_color_blend=BlendFactor.SRC_ALPHA,
                               dst_color_blend=BlendFactor.ONE_MINUS_SRC_ALPHA,
                               src_alpha_blend=BlendFactor.ONE,
                               dst_alpha_blend=BlendFactor.ONE_MINUS_SRC_ALPHA)
    front = StencilOpState(pass_op=StencilOp.INCREMENT_AND_WRAP, depth_fail_op=StencilOp.INVERT,
                           compare_op=CompareOp.NOT_EQUAL, write_mask=0x7F, reference=5)
    back = StencilOpState(fail_op=StencilOp.DECREMENT_AND_CLAMP, pass_op=StencilOp.REPLACE,
                          compare_op=CompareOp.GREATER_OR_EQUAL, compare_mask=0x0F, reference=3)
    cases = [
        ("K3", dense_fs, ColorAttachmentDesc(), DepthStencilDesc(
            depth_test_enable=True, depth_write_enable=True,
            depth_compare_op=CompareOp.GREATER_OR_EQUAL, stencil_test_enable=True,
            stencil_front=front, stencil_back=back), {}),
        ("K4", dense_fs, over, DepthStencilDesc(
            depth_test_enable=True, depth_write_enable=False,
            depth_compare_op=CompareOp.GREATER), dict(peel_layers=3)),
        ("K5", safe_fs, over, DepthStencilDesc(
            depth_test_enable=True, depth_write_enable=False,
            depth_compare_op=CompareOp.GREATER), {}),
    ]
    draws = translucent_stress(dev, n_draws=2)
    rng = np.random.default_rng(37)
    bg = torch.from_numpy(rng.uniform(0.0, 2.0, (4, H, W, 4)).astype(np.float32)).to(dev)
    z0 = torch.from_numpy(rng.uniform(0.0, 0.3, (4, H, W)).astype(np.float32)).to(dev)
    s0 = torch.from_numpy(rng.integers(0, 8, (4, H, W)).astype(np.int32)).to(dev)
    for name, fs, cdesc, ds, kw in cases:
        pipeline = pipe.GraphicPipeline(pipe.GraphicPipelineDesc(
            shader_input=GraphicShaderInput(vs, fs, layout),
            state=GraphicPipelineState(
                rasterization=RasterizationState(cull_mode=CullMode.NONE), depth_stencil=ds,
                multisample=MultisampleState(samples=4)),
            attachments=GraphicPipelineAttachments(
                color_formats=(Format.RGBA32F,), depth_format=Format.D32F,
                stencil_format=Format.S8 if ds.stencil_test_enable else None),
            color_attachment_descs=(cdesc,),
        ))

        def run(pipeline=pipeline, kw=kw, stencil=ds.stencil_test_enable):
            return draw_mod.draw_indexed_batch(
                [bg], z0, pipeline, draws, grid, per_draw_uniforms=("Gain",),
                entry_budget=STRESS_ENTRY_BUDGET, stencil=s0 if stencil else None, **kw)

        zero_counters()
        (kc, kz, ks) = run()
        torch.cuda.synchronize()
        add_launches()
        n = dict(zip(("K1", "K3", "K4", "K5"), counters()))
        with plain_path():
            (pc, pz, ps) = run()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(kc[0]).all()), f"15b {name}: non-finite colour")
        check(torch.equal(kz, pz), f"15b {name} 4x: z differs from the plain path")
        if ks.stencil is not None:
            check(torch.equal(ks.stencil, ps.stencil), f"15b {name} 4x: stencil differs")
            check(not torch.equal(ks.stencil, s0), f"15b {name} 4x: stencil unchanged")
        err = (kc[0] - pc[0]).abs()
        bad = int((err > 1e-5 + 1e-5 * pc[0].abs()).sum())
        check(bad == 0, f"15b {name} 4x: {bad} colour values beyond atol 1e-5 + rtol 1e-5 "
              f"(max {err.max().item():.3e})")
        check(int(ks.bin_overflow) == int(ps.bin_overflow), f"15b {name}: overflow differs")
        check(n[name] >= 4, f"15b {name}: launched {n[name]} times for 4 samples")
        print(f"phase 15b: {name} under 4x MSAA through draw_indexed_batch ({len(draws)} "
              f"draws of 32 of phase 10's translucent stress triangles at {W}x{H}"
              f"{', 3 peel layers' if name == 'K4' else ''}): launches "
              f"{', '.join(f'{k} {v}' for k, v in n.items() if v)}; z"
              f"{' and stencil' if ks.stencil is not None else ''} bit-equal to the plain path, "
              f"colour max err {err.max().item():.3e} [{card}]")

    # -- 15c. lines, points and the wireframe views at 1080p -------------------
    rng = np.random.default_rng(41)

    def line_pipeline(topology, restart=False, width=1.0):
        def vs_sized(attrs, res):
            return {"position": attrs["position"], "color": attrs["color"],
                    "point_size": 1.0 + 5.0 * attrs["color"][:, 3:4]}

        pvs = (Shader.vertex("points.vs", vs_sized) if topology == PrimitiveTopology.POINT_LIST
               else vs)
        return pipe.GraphicPipeline(pipe.GraphicPipelineDesc(
            shader_input=GraphicShaderInput(
                pvs, Shader.fragment("lines.fs", lambda v, r, b: v["color"]), layout),
            state=GraphicPipelineState(
                input_assembly=InputAssemblyState(topology=topology, primitive_restart=restart),
                rasterization=RasterizationState(cull_mode=CullMode.NONE, line_width=width),
                depth_stencil=DepthStencilDesc().reverse_z()),
            attachments=GraphicPipelineAttachments(color_formats=(Format.RGBA32F,),
                                                   depth_format=Format.D32F),
            color_attachment_descs=(ColorAttachmentDesc(clear_value=(0, 0, 0, 0)),),
        ))

    def vertices(px):
        """Clip-space rows over the pixel positions ``px`` (N, 2) with a
        random w, depth and RGBA; every 200th vertex beyond the near plane
        (a clipped segment reaches far off-screen: at most 256 such records
        bin at once, binning's huge-span cap)."""
        n = px.shape[0]
        w = rng.uniform(0.6, 1.8, (n, 1))
        z = rng.uniform(0.02, 0.98, (n, 1)) * w
        z[::200] = 1.3 * w[::200]
        ndc = px / [W / 2, H / 2] - 1.0
        col = rng.uniform(0.05, 1.0, (n, 4))
        rows = np.concatenate([ndc * w, z, w, col], 1).astype(np.float32)
        return torch.from_numpy(rows).to(dev)

    # Segments short enough to span at most 2x2 tiles (binning's tier that
    # holds any number of records); the strip's walk reflects at the border.
    seg0 = rng.uniform(0, 1, (10000, 2)) * [W, H]
    seg = np.stack([seg0, seg0 + rng.uniform([-60, -24], [60, 24], (10000, 2))],
                   1).reshape(-1, 2)
    walk = np.cumsum(rng.uniform([-30, -12], [30, 12], (4000, 2)), 0) % [2 * W, 2 * H]
    walk = np.array([W, H]) - np.abs(walk - [W, H])
    strip = np.arange(4000, dtype=np.int32)
    strip[rng.choice(4000, 40, replace=False)] = -1
    prims = [
        ("line list, 10,000 segments of up to 65 px, 1.5 px wide",
         line_pipeline(PrimitiveTopology.LINE_LIST, width=1.5), vertices(seg),
         torch.arange(20000, dtype=torch.int32, device=dev)),
        ("line strip with 40 restarts, 4,000 indices",
         line_pipeline(PrimitiveTopology.LINE_STRIP, restart=True), vertices(walk),
         torch.from_numpy(strip).to(dev)),
        ("point list, 20,000 points of 1-6 px", line_pipeline(PrimitiveTopology.POINT_LIST),
         vertices(rng.uniform(0, 1, (20000, 2)) * [W, H]),
         torch.arange(20000, dtype=torch.int32, device=dev)),
    ]
    for what, pipeline, vb, ib in prims:
        def run(pipeline=pipeline, vb=vb, ib=ib):
            return draw_mod.draw_indexed([torch.zeros((H, W, 4), device=dev)],
                                         torch.zeros((H, W), device=dev), pipeline, vb, ib, {},
                                         grid, entry_budget=1 << 20)

        zero_counters()
        kc, kz, ks = run()
        torch.cuda.synchronize()
        add_launches()
        n = raster_segmented.launches
        with mock.patch.object(raster_mod, "_raster_segmented_cuda", resolve_k1):
            pc, pz, ps = run()
        torch.cuda.synchronize()
        check(torch.equal(kz, pz) and torch.equal(kc[0], pc[0]),
              f"15c {what}: differs from the plain path")
        check(int(ks.bin_overflow) == 0, f"15c {what}: bin overflow {int(ks.bin_overflow)}")
        cov = int((kc[0][..., 3] > 0).sum())
        check(cov > 1000, f"15c {what}: covers {cov} px")
        print(f"phase 15c: {what} at {W}x{H}: K1 {n} launch, {cov} px covered; z and colour "
              f"bit-equal to the plain path [{card}]")

    device = RhiCore(dev).create_render_device()
    scene, mesh = build_standin_scene(device, 100, np.random.default_rng(42))
    camera = Camera(fov_y=Degree(35.0), aspect_ratio=W / H)
    orbit_camera(camera, 0.3)
    renderer = DeferredRenderer(scene, wireframe=True)
    zero_counters()
    compiled, out, _, retired = deferred_frame(device, renderer, camera, W, H, CompileOptions(),
                                               present_format=Format.BGRA8_SRGB)
    img = compiled.value(out).cpu().numpy()
    add_launches()
    n = raster_segmented.launches
    check(int(retired.bin_overflow) == 0, "15c deferred wireframe: bin overflow")
    with resolved_plain_path():
        pc, pout, _, _ = deferred_frame(device, renderer, camera, W, H, CompileOptions(),
                                        present_format=Format.BGRA8_SRGB)
        ref = pc.value(pout).cpu().numpy()
    mx, frac = lsb_diff(img, ref)
    check(mx <= 1 and frac < 0.01, "15c deferred wireframe: differs from the plain path")
    print(f"phase 15c: deferred wireframe view of phase 7's scene ({mesh.num_triangles}-"
          f"triangle stand-in, 100 lights) at {W}x{H}: K1 {n} launches, bin overflow 0; vs the "
          f"plain-path frame max LSB diff {mx}, {frac * 100:.4f}% values differ [{card}]")
    return launches


TERRAIN_FRAMES = 30
SCENE_FEATURE_FRAMES = 30
FLY_FRAMES = 60
MESH_FRAMES = 30
FEATURE_FLAGS = ["--ssao", "--contact-shadows", "--ssr", "--fog", "--sky", "--flare",
                 "--decals", "8"]


def app_run(app_cls, argv, window, frames, dev, per_frame, label, frame_callback=None,
            overflow_ok=False):
    """Drive ``app_cls`` through the engine loop (``launch``, or the loop
    with ``frame_callback`` as FlyApp's main drives it) for ``frames``
    frames, with K1's and K2's counts set to 0 just before and read just
    after. Checks that every frame launched (K1, K2) ``per_frame`` times
    with no bin overflow (unless ``overflow_ok``: then it is printed) and
    that a frame was presented. Returns (loop, frame times in ms between
    frame ends, wall seconds, (K1, K2) launches)."""
    import torch

    from zenith_tpu_torch import asset
    from zenith_tpu_torch.core.cli import EngineArgs
    from zenith_tpu_torch.engine import Engine
    from zenith_tpu_torch.launch import launch
    from zenith_tpu_torch.main_loop import EngineLoop
    from zenith_tpu_torch.ops.lighting import accumulate_point_lights
    from zenith_tpu_torch.ops.raster import raster_segmented

    log = []
    real_render = Engine.render

    def render(engine, app):
        before = (raster_segmented.launches, accumulate_point_lights.launches)
        real_render(engine, app)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        log.append((raster_segmented.launches - before[0],
                    accumulate_point_lights.launches - before[1],
                    engine.last_retired.bin_overflow, ev))

    raster_segmented.launches = 0
    accumulate_point_lights.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(Engine, "render", render):
        if frame_callback is None:
            loop = launch(app_cls, argv=["--log-level", "warn", *argv], window=window,
                          max_frames=frames, device=dev)
        else:
            asset.initialize()
            loop = EngineLoop(app_cls(EngineArgs.parse_args(["--log-level", "warn", *argv])),
                              window=window, device=dev)
            loop.run(max_frames=frames, frame_callback=frame_callback)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (raster_segmented.launches, accumulate_point_lights.launches)
    check(loop.frames_rendered == frames, f"{label}: rendered {loop.frames_rendered} frames")
    seen = sorted({(k1, k2) for k1, k2, _, _ in log})
    check(seen == [per_frame], f"{label}: (K1, K2) launched {seen} times a frame, not "
          f"{per_frame}")
    overflow = int(torch.stack([o for _, _, o, _ in log]).sum())
    if overflow_ok:
        print(f"{label}: bin overflow {overflow} entries in {frames} frames")
    else:
        check(overflow == 0, f"{label}: bin overflow {overflow}")
    last = window.last_frame
    check(last is not None and last.shape == (window.height, window.width, 4)
          and last[..., :3].std() > 1.0, f"{label}: no frame presented")
    frame_ms = np.array([log[i - 1][3].elapsed_time(log[i][3]) for i in range(1, len(log))])
    return loop, frame_ms, wall, counts


def frame_line(tag, label, frames, wall, frame_ms, counts, card, overflow_ok=False) -> None:
    steady = frame_ms[4:]
    print(f"{tag}: {label}: {frames} frames in {wall:.2f} s with the build; steady "
          f"{1e3 / np.mean(steady):.2f} FPS, frame time p50 {np.percentile(steady, 50):.3f} ms, "
          f"p99 {np.percentile(steady, 99):.3f} ms (CUDA events between frame ends, frames "
          f"5-{frames}); K1 {counts[0]}, K2 {counts[1]} launches; "
          f"{'bin overflow per pass below' if overflow_ok else 'bin overflow 0'} [{card}]")


def plain_frame_check(app, window, dev, tag, label):
    """The app's last frame again (no tick: the same camera) on a fresh
    engine's rebuild path through the plain versions, against the frame the
    run presented: <= 1 LSB, < 1% of values. Returns the plain path's
    seconds."""
    import torch

    from zenith_tpu_torch.engine import Engine
    from zenith_tpu_torch.window import Window

    pwindow = Window(width=window.width, height=window.height, title="plain")
    t0 = time.perf_counter()
    with resolved_plain_path():
        engine = Engine(pwindow, device=dev)
        engine.render(app)
        engine.shutdown()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    mx, frac = lsb_diff(window.last_frame, pwindow.last_frame)
    print(f"{tag}: {label}: last frame vs the plain-path frame: max LSB diff {mx}, "
          f"{frac * 100:.4f}% values differ (plain path {secs:.1f} s)")
    check(mx <= 1 and frac < 0.01, f"{tag} {label}: the last frame differs from the "
          "plain-path frame")
    return secs


def terrain_phases(dev, card: str, plain_k1) -> dict:
    """Phase 16: the terrain flyover and item 21's single-target screen-space
    passes. (16a) launch(TerrainApp) at 1920x1080 at its defaults, then with
    --contact-shadows; (16b) the six feature goldens; (16c) SceneApp
    --mode deferred with the seven flags over the baked cerberus; (16d)
    FlyApp's scripted flight and MeshApp. Returns K1's and K2's launches on
    these paths."""
    import torch

    from zenith_tpu_torch.engine import Engine
    from zenith_tpu_torch.ops import draw as draw_mod
    from zenith_tpu_torch.ops import raster as raster_mod
    from zenith_tpu_torch.ops.lighting import accumulate_point_lights
    from zenith_tpu_torch.ops.raster import raster_segmented
    from zenith_tpu_torch.rhi import RhiCore
    from zenith_tpu_torch.sandbox.fly import FlyApp, scripted_flight
    from zenith_tpu_torch.sandbox.mesh import MeshApp
    from zenith_tpu_torch.sandbox.scene import FEATURE_GOLDENS, SceneApp, feature_golden_frame
    from zenith_tpu_torch.sandbox.terrain import TerrainApp
    from zenith_tpu_torch.window import Window

    launches = {"K1": 0, "K2": 0}

    def add(counts):
        launches["K1"] += counts[0]
        launches["K2"] += counts[1]

    def profile_app(app, engine, tag, nodes, frame_ms, expect):
        def frame(_t):
            app.tick(0.004)
            engine.render(app)

        frame(0.0)
        profile_frames(frame, nodes, tag, card, frame_ms,
                       watch=("raster_segmented_kernel", "tiled_lights_kernel", "gather"),
                       expect=expect)

    # -- 16a. the terrain flyover at its defaults, 1920x1080 -----------------
    for label, flags in (("defaults", []), ("--contact-shadows", ["--contact-shadows"])):
        tag = f"phase 16a ({label})"
        window = Window(width=W, height=H, title="terrain")
        loop, frame_ms, wall, counts = app_run(TerrainApp, flags, window, TERRAIN_FRAMES, dev,
                                               (2, 0), tag)
        add(counts)
        app = loop.app
        check(app.tri_count == 2 * 767 * 767, f"{tag}: {app.tri_count} triangles")
        frame_line(tag, f"TerrainApp {' '.join(flags) or '(no flags)'} at {W}x{H}, "
                   f"{app.tri_count} triangles in one draw", TERRAIN_FRAMES, wall, frame_ms,
                   counts, card)
        if not flags:
            # K1 on the terrain's own shadow and G-buffer records: bit-equal to
            # its unculled plain walk, timed bare and against its bound.
            device = RhiCore(dev).create_render_device()
            calls = []
            real_raster = draw_mod.raster_segmented

            def recording_raster(bins, grid, init_z, **kw):
                calls.append((bins, grid, init_z.clone(), kw))
                return real_raster(bins, grid, init_z, **kw)

            engine = Engine(Window(width=W, height=H, title="calls"), device=dev)
            with mock.patch.object(draw_mod, "raster_segmented", recording_raster):
                engine.render(app)
            engine.shutdown()
            check(len(calls) == 2, f"{tag}: K1 ran {len(calls)} times in a frame")
            for name, (bins, grid, init_z, kw) in zip(("shadow 2048^2", "G-buffer"), calls):
                k = raster_segmented(bins, grid, init_z, **kw)
                t0 = time.perf_counter()
                with mock.patch.object(raster_mod, "_raster_segmented_cuda", plain_k1):
                    p = raster_segmented(bins, grid, init_z, **kw)
                torch.cuda.synchronize()
                p_s = time.perf_counter() - t0
                for a, b_ in zip(k, p):
                    check(torch.equal(a, b_), f"{tag}: K1 differs from its plain walk on the "
                          f"{name} pass")
                cov = int((k[1][-1] > 0).sum())
                ms = kernel_ms(lambda c=(bins, grid, init_z, kw): raster_segmented(
                    c[0], c[1], c[2], **c[3]), lambda: None)
                b_ms, b_by, frags = k1_bound(bins, grid, cov)
                print(f"{tag}: K1 {name} pass: {int(bins.blk_count.sum())} entries, largest "
                      f"tile {tile_entries(bins, grid)}, {frags} fragments, {cov} px covered; "
                      f"bit-equal to the unculled plain walk ({p_s:.1f} s); device time "
                      f"{ms:.4f} ms (CUDA events round the bare launch), bound {b_ms:.4f} ms "
                      f"({b_by}) [{card}]")
            raster_segmented.launches = 0  # the checks above are not the path's launches
        plain_frame_check(app, window, dev, tag, "TerrainApp")
        engine = Engine(Window(width=W, height=H, title="profile"), device=dev)
        app.tick(0.004)
        engine.render(app)
        sync_free(engine, app, tag)
        profile_app(app, engine, tag, ("shadow", "gbuffer", "lighting", "post"), frame_ms,
                    {"raster_segmented_kernel": 2})
        engine.shutdown()

    # -- 16b. the six feature goldens on the card -------------------------------
    device = RhiCore(dev).create_render_device()
    base = feature_golden_frame(device, "base").cpu().numpy()
    for cfg in FEATURE_GOLDENS:
        before = (raster_segmented.launches, accumulate_point_lights.launches)
        img = feature_golden_frame(device, cfg).cpu().numpy()
        ran = (raster_segmented.launches - before[0], accumulate_point_lights.launches - before[1])
        golden = np.load(REPO / "tests" / "golden" / f"feat_{cfg}_128x64.npy")
        mx, frac = lsb_diff(img, golden)
        print(f"phase 16b: feat_{cfg}_128x64 on the card: max LSB diff {mx}, "
              f"{frac * 100:.3f}% values differ; K1 {ran[0]}, K2 {ran[1]} launches; the golden "
              f"differs from the base frame in {int((golden != base).any(-1).sum())} pixels")
        check(ran == (2, 1), f"16b {cfg}: (K1, K2) ran {ran} times")
        check(mx <= 1 and frac < 0.01, f"16b: the {cfg} golden drifted")
        check((golden != base).any(), f"16b: the {cfg} golden equals the base frame")
    raster_segmented.launches = 0
    accumulate_point_lights.launches = 0

    # -- 16c. SceneApp --mode deferred with the seven flags at 1080p -----------
    tag = "phase 16c"
    window = Window(width=W, height=H, title="scene")
    loop, frame_ms, wall, counts = app_run(SceneApp, ["--mode", "deferred", *FEATURE_FLAGS],
                                           window, SCENE_FEATURE_FRAMES, dev, (2, 1), tag)
    add(counts)
    app = loop.app
    check(app.renderer.ssao is not None and app.ssr is not None and app.fog is not None
          and app.flare is not None and app.renderer.scene.atmosphere is not None
          and len(app.renderer.scene.decals) == 8 and app.renderer.scene.sun.contact_shadows,
          f"{tag}: a flag did not reach the renderer")
    frame_line(tag, f"SceneApp --mode deferred {' '.join(FEATURE_FLAGS)} at {W}x{H}",
               SCENE_FEATURE_FRAMES, wall, frame_ms, counts, card)
    plain_frame_check(app, window, dev, tag, "SceneApp")
    engine = Engine(Window(width=W, height=H, title="profile"), device=dev)
    app.tick(0.004)
    engine.render(app)
    sync_free(engine, app, tag)
    profile_app(app, engine, tag, ("shadow", "gbuffer", "decals", "ssao", "lighting", "ssr",
                                   "fog", "flare", "post"), frame_ms,
                {"raster_segmented_kernel": 2, "tiled_lights_kernel": 1})
    engine.shutdown()

    # -- 16d. FlyApp's scripted flight and MeshApp ------------------------------
    for label, app_cls, size, frames, per_frame, callback in (
            ("FlyApp", FlyApp, (1280, 720), FLY_FRAMES, (2, 0), scripted_flight),
            ("MeshApp", MeshApp, (W, H), MESH_FRAMES, (1, 0), None)):
        tag = f"phase 16d ({label})"
        window = Window(width=size[0], height=size[1], title=label)
        loop, frame_ms, wall, counts = app_run(app_cls, [], window, frames, dev, per_frame,
                                               tag, frame_callback=callback)
        add(counts)
        frame_line(tag, f"{label} at {size[0]}x{size[1]}", frames, wall, frame_ms, counts,
                   card)
        if label == "FlyApp":
            print(f"{tag}: camera at {np.round(np.asarray(loop.app.camera.location), 3)} "
                  f"after the scripted flight")
        plain_frame_check(loop.app, window, dev, tag, label)
    return launches


LAYERED_FRAMES = 30
INSTANCED_FLAGS = ["--mode", "deferred", "--gun-instances", "30", "--instances", "64"]
LAYERED_FLAGS = ["--cascades", "3", "--point-shadows", "--bloom-mips", "5"]
# K1 a frame, from the node structure (renderer/deferred.py): the plain
# shadow pass (the ground) and one instanced draw per instanced object
# (cerberus x30, the rocks) per shadow map or cascade layer, the six cube
# faces of the point light (the ground), the G-buffer pass and its two
# instanced draws.
K1_INSTANCED = 1 + 2 + 1 + 2
K1_LAYERED = 3 * (1 + 2) + 6 + 1 + 2


def recorded_frame(engine_dev, app, calls_of):
    """One frame of ``app`` on a fresh engine with K1's and K2's wrappers
    recorded: returns [(render-graph node, wrapper, args, kwargs)] in call
    order, the inputs cloned before the call."""
    from zenith_tpu_torch.engine import Engine
    from zenith_tpu_torch.window import Window

    engine = Engine(Window(width=W, height=H, title="calls"), device=engine_dev)
    calls = recorded_calls(lambda: engine.render(app), calls_of)
    engine.shutdown()
    return calls


def recorded_calls(run, calls_of):
    """``run()`` with the wrappers that ``calls_of`` names ("K1", "K2",
    "K5") recorded: [(render-graph node, wrapper, args, kwargs)] in call
    order, the inputs cloned before the call. The node is each thread's
    own: the shards of a banded frame run their nodes at once."""
    import threading

    import torch

    from zenith_tpu_torch.core import profile
    from zenith_tpu_torch.ops import draw as draw_mod
    from zenith_tpu_torch.renderer import deferred as deferred_mod

    node = threading.local()
    calls = []
    real_scope, real_raster = profile.scope, draw_mod.raster_segmented
    real_blend = draw_mod.raster_segmented_blend
    real_lights = deferred_mod.accumulate_point_lights

    @contextlib.contextmanager
    def scope(name):
        node.name = name
        with real_scope(name):
            yield

    def rec(kind, fn):
        def call(*args, **kw):
            if kind in calls_of:
                cloned = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
                calls.append((getattr(node, "name", "?"), kind, cloned, dict(kw)))
            return fn(*args, **kw)
        return call

    with mock.patch.object(profile, "scope", scope), \
            mock.patch.object(draw_mod, "raster_segmented", rec("K1", real_raster)), \
            mock.patch.object(draw_mod, "raster_segmented_blend", rec("K5", real_blend)), \
            mock.patch.object(deferred_mod, "accumulate_point_lights", rec("K2", real_lights)):
        run()
    torch.cuda.synchronize()
    return calls


def k1_against_unculled(calls, plain_k1, tag, card, want, overflow_ok=()) -> None:
    """Each recorded K1 call of a node that ``want`` accepts: the kernel
    bit-equal to its unculled plain walk (bins without rectangles), with
    its entries, fragments, overflow, device time and bound. Only nodes
    named in ``overflow_ok`` may overflow their bins."""
    import torch

    from zenith_tpu_torch.ops import raster as raster_mod
    from zenith_tpu_torch.ops.raster import raster_segmented

    checked = 0
    for node, _, (bins, grid, init_z), kw in calls:
        if not want(node):
            continue
        k = raster_segmented(bins, grid, init_z, **kw)
        t0 = time.perf_counter()
        with mock.patch.object(raster_mod, "_raster_segmented_cuda", plain_k1):
            p = raster_segmented(bins, grid, init_z, **kw)
        torch.cuda.synchronize()
        p_s = time.perf_counter() - t0
        for a, b_ in zip(k, p):
            check(torch.equal(a, b_), f"{tag}: K1 differs from its unculled plain walk on {node}")
        cov = int((k[1][-1] > 0).sum())
        ms = kernel_ms(lambda c=(bins, grid, init_z, kw): raster_segmented(
            c[0], c[1], c[2], **c[3]), lambda: None)
        b_ms, b_by, frags = k1_bound(bins, grid, cov)
        print(f"{tag}: K1 {node} ({grid.width}x{grid.height}): {int(bins.blk_count.sum())} "
              f"entries, largest tile {tile_entries(bins, grid)}, {frags} fragments, {cov} px "
              f"covered, overflow {int(bins.overflow)}; bit-equal to the unculled plain walk "
              f"({p_s:.1f} s); device time {ms:.4f} ms (CUDA events round the bare launch), "
              f"bound {b_ms:.4f} ms ({b_by}) [{card}]")
        check(int(bins.overflow) == 0 or node in overflow_ok,
              f"{tag}: {node} overflowed its bins")
        checked += 1
    check(checked > 0, f"{tag}: no K1 call checked")
    raster_segmented.launches = 0  # the checks are not the path's launches


def separate_objects(scene):
    """``scene`` with every instanced object replaced by one object per
    instance at a translated model matrix (the oracle of the reference's
    tests/test_instancing.py::TestInstancedScene)."""
    from zenith_tpu_torch.core.mathtypes import mat4_translation

    objects = []
    for o in scene.objects:
        if o.instance_offsets is None:
            objects.append(o)
            continue
        for k, off in enumerate(np.asarray(o.instance_offsets, np.float32)):
            objects.append(dataclasses.replace(
                o, name=f"{o.name}.{k}", instance_offsets=None,
                model_matrix=(mat4_translation(off) @ o.model_matrix).astype(np.float32)))
    return dataclasses.replace(scene, objects=objects)


def subresource_cases(dev) -> dict:
    """The render graph's sub-resource views through the port on ``dev``
    (twins of tests/test_subresource.py): a triangle rendered into one cube
    face and cube-sampled, a depth draw into one layer of a 2D array, a
    render-to-mip, buffer ranges, a layered mip chain written at (mip 1,
    layer 1) and the render-to-mip bloom chain. Returns {case: [numpy
    arrays]}."""
    import torch

    from zenith_tpu_torch.ops.sampling import sample_cube
    from zenith_tpu_torch.renderer import PostProcess
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.rhi import (
        BufferDesc,
        ColorAttachmentDesc,
        Format,
        GraphicShaderInput,
        PipelineCache,
        RhiCore,
        Shader,
        TextureDesc,
        attr,
    )
    from zenith_tpu_torch.rhi.state import (
        CompareOp,
        CullMode,
        DepthStencilDesc,
        GraphicPipelineState,
        RasterizationState,
        VertexLayout,
    )

    device = RhiCore(dev).create_render_device()
    layout = VertexLayout.from_fields(("position", 3), ("color", 3))
    vs = Shader.vertex("sub.vs", lambda a, r: {
        "position": torch.cat([a["position"], torch.ones_like(a["position"][:, :1])], 1),
        "color": a["color"]}, inputs=[attr("position", 3), attr("color", 3)])
    fs = Shader.fragment("sub.fs", lambda v, r, b: torch.cat(
        [v["color"], torch.ones_like(v["color"][..., :1])], -1))
    state = GraphicPipelineState(rasterization=RasterizationState(cull_mode=CullMode.NONE))
    tri = np.array([[-0.9, -0.9, 0.5, 1, 0, 0], [0.9, -0.9, 0.5, 1, 0, 0],
                    [0.0, 0.9, 0.5, 1, 0, 0]], np.float32)
    opts = CompileOptions(tile_h=8, tile_w=128)

    def run(builder, handles):
        compiled = builder.build().compile(device, PipelineCache(), opts)
        compiled.execute(device)
        out = []
        for h in handles:
            v = compiled.value(h)
            out += [x.cpu().numpy() for x in (v if isinstance(v, tuple) else (v,))]
        return out

    def draw_into(name, handle, with_fs=True, depth=False, **sel):
        builder, tex = handle
        node = builder.add_graphic_node(name)
        vb = builder.import_resource(device.upload_buffer("vb", tri))
        ib = builder.import_resource(device.upload_buffer("ib", np.array([0, 1, 2], np.int32)))
        vba, iba = node.read(vb), node.read(ib)
        rt = node.write(tex, **sel)
        with node.pipeline(GraphicShaderInput(vs, fs if with_fs else None, layout),
                           state) as binder:
            if depth:
                binder.set_depth(rt, DepthStencilDesc(
                    depth_test_enable=True, depth_write_enable=True,
                    depth_compare_op=CompareOp.GREATER, depth_clear_value=0.0))
            else:
                binder.push_color(rt, ColorAttachmentDesc(clear_value=(0, 0, 1, 1)))
        node.execute(lambda ctx: ctx.draw_indexed(vba, iba, {}))

    cases = {}
    b = RenderGraphBuilder()
    cube = b.create(TextureDesc.new_cube("cube", 64, Format.RGBA32F))
    b.export(cube)
    draw_into("to_face", (b, cube), layer=2)
    out = b.create(TextureDesc.color("sampled", 8, 8))
    b.export(out)
    node = b.add_lambda_node("sample")
    cin, dst = node.read(cube), node.write(out)
    node.execute(lambda ctx: ctx.set(dst, sample_cube(ctx.get(cin), torch.tensor(
        [0.0, 1.0, 0.0], device=dev).expand(8, 8, 3))))
    cases["cube face"] = run(b, [cube, out])
    b = RenderGraphBuilder()
    arr = b.create(TextureDesc.new_2d_array("cascades", 128, 32, 2, Format.D32F))
    b.export(arr)
    draw_into("cascade1", (b, arr), with_fs=False, depth=True, layer=1)
    cases["layer depth"] = run(b, [arr])
    b = RenderGraphBuilder()
    mips = b.create(TextureDesc("mips", 256, 128, Format.RGBA32F, mip_levels=3))
    b.export(mips)
    draw_into("to_mip1", (b, mips), mip=1)
    cases["render-to-mip"] = run(b, [mips])
    b = RenderGraphBuilder()
    buf = b.create(BufferDesc("ranges", (16,), "float32"))
    b.export(buf)
    node = b.add_lambda_node("fill")
    head, tail = node.write(buf, brange=(0, 4)), node.write(buf, brange=(12, 4))

    def fill(ctx):
        ctx.set(head, torch.full((4,), 1.0, device=dev))
        ctx.set(tail, torch.full((4,), 2.0, device=dev))

    node.execute(fill)
    cases["buffer range"] = run(b, [buf])
    b = RenderGraphBuilder()
    env = b.create(TextureDesc("env", 256, 128, Format.RGBA32F, mip_levels=2, array_layers=2))
    b.export(env)
    draw_into("to_mip1_layer1", (b, env), mip=1, layer=1)
    cases["layered mip chain"] = run(b, [env])
    b = RenderGraphBuilder()
    hdr_np = np.zeros((68, 136, 4), np.float32)
    hdr_np[20:30, 40:60, :3] = 5.0
    hdr = b.create(TextureDesc.color("hdr", 136, 68))
    ldr = b.create(TextureDesc.color("ldr", 136, 68))
    b.export(ldr)
    node = b.add_lambda_node("seed")
    sdst = node.write(hdr)
    node.execute(lambda ctx: ctx.set(sdst, torch.from_numpy(hdr_np).to(dev)))
    PostProcess(bloom_mips=3).render_to(b, hdr, ldr)
    cases["bloom mip chain"] = run(b, [ldr])
    return cases


def layered_phases(dev, card: str, plain_k1) -> dict:
    """Phase 17: deferred instancing, the render graph's sub-resource views
    and the layered shadows with the bloom mip chain. (17a) SceneApp --mode
    deferred --gun-instances 30 --instances 64 at 1920x1080: K1 on every
    pass bit-equal to its unculled plain walk, the frame against the same
    scene drawn as separate objects; (17b) the same with --cascades 3
    --point-shadows --bloom-mips 5: K1 on the three cascade layers and the
    six cube faces bit-equal to the unculled walk, K2 on the 100 unshadowed
    lights against its plain version; (17c) with --soft-shadows (VSM);
    each last frame against its plain path, a retained frame without host
    sync, a profile; (17d) the sub-resource views on the card against the
    same code on the CPU. Returns K1's and K2's launches on these paths."""
    import torch

    from zenith_tpu_torch.engine import Engine
    from zenith_tpu_torch.ops import lighting as lighting_mod
    from zenith_tpu_torch.ops import raster as raster_mod
    from zenith_tpu_torch.rendergraph import CompileOptions
    from zenith_tpu_torch.renderer import DeferredRenderer
    from zenith_tpu_torch.rhi import Format, RhiCore
    from zenith_tpu_torch.sandbox.scene import SceneApp, deferred_frame
    from zenith_tpu_torch.window import Window

    launches = {"K1": 0, "K2": 0}

    def run(tag, flags, per_frame, nodes, overflow_ok=False):
        window = Window(width=W, height=H, title="scene")
        loop, frame_ms, wall, counts = app_run(SceneApp, flags, window, LAYERED_FRAMES, dev,
                                               per_frame, tag, overflow_ok=overflow_ok)
        launches["K1"] += counts[0]
        launches["K2"] += counts[1]
        app = loop.app
        objs = [o for o in app.renderer.scene.objects if not o.translucent]
        tris = sum(o.tri_count * o.instance_count for o in objs)
        frame_line(tag, f"SceneApp {' '.join(flags)} at {W}x{H}, {tris} triangles submitted "
                   f"to each of the G-buffer and every shadow pass", LAYERED_FRAMES, wall,
                   frame_ms, counts, card, overflow_ok)
        print(f"{tag}: K1 {per_frame[0]}, K2 {per_frame[1]} launches a frame, as predicted "
              f"from the node structure; render-graph nodes {', '.join(nodes)}")
        plain_frame_check(app, window, dev, tag, "SceneApp")
        engine = Engine(Window(width=W, height=H, title="profile"), device=dev)
        app.tick(0.004)
        engine.render(app)
        sync_free(engine, app, tag)

        def frame(_t):
            app.tick(0.004)
            engine.render(app)

        frame(0.0)
        # "gemm": cuBLAS runs the lighting's (H, W, 4) x (4, 4) projections,
        # the cascade selection's among them (reference deferred.py:2125-2135).
        profile_frames(frame, nodes, tag, card, frame_ms,
                       watch=("raster_segmented_kernel", "tiled_lights_kernel", "gather",
                              "gemm"),
                       expect={"raster_segmented_kernel": per_frame[0],
                               "tiled_lights_kernel": per_frame[1]})
        engine.shutdown()
        return app

    # -- 17a. deferred instancing: x30 cerberus and 64 rocks -------------------
    t0 = time.perf_counter()
    tag = "phase 17a"
    inst_nodes = ("shadow", "shadow.inst", "gbuffer", "gbuffer.inst", "lighting", "post")
    app = run(tag, INSTANCED_FLAGS, (K1_INSTANCED, 1), inst_nodes)
    calls = recorded_frame(dev, app, ("K1",))
    check([c[0] for c in calls] == ["shadow", "shadow.inst", "shadow.inst", "gbuffer",
                                    "gbuffer.inst", "gbuffer.inst"],
          f"{tag}: K1 ran on nodes {[c[0] for c in calls]}")
    k1_against_unculled(calls, plain_k1, tag, card, lambda n: True)
    device = RhiCore(dev).create_render_device()
    images = []
    for renderer in (app.renderer, DeferredRenderer(separate_objects(app.renderer.scene))):
        compiled, final, _, retired = deferred_frame(device, renderer, app.camera, W, H,
                                                     CompileOptions(),
                                                     present_format=Format.RGBA8_SRGB)
        check(int(retired.bin_overflow) == 0, f"{tag}: bin overflow in the oracle frames")
        images.append(compiled.value(final).cpu().numpy())
    # The two vertex paths round world positions apart ((M p) + o against
    # (T(o) M) p), so a few silhouette pixels flip coverage: <= 1 LSB with
    # < 1% of values differing on all but 0.05% of the pixels.
    mx, frac = lsb_diff(*images)
    d = np.abs(images[0].astype(np.int16) - images[1].astype(np.int16)).max(-1)
    print(f"{tag}: the still frame against the same scene drawn as "
          f"{len(separate_objects(app.renderer.scene).objects)} separate objects: max LSB diff "
          f"{mx}, {frac * 100:.4f}% values differ, {int((d > 1).sum())} pixels by more than 1 "
          f"LSB [{card}]")
    check(frac < 0.01 and (d > 1).mean() < 5e-4,
          f"{tag}: the instanced frame differs from separate objects")

    print(f"phase 17a took {time.perf_counter() - t0:.1f} s")

    # -- 17b. three cascades, a shadow-casting point light, 5 bloom mips -------
    t0 = time.perf_counter()
    tag = "phase 17b"
    layered_nodes = tuple(f"shadow{s}.c{k}" for k in range(3) for s in ("", ".inst")) + tuple(
        f"omni0.f{k}" for k in range(6)) + ("gbuffer", "gbuffer.inst", "lighting",
                                            "post.bright", "post.combine")
    # The cascades fit the camera's frustum slices: the nearest one magnifies
    # the guns, whose instanced draw then bins more entries than its budget
    # (2x its records, the reference's default). Which passes overflow is
    # printed; the G-buffer and the cube faces must not.
    cascade_inst = tuple(f"shadow.inst.c{k}" for k in range(3))
    app = run(tag, INSTANCED_FLAGS + LAYERED_FLAGS, (K1_LAYERED, 1), layered_nodes,
              overflow_ok=True)
    sun = app.renderer.scene.sun
    check(sun.cascades == 3 and app.post.bloom_mips == 5
          and sum(pl.cast_shadows for pl in app.renderer.scene.point_lights) == 1,
          f"{tag}: a flag did not reach the renderer")
    calls = recorded_frame(dev, app, ("K1", "K2"))
    k1_calls = [c for c in calls if c[1] == "K1"]
    check(len(k1_calls) == K1_LAYERED, f"{tag}: K1 ran {len(k1_calls)} times in a frame")
    k1_against_unculled(k1_calls, plain_k1, tag, card,
                        lambda n: n.startswith(("shadow.c", "shadow.inst.c", "omni0.f")),
                        overflow_ok=cascade_inst)
    for node, _, (bins, _g, _z), _kw in k1_calls:
        check(int(bins.overflow) == 0 or node in cascade_inst,
              f"{tag}: {node} overflowed its bins")
    (_, _, args, kw), = [c for c in calls if c[1] == "K2"]
    check(args[5].shape[0] == 100, f"{tag}: K2 shaded {args[5].shape[0]} lights, not the 100 "
          "unshadowed ones")
    k = lighting_mod.accumulate_point_lights(*args, **kw)
    with mock.patch.object(lighting_mod, "_accumulate_point_lights_cuda", plain_k2):
        p = lighting_mod.accumulate_point_lights(*args, **kw)
    err = float((k - p).abs().max())
    check(torch.allclose(k, p, atol=2e-4, rtol=2e-3), f"{tag}: K2 beyond atol 2e-4 / rtol 2e-3 "
          f"of its plain version (max {err})")
    print(f"{tag}: K2 on the 100 unshadowed lights (the shadow-casting one shades densely): "
          f"max |kernel - plain| {err:.3e}, within atol 2e-4 / rtol 2e-3 [{card}]")

    print(f"phase 17b took {time.perf_counter() - t0:.1f} s")

    # -- 17c. variance soft shadows --------------------------------------------
    t0 = time.perf_counter()
    run("phase 17c", INSTANCED_FLAGS + ["--soft-shadows"], (K1_INSTANCED, 1), inst_nodes)
    print(f"phase 17c took {time.perf_counter() - t0:.1f} s")

    # -- 17d. the sub-resource views on the card against the CPU ---------------
    card_cases = subresource_cases(dev)
    cpu_cases = subresource_cases(torch.device("cpu"))
    for name, arrays in card_cases.items():
        # The bloom chain's elementwise ops contract into FMAs on the card.
        atol = 1e-5 if name == "bloom mip chain" else 0.0
        ok = all(np.allclose(a, b, rtol=0, atol=atol) for a, b in zip(arrays, cpu_cases[name]))
        check(ok, f"phase 17d: {name} differs between the card and the CPU")
        print(f"phase 17d: {name}: the card equals the CPU"
              + (f" (atol {atol})" if atol else " exactly"))
    raster_mod.raster_segmented.launches = 0
    lighting_mod.accumulate_point_lights.launches = 0
    return launches


EXTRAS_FRAMES = 30
REPLAY_FRAMES = 8  # one Halton cycle of TAA's jitter
IBL_POST_FLAGS = ["--mode", "deferred", "--ibl", "--fxaa", "--grade", "--film",
                  "--auto-exposure"]
TEMPORAL_FLAGS = ["--mode", "deferred", "--taa", "--velocity", "--motion-blur",
                  "--instances", "64"]
PROBE_FLAGS = ["--mode", "deferred", "--probe"]


def extras_phases(dev, card: str, plain_k1, parts: str = "abcd") -> dict:
    """Phase 18: the image-based light, the rest of the post chain and the
    temporal passes through SceneApp at 1920x1080. (18a) --ibl --fxaa
    --grade --film --auto-exposure; (18b) --taa --velocity --motion-blur
    --instances 64, then device-resident offsets; (18c) --probe; each with
    one frame function for every frame, its last frame against the plain
    path, a retained frame without host sync and a profile; (18d) the film
    golden. ``parts`` picks sub-phases (all by default). Returns K1's and
    K2's launches on these paths."""
    import torch

    import zenith_tpu_torch.renderer as renderer_pkg
    from zenith_tpu_torch.engine import Engine
    from zenith_tpu_torch.ops import raster as raster_mod
    from zenith_tpu_torch.rendergraph import graph as graph_mod
    from zenith_tpu_torch.renderer import DeferredRenderer, capture_reflection_probe
    from zenith_tpu_torch.rhi import RhiCore
    from zenith_tpu_torch.sandbox.scene import SceneApp, feature_golden_frame
    from zenith_tpu_torch.window import Window

    launches = {"K1": 0, "K2": 0}
    exposures = []
    builds = []

    class ExtrasApp(SceneApp):
        def on_frame_outputs(self, outputs):
            if "post.ae" in outputs:
                exposures.append(outputs["post.ae"])
            super().on_frame_outputs(outputs)

    real_build = graph_mod.RenderGraph._build_frame_fn

    def counting_build(graph, *args):
        builds.append(1)
        return real_build(graph, *args)

    def reset(app, snapshot):
        """Back to ``snapshot`` (orbit, TAA's jitter index, the grain's
        seed) with no temporal state: no history, exposure or motion."""
        app.orbit, taa_frame, seed = snapshot
        app._update_camera()
        if app.taa is not None:
            app.taa.reset()
            app.taa._frame = taa_frame
        if app.mblur is not None:
            app.mblur.reset()
        if app.post is not None:
            app.post._ae_state = None
            if app.post.film is not None:
                app.post.film._seed = seed
        app.renderer.reset_motion()

    def replay_check(app, tag, label):
        """The kernel path and the plain path each from reset through the
        same REPLAY_FRAMES frames (built, then retained) on fresh engines:
        their last frames <= 1 LSB, < 1% of values."""
        snapshot = (app.orbit, app.taa._frame if app.taa is not None else 0,
                    app.post.film._seed if app.post is not None and app.post.film else 0)
        frames = []
        for ctx in (contextlib.nullcontext, resolved_plain_path):
            reset(app, snapshot)
            window = Window(width=W, height=H, title="replay")
            t0 = time.perf_counter()
            with ctx():
                engine = Engine(window, device=dev)
                for _ in range(REPLAY_FRAMES):
                    app.tick(0.016)
                    engine.render(app)
                engine.shutdown()
            torch.cuda.synchronize()
            frames.append((window.last_frame, time.perf_counter() - t0))
        mx, frac = lsb_diff(frames[0][0], frames[1][0])
        print(f"{tag}: {label}: from reset through {REPLAY_FRAMES} frames, the kernel path's "
              f"last frame vs the plain path's: max LSB diff {mx}, {frac * 100:.4f}% values "
              f"differ (kernel path {frames[0][1]:.1f} s, plain path {frames[1][1]:.1f} s)")
        check(mx <= 1 and frac < 0.01, f"{tag} {label}: the last frame differs from the "
              "plain-path frame")

    def run(tag, flags, per_frame, nodes, prepare_builds=0):
        """``prepare_builds``: the frame functions prepare() builds (the
        probe's faces), beside the one the frames share."""
        window = Window(width=W, height=H, title="scene")
        builds.clear()
        with mock.patch.object(graph_mod.RenderGraph, "_build_frame_fn", counting_build):
            loop, frame_ms, wall, counts = app_run(ExtrasApp, flags, window, EXTRAS_FRAMES,
                                                   dev, per_frame, tag)
        launches["K1"] += counts[0]
        launches["K2"] += counts[1]
        check(len(builds) == 1 + prepare_builds, f"{tag}: {len(builds)} frame-function "
              f"builds in {EXTRAS_FRAMES} frames and the preparation")
        app = loop.app
        frame_line(tag, f"SceneApp {' '.join(flags)} at {W}x{H}", EXTRAS_FRAMES, wall,
                   frame_ms, counts, card)
        print(f"{tag}: K1 {per_frame[0]}, K2 {per_frame[1]} launches a frame; one frame "
              f"function built for all {EXTRAS_FRAMES} frames; render-graph nodes "
              f"{', '.join(nodes)}")
        return app, frame_ms

    def finish(app, tag, nodes, frame_ms, per_frame):
        engine = Engine(Window(width=W, height=H, title="profile"), device=dev)
        app.tick(0.004)
        engine.render(app)
        sync_free(engine, app, tag)

        def frame(_t):
            app.tick(0.004)
            engine.render(app)

        frame(0.0)
        profile_frames(frame, nodes, tag, card, frame_ms,
                       watch=("raster_segmented_kernel", "tiled_lights_kernel", "gather",
                              "gemm"),
                       expect={"raster_segmented_kernel": per_frame[0],
                               "tiled_lights_kernel": per_frame[1]})
        return engine

    # -- 18a. the image-based light and the post extras -------------------------
    def phase_a():
        t0 = time.perf_counter()
        tag = "phase 18a"
        nodes = ("shadow", "gbuffer", "lighting", "post")
        exposures.clear()
        app, frame_ms = run(tag, IBL_POST_FLAGS, (2, 1), nodes)
        env = app.renderer.scene.environment
        check(env is not None and app.renderer.scene.skybox is None and app.post.auto_exposure
              and app.post.fxaa and app.post.grade is not None and app.post.film is not None,
              f"{tag}: a flag did not reach the renderer")
        check(len(exposures) == EXTRAS_FRAMES and all(
            isinstance(e, torch.Tensor) and e.is_cuda for e in exposures),
            f"{tag}: {len(exposures)} exposures fed back on the device")
        values = [float(exposures[i - 1][0]) for i in (1, 10, EXTRAS_FRAMES)]
        check(all(np.isfinite(v) and 0.05 <= v <= 16.0 for v in values),
              f"{tag}: exposures {values}")
        print(f"{tag}: adapted exposure, fed back on the device every frame (read after the "
              f"run): frame 1 {values[0]:.6f}, frame 10 {values[1]:.6f}, frame "
              f"{EXTRAS_FRAMES} {values[2]:.6f}; environment {env.texture.desc.width}² x "
              f"{env.num_mips} mips, SH on the host [{card}]")
        replay_check(app, tag, "SceneApp")
        finish(app, tag, nodes, frame_ms, (2, 1)).shutdown()
        print(f"phase 18a took {time.perf_counter() - t0:.1f} s")

    # -- 18b. TAA, the velocity plane and motion blur over 64 rocks -------------
    def phase_b():
        t0 = time.perf_counter()
        tag = "phase 18b"
        nodes = ("shadow", "shadow.inst", "gbuffer", "gbuffer.inst", "lighting", "taa",
                 "motion_blur", "post")
        app, frame_ms = run(tag, TEMPORAL_FLAGS, (4, 1), nodes)
        check(app.renderer.velocity and app.taa is not None and app.mblur is not None
              and app.taa._history is not None and app.taa._history.is_cuda,
              f"{tag}: the temporal passes did not run")
        replay_check(app, tag, "SceneApp")
        app.tick(0.016)  # a jittered camera
        calls = recorded_frame(dev, app, ("K1",))
        check([c[0] for c in calls] == ["shadow", "shadow.inst", "gbuffer", "gbuffer.inst"],
              f"{tag}: K1 ran on nodes {[c[0] for c in calls]}")
        k1_against_unculled(calls, plain_k1, tag + " (jittered)", card,
                            lambda n: n.startswith("gbuffer"))
        engine = finish(app, tag, nodes, frame_ms, (4, 1))
        # The rocks' offsets as a CUDA tensor, replaced every frame: the default
        # renderer turns the velocity plane on, and retained frames stay free of
        # host syncs.
        scene = app.renderer.scene
        rocks = next(o for o in scene.objects if o.name == "rocks")
        offs = torch.as_tensor(np.asarray(rocks.instance_offsets, np.float32), device=dev)
        rocks.instance_offsets = offs
        app.renderer = DeferredRenderer(scene)
        check(app.renderer.velocity, f"{tag}: device offsets did not turn the velocity plane on")
        step = torch.tensor([0.0, 0.0, 0.5], device=dev)
        builds.clear()
        engine.shutdown()
        engine = Engine(Window(width=W, height=H, title="device offsets"), device=dev)
        with mock.patch.object(graph_mod.RenderGraph, "_build_frame_fn", counting_build):
            app.tick(0.016)
            engine.render(app)
            for _ in range(3):
                rocks.instance_offsets = rocks.instance_offsets + step
                app.tick(0.016)
                sync_free(engine, app, tag, "a retained frame with new device offsets")
        engine.shutdown()
        check(len(builds) == 1, f"{tag}: device offsets built {len(builds)} frame functions")
        print(f"phase 18b took {time.perf_counter() - t0:.1f} s")

    # -- 18c. a reflection probe -------------------------------------------------
    def phase_c():
        t0 = time.perf_counter()
        tag = "phase 18c"
        nodes = ("shadow", "gbuffer", "lighting", "post")
        captured = []

        def recording_capture(device, scene, *args, **kw):
            # The scene as prepare() hands it over (skybox kept, lists
            # copied): prepare() changes it once the probe is taken.
            captured.append((dataclasses.replace(scene, **{
                f.name: list(getattr(scene, f.name)) for f in dataclasses.fields(scene)
                if isinstance(getattr(scene, f.name), list)}), args, kw))
            return capture_reflection_probe(device, scene, *args, **kw)

        with mock.patch.object(renderer_pkg, "capture_reflection_probe", recording_capture):
            app, frame_ms = run(tag, PROBE_FLAGS, (2, 1), nodes, prepare_builds=1)
        check(len(captured) == 1, f"{tag}: prepare() captured {len(captured)} probes")
        scene, args, kw = captured[0]
        sh9 = app.renderer.scene.environment.sh9
        check(isinstance(sh9, torch.Tensor) and sh9.is_cuda, f"{tag}: the probe's SH left the card")
        device = RhiCore(dev).create_render_device()
        capture_reflection_probe(device, scene, *args, **kw)  # warm
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        probe = capture_reflection_probe(device, scene, *args, **kw)
        torch.cuda.synchronize()
        cap_ms = (time.perf_counter() - c0) * 1e3
        check(bool(torch.isfinite(probe.texture.mips[-1]).all()), f"{tag}: non-finite probe")
        print(f"{tag}: the probe capture of SceneApp.prepare's scene (six 64² faces through the "
              f"deferred renderer, the SH projection, a 5-level GGX prefilter of 64 samples) "
              f"took {cap_ms:.1f} ms, host clock [{card}]")
        calls = recorded_calls(lambda: capture_reflection_probe(
            device, scene, *args, **dict(kw, num_mips=2, samples=4)), ("K1",))
        check(len(calls) == 6, f"{tag}: K1 ran {len(calls)} times for six faces")
        k1_against_unculled(calls[:1], plain_k1, tag + " (probe face +X)", card, lambda n: True)
        plain_frame_check(app, app._window, dev, tag, "SceneApp")
        finish(app, tag, nodes, frame_ms, (2, 1)).shutdown()
        print(f"phase 18c took {time.perf_counter() - t0:.1f} s")

    # -- 18d. the film golden on the card ----------------------------------------
    def phase_d():
        img = feature_golden_frame(RhiCore(dev).create_render_device(), "film").cpu().numpy()
        golden = np.load(REPO / "tests" / "golden" / "feat_film_128x64.npy")
        mx, frac = lsb_diff(img, golden)
        print(f"phase 18d: feat_film_128x64 on the card: max LSB diff {mx}, "
              f"{frac * 100:.3f}% values differ")
        check(mx <= 1 and frac < 0.01, "phase 18d: the film golden drifted")

    for letter in parts:
        {"a": phase_a, "b": phase_b, "c": phase_c, "d": phase_d}[letter]()
    raster_mod.raster_segmented.launches = 0
    from zenith_tpu_torch.ops import lighting as lighting_mod

    lighting_mod.accumulate_point_lights.launches = 0
    return launches


ANIM_FRAMES = 30
ANIM_REPLAY_FRAMES = 4
# Two profiled frames a session: processing the events of ~9,600 launches a
# frame is most of a profile's cost.
ANIM_PROFILED_FRAMES = 2
DOF_HUD_FLAGS = ["--mode", "deferred", "--dof", "--hud", "--pick"]
ANIM_FLAGS = ["--mode", "deferred", "--skinned", "--morph", "--particles", "128", "--velocity",
              "--taa"]
# README.md's "everything at once" SceneApp run, with the HUD and picking.
EVERYTHING_FLAGS = ["--mode", "deferred", "--taa", "--cascades", "3", "--auto-exposure",
                    "--skinned", "--morph", "--spots", "3", "--particles", "128", "--grade",
                    "--dof", "--soft-shadows", "--hud", "--pick"]


def anim_phases(dev, card: str, plain_k1, parts: str = "abc") -> dict:
    """Phase 19: depth of field, the HUD, particles, skinning, morph targets
    and picking through SceneApp at 1920x1080. (19a) --dof --hud --pick,
    the focus racked and the HUD text changed every frame; (19b) --skinned
    --morph --particles 128 --velocity --taa, K1 on the skinned and the
    sparks' G-buffer passes bit-equal to its unculled walk; (19c) README's
    "everything at once" + --hud --pick; each with one frame function for
    every frame, its last frame against the plain path (the temporal runs
    replayed from a reset, the particle state compared too), a retained
    frame without host sync and a profile. ``parts`` picks sub-phases.
    Returns K1's and K2's launches on these paths."""
    import torch

    from zenith_tpu_torch.engine import Engine
    from zenith_tpu_torch.ops import lighting as lighting_mod
    from zenith_tpu_torch.ops import raster as raster_mod
    from zenith_tpu_torch.rendergraph import graph as graph_mod
    from zenith_tpu_torch.sandbox.scene import SceneApp
    from zenith_tpu_torch.window import Window

    launches = {"K1": 0, "K2": 0}
    builds = []
    real_build = graph_mod.RenderGraph._build_frame_fn

    def counting_build(graph, *args):
        builds.append(1)
        return real_build(graph, *args)

    class RackApp(SceneApp):
        """Racks the depth of field's focus every frame."""

        racked = 0

        def tick(self, delta_time):
            super().tick(delta_time)
            self.racked += 1
            self.dof.focus_at(60.0 + 8.0 * (self.racked % ANIM_FRAMES))

    def run(tag, flags, per_frame, app_cls=SceneApp, overflow_ok=False):
        window = Window(width=W, height=H, title="scene")
        builds.clear()
        with mock.patch.object(graph_mod.RenderGraph, "_build_frame_fn", counting_build):
            loop, frame_ms, wall, counts = app_run(app_cls, flags, window, ANIM_FRAMES, dev,
                                                   per_frame, tag, overflow_ok=overflow_ok)
        launches["K1"] += counts[0]
        launches["K2"] += counts[1]
        check(len(builds) == 1, f"{tag}: {len(builds)} frame-function builds in {ANIM_FRAMES} "
              "frames")
        app = loop.app
        frame_line(tag, f"SceneApp {' '.join(flags)} at {W}x{H}", ANIM_FRAMES, wall, frame_ms,
                   counts, card, overflow_ok)
        print(f"{tag}: K1 {per_frame[0]}, K2 {per_frame[1]} launches a frame; one frame "
              f"function built for all {ANIM_FRAMES} frames; objects "
              f"{[o.name for o in app.renderer.scene.objects]}; the screen centre is over "
              f"{app._picked_name if app.use_pick else '(no --pick)'}")
        return app, frame_ms

    def snapshot(app):
        ps = app.psys
        return (app.orbit, app.taa._frame if app.taa is not None else 0, app._anim_t,
                app._hud_fps, None if ps is None else (ps._state, ps._positions, ps._tick))

    def reset(app, snap):
        """Back to ``snap``: the camera, TAA's jitter index, the animation
        clock, the HUD's FPS and the particle state, with no history,
        exposure or motion."""
        app.orbit, taa_frame, app._anim_t, app._hud_fps, ps = snap
        app._update_camera()
        if app.taa is not None:
            app.taa.reset()
            app.taa._frame = taa_frame
        if app.post is not None:
            app.post._ae_state = None
        if ps is not None:
            app.psys._state, app.psys._positions, app.psys._tick = ps
        app.renderer.reset_motion()

    def replay_check(app, tag):
        """The kernel path and the plain path each from the same reset
        through ANIM_REPLAY_FRAMES frames on fresh engines: last frames
        <= 1 LSB, < 1% of values; the fed-back particle states equal."""
        snap = snapshot(app)
        frames, states = [], []
        for ctx in (contextlib.nullcontext, resolved_plain_path):
            reset(app, snap)
            window = Window(width=W, height=H, title="replay")
            t0 = time.perf_counter()
            with ctx():
                engine = Engine(window, device=dev)
                for _ in range(ANIM_REPLAY_FRAMES):
                    app.tick(0.016)
                    engine.render(app)
                engine.shutdown()
            torch.cuda.synchronize()
            frames.append((window.last_frame, time.perf_counter() - t0))
            states.append(None if app.psys is None else app.psys._state)
        mx, frac = lsb_diff(frames[0][0], frames[1][0])
        print(f"{tag}: from reset through {ANIM_REPLAY_FRAMES} frames, the kernel path's last "
              f"frame vs the plain path's: max LSB diff {mx}, {frac * 100:.4f}% values differ "
              f"(kernel path {frames[0][1]:.1f} s, plain path {frames[1][1]:.1f} s)")
        check(mx <= 1 and frac < 0.01, f"{tag}: the last frame differs from the plain path's")
        if states[0] is not None:
            check(torch.equal(states[0], states[1]), f"{tag}: the particle states differ")
            alive = int((states[0][:, 2] > -1e3).sum())
            print(f"{tag}: the fed-back particle state ({tuple(states[0].shape)}, {alive} "
                  f"respawned) equals the plain-path replay's")

    def finish(app, tag, nodes, frame_ms, per_frame):
        engine = Engine(Window(width=W, height=H, title="profile"), device=dev)
        app.tick(0.004)
        engine.render(app)
        sync_free(engine, app, tag)

        def frame(_t):
            app.tick(0.004)
            engine.render(app)

        frame(0.0)
        profile_frames(frame, nodes, tag, card, frame_ms,
                       watch=("raster_segmented_kernel", "tiled_lights_kernel", "gather"),
                       expect={"raster_segmented_kernel": per_frame[0],
                               "tiled_lights_kernel": per_frame[1]}, frames=ANIM_PROFILED_FRAMES)
        engine.shutdown()

    # -- 19a. depth of field, the HUD and picking -------------------------------
    def phase_a():
        t0 = time.perf_counter()
        tag = "phase 19a"
        app, frame_ms = run(tag, DOF_HUD_FLAGS, (2, 1), app_cls=RackApp)
        check(app.dof is not None and app.hud is not None and app.renderer.id_buffer,
              f"{tag}: a flag did not reach the app")
        check(app._picked_name is not None, f"{tag}: nothing picked at the screen centre")
        print(f"{tag}: focus racked to {app.dof.focus_distance:.1f} and the HUD text "
              f"{app.hud._text!r} on the last frame")
        plain_frame_check(app, app._window, dev, tag, "SceneApp")
        finish(app, tag, ("shadow", "gbuffer", "lighting", "dof", "post", "hud"), frame_ms,
               (2, 1))
        print(f"phase 19a took {time.perf_counter() - t0:.1f} s")

    # -- 19b. skins, morphs and particles with velocity and TAA ----------------
    def phase_b():
        t0 = time.perf_counter()
        tag = "phase 19b"
        per_frame = (8, 1)
        app, frame_ms = run(tag, ANIM_FLAGS, per_frame)
        check(app.renderer.velocity and app.psys is not None and app._players
              and app._morphers and app.psys._state.is_cuda,
              f"{tag}: the animated objects did not run")
        replay_check(app, tag)
        calls = recorded_frame(dev, app, ("K1",))
        names = [c[0] for c in calls]
        check(names == ["shadow", "shadow.inst", "shadow.skin", "shadow.morph", "gbuffer",
                        "gbuffer.inst", "gbuffer.skin", "gbuffer.morph"],
              f"{tag}: K1 ran on nodes {names}")
        k1_against_unculled(calls, plain_k1, tag, card,
                            lambda n: n in ("gbuffer.skin", "gbuffer.inst"))
        finish(app, tag, ("shadow", "shadow.inst", "shadow.skin", "shadow.morph", "gbuffer",
                          "gbuffer.inst", "gbuffer.skin", "gbuffer.morph", "lighting",
                          "psys.step", "taa", "post"), frame_ms, per_frame)
        print(f"phase 19b took {time.perf_counter() - t0:.1f} s")

    # -- 19c. everything at once ------------------------------------------------
    def phase_c():
        t0 = time.perf_counter()
        tag = "phase 19c"
        per_frame = (16, 1)
        app, frame_ms = run(tag, EVERYTHING_FLAGS, per_frame, overflow_ok=True)
        check(app.renderer.scene.sun.cascades == 3 and len(app.renderer.scene.spot_lights) == 3,
              f"{tag}: a flag did not reach the scene")
        replay_check(app, tag)
        finish(app, tag, ("shadow.c0", "shadow.c1", "shadow.c2", "gbuffer", "gbuffer.inst",
                          "gbuffer.skin", "gbuffer.morph", "lighting", "psys.step", "taa",
                          "dof", "post", "hud"), frame_ms, per_frame)
        print(f"phase 19c took {time.perf_counter() - t0:.1f} s")

    for letter in parts:
        {"a": phase_a, "b": phase_b, "c": phase_c}[letter]()
    raster_mod.raster_segmented.launches = 0
    lighting_mod.accumulate_point_lights.launches = 0
    return launches


# Phase 20: the interactive viewer (20a) and sort-first SPMD (20b-20d).
VIEW_W, VIEW_H = 1280, 720
VIEW_FIXED_S = 8.0  # (20a i) the fixed-resolution stream
VIEW_ADAPTIVE_S = 20.0  # (20a ii) long enough for several 1 s evaluations and 2.5 s holds
VIEW_FUSE = 4000  # frames: a served loop ends here even if the client never closes it
SPMD_W, SPMD_H = 1920, 1088  # 1088 = 4 x 272: bands of 34 8-row tiles; the 1024^2 sun map's 256
SPMD_SHARDS = 4
SPMD_FRAMES = 20
SPMD_TWIN_FRAMES = 3  # single-device and banded apps side by side, frame by frame
SPMD_FEATURE_FRAMES = 5
BLOOM_HALO_ROWS = 16  # renderer.post.BLOOM_HALO, the widest halo of a banded branch
# The feature frames' band-offset limit (band_offset_ok): above the sound
# banded frames' 0.13-0.61% and below a stuck row offset's 55-65% (phase
# 20b's negative control; PERF.md section 6).
FEATURE_LIMIT = 0.01
SPMD_FEATURE_FLAGS = ["--mode", "deferred", "--ssao", "--contact-shadows", "--ssr", "--fog",
                      "--sky", "--flare", "--taa", "--velocity", "--motion-blur", "--dof",
                      "--hud", "--auto-exposure", "--fxaa"]


def part_ok(head: str, body: bytes) -> bool:
    """A multipart part of /stream parses: its length, and the start and
    end markers of its MIME type's encoding (PNG signature + IEND, JPEG SOI
    + EOI)."""
    mime = head.split("Content-Type: ")[1].split("\r\n")[0]
    if int(head.split("Content-Length: ")[1].split("\r\n")[0]) != len(body):
        return False
    if mime == "image/png":
        return body[:8] == b"\x89PNG\r\n\x1a\n" and body[-12:-4] == b"\x00\x00\x00\x00IEND"
    return body[:2] == b"\xff\xd8" and body[-2:] == b"\xff\xd9"


class StreamReader:
    """Reads the viewer's /stream over loopback into parts: (arrival time,
    header, body)."""

    def __init__(self, url: str):
        import urllib.request

        self.resp = urllib.request.urlopen(url + "stream", timeout=30)
        self.buf = b""
        self.parts = []

    def pump(self) -> None:
        chunk = self.resp.read1(1 << 20)
        if not chunk:
            raise EOFError("the stream ended")
        self.buf += chunk
        while True:
            i = self.buf.find(b"--zenithframe\r\n")
            end = self.buf.find(b"\r\n\r\n", i) if i >= 0 else -1
            if end < 0:
                return
            head = self.buf[i:end].decode()
            n = int(head.split("Content-Length: ")[1].split("\r\n")[0])
            if len(self.buf) < end + 4 + n + 2:
                return
            self.parts.append((time.perf_counter(), head, self.buf[end + 4:end + 4 + n]))
            self.buf = self.buf[end + 4 + n + 2:]

    def close(self) -> None:
        self.resp.close()


def http_json(url: str, path: str, payload=None):
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path.lstrip("/"), data=data,
                                 method="GET" if payload is None else "POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def stream_stats(parts, t_from: float):
    """(parts, delivered FPS, mean bytes, MIME types) of the parts that
    arrived after ``t_from``."""
    recent = [p for p in parts if p[0] >= t_from]
    if len(recent) < 2:
        return len(recent), 0.0, 0.0, set()
    fps = (len(recent) - 1) / (recent[-1][0] - recent[0][0])
    mimes = {p[1].split("Content-Type: ")[1].split("\r\n")[0] for p in recent}
    return len(recent), fps, float(np.mean([len(p[2]) for p in recent])), mimes


def viewer_phase(dev, card: str) -> dict:
    """Phase 20a: FlyApp at 1280x720 served on the card, driven by a client
    thread over loopback (no browser, no network). (i) the fixed resolution
    (serve_loop adaptive=False, as fly --serve --no-adaptive): the delivered
    FPS of the multipart parts with their bytes and encoder, /frame against
    an encode of a presented frame; (ii) launch(FlyApp, serve=0): the
    adaptive stream at a 30 FPS target, its transport probe per rung, the
    rung it settles on and the FPS there; (iii) KeyW held for 1 s moves the
    camera along its forward axis, and a close event ends the loop. Every
    part parses, the loop exits by itself and no HTTP thread is left.
    Returns K1's launches."""
    import threading
    from collections import deque

    import torch

    from zenith_tpu_torch import asset, viewer as viewer_mod
    from zenith_tpu_torch.core.cli import EngineArgs
    from zenith_tpu_torch.launch import launch
    from zenith_tpu_torch.main_loop import EngineLoop
    from zenith_tpu_torch.ops.raster import raster_segmented
    from zenith_tpu_torch.sandbox.fly import FlyApp
    from zenith_tpu_torch.window import Window

    before_threads = set(threading.enumerate())
    served = {}
    real_start = viewer_mod.ViewerServer.start

    def serving(client):
        """ViewerServer.start, and the client thread behind it."""
        def start(self):
            out = real_start(self)
            served["viewer"] = self
            t = threading.Thread(target=guarded, args=(client, self), name="smoke-client",
                                 daemon=True)
            served["client"] = t
            t.start()
            return out
        return mock.patch.object(viewer_mod.ViewerServer, "start", start)

    def guarded(client, viewer):
        """Run the client; whatever happens, close the window (the loop
        then ends by itself)."""
        try:
            client(viewer)
        except BaseException as e:  # noqa: BLE001 - reported by the phase
            served["error"] = e
        finally:
            try:
                http_json(viewer.url, "/events", [{"type": "close"}])
            except Exception:  # noqa: BLE001 - the window may be closed already
                viewer.window.request_close()

    def wait_presented(url, n=5, timeout=120.0):
        t0 = time.perf_counter()
        while http_json(url, "/stats")["presented_frames"] < n:
            check(time.perf_counter() - t0 < timeout, "phase 20a: no frame presented")
            time.sleep(0.2)

    # -- (i) the fixed resolution -------------------------------------------
    tag = "phase 20a (i)"
    recent = deque(maxlen=64)
    window = Window(width=VIEW_W, height=VIEW_H, title="fly",
                    on_present=lambda img, i: recent.append(img.copy()))
    asset.initialize()
    fixed = {}

    def fixed_client(viewer):
        url = viewer.url
        wait_presented(url)
        reader = StreamReader(url)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < VIEW_FIXED_S:
            reader.pump()
        reader.close()
        fixed["parts"] = reader.parts
        fixed["t_from"] = t0 + 1.0
        import urllib.request

        with urllib.request.urlopen(url + "frame", timeout=30) as resp:
            fixed["frame"] = (resp.read(), resp.headers["Content-Type"])
        fixed["recent"] = list(recent)
        fixed["stats"] = http_json(url, "/stats")

    raster_segmented.launches = 0
    loop = EngineLoop(FlyApp(EngineArgs.parse_args(["--log-level", "warn"])), window=window,
                      device=dev)
    t0 = time.perf_counter()
    with serving(fixed_client):
        viewer_mod.serve_loop(loop, port=0, fps_cap=60.0, adaptive=False, max_frames=VIEW_FUSE)
    wall = time.perf_counter() - t0
    served["client"].join(timeout=30)
    check("error" not in served, f"{tag}: the client failed: {served.get('error')!r}")
    check(window.closed and loop.frames_rendered < VIEW_FUSE,
          f"{tag}: the loop did not end on the close event")
    k1 = raster_segmented.launches
    check(k1 >= 2 * loop.frames_rendered, f"{tag}: K1 launched {k1} times in "
          f"{loop.frames_rendered} frames")
    parts = fixed["parts"]
    bad = [i for i, (_, head, body) in enumerate(parts) if not part_ok(head, body)]
    check(parts and not bad, f"{tag}: {len(bad)} of {len(parts)} parts do not parse")
    n, fps, nbytes, mimes = stream_stats(parts, fixed["t_from"])
    body, mime = fixed["frame"]
    check(any((body, mime) == viewer_mod.encode_jpeg(f, 85) for f in fixed["recent"]),
          f"{tag}: /frame is not the encode of a presented frame")
    t1 = time.perf_counter()
    for _ in range(5):
        viewer_mod.encode_jpeg(fixed["recent"][-1], 85)
    enc_ms = (time.perf_counter() - t1) / 5 * 1e3
    print(f"{tag}: FlyApp served at {VIEW_W}x{VIEW_H} (no adaptation), {loop.frames_rendered} "
          f"frames in {wall:.1f} s; the client read {len(parts)} parts in {VIEW_FIXED_S:.0f} s, "
          f"all parse; delivered {fps:.2f} FPS over the last {n} parts (after 1 s), "
          f"{nbytes / 1e3:.1f} kB a part, encoder {sorted(mimes)} ({enc_ms:.2f} ms an encode "
          f"on the host); /frame ({mime}, {len(body)} bytes) is the encode of a presented "
          f"frame; /stats {fixed['stats']} [{card}]")

    # -- (ii) the adaptive stream through launch, then (iii) input ---------------
    tag = "phase 20a (ii)"
    probes = []
    real_probe = viewer_mod.probe_transport

    def probe(*a, **kw):
        out = real_probe(*a, **kw)
        probes.append(out)
        return out

    apps = []

    class ServedFly(FlyApp):
        def __init__(self, args):
            super().__init__(args)
            apps.append(self)

    adaptive = {}

    def adaptive_client(viewer):
        url = viewer.url
        wait_presented(url)
        reader = StreamReader(url)
        trail = []
        t0 = time.perf_counter()
        next_poll = t0
        while time.perf_counter() - t0 < VIEW_ADAPTIVE_S:
            reader.pump()
            if time.perf_counter() >= next_poll:
                trail.append((time.perf_counter(), http_json(url, "/stats")))
                next_poll += 1.0
        reader.close()
        adaptive["parts"], adaptive["trail"] = reader.parts, trail
        # (iii) KeyW held for 1 s.
        app = apps[0]
        p0 = np.asarray(app.camera.location, np.float64).copy()
        fwd = np.asarray(app.camera.forward, np.float64).copy()
        http_json(url, "/events", [{"type": "key", "code": "KeyW", "state": "down"}])
        time.sleep(1.0)
        http_json(url, "/events", [{"type": "key", "code": "KeyW", "state": "up"}])
        time.sleep(0.5)
        adaptive["move"] = (p0, fwd, np.asarray(app.camera.location, np.float64).copy())

    raster_segmented.launches = 0
    window = Window(width=VIEW_W, height=VIEW_H, title="fly")
    t0 = time.perf_counter()
    served.clear()
    with serving(adaptive_client), mock.patch.object(viewer_mod, "probe_transport", probe):
        loop = launch(ServedFly, argv=["--log-level", "warn"], window=window, serve=0,
                      fps_cap=60.0, max_frames=VIEW_FUSE, device=dev)
    wall = time.perf_counter() - t0
    served["client"].join(timeout=30)
    check("error" not in served, f"{tag}: the client failed: {served.get('error')!r}")
    check(window.closed and loop.frames_rendered < VIEW_FUSE,
          f"{tag}: the loop did not end on the close event")
    k1 += raster_segmented.launches
    check(len(probes) == 1, f"{tag}: {len(probes)} transport probes")
    for (w, h), row in probes[0].items():
        print(f"{tag}: transport probe {w}x{h}: readback {row['readback_ms']:.2f} ms (pinned "
              f"ring of 3, CUDA events) + encode {row['jpeg_ms']:.2f} ms = {row['ms']:.2f} ms "
              f"[{card}]")
    parts = adaptive["parts"]
    bad = [i for i, (_, head, body) in enumerate(parts) if not part_ok(head, body)]
    check(parts and not bad, f"{tag}: {len(bad)} of {len(parts)} parts do not parse")
    trail = adaptive["trail"]
    rungs = [(round(t - trail[0][0], 1), s["rung"], s["width"], s["height"], s["fps"])
             for t, s in trail]
    last_change = max([t for (t, s), (_, s0) in zip(trail[1:], trail) if s["rung"] != s0["rung"]],
                      default=trail[0][0])
    held = trail[-1][0] - last_change
    final = trail[-1][1]
    # The last 5 s of parts (one rung when it settled).
    n, fps, nbytes, mimes = stream_stats(parts, parts[-1][0] - 5.0)
    print(f"{tag}: launch(FlyApp, serve=0) adaptive at a 30 FPS target, {loop.frames_rendered} "
          f"frames in {wall:.1f} s; /stats each second (t, rung, width, height, fps): {rungs}")
    print(f"{tag}: {'settled' if held >= 5.0 else 'still stepping'} on rung {final['rung']} "
          f"({final['width']}x{final['height']} of view {final['view_width']}x"
          f"{final['view_height']}, quality {final['quality']}; {held:.1f} s since the last "
          f"rung change): delivered {fps:.2f} FPS over the last 5 s ({n} parts), "
          f"{nbytes / 1e3:.1f} kB a part, encoder {sorted(mimes)}; the controller measured "
          f"{final['fps']} FPS presented [{card}]")
    p0, fwd, p1 = adaptive["move"]
    delta = p1 - p0
    dist = float(np.linalg.norm(delta))
    along = float(delta @ fwd) / max(dist, 1e-9)
    print(f"phase 20a (iii): KeyW held 1 s: the camera moved {dist:.3f} units, cos to its "
          f"forward axis {along:.4f}; a close event ended the loop")
    check(dist > 1.0 and along > 0.99, "phase 20a (iii): KeyW did not move the camera forward")
    time.sleep(0.5)
    left = [t.name for t in set(threading.enumerate()) - before_threads if t.is_alive()]
    check(not left, f"phase 20a: threads left alive: {left}")
    print("phase 20a: no HTTP or client thread left alive")
    return {"K1": k1}


@contextlib.contextmanager
def engine_options(options):
    """Every Engine made inside the block compiles with ``options``."""
    from zenith_tpu_torch.engine import Engine

    real_init = Engine.__init__

    def init(self, *args, **kw):
        kw["compile_options"] = options
        real_init(self, *args, **kw)

    with mock.patch.object(Engine, "__init__", init):
        yield


@contextlib.contextmanager
def counting_collectives():
    """Counts of each collective of the SPMD runtime called in the block."""
    import threading

    from zenith_tpu_torch.parallel import spmd

    counts = {name: 0 for name in ("all_gather", "ppermute", "psum", "pmean")}
    lock = threading.Lock()
    with contextlib.ExitStack() as stack:
        for name in counts:
            def wrap(*a, _real=getattr(spmd, name), _name=name, **kw):
                with lock:
                    counts[_name] += 1
                return _real(*a, **kw)
            stack.enter_context(mock.patch.object(spmd, name, wrap))
        yield counts


def band_offset(single, banded) -> dict:
    """How far a banded frame sits from its single-device twin, in the
    terms of the reference's band-offset tolerance (test_parallel.py:171-
    176): the share of pixels whose colour differs by more than 1e-3 (HDR
    (H, W, C) float) or of values that differ by more than 1 LSB (encoded
    uint8), and the largest difference; then the same share in the seam
    rows (within BLOOM_HALO_ROWS of a band edge, where a halo fault
    lands) and in the rest. A band's edge equations are set up in
    band-local coordinates (the viewport shift), so far off-screen corners
    of near-clipped triangles round apart from the single-device setup:
    interpolated positions differ, and shading that thresholds on them
    (shadow tests) flips at a few pixels anywhere in the frame."""
    a, b = np.asarray(single), np.asarray(banded)
    if a.dtype == np.uint8:
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        off, out = d > 1, {"max": int(d.max()), "any": float((d > 0).mean())}
    else:
        d = np.abs(a - b)[..., :3].max(-1)
        off, out = d > 1e-3, {"max": float(d.max()), "any": float((d > 2e-4).mean())}
    h = a.shape[0]
    seam = np.zeros(h, bool)
    for k in range(1, SPMD_SHARDS):
        y = k * h // SPMD_SHARDS
        seam[y - BLOOM_HALO_ROWS:y + BLOOM_HALO_ROWS] = True
    out.update(off=float(off.mean()), seam=float(off[seam].mean()),
               inner=float(off[~seam].mean()))
    return out


def band_offset_ok(stats: dict, limit: float = 0.005) -> bool:
    """The reference's band-offset tolerance: under 0.5% off. The feature
    frames take FEATURE_LIMIT (their marches, blurs and temporal feedback
    spread a flipped position test over more pixels), set between phase
    20b's two readings: the sound banded frames and those of a
    deliberately broken row offset. The seam rows' share is reported, not
    held: it follows where the content lies (20d's glass covers the upper
    seams and not the lowest band)."""
    return stats["off"] < limit


def fmt_offset(o: dict) -> str:
    return (f"max {o['max']} LSB, {o['off'] * 100:.4f}% of values off by > 1 LSB (seam rows "
            f"{o['seam'] * 100:.4f}%, the rest {o['inner'] * 100:.4f}%), "
            f"{o['any'] * 100:.4f}% differ")


@contextlib.contextmanager
def broken_halo(short: int):
    """A deliberately broken ring halo, for the negative control of phase
    20b: the ``short`` outermost rows of each side of the halo repeat the
    nearest row that was exchanged (``short`` = the halo: no exchange, the
    band's own edge repeated)."""
    from zenith_tpu_torch.parallel import sharding
    from zenith_tpu_torch.renderer import deferred as deferred_mod

    real = sharding.halo_exchange_rows

    def halo_exchange_rows(band, axis_name, halo):
        ext = real(band, axis_name, halo).clone()
        k, n = min(short, halo), ext.shape[0]
        ext[:k] = ext[k:k + 1]
        ext[n - k:] = ext[n - k - 1:n - k]
        return ext

    with mock.patch.object(sharding, "halo_exchange_rows", halo_exchange_rows), \
            mock.patch.object(deferred_mod, "halo_exchange_rows", halo_exchange_rows):
        yield


@contextlib.contextmanager
def broken_row0():
    """A deliberately broken row offset, for the negative control of phase
    20b: the deferred renderer's banded branches (SSAO's taps, the contact
    march, the sky's view rays) read rank 0 on every band, so each band
    takes the top band's global rows."""
    from zenith_tpu_torch.parallel import spmd
    from zenith_tpu_torch.renderer import deferred as deferred_mod

    class RankZero:
        def __getattr__(self, name):
            return getattr(spmd, name)

        @staticmethod
        def axis_index(axis_name):
            return 0

    with mock.patch.object(deferred_mod, "spmd", RankZero()):
        yield


def twin_apps(dev, flags, options_seq, frames: int, around=(), app_cls=None):
    """SceneApps (or ``app_cls``) built alike, one on an engine of its own
    for each entry of ``options_seq`` (single-device, banded, ...), ticked
    with the same 1/60 s steps: the presented frames of each, frame by
    frame, then the second engine's collectives. ``around[k]``, where given,
    is a context manager factory that wraps engine k's renders."""
    import torch

    from zenith_tpu_torch import asset
    from zenith_tpu_torch.core.cli import EngineArgs
    from zenith_tpu_torch.engine import Engine
    from zenith_tpu_torch.sandbox.scene import SceneApp
    from zenith_tpu_torch.window import Window

    asset.initialize()
    runs = []
    for k, options in enumerate(options_seq):
        shown = []
        window = Window(width=SPMD_W, height=SPMD_H, title="twin",
                        on_present=lambda img, i, shown=shown: shown.append(img.copy()))
        app = (app_cls or SceneApp)(EngineArgs.parse_args(["--log-level", "warn", *flags]))
        engine = Engine(window, device=dev, compile_options=options)
        app.prepare(engine.render_device, window)
        wrap = around[k] if k < len(around) and around[k] else contextlib.nullcontext
        runs.append((app, engine, shown, wrap))
    counts = None
    for _ in range(frames):
        for k, (app, engine, _, wrap) in enumerate(runs):
            app.tick(1.0 / 60.0)
            with wrap():
                if k == 1:
                    with counting_collectives() as c:
                        engine.render(app)
                    counts = c if counts is None else {n: counts[n] + c[n] for n in c}
                else:
                    engine.render(app)
    for _, engine, _, _ in runs:
        engine.shutdown()
    torch.cuda.synchronize()
    return (*(shown for _, _, shown, _ in runs), counts)


def spmd_phases(dev, card: str, plain_k1, parts: str = "bcd") -> dict:
    """Phases 20b-20d: sort-first SPMD on one card, 4 shards on cuda:0 (one
    thread each). (20b) SceneApp --mode deferred over the baked cerberus
    (100 lights, the 1024^2 sun map) at 1920x1088 through an Engine given
    CompileOptions(mesh=default_mesh(4, device="cuda:0")), beside the same
    app single-device: FPS, launches, per-band K1 bit-equal to its unculled
    walk and K2 within atol 2e-4 / rtol 2e-3 of its plain version, the HDR
    and the presented frames within the reference's band-offset tolerance
    of single-device (under 0.5% of values off; band_offset says why not
    bit-equal); then 5 frames with
    every screen-space, temporal and post flag, each under FEATURE_LIMIT
    off single-device, every banded branch's collectives counted, beside
    two deliberately broken copies of the app (a short halo, a stuck row
    offset), the second of which the same check must refuse. (20c)
    the stand-alone functions on phase 7's stand-in mesh (33,884
    triangles): make_row_sharded_frame and make_sort_last_frame at
    1920x1088 against the single-device draw, composite_depth bit-equal to
    composite_depth_all_gather with forced ties, halo_exchange_rows equal
    to torch.roll, tone_and_bloom_banded bit-equal to tone_and_bloom and
    refused with a broken halo. (20d) the glass frame (K5) in bands, each band's K5
    call held against its plain version (z bit-equal, colour within atol
    1e-5 + rtol 1e-5), the frame within the band-offset tolerance of
    single-device. Returns K1's, K2's
    and K5's launches on these paths. ``parts`` picks sub-phases."""
    import torch

    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree
    from zenith_tpu_torch.ops import lighting as lighting_mod
    from zenith_tpu_torch.ops import raster as raster_mod
    from zenith_tpu_torch.ops.raster import raster_segmented, raster_segmented_blend
    from zenith_tpu_torch.parallel import default_mesh, spmd
    from zenith_tpu_torch.rendergraph import CompileOptions
    from zenith_tpu_torch.renderer import DeferredRenderer
    from zenith_tpu_torch.rhi import Format, RhiCore, encode_present
    from zenith_tpu_torch.sandbox.scene import SceneApp, build_standin_scene, deferred_frame
    from zenith_tpu_torch.sandbox.scene import orbit_camera
    from zenith_tpu_torch.window import Window

    mesh = default_mesh(SPMD_SHARDS, device=dev)
    # 16-row tiles: a 272-row band is 17 of them, a 256-row band of the
    # 1024^2 sun map 16. (With 8-row tiles more than the huge-span tier's 256
    # records of the sun map's pass span over 32 tiles, and the binning
    # drops them: bin overflow.)
    single = CompileOptions(tile_h=16, tile_w=128)
    banded = CompileOptions(tile_h=16, tile_w=128, mesh=mesh)
    launches = {"K1": 0, "K2": 0, "K5": 0}
    flags = ["--mode", "deferred"]
    band_h = SPMD_H // SPMD_SHARDS
    camera = Camera(fov_y=Degree(35.0), aspect_ratio=SPMD_W / SPMD_H)
    orbit_camera(camera, 0.3)
    device = RhiCore(dev).create_render_device()

    if "b" in parts:
        # -- 20b. the banded deferred frame through the engine -------------------
        tag = "phase 20b"
        t0 = time.perf_counter()
        fps = {}
        for label, options, per_frame in (("single-device", single, (2, 1)),
                                          (f"{SPMD_SHARDS} bands", banded,
                                           (2 * SPMD_SHARDS, SPMD_SHARDS))):
            window = Window(width=SPMD_W, height=SPMD_H, title="scene")
            with engine_options(options):
                loop, frame_ms, wall, counts = app_run(SceneApp, flags, window, SPMD_FRAMES, dev,
                                                       per_frame, f"{tag} {label}")
            launches["K1"] += counts[0]
            launches["K2"] += counts[1]
            fps[label] = 1e3 / np.mean(frame_ms[4:])
            banded_ms = frame_ms
            frame_line(f"{tag} {label}", f"SceneApp {' '.join(flags)} at {SPMD_W}x{SPMD_H}",
                       SPMD_FRAMES, wall, frame_ms, counts, card)
            app = loop.app
        check(app.renderer.scene.sun.shadow_map_size == 1024, f"{tag}: the sun map is not 1024^2")
        print(f"{tag}: banded {fps[f'{SPMD_SHARDS} bands']:.2f} FPS against single-device "
              f"{fps['single-device']:.2f} FPS [{card}]")

        # One banded frame with K1's and K2's calls recorded: each band's.
        from zenith_tpu_torch.engine import Engine

        engine = Engine(Window(width=SPMD_W, height=SPMD_H, title="calls"), device=dev,
                        compile_options=banded)
        calls = recorded_calls(lambda: engine.render(app), ("K1", "K2"))
        sync_free(engine, app, f"{tag} banded")

        def frame(_t):
            app.tick(0.004)
            engine.render(app)

        frame(0.0)
        # No kernel time by node: the profiler records host operators of the
        # threads it starts on, not of the persistent shard workers.
        profile_frames(frame, (), f"{tag} banded", card, banded_ms,
                       watch=("raster_segmented_kernel", "tiled_lights_kernel", "gather"),
                       expect={"raster_segmented_kernel": 2 * SPMD_SHARDS,
                               "tiled_lights_kernel": SPMD_SHARDS},
                       frames=ANIM_PROFILED_FRAMES)
        engine.shutdown()
        k1_calls = [c for c in calls if c[1] == "K1"]
        k2_calls = [c for c in calls if c[1] == "K2"]
        check(sorted(c[0] for c in k1_calls) == sorted(["shadow", "gbuffer"] * SPMD_SHARDS),
              f"{tag}: K1 ran on {[c[0] for c in k1_calls]}")
        for node, _, (bins, grid, init_z), _kw in k1_calls:
            want_h = 1024 // SPMD_SHARDS if node == "shadow" else band_h
            check(grid.height == want_h and tuple(init_z.shape)[0] == want_h,
                  f"{tag}: K1 on {node} ran on {grid.height} rows, not a band of {want_h}")
        k1_against_unculled(k1_calls, plain_k1, f"{tag} band", card, lambda n: True)
        check(len(k2_calls) == SPMD_SHARDS, f"{tag}: K2 ran {len(k2_calls)} times")
        k2_err = 0.0
        for _, _, args, kw in k2_calls:
            check(tuple(args[3].shape) == (band_h, SPMD_W), f"{tag}: K2 on {tuple(args[3].shape)}")
            k = lighting_mod.accumulate_point_lights(*args, **kw)
            with mock.patch.object(lighting_mod, "_accumulate_point_lights_cuda", plain_k2):
                p = lighting_mod.accumulate_point_lights(*args, **kw)
            k2_err = max(k2_err, float((k - p).abs().max()))
            check(torch.allclose(k, p, atol=2e-4, rtol=2e-3), f"{tag}: a band's K2 beyond atol "
                  f"2e-4 / rtol 2e-3 of its plain version (max {k2_err})")
        k2_ms = kernel_ms(lambda: lighting_mod.accumulate_point_lights(*k2_calls[-1][2],
                                                                       **k2_calls[-1][3]),
                          lambda: None)
        print(f"{tag}: K2 on each {band_h}x{SPMD_W} band ({-(-band_h // 16)} rows of 16x16 "
              f"regions, the last {band_h - 16 * (band_h // 16) or 16} rows high): max |kernel - "
              f"plain| {k2_err:.3e}, within atol 2e-4 / rtol 2e-3; device time {k2_ms:.4f} ms a "
              f"band [{card}]")
        raster_segmented.launches = 0
        lighting_mod.accumulate_point_lights.launches = 0

        # The HDR and the presented frames against single-device.
        hdrs = []
        for options in (single, banded):
            compiled, _, hdr, _ = deferred_frame(device, app.renderer, camera, SPMD_W, SPMD_H,
                                                 options, exports=("hdr",))
            hdrs.append(compiled.value(hdr))
        torch.cuda.synchronize()
        hdr_off = band_offset(hdrs[0].cpu().numpy(), hdrs[1].cpu().numpy())
        check(band_offset_ok(hdr_off), f"{tag}: the banded HDR differs from single-device "
              f"beyond the band-offset tolerance: {hdr_off}")
        shown1, shown4, _ = twin_apps(dev, flags, (single, banded), SPMD_TWIN_FRAMES)
        check(len(shown1) == len(shown4) == SPMD_TWIN_FRAMES, f"{tag}: frames not presented")
        offs = [band_offset(a, b) for a, b in zip(shown1, shown4)]
        check(all(band_offset_ok(o) for o in offs), f"{tag}: a banded frame differs from "
              f"single-device beyond the band-offset tolerance: {offs}")
        print(f"{tag}: the banded HDR against single-device: {hdr_off['off'] * 100:.4f}% of "
              f"pixels off by > 1e-3, {hdr_off['any'] * 100:.4f}% by > 2e-4, max "
              f"{hdr_off['max']:.3e} (seam rows {hdr_off['seam'] * 100:.4f}%); "
              f"{SPMD_TWIN_FRAMES} presented frames of twin apps: "
              + "; ".join(fmt_offset(o) for o in offs))

        # Every banded branch once on the card, beside two negative controls
        # (deliberately broken copies of the banded app): its ring halo short
        # by 2 rows (broken_halo), and the deferred renderer's row offset
        # stuck at rank 0 (broken_row0). The sound frames must pass
        # FEATURE_LIMIT and the broken row offset fail it. The short halo
        # moves the presented frame too little for any frame-level limit
        # (its reading says how little): 20c holds the halo'd bloom on
        # shared inputs instead.
        shown1, shown4, short2, row0, coll = twin_apps(
            dev, SPMD_FEATURE_FLAGS, (single, banded, banded, banded), SPMD_FEATURE_FRAMES,
            around=(None, None, lambda: broken_halo(2), broken_row0))
        launches["K1"] += raster_segmented.launches
        launches["K2"] += lighting_mod.accumulate_point_lights.launches
        check(len(shown1) == len(shown4) == SPMD_FEATURE_FRAMES, f"{tag}: frames not presented")
        offs = [band_offset(a, b) for a, b in zip(shown1, shown4)]
        broken = {name: [band_offset(a, b) for a, b in zip(shown1, frames_)]
                  for name, frames_ in (("ring halo short by 2 rows", short2),
                                        ("row offset stuck at rank 0", row0))}
        check(all(n > 0 for n in coll.values()), f"{tag}: a collective never ran: {coll}")
        print(f"{tag}: SceneApp {' '.join(SPMD_FEATURE_FLAGS)}: {SPMD_FEATURE_FRAMES} frames, each "
              f"against single-device: " + "; ".join(fmt_offset(o) for o in offs)
              + f"; the banded frames' collectives {coll} [{card}]")
        for name, os_ in broken.items():
            print(f"{tag}: negative control, the banded app with its {name}: "
                  + "; ".join(fmt_offset(o) for o in os_) + f" [{card}]")
        check(all(band_offset_ok(o, FEATURE_LIMIT) for o in offs), f"{tag}: a banded feature "
              f"frame differs from single-device beyond {FEATURE_LIMIT * 100:g}% of values off "
              f"by > 1 LSB: {offs}")
        check(not all(band_offset_ok(o, FEATURE_LIMIT) for o in broken["row offset stuck at "
                                                                         "rank 0"]),
              f"{tag}: the feature frames' check passes the banded app with its row offset "
              f"stuck at rank 0: {broken}")
        print(f"phase 20b took {time.perf_counter() - t0:.1f} s")

    if "c" in parts:
        # -- 20c. the stand-alone functions ---------------------------------------------
        t0 = time.perf_counter()
        tag = "phase 20c"
        from zenith_tpu_torch.ops import TileGrid, clear_color, clear_depth
        from zenith_tpu_torch.ops.draw import draw_indexed
        from zenith_tpu_torch.ops.geometry import transform_vertices
        from zenith_tpu_torch.parallel import (
            halo_exchange_rows,
            make_row_sharded_frame,
            make_sort_last_frame,
        )
        from zenith_tpu_torch.parallel.sharding import composite_depth, composite_depth_all_gather
        from zenith_tpu_torch.rhi import (
            ColorAttachmentDesc,
            CullMode,
            GraphicPipelineAttachments,
            GraphicPipelineDesc,
            GraphicShaderInput,
            PipelineCache,
            RasterizationState,
            Shader,
            VertexLayout,
        )
        from zenith_tpu_torch.rhi.state import DepthStencilDesc, GraphicPipelineState

        scene, _ = build_standin_scene(device, 100, np.random.default_rng(42))
        obj = scene.objects[0]
        vb8 = obj.vertex_buffer.array.reshape(-1, 8)
        model = torch.from_numpy(np.asarray(obj.model_matrix, np.float32)).to(dev)
        vp = torch.from_numpy(np.asarray(camera.render_view_projection, np.float32)).to(dev)
        clip = transform_vertices(vb8[:, :3], vp @ model)
        vb = torch.cat([clip, vb8[:, 3:6] * 0.5 + 0.5], 1).contiguous()
        ib = obj.index_buffer.array.reshape(-1, 3).to(torch.int32)
        check(ib.shape[0] % SPMD_SHARDS == 0, f"{tag}: {ib.shape[0]} triangles")
        pipe = PipelineCache().get_or_create(GraphicPipelineDesc(
            shader_input=GraphicShaderInput(
                Shader.vertex("c20.vs", lambda a, r: {"position": a["position"],
                                                      "color": a["color"]}),
                Shader.fragment("c20.fs", lambda v, r, b: torch.cat(
                    [v["color"], torch.ones_like(v["color"][..., :1])], -1)),
                VertexLayout.from_fields(("position", 4), ("color", 3))),
            state=GraphicPipelineState(rasterization=RasterizationState(cull_mode=CullMode.NONE),
                                       depth_stencil=DepthStencilDesc().reverse_z()),
            attachments=GraphicPipelineAttachments(color_formats=(Format.RGBA32F,),
                                                   depth_format=Format.D32F),
            color_attachment_descs=(ColorAttachmentDesc(),),
        ))
        grid = TileGrid(width=SPMD_W, height=SPMD_H, tile_h=8, tile_w=128)
        budget = 1 << 22
        colors, depth, stats = draw_indexed([clear_color(SPMD_H, SPMD_W, (0, 0, 0, 1), dev)],
                                            clear_depth(SPMD_H, SPMD_W, 0.0, dev), pipe, vb, ib, {},
                                            grid, bin_capacity=4096, entry_budget=budget)
        check(int(stats.bin_overflow) == 0, f"{tag}: the single-device draw overflowed its bins")
        c1, z1 = colors[0], depth
        covered = int((z1 > 0).sum())
        check(covered > SPMD_W * SPMD_H // 20, f"{tag}: the mesh covers only {covered} px")
        k1_before = raster_segmented.launches
        step = make_row_sharded_frame(mesh, pipe, SPMD_W, SPMD_H, tile_h=8, tile_w=128,
                                      bin_capacity=4096)
        cs, zs = step(vb, ib, {})
        check(len(cs.shards) == SPMD_SHARDS and all(s.shape == (band_h, SPMD_W, 4)
                                                    and s.device == mesh.devices[0]
                                                    for s in cs.shards),
              f"{tag}: the row-sharded colour is not {SPMD_SHARDS} bands on the card")
        c4, z4 = cs.full(), zs.full()
        off = ((c4 - c1).abs().amax(-1) > 1e-4) | ((z4 - z1).abs() > 1e-5)
        print(f"{tag}: make_row_sharded_frame {SPMD_W}x{SPMD_H} over {SPMD_SHARDS} bands on "
              f"cuda:0, {ib.shape[0]} triangles, {covered} px covered: "
              f"{off.float().mean().item() * 100:.4f}% of pixels off the single-device draw by "
              f"more than 1e-4 (colour) / 1e-5 (depth), max colour diff "
              f"{(c4 - c1).abs().max().item():.3e}, depth {(z4 - z1).abs().max().item():.3e}; "
              f"K1 launched {raster_segmented.launches - k1_before} times")
        check(off.float().mean().item() < 0.005, f"{tag}: the row-sharded frame differs from "
              "the single-device draw beyond the band-offset tolerance")
        sort_last = make_sort_last_frame(mesh, pipe, SPMD_W, SPMD_H, tile_h=8, tile_w=128)
        cl, zl = sort_last(vb, ib, {})
        check(torch.equal(zl, z1) and torch.equal(cl, c1), f"{tag}: the sort-last frame is not "
              "bit-equal to the single-device draw")
        print(f"{tag}: make_sort_last_frame {SPMD_W}x{SPMD_H}, {ib.shape[0] // SPMD_SHARDS} "
              f"triangles a shard, binary-swap composite: colour and depth bit-equal to the "
              f"single-device draw")
        rng = np.random.default_rng(20)
        z_np = np.round(rng.uniform(0, 1, (SPMD_SHARDS, SPMD_H, SPMD_W)) * 4) / 4
        z_np = z_np.astype(np.float32)
        c_np = rng.uniform(0, 1, (SPMD_SHARDS, SPMD_H, SPMD_W, 4)).astype(np.float32)
        zt, ct = torch.from_numpy(z_np).to(dev), torch.from_numpy(c_np).to(dev)

        def composite(fn):
            return spmd.shard_map(lambda z, c: fn(c[0], z[0], "rows"), mesh,
                                  in_specs=(spmd.P("rows"), spmd.P("rows")),
                                  out_specs=(spmd.P(), spmd.P()))(zt, ct)

        ca, za = composite(composite_depth_all_gather)
        cb, zb = composite(composite_depth)
        ties = int(((z_np == z_np.max(0)[None]).sum(0) > 1).sum())
        check(ties > 0 and torch.equal(za, zb) and torch.equal(ca, cb),
              f"{tag}: composite_depth differs from composite_depth_all_gather")
        full = torch.from_numpy(rng.uniform(0, 1, (SPMD_H, SPMD_W, 4)).astype(np.float32)).to(dev)
        halo = 16
        ext = spmd.shard_map(lambda b: halo_exchange_rows(b, "rows", halo), mesh,
                             in_specs=spmd.P("rows"), out_specs=None)(full)
        for r, band in enumerate(ext):
            check(torch.equal(band, torch.roll(full, halo - r * band_h, 0)[:band_h + 2 * halo]),
                  f"{tag}: halo_exchange_rows of band {r} is not the rolled surface")
        torch.cuda.synchronize()
        print(f"{tag}: composite_depth bit-equal to composite_depth_all_gather on {SPMD_SHARDS} "
              f"{SPMD_W}x{SPMD_H} planes with {ties} equal-z ties; halo_exchange_rows ({halo} "
              f"rows) equal to torch.roll of the full surface for every band")
        # The halo'd bloom on shared inputs: tone_and_bloom_banded over the
        # 4 bands against tone_and_bloom on the whole surface, at the CPU
        # twins' atol 1e-6 (test_torch_parallel.py), then the same bands
        # with a ring halo short by 2 rows and with none, which must fail it.
        from zenith_tpu_torch.renderer.post import (
            BLOOM_HALO,
            tone_and_bloom,
            tone_and_bloom_banded,
        )

        check(BLOOM_HALO == BLOOM_HALO_ROWS, f"{tag}: BLOOM_HALO is {BLOOM_HALO}, not "
              f"{BLOOM_HALO_ROWS}")
        hdr = torch.from_numpy(rng.exponential(0.5, (SPMD_H, SPMD_W, 4)).astype(np.float32))
        hdr = hdr.to(dev)
        bloom1 = tone_and_bloom(hdr)

        def bloom_bands():
            return spmd.shard_map(lambda b: tone_and_bloom_banded(b, "rows"), mesh,
                                  in_specs=spmd.P("rows"), out_specs=spmd.P("rows"))(hdr).full()

        bloom_err = {"sound": (bloom_bands() - bloom1).abs().max().item()}
        for name, short in (("short by 2 rows", 2), ("none", BLOOM_HALO_ROWS)):
            with broken_halo(short):
                bloom_err[name] = (bloom_bands() - bloom1).abs().max().item()
        print(f"{tag}: tone_and_bloom_banded over {SPMD_SHARDS} bands against tone_and_bloom "
              f"on the whole {SPMD_W}x{SPMD_H} surface (exponential HDR, mean 0.5): max |banded "
              f"- single| {bloom_err['sound']:.3e}; with the ring halo short by 2 rows "
              f"{bloom_err['short by 2 rows']:.3e}, with none {bloom_err['none']:.3e} [{card}]")
        check(bloom_err["sound"] <= 1e-6, f"{tag}: the banded bloom differs from single-device "
              f"beyond atol 1e-6: {bloom_err}")
        check(bloom_err["short by 2 rows"] > 1e-6 and bloom_err["none"] > 1e-6,
              f"{tag}: the banded bloom's check passes a broken halo: {bloom_err}")
        launches["K1"] += raster_segmented.launches - k1_before
        print(f"phase 20c took {time.perf_counter() - t0:.1f} s")

    if "d" in parts:
        # -- 20d. the glass frame (K5) in bands ------------------------------------------
        t0 = time.perf_counter()
        tag = "phase 20d"
        scene, _ = build_standin_scene(device, 100, np.random.default_rng(42), glass=True)
        renderer = DeferredRenderer(scene, glass_mode="kernel")
        outs = []

        def glass_frame(options):
            raster_segmented_blend.launches = 0
            compiled, enc, hdr, retired = deferred_frame(
                device, renderer, camera, SPMD_W, SPMD_H, options,
                present_format=Format.BGRA8_SRGB, exports=("hdr",))
            outs.append((compiled.value(hdr), compiled.value(enc).cpu().numpy(),
                         raster_segmented_blend.launches, int(retired.bin_overflow)))

        glass_frame(single)
        # The banded frame with each band's K5 call recorded.
        k5_calls = recorded_calls(lambda: glass_frame(banded), ("K5",))
        launches["K5"] += outs[1][2]
        check(outs[0][2] == 1 and outs[1][2] == SPMD_SHARDS,
              f"{tag}: K5 launched {outs[0][2]} / {outs[1][2]} times, not 1 / {SPMD_SHARDS}")
        check(outs[0][3] == 0 and outs[1][3] == 0, f"{tag}: bin overflow")
        # Each band's K5 call against its plain version on the same inputs
        # (records offset by the band viewport, y0 = rank x band_h): z
        # bit-equal, colour within atol 1e-5 + rtol 1e-5, as phase 11 holds
        # K5 on the whole frame.
        check(len(k5_calls) == SPMD_SHARDS, f"{tag}: {len(k5_calls)} K5 calls recorded")
        k5_err = 0.0
        for band, (node, _, args, kw) in enumerate(k5_calls):
            b, g, z = args[:3]
            check(g.height == band_h and tuple(z.shape) == (band_h, SPMD_W),
                  f"{tag}: K5 on {node} ran on {tuple(z.shape)}, not a {band_h}-row band")
            k = raster_segmented_blend(*args, **kw)
            with mock.patch.object(raster_mod, "_raster_blend_cuda", plain_k56):
                p = raster_segmented_blend(*args, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(k[1]).all()), f"{tag}: K5 band {band}: non-finite colour")
            check(torch.equal(k[0], p[0]), f"{tag}: K5 band {band}: z differs from the plain "
                  "version")
            err = (k[1] - p[1]).abs()
            bad = int((err > 1e-5 + 1e-5 * p[1].abs()).sum())
            k5_err = max(k5_err, err.max().item())
            check(bad == 0, f"{tag}: K5 band {band}: {bad} colour values beyond atol 1e-5 + "
                  f"rtol 1e-5 of the plain version (max {err.max().item():.3e})")
            n_frag, n_shaded = count_fragments(b, g, lambda rows, zpx, py, px, z=z:
                                               zpx > z[py, px])
            ms = kernel_ms(lambda c=(args, kw): raster_segmented_blend(*c[0], **c[1]),
                           lambda: None)
            b_ms, b_by = blend_bound(b, g, n_shaded, n_frag, GLASS_SHADER_OPS, False)
            print(f"{tag}: K5 {node} band {band} ({g.width}x{g.height}): "
                  f"{int(b.blk_count.sum())} entries, {n_frag} fragments, {n_shaded} shaded; z "
                  f"bit-equal to the plain version, colour max |kernel - plain| "
                  f"{err.max().item():.3e}; device time {ms:.4f} ms (CUDA events round the "
                  f"wrapper call), bound {b_ms:.4f} ms ({b_by}) [{card}]")
        hdr_off = band_offset(outs[0][0].cpu().numpy(), outs[1][0].cpu().numpy())
        enc_off = band_offset(outs[0][1], outs[1][1])
        check(band_offset_ok(hdr_off) and band_offset_ok(enc_off), f"{tag}: the banded glass "
              f"frame differs from single-device beyond the band-offset tolerance: {hdr_off}, "
              f"{enc_off}")
        print(f"{tag}: the glass frame (kernel mode) at {SPMD_W}x{SPMD_H}: K5 once per band "
              f"({SPMD_SHARDS}), each band's call within atol 1e-5 + rtol 1e-5 of its plain "
              f"version (max {k5_err:.3e}), z bit-equal; HDR against single-device "
              f"{hdr_off['off'] * 100:.4f}% of pixels off by > 1e-3 (seam rows "
              f"{hdr_off['seam'] * 100:.4f}%; {hdr_off['any'] * 100:.4f}% by > 2e-4, max "
              f"{hdr_off['max']:.3e}); encoded {fmt_offset(enc_off)}")
        raster_segmented.launches = 0
        lighting_mod.accumulate_point_lights.launches = 0
        raster_segmented_blend.launches = 0
        print(f"phase 20d took {time.perf_counter() - t0:.1f} s")
    return launches


SL_FRAMES = 20  # phase 20e: frames per mode of the forward SceneApp
SL_TWIN_FRAMES = 2
SL_COLOR_TOL, SL_DEPTH_TOL, SL_SHARE = 1e-3, 1e-5, 0.002  # test_sort_last.py's tolerance
# Phase 20e-ii: three cerberus copies (33,543 triangles each, together over
# AUTO_SL_MIN_TRIS) side by side at 0.3 scale, their world heights (z) in
# the orbit camera's top quarter of the rows, or spread over the height.
TRIO_X = (-45.0, 0.0, 45.0)
TRIO_SCALE = 0.3
TRIO_Z = {"clustered": (43.0, 43.0, 43.0), "spread": (-30.0, 7.0, 44.0)}


@contextlib.contextmanager
def recording_modes():
    """The ``parallel_modes`` of every render graph compiled in the block,
    in compile order."""
    from zenith_tpu_torch.rendergraph.graph import RenderGraph

    modes = []
    real = RenderGraph.compile

    def compile_(self, *args, **kw):
        out = real(self, *args, **kw)
        modes.append(dict(self.parallel_modes))
        return out

    with mock.patch.object(RenderGraph, "compile", compile_):
        yield modes


def trio_app(placement: str):
    """SceneApp (forward mode) whose cerberus stands three times at
    TRIO_SCALE, at TRIO_X across and TRIO_Z[placement] up."""
    from zenith_tpu_torch.sandbox.scene import SceneApp

    class TrioApp(SceneApp):
        def prepare(self, render_device, window) -> None:
            super().prepare(render_device, window)
            scene = self.renderer.scene
            gun = next(o for o in scene.objects if o.name == "cerberus")
            model = np.asarray(gun.model_matrix, np.float32)
            copies = []
            for k, (x, z) in enumerate(zip(TRIO_X, TRIO_Z[placement])):
                place = np.diag([TRIO_SCALE, TRIO_SCALE, TRIO_SCALE, 1.0]).astype(np.float32)
                place[:3, 3] = (x, 0.0, z)
                copies.append(dataclasses.replace(gun, name=f"cerberus{k}",
                                                  model_matrix=place @ model))
            scene.objects[scene.objects.index(gun):scene.objects.index(gun) + 1] = copies
            self.mark_structure_dirty()

    return TrioApp


def forward_nodes(render_device, renderer, camera, options):
    """The forward renderer's own nodes (the sun's shadow pass, the lit
    pass) at SPMD_W x SPMD_H, their colour and depth exported: returns
    (colour, depth, each node's mode, the frame's bin overflow)."""
    from zenith_tpu_torch.rendergraph import RenderGraphBuilder
    from zenith_tpu_torch.rhi import Format, PipelineCache, TextureDesc

    builder = RenderGraphBuilder()
    color = builder.create(TextureDesc.color("fwd.rt", SPMD_W, SPMD_H, Format.RGBA32F))
    depth = builder.create(TextureDesc.depth("fwd.ds", SPMD_W, SPMD_H))
    renderer.render_to(builder, color, depth, camera)
    builder.export(color)
    builder.export(depth)
    graph = builder.build()
    compiled = graph.compile(render_device, PipelineCache(), options)
    retired = compiled.execute(render_device)
    return (compiled.value(color), compiled.value(depth), dict(graph.parallel_modes),
            int(retired.bin_overflow))


def composite_offset(single, other) -> dict:
    """test_sort_last.py's measure of a sort-last node's colour and depth
    against single-device: the share of pixels off by more than
    SL_COLOR_TOL (colour, largest channel) and SL_DEPTH_TOL (depth), the
    largest differences and the bit-equal shares."""
    import torch

    dc = (single[0] - other[0]).abs().amax(-1)
    dz = (single[1] - other[1]).abs()
    return {"color_off": float((dc > SL_COLOR_TOL).float().mean()),
            "depth_off": float((dz > SL_DEPTH_TOL).float().mean()),
            "color_max": float(dc.max()), "depth_max": float(dz.max()),
            "color_equal": float(torch.eq(single[0], other[0]).all(-1).float().mean()),
            "depth_equal": float(torch.eq(single[1], other[1]).float().mean())}


def fmt_composite(o: dict) -> str:
    return (f"colour {o['color_off'] * 100:.4f}% of pixels off by > {SL_COLOR_TOL:g} (max "
            f"{o['color_max']:.3e}), {o['color_equal'] * 100:.4f}% bit-equal; depth "
            f"{o['depth_off'] * 100:.4f}% off by > {SL_DEPTH_TOL:g} (max {o['depth_max']:.3e}), "
            f"{o['depth_equal'] * 100:.4f}% bit-equal")


def sort_last_phases(dev, card: str, plain_k1) -> dict:
    """Phase 20e: sort-last and auto SPMD through the render graph on one
    card, 4 shards on cuda:0 at 1920x1088, through an Engine given
    CompileOptions(mesh=default_mesh(4, device="cuda:0"), parallel=...).
    (iii, first) SceneApp --mode forward over the baked cerberus,
    SL_FRAMES frames each single-device, sort-first and sort-last: FPS,
    launches a frame (K1 2, 8 and 8), a profile (kernel time, idle share).
    (i) the sort-last run's nodes' modes (the shadow pass banded, the lit
    pass sort-last), each shard's K1 on the lit pass recorded: full-height
    bins of a quarter of the triangles, bit-equal to the unculled plain
    walk and to the plain version, timed beside its bound; the lit pass's
    colour and depth against single-device at test_sort_last.py's tolerance
    (<= 0.2% of pixels off by > 1e-3, depth 1e-5) with the bit-equal
    share; the presented frames of twin apps within the band-offset
    tolerance (the banded shadow pass keeps band-local edge setup). (ii)
    parallel="auto" on three cerberus copies (100,629 triangles): in the
    top quarter of the rows the lit pass resolves to sort-last and the
    shadow pass to sort-first; spread over the height both stay
    sort-first; each held as in (i). Returns K1's and K2's launches."""
    import torch

    from zenith_tpu_torch.core.cli import EngineArgs
    from zenith_tpu_torch.engine import Engine
    from zenith_tpu_torch.ops import raster as raster_mod
    from zenith_tpu_torch.ops.raster import raster_segmented
    from zenith_tpu_torch.parallel import default_mesh
    from zenith_tpu_torch.rendergraph import CompileOptions
    from zenith_tpu_torch.rendergraph.graph import AUTO_SL_MIN_TRIS, _auto_prefers_sort_last
    from zenith_tpu_torch.rhi import RhiCore
    from zenith_tpu_torch.renderer.scene import band_hint_for
    from zenith_tpu_torch.sandbox.scene import SceneApp
    from zenith_tpu_torch.window import Window

    mesh = default_mesh(SPMD_SHARDS, device=dev)
    single = CompileOptions(tile_h=16, tile_w=128)
    options = {
        "single-device": single,
        "sort-first": CompileOptions(tile_h=16, tile_w=128, mesh=mesh),
        "sort-last": CompileOptions(tile_h=16, tile_w=128, mesh=mesh, parallel="sort_last"),
    }
    auto = CompileOptions(tile_h=16, tile_w=128, mesh=mesh, parallel="auto")
    flags = ["--mode", "forward"]
    launches = {"K1": 0, "K2": 0}
    n = SPMD_SHARDS

    # -- 20e-iii. each mode's speed, in one call -----------------------------------
    tag = "phase 20e"
    t0 = time.perf_counter()
    fps, apps = {}, {}
    for label, per_frame in (("single-device", (2, 0)), ("sort-first", (2 * n, 0)),
                             ("sort-last", (2 * n, 0))):
        window = Window(width=SPMD_W, height=SPMD_H, title="scene")
        with engine_options(options[label]), recording_modes() as modes:
            loop, frame_ms, wall, counts = app_run(SceneApp, flags, window, SL_FRAMES, dev,
                                                   per_frame, f"{tag} {label}")
        launches["K1"] += counts[0]
        launches["K2"] += counts[1]
        fps[label] = 1e3 / np.mean(frame_ms[4:])
        frame_line(f"{tag} {label}", f"SceneApp {' '.join(flags)} at {SPMD_W}x{SPMD_H}",
                   SL_FRAMES, wall, frame_ms, counts, card)
        want = {"sort-last": {"shadow": "sort_first", "forward": "sort_last"},
                "sort-first": {"shadow": "sort_first", "forward": "sort_first"},
                "single-device": {}}[label]
        check(modes and all(m == want for m in modes), f"{tag} {label}: node modes {modes}")
        print(f"{tag}: {label}: each node's mode {want or '(no mesh)'} in all "
              f"{len(modes)} compiles")
        app = apps[label] = loop.app
        engine = Engine(Window(width=SPMD_W, height=SPMD_H, title="profile"), device=dev,
                        compile_options=options[label])

        def frame(_t, engine=engine, app=app):
            app.tick(0.004)
            engine.render(app)

        frame(0.0)
        k1_frame = per_frame[0]
        profile_frames(frame, (), f"{tag} {label}", card, frame_ms,
                       watch=("raster_segmented_kernel", "gather"),
                       expect={"raster_segmented_kernel": k1_frame},
                       frames=ANIM_PROFILED_FRAMES)
        engine.shutdown()
    print(f"{tag}: FPS single-device {fps['single-device']:.2f}, sort-first "
          f"{fps['sort-first']:.2f}, sort-last {fps['sort-last']:.2f} [{card}]")

    # -- 20e-i. forced sort-last: each shard's K1, the composite, the frames ------
    app = apps["sort-last"]
    engine = Engine(Window(width=SPMD_W, height=SPMD_H, title="calls"), device=dev,
                    compile_options=options["sort-last"])
    calls = recorded_calls(lambda: engine.render(app), ("K1",))
    sync_free(engine, app, f"{tag} sort-last")
    engine.shutdown()
    fwd = [c for c in calls if c[0] == "forward"]
    check(sorted(c[0] for c in calls) == sorted(["shadow", "forward"] * n),
          f"{tag}: K1 ran on {[c[0] for c in calls]}")
    records = []
    for node, _, (bins, grid, init_z), kw in fwd:
        check(grid.height == SPMD_H and tuple(init_z.shape) == (SPMD_H, SPMD_W),
              f"{tag}: K1 on {node} ran on {grid.height} rows, not the full {SPMD_H}")
        records.append(int(bins.blk_count.sum()))
    k1_against_unculled(fwd, plain_k1, f"{tag} sort-last shard", card, lambda name: True)
    for shard, (node, _, (bins, grid, init_z), kw) in enumerate(fwd):
        k = raster_segmented(bins, grid, init_z, **kw)
        with mock.patch.object(raster_mod, "_raster_segmented_cuda",
                               raster_mod._raster_segmented_torch):
            p = raster_segmented(bins, grid, init_z, **kw)
        torch.cuda.synchronize()
        for a, b_ in zip(k, p):
            check(torch.equal(a, b_), f"{tag}: shard {shard}'s K1 differs from its plain version")
    raster_segmented.launches = 0
    print(f"{tag}: the lit pass's K1 on each of the {n} shards: full-height bins, "
          f"{records} entries (the shards' contiguous quarters of the triangles), bit-equal "
          f"to the unculled plain walk and to the plain version")
    device = RhiCore(dev).create_render_device()
    nodes = {label: forward_nodes(device, app.renderer, app.camera, options[label])
             for label in ("single-device", "sort-last")}
    torch.cuda.synchronize()
    check(nodes["sort-last"][2] == {"shadow": "sort_first", "forward": "sort_last"},
          f"{tag}: node modes {nodes['sort-last'][2]}")
    check(all(v[3] == 0 for v in nodes.values()), f"{tag}: bin overflow")
    off = composite_offset(nodes["single-device"], nodes["sort-last"])
    print(f"{tag}: the sort-last lit pass against single-device: {fmt_composite(off)} [{card}]")
    check(off["color_off"] <= SL_SHARE and off["depth_off"] <= SL_SHARE,
          f"{tag}: the sort-last lit pass differs from single-device beyond "
          f"test_sort_last.py's tolerance: {off}")
    shown1, shown_sl, _ = twin_apps(dev, flags, (single, options["sort-last"]), SL_TWIN_FRAMES)
    offs = [band_offset(a, b) for a, b in zip(shown1, shown_sl)]
    check(len(offs) == SL_TWIN_FRAMES and all(band_offset_ok(o) for o in offs),
          f"{tag}: a sort-last frame differs from single-device beyond the band-offset "
          f"tolerance: {offs}")
    print(f"{tag}: {SL_TWIN_FRAMES} presented sort-last frames of twin apps against "
          f"single-device: " + "; ".join(fmt_offset(o) for o in offs))
    launches["K1"] += raster_segmented.launches
    raster_segmented.launches = 0
    print(f"phase 20e-i/iii took {time.perf_counter() - t0:.1f} s")

    # -- 20e-ii. auto on a clustered and a spread scene --------------------------
    t0 = time.perf_counter()
    for placement, want in (("clustered", "sort_last"), ("spread", "sort_first")):
        app_cls = trio_app(placement)
        with recording_modes() as modes:
            shown1, shown_auto, _ = twin_apps(dev, flags, (single, auto), SL_TWIN_FRAMES,
                                              app_cls=app_cls)
        auto_modes = [m for m in modes if m]
        check(auto_modes and all(m == {"shadow": "sort_first", "forward": want}
                                 for m in auto_modes),
              f"{tag} auto {placement}: node modes {auto_modes}")
        twin = app_cls(EngineArgs.parse_args(["--log-level", "warn", *flags]))
        twin.prepare(device, Window(width=SPMD_W, height=SPMD_H, title="nodes"))
        hint = band_hint_for(twin.renderer.scene.objects,
                             range(len(twin.renderer.scene.objects)), twin.camera)
        guns = [h for h in hint if h[0] > 2]
        total = sum(t for t, _, _ in guns)
        check(total >= AUTO_SL_MIN_TRIS, f"{tag}: {total} hinted triangles")
        if placement == "clustered":
            check(all(y1 <= 0.25 for _, _, y1 in guns), f"{tag}: the trio spans {guns}")
        check(_auto_prefers_sort_last(hint, n) == (want == "sort_last"),
              f"{tag}: the hint {hint} decides against {want}")
        out = {label: forward_nodes(device, twin.renderer, twin.camera, opt)
               for label, opt in (("single-device", single), ("auto", auto))}
        torch.cuda.synchronize()
        check(out["auto"][2]["forward"] == want, f"{tag}: {out['auto'][2]}")
        off = composite_offset(out["single-device"], out["auto"])
        check(off["color_off"] <= SL_SHARE and off["depth_off"] <= SL_SHARE,
              f"{tag} auto {placement}: the lit pass differs from single-device: {off}")
        offs = [band_offset(a, b) for a, b in zip(shown1, shown_auto)]
        check(len(offs) == SL_TWIN_FRAMES and all(band_offset_ok(o) for o in offs),
              f"{tag} auto {placement}: a frame beyond the band-offset tolerance: {offs}")
        print(f"{tag}: auto, the trio {placement} (hint "
              + ", ".join(f"{t} triangles in rows {y0:.3f}-{y1:.3f}" for t, y0, y1 in guns)
              + f"): shadow sort_first, forward {want}; the lit pass against single-device: "
              f"{fmt_composite(off)}; presented frames: "
              + "; ".join(fmt_offset(o) for o in offs) + f" [{card}]")
        launches["K1"] += raster_segmented.launches
        raster_segmented.launches = 0
    print(f"phase 20e-ii took {time.perf_counter() - t0:.1f} s")
    return launches


# The fragment shader of tests/test_torch_raster_parts.py (the interpolated
# vertex colour) made kernel-safe, so that phase 21c's blended split draws
# run K5, and the record columns of its single-draw blend batch.
SOUP_FS_CUDA = """
__device__ __forceinline__ void zn_fragment(const float* a, float frag_x, float frag_y,
                                            float depth, bool front_facing, float draw_id,
                                            float* rgba) {
  const float* c = a + ZN_V_rgba;
  rgba[0] = c[0];
  rgba[1] = c[1];
  rgba[2] = c[2];
  rgba[3] = c[3];
}
"""
SOUP_LAYOUT = [("rgba", 4), ("__draw_id", 1), ("__front", 1)]
# Phase 21b: the cells (columns, rows) of a blend draw, one random
# triangle each, and the seeds of test_property_matrix.py's blend
# equations that also draw with a random two-face stencil (K6).
SWEEP_BLEND_CELLS = (8, 6)
SWEEP_STENCIL_SEEDS = (0, 2, 4, 6, 8, 10)


def sweep_modules():
    """tests/test_torch_property.py and tests/test_torch_raster_parts.py,
    whose draws phase 21 runs (they import numpy, torch, pytest, the port
    and tests/np_reference.py, nothing of JAX). Importing them leaves
    torch's CPU thread count as it was."""
    import importlib

    import torch

    tests = str(REPO / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    threads = torch.get_num_threads()
    try:
        return (importlib.import_module("test_torch_property"),
                importlib.import_module("test_torch_raster_parts"))
    finally:
        torch.set_num_threads(threads)


def sweep_blend_draw(seed: int, width: int, height: int, dev):
    """Phase 21b's draw for blend seed ``seed``: a random triangle in each
    of SWEEP_BLEND_CELLS (mixed winding, z in (0.05, 0.95), colour up to
    1.5 and alpha, a draw id and a Gain per triangle: the stress shader's
    columns) binned
    at ``width`` x ``height``, a random HDR target and z plane, and a
    random stencil plane. Returns (bins, grid, init z, colour, stencil)."""
    import torch

    from zenith_tpu_torch.ops.binning import TileGrid, bin_segmented
    from zenith_tpu_torch.ops.geometry import setup_with_attrs
    from zenith_tpu_torch.rhi.state import CullMode

    rng = np.random.default_rng(21000 + seed)
    cols, rows = SWEEP_BLEND_CELLS
    nt = cols * rows
    nv = 3 * nt
    # One triangle a cell, its corners anywhere in the cell widened by 35%
    # a side: neighbours overlap, at most a few layers deep, so equations
    # that square the destination (DST_COLOR on both sides) stay finite.
    cell = np.stack(np.meshgrid(np.arange(cols), np.arange(rows)), -1).reshape(nt, 1, 2)
    size = np.array([2.0 / cols, 2.0 / rows])
    xy = (-1.0 + (cell + rng.uniform(-0.35, 1.35, (nt, 3, 2))) * size).reshape(nv, 2)
    clip = np.concatenate([xy, rng.uniform(0.05, 0.95, (nv, 1)), np.ones((nv, 1))],
                          1).astype(np.float32)
    per_tri = np.concatenate([np.arange(nt)[:, None] % 8, rng.uniform(0.5, 1.0, (nt, 4))], 1)
    vary = np.concatenate([rng.uniform(0.0, 1.5, (nv, 3)), rng.uniform(0.1, 0.9, (nv, 1)),
                           np.repeat(per_tri, 3, 0)], 1).astype(np.float32)
    idx = np.arange(nv, dtype=np.int32).reshape(nt, 3)
    grid = TileGrid(width, height) if width > 128 else TileGrid(width, height, 8, 128)
    rec, corner = setup_with_attrs(*(torch.from_numpy(a).to(dev) for a in (clip, idx, vary)),
                                   width, height, cull_mode=CullMode.NONE)
    bins = bin_segmented(rec, corner, grid)
    init = torch.from_numpy(rng.uniform(0.0, 0.6, (height, width)).astype(np.float32)).to(dev)
    color = torch.from_numpy(rng.uniform(0.0, 2.0, (height, width, 4)).astype(np.float32))
    sten = torch.from_numpy(rng.integers(0, 256, (height, width)).astype(np.int32))
    return bins, grid, init, color.to(dev), sten.to(dev)


def sweep_phases(dev, card: str, plain_k1) -> dict:
    """Phase 21: the reference's random state sweeps and split draws on the
    card. (21a) the 32 draws of test_property.py and test_property_matrix.py
    (topology, cull x winding, all eight depth compares x write, one- and
    two-face stencil with random ops and masks, sample offsets on the 1/16
    lattice) through K1, and K3 where the draw has stencil, at 128x64 with
    8x128 tiles against np_reference.render_reference at the reference's
    tolerances, and there and at 1920x1080 bit-equal to the plain versions;
    (21b) test_property_matrix.py's blend equations, each as a translucent
    draw of random triangles over a random HDR target at 128x64 and
    1920x1080 through K5, six with a random two-face stencil through K6, z
    and stencil bit-equal and colour within atol 1e-5 + rtol 1e-5 of the
    plain version, seeds added past the reference's 12 until every factor
    code and op has been drawn in a written channel; (21c)
    test_raster_parts.py's seven splits (ops.draw's record and primitive
    caps set tiny, restored in a finally), every split render bit-equal to
    its unsplit render through K1, K3 and K5 (the blended draws with a
    kernel-safe copy of the test's shader) and K1 at each of 4 MSAA
    samples. Two negative controls: a 21a stencil draw against a plain K3
    whose stencil op table has two ops swapped, and a 21b draw against a
    plain K5 whose SRC_ALPHA and DST_ALPHA factors (and their ONE_MINUS
    forms) are swapped, must both be caught. Returns the launches of K1,
    K3, K5 and K6 and K5/K6's largest colour difference."""
    import torch

    from zenith_tpu_torch.ops import blend as blend_mod
    from zenith_tpu_torch.ops import raster as raster_mod
    from zenith_tpu_torch.ops import runtime
    from zenith_tpu_torch.ops.binning import TileGrid
    from zenith_tpu_torch.ops.raster import raster_segmented, raster_segmented_blend
    from zenith_tpu_torch.rhi import Shader, uniform
    from zenith_tpu_torch.rhi.state import BlendFactor, CompareOp, StencilOp

    tp, trp = sweep_modules()
    counters = {"K1": (raster_segmented, "launches"),
                "K3": (raster_segmented, "stencil_launches"),
                "K5": (raster_segmented_blend, "launches"),
                "K6": (raster_segmented_blend, "stencil_launches")}
    total = {k: 0 for k in counters}
    builds_at_start = runtime.shader_builds

    def run_counted(fn):
        """``fn()`` with every count set to 0 just before; returns (its
        result, the launches it made), the launches added to the phase's."""
        for f, name in counters.values():
            setattr(f, name, 0)
        out = fn()
        torch.cuda.synchronize()
        got = {k: getattr(f, name) for k, (f, name) in counters.items()}
        for k, n in got.items():
            total[k] += n
        return out, got

    def fmt(launches):
        return ", ".join(f"{k} {n}" for k, n in launches.items() if n)

    def exact(k, p, what, names):
        for a, b, name in zip(k, p, names):
            if a is None and b is None:
                continue
            check(torch.equal(a, b), f"{what}: {name} differs from the plain version (max "
                  f"{(a.float() - b.float()).abs().max().item():.3e})")

    # -- 21a. the state sweeps through K1 and K3 --------------------------------
    t0 = time.perf_counter()
    cases = ([tp.property_case(s) for s in tp.PROPERTY_SEEDS]
             + [tp.matrix_case(s) for s in tp.MATRIX_SEEDS])
    grids = {"128x64": tp.GRID, f"{W}x{H}": TileGrid(W, H)}
    a_launches = {k: 0 for k in counters}
    z_err = var_err = 0.0
    covered = 0
    for case in cases:
        want = "K1" if case["front_st"] is None else "K3"
        for tag, grid in grids.items():
            bins = tp.bins_of(case, grid, dev)
            k, got = run_counted(lambda: tp.raster_case(case, bins, grid, dev))
            check(got[want] == 1 and sum(got.values()) == 1,
                  f"21a {case['label']} at {tag}: launches {got}, not one {want}")
            for name, n in got.items():
                a_launches[name] += n
            with plain_versions(plain_k1):
                p = tp.raster_case(case, bins, grid, dev)
            torch.cuda.synchronize()
            exact(k, p, f"21a {case['label']} at {tag}", ("z", "planes", "stencil"))
            if grid is tp.GRID:
                z, acc, sten = (None if t is None else t.cpu().numpy() for t in k)
                ref = tp.oracle(case)
                try:
                    tp.assert_matches_oracle(case, z, acc, sten, ref)
                except AssertionError as e:
                    fail(f"21a {case['label']}: the card's K1/K3 disagree with np_reference: {e}")
                cov = ref["tri"] >= 0
                covered += int(cov.sum())
                z_err = max(z_err, float(np.abs(z - ref["z"]).max()))
                if cov.any():
                    interp = np.moveaxis(acc[:3] / np.maximum(acc[-1], 1e-12), 0, -1)[cov]
                    var_err = max(var_err, float(np.abs(interp - ref["c"][cov]).max()))
    n_sten = sum(c["front_st"] is not None for c in cases)
    print(f"phase 21a: {len(cases)} sweep draws ({n_sten} with stencil) at 128x64 (8x128 tiles) "
          f"and {W}x{H}: launches {fmt(a_launches)}; at 128x64 within the reference's "
          f"tolerances of np_reference ({covered} px covered, worst |z| {z_err:.3e} of 1e-4, "
          f"worst varying {var_err:.3e} of 2e-3, coverage and stencil exact); bit-equal to the "
          f"plain versions at both sizes; {time.perf_counter() - t0:.1f} s [{card}]")

    # The negative control: a plain K3 whose op table has the pass op of
    # matrix seed 3003 (one face, DECREMENT_AND_CLAMP on pass) swapped with
    # KEEP must disagree with the card's K3 on that draw.
    control = tp.matrix_case(3)
    swap = {control["front_st"].pass_op: StencilOp.KEEP,
            StencilOp.KEEP: control["front_st"].pass_op}
    real_apply = raster_mod._stencil_apply
    bins = tp.bins_of(control, tp.GRID, dev)
    k = tp.raster_case(control, bins, tp.GRID, dev)
    with plain_versions(plain_k1), mock.patch.object(
            raster_mod, "_stencil_apply",
            lambda op, s, ref: real_apply(swap.get(op, op), s, ref)):
        broken = tp.raster_case(control, bins, tp.GRID, dev)
    torch.cuda.synchronize()
    off = int((k[2] != broken[2]).sum())
    check(off > 0, "21a negative control: K3 agreed with a plain version whose stencil ops "
          "were swapped")
    print(f"phase 21a: negative control: a plain K3 with {control['front_st'].pass_op.name} and "
          f"KEEP swapped in its op table differs from the card's K3 at {off} stencil values "
          f"of matrix seed 3003: caught")

    # -- 21b. the blend equations through K5 and K6 ------------------------------
    t0 = time.perf_counter()
    fs = Shader.fragment("stress.fs", stress_fs, bindings=[uniform("Gain")], kernel_safe=True,
                         device_source=STRESS_FS_CUDA)
    alpha_factors = {BlendFactor.SRC_ALPHA, BlendFactor.DST_ALPHA,
                     BlendFactor.ONE_MINUS_SRC_ALPHA, BlendFactor.ONE_MINUS_DST_ALPHA}
    factors, ops = set(), set()
    seeds = []
    while len(seeds) < len(tp.BLEND_SEEDS) or len(factors) < len(BlendFactor) or len(ops) < 5:
        s = len(seeds)
        desc = tp.blend_case(s)[0]
        seeds.append((s, desc))
        if any(desc.write_mask[:3]):
            factors |= {desc.src_color_blend, desc.dst_color_blend}
            ops.add(desc.color_blend_op)
        if desc.write_mask[3]:
            factors |= {desc.src_alpha_blend, desc.dst_alpha_blend}
            ops.add(desc.alpha_blend_op)
    draws = {tag: {} for tag in grids}
    b_launches = {k: 0 for k in counters}
    c_err = 0.0
    n_draws = 0
    control_call = None
    for s, desc in seeds:
        for tag in grids:
            wh = (128, 64) if tag == "128x64" else (W, H)
            bins, grid, init, color, sten0 = sweep_blend_draw(s, *wh, dev)
            variants = [None]
            if s in SWEEP_STENCIL_SEEDS:
                frng = np.random.default_rng(22000 + s)
                variants.append((tp.rand_face(frng), tp.rand_face(frng)))
            for faces in variants:
                kw = dict(compare_op=CompareOp.GREATER, depth_write=False, fragment_shader=fs,
                          attr_layout=STRESS_LAYOUT, color_desc=desc)
                if faces is not None:
                    kw.update(init_stencil=sten0, stencil_front=faces[0], stencil_back=faces[1])

                def run(bins=bins, grid=grid, init=init, color=color, kw=kw):
                    return raster_segmented_blend(bins, grid, init, color, None, **kw)

                want = "K5" if faces is None else "K6"
                k, got = run_counted(run)
                check(got[want] == 1 and sum(got.values()) == 1,
                      f"21b seed {7000 + s} at {tag}: launches {got}, not one {want}")
                for name, n in got.items():
                    b_launches[name] += n
                with plain_versions(plain_k1):
                    p = run()
                torch.cuda.synchronize()
                what = f"21b seed {7000 + s} {want} at {tag}"
                check(bool(torch.isfinite(k[1]).all()), f"{what}: non-finite colour")
                exact((k[0], *k[2:]), (p[0], *p[2:]), what, ("z", "stencil"))
                err = (k[1] - p[1]).abs()
                bad = int((err > 1e-5 + 1e-5 * p[1].abs()).sum())
                check(bad == 0, f"{what}: {bad} colour values beyond atol 1e-5 + rtol 1e-5 of "
                      f"the plain version (max {err.max().item():.3e})")
                c_err = max(c_err, err.max().item())
                n_draws += 1
                uses = ((any(desc.write_mask[:3])
                         and {desc.src_color_blend, desc.dst_color_blend} & alpha_factors)
                        or (desc.write_mask[3]
                            and {desc.src_alpha_blend, desc.dst_alpha_blend} & alpha_factors))
                if control_call is None and faces is None and tag == "128x64" and uses:
                    control_call = (s, run, k)
    runtime_builds = runtime.shader_builds - builds_at_start
    check(runtime_builds == 0, f"21b: {runtime_builds} blend kernels were compiled in the phase")
    print(f"phase 21b: {len(seeds)} blend equations (seeds {7000}-{7000 + len(seeds) - 1}; "
          f"{len(tp.BLEND_SEEDS)} are test_property_matrix.py's, the rest added until every "
          f"code was drawn in a written channel), {n_draws} draws of "
          f"{SWEEP_BLEND_CELLS[0] * SWEEP_BLEND_CELLS[1]} triangles over a random HDR target at 128x64 and {W}x{H}, "
          f"{len(SWEEP_STENCIL_SEEDS)} equations also with a random two-face stencil: launches "
          f"{fmt(b_launches)}; factor codes drawn "
          f"{sorted(f.value for f in factors)} ({len(factors)} of {len(BlendFactor)}), ops "
          f"{sorted(o.value for o in ops)} ({len(ops)} of 5); z and stencil bit-equal, colour "
          f"max |kernel - plain| {c_err:.3e} (atol 1e-5 + rtol 1e-5); "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    check(len(factors) == len(BlendFactor) and len(ops) == 5, "21b: a code was not drawn")

    # The negative control: SRC_ALPHA and DST_ALPHA (and their ONE_MINUS
    # forms) swapped in a copy of the plain version's factor table.
    check(control_call is not None, "21b: no equation uses an alpha factor")
    s, run, k = control_call
    swapped = {BlendFactor.SRC_ALPHA: BlendFactor.DST_ALPHA,
               BlendFactor.DST_ALPHA: BlendFactor.SRC_ALPHA,
               BlendFactor.ONE_MINUS_SRC_ALPHA: BlendFactor.ONE_MINUS_DST_ALPHA,
               BlendFactor.ONE_MINUS_DST_ALPHA: BlendFactor.ONE_MINUS_SRC_ALPHA}
    real_factor = blend_mod._factor
    with plain_versions(plain_k1), mock.patch.object(
            blend_mod, "_factor", lambda f, *a: real_factor(swapped.get(f, f), *a)):
        broken = run()
    torch.cuda.synchronize()
    off = int(((k[1] - broken[1]).abs() > 1e-5 + 1e-5 * broken[1].abs()).sum())
    check(off > 0, "21b negative control: K5 agreed with a plain version whose alpha factors "
          "were swapped")
    print(f"phase 21b: negative control: a plain K5 with the SRC/DST alpha factors swapped "
          f"differs from the card's K5 beyond the tolerance at {off} colour values of seed "
          f"{7000 + s}: caught")

    # -- 21c. the split draws through K1, K3 and K5 ------------------------------
    t0 = time.perf_counter()
    soup_fs = Shader.fragment("p.fs.kernel", trp._fs, kernel_safe=True,
                              device_source=SOUP_FS_CUDA)
    c_launches = {k: 0 for k in counters}
    lines = []
    for name, (which, renders) in trp.SPLIT_CASES.items():
        for state, kw in renders:
            blended = kw.get("alpha", 1.0) < 1.0
            fs_c = soup_fs if blended else trp.FS
            samples = state.multisample.samples
            want = ("K5" if blended else "K3" if state.depth_stencil.stencil_test_enable
                    else "K1")
            full, n_full = run_counted(lambda: trp.render_soup(state, device=dev, fs=fs_c, **kw))
            with trp.split_caps(which) as parts:
                split, n_split = run_counted(
                    lambda: trp.render_soup(state, device=dev, fs=fs_c, **kw))
            check(parts and max(parts) > 1, f"21c {name}: the draw did not split ({parts})")
            for got in (n_full, n_split):
                check(got[want] >= samples, f"21c {name}: launches {got}, {want} not at each "
                      f"of {samples} samples")
                for k_name, n in got.items():
                    c_launches[k_name] += n
            for key in full:
                check(np.array_equal(full[key], split[key]),
                      f"21c {name}: the split render's {key} differs from the unsplit render "
                      f"(max {np.abs(full[key] - split[key]).max():.3e})")
            if all(state is not s for s in trp.DRAWS_NOTHING):
                check(bool((full["color"][..., :3] > 0).any()), f"21c {name}: nothing drawn")
            lines.append(f"{name} ({which} cap, {max(parts)} parts, {want} {n_full[want]} -> "
                         f"{n_split[want]})")
    check(runtime.shader_builds == builds_at_start, "21c: a blend kernel was compiled in the phase")
    print(f"phase 21c: {len(lines)} split renders bit-equal to their unsplit renders at 128x64: "
          f"{'; '.join(lines)}; launches {fmt(c_launches)}; {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    return dict(total, blend_err=c_err)


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

    t_start = time.perf_counter()
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
    # Every nvcc at once: the library's sources (one nvcc each, inside
    # build_kernels) beside the blend kernel of each fragment shader the
    # script draws with.
    from concurrent.futures import ThreadPoolExecutor

    from zenith_tpu_torch.renderer.deferred import glass_device_source

    with ThreadPoolExecutor(max_workers=5) as pool:
        jobs = [pool.submit(runtime.build_kernels),
                pool.submit(runtime.load_blend_kernel, glass_device_source(False), GLASS_LAYOUT),
                pool.submit(runtime.load_blend_kernel, glass_device_source(True),
                            GLASS_TEX_LAYOUT),
                pool.submit(runtime.load_blend_kernel, STRESS_FS_CUDA, STRESS_LAYOUT),
                pool.submit(runtime.load_blend_kernel, SOUP_FS_CUDA, SOUP_LAYOUT)]
        so = jobs[0].result()
        for job in jobs[1:]:
            job.result()
    runtime.load_kernels()
    print(f"phase 1: {'built' if fresh else 'reused'} {so.relative_to(REPO)} and the blend "
          f"kernels of 4 fragment shaders in {time.perf_counter() - t0:.1f} s (one nvcc per "
          f"source and per shader, all in parallel, + link + load)")
    log_path = so.with_suffix(".log")
    if log_path.exists():
        for line in ptxas_lines(log_path):
            print(f"  ptxas: {line}")

    def plain(bins, grid, z, acc, compare, write, clamp, off):
        # Bins without rectangles take the plain version's rank walk, which
        # culls nothing: the oracle holds the kernels' rectangles too.
        raster_mod._raster_segmented_torch(bins._replace(rect=None), grid, z, acc, compare,
                                           write, clamp, off)

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
          f"{covered} px): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; before the redesign "
          f"{BEFORE_MS['demo triangle']} ms [{card}]")

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
    print(f"phase 2b: K1 stress 1080p GREATER: kernel {s_ms:.4f} ms, plain {s_plain_ms:.4f} ms; "
          f"largest tile {tile_entries(bins, grid)} entries; before the redesign "
          f"{BEFORE_MS['stress draw']} ms [{card}]")

    # -- 2c. K1's cull on its hard cases, all eight compares --------------------
    from zenith_tpu_torch.ops.binning import tile_overlap

    c_clip, c_idx, c_col = (torch.from_numpy(a).to(dev) for a in cull_stress_scene())
    c_rec, c_corner = setup_with_attrs(c_clip, c_idx, c_col, W, H, cull_mode=CullMode.NONE)
    c_entries = int(tile_overlap(c_rec, grid).sum())
    c_bins = bin_segmented(c_rec, c_corner, grid, mid_cap=8192, huge_cap=4096,
                           entry_budget=c_entries)
    check(int(c_bins.overflow) == 0, "cull stress: the binning dropped entries")
    aabb = c_rec.aabb[c_rec.valid]
    far_out = int(((aabb[:, 0] < -W) | (aabb[:, 2] > 2 * W) | (aabb[:, 1] < -H)
                   | (aabb[:, 3] > 2 * H)).sum())
    check(far_out > 0, "cull stress: no record reaches far outside the surface")
    for cfg in configs[:8]:
        cov = compare_exact(*both(c_bins, grid, init, sample_offset=CULL_OFFSET, **cfg),
                            f"cull stress {cfg}")
        print(f"  bit-equal: {cfg['compare_op'].name:<17} write={cfg['depth_write']!s:<5} "
              f"covered {cov}")
    print(f"phase 2c: cull stress 1080p, sample offset {CULL_OFFSET}: {int(c_rec.valid.sum())} "
          f"valid records ({far_out} with an AABB more than a surface off-screen), "
          f"{c_entries} entries; K1 bit-equal to its plain version for all eight compares "
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

    print(f"phases 1-4 took {time.perf_counter() - t_start:.1f} s")

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"{label} took {time.perf_counter() - t0:.1f} s")
        return out

    deferred = timed("phases 5-7", deferred_phases, dev, card, plain)
    translucent, glass_launches = timed("phases 8-12", translucency_phases, dev, card,
                                        (bins, grid, init), plain)
    capped = timed("phase 13", capped_phase, dev, card, (clip, idx, colors))
    textured = timed("phase 14", textured_phases, dev, card, plain)
    forward = timed("phase 15", forward_phases, dev, card, plain,
                    (c_bins, init, compare_exact, both))
    terrain = timed("phase 16", terrain_phases, dev, card, plain)
    layered = timed("phase 17", layered_phases, dev, card, plain)
    extras = timed("phase 18", extras_phases, dev, card, plain)
    anim = timed("phase 19", anim_phases, dev, card, plain)
    viewer = timed("phase 20a", viewer_phase, dev, card)
    spmd = timed("phases 20b-20d", spmd_phases, dev, card, plain)
    sl = timed("phase 20e", sort_last_phases, dev, card, plain)
    sweep = timed("phase 21", sweep_phases, dev, card, plain)
    k1_def = deferred["k1"]
    deferred["k2"]["launches"] += (glass_launches["K2"] + textured["K2"] + terrain["K2"]
                                   + layered["K2"] + extras["K2"] + anim["K2"] + spmd["K2"]
                                   + sl["K2"])
    kernels = [{
        "name": "K1 segmented raster (_segmented_kernel)",
        "route": "cuda",
        "source": "zenith_tpu_torch/csrc/raster.cu",
        "replaces": "zenith_tpu/ops/raster.py:311",
        "launches": (main_launches + deferred["k1_launches"] + glass_launches["K1"]
                     + textured["K1"] + forward["K1"] + terrain["K1"] + layered["K1"]
                     + extras["K1"] + anim["K1"] + viewer["K1"] + spmd["K1"] + sl["K1"]
                     + sweep["K1"]),
        "max_abs_err": max(max_err, k1_def["max_abs_err"]),
        "ms": k1_def["ms"],
        "plain_ms": k1_def["plain_ms"],
        "bound_ms": k1_def["bound_ms"],
        "bound_by": k1_def["bound_by"],
        "library_ms": None,
        "shape": "deferred G-buffer pass 1080p",
    }, dict(deferred["k2"], shape="1080p G-buffer, 100 point lights"), *translucent, *capped]
    for row in translucent:
        row["launches"] += (forward.get(row["name"][:2], 0) + spmd.get(row["name"][:2], 0)
                            + sweep.get(row["name"][:2], 0))
        if row["name"][:2] in ("K5", "K6"):
            row["max_abs_err"] = max(row["max_abs_err"], sweep["blend_err"])
    print(f"  launches on the main paths: K1 {main_launches} (triangle, phase 4) + "
          f"{deferred['k1_launches']} (deferred, phase 7) + {glass_launches['K1']} (glass and "
          f"stencil frames, phases 11-12) + {textured['K1']} (textured, phase 14a) + "
          f"{forward['K1']} (forward SceneApp, MSAA, lines and points, phase 15) + "
          f"{terrain['K1']} (terrain, feature SceneApp, fly and mesh, phase 16) + "
          f"{layered['K1']} (instancing, cascades, cube faces and VSM, phase 17) + "
          f"{extras['K1']} (IBL, post extras, temporal passes and the probe, phase 18) + "
          f"{anim['K1']} (DoF, HUD, particles, skins, morphs and picking, phase 19) + "
          f"{viewer['K1']} (FlyApp served, phase 20a) + {spmd['K1']} (SceneApp and the "
          f"stand-alone steps in bands, phases 20b-20c) + {sl['K1']} (forward SceneApp "
          f"single-device, banded, sort-last and auto, phase 20e) + {sweep['K1']} (the state "
          f"sweeps and the split draws, phase 21); K2 "
          f"{deferred['k2']['launches']} (phases 7, 11, 14a, 16c, 17, 18, 19 and 20b); "
          + "; ".join(f"{r['name'][:2]} {r['launches']}" for r in translucent)
          + f" (phases 11-12; K3 {forward['K3']}, K4 {forward['K4']} and K5 {forward['K5']} "
          f"of them under 4x MSAA, phase 15b, K5 {spmd['K5']} in bands, phase 20d, K3 "
          f"{sweep['K3']}, K5 {sweep['K5']} and K6 {sweep['K6']} in the sweeps and splits, "
          f"phase 21); "
          + "; ".join(f"{r['name'][:2]} {r['launches']}" for r in capped) + " (phase 13)")
    print(f"the whole script took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
