#!/usr/bin/env python3
"""Times K2, K5, K6, K7 and K8 of one checkout of the PyTorch/CUDA port, so
that two commits can be compared on one card in one session.

    python3 tools/kernel_ab.py <checkout>

imports ``zenith_tpu_torch`` and ``chip_smoke`` from ``<checkout>`` (a tree
unpacked with ``git archive``, or this repository), builds its kernels, and
times at chip_smoke.py's own 1080p inputs:

- K2 on the deferred scene's G-buffer with its 100 point lights (phase 5);
- K5 on the two glass panes of the kernel-mode glass frame (phase 11);
- K5 and K6 on the 256 translucent screen-sized triangles, K6 through a
  read-only stencil mask whose faces differ (phase 10);
- K7 and K8 on the deferred scene's geometry seen by the camera (1080p) and
  by the sun (the 1024² shadow map), binned by the checkout's own
  ``bin_triangles`` at a capacity that drops nothing, and K1 on the same
  records through ``bin_segmented`` (phase 13);
- K1 and K3 on the 1080p stress draw, K3 with phase 8's stencil-write
  state (faces that differ, write masks).

Each is timed as a wrapper call (CUDA events, median, ``chip_smoke.cuda_ms``)
and as the kernel's own device time (torch.profiler). The last line is one
JSON object prefixed ``AB``. Run the parent and the change in turns (parent,
change, change, parent) in one session: times from two sessions may come
from two cards or hosts. Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path
from unittest import mock

import numpy as np


def device_ms(fn, part: str, reps: int = 10) -> float:
    """The mean device time in ms of the launches of the kernel whose name
    holds ``part`` (one a call of ``fn``) that a torch.profiler session
    recorded, after one call before the session and one awaited inside it
    (the tree under test may predate chip_smoke's ``device_ms``, and a
    session can miss the launches made just after it starts)."""
    import torch

    from zenith_tpu_torch.core import profile

    fn()
    torch.cuda.synchronize()
    with profile.session(cpu=False) as prof:
        fn()
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = {(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and part in e.name}
    if not spans:
        raise SystemExit(f"kernel_ab: the profiler recorded no launch of {part}")
    return sum(b - a for a, b in spans) / 1e3 / len(spans)


def main(root: Path) -> dict:
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is false: this needs a CUDA card")
    import chip_smoke as smoke
    from zenith_tpu_torch.core import profile
    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree
    from zenith_tpu_torch.ops import draw as draw_mod
    from zenith_tpu_torch.ops import lighting, raster, runtime
    from zenith_tpu_torch.ops.binning import (
        TileGrid,
        bin_segmented,
        bin_triangles,
        tile_overlap,
    )
    from zenith_tpu_torch.ops.geometry import (
        corner_attributes,
        setup_triangles,
        setup_with_attrs,
        transform_vertices,
    )
    from zenith_tpu_torch.rendergraph import CompileOptions
    from zenith_tpu_torch.renderer import DeferredRenderer
    from zenith_tpu_torch.renderer.deferred import glass_device_source
    from zenith_tpu_torch.rhi import (
        BlendFactor,
        ColorAttachmentDesc,
        Format,
        GraphicShaderInput,
        RasterizationState,
        RhiCore,
        Shader,
        uniform,
    )
    from zenith_tpu_torch.rhi import pipeline as pipe
    from zenith_tpu_torch.rhi.state import (
        CompareOp,
        CullMode,
        DepthStencilDesc,
        FrontFace,
        GraphicPipelineAttachments,
        GraphicPipelineState,
        StencilOp,
        StencilOpState,
        VertexLayout,
    )
    from zenith_tpu_torch.sandbox.scene import build_standin_scene, deferred_frame, orbit_camera

    dev = torch.device("cuda", 0)
    w, h = smoke.W, smoke.H
    runtime.build_kernels()
    runtime.load_kernels()
    runtime.load_blend_kernel(glass_device_source(False), smoke.GLASS_LAYOUT)
    runtime.load_blend_kernel(smoke.STRESS_FS_CUDA, smoke.STRESS_LAYOUT)
    with profile.session(cpu=False):  # the profiler's start-up, outside every timing
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()

    blend_calls = []
    real_blend = draw_mod.raster_segmented_blend

    def recording_blend(b, g, z, color, shade_blend, **kw):
        blend_calls.append((b, g, z.clone(), color.clone(), shade_blend, kw))
        return real_blend(b, g, z, color, shade_blend, **kw)

    def replay(call):
        b, g, z, color, shade_blend, kw = call
        return lambda: raster.raster_segmented_blend(b, g, z, color, shade_blend, **kw)

    out = {"root": str(root)}
    # The glass scene's frame: its G-buffer (K2's input) and its K5 call.
    device = RhiCore(dev).create_render_device()
    scene, _ = build_standin_scene(device, 100, np.random.default_rng(42), glass=True,
                                   glass_textured=False)
    renderer = DeferredRenderer(scene, glass_mode="kernel")
    camera = Camera(fov_y=Degree(35.0), aspect_ratio=w / h)
    orbit_camera(camera, 0.3)
    with mock.patch.object(draw_mod, "raster_segmented_blend", recording_blend):
        compiled, _, _, _ = deferred_frame(device, renderer, camera, w, h, CompileOptions(),
                                           exports=("albedo", "normal", "pos", "depth"))
    g = [compiled.value(renderer.gbuffer_handles[k]) for k in ("albedo", "normal", "pos", "depth")]
    pos, col, rad, _ = scene.light_partition()
    lp, lc, lr = (torch.from_numpy(a).to(dev) for a in (pos, col, rad))
    cam = torch.from_numpy(np.asarray(camera.location, np.float32)).to(dev)

    def k2():
        return lighting.accumulate_point_lights(*g, cam, lp, lc, lr)

    out["k2_ms"] = smoke.cuda_ms(k2, reps=50, warmup=3)
    out["k2_device_ms"] = device_ms(k2, "tiled_lights_kernel")
    panes = replay(blend_calls[0])
    out["k5_panes_ms"] = smoke.cuda_ms(panes, reps=20, warmup=2)
    out["k5_panes_device_ms"] = device_ms(panes, "raster_blend_kernel")

    # The translucent stress draws (phase 10), over then through a mask.
    layout = VertexLayout.from_fields(("position", 4), ("color", 4))
    vs = Shader.vertex("stress.vs", lambda attrs, res: {"position": attrs["position"],
                                                        "color": attrs["color"]})
    fs = Shader.fragment("stress.fs", smoke.stress_fs, bindings=[uniform("Gain")],
                         kernel_safe=True, device_source=smoke.STRESS_FS_CUDA)
    over = ColorAttachmentDesc(blend_enable=True, src_color_blend=BlendFactor.SRC_ALPHA,
                               dst_color_blend=BlendFactor.ONE_MINUS_SRC_ALPHA,
                               src_alpha_blend=BlendFactor.ONE,
                               dst_alpha_blend=BlendFactor.ONE_MINUS_SRC_ALPHA)
    translucent = DepthStencilDesc(depth_test_enable=True, depth_write_enable=False,
                                   depth_compare_op=CompareOp.GREATER)
    masked = dataclasses.replace(
        translucent, stencil_test_enable=True,
        stencil_front=StencilOpState(compare_op=CompareOp.EQUAL, compare_mask=0x01, reference=1),
        stencil_back=StencilOpState(compare_op=CompareOp.NOT_EQUAL, compare_mask=0x01,
                                    reference=1))
    rng = np.random.default_rng(29)
    draws = smoke.translucent_stress(dev)
    bg = torch.from_numpy(rng.uniform(0.0, 4.0, (h, w, 4)).astype(np.float32)).to(dev)
    init = torch.from_numpy(np.random.default_rng(11).uniform(0.0, 1.0, (h, w))
                            .astype(np.float32)).to(dev)
    init[:, : w // 2] = 0.5
    sten0 = torch.from_numpy(rng.integers(0, 4, (h, w)).astype(np.int32)).to(dev)
    for name, ds, sten in (("k5_stress", translucent, None), ("k6_stress", masked, sten0)):
        pl = pipe.GraphicPipeline(pipe.GraphicPipelineDesc(
            shader_input=GraphicShaderInput(vs, fs, layout),
            state=GraphicPipelineState(rasterization=RasterizationState(cull_mode=CullMode.NONE),
                                       depth_stencil=ds),
            attachments=GraphicPipelineAttachments(
                color_formats=(Format.RGBA32F,), depth_format=Format.D32F,
                stencil_format=Format.S8 if ds.stencil_test_enable else None),
            color_attachment_descs=(over,),
        ))
        blend_calls.clear()
        with mock.patch.object(draw_mod, "raster_segmented_blend", recording_blend):
            draw_mod.draw_indexed_batch([bg], init, pl, draws, TileGrid(w, h), stencil=sten,
                                        entry_budget=smoke.STRESS_ENTRY_BUDGET)
        call = replay(blend_calls[0])
        out[f"{name}_ms"] = smoke.cuda_ms(call, reps=10, warmup=2)
        out[f"{name}_device_ms"] = device_ms(call, "raster_blend_kernel", reps=5)

    # The capped-bin path's views of the deferred geometry (phase 13).
    pos, nrm, gidx, cam_vp, sun_vp, smsz = smoke.deferred_geometry(dev)
    vary = torch.cat([pos, nrm], dim=1)
    views = (("gbuffer", cam_vp, TileGrid(w, h), CullMode.BACK, FrontFace.COUNTER_CLOCKWISE,
              CompareOp.GREATER, 0.0),
             ("shadow", sun_vp, TileGrid(smsz, smsz), CullMode.NONE, FrontFace.CLOCKWISE,
              CompareOp.LESS, 1.0))
    for name, vp, grid, cull, front, cmp, clear in views:
        clip = transform_vertices(pos, torch.from_numpy(vp).to(dev))
        rec = setup_triangles(clip, gidx, grid.width, grid.height, cull_mode=cull,
                              front_face=front)
        k = runtime.round_up(int(tile_overlap(rec, grid).sum(1).max()), raster.K_BLOCK)
        bins = bin_triangles(rec, grid, k)
        z0 = torch.full((grid.height, grid.width), clear, device=dev)
        s0 = torch.full((grid.height, grid.width), -1, dtype=torch.int32, device=dev)
        corner = corner_attributes(rec, gidx, vary)
        attr = bins.gather_corner_data(corner)
        sbins = bin_segmented(rec, corner, grid, mid_cap=8192, huge_cap=4096,
                              entry_budget=int(tile_overlap(rec, grid).sum()))
        calls = {
            "k7": (lambda: raster.visibility_pass(bins, grid, z0, s0, compare_op=cmp),
                   "raster_capped_kernel"),
            "k8": (lambda: raster.raster_interp_pass(bins, attr, grid, z0, compare_op=cmp),
                   "raster_capped_kernel"),
            "k1": (lambda: raster.raster_segmented(sbins, grid, z0, compare_op=cmp),
                   "raster_segmented_kernel"),
        }
        for kernel, (call, part) in calls.items():
            out[f"{kernel}_{name}_ms"] = smoke.cuda_ms(call, reps=10, warmup=2)
            out[f"{kernel}_{name}_device_ms"] = device_ms(call, part)

    # K1 and K3 on the stress draw (phases 2b and 8).
    clip, idx, colors = (torch.from_numpy(a).to(dev) for a in smoke.stress_scene())
    rec, corner = setup_with_attrs(clip, idx, colors, w, h, cull_mode=CullMode.NONE)
    sbins = bin_segmented(rec, corner, TileGrid(w, h))
    s0 = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.int32)).to(dev)
    front = StencilOpState(pass_op=StencilOp.REPLACE, depth_fail_op=StencilOp.INCREMENT_AND_WRAP,
                           compare_op=CompareOp.ALWAYS, write_mask=0xF3, reference=0x5A)
    back = StencilOpState(pass_op=StencilOp.INCREMENT_AND_WRAP, depth_fail_op=StencilOp.INVERT,
                          compare_op=CompareOp.ALWAYS, write_mask=0xBF)
    calls = {"k1": lambda: raster.raster_segmented(sbins, TileGrid(w, h), init),
             "k3": lambda: raster.raster_segmented(sbins, TileGrid(w, h), init, init_stencil=s0,
                                                   stencil_front=front, stencil_back=back)}
    for kernel, call in calls.items():
        out[f"{kernel}_stress_ms"] = smoke.cuda_ms(call, reps=10, warmup=2)
        out[f"{kernel}_stress_device_ms"] = device_ms(call, "raster_segmented_kernel")
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    print("AB " + json.dumps(main(Path(sys.argv[1]).resolve())))
