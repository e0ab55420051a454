#!/usr/bin/env python3
"""Times K2, K5 and K6 of one checkout of the PyTorch/CUDA port, so that two
commits can be compared on one card in one session.

    python3 tools/kernel_ab.py <checkout>

imports ``zenith_tpu_torch`` and ``chip_smoke`` from ``<checkout>`` (a tree
unpacked with ``git archive``, or this repository), builds its kernels, and
times at chip_smoke.py's own 1080p inputs:

- K2 on the deferred scene's G-buffer with its 100 point lights (phase 5);
- K5 on the two glass panes of the kernel-mode glass frame (phase 11);
- K5 and K6 on the 256 translucent screen-sized triangles, K6 through a
  read-only stencil mask whose faces differ (phase 10).

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
    """Device time in ms per call of ``fn`` spent in kernels whose name holds
    ``part`` (torch.profiler, kernels only, after one untimed call). The
    tree under test may predate chip_smoke's own ``device_ms``."""
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
    from zenith_tpu_torch.ops.binning import TileGrid
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
        GraphicPipelineAttachments,
        GraphicPipelineState,
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
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    print("AB " + json.dumps(main(Path(sys.argv[1]).resolve())))
