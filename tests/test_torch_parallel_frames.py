"""The heavy graph frames of tests/test_parallel.py on the port:
CompileOptions(mesh=default_mesh(8, device="cpu")) renders the shadowed
forward scene (tests/test_renderers.py's) in row bands, and
make_sort_last_frame shards triangles (the deferred scenes are
test_torch_parallel_deferred.py's and the two-node 4x MSAA chain
test_torch_parallel_msaa.py's, files of their own so that the suite's
workers share the JAX compiles and no file runs much over 30 s). The scenes are built with the
reference's API and carried across by zenith_tpu_torch.interop, so both
packages draw the same numbers.

Each case holds the port's banded frame against the port's single-device
frame at the reference's own tolerance (test_parallel.py), and against
the JAX 8-device frame (``default_mesh(8, backend="cpu")``, the Pallas
raster in interpret mode):

- forward scene: < 0.5% of pixels off by > 1e-3 and < 0.5% of depths
  off by > 1e-4 against single-device (the reference's band-offset
  tolerance); against JAX the encoded frame ≤ 1 LSB with < 1% of values
  differing (the golden tolerance: the near-clipped ground's positions
  differ by XLA's FMA contraction, ROADMAP §3);
- sort-last: depth atol 1e-5, colour 1e-4 against the single-device draw
  (the reference's tolerance), the same against JAX's sort-last frame.

The JAX frames compile for ~10-30 s each; they are computed once each.
"""

from __future__ import annotations

import numpy as np
import torch

from test_torch_spmd_twins import jax_mesh, run_graph
from zenith_tpu_torch import interop
from zenith_tpu_torch.parallel import default_mesh
from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
from zenith_tpu_torch.rhi import Format, PipelineCache, RhiCore, TextureDesc, encode_present

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 64  # 8 shards x tile_h 8


def _encode(img):
    return encode_present(torch.from_numpy(np.array(img)), Format.RGBA8_SRGB).numpy()


def _lsb(a, b):
    d = np.abs(_encode(a).astype(np.int16) - _encode(b).astype(np.int16))
    return int(d.max()), float((d > 0).mean())


# -- TestEngineSPMD: the shadowed forward scene -------------------------------------


def test_shadowed_forward_scene_sharded_matches_single(cpu_devices):
    from test_renderers import build_test_scene, make_camera

    from zenith_tpu.renderer import ForwardShadowRenderer as JForward
    from zenith_tpu.rhi import RhiCore as JCore
    from zenith_tpu.rhi import TextureDesc as JTex
    from zenith_tpu_torch.renderer import ForwardShadowRenderer

    jscene = build_test_scene(JCore().create_render_device())
    renderer = ForwardShadowRenderer(interop.scene_from(jscene, CPU))
    cam = make_camera()

    def build(renderer, tex):
        def f(builder):
            color = builder.create(tex.color("rt", W, H))
            depth = builder.create(tex.depth("ds", W, H))
            builder.export(color)
            builder.export(depth)
            renderer.render_to(builder, color, depth, cam)
            return color, depth
        return f

    img1, z1 = run_graph("port", build(renderer, TextureDesc), None)
    img8, z8 = run_graph("port", build(renderer, TextureDesc), default_mesh(8, device="cpu"))
    assert img8.shape == img1.shape and z8.shape == z1.shape
    # Band-offset float math can flip sub-ulp coverage on a handful of
    # triangle-edge pixels; everything else agrees tightly.
    diff = np.abs(img8[..., :3] - img1[..., :3]).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.005
    assert (np.abs(z8 - z1) > 1e-4).mean() < 0.005
    assert img1[..., :3].std() > 0.05  # cube + shadow + ground rendered
    jimg, _ = run_graph("jax", build(JForward(jscene), JTex), jax_mesh())
    mx, frac = _lsb(img8, jimg)
    assert mx <= 1 and frac < 0.01, (mx, frac)


# -- TestSortLast -----------------------------------------------------------------------------


def test_sort_last_matches_single_device(cpu_devices, rng):
    import jax.numpy as jnp
    from test_parallel import _fs as jfs
    from test_parallel import _vs as jvs

    from zenith_tpu.parallel import make_sort_last_frame as ref_sort_last
    from zenith_tpu.rhi import GraphicPipelineDesc as JDesc
    from zenith_tpu.rhi import GraphicShaderInput as JInput
    from zenith_tpu.rhi import PipelineCache as JCache
    from zenith_tpu.rhi import Shader as JShader
    from zenith_tpu.rhi import VertexLayout as JLayout
    from zenith_tpu.rhi import (
        ColorAttachmentDesc as JCad,
        CullMode as JCull,
        Format as JFormat,
        GraphicPipelineAttachments as JAtt,
        RasterizationState as JRast,
    )
    from zenith_tpu.rhi.state import DepthStencilDesc as JDs
    from zenith_tpu.rhi.state import GraphicPipelineState as JState
    from test_torch_parallel import make_pipeline
    from zenith_tpu_torch.ops import TileGrid, clear_color, clear_depth
    from zenith_tpu_torch.ops.draw import draw_indexed
    from zenith_tpu_torch.parallel import make_sort_last_frame

    nv = 48
    pos = rng.uniform(-1.0, 1.0, size=(nv, 2))
    zz = rng.uniform(0.1, 0.9, size=(nv, 1))
    col = rng.uniform(0, 1, size=(nv, 3))
    vb_np = np.concatenate([pos, zz, col], axis=1).astype(np.float32)
    idx_np = rng.integers(0, nv, size=(32, 3)).astype(np.int32)  # 32 % 8 == 0

    pipe = make_pipeline(depth=True)
    step = make_sort_last_frame(default_mesh(8, device="cpu"), pipe, W, H, tile_h=8)
    vb, ib = torch.from_numpy(vb_np), torch.from_numpy(idx_np)
    c8, z8 = step(vb, ib, {})
    grid = TileGrid(width=W, height=H, tile_h=8, tile_w=128)
    colors, depth, _ = draw_indexed([clear_color(H, W, (0, 0, 0, 1), CPU)],
                                    clear_depth(H, W, 0.0, CPU), pipe, vb, ib, {}, grid)
    np.testing.assert_allclose(z8.numpy(), depth.numpy(), atol=1e-5)
    np.testing.assert_allclose(c8.numpy(), colors[0].numpy(), atol=1e-4)
    assert z8.numpy().max() > 0  # something rendered

    jpipe = JCache().get_or_create(JDesc(
        shader_input=JInput(JShader.vertex("sl.vs", jvs), JShader.fragment("sl.fs", jfs),
                            JLayout.from_fields(("position", 3), ("color", 3))),
        state=JState(rasterization=JRast(cull_mode=JCull.NONE), depth_stencil=JDs().reverse_z()),
        attachments=JAtt(color_formats=(JFormat.RGBA32F,), depth_format=JFormat.D32F),
        color_attachment_descs=(JCad(),),
    ))
    jc, jz = ref_sort_last(jax_mesh(), jpipe, W, H, tile_h=8)(
        jnp.asarray(vb_np), jnp.asarray(idx_np), {})
    np.testing.assert_allclose(z8.numpy(), np.asarray(jz), atol=1e-5)
    np.testing.assert_allclose(c8.numpy(), np.asarray(jc), atol=1e-4)
