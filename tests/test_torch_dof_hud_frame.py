"""A whole 128×64 frame of the port's depth of field and HUD against the
reference package's: test_picking.py's cube over the ground through the
deferred renderer, a draw that overflows its bins (test_hud.py's 300
triangles at an entry budget of 8, into a scratch target), DepthOfField,
PostProcess and the HUD with its overflow bar. The scene and the settings
are built by the reference and carried across by zenith_tpu_torch.interop.
Then the port racks the focus and changes the text on the retained frame
function. One case (the JAX frame compiles for seconds, and the suite
spreads files over its workers).

Tolerance: the encoded frame ≤ 1 LSB with < 1% of values differing (the
golden tolerance); the overflow bar's red pixels equal.
"""

import numpy as np
import torch

from test_torch_hud import _spam_draw
from zenith_tpu_torch import interop
from zenith_tpu_torch.rhi import Format as TFormat
from zenith_tpu_torch.rhi import encode_present

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 64


def _jax_parts():
    from test_renderers import make_cube

    from zenith_tpu.core.camera import Camera
    from zenith_tpu.core.mathtypes import Degree, Radians
    from zenith_tpu.renderer import DepthOfField, DirectionalLight, Scene, SceneObject
    from zenith_tpu.renderer.hud import HudOverlay
    from zenith_tpu.rhi import RhiCore

    device = RhiCore().create_render_device()
    cube = SceneObject.from_mesh(device, make_cube(size=14.0, z0=8.0), "cube",
                                 base_color=(0.8, 0.2, 0.2, 1.0), bin_capacity=64)
    ground = SceneObject.quad(device, "ground", size=200.0, z=0.0, base_color=(0.4, 0.4, 0.4, 1.0))
    scene = Scene(objects=[cube, ground],
                  sun=DirectionalLight(direction=(0.3, -0.4, 1.0), intensity=2.0,
                                       cast_shadows=False), ambient=(0.08,) * 3)
    cam = Camera(fov_y=Degree(45.0), aspect_ratio=W / H)
    cam.set_position(np.array([0.0, -60.0, 25.0], np.float32))
    cam.set_yaw_pitch(Radians(0.0), Radians(-0.25))
    hud = HudOverlay(max_chars=16, scale=1, margin=4, overflow_indicator=True)
    hud.set_text("FPS 60  OBJ 2")
    return scene, cam, DepthOfField(focus_distance=62.0, focal_range=8.0, strength=1.5), hud


def _declare(builder, renderer, cam, dof, hud, post, desc, port):
    """Scene → overflowing draw → DoF → post → HUD; returns the LDR handle."""
    hdr = builder.create(desc.color("hdr", W, H))
    sharp = builder.create(desc.color("dof", W, H))
    ldr = builder.create(desc.color("ldr", W, H))
    renderer.render_to(builder, hdr, cam, W, H)
    _spam_draw(builder, builder.create(desc.color("ovf.rt", W, H)), 8, port=port)
    dof.render_to(builder, hdr, sharp, renderer.gbuffer_handles)
    post.render_to(builder, sharp, ldr)
    hud.render_to(builder, ldr)
    builder.export(ldr)
    return ldr


def _jax_frame(scene, cam, dof, hud):
    from zenith_tpu.renderer import DeferredRenderer, PostProcess
    from zenith_tpu.rendergraph import RenderGraphBuilder
    from zenith_tpu.rendergraph.graph import CompileOptions
    from zenith_tpu.rhi import PipelineCache, RhiCore, TextureDesc

    device = RhiCore().create_render_device()
    builder = RenderGraphBuilder()
    ldr = _declare(builder, DeferredRenderer(scene, shadows=False), cam, dof, hud, PostProcess(),
                   TextureDesc, port=False)
    compiled = builder.build().compile(device, PipelineCache(), CompileOptions(tile_h=8,
                                                                                tile_w=128))
    compiled.execute(device)
    return np.asarray(compiled.value(ldr))


def _lsb(a, b):
    ea, eb = (encode_present(torch.from_numpy(np.array(x)), TFormat.RGBA8_SRGB).numpy()
              .astype(np.int16) for x in (a, b))
    d = np.abs(ea - eb)
    return int(d.max()), float((d > 0).mean())


def test_dof_hud_frame_matches_the_reference_and_retains():
    from zenith_tpu_torch.renderer import DeferredRenderer, PostProcess
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.rendergraph.graph import (
        clear_frame_program_cache,
        frame_program_cache_size,
    )
    from zenith_tpu_torch.rhi import PipelineCache, RhiCore, TextureDesc

    jscene, cam, jdof, jhud = _jax_parts()
    want = _jax_frame(jscene, cam, jdof, jhud)
    dof, hud = interop.depth_of_field_from(jdof), interop.hud_from(jhud)
    renderer = DeferredRenderer(interop.scene_from(jscene, CPU), shadows=False)
    device = RhiCore(CPU).create_render_device()
    clear_frame_program_cache()
    builder = RenderGraphBuilder()
    ldr = _declare(builder, renderer, cam, dof, hud, PostProcess(), TextureDesc, port=True)
    compiled = builder.build().compile(device, PipelineCache(), CompileOptions(tile_h=8,
                                                                                tile_w=128))
    compiled.execute(device)
    got = compiled.value(ldr).numpy()
    mx, frac = _lsb(got, want)
    assert mx <= 1 and frac < 0.01, (mx, frac)
    bh, _ = hud.bitmap_shape
    bar = (slice(4 + bh + 2, 4 + bh + 4), slice(4, W))
    red = (got[bar][..., 0] > 0.9) & (got[bar][..., 1] < 0.3)
    assert red.any() and np.array_equal(red, (want[bar][..., 0] > 0.9) & (want[bar][..., 1] < 0.3))
    # Racking focus and changing the text are changes of dynamics: the same
    # frame function renders them.
    dof.focus_at(30.0)
    hud.set_text("FPS 59  OBJ 2")
    compiled.execute(device, dynamics={**renderer.frame_dynamics(cam), **dof.frame_dynamics(),
                                       **hud.frame_dynamics()})
    racked = compiled.value(ldr).numpy()
    assert frame_program_cache_size() == 1
    assert np.abs(racked[20:, :, :3] - got[20:, :, :3]).max() > 0.02  # refocused
    assert np.abs(racked[4:4 + bh, 4:120, :3] - got[4:4 + bh, 4:120, :3]).max() > 0.5  # text
