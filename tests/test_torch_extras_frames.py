"""Whole 128×64 frames of this slice's features, the JAX graph and the port's
on the same scene (carried across by ``interop.scene_from``), through the
same per-frame flow in each package: the image-based light with FXAA,
grade, film and auto-exposure; a scene lit by its own reflection probe;
and TAA with the velocity plane and motion blur over instanced rocks after
three fed-back frames of a moving camera.

This file holds the IBL case and the body every case runs
(``check_frame``); test_torch_extras_frames_probe.py and
test_torch_extras_frames_temporal.py hold the other two, one case a file,
as each case's JAX frame takes ~20 s to compile on the CPU and the suite
spreads files, not cases, over its workers.

Tolerance: the encoded frames ≤ 1 LSB with < 1% of values differing (the
golden tolerance, tests/test_golden.py:39-42). The temporal frame may hold
two values at 2 LSB: motion blur takes nearest taps along each pixel's
velocity, and the two packages' previous world positions (the ``g.prev``
plane) differ by up to 0.017 units (at pixel x=109, y=24; the clip's FMA
rounding, ROADMAP §3, "Deferred"). At pixel (x=49, y=44), where they
differ by 0.0031, that moves a tap across a pixel edge: its red and blue
land 2 LSB apart (1 LSB without the blur).
"""

import importlib

import numpy as np
import pytest
import torch

from test_torch_shadow_frames import CPU
from zenith_tpu_torch import interop

torch.set_num_threads(1)
W, H = 128, 64


def _scene(case):
    """The reference's scene for ``case``: test_renderers.py's, with two
    point lights; the sky's environment (ibl), or four instanced rocks
    (temporal)."""
    from test_renderers import build_test_scene

    from zenith_tpu.renderer import EnvironmentLight, SceneObject
    from zenith_tpu.rhi import RhiCore
    from zenith_tpu.sandbox.scene import sky_cube_pixels

    dev = RhiCore().create_render_device()
    scene = build_test_scene(dev, num_lights=2)
    if case == "ibl":
        scene.environment = EnvironmentLight.from_cube_pixels("sky.env", sky_cube_pixels(16),
                                                              num_mips=3, samples=16)
    if case == "temporal":
        offs = np.array([[-30, 10, 0], [-12, 25, 0], [15, 22, 0], [32, 8, 0]], np.float32)
        scene.objects.append(SceneObject.cube(dev, "rocks", size=6.0, z0=0.0,
                                              base_color=(0.35, 0.33, 0.3, 1.0),
                                              instance_offsets=offs))
    return scene


def _frames(pkg, case, scene):
    """Run ``case`` in package ``pkg`` ("zenith_tpu" or "zenith_tpu_torch")
    and return its last LDR frame as numpy."""
    r = importlib.import_module(f"{pkg}.renderer")
    rg = importlib.import_module(f"{pkg}.rendergraph")
    rhi = importlib.import_module(f"{pkg}.rhi")
    cam_mod = importlib.import_module(f"{pkg}.core.camera")
    mt = importlib.import_module(f"{pkg}.core.mathtypes")
    core = rhi.RhiCore(CPU) if pkg == "zenith_tpu_torch" else rhi.RhiCore()
    device = core.create_render_device()
    if case == "probe":
        scene.environment = r.capture_reflection_probe(device, scene, (0.0, -20.0, 12.0),
                                                       size=16, num_mips=3, samples=16)
        scene.skybox = None
    renderer = r.DeferredRenderer(scene, velocity=True if case == "temporal" else None)
    taa = mblur = None
    if case == "ibl":
        post = r.PostProcess(fxaa=True, auto_exposure=True,
                             grade=r.ColorGrade(exposure_ev=0.15, contrast=1.08, saturation=1.12,
                                                temperature=0.35, tint=-0.05, vignette=0.45),
                             film=r.FilmEffects(chromatic_aberration=2.5, sharpen=0.4,
                                                grain=0.035))
    else:
        post = r.PostProcess()
    if case == "temporal":
        taa, mblur = r.TemporalAA(), r.MotionBlur()
    cam = cam_mod.Camera(fov_y=mt.Degree(45.0), aspect_ratio=W / H)
    cam.set_yaw_pitch(mt.Radians(0.0), mt.Radians(-0.25))
    cache = rhi.PipelineCache()
    for f in range({"temporal": 3, "ibl": 2}.get(case, 1)):
        cam.set_position(np.array([2.0 * f, -60.0, 25.0], np.float32))
        if taa is not None:
            taa.jitter_camera(cam, W, H)
        post.set_delta_time(0.1)
        b = rg.RenderGraphBuilder()
        src = hdr = b.create(rhi.TextureDesc.color("hdr", W, H))
        out = b.create(rhi.TextureDesc.color("out", W, H))
        b.export(out)
        renderer.render_to(b, hdr, cam, W, H)
        if taa is not None:
            t = b.create(rhi.TextureDesc.color("taa", W, H))
            taa.render_to(b, src, t, cam, W, H, renderer.gbuffer_handles)
            m = b.create(rhi.TextureDesc.color("mblur", W, H))
            src = mblur.render_to(b, t, m, cam, renderer.gbuffer_handles)
        post.render_to(b, src, out)
        compiled = b.build().compile(device, cache, rg.CompileOptions(tile_h=8))
        compiled.execute(device)
        if taa is not None:
            taa.feedback(compiled.value(t))
        if post.exposure_out is not None:
            post.feedback(compiled.value(post.exposure_out))
    img = compiled.value(out)
    return img.numpy() if isinstance(img, torch.Tensor) else np.asarray(img)


def check_frame(case):
    """``case``'s last frame in both packages, ≤ 1 LSB with < 1% of values
    differing (the temporal frame: two values at 2 LSB)."""
    jscene = _scene(case)
    scene = interop.scene_from(jscene, CPU)
    ref = _frames("zenith_tpu", case, jscene)
    port = _frames("zenith_tpu_torch", case, scene)
    assert np.isfinite(port).all() and port[..., :3].std() > 0.02
    from zenith_tpu_torch.rhi import Format, encode_present

    enc = [encode_present(torch.from_numpy(np.array(x)), Format.RGBA8_SRGB).numpy()
           .astype(np.int16) for x in (port, ref)]
    d = np.abs(enc[0] - enc[1])
    beyond = int((d > 1).sum())
    assert float((d > 0).mean()) < 0.01, (case, float((d > 0).mean()))
    if case == "temporal":
        assert beyond <= 2 and int(d.max()) <= 2, (case, beyond, int(d.max()))
    else:
        assert beyond == 0, (case, int(d.max()))


@pytest.mark.parametrize("case", ["ibl"])
def test_frame_matches_the_jax_frame(case):
    check_frame(case)
