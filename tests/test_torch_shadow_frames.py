"""Shared by the port's shadow tests (tests/test_torch_csm.py,
test_torch_omni.py, test_torch_vsm.py), and holding no test itself: one
deferred frame of a scene the reference package builds, rendered by the
reference (its frame compiled with ``jax.jit`` by the render graph) and by
the port on the interop copy, with the same camera."""

import numpy as np
import torch

CPU = torch.device("cpu")


def cameras(fov_deg, aspect, position, yaw, pitch):
    """The same camera in both packages."""
    from zenith_tpu.core.camera import Camera as JCamera
    from zenith_tpu.core.mathtypes import Degree as JDegree, Radians as JRadians

    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree, Radians

    out = []
    for cls, deg, rad in ((JCamera, JDegree, JRadians), (Camera, Degree, Radians)):
        cam = cls(fov_y=deg(fov_deg), aspect_ratio=aspect)
        cam.set_position(np.asarray(position, np.float32))
        cam.set_yaw_pitch(rad(yaw), rad(pitch))
        out.append(cam)
    return out


def jax_frame(scene, camera, w, h, **renderer_kw):
    from zenith_tpu.renderer import DeferredRenderer
    from zenith_tpu.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu.rhi import PipelineCache, RhiCore, TextureDesc

    device = RhiCore().create_render_device()
    builder = RenderGraphBuilder()
    out = builder.create(TextureDesc.color("out", w, h))
    builder.export(out)
    DeferredRenderer(scene, **renderer_kw).render_to(builder, out, camera, w, h)
    compiled = builder.build().compile(device, PipelineCache(), CompileOptions(tile_h=8))
    compiled.execute(device)
    return np.asarray(compiled.value(out))


def port_frame(scene, camera, w, h, retained_check=False, **renderer_kw):
    """The port's HDR frame; with ``retained_check`` a retained re-run
    with the renderer's frame dynamics must reproduce it exactly."""
    from zenith_tpu_torch.renderer import DeferredRenderer
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.rhi import PipelineCache, RhiCore, TextureDesc

    device = RhiCore(CPU).create_render_device()
    renderer = DeferredRenderer(scene, **renderer_kw)
    builder = RenderGraphBuilder()
    out = builder.create(TextureDesc.color("out", w, h))
    builder.export(out)
    renderer.render_to(builder, out, camera, w, h)
    compiled = builder.build().compile(device, PipelineCache(), CompileOptions(tile_h=8))
    compiled.execute(device)
    img = compiled.value(out).numpy().copy()
    if retained_check:
        compiled.execute(device, dynamics=renderer.frame_dynamics(camera))
        np.testing.assert_array_equal(compiled.value(out).numpy(), img)
    return img


def lsb(a, b):
    """(max, fraction of values differing) of the two HDR frames encoded
    to 8-bit sRGB by the port's present encode."""
    from zenith_tpu_torch.rhi import Format, encode_present

    ea, eb = (encode_present(torch.from_numpy(np.array(x)), Format.RGBA8_SRGB).numpy()
              .astype(np.int16) for x in (a, b))
    d = np.abs(ea - eb)
    return int(d.max()), float((d > 0).mean())
