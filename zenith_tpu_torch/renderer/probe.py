"""Reflection probes: render the scene into a cube map, preintegrate it and
light with it, all on the device (torch port of
zenith_tpu/renderer/probe.py).

- Render to cube: six face renders through the deferred pipeline, one
  frame function for all six (the face camera rides dynamics).
- IBL preintegration (ops.ibl): the SH projection and the GGX mip chain run
  on the device tensors the faces come back as; nothing is copied to the
  host.
- EnvironmentLight: the probe becomes ``Scene.environment`` like any other
  environment.

The face cameras use the Vulkan cube-face basis of the omni shadows and the
cube sampler, with the engine's reverse-Z infinite projection, since the
faces go through the full rasterizer.
"""

from __future__ import annotations

import numpy as np
import torch

from zenith_tpu_torch.core import mathtypes as m
from zenith_tpu_torch.core.mathtypes import Radians
from zenith_tpu_torch.renderer.omni import _FACE_BASIS


class _ProbeCamera:
    """The camera of one cube face: precomputed matrices, exactly what
    DeferredRenderer reads per frame."""

    def __init__(self, face: int, position, near: float = 0.05):
        eye = np.asarray(position, np.float64).reshape(3)
        fwd, ua, va = (np.asarray(v, np.float64) for v in _FACE_BASIS[face])
        # View rows [u; -v; -fwd]: with the engine's flip @ P(90°) pixel
        # (u, v) lands on the Vulkan face-table direction.
        rot = np.stack([ua, -va, -fwd])
        view = np.eye(4)
        view[:3, :3] = rot
        view[:3, 3] = -rot @ eye
        proj = m.perspective_infinite_reverse_rh(Radians(np.pi / 2.0), 1.0, near).astype(
            np.float64)
        rvp = m.VULKAN_Y_FLIP.astype(np.float64) @ proj @ view
        self.render_view_projection = rvp.astype(np.float32)
        self.render_inv_view_projection = np.linalg.inv(rvp).astype(np.float32)
        self.location = eye.astype(np.float32)
        self.forward = fwd.astype(np.float32)
        self.z_near = float(near)


def capture_reflection_probe(
    device,
    scene,
    position,
    *,
    size: int = 64,
    num_mips: int = 5,
    samples: int = 64,
    shadows: bool = False,
    name: str = "probe",
):
    """Render six faces of ``scene`` from ``position`` on ``device`` (a
    RenderDevice) and preintegrate them into a device-resident
    EnvironmentLight, with no host copy. The faces share one frame
    function (the camera rides dynamics); ``shadows=False`` by default, as
    in the reference."""
    from zenith_tpu_torch.renderer.deferred import DeferredRenderer
    from zenith_tpu_torch.renderer.environment import EnvironmentLight
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.rhi import Format, PipelineCache, TextureDesc

    renderer = DeferredRenderer(scene, shadows=shadows, winding_flip=True)
    cache = PipelineCache()
    # The faces are small: shrink the tile so binning stays efficient.
    options = CompileOptions(tile_h=8, tile_w=min(128, size))
    faces = []
    for k in range(6):
        cam = _ProbeCamera(k, position)
        builder = RenderGraphBuilder()
        out = builder.create(TextureDesc.color(f"{name}.face", size, size, Format.RGBA32F))
        builder.export(out)
        renderer.render_to(builder, out, cam, size, size)
        compiled = builder.build().compile(device, cache, options)
        compiled.execute(device)
        faces.append(compiled.value(out))
    cube = torch.stack(faces)
    return EnvironmentLight.from_device_cube(name, cube, num_mips=num_mips, samples=samples)
