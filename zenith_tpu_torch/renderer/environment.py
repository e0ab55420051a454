"""Environment lighting — a preintegrated image-based light for the
deferred PBR resolve (torch port of zenith_tpu/renderer/environment.py),
built on ops.ibl:

- diffuse: 9 SH coefficients, a (9, 3) dynamic: a host array for host
  cubes (projected on the host, so nothing is read back from the card) and
  a device tensor for device cubes (reflection probes);
- specular: a GGX-prefiltered cube mip chain, computed once on the device
  at build and kept there as a mipped cube Texture, which the render graph
  imports as a tuple of levels.

Usage::

    env = EnvironmentLight.from_cube_pixels("sky", pixels, device=dev)
    scene.environment = env      # DeferredRenderer picks it up
"""

from __future__ import annotations

import numpy as np
import torch

from zenith_tpu_torch.ops.ibl import irradiance_sh9, irradiance_sh9_host, prefilter_ggx
from zenith_tpu_torch.rhi.formats import Format
from zenith_tpu_torch.rhi.resource import Texture, TextureDesc, TextureUsage


def _cube_texture(name: str, mips: "list[torch.Tensor]", host_pixels=None) -> Texture:
    size = int(mips[0].shape[1])
    desc = TextureDesc(name, size, size, Format.RGBA32F, TextureUsage.SAMPLED,
                       mip_levels=len(mips), array_layers=6)
    return Texture(desc, mips[0], mips=list(mips), host_pixels=host_pixels)


def _check_cube(shape) -> None:
    if len(shape) != 4 or shape[0] != 6:
        raise ValueError(f"expected a (6, S, S, C) cube, got {tuple(shape)}")
    if shape[1] != shape[2]:
        raise ValueError("cube faces must be square")


class EnvironmentLight:
    """Preintegrated environment: ``texture`` is a mipped cube Texture whose
    level m is the GGX convolution at roughness m/(mips−1) (level 0 the raw
    environment, also the skybox); ``sh9`` is the (9, 3) diffuse irradiance
    projection, a host array or, for a device cube, a device tensor (never
    copied to the host)."""

    def __init__(self, texture: Texture, sh9):
        self.texture = texture
        if not isinstance(sh9, torch.Tensor):
            sh9 = np.ascontiguousarray(sh9, np.float32)
        if tuple(sh9.shape) != (9, 3):
            raise ValueError(f"sh9 must be (9, 3), got {tuple(sh9.shape)}")
        self.sh9 = sh9

    @property
    def num_mips(self) -> int:
        return self.texture.desc.mip_levels

    @staticmethod
    def from_cube_pixels(
        name: str,
        pixels: np.ndarray,  # (6, S, S, C) linear radiance, host
        num_mips: int = 5,
        samples: int = 64,
        intensity: float = 1.0,
        *,
        device: "torch.device | str",
    ) -> "EnvironmentLight":
        """A host cube: SH on the host, the prefilter on ``device``."""
        pixels = np.asarray(pixels, np.float32)
        _check_cube(pixels.shape)
        if intensity != 1.0:
            pixels = pixels.copy()
            pixels[..., :3] *= np.float32(intensity)
        sh9 = irradiance_sh9_host(pixels)
        cube = torch.from_numpy(np.ascontiguousarray(pixels)).to(device)
        mips = prefilter_ggx(cube, num_mips=num_mips, samples=samples)
        return EnvironmentLight(_cube_texture(name, mips, np.ascontiguousarray(pixels)), sh9)

    @staticmethod
    def from_device_cube(
        name: str,
        faces: torch.Tensor,  # (6, S, S, C) linear radiance on the device
        num_mips: int = 5,
        samples: int = 64,
    ) -> "EnvironmentLight":
        """Preintegration on the device (reflection probes, renderer.probe):
        the SH projection and the GGX prefilter both run on ``faces``, with
        no host round trip."""
        _check_cube(faces.shape)
        sh9 = irradiance_sh9(faces)
        mips = prefilter_ggx(faces, num_mips=num_mips, samples=samples)
        return EnvironmentLight(_cube_texture(name, mips), sh9)

    @staticmethod
    def from_texture(texture: Texture, num_mips: int = 5,
                     samples: int = 64) -> "EnvironmentLight":
        """Preintegrate an existing cube Texture (a loaded skybox) from its
        host pixels, on the texture's device."""
        return EnvironmentLight.from_cube_pixels(
            f"{texture.desc.name}.env", texture.host_linear(), num_mips=num_mips,
            samples=samples, device=texture.array.device,
        )
