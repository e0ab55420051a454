"""Feature renderers (reference zenith-renderer/src/lib.rs:1-3; torch port of
zenith_tpu/renderer). Ported so far: the triangle, the textured forward mesh
renderer, the forward shadow renderer (MSAA and wireframe included), the
deferred PBR renderer (textured materials, the wireframe view, decals, SSAO,
contact shadows and the atmosphere sky included), the single-target
screen-space passes (reflections, volumetric fog, lens flare), and the post
chain's bloom + ACES and present encode; ROADMAP lists the rest."""

from zenith_tpu_torch.ops.atmosphere import Atmosphere
from zenith_tpu_torch.renderer.decal import Decal
from zenith_tpu_torch.renderer.deferred import DeferredRenderer, SSAOOptions
from zenith_tpu_torch.renderer.flare import LensFlare
from zenith_tpu_torch.renderer.forward import ForwardShadowRenderer
from zenith_tpu_torch.renderer.mesh import MeshRenderer
from zenith_tpu_torch.renderer.post import PostProcess, PresentEncode
from zenith_tpu_torch.renderer.scene import (
    DirectionalLight,
    PointLight,
    Scene,
    SceneObject,
    SpotLight,
)
from zenith_tpu_torch.renderer.ssr import ScreenSpaceReflections
from zenith_tpu_torch.renderer.triangle import TriangleRenderer
from zenith_tpu_torch.renderer.volumetric import VolumetricFog

__all__ = [
    "Atmosphere",
    "Decal",
    "DeferredRenderer",
    "DirectionalLight",
    "ForwardShadowRenderer",
    "LensFlare",
    "MeshRenderer",
    "PointLight",
    "PostProcess",
    "PresentEncode",
    "SSAOOptions",
    "Scene",
    "SceneObject",
    "ScreenSpaceReflections",
    "SpotLight",
    "TriangleRenderer",
    "VolumetricFog",
]
