"""Feature renderers (reference zenith-renderer/src/lib.rs:1-3; torch port of
zenith_tpu/renderer): the triangle, the textured forward mesh renderer, the
forward shadow renderer (MSAA and wireframe included), the deferred PBR
renderer (textured materials, the wireframe view, decals, SSAO, contact
shadows, the atmosphere sky, the image-based light, skinned and morphed
objects, the velocity plane and the object-id plane included), reflection
probes, the single-target screen-space passes (reflections, volumetric fog,
lens flare, depth of field), the temporal passes (TAA, motion blur),
particles simulated on the device, the debug HUD (``renderer.hud``),
skeletal animation (``renderer.animation``), and the post chain (bloom +
ACES, auto-exposure, grade, FXAA, film) and present encode. Every node
runs in row bands under an SPMD mesh (``CompileOptions(mesh=...)``)."""

from zenith_tpu_torch.ops.atmosphere import Atmosphere
from zenith_tpu_torch.renderer.decal import Decal
from zenith_tpu_torch.renderer.deferred import DeferredRenderer, SSAOOptions
from zenith_tpu_torch.renderer.dof import DepthOfField
from zenith_tpu_torch.renderer.environment import EnvironmentLight
from zenith_tpu_torch.renderer.flare import LensFlare
from zenith_tpu_torch.renderer.forward import ForwardShadowRenderer
from zenith_tpu_torch.renderer.mesh import MeshRenderer
from zenith_tpu_torch.renderer.motion_blur import MotionBlur
from zenith_tpu_torch.renderer.particles import ParticleSystem
from zenith_tpu_torch.renderer.post import ColorGrade, FilmEffects, PostProcess, PresentEncode
from zenith_tpu_torch.renderer.probe import capture_reflection_probe
from zenith_tpu_torch.renderer.scene import (
    DirectionalLight,
    PointLight,
    Scene,
    SceneObject,
    SpotLight,
)
from zenith_tpu_torch.renderer.ssr import ScreenSpaceReflections
from zenith_tpu_torch.renderer.taa import TemporalAA
from zenith_tpu_torch.renderer.triangle import TriangleRenderer
from zenith_tpu_torch.renderer.volumetric import VolumetricFog

__all__ = [
    "Atmosphere",
    "ColorGrade",
    "Decal",
    "DeferredRenderer",
    "DepthOfField",
    "DirectionalLight",
    "EnvironmentLight",
    "FilmEffects",
    "ForwardShadowRenderer",
    "LensFlare",
    "MeshRenderer",
    "MotionBlur",
    "ParticleSystem",
    "PointLight",
    "PostProcess",
    "PresentEncode",
    "SSAOOptions",
    "Scene",
    "SceneObject",
    "ScreenSpaceReflections",
    "SpotLight",
    "TemporalAA",
    "TriangleRenderer",
    "VolumetricFog",
    "capture_reflection_probe",
]
