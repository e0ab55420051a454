"""Feature renderers (reference zenith-renderer/src/lib.rs:1-3; torch port of
zenith_tpu/renderer). Ported so far: the triangle, the deferred PBR renderer
at its defaults, and the post chain's bloom + ACES and present encode;
ROADMAP lists the rest."""

from zenith_tpu_torch.renderer.deferred import DeferredRenderer
from zenith_tpu_torch.renderer.post import PostProcess, PresentEncode
from zenith_tpu_torch.renderer.scene import (
    DirectionalLight,
    PointLight,
    Scene,
    SceneObject,
    SpotLight,
)
from zenith_tpu_torch.renderer.triangle import TriangleRenderer

__all__ = [
    "DeferredRenderer",
    "DirectionalLight",
    "PointLight",
    "PostProcess",
    "PresentEncode",
    "Scene",
    "SceneObject",
    "SpotLight",
    "TriangleRenderer",
]
