"""Feature renderers (reference zenith-renderer/src/lib.rs:1-3; torch port of
zenith_tpu/renderer). Ported so far: the triangle, the textured forward mesh
renderer, the forward shadow renderer (MSAA and wireframe included), the
deferred PBR renderer (textured materials and the wireframe view included),
and the post chain's bloom + ACES and present encode; ROADMAP lists the
rest."""

from zenith_tpu_torch.renderer.deferred import DeferredRenderer
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
from zenith_tpu_torch.renderer.triangle import TriangleRenderer

__all__ = [
    "DeferredRenderer",
    "DirectionalLight",
    "ForwardShadowRenderer",
    "MeshRenderer",
    "PointLight",
    "PostProcess",
    "PresentEncode",
    "Scene",
    "SceneObject",
    "SpotLight",
    "TriangleRenderer",
]
