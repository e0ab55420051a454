"""Feature renderers (reference zenith-renderer/src/lib.rs:1-3; torch port of
zenith_tpu/renderer). Only the triangle is ported; ROADMAP lists the rest."""

from zenith_tpu_torch.renderer.triangle import TriangleRenderer

__all__ = ["TriangleRenderer"]
