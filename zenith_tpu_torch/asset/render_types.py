"""Render-facing asset data types (copy of the NumPy-only parts of
zenith_tpu/asset/render_types.py; reference zenith-asset/src/render.rs).

- ``Vertex`` (render.rs:10-26): position + normal + tex_coord, 8 f32, as a
  (N, 8) float32 array; VertexLayout slices the named fields.
- ``Mesh`` (render.rs:28-70): vertices + indices + material index.

The skin, animation, texture, material and collection types, and the
``Asset`` base class with its URL and cache protocol, come with the asset
manager (ROADMAP item 11); until then ``Mesh.url`` is a plain string.
"""

from __future__ import annotations

import numpy as np

from zenith_tpu_torch.rhi.state import VertexLayout

# The engine-wide static vertex layout (render.rs:10-26).
Vertex = VertexLayout.from_fields(("position", 3), ("normal", 3), ("tex_coord", 2))
VERTEX_FLOATS = Vertex.stride_floats  # 8


class Mesh:
    """(render.rs:28-70) A static mesh in the ``Vertex`` layout."""

    def __init__(self, url: str, vertices: np.ndarray, indices: np.ndarray,
                 material_index: int = 0):
        if vertices.ndim != 2 or vertices.shape[1] != VERTEX_FLOATS:
            raise ValueError(f"mesh vertices must be (N, {VERTEX_FLOATS}), got {vertices.shape}")
        self.url = str(url)
        self.vertices = np.ascontiguousarray(vertices, dtype=np.float32)
        self.indices = np.ascontiguousarray(indices, dtype=np.int32).reshape(-1)
        self.material_index = int(material_index)

    @property
    def is_skinned(self) -> bool:
        return False

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0] // 3
