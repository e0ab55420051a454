"""Vertex-layout derivation from annotated classes.

The analog of ``#[derive(VertexLayout)]`` (zenith-rhi-derive/src/lib.rs:
60-232): the reference proc-macro maps a #[repr(C)] struct's fields to
vertex attributes with locations in field order and offsets from memoffset.
Here a class with ``vecN``/``float`` annotations derives a
``VertexLayout`` the same way — locations = field order, tightly packed
float32, with ``pack``/``unpack`` helpers replacing bytemuck casts.

>>> @vertex_layout
... class Vertex:
...     position: vec3
...     color: vec3
>>> Vertex.layout.stride_floats
6
>>> v = Vertex.pack([((0, 0.5, 0), (1, 0, 0))])
>>> v.shape
(1, 6)
"""

from __future__ import annotations

from typing import Any, get_type_hints

import numpy as np

from zenith_tpu_torch.rhi.state import VertexLayout


class _Vec:
    def __init__(self, components: int):
        self.components = components


float1 = _Vec(1)
vec2 = _Vec(2)
vec3 = _Vec(3)
vec4 = _Vec(4)

_SCALARS = {float: 1, "float": 1, "f32": 1}


def vertex_layout(cls):
    """Class decorator deriving a VertexLayout from field annotations.

    Mirrors the proc-macro's rules (zenith-rhi-derive/src/lib.rs:96-232):
    fields in declaration order become attributes at consecutive locations;
    supported types are float and vec2/3/4 (f32 vectors). The reference's
    #[repr(C)] requirement (lib.rs:68-75) maps to the tightly-packed (N,
    stride) float32 array layout enforced by ``pack``.
    """
    # Under `from __future__ import annotations` (PEP 563) annotations are
    # strings — resolve the known names.
    _by_name = {"float1": float1, "vec2": vec2, "vec3": vec3, "vec4": vec4,
                "float": float, "f32": float}
    fields = []
    for name, ann in cls.__annotations__.items():
        if isinstance(ann, str):
            ann = _by_name.get(ann.strip(), ann)
        if isinstance(ann, _Vec):
            comps = ann.components
        elif ann in _SCALARS:
            comps = 1
        else:
            raise TypeError(
                f"vertex field '{name}': unsupported type {ann!r} "
                f"(use float or vec2/vec3/vec4, matching the derive macro's "
                f"f32 scalar/array support)"
            )
        fields.append((name, comps))

    layout = VertexLayout.from_fields(*fields)
    cls.layout = layout

    def pack(rows) -> np.ndarray:
        """Rows of per-field tuples → (N, stride) float32 vertex buffer."""
        out = np.zeros((len(rows), layout.stride_floats), np.float32)
        for i, row in enumerate(rows):
            off = 0
            for (name, comps), value in zip(fields, row):
                v = np.asarray(value, np.float32).reshape(-1)
                assert v.size == comps, (
                    f"field '{name}' expects {comps} floats, got {v.size}"
                )
                out[i, off : off + comps] = v
                off += comps
        return out

    def unpack(array):
        return layout.unpack(array)

    cls.pack = staticmethod(pack)
    cls.unpack = staticmethod(unpack)
    return cls
