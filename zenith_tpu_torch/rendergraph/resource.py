"""Typed render-graph resource handles.

Mirrors zenith-rendergraph/src/resource.rs: graph-local integer ids wrapped
in typed handles (`RenderGraphResource`), and access objects with view
markers (`Srv` read / `Uav` read-write / `Rt` render-target) returned by
node read/write declarations (resource.rs:32-92).

Storage mirrors `InitialResourceStorage` (resource.rs:107-123): managed
resources carry a desc and materialize as tensors inside the frame
function (the caching allocator's temporaries — the device.acquire_*
recycling of graph.rs:94-128 dissolves); imported resources reference live
Buffer/Texture wrappers and become frame-function inputs.
"""

from __future__ import annotations

import enum

from zenith_tpu_torch.core.collections import FastEnum
from dataclasses import dataclass
from typing import Generic, Optional, TypeVar, Union

from zenith_tpu_torch.rhi.resource import Buffer, BufferDesc, Texture, TextureDesc

R = TypeVar("R")  # Buffer | Texture


class ViewKind(FastEnum):
    """View markers (resource.rs:36-43)."""

    SRV = "srv"  # read
    UAV = "uav"  # read-write
    RT = "rt"  # render target


@dataclass(frozen=True)
class RenderGraphResource(Generic[R]):
    """Typed handle to a graph resource (resource.rs:52-66)."""

    id: int
    kind: str  # "buffer" | "texture"

    def __repr__(self) -> str:
        return f"RenderGraphResource<{self.kind}>(#{self.id})"


@dataclass(frozen=True)
class RenderGraphResourceAccess(Generic[R]):
    """A declared access to a resource from one node (resource.rs:69-92).

    Sub-resource selectors — the analog of the reference's cached
    per-subresource image views (texture.rs:536-559) and buffer ranges
    (buffer.rs:276-322):

    - ``mip``: which mip level of a mip-mapped texture this access touches
      (render-to-mip for bloom chains; reads of one level).
    - ``layer``: which array layer / cube face (render-to-layer for shadow
      cascades and rendered cube maps). None = whole resource.
    - ``brange``: (offset, size) element range of a buffer. None = whole.

    Selectors are static Python ints, so they shape the frame function and
    ride in the structure key.
    """

    resource: RenderGraphResource
    view: ViewKind
    node_index: int
    # None = whole resource (a mip-mapped texture reads as its full chain);
    # an int selects one level explicitly — including 0.
    mip: Optional[int] = None
    layer: Optional[int] = None
    brange: "Optional[tuple[int, int]]" = None

    @property
    def id(self) -> int:
        return self.resource.id

    @property
    def selector(self) -> tuple:
        return (self.mip, self.layer, self.brange)


@dataclass
class InitialResourceStorage:
    """How a resource enters the graph (resource.rs:107-123)."""

    desc: "Union[BufferDesc, TextureDesc, None]" = None  # managed
    imported: "Union[Buffer, Texture, None]" = None  # imported

    @property
    def is_imported(self) -> bool:
        return self.imported is not None

    @property
    def name(self) -> str:
        if self.imported is not None:
            return getattr(self.imported, "debug_name", None) or \
                self.imported.desc.name
        return self.desc.name if self.desc is not None else "?"

    def texture_desc(self) -> Optional[TextureDesc]:
        if isinstance(self.desc, TextureDesc):
            return self.desc
        if isinstance(self.imported, Texture):
            return self.imported.desc
        return None

    def buffer_desc(self) -> Optional[BufferDesc]:
        if isinstance(self.desc, BufferDesc):
            return self.desc
        if isinstance(self.imported, Buffer):
            return self.imported.desc
        return None
