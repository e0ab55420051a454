"""Static scene batching: N plain draws' geometry rides TWO imported buffers
(torch port of zenith_tpu/renderer/static_batch.py).

Every per-object buffer costs per-frame Python on the rebuild path (an
import, a node read and a structure-key entry each). Concatenating the
static geometry ONCE, on the device, collapses that to O(1) imports per
node; each draw slices its ``(voff, vcount, ioff, icount)`` range (a view,
no copy).

Indices stay UNREBASED: a draw pairs ``vb[voff:voff+vcount]`` with its
original index values, so it is identical to the per-object path.

The cache keys on the identity of every participating Buffer and holds
strong references to them (ids are only unique among live objects), so
replacing any object's vertex/index buffer rebuilds the concatenation on
the next frame.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from zenith_tpu_torch.rhi.resource import Buffer, BufferDesc, BufferUsage


class StaticGeometry:
    """Concatenated vertex/index buffers + per-draw ranges.

    ``ranges[k] = (voff, vcount, ioff, icount)`` for the k-th batched
    object (in the index order the cache was queried with).
    """

    __slots__ = ("vb", "ib", "ranges", "_ck")

    def __init__(self, vb: Buffer, ib: Buffer,
                 ranges: "Tuple[Tuple[int, int, int, int], ...]"):
        self.vb = vb
        self.ib = ib
        self.ranges = ranges
        # Capture-key protocol (rendergraph.graph._capture_key): the only
        # structure-shaping content is the range table; buffer CONTENTS ride
        # as imports, so they must not key the frame function.
        flat: List[int] = []
        for r in ranges:
            flat.extend(r)
        self._ck = ("cap-static-geo", vb.desc.shape[1], tuple(flat))

    def __zenith_capture_key__(self) -> tuple:
        return self._ck


class StaticGeometryCache:
    """Per-renderer memo: rebuilt only when the participating buffers
    change identity (object list edits, buffer swaps)."""

    __slots__ = ("_key", "_geo", "_refs")

    def __init__(self) -> None:
        self._key: Optional[tuple] = None
        self._geo: Optional[StaticGeometry] = None
        self._refs: list = []

    def get(self, objects, ixs: "List[int]") -> Optional[StaticGeometry]:
        """StaticGeometry for ``[objects[i] for i in ixs]``, or None when
        batching does not apply (fewer than 2 draws, or non-uniform
        vertex layouts)."""
        if len(ixs) < 2:
            return None
        key = tuple(
            (i, id(objects[i].vertex_buffer), id(objects[i].index_buffer))
            for i in ixs
        )
        if self._key == key:
            return self._geo
        vbs = [objects[i].vertex_buffer for i in ixs]
        ibs = [objects[i].index_buffer for i in ixs]
        stride = vbs[0].desc.shape[1]
        if any(
            len(vb.desc.shape) != 2 or vb.desc.shape[1] != stride
            or vb.desc.dtype != vbs[0].desc.dtype
            or ib.desc.dtype != ibs[0].desc.dtype
            for vb, ib in zip(vbs, ibs)
        ):
            return None  # mixed layouts: fall back to per-object buffers
        ranges: List[Tuple[int, int, int, int]] = []
        vo = io = 0
        for vb, ib in zip(vbs, ibs):
            vc, ic = vb.desc.shape[0], ib.desc.shape[0]
            ranges.append((vo, vc, io, ic))
            vo += vc
            io += ic
        mega_vb = Buffer(
            BufferDesc("scene.static.vb", (vo, stride), vbs[0].desc.dtype,
                       BufferUsage.VERTEX),
            torch.cat([b.array for b in vbs], dim=0),
        )
        mega_ib = Buffer(
            BufferDesc("scene.static.ib", (io,), ibs[0].desc.dtype,
                       BufferUsage.INDEX),
            torch.cat([b.array for b in ibs], dim=0),
        )
        geo = StaticGeometry(mega_vb, mega_ib, tuple(ranges))
        self._key = key
        self._geo = geo
        self._refs = vbs + ibs
        return geo
