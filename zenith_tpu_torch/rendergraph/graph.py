"""Render graph compile + execute (torch port of
zenith_tpu/rendergraph/graph.py): the node DAG becomes one frame function,
run eagerly.

Mirrors zenith-rendergraph/src/graph.rs:

- ``compile`` (graph.rs:87-191): materializes pipelines from the cache and
  looks up (or builds) the frame function. Resource state is a dict of
  tensors threaded through the nodes in declaration order; the stream
  orders the kernels, so no barriers are derived.
- Frame functions are cached on graph *structure* (node names, pipeline
  descs, access lists, resource descs, dynamics signature, closure
  captures), the same key the reference package compiles on. A structure
  hit reuses the frame function; per-frame values ride as device tensors
  (dynamics + imported resources). The frame function performs no host
  read, so a later change can capture it as a CUDA graph.
- ``execute`` (graph.rs:202-225): one run of the frame function, which
  enqueues the frame's kernels on the current stream and returns.
- ``present`` + ``RetiredRenderGraph`` (graph.rs:227-274, 656-674).

Stencil attachments ride the node context as an int32 plane: cleared or
loaded at the node's start, threaded through its stencil-tested draws,
stored at its end.

MSAA attachments (graph.py:1297-1460): a node whose pipeline has S > 1
samples works on (S, H, W, ...) planes. Clears and loads broadcast to S
samples; the store resolves colour by its mean over the samples and depth
and stencil by sample 0, which is what every consumer reads. The
per-sample planes are also kept for the frame (``msaa_state``, keyed by
(resource, mip, layer)), so a LOAD in a later node of the same sample count
continues per sample instead of re-broadcasting the resolve; a lambda or
single-sample write drops them.

Sub-resource views (graph.py:425-570, 833-860, 1163-1300; the reference's
per-subresource image views, texture.rs:536-559, and BufferRange,
buffer.rs:276-322): accesses declared with ``mip``/``layer``/``brange``
read and write one mip level, one array layer or one buffer range. A
mip-mapped managed texture materializes as a tuple of per-level tensors,
and a graphic node may render into one level or layer (the surface is
``width >> mip`` by ``height >> mip``). Writes splice functionally: a
layer or range write makes a new tensor, so a value read earlier in the
frame, or an export the caller still holds, never changes.

SPMD (graph.py:97-160, 1091-1535): ``CompileOptions(mesh=...)`` runs the
frame function once per shard of the mesh (``parallel.spmd.shard_map``,
one thread a shard) with every graph-managed attachment split into row
bands (sort-first parallel rendering): geometry is replicated and each
shard rasterizes its band through a shifted viewport. Imported resources
and dynamics are replicated and sliced to a band the first time a graphic
node touches them; a lambda's write stays banded when its value is
band-shaped. Cross-band reads are explicit: ``ctx.get_full`` gathers a
banded attachment, and passes that read across bands take the banded
branches of their nodes (``ctx.sharded``, ``ctx.num_shards``,
``ctx.shard_axis``). The frame's counters are summed over the shards; a
banded export comes back as a ``ShardedTensor`` and ``value`` returns it
whole, on the mesh's first device. Attachment heights must divide by the
mesh size × ``tile_h``, and render-to-mip or -layer is refused under a
mesh. ``parallel="sort_last"`` and ``"auto"`` shard the triangles of the
eligible graphic nodes instead (see ``CompileOptions``): each shard
rasterizes its contiguous slice at full resolution, and a binary-swap
depth composite at the node's end lands the result in the row-band layout.
"""

from __future__ import annotations

import enum
import types as _types
from collections import OrderedDict as _OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as _np
import torch

from zenith_tpu_torch.core import log, profile
from zenith_tpu_torch.ops import blend as blend_ops
from zenith_tpu_torch.ops.binning import TileGrid
from zenith_tpu_torch.ops.draw import (
    DEFAULT_BIN_CAPACITY,
    draw_indexed,
    draw_indexed_batch,
)
from zenith_tpu_torch.parallel import spmd
from zenith_tpu_torch.parallel.sharding import ORDER_BACKGROUND, composite_depth_planes
from zenith_tpu_torch.rendergraph.builder import GraphNode, RenderGraphBuilder
from zenith_tpu_torch.rendergraph.resource import (
    InitialResourceStorage,
    RenderGraphResource,
    RenderGraphResourceAccess,
)
from zenith_tpu_torch.rhi.device import RenderDevice
from zenith_tpu_torch.rhi.pipeline import GraphicPipeline, PipelineCache
from zenith_tpu_torch.rhi.resource import Buffer, Texture, TextureDesc
from zenith_tpu_torch.rhi.shader import Shader as _Shader
from zenith_tpu_torch.rhi.state import CompareOp, LoadOp, PolygonMode, PrimitiveTopology

logger = log.get(__name__)


def _import_value(res: "Buffer | Texture"):
    """What the frame function receives for an imported resource: a mipped
    texture arrives as the tuple of its levels (graph.py:189-193)."""
    if isinstance(res, Texture) and res.mips is not None:
        return tuple(res.mips)
    return res.array


def _validate_enabled() -> bool:
    """ZENITH_VALIDATE=1 turns on graph-level validation (static access
    checks at compile time plus NaN counting of every node's attachment
    writes, reported in FrameStatsOutput.nan_pixels)."""
    from zenith_tpu_torch.core import validate

    return validate.enabled()


def _validate_graph(resources, nodes, exports) -> None:
    """Static hazard checks (read-before-write, dead writes)."""
    written: set = set()
    read_ever: set = set()
    for node in nodes:
        for a in node.inputs:
            rid = a.resource_id
            read_ever.add(rid)
            if not resources[rid].is_imported and rid not in written:
                logger.warning(
                    "[validate] node '%s' reads managed resource #%d (%s) "
                    "before any node wrote it — it will be all zeros",
                    node.name, rid, resources[rid].name,
                )
        for a in node.outputs:
            written.add(a.resource_id)
    for rid in written:
        if (
            not resources[rid].is_imported
            and rid not in read_ever
            and rid not in exports
        ):
            logger.warning(
                "[validate] managed resource #%d (%s) is written but never "
                "read or exported — dead work", rid, resources[rid].name,
            )


@dataclass(frozen=True)
class CompileOptions:
    """Static rasterizer configuration (part of the frame-function key).

    ``mesh`` (a ``parallel.spmd.Mesh``, e.g. ``default_mesh(4,
    device="cuda:0")``) turns on SPMD rendering in row bands over
    ``mesh[shard_axis]`` (see the module docstring).

    ``parallel`` picks the work decomposition of GRAPHIC nodes under a
    mesh (graph.py:107-138). ``"sort_first"`` (default): row bands, no
    collective while rasterizing, but geometry that clusters in a few bands
    loads one shard with nearly all of it. ``"sort_last"``: eligible nodes
    shard their TRIANGLES contiguously over the mesh instead; every shard
    rasterizes its T/n slice at full resolution, then a binary-swap depth
    composite (``parallel.sharding.composite_depth_planes``) lands the
    result in the row-band layout, so the nodes downstream run exactly as
    in sort-first. A node is eligible when it has full-surface attachments,
    a depth attachment with test and write on and the GREATER compare, no
    stencil and no blended colour attachment; MSAA qualifies (the composite
    runs per sample plane). Blending and stencil are submission-order state
    machines that do not commute across triangle shards, so those nodes
    stay banded in the same frame. A per-pixel submission-order plane
    breaks equal-z ties across shards as sequential draws would (up to
    ties between records of one batched draw that land on different
    shards). The attachment height must divide by the mesh size.

    ``"auto"``: a choice per node at compile time. An eligible node takes
    sort-last when its ``band_hint`` (renderers project object AABBs to
    screen rows, ``GraphicNodeBuilder.set_band_hint``) shows the triangle
    load clustering into few bands: the fullest band's estimate is over
    ``AUTO_SL_IMBALANCE`` times the uniform share, with at least
    ``AUTO_SL_MIN_TRIS`` triangles. Nodes without a hint stay banded. The
    resolved choices enter the frame-function key, so a camera move that
    flips one switches between two cached frame functions."""

    tile_h: int = 32
    tile_w: int = 128
    bin_capacity: int = DEFAULT_BIN_CAPACITY
    mesh: Optional[Any] = None
    shard_axis: str = "rows"
    parallel: str = "sort_first"
    # Multiplies every draw's entry budget; the engine doubles it when a
    # frame reports bin overflow.
    budget_scale: int = 1


# parallel="auto" thresholds (graph.py:153-159): sort-last pays a
# binary-swap composite of O(H·W) per shard whatever the triangle count, so
# it only wins when sort-first's fullest band holds well over the uniform
# share of a large triangle load.
AUTO_SL_IMBALANCE = 2.0
AUTO_SL_MIN_TRIS = 65536

PARALLEL_MODES = ("sort_first", "sort_last", "auto")


def _auto_prefers_sort_last(hint, n_shards: int) -> bool:
    """The band-occupancy test of CompileOptions(parallel="auto")
    (graph.py:162-186): spread each draw's triangles evenly over the bands
    its screen-row extent covers and prefer sort-last when the fullest band
    exceeds AUTO_SL_IMBALANCE times the uniform share."""
    if not hint or n_shards <= 1:
        return False
    total = sum(t for t, _, _ in hint)
    if total < AUTO_SL_MIN_TRIS:
        return False
    bands = [0.0] * n_shards
    for t, y0, y1 in hint:
        y0 = min(max(float(y0), 0.0), 1.0)
        y1 = min(max(float(y1), 0.0), 1.0)
        if y1 <= y0:
            y1 = min(1.0, y0 + 1e-6)
        for b in range(n_shards):
            b0, b1 = b / n_shards, (b + 1) / n_shards
            ov = min(y1, b1) - max(y0, b0)
            if ov > 0:
                bands[b] += t * ov / (y1 - y0)
    return max(bands) > AUTO_SL_IMBALANCE * (total / n_shards)


def _desc_key(desc):
    # Deliberately name-free: swapchain ring slots ("swapchain.0/1/2")
    # must share one frame function.
    if isinstance(desc, TextureDesc):
        return ("tex", desc.width, desc.height, desc.format, desc.usage,
                desc.mip_levels, desc.array_layers, desc.depth)
    return ("buf", desc.shape, desc.dtype, desc.usage)


_SCALAR_TYPES = (int, float, str, bool, bytes, type(None))


class _HKey:
    """Hash-once wrapper for the frame-function cache key (graph.rs
    structure key): the nested tuple is hashed once, equality still
    compares the full tuples."""

    __slots__ = ("t", "h")

    def __init__(self, t: tuple):
        self.t = t
        self.h = hash(t)

    def __hash__(self) -> int:
        return self.h

    def __eq__(self, other) -> bool:
        return self is other or (
            isinstance(other, _HKey) and self.h == other.h and self.t == other.t
        )


def _dynamic_tensor(v) -> torch.Tensor:
    """A dynamic's value as a tensor; values without a dtype become float32,
    as ``builder.set_dynamic`` makes them."""
    if isinstance(v, torch.Tensor):
        return v
    if not hasattr(v, "dtype"):
        v = _np.asarray(v, dtype=_np.float32)
    return torch.from_numpy(_np.array(v))


def _dynamic_signature(dyn: Dict[str, Any]) -> tuple:
    """(name, shape, dtype) of each dynamic, host or device value alike —
    part of the structure key, and what a retained execute must keep."""
    out = []
    for name in sorted(dyn):
        t = _dynamic_tensor(dyn[name])
        out.append((name, tuple(t.shape), t.dtype))
    return tuple(out)


def _dynamics_to_device(dyn: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """Per-frame values as device tensors: one small asynchronous copy per
    host value, from pinned memory (a copy from pageable memory would make
    the host wait for the card); device tensors pass through."""
    out = {}
    for name, v in dyn.items():
        t = _dynamic_tensor(v)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[name] = t.to(device)
    return out


def _capture_key(v, depth: int = 0, memo: "Optional[dict]" = None):
    """Key a closure capture by CONTENT (recursively, capped) as a hashable
    tuple (graph.py:276-421). Captured values shape what the frame function
    does, so two closures with equal code but different captures must key
    different frame functions. Device tensors key by shape/dtype only —
    content-hashing them would read the device every frame; route per-frame
    tensor values through set_dynamic or import instead."""
    if isinstance(v, _SCALAR_TYPES):
        return v
    if memo is not None:
        mk = (id(v), depth)
        hit = memo.get(mk)
        if hit is not None:
            return hit
    out = _capture_key_uncached(v, depth, memo)
    if memo is not None:
        memo[mk] = out
    return out


def _capture_key_uncached(v, depth: int, memo: "Optional[dict]"):
    if depth > 4:
        return ("cap-deep", type(v).__name__)
    zck = getattr(type(v), "__zenith_capture_key__", None)
    if zck is not None:
        return zck(v)
    if isinstance(v, _np.ndarray):
        if v.size <= 256:
            return ("cap-np", v.shape, str(v.dtype),
                    _np.ascontiguousarray(v).tobytes())
        if _validate_enabled():
            logger.warning(
                "[validate] closure captures a %s %s np array — keyed by "
                "SHAPE ONLY. If its contents vary per frame, the frame-"
                "function cache will serve stale values; use "
                "builder.set_dynamic or import_resource instead.",
                v.shape, v.dtype,
            )
        return ("cap-np-big", v.shape, str(v.dtype))
    if isinstance(v, _Shader):
        return ("cap-shader", id(v))
    if isinstance(v, (Buffer, Texture)):
        return ("cap-rhires", _desc_key(v.desc))
    if isinstance(v, (RenderDevice, PipelineCache)):
        return ("cap-runtime", type(v).__name__)
    if isinstance(v, (RenderGraphResource, RenderGraphResourceAccess)):
        return ("cap-handle", v.id if hasattr(v, "id") else v.resource_id)
    if isinstance(v, torch.Tensor):
        if _validate_enabled():
            logger.warning(
                "[validate] closure captures a %s %s device tensor — keyed "
                "by SHAPE ONLY. If its contents vary per frame, use "
                "builder.set_dynamic or import_resource instead.",
                tuple(v.shape), v.dtype,
            )
        return ("cap-array", tuple(v.shape), str(v.dtype))
    if isinstance(v, (list, tuple)):
        return (
            "cap-seq", type(v).__name__, len(v),
            tuple(_capture_key(item, depth + 1, memo) for item in v[:64]),
        )
    if isinstance(v, (set, frozenset)):
        return (
            "cap-set", len(v),
            tuple(_capture_key(item, depth + 1, memo)
                  for item in sorted(v, key=repr)[:64]),
        )
    if isinstance(v, dict):
        try:
            ks = sorted(v)
        except TypeError:
            ks = sorted(v, key=repr)
        return (
            "cap-dict", len(v),
            tuple((k if isinstance(k, _SCALAR_TYPES) else repr(k),
                   _capture_key(v[k], depth + 1, memo))
                  for k in ks[:64]),
        )
    if isinstance(v, _types.ModuleType):
        return ("cap-module", v.__name__)
    if isinstance(v, enum.Enum):
        return ("cap-enum", type(v).__qualname__, v.name)
    try:
        hash(v)
        if getattr(v, "__dataclass_fields__", None) is not None:
            return v
    except TypeError:
        pass
    if callable(v) and isinstance(getattr(v, "__code__", None), _types.CodeType):
        code = v.__code__
        cl = getattr(v, "__closure__", None)
        cells = []
        for cell in (cl if isinstance(cl, tuple) else ()):
            try:
                cells.append(_capture_key(cell.cell_contents, depth + 1, memo))
            except ValueError:
                cells.append("<empty-cell>")
        return ("cap-fn", code.co_filename, code.co_firstlineno, code.co_code,
                tuple(cells))
    d = getattr(v, "__dict__", None)
    fields = ()
    if d and len(d) <= 64:
        fields = tuple(
            (k, _capture_key(d[k], depth + 1, memo)) for k in sorted(d)
        )
    return ("cap-obj", type(v).__qualname__, fields)


def _mip_splice(cur: tuple, mip: int, arr) -> tuple:
    """One level of a mip-chain tuple replaced (graph.py:425-428; shared by
    lambda ``ctx.set`` and the graphic-node attachment store)."""
    return cur[:mip] + (arr,) + cur[mip + 1:]


def _layer_splice(cur: torch.Tensor, layer: int, arr: torch.Tensor) -> torch.Tensor:
    """``cur`` with one array layer replaced, as a new tensor (graph.py:
    431-436, the reference's functional ``.at[layer].set``): (H, W) depth
    planes expand to the stored (L, H, W, 1) channel layout."""
    if cur.ndim == arr.ndim + 2:
        arr = arr[..., None]
    out = cur.clone()
    out[layer] = arr
    return out


def _view(val, mip, layer, brange):
    """The sub-resource view of a resource's value (graph.py:533-545)."""
    if mip is not None:
        if not isinstance(val, tuple):
            raise ValueError(f"the resource has no mip chain (read with mip={mip})")
        lvl = val[mip]
        return lvl if layer is None else lvl[layer]
    if layer is not None:
        return val[layer]
    if brange is not None:
        off, size = brange
        return val[off:off + size]
    return val


class _NodeContextBase:
    def __init__(self, graph: "RenderGraph", node: GraphNode,
                 state: Dict[int, Any], dynamics: Dict[str, Any],
                 device: torch.device, shard_ctx=None):
        self._graph = graph
        self._node = node
        self._state = state
        self._dynamics = dynamics
        self.device = device
        # (axis name, shard count, banded resource ids) under an SPMD mesh.
        self._shard_ctx = shard_ctx

    @property
    def sharded(self) -> bool:
        """True when running inside an SPMD mesh (CompileOptions.mesh)."""
        return self._shard_ctx is not None

    @property
    def shard_axis(self) -> Optional[str]:
        """Mesh axis name of the row bands (None when not sharded)."""
        return self._shard_ctx[0] if self._shard_ctx is not None else None

    @property
    def num_shards(self) -> int:
        """Shards along the row-band axis (1 when not sharded)."""
        return self._shard_ctx[1] if self._shard_ctx is not None else 1

    def dynamic(self, name: str):
        """Read a per-frame value declared with builder.set_dynamic."""
        if name not in self._dynamics:
            raise KeyError(
                f"dynamic '{name}' not declared; call builder.set_dynamic first "
                f"(declared: {sorted(self._dynamics)})"
            )
        return self._dynamics[name]

    def get(self, access: RenderGraphResourceAccess):
        """Current value of a resource (a tensor, or the tuple of levels of
        a mip-mapped texture); an access declared with ``mip``/``layer``/
        ``brange`` resolves to that sub-resource view (graph.py:527-545)."""
        rid = access.id
        val = self._state.get(rid)
        if val is None:
            val = self._graph._materialize_default(rid, self.device)
            self._state[rid] = val
        return _view(val, access.mip, access.layer, access.brange)

    def get_full(self, access: RenderGraphResourceAccess):
        """Full (all-rows) value of a resource (graph.py:481-495): ``get`` on
        one device; under a mesh a banded attachment is all_gathered. For
        cross-band reads (a pass sampling the banded shadow map), never for
        row-local band math."""
        val = self.get(access)
        if self._shard_ctx is None:
            return val
        axis, _n, banded = self._shard_ctx
        if access.id in banded:
            return spmd.all_gather(val, axis, axis=0, tiled=True)
        return val


class LambdaNodeExecutionContext(_NodeContextBase):
    """(graph.rs:635-654) Arbitrary tensor compute over declared resources."""

    def __init__(self, graph: "RenderGraph", node: GraphNode, state: Dict[int, Any],
                 dynamics: Dict[str, Any], device: torch.device, overflow: torch.Tensor,
                 shard_ctx=None):
        super().__init__(graph, node, state, dynamics, device, shard_ctx)
        self._overflow = overflow

    def frame_overflow(self) -> torch.Tensor:
        """The frame's running bin-overflow count at this node (graph.py:
        452-463): the int32 device counter of the draws declared before it,
        never read back to the host. Under a mesh it is summed over the
        bands, so every shard sees the same total."""
        if self._shard_ctx is not None:
            return spmd.psum(self._overflow, self._shard_ctx[0])
        return self._overflow

    def set(self, access: RenderGraphResourceAccess, value) -> None:
        rid = access.id
        if not any(a.resource_id == rid for a in self._node.outputs):
            raise ValueError(
                f"node '{self._node.name}' writes resource #{rid} without "
                f"declaring write()"
            )
        if access.mip is None and access.layer is None and access.brange is None:
            self._state[rid] = value
        else:
            self._graph._store(self._state, rid, access.mip, access.layer, access.brange,
                               value, self.device)


class GraphicNodeExecutionContext(_NodeContextBase):
    """(graph.rs:509-633) Draw recording over the node's attachments."""

    def __init__(self, graph, node, state, dynamics, device,
                 pipeline: GraphicPipeline, grid: TileGrid,
                 colors: List[Any], depth: Optional[Any],
                 bin_capacity: int, stencil: Optional[Any] = None,
                 budget_scale: int = 1, viewport: Optional[tuple] = None,
                 shard_ctx=None, sort_last: bool = False):
        super().__init__(graph, node, state, dynamics, device, shard_ctx)
        self._budget_scale = budget_scale
        # (x0, y0, full_w, full_h): the band's place in the full surface.
        self._viewport = viewport
        self.pipeline = pipeline
        self.grid = grid
        self._colors = colors
        self._depth = depth
        self._stencil = stencil
        self._bindings: Dict[str, Any] = {}
        self._bin_capacity = bin_capacity
        self.stats: List[Any] = []
        # Sort-last triangle sharding (graph.py:588-592): whether this
        # node's draws shard their triangles over the mesh axis, the
        # per-pixel submission-order plane and the next draw's sequence
        # number.
        self._sort_last = sort_last
        self._order: Optional[torch.Tensor] = None
        self._draw_seq = 0

    def _shard_ib(self, ib):
        """This shard's contiguous slice of a TRIANGLE_LIST index buffer
        (graph.py:594-621): ceil(T/n) triangles from ``rank * per``, a short
        tail padded with copies of the first triple. A re-drawn triangle
        fails the strict GREATER test everywhere, and a duplicate on another
        shard composites to the same values. Other topologies and non-FILL
        polygon modes draw replicated: the composite resolves identical
        fragments to rank 0, so they stay right, only not faster."""
        st = self.pipeline.desc.state
        if (st.input_assembly.topology != PrimitiveTopology.TRIANGLE_LIST
                or st.rasterization.polygon_mode != PolygonMode.FILL):
            return ib
        axis, n = self._shard_ctx[0], self._shard_ctx[1]
        tri = ib.reshape(-1, 3)
        t = tri.shape[0]
        per = -(-t // n)
        pad = per * n - t
        if pad:
            tri = torch.cat([tri, tri[:1].expand(pad, 3)], dim=0)
        # The rank and the offset are host integers: slicing takes no read.
        start = spmd.axis_index(axis) * per
        return tri[start:start + per]

    def _stamp_order(self, z_before: torch.Tensor) -> None:
        """Record the pixels this draw won (graph.py:623-640): its depth
        changed, as under strict GREATER a later equal-z fragment never
        writes. The sort-last composite breaks cross-shard equal-z ties by
        this plane, in submission order. ``z_before`` stays what it was:
        every draw path returns a new depth tensor (the raster pads a copy
        of its seed, MSAA stacks new planes)."""
        if self._order is None:
            # The depth plane's shape: (H, W), or (S, H, W) under MSAA.
            self._order = torch.full(z_before.shape, ORDER_BACKGROUND, dtype=torch.int32,
                                     device=z_before.device)
        self._order = self._order.masked_fill(self._depth != z_before, self._draw_seq)
        self._draw_seq += 1

    def _composite(self) -> None:
        """The sort-last node's end (graph.py:1390-1425): merge the shards'
        full-resolution planes by depth, ties by submission order, into
        the row-band layout the nodes downstream read. Every shard reaches
        every collective, whether or not it drew: a node that recorded no
        draw composites with an order plane of ORDER_BACKGROUND. Under MSAA
        each sample plane composites on its own, in the same order on every
        shard, into banded (S, band_h, W, ...) planes."""
        axis = self._shard_ctx[0]
        samples = self.pipeline.desc.state.multisample.samples
        order = self._order
        if order is None:
            order = torch.full(self._depth.shape, ORDER_BACKGROUND, dtype=torch.int32,
                               device=self._depth.device)
        if samples == 1:
            planes, self._depth, _ = composite_depth_planes(
                list(self._colors), self._depth, order, axis, band_output=True)
            self._colors = planes
            return
        per_sample = [composite_depth_planes([c[s] for c in self._colors], self._depth[s],
                                             order[s], axis, band_output=True)
                      for s in range(samples)]
        self._colors = [torch.stack([p[0][i] for p in per_sample])
                        for i in range(len(self._colors))]
        self._depth = torch.stack([p[1] for p in per_sample])

    @property
    def extent(self) -> "Tuple[int, int]":
        return (self.grid.width, self.grid.height)

    def bind(self, name: str, value) -> None:
        """Name-based resource binding for the next draw (the
        DescriptorSetBinder analog, descriptor.rs:298-456)."""
        self._bindings[name] = value

    def bind_resource(self, name: str, access: RenderGraphResourceAccess) -> None:
        self.bind(name, self.get(access))

    def push_constants(self, value) -> None:
        """Write the pipeline's push-constant slot for subsequent draws,
        enforcing Vulkan's guaranteed 128 bytes (graph.py:655-695)."""
        from zenith_tpu_torch.rhi.shader import (
            BindingError,
            BindingKind,
            PUSH_CONSTANT_LIMIT_BYTES,
        )

        slots = [
            b for b in self.pipeline.reflection.bindings
            if b.kind == BindingKind.PUSH_CONSTANT
        ]
        pname = self.pipeline.desc.shader_input.fragment_shader.name
        if not slots:
            raise BindingError(
                f"pipeline '{pname}' declares no push_constant binding; "
                f"declare one with shader bindings=[push_constant(name)]"
            )
        if len(slots) > 1:
            raise BindingError(
                f"pipeline '{pname}' declares {len(slots)} push_constant "
                f"bindings; Vulkan layouts carry one range (pipeline.rs:111-131)"
            )
        elems = value.numel() if isinstance(value, torch.Tensor) else _np.asarray(value).size
        size = int(elems) * 4
        if size > PUSH_CONSTANT_LIMIT_BYTES:
            raise BindingError(
                f"push constants are {size} bytes; Vulkan guarantees only "
                f"{PUSH_CONSTANT_LIMIT_BYTES} (use a uniform buffer instead)"
            )
        self.bind(slots[0].name, value)

    def draw_indexed(
        self,
        vertex_buffer: "RenderGraphResourceAccess | Any",
        index_buffer: "RenderGraphResourceAccess | Any",
        resources: "Optional[Dict[str, Any]]" = None,
        bin_capacity: Optional[int] = None,
        entry_budget: Optional[int] = None,
        instance_count: int = 1,
        instance_data: "Optional[Dict[str, Any]]" = None,
    ) -> None:
        """Record one indexed draw (the cmd_draw_indexed analog,
        triangle.rs:173)."""
        vb = (
            self.get(vertex_buffer)
            if isinstance(vertex_buffer, RenderGraphResourceAccess)
            else vertex_buffer
        )
        ib = (
            self.get(index_buffer)
            if isinstance(index_buffer, RenderGraphResourceAccess)
            else index_buffer
        )
        merged = dict(self._bindings)
        if resources:
            merged.update(resources)
        z_before = self._depth
        if self._sort_last:
            ib = self._shard_ib(ib)
        self._colors, self._depth, stats = draw_indexed(
            self._colors,
            self._depth,
            self.pipeline,
            vb,
            ib,
            merged,
            self.grid,
            bin_capacity=bin_capacity or self._bin_capacity,
            viewport=self._viewport,
            entry_budget=entry_budget,
            stencil=self._stencil,
            instance_count=instance_count,
            instance_data=instance_data,
            budget_scale=self._budget_scale,
        )
        if self._sort_last:
            self._stamp_order(z_before)
        self.stats.append(stats.bin_overflow)
        if stats.stencil is not None:
            self._stencil = stats.stencil

    def draw_indexed_batch(
        self,
        draws: "List[tuple]",  # (vb access/tensor, ib access/tensor, resources[, inst])
        per_draw_uniforms: "Tuple[str, ...] | list" = (),
        entry_budget: Optional[int] = None,
        peel_layers: Optional[int] = None,
    ) -> None:
        """Record N draws as ONE binning + raster + shade pass
        (graph.py:747-808). Per-draw fragment uniforms named in
        ``per_draw_uniforms`` reach the fragment shader as dense (H, W, C)
        planes; ``peel_layers=K`` selects depth-peeled translucency for a
        blending pipeline; see ops.draw.draw_indexed_batch."""
        resolved = []
        for draw in draws:
            vb, ib, res = draw[0], draw[1], draw[2]
            vb_v = self.get(vb) if isinstance(vb, RenderGraphResourceAccess) else vb
            ib_v = self.get(ib) if isinstance(ib, RenderGraphResourceAccess) else ib
            merged = dict(self._bindings)
            if res:
                merged.update(res)
            if self._sort_last:
                ib_v = self._shard_ib(ib_v)
            if len(draw) > 3 and draw[3]:
                resolved.append((vb_v, ib_v, merged, draw[3]))
            else:
                resolved.append((vb_v, ib_v, merged))
        z_before = self._depth
        self._colors, self._depth, stats = draw_indexed_batch(
            self._colors,
            self._depth,
            self.pipeline,
            resolved,
            self.grid,
            per_draw_uniforms=tuple(per_draw_uniforms),
            viewport=self._viewport,
            entry_budget=entry_budget,
            stencil=self._stencil,
            budget_scale=self._budget_scale,
            peel_layers=peel_layers,
        )
        if self._sort_last:
            # One stamp a batch: the kernel orders records within a shard;
            # equal-z ties across shards within one batch resolve by rank.
            self._stamp_order(z_before)
        self.stats.append(stats.bin_overflow)
        if stats.stencil is not None:
            self._stencil = stats.stencil


@dataclass
class FrameStatsOutput:
    """Device-side per-frame counters returned beside the frame outputs."""

    bin_overflow: Any = 0
    nan_pixels: Any = 0  # populated only under ZENITH_VALIDATE=1


class RenderGraph:
    """(graph.rs:81-200)"""

    def __init__(self, builder: RenderGraphBuilder):
        self.resources: List[InitialResourceStorage] = builder.resources
        self.nodes: List[GraphNode] = builder.nodes
        self.exports: List[int] = builder.exports
        self.dynamics: Dict[str, Any] = builder.dynamics
        self._pipelines: Dict[int, GraphicPipeline] = {}

    # -- helpers --------------------------------------------------------------

    def _materialize_default(self, rid: int, device: torch.device):
        """Managed resource first touched: zero contents. A mip-mapped
        texture materializes as a tuple of per-level tensors, as imported
        mip textures arrive (graph.py:833-860): 3D levels halve every
        extent, array layers never shrink."""
        desc = self.resources[rid].desc
        if desc is None:
            raise ValueError(f"imported resource #{rid} has no value")
        if isinstance(desc, TextureDesc) and desc.mip_levels > 1:
            c = desc.format.channels
            dtype = desc.format.compute_dtype

            def level_shape(k):
                hw = (max(1, desc.height >> k), max(1, desc.width >> k), c)
                if desc.depth > 1:
                    return (max(1, desc.depth >> k),) + hw
                if desc.array_layers > 1:
                    return (desc.array_layers,) + hw
                return hw

            return tuple(torch.zeros(level_shape(k), dtype=dtype, device=device)
                         for k in range(desc.mip_levels))
        sds = desc.shape_dtype()
        return torch.zeros(sds.shape, dtype=sds.dtype, device=device)

    def _store(self, state, rid: int, mip, layer, brange, value, device) -> None:
        """Write ``value`` into one sub-resource of resource ``rid`` (the
        splices of graph.py:533-570 and 1229-1251, shared by lambda
        ``ctx.set`` and the graphic-node attachment store)."""
        cur = state.get(rid)
        tex = self.resources[rid].texture_desc()
        if isinstance(cur, tuple) or (tex is not None and tex.mip_levels > 1):
            if not isinstance(cur, tuple):
                cur = self._materialize_default(rid, device)
            mip = mip or 0
            if layer is not None:
                value = _layer_splice(cur[mip], layer, value)
            state[rid] = _mip_splice(cur, mip, value)
            return
        if mip:
            raise ValueError(f"resource #{rid} has no mip chain (write with mip={mip})")
        if cur is None and (layer is not None or brange is not None):
            cur = self._materialize_default(rid, device)
        if layer is not None:
            state[rid] = _layer_splice(cur, layer, value)
        elif brange is not None:
            off, size = brange
            out = cur.clone()
            out[off:off + size] = value
            state[rid] = out
        else:
            state[rid] = value

    def _written_imports(self) -> List[int]:
        out = []
        for node in self.nodes:
            for a in node.outputs:
                if self.resources[a.resource_id].is_imported and a.resource_id not in out:
                    out.append(a.resource_id)
        return out

    def _structure_key(self, options: CompileOptions, dyn_sig: tuple, device: torch.device,
                       extra: tuple = ()):
        """The frame-function cache key as a nested hashable tuple (same
        contents as the reference's key, graph.py:868-935, plus the device
        and the dynamics' (name, shape, dtype) signature). ``extra`` carries
        the resolved ``auto`` choices."""
        parts = [options, _validate_enabled(), str(device), extra]
        add = parts.append
        memo: dict = {}

        for rid, st in enumerate(self.resources):
            if st.is_imported:
                desc = st.imported.desc
                mips = (
                    len(st.imported.mips)
                    if isinstance(st.imported, Texture)
                    and st.imported.mips is not None
                    else 0
                )
                add(("import", rid, _desc_key(desc), mips))
            else:
                add(("managed", rid, _desc_key(st.desc)))
        for node in self.nodes:
            add((node.index, node.kind, node.name))
            add(tuple((a.resource_id, a.view, a.mip, a.layer, a.brange)
                      for a in node.inputs))
            add(tuple((a.resource_id, a.view, a.mip, a.layer, a.brange)
                      for a in node.outputs))
            add(tuple(node.color_attachments))
            add(node.depth_attachment)
            add(node.stencil_attachment)
            if node.pipeline_desc is not None:
                add(node.pipeline_desc)
            if node.job is not None:
                code = node.job.__code__
                add((code.co_filename, code.co_firstlineno, code.co_code))
                for cell in node.job.__closure__ or ():
                    try:
                        v = cell.cell_contents
                    except ValueError:
                        add("<empty-cell>")
                        continue
                    add(_capture_key(v, memo=memo))
        add(dyn_sig)
        add(tuple(sorted(self.exports)))
        return tuple(parts)

    def _deep_capture_fingerprint(self) -> tuple:
        """Validate-mode self-check (graph.py:937-961): content fingerprints
        of the big host numpy arrays captured by node closures, the one
        capture the structure key keys by shape alone. Device tensors stay
        shape-keyed even here: reading them back would make the host wait
        for the card. Run on a cadence, not per frame."""
        from zenith_tpu_torch.core.collections import default_hasher

        fps = []
        for node in self.nodes:
            if node.job is None:
                continue
            for cell in node.job.__closure__ or ():
                try:
                    v = cell.cell_contents
                except ValueError:
                    continue
                if isinstance(v, _np.ndarray) and v.size > 256:
                    fps.append((node.index, v.shape,
                                default_hasher(_np.ascontiguousarray(v).tobytes())))
        return tuple(fps)

    def _capture_self_check(self, key: "_HKey") -> None:
        """Every 64th cache hit under ZENITH_VALIDATE=1 (graph.py:1010-1034):
        warn when a big captured numpy array changed content while the
        cached frame function, which closes over the first graph's
        captures, kept being served."""
        global _SELFCHECK_TICK
        _SELFCHECK_TICK += 1
        if _SELFCHECK_TICK % 64:
            return
        deep = self._deep_capture_fingerprint()
        prev = _DEEP_FP_CACHE.get(key)
        if prev is None:
            if len(_DEEP_FP_CACHE) > 256:
                _DEEP_FP_CACHE.clear()
        elif prev != deep:
            logger.warning(
                "[validate] capture self-check: a closure-captured big np array "
                "CHANGED CONTENT while the frame-function cache served the same "
                "function, which still closes over the old values. Route "
                "per-frame arrays through builder.set_dynamic or import_resource."
            )
        _DEEP_FP_CACHE[key] = deep

    # -- compile ---------------------------------------------------------------

    def compile(
        self,
        device: RenderDevice,
        pipeline_cache: PipelineCache,
        options: CompileOptions = CompileOptions(),
    ) -> "CompiledRenderGraph":
        if options.parallel not in PARALLEL_MODES:
            raise ValueError(f"parallel={options.parallel!r}: expected one of {PARALLEL_MODES}")
        active_nodes: List[GraphNode] = []
        for node in self.nodes:
            if not node.is_complete:
                logger.warning("skipping incomplete node '%s'", node.name)
                continue
            if node.kind == "graphic":
                self._pipelines[node.index] = pipeline_cache.get_or_create(
                    node.pipeline_desc
                )
            active_nodes.append(node)

        if _validate_enabled():
            _validate_graph(self.resources, active_nodes, set(self.exports))

        dev = device.device
        dyn_sig = _dynamic_signature(self.dynamics)
        # parallel="auto" (graph.py:985-1005): each graphic node's choice,
        # from its band hint evaluated now, enters the key, so a cached
        # frame function always matches its choices. Without a mesh the
        # hints are never read.
        auto_pref: Dict[int, bool] = {}
        auto_key: tuple = ()
        if options.mesh is not None and options.parallel == "auto":
            n_sh = options.mesh.shape[options.shard_axis]
            auto_pref = {
                node.index: _auto_prefers_sort_last(
                    node.band_hint() if callable(node.band_hint) else node.band_hint, n_sh)
                for node in active_nodes if node.kind == "graphic"
            }
            auto_key = ("auto_sl",) + tuple(sorted(auto_pref.items()))
        sort_last = {node.index for node in active_nodes
                     if self._takes_sort_last(node, options, auto_pref)}
        # Each graphic node's decomposition (graph.py:1087, 1223-1226).
        self.parallel_modes: Dict[str, str] = {} if options.mesh is None else {
            node.name: "sort_last" if node.index in sort_last else "sort_first"
            for node in active_nodes if node.kind == "graphic"
        }
        key = _HKey(self._structure_key(options, dyn_sig, dev, extra=auto_key))
        cached = _FRAME_PROGRAM_CACHE.get(key)
        global _MISS_STREAK
        if cached is not None:
            _FRAME_PROGRAM_CACHE.move_to_end(key)
            _MISS_STREAK = 0
            if _validate_enabled():
                self._capture_self_check(key)
        else:
            cached = self._build_frame_fn(active_nodes, options, dev, sort_last)
            _FRAME_PROGRAM_CACHE[key] = cached
            if len(_FRAME_PROGRAM_CACHE) > _FRAME_PROGRAM_CACHE_MAX:
                _FRAME_PROGRAM_CACHE.popitem(last=False)
            logger.debug("frame-function cache miss (%d cached)", len(_FRAME_PROGRAM_CACHE))
            _MISS_STREAK += 1
            if _MISS_STREAK == _MISS_STREAK_WARN_AT:
                logger.warning(
                    "%d consecutive frame-function cache misses. Usual cause: "
                    "constructing Shader/GraphicShaderInput objects inside "
                    "the frame loop (shaders hash by identity; build them "
                    "once in prepare()), or captures that change every frame "
                    "(move per-frame values to builder.set_dynamic).",
                    _MISS_STREAK,
                )

        imports = {
            str(rid): _import_value(st.imported)
            for rid, st in enumerate(self.resources)
            if st.is_imported
        }
        dynamics = _dynamics_to_device(self.dynamics, dev)
        return CompiledRenderGraph(self, cached, imports, dynamics, key, dyn_sig, dev)

    def _takes_sort_last(self, node: GraphNode, options: CompileOptions,
                         auto_pref: Dict[int, bool]) -> bool:
        """Whether a graphic node shards its triangles (graph.py:1195-1240):
        asked for by ``parallel`` (or by its ``auto`` choice), and opaque
        over a full-surface depth attachment written under GREATER with no
        stencil."""
        if options.mesh is None or node.kind != "graphic":
            return False
        if not (options.parallel == "sort_last"
                or (options.parallel == "auto" and auto_pref.get(node.index, False))):
            return False
        ds = self._pipelines[node.index].desc.state.depth_stencil
        return (not _subresource_target(node)
                and node.stencil_attachment is None
                and node.depth_attachment is not None
                and ds.depth_test_enable
                and ds.depth_write_enable
                and ds.depth_compare_op == CompareOp.GREATER
                and not any(cd.blend_enable for _, cd, _, _ in node.color_attachments))

    def _build_frame_fn(self, active_nodes: List[GraphNode], options: CompileOptions,
                        device: torch.device, sort_last: "frozenset | set" = frozenset()):
        resources = self.resources
        pipelines = self._pipelines
        output_ids = list(dict.fromkeys(self._written_imports() + self.exports))
        mesh = options.mesh
        axis = options.shard_axis

        def walk(imports: Dict[str, Any], dynamics: Dict[str, torch.Tensor],
                 device: torch.device, shard_ctx):
            """Run every node in declaration order; no host reads. Under a
            mesh this is one shard's run: graph-managed attachments live as
            row bands, and ``shard_ctx``'s banded set lets ctx.get_full
            gather on demand."""
            state: Dict[int, Any] = {}
            # (rid, mip, layer) -> (samples, (S, ...) planes) of the last
            # MSAA node that stored that sub-surface.
            msaa_state: Dict[tuple, Tuple[int, torch.Tensor]] = {}
            for rid, st in enumerate(resources):
                if st.is_imported:
                    state[rid] = imports[str(rid)]
            overflow = nan_pixels = torch.zeros((), dtype=torch.int32, device=device)
            validate = _validate_enabled()

            for node in active_nodes:
                with profile.scope(node.name):
                    overflow, nan_pixels = self._run_node(
                        node, state, msaa_state, dynamics, device, pipelines, options,
                        resources, overflow, nan_pixels, validate, shard_ctx,
                        node.index in sort_last,
                    )

            outputs = {str(rid): state[rid] for rid in output_ids if rid in state}
            return outputs, FrameStatsOutput(bin_overflow=overflow, nan_pixels=nan_pixels)

        if mesh is None:
            def frame_fn(imports: Dict[str, Any], dynamics: Dict[str, torch.Tensor]):
                return walk(imports, dynamics, device, None)

            return frame_fn

        n_shards = mesh.shape[axis]

        def shard_body(imports, dynamics):
            banded: set = set()
            outputs, stats = walk(imports, dynamics, spmd.current_device(),
                                  (axis, n_shards, banded))
            return outputs, FrameStatsOutput(
                bin_overflow=spmd.psum(stats.bin_overflow, axis),
                nan_pixels=spmd.psum(stats.nan_pixels, axis),
            ), banded

        run = spmd.shard_map(shard_body, mesh, in_specs=(spmd.P(), spmd.P()), out_specs=None)

        def frame_fn(imports: Dict[str, Any], dynamics: Dict[str, torch.Tensor]):
            """The walk once per shard. Banded outputs come back as their
            bands (``ShardedTensor``); everything else (buffers, replicated
            values) as shard 0's copy, and the counters summed."""
            results = run(imports, dynamics)
            outputs0, stats, banded = results[0]
            outputs = {
                key: spmd.ShardedTensor([r[0][key] for r in results])
                if int(key) in banded else val
                for key, val in outputs0.items()
            }
            return outputs, stats

        return frame_fn

    def _run_node(self, node, state, msaa_state, dynamics, device, pipelines, options,
                  resources, overflow, nan_pixels, validate, shard_ctx=None,
                  node_sl: bool = False):
        """Run one node of the frame function; returns the running
        (overflow, nan_pixels) counters. ``node_sl``: a sort-last node,
        which rasterizes its triangle shard at full resolution and
        composites into row bands at its end."""
        n_shards = shard_ctx[1] if shard_ctx is not None else 1
        banded = shard_ctx[2] if shard_ctx is not None else ()
        if node.kind == "lambda":
            ctx = LambdaNodeExecutionContext(self, node, state, dynamics, device, overflow,
                                             shard_ctx)
            node.job(ctx)
            # A lambda write replaces the resolved surface: per-sample planes
            # of any sub-surface of the resource must not shadow it.
            for a in node.outputs:
                for k in [k for k in msaa_state if k[0] == a.resource_id]:
                    del msaa_state[k]
            if shard_ctx is not None:
                # Lambda writes stay banded when the value is band-shaped
                # (the row-local contract, graph.py:1149-1160).
                for a in node.outputs:
                    desc = resources[a.resource_id].texture_desc()
                    v = state.get(a.resource_id)
                    if desc is None or not isinstance(v, torch.Tensor):
                        continue
                    if v.shape[0] * n_shards == desc.height:
                        banded.add(a.resource_id)
                    else:
                        banded.discard(a.resource_id)
            return overflow, nan_pixels
        pipeline = pipelines[node.index]
        samples = pipeline.desc.state.multisample.samples
        if node.color_attachments:
            first_rid, _, first_mip, _ = node.color_attachments[0]
        elif node.depth_attachment is not None:
            first_rid, _, first_mip, _ = node.depth_attachment
        else:
            first_rid, first_mip = node.stencil_attachment, 0
        tdesc = resources[first_rid].texture_desc()
        att_w = max(1, tdesc.width >> first_mip)
        full_h = max(1, tdesc.height >> first_mip)
        viewport = None
        local_h = full_h
        if shard_ctx is not None:
            if _subresource_target(node):
                raise ValueError(
                    f"node '{node.name}': render-to-mip/-layer attachments are single-device "
                    f"(no SPMD mesh)")
            if node_sl:
                # Full-resolution raster on every shard; the composite
                # bands the result at the node's end.
                if full_h % n_shards:
                    raise ValueError(
                        f"node '{node.name}': attachment height {full_h} must divide by mesh "
                        f"size {n_shards} for the sort-last composite")
            else:
                if full_h % (n_shards * options.tile_h):
                    raise ValueError(
                        f"node '{node.name}': attachment height {full_h} must divide by mesh "
                        f"size {n_shards} x tile_h {options.tile_h}")
                # The band viewport (graph.py:1292-1295): rows y0 .. y0 + band.
                local_h = full_h // n_shards
                viewport = (0, spmd.axis_index(shard_ctx[0]) * local_h, att_w, full_h)
        # A render-to-mip surface is one level (graph.py:1163-1180).
        grid = TileGrid(
            width=att_w,
            height=local_h,
            tile_h=options.tile_h,
            tile_w=options.tile_w,
        )

        def band_of(rid, arr):
            """A loaded attachment in this node's layout: the shard's row
            band (a replicated full-height value is sliced the first time a
            graphic node touches it), or for a sort-last node the full
            surface (a banded value gathered)."""
            if shard_ctx is None:
                return arr
            if node_sl:
                return spmd.all_gather(arr, shard_ctx[0], axis=0, tiled=True) \
                    if rid in banded else arr
            if rid in banded:
                return arr
            return arr[viewport[1]:viewport[1] + grid.height]

        def att_load(rid, mip, layer):
            """Current contents of an attachment sub-surface (None when
            untouched); a LOAD of level k reads level k."""
            cur = state.get(rid)
            if cur is None:
                return None
            if isinstance(cur, tuple):
                cur = cur[mip]
            return cur if layer is None else cur[layer]

        def att_store(rid, mip, layer, arr):
            self._store(state, rid, mip, layer, None, arr, device)

        def to_samples(arr):
            if samples == 1:
                return arr
            return arr.unsqueeze(0).expand((samples,) + tuple(arr.shape))

        def loaded(rid, mip, layer, cur, resolve):
            """A LOADed attachment: the per-sample planes an earlier node of
            this sample count kept for the same sub-surface, else the
            resolved surface broadcast."""
            if samples > 1:
                kept = msaa_state.get((rid, mip, layer))
                if kept is not None and kept[0] == samples:
                    if node_sl and rid in banded:
                        # (S, band_h, W, ...) bands: gather the row axis.
                        return spmd.all_gather(kept[1], shard_ctx[0], axis=1, tiled=True)
                    return kept[1]
            return to_samples(resolve(cur))

        colors = []
        for rid, cdesc, mip, layer in node.color_attachments:
            cur = att_load(rid, mip, layer)
            if cdesc.load_op == LoadOp.CLEAR or cur is None:
                colors.append(to_samples(blend_ops.clear_color(
                    grid.height, grid.width, cdesc.clear_value, device)))
            else:
                colors.append(loaded(rid, mip, layer, cur, lambda c, rid=rid: band_of(rid, c)))

        depth = None
        if node.depth_attachment is not None:
            rid, ddesc, mip, layer = node.depth_attachment
            cur = att_load(rid, mip, layer)
            if ddesc.depth_load_op == LoadOp.CLEAR or cur is None:
                depth = to_samples(blend_ops.clear_depth(
                    grid.height, grid.width, ddesc.depth_clear_value, device))
            else:
                depth = loaded(rid, mip, layer, cur,
                               lambda c: band_of(rid, c[..., 0] if c.ndim == 3 else c))

        stencil = None
        if node.stencil_attachment is not None:
            srid = node.stencil_attachment
            sdesc = pipeline.desc.state.depth_stencil
            cur = state.get(srid)
            if sdesc.stencil_load_op == LoadOp.CLEAR or cur is None:
                stencil = to_samples(torch.full(
                    (grid.height, grid.width), sdesc.stencil_clear_value & 0xFF,
                    dtype=torch.int32, device=device,
                ))
            else:
                stencil = loaded(srid, 0, None, cur, lambda c: band_of(srid, c))

        ctx = GraphicNodeExecutionContext(
            self, node, state, dynamics, device, pipeline, grid,
            colors, depth, options.bin_capacity, stencil,
            budget_scale=options.budget_scale, viewport=viewport, shard_ctx=shard_ctx,
            sort_last=node_sl,
        )
        node.job(ctx)
        if node_sl:
            ctx._composite()

        # Epilogue: store attachments back (store-op STORE semantics), the
        # MSAA planes resolved (colour: mean; depth and stencil: sample 0)
        # and kept per sample for a later LOAD of the same sub-surface.
        def keep_samples(rid, mip, layer, arr):
            if samples > 1:
                msaa_state[(rid, mip, layer)] = (samples, arr)
            elif layer is None:
                # A whole-level single-sample write covers every layer's
                # kept planes of that level.
                for k in [k for k in msaa_state if k[0] == rid and k[1] == mip]:
                    del msaa_state[k]
            else:
                msaa_state.pop((rid, mip, layer), None)

        stored = []
        for (rid, _, mip, layer), arr in zip(node.color_attachments, ctx._colors):
            att_store(rid, mip, layer, arr.mean(dim=0) if samples > 1 else arr)
            keep_samples(rid, mip, layer, arr)
            stored.append(rid)
        if node.depth_attachment is not None and ctx._depth is not None:
            rid, _, mip, layer = node.depth_attachment
            att_store(rid, mip, layer, ctx._depth[0] if samples > 1 else ctx._depth)
            keep_samples(rid, mip, layer, ctx._depth)
            stored.append(rid)
        if node.stencil_attachment is not None and ctx._stencil is not None:
            srid = node.stencil_attachment
            keep_samples(srid, 0, None, ctx._stencil)
            state[srid] = ctx._stencil[0] if samples > 1 else ctx._stencil
            stored.append(srid)
        if shard_ctx is not None:
            banded.update(stored)
        for ov in ctx.stats:
            overflow = overflow + ov
        if validate:
            for arr in ctx._colors:
                nan_pixels = nan_pixels + torch.isnan(arr).sum().to(torch.int32)
            if ctx._depth is not None:
                nan_pixels = nan_pixels + torch.isnan(ctx._depth).sum().to(torch.int32)

        return overflow, nan_pixels


def _subresource_target(node: GraphNode) -> bool:
    """Whether a graphic node renders into one mip level or array layer."""
    return any(m != 0 or l is not None for _, _, m, l in node.color_attachments) or (
        node.depth_attachment is not None
        and (node.depth_attachment[2] != 0 or node.depth_attachment[3] is not None))


# Frame-function cache: structure key → frame function. Module-level so
# graphs rebuilt every frame (engine.rs:93-102) hit the same functions;
# LRU-bounded.
_FRAME_PROGRAM_CACHE: "_OrderedDict[_HKey, Callable]" = _OrderedDict()
_FRAME_PROGRAM_CACHE_MAX = 256

# Consecutive-miss counter: a steady miss streak means some per-frame
# identity defeats the cache — warn once per streak.
_MISS_STREAK = 0
_MISS_STREAK_WARN_AT = 4

# Validate-mode capture self-check state (see RenderGraph._capture_self_check).
_SELFCHECK_TICK = 0
_DEEP_FP_CACHE: dict = {}


def set_frame_program_cache_limit(n: int) -> None:
    """Cap the frame-function LRU (default 256)."""
    global _FRAME_PROGRAM_CACHE_MAX
    _FRAME_PROGRAM_CACHE_MAX = max(1, int(n))
    while len(_FRAME_PROGRAM_CACHE) > _FRAME_PROGRAM_CACHE_MAX:
        _FRAME_PROGRAM_CACHE.popitem(last=False)


def frame_program_cache_size() -> int:
    return len(_FRAME_PROGRAM_CACHE)


def clear_frame_program_cache() -> None:
    _FRAME_PROGRAM_CACHE.clear()


class CompiledRenderGraph:
    """(graph.rs:202-348)"""

    def __init__(self, graph: RenderGraph, fn, imports, dynamics, key: _HKey,
                 dyn_sig: tuple, device: torch.device):
        self._graph = graph
        self._fn = fn
        self._imports = imports
        self._dynamics = dynamics
        self._dyn_sig = dyn_sig
        self._device = device
        self.key = key
        self._outputs: Optional[Dict[str, Any]] = None
        self._stats: Optional[FrameStatsOutput] = None

    def execute(
        self,
        device: Optional[RenderDevice] = None,
        dynamics: "Optional[Dict[str, Any]]" = None,
    ) -> "RetiredRenderGraph":
        """One run of the frame function (replaces submit #1/#2 + all
        barriers/fences, graph.rs:203-274).

        RETAINED MODE: pass ``dynamics`` to override per-frame values and
        re-run the SAME frame function without rebuilding the graph. Only
        values declared via builder.set_dynamic may be overridden, with
        identical shapes/dtypes."""
        if device is not None:
            device.stats.submits += 1
        if dynamics is not None:
            merged = dict(self._graph.dynamics)
            for name, value in dynamics.items():
                if name not in merged:
                    raise KeyError(
                        f"dynamic '{name}' was not declared at build time "
                        f"(declared: {sorted(merged)})"
                    )
                merged[name] = value
            if _dynamic_signature(merged) != self._dyn_sig:
                raise ValueError(
                    "retained execute: dynamics signature changed (shape/"
                    "dtype of an overridden value differs from build time) — "
                    "rebuild the graph instead"
                )
            self._dynamics = _dynamics_to_device(merged, self._device)
        self._outputs, self._stats = self._fn(self._imports, self._dynamics)
        return RetiredRenderGraph(self)

    def value(self, resource: RenderGraphResource):
        """Final value of an exported or imported-written resource; a banded
        (SPMD) output whole, on the mesh's first device."""
        if self._outputs is None:
            raise RuntimeError("execute() first")
        out = self._outputs.get(str(resource.id))
        if out is None:
            raise KeyError(
                f"resource #{resource.id} is not a frame output "
                f"(exports: {self._graph.exports})"
            )
        if isinstance(out, spmd.ShardedTensor):
            return out.full()
        return out

    def present(self, swapchain, swapchain_resource: RenderGraphResource) -> None:
        """Hand the rendered swapchain image to the presentation ring
        (graph.rs:227-274)."""
        swapchain.present(self.value(swapchain_resource))


class RetiredRenderGraph:
    """(graph.rs:656-674) Stats carrier; memory is the caching allocator's."""

    def __init__(self, compiled: CompiledRenderGraph):
        self._compiled = compiled

    @property
    def bin_overflow(self):
        """Device-side overflow counter — reading it waits for the frame."""
        return self._compiled._stats.bin_overflow if self._compiled._stats else 0

    def release_frame_resources(self, device: RenderDevice) -> None:
        pass
