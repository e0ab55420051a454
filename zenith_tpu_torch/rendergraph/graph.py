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
per-sample planes are also kept for the frame (``msaa_state``), so a LOAD in
a later node of the same sample count continues per sample instead of
re-broadcasting the resolve; a lambda or single-sample write drops them.

Not ported yet: the SPMD ``mesh``/``parallel`` modes (ROADMAP item 24) and
sub-resource (mip/layer/range) views, with or without MSAA (item 21). Each
raises when asked for.
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
from zenith_tpu_torch.rhi.state import LoadOp

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

    ``mesh``/``shard_axis``/``parallel`` keep the reference's fields for API
    parity; only the single-device default is ported (ROADMAP item 24)."""

    tile_h: int = 32
    tile_w: int = 128
    bin_capacity: int = DEFAULT_BIN_CAPACITY
    mesh: Optional[Any] = None
    shard_axis: str = "rows"
    parallel: str = "sort_first"
    # Multiplies every draw's entry budget; the engine doubles it when a
    # frame reports bin overflow.
    budget_scale: int = 1


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


def _whole(access: RenderGraphResourceAccess) -> int:
    """The resource id of an access to a whole resource. Sub-resource views
    (mip levels, array layers, buffer ranges) are not ported yet."""
    if any(getattr(access, k, None) is not None for k in ("mip", "layer", "brange")):
        raise NotImplementedError(
            "sub-resource accesses (mip/layer/brange) are not ported yet "
            "(ROADMAP item 21: render-to-mip and render-to-layer features)"
        )
    return access.id


class _NodeContextBase:
    def __init__(self, graph: "RenderGraph", node: GraphNode,
                 state: Dict[int, Any], dynamics: Dict[str, Any],
                 device: torch.device):
        self._graph = graph
        self._node = node
        self._state = state
        self._dynamics = dynamics
        self.device = device

    def dynamic(self, name: str):
        """Read a per-frame value declared with builder.set_dynamic."""
        if name not in self._dynamics:
            raise KeyError(
                f"dynamic '{name}' not declared; call builder.set_dynamic first "
                f"(declared: {sorted(self._dynamics)})"
            )
        return self._dynamics[name]

    def get(self, access: RenderGraphResourceAccess):
        """Current value of a resource."""
        rid = _whole(access)
        val = self._state.get(rid)
        if val is None:
            val = self._graph._materialize_default(rid, self.device)
            self._state[rid] = val
        return val

    def get_full(self, access: RenderGraphResourceAccess):
        """Full (all-rows) value of a resource (graph.py:481-493): on one
        device it is ``get``; the row-banded SPMD modes are ROADMAP item 24."""
        return self.get(access)


class LambdaNodeExecutionContext(_NodeContextBase):
    """(graph.rs:635-654) Arbitrary tensor compute over declared resources."""

    def set(self, access: RenderGraphResourceAccess, value) -> None:
        rid = _whole(access)
        if not any(a.resource_id == rid for a in self._node.outputs):
            raise ValueError(
                f"node '{self._node.name}' writes resource #{rid} without "
                f"declaring write()"
            )
        self._state[rid] = value


class GraphicNodeExecutionContext(_NodeContextBase):
    """(graph.rs:509-633) Draw recording over the node's attachments."""

    def __init__(self, graph, node, state, dynamics, device,
                 pipeline: GraphicPipeline, grid: TileGrid,
                 colors: List[Any], depth: Optional[Any],
                 bin_capacity: int, stencil: Optional[Any] = None,
                 budget_scale: int = 1):
        super().__init__(graph, node, state, dynamics, device)
        self._budget_scale = budget_scale
        self.pipeline = pipeline
        self.grid = grid
        self._colors = colors
        self._depth = depth
        self._stencil = stencil
        self._bindings: Dict[str, Any] = {}
        self._bin_capacity = bin_capacity
        self.stats: List[Any] = []

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
        self._colors, self._depth, stats = draw_indexed(
            self._colors,
            self._depth,
            self.pipeline,
            vb,
            ib,
            merged,
            self.grid,
            bin_capacity=bin_capacity or self._bin_capacity,
            entry_budget=entry_budget,
            stencil=self._stencil,
            instance_count=instance_count,
            instance_data=instance_data,
            budget_scale=self._budget_scale,
        )
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
            if len(draw) > 3 and draw[3]:
                resolved.append((vb_v, ib_v, merged, draw[3]))
            else:
                resolved.append((vb_v, ib_v, merged))
        self._colors, self._depth, stats = draw_indexed_batch(
            self._colors,
            self._depth,
            self.pipeline,
            resolved,
            self.grid,
            per_draw_uniforms=tuple(per_draw_uniforms),
            entry_budget=entry_budget,
            stencil=self._stencil,
            budget_scale=self._budget_scale,
            peel_layers=peel_layers,
        )
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
        """Managed resource first touched by a read: zero contents."""
        desc = self.resources[rid].desc
        if desc is None:
            raise ValueError(f"imported resource #{rid} has no value")
        sds = desc.shape_dtype()
        return torch.zeros(sds.shape, dtype=sds.dtype, device=device)

    def _written_imports(self) -> List[int]:
        out = []
        for node in self.nodes:
            for a in node.outputs:
                if self.resources[a.resource_id].is_imported and a.resource_id not in out:
                    out.append(a.resource_id)
        return out

    def _structure_key(self, options: CompileOptions, dyn_sig: tuple, device: torch.device):
        """The frame-function cache key as a nested hashable tuple (same
        contents as the reference's key, graph.py:868-935, plus the device
        and the dynamics' (name, shape, dtype) signature)."""
        parts = [options, _validate_enabled(), str(device)]
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

    # -- compile ---------------------------------------------------------------

    def compile(
        self,
        device: RenderDevice,
        pipeline_cache: PipelineCache,
        options: CompileOptions = CompileOptions(),
    ) -> "CompiledRenderGraph":
        if options.mesh is not None or options.parallel != "sort_first":
            raise NotImplementedError(
                "SPMD rendering (mesh / parallel modes) is not ported yet "
                "(ROADMAP item 24: parallel)"
            )
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
        key = _HKey(self._structure_key(options, dyn_sig, dev))
        cached = _FRAME_PROGRAM_CACHE.get(key)
        global _MISS_STREAK
        if cached is not None:
            _FRAME_PROGRAM_CACHE.move_to_end(key)
            _MISS_STREAK = 0
        else:
            cached = self._build_frame_fn(active_nodes, options, dev)
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

    def _build_frame_fn(self, active_nodes: List[GraphNode], options: CompileOptions,
                        device: torch.device):
        resources = self.resources
        pipelines = self._pipelines
        output_ids = list(dict.fromkeys(self._written_imports() + self.exports))

        def frame_fn(imports: Dict[str, Any], dynamics: Dict[str, torch.Tensor]):
            """Run every node in declaration order; no host reads."""
            state: Dict[int, Any] = {}
            # rid -> (samples, (S, ...) planes) of the last MSAA node that
            # stored the resource.
            msaa_state: Dict[int, Tuple[int, torch.Tensor]] = {}
            for rid, st in enumerate(resources):
                if st.is_imported:
                    state[rid] = imports[str(rid)]
            overflow = nan_pixels = torch.zeros((), dtype=torch.int32, device=device)
            validate = _validate_enabled()

            for node in active_nodes:
                with profile.scope(node.name):
                    overflow, nan_pixels = self._run_node(
                        node, state, msaa_state, dynamics, device, pipelines, options,
                        resources, overflow, nan_pixels, validate,
                    )

            outputs = {str(rid): state[rid] for rid in output_ids if rid in state}
            return outputs, FrameStatsOutput(bin_overflow=overflow, nan_pixels=nan_pixels)

        return frame_fn

    def _run_node(self, node, state, msaa_state, dynamics, device, pipelines, options,
                  resources, overflow, nan_pixels, validate):
        """Run one node of the frame function; returns the running
        (overflow, nan_pixels) counters."""
        if node.kind == "lambda":
            ctx = LambdaNodeExecutionContext(self, node, state, dynamics, device)
            node.job(ctx)
            # A lambda write replaces the resolved surface: per-sample planes
            # must not shadow it.
            for a in node.outputs:
                msaa_state.pop(a.resource_id, None)
            return overflow, nan_pixels
        pipeline = pipelines[node.index]
        samples = pipeline.desc.state.multisample.samples
        atts = list(node.color_attachments)
        if node.depth_attachment is not None:
            atts.append(node.depth_attachment)
        if any(mip != 0 or layer is not None for _, _, mip, layer in atts):
            raise NotImplementedError(
                "render-to-mip/-layer attachments are not ported yet "
                "(ROADMAP item 21)"
            )
        first_rid = atts[0][0] if atts else node.stencil_attachment
        tdesc = resources[first_rid].texture_desc()
        grid = TileGrid(
            width=tdesc.width,
            height=tdesc.height,
            tile_h=options.tile_h,
            tile_w=options.tile_w,
        )

        def to_samples(arr):
            if samples == 1:
                return arr
            return arr.unsqueeze(0).expand((samples,) + tuple(arr.shape))

        def loaded(rid, resolve):
            """A LOADed attachment: the per-sample planes an earlier node of
            this sample count kept, else the resolved surface broadcast."""
            if samples > 1:
                kept = msaa_state.get(rid)
                if kept is not None and kept[0] == samples:
                    return kept[1]
            return to_samples(resolve(state[rid]))

        colors = []
        for rid, cdesc, _, _ in node.color_attachments:
            if cdesc.load_op == LoadOp.CLEAR or state.get(rid) is None:
                colors.append(to_samples(blend_ops.clear_color(
                    grid.height, grid.width, cdesc.clear_value, device)))
            else:
                colors.append(loaded(rid, lambda cur: cur))

        depth = None
        if node.depth_attachment is not None:
            rid, ddesc, _, _ = node.depth_attachment
            if ddesc.depth_load_op == LoadOp.CLEAR or state.get(rid) is None:
                depth = to_samples(blend_ops.clear_depth(
                    grid.height, grid.width, ddesc.depth_clear_value, device))
            else:
                depth = loaded(rid, lambda cur: cur[..., 0] if cur.ndim == 3 else cur)

        stencil = None
        if node.stencil_attachment is not None:
            sdesc = pipeline.desc.state.depth_stencil
            if sdesc.stencil_load_op == LoadOp.CLEAR or state.get(node.stencil_attachment) is None:
                stencil = to_samples(torch.full(
                    (grid.height, grid.width), sdesc.stencil_clear_value & 0xFF,
                    dtype=torch.int32, device=device,
                ))
            else:
                stencil = loaded(node.stencil_attachment, lambda cur: cur)

        ctx = GraphicNodeExecutionContext(
            self, node, state, dynamics, device, pipeline, grid,
            colors, depth, options.bin_capacity, stencil,
            budget_scale=options.budget_scale,
        )
        node.job(ctx)

        # Epilogue: store attachments back (store-op STORE semantics), the
        # MSAA planes resolved (colour: mean; depth and stencil: sample 0)
        # and kept per sample for a later LOAD.
        def store(rid, arr, resolve):
            if samples > 1:
                msaa_state[rid] = (samples, arr)
                arr = resolve(arr)
            else:
                msaa_state.pop(rid, None)
            state[rid] = arr

        for (rid, _, _, _), arr in zip(node.color_attachments, ctx._colors):
            store(rid, arr, lambda a: a.mean(dim=0))
        if node.depth_attachment is not None and ctx._depth is not None:
            store(node.depth_attachment[0], ctx._depth, lambda a: a[0])
        if node.stencil_attachment is not None and ctx._stencil is not None:
            store(node.stencil_attachment, ctx._stencil, lambda a: a[0])
        for ov in ctx.stats:
            overflow = overflow + ov
        if validate:
            for arr in ctx._colors:
                nan_pixels = nan_pixels + torch.isnan(arr).sum().to(torch.int32)
            if ctx._depth is not None:
                nan_pixels = nan_pixels + torch.isnan(ctx._depth).sum().to(torch.int32)

        return overflow, nan_pixels


# Frame-function cache: structure key → frame function. Module-level so
# graphs rebuilt every frame (engine.rs:93-102) hit the same functions;
# LRU-bounded.
_FRAME_PROGRAM_CACHE: "_OrderedDict[_HKey, Callable]" = _OrderedDict()
_FRAME_PROGRAM_CACHE_MAX = 256

# Consecutive-miss counter: a steady miss streak means some per-frame
# identity defeats the cache — warn once per streak.
_MISS_STREAK = 0
_MISS_STREAK_WARN_AT = 4


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
        """Final value of an exported or imported-written resource."""
        if self._outputs is None:
            raise RuntimeError("execute() first")
        out = self._outputs.get(str(resource.id))
        if out is None:
            raise KeyError(
                f"resource #{resource.id} is not a frame output "
                f"(exports: {self._graph.exports})"
            )
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
