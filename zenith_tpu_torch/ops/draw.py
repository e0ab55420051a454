"""The draw call: programmable + fixed-function pipeline for one draw or a
batch of draws (torch port of zenith_tpu/ops/draw.py: ``draw_indexed`` and
``draw_indexed_batch`` with their stencil, depth-peel, in-order blend and
multisample branches, over triangles, lines and points).

    vertex fetch (VertexLayout.unpack)
    → vertex shader (user fn, dense over vertices)
    → near clip + triangle setup (ops.geometry)
    → tile binning (ops.binning)
    → forward-interpolating raster, kernel K1; K3 with the stencil test;
      K4 per depth-peel layer (ops.raster)
    → varying finalize (ops.shade)
    → fragment shader (user fn, dense over pixels)
    → blend/output merger (ops.blend)

A batch that blends takes the in-order blend kernel instead (K5, K6 with
stencil): raster, the kernel-safe fragment shader and the output merger run
per fragment inside one pass (``_draw_batch_blend``).

Attributes are interpolated inside the raster pass as attr·(1/w) planes, so
fragment shading runs once per pixel with no gathers. Ops run eagerly in
stream order, which sequences split parts without the reference's
optimization barriers.

Lines and points (and triangles under a LINE or POINT polygon mode) expand
to screen rectangles of two triangles in setup and ride the same binning
and kernels. Multisampling runs one raster per Vulkan standard sample
position (``SAMPLE_POSITIONS``) over one shared binning: colours are
(S, H, W, C) and depth and stencil (S, H, W) inside an MSAA draw chain.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace
from typing import Any, Dict, Optional, Sequence

import torch

from zenith_tpu_torch.core import log
from zenith_tpu_torch.core import validate as _validate
from zenith_tpu_torch.ops import blend as blend_ops
from zenith_tpu_torch.ops import geometry, shade
from zenith_tpu_torch.ops.binning import TileGrid, bin_segmented
from zenith_tpu_torch.ops.raster import raster_segmented, raster_segmented_blend
from zenith_tpu_torch.rhi.pipeline import GraphicPipeline
from zenith_tpu_torch.rhi.shader import BindingError, BoundResources, FragmentBuiltins
from zenith_tpu_torch.rhi.state import (
    ColorAttachmentDesc,
    CompareOp,
    CullMode,
    InputAssemblyState,
    PolygonMode,
    PrimitiveTopology,
)

logger = log.get(__name__)

# Default per-tile candidate capacity; renderers override per scene.
DEFAULT_BIN_CAPACITY = 256

# Records per sequential raster part and primitives per geometry part, at
# the reference's values (draw.py:65-78) so that part splitting stays
# bit-equal with it.
MAX_RECORDS_PER_RASTER = 6 * 1024 * 1024
MAX_PRIMS_PER_PART = 2 * 1024 * 1024


def _geo_specs(prim_kind, clip, prims, flat_vary, grid, rast_state,
               viewport, depth_bias, point_sizes=None):
    """Deferred geometry-part builders for one draw: a list of
    ``(est_records, build)``; triangle draws above MAX_PRIMS_PER_PART split
    into contiguous primitive ranges (draw.py:81-109). The estimate is the
    reference's: 6 records a primitive for ``wire_line``, 2 for every other
    kind, although ``wire_point`` emits 6 (ROADMAP §3: pass an explicit
    ``entry_budget`` to POINT-mode draws)."""

    def make_build(pr):
        def build():
            return _setup_records(prim_kind, clip, pr, flat_vary, grid,
                                  rast_state, viewport, depth_bias,
                                  point_sizes=point_sizes)
        return build

    t = prims.shape[0]
    est_factor = 6 if prim_kind == "wire_line" else 2
    if prim_kind != "tri" or t <= MAX_PRIMS_PER_PART:
        return [(est_factor * t, make_build(prims))]
    k = -(-t // MAX_PRIMS_PER_PART)
    step = -(-t // k)
    return [
        (2 * (min(t, s + step) - s), make_build(prims[s:s + step]))
        for s in range(0, t, step)
    ]


def _bin_spec_parts(specs, grid, entry_budget=None, budget_scale=1):
    """Bin a submission-ordered list of geometry-part specs (draw.py:112-166):
    adjacent parts coalesce into groups of ≤ MAX_RECORDS_PER_RASTER
    estimated records, each group binned with its share of the budget."""
    total_est = sum(e for e, _ in specs) or 1
    scale = max(int(budget_scale), 1)
    total_budget = (
        int(entry_budget) if entry_budget is not None
        else sum(max(2 * e, 8192) for e, _ in specs)
    ) * scale

    groups = []
    cur, cur_est = [], 0
    for e, build in specs:
        if cur and cur_est + e > MAX_RECORDS_PER_RASTER:
            groups.append((cur_est, cur))
            cur, cur_est = [], 0
        cur.append(build)
        cur_est += e
    if cur:
        groups.append((cur_est, cur))

    all_parts = []
    for g_est, builds in groups:
        built = [b() for b in builds]
        if len(built) == 1:
            records, corner = built[0]
        else:
            records = geometry.TriangleRecords(
                *[torch.cat([getattr(r, f) for r, _ in built])
                  for f in geometry.TriangleRecords._fields]
            )
            corner = torch.cat([c for _, c in built])
        g_budget = max(int(round(total_budget * g_est / total_est)), 1)
        all_parts.extend(_bin_parts(records, corner, grid, entry_budget=g_budget).parts)
    return _BinParts(all_parts)


class _BinParts:
    """1..K sequential binning units for one draw (see _bin_parts)."""

    def __init__(self, parts: list):
        self.parts = parts

    @property
    def overflow(self):
        total = self.parts[0].overflow
        for p in self.parts[1:]:
            total = total + p.overflow
        return total


def _bin_parts(records, corner_data, grid, entry_budget=None,
               budget_scale=1) -> _BinParts:
    """Bin a draw's records, splitting into sequential parts above
    MAX_RECORDS_PER_RASTER records (draw.py:183-238; the port has no SMEM
    routing cap, see ops.binning)."""
    r = records.rast16.shape[0]
    scale = max(int(budget_scale), 1)
    budget = (
        int(entry_budget) if entry_budget is not None else max(2 * r, 8192)
    ) * scale
    k = max(1, -(-max(r, 1) // MAX_RECORDS_PER_RASTER))
    if k <= 1:
        return _BinParts([
            bin_segmented(records, corner_data, grid,
                          entry_budget=entry_budget, budget_scale=budget_scale)
        ])
    step = -(-r // k)
    parts = []
    for s in range(0, r, step):
        e = min(r, s + step)
        rec = geometry.TriangleRecords(*[f[s:e] for f in records])
        sub = max(-(-budget // k), 2 * (e - s), 8192)
        parts.append(bin_segmented(rec, corner_data[s:e], grid, entry_budget=sub))
    return _BinParts(parts)


def _raster_parts(bin_parts: _BinParts, grid, init_z, *, init_stencil=None,
                  stencil_front=None, stencil_back=None, z_bound=None, **kw):
    """raster_segmented over a _BinParts: parts run in order with the depth
    (and stencil) plane threaded through; attribute planes merge by part
    coverage (draw.py:241-269). Returns (z, acc), and the stencil plane as a
    third value when ``stencil_front`` is given."""
    z = init_z
    sten = init_stencil
    acc = None
    for bins in bin_parts.parts:
        if stencil_front is not None:
            z, acc_i, sten = raster_segmented(
                bins, grid, z, init_stencil=sten, stencil_front=stencil_front,
                stencil_back=stencil_back, **kw)
        else:
            z, acc_i = raster_segmented(bins, grid, z, z_bound=z_bound, **kw)
        if acc is None:
            acc = acc_i
        else:
            acc = torch.where((acc_i[-1] > 0.0)[None], acc_i, acc)
    if stencil_front is not None:
        return z, acc, sten
    return z, acc


def _default_stencil(ds, grid, device) -> torch.Tensor:
    """The stencil plane a draw starts from when none is attached."""
    return torch.full((grid.height, grid.width), ds.stencil_clear_value & 0xFF,
                      dtype=torch.int32, device=device)


def _raster_state(ds, rast_state) -> dict:
    """The depth state of a pipeline as raster_segmented's keywords."""
    return dict(depth_test=ds.depth_test_enable, depth_write=ds.depth_write_enable,
                compare_op=ds.depth_compare_op, depth_clamp=rast_state.depth_clamp)


def _zero_depth(grid, device) -> torch.Tensor:
    """The depth plane a draw without a depth attachment starts from."""
    return torch.zeros((grid.height, grid.width), dtype=torch.float32, device=device)


def _raster_one(bins, grid, ds, rast_state, init_z, stencil=None,
                sample_offset=(0.5, 0.5)):
    """One raster of a draw's bins at one sample position → (z, acc,
    stencil or None): K3 from ``stencil`` (or the clear value) when the
    pipeline enables the stencil test, else K1."""
    kw = dict(_raster_state(ds, rast_state), sample_offset=sample_offset)
    if ds.stencil_test_enable:
        init_s = stencil if stencil is not None else _default_stencil(ds, grid, init_z.device)
        return _raster_parts(bins, grid, init_z, init_stencil=init_s,
                             stencil_front=ds.stencil_front,
                             stencil_back=ds.stencil_back, **kw)
    z_out, acc = _raster_parts(bins, grid, init_z, **kw)
    return z_out, acc, None


class _CheckedAttrs(dict):
    """Vertex-attribute dict with a named error on a missing key."""

    def __init__(self, data, shader_name: str):
        super().__init__(data)
        self._shader_name = shader_name

    def __missing__(self, key):
        raise BindingError(
            f"vertex shader {self._shader_name!r} reads attribute {key!r} "
            f"which the vertex layout / instance data does not provide "
            f"(available: {sorted(k for k in self)}). Declare the shader's "
            f"inputs (Shader.vertex(..., inputs=[attr(...)])) to catch this "
            f"at pipeline build time."
        )


# Unused-binding diagnostics (validate mode): warn once per (shader, name).
_UNUSED_WARNED: "set[tuple[int, str]]" = set()


def _warn_unused_bindings(shader, res: BoundResources) -> None:
    """Declared-but-never-read binding warning (descriptor.rs:298-456)."""
    if not _validate.enabled():
        return
    for name in shader.reflection.binding_names():
        if name in res.accessed:
            continue
        k = (id(shader), name)
        if k not in _UNUSED_WARNED:
            _UNUSED_WARNED.add(k)
            logger.warning(
                "[validate] shader %r declares binding '%s' but never read "
                "it this draw — drop the declaration or use the resource",
                shader.name, name,
            )


def _check_instance_inputs(pipeline, instance_data, instance_count) -> None:
    """Draw-time validation of per_instance vertex inputs."""
    declared = pipeline.vertex_shader.vertex_inputs
    if declared is None:
        return
    inst_names = {d.name for d in declared if d.per_instance}
    if not inst_names:
        return
    got = set(instance_data or ()) | {"instance_index"}
    missing = inst_names - got
    if missing:
        raise BindingError(
            f"vertex shader {pipeline.vertex_shader.name!r} declares "
            f"per-instance inputs {sorted(missing)} but the draw's "
            f"instance_data provides {sorted(got)}"
        )


def assemble_triangles(index_buffer: torch.Tensor, ia: InputAssemblyState) -> torch.Tensor:
    """Primitive assembly: index buffer → (T, 3) triangle list
    (draw.py:343-385). TRIANGLE_STRIP follows the Vulkan rule, with odd
    triangles' first two corners swapped; with ``primitive_restart`` the
    restart index (-1 as int32) cuts strips, triangles touching it collapse
    to (0, 0, 0) and the parity restarts at each cut."""
    if ia.topology == PrimitiveTopology.TRIANGLE_LIST:
        return index_buffer.reshape(-1, 3)

    flat = index_buffer.reshape(-1).to(torch.int32)
    n = flat.shape[0]
    if n < 3:
        raise ValueError(f"triangle strip needs >= 3 indices, got {n}")
    i0, i1, i2 = flat[:-2], flat[1:-1], flat[2:]
    pos = torch.arange(n - 2, dtype=torch.int32, device=flat.device)

    if ia.primitive_restart:
        is_restart = flat == -1
        ar = torch.arange(n, dtype=torch.int32, device=flat.device)
        seg_start = torch.cummax(
            torch.where(is_restart, ar, torch.full_like(ar, -1)), 0
        ).values + 1
        parity = (pos - seg_start[: n - 2]) & 1
        bad = is_restart[:-2] | is_restart[1:-1] | is_restart[2:]
    else:
        parity = pos & 1
        bad = torch.zeros((n - 2,), dtype=torch.bool, device=flat.device)

    odd = parity == 1
    a = torch.where(odd, i1, i0)
    b = torch.where(odd, i0, i1)
    tris = torch.stack([a, b, i2], dim=1)
    return torch.where(bad[:, None], torch.zeros_like(tris), tris)


def assemble_lines(index_buffer: torch.Tensor, ia: InputAssemblyState) -> torch.Tensor:
    """Index buffer → (L, 2) segment list for the line topologies
    (draw.py:389-407). LINE_STRIP segment i is (v_i, v_{i+1}); with
    ``primitive_restart`` the segments touching the restart index collapse
    to (0, 0), zero screen length, which line setup drops."""
    flat = index_buffer.reshape(-1).to(torch.int32)
    n = flat.shape[0]
    if ia.topology == PrimitiveTopology.LINE_LIST:
        if n % 2:
            raise ValueError(f"line list needs an even index count, got {n}")
        return flat.reshape(-1, 2)
    if n < 2:
        raise ValueError(f"line strip needs >= 2 indices, got {n}")
    segs = torch.stack([flat[:-1], flat[1:]], dim=1)
    if ia.primitive_restart:
        bad = (flat[:-1] == -1) | (flat[1:] == -1)
        segs = torch.where(bad[:, None], torch.zeros_like(segs), segs)
    return segs


def _assemble_primitives(index_buffer, ia: InputAssemblyState, polygon_mode: PolygonMode):
    """Primitive assembly dispatch → (kind, (P, K) primitive indices)
    (draw.py:410-428). kind is 'tri', 'line', 'point', 'wire_line' or
    'wire_point'; the wire kinds are triangles under a LINE/POINT polygon
    mode, kept (T, 3) so that setup culls by the polygon's facing before
    taking it apart (Vulkan 27.7.1)."""
    topo = ia.topology
    if topo in (PrimitiveTopology.LINE_LIST, PrimitiveTopology.LINE_STRIP):
        return "line", assemble_lines(index_buffer, ia)
    if topo == PrimitiveTopology.POINT_LIST:
        return "point", index_buffer.reshape(-1, 1).to(torch.int32)
    tris = assemble_triangles(index_buffer, ia)
    if polygon_mode == PolygonMode.LINE:
        return "wire_line", tris
    if polygon_mode == PolygonMode.POINT:
        return "wire_point", tris
    return "tri", tris


def _setup_records(kind, clip, prims, flat_vary, grid, rast_state, viewport, depth_bias,
                   point_sizes=None):
    """Primitive setup → (TriangleRecords, corner_data) (draw.py:431-478):
    triangles through setup_with_attrs, lines and points as screen
    rectangles on the same records."""
    dc = rast_state.depth_clamp
    if kind == "tri":
        return geometry.setup_with_attrs(
            clip, prims, flat_vary, grid.width, grid.height,
            cull_mode=rast_state.cull_mode, front_face=rast_state.front_face,
            viewport=viewport, depth_bias=depth_bias, depth_clamp=dc,
        )
    if kind in ("wire_line", "wire_point"):
        front, degen = geometry.triangle_facing(clip, prims, rast_state.front_face)
        keep = ~degen
        if rast_state.cull_mode == CullMode.BACK:
            keep = keep & front
        elif rast_state.cull_mode == CullMode.FRONT:
            keep = keep & ~front
        if kind == "wire_line":
            segs = torch.cat([prims[:, [0, 1]], prims[:, [1, 2]], prims[:, [2, 0]]])
            return geometry.setup_lines_with_attrs(
                clip, segs, flat_vary, grid.width, grid.height,
                line_width=rast_state.line_width, viewport=viewport,
                depth_clamp=dc, seg_valid=torch.cat([keep, keep, keep]),
            )
        return geometry.setup_points_with_attrs(
            clip, prims.reshape(-1), flat_vary, grid.width, grid.height,
            point_sizes=point_sizes, viewport=viewport, depth_clamp=dc,
            pt_valid=keep.repeat_interleave(3),
        )
    if kind == "line":
        return geometry.setup_lines_with_attrs(
            clip, prims, flat_vary, grid.width, grid.height,
            line_width=rast_state.line_width, viewport=viewport, depth_clamp=dc,
        )
    assert kind == "point", kind
    return geometry.setup_points_with_attrs(
        clip, prims.reshape(-1), flat_vary, grid.width, grid.height,
        point_sizes=point_sizes, viewport=viewport, depth_clamp=dc,
    )


def _pop_point_sizes(vs_out) -> Optional[torch.Tensor]:
    """Take the PointSize builtin (``point_size``, Vulkan's gl_PointSize)
    out of the vertex-stage outputs, so that it never becomes a varying
    (draw.py:481-488)."""
    ps = vs_out.pop("point_size", None)
    if ps is None:
        return None
    return torch.as_tensor(ps, dtype=torch.float32).reshape(-1)


def _normalize_frag_out(frag_out) -> list:
    """Fragment-stage output → ordered list of attachment images (single
    tensor, list/tuple in attachment order, or dict sorted by key for MRT)."""
    if isinstance(frag_out, (list, tuple)):
        return list(frag_out)
    if isinstance(frag_out, dict):
        return [frag_out[k] for k in sorted(frag_out)]
    return [frag_out]


def _vertex_stage(pipeline, vertex_buffer, attrs, vs_res, indices,
                  instance_count=1, instance_data=None):
    """Run the vertex shader → (clip (N, 4), varyings, primitive indices,
    point sizes or None).

    ``instance_count`` > 1 (or instance data) runs it over a written-out
    instance dimension: instances see ``instance_data`` rows as extra attrs
    plus ``instance_index``, and primitives concatenate in instance order
    (Vulkan's primitive ordering, draw.py:1036-1069)."""
    if instance_count > 1 or instance_data:
        _check_instance_inputs(pipeline, instance_data, instance_count)
        nv = vertex_buffer.shape[0]
        dev = vertex_buffer.device
        a = _CheckedAttrs(
            {k: v.unsqueeze(0).expand(instance_count, *v.shape).reshape(instance_count * nv, -1)
             for k, v in attrs.items()},
            pipeline.vertex_shader.name,
        )
        for k, v in (instance_data or {}).items():
            v = torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(instance_count, -1)
            a[k] = v.repeat_interleave(nv, dim=0)
        a["instance_index"] = torch.arange(
            instance_count, dtype=torch.float32, device=dev
        ).repeat_interleave(nv)[:, None]
        vs_out = dict(pipeline.vertex_shader.fn(a, vs_res))
        offs = (torch.arange(instance_count, dtype=indices.dtype, device=dev) * nv)[:, None, None]
        indices = (indices[None, :, :] + offs).reshape(-1, indices.shape[1])
    else:
        vs_out = dict(pipeline.vertex_shader.fn(
            _CheckedAttrs(attrs, pipeline.vertex_shader.name), vs_res))
    clip = vs_out.pop("position")
    return clip, vs_out, indices, _pop_point_sizes(vs_out)


class PerDraw(tuple):
    """Marker for a fragment-shader resource whose value differs per draw in
    a batched draw (one element per draw, draw.py:336). Fragment shaders
    select with ``builtins.draw_id``; plain tuples stay what they always
    were."""


@dataclass
class DrawStats:
    """Per-draw counters folded into frame stats."""

    bin_overflow: Any = None  # device scalar (never read inside a frame)
    stencil: Any = None


def draw_indexed(
    colors: "Sequence[torch.Tensor]",  # current color attachment contents
    depth: Optional[torch.Tensor],  # current depth contents or None
    pipeline: GraphicPipeline,
    vertex_buffer: torch.Tensor,  # (Nv, stride) f32
    index_buffer: torch.Tensor,  # (T, 3) or (3T,) int
    resources: "Dict[str, Any]",
    grid: TileGrid,
    bin_capacity: int = DEFAULT_BIN_CAPACITY,
    viewport: "Optional[tuple]" = None,  # (x0, y0, full_w, full_h)
    entry_budget: Optional[int] = None,  # tile×record pair budget (see binning)
    stencil: Optional[torch.Tensor] = None,
    instance_count: int = 1,
    instance_data: "Optional[Dict[str, Any]]" = None,  # name → (I, C) tensors
    budget_scale: int = 1,
) -> "tuple[list[torch.Tensor], Optional[torch.Tensor], DrawStats]":
    """Run one indexed draw (draw.py:513-671); returns (colors', depth',
    stats). When the pipeline enables the stencil test the raster is kernel
    K3 and ``stats.stencil`` carries the updated plane (pass ``stencil=`` the
    current one). ``instance_count`` > 1 runs the vertex stage over a
    written-out instance dimension: instances see ``instance_data`` rows as
    extra attrs plus ``instance_index``, and records concatenate in instance
    order."""
    state = pipeline.desc.state
    rast_state = state.rasterization
    ds = state.depth_stencil

    # -- vertex stage --------------------------------------------------------
    layout = pipeline.vertex_layout
    if layout is not None:
        attrs = layout.unpack(vertex_buffer)
    else:
        attrs = {"position": vertex_buffer}
    vs_res = BoundResources(pipeline.vertex_shader.reflection, resources)
    prim_kind, indices = _assemble_primitives(
        index_buffer, state.input_assembly, rast_state.polygon_mode
    )

    clip, vs_out, indices, point_sizes = _vertex_stage(
        pipeline, vertex_buffer, attrs, vs_res, indices, instance_count, instance_data
    )
    _warn_unused_bindings(pipeline.vertex_shader, vs_res)
    if clip.ndim != 2 or clip.shape[1] != 4:
        raise ValueError(
            f"vertex shader must return clip-space 'position' (N, 4), got {tuple(clip.shape)}"
        )

    # -- primitive assembly + setup (fused with attribute gathering) ----------
    attr_layout = [(name, int(v.shape[-1]) if v.ndim > 1 else 1)
                   for name, v in vs_out.items()]
    if vs_out:
        flat_vary = torch.cat(
            [v.reshape(v.shape[0], -1).to(torch.float32) for v in vs_out.values()], dim=1
        )
    else:
        flat_vary = torch.zeros((clip.shape[0], 0), dtype=torch.float32, device=clip.device)
    depth_bias = None
    if rast_state.depth_bias_enable:
        depth_bias = (rast_state.depth_bias_constant, rast_state.depth_bias_slope)
    specs = _geo_specs(
        prim_kind, clip, indices, flat_vary, grid, rast_state, viewport, depth_bias,
        point_sizes=point_sizes,
    )
    attr_layout.append(("__front", 1))

    # -- binning + raster ------------------------------------------------------
    bins = _bin_spec_parts(specs, grid, entry_budget=entry_budget,
                           budget_scale=budget_scale)
    samples = state.multisample.samples
    if samples > 1:
        new_colors, new_depth, stencil_out = _raster_shade_msaa(
            colors, depth, pipeline, resources, bins, grid, attr_layout, samples,
            stencil, clip.device)
        return new_colors, new_depth, DrawStats(bin_overflow=bins.overflow, stencil=stencil_out)

    init_z = depth if depth is not None else _zero_depth(grid, clip.device)
    z_out, acc, stencil_out = _raster_one(bins, grid, ds, rast_state, init_z, stencil)

    varyings, mask, builtins = shade.finalize_attrs(z_out, acc, attr_layout)
    new_colors = _shade_and_blend(colors, varyings, mask, builtins, pipeline, resources)
    new_depth = z_out if depth is not None else None
    return new_colors, new_depth, DrawStats(bin_overflow=bins.overflow, stencil=stencil_out)


def _fragment_outputs(pipeline, resources, varyings, builtins, n_colors):
    """Run the fragment shader over finalized varyings → [(image, attachment
    desc)] in attachment order."""
    fs = pipeline.fragment_shader
    fs_res = BoundResources(fs.reflection, resources)
    frag_list = _normalize_frag_out(fs.fn(varyings, fs_res, builtins))
    _warn_unused_bindings(fs, fs_res)
    if len(frag_list) != n_colors:
        raise ValueError(
            f"fragment shader wrote {len(frag_list)} outputs for "
            f"{n_colors} color attachments"
        )
    descs = pipeline.desc.color_attachment_descs or (None,) * n_colors
    return [(src, d if d is not None else ColorAttachmentDesc())
            for src, d in zip(frag_list, descs)]


def _shade_and_blend(colors, varyings, mask, builtins, pipeline, resources):
    """Fragment shader → output merger for one sample, over finalized
    varyings."""
    if pipeline.fragment_shader is None:
        return list(colors)
    constants = pipeline.desc.state.color_blend.blend_constants
    return [blend_ops.apply_color_output(dst, src, mask, desc, constants)
            for dst, (src, desc) in zip(colors, _fragment_outputs(
                pipeline, resources, varyings, builtins, len(colors)))]


# Vulkan standard sample locations (spec 25.3), draw.py:701-710. Every
# position lies in [0, 1)², the range the CUDA raster wrappers accept.
SAMPLE_POSITIONS = {
    1: ((0.5, 0.5),),
    2: ((0.75, 0.75), (0.25, 0.25)),
    4: ((0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875)),
    8: (
        (0.5625, 0.3125), (0.4375, 0.6875), (0.8125, 0.5625),
        (0.3125, 0.1875), (0.1875, 0.8125), (0.0625, 0.4375),
        (0.6875, 0.9375), (0.9375, 0.0625),
    ),
}


def _sample_offsets(samples: int):
    offsets = SAMPLE_POSITIONS.get(samples)
    if offsets is None:
        raise ValueError(f"unsupported sample count {samples} "
                         f"(supported: {sorted(SAMPLE_POSITIONS)})")
    return offsets


def _plane_at(plane, s: int, samples: int):
    """Sample ``s`` of a (S, H, W, ...) plane of an MSAA draw chain, or the
    plane itself at one sample."""
    return plane[s] if plane is not None and samples > 1 else plane


def _join_samples(planes: list, samples: int):
    """The per-sample planes of a draw as one (S, H, W, ...) tensor (the
    plane itself at one sample; None when there are none)."""
    if not planes:
        return None
    return torch.stack(planes) if samples > 1 else planes[0]


def _raster_shade_msaa(colors, depth, pipeline, resources, bins, grid, attr_layout,
                       samples, stencil, device):
    """Multisampling (draw.py:713-787): one shared binning, one raster per
    standard sample position, shading and blending per sample. Inside an
    MSAA draw chain colours are (S, H, W, C), depth (S, H, W) and, when the
    pipeline tests stencil, stencil (S, H, W) int32; the render graph
    broadcasts clears and loads and resolves at the store. With
    ``sample_shading`` off the draw shades once per pixel
    (``_raster_shade_msaa_per_pixel``)."""
    state = pipeline.desc.state
    ds = state.depth_stencil
    rast_state = state.rasterization
    offsets = _sample_offsets(samples)
    if not state.multisample.sample_shading:
        return _raster_shade_msaa_per_pixel(colors, depth, pipeline, resources, bins, grid,
                                            attr_layout, offsets, stencil, device)
    out_colors = [[] for _ in colors]
    out_z, out_s = [], []
    for s, off in enumerate(offsets):
        init_z = depth[s] if depth is not None else _zero_depth(grid, device)
        z_s, acc_s, st_s = _raster_one(bins, grid, ds, rast_state, init_z,
                                       stencil[s] if stencil is not None else None, off)
        varyings, mask, builtins = shade.finalize_attrs(z_s, acc_s, attr_layout)
        shaded = _shade_and_blend([c[s] for c in colors], varyings, mask, builtins,
                                  pipeline, resources)
        for i, c in enumerate(shaded):
            out_colors[i].append(c)
        out_z.append(z_s)
        if st_s is not None:
            out_s.append(st_s)
    new_depth = torch.stack(out_z) if depth is not None else None
    return [torch.stack(cs) for cs in out_colors], new_depth, _join_samples(out_s, len(offsets))


def _raster_shade_msaa_per_pixel(colors, depth, pipeline, resources, bins, grid,
                                 attr_layout, offsets, stencil, device):
    """Shade-once-per-pixel MSAA (vk sampleShadingEnable=False,
    draw.py:790-901): one raster per sample position resolves per-sample
    visibility and depth (and stencil), one more raster at the pixel centre
    resolves the shaded surface's attributes, the fragment shader runs once
    per pixel, and each covered sample blends the result in through its own
    output merge.

    The centre plane is not kept between draws, so its depth seed is
    rebuilt from the per-sample planes by the compare: the per-pixel max for
    GREATER/GEQ, the min for LESS/LEQ, sample 0 otherwise. Silhouette
    samples whose winner differs from the centre's take the centre
    surface's colour, and samples covered where the centre is not keep
    their previous contents (the reference's documented contract)."""
    state = pipeline.desc.state
    ds = state.depth_stencil
    rast_state = state.rasterization
    zs, accs, stens = [], [], []
    for s, off in enumerate(offsets):
        init_z = depth[s] if depth is not None else _zero_depth(grid, device)
        z_s, acc_s, st_s = _raster_one(bins, grid, ds, rast_state, init_z,
                                       stencil[s] if stencil is not None else None, off)
        zs.append(z_s)
        accs.append(acc_s)
        if st_s is not None:
            stens.append(st_s)

    if depth is None:
        init_zc = _zero_depth(grid, device)
    elif ds.depth_compare_op in (CompareOp.GREATER, CompareOp.GREATER_OR_EQUAL):
        init_zc = depth.amax(dim=0)
    elif ds.depth_compare_op in (CompareOp.LESS, CompareOp.LESS_OR_EQUAL):
        init_zc = depth.amin(dim=0)
    else:
        init_zc = depth[0]
    z_c, acc_c = _raster_parts(bins, grid, init_zc, sample_offset=(0.5, 0.5),
                               **_raster_state(ds, rast_state))
    varyings, center_mask, builtins = shade.finalize_attrs(z_c, acc_c, attr_layout)

    out_colors = [[c[s] for s in range(len(offsets))] for c in colors]
    if pipeline.fragment_shader is not None:
        constants = state.color_blend.blend_constants
        frags = _fragment_outputs(pipeline, resources, varyings, builtins, len(colors))
        for s in range(len(offsets)):
            mask_s = (accs[s][-1] > 0.0) & center_mask
            for i, (src, desc) in enumerate(frags):
                out_colors[i][s] = blend_ops.apply_color_output(
                    out_colors[i][s], src, mask_s, desc, constants)
    new_depth = torch.stack(zs) if depth is not None else None
    return [torch.stack(cs) for cs in out_colors], new_depth, _join_samples(stens, len(offsets))


def _batch_records(pipeline, draws, grid, viewport, uniform_columns,
                   require_uniforms: bool = False):
    """The per-draw vertex stages of a batched draw → (geometry-part specs in
    submission order, the shared attribute layout). A ``__draw_id`` column
    rides every record; each name in ``uniform_columns`` rides as constant
    ``__u_<name>`` columns (the same value at all three corners interpolates
    to itself); ``__front`` closes the layout."""
    state = pipeline.desc.state
    rast_state = state.rasterization
    layout = pipeline.vertex_layout
    depth_bias = None
    if rast_state.depth_bias_enable:
        depth_bias = (rast_state.depth_bias_constant, rast_state.depth_bias_slope)

    all_specs = []
    attr_layout = None
    for di, draw in enumerate(draws):
        vb, ib, res = draw[0], draw[1], draw[2]
        inst = draw[3] if len(draw) > 3 else None
        attrs = layout.unpack(vb) if layout is not None else {"position": vb}
        vs_res = BoundResources(pipeline.vertex_shader.reflection, res)
        prim_kind, prims = _assemble_primitives(
            ib, state.input_assembly, rast_state.polygon_mode
        )
        icount = int(inst.get("instance_count", 1)) if inst else 1
        idata = (inst.get("instance_data") or {}) if inst else None
        clip, vs_out, prims, point_sizes = _vertex_stage(
            pipeline, vb, attrs, vs_res, prims, icount, idata
        )
        _warn_unused_bindings(pipeline.vertex_shader, vs_res)
        nv = clip.shape[0]

        this_layout = [(name, int(v.shape[-1]) if v.ndim > 1 else 1)
                       for name, v in vs_out.items()]
        vary_cols = [v.reshape(nv, -1).to(torch.float32) for v in vs_out.values()]
        this_layout.append(("__draw_id", 1))
        vary_cols.append(torch.full((nv, 1), float(di), dtype=torch.float32,
                                    device=clip.device))
        for uname in uniform_columns:
            if require_uniforms and uname not in res:
                raise BindingError(
                    f"blend batch draw {di}: fragment binding '{uname}' not provided"
                )
            uval = torch.as_tensor(res[uname], dtype=torch.float32,
                                   device=clip.device).reshape(-1)
            this_layout.append((f"__u_{uname}", int(uval.shape[0])))
            vary_cols.append(uval[None, :].expand(nv, uval.shape[0]))

        if attr_layout is None:
            attr_layout = this_layout
        elif attr_layout != this_layout:
            raise ValueError(
                f"draw {di}: varying layout {this_layout} differs from draw 0's "
                f"{attr_layout} — batched draws share one pipeline"
            )
        flat_vary = torch.cat(vary_cols, dim=1)
        all_specs.extend(_geo_specs(
            prim_kind, clip, prims, flat_vary, grid, rast_state, viewport, depth_bias,
            point_sizes=point_sizes,
        ))
    attr_layout.append(("__front", 1))
    return all_specs, attr_layout


def draw_indexed_batch(
    colors: "Sequence[torch.Tensor]",
    depth: Optional[torch.Tensor],
    pipeline: GraphicPipeline,
    draws: "Sequence[tuple]",  # (vb, ib, resources[, inst]) per draw
    grid: TileGrid,
    per_draw_uniforms: "Sequence[str]" = (),
    viewport: "Optional[tuple]" = None,
    entry_budget: Optional[int] = None,
    stencil: Optional[torch.Tensor] = None,
    budget_scale: int = 1,
    peel_layers: Optional[int] = None,
) -> "tuple[list[torch.Tensor], Optional[torch.Tensor], DrawStats]":
    """N draws through ONE binning + raster + fragment + blend pass
    (draw.py:904-1328): per-draw vertex stages, records concatenated in
    submission order (binning's (tile, record) order keeps cross-draw
    order), then one raster over K1 (K3 when the pipeline enables the stencil
    test), one fragment pass, one output merge.

    A ``__draw_id`` varying rides the records. Per-draw fragment uniforms
    (``per_draw_uniforms``) reach the fragment shader as dense (H, W, C)
    planes under their binding names: up to 8 draws rebuild each plane from
    the (N, C) table by a draw-id ``where`` chain; above 8 they ride the
    records as constant varying columns (``uniforms_in_records``,
    draw.py:1021). Other fragment bindings that differ across draws become
    ``PerDraw`` tuples. An instanced draw ``(vb, ib, res, {"instance_count",
    "instance_data"})`` runs its vertex stage over a flattened instance
    dimension.

    Blending across overlapping draws is order-dependent, and this path
    resolves one depth winner per pixel. So a blending pipeline takes either
    the in-order blend kernel (K5/K6, ``_draw_batch_blend``; the fragment
    shader must be kernel-safe) or, with ``peel_layers=K``, depth peeling: K
    winner-resolve passes over K4, each bounded by the previous layer's
    depth, shaded densely (texture sampling allowed) and composited back to
    front: exact for ≤K overlapping translucent fragments per pixel; deeper
    fragments are dropped and counted into ``DrawStats.bin_overflow``."""
    state = pipeline.desc.state
    rast_state = state.rasterization
    ds = state.depth_stencil
    n_draws = len(draws)
    if n_draws < 1:
        raise ValueError("draw_indexed_batch needs at least one draw")

    blend_enabled = any(
        desc.blend_enable for desc in pipeline.desc.color_attachment_descs or ()
    )
    peel = peel_layers is not None
    if peel:
        if not blend_enabled:
            raise ValueError("peel_layers requires a blending pipeline")
        if len(colors) != 1:
            raise ValueError("depth peel: exactly one color attachment")
        if ds.stencil_test_enable:
            raise ValueError("depth peel: stencil unsupported (use the in-order "
                             "blend-kernel path for stencil + blending)")
        if not ds.depth_test_enable or ds.depth_compare_op not in (
                CompareOp.GREATER, CompareOp.GREATER_OR_EQUAL,
                CompareOp.LESS, CompareOp.LESS_OR_EQUAL):
            raise ValueError(
                "depth peel needs an ordering depth test (GREATER/GEQ/LESS/LEQ) — "
                "peeling resolves layers by depth, not submission order")
        if int(peel_layers) < 1:
            raise ValueError("peel_layers must be at least 1")
    if blend_enabled and not peel:
        # Order-dependent blending takes the per-tile in-order blend kernel.
        # A SINGLE blended draw whose shader is not kernel-safe keeps the
        # winner-resolve + dense shade+blend path (correct unless its own
        # geometry self-overlaps).
        fs = pipeline.fragment_shader
        if fs is not None and fs.kernel_safe:
            if len(colors) != 1:
                raise ValueError("blend batch: exactly one color attachment")
            return _draw_batch_blend(
                colors, depth, pipeline, draws, grid, viewport=viewport,
                entry_budget=entry_budget, budget_scale=budget_scale, stencil=stencil,
            )
        if n_draws > 1:
            raise ValueError(
                "draw_indexed_batch with blending across multiple draws needs a "
                "KERNEL-SAFE fragment shader (Shader.fragment(..., kernel_safe=True, "
                "device_source=...): pure elementwise torch, no texture sampling) — the "
                "blend runs per fragment in submission order inside the raster kernel — "
                "or peel_layers=K for depth-peeled full-fragment-rate translucency "
                "(texture sampling allowed; exact for ≤K layers). Alternatively submit "
                "blended draws individually (one full-screen shade+blend per draw)."
            )

    uniforms_in_records = n_draws > 8 and bool(per_draw_uniforms)
    all_specs, attr_layout = _batch_records(
        pipeline, draws, grid, viewport,
        tuple(per_draw_uniforms) if uniforms_in_records else ())
    bins = _bin_spec_parts(all_specs, grid, entry_budget=entry_budget,
                           budget_scale=budget_scale)
    dev = draws[0][0].device
    samples = state.multisample.samples
    # Batched MSAA shades per sample in both sample_shading modes, as the
    # reference does (draw.py:1287-1294): colours (S, H, W, C), depth and
    # stencil (S, H, W), one raster (or peel chain) per standard position.
    offsets = _sample_offsets(samples) if samples > 1 else ((0.5, 0.5),)

    def shade_layer(z_out, acc, dst_colors):
        return _shade_batch(dst_colors, z_out, acc, attr_layout, pipeline, draws,
                            per_draw_uniforms, uniforms_in_records)

    if peel:
        # Depth peeling (Everitt 2001): peel k rejects fragments at or before
        # peel k-1's depth, so each pass resolves the next-nearest layer.
        peel_kw = dict(_raster_state(ds, rast_state), depth_test=True, depth_write=True)

        def peel_chain(init_z, dst, off):
            layers = []
            bound = None
            for _ in range(int(peel_layers)):
                z_k, acc_k = _raster_parts(bins, grid, init_z, z_bound=bound,
                                           sample_offset=off, **peel_kw)
                layers.append((z_k, acc_k))
                bound = z_k
            # Overflow probe: one more bounded pass, depth write off; any
            # surviving fragment is a dropped (K+1)-th layer. The count stays
            # a device tensor (no host read).
            _, acc_over = _raster_parts(bins, grid, init_z, z_bound=bound, sample_offset=off,
                                        **dict(peel_kw, depth_write=False))
            over = (acc_over[-1] > 0.0).sum().to(torch.int32)
            for z_k, acc_k in reversed(layers):
                dst = shade_layer(z_k, acc_k, [dst])[0]
            return dst, layers[0][0], over

        out_c, out_z = [], []
        over_total = bins.overflow
        for s, off in enumerate(offsets):
            init_z = _plane_at(depth, s, samples)
            c_s, z_s, over = peel_chain(init_z if init_z is not None else _zero_depth(grid, dev),
                                        _plane_at(colors[0], s, samples), off)
            out_c.append(c_s)
            out_z.append(z_s)
            over_total = over_total + over
        new_depth = depth
        if depth is not None and ds.depth_write_enable:
            new_depth = _join_samples(out_z, samples)
        return [_join_samples(out_c, samples)], new_depth, DrawStats(bin_overflow=over_total)

    out_colors = [[] for _ in colors]
    out_z, out_s = [], []
    for s, off in enumerate(offsets):
        init_z = _plane_at(depth, s, samples)
        z_s, acc_s, st_s = _raster_one(
            bins, grid, ds, rast_state,
            init_z if init_z is not None else _zero_depth(grid, dev),
            _plane_at(stencil, s, samples), off)
        for i, c in enumerate(shade_layer(z_s, acc_s, [_plane_at(c, s, samples) for c in colors])):
            out_colors[i].append(c)
        out_z.append(z_s)
        if st_s is not None:
            out_s.append(st_s)
    new_depth = _join_samples(out_z, samples) if depth is not None else None
    return ([_join_samples(cs, samples) for cs in out_colors], new_depth,
            DrawStats(bin_overflow=bins.overflow, stencil=_join_samples(out_s, samples)))


def make_shade_blend(fs, attr_layout, cdesc: ColorAttachmentDesc, constants, full_res):
    """The plain version's per-fragment shader + blend step for
    raster_segmented_blend (draw.py:1492-1528): finalize the interpolated
    planes (divide by the interpolated 1/w), split them into varyings,
    uniforms (``__u_`` columns), ``__front`` and ``__draw_id``, run the
    fragment shader, apply the blend equation and keep the result where the
    fragment passed."""

    def shade_blend(planes, passed, x, y, zpx, color):
        iw = planes[:, -1]
        ok = iw > 0.0
        inv = torch.where(ok, 1.0 / torch.where(ok, iw, torch.ones_like(iw)),
                          torch.zeros_like(iw))
        varyings = {}
        res_vals = {}
        front = None
        draw_id = None
        off = 0
        for name, ch in attr_layout:
            img = (planes[:, off:off + ch] * inv[:, None]).movedim(1, -1)
            if name == "__front":
                front = img[..., 0] > 0.5
            elif name == "__draw_id":
                draw_id = img[..., 0]
            elif name.startswith("__u_"):
                res_vals[name[4:]] = img
            else:
                varyings[name] = img
            off += ch
        builtins = FragmentBuiltins(
            frag_coord=torch.stack([x, y], dim=-1),
            depth=zpx,
            front_facing=front if front is not None else passed,
            resolution=full_res,
            draw_id=draw_id,
        )
        src = fs.fn(varyings, BoundResources(fs.reflection, res_vals), builtins)
        out = blend_ops.blend_colors(color, src, cdesc, constants)
        return torch.where(passed[..., None], out, color)

    return shade_blend


def _draw_batch_blend(colors, depth, pipeline, draws, grid, viewport=None,
                      entry_budget=None, budget_scale=1, stencil=None):
    """Order-correct transparency for batched draws (draw.py:1331-1583): one
    binning over every draw's records, then the per-tile in-order blend
    kernel (K5; K6 when the pipeline enables the stencil test), which shades
    and blends each passing fragment in submission order.

    Every fragment binding rides the records as constant varying columns, so
    per-draw uniforms need no draw-id select. The fragment shader must be
    kernel-safe (elementwise only); on CUDA tensors it runs as its device
    source inside the kernel, on CPU tensors as its torch function. Texture
    content can still reach it by sampling in the vertex stage and
    interpolating the sampled colour (the textured glass pipeline does)."""
    state = pipeline.desc.state
    rast_state = state.rasterization
    ds = state.depth_stencil
    fs = pipeline.fragment_shader

    all_specs, attr_layout = _batch_records(
        pipeline, draws, grid, viewport, tuple(fs.reflection.binding_names()),
        require_uniforms=True)
    bins = _bin_spec_parts(all_specs, grid, entry_budget=entry_budget,
                           budget_scale=budget_scale)
    cdesc = (pipeline.desc.color_attachment_descs or (ColorAttachmentDesc(),))[0]
    shade_blend = make_shade_blend(fs, attr_layout, cdesc, state.color_blend.blend_constants,
                                   (grid.width, grid.height))
    dev = draws[0][0].device

    def blend_parts(z_p, c_p, s_p, off):
        # The in-order blend carries its state in the planes, so the
        # sequential bin parts compose exactly.
        for b in bins.parts:
            out = raster_segmented_blend(
                b, grid, z_p, c_p, shade_blend, init_stencil=s_p,
                stencil_front=ds.stencil_front if s_p is not None else None,
                stencil_back=ds.stencil_back if s_p is not None else None,
                sample_offset=off, fragment_shader=fs, attr_layout=attr_layout,
                color_desc=cdesc, **_raster_state(ds, rast_state))
            if s_p is not None:
                z_p, c_p, s_p = out
            else:
                z_p, c_p = out
        return z_p, c_p, s_p

    samples = state.multisample.samples
    # MSAA runs one in-order blend pass per standard sample position; the
    # fragment shader runs per fragment inside it, so shading is per sample
    # in both sample_shading modes (draw.py:1536-1569).
    offsets = _sample_offsets(samples) if samples > 1 else ((0.5, 0.5),)
    out_z, out_c, out_s = [], [], []
    for s, off in enumerate(offsets):
        z_p = _plane_at(depth, s, samples)
        s_p = None
        if ds.stencil_test_enable:
            s_p = _plane_at(stencil, s, samples)
            if s_p is None:
                s_p = _default_stencil(ds, grid, dev)
        z_p, c_p, s_p = blend_parts(z_p if z_p is not None else _zero_depth(grid, dev),
                                    _plane_at(colors[0], s, samples), s_p, off)
        out_z.append(z_p)
        out_c.append(c_p)
        if s_p is not None:
            out_s.append(s_p)
    new_depth = _join_samples(out_z, samples) if depth is not None else None
    return ([_join_samples(out_c, samples)], new_depth,
            DrawStats(bin_overflow=bins.overflow, stencil=_join_samples(out_s, samples)))


def _shade_batch(colors, z_out, acc, attr_layout, pipeline, draws, per_draw_uniforms,
                 uniforms_in_records):
    """Varying finalize → fragment shader (with per-draw uniform planes and
    the draw id) → output merger for a batched draw (draw.py:1140-1205)."""
    varyings, mask, builtins = shade.finalize_attrs(z_out, acc, attr_layout)
    draw_id = varyings.pop("__draw_id", None)
    fs = pipeline.fragment_shader
    if fs is None:
        return list(colors)
    fs_resources: Dict[str, Any] = {}
    if uniforms_in_records:
        for uname in per_draw_uniforms:
            fs_resources[uname] = varyings.pop(f"__u_{uname}")
    for name in fs.reflection.binding_names():
        if name in fs_resources:
            continue
        if name in per_draw_uniforms and not uniforms_in_records:
            # (N, C) per-draw table → (H, W, C) plane by draw-id selection.
            table = [torch.as_tensor(d[2][name], dtype=torch.float32,
                                     device=z_out.device).reshape(-1) for d in draws]
            widths = {int(t.shape[0]) for t in table}
            if len(widths) != 1:
                raise ValueError(
                    f"per-draw uniform '{name}': draws disagree on width "
                    f"({sorted(widths)}) — all draws in a batch must bind the "
                    f"same-shaped value"
                )
            plane = table[0][None, None, :].expand(draw_id.shape[:2] + (table[0].shape[0],))
            for i in range(1, len(draws)):
                sel = (torch.abs(draw_id[..., 0] - i) < 0.5)[..., None]
                plane = torch.where(sel, table[i][None, None, :], plane)
            fs_resources[name] = plane
        else:
            vals = [d[2].get(name) for d in draws]
            if all(v is vals[0] for v in vals):
                fs_resources[name] = vals[0]
            else:
                fs_resources[name] = PerDraw(vals)
    if draw_id is not None:
        builtins = _dc_replace(builtins, draw_id=draw_id[..., 0])
    return _shade_and_blend(colors, varyings, mask, builtins, pipeline, fs_resources)
