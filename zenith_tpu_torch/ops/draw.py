"""The draw call: programmable + fixed-function pipeline for one draw or a
batch of draws (torch port of zenith_tpu/ops/draw.py: ``draw_indexed`` and
``draw_indexed_batch`` with their stencil, depth-peel and in-order blend
branches; single sample).

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

Not ported yet: multisampling (every ``samples > 1`` branch raises, ROADMAP
item 18) and line/point primitives (item 19).
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
               viewport, depth_bias):
    """Deferred geometry-part builders for one draw: a list of
    ``(est_records, build)``; triangle draws above MAX_PRIMS_PER_PART split
    into contiguous primitive ranges (draw.py:81-109)."""

    def make_build(pr):
        def build():
            return _setup_records(prim_kind, clip, pr, flat_vary, grid,
                                  rast_state, viewport, depth_bias)
        return build

    t = prims.shape[0]
    if t <= MAX_PRIMS_PER_PART:
        return [(2 * t, make_build(prims))]
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


def _msaa_unported() -> NotImplementedError:
    return NotImplementedError("MSAA is not ported yet (ROADMAP item 18: MSAA)")


def _default_stencil(ds, grid, device) -> torch.Tensor:
    """The stencil plane a draw starts from when none is attached."""
    return torch.full((grid.height, grid.width), ds.stencil_clear_value & 0xFF,
                      dtype=torch.int32, device=device)


def _raster_state(ds, rast_state) -> dict:
    """The depth state of a pipeline as raster_segmented's keywords."""
    return dict(depth_test=ds.depth_test_enable, depth_write=ds.depth_write_enable,
                compare_op=ds.depth_compare_op, depth_clamp=rast_state.depth_clamp)


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


def _assemble_primitives(index_buffer, ia: InputAssemblyState, polygon_mode: PolygonMode):
    """Primitive assembly dispatch → (kind, (P, 3) primitive indices). Only
    filled triangles are ported."""
    topo = ia.topology
    if topo in (PrimitiveTopology.LINE_LIST, PrimitiveTopology.LINE_STRIP,
                PrimitiveTopology.POINT_LIST) or polygon_mode != PolygonMode.FILL:
        raise NotImplementedError(
            "line/point topologies and LINE/POINT polygon modes are not "
            "ported yet (ROADMAP item 19: lines, points and polygon modes)"
        )
    return "tri", assemble_triangles(index_buffer, ia)


def _setup_records(kind, clip, prims, flat_vary, grid, rast_state, viewport, depth_bias):
    """Primitive setup → (TriangleRecords, corner_data)."""
    assert kind == "tri", kind
    return geometry.setup_with_attrs(
        clip, prims, flat_vary, grid.width, grid.height,
        cull_mode=rast_state.cull_mode, front_face=rast_state.front_face,
        viewport=viewport, depth_bias=depth_bias, depth_clamp=rast_state.depth_clamp,
    )


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
    """Run the vertex shader → (clip (N, 4), varyings, primitive indices).

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
    if vs_out.pop("point_size", None) is not None:
        raise NotImplementedError(
            "point_size is a point-primitive builtin (ROADMAP item 19)"
        )
    return clip, vs_out, indices


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
    if state.multisample.samples > 1:
        raise _msaa_unported()

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

    clip, vs_out, indices = _vertex_stage(
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
    )
    attr_layout.append(("__front", 1))

    # -- binning + raster ------------------------------------------------------
    bins = _bin_spec_parts(specs, grid, entry_budget=entry_budget,
                           budget_scale=budget_scale)
    if depth is not None:
        init_z = depth
    else:
        init_z = torch.zeros((grid.height, grid.width), dtype=torch.float32, device=clip.device)
    stencil_out = None
    if ds.stencil_test_enable:
        init_s = stencil if stencil is not None else _default_stencil(ds, grid, clip.device)
        z_out, acc, stencil_out = _raster_parts(
            bins, grid, init_z, init_stencil=init_s, stencil_front=ds.stencil_front,
            stencil_back=ds.stencil_back, **_raster_state(ds, rast_state))
    else:
        z_out, acc = _raster_parts(bins, grid, init_z, **_raster_state(ds, rast_state))

    varyings, mask, builtins = shade.finalize_attrs(z_out, acc, attr_layout)
    new_colors = _shade_and_blend(colors, varyings, mask, builtins, pipeline, resources)
    new_depth = z_out if depth is not None else None
    return new_colors, new_depth, DrawStats(bin_overflow=bins.overflow, stencil=stencil_out)


def _shade_and_blend(colors, varyings, mask, builtins, pipeline, resources):
    """Fragment shader → output merger for one sample, over finalized
    varyings."""
    state = pipeline.desc.state
    fs = pipeline.fragment_shader
    new_colors = list(colors)
    if fs is not None:
        fs_res = BoundResources(fs.reflection, resources)
        frag_out = fs.fn(varyings, fs_res, builtins)
        _warn_unused_bindings(fs, fs_res)
        frag_list = _normalize_frag_out(frag_out)
        descs = pipeline.desc.color_attachment_descs or tuple(
            None for _ in new_colors
        )
        if len(frag_list) != len(new_colors):
            raise ValueError(
                f"fragment shader wrote {len(frag_list)} outputs for "
                f"{len(new_colors)} color attachments"
            )
        for i, (dst, src) in enumerate(zip(new_colors, frag_list)):
            desc = descs[i] if descs[i] is not None else ColorAttachmentDesc()
            new_colors[i] = blend_ops.apply_color_output(
                dst, src, mask, desc, state.color_blend.blend_constants
            )
    return new_colors


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
        clip, vs_out, prims = _vertex_stage(
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
    if state.multisample.samples > 1:
        raise _msaa_unported()

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
    if depth is not None:
        init_z = depth
    else:
        init_z = torch.zeros((grid.height, grid.width), dtype=torch.float32, device=dev)
    raster_kw = _raster_state(ds, rast_state)

    def shade_layer(z_out, acc, dst_colors):
        return _shade_batch(dst_colors, z_out, acc, attr_layout, pipeline, draws,
                            per_draw_uniforms, uniforms_in_records)

    if peel:
        # Depth peeling (Everitt 2001): peel k rejects fragments at or before
        # peel k-1's depth, so each pass resolves the next-nearest layer.
        peel_kw = dict(raster_kw, depth_test=True, depth_write=True)
        layers = []
        bound = None
        for _ in range(int(peel_layers)):
            z_k, acc_k = _raster_parts(bins, grid, init_z, z_bound=bound, **peel_kw)
            layers.append((z_k, acc_k))
            bound = z_k
        # Overflow probe: one more bounded pass, depth write off; any
        # surviving fragment is a dropped (K+1)-th layer. The count stays a
        # device tensor (no host read).
        _, acc_over = _raster_parts(bins, grid, init_z, z_bound=bound,
                                    **dict(peel_kw, depth_write=False))
        over = (acc_over[-1] > 0.0).sum().to(torch.int32)
        dst = colors[0]
        for z_k, acc_k in reversed(layers):
            dst = shade_layer(z_k, acc_k, [dst])[0]
        new_depth = None
        if depth is not None:
            new_depth = layers[0][0] if ds.depth_write_enable else depth
        return [dst], new_depth, DrawStats(bin_overflow=bins.overflow + over)

    stencil_out = None
    if ds.stencil_test_enable:
        init_s = stencil if stencil is not None else _default_stencil(ds, grid, dev)
        z_out, acc, stencil_out = _raster_parts(
            bins, grid, init_z, init_stencil=init_s, stencil_front=ds.stencil_front,
            stencil_back=ds.stencil_back, **raster_kw)
    else:
        z_out, acc = _raster_parts(bins, grid, init_z, **raster_kw)
    new_colors = shade_layer(z_out, acc, colors)
    new_depth = z_out if depth is not None else None
    return new_colors, new_depth, DrawStats(bin_overflow=bins.overflow, stencil=stencil_out)


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
    if state.multisample.samples > 1:
        raise _msaa_unported()

    all_specs, attr_layout = _batch_records(
        pipeline, draws, grid, viewport, tuple(fs.reflection.binding_names()),
        require_uniforms=True)
    bins = _bin_spec_parts(all_specs, grid, entry_budget=entry_budget,
                           budget_scale=budget_scale)
    cdesc = (pipeline.desc.color_attachment_descs or (ColorAttachmentDesc(),))[0]
    shade_blend = make_shade_blend(fs, attr_layout, cdesc, state.color_blend.blend_constants,
                                   (grid.width, grid.height))

    dev = draws[0][0].device
    z_p = depth if depth is not None else torch.zeros(
        (grid.height, grid.width), dtype=torch.float32, device=dev)
    c_p = colors[0]
    s_p = None
    if ds.stencil_test_enable:
        s_p = stencil if stencil is not None else _default_stencil(ds, grid, dev)
    # The in-order blend carries its state in the planes, so the sequential
    # bin parts compose exactly.
    for b in bins.parts:
        out = raster_segmented_blend(
            b, grid, z_p, c_p, shade_blend, init_stencil=s_p,
            stencil_front=ds.stencil_front if s_p is not None else None,
            stencil_back=ds.stencil_back if s_p is not None else None,
            fragment_shader=fs, attr_layout=attr_layout, color_desc=cdesc,
            **_raster_state(ds, rast_state))
        if s_p is not None:
            z_p, c_p, s_p = out
        else:
            z_p, c_p = out
    new_depth = z_p if depth is not None else None
    return [c_p], new_depth, DrawStats(bin_overflow=bins.overflow, stencil=s_p)


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
