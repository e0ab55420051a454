"""Fixed-function pipeline state model.

Mirrors the reference's pipeline state descs (zenith-rhi/src/pipeline.rs:18-920):
every desc is a frozen, hashable dataclass so the full `GraphicPipelineDesc`
can key the pipeline cache — in this framework that cache key is also part
of the render graph's frame-function key: identical descs ⇒ identical frame
function.

Where Vulkan executes this state in fixed-function hardware, here it is
*interpreted by the rasterizer ops* (zenith_tpu_torch.ops): CullMode/FrontFace in
triangle setup, CompareOp in the depth kernel, Blend* in the color write,
Load/Store ops in how the render graph threads attachment arrays through
nodes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

from zenith_tpu_torch.core.collections import FastEnum, cached_hash
from zenith_tpu_torch.rhi.formats import Format


class LoadOp(FastEnum):
    LOAD = "load"
    CLEAR = "clear"
    DONT_CARE = "dont_care"


class StoreOp(FastEnum):
    STORE = "store"
    DONT_CARE = "dont_care"


class CompareOp(FastEnum):
    NEVER = "never"
    LESS = "less"
    EQUAL = "equal"
    LESS_OR_EQUAL = "less_or_equal"
    GREATER = "greater"
    NOT_EQUAL = "not_equal"
    GREATER_OR_EQUAL = "greater_or_equal"
    ALWAYS = "always"


class BlendFactor(FastEnum):
    ZERO = "zero"
    ONE = "one"
    SRC_COLOR = "src_color"
    ONE_MINUS_SRC_COLOR = "one_minus_src_color"
    DST_COLOR = "dst_color"
    ONE_MINUS_DST_COLOR = "one_minus_dst_color"
    SRC_ALPHA = "src_alpha"
    ONE_MINUS_SRC_ALPHA = "one_minus_src_alpha"
    DST_ALPHA = "dst_alpha"
    ONE_MINUS_DST_ALPHA = "one_minus_dst_alpha"


class BlendOp(FastEnum):
    ADD = "add"
    SUBTRACT = "subtract"
    REVERSE_SUBTRACT = "reverse_subtract"
    MIN = "min"
    MAX = "max"


class CullMode(FastEnum):
    NONE = "none"
    FRONT = "front"
    BACK = "back"


class FrontFace(FastEnum):
    COUNTER_CLOCKWISE = "ccw"
    CLOCKWISE = "cw"


class PolygonMode(FastEnum):
    """vk::PolygonMode (the reference passes it straight through,
    pipeline.rs:510,570). LINE renders each polygon's edges as
    ``line_width``-wide lines (wireframe); POINT renders its vertices as
    points. Both cull by the polygon's facing first (Vulkan 27.7.1)."""

    FILL = "fill"
    LINE = "line"
    POINT = "point"


class PrimitiveTopology(FastEnum):
    """vk::PrimitiveTopology subset: list/strip for triangles and lines,
    plus points. Lines and points rasterize as screen-space quads on the
    triangle raster path (ops.geometry.setup_lines/points_with_attrs)."""

    TRIANGLE_LIST = "triangle_list"
    TRIANGLE_STRIP = "triangle_strip"
    LINE_LIST = "line_list"
    LINE_STRIP = "line_strip"
    POINT_LIST = "point_list"


@cached_hash
@dataclass(frozen=True)
class ColorAttachmentDesc:
    """Per-color-attachment blend + load/store + clear state
    (reference pipeline.rs:337-412; defaults at pipeline.rs:355-370)."""

    blend_enable: bool = False
    src_color_blend: BlendFactor = BlendFactor.ONE
    dst_color_blend: BlendFactor = BlendFactor.ZERO
    color_blend_op: BlendOp = BlendOp.ADD
    src_alpha_blend: BlendFactor = BlendFactor.ONE
    dst_alpha_blend: BlendFactor = BlendFactor.ZERO
    alpha_blend_op: BlendOp = BlendOp.ADD
    write_mask: Tuple[bool, bool, bool, bool] = (True, True, True, True)
    load_op: LoadOp = LoadOp.CLEAR
    store_op: StoreOp = StoreOp.STORE
    clear_value: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)

    # Builder-style helpers matching the reference (pipeline.rs:388-412).
    def clear_input(self, clear_value=None) -> "ColorAttachmentDesc":
        out = replace(self, load_op=LoadOp.CLEAR)
        if clear_value is not None:
            out = replace(out, clear_value=tuple(float(c) for c in clear_value))
        return out

    def discard_input(self) -> "ColorAttachmentDesc":
        return replace(self, load_op=LoadOp.DONT_CARE)

    def load_input(self) -> "ColorAttachmentDesc":
        return replace(self, load_op=LoadOp.LOAD)

    def discard_output(self) -> "ColorAttachmentDesc":
        return replace(self, store_op=StoreOp.DONT_CARE)

    def translucent(self) -> "ColorAttachmentDesc":
        """Standard src-alpha blending preset (pipeline.rs:404-412)."""
        return replace(
            self,
            blend_enable=True,
            src_color_blend=BlendFactor.SRC_ALPHA,
            dst_color_blend=BlendFactor.DST_ALPHA,
            color_blend_op=BlendOp.ADD,
            src_alpha_blend=BlendFactor.ZERO,
            dst_alpha_blend=BlendFactor.SRC_ALPHA,
        )


class StencilOp(FastEnum):
    """(VkStencilOp, consumed via reference pipeline.rs:426-433)"""

    KEEP = "keep"
    ZERO = "zero"
    REPLACE = "replace"
    INCREMENT_AND_CLAMP = "increment_and_clamp"
    DECREMENT_AND_CLAMP = "decrement_and_clamp"
    INVERT = "invert"
    INCREMENT_AND_WRAP = "increment_and_wrap"
    DECREMENT_AND_WRAP = "decrement_and_wrap"


@cached_hash
@dataclass(frozen=True)
class StencilOpState:
    """Per-face stencil state (vk::StencilOpState; referenced by
    DepthStencilDesc.stencil_front/back, pipeline.rs:427-428).

    The test is ``compare_op(reference & compare_mask,
    stored & compare_mask)``; writes are masked by ``write_mask``.
    """

    fail_op: StencilOp = StencilOp.KEEP
    pass_op: StencilOp = StencilOp.KEEP
    depth_fail_op: StencilOp = StencilOp.KEEP
    compare_op: CompareOp = CompareOp.NEVER
    compare_mask: int = 0xFF
    write_mask: int = 0xFF
    reference: int = 0

    def writes(self) -> bool:
        """Whether this face state can modify the stencil buffer."""
        return self.write_mask != 0 and not (
            self.fail_op == StencilOp.KEEP
            and self.pass_op == StencilOp.KEEP
            and self.depth_fail_op == StencilOp.KEEP
        )


@cached_hash
@dataclass(frozen=True)
class DepthStencilDesc:
    """Depth + stencil test/write state (reference pipeline.rs:414-480;
    defaults at pipeline.rs:436-453). Note the reference defaults to
    CompareOp::LESS — with the reverse-Z camera, passes that want depth
    enable GREATER."""

    depth_test_enable: bool = False
    depth_write_enable: bool = False
    depth_compare_op: CompareOp = CompareOp.LESS
    depth_bounds_test_enable: bool = False
    depth_load_op: LoadOp = LoadOp.CLEAR
    depth_store_op: StoreOp = StoreOp.STORE
    depth_clear_value: float = 1.0

    stencil_test_enable: bool = False
    stencil_front: StencilOpState = field(default_factory=StencilOpState)
    stencil_back: StencilOpState = field(default_factory=StencilOpState)
    stencil_load_op: LoadOp = LoadOp.DONT_CARE
    stencil_store_op: StoreOp = StoreOp.DONT_CARE
    stencil_clear_value: int = 0

    @property
    def test_enabled(self) -> bool:
        # (pipeline.rs:462-464)
        return self.depth_test_enable or self.stencil_test_enable

    def reverse_z(self) -> "DepthStencilDesc":
        """Preset for the engine's infinite-reverse-Z convention: test+write
        enabled, GREATER compare, clear to 0.0 (far)."""
        return replace(
            self,
            depth_test_enable=True,
            depth_write_enable=True,
            depth_compare_op=CompareOp.GREATER,
            depth_clear_value=0.0,
        )

    def stencil_write(self, reference: int = 1) -> "DepthStencilDesc":
        """Preset: unconditionally mark covered pixels with ``reference``
        (both faces: ALWAYS pass, REPLACE on pass)."""
        op = StencilOpState(
            pass_op=StencilOp.REPLACE,
            compare_op=CompareOp.ALWAYS,
            reference=reference,
        )
        return replace(
            self,
            stencil_test_enable=True,
            stencil_front=op,
            stencil_back=op,
            stencil_load_op=LoadOp.CLEAR,
            stencil_store_op=StoreOp.STORE,
        )

    def stencil_mask(
        self, reference: int = 1, compare_op: CompareOp = CompareOp.EQUAL
    ) -> "DepthStencilDesc":
        """Preset: draw only where stored stencil compares against
        ``reference`` (both faces; stencil buffer unmodified)."""
        op = StencilOpState(compare_op=compare_op, reference=reference)
        return replace(
            self,
            stencil_test_enable=True,
            stencil_front=op,
            stencil_back=op,
            stencil_load_op=LoadOp.LOAD,
            stencil_store_op=StoreOp.STORE,
        )


@cached_hash
@dataclass(frozen=True)
class InputAssemblyState:
    """(reference pipeline.rs:483-506)"""

    topology: PrimitiveTopology = PrimitiveTopology.TRIANGLE_LIST
    primitive_restart: bool = False


@cached_hash
@dataclass(frozen=True)
class RasterizationState:
    """(reference pipeline.rs:508-586; defaults cull=BACK, front=CCW)"""

    polygon_mode: PolygonMode = PolygonMode.FILL
    cull_mode: CullMode = CullMode.BACK
    front_face: FrontFace = FrontFace.COUNTER_CLOCKWISE
    depth_clamp: bool = False
    depth_bias_enable: bool = False
    depth_bias_constant: float = 0.0
    depth_bias_slope: float = 0.0
    line_width: float = 1.0


@cached_hash
@dataclass(frozen=True)
class MultisampleState:
    """(reference pipeline.rs:589-615). 1/2/4/8 samples (Vulkan standard
    sample positions); the rasterizer keeps per-sample planes and the graph
    persists them across same-sample-count nodes.

    ``sample_shading`` mirrors vk sampleShadingEnable: True (this
    framework's default) shades at EVERY sample position — supersampling-
    grade quality. False is the GPU-default cost model: per-sample
    visibility/depth, but the fragment shader runs ONCE per pixel at the
    pixel center and broadcasts to covered samples — shading cost at 4×
    ≈ 1× non-MSAA, interior pixels bit-equal to the single-sample render.
    (Vulkan defaults to off; the quality-biased default here is deliberate
    and documented.)"""

    samples: int = 1
    sample_shading: bool = True


@cached_hash
@dataclass(frozen=True)
class ColorBlendState:
    """(reference pipeline.rs:618-704) — logic op unsupported; per-attachment
    blend lives in ColorAttachmentDesc."""

    blend_constants: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)


@cached_hash
@dataclass(frozen=True)
class GraphicPipelineState:
    """Complete fixed-function state (reference pipeline.rs:713-737)."""

    input_assembly: InputAssemblyState = field(default_factory=InputAssemblyState)
    rasterization: RasterizationState = field(default_factory=RasterizationState)
    multisample: MultisampleState = field(default_factory=MultisampleState)
    depth_stencil: DepthStencilDesc = field(default_factory=DepthStencilDesc)
    color_blend: ColorBlendState = field(default_factory=ColorBlendState)


@cached_hash
@dataclass(frozen=True)
class GraphicPipelineAttachments:
    """Attachment formats — part of the pipeline cache key (reference
    pipeline.rs:25-66)."""

    color_formats: Tuple[Format, ...] = ()
    depth_format: Optional[Format] = None
    stencil_format: Optional[Format] = None


@cached_hash
@dataclass(frozen=True)
class VertexAttribute:
    name: str
    components: int  # f32 component count (1..4)


@cached_hash
@dataclass(frozen=True)
class VertexLayout:
    """Vertex buffer layout: named float32 fields, tightly packed, binding 0
    (the analog of #[derive(VertexLayout)], zenith-rhi-derive/src/lib.rs:60-232;
    locations = field order, stride = sum of fields)."""

    attributes: Tuple[VertexAttribute, ...]

    @staticmethod
    def from_fields(*fields_: "tuple[str, int]") -> "VertexLayout":
        return VertexLayout(tuple(VertexAttribute(n, c) for n, c in fields_))

    @property
    def stride_floats(self) -> int:
        return sum(a.components for a in self.attributes)

    def field_slices(self) -> "dict[str, slice]":
        out: dict[str, slice] = {}
        off = 0
        for a in self.attributes:
            out[a.name] = slice(off, off + a.components)
            off += a.components
        return out

    def unpack(self, array):
        """Split an (N, stride) array into {name: (N, components)} views."""
        assert array.shape[-1] == self.stride_floats, (
            f"vertex buffer last dim {array.shape[-1]} != layout stride "
            f"{self.stride_floats}"
        )
        return {name: array[..., sl] for name, sl in self.field_slices().items()}
