"""Graphics pipeline objects + cache.

Mirrors zenith-rhi/src/pipeline.rs:922-1122 and pipeline_cache.rs. A
`GraphicPipelineDesc` — shaders + vertex layout + fixed-function state +
attachment formats — is the hashable key; `GraphicPipeline` is the "compiled"
object: it validates the vertex layout against shader needs (the analog of
validate_vertex_inputs, pipeline.rs:228-287), merges stage reflection for the
binder, and carries everything the rasterizer ops need to trace a draw.

PyTorch runs the draw eagerly; the hand-written kernels are built once per
process (ops.runtime). `PipelineCache` mirrors pipeline_cache.rs:19-113 (hit/miss
stats; get_or_create keyed by desc).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from zenith_tpu_torch.core import log
from zenith_tpu_torch.core.collections import cached_hash
from zenith_tpu_torch.rhi.shader import BindingError, Shader, ShaderReflection, ShaderStage
from zenith_tpu_torch.rhi.state import (
    ColorAttachmentDesc,
    DepthStencilDesc,
    GraphicPipelineAttachments,
    GraphicPipelineState,
    VertexLayout,
)

logger = log.get(__name__)


@dataclass(frozen=True)
class GraphicShaderInput:
    """VS + optional FS + vertex layout (reference pipeline.rs:137-287).

    Hash/eq use shader object identity — see Shader docstring for why that
    is the right cache-key behavior.
    """

    vertex_shader: Shader
    fragment_shader: Optional[Shader] = None
    vertex_layout: Optional[VertexLayout] = None

    def __hash__(self) -> int:
        h = self.__dict__.get("_zh_")
        if h is None:
            h = hash((id(self.vertex_shader), id(self.fragment_shader),
                      self.vertex_layout))
            object.__setattr__(self, "_zh_", h)
        return h

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, GraphicShaderInput)
            and self.vertex_shader is other.vertex_shader
            and self.fragment_shader is other.fragment_shader
            and self.vertex_layout == other.vertex_layout
        )

    def merged_reflection(self) -> ShaderReflection:
        refl = self.vertex_shader.reflection
        if self.fragment_shader is not None:
            refl = refl.merge(self.fragment_shader.reflection)
        return refl


@cached_hash
@dataclass(frozen=True)
class GraphicPipelineDesc:
    """The full pipeline cache key (reference pipeline.rs:900-920)."""

    shader_input: GraphicShaderInput
    state: GraphicPipelineState
    attachments: GraphicPipelineAttachments
    color_attachment_descs: Tuple[ColorAttachmentDesc, ...] = ()
    depth_attachment_desc: Optional[DepthStencilDesc] = None


# Desc interning: the AttachmentBinder finalizes a fresh GraphicPipelineDesc
# every frame (the graph is rebuilt per frame, engine.rs:93-102), but the
# contents recur — interning returns THE canonical instance so downstream
# hashing (frame-program structure key, pipeline cache probe) hits the
# per-instance hash memo and tuple-equality identity fast paths. Bounded
# like a pipeline cache would be: render loops create a finite desc set.
_DESC_INTERN: "dict[GraphicPipelineDesc, GraphicPipelineDesc]" = {}
_DESC_INTERN_MAX = 4096


def intern_desc(desc: GraphicPipelineDesc) -> GraphicPipelineDesc:
    got = _DESC_INTERN.get(desc)
    if got is not None:
        return got
    if len(_DESC_INTERN) >= _DESC_INTERN_MAX:
        _DESC_INTERN.clear()  # rare; next frames re-intern the live set
    _DESC_INTERN[desc] = desc
    return desc


class GraphicPipeline:
    """A validated, ready-to-trace pipeline (reference CommonPipeline /
    GraphicPipeline, pipeline.rs:922-1122)."""

    def __init__(self, desc: GraphicPipelineDesc):
        self.desc = desc
        self.reflection = desc.shader_input.merged_reflection()
        self._validate()

    def _validate(self) -> None:
        si = self.desc.shader_input
        if si.vertex_shader.stage != ShaderStage.VERTEX:
            raise BindingError(
                f"vertex_shader {si.vertex_shader.name!r} has stage "
                f"{si.vertex_shader.stage}"
            )
        if si.fragment_shader is not None and si.fragment_shader.stage != ShaderStage.FRAGMENT:
            raise BindingError(
                f"fragment_shader {si.fragment_shader.name!r} has stage "
                f"{si.fragment_shader.stage}"
            )
        self._validate_vertex_inputs()
        n_colors = len(self.desc.attachments.color_formats)
        n_descs = len(self.desc.color_attachment_descs)
        if n_descs and n_descs != n_colors:
            raise ValueError(
                f"{n_descs} color attachment descs for {n_colors} color formats"
            )
        ds = self.desc.state.depth_stencil
        if ds.depth_test_enable and self.desc.attachments.depth_format is None:
            raise ValueError(
                "depth test enabled but pipeline has no depth attachment format"
            )
        if ds.stencil_test_enable and self.desc.attachments.stencil_format is None:
            raise ValueError(
                "stencil test enabled but pipeline has no stencil attachment "
                "format (set GraphicPipelineAttachments.stencil_format)"
            )
        # Declared-but-unimplemented state must raise, not silently no-op
        # (the depth-test-without-format check above sets the precedent).
        ms = self.desc.state.multisample
        if ms.samples not in (1, 2, 4, 8):
            raise NotImplementedError(
                f"multisampling supports 1/2/4/8 samples (Vulkan standard "
                f"sample positions), got samples={ms.samples}"
            )

    def _validate_vertex_inputs(self) -> None:
        """Reject vertex-layout/shader mismatches at pipeline build — the
        analog of the reference's validate_vertex_inputs
        (zenith-rhi/src/pipeline.rs:228-287), which checks the derive-macro
        layout against SPIR-V-reflected inputs. Shaders that declare no
        ``inputs`` skip this (a missing attribute then surfaces at draw
        time); per_instance inputs are validated at draw time against
        ``instance_data`` instead of the layout."""
        si = self.desc.shader_input
        declared = si.vertex_shader.vertex_inputs
        if declared is None:
            return
        per_vertex = [d for d in declared if not d.per_instance]
        layout = si.vertex_layout
        if layout is None:
            if per_vertex:
                raise BindingError(
                    f"pipeline with vertex shader {si.vertex_shader.name!r}: "
                    f"shader declares vertex inputs "
                    f"{[d.name for d in per_vertex]} but the pipeline has no "
                    f"vertex layout"
                )
            return
        provided = {a.name: a.components for a in layout.attributes}
        for d in per_vertex:
            got = provided.get(d.name)
            if got is None:
                raise BindingError(
                    f"pipeline with vertex shader {si.vertex_shader.name!r}: "
                    f"shader input '{d.name}' ({d.components} components) is "
                    f"not provided by the vertex layout "
                    f"(layout attributes: {sorted(provided)})"
                )
            if got != d.components:
                raise BindingError(
                    f"pipeline with vertex shader {si.vertex_shader.name!r}: "
                    f"shader input '{d.name}' wants {d.components} "
                    f"components but the vertex layout provides {got}"
                )
        # Extra layout attributes are fine (the reference also allows
        # unconsumed attributes; the GPU simply never fetches them).

    @property
    def vertex_shader(self) -> Shader:
        return self.desc.shader_input.vertex_shader

    @property
    def fragment_shader(self) -> Optional[Shader]:
        return self.desc.shader_input.fragment_shader

    @property
    def vertex_layout(self) -> Optional[VertexLayout]:
        return self.desc.shader_input.vertex_layout


@dataclass
class PipelineCacheStats:
    """(reference pipeline_cache.rs:12-15)"""

    hits: int = 0
    misses: int = 0

    @property
    def size_queries(self) -> int:
        return self.hits + self.misses


class PipelineCache:
    """Desc-keyed pipeline cache (reference pipeline_cache.rs:19-113).

    The vk::PipelineCache blob has no analog: kernels are built once into
    the package's build directory (ops.runtime.load_kernels).
    """

    def __init__(self) -> None:
        self._pipelines: dict[GraphicPipelineDesc, GraphicPipeline] = {}
        self.stats = PipelineCacheStats()

    def get_or_create(self, desc: GraphicPipelineDesc) -> GraphicPipeline:
        pipe = self._pipelines.get(desc)
        if pipe is not None:
            self.stats.hits += 1
            return pipe
        self.stats.misses += 1
        pipe = GraphicPipeline(desc)
        self._pipelines[desc] = pipe
        logger.debug("pipeline cache miss → created pipeline #%d", len(self._pipelines))
        return pipe

    def __len__(self) -> int:
        return len(self._pipelines)
