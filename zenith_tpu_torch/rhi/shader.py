"""Shaders as Python functions + reflection registry.

In the reference, shaders are Slang source compiled to SPIR-V by an external
`slangc` process, then *reflected* to recover descriptor bindings and vertex
inputs (zenith-rhi/src/shader.rs:296-748). Here a shader **is** a Python
function over torch tensors, run eagerly per draw — and reflection is an
explicit, checkable declaration of the resources the function consumes, so
the name-based descriptor binder (descriptor.rs:298-456) keeps its
type-checked behavior.

Shader function contracts (enforced by the rasterizer pipeline):

Vertex stage — runs densely over all vertices (MXU/VPU friendly):

    def vs(attrs: dict[str, torch.Tensor], res: BoundResources) -> dict:
        # attrs[name]: (N, C) float32 per vertex-layout field
        # must return {"position": (N, 4) clip-space, **varyings: (N, C)}

Fragment stage — runs densely over all pixels after visibility resolution:

    def fs(varyings: dict[str, torch.Tensor], res: BoundResources,
           builtins: FragmentBuiltins) -> torch.Tensor | dict[str, torch.Tensor]:
        # varyings[name]: (..., C) perspective-correct interpolated
        # returns (..., 4) linear color, or {attachment_name: color} for MRT

Both stages are plain torch ops on tensors of the draw's device.
"""

from __future__ import annotations

import enum

from zenith_tpu_torch.core.collections import FastEnum, FastFlag
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple


class ShaderStage(FastFlag):
    """(reference shader.rs ShaderStage)"""

    VERTEX = enum.auto()
    FRAGMENT = enum.auto()
    COMPUTE = enum.auto()


class BindingKind(FastEnum):
    """(reference shader.rs ShaderBinding descriptor types + push constants,
    shader.rs:380-413)"""

    UNIFORM_BUFFER = "uniform_buffer"
    STORAGE_BUFFER = "storage_buffer"
    SAMPLED_TEXTURE = "sampled_texture"
    SAMPLER = "sampler"
    PUSH_CONSTANT = "push_constant"


@dataclass(frozen=True)
class ShaderBinding:
    """A named resource slot (reference shader.rs ShaderBinding; set/binding
    indices kept for parity though name-based lookup is canonical)."""

    name: str
    kind: BindingKind
    set_index: int = 0
    binding_index: int = 0


class BindingError(Exception):
    """(reference descriptor.rs BindingError) raised on unknown names or
    kind mismatches at bind time."""


@dataclass(frozen=True)
class VertexInput:
    """One vertex attribute a vertex shader consumes — the analog of the
    reference's SPIR-V-reflected ``VertexInputAttr`` (location, vk::Format)
    (zenith-rhi/src/shader.rs:446-748). Here the declaration is explicit
    (shaders are Python functions; there is no bytecode to reflect), checked
    against the pipeline's VertexLayout at pipeline build time
    (pipeline.rs:228-287).

    ``per_instance`` marks an instance-rate attribute (Vulkan
    VK_VERTEX_INPUT_RATE_INSTANCE): it is supplied via ``instance_data`` at
    draw time rather than by the vertex layout, and validated there.
    """

    name: str
    components: int  # f32 component count (1..4)
    per_instance: bool = False


def attr(name: str, components: int, per_instance: bool = False) -> VertexInput:
    """Declare a vertex-shader input (see VertexInput)."""
    return VertexInput(name, components, per_instance)


@dataclass(frozen=True)
class ShaderReflection:
    """Binding table for one or more stages (reference shader.rs:222-259)."""

    bindings: Tuple[ShaderBinding, ...] = ()
    stages: ShaderStage = ShaderStage.VERTEX

    def binding_names(self) -> "tuple[str, ...]":
        return tuple(b.name for b in self.bindings)

    def find(self, name: str) -> Optional[ShaderBinding]:
        for b in self.bindings:
            if b.name == name:
                return b
        return None

    def merge(self, other: "ShaderReflection") -> "ShaderReflection":
        """Union bindings across stages by name, checking kind consistency
        (reference shader.rs:222-259 merges by (set, binding))."""
        merged: dict[str, ShaderBinding] = {b.name: b for b in self.bindings}
        for b in other.bindings:
            prev = merged.get(b.name)
            if prev is not None and prev.kind != b.kind:
                raise BindingError(
                    f"binding '{b.name}' declared as {prev.kind} and {b.kind} "
                    f"in different stages"
                )
            merged.setdefault(b.name, b)
        return ShaderReflection(
            bindings=tuple(merged.values()), stages=self.stages | other.stages
        )


class BoundResources:
    """Name-based, kind-checked resource access inside shader functions —
    the runtime face of DescriptorSetBinder (reference descriptor.rs:298-456).

    Access tracks which names were read so the pipeline can warn about
    declared-but-unused bindings (parity with reflection validation).
    """

    def __init__(self, reflection: ShaderReflection, values: "dict[str, Any]"):
        self._reflection = reflection
        self._values = values
        self.accessed: set[str] = set()

    def __getitem__(self, name: str) -> Any:
        if self._reflection.find(name) is None:
            raise BindingError(
                f"shader accessed undeclared binding '{name}'; declared: "
                f"{[b.name for b in self._reflection.bindings]}"
            )
        if name not in self._values:
            raise BindingError(f"binding '{name}' declared but nothing bound")
        self.accessed.add(name)
        return self._values[name]

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_") or name == "accessed":
            raise AttributeError(name)
        return self[name]

    def get(self, name: str, default: Any = None) -> Any:
        try:
            return self[name]
        except BindingError:
            return default


@dataclass
class FragmentBuiltins:
    """Per-pixel built-in inputs available to fragment shaders (the SV_* /
    gl_FragCoord analogs)."""

    frag_coord: Any  # (..., 2) pixel-center coordinates (x, y), y-down
    depth: Any  # (...,) interpolated NDC depth (reverse-Z)
    front_facing: Any  # (...,) bool
    resolution: Tuple[int, int] = (0, 0)  # (width, height)
    draw_id: Any = None  # (...,) f32 draw index inside a batched draw


class Shader:
    """A named, staged shader function with reflection
    (reference shader.rs Shader::{from_file,from_spirv} → here: from_fn).

    Shader objects are hashed by identity: reusing the same Shader instance
    across frames keeps `GraphicPipelineDesc` stable, which keeps the
    frame function stable, which keeps the frame-function cache hot (the analog
    of PipelineCache keying, pipeline_cache.rs:19-113).
    """

    def __init__(
        self,
        name: str,
        stage: ShaderStage,
        fn: Callable[..., Any],
        bindings: "tuple[ShaderBinding, ...] | list[ShaderBinding]" = (),
        inputs: "tuple[VertexInput, ...] | list[VertexInput] | None" = None,
        kernel_safe: bool = False,
        device_source: Optional[str] = None,
    ):
        self.name = name
        self.stage = stage
        self.fn = fn
        # kernel_safe (fragment stage): the function body is pure elementwise
        # torch over its varyings/uniforms — no texture sampling, gathers, or
        # global reductions — so it can run per fragment inside the in-order
        # blend kernel (ops.raster.raster_segmented_blend) for order-correct
        # transparency.
        self.kernel_safe = kernel_safe
        # device_source (kernel-safe fragment shaders): the same function as
        # CUDA C++ text, which the blend kernel is compiled around when the
        # pipeline first draws on a CUDA device (ops.runtime
        # .load_blend_kernel). It defines
        #   __device__ __forceinline__ void zn_fragment(
        #       const float* a, float frag_x, float frag_y, float depth,
        #       bool front_facing, float draw_id, float* rgba);
        # where ``a`` holds the finalized varyings and uniforms; a varying
        # ``n`` starts at column ZN_V_n, a uniform ``U`` at ZN_U_U. ``fn``
        # stays the plain version and what CPU tensors run. A kernel-safe
        # shader without device source cannot draw on CUDA tensors.
        if device_source is not None and not kernel_safe:
            raise ValueError(
                f"shader {name!r}: device_source is for kernel_safe fragment shaders"
            )
        self.device_source = device_source
        # Declared vertex inputs (vertex stage only). None = undeclared:
        # pipeline-time layout validation is skipped and a missing attribute
        # surfaces as a draw-time error instead (legacy/loose mode).
        self.vertex_inputs: "Optional[Tuple[VertexInput, ...]]" = (
            tuple(inputs) if inputs is not None else None
        )
        # Auto-assign binding indices in declaration order (set 0), like the
        # derive macro assigns vertex locations by field order.
        indexed = []
        for i, b in enumerate(bindings):
            if b.binding_index == 0 and i > 0:
                b = ShaderBinding(b.name, b.kind, b.set_index, i)
            indexed.append(b)
        self.reflection = ShaderReflection(tuple(indexed), stages=stage)

    @staticmethod
    def vertex(name: str, fn: Callable[..., Any], bindings=(),
               inputs=None) -> "Shader":
        return Shader(name, ShaderStage.VERTEX, fn, bindings, inputs=inputs)

    @staticmethod
    def fragment(name: str, fn: Callable[..., Any], bindings=(),
                 kernel_safe: bool = False,
                 device_source: Optional[str] = None) -> "Shader":
        return Shader(name, ShaderStage.FRAGMENT, fn, bindings,
                      kernel_safe=kernel_safe, device_source=device_source)

    def __repr__(self) -> str:
        return f"Shader({self.name!r}, {self.stage})"


def uniform(name: str) -> ShaderBinding:
    return ShaderBinding(name, BindingKind.UNIFORM_BUFFER)


def storage(name: str) -> ShaderBinding:
    return ShaderBinding(name, BindingKind.STORAGE_BUFFER)


def texture2d(name: str) -> ShaderBinding:
    return ShaderBinding(name, BindingKind.SAMPLED_TEXTURE)


def sampler(name: str) -> ShaderBinding:
    return ShaderBinding(name, BindingKind.SAMPLER)


#: Vulkan's guaranteed maxPushConstantsSize — the reference's pipeline layout
#: carries one push-constant range sized from reflection (pipeline.rs:111-131);
#: 128 bytes is the only portable size, so we enforce it for parity.
PUSH_CONSTANT_LIMIT_BYTES = 128


def push_constant(name: str) -> ShaderBinding:
    """Declare a push-constant slot (reference shader.rs:380-413 reflects
    these from SPIR-V; command.rs cmd push_constants writes them). Here
    a push constant is a small uniform in all but name — the draw context's
    ``push_constants(value)`` routes a value to this slot and enforces the
    128-byte Vulkan guarantee. At most one per pipeline (one range per
    layout, like the reference)."""
    return ShaderBinding(name, BindingKind.PUSH_CONSTANT)
