"""Per-frame declarative pass DAG → one eager frame function (torch port of
zenith_tpu/rendergraph).

Mirrors zenith-rendergraph (reference zenith-rendergraph/src/lib.rs:7-25):
builder with typed handles, graphic/lambda nodes, compile/execute/present/
retire — with barriers, fences, and resource states replaced by stream-
ordered tensor dataflow.
"""

from zenith_tpu_torch.rendergraph.builder import (
    AttachmentBinder,
    GraphicNodeBuilder,
    GraphNode,
    LambdaNodeBuilder,
    RenderGraphBuilder,
    ResourceAccessStorage,
)
from zenith_tpu_torch.rendergraph.graph import (
    CompiledRenderGraph,
    CompileOptions,
    GraphicNodeExecutionContext,
    LambdaNodeExecutionContext,
    RenderGraph,
    RetiredRenderGraph,
    clear_frame_program_cache,
    set_frame_program_cache_limit,
    frame_program_cache_size,
)
from zenith_tpu_torch.rendergraph.resource import (
    RenderGraphResource,
    RenderGraphResourceAccess,
    ViewKind,
)

__all__ = [name for name in dir() if not name.startswith("_")]
