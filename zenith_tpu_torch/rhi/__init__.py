"""The "render hardware interface" of the PyTorch port — the zenith-rhi
analog (counterpart of zenith_tpu/rhi).

Re-export surface mirroring zenith-rhi/src/lib.rs:28-67. Where the reference
deliberately leaks `ash::vk` (lib.rs:31), this layer's "native" vocabulary is
torch: resources expose their tensors directly, and upper layers may use
torch freely — the abstraction is deliberately leaky in the same way.
"""

from zenith_tpu_torch.rhi.command import (
    CommandEncoder,
    CommandPool,
    DeferReleaseQueue,
    ImmediateCommandEncoder,
    LastFreedStats,
    UploadPool,
)
from zenith_tpu_torch.rhi.derive import float1, vec2, vec3, vec4, vertex_layout
from zenith_tpu_torch.rhi.device import (
    NUM_BACK_BUFFERS,
    FrameStats,
    PhysicalDevice,
    RenderDevice,
    RhiCore,
    select_physical_device,
)
from zenith_tpu_torch.rhi.formats import (
    Format,
    FormatAspect,
    decode_stored,
    encode_present,
    linear_to_srgb,
    srgb_to_linear,
)
from zenith_tpu_torch.rhi.pipeline import (
    GraphicPipeline,
    GraphicPipelineDesc,
    GraphicShaderInput,
    PipelineCache,
    PipelineCacheStats,
)
from zenith_tpu_torch.rhi.resource import (
    Buffer,
    BufferDesc,
    BufferUsage,
    ResourceCache,
    ResourceCacheStats,
    Texture,
    TextureDesc,
    TextureUsage,
)
from zenith_tpu_torch.rhi.sampler import (
    AddressMode,
    BorderColor,
    Filter,
    MipmapMode,
    Sampler,
    SamplerConfig,
)
from zenith_tpu_torch.rhi.shader import (
    BindingError,
    BindingKind,
    BoundResources,
    FragmentBuiltins,
    Shader,
    ShaderBinding,
    ShaderReflection,
    ShaderStage,
    VertexInput,
    attr,
    push_constant,
    sampler,
    storage,
    texture2d,
    uniform,
)
from zenith_tpu_torch.rhi.state import (
    BlendFactor,
    BlendOp,
    ColorAttachmentDesc,
    ColorBlendState,
    CompareOp,
    CullMode,
    DepthStencilDesc,
    FrontFace,
    GraphicPipelineAttachments,
    GraphicPipelineState,
    InputAssemblyState,
    LoadOp,
    MultisampleState,
    PolygonMode,
    PrimitiveTopology,
    RasterizationState,
    StoreOp,
    VertexAttribute,
    VertexLayout,
)
from zenith_tpu_torch.rhi.swapchain import PresentMode, Swapchain, SwapchainConfig

__all__ = [name for name in dir() if not name.startswith("_")]
