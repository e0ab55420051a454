"""The rasterizer (torch port of zenith_tpu/ops): triangle setup (geometry),
the coarse rasterizer (binning), the fine rasterizer over the hand-written
CUDA kernels K1 and K3-K8 (raster), attribute resolution (shade), the
texture sampler (sampling) and the output merger (blend), composed per draw
call by ``draw``. The capped-bin path (``setup_triangles`` →
``bin_triangles`` → ``visibility_pass`` / ``raster_interp_pass`` →
``resolve_varyings`` / ``finalize_attrs``) is the reference's second
implementation of the raster, over K7 and K8."""

from zenith_tpu_torch.ops import binning, blend, draw, geometry, raster, runtime, sampling, shade
from zenith_tpu_torch.ops.binning import (
    ENTRY_CHUNK,
    SegmentedBins,
    TileBins,
    TileGrid,
    bin_segmented,
    bin_triangles,
)
from zenith_tpu_torch.ops.blend import apply_color_output, clear_color, clear_depth
from zenith_tpu_torch.ops.draw import DEFAULT_BIN_CAPACITY, DrawStats, draw_indexed
from zenith_tpu_torch.ops.geometry import (
    TriangleRecords,
    clip_near_w,
    corner_attributes,
    setup_triangles,
    setup_with_attrs,
    transform_vertices,
)
from zenith_tpu_torch.ops.raster import (
    K_BLOCK,
    raster_interp_pass,
    raster_segmented,
    visibility_pass,
)
from zenith_tpu_torch.ops.sampling import (
    PackedMips,
    pack_mips,
    sample_2d,
    sample_2d_lod,
    sample_shadow_pcf,
    screen_space_lod,
)
from zenith_tpu_torch.ops.shade import finalize_attrs, resolve_varyings

__all__ = [name for name in dir() if not name.startswith("_")]
