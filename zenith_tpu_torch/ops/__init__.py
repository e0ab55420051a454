"""The rasterizer (torch port of zenith_tpu/ops): triangle setup (geometry),
the coarse rasterizer (binning), the fine rasterizer over the hand-written
CUDA kernels K1 and K3-K6 (raster), attribute finalize (shade) and the output
merger (blend), composed per draw call by ``draw``."""

from zenith_tpu_torch.ops import binning, blend, draw, geometry, raster, runtime, shade
from zenith_tpu_torch.ops.binning import (
    ENTRY_CHUNK,
    SegmentedBins,
    TileGrid,
    bin_segmented,
)
from zenith_tpu_torch.ops.blend import apply_color_output, clear_color, clear_depth
from zenith_tpu_torch.ops.draw import DEFAULT_BIN_CAPACITY, DrawStats, draw_indexed
from zenith_tpu_torch.ops.geometry import (
    TriangleRecords,
    setup_with_attrs,
    transform_vertices,
)
from zenith_tpu_torch.ops.raster import raster_segmented
from zenith_tpu_torch.ops.shade import finalize_attrs

__all__ = [name for name in dir() if not name.startswith("_")]
