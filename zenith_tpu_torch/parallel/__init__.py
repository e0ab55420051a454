"""Multi-device SPMD rendering over a mesh of shards (torch port of
zenith_tpu/parallel).

Sort-first parallel rendering: the framebuffer is split in row bands over a
1-D mesh axis, geometry processing is replicated, and each shard bins,
rasterizes and shades only its band. The only cross-shard communication is
the optional final gather for presentation and the halo or gather of the
passes that read across bands. The shards run as threads of one process
(``parallel.spmd``).
"""

from zenith_tpu_torch.parallel.sharding import (
    ORDER_BACKGROUND,
    composite_depth_planes,
    default_mesh,
    make_row_sharded_frame,
    halo_exchange_rows,
    make_sort_last_frame,
    row_sharding,
)

__all__ = [
    "ORDER_BACKGROUND",
    "composite_depth_planes",
    "default_mesh",
    "make_row_sharded_frame",
    "make_sort_last_frame",
    "halo_exchange_rows",
    "row_sharding",
]
