"""Sort-first SPMD rendering: framebuffer row bands over a device mesh
(torch port of zenith_tpu/parallel/sharding.py, on the thread runtime of
``parallel.spmd``).

Each shard of a 1-D mesh axis ("rows") owns an H/n-row band of the
framebuffer. Inside ``shard_map`` the shard derives its band origin from
``axis_index`` and rasterizes with a shifted viewport
(ops.geometry's ``viewport=``); vertex transform and triangle setup are
replicated, and binning drops the triangles outside the band. No
collective runs during rendering; the banded framebuffer stays banded
(``ShardedTensor``) or is gathered for presentation.

The sort-last functions (triangles sharded, planes merged by a depth
composite) live here too: ``make_sort_last_frame``, ``composite_depth``
(binary swap) and ``composite_depth_planes``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from zenith_tpu_torch.ops import blend as blend_ops
from zenith_tpu_torch.ops.binning import TileGrid
from zenith_tpu_torch.ops.draw import draw_indexed
from zenith_tpu_torch.parallel import spmd
from zenith_tpu_torch.parallel.spmd import Mesh, P
from zenith_tpu_torch.rhi.pipeline import GraphicPipeline


def default_mesh(n_devices: Optional[int] = None, axis: str = "rows",
                 device: "Optional[torch.device | str]" = None) -> Mesh:
    """A 1-D mesh of ``n_devices`` shards. With no ``device``, the first
    ``n_devices`` CUDA devices (all of them when ``n_devices`` is None); it
    raises when there are fewer. ``device="cpu"`` or ``"cuda:0"`` puts
    ``n_devices`` shards on that one device, as JAX's
    ``--xla_force_host_platform_device_count`` puts them on the CPU."""
    if device is not None:
        return Mesh([torch.device(device)] * (n_devices or 1), axis)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if n < 1 or have < n:
        raise RuntimeError(
            f"default_mesh({n_devices}) needs {max(n, 1)} CUDA devices and {have} are "
            f"available; pass device='cpu' or device='cuda:0' to put the shards on one device"
        )
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def row_sharding(mesh: Mesh, axis: str = "rows") -> P:
    """The spec of (H, W, C) framebuffers: rows split across the mesh."""
    return P(axis)


def make_sort_last_frame(
    mesh: Mesh,
    pipeline: GraphicPipeline,
    width: int,
    height: int,
    clear_color: "tuple" = (0.0, 0.0, 0.0, 1.0),
    depth_clear: float = 0.0,
    tile_h: int = 8,
    tile_w: int = 128,
    axis: str = "rows",
) -> Callable[..., Any]:
    """Sort-LAST SPMD rendering: TRIANGLES sharded across the mesh, each
    shard rasterizing its contiguous subset at full resolution, composited
    by a depth-winner reduction (``composite_depth``). Equal-z ties resolve
    toward the lowest rank = earliest submission, the first-wins rule of the
    GREATER depth compare. Requires an opaque pipeline (depth test+write;
    no blending).

    Returns ``step(vertex_buffer, index_buffer, resources) -> (color,
    depth)``, full (H, W, …) results (shard 0's copy). The index buffer's
    triangle count must divide by the mesh size."""
    grid = TileGrid(width=width, height=height, tile_h=tile_h, tile_w=tile_w)
    ds = pipeline.desc.state.depth_stencil
    if not (ds.depth_test_enable and ds.depth_write_enable):
        raise ValueError("sort-last compositing needs depth test+write (opaque geometry)")
    for desc in pipeline.desc.color_attachment_descs or ():
        if desc.blend_enable:
            raise ValueError("sort-last compositing cannot reproduce order-dependent blending")

    def shard_body(vb, ib, resources):
        # ib arrives as this shard's contiguous (T/n, 3) triangle slice.
        dev = vb.device
        colors = [blend_ops.clear_color(height, width, clear_color, dev)]
        depth = blend_ops.clear_depth(height, width, depth_clear, dev)
        colors, depth, _stats = draw_indexed(colors, depth, pipeline, vb, ib, resources, grid)
        return composite_depth(colors[0], depth, axis)

    return spmd.shard_map(
        shard_body, mesh,
        in_specs=(P(), P(axis), P()),  # triangles sharded; the rest replicated
        out_specs=(P(), P()),  # composited planes replicated
    )


def composite_depth_all_gather(color, depth, axis_name: str):
    """Reference (non-scalable) depth compositor: all_gather every shard's
    full-resolution (z, color) planes and take the depth-argmax (the first
    maximum: the lowest rank). The oracle ``composite_depth`` is held
    bit-equal to."""
    z_all = spmd.all_gather(depth, axis_name)  # (n, H, W)
    c_all = spmd.all_gather(color, axis_name)  # (n, H, W, 4)
    winner = torch.argmax(z_all, dim=0)  # first max → earliest shard
    z_out = torch.amax(z_all, dim=0)
    idx = winner[None, ..., None].expand(1, *winner.shape, c_all.shape[-1])
    c_out = torch.gather(c_all, 0, idx)[0]
    return c_out, z_out


def composite_depth(color, depth, axis_name: str):
    """Scalable sort-last depth compositing: BINARY SWAP (recursive
    halving) + tiled reassembly.

    log2(n) rounds; in round k every shard pairs with ``rank ^ d`` (d =
    n/2, n/4, …, 1), keeps the half of its current region selected by that
    rank bit, sends the other half (one ppermute of (rows/2, W) planes), and
    depth-composites what it receives. After the rounds shard r holds the
    composited rows of piece r, and one tiled all_gather reassembles the
    frame. Ties resolve as the all_gather compositor does: the lexicographic
    (z, -origin rank) max is associative, so the tournament is exact.
    Requires n a power of two and H divisible by n; other configurations
    use the all_gather compositor."""
    n = spmd.axis_size(axis_name)
    h = depth.shape[0]
    if n == 1:
        return color, depth
    if n & (n - 1) != 0 or h % n != 0:
        return composite_depth_all_gather(color, depth, axis_name)

    rank = spmd.axis_index(axis_name)
    z, c = depth, color
    rk = torch.full(z.shape, rank, dtype=torch.int32, device=z.device)
    d = n // 2
    while d >= 1:
        half = z.shape[0] // 2
        low = (rank & d) == 0  # the lower rank keeps the top half
        perm = [(i, i ^ d) for i in range(n)]

        def swap(a):
            send, mine = (a[half:], a[:half]) if low else (a[:half], a[half:])
            return spmd.ppermute(send, axis_name, perm), mine

        z_recv, z_mine = swap(z)
        c_recv, c_mine = swap(c)
        r_recv, r_mine = swap(rk)
        take = (z_recv > z_mine) | ((z_recv == z_mine) & (r_recv < r_mine))
        z = torch.where(take, z_recv, z_mine)
        c = torch.where(take[..., None], c_recv, c_mine)
        rk = torch.where(take, r_recv, r_mine)
        d //= 2
    # Shard r now holds piece r: a tiled gather reassembles rows in order.
    z_out = spmd.all_gather(z, axis_name, axis=0, tiled=True)
    c_out = spmd.all_gather(c, axis_name, axis=0, tiled=True)
    return c_out, z_out


# Background value of the submission-order plane: larger than any draw
# sequence number, so undrawn pixels lose every tie against drawn ones and
# resolve among themselves to the (identical) loaded contents of rank 0.
ORDER_BACKGROUND = 2**31 - 1


def composite_depth_planes(
    planes: "list",
    depth,
    order,
    axis_name: str,
    band_output: bool = False,
):
    """Binary-swap sort-last compositing of N attachment planes sharing ONE
    depth plane — the engine-graph generalization of ``composite_depth``.

    Per pixel the winner is the shard with max z; equal z resolves to the
    lowest ``order`` (a per-pixel int32 submission-order plane,
    ``ORDER_BACKGROUND`` for undrawn pixels), and equal (z, order) to the
    lowest rank. The lexicographic (z, -order, -rank) max is associative,
    so the pairwise tournament is exact.

    With ``band_output`` each shard keeps its contiguous row piece r, the
    row-band layout of the sort-first path. Otherwise full surfaces are
    all_gathered on every shard. Non-power-of-two meshes or heights that
    don't divide use an all_gather composite (same winner rule)."""
    n = spmd.axis_size(axis_name)
    h = depth.shape[0]
    rank = spmd.axis_index(axis_name)
    if n == 1:
        return planes, depth, order
    if n & (n - 1) != 0 or h % n != 0:
        z_all = spmd.all_gather(depth, axis_name)  # (n, H, W)
        o_all = spmd.all_gather(order, axis_name)
        # Winner rank per pixel: lexicographic (z desc, order asc, rank
        # asc); scan ranks in order, keeping the incumbent on ties.
        z_w, o_w = z_all[0], o_all[0]
        r_w = torch.zeros(z_w.shape, dtype=torch.int32, device=z_w.device)
        for r in range(1, n):
            take = (z_all[r] > z_w) | ((z_all[r] == z_w) & (o_all[r] < o_w))
            z_w = torch.where(take, z_all[r], z_w)
            o_w = torch.where(take, o_all[r], o_w)
            r_w = torch.where(take, torch.full_like(r_w, r), r_w)
        out_planes = []
        for p in planes:
            p_all = spmd.all_gather(p, axis_name)
            sel = r_w.reshape(r_w.shape + (1,) * (p_all.ndim - 1 - r_w.ndim)).long()
            sel = sel.expand(*p_all.shape[1:])
            out_planes.append(torch.gather(p_all, 0, sel[None])[0])
        if band_output and h % n == 0:
            piece = h // n
            s = rank * piece
            out_planes = [p[s:s + piece] for p in out_planes]
            z_w, o_w = z_w[s:s + piece], o_w[s:s + piece]
        return out_planes, z_w, o_w

    z, o = depth, order
    ps = list(planes)
    rk = torch.full(z.shape, rank, dtype=torch.int32, device=z.device)
    d = n // 2
    while d >= 1:
        half = z.shape[0] // 2
        low = (rank & d) == 0
        perm = [(i, i ^ d) for i in range(n)]

        def swap(a):
            send, mine = (a[half:], a[:half]) if low else (a[:half], a[half:])
            return spmd.ppermute(send, axis_name, perm), mine

        z_recv, z_mine = swap(z)
        o_recv, o_mine = swap(o)
        r_recv, r_mine = swap(rk)
        take = (z_recv > z_mine) | (
            (z_recv == z_mine)
            & ((o_recv < o_mine) | ((o_recv == o_mine) & (r_recv < r_mine)))
        )
        z = torch.where(take, z_recv, z_mine)
        o = torch.where(take, o_recv, o_mine)
        rk = torch.where(take, r_recv, r_mine)
        new_ps = []
        for p in ps:
            p_recv, p_mine = swap(p)
            t = take.reshape(take.shape + (1,) * (p.ndim - take.ndim))
            new_ps.append(torch.where(t, p_recv, p_mine))
        ps = new_ps
        d //= 2
    if band_output:
        # Shard r holds contiguous piece r: already the row-band layout.
        return ps, z, o
    ps = [spmd.all_gather(p, axis_name, axis=0, tiled=True) for p in ps]
    z = spmd.all_gather(z, axis_name, axis=0, tiled=True)
    o = spmd.all_gather(o, axis_name, axis=0, tiled=True)
    return ps, z, o


def make_row_sharded_frame(
    mesh: Mesh,
    pipeline: GraphicPipeline,
    width: int,
    height: int,
    clear_color: "tuple" = (0.0, 0.0, 0.0, 1.0),
    depth_clear: float = 0.0,
    use_depth: bool = True,
    tile_h: int = 8,
    tile_w: int = 128,
    bin_capacity: int = 64,
    axis: str = "rows",
) -> Callable[..., Any]:
    """Build a multi-shard frame step.

    Returns ``step(vertex_buffer, index_buffer, resources) -> (color,
    depth)``: ``ShardedTensor`` row bands over ``mesh[axis]``, colour (H, W,
    4) and depth (H, W) (zeros without ``use_depth``). H must divide by the
    mesh size × tile_h."""
    n = mesh.shape[axis]
    if height % n:
        raise ValueError(f"height {height} must divide across {n} shards")
    shard_h = height // n
    if shard_h % tile_h:
        raise ValueError(f"shard height {shard_h} must be a multiple of tile_h {tile_h}")
    grid = TileGrid(width=width, height=shard_h, tile_h=tile_h, tile_w=tile_w)

    def shard_body(vb, ib, resources):
        dev = vb.device
        y0 = spmd.axis_index(axis) * shard_h
        colors = [blend_ops.clear_color(shard_h, width, clear_color, dev)]
        depth = blend_ops.clear_depth(shard_h, width, depth_clear, dev) if use_depth else None
        colors, depth, _stats = draw_indexed(
            colors, depth, pipeline, vb, ib, resources, grid,
            bin_capacity=bin_capacity, viewport=(0, y0, width, height),
        )
        if use_depth:
            return colors[0], depth
        return colors[0], torch.zeros((shard_h, width), dtype=torch.float32, device=dev)

    return spmd.shard_map(
        shard_body, mesh,
        in_specs=(P(), P(), P()),  # geometry + resources replicated
        out_specs=(P(axis), P(axis)),  # framebuffer row bands
    )


def halo_exchange_rows(band: torch.Tensor, axis_name: str, halo: int) -> torch.Tensor:
    """Ring halo exchange over row bands: ``band`` extended with ``halo``
    rows from the neighbour above and below, wrapping at the ends (the
    periodic semantics of roll-based filters, so a banded filter reproduces
    the single-device result bit for bit). Two ppermute rings of (halo, W,
    C) each."""
    n = spmd.axis_size(axis_name)
    if n == 1:
        return band
    tail = band[-halo:]  # rows sent DOWN (to i+1)
    head = band[:halo]  # rows sent UP (to i-1)
    perm_down = [(i, (i + 1) % n) for i in range(n)]
    perm_up = [(i, (i - 1) % n) for i in range(n)]
    upper = spmd.ppermute(tail, axis_name, perm_down)  # i-1's tail
    lower = spmd.ppermute(head, axis_name, perm_up)  # i+1's head
    return torch.cat([upper, band, lower], dim=0)
