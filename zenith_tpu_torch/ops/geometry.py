"""Vertex transform, near clipping, and triangle setup (torch port of
zenith_tpu/ops/geometry.py).

Dense tensor ops over all triangles at once. Outputs are static-shape
*triangle records* consumed by binning and the raster kernel (ops.raster):

- ``rast16``  (R, 16) f32 — the raster core record (see RAST_* indices):
  three oriented edge equations (inside > 0), top-left flags, 1/|det|, and
  per-corner NDC depth. Kernel K1 reads these columns.
- ``shade16`` (R, 16) f32 — per-corner 1/w and original-triangle
  barycentrics plus the front-facing flag. ``setup_triangles`` records the
  near clip's barycentrics (``corner_attributes`` and
  ``shade.resolve_varyings`` read them); ``setup_with_attrs`` clips the
  attributes themselves and leaves them the identity.
- ``tri_id``  (R,) i32, ``valid`` (R,) bool, ``aabb`` (R, 4) f32.

R = 2 × number of input triangles (static near-clip expansion). Line and
point setup expand each segment or point into a screen rectangle of two
triangles on the same records (R = 2L, 2P).

Conventions match the reference for per-pixel parity: pixel centres at
(px+0.5, py+0.5), y down; det > 0 ⇔ clockwise on screen; top-left fill rule.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from zenith_tpu_torch.rhi.state import CullMode, FrontFace

# rast16 column indices (zenith_tpu/ops/geometry.py:42-48, column for column).
RAST_A01, RAST_B01, RAST_C01 = 0, 1, 2
RAST_A12, RAST_B12, RAST_C12 = 3, 4, 5
RAST_A20, RAST_B20, RAST_C20 = 6, 7, 8
RAST_TL01, RAST_TL12, RAST_TL20 = 9, 10, 11
RAST_INV_DET = 12
RAST_Z0, RAST_Z1, RAST_Z2 = 13, 14, 15

# shade16 column indices.
SHADE_IW0, SHADE_IW1, SHADE_IW2 = 0, 1, 2
SHADE_B0X, SHADE_B0Y = 3, 4
SHADE_B1X, SHADE_B1Y = 5, 6
SHADE_B2X, SHADE_B2Y = 7, 8
SHADE_FRONT = 9

NEAR_W_EPS = 1e-5


class TriangleRecords(NamedTuple):
    rast16: torch.Tensor  # (R, 16) f32
    shade16: torch.Tensor  # (R, 16) f32
    tri_id: torch.Tensor  # (R,) i32
    valid: torch.Tensor  # (R,) bool
    aabb: torch.Tensor  # (R, 4) f32: xmin, ymin, xmax, ymax (pixels)


def transform_vertices(positions: torch.Tensor, mvp: torch.Tensor) -> torch.Tensor:
    """Model/world positions (N, 3) → clip space (N, 4)."""
    n = positions.shape[0]
    pos = positions.to(torch.float32)
    hom = torch.cat([pos, torch.ones((n, 1), dtype=torch.float32, device=pos.device)], dim=1)
    return hom @ mvp.to(torch.float32).T


def setup_with_attrs(
    clip_positions: torch.Tensor,  # (Nv, 4)
    indices: torch.Tensor,  # (T, 3)
    varyings: torch.Tensor,  # (Nv, A) flattened vertex-stage outputs
    width: int,
    height: int,
    cull_mode: CullMode = CullMode.BACK,
    front_face: FrontFace = FrontFace.COUNTER_CLOCKWISE,
    viewport: "tuple | None" = None,
    depth_bias: "tuple[float, float] | None" = None,  # (constant, slope)
    depth_clamp: bool = False,
) -> "tuple[TriangleRecords, torch.Tensor]":
    """Fused triangle setup + corner-attribute production
    (geometry.py:68-130). Returns the records and the FLAT corner data
    (R, 3·(A+2)): per corner [attr·iw…, front·iw, iw], which K1 reads."""
    indices = indices.to(torch.int64)
    t = indices.shape[0]
    a = varyings.shape[1]
    combined = torch.cat(
        [clip_positions.to(torch.float32), varyings.to(torch.float32)], dim=1
    )
    corners = combined[indices.reshape(-1)].reshape(t, 3, 4 + a)

    # depth_clamp disables near/far z clipping (Vulkan 27.4); only the w > 0
    # clip remains, which keeps screen coordinates finite.
    corners2, valid = _clip_payload(corners, clamp_z=depth_clamp)
    ar = torch.arange(t, dtype=torch.int32, device=corners.device)
    tri_id = torch.cat([ar, ar])

    records = _records_from_corners(
        corners2[..., :4], valid, tri_id, width, height,
        cull_mode, front_face, viewport,
        depth_bias=depth_bias, depth_clamp=depth_clamp,
    )

    w = torch.clamp(corners2[..., 3], min=NEAR_W_EPS)  # (R, 3)
    iw = 1.0 / w
    front = records.shade16[:, SHADE_FRONT][:, None]  # (R, 1)
    blocks = []
    for c in range(3):
        iw_c = iw[:, c][:, None]
        blocks.append(corners2[:, c, 4:] * iw_c)  # (R, A)
        blocks.append(front * iw_c)
        blocks.append(iw_c)
    corner_flat = torch.cat(blocks, dim=1)
    return records, corner_flat.to(torch.float32)


def corner_attributes(
    records: TriangleRecords,
    indices: torch.Tensor,  # (T, 3) original index buffer
    varyings: torch.Tensor,  # (Nv, A) flattened vertex-stage outputs
) -> torch.Tensor:
    """Per-record corner data (R, 3·(A+2)) for the capped-bin interp pass
    (geometry.py:558-598): per corner [varying·iw…, front·iw, iw], where a
    clipped corner blends the original corners' varyings by the barycentrics
    ``setup_triangles`` recorded in shade16."""
    r = records.rast16.shape[0]
    tri = indices.to(torch.int64)[records.tri_id.to(torch.int64)]  # (R, 3)
    v = varyings.to(torch.float32)[tri.reshape(-1)].reshape(r, 3, -1)
    sh = records.shade16
    front = sh[:, SHADE_FRONT][:, None]
    blocks = []
    for bxcol, bycol, iwcol in ((SHADE_B0X, SHADE_B0Y, SHADE_IW0),
                                (SHADE_B1X, SHADE_B1Y, SHADE_IW1),
                                (SHADE_B2X, SHADE_B2Y, SHADE_IW2)):
        bx = sh[:, bxcol][:, None]
        by = sh[:, bycol][:, None]
        bz = 1.0 - bx - by
        attr = bx * v[:, 0, :] + by * v[:, 1, :] + bz * v[:, 2, :]  # (R, A)
        iw_c = sh[:, iwcol][:, None]
        blocks += [attr * iw_c, front * iw_c, iw_c]
    return torch.cat(blocks, dim=1).to(torch.float32)


def clip_near_w(corners: torch.Tensor, obary: torch.Tensor, w_eps: float = NEAR_W_EPS):
    """Clip triangles against the near plane z ≤ w with static 2× expansion
    (geometry.py:615-688). corners (T, 3, 4) clip space, obary (T, 3, 3)
    barycentrics w.r.t. the original triangle → (corners2 (2T, 3, 4),
    obary2 (2T, 3, 3), valid (2T,)). Both are lerped as one payload, which
    rounds each column as the reference does."""
    out, valid = _clip_payload(torch.cat([corners, obary.to(corners.dtype)], dim=-1),
                               w_eps=w_eps)
    return out[..., :4], out[..., 4:], valid


def setup_triangles(
    clip_positions: torch.Tensor,  # (Nv, 4)
    indices: torch.Tensor,  # (T, 3)
    width: int,
    height: int,
    cull_mode: CullMode = CullMode.BACK,
    front_face: FrontFace = FrontFace.COUNTER_CLOCKWISE,
    near_clip: bool = True,
    viewport: "tuple | None" = None,
) -> TriangleRecords:
    """Gather → near clip → viewport → edge equations (geometry.py:691-806):
    the records of the capped-bin path, R = 2T (``near_clip``) or T, with
    the clip's original-triangle barycentrics in shade16."""
    indices = indices.to(torch.int64)
    t = indices.shape[0]
    dev = clip_positions.device
    corners = clip_positions.to(torch.float32)[indices.reshape(-1)].reshape(t, 3, 4)
    obary = torch.eye(3, dtype=torch.float32, device=dev).expand(t, 3, 3)
    ar = torch.arange(t, dtype=torch.int32, device=dev)
    if near_clip:
        corners, obary, valid = clip_near_w(corners, obary)
        tri_id = torch.cat([ar, ar])
    else:
        valid = torch.all(corners[..., 3] > NEAR_W_EPS, dim=1)
        tri_id = ar
    return _records_from_corners(corners, valid, tri_id, width, height, cull_mode,
                                 front_face, viewport, obary=obary)


def setup_lines_with_attrs(
    clip_positions: torch.Tensor,  # (Nv, 4)
    segments: torch.Tensor,  # (L, 2) endpoint indices
    varyings: torch.Tensor,  # (Nv, A)
    width: int,
    height: int,
    line_width: float = 1.0,
    viewport: "tuple | None" = None,
    depth_clamp: bool = False,
    seg_valid: Optional[torch.Tensor] = None,  # (L,) extra mask (wireframe cull)
) -> "tuple[TriangleRecords, torch.Tensor]":
    """Line setup (geometry.py:133-261): each segment becomes a
    ``line_width``-wide screen rectangle with butt caps (Vulkan 27.6), two
    triangles sharing a diagonal, on the ordinary triangle records. Depth,
    1/w and attributes are per endpoint, so interpolation is
    perspective-correct along the line and constant across it. Lines are
    never culled and always front-facing; zero-length lines draw nothing.
    Returns (records, corner data) with R = 2L."""
    segments = segments.to(torch.int64)
    nl = segments.shape[0]
    a = varyings.shape[1]
    combined = torch.cat([clip_positions.to(torch.float32), varyings.to(torch.float32)], dim=1)
    ends = combined[segments.reshape(-1)].reshape(nl, 2, 4 + a)

    # Near clip (z <= w, or w > 0 only under depth clamp): a clipped segment
    # stays one segment.
    d = ends[..., 3] if depth_clamp else ends[..., 3] - ends[..., 2]
    inside = d > NEAR_W_EPS  # (L, 2)
    valid = inside[:, 0] | inside[:, 1]
    if seg_valid is not None:
        valid = valid & seg_valid
    denom = d[:, 0] - d[:, 1]
    denom = torch.where(torch.abs(denom) > 1e-20, denom, torch.ones_like(denom))
    t = torch.clamp((d[:, 0] - NEAR_W_EPS) / denom, 0.0, 1.0)[:, None]
    crossing = _lerp_fma(ends[:, 0], ends[:, 1], t)
    e0 = torch.where(inside[:, 0, None], ends[:, 0], crossing)
    e1 = torch.where(inside[:, 1, None], ends[:, 1], crossing)

    pts = torch.stack([e0, e1], dim=1)  # (L, 2, 4+A)
    iw2 = 1.0 / torch.clamp(pts[..., 3], min=NEAR_W_EPS)  # (L, 2)
    ndc = pts[..., :3] * iw2[..., None]
    vx0, vy0, full_w, full_h = viewport if viewport is not None else (0, 0, width, height)
    px = (ndc[..., 0] + 1.0) * (0.5 * full_w) - vx0  # (L, 2)
    py = (ndc[..., 1] + 1.0) * (0.5 * full_h) - vy0
    pz = ndc[..., 2]

    # Rectangle expansion: +-(line_width / 2) along the screen normal.
    dx = px[:, 1] - px[:, 0]
    dy = py[:, 1] - py[:, 0]
    ln = torch.sqrt(dx * dx + dy * dy)
    ok = ln > 1e-6
    valid = valid & ok
    hw = 0.5 * float(line_width)
    inv_ln = torch.where(ok, 1.0 / torch.where(ok, ln, torch.ones_like(ln)),
                         torch.zeros_like(ln))
    nx = -dy * inv_ln * hw
    ny = dx * inv_ln * hw

    # A_e = endpoint e shifted +n, B_e shifted -n; triangles (A0, B0, B1)
    # and (A0, B1, A1), whose corners come from endpoints (0, 0, 1) and
    # (0, 1, 1).
    ax0, ay0 = px[:, 0] + nx, py[:, 0] + ny
    bx0, by0 = px[:, 0] - nx, py[:, 0] - ny
    ax1, ay1 = px[:, 1] + nx, py[:, 1] + ny
    bx1, by1 = px[:, 1] - nx, py[:, 1] - ny
    sx = torch.cat([torch.stack([ax0, bx0, bx1], 1), torch.stack([ax0, bx1, ax1], 1)])
    sy = torch.cat([torch.stack([ay0, by0, by1], 1), torch.stack([ay0, by1, ay1], 1)])
    ends_of = ((0, 0, 1), (0, 1, 1))

    def per_endpoint(vals):  # (L, 2) -> (2L, 3)
        return torch.cat([torch.stack([vals[:, e] for e in idx], 1) for idx in ends_of])

    iw = per_endpoint(iw2)
    ar = torch.arange(nl, dtype=torch.int32, device=clip_positions.device)
    records = _edge_setup(
        sx, sy, per_endpoint(pz), iw, torch.cat([valid, valid]), torch.cat([ar, ar]),
        width, height, CullMode.NONE, FrontFace.COUNTER_CLOCKWISE,
        depth_clamp=depth_clamp, force_front=True,
    )

    attrs2 = pts[..., 4:]  # (L, 2, A)
    halves = []
    for j, idx in enumerate(ends_of):
        iw_j = iw[j * nl:(j + 1) * nl]
        blocks = []
        for c, e in enumerate(idx):
            iw_c = iw_j[:, c][:, None]
            blocks += [attrs2[:, e, :] * iw_c, iw_c, iw_c]  # front = 1
        halves.append(torch.cat(blocks, dim=1))
    return records, torch.cat(halves, dim=0).to(torch.float32)


def setup_points_with_attrs(
    clip_positions: torch.Tensor,  # (Nv, 4)
    point_indices: torch.Tensor,  # (P,) vertex indices
    varyings: torch.Tensor,  # (Nv, A)
    width: int,
    height: int,
    point_sizes: Optional[torch.Tensor] = None,  # (Nv,) pixels (PointSize)
    viewport: "tuple | None" = None,
    depth_clamp: bool = False,
    pt_valid: Optional[torch.Tensor] = None,  # (P,) extra mask (polygon cull)
) -> "tuple[TriangleRecords, torch.Tensor]":
    """Point setup (geometry.py:264-351): each point becomes a
    ``point_size`` square centred on its vertex (Vulkan 27.5), two
    triangles on the ordinary raster path; a point is drawn whole or not at
    all. ``point_sizes`` is the vertex stage's PointSize, 1.0 by default.
    Returns (records, corner data) with R = 2P."""
    point_indices = point_indices.reshape(-1).to(torch.int64)
    p = point_indices.shape[0]
    dev = clip_positions.device
    combined = torch.cat([clip_positions.to(torch.float32), varyings.to(torch.float32)], dim=1)
    pts = combined[point_indices]  # (P, 4+A)
    if point_sizes is not None:
        sizes = point_sizes.reshape(-1).to(torch.float32)[point_indices]
    else:
        sizes = torch.ones((p,), dtype=torch.float32, device=dev)

    d = pts[:, 3] if depth_clamp else pts[:, 3] - pts[:, 2]
    valid = d > NEAR_W_EPS
    if pt_valid is not None:
        valid = valid & pt_valid

    iw1 = 1.0 / torch.clamp(pts[:, 3], min=NEAR_W_EPS)
    ndc = pts[:, :3] * iw1[:, None]
    vx0, vy0, full_w, full_h = viewport if viewport is not None else (0, 0, width, height)
    cx = (ndc[:, 0] + 1.0) * (0.5 * full_w) - vx0
    cy = (ndc[:, 1] + 1.0) * (0.5 * full_h) - vy0
    h = 0.5 * torch.clamp(sizes, min=1e-3)

    # Corners clockwise on screen, (-,-) (+,-) (+,+) (-,+); triangles
    # (c0, c1, c2) and (c0, c2, c3).
    xs = (cx - h, cx + h, cx + h, cx - h)
    ys = (cy - h, cy - h, cy + h, cy + h)
    sx = torch.cat([torch.stack([xs[0], xs[1], xs[2]], 1), torch.stack([xs[0], xs[2], xs[3]], 1)])
    sy = torch.cat([torch.stack([ys[0], ys[1], ys[2]], 1), torch.stack([ys[0], ys[2], ys[3]], 1)])

    def dup(v):  # (P,) -> (2P, 3), constant across corners
        v3 = v[:, None].expand(p, 3)
        return torch.cat([v3, v3])

    ar = torch.arange(p, dtype=torch.int32, device=dev)
    records = _edge_setup(
        sx, sy, dup(ndc[:, 2]), dup(iw1), torch.cat([valid, valid]), torch.cat([ar, ar]),
        width, height, CullMode.NONE, FrontFace.COUNTER_CLOCKWISE,
        depth_clamp=depth_clamp, force_front=True,
    )
    iw1c = iw1[:, None]
    one_tri = torch.cat([pts[:, 4:] * iw1c, iw1c, iw1c] * 3, dim=1)
    return records, torch.cat([one_tri, one_tri], dim=0).to(torch.float32)


def triangle_facing(
    clip_positions: torch.Tensor,  # (Nv, 4)
    indices: torch.Tensor,  # (T, 3)
    front_face: FrontFace,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """(front, degenerate) facing classification per triangle in NDC
    (geometry.py:354-378)."""
    indices = indices.to(torch.int64)
    t = indices.shape[0]
    corners = clip_positions.to(torch.float32)[indices.reshape(-1)].reshape(t, 3, 4)
    w = torch.clamp(corners[..., 3], min=NEAR_W_EPS)
    nx = corners[..., 0] / w
    ny = corners[..., 1] / w
    det = (nx[:, 1] - nx[:, 0]) * (ny[:, 2] - ny[:, 0]) - (
        nx[:, 2] - nx[:, 0]
    ) * (ny[:, 1] - ny[:, 0])
    is_cw = det > 0.0
    front = is_cw if front_face == FrontFace.CLOCKWISE else ~is_cw
    return front, det == 0.0


def _lerp_fma(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``a + (b - a) * t`` rounded as the fused multiply-add that XLA
    contracts it into when the reference is compiled. The float32 product is
    exact in float64; the float64 sum and the cast to float32 then give the
    fused result, except where the sum lands exactly on a float32 tie (the
    cast then rounds it to even, which may differ from the fused result).
    Near-clipped corners reach screen coordinates far off-screen, where
    rounding the product and the sum apart moves the surface's interpolated
    positions."""
    d = (b - a).double()
    return (a.double() + d * t.double()).to(torch.float32)


def _clip_payload(corners: torch.Tensor, w_eps: float = NEAR_W_EPS,
                  clamp_z: bool = False):
    """Lerp the whole per-corner payload (xyzw | attrs…) across the z ≤ w
    plane (or, with ``clamp_z``, across w > 0 only), with static 2×
    expansion (geometry.py:381-419). Each lerp rounds as the fused
    multiply-add that XLA contracts it into when the reference is compiled
    (its frame function, or ``jax.jit`` of the setup)."""
    if clamp_z:
        d = corners[..., 3]
    else:
        d = corners[..., 3] - corners[..., 2]
    inside = d > w_eps
    c = inside.sum(dim=1)
    inside_i = inside.to(torch.int8)

    rot1 = torch.argmax(inside_i, dim=1)
    rot2 = (torch.argmin(inside_i, dim=1) + 1) % 3
    rot = torch.where(c == 1, rot1, torch.where(c == 2, rot2, torch.zeros_like(rot1)))
    idx = (rot[:, None] + torch.arange(3, device=corners.device)[None, :]) % 3
    v = torch.take_along_dim(corners, idx[:, :, None], dim=1)
    dv = v[..., 3] if clamp_z else v[..., 3] - v[..., 2]

    def isect(i, j):
        denom = dv[:, i] - dv[:, j]
        denom = torch.where(torch.abs(denom) > 1e-20, denom, torch.ones_like(denom))
        tt = torch.clamp((dv[:, i] - w_eps) / denom, 0.0, 1.0)[:, None]
        return _lerp_fma(v[:, i], v[:, j], tt)

    p01 = isect(0, 1)
    p12 = isect(1, 2)
    p02 = isect(0, 2)

    full = torch.stack([v[:, 0], v[:, 1], v[:, 2]], 1)
    one = torch.stack([v[:, 0], p01, p02], 1)
    two_a = torch.stack([v[:, 0], v[:, 1], p12], 1)
    two_b = torch.stack([v[:, 0], p12, p02], 1)

    c_ = c[:, None, None]
    out1 = torch.where(c_ == 3, full, torch.where(c_ == 2, two_a, one))
    corners2 = torch.cat([out1, two_b], dim=0)
    valid = torch.cat([c >= 1, c == 2], dim=0)
    return corners2, valid


def _records_from_corners(
    corners: torch.Tensor,  # (R, 3, 4) clipped clip-space positions
    valid: torch.Tensor,
    tri_id: torch.Tensor,
    width: int,
    height: int,
    cull_mode: CullMode,
    front_face: FrontFace,
    viewport: "tuple | None",
    depth_bias: "tuple[float, float] | None" = None,
    depth_clamp: bool = False,
    obary: Optional[torch.Tensor] = None,
) -> TriangleRecords:
    """Viewport transform + edge setup (geometry.py:422-456)."""
    w = torch.clamp(corners[..., 3], min=NEAR_W_EPS)
    iw = 1.0 / w
    ndc = corners[..., :3] * iw[..., None]
    if viewport is not None:
        vx0, vy0, full_w, full_h = viewport
    else:
        vx0, vy0, full_w, full_h = 0, 0, width, height
    sx = (ndc[..., 0] + 1.0) * (0.5 * full_w) - vx0
    sy = (ndc[..., 1] + 1.0) * (0.5 * full_h) - vy0
    sz = ndc[..., 2]
    return _edge_setup(
        sx, sy, sz, iw, valid, tri_id, width, height,
        cull_mode, front_face, depth_bias=depth_bias, depth_clamp=depth_clamp, obary=obary,
    )


def _edge_setup(
    sx: torch.Tensor,  # (R, 3) screen-space corner x (pixels)
    sy: torch.Tensor,
    sz: torch.Tensor,  # (R, 3) NDC depth
    iw: torch.Tensor,  # (R, 3) 1/w per corner
    valid: torch.Tensor,
    tri_id: torch.Tensor,
    width: int,
    height: int,
    cull_mode: CullMode,
    front_face: FrontFace,
    depth_bias: "tuple[float, float] | None" = None,
    depth_clamp: bool = False,
    force_front: bool = False,
    obary: Optional[torch.Tensor] = None,  # (R, 3, 3); None: the identity
) -> TriangleRecords:
    """Edge-equation setup from screen-space corners (geometry.py:459-555;
    setup_triangles' inline copy, 742-806, is the same arithmetic with the
    clip's ``obary`` in shade16)."""
    x0, x1, x2 = sx[:, 0], sx[:, 1], sx[:, 2]
    y0, y1, y2 = sy[:, 0], sy[:, 1], sy[:, 2]

    det = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    is_cw = det > 0.0
    if force_front:
        front = torch.ones_like(is_cw)
    else:
        front = is_cw if front_face == FrontFace.CLOCKWISE else ~is_cw

    valid = valid & (det != 0.0)
    if not force_front:
        if cull_mode == CullMode.BACK:
            valid = valid & front
        elif cull_mode == CullMode.FRONT:
            valid = valid & ~front

    one = torch.ones_like(det)
    s = torch.where(is_cw, one, -one)

    def edge(xi, yi, xj, yj):
        aa = (yi - yj) * s
        bb = (xj - xi) * s
        cc = -(aa * xi + bb * yi)
        dx = (xj - xi) * s
        dy = (yj - yi) * s
        tl = (dy < 0.0) | ((dy == 0.0) & (dx > 0.0))
        return aa, bb, cc, tl.to(torch.float32)

    a01, b01, c01, tl01 = edge(x0, y0, x1, y1)
    a12, b12, c12, tl12 = edge(x1, y1, x2, y2)
    a20, b20, c20, tl20 = edge(x2, y2, x0, y0)

    abs_det = torch.abs(det)
    pos = abs_det > 0.0
    inv_det = torch.where(pos, 1.0 / torch.where(pos, abs_det, one), torch.zeros_like(det))

    if depth_bias is not None and (depth_bias[0] or depth_bias[1]):
        bias_c, bias_s = float(depth_bias[0]), float(depth_bias[1])
        dzdx = inv_det * (a12 * sz[:, 0] + a20 * sz[:, 1] + a01 * sz[:, 2])
        dzdy = inv_det * (b12 * sz[:, 0] + b20 * sz[:, 1] + b01 * sz[:, 2])
        m = torch.maximum(torch.abs(dzdx), torch.abs(dzdy))
        zmax_abs = torch.amax(torch.abs(sz), dim=1)
        r = torch.exp2(torch.floor(torch.log2(torch.clamp(zmax_abs, min=1e-30))) - 23.0)
        o = bias_c * r + bias_s * m
        sz = sz + o[:, None]

    rast16 = torch.stack(
        [a01, b01, c01, a12, b12, c12, a20, b20, c20,
         tl01, tl12, tl20, inv_det, sz[:, 0], sz[:, 1], sz[:, 2]],
        dim=1,
    ).to(torch.float32)

    zeros = torch.zeros_like(det)
    if obary is None:
        bary = [one, zeros, zeros, one, zeros, zeros]
    else:
        bary = [obary[:, 0, 0], obary[:, 0, 1], obary[:, 1, 0], obary[:, 1, 1],
                obary[:, 2, 0], obary[:, 2, 1]]
    shade16 = torch.stack(
        [iw[:, 0], iw[:, 1], iw[:, 2],
         *bary,
         front.to(torch.float32),
         zeros, zeros, zeros, zeros, zeros, zeros],
        dim=1,
    ).to(torch.float32)

    xmin = torch.minimum(torch.minimum(x0, x1), x2)
    xmax = torch.maximum(torch.maximum(x0, x1), x2)
    ymin = torch.minimum(torch.minimum(y0, y1), y2)
    ymax = torch.maximum(torch.maximum(y0, y1), y2)
    valid = valid & (xmax > 0) & (xmin < width) & (ymax > 0) & (ymin < height)
    if not depth_clamp:
        zmin = torch.minimum(torch.minimum(sz[:, 0], sz[:, 1]), sz[:, 2])
        zmax = torch.maximum(torch.maximum(sz[:, 0], sz[:, 1]), sz[:, 2])
        valid = valid & (zmax >= 0.0) & (zmin <= 1.0)

    aabb = torch.stack([xmin, ymin, xmax, ymax], dim=1).to(torch.float32)
    rast16 = torch.where(valid[:, None], rast16, torch.zeros_like(rast16))
    return TriangleRecords(rast16, shade16, tri_id, valid, aabb)
