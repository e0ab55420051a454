// Device helpers shared by the rasterizers: K1, K3 and K4 (raster.cu), K5
// and K6 (raster_blend.cu), K7 and K8 (raster_capped.cu). Everything that
// decides coverage or depth rounds each product and sum on its own
// (__fmul_rn/__fadd_rn, never an FMA), in the reference's order.
//
// All of them walk a tile the same way (raster.cu's source note says why):
// the grid spreads each tile over kSubH x kSubW sub-regions; the CTAs of a
// tile each walk all of its entries in order, staging them a chunk at a
// time two buffers deep with cp.async (walk_chunks: over the segmented
// bins' blocks, walk_tile_blocks; over a capped bin's rows,
// walk_row_chunks); each of a CTA's warps owns a kWarpH x kWarpW block of
// pixels, kPix a lane, and visits only the entries whose pixel rectangle
// (SegmentedBins.rect, TileBins.rect) reaches that block
// (for_each_overlap).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// One face of the stencil state (rhi.state.StencilOpState). Compare codes
// are depth_compare's; op codes: 0 KEEP, 1 ZERO, 2 REPLACE, 3
// INCREMENT_AND_CLAMP, 4 DECREMENT_AND_CLAMP, 5 INVERT, 6 INCREMENT_AND_WRAP,
// 7 DECREMENT_AND_WRAP.
struct StencilFace {
  int compare, fail_op, depth_fail_op, pass_op, reference, compare_mask, write_mask;
};

struct StencilState {
  StencilFace front, back;
  int faces_differ;
};

constexpr int kRast = 16;                // rast16 columns at the head of a row

// Column layout of a merged row (zenith_tpu/ops/geometry.py RAST_*):
// 0-8 edge (a, b, c) x3, 9-11 top-left flags, 12 inv_det, 13-15 corner z,
// then 3 corners x a_n attribute columns [attr*iw..., front*iw, iw].

__device__ __forceinline__ float edge_eval(const float* r, int k, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[3 * k], x), __fmul_rn(r[3 * k + 1], y)), r[3 * k + 2]);
}

__device__ __forceinline__ bool depth_compare(int op, float n, float c) {
  switch (op) {
    case 0: return false;   // NEVER
    case 1: return n < c;   // LESS
    case 2: return n == c;  // EQUAL
    case 3: return n <= c;  // LESS_OR_EQUAL
    case 4: return n > c;   // GREATER
    case 5: return n != c;  // NOT_EQUAL
    case 6: return n >= c;  // GREATER_OR_EQUAL
    default: return true;   // ALWAYS
  }
}

__device__ __forceinline__ bool int_compare(int op, int n, int c) {
  switch (op) {
    case 0: return false;
    case 1: return n < c;
    case 2: return n == c;
    case 3: return n <= c;
    case 4: return n > c;
    case 5: return n != c;
    case 6: return n >= c;
    default: return true;
  }
}

__device__ __forceinline__ int stencil_apply(int op, int s, int reference) {
  switch (op) {
    case 1: return 0;
    case 2: return reference & 0xFF;
    case 3: return min(s + 1, 255);
    case 4: return max(s - 1, 0);
    case 5: return ~s & 0xFF;
    case 6: return (s + 1) & 0xFF;
    case 7: return (s - 1) & 0xFF;
    default: return s;
  }
}

// Stencil test + depth test + stencil write for one covered fragment
// (Vulkan 27.18-27.19). Returns whether the fragment passed both tests.
__device__ __forceinline__ bool stencil_depth_test(const StencilFace& f, bool depth_ok,
                                                   int& sten) {
  const int s = sten;
  const bool spass = int_compare(f.compare, (f.reference & f.compare_mask) & 0xFF,
                                 s & (f.compare_mask & 0xFF));
  const bool dpass = spass && depth_ok;
  const int op = !spass ? f.fail_op : (dpass ? f.pass_op : f.depth_fail_op);
  const int out = stencil_apply(op, s, f.reference);
  const int wmask = f.write_mask & 0xFF;
  sten = (wmask == 0xFF) ? out : ((s & ~wmask) | (out & wmask));
  return dpass;
}


// The CTA's sub-region and the warp's pixel block: 16x16 pixels, four warps
// of 8x8 (2 pixels a lane), 16 CTAs to a 32x128 tile; the fastest of the
// nine shapes timed on the deferred frame's K1 passes (PERF.md §6).
constexpr int kSubH = 16;
constexpr int kSubW = 16;
constexpr int kWarpH = 8;
constexpr int kWarpW = 8;
constexpr int kWarpsX = kSubW / kWarpW;
constexpr int kWarps = (kSubH / kWarpH) * kWarpsX;
constexpr int kThreads = 32 * kWarps;
constexpr int kLaneRows = 32 / kWarpW;     // pixel rows the lanes span at once
constexpr int kPix = kWarpH / kLaneRows;   // pixels per lane
constexpr int kMaxChunk = 128;             // entries per block (binning.ENTRY_CHUNK)
static_assert(32 % kWarpW == 0 && kWarpH % kLaneRows == 0, "a warp block is whole lane-rows");
static_assert(kSubW % kWarpW == 0 && kSubH % kWarpH == 0, "a sub-region is whole warp blocks");
static_assert(kThreads <= 1024 && kPix <= 32, "CTA or lane too large");

// Where a thread's pixels lie: its warp's pixel block inside the CTA's
// sub-region of tile (tile_y, tile_x), clipped to the tile. Lane l owns
// column l % kWarpW of the block and rows l / kWarpW + k * kLaneRows,
// k < kPix; bit k of `live` says whether that pixel lies inside the tile.
struct WarpPixels {
  int bx0, by0, bx1, by1;  // the block's surface pixels, inclusive
  int gx;                  // the lane's surface column
  unsigned live;
  bool warp_live;          // uniform across the warp
};

__device__ __forceinline__ WarpPixels warp_pixels(int tile_y, int tile_x, int tile_h,
                                                  int tile_w, int subs_x) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = blockIdx.y;
  const int wy = (sub / subs_x) * kSubH + (warp / kWarpsX) * kWarpH;
  const int wx = (sub % subs_x) * kSubW + (warp % kWarpsX) * kWarpW;
  const int y_base = tile_y * tile_h;
  const int x_base = tile_x * tile_w;
  WarpPixels p;
  p.warp_live = wy < tile_h && wx < tile_w;
  p.bx0 = x_base + wx;
  p.by0 = y_base + wy;
  p.bx1 = x_base + min(wx + kWarpW, tile_w) - 1;
  p.by1 = y_base + min(wy + kWarpH, tile_h) - 1;
  const int lx = wx + lane % kWarpW;
  p.gx = x_base + lx;
  p.live = 0;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (lx < tile_w && wy + lane / kWarpW + k * kLaneRows < tile_h) p.live |= 1u << k;
  }
  return p;
}

// The surface row of the lane's pixel k.
__device__ __forceinline__ int pixel_row(const WarpPixels& p, int k) {
  return p.by0 + (threadIdx.x & 31) / kWarpW + k * kLaneRows;
}

// Whether lane-row k of the block (rows by0 + k * kLaneRows ... + kLaneRows
// - 1) holds a row of rectangle q: a test uniform across the warp.
__device__ __forceinline__ bool rows_reach(const WarpPixels& p, const int4& q, int k) {
  const int row_lo = p.by0 + k * kLaneRows;
  return q.y <= row_lo + kLaneRows - 1 && q.w >= row_lo;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Columns [col, col + ncols) of block b's first `count` rows into `dst`
// (row stride ncols), with 4-byte cp.async copies by every thread of the
// CTA: a row of 16 + 3 a_n floats need not start 16-byte aligned. The caller
// commits.
__device__ __forceinline__ void stage_columns(float* dst, const float* __restrict__ rows, int b,
                                              int count, int chunk, int row_stride, int col,
                                              int ncols) {
  const float* src = rows + (size_t)b * chunk * row_stride + col;
  for (int e = threadIdx.x; e < count * ncols; e += kThreads) {
    const int i = e / ncols;
    cp_async4(dst + e, src + (size_t)i * row_stride + (e - i * ncols));
  }
}

// n 16-byte pieces from `src` into `dst` (both 16-byte aligned) with
// 16-byte cp.async copies by every thread of the CTA. The caller commits.
__device__ __forceinline__ void stage16(void* dst, const void* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    cp_async16(static_cast<int4*>(dst) + i, static_cast<const int4*>(src) + i);
  }
}

// Block b's rectangles into `dst` (the table is 16-byte aligned). The
// caller commits.
__device__ __forceinline__ void stage_rects(int4* dst, const int4* __restrict__ rects, int b,
                                            int count, int chunk) {
  stage16(dst, rects + (size_t)b * chunk, count);
}

// The CTA's walk over chunks of entries, in order: chunk c0 (count0
// entries), then c0 + 1, ... while next(c) gives chunk c a count above 0.
// stage(buf, c, count) starts chunk c's copies into staging buffer buf;
// visit(buf, c, count) walks it once every thread's copies landed. The next
// chunk loads while this one is walked (two buffers).
template <typename Next, typename Stage, typename Visit>
__device__ __forceinline__ void walk_chunks(int c0, int count0, Next&& next, Stage&& stage,
                                            Visit&& visit) {
  int c = c0;
  int buf = 0;
  int count = count0;
  stage(0, c, count);
  cp_async_commit();
  while (true) {
    const int ncount = next(c + 1);
    if (ncount > 0) {
      stage(buf ^ 1, c + 1, ncount);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c is in buffer buf for every thread
    visit(buf, c, count);
    if (ncount <= 0) break;
    __syncthreads();  // every warp is done with buffer buf before it is refilled
    ++c;
    buf ^= 1;
    count = ncount;
  }
}

// K1-K6: one tile's blocks from b0 (blk_init[b0] == 1, count0 entries), in
// order, while blk_init stays 0 and the next block holds entries (a tile's
// blocks are never empty; dead blocks, count 0, lie past every live one).
template <typename Stage, typename Visit>
__device__ __forceinline__ void walk_tile_blocks(const int* __restrict__ blk_count,
                                                 const int* __restrict__ blk_init,
                                                 int num_blocks, int b0, int count0,
                                                 Stage&& stage, Visit&& visit) {
  walk_chunks(
      b0, count0,
      [&](int nb) { return (nb < num_blocks && blk_init[nb] == 0) ? blk_count[nb] : 0; },
      stage, visit);
}

// K7/K8: a capped bin's first `count` rows (count > 0), which lie one after
// another, kMaxChunk at a time: chunk c holds rows c * kMaxChunk onward.
template <typename Stage, typename Visit>
__device__ __forceinline__ void walk_row_chunks(int count, Stage&& stage, Visit&& visit) {
  walk_chunks(
      0, min(count, kMaxChunk),
      [&](int c) { return min(kMaxChunk, count - c * kMaxChunk); }, stage, visit);
}

// The warp's pixel block against a staged block's rectangles: visit(e) for
// every entry e < count whose rectangle overlaps the block, in order (one
// lane per entry, one ballot per 32 entries). Exact: an entry that covers
// none of the block's pixels changes nothing there.
template <typename Visit>
__device__ __forceinline__ void for_each_overlap(const WarpPixels& p, const int4* rect, int count,
                                                 Visit&& visit) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int w = 0; w * 32 < count; ++w) {
    const int i = w * 32 + lane;
    bool hit = false;
    if (i < count) {
      const int4 q = rect[i];
      hit = q.x <= p.bx1 && q.z >= p.bx0 && q.y <= p.by1 && q.w >= p.by0;
    }
    unsigned m = __ballot_sync(0xffffffffu, hit);
    while (m) {  // the overlapping entries, in order
      const int e = w * 32 + __ffs(m) - 1;
      m &= m - 1;
      visit(e);
    }
  }
}

// The edge functions, coverage (top-left rule), barycentrics x inv_det and
// plane depth of row r at (x, y), with the depth clamp or the [0, 1] range
// test: the reference's rounded operations in its order.
struct Fragment {
  float w0, w1, w2, z;
  bool cov;
};

__device__ __forceinline__ Fragment fragment(const float* r, float x, float y, int depth_clamp) {
  const float e01 = edge_eval(r, 0, x, y);
  const float e12 = edge_eval(r, 1, x, y);
  const float e20 = edge_eval(r, 2, x, y);
  Fragment f;
  f.cov = ((e01 > 0.0f) || (e01 == 0.0f && r[9] > 0.0f)) &&
          ((e12 > 0.0f) || (e12 == 0.0f && r[10] > 0.0f)) &&
          ((e20 > 0.0f) || (e20 == 0.0f && r[11] > 0.0f));
  f.w0 = __fmul_rn(e12, r[12]);
  f.w1 = __fmul_rn(e20, r[12]);
  f.w2 = __fmul_rn(e01, r[12]);
  f.z = __fadd_rn(__fadd_rn(__fmul_rn(f.w0, r[13]), __fmul_rn(f.w1, r[14])),
                  __fmul_rn(f.w2, r[15]));
  if (depth_clamp) {
    if (!isnan(f.z)) f.z = fminf(fmaxf(f.z, 0.0f), 1.0f);
  } else {
    f.cov = f.cov && (f.z >= 0.0f) && (f.z <= 1.0f);
  }
  return f;
}

// A staged row's 16 raster columns, read as four float4 (the staging
// buffer's rows are 16 floats, 16-byte aligned).
__device__ __forceinline__ void load_rast(const float* s_rast, int e, float* r) {
  const float4* r4 = reinterpret_cast<const float4*>(s_rast + e * kRast);
#pragma unroll
  for (int c = 0; c < kRast / 4; ++c) {
    const float4 t = r4[c];
    r[4 * c] = t.x;
    r[4 * c + 1] = t.y;
    r[4 * c + 2] = t.z;
    r[4 * c + 3] = t.w;
  }
}

}  // namespace
