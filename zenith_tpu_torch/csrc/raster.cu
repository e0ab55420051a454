// K1: the segmented rasterizer, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel zenith_tpu/ops/raster.py::_segmented_kernel
// (raster.py:311; entry raster_segmented, plain branch). For every binned
// (tile, record) entry, in the tile's submission order, it evaluates the
// three edge functions at the pixel centre (+ sample offset) with the
// top-left rule, the barycentrics times inv_det, the plane depth (clamped,
// or rejected outside [0, 1]) and one of the eight depth compares, with an
// optional depth write. The last passing entry of a pixel defines its A+2
// perspective attribute planes.
//
// Order. The Pallas grid runs blocks one after another and a tile's blocks
// are consecutive; CUDA blocks run concurrently. Order only matters per
// pixel, so each pixel is owned by exactly one thread, which sees the tile's
// entries in submission order. The grid is (entry blocks) x (sub-regions of
// a tile): a CTA whose block does not start a tile (blk_init != 1) returns
// at once; the others each own one kSubH x kSubW sub-region of the tile and
// walk b, b+1, ... while blk_init stays 0 and the block holds entries (a
// tile's blocks are never empty; dead blocks, count 0, lie past every live
// block). No host sync is needed.
//
// The cull. Each warp owns a kWarpH x kWarpW block of pixels (kPix per
// lane). binning.bin_segmented gives every row an inclusive pixel rectangle
// (x0, y0, x1, y1) that holds every pixel its triangle can cover: the vertex
// AABB floored/ceiled and widened by one pixel, clamped to the surface. Per
// staged block each warp tests the rectangles of its entries against its
// pixel block (one lane per entry, one ballot per 32 entries) and walks only
// the entries that overlap, in order, skipping a lane-row of pixels whose
// rows the rectangle misses (a test uniform across the warp). It is exact:
// an entry that does not cover a pixel changes nothing there (not z, not
// the winner, not the stencil, which only covered fragments update, not the
// bound), so skipping it cannot change a result. The plain version does not
// cull, so bit-equality with it on the card checks the rectangles too.
//
// Staging. The 16 raster columns and the rectangle of a block's entries (K3:
// also the front flag, column kRast + a_n - 2) are copied into shared memory
// with cp.async (4-byte copies for the rows, whose stride 16 + 3 a_n need not
// keep 16-byte alignment; 16-byte copies for the rectangles), two buffers
// deep, so the next block loads while this one is walked.
//
// Exactness. Coverage tests e == 0 (top-left rule), so the edge, depth and
// attribute arithmetic must round exactly like the reference: every product
// and sum goes through __fmul_rn/__fadd_rn (never contracted into an FMA),
// in the reference's order ((a*x + b*y) + c) and (w0*z0 + w1*z1) + w2*z2.
//
// State. Per pixel a thread keeps (z, winning row) in registers (K3 also the
// stencil, K4 the bound). The attribute planes are not carried through the
// walk: after it each pixel recomputes its barycentrics from the winning row
// (the same rounded operations, hence the same bits) and writes its a_n
// planes once. Register use is independent of a_n.
//
// What bounds it on the H100: before this design one CTA of 256 threads
// walked a whole 32x128 tile and tested every entry against all 4,096
// pixels, so the most crowded tile (3,324 entries in the 1024^2 shadow map)
// ran on one SM while the others idled, and 99% of the pixel tests missed
// (shadow pass 8.5-8.6 ms, G-buffer pass 3.0-3.2 ms). Now a tile is spread
// over (tile_h / kSubH) x (tile_w / kSubW) CTAs and a warp evaluates only
// the entries whose rectangle reaches its pixels; what remains is the
// fragment work of the densest sub-regions, each CTA's walk over all of
// its tile's blocks (staging and ballots) and the z and plane traffic. Of
// nine shapes timed once on one card (NVIDIA H100 80GB HBM3, 700 W), 16x16
// CTAs of 8x8 warp blocks were the fastest: shadow pass 0.19-0.20 ms,
// G-buffer pass 0.14 ms, against 0.36-0.37 / 0.19-0.21 ms for 32x32 CTAs of
// 8x16 warps and 0.60 / 0.25 ms for 8x32 warps.
//
// K3 and K4 are this kernel with one more plane, as compile-time variants of
// the same template (kPlain is K1):
//
// K3 (kStencil) replaces _segmented_stencil_kernel (entry raster_segmented
// with stencil state): an int32 stencil plane (8-bit semantics) rides in
// registers beside z. Per fragment: coverage -> stencil test (reference &
// compare_mask against stored & compare_mask) -> depth test; fail_op,
// depth_fail_op or pass_op fires under write_mask, for fragments that never
// win the pixel too, so the stencil is updated inside the walk while the
// planes still only record the winning row (the depth pass decides the
// winner). The face state is chosen per record by its front*iw column when
// the faces differ.
//
// K4 (kPeel) replaces _segmented_peel_kernel (entry raster_segmented with
// z_bound): one bound value per pixel in registers and one more compare
// (the strict opposite of the depth compare) before the depth test.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

enum Variant { kPlain = 0, kStencil = 1, kPeel = 2 };

// The CTA's sub-region and the warp's pixel block: 16x16 pixels, four warps
// of 8x8 (2 pixels a lane), 16 CTAs to a 32x128 tile; the fastest of the
// nine shapes timed on the deferred frame's passes (PERF.md §6).
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
constexpr int kMaskWords = kMaxChunk / 32;
static_assert(32 % kWarpW == 0 && kWarpH % kLaneRows == 0, "a warp block is whole lane-rows");
static_assert(kSubW % kWarpW == 0 && kSubH % kWarpH == 0, "a sub-region is whole warp blocks");
static_assert(kThreads <= 1024 && kPix <= 32, "CTA or lane too large");

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

// Block b's raster columns and rectangles (K3: and front flags) into one
// staging buffer, as one cp.async group of every thread.
template <int V>
__device__ __forceinline__ void stage_block(float* s_rast, int4* s_rect, float* s_front,
                                            const float* __restrict__ rows,
                                            const int4* __restrict__ rects, int b, int count,
                                            int chunk, int row_stride, int a_n) {
  const float* src = rows + (size_t)b * chunk * row_stride;
  for (int e = threadIdx.x; e < count * kRast; e += kThreads) {
    const int i = e / kRast;
    cp_async4(s_rast + e, src + (size_t)i * row_stride + (e - i * kRast));
  }
  for (int i = threadIdx.x; i < count; i += kThreads)
    cp_async16(s_rect + i, rects + (size_t)b * chunk + i);
  if constexpr (V == kStencil) {
    for (int i = threadIdx.x; i < count; i += kThreads)
      cp_async4(s_front + i, src + (size_t)i * row_stride + kRast + a_n - 2);
  }
  cp_async_commit();
}

template <int V>
__global__ void __launch_bounds__(kThreads)
raster_segmented_kernel(const int* __restrict__ blk_tile_y, const int* __restrict__ blk_tile_x,
                        const int* __restrict__ blk_count, const int* __restrict__ blk_init,
                        const float* __restrict__ rows, const int4* __restrict__ rects,
                        float* __restrict__ z, float* __restrict__ acc, int num_blocks,
                        int chunk, int row_stride, int a_n, int wp, int hp, int tile_h,
                        int tile_w, int subs_x, int compare, int depth_write, int depth_clamp,
                        float off_x, float off_y, int* __restrict__ stencil,
                        StencilState sstate, const float* __restrict__ z_bound,
                        int bound_compare) {
  __shared__ __align__(16) float s_rast[2][kMaxChunk * kRast];
  __shared__ __align__(16) int4 s_rect[2][kMaxChunk];
  __shared__ float s_front[V == kStencil ? 2 : 1][V == kStencil ? kMaxChunk : 1];

  const int b0 = blockIdx.x;
  if (blk_init[b0] != 1) return;
  const int count0 = blk_count[b0];
  if (count0 <= 0) return;  // an empty draw changes nothing

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = blockIdx.y;
  // The warp's pixel block in tile coordinates, then in surface pixels
  // clipped to the tile.
  const int wy = (sub / subs_x) * kSubH + (warp / kWarpsX) * kWarpH;
  const int wx = (sub % subs_x) * kSubW + (warp % kWarpsX) * kWarpW;
  const int y_base = blk_tile_y[b0] * tile_h;
  const int x_base = blk_tile_x[b0] * tile_w;
  const bool warp_live = wy < tile_h && wx < tile_w;  // uniform across the warp
  const int bx0 = x_base + wx;
  const int by0 = y_base + wy;
  const int bx1 = x_base + min(wx + kWarpW, tile_w) - 1;
  const int by1 = y_base + min(wy + kWarpH, tile_h) - 1;

  // Lane l owns column l % kWarpW of the block and rows l / kWarpW + k *
  // kLaneRows, k < kPix.
  const int lx = wx + lane % kWarpW;
  const int gx = x_base + lx;
  const float px = __fadd_rn((float)gx, off_x);
  float zr[kPix];
  float py[kPix];
  int win[kPix];
  int sten[V == kStencil ? kPix : 1];
  float bnd[V == kPeel ? kPix : 1];
  unsigned live = 0;  // bit k: pixel k lies inside the tile
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int ly = wy + lane / kWarpW + k * kLaneRows;
    const int gy = y_base + ly;
    win[k] = -1;
    zr[k] = 0.0f;
    py[k] = __fadd_rn((float)gy, off_y);
    if constexpr (V == kStencil) sten[k] = 0;
    if constexpr (V == kPeel) bnd[k] = 0.0f;
    if (lx < tile_w && ly < tile_h) {
      live |= 1u << k;
      const size_t o = (size_t)gy * wp + gx;
      zr[k] = z[o];
      if constexpr (V == kStencil) sten[k] = stencil[o];
      if constexpr (V == kPeel) bnd[k] = z_bound[o];
    }
  }

  int b = b0;
  int buf = 0;
  int count = count0;
  stage_block<V>(s_rast[0], s_rect[0], s_front[0], rows, rects, b, count, chunk, row_stride, a_n);
  while (true) {
    const int nb = b + 1;
    const int ncount = (nb < num_blocks && blk_init[nb] == 0) ? blk_count[nb] : 0;
    if (ncount > 0) {
      const int nbuf = buf ^ 1;
      stage_block<V>(s_rast[nbuf], s_rect[nbuf], s_front[V == kStencil ? nbuf : 0], rows, rects,
                     nb, ncount, chunk, row_stride, a_n);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // block b is in buffer buf for every thread

    if (warp_live) {
      const float* sr = s_rast[buf];
      const int4* sq = s_rect[buf];
#pragma unroll 1
      for (int w = 0; w < kMaskWords && w * 32 < count; ++w) {
        const int i = w * 32 + lane;
        bool hit = false;
        if (i < count) {
          const int4 q = sq[i];
          hit = q.x <= bx1 && q.z >= bx0 && q.y <= by1 && q.w >= by0;
        }
        unsigned m = __ballot_sync(0xffffffffu, hit);
        while (m) {  // the warp's overlapping entries, in order
          const int e = w * 32 + __ffs(m) - 1;
          m &= m - 1;
          const int4 q = sq[e];
          const float4* r4 = reinterpret_cast<const float4*>(sr + e * kRast);
          float r[kRast];
#pragma unroll
          for (int c = 0; c < kRast / 4; ++c) {
            const float4 t = r4[c];
            r[4 * c] = t.x;
            r[4 * c + 1] = t.y;
            r[4 * c + 2] = t.z;
            r[4 * c + 3] = t.w;
          }
          const int row_id = b * chunk + e;
          StencilFace face = sstate.front;
          if constexpr (V == kStencil) {
            if (sstate.faces_differ && !(s_front[buf][e] > 0.0f)) face = sstate.back;
          }
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            // Lane-row k spans rows by0 + k * kLaneRows ... + kLaneRows - 1:
            // skip it, warp-uniformly, where the rectangle misses them.
            const int row_lo = by0 + k * kLaneRows;
            if (q.y > row_lo + kLaneRows - 1 || q.w < row_lo) continue;
            if (!((live >> k) & 1u)) continue;
            const float e01 = edge_eval(r, 0, px, py[k]);
            const float e12 = edge_eval(r, 1, px, py[k]);
            const float e20 = edge_eval(r, 2, px, py[k]);
            bool cov = ((e01 > 0.0f) || (e01 == 0.0f && r[9] > 0.0f)) &&
                       ((e12 > 0.0f) || (e12 == 0.0f && r[10] > 0.0f)) &&
                       ((e20 > 0.0f) || (e20 == 0.0f && r[11] > 0.0f));
            const float w0 = __fmul_rn(e12, r[12]);
            const float w1 = __fmul_rn(e20, r[12]);
            const float w2 = __fmul_rn(e01, r[12]);
            float zpx = __fadd_rn(__fadd_rn(__fmul_rn(w0, r[13]), __fmul_rn(w1, r[14])),
                                  __fmul_rn(w2, r[15]));
            if (depth_clamp) {
              if (!isnan(zpx)) zpx = fminf(fmaxf(zpx, 0.0f), 1.0f);
            } else {
              cov = cov && (zpx >= 0.0f) && (zpx <= 1.0f);
            }
            if constexpr (V == kPeel) cov = cov && depth_compare(bound_compare, zpx, bnd[k]);
            bool passed;
            if constexpr (V == kStencil) {
              // An uncovered pixel fails both tests and keeps its stencil.
              passed = cov && stencil_depth_test(face, depth_compare(compare, zpx, zr[k]), sten[k]);
            } else {
              passed = cov && depth_compare(compare, zpx, zr[k]);
            }
            if (passed) {
              if (depth_write) zr[k] = zpx;
              win[k] = row_id;
            }
          }
        }
      }
    }
    if (ncount <= 0) break;
    __syncthreads();  // every warp is done with buffer buf before it is refilled
    b = nb;
    buf ^= 1;
    count = ncount;
  }

  const size_t plane = (size_t)hp * wp;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (!((live >> k) & 1u)) continue;
    const int gy = by0 + lane / kWarpW + k * kLaneRows;
    const size_t o = (size_t)gy * wp + gx;
    z[o] = zr[k];
    if constexpr (V == kStencil) stencil[o] = sten[k];
    if (win[k] >= 0) {
      const float* r = rows + (size_t)win[k] * row_stride;
      const float e01 = edge_eval(r, 0, px, py[k]);
      const float e12 = edge_eval(r, 1, px, py[k]);
      const float e20 = edge_eval(r, 2, px, py[k]);
      const float w0 = __fmul_rn(e12, r[12]);
      const float w1 = __fmul_rn(e20, r[12]);
      const float w2 = __fmul_rn(e01, r[12]);
      const float* c0 = r + kRast;
      const float* c1 = c0 + a_n;
      const float* c2 = c1 + a_n;
      for (int a = 0; a < a_n; ++a) {
        acc[a * plane + o] = __fadd_rn(__fadd_rn(__fmul_rn(w0, c0[a]), __fmul_rn(w1, c1[a])),
                                       __fmul_rn(w2, c2[a]));
      }
    }
  }
}

template <int V>
int launch_raster(const int* blk_tile_y, const int* blk_tile_x, const int* blk_count,
                  const int* blk_init, const float* rows, const void* rects, float* z,
                  float* acc, int num_blocks, int chunk, int row_stride, int a_n, int wp, int hp,
                  int tile_h, int tile_w, int compare, int depth_write, int depth_clamp,
                  float off_x, float off_y, int* stencil, const StencilState& sstate,
                  const float* z_bound, int bound_compare, void* stream) {
  if (num_blocks <= 0) return 0;
  if (chunk <= 0 || chunk > kMaxChunk || tile_h <= 0 || tile_w <= 0)
    return (int)cudaErrorInvalidValue;
  const int subs_x = (tile_w + kSubW - 1) / kSubW;
  const int subs = subs_x * ((tile_h + kSubH - 1) / kSubH);
  if (subs > 65535) return (int)cudaErrorInvalidValue;
  raster_segmented_kernel<V><<<dim3(num_blocks, subs), kThreads, 0, (cudaStream_t)stream>>>(
      blk_tile_y, blk_tile_x, blk_count, blk_init, rows, (const int4*)rects, z, acc, num_blocks,
      chunk, row_stride, a_n, wp, hp, tile_h, tile_w, subs_x, compare, depth_write, depth_clamp,
      off_x, off_y, stencil, sstate, z_bound, bound_compare);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`, does
// not synchronise, allocates nothing; returns cudaGetLastError() after the
// launch. `rects` is the bins' (rows, 4) int32 rectangle table, 16-byte
// aligned.
extern "C" int zn_raster_segmented(const int* blk_tile_y, const int* blk_tile_x,
                                   const int* blk_count, const int* blk_init,
                                   const float* rows, const void* rects, float* z, float* acc,
                                   int num_blocks, int chunk, int row_stride, int a_n, int wp,
                                   int hp, int tile_h, int tile_w, int compare, int depth_write,
                                   int depth_clamp, float off_x, float off_y, void* stream) {
  return launch_raster<kPlain>(blk_tile_y, blk_tile_x, blk_count, blk_init, rows, rects, z, acc,
                               num_blocks, chunk, row_stride, a_n, wp, hp, tile_h, tile_w, compare,
                               depth_write, depth_clamp, off_x, off_y, nullptr, StencilState{},
                               nullptr, 0, stream);
}

// K3. `faces` holds 14 ints: (compare, fail_op, depth_fail_op, pass_op,
// reference, compare_mask, write_mask) of the front face, then of the back.
extern "C" int zn_raster_segmented_stencil(const int* blk_tile_y, const int* blk_tile_x,
                                           const int* blk_count, const int* blk_init,
                                           const float* rows, const void* rects, float* z,
                                           float* acc, int* stencil, int num_blocks, int chunk,
                                           int row_stride, int a_n, int wp, int hp, int tile_h,
                                           int tile_w, int compare, int depth_write,
                                           int depth_clamp, float off_x, float off_y,
                                           const int* faces, void* stream) {
  StencilState st;
  st.front = {faces[0], faces[1], faces[2], faces[3], faces[4], faces[5], faces[6]};
  st.back = {faces[7], faces[8], faces[9], faces[10], faces[11], faces[12], faces[13]};
  st.faces_differ = 0;
  for (int k = 0; k < 7; ++k) st.faces_differ |= (faces[k] != faces[7 + k]);
  return launch_raster<kStencil>(blk_tile_y, blk_tile_x, blk_count, blk_init, rows, rects, z,
                                 acc, num_blocks, chunk, row_stride, a_n, wp, hp, tile_h, tile_w,
                                 compare, depth_write, depth_clamp, off_x, off_y, stencil, st,
                                 nullptr, 0, stream);
}

// K4. `bound_compare` is the strict opposite of the depth compare (LESS for
// GREATER/GREATER_OR_EQUAL, GREATER for LESS/LESS_OR_EQUAL).
extern "C" int zn_raster_segmented_peel(const int* blk_tile_y, const int* blk_tile_x,
                                        const int* blk_count, const int* blk_init,
                                        const float* rows, const void* rects, float* z, float* acc,
                                        const float* z_bound, int num_blocks, int chunk,
                                        int row_stride, int a_n, int wp, int hp, int tile_h,
                                        int tile_w, int compare, int depth_write, int depth_clamp,
                                        float off_x, float off_y, int bound_compare,
                                        void* stream) {
  return launch_raster<kPeel>(blk_tile_y, blk_tile_x, blk_count, blk_init, rows, rects, z, acc,
                              num_blocks, chunk, row_stride, a_n, wp, hp, tile_h, tile_w, compare,
                              depth_write, depth_clamp, off_x, off_y, nullptr, StencilState{},
                              z_bound, bound_compare, stream);
}
