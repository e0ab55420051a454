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
// deep, so the next block loads while this one is walked. The walk, the
// staging, the ballot and the shape constants are in raster_common.cuh,
// shared with K5 and K6 (raster_blend.cu).
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

  const WarpPixels pix = warp_pixels(blk_tile_y[b0], blk_tile_x[b0], tile_h, tile_w, subs_x);
  const float px = __fadd_rn((float)pix.gx, off_x);
  float zr[kPix];
  float py[kPix];
  int win[kPix];
  int sten[V == kStencil ? kPix : 1];
  float bnd[V == kPeel ? kPix : 1];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int gy = pixel_row(pix, k);
    win[k] = -1;
    zr[k] = 0.0f;
    py[k] = __fadd_rn((float)gy, off_y);
    if constexpr (V == kStencil) sten[k] = 0;
    if constexpr (V == kPeel) bnd[k] = 0.0f;
    if ((pix.live >> k) & 1u) {
      const size_t o = (size_t)gy * wp + pix.gx;
      zr[k] = z[o];
      if constexpr (V == kStencil) sten[k] = stencil[o];
      if constexpr (V == kPeel) bnd[k] = z_bound[o];
    }
  }

  // Per block: its raster columns and rectangles (K3: and front flags,
  // column kRast + a_n - 2).
  auto stage = [&](int buf, int b, int count) {
    stage_columns(s_rast[buf], rows, b, count, chunk, row_stride, 0, kRast);
    stage_rects(s_rect[buf], rects, b, count, chunk);
    if constexpr (V == kStencil) {
      stage_columns(s_front[buf], rows, b, count, chunk, row_stride, kRast + a_n - 2, 1);
    }
  };
  auto visit = [&](int buf, int b, int count) {
    if (!pix.warp_live) return;
    for_each_overlap(pix, s_rect[buf], count, [&](int e) {
      const int4 q = s_rect[buf][e];
      float r[kRast];
      load_rast(s_rast[buf], e, r);
      const int row_id = b * chunk + e;
      StencilFace face = sstate.front;
      if constexpr (V == kStencil) {
        if (sstate.faces_differ && !(s_front[buf][e] > 0.0f)) face = sstate.back;
      }
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        // Skip lane-row k, warp-uniformly, where the rectangle misses it.
        if (!rows_reach(pix, q, k)) continue;
        if (!((pix.live >> k) & 1u)) continue;
        Fragment f = fragment(r, px, py[k], depth_clamp);
        if constexpr (V == kPeel) f.cov = f.cov && depth_compare(bound_compare, f.z, bnd[k]);
        bool passed;
        if constexpr (V == kStencil) {
          // An uncovered pixel fails both tests and keeps its stencil.
          passed = f.cov && stencil_depth_test(face, depth_compare(compare, f.z, zr[k]), sten[k]);
        } else {
          passed = f.cov && depth_compare(compare, f.z, zr[k]);
        }
        if (passed) {
          if (depth_write) zr[k] = f.z;
          win[k] = row_id;
        }
      }
    });
  };
  walk_tile_blocks(blk_count, blk_init, num_blocks, b0, count0, stage, visit);

  const size_t plane = (size_t)hp * wp;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (!((pix.live >> k) & 1u)) continue;
    const size_t o = (size_t)pixel_row(pix, k) * wp + pix.gx;
    z[o] = zr[k];
    if constexpr (V == kStencil) stencil[o] = sten[k];
    if (win[k] >= 0) {
      const float* r = rows + (size_t)win[k] * row_stride;
      const Fragment f = fragment(r, px, py[k], depth_clamp);
      const float* c0 = r + kRast;
      const float* c1 = c0 + a_n;
      const float* c2 = c1 + a_n;
      for (int a = 0; a < a_n; ++a) {
        acc[a * plane + o] = __fadd_rn(__fadd_rn(__fmul_rn(f.w0, c0[a]), __fmul_rn(f.w1, c1[a])),
                                       __fmul_rn(f.w2, c2[a]));
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
