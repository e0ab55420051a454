// K1: the segmented rasterizer, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel zenith_tpu/ops/raster.py::_segmented_kernel
// (entry raster_segmented, plain branch). For every binned (tile, record)
// entry, in the tile's submission order, it evaluates the three edge
// functions at the pixel centre (+ sample offset) with the top-left rule,
// the barycentrics times inv_det, the plane depth (clamped, or rejected
// outside [0, 1]) and one of the eight depth compares, with an optional
// depth write. The last passing entry of a pixel defines its A+2
// perspective attribute planes.
//
// Order. The Pallas grid runs blocks one after another and a tile's blocks
// are consecutive; CUDA blocks run concurrently. So one CTA owns one tile:
// the launch has one CTA per entry block, a CTA whose block does not start a
// tile (blk_init != 1) returns at once, and the others walk b, b+1, ... while
// blk_init stays 0. Dead blocks route to the last live tile with count 0, so
// the walk passes over them harmlessly. No host sync is needed.
//
// Exactness. Coverage tests e == 0 (top-left rule), so the edge, depth and
// attribute arithmetic must round exactly like the reference: every product
// and sum goes through __fmul_rn/__fadd_rn (never contracted into an FMA),
// in the reference's order ((a*x + b*y) + c) and (w0*z0 + w1*z1) + w2*z2.
//
// State. Per pixel a thread keeps (z, winning row) in registers: 16 pixels
// per thread, 256 threads, tiles up to 4096 pixels (32x128 at 1080p, 8x128
// in the tests). The attribute planes are not carried through the walk: a
// pass only records the row index, and after the walk each pixel recomputes
// its barycentrics from the winning row (the same rounded operations, hence
// the same bits) and writes its a_n planes once. Register use is therefore
// independent of a_n (5 for the triangle, ~12 for a G-buffer pass).
//
// What bounds it on the H100: per-entry ALU work (about 30 fp32 operations
// per pixel per entry over the tile's 4096 pixels) against only 64 bytes of
// row data per entry, which the CTA stages in shared memory once per block
// and broadcasts. A tile's entries are walked serially by one CTA, so a tile
// with many entries is the critical path; the design keeps that walk free of
// global memory traffic (no attribute writes until the end).
//
// tile_h, tile_w and a_n are runtime parameters.
//
// K3 and K4 are this kernel with one more plane, as compile-time variants of
// the same template (kPlain is K1, unchanged):
//
// K3 (kStencil) replaces _segmented_stencil_kernel (entry raster_segmented
// with stencil state): an int32 stencil plane (8-bit semantics) rides in
// registers beside z. Per fragment: coverage -> stencil test (reference &
// compare_mask against stored & compare_mask) -> depth test; fail_op,
// depth_fail_op or pass_op fires under write_mask, for fragments that never
// win the pixel too, so the stencil is updated inside the walk while the
// planes still only record the winning row (the depth pass decides the
// winner). The face state is chosen per record by its front*iw column
// (16 + a_n - 2, staged beside the rast16 columns) when the faces differ.
//
// K4 (kPeel) replaces _segmented_peel_kernel (entry raster_segmented with
// z_bound): one bound value per pixel in registers and one more compare
// (the strict opposite of the depth compare) before the depth test.
//
// Both are bound like K1, by per-entry ALU work; each adds one plane read
// (and K3 one plane written) to K1's traffic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

enum Variant { kPlain = 0, kStencil = 1, kPeel = 2 };

constexpr int kThreads = 256;
constexpr int kMaxPixelsPerThread = 16;  // tile_h * tile_w <= 4096

template <int V>
__global__ void __launch_bounds__(kThreads)
raster_segmented_kernel(const int* __restrict__ blk_tile_y, const int* __restrict__ blk_tile_x,
                        const int* __restrict__ blk_count, const int* __restrict__ blk_init,
                        const float* __restrict__ rows, float* __restrict__ z,
                        float* __restrict__ acc, int num_blocks, int chunk, int row_stride,
                        int a_n, int wp, int hp, int tile_h, int tile_w, int compare,
                        int depth_write, int depth_clamp, float off_x, float off_y,
                        int* __restrict__ stencil, StencilState sstate,
                        const float* __restrict__ z_bound, int bound_compare) {
  extern __shared__ float s_rast[];  // chunk x kRast (+ chunk front flags for K3)
  const int b0 = blockIdx.x;
  if (blk_init[b0] != 1) return;

  const int npix = tile_h * tile_w;
  const int y_base = blk_tile_y[b0] * tile_h;
  const int x_base = blk_tile_x[b0] * tile_w;

  float zr[kMaxPixelsPerThread];
  int win[kMaxPixelsPerThread];
  float px[kMaxPixelsPerThread];
  float py[kMaxPixelsPerThread];
  int sten[V == kStencil ? kMaxPixelsPerThread : 1];
  float bnd[V == kPeel ? kMaxPixelsPerThread : 1];
  float* s_front = s_rast + chunk * kRast;  // K3 only
#pragma unroll
  for (int k = 0; k < kMaxPixelsPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    win[k] = -1;
    zr[k] = 0.0f;
    px[k] = 0.0f;
    py[k] = 0.0f;
    if constexpr (V == kStencil) sten[k] = 0;
    if constexpr (V == kPeel) bnd[k] = 0.0f;
    if (p < npix) {
      const int gy = y_base + p / tile_w;
      const int gx = x_base + p % tile_w;
      zr[k] = z[(size_t)gy * wp + gx];
      if constexpr (V == kStencil) sten[k] = stencil[(size_t)gy * wp + gx];
      if constexpr (V == kPeel) bnd[k] = z_bound[(size_t)gy * wp + gx];
      px[k] = __fadd_rn((float)gx, off_x);
      py[k] = __fadd_rn((float)gy, off_y);
    }
  }

  for (int b = b0; b < num_blocks && (b == b0 || blk_init[b] == 0); ++b) {
    const int count = blk_count[b];
    if (count <= 0) continue;  // uniform across the CTA
    __syncthreads();           // the previous block's rows are consumed
    const float* src = rows + (size_t)b * chunk * row_stride;
    for (int e = threadIdx.x; e < count * kRast; e += kThreads) {
      const int i = e / kRast;
      s_rast[e] = src[(size_t)i * row_stride + (e - i * kRast)];
    }
    if constexpr (V == kStencil) {
      for (int i = threadIdx.x; i < count; i += kThreads)
        s_front[i] = src[(size_t)i * row_stride + kRast + a_n - 2];
    }
    __syncthreads();
    for (int i = 0; i < count; ++i) {
      const float* r = s_rast + i * kRast;
      const int row_id = b * chunk + i;
      StencilFace face = sstate.front;
      if constexpr (V == kStencil) {
        if (sstate.faces_differ && !(s_front[i] > 0.0f)) face = sstate.back;
      }
#pragma unroll
      for (int k = 0; k < kMaxPixelsPerThread; ++k) {
        if (threadIdx.x + k * kThreads < npix) {
          const float e01 = edge_eval(r, 0, px[k], py[k]);
          const float e12 = edge_eval(r, 1, px[k], py[k]);
          const float e20 = edge_eval(r, 2, px[k], py[k]);
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

  const size_t plane = (size_t)hp * wp;
#pragma unroll
  for (int k = 0; k < kMaxPixelsPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p < npix) {
      const int gy = y_base + p / tile_w;
      const int gx = x_base + p % tile_w;
      const size_t o = (size_t)gy * wp + gx;
      z[o] = zr[k];
      if constexpr (V == kStencil) stencil[o] = sten[k];
      if (win[k] >= 0) {
        const float* r = rows + (size_t)win[k] * row_stride;
        const float e01 = edge_eval(r, 0, px[k], py[k]);
        const float e12 = edge_eval(r, 1, px[k], py[k]);
        const float e20 = edge_eval(r, 2, px[k], py[k]);
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
}

template <int V>
int launch_raster(const int* blk_tile_y, const int* blk_tile_x, const int* blk_count,
                  const int* blk_init, const float* rows, float* z, float* acc, int num_blocks,
                  int chunk, int row_stride, int a_n, int wp, int hp, int tile_h, int tile_w,
                  int compare, int depth_write, int depth_clamp, float off_x, float off_y,
                  int* stencil, const StencilState& sstate, const float* z_bound,
                  int bound_compare, void* stream) {
  if (num_blocks <= 0) return 0;
  if (tile_h * tile_w > kThreads * kMaxPixelsPerThread) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)chunk * (kRast + (V == kStencil ? 1 : 0)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        raster_segmented_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  raster_segmented_kernel<V><<<num_blocks, kThreads, smem, (cudaStream_t)stream>>>(
      blk_tile_y, blk_tile_x, blk_count, blk_init, rows, z, acc, num_blocks, chunk, row_stride,
      a_n, wp, hp, tile_h, tile_w, compare, depth_write, depth_clamp, off_x, off_y, stencil,
      sstate, z_bound, bound_compare);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`, does
// not synchronise, allocates nothing; returns cudaGetLastError() after the
// launch.
extern "C" int zn_raster_segmented(const int* blk_tile_y, const int* blk_tile_x,
                                   const int* blk_count, const int* blk_init,
                                   const float* rows, float* z, float* acc, int num_blocks,
                                   int chunk, int row_stride, int a_n, int wp, int hp,
                                   int tile_h, int tile_w, int compare, int depth_write,
                                   int depth_clamp, float off_x, float off_y, void* stream) {
  return launch_raster<kPlain>(blk_tile_y, blk_tile_x, blk_count, blk_init, rows, z, acc,
                               num_blocks, chunk, row_stride, a_n, wp, hp, tile_h, tile_w, compare,
                               depth_write, depth_clamp, off_x, off_y, nullptr, StencilState{},
                               nullptr, 0, stream);
}

// K3. `faces` holds 14 ints: (compare, fail_op, depth_fail_op, pass_op,
// reference, compare_mask, write_mask) of the front face, then of the back.
extern "C" int zn_raster_segmented_stencil(const int* blk_tile_y, const int* blk_tile_x,
                                           const int* blk_count, const int* blk_init,
                                           const float* rows, float* z, float* acc, int* stencil,
                                           int num_blocks, int chunk, int row_stride, int a_n,
                                           int wp, int hp, int tile_h, int tile_w, int compare,
                                           int depth_write, int depth_clamp, float off_x,
                                           float off_y, const int* faces, void* stream) {
  StencilState st;
  st.front = {faces[0], faces[1], faces[2], faces[3], faces[4], faces[5], faces[6]};
  st.back = {faces[7], faces[8], faces[9], faces[10], faces[11], faces[12], faces[13]};
  st.faces_differ = 0;
  for (int k = 0; k < 7; ++k) st.faces_differ |= (faces[k] != faces[7 + k]);
  return launch_raster<kStencil>(blk_tile_y, blk_tile_x, blk_count, blk_init, rows, z, acc,
                                 num_blocks, chunk, row_stride, a_n, wp, hp, tile_h, tile_w,
                                 compare, depth_write, depth_clamp, off_x, off_y, stencil, st,
                                 nullptr, 0, stream);
}

// K4. `bound_compare` is the strict opposite of the depth compare (LESS for
// GREATER/GREATER_OR_EQUAL, GREATER for LESS/LESS_OR_EQUAL).
extern "C" int zn_raster_segmented_peel(const int* blk_tile_y, const int* blk_tile_x,
                                        const int* blk_count, const int* blk_init,
                                        const float* rows, float* z, float* acc,
                                        const float* z_bound, int num_blocks, int chunk,
                                        int row_stride, int a_n, int wp, int hp, int tile_h,
                                        int tile_w, int compare, int depth_write, int depth_clamp,
                                        float off_x, float off_y, int bound_compare,
                                        void* stream) {
  return launch_raster<kPeel>(blk_tile_y, blk_tile_x, blk_count, blk_init, rows, z, acc,
                              num_blocks, chunk, row_stride, a_n, wp, hp, tile_h, tile_w, compare,
                              depth_write, depth_clamp, off_x, off_y, nullptr, StencilState{},
                              z_bound, bound_compare, stream);
}
