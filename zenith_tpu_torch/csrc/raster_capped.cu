// K7 and K8: the capped-bin rasterizers, hand-written for Hopper (sm_90a).
//
// K7 replaces the Pallas kernel zenith_tpu/ops/raster.py::_visibility_kernel
// (entry visibility_pass), K8 replaces raster.py::_interp_kernel (entry
// raster_interp_pass). Both walk a tile's first counts[t] records of its
// fixed-capacity bin (binning.bin_triangles: (T, K, 16) rows in record
// order) and evaluate, per pixel centre and record, the three edge functions
// with the top-left rule, the barycentrics times inv_det, the plane depth
// (rejected outside [0, 1]; these passes have no depth clamp) and one of the
// eight depth compares, with an optional depth write. The last passing
// record wins the pixel: K7 writes its slot (its global record index, read
// as int32 from binned_slot, where the reference packs it as a float column
// of the rows), K8 its a_n perspective planes w0*c0 + w1*c1 + w2*c2 from the
// record's corner data (T, K, 3*a_n), zero where nothing passed.
//
// Order. The Pallas grid walks a tile's k-blocks one after another; CUDA
// blocks run concurrently. So one CTA owns one tile (grid T, no routing
// tables) and walks its records in order, staging kChunk rows at a time in
// shared memory.
//
// Exactness. Coverage tests e == 0 (top-left rule), so every product and sum
// goes through __fmul_rn/__fadd_rn (never an FMA), in the reference's order
// ((a*x + b*y) + c, (w0*z0 + w1*z1) + w2*z2): the result equals the plain
// PyTorch version, and K8 equals K1 over the same records, bit for bit.
//
// State. As in K1 (raster.cu): 256 threads x 16 pixels, tiles up to 4096
// pixels (32x128 at 1080p); per pixel (z, winning record) in registers. K8
// recomputes the winner's barycentrics after the walk and writes its planes
// once, so its registers do not grow with a_n. Tiles past the image edge are
// padded by the wrapper to whole tiles (raster.py::_pad_plane).
//
// What bounds it on the H100: per-record ALU work (about 30 fp32 operations
// per pixel per record over the tile's pixels) against 64 bytes of row per
// record, staged once and broadcast from shared memory. One CTA walks a tile
// serially, so the tile with the most records is the critical path.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

constexpr int kCappedThreads = 256;
constexpr int kCappedPixels = 16;  // per thread: tile_h * tile_w <= 4096
constexpr int kChunk = 128;        // rows staged per step

template <bool kSlot>
__global__ void __launch_bounds__(kCappedThreads)
raster_capped_kernel(const int* __restrict__ counts, const float* __restrict__ rast,
                     const int* __restrict__ slots, const float* __restrict__ attr,
                     float* __restrict__ z, int* __restrict__ slot_out, float* __restrict__ acc,
                     int k, int a_n, int tiles_x, int wp, int hp, int tile_h, int tile_w,
                     int compare, int depth_write) {
  __shared__ float s_rast[kChunk * kRast];
  const int t = blockIdx.x;
  const int count = counts[t];
  const int npix = tile_h * tile_w;
  const int y_base = (t / tiles_x) * tile_h;
  const int x_base = (t % tiles_x) * tile_w;
  const float* tile_rows = rast + (size_t)t * k * kRast;

  float zr[kCappedPixels];
  int win[kCappedPixels];
  float px[kCappedPixels];
  float py[kCappedPixels];
#pragma unroll
  for (int q = 0; q < kCappedPixels; ++q) {
    const int p = threadIdx.x + q * kCappedThreads;
    win[q] = -1;
    zr[q] = 0.0f;
    px[q] = 0.0f;
    py[q] = 0.0f;
    if (p < npix) {
      const int gy = y_base + p / tile_w;
      const int gx = x_base + p % tile_w;
      zr[q] = z[(size_t)gy * wp + gx];
      px[q] = __fadd_rn((float)gx, 0.5f);
      py[q] = __fadd_rn((float)gy, 0.5f);
    }
  }

  for (int base = 0; base < count; base += kChunk) {
    const int n = min(kChunk, count - base);
    __syncthreads();  // the previous chunk's rows are consumed
    for (int e = threadIdx.x; e < n * kRast; e += kCappedThreads)
      s_rast[e] = tile_rows[(size_t)base * kRast + e];
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float* r = s_rast + i * kRast;
#pragma unroll
      for (int q = 0; q < kCappedPixels; ++q) {
        if (threadIdx.x + q * kCappedThreads < npix) {
          const float e01 = edge_eval(r, 0, px[q], py[q]);
          const float e12 = edge_eval(r, 1, px[q], py[q]);
          const float e20 = edge_eval(r, 2, px[q], py[q]);
          const bool cov = ((e01 > 0.0f) || (e01 == 0.0f && r[9] > 0.0f)) &&
                           ((e12 > 0.0f) || (e12 == 0.0f && r[10] > 0.0f)) &&
                           ((e20 > 0.0f) || (e20 == 0.0f && r[11] > 0.0f));
          const float w0 = __fmul_rn(e12, r[12]);
          const float w1 = __fmul_rn(e20, r[12]);
          const float w2 = __fmul_rn(e01, r[12]);
          const float zpx = __fadd_rn(__fadd_rn(__fmul_rn(w0, r[13]), __fmul_rn(w1, r[14])),
                                      __fmul_rn(w2, r[15]));
          if (cov && zpx >= 0.0f && zpx <= 1.0f && depth_compare(compare, zpx, zr[q])) {
            if (depth_write) zr[q] = zpx;
            win[q] = base + i;
          }
        }
      }
    }
  }

  const size_t plane = (size_t)hp * wp;
#pragma unroll
  for (int q = 0; q < kCappedPixels; ++q) {
    const int p = threadIdx.x + q * kCappedThreads;
    if (p < npix) {
      const int gy = y_base + p / tile_w;
      const int gx = x_base + p % tile_w;
      const size_t o = (size_t)gy * wp + gx;
      z[o] = zr[q];
      if constexpr (kSlot) {
        if (win[q] >= 0) slot_out[o] = slots[(size_t)t * k + win[q]];
      } else {
        if (win[q] < 0) {
          for (int a = 0; a < a_n; ++a) acc[a * plane + o] = 0.0f;
        } else {
          const float* r = tile_rows + (size_t)win[q] * kRast;
          const float e01 = edge_eval(r, 0, px[q], py[q]);
          const float e12 = edge_eval(r, 1, px[q], py[q]);
          const float e20 = edge_eval(r, 2, px[q], py[q]);
          const float w0 = __fmul_rn(e12, r[12]);
          const float w1 = __fmul_rn(e20, r[12]);
          const float w2 = __fmul_rn(e01, r[12]);
          const float* c0 = attr + ((size_t)t * k + win[q]) * 3 * a_n;
          const float* c1 = c0 + a_n;
          const float* c2 = c1 + a_n;
          for (int a = 0; a < a_n; ++a) {
            acc[a * plane + o] = __fadd_rn(
                __fadd_rn(__fmul_rn(w0, c0[a]), __fmul_rn(w1, c1[a])), __fmul_rn(w2, c2[a]));
          }
        }
      }
    }
  }
}

template <bool kSlot>
int launch_capped(const int* counts, const float* rast, const int* slots, const float* attr,
                  float* z, int* slot_out, float* acc, int num_tiles, int k, int a_n,
                  int tiles_x, int wp, int hp, int tile_h, int tile_w, int compare,
                  int depth_write, void* stream) {
  if (num_tiles <= 0) return 0;
  if (tile_h * tile_w > kCappedThreads * kCappedPixels) return (int)cudaErrorInvalidValue;
  raster_capped_kernel<kSlot><<<num_tiles, kCappedThreads, 0, (cudaStream_t)stream>>>(
      counts, rast, slots, attr, z, slot_out, acc, k, a_n, tiles_x, wp, hp, tile_h, tile_w,
      compare, depth_write);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`, does
// not synchronise, allocates nothing; returns cudaGetLastError() after the
// launch. z (hp, wp) and, for K7, slot (hp, wp) are updated in place; K8
// writes every value of acc (a_n, hp, wp).

// K7: rast (T, K, 16), slots (T, K) int32.
extern "C" int zn_visibility(const int* counts, const float* rast, const int* slots, float* z,
                             int* slot, int num_tiles, int k, int tiles_x, int wp, int tile_h,
                             int tile_w, int compare, int depth_write, void* stream) {
  return launch_capped<true>(counts, rast, slots, nullptr, z, slot, nullptr, num_tiles, k, 0,
                             tiles_x, wp, 0, tile_h, tile_w, compare, depth_write, stream);
}

// K8: rast (T, K, 16), attr (T, K, 3 * a_n).
extern "C" int zn_raster_interp(const int* counts, const float* rast, const float* attr,
                                float* z, float* acc, int num_tiles, int k, int a_n, int tiles_x,
                                int wp, int hp, int tile_h, int tile_w, int compare,
                                int depth_write, void* stream) {
  return launch_capped<false>(counts, rast, nullptr, attr, z, nullptr, acc, num_tiles, k, a_n,
                              tiles_x, wp, hp, tile_h, tile_w, compare, depth_write, stream);
}
