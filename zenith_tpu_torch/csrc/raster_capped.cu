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
// record's corner data (T, K, 3*a_n). The wrapper zero-fills the planes, so
// K8 writes only the pixels a record won.
//
// The walk is K1's (raster.cu; the helpers are in raster_common.cuh), over
// the capped layout. The grid is (tiles) x (kSubH x kSubW sub-regions of a
// tile): 16 CTAs of 16x16 pixels to a 32x128 tile, 4 warps of 8x8 pixels to
// a CTA, 2 pixels a lane. A CTA whose tile holds no record returns at once;
// the others walk the tile's rows 0 ... counts[t] - 1 in order, kMaxChunk
// at a time (walk_row_chunks). Tiles of any size split this way, so the
// kernels take any tile shape (subs <= 65535).
//
// Order. Each pixel is owned by exactly one thread, and every CTA of a tile
// sees all of its records in slot order, so EQUAL ties, depth-write-off
// overdraw and "the last passing record wins" resolve as in the reference.
// One tile's records are never split over CTAs.
//
// The cull. binning.bin_triangles gives every slot its record's inclusive
// pixel rectangle (TileBins.rect, (T, K, 4) int32: x0, y0, x1, y1), which
// holds every pixel centre the triangle can cover: the vertex AABB
// floored/ceiled and widened by one pixel, clamped to the padded surface
// before the int cast (a near-clipped record's AABB reaches thousands of
// pixels off it); pad slots hold the empty rectangle (0, 0, -1, -1) and lie
// past counts[t], so they are never visited. Per staged chunk each warp
// ballots the rectangles against its pixel block and evaluates only the
// records that overlap, in order, skipping a lane-row whose rows the
// rectangle misses (for_each_overlap, rows_reach). It is exact: a record
// that covers no pixel of a warp changes nothing there (not z, not the
// winner), so skipping it cannot change a result. The plain versions do not
// cull, so bit-equality with them on the card checks the rectangles too.
//
// Staging. A capped row is 16 floats (64 bytes) and a rectangle 16 bytes,
// and a chunk's rows and rectangles lie contiguous, so both are copied with
// 16-byte cp.async (the wrapper checks that both tables are 16-byte
// aligned), two buffers deep: 2 x 128 x 80 bytes = 20 KB of shared memory.
//
// Exactness. Coverage tests e == 0 (top-left rule), so every product and sum
// goes through __fmul_rn/__fadd_rn (never an FMA), in the reference's order
// ((a*x + b*y) + c, (w0*z0 + w1*z1) + w2*z2): the result equals the plain
// PyTorch version, and K8 equals K1 over the same records, bit for bit.
//
// State. Per pixel (z, winning row) in registers. After the walk K8
// recomputes the winner's barycentrics from its row (the same rounded
// operations, hence the same bits) and writes its a_n planes once, so
// register use does not grow with a_n. Tiles past the image edge are padded
// by the wrapper to whole tiles (raster.py::_pad_plane).
//
// What bounds it on the H100: the fragment work of the densest sub-regions
// (about 30 fp32 operations per covered pixel and record a warp cannot
// cull), plus every CTA's walk over all of its tile's rows (staging 80 bytes
// a row and one ballot per 32 rows, 16 times over for a 32x128 tile), plus
// the z, slot and plane traffic. Before this design one CTA of 256 threads
// owned a whole tile and tested every record at all of its 4,096 pixels
// with no cull, so the tile with the most records ran on one SM while the
// others idled, and nearly every pixel test missed: 3.0-3.4 ms on the
// deferred G-buffer view, 8.7-9.3 ms on its 1024^2 shadow view, 7.4-8.1 ms
// on the 1080p stress draw (NVIDIA H100 80GB HBM3, 700 W), 10-41 times K1's
// time on the same records. Now the work spreads over 16 CTAs a tile and a
// warp evaluates only the records that reach its pixels, as in K1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

template <bool kSlot>
__global__ void __launch_bounds__(kThreads)
raster_capped_kernel(const int* __restrict__ counts, const float* __restrict__ rast,
                     const int4* __restrict__ rects, const int* __restrict__ slots,
                     const float* __restrict__ attr, float* __restrict__ z,
                     int* __restrict__ slot_out, float* __restrict__ acc, int k, int a_n,
                     int tiles_x, int wp, int hp, int tile_h, int tile_w, int subs_x,
                     int compare, int depth_write) {
  __shared__ __align__(16) float s_rast[2][kMaxChunk * kRast];
  __shared__ __align__(16) int4 s_rect[2][kMaxChunk];

  const int t = blockIdx.x;
  const int count = counts[t];
  if (count <= 0) return;  // no record: z and the outputs keep their seed

  const WarpPixels pix = warp_pixels(t / tiles_x, t % tiles_x, tile_h, tile_w, subs_x);
  const float* tile_rows = rast + (size_t)t * k * kRast;
  const int4* tile_rects = rects + (size_t)t * k;
  const float px = __fadd_rn((float)pix.gx, 0.5f);
  float zr[kPix];
  float py[kPix];
  int win[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    const int gy = pixel_row(pix, q);
    win[q] = -1;
    zr[q] = 0.0f;
    py[q] = __fadd_rn((float)gy, 0.5f);
    if ((pix.live >> q) & 1u) zr[q] = z[(size_t)gy * wp + pix.gx];
  }

  // Chunk c: rows c * kMaxChunk ... + n - 1, their raster columns and
  // rectangles, each contiguous and 16-byte aligned.
  auto stage = [&](int buf, int c, int n) {
    stage16(s_rast[buf], tile_rows + (size_t)c * kMaxChunk * kRast, n * (kRast / 4));
    stage16(s_rect[buf], tile_rects + (size_t)c * kMaxChunk, n);
  };
  auto visit = [&](int buf, int c, int n) {
    if (!pix.warp_live) return;
    for_each_overlap(pix, s_rect[buf], n, [&](int e) {
      const int4 q = s_rect[buf][e];
      float r[kRast];
      load_rast(s_rast[buf], e, r);
      const int row = c * kMaxChunk + e;
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        // Skip lane-row j, warp-uniformly, where the rectangle misses it.
        if (!rows_reach(pix, q, j)) continue;
        if (!((pix.live >> j) & 1u)) continue;
        const Fragment f = fragment(r, px, py[j], 0);
        if (f.cov && depth_compare(compare, f.z, zr[j])) {
          if (depth_write) zr[j] = f.z;
          win[j] = row;
        }
      }
    });
  };
  walk_row_chunks(count, stage, visit);

  const size_t plane = (size_t)hp * wp;
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    if (!((pix.live >> q) & 1u)) continue;
    const size_t o = (size_t)pixel_row(pix, q) * wp + pix.gx;
    if (depth_write) z[o] = zr[q];
    if (win[q] < 0) continue;
    if constexpr (kSlot) {
      slot_out[o] = slots[(size_t)t * k + win[q]];
    } else {
      const Fragment f = fragment(tile_rows + (size_t)win[q] * kRast, px, py[q], 0);
      const float* c0 = attr + ((size_t)t * k + win[q]) * 3 * a_n;
      const float* c1 = c0 + a_n;
      const float* c2 = c1 + a_n;
      for (int a = 0; a < a_n; ++a) {
        acc[a * plane + o] = __fadd_rn(__fadd_rn(__fmul_rn(f.w0, c0[a]), __fmul_rn(f.w1, c1[a])),
                                       __fmul_rn(f.w2, c2[a]));
      }
    }
  }
}

template <bool kSlot>
int launch_capped(const int* counts, const float* rast, const void* rects, const int* slots,
                  const float* attr, float* z, int* slot_out, float* acc, int num_tiles, int k,
                  int a_n, int tiles_x, int wp, int hp, int tile_h, int tile_w, int compare,
                  int depth_write, void* stream) {
  if (num_tiles <= 0) return 0;
  if (tile_h <= 0 || tile_w <= 0) return (int)cudaErrorInvalidValue;
  const int subs_x = (tile_w + kSubW - 1) / kSubW;
  const int subs = subs_x * ((tile_h + kSubH - 1) / kSubH);
  if (subs > 65535) return (int)cudaErrorInvalidValue;
  raster_capped_kernel<kSlot><<<dim3(num_tiles, subs), kThreads, 0, (cudaStream_t)stream>>>(
      counts, rast, (const int4*)rects, slots, attr, z, slot_out, acc, k, a_n, tiles_x, wp, hp,
      tile_h, tile_w, subs_x, compare, depth_write);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`, does
// not synchronise, allocates nothing; returns cudaGetLastError() after the
// launch. z (hp, wp) and, for K7, slot (hp, wp) are updated in place; K8
// writes acc (a_n, hp, wp), which the caller zero-fills, where a record won.
// rast (T, K, 16) and rects (T, K, 4) int32 are 16-byte aligned.

// K7: slots (T, K) int32.
extern "C" int zn_visibility(const int* counts, const float* rast, const void* rects,
                             const int* slots, float* z, int* slot, int num_tiles, int k,
                             int tiles_x, int wp, int tile_h, int tile_w, int compare,
                             int depth_write, void* stream) {
  return launch_capped<true>(counts, rast, rects, slots, nullptr, z, slot, nullptr, num_tiles, k,
                             0, tiles_x, wp, 0, tile_h, tile_w, compare, depth_write, stream);
}

// K8: attr (T, K, 3 * a_n).
extern "C" int zn_raster_interp(const int* counts, const float* rast, const void* rects,
                                const float* attr, float* z, float* acc, int num_tiles, int k,
                                int a_n, int tiles_x, int wp, int hp, int tile_h, int tile_w,
                                int compare, int depth_write, void* stream) {
  return launch_capped<false>(counts, rast, rects, nullptr, attr, z, nullptr, acc, num_tiles, k,
                              a_n, tiles_x, wp, hp, tile_h, tile_w, compare, depth_write, stream);
}
