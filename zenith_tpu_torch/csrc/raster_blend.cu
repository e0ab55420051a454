// K5 and K6: the in-order blending rasterizer, hand-written for Hopper
// (sm_90a), compiled once per fragment shader.
//
// K5 replaces the Pallas kernel zenith_tpu/ops/raster.py::
// _segmented_blend_kernel (entry raster_segmented_blend); K6 replaces
// _segmented_blend_stencil_kernel (the same entry with stencil state). For
// every binned (tile, record) entry, in the tile's submission order, and for
// every pixel the entry covers and whose depth (and, in K6, stencil) test
// passes: interpolate the a_n attribute planes, divide by the interpolated
// 1/w, run the fragment shader, and blend its RGBA against the pixel's
// carried colour: the Vulkan output merger executed per fragment, in order.
// K6 carries K3's stencil plane as well: coverage -> stencil test -> depth
// test, stencil ops firing on their outcomes, and only fragments passing
// both tests shade and blend.
//
// The shader is device code. This file is not compiled on its own: the
// build writes a translation unit that defines
//
//   ZN_A_N                 attribute planes per corner, the trailing 1/w
//                          included (row width = 16 + 3 * ZN_A_N)
//   ZN_FRONT_COL           column of __front among them (-1 if absent)
//   ZN_DRAW_ID_COL         column of __draw_id (-1 if absent)
//   ZN_V_<name>, ZN_U_<name>   first column of each varying and uniform
//
// then the shader's source, which must define
//
//   __device__ __forceinline__ void zn_fragment(
//       const float* a,      // finalized attributes, attr_layout order
//       float frag_x, float frag_y, float depth, bool front_facing,
//       float draw_id, float* rgba);
//
// and then includes this file. It is compiled with -fmad=false, so shader
// and blend arithmetic round product by product like the plain PyTorch
// version (the tolerance between the two is stated in ops/raster.py).
//
// Order, exactness and the walk are K1's (raster.cu, with the helpers in
// raster_common.cuh): the grid is (entry blocks) x (16x16-pixel sub-regions
// of a tile); the CTA of a block that starts a tile (blk_init == 1) walks
// all of the tile's blocks in submission order, so each pixel is owned by
// one thread, which sees its entries in order: in-order blending, depth-EQUAL
// ties and the stencil stay exact. Coverage, depth and interpolation use the
// same rounded operations in the same order as the plain version.
//
// The cull. Each warp owns an 8x8 pixel block (2 pixels a lane), ballots
// every staged block's per-row pixel rectangles (SegmentedBins.rect) against
// it and evaluates only the entries that reach it, skipping a lane-row the
// rectangle misses; only fragments that pass their tests are shaded and
// blended. It is exact: an entry that does not cover a pixel changes
// nothing there (not z, not the colour, not the stencil, which only covered
// fragments update). The plain version does not cull, so the agreement of
// the two on the card checks the rectangles too.
//
// Staging. Unlike K1 every passing fragment is shaded at once, so the walk
// needs the whole row: per block, its 16 raster columns (16-byte aligned
// rows of 16, read as float4), its 3 * a_n attribute columns and its
// rectangles go to dynamic shared memory with cp.async (4-byte copies for
// the rows, whose stride 16 + 3 a_n need not keep 16-byte alignment; 16-byte
// copies for the rectangles), two buffers deep: 2 x 128 x (16 + 64 + 12 a_n)
// bytes, 59 KB for the glass panes' a_n = 13.
//
// State. Per pixel a lane carries z, four colours and (K6) the stencil in
// registers, read once before the walk and written once after it; 2 pixels
// a lane, so the shader is inlined twice (it was inlined 8 times when one
// CTA of 512 threads owned a whole 32x128 tile).
//
// What bounds it on the H100: ALU work, as K1, plus the shader and blend per
// passing fragment; memory traffic is the rows once and the z, colour (and
// stencil) planes read and written once. Before this design one CTA walked
// a whole tile and evaluated every entry at all of its 4,096 pixels with no
// cull, one CTA an SM at 99-109 registers: 0.70-1.68 ms on the glass panes'
// ~1 entry a tile, 5.8-7.5 ms on the translucent stress draw. Now a tile
// spreads over 16 CTAs and a warp touches only the entries that reach its
// pixels.

#ifndef ZN_A_N
#error "raster_blend.cu is compiled per shader: see ops/runtime.py::load_blend_kernel"
#endif

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

constexpr int kRow = kRast + 3 * ZN_A_N;
constexpr int kAttr = 3 * ZN_A_N;  // the three corners' attribute columns

// The blend equation of one colour attachment (rhi.state.ColorAttachmentDesc).
// Factor codes: 0 ZERO, 1 ONE, 2 SRC_COLOR, 3 ONE_MINUS_SRC_COLOR, 4
// DST_COLOR, 5 ONE_MINUS_DST_COLOR, 6 SRC_ALPHA, 7 ONE_MINUS_SRC_ALPHA, 8
// DST_ALPHA, 9 ONE_MINUS_DST_ALPHA. Op codes: 0 ADD, 1 SUBTRACT, 2
// REVERSE_SUBTRACT, 3 MIN, 4 MAX. write_mask: bit k set = channel k written.
struct BlendState {
  int enable, src_color, dst_color, color_op, src_alpha, dst_alpha, alpha_op, write_mask;
};

__device__ __forceinline__ float blend_factor(int f, const float* src, const float* dst, int k) {
  switch (f) {
    case 0: return 0.0f;
    case 1: return 1.0f;
    case 2: return src[k];
    case 3: return 1.0f - src[k];
    case 4: return dst[k];
    case 5: return 1.0f - dst[k];
    case 6: return src[3];
    case 7: return 1.0f - src[3];
    case 8: return dst[3];
    default: return 1.0f - dst[3];
  }
}

__device__ __forceinline__ float blend_op(int op, float a, float b) {
  switch (op) {
    case 0: return a + b;
    case 1: return a - b;
    case 2: return b - a;
    case 3: return fminf(a, b);
    default: return fmaxf(a, b);
  }
}

// ops/blend.py::blend_colors for one pixel: dst <- blend(dst, src).
__device__ __forceinline__ void blend_pixel(const BlendState& bs, const float* src, float* dst) {
  float out[4];
  if (bs.enable) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      out[k] = blend_op(bs.color_op, src[k] * blend_factor(bs.src_color, src, dst, k),
                        dst[k] * blend_factor(bs.dst_color, src, dst, k));
    }
    out[3] = blend_op(bs.alpha_op, src[3] * blend_factor(bs.src_alpha, src, dst, 3),
                      dst[3] * blend_factor(bs.dst_alpha, src, dst, 3));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = src[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (bs.write_mask & (1 << k)) dst[k] = out[k];
  }
}

// Dynamic shared memory per CTA: two staging buffers of `chunk` entries,
// each a rectangle, 16 raster columns and kAttr attribute columns.
__host__ __device__ constexpr size_t blend_smem_per_entry() {
  return sizeof(int4) + sizeof(float) * (kRast + kAttr);
}

template <bool STENCIL>
__global__ void __launch_bounds__(kThreads)
raster_blend_kernel(const int* __restrict__ blk_tile_y, const int* __restrict__ blk_tile_x,
                    const int* __restrict__ blk_count, const int* __restrict__ blk_init,
                    const float* __restrict__ rows, const int4* __restrict__ rects,
                    float* __restrict__ z, float4* __restrict__ color,
                    int* __restrict__ stencil, int num_blocks, int chunk, int wp, int tile_h,
                    int tile_w, int subs_x, int compare, int depth_write, int depth_clamp,
                    float off_x, float off_y, BlendState bs, StencilState sstate) {
  // [2][chunk] rectangles, then [2][chunk x kRast] raster columns, then
  // [2][chunk x kAttr] attribute columns.
  extern __shared__ __align__(16) int4 s_dyn[];
  int4* const s_rect = s_dyn;
  float* const s_rast = reinterpret_cast<float*>(s_dyn + 2 * chunk);
  float* const s_attr = s_rast + 2 * chunk * kRast;

  const int b0 = blockIdx.x;
  if (blk_init[b0] != 1) return;
  const int count0 = blk_count[b0];
  if (count0 <= 0) return;  // an empty draw changes nothing

  const WarpPixels pix = warp_pixels(blk_tile_y[b0], blk_tile_x[b0], tile_h, tile_w, subs_x);
  const float px = __fadd_rn((float)pix.gx, off_x);
  float zr[kPix];
  float py[kPix];
  float col[kPix][4];
  int sten[STENCIL ? kPix : 1];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int gy = pixel_row(pix, k);
    zr[k] = 0.0f;
    py[k] = __fadd_rn((float)gy, off_y);
    col[k][0] = col[k][1] = col[k][2] = col[k][3] = 0.0f;
    if constexpr (STENCIL) sten[k] = 0;
    if ((pix.live >> k) & 1u) {
      const size_t o = (size_t)gy * wp + pix.gx;
      zr[k] = z[o];
      const float4 c = color[o];
      col[k][0] = c.x;
      col[k][1] = c.y;
      col[k][2] = c.z;
      col[k][3] = c.w;
      if constexpr (STENCIL) sten[k] = stencil[o];
    }
  }

  auto stage = [&](int buf, int b, int count) {
    stage_rects(s_rect + buf * chunk, rects, b, count, chunk);
    stage_columns(s_rast + buf * chunk * kRast, rows, b, count, chunk, kRow, 0, kRast);
    stage_columns(s_attr + buf * chunk * kAttr, rows, b, count, chunk, kRow, kRast, kAttr);
  };
  auto visit = [&](int buf, int, int count) {
    if (!pix.warp_live) return;
    const int4* sq = s_rect + buf * chunk;
    for_each_overlap(pix, sq, count, [&](int e) {
      const int4 q = sq[e];
      float r[kRast];
      load_rast(s_rast + buf * chunk * kRast, e, r);
      const float* c0 = s_attr + (buf * chunk + e) * kAttr;
      const float* c1 = c0 + ZN_A_N;
      const float* c2 = c1 + ZN_A_N;
      StencilFace face = sstate.front;
      if constexpr (STENCIL) {
        if (sstate.faces_differ && !(c0[ZN_A_N - 2] > 0.0f)) face = sstate.back;
      }
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        // Skip lane-row k, warp-uniformly, where the rectangle misses it.
        if (!rows_reach(pix, q, k)) continue;
        if (!((pix.live >> k) & 1u)) continue;
        const Fragment f = fragment(r, px, py[k], depth_clamp);
        bool passed;
        if constexpr (STENCIL) {
          // An uncovered pixel fails both tests and keeps its stencil.
          passed = f.cov && stencil_depth_test(face, depth_compare(compare, f.z, zr[k]), sten[k]);
        } else {
          passed = f.cov && depth_compare(compare, f.z, zr[k]);
        }
        if (!passed) continue;
        if (depth_write) zr[k] = f.z;
        const float iw = __fadd_rn(
            __fadd_rn(__fmul_rn(f.w0, c0[ZN_A_N - 1]), __fmul_rn(f.w1, c1[ZN_A_N - 1])),
            __fmul_rn(f.w2, c2[ZN_A_N - 1]));
        const float inv = iw > 0.0f ? __fdiv_rn(1.0f, iw) : 0.0f;
        float a[ZN_A_N];
#pragma unroll
        for (int j = 0; j < ZN_A_N - 1; ++j) {
          a[j] = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(f.w0, c0[j]), __fmul_rn(f.w1, c1[j])),
                                     __fmul_rn(f.w2, c2[j])),
                           inv);
        }
        a[ZN_A_N - 1] = iw;
        const bool front = ZN_FRONT_COL >= 0 ? a[ZN_FRONT_COL >= 0 ? ZN_FRONT_COL : 0] > 0.5f
                                             : true;
        const float draw_id = ZN_DRAW_ID_COL >= 0 ? a[ZN_DRAW_ID_COL >= 0 ? ZN_DRAW_ID_COL : 0]
                                                  : 0.0f;
        float rgba[4];
        zn_fragment(a, px, py[k], f.z, front, draw_id, rgba);
        blend_pixel(bs, rgba, col[k]);
      }
    });
  };
  walk_tile_blocks(blk_count, blk_init, num_blocks, b0, count0, stage, visit);

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (!((pix.live >> k) & 1u)) continue;
    const size_t o = (size_t)pixel_row(pix, k) * wp + pix.gx;
    z[o] = zr[k];
    color[o] = make_float4(col[k][0], col[k][1], col[k][2], col[k][3]);
    if constexpr (STENCIL) stencil[o] = sten[k];
  }
}

template <bool STENCIL>
int launch_blend(const int* blk_tile_y, const int* blk_tile_x, const int* blk_count,
                 const int* blk_init, const float* rows, const void* rects, float* z,
                 float* color, int* stencil, int num_blocks, int chunk, int row_stride, int wp,
                 int tile_h, int tile_w, int compare, int depth_write, int depth_clamp,
                 float off_x, float off_y, const int* blend, const int* faces, void* stream) {
  if (num_blocks <= 0) return 0;
  if (row_stride != kRow || chunk <= 0 || chunk > kMaxChunk || tile_h <= 0 || tile_w <= 0)
    return (int)cudaErrorInvalidValue;
  const int subs_x = (tile_w + kSubW - 1) / kSubW;
  const int subs = subs_x * ((tile_h + kSubH - 1) / kSubH);
  if (subs > 65535) return (int)cudaErrorInvalidValue;
  BlendState bs = {blend[0], blend[1], blend[2], blend[3], blend[4], blend[5], blend[6], blend[7]};
  StencilState st = {};
  if (STENCIL) {
    st.front = {faces[0], faces[1], faces[2], faces[3], faces[4], faces[5], faces[6]};
    st.back = {faces[7], faces[8], faces[9], faces[10], faces[11], faces[12], faces[13]};
    for (int k = 0; k < 7; ++k) st.faces_differ |= (faces[k] != faces[7 + k]);
  }
  // Above 48 KB the kernel must be allowed its dynamic shared memory, once
  // per device (kMaxChunk entries, the most any call stages).
  constexpr int kMaxSmem = (int)(2 * kMaxChunk * blend_smem_per_entry());
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (kMaxSmem > 48 * 1024 && dev < 64 && !allowed[dev]) {
    err = cudaFuncSetAttribute(raster_blend_kernel<STENCIL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }
  const size_t smem = 2 * (size_t)chunk * blend_smem_per_entry();
  raster_blend_kernel<STENCIL><<<dim3(num_blocks, subs), kThreads, smem, (cudaStream_t)stream>>>(
      blk_tile_y, blk_tile_x, blk_count, blk_init, rows, (const int4*)rects, z,
      reinterpret_cast<float4*>(color), stencil, num_blocks, chunk, wp, tile_h, tile_w, subs_x,
      compare, depth_write, depth_clamp, off_x, off_y, bs, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). `color` is (hp, wp, 4) float32,
// 16-byte aligned, updated in place like `z` (and `stencil`). `rects` is the
// bins' (rows, 4) int32 rectangle table, 16-byte aligned. `blend` holds the
// 8 ints of BlendState, `faces` the 14 ints of the two stencil faces (see
// raster.cu::zn_raster_segmented_stencil). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError().
extern "C" int zn_raster_blend(const int* blk_tile_y, const int* blk_tile_x,
                               const int* blk_count, const int* blk_init, const float* rows,
                               const void* rects, float* z, float* color, int num_blocks,
                               int chunk, int row_stride, int wp, int tile_h, int tile_w,
                               int compare, int depth_write, int depth_clamp, float off_x,
                               float off_y, const int* blend, void* stream) {
  return launch_blend<false>(blk_tile_y, blk_tile_x, blk_count, blk_init, rows, rects, z, color,
                             nullptr, num_blocks, chunk, row_stride, wp, tile_h, tile_w, compare,
                             depth_write, depth_clamp, off_x, off_y, blend, nullptr, stream);
}

extern "C" int zn_raster_blend_stencil(const int* blk_tile_y, const int* blk_tile_x,
                                       const int* blk_count, const int* blk_init,
                                       const float* rows, const void* rects, float* z,
                                       float* color, int* stencil, int num_blocks, int chunk,
                                       int row_stride, int wp, int tile_h, int tile_w,
                                       int compare, int depth_write, int depth_clamp,
                                       float off_x, float off_y, const int* blend,
                                       const int* faces, void* stream) {
  return launch_blend<true>(blk_tile_y, blk_tile_x, blk_count, blk_init, rows, rects, z, color,
                            stencil, num_blocks, chunk, row_stride, wp, tile_h, tile_w, compare,
                            depth_write, depth_clamp, off_x, off_y, blend, faces, stream);
}
