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
// Order and exactness are K1's (raster.cu): one CTA owns a tile and walks
// its blocks while blk_init == 0; coverage and depth use the same rounded
// operations in the same order.
//
// State. Unlike K1 the planes cannot be deferred to the end of the walk:
// every passing fragment is shaded and blended at once. Per pixel a thread
// carries z, four colours and (K6) the stencil, so a tile's 4096 pixels are
// spread over 512 threads x 8 pixels (56-64 live carry registers before the
// shader's own), and the walk stages the whole row (16 + 3 * a_n columns) in
// shared memory, not only its first 16. Only passing fragments are shaded
// (the reference shades every fragment and selects; the result is the same).
//
// What bounds it on the H100: ALU work, as K1, plus the shader and blend per
// passing fragment; memory traffic is the rows once and the z, colour (and
// stencil) planes read and written once.

#ifndef ZN_A_N
#error "raster_blend.cu is compiled per shader: see ops/runtime.py::load_blend_kernel"
#endif

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

constexpr int kBlendThreads = 512;
constexpr int kBlendPixels = 8;  // tile_h * tile_w <= 4096
constexpr int kRow = kRast + 3 * ZN_A_N;

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

template <bool STENCIL>
__global__ void __launch_bounds__(kBlendThreads)
raster_blend_kernel(const int* __restrict__ blk_tile_y, const int* __restrict__ blk_tile_x,
                    const int* __restrict__ blk_count, const int* __restrict__ blk_init,
                    const float* __restrict__ rows, float* __restrict__ z,
                    float4* __restrict__ color, int* __restrict__ stencil, int num_blocks,
                    int chunk, int wp, int tile_h, int tile_w, int compare, int depth_write,
                    int depth_clamp, float off_x, float off_y, BlendState bs,
                    StencilState sstate) {
  extern __shared__ float s_rows[];  // chunk x kRow
  const int b0 = blockIdx.x;
  if (blk_init[b0] != 1) return;

  const int npix = tile_h * tile_w;
  const int y_base = blk_tile_y[b0] * tile_h;
  const int x_base = blk_tile_x[b0] * tile_w;

  float zr[kBlendPixels];
  float px[kBlendPixels];
  float py[kBlendPixels];
  float col[kBlendPixels][4];
  int sten[STENCIL ? kBlendPixels : 1];
#pragma unroll
  for (int k = 0; k < kBlendPixels; ++k) {
    const int p = threadIdx.x + k * kBlendThreads;
    zr[k] = 0.0f;
    px[k] = 0.0f;
    py[k] = 0.0f;
    col[k][0] = col[k][1] = col[k][2] = col[k][3] = 0.0f;
    if constexpr (STENCIL) sten[k] = 0;
    if (p < npix) {
      const int gy = y_base + p / tile_w;
      const int gx = x_base + p % tile_w;
      const size_t o = (size_t)gy * wp + gx;
      zr[k] = z[o];
      const float4 c = color[o];
      col[k][0] = c.x;
      col[k][1] = c.y;
      col[k][2] = c.z;
      col[k][3] = c.w;
      if constexpr (STENCIL) sten[k] = stencil[o];
      px[k] = __fadd_rn((float)gx, off_x);
      py[k] = __fadd_rn((float)gy, off_y);
    }
  }

  for (int b = b0; b < num_blocks && (b == b0 || blk_init[b] == 0); ++b) {
    const int count = blk_count[b];
    if (count <= 0) continue;  // uniform across the CTA
    __syncthreads();           // the previous block's rows are consumed
    const float* src = rows + (size_t)b * chunk * kRow;
    for (int e = threadIdx.x; e < count * kRow; e += kBlendThreads) s_rows[e] = src[e];
    __syncthreads();
    for (int i = 0; i < count; ++i) {
      const float* r = s_rows + i * kRow;
      StencilFace face = sstate.front;
      if constexpr (STENCIL) {
        if (sstate.faces_differ && !(r[kRast + ZN_A_N - 2] > 0.0f)) face = sstate.back;
      }
#pragma unroll
      for (int k = 0; k < kBlendPixels; ++k) {
        if (threadIdx.x + k * kBlendThreads < npix) {
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
          bool passed;
          if constexpr (STENCIL) {
            // An uncovered pixel fails both tests and keeps its stencil.
            passed = cov && stencil_depth_test(face, depth_compare(compare, zpx, zr[k]), sten[k]);
          } else {
            passed = cov && depth_compare(compare, zpx, zr[k]);
          }
          if (passed) {
            if (depth_write) zr[k] = zpx;
            const float* c0 = r + kRast;
            const float* c1 = c0 + ZN_A_N;
            const float* c2 = c1 + ZN_A_N;
            const float iw = __fadd_rn(
                __fadd_rn(__fmul_rn(w0, c0[ZN_A_N - 1]), __fmul_rn(w1, c1[ZN_A_N - 1])),
                __fmul_rn(w2, c2[ZN_A_N - 1]));
            const float inv = iw > 0.0f ? __fdiv_rn(1.0f, iw) : 0.0f;
            float a[ZN_A_N];
#pragma unroll
            for (int j = 0; j < ZN_A_N - 1; ++j) {
              a[j] = __fmul_rn(
                  __fadd_rn(__fadd_rn(__fmul_rn(w0, c0[j]), __fmul_rn(w1, c1[j])),
                            __fmul_rn(w2, c2[j])),
                  inv);
            }
            a[ZN_A_N - 1] = iw;
            const bool front = ZN_FRONT_COL >= 0 ? a[ZN_FRONT_COL >= 0 ? ZN_FRONT_COL : 0] > 0.5f
                                                 : true;
            const float draw_id = ZN_DRAW_ID_COL >= 0 ? a[ZN_DRAW_ID_COL >= 0 ? ZN_DRAW_ID_COL : 0]
                                                      : 0.0f;
            float rgba[4];
            zn_fragment(a, px[k], py[k], zpx, front, draw_id, rgba);
            blend_pixel(bs, rgba, col[k]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kBlendPixels; ++k) {
    const int p = threadIdx.x + k * kBlendThreads;
    if (p < npix) {
      const int gy = y_base + p / tile_w;
      const int gx = x_base + p % tile_w;
      const size_t o = (size_t)gy * wp + gx;
      z[o] = zr[k];
      color[o] = make_float4(col[k][0], col[k][1], col[k][2], col[k][3]);
      if constexpr (STENCIL) stencil[o] = sten[k];
    }
  }
}

template <bool STENCIL>
int launch_blend(const int* blk_tile_y, const int* blk_tile_x, const int* blk_count,
                 const int* blk_init, const float* rows, float* z, float* color, int* stencil,
                 int num_blocks, int chunk, int row_stride, int wp, int tile_h, int tile_w,
                 int compare, int depth_write, int depth_clamp, float off_x, float off_y,
                 const int* blend, const int* faces, void* stream) {
  if (num_blocks <= 0) return 0;
  if (row_stride != kRow) return (int)cudaErrorInvalidValue;
  if (tile_h * tile_w > kBlendThreads * kBlendPixels) return (int)cudaErrorInvalidValue;
  BlendState bs = {blend[0], blend[1], blend[2], blend[3], blend[4], blend[5], blend[6], blend[7]};
  StencilState st = {};
  if (STENCIL) {
    st.front = {faces[0], faces[1], faces[2], faces[3], faces[4], faces[5], faces[6]};
    st.back = {faces[7], faces[8], faces[9], faces[10], faces[11], faces[12], faces[13]};
    for (int k = 0; k < 7; ++k) st.faces_differ |= (faces[k] != faces[7 + k]);
  }
  const size_t smem = (size_t)chunk * kRow * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        raster_blend_kernel<STENCIL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  raster_blend_kernel<STENCIL><<<num_blocks, kBlendThreads, smem, (cudaStream_t)stream>>>(
      blk_tile_y, blk_tile_x, blk_count, blk_init, rows, z, reinterpret_cast<float4*>(color),
      stencil, num_blocks, chunk, wp, tile_h, tile_w, compare, depth_write, depth_clamp, off_x,
      off_y, bs, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). `color` is (hp, wp, 4) float32,
// 16-byte aligned, updated in place like `z` (and `stencil`). `blend` holds
// the 8 ints of BlendState, `faces` the 14 ints of the two stencil faces
// (see raster.cu::zn_raster_segmented_stencil). Launches on `stream`, does
// not synchronise, allocates nothing; returns cudaGetLastError().
extern "C" int zn_raster_blend(const int* blk_tile_y, const int* blk_tile_x,
                               const int* blk_count, const int* blk_init, const float* rows,
                               float* z, float* color, int num_blocks, int chunk, int row_stride,
                               int wp, int tile_h, int tile_w, int compare, int depth_write,
                               int depth_clamp, float off_x, float off_y, const int* blend,
                               void* stream) {
  return launch_blend<false>(blk_tile_y, blk_tile_x, blk_count, blk_init, rows, z, color, nullptr,
                             num_blocks, chunk, row_stride, wp, tile_h, tile_w, compare,
                             depth_write, depth_clamp, off_x, off_y, blend, nullptr, stream);
}

extern "C" int zn_raster_blend_stencil(const int* blk_tile_y, const int* blk_tile_x,
                                       const int* blk_count, const int* blk_init,
                                       const float* rows, float* z, float* color, int* stencil,
                                       int num_blocks, int chunk, int row_stride, int wp,
                                       int tile_h, int tile_w, int compare, int depth_write,
                                       int depth_clamp, float off_x, float off_y,
                                       const int* blend, const int* faces, void* stream) {
  return launch_blend<true>(blk_tile_y, blk_tile_x, blk_count, blk_init, rows, z, color, stencil,
                            num_blocks, chunk, row_stride, wp, tile_h, tile_w, compare,
                            depth_write, depth_clamp, off_x, off_y, blend, faces, stream);
}
