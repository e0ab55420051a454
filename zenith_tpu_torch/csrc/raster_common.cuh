// Device helpers shared by the segmented rasterizers: K1, K3 and K4
// (raster.cu) and K5 and K6 (raster_blend.cu). Everything that decides
// coverage or depth rounds each product and sum on its own
// (__fmul_rn/__fadd_rn, never an FMA), in the reference's order.

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

}  // namespace
