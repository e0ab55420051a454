// K2: tiled deferred point/spot-light accumulation, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel zenith_tpu/ops/lighting.py::_tiled_lights_kernel
// (entry accumulate_point_lights). Per (tile_h, tile_w) framebuffer tile
// (16x128 by default): the world-space AABB of the covered pixels
// (depth > 0); a sphere-vs-AABB cull of every light; for each light that
// hits, the Cook-Torrance GGX BRDF x inverse square x distance window
// clip(1 - q^4, 0, 1)^2 x spot cone, summed per pixel in light order.
//
// Layout. One CTA per tile, 256 threads, each owning up to 8 pixels of the
// tile (pixel p = threadIdx.x + k*256, row-major in the tile), so a warp
// reads 32 neighbouring pixels of one row: the G-buffer planes are read
// channel-last (H, W, 4) as float4, 512 contiguous bytes per warp load.
// Pixels beyond the image (the ragged last tiles) count as uncovered, which
// is what the reference's zero padding of depth gives, so no padded copy is
// made. The output (H, W, 3) is written once per pixel.
//
// The cull. A block-wide min/max reduction (warp shuffles, then one value
// per warp in shared memory) gives the tile's AABB and any_cov. The light
// table (L x 16 floats) is staged in shared memory in chunks of kChunk
// lights; each thread tests one light of the chunk against the AABB and
// stores the flag, so the walk over the chunk reads a flag that is the same
// for every thread: the BRDF loop does not diverge across the CTA. A light
// that the test rejects lies beyond its radius from every covered pixel of
// the tile, so its window is 0 there: a borderline flip of the test changes
// no result. Uncovered pixels of a hit tile get weight 0, as in the
// reference (w = where(covered, att * win * cone, 0)).
//
// Precision. FMA contraction and rsqrtf in the BRDF make K2 differ from its
// plain PyTorch version (ops/lighting.py::_accumulate_point_lights_torch)
// by rounding only; both are held to the reference's own tolerance against
// a dense per-light loop, atol 2e-4 / rtol 2e-3 (tests/test_lighting.py).
// The light direction and the spot cone are the exception: they round each
// operation in the plain version's order, so the cone factor is the plain
// version's bit for bit. A hard-edged cone (cos_inner >= cos_outer, so
// inv_cone = 1e4) would otherwise turn one rounding step of the cosine
// into a change of the cone factor far beyond that tolerance.
//
// What bounds it on the H100: at 1920x1080 the bytes are three (H, W, 4)
// f32 planes, the depth and the (H, W, 3) output, about 132.7 MB, or about
// 40 us at 3.35 TB/s. The operations the inputs need are about 128 fp32
// operations per lit (light, pixel) pair, a covered pixel within the
// light's radius (chip_smoke.py counts them). The kernel does that work for
// every pixel of every hit (tile, light) pair, lit or not, which is the
// most the cull leaves. The design keeps each pixel's state in registers
// across the light walk (one read of the G-buffer, one write of the
// output) and spends no work on lights a tile does not touch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixelsPerThread = 8;  // tile_h * tile_w <= 2048
constexpr int kChunk = 256;          // lights staged per pass (16 KB)
constexpr int kCols = 16;            // columns of a light row
constexpr float kBig = 3.0e38f;
constexpr float kPi = 3.14159265358979323846f;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
tiled_lights_kernel(const float4* __restrict__ am, const float4* __restrict__ nr,
                    const float4* __restrict__ pe, const float* __restrict__ depth,
                    const float* __restrict__ lights, const float* __restrict__ cam,
                    float* __restrict__ out, int num_lights, int h, int w, int tile_h,
                    int tile_w) {
  __shared__ float s_lights[kChunk * kCols];
  __shared__ int s_hit[kChunk];
  __shared__ float s_red[7][kWarps];

  const int npix = tile_h * tile_w;
  const int y_base = blockIdx.y * tile_h;
  const int x_base = blockIdx.x * tile_w;

  // -- 1. the tile's AABB over covered pixels -------------------------------
  float lo[3] = {kBig, kBig, kBig};
  float hi[3] = {-kBig, -kBig, -kBig};
  float cov_any = 0.0f;
#pragma unroll
  for (int k = 0; k < kPixelsPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const int gy = y_base + p / tile_w;
    const int gx = x_base + p % tile_w;
    if (p < npix && gy < h && gx < w) {
      const size_t o = (size_t)gy * w + gx;
      if (depth[o] > 0.0f) {
        const float4 q = pe[o];
        lo[0] = fminf(lo[0], q.x);
        lo[1] = fminf(lo[1], q.y);
        lo[2] = fminf(lo[2], q.z);
        hi[0] = fmaxf(hi[0], q.x);
        hi[1] = fmaxf(hi[1], q.y);
        hi[2] = fmaxf(hi[2], q.z);
        cov_any = 1.0f;
      }
    }
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = warp_min(lo[a]);
    hi[a] = warp_max(hi[a]);
  }
  cov_any = warp_max(cov_any);
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s_red[a][warp] = lo[a];
      s_red[3 + a][warp] = hi[a];
    }
    s_red[6][warp] = cov_any;
  }
  __syncthreads();
  float bmin[3], bmax[3];
  bool any_cov = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    bmin[a] = s_red[a][0];
    bmax[a] = s_red[3 + a][0];
  }
  any_cov = s_red[6][0] > 0.0f;
  for (int i = 1; i < kWarps; ++i) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      bmin[a] = fminf(bmin[a], s_red[a][i]);
      bmax[a] = fmaxf(bmax[a], s_red[3 + a][i]);
    }
    any_cov = any_cov || s_red[6][i] > 0.0f;
  }

  // -- 2. per pixel: the light walk, state in registers ----------------------
  const float cx = cam[0], cy = cam[1], cz = cam[2];
  float acc[kPixelsPerThread][3];
#pragma unroll
  for (int k = 0; k < kPixelsPerThread; ++k) acc[k][0] = acc[k][1] = acc[k][2] = 0.0f;

  for (int base = 0; base < num_lights; base += kChunk) {
    const int count = min(kChunk, num_lights - base);
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < count * kCols; e += kThreads) {
      s_lights[e] = lights[(size_t)base * kCols + e];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < count; i += kThreads) {
      const float* r = s_lights + i * kCols;
      const float ddx = fmaxf(fmaxf(bmin[0] - r[0], r[0] - bmax[0]), 0.0f);
      const float ddy = fmaxf(fmaxf(bmin[1] - r[1], r[1] - bmax[1]), 0.0f);
      const float ddz = fmaxf(fmaxf(bmin[2] - r[2], r[2] - bmax[2]), 0.0f);
      s_hit[i] = (ddx * ddx + ddy * ddy + ddz * ddz <= r[3] * r[3]) && any_cov;
    }
    __syncthreads();
    if (!any_cov) continue;  // uniform across the CTA

#pragma unroll 1
    for (int k = 0; k < kPixelsPerThread; ++k) {
      const int p = threadIdx.x + k * kThreads;
      const int gy = y_base + p / tile_w;
      const int gx = x_base + p % tile_w;
      if (p >= npix || gy >= h || gx >= w) continue;
      const size_t o = (size_t)gy * w + gx;
      const bool covered = depth[o] > 0.0f;
      const float4 a4 = am[o];
      const float4 n4 = nr[o];
      const float4 p4 = pe[o];
      const float nx = n4.x, ny = n4.y, nz = n4.z, rough = n4.w;
      const float ar = a4.x, ag = a4.y, ab = a4.z, metal = a4.w;
      const float wx = p4.x, wy = p4.y, wz = p4.z;
      float vx = cx - wx, vy = cy - wy, vz = cz - wz;
      const float vn = rsqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 1e-16f));
      vx *= vn;
      vy *= vn;
      vz *= vn;
      // Per-pixel BRDF terms that do not depend on the light.
      const float ndv = fmaxf(nx * vx + ny * vy + nz * vz, 1e-4f);
      const float a = fmaxf(rough * rough, 1e-3f);
      const float a2 = a * a;
      const float kk = (rough + 1.0f) * (rough + 1.0f) / 8.0f;
      const float gv = ndv / (ndv * (1.0f - kk) + kk);
      const float f0r = 0.04f * (1.0f - metal) + ar * metal;
      const float f0g = 0.04f * (1.0f - metal) + ag * metal;
      const float f0b = 0.04f * (1.0f - metal) + ab * metal;
      const float diff = (1.0f - metal) * (1.0f / kPi);
      float sr = acc[k][0], sg = acc[k][1], sb = acc[k][2];

      for (int i = 0; i < count; ++i) {
        if (!s_hit[i]) continue;  // uniform across the CTA
        const float* r = s_lights + i * kCols;
        // The light direction and the cone's cosine round each operation in
        // the plain version's order (no FMA contraction): a hard cone edge
        // multiplies the cosine's rounding by inv_cone (up to 1e4).
        const float tx = r[0] - wx, ty = r[1] - wy, tz = r[2] - wz;
        const float d2 = fmaxf(
            __fadd_rn(__fadd_rn(__fmul_rn(tx, tx), __fmul_rn(ty, ty)), __fmul_rn(tz, tz)), 1e-8f);
        const float dist = __fsqrt_rn(d2);
        const float inv = __frcp_rn(dist);
        const float lx = __fmul_rn(tx, inv), ly = __fmul_rn(ty, inv), lz = __fmul_rn(tz, inv);
        const float att = 1.0f / d2;
        const float q = dist / r[3];
        const float q2 = q * q;
        float win = fminf(fmaxf(1.0f - q2 * q2, 0.0f), 1.0f);
        win = win * win;

        float hx = lx + vx, hy = ly + vy, hz = lz + vz;
        const float hn = rsqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-16f));
        hx *= hn;
        hy *= hn;
        hz *= hn;
        const float ndl = fmaxf(nx * lx + ny * ly + nz * lz, 0.0f);
        const float ndh = fmaxf(nx * hx + ny * hy + nz * hz, 0.0f);
        const float vdh = fmaxf(vx * hx + vy * hy + vz * hz, 0.0f);
        const float denom = ndh * ndh * (a2 - 1.0f) + 1.0f;
        const float d = a2 / fmaxf(kPi * denom * denom, 1e-8f);
        const float g = gv * (ndl / fmaxf(ndl * (1.0f - kk) + kk, 1e-8f));
        const float m1 = 1.0f - vdh;
        const float m2 = m1 * m1;
        const float fres = m2 * m2 * m1;
        const float fr = f0r + (1.0f - f0r) * fres;
        const float fg = f0g + (1.0f - f0g) * fres;
        const float fb = f0b + (1.0f - f0b) * fres;
        const float spec = d * g / fmaxf(4.0f * ndv * ndl, 1e-4f);

        const float cosang =
            -__fadd_rn(__fadd_rn(__fmul_rn(lx, r[8]), __fmul_rn(ly, r[9])), __fmul_rn(lz, r[10]));
        const float t = fminf(fmaxf(__fmul_rn(__fsub_rn(cosang, r[11]), r[12]), 0.0f), 1.0f);
        const float cone = __fadd_rn(1.0f, __fmul_rn(r[7], __fsub_rn(__fmul_rn(t, t), 1.0f)));
        const float wgt = covered ? att * win * cone : 0.0f;
        sr += ((1.0f - fr) * diff * ar + spec * fr) * ndl * r[4] * wgt;
        sg += ((1.0f - fg) * diff * ag + spec * fg) * ndl * r[5] * wgt;
        sb += ((1.0f - fb) * diff * ab + spec * fb) * ndl * r[6] * wgt;
      }
      acc[k][0] = sr;
      acc[k][1] = sg;
      acc[k][2] = sb;
    }
  }

#pragma unroll
  for (int k = 0; k < kPixelsPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const int gy = y_base + p / tile_w;
    const int gx = x_base + p % tile_w;
    if (p < npix && gy < h && gx < w) {
      float* dst = out + ((size_t)gy * w + gx) * 3;
      dst[0] = acc[k][0];
      dst[1] = acc[k][1];
      dst[2] = acc[k][2];
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the launch.
extern "C" int zn_tiled_lights(const float* am, const float* nr, const float* pe,
                               const float* depth, const float* lights, const float* cam,
                               float* out, int num_lights, int h, int w, int tile_h,
                               int tile_w, void* stream) {
  if (num_lights <= 0 || h <= 0 || w <= 0) return 0;
  if (tile_h * tile_w > kThreads * kPixelsPerThread) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h);
  tiled_lights_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(am), reinterpret_cast<const float4*>(nr),
      reinterpret_cast<const float4*>(pe), depth, lights, cam, out, num_lights, h, w, tile_h,
      tile_w);
  return (int)cudaGetLastError();
}
