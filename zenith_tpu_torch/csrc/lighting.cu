// K2: tiled deferred point/spot-light accumulation, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel zenith_tpu/ops/lighting.py::_tiled_lights_kernel
// (entry accumulate_point_lights). Per framebuffer region: the world-space
// AABB of the covered pixels (depth > 0); a sphere-vs-AABB cull of every
// light; for each light that hits, the Cook-Torrance GGX BRDF x inverse
// square x distance window clip(1 - q^4, 0, 1)^2 x spot cone, summed per
// pixel in light order.
//
// Layout. One CTA per kSubH x kSubW region (16x16: 8,160 CTAs at 1080p),
// 256 threads, one pixel each, so the densest region's lights are walked by
// 256 threads at once and an SM holds many such CTAs to hide the walk's
// latency. A warp reads two rows of 16 neighbouring pixels: the G-buffer
// planes are read channel-last (H, W, 4) as float4, once per pixel. Pixels
// beyond the image (the ragged last regions) count as uncovered, which is
// what the reference's zero padding of depth gives, so no padded copy is
// made. The output (H, W, 3) is written once per pixel.
//
// The cull, then a compact list. A block-wide min/max reduction (warp
// shuffles, then one value per warp in shared memory) gives the region's
// AABB and whether any pixel is covered; a region with none writes zeros and
// ends. The lights are tested kChunk at a time, one per thread; the hits are
// compacted in light order (a ballot per warp, a prefix over the warps) into
// a list in shared memory, their rows staged beside it with what the walk
// can take once per light (1 / radius). Every pixel then walks the list.
//
// Why the kernel may cull more finely than the reference's (tile_h, tile_w)
// tiles: a light that misses a region's box lies beyond its radius from
// every covered pixel of the region, so its window clip(1 - q^4, 0, 1)^2 is
// 0 there, apart from rounding at the exact border, where it is ~1e-13. So a
// conservative cull over any region gives the dense per-light sum, and the
// kernel's regions need not be the tiles. The plain version keeps the
// reference's tile cull (ops/lighting.py); the two differ by rounding only.
// Inside the walk a pixel also skips a light whose weight att * win * cone
// is 0 (beyond the radius, outside a spot's cone, or uncovered): the plain
// version adds 0 there, which changes no sum.
//
// Precision. FMA contraction and fast reciprocals and divides (__fdividef)
// in the BRDF make K2 differ from its plain PyTorch version
// (ops/lighting.py::_accumulate_point_lights_torch) by rounding only; both
// are held to the reference's own tolerance against a dense per-light loop,
// atol 2e-4 / rtol 2e-3 (tests/test_lighting.py). Two chains are the
// exception and round each operation in the plain version's order, with
// rsqrtf as PyTorch's CUDA rsqrt: the light direction and spot cone, so the
// cone factor is the plain version's bit for bit (a hard-edged cone,
// cos_inner >= cos_outer, has inv_cone = 1e4 and would turn one rounding
// step of the cosine into a change of the cone factor far beyond that
// tolerance); and the view and half vectors with their dot products, so
// n.h, n.v and n.l are the plain version's bits (near a smooth surface's
// specular peak, roughness 0.05, the GGX term changes by percents with one
// rounding step of n.h).
//
// What bounds it on the H100: at 1920x1080 the bytes are three (H, W, 4)
// f32 planes, the depth and the (H, W, 3) output, about 132.7 MB, or about
// 40 us at 3.35 TB/s. The operations the inputs need are about 128 fp32
// operations per lit (light, pixel) pair, a covered pixel within the
// light's radius (chip_smoke.py counts them), about 60 us for the 31 M lit
// pairs of the 1080p scene. Before this design one CTA of 256 threads
// walked a 16x128 tile, 8 pixels a thread one after another, and evaluated
// every hit light at all of its pixels: the densest tiles' CTAs, 8 warps of
// long dependent chains each, set the time (0.59-0.61 ms a frame). Now the
// work spreads over 8x more CTAs, each pixel's state stays in registers
// across the walk (one read of the G-buffer, one write of the output), and
// no work is spent on a light a region does not touch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSubH = 16;  // the cull region (ops/lighting.py KERNEL_CULL)
constexpr int kSubW = 16;
constexpr int kThreads = kSubH * kSubW;  // one pixel a thread
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;  // lights tested per pass, one a thread
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

// (ax, ay, az) . (bx, by, bz) with each product and sum rounded, in the
// plain version's order.
__device__ __forceinline__ float dot_rn(float ax, float ay, float az, float bx, float by,
                                       float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// A light row as staged for the walk: the table's 16 columns (px py pz
// radius cr cg cb spot dx dy dz cos_outer inv_cone pad pad pad) with the
// radius replaced by its reciprocal.
struct __align__(16) StagedLight {
  float4 pos_inv_r, color_spot, dir_cos, cone;
};

__global__ void __launch_bounds__(kThreads)
tiled_lights_kernel(const float4* __restrict__ am, const float4* __restrict__ nr,
                    const float4* __restrict__ pe, const float* __restrict__ depth,
                    const float4* __restrict__ lights, const float* __restrict__ cam,
                    float* __restrict__ out, int num_lights, int h, int w) {
  __shared__ StagedLight s_lights[kChunk];
  __shared__ float s_red[7][kWarps];
  __shared__ int s_count[kWarps];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gx = blockIdx.x * kSubW + threadIdx.x % kSubW;
  const int gy = blockIdx.y * kSubH + threadIdx.x / kSubW;
  const bool inside = gx < w && gy < h;
  const size_t o = inside ? (size_t)gy * w + gx : 0;
  const bool covered = inside && depth[o] > 0.0f;

  // -- 1. the region's AABB over covered pixels -----------------------------
  float4 p4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float lo[3] = {kBig, kBig, kBig};
  float hi[3] = {-kBig, -kBig, -kBig};
  if (covered) {
    p4 = pe[o];
    lo[0] = hi[0] = p4.x;
    lo[1] = hi[1] = p4.y;
    lo[2] = hi[2] = p4.z;
  }
  float cov_any = covered ? 1.0f : 0.0f;
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
    bmin[a] = kBig;
    bmax[a] = -kBig;
  }
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      bmin[a] = fminf(bmin[a], s_red[a][i]);
      bmax[a] = fmaxf(bmax[a], s_red[3 + a][i]);
    }
    any_cov = any_cov || s_red[6][i] > 0.0f;
  }
  float* dst = out + o * 3;
  if (!any_cov) {  // uniform across the CTA
    if (inside) dst[0] = dst[1] = dst[2] = 0.0f;
    return;
  }

  // -- 2. per pixel: the terms that do not depend on the light ---------------
  float sr = 0.0f, sg = 0.0f, sb = 0.0f;
  const float wx = p4.x, wy = p4.y, wz = p4.z;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, ar = 0.0f, ag = 0.0f, ab = 0.0f;
  float vx = 0.0f, vy = 0.0f, vz = 0.0f, ndv = 0.0f, a2 = 0.0f, kk = 0.0f, one_kk = 0.0f;
  float gv = 0.0f, f0r = 0.0f, f0g = 0.0f, f0b = 0.0f, diff = 0.0f;
  if (covered) {
    const float4 a4 = am[o];
    const float4 n4 = nr[o];
    nx = n4.x;
    ny = n4.y;
    nz = n4.z;
    const float rough = n4.w;
    ar = a4.x;
    ag = a4.y;
    ab = a4.z;
    const float metal = a4.w;
    vx = cam[0] - wx;
    vy = cam[1] - wy;
    vz = cam[2] - wz;
    const float vn = rsqrtf(fmaxf(dot_rn(vx, vy, vz, vx, vy, vz), 1e-16f));
    vx *= vn;
    vy *= vn;
    vz *= vn;
    ndv = fmaxf(dot_rn(nx, ny, nz, vx, vy, vz), 1e-4f);
    const float a = fmaxf(rough * rough, 1e-3f);
    a2 = a * a;
    kk = (rough + 1.0f) * (rough + 1.0f) * 0.125f;
    one_kk = 1.0f - kk;
    gv = __fdividef(ndv, ndv * one_kk + kk);
    f0r = 0.04f * (1.0f - metal) + ar * metal;
    f0g = 0.04f * (1.0f - metal) + ag * metal;
    f0b = 0.04f * (1.0f - metal) + ab * metal;
    diff = (1.0f - metal) * (1.0f / kPi);
  }

  for (int base = 0; base < num_lights; base += kChunk) {
    // -- 3. cull kChunk lights against the box, compact the hits in order ---
    const int l = base + threadIdx.x;
    bool hit = false;
    if (l < num_lights) {
      const float4 r = lights[(size_t)l * 4];  // px py pz radius
      const float ddx = fmaxf(fmaxf(bmin[0] - r.x, r.x - bmax[0]), 0.0f);
      const float ddy = fmaxf(fmaxf(bmin[1] - r.y, r.y - bmax[1]), 0.0f);
      const float ddz = fmaxf(fmaxf(bmin[2] - r.z, r.z - bmax[2]), 0.0f);
      hit = ddx * ddx + ddy * ddy + ddz * ddz <= r.w * r.w;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    __syncthreads();  // the previous chunk's list is consumed
    if (lane == 0) s_count[warp] = __popc(m);
    __syncthreads();
    int slot = __popc(m & ((1u << lane) - 1u));
    int n_hit = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int c = s_count[i];
      slot += i < warp ? c : 0;
      n_hit += c;
    }
    if (hit) {
      const float4* r = lights + (size_t)l * 4;
      StagedLight s;
      s.pos_inv_r = r[0];
      s.pos_inv_r.w = 1.0f / s.pos_inv_r.w;
      s.color_spot = r[1];
      s.dir_cos = r[2];
      s.cone = r[3];
      s_lights[slot] = s;
    }
    __syncthreads();
    if (!covered) continue;

    // -- 4. the walk: every hit light at this pixel, in light order -----------
    for (int i = 0; i < n_hit; ++i) {
      const float4 lp = s_lights[i].pos_inv_r;
      // The light direction and the cone's cosine round each operation in
      // the plain version's order (no FMA contraction): a hard cone edge
      // multiplies the cosine's rounding by inv_cone (up to 1e4).
      const float tx = __fsub_rn(lp.x, wx), ty = __fsub_rn(lp.y, wy), tz = __fsub_rn(lp.z, wz);
      const float d2 = fmaxf(dot_rn(tx, ty, tz, tx, ty, tz), 1e-8f);
      const float dist = __fsqrt_rn(d2);
      const float q = dist * lp.w;
      const float q2 = q * q;
      float win = fminf(fmaxf(1.0f - q2 * q2, 0.0f), 1.0f);
      if (!(win > 0.0f)) continue;  // beyond the radius: adds 0
      win = win * win;
      const float inv = __frcp_rn(dist);
      const float lx = __fmul_rn(tx, inv), ly = __fmul_rn(ty, inv), lz = __fmul_rn(tz, inv);
      const float4 dc = s_lights[i].dir_cos;
      const float4 cs = s_lights[i].color_spot;
      const float cone_k = s_lights[i].cone.x;
      const float cosang = -dot_rn(lx, ly, lz, dc.x, dc.y, dc.z);
      const float t = fminf(fmaxf(__fmul_rn(__fsub_rn(cosang, dc.w), cone_k), 0.0f), 1.0f);
      const float cone = __fadd_rn(1.0f, __fmul_rn(cs.w, __fsub_rn(__fmul_rn(t, t), 1.0f)));
      const float wgt = inv * inv * win * cone;  // att = 1 / d2
      if (wgt == 0.0f) continue;  // outside a spot's cone: adds 0

      float hx = lx + vx, hy = ly + vy, hz = lz + vz;
      const float hn = rsqrtf(fmaxf(dot_rn(hx, hy, hz, hx, hy, hz), 1e-16f));
      hx *= hn;
      hy *= hn;
      hz *= hn;
      const float ndl = fmaxf(dot_rn(nx, ny, nz, lx, ly, lz), 0.0f);
      const float ndh = fmaxf(dot_rn(nx, ny, nz, hx, hy, hz), 0.0f);
      const float vdh = fmaxf(dot_rn(vx, vy, vz, hx, hy, hz), 0.0f);
      const float denom = __fadd_rn(__fmul_rn(__fmul_rn(ndh, ndh), a2 - 1.0f), 1.0f);
      const float d = __fdividef(a2, fmaxf(kPi * denom * denom, 1e-8f));
      const float g = gv * __fdividef(ndl, fmaxf(ndl * one_kk + kk, 1e-8f));
      const float m1 = 1.0f - vdh;
      const float m2 = m1 * m1;
      const float fres = m2 * m2 * m1;
      const float fr = f0r + (1.0f - f0r) * fres;
      const float fg = f0g + (1.0f - f0g) * fres;
      const float fb = f0b + (1.0f - f0b) * fres;
      const float spec = __fdividef(d * g, fmaxf(4.0f * ndv * ndl, 1e-4f));
      const float k = ndl * wgt;
      sr += ((1.0f - fr) * diff * ar + spec * fr) * k * cs.x;
      sg += ((1.0f - fg) * diff * ag + spec * fg) * k * cs.y;
      sb += ((1.0f - fb) * diff * ab + spec * fb) * k * cs.z;
    }
  }

  if (inside) {
    dst[0] = sr;
    dst[1] = sg;
    dst[2] = sb;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `lights` is the (L, 16) float32
// light table, 16-byte aligned. Launches on `stream`, does not synchronise,
// allocates nothing; returns cudaGetLastError() after the launch.
extern "C" int zn_tiled_lights(const float* am, const float* nr, const float* pe,
                               const float* depth, const float* lights, const float* cam,
                               float* out, int num_lights, int h, int w, void* stream) {
  if (num_lights <= 0 || h <= 0 || w <= 0) return 0;
  const dim3 grid((w + kSubW - 1) / kSubW, (h + kSubH - 1) / kSubH);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  tiled_lights_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(am), reinterpret_cast<const float4*>(nr),
      reinterpret_cast<const float4*>(pe), depth, reinterpret_cast<const float4*>(lights), cam,
      out, num_lights, h, w);
  return (int)cudaGetLastError();
}
