// zenith_tpu_torch native runtime helpers (C++, loaded via ctypes).
//
// The reference implements its engine runtime in native code (Rust); this
// module provides native implementations for the host-side hot paths that
// remain CPU work (the device compute path is PyTorch + hand-written CUDA):
//
//   zn_hash64      — 64-bit content hash (xxhash64-style mixing) used by the
//                    render-graph structure key each frame (the foldhash
//                    DefaultHasher analog, zenith-core/src/collections.rs).
//   zn_encode_png  — zlib-backed PNG encoder for swapchain frame dumps /
//                    golden-image output (the `image` crate analog).
//
// Build: g++ -O3 -shared -fPIC native.cpp -o libzenith_native.so -lz
// (driven by zenith_tpu_torch/native/__init__.py; pure-Python fallbacks exist).

#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// xxhash64-style avalanche hash (public algorithm, independent impl).
// ---------------------------------------------------------------------------

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

uint64_t zn_hash64(const uint8_t* data, size_t len, uint64_t seed) {
  const uint64_t P1 = 0x9E3779B185EBCA87ULL;
  const uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
  const uint64_t P3 = 0x165667B19E3779F9ULL;
  const uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
  const uint64_t P5 = 0x27D4EB2F165667C5ULL;

  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t h;

  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    while (p + 32 <= end) {
      uint64_t k;
      memcpy(&k, p, 8);       v1 = rotl64(v1 + k * P2, 31) * P1;
      memcpy(&k, p + 8, 8);   v2 = rotl64(v2 + k * P2, 31) * P1;
      memcpy(&k, p + 16, 8);  v3 = rotl64(v3 + k * P2, 31) * P1;
      memcpy(&k, p + 24, 8);  v4 = rotl64(v4 + k * P2, 31) * P1;
      p += 32;
    }
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    uint64_t vs[4] = {v1, v2, v3, v4};
    for (uint64_t v : vs) {
      h ^= rotl64(v * P2, 31) * P1;
      h = h * P1 + P4;
    }
  } else {
    h = seed + P5;
  }
  h += (uint64_t)len;

  while (p + 8 <= end) {
    uint64_t k;
    memcpy(&k, p, 8);
    h ^= rotl64(k * P2, 31) * P1;
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    uint32_t k;
    memcpy(&k, p, 4);
    h ^= (uint64_t)k * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (uint64_t)(*p) * P5;
    h = rotl64(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// PNG encoding (8-bit RGB / RGBA, filter 0), zlib-compressed.
// ---------------------------------------------------------------------------

static void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back((x >> 24) & 0xFF);
  v.push_back((x >> 16) & 0xFF);
  v.push_back((x >> 8) & 0xFF);
  v.push_back(x & 0xFF);
}

static void put_chunk(std::vector<uint8_t>& out, const char type[4],
                      const uint8_t* data, size_t len) {
  put_be32(out, (uint32_t)len);
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  if (len) out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, out.data() + start, (uInt)(4 + len));
  put_be32(out, crc);
}

// Returns the number of bytes written to `out` (or 0 on failure). `out`
// must have capacity >= zn_png_bound(width, height, channels).
size_t zn_encode_png(const uint8_t* pixels, uint32_t width, uint32_t height,
                     uint32_t channels, uint8_t* out, size_t out_capacity) {
  if (channels != 3 && channels != 4) return 0;

  // Filtered scanlines (filter byte 0 per row).
  const size_t stride = (size_t)width * channels;
  std::vector<uint8_t> raw((stride + 1) * height);
  for (uint32_t y = 0; y < height; ++y) {
    raw[y * (stride + 1)] = 0;
    memcpy(&raw[y * (stride + 1) + 1], pixels + y * stride, stride);
  }

  uLongf comp_cap = compressBound((uLong)raw.size());
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), (uLong)raw.size(), 6) != Z_OK)
    return 0;

  std::vector<uint8_t> png;
  png.reserve(comp_cap + 128);
  const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  png.insert(png.end(), sig, sig + 8);

  uint8_t ihdr[13];
  ihdr[0] = (width >> 24) & 0xFF; ihdr[1] = (width >> 16) & 0xFF;
  ihdr[2] = (width >> 8) & 0xFF;  ihdr[3] = width & 0xFF;
  ihdr[4] = (height >> 24) & 0xFF; ihdr[5] = (height >> 16) & 0xFF;
  ihdr[6] = (height >> 8) & 0xFF;  ihdr[7] = height & 0xFF;
  ihdr[8] = 8;                         // bit depth
  ihdr[9] = (channels == 3) ? 2 : 6;   // color type: RGB / RGBA
  ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  put_chunk(png, "IHDR", ihdr, 13);
  put_chunk(png, "IDAT", comp.data(), comp_cap);
  put_chunk(png, "IEND", nullptr, 0);

  if (png.size() > out_capacity) return 0;
  memcpy(out, png.data(), png.size());
  return png.size();
}

size_t zn_png_bound(uint32_t width, uint32_t height, uint32_t channels) {
  size_t raw = ((size_t)width * channels + 1) * height;
  return compressBound((uLong)raw) + 1024;
}

}  // extern "C"
