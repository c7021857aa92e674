// Host output path of the PyTorch port: tonemap to 8-bit RGB and a PNG
// writer, in plain C++ with zlib.  The port's own copy of the two output
// functions of the JAX package's native runtime; nothing else of that
// runtime is needed here.
//
// Pure C ABI, loaded with ctypes by runtime/native.py.  Build (at first
// use, runtime/build.py):
//   g++ -O2 -ffp-contract=off -shared -fPIC -std=c++17 ptru_native.cpp -lz

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <zlib.h>

// HDR [n_px, 3] f32 -> LDR [n_px, 3] u8: exposure, Reinhard, gamma.  The
// formula of utils/image.py:tonemap; powf may differ from numpy's power by
// an ulp, so a value can land 1 LSB away.
extern "C" void ptru_tonemap_rgb8(const float *hwc, uint8_t *out, int64_t n_px,
                                  float exposure, float inv_gamma) {
  int64_t n = n_px * 3;
  for (int64_t i = 0; i < n; ++i) {
    float x = hwc[i] * exposure;
    x = x / (1.0f + x);
    x = x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
    x = powf(x, inv_gamma);
    out[i] = (uint8_t)(x * 255.0f + 0.5f);
  }
}

static void png_chunk(FILE *f, const char tag[4], const uint8_t *data,
                      uint32_t len) {
  uint8_t hdr[8] = {(uint8_t)(len >> 24), (uint8_t)(len >> 16),
                    (uint8_t)(len >> 8),  (uint8_t)len,
                    (uint8_t)tag[0],      (uint8_t)tag[1],
                    (uint8_t)tag[2],      (uint8_t)tag[3]};
  fwrite(hdr, 1, 8, f);
  if (len) fwrite(data, 1, len, f);
  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, hdr + 4, 4);
  if (len) crc = crc32(crc, data, len);
  uint8_t cb[4] = {(uint8_t)(crc >> 24), (uint8_t)(crc >> 16),
                   (uint8_t)(crc >> 8), (uint8_t)crc};
  fwrite(cb, 1, 4, f);
}

// 8-bit RGB PNG of rgb [h, w, 3] (filter 0 per scanline, zlib level 6, as
// utils/image.py:encode_png).  Returns 0 on success, 1 if zlib failed, 2 if
// the file could not be opened, 3 if it could not be written in full.
extern "C" int ptru_write_png(const char *path, const uint8_t *rgb, int w, int h) {
  int64_t stride = (int64_t)w * 3;
  std::vector<uint8_t> raw((stride + 1) * h);
  for (int y = 0; y < h; ++y) {
    raw[(stride + 1) * y] = 0;
    memcpy(&raw[(stride + 1) * y + 1], rgb + stride * y, stride);
  }
  uLongf comp_cap = compressBound(raw.size());
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), raw.size(), 6) != Z_OK)
    return 1;

  FILE *f = fopen(path, "wb");
  if (!f) return 2;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  fwrite(sig, 1, 8, f);
  uint8_t ihdr[13] = {(uint8_t)(w >> 24), (uint8_t)(w >> 16), (uint8_t)(w >> 8),
                      (uint8_t)w,         (uint8_t)(h >> 24), (uint8_t)(h >> 16),
                      (uint8_t)(h >> 8),  (uint8_t)h,         8,
                      2,                  0,                  0,
                      0};
  png_chunk(f, "IHDR", ihdr, 13);
  png_chunk(f, "IDAT", comp.data(), (uint32_t)comp_cap);
  png_chunk(f, "IEND", nullptr, 0);
  int failed = ferror(f);
  if (fclose(f) != 0 || failed) return 3;
  return 0;
}
