// Native scene loader: threaded PNG decode + fused ray-buffer build.
//
// The host data path of the single-scene dataset (PIL decode + numpy ray
// math per image) as one C++ pipeline: each worker thread decodes one image
// (minimal PNG reader: zlib inflate + scanline defilter), white-blends
// alpha, and writes the flat (N_rays, 3) buffers (origins, unit directions,
// rgb) in place. aonerf_torch/native/__init__.py builds it with g++ and
// loads it via ctypes. The arithmetic is the JAX package's loader's, so the
// buffers carry the same bits.
//
// Scope: 8-bit, non-interlaced PNG, color types 0 (gray), 2 (RGB),
// 4 (gray+alpha), 6 (RGBA) — everything PIL and SAPIEN emit for rgb.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Image {
  int w = 0, h = 0, channels = 0;
  std::vector<uint8_t> pixels;  // h*w*channels, row-major
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b),
      pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Returns 0 on success; negative error codes otherwise.
int decode_png(const uint8_t* data, size_t n, Image* out) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (n < 8 || std::memcmp(data, kSig, 8) != 0) return -1;

  size_t pos = 8;
  int width = 0, height = 0, depth = 0, color = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= n) {
    uint32_t len = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    if (pos + 12 + len > n) return -2;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return -2;
      width = int(be32(body));
      height = int(be32(body + 4));
      depth = body[8];
      color = body[9];
      interlace = body[12];
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (width <= 0 || height <= 0 || depth != 8 || interlace != 0) return -3;
  int ch;
  switch (color) {
    case 0: ch = 1; break;
    case 2: ch = 3; break;
    case 4: ch = 2; break;
    case 6: ch = 4; break;
    default: return -3;  // palette (3) unsupported
  }

  const size_t stride = size_t(width) * ch;
  std::vector<uint8_t> raw(size_t(height) * (stride + 1));
  uLongf raw_len = uLongf(raw.size());
  if (uncompress(raw.data(), &raw_len, idat.data(), uLong(idat.size())) != Z_OK ||
      raw_len != raw.size())
    return -4;

  out->w = width;
  out->h = height;
  out->channels = ch;
  out->pixels.resize(size_t(height) * stride);
  const int bpp = ch;
  uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = raw.data() + size_t(y) * (stride + 1);
    uint8_t* dst = out->pixels.data() + size_t(y) * stride;
    const int filter = src[0];
    ++src;
    switch (filter) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        for (size_t x = 0; x < stride; ++x)
          dst[x] = uint8_t(src[x] + (x >= size_t(bpp) ? dst[x - bpp] : 0));
        break;
      case 2:
        for (size_t x = 0; x < stride; ++x)
          dst[x] = uint8_t(src[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          dst[x] = uint8_t(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          int c = (prev && x >= size_t(bpp)) ? prev[x - bpp] : 0;
          dst[x] = uint8_t(src[x] + paeth(a, b, c));
        }
        break;
      default:
        return -5;
    }
    prev = dst;
  }
  return 0;
}

int read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -10;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz <= 0) {
    std::fclose(f);
    return -10;
  }
  out->resize(size_t(sz));
  size_t got = std::fread(out->data(), 1, size_t(sz), f);
  std::fclose(f);
  return got == size_t(sz) ? 0 : -10;
}

// Fill rgb (+optional alpha) for one decoded image, white/black-blended.
void blend_into(const Image& img, int white_bkgd, float* rgb, float* alpha) {
  const size_t npix = size_t(img.w) * img.h;
  const float bg = white_bkgd ? 1.0f : 0.0f;
  const uint8_t* p = img.pixels.data();
  const float inv = 1.0f / 255.0f;
  for (size_t i = 0; i < npix; ++i) {
    float r, g, b, a;
    switch (img.channels) {
      case 1: r = g = b = p[i] * inv; a = 1.0f; break;
      case 2: r = g = b = p[2 * i] * inv; a = p[2 * i + 1] * inv; break;
      case 3: r = p[3 * i] * inv; g = p[3 * i + 1] * inv; b = p[3 * i + 2] * inv; a = 1.0f; break;
      default:
        r = p[4 * i] * inv; g = p[4 * i + 1] * inv; b = p[4 * i + 2] * inv;
        a = p[4 * i + 3] * inv;
    }
    rgb[3 * i] = r * a + bg * (1.0f - a);
    rgb[3 * i + 1] = g * a + bg * (1.0f - a);
    rgb[3 * i + 2] = b * a + bg * (1.0f - a);
    if (alpha) alpha[i] = a;
  }
}

}  // namespace

extern "C" {

// Decode one PNG into caller buffers (for eval-path single images).
// rgb: (h*w*3) f32 out; alpha: (h*w) f32 out or null. Returns 0 or error.
int aonerf_decode_png(const char* path, int expect_w, int expect_h,
                      int white_bkgd, float* rgb, float* alpha) {
  std::vector<uint8_t> buf;
  int rc = read_file(path, &buf);
  if (rc) return rc;
  Image img;
  rc = decode_png(buf.data(), buf.size(), &img);
  if (rc) return rc;
  if (img.w != expect_w || img.h != expect_h) return -20;  // caller resizes via PIL
  blend_into(img, white_bkgd, rgb, alpha);
  return 0;
}

// Decode one PNG into an RGBA u8 buffer (h*w*4; alpha=255 when the file
// has none). Returns 0 or error (-20 = dimension mismatch: caller resizes
// via PIL instead).
int aonerf_decode_png_u8(const char* path, int expect_w, int expect_h,
                         uint8_t* rgba) {
  std::vector<uint8_t> buf;
  int rc = read_file(path, &buf);
  if (rc) return rc;
  Image img;
  rc = decode_png(buf.data(), buf.size(), &img);
  if (rc) return rc;
  if (img.w != expect_w || img.h != expect_h) return -20;
  const size_t npix = size_t(img.w) * img.h;
  const uint8_t* p = img.pixels.data();
  for (size_t i = 0; i < npix; ++i) {
    switch (img.channels) {
      case 1:
        rgba[4 * i] = rgba[4 * i + 1] = rgba[4 * i + 2] = p[i];
        rgba[4 * i + 3] = 255;
        break;
      case 2:
        rgba[4 * i] = rgba[4 * i + 1] = rgba[4 * i + 2] = p[2 * i];
        rgba[4 * i + 3] = p[2 * i + 1];
        break;
      case 3:
        rgba[4 * i] = p[3 * i];
        rgba[4 * i + 1] = p[3 * i + 1];
        rgba[4 * i + 2] = p[3 * i + 2];
        rgba[4 * i + 3] = 255;
        break;
      default:
        std::memcpy(rgba + 4 * i, p + 4 * i, 4);
    }
  }
  return 0;
}

// Load a whole scene: n images, each h*w pixels. Fuses decode + blend +
// world-ray construction, parallel over images.
//   paths:   n C-strings
//   c2ws:    (n, 12) f32 row-major 3x4 camera-to-world
//   dirs:    (h*w, 3) f32 camera-frame pixel directions
//   rays_o/rays_d/rgbs: (n*h*w, 3) f32 outputs (rays_d = unit viewdirs,
//            matching get_rays_np aliasing, ray_utils.py:145-148)
//   alphas:  (n*h*w) f32 output or null
// Returns 0, or the (index+1) of the first image that failed (e.g. size
// mismatch -> caller falls back to the PIL path for everything).
int aonerf_load_scene(const char* const* paths, int n, const float* c2ws,
                      const float* dirs, int h, int w, int white_bkgd,
                      float* rays_o, float* rays_d, float* rgbs,
                      float* alphas, int n_threads) {
  const size_t npix = size_t(h) * w;
  std::atomic<int> next(0), failed(0);
  if (n_threads <= 0) n_threads = int(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = 2;
  if (n_threads > n) n_threads = n;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load()) return;
      std::vector<uint8_t> buf;
      Image img;
      if (read_file(paths[i], &buf) ||
          decode_png(buf.data(), buf.size(), &img) || img.w != w ||
          img.h != h) {
        failed.store(i + 1);
        return;
      }
      float* rgb = rgbs + 3 * npix * i;
      blend_into(img, white_bkgd, rgb, alphas ? alphas + npix * i : nullptr);

      const float* M = c2ws + 12 * i;  // rows: [R | t]
      float* o = rays_o + 3 * npix * i;
      float* d = rays_d + 3 * npix * i;
      for (size_t p = 0; p < npix; ++p) {
        const float dx = dirs[3 * p], dy = dirs[3 * p + 1], dz = dirs[3 * p + 2];
        float wx = M[0] * dx + M[1] * dy + M[2] * dz;
        float wy = M[4] * dx + M[5] * dy + M[6] * dz;
        float wz = M[8] * dx + M[9] * dy + M[10] * dz;
        const float invn = 1.0f / std::sqrt(wx * wx + wy * wy + wz * wz);
        d[3 * p] = wx * invn;
        d[3 * p + 1] = wy * invn;
        d[3 * p + 2] = wz * invn;
        o[3 * p] = M[3];
        o[3 * p + 1] = M[7];
        o[3 * p + 2] = M[11];
      }
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load();
}

}  // extern "C"
