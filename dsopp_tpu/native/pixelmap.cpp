// Native host-side image preprocessing kernels.
//
// Native analog of the reference's hand-vectorized CPU kernels
// (reference: src/features/src/calculate_pixelinfo.cpp — AVX2 gradient
// computation; downscale_image.hpp — 2x2 average pyramid;
// photometrically_corrected_image.cpp — inverse-response LUT).
//
// These run on the host data path: decoding/correcting/pyramid-building the
// incoming frame while the device computes on the previous one.  Built with
// -O3 -march=native; exposed to Python via ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Photometric correction: out[i] = lut[img[i]] (linear interp) / vignette[i].
void photometric_correct(const float* img, const float* lut256,
                         const float* vignette, float* out, int64_t n) {
  if (vignette) {
    for (int64_t i = 0; i < n; ++i) {
      float v = img[i];
      v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
      int lo = static_cast<int>(v);
      int hi = lo < 255 ? lo + 1 : 255;
      float frac = v - static_cast<float>(lo);
      float c = lut256[lo] * (1.f - frac) + lut256[hi] * frac;
      float vg = vignette[i] > 1e-3f ? vignette[i] : 1e-3f;
      out[i] = c / vg;
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      float v = img[i];
      v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
      int lo = static_cast<int>(v);
      int hi = lo < 255 ? lo + 1 : 255;
      float frac = v - static_cast<float>(lo);
      out[i] = lut256[lo] * (1.f - frac) + lut256[hi] * frac;
    }
  }
}

// 2x2 average downscale (reference downscaleImage).
void downscale2(const float* img, int h, int w, float* out) {
  int oh = h / 2, ow = w / 2;
  for (int y = 0; y < oh; ++y) {
    const float* r0 = img + (2 * y) * w;
    const float* r1 = img + (2 * y + 1) * w;
    float* o = out + y * ow;
    for (int x = 0; x < ow; ++x) {
      o[x] = 0.25f * (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1]);
    }
  }
}

// Per-pixel gradients: central differences *0.5 interior, one-sided borders
// (reference calculate_pixelinfo semantics).  Writes a [3, H, W] pixel map:
// channel 0 = intensity copy, 1 = dx, 2 = dy.
void pixel_map(const float* img, int h, int w, float* out3hw) {
  float* intensity = out3hw;
  float* dx = out3hw + static_cast<int64_t>(h) * w;
  float* dy = dx + static_cast<int64_t>(h) * w;
  std::memcpy(intensity, img, sizeof(float) * static_cast<size_t>(h) * w);
  for (int y = 0; y < h; ++y) {
    const float* row = img + y * w;
    float* dxr = dx + y * w;
    dxr[0] = row[1] - row[0];
    for (int x = 1; x < w - 1; ++x) dxr[x] = 0.5f * (row[x + 1] - row[x - 1]);
    dxr[w - 1] = row[w - 1] - row[w - 2];
  }
  for (int x = 0; x < w; ++x) {
    dy[x] = img[w + x] - img[x];
    dy[(h - 1) * w + x] = img[(h - 1) * w + x] - img[(h - 2) * w + x];
  }
  for (int y = 1; y < h - 1; ++y) {
    const float* up = img + (y - 1) * w;
    const float* dn = img + (y + 1) * w;
    float* dyr = dy + y * w;
    for (int x = 0; x < w; ++x) dyr[x] = 0.5f * (dn[x] - up[x]);
  }
}

// Full pyramid of pixel maps in one call: outs[l] is a [3, h_l, w_l] buffer,
// scratch must hold h*w floats.  Levels halve exactly.
void pyramid_pixel_maps(const float* img, int h, int w, int levels,
                        float** outs, float* scratch_a, float* scratch_b) {
  const float* cur = img;
  int ch = h, cw = w;
  float* bufs[2] = {scratch_a, scratch_b};
  int which = 0;
  for (int l = 0; l < levels; ++l) {
    pixel_map(cur, ch, cw, outs[l]);
    if (l + 1 < levels) {
      float* next = bufs[which];
      downscale2(cur, ch, cw, next);
      cur = next;
      ch /= 2;
      cw /= 2;
      which ^= 1;
    }
  }
}

}  // extern "C"
