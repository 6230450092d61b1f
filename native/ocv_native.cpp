// Native host-side runtime for oclcomputervision_jax.
//
// The accelerator owns the compute path (JAX/XLA/Pallas); this library owns the
// host side: asset decode (.flo), uint8 staging transforms, and fast CPU
// reference kernels used as golden oracles and device-less fallbacks.
// (The reference toolkit's host runtime was pyopencl host code,
// e.g. histeq/eq_opencl.py; this is its native equivalent.)
//
// Exposed as a plain C ABI consumed via ctypes
// (oclcomputervision_jax/utils/_native.py). Build: native/build.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

extern "C" {

// ---------------------------------------------------------------- .flo codec
// Middlebury .flo: float tag 202021.25, int32 w, int32 h, interleaved
// (u, v) float32 (me_test.py:12-44 semantics).
int flo_probe(const uint8_t* raw, int64_t nbytes, int32_t* w, int32_t* h) {
  if (nbytes < 12) return -1;
  float tag;
  std::memcpy(&tag, raw, 4);
  if (tag != 202021.25f) return -2;
  std::memcpy(w, raw + 4, 4);
  std::memcpy(h, raw + 8, 4);
  if (*w <= 0 || *h <= 0 || nbytes < 12 + int64_t(*w) * *h * 8) return -3;
  return 0;
}

int flo_decode(const uint8_t* raw, int64_t nbytes, float* out /*[h*w*2]*/) {
  int32_t w, h;
  int rc = flo_probe(raw, nbytes, &w, &h);
  if (rc != 0) return rc;
  std::memcpy(out, raw + 12, size_t(w) * h * 8);
  return 0;
}

int flo_encode_header(int32_t w, int32_t h, uint8_t* out /*[12]*/) {
  float tag = 202021.25f;
  std::memcpy(out, &tag, 4);
  std::memcpy(out + 4, &w, 4);
  std::memcpy(out + 8, &h, 4);
  return 0;
}

// ------------------------------------------------------------ histogram grid
// Per-tile histograms, layout [gh, gw, 256] like hist.cl:41-90 output.
void hist_grid_u8(const uint8_t* img, int64_t h, int64_t w, int64_t th,
                  int64_t tw, uint32_t* out /*[h/th * w/tw * 256]*/) {
  const int64_t gh = h / th, gw = w / tw;
  std::memset(out, 0, size_t(gh) * gw * 256 * 4);
  for (int64_t gy = 0; gy < gh; ++gy)
    for (int64_t gx = 0; gx < gw; ++gx) {
      uint32_t* bins = out + (gy * gw + gx) * 256;
      for (int64_t y = gy * th; y < (gy + 1) * th; ++y) {
        const uint8_t* row = img + y * w + gx * tw;
        for (int64_t x = 0; x < tw; ++x) bins[row[x]]++;
      }
    }
}

// ------------------------------------------------------------- transfer func
// Exact float64 reproduction of eq_global.py:10-37 (CDF -> punch ->
// alpha-blend -> clip -> gain limit).
void calc_transfer_func(const double* hist /*[n]*/, int64_t n, double alpha,
                        double punch, double clip, float* out /*[n]*/) {
  double total = 0;
  for (int64_t i = 0; i < n; ++i) total += hist[i];
  double acc = 0;
  int64_t dark = 0, bright = 0;
  bool dark_set = false, bright_set = false;
  for (int64_t i = 0; i < n; ++i) {
    acc += hist[i];
    const double cdf = acc / total;
    if (!dark_set && cdf >= punch) { dark = i; dark_set = true; }
    if (!bright_set && cdf >= 1.0 - punch) { bright = i; bright_set = true; }
  }
  double punched_total = 0;
  for (int64_t i = dark; i < bright; ++i) punched_total += hist[i];
  double pacc = 0;
  for (int64_t i = 0; i < n; ++i) {
    double cdf;
    if (i < dark) {
      cdf = 0.0;
    } else if (i >= bright) {
      cdf = 1.0;
    } else {
      pacc += hist[i];
      cdf = pacc / punched_total;
    }
    double m = alpha * cdf * 255.0 + (1.0 - alpha) * double(i);
    m = std::min(std::max(m, 0.0), 255.0);
    m = std::min(std::max(m, double(i) / clip), double(i) * clip);
    out[i] = float(m);
  }
}

// ------------------------------------------------------------------ LUT apply
void apply_lut_u8(const uint8_t* img, const uint8_t* lut /*[256]*/,
                  uint8_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = lut[img[i]];
}

// --------------------------------------------------- block-matching ME oracle
// Dense shrinking-step SAD search, numerically identical to
// motion_estimation/me_pyramid.py:130-205 (zero-padded OOB, first-min
// tie-break in row-major (dy,dx) order, trunc-toward-zero seed use,
// 'shipped' seed double-count or 'fixed' displacement output).
static inline int32_t sad_at(const uint8_t* f0, const uint8_t* f1, int64_t h,
                             int64_t w, int64_t y0, int64_t x0, int64_t y1,
                             int64_t x1, int64_t ps) {
  int32_t s = 0;
  const int64_t pm = ps / 2;
  for (int64_t i = 0; i < ps; ++i)
    for (int64_t j = 0; j < ps; ++j) {
      const int64_t ay = y0 - pm + i, ax = x0 - pm + j;
      const int64_t by = y1 - pm + i, bx = x1 - pm + j;
      const int32_t a =
          (ay >= 0 && ay < h && ax >= 0 && ax < w) ? f0[ay * w + ax] : 0;
      const int32_t b =
          (by >= 0 && by < h && bx >= 0 && bx < w) ? f1[by * w + bx] : 0;
      s += a > b ? a - b : b - a;
    }
  return s;
}

void block_match(const uint8_t* f0, const uint8_t* f1, int64_t h, int64_t w,
                 const float* seed /*[h*w*2] or null*/, int64_t search_size,
                 int64_t patch_size, int shipped_seed_mode,
                 float* mv_out /*[h*w*2]*/) {
  const int64_t step0 = search_size / 2 - patch_size / 2;
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      const float su = seed ? seed[(y * w + x) * 2 + 0] : 0.0f;
      const float sv = seed ? seed[(y * w + x) * 2 + 1] : 0.0f;
      int64_t cy = y + int64_t(std::trunc(sv));
      int64_t cx = x + int64_t(std::trunc(su));
      for (int64_t step = step0; step >= 1; step /= 2) {
        int32_t best = std::numeric_limits<int32_t>::max();
        int64_t bdy = 0, bdx = 0;
        for (int64_t dy = -step; dy <= step; dy += step)
          for (int64_t dx = -step; dx <= step; dx += step) {
            const int32_t s =
                sad_at(f0, f1, h, w, y, x, cy + dy, cx + dx, patch_size);
            if (s < best) { best = s; bdy = dy; bdx = dx; }
          }
        cy += bdy;
        cx += bdx;
      }
      const float du = float(cx - x), dv = float(cy - y);
      mv_out[(y * w + x) * 2 + 0] = shipped_seed_mode ? su + du : du;
      mv_out[(y * w + x) * 2 + 1] = shipped_seed_mode ? sv + dv : dv;
    }
  }
}

// ----------------------------------------------------------- tile staging
// [H, W] uint8 -> [gh, gw, th, tw] tiles (host-side staging for padded
// device uploads).
void tile_pack_u8(const uint8_t* img, int64_t h, int64_t w, int64_t th,
                  int64_t tw, uint8_t pad_value, int64_t gh, int64_t gw,
                  uint8_t* out /*[gh*gw*th*tw]*/) {
  for (int64_t gy = 0; gy < gh; ++gy)
    for (int64_t gx = 0; gx < gw; ++gx) {
      uint8_t* tile = out + ((gy * gw) + gx) * th * tw;
      for (int64_t i = 0; i < th; ++i) {
        const int64_t y = gy * th + i;
        uint8_t* dst = tile + i * tw;
        if (y >= h) {
          std::memset(dst, pad_value, size_t(tw));
          continue;
        }
        const int64_t x0 = gx * tw;
        const int64_t ncopy = std::max<int64_t>(0, std::min(tw, w - x0));
        if (ncopy > 0) std::memcpy(dst, img + y * w + x0, size_t(ncopy));
        if (ncopy < tw) std::memset(dst + ncopy, pad_value, size_t(tw - ncopy));
      }
    }
}

}  // extern "C"
