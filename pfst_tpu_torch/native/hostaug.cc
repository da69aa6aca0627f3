// Host-side data-pipeline kernels of the PyTorch port (copy of
// pfst_tpu/native/hostaug.cc, whose HSV round trip it keeps unchanged,
// plus PNG unfiltering and OpenCV-exact uint8 resizes).
//
// * hsv_modify_u8: the photometric distortion's saturation/hue step
//   (PhotoMetricDistortion / StrongAugmentation, reference
//   rsiseg/datasets/pipelines/transforms.py:943-1160) fused into one pass
//   per pixel, bit-exact to OpenCV's uint8 BGR->HSV->BGR at widths that
//   are multiples of 32 (the JAX file's notes, below, and
//   tests/test_native_hostaug.py hold it over the full cubes):
//   - BGR->HSV (8u): fixed-point with the sdiv/hdiv tables and
//     hsv_shift=12 rounding (opencv color_hsv RGB2HSV_b).
//   - HSV->BGR (8u): float sector formula; the 1 - s*(1-h) / 1 - s*h
//     terms are FMA-contracted (fmaf), the final x*255 is TRUNCATED to
//     int. Built with -ffp-contract=off + explicit fmaf so the compiler
//     cannot re-associate differently. OpenCV's own scalar tail rounds
//     where its 32-pixel SIMD loop truncates; this kernel implements the
//     SIMD behaviour everywhere.
// * png_unfilter: the five PNG row filters (None, Sub, Up, Average,
//   Paeth) undone in place, for the port's own PNG reader.
// * resize_linear_u8 / resize_nearest_u8: cv2.resize INTER_LINEAR and
//   INTER_NEAREST on uint8 images. The caller (pipelines/transforms.py)
//   computes OpenCV's source offsets and 11-bit fixed-point weights;
//   these loops do OpenCV's integer arithmetic: the horizontal pass
//   S0*a0 + S1*a1, then the vertical pass
//   ((((r0 >> 4) * b0) >> 16) + (((r1 >> 4) * b1) >> 16) + 2) >> 2.
// * resize_linear_f32: cv2.resize INTER_LINEAR on float32 images of at
//   least two rows and columns, as OpenCV 5 computes it: each pass is
//   fmaf(S1 - S0, f, S0), with the fractions f from the caller.
// * warp_affine_linear_{u8,u16,f32} / warp_affine_nearest: cv2.warpAffine
//   INTER_LINEAR and INTER_NEAREST with a constant border on uint8,
//   uint16 and float32 images (nearest on any pixel size), as OpenCV 5
//   computes them in float32 (its AVX2 kernels, 16
//   columns a vector step): the caller gives the inverse map (float32,
//   from OpenCV's float64 inversion). In the columns of the vector steps
//   (x + 16 <= dw from x = 0) the source point is
//   sx = fmaf(x, M0, y * M1 + M2), in the remaining columns OpenCV's
//   scalar tail fmaf(x, M0, y * M1) + M2 (likewise sy). Nearest takes
//   the pixel at (lrintf(sx), lrintf(sy)); linear blends the four taps
//   at floor(sx), floor(sy) by fmaf(a, p1 - p0, p0) along x, then y,
//   with lrintf and saturation at the end; a tap outside the image
//   reads the border value of its channel.
// * clahe_u8: cv::CLAHE::apply on one uint8 plane: tiles of the image
//   padded bottom and right with BORDER_REFLECT_101 where the grid does
//   not divide it (by a whole tile count where it does divide one side,
//   as OpenCV pads), histograms clipped at max(1, int(clip * area /
//   256)) with the excess spread as a batch over all bins and then one
//   count every max(256 / residual, 1) bins, the LUT
//   saturate(lrintf(cumsum * (255.f / area))), and the float32 bilinear
//   blend of the four tiles' LUTs around each pixel.
// * apply_lut_u8: dst[i] = lut[src[i]] (cv2.LUT on uint8).
// * tiff_lzw_decode / tiff_lzw_encode / packbits_decode: the TIFF
//   codecs of compression 5 (LZW, MSB-first codes of 9 to 12 bits with
//   the width growing one code early, as libtiff reads and writes them)
//   and 32773 (PackBits), for the port's own TIFF reader and writer
//   (pipelines/tiff.py).
//
// Built with g++ at first use by pfst_tpu_torch/native/hostaug.py; a
// failed build raises, nothing falls back.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kHsvShift = 12;

struct Tables {
  int sdiv[256];
  int hdiv[256];
  Tables() {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = static_cast<int>((255 << kHsvShift) / (1.0 * i) + 0.5);
      hdiv[i] = static_cast<int>((180 << kHsvShift) / (6.0 * i) + 0.5);
    }
  }
};
const Tables kTab;

inline void bgr2hsv_px(int b, int g, int r, uint8_t* h8, uint8_t* s8,
                       uint8_t* v8) {
  int v = b > g ? b : g;
  if (r > v) v = r;
  int vmin = b < g ? b : g;
  if (r < vmin) vmin = r;
  int diff = v - vmin;
  int vr = v == r ? -1 : 0;
  int vg = v == g ? -1 : 0;
  int s = (diff * kTab.sdiv[v] + (1 << (kHsvShift - 1))) >> kHsvShift;
  int h = (vr & (g - b)) +
          (~vr & ((vg & (b - r + 2 * diff)) +
                  ((~vg) & (r - g + 4 * diff))));
  h = (h * kTab.hdiv[diff] + (1 << (kHsvShift - 1))) >> kHsvShift;
  h += h < 0 ? 180 : 0;
  *h8 = static_cast<uint8_t>(h);
  *s8 = static_cast<uint8_t>(s);
  *v8 = static_cast<uint8_t>(v);
}

inline uint8_t trunc_u8(float x) {
  // cv2 (5.0) truncates the final x*255 toward zero, then clamps.
  int i = static_cast<int>(x);
  return static_cast<uint8_t>(i < 0 ? 0 : (i > 255 ? 255 : i));
}

inline void hsv2bgr_px(uint8_t h8, uint8_t s8, uint8_t v8, uint8_t* b8,
                       uint8_t* g8, uint8_t* r8) {
  if (s8 == 0) {
    *b8 = *g8 = *r8 = v8;
    return;
  }
  float s = s8 * (1.f / 255.f);
  float v = v8 * (1.f / 255.f);
  float b, g, r;
  {
    // Derived from OpenCV 5.0's uint8 HSV->BGR (held over the full cube
    // by tests/test_native_hostaug.py); rows 3-5 differ from the
    // classic OpenCV table.
    static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2},
                                          {3, 0, 1}, {0, 2, 1},
                                          {0, 1, 3}, {2, 1, 0}};
    float h = h8 * (6.f / 180.f);
    if (h < 0.f) {
      do h += 6.f; while (h < 0.f);
    } else if (h >= 6.f) {
      do h -= 6.f; while (h >= 6.f);
    }
    int sector = static_cast<int>(std::floor(h));
    h -= sector;
    if (static_cast<unsigned>(sector) >= 6u) {
      sector = 0;
      h = 0.f;
    }
    float tab[4];
    tab[0] = v;
    tab[1] = v * (1.f - s);
    tab[2] = v * std::fmaf(-s, h, 1.f);
    tab[3] = v * std::fmaf(-s, 1.f - h, 1.f);
    b = tab[sector_data[sector][0]];
    g = tab[sector_data[sector][1]];
    r = tab[sector_data[sector][2]];
  }
  *b8 = trunc_u8(b * 255.f);
  *g8 = trunc_u8(g * 255.f);
  *r8 = trunc_u8(r * 255.f);
}

}  // namespace

extern "C" {

// Fused BGR -> HSV -> {S-LUT, H-LUT} -> BGR, one pass, no
// intermediate image.  Either LUT may be null (identity).  src/dst
// are HxWx3 uint8 BGR; may alias.
void hsv_modify_u8(const uint8_t* src, uint8_t* dst, int64_t npix,
                   const uint8_t* sat_lut, const uint8_t* hue_lut) {
  for (int64_t i = 0; i < npix; ++i) {
    const uint8_t* p = src + 3 * i;
    uint8_t h, s, v;
    bgr2hsv_px(p[0], p[1], p[2], &h, &s, &v);
    if (sat_lut) s = sat_lut[s];
    if (hue_lut) h = hue_lut[h];
    hsv2bgr_px(h, s, v, dst + 3 * i, dst + 3 * i + 1,
               dst + 3 * i + 2);
  }
}

// Bare conversions, exposed for the exhaustive parity tests.
void bgr2hsv_u8(const uint8_t* src, uint8_t* dst, int64_t npix) {
  for (int64_t i = 0; i < npix; ++i) {
    const uint8_t* p = src + 3 * i;
    bgr2hsv_px(p[0], p[1], p[2], dst + 3 * i, dst + 3 * i + 1,
               dst + 3 * i + 2);
  }
}

void hsv2bgr_u8(const uint8_t* src, uint8_t* dst, int64_t npix) {
  for (int64_t i = 0; i < npix; ++i) {
    const uint8_t* p = src + 3 * i;
    hsv2bgr_px(p[0], p[1], p[2], dst + 3 * i, dst + 3 * i + 1,
               dst + 3 * i + 2);
  }
}

// LUT gather: dst[i] = lut[src[i]] (any-layout uint8).
void apply_lut_u8(const uint8_t* src, uint8_t* dst, int64_t n,
                  const uint8_t* lut) {
  for (int64_t i = 0; i < n; ++i) dst[i] = lut[src[i]];
}

// Undo the PNG row filters in place. data holds height rows, each a
// filter-type byte followed by stride bytes; out receives the height x
// stride unfiltered bytes. bpp is the bytes per pixel (>= 1). Returns 0,
// or -1 on an unknown filter type.
int png_unfilter(const uint8_t* data, uint8_t* out, int64_t height,
                 int64_t stride, int64_t bpp) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = data + y * (stride + 1);
    uint8_t ftype = in[0];
    ++in;
    uint8_t* row = out + y * stride;
    const uint8_t* up = y > 0 ? out + (y - 1) * stride : nullptr;
    switch (ftype) {
      case 0:
        std::memcpy(row, in, stride);
        break;
      case 1:
        for (int64_t x = 0; x < stride; ++x)
          row[x] = in[x] + (x >= bpp ? row[x - bpp] : 0);
        break;
      case 2:
        for (int64_t x = 0; x < stride; ++x)
          row[x] = in[x] + (up ? up[x] : 0);
        break;
      case 3:
        for (int64_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? row[x - bpp] : 0;
          int b = up ? up[x] : 0;
          row[x] = in[x] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:
        for (int64_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? row[x - bpp] : 0;
          int b = up ? up[x] : 0;
          int c = (up && x >= bpp) ? up[x - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p;
          int pb = p > b ? p - b : b - p;
          int pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          row[x] = in[x] + static_cast<uint8_t>(pred);
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}

// cv2.resize(INTER_LINEAR) of an (h, w, cn) uint8 image to (dh, dw, cn).
// xofs[dw]: left source column; alpha[2*dw]: its 11-bit weights (the
// right column is min(xofs + 1, w - 1)); yofs[2*dh]: the two source rows;
// beta[2*dh]: their weights.
void resize_linear_u8(const uint8_t* src, int64_t h, int64_t w, int64_t cn,
                      uint8_t* dst, int64_t dh, int64_t dw,
                      const int32_t* xofs, const int16_t* alpha,
                      const int32_t* yofs, const int16_t* beta) {
  (void)h;
  const int64_t row_len = dw * cn;
  int32_t* rows = new int32_t[2 * row_len];
  int64_t cached[2] = {-1, -1};
  for (int64_t dy = 0; dy < dh; ++dy) {
    for (int k = 0; k < 2; ++k) {
      int64_t sy = yofs[2 * dy + k];
      int32_t* buf = rows + k * row_len;
      if (cached[k] == sy) continue;
      if (cached[1 - k] == sy) {
        std::memcpy(buf, rows + (1 - k) * row_len,
                    row_len * sizeof(int32_t));
      } else {
        const uint8_t* s = src + sy * w * cn;
        for (int64_t dx = 0; dx < dw; ++dx) {
          int64_t x0 = xofs[dx];
          int64_t x1 = x0 + 1 < w ? x0 + 1 : w - 1;
          int32_t a0 = alpha[2 * dx], a1 = alpha[2 * dx + 1];
          for (int64_t c = 0; c < cn; ++c)
            buf[dx * cn + c] = s[x0 * cn + c] * a0 + s[x1 * cn + c] * a1;
        }
      }
      cached[k] = sy;
    }
    const int32_t b0 = beta[2 * dy], b1 = beta[2 * dy + 1];
    uint8_t* d = dst + dy * row_len;
    for (int64_t i = 0; i < row_len; ++i) {
      int32_t v = (((rows[i] >> 4) * b0) >> 16) +
                  (((rows[row_len + i] >> 4) * b1) >> 16);
      v = (v + 2) >> 2;
      d[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
  delete[] rows;
}

// cv2.resize(INTER_NEAREST): dst[y, x] = src[yofs[y], xofs[x]], pixels of
// cn bytes.
void resize_nearest_u8(const uint8_t* src, int64_t w, int64_t cn,
                       uint8_t* dst, int64_t dh, int64_t dw,
                       const int32_t* xofs, const int32_t* yofs) {
  for (int64_t dy = 0; dy < dh; ++dy) {
    const uint8_t* s = src + static_cast<int64_t>(yofs[dy]) * w * cn;
    uint8_t* d = dst + dy * dw * cn;
    for (int64_t dx = 0; dx < dw; ++dx)
      std::memcpy(d + dx * cn, s + static_cast<int64_t>(xofs[dx]) * cn, cn);
  }
}

// cv2.resize(INTER_LINEAR) of an (h, w, cn) float32 image to (dh, dw, cn),
// h, w >= 2. x0[dw], x1[dw]: the two source columns; fx[dw]: the weight
// of x1; y0[dh], y1[dh], fy[dh] likewise for rows.
void resize_linear_f32(const float* src, int64_t w, int64_t cn, float* dst,
                       int64_t dh, int64_t dw, const int32_t* x0,
                       const int32_t* x1, const float* fx,
                       const int32_t* y0, const int32_t* y1,
                       const float* fy) {
  const int64_t row_len = dw * cn;
  std::vector<float> rows(2 * row_len);
  int64_t cached[2] = {-1, -1};
  for (int64_t dy = 0; dy < dh; ++dy) {
    const int64_t want[2] = {y0[dy], y1[dy]};
    for (int k = 0; k < 2; ++k) {
      float* buf = rows.data() + k * row_len;
      if (cached[k] == want[k]) continue;
      if (cached[1 - k] == want[k]) {
        std::memcpy(buf, rows.data() + (1 - k) * row_len,
                    row_len * sizeof(float));
      } else {
        const float* s = src + want[k] * w * cn;
        for (int64_t dx = 0; dx < dw; ++dx) {
          const float* a = s + static_cast<int64_t>(x0[dx]) * cn;
          const float* b = s + static_cast<int64_t>(x1[dx]) * cn;
          for (int64_t c = 0; c < cn; ++c)
            buf[dx * cn + c] = std::fmaf(b[c] - a[c], fx[dx], a[c]);
        }
      }
      cached[k] = want[k];
    }
    const float* r0 = rows.data();
    const float* r1 = rows.data() + row_len;
    float* d = dst + dy * row_len;
    for (int64_t i = 0; i < row_len; ++i)
      d[i] = std::fmaf(r1[i] - r0[i], fy[dy], r0[i]);
  }
}

}  // extern "C"

namespace {

inline uint8_t saturate_u8(float v) {
  long r = std::lrintf(v);
  return static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
}

constexpr int64_t kWarpStep = 16;  // OpenCV's AVX2 warp: 2 x 8 lanes

// The source point of output pixel (x, y) under the inverse map m, as
// OpenCV's vector steps (x < vec_end) or its scalar tail compute it.
inline void warp_point(const float* m, int64_t x, int64_t y, int64_t vec_end,
                       float* sx, float* sy) {
  const float fx = static_cast<float>(x), fy = static_cast<float>(y);
  if (x < vec_end) {
    *sx = std::fmaf(fx, m[0], fy * m[1] + m[2]);
    *sy = std::fmaf(fx, m[3], fy * m[4] + m[5]);
  } else {
    *sx = std::fmaf(fx, m[0], fy * m[1]) + m[2];
    *sy = std::fmaf(fx, m[3], fy * m[4]) + m[5];
  }
}

inline int64_t warp_vec_end(int64_t dw) {
  return dw >= kWarpStep ? (dw / kWarpStep) * kWarpStep : 0;
}

inline uint8_t store_px(float v, uint8_t*) { return saturate_u8(v); }
inline uint16_t store_px(float v, uint16_t*) {
  long r = std::lrintf(v);
  return static_cast<uint16_t>(r < 0 ? 0 : (r > 65535 ? 65535 : r));
}
inline float store_px(float v, float*) { return v; }

// cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT) of an (h, w, cn) image of
// T (uint8, uint16 or float32) into (dh, dw, cn); m: the inverse map
// (dst -> src), 6 floats; border: cn values of T. Integer types round
// and saturate at the end, float32 stores the blend as it is.
template <typename T>
void warp_linear(const T* src, int64_t h, int64_t w, int64_t cn, T* dst,
                 int64_t dh, int64_t dw, const float* m, const T* border) {
  std::vector<float> p(4 * cn);
  const int64_t vec_end = warp_vec_end(dw);
  for (int64_t y = 0; y < dh; ++y) {
    for (int64_t x = 0; x < dw; ++x) {
      float sx, sy;
      warp_point(m, x, y, vec_end, &sx, &sy);
      const float x0 = std::floor(sx), y0 = std::floor(sy);
      const float a = sx - x0, b = sy - y0;
      const int64_t ix = static_cast<int64_t>(x0);
      const int64_t iy = static_cast<int64_t>(y0);
      for (int k = 0; k < 4; ++k) {
        const int64_t ty = iy + (k >> 1), tx = ix + (k & 1);
        const bool inside = ty >= 0 && ty < h && tx >= 0 && tx < w;
        const T* s = src + (ty * w + tx) * cn;
        for (int64_t c = 0; c < cn; ++c)
          p[k * cn + c] = static_cast<float>(inside ? s[c] : border[c]);
      }
      T* d = dst + (y * dw + x) * cn;
      for (int64_t c = 0; c < cn; ++c) {
        const float p00 = p[c], p01 = p[cn + c];
        const float p10 = p[2 * cn + c], p11 = p[3 * cn + c];
        const float v0 = std::fmaf(a, p01 - p00, p00);
        const float v1 = std::fmaf(a, p11 - p10, p10);
        d[c] = store_px(std::fmaf(b, v1 - v0, v0), d);
      }
    }
  }
}

}  // namespace

extern "C" {

void warp_affine_linear_u8(const uint8_t* src, int64_t h, int64_t w,
                           int64_t cn, uint8_t* dst, int64_t dh, int64_t dw,
                           const float* m, const uint8_t* border) {
  warp_linear(src, h, w, cn, dst, dh, dw, m, border);
}

void warp_affine_linear_u16(const uint16_t* src, int64_t h, int64_t w,
                            int64_t cn, uint16_t* dst, int64_t dh,
                            int64_t dw, const float* m,
                            const uint16_t* border) {
  warp_linear(src, h, w, cn, dst, dh, dw, m, border);
}

void warp_affine_linear_f32(const float* src, int64_t h, int64_t w,
                            int64_t cn, float* dst, int64_t dh, int64_t dw,
                            const float* m, const float* border) {
  warp_linear(src, h, w, cn, dst, dh, dw, m, border);
}

// cv2.warpAffine(INTER_NEAREST, BORDER_CONSTANT) of an (h, w) image of
// pixels of px bytes (any type and channel count) into (dh, dw); border:
// one pixel's px bytes.
void warp_affine_nearest(const uint8_t* src, int64_t h, int64_t w,
                         int64_t px, uint8_t* dst, int64_t dh, int64_t dw,
                         const float* m, const uint8_t* border) {
  const int64_t vec_end = warp_vec_end(dw);
  for (int64_t y = 0; y < dh; ++y) {
    for (int64_t x = 0; x < dw; ++x) {
      float fx, fy;
      warp_point(m, x, y, vec_end, &fx, &fy);
      const int64_t sx = std::lrintf(fx), sy = std::lrintf(fy);
      const bool inside = sy >= 0 && sy < h && sx >= 0 && sx < w;
      std::memcpy(dst + (y * dw + x) * px,
                  inside ? src + (sy * w + sx) * px : border, px);
    }
  }
}

// OpenCV's borderInterpolate for BORDER_REFLECT_101.
static int64_t reflect101(int64_t p, int64_t len) {
  if (len == 1) return 0;
  while (p < 0 || p >= len) p = p < 0 ? -p : 2 * (len - 1) - p;
  return p;
}

// cv::createCLAHE(clip, (gx, gy))->apply of an (h, w) uint8 plane.
void clahe_u8(const uint8_t* src, int64_t h, int64_t w, uint8_t* dst,
              double clip, int64_t gx, int64_t gy) {
  const bool divides = w % gx == 0 && h % gy == 0;
  const int64_t eh = divides ? h : h + gy - h % gy;
  const int64_t ew = divides ? w : w + gx - w % gx;
  const int64_t th = eh / gy, tw = ew / gx, area = th * tw;
  const float lut_scale = 255.0f / static_cast<float>(area);
  int clip_limit = 0;
  if (clip > 0.0) {
    clip_limit = static_cast<int>(clip * area / 256);
    if (clip_limit < 1) clip_limit = 1;
  }
  std::vector<int64_t> rows(eh), cols(ew);
  for (int64_t i = 0; i < eh; ++i) rows[i] = reflect101(i, h);
  for (int64_t i = 0; i < ew; ++i) cols[i] = reflect101(i, w);
  std::vector<uint8_t> lut(gx * gy * 256);
  for (int64_t t = 0; t < gx * gy; ++t) {
    const int64_t ty = t / gx, tx = t % gx;
    int hist[256] = {0};
    for (int64_t y = ty * th; y < (ty + 1) * th; ++y) {
      const uint8_t* s = src + rows[y] * w;
      for (int64_t x = tx * tw; x < (tx + 1) * tw; ++x) ++hist[s[cols[x]]];
    }
    if (clip_limit > 0) {
      int clipped = 0;
      for (int i = 0; i < 256; ++i) {
        if (hist[i] > clip_limit) {
          clipped += hist[i] - clip_limit;
          hist[i] = clip_limit;
        }
      }
      const int batch = clipped / 256;
      int residual = clipped - batch * 256;
      for (int i = 0; i < 256; ++i) hist[i] += batch;
      if (residual != 0) {
        const int step = 256 / residual > 1 ? 256 / residual : 1;
        for (int i = 0; i < 256 && residual > 0; i += step, --residual)
          ++hist[i];
      }
    }
    int sum = 0;
    uint8_t* l = lut.data() + t * 256;
    for (int i = 0; i < 256; ++i) {
      sum += hist[i];
      l[i] = saturate_u8(static_cast<float>(sum) * lut_scale);
    }
  }
  const float inv_th = 1.0f / static_cast<float>(th);
  const float inv_tw = 1.0f / static_cast<float>(tw);
  std::vector<int64_t> ind1(w), ind2(w);
  std::vector<float> xa(w), xa1(w);
  for (int64_t x = 0; x < w; ++x) {
    const float txf = static_cast<float>(x) * inv_tw - 0.5f;
    int64_t tx1 = static_cast<int64_t>(std::floor(txf));
    int64_t tx2 = tx1 + 1;
    xa[x] = txf - static_cast<float>(tx1);
    xa1[x] = 1.0f - xa[x];
    tx1 = tx1 > 0 ? tx1 : 0;
    tx2 = tx2 < gx - 1 ? tx2 : gx - 1;
    ind1[x] = tx1 * 256;
    ind2[x] = tx2 * 256;
  }
  for (int64_t y = 0; y < h; ++y) {
    const float tyf = static_cast<float>(y) * inv_th - 0.5f;
    int64_t ty1 = static_cast<int64_t>(std::floor(tyf));
    int64_t ty2 = ty1 + 1;
    const float ya = tyf - static_cast<float>(ty1), ya1 = 1.0f - ya;
    ty1 = ty1 > 0 ? ty1 : 0;
    ty2 = ty2 < gy - 1 ? ty2 : gy - 1;
    const uint8_t* l1 = lut.data() + ty1 * gx * 256;
    const uint8_t* l2 = lut.data() + ty2 * gx * 256;
    const uint8_t* s = src + y * w;
    uint8_t* d = dst + y * w;
    for (int64_t x = 0; x < w; ++x) {
      const int v = s[x];
      const float r = (l1[ind1[x] + v] * xa1[x] + l1[ind2[x] + v] * xa[x]) *
                          ya1 +
                      (l2[ind1[x] + v] * xa1[x] + l2[ind2[x] + v] * xa[x]) *
                          ya;
      d[x] = saturate_u8(r);
    }
  }
}

// TIFF LZW: decode the n bytes of src into dst (capacity cap). Returns the
// number of bytes written (a strip may end without its EOI code, as
// libtiff allows), or -1 on a code that is not in the table.
int64_t tiff_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap) {
  std::vector<int32_t> prefix(4096), length(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int next = 258, width = 9, old = -1;
  uint64_t bits = 0;
  int nbits = 0;
  int64_t pos = 0, out = 0;
  auto emit = [&](int code) {
    int64_t len = length[code];
    int64_t end = out + len;
    for (int c = code; c >= 0; c = prefix[c]) {
      --end;
      if (end < cap) dst[end] = suffix[c];
    }
    out += len;
  };
  for (;;) {
    while (nbits < width) {
      if (pos >= n) return out < cap ? out : cap;
      bits = (bits << 8) | src[pos++];
      nbits += 8;
    }
    int code = static_cast<int>((bits >> (nbits - width)) &
                                ((1u << width) - 1));
    nbits -= width;
    if (code == 257) break;
    if (code == 256) {
      next = 258;
      width = 9;
      old = -1;
      continue;
    }
    if (old < 0) {
      if (code > 255) return -1;
      emit(code);
      old = code;
      continue;
    }
    uint8_t head;
    if (code < next) {
      emit(code);
      head = first[code];
    } else if (code == next) {
      emit(old);
      head = first[old];
      if (out < cap) dst[out] = head;
      ++out;
    } else {
      return -1;
    }
    if (next < 4096) {
      prefix[next] = old;
      suffix[next] = head;
      first[next] = first[old];
      length[next] = length[old] + 1;
      ++next;
      if (next >= (1 << width) - 1 && width < 12) ++width;
    }
    old = code;
  }
  return out < cap ? out : cap;
}

// TIFF LZW: encode the n bytes of src into dst (capacity cap, at least
// n * 3 / 2 + 16). Returns the number of bytes written.
int64_t tiff_lzw_encode(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap) {
  std::vector<int16_t> child(4096 * 256, -1);
  uint64_t bits = 0;
  int nbits = 0, width = 9, next = 258;
  int64_t out = 0;
  auto put = [&](int code) {
    bits = (bits << width) | static_cast<uint64_t>(code);
    nbits += width;
    while (nbits >= 8) {
      if (out < cap) dst[out] = static_cast<uint8_t>(bits >> (nbits - 8));
      ++out;
      nbits -= 8;
    }
  };
  // after a code goes out its entry is added: the width grows once the
  // next free code no longer fits, and a full table is cleared
  auto added = [&]() {
    ++next;
    if (next == 4094) {
      put(256);
      std::fill(child.begin(), child.end(), -1);
      next = 258;
      width = 9;
    } else if (next > (1 << width) - 1) {
      ++width;
    }
  };
  put(256);
  if (n > 0) {
    int w = src[0];
    for (int64_t i = 1; i < n; ++i) {
      int c = src[i];
      int16_t k = child[w * 256 + c];
      if (k >= 0) {
        w = k;
        continue;
      }
      put(w);
      child[w * 256 + c] = static_cast<int16_t>(next);
      added();
      w = c;
    }
    put(w);
    added();
  }
  put(257);
  if (nbits > 0) {
    if (out < cap) dst[out] = static_cast<uint8_t>(bits << (8 - nbits));
    ++out;
  }
  return out;
}

// PackBits (TIFF compression 32773): decode n bytes of src into dst
// (capacity cap); returns the number of bytes written.
int64_t packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap) {
  int64_t pos = 0, out = 0;
  while (pos < n && out < cap) {
    int h = static_cast<int8_t>(src[pos++]);
    if (h >= 0) {
      int64_t len = h + 1;
      if (len > n - pos) len = n - pos;
      if (len > cap - out) len = cap - out;
      std::memcpy(dst + out, src + pos, len);
      out += len;
      pos += h + 1;
    } else if (h != -128) {
      if (pos >= n) break;
      int64_t len = 1 - h;
      if (len > cap - out) len = cap - out;
      std::memset(dst + out, src[pos++], len);
      out += len;
    }
  }
  return out;
}

}  // extern "C"
