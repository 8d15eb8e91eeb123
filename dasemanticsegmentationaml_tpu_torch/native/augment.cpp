// Native host-side augmentation ops (the --host_augment hot path).
//
// A copy of dasemanticsegmentationaml_tpu/native/augment.cpp, the source
// of the dseg_aug_* entry points of the JAX package's libdsegloader.so,
// built on its own (it needs neither loader.cpp nor the image libraries).
// One change: the hue tables fill sqlut[uv][maxc] only where uv <= maxc
// (the pairs a pixel can reach; the rest are 0), so no out-of-range
// double is cast to uint8. The entries it changes are never read, so the
// output is bit-identical to the original's.
//
// Bit-exact C++ ports of data/augment_pil_exact.py, which is itself a
// bit-exact numpy reimplementation of torchvision-on-Pillow (reference
// dataset/GTAV.py:32-59). Every float expression reproduces the numpy
// op sequence exactly: float32 blend arithmetic (no FMA -- built with
// -ffp-contract=off), double homography/bilinear math, rint() for
// numpy's half-even np.round, trunc stores.
// tests/test_torch_host_augment.py pins native == numpy and this copy ==
// the original, entry point by entry point.
//
// Called per sample from the Loader's decode threads via ctypes (GIL
// released).
//
// Build: data/native_augment.py compiles it with g++ at first use into
// build/native/, keyed by a hash of this source and the flags.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// Pillow convert("L"): (19595 R + 38470 G + 7471 B + 0x8000) >> 16
inline int luma_int(int r, int g, int b) {
  return (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16;
}

// Image.blend semantics on one uint8 value: float32 d + f*(v - d),
// clipped to [0, 255], TRUNCATED (Pillow Blend.c casts; numpy twin
// augment_pil_exact._blend).
inline uint8_t blend1(float d, float f, uint8_t v) {
  float t = d + f * (static_cast<float>(v) - d);
  if (t >= 255.0f) return 255;
  if (t <= 0.0f) return 0;
  return static_cast<uint8_t>(truncf(t));
}

inline long clampl(long v, long lo, long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// mode: 0 brightness (blend vs black), 1 contrast (blend vs the
// integer-rounded mean of the L plane), 2 saturation (blend vs the
// per-pixel L plane). src/dst: HWC uint8 RGB, may NOT alias.
int dseg_aug_blend(const uint8_t* src, uint8_t* dst, int h, int w,
                   int mode, float factor) {
  if (!src || !dst || h <= 0 || w <= 0) return -1;
  const long n = static_cast<long>(h) * w;
  if (mode == 0) {
    for (long i = 0; i < n * 3; ++i) dst[i] = blend1(0.0f, factor, src[i]);
    return 0;
  }
  if (mode == 1) {
    // ImageStat int(mean+0.5) in exact integers: (2s+n)//(2n)
    int64_t s = 0;
    for (long i = 0; i < n; ++i) {
      const uint8_t* p = src + i * 3;
      s += luma_int(p[0], p[1], p[2]);
    }
    const float mean = static_cast<float>((2 * s + n) / (2 * n));
    for (long i = 0; i < n * 3; ++i) dst[i] = blend1(mean, factor, src[i]);
    return 0;
  }
  if (mode == 2) {
    for (long i = 0; i < n; ++i) {
      const uint8_t* p = src + i * 3;
      const float d = static_cast<float>(luma_int(p[0], p[1], p[2]));
      uint8_t* o = dst + i * 3;
      o[0] = blend1(d, factor, p[0]);
      o[1] = blend1(d, factor, p[1]);
      o[2] = blend1(d, factor, p[2]);
    }
    return 0;
  }
  return -2;
}

// torchvision Grayscale(3): convert("L") replicated to 3 channels.
int dseg_aug_gray3(const uint8_t* src, uint8_t* dst, int h, int w) {
  if (!src || !dst || h <= 0 || w <= 0) return -1;
  const long n = static_cast<long>(h) * w;
  for (long i = 0; i < n; ++i) {
    const uint8_t* p = src + i * 3;
    const uint8_t l = static_cast<uint8_t>(luma_int(p[0], p[1], p[2]));
    uint8_t* o = dst + i * 3;
    o[0] = l; o[1] = l; o[2] = l;
  }
  return 0;
}

// torchvision adjust_hue on PIL: Convert.c rgb2hsv (float32 with the
// exact float64 promotion points), uint8 wraparound shift of the H
// plane, Convert.c hsv2rgb (np.round == rint half-even). Ported
// expression-for-expression from augment_pil_exact.{rgb2hsv,hsv2rgb}.
int dseg_aug_hue(const uint8_t* src, uint8_t* dst, int h, int w,
                 int shift_u8) {
  if (!src || !dst || h <= 0 || w <= 0) return -1;
  const long n = static_cast<long>(h) * w;
  // Per-h2 tables (h2 in [0,255]): sector and fractional part of
  // x = h2*6/255. Values are EXACTLY what the scalar expressions below
  // used to compute per pixel (same ops, hoisted); C++11 static-local
  // init is thread-safe for the Loader's worker threads.
  struct HueTabs {
    int sector[256];
    float f[256];
    double fs[256];  // (double)((float)sq / 255.0f), indexed by sq
    // qlut[uv][num] = (float)num / (float)uv — the rc/gc/bc divides
    // precomputed (num = maxc - channel <= uv, so num <= uv suffices,
    // but the full square keeps indexing branch-free). 256 KB.
    float qlut[256][256];
    // sqlut[uv][maxc] = trunc((double)((float)uv / (float)maxc) * 255)
    // — the saturation quantization, for uv <= maxc (0 elsewhere), 64 KB.
    uint8_t sqlut[256][256];
    HueTabs() {
      for (int h2 = 0; h2 < 256; ++h2) {
        const double x = static_cast<double>(h2) * 6.0 / 255.0;
        sector[h2] = static_cast<int>(floor(x));
        f[h2] = static_cast<float>(x - static_cast<double>(sector[h2]));
      }
      for (int sq = 0; sq < 256; ++sq)
        fs[sq] = static_cast<double>(static_cast<float>(sq) / 255.0f);
      for (int uv = 0; uv < 256; ++uv) {
        for (int num = 0; num < 256; ++num)
          qlut[uv][num] = uv ? static_cast<float>(num) /
                                   static_cast<float>(uv)
                             : 0.0f;
        for (int maxc = 1; maxc < 256; ++maxc) {
          const float s32 =
              static_cast<float>(uv) / static_cast<float>(maxc);
          // uv > maxc is unreachable, and its quotient would leave
          // uint8's range
          sqlut[uv][maxc] = uv <= maxc ? static_cast<uint8_t>(
              trunc(static_cast<double>(s32) * 255.0)) : 0;
        }
        sqlut[uv][0] = 0;  // unreachable (uv > 0 implies maxc > 0)
      }
    }
  };
  static const HueTabs T;
  for (long i = 0; i < n; ++i) {
    const uint8_t* p = src + i * 3;
    uint8_t* o = dst + i * 3;
    const int r = p[0], g = p[1], b = p[2];
    const int maxc = std::max(r, std::max(g, b));
    const int minc = std::min(r, std::min(g, b));
    const int uv = maxc - minc;
    if (uv == 0) {
      // gray pixel: H=S=0, hue shift is a no-op, hsv2rgb returns (v,v,v)
      const uint8_t v = static_cast<uint8_t>(maxc);
      o[0] = v; o[1] = v; o[2] = v;
      continue;
    }
    // ---- rgb2hsv (quantized planes, divides via the exact LUTs) ----
    const float* qrow = T.qlut[uv];
    const float rc = qrow[maxc - r];
    const float gc = qrow[maxc - g];
    const float bc = qrow[maxc - b];
    double h64;
    if (maxc == r) {
      h64 = static_cast<double>(bc) - static_cast<double>(gc);
    } else if (maxc == g) {
      h64 = 2.0 + static_cast<double>(rc) - static_cast<double>(bc);
    } else {
      h64 = 4.0 + static_cast<double>(gc) - static_cast<double>(rc);
    }
    const float hf = static_cast<float>(h64);
    // fmod(y, 1.0) with y = hf/6 + 1 in [0, 2): h64 in [-1, 5] exactly
    // (each of rc/gc/bc is in [0, 1]), so the branch below computes the
    // SAME bits as fmod — y - 1 is Sterbenz-exact for y in [1, 2)
    const double y = static_cast<double>(hf) / 6.0 + 1.0;
    const double hmod64 = y >= 1.0 ? y - 1.0 : y;
    const float hmod = static_cast<float>(hmod64);
    const int hq =
        static_cast<int>(trunc(static_cast<double>(hmod) * 255.0));
    const int sq = T.sqlut[uv][maxc];
    // ---- H-plane uint8 wraparound shift ----
    const int h2 = (hq + shift_u8) & 0xFF;
    // ---- hsv2rgb ----
    if (sq == 0) {
      const uint8_t v = static_cast<uint8_t>(maxc);
      o[0] = v; o[1] = v; o[2] = v;
      continue;
    }
    const int sector = T.sector[h2];
    const double f64 = static_cast<double>(T.f[h2]);
    const double fs64 = T.fs[sq];
    const double vf = static_cast<double>(maxc);
    // np.round is half-even == rint under the default rounding mode.
    // No clamps needed: fs, f in [0, 1] so each factor is in [0, 1]
    // and vf*factor in [0, 255] — rint can't leave [0, 255].
    const double pd = rint(vf * (1.0 - fs64));
    const double qd = rint(vf * (1.0 - fs64 * f64));
    const double td = rint(vf * (1.0 - fs64 * (1.0 - f64)));
    const uint8_t P = static_cast<uint8_t>(pd);
    const uint8_t Q = static_cast<uint8_t>(qd);
    const uint8_t T8 = static_cast<uint8_t>(td);
    const uint8_t V = static_cast<uint8_t>(maxc);
    switch (sector % 6) {
      case 0: o[0] = V; o[1] = T8; o[2] = P; break;
      case 1: o[0] = Q; o[1] = V; o[2] = P; break;
      case 2: o[0] = P; o[1] = V; o[2] = T8; break;
      case 3: o[0] = P; o[1] = Q; o[2] = V; break;
      case 4: o[0] = T8; o[1] = P; o[2] = V; break;
      default: o[0] = V; o[1] = P; o[2] = Q; break;
    }
  }
  return 0;
}

// Image.transform(size, PERSPECTIVE, coeffs, BILINEAR, fillcolor):
// per-output-pixel double homography at +0.5 centers, -0.5 shift,
// HALF-OPEN oob ([-0.5, size-0.5)), edge-clamped double bilinear,
// truncated uint8 store (augment_pil_exact.perspective_bilinear).
// ch: 1 or 3. src/dst must not alias.
int dseg_aug_perspective_bilinear(const uint8_t* src, uint8_t* dst,
                                  int h, int w, int ch,
                                  const double* coeffs, int fill) {
  if (!src || !dst || !coeffs || h <= 0 || w <= 0) return -1;
  if (ch != 1 && ch != 3) return -2;
  const double a = coeffs[0], b = coeffs[1], c = coeffs[2];
  const double d = coeffs[3], e = coeffs[4], f = coeffs[5];
  const double gg = coeffs[6], hh = coeffs[7];
  const uint8_t fillv = static_cast<uint8_t>(fill);
  for (int y = 0; y < h; ++y) {
    const double yy = static_cast<double>(y) + 0.5;
    uint8_t* orow = dst + static_cast<long>(y) * w * ch;
    for (int x = 0; x < w; ++x) {
      const double xx = static_cast<double>(x) + 0.5;
      const double den = gg * xx + hh * yy + 1.0;
      const double sx = (a * xx + b * yy + c) / den - 0.5;
      const double sy = (d * xx + e * yy + f) / den - 0.5;
      uint8_t* o = orow + static_cast<long>(x) * ch;
      if (sx < -0.5 || sx >= w - 0.5 || sy < -0.5 || sy >= h - 0.5) {
        for (int k = 0; k < ch; ++k) o[k] = fillv;
        continue;
      }
      const double x0 = floor(sx);
      const double y0 = floor(sy);
      const double wx = sx - x0;
      const double wy = sy - y0;
      const long x0l = static_cast<long>(x0);
      const long y0l = static_cast<long>(y0);
      const long x0i = clampl(x0l, 0, w - 1);
      const long x1i = clampl(x0l + 1, 0, w - 1);
      const long y0i = clampl(y0l, 0, h - 1);
      const long y1i = clampl(y0l + 1, 0, h - 1);
      const uint8_t* r0 = src + (y0i * w) * ch;
      const uint8_t* r1 = src + (y1i * w) * ch;
      for (int k = 0; k < ch; ++k) {
        const double A = static_cast<double>(r0[x0i * ch + k]);
        const double B = static_cast<double>(r0[x1i * ch + k]);
        const double C = static_cast<double>(r1[x0i * ch + k]);
        const double D = static_cast<double>(r1[x1i * ch + k]);
        const double top = A * (1.0 - wx) + B * wx;
        const double bot = C * (1.0 - wx) + D * wx;
        double v = top * (1.0 - wy) + bot * wy;
        v = trunc(v);
        if (v < 0.0) v = 0.0;
        if (v > 255.0) v = 255.0;
        o[k] = static_cast<uint8_t>(v);
      }
    }
  }
  return 0;
}

// NEAREST perspective warp of an HW label map on the SAME double grid:
// index = floor(s + 0.5), shared half-open oob, ignore-fill
// (host_augment.warp_nearest_label).
int dseg_aug_perspective_nearest(const uint8_t* src, uint8_t* dst,
                                 int h, int w, const double* coeffs,
                                 int fill) {
  if (!src || !dst || !coeffs || h <= 0 || w <= 0) return -1;
  const double a = coeffs[0], b = coeffs[1], c = coeffs[2];
  const double d = coeffs[3], e = coeffs[4], f = coeffs[5];
  const double gg = coeffs[6], hh = coeffs[7];
  const uint8_t fillv = static_cast<uint8_t>(fill);
  for (int y = 0; y < h; ++y) {
    const double yy = static_cast<double>(y) + 0.5;
    uint8_t* orow = dst + static_cast<long>(y) * w;
    for (int x = 0; x < w; ++x) {
      const double xx = static_cast<double>(x) + 0.5;
      const double den = gg * xx + hh * yy + 1.0;
      const double sx = (a * xx + b * yy + c) / den - 0.5;
      const double sy = (d * xx + e * yy + f) / den - 0.5;
      if (sx < -0.5 || sx >= w - 0.5 || sy < -0.5 || sy >= h - 0.5) {
        orow[x] = fillv;
        continue;
      }
      const long xi = clampl(static_cast<long>(floor(sx + 0.5)), 0, w - 1);
      const long yi = clampl(static_cast<long>(floor(sy + 0.5)), 0, h - 1);
      orow[x] = src[yi * w + xi];
    }
  }
  return 0;
}

// Fused CS-HF color path: contrast blend (vs the integer-rounded L
// mean of SRC), then saturation blend (vs the L plane of the contrast
// RESULT), then the horizontal flip — one read of src, one mirrored
// write of dst, no intermediate images. Bit-identical to the three-op
// sequence adjust_contrast -> adjust_saturation -> hflip
// (augment_pil_exact.apply_family CS-HF): the per-pixel dataflow is
// unchanged, only the memory round-trips between ops are removed.
// src/dst: HWC uint8 RGB, may NOT alias.
int dseg_aug_cs_hf_fused(const uint8_t* src, uint8_t* dst, int h, int w,
                         float contrast, float saturation) {
  if (!src || !dst || h <= 0 || w <= 0) return -1;
  const long n = static_cast<long>(h) * w;
  int64_t s = 0;
  for (long i = 0; i < n; ++i) {
    const uint8_t* p = src + i * 3;
    s += luma_int(p[0], p[1], p[2]);
  }
  const float mean = static_cast<float>((2 * s + n) / (2 * n));
  for (int y = 0; y < h; ++y) {
    const uint8_t* irow = src + static_cast<long>(y) * w * 3;
    uint8_t* orow = dst + static_cast<long>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      const uint8_t* p = irow + static_cast<long>(x) * 3;
      const uint8_t c0 = blend1(mean, contrast, p[0]);
      const uint8_t c1 = blend1(mean, contrast, p[1]);
      const uint8_t c2 = blend1(mean, contrast, p[2]);
      const float d = static_cast<float>(luma_int(c0, c1, c2));
      uint8_t* o = orow + static_cast<long>(w - 1 - x) * 3;
      o[0] = blend1(d, saturation, c0);
      o[1] = blend1(d, saturation, c1);
      o[2] = blend1(d, saturation, c2);
    }
  }
  return 0;
}

// Fused B-GS-R color path: brightness blend then Grayscale(3) luma in
// one traversal, emitting the SINGLE gray plane (the three output
// channels of to_grayscale3 are identical, so the caller rotates this
// 1-channel plane — 1/3 the rotate traffic — and replicates after;
// nearest rotation is a pixel permutation with fill 0 -> 0, so
// rotate(replicate) == replicate(rotate) exactly).
int dseg_aug_bright_gray1(const uint8_t* src, uint8_t* dst, int h, int w,
                          float factor) {
  if (!src || !dst || h <= 0 || w <= 0) return -1;
  const long n = static_cast<long>(h) * w;
  for (long i = 0; i < n; ++i) {
    const uint8_t* p = src + i * 3;
    const uint8_t b0 = blend1(0.0f, factor, p[0]);
    const uint8_t b1 = blend1(0.0f, factor, p[1]);
    const uint8_t b2 = blend1(0.0f, factor, p[2]);
    dst[i] = static_cast<uint8_t>(luma_int(b0, b1, b2));
  }
  return 0;
}

// Rotate a 1-channel gray plane and replicate to 3 output channels in
// the same pass (the B-GS-R tail: to_grayscale3's channels are
// identical, so rotate-then-replicate == replicate-then-rotate with
// fill 0 -> (0,0,0)). Same 16.16 fixed-point walk as
// dseg_aug_affine_nearest_fixed.
int dseg_aug_rotate_gray_rep3(const uint8_t* src, uint8_t* dst, int h,
                              int w, int64_t xin0, int64_t yin0,
                              int64_t dxx, int64_t dyy, int64_t dxr,
                              int64_t dyr, int fill) {
  if (!src || !dst || h <= 0 || w <= 0) return -1;
  const uint8_t fillv = static_cast<uint8_t>(fill);
  for (int y = 0; y < h; ++y) {
    int64_t xacc = xin0 + static_cast<int64_t>(y) * dxr;
    int64_t yacc = yin0 + static_cast<int64_t>(y) * dyr;
    uint8_t* orow = dst + static_cast<long>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      const int64_t xin = (xacc + static_cast<int64_t>(x) * dxx) >> 16;
      const int64_t yin = (yacc + static_cast<int64_t>(x) * dyy) >> 16;
      const uint8_t v = (xin < 0 || xin >= w || yin < 0 || yin >= h)
                            ? fillv
                            : src[yin * w + xin];
      uint8_t* o = orow + static_cast<long>(x) * 3;
      o[0] = v; o[1] = v; o[2] = v;
    }
  }
  return 0;
}

// Image.rotate(angle, NEAREST, expand=False, fillcolor): Geometry.c's
// 16.16 fixed-point integer fast path. The six fixed-point start/step
// values come from Python (augment_pil_exact.rotate_fixed_point_starts
// — exact Python-int math), so this loop is pure int64 arithmetic,
// identical to both Pillow and the numpy twin. ch: 1 (labels) or 3.
int dseg_aug_affine_nearest_fixed(const uint8_t* src, uint8_t* dst,
                                  int h, int w, int ch,
                                  int64_t xin0, int64_t yin0,
                                  int64_t dxx, int64_t dyy,
                                  int64_t dxr, int64_t dyr, int fill) {
  if (!src || !dst || h <= 0 || w <= 0) return -1;
  if (ch != 1 && ch != 3) return -2;
  const uint8_t fillv = static_cast<uint8_t>(fill);
  for (int y = 0; y < h; ++y) {
    int64_t xacc = xin0 + static_cast<int64_t>(y) * dxr;
    int64_t yacc = yin0 + static_cast<int64_t>(y) * dyr;
    uint8_t* orow = dst + static_cast<long>(y) * w * ch;
    for (int x = 0; x < w; ++x) {
      const int64_t xin = (xacc + static_cast<int64_t>(x) * dxx) >> 16;
      const int64_t yin = (yacc + static_cast<int64_t>(x) * dyy) >> 16;
      uint8_t* o = orow + static_cast<long>(x) * ch;
      if (xin < 0 || xin >= w || yin < 0 || yin >= h) {
        for (int k = 0; k < ch; ++k) o[k] = fillv;
      } else {
        const uint8_t* p = src + (yin * w + xin) * ch;
        for (int k = 0; k < ch; ++k) o[k] = p[k];
      }
    }
  }
  return 0;
}

}  // extern "C"
