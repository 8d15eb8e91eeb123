// Native host-side image decode + resize for the input pipeline.
//
// A copy of dasemanticsegmentationaml_tpu/native/loader.cpp, the source
// of the dseg_image_size / dseg_decode_resize entry points of the JAX
// package's libdsegloader.so, built on its own (without augment.cpp).
// The code below the includes is the original's, unchanged;
// tests/test_torch_native_loader.py holds this copy's two entry points
// bit-identical to a build of the original on every image kind the
// pipeline meets (RGB, gray, palettised and RGBA PNGs, JPEG, a corrupt
// and a truncated JPEG, a PNG whose header claims 500000x500000).
//
// libpng/libjpeg decode + a Pillow-exact separable triangle-filter
// (BILINEAR, antialiased) resize for images and Pillow's NEAREST for
// label maps (the reference's DataLoader-worker PIL decode, reference
// cityscapes.py:61-69, GTAV.py:81-90). Called per sample from the
// Loader's decode threads via ctypes.CDLL, which releases the GIL for
// the call, so the threads decode in parallel.
//
// Build: data/native.py compiles it with g++ at first use into
// build/native/ (-lpng -ljpeg -lz), named by a hash of this source, the
// flags and the machine; when that fails, decode stays on PIL and the
// CLI says why.

#include <png.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
#include <jpeglib.h>
}

namespace {

bool ends_with(const std::string& s, const std::string& suffix) {
  if (s.size() < suffix.size()) return false;
  std::string tail = s.substr(s.size() - suffix.size());
  std::transform(tail.begin(), tail.end(), tail.begin(), ::tolower);
  return tail == suffix;
}

// Cap on decoded pixels: a corrupt/hostile header claiming huge
// dimensions must fall back to PIL (which raises a catchable Python
// error) instead of throwing bad_alloc across the extern "C" boundary
// (std::terminate -> the whole training process dies on one bad file).
constexpr size_t kMaxPixels = 512ull * 1024 * 1024;  // 0.5 gigapixel

// Label-map (gray) PNG decode via the full libpng API. The simplified
// png_image API with PNG_FORMAT_GRAY expands palettized PNGs to RGB and
// luma-converts them -- but for 'P'-mode label maps (GTA5 labels,
// reference GTAV.py:88) the pixel VALUE is the class id, so the palette
// indices themselves must be returned, exactly as PIL does for mode 'P'
// (transforms_host.load_label keeps L/P/I modes unconverted). Anything
// that is not 8-bit-indexable gray/palette data falls back to PIL.
bool decode_png_gray(const char* path, std::vector<uint8_t>& out,
                     int& w, int& h, int& channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                             nullptr);
  if (!png) {
    std::fclose(f);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(f);
    return false;
  }
  // constructed BEFORE setjmp: a longjmp from png_read_image would
  // otherwise jump back over the live vector (formally UB, practically
  // a heap leak per corrupt file); declared here its destructor runs on
  // the normal return from the setjmp branch
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {  // libpng fatal error -> clean failure
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  int color_type = png_get_color_type(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  bool indexed = (color_type == PNG_COLOR_TYPE_PALETTE);
  bool gray8 = (color_type == PNG_COLOR_TYPE_GRAY && bit_depth <= 8);
  if (!indexed && !gray8) {
    // RGB/alpha/16-bit labels: defer to the PIL path (its conversion
    // rules are the parity contract).
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    return false;
  }
  if (bit_depth < 8) {
    // expand 1/2/4-bit values to one byte each WITHOUT scaling:
    // palette indices stay indices, gray values stay raw (PIL's 'P';
    // sub-8-bit non-palette gray is not a label format we serve).
    if (indexed) {
      png_set_packing(png);
    } else {
      png_destroy_read_struct(&png, &info, nullptr);
      std::fclose(f);
      return false;
    }
  }
  png_set_interlace_handling(png);
  png_read_update_info(png, info);
  w = static_cast<int>(png_get_image_width(png, info));
  h = static_cast<int>(png_get_image_height(png, info));
  channels = 1;
  if (png_get_rowbytes(png, info) != static_cast<size_t>(w)) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    return false;
  }
  if (static_cast<size_t>(w) * h > kMaxPixels) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    return false;
  }
  out.resize(static_cast<size_t>(w) * h);
  rows.resize(h);
  for (int y = 0; y < h; y++)
    rows[y] = out.data() + static_cast<size_t>(y) * w;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(f);
  return true;
}

bool decode_png(const char* path, bool gray, std::vector<uint8_t>& out,
                int& w, int& h, int& channels) {
  if (gray) return decode_png_gray(path, out, w, h, channels);
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return false;
  if (image.format & (PNG_FORMAT_FLAG_ALPHA | PNG_FORMAT_FLAG_LINEAR)) {
    // alpha (incl. palette tRNS) or 16-bit: libpng would alpha-composite
    // / downconvert, which DIFFERS from the PIL fallback's
    // convert("RGB") (drops alpha). PIL's conversion rules are the
    // parity contract — defer.
    png_image_free(&image);
    return false;
  }
  if (static_cast<size_t>(image.width) * image.height > kMaxPixels) {
    png_image_free(&image);
    return false;
  }
  image.format = PNG_FORMAT_RGB;
  w = static_cast<int>(image.width);
  h = static_cast<int>(image.height);
  channels = 3;
  out.resize(static_cast<size_t>(w) * h * channels);
  if (!png_image_finish_read(&image, nullptr, out.data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  return true;
}

// libjpeg's default error_exit calls exit(): one corrupt .jpg would
// take down the whole training process. Standard setjmp override so a
// fatal decode error returns false (-> PIL fallback) instead.
struct JpegErrorJmp {
  jpeg_error_mgr pub;
  std::jmp_buf jump;
};

void jpeg_error_longjmp(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<JpegErrorJmp*>(cinfo->err)->jump, 1);
}

bool decode_jpeg(const char* path, bool gray, std::vector<uint8_t>& out,
                 int& w, int& h, int& channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorJmp jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_longjmp;
  if (setjmp(jerr.jump)) {  // fatal libjpeg error mid-decode
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  channels = cinfo.output_components;
  if (static_cast<size_t>(w) * h > kMaxPixels) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  out.resize(static_cast<size_t>(w) * h * channels);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.data() +
                   static_cast<size_t>(cinfo.output_scanline) * w * channels;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

bool decode(const char* path, bool gray, std::vector<uint8_t>& data, int& w,
            int& h, int& channels) {
  std::string p(path);
  if (ends_with(p, ".png")) return decode_png(path, gray, data, w, h,
                                              channels);
  if (ends_with(p, ".jpg") || ends_with(p, ".jpeg"))
    return decode_jpeg(path, gray, data, w, h, channels);
  return false;
}

// PIL-style precomputed triangle-filter coefficients for one axis.
// (PIL Resample.c precompute_coeffs with the BILINEAR filter: support 1.0
// scaled by max(1, in/out) => proper antialiasing on downscale.)
struct AxisCoeffs {
  std::vector<int> bounds_lo;  // first source index per output pixel
  std::vector<int> counts;     // number of taps
  std::vector<double> weights;  // taps, row-major [out, kmax]; double all
                                // the way to the fixed-point scaling, or
                                // the 22-bit int coefficients lose a ulp
  int kmax = 0;
};

AxisCoeffs triangle_coeffs(int in_size, int out_size) {
  AxisCoeffs c;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 1.0 * filterscale;  // BILINEAR support = 1.0
  c.kmax = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds_lo.resize(out_size);
  c.counts.resize(out_size);
  c.weights.assign(static_cast<size_t>(out_size) * c.kmax, 0.0);
  for (int i = 0; i < out_size; i++) {
    double center = (i + 0.5) * scale;
    int lo = static_cast<int>(std::max(center - support + 0.5, 0.0));
    int hi = static_cast<int>(
        std::min(center + support + 0.5, static_cast<double>(in_size)));
    int n = hi - lo;
    double total = 0.0;
    std::vector<double> ww(n);
    for (int k = 0; k < n; k++) {
      double x = (lo + k - center + 0.5) / filterscale;
      double wgt = (x < 0 ? 1.0 + x : 1.0 - x);
      if (wgt < 0) wgt = 0;
      ww[k] = wgt;
      total += wgt;
    }
    if (total == 0.0) total = 1.0;
    c.bounds_lo[i] = lo;
    c.counts[i] = n;
    for (int k = 0; k < n; k++) {
      c.weights[static_cast<size_t>(i) * c.kmax + k] =
          ww[k] / total;
    }
  }
  return c;
}

// Pillow Resample.c fixed-point parameters (8-bit path): coefficients
// are rounded to ints scaled by 1 << PRECISION_BITS and accumulated in
// int32 with a pre-added 0.5 ulp; each pass emits uint8. Reproducing
// this EXACTLY (incl. the uint8 quantization between the horizontal and
// vertical passes) makes the native loader bit-equal to PIL.Image.resize
// -- the reference's actual data path (reference cityscapes.py:65-66).
constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int32_t ss) {
  ss >>= kPrecisionBits;
  if (ss < 0) return 0;
  if (ss > 255) return 255;
  return static_cast<uint8_t>(ss);
}

// Round the normalized double taps to Pillow's int coefficients.
std::vector<int32_t> int_coeffs(const AxisCoeffs& c, int out_size) {
  std::vector<int32_t> kk(static_cast<size_t>(out_size) * c.kmax, 0);
  for (size_t i = 0; i < kk.size(); i++) {
    double w = c.weights[i] * (1 << kPrecisionBits);
    kk[i] = static_cast<int32_t>(w < 0 ? w - 0.5 : w + 0.5);
  }
  return kk;
}

// Separable bilinear (triangle) resize, uint8 HWC -- Pillow-exact.
//
// Two fixed-point passes with a uint8 intermediate, like Pillow's
// ImagingResampleHorizontal_8bpc / Vertical_8bpc: horizontal first on
// the full-height input, quantize to uint8, then vertical. Identity
// axes (in == out, e.g. the height axis of the faithful 2048x1024 ->
// 512x1024 Cityscapes path) skip their pass exactly as Pillow does
// (the need_horizontal/need_vertical checks in ImagingResample).
// Verified bit-equal to PIL.Image.resize(BILINEAR) in
// tests/test_native.py.
void resize_bilinear(const uint8_t* src, int in_w, int in_h, int ch,
                     uint8_t* dst, int out_w, int out_h) {
  const bool need_x = (in_w != out_w);
  const bool need_y = (in_h != out_h);
  const uint8_t* cur = src;
  std::vector<uint8_t> tmp;

  if (need_x) {
    AxisCoeffs cx = triangle_coeffs(in_w, out_w);
    std::vector<int32_t> kk = int_coeffs(cx, out_w);
    uint8_t* out;
    if (need_y) {
      tmp.resize(static_cast<size_t>(in_h) * out_w * ch);
      out = tmp.data();
    } else {
      out = dst;
    }
    for (int y = 0; y < in_h; y++) {
      const uint8_t* row = cur + static_cast<size_t>(y) * in_w * ch;
      uint8_t* orow = out + static_cast<size_t>(y) * out_w * ch;
      for (int x = 0; x < out_w; x++) {
        const int32_t* wv = &kk[static_cast<size_t>(x) * cx.kmax];
        const uint8_t* pv = row + static_cast<size_t>(cx.bounds_lo[x]) * ch;
        int n = cx.counts[x];
        for (int c = 0; c < ch; c++) {
          int32_t ss = 1 << (kPrecisionBits - 1);
          for (int k = 0; k < n; k++) ss += wv[k] * pv[k * ch + c];
          orow[x * ch + c] = clip8(ss);
        }
      }
    }
    cur = out;
  }

  if (need_y) {
    AxisCoeffs cy = triangle_coeffs(in_h, out_h);
    std::vector<int32_t> kk = int_coeffs(cy, out_h);
    const int row_elems = out_w * ch;
    for (int y = 0; y < out_h; y++) {
      const int32_t* wv = &kk[static_cast<size_t>(y) * cy.kmax];
      const uint8_t* base =
          cur + static_cast<size_t>(cy.bounds_lo[y]) * row_elems;
      int n = cy.counts[y];
      uint8_t* drow = dst + static_cast<size_t>(y) * row_elems;
      for (int x = 0; x < row_elems; x++) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        for (int k = 0; k < n; k++)
          ss += wv[k] * base[static_cast<size_t>(k) * row_elems + x];
        drow[x] = clip8(ss);
      }
    }
  } else if (!need_x) {
    std::memcpy(dst, src, static_cast<size_t>(in_w) * in_h * ch);
  }
}

// PIL NEAREST: Pillow computes source positions by CUMULATIVE double
// addition (xx = scale*0.5; per output pixel: idx = (int)xx; xx += scale
// — ImagingTransformAffine's double path), NOT by per-pixel (i+0.5)*scale
// multiplication. The accumulated rounding error is semantically
// load-bearing: e.g. 640->321 output column 160 has exact center 320.0,
// but the accumulated sum lands at 319.999... -> source index 319, while
// the multiplicative form gives 320. Labels are class ids, so a one-off
// here silently changes training data vs the PIL pipeline — pinned
// bit-exact vs Pillow in tests/test_native.py.
void resize_nearest(const uint8_t* src, int in_w, int in_h, int ch,
                    uint8_t* dst, int out_w, int out_h) {
  std::vector<int> xs(out_w), ys(out_h);
  double sx = static_cast<double>(in_w) / out_w;
  double sy = static_cast<double>(in_h) / out_h;
  double xx = sx * 0.5;
  for (int x = 0; x < out_w; x++, xx += sx)
    xs[x] = std::min(std::max(static_cast<int>(xx), 0), in_w - 1);
  double yy = sy * 0.5;
  for (int y = 0; y < out_h; y++, yy += sy)
    ys[y] = std::min(std::max(static_cast<int>(yy), 0), in_h - 1);
  for (int y = 0; y < out_h; y++) {
    const uint8_t* srow = src + static_cast<size_t>(ys[y]) * in_w * ch;
    uint8_t* drow = dst + static_cast<size_t>(y) * out_w * ch;
    for (int x = 0; x < out_w; x++) {
      std::memcpy(drow + x * ch, srow + xs[x] * ch, ch);
    }
  }
}

}  // namespace

extern "C" {

int dseg_image_size(const char* path, int* w, int* h) try {
  std::string p(path);
  if (ends_with(p, ".png")) {
    png_image image;
    std::memset(&image, 0, sizeof(image));
    image.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_file(&image, path)) return 1;
    *w = image.width;
    *h = image.height;
    png_image_free(&image);
    return 0;
  }
  if (ends_with(p, ".jpg") || ends_with(p, ".jpeg")) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    jpeg_decompress_struct cinfo;
    JpegErrorJmp jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_longjmp;
    if (setjmp(jerr.jump)) {
      jpeg_destroy_decompress(&cinfo);
      std::fclose(f);
      return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
      jpeg_destroy_decompress(&cinfo);
      std::fclose(f);
      return 1;
    }
    *w = cinfo.image_width;
    *h = cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 0;
  }
  return 1;
} catch (...) {
  return 1;
}

// mode: 0 = bilinear (images), 1 = nearest (labels).
// Returns 0 on success. Caller allocates out (out_h * out_w * channels).
// noexcept boundary: any C++ exception escaping extern "C" into ctypes is
// std::terminate -> SIGABRT for the whole training process; translate to
// the error code (-> PIL fallback) instead.
int dseg_decode_resize(const char* path, int out_w, int out_h, int mode,
                       int grayscale, uint8_t* out, int* got_w,
                       int* got_h) try {
  std::vector<uint8_t> data;
  int w = 0, h = 0, ch = 0;
  if (!decode(path, grayscale != 0, data, w, h, ch)) return 1;
  int want_ch = grayscale ? 1 : 3;
  if (ch != want_ch) return 2;
  if (out_w <= 0 || out_h <= 0 || (out_w == w && out_h == h)) {
    std::memcpy(out, data.data(), data.size());
    *got_w = w;
    *got_h = h;
    return 0;
  }
  if (mode == 1) {
    resize_nearest(data.data(), w, h, ch, out, out_w, out_h);
  } else {
    resize_bilinear(data.data(), w, h, ch, out, out_w, out_h);
  }
  *got_w = out_w;
  *got_h = out_h;
  return 0;
} catch (...) {
  return 3;
}

}  // extern "C"
