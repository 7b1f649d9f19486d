// Native data loader of the PyTorch port: image decode, antialiased
// bicubic resize and crop/augment, with a threaded batch API. The port's
// own copy of the JAX package's native/loader.cc (the same functions and
// arithmetic, so the two bindings give the same bytes), built by
// tpu_diinn_torch/native/loader.py.
//
// It plays the role torchvision's C++ ops play in the reference pipeline
// (srdata.py:210,228,236: libpng/libjpeg decode and antialiased bicubic
// downsampling inside the dataloader workers, the host-side hot loop).
// Exposed through a plain C ABI (ctypes); all randomness (crop offsets,
// flips) is decided by the Python side, so the pipeline stays
// reproducible from one seed.
//
// The bicubic weights replicate torch/PIL antialiased bicubic exactly
// (cubic a=-0.5, support scaled by the downsampling factor, boundary-
// clipped and renormalized; float64 weights, float32 accumulation).
//
// Errors: a PNG or JPEG that its library cannot decode makes the call
// return nonzero. libpng reports through its setjmp buffer; libjpeg's
// error_exit is replaced by one that longjmps back to decode_jpeg (its
// default calls exit() and would end the process).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <csetjmp>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

// ---------------------------------------------------------------------------
// Decode: PNG / JPEG -> RGB uint8. Returns 0 on success.
// ---------------------------------------------------------------------------

static int decode_png(FILE* f, std::vector<uint8_t>* out, int* h, int* w) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return 1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return 1;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 1;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);
  out->resize(size_t(height) * width * 3);
  std::vector<png_bytep> rows(height);
  for (png_uint_32 y = 0; y < height; ++y)
    rows[y] = out->data() + size_t(y) * width * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  *h = int(height);
  *w = int(width);
  return 0;
}

// libjpeg's error manager with a way back: error_exit longjmps to the
// decode that set `back`, which cleans up and returns an error.
struct JpegError {
  jpeg_error_mgr mgr;  // first, so that cinfo.err points at the struct
  jmp_buf back;
};

static void jpeg_error_return(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegError*>(cinfo->err)->back, 1);
}

static int decode_jpeg(FILE* f, std::vector<uint8_t>* out, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_return;
  if (setjmp(jerr.back)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(size_t(*h) * (*w) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->data() + size_t(cinfo.output_scanline) * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// image_size: peek dimensions (for Python-side crop RNG without full decode).
int image_size(const char* path, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  uint8_t magic[4] = {0};
  if (fread(magic, 1, 4, f) != 4) {
    fclose(f);
    return 1;
  }
  rewind(f);
  std::vector<uint8_t> buf;
  int rc;
  if (magic[0] == 0x89 && magic[1] == 'P')
    rc = decode_png(f, &buf, h, w);  // header-only fast path not worth it
  else
    rc = decode_jpeg(f, &buf, h, w);
  fclose(f);
  return rc;
}

// decode_image: full decode into caller-allocated buffer of h*w*3 bytes.
// Call with out=nullptr first via image_size to learn dimensions.
int decode_image(const char* path, uint8_t* out, int h, int w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  uint8_t magic[2] = {0};
  if (fread(magic, 1, 2, f) != 2) {
    fclose(f);
    return 1;
  }
  rewind(f);
  std::vector<uint8_t> buf;
  int hh = 0, ww = 0;
  int rc = (magic[0] == 0x89 && magic[1] == 'P')
               ? decode_png(f, &buf, &hh, &ww)
               : decode_jpeg(f, &buf, &hh, &ww);
  fclose(f);
  if (rc || hh != h || ww != w) return 1;
  memcpy(out, buf.data(), buf.size());
  return 0;
}

// ---------------------------------------------------------------------------
// Antialiased bicubic resize (torch/PIL convention), separable.
// ---------------------------------------------------------------------------

static inline double cubic_filter(double x) {
  const double a = -0.5;
  x = std::fabs(x);
  if (x <= 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct AxisWeights {
  int taps;                  // max taps per output index
  std::vector<int> lo;       // first source index per output
  std::vector<int> count;    // valid taps per output
  std::vector<double> w;     // [out, taps]
};

static AxisWeights compute_weights(int n_in, int n_out, bool antialias) {
  AxisWeights aw;
  double scale = double(n_in) / n_out;
  double support, invscale;
  if (antialias && scale >= 1.0) {
    support = 2.0 * scale;
    invscale = 1.0 / scale;
  } else {
    support = 2.0;
    invscale = 1.0;
  }
  aw.taps = int(std::ceil(support)) * 2 + 2;
  aw.lo.resize(n_out);
  aw.count.resize(n_out);
  aw.w.assign(size_t(n_out) * aw.taps, 0.0);
  for (int i = 0; i < n_out; ++i) {
    double center = scale * (i + 0.5);
    int lo = std::max(int(center - support + 0.5), 0);
    int hi = std::min(int(center + support + 0.5), n_in);
    double total = 0.0;
    for (int j = lo; j < hi; ++j) {
      double v = cubic_filter((j - center + 0.5) * invscale);
      aw.w[size_t(i) * aw.taps + (j - lo)] = v;
      total += v;
    }
    if (total != 0.0)
      for (int j = 0; j < hi - lo; ++j) aw.w[size_t(i) * aw.taps + j] /= total;
    aw.lo[i] = lo;
    aw.count[i] = hi - lo;
  }
  return aw;
}

// resize float32 HWC image (h_in, w_in, c) -> (h_out, w_out, c).
void resize_bicubic_f32(const float* in, int h_in, int w_in, int c,
                        float* out, int h_out, int w_out, int antialias) {
  AxisWeights wh = compute_weights(h_in, h_out, antialias != 0);
  AxisWeights ww = compute_weights(w_in, w_out, antialias != 0);
  // pass 1: H
  std::vector<float> tmp(size_t(h_out) * w_in * c);
  for (int i = 0; i < h_out; ++i) {
    for (int x = 0; x < w_in * c; ++x) {
      float acc = 0.f;
      const double* wrow = &wh.w[size_t(i) * wh.taps];
      for (int t = 0; t < wh.count[i]; ++t)
        acc += float(wrow[t]) * in[size_t(wh.lo[i] + t) * w_in * c + x];
      tmp[size_t(i) * w_in * c + x] = acc;
    }
  }
  // pass 2: W
  for (int i = 0; i < h_out; ++i) {
    const float* row = &tmp[size_t(i) * w_in * c];
    for (int j = 0; j < w_out; ++j) {
      const double* wrow = &ww.w[size_t(j) * ww.taps];
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int t = 0; t < ww.count[j]; ++t)
          acc += float(wrow[t]) * row[size_t(ww.lo[j] + t) * c + ch];
        out[(size_t(i) * w_out + j) * c + ch] = acc;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Full training sample: decode -> crop -> downsample -> flips.
// Matches SRDataDownsample.get_patch + _augment (srdata.py:186-237).
// ---------------------------------------------------------------------------

static void apply_flips(float* img, int h, int w, int c, int hflip, int vflip,
                        int dflip, float* scratch) {
  size_t row = size_t(w) * c;
  if (hflip) {  // flip H
    for (int y = 0; y < h / 2; ++y) {
      float* a = img + size_t(y) * row;
      float* b = img + size_t(h - 1 - y) * row;
      std::swap_ranges(a, a + row, b);
    }
  }
  if (vflip) {  // flip W
    for (int y = 0; y < h; ++y) {
      float* r = img + size_t(y) * row;
      for (int x = 0; x < w / 2; ++x)
        for (int ch = 0; ch < c; ++ch)
          std::swap(r[size_t(x) * c + ch], r[size_t(w - 1 - x) * c + ch]);
    }
  }
  if (dflip) {  // transpose HxW (requires h == w for in-place via scratch)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        for (int ch = 0; ch < c; ++ch)
          scratch[(size_t(x) * h + y) * c + ch] = img[(size_t(y) * w + x) * c + ch];
    memcpy(img, scratch, size_t(h) * w * c * sizeof(float));
  }
}

// sample_patch: one (lr, hr) training pair from a decoded uint8 image.
//   img: (h, w, 3) uint8; crop hr_patch at (top, left) of size hps x hps,
//   downsample to ps x ps, apply shared flips; outputs are [0,1] float32.
int sample_patch(const uint8_t* img, int h, int w, int top, int left, int hps,
                 int ps, int hflip, int vflip, int dflip, float* lr_out,
                 float* hr_out) {
  if (top < 0 || left < 0 || top + hps > h || left + hps > w) return 1;
  std::vector<float> crop(size_t(hps) * hps * 3);
  for (int y = 0; y < hps; ++y)
    for (int x = 0; x < hps; ++x)
      for (int ch = 0; ch < 3; ++ch)
        crop[(size_t(y) * hps + x) * 3 + ch] =
            float(img[(size_t(top + y) * w + (left + x)) * 3 + ch]);
  resize_bicubic_f32(crop.data(), hps, hps, 3, lr_out, ps, ps, 1);
  std::vector<float> scratch(size_t(hps) * hps * 3);
  apply_flips(crop.data(), hps, hps, 3, hflip, vflip, dflip, scratch.data());
  apply_flips(lr_out, ps, ps, 3, hflip, vflip, dflip, scratch.data());
  const float inv = 1.0f / 255.0f;
  for (size_t i = 0; i < crop.size(); ++i) hr_out[i] = crop[i] * inv;
  for (size_t i = 0; i < size_t(ps) * ps * 3; ++i) lr_out[i] *= inv;
  return 0;
}

// ---------------------------------------------------------------------------
// Threaded batch: decode+sample B items in parallel with std::thread.
// Arrays are flattened per-item parameter lists.
// ---------------------------------------------------------------------------

int sample_batch(const char** paths, int n, const int* tops, const int* lefts,
                 int hps, int ps, const int* hflips, const int* vflips,
                 const int* dflips, float* lr_out, float* hr_out,
                 int n_threads) {
  std::atomic<int> next(0), failed(0);
  size_t lr_stride = size_t(ps) * ps * 3;
  size_t hr_stride = size_t(hps) * hps * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int h = 0, w = 0;
      if (image_size(paths[i], &h, &w)) {
        failed.fetch_add(1);
        continue;
      }
      std::vector<uint8_t> img(size_t(h) * w * 3);
      if (decode_image(paths[i], img.data(), h, w) ||
          sample_patch(img.data(), h, w, tops[i], lefts[i], hps, ps,
                       hflips[i], vflips[i], dflips[i],
                       lr_out + size_t(i) * lr_stride,
                       hr_out + size_t(i) * hr_stride))
        failed.fetch_add(1);
    }
  };
  int nt = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load();
}

}  // extern "C"
