// cometio: the native (C++) image decode and preprocess core of the data layer.
//
// The port's own copy of the JAX package's loader (comet_tpu/native/cometio.cpp);
// the code below the includes is the same. The reference's data loader leans on
// PIL's C decoders and resampler (kubric_movif_SFM_dataset_YT.py:160-266 decodes
// S=16 frames per sequence and LANCZOS-resizes the sequence crop). This module is
// the host-side equivalent: libjpeg/libpng decoding, a fixed-point Lanczos-3
// crop-resampler that is BIT-EXACT against PIL's (Pillow Resample.c 8bpc path:
// horizontal-then-vertical passes, 22-bit fixed-point coefficients, per-pass
// uint8 rounding), ImageNet normalization, and a std::thread pool over the
// frames of a sequence.
//
// A plain C ABI consumed from Python through ctypes
// (comet_tpu_torch/native/__init__.py); no Python.h dependency.
//
// Build: g++ -O3 -fPIC -shared -pthread -std=c++17 cometio.cpp -ljpeg -lpng -lz
//   (run at first use by comet_tpu_torch/native/__init__.py)

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

extern "C" {

// ---------------------------------------------------------------------------
// Decoding
// ---------------------------------------------------------------------------

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG byte buffer to tightly-packed RGB8. Returns 0 on success.
// Uses JDCT_ISLOW (libjpeg's default and PIL's) so pixel values match a
// PIL decode through the same libjpeg.
int decode_jpeg(const uint8_t* bytes, size_t len, std::vector<uint8_t>* out,
                int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(bytes),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.dct_method = JDCT_ISLOW;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(size_t(*w) * size_t(*h) * 3);
  const size_t stride = size_t(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + size_t(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) {
    png_error(png, "read past end");
    return;
  }
  memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

// Decode a PNG byte buffer to tightly-packed RGB8 (palette expanded,
// grayscale replicated, 16-bit stripped, alpha dropped — the same result
// as PIL's Image.open(...).convert("RGB") for these transforms).
int decode_png(const uint8_t* bytes, size_t len, std::vector<uint8_t>* out,
               int* w, int* h) {
  if (len < 8 || png_sig_cmp(bytes, 0, 8)) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -1;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -1;
  }
  PngReadState state{bytes, len, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);

  png_uint_32 width, height;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &width, &height, &bit_depth, &color_type, nullptr,
               nullptr, nullptr);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  *w = static_cast<int>(width);
  *h = static_cast<int>(height);
  out->resize(size_t(width) * height * 3);
  std::vector<png_bytep> rows(height);
  const size_t stride = size_t(width) * 3;
  for (png_uint_32 y = 0; y < height; y++)
    rows[y] = out->data() + y * stride;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

int read_file(const char* path, std::vector<uint8_t>* bytes) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  if (size < 0) {
    fclose(f);
    return -1;
  }
  fseek(f, 0, SEEK_SET);
  bytes->resize(size_t(size));
  size_t got = fread(bytes->data(), 1, size_t(size), f);
  fclose(f);
  return got == size_t(size) ? 0 : -1;
}

// Decode any supported container (sniffed by magic) to RGB8.
int decode_rgb_bytes(const uint8_t* bytes, size_t len,
                     std::vector<uint8_t>* out, int* w, int* h) {
  if (len >= 3 && bytes[0] == 0xFF && bytes[1] == 0xD8 && bytes[2] == 0xFF)
    return decode_jpeg(bytes, len, out, w, h);
  if (len >= 8 && !png_sig_cmp(bytes, 0, 8))
    return decode_png(bytes, len, out, w, h);
  return -2;  // unknown container
}

// ---------------------------------------------------------------------------
// PIL-exact Lanczos-3 resampling (Pillow Resample.c, 8bpc fixed-point path)
// ---------------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow PRECISION_BITS

double sinc(double x) {
  if (x == 0.0) return 1.0;
  x *= M_PI;
  return sin(x) / x;
}

double lanczos_filter(double x) {
  if (-3.0 <= x && x < 3.0) return sinc(x) * sinc(x / 3.0);
  return 0.0;
}

// Pillow precompute_coeffs: tap windows + normalized double weights for one
// axis of a (in0, in1) -> outSize resample.
int precompute_coeffs(int in_size, double in0, double in1, int out_size,
                      std::vector<int>* bounds, std::vector<double>* kk) {
  const double scale = (in1 - in0) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 3.0 * filterscale;
  const int ksize = static_cast<int>(ceil(support)) * 2 + 1;
  bounds->resize(size_t(out_size) * 2);
  kk->assign(size_t(out_size) * ksize, 0.0);
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; xx++) {
    const double center = in0 + (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = kk->data() + size_t(xx) * ksize;
    double wsum = 0.0;
    for (int x = 0; x < xmax; x++) {
      const double w = lanczos_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      wsum += w;
    }
    if (wsum != 0.0)
      for (int x = 0; x < xmax; x++) k[x] /= wsum;
    (*bounds)[size_t(xx) * 2] = xmin;
    (*bounds)[size_t(xx) * 2 + 1] = xmax;
  }
  return ksize;
}

// Pillow normalize_coeffs_8bpc: doubles -> 22-bit fixed point with
// round-half-away-from-zero.
void normalize_coeffs_8bpc(const std::vector<double>& kk,
                           std::vector<int>* kk_int) {
  kk_int->resize(kk.size());
  for (size_t i = 0; i < kk.size(); i++) {
    const double w = kk[i] * (1 << kPrecisionBits);
    (*kk_int)[i] = static_cast<int>(w < 0 ? w - 0.5 : w + 0.5);
  }
}

inline uint8_t clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

// One horizontal resampling pass over [h, in_w, ch] -> [h, out_w, ch].
void resample_horizontal_8bpc(const uint8_t* src, int h, int in_w, int ch,
                              int out_w, const std::vector<int>& bounds,
                              const std::vector<int>& kk_int, int ksize,
                              uint8_t* dst) {
  for (int yy = 0; yy < h; yy++) {
    const uint8_t* srow = src + size_t(yy) * in_w * ch;
    uint8_t* drow = dst + size_t(yy) * out_w * ch;
    for (int xx = 0; xx < out_w; xx++) {
      const int xmin = bounds[size_t(xx) * 2];
      const int xmax = bounds[size_t(xx) * 2 + 1];
      const int* k = kk_int.data() + size_t(xx) * ksize;
      for (int c = 0; c < ch; c++) {
        int ss = 1 << (kPrecisionBits - 1);
        const uint8_t* sp = srow + size_t(xmin) * ch + c;
        for (int x = 0; x < xmax; x++) ss += sp[size_t(x) * ch] * k[x];
        drow[size_t(xx) * ch + c] = clip8(ss);
      }
    }
  }
}

// One vertical resampling pass over [in_h, w, ch] -> [out_h, w, ch].
void resample_vertical_8bpc(const uint8_t* src, int in_h, int w, int ch,
                            int out_h, const std::vector<int>& bounds,
                            const std::vector<int>& kk_int, int ksize,
                            uint8_t* dst) {
  const size_t stride = size_t(w) * ch;
  for (int yy = 0; yy < out_h; yy++) {
    const int ymin = bounds[size_t(yy) * 2];
    const int ymax = bounds[size_t(yy) * 2 + 1];
    const int* k = kk_int.data() + size_t(yy) * ksize;
    uint8_t* drow = dst + size_t(yy) * stride;
    for (size_t i = 0; i < stride; i++) {
      int ss = 1 << (kPrecisionBits - 1);
      const uint8_t* sp = src + size_t(ymin) * stride + i;
      for (int y = 0; y < ymax; y++) ss += sp[size_t(y) * stride] * k[y];
      drow[i] = clip8(ss);
    }
  }
}

// PIL crop semantics: an integer box (x0, y0, x1, y1) against an [h, w, ch]
// image; pixels outside the source are zero.
void crop_zero_pad(const uint8_t* src, int h, int w, int ch, const int box[4],
                   std::vector<uint8_t>* out) {
  const int bw = box[2] - box[0], bh = box[3] - box[1];
  out->assign(size_t(bw) * bh * ch, 0);
  const int sx0 = box[0] < 0 ? 0 : box[0];
  const int sy0 = box[1] < 0 ? 0 : box[1];
  const int sx1 = box[2] > w ? w : box[2];
  const int sy1 = box[3] > h ? h : box[3];
  if (sx1 <= sx0 || sy1 <= sy0) return;
  const size_t row_bytes = size_t(sx1 - sx0) * ch;
  for (int y = sy0; y < sy1; y++) {
    memcpy(out->data() +
               (size_t(y - box[1]) * bw + size_t(sx0 - box[0])) * ch,
           src + (size_t(y) * w + sx0) * ch, row_bytes);
  }
}

// crop + two-pass Lanczos resize to [out_size, out_size, ch], bit-exact
// against PIL's img.crop(box).resize((out, out), LANCZOS).
int crop_resize_lanczos(const uint8_t* src, int h, int w, int ch,
                        const int box[4], int out_size,
                        std::vector<uint8_t>* out) {
  const int bw = box[2] - box[0], bh = box[3] - box[1];
  if (bw <= 0 || bh <= 0 || out_size <= 0) return -1;
  std::vector<uint8_t> crop;
  crop_zero_pad(src, h, w, ch, box, &crop);

  std::vector<int> bounds_h, bounds_v, kih, kiv;
  std::vector<double> kkh, kkv;
  const int ksh = precompute_coeffs(bw, 0.0, bw, out_size, &bounds_h, &kkh);
  const int ksv = precompute_coeffs(bh, 0.0, bh, out_size, &bounds_v, &kkv);
  normalize_coeffs_8bpc(kkh, &kih);
  normalize_coeffs_8bpc(kkv, &kiv);

  // Pillow pass order: horizontal into a temp image, then vertical.
  std::vector<uint8_t> tmp(size_t(bh) * out_size * ch);
  resample_horizontal_8bpc(crop.data(), bh, bw, ch, out_size, bounds_h, kih,
                           ksh, tmp.data());
  out->resize(size_t(out_size) * out_size * ch);
  resample_vertical_8bpc(tmp.data(), bh, out_size, ch, out_size, bounds_v,
                         kiv, ksv, out->data());
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

const char* cometio_version() { return "cometio 1.0 (jpeg+png, lanczos8)"; }

// Header-only probe of image dimensions. Returns 0 on success.
int cometio_image_size(const char* path, int* w, int* h) {
  std::vector<uint8_t> bytes;
  if (read_file(path, &bytes) != 0) return -1;
  if (bytes.size() >= 3 && bytes[0] == 0xFF && bytes[1] == 0xD8) {
    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
      jpeg_destroy_decompress(&cinfo);
      return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, bytes.data(),
                 static_cast<unsigned long>(bytes.size()));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
      jpeg_destroy_decompress(&cinfo);
      return -1;
    }
    *w = cinfo.image_width;
    *h = cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  if (bytes.size() >= 24 && !png_sig_cmp(bytes.data(), 0, 8)) {
    // IHDR is always the first chunk: width/height big-endian at offsets
    // 16/20.
    const uint8_t* p = bytes.data();
    *w = (p[16] << 24) | (p[17] << 16) | (p[18] << 8) | p[19];
    *h = (p[20] << 24) | (p[21] << 16) | (p[22] << 8) | p[23];
    return 0;
  }
  return -2;
}

// Decode to RGB8 into caller-provided storage of capacity `cap` bytes.
// Returns 0 on success, -2 if cap is too small (w/h are still set).
int cometio_decode_rgb(const char* path, uint8_t* out, long long cap, int* w,
                       int* h) {
  std::vector<uint8_t> bytes, rgb;
  if (read_file(path, &bytes) != 0) return -1;
  if (decode_rgb_bytes(bytes.data(), bytes.size(), &rgb, w, h) != 0)
    return -1;
  if (static_cast<long long>(rgb.size()) > cap) return -2;
  memcpy(out, rgb.data(), rgb.size());
  return 0;
}

// crop(box) + LANCZOS resize of an in-memory [h, w, ch] uint8 image,
// bit-exact vs PIL. dst must hold out_size*out_size*ch bytes.
int cometio_crop_resize_lanczos(const uint8_t* src, int h, int w, int ch,
                                const int* box, int out_size, uint8_t* dst) {
  std::vector<uint8_t> out;
  if (crop_resize_lanczos(src, h, w, ch, box, out_size, &out) != 0) return -1;
  memcpy(dst, out.data(), out.size());
  return 0;
}

// Decode to 8-bit luma (PIL convert("L") parity: ITU-R 601-2 via Pillow's
// L24 fixed-point table; for sources that are already grayscale the
// round-trip through RGB replication is exact).
int cometio_decode_gray(const char* path, uint8_t* out, long long cap,
                        int* w, int* h) {
  std::vector<uint8_t> bytes, rgb;
  if (read_file(path, &bytes) != 0) return -1;
  if (decode_rgb_bytes(bytes.data(), bytes.size(), &rgb, w, h) != 0)
    return -1;
  const long long npix = static_cast<long long>(*w) * *h;
  if (npix > cap) return -2;
  for (long long i = 0; i < npix; i++) {
    const uint8_t* p = rgb.data() + i * 3;
    out[i] = static_cast<uint8_t>(
        (p[0] * 19595 + p[1] * 38470 + p[2] * 7471 + 0x8000) >> 16);
  }
  return 0;
}

// Threaded mask pass: decode each mask to luma, record its nonzero-pixel
// bbox as (xmin, ymin, xmax+1, ymax+1) — or (0, 0, w, h) when empty,
// matching datasets.mask_bbox — and write mask 0's full luma plane into
// mask0 (capacity mask0_cap; w0/h0 report its size). Returns 0 on
// success, else the first per-frame error.
int cometio_load_masks(const char** paths, int n, int n_threads,
                       int* bboxes, uint8_t* mask0, long long mask0_cap,
                       int* w0, int* h0) {
  if (n <= 0) return -1;
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? static_cast<int>(hw) : 4;
  }
  if (n_threads > n) n_threads = n;

  std::atomic<int> next(0);
  std::vector<int> status(n, 0);

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      std::vector<uint8_t> bytes, rgb;
      int w = 0, h = 0;
      if (read_file(paths[i], &bytes) != 0 ||
          decode_rgb_bytes(bytes.data(), bytes.size(), &rgb, &w, &h) != 0) {
        status[i] = -1;
        continue;
      }
      int xmin = w, ymin = h, xmax = -1, ymax = -1;
      uint8_t* m0 = nullptr;
      if (i == 0) {
        if (static_cast<long long>(w) * h > mask0_cap) {
          status[i] = -2;
          continue;
        }
        *w0 = w;
        *h0 = h;
        m0 = mask0;
      }
      for (int y = 0; y < h; y++) {
        const uint8_t* row = rgb.data() + size_t(y) * w * 3;
        for (int x = 0; x < w; x++) {
          const uint8_t* p = row + size_t(x) * 3;
          const uint8_t l = static_cast<uint8_t>(
              (p[0] * 19595 + p[1] * 38470 + p[2] * 7471 + 0x8000) >> 16);
          if (m0) m0[size_t(y) * w + x] = l;
          if (l) {
            if (x < xmin) xmin = x;
            if (x > xmax) xmax = x;
            if (y < ymin) ymin = y;
            if (y > ymax) ymax = y;
          }
        }
      }
      int* b = bboxes + size_t(i) * 4;
      if (xmax < 0) {  // empty mask -> full image (datasets.mask_bbox)
        b[0] = 0;
        b[1] = 0;
        b[2] = w;
        b[3] = h;
      } else {
        b[0] = xmin;
        b[1] = ymin;
        b[2] = xmax + 1;
        b[3] = ymax + 1;
      }
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; i++)
    if (status[i] != 0) return status[i];
  return 0;
}

// Threaded sequence loader: decode n frames, crop+LANCZOS-resize each to
// [crop, crop, 3], normalize ((x/255 - mean) / std), and write float32
// [n, crop, crop, 3] into `out`. Every frame is decoded and resampled on
// its own pool thread (the ctypes caller drops the GIL for the whole
// call). Returns 0 if every frame succeeded, else the first frame error
// (-1 io/decode, -3 shape mismatch vs frame 0 is allowed — frames are
// processed independently).
int cometio_load_sequence(const char** paths, int n, const int* box,
                          int crop_size, const float* mean,
                          const float* stddev, int n_threads, float* out) {
  if (n <= 0) return -1;
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? static_cast<int>(hw) : 4;
  }
  if (n_threads > n) n_threads = n;

  std::atomic<int> next(0);
  std::vector<int> status(n, 0);
  const size_t frame_elems = size_t(crop_size) * crop_size * 3;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      std::vector<uint8_t> bytes, rgb, resized;
      int w = 0, h = 0;
      if (read_file(paths[i], &bytes) != 0 ||
          decode_rgb_bytes(bytes.data(), bytes.size(), &rgb, &w, &h) != 0) {
        status[i] = -1;
        continue;
      }
      if (crop_resize_lanczos(rgb.data(), h, w, 3, box, crop_size,
                              &resized) != 0) {
        status[i] = -1;
        continue;
      }
      float* dst = out + size_t(i) * frame_elems;
      // exact IEEE-f32 match of the numpy host path:
      // (x / 255.0 - mean) / std, all in float32
      for (size_t p = 0; p < frame_elems; p++) {
        const int c = static_cast<int>(p % 3);
        dst[p] = (static_cast<float>(resized[p]) / 255.0f - mean[c]) /
                 stddev[c];
      }
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; i++)
    if (status[i] != 0) return status[i];
  return 0;
}

// Threaded RAW decode: n same-sized frames into a contiguous uint8
// [n, h, w, 3] buffer, NO resampling — the companion of the XLA device
// preprocessing path (data/device_pipeline.py), which crops/resizes/
// normalizes on the accelerator. Caller passes the expected (w, h)
// (probe frame 0 with cometio_image_size); a frame of any other size
// fails with -3. Returns 0 on success, else the first frame error.
int cometio_decode_frames(const char** paths, int n, int w, int h,
                          int n_threads, uint8_t* out) {
  if (n <= 0 || w <= 0 || h <= 0) return -1;
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? static_cast<int>(hw) : 4;
  }
  if (n_threads > n) n_threads = n;

  std::atomic<int> next(0);
  std::vector<int> status(n, 0);
  const size_t frame_bytes = size_t(h) * w * 3;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      std::vector<uint8_t> bytes, rgb;
      int fw = 0, fh = 0;
      if (read_file(paths[i], &bytes) != 0 ||
          decode_rgb_bytes(bytes.data(), bytes.size(), &rgb, &fw, &fh) != 0) {
        status[i] = -1;
        continue;
      }
      if (fw != w || fh != h) {
        status[i] = -3;
        continue;
      }
      memcpy(out + size_t(i) * frame_bytes, rgb.data(), frame_bytes);
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; i++)
    if (status[i] != 0) return status[i];
  return 0;
}

}  // extern "C"
