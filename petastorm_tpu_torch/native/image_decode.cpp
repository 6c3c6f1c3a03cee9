// Batched PNG/JPEG decode of a whole image column in one C call.
//
// The port's own copy of the pixel half of
// petastorm_tpu/native/image_decode.cpp (png_mem_read, read_png,
// decode_png_gray_cv2, decode_png, decode_jpeg, decode_one :50-221,
// decode_jpeg_roi, decode_png_roi, decode_one_roi :237-380;
// pst_decode_image_batch :575, pst_decode_image :610,
// pst_decode_image_batch_roi :622).  The coefficient half lives in
// jpeg_coef.cpp.
//
// Why it exists: the per-cell decoders Python can call (cv2.imdecode, PIL)
// run one cell per Python call, so a thread pool of readers serialises on
// the GIL between cells.  This library decodes a whole column of encoded
// cells in one call, which ctypes makes with the GIL released, and can fan
// the batch out over threads of its own; it writes straight into one
// preallocated contiguous uint8 array, the layout a ColumnBatch holds.
//
// Output is interleaved row-major uint8, RGB order for 3-channel images
// (stored streams are standard RGB files).  Built against the vendored
// libjpeg-turbo 6.2-ABI and libpng 1.6 headers in include/ (build.py).
// C ABI only, loaded with ctypes (native/image.py).

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------------------
// PNG via the full libpng 1.6 API (not the "simplified" one): full control
// over transforms and CRC policy.  Color-source -> grayscale-target uses
// png_set_rgb_to_gray(0.299, 0.587, 0.114) - the exact call OpenCV's PNG
// reader makes for IMREAD_GRAYSCALE - so native and cv2 fallback paths yield
// bit-identical tensors.  (The simplified API's PNG_FORMAT_GRAY uses libpng's
// default BT.709 + gamma handling, which differs by up to ~50/255.)
//
// In-stream CRC checking is skipped (PNG_CRC_QUIET_USE): inflate of
// incompressible image data is near-memcpy speed, leaving CRC as a large
// fraction of decode time.  Storage integrity is the parquet layer's job; a
// decode-time CRC on every read would re-pay that cost on the hot path.
// ---------------------------------------------------------------------------
struct PngMemSrc {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_mem_read(png_structp png, png_bytep dst, png_size_t n) {
  PngMemSrc* s = static_cast<PngMemSrc*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) {
    png_error(png, "read past end");
    return;
  }
  std::memcpy(dst, s->data + s->pos, n);
  s->pos += n;
}

// special setup() return: re-dispatch to the cv2-gray path (not an error)
constexpr int kPngRedirectGray = 1;

// Shared full-API read skeleton: open + mem source + CRC policy + dimension
// check, then the caller's transform setup (given the source color_type),
// then rowbytes validation and the row read.  Any libpng error longjmps to
// the setjmp here and returns -5.
template <typename SetupFn>
int read_png(const uint8_t* src, size_t len, uint8_t* out, int height,
             int width, size_t stride, SetupFn setup) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return -2;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -2;
  }
  // fully built before setjmp: longjmp must not skip over mutations of
  // non-volatile locals
  std::vector<png_bytep> rows(height);
  for (int y = 0; y < height; ++y) rows[y] = out + (size_t)y * stride;
  int rc = 0;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -5;
  }
  PngMemSrc mem{src, len, 0};
  png_set_read_fn(png, &mem, png_mem_read);
  png_set_crc_action(png, PNG_CRC_QUIET_USE, PNG_CRC_QUIET_USE);
  png_read_info(png, info);
  if ((int)png_get_image_width(png, info) != width ||
      (int)png_get_image_height(png, info) != height) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  rc = setup(png, png_get_color_type(png, info));
  if (rc != 0) {
    png_destroy_read_struct(&png, &info, nullptr);
    return rc;
  }
  (void)png_set_interlace_handling(png);
  png_read_update_info(png, info);
  if (png_get_rowbytes(png, info) != stride) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -4;
  }
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

int decode_png_gray_cv2(const uint8_t* src, size_t len, uint8_t* out,
                        int height, int width) {
  return read_png(src, len, out, height, width, (size_t)width,
                  [](png_structp png, png_byte) {
                    png_set_expand(png);    // palette->rgb, low-bit gray->8
                    png_set_strip_16(png);  // 16-bit->8-bit
                    png_set_strip_alpha(png);
                    // (red, green) weights; blue = 1 - red - green = 0.114
                    png_set_rgb_to_gray(png, PNG_ERROR_ACTION_NONE, 0.299,
                                        0.587);
                    return 0;
                  });
}

int decode_png(const uint8_t* src, size_t len, uint8_t* out, int height,
               int width, int channels) {
  if (channels != 1 && channels != 3 && channels != 4) return -4;
  int rc = read_png(
      src, len, out, height, width, (size_t)width * channels,
      [channels](png_structp png, png_byte color_type) {
        if (channels == 1 && (color_type & PNG_COLOR_MASK_COLOR))
          return kPngRedirectGray;  // needs cv2-matching gray weights
        png_set_expand(png);    // palette->rgb, low-bit gray->8, tRNS->alpha
        png_set_strip_16(png);  // 16-bit->8-bit
        if (channels >= 3) png_set_gray_to_rgb(png);
        if (channels == 4) {
          if (!(color_type & PNG_COLOR_MASK_ALPHA))
            png_set_add_alpha(png, 0xFF, PNG_FILLER_AFTER);
        } else {
          png_set_strip_alpha(png);
        }
        return 0;
      });
  if (rc == kPngRedirectGray)
    return decode_png_gray_cv2(src, len, out, height, width);
  return rc;
}

// ---------------------------------------------------------------------------
// JPEG via libjpeg with setjmp error trap (libjpeg's error model).
// ---------------------------------------------------------------------------
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

int decode_jpeg(const uint8_t* src, size_t len, uint8_t* out, int height,
                int width, int channels) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(src), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  cinfo.out_color_space = (channels == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_width != width || (int)cinfo.output_height != height ||
      (int)cinfo.output_components != channels) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -4;
  }
  const size_t stride = (size_t)width * channels;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int decode_one(const uint8_t* src, size_t len, uint8_t* out, int height,
               int width, int channels) {
  if (len >= 8 && src[0] == 0x89 && src[1] == 'P' && src[2] == 'N' &&
      src[3] == 'G')
    return decode_png(src, len, out, height, width, channels);
  if (len >= 2 && src[0] == 0xFF && src[1] == 0xD8)
    return decode_jpeg(src, len, out, height, width, channels);
  return -1;  // unknown magic
}

// ---------------------------------------------------------------------------
// ROI (partial) decode: augment-crop pipelines keep only a (crop_h, crop_w)
// window, so decoding the full image just to throw most of it away wastes the
// dominant ingest cost.  Both codecs are sequential-scanline formats, so the
// honest savings are: rows BELOW the crop are never entropy-decoded or
// IDCT'd/inflated (the decode aborts after the last needed scanline), rows
// ABOVE it are decoded into a small discard buffer (required by the stream
// format - plain libjpeg has no jpeg_skip_scanlines; with libjpeg-turbo that
// could skip their IDCT too), and only the crop's columns are copied to the
// output.  For a centered/random crop this cuts roughly half the row work
// plus the full-image copy; the output is byte-identical to slicing a full
// decode (same decoder, same rows).
// ---------------------------------------------------------------------------

int decode_jpeg_roi(const uint8_t* src, size_t len, uint8_t* out, int height,
                    int width, int channels, int crop_y, int crop_x,
                    int crop_h, int crop_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  // heap buffers built before setjmp (longjmp must not skip destructors)
  std::vector<uint8_t> rowbuf;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(src), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  cinfo.out_color_space = (channels == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_width != width || (int)cinfo.output_height != height ||
      (int)cinfo.output_components != channels) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -4;
  }
  const size_t full_stride = (size_t)width * channels;
  const size_t out_stride = (size_t)crop_w * channels;
  rowbuf.resize(full_stride);
  const int last = crop_y + crop_h;  // first row we do NOT need
  while ((int)cinfo.output_scanline < last) {
    int y = (int)cinfo.output_scanline;
    JSAMPROW row = rowbuf.data();
    jpeg_read_scanlines(&cinfo, &row, 1);
    if (y >= crop_y)
      std::memcpy(out + (size_t)(y - crop_y) * out_stride,
                  rowbuf.data() + (size_t)crop_x * channels, out_stride);
  }
  // rows below the crop are never decoded: abort skips straight to cleanup
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int decode_png_roi(const uint8_t* src, size_t len, uint8_t* out, int height,
                   int width, int channels, int crop_y, int crop_x,
                   int crop_h, int crop_w) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return -2;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -2;
  }
  std::vector<uint8_t> rowbuf;
  std::vector<uint8_t> full;     // interlaced fallback only
  std::vector<png_bytep> rows;   // interlaced fallback only
  bool redirect_gray = false;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -5;
  }
  PngMemSrc mem{src, len, 0};
  png_set_read_fn(png, &mem, png_mem_read);
  png_set_crc_action(png, PNG_CRC_QUIET_USE, PNG_CRC_QUIET_USE);
  png_read_info(png, info);
  if ((int)png_get_image_width(png, info) != width ||
      (int)png_get_image_height(png, info) != height) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  png_byte color_type = png_get_color_type(png, info);
  if (channels == 1 && (color_type & PNG_COLOR_MASK_COLOR)) {
    // needs the cv2-matching gray weights path; handled by the caller via a
    // full gray decode + crop (rare: color stream into a grayscale field)
    redirect_gray = true;
  } else {
    png_set_expand(png);
    png_set_strip_16(png);
    if (channels >= 3) png_set_gray_to_rgb(png);
    if (channels == 4) {
      if (!(color_type & PNG_COLOR_MASK_ALPHA))
        png_set_add_alpha(png, 0xFF, PNG_FILLER_AFTER);
    } else {
      png_set_strip_alpha(png);
    }
  }
  if (redirect_gray) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kPngRedirectGray;
  }
  const bool interlaced =
      png_get_interlace_type(png, info) != PNG_INTERLACE_NONE;
  (void)png_set_interlace_handling(png);
  png_read_update_info(png, info);
  const size_t full_stride = (size_t)width * channels;
  const size_t out_stride = (size_t)crop_w * channels;
  if (png_get_rowbytes(png, info) != full_stride) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -4;
  }
  if (interlaced) {
    // Adam7 delivers every row on every pass: no early-out is possible, so
    // decode whole rows and crop afterwards (correctness over savings)
    full.resize(full_stride * height);
    rows.resize(height);
    for (int y = 0; y < height; ++y) rows[y] = full.data() + y * full_stride;
    png_read_image(png, rows.data());
    for (int y = 0; y < crop_h; ++y)
      std::memcpy(out + (size_t)y * out_stride,
                  full.data() + (size_t)(crop_y + y) * full_stride
                      + (size_t)crop_x * channels,
                  out_stride);
  } else {
    rowbuf.resize(full_stride);
    const int last = crop_y + crop_h;
    for (int y = 0; y < last; ++y) {
      png_read_row(png, rowbuf.data(), nullptr);
      if (y >= crop_y)
        std::memcpy(out + (size_t)(y - crop_y) * out_stride,
                    rowbuf.data() + (size_t)crop_x * channels, out_stride);
    }
    // rows below the crop are never inflated: destroy without png_read_end
  }
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

int decode_one_roi(const uint8_t* src, size_t len, uint8_t* out, int height,
                   int width, int channels, int crop_y, int crop_x,
                   int crop_h, int crop_w) {
  if (crop_y < 0 || crop_x < 0 || crop_h < 1 || crop_w < 1 ||
      crop_y + crop_h > height || crop_x + crop_w > width)
    return -8;  // crop outside the image
  if (crop_y == 0 && crop_x == 0 && crop_h == height && crop_w == width)
    return decode_one(src, len, out, height, width, channels);
  if (len >= 8 && src[0] == 0x89 && src[1] == 'P' && src[2] == 'N' &&
      src[3] == 'G') {
    int rc = decode_png_roi(src, len, out, height, width, channels, crop_y,
                            crop_x, crop_h, crop_w);
    if (rc == kPngRedirectGray) {
      // color->gray needs the weighted transform over full rows: decode the
      // full gray image to a scratch buffer, then crop (rare path)
      std::vector<uint8_t> scratch((size_t)height * width);
      rc = decode_png_gray_cv2(src, len, scratch.data(), height, width);
      if (rc != 0) return rc;
      for (int y = 0; y < crop_h; ++y)
        std::memcpy(out + (size_t)y * crop_w,
                    scratch.data() + (size_t)(crop_y + y) * width + crop_x,
                    (size_t)crop_w);
    }
    return rc;
  }
  if (len >= 2 && src[0] == 0xFF && src[1] == 0xD8)
    return decode_jpeg_roi(src, len, out, height, width, channels, crop_y,
                           crop_x, crop_h, crop_w);
  return -1;  // unknown magic
}

// Runs decode(i) for i in [0, n), inline when nthreads <= 1, else over up
// to nthreads threads of contiguous chunks.  Returns 0, or (1 + index) of
// the first image whose decode returned nonzero; the other threads stop at
// their next image.
template <typename DecodeFn>
int fan_out(int n, int nthreads, DecodeFn decode) {
  std::atomic<int> failed{0};  // 1 + index of first failure, 0 = ok
  auto run = [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      if (failed.load(std::memory_order_relaxed)) return;
      if (decode(i) != 0) {
        int expected = 0;
        failed.compare_exchange_strong(expected, 1 + i);
        return;
      }
    }
  };
  if (nthreads <= 1 || n <= 1) {
    run(0, n);
  } else {
    int workers = nthreads < n ? nthreads : n;
    std::vector<std::thread> threads;
    threads.reserve(workers);
    int chunk = (n + workers - 1) / workers;
    for (int w = 0; w < workers; ++w) {
      int lo = w * chunk;
      int hi = lo + chunk < n ? lo + chunk : n;
      if (lo >= hi) break;
      threads.emplace_back(run, lo, hi);
    }
    for (auto& t : threads) t.join();
  }
  return failed.load();
}

}  // namespace

extern "C" {

// Decode n images into out (contiguous, one image every `stride` bytes).
// srcs[i] = pointer to encoded stream i of length lens[i].  All images must
// decode to exactly (height, width, channels) uint8.  nthreads <= 1 decodes
// inline; otherwise the batch is split over threads.  Returns 0 on success,
// or (1 + index) of the first failing image.
int pst_decode_image_batch(const uint8_t* const* srcs, const uint64_t* lens,
                           int n, uint8_t* out, uint64_t stride, int height,
                           int width, int channels, int nthreads) {
  return fan_out(n, nthreads, [&](int i) {
    return decode_one(srcs[i], (size_t)lens[i], out + (uint64_t)i * stride,
                      height, width, channels);
  });
}

// One image: the batch's decode of a single cell (tests).
int pst_decode_image(const uint8_t* src, uint64_t len, uint8_t* out, int height,
                     int width, int channels) {
  return decode_one(src, (size_t)len, out, height, width, channels);
}

// Batched ROI decode: like pst_decode_image_batch, but each image i decodes
// only its (crop_h, crop_w) window anchored at (crop_ys[i], crop_xs[i]) -
// out rows are (crop_h, crop_w, channels), one every `stride` bytes.  Every
// stream must still decode to exactly (height, width, channels); the crop
// need not be 8x8-block aligned (the copy is scanline-level, so the result
// is byte-identical to slicing a full decode).  Returns 0, or (1 + index)
// of the first failing image.
int pst_decode_image_batch_roi(const uint8_t* const* srcs,
                               const uint64_t* lens, int n, uint8_t* out,
                               uint64_t stride, int height, int width,
                               int channels, const int32_t* crop_ys,
                               const int32_t* crop_xs, int crop_h, int crop_w,
                               int nthreads) {
  return fan_out(n, nthreads, [&](int i) {
    return decode_one_roi(srcs[i], (size_t)lens[i], out + (uint64_t)i * stride,
                          height, width, channels, crop_ys[i], crop_xs[i],
                          crop_h, crop_w);
  });
}

}  // extern "C"
