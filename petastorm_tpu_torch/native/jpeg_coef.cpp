// Hybrid JPEG decode, host half: libjpeg's entropy (Huffman) decode only.
//
// The port's own copy of the coefficient half of
// petastorm_tpu/native/image_decode.cpp (JpegErr/jpeg_err_exit :150-162,
// jpeg_coef_open :398, pst_jpeg_coef_layout :416, jpeg_read_coefs_one :454,
// pst_jpeg_read_coefs :513, pst_jpeg_coef_batch :523), without the PNG and
// pixel-decode code.  jpeg_read_coefficients stops after the entropy
// decoder, yielding quantized DCT coefficient blocks; the FLOP-heavy rest
// (dequant + 8x8 IDCT + chroma upsample + YCbCr->RGB) runs on the card in
// kernel B2 (petastorm_tpu_torch/csrc/jpeg_decode.cu).  Coefficient blocks
// and quant tables are both in natural (row-major) order: libjpeg un-zigzags
// during entropy decode.
//
// Built against the libjpeg-turbo 6.2-ABI headers in include/ (build.py);
// jpeg_CreateDecompress checks the struct size and ABI version at run time,
// so a library of another ABI fails loudly, not silently.
//
// C ABI only, loaded with ctypes (native/image.py), which releases the GIL
// for the whole call.

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

// libjpeg's error model: error_exit must not return, so it longjmps back to
// the setjmp of the call that failed.
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

constexpr int kJpegMaxComps = 4;

// meta layout (int32): [ncomp, width, height,
//   then per component (kJpegMaxComps slots):
//   h_samp, v_samp, blocks_w, blocks_h]
constexpr int kJpegMetaLen = 3 + 4 * kJpegMaxComps;

int jpeg_coef_open(jpeg_decompress_struct* cinfo, JpegErr* jerr, const uint8_t* src,
                   size_t len) {
  cinfo->err = jpeg_std_error(&jerr->mgr);
  jerr->mgr.error_exit = jpeg_err_exit;
  jpeg_create_decompress(cinfo);
  jpeg_mem_src(cinfo, const_cast<unsigned char*>(src), len);
  if (jpeg_read_header(cinfo, TRUE) != JPEG_HEADER_OK) return -3;
  if (cinfo->num_components < 1 || cinfo->num_components > kJpegMaxComps) return -4;
  return 0;
}

// Entropy-decode coefficients.  outs[c] must hold blocks_h*blocks_w*64
// int16s (natural order within each block); qtabs must hold
// num_components*64 uint16s (natural order).  When expected_meta is non-null
// the image's geometry must match it exactly (batch-stacking contract).
int jpeg_read_coefs_one(const uint8_t* src, uint64_t len, int16_t* const* outs,
                        uint16_t* qtabs, const int32_t* expected_meta) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  int rc = jpeg_coef_open(&cinfo, &jerr, src, (size_t)len);
  if (rc != 0) {
    jpeg_destroy_decompress(&cinfo);
    return rc;
  }
  if (expected_meta && (expected_meta[0] != cinfo.num_components ||
                        expected_meta[1] != (int32_t)cinfo.image_width ||
                        expected_meta[2] != (int32_t)cinfo.image_height)) {
    jpeg_destroy_decompress(&cinfo);
    return -7;  // geometry mismatch within a batch
  }
  jvirt_barray_ptr* barrays = jpeg_read_coefficients(&cinfo);
  if (!barrays) {
    jpeg_destroy_decompress(&cinfo);
    return -5;
  }
  for (int c = 0; c < cinfo.num_components; ++c) {
    jpeg_component_info* ci = &cinfo.comp_info[c];
    if (!ci->quant_table) {
      jpeg_destroy_decompress(&cinfo);
      return -6;
    }
    if (expected_meta) {
      const int32_t* m = expected_meta + 3 + 4 * c;
      if (m[0] != ci->h_samp_factor || m[1] != ci->v_samp_factor ||
          m[2] != (int32_t)ci->width_in_blocks || m[3] != (int32_t)ci->height_in_blocks) {
        jpeg_destroy_decompress(&cinfo);
        return -7;
      }
    }
    for (int k = 0; k < DCTSIZE2; ++k) qtabs[c * DCTSIZE2 + k] = ci->quant_table->quantval[k];
    const JDIMENSION bw = ci->width_in_blocks;
    const JDIMENSION bh = ci->height_in_blocks;
    int16_t* dst = outs[c];
    for (JDIMENSION row = 0; row < bh; ++row) {
      JBLOCKARRAY rows = (*cinfo.mem->access_virt_barray)((j_common_ptr)&cinfo, barrays[c], row,
                                                          1, FALSE);
      static_assert(sizeof(JCOEF) == sizeof(int16_t), "JCOEF must be int16");
      std::memcpy(dst + (size_t)row * bw * DCTSIZE2, rows[0],
                  (size_t)bw * DCTSIZE2 * sizeof(int16_t));
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

extern "C" {

// Probe geometry without entropy-decoding.  Returns 0 and fills meta
// (kJpegMetaLen int32s) on success.
int pst_jpeg_coef_layout(const uint8_t* src, uint64_t len, int32_t* meta) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  int rc = jpeg_coef_open(&cinfo, &jerr, src, (size_t)len);
  if (rc != 0) {
    jpeg_destroy_decompress(&cinfo);
    return rc;
  }
  // the block geometry jpeg_read_coefficients would give, without running
  // the entropy decode
  meta[0] = cinfo.num_components;
  meta[1] = (int32_t)cinfo.image_width;
  meta[2] = (int32_t)cinfo.image_height;
  for (int c = 0; c < cinfo.num_components; ++c) {
    jpeg_component_info* ci = &cinfo.comp_info[c];
    int32_t* m = meta + 3 + 4 * c;
    m[0] = ci->h_samp_factor;
    m[1] = ci->v_samp_factor;
    // ceil(comp_width / 8), comp_width = ceil(image_width * h_samp / max_h)
    long cw = ((long)cinfo.image_width * ci->h_samp_factor + cinfo.max_h_samp_factor - 1) /
              cinfo.max_h_samp_factor;
    long ch = ((long)cinfo.image_height * ci->v_samp_factor + cinfo.max_v_samp_factor - 1) /
              cinfo.max_v_samp_factor;
    m[2] = (int32_t)((cw + 7) / 8);
    m[3] = (int32_t)((ch + 7) / 8);
  }
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int pst_jpeg_read_coefs(const uint8_t* src, uint64_t len, int16_t* const* outs,
                        uint16_t* qtabs) {
  return jpeg_read_coefs_one(src, len, outs, qtabs, nullptr);
}

// Batched entropy decode in ONE GIL-released call.  outs[c] points to a
// stacked (n, blocks_h, blocks_w, 64) int16 array whose per-image stride is
// plane_strides[c] int16 elements; qtabs holds n*ncomp*64 uint16s; meta is
// the kJpegMetaLen layout every image must match.  Returns 0, or (1 + index)
// of the first failing image.
int pst_jpeg_coef_batch(const uint8_t* const* srcs, const uint64_t* lens, int n,
                        int16_t* const* outs, const uint64_t* plane_strides, uint16_t* qtabs,
                        const int32_t* meta, int nthreads) {
  const int ncomp = meta[0];
  std::atomic<int> failed{0};
  auto run = [&](int lo, int hi) {
    std::vector<int16_t*> dsts(ncomp);
    for (int i = lo; i < hi; ++i) {
      if (failed.load(std::memory_order_relaxed)) return;
      for (int c = 0; c < ncomp; ++c) dsts[c] = outs[c] + (uint64_t)i * plane_strides[c];
      int rc = jpeg_read_coefs_one(srcs[i], lens[i], dsts.data(),
                                   qtabs + (size_t)i * ncomp * DCTSIZE2, meta);
      if (rc != 0) {
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

}  // extern "C"
