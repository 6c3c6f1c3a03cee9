// Bilinear scale-and-translate of uint8 NHWC images, with an optional
// per-image horizontal flip, on Hopper (sm_90a).
//
// Replaces the XLA-compiled resample of
// petastorm_tpu/ops/augment.py::random_resized_crop (and resize_images, and
// the random_flip that the training step applies after the crop): per image,
// jax.image.scale_and_translate with the triangle kernel, which builds a dense
// (in x out) weight matrix per axis (jax/_src/image/scale.py::
// compute_weight_mat) and contracts the image with both; then round half to
// even and clip to uint8.
//
// For output pixel (oy, ox) of image n, on each axis, with the per-image
// float32 (inv_scale, translation) that the wrapper computes:
//
//     sample = ((o + 0.5) * inv_scale - translation * inv_scale) - 0.5
//     w(i)   = max(0, 1 - |sample - i| / kernel_scale),  i in [0, in)
//     kernel_scale = max(inv_scale, 1) with antialias, else 1
//     weights w(i) / sum_i w(i), all zero when the sum is <= 1000 * FLT_EPSILON
//     or when sample lies outside [-0.5, in - 0.5]
//
//     out[n, oy, flip ? ow-1-ox : ox, c] =
//         clip(rint(sum_ix wx(ix) * sum_iy wy(iy) * in[n, iy, ix, c]), 0, 255)
//
// Only the taps within kernel_scale of `sample` are walked (floor(sample) and
// the next one without antialias; more when an antialiased axis is
// downscaled): the other entries of JAX's dense matrices are zeros and add
// nothing.  The sample position and the tap weights are computed with
// explicitly rounded operations (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn),
// so nvcc cannot contract them into FMAs: a sample moved by one ulp moves the
// rounded byte where the value sits at a .5 boundary.  The sums contract rows first, then
// columns, as the plain version does, with FMAs in increasing tap order.
//
// Two kernels compute this function.
//
// resized_crop_u8_kernel, the general one (any number of taps, so antialiased
// downscales too), gives one thread one output pixel and all its channels.
// Each thread builds both axes' taps and divides each tap weight by the sum
// (six IEEE divisions a pixel), takes its pixel's indices apart with 64-bit
// divisions and moves every byte with a load or store of its own.
//
// resized_crop_u8_tiled_kernel takes only axes of two taps (no antialias:
// every crop of the training step).  At the ImageNet training batch the work
// needs 20.5 MB of source pixels and 38.5 MB of output, 0.018 ms at 3.35 TB/s,
// but both kernels are bound by instructions: the general one computes weights
// that depend only on (image, row) or (image, column), some 300x more often
// than there are such values.  So a block of kThreads threads takes a tile of
// kTileRows output rows x kTileCols output columns of one image, one thread
// per column:
//   - the taps, normalised weights and source row offsets of the tile's rows
//     go into a shared table (kTileRows x 24 bytes, the kernel's only shared
//     memory) and each thread keeps its column's in registers: two divisions
//     per row or column and tile, not six per pixel, and only 32-bit indices
//     taken from blockIdx/threadIdx;
//   - each thread reads its taps' bytes from device memory and stores its
//     pixel's bytes itself; a warp's loads and stores fall on neighbouring
//     addresses, and L1 serves the reuse of a source pixel by neighbouring
//     columns and rows.  Staging the source rectangle or the output tile in
//     shared memory (16-byte copies) was measured slower on the H100;
//   - per pixel no branch and no conversion instruction (those issue at a
//     quarter of the FMA rate): the FMA of a zero weight runs and adds +0,
//     bytes become floats and rounded sums become bytes through the
//     mantissa of 2^23 + v, and C = 3 is a compile-time constant.
// Per pixel it computes the general kernel's values in its order: the same
// make_axis and tap_weight, the same __fdiv_rn(tap_weight(a, i), a.total)
// weights, FMAs over the rows then the columns in increasing tap order, and
// the same round half to even and clip; each change above gives the same
// float or byte exactly.  So the two kernels give the same bytes by
// construction, and chip_smoke.py checks every byte.
// Both are launched on the caller's stream and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4;  // channels accumulated in registers per pass
constexpr float kMinWeightSum = 1000.0f * 1.1920928955078125e-7f;  // 1000 * FLT_EPSILON

struct Axis {
  float sample;
  float kernel_scale;
  float total;  // sum of the unnormalised tap weights
  int lo, hi;   // taps [lo, hi] within the input
  bool zero;    // every weight of this output position is zero
};

__device__ __forceinline__ float tap_weight(const Axis& a, int i) {
  float x = fabsf(__fsub_rn(a.sample, (float)i));
  if (a.kernel_scale != 1.0f) x = __fdiv_rn(x, a.kernel_scale);  // x / 1 is x
  return fmaxf(0.0f, __fsub_rn(1.0f, x));
}

__device__ __forceinline__ Axis make_axis(int o, int in_size, float inv_scale,
                                          float translation, bool antialias) {
  Axis a;
  const float pos = __fmul_rn(__fadd_rn((float)o, 0.5f), inv_scale);
  a.sample = __fsub_rn(__fsub_rn(pos, __fmul_rn(translation, inv_scale)), 0.5f);
  a.kernel_scale = antialias ? fmaxf(inv_scale, 1.0f) : 1.0f;
  a.total = 0.0f;
  a.lo = 0;
  a.hi = -1;
  // false for a NaN sample as well
  const bool inside = a.sample >= -0.5f && a.sample <= (float)in_size - 0.5f;
  a.zero = !inside;
  if (inside) {
    // kernel_scale 1: |sample - i| < 1 only for floor(sample) and the next
    // tap (sample - i is exact there); otherwise one tap of margin each side
    const float lo = a.kernel_scale == 1.0f ? floorf(a.sample)
                                            : floorf(__fsub_rn(a.sample, a.kernel_scale));
    const float hi = a.kernel_scale == 1.0f ? lo + 1.0f
                                            : ceilf(__fadd_rn(a.sample, a.kernel_scale));
    a.lo = lo < 0.0f ? 0 : (int)lo;
    a.hi = hi > (float)(in_size - 1) ? in_size - 1 : (int)hi;
    for (int i = a.lo; i <= a.hi; ++i) a.total = __fadd_rn(a.total, tap_weight(a, i));
    a.zero = !(fabsf(a.total) > kMinWeightSum);
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
resized_crop_u8_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int n,
                       int h, int w, int c, int oh, int ow,
                       const float* __restrict__ params, const uint8_t* __restrict__ flips,
                       bool antialias) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long pixels = (long long)n * oh * ow;
  if (idx >= pixels) return;
  const int ox = (int)(idx % ow);
  const int oy = (int)((idx / ow) % oh);
  const int img = (int)(idx / ((long long)ow * oh));

  const float* p = params + 4 * img;
  const Axis ay = make_axis(oy, h, p[0], p[1], antialias);
  const Axis ax = make_axis(ox, w, p[2], p[3], antialias);

  const int store_x = (flips != nullptr && flips[img]) ? ow - 1 - ox : ox;
  uint8_t* dst = out + (((long long)img * oh + oy) * ow + store_x) * c;
  if (ay.zero || ax.zero) {
    for (int k = 0; k < c; ++k) dst[k] = 0;
    return;
  }
  const uint8_t* src = in + (long long)img * h * w * c;

  for (int c0 = 0; c0 < c; c0 += kChunk) {
    const int nc = c - c0 < kChunk ? c - c0 : kChunk;
    float acc[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int ix = ax.lo; ix <= ax.hi; ++ix) {
      const float wx = __fdiv_rn(tap_weight(ax, ix), ax.total);
      if (wx == 0.0f) continue;
      float col[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int iy = ay.lo; iy <= ay.hi; ++iy) {
        const float wy = __fdiv_rn(tap_weight(ay, iy), ay.total);
        if (wy == 0.0f) continue;
        const uint8_t* px = src + ((long long)iy * w + ix) * c + c0;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          if (k < nc) col[k] = fmaf(wy, (float)px[k], col[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) acc[k] = fmaf(wx, col[k], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < nc) dst[c0 + k] = (uint8_t)fminf(fmaxf(rintf(acc[k]), 0.0f), 255.0f);
    }
  }
}

constexpr int kTileRows = 8;    // R: output rows of a tile
constexpr int kTileCols = 256;  // TW: output columns of a tile, one thread each
static_assert(kTileCols == kThreads, "one thread per tile column");

// A tile row's two row taps: their normalised weights (0: no second tap) and
// the byte offset of each tap's source row from the image's first byte (a
// missing second tap points at the first tap's row).
struct RowTaps {
  float w[2];
  long long off[2];
  bool zero;
};

__shared__ RowTaps s_rows[kTileRows];

// (float)b for a byte b, exactly, without a conversion instruction (those
// issue at a quarter of the FMA rate on sm_90): 2^23 + b has b in its low
// mantissa bits, and the subtraction is exact.
__device__ __forceinline__ float byte_to_float(uint8_t b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), 8388608.0f);
}

// (uint8_t)fminf(fmaxf(rintf(x), 0), 255), exactly: clipping before or after
// rounding half to even gives the same byte, and adding 2^23 to a value in
// [0, 255] rounds it half to even into the low mantissa bits.
__device__ __forceinline__ uint8_t round_clip_byte(float x) {
  const float v = fminf(fmaxf(x, 0.0f), 255.0f);
  return (uint8_t)(__float_as_uint(__fadd_rn(v, 8388608.0f)) & 0xffu);
}

// The tile's pixels in this thread's column, row after row: the general
// kernel's arithmetic in its order.  Source bytes come from src + the row
// tap's offset + xoff (+ c for the second column tap); output bytes go to
// dst + r * row_bytes.  kC is the channel count, or 0 for one known only at
// run time.  The general kernel skips a zero weight; here its FMA runs and
// adds +0 (weights, bytes and partial sums are >= +0 and finite, so
// fmaf(0, b, s) is s), and a missing second tap reads the first tap's bytes.
template <int kC>
__device__ __forceinline__ void tile_pixels(const uint8_t* __restrict__ src,
                                            uint8_t* __restrict__ dst, long long row_bytes,
                                            int c_run, int rows, bool xzero, int xoff,
                                            float wx0, float wx1) {
  const int c = kC ? kC : c_run;
  const float wx[2] = {wx0, wx1};
  const int xtap[2] = {0, wx1 != 0.0f ? c : 0};  // byte offset of each column tap
  for (int r = 0; r < rows; ++r, dst += row_bytes) {
    const RowTaps t = s_rows[r];
    if (t.zero || xzero) {
      for (int k = 0; k < c; ++k) dst[k] = 0;
      continue;
    }
    const uint8_t* row[2] = {src + t.off[0] + xoff, src + t.off[1] + xoff};
    for (int c0 = 0; c0 < c; c0 += kChunk) {
      const int nc = c - c0 < kChunk ? c - c0 : kChunk;
      float acc[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float col[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint8_t* px = row[i] + xtap[j] + c0;
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            if (k < nc) col[k] = fmaf(t.w[i], byte_to_float(px[k]), col[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          if (k < nc) acc[k] = fmaf(wx[j], col[k], acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k < nc) dst[c0 + k] = round_clip_byte(acc[k]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
resized_crop_u8_tiled_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int n,
                             int h, int w, int c, int oh, int ow,
                             const float* __restrict__ params,
                             const uint8_t* __restrict__ flips) {
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTileRows, rows = min(kTileRows, oh - y0);
  const int ox = blockIdx.x * kTileCols + tid;
  const bool active = ox < ow;
  const long long row_bytes = (long long)ow * c;

  for (int img = blockIdx.z; img < n; img += gridDim.z) {
    const float* p = params + 4 * img;
    // this thread's column: its taps and weights, as the general kernel makes them
    bool xzero = true;
    int xoff = 0;
    float wx0 = 0.0f, wx1 = 0.0f;
    if (active) {
      const Axis ax = make_axis(ox, w, p[2], p[3], false);
      xzero = ax.zero;
      if (!xzero) {
        xoff = ax.lo * c;
        wx0 = __fdiv_rn(tap_weight(ax, ax.lo), ax.total);
        if (ax.hi > ax.lo) wx1 = __fdiv_rn(tap_weight(ax, ax.hi), ax.total);
      }
    }
    __syncthreads();  // the previous image's readers of the row table are done
    if (tid < rows) {
      const Axis ay = make_axis(y0 + tid, h, p[0], p[1], false);
      RowTaps t;
      t.zero = ay.zero;
      t.w[0] = t.w[1] = 0.0f;
      t.off[0] = t.off[1] = 0;
      if (!ay.zero) {
        t.w[0] = __fdiv_rn(tap_weight(ay, ay.lo), ay.total);
        if (ay.hi > ay.lo) t.w[1] = __fdiv_rn(tap_weight(ay, ay.hi), ay.total);
        t.off[0] = (long long)ay.lo * w * c;
        t.off[1] = (long long)(t.w[1] != 0.0f ? ay.hi : ay.lo) * w * c;
      }
      s_rows[tid] = t;
    }
    __syncthreads();

    if (active) {
      const bool flip = flips != nullptr && flips[img];
      const uint8_t* src = in + (long long)img * h * w * c;
      uint8_t* dst = out + ((long long)img * oh + y0) * row_bytes +
                     (long long)(flip ? ow - 1 - ox : ox) * c;
      // RGB, the training step's case, with the channel count known to the compiler
      if (c == 3) {
        tile_pixels<3>(src, dst, row_bytes, c, rows, xzero, xoff, wx0, wx1);
      } else {
        tile_pixels<0>(src, dst, row_bytes, c, rows, xzero, xoff, wx0, wx1);
      }
    }
  }
}

}  // namespace

// params: device array of n x 4 floats (inv_scale_y, translation_y,
// inv_scale_x, translation_x); flips: device array of n bytes, or null for no
// flips.  Returns a cudaError_t (0 = launched), or -1 for arguments the
// kernel does not take.
extern "C" int pst_resized_crop_u8(const void* in, void* out, int n, int h, int w, int c,
                                   int oh, int ow, const float* params, const uint8_t* flips,
                                   int antialias, void* stream) {
  if (n < 0 || h < 1 || w < 1 || c < 1 || oh < 1 || ow < 1) return -1;
  if (n == 0) return 0;
  const long long pixels = (long long)n * oh * ow;
  const long long blocks = (pixels + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return -1;
  resized_crop_u8_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n, h, w, c, oh, ow, params,
      flips, antialias != 0);
  return (int)cudaGetLastError();
}

// The tiled kernel: the arguments of pst_resized_crop_u8 without antialias
// (two taps per axis).  Returns a cudaError_t (0 = launched), or -1 for
// arguments the kernel does not take.
extern "C" int pst_resized_crop_tiled_u8(const void* in, void* out, int n, int h, int w, int c,
                                         int oh, int ow, const float* params,
                                         const uint8_t* flips, void* stream) {
  if (n < 0 || h < 1 || w < 1 || c < 1 || oh < 1 || ow < 1) return -1;
  if ((long long)w * c > 0x7fffffffLL) return -1;  // a row's byte offsets are 32-bit
  if (n == 0) return 0;
  const dim3 grid((unsigned)((ow + kTileCols - 1) / kTileCols),
                  (unsigned)((oh + kTileRows - 1) / kTileRows),
                  (unsigned)(n < 65535 ? n : 65535));  // blocks loop over the images
  if (grid.y > 65535u) return -1;
  resized_crop_u8_tiled_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n, h, w, c, oh, ow, params,
      flips);
  return (int)cudaGetLastError();
}
