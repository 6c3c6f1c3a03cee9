// Scale-and-translate of uint8 (and float32) NHWC images with the filters of
// jax.image, with an optional per-image horizontal flip, and its nearest
// resize, on Hopper (sm_90a).
//
// Replaces the XLA-compiled resample of
// petastorm_tpu/ops/augment.py::random_resized_crop (and resize_images, and
// the random_flip that the training step applies after the crop): per image,
// jax.image.scale_and_translate with the triangle kernel (bilinear), Keys
// cubic (a = -0.5), Lanczos 3 or Lanczos 5, which builds a dense (in x out)
// weight matrix per axis (jax/_src/image/scale.py::compute_weight_mat) and
// contracts the image with both; then round half to even and clip to uint8.
// And jax.image.resize(method='nearest') of resize_images: a gather.
//
// For output pixel (oy, ox) of image n, on each axis, with the per-image
// float32 (inv_scale, translation) that the wrapper computes:
//
//     sample = ((o + 0.5) * inv_scale - translation * inv_scale) - 0.5
//     w(i)   = filter(|sample - i| / kernel_scale),  i in [0, in)
//     kernel_scale = max(inv_scale, 1) with antialias, else 1
//     weights w(i) / sum_i w(i), all zero when |sum| <= 1000 * FLT_EPSILON
//     or when sample lies outside [-0.5, in - 0.5]
//
//     out[n, oy, flip ? ow-1-ox : ox, c] =
//         clip(rint(sum_ix wx(ix) * sum_iy wy(iy) * in[n, iy, ix, c]), 0, 255)
//
// Only the taps within radius x kernel_scale of `sample` are walked (the
// filter's radius: 1, 2, 3 or 5; floor(sample) and the next tap for bilinear
// without antialias): the other entries of JAX's dense matrices are zeros
// and add nothing.  The sample position and the tap weights are computed
// with explicitly rounded operations (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn), so nvcc cannot contract them into FMAs: a sample moved by one
// ulp moves the rounded byte where the value sits at a .5 boundary.  The
// sums contract rows first, then columns, as the plain version does, with
// FMAs in increasing tap order.
//
// Four kernels compute the resample; each gives the others' bytes.
//
// resized_crop_kernel<T, F>, the general one (any filter, any number of
// taps), gives one thread one output pixel and all its channels.  No uint8
// path launches it: its uint8 instances are the byte oracle the other
// kernels are held to.  Its float32 instances (float32 in and out, the same
// arithmetic without the final round and clip) take every image that is not
// uint8; the wrapper converts other dtypes to float32 and back, as the
// reference does.  Each thread builds both axes' taps and divides each tap
// weight by the sum, takes its pixel's indices apart with 64-bit divisions
// and walks taps_y x taps_x source pixels: it is bound by instructions, some
// 10x above the other kernels, and Lanczos 5 with antialias at 224 -> 160
// walks about 225 source pixels a pixel.
//
// resized_crop_u8_tiled_kernel takes bilinear without antialias: two taps an
// axis, every crop of the training step.  A block of kThreads threads takes
// a tile of kTileRows output rows x kTileCols output columns of one image,
// one thread per column:
//   - the taps, normalised weights and source row offsets of the tile's rows
//     go into a shared table (kTileRows x 24 bytes) and each thread keeps its
//     column's in registers: two divisions per row or column and tile, and
//     only 32-bit indices taken from blockIdx/threadIdx;
//   - each thread reads its taps' bytes from device memory and stores its
//     pixel's bytes itself; L1 serves the reuse of a source pixel by
//     neighbouring columns and rows (staging the source rectangle or the
//     output tile in shared memory was measured slower on the H100);
//   - per pixel no branch and no conversion instruction: the FMA of a zero
//     weight runs and adds +0, bytes become floats and rounded sums bytes
//     through the mantissa of 2^23 + v, and C = 3 is a compile-time constant.
// It is bound by instructions and latency, at about a quarter of its bytes'
// bound (PERF.md).
//
// The separable tiled kernel takes bilinear with antialias, and cubic,
// Lanczos 3 and Lanczos 5 with or without (2-3 taps an axis at the 256 -> 224
// bilinear evaluation resize; 5-6, 8-9 and 14-15 for the three filters at
// 224 -> 160 with antialias; 4, 6-7 and 10-11 without; hundreds at a steep
// antialiased downscale).  The weights depend only on (image, row) or
// (image, column), and the vertical sum col = sum_iy wy(iy) * px(iy, ix) of
// an output row and a source column does not depend on the output column.
// So:
//   - a pre-pass (resample_axes_kernel<F>, one thread an axis) writes every
//     image's row and column Axis and normalised weights to device scratch,
//     each axis's taps trimmed to its first and last nonzero weight: each
//     weight, with its two sinf for Lanczos, once an (image, row) or (image,
//     column), not once a pixel; once a row or column for all images when
//     they share their params (resize_images);
//   - a block takes a tile of R output rows x TW output columns of one image
//     (augment.aa_launch_plan sizes them, and the tables' capacity for the
//     filter's radius, from the shapes, the filter and antialias alone,
//     within 232,448 B of dynamic shared memory);
//   - vertical pass (resample_u8_separable_kernel): a warp a tile row, its
//     weights in registers, its lanes on neighbouring bytes of the span
//     [first tap of the first nonzero column, last tap of the last]
//     (coalesced; 4-byte words from 7 taps on, when the image's rows start
//     on 4-byte boundaries and one group holds every channel): col in shared memory
//     (float32), the FMA chain over the row's taps in increasing iy from
//     0.0f, specialised on the row's tap count (each count up to 16) so that
//     its loads are in flight together;
//   - horizontal pass: a thread a tile column, its weights in registers, row
//     after row: acc = the FMA chain of wx * col over a window of the tap
//     count's neighbouring source columns that holds the column's taps, the
//     others with weight 0, in increasing ix, then round_clip_byte, stored
//     at the flipped column when the image is flipped; a warp's columns share
//     the largest tap count among them, so no lane branches;
//   - about taps_y + taps_x FMAs a pixel and channel, not taps_y x taps_x.
// A span wider than the plan's chunk is walked in chunks in increasing
// column, each pixel's acc carried in shared memory from one chunk to the
// next; a tap beyond a table's capacity is computed as the table would hold
// it (tap_weight_of, the filter known at run time); so any shape and any
// params run without reading past a table.  It is bound by instructions and
// latency, not bytes: the vertical pass turns each byte of the span into a
// float once a tap row, the horizontal pass reads each sum from shared
// memory once a tap and channel (PERF.md gives the split).
//
// Byte-identical to the general kernel by construction, for weights of
// either sign.  col for (oy, ix) is the FMA chain the general kernel runs
// inside its ix loop, with the same weights (tap_weight<F>, make_axis's
// total summed in its order, then __fdiv_rn(tap_weight<F>(a, i), a.total))
// in the same order, and acc is its outer chain in the same order, carried
// across chunks as the same float.  The general kernel skips a zero weight;
// here a trimmed end tap is not walked, and a zero weight in the chain (a
// tap past a row's count, a window column that is no tap of its column, an
// interior zero) runs its FMA.  That FMA adds nothing: a chain starts at
// +0.0f, and under round to nearest a sum is -0 only when both addends are
// -0, so no partial sum is ever -0; then fmaf(+-0, b, s) = (+-0) + s = s
// for every finite b and every s that is not -0.  Cubic and Lanczos weights
// are negative on their outer lobes, so partial sums may be negative or
// exceed 255; bytes and sums stay finite, and round_clip_byte clips before it
// rounds, which gives the byte the general kernel's rint-then-clip gives.
// A zero row or column (ay.zero, ax.zero) gives zero bytes, as there.
// chip_smoke.py checks every byte.
//
// The nearest gather picks source pixel (floor(float32((oy + 0.5) * h) / oh),
// the same of ox) of its image, in float32 as jax computes it, clamped to
// the input as jax's gather clamps an index.  A block takes a tile of output
// rows of an image and computes its rows' and columns' source offsets once
// into shared memory, 32-bit within an image; resize_nearest_rows_kernel
// then writes the tile's rows as 16-, 4- or 1-byte words, as the row bytes
// and the output's alignment allow, for a pixel of any size,
// assembling each word's bytes from the source row.  It moves each picked
// source byte and each output byte once; L1 and L2 serve a source row's
// reuse by neighbouring output rows.
//
// All are launched on the caller's stream and allocate nothing (the
// pre-pass's scratch comes from the wrapper).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4;  // channels accumulated in registers per pass
constexpr int kWeightCache = 32;  // row weights a pixel of the general kernel keeps
constexpr float kMinWeightSum = 1000.0f * 1.1920928955078125e-7f;  // 1000 * FLT_EPSILON

struct Axis {
  float sample;
  float kernel_scale;
  float total;  // sum of the unnormalised tap weights
  int lo, hi;   // taps [lo, hi] within the input
  bool zero;    // every weight of this output position is zero
};

// The filters of jax.image (jax/_src/image/scale.py): kTriangle is
// _fill_triangle_kernel (bilinear), kKeysCubic _fill_keys_cubic_kernel (Keys,
// a = -0.5), kLanczos3 and kLanczos5 _fill_lanczos_kernel(radius, x), each on
// x = |sample - i| / kernel_scale >= 0, in jax's float32 expressions in its
// order.  Cubic and Lanczos weights are negative on their outer lobes.
constexpr int kTriangle = 0, kKeysCubic = 1, kLanczos3 = 2, kLanczos5 = 3;
constexpr float kPi = 3.14159265358979323846f;          // np.pi as float32
constexpr float kPiSquared = 9.8696044010893586188f;    // np.pi ** 2 as float32

template <int F>
struct FilterRadius;  // the support: the weight is 0 for x past it
template <> struct FilterRadius<kTriangle> { static constexpr float value = 1.0f; };
template <> struct FilterRadius<kKeysCubic> { static constexpr float value = 2.0f; };
template <> struct FilterRadius<kLanczos3> { static constexpr float value = 3.0f; };
template <> struct FilterRadius<kLanczos5> { static constexpr float value = 5.0f; };

template <int F>
__device__ __forceinline__ float filter_value(float x) {
  if constexpr (F == kTriangle) {
    return fmaxf(0.0f, __fsub_rn(1.0f, x));
  } else if constexpr (F == kKeysCubic) {
    // ((1.5 x - 2.5) x) x + 1; ((-0.5 x + 2.5) x - 4) x + 2 from 1; 0 from 2
    if (x >= 2.0f) return 0.0f;
    if (x >= 1.0f)
      return __fadd_rn(__fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(__fmul_rn(-0.5f, x), 2.5f), x),
                                           4.0f), x), 2.0f);
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(1.5f, x), 2.5f), x), x), 1.0f);
  } else {
    // r sin(pi x) sin(pi x / r) / (pi^2 x^2) for x > 1e-3, 1 below, 0 past r;
    // sinf, not the fast __sinf (full range reduction, within 2 ulp)
    constexpr float r = FilterRadius<F>::value;
    if (x > r) return 0.0f;
    if (!(x > 1e-3f)) return 1.0f;
    const float px = __fmul_rn(kPi, x);
    const float y = __fmul_rn(__fmul_rn(r, sinf(px)), sinf(__fdiv_rn(px, r)));
    return __fdiv_rn(y, __fmul_rn(kPiSquared, __fmul_rn(x, x)));
  }
}

template <int F = kTriangle>
__device__ __forceinline__ float tap_weight(const Axis& a, int i) {
  float x = fabsf(__fsub_rn(a.sample, (float)i));
  if (a.kernel_scale != 1.0f) x = __fdiv_rn(x, a.kernel_scale);  // x / 1 is x
  return filter_value<F>(x);
}

// The sample, kernel scale and taps [lo, hi] of output position o; zero
// when the sample lies outside the input (total still 0).
template <int F = kTriangle>
__device__ __forceinline__ Axis axis_taps(int o, int in_size, float inv_scale,
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
    float lo, hi;
    if (F == kTriangle && a.kernel_scale == 1.0f) {
      // |sample - i| < 1 only for floor(sample) and the next tap (sample - i
      // is exact there)
      lo = floorf(a.sample);
      hi = lo + 1.0f;
    } else {
      // the filter's support, radius x kernel_scale each side, and a tap of
      // margin for the rounding of the ends
      const float span = __fmul_rn(FilterRadius<F>::value, a.kernel_scale);
      lo = floorf(__fsub_rn(a.sample, span));
      hi = ceilf(__fadd_rn(a.sample, span));
    }
    a.lo = lo < 0.0f ? 0 : (int)lo;
    a.hi = hi > (float)(in_size - 1) ? in_size - 1 : (int)hi;
  }
  return a;
}

template <int F = kTriangle>
__device__ __forceinline__ Axis make_axis(int o, int in_size, float inv_scale,
                                          float translation, bool antialias) {
  Axis a = axis_taps<F>(o, in_size, inv_scale, translation, antialias);
  if (!a.zero) {
    for (int i = a.lo; i <= a.hi; ++i) a.total = __fadd_rn(a.total, tap_weight<F>(a, i));
    a.zero = !(fabsf(a.total) > kMinWeightSum);
  }
  return a;
}

// The stored value of a sum: rounded half to even and clipped for uint8,
// as it is for float32.
__device__ __forceinline__ uint8_t store_value(float v, uint8_t) {
  return (uint8_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}
__device__ __forceinline__ float store_value(float v, float) { return v; }

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
resized_crop_kernel(const T* __restrict__ in, T* __restrict__ out, int n, int h, int w, int c,
                    int oh, int ow, const float* __restrict__ params,
                    const uint8_t* __restrict__ flips, bool antialias) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long pixels = (long long)n * oh * ow;
  if (idx >= pixels) return;
  const int ox = (int)(idx % ow);
  const int oy = (int)((idx / ow) % oh);
  const int img = (int)(idx / ((long long)ow * oh));

  const float* p = params + 4 * img;
  const Axis ay = make_axis<F>(oy, h, p[0], p[1], antialias);
  const Axis ax = make_axis<F>(ox, w, p[2], p[3], antialias);

  const int store_x = (flips != nullptr && flips[img]) ? ow - 1 - ox : ox;
  T* dst = out + (((long long)img * oh + oy) * ow + store_x) * c;
  if (ay.zero || ax.zero) {
    for (int k = 0; k < c; ++k) dst[k] = T(0);
    return;
  }
  const T* src = in + (long long)img * h * w * c;
  // the other filters' row weights, each computed once a pixel (two sinf for
  // Lanczos), not once a column tap: the same values, the same order
  float wy_cache[F == kTriangle ? 1 : kWeightCache];
  if constexpr (F != kTriangle) {
    for (int j = 0; j < kWeightCache && ay.lo + j <= ay.hi; ++j)
      wy_cache[j] = __fdiv_rn(tap_weight<F>(ay, ay.lo + j), ay.total);
  }

  for (int c0 = 0; c0 < c; c0 += kChunk) {
    const int nc = c - c0 < kChunk ? c - c0 : kChunk;
    float acc[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int ix = ax.lo; ix <= ax.hi; ++ix) {
      const float wx = __fdiv_rn(tap_weight<F>(ax, ix), ax.total);
      if (wx == 0.0f) continue;
      float col[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int iy = ay.lo; iy <= ay.hi; ++iy) {
        const float wy = F != kTriangle && iy - ay.lo < kWeightCache
                             ? wy_cache[F == kTriangle ? 0 : iy - ay.lo]
                             : __fdiv_rn(tap_weight<F>(ay, iy), ay.total);
        if (wy == 0.0f) continue;
        const T* px = src + ((long long)iy * w + ix) * c + c0;
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
      if (k < nc) dst[c0 + k] = store_value(acc[k], T());
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

// -- the separable tiled kernel --------------------------------------------

// The launch plan's sizes (the wrapper's aa_launch_plan): tile rows and
// columns, the tap capacity of each axis's weight table, the source columns
// of one span chunk and the channels of one group.
struct AaPlan {
  int rows, cols, cap_y, cap_x, span, group;
};

// Dynamic shared memory of a block: the tile's row and column axes, the
// vertical sums of one span chunk and the horizontal sums carried from one
// chunk to the next.
__host__ __device__ inline long long aa_shared_bytes(const AaPlan& p) {
  return (long long)sizeof(Axis) * (p.rows + p.cols) +
         4LL * ((long long)p.rows * p.span * p.group + (long long)p.rows * p.cols * p.group);
}

// The axis tables in device memory, from the pre-pass: per image its oh row
// axes then its ow column axes, and their normalised weights, cap_y a row
// and cap_x a column; filter is the filter they were made with.  shared:
// every image has the first image's params, so only its tables are made
// and every image reads them (resize_images).
struct AaTables {
  Axis* axes;
  float* weights;
  int oh, ow, cap_y, cap_x, filter;
  bool shared;
  __host__ __device__ long long axes_count(int n) const { return (long long)n * (oh + ow); }
  __host__ __device__ long long weights_count(int n) const {
    return (long long)n * ((long long)oh * cap_y + (long long)ow * cap_x);
  }
  __device__ const Axis& row(int img, int o) const { return axes[(long long)img * (oh + ow) + o]; }
  __device__ const Axis& col(int img, int o) const {
    return axes[(long long)img * (oh + ow) + oh + o];
  }
  __device__ float* row_weights(int img, int o) const {
    return weights + img * ((long long)oh * cap_y + (long long)ow * cap_x) + (long long)o * cap_y;
  }
  __device__ float* col_weights(int img, int o) const {
    return weights + img * ((long long)oh * cap_y + (long long)ow * cap_x) +
           (long long)oh * cap_y + (long long)o * cap_x;
  }
};

// make_axis<F>, its taps trimmed to the first and the last nonzero weight (a
// zero weight's FMA at either end of a chain adds nothing), and its
// normalised weights in table[0, cap): one walk over the taps sums
// make_axis's total in its order and keeps the unnormalised weights from the
// first nonzero one on, then each is divided by the total.
template <int F>
__device__ __forceinline__ Axis make_table_axis(int o, int in_size, float inv_scale,
                                                float translation, bool antialias, float* table,
                                                int cap) {
  Axis a = axis_taps<F>(o, in_size, inv_scale, translation, antialias);
  if (a.zero) return a;
  int first = -1, last = -1;
  for (int i = a.lo; i <= a.hi; ++i) {
    const float t = tap_weight<F>(a, i);
    a.total = __fadd_rn(a.total, t);
    if (t != 0.0f) {
      if (first < 0) first = i;
      last = i;
    }
    if (first >= 0 && i - first < cap) table[i - first] = t;
  }
  a.zero = !(fabsf(a.total) > kMinWeightSum);
  if (!a.zero) {  // a nonzero total: some tap's weight is nonzero
    a.lo = first;
    a.hi = last;
    for (int j = 0; j <= last - first && j < cap; ++j) table[j] = __fdiv_rn(table[j], a.total);
  }
  return a;
}

// Blocks of the separable kernel resident on an SM: at most 64 registers a
// thread (measured faster than 80 registers and 3 blocks, and than 48 with
// spills).
constexpr int kAaBlocksPerSm = 4;

// The pre-pass: every image's row and column axes, one thread each, with
// filter F and the caller's antialias.
template <int F>
__global__ void __launch_bounds__(kThreads)
resample_axes_kernel(int n, int h, int w, const float* __restrict__ params, bool antialias,
                     AaTables t) {
  const long long count = t.axes_count(n);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    const int img = (int)(i / (t.oh + t.ow)), o = (int)(i - (long long)img * (t.oh + t.ow));
    const float* p = params + 4 * img;
    t.axes[i] = o < t.oh ? make_table_axis<F>(o, h, p[0], p[1], antialias,
                                              t.row_weights(img, o), t.cap_y)
                         : make_table_axis<F>(o - t.oh, w, p[2], p[3], antialias,
                                              t.col_weights(img, o - t.oh), t.cap_x);
  }
}

// tap_weight with the filter known at run time: only taps past a table's
// capacity take it, so the tiled kernel has one instance for every filter.
__device__ __noinline__ float tap_weight_of(int filter, const Axis& a, int i) {
  switch (filter) {
    case kKeysCubic: return tap_weight<kKeysCubic>(a, i);
    case kLanczos3: return tap_weight<kLanczos3>(a, i);
    case kLanczos5: return tap_weight<kLanczos5>(a, i);
    default: return tap_weight<kTriangle>(a, i);
  }
}

// Tap j of axis a, normalised: from the table below its capacity, else
// computed as the table would hold it (so no shape reads past a table).
__device__ __forceinline__ float table_weight(const Axis& a, const float* table, int cap, int j,
                                              int filter) {
  return j < cap ? table[j] : __fdiv_rn(tap_weight_of(filter, a, a.lo + j), a.total);
}

// The most taps a row or a column walks with its count known to the
// compiler (an instance each); past it, the loop over any number.  The
// kernel has an instance for tables of up to 8 taps (bilinear, cubic) and
// one for up to 16 (Lanczos): the cases of 9-16 taps raise every path's
// register pressure (spills at 64 registers), which slows the narrow
// filters.
constexpr int kMaxTapCase = 16, kNarrowTapCase = 8;

// Vertical pass of one tile row over `elems` span bytes (ng channels of each
// source column), lanes on neighbouring bytes: col = the FMA chain over the
// row's taps in increasing iy.  kT > 0: exactly kT taps, all in the
// table, their weights in registers and their loads in flight at once;
// kT = 0: any.  kFlat: the group holds every channel
// (ng == c == group), so element q is byte q of the span and sum q.
template <int kT, bool kFlat>
__device__ __forceinline__ void aa_vertical_row(const Axis& ay, const float* wy, int cap,
                                                int filter, const uint8_t* row0,
                                                long long row_bytes, float* col_r, int elems,
                                                int ng, int c, int group, int lane) {
  const int taps = ay.hi - ay.lo + 1;
  if (kT == 0) {
    for (int q = lane; q < elems; q += 32) {
      const int ix = q / ng, k = q - ix * ng;
      const uint8_t* px = row0 + (long long)ix * c + k;
      float col = 0.0f;
      for (int j = 0; j < taps; ++j, px += row_bytes)
        col = fmaf(table_weight(ay, wy, cap, j, filter), byte_to_float(*px), col);
      col_r[ix * group + k] = col;
    }
    return;
  }
  constexpr int kTaps = kT > 0 ? kT : 1;
  float wr[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) wr[j] = wy[j];
  for (int q = lane; q < elems; q += 32) {
    const int ix = kFlat ? q : q / ng, k = kFlat ? 0 : q - ix * ng;
    const uint8_t* px = row0 + (kFlat ? q : (long long)ix * c + k);
    float b[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      b[j] = byte_to_float(px[j * row_bytes]);
    float col = 0.0f;
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      col = fmaf(wr[j], b[j], col);
    col_r[kFlat ? q : ix * group + k] = col;
  }
}

// (float)byte k of v, exactly: byte_to_float with the byte picked by one
// byte permute.
__device__ __forceinline__ float word_byte_to_float(uint32_t v, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440u | k)), 8388608.0f);
}

// The vertical pass reads 4-byte words for rows of at least kWordTaps taps
// (measured faster from Lanczos 3 on; a byte a load is faster below), where
// the image's rows start on 4-byte boundaries, so that a word holding a byte
// of a row lies in that row.
constexpr int kWordTaps = 7;

// aa_vertical_row for a group holding every channel (kFlat) over rows that
// start on 4-byte boundaries: each lane loads the aligned 4-byte words of
// the span, a word a tap row, and runs the four bytes' FMA chains (the same
// chains as the byte loads give); a byte outside the span is not stored.
template <int kT>
__device__ __forceinline__ void aa_vertical_row_words(const Axis& ay, const float* wy,
                                                      const uint8_t* row0, long long row_bytes,
                                                      float* col_r, int elems, int lane) {
  const int a0 = (int)(reinterpret_cast<uintptr_t>(row0) & 3);
  const uint32_t* base = reinterpret_cast<const uint32_t*>(row0 - a0);
  const long long row_words = row_bytes >> 2;
  float wr[kT];
#pragma unroll
  for (int j = 0; j < kT; ++j) wr[j] = wy[j];
  const int words = (elems + a0 + 3) >> 2;
  for (int p = lane; p < words; p += 32) {
    uint32_t v[kT];
#pragma unroll
    for (int j = 0; j < kT; ++j) v[j] = base[p + j * row_words];
    float col[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kT; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) col[k] = fmaf(wr[j], word_byte_to_float(v[j], k), col[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = 4 * p + k - a0;
      if (q >= 0 && q < elems) col_r[q] = col[k];
    }
  }
}

// Horizontal pass of one tile column over rows r0, r0 + dr, ...: acc = the
// FMA chain of wx * col over the column's taps among this chunk's source
// columns [a, a + len), in increasing ix, carried from the chunk before
// (unless first); in the last chunk the rounded bytes go to dst + r *
// out_row_bytes.  kT > 0 (and len >= kT): the chain walks a window of kT
// neighbouring source columns of the chunk that holds every tap of the
// column in it, the window's other columns with weight 0, so the sums' offsets
// are the same for every row (constants when kG, the group, is known) and no
// lane branches.  kT = 0: any number of taps, walked one by one.
template <int kT, int kG>
__device__ __forceinline__ void aa_horizontal_col(
    const Axis& ax, const float* wx, int cap, int filter, const Axis* s_ay, const float* s_col,
    float* carry, int span, int group_run, int cols, int r0, int dr, int rows, int a, int len,
    int ng, bool first, bool last, uint8_t* dst, long long out_row_bytes) {
  const int group = kG ? kG : group_run;
  const int taps = ax.hi - ax.lo + 1;
  constexpr int kTaps = kT > 0 ? kT : 1;
  float wr[kTaps];
  int start = a;  // the window's first source column
  if (kT > 0) {
    start = min(max(ax.lo, a), a + len - kT);
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const int t = start + j - ax.lo;  // the window column's tap, if it is one
      wr[j] = !ax.zero && t >= 0 && t < taps ? wx[t] : 0.0f;
    }
  }
  for (int r = r0; r < rows; r += dr) {
    float acc[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
    float* carry_r = carry + r * cols * group;
    if (!first) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (k < ng) acc[k] = carry_r[k];
    }
    const bool zero = ax.zero || s_ay[r].zero;
    if (!zero) {
      const float* col_r = s_col + r * span * group;  // the sums of source columns a, a + 1, ...
      if (kT > 0) {
        const float* win = col_r + (start - a) * group;
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
#pragma unroll
          for (int k = 0; k < kChunk; ++k)
            if (k < ng) acc[k] = fmaf(wr[j], win[j * group + k], acc[k]);
        }
      } else {
        for (int ix = max(a, ax.lo); ix <= min(a + len - 1, ax.hi); ++ix) {
          const float wj = table_weight(ax, wx, cap, ix - ax.lo, filter);
#pragma unroll
          for (int k = 0; k < kChunk; ++k)
            if (k < ng) acc[k] = fmaf(wj, col_r[(ix - a) * group + k], acc[k]);
        }
      }
    }
    if (last) {
      uint8_t* d = dst + r * out_row_bytes;
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (k < ng) d[k] = zero ? 0 : round_clip_byte(acc[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (k < ng) carry_r[k] = acc[k];
    }
  }
}

template <int kC, int kMaxT>
__global__ void __launch_bounds__(kThreads, kAaBlocksPerSm)
resample_u8_separable_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int n,
                             int h, int w, int c_run, int oh, int ow,
                             const uint8_t* __restrict__ flips, AaPlan plan, AaTables tables) {
  extern __shared__ float4 s_dyn[];
  Axis* s_ay = reinterpret_cast<Axis*>(s_dyn);
  Axis* s_ax = s_ay + plan.rows;
  float* s_col = reinterpret_cast<float*>(s_ax + plan.cols);
  float* s_acc = s_col + plan.rows * plan.span * plan.group;
  __shared__ int s_lo[kThreads / 32], s_hi[kThreads / 32];

  const int c = kC ? kC : c_run;
  const int x0 = blockIdx.x * plan.cols, cols = min(plan.cols, ow - x0);
  const int tiles_y = (oh + plan.rows - 1) / plan.rows;
  const long long row_bytes = (long long)w * c, out_row_bytes = (long long)ow * c;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  // horizontal pass: threads_per_col threads share a column, over rows
  // r0, r0 + threads_per_col, ...
  const int threads_per_col = max(1, (int)blockDim.x / plan.cols);
  // word loads in the vertical pass: every channel in one group, rows on 4-byte boundaries
  const bool words = kC != 0 && row_bytes % 4 == 0 && (reinterpret_cast<uintptr_t>(in) & 3) == 0;

  // (each tile's work ends with a barrier, so its readers of the shared
  // arrays are done before the next tile writes them)
  for (int img = blockIdx.z; img < n; img += gridDim.z)
  for (int ty = blockIdx.y; ty < tiles_y; ty += gridDim.y) {
    const int y0 = ty * plan.rows, rows = min(plan.rows, oh - y0);
    const int timg = tables.shared ? 0 : img;  // the image whose tables hold this one's
    // the tile's axes from the pre-pass; the span of its nonzero columns'
    // taps reduced in each warp, then over the warps
    for (int t = blockDim.x - 1 - threadIdx.x; t < rows && t >= 0; t += blockDim.x)
      s_ay[t] = tables.row(timg, y0 + t);
    int lo = 0x7fffffff, hi = -1;
    for (int t = threadIdx.x; t < cols; t += blockDim.x) {
      const Axis ax = tables.col(timg, x0 + t);
      s_ax[t] = ax;
      if (!ax.zero) {
        lo = min(lo, ax.lo);
        hi = max(hi, ax.hi);
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      s_lo[threadIdx.x >> 5] = lo;
      s_hi[threadIdx.x >> 5] = hi;
    }
    __syncthreads();
    for (int i = 0; i < warps; ++i) {
      lo = min(lo, s_lo[i]);
      hi = max(hi, s_hi[i]);
    }
    // the source columns of the tile's nonzero columns' taps (none: len <= 0)
    const int span_lo = lo, span_len = hi - lo + 1;
    const bool flip = flips != nullptr && flips[img];
    const uint8_t* src = in + (long long)img * h * row_bytes;
    uint8_t* dst_img = out + (long long)img * oh * out_row_bytes;

    for (int c0 = 0; c0 < c; c0 += plan.group) {
      const int ng = kC ? kC : min(plan.group, c - c0);
      // span chunks in increasing source column; one pass when the span is empty
      for (int s0 = 0;; s0 += plan.span) {
        const int len = min(plan.span, span_len - s0);
        const bool last = s0 + plan.span >= span_len;
        // vertical: warp w takes tile rows w, w + warps, ...
        for (int r = threadIdx.x >> 5; r < rows && len > 0; r += warps) {
          const Axis ay = s_ay[r];
          if (ay.zero) continue;
          const int taps = ay.hi - ay.lo + 1;
          const float* wy = tables.row_weights(timg, y0 + r);
          const uint8_t* row0 = src + (long long)ay.lo * row_bytes +
                                (long long)(span_lo + s0) * c + c0;
          float* col_r = s_col + r * plan.span * plan.group;
#define PST_AA_VERTICAL(T)                                                                   \
  {                                                                                        \
    constexpr int kTv = T <= kMaxT ? T : 0;                                                \
    if (words && kTv >= kWordTaps)                                                         \
      aa_vertical_row_words<(kTv > 0 ? kTv : 1)>(ay, wy, row0, row_bytes, col_r, len * ng, \
                                                 lane);                                    \
    else                                                                                   \
      aa_vertical_row<kTv, kC != 0>(ay, wy, tables.cap_y, tables.filter, row0, row_bytes,  \
                                    col_r, len * ng, ng, c, plan.group, lane);             \
  }
          switch (taps > tables.cap_y || taps > kMaxT ? 0 : taps) {
            case 1: PST_AA_VERTICAL(1) break;
            case 2: PST_AA_VERTICAL(2) break;
            case 3: PST_AA_VERTICAL(3) break;
            case 4: PST_AA_VERTICAL(4) break;
            case 5: PST_AA_VERTICAL(5) break;
            case 6: PST_AA_VERTICAL(6) break;
            case 7: PST_AA_VERTICAL(7) break;
            case 8: PST_AA_VERTICAL(8) break;
            case 9: PST_AA_VERTICAL(9) break;
            case 10: PST_AA_VERTICAL(10) break;
            case 11: PST_AA_VERTICAL(11) break;
            case 12: PST_AA_VERTICAL(12) break;
            case 13: PST_AA_VERTICAL(13) break;
            case 14: PST_AA_VERTICAL(14) break;
            case 15: PST_AA_VERTICAL(15) break;
            case 16: PST_AA_VERTICAL(16) break;
            default: PST_AA_VERTICAL(0) break;
          }
#undef PST_AA_VERTICAL
        }
        __syncthreads();
        // horizontal: each column's weights in registers, its pixels row
        // after row; a warp's lanes move together, to agree on a tap count
        for (int t0 = threadIdx.x - lane; t0 < cols * threads_per_col; t0 += blockDim.x) {
          const int t = t0 + lane;
          const bool active = t < cols * threads_per_col;
          const int x = active ? t % cols : 0, r0 = active ? t / cols : rows;
          const Axis ax = s_ax[x];
          const int taps = ax.hi - ax.lo + 1, ox = x0 + x;
          const int need = !active || ax.zero ? 0 : taps <= tables.cap_x ? taps : 0x7fffffff;
          const int most = __reduce_max_sync(0xffffffffu, need);
          if (!active) continue;
          const float* wx = tables.col_weights(timg, ox);
          float* carry = s_acc + x * plan.group;
          uint8_t* dst = dst_img + (long long)y0 * out_row_bytes +
                         (long long)(flip ? ow - 1 - ox : ox) * c + c0;
          const int a = span_lo + s0;
          const int kt = most == 0 ? 1 : most > kMaxT ? 0 : most;
#define PST_AA_HORIZONTAL(T)                                                                  \
  aa_horizontal_col<(T <= kMaxT ? T : 0), kC>(ax, wx, tables.cap_x, tables.filter, s_ay, s_col,  \
                                              carry, plan.span, plan.group, plan.cols, r0,     \
                                              threads_per_col, rows, a, len, ng, s0 == 0, last, \
                                              dst, out_row_bytes)
          switch (kt > len ? 0 : kt) {
            case 1: PST_AA_HORIZONTAL(1); break;
            case 2: PST_AA_HORIZONTAL(2); break;
            case 3: PST_AA_HORIZONTAL(3); break;
            case 4: PST_AA_HORIZONTAL(4); break;
            case 5: PST_AA_HORIZONTAL(5); break;
            case 6: PST_AA_HORIZONTAL(6); break;
            case 7: PST_AA_HORIZONTAL(7); break;
            case 8: PST_AA_HORIZONTAL(8); break;
            case 9: PST_AA_HORIZONTAL(9); break;
            case 10: PST_AA_HORIZONTAL(10); break;
            case 11: PST_AA_HORIZONTAL(11); break;
            case 12: PST_AA_HORIZONTAL(12); break;
            case 13: PST_AA_HORIZONTAL(13); break;
            case 14: PST_AA_HORIZONTAL(14); break;
            case 15: PST_AA_HORIZONTAL(15); break;
            case 16: PST_AA_HORIZONTAL(16); break;
            default: PST_AA_HORIZONTAL(0); break;
          }
#undef PST_AA_HORIZONTAL
        }
        __syncthreads();  // the next chunk, group or tile overwrites the sums
        if (last) break;
      }
    }
  }
}

constexpr long long kMaxSharedBytes = 232448;   // an sm_90 block's dynamic shared memory
constexpr long long kDefaultSharedBytes = 48 * 1024;

// Device scratch of the pre-pass's tables (augment.AaPlan.scratch_bytes).
long long aa_scratch_bytes(int n, int oh, int ow, int cap_y, int cap_x) {
  const AaTables t{nullptr, nullptr, oh, ow, cap_y, cap_x, kTriangle, false};
  return t.axes_count(n) * (long long)sizeof(Axis) + 4 * t.weights_count(n);
}

template <int F>
cudaError_t launch_axes(const AaTables& tables, cudaStream_t stream, int n, int h, int w,
                        const float* params, bool antialias) {
  const long long blocks = (tables.axes_count(tables.shared ? 1 : n) + kThreads - 1) / kThreads;
  resample_axes_kernel<F><<<(unsigned)(blocks < 65535 ? blocks : 65535), kThreads, 0, stream>>>(
      tables.shared ? 1 : n, h, w, params, antialias, tables);
  return cudaGetLastError();
}

template <int kC, int kMaxT>
int launch_separable(const dim3& grid, const AaPlan& plan, const AaTables& tables,
                     cudaStream_t stream, const uint8_t* in, uint8_t* out, int n, int h, int w,
                     int c, int oh, int ow, const float* params, const uint8_t* flips,
                     bool antialias) {
  cudaError_t err;
  switch (tables.filter) {
    case kTriangle: err = launch_axes<kTriangle>(tables, stream, n, h, w, params, antialias); break;
    case kKeysCubic: err = launch_axes<kKeysCubic>(tables, stream, n, h, w, params, antialias); break;
    case kLanczos3: err = launch_axes<kLanczos3>(tables, stream, n, h, w, params, antialias); break;
    default: err = launch_axes<kLanczos5>(tables, stream, n, h, w, params, antialias); break;
  }
  if (err != cudaSuccess) return (int)err;
  const long long bytes = aa_shared_bytes(plan);
  if (bytes > kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(resample_u8_separable_kernel<kC, kMaxT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  resample_u8_separable_kernel<kC, kMaxT><<<grid, kThreads, (size_t)bytes, stream>>>(
      in, out, n, h, w, c, oh, ow, flips, plan, tables);
  return (int)cudaGetLastError();
}

// -- the nearest gather ----------------------------------------------------

constexpr int kNearestCols = 2048;  // output columns of a block's row segment
constexpr int kNearestRows = 64;    // the most output rows of a tile

// jax's source index of output position o: floor(fl(fl((o + 0.5) * in) / out))
// in float32, clamped to the input as jax's gather clamps an index.
__device__ __forceinline__ int nearest_index(int o, int in_size, int out_size) {
  const float f = floorf(__fdiv_rn(__fmul_rn(__fadd_rn((float)o, 0.5f), (float)in_size),
                                   (float)out_size));
  return f < 0.0f ? 0 : f > (float)(in_size - 1) ? in_size - 1 : (int)f;
}

// A block takes `rows_per_tile` output rows x kNearestCols output columns of
// every image (blocks loop over the images).  The tile's source row offsets
// and its columns' source byte offsets are computed once into shared memory;
// then each thread writes kW-byte words of the tile's rows (kW = 16, 4 or 1,
// as the row bytes allow), assembling each word's bytes from the source rows,
// which L1 and L2 serve.  Offsets are 32-bit within an image.
template <int kW>
__global__ void __launch_bounds__(kThreads)
resize_nearest_rows_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int n,
                           int h, int w, int pixel_bytes, int oh, int ow, int rows_per_tile) {
  __shared__ int s_col[kNearestCols];  // source byte offset of each column in its row
  __shared__ int s_row[kNearestRows];  // source byte offset of each row in its image
  const int pb = pixel_bytes;
  const int x0 = blockIdx.x * kNearestCols, cols = min(kNearestCols, ow - x0);
  const int y0 = blockIdx.y * rows_per_tile, rows = min(rows_per_tile, oh - y0);
  for (int t = threadIdx.x; t < cols; t += blockDim.x) s_col[t] = nearest_index(x0 + t, w, ow) * pb;
  for (int t = threadIdx.x; t < rows; t += blockDim.x)
    s_row[t] = nearest_index(y0 + t, h, oh) * w * pb;
  __syncthreads();
  const int words = cols * pb / kW;  // a segment's bytes are whole words (the entry checks)
  const long long out_row_bytes = (long long)ow * pb;
  for (int img = blockIdx.z; img < n; img += gridDim.z) {
    const uint8_t* src = in + (long long)img * h * w * pb;
    uint8_t* dst = out + ((long long)img * oh + y0) * out_row_bytes + (long long)x0 * pb;
    for (int e = threadIdx.x; e < rows * words; e += blockDim.x) {
      const int r = e / words, b = (e - r * words) * kW;  // tile row, byte in the segment
      const uint8_t* srow = src + s_row[r];
      int px = b / pb, ch = b - px * pb;
      uint8_t* d = dst + r * out_row_bytes + b;
      if constexpr (kW == 1) {
        *d = srow[s_col[px] + ch];
        continue;
      }
      uint32_t word[kW >= 4 ? kW / 4 : 1];
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        const uint32_t v = srow[s_col[px] + ch];
        if (k % 4 == 0) word[k / 4] = v;
        else word[k / 4] |= v << (8 * (k % 4));
        if (++ch == pb) {
          ch = 0;
          ++px;
        }
      }
      if constexpr (kW == 16)
        *reinterpret_cast<uint4*>(d) = make_uint4(word[0], word[1], word[2], word[3]);
      else
        *reinterpret_cast<uint32_t*>(d) = word[0];
    }
  }
}

}  // namespace

// params: device array of n x 4 floats (inv_scale_y, translation_y,
// inv_scale_x, translation_x); flips: device array of n bytes, or null for no
// flips.  Returns a cudaError_t (0 = launched), or -1 for arguments the
// kernel does not take.
template <typename T, int F>
int launch_general(const void* in, void* out, int n, int h, int w, int c, int oh, int ow,
                   const float* params, const uint8_t* flips, int antialias, void* stream) {
  if (n < 0 || h < 1 || w < 1 || c < 1 || oh < 1 || ow < 1) return -1;
  if (n == 0) return 0;
  const long long pixels = (long long)n * oh * ow;
  const long long blocks = (pixels + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return -1;
  resized_crop_kernel<T, F><<<(unsigned)blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), n, h, w, c, oh, ow, params, flips,
      antialias != 0);
  return (int)cudaGetLastError();
}

// The general kernel with filter 0 (triangle, bilinear), 1 (Keys cubic), 2
// (Lanczos 3) or 3 (Lanczos 5) on uint8 NHWC images, rounded half to even and
// clipped; -1 for another filter.
template <typename T>
int launch_filtered(const void* in, void* out, int n, int h, int w, int c, int oh, int ow,
                    const float* params, const uint8_t* flips, int filter, int antialias,
                    void* stream) {
  switch (filter) {
    case kTriangle:
      return launch_general<T, kTriangle>(in, out, n, h, w, c, oh, ow, params, flips,
                                          antialias, stream);
    case kKeysCubic:
      return launch_general<T, kKeysCubic>(in, out, n, h, w, c, oh, ow, params, flips,
                                           antialias, stream);
    case kLanczos3:
      return launch_general<T, kLanczos3>(in, out, n, h, w, c, oh, ow, params, flips,
                                          antialias, stream);
    case kLanczos5:
      return launch_general<T, kLanczos5>(in, out, n, h, w, c, oh, ow, params, flips,
                                          antialias, stream);
    default:
      return -1;
  }
}

extern "C" int pst_resample_u8(const void* in, void* out, int n, int h, int w, int c, int oh,
                               int ow, const float* params, const uint8_t* flips, int filter,
                               int antialias, void* stream) {
  return launch_filtered<uint8_t>(in, out, n, h, w, c, oh, ow, params, flips, filter,
                                  antialias, stream);
}

// pst_resample_u8 on float32 NHWC images, the sums stored unrounded.
extern "C" int pst_resample_f32(const void* in, void* out, int n, int h, int w, int c, int oh,
                                int ow, const float* params, const uint8_t* flips, int filter,
                                int antialias, void* stream) {
  return launch_filtered<float>(in, out, n, h, w, c, oh, ow, params, flips, filter, antialias,
                                stream);
}

// Nearest resize of n NHWC images of pixel_bytes bytes a pixel (C x the
// element size), (h, w) -> (oh, ow).  Returns a cudaError_t (0 = launched),
// or -1 for arguments the kernel does not take (an image of 2^31 bytes or
// more: its offsets are 32-bit).
extern "C" int pst_resize_nearest(const void* in, void* out, int n, int h, int w,
                                  int pixel_bytes, int oh, int ow, void* stream) {
  if (n < 0 || h < 1 || w < 1 || pixel_bytes < 1 || oh < 1 || ow < 1) return -1;
  if ((long long)h * w * pixel_bytes > 0x7fffffffLL) return -1;
  if ((long long)kNearestCols * pixel_bytes > 0x7fffffffLL) return -1;
  if (n == 0) return 0;
  // words as wide as every row segment's start and length allow (a segment
  // starts kNearestCols pixels after the last, at a multiple of 16 bytes)
  const long long row_bytes = (long long)ow * pixel_bytes;
  const uintptr_t base = reinterpret_cast<uintptr_t>(out);
  const int word = row_bytes % 16 == 0 && base % 16 == 0 ? 16
                   : row_bytes % 4 == 0 && base % 4 == 0 ? 4 : 1;
  // about 4096 bytes of output a tile row group, at most kNearestRows rows
  const long long seg_bytes = (long long)(ow < kNearestCols ? ow : kNearestCols) * pixel_bytes;
  const long long want = 4096 / seg_bytes;
  const int rows = (int)(want < 1 ? 1 : want > kNearestRows ? kNearestRows : want);
  const long long tiles_y = (oh + (long long)rows - 1) / rows;
  if (tiles_y > 65535) return -1;
  const dim3 grid((unsigned)((ow + kNearestCols - 1) / kNearestCols), (unsigned)tiles_y,
                  (unsigned)(n < 65535 ? n : 65535));  // blocks loop over the images
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  if (word == 16)
    resize_nearest_rows_kernel<16><<<grid, kThreads, 0, s>>>(src, dst, n, h, w, pixel_bytes, oh,
                                                             ow, rows);
  else if (word == 4)
    resize_nearest_rows_kernel<4><<<grid, kThreads, 0, s>>>(src, dst, n, h, w, pixel_bytes, oh,
                                                            ow, rows);
  else
    resize_nearest_rows_kernel<1><<<grid, kThreads, 0, s>>>(src, dst, n, h, w, pixel_bytes, oh,
                                                            ow, rows);
  return (int)cudaGetLastError();
}

// The tiled kernel: the arguments of pst_resample_u8 without the filter
// (bilinear) and without antialias (two taps per axis).  Returns a cudaError_t (0 = launched), or -1 for
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

// The separable tiled kernel, after its pre-pass: the arguments of
// pst_resample_u8 (the filter, FILTERS in augment.py, and antialias);
// shared_params (nonzero: params holds one image's 4 floats, every image's);
// the launch plan (tile rows and columns, the row and column tap capacities,
// the source columns of a span chunk, the channels of a group;
// augment.aa_launch_plan) and device scratch of at least aa_scratch_bytes
// (of one image with shared params) for the pre-pass's tables.  Returns a
// cudaError_t (0 = launched), or -1 for arguments, a plan or scratch the
// kernels do not take.
extern "C" int pst_resample_separable_u8(const void* in, void* out, int n, int h, int w, int c,
                                         int oh, int ow, const float* params,
                                         const uint8_t* flips, int filter, int antialias,
                                         int shared_params, int rows, int cols, int cap_y,
                                         int cap_x, int span, int group, void* scratch,
                                         long long scratch_bytes, void* stream) {
  if (n < 0 || h < 1 || w < 1 || c < 1 || oh < 1 || ow < 1) return -1;
  if (filter < kTriangle || filter > kLanczos5) return -1;
  if (rows < 1 || cols < 1 || cap_y < 1 || cap_x < 1 || span < 1) return -1;
  if (group < 1 || group > kChunk || group > c) return -1;
  const AaPlan plan{rows, cols, cap_y, cap_x, span, group};
  if (aa_shared_bytes(plan) > kMaxSharedBytes) return -1;
  const int n_tables = shared_params && n > 0 ? 1 : n;
  if (scratch_bytes < aa_scratch_bytes(n_tables, oh, ow, cap_y, cap_x)) return -1;
  if (n == 0) return 0;
  // the axes first (4-byte aligned structs), then the weights
  AaTables tables{static_cast<Axis*>(scratch), nullptr, oh, ow, cap_y, cap_x, filter,
                  shared_params != 0};
  tables.weights = reinterpret_cast<float*>(tables.axes + tables.axes_count(n_tables));
  const long long tiles_x = (ow + (long long)cols - 1) / cols;
  const long long tiles_y = (oh + (long long)rows - 1) / rows;
  // blocks loop over the images and over row tiles past 65535
  const dim3 grid((unsigned)tiles_x, (unsigned)(tiles_y < 65535 ? tiles_y : 65535),
                  (unsigned)(n < 65535 ? n : 65535));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  // RGB in one group, the common case, with the channel count known to the
  // compiler; the instance with tap cases up to 8 for narrow tables
  const bool narrow = cap_y <= kNarrowTapCase && cap_x <= kNarrowTapCase;
  const bool aa = antialias != 0;
  if (c == 3 && group == 3)
    return narrow ? launch_separable<3, kNarrowTapCase>(grid, plan, tables, s, src, dst, n, h, w,
                                                        c, oh, ow, params, flips, aa)
                  : launch_separable<3, kMaxTapCase>(grid, plan, tables, s, src, dst, n, h, w, c,
                                                     oh, ow, params, flips, aa);
  return narrow ? launch_separable<0, kNarrowTapCase>(grid, plan, tables, s, src, dst, n, h, w, c,
                                                      oh, ow, params, flips, aa)
                : launch_separable<0, kMaxTapCase>(grid, plan, tables, s, src, dst, n, h, w, c, oh,
                                                   ow, params, flips, aa);
}
