// Scale-and-translate of uint8 (and float32) NHWC images with the filters of
// jax.image, with an optional per-image horizontal flip, and its nearest
// resize, on Hopper (sm_90a).
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
// Three kernels compute this function.
//
// resized_crop_kernel, the general one (any number of taps, so antialiased
// downscales too), gives one thread one output pixel and all its channels.
// No uint8 path launches it: it is the byte oracle that the other two are
// held to (its uint8 instance).  Its float32 instance (float32 in and
// out, the same arithmetic without the final round and clip) takes every
// image that is not uint8; the wrapper converts other dtypes to float32 and
// back, as the reference does.
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
//
// resized_crop_u8_aa_tiled_kernel takes antialias, so any number of taps per
// axis (4-5 walked, 2-3 nonzero, at the 256 -> 224 evaluation resize;
// hundreds at a steep downscale; two on an upscaled axis).  There the general
// kernel runs some 60 IEEE divisions a pixel and walks taps_y x taps_x
// source pixels.  The weights depend only on (image, row) or (image, column),
// and the vertical sum col = sum_iy wy(iy) * px(iy, ix) of an output row and
// a source column does not depend on the output column.  So:
//   - a pre-pass (resized_crop_aa_axes_kernel, one thread an axis) writes
//     every image's row and column Axis and normalised weights to device
//     scratch, each axis's taps trimmed to its first and last nonzero weight:
//     (oh + ow) axes an image, not 60 divisions a pixel;
//   - a block takes a tile of R output rows x TW output columns of one image
//     (augment.aa_launch_plan sizes them from the shapes alone, within
//     232,448 B of dynamic shared memory; 8 x 224 at the evaluation resize);
//   - vertical pass: a warp a tile row, its weights in registers, its lanes
//     on neighbouring bytes of the span [first tap of the first nonzero
//     column, last tap of the last] (coalesced): col in shared memory
//     (float32), the FMA chain over the row's taps in increasing iy from
//     0.0f, specialised on the row's tap count so that its loads are in
//     flight together;
//   - horizontal pass: a thread a tile column, its weights in registers, row
//     after row: acc = the FMA chain of wx * col over the column's taps in
//     increasing ix, then round_clip_byte, stored at the flipped column when
//     the image is flipped; a warp's columns share the largest tap count
//     among them (a column with fewer walks weight 0), so no lane branches;
//   - about taps_y + taps_x FMAs a pixel and channel, not taps_y x taps_x.
// It is bound by latency, not bytes: four blocks an SM (64 registers) beat
// three (80) and five or six (spilling).  Staging the tile's source rows in
// shared memory was measured slower.  A span wider than the plan's chunk is
// walked in chunks in increasing column, each pixel's acc carried in shared
// memory from one chunk to the next; a tap beyond a table's capacity is
// computed as the table would hold it; so any shape and any params run
// without reading past a table.
// Byte-identical to the general kernel by construction: col for (oy, ix) is
// the FMA chain the general kernel runs inside its ix loop, with the same
// weights (tap_weight, make_axis's total summed in its order, then
// __fdiv_rn(tap_weight(a, i), a.total)) in the same order, and acc is its
// outer chain in the same order, carried across chunks as the same float.
// The general kernel skips a zero weight; here a trimmed end tap is not
// walked and a zero weight's FMA runs and adds +0, since weights, bytes and
// partial sums are finite and >= +0 (so each chain starts and ends as
// there).  A zero row or column (ay.zero, ax.zero) gives zero bytes, as
// there.  chip_smoke.py checks every byte.
// The other filters of jax.image (method= cubic: Keys with a = -0.5;
// lanczos3, lanczos5) run in the general kernel, an instance a filter
// (resized_crop_kernel<T, F>: filter_value<F> in tap_weight, and taps
// [floor(sample - r * kernel_scale), ceil(sample + r * kernel_scale)] for the
// filter's radius r), uint8 and float32 alike.  Their weights go negative on
// the outer lobes, which the tiled kernels' +0 arguments do not allow, and
// their supports are 2-5x wider; the general kernel skips a zero weight
// whatever the sign of the others, so it takes them as they are.  Lanczos 5
// with antialias on a 500 -> 224 axis walks about 23 taps an axis, 529 a
// pixel.  resize_nearest_kernel is method='nearest' of resize_images: a gather.
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

// -- the antialiased tiled kernel ------------------------------------------

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
// and cap_x a column.
struct AaTables {
  Axis* axes;
  float* weights;
  int oh, ow, cap_y, cap_x;
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

// make_axis with antialias, its taps trimmed to the first and the last
// nonzero weight (a zero weight's FMA at either end of a chain adds +0), and
// its normalised weights in table[0, cap): one walk over the taps sums
// make_axis's total in its order and keeps the unnormalised weights from the
// first nonzero one on, then each is divided by the total.
__device__ __forceinline__ Axis make_aa_axis(int o, int in_size, float inv_scale,
                                             float translation, float* table, int cap) {
  Axis a = axis_taps(o, in_size, inv_scale, translation, true);
  if (a.zero) return a;
  int first = -1, last = -1;
  for (int i = a.lo; i <= a.hi; ++i) {
    const float t = tap_weight(a, i);
    a.total = __fadd_rn(a.total, t);
    if (t != 0.0f) {
      if (first < 0) first = i;
      last = i;
    }
    if (first >= 0 && i - first < cap) table[i - first] = t;
  }
  a.zero = !(fabsf(a.total) > kMinWeightSum);
  if (!a.zero) {  // a nonzero total: some tap's weight is > 0
    a.lo = first;
    a.hi = last;
    for (int j = 0; j <= last - first && j < cap; ++j) table[j] = __fdiv_rn(table[j], a.total);
  }
  return a;
}

// Blocks of the antialiased kernel resident on an SM: at most 64 registers a
// thread (measured faster than 80 registers and 3 blocks, and than 48 with
// spills).
constexpr int kAaBlocksPerSm = 4;

// The pre-pass: every image's row and column axes, one thread each.
__global__ void __launch_bounds__(kThreads)
resized_crop_aa_axes_kernel(int n, int h, int w, const float* __restrict__ params, AaTables t) {
  const long long count = t.axes_count(n);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    const int img = (int)(i / (t.oh + t.ow)), o = (int)(i - (long long)img * (t.oh + t.ow));
    const float* p = params + 4 * img;
    t.axes[i] = o < t.oh ? make_aa_axis(o, h, p[0], p[1], t.row_weights(img, o), t.cap_y)
                         : make_aa_axis(o - t.oh, w, p[2], p[3],
                                        t.col_weights(img, o - t.oh), t.cap_x);
  }
}

// Tap j of axis a, normalised: from the table below its capacity, else
// computed as the table would hold it (so no shape reads past a table).
__device__ __forceinline__ float aa_weight(const Axis& a, const float* table, int cap, int j) {
  return j < cap ? table[j] : __fdiv_rn(tap_weight(a, a.lo + j), a.total);
}

// Vertical pass of one tile row over `elems` span bytes (ng channels of each
// source column), lanes on neighbouring bytes: col = the FMA chain over the
// row's taps in increasing iy.  kT > 0: at most kT taps (exactly kT when
// kExact), all in the table, their weights in registers and their loads in
// flight at once; kT = 0: any.  kFlat: the group holds every channel
// (ng == c == group), so element q is byte q of the span and sum q.
template <int kT, bool kExact, bool kFlat>
__device__ __forceinline__ void aa_vertical_row(const Axis& ay, const float* wy, int cap,
                                                const uint8_t* row0, long long row_bytes,
                                                float* col_r, int elems, int ng, int c,
                                                int group, int lane) {
  const int taps = ay.hi - ay.lo + 1;
  if (kT == 0) {
    for (int q = lane; q < elems; q += 32) {
      const int ix = q / ng, k = q - ix * ng;
      const uint8_t* px = row0 + (long long)ix * c + k;
      float col = 0.0f;
      for (int j = 0; j < taps; ++j, px += row_bytes)
        col = fmaf(aa_weight(ay, wy, cap, j), byte_to_float(*px), col);
      col_r[ix * group + k] = col;
    }
    return;
  }
  constexpr int kTaps = kT > 0 ? kT : 1;
  float wr[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) wr[j] = (kExact || j < taps) ? wy[j] : 0.0f;
  for (int q = lane; q < elems; q += 32) {
    const int ix = kFlat ? q : q / ng, k = kFlat ? 0 : q - ix * ng;
    const uint8_t* px = row0 + (kFlat ? q : (long long)ix * c + k);
    float b[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      b[j] = (kExact || j < taps) ? byte_to_float(px[j * row_bytes]) : 0.0f;
    float col = 0.0f;
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      if (kExact || j < taps) col = fmaf(wr[j], b[j], col);
    col_r[kFlat ? q : ix * group + k] = col;
  }
}

// Horizontal pass of one tile column over rows r0, r0 + dr, ...: acc = the
// FMA chain of wx * col over the column's taps among this chunk's source
// columns [a, b], in increasing ix, carried from the chunk before (unless
// first); in the last chunk the rounded bytes go to dst + r * out_row_bytes.
// kT > 0: every column of the warp has at most kT taps, all in its table; a
// column with fewer, or a tap outside the chunk, walks weight 0 at the
// chunk's first column, whose FMA adds +0 (no branch a tap).  kT = 0: any
// number of taps, walked one by one.
template <int kT>
__device__ __forceinline__ void aa_horizontal_col(
    const Axis& ax, const float* wx, int cap, const Axis* s_ay, const float* s_col,
    float* carry, int span, int group, int cols, int r0, int dr, int rows, int a, int b,
    int ng, bool first, bool last, uint8_t* dst, long long out_row_bytes) {
  const int taps = ax.hi - ax.lo + 1;
  constexpr int kTaps = kT > 0 ? kT : 1;
  float wr[kTaps];
  int cx[kTaps];  // each tap's sum: its column's offset from a
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    const int ix = ax.lo + j;
    const bool use = kT > 0 && !ax.zero && j < taps && ix >= a && ix <= b;
    wr[j] = use ? wx[j] : 0.0f;
    cx[j] = use ? (ix - a) * group : 0;
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
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
#pragma unroll
          for (int k = 0; k < kChunk; ++k)
            if (k < ng) acc[k] = fmaf(wr[j], col_r[cx[j] + k], acc[k]);
        }
      } else {
        for (int ix = max(a, ax.lo); ix <= min(b, ax.hi); ++ix) {
          const float wj = aa_weight(ax, wx, cap, ix - ax.lo);
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

template <int kC>
__global__ void __launch_bounds__(kThreads, kAaBlocksPerSm)
resized_crop_u8_aa_tiled_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int n,
                                int h, int w, int c_run, int oh, int ow,
                                const uint8_t* __restrict__ flips, AaPlan plan,
                                AaTables tables) {
  extern __shared__ float4 s_dyn[];
  Axis* s_ay = reinterpret_cast<Axis*>(s_dyn);
  Axis* s_ax = s_ay + plan.rows;
  float* s_col = reinterpret_cast<float*>(s_ax + plan.cols);
  float* s_acc = s_col + plan.rows * plan.span * plan.group;
  __shared__ int s_lo[kThreads / 32], s_hi[kThreads / 32];

  const int c = kC ? kC : c_run;
  const int y0 = blockIdx.y * plan.rows, rows = min(plan.rows, oh - y0);
  const int x0 = blockIdx.x * plan.cols, cols = min(plan.cols, ow - x0);
  const long long row_bytes = (long long)w * c, out_row_bytes = (long long)ow * c;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  // horizontal pass: threads_per_col threads share a column, over rows
  // r0, r0 + threads_per_col, ...
  const int threads_per_col = max(1, (int)blockDim.x / plan.cols);

  // (each image's work ends with a barrier, so its readers of the shared
  // arrays are done before the next image writes them)
  for (int img = blockIdx.z; img < n; img += gridDim.z) {
    // the tile's axes from the pre-pass; the span of its nonzero columns'
    // taps reduced in each warp, then over the warps
    for (int t = blockDim.x - 1 - threadIdx.x; t < rows && t >= 0; t += blockDim.x)
      s_ay[t] = tables.row(img, y0 + t);
    int lo = 0x7fffffff, hi = -1;
    for (int t = threadIdx.x; t < cols; t += blockDim.x) {
      const Axis ax = tables.col(img, x0 + t);
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
          const float* wy = tables.row_weights(img, y0 + r);
          const uint8_t* row0 = src + (long long)ay.lo * row_bytes +
                                (long long)(span_lo + s0) * c + c0;
          float* col_r = s_col + r * plan.span * plan.group;
#define PST_AA_VERTICAL(T, EXACT)                                                    \
  aa_vertical_row<T, EXACT, kC != 0>(ay, wy, tables.cap_y, row0, row_bytes, col_r, len * ng, ng, c, \
                            plan.group, lane)
          switch (taps > tables.cap_y ? 0 : taps) {
            case 1: PST_AA_VERTICAL(1, true); break;
            case 2: PST_AA_VERTICAL(2, true); break;
            case 3: PST_AA_VERTICAL(3, true); break;
            case 4: PST_AA_VERTICAL(4, true); break;
            case 5: case 6: case 7: case 8: PST_AA_VERTICAL(8, false); break;
            default: PST_AA_VERTICAL(0, false); break;
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
          const float* wx = tables.col_weights(img, ox);
          float* carry = s_acc + x * plan.group;
          uint8_t* dst = dst_img + (long long)y0 * out_row_bytes +
                         (long long)(flip ? ow - 1 - ox : ox) * c + c0;
          const int a = span_lo + s0, b = span_lo + s0 + len - 1;
#define PST_AA_HORIZONTAL(T)                                                           \
  aa_horizontal_col<T>(ax, wx, tables.cap_x, s_ay, s_col, carry, plan.span, plan.group, \
                              plan.cols, r0, threads_per_col, rows, a, b, ng, s0 == 0, last,  \
                              dst, out_row_bytes)
          switch (most) {
            case 0: case 1: PST_AA_HORIZONTAL(1); break;
            case 2: PST_AA_HORIZONTAL(2); break;
            case 3: PST_AA_HORIZONTAL(3); break;
            case 4: PST_AA_HORIZONTAL(4); break;
            case 5: case 6: case 7: case 8: PST_AA_HORIZONTAL(8); break;
            default: PST_AA_HORIZONTAL(0); break;
          }
#undef PST_AA_HORIZONTAL
        }
        __syncthreads();  // the next chunk or group overwrites the sums
        if (last) break;
      }
    }
  }
}

constexpr long long kMaxSharedBytes = 232448;   // an sm_90 block's dynamic shared memory
constexpr long long kDefaultSharedBytes = 48 * 1024;

// Device scratch of the pre-pass's tables (augment.AaPlan.scratch_bytes).
long long aa_scratch_bytes(int n, int oh, int ow, int cap_y, int cap_x) {
  const AaTables t{nullptr, nullptr, oh, ow, cap_y, cap_x};
  return t.axes_count(n) * (long long)sizeof(Axis) + 4 * t.weights_count(n);
}

template <int kC>
int launch_aa(const dim3& grid, const AaPlan& plan, const AaTables& tables, cudaStream_t stream,
              const uint8_t* in, uint8_t* out, int n, int h, int w, int c, int oh, int ow,
              const float* params, const uint8_t* flips) {
  const long long axes = tables.axes_count(n);
  const long long prepass_blocks = (axes + kThreads - 1) / kThreads;
  resized_crop_aa_axes_kernel<<<(unsigned)(prepass_blocks < 65535 ? prepass_blocks : 65535),
                                kThreads, 0, stream>>>(n, h, w, params, tables);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long bytes = aa_shared_bytes(plan);
  if (bytes > kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(resized_crop_u8_aa_tiled_kernel<kC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  resized_crop_u8_aa_tiled_kernel<kC><<<grid, kThreads, (size_t)bytes, stream>>>(
      in, out, n, h, w, c, oh, ow, flips, plan, tables);
  return (int)cudaGetLastError();
}

// resize_nearest_kernel: jax.image.resize(method='nearest')
// (jax/_src/image/scale.py::_resize_nearest), one thread an output pixel,
// which copies the pixel_bytes bytes (C x the element size, so any dtype) of
// source pixel (floor(float32((oy + 0.5) * h / oh)), the same of ox) of its
// image.  The offsets are float32 as jax computes them, clamped to the input
// as jax's gather clamps an index.
__global__ void __launch_bounds__(kThreads)
resize_nearest_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int n, int h,
                      int w, int pixel_bytes, int oh, int ow) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long pixels = (long long)n * oh * ow;
  if (idx >= pixels) return;
  const int ox = (int)(idx % ow);
  const int oy = (int)((idx / ow) % oh);
  const long long img = idx / ((long long)ow * oh);
  const float fy = floorf(__fdiv_rn(__fmul_rn(__fadd_rn((float)oy, 0.5f), (float)h), (float)oh));
  const float fx = floorf(__fdiv_rn(__fmul_rn(__fadd_rn((float)ox, 0.5f), (float)w), (float)ow));
  const int sy = fy < 0.0f ? 0 : fy > (float)(h - 1) ? h - 1 : (int)fy;
  const int sx = fx < 0.0f ? 0 : fx > (float)(w - 1) ? w - 1 : (int)fx;
  const uint8_t* src = in + ((img * h + sy) * w + sx) * pixel_bytes;
  uint8_t* dst = out + idx * pixel_bytes;
  for (int b = 0; b < pixel_bytes; ++b) dst[b] = src[b];
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
// or -1 for arguments the kernel does not take.
extern "C" int pst_resize_nearest(const void* in, void* out, int n, int h, int w,
                                  int pixel_bytes, int oh, int ow, void* stream) {
  if (n < 0 || h < 1 || w < 1 || pixel_bytes < 1 || oh < 1 || ow < 1) return -1;
  if (n == 0) return 0;
  const long long blocks = ((long long)n * oh * ow + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return -1;
  resize_nearest_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n, h, w, pixel_bytes, oh, ow);
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

// The antialiased tiled kernel, after its pre-pass: the arguments of
// pst_resample_u8 without the filter (bilinear), with antialias, the launch plan (tile rows and
// columns, the row and column tap capacities, the source columns of a span
// chunk, the channels of a group; augment.aa_launch_plan) and device scratch
// of at least aa_scratch_bytes for the pre-pass's tables.  Returns a
// cudaError_t (0 = launched), or -1 for arguments, a plan or scratch the
// kernels do not take.
extern "C" int pst_resized_crop_aa_u8(const void* in, void* out, int n, int h, int w, int c,
                                      int oh, int ow, const float* params, const uint8_t* flips,
                                      int rows, int cols, int cap_y, int cap_x, int span,
                                      int group, void* scratch, long long scratch_bytes,
                                      void* stream) {
  if (n < 0 || h < 1 || w < 1 || c < 1 || oh < 1 || ow < 1) return -1;
  if (rows < 1 || cols < 1 || cap_y < 1 || cap_x < 1 || span < 1) return -1;
  if (group < 1 || group > kChunk || group > c) return -1;
  const AaPlan plan{rows, cols, cap_y, cap_x, span, group};
  if (aa_shared_bytes(plan) > kMaxSharedBytes) return -1;
  if (scratch_bytes < aa_scratch_bytes(n, oh, ow, cap_y, cap_x)) return -1;
  if (n == 0) return 0;
  // the axes first (4-byte aligned structs), then the weights
  AaTables tables{static_cast<Axis*>(scratch), nullptr, oh, ow, cap_y, cap_x};
  tables.weights = reinterpret_cast<float*>(tables.axes + tables.axes_count(n));
  const dim3 grid((unsigned)((ow + cols - 1) / cols), (unsigned)((oh + rows - 1) / rows),
                  (unsigned)(n < 65535 ? n : 65535));  // blocks loop over the images
  if (grid.x > 0x7fffffffu || grid.y > 65535u) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  // RGB in one group, the common case, with the channel count known to the compiler
  if (c == 3 && group == 3)
    return launch_aa<3>(grid, plan, tables, s, src, dst, n, h, w, c, oh, ow, params, flips);
  return launch_aa<0>(grid, plan, tables, s, src, dst, n, h, w, c, oh, ow, params, flips);
}
