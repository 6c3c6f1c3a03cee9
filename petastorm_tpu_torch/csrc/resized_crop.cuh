// The tiled and the separable resample kernels of csrc/resized_crop.cu on
// an element type E: the code the resample's libraries share.  Each library
// instantiates them for its element types (resized_crop.cu: uint8, beside
// the general kernel and the nearest gather; resized_crop_f32.cu,
// resized_crop_f16.cu, resized_crop_bf16.cu: one float type each), so that
// the four build at once, one nvcc each.  resized_crop.cu's header comment
// describes the kernels and why they give the general kernel's bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

constexpr int kTileRows = 8;    // R: output rows of a tile
constexpr int kTileCols = 256;  // TW: output columns of a tile, one thread each
static_assert(kTileCols == kThreads, "one thread per tile column");

// A tile row's two row taps: their normalised weights (0: no second tap) and
// the element offset of each tap's source row from the image's first
// element (a missing second tap points at the first tap's row).
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

// (float)byte k of v, exactly: byte_to_float with the byte picked by one
// byte permute.
__device__ __forceinline__ float word_byte_to_float(uint32_t v, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440u | k)), 8388608.0f);
}

// The vertical pass reads 4-byte words for rows of at least kWordTaps taps,
// where the image's rows start on 4-byte boundaries.  uint8: measured
// faster from Lanczos 3 on, a byte a load faster below.  float16 (phase 33
// (b)'s shape, NVIDIA H100 80GB HBM3 at 700 W, crop_ab.py): Lanczos 5 0.2111
// ms from 7 taps on, 0.2152 from 1, 0.2225 with element loads; the bilinear
// evaluation resize (2-3 taps) alike within 1 %.
constexpr int kWordTaps = 7;

// The element types of the tiled and the separable kernels: T, load (an
// element as a float, exactly), store (a float sum as an element), and the
// vertical pass's word loads: kPerWord elements a 4-byte word (0: none),
// word_elem(v, k) element k of word v as load gives it.  uint8: the byte
// tricks above.  float16 and bfloat16: conversions exact both ways into
// float32, stores rounded to nearest even.
struct ElemU8 {
  using T = uint8_t;
  static constexpr int kPerWord = 4;
  __device__ static __forceinline__ float load(T v) { return byte_to_float(v); }
  __device__ static __forceinline__ T store(float x) { return round_clip_byte(x); }
  __device__ static __forceinline__ float word_elem(uint32_t v, int k) {
    return word_byte_to_float(v, k);
  }
};

struct ElemF32 {
  using T = float;
  static constexpr int kPerWord = 0;
  __device__ static __forceinline__ float load(T v) { return v; }
  __device__ static __forceinline__ T store(float x) { return x; }
};

struct ElemF16 {
  using T = __half;
  static constexpr int kPerWord = 2;
  __device__ static __forceinline__ float load(T v) { return __half2float(v); }
  __device__ static __forceinline__ T store(float x) { return __float2half_rn(x); }
  __device__ static __forceinline__ float word_elem(uint32_t v, int k) {
    return __half2float(__ushort_as_half((unsigned short)(k ? v >> 16 : v & 0xffffu)));
  }
};

struct ElemBF16 {
  using T = __nv_bfloat16;
  static constexpr int kPerWord = 2;
  __device__ static __forceinline__ float load(T v) { return __bfloat162float(v); }
  __device__ static __forceinline__ T store(float x) { return __float2bfloat16_rn(x); }
  // a bfloat16 is the high half of its float32
  __device__ static __forceinline__ float word_elem(uint32_t v, int k) {
    return __uint_as_float(k ? v & 0xffff0000u : v << 16);
  }
};

// The tile's pixels in this thread's column, row after row: the general
// kernel's arithmetic in its order.  Source elements come from src + the
// row tap's offset + xoff (+ c for the second column tap); output elements
// go to dst + r * row_elems.  kC is the channel count, or 0 for one known
// only at run time.  The general kernel skips a zero weight; here its FMA
// runs and adds +0 (no partial sum is -0 and the elements are finite, so
// fmaf(0, b, s) is s), and a missing second tap reads the first tap's
// elements.
template <typename E, int kC>
__device__ __forceinline__ void tile_pixels(const typename E::T* __restrict__ src,
                                            typename E::T* __restrict__ dst,
                                            long long row_elems, int c_run, int rows, bool xzero,
                                            int xoff, float wx0, float wx1) {
  using T = typename E::T;
  const int c = kC ? kC : c_run;
  const float wx[2] = {wx0, wx1};
  const int xtap[2] = {0, wx1 != 0.0f ? c : 0};  // element offset of each column tap
  for (int r = 0; r < rows; ++r, dst += row_elems) {
    const RowTaps t = s_rows[r];
    if (t.zero || xzero) {
      for (int k = 0; k < c; ++k) dst[k] = E::store(0.0f);
      continue;
    }
    const T* row[2] = {src + t.off[0] + xoff, src + t.off[1] + xoff};
    for (int c0 = 0; c0 < c; c0 += kChunk) {
      const int nc = c - c0 < kChunk ? c - c0 : kChunk;
      float acc[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float col[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const T* px = row[i] + xtap[j] + c0;
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            if (k < nc) col[k] = fmaf(t.w[i], E::load(px[k]), col[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          if (k < nc) acc[k] = fmaf(wx[j], col[k], acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k < nc) dst[c0 + k] = E::store(acc[k]);
      }
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
resized_crop_tiled_kernel(const typename E::T* __restrict__ in, typename E::T* __restrict__ out,
                          int n, int h, int w, int c, int oh, int ow,
                          const float* __restrict__ params, const uint8_t* __restrict__ flips) {
  using T = typename E::T;
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTileRows, rows = min(kTileRows, oh - y0);
  const int ox = blockIdx.x * kTileCols + tid;
  const bool active = ox < ow;
  const long long row_elems = (long long)ow * c;

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
      const T* src = in + (long long)img * h * w * c;
      T* dst = out + ((long long)img * oh + y0) * row_elems +
               (long long)(flip ? ow - 1 - ox : ox) * c;
      // RGB, the training step's case, with the channel count known to the compiler
      if (c == 3) {
        tile_pixels<E, 3>(src, dst, row_elems, c, rows, xzero, xoff, wx0, wx1);
      } else {
        tile_pixels<E, 0>(src, dst, row_elems, c, rows, xzero, xoff, wx0, wx1);
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

// Vertical pass of one tile row over `elems` span elements (ng channels of
// each source column), lanes on neighbouring elements: col = the FMA chain
// over the row's taps in increasing iy.  kT > 0: exactly kT taps, all in
// the table, their weights in registers and their loads in flight at once;
// kT = 0: any.  kFlat: the group holds every channel (ng == c == group), so
// element q is element q of the span and sum q.
template <typename E, int kT, bool kFlat>
__device__ __forceinline__ void aa_vertical_row(const Axis& ay, const float* wy, int cap,
                                                int filter, const typename E::T* row0,
                                                long long row_elems, float* col_r, int elems,
                                                int ng, int c, int group, int lane) {
  using T = typename E::T;
  const int taps = ay.hi - ay.lo + 1;
  if (kT == 0) {
    for (int q = lane; q < elems; q += 32) {
      const int ix = q / ng, k = q - ix * ng;
      const T* px = row0 + (long long)ix * c + k;
      float col = 0.0f;
      for (int j = 0; j < taps; ++j, px += row_elems)
        col = fmaf(table_weight(ay, wy, cap, j, filter), E::load(*px), col);
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
    const T* px = row0 + (kFlat ? q : (long long)ix * c + k);
    float b[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      b[j] = E::load(px[j * row_elems]);
    float col = 0.0f;
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      col = fmaf(wr[j], b[j], col);
    col_r[kFlat ? q : ix * group + k] = col;
  }
}

// aa_vertical_row for a group holding every channel (kFlat) over rows that
// start on 4-byte boundaries (so that a word holding an element of a row
// lies in that row), for rows of at least kWordTaps taps: each lane
// loads the aligned 4-byte words of the span, a word a tap row, and runs
// the E::kPerWord elements' FMA chains (the same chains as the element
// loads give); an element outside the span is not stored.
template <typename E, int kT>
__device__ __forceinline__ void aa_vertical_row_words(const Axis& ay, const float* wy,
                                                      const typename E::T* row0,
                                                      long long row_elems, float* col_r,
                                                      int elems, int lane) {
  constexpr int kPer = E::kPerWord, kShift = kPer == 4 ? 2 : 1;  // 4 or 2 elements a word
  const int a0 = (int)(reinterpret_cast<uintptr_t>(row0) & 3) / (int)sizeof(typename E::T);
  const uint32_t* base = reinterpret_cast<const uint32_t*>(row0 - a0);
  const long long row_words = row_elems >> kShift;
  float wr[kT];
#pragma unroll
  for (int j = 0; j < kT; ++j) wr[j] = wy[j];
  const int words = (elems + a0 + kPer - 1) >> kShift;
  for (int p = lane; p < words; p += 32) {
    uint32_t v[kT];
#pragma unroll
    for (int j = 0; j < kT; ++j) v[j] = base[p + j * row_words];
    float col[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) col[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) col[k] = fmaf(wr[j], E::word_elem(v[j], k), col[k]);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = kPer * p + k - a0;
      if (q >= 0 && q < elems) col_r[q] = col[k];
    }
  }
}

// Horizontal pass of one tile column over rows r0, r0 + dr, ...: acc = the
// FMA chain of wx * col over the column's taps among this chunk's source
// columns [a, a + len), in increasing ix, carried from the chunk before
// (unless first); in the last chunk the stored elements go to dst + r *
// out_row_elems.  kT > 0 (and len >= kT): the chain walks a window of kT
// neighbouring source columns of the chunk that holds every tap of the
// column in it, the window's other columns with weight 0, so the sums' offsets
// are the same for every row (constants when kG, the group, is known) and no
// lane branches.  kT = 0: any number of taps, walked one by one.
template <typename E, int kT, int kG>
__device__ __forceinline__ void aa_horizontal_col(
    const Axis& ax, const float* wx, int cap, int filter, const Axis* s_ay, const float* s_col,
    float* carry, int span, int group_run, int cols, int r0, int dr, int rows, int a, int len,
    int ng, bool first, bool last, typename E::T* dst, long long out_row_elems) {
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
      typename E::T* d = dst + r * out_row_elems;
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (k < ng) d[k] = zero ? E::store(0.0f) : E::store(acc[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (k < ng) carry_r[k] = acc[k];
    }
  }
}

template <typename E, int kC, int kMaxT>
__global__ void __launch_bounds__(kThreads, kAaBlocksPerSm)
resample_separable_kernel(const typename E::T* __restrict__ in, typename E::T* __restrict__ out,
                          int n, int h, int w, int c_run, int oh, int ow,
                          const uint8_t* __restrict__ flips, AaPlan plan, AaTables tables) {
  using T = typename E::T;
  extern __shared__ float4 s_dyn[];
  Axis* s_ay = reinterpret_cast<Axis*>(s_dyn);
  Axis* s_ax = s_ay + plan.rows;
  float* s_col = reinterpret_cast<float*>(s_ax + plan.cols);
  float* s_acc = s_col + plan.rows * plan.span * plan.group;
  __shared__ int s_lo[kThreads / 32], s_hi[kThreads / 32];

  const int c = kC ? kC : c_run;
  const int x0 = blockIdx.x * plan.cols, cols = min(plan.cols, ow - x0);
  const int tiles_y = (oh + plan.rows - 1) / plan.rows;
  const long long row_elems = (long long)w * c, out_row_elems = (long long)ow * c;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  // horizontal pass: threads_per_col threads share a column, over rows
  // r0, r0 + threads_per_col, ...
  const int threads_per_col = max(1, (int)blockDim.x / plan.cols);
  // word loads in the vertical pass: every channel in one group, rows on 4-byte boundaries
  const bool words = kC != 0 && row_elems * (long long)sizeof(T) % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(in) & 3) == 0;

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
    const T* src = in + (long long)img * h * row_elems;
    T* dst_img = out + (long long)img * oh * out_row_elems;

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
          const T* row0 = src + (long long)ay.lo * row_elems + (long long)(span_lo + s0) * c + c0;
          float* col_r = s_col + r * plan.span * plan.group;
#define PST_AA_VERTICAL(N)                                                                   \
  {                                                                                        \
    constexpr int kTv = N <= kMaxT ? N : 0;                                                \
    if constexpr (E::kPerWord > 0 && kTv >= kWordTaps) {                     \
      if (words)                                                                           \
        aa_vertical_row_words<E, kTv>(ay, wy, row0, row_elems, col_r, len * ng, lane);     \
      else                                                                                 \
        aa_vertical_row<E, kTv, kC != 0>(ay, wy, tables.cap_y, tables.filter, row0,        \
                                         row_elems, col_r, len * ng, ng, c, plan.group,    \
                                         lane);                                            \
    } else {                                                                               \
      aa_vertical_row<E, kTv, kC != 0>(ay, wy, tables.cap_y, tables.filter, row0,          \
                                       row_elems, col_r, len * ng, ng, c, plan.group, lane); \
    }                                                                                      \
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
          T* dst = dst_img + (long long)y0 * out_row_elems +
                   (long long)(flip ? ow - 1 - ox : ox) * c + c0;
          const int a = span_lo + s0;
          const int kt = most == 0 ? 1 : most > kMaxT ? 0 : most;
#define PST_AA_HORIZONTAL(N)                                                                  \
  aa_horizontal_col<E, (N <= kMaxT ? N : 0), kC>(ax, wx, tables.cap_x, tables.filter, s_ay,     \
                                                 s_col, carry, plan.span, plan.group, plan.cols, \
                                                 r0, threads_per_col, rows, a, len, ng, s0 == 0, \
                                                 last, dst, out_row_elems)
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

template <typename E, int kC, int kMaxT>
int launch_separable(const dim3& grid, const AaPlan& plan, const AaTables& tables,
                     cudaStream_t stream, const typename E::T* in, typename E::T* out, int n,
                     int h, int w, int c, int oh, int ow, const float* params,
                     const uint8_t* flips, bool antialias) {
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
    err = cudaFuncSetAttribute(resample_separable_kernel<E, kC, kMaxT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  resample_separable_kernel<E, kC, kMaxT><<<grid, kThreads, (size_t)bytes, stream>>>(
      in, out, n, h, w, c, oh, ow, flips, plan, tables);
  return (int)cudaGetLastError();
}

// The tiled kernel on elements of E: the arguments of pst_resample_u8
// without the filter (bilinear) and without antialias (two taps per axis).
// Returns a cudaError_t (0 = launched), or -1 for arguments the kernel does
// not take.
template <typename E>
int launch_tiled(const void* in, void* out, int n, int h, int w, int c, int oh, int ow,
                 const float* params, const uint8_t* flips, void* stream) {
  if (n < 0 || h < 1 || w < 1 || c < 1 || oh < 1 || ow < 1) return -1;
  if ((long long)w * c > 0x7fffffffLL) return -1;  // a row's element offsets are 32-bit
  if (n == 0) return 0;
  const dim3 grid((unsigned)((ow + kTileCols - 1) / kTileCols),
                  (unsigned)((oh + kTileRows - 1) / kTileRows),
                  (unsigned)(n < 65535 ? n : 65535));  // blocks loop over the images
  if (grid.y > 65535u) return -1;
  using T = typename E::T;
  resized_crop_tiled_kernel<E><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), n, h, w, c, oh, ow, params, flips);
  return (int)cudaGetLastError();
}

// The separable tiled kernel on elements of E, after its pre-pass: the
// arguments of pst_resample_u8 (the filter, FILTERS in augment.py, and
// antialias); shared_params (nonzero: params holds one image's 4 floats,
// every image's); the launch plan (tile rows and columns, the row and
// column tap capacities, the source columns of a span chunk, the channels
// of a group; augment.aa_launch_plan) and device scratch of at least
// aa_scratch_bytes (of one image with shared params) for the pre-pass's
// tables.  Returns a cudaError_t (0 = launched), or -1 for arguments, a plan
// or scratch the kernels do not take.
template <typename E>
int launch_separable_entry(const void* in, void* out, int n, int h, int w, int c, int oh, int ow,
                           const float* params, const uint8_t* flips, int filter, int antialias,
                           int shared_params, int rows, int cols, int cap_y, int cap_x, int span,
                           int group, void* scratch, long long scratch_bytes, void* stream) {
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
  using T = typename E::T;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  // RGB in one group, the common case, with the channel count known to the
  // compiler; the instance with tap cases up to 8 for narrow tables
  const bool narrow = cap_y <= kNarrowTapCase && cap_x <= kNarrowTapCase;
  const bool aa = antialias != 0;
  if (c == 3 && group == 3)
    return narrow ? launch_separable<E, 3, kNarrowTapCase>(grid, plan, tables, s, src, dst, n, h,
                                                           w, c, oh, ow, params, flips, aa)
                  : launch_separable<E, 3, kMaxTapCase>(grid, plan, tables, s, src, dst, n, h, w,
                                                        c, oh, ow, params, flips, aa);
  return narrow ? launch_separable<E, 0, kNarrowTapCase>(grid, plan, tables, s, src, dst, n, h, w,
                                                         c, oh, ow, params, flips, aa)
                : launch_separable<E, 0, kMaxTapCase>(grid, plan, tables, s, src, dst, n, h, w, c,
                                                      oh, ow, params, flips, aa);
}

}  // namespace

// The extern "C" entries of the two kernels on one element type.
#define PST_TILED_ENTRY(NAME, ELEM)                                                          \
  extern "C" int NAME(const void* in, void* out, int n, int h, int w, int c, int oh, int ow, \
                      const float* params, const uint8_t* flips, void* stream) {             \
    return launch_tiled<ELEM>(in, out, n, h, w, c, oh, ow, params, flips, stream);           \
  }

#define PST_SEPARABLE_ENTRY(NAME, ELEM)                                                      \
  extern "C" int NAME(const void* in, void* out, int n, int h, int w, int c, int oh, int ow, \
                      const float* params, const uint8_t* flips, int filter, int antialias,  \
                      int shared_params, int rows, int cols, int cap_y, int cap_x, int span, \
                      int group, void* scratch, long long scratch_bytes, void* stream) {     \
    return launch_separable_entry<ELEM>(in, out, n, h, w, c, oh, ow, params, flips, filter,  \
                                        antialias, shared_params, rows, cols, cap_y, cap_x,  \
                                        span, group, scratch, scratch_bytes, stream);        \
  }
