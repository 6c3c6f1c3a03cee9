// Scale-and-translate of uint8, float32, float16 and bfloat16 NHWC images
// with the filters of jax.image, with an optional per-image horizontal flip,
// and its nearest resize, on Hopper (sm_90a).
//
// Replaces the XLA-compiled resample of
// petastorm_tpu/ops/augment.py::random_resized_crop (and resize_images, and
// the random_flip that the training step applies after the crop): per image,
// jax.image.scale_and_translate with the triangle kernel (bilinear), Keys
// cubic (a = -0.5), Lanczos 3 or Lanczos 5, which builds a dense (in x out)
// weight matrix per axis (jax/_src/image/scale.py::compute_weight_mat) and
// contracts the image with both; then round half to even and clip to uint8,
// or cast a float sum to the image's float type.  And
// jax.image.resize(method='nearest') of resize_images: a gather.
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
// taps), gives one thread one output pixel and all its channels.  No path
// launches it: its uint8 instances are the byte oracle the other kernels
// are held to, its float32 instances (float32 in and out, the same
// arithmetic without the final round and clip) the bit oracle of their
// float instances.  Each thread builds both axes' taps and divides each tap
// weight by the sum, takes its pixel's indices apart with 64-bit divisions
// and walks taps_y x taps_x source pixels: it is bound by instructions, some
// 10x above the other kernels, and Lanczos 5 with antialias at 224 -> 160
// walks about 225 source pixels a pixel.
//
// The tiled and the separable kernels take an element type E (Elem* below):
// how an element becomes a float, exactly, and how a sum becomes an element.
// uint8 (ElemU8) loads bytes without a conversion instruction and rounds
// half to even and clips; float32 (ElemF32) loads and stores the float as it
// is; float16 and bfloat16 (ElemF16, ElemBF16) load exactly and store with
// __float2half_rn / __float2bfloat16_rn, round to nearest even as torch's
// .to(dtype).  The sums are float32 in every instance, in the general
// kernel's order, so a float32 result equals the general kernel's float32
// instance bit for bit and a float16 or bfloat16 result equals that instance
// on the image cast to float32, then cast back (the wrapper's route for
// other dtypes before these instances; integer dtypes other than uint8 still
// take it, through the float32 instance).
//
// resized_crop_tiled_kernel<E> takes bilinear without antialias: two taps an
// axis, every crop of the training step.  A block of kThreads threads takes
// a tile of kTileRows output rows x kTileCols output columns of one image,
// one thread per column:
//   - the taps, normalised weights and source row offsets of the tile's rows
//     go into a shared table (kTileRows x 24 bytes) and each thread keeps its
//     column's in registers: two divisions per row or column and tile, and
//     only 32-bit indices taken from blockIdx/threadIdx;
//   - each thread reads its taps' elements from device memory and stores
//     its pixel's elements itself; L1 serves the reuse of a source pixel by
//     neighbouring columns and rows (staging the source rectangle or the
//     output tile in shared memory was measured slower on the H100);
//   - per pixel no branch and, for uint8, no conversion instruction: the
//     FMA of a zero weight runs and adds +0, bytes become floats and rounded
//     sums bytes through the mantissa of 2^23 + v, and C = 3 is a
//     compile-time constant.
// For uint8 it is bound by instructions and latency, at about a quarter of
// its bytes' bound (PERF.md); a float32 image moves four times the bytes.
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
//   - vertical pass (resample_separable_kernel<E, ...>): a warp a tile row,
//     its weights in registers, its lanes on neighbouring elements of the
//     span [first tap of the first nonzero column, last tap of the last]
//     (coalesced; 4-byte words, of 4 bytes or of two float16 or bfloat16
//     elements, from 7 taps on, when the image's rows start on 4-byte
//     boundaries and one group holds every channel; a float32 element is a
//     word already): col in shared memory
//     (float32), the FMA chain over the row's taps in increasing iy from
//     0.0f, specialised on the row's tap count (each count up to 16) so that
//     its loads are in flight together;
//   - horizontal pass: a thread a tile column, its weights in registers, row
//     after row: acc = the FMA chain of wx * col over a window of the tap
//     count's neighbouring source columns that holds the column's taps, the
//     others with weight 0, in increasing ix, then E::store, stored at the
//     flipped column when the image is flipped; a warp's columns share
//     the largest tap count among them, so no lane branches;
//   - about taps_y + taps_x FMAs a pixel and channel, not taps_y x taps_x.
// A span wider than the plan's chunk is walked in chunks in increasing
// column, each pixel's acc carried in shared memory from one chunk to the
// next; a tap beyond a table's capacity is computed as the table would hold
// it (tap_weight_of, the filter known at run time); so any shape and any
// params run without reading past a table.  It is bound by instructions and
// latency, not bytes: the vertical pass turns each element of the span into
// a float once a tap row, the horizontal pass reads each sum from shared
// memory once a tap and channel (PERF.md gives the split).
//
// Identical to the general kernel by construction, for weights of either
// sign and any finite inputs (the same holds for the tiled kernel).  col
// for (oy, ix) is the FMA chain the general kernel runs
// inside its ix loop, with the same weights (tap_weight<F>, make_axis's
// total summed in its order, then __fdiv_rn(tap_weight<F>(a, i), a.total))
// in the same order, and acc is its outer chain in the same order, carried
// across chunks as the same float.  The general kernel skips a zero weight;
// here a trimmed end tap is not walked, and a zero weight in the chain (a
// tap past a row's count, a window column that is no tap of its column, an
// interior zero) runs its FMA.  That FMA adds nothing: a chain starts at
// +0.0f, and under round to nearest a sum is -0 only when both addends are
// -0, so no partial sum is ever -0; then fmaf(+-0, b, s) = (+-0) + s = s
// for every finite b and every s that is not -0 (an infinite s included).
// Cubic and Lanczos weights are negative on their outer lobes, and float
// images may hold negative values, so partial sums may be negative or
// exceed 255; round_clip_byte clips before it rounds, which gives the byte
// the general kernel's rint-then-clip gives, and the float stores take the
// float32 sum as it is.  A zero row or column (ay.zero, ax.zero) gives +0,
// as there.  chip_smoke.py checks every byte and bit.
//
// An infinite or NaN input breaks the equality: a zero-weight FMA walked
// here over it gives NaN (0 x inf), where the general kernel skips the tap,
// so more outputs are NaN here (those whose walked window, second tap or
// span chunk holds the value).  The reference's dense contraction
// (jax.image.scale_and_translate, and _scale_and_translate in the wrapper)
// multiplies every input by a weight, 0 for most, so one such input makes
// every output of its image whose row or column contraction reads it NaN,
// more still.  No kernel here chases that case.
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
#include "resized_crop.cuh"

namespace {

constexpr int kWeightCache = 32;  // row weights a pixel of the general kernel keeps

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

PST_TILED_ENTRY(pst_resized_crop_tiled_u8, ElemU8)
PST_SEPARABLE_ENTRY(pst_resample_separable_u8, ElemU8)
