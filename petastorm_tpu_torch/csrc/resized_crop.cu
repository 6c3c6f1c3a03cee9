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
// Bound: memory.  A thread does about 8 flops per tap and channel and reads
// and writes bytes; at the ImageNet training batch (256 x 224 x 224 x 3 out)
// the kernel must write 38.5 MB and read the drawn boxes' source pixels
// (about half the 38.5 MB input on average).  This first version gives one
// thread one output pixel and all its channels: a warp's reads fall on one or
// two source rows and its stores on one contiguous run of output bytes.
// Staging source rows in shared memory (or TMA) is later work.
// Launched on the caller's stream; allocates nothing.

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
