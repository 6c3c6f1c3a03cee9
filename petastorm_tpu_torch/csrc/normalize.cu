// uint8 -> float image normalization on Hopper (sm_90a).
//
// Replaces petastorm_tpu/ops/normalize.py::_normalize_kernel (the Pallas TPU
// kernel launched by _normalize_pallas with tiles from _choose_block):
//
//     out[i] = cast<T>(fmaf(float(in[i]), scale[c], bias[c])),  c = i % C
//
// over the flat N*H*W*C bytes of an NHWC batch, with
// scale = 1/(255*std[c]) and bias = -mean[c]/std[c] computed by the caller.
//
// Bound: memory.  One byte is read and sizeof(T) bytes are written per
// element for two flops, far below the card's 295 flops/byte balance point;
// at the ImageNet batch (256 x 224 x 224 x 3, bf16 out) the kernel must move
// 115.6 MB, about 35 us at 3.35 TB/s.  The design therefore only has to keep
// every load and store wide and coalesced:
//   * a grid-stride loop over 16-byte uint4 loads from the first 16-byte
//     aligned input address, and a scalar path for the at most 15 + 15
//     ragged elements before and after it, so any shape and any input
//     offset runs (the TPU kernel needed N % 8 == 0 and H*W*C % 128 == 0);
//   * the 16 outputs of one load are stored as 16-byte vectors when the
//     output address allows it (one alignment test for the whole launch);
//   * C per-channel constants in shared memory, indexed by i % C, instead of
//     the TPU kernel's per-position vectors of H*W*C floats; above
//     kMaxChannels they stay in a device buffer that the caller fills and
//     are read through the read-only cache (no channel limit).
// Launched on the caller's stream; allocates nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 64;
constexpr int kThreads = 256;

struct Channels {
  float scale[kMaxChannels];
  float bias[kMaxChannels];
};

template <typename T> __device__ __forceinline__ T convert(float v);
template <> __device__ __forceinline__ float convert<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half convert<__half>(float v) {
  return __float2half_rn(v);
}

// kDeviceChannels: scale and bias are device arrays of `channels` floats
// (d_scale, d_bias); otherwise they come by value in `k`.
template <typename T, bool kVectorStore, bool kDeviceChannels>
__global__ void __launch_bounds__(kThreads)
normalize_u8_kernel(const uint8_t* __restrict__ in, T* __restrict__ out, long long n,
                    long long head, long long n_vec, int channels, Channels k,
                    const float* __restrict__ d_scale, const float* __restrict__ d_bias) {
  __shared__ float s_scale_buf[kDeviceChannels ? 1 : kMaxChannels];
  __shared__ float s_bias_buf[kDeviceChannels ? 1 : kMaxChannels];
  const float* s_scale = d_scale;
  const float* s_bias = d_bias;
  if (!kDeviceChannels) {
    for (int c = threadIdx.x; c < channels; c += blockDim.x) {
      s_scale_buf[c] = k.scale[c];
      s_bias_buf[c] = k.bias[c];
    }
    __syncthreads();
    s_scale = s_scale_buf;
    s_bias = s_bias_buf;
  }

  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;

  // ragged edges: `head` elements before the first aligned byte, and what is
  // left after the last full 16-byte vector
  const long long tail = head + n_vec * 16;
  if (tid < head) {
    const int c = (int)(tid % channels);
    out[tid] = convert<T>(fmaf((float)in[tid], s_scale[c], s_bias[c]));
  }
  if (tid < n - tail) {
    const long long i = tail + tid;
    const int c = (int)(i % channels);
    out[i] = convert<T>(fmaf((float)in[i], s_scale[c], s_bias[c]));
  }

  for (long long v = tid; v < n_vec; v += stride) {
    const long long base = head + v * 16;
    const uint4 packed = *reinterpret_cast<const uint4*>(in + base);
    const uint32_t words[4] = {packed.x, packed.y, packed.z, packed.w};
    int c = (int)(base % channels);
    alignas(16) T vals[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float x = (float)((words[j >> 2] >> ((j & 3) * 8)) & 0xFFu);
      vals[j] = convert<T>(fmaf(x, s_scale[c], s_bias[c]));
      c = (c + 1 == channels) ? 0 : c + 1;
    }
    if (kVectorStore) {
      uint4* dst = reinterpret_cast<uint4*>(out + base);
      const uint4* src = reinterpret_cast<const uint4*>(vals);
#pragma unroll
      for (int w = 0; w < (int)(16 * sizeof(T) / 16); ++w) dst[w] = src[w];
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) out[base + j] = vals[j];
    }
  }
}

template <typename T, bool kDeviceChannels>
int launch(const uint8_t* in, void* out_raw, long long n, int channels, const Channels& k,
           const float* d_scale, const float* d_bias, cudaStream_t stream) {
  T* out = static_cast<T*>(out_raw);
  long long head = (long long)((16 - ((uintptr_t)in & 15)) & 15);
  if (head > n) head = n;
  const long long n_vec = (n - head) / 16;
  const bool vector_store = (((uintptr_t)(out + head)) & 15) == 0;

  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long work = n_vec > 32 ? n_vec : 32;  // >= 30 threads for the edges
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long max_blocks = (long long)sms * 8;
  if (blocks > max_blocks) blocks = max_blocks;

  if (vector_store) {
    normalize_u8_kernel<T, true, kDeviceChannels><<<(unsigned)blocks, kThreads, 0, stream>>>(
        in, out, n, head, n_vec, channels, k, d_scale, d_bias);
  } else {
    normalize_u8_kernel<T, false, kDeviceChannels><<<(unsigned)blocks, kThreads, 0, stream>>>(
        in, out, n, head, n_vec, channels, k, d_scale, d_bias);
  }
  return (int)cudaGetLastError();
}

template <bool kDeviceChannels>
int dispatch(const void* in, void* out, long long n, int channels, const Channels& k,
             const float* d_scale, const float* d_bias, int out_dtype, void* stream) {
  const uint8_t* src = static_cast<const uint8_t*>(in);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return launch<float, kDeviceChannels>(src, out, n, channels, k, d_scale, d_bias, s);
    case 1:
      return launch<__nv_bfloat16, kDeviceChannels>(src, out, n, channels, k, d_scale, d_bias,
                                                    s);
    case 2: return launch<__half, kDeviceChannels>(src, out, n, channels, k, d_scale, d_bias, s);
    default: return -1;
  }
}

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16, 2 = float16.  `scale` and `bias` are
// host arrays of `channels` floats, at most kMaxChannels, passed to the
// kernel by value.  Returns a cudaError_t (0 = launched), or -1 for arguments
// the kernel does not take.
extern "C" int pst_normalize_u8(const void* in, void* out, long long n, int channels,
                                const float* scale, const float* bias, int out_dtype,
                                void* stream) {
  if (channels < 1 || channels > kMaxChannels || n < 0 || out_dtype < 0 || out_dtype > 2)
    return -1;
  if (n == 0) return 0;
  Channels k;
  for (int c = 0; c < channels; ++c) {
    k.scale[c] = scale[c];
    k.bias[c] = bias[c];
  }
  return dispatch<false>(in, out, n, channels, k, nullptr, nullptr, out_dtype, stream);
}

// Any channel count: `scale` and `bias` are device arrays of `channels`
// floats, read by the kernel where they lie.  Returns as pst_normalize_u8.
extern "C" int pst_normalize_u8_channels(const void* in, void* out, long long n, int channels,
                                         const float* scale, const float* bias, int out_dtype,
                                         void* stream) {
  if (channels < 1 || n < 0 || out_dtype < 0 || out_dtype > 2) return -1;
  if (n == 0) return 0;
  return dispatch<true>(in, out, n, channels, Channels{}, scale, bias, out_dtype, stream);
}
