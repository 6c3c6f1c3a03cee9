// Hybrid JPEG decode, device half (kernel B2), on Hopper (sm_90a).
//
// Replaces the XLA-compiled petastorm_tpu/ops/jpeg.py::decode_coefficients
// (with _idct_blocks, _upsample_axis_fancy, _upsample_to and _YCC_TO_RGB):
// from the quantized DCT coefficient planes that libjpeg's entropy decoder
// wrote on the host (int16, (n, blocks_h, blocks_w, 64) per component,
// natural order) and the quant tables ((n, ncomp, 64), int32 as the loader
// delivers them), per image:
//
//     X[u, v]   = coef[u*8 + v] * q[u*8 + v]                    (dequantize)
//     S[k, l]   = sum_u A[u, k] * (sum_v X[u, v] * A[v, l]) + 128  (8x8 IDCT)
//     component c cropped to ch = ceil(H*v_c/max_v) x cw = ceil(W*h_c/max_h)
//     upsampled by (fy, fx) = (max_v/v_c, max_h/h_c), rows first: for a
//     factor 2 with fancy upsampling libjpeg's triangle filter,
//         out[2i] = (3*S[i] + S[i-1]) * 0.25, out[2i+1] = (3*S[i] + S[i+1]) * 0.25,
//     its neighbours replicated at the cropped edge (ch, cw); otherwise
//     nearest (out[r] = S[r / f])
//     3 components: BT.601 YCbCr -> RGB; then rounded half to even and
//     clipped for uint8, or stored as float32
//
// A[u, x] = c(u)/2 * cos((2x+1) u pi / 16) comes from the caller (the
// reference's float32 table).  The sums of the IDCT run as FMAs in
// increasing v, then increasing u; the upsample and the color are written
// with explicitly rounded operations, as the plain version computes them.
//
// Bound: bytes.  At the ImageNet batch (256 images of 224x224, 4:2:0) the
// kernel reads 38.5 MB of coefficients and writes 38.5 MB of pixels, 0.023
// ms at 3.35 TB/s; its 0.8 GFLOP of float32 need 0.012 ms.  The XLA form
// writes the dequantized blocks, the spatial planes and the upsampled planes
// to memory between its ops; here one pass per tile keeps them in shared
// memory:
//   - a block takes a tile of one image: one MCU row (8 * max_v output rows)
//     x up to 256 output columns (a whole number of MCUs);
//   - fill: the tile's own coefficient blocks of every component go through
//     the separable IDCT, one thread a block column (T[u] for its column l,
//     then its 8 samples), into a float32 region of shared memory; where the
//     triangle filter runs, the region has a one-sample halo on each side,
//     each halo sample computed alone with the same arithmetic (the same T
//     column, the same FMA chain for its row), so a sample has the same
//     float whichever tile computes it;
//   - emit: one thread a pixel, the upsample read from the regions at
//     indices clamped to the cropped size (the edge replication), the
//     color, the store.
// Launched on the caller's stream; allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxComps = 3;
constexpr int kThreads = 256;
constexpr int kMaxTileCols = 256;            // output columns of a tile, at most
constexpr int kMaxSharedBytes = 232448;      // an sm_90 block's dynamic shared memory

struct Comp {
  const int16_t* coefs;     // (n, bh, bw, 64)
  long long image_stride;   // bh * bw * 64
  int bh, bw;               // blocks of the plane
  int fy, fx;               // upsample factors
  int ch, cw;               // cropped sampled size
  int fancy_y, fancy_x;     // the triangle filter on that axis (else nearest)
  int hy, hx;               // halo samples on each side: 1 where the filter runs
  int tile_brows, tile_bcols;  // blocks of a tile (before the plane's edge)
  int stride;               // floats between two region rows
  int offset;               // the region's first float in shared memory
};

struct Params {
  Comp comp[kMaxComps];
  const int32_t* qtabs;     // (n, ncomp, 64)
  void* out;                // (n, height, width, channels)
  int ncomp, n, height, width;
  int tile_rows, tile_cols;
  int out_f32;
  float basis[64];          // A[u * 8 + x]
};

// Shared memory: the basis, the dequantizing tables, then each component's region.
constexpr int kBasisFloats = 64;
constexpr int kQuantFloats = kMaxComps * 64;

// T[u] = sum_v X[u, v] * A[v, l]: the first half of the IDCT for column l of
// one block, dequantized on the way.
__device__ __forceinline__ void column_transform(const int16_t* __restrict__ block,
                                                 const float* __restrict__ q,
                                                 const float* __restrict__ a, int l,
                                                 float t[8]) {
  float al[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) al[v] = a[v * 8 + l];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int4 packed = reinterpret_cast<const int4*>(block)[u];  // the block's row u
    const int32_t words[4] = {packed.x, packed.y, packed.z, packed.w};
    float acc = 0.0f;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int16_t coef = (int16_t)((uint32_t)words[v >> 1] >> ((v & 1) * 16));
      acc = fmaf(__fmul_rn((float)coef, q[u * 8 + v]), al[v], acc);
    }
    t[u] = acc;
  }
}

// S[k, l] = sum_u A[u, k] * T[u] + 128.
__device__ __forceinline__ float row_sample(const float t[8], const float* __restrict__ a, int k) {
  float acc = 0.0f;
#pragma unroll
  for (int u = 0; u < 8; ++u) acc = fmaf(a[u * 8 + k], t[u], acc);
  return __fadd_rn(acc, 128.0f);
}

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// The tile's blocks of one component: rows [br0, br0 + nbr), cols [bc0, bc0 + nbc).
struct TileBlocks {
  int br0, bc0, nbr, nbc;
};

__device__ __forceinline__ TileBlocks tile_blocks(const Comp& cp, int tile_x, int tile_y) {
  TileBlocks t;
  t.br0 = tile_y * cp.tile_brows;
  t.bc0 = tile_x * cp.tile_bcols;
  t.nbr = min(cp.tile_brows, cp.bh - t.br0);
  t.nbc = min(cp.tile_bcols, cp.bw - t.bc0);
  return t;
}

// The sample (row, col) of the plane, computed alone.
__device__ __forceinline__ float plane_sample(const Comp& cp, const int16_t* plane,
                                              const float* q, const float* a, int row,
                                              int col) {
  const int16_t* block = plane + ((long long)(row >> 3) * cp.bw + (col >> 3)) * 64;
  float t[8];
  column_transform(block, q, a, col & 7, t);
  return row_sample(t, a, row & 7);
}

// Fill every component's region with the tile's samples and their halo.
// Region (lr, lc) holds the plane's sample (row0 - hy + lr, col0 - hx + lc)
// with row0 = 8 * br0, col0 = 8 * bc0; a halo sample outside the cropped
// plane holds the sample at the clamped index instead.
__device__ void fill(const Params& p, int img, int tile_x, int tile_y, float* smem, int tid,
                     int nthreads) {
  const float* a = smem;
  for (int c = 0; c < p.ncomp; ++c) {
    const Comp& cp = p.comp[c];
    const TileBlocks tb = tile_blocks(cp, tile_x, tile_y);
    const int16_t* plane = cp.coefs + (long long)img * cp.image_stride;
    const float* q = smem + kBasisFloats + c * 64;
    float* region = smem + cp.offset;
    const int row0 = 8 * tb.br0, col0 = 8 * tb.bc0;
    const int rows = 8 * tb.nbr + 2 * cp.hy, cols = 8 * tb.nbc + 2 * cp.hx;
    // the own blocks: a thread a block column
    const int columns = tb.nbr * tb.nbc * 8;
    for (int i = tid; i < columns; i += nthreads) {
      const int l = i & 7, j = (i >> 3) % tb.nbc, b = (i >> 3) / tb.nbc;
      const int16_t* block = plane + ((long long)(tb.br0 + b) * cp.bw + tb.bc0 + j) * 64;
      float t[8];
      column_transform(block, q, a, l, t);
      float* dst = region + (cp.hy + 8 * b) * cp.stride + cp.hx + 8 * j + l;
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[k * cp.stride] = row_sample(t, a, k);
    }
    // halo rows above and below, across the region's columns (corners included)
    if (cp.hy) {
      for (int i = tid; i < 2 * cols; i += nthreads) {
        const int side = i / cols, lc = i % cols;
        const int row = clampi(side ? row0 + 8 * tb.nbr : row0 - 1, cp.ch - 1);
        const int col = clampi(col0 - cp.hx + lc, cp.cw - 1);
        region[(side ? rows - 1 : 0) * cp.stride + lc] = plane_sample(cp, plane, q, a, row, col);
      }
    }
    // halo columns left and right, along the own rows
    if (cp.hx) {
      const int own_rows = 8 * tb.nbr;
      for (int i = tid; i < 2 * own_rows; i += nthreads) {
        const int side = i / own_rows, r = i % own_rows;
        const int col = clampi(side ? col0 + 8 * tb.nbc : col0 - 1, cp.cw - 1);
        region[(cp.hy + r) * cp.stride + (side ? cols - 1 : 0)] =
            plane_sample(cp, plane, q, a, row0 + r, col);
      }
    }
  }
}

// One upsampled sample of component c at output pixel (y, x).
__device__ __forceinline__ float upsampled(const Comp& cp, const float* region, int row0,
                                           int col0, int y, int x) {
  int ra, rb, ca, cb;
  if (cp.fancy_y) {
    const int i = y >> 1;
    ra = clampi(i, cp.ch - 1);
    rb = clampi((y & 1) ? i + 1 : i - 1, cp.ch - 1);
  } else {
    ra = rb = y / cp.fy;
  }
  if (cp.fancy_x) {
    const int k = x >> 1;
    ca = clampi(k, cp.cw - 1);
    cb = clampi((x & 1) ? k + 1 : k - 1, cp.cw - 1);
  } else {
    ca = cb = x / cp.fx;
  }
  const float* row_a = region + (ra - row0 + cp.hy) * cp.stride - col0 + cp.hx;
  const float* row_b = region + (rb - row0 + cp.hy) * cp.stride - col0 + cp.hx;
  // rows first, then columns, as the reference upsamples
  float va = row_a[ca], vb = row_a[cb];
  if (cp.fancy_y) {
    va = __fmul_rn(__fadd_rn(__fmul_rn(3.0f, va), row_b[ca]), 0.25f);
    vb = __fmul_rn(__fadd_rn(__fmul_rn(3.0f, vb), row_b[cb]), 0.25f);
  }
  return cp.fancy_x ? __fmul_rn(__fadd_rn(__fmul_rn(3.0f, va), vb), 0.25f) : va;
}

__device__ __forceinline__ uint8_t to_byte(float v) {
  return (uint8_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

// Upsample, convert and store the tile's pixels, one thread a pixel.
__device__ void emit(const Params& p, int img, int tile_x, int tile_y, const float* smem,
                     int tid, int nthreads) {
  const int y0 = tile_y * p.tile_rows, x0 = tile_x * p.tile_cols;
  const int th = min(p.tile_rows, p.height - y0), tw = min(p.tile_cols, p.width - x0);
  int row0[kMaxComps], col0[kMaxComps];
  for (int c = 0; c < p.ncomp; ++c) {
    const TileBlocks tb = tile_blocks(p.comp[c], tile_x, tile_y);
    row0[c] = 8 * tb.br0;
    col0[c] = 8 * tb.bc0;
  }
  for (int i = tid; i < th * tw; i += nthreads) {
    const int y = y0 + i / tw, x = x0 + i % tw;
    float v[kMaxComps];
    for (int c = 0; c < p.ncomp; ++c)
      v[c] = upsampled(p.comp[c], smem + p.comp[c].offset, row0[c], col0[c], y, x);
    const long long pixel = ((long long)img * p.height + y) * p.width + x;
    if (p.ncomp == 1) {
      if (p.out_f32) static_cast<float*>(p.out)[pixel] = v[0];
      else static_cast<uint8_t*>(p.out)[pixel] = to_byte(v[0]);
      continue;
    }
    const float luma = v[0];
    const float cb = __fsub_rn(v[1], 128.0f), cr = __fsub_rn(v[2], 128.0f);
    const float r = __fadd_rn(luma, __fmul_rn(1.402f, cr));
    const float g = __fadd_rn(__fadd_rn(luma, __fmul_rn(-0.344136286f, cb)),
                              __fmul_rn(-0.714136286f, cr));
    const float b = __fadd_rn(luma, __fmul_rn(1.772f, cb));
    if (p.out_f32) {
      float* dst = static_cast<float*>(p.out) + 3 * pixel;
      dst[0] = r;
      dst[1] = g;
      dst[2] = b;
    } else {
      uint8_t* dst = static_cast<uint8_t*>(p.out) + 3 * pixel;
      dst[0] = to_byte(r);
      dst[1] = to_byte(g);
      dst[2] = to_byte(b);
    }
  }
}

// __grid_constant__: the device functions take the parameters by reference
// where they lie, without a copy to local memory.
__global__ void __launch_bounds__(kThreads) jpeg_decode_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) smem[i] = p.basis[i];
  for (int img = blockIdx.z; img < p.n; img += gridDim.z) {
    // the image's dequantizing tables (the previous image's emit is done)
    for (int i = threadIdx.x; i < p.ncomp * 64; i += blockDim.x)
      smem[kBasisFloats + i] = (float)p.qtabs[(long long)img * p.ncomp * 64 + i];
    __syncthreads();
    fill(p, img, blockIdx.x, blockIdx.y, smem, threadIdx.x, blockDim.x);
    __syncthreads();
    emit(p, img, blockIdx.x, blockIdx.y, smem, threadIdx.x, blockDim.x);
    __syncthreads();
  }
}

// The launch's parameters and shared bytes, or -1 for arguments the kernel
// does not take.
long long make_params(Params& p, int ncomp, const int16_t* const* planes, const int* blocks,
                      const int* sampling, const int32_t* qtabs, int n, int height, int width,
                      int fancy, const float* basis, void* out, int out_f32) {
  if ((ncomp != 1 && ncomp != 3) || n < 0 || height < 1 || width < 1) return -1;
  int max_h = 1, max_v = 1;
  for (int c = 0; c < ncomp; ++c) {
    if (sampling[2 * c] < 1 || sampling[2 * c] > 4 || sampling[2 * c + 1] < 1 ||
        sampling[2 * c + 1] > 4)
      return -1;
    max_h = sampling[2 * c] > max_h ? sampling[2 * c] : max_h;
    max_v = sampling[2 * c + 1] > max_v ? sampling[2 * c + 1] : max_v;
  }
  p.ncomp = ncomp;
  p.n = n;
  p.height = height;
  p.width = width;
  p.qtabs = qtabs;
  p.out = out;
  p.out_f32 = out_f32;
  for (int i = 0; i < 64; ++i) p.basis[i] = basis[i];
  const int mcu_w = 8 * max_h;
  const int mcus = kMaxTileCols / mcu_w > 0 ? kMaxTileCols / mcu_w : 1;
  p.tile_rows = 8 * max_v;
  p.tile_cols = mcu_w * mcus;
  long long floats = kBasisFloats + kQuantFloats;
  for (int c = 0; c < ncomp; ++c) {
    Comp& cp = p.comp[c];
    const int h = sampling[2 * c], v = sampling[2 * c + 1];
    if (max_h % h || max_v % v) return -1;
    cp.coefs = planes[c];
    cp.bh = blocks[2 * c];
    cp.bw = blocks[2 * c + 1];
    cp.image_stride = (long long)cp.bh * cp.bw * 64;
    cp.fy = max_v / v;
    cp.fx = max_h / h;
    cp.ch = (int)(((long long)height * v + max_v - 1) / max_v);
    cp.cw = (int)(((long long)width * h + max_h - 1) / max_h);
    if ((long long)cp.bh * 8 < cp.ch || (long long)cp.bw * 8 < cp.cw) return -1;
    cp.fancy_y = fancy && cp.fy == 2;
    cp.fancy_x = fancy && cp.fx == 2;
    cp.hy = cp.fancy_y;
    cp.hx = cp.fancy_x;
    cp.tile_brows = v;
    cp.tile_bcols = h * mcus;
    cp.stride = 8 * cp.tile_bcols + 2 * cp.hx;
    cp.offset = (int)floats;
    floats += (long long)(8 * cp.tile_brows + 2 * cp.hy) * cp.stride;
  }
  return floats * (long long)sizeof(float);
}

}  // namespace

// planes: ncomp device pointers; blocks: per component (blocks_h, blocks_w);
// sampling: per component (h_samp, v_samp); qtabs: device int32 (n, ncomp,
// 64); basis: host float32 A[u * 8 + x]; out: device (n, height, width, 3)
// for 3 components, (n, height, width) for one; out_dtype 0 = uint8, 1 =
// float32.  Coefficient planes must be 16-byte aligned.  Returns a
// cudaError_t (0 = launched), or -1 for arguments the kernel does not take.
extern "C" int pst_jpeg_decode(int ncomp, const int16_t* const* planes, const int* blocks,
                               const int* sampling, const int32_t* qtabs, int n, int height,
                               int width, int fancy, const float* basis, void* out,
                               int out_dtype, void* stream) {
  if (out_dtype != 0 && out_dtype != 1) return -1;
  Params p;
  const long long bytes = make_params(p, ncomp, planes, blocks, sampling, qtabs, n, height,
                                      width, fancy, basis, out, out_dtype);
  if (bytes < 0 || bytes > kMaxSharedBytes) return -1;
  for (int c = 0; c < ncomp; ++c)
    if (((uintptr_t)planes[c]) & 15) return -1;
  if (n == 0) return 0;
  const dim3 grid((unsigned)((width + p.tile_cols - 1) / p.tile_cols),
                  (unsigned)((height + p.tile_rows - 1) / p.tile_rows),
                  (unsigned)(n < 65535 ? n : 65535));  // blocks loop over the images
  if (grid.y > 65535u) return -1;
  cudaError_t err = cudaFuncSetAttribute(jpeg_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  jpeg_decode_kernel<<<grid, kThreads, (size_t)bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
