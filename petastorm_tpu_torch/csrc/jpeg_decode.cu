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
// increasing v (T[u, l] = sum_v X[u, v] A[v, l]), then increasing u; the
// upsample and the color are written with explicitly rounded operations, as
// the plain version computes them.
//
// Two kernels compute it with the same float operations in the same order,
// so their outputs are equal byte for byte (uint8) and bit for bit
// (float32):
//   - jpeg_decode_tiled_kernel (pst_jpeg_decode_tiled), below, which every
//     launch of the package takes;
//   - jpeg_decode_kernel (pst_jpeg_decode), the first and simple design,
//     kept as the byte oracle and the timing yardstick
//     (ops/jpeg.launch_jpeg_decode(..., kernel="general")).
//
// Bound: bytes.  At the ImageNet batch (256 images of 224x224, 4:2:0) a
// kernel reads 38.7 MB (coefficients and quant tables) and writes 38.5 MB
// of pixels, 0.0231 ms at 3.35 TB/s; its 0.87 GFLOP of float32 need 0.013 ms.
//
// The general kernel: a block takes a tile of one image (one MCU row, 8 *
// max_v output rows, x up to 256 output columns); fill: the tile's blocks
// of every component go through the separable IDCT, one thread a block
// column (T[u] for its column l, then its 8 samples), into a float32 region
// of shared memory, with a one-sample halo where the triangle filter runs,
// each halo sample computed alone with the same arithmetic; emit: one
// thread a pixel, the upsample read from the regions at indices clamped to
// the cropped size, the color, the store.  At the main shape (3,584 tiles of
// 16 x 224 pixels, 256 threads) it is bound by instruction issue, not bytes:
//   1. each coefficient is converted and dequantized eight times: the eight
//      threads of a block's columns each unpack the whole block;
//   2. the chroma halo is computed a sample at a time, a whole column
//      transform for one sample: more work than the tile's own chroma;
//   3. the pixel loop costs about a hundred instructions a pixel: a run-time
//      division and modulo, the geometry branches, single-byte stores;
//   4. nothing overlaps: a block loads, computes and stores one tile.
//
// The tiled kernel, for each of those:
//   1. the 8 lanes of a warp that hold a block do both passes of its IDCT:
//      lane u converts and dequantizes row u's 8 coefficients once and
//      writes T[u][0..7] to the warp's scratch; after __syncwarp, lane l
//      reads column l back (T[0..7][l], conflict-free) and sums S[k][l] for
//      the 8 rows k at once, the basis as constants, into the component's
//      region of samples in shared memory;
//   2. the halo block rows (row 7 of the block row above, row 0 of the one
//      below) and, where a tile does not span the width, the halo block
//      columns go through the same passes as the tile's own blocks, with
//      only the rows the tile reads summed in the column pass;
//   3. the geometry is resolved per launch: instances for 4:2:0, 4:2:2 and
//      4:4:4 with fancy upsampling and for grayscale, in which a thread
//      takes 8 neighbouring pixels of one row: the full-size components'
//      samples as two float4 loads, the chroma upsampled from its region,
//      the color, three 8-byte stores (six 16-byte ones for float32); one
//      generic instance takes every other launch (4:1:1, 4:4:0, nearest)
//      pixel by pixel; the divisors a tile needs come from the host;
//   4. a persistent grid: each block walks tiles with a stride, the
//      coefficients and quant tables of a tile staged in shared memory by
//      cp.async.bulk (the TMA's 1-D copy), completed on an mbarrier, two
//      stages, so the tile after next arrives while a tile is computed.
// Its launch plan (tile size, staged blocks, shared bytes, blocks) comes
// from ops/jpeg.decode_launch_plan; at the main shape: tiles of 16 x 224,
// 72,192 shared bytes, three blocks an SM (80 registers).
// Both kernels launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

__host__ __device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

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

// ---------------------------------------------------------------------------
// The tiled kernel
// ---------------------------------------------------------------------------

namespace {

constexpr int kTiledThreads = 256;
constexpr int kTiledBlocksPerSM = 3;      // __launch_bounds__: three blocks' registers fit an SM
constexpr int kHeaderBytes = 2048;        // barriers, tile descriptors, quant tables
constexpr int kTStride = 68;              // floats of one quant table (see trow)
constexpr int kScratchStride = 72;        // floats of one block's T in a warp's scratch

enum Kind { kKind420 = 0, kKind422 = 1, kKind444 = 2, kKindGray = 3, kKindGeneric = 4 };

// Row u of an 8x8 float table in shared memory: rows 4-7 sit 4 floats
// further on, so the 8 rows of one table start in 8 different 4-bank
// groups.  A warp's 4 blocks' T lie kScratchStride = 72 floats apart, so
// that their columns fall in 32 different banks.
__host__ __device__ constexpr int trow(int u) { return u * 8 + (u & 4); }

struct TComp {
  const int16_t* coefs;     // (n, bh, bw, 64)
  long long image_stride;   // bh * bw * 64
  int bw;                   // block columns of the plane
  int fy, fx;               // upsample factors
  int ch, cw;               // cropped sampled size
  int fancy_y, fancy_x;     // the triangle filter on that axis (else nearest)
  int span_y, span_x;       // samples a whole tile reads (tile_rows / fy, tile_cols / fx)
  int end_y, end_x;         // the last sample the last tile reads ((height - 1) / fy, ...)
  unsigned long long nsc_magic[4];  // div_magic(staged block columns) by column class
  int stage_off;            // bytes from the start of a stage
  int region_off, region_stride;  // floats
};

struct TParams {
  TComp comp[kMaxComps];
  const int32_t* qtabs;     // (n, ncomp, 64)
  void* out;                // (n, height, width, channels)
  int ncomp, height, width, out_f32;
  int tile_rows, tile_cols, tiles_y, tiles_x;
  long long tiles;          // n * tiles_y * tiles_x
  unsigned long long groups_magic[2];  // div_magic(groups of 8 columns): a tile, the last
  int stage_bytes;          // a stage: the image's quant tables, then each component's blocks
  int region_base;          // bytes of shared memory; the stages start at kHeaderBytes and
                            // the warps' scratch after them
  float basis[64];          // A[u * 8 + x]
};

// One component's share of a tile.
struct CompTile {
  int rlo, rhi, clo, chi;   // the samples the tile reads, clamped to the cropped plane
  int sb0, nsb, sc0, nsc;   // their blocks, staged: rows [sb0, sb0 + nsb), cols [sc0, sc0 + nsc)
  int idct_end;             // IDCT tasks of components 0..c
  unsigned long long nsc_magic;
};

struct TileDesc {
  int img, y0, y1, x0, x1, groups;  // output rows [y0, y1), cols [x0, x1): groups of 8 columns
  unsigned long long groups_magic;
  int idct_total, emit_total;
  CompTile c[kMaxComps];
};

constexpr int kDescOff = 16;  // after the two stages' barriers; two descriptors
constexpr int kQfOff = kDescOff + 2 * (int)((sizeof(TileDesc) + 15) / 16 * 16);
static_assert(kQfOff + 4 * kMaxComps * kTStride <= kHeaderBytes, "the header outgrew kHeaderBytes");

// ceil(2^32 / d) = floor((2^32 - 1) / d) + 1: (i * m) >> 32 == i / d for
// i * d < 2^32.  Worked out on the host for each divisor a launch has.
unsigned long long div_magic(int d) { return (unsigned long long)(0xffffffffu / (unsigned)d) + 1; }

// A tile column's class: bit 0 the first column, bit 1 the last; the
// staged block columns, and so their divisor, depend on nothing else.
__host__ __device__ inline int column_class(int tx, int tiles_x) {
  return (tx == 0) | ((tx == tiles_x - 1) << 1);
}

__device__ __forceinline__ int div_by(int i, unsigned long long m) {
  return (int)(((unsigned long long)(unsigned)i * m) >> 32);
}

// A tile of the walk, stepped by the grid's size without a division.
struct Walk {
  int img, ty, tx;
  int step_img, step_ty, step_tx;  // the grid's size in images, tile rows and tile columns

  __device__ Walk(const TParams& p, long long first, long long step) {
    const long long per_image = (long long)p.tiles_y * p.tiles_x;
    img = (int)(first / per_image);
    const int rem = (int)(first - img * per_image);
    ty = rem / p.tiles_x;
    tx = rem - ty * p.tiles_x;
    step_img = (int)(step / per_image);
    const int step_rem = (int)(step - step_img * per_image);
    step_ty = step_rem / p.tiles_x;
    step_tx = step_rem - step_ty * p.tiles_x;
  }

  __device__ void advance(const TParams& p) {
    img += step_img;
    ty += step_ty;
    tx += step_tx;
    if (tx >= p.tiles_x) {
      tx -= p.tiles_x;
      ++ty;
    }
    if (ty >= p.tiles_y) {
      ty -= p.tiles_y;
      ++img;
    }
  }
};

// The samples one axis of tile t (of `tiles`) reads, clamped to [0, size):
// the tile's `span` samples (to `end` in the last tile) and, with the
// triangle filter, one neighbour on each side.
__host__ __device__ inline void axis_range(int t, int tiles, int span, int end, int fancy,
                                          int size, int& first, int& last) {
  first = clampi(t * span - fancy, size - 1);
  last = clampi((t == tiles - 1 ? end : t * span + span - 1) + fancy, size - 1);
}

__host__ __device__ inline void comp_tile(const TParams& p, const TComp& cp, int ty, int tx,
                                          CompTile& ct) {
  axis_range(ty, p.tiles_y, cp.span_y, cp.end_y, cp.fancy_y, cp.ch, ct.rlo, ct.rhi);
  axis_range(tx, p.tiles_x, cp.span_x, cp.end_x, cp.fancy_x, cp.cw, ct.clo, ct.chi);
  ct.sb0 = ct.rlo >> 3;
  ct.nsb = (ct.rhi >> 3) - ct.sb0 + 1;
  ct.sc0 = ct.clo >> 3;
  ct.nsc = (ct.chi >> 3) - ct.sc0 + 1;
}

// The tile's descriptor, worked out once by one thread.  IDCT tasks: 8 per
// staged block (its rows u, then its columns l), components one after the
// other.  Emit tasks: 8 per (block row, group of 8 columns) of the output
// tile (its rows k).
__device__ void tile_desc(const TParams& p, const Walk& w, TileDesc& d) {
  d.img = w.img;
  d.y0 = w.ty * p.tile_rows;
  d.y1 = min(d.y0 + p.tile_rows, p.height);
  d.x0 = w.tx * p.tile_cols;
  d.x1 = min(d.x0 + p.tile_cols, p.width);
  const int cls = column_class(w.tx, p.tiles_x);
  d.groups = (d.x1 - d.x0 + 7) >> 3;
  d.groups_magic = p.groups_magic[cls >> 1];
  d.emit_total = ((d.y1 - d.y0 + 7) >> 3) * d.groups * 8;
  int tasks = 0;
  for (int c = 0; c < kMaxComps; ++c) {
    CompTile& ct = d.c[c];
    if (c >= p.ncomp) {  // past the last component: an end no task reaches
      ct.idct_end = 0x7fffffff;
      continue;
    }
    const TComp& cp = p.comp[c];
    comp_tile(p, cp, w.ty, w.tx, ct);
    tasks += ct.nsb * ct.nsc * 8;
    ct.idct_end = tasks;
    ct.nsc_magic = cp.nsc_magic[cls];
  }
  d.idct_total = tasks;
}

// ---- the stages: cp.async.bulk into shared memory, completed on an mbarrier

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this block's earlier reads of a stage (generic proxy) before the
// copies that refill it (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(__cvta_generic_to_global(src)), "r"(bytes),
      "r"(smem_addr(bar))
      : "memory");
}

// Stage a tile (one thread): the image's quant tables, then each
// component's staged blocks as nsb rows of nsc blocks; one copy for a
// component whose rows span the plane's width (they lie back to back),
// else one a block row.
__device__ void stage_tile(const TParams& p, const Walk& w, unsigned char* stage,
                           uint64_t* bar) {
  CompTile ct[kMaxComps];
  uint32_t bytes = 256u * p.ncomp;
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    if (c >= p.ncomp) break;
    comp_tile(p, p.comp[c], w.ty, w.tx, ct[c]);
    bytes += 128u * ct[c].nsb * ct[c].nsc;
  }
  fence_proxy_async();
  mbar_expect_tx(bar, bytes);
  bulk_copy(stage, p.qtabs + (long long)w.img * p.ncomp * 64, 256u * p.ncomp, bar);
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    if (c >= p.ncomp) break;
    const TComp& cp = p.comp[c];
    const int16_t* src = cp.coefs + w.img * cp.image_stride +
                         ((long long)ct[c].sb0 * cp.bw + ct[c].sc0) * 64;
    unsigned char* dst = stage + cp.stage_off;
    const uint32_t row_bytes = 128u * ct[c].nsc;
    if (ct[c].nsc == cp.bw) {
      bulk_copy(dst, src, row_bytes * ct[c].nsb, bar);
    } else {
      for (int r = 0; r < ct[c].nsb; ++r)
        bulk_copy(dst + r * row_bytes, src + (long long)r * cp.bw * 64, row_bytes, bar);
    }
  }
}

// ---- the IDCT: both passes of a block in the 8 lanes that hold it

// Task i: block b = (i - start) >> 3 of component c, lane j = i & 7
// (= threadIdx.x & 7: the stride and every component's task count are
// multiples of 8).  Row pass, u = j: the row's 8 coefficients converted and
// dequantized once, T[u][0..7] into the warp's scratch.  Column pass,
// l = j: T[0..7][l] back, then S[k][l] for the rows k the tile reads,
// into the component's region (row r - rlo, column col - 8 * sc0 holds the
// plane's sample (r, col)).  The loop runs while any lane of the warp has a
// task, so every lane reaches the __syncwarp()s; lanes without one come in
// whole blocks of 8.
__device__ __forceinline__ void idct_blocks(const TParams& p, const TileDesc& d,
                                            const unsigned char* stage, const float* qf,
                                            float* scratch, float* regions) {
  const int lane = threadIdx.x & 31, j = lane & 7;
  float* tb = scratch + ((threadIdx.x >> 5) * 4 + (lane >> 3)) * kScratchStride;
  const int total = d.idct_total, end0 = d.c[0].idct_end, end1 = d.c[1].idct_end;
  for (int base = threadIdx.x - lane; base < total; base += kTiledThreads) {
    const int i = base + lane;
    const bool active = i < total;
    const int c = (i >= end0) + (i >= end1);
    const TComp& cp = p.comp[c];
    const int b = (i - (c == 0 ? 0 : c == 1 ? end0 : end1)) >> 3;
    if (active) {
      const int4 packed = *reinterpret_cast<const int4*>(stage + cp.stage_off + b * 128 + j * 16);
      const float4 qa = *reinterpret_cast<const float4*>(qf + c * kTStride + trow(j));
      const float4 qb = *reinterpret_cast<const float4*>(qf + c * kTStride + trow(j) + 4);
      const int32_t words[4] = {packed.x, packed.y, packed.z, packed.w};
      const float q[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      float x[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int16_t coef = (int16_t)((uint32_t)words[v >> 1] >> ((v & 1) * 16));
        x[v] = __fmul_rn((float)coef, q[v]);
      }
      float t[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        float acc = 0.0f;
#pragma unroll
        for (int v = 0; v < 8; ++v) acc = fmaf(x[v], p.basis[v * 8 + l], acc);
        t[l] = acc;
      }
      *reinterpret_cast<float4*>(tb + trow(j)) = make_float4(t[0], t[1], t[2], t[3]);
      *reinterpret_cast<float4*>(tb + trow(j) + 4) = make_float4(t[4], t[5], t[6], t[7]);
    }
    __syncwarp();
    if (active) {
      const CompTile& ct = d.c[c];
      float t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) t[u] = tb[trow(u) + j];
      const int bb = div_by(b, ct.nsc_magic), col = b - bb * ct.nsc;
      const int row0 = 8 * (ct.sb0 + bb);  // the block's first sample row
      const int k0 = max(ct.rlo - row0, 0), k1 = min(ct.rhi - row0, 7);
      float* dst = regions + cp.region_off + (row0 - ct.rlo) * cp.region_stride + 8 * col + j;
      if (k0 == 0 && k1 == 7) {  // a whole block: the 8 rows' sums interleaved
        float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = fmaf(p.basis[u * 8 + k], t[u], acc[k]);
#pragma unroll
        for (int k = 0; k < 8; ++k) dst[k * cp.region_stride] = __fadd_rn(acc[k], 128.0f);
      } else {  // a halo block, or the image's last rows: the rows the tile reads
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (k < k0 || k > k1) continue;
          float acc = 0.0f;
#pragma unroll
          for (int u = 0; u < 8; ++u) acc = fmaf(p.basis[u * 8 + k], t[u], acc);
          dst[k * cp.region_stride] = __fadd_rn(acc, 128.0f);
        }
      }
    }
    __syncwarp();  // the scratch takes the warp's next blocks
  }
}

// ---- emit: upsample, color, store; 8 neighbouring pixels a task

__device__ __forceinline__ float triangle(float near, float far) {
  return __fmul_rn(__fadd_rn(__fmul_rn(3.0f, near), far), 0.25f);
}

// Component c's samples upsampled to the output pixels (y, xs..xs+7), for a
// horizontal triangle filter and a vertical one (FANCY_Y) or none (fy = 1).
// Columns past the tile read at indices clamped to the staged ones: only
// pixels that are not stored take them.
template <bool FANCY_Y>
__device__ __forceinline__ void chroma8(const TComp& cp, const CompTile& ct, const float* regions,
                                        int y, int xs, float out[8]) {
  const float* base = regions + cp.region_off - 8 * ct.sc0;
  const float* row_a;
  const float* row_b;
  if (FANCY_Y) {
    const int i = y >> 1;
    row_a = base + (clampi(i, cp.ch - 1) - ct.rlo) * cp.region_stride;
    row_b = base + (clampi((y & 1) ? i + 1 : i - 1, cp.ch - 1) - ct.rlo) * cp.region_stride;
  } else {
    row_a = row_b = base + (y - ct.rlo) * cp.region_stride;
  }
  const int m0 = xs >> 1;
  float v[6];  // rows first, at the sample columns m0 - 1 .. m0 + 4
  if (m0 - 1 >= ct.clo && m0 + 4 <= ct.chi) {  // no column to clamp
#pragma unroll
    for (int e = 0; e < 6; ++e)
      v[e] = FANCY_Y ? triangle(row_a[m0 - 1 + e], row_b[m0 - 1 + e]) : row_a[m0 - 1 + e];
  } else {
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const int col = min(max(m0 + e - 1, ct.clo), ct.chi);
      v[e] = FANCY_Y ? triangle(row_a[col], row_b[col]) : row_a[col];
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float near3 = __fmul_rn(3.0f, v[e + 1]);
    out[2 * e] = __fmul_rn(__fadd_rn(near3, v[e]), 0.25f);
    out[2 * e + 1] = __fmul_rn(__fadd_rn(near3, v[e + 2]), 0.25f);
  }
}

// v rounded half to even and clipped to [0, 255], as to_byte: the
// conversion clamps below 0 (and takes NaN to 0) by itself.
__device__ __forceinline__ uint32_t byte_bits(float v) { return min(__float2uint_rn(v), 255u); }

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// Store 8 pixels of C channels from `pixel` on, the first `count` of them.
template <int C>
__device__ __forceinline__ void store_pixels(const TParams& p, long long pixel, int count,
                                             const float (&v)[8 * C]) {
  const long long first = C * pixel;
  if (p.out_f32) {
    float* dst = static_cast<float*>(p.out) + first;
    if (count == 8 && (first & 3) == 0) {
#pragma unroll
      for (int j = 0; j < 2 * C; ++j)
        reinterpret_cast<float4*>(dst)[j] =
            make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 8 * C; ++j)
        if (j < C * count) dst[j] = v[j];
    }
  } else {
    uint8_t* dst = static_cast<uint8_t*>(p.out) + first;
    uint32_t b[8 * C];
#pragma unroll
    for (int j = 0; j < 8 * C; ++j) b[j] = byte_bits(v[j]);
    if (count == 8 && (first & 7) == 0) {
#pragma unroll
      for (int j = 0; j < C; ++j)
        reinterpret_cast<uint2*>(dst)[j] =
            make_uint2(pack4(b[8 * j], b[8 * j + 1], b[8 * j + 2], b[8 * j + 3]),
                       pack4(b[8 * j + 4], b[8 * j + 5], b[8 * j + 6], b[8 * j + 7]));
    } else {
#pragma unroll
      for (int j = 0; j < 8 * C; ++j)
        if (j < C * count) dst[j] = (uint8_t)b[j];
    }
  }
}

__device__ __forceinline__ void store_rgb(const TParams& p, long long pixel, int count,
                                          const float (&y)[8], const float (&cb)[8],
                                          const float (&cr)[8]) {
  float rgb[24];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float b = __fsub_rn(cb[e], 128.0f), r = __fsub_rn(cr[e], 128.0f);
    rgb[3 * e] = __fadd_rn(y[e], __fmul_rn(1.402f, r));
    rgb[3 * e + 1] = __fadd_rn(__fadd_rn(y[e], __fmul_rn(-0.344136286f, b)),
                               __fmul_rn(-0.714136286f, r));
    rgb[3 * e + 2] = __fadd_rn(y[e], __fmul_rn(1.772f, b));
  }
  store_pixels<3>(p, pixel, count, rgb);
}

// 8 samples of a component at full size: output pixels (y, xs..xs+7) are
// its region's row y - rlo, columns xs - x0 on (sc0 = x0 / 8).
__device__ __forceinline__ void full8(const TComp& cp, const CompTile& ct, const float* regions,
                                      int y, int col, float out[8]) {
  const float* src = regions + cp.region_off + (y - ct.rlo) * cp.region_stride + col;
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
}

// Emit task i: row k = i & 7 of block row bb, group g of the output tile.
template <int K>
__device__ __forceinline__ void emit_fast(const TParams& p, const TileDesc& d,
                                          const float* regions) {
  const int total = d.emit_total, groups = d.groups, img = d.img;
  const int y0 = d.y0, y1 = d.y1, x0 = d.x0, x1 = d.x1;
  const unsigned long long gm = d.groups_magic;
  for (int i = threadIdx.x; i < total; i += kTiledThreads) {
    const int rest = i >> 3, bb = div_by(rest, gm), g = rest - bb * groups;
    const int y = y0 + 8 * bb + (i & 7);
    if (y >= y1) continue;
    const int xs = x0 + 8 * g, count = min(8, x1 - xs);
    const long long pixel = ((long long)img * p.height + y) * p.width + xs;
    float v0[8];
    full8(p.comp[0], d.c[0], regions, y, 8 * g, v0);
    if (K == kKindGray) {
      store_pixels<1>(p, pixel, count, v0);
      continue;
    }
    float v1[8], v2[8];
    if (K == kKind444) {
      full8(p.comp[1], d.c[1], regions, y, 8 * g, v1);
      full8(p.comp[2], d.c[2], regions, y, 8 * g, v2);
    } else {
      chroma8<K == kKind420>(p.comp[1], d.c[1], regions, y, xs, v1);
      chroma8<K == kKind420>(p.comp[2], d.c[2], regions, y, xs, v2);
    }
    store_rgb(p, pixel, count, v0, v1, v2);
  }
}

// The generic emit: every component from its region, upsampled pixel by
// pixel as the general kernel's `upsampled`; the column's sample index and
// remainder are stepped along the 8 pixels.
__device__ __forceinline__ void emit_generic(const TParams& p, const TileDesc& d,
                                             const float* regions) {
  const int total = d.emit_total, groups = d.groups;
  for (int i = threadIdx.x; i < total; i += kTiledThreads) {
    const int rest = i >> 3, bb = div_by(rest, d.groups_magic), g = rest - bb * groups;
    const int y = d.y0 + 8 * bb + (i & 7);
    if (y >= d.y1) continue;
    const int xs = d.x0 + 8 * g, count = min(8, d.x1 - xs);
    float v[kMaxComps][8];
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c) {
      if (c >= p.ncomp) break;
      const TComp& cp = p.comp[c];
      const CompTile& ct = d.c[c];
      int ra, rb;
      if (cp.fancy_y) {
        const int r = y >> 1;
        ra = clampi(r, cp.ch - 1);
        rb = clampi((y & 1) ? r + 1 : r - 1, cp.ch - 1);
      } else {
        ra = rb = y / cp.fy;
      }
      const float* base = regions + cp.region_off - 8 * ct.sc0;
      const float* row_a = base + (ra - ct.rlo) * cp.region_stride;
      const float* row_b = base + (rb - ct.rlo) * cp.region_stride;
      int m = xs / cp.fx, rem = xs - m * cp.fx;  // pixel xs + e: column m, remainder rem
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float out = 0.0f;
        if (e < count) {
          int ca = m, cb = m;
          if (cp.fancy_x) {
            const int x = xs + e, k = x >> 1;
            ca = clampi(k, cp.cw - 1);
            cb = clampi((x & 1) ? k + 1 : k - 1, cp.cw - 1);
          }
          float va = row_a[ca], vb = row_a[cb];
          if (cp.fancy_y) {
            va = triangle(va, row_b[ca]);
            vb = triangle(vb, row_b[cb]);
          }
          out = cp.fancy_x ? triangle(va, vb) : va;
        }
        v[c][e] = out;
        if (++rem == cp.fx) {
          rem = 0;
          ++m;
        }
      }
    }
    const long long pixel = ((long long)d.img * p.height + y) * p.width + xs;
    if (p.ncomp == 1) store_pixels<1>(p, pixel, count, v[0]);
    else store_rgb(p, pixel, count, v[0], v[1], v[2]);
  }
}

// A persistent block walks the tiles blockIdx.x, + gridDim.x, ...; local
// tile t sits in stage t & 1, whose barrier completes once a use.
template <int K>
__global__ void __launch_bounds__(kTiledThreads, kTiledBlocksPerSM)
    jpeg_decode_tiled_kernel(const __grid_constant__ TParams p) {
  extern __shared__ __align__(16) unsigned char tsmem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(tsmem);
  TileDesc* descs = reinterpret_cast<TileDesc*>(tsmem + kDescOff);  // tile t's is descs[t & 1]
  float* qf = reinterpret_cast<float*>(tsmem + kQfOff);
  unsigned char* stages = tsmem + kHeaderBytes;
  float* scratch = reinterpret_cast<float*>(stages + 2 * p.stage_bytes);
  float* regions = reinterpret_cast<float*>(tsmem + p.region_base);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    mbar_fence_init();
  }
  __syncthreads();
  const long long step = gridDim.x;
  Walk walk(p, blockIdx.x, step), ahead = walk;  // the tile, and the tile to stage next
  if (tid == 0) {
    for (int s = 0; s < 2; ++s, ahead.advance(p))
      if (blockIdx.x + s * step < p.tiles)
        stage_tile(p, ahead, stages + s * p.stage_bytes, &full[s]);
  }
  // Tile t waits for its stage, and gets its descriptor and its image's quant
  // tables as floats (rows as trow), at the end of tile t - 1.
  auto prepare = [&](int t, const Walk& w) {
    unsigned char* stage = stages + (t & 1) * p.stage_bytes;
    mbar_wait(&full[t & 1], (t >> 1) & 1);
    if (tid == 0) tile_desc(p, w, descs[t & 1]);
    if (tid < p.ncomp * 64)
      qf[(tid >> 6) * kTStride + trow((tid >> 3) & 7) + (tid & 7)] =
          (float)reinterpret_cast<const int32_t*>(stage)[tid];
  };
  if (blockIdx.x < p.tiles) prepare(0, walk);
  __syncthreads();
  int t = 0;
  for (long long tile = blockIdx.x; tile < p.tiles; tile += step, ++t) {
    const int s = t & 1;
    unsigned char* stage = stages + s * p.stage_bytes;
    const TileDesc& d = descs[s];
    idct_blocks(p, d, stage, qf, scratch, regions);
    __syncthreads();  // the stage is read: it takes the tile after next
    if (tid == 0) {
      if (tile + 2 * step < p.tiles) stage_tile(p, ahead, stage, &full[s]);
      ahead.advance(p);
    }
    if (K == kKindGeneric) emit_generic(p, d, regions);
    else emit_fast<K>(p, d, regions);
    walk.advance(p);
    if (tile + step < p.tiles) prepare(t + 1, walk);
    __syncthreads();
  }
}

// The smallest stride >= w floats that is `rem` more than a multiple of 32
// (rem a multiple of 4: float4 loads stay aligned).  16: the neighbouring
// chroma rows the emit reads at once spread over twice as many banks as at
// a multiple of 32; 4: 8 rows read as float4s at once fall in 8 different
// 4-bank groups.
int region_stride(int w, int rem) { return w + ((rem - w % 32) + 32) % 32; }

// The tiled launch's parameters, instance and shared bytes, or -1 for
// arguments the kernel does not take or a plan that differs from the one
// these shapes give (ops/jpeg.decode_launch_plan: [tile_rows, tile_cols,
// blocks, stage_bytes, shared_bytes, then per component the staged block
// rows and columns at most]).  The tile size and the number of blocks are
// the plan's choice; the rest follows from them and is checked.
long long make_tiled_params(TParams& p, int& kind, int& ctas, int ncomp,
                            const int16_t* const* planes, const int* blocks, const int* sampling,
                            const int32_t* qtabs, int n, int height, int width, int fancy,
                            const float* basis, void* out, int out_f32, const int* plan,
                            int plan_len) {
  if ((ncomp != 1 && ncomp != 3) || n < 0 || height < 1 || width < 1 ||
      plan_len != 5 + 2 * ncomp)
    return -1;
  int max_h = 1, max_v = 1;
  for (int c = 0; c < ncomp; ++c) {
    if (sampling[2 * c] < 1 || sampling[2 * c] > 4 || sampling[2 * c + 1] < 1 ||
        sampling[2 * c + 1] > 4)
      return -1;
    max_h = sampling[2 * c] > max_h ? sampling[2 * c] : max_h;
    max_v = sampling[2 * c + 1] > max_v ? sampling[2 * c + 1] : max_v;
  }
  const int tile_rows = plan[0], tile_cols = plan[1];
  ctas = plan[2];
  if (tile_rows < 8 * max_v || tile_rows % (8 * max_v) || tile_cols < 8 * max_h ||
      tile_cols % (8 * max_h) || ctas < 1)
    return -1;
  const int mcu_rows = tile_rows / (8 * max_v), mcu_cols = tile_cols / (8 * max_h);
  p.ncomp = ncomp;
  p.height = height;
  p.width = width;
  p.qtabs = qtabs;
  p.out = out;
  p.out_f32 = out_f32;
  p.tile_rows = tile_rows;
  p.tile_cols = tile_cols;
  p.tiles_y = (height + tile_rows - 1) / tile_rows;
  p.tiles_x = (width + tile_cols - 1) / tile_cols;
  p.tiles = (long long)n * p.tiles_y * p.tiles_x;
  if ((long long)p.tiles_y * p.tiles_x >= (1ll << 31)) return -1;
  for (int i = 0; i < 64; ++i) p.basis[i] = basis[i];
  int fy[kMaxComps] = {1, 1, 1}, fx[kMaxComps] = {1, 1, 1};
  for (int c = 0; c < ncomp; ++c) {
    if (max_h % sampling[2 * c] || max_v % sampling[2 * c + 1]) return -1;
    fx[c] = max_h / sampling[2 * c];
    fy[c] = max_v / sampling[2 * c + 1];
  }
  // the instance: luma at full size and two chroma components alike
  kind = kKindGeneric;
  if (ncomp == 1) {
    kind = kKindGray;
  } else if (fy[0] == 1 && fx[0] == 1 && fy[1] == fy[2] && fx[1] == fx[2]) {
    if (fy[1] == 1 && fx[1] == 1) kind = kKind444;
    else if (fancy && fy[1] == 2 && fx[1] == 2) kind = kKind420;
    else if (fancy && fy[1] == 1 && fx[1] == 2) kind = kKind422;
  }
  long long stage = 256ll * ncomp, rfloats = 0;
  for (int c = 0; c < ncomp; ++c) {
    TComp& cp = p.comp[c];
    const int h = sampling[2 * c], v = sampling[2 * c + 1];
    const int bh = blocks[2 * c];
    cp.coefs = planes[c];
    cp.bw = blocks[2 * c + 1];
    cp.image_stride = (long long)bh * cp.bw * 64;
    cp.fy = fy[c];
    cp.fx = fx[c];
    cp.ch = (int)(((long long)height * v + max_v - 1) / max_v);
    cp.cw = (int)(((long long)width * h + max_h - 1) / max_h);
    if ((long long)bh * 8 < cp.ch || (long long)cp.bw * 8 < cp.cw) return -1;
    cp.fancy_y = fancy && cp.fy == 2;
    cp.fancy_x = fancy && cp.fx == 2;
    cp.span_y = tile_rows / cp.fy;
    cp.span_x = tile_cols / cp.fx;
    cp.end_y = (height - 1) / cp.fy;
    cp.end_x = (width - 1) / cp.fx;
    // blocks a tile stages, at most
    const int cap_rows = std::min(v * mcu_rows + 2 * cp.fancy_y, bh);
    const int cap_cols = std::min(h * mcu_cols + 2 * cp.fancy_x, cp.bw);
    if (cap_rows != plan[5 + 2 * c] || cap_cols != plan[6 + 2 * c]) return -1;
    cp.stage_off = (int)stage;
    stage += 128ll * cap_rows * cap_cols;
    // a component the fast instances read a row at a time (8 rows k in a
    // quarter warp) wants row starts in 8 different 4-bank groups
    const bool rows8 = kind != kKindGeneric && cp.fy == 1 && cp.fx == 1;
    cp.region_stride = region_stride(8 * cap_cols, rows8 ? 4 : 16);
    cp.region_off = (int)rfloats;
    rfloats += (long long)(8 * v * mcu_rows + 2 * cp.fancy_y) * cp.region_stride;
  }
  // the divisors by column class (a class no tile column has keeps 0)
  const int last_x0 = (p.tiles_x - 1) * tile_cols;
  p.groups_magic[0] = div_magic(tile_cols / 8);
  p.groups_magic[1] = div_magic((width - last_x0 + 7) / 8);
  for (int cls = 0; cls < 4; ++cls) {
    const int tx = cls == 0 ? 1 : cls == 1 ? 0 : p.tiles_x - 1;
    const bool exists = cls == 3 ? p.tiles_x == 1 : cls == 0 ? p.tiles_x >= 3 : p.tiles_x >= 2;
    for (int c = 0; c < ncomp; ++c) {
      CompTile ct;
      comp_tile(p, p.comp[c], 0, tx, ct);
      p.comp[c].nsc_magic[cls] = exists ? div_magic(ct.nsc) : 0;
    }
  }
  const long long region_base =
      kHeaderBytes + 2 * stage + 4ll * kTiledThreads / 8 * kScratchStride;
  const long long bytes = region_base + 4 * rfloats;
  if (stage != plan[3] || bytes != plan[4] || bytes > kMaxSharedBytes) return -1;
  p.stage_bytes = (int)stage;
  p.region_base = (int)region_base;
  return bytes;
}

template <int K>
int launch_tiled(const TParams& p, int ctas, long long bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(jpeg_decode_tiled_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  jpeg_decode_tiled_kernel<K><<<ctas, kTiledThreads, (size_t)bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// pst_jpeg_decode's arguments, with the quant tables 16-byte aligned too,
// and the launch plan (`plan_len` ints, see make_tiled_params).  Returns a
// cudaError_t (0 = launched), or -1 for arguments or a plan the kernel does
// not take.
extern "C" int pst_jpeg_decode_tiled(int ncomp, const int16_t* const* planes, const int* blocks,
                                     const int* sampling, const int32_t* qtabs, int n, int height,
                                     int width, int fancy, const float* basis, void* out,
                                     int out_dtype, const int* plan, int plan_len, void* stream) {
  if (out_dtype != 0 && out_dtype != 1) return -1;
  TParams p;
  int kind = 0, ctas = 0;
  const long long bytes =
      make_tiled_params(p, kind, ctas, ncomp, planes, blocks, sampling, qtabs, n, height, width,
                        fancy, basis, out, out_dtype, plan, plan_len);
  if (bytes < 0 || ((uintptr_t)qtabs & 15)) return -1;
  for (int c = 0; c < ncomp; ++c)
    if (((uintptr_t)planes[c]) & 15) return -1;
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kKind420: return launch_tiled<kKind420>(p, ctas, bytes, s);
    case kKind422: return launch_tiled<kKind422>(p, ctas, bytes, s);
    case kKind444: return launch_tiled<kKind444>(p, ctas, bytes, s);
    case kKindGray: return launch_tiled<kKindGray>(p, ctas, bytes, s);
    default: return launch_tiled<kKindGeneric>(p, ctas, bytes, s);
  }
}
