// Block attention forward and backward on Hopper (sm_90a), float32.
//
// Replaces the XLA-compiled einsums of petastorm_tpu/ops/ring_attention.py
// (:40 _block_attention, merged by :30 _merge) and ops/ulysses.py
// (:37 _full_attention, the same computation over one block), and their
// gradients, which JAX takes by differentiating them:
//
//   forward   s = q.k^T * scale, masked where k_offset + j > q_offset + i
//             (causal), m = max_j s, p = exp(s - m), l = sum_j p, o = p.v;
//             merged into the running (o, l, m) in place by log-sum-exp
//             rescaling (the fused _merge);
//   backward  given the log-sum-exp of the finished rows (lse) and
//             delta = rowsum(dO * O): p = exp(s - lse), dV += p^T.dO,
//             dS = p * (dO.v^T - delta), dQ += dS.k * scale,
//             dK += dS^T.q * scale (flash-attention's backward).
//
// Bound: operations.  A forward block does 4*Sq*Sk*D flops a (batch, head)
// for 4*(Sq + Sk)*D bytes: at the trainer's 2048 x 2048 x 128 blocks that is
// 512 flops a byte, above the card's float32 balance (67 TFLOP/s over
// 3.35 TB/s, 20 flops a byte), so float32 FMAs bound it, not memory.  The
// backward does 2.5 times the forward's work (five products instead of two).
//
// Design (simple and right first; wgmma and TMA are later work):
//   * one thread block of 256 threads a (batch*head, 64-row tile); the
//     forward's tile is 64 query rows that loop over 64-row K/V tiles with an
//     online softmax, so the Sq x Sk scores never reach device memory;
//   * q, k, v (and dO) tiles are staged in shared memory with a row stride of
//     D + 1 floats (odd), so the 16 lanes that read 16 different rows at one
//     column hit 16 different banks; each thread keeps a 4 x 4 tile of scores
//     and a 4 x 8 tile of the output in registers (rows ty + 16 i, columns
//     tx + 16 j), and the row max and sum reduce over the 16 lanes of a
//     half-warp by shuffles;
//   * the mask comes from (q_offset, k_offset), not from a tensor, and a
//     causal block skips the K tiles (forward, dQ) or Q tiles (dK, dV) that
//     lie wholly in the future; a fully masked row keeps m = -inf, l = 0 and
//     o = 0, and its p is 0, never exp(-inf + inf);
//   * the backward is two kernels, one a K tile (dK, dV in registers, a loop
//     over the Q tiles) and one a Q tile (dQ in registers, a loop over the K
//     tiles).  They recompute the scores twice (seven products where five
//     would do) but need no atomics, so a gradient is the same bit for bit
//     from run to run, and each output element has one writer that adds to
//     what the ring has accumulated (+=);
//   * delta = rowsum(dO * O) is its own small kernel, a warp a row.
// Launched on the caller's stream; allocates nothing.  D is at most 128.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows of a Q tile and of a K/V tile
constexpr int kThreads = 256;   // 16 x 16: tx = tid & 15, ty = tid >> 4
constexpr int kMaxD = 128;
constexpr int kDj = kMaxD / 16;  // output columns a thread holds: tx + 16 jj
constexpr int kPld = kTile + 1;  // row stride of the P / dS tile

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [row0, row0 + kTile) of a (rows, D) matrix into a (kTile, ld) tile;
// rows past `rows` are zero
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          int row0, int rows, int D, int ld) {
  const int n = kTile * D;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    dst[r * ld + d] = (row0 + r < rows) ? src[(long long)(row0 + r) * D + d] : 0.f;
  }
}

// the 4 x 4 scores a thread owns, s = a_rows . b_cols over D, and (kTwo)
// t = c_rows . e_cols in the same pass
template <bool kTwo>
__device__ __forceinline__ void tile_dots(const float* __restrict__ a, const float* __restrict__ b,
                                          const float* __restrict__ c, const float* __restrict__ e,
                                          int D, int ld, int tx, int ty, float s[4][4],
                                          float t[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      t[i][j] = 0.f;
    }
  for (int d = 0; d < D; ++d) {
    float ar[4], br[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ar[i] = a[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) br[j] = b[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(ar[i], br[j], s[i][j]);
    if (kTwo) {
      float cr[4], er[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cr[i] = c[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) er[j] = e[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) t[i][j] = fmaf(cr[i], er[j], t[i][j]);
    }
  }
}

// acc[i][jj] += sum_r p[r][row_i] * x[r][tx + 16 jj] over the tile's rows
// (kTransposed: p is read as p^T, column row_i), else
// acc[i][jj] += sum_c p[row_i][c] * x[c][tx + 16 jj]
template <bool kTransposed>
__device__ __forceinline__ void tile_product(const float* __restrict__ p,
                                             const float* __restrict__ x, int n, int D, int ld,
                                             int tx, int ty, float acc[4][kDj]) {
  for (int r = 0; r < n; ++r) {
    float pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pr[i] = kTransposed ? p[r * kPld + ty + 16 * i] : p[(ty + 16 * i) * kPld + r];
#pragma unroll
    for (int jj = 0; jj < kDj; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) {
        const float xv = x[r * ld + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pr[i], xv, acc[i][jj]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
block_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ l, float* __restrict__ m, int Sq, int Sk, int D,
                           float scale, int causal, long long q_offset, long long k_offset) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;
  float* ks = qs + kTile * ld;
  float* vs = ks + kTile * ld;
  float* ps = vs + kTile * ld;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const float* qb = q + bh * Sq * D;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;

  load_tile(qs, qb, q0, Sq, D, ld);
  float acc[4][kDj];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kDj; ++jj) acc[i][jj] = 0.f;
  }
  const long long q_last = q_offset + min(q0 + kTile, Sq) - 1;
  for (int k0 = 0; k0 < Sk; k0 += kTile) {
    if (causal && k_offset + k0 > q_last) break;  // this and later tiles are future keys
    __syncthreads();  // the last tile's readers are done with ks, vs and ps
    load_tile(ks, kb, k0, Sk, D, ld);
    load_tile(vs, vb, k0, Sk, D, ld);
    __syncthreads();
    float s[4][4], unused[4][4];
    tile_dots<false>(qs, ks, nullptr, nullptr, D, ld, tx, ty, s, unused);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = q_offset + q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < Sk && (!causal || k_offset + col <= qpos);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], half_warp_max(mx));
      const float alpha = (m_run[i] == -INFINITY) ? 0.f : expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kPld + tx + 16 * j] = p;
        sum += p;
      }
      l_run[i] = l_run[i] * alpha + half_warp_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kDj; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();
    tile_product<false>(ps, vs, min(kTile, Sk - k0), D, ld, tx, ty, acc);
  }

  // merge into the running (o, l, m): the 16 threads of a row share a
  // half-warp, so they all read l and m before one of them writes them
  float m_old[4], l_old[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    m_old[i] = row < Sq ? m[bh * Sq + row] : -INFINITY;
    l_old[i] = row < Sq ? l[bh * Sq + row] : 0.f;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float m_out = fmaxf(m_old[i], m_run[i]);
    const float a = (m_old[i] == -INFINITY) ? 0.f : expf(m_old[i] - m_out);
    const float b = (m_run[i] == -INFINITY) ? 0.f : expf(m_run[i] - m_out);
    float* orow = o + (bh * Sq + row) * D;
#pragma unroll
    for (int jj = 0; jj < kDj; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) orow[d] = orow[d] * a + acc[i][jj] * b;
    }
    if (tx == 0) {
      l[bh * Sq + row] = l_old[i] * a + l_run[i] * b;
      m[bh * Sq + row] = m_out;
    }
  }
}

// p of the scores s a thread owns, given the rows' log-sum-exp
__device__ __forceinline__ float prob(float s, float lse, bool ok) {
  return (ok && lse != -INFINITY) ? expf(s - lse) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
block_attention_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
                            int D, float scale, int causal, long long q_offset,
                            long long k_offset) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* ks = smem;
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* dos = qs + kTile * ld;
  float* ps = dos + kTile * ld;
  float* lse_s = ps + kTile * kPld;
  float* delta_s = lse_s + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const float* qb = q + bh * Sq * D;
  const float* dob = dout + bh * Sq * D;

  load_tile(ks, k + bh * Sk * D, k0, Sk, D, ld);
  load_tile(vs, v + bh * Sk * D, k0, Sk, D, ld);
  float acc_dk[4][kDj], acc_dv[4][kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kDj; ++jj) acc_dk[i][jj] = acc_dv[i][jj] = 0.f;
  int qstart = 0;
  if (causal) {  // Q tiles wholly before this K tile see none of its keys
    const long long first = k_offset + k0 - q_offset;
    if (first > 0) qstart = (int)min((long long)Sq, first / kTile * kTile);
  }
  for (int q0 = qstart; q0 < Sq; q0 += kTile) {
    __syncthreads();
    load_tile(qs, qb, q0, Sq, D, ld);
    load_tile(dos, dob, q0, Sq, D, ld);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < Sq ? lse[bh * Sq + row] : -INFINITY;
      delta_s[threadIdx.x] = row < Sq ? delta[bh * Sq + row] : 0.f;
    }
    __syncthreads();
    // scores and dP = dO.v^T: query rows ty + 16 i, key columns tx + 16 j
    float s[4][4], dp[4][4];
    tile_dots<true>(qs, ks, dos, vs, D, ld, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const long long qpos = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = q0 + r < Sq && col < Sk && (!causal || k_offset + col <= qpos);
        s[i][j] = prob(s[i][j] * scale, lse_s[r], ok);  // s now holds p
        ps[r * kPld + tx + 16 * j] = s[i][j];
      }
    }
    __syncthreads();
    tile_product<true>(ps, dos, kTile, D, ld, tx, ty, acc_dv);  // dV += p^T.dO
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[r * kPld + tx + 16 * j] = s[i][j] * (dp[i][j] - delta_s[r]);  // dS
    }
    __syncthreads();
    tile_product<true>(ps, qs, kTile, D, ld, tx, ty, acc_dk);  // dK += dS^T.q
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Sk) continue;
    float* dkrow = dk + (bh * Sk + row) * D;
    float* dvrow = dv + (bh * Sk + row) * D;
#pragma unroll
    for (int jj = 0; jj < kDj; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) {
        dkrow[d] += acc_dk[i][jj] * scale;
        dvrow[d] += acc_dv[i][jj];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
block_attention_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, int Sq, int Sk, int D, float scale, int causal,
                          long long q_offset, long long k_offset) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;
  float* vs = ks + kTile * ld;
  float* ds = vs + kTile * ld;
  float* lse_s = ds + kTile * kPld;
  float* delta_s = lse_s + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;

  load_tile(qs, q + bh * Sq * D, q0, Sq, D, ld);
  load_tile(dos, dout + bh * Sq * D, q0, Sq, D, ld);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < Sq ? lse[bh * Sq + row] : -INFINITY;
    delta_s[threadIdx.x] = row < Sq ? delta[bh * Sq + row] : 0.f;
  }
  float acc[4][kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kDj; ++jj) acc[i][jj] = 0.f;
  const long long q_last = q_offset + min(q0 + kTile, Sq) - 1;
  for (int k0 = 0; k0 < Sk; k0 += kTile) {
    if (causal && k_offset + k0 > q_last) break;
    __syncthreads();
    load_tile(ks, kb, k0, Sk, D, ld);
    load_tile(vs, vb, k0, Sk, D, ld);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<true>(qs, ks, dos, vs, D, ld, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const long long qpos = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = q0 + r < Sq && col < Sk && (!causal || k_offset + col <= qpos);
        const float p = prob(s[i][j] * scale, lse_s[r], ok);
        ds[r * kPld + tx + 16 * j] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    tile_product<false>(ds, ks, min(kTile, Sk - k0), D, ld, tx, ty, acc);  // dQ += dS.k
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    float* dqrow = dq + (bh * Sq + row) * D;
#pragma unroll
    for (int jj = 0; jj < kDj; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) dqrow[d] += acc[i][jj] * scale;
    }
  }
}

// delta[row] = sum_d dout[row, d] * o[row, d]: one warp a row
__global__ void __launch_bounds__(kThreads)
attention_row_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum = fmaf(o[row * D + d], dout[row * D + d], sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

int fwd_smem_bytes(int D) { return (int)sizeof(float) * (3 * kTile * (D + 1) + kTile * kPld); }
int bwd_smem_bytes(int D) {
  return (int)sizeof(float) * (4 * kTile * (D + 1) + kTile * kPld + 2 * kTile);
}

bool bad_shape(long long BH, int Sq, int Sk, int D) {
  return BH < 0 || Sq < 0 || Sk < 0 || D < 1 || D > kMaxD || BH > 0x7fffffffLL ||
         (Sq + kTile - 1) / kTile > 65535 || (Sk + kTile - 1) / kTile > 65535;
}

}  // namespace

// Flash-attention forward of q (BH, Sq, D) against one K/V block (BH, Sk, D),
// merged into the running o (BH, Sq, D), l and m (BH, Sq) in place; float32,
// contiguous.  Returns a cudaError_t (0: launched), -1 for a shape it does
// not take.
extern "C" int pst_block_attention_fwd(const float* q, const float* k, const float* v, float* o,
                                       float* l, float* m, long long BH, int Sq, int Sk, int D,
                                       float scale, int causal, long long q_offset,
                                       long long k_offset, void* stream) {
  if (bad_shape(BH, Sq, Sk, D)) return -1;
  if (BH == 0 || Sq == 0 || Sk == 0) return 0;
  const int smem = fwd_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(block_attention_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)BH, (unsigned)((Sq + kTile - 1) / kTile));
  block_attention_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, o, l, m, Sq, Sk, D, scale, causal, q_offset, k_offset);
  return (int)cudaGetLastError();
}

// The block's gradients, added to dq (BH, Sq, D), dk and dv (BH, Sk, D):
// the dK/dV kernel, then the dQ kernel.  lse and delta are (BH, Sq).
// Returns as pst_block_attention_fwd.
extern "C" int pst_block_attention_bwd(const float* q, const float* k, const float* v,
                                       const float* dout, const float* lse, const float* delta,
                                       float* dq, float* dk, float* dv, long long BH, int Sq,
                                       int Sk, int D, float scale, int causal,
                                       long long q_offset, long long k_offset, void* stream) {
  if (bad_shape(BH, Sq, Sk, D)) return -1;
  if (BH == 0 || Sq == 0 || Sk == 0) return 0;
  const int smem = bwd_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(block_attention_dkdv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(block_attention_dq_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  block_attention_dkdv_kernel<<<dim3((unsigned)BH, (unsigned)((Sk + kTile - 1) / kTile)),
                                kThreads, smem, s>>>(q, k, v, dout, lse, delta, dk, dv, Sq, Sk,
                                                     D, scale, causal, q_offset, k_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  block_attention_dq_kernel<<<dim3((unsigned)BH, (unsigned)((Sq + kTile - 1) / kTile)),
                              kThreads, smem, s>>>(q, k, v, dout, lse, delta, dq, Sq, Sk, D,
                                                   scale, causal, q_offset, k_offset);
  return (int)cudaGetLastError();
}

// delta (rows,) = rowsum(dout * o) over rows of D floats.  Returns as above.
extern "C" int pst_attention_row_delta(const float* o, const float* dout, float* delta,
                                       long long rows, int D, void* stream) {
  if (rows < 0 || D < 1) return -1;
  if (rows == 0) return 0;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return -1;
  attention_row_delta_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      o, dout, delta, rows, D);
  return (int)cudaGetLastError();
}
