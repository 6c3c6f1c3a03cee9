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
// 512 flops a byte, far above the card's balance.  The products run on the
// tensor cores in error-compensated TF32 ("3xTF32", CUTLASS's
// OpMultiplyAddFastF32): each float32 operand x is split into big, x rounded
// to TF32 (cvt.rna.tf32.f32: nearest, ties away from zero), and
// small = x - big, which the tensor core reads as TF32 by dropping its low 13
// bits; a product is big.big + big.small + small.big.  The dropped
// small.small term and the two roundings leave at most about 2.5 * 2^-21
// (1.2e-6) of relative error a product, far inside the 1e-5 / 1e-4 the
// kernel is held to; one TF32 pass (2^-11) would not be
// (tests/test_torch_b4_tf32_split.py emulates both).  The tensor core
// truncates each float32 accumulation, so big.big accumulates apart from the
// small terms and a p.v-type product sums one tile in fresh registers
// before it is added, in float32, to the running output.  Three TF32
// products for each float32 one put the least time the card can take for
// this float32-accurate work at 495 / 3 = 165 TFLOP/s: at the trainer's
// diagonal block 0.416 ms forward and 1.04 ms backward (five products; the
// kernels do seven, see below).
//
// Design (FlashAttention-2's layout on mma.sync.m16n8k8 TF32; wgmma reads B
// from shared memory and takes TF32 operands K-major only, while the split
// needs both halves of every operand in registers and p.v, p^T.dO and
// dS^T.q each have an MN-major operand):
//   * one block of 8 warps owns 128 rows: query rows (forward, dQ) or key
//     rows (dK/dV); each warp owns 16 of them, and its score tile, its
//     output accumulators (O, dQ, or dK and dV) and its row max and sum
//     stay in registers; the row max and sum reduce over the 4 lanes of a
//     quad by shuffles;
//   * the other side streams through a 2-stage ring in shared memory filled
//     by cp.async (16-byte copies, or 4-byte copies where D % 4 != 0 or a
//     pointer is not 16-byte aligned), so the next tile's load overlaps this
//     tile's products: 64-key K/V tiles (forward), 32-key K/V tiles (dQ),
//     32-query Q/dO tiles (dK/dV);
//   * a tile row holds D rounded up to 64 or 128 floats (the kernel's two
//     instances), zero past D, so every product runs over whole k-steps of 8
//     with no branch; its 8-float groups are XOR-swizzled by the row
//     (see at()) so that every fragment load, 64 bits a lane, is free of
//     bank conflicts: the k-slots t and t + 4 of a k-step are its columns 2t
//     and 2t + 1, and n-tiles go in pairs whose columns interleave;
//   * the score accumulator's layout is not the A operand's (lane (g, t)
//     holds columns 2t, 2t+1 and needs t, t + 4), so the score product reads
//     its B rows permuted: mma column 2t is key (or query) t and column
//     2t + 1 is t + 4 of each 8.  P and dS then feed the next mma from the
//     registers they were computed in, split into big and small like every
//     other operand;
//   * the mask comes from (q_offset, k_offset); a causal block skips the
//     tiles that lie wholly in the future, a warp skips the products of a
//     tile none of its rows can see, and the forward and dQ launch the last
//     (longest) query tiles first so a causal launch ends with short ones;
//     a fully masked row keeps m = -inf, l = 0 and o = 0, and its p is 0,
//     never exp(-inf + inf);
//   * the backward is two kernels, one a K tile (dK, dV in registers, a
//     loop over the Q tiles) and one a Q tile (dQ in registers, a loop over
//     the K tiles).  They recompute the scores twice (seven products where
//     five would do) but need no atomics, so a gradient is the same bit for
//     bit from run to run, and each output element has one writer that adds
//     to what the ring has accumulated (+=);
//   * delta = rowsum(dO * O) is its own small kernel, a warp a row.
// Registers bound the occupancy: one block of 8 warps an SM (ptxas: the
// D <= 128 instances use 255 registers, the forward's and dK/dV's with a
// small spill), 196,608 bytes of dynamic shared memory (197,120 for dK/dV).
//
// The first kernels, SIMT float32 FMAs from shared memory (4 x 4 scores a
// thread, rows of D + 1 floats), are kept below as block_attention_*_simt
// (pst_block_attention_fwd_simt, pst_block_attention_bwd_simt): the timing
// yardstick and a second oracle, which no path of the package launches.
// Launched on the caller's stream; allocates nothing.  D is at most 128.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;

// -- the tensor-core kernels ----------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kOwnRows = 16 * kWarps;  // query (forward, dQ) or key (dK/dV) rows a block owns
constexpr int kFwdTile = 64;           // keys a streamed K/V tile of the forward
constexpr int kBwdTile = 32;           // rows a streamed tile of the backward kernels

// the float offset of (row, col) in a tile of LD floats a row (LD a multiple
// of 32): the row's 8-float groups XOR-swizzled by f(row) = (row & 3) ^
// ((row >> 1) & 2), so that the 64-bit fragment loads of a half-warp (4 rows
// by 8 floats, the rows 0-3, 4-7, {0, 4, 1, 5} or {2, 6, 3, 7} of an 8-row
// block) fall on 32 distinct banks
template <int LD>
__device__ __forceinline__ int at(int row, int col) {
  return row * LD + (col ^ (((row & 3) ^ ((row >> 1) & 2)) << 3));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + n) of a (rows, D) matrix into an n-row swizzled tile,
// by cp.async; rows past `rows` are zero-filled, columns >= D untouched
template <int LD>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, const float* __restrict__ src,
                                           int row0, int rows, int n, int D, bool vec) {
  if (vec) {
    const int cpr = D >> 2;  // 16-byte chunks a row
    for (int e = threadIdx.x; e < n * cpr; e += kMmaThreads) {
      const int r = e / cpr;
      const int c = (e - r * cpr) << 2;
      const bool ok = row0 + r < rows;
      cp_async16(dst + at<LD>(r, c), ok ? src + (long long)(row0 + r) * D + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < n * D; e += kMmaThreads) {
      const int r = e / D;
      const int c = e - r * D;
      const bool ok = row0 + r < rows;
      cp_async4(dst + at<LD>(r, c), ok ? src + (long long)(row0 + r) * D + c : src, ok);
    }
  }
}

// zero columns [D, LD) of `n` swizzled rows: the products run over all LD
template <int LD>
__device__ __forceinline__ void zero_tail(float* buf, int n, int D) {
  const int w = LD - D;
  for (int e = threadIdx.x; e < n * w; e += kMmaThreads) {
    const int r = e / w;
    buf[at<LD>(r, D + e - r * w)] = 0.f;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// x = big + small: big is cvt.rna.tf32.f32 of x (nearest, ties away from
// zero) in its integer form, the same for finite x without the four
// instructions of NaN and infinity handling; small = x - big (exact), which
// the tensor core reads as TF32 by dropping its low 13 bits
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// c[j] = a_rows . b_rows^T for the warp's 16 rows of `a` (from arow0) and the
// 8 NT rows of `b`, over LD columns (zero past D).  Lane (g, t) = (lane / 4,
// lane % 4) holds rows g and g + 8 (c[j][0..1], c[j][2..3]); c[j][0] and
// c[j][2] are b's row 8j + t, c[j][1] and c[j][3] its row 8j + t + 4: the
// score product reads b's rows permuted so that the scores are the A
// operand of the next product as they lie (see tile_product).  The k-slots
// t and t + 4 of a k-step are its columns 2t and 2t + 1, one 64-bit load.
// big.big accumulates apart from the two small terms: the tensor core
// truncates each accumulation, and the small terms' truncation is 2^-11
// times smaller.
template <int LD, int NT>
__device__ __forceinline__ void tile_scores(float (&c)[NT][4], const float* __restrict__ a,
                                            int arow0, const float* __restrict__ b, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int brow = (g >> 1) | ((g & 1) << 2);  // b's row for mma column g
  // the swizzled offsets of k-step kk are o[kk & 3] + 32 (kk >> 2)
  int oa[4], ob[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    oa[q] = at<LD>(arow0 + g, 8 * q + 2 * t);
    ob[q] = at<LD>(brow, 8 * q + 2 * t);
  }
  float lo[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = lo[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < LD / 8; ++kk) {
    const float* ak = a + oa[kk & 3] + 32 * (kk >> 2);
    const float2 x0 = lds2(ak);
    const float2 x1 = lds2(ak + 8 * LD);  // row g + 8: the same swizzle
    uint32_t ab[4], as[4];
    split(x0.x, ab[0], as[0]);
    split(x1.x, ab[1], as[1]);
    split(x0.y, ab[2], as[2]);
    split(x1.y, ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 y = lds2(b + ob[kk & 3] + 32 * (kk >> 2) + 8 * j * LD);
      uint32_t bb[2], bs[2];
      split(y.x, bb[0], bs[0]);
      split(y.y, bb[1], bs[1]);
      mma_tf32(lo[j], as, bb);
      mma_tf32(lo[j], ab, bs);
      mma_tf32(c[j], ab, bb);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += lo[j][e];
}

// acc[n] += p . b for the warp's 16 rows: p (16 x 8 NT) in tile_scores'
// layout, whose k-slot t of k-step j is b's row 8j + t, so it is the A
// operand as it lies; b is 8 NT rows of LD floats.  n-tiles go in pairs:
// column g of n-tiles 2m and 2m + 1 is b's column 16m + 2g and 16m + 2g + 1
// (one 64-bit load), so acc[n][e] holds column out_col(n, e, t).  Each pair
// sums this tile in fresh registers (big.big apart, as in tile_scores) and
// adds the sum to acc in float32: acc sees one rounding a tile, not the
// tensor core's truncation at every k-step.
template <int LD, int NT, int ND>
__device__ __forceinline__ void tile_product(float (&acc)[ND][4], const float (&p)[NT][4],
                                             const float* __restrict__ b, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t pb[NT][4], ps[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split(p[j][0], pb[j][0], ps[j][0]);  // row g, b row 8j + t
    split(p[j][2], pb[j][1], ps[j][1]);  // row g + 8
    split(p[j][1], pb[j][2], ps[j][2]);  // row g, b row 8j + t + 4
    split(p[j][3], pb[j][3], ps[j][3]);  // row g + 8
  }
  // b's rows t and t + 4, columns 16 c + 2g (c = 0, 1); column 16m + 2g adds
  // 32 (m >> 1) to those of c = m & 1
  int o0[2], o4[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    o0[c] = at<LD>(t, 16 * c + 2 * g);
    o4[c] = at<LD>(t + 4, 16 * c + 2 * g);
  }
#pragma unroll
  for (int n = 0; n < ND; n += 2) {
    float hi[2][4], lo[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) hi[h][e] = lo[h][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int off = 32 * (n >> 2) + 8 * j * LD;
      const float2 y0 = lds2(b + o0[(n >> 1) & 1] + off);
      const float2 y1 = lds2(b + o4[(n >> 1) & 1] + off);
      uint32_t bb[2][2], bs[2][2];
      split(y0.x, bb[0][0], bs[0][0]);
      split(y1.x, bb[0][1], bs[0][1]);
      split(y0.y, bb[1][0], bs[1][0]);
      split(y1.y, bb[1][1], bs[1][1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_tf32(lo[h], ps[j], bb[h]);
        mma_tf32(lo[h], pb[j], bs[h]);
        mma_tf32(hi[h], pb[j], bb[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n + h][e] += hi[h][e] + lo[h][e];
  }
}

// the column of D that acc[n][e] of tile_product holds in lane t
__device__ __forceinline__ int out_col(int n, int e, int t) {
  return 8 * (n & ~1) + 4 * t + 2 * (e & 1) + (n & 1);
}

// kND: n-steps of 8 along D the instance holds (8: D <= 64, 16: D <= 128)
template <int kND>
__global__ void __launch_bounds__(kMmaThreads, 1)
block_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ l, float* __restrict__ m, int Sq, int Sk, int D,
                           float scale, int causal, long long q_offset, long long k_offset,
                           int vec) {
  constexpr int LD = 8 * kND;
  constexpr int NT = kFwdTile / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // kOwnRows x LD
  float* ring = qs + kOwnRows * LD;    // [stage][K, V] x kFwdTile x LD
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwnRows;  // the longest causal tiles first
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;
  const int wrow = warp * 16;

  zero_tail<LD>(smem, kOwnRows + 4 * kFwdTile, D);
  stage_rows<LD>(qs, q + bh * Sq * D, q0, Sq, kOwnRows, D, vec);
  int ntiles = (Sk + kFwdTile - 1) / kFwdTile;
  if (causal) {  // tiles whose first key is past the block's last query are skipped
    const long long last = q_offset + min(q0 + kOwnRows, Sq) - 1 - k_offset;
    ntiles = last < 0 ? 0 : (int)min((long long)ntiles, last / kFwdTile + 1);
  }
  if (ntiles > 0) {
    stage_rows<LD>(ring, kb, 0, Sk, kFwdTile, D, vec);
    stage_rows<LD>(ring + kFwdTile * LD, vb, 0, Sk, kFwdTile, D, vec);
  }
  cp_async_commit();

  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // l: this lane's share
  const long long w_last = q_offset + q0 + wrow + 15;  // the warp's last query position
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kFwdTile;
    if (it + 1 < ntiles) {
      float* next = ring + ((it + 1) & 1) * 2 * kFwdTile * LD;
      stage_rows<LD>(next, kb, k0 + kFwdTile, Sk, kFwdTile, D, vec);
      stage_rows<LD>(next + kFwdTile * LD, vb, k0 + kFwdTile, Sk, kFwdTile, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and q) landed; the next one stays in flight
    __syncthreads();
    const float* ks = ring + (it & 1) * 2 * kFwdTile * LD;
    const float* vs = ks + kFwdTile * LD;
    if (!causal || k_offset + k0 <= w_last) {
      float s[NT][4];
      tile_scores<LD, NT>(s, qs, wrow, ks, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long qpos = q_offset + q0 + wrow + g + 8 * r;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + t + 4 * e;
            const bool ok = key < Sk && (!causal || k_offset + key <= qpos);
            float& x = s[j][2 * r + e];
            x = ok ? x * scale : -INFINITY;
            mx = fmaxf(mx, x);
          }
        const float m_new = fmaxf(m_run[r], quad_max(mx));
        const float alpha = (m_run[r] == -INFINITY) ? 0.f : expf(m_run[r] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * r + e];
            x = (x == -INFINITY) ? 0.f : expf(x - m_new);
            sum += x;
          }
        l_run[r] = l_run[r] * alpha + sum;
        m_run[r] = m_new;
#pragma unroll
        for (int n = 0; n < kND; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
      }
      tile_product<LD, NT, kND>(acc, s, vs, lane);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // merge into the running (o, l, m): the 4 lanes of a row's quad all read l
  // and m before one of them writes them
  float m_old[2], l_old[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    l_run[r] = quad_sum(l_run[r]);
    m_old[r] = row < Sq ? m[bh * Sq + row] : -INFINITY;
    l_old[r] = row < Sq ? l[bh * Sq + row] : 0.f;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    if (row >= Sq) continue;
    const float m_out = fmaxf(m_old[r], m_run[r]);
    const float a = (m_old[r] == -INFINITY) ? 0.f : expf(m_old[r] - m_out);
    const float b = (m_run[r] == -INFINITY) ? 0.f : expf(m_run[r] - m_out);
    float* orow = o + (bh * Sq + row) * D;
#pragma unroll
    for (int n = 0; n < kND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = out_col(n, e, t);
        if (d < D) orow[d] = orow[d] * a + acc[n][2 * r + e] * b;
      }
    if (t == 0) {
      l[bh * Sq + row] = l_old[r] * a + l_run[r] * b;
      m[bh * Sq + row] = m_out;
    }
  }
}

template <int kND>
__global__ void __launch_bounds__(kMmaThreads, 1)
block_attention_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
                            int D, float scale, int causal, long long q_offset,
                            long long k_offset, int vec) {
  constexpr int LD = 8 * kND;
  constexpr int NT = kBwdTile / 8;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                     // kOwnRows x LD
  float* vs = ks + kOwnRows * LD;       // kOwnRows x LD
  float* ring = vs + kOwnRows * LD;     // [stage][Q, dO] x kBwdTile x LD
  float* rows_s = ring + 4 * kBwdTile * LD;  // [stage][lse, delta] x kBwdTile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * kOwnRows;  // under causal the first key tiles see the most queries
  const float* qb = q + bh * Sq * D;
  const float* dob = dout + bh * Sq * D;
  const float* lseb = lse + bh * Sq;
  const float* deltab = delta + bh * Sq;
  const int wrow = warp * 16;

  zero_tail<LD>(smem, 2 * kOwnRows + 4 * kBwdTile, D);
  stage_rows<LD>(ks, k + bh * Sk * D, k0, Sk, kOwnRows, D, vec);
  stage_rows<LD>(vs, v + bh * Sk * D, k0, Sk, kOwnRows, D, vec);
  int qstart = 0;
  if (causal) {  // Q tiles wholly before this K tile see none of its keys
    const long long first = k_offset + k0 - q_offset;
    if (first > 0) qstart = (int)min((long long)Sq, first / kBwdTile * kBwdTile);
  }
  const int ntiles = (Sq - qstart + kBwdTile - 1) / kBwdTile;
  auto stage = [&](int it) {
    const int q0 = qstart + it * kBwdTile;
    float* dst = ring + (it & 1) * 2 * kBwdTile * LD;
    stage_rows<LD>(dst, qb, q0, Sq, kBwdTile, D, vec);
    stage_rows<LD>(dst + kBwdTile * LD, dob, q0, Sq, kBwdTile, D, vec);
    float* rs = rows_s + (it & 1) * 2 * kBwdTile;
    if (threadIdx.x < 2 * kBwdTile) {
      const int i = threadIdx.x & (kBwdTile - 1);
      const bool ok = q0 + i < Sq;
      const float* src = threadIdx.x < kBwdTile ? lseb : deltab;
      cp_async4(rs + threadIdx.x, ok ? src + q0 + i : src, ok);
    }
  };
  if (ntiles > 0) stage(0);
  cp_async_commit();

  float acc_dk[kND][4], acc_dv[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;
  const long long w_first = k_offset + k0 + wrow;  // the warp's first key position
  for (int it = 0; it < ntiles; ++it) {
    const int q0 = qstart + it * kBwdTile;
    if (it + 1 < ntiles) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* qs = ring + (it & 1) * 2 * kBwdTile * LD;
    const float* dos = qs + kBwdTile * LD;
    const float* lse_s = rows_s + (it & 1) * 2 * kBwdTile;
    const float* delta_s = lse_s + kBwdTile;
    if (!causal || q_offset + q0 + kBwdTile - 1 >= w_first) {
      // s = k.q^T (p^T) and dp = v.dO^T (dP^T): key rows g, g + 8 of the warp,
      // query columns 8j + t + 4e
      float s[NT][4], dp[NT][4];
      tile_scores<LD, NT>(s, ks, wrow, qs, lane);
      tile_scores<LD, NT>(dp, vs, wrow, dos, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = k0 + wrow + g + 8 * r;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * j + t + 4 * e;
            const float row_lse = lse_s[i];
            const bool ok = q0 + i < Sq && key < Sk && row_lse != -INFINITY &&
                            (!causal || k_offset + key <= q_offset + q0 + i);
            const float p = ok ? expf(s[j][2 * r + e] * scale - row_lse) : 0.f;
            s[j][2 * r + e] = p;
            dp[j][2 * r + e] = p * (dp[j][2 * r + e] - delta_s[i]);  // dS^T
          }
      }
      tile_product<LD, NT, kND>(acc_dv, s, dos, lane);  // dV += p^T.dO
      tile_product<LD, NT, kND>(acc_dk, dp, qs, lane);  // dK += dS^T.q
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + wrow + g + 8 * r;
    if (row >= Sk) continue;
    float* dkrow = dk + (bh * Sk + row) * D;
    float* dvrow = dv + (bh * Sk + row) * D;
#pragma unroll
    for (int n = 0; n < kND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = out_col(n, e, t);
        if (d < D) {
          dkrow[d] += acc_dk[n][2 * r + e] * scale;
          dvrow[d] += acc_dv[n][2 * r + e];
        }
      }
  }
}

template <int kND>
__global__ void __launch_bounds__(kMmaThreads, 1)
block_attention_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, int Sq, int Sk, int D, float scale, int causal,
                          long long q_offset, long long k_offset, int vec) {
  constexpr int LD = 8 * kND;
  constexpr int NT = kBwdTile / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // kOwnRows x LD
  float* dos = qs + kOwnRows * LD;    // kOwnRows x LD
  float* ring = dos + kOwnRows * LD;  // [stage][K, V] x kBwdTile x LD
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwnRows;  // the longest causal tiles first
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;
  const int wrow = warp * 16;

  zero_tail<LD>(smem, 2 * kOwnRows + 4 * kBwdTile, D);
  stage_rows<LD>(qs, q + bh * Sq * D, q0, Sq, kOwnRows, D, vec);
  stage_rows<LD>(dos, dout + bh * Sq * D, q0, Sq, kOwnRows, D, vec);
  int ntiles = (Sk + kBwdTile - 1) / kBwdTile;
  if (causal) {
    const long long last = q_offset + min(q0 + kOwnRows, Sq) - 1 - k_offset;
    ntiles = last < 0 ? 0 : (int)min((long long)ntiles, last / kBwdTile + 1);
  }
  if (ntiles > 0) {
    stage_rows<LD>(ring, kb, 0, Sk, kBwdTile, D, vec);
    stage_rows<LD>(ring + kBwdTile * LD, vb, 0, Sk, kBwdTile, D, vec);
  }
  cp_async_commit();
  float row_lse[2], row_delta[2];  // rows g and g + 8 of the warp; past Sq: lse = -inf
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    row_lse[r] = row < Sq ? lse[bh * Sq + row] : -INFINITY;
    row_delta[r] = row < Sq ? delta[bh * Sq + row] : 0.f;
  }

  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const long long w_last = q_offset + q0 + wrow + 15;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBwdTile;
    if (it + 1 < ntiles) {
      float* next = ring + ((it + 1) & 1) * 2 * kBwdTile * LD;
      stage_rows<LD>(next, kb, k0 + kBwdTile, Sk, kBwdTile, D, vec);
      stage_rows<LD>(next + kBwdTile * LD, vb, k0 + kBwdTile, Sk, kBwdTile, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ks = ring + (it & 1) * 2 * kBwdTile * LD;
    const float* vs = ks + kBwdTile * LD;
    if (!causal || k_offset + k0 <= w_last) {
      float s[NT][4], dp[NT][4];
      tile_scores<LD, NT>(s, qs, wrow, ks, lane);
      tile_scores<LD, NT>(dp, dos, wrow, vs, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long qpos = q_offset + q0 + wrow + g + 8 * r;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + t + 4 * e;
            const bool ok = key < Sk && row_lse[r] != -INFINITY &&
                            (!causal || k_offset + key <= qpos);
            const float p = ok ? expf(s[j][2 * r + e] * scale - row_lse[r]) : 0.f;
            s[j][2 * r + e] = p * (dp[j][2 * r + e] - row_delta[r]);  // dS
          }
      }
      tile_product<LD, NT, kND>(acc, s, ks, lane);  // dQ += dS.k
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    if (row >= Sq) continue;
    float* dqrow = dq + (bh * Sq + row) * D;
#pragma unroll
    for (int n = 0; n < kND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = out_col(n, e, t);
        if (d < D) dqrow[d] += acc[n][2 * r + e] * scale;
      }
  }
}

// -- the SIMT kernels: float32 FMAs from shared memory, kept as the timing
// yardstick and a second oracle (pst_block_attention_*_simt) ------------------

namespace simt {


constexpr int kTile = 64;       // rows of a Q tile and of a K/V tile
constexpr int kThreads = 256;   // 16 x 16: tx = tid & 15, ty = tid >> 4
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
block_attention_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
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
block_attention_dkdv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
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
block_attention_dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
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

int fwd_smem_bytes(int D) { return (int)sizeof(float) * (3 * kTile * (D + 1) + kTile * kPld); }
int bwd_smem_bytes(int D) {
  return (int)sizeof(float) * (4 * kTile * (D + 1) + kTile * kPld + 2 * kTile);
}

}  // namespace simt

// delta[row] = sum_d dout[row, d] * o[row, d]: one warp a row
constexpr int kDeltaThreads = 256;

__global__ void __launch_bounds__(kDeltaThreads)
attention_row_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int D) {
  const long long row = (long long)blockIdx.x * (kDeltaThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum = fmaf(o[row * D + d], dout[row * D + d], sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

bool bad_shape(long long BH, int Sq, int Sk, int D) {
  return BH < 0 || Sq < 0 || Sk < 0 || D < 1 || D > kMaxD || BH > 0x7fffffffLL ||
         (Sq + simt::kTile - 1) / simt::kTile > 65535 ||
         (Sk + simt::kTile - 1) / simt::kTile > 65535;
}

// 16-byte cp.async copies: D a multiple of 4 and every streamed matrix 16-byte aligned
int vector_copies(int D, const void* a, const void* b, const void* c,
                  const void* d = nullptr) {
  const uintptr_t bits = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d;
  return D % 4 == 0 && bits % 16 == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int kND>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* l, float* m,
               long long BH, int Sq, int Sk, int D, float scale, int causal, long long q_offset,
               long long k_offset, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (kOwnRows + 4 * kFwdTile) * 8 * kND;
  cudaError_t err = allow_smem(block_attention_fwd_kernel<kND>, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = vector_copies(D, q, k, v);
  dim3 grid((unsigned)BH, (unsigned)((Sq + kOwnRows - 1) / kOwnRows));
  block_attention_fwd_kernel<kND><<<grid, kMmaThreads, smem, stream>>>(
      q, k, v, o, l, m, Sq, Sk, D, scale, causal, q_offset, k_offset, vec);
  return (int)cudaGetLastError();
}

template <int kND>
int launch_bwd(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* delta, float* dq, float* dk, float* dv,
               long long BH, int Sq, int Sk, int D, float scale, int causal, long long q_offset,
               long long k_offset, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (2 * kOwnRows + 4 * kBwdTile) * 8 * kND;
  const int smem_dkdv = smem + (int)sizeof(float) * 4 * kBwdTile;
  cudaError_t err = allow_smem(block_attention_dkdv_kernel<kND>, smem_dkdv);
  if (err == cudaSuccess) err = allow_smem(block_attention_dq_kernel<kND>, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = vector_copies(D, q, k, v, dout);
  block_attention_dkdv_kernel<kND>
      <<<dim3((unsigned)BH, (unsigned)((Sk + kOwnRows - 1) / kOwnRows)), kMmaThreads, smem_dkdv,
         stream>>>(q, k, v, dout, lse, delta, dk, dv, Sq, Sk, D, scale, causal, q_offset,
                   k_offset, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  block_attention_dq_kernel<kND>
      <<<dim3((unsigned)BH, (unsigned)((Sq + kOwnRows - 1) / kOwnRows)), kMmaThreads, smem,
         stream>>>(q, k, v, dout, lse, delta, dq, Sq, Sk, D, scale, causal, q_offset, k_offset,
                   vec);
  return (int)cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  return D <= 64 ? launch_fwd<8>(q, k, v, o, l, m, BH, Sq, Sk, D, scale, causal, q_offset,
                                 k_offset, s)
                 : launch_fwd<16>(q, k, v, o, l, m, BH, Sq, Sk, D, scale, causal, q_offset,
                                  k_offset, s);
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
  cudaStream_t s = (cudaStream_t)stream;
  return D <= 64 ? launch_bwd<8>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Sq, Sk, D, scale,
                                 causal, q_offset, k_offset, s)
                 : launch_bwd<16>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Sq, Sk, D, scale,
                                  causal, q_offset, k_offset, s);
}

// The SIMT kernels' forward and backward, with the arguments and results of
// the two above: the timing yardstick and second oracle, launched by no path.
extern "C" int pst_block_attention_fwd_simt(const float* q, const float* k, const float* v,
                                            float* o, float* l, float* m, long long BH, int Sq,
                                            int Sk, int D, float scale, int causal,
                                            long long q_offset, long long k_offset,
                                            void* stream) {
  if (bad_shape(BH, Sq, Sk, D)) return -1;
  if (BH == 0 || Sq == 0 || Sk == 0) return 0;
  const int smem = simt::fwd_smem_bytes(D);
  cudaError_t err = allow_smem(simt::block_attention_fwd_simt_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)BH, (unsigned)((Sq + simt::kTile - 1) / simt::kTile));
  simt::block_attention_fwd_simt_kernel<<<grid, simt::kThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, o, l, m, Sq, Sk, D, scale, causal, q_offset, k_offset);
  return (int)cudaGetLastError();
}

extern "C" int pst_block_attention_bwd_simt(const float* q, const float* k, const float* v,
                                            const float* dout, const float* lse,
                                            const float* delta, float* dq, float* dk, float* dv,
                                            long long BH, int Sq, int Sk, int D, float scale,
                                            int causal, long long q_offset, long long k_offset,
                                            void* stream) {
  if (bad_shape(BH, Sq, Sk, D)) return -1;
  if (BH == 0 || Sq == 0 || Sk == 0) return 0;
  const int smem = simt::bwd_smem_bytes(D);
  cudaError_t err = allow_smem(simt::block_attention_dkdv_simt_kernel, smem);
  if (err == cudaSuccess) err = allow_smem(simt::block_attention_dq_simt_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  simt::block_attention_dkdv_simt_kernel<<<
      dim3((unsigned)BH, (unsigned)((Sk + simt::kTile - 1) / simt::kTile)), simt::kThreads, smem,
      s>>>(q, k, v, dout, lse, delta, dk, dv, Sq, Sk, D, scale, causal, q_offset, k_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  simt::block_attention_dq_simt_kernel<<<
      dim3((unsigned)BH, (unsigned)((Sq + simt::kTile - 1) / simt::kTile)), simt::kThreads, smem,
      s>>>(q, k, v, dout, lse, delta, dq, Sq, Sk, D, scale, causal, q_offset, k_offset);
  return (int)cudaGetLastError();
}

// delta (rows,) = rowsum(dout * o) over rows of D floats.  Returns as above.
extern "C" int pst_attention_row_delta(const float* o, const float* dout, float* delta,
                                       long long rows, int D, void* stream) {
  if (rows < 0 || D < 1) return -1;
  if (rows == 0) return 0;
  const long long blocks = (rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32);
  if (blocks > 0x7fffffffLL) return -1;
  attention_row_delta_kernel<<<(unsigned)blocks, kDeltaThreads, 0, (cudaStream_t)stream>>>(
      o, dout, delta, rows, D);
  return (int)cudaGetLastError();
}
