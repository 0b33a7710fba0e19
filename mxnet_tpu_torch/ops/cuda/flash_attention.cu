// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py:
//   flash_attention_fwd <- `_fwd_kernel` (launched by `_flash_fwd`)
//   flash_attention_dq  <- `_dq_kernel`  (launched by `_flash_bwd`)
//   flash_attention_dkv <- `_dkv_kernel` (launched by `_flash_bwd`)
// on q, k, v of shape (B*H, S, D), D = 64 or 128:
//   fwd : O = dropout(softmax(scale * Q K^T [causal])) V by an online
//         softmax over key tiles, and lse = m + log(l) per query row, with
//         l the softmax normaliser BEFORE dropout;
//   dq  : p = exp(scale * Q K^T - lse) recomputed, dp = mask(dO V^T),
//         ds = p * (dp - delta), dQ = ds K * scale;
//   dkv : dV = mask(p)^T dO, dK = ds^T Q * scale;
// with delta = rowsum(O * dO) computed by the caller in f32, as
// `_flash_bwd` computes it outside its kernels.  mask() keeps an entry
// where the counter hash `uniform01(bh, q, k, seed) >= dropout` and
// scales it by 1/(1 - dropout); it is drawn in registers from absolute
// positions in forward and backward alike, so no mask is ever stored and
// the result does not depend on the tiling.  The hash is the TPU kernels'
// `_uniform01` bit for bit (uint32 arithmetic, bh the flattened b*H + h).
// Both backward kernels recompute S = Q K^T and dP = dO V^T, as the two
// TPU kernels do; they are not merged into one, which would need atomics
// on dQ and would lose the same bits on every run.
//
// Types: q, k, v, dO and o are float or bf16 (all one type).  O, dQ, dK
// and dV are written in the input type, lse in f32.  S need not divide
// by the tile: rows and keys past S arrive as zeros and are masked.
//
// bf16 inputs (the training path) run on the tensor cores: the forward
// `fwd_tc_kernel`, dQ `dq_tc_kernel` and dK/dV `dkv_tc_kernel`.  A work
// item is 64 query rows (forward, dQ) or 64 keys (dK/dV) of one head:
// one warpgroup (128 threads) owns it and loops over the other axis'
// 64-wide tiles.  Blocks are persistent, as many as
// fit on the card at once, each walking items blockIdx.x, + gridDim.x,
// ...  Tiles come by TMA (3-D tensor maps over (D, S, B*H): rows past S
// come as zeros and never from the next head) into 128-byte-swizzled
// shared memory on mbarriers: the next item's own tiles while this item
// runs, the streamed pair two steps ahead, across items.  Results go out
// through the item's own tiles in shared memory by TMA, in whole lines
// (rows past S are not written).  Per tile, with wgmma m64nNk16 (bf16
// operands, f32 accumulators):
//   fwd : S = Q K^T from shared memory (K-major along D); the online
//         softmax in registers (each thread holds two rows of the
//         accumulator: row max and sum over the quad of lanes sharing a
//         row), O rescaled by alpha; then O += mask(P) V with p as the
//         A operand from registers and V read MN-major;
//   dQ  : S = Q K^T and dP = dO V^T from shared memory (K-major along D);
//         p and ds in registers on the accumulator fragments; then
//         dQ += ds K with ds as the A operand from registers (the
//         accumulator layout of the first product is the A-fragment
//         layout of the next) and K read MN-major (transposed);
//   dkv : S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T land in
//         accumulator layout (lse and delta indexed by column); then
//         dV += mask(P)^T dO and dK += dS^T Q, B read MN-major.
// Numerics: p and ds are f32, as the TPU kernels multiply them.  Each is
// cut into hi = bf16(x) and lo = bf16(x - hi) and both pieces go into
// one f32 accumulator against the exact bf16 operand (V, K, Q or dO): x to
// ~2^-16 relative, far inside the bf16 rounding of the outputs.  `scale`
// multiplies the f32 S accumulator (the plain versions scale q before the
// product), folded with log2(e) into one fma whose result goes to the
// SFU's 2^x: p = 2^(s scale log2(e) - lse log2(e)) to ~2^-19 relative
// for |scale s - lse| up to ~30 (the rounded constants and ex2.approx),
// again below the split's 2^-16.  The forward takes the same 2^x of
// s scale log2(e) - m log2(e) with m its running row max, and writes
// lse = m + log(l) to f32 accuracy, since the backward kernels recompute
// p from it.  At D = 64 scale is 1/8, exact; at
// D = 128 scaling the sum rather than q differs by an f32 ulp or so of
// s.  The summation order of the tensor cores differs from the plain
// versions' (and their f32 adds do not round to nearest), a few f32 ulps
// over these sums of 64-1024 terms.  The dropout test is an integer
// compare of the hash's 24 bits, the same mask bit for bit.  Accumulators
// stay in the block that owns them: no atomics, the same bits on every
// run.
//
// Bound (chip_smoke.py, at BERT-base's 768 x 128 x 64 bf16): all three
// kernels are bound by bytes (reading q, k, v and dO once);
// their flops with the split, at the bf16 tensor-core rate, take about a
// third of that.  What is left: the copies alone run near the card's
// copy rate, but a block's steps are serial (products, wait, the
// elementwise work of 2^x, the dropout hash and the split, products,
// wait), so compute overlaps the copies only across the three blocks
// resident on an SM (registers: dK/dV at 168 a thread; shared memory:
// dQ); each head's streamed tiles are read by two items at S = 128.
// Tried and measured slower (PERF.md): two warpgroups a block sharing
// the stream, items in consecutive shares per block.
//
// f32 inputs (the f32 model checks) keep SIMT bodies (`fwd_simt_kernel`,
// `dq_simt_kernel`, `dkv_simt_kernel`): one 256-thread block owns 64 rows, tiles
// are staged in shared memory as f32 with rows padded by one float, and
// each thread computes a 4 x 4 block of every 64 x 64 product and a
// 4 x D/16 block of every 64 x D one, all in f32.  Whole tiles past the
// diagonal are skipped under causal masking, as the TPU kernels skip
// whole blocks, in every body.  They are far above their bound.
//
// Every kernel allocates nothing and launches on the caller's stream;
// each entry point returns cudaGetLastError() after its launch.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"  // wgmma, mbarrier and TMA wrappers

namespace {

constexpr int kTile = 64;        // query rows / keys per tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kLdP = kTile + 1;  // row stride of a 64 x 64 f32 tile
constexpr float kNegInf = -1e30f;  // the TPU kernels' _NEG_INF

// The top 24 bits of the TPU kernels' `_uniform01` hash of (bh, q, k,
// seed), uint32 arithmetic wrapping mod 2^32.
__device__ __forceinline__ uint32_t hash24(uint32_t bh, uint32_t q,
                                           uint32_t k, uint32_t seed) {
  uint32_t x = q * 0x9E3779B9u + k * 0x85EBCA6Bu + bh * 0xC2B2AE35u + seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >> 8;
}

// `_uniform01`: U[0,1), the hash's top 24 bits scaled by 2^-24.
__device__ __forceinline__ float uniform01(uint32_t bh, uint32_t q,
                                           uint32_t k, uint32_t seed) {
  return static_cast<float>(hash24(bh, q, k, seed)) * (1.0f / 16777216.0f);
}

struct Drop {
  float p;        // dropout rate (0: off)
  float scale;    // 1 / (1 - p), rounded to f32 by the caller
  uint32_t seed;  // the int32 seed's bits
};

// The kernels' dropout argument: the int32 seed lies in device memory
// (the caller writes it there, e.g. a counter that a captured graph
// advances on every replay), read once by each thread at the start of a
// kernel; not read at all when p == 0.
struct DropArg {
  float p;
  float scale;
  const int* seed;
  __device__ __forceinline__ Drop load() const {
    return Drop{p, scale, p > 0.f ? static_cast<uint32_t>(__ldg(seed)) : 0u};
  }
};

// uniform01 >= p, as the tensor-core kernels test it: hash24 >= thr =
// ceil(p * 2^24), the same bits (u * 2^-24 and p * 2^24 are exact in
// f32, and hash24 is an integer).
__device__ __forceinline__ uint32_t keep_threshold(const Drop& drop) {
  return static_cast<uint32_t>(ceilf(drop.p * 16777216.f));
}

// Stage rows [row0, row0 + 64) of one (S, D) matrix into a 64 x (D+1) f32
// tile, times `mul`; rows at or past S are zeros.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int S, float mul) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D, g = row0 + r;
    dst[r * (D + 1) + c] = g < S ? src[(long long)g * D + c] * mul : 0.f;
  }
}

// Stage 64 f32 row values (lse or delta) starting at row0; zeros past S.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int row0, int S) {
  if (threadIdx.x < kTile) {
    const int g = row0 + threadIdx.x;
    dst[threadIdx.x] = g < S ? src[g] : 0.f;
  }
}

// acc[i][j] = sum_d (A[r_i][d] * amul) * B[c_j][d] for r_i = ty*4 + i,
// c_j = tx + 16 j: a 64 x 64 block of A B^T, A and B 64 x (D+1) tiles.
template <int D>
__device__ __forceinline__ void mm_abt(const float* A, const float* B,
                                       float amul, float acc[4][4], int ty,
                                       int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * (D + 1) + d] * amul;
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k P[r_i][k] * X[k][c_j], c_j = tx + 16 j: a 64 x D
// block of P X, P a 64 x 64 tile (stride kLdP), X a 64 x (D+1) tile.
template <int D>
__device__ __forceinline__ void mm_ab(const float* P, const float* X,
                                      float acc[4][D / 16], int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float a[4], b[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[(ty * 4 + i) * kLdP + k];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) b[j] = X[k * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_q P[q][r_i] * X[q][c_j]: a 64 x D block of P^T X.
template <int D>
__device__ __forceinline__ void mm_atb(const float* P, const float* X,
                                       float acc[4][D / 16], int ty, int tx) {
#pragma unroll 4
  for (int q = 0; q < kTile; ++q) {
    float a[4], b[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[q * kLdP + ty * 4 + i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) b[j] = X[q * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool in_mask(int qp, int kp, int S, bool causal) {
  return qp < S && kp < S && (!causal || qp >= kp);
}

// --------------------------------------------------------- forward, f32 ---
template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int S, float scale, int causal,
                    DropArg drop_arg) {
  const Drop drop = drop_arg.load();
  extern __shared__ float sm[];
  float* Qs = sm;                       // 64 x (D+1), times scale
  float* Ks = Qs + kTile * (D + 1);     // 64 x (D+1)
  float* Vs = Ks + kTile * (D + 1);     // 64 x (D+1)
  float* Ps = Vs + kTile * (D + 1);     // 64 x 65: scores, then p
  float* m_s = Ps + kTile * kLdP;       // running max per row
  float* l_s = m_s + kTile;             // running normaliser per row
  float* a_s = l_s + kTile;             // this tile's rescale per row
  const int bh = (int)blockIdx.x, q0 = blockIdx.y * kTile;
  const long long base = (long long)bh * S * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;

  stage<D>(Qs, q + base, q0, S, scale);
  if (tid < kTile) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  int n_k = (S + kTile - 1) / kTile;
  // under causal masking, key tiles wholly past the diagonal skip
  if (causal) n_k = min(n_k, (int)blockIdx.y + 1);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers of Ks/Vs/Ps are done
    stage<D>(Ks, k + base, k0, S, 1.f);
    stage<D>(Vs, v + base, k0, S, 1.f);
    __syncthreads();
    float s[4][4];
    mm_abt<D>(Qs, Ks, 1.f, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        Ps[r * kLdP + c] =
            in_mask(q0 + r, k0 + c, S, causal) ? s[i][j] : kNegInf;
      }
    __syncthreads();
    // online softmax: each warp owns 8 rows, each lane two columns
    for (int rr = 0; rr < kTile / 8; ++rr) {
      const int r = warp * (kTile / 8) + rr;
      const float x0 = Ps[r * kLdP + lane], x1 = Ps[r * kLdP + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (drop.p > 0.f) {
        const uint32_t qp = q0 + r;
        p0 = uniform01(bh, qp, k0 + lane, drop.seed) >= drop.p
                 ? p0 * drop.scale : 0.f;
        p1 = uniform01(bh, qp, k0 + lane + 32, drop.seed) >= drop.p
                 ? p1 * drop.scale : 0.f;
      }
      Ps[r * kLdP + lane] = p0;
      Ps[r * kLdP + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;  // the pre-dropout normaliser
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    mm_ab<D>(Ps, Vs, acc, ty, tx);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qp = q0 + r;
    if (qp < S) {
      const float l = l_s[r];
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        o[base + (long long)qp * D + tx + 16 * j] = acc[i][j] / l;
    }
  }
  if (tid < kTile && q0 + tid < S)
    lse[(long long)bh * S + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

// ------------------------------------------------------------- dQ, f32 ---
template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int S, float scale, int causal, DropArg drop_arg) {
  const Drop drop = drop_arg.load();
  extern __shared__ float sm[];
  float* Qs = sm;                       // 64 x (D+1), times scale
  float* dOs = Qs + kTile * (D + 1);    // 64 x (D+1)
  float* Ks = dOs + kTile * (D + 1);    // 64 x (D+1)
  float* Vs = Ks + kTile * (D + 1);     // 64 x (D+1)
  float* dSs = Vs + kTile * (D + 1);    // 64 x 65: ds
  float* lse_s = dSs + kTile * kLdP;
  float* dl_s = lse_s + kTile;
  const int bh = (int)blockIdx.x, q0 = blockIdx.y * kTile;
  const long long base = (long long)bh * S * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  stage<D>(Qs, q + base, q0, S, scale);
  stage<D>(dOs, dout + base, q0, S, 1.f);
  stage_rows(lse_s, lse + (long long)bh * S, q0, S);
  stage_rows(dl_s, delta + (long long)bh * S, q0, S);
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  int n_k = (S + kTile - 1) / kTile;
  if (causal) n_k = min(n_k, (int)blockIdx.y + 1);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    stage<D>(Ks, k + base, k0, S, 1.f);
    stage<D>(Vs, v + base, k0, S, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    mm_abt<D>(Qs, Ks, 1.f, s, ty, tx);
    mm_abt<D>(dOs, Vs, 1.f, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const int qp = q0 + r, kp = k0 + c;
        const float p =
            in_mask(qp, kp, S, causal) ? expf(s[i][j] - lse_s[r]) : 0.f;
        float d = dp[i][j];
        if (drop.p > 0.f)
          d = uniform01(bh, qp, kp, drop.seed) >= drop.p ? d * drop.scale
                                                         : 0.f;
        dSs[r * kLdP + c] = p * (d - dl_s[r]);
      }
    __syncthreads();
    mm_ab<D>(dSs, Ks, acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp < S) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        dq[base + (long long)qp * D + tx + 16 * j] = acc[i][j] * scale;
    }
  }
}

// ---------------------------------------------------------- dK/dV, f32 ---
template <int D>
__global__ void __launch_bounds__(kThreads)
    dkv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int S, float scale, int causal,
                    DropArg drop_arg) {
  const Drop drop = drop_arg.load();
  extern __shared__ float sm[];
  float* Ks = sm;                       // 64 x (D+1), this block's keys
  float* Vs = Ks + kTile * (D + 1);     // 64 x (D+1)
  float* Qs = Vs + kTile * (D + 1);     // 64 x (D+1), unscaled
  float* dOs = Qs + kTile * (D + 1);    // 64 x (D+1)
  float* Ps = dOs + kTile * (D + 1);    // 64 x 65: mask(p), rows = queries
  float* dSs = Ps + kTile * kLdP;       // 64 x 65: ds
  float* lse_s = dSs + kTile * kLdP;
  float* dl_s = lse_s + kTile;
  const int bh = (int)blockIdx.x, k0 = blockIdx.y * kTile;
  const long long base = (long long)bh * S * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  stage<D>(Ks, k + base, k0, S, 1.f);
  stage<D>(Vs, v + base, k0, S, 1.f);
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_q = (S + kTile - 1) / kTile;
  // under causal masking, query tiles wholly before this key tile skip
  for (int qt = causal ? (int)blockIdx.y : 0; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    stage<D>(Qs, q + base, q0, S, 1.f);
    stage<D>(dOs, dout + base, q0, S, 1.f);
    stage_rows(lse_s, lse + (long long)bh * S, q0, S);
    stage_rows(dl_s, delta + (long long)bh * S, q0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    mm_abt<D>(Qs, Ks, scale, s, ty, tx);  // rows = queries, cols = keys
    mm_abt<D>(dOs, Vs, 1.f, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const int qp = q0 + r, kp = k0 + c;
        const float p =
            in_mask(qp, kp, S, causal) ? expf(s[i][j] - lse_s[r]) : 0.f;
        float pd = p, d = dp[i][j];
        if (drop.p > 0.f) {
          const bool keep = uniform01(bh, qp, kp, drop.seed) >= drop.p;
          pd = keep ? p * drop.scale : 0.f;
          d = keep ? d * drop.scale : 0.f;
        }
        Ps[r * kLdP + c] = pd;
        dSs[r * kLdP + c] = p * (d - dl_s[r]);
      }
    __syncthreads();
    mm_atb<D>(Ps, dOs, dv_acc, ty, tx);
    mm_atb<D>(dSs, Qs, dk_acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp < S) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const long long at = base + (long long)kp * D + tx + 16 * j;
        dk[at] = dk_acc[i][j] * scale;
        dv[at] = dv_acc[i][j];
      }
    }
  }
}

// ------------------------------------- bf16 forward, dQ, dK/dV: tensor cores
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A block's shared memory: two slots of its own kOwn 64 x D tiles (the
// pair Q and dO, or K and V; the forward's Q alone: this item's and the
// next), two stages of the streamed pair (K and V, or Q and dO), each
// tile D/64 panels of 64 rows x 128 bytes (the TMA's 128-byte swizzle);
// four mbarriers (two slots, two stages; 64 bytes kept); (dK/dV) two
// stages of the streamed query tile's lse*log2(e) and delta.
template <int D, int kOwn = 2>
struct TcTiles {
  static constexpr int kPanels = D / 64;
  static constexpr int kBytes = kPanels * kPanelBytes;  // one 64 x D tile
  static constexpr int kStreamOff = 2 * kOwn * kBytes;
  static constexpr int kBarOff = kStreamOff + 4 * kBytes;
  static constexpr int kRowsOff = kBarOff + 64;
  static constexpr int smem_bytes() {
    return 1024 + kRowsOff + 2 * 2 * kTile * 4;
  }
};

// A persistent block's walk: work items w = blockIdx.x, + gridDim.x, ...
// below n_items, item w = (head w / n_t, own tile w % n_t); per item the
// streamed tiles first(t)..last(t) (forward and dQ, `dq` true: key tiles
// up to the diagonal under causal masking; dK/dV: query tiles from it).
struct Walk {
  int n_t, n_items;
  bool causal, dq;
  __device__ int first(int t) const { return !dq && causal ? t : 0; }
  __device__ int last(int t) const { return dq && causal ? t : n_t - 1; }
  // (w, st) to the block's next step; false past its last
  __device__ bool next(int& w, int& st) const {
    if (st < last(w % n_t)) {
      ++st;
      return true;
    }
    w += gridDim.x;
    st = first(w % n_t);
    return w < n_items;
  }
};

// Thread 0: the 64 x D tile of rows [row0, row0 + 64) of head bh, as its
// D/64 panels, completing on `bar`.
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int bh) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    tma_load_3d(dst + p * kPanelBytes, map, bar, p * 64, row0, bh);
}

// acc = A B^T over D for two 64 x D tiles in shared memory, both K-major
// along D: 16 columns (32 bytes) a step within a panel, then the next
// panel.
template <int D>
__device__ __forceinline__ void mma_abt_tc(float (&acc)[32], const uint8_t* a,
                                           const uint8_t* b) {
  const uint32_t a0 = smem_u32(a), b0 = smem_u32(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    wgmma64<0, 0>(acc, smem_desc(a0 + off, 16, 1024),
                  smem_desc(b0 + off, 16, 1024), kk > 0);
  }
}

// acc[64 x D] += X B with X (64 x 64) as the hi and lo bf16 pieces of its
// k16 steps in A-fragment registers, and B a 64 x D tile in shared
// memory read MN-major: 16 rows (2048 bytes) a step, panels kPanelBytes
// apart.
template <int D>
__device__ __forceinline__ void mma_xb_tc(float (&acc)[D / 64][32],
                                          const uint32_t (&x)[4][2][4],
                                          const uint8_t* b) {
  const uint32_t b0 = smem_u32(b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t db = smem_desc(b0 + j * 2048, kPanelBytes, 1024);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if constexpr (D == 64)
        wgmma64_rs(acc[0], x[j][t], db);
      else
        wgmma128_rs(acc[0], acc[D / 64 - 1], x[j][t], db);
    }
  }
}

// Accumulator element i of a 64 x N wgmma result held by this thread:
// row 16*warp + lane/4 (+8 when bit 1 of i is set), column
// 8*(i/4) + 2*(lane%4) + i%2.
__device__ __forceinline__ int acc_row(int i) {
  return (threadIdx.x % 128) / 32 * 16 + (threadIdx.x % 32) / 4 +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

// The 64 x 64 f32 values v (accumulator layout) as A fragments of four
// k16 steps, each in two bf16 pieces: x[j][0] = hi = bf16(v), x[j][1] =
// lo = bf16(v - hi).  Elements 8j..8j+7 hold columns 16j..16j+15, in
// the A-fragment order of the step's four registers.
__device__ __forceinline__ void split_frags(const float (&v)[32],
                                            uint32_t (&x)[4][2][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = v[8 * j + 2 * r], b = v[8 * j + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(a - __low2float(hi), b - __high2float(hi));
      x[j][0][r] = *reinterpret_cast<const uint32_t*>(&hi);
      x[j][1][r] = *reinterpret_cast<const uint32_t*>(&lo);
    }
}

__device__ __forceinline__ void keep_frags(const uint32_t (&x)[4][2][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int t = 0; t < 2; ++t) keep(x[j][t]);
}

// A 64 x D accumulator times `mul` as bf16 into a 64 x D tile of shared
// memory, in the TMA's 128-byte swizzle (conflict-free: the eight rows
// of a warp's store land in eight different 16-byte columns of banks).
template <int D>
__device__ __forceinline__ void stage_out(uint8_t* tile,
                                          const float (&acc)[D / 64][32],
                                          float mul) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = acc_row(i), c = acc_col(i);
      *reinterpret_cast<__nv_bfloat162*>(tile + p * kPanelBytes +
                                         swz(r, c / 8) + (c % 8) * 2) =
          __floats2bfloat162_rn(acc[p][i] * mul, acc[p][i + 1] * mul);
    }
}

// One thread: a staged 64 x D tile to rows [row0, row0 + 64) of head bh
// (rows past S are not written), as one bulk group; its shared memory
// may be written again after bulk_wait_read().
template <int D>
__device__ __forceinline__ void store_out(const CUtensorMap* map,
                                          const uint8_t* tile, int row0,
                                          int bh) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    tma_store_3d(map, tile + p * kPanelBytes, p * 64, row0, bh);
  bulk_commit();
}

// 2^x by the SFU (ex2.approx.ftz: ~2^-22 relative, results below 2^-126
// flushed to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// dQ's terms on this thread's 32 elements of a 64 x 64 tile (rows =
// queries from q0, columns = keys from k0), in place of s: p =
// exp(scale s - lse) as 2^(s scale log2(e) - lse log2(e)), masked only
// on a tile that reaches past S or the diagonal (kEdge); dp masked by
// the dropout hash (kDrop); ds = p (dp - delta).  lse2 = lse log2(e).
template <bool kEdge, bool kDrop>
__device__ __forceinline__ void dq_terms(float (&s)[32],
                                         const float (&dp)[32],
                                         const float (&lse2)[2],
                                         const float (&dl)[2], int q0,
                                         int k0, int S, bool causal,
                                         float sl2, int bh, Drop drop) {
  const uint32_t thr = keep_threshold(drop);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    const int qp = q0 + acc_row(i), kp = k0 + acc_col(i);
    float p = ex2(fmaf(s[i], sl2, -lse2[h]));
    if (kEdge && !in_mask(qp, kp, S, causal)) p = 0.f;
    float d = dp[i];
    if (kDrop)
      d = hash24(bh, qp, kp, drop.seed) >= thr ? d * drop.scale : 0.f;
    s[i] = p * (d - dl[h]);
  }
}

// dK/dV's terms on a 64 x 64 tile of S^T and dP^T (rows = keys from k0,
// columns = queries from q0; lse2 and dl indexed by column, from shared
// memory): s becomes mask(p)^T and dp becomes ds^T.
template <bool kEdge, bool kDrop>
__device__ __forceinline__ void dkv_terms(float (&s)[32], float (&dp)[32],
                                          const float* lse2,
                                          const float* dl, int q0, int k0,
                                          int S, bool causal, float sl2,
                                          int bh, Drop drop) {
  const uint32_t thr = keep_threshold(drop);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = acc_col(i);
    const int kp = k0 + acc_row(i), qp = q0 + c;
    float p = ex2(fmaf(s[i], sl2, -lse2[c]));
    if (kEdge && !in_mask(qp, kp, S, causal)) p = 0.f;
    float pd = p, d = dp[i];
    if (kDrop) {
      const bool keep = hash24(bh, qp, kp, drop.seed) >= thr;
      pd = keep ? p * drop.scale : 0.f;
      d = keep ? d * drop.scale : 0.f;
    }
    s[i] = pd;
    dp[i] = p * (d - dl[c]);
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The parts of a persistent tensor-core block: its shared memory, the
// walk, and thread 0's loads.  Thread 0 keeps the stream two steps ahead
// of the block (across items) and each item's own pair one item ahead.
template <int D, int kOwn = 2>
struct TcBlock {
  using L = TcTiles<D, kOwn>;
  uint8_t* own;        // [2 slots][kOwn own tiles]
  uint8_t* stream;     // [2 stages][streamed pair]
  uint64_t* bar;       // [own slot 0, 1, stage 0, 1]
  Walk walk;
  // thread 0's next streamed step (item pw, tile pst; the block's ps-th)
  int pw, pst, ps;
  bool pmore;

  __device__ TcBlock(uint8_t* smem, int n_t, int n_items, bool causal,
                     bool dq)
      : own(smem), stream(smem + L::kStreamOff),
        bar(reinterpret_cast<uint64_t*>(smem + L::kBarOff)),
        walk{n_t, n_items, causal, dq}, pw(blockIdx.x),
        pst(walk.first(blockIdx.x % n_t)), ps(0), pmore(true) {}

  __device__ uint8_t* own_tile(int j, int which) const {
    return own + ((j & 1) * kOwn + which) * L::kBytes;
  }
  __device__ uint8_t* stream_tile(int s, int which) const {
    return stream + ((s & 1) * 2 + which) * L::kBytes;
  }
  // thread 0: item w's own pair into slot j&1 (the forward's Q alone:
  // b null, kOwn 1)
  __device__ void load_own(int w, int j, const CUtensorMap* a,
                           const CUtensorMap* b) {
    uint64_t* bb = &bar[j & 1];
    const int row0 = w % walk.n_t * kTile, bh = w / walk.n_t;
    mbar_expect_tx(bb, (b != nullptr ? 2 : 1) * L::kBytes);
    load_tile<D>(own_tile(j, 0), a, bb, row0, bh);
    if (b != nullptr) load_tile<D>(own_tile(j, 1), b, bb, row0, bh);
  }
  // thread 0: the next streamed step's pair into its stage
  __device__ void load_step(const CUtensorMap* a, const CUtensorMap* b) {
    if (!pmore) return;
    uint64_t* bb = &bar[2 + (ps & 1)];
    const int bh = pw / walk.n_t;
    mbar_expect_tx(bb, 2 * L::kBytes);
    load_tile<D>(stream_tile(ps, 0), a, bb, pst * kTile, bh);
    load_tile<D>(stream_tile(ps, 1), b, bb, pst * kTile, bh);
    ++ps;
    pmore = walk.next(pw, pst);
  }
  // thread 0, once: barriers, the first item's own pair, two steps
  __device__ void start(const CUtensorMap* oa, const CUtensorMap* ob,
                        const CUtensorMap* sa, const CUtensorMap* sb) {
    for (int i = 0; i < 4; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_own(blockIdx.x, 0, oa, ob);
    load_step(sa, sb);
    load_step(sa, sb);
  }
  // thread 0, at item j's start: the next item's own pair, once slot
  // (j+1)&1's results (item j-1's) have been read out
  __device__ void next_own(int w, int j, const CUtensorMap* oa,
                           const CUtensorMap* ob) {
    if (w + (int)gridDim.x < walk.n_items) {
      bulk_wait_read();
      load_own(w + gridDim.x, j + 1, oa, ob);
    }
  }
};

// Replaces `_dq_kernel` for bf16.  A persistent block of one warpgroup
// walks items (head, 64 query rows); per item, the key tiles stream past
// its Q and dO.
template <int D>
__global__ void __launch_bounds__(128)
    dq_tc_kernel(const __grid_constant__ CUtensorMap qm,
                 const __grid_constant__ CUtensorMap km,
                 const __grid_constant__ CUtensorMap vm,
                 const __grid_constant__ CUtensorMap dom,
                 const __grid_constant__ CUtensorMap dqm, int n_items,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, int S, float scale,
                 int causal, DropArg drop_arg) {
  const Drop drop = drop_arg.load();
  extern __shared__ uint8_t smem_raw[];
  const int n_t = (S + kTile - 1) / kTile, tid = threadIdx.x;
  TcBlock<D> blk(align1024(smem_raw), n_t, n_items, causal, true);
  if (tid == 0) blk.start(&qm, &dom, &km, &vm);
  __syncthreads();   // the barriers are initialised

  const float sl2 = scale * kLog2e;
  const bool dropping = drop.p > 0.f;
  float acc[D / 64][32];
  int s = 0;         // the block's streamed step
  for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
    const int bh = w / n_t, qt = w % n_t, q0 = qt * kTile;
    if (tid == 0) blk.next_own(w, j, &qm, &dom);
    // lse and delta of this thread's two rows (h: +8)
    float lse2[2], dl_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = q0 + acc_row(2 * h);
      const long long at = (long long)bh * S + g;
      lse2[h] = g < S ? lse[at] * kLog2e : 0.f;
      dl_r[h] = g < S ? delta[at] : 0.f;
    }
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
    uint8_t* q_t = blk.own_tile(j, 0);
    const uint8_t* do_t = blk.own_tile(j, 1);
    mbar_wait(&blk.bar[j & 1], (j >> 1) & 1);
    for (int kt = 0; kt <= blk.walk.last(qt); ++kt, ++s) {
      const int k0 = kt * kTile;
      const uint8_t* k_t = blk.stream_tile(s, 0);
      mbar_wait(&blk.bar[2 + (s & 1)], (s >> 1) & 1);
      float sc[32], dp[32];
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
      mma_abt_tc<D>(sc, q_t, k_t);                         // Q K^T
      mma_abt_tc<D>(dp, do_t, blk.stream_tile(s, 1));      // dO V^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      // ds, in place of sc; masks only on the diagonal tile and the tail
      if ((causal && kt == qt) || k0 + kTile > S || q0 + kTile > S) {
        if (dropping)
          dq_terms<true, true>(sc, dp, lse2, dl_r, q0, k0, S, causal, sl2,
                               bh, drop);
        else
          dq_terms<true, false>(sc, dp, lse2, dl_r, q0, k0, S, causal, sl2,
                                bh, drop);
      } else if (dropping) {
        dq_terms<false, true>(sc, dp, lse2, dl_r, q0, k0, S, causal, sl2,
                              bh, drop);
      } else {
        dq_terms<false, false>(sc, dp, lse2, dl_r, q0, k0, S, causal, sl2,
                               bh, drop);
      }
      uint32_t x[4][2][4];
      split_frags(sc, x);
#pragma unroll
      for (int p = 0; p < D / 64; ++p) fence_acc(acc[p]);
      wgmma_fence();
      mma_xb_tc<D>(acc, x, k_t);                           // dQ += ds K
      wgmma_commit();
      wgmma_wait<0>();
      keep_frags(x);
#pragma unroll
      for (int p = 0; p < D / 64; ++p) fence_acc(acc[p]);
      __syncthreads();   // every warp is done with this stage
      if (tid == 0) blk.load_step(&km, &vm);
    }
    // dQ * scale out through the item's Q tile (its last reader is done)
    stage_out<D>(q_t, acc, scale);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) store_out<D>(&dqm, q_t, q0, bh);
  }
  if (tid == 0) bulk_wait_read();
}

// Replaces `_dkv_kernel` for bf16.  A persistent block of one warpgroup
// walks items (head, 64 keys); per item, the query tiles stream past its
// K and V.  At D = 64 held to 168 registers: three blocks an SM.
template <int D>
__global__ void __launch_bounds__(128, D == 64 ? 3 : 1)
    dkv_tc_kernel(const __grid_constant__ CUtensorMap qm,
                  const __grid_constant__ CUtensorMap km,
                  const __grid_constant__ CUtensorMap vm,
                  const __grid_constant__ CUtensorMap dom,
                  const __grid_constant__ CUtensorMap dkm,
                  const __grid_constant__ CUtensorMap dvm, int n_items,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, int S, float scale,
                  int causal, DropArg drop_arg) {
  const Drop drop = drop_arg.load();
  using L = TcTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const int n_t = (S + kTile - 1) / kTile, tid = threadIdx.x;
  TcBlock<D> blk(sm, n_t, n_items, causal, false);
  // [2 stages][lse * log2(e), delta][64 query columns]
  float* rows = reinterpret_cast<float*>(sm + L::kRowsOff);
  auto load_rows = [&](int w, int qt, int s) {   // step s's lse, delta
    const int g = qt * kTile + tid % kTile;
    const long long at = (long long)(w / n_t) * S + g;
    float* r = rows + (s & 1) * 2 * kTile;
    if (tid < kTile)
      r[tid] = g < S ? lse[at] * kLog2e : 0.f;
    else
      r[tid] = g < S ? delta[at] : 0.f;
  };
  if (tid == 0) blk.start(&km, &vm, &qm, &dom);
  load_rows(blockIdx.x, blk.walk.first(blockIdx.x % n_t), 0);
  __syncthreads();   // the barriers are initialised; step 0's rows stored

  const float sl2 = scale * kLog2e;
  const bool dropping = drop.p > 0.f;
  float dk_acc[D / 64][32], dv_acc[D / 64][32];
  int s = 0;         // the block's streamed step
  for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
    const int bh = w / n_t, kt = w % n_t, k0 = kt * kTile;
    if (tid == 0) blk.next_own(w, j, &km, &vm);
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[p][i] = dv_acc[p][i] = 0.f;
    uint8_t* k_t = blk.own_tile(j, 0);
    uint8_t* v_t = blk.own_tile(j, 1);
    mbar_wait(&blk.bar[j & 1], (j >> 1) & 1);
    for (int qt = blk.walk.first(kt); qt < n_t; ++qt, ++s) {
      const int q0 = qt * kTile;
      const uint8_t* q_t = blk.stream_tile(s, 0);
      const uint8_t* do_t = blk.stream_tile(s, 1);
      mbar_wait(&blk.bar[2 + (s & 1)], (s >> 1) & 1);
      float sc[32], dp[32];
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
      mma_abt_tc<D>(sc, k_t, q_t);   // S^T = K Q^T: rows keys, cols queries
      mma_abt_tc<D>(dp, v_t, do_t);  // dP^T = V dO^T
      wgmma_commit();
      {  // the next step's lse and delta, stored while the products run
         // (its stage was last read before the previous step's barrier)
        int nw = w, nq = qt;
        if (blk.walk.next(nw, nq)) load_rows(nw, nq, s + 1);
      }
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      // mask(p)^T and ds^T in place of sc and dp; masks only on the
      // diagonal tile and the tail
      const float* lse2 = rows + (s & 1) * 2 * kTile;
      const float* dl = lse2 + kTile;
      if ((causal && qt == kt) || k0 + kTile > S || q0 + kTile > S) {
        if (dropping)
          dkv_terms<true, true>(sc, dp, lse2, dl, q0, k0, S, causal, sl2,
                                bh, drop);
        else
          dkv_terms<true, false>(sc, dp, lse2, dl, q0, k0, S, causal, sl2,
                                 bh, drop);
      } else if (dropping) {
        dkv_terms<false, true>(sc, dp, lse2, dl, q0, k0, S, causal, sl2,
                               bh, drop);
      } else {
        dkv_terms<false, false>(sc, dp, lse2, dl, q0, k0, S, causal, sl2,
                                bh, drop);
      }
      uint32_t xp[4][2][4], xs[4][2][4];
      split_frags(sc, xp);
      split_frags(dp, xs);
#pragma unroll
      for (int p = 0; p < D / 64; ++p) {
        fence_acc(dk_acc[p]);
        fence_acc(dv_acc[p]);
      }
      wgmma_fence();
      mma_xb_tc<D>(dv_acc, xp, do_t);   // dV += mask(P)^T dO
      mma_xb_tc<D>(dk_acc, xs, q_t);    // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      keep_frags(xp);
      keep_frags(xs);
#pragma unroll
      for (int p = 0; p < D / 64; ++p) {
        fence_acc(dk_acc[p]);
        fence_acc(dv_acc[p]);
      }
      __syncthreads();   // every warp is done with this stage
      if (tid == 0) blk.load_step(&qm, &dom);
    }
    // dK * scale and dV out through the item's K and V tiles
    stage_out<D>(k_t, dk_acc, scale);
    stage_out<D>(v_t, dv_acc, 1.f);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      store_out<D>(&dkm, k_t, k0, bh);
      store_out<D>(&dvm, v_t, k0, bh);
    }
  }
  if (tid == 0) bulk_wait_read();
}

// The forward's online softmax on this thread's 32 elements of a 64 x 64
// score tile (rows = queries from q0, columns = keys from k0), in place
// of s.  Scores go to log2 units, t = s scale log2(e), set to kNegInf
// where masked (only on a tile that reaches past S or the diagonal:
// kEdge); the running row max m2 (log2 units) is reduced over the quad
// of lanes that share a row (xor 1, 2); alpha = 2^(m2 old - m2 new)
// rescales this thread's part of the normaliser l, which then takes p =
// 2^(t - m2) before dropout; p is then dropped by the hash and scaled
// (kDrop).  A row with every score masked keeps m2 = kNegInf, finite:
// p = 1 there, never NaN.
template <bool kEdge, bool kDrop>
__device__ __forceinline__ void fwd_terms(float (&s)[32], float (&m2)[2],
                                          float (&l)[2], float (&alpha)[2],
                                          int q0, int k0, int S, bool causal,
                                          float sl2, int bh, Drop drop) {
  float mx[2] = {m2[0], m2[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float t = s[i] * sl2;
    if (kEdge && !in_mask(q0 + acc_row(i), k0 + acc_col(i), S, causal))
      t = kNegInf;
    s[i] = t;
    mx[h] = fmaxf(mx[h], t);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = ex2(m2[h] - mx[h]);
    m2[h] = mx[h];
    l[h] *= alpha[h];
  }
  const uint32_t thr = keep_threshold(drop);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float p = ex2(s[i] - m2[h]);
    l[h] += p;
    if (kDrop)
      p = hash24(bh, q0 + acc_row(i), k0 + acc_col(i), drop.seed) >= thr
              ? p * drop.scale
              : 0.f;
    s[i] = p;
  }
}

// Replaces `_fwd_kernel` for bf16.  A persistent block of one warpgroup
// walks items (head, 64 query rows); per item, the key and value tiles
// stream past its Q (up to the diagonal under causal masking) and O
// accumulates in registers under the online softmax: S = Q K^T, then
// O = alpha O + mask(P) V with the dropped p as the A operand from
// registers in hi + lo pieces.  O / l leaves through the item's Q tile
// by TMA; lse = m + log(l) (natural log, f32) by one lane of each quad.
// Its own slots hold Q alone, so at D = 64 four blocks fit an SM, held to
// 128 registers.
template <int D>
__global__ void __launch_bounds__(128, D == 64 ? 4 : 2)
    fwd_tc_kernel(const __grid_constant__ CUtensorMap qm,
                  const __grid_constant__ CUtensorMap km,
                  const __grid_constant__ CUtensorMap vm,
                  const __grid_constant__ CUtensorMap om, int n_items,
                  float* __restrict__ lse, int S, float scale, int causal,
                  DropArg drop_arg) {
  const Drop drop = drop_arg.load();
  extern __shared__ uint8_t smem_raw[];
  const int n_t = (S + kTile - 1) / kTile, tid = threadIdx.x;
  TcBlock<D, 1> blk(align1024(smem_raw), n_t, n_items, causal, true);
  if (tid == 0) blk.start(&qm, nullptr, &km, &vm);
  __syncthreads();   // the barriers are initialised

  const float sl2 = scale * kLog2e;
  const bool dropping = drop.p > 0.f;
  float acc[D / 64][32];
  int s = 0;         // the block's streamed step
  for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
    const int bh = w / n_t, qt = w % n_t, q0 = qt * kTile;
    if (tid == 0) blk.next_own(w, j, &qm, nullptr);
    // this thread's two rows (h: +8): running max in log2 units, its
    // part of the normaliser
    float m2[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
    uint8_t* q_t = blk.own_tile(j, 0);
    mbar_wait(&blk.bar[j & 1], (j >> 1) & 1);
    for (int kt = 0; kt <= blk.walk.last(qt); ++kt, ++s) {
      const int k0 = kt * kTile;
      mbar_wait(&blk.bar[2 + (s & 1)], (s >> 1) & 1);
      float sc[32];
      fence_acc(sc);
      wgmma_fence();
      mma_abt_tc<D>(sc, q_t, blk.stream_tile(s, 0));        // Q K^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      // p in place of sc; masks only on the diagonal tile and the tail
      float alpha[2];
      if ((causal && kt == qt) || k0 + kTile > S || q0 + kTile > S) {
        if (dropping)
          fwd_terms<true, true>(sc, m2, l, alpha, q0, k0, S, causal, sl2, bh,
                                drop);
        else
          fwd_terms<true, false>(sc, m2, l, alpha, q0, k0, S, causal, sl2,
                                 bh, drop);
      } else if (dropping) {
        fwd_terms<false, true>(sc, m2, l, alpha, q0, k0, S, causal, sl2, bh,
                               drop);
      } else {
        fwd_terms<false, false>(sc, m2, l, alpha, q0, k0, S, causal, sl2,
                                bh, drop);
      }
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[p][i] *= alpha[(i >> 1) & 1];
      uint32_t x[4][2][4];
      split_frags(sc, x);
#pragma unroll
      for (int p = 0; p < D / 64; ++p) fence_acc(acc[p]);
      wgmma_fence();
      mma_xb_tc<D>(acc, x, blk.stream_tile(s, 1));          // O += P V
      wgmma_commit();
      wgmma_wait<0>();
      keep_frags(x);
#pragma unroll
      for (int p = 0; p < D / 64; ++p) fence_acc(acc[p]);
      __syncthreads();   // every warp is done with this stage
      if (tid == 0) blk.load_step(&km, &vm);
    }
    // the normaliser of each row over its quad; O / l out through the
    // item's Q tile (its last reader is done)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] /= l[(i >> 1) & 1];
    stage_out<D>(q_t, acc, 1.f);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) store_out<D>(&om, q_t, q0, bh);
    if (tid % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = q0 + acc_row(2 * h);
        if (g < S) lse[(long long)bh * S + g] = m2[h] * kLn2 + logf(l[h]);
      }
    }
  }
  if (tid == 0) bulk_wait_read();
}

// ---------------------------------------------------------------- launch ---
constexpr size_t tile_floats(int d) { return (size_t)kTile * (d + 1); }
constexpr size_t fwd_smem(int d) {
  return sizeof(float) * (3 * tile_floats(d) + kTile * kLdP + 3 * kTile);
}
constexpr size_t dq_smem(int d) {
  return sizeof(float) * (4 * tile_floats(d) + kTile * kLdP + 2 * kTile);
}
constexpr size_t dkv_smem(int d) {
  return sizeof(float) * (4 * tile_floats(d) + 2 * kTile * kLdP + 2 * kTile);
}

// Opt a kernel into its dynamic shared memory (above the 48 KB default)
// and launch it on grid (bh, tiles of S).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int bh, int S, void* stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bh, (S + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int dtype, int bh, int S, int d) {
  return (dtype != 0 && dtype != 1) || (d != 64 && d != 128) || bh < 1 ||
         S < 1 || (S + kTile - 1) / kTile > 65535 ||
         (long long)bh * ((S + kTile - 1) / kTile) > 0x7FFFFFFFLL;
}

DropArg make_drop(float p, float scale, const int* seed) {
  return DropArg{p, scale, seed};
}

template <int D>
int fwd_simt(const void* q, const void* k, const void* v, void* o,
             float* lse, int bh, int S, float scale, int causal, DropArg dr,
             void* stream) {
  return launch(fwd_simt_kernel<D>, fwd_smem(D), bh, S, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o), lse, S,
                scale, causal, dr);
}

template <int D>
int dq_simt(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dq, int bh, int S,
            float scale, int causal, DropArg dr, void* stream) {
  return launch(dq_simt_kernel<D>, dq_smem(D), bh, S, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v),
                static_cast<const float*>(dout), lse, delta,
                static_cast<float*>(dq), S, scale, causal, dr);
}

template <int D>
int dkv_simt(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dk, void* dv,
             int bh, int S, float scale, int causal, DropArg dr,
             void* stream) {
  return launch(dkv_simt_kernel<D>, dkv_smem(D), bh, S, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v),
                static_cast<const float*>(dout), lse, delta,
                static_cast<float*>(dk), static_cast<float*>(dv), S, scale,
                causal, dr);
}

// The bf16 (bh, S, d) tensor at `base` as a 3-D tensor map (d, S, bh),
// boxes of 64 columns x 64 rows of one head, 128-byte swizzled; rows past
// S read as zeros.
cudaError_t head_map(CUtensorMap* map, const void* base, int bh, int S,
                     int d) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(S) * d * 2};
  const cuuint32_t box[3] = {64, kTile, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Maps of q, k, v, dO and the outputs, the kernel's dynamic shared
// memory opted in, and the launch of as many persistent blocks as can be
// resident at once (at most one per work item (head, 64-row tile)).
template <int N, typename Kernel, typename... Args>
int launch_tc(Kernel kernel, int smem, const void* const (&ptrs)[N], int bh,
              int S, int d, void* stream, Args... args) {
  CUtensorMap maps[N];
  for (int i = 0; i < N; ++i) {
    const cudaError_t e = head_map(&maps[i], ptrs[i], bh, S, d);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 128,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int items = bh * ((S + kTile - 1) / kTile);
  const int blocks = std::min(items, std::max(1, per_sm) * sms);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (N == 4)
    kernel<<<blocks, 128, smem, st>>>(maps[0], maps[1], maps[2], maps[3],
                                      items, args...);
  else if constexpr (N == 5)
    kernel<<<blocks, 128, smem, st>>>(maps[0], maps[1], maps[2], maps[3],
                                      maps[4], items, args...);
  else
    kernel<<<blocks, 128, smem, st>>>(maps[0], maps[1], maps[2], maps[3],
                                      maps[4], maps[5], items, args...);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int S, float scale, int causal, DropArg dr, void* stream) {
  const void* const ptrs[4] = {q, k, v, o};
  return launch_tc(fwd_tc_kernel<D>, TcTiles<D, 1>::smem_bytes(), ptrs, bh,
                   S, D, stream, lse, S, scale, causal, dr);
}

template <int D>
int dq_tc(const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* delta, void* dq, int bh, int S,
          float scale, int causal, DropArg dr, void* stream) {
  const void* const ptrs[5] = {q, k, v, dout, dq};
  return launch_tc(dq_tc_kernel<D>, TcTiles<D>::smem_bytes(), ptrs, bh, S,
                   D, stream, lse, delta, S, scale, causal, dr);
}

template <int D>
int dkv_tc(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int bh,
           int S, float scale, int causal, DropArg dr, void* stream) {
  const void* const ptrs[6] = {q, k, v, dout, dk, dv};
  return launch_tc(dkv_tc_kernel<D>, TcTiles<D>::smem_bytes(), ptrs, bh, S,
                   D, stream, lse, delta, S, scale, causal, dr);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  All tensors contiguous, (bh, S, d) or
// (bh, S) for lse/delta.  seed points at the int32 seed in device
// memory (its bits are used; not read at dropout 0), so a captured graph
// that rewrites it draws new masks on every replay.
// The bf16 kernels read q, k, v and dO and write O, dQ, dK and dV by
// TMA: their addresses must be 16-byte aligned.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int bh, int S, int d, float scale,
                                   int causal, float dropout,
                                   float drop_scale, const int* seed,
                                   void* stream) {
  if (bad_args(dtype, bh, S, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const DropArg dr = make_drop(dropout, drop_scale, seed);
  if (dtype == 0)
    return d == 64 ? fwd_simt<64>(q, k, v, o, lse, bh, S, scale, causal, dr,
                                  stream)
                   : fwd_simt<128>(q, k, v, o, lse, bh, S, scale, causal, dr,
                                   stream);
  return d == 64 ? fwd_tc<64>(q, k, v, o, lse, bh, S, scale, causal, dr,
                              stream)
                 : fwd_tc<128>(q, k, v, o, lse, bh, S, scale, causal, dr,
                               stream);
}

extern "C" int flash_attention_dq(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dq, int bh, int S, int d,
                                  float scale, int causal, float dropout,
                                  float drop_scale, const int* seed,
                                  void* stream) {
  if (bad_args(dtype, bh, S, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const DropArg dr = make_drop(dropout, drop_scale, seed);
  if (dtype == 0)
    return d == 64 ? dq_simt<64>(q, k, v, dout, lse, delta, dq, bh, S, scale,
                                 causal, dr, stream)
                   : dq_simt<128>(q, k, v, dout, lse, delta, dq, bh, S,
                                  scale, causal, dr, stream);
  return d == 64 ? dq_tc<64>(q, k, v, dout, lse, delta, dq, bh, S, scale,
                             causal, dr, stream)
                 : dq_tc<128>(q, k, v, dout, lse, delta, dq, bh, S, scale,
                              causal, dr, stream);
}

extern "C" int flash_attention_dkv(int dtype, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, int bh, int S, int d,
                                   float scale, int causal, float dropout,
                                   float drop_scale, const int* seed,
                                   void* stream) {
  if (bad_args(dtype, bh, S, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const DropArg dr = make_drop(dropout, drop_scale, seed);
  if (dtype == 0)
    return d == 64 ? dkv_simt<64>(q, k, v, dout, lse, delta, dk, dv, bh, S,
                                  scale, causal, dr, stream)
                   : dkv_simt<128>(q, k, v, dout, lse, delta, dk, dv, bh, S,
                                   scale, causal, dr, stream);
  return d == 64 ? dkv_tc<64>(q, k, v, dout, lse, delta, dk, dv, bh, S,
                              scale, causal, dr, stream)
                 : dkv_tc<128>(q, k, v, dout, lse, delta, dk, dv, bh, S,
                               scale, causal, dr, stream);
}
