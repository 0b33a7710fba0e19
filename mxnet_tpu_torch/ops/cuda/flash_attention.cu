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
//
// Types: q, k, v, dO and o are float or bf16 (all one type), cast to f32
// as a tile is staged; every product and sum is f32, as in the TPU kernels
// (p stays f32 for P V).  O, dQ, dK and dV are written in the input type,
// lse in f32.  S need not divide by the tile: rows and keys past S are
// staged as zeros and masked.
//
// Design: the TPU kernels carry their accumulators in VMEM scratch across
// the sequential last grid axis.  Here one 256-thread block owns a tile
// of 64 query rows (fwd, dq) or 64 keys (dkv), loops over the other axis'
// 64-wide tiles itself and keeps its accumulators in registers; dK and
// dV are summed by the block that owns the key tile, so there are no
// atomics and every run gives the same bits.  Tiles are staged in shared
// memory as f32 with rows padded by one float (no bank conflicts); each
// thread computes a 4 x 4 block of every 64 x 64 product and a 4 x D/16
// block of every 64 x D one.  Whole key tiles above the diagonal are
// skipped under causal masking, as the TPU kernels skip whole blocks.
//
// Bound (numbers in chip_smoke.py, at BERT-base's 768 x 128 x 64 bf16):
// at S = 128 each kernel is bound by bytes (its flops at the bf16 tensor-
// core rate take less time than reading q, k, v and dO once).  This first
// version multiplies on the f32 SIMT units, stages with plain loads and
// overlaps no copy with compute, so it runs far above that bound;
// wgmma on bf16 tiles fed by TMA is later work (and a bf16 P V would
// change the numerics: the TPU kernels keep p in f32).
//
// Every kernel allocates nothing and launches on the caller's stream;
// each entry point returns cudaGetLastError() after its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // query rows / keys per tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kLdP = kTile + 1;  // row stride of a 64 x 64 f32 tile
constexpr float kNegInf = -1e30f;  // the TPU kernels' _NEG_INF

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch casts
}

// `_uniform01` of the TPU kernels: U[0,1) from (bh, q, k, seed), uint32
// arithmetic wrapping mod 2^32, the top 24 bits scaled by 2^-24.
__device__ __forceinline__ float uniform01(uint32_t bh, uint32_t q,
                                           uint32_t k, uint32_t seed) {
  uint32_t x = q * 0x9E3779B9u + k * 0x85EBCA6Bu + bh * 0xC2B2AE35u + seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
}

struct Drop {
  float p;        // dropout rate (0: off)
  float scale;    // 1 / (1 - p), rounded to f32 by the caller
  uint32_t seed;  // the int32 seed's bits
};

// Stage rows [row0, row0 + 64) of one (S, D) matrix into a 64 x (D+1) f32
// tile, times `mul`; rows at or past S are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int S, float mul) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D, g = row0 + r;
    dst[r * (D + 1) + c] = g < S ? ld(src, (long long)g * D + c) * mul : 0.f;
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

// ------------------------------------------------------------- forward ---
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int S, float scale, int causal,
               Drop drop) {
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

  stage<T, D>(Qs, q + base, q0, S, scale);
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
    stage<T, D>(Ks, k + base, k0, S, 1.f);
    stage<T, D>(Vs, v + base, k0, S, 1.f);
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
        st(o, base + (long long)qp * D + tx + 16 * j, acc[i][j] / l);
    }
  }
  if (tid < kTile && q0 + tid < S)
    lse[(long long)bh * S + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

// ------------------------------------------------------------------ dQ ---
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int S, float scale, int causal, Drop drop) {
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

  stage<T, D>(Qs, q + base, q0, S, scale);
  stage<T, D>(dOs, dout + base, q0, S, 1.f);
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
    stage<T, D>(Ks, k + base, k0, S, 1.f);
    stage<T, D>(Vs, v + base, k0, S, 1.f);
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
        st(dq, base + (long long)qp * D + tx + 16 * j, acc[i][j] * scale);
    }
  }
}

// --------------------------------------------------------------- dK/dV ---
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int S, float scale, int causal,
               Drop drop) {
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

  stage<T, D>(Ks, k + base, k0, S, 1.f);
  stage<T, D>(Vs, v + base, k0, S, 1.f);
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
    stage<T, D>(Qs, q + base, q0, S, 1.f);
    stage<T, D>(dOs, dout + base, q0, S, 1.f);
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
        st(dk, at, dk_acc[i][j] * scale);
        st(dv, at, dv_acc[i][j]);
      }
    }
  }
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
         S < 1 || (S + kTile - 1) / kTile > 65535;
}

Drop make_drop(float p, float scale, int seed) {
  return Drop{p, scale, static_cast<uint32_t>(seed)};
}

template <typename T, int D>
int fwd_typed(const void* q, const void* k, const void* v, void* o,
              float* lse, int bh, int S, float scale, int causal, Drop dr,
              void* stream) {
  return launch(fwd_kernel<T, D>, fwd_smem(D), bh, S, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o), lse, S, scale,
                causal, dr);
}

template <typename T, int D>
int dq_typed(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, int bh, int S,
             float scale, int causal, Drop dr, void* stream) {
  return launch(dq_kernel<T, D>, dq_smem(D), bh, S, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                delta, static_cast<T*>(dq), S, scale, causal, dr);
}

template <typename T, int D>
int dkv_typed(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dk, void* dv,
              int bh, int S, float scale, int causal, Drop dr,
              void* stream) {
  return launch(dkv_kernel<T, D>, dkv_smem(D), bh, S, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                delta, static_cast<T*>(dk), static_cast<T*>(dv), S, scale,
                causal, dr);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  All tensors contiguous, (bh, S, d) or
// (bh, S) for lse/delta.  seed is the int32 seed (its bits are used).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int bh, int S, int d, float scale,
                                   int causal, float dropout,
                                   float drop_scale, int seed,
                                   void* stream) {
  if (bad_args(dtype, bh, S, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const Drop dr = make_drop(dropout, drop_scale, seed);
  if (dtype == 0)
    return d == 64 ? fwd_typed<float, 64>(q, k, v, o, lse, bh, S, scale,
                                          causal, dr, stream)
                   : fwd_typed<float, 128>(q, k, v, o, lse, bh, S, scale,
                                           causal, dr, stream);
  return d == 64 ? fwd_typed<__nv_bfloat16, 64>(q, k, v, o, lse, bh, S,
                                                scale, causal, dr, stream)
                 : fwd_typed<__nv_bfloat16, 128>(q, k, v, o, lse, bh, S,
                                                 scale, causal, dr, stream);
}

extern "C" int flash_attention_dq(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dq, int bh, int S, int d,
                                  float scale, int causal, float dropout,
                                  float drop_scale, int seed, void* stream) {
  if (bad_args(dtype, bh, S, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const Drop dr = make_drop(dropout, drop_scale, seed);
  if (dtype == 0)
    return d == 64 ? dq_typed<float, 64>(q, k, v, dout, lse, delta, dq, bh,
                                         S, scale, causal, dr, stream)
                   : dq_typed<float, 128>(q, k, v, dout, lse, delta, dq, bh,
                                          S, scale, causal, dr, stream);
  return d == 64 ? dq_typed<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq,
                                               bh, S, scale, causal, dr,
                                               stream)
                 : dq_typed<__nv_bfloat16, 128>(q, k, v, dout, lse, delta,
                                                dq, bh, S, scale, causal, dr,
                                                stream);
}

extern "C" int flash_attention_dkv(int dtype, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, int bh, int S, int d,
                                   float scale, int causal, float dropout,
                                   float drop_scale, int seed,
                                   void* stream) {
  if (bad_args(dtype, bh, S, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const Drop dr = make_drop(dropout, drop_scale, seed);
  if (dtype == 0)
    return d == 64 ? dkv_typed<float, 64>(q, k, v, dout, lse, delta, dk, dv,
                                          bh, S, scale, causal, dr, stream)
                   : dkv_typed<float, 128>(q, k, v, dout, lse, delta, dk,
                                           dv, bh, S, scale, causal, dr,
                                           stream);
  return d == 64 ? dkv_typed<__nv_bfloat16, 64>(q, k, v, dout, lse, delta,
                                                dk, dv, bh, S, scale, causal,
                                                dr, stream)
                 : dkv_typed<__nv_bfloat16, 128>(q, k, v, dout, lse, delta,
                                                 dk, dv, bh, S, scale,
                                                 causal, dr, stream);
}
