// Fused norm -> relu -> conv for Hopper (sm_90a): forward, dX and dW.
//
// Replaces the three TPU kernels of mxnet_tpu/ops/pallas/fused_conv.py:
//   fused_conv_fwd <- `_fwd_kernel` (launched by `_fwd`)
//   fused_conv_dx  <- `_dx_kernel`  (launched by `_dx`)
//   fused_conv_dw  <- `_dw_kernel`  (launched by `_dw`)
// They compute out = conv_SAME(X, w) with X = relu(x*scale + shift [+ res])
// (the relu optional), NHWC activations, HWIO weights, k in {1, 3},
// stride 1 or 2, and its two gradients.  The point of the TPU kernels is
// kept: X is formed from the raw x as a tile is loaded and never written
// to device memory, in the forward or in either backward kernel.
//
// Types: x, res, dO and w are float or bf16 (all one type); scale and
// shift are f32; every product and sum is f32 (as in the TPU kernels,
// which multiply the f32 prologue by the f32-cast weights).  out, dx and
// dres are written in x's type; dscale, dshift and dW in f32.
//
// All three are implicit GEMMs over NHWC, sharing one tile loop:
//   fwd : rows = output positions (N*Ho*Wo), cols = Co, depth = k*k*Ci
//   dX  : rows = input positions (N*H*W),    cols = Ci, depth = k*k*Co
//   dW  : rows = (tap, ci) (k*k*Ci),         cols = Co, depth = N*Ho*Wo
// A 256-thread block owns a 64x64 tile of the result; per step of 16 in
// the depth it stages a 16x64 A tile and a 16x64 B tile in shared memory
// (as f32; rows padded by 4 floats against bank conflicts) and each
// thread accumulates a 4x4 sub-tile in registers from float4 reads.  The
// loaders compute their own NHWC offsets and zero what lies outside the
// image (SAME padding is zero padding of X, after the prologue), so the
// Pallas kernels' padded copies, contiguous-slice taps and zero-
// interleaved dilation of dO (workarounds for Mosaic's missing strided
// slices) have no counterpart here.
//
// Bound (see chip_smoke.py for the numbers at ResNet-50's shapes): the
// 3x3 convs sit near the card's bf16 ridge (~290 flops per byte), the
// 1x1 convs are byte-bound.  This first version multiplies on the f32
// SIMT units, not the tensor cores, so it is compute-bound far above
// either bound; what the design buys is the traffic: each kernel reads x
// (and res) once per tile that needs it and never writes or rereads X.
// Tensor cores (wgmma on bf16 tiles fed by TMA) are the next step.
//
// Every kernel allocates nothing and launches on the caller's stream;
// each entry point returns cudaGetLastError() after its launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;        // rows of the result tile
constexpr int kBN = 64;        // cols of the result tile
constexpr int kBK = 16;        // depth of one staged step
constexpr int kPad = 4;        // row padding of the staged tiles (floats)
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 results each

struct Geom {
  int n, h, w, ci, co, k, stride, ho, wo, pad_y, pad_x;
};

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

// x*scale + shift [+ res] at one element, rounded after each operation as
// PyTorch's separate elementwise ops round it (no contraction into an
// fma), so the relu mask equals the plain version's bit for bit.
__device__ __forceinline__ float pre_act(float xv, float rv, bool has_res,
                                         float sc, float sh) {
  const float p = __fadd_rn(__fmul_rn(xv, sc), sh);
  return has_res ? __fadd_rn(p, rv) : p;
}

// X = relu(x*scale + shift [+ res]) at one element (the TPU `_prologue`),
// from raw values already in registers.
__device__ __forceinline__ float prologue(float xv, float rv, bool has_res,
                                          float sc, float sh, int relu) {
  const float p = pre_act(xv, rv, has_res, sc, sh);
  return relu ? fmaxf(p, 0.f) : p;
}

// acc[4][4] += A^T B over one staged depth step: rows tr*4.., cols tc*4..
__device__ __forceinline__ void mma_tile(float (*as)[kBM + kPad],
                                         float (*bs)[kBN + kPad],
                                         float acc[4][4], int tr, int tc) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(&as[kk][tr * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tc * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------- forward
// Replaces `_fwd_kernel`.  The TPU grid (N, Co/block) holds a whole image
// per step in VMEM; here a block owns 64 output positions x 64 output
// channels, so every SM has work at any batch.  The A tile is X at the
// tap of each depth index, formed on load.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
           const float* __restrict__ shift, const T* __restrict__ w,
           const T* __restrict__ res, T* __restrict__ out, Geom g, int relu) {
  __shared__ __align__(16) float as[kBK][kBM + kPad];
  __shared__ __align__(16) float bs[kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int M = g.n * g.ho * g.wo;
  const int K = g.k * g.k * g.ci;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  // A loader: depth index tid % 16, rows tid / 16 + 16 j (consecutive
  // threads read consecutive input channels of one pixel)
  const int a_k = tid % kBK;
  int a_n[4], a_iy[4], a_ix[4];
  bool a_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + tid / kBK + 16 * j;
    a_ok[j] = m < M;
    const int mm = a_ok[j] ? m : 0;
    const int img = mm / (g.ho * g.wo);
    const int rem = mm - img * g.ho * g.wo;
    const int oy = rem / g.wo, ox = rem - (rem / g.wo) * g.wo;
    a_n[j] = img;
    a_iy[j] = oy * g.stride - g.pad_y;
    a_ix[j] = ox * g.stride - g.pad_x;
  }
  // B loader: output channel tid % 64, depth rows tid / 64 + 4 j
  const int b_n = tid % kBN, b_k = tid / kBN;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int kg = k0 + a_k;
    const bool kok = kg < K;
    const int tap = kok ? kg / g.ci : 0;
    const int c = kok ? kg - tap * g.ci : 0;
    const int ky = tap / g.k, kx = tap - (tap / g.k) * g.k;
    const float sc = kok ? scale[c] : 0.f, sh = kok ? shift[c] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = 0.f;
      const int iy = a_iy[j] + ky, ix = a_ix[j] + kx;
      if (kok && a_ok[j] && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w) {
        const long long off =
            ((static_cast<long long>(a_n[j]) * g.h + iy) * g.w + ix) * g.ci +
            c;
        v = prologue(ld(x, off), res != nullptr ? ld(res, off) : 0.f,
                     res != nullptr, sc, sh, relu);
      }
      as[a_k][tid / kBK + 16 * j] = v;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = b_k + 4 * j;
      const int kgb = k0 + kk, col = n0 + b_n;
      bs[kk][b_n] = (kgb < K && col < g.co)
                        ? ld(w, static_cast<long long>(kgb) * g.co + col)
                        : 0.f;
    }
    __syncthreads();
    mma_tile(as, bs, acc, tr, tc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tr * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tc * 4 + j;
      if (col < g.co) st(out, static_cast<long long>(m) * g.co + col,
                         acc[i][j]);
    }
  }
}

// --------------------------------------------------------------------- dX
// Replaces `_dx_kernel`.  G = dO correlated with the flipped taps: input
// position (iy, ix) takes, for each tap (ky, kx), the output position
// oy = (iy + pad_y - ky) / stride when that division is exact and in
// range (the dO positions that map to this input position are indexed
// directly; there is no dilated copy of dO).  The epilogue recomputes the
// relu mask from the raw x and writes dx = G*m*scale, dres = G*m, and
// this block's column sums of G*m*x and G*m (the dscale/dshift partials,
// one row per block of 64 positions, summed by `reduce_rows`: a fixed
// order, so the result does not change from run to run).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const T* __restrict__ x, const float* __restrict__ scale,
          const float* __restrict__ shift, const T* __restrict__ w,
          const T* __restrict__ dout, const T* __restrict__ res,
          T* __restrict__ dx, T* __restrict__ dres,
          float* __restrict__ part_sc, float* __restrict__ part_sh, Geom g,
          int relu) {
  __shared__ __align__(16) float as[kBK][kBM + kPad];
  __shared__ __align__(16) float bs[kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int M = g.n * g.h * g.w;
  const int K = g.k * g.k * g.co;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  // A loader: depth index (an output channel of a tap) tid % 16, rows
  // (input positions) tid / 16 + 16 j
  const int a_k = tid % kBK;
  int a_n[4], a_ty[4], a_tx[4];
  bool a_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + tid / kBK + 16 * j;
    a_ok[j] = m < M;
    const int mm = a_ok[j] ? m : 0;
    const int img = mm / (g.h * g.w);
    const int rem = mm - img * g.h * g.w;
    const int iy = rem / g.w, ix = rem - (rem / g.w) * g.w;
    a_n[j] = img;
    a_ty[j] = iy + g.pad_y;
    a_tx[j] = ix + g.pad_x;
  }
  // B loader: B[(tap, co), ci] = w[tap, ci, co]; consecutive threads
  // take consecutive co (contiguous in HWIO)
  const int b_k = tid % kBK;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int kg = k0 + a_k;
    const bool kok = kg < K;
    const int tap = kok ? kg / g.co : 0;
    const int c = kok ? kg - tap * g.co : 0;
    const int ky = tap / g.k, kx = tap - (tap / g.k) * g.k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = 0.f;
      const int ty = a_ty[j] - ky, tx = a_tx[j] - kx;
      if (kok && a_ok[j] && ty >= 0 && tx >= 0 && ty % g.stride == 0 &&
          tx % g.stride == 0) {
        const int oy = ty / g.stride, ox = tx / g.stride;
        if (oy < g.ho && ox < g.wo) {
          v = ld(dout, ((static_cast<long long>(a_n[j]) * g.ho + oy) * g.wo +
                        ox) * g.co + c);
        }
      }
      as[a_k][tid / kBK + 16 * j] = v;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = tid / kBK + 16 * j;
      const int col = n0 + nn;
      bs[b_k][nn] =
          (kok && col < g.ci)
              ? ld(w, (static_cast<long long>(tap) * g.ci + col) * g.co + c)
              : 0.f;
    }
    __syncthreads();
    mma_tile(as, bs, acc, tr, tc);
    __syncthreads();
  }

  float csc[4] = {}, csh[4] = {};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tc * 4 + j;
    if (col >= g.ci) continue;
    const float sc = scale[col], sh = shift[col];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + tr * 4 + i;
      if (m >= M) continue;
      const long long off = static_cast<long long>(m) * g.ci + col;
      const float xv = ld(x, off);
      float gm = acc[i][j];
      if (relu && !(pre_act(xv, res != nullptr ? ld(res, off) : 0.f,
                            res != nullptr, sc, sh) > 0.f))
        gm = 0.f;
      st(dx, off, gm * sc);
      if (dres != nullptr) st(dres, off, gm);
      csc[j] += gm * xv;
      csh[j] += gm;
    }
  }
  // column sums over the block's 64 rows: the staged tiles are free now
  // (the loop ended on a barrier) and hold 16 x 64 floats each
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    as[tr][tc * 4 + j] = csc[j];
    bs[tr][tc * 4 + j] = csh[j];
  }
  __syncthreads();
  if (tid < kBN && n0 + tid < g.ci) {
    float s0 = 0.f, s1 = 0.f;
    for (int r = 0; r < 16; ++r) {
      s0 += as[r][tid];
      s1 += bs[r][tid];
    }
    const long long o = static_cast<long long>(blockIdx.x) * g.ci + n0 + tid;
    part_sc[o] = s0;
    part_sh[o] = s1;
  }
}

// out[c] = sum_r part[r, c], rows taken in a fixed order (32 lanes of
// rows per column, then the lanes in order): the dscale/dshift totals.
__global__ void __launch_bounds__(1024)
reduce_rows(const float* __restrict__ part, int rows, int cols,
            float* __restrict__ out) {
  __shared__ float red[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < cols)
    for (int r = threadIdx.y; r < rows; r += 32)
      s += part[static_cast<long long>(r) * cols + col];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float t = 0.f;
    for (int i = 0; i < 32; ++i) t += red[i][threadIdx.x];
    out[col] = t;
  }
}

// --------------------------------------------------------------------- dW
// Replaces `_dw_kernel`.  The TPU grid (Co/block, N) carries one f32
// accumulator across the batch in order; CUDA blocks run in no order, so
// the N*Ho*Wo positions are cut into `gridDim.z` contiguous chunks, each
// block reduces its chunk for a 64 (tap, ci) x 64 co tile, and writes an
// f32 partial; `reduce_splits` adds the partials in split order (no
// atomics: the result does not change from run to run).  The A tile is X
// at each position's tap, formed on load.  Its positions are decoded into
// shared memory once per depth step (two integer divisions per position,
// not per loaded element), and the next step's raw values are loaded into
// registers before the current step is multiplied.  (The same register
// prefetch made the forward and dX kernels slower on the card, so they
// load and multiply in turn; PERF.md has the times.)
template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ x, const float* __restrict__ scale,
          const float* __restrict__ shift, const T* __restrict__ dout,
          const T* __restrict__ res, float* __restrict__ part, Geom g,
          int relu, int chunk) {
  __shared__ __align__(16) float as[kBK][kBM + kPad];
  __shared__ __align__(16) float bs[kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int M = g.k * g.k * g.ci;
  const int K = g.n * g.ho * g.wo;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(K, kbeg + chunk);

  // A loader: one (tap, ci) row per thread (tid % 64, consecutive
  // threads on consecutive channels), depth rows tid / 64 + 4 j
  const int a_m = tid % kBM, a_k = tid / kBM;
  const int mg = m0 + a_m;
  const bool mok = mg < M;
  const int tap = mok ? mg / g.ci : 0;
  const int c = mok ? mg - tap * g.ci : 0;
  const int ky = tap / g.k, kx = tap - (tap / g.k) * g.k;
  const float sc = mok ? scale[c] : 0.f, sh = mok ? shift[c] : 0.f;
  const int hw = g.ho * g.wo;

  // the image and first input row/column of each of a depth step's 16
  // positions, decoded once per step by 16 threads (double-buffered: a
  // step's table is written while the previous step's is read)
  __shared__ int pimg[2][kBK], piy[2][kBK], pix[2][kBK];
  auto decode = [&](int k0, int buf) {
    if (tid < kBK) {
      const int kg = k0 + tid;
      const int img = kg / hw;
      const int rem = kg - img * hw;
      const int oy = rem / g.wo, ox = rem - (rem / g.wo) * g.wo;
      pimg[buf][tid] = kg < kend ? img : -1;
      piy[buf][tid] = oy * g.stride - g.pad_y;
      pix[buf][tid] = ox * g.stride - g.pad_x;
    }
  };
  // raw values of the next depth step, loaded before the current step
  // is multiplied
  float xa[4], ra[4], db[4];
  bool va[4];
  auto load = [&](int k0, int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = a_k + 4 * j;
      const int img = pimg[buf][kk];
      const int iy = piy[buf][kk] + ky, ix = pix[buf][kk] + kx;
      va[j] = mok && img >= 0 && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
      const long long off =
          ((static_cast<long long>(img) * g.h + iy) * g.w + ix) * g.ci + c;
      xa[j] = va[j] ? ld(x, off) : 0.f;
      ra[j] = (va[j] && res != nullptr) ? ld(res, off) : 0.f;
      const int kg = k0 + kk, col = n0 + a_m;
      db[j] = (kg < kend && col < g.co)
                  ? ld(dout, static_cast<long long>(kg) * g.co + col)
                  : 0.f;
    }
  };

  float acc[4][4] = {};
  decode(kbeg, 0);
  __syncthreads();
  load(kbeg, 0);
  int buf = 0;
  for (int k0 = kbeg; k0 < kend; k0 += kBK, buf ^= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = a_k + 4 * j;
      as[kk][a_m] =
          va[j] ? prologue(xa[j], ra[j], res != nullptr, sc, sh, relu) : 0.f;
      bs[kk][a_m] = db[j];
    }
    decode(k0 + kBK, buf ^ 1);
    __syncthreads();
    if (k0 + kBK < kend) load(k0 + kBK, buf ^ 1);
    mma_tile(as, bs, acc, tr, tc);
    __syncthreads();
  }
  float* dst = part + static_cast<long long>(blockIdx.z) * M * g.co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tr * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tc * 4 + j;
      if (col < g.co) dst[static_cast<long long>(m) * g.co + col] = acc[i][j];
    }
  }
}

// out[e] = sum_s part[s, e] in split order.
__global__ void __launch_bounds__(256)
reduce_splits(const float* __restrict__ part, int splits, long long total,
              float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= total) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += part[i * total + e];
  out[e] = s;
}

Geom make_geom(int n, int h, int w, int ci, int co, int k, int stride,
               int ho, int wo, int pad_y, int pad_x) {
  return Geom{n, h, w, ci, co, k, stride, ho, wo, pad_y, pad_x};
}

unsigned blocks_for(long long items, int per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

template <typename T>
void launch_fwd(const void* x, const void* scale, const void* shift,
                const void* w, const void* res, void* out, Geom g, int relu,
                cudaStream_t stream) {
  const dim3 grid(blocks_for(static_cast<long long>(g.n) * g.ho * g.wo, kBM),
                  blocks_for(g.co, kBN));
  fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const T*>(w),
      static_cast<const T*>(res), static_cast<T*>(out), g, relu);
}

template <typename T>
void launch_dx(const void* x, const void* scale, const void* shift,
               const void* w, const void* dout, const void* res, void* dx,
               void* dres, float* part_sc, float* part_sh, Geom g, int relu,
               cudaStream_t stream) {
  const dim3 grid(blocks_for(static_cast<long long>(g.n) * g.h * g.w, kBM),
                  blocks_for(g.ci, kBN));
  dx_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const T*>(w),
      static_cast<const T*>(dout), static_cast<const T*>(res),
      static_cast<T*>(dx), static_cast<T*>(dres), part_sc, part_sh, g, relu);
}

template <typename T>
void launch_dw(const void* x, const void* scale, const void* shift,
               const void* dout, const void* res, float* part, Geom g,
               int relu, int splits, int chunk, cudaStream_t stream) {
  const dim3 grid(blocks_for(static_cast<long long>(g.k) * g.k * g.ci, kBM),
                  blocks_for(g.co, kBN), splits);
  dw_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const T*>(dout),
      static_cast<const T*>(res), part, g, relu, chunk);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, res, dO, w, out, dx, dres).
// Geometry: n, h, w, ci, co, k, stride, and the SAME output size (ho, wo)
// and low-side padding (pad_y, pad_x) as the wrapper computes them.
// `res` and `dres` may be null (no residual).  Each returns
// cudaGetLastError() after its launches (0 on success).
extern "C" int fused_conv_fwd(int dtype, const void* x, const void* scale,
                              const void* shift, const void* w,
                              const void* res, void* out, int n, int h,
                              int wd, int ci, int co, int k, int stride,
                              int ho, int wo, int pad_y, int pad_x, int relu,
                              void* stream) {
  const Geom g = make_geom(n, h, wd, ci, co, k, stride, ho, wo, pad_y, pad_x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_fwd<float>(x, scale, shift, w, res, out, g, relu, s);
  else if (dtype == 1)
    launch_fwd<__nv_bfloat16>(x, scale, shift, w, res, out, g, relu, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// part_sc/part_sh: scratch of ceil(n*h*w / 64) * ci floats each;
// dscale/dshift: ci floats each (f32).
extern "C" int fused_conv_dx(int dtype, const void* x, const void* scale,
                             const void* shift, const void* w,
                             const void* dout, const void* res, void* dx,
                             void* dres, void* part_sc, void* part_sh,
                             void* dscale, void* dshift, int n, int h,
                             int wd, int ci, int co, int k, int stride,
                             int ho, int wo, int pad_y, int pad_x, int relu,
                             void* stream) {
  const Geom g = make_geom(n, h, wd, ci, co, k, stride, ho, wo, pad_y, pad_x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* psc = static_cast<float*>(part_sc);
  float* psh = static_cast<float*>(part_sh);
  if (dtype == 0)
    launch_dx<float>(x, scale, shift, w, dout, res, dx, dres, psc, psh, g,
                     relu, s);
  else if (dtype == 1)
    launch_dx<__nv_bfloat16>(x, scale, shift, w, dout, res, dx, dres, psc,
                             psh, g, relu, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = static_cast<int>(
      blocks_for(static_cast<long long>(n) * h * wd, kBM));
  const dim3 rgrid(blocks_for(ci, 32)), rblock(32, 32);
  reduce_rows<<<rgrid, rblock, 0, s>>>(psc, rows, ci,
                                       static_cast<float*>(dscale));
  reduce_rows<<<rgrid, rblock, 0, s>>>(psh, rows, ci,
                                       static_cast<float*>(dshift));
  return static_cast<int>(cudaGetLastError());
}

// part: scratch of splits * k*k*ci*co floats (may be `dw` itself when
// splits == 1); dw: k*k*ci*co floats (f32).  Split i reduces positions
// [i*chunk, min(n*ho*wo, (i+1)*chunk)); chunk is a multiple of 16.
extern "C" int fused_conv_dw(int dtype, const void* x, const void* scale,
                             const void* shift, const void* dout,
                             const void* res, void* part, void* dw, int n,
                             int h, int wd, int ci, int co, int k,
                             int stride, int ho, int wo, int pad_y,
                             int pad_x, int relu, int splits, int chunk,
                             void* stream) {
  const Geom g = make_geom(n, h, wd, ci, co, k, stride, ho, wo, pad_y, pad_x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    launch_dw<float>(x, scale, shift, dout, res, p, g, relu, splits, chunk,
                     s);
  else if (dtype == 1)
    launch_dw<__nv_bfloat16>(x, scale, shift, dout, res, p, g, relu, splits,
                             chunk, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1) {
    const long long total = static_cast<long long>(k) * k * ci * co;
    reduce_splits<<<blocks_for(total, 256), 256, 0, s>>>(
        p, splits, total, static_cast<float*>(dw));
  }
  return static_cast<int>(cudaGetLastError());
}
