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
// All three are implicit GEMMs over NHWC:
//   fwd : rows = output positions (N*Ho*Wo), cols = Co, depth = k*k*Ci
//   dX  : rows = input positions (N*H*W),    cols = Ci, depth = k*k*Co
//   dW  : rows = (tap, ci) (k*k*Ci),         cols = Co, depth = N*Ho*Wo
// The loaders compute their own NHWC offsets and zero what lies outside
// the image (SAME padding is zero padding of X, after the prologue), so
// the Pallas kernels' padded copies, contiguous-slice taps and zero-
// interleaved dilation of dO (workarounds for Mosaic's missing strided
// slices) have no counterpart here.
//
// Forward and dW run on the tensor cores: warpgroup MMAs (wgmma, bf16
// operands, f32 accumulators) fed through shared-memory rings, B (w
// viewed as [k*k*Ci, Co], dO as [N*Ho*Wo, Co]) by the TMA as 64 x 64
// panels, 128-byte swizzled, completing on mbarriers.  X is formed from
// the staged raw x in f32 (the prologue rounded as below) and split into
// bf16 pieces.  The bf16 dX at stride 1 (`dx_tc_kernel`) runs there too:
// its A operand is the raw dO and its B is w, both exact bf16, so it
// forms no X and needs one product per term.
//
// The training path (bf16, stride 1, no residual) forms X once per x
// element and 64-channel chunk, not once per tap: a block's TMA stages
// the consecutive NHWC positions that all its taps reach (its "halo"),
// X is formed from them into swizzled bf16 tiles, and each tap's A
// fragments are read from those rows by ldmatrix, one row address per
// lane (a zero row where the tap leaves the image: SAME padding), into
// registers for wgmma.
//   `fwd_halo_kernel`: 128 output positions x 64, 128 or 256 output
//     channels a block (wide tiles form X for fewer blocks); the next
//     chunk's halo arrives while this chunk's taps run.
//   `dw_halo_kernel` (3x3): 64 input x 64 output channels for all nine
//     taps over a chunk of positions, three warpgroups, one kernel row
//     each; A = X^T comes by ldmatrix.trans; chunks of positions are
//     reduced by `reduce_splits` in order (no atomics: the same bits on
//     every run).
//   `dx_tc_kernel` (1x1 and 3x3, with or without a residual): 128 input
//     positions x 64, 128 or 256 input channels a block; the halo is of
//     dO, staged by the TMA straight into swizzled tiles (nothing to
//     form), read at the forward's tap offsets mirrored; w read K-major.
// `tc_kernel` takes the rest (f32, stride 2, a residual; dW of the 1x1
// convs): per step of 64 in the depth every thread gathers its share of
// the raw rows with 16-byte cp.async copies (one row = one position's
// 64-channel slice at the step's tap; a row outside the image is
// fetched as nothing and flagged), X is formed into swizzled tiles that
// wgmma reads from shared memory while the previous step's MMAs run.
// The tile is [position][ci], 128 bytes a row: the forward reads it
// K-major (A = positions x ci), dW transposed (A = ci x positions, one
// tap a tile, split-K as above).
//
// Numerics: every product is f32-accurate, as in the TPU kernels (which
// multiply the f32 prologue by the f32-cast operand).  X is split into
// bf16 pieces, hi = bf16(X) and each further piece the rounded remainder
// (every remainder is exact in f32).  With bf16 inputs B (w or dO) is
// exact in bf16, so each depth step issues X_hi.B and X_lo.B into one f32
// accumulator: X to ~2^-16 relative, within the card check's tolerance.
// With f32 inputs the wrapper passes B as its three bf16 pieces (hi,
// mid, lo) and X is cut in three as well: the six products whose piece
// orders sum to at most 2 hold each product to ~2^-24, as f32 does (two
// pieces of each, three products, measured 3-12x the model check's noise
// floor on the card).  The tensor cores' f32 accumulation does not round
// to nearest, so `tc_kernel`'s dW and f32 paths sum each step's products
// in a fresh accumulator and add it to the total on the SIMT units; the
// halo dW keeps its chunks short (~1500 positions) instead.  The split
// doubles the tensor-core work of the bf16 path against one product per
// term (f32 inputs: six times).
//
// Bound (numbers in chip_smoke.py at ResNet-50's shapes): the 3x3 convs
// sit near the card's bf16 ridge (~290 flops per byte), the 1x1 convs
// are byte-bound; with two products per term the tensor work is twice
// the function's.  What holds the kernels back now (PERF.md): the SIMT
// work of forming X, one block per SM, and tensor cores idle while a
// step's X is formed and between steps.  dX in f32 and at stride 2
// keeps `dx_kernel` on the f32 SIMT units (64x64 tiles, 4x4 results per
// thread, f32 tiles staged through registers), far above its bound; it
// serves the f32 model check and the stride-2 cases, not the training
// path.
//
// Every kernel allocates nothing and launches on the caller's stream;
// each entry point returns cudaGetLastError() after its launches.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // wgmma, mbarrier, TMA and ldmatrix wrappers

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

// 16 bytes global -> shared, or 16 zero bytes when !ok (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Eight staged values of type T from shared memory as floats, read in
// 16-byte loads (a bf16 is the top half of its f32).
template <typename T>
__device__ __forceinline__ void load8(const uint8_t* p, float (&v)[8]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}

// scale and shift of channels c..c+7 (zeros past ci, where X is then 0).
__device__ __forceinline__ void load_affine(const float* scale,
                                            const float* shift, int c,
                                            int ci, float (&sc)[8],
                                            float (&sh)[8]) {
#pragma unroll
  for (int e = 0; e < 8; e += 4) {
    const bool ok = c + e < ci;
    const float4 a = ok ? *reinterpret_cast<const float4*>(scale + c + e)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b = ok ? *reinterpret_cast<const float4*>(shift + c + e)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    sc[e] = a.x, sc[e + 1] = a.y, sc[e + 2] = a.z, sc[e + 3] = a.w;
    sh[e] = b.x, sh[e + 1] = b.y, sh[e + 2] = b.z, sh[e + 3] = b.w;
  }
}

__device__ __forceinline__ void st2(float* p, long long i, float a,
                                    float b) {
  *reinterpret_cast<float2*>(p + i) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, long long i, float a,
                                    float b) {
  *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(a, b);
}

// What a tensor-core kernel stages per step and how it is cut.
//   kWG: consumer warpgroups (all threads also load and transform);
//   kNP: 64-wide column panels per warpgroup;
//   kDW: false = forward (warpgroups split the rows: 64 positions each),
//        true = dW (one 64-row (tap, ci) tile; warpgroups split the cols).
template <typename T, int kWG, int kNP, bool kDW>
struct Tile {
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kRows = kDW ? 64 : 64 * kWG;  // staged positions
  static constexpr int kPanels = kDW ? kNP * kWG : kNP;  // B panels
  static constexpr int kCols = kPanel * kPanels;          // block cols
  // bf16 pieces of X and of B: X = hi + lo (bf16 inputs: B exact);
  // f32 inputs: X and B each hi + mid + lo
  static constexpr int kPiecesX = sizeof(T) == 4 ? 3 : 2;
  static constexpr int kTermsB = sizeof(T) == 4 ? 3 : 1;
  // Each step's products are summed in a fresh accumulator and added to
  // the f32 total by the SIMT units (rounded to nearest): the tensor
  // cores' own accumulation does not round to nearest and drifts over a
  // long sum.  For dW (reductions of up to ~14000 positions a block) and
  // the f32 check path; the bf16 forward keeps one accumulator.
  static constexpr bool kPromote = kDW || sizeof(T) == 4;
  static constexpr int kRawRow = 64 * static_cast<int>(sizeof(T));
  static constexpr int kUnits = kRows * 8 / kThreads;  // 8-ch units/thread
  static constexpr int kBBytes = kTermsB * kPanels * kPanelBytes;
  static constexpr int kRawBytes = kRows * kRawRow;
  static constexpr int kABytes = kRows * 128;           // one bf16 A tile

  // dynamic shared memory of `stages` stages (+1024 for alignment)
  static __host__ __device__ int smem_bytes(int stages, bool res) {
    return 1024 + stages * (kBBytes + kRawBytes * (res ? 2 : 1)) +
           2 * kPiecesX * kABytes + stages * kRows + 8 * 4 + 8;
  }
};

// Replaces `_fwd_kernel` (kDW false) and `_dw_kernel` (kDW true).
//   forward: block = kRows output positions x kCols output channels;
//            step s = (tap, 64-channel chunk); B = w rows tap*Ci + c0.
//   dW: block = (tap, 64 channels) x kCols output channels x one chunk
//       of positions [kbeg, kend); step s = 64 positions; B = dO rows.
// `b0`.. map the bf16 pieces of B (one for bf16 inputs, three for f32:
// hi, mid, lo).  `dst` is out (forward, x's type) or this split's f32
// partial of dW.
template <typename T, int kWG, int kNP, bool kDW>
__global__ void __launch_bounds__(128 * kWG, 1)
tc_kernel(const __grid_constant__ CUtensorMap b0,
          const __grid_constant__ CUtensorMap b1,
          const __grid_constant__ CUtensorMap b2, const T* __restrict__ x,
          const T* __restrict__ res, const float* __restrict__ scale,
          const float* __restrict__ shift, void* __restrict__ dst, Geom g,
          int relu, int stages, int chunk) {
  using L = Tile<T, kWG, kNP, kDW>;
  constexpr int kRows = L::kRows, kRawRow = L::kRawRow;
  constexpr int kChunkElems = 16 / static_cast<int>(sizeof(T));
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const bool has_res = res != nullptr;
  uint8_t* sB = sm;                                  // [stages] B panels
  uint8_t* sX = sB + stages * L::kBBytes;            // [stages] raw x
  uint8_t* sR = sX + stages * L::kRawBytes;          // [stages] raw res
  uint8_t* sA = sR + (has_res ? stages * L::kRawBytes : 0);  // [2][piece]
  uint8_t* sOk = sA + 2 * L::kPiecesX * L::kABytes;  // [stages][kRows]
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(sOk + stages * kRows) + 7) &
      ~uintptr_t(7));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int nch = (g.ci + 63) / 64;   // 64-channel chunks per tap
  const int P = g.n * g.ho * g.wo;    // output positions
  const int hw = g.ho * g.wo;
  const int n0 = blockIdx.y * L::kCols;
  // forward: this block's positions; dW: its tap, channels, positions
  const int m0 = kDW ? 0 : blockIdx.x * kRows;
  const int dw_tap = kDW ? blockIdx.x / nch : 0;
  const int dw_c0 = kDW ? (blockIdx.x % nch) * 64 : 0;
  const int kbeg = kDW ? blockIdx.z * chunk : 0;
  const int kend = kDW ? min(P, kbeg + chunk) : 0;
  const int steps = kDW ? (kend - kbeg + 63) / 64 : g.k * g.k * nch;

  // forward: each thread's staged rows keep their positions all along
  int fn[L::kUnits], fy[L::kUnits], fx[L::kUnits];
  bool fok[L::kUnits];
#pragma unroll
  for (int j = 0; j < L::kUnits; ++j) {
    const int m = m0 + (tid + j * L::kThreads) / 8;
    fok[j] = !kDW && m < P;
    const int mm = fok[j] ? m : 0;
    fn[j] = mm / hw;
    const int rem = mm - fn[j] * hw;
    fy[j] = (rem / g.wo) * g.stride - g.pad_y;
    fx[j] = (rem % g.wo) * g.stride - g.pad_x;
  }

  // gather step s's raw rows into stage `slot` (flag the valid ones) and
  // ask for its B tile
  auto issue = [&](int s, int slot) {
    int tap, c0, brow, p0 = 0;
    if (kDW) {
      tap = dw_tap;
      c0 = dw_c0;
      p0 = kbeg + s * 64;
      brow = p0;
    } else {
      tap = s / nch;
      c0 = (s - tap * nch) * 64;
      brow = tap * g.ci + c0;
    }
    const int ky = tap / g.k, kx = tap - (tap / g.k) * g.k;
#pragma unroll
    for (int j = 0; j < L::kUnits; ++j) {
      const int u = tid + j * L::kThreads, r = u / 8, q = u % 8;
      int img, iy, ix;
      bool ok;
      if (kDW) {
        const int p = p0 + r;
        ok = p < kend;
        const int pp = ok ? p : 0;
        img = pp / hw;
        const int rem = pp - img * hw;
        iy = (rem / g.wo) * g.stride - g.pad_y + ky;
        ix = (rem % g.wo) * g.stride - g.pad_x + kx;
      } else {
        ok = fok[j];
        img = fn[j];
        iy = fy[j] + ky;
        ix = fx[j] + kx;
      }
      ok = ok && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
      const int c = c0 + q * 8;
      const bool cok = ok && c < g.ci;
      const long long off =
          cok ? ((static_cast<long long>(img) * g.h + iy) * g.w + ix) *
                        g.ci + c
              : 0;
      uint8_t* xd = sX + slot * L::kRawBytes + r * kRawRow +
                    q * 8 * static_cast<int>(sizeof(T));
#pragma unroll
      for (int h = 0; h < static_cast<int>(sizeof(T)) / 2; ++h)
        cp_async16(xd + 16 * h, x + off + h * kChunkElems, cok);
      if (has_res) {
        uint8_t* rd = xd + (sR - sX);
#pragma unroll
        for (int h = 0; h < static_cast<int>(sizeof(T)) / 2; ++h)
          cp_async16(rd + 16 * h, res + off + h * kChunkElems, cok);
      }
      if (q == 0) sOk[slot * kRows + r] = ok;
    }
    cp_async_commit();
    if (tid == 0) {
      mbar_expect_tx(&bar[slot], L::kBBytes);
#pragma unroll
      for (int t = 0; t < L::kTermsB; ++t)
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          tma_load(sB + slot * L::kBBytes + (t * L::kPanels + p) *
                                                kPanelBytes,
                   t == 0 ? &b0 : t == 1 ? &b1 : &b2, &bar[slot],
                   n0 + p * kPanel,
                   brow);
    }
  };

  // A thread always takes channels q*8.. of a 64-channel chunk (q =
  // tid % 8): their scale and shift are loaded once a step (forward, the
  // chunk moves) or once (dW)
  const int q = tid % 8;
  float sc[8], sh[8];
  if (kDW) load_affine(scale, shift, dw_c0 + q * 8, g.ci, sc, sh);

  // X = relu(x*scale + shift [+ res]) of stage `slot` -> A tiles `buf`,
  // as bf16 pieces hi = bf16(X), then each the rounded remainder (each
  // remainder is exact in f32); flagged rows and channels past Ci are 0
  auto transform = [&](int s, int slot, int buf) {
    const int c = (kDW ? dw_c0 : (s % nch) * 64) + q * 8;
    if (!kDW) load_affine(scale, shift, c, g.ci, sc, sh);
    uint8_t* a0 = sA + buf * L::kPiecesX * L::kABytes;
#pragma unroll
    for (int j = 0; j < L::kUnits; ++j) {
      const int r = (tid + j * L::kThreads) / 8;
      uint32_t pk[L::kPiecesX][4] = {};
      if (sOk[slot * kRows + r] && c < g.ci) {
        const uint8_t* xs = sX + slot * L::kRawBytes + r * kRawRow +
                            q * 8 * static_cast<int>(sizeof(T));
        float xv[8], rv[8] = {};
        load8<T>(xs, xv);
        if (has_res) load8<T>(xs + (sR - sX), rv);
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          float X[2];
#pragma unroll
          for (int f = 0; f < 2; ++f)
            X[f] = prologue(xv[e + f], rv[e + f], has_res, sc[e + f],
                            sh[e + f], relu);
#pragma unroll
          for (int t = 0; t < L::kPiecesX; ++t) {
            const __nv_bfloat162 b = __floats2bfloat162_rn(X[0], X[1]);
            pk[t][e / 2] = *reinterpret_cast<const uint32_t*>(&b);
            X[0] -= __low2float(b);
            X[1] -= __high2float(b);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < L::kPiecesX; ++t)
        *reinterpret_cast<uint4*>(a0 + t * L::kABytes + swz(r, q)) =
            make_uint4(pk[t][0], pk[t][1], pk[t][2], pk[t][3]);
    }
  };

  float acc[kNP][32], tot[kNP][32];
#pragma unroll
  for (int p = 0; p < kNP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = tot[p][i] = 0.f;

  // issue the MMAs of one step on stage `slot` and A tiles `buf`: the
  // products of pieces whose orders sum to at most 1 (bf16 inputs:
  // X_hi.B, X_lo.B) or 2 (f32: hi.hi, hi.mid, mid.hi, hi.lo, lo.hi,
  // mid.mid; the dropped terms are ~2^-24 of the product)
  auto mma = [&](int slot, int buf) {
    uint32_t a0 = smem_u32(sA + buf * L::kPiecesX * L::kABytes);
    if (!kDW) a0 += wg * 64 * 128;         // this warpgroup's 64 rows
    const uint32_t b0s = smem_u32(sB + slot * L::kBBytes);
#pragma unroll
    for (int p = 0; p < kNP; ++p) fence_acc(acc[p]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // K-major A steps 16 channels (32 bytes) along its rows; an
      // M-major A and the N-major B step 16 rows (2048 bytes).  The
      // stride offset is the 1024 bytes between groups of 8 rows; the
      // leading offset of an M/N-major operand is the stride between
      // 64-wide panels (unused by a K-major one)
      const uint32_t aoff = kDW ? kk * 2048 : kk * 32;
      const uint32_t alb = kDW ? kPanelBytes : 16;
#pragma unroll
      for (int ta = 0; ta < L::kPiecesX; ++ta)
#pragma unroll
        for (int tb = 0; tb < L::kTermsB; ++tb) {
          if (ta + tb > L::kPiecesX - 1) continue;
          const uint64_t da =
              smem_desc(a0 + ta * L::kABytes + aoff, alb, 1024);
          const int add = !L::kPromote || kk + ta + tb > 0;
#pragma unroll
          for (int p = 0; p < kNP; p += 2) {
            // n128 over panel pairs, n64 for a last odd panel
            const int panel = kDW ? wg * kNP + p : p;
            const uint64_t db =
                smem_desc(b0s + panel * kPanelBytes + kk * 2048 +
                              tb * L::kPanels * kPanelBytes,
                          kPanelBytes, 1024);
            if (p + 1 < kNP)
              wgmma128<kDW ? 1 : 0>(acc[p], acc[p + 1 < kNP ? p + 1 : p], da,
                                      db, add);
            else
              wgmma64<kDW ? 1 : 0>(acc[p], da, db, add);
          }
        }
    }
    wgmma_commit();
  };

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // stages-2 steps in flight ahead of the one being transformed; the
  // one before it is still in the tensor cores
  for (int s = 0; s < stages - 2; ++s) {
    if (s < steps) issue(s, s);
    else cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    const int slot = s % stages;
    if (stages == 4) cp_async_wait<1>();
    else cp_async_wait<0>();
    mbar_wait(&bar[slot], (s / stages) & 1);
    wgmma_wait<1>();           // step s-2's MMAs are done (this warpgroup)
    __syncthreads();           // ... and every warpgroup's: its stage and
                               // A tiles are free; stage s has landed
    transform(s, slot, s & 1);
    // make the A tiles visible to the tensor cores (the async proxy)
    fence_proxy_async();
    const int next = s + stages - 2;
    if (next < steps) issue(next, next % stages);
    else cp_async_commit();
    if constexpr (L::kPromote) {
      wgmma_wait<0>();         // step s-1's sum (zeros at s = 0) is done
#pragma unroll
      for (int p = 0; p < kNP; ++p) {
        fence_acc(acc[p]);
#pragma unroll
        for (int i = 0; i < 32; ++i) tot[p][i] += acc[p][i];
      }
    }
    __syncthreads();
    mma(slot, s & 1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < kNP; ++p) {
    fence_acc(acc[p]);
    if constexpr (L::kPromote) {
#pragma unroll
      for (int i = 0; i < 32; ++i) tot[p][i] += acc[p][i];
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) tot[p][i] = acc[p][i];
    }
  }

  // accumulator (i) of thread t: row 16*warp + lane/4 (+8 for i%4 >= 2),
  // col 8*(i/4) + 2*(lane%4) + i%2, within the warpgroup's 64 x 64 panel
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
#pragma unroll
  for (int p = 0; p < kNP; ++p) {
    const int cbase = n0 + (kDW ? wg * kNP + p : p) * kPanel + 2 * (lane % 4);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = cbase + 8 * q;
      if (col >= g.co) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r0 + 8 * hf;
        const float a = tot[p][4 * q + 2 * hf], b = tot[p][4 * q + 2 * hf + 1];
        if (kDW) {
          const int c = dw_c0 + r;
          if (c >= g.ci) continue;
          const long long row = static_cast<long long>(dw_tap) * g.ci + c;
          float* part = static_cast<float*>(dst) +
                        static_cast<long long>(blockIdx.z) * g.k * g.k *
                            g.ci * g.co;
          st2(part, row * g.co + col, a, b);
        } else {
          const int m = m0 + wg * 64 + r;
          if (m >= P) continue;
          st2(static_cast<T*>(dst), static_cast<long long>(m) * g.co + col,
              a, b);
        }
      }
    }
  }
}

// What the halo forward stages.  A block takes 128 output positions (two
// warpgroups of 64) x 64*kNP output channels (kNP = 4 leaves room for
// two B stages only); per 64-channel chunk it
// stages the x rows that its positions' taps reach, kHaloMax at most
// (128 + (k-1)*(W+1) rows), forms X from them once, and the k*k taps
// read their rows of that X.
template <int kNP>
struct Halo {
  static constexpr int kThreads = 256;
  static constexpr int kRows = 128;
  static constexpr int kHaloMax = 256;
  static constexpr int kBBytes = kNP * kPanelBytes;
  static constexpr int kRawBytes = kHaloMax * 128;   // bf16 rows of 64 ch
  static constexpr int kABytes = kHaloMax * 128;     // one bf16 piece
  static constexpr int kStages = kNP == 4 ? 2 : 4;  // B ring
  static constexpr int smem_bytes() {
    return 1024 + kStages * kBBytes + 2 * kRawBytes + 2 * kABytes + 128 +
           8 * (kStages + 2);
  }
};

// Replaces `_fwd_kernel` for bf16 x at stride 1 without a residual (the
// ResNet path) where the halo fits: the prologue and split run once per
// x element and chunk instead of once per tap.  Steps are (chunk, tap),
// chunk outer; B (w rows tap*Ci + c0) arrives by TMA in a 4-stage ring,
// the raw halo of the next chunk by TMA while the current chunk's taps
// run.  A warp's A fragments come from the X tiles by ldmatrix, one row
// address per lane: the row its output position reaches at the tap, or
// a zero row where that lies outside the image (SAME padding).
template <int kNP>
__global__ void __launch_bounds__(256, 1)
fwd_halo_kernel(const __grid_constant__ CUtensorMap bm,
                const __grid_constant__ CUtensorMap xm,
                const float* __restrict__ scale,
                const float* __restrict__ shift,
                __nv_bfloat16* __restrict__ out, Geom g, int relu,
                int halo_rows) {
  using L = Halo<kNP>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sB = sm;                            // [S] B panels
  uint8_t* sX = sB + S * L::kBBytes;           // [2] raw halo
  uint8_t* sA = sX + 2 * L::kRawBytes;         // [hi, lo] X halo
  uint8_t* sZero = sA + 2 * L::kABytes;        // one zero row
  uint64_t* bar = reinterpret_cast<uint64_t*>(sZero + 128);  // [S] B
  uint64_t* xbar = bar + S;                                   // [2] halo

  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int nch = (g.ci + 63) / 64;
  const int taps = g.k * g.k;
  const int steps = nch * taps;
  const int P = g.n * g.h * g.w;
  const int m0 = blockIdx.x * L::kRows;
  const int n0 = blockIdx.y * kPanel * kNP;
  const int h0 = m0 - g.pad_y * g.w - g.pad_x;   // first halo row

  // this lane's ldmatrix row: output position m, image row/col (y, x)
  const int lrow = wg * 64 + warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lm = m0 + lrow;
  const bool lok = lm < P;
  const int lrem = (lok ? lm : 0) % (g.h * g.w);
  const int ly = lrem / g.w, lx = lrem % g.w;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(&bar[i], 1);
    for (int i = 0; i < 2; ++i) mbar_init(&xbar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 32) reinterpret_cast<uint32_t*>(sZero)[tid] = 0u;
  __syncthreads();

  auto load_b = [&](int s) {        // thread 0: step s's B into its slot
    const int cc = s / taps, tap = s - cc * taps;
    const int slot = s % S;
    mbar_expect_tx(&bar[slot], L::kBBytes);
#pragma unroll
    for (int p = 0; p < kNP; ++p)
      tma_load(sB + slot * L::kBBytes + p * kPanelBytes, &bm, &bar[slot],
               n0 + p * kPanel, tap * g.ci + cc * 64);
  };
  auto load_x = [&](int cc) {       // thread 0: chunk cc's raw halo
    mbar_expect_tx(&xbar[cc & 1], L::kRawBytes);
    tma_load(sX + (cc & 1) * L::kRawBytes, &xm, &xbar[cc & 1], cc * 64, h0);
  };
  if (tid == 0) {
    load_x(0);
    for (int s = 0; s < S && s < steps; ++s) load_b(s);
  }

  const int q = tid % 8;
  float sc[8], sh[8];
  float acc[kNP][32];
#pragma unroll
  for (int p = 0; p < kNP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  for (int cc = 0; cc < nch; ++cc) {
    // X of chunk cc's halo, hi and lo pieces (the taps of chunk cc-1 are
    // done: every step ends on a barrier after its MMAs)
    load_affine(scale, shift, cc * 64 + q * 8, g.ci, sc, sh);
    mbar_wait(&xbar[cc & 1], (cc >> 1) & 1);
    const uint8_t* raw = sX + (cc & 1) * L::kRawBytes;
    for (int u = tid; u < halo_rows * 8; u += L::kThreads) {
      const int r = u / 8;
      float xv[8];
      load8<__nv_bfloat16>(raw + r * 128 + q * 16, xv);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float X0 = prologue(xv[e], 0.f, false, sc[e], sh[e], relu);
        float X1 = prologue(xv[e + 1], 0.f, false, sc[e + 1], sh[e + 1], relu);
        const __nv_bfloat162 b = __floats2bfloat162_rn(X0, X1);
        const __nv_bfloat162 l = __floats2bfloat162_rn(
            X0 - __low2float(b), X1 - __high2float(b));
        hi[e / 2] = *reinterpret_cast<const uint32_t*>(&b);
        lo[e / 2] = *reinterpret_cast<const uint32_t*>(&l);
      }
      *reinterpret_cast<uint4*>(sA + swz(r, q)) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sA + L::kABytes + swz(r, q)) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();   // the X halo is whole; raw buffer cc&1 is free
    if (tid == 0 && cc + 1 < nch) load_x(cc + 1);

    for (int tap = 0; tap < taps; ++tap) {
      const int s = cc * taps + tap, slot = s % S;
      const int ky = tap / g.k, kx = tap - (tap / g.k) * g.k;
      const int iy = ly + ky - g.pad_y, ix = lx + kx - g.pad_x;
      const bool ok = lok && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
      const int hr = lrow + ky * g.w + kx;     // halo row of this lane
      // A fragments: per k16 slice kk, pieces hi and lo
      uint32_t a[4][2][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const uint32_t addr =
              ok ? smem_u32(sA + t * L::kABytes +
                            swz(hr, 2 * kk + (lane >> 4)))
                 : smem_u32(sZero);
          ldmatrix_x4(a[kk][t], addr);
        }
      mbar_wait(&bar[slot], (s / S) & 1);
#pragma unroll
      for (int p = 0; p < kNP; ++p) fence_acc(acc[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = smem_desc(
            smem_u32(sB + slot * L::kBBytes) + kk * 2048, kPanelBytes, 1024);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if constexpr (kNP == 1) {
            wgmma64_rs(acc[0], a[kk][t], db);
          } else {
#pragma unroll
            for (int p = 0; p < kNP; p += 2)
              wgmma128_rs(acc[p], acc[p + 1], a[kk][t],
                          db + ((p * kPanelBytes) >> 4));
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < kNP; ++p) fence_acc(acc[p]);
      __syncthreads();   // every warpgroup is done with the slot
      if (tid == 0 && s + S < steps) load_b(s + S);
    }
  }

  // accumulator (i) of thread t: row 16*warp + lane/4 (+8 for i%4 >= 2),
  // col 8*(i/4) + 2*(lane%4) + i%2, within the warpgroup's 64 x 64 panel
  const int r0 = warp * 16 + lane / 4;
#pragma unroll
  for (int p = 0; p < kNP; ++p) {
    const int cbase = n0 + p * kPanel + 2 * (lane % 4);
#pragma unroll
    for (int qq = 0; qq < 8; ++qq) {
      const int col = cbase + 8 * qq;
      if (col >= g.co) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m0 + wg * 64 + r0 + 8 * hf;
        if (m >= P) continue;
        st2(out, static_cast<long long>(m) * g.co + col,
            acc[p][4 * qq + 2 * hf], acc[p][4 * qq + 2 * hf + 1]);
      }
    }
  }
}

// What the 3x3 halo dW stages: three warpgroups, one kernel row each;
// per step of 64 positions the x rows all nine taps reach (64 + 2W + 2,
// kHaloMax at most).
struct DwHalo {
  static constexpr int kThreads = 384;
  static constexpr int kHaloMax = 256;
  static constexpr int kStages = 4;
  static constexpr int kRawBytes = kHaloMax * 128;
  static constexpr int kABytes = kHaloMax * 128;     // one bf16 piece
  static constexpr int smem_bytes() {
    return 1024 + kStages * kPanelBytes + 2 * kRawBytes + 4 * kABytes +
           128 + 8 * (kStages + 2);
  }
};

// Replaces `_dw_kernel` for bf16 x at stride 1, 3x3, without a residual
// (the ResNet path) where the halo fits.  A block takes 64 input
// channels x 64 output channels for all nine taps over one chunk of
// positions: warpgroup ky keeps the accumulators of taps (ky, 0..2).  Per
// step the TMA brings the 64 x 64 dO tile (B) and the raw x rows of the
// step's halo; X is formed from them once (two bf16 pieces, double
// buffered so the next step's X is formed while the tensor cores finish
// this one), and each tap's A = X^T fragments come by ldmatrix.trans, one
// position row per lane (a zero row where the tap leaves the image or
// the position the chunk).  The sums run in the tensor cores'
// accumulators over a chunk of ~1500 positions; chunks are added in
// order by `reduce_splits`.
__global__ void __launch_bounds__(384, 1)
dw_halo_kernel(const __grid_constant__ CUtensorMap dm,
               const __grid_constant__ CUtensorMap xm,
               const float* __restrict__ scale,
               const float* __restrict__ shift, float* __restrict__ part,
               Geom g, int relu, int chunk, int halo_rows) {
  using L = DwHalo;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sB = sm;                            // [S] dO panels
  uint8_t* sX = sB + S * kPanelBytes;          // [2] raw halo
  uint8_t* sA = sX + 2 * L::kRawBytes;         // [2][hi, lo] X halo
  uint8_t* sZero = sA + 4 * L::kABytes;        // one zero row
  uint64_t* bar = reinterpret_cast<uint64_t*>(sZero + 128);  // [S] B
  uint64_t* xbar = bar + S;                                   // [2] raw

  const int tid = threadIdx.x, wg = tid / 128;     // wg = ky
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int P = g.n * g.h * g.w, hw = g.h * g.w;
  const int c0 = blockIdx.x * 64, n0 = blockIdx.y * kPanel;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(P, kbeg + chunk);
  const int steps = (kend - kbeg + 63) / 64;
  const int lead = g.pad_y * g.w + g.pad_x;       // halo rows before p0

  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(&bar[i], 1);
    for (int i = 0; i < 2; ++i) mbar_init(&xbar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 32) reinterpret_cast<uint32_t*>(sZero)[tid] = 0u;
  __syncthreads();

  auto load_b = [&](int s) {        // thread 0: step s's dO tile
    mbar_expect_tx(&bar[s % S], kPanelBytes);
    tma_load(sB + (s % S) * kPanelBytes, &dm, &bar[s % S], n0,
             kbeg + s * 64);
  };
  auto load_x = [&](int s) {        // thread 0: step s's raw halo
    mbar_expect_tx(&xbar[s & 1], L::kRawBytes);
    tma_load(sX + (s & 1) * L::kRawBytes, &xm, &xbar[s & 1], c0,
             kbeg + s * 64 - lead);
  };
  if (tid == 0) {
    for (int s = 0; s < 2 && s < steps; ++s) load_x(s);
    for (int s = 0; s < S - 1 && s < steps; ++s) load_b(s);
  }

  const int q = tid % 8;
  float sc[8], sh[8];
  load_affine(scale, shift, c0 + q * 8, g.ci, sc, sh);
  float acc[3][32];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;

  // this lane's ldmatrix.trans row: matrix lane/8 holds positions
  // 8*(lane/16).. of a 16-position slice and channels 16*warp + 8*(lane/8
  // % 2)..; the lane gives the row of position (lane % 8) of that matrix
  const int lpos = (lane & 7) + 8 * (lane >> 4);
  const int lchunk = 2 * warp + ((lane >> 3) & 1);
  const uint32_t zero = smem_u32(sZero);
  // A fragments of two (k16 slice, tap) groups: a group's registers stay
  // untouched until the wait after the next group's issue
  uint32_t a[2][2][4] = {};

  for (int s = 0; s < steps; ++s) {
    const int p0 = kbeg + s * 64;
    uint8_t* xa = sA + (s & 1) * 2 * L::kABytes;
    mbar_wait(&xbar[s & 1], (s >> 1) & 1);
    const uint8_t* raw = sX + (s & 1) * L::kRawBytes;
    for (int u = tid; u < halo_rows * 8; u += L::kThreads) {
      const int r = u / 8;
      float xv[8];
      load8<__nv_bfloat16>(raw + r * 128 + q * 16, xv);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const float X0 = prologue(xv[e], 0.f, false, sc[e], sh[e], relu);
        const float X1 =
            prologue(xv[e + 1], 0.f, false, sc[e + 1], sh[e + 1], relu);
        const __nv_bfloat162 b = __floats2bfloat162_rn(X0, X1);
        const __nv_bfloat162 l = __floats2bfloat162_rn(
            X0 - __low2float(b), X1 - __high2float(b));
        hi[e / 2] = *reinterpret_cast<const uint32_t*>(&b);
        lo[e / 2] = *reinterpret_cast<const uint32_t*>(&l);
      }
      *reinterpret_cast<uint4*>(xa + swz(r, q)) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(xa + L::kABytes + swz(r, q)) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    wgmma_wait<0>();   // step s-1's MMAs (their A registers, B slot)
    keep(a[1][0]);     // ... whose last group read a[1] until now
    keep(a[1][1]);
#pragma unroll
    for (int t = 0; t < 3; ++t) fence_acc(acc[t]);
    __syncthreads();   // X of step s is whole; raw s&1 and B slot free
    if (tid == 0) {
      if (s + 2 < steps) load_x(s + 2);
      if (s + S - 1 < steps) load_b(s + S - 1);
    }

    // row addresses of this lane's positions (one per k16 slice) at the
    // three taps of kernel row wg
    uint32_t addr[4][3];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int pr = kk * 16 + lpos;             // position - p0
      const int p = p0 + pr;
      const int rem = (p < kend ? p : 0) % hw;
      const int iy = rem / g.w + wg - g.pad_y;
      const bool rok = p < kend && iy >= 0 && iy < g.h;
      const int x = rem % g.w;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int ix = x + kx - g.pad_x;
        const int hr = pr + wg * g.w + kx;
        addr[kk][kx] = rok && ix >= 0 && ix < g.w
                           ? smem_u32(xa) + swz(hr, lchunk)
                           : zero;
      }
    }
    mbar_wait(&bar[s % S], (s / S) & 1);
    const uint32_t b0 = smem_u32(sB + (s % S) * kPanelBytes);
    wgmma_fence();
    // twelve groups (k16 slice, tap) of two wgmmas (X hi, X lo)
#pragma unroll
    for (int gi = 0; gi < 12; ++gi) {
      const int kk = gi / 3, kx = gi % 3, buf = gi & 1;
      const uint32_t ah = addr[kk][kx];
      ldmatrix_x4_trans(a[buf][0], ah);
      ldmatrix_x4_trans(a[buf][1], ah == zero ? zero : ah + L::kABytes);
      const uint64_t db = smem_desc(b0 + kk * 2048, kPanelBytes, 1024);
      wgmma64_rs(acc[kx], a[buf][0], db);
      wgmma64_rs(acc[kx], a[buf][1], db);
      wgmma_commit();
      if (gi > 0) {
        wgmma_wait<1>();
        keep(a[buf ^ 1][0]);
        keep(a[buf ^ 1][1]);
      }
    }
  }
  wgmma_wait<0>();
  keep(a[1][0]);
  keep(a[1][1]);
#pragma unroll
  for (int t = 0; t < 3; ++t) fence_acc(acc[t]);

  // accumulator (i): row (input channel) 16*warp + lane/4 (+8 for i%4 >=
  // 2), col (output channel) 8*(i/4) + 2*(lane%4) + i%2
  float* dst = part + static_cast<long long>(blockIdx.z) * 9 * g.ci * g.co;
  const int r0 = warp * 16 + lane / 4;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
    for (int qq = 0; qq < 8; ++qq) {
      const int col = n0 + 8 * qq + 2 * (lane % 4);
      if (col >= g.co) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = c0 + r0 + 8 * hf;
        if (c >= g.ci) continue;
        const long long row = static_cast<long long>(wg * 3 + kx) * g.ci + c;
        st2(dst, row * g.co + col, acc[kx][4 * qq + 2 * hf],
            acc[kx][4 * qq + 2 * hf + 1]);
      }
    }
  }
}

// --------------------------------------------------------------------- dX
// Replaces `_dx_kernel` for f32 and stride 2 (bf16 at stride 1 takes
// `dx_tc_kernel`).  G = dO correlated with the flipped taps: input
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

// What the tensor-core dX stages.  A block takes 128 input positions
// (two warpgroups of 64) x 64*kNP input channels; per 64-channel chunk of
// Co the TMA brings the dO rows that all its positions' taps reach (its
// halo: 128 + (k-1)(W+1) rows, rounded up to whole 8-row swizzle atoms)
// into a ring of halo slots in kRingBytes (two at the widest images, up
// to kMaxSlots), and per (chunk, tap) step the 64*kNP x 64 panel of w
// rows tap*Ci + c0.. into a B ring.
template <int kNP>
struct DxHalo {
  static constexpr int kThreads = 256;
  static constexpr int kRows = 128;
  static constexpr int kHaloMax = 256;
  static constexpr int kBBytes = kNP * kPanelBytes;
  static constexpr int kStages = kNP == 2 ? 2 : 4;  // B ring
  static constexpr int kRingBytes = 65536;          // dO halo slots
  static constexpr int kMaxSlots = 4;
  static constexpr int smem_bytes() {
    return 1024 + kStages * kBBytes + kRingBytes + 128 +
           8 * (kStages + kMaxSlots);
  }
};

// Replaces `_dx_kernel` for bf16 at stride 1 (the ResNet path).  G = dO
// correlated with the flipped taps is an implicit GEMM over the input
// positions, whose A operand is the raw dO: no prologue, and both
// operands are exact bf16, so one product per term.  Steps are (chunk of
// 64 output channels, tap), chunk outer.  A warp's A fragments come from
// the chunk's staged halo by ldmatrix, one row address per lane: the dO
// row its input position reaches at the tap, (pad - ky) W + (pad - kx)
// rows from it, or a zero row where that lies outside the image.  B is w
// as [k*k*Ci, Co], read K-major (Co contiguous), so no transposed copy of
// w exists; where a panel runs past this tap's Ci rows (Ci < 64 or the
// last column block) those rows feed only columns >= Ci, never written.
// One step's MMAs stay in flight while the next step's fragments are
// loaded (wgmma_wait<1>); the loads of a panel's x (and res) for the
// epilogue are all issued before any is used.
// The epilogue recomputes the relu mask from the raw x (and res) with
// `pre_act`, writes dx = G*m*scale and dres = G*m in bf16, and one
// partial row of sum G*m*x and sum G*m per 64 positions (a warpgroup),
// summed in a fixed order (the quad's two rows, the warp's lanes by a
// shuffle tree, the four warps in turn): the same bits on every run.
template <int kNP>
__global__ void __launch_bounds__(256, kNP == 4 ? 1 : 2)
dx_tc_kernel(const __grid_constant__ CUtensorMap wm,
             const __grid_constant__ CUtensorMap dm,
             const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ res,
             const float* __restrict__ scale,
             const float* __restrict__ shift, __nv_bfloat16* __restrict__ dx,
             __nv_bfloat16* __restrict__ dres, float* __restrict__ part_sc,
             float* __restrict__ part_sh, Geom g, int relu, int slot_bytes,
             int slots) {
  using L = DxHalo<kNP>;
  constexpr int SB = L::kStages, kCols = kNP * kPanel;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sB = sm;                            // [SB] w panels
  uint8_t* sD = sB + SB * L::kBBytes;          // [slots] dO halos
  uint8_t* sZero = sD + L::kRingBytes;         // one zero row
  uint64_t* bar = reinterpret_cast<uint64_t*>(sZero + 128);  // [SB] B
  uint64_t* dbar = bar + SB;                                  // halos

  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int nch = (g.co + 63) / 64;
  const int taps = g.k * g.k;
  const int steps = nch * taps;
  const int P = g.n * g.h * g.w;
  const int m0 = blockIdx.x * L::kRows;
  const int c0 = blockIdx.y * kCols;
  // halo row 0 is dO row m0 - lead, where the last tap reaches
  const int lead = (g.k - 1 - g.pad_y) * g.w + (g.k - 1 - g.pad_x);

  // this lane's ldmatrix row: input position m, image row/col (y, x)
  const int lrow = wg * 64 + warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lm = m0 + lrow;
  const bool lok = lm < P;
  const int lrem = (lok ? lm : 0) % (g.h * g.w);
  const int ly = lrem / g.w, lx = lrem % g.w;

  if (tid == 0) {
    for (int i = 0; i < SB; ++i) mbar_init(&bar[i], 1);
    for (int i = 0; i < L::kMaxSlots; ++i) mbar_init(&dbar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 32) reinterpret_cast<uint32_t*>(sZero)[tid] = 0u;
  __syncthreads();

  auto load_b = [&](int s) {        // thread 0: step s's w panels
    const int cc = s / taps, tap = s - cc * taps;
    const int slot = s % SB;
    mbar_expect_tx(&bar[slot], L::kBBytes);
#pragma unroll
    for (int p = 0; p < kNP; ++p)
      tma_load(sB + slot * L::kBBytes + p * kPanelBytes, &wm, &bar[slot],
               cc * 64, tap * g.ci + c0 + p * kPanel);
  };
  auto load_d = [&](int cc) {       // thread 0: chunk cc's dO halo
    const int slot = cc % slots;
    mbar_expect_tx(&dbar[slot], slot_bytes);
    tma_load(sD + slot * slot_bytes, &dm, &dbar[slot], cc * 64, m0 - lead);
  };
  if (tid == 0) {
    for (int cc = 0; cc < slots && cc < nch; ++cc) load_d(cc);
    for (int s = 0; s < SB && s < steps; ++s) load_b(s);
  }

  float acc[kNP][32];
#pragma unroll
  for (int p = 0; p < kNP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  // Step s = (chunk s / taps, tap s % taps).  Its A fragments go to one
  // of two register sets, a0 for even steps and a1 for odd ones (each
  // step's code is inlined twice, so no set is indexed at run time): a
  // set stays untouched until the next step's wait finds its MMAs done,
  // while the next step's are loaded.
  uint32_t a0[4][4], a1[4][4];
  auto step = [&](int s, uint32_t (&a)[4][4], uint32_t (&prev)[4][4]) {
    const int cc = s / taps, tap = s - cc * taps, slot = s % SB;
    const int dslot = cc % slots;
    const uint8_t* halo = sD + dslot * slot_bytes;
    if (tap == 0) mbar_wait(&dbar[dslot], (cc / slots) & 1);
    const int ky = tap / g.k, kx = tap - ky * g.k;
    const int oy = ly + g.pad_y - ky, ox = lx + g.pad_x - kx;
    const bool ok = lok && oy >= 0 && oy < g.h && ox >= 0 && ox < g.w;
    const int hr = lrow + lead + (g.pad_y - ky) * g.w + (g.pad_x - kx);
    // A fragments of the chunk's four k16 slices at this tap
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(a[kk], ok ? smem_u32(halo + swz(hr, 2 * kk + (lane >> 4)))
                            : smem_u32(sZero));
    mbar_wait(&bar[slot], (s / SB) & 1);
#pragma unroll
    for (int p = 0; p < kNP; ++p) fence_acc(acc[p]);
    wgmma_fence();
    const uint32_t b0 = smem_u32(sB + slot * L::kBBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // K-major B: a k16 slice is 32 bytes along each 128-byte row
      const uint64_t db = smem_desc(b0 + kk * 32, 16, 1024);
      if constexpr (kNP == 1) {
        wgmma64_rs<0>(acc[0], a[kk], db);
      } else {
#pragma unroll
        for (int p = 0; p < kNP; p += 2)
          wgmma128_rs<0>(acc[p], acc[p + 1], a[kk],
                         db + ((p * kPanelBytes) >> 4));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();     // step s-1's MMAs are done (this warpgroup)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) keep(prev[kk]);
    __syncthreads();     // ... and every warpgroup's: its B slot is free
                         // (and, past a chunk's last tap, every warp has
                         // read the chunk's halo)
    if (tid == 0) {
      if (s > 0 && s - 1 + SB < steps) load_b(s - 1 + SB);
      if (tap == taps - 1 && cc + slots < nch) load_d(cc + slots);
    }
  };
  for (int s = 0; s < steps; ++s) {
    if (s & 1)
      step(s, a1, a0);
    else
      step(s, a0, a1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    keep(a0[kk]);
    keep(a1[kk]);
  }
#pragma unroll
  for (int p = 0; p < kNP; ++p) fence_acc(acc[p]);
  // wgmma_wait<0> covers this warpgroup's MMAs only: the other's last
  // step may still read its B panel, which may lie under `red` below
  __syncthreads();

  // accumulator (i) of thread t: row 16*warp + lane/4 (+8 for i%4 >= 2),
  // col 8*(i/4) + 2*(lane%4) + i%2, within the warpgroup's 64 x 64 panel.
  // The B ring is free (every load and every MMA was waited for): it
  // holds the warps' column sums, [warpgroup][warp][sum G*m*x, sum G*m]
  // [kCols].
  const bool has_res = res != nullptr;
  float* red = reinterpret_cast<float*>(sB);
  const int r0 = warp * 16 + lane / 4;
#pragma unroll
  for (int p = 0; p < kNP; ++p) {
    __nv_bfloat162 xr[8][2], rr[8][2];
#pragma unroll
    for (int qq = 0; qq < 8; ++qq) {
      const int col = c0 + p * kPanel + 8 * qq + 2 * (lane % 4);
      const bool cok = col < g.ci;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m0 + wg * 64 + r0 + 8 * hf;
        const long long off = static_cast<long long>(m) * g.ci + col;
        const bool in = cok && m < P;
        const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
        xr[qq][hf] =
            in ? *reinterpret_cast<const __nv_bfloat162*>(x + off) : z;
        rr[qq][hf] = in && has_res
                         ? *reinterpret_cast<const __nv_bfloat162*>(res + off)
                         : z;
      }
    }
#pragma unroll
    for (int qq = 0; qq < 8; ++qq) {
      const int cl = p * kPanel + 8 * qq + 2 * (lane % 4);
      const int col = c0 + cl;
      float ssc[2] = {0.f, 0.f}, ssh[2] = {0.f, 0.f};
      const bool cok = col < g.ci;
      const float2 zero2 = make_float2(0.f, 0.f);
      const float2 sc =
          cok ? *reinterpret_cast<const float2*>(scale + col) : zero2;
      const float2 sh =
          cok ? *reinterpret_cast<const float2*>(shift + col) : zero2;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m0 + wg * 64 + r0 + 8 * hf;
        if (!cok || m >= P) continue;
        const long long off = static_cast<long long>(m) * g.ci + col;
        const float2 xv = __bfloat1622float2(xr[qq][hf]);
        const float2 rv = __bfloat1622float2(rr[qq][hf]);
        float g0 = acc[p][4 * qq + 2 * hf], g1 = acc[p][4 * qq + 2 * hf + 1];
        if (relu && !(pre_act(xv.x, rv.x, has_res, sc.x, sh.x) > 0.f))
          g0 = 0.f;
        if (relu && !(pre_act(xv.y, rv.y, has_res, sc.y, sh.y) > 0.f))
          g1 = 0.f;
        st2(dx, off, g0 * sc.x, g1 * sc.y);
        if (dres != nullptr) st2(dres, off, g0, g1);
        ssc[0] += g0 * xv.x;
        ssc[1] += g1 * xv.y;
        ssh[0] += g0;
        ssh[1] += g1;
      }
      // over the warp's eight row groups (lanes xor 4, 8, 16)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ssc[e] += __shfl_xor_sync(0xffffffffu, ssc[e], o);
          ssh[e] += __shfl_xor_sync(0xffffffffu, ssh[e], o);
        }
      if (lane < 4) {
        float* rw = red + (wg * 4 + warp) * 2 * kCols;
        rw[cl] = ssc[0];
        rw[cl + 1] = ssc[1];
        rw[kCols + cl] = ssh[0];
        rw[kCols + cl + 1] = ssh[1];
      }
    }
  }
  __syncthreads();
  // one partial row per warpgroup's 64 positions: its four warps in turn
  for (int i = tid; i < 2 * kCols; i += L::kThreads) {
    const int w2 = i / kCols, cl = i % kCols, col = c0 + cl;
    const int row = blockIdx.x * 2 + w2;
    if (col >= g.ci || row * 64 >= P) continue;
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int wp = 0; wp < 4; ++wp) {
      const float* rw = red + (w2 * 4 + wp) * 2 * kCols;
      a += rw[cl];
      b += rw[kCols + cl];
    }
    const long long o = static_cast<long long>(row) * g.ci + col;
    part_sc[o] = a;
    part_sh[o] = b;
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

// The bf16 matrix [rows, cols] (row-major) at `base` as boxes of
// box_rows x 64, 128-byte swizzled (B operands) or not (raw x rows);
// reads past its edges give zeros.
cudaError_t make_map(CUtensorMap* map, const void* base, long long rows,
                     int cols, int box_rows = kPanel, bool swizzle = true) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kPanel, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
      dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// B maps: bf16 B [rows, co] at `b`, or for f32 inputs its bf16 pieces
// [3, rows, co] (hi, mid, lo) there.
cudaError_t make_b_maps(int dtype, const void* b, long long rows, int co,
                        CUtensorMap (&maps)[3]) {
  for (int t = 0; t < 3; ++t) {
    if (dtype != 0 && t > 0) {
      maps[t] = maps[0];
      continue;
    }
    const cudaError_t e = make_map(
        &maps[t], static_cast<const __nv_bfloat16*>(b) + t * rows * co, rows,
        co);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// The deepest ring (4 stages, at least 3) that fits, then the launch.
template <typename T, int kWG, int kNP, bool kDW>
cudaError_t launch_tc(const CUtensorMap (&maps)[3],
                      const void* x, const void* res, const void* scale,
                      const void* shift, void* dst, Geom g, int relu,
                      int chunk, dim3 grid, cudaStream_t stream) {
  using L = Tile<T, kWG, kNP, kDW>;
  const bool has_res = res != nullptr;
  int stages = 4;
  while (stages > 3 && L::smem_bytes(stages, has_res) > kSmemMax) --stages;
  const int bytes = L::smem_bytes(stages, has_res);
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = tc_kernel<T, kWG, kNP, kDW>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, L::kThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const T*>(x),
      static_cast<const T*>(res),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      dst, g, relu, stages, chunk);
  return cudaGetLastError();
}

// Rows of the halo forward's staged x: 128 positions and what their taps
// reach beyond them.
int halo_rows(const Geom& g) { return 128 + (g.k - 1) * (g.w + 1); }

// The halo forward: bf16, stride 1, no residual, halo_rows(g) at most
// kHaloMax (every fused conv of ResNet-50; the rest takes `tc_kernel`).
bool halo_fits(int dtype, const Geom& g, const void* res) {
  return dtype == 1 && g.stride == 1 && res == nullptr &&
         halo_rows(g) <= Halo<1>::kHaloMax;
}

cudaError_t launch_halo(const CUtensorMap& bm, const void* x,
                        const void* scale, const void* shift, void* out,
                        Geom g, int relu, cudaStream_t stream) {
  CUtensorMap xm;
  cudaError_t e = make_map(&xm, x, static_cast<long long>(g.n) * g.h * g.w,
                           g.ci, Halo<1>::kHaloMax, false);
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks_for(static_cast<long long>(g.n) * g.h * g.w, 128),
                  blocks_for(g.co, g.co <= 64 ? 64 : g.co <= 128 ? 128 : 256));
  auto launch = [&](auto kernel, int bytes) {
    const cudaError_t a = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (a != cudaSuccess) return a;
    kernel<<<grid, 256, bytes, stream>>>(
        bm, xm, static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<__nv_bfloat16*>(out),
        g, relu, halo_rows(g));
    return cudaGetLastError();
  };
  if (g.co <= 64) return launch(fwd_halo_kernel<1>, Halo<1>::smem_bytes());
  if (g.co <= 128) return launch(fwd_halo_kernel<2>, Halo<2>::smem_bytes());
  return launch(fwd_halo_kernel<4>, Halo<4>::smem_bytes());
}

// The 3x3 halo dW: bf16, stride 1, no residual, its halo (64 + 2(W+1)
// rows) within kHaloMax (every 3x3 fused conv of ResNet-50).
bool dw_halo_fits(int dtype, const Geom& g, const void* res) {
  return dtype == 1 && g.stride == 1 && g.k == 3 && res == nullptr &&
         64 + 2 * (g.w + 1) <= DwHalo::kHaloMax;
}

cudaError_t launch_dw_halo(const CUtensorMap& dm, const void* x,
                           const void* scale, const void* shift,
                           float* part, Geom g, int relu, int splits,
                           int chunk, cudaStream_t stream) {
  CUtensorMap xm;
  cudaError_t e = make_map(&xm, x, static_cast<long long>(g.n) * g.h * g.w,
                           g.ci, DwHalo::kHaloMax, false);
  if (e != cudaSuccess) return e;
  const int bytes = DwHalo::smem_bytes();
  e = cudaFuncSetAttribute(dw_halo_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks_for(g.ci, 64), blocks_for(g.co, 64), splits);
  dw_halo_kernel<<<grid, DwHalo::kThreads, bytes, stream>>>(
      dm, xm, static_cast<const float*>(scale),
      static_cast<const float*>(shift), part, g, relu, chunk,
      64 + 2 * (g.w + 1));
  return cudaGetLastError();
}

// The channel counts the tensor-core kernels take: 16-byte rows of x
// (cp.async) and of B (the TMA's stride rule).
bool tc_widths_ok(const Geom& g) { return g.ci % 8 == 0 && g.co % 8 == 0; }

template <typename T>
cudaError_t launch_dx(const void* x, const void* scale, const void* shift,
                      const void* w, const void* dout, const void* res,
                      void* dx, void* dres, float* part_sc, float* part_sh,
                      Geom g, int relu, cudaStream_t stream) {
  const dim3 grid(blocks_for(static_cast<long long>(g.n) * g.h * g.w, kBM),
                  blocks_for(g.ci, kBN));
  dx_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const T*>(w),
      static_cast<const T*>(dout), static_cast<const T*>(res),
      static_cast<T*>(dx), static_cast<T*>(dres), part_sc, part_sh, g, relu);
  return cudaGetLastError();
}

// The tensor-core dX: bf16, stride 1, Ci and Co multiples of 8, its halo
// within kHaloMax rows (every fused conv of ResNet-50; the rest keeps the
// SIMT `dx_kernel`).
bool dx_tc_fits(int dtype, const Geom& g) {
  return dtype == 1 && g.stride == 1 && tc_widths_ok(g) &&
         halo_rows(g) <= DxHalo<1>::kHaloMax;
}

// Maps of w ([k*k*Ci, Co], 64 x 64 panels) and dO ([N*H*W, Co], boxes of
// the halo's rows x 64 channels, both 128-byte swizzled), the halo ring
// cut into as many slots as fit (at most kMaxSlots), 64, 128 or 256
// input channels a block by Ci; then the launch.
cudaError_t launch_dx_tc(const void* x, const void* scale, const void* shift,
                         const void* w, const void* dout, const void* res,
                         void* dx, void* dres, float* part_sc,
                         float* part_sh, Geom g, int relu,
                         cudaStream_t stream) {
  const int rows = (halo_rows(g) + 7) / 8 * 8;   // whole swizzle atoms
  const int slot_bytes = rows * 128;
  const int fit = DxHalo<1>::kRingBytes / slot_bytes;
  const int slots = fit < DxHalo<1>::kMaxSlots ? fit : DxHalo<1>::kMaxSlots;
  const long long P = static_cast<long long>(g.n) * g.h * g.w;
  CUtensorMap wm, dm;
  cudaError_t e = make_map(&wm, w, static_cast<long long>(g.k) * g.k * g.ci,
                           g.co);
  if (e == cudaSuccess) e = make_map(&dm, dout, P, g.co, rows);
  if (e != cudaSuccess) return e;
  const int np = g.ci <= 64 ? 1 : g.ci <= 128 ? 2 : 4;
  const dim3 grid(blocks_for(P, 128), blocks_for(g.ci, 64 * np));
  auto launch = [&](auto kernel, int bytes) {
    const cudaError_t a = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (a != cudaSuccess) return a;
    kernel<<<grid, 256, bytes, stream>>>(
        wm, dm, static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(res),
        static_cast<const float*>(scale), static_cast<const float*>(shift),
        static_cast<__nv_bfloat16*>(dx), static_cast<__nv_bfloat16*>(dres),
        part_sc, part_sh, g, relu, slot_bytes, slots);
    return cudaGetLastError();
  };
  if (np == 1) return launch(dx_tc_kernel<1>, DxHalo<1>::smem_bytes());
  if (np == 2) return launch(dx_tc_kernel<2>, DxHalo<2>::smem_bytes());
  return launch(dx_tc_kernel<4>, DxHalo<4>::smem_bytes());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, res, dO, w, out, dx, dres).
// Geometry: n, h, w, ci, co, k, stride, and the SAME output size (ho, wo)
// and low-side padding (pad_y, pad_x) as the wrapper computes them.
// `res` and `dres` may be null (no residual).  Each returns
// cudaGetLastError() after its launches (0 on success).
//
// Forward: with dtype 1, w is the bf16 HWIO weight ([k*k*ci, co]); with
// dtype 0, w is the f32 weight's bf16 pieces [3, k*k*ci, co] (hi, mid,
// lo), which the wrapper splits.  ci and co must be multiples of 8.
extern "C" int fused_conv_fwd(int dtype, const void* x, const void* scale,
                              const void* shift, const void* w,
                              const void* res, void* out, int n, int h,
                              int wd, int ci, int co, int k, int stride,
                              int ho, int wo, int pad_y, int pad_x, int relu,
                              void* stream) {
  const Geom g = make_geom(n, h, wd, ci, co, k, stride, ho, wo, pad_y, pad_x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || !tc_widths_ok(g))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  cudaError_t e = make_b_maps(dtype, w, static_cast<long long>(k) * k * ci,
                              co, maps);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = static_cast<long long>(n) * ho * wo;
  using bf16 = __nv_bfloat16;
  if (halo_fits(dtype, g, res))
    e = launch_halo(maps[0], x, scale, shift, out, g, relu, s);
  else if (dtype == 0)
    e = launch_tc<float, 1, 1, false>(
        maps, x, res, scale, shift, out, g, relu, 0,
        dim3(blocks_for(rows, 64), blocks_for(co, 64)), s);
  else
    e = launch_tc<bf16, 2, 2, false>(
        maps, x, res, scale, shift, out, g, relu, 0,
        dim3(blocks_for(rows, 128), blocks_for(co, 128)), s);
  return static_cast<int>(e);
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
  cudaError_t e;
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dx_tc_fits(dtype, g))
    e = launch_dx_tc(x, scale, shift, w, dout, res, dx, dres, psc, psh, g,
                     relu, s);
  else if (dtype == 0)
    e = launch_dx<float>(x, scale, shift, w, dout, res, dx, dres, psc, psh,
                         g, relu, s);
  else
    e = launch_dx<__nv_bfloat16>(x, scale, shift, w, dout, res, dx, dres,
                                 psc, psh, g, relu, s);
  if (e != cudaSuccess) return static_cast<int>(e);
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
// [i*chunk, min(n*ho*wo, (i+1)*chunk)).  With dtype 1, dout is the bf16
// dO ([n*ho*wo, co]); with dtype 0, the f32 dO's bf16 pieces [3,
// n*ho*wo, co] (hi, mid, lo), which the wrapper splits.  ci and co must be
// multiples of 8.  The 3x3 halo kernel (`dw_halo_fits`) takes 64 ci x 64
// co for all nine taps a block; `tc_kernel` 64 (tap, ci) rows and 256
// output channels (f32: 64).
extern "C" int fused_conv_dw(int dtype, const void* x, const void* scale,
                             const void* shift, const void* dout,
                             const void* res, void* part, void* dw, int n,
                             int h, int wd, int ci, int co, int k,
                             int stride, int ho, int wo, int pad_y,
                             int pad_x, int relu, int splits, int chunk,
                             void* stream) {
  const Geom g = make_geom(n, h, wd, ci, co, k, stride, ho, wo, pad_y, pad_x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || !tc_widths_ok(g) || splits < 1 ||
      chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  cudaError_t e = make_b_maps(dtype, dout,
                              static_cast<long long>(n) * ho * wo, co, maps);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned tiles = static_cast<unsigned>(k * k * ((ci + 63) / 64));
  float* p = static_cast<float*>(part);
  using bf16 = __nv_bfloat16;
  if (dw_halo_fits(dtype, g, res))
    e = launch_dw_halo(maps[0], x, scale, shift, p, g, relu, splits, chunk,
                       s);
  else if (dtype == 0)
    e = launch_tc<float, 1, 1, true>(
        maps, x, res, scale, shift, p, g, relu, chunk,
        dim3(tiles, blocks_for(co, 64), splits), s);
  else
    e = launch_tc<bf16, 2, 2, true>(
        maps, x, res, scale, shift, p, g, relu, chunk,
        dim3(tiles, blocks_for(co, 256), splits), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (splits > 1) {
    const long long total = static_cast<long long>(k) * k * ci * co;
    reduce_splits<<<blocks_for(total, 256), 256, 0, s>>>(
        p, splits, total, static_cast<float*>(dw));
  }
  return static_cast<int>(cudaGetLastError());
}
