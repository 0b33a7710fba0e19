// Ragged paged decode attention for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/paged_attention.py
// (`_kernel`, launched by `paged_decode_attention_pallas`).  One query
// token per decode slot attends over that slot's own ragged-length
// context, which lives in pages of the shared pool
// [n_pages, page_size, H, D] and is addressed through the slot's row of
// the page table [S, P].
//
// Bound: device-memory bytes.  Per call the work reads each slot's
// valid K and V rows once: sum_s len_s * H * D * 4 B * 2, plus q, the
// output, the tables and the lengths.  The work is 4 flops per pair of
// K/V elements read (half a flop per byte), far below the card's
// compute/bandwidth ratio, so the levers are reading each K/V byte once,
// keeping enough bytes in flight on every SM, and spreading a slot's
// context over the card however few slots are long.
//
// Design (split-K, "flash-decoding"):
//  - one block per (slot, split, head chunk): a split is `span` positions
//    of one slot's context, a head chunk the heads whose rows a block
//    takes together (all H where H x D <= 1024 floats and full slots give
//    every SM a block; fewer, down to 512-byte rows, where they do not).
//    The partition comes from static shapes only (ops/paged_attention.py
//    `_partition`): the wrapper reads neither lengths nor tables.  A
//    block whose split starts past its slot's length exits at once, so a
//    few long slots among idle ones still spread over the card;
//  - one producer warp reads each page id of its split from the table
//    once (the counterpart of the TPU kernel's scalar-prefetched table)
//    and copies K and V with 1-D bulk copies (cp.async.bulk, completing
//    on an mbarrier, L2 evict-first) into a ring of kStages stages of up
//    to 32 KB.  The rows of [t0, t0 + c) of one page across all heads are
//    one contiguous span of the pool, so such a stage is one copy each
//    for K and V per page it touches; a head chunk's rows are one copy a
//    position, issued by the warp's lanes together;
//  - eight consumer warps compute from shared memory on the SIMT units in
//    f32: D/4 lanes own a position at a time (a float4 of K and of V
//    each), four positions per step with their dot products reduced by
//    shuffles together, an online softmax per (head, lane group) in
//    registers;
//  - at the split's end the lane groups of each head combine in order.  A
//    slot with one split writes its output; otherwise the block writes
//    its partial (m, l, acc[D]) per head into the workspace, fences, and
//    adds one to the (slot, head chunk)'s arrival counter; the block that
//    completes it sets the counter back to 0 and merges the partials in
//    split order.  No float atomics: a launch repeats its bits;
//  - a slot of length 0 gets zeros, as from the TPU kernel.
// The kernel allocates nothing and launches on the caller's stream; the
// workspace (partials, and counters that are zero between launches)
// comes from the wrapper.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kProducerWarp = kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kStages = 3;
constexpr int kStageBytes = 32768;  // K and V of one stage, at most
constexpr int kStageFloats = kStageBytes / 4;
constexpr int kRowFloats = 1024;             // heads x D of a chunk, at most
constexpr int kScratchFloats = 6 * kConsumers;  // 256 float4 + 2 x 256
constexpr int kSmemBytes =
    kStages * kStageBytes + kScratchFloats * 4 + 2 * kStages * 8 + 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;

struct Geo {
  int slots, heads, head_dim, n_pages, page_size, pages_per_seq;
  int hc;       // heads of a head chunk
  int n_hc;     // head chunks
  int tc;       // positions of a ring stage
  int span;     // positions of a split
  int n_split;  // splits of the longest context
  float scale;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ float4 f4(float v) {
  return make_float4(v, v, v, v);
}
__device__ __forceinline__ float4 axpby(float4 x, float a, float4 y,
                                        float b) {
  return make_float4(x.x * a + y.x * b, x.y * a + y.y * b,
                     x.z * a + y.z * b, x.w * a + y.w * b);
}

// Page ids [wb, wb + 32) of a slot's table row, one a lane, clamped into
// the pool (lanes past `last` hold 0).
__device__ __forceinline__ int page_ids(const int* trow, int wb, int last,
                                        int lane, int n_pages) {
  const int i = wb + lane;
  return i <= last ? min(max(__ldg(trow + i), 0), n_pages - 1) : 0;
}

// The producer warp: lane 0 waits for a free stage and sets its bytes;
// the copies of positions [t0, t1) go out stage by stage.  Every lane
// keeps one page id of a window of 32 pages.
__device__ void produce(const float* kp, const float* vp, const int* trow,
                        const Geo& g, int hk, int rp, int t0, int t1,
                        float* ring, uint64_t* full, uint64_t* empty,
                        int lane) {
  const size_t row = static_cast<size_t>(g.heads) * g.head_dim;
  const size_t col = static_cast<size_t>(hk) * g.hc * g.head_dim;
  const int vofs = g.tc * g.hc * g.head_dim;
  const uint32_t rbytes = rp * 4;
  const bool whole = rp == g.heads * g.head_dim;  // a position: one span
  const uint64_t policy = l2_evict_first();
  const int last = (t1 - 1) / g.page_size;
  int wb = t0 / g.page_size;
  int pid = page_ids(trow, wb, last, lane, g.n_pages);
  int stage = 0;
  uint32_t phase = 0;
  for (int s0 = t0; s0 < t1; s0 += g.tc) {
    const int s1 = min(s0 + g.tc, t1);
    if (lane == 0) {
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_expect_tx(&full[stage], 2u * (s1 - s0) * rbytes);
    }
    __syncwarp();
    float* ks = ring + stage * kStageFloats;
    float* vs = ks + vofs;
    for (int t = s0; t < s1;) {
      const int pg = t / g.page_size;
      if (pg - wb >= 32) {
        wb = pg;
        pid = page_ids(trow, wb, last, lane, g.n_pages);
      }
      const int page = __shfl_sync(kFull, pid, pg - wb);
      const int n = min(s1, (pg + 1) * g.page_size) - t;
      const size_t src =
          (static_cast<size_t>(page) * g.page_size + (t - pg * g.page_size)) *
              row + col;
      const int dst = (t - s0) * rp;
      uint64_t* bar = &full[stage];
      if (whole) {
        if (lane == 0) {
          bulk_load(ks + dst, kp + src, n * rbytes, bar, policy);
          bulk_load(vs + dst, vp + src, n * rbytes, bar, policy);
        }
      } else {
        // one copy a position's row: the lanes issue them together
        for (int r = lane; r < n; r += 32) {
          bulk_load(ks + dst + r * rp, kp + src + r * row, rbytes, bar,
                    policy);
          bulk_load(vs + dst + r * rp, vp + src + r * row, rbytes, bar,
                    policy);
        }
      }
      t += n;
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// Merge the partials of (slot s, head chunk hk) over its nsp splits:
// thread (r, head, float4) takes splits [r n / R, (r+1) n / R) in order,
// then the R ranges are combined in order.
__device__ void merge(const Geo& g, int s, int hk, int nsp,
                      const float* pacc, const float* pm, const float* pl,
                      float* out, float* scr, int tid) {
  const int L = g.head_dim / 4;
  const int pairs = g.hc * L;
  const int R = kConsumers / pairs;
  const int r = tid / pairs, pr = tid - r * pairs;
  const int hh = pr / L, prt = pr - hh * L;
  const int hcnt = min(g.hc, g.heads - hk * g.hc);
  const bool act = r < R && hh < hcnt;
  const int head = hk * g.hc + hh;
  float m = kNeg, l = 0.f;
  float4 acc = f4(0.f);
  if (act) {
    const int lo = r * nsp / R, hi = (r + 1) * nsp / R;
    const size_t base = static_cast<size_t>(s) * g.n_split * g.heads + head;
    for (int i = lo; i < hi; i += 4) {
      float mi[4], li[4];
      float4 ai[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mi[u] = kNeg;
        li[u] = 0.f;
        ai[u] = f4(0.f);
        if (i + u < hi) {
          const size_t x = base + static_cast<size_t>(i + u) * g.heads;
          mi[u] = __ldcg(pm + x);
          li[u] = __ldcg(pl + x);
          ai[u] = __ldcg(reinterpret_cast<const float4*>(
              pacc + x * g.head_dim) + prt);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i + u < hi) {
          const float mn = fmaxf(m, mi[u]);
          const float a = expf(m - mn), b = expf(mi[u] - mn);
          l = l * a + li[u] * b;
          acc = axpby(acc, a, ai[u], b);
          m = mn;
        }
      }
    }
  }
  float4* sa = reinterpret_cast<float4*>(scr);
  float* sm = scr + 4 * kConsumers;
  float* sl = sm + kConsumers;
  sa[tid] = acc;
  sm[tid] = m;
  sl[tid] = l;
  consumers_sync();
  if (r == 0 && act) {
    float M = kNeg;
    for (int q = 0; q < R; ++q) M = fmaxf(M, sm[q * pairs + pr]);
    float Ls = 0.f;
    float4 o = f4(0.f);
    for (int q = 0; q < R; ++q) {
      const float e = expf(sm[q * pairs + pr] - M);
      Ls += sl[q * pairs + pr] * e;
      o = axpby(o, 1.f, sa[q * pairs + pr], e);
    }
    const float inv = 1.f / Ls;
    reinterpret_cast<float4*>(
        out + (static_cast<size_t>(s) * g.heads + head) * g.head_dim)[prt] =
        make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
  }
}

// The eight consumer warps: lane group (head h, sub-index j) of D/4
// lanes takes positions j, j + gph, ... of every stage of [t0, t1).
__device__ void consume(const float* q, float* out, float* ws, int* counters,
                        const Geo& g, int s, int k, int hk, int hcnt, int rp,
                        int t0, int t1, int nsp, const float* ring,
                        uint64_t* full, uint64_t* empty, float* scr,
                        int* last, int tid) {
  const int D = g.head_dim, L = D / 4;
  const int lane = tid & 31;
  const int grp = tid / L, part = tid - grp * L;
  const int gph = (kConsumers / L) / g.hc;  // lane groups a head
  const int h = grp % g.hc, j = grp / g.hc;
  const int vofs = g.tc * g.hc * D;
  const bool act = j < gph && h < hcnt;
  float4 qs = f4(0.f);
  if (act) {
    const float4 qv = __ldg(reinterpret_cast<const float4*>(
        q + (static_cast<size_t>(s) * g.heads + hk * g.hc + h) * D) + part);
    qs = make_float4(qv.x * g.scale, qv.y * g.scale, qv.z * g.scale,
                     qv.w * g.scale);
  }
  float m = kNeg, l = 0.f;
  float4 acc = f4(0.f);
  int stage = 0;
  uint32_t phase = 0;
  for (int s0 = t0; s0 < t1; s0 += g.tc) {
    const int nt = min(g.tc, t1 - s0);
    mbar_wait(&full[stage], phase);
    const float* ks = ring + stage * kStageFloats + h * D + part * 4;
    const float* vs = ks + vofs;
    // warp-uniform trip count: the full-mask shuffles never diverge
    for (int tb = 0; tb < nt; tb += 4 * gph) {
      float sc[4];
      float4 vv[4];
      bool ok[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int tt = tb + j + u * gph;
        ok[u] = act && tt < nt;
        float4 kk = f4(0.f);
        vv[u] = kk;
        if (ok[u]) {
          kk = *reinterpret_cast<const float4*>(ks + tt * rp);
          vv[u] = *reinterpret_cast<const float4*>(vs + tt * rp);
        }
        sc[u] = qs.x * kk.x + qs.y * kk.y + qs.z * kk.z + qs.w * kk.w;
      }
      for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          sc[u] += __shfl_xor_sync(kFull, sc[u], off);
      }
      float mx = m;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (ok[u]) mx = fmaxf(mx, sc[u]);
      const float alpha = expf(m - mx);
      l *= alpha;
      acc = make_float4(acc.x * alpha, acc.y * alpha, acc.z * alpha,
                        acc.w * alpha);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (ok[u]) {
          const float p = expf(sc[u] - mx);
          l += p;
          acc = axpby(acc, 1.f, vv[u], p);
        }
      }
      m = mx;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // the lane groups of each head combine, j in order
  float* sa = scr;  // [groups][D]
  float* sm = scr + 4 * kConsumers;
  float* sl = sm + kConsumers;
  reinterpret_cast<float4*>(sa)[tid] = acc;
  if (part == 0) {
    sm[grp] = m;
    sl[grp] = l;
  }
  consumers_sync();
  const size_t n_part = static_cast<size_t>(g.slots) * g.n_split * g.heads;
  float* pacc = ws;
  float* pm = ws + n_part * D;
  float* pl = pm + n_part;
  for (int i = tid; i < rp; i += kConsumers) {
    const int hh = i / D, d = i - hh * D;
    float M = kNeg;
    for (int q = 0; q < gph; ++q) M = fmaxf(M, sm[q * g.hc + hh]);
    float Ls = 0.f, o = 0.f;
    for (int q = 0; q < gph; ++q) {
      const int x = q * g.hc + hh;
      const float e = expf(sm[x] - M);
      Ls += sl[x] * e;
      o += sa[x * D + d] * e;
    }
    const int head = hk * g.hc + hh;
    if (nsp == 1) {
      out[(static_cast<size_t>(s) * g.heads + head) * D + d] = o / Ls;
    } else {
      const size_t x = (static_cast<size_t>(s) * g.n_split + k) * g.heads +
                       head;
      pacc[x * D + d] = o;
      if (d == 0) {
        pm[x] = M;
        pl[x] = Ls;
      }
    }
  }
  if (nsp == 1) return;
  // partials written and fenced, then the arrival; the block that
  // completes the (slot, head chunk) merges
  __threadfence();
  consumers_sync();
  if (tid == 0) {
    int* c = counters + static_cast<size_t>(s) * g.n_hc + hk;
    const bool done = atomicAdd(c, 1) == nsp - 1;
    if (done) *c = 0;  // every split has arrived: ready for the next launch
    *last = done;
  }
  consumers_sync();
  if (*last) {
    __threadfence();
    merge(g, s, hk, nsp, pacc, pm, pl, out, scr, tid);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
paged_decode_attention_f32_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k_pages,
                                  const float* __restrict__ v_pages,
                                  const int* __restrict__ tables,
                                  const int* __restrict__ lengths,
                                  float* __restrict__ out,
                                  float* __restrict__ ws,
                                  int* __restrict__ counters, Geo g) {
  const int s = blockIdx.x, k = blockIdx.y, hk = blockIdx.z;
  const int tid = threadIdx.x;
  const int ctx = g.pages_per_seq * g.page_size;
  const int len = max(0, min(__ldg(lengths + s), ctx));
  const int t0 = k * g.span;
  const int hcnt = min(g.hc, g.heads - hk * g.hc);
  const int rp = hcnt * g.head_dim;
  if (t0 >= len) {
    if (k == 0) {  // length 0: zeros, as from the TPU kernel
      float* o = out + (static_cast<size_t>(s) * g.heads + hk * g.hc) *
                           g.head_dim;
      for (int i = tid; i < rp; i += kThreads) o[i] = 0.f;
    }
    return;
  }
  const int t1 = min(t0 + g.span, len);
  const int nsp = (len + g.span - 1) / g.span;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* scr = ring + kStages * kStageFloats;
  uint64_t* full = reinterpret_cast<uint64_t*>(scr + kScratchFloats);
  uint64_t* empty = full + kStages;
  int* last = reinterpret_cast<int*>(empty + kStages);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (tid / 32 == kProducerWarp) {
    produce(k_pages, v_pages,
            tables + static_cast<size_t>(s) * g.pages_per_seq, g, hk, rp, t0,
            t1, ring, full, empty, tid & 31);
    return;
  }
  consume(q, out, ws, counters, g, s, k, hk, hcnt, rp, t0, t1, nsp, ring,
          full, empty, scr, last, tid);
}

// Devices whose kernel is opted in to its dynamic shared memory.
std::atomic<bool> g_opted_in[64];

}  // namespace

// The constant arguments of one launch plan, as ops/paged_attention.py's
// `_Call` lays them out: shapes, the partition (`_partition`), scale.
struct PagedCall {
  int slots, heads, head_dim, n_pages, page_size, pages_per_seq;
  int heads_per_chunk, stage_positions, span, n_split;
  float scale;
};

// Launches grid (slots, splits, head chunks).  Returns cudaGetLastError()
// after the launch (0 on success); cudaErrorInvalidValue for arguments
// the kernel does not take.  `ws` holds slots x n_split x heads x
// (head_dim + 2) floats of partials (none where n_split is 1) and
// `counters` slots x head chunks ints, zero between launches.
extern "C" int paged_decode_attention_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* tables, const int* lengths, float* out, float* ws,
    int* counters, const PagedCall* call, void* stream) {
  const PagedCall& c = *call;
  const int lanes = c.head_dim / 4;
  const long long ctx = static_cast<long long>(c.pages_per_seq) * c.page_size;
  const int hc = c.heads_per_chunk, tc = c.stage_positions;
  if (c.head_dim % 4 != 0 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || c.slots < 1 || c.heads < 1 ||
      c.n_pages < 1 || c.page_size < 1 || c.pages_per_seq < 1 ||
      ctx > (1 << 30) || hc < 1 || hc > c.heads ||
      hc * c.head_dim > kRowFloats || tc < 1 ||
      2LL * tc * hc * c.head_dim * 4 > kStageBytes || c.span < tc ||
      c.span % tc != 0 || c.n_split < 1 || c.n_split > 65535 ||
      static_cast<long long>(c.n_split) * c.span < ctx ||
      (c.heads + hc - 1) / hc > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto kernel = paged_decode_attention_f32_kernel;
  if (!g_opted_in[dev & 63].load()) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_opted_in[dev & 63].store(true);
  }
  const Geo g{c.slots, c.heads, c.head_dim, c.n_pages, c.page_size,
              c.pages_per_seq, hc, (c.heads + hc - 1) / hc, tc, c.span,
              c.n_split, c.scale};
  const dim3 grid(c.slots, c.n_split, g.n_hc);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      q, k_pages, v_pages, tables, lengths, out, ws, counters, g);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's dynamic shared memory in bytes.
extern "C" int paged_decode_attention_smem_bytes() { return kSmemBytes; }
