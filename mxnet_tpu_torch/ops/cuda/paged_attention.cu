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
// compute/bandwidth ratio, so the only lever is reading each K/V byte
// once, with wide coalesced loads.
//
// Design:
//  - one thread block per (slot, head); the block reads its own page ids
//    from the table inside its loop over positions (this takes the place
//    of the TPU kernel's scalar-prefetched page table);
//  - the block's warps split the positions of the context.  D/4 lanes
//    ("a group") own one position at a time: each lane loads one float4
//    of the K row and of the V row (16-byte loads, a whole 256-byte row
//    per group for D = 64), the dot product is a butterfly shuffle inside
//    the group, and each group keeps its own online softmax (m, l and its
//    float4 slice of the accumulator) in f32 registers;
//  - positions past the slot's length are never read, so a short slot
//    costs only its own pages;
//  - the groups combine through shared memory at the end; a slot of
//    length 0 writes zeros, as the TPU kernel does.
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;

__global__ void __launch_bounds__(kThreads)
paged_decode_attention_f32_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k_pages,
                                  const float* __restrict__ v_pages,
                                  const int* __restrict__ tables,
                                  const int* __restrict__ lengths,
                                  float* __restrict__ out,
                                  int heads, int head_dim, int n_pages,
                                  int page_size, int pages_per_seq,
                                  float scale) {
  extern __shared__ float smem[];
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int lanes = head_dim / 4;            // lanes per position, 2^k <= 32
  const int per_warp = 32 / lanes;           // positions a warp holds at once
  const int n_groups = kWarps * per_warp;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / lanes;
  const int part = lane % lanes;             // this lane's float4 of D
  const int group = warp * per_warp + sub;

  int length = lengths[s];
  length = max(0, min(length, pages_per_seq * page_size));

  const float4 qv = reinterpret_cast<const float4*>(
      q + (static_cast<size_t>(s) * heads + h) * head_dim)[part];
  const float4 qs = make_float4(qv.x * scale, qv.y * scale, qv.z * scale,
                                qv.w * scale);
  const size_t row = static_cast<size_t>(heads) * head_dim;
  const int* table = tables + static_cast<size_t>(s) * pages_per_seq;

  float m = kNeg;
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // warp-uniform trip count: every lane of a warp takes the same number
  // of iterations, so the full-mask shuffles below never diverge
  for (int t0 = warp * per_warp; t0 < length; t0 += n_groups) {
    const int t = t0 + sub;
    const bool valid = t < length;
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 vv = kv;
    if (valid) {
      int page = table[t / page_size];
      page = min(max(page, 0), n_pages - 1);
      const size_t base =
          (static_cast<size_t>(page) * page_size + t % page_size) * row +
          static_cast<size_t>(h) * head_dim;
      kv = reinterpret_cast<const float4*>(k_pages + base)[part];
      vv = reinterpret_cast<const float4*>(v_pages + base)[part];
    }
    float dot = qs.x * kv.x + qs.y * kv.y + qs.z * kv.z + qs.w * kv.w;
    for (int off = lanes >> 1; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (valid) {
      const float m_new = fmaxf(m, dot);
      const float alpha = expf(m - m_new);
      const float p = expf(dot - m_new);
      l = l * alpha + p;
      acc.x = acc.x * alpha + p * vv.x;
      acc.y = acc.y * alpha + p * vv.y;
      acc.z = acc.z * alpha + p * vv.z;
      acc.w = acc.w * alpha + p * vv.w;
      m = m_new;
    }
  }

  // combine the groups: smem = [n_groups][head_dim] accumulators, then
  // n_groups maxima, then n_groups sums
  float* s_acc = smem;
  float* s_m = smem + n_groups * head_dim;
  float* s_l = s_m + n_groups;
  reinterpret_cast<float4*>(s_acc + group * head_dim)[part] = acc;
  if (part == 0) {
    s_m[group] = m;
    s_l[group] = l;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < head_dim; d += kThreads) {
    float m_all = kNeg;
    for (int g = 0; g < n_groups; ++g) m_all = fmaxf(m_all, s_m[g]);
    float l_all = 0.f;
    float o = 0.f;
    for (int g = 0; g < n_groups; ++g) {
      const float w = expf(s_m[g] - m_all);
      l_all += s_l[g] * w;
      o += s_acc[g * head_dim + d] * w;
    }
    // length 0: no group ran a position, o is 0 and so is the output
    const float norm = l_all > 0.f ? l_all : 1.f;
    out[(static_cast<size_t>(s) * heads + h) * head_dim + d] = o / norm;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success);
// cudaErrorInvalidValue for a head_dim the kernel does not take.
extern "C" int paged_decode_attention_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* tables, const int* lengths, float* out, int slots, int heads,
    int head_dim, int n_pages, int page_size, int pages_per_seq, float scale,
    void* stream) {
  const int lanes = head_dim / 4;
  if (head_dim % 4 != 0 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || slots < 1 || heads < 1 ||
      n_pages < 1 || page_size < 1 || pages_per_seq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_groups = kWarps * (32 / lanes);
  const size_t smem = sizeof(float) * n_groups * (head_dim + 2);
  dim3 grid(slots, heads);
  paged_decode_attention_f32_kernel<<<grid, kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      q, k_pages, v_pages, tables, lengths, out, heads, head_dim, n_pages,
      page_size, pages_per_seq, scale);
  return static_cast<int>(cudaGetLastError());
}
