// Per-edge dot products (SDDMM) for Hopper (sm_90a): kernel #17's
// redesign, the edge scores one dst block at a time.
//
// Replaces _sddmm_kernel of ggnn_tpu/ops/spmm_pallas.py (run by
// sddmm_pallas) for the indexed form with G a multiple of 4 and G <= 128:
//     out[e] = ⟨p[src_e], q[dst_e]⟩ · mask[e]      (f32, [E])
// with mask 1 where none is given.  sddmm.cu keeps the pre-gathered form
// and the other widths.
//
// Bound on this card: HBM bytes.  The function reads p and q once (2 × 134
// MB at 262,144 nodes, G = 128), the index arrays and the mask, and writes
// E floats: ≈ 0.11 ms at 3.35 TB/s for E = 8M.  What it has to gather is
// larger: every edge's p row (8M × 512 B = 4.1 GB) and its q row.  The
// first body read both rows per edge in the layout's (type, dst, src)
// order: all of q once per type run, p at random (134 MB against 50 MB of
// L2).
//
// Design.  A plan made once per pair of index arrays on the device
// (ops/spmm.py::sddmm_plan) lists the edge ids grouped by (src slab, dst
// block of 128 rows), slab-major (one stable sort), and cuts each key's
// run into work items of at most K edges; an empty key makes no item.  A
// slab is about 32 MB of p rows (65,536 at G = 128), so the CTAs at work,
// which all take items of one slab, find its p rows in L2.  One CTA a work
// item: it stages its block's q rows (128 × G f32, 64 KB at G = 128) in
// shared memory by cp.async, once: q leaves L2 once per slab and block.
// Each warp walks a contiguous share of the item's edges in batches of 32.
// Each lane loads its 16 bytes of a p row straight into registers,
// kRegRing − 1 rows ahead, takes the elements 4l .. 4l + 3 of the p and q
// rows and adds their products in that order (explicit fmas), keeping its
// partial of every edge of the batch.  Five rounds of xor shuffles
// (fold<16> … fold<1>: 16 values, then 8, 4, 2, 1) then leave lane j with
// the sum of edge j, each edge's 32 partials added in the xor butterfly's
// tree (lanes 16 apart, then 8, ...), as sddmm.cu adds them: 31 shuffles
// for 32 edges, each score one edge's own sum, the same bits on every run,
// under every plan and as the first body.  The edge ids of the next batch
// and their src, dst and mask are loaded a batch ahead; lane j stores its
// sum at edge j's id.  No float atomics, no split sums.
#include <stdint.h>

#include <cuda_runtime.h>

#include "common.cuh"
#include "mma_pipe.cuh"

namespace ggnn {
namespace sdb {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockRows = 128;  // dst rows a plan block holds

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kRegRing = 16;
static_assert(32 % kRegRing == 0, "a ring slot is the same in every batch");

// One round of the batch sum: part[0 .. 2·OFF) holds the lane's partials of
// 2·OFF edges; lane l keeps the half whose index bit OFF is its own lane
// bit OFF, sends the other half to lane l ^ OFF and adds what it receives.
template <int OFF>
__device__ __forceinline__ void fold(float (&part)[32], int lane) {
  const bool hi = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = hi ? part[i] : part[i + OFF];
    const float keep = hi ? part[i + OFF] : part[i];
    part[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Work item blockIdx.x of the plan: key = the plan's (slab, block) key
// (its q block is key % n_qblk), edges order[e0 .. e1).
__global__ void __launch_bounds__(kThreads, 2) sddmm_blocked_kernel(
    const float* __restrict__ p, long long n_p, const float* __restrict__ q,
    long long n_q, int G, const int* __restrict__ src,
    const int* __restrict__ dst, const float* __restrict__ mask,
    const int* __restrict__ order, const int* __restrict__ item_first,
    const int* __restrict__ key_start, int n_keys, int n_qblk, int K,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int item = blockIdx.x;
  if (item >= item_first[n_keys]) return;  // past the plan: the whole CTA
  const int key = item_block(item_first, n_keys, item);
  const long long r0 = (long long)(key % n_qblk) * kBlockRows;
  const int e0 = key_start[key] + (item - item_first[key]) * K;
  const int e1 = min(e0 + K, key_start[key + 1]);
  float* q_s = reinterpret_cast<float*>(smem);          // [128][G]
  const int vec = G >> 2;                               // float4s a row
  {  // the block's q rows lie one after another: one linear copy
    const int n4 = int(min((long long)kBlockRows, n_q - r0)) * vec;
    const float* qb = q + r0 * G;
    for (int i = threadIdx.x; i < n4; i += kThreads)
      pipe::cp_async16(q_s + 4 * i, qb + 4 * i);
    pipe::cp_async_commit();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = e1 - e0;
  const int w0 = e0 + int((long long)n * warp / kWarps);
  const int w1 = e0 + int((long long)n * (warp + 1) / kWarps);
  const int nw = w1 - w0;
  const bool mine = lane < vec;  // the lanes that hold row elements

  // batch b: lane j holds edge w0 + 32b + j (id −1 past the share)
  auto edge_id = [&](int b) {
    const int j = w0 + 32 * b + lane;
    return j < w1 ? __ldg(order + j) : -1;
  };
  int c_id = edge_id(0), c_u = -1, c_v = 0;
  float c_m = 0.0f;
  if (c_id >= 0) {
    c_u = __ldg(src + c_id);
    c_v = __ldg(dst + c_id);
    c_m = mask ? __ldg(mask + c_id) : 1.0f;
  }
  int n_id = edge_id(1), n_u = -1, n_v = 0;
  float n_m = 0.0f;
  if (n_id >= 0) {
    n_u = __ldg(src + n_id);
    n_v = __ldg(dst + n_id);
    n_m = mask ? __ldg(mask + n_id) : 1.0f;
  }
  int f_id = edge_id(2);

  // this lane's 16 bytes of the p row of the share's edge k (0 past it)
  auto row = [&](int k, int u) {
    if (k < nw && mine && u >= 0 && u < n_p)
      return __ldg(reinterpret_cast<const float4*>(p + (long long)u * G) +
                   lane);
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  float4 pr[kRegRing];
#pragma unroll
  for (int k = 0; k < kRegRing - 1; ++k)
    pr[k] = row(k, __shfl_sync(0xffffffffu, c_u, k));
  cp_wait<0>();     // this thread's q copies
  __syncthreads();  // everyone's

  for (int jb = 0; jb < nw; jb += 32) {
    if (jb > 0) {  // the next batch becomes the current one
      c_id = n_id;
      c_u = n_u;
      c_v = n_v;
      c_m = n_m;
      n_id = f_id;
      n_u = -1;
      if (n_id >= 0) {
        n_u = __ldg(src + n_id);
        n_v = __ldg(dst + n_id);
        n_m = mask ? __ldg(mask + n_id) : 1.0f;
      }
      f_id = edge_id((jb >> 5) + 2);
    }
    float part[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int k = e + kRegRing - 1;  // the row into the slot e − 1 left
      pr[k % kRegRing] = row(
          jb + k, __shfl_sync(0xffffffffu, k < 32 ? c_u : n_u, k & 31));
      float s = 0.0f;
      if (jb + e < nw) {
        const int v = __shfl_sync(0xffffffffu, c_v, e);
        if (mine) {
          const float4 a = pr[e % kRegRing];
          const float4 c = *reinterpret_cast<const float4*>(
              q_s + (long long)(v - r0) * G + 4 * lane);
          s = __fmaf_rn(a.x, c.x, s);
          s = __fmaf_rn(a.y, c.y, s);
          s = __fmaf_rn(a.z, c.z, s);
          s = __fmaf_rn(a.w, c.w, s);
        }
      }
      part[e] = s;
    }
    fold<16>(part, lane);
    fold<8>(part, lane);
    fold<4>(part, lane);
    fold<2>(part, lane);
    fold<1>(part, lane);
    if (c_id >= 0) out[c_id] = mask ? part[0] * c_m : part[0];
  }
}

}  // namespace sdb
}  // namespace ggnn

// The indexed form at G % 4 == 0, 4 <= G <= 128.  p f32 [n_p, G], q f32
// [n_q, G] (16-byte aligned); src, dst int32 [E]; mask f32 [E] or null
// (1); the plan (ops/spmm.py::sddmm_plan): order int32 [E] (the edge ids
// grouped by key), key_start int32 [n_keys + 1], item_first int32 [n_keys
// + 1] (key k's work items of at most K edges), key % n_qblk the q block of
// key k; `grid` CTAs, at least the plan's items (the others return at
// once); out f32 [E].  Returns the cudaError_t of the launch.
extern "C" int ggnn_sddmm_blocked(const void* p, long long n_p, const void* q,
                                  long long n_q, int G, const void* src,
                                  const void* dst, const void* mask,
                                  long long E, const void* order,
                                  const void* item_first,
                                  const void* key_start, int n_keys,
                                  int n_qblk, int K, long long grid, void* out,
                                  void* stream) {
  namespace sdb = ggnn::sdb;
  if (E <= 0 || grid <= 0) return 0;
  if (G < 4 || G > 128 || G % 4 || K < 1 || n_keys < 1 || n_qblk < 1 ||
      grid > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  const int smem = sdb::kBlockRows * G * int(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      sdb::sddmm_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  sdb::sddmm_blocked_kernel<<<unsigned(grid), sdb::kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), n_p, static_cast<const float*>(q), n_q, G,
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const float*>(mask), static_cast<const int*>(order),
      static_cast<const int*>(item_first), static_cast<const int*>(key_start),
      n_keys, n_qblk, K, static_cast<float*>(out));
  return int(cudaGetLastError());
}
