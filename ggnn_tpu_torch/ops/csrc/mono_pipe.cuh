// The bf16 tensor-core pipeline of #11 window_block_spmm_mono and #8
// onehot_segment_scatter_flat for Hopper (sm_90a) at D = 128, in all three
// side-stream forms: the dst-local ids, the int8 counts and the int8
// one-hot (which is the count form: #8's product, as the TPU kernel and
// its plain version compute it, with no decode).
//
// One 128-row output block's sums are Σ_t C_t · table[win_t·stride + k],
// k over the window.  The host (ops/window.py::mono_plan, once per layout)
// cuts every tile's window into 16-row k-groups and keeps only the groups
// that add something, each a *unit* {first table row, the group's offset
// in the stream}:
// - dst-local ids: a group some id of which lies in [0, 128);
// - counts / one-hot: a group whose [128 × 16] bytes are not all 0 (a
//   per-stream mask built once on the device).
// Dummy tiles (win < 0), all-padding tiles and groups that no id names
// make no unit: their rows and bytes are never read.  A block's real
// tiles are cut into work items of at most kSplit tiles (a hub row is
// never one accumulator's alone); a work item's units are contiguous.
//
// The pipeline: one CTA a work item, its units in stages of kUnits (a unit
// a warp), a ring of STAGES stages with the next stages' copies in flight
// during the current one's products.  Warp w copies unit w of a stage: its
// 16 table rows (B, 4 KB) by cp.async into a swizzled [16][128] bf16 tile
// (16-byte chunk c of row k at chunk c ^ (k & 7): ldmatrix.trans reads 8
// rows of one chunk without a bank conflict), stored at rows permuted
// within the group (wpipe::perm_bf16), and its A operand beside them: the
// 16 ids (64 B), or the [128][16] count bytes (2 KB); the warp's descriptor
// of its unit of the next stage is loaded a stage ahead.  A is made in
// registers:
// - ids: a lane's k-slots (2q, 2q + 1, 2q + 8, 2q + 9) hold the window
//   rows 4q, 4q + 2, 4q + 1, 4q + 3 (the permutation), so one 16-byte load
//   of ids 4q .. 4q + 3 gives its four 0/1 pairs by comparing with its rows
//   (as typed_pipe.cuh::onehot_mma);
// - counts: ldmatrix gives a lane 4 consecutive bytes k = 4q .. 4q + 3 of
//   its row; wpipe::s8x4_to_bf16 turns them into the pairs (4q, 4q + 2)
//   and (4q + 1, 4q + 3), exact (every int8 is exact in bf16), which the
//   same permutation puts in the mma's k order (window_pipe.cuh, #13).
// 8 warps tile the 128 × 128 f32 accumulator as 4 × 2 tiles of 32 × 64
// (wpipe::Tile<8>), kept in registers across the item's units; at the end
// the item rounds it once to the output type (a block of one item) or
// stores an f32 partial, which partial_sum.cuh sums in item order over many
// CTAs.  Blocks without a unit are zeroed.  No float atomics: the same
// bits on every run.
#pragma once

#include "partial_sum.cuh"
#include "window_pipe.cuh"

namespace ggnn {
namespace mpipe {

using wpipe::bf16;
using wpipe::cp16;
using TA = wpipe::Tile<8>;
using Acc = float[2][8][4];
constexpr int kThreads = 256;
constexpr int kUnits = kThreads / 32;            // a stage: a unit a warp
constexpr int kBBytes = kUnits * 16 * 128 * 2;   // 32 KB of table rows

// One stage: the units' table rows, then their A data (ids or bytes).
template <bool IDS>
struct Stage {
  static constexpr int a = IDS ? kUnits * 16 * 4 : kUnits * 128 * 16;
  static constexpr int bytes = kBBytes + a;
};

// Storage row, within its group, of the group's row r: the even rows
// first (wpipe::perm_bf16 on 16 rows).
__device__ __forceinline__ int perm16(int r) {
  return ((r & 1) << 3) | (r >> 1);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The calling warp's copies of its unit u into slot w of a stage: table
// [n_table, 128] bf16, c_stream the ids [*, window] int32 or bytes
// [*·128, window] int8; u = {row, v}: table rows [row, row + 16), and the
// group's 16 ids, or the first 16 bytes of its 128 count rows (window
// bytes apart), from byte 16·v of the stream.  Rows outside [0, n_table)
// read 0.
template <bool IDS>
__device__ __forceinline__ void fetch_unit(unsigned char* st, int w, int2 u,
                                           const bf16* __restrict__ table,
                                           long long n_table,
                                           const void* __restrict__ c_stream,
                                           int window) {
  const int lane = threadIdx.x & 31;
  bf16* Bs = reinterpret_cast<bf16*>(st);
  unsigned char* As = st + kBBytes;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = i * 32 + lane, r = idx >> 4, ch = idx & 15;
    const long long row = (long long)u.x + r;
    const bool ok = row >= 0 && row < n_table;
    const int k = w * 16 + perm16(r);
    cp16(Bs + k * 128 + ((ch ^ (k & 7)) << 3),
         table + (ok ? row : 0) * 128 + ch * 8, ok);
  }
  const int8_t* src = static_cast<const int8_t*>(c_stream) + 16ll * u.y;
  if constexpr (IDS) {
    if (lane < 4) cp16(As + (w * 16 + 4 * lane) * 4, src + 16 * lane, true);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i * 32 + lane;
      cp16(As + (w * 128 + r) * 16, src + (long long)r * window, true);
    }
  }
}

// acc += the products of a stage's units [0, nu).
template <bool IDS>
__device__ __forceinline__ void stage_mma(Acc& acc, const unsigned char* st,
                                          int nu) {
  const int lane = threadIdx.x & 31;
  const bf16* Bs = reinterpret_cast<const bf16*>(st);
  const unsigned char* As = st + kBBytes;
  for (int i = 0; i < nu; ++i) {
    uint32_t a[2][4];
    if constexpr (IDS) {
      constexpr uint32_t kOne = 0x3F80u;  // bf16 1.0
      const int4 v = *reinterpret_cast<const int4*>(
          As + (i * 16 + 4 * (lane & 3)) * 4);
      const int r0 = TA::row0() + (lane >> 2);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int ra = r0 + 16 * mi, rb = ra + 8;
        a[mi][0] = (v.x == ra ? kOne : 0u) | (v.z == ra ? kOne << 16 : 0u);
        a[mi][1] = (v.x == rb ? kOne : 0u) | (v.z == rb ? kOne << 16 : 0u);
        a[mi][2] = (v.y == ra ? kOne : 0u) | (v.w == ra ? kOne << 16 : 0u);
        a[mi][3] = (v.y == rb ? kOne : 0u) | (v.w == rb ? kOne << 16 : 0u);
      }
    } else {
      uint32_t w[4];
      pipe::ldsm_x4(w, reinterpret_cast<const bf16*>(
                           As + (i * 128 + TA::row0() + lane) * 16));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        wpipe::s8x4_to_bf16(w[2 * mi], a[mi][0], a[mi][2]);
        wpipe::s8x4_to_bf16(w[2 * mi + 1], a[mi][1], a[mi][3]);
      }
    }
    const int kk = i * 16 + (lane & 15);
    const bf16* brow = Bs + kk * 128;
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int ch = (TA::col0() >> 3) + 2 * nj + (lane >> 4);
      uint32_t b[4];
      pipe::ldsm_x4_trans(b, brow + ((ch ^ (kk & 7)) << 3));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        pipe::mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
        pipe::mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// acc's fragments to rows [128][128] of dst, rounded to TO: f32 pairs
// straight from the fragments (whole 32-byte sectors); bf16 through shared
// memory (rows 272 bytes apart: a fragment store's 8 rows fall in 8 bank
// groups), then 16-byte stores of whole rows.  Every warp must be done with
// smem's stages (and every copy landed).
template <typename TO>
__device__ __forceinline__ void store_acc(const Acc& acc,
                                          TO* __restrict__ dst,
                                          unsigned char* smem) {
  constexpr bool kStaged = sizeof(TO) == 2;
  constexpr int ld = kStaged ? 136 : 128;  // a row of the pairs' target
  TO* S = kStaged ? reinterpret_cast<TO*>(smem) : dst;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        TO* p = S + TA::row(mi, e) * ld + TA::col(ni, e);
        if constexpr (sizeof(TO) == 4)
          *reinterpret_cast<float2*>(p) =
              make_float2(acc[mi][ni][e], acc[mi][ni][e + 1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(p) =
              __floats2bfloat162_rn(acc[mi][ni][e], acc[mi][ni][e + 1]);
      }
  if constexpr (kStaged) {
    __syncthreads();
    constexpr int kVec = 16 / sizeof(TO);  // elements a 16-byte store
    for (int i = threadIdx.x; i < 128 * 128 / kVec; i += kThreads) {
      const int r = i / (128 / kVec), c = i % (128 / kVec) * kVec;
      *reinterpret_cast<uint4*>(dst + r * 128 + c) =
          *reinterpret_cast<const uint4*>(S + r * ld + c);
    }
  }
}

// One CTA a work item: CTA b < n_work sums work item b (work[b] = {first
// unit, end unit, output block, partial slot or −1}) into its block or
// slot; CTA n_work + z zeroes block zero_blk[z].
template <bool IDS, typename TO, int STAGES>
__global__ void __launch_bounds__(kThreads, 2) mono_fused_kernel(
    const bf16* __restrict__ table, long long n_table,
    const void* __restrict__ c_stream, int window,
    const int2* __restrict__ units, const int4* __restrict__ work,
    int n_work, const int* __restrict__ zero_blk,
    float* __restrict__ ws, TO* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kStage = Stage<IDS>::bytes;
  if (int(blockIdx.x) >= n_work) {
    uint4* dst = reinterpret_cast<uint4*>(
        out + size_t(zero_blk[blockIdx.x - n_work]) * 128 * 128);
    for (int i = threadIdx.x; i < int(128 * 128 * sizeof(TO) / 16);
         i += kThreads)
      dst[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int w = threadIdx.x >> 5;
  const int4 wk = work[blockIdx.x];
  const int n_st = (wk.y - wk.x + kUnits - 1) / kUnits;
  // this warp's unit of the next stage to copy, loaded a stage ahead
  int ub = wk.x;
  int2 d = w < wk.y - ub ? units[ub + w] : make_int2(0, 0);
  auto fetch = [&](int s) {
    if (w < wk.y - ub)
      fetch_unit<IDS>(smem + (s % STAGES) * kStage, w, d, table, n_table,
                      c_stream, window);
    ub += kUnits;
    if (w < wk.y - ub) d = units[ub + w];
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_st) fetch(s);
    pipe::cp_async_commit();
  }
  Acc acc;
  wpipe::zero<8>(acc);
  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<STAGES - 2>();
    // stage s has landed for every thread; every warp is done with stage
    // s − 1, whose buffer the next fetch refills
    __syncthreads();
    if (s + STAGES - 1 < n_st) fetch(s + STAGES - 1);
    pipe::cp_async_commit();
    stage_mma<IDS>(acc, smem + (s % STAGES) * kStage,
                   min(kUnits, wk.y - wk.x - s * kUnits));
  }
  pipe::cp_async_wait_all();
  __syncthreads();  // every warp is done with the stages
  if (wk.w >= 0)
    store_acc(acc, ws + size_t(wk.w) * 128 * 128, smem);
  else
    store_acc(acc, out + size_t(wk.z) * 128 * 128, smem);
}

// The item kernel, then the split blocks' partials summed in item order
// (item_first [n_blocks + 1], pbase [n_blocks], split [n_split]: the plan's
// 128-row blocks).  Returns the cudaError_t of the launches.
template <bool IDS, typename TO, int STAGES>
int launch_mono_fused(const void* table, long long n_table,
                      const void* c_stream, int window, const void* units,
                      const void* work, int n_work, const void* zero_blk,
                      int n_zero, const void* item_first, const void* pbase,
                      const void* split, int n_split, void* ws, void* out,
                      cudaStream_t s) {
  constexpr size_t smem = size_t(STAGES) * Stage<IDS>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mono_fused_kernel<IDS, TO, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  mono_fused_kernel<IDS, TO, STAGES><<<n_work + n_zero, kThreads, smem, s>>>(
      static_cast<const bf16*>(table), n_table, c_stream, window,
      static_cast<const int2*>(units), static_cast<const int4*>(work),
      n_work, static_cast<const int*>(zero_blk), static_cast<float*>(ws),
      static_cast<TO*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return int(err);
  return launch_partial_sum<256, 4, TO>(split, item_first, pbase, ws,
                                        n_split, 128, out, s);
}

}  // namespace mpipe
}  // namespace ggnn
