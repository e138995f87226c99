// The fused window step (#13) in bf16 for Hopper (sm_90a): the kernel
// template of the forms that window_step.cu sends here (see there for what
// the step computes); one source file per form (window_step_fused*.cu),
// so that nvcc builds them in parallel.
//
// Design.  One CTA per (dst block, 128-row slice), 8 warps of 32 × 64
// output tiles (window_pipe.cuh), the slice's f32 sums in registers; the
// slice walks its block's real tiles in list order, and each tile in
// chunks of 128 window rows.  Per chunk:
// - the slice's count rows [128][128] int8 go by 16-byte cp.async into a
//   ring of two stages, one chunk ahead of the product, as they lie; they
//   are the A operand (ldmatrix), converted to bf16 in the fragments;
// - the window chunk is the B operand [128 k][128 n], read by
//   ldmatrix.trans: a table chunk by cp.async into a ring of two stages
//   beside the counts (rows stored at perm_bf16; the q8 table's int8 rows
//   at perm_s8, multiplied exactly by mma.m16n8k32 and byte permutes);
//   an on-demand window T(h_blk · W_t + b_t) is built ONCE per dst block:
//   the block's slices are one thread-block cluster; during a tile's
//   product each CTA builds its columns [rank·128/cs, +128/cs) of every
//   chunk of the next tile's window (the h block and its pieces of W_t by
//   cp.async, a chunk ahead) into the block's window scratch in device
//   memory (two slots, 2·W rows; it stays in L2), and one cluster barrier
//   a tile publishes it: the chunks are then read like a table's.
// The GRU epilogue stages a and h in bf16 (and h's f32 rows, for the
// gates) and runs gru_pipe.cuh's gru_tile, which #6 shares: the six [128,
// 128] weight panels through two cp.async stages, read by ldmatrix.trans.
//
// Unchanged from the first version: each row sums its block's tiles in
// list order, in f32, with no atomics (the same bits on every run); a
// dummy tile (win < 0) or one past the stream adds nothing; a block
// without a real tile gives the GRU of init; the rounding points (a, h,
// r⊙h rounded to bf16 before the gate products; an on-demand chunk
// rounded once; q8 products exact in int32, times the window's scale).
//
// STORE (on-demand only; #12, window_ondemand_fused.cu): the same
// pipeline without the GRU epilogue, the sums stored in f32, and each dst
// block's real tiles cut into work items of at most split_k tiles (the
// host's plan: rt, the real tiles in list order, block b's at rt[rt_start
// [b] .. rt_start[b + 1])), one CTA (cluster) per item with a window
// scratch of its own, so that a hub block that holds most of a power-law
// graph's tiles spreads over the card.  A block of one item writes its
// rows; a block of more writes one f32 partial per item (slot pbase[b] +
// k), summed in item order by window_ondemand_fused.cu's second kernel.
#pragma once

#include "common.cuh"
#include "gru_pipe.cuh"
#include "window_pipe.cuh"

namespace ggnn {
namespace wstep {

// (using-declarations, not a using-directive: common.cuh's ggnn::kThreads,
// and window_step.cuh's kLd8 where both are included, stay out of the way)
using wpipe::bf16;
using wpipe::cluster_sync;
using wpipe::cp16;
using wpipe::gru_panel;
using wpipe::gru_tile;
using wpipe::kChunk8;
using wpipe::kLd;
using wpipe::kLd8;
using wpipe::kThreads;
using wpipe::mma_bf16;
using wpipe::mma_counts_bf16;
using wpipe::mma_s8_s8;
using wpipe::perm_bf16;
using wpipe::perm_s8;
using wpipe::push_block;
using wpipe::Tile;
using wpipe::zero;
constexpr int kTable = 0, kQ8 = 1, kOnDemand = 2;

// dynamic shared memory: the count ring and the B ring (two stages each),
// the h block and two stages of the W_t piece of on-demand builds; the
// epilogue reuses them as a, h, and two weight stages
constexpr size_t kCS = 0;
constexpr size_t kBB = 2 * kChunk8;
constexpr size_t kHB = kBB + 2 * pipe::kChunk;
constexpr size_t kWP = kHB + pipe::kChunk;
constexpr size_t kSmem = kWP + 2 * pipe::kChunk;  // 210,944 B

// One piece of an on-demand chunk, into the block's window scratch in
// device memory: dst[k][c] = bf16(H[k] · Wp[:, c] + bias[c]) for the
// 8·2·NI columns of this CTA (dst rows 128 elements apart).
template <int NI>
__device__ __forceinline__ void build_piece(const bf16* H, const bf16* Wp,
                                            int ldw, const float* bias,
                                            bf16* dst) {
  float2 bv[NI];  // this thread's bias pairs, loaded before the product
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
    bv[ni] = *reinterpret_cast<const float2*>(bias + Tile<NI>::col(ni, 0));
  float acc[2][NI][4];
  zero<NI>(acc);
  mma_bf16<NI>(acc, H, kLd, Wp, ldw);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = Tile<NI>::row(mi, e), c = Tile<NI>::col(ni, e);
        *reinterpret_cast<__nv_bfloat162*>(dst + r * 128 + c) =
            __floats2bfloat162_rn(acc[mi][ni][e] + bv[ni].x,
                                  acc[mi][ni][e + 1] + bv[ni].y);
      }
}

// The STORE form's work items (see above); all null for the fused forms.
struct Items {
  const int* item_first;  // [n_blocks + 1]: block b's items
  const int* rt;          // the real tiles, in list order
  const int* rt_start;    // [n_blocks + 1]: block b's entries of rt
  const int* pbase;       // [n_blocks]: a split block's first partial slot
  float* ws;              // the partials, [slots, out_rows, 128] f32
  int n_blocks, split_k;
};

template <int SRC, bool RES, bool STORE>
__global__ void __launch_bounds__(kThreads, 1) window_step_fused_kernel(
    const void* __restrict__ table, long long n_table,
    const int8_t* __restrict__ counts, long long n_c,
    const int* __restrict__ tile_start, const int* __restrict__ win_of_tile,
    const int* __restrict__ c_off, int out_rows, int window,
    const float* __restrict__ scales, const bf16* __restrict__ wbank,
    const float* __restrict__ bbank, int T2,
    const float* __restrict__ init, const float* __restrict__ hstate,
    const bf16* __restrict__ wa, const float* __restrict__ b3,
    const bf16* __restrict__ uzr, const bf16* __restrict__ uh,
    float* __restrict__ out, bf16* __restrict__ res,
    bf16* __restrict__ scratch, Items items) {
  static_assert(!STORE || (SRC == kOnDemand && !RES),
                "STORE is the on-demand sums without the epilogue");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int rt_list[kThreads];   // the block's next real tiles
  __shared__ int rt_warp[kThreads / 32];
  constexpr bool kPair = SRC == kQ8;
  using TA = Tile<8, kPair>;
  const int slices = out_rows / 128;
  // the work item (STORE) or the dst block of this CTA's cluster
  const int wi = blockIdx.x / slices, slice = blockIdx.x % slices;
  int b = wi;
  if constexpr (STORE) b = item_block(items.item_first, items.n_blocks, wi);
  const int cs = SRC == kOnDemand ? slices : 1;  // CTAs of the cluster
  const int rank = SRC == kOnDemand ? slice : 0;
  const int pw = 128 / cs;                       // a piece's columns
  const size_t orow0 = size_t(b) * out_rows + size_t(slice) * 128;
  const int nch = window / 128;
  const int wpb = SRC == kOnDemand ? T2 / nch : 1;
  unsigned char* CS = smem + kCS;
  bf16* HB = reinterpret_cast<bf16*>(smem + kHB);
  bf16* WP = reinterpret_cast<bf16*>(smem + kWP);
  auto bbuf = [&](int st) { return smem + kBB + st * pipe::kChunk; };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mi][ni][e] =
            init ? init[(orow0 + TA::row(mi, e)) * 128 + TA::col(ni, e)]
                 : 0.0f;
  int iacc[2][8][4];
  if constexpr (SRC == kQ8) zero<8>(iacc);

  // STORE: the item's real tiles from the plan
  int it_pos = 0, it_end = 0, n_items = 1, k_item = 0;
  if constexpr (STORE) {
    k_item = wi - items.item_first[b];
    n_items = items.item_first[b + 1] - items.item_first[b];
    it_pos = items.rt_start[b] + k_item * items.split_k;
    it_end = min(it_pos + items.split_k, items.rt_start[b + 1]);
  }
  // the block's real tiles in list order, 256 entries scanned at a time
  const int t1 = tile_start[b + 1];
  int pos = 0, cnt = 0, scan = tile_start[b];
  auto next_tile = [&]() -> int {
    if constexpr (STORE) return it_pos < it_end ? items.rt[it_pos++] : -1;
    while (pos == cnt && scan < t1) {
      const int tc = scan + threadIdx.x;
      bool real = false;
      if (tc < t1) {
        const long long c = c_off ? (long long)c_off[tc] : tc;
        real = win_of_tile[tc] >= 0 && c >= 0 && c < n_c;
      }
      const unsigned m = __ballot_sync(0xffffffffu, real);
      __syncthreads();  // every thread is done with the previous list
      if ((threadIdx.x & 31) == 0) rt_warp[threadIdx.x >> 5] = __popc(m);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int i = 0; i < kThreads / 32; ++i) {
        before += i < (threadIdx.x >> 5) ? rt_warp[i] : 0;
        total += rt_warp[i];
      }
      if (real)
        rt_list[before + __popc(m & ((1u << (threadIdx.x & 31)) - 1))] = tc;
      __syncthreads();
      pos = 0;
      cnt = total;
      scan += kThreads;
    }
    return pos < cnt ? rt_list[pos++] : -1;
  };

  // the counts of chunk j of tile t into stage st
  auto fetch_counts = [&](int t, int j, int st) {
    const long long c = c_off ? (long long)c_off[t] : t;
    const int8_t* C =
        counts + (size_t(c) * out_rows + size_t(slice) * 128) * window +
        j * 128;
    unsigned char* cd = CS + st * kChunk8;
    for (int idx = threadIdx.x; idx < 128 * 8; idx += kThreads) {
      const int r = idx >> 3, v = idx & 7;
      cp16(cd + r * kLd8 + v * 16, C + size_t(r) * window + v * 16, true);
    }
  };
  // 128 window rows [row0, row0 + 128) of a row-major table (bf16, or the
  // q8 table's int8) into B stage st; rows at or past n_rows read 0
  auto fetch_window = [&](const void* src, long long row0, long long n_rows,
                          int st) {
    for (int idx = threadIdx.x; idx < 128 * (SRC == kQ8 ? 8 : 16);
         idx += kThreads) {
      const int k = SRC == kQ8 ? idx >> 3 : idx >> 4;
      const int v = SRC == kQ8 ? idx & 7 : idx & 15;
      const long long row = row0 + k;
      const bool ok = row < n_rows;
      const unsigned char* p = static_cast<const unsigned char*>(src) +
                               (ok ? row : 0) * (SRC == kQ8 ? 128 : 256) +
                               v * 16;
      unsigned char* dst =
          SRC == kQ8 ? bbuf(st) + perm_s8(k) * kLd8 + v * 16
                     : bbuf(st) + perm_bf16(k) * (kLd * 2) + v * 16;
      cp16(dst, p, ok);
    }
  };
  auto fetch = [&](int t, int j, int st) {
    fetch_counts(t, j, st);
    fetch_window(table, (long long)win_of_tile[t] * window + j * 128,
                 n_table, st);
  };
  // on-demand: the block's window scratch, two slots of W rows, and the
  // inputs of a tile's build (its h block; the CTA's piece of W_t for
  // chunk j, into W stage ws)
  bf16* scr = SRC == kOnDemand ? scratch + size_t(wi) * 2 * window * 128
                               : nullptr;
  auto fetch_h = [&](int t) {
    const long long hb = (long long)(win_of_tile[t] / wpb) * 128;
    const bf16* h = static_cast<const bf16*>(table);
    for (int idx = threadIdx.x; idx < 128 * 16; idx += kThreads) {
      const int r = idx >> 4, v = idx & 15;
      const bool ok = hb + r < n_table;
      cp16(HB + r * kLd + v * 8, h + (ok ? hb + r : 0) * 128 + v * 8, ok);
    }
  };
  const int ldw = pw + 8;
  auto fetch_wpiece = [&](int t, int j, int ws) {
    const int tj = (win_of_tile[t] % wpb) * nch + j;
    const int vpr = pw / 8;
    for (int idx = threadIdx.x; idx < 128 * vpr; idx += kThreads) {
      const int k = idx / vpr, v = idx % vpr;
      cp16(WP + (ws * 128 + k) * ldw + v * 8,
           wbank + (size_t(tj) * 128 + k) * 128 + rank * pw + v * 8, true);
    }
  };
  auto build = [&](int t, int j, int ws, int slot) {
    const int tj = (win_of_tile[t] % wpb) * nch + j;
    const float* bias = bbank + size_t(tj) * 128 + rank * pw;
    bf16* dst = scr + (size_t(slot) * window + j * 128) * 128 + rank * pw;
    const bf16* Wp = WP + ws * 128 * ldw;
    if (cs == 1) build_piece<8>(HB, Wp, ldw, bias, dst);
    else if (cs == 2) build_piece<4>(HB, Wp, ldw, bias, dst);
    else build_piece<2>(HB, Wp, ldw, bias, dst);
  };
  auto consume = [&](int t, int j, int cst, int bst) {
    const unsigned char* C = CS + cst * kChunk8;
    if constexpr (SRC == kQ8) {
      mma_s8_s8(iacc, C, bbuf(bst));
      if (j == nch - 1) {
        const float sc = scales[win_of_tile[t]];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[mi][ni][e] += float(iacc[mi][ni][e]) * sc;
              iacc[mi][ni][e] = 0;
            }
      }
    } else {
      mma_counts_bf16(acc, C, reinterpret_cast<const bf16*>(bbuf(bst)));
    }
  };

  bool panels = false;
  // the GRU epilogue's first two weight panels, into HB and WP as soon as
  // those are free
  auto fetch_panels = [&]() {
    gru_panel(0, HB, wa, uzr, uh);
    gru_panel(1, WP, wa, uzr, uh);
    panels = true;
  };

  if constexpr (SRC == kOnDemand) {
    // tile i's window is built during tile i − 1 by the cluster, each CTA
    // its columns of every chunk, into slot i & 1 of the scratch; one
    // cluster barrier a tile publishes it, and tile i's chunks are then
    // read like a table's
    int cur = next_tile();
    if (cur >= 0) {
      fetch_h(cur);
      fetch_wpiece(cur, 0, 0);
      pipe::cp_async_commit();
      for (int j = 0; j < nch; ++j) {
        pipe::cp_async_wait_all();
        __syncthreads();  // the h block and chunk j's W_t piece landed
        if (j + 1 < nch) fetch_wpiece(cur, j + 1, (j + 1) & 1);
        pipe::cp_async_commit();
        build(cur, j, j & 1, 0);
      }
    }
    int nxt = cur >= 0 ? next_tile() : -1;
    cluster_sync();  // tile 0's window is in the scratch
    int s = 0;
    for (int i = 0; cur >= 0; ++i) {
      const bf16* win = scr + size_t(i & 1) * window * 128;
      if (i == 0) fetch_counts(cur, 0, s & 1);  // later: a chunk ahead
      fetch_window(win, 0, window, s & 1);  // the first chunk's window
      if (nxt >= 0) {
        fetch_h(nxt);
        fetch_wpiece(nxt, 0, 0);
      } else if constexpr (!STORE) {
        fetch_panels();  // HB and WP are free for good
      }
      pipe::cp_async_commit();
      for (int j = 0; j < nch; ++j, ++s) {
        pipe::cp_async_wait_all();
        __syncthreads();  // chunk j, and the next tile's inputs, landed
        if (j + 1 < nch) {
          fetch_counts(cur, j + 1, (s + 1) & 1);
          fetch_window(win, j * 128 + 128, window, (s + 1) & 1);
          if (nxt >= 0) fetch_wpiece(nxt, j + 1, (j + 1) & 1);
        } else if (nxt >= 0) {
          fetch_counts(nxt, 0, (s + 1) & 1);  // its window waits for the
        }                                     // barrier, its counts do not
        pipe::cp_async_commit();
        if (nxt >= 0) build(nxt, j, j & 1, (i + 1) & 1);
        consume(cur, j, s & 1, s & 1);
      }
      const int nxt2 = nxt >= 0 ? next_tile() : -1;
      // the next tile's window is in the scratch, and no CTA reads this
      // tile's slot any more
      cluster_sync();
      cur = nxt;
      nxt = nxt2;
    }
  } else {
    fetch_panels();  // HB and WP are not used by a table's loop
    int t_cur = next_tile();
    if (t_cur >= 0) {
      fetch(t_cur, 0, 0);
      pipe::cp_async_commit();
    }
    int s = 0;
    while (t_cur >= 0) {
      int t_nxt = t_cur;  // the tile of chunk s + 1
      for (int j = 0; j < nch; ++j, ++s) {
        const int st = s & 1;
        int jn = j + 1;
        if (jn == nch) {
          t_nxt = next_tile();
          jn = 0;
        }
        pipe::cp_async_wait_all();
        __syncthreads();  // chunk s has landed; stage st ^ 1 is free
        if (t_nxt >= 0) fetch(t_nxt, jn, st ^ 1);
        pipe::cp_async_commit();
        consume(t_cur, j, st, st);
      }
      t_cur = t_nxt;
    }
  }
  pipe::cp_async_wait_all();
  __syncthreads();

  if constexpr (STORE) {
    // the sums, f32, into the output rows or the item's partial slot
    float* dst = n_items == 1
                     ? out + orow0 * 128
                     : items.ws + (size_t(items.pbase[b] + k_item) * out_rows +
                                   size_t(slice) * 128) * 128;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          *reinterpret_cast<float2*>(dst + TA::row(mi, e) * 128 +
                                     TA::col(ni, e)) =
              make_float2(acc[mi][ni][e], acc[mi][ni][e + 1]);
    return;
  }

  // --- the GRU epilogue (gru_pipe.cuh) --------------------------------------
  // h's f32 rows (Hf, over the count ring and the first B stage) by
  // cp.async, then read from shared memory; a in B stage 1, h in bf16 in
  // the second half of WP, the weight stages HB and WP
  float* Hf = reinterpret_cast<float*>(smem);
  constexpr int kLdH = 132;  // Hf row length (floats)
  static_assert(128 * kLdH * 4 <= kBB + pipe::kChunk, "Hf fits");
  bf16* A_s = reinterpret_cast<bf16*>(bbuf(1));
  bf16* H_s = reinterpret_cast<bf16*>(smem + kWP + pipe::kChunk);
  if (!panels) fetch_panels();
  const float* hrow = hstate + orow0 * 128;
  for (int idx = threadIdx.x; idx < 128 * 32; idx += kThreads) {
    const int r = idx >> 5, v = idx & 31;
    cp16(Hf + r * kLdH + 4 * v, hrow + r * 128 + 4 * v, true);
  }
  pipe::cp_async_commit();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        A_s[TA::row(mi, e) * kLd + TA::col(ni, e)] =
            __float2bfloat16_rn(acc[mi][ni][e]);
  pipe::cp_async_wait_all();
  __syncthreads();
  for (int idx = threadIdx.x; idx < 128 * 32; idx += kThreads) {
    const int r = idx >> 5, v = idx & 31;
    const float4 x = *reinterpret_cast<const float4*>(Hf + r * kLdH + 4 * v);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    *reinterpret_cast<uint2*>(H_s + r * kLd + 4 * v) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  }
  __syncthreads();
  constexpr int kRes = 4 * 128;  // a residual row: a | z | r | h̃
  bf16* rrow = RES ? res + orow0 * kRes : nullptr;
  if constexpr (RES) {
    for (int idx = threadIdx.x; idx < 128 * 16; idx += kThreads) {
      const int r = idx >> 4, v = idx & 15;
      reinterpret_cast<uint4*>(rrow + size_t(r) * kRes)[v] =
          *reinterpret_cast<const uint4*>(A_s + r * kLd + v * 8);
    }
  }
  // h' replaces h in Hf and h̃ goes to A_s; then both leave as whole rows,
  // 16 bytes a store
  gru_tile<RES>(A_s, H_s, HB, WP, Hf, kLdH, Hf, kLdH, rrow, wa, b3, uzr,
                uh);
  __syncthreads();
  float* orow = out + orow0 * 128;
  for (int idx = threadIdx.x; idx < 128 * 32; idx += kThreads) {
    const int r = idx >> 5, v = idx & 31;
    reinterpret_cast<float4*>(orow + r * 128)[v] =
        *reinterpret_cast<const float4*>(Hf + r * kLdH + 4 * v);
  }
  if constexpr (RES) {
    for (int idx = threadIdx.x; idx < 128 * 16; idx += kThreads) {
      const int r = idx >> 4, v = idx & 15;
      reinterpret_cast<uint4*>(rrow + size_t(r) * kRes + 384)[v] =
          *reinterpret_cast<const uint4*>(A_s + r * kLd + v * 8);
    }
  }
}

// The launch: one CTA per (dst block, 128-row slice), or with STORE per
// (work item, slice); on-demand windows with the slices of a block as one
// cluster (out_rows 128, 256 or 512).
template <int SRC, bool RES, bool STORE>
int launch_window_step_fused(
    const void* table, long long n_table, const void* counts, long long n_c,
    const void* tile_start, const void* win_of_tile, const void* c_off,
    int n_blocks, int out_rows, int window, const void* scales,
    const void* wbank, const void* bbank, int T2, const void* init,
    const void* hstate, const void* wa, const void* b3, const void* uzr,
    const void* uh, void* out, void* res, void* scratch, Items items,
    cudaStream_t stream) {
  const int slices = out_rows / 128;
  const int cs = SRC == kOnDemand ? slices : 1;
  if (out_rows <= 0 || out_rows % 128 || window <= 0 || window % 128 ||
      (cs != 1 && cs != 2 && cs != 4) || (SRC == kOnDemand && !scratch))
    return int(cudaErrorInvalidValue);
  auto kern = window_step_fused_kernel<SRC, RES, STORE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  // (with STORE, n_blocks counts the work items)
  cfg.gridDim = dim3(unsigned(n_blocks) * slices);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, table, n_table, static_cast<const int8_t*>(counts), n_c,
      static_cast<const int*>(tile_start),
      static_cast<const int*>(win_of_tile), static_cast<const int*>(c_off),
      out_rows, window, static_cast<const float*>(scales),
      static_cast<const bf16*>(wbank), static_cast<const float*>(bbank), T2,
      static_cast<const float*>(init), static_cast<const float*>(hstate),
      static_cast<const bf16*>(wa), static_cast<const float*>(b3),
      static_cast<const bf16*>(uzr), static_cast<const bf16*>(uh),
      static_cast<float*>(out), static_cast<bf16*>(res),
      static_cast<bf16*>(scratch), items);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace wstep
}  // namespace ggnn

#define GGNN_WINDOW_STEP_FUSED_SIG                                           \
  const void*, long long, const void*, long long, const void*, const void*, \
      const void*, int, int, int, const void*, const void*, const void*,    \
      int, const void*, const void*, const void*, const void*, const void*, \
      const void*, void*, void*, void*, ggnn::wstep::Items, cudaStream_t
#define GGNN_WINDOW_STEP_FUSED_INSTANTIATE(SRC, RES, STORE)            \
  template int ggnn::wstep::launch_window_step_fused<SRC, RES, STORE>( \
      GGNN_WINDOW_STEP_FUSED_SIG);
#define GGNN_WINDOW_STEP_FUSED_EXTERN(SRC, RES, STORE)                 \
  extern template int                                                  \
  ggnn::wstep::launch_window_step_fused<SRC, RES, STORE>(              \
      GGNN_WINDOW_STEP_FUSED_SIG);
