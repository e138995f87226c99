// The typed pack's slot pipeline for Hopper (sm_90a), shared by the per-tile
// kernels #6 and #7 (typed_tile_fused.cu) and the per-block kernels #1 and
// #2 (typed_block_fused.cu), all in bf16 at D = 128.
//
// Each of them sums, for one 128-row dst block, a list of slots (a tile of
// the per-tile layout, or a (type, chunk) slot of the block layout):
//     acc += Σ_i bf16(onehot(dstl row c_i) @ H_i) @ W[type_i]
// H_i the slot's rows of h_pack from row off_i·align.  What the design does
// about the bound (the scattered reads of h_pack, 2 GB a call at the
// headlines) and about a hub's skew:
// - a slot's real rows lie in a prefix of its tile_e rows (the pack fills
//   a (block, type) group's slots in order): the host gives each dstl
//   row's length (its last dst id ≥ 0, plus one), and only that prefix is
//   read, in 128-row chunks;
// - the one-hot product runs on the tensor cores: the 0/1 operand is made
//   in registers from the dst ids (a lane compares its dst ids with its
//   rows), H is the B operand as it lies (ldmatrix.trans), so every warp
//   does the same work whatever the skew, over the slot's real rows in
//   steps of 16;
// - the slot's sums, rounded to bf16 once per slot (the TPU kernels'
//   rounding point), go through shared memory as the A operand of the W_t
//   product (ldmatrix; W_t as it lies, ldmatrix.trans), 8 warps as 4 × 2
//   tiles of 32 × 64 (window_pipe.cuh);
// - H's 128-row chunks and their dst ids go by cp.async into a ring of two
//   stages, one chunk ahead; W_t into a ring of two, loaded only where the
//   type changes (a list is sorted by type), issued with the new type's
//   first chunk.
// Slots with no real row, a type outside [0, T2) or a dstl row outside
// [0, n_dstl) are skipped (the caller gives them length 0); rows outside
// [0, n_pack) read 0 and dst ids outside [0, 128) match no row, so a layout
// that does not belong to its pack cannot address memory outside it.  No
// float atomics: the same bits on every run.
#pragma once

#include "common.cuh"
#include "gru_pipe.cuh"
#include "window_pipe.cuh"

namespace ggnn {
namespace tpipe {

using wpipe::bf16;
using wpipe::cp16;
using wpipe::gru_panel;
using wpipe::gru_tile;
using wpipe::kLd;
using wpipe::kThreads;
using wpipe::mma_bf16;
using wpipe::Tile;
using wpipe::zero;
using TA = Tile<8>;

// dynamic shared memory: the H chunk ring and the W_t ring (two stages
// each), the slot's rounded sums P, the dst-id ring; the GRU epilogue
// reuses P as a, H stage 0 as h and the W ring for its weight panels
constexpr size_t kH = 0;
constexpr size_t kW = kH + 2 * pipe::kChunk;
constexpr size_t kP = kW + 2 * pipe::kChunk;
constexpr size_t kDl = kP + pipe::kChunk;
constexpr size_t kSmem = kDl + 2 * 128 * sizeof(int);  // 175,104 B

// p += onehot(dl)[128 dst × nk k] · H[nk k × 128 n] on the warp's 32 × 64
// tile (nk: the chunk's rows up to the slot's length, a multiple of 16 or
// 128): the A fragment of lane (g, q) holds rows r, r + 8 of each m16-tile
// and k = k0 + 2q, +1, +8, +9, 1.0 where dl[k] is the row.
__device__ __forceinline__ void onehot_mma(float (&p)[2][8][4], const int* dl,
                                           const bf16* H, int nk) {
  constexpr uint32_t kOne = 0x3F80u;  // bf16 1.0
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int r0 = TA::row0() + (lane >> 2);
  const bf16* b_base = H + (lane & 15) * kLd + TA::col0() + (lane >> 4) * 8;
#pragma unroll
  for (int k0 = 0; k0 < 128; k0 += 16) {
    if (k0 >= nk) break;
    const int2 lo = *reinterpret_cast<const int2*>(dl + k0 + 2 * q);
    const int2 hi = *reinterpret_cast<const int2*>(dl + k0 + 8 + 2 * q);
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int ra = r0 + 16 * mi, rb = ra + 8;
      a[mi][0] = (lo.x == ra ? kOne : 0u) | (lo.y == ra ? kOne << 16 : 0u);
      a[mi][1] = (lo.x == rb ? kOne : 0u) | (lo.y == rb ? kOne << 16 : 0u);
      a[mi][2] = (hi.x == ra ? kOne : 0u) | (hi.y == ra ? kOne << 16 : 0u);
      a[mi][3] = (hi.x == rb ? kOne : 0u) | (hi.y == rb ? kOne << 16 : 0u);
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t b[4];
      pipe::ldsm_x4_trans(b, b_base + k0 * kLd + nj * 16);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        pipe::mma_bf16(p[mi][2 * nj], a[mi], b[0], b[1]);
        pipe::mma_bf16(p[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// acc += the sums of slots [0, n) of the list in shared memory (off: the
// slot's first pack row / align; typ; c: its dstl row; len: its real-row
// prefix, 0 to skip it), in list order.  Every thread of the CTA calls it;
// on return every copy has landed and every warp is done with the shared
// buffers, so the caller may refill the list or reuse them.
__device__ __forceinline__ void slot_sums(
    float (&acc)[2][8][4], unsigned char* smem, const int* s_off,
    const int* s_typ, const int* s_c, const int* s_len, int n,
    const bf16* __restrict__ h_pack, long long n_pack,
    const int* __restrict__ dstl, int tile_e, int align,
    const bf16* __restrict__ msg_w) {
  bf16* Hs = reinterpret_cast<bf16*>(smem + kH);
  bf16* Ws = reinterpret_cast<bf16*>(smem + kW);
  bf16* Ps = reinterpret_cast<bf16*>(smem + kP);
  int* Dl = reinterpret_cast<int*>(smem + kDl);
  // the list's next slot with a real row, in list order (every thread
  // alike): its index in the list
  int i_scan = 0;
  auto next_slot = [&]() -> int {
    while (i_scan < n) {
      const int i = i_scan++;
      if (s_len[i] > 0) return i;
    }
    return -1;
  };
  // chunk j of slot t (its rows and dst ids) into stage st; rows past the
  // slot's length or outside the pack read 0 (their dst ids too: a 0 row
  // adds 0)
  auto fetch = [&](int t, int j, int st) {
    const int len = s_len[t];
    const long long base = (long long)s_off[t] * align + j * 128;
    bf16* hd = Hs + st * 128 * kLd;
    for (int idx = threadIdx.x; idx < 128 * 16; idx += kThreads) {
      const int r = idx >> 4, v = idx & 15;
      const long long row = base + r;
      const bool ok = j * 128 + r < len && row >= 0 && row < n_pack;
      cp16(hd + r * kLd + v * 8, h_pack + (ok ? row : 0) * 128 + v * 8, ok);
    }
    if (threadIdx.x < 32) {
      const int jj = j * 128 + threadIdx.x * 4;
      const bool ok = jj < tile_e;
      cp16(Dl + st * 128 + threadIdx.x * 4,
           ok ? dstl + size_t(s_c[t]) * tile_e + jj : dstl, ok);
    }
  };
  auto fetch_w = [&](int typ, int wb) {
    bf16* wd = Ws + wb * 128 * kLd;
    const bf16* src = msg_w + size_t(typ) * 128 * 128;
    for (int idx = threadIdx.x; idx < 128 * 16; idx += kThreads) {
      const int r = idx >> 4, v = idx & 15;
      cp16(wd + r * kLd + v * 8, src + r * 128 + v * 8, true);
    }
  };

  float p[2][8][4];
  int t = next_slot();
  int wb = 0, w_type = -1;  // the W stage of slot t and the type it holds
  if (t >= 0) {
    fetch(t, 0, 0);
    w_type = s_typ[t];
    fetch_w(w_type, 0);
  }
  pipe::cp_async_commit();
  int s = 0;  // the stage counter of (slot, chunk) units
  while (t >= 0) {
    const int len = s_len[t], nch = (len + 127) / 128;
    int t_next = -1;
    for (int j = 0; j < nch; ++j, ++s) {
      int nt = t, nj = j + 1;
      if (nj == nch) {
        t_next = next_slot();
        nt = t_next;
        nj = 0;
      }
      pipe::cp_async_wait_all();
      __syncthreads();  // unit s has landed; every warp is done with s − 1
      if (nt >= 0) {
        fetch(nt, nj, (s + 1) & 1);
        if (nj == 0 && s_typ[nt] != w_type)
          fetch_w(s_typ[nt], wb ^ 1);  // the other stage is free
      }
      pipe::cp_async_commit();
      if (j == 0) zero<8>(p);
      onehot_mma(p, Dl + (s & 1) * 128, Hs + (s & 1) * 128 * kLd,
                 min(128, (len - j * 128 + 15) & ~15));
      if (j == nch - 1) {
        // the slot's sums, rounded to bf16, are the A operand of W_t
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; e += 2)
              *reinterpret_cast<__nv_bfloat162*>(
                  Ps + TA::row(mi, e) * kLd + TA::col(ni, e)) =
                  __floats2bfloat162_rn(p[mi][ni][e], p[mi][ni][e + 1]);
        __syncthreads();
        mma_bf16<8>(acc, Ps, kLd, Ws + wb * 128 * kLd, kLd);
      }
    }
    if (t_next >= 0 && s_typ[t_next] != w_type) {
      wb ^= 1;
      w_type = s_typ[t_next];
    }
    t = t_next;
  }
  pipe::cp_async_wait_all();
  __syncthreads();
}

// The warp's fragments of acc to rows [128][128] f32 (a block's output rows
// or a partial slot).
__device__ __forceinline__ void store_rows(const float (&acc)[2][8][4],
                                           float* __restrict__ dst) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<float2*>(dst + TA::row(mi, e) * 128 +
                                   TA::col(ni, e)) =
            make_float2(acc[mi][ni][e], acc[mi][ni][e + 1]);
}

// The GRU epilogue of a block (gru_pipe.cuh's gru_tile, as #13's): a in P
// (bf16), h's f32 rows from hrow into H stage 0 in bf16, the six weight
// panels through the two W stages; h' to orow.  A function of its own, so
// that its registers are not the slot loop's.
static __device__ __noinline__ void tile_gru_epilogue(
    bf16* Ps, bf16* Hs, bf16* Ws, const float* __restrict__ hrow,
    const bf16* __restrict__ wa, const float* __restrict__ b3,
    const bf16* __restrict__ uzr, const bf16* __restrict__ uh,
    float* __restrict__ orow) {
  bf16* W1 = Ws + 128 * kLd;
  gru_panel(0, Ws, wa, uzr, uh);
  gru_panel(1, W1, wa, uzr, uh);
  for (int idx = threadIdx.x; idx < 128 * 32; idx += kThreads) {
    const int r = idx >> 5, c = (idx & 31) * 4;
    const float4 x = *reinterpret_cast<const float4*>(hrow + r * 128 + c);
    __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(Hs + r * kLd + c);
    hp[0] = __floats2bfloat162_rn(x.x, x.y);
    hp[1] = __floats2bfloat162_rn(x.z, x.w);
  }
  gru_tile<false>(Ps, Hs, Ws, W1, hrow, 128, orow, 128, nullptr, wa, b3, uzr,
                  uh);
}

// The GRU step on a = acc + init (the block's rows, init added after the
// sums as the plain versions add it), rounded to bf16 into P; h' to orow.
// The caller's slot_sums has returned (the shared buffers are free).
__device__ __forceinline__ void init_gru(
    const float (&acc)[2][8][4], unsigned char* smem,
    const float* __restrict__ init_rows, const float* __restrict__ hrow,
    const bf16* __restrict__ wa, const float* __restrict__ b3,
    const bf16* __restrict__ uzr, const bf16* __restrict__ uh,
    float* __restrict__ orow) {
  bf16* Ps = reinterpret_cast<bf16*>(smem + kP);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = TA::row(mi, e), c = TA::col(ni, e);
        const float2 iv =
            *reinterpret_cast<const float2*>(init_rows + r * 128 + c);
        *reinterpret_cast<__nv_bfloat162*>(Ps + r * kLd + c) =
            __floats2bfloat162_rn(acc[mi][ni][e] + iv.x,
                                  acc[mi][ni][e + 1] + iv.y);
      }
  tile_gru_epilogue(Ps, reinterpret_cast<bf16*>(smem + kH),
                    reinterpret_cast<bf16*>(smem + kW), hrow, wa, b3, uzr, uh,
                    orow);
}

}  // namespace tpipe
}  // namespace ggnn
