// The fused per-tile typed step (#6) in bf16 for Hopper (sm_90a): the typed
// pack's scatter with the GRU step in its epilogue, where block mode
// declines (hub-heavy and power-law graphs).
//
// Replaces ggnn_tpu/ops/scatter_pallas.py::_typed_step_kernel (run by
// typed_step_gru).  For dst block b it computes
//     a = init_b + Σ_t T(onehot(dstl[c_off[t]]) @ H_t) @ W[type[t]]
// over the block's tiles t (tile t reads tile_e rows of h_pack from
// tile_msg_off[t]·align; −1 marks a dummy tile, which adds nothing; dst ids
// outside [0, 128), rows outside [0, n_pack), dstl rows outside [0, n_dstl)
// and types outside [0, T2) add nothing), the one-hot product in f32 and
// rounded to bf16 PER TILE, as the TPU kernel does, then the GRU cell of
// common.cuh::gru_block on a.  init is added after the tile sums.
//
// Bound on this card: the scattered reads of h_pack.  At the scale-free
// headline (262,144 nodes, 8M directed edges, Zipf 1.2, D = 128, tile_e
// 256) one call reads 2.05 GB of packed rows (0.61 ms at 3.35 TB/s); the
// W_t products are 61K·2·128³ ≈ 0.26 TFLOP.  The first version
// (typed_tile.cu, which #7 keeps) lost its time to two things:
// - the one-hot product was a segment sum in which warp w adds the tile
//   rows bound for dst rows [16w, 16w + 16): a hub row's tile fell to one
//   warp while seven waited (the hub block, 22,328 of 60,962 tiles, took
//   5.55 of #7's 8.58 ms);
// - a second kernel summed the hub block's 698 item partials (45.7 MB of
//   f32) on one SM, then ran the epilogue there.
// This design:
// - the one-hot product runs on the tensor cores: the 0/1 operand is made
//   in registers from dstl (a lane compares its dst ids with its rows), H_t
//   is the B operand as it lies (ldmatrix.trans), so every warp does the
//   same work whatever the skew, over the tile's real rows in steps of 16:
//   2·128·len·128 operations a tile, as much as the W product at 128 rows
//   (skipping a warp's k-steps without one of its rows cost more than it
//   saved: scripts/torch_scalefree_variants.py);
// - the tile's sums, rounded to bf16, go through shared memory as the A
//   operand of the W_t product (ldmatrix; W_t as it lies, ldmatrix.trans),
//   8 warps as 4 × 2 tiles of 32 × 64 (window_pipe.cuh);
// - a tile's real rows lie in a prefix of its tile_e slots (the pack fills
//   a (block, type) group's tiles in order): the host gives each dstl
//   row's length (its last dst id ≥ 0, plus one), and only that prefix is
//   read, in 128-row chunks (the scale-free headline has 8M real rows in
//   60,962 tiles of 256 slots);
// - H_t's 128-row chunks and their dst ids go by cp.async into a ring of
//   two stages, one chunk ahead; W_t into a ring of two, loaded only where
//   the type changes (a block's tiles are sorted by type), issued with the
//   new type's first chunk;
// - the hub split is typed_tile.cu's (kSplit = 32 tiles an item, one CTA
//   per item, common.cuh); a block of several items writes f32 partials,
//   and the second kernel sums them over 8 CTAs a block, each 16 rows in
//   item order, and runs the GRU on its 16 rows there (the weight panels
//   by cp.async, ldmatrix.trans), so the sum meets the epilogue without
//   another pass through memory.
// No float atomics: the same bits on every run.  The sums are taken in
// another order than #7's segment sums (the tensor cores add a k-step's 16
// products at once), so #6's a is held to the plain version, not to #7's
// output bit for bit.
#include "common.cuh"
#include "gru_pipe.cuh"
#include "window_pipe.cuh"

namespace ggnn {
namespace tstep {

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

// dynamic shared memory: the H_t chunk ring and the W_t ring (two stages
// each), the tile's rounded sums P, the dst-id ring; the epilogue reuses P
// as a, H stage 0 as h and the W ring for its weight panels
constexpr size_t kH = 0;
constexpr size_t kW = kH + 2 * pipe::kChunk;
constexpr size_t kP = kW + 2 * pipe::kChunk;
constexpr size_t kDl = kP + pipe::kChunk;
constexpr size_t kSmem = kDl + 2 * 128 * sizeof(int);  // 175,104 B

// p += onehot(dl)[128 dst × nk k] · H[nk k × 128 n] on the warp's 32 × 64
// tile (nk: the chunk's rows up to the tile's length, a multiple of 16 or
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

// The GRU epilogue of a single-item block (gru_pipe.cuh's gru_tile, as
// #13's): a in P (bf16), h's f32 rows from hrow into H stage 0 in bf16,
// the six weight panels through the two W stages; h' to orow.  A function
// of its own, so that its registers are not the tile loop's.
__device__ __noinline__ void tile_gru_epilogue(
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

// One CTA per work item (grid = item_first[n_blocks]).
__global__ void __launch_bounds__(kThreads, 1) typed_step_fused_kernel(
    const bf16* __restrict__ h_pack, long long n_pack,
    const int* __restrict__ dstl, long long n_dstl,
    const int* __restrict__ tile_start, const int* __restrict__ tile_msg_off,
    const int* __restrict__ c_off, const int* __restrict__ tile_type,
    const int* __restrict__ dstl_len, const bf16* __restrict__ msg_w,
    int T2, int n_blocks, int tile_e,
    int align, const int* __restrict__ item_first,
    const int* __restrict__ pbase, const float* __restrict__ init,
    const float* __restrict__ hstate, const bf16* __restrict__ wa,
    const float* __restrict__ b3, const bf16* __restrict__ uzr,
    const bf16* __restrict__ uh, float* __restrict__ ws,
    float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Hs = reinterpret_cast<bf16*>(smem + kH);
  bf16* Ws = reinterpret_cast<bf16*>(smem + kW);
  bf16* Ps = reinterpret_cast<bf16*>(smem + kP);
  int* Dl = reinterpret_cast<int*>(smem + kDl);
  const int item = blockIdx.x;
  const int b = item_block(item_first, n_blocks, item);
  const int k = item - item_first[b];
  const int n_items = item_first[b + 1] - item_first[b];
  // the item's tiles (at most kSplit), read once into shared memory: pack
  // offset, type, dstl row and length (0: a dummy, or no real row)
  __shared__ int s_off[kSplit], s_typ[kSplit], s_c[kSplit], s_len[kSplit];
  static_assert(kSplit <= kThreads, "a thread per tile of an item");
  const int t0 = tile_start[b] + k * kSplit;
  const int n_t = min(t0 + kSplit, tile_start[b + 1]) - t0;
  if (threadIdx.x < n_t) {
    const int i = threadIdx.x;
    const int off = tile_msg_off[t0 + i], typ = tile_type[t0 + i];
    const int c = c_off[t0 + i];
    const bool ok =
        off >= 0 && typ >= 0 && typ < T2 && c >= 0 && c < n_dstl;
    s_off[i] = off;
    s_typ[i] = typ;
    s_c[i] = c;
    s_len[i] = ok ? min(dstl_len[c], tile_e) : 0;
  }
  __syncthreads();
  // the item's next tile with a real row, in list order (every thread
  // alike): its index in the item
  int i_scan = 0;
  auto next_tile = [&]() -> int {
    while (i_scan < n_t) {
      const int i = i_scan++;
      if (s_len[i] > 0) return i;
    }
    return -1;
  };
  // chunk j of the item's tile t (its rows and dst ids) into stage st;
  // rows past the tile's length or outside the pack read 0 (their dst ids
  // too: a 0 row adds 0)
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

  float acc[2][8][4], p[2][8][4];
  zero<8>(acc);
  int t = next_tile();
  int wb = 0, w_type = -1;  // the W stage of tile t and the type it holds
  if (t >= 0) {
    fetch(t, 0, 0);
    w_type = s_typ[t];
    fetch_w(w_type, 0);
  }
  pipe::cp_async_commit();
  int s = 0;  // the stage counter of (tile, chunk) units
  while (t >= 0) {
    const int len = s_len[t], nch = (len + 127) / 128;
    int t_next = -1;
    for (int j = 0; j < nch; ++j, ++s) {
      int nt = t, nj = j + 1;
      if (nj == nch) {
        t_next = next_tile();
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
        // the tile's sums, rounded to bf16, are the A operand of W_t
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

  const size_t ob = size_t(b) * 128 * 128;
  if (n_items > 1) {  // the item's partial, summed by the second kernel
    float* dst = ws + size_t(pbase[b] + k) * 128 * 128;
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
  // the GRU epilogue on a = sums + init (over P), in a function of its own
  // (its registers are not the tile loop's)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = TA::row(mi, e), c = TA::col(ni, e);
        const float2 iv =
            *reinterpret_cast<const float2*>(init + ob + r * 128 + c);
        *reinterpret_cast<__nv_bfloat162*>(Ps + r * kLd + c) =
            __floats2bfloat162_rn(acc[mi][ni][e] + iv.x,
                                  acc[mi][ni][e + 1] + iv.y);
      }
  tile_gru_epilogue(Ps, Hs, Ws, hstate + ob, wa, b3, uzr, uh, out + ob);
}

// The split blocks: 8 CTAs a block (split[blockIdx.x / 8]), each 16 rows.
// Sums the block's item partials in item order, adds init, and runs the
// GRU cell on its rows (gru_block's products and rounding points: the
// gate products' inputs a, h and r⊙h in bf16, f32 gates and h); warp w
// owns the gates' columns [16w, 16w + 16), the six [128, 128] weight
// panels streamed through two cp.async stages and read by ldmatrix.trans.
constexpr int kRS = 16;                                   // rows a CTA
constexpr size_t kRowsB = size_t(kRS) * kLd * sizeof(bf16);
constexpr size_t kRSmem = 2 * pipe::kChunk + 3 * kRowsB;  // 82,688 B

__global__ void __launch_bounds__(kThreads) typed_step_reduce_kernel(
    const int* __restrict__ split, const int* __restrict__ item_first,
    const int* __restrict__ pbase, const float* __restrict__ ws,
    const float* __restrict__ init, const float* __restrict__ hstate,
    const bf16* __restrict__ wa, const float* __restrict__ b3,
    const bf16* __restrict__ uzr, const bf16* __restrict__ uh,
    float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* W_s[2] = {reinterpret_cast<bf16*>(smem),
                  reinterpret_cast<bf16*>(smem + pipe::kChunk)};
  bf16* A_s = reinterpret_cast<bf16*>(smem + 2 * pipe::kChunk);
  bf16* H_s = reinterpret_cast<bf16*>(smem + 2 * pipe::kChunk + kRowsB);
  bf16* RH_s = reinterpret_cast<bf16*>(smem + 2 * pipe::kChunk + 2 * kRowsB);
  const int b = split[blockIdx.x / (128 / kRS)];
  const int strip = blockIdx.x % (128 / kRS);
  const int n = item_first[b + 1] - item_first[b];
  const size_t row0 = size_t(b) * 128 + size_t(strip) * kRS;

  gru_panel(0, W_s[0], wa, uzr, uh);
  gru_panel(1, W_s[1], wa, uzr, uh);

  // the partial sums: 16 rows of 32 float4, two a thread, in item order
  const float* base =
      ws + size_t(pbase[b]) * 128 * 128 + size_t(strip) * kRS * 128;
  float4 sum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) sum[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int it = 0; it < n; ++it) {
    const float4* slot =
        reinterpret_cast<const float4*>(base + size_t(it) * 128 * 128);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 v = slot[threadIdx.x + i * kThreads];
      sum[i].x += v.x;
      sum[i].y += v.y;
      sum[i].z += v.z;
      sum[i].w += v.w;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 5, c = (idx & 31) * 4;
    const float4 iv = *reinterpret_cast<const float4*>(init + (row0 + r) *
                                                       128 + c);
    const float4 hv = *reinterpret_cast<const float4*>(hstate + (row0 + r) *
                                                        128 + c);
    __nv_bfloat162* ap = reinterpret_cast<__nv_bfloat162*>(A_s + r * kLd + c);
    ap[0] = __floats2bfloat162_rn(sum[i].x + iv.x, sum[i].y + iv.y);
    ap[1] = __floats2bfloat162_rn(sum[i].z + iv.z, sum[i].w + iv.w);
    __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(H_s + r * kLd + c);
    hp[0] = __floats2bfloat162_rn(hv.x, hv.y);
    hp[1] = __floats2bfloat162_rn(hv.z, hv.w);
  }

  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int c0 = (threadIdx.x >> 5) * 16;
  // x[ni] += A[16 × 128] · W[:, c0 + 8ni .. + 8] (k ascending, as warp_gemm)
  auto gemm = [&](float (&x)[2][4], const bf16* A, const bf16* W) {
    const bf16* a_base = A + (lane & 15) * kLd + (lane >> 4) * 8;
    const bf16* b_base = W + (lane & 15) * kLd + c0 + (lane >> 4) * 8;
#pragma unroll
    for (int k0 = 0; k0 < 128; k0 += 16) {
      uint32_t a[4], bb[4];
      pipe::ldsm_x4(a, a_base + k0);
      pipe::ldsm_x4_trans(bb, b_base + k0 * kLd);
      pipe::mma_bf16(x[0], a, bb[0], bb[1]);
      pipe::mma_bf16(x[1], a, bb[2], bb[3]);
    }
  };
  float z[2][4] = {}, x[2][4] = {};
  auto step = [&](float (&acc)[2][4], const bf16* A, int stage, int next) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    gemm(acc, A, W_s[stage]);
    __syncthreads();
    gru_panel(next, W_s[stage], wa, uzr, uh);
  };
  step(z, A_s, 0, 2);  // a·W_z
  step(z, H_s, 1, 3);  // h·U_z
  step(x, A_s, 0, 4);  // a·W_r
  step(x, H_s, 1, 5);  // h·U_r
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + (e >> 1) * 8, c = c0 + ni * 8 + 2 * q + (e & 1);
      const float hv = hstate[(row0 + r) * 128 + c];
      z[ni][e] = sigmoid_f(z[ni][e] + b3[c]);
      const float rg = sigmoid_f(x[ni][e] + b3[128 + c]);
      RH_s[r * kLd + c] = __float2bfloat16_rn(rg * hv);
      x[ni][e] = 0.f;
    }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();  // W_h has landed; r⊙h is in RH_s
  gemm(x, A_s, W_s[0]);
  pipe::cp_async_wait_all();
  __syncthreads();
  gemm(x, RH_s, W_s[1]);
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + (e >> 1) * 8, c = c0 + ni * 8 + 2 * q + (e & 1);
      const size_t o = (row0 + r) * 128 + c;
      const float hv = hstate[o];
      const float ht = tanhf(x[ni][e] + b3[256 + c]);
      out[o] = (1.0f - z[ni][e]) * hv + z[ni][e] * ht;
    }
}

}  // namespace tstep
}  // namespace ggnn

// h_pack, msg_w and the GRU weights bf16 (D = 128, tile_e a multiple of
// 16); the layout arrays, dstl_len [n_dstl] (each dstl row's last index
// with a dst id ≥ 0, plus one; 0 for none), item_first / pbase (the hub
// split, common.cuh) and split [n_split] (the blocks of more than one
// item) int32; init,
// hstate f32 [n_blocks·128, 128]; b3 [384] f32; ws n_partial [128, 128]
// f32 slots; out f32 [n_blocks·128, 128].  Returns the cudaError_t of the
// launches (0 = success).
extern "C" int ggnn_typed_step_fused(
    const void* h_pack, long long n_pack, const void* dstl, long long n_dstl,
    const void* tile_start, const void* tile_msg_off, const void* c_off,
    const void* tile_type, const void* dstl_len, const void* msg_w, int T2,
    int n_blocks, int tile_e, int align, const void* item_first,
    const void* pbase, int n_items, const void* split, int n_split,
    const void* init,
    const void* hstate, const void* wa, const void* b3, const void* uzr,
    const void* uh, void* ws, void* out, void* stream) {
  using namespace ggnn::tstep;
  if (n_blocks <= 0 || n_items <= 0) return 0;
  if (tile_e <= 0 || tile_e % 16) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      typed_step_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(kSmem));
  if (err != cudaSuccess) return int(err);
  typed_step_fused_kernel<<<n_items, kThreads, kSmem, s>>>(
      static_cast<const bf16*>(h_pack), n_pack, static_cast<const int*>(dstl),
      n_dstl, static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_msg_off), static_cast<const int*>(c_off),
      static_cast<const int*>(tile_type), static_cast<const int*>(dstl_len),
      static_cast<const bf16*>(msg_w), T2,
      n_blocks, tile_e, align, static_cast<const int*>(item_first),
      static_cast<const int*>(pbase), static_cast<const float*>(init),
      static_cast<const float*>(hstate), static_cast<const bf16*>(wa),
      static_cast<const float*>(b3), static_cast<const bf16*>(uzr),
      static_cast<const bf16*>(uh), static_cast<float*>(ws),
      static_cast<float*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return int(err);
  err = cudaFuncSetAttribute(typed_step_reduce_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kRSmem));
  if (err != cudaSuccess) return int(err);
  typed_step_reduce_kernel<<<n_split * (128 / kRS), kThreads, kRSmem, s>>>(
      static_cast<const int*>(split), static_cast<const int*>(item_first),
      static_cast<const int*>(pbase), static_cast<const float*>(ws),
      static_cast<const float*>(init), static_cast<const float*>(hstate),
      static_cast<const bf16*>(wa), static_cast<const float*>(b3),
      static_cast<const bf16*>(uzr), static_cast<const bf16*>(uh),
      static_cast<float*>(out));
  return int(cudaGetLastError());
}
