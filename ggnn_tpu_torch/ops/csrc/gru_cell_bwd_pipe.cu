// GRU cell backward for Hopper (sm_90a), bf16 at D = 128: kernel #4's
// redesign.
//
// Replaces ggnn_tpu/ops/gru_pallas.py::gru_cell_bwd (_bwd_kernel) for bf16
// residuals and D = 128; f32 and D = 128·P keep gru_cell_bwd.cu and
// gru_cell_wide.cu.  The function is gru_cell_bwd.cu's: dq = g·z·(1 − h̃²),
// dpz = g·(h̃ − h)·z·(1 − z), drh = dq·U_hᵀ, dpr = drh·h·r·(1 − r),
// dh = g·(1 − z) + drh·r + dpz·U_zᵀ + dpr·U_rᵀ (f32), da = dpz·W_zᵀ +
// dpr·W_rᵀ + dq·W_hᵀ (f32 or bf16), dW_a = aᵀ·[dpz | dpr | dq], dU_zr =
// hᵀ·[dpz | dpr], dU_h = (r·h)ᵀ·dq, db = Σ_rows [dpz | dpr | dq]; every
// product input rounded to bf16 (the gate gradients too; r·h formed in f32
// and rounded once), f32 accumulation, db summed from the f32 gate
// gradients, every sum in a fixed order and no float atomics.
//
// Bound on this card: HBM bytes.  At the headline (262,144 rows) the
// function reads g (134 MB) and five residuals (336 MB) and writes dh and
// da (268 MB): 0.74 GB, 0.221 ms at 3.35 TB/s.  Its products (103 GFLOP)
// take 0.10 ms at the dense bf16 rate.  The split into passes adds the gate
// workspace (201 MB written, read back) and a second read of a, h and r.
//
// 1. Rows: persistent, one CTA of 8 warps an SM, each walking a contiguous
//    range of 128-row blocks as 32-row sub-blocks.  The six weight panels
//    (U_h, W_h, W_z, W_r, U_z, U_r: 192 KB of bf16) are loaded once into
//    shared memory as they lie in memory, [n][k] rows with 16-byte chunks
//    XOR-swizzled by the row, and stay resident: a product x·Wᵀ reads B
//    through the non-transposing ldmatrix, and no product waits on a weight
//    copy.  Warp w owns rows 16·(w & 1) and columns 32·(w >> 1) of a
//    sub-block.  Its g, z, h, r and h̃ are loaded straight into registers in
//    the mma fragment layout (32-byte sectors whole), one sub-block ahead:
//    g, z and h̃ are fetched for the next sub-block as soon as the gates of
//    this one are formed, h and r once dpr is; each value is read from
//    global memory once.  The gate gradients go through shared memory as
//    the A operands of the products and leave to the workspace as 16-byte
//    rows; dh and da leave from the accumulators as whole 32-byte sectors.
//    The four warps of a row strip synchronise by a named barrier.  db's
//    column sums: per strip over the sub-blocks of a block, then the two
//    strips, into one partial per 128-row block.
// 2. Params: split-K over chunks of 16 blocks, one CTA per (product,
//    chunk) with the product index fastest, so that the six CTAs reading
//    one chunk run side by side and share its rows in L2.  64-row K-steps
//    of x and y stream through a two-stage cp.async ring; the xᵀ operand is
//    read by ldmatrix.trans as the rows lie (r·h formed in shared memory).
// 3. Reduce: one thread per parameter-gradient element sums the chunk
//    partials in chunk order; db's block partials are summed by 8 warps a
//    32-column group in a fixed interleave, then the 8 sums in order.
// Every split is fixed by N alone: the same bits on every card.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "mma_pipe.cuh"

namespace ggnn {
namespace gbwd {

using pipe::bf16;
using pipe::kLd;

constexpr int kThreads = 256;
constexpr int kSub = 32;                         // rows of a sub-block
constexpr int kSubs = kRows / kSub;              // sub-blocks of a block
constexpr int kPanel = 128 * 256;                // bytes of a weight panel
constexpr size_t kW = size_t(6) * kPanel;        // 196,608
constexpr size_t kA = size_t(kSub) * kLd * sizeof(bf16);  // 8,704
constexpr size_t kRed = size_t(2) * 3 * 2 * 128 * sizeof(float);
constexpr size_t kRowsSmem = kW + 3 * kA + kRed;  // 228,864
constexpr int kBlocksPerChunk = 16;              // as gru_cell_bwd.cu
constexpr int kKStep = 64;                       // params pass K-step rows
constexpr size_t kTile = size_t(kKStep) * kLd * sizeof(bf16);  // 17,408
constexpr size_t kParSmem = 2 * 3 * kTile;       // 104,448

__device__ __forceinline__ void ldsm_x4_addr(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The 128 threads of row strip s (warps s, s + 2, s + 4, s + 6).
__device__ __forceinline__ void strip_sync(int s) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + s) : "memory");
}

__device__ __forceinline__ float2 bf2(uint32_t v) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return __bfloat1622float2(x);
}
__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&x);
}
__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// acc[4 n-tiles][4] += A[16-row strip][128 k] · panel[k][32 columns from
// c0]: A row-major [.][kLd] by ldmatrix, the panel B[k][n] = W[n][k] as W's
// rows lie (row n at n·256 bytes, 16-byte chunk c at (c ^ (n & 7))·16).
__device__ __forceinline__ void strip_mma(float (&acc)[4][4], const bf16* A,
                                          uint32_t panel, int c0) {
  const int lane = threadIdx.x & 31;
  const bf16* a_base = A + (lane & 15) * kLd + (lane >> 4) * 8;
  const int nl = ((lane >> 4) << 3) + (lane & 7), kl = (lane >> 3) & 1;
#pragma unroll
  for (int k0 = 0; k0 < 128; k0 += 16) {
    uint32_t a[4];
    pipe::ldsm_x4(a, a_base + k0);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const int n = c0 + nj * 16 + nl, kc = (k0 >> 3) + kl;
      uint32_t b[4];
      ldsm_x4_addr(b, panel + n * 256 + ((kc ^ (n & 7)) << 4));
      pipe::mma_bf16(acc[2 * nj], a, b[0], b[1]);
      pipe::mma_bf16(acc[2 * nj + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero4(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
}

// The strip's 16 column sums of v (rows g and g + 8 of each lane, then the
// 8 row groups), added to red[col] by lanes 0-3 (the column's one writer).
__device__ __forceinline__ void colsum(const float (&v)[4][4], float* red,
                                       int c0, bool first) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float s = v[ni][q] + v[ni][q + 2];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) {
        float* p = red + c0 + ni * 8 + 2 * lane + q;
        *p = first ? s : *p + s;
      }
    }
}

// The strip's 16 rows of gate tile A_s to gates[row0 ...] as 16-byte rows.
__device__ __forceinline__ void store_gate(bf16* __restrict__ dst,
                                           const bf16* A_s, int strip) {
  const int ts = (threadIdx.x >> 6) * 32 + (threadIdx.x & 31);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int v = ts + 128 * k, r = 16 * strip + v / 16, c = (v % 16) * 8;
    *reinterpret_cast<uint4*>(dst + size_t(r) * 128 + c) =
        *reinterpret_cast<const uint4*>(A_s + r * kLd + c);
  }
}

template <typename TD>
__device__ __forceinline__ void store_pair(TD* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a,
                                                  float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf2(a, b);
}

template <typename TD>
__global__ void __launch_bounds__(kThreads, 1) gru_bwd_rows_bf16(
    const float* __restrict__ g, const bf16* __restrict__ h,
    const bf16* __restrict__ z, const bf16* __restrict__ r,
    const bf16* __restrict__ ht, const bf16* __restrict__ wa,
    const bf16* __restrict__ uzr, const bf16* __restrict__ uh,
    float* __restrict__ dh, TD* __restrict__ da, bf16* __restrict__ gates,
    float* __restrict__ dbp, int n_blocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t W_s = pipe::smem_addr(smem);
  bf16* P_s = reinterpret_cast<bf16*>(smem + kW);        // dpz
  bf16* Q_s = reinterpret_cast<bf16*>(smem + kW + kA);   // dq
  bf16* R_s = reinterpret_cast<bf16*>(smem + kW + 2 * kA);  // dpr
  float* red = reinterpret_cast<float*>(smem + kW + 3 * kA);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int strip = warp & 1, c0 = (warp >> 1) * 32;
  const size_t n_elems = size_t(n_blocks) * kRows * 128;
  bf16* gz = gates;
  bf16* gr = gates + n_elems;
  bf16* gq = gates + 2 * n_elems;
  const int b0 = int((long long)n_blocks * blockIdx.x / gridDim.x);
  const int b1 = int((long long)n_blocks * (blockIdx.x + 1) / gridDim.x);
  const int s0 = b0 * kSubs, s1 = b1 * kSubs;

  // the six panels, once: panel p row n = W[n][col0 .. col0 + 128)
  auto load_panels = [&]() {
    for (int idx = tid; idx < 6 * 128 * 16; idx += kThreads) {
      const int p = idx >> 11, n = (idx >> 4) & 127, c = idx & 15;
      const bf16* src =
          p == 0 ? uh + n * 128
                 : (p < 4 ? wa + n * 384 + (p == 1 ? 256 : (p - 2) * 128)
                          : uzr + n * 256 + (p - 4) * 128);
      pipe::cp_async16(smem + p * kPanel + n * 256 + ((c ^ (n & 7)) << 4),
                       src + c * 8);
    }
    pipe::cp_async_commit();
  };
  load_panels();

  // this lane's fragment elements: rows rw + 8·hr, columns cl + 8·ni + {0,1}
  const int rw = 16 * strip + (lane >> 2), cl = c0 + 2 * (lane & 3);
  float2 gv[4][2];
  uint32_t zv[4][2], tv[4][2], hv[4][2], rv[4][2];
  auto at = [&](int s, int ni, int hr) {
    return (size_t(s) * kSub + rw + 8 * hr) * 128 + cl + 8 * ni;
  };
  auto load_gzt = [&](int s) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const size_t i = at(s, ni, hr);
        gv[ni][hr] = __ldg(reinterpret_cast<const float2*>(g + i));
        zv[ni][hr] = ldg32(z + i);
        tv[ni][hr] = ldg32(ht + i);
      }
  };
  auto load_hr = [&](int s) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const size_t i = at(s, ni, hr);
        hv[ni][hr] = ldg32(h + i);
        rv[ni][hr] = ldg32(r + i);
      }
  };
  if (s0 < s1) {
    load_gzt(s0);
    load_hr(s0);
  }
  pipe::cp_async_wait_all();
  __syncthreads();

  const bf16* Pw = P_s + 16 * strip * kLd;
  const bf16* Qw = Q_s + 16 * strip * kLd;
  const bf16* Rw = R_s + 16 * strip * kLd;
  for (int s = s0; s < s1; ++s) {
    const int sub = s % kSubs;
    float* rb = red + ((s / kSubs) & 1) * (3 * 2 * 128) + strip * 128;
    const size_t row0 = size_t(s) * kSub;
    float acc1[4][4], acc2[4][4], dh0[4][4], v1[4][4], v2[4][4];

    strip_sync(strip);  // the strip is done with the last sub-block's tiles
    // dq and dpz; dh's first term g·(1 − z)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float2 gg = gv[ni][hr], zz = bf2(zv[ni][hr]),
                     hh = bf2(hv[ni][hr]), tt = bf2(tv[ni][hr]);
        const float gx[2] = {gg.x, gg.y}, zx[2] = {zz.x, zz.y},
                    hx[2] = {hh.x, hh.y}, tx[2] = {tt.x, tt.y};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          v1[ni][2 * hr + q] = (gx[q] * zx[q]) * (1.0f - tx[q] * tx[q]);
          v2[ni][2 * hr + q] =
              (gx[q] * (tx[q] - hx[q])) * zx[q] * (1.0f - zx[q]);
          dh0[ni][2 * hr + q] = gx[q] * (1.0f - zx[q]);
        }
        const int o = (rw + 8 * hr) * kLd + cl + 8 * ni;
        *reinterpret_cast<uint32_t*>(Q_s + o) =
            pack_bf2(v1[ni][2 * hr], v1[ni][2 * hr + 1]);
        *reinterpret_cast<uint32_t*>(P_s + o) =
            pack_bf2(v2[ni][2 * hr], v2[ni][2 * hr + 1]);
      }
    colsum(v2, rb, c0, sub == 0);                 // db_z
    colsum(v1, rb + 2 * 2 * 128, c0, sub == 0);   // db_h
    if (s + 1 < s1) load_gzt(s + 1);
    strip_sync(strip);  // the strip's rows of Q_s and P_s are complete
    store_gate(gq + row0 * 128, Q_s, strip);
    store_gate(gz + row0 * 128, P_s, strip);

    zero4(acc1);
    zero4(acc2);
    strip_mma(acc1, Qw, W_s + 0 * kPanel, c0);   // drh = dq·U_hᵀ
    strip_mma(acc2, Qw, W_s + 1 * kPanel, c0);   // da = dq·W_hᵀ
    strip_mma(acc2, Pw, W_s + 2 * kPanel, c0);   //    + dpz·W_zᵀ

    // dpr; acc1 becomes g·(1 − z) + drh·r
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float2 hh = bf2(hv[ni][hr]), rr = bf2(rv[ni][hr]);
        const float hx[2] = {hh.x, hh.y}, rx[2] = {rr.x, rr.y};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int e = 2 * hr + q;
          const float drh = acc1[ni][e];
          v1[ni][e] = (drh * hx[q]) * rx[q] * (1.0f - rx[q]);
          acc1[ni][e] = dh0[ni][e] + drh * rx[q];
        }
        *reinterpret_cast<uint32_t*>(R_s + (rw + 8 * hr) * kLd + cl +
                                     8 * ni) =
            pack_bf2(v1[ni][2 * hr], v1[ni][2 * hr + 1]);
      }
    colsum(v1, rb + 2 * 128, c0, sub == 0);       // db_r
    if (s + 1 < s1) load_hr(s + 1);
    strip_sync(strip);  // the strip's rows of R_s are complete
    store_gate(gr + row0 * 128, R_s, strip);

    strip_mma(acc2, Rw, W_s + 3 * kPanel, c0);   //    + dpr·W_rᵀ
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        store_pair(da + (row0 + rw + 8 * hr) * 128 + cl + 8 * ni,
                   acc2[ni][2 * hr], acc2[ni][2 * hr + 1]);
    strip_mma(acc1, Pw, W_s + 4 * kPanel, c0);   // dh += dpz·U_zᵀ
    strip_mma(acc1, Rw, W_s + 5 * kPanel, c0);   //     + dpr·U_rᵀ
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        store_pair(dh + (row0 + rw + 8 * hr) * 128 + cl + 8 * ni,
                   acc1[ni][2 * hr], acc1[ni][2 * hr + 1]);

    if (sub == kSubs - 1) {
      // db's partial of the block: strip 0 + strip 1 (each summed over the
      // sub-blocks in order); red is double-buffered by block parity, so
      // one barrier a block suffices
      __syncthreads();
      const float* rr = red + ((s / kSubs) & 1) * (3 * 2 * 128);
      for (int j = tid; j < 3 * 128; j += kThreads) {
        const int gate = j >> 7, c = j & 127;
        dbp[size_t(s / kSubs) * 384 + j] =
            rr[gate * 256 + c] + rr[gate * 256 + 128 + c];
      }
    }
  }
}

// Partial over chunk blockIdx.y of product p = blockIdx.x:
//   p = 0, 1, 2: aᵀ·dpz, aᵀ·dpr, aᵀ·dq;  p = 3, 4: hᵀ·dpz, hᵀ·dpr;
//   p = 5: (r·h)ᵀ·dq, r·h taken in f32 and rounded to bf16.
// ws[chunk][p] is [128 m][128 n] f32 row-major.
__global__ void __launch_bounds__(kThreads, 2) gru_bwd_params_bf16(
    const bf16* __restrict__ h, const bf16* __restrict__ a,
    const bf16* __restrict__ r, const bf16* __restrict__ gates,
    float* __restrict__ ws, int n_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTileElems = kKStep * kLd;
  bf16* S = reinterpret_cast<bf16*>(smem);  // stage st: x, y, r at 3·st
  const int p = blockIdx.x, chunk = blockIdx.y, tid = threadIdx.x;
  const size_t n_elems = size_t(n_blocks) * kRows * 128;
  const bf16* x = p < 3 ? a : h;
  const bf16* y = gates + size_t(p < 3 ? p : (p < 5 ? p - 3 : 2)) * n_elems;
  const long long r0 = (long long)chunk * kBlocksPerChunk * kRows;
  const long long r_end = (long long)n_blocks * kRows;
  const long long r1 = r0 + (long long)kBlocksPerChunk * kRows < r_end
                           ? r0 + (long long)kBlocksPerChunk * kRows
                           : r_end;
  const int nk = int((r1 - r0) / kKStep);

  auto stage = [&](int j, int st) {
    bf16* xs = S + (3 * st) * kTileElems;
    bf16* ys = xs + kTileElems;
    bf16* rs = ys + kTileElems;
    const size_t base = size_t(r0 + (long long)j * kKStep) * 128;
    for (int idx = tid; idx < kKStep * 16; idx += kThreads) {
      const int k = idx >> 4, c = (idx & 15) * 8;
      pipe::cp_async16(xs + k * kLd + c, x + base + k * 128 + c);
      pipe::cp_async16(ys + k * kLd + c, y + base + k * 128 + c);
      if (p == 5) pipe::cp_async16(rs + k * kLd + c, r + base + k * 128 + c);
    }
    pipe::cp_async_commit();
  };

  pipe::WarpTile tile;
  tile.zero();
  const int lane = tid & 31;
  // A = xᵀ through ldmatrix.trans: lane l addresses x row k0 + 8·(l >> 4)
  // + (l & 7), column m0 + 8·((l >> 3) & 1)
  const int ak = ((lane >> 4) << 3) + (lane & 7), am = ((lane >> 3) & 1) * 8;
  stage(0, 0);
  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    pipe::cp_async_wait_all();
    __syncthreads();  // stage st landed; every warp is done with st ^ 1
    if (j + 1 < nk) stage(j + 1, st ^ 1);
    bf16* xs = S + (3 * st) * kTileElems;
    const bf16* ys = xs + kTileElems;
    if (p == 5) {  // x = bf16(f32(r)·f32(h)), in place
      const bf16* rs = ys + kTileElems;
      for (int idx = tid; idx < kKStep * 64; idx += kThreads) {
        const int k = idx >> 6, c = (idx & 63) * 2;
        uint32_t* px = reinterpret_cast<uint32_t*>(xs + k * kLd + c);
        const float2 hh = bf2(*px);
        const float2 rr =
            bf2(*reinterpret_cast<const uint32_t*>(rs + k * kLd + c));
        *px = pack_bf2(rr.x * hh.x, rr.y * hh.y);
      }
      __syncthreads();
    }
    const bf16* b_base = ys + (lane & 15) * kLd + pipe::WarpTile::col0() +
                         (lane >> 4) * 8;
#pragma unroll
    for (int k0 = 0; k0 < kKStep; k0 += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        pipe::ldsm_x4_trans(af[mi], xs + (k0 + ak) * kLd +
                                        pipe::WarpTile::row0() + 16 * mi +
                                        am);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        pipe::ldsm_x4_trans(b, b_base + k0 * kLd + nj * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          pipe::mma_bf16(tile.acc[mi][2 * nj], af[mi], b[0], b[1]);
          pipe::mma_bf16(tile.acc[mi][2 * nj + 1], af[mi], b[2], b[3]);
        }
      }
    }
  }
  float* out = ws + (size_t(chunk) * 6 + p) * 128 * 128;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<float2*>(out + pipe::WarpTile::row(mi, e) * 128 +
                                   pipe::WarpTile::col(ni, e)) =
            make_float2(tile.acc[mi][ni][e], tile.acc[mi][ni][e + 1]);
}

// Blocks [0, 384): one thread per element of the six [128, 128] products,
// summing the chunk partials in chunk order.  Blocks [384, 396): db's 32
// columns 32·(b − 384) ..; warp w sums the block partials w, w + 8, ... in
// turn, then lane c of warp 0 the 8 warp sums in order.
constexpr int kProdBlocks = 6 * 128 * 128 / kThreads;  // 384
constexpr int kDbBlocks = 3 * 128 / 32;                 // 12

__global__ void __launch_bounds__(kThreads) gru_bwd_reduce_bf16(
    const float* __restrict__ ws, const float* __restrict__ dbp,
    int n_chunks, int n_blocks, float* __restrict__ dwa,
    float* __restrict__ db, float* __restrict__ duzr,
    float* __restrict__ duh) {
  constexpr int kProd = 128 * 128;
  if (blockIdx.x < kProdBlocks) {
    const int idx = blockIdx.x * kThreads + threadIdx.x;
    const int p = idx / kProd, rem = idx % kProd;
    const int m = rem >> 7, n = rem & 127;
    const float* src = ws + size_t(p) * kProd + rem;
    float s = 0.0f;
#pragma unroll 16
    for (int ch = 0; ch < n_chunks; ++ch) s += src[size_t(ch) * 6 * kProd];
    if (p < 3)
      dwa[m * 384 + p * 128 + n] = s;
    else if (p < 5)
      duzr[m * 256 + (p - 3) * 128 + n] = s;
    else
      duh[m * 128 + n] = s;
    return;
  }
  __shared__ float part[8][32];
  const int col = (blockIdx.x - kProdBlocks) * 32 + (threadIdx.x & 31);
  const int w = threadIdx.x >> 5;
  float s = 0.0f;
#pragma unroll 16
  for (int b = w; b < n_blocks; b += 8) s += dbp[size_t(b) * 384 + col];
  part[w][threadIdx.x & 31] = s;
  __syncthreads();
  if (w == 0) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += part[k][threadIdx.x & 31];
    db[col] = t;
  }
}

}  // namespace gbwd

// bf16 residuals at D = 128 (gru_cell_bwd.cu's entry point calls this for
// dtype 1): the arguments of ggnn_gru_cell_bwd; ws holds n_chunks (N / 128
// blocks in chunks of 16) × 6 × 128 × 128 f32.
template <typename TD>
int launch_gru_bwd_bf16(const void* g, const void* h, const void* a,
                        const void* z, const void* r, const void* ht,
                        const void* wa, const void* uzr, const void* uh,
                        void* dh, void* da, void* gates, void* dbp, void* ws,
                        void* dwa, void* db, void* duzr, void* duh,
                        int n_blocks, cudaStream_t stream) {
  using gbwd::bf16;
  auto rows = gbwd::gru_bwd_rows_bf16<TD>;
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(gbwd::kRowsSmem));
  if (err != cudaSuccess) return int(err);
  const int n_ctas = std::min(n_blocks, pipe::multiprocessors());
  rows<<<n_ctas, gbwd::kThreads, gbwd::kRowsSmem, stream>>>(
      static_cast<const float*>(g), static_cast<const bf16*>(h),
      static_cast<const bf16*>(z), static_cast<const bf16*>(r),
      static_cast<const bf16*>(ht), static_cast<const bf16*>(wa),
      static_cast<const bf16*>(uzr), static_cast<const bf16*>(uh),
      static_cast<float*>(dh), static_cast<TD*>(da), static_cast<bf16*>(gates),
      static_cast<float*>(dbp), n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const int n_chunks =
      (n_blocks + gbwd::kBlocksPerChunk - 1) / gbwd::kBlocksPerChunk;
  err = cudaFuncSetAttribute(gbwd::gru_bwd_params_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(gbwd::kParSmem));
  if (err != cudaSuccess) return int(err);
  gbwd::gru_bwd_params_bf16<<<dim3(6, n_chunks), gbwd::kThreads,
                              gbwd::kParSmem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(a),
      static_cast<const bf16*>(r), static_cast<const bf16*>(gates),
      static_cast<float*>(ws), n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  gbwd::gru_bwd_reduce_bf16<<<gbwd::kProdBlocks + gbwd::kDbBlocks,
                              gbwd::kThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(dbp), n_chunks,
      n_blocks, static_cast<float*>(dwa), static_cast<float*>(db),
      static_cast<float*>(duzr), static_cast<float*>(duh));
  return int(cudaGetLastError());
}

template int launch_gru_bwd_bf16<float>(const void*, const void*, const void*,
                                        const void*, const void*, const void*,
                                        const void*, const void*, const void*,
                                        void*, void*, void*, void*, void*,
                                        void*, void*, void*, void*, int,
                                        cudaStream_t);
template int launch_gru_bwd_bf16<__nv_bfloat16>(
    const void*, const void*, const void*, const void*, const void*,
    const void*, const void*, const void*, const void*, void*, void*, void*,
    void*, void*, void*, void*, void*, void*, int, cudaStream_t);

}  // namespace ggnn
