// The GRU cell of a 128-row block on the tensor cores for Hopper (sm_90a):
// common.cuh::gru_block's products and rounding points (a·W, then h·U, k
// ascending, into one f32 accumulator; the products' inputs a, h and r⊙h
// in bf16; f32 gates with sigmoid_f and tanhf, f32 h'), in two forms.
// - gru_tile, the epilogue of the fused steps #13 (window_step_fused.cuh),
//   #6 (typed_tile_fused.cu) and #2 (typed_block_fused.cu): 8 warps of 32 ×
//   64 output tiles (window_pipe.cuh), the six [128, 128] weight panels
//   (W_z, U_z, W_r, U_r, W_h, U_h) streamed through two stages by cp.async
//   and read by ldmatrix.trans.
// - gru_strip, the body of #3's bf16 kernel (gru_cell_pipe.cu): the six
//   panels resident in shared memory (load_panels), one warp a 16-row
//   strip of all 128 columns with its operands in registers.
// The pointwise math is common.cuh's (gru_gate, gru_cand, gru_h_next), as
// gru_block's.  (window_pipe.cuh, which #14 includes without common.cuh,
// stays free of the cell's sigmoid.)
#pragma once

#include "common.cuh"
#include "window_pipe.cuh"

namespace ggnn {
namespace wpipe {

// Weight panel pn ([128, 128] of wa [128, 384], uzr [128, 256] or uh
// [128, 128], in the order above) into dst ([128][kLd]) by cp.async, one
// commit group.
__device__ __forceinline__ void gru_panel(int pn, bf16* dst,
                                          const bf16* __restrict__ wa,
                                          const bf16* __restrict__ uzr,
                                          const bf16* __restrict__ uh) {
  const bf16* src = pn == 5 ? uh : (pn & 1) ? uzr : wa;
  const int ld = pn == 5 ? 128 : (pn & 1) ? 256 : 384;
  const int col = pn == 5 ? 0 : (pn >> 1) * 128;
  for (int idx = threadIdx.x; idx < 128 * 16; idx += kThreads) {
    const int k = idx >> 4, v = idx & 15;
    cp16(dst + k * kLd + v * 8, src + size_t(k) * ld + col + v * 8, true);
  }
  pipe::cp_async_commit();
}

// On entry: a in A_s and h in H_s (bf16 [128][kLd]), h's f32 rows at hf
// (rows ldh floats apart, shared or global memory), and panels 0 and 1
// issued into W0 and W1 (gru_panel) as the last two cp.async groups, or
// landed.  r⊙h replaces h in H_s; h' goes to hout (rows ldo floats apart;
// it may be hf: each element is read, then written, by one thread).  RES:
// z and r to the residual rows rrow (a | z | r | h̃, 512 bf16 a row) and
// h̃ into A_s.  The caller synchronizes before it reads hout or A_s.
template <bool RES>
__device__ __forceinline__ void gru_tile(
    bf16* A_s, bf16* H_s, bf16* W0, bf16* W1, const float* hf, int ldh,
    float* hout, int ldo, bf16* rrow, const bf16* __restrict__ wa,
    const float* __restrict__ b3, const bf16* __restrict__ uzr,
    const bf16* __restrict__ uh) {
  using TG = Tile<8>;
  constexpr int kRes = 4 * 128;
  bf16* const W_s[2] = {W0, W1};
  float z[2][8][4], g[2][8][4];
  zero<8>(z);
  zero<8>(g);
  auto step = [&](float (&x)[2][8][4], const bf16* A, int stage, int next) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    mma_bf16<8>(x, A, kLd, W_s[stage], kLd);
    __syncthreads();
    gru_panel(next, W_s[stage], wa, uzr, uh);
  };
  step(z, A_s, 0, 2);  // a·W_z
  step(z, H_s, 1, 3);  // h·U_z
  step(g, A_s, 0, 4);  // a·W_r
  step(g, H_s, 1, 5);  // h·U_r
  // gates; r⊙h replaces h in H_s (every warp is done with H_s)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = TG::row(mi, e), c = TG::col(ni, e);
        const float2 hv = *reinterpret_cast<const float2*>(hf + r * ldh + c);
        const float z0 = gru_gate(z[mi][ni][e], b3[c]);
        const float z1 = gru_gate(z[mi][ni][e + 1], b3[c + 1]);
        const float r0 = gru_gate(g[mi][ni][e], b3[128 + c]);
        const float r1 = gru_gate(g[mi][ni][e + 1], b3[128 + c + 1]);
        z[mi][ni][e] = z0;
        z[mi][ni][e + 1] = z1;
        *reinterpret_cast<__nv_bfloat162*>(H_s + r * kLd + c) =
            __floats2bfloat162_rn(r0 * hv.x, r1 * hv.y);
        if constexpr (RES) {
          *reinterpret_cast<__nv_bfloat162*>(rrow + size_t(r) * kRes + 128 +
                                             c) =
              __floats2bfloat162_rn(z0, z1);
          *reinterpret_cast<__nv_bfloat162*>(rrow + size_t(r) * kRes + 256 +
                                             c) =
              __floats2bfloat162_rn(r0, r1);
        }
      }
  zero<8>(g);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();  // W_h has landed; r⊙h is in H_s
  mma_bf16<8>(g, A_s, kLd, W_s[0], kLd);
  pipe::cp_async_wait_all();
  __syncthreads();
  mma_bf16<8>(g, H_s, kLd, W_s[1], kLd);
  // h' to hout; with RES h̃ to A_s (no warp reads a any more)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = TG::row(mi, e), c = TG::col(ni, e);
        const float2 hv = *reinterpret_cast<const float2*>(hf + r * ldh + c);
        const float h0 = gru_cand(g[mi][ni][e], b3[256 + c]);
        const float h1 = gru_cand(g[mi][ni][e + 1], b3[256 + c + 1]);
        const float z0 = z[mi][ni][e], z1 = z[mi][ni][e + 1];
        *reinterpret_cast<float2*>(hout + r * ldo + c) =
            make_float2(gru_h_next(z0, hv.x, h0), gru_h_next(z1, hv.y, h1));
        if constexpr (RES)
          *reinterpret_cast<__nv_bfloat162*>(A_s + r * kLd + c) =
              __floats2bfloat162_rn(h0, h1);
      }
}

// --- gru_strip: the six panels resident -----------------------------------

constexpr int kPanelBytes = 128 * 256;  // a [128 k][128 n] bf16 panel

// The six panels, in gru_panel's order, into `panels` as they lie in memory:
// panel pn row k (256 bytes) at pn·kPanelBytes + 256·k, its 16-byte chunk c
// at chunk c ^ (k & 7), so that the 8 rows an ldmatrix reads lie in 8
// different bank groups.  cp.async by the CTA's `nthreads` threads, one
// commit group.
__device__ __forceinline__ void load_panels(unsigned char* panels,
                                            const bf16* __restrict__ wa,
                                            const bf16* __restrict__ uzr,
                                            const bf16* __restrict__ uh,
                                            int nthreads) {
  for (int idx = threadIdx.x; idx < 6 * 128 * 16; idx += nthreads) {
    const int pn = idx >> 11, k = (idx >> 4) & 127, c = idx & 15;
    const bf16* src = pn == 5 ? uh + k * 128
                              : (pn & 1 ? uzr + k * 256 : wa + k * 384) +
                                    (pn >> 1) * 128;
    pipe::cp_async16(panels + pn * kPanelBytes + k * 256 + ((c ^ (k & 7)) << 4),
                     src + c * 8);
  }
  pipe::cp_async_commit();
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// acc[t] (the n8-tiles of columns 16j + 8t ..) += A · panel[:, 16j, 16j +
// 16) for the warp's 16 rows, A as 8 m16k16 fragments, k ascending.  B by
// ldmatrix.x4.trans: lane l addresses row 16·kc + (l & 15), chunk 2j +
// (l >> 4).
__device__ __forceinline__ void strip_mma(float (&acc)[2][4],
                                          const uint32_t (&af)[8][4],
                                          uint32_t panel, int j) {
  const int lane = threadIdx.x & 31;
  const int kl = lane & 15, ch = 2 * j + (lane >> 4);
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    const int k = 16 * kc + kl;
    uint32_t b[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
        : "r"(panel + k * 256 + ((ch ^ (k & 7)) << 4)));
    pipe::mma_bf16(acc[0], af[kc], b[0], b[1]);
    pipe::mma_bf16(acc[1], af[kc], b[2], b[3]);
  }
}

// One fragment row of a 16-column group of a bf16 array: p0 holds the
// lane's columns 2q, 2q + 1 of the group's first n8-tile, p1 those of its
// second (q = lane & 3).  Two shuffles in the quad give lane q the columns
// 4q .. 4q + 3, so the quad stores the group's 32 bytes of the row, one
// whole sector, with one 8-byte store a lane.
__device__ __forceinline__ void store_group(bf16* __restrict__ row,
                                            uint32_t p0, uint32_t p1) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  // lane 1 takes lane 2's p0, lane 2 lane 1's p1
  const uint32_t x = __shfl_xor_sync(0xffffffffu, q >= 2 ? p0 : p1, 3);
  // lane 0 takes lane 1's p0, 1 lane 3's p0, 2 lane 0's p1, 3 lane 2's p1
  const uint32_t y = __shfl_sync(0xffffffffu, q & 1 ? p0 : p1,
                                 (lane & ~3) | ((0x2031 >> (4 * q)) & 3));
  const uint32_t w0 = q == 0 ? p0 : (q == 1 ? x : y);
  const uint32_t w1 = q == 3 ? p1 : (q == 2 ? x : y);
  *reinterpret_cast<uint2*>(row + 4 * q) = make_uint2(w0, w1);
}

// The f32 h of the lane's fragment elements in column group j (rows g and
// g + 8 of n8-tiles 2j and 2j + 1), read before the group's products.
__device__ __forceinline__ void load_group(const float* __restrict__ h,
                                           int j, float2 (&hv)[2][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      hv[t][hr] = __ldg(reinterpret_cast<const float2*>(
          h + (g + 8 * hr) * 128 + 16 * j + 8 * t + 2 * q));
}

// The cell on one warp's 16-row strip of all 128 columns.  af, hf: a and h
// rounded to bf16 as m16k16 A fragments (k chunk kc: rows g, g + 8 of lane
// 4g + q, columns 16kc + 2q, + 1 and 16kc + 8 + 2q, + 1); panels: the six
// resident panels (load_panels); b_s: the f32 biases [3·128] in shared
// memory; h: the strip's f32 state rows (128 floats apart), read again
// where the f32 h enters (load_group); outputs the strip's rows of h' (f32), z, r and h̃ (bf16).
// 1. r = σ(a·W_r + h·U_r + b_r), 16 columns at a time; r⊙h is rounded to
//    bf16 straight into the A fragments of the last product: the C
//    fragments of the n8-tiles 2kc and 2kc + 1 are the A fragment of k
//    chunk kc, element for element.
// 2. z = σ(a·W_z + h·U_z + b_z) and h̃ = tanh(a·W_h + (r⊙h)·U_h + b_h),
//    16 columns at a time, then h' = (1 − z)·h + z·h̃.
// Each output element sees gru_block's products in gru_block's order.
__device__ __forceinline__ void gru_strip(
    const uint32_t (&af)[8][4], const uint32_t (&hf)[8][4], uint32_t panels,
    const float* b_s, const float* __restrict__ h, float* __restrict__ out_h,
    bf16* __restrict__ out_z, bf16* __restrict__ out_r,
    bf16* __restrict__ out_ht) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  uint32_t rf[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float2 hv4[2][2];
    load_group(h, j, hv4);
    float acc[2][4] = {};
    strip_mma(acc, af, panels + 2 * kPanelBytes, j);  // a·W_r
    strip_mma(acc, hf, panels + 3 * kPanelBytes, j);  // h·U_r
    uint32_t rp[2][2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int c = 16 * j + 8 * t + 2 * q;
        const float2 hv = hv4[t][hr];
        const float2 b = *reinterpret_cast<const float2*>(b_s + 128 + c);
        const float r0 = gru_gate(acc[t][2 * hr], b.x);
        const float r1 = gru_gate(acc[t][2 * hr + 1], b.y);
        rf[j][2 * t + hr] = pack2(r0 * hv.x, r1 * hv.y);
        rp[hr][t] = pack2(r0, r1);
      }
    store_group(out_r + g * 128 + 16 * j, rp[0][0], rp[0][1]);
    store_group(out_r + (g + 8) * 128 + 16 * j, rp[1][0], rp[1][1]);
  }
#pragma unroll 1
  for (int j = 0; j < 8; ++j) {
    float2 hv4[2][2];
    load_group(h, j, hv4);
    float za[2][4] = {}, ta[2][4] = {};
    strip_mma(za, af, panels, j);                     // a·W_z
    strip_mma(za, hf, panels + kPanelBytes, j);       // h·U_z
    strip_mma(ta, af, panels + 4 * kPanelBytes, j);   // a·W_h
    strip_mma(ta, rf, panels + 5 * kPanelBytes, j);   // (r⊙h)·U_h
    uint32_t zp[2][2], tp[2][2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = g + 8 * hr, c = 16 * j + 8 * t + 2 * q;
        const float2 hv = hv4[t][hr];
        const float2 bz = *reinterpret_cast<const float2*>(b_s + c);
        const float2 bh = *reinterpret_cast<const float2*>(b_s + 256 + c);
        const float z0 = gru_gate(za[t][2 * hr], bz.x);
        const float z1 = gru_gate(za[t][2 * hr + 1], bz.y);
        const float h0 = gru_cand(ta[t][2 * hr], bh.x);
        const float h1 = gru_cand(ta[t][2 * hr + 1], bh.y);
        *reinterpret_cast<float2*>(out_h + row * 128 + c) =
            make_float2(gru_h_next(z0, hv.x, h0), gru_h_next(z1, hv.y, h1));
        zp[hr][t] = pack2(z0, z1);
        tp[hr][t] = pack2(h0, h1);
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int o = (g + 8 * hr) * 128 + 16 * j;
      store_group(out_z + o, zp[hr][0], zp[hr][1]);
      store_group(out_ht + o, tp[hr][0], tp[hr][1]);
    }
  }
}

}  // namespace wpipe
}  // namespace ggnn
