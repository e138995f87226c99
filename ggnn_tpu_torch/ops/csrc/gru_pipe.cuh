// The GRU epilogue of a 128-row block on the tensor cores for Hopper
// (sm_90a), shared by the fused steps #13 (window_step_fused.cuh) and #6
// (typed_tile_fused.cu): common.cuh::gru_block's products and rounding
// points (a·W, then h·U, k ascending; the products' inputs a, h and r⊙h in
// bf16; f32 gates and h'), 8 warps of 32 × 64 output tiles
// (window_pipe.cuh), the six [128, 128] weight panels (W_z, U_z, W_r, U_r,
// W_h, U_h) streamed through two stages by cp.async and read by
// ldmatrix.trans.  (window_pipe.cuh, which #14 includes without
// common.cuh, stays free of the cell's sigmoid.)
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
        const float z0 = sigmoid_f(z[mi][ni][e] + b3[c]);
        const float z1 = sigmoid_f(z[mi][ni][e + 1] + b3[c + 1]);
        const float r0 = sigmoid_f(g[mi][ni][e] + b3[128 + c]);
        const float r1 = sigmoid_f(g[mi][ni][e + 1] + b3[128 + c + 1]);
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
        const float h0 = tanhf(g[mi][ni][e] + b3[256 + c]);
        const float h1 = tanhf(g[mi][ni][e + 1] + b3[256 + c + 1]);
        const float z0 = z[mi][ni][e], z1 = z[mi][ni][e + 1];
        *reinterpret_cast<float2*>(hout + r * ldo + c) =
            make_float2((1.0f - z0) * hv.x + z0 * h0,
                        (1.0f - z1) * hv.y + z1 * h1);
        if constexpr (RES)
          *reinterpret_cast<__nv_bfloat162*>(A_s + r * kLd + c) =
              __floats2bfloat162_rn(h0, h1);
      }
}

}  // namespace wpipe
}  // namespace ggnn
