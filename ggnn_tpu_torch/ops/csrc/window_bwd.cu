// The window backend's fused backward for Hopper (sm_90a).
//
// Replaces _window_bwd_fused_kernel of ggnn_tpu/ops/window_pallas.py (run by
// window_bwd_fused, #14): the backward of the window aggregation, without
// the [T2·N, D] intermediate Y ever reaching device memory.  The forward
// added count · table row (h_u·W_t + b_t, block-major rows: row = (u / 128)·
// T2·128 + t·128 + u % 128) into each dst row; its backward for the rows of
// source block b and type t is the slab
//   Y_t,b [128, D] = Σ_{real tiles (w, B) of window w} C_(B,w)ᵀ · ā_B,
// window w = b·wpb + t / S holding types S·(t / S) .. S·(t / S) + S − 1
// (S = W / 128, wpb = T2·128 / W), C_(B,w) the FORWARD count tile [BR, W]
// of dst block B (read at gt_c_off, its columns (t % S)·128 .. + 127), ā_B
// the cotangent's rows of that block (the kernel takes āᵀ [D, n_blocks·BR],
// as the TPU kernel does); then, with Y_t,b rounded to the compute dtype T
// (the TPU kernel's rounding point):
//   dhᵀ[:, b] = Σ_t W_t · Y_t,bᵀ      and     dWᵀ_t += Y_t,bᵀ · h_b.
// With `quant` (int8 gradients) āᵀ is int8 with one power-of-2 scale per
// dst block: each tile's product is exact in int32 (mma.sync s8·s8 → s32,
// the counts int8 too) and joins the f32 sum as float(product) · scale[B].
// A window with no real tile (only its dummy, win < 0) gives a zero slab
// and is skipped: it adds exactly nothing (the TPU kernel's `nonempty`).
// The bias gradient is not here: one [T2, N]·[N, D] product outside.
//
// Design.  The TPU kernel walks every backward tile in one sequential grid,
// keeping one source block's windows and a 1 MB dWᵀ accumulator in VMEM.
// - bf16 at D = 128 with W of 128, 256 or 512 (exact and int8 ā) runs
//   window_bwd_fused.cu: every operand read as it lies (Yᵀ = āᵀ · C, the
//   count tile's rows as the B operand), one staging of each āᵀ chunk for
//   the S = W / 128 slabs of a window (a thread-block cluster of S CTAs
//   sharing it through distributed shared memory), copies in flight
//   during the products, and dWᵀ kept in registers across a group of
//   source blocks (written once per group and type).
// - f32, and bf16 at D = 128·P > 128, keep the first version (below): one
//   CTA (8 warps, 16 rows each) takes a group of consecutive source blocks
//   and one 128-column panel dp of dh (grid y: P = D / 128 panels), and
//   walks, for each block b, its T2 slabs in type order and each slab's
//   128-column panels fp in order: the slab panel Y_t,b[:, fp] accumulates
//   in registers over the window's real tiles in list order and over BR in
//   K-chunks of 128 (the chunk of Cᵀ transposed by scalar stores and ā's
//   columns fp staged in shared memory, nothing in flight); it is rounded
//   to T into shared memory twice (Y and Yᵀ), then dh_b[:, dp] +=
//   Y[:, fp]·W_t[dp, fp]ᵀ stays in registers across the slabs and panels,
//   and the group's dWᵀ_t[fp, dp] partial [128, 128] f32 in the zeroed
//   workspace gains Y[:, fp]ᵀ·h_b[:, dp] (a read-modify-write per slab;
//   each element read and written by one thread of one CTA only).  At
//   D = 128·P each of the P dp panels computes all P Y panels (the count
//   products P times, P² in all).
// A second kernel sums the groups' dWᵀ partials in group order.  Every sum
// runs in one fixed order: the same bits on every run, no atomics.
//
// Bound on this card: the bytes (the count stream's real tiles, āᵀ once, h,
// the outputs; 2.15 GB of counts at the community headline).
#include "window_step.cuh"

namespace ggnn {

// NP: D / 128, the column panels, a template argument (1 or 2) so that the
// D = 128 and 256 kernels keep their unrolled panel loops and address
// arithmetic (at D = 256 NP = 2 gains about 1 % over NP = 0 on an H100);
// NP = 0 takes the panel count from the grid (gridDim.y), for every wider
// D.
template <typename T, bool QUANT, int NP>
__global__ void __launch_bounds__(kThreads) window_bwd_kernel(
    const void* __restrict__ dat, const float* __restrict__ scales,
    long long n_cols, const int8_t* __restrict__ counts, long long n_c,
    const int* __restrict__ gt_start, const int* __restrict__ gt_win,
    const int* __restrict__ gt_c_off, int n_dst_blocks, int BR, int W,
    int T2, int n_src_blocks, int group, const T* __restrict__ msg_w,
    const T* __restrict__ h, float* __restrict__ dht,
    float* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  T* P = reinterpret_cast<T*>(smem);                      // Cᵀ chunk, then Y
  T* Q = reinterpret_cast<T*>(smem + Smem<T>::tile);      // ā chunk, W_t, h
  T* R = reinterpret_cast<T*>(smem + 2 * Smem<T>::tile);  // Yᵀ
  int8_t* A8 = reinterpret_cast<int8_t*>(P);
  int8_t* B8 = reinterpret_cast<int8_t*>(Q);

  const int np = NP > 0 ? NP : int(gridDim.y);
  const int D = np * kRows;
  const int g = blockIdx.x, dp = NP == 1 ? 0 : int(blockIdx.y);
  const int row0 = (threadIdx.x >> 5) * 16;
  const int S = W / kRows, wpb = T2 / S;
  const long long N = (long long)n_src_blocks * kRows;
  const int b_end = min(n_src_blocks, (g + 1) * group);
  for (int b = g * group; b < b_end; ++b) {
    float dh[kNT][4];
    zero_acc(dh);
    for (int t = 0; t < T2; ++t) {
      const int w = b * wpb + t / S, col0 = (t % S) * kRows;
      const int t0 = gt_start[w], t1 = gt_start[w + 1];
      for (int fp = 0; fp < np; ++fp) {
        float acc[kNT][4];
        zero_acc(acc);
        bool any = false;
        for (int tt = t0; tt < t1; ++tt) {
          const int B = gt_win[tt];
          const long long c = gt_c_off[tt];
          if (B < 0 || B >= n_dst_blocks || c < 0 || c >= n_c) continue;
          any = true;
          const int8_t* C = counts + size_t(c) * BR * W + col0;
          int iacc[kNT][4];
          if constexpr (QUANT) {
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) iacc[nt][e] = 0;
          }
          for (int k0 = 0; k0 < BR; k0 += kRows) {
            const size_t acol = size_t(B) * BR + k0;
            __syncthreads();  // every warp is done with the previous chunk
            for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads) {
              // A[n][k] = C[k0 + k][col0 + n];
              // Bt[f][k] = āᵀ[fp·128 + f][B·BR + k0 + k]
              const int k = idx / kD, n = idx % kD;
              const int8_t cv = C[size_t(k0 + k) * W + n];
              const int f = idx / kRows, kk = idx % kRows;
              const size_t arow = size_t(fp * kRows + f) * n_cols;
              if constexpr (QUANT) {
                A8[n * kLd8 + k] = cv;
                B8[f * kLd8 + kk] =
                    static_cast<const int8_t*>(dat)[arow + acol + kk];
              } else {
                P[n * ld + k] = from_f<T>(float(cv));
                Q[f * ld + kk] = static_cast<const T*>(dat)[arow + acol + kk];
              }
            }
            __syncthreads();
            if constexpr (QUANT)
              warp_gemm_s8(iacc, A8 + row0 * kLd8, B8);
            else
              warp_gemm(acc, P + row0 * ld, Q);
          }
          if constexpr (QUANT) {
            const float s = scales[B];
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[nt][e] += float(iacc[nt][e]) * s;
          }
        }
        if (!any) break;  // an empty window: a zero slab, every panel
        __syncthreads();  // every warp is done with the last chunk
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = row0 + frag_row(e), f = frag_col(nt, e);
            const T y = from_f<T>(acc[nt][e]);
            P[n * ld + f] = y;
            R[f * ld + n] = y;
          }
        // Q[d][f] = W_t[dp·128 + d][fp·128 + f]
        load_w_rows(Q, msg_w + size_t(t) * D * D + size_t(dp) * kRows * D,
                    D, fp * kRows);
        __syncthreads();
        // dh[n][d] += Σ_f Y[n][f] W_t[d][f] over this panel's f
        warp_gemm(dh, P + row0 * ld, Q);
        __syncthreads();
        // Q[d][n] = h_b[n][dp·128 + d]
        load_wt(Q, h + size_t(b) * kRows * D, D, dp * kRows);
        __syncthreads();
        // dWᵀ_t[fp·128 + f][dp·128 + d] += Σ_n Yᵀ[f][n] h_b[n][d], this
        // warp's rows f
        float* part = ws + (size_t(g) * T2 + t) * D * D +
                      size_t(fp) * kRows * D + dp * kRows;
        float wacc[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            wacc[nt][e] =
                part[size_t(row0 + frag_row(e)) * D + frag_col(nt, e)];
        warp_gemm(wacc, R + row0 * ld, Q);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            part[size_t(row0 + frag_row(e)) * D + frag_col(nt, e)] =
                wacc[nt][e];
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dht[size_t(dp * kRows + frag_col(nt, e)) * N + size_t(b) * kRows +
            row0 + frag_row(e)] = dh[nt][e];
  }
}

// dwt[i] = Σ_g ws[g][i] in group order.
__global__ void window_bwd_dw_sum(const float* __restrict__ ws, int n_groups,
                                  long long per, float* __restrict__ dwt) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per) return;
  float s = 0.0f;
  for (int g = 0; g < n_groups; ++g) s += ws[g * per + i];
  dwt[i] = s;
}

int launch_window_bwd_dw_sum(const void* ws, int n_groups, long long per,
                              void* dwt, cudaStream_t stream) {
  window_bwd_dw_sum<<<int((per + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(ws), n_groups, per, static_cast<float*>(dwt));
  return int(cudaGetLastError());
}

// window_bwd_fused.cu
int launch_window_bwd_fused(int quant, const void* dat, const void* scales,
                            long long n_cols, const void* counts,
                            const void* walk, const void* goff, int BR,
                            int W, int T2, int n_src_blocks, int group,
                            const void* msg_w, const void* h, void* dht,
                            void* ws, cudaStream_t stream);

template <typename T, bool QUANT, int NP>
int launch_window_bwd(int P, const void* dat, const void* scales,
                      long long n_cols,
                      const void* counts, long long n_c, const void* gt_start,
                      const void* gt_win, const void* gt_c_off,
                      int n_dst_blocks, int BR, int W, int T2,
                      int n_src_blocks, int group, const void* msg_w,
                      const void* h, void* dht, void* ws, void* dwt,
                      cudaStream_t stream) {
  const size_t smem = 3 * Smem<T>::tile;
  cudaError_t err = cudaFuncSetAttribute(
      window_bwd_kernel<T, QUANT, NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int n_groups = (n_src_blocks + group - 1) / group;
  window_bwd_kernel<T, QUANT, NP><<<dim3(n_groups, P), kThreads, smem,
                                    stream>>>(
      dat, static_cast<const float*>(scales), n_cols,
      static_cast<const int8_t*>(counts), n_c,
      static_cast<const int*>(gt_start), static_cast<const int*>(gt_win),
      static_cast<const int*>(gt_c_off), n_dst_blocks, BR, W, T2,
      n_src_blocks, group, static_cast<const T*>(msg_w),
      static_cast<const T*>(h), static_cast<float*>(dht),
      static_cast<float*>(ws));
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return launch_window_bwd_dw_sum(
      ws, n_groups, (long long)T2 * P * kRows * P * kRows, dwt, stream);
}

}  // namespace ggnn

// dtype (of msg_w, h and, without quant, āᵀ): 0 = float32, 1 = bfloat16;
// quant: āᵀ int8 with scales [n_dst_blocks] f32 (bf16 only).  D a multiple
// of 128.  dat āᵀ [D, n_cols = n_dst_blocks·BR]; counts the forward stream
// int8 [n_c·BR, W]; gt_start [n_wins + 1], gt_win (the tile's dst block,
// < 0 for a dummy) and gt_c_off [n_gt]; msg_w [T2, D, D]; h
// [n_src_blocks·128, D]; dht f32 [D, n_src_blocks·128]; ws f32
// [ceil(n_src_blocks / group), T2, D, D] (zeroed, but for the bf16 D = 128
// form, which writes every element once); dwt f32 [T2, D, D] (dWᵀ); for
// the bf16 D = 128 form (else null) its walk, int32 [n_real, 4] rows (dst
// block, stream tile, window, 0), and each group's first row [n_groups + 1]
// (ops/window.py::bwd_walk).
// BR and W multiples of 128, T2·128 a multiple of W.  Returns the
// cudaError_t of the launches.
extern "C" int ggnn_window_bwd(int dtype, int quant, const void* dat,
                               const void* scales, long long n_cols,
                               const void* counts, long long n_c,
                               const void* gt_start, const void* gt_win,
                               const void* gt_c_off, int n_dst_blocks, int BR,
                               int W, int T2, int n_src_blocks, int group,
                               int D, const void* msg_w, const void* h,
                               void* dht, void* ws, void* dwt,
                               const void* walk, const void* goff,
                               void* stream) {
  if (n_src_blocks <= 0) return 0;
  if (BR <= 0 || BR % ggnn::kRows || W <= 0 || W % ggnn::kRows || T2 <= 0 ||
      (T2 * ggnn::kRows) % W || group <= 0 || (quant && !scales) ||
      D <= 0 || D % ggnn::kD)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = D / ggnn::kD;
  if (dtype == 1 && P == 1 && (W == 128 || W == 256 || W == 512)) {
    if (!walk || !goff) return int(cudaErrorInvalidValue);
    int err = ggnn::launch_window_bwd_fused(
        quant, dat, scales, n_cols, counts, walk, goff, BR, W, T2,
        n_src_blocks, group, msg_w, h, dht, ws, s);
    if (err != 0) return err;
    return ggnn::launch_window_bwd_dw_sum(
        ws, (n_src_blocks + group - 1) / group, (long long)T2 * D * D, dwt,
        s);
  }
#define GGNN_LAUNCH(T, Q, NP)                                                \
  return ggnn::launch_window_bwd<T, Q, NP>(                                  \
      P, dat, scales, n_cols, counts, n_c, gt_start, gt_win, gt_c_off,          \
      n_dst_blocks, BR, W, T2, n_src_blocks, group, msg_w, h, dht, ws, dwt,  \
      s)
#define GGNN_WIDTHS(T, Q)           \
  {                                 \
    if (P == 1) GGNN_LAUNCH(T, Q, 1); \
    if (P == 2) GGNN_LAUNCH(T, Q, 2); \
    GGNN_LAUNCH(T, Q, 0);           \
  }
  if (dtype == 1 && quant) GGNN_WIDTHS(__nv_bfloat16, true);
  if (dtype == 1) GGNN_WIDTHS(__nv_bfloat16, false);
  if (dtype == 0 && !quant) GGNN_WIDTHS(float, false);
#undef GGNN_WIDTHS
#undef GGNN_LAUNCH
  return int(cudaErrorInvalidValue);
}
