// The window step kernel template (see window_step.cu for what it
// computes and its design).  Each table source is instantiated in a
// source file of its own, so that nvcc compiles them in parallel:
// window_step.cu (kTable, with the GRU for #13 and without it for #11's
// int4 and tall count forms, and the entry point), window_step_q8.cu,
// window_step_ondemand.cu (#13 on-demand) and window_ondemand.cu (#12).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace ggnn {

constexpr int kTable = 0, kQ8 = 1, kOnDemand = 2;
constexpr int kLd8 = kD + 16;  // int8 operand rows in shared memory (bytes)

// acc[16 x 128] += A[16 x 128] · B[128 x 128] for the calling warp, int8
// operands, exact int32 sums (mma.sync.m16n8k32 s8·s8 → s32).  A: this
// warp's strip of a [128][kLd8] int8 operand; Bt: B transposed, [n][kLd8].
__device__ __forceinline__ void warp_gemm_s8(int (&acc)[kNT][4],
                                             const int8_t* A,
                                             const int8_t* Bt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < kD; k0 += 32) {
    const int8_t* ap = A + g * kLd8 + k0 + 4 * tq;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * kLd8);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 16);
    const uint32_t a3 =
        *reinterpret_cast<const uint32_t*>(ap + 8 * kLd8 + 16);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int8_t* bp = Bt + (nt * 8 + g) * kLd8 + k0 + 4 * tq;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 16);
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+r"(acc[nt][0]), "+r"(acc[nt][1]), "+r"(acc[nt][2]),
            "+r"(acc[nt][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
}

// One CTA per (dst block, 128-row slice): grid (n_blocks, out_rows / 128).
// T is the compute dtype: the table's, the h source's, and the GRU weights'
// (for kQ8 the table is int8 and T the weights').  Shared memory: three
// [128][ld] tiles of T (buf0: the counts as T, or a W_t operand; buf1: the
// window chunk, transposed; buf2: the h block of kOnDemand), reused by the
// epilogue as (A_s, W_s, H_s).  kQ8 views buf0 and buf1 as int8 operands.
// RES (with FUSED): also write the training residuals (a | z | r | h̃) in T,
// rows of 4·128, to `res` (emit_res of the TPU kernel).  Without FUSED (the
// sums only, kTable) out_rows need not be a multiple of 128: the last slice
// of a block computes and writes only its out_rows % 128 rows.  Without
// FUSED the state may also be P·128 wide (P = gridDim.z): CTA z sums output
// columns [z·128, z·128 + 128) of rows P·128 wide (table, init, out), and
// an on-demand window chunk sums its products over the P 128-column panels
// of the h block and of W_t.
template <typename T, int SRC, bool FUSED, bool RES>
__global__ void __launch_bounds__(kThreads) window_step_kernel(
    const void* __restrict__ table, long long n_table,
    const int8_t* __restrict__ counts, long long n_c, bool packed,
    const int* __restrict__ tile_start, const int* __restrict__ win_of_tile,
    const int* __restrict__ c_off, int out_rows, int window,
    const float* __restrict__ scales, const T* __restrict__ wbank,
    const float* __restrict__ bbank, int T2,
    const float* __restrict__ init, const float* __restrict__ hstate,
    const T* __restrict__ wa, const float* __restrict__ b3,
    const T* __restrict__ uzr, const T* __restrict__ uh,
    float* __restrict__ out, T* __restrict__ res) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  T* buf0 = reinterpret_cast<T*>(smem);
  T* buf1 = reinterpret_cast<T*>(smem + Smem<T>::tile);
  T* buf2 = reinterpret_cast<T*>(smem + 2 * Smem<T>::tile);
  int8_t* A8 = reinterpret_cast<int8_t*>(buf0);
  int8_t* B8 = reinterpret_cast<int8_t*>(buf1);
  __shared__ int wl_s[kThreads];  // a chunk of the block's win_of_tile

  const int b = blockIdx.x, slice = blockIdx.y;
  const int P = gridDim.z, ldw = P * kD;   // row length of the wide arrays
  const int colq = blockIdx.z * kD;        // this CTA's output columns
  const size_t orow0 = size_t(b) * out_rows + size_t(slice) * kRows;
  const int row0 = (threadIdx.x >> 5) * 16;
  const int nrows = min(kRows, out_rows - slice * kRows);  // rows of slice
  const int ccols = packed ? window / 2 : window;
  const int gtypes = window / kRows;
  const int wpb = SRC == kOnDemand ? T2 / gtypes : 1;

  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[nt][e] = init ? init[(orow0 + row0 + frag_row(e)) * ldw + colq +
                               frag_col(nt, e)]
                        : 0.0f;

  const int t0 = tile_start[b], t1 = tile_start[b + 1];
  for (int tc = t0; tc < t1; tc += kThreads) {
    const int n = min(kThreads, t1 - tc);
    const int w_mine = threadIdx.x < n ? win_of_tile[tc + threadIdx.x] : -1;
    __syncthreads();  // every thread is done with the previous chunk's list
    wl_s[threadIdx.x] = w_mine;
    if (!__syncthreads_or(w_mine >= 0)) continue;
    for (int i = 0; i < n; ++i) {
      const int w = wl_s[i];
      if (w < 0) continue;
      const int t = tc + i;
      const long long c = c_off ? c_off[t] : t;
      if (c < 0 || c >= n_c) continue;
      const int8_t* C = counts + (size_t(c) * out_rows +
                                  size_t(slice) * kRows) * ccols;
      int iacc[kNT][4];
      if constexpr (SRC == kQ8) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) iacc[nt][e] = 0;
      }
      long long hb = 0;
      int tbase = 0;
      // the h block's K-panel kp of an on-demand window, into buf2
      auto stage_h = [&](int kp) {
        const T* hsrc = static_cast<const T*>(table);
        for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads) {
          const int r = idx / kD, k = idx % kD;
          buf2[r * ld + k] = hb + r < n_table
                                 ? hsrc[(hb + r) * ldw + kp * kD + k]
                                 : from_f<T>(0.0f);
        }
      };
      if constexpr (SRC == kOnDemand) {
        hb = (long long)(w / wpb) * kRows;
        tbase = (w % wpb) * gtypes;
        if (P == 1) {
          __syncthreads();  // every warp is done with the previous h block
          stage_h(0);
        }
      }
      const long long base = (long long)w * window;
      for (int j0 = 0; j0 < window; j0 += kD) {
        const int nk = min(kD, window - j0);
        if constexpr (SRC == kOnDemand) {
          // window chunk j = T(h_blk · W_{tbase+j} + b_{tbase+j}), built
          // in registers and stored transposed into buf1
          const int tj = tbase + j0 / kD;
          float wacc[kNT][4];
          zero_acc(wacc);
          for (int kp = 0; kp < P; ++kp) {
            __syncthreads();  // buf0, buf1 (and buf2 when P > 1) are free
            if (P > 1) stage_h(kp);
            load_wt(buf0, wbank + (size_t(tj) * ldw + kp * kD) * ldw, ldw,
                    colq);
            __syncthreads();
            warp_gemm(wacc, buf2 + row0 * ld, buf0);
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = row0 + frag_row(e), col = frag_col(nt, e);
              buf1[col * ld + r] =
                  from_f<T>(wacc[nt][e] + bbank[size_t(tj) * ldw + colq + col]);
            }
          __syncthreads();  // every warp is done reading W_t from buf0
          for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads) {
            const int r = idx / kD, kk = idx % kD;
            buf0[r * ld + kk] = from_f<T>(
                float(count_at(C + size_t(r) * ccols, j0 + kk, window,
                               false)));
          }
          __syncthreads();
          warp_gemm(acc, buf0 + row0 * ld, buf1);
        } else if constexpr (SRC == kQ8) {
          const int8_t* tq = static_cast<const int8_t*>(table);
          __syncthreads();  // every warp is done with the previous chunk
          for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads) {
            const int r = idx / kD, kk = idx % kD;
            A8[r * kLd8 + kk] = kk < nk ? C[size_t(r) * ccols + j0 + kk] : 0;
            const int kr = idx / kD, nn = idx % kD;
            const long long row = base + j0 + kr;
            B8[nn * kLd8 + kr] =
                (kr < nk && row < n_table) ? tq[row * ldw + colq + nn] : 0;
          }
          __syncthreads();
          warp_gemm_s8(iacc, A8 + row0 * kLd8, B8);
        } else {
          const T* tab = static_cast<const T*>(table);
          __syncthreads();  // every warp is done with the previous chunk
          for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads) {
            const int r = idx / kD, kk = idx % kD;
            buf0[r * ld + kk] = from_f<T>(
                kk < nk && r < nrows
                    ? float(count_at(C + size_t(r) * ccols, j0 + kk, window,
                                     packed))
                    : 0.0f);
            const int kr = idx / kD, nn = idx % kD;
            const long long row = base + j0 + kr;
            buf1[nn * ld + kr] = (kr < nk && row < n_table)
                                     ? tab[row * ldw + colq + nn]
                                     : from_f<T>(0.0f);
          }
          __syncthreads();
          warp_gemm(acc, buf0 + row0 * ld, buf1);
        }
      }
      if constexpr (SRC == kQ8) {
        const float s = scales[w];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] += float(iacc[nt][e]) * s;
      }
    }
  }

  if constexpr (FUSED) {
    __syncthreads();  // every warp is done with the last tile's operands
    // a rounded to T (this warp's rows; with RES also the residual's a),
    // h rounded to T, then the GRU (gru_block starts with a barrier)
    constexpr int kRes = 4 * kD;  // a residual row: a | z | r | h̃
    T* rrow = RES ? res + orow0 * kRes : nullptr;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + frag_row(e), c = frag_col(nt, e);
        const T av = from_f<T>(acc[nt][e]);
        buf0[r * ld + c] = av;
        if constexpr (RES) rrow[size_t(r) * kRes + c] = av;
      }
    const float* hrow = hstate + orow0 * kD;
    stage_rows(buf2, hrow);
    gru_block<T, RES, RES ? kRes : kD>(
        buf0, buf2, buf1, hrow, wa, b3, uzr, uh, out + orow0 * kD,
        RES ? rrow + kD : nullptr, RES ? rrow + 2 * kD : nullptr,
        RES ? rrow + 3 * kD : nullptr);
  } else {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int c0 = frag_col(nt, 0);
      const int lo = row0 + frag_row(0), hi = row0 + frag_row(2);
      if (lo < nrows)
        *reinterpret_cast<float2*>(out + (orow0 + lo) * ldw + colq + c0) =
            make_float2(acc[nt][0], acc[nt][1]);
      if (hi < nrows)
        *reinterpret_cast<float2*>(out + (orow0 + hi) * ldw + colq + c0) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

template <typename T, int SRC, bool FUSED, bool RES>
int launch_window_step(int P, const void* table, long long n_table,
                              const void* counts, long long n_c, bool packed,
                              const void* tile_start, const void* win_of_tile,
                              const void* c_off, int n_blocks, int out_rows,
                              int window, const void* scales,
                              const void* wbank, const void* bbank, int T2,
                              const void* init, const void* hstate,
                              const void* wa, const void* b3,
                              const void* uzr, const void* uh, void* out,
                              void* res, cudaStream_t stream) {
  if (out_rows <= 0 || window <= 0 || P <= 0 || (FUSED && P != 1))
    return int(cudaErrorInvalidValue);
  if (out_rows % kRows && (FUSED || SRC != kTable))
    return int(cudaErrorInvalidValue);
  if (RES != (res != nullptr) || (RES && (!FUSED || SRC == kQ8)))
    return int(cudaErrorInvalidValue);
  if (packed && (SRC != kTable || window % 2)) return int(cudaErrorInvalidValue);
  if (SRC != kTable && window % kRows) return int(cudaErrorInvalidValue);
  if (SRC == kOnDemand &&
      (T2 <= 0 || (T2 * kRows) % window || !wbank || !bbank))
    return int(cudaErrorInvalidValue);
  if (SRC == kQ8 && !scales) return int(cudaErrorInvalidValue);
  if (FUSED && (!hstate || !wa || !b3 || !uzr || !uh))
    return int(cudaErrorInvalidValue);
  const size_t smem = 3 * Smem<T>::tile;
  cudaError_t err = cudaFuncSetAttribute(
      window_step_kernel<T, SRC, FUSED, RES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_blocks, (out_rows + kRows - 1) / kRows, P);
  window_step_kernel<T, SRC, FUSED, RES><<<grid, kThreads, smem, stream>>>(
      table, n_table, static_cast<const int8_t*>(counts), n_c, packed,
      static_cast<const int*>(tile_start),
      static_cast<const int*>(win_of_tile), static_cast<const int*>(c_off),
      out_rows, window, static_cast<const float*>(scales),
      static_cast<const T*>(wbank), static_cast<const float*>(bbank), T2,
      static_cast<const float*>(init), static_cast<const float*>(hstate),
      static_cast<const T*>(wa), static_cast<const float*>(b3),
      static_cast<const T*>(uzr), static_cast<const T*>(uh),
      static_cast<float*>(out), static_cast<T*>(res));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// The instantiations of one (SRC, FUSED, RES) form, bf16 and f32.
#define GGNN_WINDOW_STEP_SIG                                                 \
  int, const void*, long long, const void*, long long, bool, const void*,   \
      const void*, const void*, int, int, int, const void*, const void*,    \
      const void*, int, const void*, const void*, const void*, const void*, \
      const void*, const void*, void*, void*, cudaStream_t
#define GGNN_WINDOW_STEP_INSTANTIATE(SRC, FUSED, RES)                        \
  template int ggnn::launch_window_step<__nv_bfloat16, SRC, FUSED, RES>(   \
      GGNN_WINDOW_STEP_SIG);                                                \
  template int ggnn::launch_window_step<float, SRC, FUSED, RES>(           \
      GGNN_WINDOW_STEP_SIG);

// The same, declared for the translation units that only call them.
#define GGNN_WINDOW_STEP_EXTERN(SRC, FUSED, RES)                             \
  extern template int                                                       \
  ggnn::launch_window_step<__nv_bfloat16, SRC, FUSED, RES>(                 \
      GGNN_WINDOW_STEP_SIG);                                                \
  extern template int ggnn::launch_window_step<float, SRC, FUSED, RES>(    \
      GGNN_WINDOW_STEP_SIG);
