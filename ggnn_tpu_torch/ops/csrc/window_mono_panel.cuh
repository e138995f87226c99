// The panel kernel of window_block_spmm_mono at widths D != 128 (the bAbI
// models run D = 4 to 16; see window_mono.cu for the function and the hub
// split).  Instantiated per side-stream form in window_mono_panel.cu
// (dst-local) and window_mono_panel_counts.cu (counts, and #8's one-hot
// stream, whose product is the count form's), so that nvcc builds them in
// parallel with each other and with the D = 128 kernels.
#pragma once

#include <stdint.h>

#include "window_mono.cuh"

namespace ggnn {

// Any width D != 128: one CTA per (work item, panel of 128 columns); the
// panel holds columns [c0, c0 + w), w = min(128, D − c0).  Each thread owns
// the elements idx = threadIdx.x + k·kThreads of the panel's [128, w] rows
// and sums their terms in the order of the window rows, kPanelRows staged
// rows at a time (a staged chunk's terms in a register, then added to the
// element's sum).
constexpr int kPanelRows = 32;
constexpr int kOwn = kRows * kRows / kThreads;  // elements a thread owns

template <typename TT, typename TO, int MODE>
__global__ void __launch_bounds__(kThreads) window_mono_panel_kernel(
    const TT* __restrict__ table, long long n_table, int D,
    const void* __restrict__ c_stream, long long n_c, bool packed,
    int out_rows, const int* __restrict__ tile_start,
    const int* __restrict__ win_of_tile, const int* __restrict__ c_off,
    int n_blocks, int window, int stride,
    const int* __restrict__ item_first, const int* __restrict__ pbase,
    float* __restrict__ ws, TO* __restrict__ out) {
  constexpr bool DSTL = MODE == kDstl;
  const int slice = blockIdx.z, slices = gridDim.z;
  const int ccols = packed ? window / 2 : window;
  __shared__ float T_s[kPanelRows][kRows];
  __shared__ float C_s[kRows][kPanelRows + 1];
  __shared__ int d_s[kPanelRows];
  const int item = blockIdx.x;
  const int b = item_block(item_first, n_blocks, item);
  const int k = item - item_first[b];
  const int n_items = item_first[b + 1] - item_first[b];
  const int t0 = tile_start[b] + k * kSplit;
  const int t1 = min(t0 + kSplit, tile_start[b + 1]);
  const int c0 = blockIdx.y * kRows;
  const int w = min(kRows, D - c0);
  float acc[kOwn];
#pragma unroll
  for (int q = 0; q < kOwn; ++q) acc[q] = 0.0f;
  for (int t = t0; t < t1; ++t) {
    const int wt = win_of_tile ? win_of_tile[t] : t;
    const int c = c_off ? c_off[t] : t;
    if (wt < 0 || c < 0 || c >= n_c) continue;
    const long long base = (long long)wt * stride;
    for (int j0 = 0; j0 < window; j0 += kPanelRows) {
      const int nj = min(kPanelRows, window - j0);
      __syncthreads();  // every thread is done with the previous chunk
      for (int idx = threadIdx.x; idx < kPanelRows * w; idx += kThreads) {
        const int jr = idx / w, col = idx % w;
        const long long row = base + j0 + jr;
        T_s[jr][col] = (jr < nj && row >= 0 && row < n_table)
                           ? to_f(table[row * D + c0 + col])
                           : 0.0f;
      }
      if constexpr (DSTL) {
        const int* dstl = static_cast<const int*>(c_stream) + size_t(c) * window;
        for (int jr = threadIdx.x; jr < kPanelRows; jr += kThreads) {
          const long long row = base + j0 + jr;
          d_s[jr] = (jr < nj && row >= 0 && row < n_table) ? dstl[j0 + jr] : -1;
        }
      } else {
        const int8_t* C =
            static_cast<const int8_t*>(c_stream) +
            (size_t(c) * out_rows + size_t(slice) * kRows) * ccols;
        for (int idx = threadIdx.x; idx < kRows * kPanelRows; idx += kThreads) {
          const int r = idx / kPanelRows, jr = idx % kPanelRows;
          C_s[r][jr] = jr < nj ? float(count_at(C + size_t(r) * ccols,
                                                j0 + jr, window, packed))
                               : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kOwn; ++q) {
        const int idx = threadIdx.x + q * kThreads;
        if (idx >= kRows * w) break;
        const int r = idx / w, col = idx % w;
        float s = 0.0f;
        for (int jr = 0; jr < nj; ++jr) {
          if constexpr (DSTL) {
            if (d_s[jr] == r) s += T_s[jr][col];
          } else {
            const float cv = C_s[r][jr];
            if (cv != 0.0f) s = fmaf(cv, T_s[jr][col], s);
          }
        }
        acc[q] += s;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kOwn; ++q) {
    const int idx = threadIdx.x + q * kThreads;
    if (idx >= kRows * w) break;
    const int r = idx / w, col = idx % w;
    if (n_items > 1)
      ws[((size_t(pbase[b] + k) * slices + slice) * kRows + r) * D + c0 +
         col] = acc[q];
    else
      out[(size_t(b) * out_rows + size_t(slice) * kRows + r) * D + c0 + col] =
          from_f<TO>(acc[q]);
  }
}

// The partial sums of window_mono_panel_kernel's split blocks, in item
// order: one CTA per (output block, slice), slots of [128, D] f32.
template <typename TO>
__global__ void __launch_bounds__(kThreads) window_mono_panel_reduce_kernel(
    const int* __restrict__ item_first, const int* __restrict__ pbase, int D,
    int out_rows, const float* __restrict__ ws, TO* __restrict__ out) {
  const int b = blockIdx.x, slice = blockIdx.y, slices = gridDim.y;
  const int n_items = item_first[b + 1] - item_first[b];
  if (n_items <= 1) return;
  const size_t slot = size_t(kRows) * D;
  const float* p = ws + (size_t(pbase[b]) * slices + slice) * slot;
  TO* dst = out + (size_t(b) * out_rows + size_t(slice) * kRows) * D;
  for (size_t i = threadIdx.x; i < slot; i += kThreads) {
    float s = p[i];
    for (int k = 1; k < n_items; ++k) s += p[size_t(k) * slices * slot + i];
    dst[i] = from_f<TO>(s);
  }
}


template <typename TT, typename TO, int MODE>
int launch_window_mono_panel(const void* table, long long n_table, int D,
                             const void* c_stream, long long n_c, bool packed,
                             int out_rows, const void* tile_start,
                             const void* win_of_tile, const void* c_off,
                             int n_blocks, int window, int stride,
                             const void* item_first, const void* pbase,
                             int n_items, int n_partial, void* ws, void* out,
                             cudaStream_t stream) {
  const int slices = out_rows / kRows;
  const dim3 grid(n_items, (D + kRows - 1) / kRows, slices);
  window_mono_panel_kernel<TT, TO, MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const TT*>(table), n_table, D, c_stream, n_c, packed,
      out_rows, static_cast<const int*>(tile_start),
      static_cast<const int*>(win_of_tile), static_cast<const int*>(c_off),
      n_blocks, window, stride, static_cast<const int*>(item_first),
      static_cast<const int*>(pbase), static_cast<float*>(ws),
      static_cast<TO*>(out));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_partial == 0) return int(err);
  window_mono_panel_reduce_kernel<TO>
      <<<dim3(n_blocks, slices), kThreads, 0, stream>>>(
          static_cast<const int*>(item_first),
          static_cast<const int*>(pbase), D, out_rows,
          static_cast<const float*>(ws), static_cast<TO*>(out));
  return int(cudaGetLastError());
}

}  // namespace ggnn

