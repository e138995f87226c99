// Windowed count-matrix SpMM for Hopper (sm_90a): the reverse scatter of the
// legacy grad layout, the typed pack's backward where the octet layout
// declines (hub-heavy and power-law graphs).
//
// Replaces ggnn_tpu/ops/window_pallas.py::_window_mono_kernel (run by
// window_block_spmm_mono) with out_rows = 128 and the unpacked side
// streams.  For output block b it computes, in f32,
//     out[b·128 : (b+1)·128] = Σ_t C_t · table[win[t]·stride : win[t]·stride + window]
// over the tiles t in [tile_start[b], tile_start[b + 1]) with win[t] >= 0
// (a negative window marks a dummy tile, which adds nothing), and rounds
// once to the output dtype at the flush.  C_t is either
// - DSTL: the one-hot of row c[t] of a [n_c, window] int32 dst-local
//   stream (−1 = no edge): a segment sum, each window row added to the
//   output row it names; or
// - counts: rows [c[t]·128, c[t]·128 + 128) of an int8 [n_c·128, window]
//   count matrix: a matrix product, counts converted to the table's type
//   (exact for int8) through mma.sync (bf16) or FMA loops (f32),
// with c[t] = c_off[t], or t where c_off is null (a dense stream).
//
// Bound on this card: HBM bytes.  At the scale-free headline's grad layout
// (262,144 nodes, 8M directed edges, Zipf 1.2, 16 message types, D = 128,
// bf16, g_tile 256) one call reads 8.25M packed rows of G (2.1 GB) and the
// 62 MB dstl stream and writes Y (4.19M rows, 1.07 GB): ≈ 0.97 ms at
// 3.35 TB/s.  The grad blocks of the hub's source rows hold ~1,400 tiles
// each against ~2 elsewhere, so one CTA per output block would leave a
// few SMs with the hub's work.  As in typed_tile.cu, each block's tiles are
// cut into work items of at most kSplit = 32 tiles (common.cuh), one CTA
// per item; a block with one item flushes its rows itself, a block with
// more writes f32 partials that a second kernel sums in item order and
// flushes.  Inside an item the DSTL rows are summed into a [128, D] f32
// shared-memory buffer by segment_sum_ordered (common.cuh: each warp its
// own 16 output rows, in the order of the rows).  No float atomics: the
// same result on every run.
// Rows outside [0, n_table), dst ids outside [0, 128) and side-stream rows
// outside [0, n_c) are dropped, so a layout that does not belong to its
// table cannot address memory outside it.
#include <stdint.h>

#include "common.cuh"

namespace ggnn {

template <typename TT>
struct MonoSmem {
  static constexpr size_t sums = size_t(kRows) * kD * sizeof(float);
  static constexpr size_t dstl = sums + Stage<TT>::bytes;
  static constexpr size_t counts = sums + 2 * Smem<TT>::tile;
};

// One CTA per work item (grid = item_first[n_blocks]).
template <typename TT, typename TO, bool DSTL>
__global__ void __launch_bounds__(kThreads) window_mono_kernel(
    const TT* __restrict__ table, long long n_table,
    const void* __restrict__ c_stream, long long n_c,
    const int* __restrict__ tile_start, const int* __restrict__ win_of_tile,
    const int* __restrict__ c_off, int n_blocks, int window, int stride,
    const int* __restrict__ item_first, const int* __restrict__ pbase,
    float* __restrict__ ws, TO* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);
  const int item = blockIdx.x;
  const int b = item_block(item_first, n_blocks, item);
  const int k = item - item_first[b];
  const int n_items = item_first[b + 1] - item_first[b];
  const int t0 = tile_start[b] + k * kSplit;
  const int t1 = min(t0 + kSplit, tile_start[b + 1]);

  if constexpr (DSTL) {
    const int* dstl = static_cast<const int*>(c_stream);
    TT* H_s = reinterpret_cast<TT*>(smem + MonoSmem<TT>::sums);
    zero_strip(S);
    for (int t = t0; t < t1; ++t) {
      const int w = win_of_tile[t];
      const int c = c_off ? c_off[t] : t;
      if (w < 0 || c < 0 || c >= n_c) continue;
      segment_sum_ordered(S, H_s, table, n_table, (long long)w * stride,
                          dstl + size_t(c) * window, window);
    }
  } else {
    constexpr int ld = Smem<TT>::ld;
    const int8_t* counts = static_cast<const int8_t*>(c_stream);
    TT* A_s = reinterpret_cast<TT*>(smem + MonoSmem<TT>::sums);
    TT* W_s = reinterpret_cast<TT*>(smem + MonoSmem<TT>::sums +
                                    Smem<TT>::tile);
    const int row0 = (threadIdx.x >> 5) * 16;
    float acc[kNT][4];
    zero_acc(acc);
    for (int t = t0; t < t1; ++t) {
      const int w = win_of_tile[t];
      const int c = c_off ? c_off[t] : t;
      if (w < 0 || c < 0 || c >= n_c) continue;
      const long long base = (long long)w * stride;
      const int8_t* C = counts + size_t(c) * kRows * window;
      for (int j0 = 0; j0 < window; j0 += kD) {
        const int nk = min(kD, window - j0);
        __syncthreads();  // every warp is done with the previous chunk
        for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads) {
          const int r = idx / kD, kk = idx % kD;
          A_s[r * ld + kk] = from_f<TT>(
              kk < nk ? float(C[size_t(r) * window + j0 + kk]) : 0.0f);
          // W_s[n][kk] = table row (base + j0 + kk), feature n
          const int kr = idx / kD, n = idx % kD;
          const long long row = base + j0 + kr;
          W_s[n * ld + kr] = (kr < nk && row >= 0 && row < n_table)
                                 ? table[row * kD + n]
                                 : from_f<TT>(0.0f);
        }
        __syncthreads();
        warp_gemm(acc, A_s + row0 * ld, W_s);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        S[(row0 + frag_row(e)) * kD + frag_col(nt, e)] = acc[nt][e];
  }
  __syncthreads();
  if (n_items > 1) {
    float* slot = ws + size_t(pbase[b] + k) * kSlot;
    for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads)
      slot[idx] = S[idx];
  } else {
    TO* dst = out + size_t(b) * kRows * kD;
    for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads)
      dst[idx] = from_f<TO>(S[idx]);
  }
}

// One CTA per output block; blocks with one item were flushed by the first
// kernel.  Sums the block's partials in item order and flushes them.
template <typename TO>
__global__ void __launch_bounds__(kThreads) window_mono_reduce_kernel(
    const int* __restrict__ item_first, const int* __restrict__ pbase,
    const float* __restrict__ ws, TO* __restrict__ out) {
  const int b = blockIdx.x;
  const int n_items = item_first[b + 1] - item_first[b];
  if (n_items <= 1) return;
  const float4* slots =
      reinterpret_cast<const float4*>(ws + size_t(pbase[b]) * kSlot);
  TO* dst = out + size_t(b) * kRows * kD;
  for (int i = threadIdx.x; i < kSlot / 4; i += kThreads) {
    float4 s = slots[i];
#pragma unroll 8
    for (int k = 1; k < n_items; ++k) {
      const float4 v = slots[size_t(k) * (kSlot / 4) + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    dst[4 * i] = from_f<TO>(s.x);
    dst[4 * i + 1] = from_f<TO>(s.y);
    dst[4 * i + 2] = from_f<TO>(s.z);
    dst[4 * i + 3] = from_f<TO>(s.w);
  }
}

template <typename TT, typename TO, bool DSTL>
static int launch_window_mono(const void* table, long long n_table,
                              const void* c_stream, long long n_c,
                              const void* tile_start, const void* win_of_tile,
                              const void* c_off, int n_blocks, int window,
                              int stride, const void* item_first,
                              const void* pbase, int n_items, int n_partial,
                              void* ws, void* out, cudaStream_t stream) {
  const size_t smem = DSTL ? MonoSmem<TT>::dstl : MonoSmem<TT>::counts;
  cudaError_t err = cudaFuncSetAttribute(
      window_mono_kernel<TT, TO, DSTL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  window_mono_kernel<TT, TO, DSTL><<<n_items, kThreads, smem, stream>>>(
      static_cast<const TT*>(table), n_table, c_stream, n_c,
      static_cast<const int*>(tile_start),
      static_cast<const int*>(win_of_tile), static_cast<const int*>(c_off),
      n_blocks, window, stride, static_cast<const int*>(item_first),
      static_cast<const int*>(pbase), static_cast<float*>(ws),
      static_cast<TO*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || n_partial == 0) return int(err);
  window_mono_reduce_kernel<TO><<<n_blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(item_first), static_cast<const int*>(pbase),
      static_cast<const float*>(ws), static_cast<TO*>(out));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// table_dtype, out_dtype: 0 = float32, 1 = bfloat16; dstl = 1: c_stream is
// the int32 [n_c, window] dst-local stream, else the int8 [n_c·128, window]
// count matrix; c_off may be null (tile t reads side-stream entry t).
// item_first [n_blocks + 1] and pbase [n_blocks] are the hub split (see
// common.cuh); ws holds n_partial [128, 128] f32 slots.  out is
// [n_blocks·128, 128].  Returns the cudaError_t of the launches.
extern "C" int ggnn_window_mono(
    int table_dtype, int out_dtype, int dstl, const void* table,
    long long n_table, const void* c_stream, long long n_c,
    const void* tile_start, const void* win_of_tile, const void* c_off,
    int n_blocks, int window, int stride, const void* item_first,
    const void* pbase, int n_items, int n_partial, void* ws, void* out,
    void* stream) {
  if (n_blocks <= 0 || n_items <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GGNN_LAUNCH(TT, TO, DS)                                              \
  return ggnn::launch_window_mono<TT, TO, DS>(                               \
      table, n_table, c_stream, n_c, tile_start, win_of_tile, c_off,         \
      n_blocks, window, stride, item_first, pbase, n_items, n_partial, ws,   \
      out, s)
#define GGNN_DTYPES(DS)                                                      \
  if (table_dtype == 1 && out_dtype == 1)                                    \
    GGNN_LAUNCH(__nv_bfloat16, __nv_bfloat16, DS);                           \
  if (table_dtype == 1 && out_dtype == 0) GGNN_LAUNCH(__nv_bfloat16, float, DS); \
  if (table_dtype == 0 && out_dtype == 1) GGNN_LAUNCH(float, __nv_bfloat16, DS); \
  if (table_dtype == 0 && out_dtype == 0) GGNN_LAUNCH(float, float, DS)
  if (dstl) {
    GGNN_DTYPES(true);
  } else {
    GGNN_DTYPES(false);
  }
#undef GGNN_DTYPES
#undef GGNN_LAUNCH
  return int(cudaErrorInvalidValue);
}
