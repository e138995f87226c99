// Windowed count-matrix SpMM for Hopper (sm_90a): the reverse scatter of the
// legacy grad layouts, and the forward scatter of the legacy table-gather
// layout, in f32 at D = 128 and at every other width.  (A bf16 table at
// D = 128 runs window_mono_fused.cu's tensor-core pipeline, mono_pipe.cuh,
// where the window is a multiple of 16, else the panel kernel below.)
//
// Replaces ggnn_tpu/ops/window_pallas.py::_window_mono_kernel (run by
// window_block_spmm_mono), and, through entry points of their own, the two
// legacy one-hot scatters of ggnn_tpu/ops/scatter_pallas.py, which are this
// product with window = tile_e and win_of_tile = arange
// (scatter_pallas.py:760-771):
// - _scatter_stream_flat_kernel (onehot_segment_scatter_flat): the int8
//   transposed one-hot stream, C_t = rows [t·128, t·128 + 128);
// - _scatter_kernel (onehot_segment_scatter): the dst-local ids, the DSTL
//   form below with dstl = dst_local viewed as [n_tiles, tile_e].
// For output block b it computes, in f32,
//     out[b·R : (b+1)·R] = Σ_t C_t · table[win[t]·stride : win[t]·stride + window]
// over the tiles t in [tile_start[b], tile_start[b + 1]) with win[t] >= 0
// (a negative window marks a dummy tile, which adds nothing; a null
// win_of_tile means win[t] = t), and rounds once to the output dtype at the
// flush.  C_t is either
// - DSTL: the one-hot of row c[t] of a [n_c, window] int32 dst-local
//   stream (−1 = no edge): a segment sum, each window row added to the
//   output row it names; or
// - counts: rows [c[t]·R, c[t]·R + R) of an int8 [n_c·R, window] count
//   matrix: a matrix product, counts converted to f32 (exact) through FMA
//   loops;
// - the one-hot stream (a count matrix whose columns hold at most one 1,
//   which the wrapper checks once per stream): decoded into dst-local ids,
//   then the DSTL sum,
// with c[t] = c_off[t], or t where c_off is null (a dense stream).  Here R
// = out_rows = 128.  The window layouts' other count forms, the int4 pairs
// [n_c·R, window/2] (`packed`) and R = 256 or 512, are at D = 128 the sums
// of the window step (window_step.cuh, instantiated without the GRU in
// window_step.cu), which ops/window.py launches for them; the panel kernel
// below takes them at every other D.
//
// Bound on this card: HBM bytes (see window_mono_fused.cu).  Each
// block's tiles are cut into work items of at most kSplit = 32 tiles
// (common.cuh), one CTA per item; a block with one item flushes its rows
// itself, a block with more writes f32 partials that a second kernel sums
// in item order and flushes.  Inside an item the DSTL rows are summed into
// a [128, D] f32 shared-memory buffer by segment_sum_ordered (common.cuh:
// each warp its own 16 output rows, in the order of the rows).  No float
// atomics: the same result on every run.
//
// Widths: D = 128 runs the kernel above.  Any other D >= 1 (the
// bAbI models run D = 4 to 16), and bf16 at D = 128 with a window of no
// multiple of 16, runs window_mono_panel_kernel
// (window_mono_panel.cuh, compiled in parallel with this file): one CTA per
// (work item, 128-column panel), the last panel masked, the panel's
// table rows staged 32 at a time in shared memory and every output element
// summed by one thread in the order of the window rows.  It is as exact
// and as deterministic as the D = 128 kernel, and slow: no tensor cores,
// scalar loads (the widths it serves are small).
// Rows outside [0, n_table), dst ids outside [0, 128) and side-stream rows
// outside [0, n_c) are dropped, so a layout that does not belong to its
// table cannot address memory outside it.
#include <stdint.h>

#include <type_traits>

#include "window_mono.cuh"

GGNN_MONO_PANEL_EXTERN

namespace ggnn {

template <typename TT>
struct MonoSmem {
  static constexpr size_t sums = size_t(kRows) * kD * sizeof(float);
  static constexpr size_t dstl = sums + Stage<TT>::bytes;
  static constexpr size_t counts = sums + 2 * Smem<TT>::tile;
  // + the decoded dst ids of one tile, [window] int32
  static size_t onehot(int window) { return dstl + size_t(window) * 4; }
};

// One CTA per work item (grid = item_first[n_blocks]).
template <typename TT, typename TO, int MODE>
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
  zero_strip(S);

  if constexpr (MODE == kDstl) {
    const int* dstl = static_cast<const int*>(c_stream);
    TT* H_s = reinterpret_cast<TT*>(smem + MonoSmem<TT>::sums);
    for (int t = t0; t < t1; ++t) {
      const int w = win_of_tile ? win_of_tile[t] : t;
      const int c = c_off ? c_off[t] : t;
      if (w < 0 || c < 0 || c >= n_c) continue;
      segment_sum_ordered(S, H_s, table, n_table, (long long)w * stride,
                          dstl + size_t(c) * window, window);
    }
  } else if constexpr (MODE == kOnehot) {
    // Decode each tile's one-hot into d_s[j] = its row (−1: no entry), then
    // the same ordered segment sum as the dst-local stream: exact f32 adds
    // in the order of the window rows, whatever a hub row's length.
    const int8_t* onehot = static_cast<const int8_t*>(c_stream);
    TT* H_s = reinterpret_cast<TT*>(smem + MonoSmem<TT>::sums);
    int* d_s = reinterpret_cast<int*>(smem + MonoSmem<TT>::dstl);
    for (int t = t0; t < t1; ++t) {
      const int w = win_of_tile ? win_of_tile[t] : t;
      const int c = c_off ? c_off[t] : t;
      if (w < 0 || c < 0 || c >= n_c) continue;
      __syncthreads();  // every warp is done with the previous tile's ids
      for (int j = threadIdx.x; j < window; j += kThreads) d_s[j] = -1;
      __syncthreads();
      // 16 bytes of the [128, window] tile per load (128·window is a
      // multiple of 16); a nonzero byte names its (row, column), the one
      // entry of its column in a one-hot stream
      const int4* C = reinterpret_cast<const int4*>(
          onehot + size_t(c) * kRows * window);
      for (int q = threadIdx.x; q < kRows * window / 16; q += kThreads) {
        const int4 v = C[q];
        if ((v.x | v.y | v.z | v.w) == 0) continue;
        const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int byte = (words[i >> 2] >> (8 * (i & 3))) & 0xff;
          if (byte == 0) continue;
          const int pos = q * 16 + i, r = pos / window, j = pos % window;
          atomicCAS(&d_s[j], -1, r);
        }
      }
      __syncthreads();
      segment_sum_ordered(S, H_s, table, n_table, (long long)w * stride,
                          d_s, window);
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
      const int w = win_of_tile ? win_of_tile[t] : t;
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

// The f32 D = 128 kernel and its reduce.
template <typename TO, int MODE>
static int launch_window_mono_d128(const void* table, long long n_table,
                                   const void* c_stream, long long n_c,
                                   const void* tile_start,
                                   const void* win_of_tile, const void* c_off,
                                   int n_blocks, int window, int stride,
                                   const void* item_first, const void* pbase,
                                   int n_items, int n_partial, void* ws,
                                   void* out, cudaStream_t stream) {
  const size_t smem = MODE == kDstl     ? MonoSmem<float>::dstl
                      : MODE == kCounts ? MonoSmem<float>::counts
                                        : MonoSmem<float>::onehot(window);
  cudaError_t err = cudaFuncSetAttribute(
      window_mono_kernel<float, TO, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  window_mono_kernel<float, TO, MODE><<<n_items, kThreads, smem, stream>>>(
      static_cast<const float*>(table), n_table, c_stream, n_c,
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

template <typename TT, typename TO, int MODE>
static int launch_window_mono(const void* table, long long n_table, int D,
                              const void* c_stream, long long n_c,
                              bool packed, int out_rows,
                              const void* tile_start, const void* win_of_tile,
                              const void* c_off, int n_blocks, int window,
                              int stride, const void* item_first,
                              const void* pbase, int n_items, int n_partial,
                              void* ws, void* out, cudaStream_t stream) {
  if (D < 1) return int(cudaErrorInvalidValue);
  if (MODE == kOnehot && window % 16 != 0 && D == kD)
    return int(cudaErrorInvalidValue);
  // the dst-local and one-hot forms address 128-row blocks; the panel
  // kernel's counts any multiple of 128, int8 or int4 pairs; the D = 128
  // kernel's 128-row blocks of int8 counts (the window step takes the rest)
  if (out_rows % kRows || (MODE != kCounts && out_rows != kRows) ||
      (packed && (MODE != kCounts || window % 2)) ||
      (D == kD && (packed || out_rows != kRows)))
    return int(cudaErrorInvalidValue);
  // a bf16 table at D = 128 runs window_mono_fused.cu, or, where the
  // window is no multiple of 16, the panel kernel
  if constexpr (std::is_same<TT, float>::value) {
    if (D == kD)
      return launch_window_mono_d128<TO, MODE>(
          table, n_table, c_stream, n_c, tile_start, win_of_tile, c_off,
          n_blocks, window, stride, item_first, pbase, n_items, n_partial,
          ws, out, stream);
  }
  return launch_window_mono_panel<TT, TO, MODE == kOnehot ? kCounts : MODE>(
      table, n_table, D, c_stream, n_c, packed, out_rows, tile_start,
      win_of_tile, c_off, n_blocks, window, stride, item_first, pbase,
      n_items, n_partial, ws, out, stream);
}

}  // namespace ggnn

// table_dtype, out_dtype: 0 = float32, 1 = bfloat16; dstl = 1: c_stream is
// the int32 [n_c, window] dst-local stream (out_rows = 128), else the int8
// [n_c·out_rows, window] count matrix, or with packed = 1 its int4 pairs
// [n_c·out_rows, window/2] (D = 128: an f32 table, int8 counts and
// out_rows = 128 only);
// win_of_tile and c_off may be null (tile t reads window t, side-stream
// entry t).  item_first [n_blocks + 1] and pbase [n_blocks] are the hub
// split (see common.cuh); ws holds n_partial·out_rows/128 [128, D] f32
// slots.  table is [n_table, D], out [n_blocks·out_rows, D] with out_rows a
// multiple of 128, D >= 1.
// Returns the cudaError_t of the launches.
extern "C" int ggnn_window_mono(
    int table_dtype, int out_dtype, int dstl, int packed, const void* table,
    long long n_table, int D, const void* c_stream, long long n_c,
    const void* tile_start, const void* win_of_tile, const void* c_off,
    int n_blocks, int out_rows, int window, int stride,
    const void* item_first, const void* pbase, int n_items, int n_partial,
    void* ws, void* out, void* stream) {
  if (n_blocks <= 0 || n_items <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GGNN_LAUNCH(TT, TO, DS)                                              \
  return ggnn::launch_window_mono<TT, TO, DS>(                               \
      table, n_table, D, c_stream, n_c, packed != 0, out_rows, tile_start,   \
      win_of_tile, c_off, n_blocks, window, stride, item_first, pbase,       \
      n_items, n_partial, ws, out, s)
#define GGNN_DTYPES(DS)                                                      \
  if (table_dtype == 1 && out_dtype == 1)                                    \
    GGNN_LAUNCH(__nv_bfloat16, __nv_bfloat16, DS);                           \
  if (table_dtype == 1 && out_dtype == 0) GGNN_LAUNCH(__nv_bfloat16, float, DS); \
  if (table_dtype == 0 && out_dtype == 1) GGNN_LAUNCH(float, __nv_bfloat16, DS); \
  if (table_dtype == 0 && out_dtype == 0) GGNN_LAUNCH(float, float, DS)
  if (dstl) {
    GGNN_DTYPES(ggnn::kDstl);
  } else {
    GGNN_DTYPES(ggnn::kCounts);
  }
#undef GGNN_DTYPES
#undef GGNN_LAUNCH
  return int(cudaErrorInvalidValue);
}

// onehot_segment_scatter_flat: msgs [n_tiles·tile_e, D] (dtype 0 = float32,
// 1 = bfloat16: D != 128), the int8 transposed one-hot stream
// [n_tiles·128, tile_e] (each column at most one entry, a 1: the wrapper's
// check), tile_start [n_blocks + 1]; out [n_blocks·128, D] f32.  Tile t
// reads message rows [t·tile_e, (t + 1)·tile_e) and one-hot rows [t·128,
// (t + 1)·128), decoded into dst-local ids at D = 128 (tile_e % 16 == 0),
// taken as counts at other D.  The hub split and ws as in
// ggnn_window_mono.
extern "C" int ggnn_onehot_flat(
    int dtype, const void* msgs, long long n_msgs, int D, const void* onehot,
    long long n_tiles, const void* tile_start, int n_blocks, int tile_e,
    const void* item_first, const void* pbase, int n_items, int n_partial,
    void* ws, void* out, void* stream) {
  if (n_blocks <= 0 || n_items <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return ggnn::launch_window_mono<__nv_bfloat16, float, ggnn::kOnehot>(
        msgs, n_msgs, D, onehot, n_tiles, false, ggnn::kRows, tile_start,
        nullptr, nullptr,
        n_blocks, tile_e, tile_e, item_first, pbase, n_items, n_partial, ws,
        out, s);
  if (dtype == 0)
    return ggnn::launch_window_mono<float, float, ggnn::kOnehot>(
        msgs, n_msgs, D, onehot, n_tiles, false, ggnn::kRows, tile_start,
        nullptr, nullptr,
        n_blocks, tile_e, tile_e, item_first, pbase, n_items, n_partial, ws,
        out, s);
  return int(cudaErrorInvalidValue);
}

// onehot_segment_scatter: msgs [n_tiles·tile_e, D] (dtype 0 = float32,
// 1 = bfloat16: D != 128, or tile_e % 16 != 0), dst_local int32
// [n_tiles·tile_e] (−1 = padding), tile_start [n_blocks + 1]; out
// [n_blocks·128, D] f32.  Edge e of tile t = e / tile_e adds msgs[e] to row
// dst_local[e] of its block.  The hub split and ws as in ggnn_window_mono.
extern "C" int ggnn_onehot_dstl(
    int dtype, const void* msgs, long long n_msgs, int D,
    const void* dst_local, long long n_tiles, const void* tile_start,
    int n_blocks, int tile_e, const void* item_first, const void* pbase,
    int n_items, int n_partial, void* ws, void* out, void* stream) {
  if (n_blocks <= 0 || n_items <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return ggnn::launch_window_mono<__nv_bfloat16, float, ggnn::kDstl>(
        msgs, n_msgs, D, dst_local, n_tiles, false, ggnn::kRows, tile_start,
        nullptr, nullptr,
        n_blocks, tile_e, tile_e, item_first, pbase, n_items, n_partial, ws,
        out, s);
  if (dtype == 0)
    return ggnn::launch_window_mono<float, float, ggnn::kDstl>(
        msgs, n_msgs, D, dst_local, n_tiles, false, ggnn::kRows, tile_start,
        nullptr, nullptr,
        n_blocks, tile_e, tile_e, item_first, pbase, n_items, n_partial, ws,
        out, s);
  return int(cudaErrorInvalidValue);
}
