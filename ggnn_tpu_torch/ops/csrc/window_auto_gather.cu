// The windowed count-matrix SpMM for Hopper (sm_90a) as a sparse
// gather-sum: kernel #20's redesign.
//
// Replaces _window_kernel of ggnn_tpu/ops/window_pallas.py (run by
// window_block_spmm, #20) and _scatter_loopT_kernel of
// ggnn_tpu/ops/scatter_pallas.py (run by onehot_segment_scatter_loopT,
// #19; and _scatter_stream_kernel, #18, in the forms #11's pipeline does
// not take): #19 is this function with W = tile_e, each tile t reading its
// own message rows (w = t) into the block tile_start gives it, the tiles
// past tile_start[-1] unused (ops/legacy.py::loopT_plan_once).
//
// For every dst block b of 128 rows and its tiles t with win_of_tile[t] =
// w >= 0,
//     out[b·128 + r] = Σ_t Σ_j C_c[r][j] · table[w·W + j]           (f32)
// with C_c the int8 count tile [128, W] of stream entry c (c_off[t], or
// t), whatever values it holds (−128 … 127), and table [R, D] in T (bf16 or
// f32).  Every block is written, a block without tiles as zeros.
//
// The count tiles are the TPU's way to feed its matrix unit: at the
// community headline (W 512, 32,768 real tiles of 64 KB) at most 0.37 % of
// their bytes are not zero.  Here the function is a gather-sum over those
// bytes alone.  A plan made once per layout on the device
// (ops/window.py::window_auto_plan) lists every nonzero byte as an entry
// {table row w·W + j, count}, in order of output row (then tile, then j),
// packed into 4 bytes (row << 8 | count byte) where the table has fewer
// than 2^24 rows, else 8; and cuts the rows into work items {first entry,
// end entry, output row, partial slot or −1} of at most K entries, a
// row of more being cut evenly into several (so that no hub row sits on
// one group of lanes alone).  Every output row has at least one item; a
// row without entries writes zeros.
//
// The kernel: LANES lanes a work item (bf16: 16 lanes × 16 bytes make a
// 128-column row; f32: 32 × 16 bytes), consecutive items in consecutive
// groups and CTAs, so the blocks of one community, which read the same
// windows, run together and find their rows in L2.  A group loads LANES
// entries at once (lane k entry k, coalesced), then takes them kDepth (4)
// at a time: each lane broadcasts an entry by a shuffle, loads its 16
// bytes of the kDepth table rows into registers (all in flight together),
// and adds count · row to its f32 accumulators in entry order (explicit
// fmas).  The
// item writes its row once, or its f32 partial; a second kernel sums a
// split row's partials in item order.  Other widths D run 128-column
// panels (grid y); a D of no whole 16-byte vectors loads element by
// element.  No float atomics: the same bits on every run.
//
// Bound on this card: HBM bytes.  A launch on a layout seen before reads
// the plan (≈ 4 bytes an entry plus 16 an item), each table row that an
// entry names (once, if L2 keeps it between the entries that name it) and
// writes the output: ≈ 1.2 GB at the headline, ≈ 0.37 ms at 3.35 TB/s.
// For #19 at the uniform headline (tile_e 2048, 8M edges) every entry
// names its own message row: ≈ 2.22 GB in bf16, 0.66 ms, where the dense
// one-hot product would read 3.26 GB.
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ggnn {
namespace agather {

constexpr int kThreads = 256;
constexpr int kDepth = 4;        // table rows in flight a lane
constexpr int kLanesBf16 = 16;   // lanes an item of a bf16 table
constexpr int kPanel = 128;      // columns a grid y panel

// A plan entry: its table row and count.
struct Ent {
  int row, v;
};
__device__ __forceinline__ Ent decode(uint32_t e) {
  return {int(e >> 8), int(int8_t(e & 0xffu))};
}
__device__ __forceinline__ Ent decode(int2 e) { return {e.x, e.y}; }

__device__ __forceinline__ uint32_t shfl(unsigned mask, uint32_t e, int k,
                                         int width) {
  return __shfl_sync(mask, e, k, width);
}
__device__ __forceinline__ int2 shfl(unsigned mask, int2 e, int k,
                                     int width) {
  return make_int2(__shfl_sync(mask, e.x, k, width),
                   __shfl_sync(mask, e.y, k, width));
}

// The V elements of T at p as NW 32-bit words (bf16 pairs or f32), by
// vector loads (VEC: whole, aligned vectors) or element by element (the
// first n only; the rest 0).
template <typename T, int V, bool VEC>
__device__ __forceinline__ void load_row(const T* p, int n,
                                         uint32_t (&w)[V * sizeof(T) / 4]) {
  constexpr int NW = V * sizeof(T) / 4;
  if constexpr (VEC) {
    if constexpr (NW == 2) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = x.x;
      w[1] = x.y;
    } else {
#pragma unroll
      for (int i = 0; i < NW / 4; ++i) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = x.x;
        w[4 * i + 1] = x.y;
        w[4 * i + 2] = x.z;
        w[4 * i + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = 0u;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (i >= n) break;
      if constexpr (sizeof(T) == 2)
        w[i >> 1] |= uint32_t(__ldg(reinterpret_cast<const unsigned short*>(
                         p) + i)) << (16 * (i & 1));
      else
        w[i] = __ldg(reinterpret_cast<const uint32_t*>(p) + i);
    }
  }
}

// Element i of a row's words as f32 (a bf16 is its high half-word).
template <typename T>
__device__ __forceinline__ float elem(const uint32_t* w, int i) {
  if constexpr (sizeof(T) == 2)
    return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u)
                                   : (w[i >> 1] << 16));
  else
    return __uint_as_float(w[i]);
}

// Work item g = (global thread) / LANES, columns [c0 + lane·V, + V) of its
// row, c0 = 128·blockIdx.y.  items[g] = {first entry, end entry, output
// row, partial slot or −1}.
template <typename T, typename E, int LANES, bool VEC>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const T* __restrict__ table, int D, const E* __restrict__ ent,
    const int4* __restrict__ items, int n_items, float* __restrict__ ws,
    float* __restrict__ out) {
  constexpr int V = kPanel / LANES;
  constexpr int NW = V * sizeof(T) / 4;
  static_assert(LANES % kDepth == 0, "a depth never crosses an entry load");
  const int lane = threadIdx.x % LANES;
  const int g = (blockIdx.x * kThreads + threadIdx.x) / LANES;
  if (g >= n_items) return;  // the whole group
  unsigned mask = 0xffffffffu;  // the group's lanes
  if constexpr (LANES < 32)
    mask = ((1u << LANES) - 1u) << ((threadIdx.x & 31) & ~(LANES - 1));
  const int4 it = __ldg(items + g);
  const int col = blockIdx.y * kPanel + lane * V;
  const int ncols = min(V, D - col);
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  for (int base = it.x; base < it.y; base += LANES) {
    const int n = min(LANES, it.y - base);
    E mine;
    if (lane < n)
      mine = ent[base + lane];
    else
      mine = E{};
    for (int k0 = 0; k0 < n; k0 += kDepth) {
      uint32_t raw[kDepth][NW];
      int cnt[kDepth];
#pragma unroll
      for (int q = 0; q < kDepth; ++q) {
        const Ent e = decode(shfl(mask, mine, k0 + q, LANES));
        cnt[q] = e.v;
        if (k0 + q < n && ncols > 0) {
          load_row<T, V, VEC>(table + size_t(e.row) * D + col, ncols,
                              raw[q]);
        } else {
#pragma unroll
          for (int i = 0; i < NW; ++i) raw[q][i] = 0u;
        }
      }
#pragma unroll
      for (int q = 0; q < kDepth; ++q) {
        if (k0 + q >= n) break;
        const float c = float(cnt[q]);
#pragma unroll
        for (int i = 0; i < V; ++i)
          acc[i] = __fmaf_rn(c, elem<T>(raw[q], i), acc[i]);
      }
    }
  }
  if (ncols <= 0) return;
  float* dst = (it.w >= 0 ? ws + size_t(it.w) * D : out + size_t(it.z) * D) +
               col;
  if (ncols == V && D % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (i < ncols) dst[i] = acc[i];
  }
}

// A split row's partials (ws rows pbase[r] .. pbase[r] + items of row r,
// D floats each) summed in item order: CTA (i, y) writes columns
// [128 y, 128 y + 128) of row split[i].
__global__ void __launch_bounds__(kPanel) partial_rows_kernel(
    const int* __restrict__ split, const int* __restrict__ item_first,
    const int* __restrict__ pbase, const float* __restrict__ ws, int D,
    float* __restrict__ out) {
  const int r = split[blockIdx.x];
  const int col = blockIdx.y * kPanel + threadIdx.x;
  if (col >= D) return;
  const int n = item_first[r + 1] - item_first[r];
  const float* p = ws + size_t(pbase[r]) * D + col;
  float s = 0.0f;
#pragma unroll 4
  for (int k = 0; k < n; ++k) s += p[size_t(k) * D];
  out[size_t(r) * D + col] = s;
}

template <typename T, typename E>
int launch(const void* table, int D, const void* ent, const void* items,
           int n_items, const void* split, int n_split,
           const void* item_first, const void* pbase, void* ws, void* out,
           cudaStream_t s) {
  constexpr int LANES = sizeof(T) == 2 ? kLanesBf16 : 32;
  constexpr int V = kPanel / LANES;
  const dim3 grid((unsigned(n_items) * LANES + kThreads - 1) / kThreads,
                  (D + kPanel - 1) / kPanel);
  auto kernel = D % V == 0 ? gather_kernel<T, E, LANES, true>
                           : gather_kernel<T, E, LANES, false>;
  kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(table), D, static_cast<const E*>(ent),
      static_cast<const int4*>(items), n_items, static_cast<float*>(ws),
      static_cast<float*>(out));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return int(err);
  partial_rows_kernel<<<dim3(n_split, (D + kPanel - 1) / kPanel), kPanel, 0,
                        s>>>(static_cast<const int*>(split),
                             static_cast<const int*>(item_first),
                             static_cast<const int*>(pbase),
                             static_cast<const float*>(ws), D,
                             static_cast<float*>(out));
  return int(cudaGetLastError());
}

}  // namespace agather
}  // namespace ggnn

// #20 window_block_spmm.  dtype: 0 = float32, 1 = bfloat16 (the table
// [*, D]); packed: 1 = entries uint32 (row << 8 | count byte), 0 = int32
// pairs {row, count}; items int32 [n_items, 4] {first entry, end entry,
// output row, partial slot or −1}; split [n_split] the rows of several
// items, item_first [rows + 1] and pbase [rows] their items and first
// partial slots; ws f32 [partial slots, D]; out f32 [rows, D], every row
// written.  Returns the cudaError_t of the launches.
extern "C" int ggnn_window_auto_gather(int dtype, int packed,
                                       const void* table, int D,
                                       const void* ent, const void* items,
                                       int n_items, const void* split,
                                       int n_split, const void* item_first,
                                       const void* pbase, void* ws, void* out,
                                       void* stream) {
  using namespace ggnn::agather;
  if (n_items <= 0) return 0;
  if (D < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GGNN_LAUNCH(T, E)                                                   \
  return launch<T, E>(table, D, ent, items, n_items, split, n_split,        \
                      item_first, pbase, ws, out, s)
  if (dtype == 1 && packed) GGNN_LAUNCH(__nv_bfloat16, uint32_t);
  if (dtype == 1 && !packed) GGNN_LAUNCH(__nv_bfloat16, int2);
  if (dtype == 0 && packed) GGNN_LAUNCH(float, uint32_t);
  if (dtype == 0 && !packed) GGNN_LAUNCH(float, int2);
#undef GGNN_LAUNCH
  return int(cudaErrorInvalidValue);
}
