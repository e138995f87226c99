// Fixed-order segment sums for Hopper (sm_90a): the port's float segment
// sums (ops/segment_rows.py::segment_rows_sum),
//     out[r] = Σ_{i: seg_i = r} vals_i        (r < n_rows; other ids dropped)
// in the order of a plan made once per index tensor, so that the same
// inputs give the same bits on every run.  The JAX package sums these with
// jax.ops.segment_sum (ggnn_tpu/ops/segment.py:57), which XLA lowers to a
// scatter-add; the port's atomics-based index_add_ summed in whatever order
// the atomics landed.
//
// Design.  The plan (host of the launch, torch ops on the device) sorts the
// segment ids stably: order[] lists each row's entries in index order, rows
// ascending.  A row of more than K entries is cut into chunks of K, each a
// work item {row, begin, end, slot}.  Kernel 1: one warp per work item,
// lanes across the columns (float4 / double2 where the row width and the
// alignment allow, else one element per lane), adds the item's rows in
// plan order, UNROLL row loads in flight; an item of a row that was not
// cut writes the row of out, one of a cut row its partial into slot of a
// workspace.  Kernel 2: one warp per cut row adds its chunk partials in
// chunk order (as partial_sum.cuh does for the split blocks).  f32 values
// sum in f32, f64 in f64.  No atomics: a row is written by one warp.  This
// is a row reduction that Triton would serve as well; it is CUDA because
// the port has one build path (nvcc into the ctypes library).
//
// Bound on this card: HBM bytes.  Each entry's row is read once, the order
// once, each output row written once: at the uniform headline (8M directed
// edges, 262,144 rows, D = 128, f32) 4.1 GB of messages, ≈ 1.2 ms at 3.35
// TB/s; its M·D additions take 0.02 ms at the f32 rate.
#include <stdint.h>

#include <cuda_runtime.h>

namespace ggnn {

constexpr int kSegThreads = 256;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSegUnroll = 8;

template <typename T, int V>
__device__ __forceinline__ void seg_load(const T* __restrict__ p, T (&x)[V]) {
  if constexpr (V == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else if constexpr (V == 2) {
    const double2 d = __ldg(reinterpret_cast<const double2*>(p));
    x[0] = d.x;
    x[1] = d.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <typename T, int V>
__device__ __forceinline__ void seg_store(T* __restrict__ p, const T (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// items: int4 {row, begin, end, slot} (slot < 0: the row's only item, which
// writes out; else its partial goes to ws[slot]).
template <typename T, int V>
__global__ void __launch_bounds__(kSegThreads) segment_rows_kernel(
    const T* __restrict__ vals, int D, const int* __restrict__ order,
    const int4* __restrict__ items, int n_items, T* __restrict__ ws,
    T* __restrict__ out) {
  const int i = blockIdx.x * kSegWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n_items) return;  // the whole warp leaves together
  const int4 it = items[i];
  T* dst = it.w < 0 ? out + size_t(it.x) * D : ws + size_t(it.w) * D;
  for (int c = lane * V; c < D; c += 32 * V) {
    T acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = T(0);
    int j = it.y;
    for (; j + kSegUnroll <= it.z; j += kSegUnroll) {
      T x[kSegUnroll][V];
#pragma unroll
      for (int u = 0; u < kSegUnroll; ++u)
        seg_load<T, V>(vals + size_t(__ldg(order + j + u)) * D + c, x[u]);
#pragma unroll
      for (int u = 0; u < kSegUnroll; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] += x[u][v];
    }
    for (; j < it.z; ++j) {
      T x[V];
      seg_load<T, V>(vals + size_t(__ldg(order + j)) * D + c, x);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += x[v];
    }
    seg_store<T, V>(dst + c, acc);
  }
}

// One warp per cut row: its n chunk partials (slots first .. first + n - 1)
// added in chunk order.
template <typename T>
__global__ void __launch_bounds__(kSegThreads) segment_rows_partials(
    const int* __restrict__ split_row, const int* __restrict__ split_first,
    const int* __restrict__ split_n, int n_split, const T* __restrict__ ws,
    int D, T* __restrict__ out) {
  const int s = blockIdx.x * kSegWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= n_split) return;
  const size_t first = split_first[s];
  const int n = split_n[s];
  T* dst = out + size_t(split_row[s]) * D;
  for (int c = lane; c < D; c += 32) {
    T acc = T(0);
    for (int k = 0; k < n; ++k) acc += ws[(first + k) * D + c];
    dst[c] = acc;
  }
}

template <typename T, int V>
int launch_segment_rows(const void* vals, int D, const void* order,
                        const void* items, int n_items, void* ws,
                        const void* split_row, const void* split_first,
                        const void* split_n, int n_split, void* out,
                        cudaStream_t s) {
  const unsigned blocks = unsigned((n_items + kSegWarps - 1) / kSegWarps);
  segment_rows_kernel<T, V><<<blocks, kSegThreads, 0, s>>>(
      static_cast<const T*>(vals), D, static_cast<const int*>(order),
      static_cast<const int4*>(items), n_items, static_cast<T*>(ws),
      static_cast<T*>(out));
  if (n_split > 0) {
    const unsigned b2 = unsigned((n_split + kSegWarps - 1) / kSegWarps);
    segment_rows_partials<T><<<b2, kSegThreads, 0, s>>>(
        static_cast<const int*>(split_row),
        static_cast<const int*>(split_first),
        static_cast<const int*>(split_n), n_split,
        static_cast<const T*>(ws), D, static_cast<T*>(out));
  }
  return int(cudaGetLastError());
}

}  // namespace ggnn

// dtype 0: f32 values, 1: f64; vec 1: rows read as float4 / double2 (D a
// multiple of 4 / 2, vals 16-byte aligned).  vals [M, D]; order int32 [M]
// (the plan's entry order); items int32 [n_items, 4]; ws [slots, D] of the
// values' type (null without cut rows); split_row, split_first, split_n
// int32 [n_split]; out [n_rows, D], zero where no item writes.  Returns the
// cudaError_t of the launches.
extern "C" int ggnn_segment_rows(int dtype, int vec, const void* vals, int D,
                                 const void* order, const void* items,
                                 int n_items, void* ws, const void* split_row,
                                 const void* split_first, const void* split_n,
                                 int n_split, void* out, void* stream) {
  if (n_items <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? ggnn::launch_segment_rows<float, 4>(
                     vals, D, order, items, n_items, ws, split_row,
                     split_first, split_n, n_split, out, s)
               : ggnn::launch_segment_rows<float, 1>(
                     vals, D, order, items, n_items, ws, split_row,
                     split_first, split_n, n_split, out, s);
  if (dtype == 1)
    return vec ? ggnn::launch_segment_rows<double, 2>(
                     vals, D, order, items, n_items, ws, split_row,
                     split_first, split_n, n_split, out, s)
               : ggnn::launch_segment_rows<double, 1>(
                     vals, D, order, items, n_items, ws, split_row,
                     split_first, split_n, n_split, out, s);
  return int(cudaErrorInvalidValue);
}
