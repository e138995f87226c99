// The block-major node-transform table for Hopper (sm_90a).
//
// Replaces ggnn_tpu/ops/window_pallas.py::_table_block_kernel (run by
// node_table_block_major).  For h [N, D] (N % 128 == 0), msg_w [T2, D, D]
// and msg_b [T2, D], all in one dtype T (bf16 or f32), it writes
//     out[i·T2·128 + t·128 + s] = T(h[i·128 + s] · W_t + b_t)
// for every 128-row source block i, type t and row s: the products
// accumulate in f32, the bias is added in f32, and the sum is rounded once
// to T.  The legacy table-gather forward gathers its messages from these
// rows (layout row_order = 'block').
//
// Bound on this card: HBM bytes.  At the uniform headline (262,144 nodes,
// T2 = 16, D = 128, bf16) one call reads h (67 MB) and writes the table
// (1.07 GB): ≈ 0.34 ms at 3.35 TB/s, against 0.14 TFLOP of products
// (0.14 ms at the dense bf16 tensor rate).  Design: one CTA per (source block
// i, type t, panel of 128 output columns); the block's rows (A) and W_t's
// panel (B, transposed) are staged in shared memory in K-chunks of 128,
// zero beyond D, and multiplied by common.cuh's warp_gemm (mma.sync bf16,
// or FMA loops in the same fragment layout for f32, so an f32 table keeps
// full f32 products); the rounded result goes back through shared memory
// so that the table's rows are written with coalesced stores.  h is re-read
// once per (type, panel), from L2.  D may be any width >= 1.
#include <stdint.h>

#include "common.cuh"

namespace ggnn {

template <typename T>
__global__ void __launch_bounds__(kThreads) node_table_kernel(
    const T* __restrict__ h, const T* __restrict__ w, const T* __restrict__ b,
    int D, int T2, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  T* A_s = reinterpret_cast<T*>(smem);
  T* B_s = reinterpret_cast<T*>(smem + Smem<T>::tile);
  const int i = blockIdx.x, t = blockIdx.y, c0 = blockIdx.z * kRows;
  const int wid = min(kRows, D - c0);
  const int row0 = (threadIdx.x >> 5) * 16;
  const T* hb = h + size_t(i) * kRows * D;
  const T* wt = w + size_t(t) * D * D;
  float acc[kNT][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < D; k0 += kD) {
    __syncthreads();  // every warp is done with the previous chunk
    for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads) {
      // A_s[r][k] = h[i·128 + r][k0 + k]
      const int r = idx / kD, k = idx % kD;
      A_s[r * ld + k] = k0 + k < D ? hb[size_t(r) * D + k0 + k]
                                   : from_f<T>(0.0f);
      // B_s[n][k] = W_t[k0 + k][c0 + n]: consecutive threads read
      // consecutive columns of one row of W_t
      const int kk = idx / kD, n = idx % kD;
      B_s[n * ld + kk] = (k0 + kk < D && n < wid)
                             ? wt[size_t(k0 + kk) * D + c0 + n]
                             : from_f<T>(0.0f);
    }
    __syncthreads();
    warp_gemm(acc, A_s + row0 * ld, B_s);
  }
  __syncthreads();  // A_s is free: the rounded rows go there
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + frag_row(e), col = frag_col(nt, e);
      if (col < wid)
        A_s[r * ld + col] =
            from_f<T>(acc[nt][e] + to_f(b[size_t(t) * D + c0 + col]));
    }
  __syncthreads();
  T* dst = out + (size_t(i) * T2 + t) * kRows * D + c0;
  for (int idx = threadIdx.x; idx < kRows * wid; idx += kThreads) {
    const int r = idx / wid, col = idx % wid;
    dst[size_t(r) * D + col] = A_s[r * ld + col];
  }
}

template <typename T>
static int launch_node_table(const void* h, const void* w, const void* b,
                             int n_blocks, int D, int T2, void* out,
                             cudaStream_t stream) {
  if (D < 1) return int(cudaErrorInvalidValue);
  const size_t smem = 2 * Smem<T>::tile;
  cudaError_t err = cudaFuncSetAttribute(
      node_table_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_blocks, T2, (D + kRows - 1) / kRows);
  node_table_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const T*>(b), D, T2, static_cast<T*>(out));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// dtype: 0 = float32, 1 = bfloat16 (h, msg_w, msg_b and out all in it).
// h [n_blocks·128, D], msg_w [T2, D, D], msg_b [T2, D], out
// [n_blocks·T2·128, D], D >= 1.  Returns the cudaError_t of the
// launch.
extern "C" int ggnn_node_table(int dtype, const void* h, const void* msg_w,
                               const void* msg_b, int n_blocks, int D, int T2,
                               void* out, void* stream) {
  if (n_blocks <= 0 || T2 <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return ggnn::launch_node_table<__nv_bfloat16>(h, msg_w, msg_b, n_blocks,
                                                  D, T2, out, s);
  if (dtype == 0)
    return ggnn::launch_node_table<float>(h, msg_w, msg_b, n_blocks, D, T2,
                                          out, s);
  return int(cudaErrorInvalidValue);
}
