// The q8 node-transform table for Hopper (sm_90a).
//
// Replaces ggnn_tpu/ops/window_pallas.py::_table_block_q8_kernel (run by
// node_table_block_major_q8, #15).  For h [N, 128] (N % 128 == 0), msg_w
// [T2, 128, 128] and msg_b [T2, 128] in one dtype T (bf16 or f32), and
// windows of gtypes = W / 128 consecutive types, it writes for every source
// block i and window g (types t = g·gtypes + j):
//     v = h[i·128 + s] · W_t + b_t          (f32 products, f32 bias)
//     e = clip(ceil(log2(max(max|v| over the window, 1e-30)) − 6.9886), ±100)
//     out[(i·T2 + t)·128 + s] = int8(clip(rint(v · 2^−e), ±127))
//     scales[i·(T2 / gtypes) + g] = 2^e
// rint rounds half to even, as jnp.round; log2f may differ from XLA's log2
// by an ulp where the argument of ceil sits at an integer.
//
// Bound on this card: HBM bytes.  At the community headline (262,144
// nodes, T2 = 16, W 512, bf16) one call reads h (67 MB) and writes the int8
// table (537 MB): ≈ 0.18 ms at 3.35 TB/s, against 0.137 TFLOP of products.
// Design: one CTA per (source block, window); the block's rows and each
// W_t (transposed) staged in shared memory and multiplied by common.cuh's
// warp_gemm.  A window's scale needs the max over all its values before any
// of them is quantized, and gtypes [128, 128] f32 accumulators do not fit in
// registers, so the products run twice: a first pass for the max, a second
// (the same instructions on the same operands: the same bits) that
// quantizes.  This doubles the products (0.27 TFLOP, still under the
// bytes' time).  Wider states (D = 128·P) walk 128-column panels: each
// output panel's products sum over the P K-panels of h and W_t (h's panel
// staged anew for each), and the window's max covers every panel.
#include <stdint.h>

#include "common.cuh"

namespace ggnn {

template <typename T>
__global__ void __launch_bounds__(kThreads) node_table_q8_kernel(
    const T* __restrict__ h, const T* __restrict__ w, const T* __restrict__ b,
    int T2, int gtypes, int P, int8_t* __restrict__ out,
    float* __restrict__ scales) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  T* A_s = reinterpret_cast<T*>(smem);
  T* B_s = reinterpret_cast<T*>(smem + Smem<T>::tile);
  __shared__ float warp_max[kThreads / 32];
  __shared__ float e_s;
  const int i = blockIdx.x, g = blockIdx.y;
  const int row0 = (threadIdx.x >> 5) * 16;
  const int D = P * kD;
  const T* hb = h + size_t(i) * kRows * D;
  auto stage_h = [&](int kp) {  // K-panel kp of the source block's rows
    for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads)
      A_s[(idx / kD) * ld + idx % kD] =
          hb[size_t(idx / kD) * D + kp * kD + idx % kD];
  };
  if (P == 1) stage_h(0);

  float acc[kNT][4];
  float m = 0.0f;
  float inv = 0.0f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int j = 0; j < gtypes; ++j)
      for (int qp = 0; qp < P; ++qp) {  // output panel qp of type t
        const int t = g * gtypes + j;
        zero_acc(acc);
        for (int kp = 0; kp < P; ++kp) {
          __syncthreads();  // every warp is done with the previous W_t (and
                            // the first time: A_s is staged)
          if (P > 1) stage_h(kp);
          load_wt(B_s, w + (size_t(t) * D + kp * kD) * D, D, qp * kD);
          __syncthreads();
          warp_gemm(acc, A_s + row0 * ld, B_s);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = row0 + frag_row(e), col = qp * kD + frag_col(nt, e);
            const float v = acc[nt][e] + to_f(b[size_t(t) * D + col]);
            if (pass == 0) {
              m = fmaxf(m, fabsf(v));
            } else {
              const float q = fminf(fmaxf(rintf(v * inv), -127.0f), 127.0f);
              out[((size_t(i) * T2 + t) * kRows + r) * D + col] = int8_t(q);
            }
          }
      }
    if (pass == 0) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
      __syncthreads();
      if (threadIdx.x == 0) {
        float mm = warp_max[0];
        for (int k = 1; k < kThreads / 32; ++k) mm = fmaxf(mm, warp_max[k]);
        // log2(127) = 6.9886: max|v|·2^-e <= 127
        float e = ceilf(log2f(fmaxf(mm, 1e-30f)) - 6.9886f);
        e = fminf(fmaxf(e, -100.0f), 100.0f);
        e_s = e;
        scales[size_t(i) * (T2 / gtypes) + g] = exp2f(e);
      }
      __syncthreads();
      inv = exp2f(-e_s);
    }
  }
}

template <typename T>
static int launch_node_table_q8(const void* h, const void* w, const void* b,
                                int n_blocks, int T2, int gtypes, int P,
                                void* out, void* scales, cudaStream_t stream) {
  if (gtypes <= 0 || T2 % gtypes || P <= 0) return int(cudaErrorInvalidValue);
  const size_t smem = 2 * Smem<T>::tile;
  cudaError_t err = cudaFuncSetAttribute(
      node_table_q8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_blocks, T2 / gtypes);
  node_table_q8_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const T*>(b), T2, gtypes, P, static_cast<int8_t*>(out),
      static_cast<float*>(scales));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// dtype: 0 = float32, 1 = bfloat16 (h, msg_w, msg_b).  h [n_blocks·128, D],
// msg_w [T2, D, D], msg_b [T2, D] with D = 128·P; windows of gtypes types
// (T2 % gtypes == 0); out int8 [n_blocks·T2·128, D], scales f32
// [n_blocks·T2 / gtypes].  Returns the cudaError_t of the launch.
extern "C" int ggnn_node_table_q8(int dtype, const void* h, const void* msg_w,
                                  const void* msg_b, int n_blocks, int T2,
                                  int gtypes, int P, void* out, void* scales,
                                  void* stream) {
  if (n_blocks <= 0 || T2 <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return ggnn::launch_node_table_q8<__nv_bfloat16>(
        h, msg_w, msg_b, n_blocks, T2, gtypes, P, out, scales, s);
  if (dtype == 0)
    return ggnn::launch_node_table_q8<float>(h, msg_w, msg_b, n_blocks, T2,
                                             gtypes, P, out, scales, s);
  return int(cudaErrorInvalidValue);
}
