// GRU cell forward for Hopper (sm_90a).
//
// Replaces ggnn_tpu/ops/gru_pallas.py::gru_cell_fwd (_fwd_kernel): one pass
// per 128-row block computes pa = a·W_a + b, ph = h·U_zr, z, r and
// h̃ = tanh(pa_h + (r⊙h)·U_h), and writes h' (f32) plus the z, r, h̃
// residuals in the matmul dtype.
//
// Bound on this card: HBM bytes.  Per row it reads h and a (2 x 512 B f32)
// and writes h' (512 B) and three residuals (3 x 256 B in bf16) against
// 6·D² = 98K multiply-adds, about 45 flop/byte: below the H100's bf16 ridge
// (~295 flop/byte), so the gate matmuls must not add traffic.  The design
// keeps a, h and r⊙h in shared memory for the whole cell, streams the four
// [D, D] weight tiles of each product through one smem tile (the weights
// stay L2-resident across CTAs) and never writes the [N, 3D] pre-activations
// that a composition of library matmuls would materialize.
#include "common.cuh"

namespace ggnn {

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    gru_cell_kernel(const float* __restrict__ h, const float* __restrict__ a,
                    const T* __restrict__ wa, const float* __restrict__ b3,
                    const T* __restrict__ uzr, const T* __restrict__ uh,
                    float* __restrict__ out_h, T* __restrict__ out_z,
                    T* __restrict__ out_r, T* __restrict__ out_ht) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* A_s = reinterpret_cast<T*>(smem);
  T* H_s = reinterpret_cast<T*>(smem + Smem<T>::tile);
  T* W_s = reinterpret_cast<T*>(smem + 2 * Smem<T>::tile);
  const size_t base = size_t(blockIdx.x) * kRows * kD;
  stage_rows(A_s, a + base);
  stage_rows(H_s, h + base);
  gru_block<T, true>(A_s, H_s, W_s, h + base, wa, b3, uzr, uh, out_h + base,
                     out_z + base, out_r + base, out_ht + base);
}

template <typename T>
static int launch_gru_cell(const void* h, const void* a, const void* wa,
                           const void* b3, const void* uzr, const void* uh,
                           void* out_h, void* z, void* r, void* ht,
                           int n_blocks, cudaStream_t stream) {
  const size_t smem = 3 * Smem<T>::tile;
  cudaError_t err = cudaFuncSetAttribute(
      gru_cell_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  gru_cell_kernel<T><<<n_blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(a),
      static_cast<const T*>(wa), static_cast<const float*>(b3),
      static_cast<const T*>(uzr), static_cast<const T*>(uh),
      static_cast<float*>(out_h), static_cast<T*>(z), static_cast<T*>(r),
      static_cast<T*>(ht));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// dtype: 0 = float32, 1 = bfloat16 (matmul inputs, weights and residuals).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int ggnn_gru_cell(int dtype, const void* h, const void* a,
                             const void* wa, const void* b3, const void* uzr,
                             const void* uh, void* out_h, void* z, void* r,
                             void* ht, int n_blocks, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return ggnn::launch_gru_cell<__nv_bfloat16>(h, a, wa, b3, uzr, uh, out_h,
                                                z, r, ht, n_blocks, s);
  if (dtype == 0)
    return ggnn::launch_gru_cell<float>(h, a, wa, b3, uzr, uh, out_h, z, r,
                                        ht, n_blocks, s);
  return int(cudaErrorInvalidValue);
}

// Message of a cudaError_t returned by the entry points above.
extern "C" const char* ggnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
