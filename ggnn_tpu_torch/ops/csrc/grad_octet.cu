// Reverse scatter of the typed-pack backward for Hopper (sm_90a).
//
// Replaces ggnn_tpu/ops/scatter_pallas.py::_grad_octet_kernel (run by
// typed_grad_octet_scatter).  It computes Y[row] = Σ_{e packed to row} G[e]
// over the octet grad layout: grad block gb = 8·o + j (octet o, block j of
// the octet) has C slots; slot c holds up to g_tile packed rows of G
// starting at (oblk16[o] + slot_off16[gb·C + c])·16, whose block-local
// target rows are row o·R8 + j·C + c of dstl_oct (−1 = padding, and an
// offset of −1 marks an empty slot).  Y is [n_oct·8·128, D] in the output
// dtype, summed in f32.
//
// Bound on this card: HBM bytes.  At the headline (262,144 nodes, 8M
// directed edges, 16 message types, D = 128, bf16) one call reads 8.25M
// gathered rows of G (2.1 GB), the 64 MB dstl stream, and writes Y
// (4.19M rows, 1.07 GB): ≈ 1.0 ms at 3.35 TB/s.  There is no arithmetic to
// speak of (the TPU kernel's one-hot MXU product is a segment sum).  The
// octet grouping exists on the TPU to amortize DMAs; here it is only the
// addressing scheme of the reference's arrays:
// - one CTA per 128-row grad block owns its output rows, so there are no
//   global atomics and every row of Y is written exactly once (rows of an
//   octet past the last grad block, and blocks with no slot, come out 0);
// - the block's rows are summed into a [128, D] f32 shared-memory buffer by
//   the fixed-order segment sum of common.cuh (segment_sum_ordered: each
//   warp adds the rows of its own 16 output rows in row order; no atomics,
//   the same result on every run), then flushed once in the output dtype.
// Empty slots are skipped and −1 dstl entries dropped, so both add exactly
// 0.  Rows outside [0, n_G) and dst ids outside [0, 128) are dropped too, so
// a layout that does not belong to G cannot address memory outside it.
#include "common.cuh"

namespace ggnn {

template <typename TG, typename TO>
__global__ void __launch_bounds__(kThreads) grad_octet_kernel(
    const TG* __restrict__ G, long long n_G, const int* __restrict__ dstl_oct,
    const int* __restrict__ slot_off16, const int* __restrict__ oblk16,
    int g_tile, int C, int R8, TO* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);
  TG* H_s = reinterpret_cast<TG*>(smem + kRows * kD * sizeof(float));
  const int gb = blockIdx.x;  // grad block: octet gb / 8, block gb % 8
  const int o = gb >> 3, j = gb & 7;
  zero_strip(S);
  const long long span0 = (long long)oblk16[o] * 16;
  for (int c = 0; c < C; ++c) {
    const int off = slot_off16[size_t(gb) * C + c];
    if (off < 0) continue;
    segment_sum_ordered(S, H_s, G, n_G, span0 + (long long)off * 16,
                        dstl_oct + (size_t(o) * R8 + j * C + c) * g_tile,
                        g_tile);
  }
  __syncthreads();
  TO* dst = out + size_t(gb) * kRows * kD;
  for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads)
    dst[idx] = from_f<TO>(S[idx]);
}

template <typename TG, typename TO>
static int launch_grad_octet(const void* G, long long n_G, const void* dstl,
                             const void* slot, const void* oblk, int n_oct,
                             int g_tile, int C, int R8, void* out,
                             cudaStream_t stream) {
  const size_t smem = size_t(kRows) * kD * sizeof(float) + Stage<TG>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      grad_octet_kernel<TG, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  grad_octet_kernel<TG, TO><<<n_oct * 8, kThreads, smem, stream>>>(
      static_cast<const TG*>(G), n_G, static_cast<const int*>(dstl),
      static_cast<const int*>(slot), static_cast<const int*>(oblk), g_tile, C,
      R8, static_cast<TO*>(out));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// g_dtype, out_dtype: 0 = float32, 1 = bfloat16.  out is [n_oct·8·128, 128].
// Returns the cudaError_t of the launch (0 = success).
extern "C" int ggnn_grad_octet(int g_dtype, int out_dtype, const void* G,
                               long long n_G, const void* dstl_oct,
                               const void* slot_off16, const void* oblk16,
                               int n_oct, int g_tile, int C, int R8, void* out,
                               void* stream) {
  if (n_oct <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GGNN_LAUNCH(TG, TO)                                                  \
  return ggnn::launch_grad_octet<TG, TO>(G, n_G, dstl_oct, slot_off16,       \
                                         oblk16, n_oct, g_tile, C, R8, out, s)
  if (g_dtype == 1 && out_dtype == 1) GGNN_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (g_dtype == 1 && out_dtype == 0) GGNN_LAUNCH(__nv_bfloat16, float);
  if (g_dtype == 0 && out_dtype == 1) GGNN_LAUNCH(float, __nv_bfloat16);
  if (g_dtype == 0 && out_dtype == 0) GGNN_LAUNCH(float, float);
#undef GGNN_LAUNCH
  return int(cudaErrorInvalidValue);
}
