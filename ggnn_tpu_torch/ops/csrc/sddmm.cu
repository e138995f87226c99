// Per-edge dot products (SDDMM) for Hopper (sm_90a), kernel #17.
//
// Replaces _sddmm_kernel of ggnn_tpu/ops/spmm_pallas.py (run by
// sddmm_pallas): the scores of the SDDMM edge gates,
//     out[e] = ⟨p[u_e], q[v_e]⟩ · mask[e]      (f32, [E])
// with u_e = src[e] and v_e = dst[e] where index arrays are given (a null
// pointer means row e: the reference's pre-gathered [E, G] operands) and
// mask 1 where none is given.  G is any width; E any length.
//
// Design.  One warp per edge: lane l takes the row elements l·4 .. l·4 + 3,
// then every 128th further on, as float4 loads where G is a multiple of 4
// (else one element per lane, every 32nd), and adds its products in that
// order; the warp then reduces its 32 partial sums with xor shuffles (16, 8,
// 4, 2, 1), a fixed order, so two runs give the same bits.  With the index
// arrays the rows are read where they lie and the [E, G] gathered copies of
// the reference (2 × 4.1 GB a step at the uniform headline, G = 128) never
// exist.  This is a row reduction that Triton would serve as well; it is
// CUDA because the port has one build path (nvcc into the ctypes library)
// and no Triton.
//
// Bound on this card: HBM bytes.  The function reads p and q once (2 × 134
// MB at 262,144 nodes, G = 128), the index arrays and the mask, and writes
// E floats: ≈ 0.13 ms at 3.35 TB/s for E = 8M; its 2·E·G operations take
// 0.03 ms at the f32 rate.  Each edge's rows are gathered at random (8.2 GB
// of row reads for 8M edges, partly from L2), which this first version
// does not reorder.
#include <stdint.h>

#include <cuda_runtime.h>

namespace ggnn {

constexpr int kSddmmThreads = 256;
constexpr int kSddmmWarps = kSddmmThreads / 32;

template <bool VEC>
__global__ void __launch_bounds__(kSddmmThreads) sddmm_kernel(
    const float* __restrict__ p, long long n_p, const float* __restrict__ q,
    long long n_q, int G, const int* __restrict__ src,
    const int* __restrict__ dst, const float* __restrict__ mask,
    long long E, float* __restrict__ out) {
  const long long e =
      (long long)blockIdx.x * kSddmmWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= E) return;  // the whole warp leaves together
  const long long u = src ? (long long)src[e] : e;
  const long long v = dst ? (long long)dst[e] : e;
  float s = 0.0f;
  if (u >= 0 && u < n_p && v >= 0 && v < n_q) {  // the wrapper refuses others
    const float* pr = p + u * G;
    const float* qr = q + v * G;
    if constexpr (VEC) {
      for (int j = lane * 4; j < G; j += 128) {
        const float4 a = *reinterpret_cast<const float4*>(pr + j);
        const float4 c = *reinterpret_cast<const float4*>(qr + j);
        s = __fmaf_rn(a.x, c.x, s);
        s = __fmaf_rn(a.y, c.y, s);
        s = __fmaf_rn(a.z, c.z, s);
        s = __fmaf_rn(a.w, c.w, s);
      }
    } else {
      for (int j = lane; j < G; j += 32) s += pr[j] * qr[j];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[e] = mask ? s * mask[e] : s;
}

}  // namespace ggnn

// p f32 [n_p, G], q f32 [n_q, G] (16-byte aligned); src, dst int32 [E] or
// null (row e); mask f32 [E] or null (1); out f32 [E].  Returns the
// cudaError_t of the launch.
extern "C" int ggnn_sddmm(const void* p, long long n_p, const void* q,
                          long long n_q, int G, const void* src,
                          const void* dst, const void* mask, long long E,
                          void* out, void* stream) {
  if (E <= 0) return 0;
  if (G < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (E + ggnn::kSddmmWarps - 1) / ggnn::kSddmmWarps;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const auto* pf = static_cast<const float*>(p);
  const auto* qf = static_cast<const float*>(q);
  const auto* si = static_cast<const int*>(src);
  const auto* di = static_cast<const int*>(dst);
  const auto* mf = static_cast<const float*>(mask);
  auto* of = static_cast<float*>(out);
  if (G % 4 == 0)
    ggnn::sddmm_kernel<true><<<unsigned(blocks), ggnn::kSddmmThreads, 0, s>>>(
        pf, n_p, qf, n_q, G, si, di, mf, E, of);
  else
    ggnn::sddmm_kernel<false><<<unsigned(blocks), ggnn::kSddmmThreads, 0,
                                s>>>(pf, n_p, qf, n_q, G, si, di, mf, E, of);
  return int(cudaGetLastError());
}
