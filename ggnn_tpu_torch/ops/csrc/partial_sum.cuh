// The second kernel of the split STORE forms (#12 window_ondemand_fused.cu,
// #7 typed_tile_fused.cu, #11/#8 window_mono_fused.cu) for Hopper (sm_90a):
// a split block's work-item partials summed in item order and stored in f32
// or, rounded once, in bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ggnn {

// The split blocks' partials (out_rows·128 floats a slot, slots pbase[b] ..
// pbase[b] + items of block b) summed in item order: CTA (i, j) sums
// float4 columns [NT j, NT j + NT) of block split[i], so a hub block's sum
// spreads over out_rows·32 / NT CTAs and no SM sums a hub alone; a thread
// keeps UNROLL of its loads in flight.  The same order on every run: the
// same bits.
template <int NT, int UNROLL = 4, typename TO = float>
__global__ void __launch_bounds__(NT) partial_sum_kernel(
    const int* __restrict__ split, const int* __restrict__ item_first,
    const int* __restrict__ pbase, const float* __restrict__ ws, int out_rows,
    TO* __restrict__ out) {
  const int per = out_rows * 128 / 4;  // float4 of a block
  const int ctas = per / NT;
  const int b = split[blockIdx.x / ctas];
  const int v = (blockIdx.x % ctas) * NT + threadIdx.x;
  const int n = item_first[b + 1] - item_first[b];
  const float4* slot =
      reinterpret_cast<const float4*>(ws) + size_t(pbase[b]) * per + v;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll (UNROLL)
  for (int k = 0; k < n; ++k) {
    const float4 x = slot[size_t(k) * per];
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  if constexpr (sizeof(TO) == 4) {
    reinterpret_cast<float4*>(out)[size_t(b) * per + v] = s;
  } else {
    __nv_bfloat162* o =
        reinterpret_cast<__nv_bfloat162*>(out) + 2 * (size_t(b) * per + v);
    o[0] = __floats2bfloat162_rn(s.x, s.y);
    o[1] = __floats2bfloat162_rn(s.z, s.w);
  }
}

// Launches it over the n_split blocks of `split` (out_rows·32 divisible by
// NT); out is TO.
template <int NT, int UNROLL = 4, typename TO = float>
int launch_partial_sum(const void* split, const void* item_first,
                       const void* pbase, const void* ws, int n_split,
                       int out_rows, void* out, cudaStream_t s) {
  const int ctas = out_rows * 128 / 4 / NT;
  partial_sum_kernel<NT, UNROLL, TO><<<n_split * ctas, NT, 0, s>>>(
      static_cast<const int*>(split), static_cast<const int*>(item_first),
      static_cast<const int*>(pbase), static_cast<const float*>(ws), out_rows,
      static_cast<TO*>(out));
  return int(cudaGetLastError());
}

}  // namespace ggnn
