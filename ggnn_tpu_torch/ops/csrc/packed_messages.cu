// The pallas backend's per-tile messages for Hopper (sm_90a), kernel #16.
//
// Replaces _messages_kernel of ggnn_tpu/ops/spmm_pallas.py (run by
// packed_messages).  The packed layout cuts the type-sorted edges into tiles
// of tile_e slots, each of one message type t = tile_type[i]; slot j of
// tile i holds the edge (src_j, mask_j).  The kernel writes
//     out[j] = (h[src_j] · W_t + b_t) · mask_j        (f32, [P, D])
// with the products of the compute dtype T's values accumulated in f32
// (mma.sync bf16 → f32; for T = f32 FMA loops, full f32, no TF32), the bias
// added in f32 and the mask multiplied last, the reference's rounding
// points.  The reference gathers h[src] with an XLA op into a [P, D] array
// before its kernel; here each CTA gathers its tile's rows by src straight
// into shared memory, so that array never exists.
//
// Design.  One CTA per (tile, 128-column panel of the output): it stages
// W_t's panel transposed in shared memory (32 KB in bf16 at D = 128) and the
// tile's rows, 128 at a time, gathered by src (16-byte loads where a row is
// whole 16-byte vectors, else element by element), both zero beyond D and
// beyond the tile, in K-chunks of 128 (D = 256: two chunks; D < 128 is
// zero-filled, which adds exact zeros); common.cuh's warp_gemm multiplies
// them, and the epilogue adds b_t, multiplies by the mask and stores f32.
// A 128-row chunk whose masks are all zero (padding slots, all-padding tail
// tiles) writes zeros without a product.  Every output row is written by one
// CTA: no atomics, the same bits on every run.
//
// Bound on this card: HBM bytes.  At the uniform headline (8M directed
// edges in 62,516 tiles of 128, D = 128, bf16) one call writes 4.1 GB of f32
// messages and reads h (67 MB), src and mask (64 MB): ≈ 1.26 ms at 3.35
// TB/s, against 0.26 TFLOP of products (0.27 ms at the dense bf16 tensor
// rate).  The gathered rows come from L2 or HBM at random (h's 67 MB does not
// fit in the 50 MB L2).  What this first version does not do: cp.async/TMA
// staging, wgmma, or keeping W_t resident across a type's consecutive tiles.
#include <stdint.h>

#include "common.cuh"

namespace ggnn {

template <typename T>
__global__ void __launch_bounds__(kThreads) packed_messages_kernel(
    const T* __restrict__ h, long long n_h, int D,
    const int* __restrict__ src, const float* __restrict__ mask,
    const int* __restrict__ tile_type, int tile_e,
    const T* __restrict__ w, const T* __restrict__ b, int T2,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  T* A_s = reinterpret_cast<T*>(smem);
  T* B_s = reinterpret_cast<T*>(smem + Smem<T>::tile);
  __shared__ int rows_s[kRows];
  __shared__ float mask_s[kRows];
  const int i = blockIdx.x, c0 = blockIdx.y * kRows;
  const int wid = min(kRows, D - c0);
  const int row0 = (threadIdx.x >> 5) * 16;
  const int t = min(max(tile_type[i], 0), T2 - 1);
  const T* wt = w + size_t(t) * D * D;
  const bool vec = (D % V) == 0;
  const long long base = (long long)i * tile_e;
  for (int r0 = 0; r0 < tile_e; r0 += kRows) {
    const int n = min(kRows, tile_e - r0);
    __syncthreads();  // every warp is done with the previous chunk
    if (threadIdx.x < kRows) {
      const int r = threadIdx.x;
      int s = -1;
      float m = 0.0f;
      if (r < n) {
        s = src[base + r0 + r];
        m = mask[base + r0 + r];
        if (s < 0 || s >= n_h) s = -1;  // refused by the wrapper; read 0
      }
      rows_s[r] = s;
      mask_s[r] = m;
    }
    const bool live = __syncthreads_or(threadIdx.x < n &&
                                       mask_s[threadIdx.x] != 0.0f);
    float* dst = out + (base + r0) * D + c0;
    if (!live) {  // all padding: (h[0]·W_t + b_t)·0 is a zero row
      for (int idx = threadIdx.x; idx < n * wid; idx += kThreads)
        dst[size_t(idx / wid) * D + idx % wid] = 0.0f;
      continue;
    }
    float acc[kNT][4];
    zero_acc(acc);
    for (int k0 = 0; k0 < D; k0 += kD) {
      const int kw = min(kD, D - k0);
      __syncthreads();  // every warp is done with the previous K-chunk
      if (vec && kw == kD) {
        // A_s[r][k] = h[rows_s[r]][k0 + k], one 16-byte vector a thread
        for (int idx = threadIdx.x; idx < kRows * (kD / V);
             idx += kThreads) {
          const int r = idx / (kD / V), v = idx % (kD / V);
          const int s = rows_s[r];
          uint4 x = make_uint4(0u, 0u, 0u, 0u);
          if (s >= 0)
            x = *reinterpret_cast<const uint4*>(h + size_t(s) * D + k0 +
                                                v * V);
          *reinterpret_cast<uint4*>(A_s + r * ld + v * V) = x;
        }
      } else {
        for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads) {
          const int r = idx / kD, k = idx % kD;
          const int s = rows_s[r];
          A_s[r * ld + k] = (s >= 0 && k < kw) ? h[size_t(s) * D + k0 + k]
                                               : from_f<T>(0.0f);
        }
      }
      // B_s[c][k] = W_t[k0 + k][c0 + c]
      for (int idx = threadIdx.x; idx < kD * kD; idx += kThreads) {
        const int k = idx / kD, c = idx % kD;
        B_s[c * ld + k] = (k < kw && c < wid)
                              ? wt[size_t(k0 + k) * D + c0 + c]
                              : from_f<T>(0.0f);
      }
      __syncthreads();
      warp_gemm(acc, A_s + row0 * ld, B_s);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + frag_row(e), c = frag_col(nt, e);
        if (r < n && c < wid)
          dst[size_t(r) * D + c] =
              (acc[nt][e] + to_f(b[size_t(t) * D + c0 + c])) * mask_s[r];
      }
  }
}

template <typename T>
static int launch_packed_messages(const void* h, long long n_h, int D,
                                  const void* src, const void* mask,
                                  const void* tile_type, int n_tiles,
                                  int tile_e, const void* w, const void* b,
                                  int T2, void* out, cudaStream_t stream) {
  if (D < 1 || tile_e <= 0 || T2 <= 0)
    return int(cudaErrorInvalidValue);
  const size_t smem = 2 * Smem<T>::tile;
  cudaError_t err = cudaFuncSetAttribute(
      packed_messages_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_tiles, (D + kD - 1) / kD);
  packed_messages_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), n_h, D, static_cast<const int*>(src),
      static_cast<const float*>(mask), static_cast<const int*>(tile_type),
      tile_e, static_cast<const T*>(w), static_cast<const T*>(b), T2,
      static_cast<float*>(out));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// dtype: 0 = float32, 1 = bfloat16 (h, msg_w and msg_b in it).  h [n_h, D],
// D >= 1; src int32 and mask f32 [n_tiles·tile_e]; tile_type int32
// [n_tiles]; msg_w [T2, D, D], msg_b [T2, D]; out f32 [n_tiles·tile_e, D].
// Returns the cudaError_t of the launch.
extern "C" int ggnn_packed_messages(int dtype, const void* h, long long n_h,
                                    int D, const void* src, const void* mask,
                                    const void* tile_type, int n_tiles,
                                    int tile_e, const void* msg_w,
                                    const void* msg_b, int T2, void* out,
                                    void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return ggnn::launch_packed_messages<__nv_bfloat16>(
        h, n_h, D, src, mask, tile_type, n_tiles, tile_e, msg_w, msg_b, T2,
        out, s);
  if (dtype == 0)
    return ggnn::launch_packed_messages<float>(h, n_h, D, src, mask,
                                               tile_type, n_tiles, tile_e,
                                               msg_w, msg_b, T2, out, s);
  return int(cudaErrorInvalidValue);
}
