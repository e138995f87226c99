// The auto-pipelined windowed count-matrix SpMM for Hopper (sm_90a): kernel
// #20.
//
// Replaces _window_kernel of ggnn_tpu/ops/window_pallas.py (run by
// window_block_spmm).  For every dst block b of 128 rows and its tiles t in
// [tile_start[b], tile_start[b + 1]) with win_of_tile[t] = w >= 0,
//     out[b·128 + r] = Σ_t Σ_j C_c[r][j] · table[w·W + j]           (f32)
// with C_c the int8 count tile [128, W] at rows [c·128, (c + 1)·128) of the
// stream (c = c_off[t], or t without c_off) and table [R, D] in T (bf16 or
// f32).  A dummy tile (w < 0) adds nothing.  The TPU kernel zeroes a block
// at its first tile and never writes a block without tiles; here every
// block is written, such a block as zeros.
//
// Design.  The TPU kernel is one sequential grid over the tiles, each step
// one [128, W]·[W, D] product into the output block that Pallas keeps
// resident while consecutive tiles hit it (its automatic pipelining fetches
// the next tile's C and window meanwhile).  Here one CTA per (dst block,
// 128-column panel of D) walks the block's tiles in order; unlike #11
// (window_mono.cu) there is no work-item split of a long block.  At W = 512
// a bf16 window is 128 KB, so each tile runs in K-chunks of 128 window rows:
// the chunk of C as the A operand [128][128] in T, the table rows as the
// transposed B operand, multiplied by common.cuh's warp_gemm (mma.sync bf16
// in, f32 accumulators in registers; the counts, at most 127, are exact in
// bf16) or, for an f32 table, its FMA loops (no TF32).  The block is written
// once: no atomics, the same bits on every run.
//
// Bound on this card: HBM bytes.  At the community headline's default
// window layout (W 512, 128-row blocks, 262,144 nodes, 8M directed edges,
// D = 128, bf16) a call reads the count stream's real tiles (64 KB each)
// and each tile's window (128 KB), and writes 134 MB.  What this first
// version does not do: decode the ~99 %-zero count tiles sparsely, share a
// window between the blocks that read it, TMA or wgmma.
#include <stdint.h>

#include "common.cuh"

namespace ggnn {

template <typename T>
__global__ void __launch_bounds__(kThreads) window_auto_kernel(
    const T* __restrict__ table, long long n_table, int D,
    const int8_t* __restrict__ counts, long long n_c,
    const int* __restrict__ tile_start, const int* __restrict__ win_of_tile,
    const int* __restrict__ c_off, int n_tiles, int window,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  T* A_s = reinterpret_cast<T*>(smem);                  // A[r][k] = C
  T* B_s = reinterpret_cast<T*>(smem + Smem<T>::tile);  // Bt[n][k] = table
  const int b = blockIdx.x, c0 = blockIdx.y * kD, wid = min(kD, D - c0);
  const int row0 = (threadIdx.x >> 5) * 16;
  const int t1 = min(max(tile_start[b + 1], 0), n_tiles);
  const int t0 = min(max(tile_start[b], 0), t1);
  float acc[kNT][4];
  zero_acc(acc);
  for (int t = t0; t < t1; ++t) {
    const int w = win_of_tile[t];
    const long long c = c_off ? c_off[t] : t;
    if (w < 0 || c < 0 || c >= n_c) continue;  // a dummy tile adds nothing
    const int8_t* C = counts + size_t(c) * kRows * window;
    const long long base = (long long)w * window;
    for (int j0 = 0; j0 < window; j0 += kD) {
      const int nk = min(kD, window - j0);
      __syncthreads();  // every warp is done with the previous chunk
      for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads) {
        // A_s[r][k] = C[r][j0 + k]
        const int r = idx / kD, k = idx % kD;
        A_s[r * ld + k] =
            from_f<T>(k < nk ? float(C[size_t(r) * window + j0 + k]) : 0.0f);
        // B_s[n][k] = table[base + j0 + k][c0 + n]
        const int kk = idx / kD, n = idx % kD;
        const long long row = base + j0 + kk;
        B_s[n * ld + kk] = (kk < nk && n < wid && row < n_table)
                               ? table[size_t(row) * D + c0 + n]
                               : from_f<T>(0.0f);
      }
      __syncthreads();
      warp_gemm(acc, A_s + row0 * ld, B_s);
    }
  }
  float* dst = out + size_t(b) * kRows * D + c0;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = frag_col(nt, e);
      if (col < wid) dst[size_t(row0 + frag_row(e)) * D + col] = acc[nt][e];
    }
}

template <typename T>
static int launch_window_auto(const void* table, long long n_table, int D,
                              const void* counts, long long n_c,
                              const void* tile_start, const void* win_of_tile,
                              const void* c_off, int n_tiles, int n_blocks,
                              int window, void* out, cudaStream_t stream) {
  if (D < 1 || window < 1) return int(cudaErrorInvalidValue);
  const size_t smem = 2 * Smem<T>::tile;
  cudaError_t err = cudaFuncSetAttribute(
      window_auto_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_blocks, (D + kD - 1) / kD);
  window_auto_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(table), n_table, D,
      static_cast<const int8_t*>(counts), n_c,
      static_cast<const int*>(tile_start),
      static_cast<const int*>(win_of_tile), static_cast<const int*>(c_off),
      n_tiles, window, static_cast<float*>(out));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// #20 window_block_spmm.  dtype: 0 = float32, 1 = bfloat16 (the table).
// table [n_table, D]; counts int8 [n_c·128, window]; tile_start int32
// [n_blocks + 1] (clamped to [0, n_tiles]); win_of_tile int32 [n_tiles]
// (< 0: a dummy tile); c_off int32 [n_tiles] or null (tile t reads count
// tile t); out f32 [n_blocks·128, D], every row written.  Table rows past
// n_table and count tiles outside [0, n_c) add nothing.  Returns the
// cudaError_t of the launch.
extern "C" int ggnn_window_auto(int dtype, const void* table,
                                long long n_table, int D, const void* counts,
                                long long n_c, const void* tile_start,
                                const void* win_of_tile, const void* c_off,
                                int n_tiles, int n_blocks, int window,
                                void* out, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return ggnn::launch_window_auto<__nv_bfloat16>(
        table, n_table, D, counts, n_c, tile_start, win_of_tile, c_off,
        n_tiles, n_blocks, window, out, s);
  if (dtype == 0)
    return ggnn::launch_window_auto<float>(table, n_table, D, counts, n_c,
                                           tile_start, win_of_tile, c_off,
                                           n_tiles, n_blocks, window, out, s);
  return int(cudaErrorInvalidValue);
}
