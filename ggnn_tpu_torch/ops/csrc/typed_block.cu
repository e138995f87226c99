// Typed per-block scatter for Hopper (sm_90a), plain or with the GRU step
// fused into its epilogue, in f32: the first body of #1 and #2, which bf16
// replaced by typed_block_fused.cu (block-mode layouts have tile_e a
// multiple of 16, which that kernel takes).
//
// Replaces ggnn_tpu/ops/scatter_pallas.py::_typed_block_kernel (run by
// typed_block_scatter with fused=False and by typed_block_step_gru with
// fused=True).  For dst block b it computes
//     out[b·128 : (b+1)·128] = init_b + Σ_{t, c} T(onehot(b, t, c) @ H_{b,t,c}) @ W_t
// where slot (t, c) holds up to tile_e packed edges of type t whose rows
// start at (blk_off16[b] + slot_off16[b·S8 + t·cmax + c])·16 in h_pack and
// whose dst-local ids are row b·S8 + t·cmax + c of dstl_blk (−1 = padding).
// The one-hot product is taken in f32 and rounded to the compute dtype T per
// slot before the W_t product, exactly as the TPU kernel does.
//
// Bound on this card: the scattered reads of h_pack.  Per step at the
// headline (262,144 nodes, 8M directed edges, D = 128, bf16) the kernel
// reads 8.2M random 256-byte rows (2.1 GB) against 2·41K·128·128² ≈ 0.17
// TFLOP of slot products, far below the tensor-core rate; so the design
// spends its effort on the gather:
// - one CTA per 128-row dst block owns its output rows: no atomics in
//   global memory and no second pass;
// - the TPU kernel's resident W bank (512 KB) and block span (1.2 MB) do
//   not fit in shared memory, so W_t is loaded once per type (t outer,
//   chunk inner, as the TPU loop order allows) and each slot's rows are
//   staged through shared memory;
// - the one-hot product is the fixed-order segment sum of common.cuh
//   (segment_sum_ordered: each warp adds the rows of its own 16 dst rows in
//   row order into a [128, D] f32 buffer; no atomics, the same result on
//   every run);
// - the rounded sums go through mma.sync (bf16) or FMA loops (f32) into a
//   register accumulator that never leaves the SM until the block is done.
// Empty slots (offset −1) are skipped; they would add exactly zero.  Rows
// outside [0, n_pack) or dst ids outside [0, 128) are dropped, so a layout
// that does not belong to h_pack cannot address memory outside it.
#include "common.cuh"

namespace ggnn {

template <typename T>
struct BlockSmem {
  static constexpr size_t sums = size_t(kRows) * kD * sizeof(float);
  // region 0 holds the f32 sums and the staged slot rows, later the staged
  // h of the GRU epilogue
  static constexpr size_t work = sums + Stage<T>::bytes;
  static constexpr size_t r0 = work > Smem<T>::tile ? work : Smem<T>::tile;
  static constexpr size_t bytes = r0 + 2 * Smem<T>::tile;
};

template <typename T, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1) typed_block_kernel(
    const T* __restrict__ h_pack, long long n_pack,
    const int* __restrict__ dstl_blk, const int* __restrict__ slot_off16,
    const int* __restrict__ blk_off16, const T* __restrict__ msg_w, int T2,
    int cmax, int S8, int tile_e, const float* __restrict__ init,
    const float* __restrict__ hstate, const T* __restrict__ wa,
    const float* __restrict__ b3, const T* __restrict__ uzr,
    const T* __restrict__ uh, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  float* S = reinterpret_cast<float*>(smem);
  T* H_s = reinterpret_cast<T*>(smem + BlockSmem<T>::sums);
  T* A_s = reinterpret_cast<T*>(smem + BlockSmem<T>::r0);
  T* W_s = reinterpret_cast<T*>(smem + BlockSmem<T>::r0 + Smem<T>::tile);
  const int b = blockIdx.x;
  const int row0 = (threadIdx.x >> 5) * 16;
  const size_t out_base = size_t(b) * kRows * kD;

  float acc[kNT][4];
  if (FUSED) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[nt][e] =
            init[out_base + (row0 + frag_row(e)) * kD + frag_col(nt, e)];
  } else {
    zero_acc(acc);
  }

  const long long span0 = (long long)blk_off16[b] * 16;
  const int* slots = slot_off16 + size_t(b) * S8;
  for (int t = 0; t < T2; ++t) {
    bool any = false;
    for (int c = 0; c < cmax; ++c) any |= slots[t * cmax + c] >= 0;
    if (!any) continue;
    __syncthreads();  // every warp is done with the previous W_s
    // every warp sees the new W_s after the segment sum's barriers
    load_wt(W_s, msg_w + size_t(t) * kD * kD, kD, 0);
    for (int c = 0; c < cmax; ++c) {
      const int s = t * cmax + c;
      const int off = slots[s];
      if (off < 0) continue;
      zero_strip(S);
      segment_sum_ordered(S, H_s, h_pack, n_pack, span0 + (long long)off * 16,
                          dstl_blk + (size_t(b) * S8 + s) * tile_e, tile_e);
      round_strip(A_s, S);  // the slot's sums, rounded to T per slot
      warp_gemm(acc, A_s + row0 * ld, W_s);
    }
  }

  if (FUSED) {
    __syncthreads();
    T* H_s = reinterpret_cast<T*>(smem);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        A_s[(row0 + frag_row(e)) * ld + frag_col(nt, e)] =
            from_f<T>(acc[nt][e]);
    stage_rows(H_s, hstate + out_base);
    gru_block<T, false>(A_s, H_s, W_s, hstate + out_base, wa, b3, uzr, uh,
                        out + out_base, nullptr, nullptr, nullptr);
  } else {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[out_base + (row0 + frag_row(e)) * kD + frag_col(nt, e)] =
            acc[nt][e];
  }
}

template <typename T, bool FUSED>
static int launch_typed_block(const void* h_pack, long long n_pack,
                              const void* dstl_blk, const void* slot_off16,
                              const void* blk_off16, const void* msg_w,
                              int n_blocks, int T2, int cmax, int S8,
                              int tile_e, const void* init, const void* hstate,
                              const void* wa, const void* b3, const void* uzr,
                              const void* uh, void* out, cudaStream_t stream) {
  const size_t smem = BlockSmem<T>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      typed_block_kernel<T, FUSED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  typed_block_kernel<T, FUSED><<<n_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(h_pack), n_pack,
      static_cast<const int*>(dstl_blk), static_cast<const int*>(slot_off16),
      static_cast<const int*>(blk_off16), static_cast<const T*>(msg_w), T2,
      cmax, S8, tile_e, static_cast<const float*>(init),
      static_cast<const float*>(hstate), static_cast<const T*>(wa),
      static_cast<const float*>(b3), static_cast<const T*>(uzr),
      static_cast<const T*>(uh), static_cast<float*>(out));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// dtype: 0 = float32 (h_pack, msg_w and the GRU weights; bf16 runs
// ggnn_typed_block_fused); fused = 0: plain scatter (init, hstate, GRU
// weights unused, may be null).  Returns the cudaError_t of the launch (0 =
// success).
extern "C" int ggnn_typed_block(int dtype, int fused, const void* h_pack,
                                long long n_pack, const void* dstl_blk,
                                const void* slot_off16, const void* blk_off16,
                                const void* msg_w, int n_blocks, int T2,
                                int cmax, int S8, int tile_e, const void* init,
                                const void* hstate, const void* wa,
                                const void* b3, const void* uzr,
                                const void* uh, void* out, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GGNN_LAUNCH(T, F)                                                    \
  return ggnn::launch_typed_block<T, F>(                                     \
      h_pack, n_pack, dstl_blk, slot_off16, blk_off16, msg_w, n_blocks, T2,  \
      cmax, S8, tile_e, init, hstate, wa, b3, uzr, uh, out, s)
  if (dtype == 0 && fused) GGNN_LAUNCH(float, true);
  if (dtype == 0) GGNN_LAUNCH(float, false);
#undef GGNN_LAUNCH
  return int(cudaErrorInvalidValue);
}
