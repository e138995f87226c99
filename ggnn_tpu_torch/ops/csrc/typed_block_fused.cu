// The per-block typed kernels #1 and #2 in bf16 for Hopper (sm_90a): the
// typed pack's block-mode scatter (#1, the STORE form) and the same with
// the GRU step in its epilogue (#2, FUSED).
//
// Replaces ggnn_tpu/ops/scatter_pallas.py::_typed_block_kernel (run by
// typed_block_scatter with fused=False and by typed_block_step_gru with
// fused=True).  For dst block b it computes
//     s = Σ_{t, c} T(onehot(b, t, c) @ H_{b,t,c}) @ W_t
// where slot s = t·cmax + c of block b holds up to tile_e packed edges of
// type t whose rows start at (blk_off16[b] + slot_off16[b·S8 + s])·16 in
// h_pack and whose dst-local ids are row b·S8 + s of dstl_blk (−1 =
// padding); the one-hot product in f32, rounded to bf16 PER SLOT before
// the W_t product, as the TPU kernel does.  #1 stores s; #2 runs the GRU
// cell on a = s + init (init added after the slot sums, as the plain
// versions do).
//
// Bound on this card: the scattered reads of h_pack.  At the uniform
// headline (262,144 nodes, 8M directed edges, 16 message types, tile_e
// 256: 2,048 blocks of S8 = 32 slots, 48,535 of them real) one call reads
// 8.39M real rows, 2.15 GB (0.64 ms at 3.35 TB/s), against 48.5K·2·128³ ≈
// 0.20 TFLOP of W_t products.  The first body (typed_block.cu, which f32
// keeps) lost its time to:
// - the one-hot product as a segment sum, warp w adding the rows bound for
//   dst rows [16w, 16w + 16) (common.cuh::segment_sum_ordered);
// - every non-empty slot read whole (12.4M slot rows, 3.18 GB), though its
//   real rows lie in a prefix of it;
// - W_t loaded synchronously, once per type, behind a CTA barrier.
// This design, one CTA per dst block (block mode declines on hub graphs,
// so no block needs a split):
// - the block's slots (pack offset, type, dstl row, real-prefix length
//   from the host's plan) are read once into shared memory, up to kGroup
//   at a time; empty and zero-length slots are skipped;
// - they go through typed_pipe.cuh's slot pipeline, shared with #6 and #7:
//   only each slot's real prefix read, in 128-row chunks through a
//   two-stage cp.async ring one chunk ahead; the one-hot product on the
//   tensor cores, its 0/1 operand made in registers from the dst ids; each
//   slot's sums rounded to bf16 once and multiplied by W_t from a two-stage
//   ring loaded where the type changes, one type ahead;
// - #2's epilogue is #6's and #13's (gru_pipe.cuh's gru_tile behind
//   typed_pipe.cuh's __noinline__ wrapper); #1 stores f32.
// No float atomics: the same bits on every run.  The tensor cores add a
// k-step's 16 terms at once, not the segment sum's order, so a slot's sum
// that lies on a bf16 boundary may round to the other neighbour: the
// kernel is held to the plain version within one bf16 ulp of each slot's
// rounded sum, times |W_t|.
#include "typed_pipe.cuh"

namespace ggnn {
namespace tblock {

// (using-declarations: common.cuh's ggnn::kThreads is another name)
using tpipe::bf16;
using tpipe::init_gru;
using tpipe::kSmem;
using tpipe::kThreads;
using tpipe::slot_sums;
using tpipe::store_rows;
using tpipe::zero;

constexpr int kGroup = kThreads;  // slots read into shared memory at once

// One CTA per dst block.
template <bool FUSED>
__global__ void __launch_bounds__(kThreads, 1) typed_block_fused_kernel(
    const bf16* __restrict__ h_pack, long long n_pack,
    const int* __restrict__ dstl_blk, const int* __restrict__ slot_off16,
    const int* __restrict__ blk_off16, const int* __restrict__ dstl_len,
    const bf16* __restrict__ msg_w, int T2, int cmax, int S8, int tile_e,
    const float* __restrict__ init, const float* __restrict__ hstate,
    const bf16* __restrict__ wa, const float* __restrict__ b3,
    const bf16* __restrict__ uzr, const bf16* __restrict__ uh,
    float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_off[kGroup], s_typ[kGroup], s_c[kGroup], s_len[kGroup];
  const int b = blockIdx.x;
  const int base16 = blk_off16[b];
  float acc[2][8][4];
  zero<8>(acc);
  // slots in order: by type, then chunk (s = t·cmax + c)
  for (int g0 = 0; g0 < S8; g0 += kGroup) {
    const int n = min(kGroup, S8 - g0);
    if (threadIdx.x < n) {
      const int i = threadIdx.x, s = g0 + i;
      const int row = b * S8 + s;
      const int off = slot_off16[row], typ = s / cmax;
      s_off[i] = base16 + off;  // in rows of 16
      s_typ[i] = typ;
      s_c[i] = row;
      s_len[i] = off >= 0 && typ < T2 ? min(dstl_len[row], tile_e) : 0;
    }
    __syncthreads();
    slot_sums(acc, smem, s_off, s_typ, s_c, s_len, n, h_pack, n_pack,
              dstl_blk, tile_e, 16, msg_w);
  }

  const size_t ob = size_t(b) * 128 * 128;
  if constexpr (FUSED)
    init_gru(acc, smem, init + ob, hstate + ob, wa, b3, uzr, uh, out + ob);
  else
    store_rows(acc, out + ob);
}

template <bool FUSED>
static int launch_block_fused(
    const void* h_pack, long long n_pack, const void* dstl_blk,
    const void* slot_off16, const void* blk_off16, const void* dstl_len,
    const void* msg_w, int n_blocks, int T2, int cmax, int S8, int tile_e,
    const void* init, const void* hstate, const void* wa, const void* b3,
    const void* uzr, const void* uh, void* out, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      typed_block_fused_kernel<FUSED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err != cudaSuccess) return int(err);
  typed_block_fused_kernel<FUSED><<<n_blocks, kThreads, kSmem, s>>>(
      static_cast<const bf16*>(h_pack), n_pack,
      static_cast<const int*>(dstl_blk), static_cast<const int*>(slot_off16),
      static_cast<const int*>(blk_off16), static_cast<const int*>(dstl_len),
      static_cast<const bf16*>(msg_w), T2, cmax, S8, tile_e,
      static_cast<const float*>(init), static_cast<const float*>(hstate),
      static_cast<const bf16*>(wa), static_cast<const float*>(b3),
      static_cast<const bf16*>(uzr), static_cast<const bf16*>(uh),
      static_cast<float*>(out));
  return int(cudaGetLastError());
}

}  // namespace tblock
}  // namespace ggnn

// h_pack [n_pack, 128], msg_w [T2, 128, 128] and the GRU weights bf16;
// dstl_blk [n_blocks·S8, tile_e], slot_off16 [n_blocks·S8], blk_off16
// [n_blocks] and dstl_len [n_blocks·S8] (each dstl_blk row's last index
// with a dst id ≥ 0, plus one) int32; tile_e a multiple of 16.  fused = 0:
// #1, out = the sums (init, hstate and the GRU weights unused, may be
// null); fused = 1: #2, init and hstate f32 [n_blocks·128, 128], b3 [384]
// f32, out = h'.  out f32 [n_blocks·128, 128].  Returns the cudaError_t of
// the launch (0 = success).
extern "C" int ggnn_typed_block_fused(
    int fused, const void* h_pack, long long n_pack, const void* dstl_blk,
    const void* slot_off16, const void* blk_off16, const void* dstl_len,
    const void* msg_w, int n_blocks, int T2, int cmax, int S8, int tile_e,
    const void* init, const void* hstate, const void* wa, const void* b3,
    const void* uzr, const void* uh, void* out, void* stream) {
  if (n_blocks <= 0) return 0;
  if (tile_e <= 0 || tile_e % 16 || cmax <= 0 || S8 <= 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused)
    return ggnn::tblock::launch_block_fused<true>(
        h_pack, n_pack, dstl_blk, slot_off16, blk_off16, dstl_len, msg_w,
        n_blocks, T2, cmax, S8, tile_e, init, hstate, wa, b3, uzr, uh, out,
        s);
  return ggnn::tblock::launch_block_fused<false>(
      h_pack, n_pack, dstl_blk, slot_off16, blk_off16, dstl_len, msg_w,
      n_blocks, T2, cmax, S8, tile_e, init, hstate, wa, b3, uzr, uh, out, s);
}
