// Per-tile typed scatter for Hopper (sm_90a), plain or with the GRU step
// fused into its epilogue: the typed pack where block mode declines
// (hub-heavy and power-law graphs).
//
// Replaces ggnn_tpu/ops/scatter_pallas.py::_typed_onehot_kernel (run by
// typed_onehot_scatter, FUSED = false) and ::_typed_step_kernel (run by
// typed_step_gru, FUSED = true).  For dst block b it computes
//     out[b·128 : (b+1)·128] = init_b + Σ_t T(onehot(dstl[c_off[t]]) @ H_t) @ W[type[t]]
// over the tiles t in [tile_start[b], tile_start[b + 1]): tile t reads
// tile_e rows of h_pack from tile_msg_off[t]·align (−1 marks a dummy tile,
// which adds nothing), its dst-local ids are row c_off[t] of dstl (−1 =
// no edge), and the one-hot product is taken in f32 and rounded to the
// compute dtype T PER TILE before the W product, as the TPU kernel does.
// FUSED adds init (the Σ_t indeg_t·b_t bias) after the tile sums, as the
// plain version does, and runs the GRU cell of common.cuh on the block's
// rows; otherwise init is 0.  So typed_step_gru's aggregation is exactly
// typed_onehot_scatter's output plus init, and the fused epilogue can be
// held to the GRU cell of those sums.
//
// Bound on this card: the scattered reads of h_pack, as for the per-block
// kernel (typed_block.cu): at the scale-free headline (262,144 nodes, 8M
// directed edges, Zipf 1.2, D = 128, bf16) one call reads 2.05 GB of
// packed rows (0.61 ms at 3.35 TB/s) against 61K·2·128³ ≈ 0.26 TFLOP of
// W_t products (0.26 ms at 989 TFLOP/s; the one-hot product is a segment
// sum, not a matrix product, here).  What shapes the design is the
// hub: dst block 0 holds 37 % of the tiles (22,328 of 60,962) and 71 % of
// the edges.  The TPU walks all tiles in one sequential program; one CTA per
// dst block here would put that block on one of 132 SMs.  So:
// - each block's tiles are cut into work items of at most kSplit = 32
//   tiles (common.cuh), one CTA per item; the hub becomes 698 items that
//   start first (items are numbered by block);
// - a block with one item writes its rows itself (and runs the GRU
//   epilogue); a block with more writes f32 partials that a second kernel
//   sums in item order, adds init and runs the epilogue;
// - inside an item, W_t is reloaded only when the tile type changes (tiles
//   of a block are sorted by type); each tile's rows are staged in shared
//   memory and summed by segment_sum_ordered (each warp its own 16 dst
//   rows, in the order of the rows), the warp's strip is rounded to T and
//   multiplied by W_t with mma.sync (bf16) or FMA loops (f32) into a
//   register accumulator.  No float atomics: the same result on every run.
// Rows outside [0, n_pack), dst ids outside [0, 128), dstl rows outside
// [0, n_dstl) and types outside [0, T2) are dropped, so a layout that does
// not belong to its pack cannot address memory outside it.
#include "common.cuh"

namespace ggnn {

template <typename T>
struct TileSmem {
  static constexpr size_t sums = size_t(kRows) * kD * sizeof(float);
  // region 0 holds the f32 sums and the staged tile rows, later the staged
  // h of the GRU epilogue; then the A and W operands
  static constexpr size_t work = sums + Stage<T>::bytes;
  static constexpr size_t r0 = work > Smem<T>::tile ? work : Smem<T>::tile;
  static constexpr size_t bytes = r0 + 2 * Smem<T>::tile;
};

// The GRU epilogue on the CTA's block: a = acc (init included) rounded to
// T, h staged from hstate; writes h' (f32) to out.
template <typename T>
__device__ void tile_epilogue(unsigned char* smem, const float (&acc)[kNT][4],
                              const float* __restrict__ hrow,
                              const T* __restrict__ wa,
                              const float* __restrict__ b3,
                              const T* __restrict__ uzr,
                              const T* __restrict__ uh,
                              float* __restrict__ out_rows) {
  constexpr int ld = Smem<T>::ld;
  T* H_s = reinterpret_cast<T*>(smem);
  T* A_s = reinterpret_cast<T*>(smem + TileSmem<T>::r0);
  T* W_s = reinterpret_cast<T*>(smem + TileSmem<T>::r0 + Smem<T>::tile);
  const int row0 = (threadIdx.x >> 5) * 16;
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      A_s[(row0 + frag_row(e)) * ld + frag_col(nt, e)] = from_f<T>(acc[nt][e]);
  stage_rows(H_s, hrow);
  gru_block<T, false>(A_s, H_s, W_s, hrow, wa, b3, uzr, uh, out_rows, nullptr,
                      nullptr, nullptr);
}

__device__ __forceinline__ void write_frag(float* __restrict__ out_rows,
                                           const float (&acc)[kNT][4]) {
  const int row0 = (threadIdx.x >> 5) * 16;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out_rows[(row0 + frag_row(e)) * kD + frag_col(nt, e)] = acc[nt][e];
}

__device__ __forceinline__ void add_rows(float (&acc)[kNT][4],
                                         const float* __restrict__ rows) {
  const int row0 = (threadIdx.x >> 5) * 16;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[nt][e] += rows[(row0 + frag_row(e)) * kD + frag_col(nt, e)];
}

// One CTA per work item (grid = item_first[n_blocks]).
template <typename T, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1) typed_tile_kernel(
    const T* __restrict__ h_pack, long long n_pack, const int* __restrict__ dstl,
    long long n_dstl, const int* __restrict__ tile_start,
    const int* __restrict__ tile_msg_off, const int* __restrict__ c_off,
    const int* __restrict__ tile_type, const T* __restrict__ msg_w, int T2,
    int n_blocks, int tile_e, int align, const int* __restrict__ item_first,
    const int* __restrict__ pbase, const float* __restrict__ init,
    const float* __restrict__ hstate, const T* __restrict__ wa,
    const float* __restrict__ b3, const T* __restrict__ uzr,
    const T* __restrict__ uh, float* __restrict__ ws,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  float* S = reinterpret_cast<float*>(smem);
  T* H_s = reinterpret_cast<T*>(smem + TileSmem<T>::sums);
  T* A_s = reinterpret_cast<T*>(smem + TileSmem<T>::r0);
  T* W_s = reinterpret_cast<T*>(smem + TileSmem<T>::r0 + Smem<T>::tile);
  const int item = blockIdx.x;
  const int b = item_block(item_first, n_blocks, item);
  const int k = item - item_first[b];
  const int n_items = item_first[b + 1] - item_first[b];
  const int t_end = tile_start[b + 1];
  const int t0 = tile_start[b] + k * kSplit;
  const int t1 = min(t0 + kSplit, t_end);
  const int row0 = (threadIdx.x >> 5) * 16;
  const size_t out_base = size_t(b) * kRows * kD;

  float acc[kNT][4];
  zero_acc(acc);
  int w_type = -1;
  for (int t = t0; t < t1; ++t) {
    const int off = tile_msg_off[t];
    const int typ = tile_type[t];
    const int c = c_off[t];
    if (off < 0 || typ < 0 || typ >= T2 || c < 0 || c >= n_dstl) continue;
    if (typ != w_type) {
      __syncthreads();  // every warp is done with the previous W_s
      load_wt(W_s, msg_w + size_t(typ) * kD * kD, kD, 0);
      w_type = typ;     // visible after segment_sum_ordered's barriers
    }
    zero_strip(S);
    segment_sum_ordered(S, H_s, h_pack, n_pack, (long long)off * align,
                        dstl + size_t(c) * tile_e, tile_e);
    round_strip(A_s, S);  // the tile's sums, rounded to T per tile
    warp_gemm(acc, A_s + row0 * ld, W_s);
  }

  if (n_items > 1) {
    store_frag(ws + size_t(pbase[b] + k) * kSlot, acc);
  } else if (FUSED) {
    add_rows(acc, init + out_base);
    tile_epilogue<T>(smem, acc, hstate + out_base, wa, b3, uzr, uh,
                     out + out_base);
  } else {
    write_frag(out + out_base, acc);
  }
}

// One CTA per dst block; blocks with one item were written by the first
// kernel.  Sums the block's partials in item order, then adds init (FUSED)
// and writes the rows (through the GRU epilogue when FUSED).
template <typename T, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1) typed_tile_reduce_kernel(
    const int* __restrict__ item_first, const int* __restrict__ pbase,
    const float* __restrict__ ws, const float* __restrict__ init,
    const float* __restrict__ hstate, const T* __restrict__ wa,
    const float* __restrict__ b3, const T* __restrict__ uzr,
    const T* __restrict__ uh, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int n_items = item_first[b + 1] - item_first[b];
  if (n_items <= 1) return;
  const size_t out_base = size_t(b) * kRows * kD;
  float acc[kNT][4];
  zero_acc(acc);
#pragma unroll 2
  for (int k = 0; k < n_items; ++k)
    add_frag(acc, ws + size_t(pbase[b] + k) * kSlot);
  if (FUSED) add_rows(acc, init + out_base);
  if (FUSED)
    tile_epilogue<T>(smem, acc, hstate + out_base, wa, b3, uzr, uh,
                     out + out_base);
  else
    write_frag(out + out_base, acc);
}

template <typename T, bool FUSED>
static int launch_typed_tile(const void* h_pack, long long n_pack,
                             const void* dstl, long long n_dstl,
                             const void* tile_start, const void* tile_msg_off,
                             const void* c_off, const void* tile_type,
                             const void* msg_w, int T2, int n_blocks,
                             int tile_e, int align, const void* item_first,
                             const void* pbase, int n_items, int n_partial,
                             const void* init, const void* hstate,
                             const void* wa, const void* b3, const void* uzr,
                             const void* uh, void* ws, void* out,
                             cudaStream_t stream) {
  const size_t smem = TileSmem<T>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      typed_tile_kernel<T, FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  typed_tile_kernel<T, FUSED><<<n_items, kThreads, smem, stream>>>(
      static_cast<const T*>(h_pack), n_pack, static_cast<const int*>(dstl),
      n_dstl, static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_msg_off), static_cast<const int*>(c_off),
      static_cast<const int*>(tile_type), static_cast<const T*>(msg_w), T2,
      n_blocks, tile_e, align, static_cast<const int*>(item_first),
      static_cast<const int*>(pbase), static_cast<const float*>(init),
      static_cast<const float*>(hstate), static_cast<const T*>(wa),
      static_cast<const float*>(b3), static_cast<const T*>(uzr),
      static_cast<const T*>(uh), static_cast<float*>(ws),
      static_cast<float*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || n_partial == 0) return int(err);
  const size_t rsmem = FUSED ? TileSmem<T>::bytes : 0;
  if (FUSED) {
    err = cudaFuncSetAttribute(typed_tile_reduce_kernel<T, FUSED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(rsmem));
    if (err != cudaSuccess) return int(err);
  }
  typed_tile_reduce_kernel<T, FUSED><<<n_blocks, kThreads, rsmem, stream>>>(
      static_cast<const int*>(item_first), static_cast<const int*>(pbase),
      static_cast<const float*>(ws), static_cast<const float*>(init),
      static_cast<const float*>(hstate), static_cast<const T*>(wa),
      static_cast<const float*>(b3), static_cast<const T*>(uzr),
      static_cast<const T*>(uh), static_cast<float*>(out));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// The split of each block's tiles into items of at most this many tiles.
extern "C" int ggnn_tile_split() { return ggnn::kSplit; }

// dtype: 0 = float32, 1 = bfloat16 (h_pack, msg_w and the GRU weights);
// fused = 0: plain scatter (init, hstate, GRU weights unused, may be null).
// item_first [n_blocks + 1] and pbase [n_blocks] are the hub split (see
// common.cuh); ws holds n_partial [128, 128] f32 slots.  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int ggnn_typed_tile(
    int dtype, int fused, const void* h_pack, long long n_pack,
    const void* dstl, long long n_dstl, const void* tile_start,
    const void* tile_msg_off, const void* c_off, const void* tile_type,
    const void* msg_w, int T2, int n_blocks, int tile_e, int align,
    const void* item_first, const void* pbase, int n_items, int n_partial,
    const void* init, const void* hstate, const void* wa, const void* b3,
    const void* uzr, const void* uh, void* ws, void* out, void* stream) {
  if (n_blocks <= 0 || n_items <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GGNN_LAUNCH(T, F)                                                    \
  return ggnn::launch_typed_tile<T, F>(                                      \
      h_pack, n_pack, dstl, n_dstl, tile_start, tile_msg_off, c_off,         \
      tile_type, msg_w, T2, n_blocks, tile_e, align, item_first, pbase,      \
      n_items, n_partial, init, hstate, wa, b3, uzr, uh, ws, out, s)
  if (dtype == 1 && fused) GGNN_LAUNCH(__nv_bfloat16, true);
  if (dtype == 1) GGNN_LAUNCH(__nv_bfloat16, false);
  if (dtype == 0 && fused) GGNN_LAUNCH(float, true);
  if (dtype == 0) GGNN_LAUNCH(float, false);
#undef GGNN_LAUNCH
  return int(cudaErrorInvalidValue);
}
