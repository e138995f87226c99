// The on-demand window sums (#12, window_block_spmm_ondemand) in bf16 for
// Hopper (sm_90a): window_step_fused.cuh's on-demand pipeline in its STORE
// form, and the second kernel that sums a split block's partials.
//
// Replaces ggnn_tpu/ops/window_pallas.py::_window_ondemand_kernel: for dst
// block b, a = Σ over its real tiles of C_tile · window, each window built
// on the chip from a 128-row h block as T(h_blk · W_t + b_t) (f32 products
// and bias, rounded once to bf16), the sums stored in f32.
//
// Bound on this card: the count stream's bytes (2.15 GB at the community
// headline, W 512, block_rows 512: 0.64 ms at 3.35 TB/s; 0.59 GB at the
// scale-free one, block_rows 128) against the products (each tile's
// window build, 2·128·W·128 per 128 rows built, and its count product,
// 2·block_rows·W·128).  The first body (window_step.cuh) staged each count
// chunk and window row by scalar loops with nothing in flight, rebuilt an
// on-demand chunk in every 128-row slice of a block, and walked a block's
// tiles on one CTA: on the scale-free layout (Zipf 1.2: dst block 0 holds
// 3,472 of 8,974 real tiles) that one CTA set the kernel's time.  Here:
// - the fused step's pipeline (#13's): count chunks by
//   cp.async one chunk ahead, read by ldmatrix as they lie; each window
//   built once per work item by the block's slices as one cluster, into
//   the item's two-window scratch in device memory (it stays in L2), then
//   read back like a table;
// - the hub split: each block's real tiles (the host's plan, in list
//   order) cut into work items of at most split_k tiles, one CTA (cluster)
//   each, so the hub spreads over the card; a block of one item writes its
//   rows, a block of more one f32 partial per item;
// - the second kernel (partial_sum.cuh) sums a split block's partials in
//   item order, each CTA 256 float4 columns of the block, so no SM sums a
//   hub alone.
// No float atomics: the same bits on every run.
#include "partial_sum.cuh"
#include "window_step_fused.cuh"

GGNN_WINDOW_STEP_FUSED_INSTANTIATE(ggnn::wstep::kOnDemand, false, true)

// h [n_h, 128] bf16 (the h source of block-major windows), counts int8
// [n_c·out_rows, window], tile_start [n_blocks + 1], win_of_tile and c_off
// (or null) [n_tiles]; wbank [T2, 128, 128] bf16, bbank [T2, 128] f32; the
// plan (int32): item_first [n_blocks + 1], rt (the real tiles in list
// order), rt_start [n_blocks + 1], pbase [n_blocks], split [n_split] (the
// blocks of more than one item); ws the partial slots [*, out_rows, 128]
// f32; scratch [n_items, 2·window, 128] bf16; out f32 [n_blocks·out_rows,
// 128].  out_rows 128, 256 or 512; window a multiple of 128 that divides
// T2·128.  Returns the cudaError_t of the launches (0 = success).
extern "C" int ggnn_window_ondemand_fused(
    const void* h, long long n_h, const void* counts, long long n_c,
    const void* tile_start, const void* win_of_tile, const void* c_off,
    int n_blocks, int out_rows, int window, const void* wbank,
    const void* bbank, int T2, const void* item_first, const void* rt,
    const void* rt_start, const void* pbase, int n_items, int split_k,
    const void* split, int n_split, void* ws, void* scratch, void* out,
    void* stream) {
  using namespace ggnn::wstep;
  if (n_blocks <= 0 || n_items <= 0) return 0;
  if (T2 <= 0 || split_k <= 0 || window % 128 || (T2 * 128) % window ||
      (out_rows != 128 && out_rows != 256 && out_rows != 512))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Items items{static_cast<const int*>(item_first),
                    static_cast<const int*>(rt),
                    static_cast<const int*>(rt_start),
                    static_cast<const int*>(pbase),
                    static_cast<float*>(ws), n_blocks, split_k};
  int err = launch_window_step_fused<kOnDemand, false, true>(
      h, n_h, counts, n_c, tile_start, win_of_tile, c_off, n_items, out_rows,
      window, nullptr, wbank, bbank, T2, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, out, nullptr, scratch, items, s);
  if (err != 0 || n_split == 0) return err;
  return ggnn::launch_partial_sum<256>(split, item_first, pbase, ws, n_split,
                                      out_rows, out, s);
}
