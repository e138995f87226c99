// The window backend's fused step and on-demand windows for Hopper (sm_90a).
//
// Replaces two kernels of ggnn_tpu/ops/window_pallas.py:
// - _window_step_kernel (run by window_step_gru, #13): per dst block, the
//   aggregation a = init + Σ_tiles C_tile · window, then the GRU epilogue on
//   a, from three table sources (SRC); with emit_res (RES, kTable and
//   kOnDemand) also the training residuals (a | z | r | h̃) per row in T,
//   each rounded from the epilogue's f32 values:
//   kTable    a bf16/f32 table [R, D]; window w = rows [w·W, w·W + W); the
//             counts int8 or int4 pairs (`packed`);
//   kQ8       the int8 values-only table of node_table_block_major_q8 with
//             one power-of-2 scale per window: each tile's product is
//             exact in int32 (mma.sync s8·s8 → s32) and joins a as
//             float(product) · scales[w], as the TPU kernel's int8 MXU dot;
//   kOnDemand no table: window w of a block-major table is built on the
//             chip from the 128-row h block (w / wpb)·128 of the h source,
//             rows [j·128, (j+1)·128) = T(h_blk · W_{tbase+j} + b_{tbase+j})
//             (f32 products and bias, one rounding to T, as
//             node_table_block_major rounds), tbase = (w % wpb)·W/128,
//             wpb = T2·128 / W;
// - _window_ondemand_kernel (run by window_block_spmm_ondemand, #12): the
//   kOnDemand sums without the epilogue, written as f32 (FUSED = false);
// and, as kTable without the epilogue, the window layouts' count forms of
// _window_mono_kernel (#11) at D = 128 that window_mono.cu leaves out: the
// int4-packed counts and the 256- and 512-row dst blocks, and the backward's
// Y = Cᵀ·ā over the transposed count stream (out_rows = W, any width: a
// last slice of fewer than 128 rows is masked).
// A tile with win < 0 is a dummy (zero-init or padding) and adds nothing.
// The GRU epilogue is common.cuh::gru_block<T, false>, #2's: gate products
// on a and h rounded to T, r⊙h rounded to T before U_h, f32 gates and h.
//
// Design.  The TPU kernel keeps a dst block of up to 512 rows and its f32
// accumulator in VMEM, and walks the block's tiles with a DMA ring.  A 512-
// row f32 accumulator alone (256 KB) exceeds a CTA's 227 KB of shared
// memory, so here each dst block is cut into 128-row slices, one CTA per
// (block, slice), the accumulator in registers; each slice walks its
// block's real tiles in list order (one fixed order: the same bits on every
// run), and each tile in chunks of 128 window rows.
// - The fused bf16 forms (#13 over a table, the q8 table or on-demand
//   windows, with or without emit_res; int8 counts, W a multiple of 128)
//   run window_step_fused.cuh: count chunks and table chunks in flight by
//   cp.async during the product, both read by ldmatrix as they lie (the
//   int8 counts converted to bf16 in the fragments, q8 products exact
//   through mma.m16n8k32), each on-demand chunk built once per dst block
//   by the block's slices as one thread-block cluster, the GRU epilogue's
//   weights by cp.async and ldmatrix.trans.  Bound on this card: the count
//   stream's bytes (2.15 GB at the community headline: 262,144 nodes,
//   W 512, block_rows 512, 16 message types, D = 128).
// - #12 in bf16 at D = 128 (on-demand blocks of 128, 256 or 512 rows)
//   runs the same pipeline's STORE form with a hub split
//   (window_ondemand_fused.cu, its own entry point).
// - Every other instantiation of window_step.cuh (f32; the int4 counts; a
//   W that is no multiple of 128; on-demand blocks of other than 128, 256
//   or 512 rows; the sums without the epilogue: #12 in f32 or at a wider
//   D, #11's window forms, the backward's Y path) keeps the first
//   version's body: per chunk, the [128, 128] counts converted to T and
//   the window rows staged in shared memory by scalar loops, then one
//   warp_gemm, with nothing in flight; an on-demand chunk is rebuilt by
//   each slice.  The block's tile list is scanned 256 entries at a time for
//   real tiles (__syncthreads_or), so a static budget's padding tiles
//   (hundreds of thousands on the last block of a serving layout) cost a
//   read of their win_of_tile and nothing else.
#include "window_step.cuh"
#include "window_step_fused.cuh"

GGNN_WINDOW_STEP_INSTANTIATE(ggnn::kTable, true, false)
GGNN_WINDOW_STEP_INSTANTIATE(ggnn::kTable, false, false)
GGNN_WINDOW_STEP_EXTERN(ggnn::kQ8, true, false)
GGNN_WINDOW_STEP_EXTERN(ggnn::kQ8, false, false)
GGNN_WINDOW_STEP_EXTERN(ggnn::kOnDemand, true, false)
GGNN_WINDOW_STEP_EXTERN(ggnn::kOnDemand, false, false)
GGNN_WINDOW_STEP_EXTERN(ggnn::kTable, true, true)
GGNN_WINDOW_STEP_EXTERN(ggnn::kOnDemand, true, true)
GGNN_WINDOW_STEP_FUSED_EXTERN(ggnn::wstep::kTable, false, false)
GGNN_WINDOW_STEP_FUSED_EXTERN(ggnn::wstep::kTable, true, false)
GGNN_WINDOW_STEP_FUSED_EXTERN(ggnn::wstep::kQ8, false, false)
GGNN_WINDOW_STEP_FUSED_EXTERN(ggnn::wstep::kOnDemand, false, false)
GGNN_WINDOW_STEP_FUSED_EXTERN(ggnn::wstep::kOnDemand, true, false)

// src: 0 = table, 1 = q8, 2 = on-demand; dtype (the table's, or for q8 the
// GRU weights'; wbank's for on-demand): 0 = float32, 1 = bfloat16; fused: 1
// = the GRU epilogue (#13), 0 = the sums only (table: #11's window forms;
// on-demand: #12).  table [n_table,
// 128] (q8: int8; on-demand: the h source [n_table, 128]); counts int8
// [n_c·out_rows, window] (packed: [n_c·out_rows, window/2]); tile_start
// [n_blocks + 1], win_of_tile and c_off (or null: tile t reads entry t)
// [n_tiles]; scales [n_wins] f32 (q8); wbank [T2, 128, 128], bbank [T2, 128]
// f32 (on-demand); init (or null: zero) and hstate f32 [n_blocks·out_rows,
// 128]; wa [128, 384], b3 [384] f32, uzr [128, 256], uh [128, 128]; out f32
// [n_blocks·out_rows, 128]; res (or null: no residuals; fused table or
// on-demand only) [n_blocks·out_rows, 512] in the dtype; scratch (the
// bf16 fused on-demand form, else null) bf16 [n_blocks, 2·window, 128].
// Without fused,
// width = P·128 for wider states (every 128 above becomes the width: the
// table, h source, wbank [T2, width, width], bbank, init and out).  Returns
// the cudaError_t of the launch.
extern "C" int ggnn_window_step(
    int src, int dtype, int fused, int packed, int width, const void* table,
    long long n_table, const void* counts, long long n_c,
    const void* tile_start, const void* win_of_tile, const void* c_off,
    int n_blocks, int out_rows, int window, const void* scales,
    const void* wbank, const void* bbank, int T2, const void* init,
    const void* hstate, const void* wa, const void* b3, const void* uzr,
    const void* uh, void* out, void* res, void* scratch, void* stream) {
  if (n_blocks <= 0) return 0;
  if (width <= 0 || width % ggnn::kD) return int(cudaErrorInvalidValue);
  const int P = width / ggnn::kD;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slices = out_rows / ggnn::kRows;
  if (fused && dtype == 1 && !packed && P == 1 && window > 0 &&
      window % ggnn::kRows == 0 && out_rows > 0 &&
      out_rows % ggnn::kRows == 0 &&
      (src != ggnn::kOnDemand || slices == 1 || slices == 2 || slices == 4)) {
    if (!hstate || !wa || !b3 || !uzr || !uh || (src == ggnn::kQ8 && res) ||
        (src == ggnn::kQ8 && !scales) ||
        (src == ggnn::kOnDemand &&
         (T2 <= 0 || (T2 * ggnn::kRows) % window || !wbank || !bbank)))
      return int(cudaErrorInvalidValue);
#define GGNN_FUSED(SRC, RES)                                                 \
  return ggnn::wstep::launch_window_step_fused<SRC, RES, false>(             \
      table, n_table, counts, n_c, tile_start, win_of_tile, c_off, n_blocks, \
      out_rows, window, scales, wbank, bbank, T2, init, hstate, wa, b3, uzr, \
      uh, out, res, scratch, ggnn::wstep::Items{}, s)
    if (src == ggnn::kTable && res) GGNN_FUSED(ggnn::wstep::kTable, true);
    if (src == ggnn::kTable) GGNN_FUSED(ggnn::wstep::kTable, false);
    if (src == ggnn::kQ8) GGNN_FUSED(ggnn::wstep::kQ8, false);
    if (src == ggnn::kOnDemand && res)
      GGNN_FUSED(ggnn::wstep::kOnDemand, true);
    if (src == ggnn::kOnDemand) GGNN_FUSED(ggnn::wstep::kOnDemand, false);
#undef GGNN_FUSED
    return int(cudaErrorInvalidValue);
  }
#define GGNN_LAUNCH(T, SRC, FUSED, RES)                                      \
  return ggnn::launch_window_step<T, SRC, FUSED, RES>(                       \
      P, table, n_table, counts, n_c, packed != 0, tile_start, win_of_tile,     \
      c_off, n_blocks, out_rows, window, scales, wbank, bbank, T2, init,     \
      hstate, wa, b3, uzr, uh, out, res, s)
#define GGNN_DTYPES(SRC, FUSED, RES)                                         \
  if (dtype == 1) GGNN_LAUNCH(__nv_bfloat16, SRC, FUSED, RES);               \
  if (dtype == 0) GGNN_LAUNCH(float, SRC, FUSED, RES)
  if (fused && res) {
    if (src == ggnn::kTable) { GGNN_DTYPES(ggnn::kTable, true, true); }
    if (src == ggnn::kOnDemand) { GGNN_DTYPES(ggnn::kOnDemand, true, true); }
  } else if (fused) {
    if (src == ggnn::kTable) { GGNN_DTYPES(ggnn::kTable, true, false); }
    if (src == ggnn::kQ8) { GGNN_DTYPES(ggnn::kQ8, true, false); }
    if (src == ggnn::kOnDemand) { GGNN_DTYPES(ggnn::kOnDemand, true, false); }
  } else if (!res) {
    if (src == ggnn::kTable) { GGNN_DTYPES(ggnn::kTable, false, false); }
    if (src == ggnn::kQ8) { GGNN_DTYPES(ggnn::kQ8, false, false); }
    if (src == ggnn::kOnDemand) { GGNN_DTYPES(ggnn::kOnDemand, false, false); }
  }
#undef GGNN_DTYPES
#undef GGNN_LAUNCH
  return int(cudaErrorInvalidValue);
}
