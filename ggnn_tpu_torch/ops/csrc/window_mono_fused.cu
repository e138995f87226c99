// #11 window_block_spmm_mono and #8 onehot_segment_scatter_flat in bf16 at
// D = 128 for Hopper (sm_90a): mono_pipe.cuh's tensor-core pipeline over
// the units of a plan made once per layout (ops/window.py::mono_plan).
//
// Replaces ggnn_tpu/ops/window_pallas.py::_window_mono_kernel (run by
// window_block_spmm_mono) in its dst-local and int8 count forms at 128-row
// output blocks (a taller block of R = 128·S rows is S blocks of 128 rows
// to the plan: slice s reads count rows [s·128, s·128 + 128) of its tiles),
// and ggnn_tpu/ops/scatter_pallas.py::_scatter_stream_flat_kernel
// (onehot_segment_scatter_flat: the count form with win_of_tile = arange,
// window = tile_e, scatter_pallas.py:760-771); the dst-local form also runs
// #9 onehot_segment_scatter (_scatter_kernel).
//
// Bound on this card: HBM bytes.  At the scale-free headline's grad layout
// (262,144 nodes, 8M directed edges, Zipf 1.2, 16 message types, bf16,
// g_tile 256) one call must read 8.25M packed rows of G (2.1 GB) and the
// dst-local stream and write Y (1.07 GB): 0.95 ms at 3.35 TB/s; #8 at the
// uniform headline reads 8M message rows (2.05 GB) and the 1.06 GB one-hot
// stream: 0.97 ms.  The first body (window_mono.cu) summed on the CUDA
// cores (one warp per 16 dst rows: a hub tile fell to one warp), read
// every row of a window whatever its ids, staged counts and table by
// scalar transposing stores and summed a split block's partials on one
// CTA.  Here every unit costs the same on every warp (the one-hot or count
// product on the tensor cores), only units that add something are read,
// each warp copies a unit of every stage (its descriptor loaded a stage
// ahead) while the warps multiply the stages before it, and a split
// block's partials are summed by 16 CTAs a block (partial_sum.cuh), in
// item order.
#include "mono_pipe.cuh"

// ids = 1: c_stream is the int32 dst-local stream [n, window]; else the
// int8 count (or one-hot) matrix [n·128, window].  out_dtype 0 = float32,
// 1 = bfloat16.  table [n_table, 128] bf16; window % 16 == 0; the plan
// (int32): units [n_units, 2] ({first table row, the offset of the
// group's ids or first count bytes in c_stream / 16}),
// work [n_work, 4] (the work items with a unit: {first unit, end unit,
// output block, partial slot or −1}), zero_blk [n_zero] (the blocks
// without a unit), item_first [n_blocks + 1], pbase [n_blocks] and split
// [n_split] (the blocks of several items) over the plan's 128-row blocks;
// ws [n_partial, 128, 128] f32; out [n_blocks·128, 128].  The dst-local
// form runs a ring of three stages (100 KB, two CTAs an SM), the count
// form of two (96 KB).  Returns the cudaError_t of the launches (0 =
// success).
extern "C" int ggnn_mono_fused(int ids, int out_dtype, const void* table,
                               long long n_table, const void* c_stream,
                               int window, const void* units,
                               const void* work, int n_work,
                               const void* zero_blk, int n_zero,
                               const void* item_first, const void* pbase,
                               const void* split, int n_split, void* ws,
                               void* out, void* stream) {
  using namespace ggnn::mpipe;
  if (n_work <= 0 && n_zero <= 0) return 0;
  if (window <= 0 || window % 16) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GGNN_LAUNCH(IDS, TO)                                                 \
  return launch_mono_fused<IDS, TO, IDS ? 3 : 2>(                            \
      table, n_table, c_stream, window, units, work, n_work, zero_blk,       \
      n_zero, item_first, pbase, split, n_split, ws, out, s)
  if (ids && out_dtype == 0) GGNN_LAUNCH(true, float);
  if (ids && out_dtype == 1) GGNN_LAUNCH(true, __nv_bfloat16);
  if (!ids && out_dtype == 0) GGNN_LAUNCH(false, float);
  if (!ids && out_dtype == 1) GGNN_LAUNCH(false, __nv_bfloat16);
#undef GGNN_LAUNCH
  return int(cudaErrorInvalidValue);
}
