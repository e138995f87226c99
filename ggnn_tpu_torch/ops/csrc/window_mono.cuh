// What window_mono.cu and the panel kernel's sources share: the side
// stream's forms and the launcher of the any-width panel kernel, which is
// compiled in files of its own (window_mono_panel*.cu) so that nvcc builds
// them in parallel.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace ggnn {

// The side stream's form: a dst-local stream, an int8 count matrix, or an
// int8 one-hot matrix (each column at most one entry, a 1), which the f32
// D = 128 kernel decodes into dst-local ids (the panel kernel takes it as
// counts).
constexpr int kDstl = 0, kCounts = 1, kOnehot = 2;

// window_block_spmm_mono at a width D != 128 (window_mono_panel.cu); the
// arguments as launch_window_mono's.
template <typename TT, typename TO, int MODE>
int launch_window_mono_panel(const void* table, long long n_table, int D,
                             const void* c_stream, long long n_c, bool packed,
                             int out_rows, const void* tile_start,
                             const void* win_of_tile, const void* c_off,
                             int n_blocks, int window, int stride,
                             const void* item_first, const void* pbase,
                             int n_items, int n_partial, void* ws, void* out,
                             cudaStream_t stream);

}  // namespace ggnn

// The (table, output, stream) combinations the entry points launch.
#define GGNN_MONO_PANEL_ONE(PREFIX, TT, TO, MODE)                             \
  PREFIX template int ggnn::launch_window_mono_panel<TT, TO, MODE>(          \
      const void*, long long, int, const void*, long long, bool, int,        \
      const void*, const void*, const void*, int, int, int, const void*,     \
      const void*, int, int, void*, void*, cudaStream_t);
#define GGNN_MONO_PANEL_DSTL(PREFIX)                                          \
  GGNN_MONO_PANEL_ONE(PREFIX, __nv_bfloat16, __nv_bfloat16, ggnn::kDstl)      \
  GGNN_MONO_PANEL_ONE(PREFIX, __nv_bfloat16, float, ggnn::kDstl)              \
  GGNN_MONO_PANEL_ONE(PREFIX, float, __nv_bfloat16, ggnn::kDstl)              \
  GGNN_MONO_PANEL_ONE(PREFIX, float, float, ggnn::kDstl)
#define GGNN_MONO_PANEL_COUNTS(PREFIX)                                        \
  GGNN_MONO_PANEL_ONE(PREFIX, __nv_bfloat16, __nv_bfloat16, ggnn::kCounts)    \
  GGNN_MONO_PANEL_ONE(PREFIX, __nv_bfloat16, float, ggnn::kCounts)            \
  GGNN_MONO_PANEL_ONE(PREFIX, float, __nv_bfloat16, ggnn::kCounts)            \
  GGNN_MONO_PANEL_ONE(PREFIX, float, float, ggnn::kCounts)
#define GGNN_MONO_PANEL_EXTERN                                                \
  GGNN_MONO_PANEL_DSTL(extern)                                                \
  GGNN_MONO_PANEL_COUNTS(extern)
