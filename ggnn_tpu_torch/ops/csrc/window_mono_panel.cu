// window_block_spmm_mono at widths D != 128 on the dst-local stream: the
// instantiations of window_mono_panel.cuh for this form.
#include "window_mono_panel.cuh"

GGNN_MONO_PANEL_DSTL()
