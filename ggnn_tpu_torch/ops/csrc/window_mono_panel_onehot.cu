// window_block_spmm_mono at widths D != 128 on the int8 one-hot stream: the
// instantiations of window_mono_panel.cuh for this form.
#include "window_mono_panel.cuh"

GGNN_MONO_PANEL_ONEHOT()
