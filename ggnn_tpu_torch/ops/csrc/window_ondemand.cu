// The on-demand window sums (#12, window_block_spmm_ondemand) in f32 and at
// D > 128: the instantiations of window_step.cuh for this source (the bf16
// D = 128 form is window_ondemand_fused.cu), compiled in a file of their own
// so that nvcc builds the window kernels in parallel (see window_step.cu).
#include "window_step.cuh"

GGNN_WINDOW_STEP_INSTANTIATE(ggnn::kOnDemand, false, false)
