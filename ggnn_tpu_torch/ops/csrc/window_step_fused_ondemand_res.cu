// The fused window step (#13) in bf16 over on-demand windows with the
// training residuals (emit_res): the instantiation of window_step_fused.cuh
// for this form, in a file of its own so that nvcc builds the window kernels
// in parallel.
#include "window_step_fused.cuh"

GGNN_WINDOW_STEP_FUSED_INSTANTIATE(ggnn::wstep::kOnDemand, true, false)
