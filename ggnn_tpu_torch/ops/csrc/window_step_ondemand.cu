// The fused window step (#13) over on-demand windows: the instantiations of
// window_step.cuh for this source, compiled in a file of their own so that
// nvcc builds the window kernels in parallel (see window_step.cu).
#include "window_step.cuh"

GGNN_WINDOW_STEP_INSTANTIATE(ggnn::kOnDemand, true, false)
