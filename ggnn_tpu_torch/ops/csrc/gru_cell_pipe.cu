// GRU cell forward for Hopper (sm_90a), bf16 at D = 128: kernel #3's
// redesign, the weights resident and the rows through registers.
//
// Replaces ggnn_tpu/ops/gru_pallas.py::gru_cell_fwd (_fwd_kernel) for
// bf16 weights and residuals at D = 128; f32 and D < 128 keep gru_cell.cu,
// D > 128 gru_cell_wide.cu.  The function is gru_cell.cu's: z = σ(a·W_z +
// h·U_z + b_z), r = σ(a·W_r + h·U_r + b_r), h̃ = tanh(a·W_h + (r⊙h)·U_h +
// b_h), h' = (1 − z)⊙h + z⊙h̃, h' in f32 and z, r, h̃ in bf16; the
// products' inputs a, h and r⊙h rounded to bf16, f32 accumulation, each
// element's products in gru_block's order (common.cuh), so the two bodies
// give the same bits.
//
// Bound on this card: HBM bytes.  At the headline (262,144 rows) the cell
// reads h and a (2 × 134 MB f32) and writes h' (134 MB) and three bf16
// residuals (201 MB): 0.60 GB, 0.18 ms at 3.35 TB/s; its products (51.5
// GFLOP) take 0.05 ms at the dense bf16 rate.  The first body gave each
// 128-row block a CTA that copied the six weight panels in one by one,
// transposed element by element, behind a barrier each.
//
// Design (gru_pipe.cuh::gru_strip).  Persistent: one CTA an SM, each
// walking a contiguous range of 16-row strips, warp w its strips w, w + 8,
// ....  The six bf16 [128, 128] panels (192 KB) are loaded once per CTA
// into swizzled shared memory by cp.async and read by ldmatrix.trans; the
// biases sit beside them.  A warp takes all 128 columns of its 16 rows, so
// its operands never leave registers: a and h are read as 8-byte pairs in
// the mma A layout (a quad reads whole 32-byte sectors; all 64 loads of a
// strip at once) and packed to bf16 fragments; r⊙h is formed from r's
// accumulators, whose m16n8 C layout over two adjacent n8-tiles is the
// m16k16 A layout.  The products of one 16-column group at a time keep the
// sums to 16 registers: r for every group first (its r⊙h fragments are
// the last product's A), then z and h̃ group by group, each group's f32 h
// read again (from L1 or L2) before its products.  The strip's own
// fragments and sums take 176 registers; a strip ahead in registers (64
// more for a) gained 1 %, a bulk L2 prefetch of the next strip lost 9 %,
// 16 warps an SM (128 registers, spilling) lost 10 % (PERF.md).
// h' leaves as 8-byte pairs (a quad: a 32-byte sector), z, r and h̃ after
// two quad shuffles as 8-byte runs (a quad: a sector).  No shared memory
// but the panels and biases, no barrier after the panels have landed.
#include <stdint.h>

#include <algorithm>

#include "gru_pipe.cuh"

namespace ggnn {
namespace gpipe {

using wpipe::bf16;

constexpr int kWarps = 8;
constexpr int kStrip = 16;                           // rows a warp takes
constexpr size_t kSmem = size_t(6) * wpipe::kPanelBytes + 3 * 128 * 4;

// The strip's rows of x ([*, 128] f32) in the m16k16 A layout: lane
// 4g + q reads rows g and g + 8, columns 16kc + 2q, + 1 and 16kc + 8 + 2q,
// + 1 (a quad reads whole 32-byte sectors), all 32 loads at once ...
__device__ __forceinline__ void load_rows(const float* __restrict__ x,
                                          float2 (&v)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kc = 0; kc < 8; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[kc][i] = __ldg(reinterpret_cast<const float2*>(
          x + (g + 8 * (i & 1)) * 128 + 16 * kc + 8 * (i >> 1) + 2 * q));
}

// ... and rounded to bf16 as the 8 A fragments.
__device__ __forceinline__ void pack_rows(const float2 (&v)[8][4],
                                          uint32_t (&f)[8][4]) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[kc][i] = wpipe::pack2(v[kc][i].x, v[kc][i].y);
}

__device__ __forceinline__ void load_frags(const float* __restrict__ x,
                                           uint32_t (&f)[8][4]) {
  float2 v[8][4];
  load_rows(x, v);
  pack_rows(v, f);
}

template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1) gru_cell_pipe_kernel(
    const float* __restrict__ h, const float* __restrict__ a,
    const bf16* __restrict__ wa, const float* __restrict__ b3,
    const bf16* __restrict__ uzr, const bf16* __restrict__ uh,
    float* __restrict__ out_h, bf16* __restrict__ out_z,
    bf16* __restrict__ out_r, bf16* __restrict__ out_ht, int n_strips) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* b_s = reinterpret_cast<float*>(smem + 6 * wpipe::kPanelBytes);
  const int tid = threadIdx.x, warp = tid >> 5;
  wpipe::load_panels(smem, wa, uzr, uh, WARPS * 32);
  for (int i = tid; i < 3 * 128; i += WARPS * 32) b_s[i] = b3[i];
  const int s1 = int((long long)n_strips * (blockIdx.x + 1) / gridDim.x);
  int s = int((long long)n_strips * blockIdx.x / gridDim.x) + warp;
  constexpr size_t kRowsF = size_t(kStrip) * 128;  // floats of a strip
  uint32_t af[8][4], hf[8][4];
  if (s < s1) {
    load_frags(a + s * kRowsF, af);
    load_frags(h + s * kRowsF, hf);
  }
  pipe::cp_async_wait_all();
  __syncthreads();  // the panels and biases are in
  const uint32_t panels = pipe::smem_addr(smem);
  for (; s < s1; s += WARPS) {
    const bool more = s + WARPS < s1;
    const size_t o = s * kRowsF;
    wpipe::gru_strip(af, hf, panels, b_s, h + o, out_h + o, out_z + o,
                     out_r + o, out_ht + o);
    if (more) {
      load_frags(a + (s + WARPS) * kRowsF, af);
      load_frags(h + (s + WARPS) * kRowsF, hf);
    }
  }
}

}  // namespace gpipe
}  // namespace ggnn

// The arguments of ggnn_gru_cell (gru_cell.cu) for dtype 1, bf16 weights
// and residuals at D = 128: h, a f32 [N, 128], wa [128, 384], uzr [128,
// 256], uh [128, 128] bf16, b3 [384] f32; out_h f32, z, r, ht bf16 [N,
// 128]; N = 128 · n_blocks.  Returns the cudaError_t of the launch.
extern "C" int ggnn_gru_cell_pipe(int dtype, const void* h, const void* a,
                                  const void* wa, const void* b3,
                                  const void* uzr, const void* uh, void* out_h,
                                  void* z, void* r, void* ht, int n_blocks,
                                  void* stream) {
  namespace gp = ggnn::gpipe;
  using gp::bf16;
  if (n_blocks <= 0) return 0;
  if (dtype != 1) return int(cudaErrorInvalidValue);
  constexpr int W = gp::kWarps;
  auto kernel = gp::gru_cell_pipe_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(gp::kSmem));
  if (err != cudaSuccess) return int(err);
  const int n_strips = n_blocks * (128 / gp::kStrip);
  const int n_ctas = std::min((n_strips + W - 1) / W,
                              ggnn::pipe::multiprocessors());
  kernel<<<n_ctas, W * 32, gp::kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(a),
      static_cast<const bf16*>(wa), static_cast<const float*>(b3),
      static_cast<const bf16*>(uzr), static_cast<const bf16*>(uh),
      static_cast<float*>(out_h), static_cast<bf16*>(z), static_cast<bf16*>(r),
      static_cast<bf16*>(ht), n_strips);
  return int(cudaGetLastError());
}
