// The per-tile typed kernels #6 and #7 in bf16 for Hopper (sm_90a): the
// typed pack's scatter where block mode declines (hub-heavy and power-law
// graphs), with the GRU step in its epilogue (#6) or storing its f32 sums
// (#7, the STORE form).
//
// Replaces ggnn_tpu/ops/scatter_pallas.py::_typed_step_kernel (run by
// typed_step_gru) and ::_typed_onehot_kernel (run by typed_onehot_scatter).
// For dst block b they compute
//     s = Σ_t T(onehot(dstl[c_off[t]]) @ H_t) @ W[type[t]]
// over the block's tiles t (tile t reads tile_e rows of h_pack from
// tile_msg_off[t]·align; −1 marks a dummy tile, which adds nothing), the
// one-hot product in f32 and rounded to bf16 PER TILE, as the TPU kernels
// do; #7 stores s, #6 runs the GRU cell of common.cuh::gru_block on
// a = s + init (init added after the tile sums, as the plain versions do).
//
// Bound on this card: the scattered reads of h_pack.  At the scale-free
// headline (262,144 nodes, 8M directed edges, Zipf 1.2, D = 128, tile_e
// 256) one call reads 2.05 GB of packed rows (0.61 ms at 3.35 TB/s); the
// W_t products are 61K·2·128³ ≈ 0.26 TFLOP.  The first version
// (typed_tile.cu, which f32 keeps) lost its time to two things:
// - the one-hot product was a segment sum in which warp w adds the tile
//   rows bound for dst rows [16w, 16w + 16): a hub row's tile fell to one
//   warp while seven waited (the hub block, 22,328 of 60,962 tiles, took
//   5.43 of #7's 8.5 ms);
// - a second kernel summed the hub block's 698 item partials (45.7 MB of
//   f32) on one SM, then ran the epilogue there.
// This design:
// - an item's tiles go through typed_pipe.cuh's slot pipeline (shared with
//   #1 and #2): the one-hot product on the tensor cores over each tile's
//   real-row prefix, H_t's chunks and W_t by cp.async one unit ahead;
// - the hub split is typed_tile.cu's (kSplit = 32 tiles an item, one CTA
//   per item, common.cuh); a block of several items writes f32 partials;
// - #6's second kernel sums them over 8 CTAs a block, each 16 rows in item
//   order, and runs the GRU on its 16 rows there (the weight panels by
//   cp.async, ldmatrix.trans), so the sum meets the epilogue without
//   another pass through memory; #7's (partial_sum.cuh) sums float4
//   columns in item order, kReduceThreads a CTA, so the hub's 698 partials
//   spread over 128·32 / kReduceThreads = 128 CTAs.
// No float atomics: the same bits on every run.  The sums are taken in
// another order than typed_tile.cu's segment sums (the tensor cores add a
// k-step's 16 products at once), so both are held to the plain version
// within one bf16 ulp of each tile's rounded sum, not to each other.
#include "partial_sum.cuh"
#include "typed_pipe.cuh"

namespace ggnn {
namespace tstep {

// (using-declarations: common.cuh's ggnn::kThreads is another name)
using tpipe::bf16;
using tpipe::gru_panel;
using tpipe::init_gru;
using tpipe::kLd;
using tpipe::kSmem;
using tpipe::kThreads;
using tpipe::slot_sums;
using tpipe::store_rows;
using tpipe::zero;

// #7's second kernel: float4 columns a CTA and loads in flight a thread
// (the variants' choice, scripts/torch_typed_variants.py).
constexpr int kReduceThreads = 32, kReduceUnroll = 16;

// One CTA per work item (grid = item_first[n_blocks]); GRU: #6, else #7.
template <bool GRU>
__global__ void __launch_bounds__(kThreads, 1) typed_tile_fused_kernel(
    const bf16* __restrict__ h_pack, long long n_pack,
    const int* __restrict__ dstl, long long n_dstl,
    const int* __restrict__ tile_start, const int* __restrict__ tile_msg_off,
    const int* __restrict__ c_off, const int* __restrict__ tile_type,
    const int* __restrict__ dstl_len, const bf16* __restrict__ msg_w,
    int T2, int n_blocks, int tile_e,
    int align, const int* __restrict__ item_first,
    const int* __restrict__ pbase, const float* __restrict__ init,
    const float* __restrict__ hstate, const bf16* __restrict__ wa,
    const float* __restrict__ b3, const bf16* __restrict__ uzr,
    const bf16* __restrict__ uh, float* __restrict__ ws,
    float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int item = blockIdx.x;
  const int b = item_block(item_first, n_blocks, item);
  const int k = item - item_first[b];
  const int n_items = item_first[b + 1] - item_first[b];
  // the item's tiles (at most kSplit), read once into shared memory: pack
  // offset, type, dstl row and length (0: a dummy, or no real row)
  __shared__ int s_off[kSplit], s_typ[kSplit], s_c[kSplit], s_len[kSplit];
  static_assert(kSplit <= kThreads, "a thread per tile of an item");
  const int t0 = tile_start[b] + k * kSplit;
  const int n_t = min(t0 + kSplit, tile_start[b + 1]) - t0;
  if (threadIdx.x < n_t) {
    const int i = threadIdx.x;
    const int off = tile_msg_off[t0 + i], typ = tile_type[t0 + i];
    const int c = c_off[t0 + i];
    const bool ok =
        off >= 0 && typ >= 0 && typ < T2 && c >= 0 && c < n_dstl;
    s_off[i] = off;
    s_typ[i] = typ;
    s_c[i] = c;
    s_len[i] = ok ? min(dstl_len[c], tile_e) : 0;
  }
  __syncthreads();
  float acc[2][8][4];
  zero<8>(acc);
  slot_sums(acc, smem, s_off, s_typ, s_c, s_len, n_t, h_pack, n_pack, dstl,
            tile_e, align, msg_w);

  const size_t ob = size_t(b) * 128 * 128;
  if (n_items > 1) {  // the item's partial, summed by the second kernel
    store_rows(acc, ws + size_t(pbase[b] + k) * 128 * 128);
    return;
  }
  if constexpr (GRU)  // the GRU epilogue on a = sums + init
    init_gru(acc, smem, init + ob, hstate + ob, wa, b3, uzr, uh, out + ob);
  else
    store_rows(acc, out + ob);
}

// #6's second kernel: 8 CTAs a split block (split[blockIdx.x / 8]), each
// 16 rows.
// Sums the block's item partials in item order, adds init, and runs the
// GRU cell on its rows (gru_block's products and rounding points: the
// gate products' inputs a, h and r⊙h in bf16, f32 gates and h); warp w
// owns the gates' columns [16w, 16w + 16), the six [128, 128] weight
// panels streamed through two cp.async stages and read by ldmatrix.trans.
constexpr int kRS = 16;                                   // rows a CTA
constexpr size_t kRowsB = size_t(kRS) * kLd * sizeof(bf16);
constexpr size_t kRSmem = 2 * pipe::kChunk + 3 * kRowsB;  // 82,688 B

__global__ void __launch_bounds__(kThreads) typed_step_reduce_kernel(
    const int* __restrict__ split, const int* __restrict__ item_first,
    const int* __restrict__ pbase, const float* __restrict__ ws,
    const float* __restrict__ init, const float* __restrict__ hstate,
    const bf16* __restrict__ wa, const float* __restrict__ b3,
    const bf16* __restrict__ uzr, const bf16* __restrict__ uh,
    float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* W_s[2] = {reinterpret_cast<bf16*>(smem),
                  reinterpret_cast<bf16*>(smem + pipe::kChunk)};
  bf16* A_s = reinterpret_cast<bf16*>(smem + 2 * pipe::kChunk);
  bf16* H_s = reinterpret_cast<bf16*>(smem + 2 * pipe::kChunk + kRowsB);
  bf16* RH_s = reinterpret_cast<bf16*>(smem + 2 * pipe::kChunk + 2 * kRowsB);
  const int b = split[blockIdx.x / (128 / kRS)];
  const int strip = blockIdx.x % (128 / kRS);
  const int n = item_first[b + 1] - item_first[b];
  const size_t row0 = size_t(b) * 128 + size_t(strip) * kRS;

  gru_panel(0, W_s[0], wa, uzr, uh);
  gru_panel(1, W_s[1], wa, uzr, uh);

  // the partial sums: 16 rows of 32 float4, two a thread, in item order
  const float* base =
      ws + size_t(pbase[b]) * 128 * 128 + size_t(strip) * kRS * 128;
  float4 sum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) sum[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int it = 0; it < n; ++it) {
    const float4* slot =
        reinterpret_cast<const float4*>(base + size_t(it) * 128 * 128);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 v = slot[threadIdx.x + i * kThreads];
      sum[i].x += v.x;
      sum[i].y += v.y;
      sum[i].z += v.z;
      sum[i].w += v.w;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 5, c = (idx & 31) * 4;
    const float4 iv = *reinterpret_cast<const float4*>(init + (row0 + r) *
                                                       128 + c);
    const float4 hv = *reinterpret_cast<const float4*>(hstate + (row0 + r) *
                                                        128 + c);
    __nv_bfloat162* ap = reinterpret_cast<__nv_bfloat162*>(A_s + r * kLd + c);
    ap[0] = __floats2bfloat162_rn(sum[i].x + iv.x, sum[i].y + iv.y);
    ap[1] = __floats2bfloat162_rn(sum[i].z + iv.z, sum[i].w + iv.w);
    __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(H_s + r * kLd + c);
    hp[0] = __floats2bfloat162_rn(hv.x, hv.y);
    hp[1] = __floats2bfloat162_rn(hv.z, hv.w);
  }

  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int c0 = (threadIdx.x >> 5) * 16;
  // x[ni] += A[16 × 128] · W[:, c0 + 8ni .. + 8] (k ascending, as warp_gemm)
  auto gemm = [&](float (&x)[2][4], const bf16* A, const bf16* W) {
    const bf16* a_base = A + (lane & 15) * kLd + (lane >> 4) * 8;
    const bf16* b_base = W + (lane & 15) * kLd + c0 + (lane >> 4) * 8;
#pragma unroll
    for (int k0 = 0; k0 < 128; k0 += 16) {
      uint32_t a[4], bb[4];
      pipe::ldsm_x4(a, a_base + k0);
      pipe::ldsm_x4_trans(bb, b_base + k0 * kLd);
      pipe::mma_bf16(x[0], a, bb[0], bb[1]);
      pipe::mma_bf16(x[1], a, bb[2], bb[3]);
    }
  };
  float z[2][4] = {}, x[2][4] = {};
  auto step = [&](float (&acc)[2][4], const bf16* A, int stage, int next) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    gemm(acc, A, W_s[stage]);
    __syncthreads();
    gru_panel(next, W_s[stage], wa, uzr, uh);
  };
  step(z, A_s, 0, 2);  // a·W_z
  step(z, H_s, 1, 3);  // h·U_z
  step(x, A_s, 0, 4);  // a·W_r
  step(x, H_s, 1, 5);  // h·U_r
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + (e >> 1) * 8, c = c0 + ni * 8 + 2 * q + (e & 1);
      const float hv = hstate[(row0 + r) * 128 + c];
      z[ni][e] = sigmoid_f(z[ni][e] + b3[c]);
      const float rg = sigmoid_f(x[ni][e] + b3[128 + c]);
      RH_s[r * kLd + c] = __float2bfloat16_rn(rg * hv);
      x[ni][e] = 0.f;
    }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();  // W_h has landed; r⊙h is in RH_s
  gemm(x, A_s, W_s[0]);
  pipe::cp_async_wait_all();
  __syncthreads();
  gemm(x, RH_s, W_s[1]);
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + (e >> 1) * 8, c = c0 + ni * 8 + 2 * q + (e & 1);
      const size_t o = (row0 + r) * 128 + c;
      const float hv = hstate[o];
      const float ht = tanhf(x[ni][e] + b3[256 + c]);
      out[o] = (1.0f - z[ni][e]) * hv + z[ni][e] * ht;
    }
}

template <bool GRU>
static int launch_tile_fused(
    const void* h_pack, long long n_pack, const void* dstl, long long n_dstl,
    const void* tile_start, const void* tile_msg_off, const void* c_off,
    const void* tile_type, const void* dstl_len, const void* msg_w, int T2,
    int n_blocks, int tile_e, int align, const void* item_first,
    const void* pbase, int n_items, const void* split, int n_split,
    const void* init, const void* hstate, const void* wa, const void* b3,
    const void* uzr, const void* uh, void* ws, void* out, cudaStream_t s) {
  if (n_blocks <= 0 || n_items <= 0) return 0;
  if (tile_e <= 0 || tile_e % 16) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      typed_tile_fused_kernel<GRU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err != cudaSuccess) return int(err);
  typed_tile_fused_kernel<GRU><<<n_items, kThreads, kSmem, s>>>(
      static_cast<const bf16*>(h_pack), n_pack, static_cast<const int*>(dstl),
      n_dstl, static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_msg_off), static_cast<const int*>(c_off),
      static_cast<const int*>(tile_type), static_cast<const int*>(dstl_len),
      static_cast<const bf16*>(msg_w), T2,
      n_blocks, tile_e, align, static_cast<const int*>(item_first),
      static_cast<const int*>(pbase), static_cast<const float*>(init),
      static_cast<const float*>(hstate), static_cast<const bf16*>(wa),
      static_cast<const float*>(b3), static_cast<const bf16*>(uzr),
      static_cast<const bf16*>(uh), static_cast<float*>(ws),
      static_cast<float*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return int(err);
  if constexpr (!GRU)
    return launch_partial_sum<kReduceThreads, kReduceUnroll>(
        split, item_first, pbase, ws, n_split, 128, out, s);
  err = cudaFuncSetAttribute(typed_step_reduce_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kRSmem));
  if (err != cudaSuccess) return int(err);
  typed_step_reduce_kernel<<<n_split * (128 / kRS), kThreads, kRSmem, s>>>(
      static_cast<const int*>(split), static_cast<const int*>(item_first),
      static_cast<const int*>(pbase), static_cast<const float*>(ws),
      static_cast<const float*>(init), static_cast<const float*>(hstate),
      static_cast<const bf16*>(wa), static_cast<const float*>(b3),
      static_cast<const bf16*>(uzr), static_cast<const bf16*>(uh),
      static_cast<float*>(out));
  return int(cudaGetLastError());
}

}  // namespace tstep
}  // namespace ggnn

// h_pack, msg_w and the GRU weights bf16 (D = 128, tile_e a multiple of
// 16); the layout arrays, dstl_len [n_dstl] (each dstl row's last index
// with a dst id ≥ 0, plus one; 0 for none), item_first / pbase (the hub
// split, common.cuh) and split [n_split] (the blocks of more than one
// item) int32; init,
// hstate f32 [n_blocks·128, 128]; b3 [384] f32; ws n_partial [128, 128]
// f32 slots; out f32 [n_blocks·128, 128].  Returns the cudaError_t of the
// launches (0 = success).
extern "C" int ggnn_typed_step_fused(
    const void* h_pack, long long n_pack, const void* dstl, long long n_dstl,
    const void* tile_start, const void* tile_msg_off, const void* c_off,
    const void* tile_type, const void* dstl_len, const void* msg_w, int T2,
    int n_blocks, int tile_e, int align, const void* item_first,
    const void* pbase, int n_items, const void* split, int n_split,
    const void* init,
    const void* hstate, const void* wa, const void* b3, const void* uzr,
    const void* uh, void* ws, void* out, void* stream) {
  return ggnn::tstep::launch_tile_fused<true>(
      h_pack, n_pack, dstl, n_dstl, tile_start, tile_msg_off, c_off,
      tile_type, dstl_len, msg_w, T2, n_blocks, tile_e, align, item_first,
      pbase, n_items, split, n_split, init, hstate, wa, b3, uzr, uh, ws, out,
      static_cast<cudaStream_t>(stream));
}

// #7, the STORE form: the arguments of ggnn_typed_step_fused without init,
// hstate and the GRU weights; out f32 [n_blocks·128, 128] = the sums.
extern "C" int ggnn_typed_onehot_fused(
    const void* h_pack, long long n_pack, const void* dstl, long long n_dstl,
    const void* tile_start, const void* tile_msg_off, const void* c_off,
    const void* tile_type, const void* dstl_len, const void* msg_w, int T2,
    int n_blocks, int tile_e, int align, const void* item_first,
    const void* pbase, int n_items, const void* split, int n_split, void* ws,
    void* out, void* stream) {
  return ggnn::tstep::launch_tile_fused<false>(
      h_pack, n_pack, dstl, n_dstl, tile_start, tile_msg_off, c_off,
      tile_type, dstl_len, msg_w, T2, n_blocks, tile_e, align, item_first,
      pbase, n_items, split, n_split, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, ws, out, static_cast<cudaStream_t>(stream));
}
