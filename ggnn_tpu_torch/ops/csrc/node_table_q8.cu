// The q8 node-transform table for Hopper (sm_90a), kernel #15.
//
// Replaces ggnn_tpu/ops/window_pallas.py::_table_block_q8_kernel (run by
// node_table_block_major_q8).  For h [N, D] (N % 128 == 0), msg_w
// [T2, D, D] and msg_b [T2, D] in one dtype T (bf16 or f32), and windows of
// gtypes = W / 128 consecutive types, it writes for every source block i
// and window g (types t = g·gtypes + j):
//     v = h[i·128 + s] · W_t + b_t          (f32 products, f32 bias)
//     e = clip(ceil(log2(max(max|v| over the window, 1e-30)) − 6.9886), ±100)
//     out[(i·T2 + t)·128 + s] = int8(clip(rint(v · 2^−e), ±127))
//     scales[i·(T2 / gtypes) + g] = 2^e
// rint rounds half to even, as jnp.round; log2f may differ from XLA's log2
// by an ulp where the argument of ceil sits at an integer.
//
// Bound on this card: HBM bytes.  At the community headline (262,144
// nodes, T2 = 16, W 512, bf16) one call reads h (67 MB) and writes the int8
// table (537 MB): ≈ 0.18 ms at 3.35 TB/s, against 0.137 TFLOP of products
// (0.14 ms at the dense bf16 rate).  A window's scale needs the max over
// all its values before any of them is quantized.
//
// bf16 at D = 128 (mma_pipe.cuh's products, ldmatrix and mma.sync, W_t
// read as it lies through ldmatrix.trans):
// (b) up to 8 types a window: a cluster of gtypes CTAs a window, CTA j
//     running type g·gtypes + j, so that each product runs once and its
//     accumulator waits in registers for the window's exponent.  Clusters
//     walk contiguous ranges of (window, source block) items in
//     window-major order: a CTA's W_t and b_t stay resident across a run of
//     one window (staged again where g changes), and the source blocks'
//     rows stream by 16-byte cp.async through a ring of two stages, the
//     next item's copy in flight during the current product.  The CTA's
//     max|v| goes into its slot in every CTA of the cluster
//     (st.shared::cluster), one cluster barrier publishes them (slots
//     double-buffered by item parity), and every CTA takes the exponent
//     from the same values.  The tile is quantized into the stage its rows
//     came from and leaves as contiguous 16-byte int8 rows with streaming
//     stores.
// (a) more types a window (W = 2048: 16): persistent CTAs, two an SM, walk
//     (source block, window) items in block-major order; a block's rows
//     are staged once and stay resident across its windows, W_t and b_t
//     stream through a ring of two stages, and each window's products run
//     twice, a first pass for the max and a second (the same instructions
//     on the same operands: the same bits) that quantizes into the ring
//     stage just read; the tile leaves as 16-byte int8 rows with streaming
//     stores.  (a) and (b) give the same bits.
//
// f32, and D = 128·P in either dtype, keep the first body: one CTA per
// (source block, window), the block's rows and each W_t (transposed)
// staged in shared memory and multiplied by common.cuh's warp_gemm, the
// products twice; wider states walk 128-column panels, each output panel's
// products summing over the P K-panels of h and W_t (h's panel staged anew
// for each), and the window's max covering every panel.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "mma_pipe.cuh"
#include "window_pipe.cuh"

namespace ggnn {

// --- bf16, D = 128 -----------------------------------------------------------

namespace {

using pipe::bf16;
constexpr int kLd8 = 144;  // int8 rows of 128 + 16 bytes in the epilogue

// log2(127) = 6.9886: max|v|·2^-e <= 127
__device__ __forceinline__ float window_exponent(float m) {
  const float e = ceilf(log2f(fmaxf(m, 1e-30f)) - 6.9886f);
  return fminf(fmaxf(e, -100.0f), 100.0f);
}

// Design (a) of the header: windows of more types than a cluster holds.
__global__ void __launch_bounds__(pipe::kThreads, 2)
    node_table_q8_bf16_kernel(const bf16* __restrict__ h,
                              const bf16* __restrict__ w,
                              const bf16* __restrict__ b, int n_blocks,
                              int T2, int gtypes, int8_t* __restrict__ out,
                              float* __restrict__ scales) {
  using pipe::kLd;
  using pipe::kRows;
  using pipe::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kChunkElems = kRows * kLd;
  __shared__ __align__(16) bf16 bias_s[2][128];
  __shared__ float warp_max[kThreads / 32];
  __shared__ float e_s;
  const int tid = threadIdx.x;
  bf16* A_s = reinterpret_cast<bf16*>(smem);
  bf16* W_s = A_s + kChunkElems;  // the ring: 2 stages
  const int wpb = T2 / gtypes;    // windows of a source block
  const int per_item = 2 * gtypes;  // steps: pass 0 (max), pass 1 (quantize)
  const long long n_items = (long long)n_blocks * wpb;
  const long long it0 = n_items * blockIdx.x / gridDim.x;
  const long long it1 = n_items * (blockIdx.x + 1) / gridDim.x;
  const long long n_steps = (it1 - it0) * per_item;

  // step q's type: item it0 + q / per_item, type j = q % gtypes of its window
  auto type_of = [&](long long q) {
    const long long item = it0 + q / per_item;
    return int(item % wpb) * gtypes + int(q % gtypes);
  };
  auto stage_step = [&](long long q, int st) {
    const bf16* wt = w + size_t(type_of(q)) * 128 * 128;
    pipe::stage_chunk(
        W_s + st * kChunkElems,
        [&](int k) -> const bf16* { return wt + size_t(k) * 128; }, 0, 128,
        true);
    if (tid < 16)
      pipe::cp_async16(&bias_s[st][tid * 8],
                       b + size_t(type_of(q)) * 128 + tid * 8);
    pipe::cp_async_commit();
  };

  pipe::WarpTile tile;
  long long staged = -1;  // the resident rows' source block
  float m = 0.0f, inv = 0.0f;
  if (n_steps > 0) stage_step(0, 0);
  for (long long q = 0; q < n_steps; ++q) {
    const int st = int(q & 1);
    const long long item = it0 + q / per_item;
    const long long blk = item / wpb;
    const int g = int(item % wpb), k = int(q % per_item);
    const int pass = k / gtypes, t = g * gtypes + k % gtypes;
    // step q's W_t (copied during step q − 1) has landed; past the barrier
    // every warp is done with step q − 1, so its stage is free
    pipe::cp_async_wait_all();
    __syncthreads();
    if (blk != staged) {
      pipe::stage_chunk(
          A_s,
          [&](int r) -> const bf16* {
            return h + (size_t(blk) * kRows + r) * 128;
          },
          0, 128, true);
      pipe::cp_async_commit();
      pipe::cp_async_wait_all();
      __syncthreads();
      staged = blk;
    }
    if (q + 1 < n_steps) stage_step(q + 1, st ^ 1);
    tile.zero();
    tile.mma_chunk(A_s, W_s + st * kChunkElems);
    if (pass == 0) {
      if (k == 0) m = 0.0f;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int c = pipe::WarpTile::col(ni, 0);
        const float b0 = to_f(bias_s[st][c]), b1 = to_f(bias_s[st][c + 1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; e += 2)
            m = fmaxf(m, fmaxf(fabsf(tile.acc[mi][ni][e] + b0),
                               fabsf(tile.acc[mi][ni][e + 1] + b1)));
      }
      if (k == gtypes - 1) {  // the window's max → its exponent
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        if ((tid & 31) == 0) warp_max[tid >> 5] = m;
        __syncthreads();
        if (tid == 0) {
          float mm = warp_max[0];
          for (int i = 1; i < kThreads / 32; ++i) mm = fmaxf(mm, warp_max[i]);
          const float e = window_exponent(mm);
          e_s = e;
          scales[size_t(item)] = exp2f(e);  // window-major: i·wpb + g
        }
        __syncthreads();
        inv = exp2f(-e_s);
      }
    } else {
      // q = clip(rint(v·2^-e), ±127) into the W stage just used (free until
      // the next step stages the step after it there), then 16-byte rows
      unsigned char* O_s =
          reinterpret_cast<unsigned char*>(W_s + st * kChunkElems);
      __syncthreads();  // every warp is done reading the stage
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int c = pipe::WarpTile::col(ni, 0);
        const float b0 = to_f(bias_s[st][c]), b1 = to_f(bias_s[st][c + 1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const float q0 = fminf(
                fmaxf(rintf((tile.acc[mi][ni][e] + b0) * inv), -127.0f),
                127.0f);
            const float q1 = fminf(
                fmaxf(rintf((tile.acc[mi][ni][e + 1] + b1) * inv), -127.0f),
                127.0f);
            *reinterpret_cast<uint16_t*>(
                O_s + pipe::WarpTile::row(mi, e) * kLd8 + c) =
                uint16_t(uint8_t(int8_t(q0))) |
                uint16_t(uint16_t(uint8_t(int8_t(q1))) << 8);
          }
      }
      __syncthreads();
      int8_t* dst = out + (size_t(blk) * T2 + t) * kRows * 128;
      for (int idx = tid; idx < kRows * 8; idx += kThreads) {
        const int r = idx >> 3, v = idx & 7;
        __stcs(reinterpret_cast<int4*>(dst + r * 128 + v * 16),
               *reinterpret_cast<const int4*>(O_s + r * kLd8 + v * 16));
      }
    }
  }
}

// Design (b) of the header: windows of at most kMaxCluster types.
constexpr int kMaxCluster = 8;

__global__ void __launch_bounds__(pipe::kThreads, 2)
    node_table_q8_cluster_kernel(const bf16* __restrict__ h,
                                 const bf16* __restrict__ w,
                                 const bf16* __restrict__ b, int n_blocks,
                                 int T2, int gtypes,
                                 int8_t* __restrict__ out,
                                 float* __restrict__ scales) {
  using pipe::kLd;
  using pipe::kRows;
  using pipe::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kChunkElems = kRows * kLd;
  __shared__ __align__(16) bf16 bias_s[128];
  __shared__ float warp_max[kThreads / 32];
  __shared__ float slot[2][kMaxCluster];  // the cluster's maxes
  const int tid = threadIdx.x;
  bf16* W_s = reinterpret_cast<bf16*>(smem);  // W_t, resident
  bf16* A_s = W_s + kChunkElems;              // the ring: 2 stages
  const int rank = int(blockIdx.x) % gtypes;
  const int cluster = int(blockIdx.x) / gtypes;
  const int n_clusters = int(gridDim.x) / gtypes;
  const int wpb = T2 / gtypes;
  const long long n_items = (long long)n_blocks * wpb;
  const long long it0 = n_items * cluster / n_clusters;
  const long long it1 = n_items * (cluster + 1) / n_clusters;

  // window-major items: item = g·n_blocks + source block
  auto stage_rows = [&](long long item, int st) {
    const long long blk = item % n_blocks;
    pipe::stage_chunk(
        A_s + st * kChunkElems,
        [&](int r) -> const bf16* {
          return h + (size_t(blk) * kRows + r) * 128;
        },
        0, 128, true);
    pipe::cp_async_commit();
  };

  pipe::WarpTile tile;
  int staged_g = -1;  // the window of the resident W_t
  wpipe::cluster_sync();  // every CTA of the cluster runs before any store
  if (it0 < it1) stage_rows(it0, 0);
  for (long long item = it0; item < it1; ++item) {
    const int st = int((item - it0) & 1);
    const int g = int(item / n_blocks);
    const long long blk = item % n_blocks;
    const int t = g * gtypes + rank;
    // this item's rows have landed; every warp is done with the last
    // item's stage (its int8 tile went out from there)
    pipe::cp_async_wait_all();
    __syncthreads();
    if (g != staged_g) {
      const bf16* wt = w + size_t(t) * 128 * 128;
      pipe::stage_chunk(
          W_s, [&](int k) -> const bf16* { return wt + size_t(k) * 128; }, 0,
          128, true);
      if (tid < 16)
        pipe::cp_async16(&bias_s[tid * 8], b + size_t(t) * 128 + tid * 8);
      pipe::cp_async_commit();
      pipe::cp_async_wait_all();
      __syncthreads();
      staged_g = g;
    }
    if (item + 1 < it1) stage_rows(item + 1, st ^ 1);
    tile.zero();
    tile.mma_chunk(A_s + st * kChunkElems, W_s);
    float m = 0.0f;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int c = pipe::WarpTile::col(ni, 0);
      const float b0 = to_f(bias_s[c]), b1 = to_f(bias_s[c + 1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          m = fmaxf(m, fmaxf(fabsf(tile.acc[mi][ni][e] + b0),
                             fabsf(tile.acc[mi][ni][e + 1] + b1)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((tid & 31) == 0) warp_max[tid >> 5] = m;
    __syncthreads();
    const int par = int((item - it0) & 1);
    if (tid < gtypes) {  // this CTA's max into slot [par][rank] of CTA tid
      float mm = warp_max[0];
      for (int i = 1; i < kThreads / 32; ++i) mm = fmaxf(mm, warp_max[i]);
      asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(
                       wpipe::map_rank(&slot[par][rank], tid)),
                   "f"(mm)
                   : "memory");
    }
    wpipe::cluster_sync();  // every CTA's max is in every slot
    float mm = slot[par][0];
    for (int i = 1; i < gtypes; ++i) mm = fmaxf(mm, slot[par][i]);
    const float ex = window_exponent(mm), inv = exp2f(-ex);
    if (rank == 0 && tid == 0) scales[size_t(blk) * wpb + g] = exp2f(ex);
    // q = clip(rint(v·2^-e), ±127) into the rows' stage (every warp is past
    // its product: the cluster barrier), then 16-byte rows
    unsigned char* O_s =
        reinterpret_cast<unsigned char*>(A_s + st * kChunkElems);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int c = pipe::WarpTile::col(ni, 0);
      const float b0 = to_f(bias_s[c]), b1 = to_f(bias_s[c + 1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float q0 = fminf(
              fmaxf(rintf((tile.acc[mi][ni][e] + b0) * inv), -127.0f), 127.0f);
          const float q1 = fminf(
              fmaxf(rintf((tile.acc[mi][ni][e + 1] + b1) * inv), -127.0f),
              127.0f);
          *reinterpret_cast<uint16_t*>(
              O_s + pipe::WarpTile::row(mi, e) * kLd8 + c) =
              uint16_t(uint8_t(int8_t(q0))) |
              uint16_t(uint16_t(uint8_t(int8_t(q1))) << 8);
        }
    }
    __syncthreads();
    int8_t* dst = out + (size_t(blk) * T2 + t) * kRows * 128;
    for (int idx = tid; idx < kRows * 8; idx += kThreads) {
      const int r = idx >> 3, v = idx & 7;
      __stcs(reinterpret_cast<int4*>(dst + r * 128 + v * 16),
             *reinterpret_cast<const int4*>(O_s + r * kLd8 + v * 16));
    }
  }
}

int launch_node_table_q8_cluster(const void* h, const void* w, const void* b,
                                 int n_blocks, int T2, int gtypes, void* out,
                                 void* scales, cudaStream_t stream) {
  const size_t smem = 3 * pipe::kChunk;  // W_t, the ring
  auto kern = node_table_q8_cluster_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(gtypes);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(pipe::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(unsigned(gtypes) * 4096);
  int fit = 0;  // clusters resident at once (two CTAs an SM)
  err = cudaOccupancyMaxActiveClusters(&fit, kern, &cfg);
  if (err != cudaSuccess) return int(err);
  const long long n_items = (long long)n_blocks * (T2 / gtypes);
  cfg.gridDim = dim3(unsigned(
      gtypes * std::min<long long>(n_items, std::max(fit, 1))));
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const bf16*>(h),
                           static_cast<const bf16*>(w),
                           static_cast<const bf16*>(b), n_blocks, T2, gtypes,
                           static_cast<int8_t*>(out),
                           static_cast<float*>(scales));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

int launch_node_table_q8_bf16(const void* h, const void* w, const void* b,
                              int n_blocks, int T2, int gtypes, void* out,
                              void* scales, cudaStream_t stream) {
  const size_t smem = 3 * pipe::kChunk;  // the block's rows, the ring
  cudaError_t err = cudaFuncSetAttribute(
      node_table_q8_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  int per_sm = 0;  // 2 (104 KB each)
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, node_table_q8_bf16_kernel, pipe::kThreads, smem);
  if (err != cudaSuccess) return int(err);
  const long long n_items = (long long)n_blocks * (T2 / gtypes);
  const int grid = int(std::min<long long>(
      n_items, std::max(per_sm, 1) * pipe::multiprocessors()));
  node_table_q8_bf16_kernel<<<grid, pipe::kThreads, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), n_blocks, T2, gtypes,
      static_cast<int8_t*>(out), static_cast<float*>(scales));
  return int(cudaGetLastError());
}

}  // namespace

// --- f32 and D = 128·P: one CTA per (source block, window) ------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) node_table_q8_kernel(
    const T* __restrict__ h, const T* __restrict__ w, const T* __restrict__ b,
    int T2, int gtypes, int P, int8_t* __restrict__ out,
    float* __restrict__ scales) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  T* A_s = reinterpret_cast<T*>(smem);
  T* B_s = reinterpret_cast<T*>(smem + Smem<T>::tile);
  __shared__ float warp_max[kThreads / 32];
  __shared__ float e_s;
  const int i = blockIdx.x, g = blockIdx.y;
  const int row0 = (threadIdx.x >> 5) * 16;
  const int D = P * kD;
  const T* hb = h + size_t(i) * kRows * D;
  auto stage_h = [&](int kp) {  // K-panel kp of the source block's rows
    for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads)
      A_s[(idx / kD) * ld + idx % kD] =
          hb[size_t(idx / kD) * D + kp * kD + idx % kD];
  };
  if (P == 1) stage_h(0);

  float acc[kNT][4];
  float m = 0.0f;
  float inv = 0.0f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int j = 0; j < gtypes; ++j)
      for (int qp = 0; qp < P; ++qp) {  // output panel qp of type t
        const int t = g * gtypes + j;
        zero_acc(acc);
        for (int kp = 0; kp < P; ++kp) {
          __syncthreads();  // every warp is done with the previous W_t (and
                            // the first time: A_s is staged)
          if (P > 1) stage_h(kp);
          load_wt(B_s, w + (size_t(t) * D + kp * kD) * D, D, qp * kD);
          __syncthreads();
          warp_gemm(acc, A_s + row0 * ld, B_s);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = row0 + frag_row(e), col = qp * kD + frag_col(nt, e);
            const float v = acc[nt][e] + to_f(b[size_t(t) * D + col]);
            if (pass == 0) {
              m = fmaxf(m, fabsf(v));
            } else {
              const float q = fminf(fmaxf(rintf(v * inv), -127.0f), 127.0f);
              out[((size_t(i) * T2 + t) * kRows + r) * D + col] = int8_t(q);
            }
          }
      }
    if (pass == 0) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
      __syncthreads();
      if (threadIdx.x == 0) {
        float mm = warp_max[0];
        for (int k = 1; k < kThreads / 32; ++k) mm = fmaxf(mm, warp_max[k]);
        const float e = window_exponent(mm);
        e_s = e;
        scales[size_t(i) * (T2 / gtypes) + g] = exp2f(e);
      }
      __syncthreads();
      inv = exp2f(-e_s);
    }
  }
}

template <typename T>
static int launch_node_table_q8(const void* h, const void* w, const void* b,
                                int n_blocks, int T2, int gtypes, int P,
                                void* out, void* scales, cudaStream_t stream) {
  const size_t smem = 2 * Smem<T>::tile;
  cudaError_t err = cudaFuncSetAttribute(
      node_table_q8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_blocks, T2 / gtypes);
  node_table_q8_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const T*>(b), T2, gtypes, P, static_cast<int8_t*>(out),
      static_cast<float*>(scales));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// dtype: 0 = float32, 1 = bfloat16 (h, msg_w, msg_b).  h [n_blocks·128, D],
// msg_w [T2, D, D], msg_b [T2, D] with D = 128·P; windows of gtypes types
// (T2 % gtypes == 0); out int8 [n_blocks·T2·128, D], scales f32
// [n_blocks·T2 / gtypes].  Returns the cudaError_t of the launch.
extern "C" int ggnn_node_table_q8(int dtype, const void* h, const void* msg_w,
                                  const void* msg_b, int n_blocks, int T2,
                                  int gtypes, int P, void* out, void* scales,
                                  void* stream) {
  if (n_blocks <= 0 || T2 <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gtypes <= 0 || T2 % gtypes || P <= 0) return int(cudaErrorInvalidValue);
  if (dtype == 1 && P == 1 && gtypes <= ggnn::kMaxCluster)
    return ggnn::launch_node_table_q8_cluster(h, msg_w, msg_b, n_blocks, T2,
                                              gtypes, out, scales, s);
  if (dtype == 1 && P == 1)
    return ggnn::launch_node_table_q8_bf16(h, msg_w, msg_b, n_blocks, T2,
                                           gtypes, out, scales, s);
  if (dtype == 1)
    return ggnn::launch_node_table_q8<__nv_bfloat16>(
        h, msg_w, msg_b, n_blocks, T2, gtypes, P, out, scales, s);
  if (dtype == 0)
    return ggnn::launch_node_table_q8<float>(h, msg_w, msg_b, n_blocks, T2,
                                             gtypes, P, out, scales, s);
  return int(cudaErrorInvalidValue);
}
