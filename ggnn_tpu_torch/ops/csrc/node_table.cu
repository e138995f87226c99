// The block-major node-transform table for Hopper (sm_90a), kernel #10.
//
// Replaces ggnn_tpu/ops/window_pallas.py::_table_block_kernel (run by
// node_table_block_major).  For h [N, D] (N % 128 == 0), msg_w [T2, D, D]
// and msg_b [T2, D], all in one dtype T (bf16 or f32), it writes
//     out[i·T2·128 + t·128 + s] = T(h[i·128 + s] · W_t + b_t)
// for every 128-row source block i, type t and row s: the products
// accumulate in f32, the bias is added in f32, and the sum is rounded once
// to T.  The legacy table-gather forward gathers its messages from these
// rows (layout row_order = 'block'); the window backend reads its windows.
//
// Bound on this card: HBM bytes.  At the uniform headline (262,144 nodes,
// T2 = 16, D = 128, bf16) one call reads h (67 MB) and writes the table
// (1.07 GB): ≈ 0.34 ms at 3.35 TB/s, against 0.14 TFLOP of products
// (0.14 ms at the dense bf16 tensor rate).
//
// Design, bf16 (mma_pipe.cuh).  Persistent CTAs, two per SM at D <= 128
// (102 KB of shared memory each, at most 128 registers a thread), for each
// 128-column panel of the output: CTA x walks a contiguous range of (source
// block, type) items in block-major order.  A block's rows are staged once,
// with 16-byte cp.async copies, and stay in shared memory while the CTA
// loops over the types; W_t's panel and b_t stream through a ring of two
// stages as they lie in memory (the whole bank, 512 KB at the headline,
// stays in L2), the next type's copy in flight during the current product
// (mma.sync bf16 with ldmatrix, B through ldmatrix.trans).  The epilogue
// adds b_t in f32 and rounds once into the ring stage the product has just
// read; the (i, t) block, contiguous [128, D] rows, then goes out as
// 16-byte rows with streaming (evict-first) stores while the SM's other CTA
// multiplies.  Any D: K and N tails are zero in shared memory, D = 128·P
// runs P panels (grid y) over P K-chunks; the block's rows are resident up
// to three K-chunks at a time, so above D = 384 they are staged again for
// each type.  No split-K: the same bits on every run.
//
// f32 keeps full f32 FMA products (no TF32): one CTA per (block, type,
// panel) stages the block's rows and W_t's panel (transposed) in K-chunks
// and common.cuh's warp_gemm multiplies them.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "mma_pipe.cuh"

namespace ggnn {

// --- bf16: the persistent kernel ------------------------------------------

namespace {

using pipe::bf16;
constexpr int kAMax = 3;  // K-chunks of the source block resident at most

__global__ void __launch_bounds__(pipe::kThreads, 2)
    node_table_bf16_kernel(const bf16* __restrict__ h,
                           const bf16* __restrict__ w,
                           const bf16* __restrict__ b, int n_blocks, int D,
                           int T2, bf16* __restrict__ out) {
  using pipe::kCols;
  using pipe::kLd;
  using pipe::kRows;
  using pipe::kThreads;
  using pipe::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kChunkElems = kRows * kLd;
  __shared__ __align__(16) bf16 bias_s[2][kCols];  // b_t beside its W chunk

  const int tid = threadIdx.x;
  const int KP = (D + kCols - 1) / kCols;  // K-chunks
  const int KA = min(KP, kAMax);           // of them resident
  const int c0 = blockIdx.y * kCols;       // this CTA's panel
  const int wid = min(kCols, D - c0);
  const bool vec = D % kVec == 0;
  bf16* A_s = reinterpret_cast<bf16*>(smem);
  bf16* W_s = A_s + KA * kChunkElems;      // the ring: 2 stages
  // CTA x takes the (block, type) items [n·x/G, n·(x+1)/G), in block-major
  // order: each item is KP steps, one a K-chunk
  const long long n_items = (long long)n_blocks * T2;
  const long long it0 = n_items * blockIdx.x / gridDim.x;
  const long long it1 = n_items * (blockIdx.x + 1) / gridDim.x;
  const long long n_steps = (it1 - it0) * KP;

  // stages step q's chunk of W_t's panel, and b_t's, into ring stage st
  auto stage_step = [&](long long q, int st) {
    const int t = int((it0 + q / KP) % T2), kk0 = int(q % KP) * kCols;
    const bf16* wt = w + size_t(t) * D * D;
    pipe::stage_chunk(
        W_s + st * kChunkElems,
        [&](int k) -> const bf16* {
          return kk0 + k < D ? wt + size_t(kk0 + k) * D : nullptr;
        },
        c0, D, vec);
    const bf16* bt = b + size_t(t) * D + c0;
    if (vec) {
      if (tid < kCols / kVec) {
        if (tid * kVec < wid)
          pipe::cp_async16(&bias_s[st][tid * kVec], bt + tid * kVec);
        else
          *reinterpret_cast<uint4*>(&bias_s[st][tid * kVec]) =
              make_uint4(0u, 0u, 0u, 0u);
      }
    } else if (tid < kCols) {
      bias_s[st][tid] = tid < wid ? bt[tid] : __float2bfloat16_rn(0.0f);
    }
    pipe::cp_async_commit();
  };

  pipe::WarpTile tile;
  long long staged = -1;                    // the resident rows' key
  const int n_groups = (KP + KA - 1) / KA;
  if (n_steps > 0) stage_step(0, 0);
  for (long long q = 0; q < n_steps; ++q) {
    const int st = int(q & 1);
    const long long item = it0 + q / KP;
    const long long blk = item / T2;
    const int t = int(item % T2), kc = int(q % KP);
    const int grp = kc / KA;
    const long long key = blk * n_groups + grp;
    // step q's W chunk (copied during step q − 1) has landed; past the
    // barrier every warp is done with step q − 1, so its stage is free
    pipe::cp_async_wait_all();
    __syncthreads();
    if (key != staged) {  // a new block (or, above D = 384, K-group)
      const bf16* hb = h + size_t(blk) * kRows * D;
      for (int j = 0; j < KA; ++j) {
        const int kk0 = (grp * KA + j) * kCols;
        if (kk0 >= D) break;
        pipe::stage_chunk(
            A_s + j * kChunkElems,
            [&](int r) -> const bf16* { return hb + size_t(r) * D; }, kk0,
            D, vec);
      }
      pipe::cp_async_commit();
      pipe::cp_async_wait_all();
      __syncthreads();
      staged = key;
    }
    if (q + 1 < n_steps) stage_step(q + 1, st ^ 1);
    if (kc == 0) tile.zero();
    tile.mma_chunk(A_s + (kc - grp * KA) * kChunkElems,
                   W_s + st * kChunkElems);
    if (kc == KP - 1) {
      // epilogue: acc + b_t rounded once into the W stage just used (free
      // until the next step stages the step after it there), then 16-byte
      // rows
      bf16* O_s = W_s + st * kChunkElems;
      __syncthreads();  // every warp is done reading the stage
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int c = pipe::WarpTile::col(ni, 0);
        const float b0 = to_f(bias_s[st][c]), b1 = to_f(bias_s[st][c + 1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int r = pipe::WarpTile::row(mi, e);
            *reinterpret_cast<__nv_bfloat162*>(O_s + r * kLd + c) =
                __floats2bfloat162_rn(tile.acc[mi][ni][e] + b0,
                                      tile.acc[mi][ni][e + 1] + b1);
          }
      }
      __syncthreads();
      bf16* dst = out + (size_t(blk) * T2 + t) * kRows * D + c0;
      if (vec) {
        constexpr int kV = kCols / kVec;
        for (int idx = tid; idx < kRows * kV; idx += kThreads) {
          const int r = idx / kV, v = idx % kV;
          if (v * kVec < wid)
            __stcs(reinterpret_cast<int4*>(dst + size_t(r) * D + v * kVec),
                   *reinterpret_cast<const int4*>(O_s + r * kLd + v * kVec));
        }
      } else {
        for (int idx = tid; idx < kRows * wid; idx += kThreads) {
          const int r = idx / wid, c = idx % wid;
          dst[size_t(r) * D + c] = O_s[r * kLd + c];
        }
      }
    }
  }
}

int launch_node_table_bf16(const void* h, const void* w, const void* b,
                           int n_blocks, int D, int T2, void* out,
                           cudaStream_t stream) {
  const int panels = (D + pipe::kCols - 1) / pipe::kCols;
  const size_t smem = (std::min(panels, kAMax) + 2) * pipe::kChunk;
  cudaError_t err = cudaFuncSetAttribute(
      node_table_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  int per_sm = 0;  // 2 at D <= 128 (102 KB each), else 1
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, node_table_bf16_kernel, pipe::kThreads, smem);
  if (err != cudaSuccess) return int(err);
  const int per_panel =
      std::max(1, std::max(per_sm, 1) * pipe::multiprocessors() / panels);
  const long long n_items = (long long)n_blocks * T2;
  const dim3 grid(unsigned(std::min<long long>(n_items, per_panel)), panels);
  node_table_bf16_kernel<<<grid, pipe::kThreads, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), n_blocks, D, T2, static_cast<bf16*>(out));
  return int(cudaGetLastError());
}

}  // namespace

// --- f32: full f32 products, one CTA per (block, type, panel) -------------

__global__ void __launch_bounds__(kThreads) node_table_f32_kernel(
    const float* __restrict__ h, const float* __restrict__ w,
    const float* __restrict__ b, int D, int T2, float* __restrict__ out) {
  using T = float;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  T* A_s = reinterpret_cast<T*>(smem);
  T* B_s = reinterpret_cast<T*>(smem + Smem<T>::tile);
  const int i = blockIdx.x, t = blockIdx.y, c0 = blockIdx.z * kRows;
  const int wid = min(kRows, D - c0);
  const int row0 = (threadIdx.x >> 5) * 16;
  const T* hb = h + size_t(i) * kRows * D;
  const T* wt = w + size_t(t) * D * D;
  float acc[kNT][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < D; k0 += kD) {
    __syncthreads();  // every warp is done with the previous chunk
    for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads) {
      // A_s[r][k] = h[i·128 + r][k0 + k]
      const int r = idx / kD, k = idx % kD;
      A_s[r * ld + k] = k0 + k < D ? hb[size_t(r) * D + k0 + k]
                                   : from_f<T>(0.0f);
      // B_s[n][k] = W_t[k0 + k][c0 + n]: consecutive threads read
      // consecutive columns of one row of W_t
      const int kk = idx / kD, n = idx % kD;
      B_s[n * ld + kk] = (k0 + kk < D && n < wid)
                             ? wt[size_t(k0 + kk) * D + c0 + n]
                             : from_f<T>(0.0f);
    }
    __syncthreads();
    warp_gemm(acc, A_s + row0 * ld, B_s);
  }
  __syncthreads();  // A_s is free: the rounded rows go there
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + frag_row(e), col = frag_col(nt, e);
      if (col < wid)
        A_s[r * ld + col] =
            from_f<T>(acc[nt][e] + to_f(b[size_t(t) * D + c0 + col]));
    }
  __syncthreads();
  T* dst = out + (size_t(i) * T2 + t) * kRows * D + c0;
  for (int idx = threadIdx.x; idx < kRows * wid; idx += kThreads) {
    const int r = idx / wid, col = idx % wid;
    dst[size_t(r) * D + col] = A_s[r * ld + col];
  }
}

static int launch_node_table_f32(const void* h, const void* w,
                                 const void* b, int n_blocks, int D, int T2,
                                 void* out, cudaStream_t stream) {
  const size_t smem = 2 * Smem<float>::tile;
  cudaError_t err = cudaFuncSetAttribute(
      node_table_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_blocks, T2, (D + kRows - 1) / kRows);
  node_table_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const float*>(b), D, T2, static_cast<float*>(out));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// dtype: 0 = float32, 1 = bfloat16 (h, msg_w, msg_b and out all in it).
// h [n_blocks·128, D], msg_w [T2, D, D], msg_b [T2, D], out
// [n_blocks·T2·128, D], D >= 1.  Returns the cudaError_t of the
// launch.
extern "C" int ggnn_node_table(int dtype, const void* h, const void* msg_w,
                               const void* msg_b, int n_blocks, int D, int T2,
                               void* out, void* stream) {
  if (n_blocks <= 0 || T2 <= 0) return 0;
  if (D < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return ggnn::launch_node_table_bf16(h, msg_w, msg_b, n_blocks, D, T2, out,
                                        s);
  if (dtype == 0)
    return ggnn::launch_node_table_f32(h, msg_w, msg_b, n_blocks, D, T2, out,
                                       s);
  return int(cudaErrorInvalidValue);
}
