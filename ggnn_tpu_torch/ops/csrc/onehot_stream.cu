// The streamed one-hot scatter for Hopper (sm_90a): kernel #19, and #18
// where #11's pipeline does not take it.
//
// Replaces _scatter_loopT_kernel (run by onehot_segment_scatter_loopT, #19)
// of ggnn_tpu/ops/scatter_pallas.py, and _scatter_stream_kernel (run by
// onehot_segment_scatter_stream, #18) for an f32 message pack, D ≠ 128 or
// tile_e % 16 ≠ 0 (bf16 at D = 128 with tile_e % 16 = 0 runs #11's count
// form, window_mono_fused.cu).  Both compute, for every dst block b of 128
// rows and its tiles i in [tile_start[b], tile_start[b + 1]),
//     out[b·128 + r] = Σ_i Σ_j C[i·128 + r][j] · msgs[i·tile_e + j]      (f32)
// from the int8 stream C [n_tiles·128, tile_e] (each tile's one-hot stored
// transposed, the array #8 reads) and msgs [n_tiles·tile_e, D] in T (bf16 or
// f32), whatever int8 values C holds (the TPU kernels cast C and multiply;
// they do not check that it is one-hot).  A block without tiles is written
// as zeros.
//
// Design.  One CTA per (dst block, 128-column panel of D); it walks the
// block's edges in order, in K-chunks of 128 edges (a block's tiles are
// consecutive, so a chunk may span tiles when tile_e < 128).  At tile_e
// 2048–4096 a one-hot tile is 256–512 KB, more than shared memory holds;
// a chunk is 16 KB of one-hot and 32 KB of bf16 messages.  The counterpart
// of the TPU kernel's double-buffered DMA loop: a ring of two stages filled
// by cp.async (16-byte copies straight from global memory into the raw
// layouts, C as int8 [r][k] and the messages as [k][n]); the copies of
// chunk k + 1 are in flight while chunk k is multiplied, whose operands the
// product reads in place (warp_gemm_raw: mma.sync, bf16 in, f32
// accumulators in registers; the counts are exact in bf16 and the products
// exact in f32; FMA loops in the same fragment layout for f32 messages, no
// TF32).  Where a 16-byte copy would not be aligned (tile_e % 16 ≠ 0; D not
// whole 16-byte vectors) that part of a stage is stored by plain loads
// instead.  The block is written once: no atomics, no split, the same bits
// on every run.
//
// Bound on this card: HBM bytes.  At the uniform headline (8M directed
// edges, tile_e 2048, D = 128, bf16) one call reads the messages (≈ 2.1 GB)
// and the one-hot stream (≈ 1.1 GB) once and writes 134 MB: ≈ 1 ms at 3.35
// TB/s, against 0.28 TFLOP of dense one-hot products (0.28 ms at the bf16
// tensor rate).  What this body does not do: TMA, wgmma, decoding the
// one-hot into dst ids (#8 does) or skipping its zeros.
#include <stdint.h>

#include "common.cuh"

namespace ggnn {

constexpr int kChunk = kD;            // edges per K-chunk
constexpr int kLdO = kChunk + 16;     // int8 one-hot rows in shared memory

// The block's edge range [e0, e1) in message rows, its tiles clamped to
// the stream.
__device__ __forceinline__ void block_edges(const int* __restrict__ tile_start,
                                            int n_tiles, int tile_e,
                                            long long& e0, long long& e1) {
  const int b = blockIdx.x;
  const int t1 = min(max(tile_start[b + 1], 0), n_tiles);
  const int t0 = min(max(tile_start[b], 0), t1);
  e0 = (long long)t0 * tile_e;
  e1 = (long long)t1 * tile_e;
}

// C's entry for dst row r and message row e (tile e / tile_e, column
// e % tile_e); i0, j0: the tile and column of the chunk's first edge e0,
// k = e − e0.
__device__ __forceinline__ int8_t onehot_at(const int8_t* __restrict__ oh,
                                            int tile_e, long long i0, int j0,
                                            int k, int r) {
  const int j = j0 + k;
  const long long i = i0 + j / tile_e;
  return oh[(i * kRows + r) * tile_e + j % tile_e];
}

__device__ __forceinline__ void store_out(const float (&acc)[kNT][4],
                                          float* __restrict__ out, int D,
                                          int c0, int wid) {
  const int row0 = (threadIdx.x >> 5) * 16;
  float* dst = out + size_t(blockIdx.x) * kRows * D + c0;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = frag_col(nt, e);
      if (c < wid) dst[size_t(row0 + frag_row(e)) * D + c] = acc[nt][e];
    }
}

// --- #19: a cp.async ring of two stages ----------------------------------------

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t pack_i8(int8_t lo, int8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(float(lo), float(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf(__nv_bfloat16 lo,
                                            __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// acc[16 x 128] += A[16 x 128] · M[128 x 128] for the calling warp, with A
// this warp's strip of the raw int8 one-hot [r][kLdO] and M the raw
// message chunk, row-major [k][ld] (warp_gemm's fragments, gathered from
// the untransposed operands).
__device__ __forceinline__ void warp_gemm_raw(float (&acc)[kNT][4],
                                              const int8_t* A,
                                              const __nv_bfloat16* M) {
  constexpr int ld = Smem<__nv_bfloat16>::ld;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < kChunk; k0 += 16) {
    const int8_t* ap = A + g * kLdO + k0 + 2 * tq;
    const uint32_t a0 = pack_i8(ap[0], ap[1]);
    const uint32_t a1 = pack_i8(ap[8 * kLdO], ap[8 * kLdO + 1]);
    const uint32_t a2 = pack_i8(ap[8], ap[9]);
    const uint32_t a3 = pack_i8(ap[8 * kLdO + 8], ap[8 * kLdO + 9]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const __nv_bfloat16* bp = M + (k0 + 2 * tq) * ld + nt * 8 + g;
      const uint32_t b0 = pack_bf(bp[0], bp[ld]);
      const uint32_t b1 = pack_bf(bp[8 * ld], bp[9 * ld]);
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(acc[nt][0]), "+f"(acc[nt][1]), "+f"(acc[nt][2]),
            "+f"(acc[nt][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
}

__device__ __forceinline__ void warp_gemm_raw(float (&acc)[kNT][4],
                                              const int8_t* A,
                                              const float* M) {
  constexpr int ld = Smem<float>::ld;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll 2
  for (int k = 0; k < kChunk; ++k) {
    const float lo = float(A[g * kLdO + k]), hi = float(A[(g + 8) * kLdO + k]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float2 b = *reinterpret_cast<const float2*>(M + k * ld + nt * 8 +
                                                        2 * tq);
      acc[nt][0] = fmaf(lo, b.x, acc[nt][0]);
      acc[nt][1] = fmaf(lo, b.y, acc[nt][1]);
      acc[nt][2] = fmaf(hi, b.x, acc[nt][2]);
      acc[nt][3] = fmaf(hi, b.y, acc[nt][3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) onehot_loopT_kernel(
    const T* __restrict__ msgs, int D, const int8_t* __restrict__ onehot,
    int n_tiles, int tile_e, const int* __restrict__ tile_start,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  constexpr int V = 16 / sizeof(T);  // message elements per 16-byte copy
  constexpr int kVecO = kChunk / 16, kVecM = kD / V;
  int8_t* O_s = reinterpret_cast<int8_t*>(smem);  // [2][128][kLdO]
  T* M_s = reinterpret_cast<T*>(smem + 2 * kRows * kLdO);  // [2][128][ld]
  const int c0 = blockIdx.y * kD, wid = min(kD, D - c0);
  const int row0 = (threadIdx.x >> 5) * 16;
  const bool vec_o = tile_e % 16 == 0, vec_m = D % V == 0;
  long long e_begin, e_end;
  block_edges(tile_start, n_tiles, tile_e, e_begin, e_end);
  const int n_chunks = int((e_end - e_begin + kChunk - 1) / kChunk);

  // stage s ← chunk q: cp.async where a 16-byte copy is whole and aligned,
  // plain stores elsewhere (the ragged tail, padding, unaligned streams)
  auto fill = [&](int s, int q) {
    const long long e0 = e_begin + (long long)q * kChunk;
    const int nk = int(min((long long)kChunk, e_end - e0));
    const long long i0 = e0 / tile_e;
    const int j0 = int(e0 - i0 * tile_e);
    int8_t* O = O_s + s * kRows * kLdO;
    for (int v = threadIdx.x; v < kRows * kVecO; v += kThreads) {
      const int r = v / kVecO, k = (v % kVecO) * 16;
      int8_t* d = O + r * kLdO + k;
      if (vec_o && k + 16 <= nk) {
        const int j = j0 + k;
        const long long i = i0 + j / tile_e;
        cp_async16(d, onehot + (i * kRows + r) * tile_e + j % tile_e);
      } else {
        for (int u = 0; u < 16; ++u)
          d[u] = k + u < nk ? onehot_at(onehot, tile_e, i0, j0, k + u, r) : 0;
      }
    }
    T* M = M_s + s * kChunk * ld;
    for (int v = threadIdx.x; v < kChunk * kVecM; v += kThreads) {
      const int k = v / kVecM, n = (v % kVecM) * V;
      T* d = M + k * ld + n;
      const T* src = msgs + size_t(e0 + k) * D + c0 + n;
      if (vec_m && k < nk && n + V <= wid) {
        cp_async16(d, src);
      } else {
        for (int u = 0; u < V; ++u)
          d[u] = (k < nk && n + u < wid) ? src[u] : from_f<T>(0.0f);
      }
    }
  };

  float acc[kNT][4];
  zero_acc(acc);
  if (n_chunks > 0) fill(0, 0);
  cp_async_commit();
  for (int q = 0; q < n_chunks; ++q) {
    // the stage of chunk q + 1 was last read in iteration q − 1, which
    // ended with a barrier
    if (q + 1 < n_chunks) fill((q + 1) & 1, q + 1);
    cp_async_commit();
    cp_async_wait_prev();  // chunk q's copies have landed (this thread's)
    __syncthreads();       // ... and every thread's, and its plain stores
    const int s = q & 1;
    warp_gemm_raw(acc, O_s + s * kRows * kLdO + row0 * kLdO,
                  M_s + s * kChunk * ld);
    __syncthreads();  // every warp is done with stage s
  }
  store_out(acc, out, D, c0, wid);
}

template <typename T>
int launch_onehot_loopT(const void* msgs, long long n_msgs, int D,
                         const void* onehot, int n_tiles, int tile_e,
                         const void* tile_start, int n_blocks, void* out,
                         cudaStream_t stream) {
  if (D < 1 || tile_e < 1 || n_msgs < (long long)n_tiles * tile_e)
    return int(cudaErrorInvalidValue);
  auto kernel = onehot_loopT_kernel<T>;
  const size_t smem = 2 * (size_t(kRows) * kLdO + Smem<T>::tile);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_blocks, (D + kD - 1) / kD);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(msgs), D, static_cast<const int8_t*>(onehot),
      n_tiles, tile_e, static_cast<const int*>(tile_start),
      static_cast<float*>(out));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// #19 onehot_segment_scatter_loopT (and #18's other forms).  dtype: 0 =
// float32, 1 = bfloat16 (the messages).  msgs [n_msgs ≥ n_tiles·tile_e,
// D]; onehot int8 [n_tiles·128, tile_e]; tile_start int32 [n_blocks + 1]
// (clamped to [0, n_tiles]); out f32 [n_blocks·128, D], every row written.
// Returns the cudaError_t of the launch.
extern "C" int ggnn_onehot_loopT(int dtype, const void* msgs, long long n_msgs,
                                 int D, const void* onehot, int n_tiles,
                                 int tile_e, const void* tile_start,
                                 int n_blocks, void* out, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return ggnn::launch_onehot_loopT<__nv_bfloat16>(
        msgs, n_msgs, D, onehot, n_tiles, tile_e, tile_start, n_blocks, out,
        s);
  if (dtype == 0)
    return ggnn::launch_onehot_loopT<float>(msgs, n_msgs, D, onehot, n_tiles,
                                            tile_e, tile_start, n_blocks, out,
                                            s);
  return int(cudaErrorInvalidValue);
}
