// Shared device code of the GGNN kernels for Hopper (sm_90a).
//
// Every kernel here works on one 128-row block of node states per CTA, with
// 8 warps: warp w owns rows [16w, 16w + 16) and all D = 128 columns, so a
// row strip of a shared-memory A operand is private to its warp and only the
// weight tile is shared.  The accumulator of a [16, 128] strip lives in
// registers in the m16n8k16 C-fragment layout (16 n-tiles x 4 floats).
//
// Matrix products:
// - bf16 operands go through mma.sync.m16n8k16 (bf16 in, f32 accumulate);
// - f32 operands go through FMA loops that fill the same fragment layout, so
//   an f32 model keeps full f32 products (no TF32) and shares the epilogues.
//
// Weights are copied into shared memory TRANSPOSED (Bt[n][k]), so a
// B fragment is one 32-bit load; rows are padded by 8 elements to spread a
// fragment load over all 32 banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ggnn {

constexpr int kRows = 128;           // rows per CTA (one dst block)
constexpr int kD = 128;              // state width the kernels take
constexpr int kNT = kD / 8;          // 8-column n-tiles per warp strip
constexpr int kThreads = 256;        // 8 warps x 16 rows
constexpr int kPad = 8;              // row padding of smem operands

template <typename T>
struct Smem {
  static constexpr int ld = kD + kPad;                        // elements
  static constexpr size_t tile = size_t(kRows) * ld * sizeof(T);  // [128][ld]
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch/XLA
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Bt[n][k] = W[k][col0 + n] for n, k in [0, 128): one [D, D] weight tile,
// transposed into shared memory.  W is row-major with row length ldw.
template <typename T>
__device__ __forceinline__ void load_wt(T* Bt, const T* __restrict__ W,
                                        int ldw, int col0) {
  constexpr int ld = Smem<T>::ld;
  for (int idx = threadIdx.x; idx < kD * kD; idx += kThreads) {
    const int k = idx / kD, n = idx % kD;
    Bt[n * ld + k] = W[size_t(k) * ldw + col0 + n];
  }
}

// Bt[n][k] = W[n][col0 + k] for n, k in [0, 128): the tile for a product
// with the TRANSPOSE of W[:, col0 : col0 + 128] (the backward's x·Wᵀ).
template <typename T>
__device__ __forceinline__ void load_w_rows(T* Bt, const T* __restrict__ W,
                                            int ldw, int col0) {
  constexpr int ld = Smem<T>::ld;
  for (int idx = threadIdx.x; idx < kD * kD; idx += kThreads) {
    const int n = idx / kD, k = idx % kD;
    Bt[n * ld + k] = W[size_t(n) * ldw + col0 + k];
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[kNT][4]) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
}

// acc[16 x 128] += A[16 x 128] @ B[128 x 128] for the calling warp.
// A: this warp's 16-row strip of a [128][ld] smem operand; Bt: transposed B.
__device__ __forceinline__ void warp_gemm(float (&acc)[kNT][4],
                                          const __nv_bfloat16* A,
                                          const __nv_bfloat16* Bt) {
  constexpr int ld = Smem<__nv_bfloat16>::ld;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < kD; k0 += 16) {
    const __nv_bfloat16* ap = A + g * ld + k0 + 2 * tq;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * ld);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 8);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ap + 8 * ld + 8);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const __nv_bfloat16* bp = Bt + (nt * 8 + g) * ld + k0 + 2 * tq;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
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

__device__ __forceinline__ void warp_gemm(float (&acc)[kNT][4], const float* A,
                                          const float* Bt) {
  constexpr int ld = Smem<float>::ld;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll 2
  for (int k = 0; k < kD; ++k) {
    const float lo = A[g * ld + k], hi = A[(g + 8) * ld + k];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float b0 = Bt[(nt * 8 + 2 * tq) * ld + k];
      const float b1 = Bt[(nt * 8 + 2 * tq + 1) * ld + k];
      acc[nt][0] = fmaf(lo, b0, acc[nt][0]);
      acc[nt][1] = fmaf(lo, b1, acc[nt][1]);
      acc[nt][2] = fmaf(hi, b0, acc[nt][2]);
      acc[nt][3] = fmaf(hi, b1, acc[nt][3]);
    }
  }
}

// Fragment element (nt, e) of the calling thread sits at strip row
// frag_row(e) and column frag_col(nt, e).
__device__ __forceinline__ int frag_row(int e) {
  return ((threadIdx.x & 31) >> 2) + ((e >> 1) << 3);
}
__device__ __forceinline__ int frag_col(int nt, int e) {
  return nt * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

// GRU cell on the CTA's 128 rows (the epilogue of the fused typed-block step
// and the body of the GRU cell kernel):
//   z = σ(a·W_z + h·U_z + b_z),  r = σ(a·W_r + h·U_r + b_r),
//   h̃ = tanh(a·W_h + (r⊙h)·U_h + b_h),  h' = (1 − z)⊙h + z⊙h̃,
// with matmul inputs in T and f32 accumulation and gates.
//   A_s: a rounded to T, [128][ld] smem;  H_s: h rounded to T, [128][ld] smem
//   (overwritten with r⊙h);  W_s: a [128][ld] smem weight tile;
//   hrow: the f32 state rows [128, D];  wa [D, 3D], uzr [D, 2D], uh [D, D]
//   in T;  b3 [3D] f32.  Writes h' (f32) and, if EMIT, z, r, h̃ in T.
template <typename T, bool EMIT>
__device__ void gru_block(const T* A_s, T* H_s, T* W_s,
                          const float* __restrict__ hrow,
                          const T* __restrict__ wa, const float* __restrict__ b3,
                          const T* __restrict__ uzr, const T* __restrict__ uh,
                          float* __restrict__ out_h, T* __restrict__ out_z,
                          T* __restrict__ out_r, T* __restrict__ out_ht) {
  constexpr int ld = Smem<T>::ld;
  const int row0 = (threadIdx.x >> 5) * 16;
  const T* a_strip = A_s + row0 * ld;
  T* h_strip = H_s + row0 * ld;
  float zacc[kNT][4], racc[kNT][4];
  zero_acc(zacc);
  zero_acc(racc);

  __syncthreads();
  load_wt(W_s, wa, 3 * kD, 0);
  __syncthreads();
  warp_gemm(zacc, a_strip, W_s);
  __syncthreads();
  load_wt(W_s, uzr, 2 * kD, 0);
  __syncthreads();
  warp_gemm(zacc, h_strip, W_s);
  __syncthreads();
  load_wt(W_s, wa, 3 * kD, kD);
  __syncthreads();
  warp_gemm(racc, a_strip, W_s);
  __syncthreads();
  load_wt(W_s, uzr, 2 * kD, kD);
  __syncthreads();
  warp_gemm(racc, h_strip, W_s);
  __syncwarp();

  // gates; r⊙h replaces this warp's own strip of H_s (no other warp reads it)
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + frag_row(e), c = frag_col(nt, e);
      const float z = sigmoid_f(zacc[nt][e] + b3[c]);
      const float rg = sigmoid_f(racc[nt][e] + b3[kD + c]);
      const float hv = hrow[r * kD + c];
      zacc[nt][e] = z;
      H_s[r * ld + c] = from_f<T>(rg * hv);
      if (EMIT) {
        out_z[r * kD + c] = from_f<T>(z);
        out_r[r * kD + c] = from_f<T>(rg);
      }
    }
  }
  zero_acc(racc);
  __syncthreads();
  load_wt(W_s, wa, 3 * kD, 2 * kD);
  __syncthreads();
  warp_gemm(racc, a_strip, W_s);
  __syncthreads();
  load_wt(W_s, uh, kD, 0);
  __syncthreads();
  warp_gemm(racc, h_strip, W_s);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + frag_row(e), c = frag_col(nt, e);
      const float ht = tanhf(racc[nt][e] + b3[2 * kD + c]);
      const float hv = hrow[r * kD + c];
      const float z = zacc[nt][e];
      out_h[r * kD + c] = (1.0f - z) * hv + z * ht;
      if (EMIT) out_ht[r * kD + c] = from_f<T>(ht);
    }
  }
}

// Copies 128 rows of a row-major [*, D] f32 array into a [128][ld] smem
// operand, rounded to T.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const float* __restrict__ src) {
  constexpr int ld = Smem<T>::ld;
  for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads) {
    const int r = idx / kD, c = idx % kD;
    dst[r * ld + c] = from_f<T>(src[idx]);
  }
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

// The rows of a tile (a slot) that one pass of segment_sum_ordered stages
// in shared memory (16 KB for f32, 32 KB for bf16).
template <typename T>
struct Stage {
  static constexpr int rows = sizeof(T) == 2 ? 128 : 32;
  static constexpr size_t bytes = size_t(rows) * kD * sizeof(T);
};

// S[d][:] += run for the calling warp's lane (features 4l..4l+3).
__device__ __forceinline__ void add_run(float* S, int d, const float (&run)[4]) {
  float4* p = reinterpret_cast<float4*>(S + d * kD) + (threadIdx.x & 31);
  float4 s = *p;
  s.x += run[0];
  s.y += run[1];
  s.z += run[2];
  s.w += run[3];
  *p = s;
}

// The one-hot product of every scatter kernel (the TPU kernels' one-hot MXU
// product is a segment sum here), in a fixed order and without atomics:
// S[d][:] += h_pack[base + j] for j = 0 .. tile_e − 1 in turn, for each j
// whose dst id d = drow[j] lies in [0, 128) and whose pack row lies in
// [0, n_pack).  S is [128][kD] f32, row-major.  The CTA stages
// Stage<T>::rows rows of the tile at a time in H_s (16-byte loads); warp w
// then adds the staged rows bound for its own dst rows [16w, 16w + 16),
// lane l features 4l..4l+3, so every element of S has one writer and sees
// its terms in the order of j: the same sums on every run.  A run of rows
// with one dst id is summed in registers and added to S once.  Warp w's
// strip of S is its own: the caller zeroes it and reads it back with no
// CTA barrier.  A hub row's tile (all rows to one dst) falls to one warp;
// its rows come from shared memory, 8 loads in flight, so that warp waits
// on no global load.
template <typename T>
__device__ void segment_sum_ordered(float* S, T* H_s,
                                    const T* __restrict__ h_pack,
                                    long long n_pack, long long base,
                                    const int* __restrict__ drow,
                                    int tile_e) {
  constexpr int R = Stage<T>::rows;
  constexpr int VPR = kD * sizeof(T) / 16;  // 16-byte vectors per row
  constexpr int PER = R * VPR / kThreads;   // vectors per thread per pass
  static_assert(R * VPR % kThreads == 0, "a pass is whole vectors/thread");
  const int lane = threadIdx.x & 31, lo = (threadIdx.x >> 5) * 16;
  int cur = -1;
  float run[4] = {0.f, 0.f, 0.f, 0.f};
  // the next pass's rows are loaded into registers while the warps scan
  // the current one, all PER loads of a thread in flight at once
  uint4 x[PER];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / VPR;
      const long long row = base + j0 + r;
      x[i] = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + r < tile_e && row >= 0 && row < n_pack)
        x[i] = reinterpret_cast<const uint4*>(h_pack + row * kD)[idx % VPR];
    }
  };
  fetch(0);
  for (int j0 = 0; j0 < tile_e; j0 += R) {
    const int n = min(R, tile_e - j0);
    __syncthreads();  // every warp is done with the previous rows of H_s
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      reinterpret_cast<uint4*>(H_s + (idx / VPR) * kD)[idx % VPR] = x[i];
    }
    __syncthreads();
    if (j0 + R < tile_e) fetch(j0 + R);
    for (int q0 = 0; q0 < n; q0 += 32) {
      int d = -1;
      if (q0 + lane < n) {
        const long long row = base + j0 + q0 + lane;
        if (row >= 0 && row < n_pack) d = drow[j0 + q0 + lane];
      }
      unsigned mine = __ballot_sync(0xffffffffu, d >= lo && d < lo + 16);
      while (mine) {  // this warp's rows, in the order of j, U in flight
        constexpr int U = 8;
        int dq[U];
        float v[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = mine ? __ffs(mine) - 1 : -1;
          mine &= mine - 1;
          dq[u] = __shfl_sync(0xffffffffu, d, q < 0 ? 0 : q);
          if (q < 0) dq[u] = -1;
          else load4(H_s + (q0 + q) * kD + 4 * lane, v[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (dq[u] < 0) break;
          if (dq[u] != cur) {
            if (cur >= 0) add_run(S, cur, run);
            cur = dq[u];
#pragma unroll
            for (int i = 0; i < 4; ++i) run[i] = 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) run[i] += v[u][i];
        }
      }
    }
  }
  if (cur >= 0) add_run(S, cur, run);
}

// The calling warp's 16-row strip of the f32 sums S [128][kD], rounded to T
// into its strip of the [128][ld] operand A_s (the per-slot or per-tile
// rounding point of the scatter kernels).
template <typename T>
__device__ __forceinline__ void round_strip(T* A_s, const float* S) {
  constexpr int ld = Smem<T>::ld;
  const int row0 = (threadIdx.x >> 5) * 16;
  __syncwarp();
  for (int idx = threadIdx.x & 31; idx < 16 * kD; idx += 32)
    A_s[(row0 + idx / kD) * ld + idx % kD] = from_f<T>(S[row0 * kD + idx]);
  __syncwarp();
}

// Zeroes the calling warp's 16-row strip of a [128][kD] f32 buffer.
__device__ __forceinline__ void zero_strip(float* S) {
  float4* p = reinterpret_cast<float4*>(S + (threadIdx.x >> 5) * 16 * kD);
  for (int i = threadIdx.x & 31; i < 16 * kD / 4; i += 32)
    p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The hub split of the per-tile kernels (typed_tile.cu, window_mono.cu).
// Each output block's tile list [tile_start[b], tile_start[b + 1]) is cut
// into work items of at most kSplit tiles, one CTA per item, so a hub block
// that holds a third of all tiles spreads over the whole card instead of
// one SM.  item_first[b] .. item_first[b + 1] are block b's items (at least
// one, also for an empty block).  A block with one item writes its rows
// itself; a block with more writes one f32 partial per item to a workspace
// slot (pbase[b] + k for its item k), and a second kernel sums them in item
// order.  With segment_sum_ordered inside the items, no float atomics
// anywhere: the same result on every run.
constexpr int kSplit = 32;

// The block of work item `item` (the largest b with item_first[b] <= item),
// found by thread 0 and broadcast; every thread of the CTA must call it.
__device__ __forceinline__ int item_block(const int* __restrict__ item_first,
                                          int n_blocks, int item) {
  __shared__ int blk;
  if (threadIdx.x == 0) {
    int lo = 0, hi = n_blocks - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (item_first[mid] <= item) lo = mid; else hi = mid - 1;
    }
    blk = lo;
  }
  __syncthreads();
  const int b = blk;
  __syncthreads();
  return b;
}

// A [128, D] f32 partial in fragment order: element (nt, e) of thread tid at
// slot[(nt·kThreads + tid)·4 + e], so a CTA's stores and loads are float4s
// on consecutive addresses.
constexpr int kSlot = kRows * kD;  // floats per workspace slot

__device__ __forceinline__ void store_frag(float* __restrict__ slot,
                                           const float (&acc)[kNT][4]) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
    reinterpret_cast<float4*>(slot)[nt * kThreads + threadIdx.x] =
        make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
}

__device__ __forceinline__ void add_frag(float (&acc)[kNT][4],
                                         const float* __restrict__ slot) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const float4 v = reinterpret_cast<const float4*>(slot)[nt * kThreads +
                                                           threadIdx.x];
    acc[nt][0] += v.x;
    acc[nt][1] += v.y;
    acc[nt][2] += v.z;
    acc[nt][3] += v.w;
  }
}

}  // namespace ggnn
