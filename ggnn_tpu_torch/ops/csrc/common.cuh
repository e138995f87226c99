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

// S[d][:] += h_pack[base + j] for every column j of the slot with dst id
// d = drow[j] >= 0.  Lane l carries features 4l..4l+3, kept at S columns
// i·32 + l (i = 0..3) so each of the four atomics of a warp is bank-free.
template <typename T>
__device__ __forceinline__ void segment_sum(float* S,
                                            const T* __restrict__ h_pack,
                                            long long n_pack, long long base,
                                            const int* __restrict__ drow,
                                            int tile_e) {
  constexpr int U = 16;  // rows in flight per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j0 = warp * 32; j0 < tile_e; j0 += kThreads) {
    const int j = j0 + lane;
    int d = -1;
    if (j < tile_e) {
      d = drow[j];
      const long long row = base + j;
      if (unsigned(d) >= unsigned(kRows) || row < 0 || row >= n_pack) d = -1;
    }
#pragma unroll
    for (int q0 = 0; q0 < 32; q0 += U) {
      int dq[U];
      float v[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        dq[u] = __shfl_sync(0xffffffffu, d, q0 + u);
        if (dq[u] >= 0)
          load4(h_pack + (base + j0 + q0 + u) * kD + 4 * lane, v[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (dq[u] >= 0) {
          float* p = S + dq[u] * kD + lane;
          atomicAdd(p, v[u][0]);
          atomicAdd(p + 32, v[u][1]);
          atomicAdd(p + 64, v[u][2]);
          atomicAdd(p + 96, v[u][3]);
        }
      }
    }
  }
}

}  // namespace ggnn
