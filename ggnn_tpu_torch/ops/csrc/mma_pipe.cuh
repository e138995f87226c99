// Pipelined bf16 products for Hopper (sm_90a): the pieces the persistent
// kernels #10 (node_table.cu) and #16 (packed_messages.cu) share.
//
// Both kernels multiply 128-row operands by 128 × 128 weight panels, one
// 128-deep K-chunk at a time.  One operand stays resident in shared memory
// across many products and is staged again only where its key changes (#16:
// W_t's panel across a run of equal tile_type; #10: a source block's rows
// across its T2 types); the other streams through a ring of two stages, so
// that the next chunk's copies are in flight while the current one is
// multiplied.  Every copy is a 16-byte cp.async.cg where the row is whole
// 16-byte vectors; else element by element (synchronous, visible after the
// next barrier).  K and N tails are zero in shared memory.
//
// The product is mma.sync.m16n8k16 (bf16 in, f32 accumulate) with both
// operands read by ldmatrix: A row-major [128][kLd] through ldmatrix.x4, B
// as it lies in memory, k-major [128 k][kLd n], through ldmatrix.x4.trans,
// so no weight is transposed by scalar stores.  8 warps tile the CTA's
// 128 × 128 output as 4 × 2 warp tiles of 32 rows × 64 columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ggnn {
namespace pipe {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;              // 8 warps
constexpr int kRows = 128;                 // rows of an operand chunk
constexpr int kCols = 128;                 // K-chunk depth and N-panel width
constexpr int kLd = kCols + 8;             // smem row length (elements)
constexpr size_t kChunk = size_t(kRows) * kLd * sizeof(bf16);  // 34,816 B
constexpr int kVec = 8;                    // bf16 per 16-byte vector

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits for every group this thread committed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stages one [128][kLd] chunk: row r = row(r)[col0 .. col0 + 128), a null
// row pointer, or a column at or past `limit`, reads 0.  `vec`: every
// row's start and col0 are 16-byte aligned and (limit − col0) ≥ 128 or a
// multiple of 8, so whole vectors are copied with cp.async.
template <typename RowFn>
__device__ __forceinline__ void stage_chunk(bf16* dst, RowFn row, int col0,
                                            int limit, bool vec) {
  const int wid = min(kCols, limit - col0);
  if (vec) {
    for (int idx = threadIdx.x; idx < kRows * (kCols / kVec);
         idx += kThreads) {
      const int r = idx / (kCols / kVec), v = idx % (kCols / kVec);
      bf16* d = dst + r * kLd + v * kVec;
      const bf16* p = row(r);
      if (p != nullptr && v * kVec < wid)
        cp_async16(d, p + col0 + v * kVec);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * kCols; idx += kThreads) {
      const int r = idx / kCols, c = idx % kCols;
      const bf16* p = row(r);
      dst[r * kLd + c] =
          (p != nullptr && c < wid) ? p[col0 + c] : __float2bfloat16_rn(0.f);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The calling warp's 32 × 64 tile of the CTA's 128 × 128 output.
struct WarpTile {
  float acc[2][8][4];  // [16-row m-tile][8-column n-tile][C fragment]

  __device__ __forceinline__ static int row0() {
    return (threadIdx.x >> 5 & 3) * 32;
  }
  __device__ __forceinline__ static int col0() {
    return (threadIdx.x >> 7) * 64;
  }
  // Fragment element (mi, ni, e) sits at row(mi, e), col(ni, e) of the
  // CTA's tile.
  __device__ __forceinline__ static int row(int mi, int e) {
    return row0() + mi * 16 + ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
  }
  __device__ __forceinline__ static int col(int ni, int e) {
    return col0() + ni * 8 + 2 * (threadIdx.x & 3) + (e & 1);
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
  }

  // acc += A[128 × 128 chunk] · B[128 × 128 chunk] on the warp's tile; A
  // row-major, B k-major, both [128][kLd] in shared memory.
  __device__ __forceinline__ void mma_chunk(const bf16* A, const bf16* B) {
    const int lane = threadIdx.x & 31;
    const bf16* a_base = A + (row0() + (lane & 15)) * kLd + (lane >> 4) * 8;
    const bf16* b_base = B + (lane & 15) * kLd + col0() + (lane >> 4) * 8;
#pragma unroll
    for (int k0 = 0; k0 < kCols; k0 += 16) {
      uint32_t a[2][4];
      ldsm_x4(a[0], a_base + k0);
      ldsm_x4(a[1], a_base + 16 * kLd + k0);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        ldsm_x4_trans(b, b_base + k0 * kLd + nj * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
};

// The streaming multiprocessors of the current device (132 on an H100 SXM):
// a persistent kernel launches about one CTA on each.
inline int multiprocessors() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n < 1)
    return 1;
  return n;
}

}  // namespace pipe
}  // namespace ggnn
