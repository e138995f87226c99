// Pieces of the window kernels #13 (window_step_fused.cuh) and #14
// (window_bwd_fused.cu) for Hopper (sm_90a), on top of mma_pipe.cuh.
//
// Both kernels multiply int8 count chunks as they lie in memory:
// - #13 takes a count chunk [128 rows][128 k] as the A operand of a bf16
//   product with a window chunk [128 k][128 n].  ldmatrix on the int8 rows
//   gives a lane 4 consecutive k of its row (the int8 A fragment); they
//   become two bf16x2 registers by integer operations (s8x4_to_bf16),
//   holding k (4q, 4q + 2) and (4q + 1, 4q + 3).  The bf16 product reads
//   that as its k order, so the B chunk is stored with its rows permuted to
//   match (perm_bf16: within 16 rows, the even rows first): a B row is then
//   still read by ldmatrix.trans as it lies, and no element is converted
//   one by one or transposed by scalar stores.
// - #13's q8 source and #14's int8 form multiply two int8 operands
//   (mma.m16n8k32): B = a table or count chunk [128 k][128 n] int8 as it
//   lies, read by ldmatrix.trans on b16 pairs with its rows permuted
//   (perm_s8) so that two byte permutes (prmt) give a lane its 4
//   consecutive k of one column.  A lane then holds the columns 2j and
//   2j + 1 of a 16-column group: the n8-tiles of the accumulator are the
//   group's even and odd columns (pair_col), undone where the sums are
//   written out.
// - #14's exact form takes the count chunk as B of a bf16 product: the
//   same ldmatrix.trans gives a lane (k 2q, 2q + 1) × (n 2j, 2j + 1); one
//   conversion gives the even column's pair, one the odd's (pair_col).
// The clusters of both kernels share a chunk between their CTAs through
// distributed shared memory: each CTA stores its part into the others'
// buffers (st_cluster, push_rows) and a cluster barrier publishes it.
#pragma once

#include "mma_pipe.cuh"

namespace ggnn {
namespace wpipe {

using pipe::bf16;
using pipe::kLd;      // bf16 rows of 128 + 8 elements
using pipe::kThreads;
constexpr int kLd8 = 144;  // int8 rows of 128 + 16 bytes
constexpr size_t kChunk8 = size_t(128) * kLd8;  // 18,432 B

// cp.async of 16 bytes, or zeros when !valid (src-size 0: nothing read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   pipe::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// Two bf16x2 from 4 int8: (byte 0, byte 2) and (byte 1, byte 3), each
// exact: 0x43xx holds 128 + (b & 127), and 128 + 128·sign is subtracted.
__device__ __forceinline__ uint32_t s8pair_to_bf16(uint32_t w) {
  const uint32_t m = (w & 0x007f007fu) | 0x43004300u;
  const uint32_t s = (w & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                                   *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ void s8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  lo = s8pair_to_bf16(w);
  hi = s8pair_to_bf16(w >> 8);
}

// Storage row of chunk row k for the two B layouts above (k in [0, 128)).
__device__ __forceinline__ int perm_bf16(int k) {
  return (k & ~15) | ((k & 1) << 3) | ((k & 15) >> 1);
}
__device__ __forceinline__ int perm_s8(int k) {
  // k = 16·h + 4a + 2b + c → 16·h + 8b + 2a + c
  return (k & ~15) | ((k & 2) << 2) | ((k & 12) >> 1) | (k & 1);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --- clusters -------------------------------------------------------------

// Every thread of every CTA of the cluster: a barrier with release /
// acquire, so the shared memory written before it is seen after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The cluster address of local shared address p in CTA `rank`.
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(pipe::smem_addr(p)), "r"(rank));
  return a;
}
// A 16-byte store to a cluster address (another CTA's shared memory): it
// does not wait, and the next cluster barrier publishes it.
__device__ __forceinline__ void st_cluster(uint32_t a, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Copies bytes [col0, col0 + ncols) of rows [row0, row0 + nrows) of a
// buffer of rows ld_bytes apart (all multiples of 16) to the same place in
// the other CTAs of the cluster, 16 bytes a store.
__device__ __forceinline__ void push_block(const unsigned char* buf,
                                           int ld_bytes, int row0, int nrows,
                                           int col0, int ncols, int cs,
                                           int rank) {
  const int vec = ncols / 16;
  for (int idx = threadIdx.x; idx < nrows * vec; idx += kThreads) {
    const unsigned char* p =
        buf + (row0 + idx / vec) * ld_bytes + col0 + (idx % vec) * 16;
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    for (int r = 0; r < cs; ++r)
      if (r != rank) st_cluster(map_rank(p, r), v);
  }
}

// --- warp tiles ---------------------------------------------------------
// 8 warps tile a 128-row output as 4 × 2 warp tiles of 32 rows × 8·NI
// columns; fragment element (mi, ni, e) at row(mi, e), col(ni, e).  With
// PAIR the n8-tiles are the even and odd columns of 16-column groups
// (pair_col), as the int8 B fragments above give them.
template <int NI, bool PAIR = false>
struct Tile {
  static_assert(!PAIR || NI % 2 == 0, "pairs of n8-tiles");
  __device__ __forceinline__ static int row0() {
    return (threadIdx.x >> 5 & 3) * 32;
  }
  __device__ __forceinline__ static int col0() {
    return (threadIdx.x >> 7) * NI * 8;
  }
  __device__ __forceinline__ static int row(int mi, int e) {
    return row0() + mi * 16 + ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
  }
  __device__ __forceinline__ static int col(int ni, int e) {
    const int q = threadIdx.x & 3;
    if (PAIR)
      return col0() + (ni >> 1) * 16 + 4 * q + 2 * (e & 1) + (ni & 1);
    return col0() + ni * 8 + 2 * q + (e & 1);
  }
};

template <int NI, typename V>
__device__ __forceinline__ void zero(V (&acc)[2][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = V(0);
}

// acc += A[128 × 128] · B[128 × 8·2·NI] on the warp's tile: A bf16
// row-major [128][lda], B bf16 k-major [128][ldb] (as it lies: ldmatrix.
// trans), both in shared memory.
template <int NI>
__device__ __forceinline__ void mma_bf16(float (&acc)[2][NI][4],
                                         const bf16* A, int lda,
                                         const bf16* B, int ldb) {
  static_assert(NI % 2 == 0, "ldmatrix.x4 gives two n8-tiles");
  const int lane = threadIdx.x & 31;
  const bf16* a_base =
      A + (Tile<NI>::row0() + (lane & 15)) * lda + (lane >> 4) * 8;
  const bf16* b_base = B + (lane & 15) * ldb + Tile<NI>::col0() +
                       (lane >> 4) * 8;
#pragma unroll
  for (int k0 = 0; k0 < 128; k0 += 16) {
    uint32_t a[2][4];
    pipe::ldsm_x4(a[0], a_base + k0);
    pipe::ldsm_x4(a[1], a_base + 16 * lda + k0);
#pragma unroll
    for (int nj = 0; nj < NI / 2; ++nj) {
      uint32_t b[4];
      pipe::ldsm_x4_trans(b, b_base + k0 * ldb + nj * 16);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        pipe::mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
        pipe::mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// The int8 A fragments of a k32 step for the warp's two m16-tiles, from a
// [128][kLd8] int8 buffer: a[mi] = (row g, k 4q..), (row g + 8, k 4q..),
// (row g, k 16 + 4q..), (row g + 8, k 16 + 4q..).
__device__ __forceinline__ void ldsm_a8(uint32_t (&a)[2][4],
                                        const unsigned char* A, int k32) {
  const int lane = threadIdx.x & 31;
  const unsigned char* p =
      A + (Tile<8>::row0() + (lane & 15)) * kLd8 + k32 * 32 + (lane >> 4) * 16;
  pipe::ldsm_x4(a[0], reinterpret_cast<const bf16*>(p));
  pipe::ldsm_x4(a[1], reinterpret_cast<const bf16*>(p + 16 * kLd8));
}

// #13: acc += C[128 × 128] (int8 counts, [128][kLd8]) · B (bf16, rows
// stored at perm_bf16, [128][kLd]) on the warp's 32 × 64 tile.
__device__ __forceinline__ void mma_counts_bf16(float (&acc)[2][8][4],
                                                const unsigned char* C,
                                                const bf16* B) {
  const int lane = threadIdx.x & 31;
  const bf16* b_base = B + (lane & 15) * kLd + Tile<8>::col0() +
                       (lane >> 4) * 8;
#pragma unroll
  for (int k32 = 0; k32 < 4; ++k32) {
    uint32_t w[2][4];
    ldsm_a8(w, C, k32);
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        s8x4_to_bf16(w[mi][2 * st], a[mi][0], a[mi][2]);
        s8x4_to_bf16(w[mi][2 * st + 1], a[mi][1], a[mi][3]);
      }
      const int k0 = k32 * 32 + st * 16;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        pipe::ldsm_x4_trans(b, b_base + k0 * kLd + nj * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          pipe::mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          pipe::mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
}

// #13 q8 and #14 int8: acc += A (int8 [128][kLd8]) · B (int8 [128 k][kLd8]
// with rows at perm_s8), exact in int32, on the warp's 32 × 64 tile in the
// PAIR layout.
__device__ __forceinline__ void mma_s8_s8(int (&acc)[2][8][4],
                                          const unsigned char* A,
                                          const unsigned char* B) {
  const int lane = threadIdx.x & 31;
  const unsigned char* b_base = B + lane * kLd8 + Tile<8>::col0();
#pragma unroll
  for (int k32 = 0; k32 < 4; ++k32) {
    uint32_t a[2][4];
    ldsm_a8(a, A, k32);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t r[4];
      pipe::ldsm_x4_trans(r, reinterpret_cast<const bf16*>(
                                 b_base + k32 * 32 * kLd8 + g * 16));
      const uint32_t b0e = __byte_perm(r[0], r[1], 0x6420);
      const uint32_t b0o = __byte_perm(r[0], r[1], 0x7531);
      const uint32_t b1e = __byte_perm(r[2], r[3], 0x6420);
      const uint32_t b1o = __byte_perm(r[2], r[3], 0x7531);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_s8(acc[mi][2 * g], a[mi], b0e, b1e);
        mma_s8(acc[mi][2 * g + 1], a[mi], b0o, b1o);
      }
    }
  }
}

// #14 exact: acc += A (bf16 [128][kLd]) · C (int8 counts [128 k][kLd8] as
// they lie, converted in the fragments) on the warp's 32 × 64 tile in the
// PAIR layout.
__device__ __forceinline__ void mma_bf16_counts(float (&acc)[2][8][4],
                                                const bf16* A,
                                                const unsigned char* C) {
  const int lane = threadIdx.x & 31;
  const bf16* a_base =
      A + (Tile<8>::row0() + (lane & 15)) * kLd + (lane >> 4) * 8;
  const unsigned char* c_base =
      C + (lane & 15) * kLd8 + Tile<8>::col0() + (lane >> 4) * 16;
#pragma unroll 2
  for (int k0 = 0; k0 < 128; k0 += 16) {
    uint32_t a[2][4];
    pipe::ldsm_x4(a[0], a_base + k0);
    pipe::ldsm_x4(a[1], a_base + 16 * kLd + k0);
#pragma unroll
    for (int g = 0; g < 4; g += 2) {
      uint32_t r[4];
      pipe::ldsm_x4_trans(
          r, reinterpret_cast<const bf16*>(c_base + k0 * kLd8 + g * 16));
      // r[0], r[1]: group g, k rows 0-7 and 8-15; r[2], r[3]: group g + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b0e, b0o, b1e, b1o;
        s8x4_to_bf16(r[2 * h], b0e, b0o);
        s8x4_to_bf16(r[2 * h + 1], b1e, b1o);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          pipe::mma_bf16(acc[mi][2 * (g + h)], a[mi], b0e, b1e);
          pipe::mma_bf16(acc[mi][2 * (g + h) + 1], a[mi], b0o, b1o);
        }
      }
    }
  }
}

}  // namespace wpipe
}  // namespace ggnn
