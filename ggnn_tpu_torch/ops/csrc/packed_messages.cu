// The pallas backend's per-tile messages for Hopper (sm_90a), kernel #16.
//
// Replaces _messages_kernel of ggnn_tpu/ops/spmm_pallas.py (run by
// packed_messages).  The packed layout cuts the type-sorted edges into tiles
// of tile_e slots, each of one message type t = tile_type[i]; slot j of
// tile i holds the edge (src_j, mask_j).  The kernel writes
//     out[j] = (h[src_j] · W_t + b_t) · mask_j        (f32, [P, D])
// with the products of the compute dtype's values accumulated in f32, the
// bias added in f32 and the mask multiplied last, the reference's rounding
// points.  The reference gathers h[src] with an XLA op into a [P, D] array
// before its kernel; here the rows are gathered by src straight into shared
// memory, so that array never exists.
//
// Bound on this card: HBM bytes.  At the uniform headline (8M directed
// edges in 62,516 tiles of 128, D = 128, bf16) one call writes 4.1 GB of f32
// messages and reads h (67 MB), src and mask (64 MB): ≈ 1.26 ms at 3.35
// TB/s, against 0.26 TFLOP of products (0.27 ms at the dense bf16 tensor
// rate).  The 2 GB of gathered rows come from L2 or HBM at random (h's
// 67 MB does not fit in the 50 MB L2).
//
// Design, bf16 (mma_pipe.cuh).  Persistent CTAs, about one per SM for each
// 128-column panel of the output: CTA x walks a contiguous range of 128-row
// chunks of tiles (a tile of tile_e > 128 slots is several chunks; one of
// fewer is one short chunk).  W_t's panel, as it lies in memory, and b_t
// stay in shared memory across a run of equal tile_type and are staged
// again only where the type changes (pack_type_tiles sorts the types, so a
// CTA sees one or two runs; any order is right, only slower).  The rows of
// the next chunk are gathered by src with 16-byte cp.async copies into the
// second stage of a two-stage ring while the current chunk is multiplied
// (mma.sync bf16 with ldmatrix, B through ldmatrix.trans); the src ids,
// masks and tile types are loaded a step earlier still, so no copy waits on
// its index.  The epilogue adds b_t in f32 and multiplies by the mask into
// a shared f32 stage of each warp's own 32 × 64 tile, and the warp stores
// it as 16-byte pieces of whole rows (two 256-byte row segments an
// instruction) with streaming (evict-first) stores: no CTA barrier stands
// between one chunk's product and the next, and the 4.1 GB of messages do
// not push h's rows out of L2 (stores in the fragments' pattern, 8 rows ×
// 32 bytes an instruction, measured 12 % slower on the card:
// scripts/torch_table_messages_variants.py).  A chunk whose masks are all
// zero (padding slots, all-padding tail tiles) writes
// zeros without a product.  Every output row is written by one CTA: no
// atomics, the same bits on every run.  Any D: K and N tails are zero in
// shared memory, D = 128·P runs P panels (grid y) over P K-chunks; W_t's
// panel is resident two K-chunks at a time, so above D = 256 it is staged
// again for each chunk of rows.  Shared memory: W 2 × 34 KB, the ring 2 ×
// 34 KB, the warps' stages 72 KB.
//
// f32 operands keep full f32 FMA products (no TF32): one CTA per (tile,
// panel) stages W_t's panel transposed and the gathered rows, and
// common.cuh's warp_gemm multiplies them.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "mma_pipe.cuh"

namespace ggnn {

// --- bf16: the persistent kernel ------------------------------------------

namespace {

using pipe::bf16;
constexpr int kWChunks = 2;                 // K-chunks of W_t resident at once
constexpr int kWarpRows = 32, kWarpCols = 64;  // a warp's output tile
constexpr int kLdW = kWarpCols + 8;             // its f32 stage's rows
constexpr size_t kSmemBf16 =                    // 208 KB
    (kWChunks + 2) * pipe::kChunk + 8 * kWarpRows * kLdW * sizeof(float);

__global__ void __launch_bounds__(pipe::kThreads, 1)
    packed_messages_bf16_kernel(const bf16* __restrict__ h, long long n_h,
                                int D, const int* __restrict__ src,
                                const float* __restrict__ mask,
                                const int* __restrict__ tile_type,
                                int n_tiles, int tile_e,
                                const bf16* __restrict__ w,
                                const bf16* __restrict__ b, int T2,
                                float* __restrict__ out) {
  using pipe::kCols;
  using pipe::kLd;
  using pipe::kRows;
  using pipe::kThreads;
  using pipe::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kChunkElems = kRows * kLd;
  bf16* W_s = reinterpret_cast<bf16*>(smem);
  bf16* A_s = W_s + kWChunks * kChunkElems;                // the ring
  float* O_w = reinterpret_cast<float*>(A_s + 2 * kChunkElems);  // warps'
  __shared__ float bias_s[kCols];
  __shared__ float mask_s[2][kRows];

  const int tid = threadIdx.x;
  const int KP = (D + kCols - 1) / kCols;  // K-chunks
  const int c0 = blockIdx.y * kCols;       // this CTA's panel
  const int wid = min(kCols, D - c0);
  const bool vec = D % kVec == 0;
  const int cpt = (tile_e + kRows - 1) / kRows;  // row chunks a tile
  const long long n_items = (long long)n_tiles * cpt;
  const long long it0 = n_items * blockIdx.x / gridDim.x;
  const long long it1 = n_items * (blockIdx.x + 1) / gridDim.x;
  const long long n_steps = (it1 - it0) * KP;  // (item, K-chunk) pairs

  // step q's chunk: rows base .. base + n of the packed layout
  auto rows_of = [&](long long q, long long& base, int& n) {
    const long long item = it0 + q / KP;
    const int r0 = int(item % cpt) * kRows;
    n = min(kRows, tile_e - r0);
    base = (item / cpt) * tile_e + r0;
  };
  // The src ids of this thread's gather rows (tid/16 + 16j), the mask of
  // row tid and the chunk's tile type, loaded a step before the gather that
  // uses them, so that nothing waits on an index.  Raw values: they are
  // checked where used.
  int srcs[kRows * kCols / kVec / kThreads];
  float m_pre = 0.0f;
  int t_pre = 0;
  auto fetch = [&](long long q) {
    long long base;
    int n;
    rows_of(q, base, n);
    t_pre = tile_type[(it0 + q / KP) / cpt];
#pragma unroll
    for (int j = 0; j < kRows * kCols / kVec / kThreads; ++j) {
      const int r = (tid >> 4) + 16 * j;
      srcs[j] = r < n ? src[base + r] : -1;
    }
    m_pre = tid < n ? mask[base + tid] : 0.0f;
  };
  // gathers step q's rows into ring stage st and its masks into mask_s[st];
  // returns (for threads < 128) whether row tid is a live slot
  auto stage_step = [&](long long q, int st) -> bool {
    long long base;
    int n;
    rows_of(q, base, n);
    const int k0 = int(q % KP) * kCols;
    bf16* A = A_s + st * kChunkElems;
    if (vec) {
      const int v = tid & 15;
#pragma unroll
      for (int j = 0; j < kRows * kCols / kVec / kThreads; ++j) {
        const int r = (tid >> 4) + 16 * j, s = srcs[j];
        bf16* d = A + r * kLd + v * kVec;
        // an id out of range is refused by the wrapper; it reads 0 here
        if (s >= 0 && s < n_h && k0 + v * kVec < D)
          pipe::cp_async16(d, h + size_t(s) * D + k0 + v * kVec);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      pipe::stage_chunk(
          A,
          [&](int r) -> const bf16* {
            if (r >= n) return nullptr;
            const int s = src[base + r];
            return (s < 0 || s >= n_h) ? nullptr : h + size_t(s) * D;
          },
          k0, D, false);
    }
    pipe::cp_async_commit();
    if (tid < kRows) mask_s[st][tid] = m_pre;
    return tid < kRows && m_pre != 0.0f;
  };

  pipe::WarpTile tile;
  long long staged = -1;                    // the resident W group's key
  bool live_cur = false;
  int t_cur = 0;
  if (n_steps > 0) {
    fetch(0);
    t_cur = t_pre;
    live_cur = stage_step(0, 0);
    if (n_steps > 1) fetch(1);
  }
  for (long long q = 0; q < n_steps; ++q) {
    const int st = int(q & 1);
    const int kc = int(q % KP);
    const int t = min(max(t_cur, 0), T2 - 1);
    const int grp = kc / kWChunks;
    const long long key = (long long)t * KP + grp;
    // step q's rows (copied during step q − 1) have landed; past the
    // barrier every warp is done with step q − 1, so its stage, W_s and
    // the masks are free
    pipe::cp_async_wait_all();
    const bool live = __syncthreads_or(live_cur);
    if (key != staged) {  // a new type (or, above D = 256, K-group)
      const bf16* wt = w + size_t(t) * D * D;
      for (int j = 0; j < kWChunks; ++j) {
        const int kk0 = (grp * kWChunks + j) * kCols;
        if (kk0 >= D) break;
        pipe::stage_chunk(
            W_s + j * kChunkElems,
            [&](int k) -> const bf16* {
              return kk0 + k < D ? wt + size_t(kk0 + k) * D : nullptr;
            },
            c0, D, vec);
      }
      if (tid < kCols)
        bias_s[tid] = tid < wid ? to_f(b[size_t(t) * D + c0 + tid]) : 0.0f;
      pipe::cp_async_commit();
      pipe::cp_async_wait_all();
      __syncthreads();
      staged = key;
    }
    if (q + 1 < n_steps) {
      live_cur = stage_step(q + 1, st ^ 1);
      t_cur = t_pre;
      if (q + 2 < n_steps) fetch(q + 2);
    }
    if (kc == 0) tile.zero();
    if (live)
      tile.mma_chunk(A_s + st * kChunkElems,
                     W_s + (kc - grp * kWChunks) * kChunkElems);
    if (kc == KP - 1) {
      // epilogue: (acc + b_t)·mask into the warp's own f32 stage, then out
      // as 16-byte pieces of whole rows (a warp instruction writes two
      // 256-byte row segments); the stage is the warp's, so no CTA barrier
      long long base;
      int n;
      rows_of(q, base, n);
      float* dst = out + base * D + c0;
      const int lane = tid & 31;
      const int r0w = pipe::WarpTile::row0(), c0w = pipe::WarpTile::col0();
      float* Ow = O_w + (tid >> 5) * kWarpRows * kLdW;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int rl = pipe::WarpTile::row(mi, e) - r0w;
          const float m = mask_s[st][r0w + rl];
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const int cl = pipe::WarpTile::col(ni, e) - c0w;
            float2 v = make_float2(0.0f, 0.0f);
            if (live) {
              v.x = (tile.acc[mi][ni][e] + bias_s[c0w + cl]) * m;
              v.y = (tile.acc[mi][ni][e + 1] + bias_s[c0w + cl + 1]) * m;
            }
            *reinterpret_cast<float2*>(Ow + rl * kLdW + cl) = v;
          }
        }
      __syncwarp();
      if (D % 4 == 0) {
#pragma unroll
        for (int i = 0; i < kWarpRows / 2; ++i) {
          const int rl = 2 * i + (lane >> 4), cl = (lane & 15) * 4;
          if (r0w + rl < n && c0w + cl < wid)
            __stcs(reinterpret_cast<float4*>(dst + size_t(r0w + rl) * D +
                                             c0w + cl),
                   *reinterpret_cast<const float4*>(Ow + rl * kLdW + cl));
        }
      } else {
        for (int i = lane; i < kWarpRows * kWarpCols; i += 32) {
          const int rl = i / kWarpCols, cl = i % kWarpCols;
          if (r0w + rl < n && c0w + cl < wid)
            __stcs(dst + size_t(r0w + rl) * D + c0w + cl,
                   Ow[rl * kLdW + cl]);
        }
      }
      __syncwarp();  // the stage is read before the next epilogue writes
    }
  }
}

int launch_packed_messages_bf16(const void* h, long long n_h, int D,
                                const void* src, const void* mask,
                                const void* tile_type, int n_tiles,
                                int tile_e, const void* w, const void* b,
                                int T2, void* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      packed_messages_bf16_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBf16));
  if (err != cudaSuccess) return int(err);
  const int panels = (D + pipe::kCols - 1) / pipe::kCols;
  const long long n_items =
      (long long)n_tiles * ((tile_e + pipe::kRows - 1) / pipe::kRows);
  const long long per_panel =
      std::max(1, pipe::multiprocessors() / panels);
  const dim3 grid(unsigned(std::min(n_items, per_panel)), panels);
  packed_messages_bf16_kernel<<<grid, pipe::kThreads, kSmemBf16, stream>>>(
      static_cast<const bf16*>(h), n_h, D, static_cast<const int*>(src),
      static_cast<const float*>(mask), static_cast<const int*>(tile_type),
      n_tiles, tile_e, static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), T2, static_cast<float*>(out));
  return int(cudaGetLastError());
}

}  // namespace

// --- f32: full f32 products, one CTA per (tile, panel) ----------------------

__global__ void __launch_bounds__(kThreads) packed_messages_f32_kernel(
    const float* __restrict__ h, long long n_h, int D,
    const int* __restrict__ src, const float* __restrict__ mask,
    const int* __restrict__ tile_type, int tile_e,
    const float* __restrict__ w, const float* __restrict__ b, int T2,
    float* __restrict__ out) {
  using T = float;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  T* A_s = reinterpret_cast<T*>(smem);
  T* B_s = reinterpret_cast<T*>(smem + Smem<T>::tile);
  __shared__ int rows_s[kRows];
  __shared__ float mask_s[kRows];
  const int i = blockIdx.x, c0 = blockIdx.y * kRows;
  const int wid = min(kRows, D - c0);
  const int row0 = (threadIdx.x >> 5) * 16;
  const int t = min(max(tile_type[i], 0), T2 - 1);
  const T* wt = w + size_t(t) * D * D;
  const bool vec = (D % V) == 0;
  const long long base = (long long)i * tile_e;
  for (int r0 = 0; r0 < tile_e; r0 += kRows) {
    const int n = min(kRows, tile_e - r0);
    __syncthreads();  // every warp is done with the previous chunk
    if (threadIdx.x < kRows) {
      const int r = threadIdx.x;
      int s = -1;
      float m = 0.0f;
      if (r < n) {
        s = src[base + r0 + r];
        m = mask[base + r0 + r];
        if (s < 0 || s >= n_h) s = -1;  // refused by the wrapper; read 0
      }
      rows_s[r] = s;
      mask_s[r] = m;
    }
    const bool live = __syncthreads_or(threadIdx.x < n &&
                                       mask_s[threadIdx.x] != 0.0f);
    float* dst = out + (base + r0) * D + c0;
    if (!live) {  // all padding: (h[0]·W_t + b_t)·0 is a zero row
      for (int idx = threadIdx.x; idx < n * wid; idx += kThreads)
        dst[size_t(idx / wid) * D + idx % wid] = 0.0f;
      continue;
    }
    float acc[kNT][4];
    zero_acc(acc);
    for (int k0 = 0; k0 < D; k0 += kD) {
      const int kw = min(kD, D - k0);
      __syncthreads();  // every warp is done with the previous K-chunk
      if (vec && kw == kD) {
        // A_s[r][k] = h[rows_s[r]][k0 + k], one 16-byte vector a thread
        for (int idx = threadIdx.x; idx < kRows * (kD / V);
             idx += kThreads) {
          const int r = idx / (kD / V), v = idx % (kD / V);
          const int s = rows_s[r];
          uint4 x = make_uint4(0u, 0u, 0u, 0u);
          if (s >= 0)
            x = *reinterpret_cast<const uint4*>(h + size_t(s) * D + k0 +
                                                v * V);
          *reinterpret_cast<uint4*>(A_s + r * ld + v * V) = x;
        }
      } else {
        for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads) {
          const int r = idx / kD, k = idx % kD;
          const int s = rows_s[r];
          A_s[r * ld + k] = (s >= 0 && k < kw) ? h[size_t(s) * D + k0 + k]
                                               : from_f<T>(0.0f);
        }
      }
      // B_s[c][k] = W_t[k0 + k][c0 + c]
      for (int idx = threadIdx.x; idx < kD * kD; idx += kThreads) {
        const int k = idx / kD, c = idx % kD;
        B_s[c * ld + k] = (k < kw && c < wid)
                              ? wt[size_t(k0 + k) * D + c0 + c]
                              : from_f<T>(0.0f);
      }
      __syncthreads();
      warp_gemm(acc, A_s + row0 * ld, B_s);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + frag_row(e), c = frag_col(nt, e);
        if (r < n && c < wid)
          dst[size_t(r) * D + c] =
              (acc[nt][e] + to_f(b[size_t(t) * D + c0 + c])) * mask_s[r];
      }
  }
}

static int launch_packed_messages_f32(const void* h, long long n_h, int D,
                                      const void* src, const void* mask,
                                      const void* tile_type, int n_tiles,
                                      int tile_e, const void* w,
                                      const void* b, int T2, void* out,
                                      cudaStream_t stream) {
  const size_t smem = 2 * Smem<float>::tile;
  cudaError_t err = cudaFuncSetAttribute(
      packed_messages_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_tiles, (D + kD - 1) / kD);
  packed_messages_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(h), n_h, D, static_cast<const int*>(src),
      static_cast<const float*>(mask), static_cast<const int*>(tile_type),
      tile_e, static_cast<const float*>(w), static_cast<const float*>(b), T2,
      static_cast<float*>(out));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// dtype: 0 = float32, 1 = bfloat16 (h, msg_w and msg_b in it).  h [n_h, D],
// D >= 1; src int32 and mask f32 [n_tiles·tile_e]; tile_type int32
// [n_tiles]; msg_w [T2, D, D], msg_b [T2, D]; out f32 [n_tiles·tile_e, D].
// Returns the cudaError_t of the launch.
extern "C" int ggnn_packed_messages(int dtype, const void* h, long long n_h,
                                    int D, const void* src, const void* mask,
                                    const void* tile_type, int n_tiles,
                                    int tile_e, const void* msg_w,
                                    const void* msg_b, int T2, void* out,
                                    void* stream) {
  if (n_tiles <= 0) return 0;
  if (D < 1 || tile_e <= 0 || T2 <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return ggnn::launch_packed_messages_bf16(h, n_h, D, src, mask, tile_type,
                                             n_tiles, tile_e, msg_w, msg_b,
                                             T2, out, s);
  if (dtype == 0)
    return ggnn::launch_packed_messages_f32(h, n_h, D, src, mask, tile_type,
                                            n_tiles, tile_e, msg_w, msg_b, T2,
                                            out, s);
  return int(cudaErrorInvalidValue);
}
