// The window backend's fused backward (#14) in bf16 at D = 128 for Hopper
// (sm_90a), exact and with int8 ā; window_bwd.cu sends these forms here
// (see there for what the backward computes).
//
// Design.  Yᵀ_t,b = Σ_tiles āᵀ_B · C_tile is computed in the TPU kernel's
// own orientation, every operand as it lies in memory: āᵀ's rows are the A
// operand (ldmatrix), the count tile's rows the B operand (ldmatrix.trans
// on the int8 bytes, converted to bf16 in the fragments, or for int8 ā
// multiplied exactly by mma.m16n8k32 after two byte permutes;
// window_pipe.cuh); then dhᵀ_b = W_t · Yᵀ (W_t's rows as stored) and
// dWᵀ_t += Yᵀ · h_b (h_b's rows as stored, ldmatrix.trans).
// - The S = W / 128 slabs of a window walk the same tiles and differ in
//   the count tile's 128-column slice: the S CTAs of a thread-block
//   cluster own one slab type each (t ≡ rank mod S), and each k-chunk of
//   āᵀ is staged once for all of them: each CTA copies 128 / S of its rows
//   by cp.async and stores them into the other CTAs' shared memory (stores
//   to distributed shared memory, which do not wait) before one cluster
//   barrier.  Count and āᵀ chunks go through rings of two stages, one
//   chunk ahead of the product.
// - The walk is (window j of the source blocks) outer, (source block b of
//   the cluster's group) inner, so dWᵀ_t of a CTA's type stays in
//   registers across the group and is written once per group and type (no
//   read-modify-write; the groups' partials are summed by a second kernel
//   in group order), and W_t is staged once per j.  dhᵀ_b's partial over
//   the cluster's S types is summed across the cluster in rank order: each
//   CTA stores the partial's rows into the CTA that owns them (128 / S
//   rows each), which adds the S partials and adds them to dhᵀ in j order
//   (the first j writes it).
// - About one CTA per SM: the group size comes from the number of clusters
//   that fit on the card at once (ggnn_window_bwd_slots), and the group's
//   real tiles come in walk order from a table the wrapper builds
//   (ops/window.py::bwd_walk), read a row ahead.
// Every sum runs in one fixed order: the same bits on every run, no
// atomics.  A window with no real tile adds exactly zero; Y is rounded to
// bf16 before the dh and dW products (the TPU kernel's rounding point);
// int8 products are exact in int32, times scale[B] per tile.
#include "window_pipe.cuh"

namespace ggnn {
namespace wbwd {

using wpipe::bf16;
using wpipe::cluster_sync;
using wpipe::cp16;
using wpipe::kChunk8;
using wpipe::kLd;
using wpipe::kLd8;
using wpipe::kThreads;
using wpipe::map_rank;
using wpipe::mma_bf16;
using wpipe::mma_bf16_counts;
using wpipe::mma_s8_s8;
using wpipe::perm_s8;
using wpipe::push_block;
using wpipe::st_cluster;
using wpipe::Tile;
using wpipe::zero;

constexpr size_t kCS = 0;                        // count ring (int8)
constexpr size_t kAB = 2 * kChunk8;              // āᵀ ring
constexpr size_t kWT = kAB + 2 * pipe::kChunk;   // W_t [d][f]
constexpr size_t kYS = kWT + pipe::kChunk;       // Yᵀ [f][n], bf16
constexpr size_t kHS = kYS + pipe::kChunk;       // h_b [n][d]
constexpr size_t kSmem = kHS + pipe::kChunk;     // 210,944 B
// the dh partials each CTA receives, [S][128 / S][kLdF] f32 over Yᵀ and h_b
constexpr int kLdF = 132;
static_assert(128 * kLdF * 4 <= 2 * pipe::kChunk, "dh partials fit");

template <bool QUANT>
__global__ void __launch_bounds__(kThreads, 1) window_bwd_fused_kernel(
    const void* __restrict__ dat, const float* __restrict__ scales,
    long long n_cols, const int8_t* __restrict__ counts,
    const int4* __restrict__ walk, const int* __restrict__ goff, int BR,
    int W, int T2, int n_src_blocks, int group, const bf16* __restrict__ msg_w,
    const bf16* __restrict__ h, float* __restrict__ dht,
    float* __restrict__ ws) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = W / 128, q = blockIdx.x % S, g = blockIdx.x / S;
  const int wpb = T2 / S, nk = BR / 128, pf = 128 / S;
  const int b0 = g * group, b1 = min(n_src_blocks, b0 + group);
  const long long N = (long long)n_src_blocks * 128;
  unsigned char* CS = smem + kCS;
  bf16* WT = reinterpret_cast<bf16*>(smem + kWT);
  bf16* YS = reinterpret_cast<bf16*>(smem + kYS);
  bf16* HS = reinterpret_cast<bf16*>(smem + kHS);
  float* DH = reinterpret_cast<float*>(smem + kYS);
  auto abuf = [&](int st) { return smem + kAB + st * pipe::kChunk; };

  // the group's real backward tiles in walk order (window j outer, source
  // block b inner, each window's tiles in list order; ops/window.py::
  // bwd_walk): rows (dst block B, stream tile c, window w = b·wpb + j);
  // a chunk is (row, k-chunk kc), and w = −1 past the group's last row
  const int p_end = goff[g + 1];
  auto row_at = [&](int p) {
    return p < p_end ? walk[p] : make_int4(-1, -1, -1, -1);
  };
  auto fetch_chunk = [&](const int4& e, int kc, int st) {
    const int8_t* C = counts + (size_t(e.y) * BR + size_t(kc) * 128) * W +
                      q * 128;
    unsigned char* cd = CS + st * kChunk8;
    for (int idx = threadIdx.x; idx < 128 * 8; idx += kThreads) {
      const int k = idx >> 3, v = idx & 7;
      cp16(cd + (QUANT ? perm_s8(k) : k) * kLd8 + v * 16,
           C + size_t(k) * W + v * 16, true);
    }
    constexpr int esz = QUANT ? 1 : 2, vpr = 128 * esz / 16;
    const unsigned char* A = static_cast<const unsigned char*>(dat) +
                             (size_t(e.x) * BR + size_t(kc) * 128) * esz;
    for (int idx = threadIdx.x; idx < pf * vpr; idx += kThreads) {
      const int f = q * pf + idx / vpr, v = idx % vpr;
      cp16(abuf(st) + f * (QUANT ? kLd8 : kLd * 2) + v * 16,
           A + size_t(f) * n_cols * esz + v * 16, true);
    }
  };
  auto fetch_rows = [&](bf16* dst, const bf16* src) {
    for (int idx = threadIdx.x; idx < 128 * 16; idx += kThreads) {
      const int r = idx >> 4, v = idx & 15;
      cp16(dst + r * kLd + v * 8, src + size_t(r) * 128 + v * 8, true);
    }
  };

  // W_t and h_b of the next slab that has a real tile (window w): HS once
  // per such slab (the dh partials overlay it), WT when j changes
  int wt_j = -1;
  auto fetch_slab = [&](int w) {
    if (w < 0) return;
    if (w % wpb != wt_j) {
      wt_j = w % wpb;
      fetch_rows(WT, msg_w + size_t(S * wt_j + q) * 128 * 128);
    }
    fetch_rows(HS, h + size_t(w / wpb) * 128 * 128);
  };
  // the next chunk (nxt, nkc), at row p of the walk, and the row after
  int p = goff[g];
  int4 nxt = row_at(p), after = row_at(p + 1);
  int nkc = 0;
  fetch_slab(nxt.z);
  if (nxt.z >= 0) fetch_chunk(nxt, 0, 0);
  pipe::cp_async_commit();
  int s = 0;
  for (int j = 0; j < wpb && b0 < b1; ++j) {
    const int t = S * j + q;
    float dw[2][8][4];
    zero<8>(dw);
    for (int b = b0; b < b1; ++b) {
      float y[2][8][4];
      int iacc[2][8][4];
      zero<8>(y);
      if constexpr (QUANT) zero<8>(iacc);
      bool any = false;
      const int w = b * wpb + j;
      while (nxt.z == w) {
        const int4 cur = nxt;
        const int ckc = nkc;
        if (++nkc == nk) {  // the walk's next row (loaded a row ahead)
          nkc = 0;
          nxt = after;
          after = row_at(++p + 1);
        }
        const int st = s & 1;
        pipe::cp_async_wait_all();
        // this CTA's rows of chunk s have landed, and it is done with
        // chunk s − 1 (whose stage takes this CTA's copies of chunk s + 1)
        __syncthreads();
        if (nxt.z >= 0) fetch_chunk(nxt, nkc, st ^ 1);
        pipe::cp_async_commit();
        push_block(abuf(st), QUANT ? kLd8 : kLd * 2, q * pf, pf, 0,
                   QUANT ? 128 : 256, S, q);
        // every CTA's rows of chunk s are in every CTA, and no CTA still
        // multiplies chunk s − 1
        cluster_sync();
        const unsigned char* C = CS + st * kChunk8;
        if constexpr (QUANT) {
          mma_s8_s8(iacc, abuf(st), C);
          if (ckc == nk - 1) {
            const float sc = scales[cur.x];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int ni = 0; ni < 8; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  y[mi][ni][e] += float(iacc[mi][ni][e]) * sc;
                  iacc[mi][ni][e] = 0;
                }
          }
        } else {
          mma_bf16_counts(y, reinterpret_cast<const bf16*>(abuf(st)), C);
        }
        any = true;
        ++s;
      }
      const int rows0 = q * pf;  // this CTA's rows of dhᵀ
      float* dcol = dht + size_t(b) * 128;
      if (!any) {
        // an empty window: nothing to add; the first j writes the zeros
        if (j == 0)
          for (int idx = threadIdx.x; idx < pf * 32; idx += kThreads)
            reinterpret_cast<float4*>(dcol + (rows0 + idx / 32) * N)[idx % 32] =
                make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        using TP = Tile<8, true>;
        using TS = Tile<8>;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              YS[TP::row(mi, e) * kLd + TP::col(ni, e)] =
                  __float2bfloat16_rn(y[mi][ni][e]);
        __syncthreads();
        mma_bf16<8>(dw, YS, kLd, HS, kLd);  // dWᵀ_t[f][d] += Yᵀ[f][n] h[n][d]
        zero<8>(y);
        mma_bf16<8>(y, WT, kLd, YS, kLd);   // dhᵀ[d][n] = W_t[d][f] Yᵀ[f][n]
        cluster_sync();  // no CTA reads its Yᵀ and h_b any more
        // row d of the partial to CTA d / pf, slot q: DH[q·pf + d % pf]
        uint32_t base[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) base[r] = r < S ? map_rank(DH, r) : 0u;
        // lanes 2m and 2m + 1 of a quad swap halves: the even one stores
        // its row's 4 columns, the odd one its partner's row + 8's
        const bool odd = threadIdx.x & 1;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const float v0 = y[mi][ni][0], v1 = y[mi][ni][1];
            const float v2 = y[mi][ni][2], v3 = y[mi][ni][3];
            const float r0 = __shfl_xor_sync(~0u, odd ? v0 : v2, 1);
            const float r1 = __shfl_xor_sync(~0u, odd ? v1 : v3, 1);
            const int d = TS::row(mi, odd ? 2 : 0);
            const int n = TS::col(ni, 0) - (odd ? 2 : 0);
            const float4 f = odd ? make_float4(r0, r1, v2, v3)
                                 : make_float4(v0, v1, r0, r1);
            st_cluster(base[d / pf] + 4u * ((q * pf + d % pf) * kLdF + n),
                       *reinterpret_cast<const uint4*>(&f));
          }
        // rows [q·pf, +pf) of dhᵀ_b, 16 / S float4 a thread: the earlier
        // j's sums loaded all at once (in flight together), then the S
        // partials added in rank order
        constexpr int kIt = 128 * 32 / kThreads;  // at S = 1
        const int n_it = pf * 32 / kThreads;
        float4 old[kIt];
#pragma unroll
        for (int it = 0; it < kIt; ++it) {
          const int idx = threadIdx.x + it * kThreads;
          old[it] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (j > 0 && it < n_it)
            old[it] = reinterpret_cast<const float4*>(
                dcol + (rows0 + idx / 32) * N)[idx % 32];
        }
        cluster_sync();  // every partial has arrived
#pragma unroll
        for (int it = 0; it < kIt; ++it) {
          if (it >= n_it) break;
          const int idx = threadIdx.x + it * kThreads;
          const int dd = idx / 32, v = idx % 32;
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int k = 0; k < S; ++k) {
            const float4 u = *reinterpret_cast<const float4*>(
                DH + (k * pf + dd) * kLdF + 4 * v);
            sum.x += u.x;
            sum.y += u.y;
            sum.z += u.z;
            sum.w += u.w;
          }
          if (j > 0) {
            sum.x = old[it].x + sum.x;
            sum.y = old[it].y + sum.y;
            sum.z = old[it].z + sum.z;
            sum.w = old[it].w + sum.w;
          }
          reinterpret_cast<float4*>(dcol + (rows0 + dd) * N)[v] = sum;
        }
        __syncthreads();  // HS (under the partials) is free
        fetch_slab(nxt.z);
        pipe::cp_async_commit();
      }
    }
    // dWᵀ_t's partial of this group, written once
    float* part = ws + (size_t(g) * T2 + t) * 128 * 128;
    using TS = Tile<8>;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          *reinterpret_cast<float2*>(part + TS::row(mi, e) * 128 +
                                     TS::col(ni, e)) =
              make_float2(dw[mi][ni][e], dw[mi][ni][e + 1]);
  }
  pipe::cp_async_wait_all();
}

template <bool QUANT>
cudaLaunchConfig_t bwd_config(int S, int n_clusters, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(n_clusters) * S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool QUANT>
int launch(const void* dat, const void* scales, long long n_cols,
           const void* counts, const void* walk, const void* goff, int BR,
           int W, int T2, int n_src_blocks, int group, const void* msg_w,
           const void* h, void* dht, void* ws, cudaStream_t stream) {
  const int S = W / 128;
  if (S != 1 && S != 2 && S != 4) return int(cudaErrorInvalidValue);
  auto kern = window_bwd_fused_kernel<QUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err != cudaSuccess) return int(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = bwd_config<QUANT>(
      S, (n_src_blocks + group - 1) / group, stream, attr);
  err = cudaLaunchKernelEx(
      &cfg, kern, dat, static_cast<const float*>(scales), n_cols,
      static_cast<const int8_t*>(counts), static_cast<const int4*>(walk),
      static_cast<const int*>(goff), BR, W, T2, n_src_blocks, group,
      static_cast<const bf16*>(msg_w),
      static_cast<const bf16*>(h), static_cast<float*>(dht),
      static_cast<float*>(ws));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

template <bool QUANT>
int slots(int S) {
  auto kern = window_bwd_fused_kernel<QUANT>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(kSmem)) != cudaSuccess)
    return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = bwd_config<QUANT>(S, 4096, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) return 0;
  return n;
}

}  // namespace wbwd

int launch_window_bwd_fused(int quant, const void* dat, const void* scales,
                            long long n_cols, const void* counts,
                            const void* walk, const void* goff, int BR,
                            int W, int T2, int n_src_blocks, int group,
                            const void* msg_w, const void* h, void* dht,
                            void* ws, cudaStream_t stream) {
  return (quant ? wbwd::launch<true> : wbwd::launch<false>)(
      dat, scales, n_cols, counts, walk, goff, BR, W, T2, n_src_blocks, group,
      msg_w, h, dht, ws, stream);
}

}  // namespace ggnn

// The clusters of S = W / 128 CTAs of the bf16 fused backward (exact, or
// int8 ā with quant) that fit on the current card at once (0 on error):
// the wrapper's group size is ceil(n_src_blocks / slots).
extern "C" int ggnn_window_bwd_slots(int quant, int S) {
  if (S != 1 && S != 2 && S != 4) return 0;
  return quant ? ggnn::wbwd::slots<true>(S) : ggnn::wbwd::slots<false>(S);
}
