// GRU cell backward for Hopper (sm_90a).
//
// Replaces ggnn_tpu/ops/gru_pallas.py::gru_cell_bwd (_bwd_kernel).  From the
// output cotangent g (f32) and the narrow residuals h, a, z, r, h̃ (matmul
// dtype T) it computes
//   dq  = g·z·(1 − h̃²),  dpz = g·(h̃ − h)·z·(1 − z),
//   drh = dq·U_hᵀ,       dpr = drh·h·r·(1 − r),
//   dh  = g·(1 − z) + drh·r + dpz·U_zᵀ + dpr·U_rᵀ          (f32)
//   da  = dpz·W_zᵀ + dpr·W_rᵀ + dq·W_hᵀ                     (f32 or T)
//   dW_a = aᵀ·[dpz | dpr | dq],  dU_zr = hᵀ·[dpz | dpr],  dU_h = (r·h)ᵀ·dq,
//   db = Σ_rows [dpz | dpr | dq]                             (all f32)
// with every matmul input rounded to T (gate gradients included) and f32
// accumulation, and db summed from the f32 gate gradients, as the TPU kernel
// does.
//
// The TPU kernel accumulates the parameter gradients across its sequential
// grid; a [D, 6D] f32 accumulator per CTA (384 KB) does not fit in shared
// memory here, and float atomics would make the result change from run to
// run.  So the work is split in three deterministic launches:
// 1. rows: one CTA per 128-row block (8 warps x 16 rows) computes the gate
//    gradients, dh and da with mma.sync (bf16) or FMA loops (f32), writes
//    dpz, dpr, dq rounded to T to a workspace and the block's column sums of
//    the f32 gate gradients (db partials);
// 2. params: split-K over row chunks, one CTA per (chunk, product) for the
//    six [128, 128] products xᵀ·y, each staged transposed in shared memory,
//    writing one f32 partial per chunk;
// 3. reduce: every output element sums its chunk partials in a fixed order.
//
// Bound on this card: HBM bytes.  At the headline (262,144 rows, D = 128,
// bf16) the rows pass reads g (134 MB) and four residuals (268 MB) and
// writes dh (134 MB), da (134 MB) and the gate workspace (201 MB); the params
// pass reads 6 x 2 x 67 MB and the partials are ~50 MB: ≈ 1.7 GB, ≈ 0.5 ms
// at 3.35 TB/s, against the ≈ 0.7 GB the function itself must move.
#include "common.cuh"

namespace ggnn {

constexpr int kBlocksPerChunk = 16;  // 128-row blocks per split-K chunk

template <typename T>
__device__ __forceinline__ float ld_f(const T* p, size_t i) {
  return to_f(p[i]);
}

// Column sums over the calling warp's 16 rows of n-tile nt of a
// fragment-layout value v[e], into red[warp][c]; the caller sums red over
// the 8 warps in a fixed order.
__device__ __forceinline__ void colsum_nt(const float (&v)[4], int nt,
                                          float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float s = v[q] + v[q + 2];  // rows g and g + 8
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (lane < 4) red[warp * kD + nt * 8 + 2 * lane + q] = s;
  }
}

template <typename T>
struct BwdSmem {
  static constexpr size_t tiles = 3 * Smem<T>::tile;  // P_s, Q_s, W_s
  static constexpr size_t red = size_t(8) * 3 * kD * sizeof(float);
  static constexpr size_t bytes = tiles + red;
};

template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads, 1) gru_bwd_rows_kernel(
    const float* __restrict__ g, const T* __restrict__ h,
    const T* __restrict__ z, const T* __restrict__ r, const T* __restrict__ ht,
    const T* __restrict__ wa, const T* __restrict__ uzr,
    const T* __restrict__ uh, float* __restrict__ dh, TD* __restrict__ da,
    T* __restrict__ gates, float* __restrict__ dbp, size_t n_elems) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  T* P_s = reinterpret_cast<T*>(smem);                      // dpz
  T* Q_s = reinterpret_cast<T*>(smem + Smem<T>::tile);      // dq, then dpr
  T* W_s = reinterpret_cast<T*>(smem + 2 * Smem<T>::tile);
  float* red = reinterpret_cast<float*>(smem + BwdSmem<T>::tiles);
  const int row0 = (threadIdx.x >> 5) * 16;
  const size_t base = size_t(blockIdx.x) * kRows * kD;
  T* gz = gates;
  T* gr = gates + n_elems;
  T* gq = gates + 2 * n_elems;

  // dq and dpz, elementwise; their f32 column sums are db's partials
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    float vq[4], vz[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = row0 + frag_row(e), c = frag_col(nt, e);
      const size_t i = base + size_t(rr) * kD + c;
      const float gv = g[i], zv = ld_f(z, i), hv = ld_f(h, i);
      const float htv = ld_f(ht, i);
      vq[e] = (gv * zv) * (1.0f - htv * htv);
      vz[e] = (gv * (htv - hv)) * zv * (1.0f - zv);
      const T tq = from_f<T>(vq[e]), tz = from_f<T>(vz[e]);
      Q_s[rr * ld + c] = tq;
      P_s[rr * ld + c] = tz;
      gq[i] = tq;
      gz[i] = tz;
    }
    colsum_nt(vq, nt, red + 2 * 8 * kD);
    colsum_nt(vz, nt, red);
  }

  // drh = dq·U_hᵀ (acc1) and da's h̃ term dq·W_hᵀ (acc2)
  float acc1[kNT][4], acc2[kNT][4];
  zero_acc(acc1);
  zero_acc(acc2);
  __syncthreads();
  load_w_rows(W_s, uh, kD, 0);
  __syncthreads();
  warp_gemm(acc1, Q_s + row0 * ld, W_s);
  __syncthreads();
  load_w_rows(W_s, wa, 3 * kD, 2 * kD);
  __syncthreads();
  warp_gemm(acc2, Q_s + row0 * ld, W_s);
  __syncwarp();

  // dpr replaces dq in this warp's own strip of Q_s; acc1 becomes drh·r
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    float vr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = row0 + frag_row(e), c = frag_col(nt, e);
      const size_t i = base + size_t(rr) * kD + c;
      const float rv = ld_f(r, i), hv = ld_f(h, i), drh = acc1[nt][e];
      vr[e] = (drh * hv) * rv * (1.0f - rv);
      const T t = from_f<T>(vr[e]);
      Q_s[rr * ld + c] = t;
      gr[i] = t;
      acc1[nt][e] = drh * rv;
    }
    colsum_nt(vr, nt, red + 8 * kD);
  }
  __syncwarp();

  // da += dpz·W_zᵀ + dpr·W_rᵀ
  __syncthreads();
  load_w_rows(W_s, wa, 3 * kD, 0);
  __syncthreads();
  warp_gemm(acc2, P_s + row0 * ld, W_s);
  __syncthreads();
  load_w_rows(W_s, wa, 3 * kD, kD);
  __syncthreads();
  warp_gemm(acc2, Q_s + row0 * ld, W_s);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t i = base + size_t(row0 + frag_row(e)) * kD + frag_col(nt, e);
      da[i] = from_f<TD>(acc2[nt][e]);
    }

  // dh = g·(1 − z) + drh·r + dpz·U_zᵀ + dpr·U_rᵀ
  __syncthreads();
  load_w_rows(W_s, uzr, 2 * kD, 0);
  __syncthreads();
  warp_gemm(acc1, P_s + row0 * ld, W_s);
  __syncthreads();
  load_w_rows(W_s, uzr, 2 * kD, kD);
  __syncthreads();
  warp_gemm(acc1, Q_s + row0 * ld, W_s);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t i = base + size_t(row0 + frag_row(e)) * kD + frag_col(nt, e);
      dh[i] = g[i] * (1.0f - ld_f(z, i)) + acc1[nt][e];
    }

  // db partials of this block: the 8 warps' column sums in a fixed order
  __syncthreads();
  for (int j = threadIdx.x; j < 3 * kD; j += kThreads) {
    const int gate = j / kD, c = j % kD;
    float s = 0.0f;
    for (int w = 0; w < 8; ++w) s += red[(gate * 8 + w) * kD + c];
    dbp[size_t(blockIdx.x) * 3 * kD + j] = s;
  }
}

// Partial of product p over the rows of chunk blockIdx.x:
//   p = 0, 1, 2: aᵀ·dpz, aᵀ·dpr, aᵀ·dq;  p = 3, 4: hᵀ·dpz, hᵀ·dpr;
//   p = 5: (r·h)ᵀ·dq, with r·h taken in f32 and rounded to T.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) gru_bwd_params_kernel(
    const T* __restrict__ h, const T* __restrict__ a, const T* __restrict__ r,
    const T* __restrict__ gates, float* __restrict__ ws, int n_blocks,
    size_t n_elems) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  T* A_s = reinterpret_cast<T*>(smem);                  // A[m][k] = x[k][m]
  T* B_s = reinterpret_cast<T*>(smem + Smem<T>::tile);  // Bt[n][k] = y[k][n]
  const int chunk = blockIdx.x, p = blockIdx.y;
  const T* x = p < 3 ? a : h;
  const T* y = gates + size_t(p < 3 ? p : (p < 5 ? p - 3 : 2)) * n_elems;
  const int row0 = (threadIdx.x >> 5) * 16;
  float acc[kNT][4];
  zero_acc(acc);
  const int b_end = min(n_blocks, (chunk + 1) * kBlocksPerChunk);
  for (int b = chunk * kBlocksPerChunk; b < b_end; ++b) {
    const size_t base = size_t(b) * kRows * kD;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads) {
      const int k = idx / kD, m = idx % kD;
      const size_t i = base + idx;
      A_s[m * ld + k] =
          p == 5 ? from_f<T>(to_f(r[i]) * to_f(h[i])) : x[i];
      B_s[m * ld + k] = y[i];
    }
    __syncthreads();
    warp_gemm(acc, A_s + row0 * ld, B_s);
  }
  float* out = ws + (size_t(chunk) * 6 + p) * kD * kD;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(row0 + frag_row(e)) * kD + frag_col(nt, e)] = acc[nt][e];
}

// Sums the chunk partials (and the block partials of db) in a fixed order
// into dW_a [D, 3D], dU_zr [D, 2D], dU_h [D, D] and db [3D].
__global__ void gru_bwd_reduce_kernel(const float* __restrict__ ws,
                                      const float* __restrict__ dbp,
                                      int n_chunks, int n_blocks,
                                      float* __restrict__ dwa,
                                      float* __restrict__ db,
                                      float* __restrict__ duzr,
                                      float* __restrict__ duh) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  constexpr int kTile = kD * kD;
  if (idx < 6 * kTile) {
    const int p = idx / kTile, rem = idx % kTile;
    const int m = rem / kD, n = rem % kD;
    float s = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch)
      s += ws[(size_t(ch) * 6 + p) * kTile + rem];
    if (p < 3)
      dwa[m * 3 * kD + p * kD + n] = s;
    else if (p < 5)
      duzr[m * 2 * kD + (p - 3) * kD + n] = s;
    else
      duh[m * kD + n] = s;
  } else if (idx < 6 * kTile + 3 * kD) {
    const int j = idx - 6 * kTile;
    float s = 0.0f;
    for (int b = 0; b < n_blocks; ++b) s += dbp[size_t(b) * 3 * kD + j];
    db[j] = s;
  }
}

template <typename T, typename TD>
static int launch_gru_bwd(const void* g, const void* h, const void* a,
                          const void* z, const void* r, const void* ht,
                          const void* wa, const void* uzr, const void* uh,
                          void* dh, void* da, void* gates, void* dbp, void* ws,
                          void* dwa, void* db, void* duzr, void* duh,
                          int n_blocks, cudaStream_t stream) {
  const size_t n_elems = size_t(n_blocks) * kRows * kD;
  const size_t smem_rows = BwdSmem<T>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_rows_kernel<T, TD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem_rows));
  if (err != cudaSuccess) return int(err);
  gru_bwd_rows_kernel<T, TD><<<n_blocks, kThreads, smem_rows, stream>>>(
      static_cast<const float*>(g), static_cast<const T*>(h),
      static_cast<const T*>(z), static_cast<const T*>(r),
      static_cast<const T*>(ht), static_cast<const T*>(wa),
      static_cast<const T*>(uzr), static_cast<const T*>(uh),
      static_cast<float*>(dh), static_cast<TD*>(da), static_cast<T*>(gates),
      static_cast<float*>(dbp), n_elems);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const int n_chunks = (n_blocks + kBlocksPerChunk - 1) / kBlocksPerChunk;
  const size_t smem_par = 2 * Smem<T>::tile;
  err = cudaFuncSetAttribute(gru_bwd_params_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_par));
  if (err != cudaSuccess) return int(err);
  gru_bwd_params_kernel<T><<<dim3(n_chunks, 6), kThreads, smem_par, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(a),
      static_cast<const T*>(r), static_cast<const T*>(gates),
      static_cast<float*>(ws), n_blocks, n_elems);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const int total = 6 * kD * kD + 3 * kD;
  gru_bwd_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(dbp), n_chunks,
      n_blocks, static_cast<float*>(dwa), static_cast<float*>(db),
      static_cast<float*>(duzr), static_cast<float*>(duh));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// Number of split-K chunks the workspace ws must hold for n_blocks blocks
// (ws is [n_chunks, 6, 128, 128] f32).
extern "C" int ggnn_gru_bwd_chunks(int n_blocks) {
  return (n_blocks + ggnn::kBlocksPerChunk - 1) / ggnn::kBlocksPerChunk;
}

// dtype: 0 = float32, 1 = bfloat16 (residuals h, a, z, r, h̃, weights and the
// gate workspace [3, N, 128]); da_narrow = 1 writes da in that dtype, else
// f32.  g, dh, dbp [n_blocks, 3·128], ws and the parameter grads are f32.
// Returns the cudaError_t of the first failed launch (0 = success).
extern "C" int ggnn_gru_cell_bwd(int dtype, int da_narrow, const void* g,
                                 const void* h, const void* a, const void* z,
                                 const void* r, const void* ht, const void* wa,
                                 const void* uzr, const void* uh, void* dh,
                                 void* da, void* gates, void* dbp, void* ws,
                                 void* dwa, void* db, void* duzr, void* duh,
                                 int n_blocks, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GGNN_LAUNCH(T, TD)                                                   \
  return ggnn::launch_gru_bwd<T, TD>(g, h, a, z, r, ht, wa, uzr, uh, dh, da, \
                                     gates, dbp, ws, dwa, db, duzr, duh,     \
                                     n_blocks, s)
  if (dtype == 1 && da_narrow) GGNN_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 1) GGNN_LAUNCH(__nv_bfloat16, float);
  if (dtype == 0) GGNN_LAUNCH(float, float);
#undef GGNN_LAUNCH
  return int(cudaErrorInvalidValue);
}
