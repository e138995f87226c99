// GRU cell forward and backward for states wider than 128 (D = 128·P) on
// Hopper (sm_90a).
//
// Replaces ggnn_tpu/ops/gru_pallas.py::gru_cell_fwd (_fwd_kernel, #3) and
// gru_cell_bwd (_bwd_kernel, #4) at the widths the D = 128 kernels
// (gru_cell.cu, gru_cell_bwd.cu) do not take: the same functions, with the
// same rounding points (every matmul input rounded to T: a, h, r⊙h, the
// gate gradients; f32 accumulation, f32 gates and state).
//
// Design.  A CTA still owns 128 rows (8 warps of 16 rows, the mma.sync
// fragment layout of common.cuh), but a [128, D] operand no longer fits in
// shared memory next to a weight tile in f32, so every product walks
// 128-column panels: for output panel q, acc = Σ_kp x[:, kp] · W[kp, q],
// each x panel staged (rounded to T) from global memory and each W panel
// loaded transposed, one accumulator (64 registers) at a time.  The
// forward's gates need all of r before r⊙h enters the h̃ product, so z is
// kept in the output rows (f32, read back by the thread that wrote it) and
// r⊙h in a T workspace; the backward keeps the gate gradients in its gate
// workspace (as gru_cell_bwd.cu does) and drh⊙r in the dh rows, and db's
// per-warp column sums in shared memory up to P = 2, above that in global
// scratch (3·P·8·128 floats a block no longer fit beside two tiles).  The
// parameter gradients are gru_cell_bwd.cu's split-K products, one CTA per
// (row chunk, product, 128×128 output tile), summed over the chunks in a
// fixed order.
//
// Bound on this card: HBM bytes, as the D = 128 kernels; the panels re-read
// their inputs P times from L2.
#include "common.cuh"

namespace ggnn {

constexpr int kWideBlocksPerChunk = 16;  // 128-row blocks per split-K chunk
constexpr int kSmemRedPanels = 2;  // the widest P whose db sums fit in smem

// dst[r][c] = T(src[r·ldx + col0 + c]) for the CTA's 128 rows.
template <typename T, typename S>
__device__ __forceinline__ void stage_panel(T* dst, const S* __restrict__ src,
                                            int ldx, int col0) {
  constexpr int ld = Smem<T>::ld;
  for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads) {
    const int r = idx / kD, c = idx % kD;
    dst[r * ld + c] = from_f<T>(to_f(src[size_t(r) * ldx + col0 + c]));
  }
}

// --- forward -----------------------------------------------------------------

template <typename T, bool EMIT>
__global__ void __launch_bounds__(kThreads) gru_wide_fwd_kernel(
    const float* __restrict__ h, const float* __restrict__ a,
    const T* __restrict__ wa, const float* __restrict__ b3,
    const T* __restrict__ uzr, const T* __restrict__ uh, int P,
    T* __restrict__ rh, float* __restrict__ out_h, T* __restrict__ out_z,
    T* __restrict__ out_r, T* __restrict__ out_ht) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  T* X_s = reinterpret_cast<T*>(smem);
  T* W_s = reinterpret_cast<T*>(smem + Smem<T>::tile);
  const int D = P * kD;
  const size_t rb = size_t(blockIdx.x) * kRows * D;  // this block's rows
  const float* hb = h + rb;
  const float* ab = a + rb;
  T* rhb = rh + rb;
  float* ob = out_h + rb;
  const int row0 = (threadIdx.x >> 5) * 16;
  float acc[kNT][4];
  // gate g (0 = z, 1 = r, 2 = h̃) of output panel q:
  //   acc = Σ_kp a[:, kp]·W_g[kp, q] + y[:, kp]·U_g[kp, q], y = h or r⊙h
  auto gate = [&](int g, int q) {
    zero_acc(acc);
    for (int kp = 0; kp < P; ++kp) {
      __syncthreads();
      stage_panel(X_s, ab, D, kp * kD);
      load_wt(W_s, wa + size_t(kp) * kD * 3 * D, 3 * D, g * D + q * kD);
      __syncthreads();
      warp_gemm(acc, X_s + row0 * ld, W_s);
      __syncthreads();
      if (g < 2) {
        stage_panel(X_s, hb, D, kp * kD);
        load_wt(W_s, uzr + size_t(kp) * kD * 2 * D, 2 * D, g * D + q * kD);
      } else {
        stage_panel(X_s, rhb, D, kp * kD);
        load_wt(W_s, uh + size_t(kp) * kD * D, D, q * kD);
      }
      __syncthreads();
      warp_gemm(acc, X_s + row0 * ld, W_s);
    }
  };
  for (int q = 0; q < P; ++q) {  // z, kept in the output rows
    gate(0, q);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t i = size_t(row0 + frag_row(e)) * D + q * kD +
                         frag_col(nt, e);
        const float z = sigmoid_f(acc[nt][e] + b3[q * kD + frag_col(nt, e)]);
        ob[i] = z;
        if (EMIT) out_z[rb + i] = from_f<T>(z);
      }
  }
  for (int q = 0; q < P; ++q) {  // r, and r⊙h rounded to T
    gate(1, q);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t i = size_t(row0 + frag_row(e)) * D + q * kD +
                         frag_col(nt, e);
        const float rg =
            sigmoid_f(acc[nt][e] + b3[D + q * kD + frag_col(nt, e)]);
        rhb[i] = from_f<T>(rg * hb[i]);
        if (EMIT) out_r[rb + i] = from_f<T>(rg);
      }
  }
  for (int q = 0; q < P; ++q) {  // h̃ and h'
    gate(2, q);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t i = size_t(row0 + frag_row(e)) * D + q * kD +
                         frag_col(nt, e);
        const float ht =
            tanhf(acc[nt][e] + b3[2 * D + q * kD + frag_col(nt, e)]);
        const float z = ob[i], hv = hb[i];
        ob[i] = (1.0f - z) * hv + z * ht;
        if (EMIT) out_ht[rb + i] = from_f<T>(ht);
      }
  }
}

// --- backward: rows ------------------------------------------------------------

// Column sums over the calling warp's 16 rows of n-tile nt (as
// gru_cell_bwd.cu's colsum_nt), into red[warp][c] of a [8][128] slab.
__device__ __forceinline__ void colsum_wide(const float (&v)[4], int nt,
                                            float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float s = v[q] + v[q + 2];
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (lane < 4) red[warp * kD + nt * 8 + 2 * lane + q] = s;
  }
}

// rows: dq, dpz (then dpr) rounded to T into the gate workspace [3, N, D];
// drh = dq·U_hᵀ; dpr = drh·h·r(1 − r); da = dpz·W_zᵀ + dpr·W_rᵀ + dq·W_hᵀ;
// dh = g(1 − z) + drh·r + dpz·U_zᵀ + dpr·U_rᵀ; db partials per block.
template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads, 1) gru_wide_bwd_rows_kernel(
    const float* __restrict__ g, const T* __restrict__ h,
    const T* __restrict__ z, const T* __restrict__ r, const T* __restrict__ ht,
    const T* __restrict__ wa, const T* __restrict__ uzr,
    const T* __restrict__ uh, int P, float* __restrict__ dh,
    TD* __restrict__ da, T* __restrict__ gates, float* __restrict__ dbp,
    float* __restrict__ red_g, size_t n_elems) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  T* X_s = reinterpret_cast<T*>(smem);
  T* W_s = reinterpret_cast<T*>(smem + Smem<T>::tile);
  // db's per-warp column sums: in shared memory up to P = 2; wider states
  // keep them in this block's slot of the global scratch red_g (the
  // barrier before the final sum orders a block's global writes too)
  float* red = red_g ? red_g + size_t(blockIdx.x) * 3 * P * 8 * kD
                     : reinterpret_cast<float*>(smem + 2 * Smem<T>::tile);
  const int D = P * kD;
  const size_t rb = size_t(blockIdx.x) * kRows * D;
  T* gz = gates + rb;
  T* gr = gates + n_elems + rb;
  T* gq = gates + 2 * n_elems + rb;
  const int row0 = (threadIdx.x >> 5) * 16;
  // red: [gate (z, r, q)][panel][warp][128]
  auto slab = [&](int gate, int q) { return red + (gate * P + q) * 8 * kD; };

  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float vq[4], vz[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t i = size_t(row0 + frag_row(e)) * D + q * kD +
                         frag_col(nt, e);
        const float gv = g[rb + i], zv = to_f(z[rb + i]);
        const float hv = to_f(h[rb + i]), htv = to_f(ht[rb + i]);
        vq[e] = (gv * zv) * (1.0f - htv * htv);
        vz[e] = (gv * (htv - hv)) * zv * (1.0f - zv);
        gq[i] = from_f<T>(vq[e]);
        gz[i] = from_f<T>(vz[e]);
      }
      colsum_wide(vq, nt, slab(2, q));
      colsum_wide(vz, nt, slab(0, q));
    }

  float acc[kNT][4];
  // acc (+)= Σ_kp x[:, kp] · M[q rows, col0 + kp panel]ᵀ, x a gate panel
  auto prod = [&](const T* x, const T* M, int ldm, int col0, int q) {
    for (int kp = 0; kp < P; ++kp) {
      __syncthreads();
      stage_panel(X_s, x, D, kp * kD);
      load_w_rows(W_s, M + size_t(q) * kD * ldm, ldm, col0 + kp * kD);
      __syncthreads();
      warp_gemm(acc, X_s + row0 * ld, W_s);
    }
  };
  for (int q = 0; q < P; ++q) {  // drh → dpr; drh·r kept in dh
    zero_acc(acc);
    prod(gq, uh, D, 0, q);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float vr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t i = size_t(row0 + frag_row(e)) * D + q * kD +
                         frag_col(nt, e);
        const float rv = to_f(r[rb + i]), hv = to_f(h[rb + i]);
        const float drh = acc[nt][e];
        vr[e] = (drh * hv) * rv * (1.0f - rv);
        gr[i] = from_f<T>(vr[e]);
        dh[rb + i] = drh * rv;
      }
      colsum_wide(vr, nt, slab(1, q));
    }
  }
  for (int q = 0; q < P; ++q) {  // da
    zero_acc(acc);
    prod(gq, wa, 3 * D, 2 * D, q);
    prod(gz, wa, 3 * D, 0, q);
    prod(gr, wa, 3 * D, D, q);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t i = size_t(row0 + frag_row(e)) * D + q * kD +
                         frag_col(nt, e);
        da[rb + i] = from_f<TD>(acc[nt][e]);
      }
  }
  for (int q = 0; q < P; ++q) {  // dh
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[nt][e] = dh[rb + size_t(row0 + frag_row(e)) * D + q * kD +
                        frag_col(nt, e)];
    prod(gz, uzr, 2 * D, 0, q);
    prod(gr, uzr, 2 * D, D, q);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t i = rb + size_t(row0 + frag_row(e)) * D + q * kD +
                         frag_col(nt, e);
        dh[i] = g[i] * (1.0f - to_f(z[i])) + acc[nt][e];
      }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 3 * D; j += kThreads) {
    const int gate = j / D, c = j % D;
    const float* s_ = slab(gate, c / kD);
    float s = 0.0f;
    for (int w = 0; w < 8; ++w) s += s_[w * kD + c % kD];
    dbp[size_t(blockIdx.x) * 3 * D + j] = s;
  }
}

// --- backward: parameter gradients ---------------------------------------------

// Partial of product p's output tile (mi, ni) = blockIdx.z over the rows of
// chunk blockIdx.x (the products of gru_cell_bwd.cu's params kernel).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) gru_wide_bwd_params_kernel(
    const T* __restrict__ h, const T* __restrict__ a, const T* __restrict__ r,
    const T* __restrict__ gates, float* __restrict__ ws, int n_blocks, int P,
    size_t n_elems) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = Smem<T>::ld;
  T* A_s = reinterpret_cast<T*>(smem);                  // A[m][k] = x[k][m]
  T* B_s = reinterpret_cast<T*>(smem + Smem<T>::tile);  // Bt[n][k] = y[k][n]
  const int chunk = blockIdx.x, p = blockIdx.y;
  const int mi = blockIdx.z / P, ni = blockIdx.z % P;
  const int D = P * kD;
  const T* x = p < 3 ? a : h;
  const T* y = gates + size_t(p < 3 ? p : (p < 5 ? p - 3 : 2)) * n_elems;
  const int row0 = (threadIdx.x >> 5) * 16;
  float acc[kNT][4];
  zero_acc(acc);
  const int b_end = min(n_blocks, (chunk + 1) * kWideBlocksPerChunk);
  for (int b = chunk * kWideBlocksPerChunk; b < b_end; ++b) {
    const size_t base = size_t(b) * kRows * D;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kRows * kD; idx += kThreads) {
      const int k = idx / kD, m = idx % kD;
      const size_t ix = base + size_t(k) * D + mi * kD + m;
      const size_t iy = base + size_t(k) * D + ni * kD + m;
      A_s[m * ld + k] =
          p == 5 ? from_f<T>(to_f(r[ix]) * to_f(h[ix])) : x[ix];
      B_s[m * ld + k] = y[iy];
    }
    __syncthreads();
    warp_gemm(acc, A_s + row0 * ld, B_s);
  }
  float* out = ws + (size_t(chunk) * 6 + p) * D * D;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[size_t(mi * kD + row0 + frag_row(e)) * D + ni * kD +
          frag_col(nt, e)] = acc[nt][e];
}

// The chunk partials and db's block partials summed in a fixed order.
__global__ void gru_wide_bwd_reduce_kernel(
    const float* __restrict__ ws, const float* __restrict__ dbp, int n_chunks,
    int n_blocks, int D, float* __restrict__ dwa, float* __restrict__ db,
    float* __restrict__ duzr, float* __restrict__ duh) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long tile = (long long)D * D;
  if (idx < 6 * tile) {
    const int p = int(idx / tile);
    const long long rem = idx % tile;
    const int m = int(rem / D), n = int(rem % D);
    float s = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch)
      s += ws[(size_t(ch) * 6 + p) * tile + rem];
    if (p < 3)
      dwa[size_t(m) * 3 * D + p * D + n] = s;
    else if (p < 5)
      duzr[size_t(m) * 2 * D + (p - 3) * D + n] = s;
    else
      duh[size_t(m) * D + n] = s;
  } else if (idx < 6 * tile + 3 * D) {
    const int j = int(idx - 6 * tile);
    float s = 0.0f;
    for (int b = 0; b < n_blocks; ++b) s += dbp[size_t(b) * 3 * D + j];
    db[j] = s;
  }
}

template <typename T>
static int launch_gru_wide_fwd(const void* h, const void* a, const void* wa,
                               const void* b3, const void* uzr, const void* uh,
                               int P, void* rh, void* out_h, void* z, void* r,
                               void* ht, int n_blocks, cudaStream_t stream) {
  const size_t smem = 2 * Smem<T>::tile;
  cudaError_t err = cudaFuncSetAttribute(
      gru_wide_fwd_kernel<T, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  gru_wide_fwd_kernel<T, true><<<n_blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(a),
      static_cast<const T*>(wa), static_cast<const float*>(b3),
      static_cast<const T*>(uzr), static_cast<const T*>(uh), P,
      static_cast<T*>(rh), static_cast<float*>(out_h), static_cast<T*>(z),
      static_cast<T*>(r), static_cast<T*>(ht));
  return int(cudaGetLastError());
}

template <typename T, typename TD>
static int launch_gru_wide_bwd(const void* g, const void* h, const void* a,
                               const void* z, const void* r, const void* ht,
                               const void* wa, const void* uzr, const void* uh,
                               int P, void* dh, void* da, void* gates,
                               void* dbp, void* ws, void* dwa, void* db,
                               void* duzr, void* duh, int n_blocks,
                               cudaStream_t stream) {
  const int D = P * kD;
  const size_t n_elems = size_t(n_blocks) * kRows * D;
  // P > 2: db's warp sums go to ws (n_blocks·3·P·8·128 floats, which the
  // wrapper sizes it for), which the params kernel overwrites afterwards
  float* red_g = P > kSmemRedPanels ? static_cast<float*>(ws) : nullptr;
  const size_t smem_rows =
      2 * Smem<T>::tile +
      (red_g ? 0 : size_t(3) * P * 8 * kD * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gru_wide_bwd_rows_kernel<T, TD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_rows));
  if (err != cudaSuccess) return int(err);
  gru_wide_bwd_rows_kernel<T, TD><<<n_blocks, kThreads, smem_rows, stream>>>(
      static_cast<const float*>(g), static_cast<const T*>(h),
      static_cast<const T*>(z), static_cast<const T*>(r),
      static_cast<const T*>(ht), static_cast<const T*>(wa),
      static_cast<const T*>(uzr), static_cast<const T*>(uh), P,
      static_cast<float*>(dh), static_cast<TD*>(da), static_cast<T*>(gates),
      static_cast<float*>(dbp), red_g, n_elems);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int n_chunks =
      (n_blocks + kWideBlocksPerChunk - 1) / kWideBlocksPerChunk;
  const size_t smem_par = 2 * Smem<T>::tile;
  err = cudaFuncSetAttribute(gru_wide_bwd_params_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_par));
  if (err != cudaSuccess) return int(err);
  gru_wide_bwd_params_kernel<T>
      <<<dim3(n_chunks, 6, P * P), kThreads, smem_par, stream>>>(
          static_cast<const T*>(h), static_cast<const T*>(a),
          static_cast<const T*>(r), static_cast<const T*>(gates),
          static_cast<float*>(ws), n_blocks, P, n_elems);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const long long total = 6LL * D * D + 3 * D;
  gru_wide_bwd_reduce_kernel<<<int((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(dbp), n_chunks,
      n_blocks, D, static_cast<float*>(dwa), static_cast<float*>(db),
      static_cast<float*>(duzr), static_cast<float*>(duh));
  return int(cudaGetLastError());
}

}  // namespace ggnn

// The forward at D = 128·P: dtype 0 = float32, 1 = bfloat16 (weights, the
// gates z, r, h̃ and the r⊙h workspace rh [N, D]); h, a, out_h f32 [N, D];
// wa [D, 3D], b3 [3D] f32, uzr [D, 2D], uh [D, D].  Returns the
// cudaError_t of the launch.
extern "C" int ggnn_gru_cell_wide(int dtype, int P, const void* h,
                                  const void* a, const void* wa,
                                  const void* b3, const void* uzr,
                                  const void* uh, void* rh, void* out_h,
                                  void* z, void* r, void* ht, int n_blocks,
                                  void* stream) {
  if (n_blocks <= 0) return 0;
  if (P <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return ggnn::launch_gru_wide_fwd<__nv_bfloat16>(
        h, a, wa, b3, uzr, uh, P, rh, out_h, z, r, ht, n_blocks, s);
  if (dtype == 0)
    return ggnn::launch_gru_wide_fwd<float>(h, a, wa, b3, uzr, uh, P, rh,
                                            out_h, z, r, ht, n_blocks, s);
  return int(cudaErrorInvalidValue);
}

// Split-K chunks of the backward's workspace ws [n_chunks, 6, D, D] f32.
extern "C" int ggnn_gru_wide_bwd_chunks(int n_blocks) {
  return (n_blocks + ggnn::kWideBlocksPerChunk - 1) /
         ggnn::kWideBlocksPerChunk;
}

// The backward at D = 128·P, the arguments of ggnn_gru_cell_bwd with
// gates [3, N, D] in the dtype, dbp [n_blocks, 3D] and the outputs at D.
extern "C" int ggnn_gru_cell_bwd_wide(int dtype, int da_narrow, int P,
                                      const void* g, const void* h,
                                      const void* a, const void* z,
                                      const void* r, const void* ht,
                                      const void* wa, const void* uzr,
                                      const void* uh, void* dh, void* da,
                                      void* gates, void* dbp, void* ws,
                                      void* dwa, void* db, void* duzr,
                                      void* duh, int n_blocks, void* stream) {
  if (n_blocks <= 0) return 0;
  if (P <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GGNN_LAUNCH(T, TD)                                                   \
  return ggnn::launch_gru_wide_bwd<T, TD>(g, h, a, z, r, ht, wa, uzr, uh, P, \
                                          dh, da, gates, dbp, ws, dwa, db,   \
                                          duzr, duh, n_blocks, s)
  if (dtype == 1 && da_narrow) GGNN_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 1) GGNN_LAUNCH(__nv_bfloat16, float);
  if (dtype == 0) GGNN_LAUNCH(float, float);
#undef GGNN_LAUNCH
  return int(cudaErrorInvalidValue);
}
