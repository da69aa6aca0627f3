// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels that tools/attn_microbench.py::flash
// reaches through jax.experimental.pallas.ops.tpu.flash_attention (jax
// 0.9.0): the forward (_flash_attention_impl, pallas_call at :758), dK/dV
// (_flash_attention_bwd_dkv, :1121) and dQ (_flash_attention_bwd_dq,
// :1456), for the case the port runs: non-causal, no bias, no segment ids.
//
//   forward:  O = softmax(S) V with S = (Q K^T) * scale, and per query row
//             LSE = max_j S + log sum_j exp(S - max_j S)   (fp32)
//   backward: P = exp(S - LSE), Di = rowsum(dO * O)  (computed by the caller,
//             as the library computes it in XLA), dS = P * (dO V^T - Di),
//             dV = P^T dO, dK = dS^T Q * scale, dQ = dS K * scale
//
// q, k, v, dO are (B, H, N, D) fp32 or bf16 with any batch, head and row
// strides and a contiguous last dimension; O, dQ, dK, dV are written with
// the strides the caller gives, in the input type; LSE and Di are (B, H, N)
// fp32, contiguous. D is 32, 64 or 128. Every product and sum is fp32 on
// the CUDA cores (no tensor cores, no TF32), so an fp32 input is held to
// the plain fp32 formula; a bf16 input is widened on load and P stays fp32.
//
// What bounds it: the forward does 4*B*H*N^2*D flops on B*H*N*(4D) values
// (N/2 flops per byte at D = 64, fp32), the backward 10*B*H*N^2*D, so at
// the ViT's N = 1025 every kernel is bound by arithmetic, not memory: on
// the CUDA cores by the 67 TFLOP/s fp32 peak, on the tensor cores (a later
// design: wgmma, TMA, warp specialisation) by 989 TFLOP/s bf16.
//
// Design. A block of 128 threads owns a tile of 64 rows: query rows in the
// forward and dQ kernels, key rows in dK/dV; it streams the other side's
// rows through shared memory in tiles (64 rows; 32 in dK/dV), so no block
// needs another's result: no atomics, and the result is deterministic.
// Thread t = 8 ty + tx owns rows 4 ty .. 4 ty + 3 of its block's tile and,
// of a streamed tile, the columns (j / 4) * 32 + 4 tx + j % 4; of the head
// dimension, the columns (e / 4) * 32 + 4 tx + e % 4. Tiles are kept in
// shared memory as fp32, transposed ([d][row]) where a thread reads four
// consecutive rows of one d, row-major ([row][d]) where it reads four
// consecutive d of one row, so every inner-loop read is one 16-byte load
// without bank conflicts. The forward keeps the online softmax (running
// max m and sum l, one per row) in registers; the eight threads of a row
// combine their maxima with warp shuffles. Rows at or past N are read as
// zero, their scores masked (-inf in the forward, P = 0 in the backward)
// and never written, so N need not be a multiple of a tile (N = 1025: the
// last tile holds one key).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // 16 row groups (ty) x 8 column groups (tx)
constexpr int kRows = 64;      // rows a block owns
constexpr int kCols = 64;      // streamed rows per tile, forward and dQ
constexpr int kBwdCols = 32;   // streamed query rows per tile, dK/dV
constexpr int kPad = 4;        // keeps 16-byte alignment of padded rows
constexpr int kRowsP = kRows + kPad;
constexpr int kBwdColsP = kBwdCols + kPad;

// batch, head and row strides (elements) of up to six tensors
struct Strides {
  long long t[6][3];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// column j of a thread's share of a tile (or of the head dimension)
__device__ __forceinline__ int col_of(int j, int tx) {
  return (j >> 2) * 32 + tx * 4 + (j & 3);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Rows row0 .. row0 + R - 1 of an (N, D) matrix with row stride rs into
// shared memory, widened to fp32: transposed (tr[d * (R + kPad) + r]) and/or
// row-major (rm[r * (D + kPad) + d]). Rows at or past n read as 0.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          long long rs, int row0, int n,
                                          float* tr, float* rm) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int row = row0 + r;
    const float v = row < n ? widen(src[row * rs + d]) : 0.f;
    if (tr != nullptr) tr[d * (R + kPad) + r] = v;
    if (rm != nullptr) rm[r * (D + kPad) + d] = v;
  }
}

template <int D>
constexpr int fwd_smem_floats() {
  return 2 * D * kRowsP + kCols * (D + kPad) + kCols * kRowsP;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int N, float scale,
                     Strides st) {
  constexpr int DP = D + kPad;
  constexpr int DC = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;               // [D][kRowsP]  query rows, transposed
  float* kt = qt + D * kRowsP;    // [D][kRowsP]  key rows, transposed
  float* vm = kt + D * kRowsP;    // [kCols][DP]  value rows
  float* pt = vm + kCols * DP;    // [kCols][kRowsP]  P, key-major

  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const T* kb = k + b * st.t[1][0] + h * st.t[1][1];
  const T* vb = v + b * st.t[2][0] + h * st.t[2][1];
  load_tile<T, D, kRows>(q + b * st.t[0][0] + h * st.t[0][1], st.t[0][2],
                         row0, N, qt, nullptr);

  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DC; ++e) acc[i][e] = 0.f;
  }

  for (int c0 = 0; c0 < N; c0 += kCols) {
    __syncthreads();  // the query tile is in; the last tile's reads are done
    load_tile<T, D, kCols>(kb, st.t[1][2], c0, N, kt, nullptr);
    load_tile<T, D, kCols>(vb, st.t[2][2], c0, N, nullptr, vm);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = ld4(qt + d * kRowsP + ty * 4);
      const float4 k0 = ld4(kt + d * kRowsP + tx * 4);
      const float4 k1 = ld4(kt + d * kRowsP + 32 + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax: scale, mask the keys past N, new running max
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = c0 + col_of(j, tx) < N ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      // the tile holds key c0 < N, so mn is finite and alpha is 0 on the
      // first tile (m = -inf), never NaN
      const float mn = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < DC; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        l[i] += s[i][j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      st4(pt + col_of(j, tx) * kRowsP + ty * 4, s[0][j], s[1][j], s[2][j],
          s[3][j]);
    __syncthreads();

    // O += P V
#pragma unroll 4
    for (int c = 0; c < kCols; ++c) {
      const float4 pa = ld4(pt + c * kRowsP + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < DC / 4; ++g) {
        const float4 va = ld4(vm + c * DP + g * 32 + tx * 4);
        const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g * 4 + e] = fmaf(pv[i], vv[e], acc[i][g * 4 + e]);
      }
    }
  }

  T* ob = o + b * st.t[3][0] + h * st.t[3][1];
  float* lb = lse + (static_cast<long long>(b) * H + h) * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = row0 + ty * 4 + i;
    if (row < N) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int e = 0; e < DC; ++e)
        narrow(ob + row * st.t[3][2] + col_of(e, tx), acc[i][e] * inv);
      if (tx == 0) lb[row] = m[i] + logf(l[i]);
    }
  }
}

// dK and dV of a block's 64 key rows, streaming the query rows in tiles of
// 32: per tile, S and dP (key rows x query rows), P and dS in shared
// memory (query-major), then dV += P^T dO and dK += dS^T Q.
template <int D>
constexpr int dkv_smem_floats() {
  return 2 * D * kRowsP + 2 * D * kBwdColsP + 2 * kBwdCols * (D + kPad) +
         2 * kBwdCols * kRowsP + 2 * kBwdCols;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int N, float scale,
                         Strides st) {
  constexpr int DP = D + kPad;
  constexpr int DC = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                     // [D][kRowsP]   key rows, transposed
  float* vt = kt + D * kRowsP;          // [D][kRowsP]   value rows, transposed
  float* qt = vt + D * kRowsP;          // [D][kBwdColsP] query rows, transposed
  float* dot = qt + D * kBwdColsP;      // [D][kBwdColsP] dO rows, transposed
  float* qm = dot + D * kBwdColsP;      // [kBwdCols][DP] query rows
  float* dom = qm + kBwdCols * DP;      // [kBwdCols][DP] dO rows
  float* ps = dom + kBwdCols * DP;      // [kBwdCols][kRowsP] P, query-major
  float* dss = ps + kBwdCols * kRowsP;  // [kBwdCols][kRowsP] dS, query-major
  float* lse_s = dss + kBwdCols * kRowsP;  // [kBwdCols]
  float* di_s = lse_s + kBwdCols;       // [kBwdCols]

  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const T* qb = q + b * st.t[0][0] + h * st.t[0][1];
  const T* dob = dout + b * st.t[3][0] + h * st.t[3][1];
  const long long stat0 = (static_cast<long long>(b) * H + h) * N;
  load_tile<T, D, kRows>(k + b * st.t[1][0] + h * st.t[1][1], st.t[1][2],
                         row0, N, kt, nullptr);
  load_tile<T, D, kRows>(v + b * st.t[2][0] + h * st.t[2][1], st.t[2][2],
                         row0, N, vt, nullptr);

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DC; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  for (int c0 = 0; c0 < N; c0 += kBwdCols) {
    __syncthreads();
    load_tile<T, D, kBwdCols>(qb, st.t[0][2], c0, N, qt, qm);
    load_tile<T, D, kBwdCols>(dob, st.t[3][2], c0, N, dot, dom);
    if (threadIdx.x < kBwdCols) {
      const int row = c0 + threadIdx.x;
      lse_s[threadIdx.x] = row < N ? lse[stat0 + row] : 0.f;
      di_s[threadIdx.x] = row < N ? di[stat0 + row] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 ka = ld4(kt + d * kRowsP + ty * 4);
      const float4 va = ld4(vt + d * kRowsP + ty * 4);
      const float4 qa = ld4(qt + d * kBwdColsP + tx * 4);
      const float4 da = ld4(dot + d * kBwdColsP + tx * 4);
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
      const float vv[4] = {va.x, va.y, va.z, va.w};
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float dv_[4] = {da.x, da.y, da.z, da.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dv_[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j;
      const bool valid = c0 + c < N;
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = valid ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
        ds[i] = p[i] * (dp[i][j] - di_s[c]);
      }
      st4(ps + c * kRowsP + ty * 4, p[0], p[1], p[2], p[3]);
      st4(dss + c * kRowsP + ty * 4, ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBwdCols; ++c) {
      const float4 pa = ld4(ps + c * kRowsP + ty * 4);
      const float4 sa = ld4(dss + c * kRowsP + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
#pragma unroll
      for (int g = 0; g < DC / 4; ++g) {
        const float4 oa = ld4(dom + c * DP + g * 32 + tx * 4);
        const float4 qa = ld4(qm + c * DP + g * 32 + tx * 4);
        const float ov[4] = {oa.x, oa.y, oa.z, oa.w};
        const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc_v[i][g * 4 + e] = fmaf(pv[i], ov[e], acc_v[i][g * 4 + e]);
            acc_k[i][g * 4 + e] = fmaf(sv[i], qv[e], acc_k[i][g * 4 + e]);
          }
      }
    }
  }

  T* dkb = dk + b * st.t[4][0] + h * st.t[4][1];
  T* dvb = dv + b * st.t[5][0] + h * st.t[5][1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row < N) {
#pragma unroll
      for (int e = 0; e < DC; ++e) {
        narrow(dkb + row * st.t[4][2] + col_of(e, tx), acc_k[i][e] * scale);
        narrow(dvb + row * st.t[5][2] + col_of(e, tx), acc_v[i][e]);
      }
    }
  }
}

// dQ of a block's 64 query rows, streaming the key rows in tiles of 64:
// per tile, S and dP (query rows x key rows), dS in shared memory
// (key-major), then dQ += dS K.
template <int D>
constexpr int dq_smem_floats() {
  return 4 * D * kRowsP + kCols * (D + kPad) + kCols * kRowsP;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, T* __restrict__ dq,
                        int H, int N, float scale, Strides st) {
  constexpr int DP = D + kPad;
  constexpr int DC = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;               // [D][kRowsP]  query rows, transposed
  float* dot = qt + D * kRowsP;   // [D][kRowsP]  dO rows, transposed
  float* kt = dot + D * kRowsP;   // [D][kRowsP]  key rows, transposed
  float* vt = kt + D * kRowsP;    // [D][kRowsP]  value rows, transposed
  float* km = vt + D * kRowsP;    // [kCols][DP]  key rows
  float* dst = km + kCols * DP;   // [kCols][kRowsP]  dS, key-major

  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const T* kb = k + b * st.t[1][0] + h * st.t[1][1];
  const T* vb = v + b * st.t[2][0] + h * st.t[2][1];
  load_tile<T, D, kRows>(q + b * st.t[0][0] + h * st.t[0][1], st.t[0][2],
                         row0, N, qt, nullptr);
  load_tile<T, D, kRows>(dout + b * st.t[3][0] + h * st.t[3][1], st.t[3][2],
                         row0, N, dot, nullptr);
  const long long stat0 = (static_cast<long long>(b) * H + h) * N;
  float lse_r[4], di_r[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    lse_r[i] = row < N ? lse[stat0 + row] : 0.f;
    di_r[i] = row < N ? di[stat0 + row] : 0.f;
#pragma unroll
    for (int e = 0; e < DC; ++e) acc[i][e] = 0.f;
  }

  for (int c0 = 0; c0 < N; c0 += kCols) {
    __syncthreads();
    load_tile<T, D, kCols>(kb, st.t[1][2], c0, N, kt, km);
    load_tile<T, D, kCols>(vb, st.t[2][2], c0, N, vt, nullptr);
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float4 qa = ld4(qt + d * kRowsP + ty * 4);
      const float4 oa = ld4(dot + d * kRowsP + ty * 4);
      const float4 k0 = ld4(kt + d * kRowsP + tx * 4);
      const float4 k1 = ld4(kt + d * kRowsP + 32 + tx * 4);
      const float4 v0 = ld4(vt + d * kRowsP + tx * 4);
      const float4 v1 = ld4(vt + d * kRowsP + 32 + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float ov[4] = {oa.x, oa.y, oa.z, oa.w};
      const float kv[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col_of(j, tx);
      const bool valid = c0 + c < N;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = valid ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds[i] = p * (dp[i][j] - di_r[i]);
      }
      st4(dst + c * kRowsP + ty * 4, ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kCols; ++c) {
      const float4 sa = ld4(dst + c * kRowsP + ty * 4);
      const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
#pragma unroll
      for (int g = 0; g < DC / 4; ++g) {
        const float4 ka = ld4(km + c * DP + g * 32 + tx * 4);
        const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g * 4 + e] = fmaf(sv[i], kv[e], acc[i][g * 4 + e]);
      }
    }
  }

  T* dqb = dq + b * st.t[4][0] + h * st.t[4][1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row < N) {
#pragma unroll
      for (int e = 0; e < DC; ++e)
        narrow(dqb + row * st.t[4][2] + col_of(e, tx), acc[i][e] * scale);
    }
  }
}

// which of the three kernels a launch runs
enum Kind { kForward = 0, kDkv = 1, kDq = 2 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* di;
  void* out0;   // O, dK or dQ
  void* out1;   // dV
  float* lse_out;
  int B, H, N;
  float scale;
  Strides st;
};

template <typename T, int D>
cudaError_t launch(Kind kind, const Args& a, cudaStream_t stream) {
  const dim3 grid((a.N + kRows - 1) / kRows, a.H, a.B);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (kind == kForward) {
    const size_t bytes = fwd_smem_floats<D>() * sizeof(float);
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
        q, k, v, static_cast<T*>(a.out0), a.lse_out, a.H, a.N, a.scale, a.st);
  } else if (kind == kDkv) {
    const size_t bytes = dkv_smem_floats<D>() * sizeof(float);
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
        q, k, v, dout, a.lse_in, a.di, static_cast<T*>(a.out0),
        static_cast<T*>(a.out1), a.H, a.N, a.scale, a.st);
  } else {
    const size_t bytes = dq_smem_floats<D>() * sizeof(float);
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
        q, k, v, dout, a.lse_in, a.di, static_cast<T*>(a.out0), a.H, a.N,
        a.scale, a.st);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Kind kind, int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(kind, a, s);
    case 64: return launch<T, 64>(kind, a, s);
    case 128: return launch<T, 128>(kind, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// Launch one kernel on `stream` on `device`, leaving the caller's current
// device as it was. `strides` holds n_tensors x (batch, head, row) strides.
int run(Kind kind, Args a, int D, const long long* strides, int n_tensors,
        int is_bf16, int device, void* stream) {
  if (a.B <= 0 || a.B > 65535 || a.H <= 0 || a.H > 65535 || a.N <= 0 ||
      strides == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_tensors; ++i)
    for (int j = 0; j < 3; ++j) a.st.t[i][j] = strides[i * 3 + j];
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? dispatch_d<__nv_bfloat16>(kind, D, a, s)
                : dispatch_d<float>(kind, D, a, s);
  const cudaError_t restored = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : restored);
}

}  // namespace

// Forward: O (strides[9..11]) and LSE (B, H, N) fp32 from q, k, v
// (strides[0..8]). Returns the cudaError_t of the launch; 0 means accepted.
extern "C" int pfst_flash_attention_forward(const void* q, const void* k,
                                            const void* v, void* o,
                                            float* lse, int B, int H, int N,
                                            int D, const long long* strides,
                                            float scale, int is_bf16,
                                            int device, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out0 = o;
  a.lse_out = lse;
  a.B = B;
  a.H = H;
  a.N = N;
  a.scale = scale;
  return run(kForward, a, D, strides, 4, is_bf16, device, stream);
}

// dK (strides[12..14]) and dV (strides[15..17]) from q, k, v, dO
// (strides[0..11]) and the forward's LSE and Di = rowsum(dO * O), both
// (B, H, N) fp32.
extern "C" int pfst_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, void* dk, void* dv, int B, int H,
    int N, int D, const long long* strides, float scale, int is_bf16,
    int device, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.di = di;
  a.out0 = dk;
  a.out1 = dv;
  a.B = B;
  a.H = H;
  a.N = N;
  a.scale = scale;
  return run(kDkv, a, D, strides, 6, is_bf16, device, stream);
}

// dQ (strides[12..14]) from q, k, v, dO (strides[0..11]), LSE and Di.
extern "C" int pfst_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, void* dq, int B, int H, int N, int D,
    const long long* strides, float scale, int is_bf16, int device,
    void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.di = di;
  a.out0 = dq;
  a.B = B;
  a.H = H;
  a.N = N;
  a.scale = scale;
  return run(kDq, a, D, strides, 5, is_bf16, device, stream);
}

extern "C" const char* pfst_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
