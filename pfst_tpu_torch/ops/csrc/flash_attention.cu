// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels that tools/attn_microbench.py::flash
// reaches through jax.experimental.pallas.ops.tpu.flash_attention (jax
// 0.9.0): the forward (_flash_attention_impl, pallas_call at :758), dK/dV
// (_flash_attention_bwd_dkv, :1121) and dQ (_flash_attention_bwd_dq,
// :1456), for the case the port runs: non-causal, no segment ids, with
// or without the library's additive bias ab (flash_attention.py:144).
//
//   forward:  O = softmax(S) V with S = (Q K^T + ab) * scale, and per query
//             row LSE = max_j S + log sum_j exp(S - max_j S)   (fp32)
//   backward: P = exp(S - LSE), Di = rowsum(dO * O)  (computed by the caller,
//             as the library computes it in XLA), dS = P * (dO V^T - Di),
//             dV = P^T dO, dK = (dS scale)^T Q, dQ = (dS scale) K, and
//             dab = dS scale in fp32 (the dQ kernel, where the library's
//             dQ kernel writes it, flash_attention.py:1243-1253)
//
// q, k, v, dO are (B, H, N, D) fp32 or bf16 with a contiguous last
// dimension, base addresses and batch, head and row strides that are
// multiples of 16 bytes (cp.async moves 16-byte chunks, TMA wants 16-byte
// aligned bases and strides; the wrapper copies a tensor that breaks
// this); O, dQ, dK, dV are written with the strides the caller gives, in
// the input type; LSE and Di are (B, H, N) fp32, contiguous. D is 32, 64
// or 128. ab (optional, null for none) and dab (the dQ kernel's, optional)
// are (B, H, N, N) fp32 with a contiguous last dimension, read and written
// through their own batch, head and row strides (a batch stride of 0
// serves one bias to every batch). Every kernel adds ab[row, key] to the
// accumulator element that holds that query row and key, with plain
// loads in the accumulators' layout (in dK/dV, whose accumulators are
// indexed by key row, down a column of ab). Each kernel is a template on
// kBias: without a bias the launch takes the instantiation that has none
// of this code, the kernels as they were before it, and their results.
// ab adds 4 N^2 bytes a (b, h) to each kernel's reads and dab as many to
// dQ's writes: at the BEiT's N = 1601 that makes the bf16 kernels bound
// by bytes.
//
// What bounds it: the forward does 4*B*H*N^2*D flops on B*H*N*(4D) values
// (N/2 flops per byte at D = 64, fp32), the backward 10*B*H*N^2*D, so at
// the ViT's N = 1025 every kernel is bound by arithmetic, not memory: by
// 989 TFLOP/s on the tensor cores for bf16, by 495 / 3 = 165 TFLOP/s for
// fp32 as 3xTF32.
//
// Two designs, chosen by input type and kernel:
//
// * dQ in both types, and the bf16 forward and dK/dV
//   (flash_bwd_dq_wgmma_kernel, flash_fwd_wgmma_kernel,
//   flash_bwd_dkv_wgmma_kernel, sm_90a): warpgroup products (wgmma) from
//   tiles that TMA copies into swizzled shared memory, a producer
//   warpgroup feeding consumer warpgroups through an mbarrier ring (the
//   sections below say more). Only wgmma reaches the card's full bf16
//   and TF32 rates; TMA takes the copies off the consumers' issue slots.
// * fp32 forward and dK/dV (flash_fwd_kernel, flash_bwd_dkv_kernel):
//   warp products (mma.sync, mma.cuh). A block of 4 warps owns 64 rows of
//   one (b, h): query rows in the forward, key rows in dK/dV, 16 per warp.
//   The other side's rows stream through a two-stage cp.async ring in
//   shared memory, in the input type: the copy of tile t + 1 is issued
//   before the arithmetic on tile t.
//
// Both: rows at or past N are zero-filled by the copies and their scores
// masked (-inf in the forward, P = 0 in the backward), so N need not be a
// multiple of a tile (N = 1025: the last tile holds one key); such rows of
// the block's own are never written. Blocks own disjoint outputs, so no
// kernel uses atomics and every result is deterministic.
// * Forward: S = Q K^T lands in accumulators, where the online softmax
//   runs (row max and sum over a lane quad by two shuffles each). P =
//   exp(S - m) is rounded to the input type, as the TPU kernel does
//   (p.astype(v.dtype)), and fed from the accumulators straight into P V
//   as the A operand; the row sum l is taken over the unrounded P. O =
//   acc / l in the input type, LSE fp32.
// * dK/dV: keys are the M side of every product, so S^T = K Q^T and
//   dP^T = V dO^T land in accumulators indexed by key row: P^T = exp(S^T -
//   LSE) (0 past N), dS^T s = P^T (dP^T - Di) s, both rounded to the input
//   type (the TPU kernel's p.T.astype, and ds.T.astype after its
//   ds * sm_scale) and reused in registers as the A operands of
//   dV += P^T dO and dK += (dS^T s) Q.
// * dQ: the forward's layout with two products per tile: S = Q K^T and
//   dP = dO V^T land in accumulators indexed by query row; dS s = P (dP -
//   Di) s is rounded to the input type (the TPU kernel's ds * sm_scale,
//   then ds.astype(k.dtype)) and fed from the accumulators into
//   dQ += (dS s) K as the A operand.
// fp32 input runs as 3xTF32 (mma.cuh; in dQ tf32 wgmma), where every
// operand, and P, P^T, dS s and dS^T s, is split into hi and lo parts
// instead of rounded: accurate to fp32.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <type_traits>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps, 16 rows each
constexpr int kRows = 64;      // rows a block owns
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// batch, head and row strides (elements) of up to six tensors, then of
// ab (slot kAb) and dab (slot kDab)
constexpr int kAb = 6, kDab = 7;
struct Strides {
  long long t[8][3];
};

// The bias rows of the lane's accumulator rows row and row + 8 of head
// (b, h) of t (ab or dab, by slot), or null where t is absent or the row
// lies at or past N.
template <typename T>
__device__ __forceinline__ void bias_rows(T* (&r)[2], T* t, const Strides& st,
                                          int slot, int b, int h, int row,
                                          int N) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    r[i] = t != nullptr && row + 8 * i < N
               ? t + b * st.t[slot][0] + h * st.t[slot][1] +
                     (row + 8 * i) * st.t[slot][2]
               : nullptr;
}

// ab + key, the head of the bias column of the lane's key rows key and
// key + 8 of head (b, h) (dK/dV), or null where ab is absent or the key
// lies at or past N.
__device__ __forceinline__ void bias_cols(const float* (&k)[2],
                                          const float* ab, const Strides& st,
                                          int b, int h, int key, int N) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    k[i] = ab != nullptr && key + 8 * i < N
               ? ab + b * st.t[kAb][0] + h * st.t[kAb][1] + key + 8 * i
               : nullptr;
}

// s[j][e] += ab[row][key] for the accumulators of rows g (e < 2), g + 8
// (r[0], r[1]) and keys c0 + 8 j + e % 2 before N (c0 = tile start + 2 t).
template <int NB>
__device__ __forceinline__ void add_bias(float (&s)[NB][4],
                                         const float* const (&r)[2], int c0,
                                         int N) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 8 * j + (e & 1);
      if (r[e >> 1] != nullptr && c < N) s[j][e] += r[e >> 1][c];
    }
}

// The same for dK/dV's transposed accumulators: rows are keys, columns
// queries, so element (key, query) adds ab[query][key], read down the
// column of each key (k[0], k[1]: ab + key; rs: ab's row stride).
template <int NB>
__device__ __forceinline__ void add_bias_t(float (&s)[NB][4],
                                           const float* const (&k)[2],
                                           long long rs, int c0, int N) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 8 * j + (e & 1);
      if (k[e >> 1] != nullptr && c < N) s[j][e] += k[e >> 1][c * rs];
    }
}

// dab[row][key] = ds[j][e] for the rows r[0], r[1] and keys before N.
template <int NB>
__device__ __forceinline__ void store_dab(const float (&ds)[NB][4],
                                          float* const (&r)[2], int c0,
                                          int N) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 8 * j + (e & 1);
      if (r[e >> 1] != nullptr && c < N) r[e >> 1][c] = ds[j][e];
    }
}

// Tile shapes of the mma.sync kernels (fp32 forward and dK/dV). A
// streamed tile holds 64 rows where a row is at most 128 bytes (fp32
// D = 32) and 32 rows otherwise, which keeps the forward's shared memory
// at 25-52 KB except D = 128 (101 KB), and dK/dV's at 31-70 KB except
// D = 128 (136 KB); it also bounds the accumulators (S and dP) that live
// in registers.
template <typename T, int D>
struct Tile {
  static constexpr int kLd = pfst::pitch<T, D>();
  static constexpr int kCols = D * sizeof(T) <= 128 ? 64 : 32;
};

template <typename T, int D>
constexpr size_t fwd_smem_bytes() {
  return (kRows + 4 * Tile<T, D>::kCols) * Tile<T, D>::kLd * sizeof(T);
}

template <typename T, int D, bool kBias>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse,
                     const float* __restrict__ ab, int H, int N,
                     float scale, Strides st) {
  using M = pfst::Mma<T>;
  constexpr int LD = Tile<T, D>::kLd;
  constexpr int KT = Tile<T, D>::kCols;  // keys per tile
  constexpr int NB = KT / 8;             // 8-key blocks of S
  constexpr int KS = D / M::kK;          // k-steps of Q K^T
  constexpr int PS = KT / M::kK;         // k-steps of P V
  constexpr int DB = D / 8;              // 8-column blocks of O
  extern __shared__ __align__(16) float smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [kRows][LD]
  T* ks = qs + kRows * LD;             // [2][KT][LD]  key ring
  T* vs = ks + 2 * KT * LD;            // [2][KT][LD]  value ring

  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const T* kb = k + b * st.t[1][0] + h * st.t[1][1];
  const T* vb = v + b * st.t[2][0] + h * st.t[2][1];
  const int tiles = (N + KT - 1) / KT;
  pfst::load_rows<T, D, kRows, kThreads>(
      qs, q + b * st.t[0][0] + h * st.t[0][1], st.t[0][2], row0, N);
  pfst::load_rows<T, D, KT, kThreads>(ks, kb, st.t[1][2], 0, N);
  pfst::load_rows<T, D, KT, kThreads>(vs, vb, st.t[2][2], 0, N);
  pfst::cp_async_commit();

  uint32_t qf[KS][4];
  float acc[DB][4] = {};
  float m[2] = {-INFINITY, -INFINITY};  // running max of S log2 e, rows g, g+8
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
  const float sl2 = scale * kLog2e;
  const float* abr[2];
  bias_rows(abr, ab, st, kAb, b, h, row0 + wr + (lane >> 2), N);
  for (int it = 0; it < tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < tiles) {
      const int next = (stage ^ 1) * KT * LD;
      pfst::load_rows<T, D, KT, kThreads>(ks + next, kb, st.t[1][2],
                                          (it + 1) * KT, N);
      pfst::load_rows<T, D, KT, kThreads>(vs + next, vb, st.t[2][2],
                                          (it + 1) * KT, N);
    }
    pfst::cp_async_commit();
    pfst::cp_async_wait<1>();  // tile it (and on it = 0 the query rows)
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        pfst::load_a<T, LD>(qf[kk], qs, wr, kk * M::kK, lane);
    }
    const T* kt = ks + stage * KT * LD;
    const T* vt = vs + stage * KT * LD;

    float s[NB][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const typename M::A a = M::a(qf[kk]);
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t bf[4];
        pfst::load_b<T, LD>(bf, kt, j * 8, kk * M::kK, lane);
        M::mma(s[j], a, bf[0], bf[1]);
        M::mma(s[j + 1], a, bf[2], bf[3]);
      }
    }

    // online softmax on the fragments: rows g (e < 2) and g + 8, keys
    // it KT + 8 j + 2 t + e % 2; the bias added first; keys past N masked
    const int c0 = it * KT + 2 * (lane & 3);
    if constexpr (kBias) add_bias(s, abr, c0, N);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = c0 + 8 * j + (e & 1) < N ? s[j][e] * sl2 : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the tile holds key it KT < N, so mn is finite and alpha is 0 on
      // the first tile (m = -inf), never NaN
      const float mn = fmaxf(m[i], pfst::quad_max(mt[i]));
      const float alpha = exp2f(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < DB; ++e) {
        acc[e][2 * i] *= alpha;
        acc[e][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }

    // O += P V, P from the accumulators
#pragma unroll
    for (int kc = 0; kc < PS; ++kc) {
      const typename M::A p = M::a_from_acc(s, kc);
#pragma unroll
      for (int e = 0; e < DB; e += 2) {
        uint32_t bf[4];
        M::template load_b_trans<LD>(bf, vt, kc * M::kK, e * 8, lane);
        M::mma(acc[e], p, bf[0], bf[1]);
        M::mma(acc[e + 1], p, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the stage is read; the next copy may overwrite it
  }

  T* ob = o + b * st.t[3][0] + h * st.t[3][1];
  float* lb = lse + (static_cast<long long>(b) * H + h) * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = pfst::quad_sum(l[i]);
    const int row = row0 + wr + (lane >> 2) + 8 * i;
    if (row < N) {
      const float inv = 1.f / li;
      T* orow = ob + row * st.t[3][2] + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < DB; ++e)
        pfst::store2(orow + 8 * e, acc[e][2 * i] * inv,
                     acc[e][2 * i + 1] * inv);
      if ((lane & 3) == 0) lb[row] = (m[i] + log2f(li)) * kLn2;
    }
  }
}

template <typename T, int D>
constexpr size_t dkv_smem_bytes() {
  return (2 * kRows + 4 * Tile<T, D>::kCols) * Tile<T, D>::kLd * sizeof(T) +
         4 * Tile<T, D>::kCols * sizeof(float);
}

template <typename T, int D, bool kBias>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di,
                         const float* __restrict__ ab, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int N, float scale,
                         Strides st) {
  using M = pfst::Mma<T>;
  constexpr int LD = Tile<T, D>::kLd;
  constexpr int QT = Tile<T, D>::kCols;  // query rows per tile
  constexpr int NB = QT / 8;             // 8-query blocks of S^T, dP^T
  constexpr int KS = D / M::kK;          // k-steps of K Q^T, V dO^T
  constexpr int PS = QT / M::kK;         // k-steps of P^T dO, (dS^T s) Q
  constexpr int DB = D / 8;              // 8-column blocks of dK, dV
  // K and V fragments stay in registers for the block's life where they
  // are small (bf16 up to D = 64, fp32 D = 32); else each tile re-reads
  // them from shared memory, which keeps the accumulators out of local
  // memory
  constexpr bool kHold = D * sizeof(T) <= 128;
  extern __shared__ __align__(16) float smem[];
  T* ks = reinterpret_cast<T*>(smem);  // [kRows][LD]  key rows
  T* vs = ks + kRows * LD;             // [kRows][LD]  value rows
  T* qs = vs + kRows * LD;             // [2][QT][LD]  query ring
  T* dos = qs + 2 * QT * LD;           // [2][QT][LD]  dO ring
  float* ls = reinterpret_cast<float*>(dos + 2 * QT * LD);  // [2][QT] LSE
  float* ds = ls + 2 * QT;                                  // [2][QT] Di

  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const T* qb = q + b * st.t[0][0] + h * st.t[0][1];
  const T* dob = dout + b * st.t[3][0] + h * st.t[3][1];
  const long long stat0 = (static_cast<long long>(b) * H + h) * N;
  const int tiles = (N + QT - 1) / QT;
  pfst::load_rows<T, D, kRows, kThreads>(
      ks, k + b * st.t[1][0] + h * st.t[1][1], st.t[1][2], row0, N);
  pfst::load_rows<T, D, kRows, kThreads>(
      vs, v + b * st.t[2][0] + h * st.t[2][1], st.t[2][2], row0, N);
  pfst::load_rows<T, D, QT, kThreads>(qs, qb, st.t[0][2], 0, N);
  pfst::load_rows<T, D, QT, kThreads>(dos, dob, st.t[3][2], 0, N);
  pfst::load_vec<QT>(ls, lse + stat0, 0, N);
  pfst::load_vec<QT>(ds, di + stat0, 0, N);
  pfst::cp_async_commit();

  uint32_t kf[kHold ? KS : 1][4], vf[kHold ? KS : 1][4];
  float dka[DB][4] = {}, dva[DB][4] = {};
  const float sl2 = scale * kLog2e;
  const float* abk[2];
  bias_cols(abk, ab, st, b, h, row0 + wr + (lane >> 2), N);
  for (int it = 0; it < tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < tiles) {
      const int next = (stage ^ 1) * QT;
      pfst::load_rows<T, D, QT, kThreads>(qs + next * LD, qb, st.t[0][2],
                                          (it + 1) * QT, N);
      pfst::load_rows<T, D, QT, kThreads>(dos + next * LD, dob, st.t[3][2],
                                          (it + 1) * QT, N);
      pfst::load_vec<QT>(ls + next, lse + stat0, (it + 1) * QT, N);
      pfst::load_vec<QT>(ds + next, di + stat0, (it + 1) * QT, N);
    }
    pfst::cp_async_commit();
    pfst::cp_async_wait<1>();  // tile it (and on it = 0 the key rows)
    __syncthreads();
    if constexpr (kHold) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          pfst::load_a<T, LD>(kf[kk], ks, wr, kk * M::kK, lane);
          pfst::load_a<T, LD>(vf[kk], vs, wr, kk * M::kK, lane);
        }
      }
    }
    const T* qt = qs + stage * QT * LD;
    const T* dot = dos + stage * QT * LD;
    const float* lt = ls + stage * QT;
    const float* dt = ds + stage * QT;

    float s[NB][4] = {}, dp[NB][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kr[4], vr[4];
      if constexpr (kHold) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kr[i] = kf[kk][i];
          vr[i] = vf[kk][i];
        }
      } else {
        pfst::load_a<T, LD>(kr, ks, wr, kk * M::kK, lane);
        pfst::load_a<T, LD>(vr, vs, wr, kk * M::kK, lane);
      }
      const typename M::A ka = M::a(kr);
      const typename M::A va = M::a(vr);
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t bf[4];
        pfst::load_b<T, LD>(bf, qt, j * 8, kk * M::kK, lane);
        M::mma(s[j], ka, bf[0], bf[1]);
        M::mma(s[j + 1], ka, bf[2], bf[3]);
        pfst::load_b<T, LD>(bf, dot, j * 8, kk * M::kK, lane);
        M::mma(dp[j], va, bf[0], bf[1]);
        M::mma(dp[j + 1], va, bf[2], bf[3]);
      }
    }

    // P^T and dS^T s on the fragments: key rows g, g + 8, query columns
    // 8 j + 2 t + e % 2 of the tile, the bias added first; queries past N
    // give P = 0. dS^T is scaled before a_from_acc rounds it, as the TPU
    // kernel scales ds before ds.T.astype
    const int c0 = 2 * (lane & 3);
    if constexpr (kBias) add_bias_t(s, abk, st.t[kAb][2], it * QT + c0, N);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 8 * j + (e & 1);
        const float p = it * QT + c < N
                            ? exp2f(s[j][e] * sl2 - lt[c] * kLog2e)
                            : 0.f;
        dp[j][e] = p * (dp[j][e] - dt[c]) * scale;
        s[j][e] = p;
      }

    // dV += P^T dO, dK += (dS^T s) Q
#pragma unroll
    for (int kc = 0; kc < PS; ++kc) {
      const typename M::A pa = M::a_from_acc(s, kc);
      const typename M::A sa = M::a_from_acc(dp, kc);
#pragma unroll
      for (int e = 0; e < DB; e += 2) {
        uint32_t bf[4];
        M::template load_b_trans<LD>(bf, dot, kc * M::kK, e * 8, lane);
        M::mma(dva[e], pa, bf[0], bf[1]);
        M::mma(dva[e + 1], pa, bf[2], bf[3]);
        M::template load_b_trans<LD>(bf, qt, kc * M::kK, e * 8, lane);
        M::mma(dka[e], sa, bf[0], bf[1]);
        M::mma(dka[e + 1], sa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the stage is read; the next copy may overwrite it
  }

  T* dkb = dk + b * st.t[4][0] + h * st.t[4][1];
  T* dvb = dv + b * st.t[5][0] + h * st.t[5][1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wr + (lane >> 2) + 8 * i;
    if (row < N) {
      T* dkr = dkb + row * st.t[4][2] + 2 * (lane & 3);
      T* dvr = dvb + row * st.t[5][2] + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < DB; ++e) {
        pfst::store2(dkr + 8 * e, dka[e][2 * i], dka[e][2 * i + 1]);
        pfst::store2(dvr + 8 * e, dva[e][2 * i], dva[e][2 * i + 1]);
      }
    }
  }
}

// ---- bf16 forward and dK/dV on wgmma + TMA (sm_90a) ----
//
// A block is one producer warpgroup and C consumer warpgroups. The
// producer gives its registers back (setmaxnreg.dec) and one of its
// threads keeps TMA loads in flight through a ring of tiles in shared
// memory (in dK/dV its warp's lanes also load LSE and Di): each
// stage has a full mbarrier (armed with the stage's bytes by expect_tx,
// completed by the TMA) and an empty one (one arrival per consumer
// thread once the stage is read). The consumers take the registers
// (setmaxnreg.inc), each owns 64 rows of the block's side, and runs its
// products as warpgroup wgmmas from the swizzled tiles (wgmma.cuh),
// waiting for each group before the arithmetic that reads it; dK/dV
// issues a tile's first products right behind the tile before's second
// ones. The accumulators keep mma.sync's m16n8 layout per warp, so the
// softmax, the masks, the roundings (Mma<bf16>::a_from_acc, which also
// forms the register A operand of the second product) and the stores are
// the mma.sync kernels'. Rows past N are zero-filled by TMA and masked as
// there.

// Consumer warpgroups a block. The forward runs one (two blocks an SM),
// dK/dV two (one block an SM): the faster count for each on the H100 at
// the ViT shapes (PERF.md, section 6); at one, dK/dV's four accumulators
// spill.
constexpr int kFwdWG = 1, kDkvWG = 2;

// Registers a thread after setmaxnreg: a block of 256 threads runs two to
// an SM (128 each at launch), one of 384 threads alone (168); the
// producer keeps 40 for its loop.
constexpr int kProducerRegs = 40;
template <int C>
__host__ __device__ constexpr int consumer_regs() {
  return C == 1 ? 216 : 232;
}

// Shared memory of the forward (byte offsets from a 1024-byte boundary):
// the block's query rows, then kStages key tiles, kStages value tiles and
// the barriers (Q full; per stage K full, V full, empty). At D = 128 and
// one consumer warpgroup (128 registers a thread) a tile holds 64 keys,
// which keeps S and P out of local memory. Two stages: a third measured
// within 3 % (PERF.md, section 6) and would take 32 KB more a block.
template <int D, int C>
struct FwdSmem {
  using T = __nv_bfloat16;
  static constexpr int kStages = 2;
  static constexpr int kRows = 64 * C;
  static constexpr int kKeys = C == 1 && D == 128 ? 64 : 128;  // a tile
  static constexpr int kK = pfst::tile_bytes<T, D, kRows>();
  static constexpr int kV = kK + kStages * pfst::tile_bytes<T, D, kKeys>();
  static constexpr int kBar = kV + kStages * pfst::tile_bytes<T, D, kKeys>();
  static constexpr int kBytes = kBar + (1 + 3 * kStages) * 8 + 1024;
};

template <int W, int M>
__device__ __forceinline__ float (&slice(float (&acc)[M][4], int r))[W / 8]
                                                                     [4] {
  return *reinterpret_cast<float(*)[W / 8][4]>(&acc[r * (W / 8)]);
}

template <int D, int C, bool kBias>
__global__ void __launch_bounds__(128 * (C + 1), C == 1 ? 2 : 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse,
                           const float* __restrict__ ab, int H, int N,
                           float scale, Strides st) {
  using T = __nv_bfloat16;
  using M = pfst::Mma<T>;
  using L = FwdSmem<D, C>;
  constexpr int kStages = L::kStages;
  constexpr int KT = L::kKeys;
  constexpr int NB = KT / 8;   // 8-key blocks of S
  constexpr int KS = D / 16;   // k-steps of Q K^T
  constexpr int PS = KT / 16;  // k-steps of P V
  constexpr int DB = D / 8;    // 8-column blocks of O
  constexpr int W = pfst::Atom<T, D>::kCols;
  constexpr int RG = pfst::Atom<T, D>::kRegions;
  constexpr int kTile = pfst::tile_bytes<T, D, KT>();
  extern __shared__ __align__(16) float smem[];
  char* base = pfst::smem_align(smem);
  T* qs = reinterpret_cast<T*>(base);
  T* ks = reinterpret_cast<T*>(base + L::kK);
  T* vs = reinterpret_cast<T*>(base + L::kV);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * L::kRows;
  const int tiles = (N + KT - 1) / KT;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    pfst::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      pfst::mbar_init(k_full + s, 1);
      pfst::mbar_init(v_full + s, 1);
      pfst::mbar_init(empty + s, 128 * C);
    }
    pfst::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    pfst::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      pfst::mbar_expect_tx(q_full, pfst::tile_bytes<T, D, L::kRows>());
      pfst::tma_tile<T, D, L::kRows>(qs, &tq, q_full, row0, h, b);
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kStages;
        pfst::mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        pfst::mbar_expect_tx(k_full + s, kTile);
        pfst::tma_tile<T, D, KT>(ks + s * KT * D, &tk, k_full + s, it * KT, h,
                              b);
        pfst::mbar_expect_tx(v_full + s, kTile);
        pfst::tma_tile<T, D, KT>(vs + s * KT * D, &tv, v_full + s, it * KT, h,
                              b);
      }
    }
    return;
  }

  pfst::setmaxnreg_inc<consumer_regs<C>()>();
  const int lane = threadIdx.x & 31;
  const int qr = (wg - 1) * 64;                   // the warpgroup's rows
  const int wr = qr + ((threadIdx.x >> 5) & 3) * 16;  // the warp's rows
  float acc[DB][4] = {};
  float m[2] = {-INFINITY, -INFINITY};  // running max of S log2 e, rows g, g+8
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
  const float sl2 = scale * kLog2e;
  const float* abr[2];
  bias_rows(abr, ab, st, kAb, b, h, row0 + wr + (lane >> 2), N);

  pfst::mbar_wait(q_full, 0);
  for (int it = 0; it < tiles; ++it) {
    const int s = it % kStages;
    const int phase = (it / kStages) & 1;
    const T* kt = ks + s * KT * D;
    const T* vt = vs + s * KT * D;

    // S = Q K^T, both K-major in shared memory
    float sc[NB][4];
    pfst::mbar_wait(k_full + s, phase);
    pfst::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      pfst::wgmma_ss<KT, 0>(sc, pfst::desc_k<T, D, L::kRows>(qs, qr, kk),
                            pfst::desc_k<T, D, KT>(kt, 0, kk), kk > 0);
    pfst::wgmma_commit();
    pfst::wgmma_wait<0>();
    pfst::fence_regs(sc);

    // online softmax on the fragments, as in flash_fwd_kernel (the bias
    // added first), with the scale folded into one FMA before 2^x; only
    // the last tile holds keys past N (masked to -inf)
    if constexpr (kBias) add_bias(sc, abr, it * KT + 2 * (lane & 3), N);
    if ((it + 1) * KT > N) {
      const int c0 = it * KT + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * j + (e & 1) >= N) sc[j][e] = -INFINITY;
    }
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], sc[j][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the tile holds key it KT < N, so mn is finite and alpha is 0 on
      // the first tile (m = -inf), never NaN
      const float mn = fmaxf(m[i], pfst::quad_max(mt[i]) * sl2);
      const float alpha = pfst::ex2(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < DB; ++e) {
        acc[e][2 * i] *= alpha;
        acc[e][2 * i + 1] *= alpha;
      }
    }
    uint32_t pa[PS][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = pfst::ex2(fmaf(sc[j][e], sl2, -m[e >> 1]));
        l[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int kc = 0; kc < PS; ++kc) {
      const M::A p = M::a_from_acc(sc, kc);
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kc][i] = p.r[i];
    }

    // O += P V: P from registers, V MN-major, one wgmma per region. (The
    // next tile's S issued behind it, as dK/dV does, keeps S, P and O
    // live at once: more than one warpgroup's 128 registers hold.)
    pfst::mbar_wait(v_full + s, phase);
    pfst::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < PS; ++kc)
#pragma unroll
      for (int r = 0; r < RG; ++r)
        pfst::wgmma_rs<W, 1>(slice<W>(acc, r), pa[kc],
                             pfst::desc_mn<D, KT>(vt, kc, r), 1);
    pfst::wgmma_commit();
    pfst::wgmma_wait<0>();
    pfst::fence_regs(acc);
    pfst::fence_regs(pa);
    pfst::mbar_arrive(empty + s);  // the stage is read
  }

  T* ob = o + b * st.t[3][0] + h * st.t[3][1];
  float* lb = lse + (static_cast<long long>(b) * H + h) * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = pfst::quad_sum(l[i]);
    const int row = row0 + wr + (lane >> 2) + 8 * i;
    if (row < N) {
      const float inv = 1.f / li;
      T* orow = ob + row * st.t[3][2] + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < DB; ++e)
        pfst::store2(orow + 8 * e, acc[e][2 * i] * inv,
                     acc[e][2 * i + 1] * inv);
      if ((lane & 3) == 0) lb[row] = (m[i] + log2f(li)) * kLn2;
    }
  }
}

// Shared memory of dK/dV: the block's key and value rows, then per stage
// a query tile, a dO tile, their LSE and Di, and the barriers (K/V full;
// per stage full, empty). TMA brings the tiles; the producer warp's
// lanes load LSE and Di (a row of N fp32 values has no 16-byte stride
// for a tensor map) and each arrives on the stage's full barrier. Query
// tiles of 32 rows at D = 128 keep the four accumulators (dK, dV 64
// registers each, S^T, dP^T) and the two A operands near the consumers'
// registers. Three stages: a tile's first products are issued while the
// tile before is still read, so two stages are in use at once, and the
// third lets the producer run a tile ahead (22-26 % faster at N >= 1024,
// PERF.md, section 6).
template <int D, int C>
struct DkvSmem {
  using T = __nv_bfloat16;
  static constexpr int kStages = 3;
  static constexpr int kRows = 64 * C;
  static constexpr int kQueries = D == 128 ? 32 : 64;  // per tile
  static constexpr int kV = pfst::tile_bytes<T, D, kRows>();
  static constexpr int kQ = kV + pfst::tile_bytes<T, D, kRows>();
  static constexpr int kO = kQ + kStages * pfst::tile_bytes<T, D, kQueries>();
  static constexpr int kL = kO + kStages * pfst::tile_bytes<T, D, kQueries>();
  static constexpr int kDi = kL + kStages * kQueries * 4;
  static constexpr int kBar = kDi + kStages * kQueries * 4;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

template <int D, int C, bool kBias>
__global__ void __launch_bounds__(128 * (C + 1), C == 1 ? 2 : 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ di,
                               const float* __restrict__ ab,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int H, int N,
                               float scale, Strides st) {
  using T = __nv_bfloat16;
  using M = pfst::Mma<T>;
  using L = DkvSmem<D, C>;
  constexpr int kStages = L::kStages;
  constexpr int QT = L::kQueries;
  constexpr int NB = QT / 8;   // 8-query blocks of S^T, dP^T
  constexpr int KS = D / 16;   // k-steps of K Q^T, V dO^T
  constexpr int PS = QT / 16;  // k-steps of P^T dO, (dS^T s) Q
  constexpr int DB = D / 8;    // 8-column blocks of dK, dV
  constexpr int W = pfst::Atom<T, D>::kCols;
  constexpr int RG = pfst::Atom<T, D>::kRegions;
  constexpr int kTile = pfst::tile_bytes<T, D, QT>();
  extern __shared__ __align__(16) float smem[];
  char* base = pfst::smem_align(smem);
  T* ks = reinterpret_cast<T*>(base);
  T* vs = reinterpret_cast<T*>(base + L::kV);
  T* qs = reinterpret_cast<T*>(base + L::kQ);
  T* dos = reinterpret_cast<T*>(base + L::kO);
  float* ls = reinterpret_cast<float*>(base + L::kL);  // LSE log2 e
  float* ds = reinterpret_cast<float*>(base + L::kDi);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * L::kRows;
  const int tiles = (N + QT - 1) / QT;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    pfst::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      pfst::mbar_init(full + s, 32);  // the producer warp's lanes
      pfst::mbar_init(empty + s, 128 * C);
    }
    pfst::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    pfst::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const long long stat0 = (static_cast<long long>(b) * H + h) * N;
      if (lane == 0) {
        pfst::mbar_expect_tx(kv_full, 2 * pfst::tile_bytes<T, D, L::kRows>());
        pfst::tma_tile<T, D, L::kRows>(ks, &tk, kv_full, row0, h, b);
        pfst::tma_tile<T, D, L::kRows>(vs, &tv, kv_full, row0, h, b);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kStages;
        pfst::mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        for (int i = lane; i < QT; i += 32) {
          const int row = it * QT + i;
          ls[s * QT + i] = row < N ? lse[stat0 + row] * kLog2e : 0.f;
          ds[s * QT + i] = row < N ? di[stat0 + row] : 0.f;
        }
        if (lane == 0) {  // its arrival, with the tiles' bytes
          pfst::mbar_expect_tx(full + s, 2 * kTile);
          pfst::tma_tile<T, D, QT>(qs + s * QT * D, &tq, full + s, it * QT, h,
                                b);
          pfst::tma_tile<T, D, QT>(dos + s * QT * D, &tdo, full + s, it * QT,
                                h, b);
        } else {
          pfst::mbar_arrive(full + s);
        }
      }
    }
    return;
  }

  pfst::setmaxnreg_inc<consumer_regs<C>()>();
  const int lane = threadIdx.x & 31;
  const int kr = (wg - 1) * 64;                   // the warpgroup's keys
  const int wr = kr + ((threadIdx.x >> 5) & 3) * 16;  // the warp's keys
  float dka[DB][4] = {}, dva[DB][4] = {};
  const float sl2 = scale * kLog2e;
  const float* abk[2];
  bias_cols(abk, ab, st, b, h, row0 + wr + (lane >> 2), N);

  // S^T = K Q^T and dP^T = V dO^T, all K-major in shared memory, into sc
  // and dp; issued one tile ahead, right behind the dV and dK products of
  // the tile before
  float sc[NB][4], dp[NB][4];
  pfst::mbar_wait(kv_full, 0);
  pfst::mbar_wait(full, 0);
  pfst::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    pfst::wgmma_ss<QT, 0>(sc, pfst::desc_k<T, D, L::kRows>(ks, kr, kk),
                          pfst::desc_k<T, D, QT>(qs, 0, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    pfst::wgmma_ss<QT, 0>(dp, pfst::desc_k<T, D, L::kRows>(vs, kr, kk),
                          pfst::desc_k<T, D, QT>(dos, 0, kk), kk > 0);
  pfst::wgmma_commit();
  for (int it = 0; it < tiles; ++it) {
    const int s = it % kStages;
    const T* qt = qs + s * QT * D;
    const T* dot = dos + s * QT * D;
    const float* lt = ls + s * QT;
    const float* dt = ds + s * QT;
    pfst::wgmma_wait<0>();  // S^T and dP^T of this tile
    pfst::fence_regs(sc);
    pfst::fence_regs(dp);

    // P^T and dS^T s, as in flash_bwd_dkv_kernel (the bias added first),
    // the scale folded into one FMA before 2^x; only the last tile holds
    // queries past N (P = 0)
    if constexpr (kBias)
      add_bias_t(sc, abk, st.t[kAb][2], it * QT + 2 * (lane & 3), N);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 2 * (lane & 3) + 8 * j + (e & 1);
        const float p = pfst::ex2(fmaf(sc[j][e], sl2, -lt[c]));
        dp[j][e] = p * (dp[j][e] - dt[c]) * scale;
        sc[j][e] = p;
      }
    if ((it + 1) * QT > N) {
      const int c0 = it * QT + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * j + (e & 1) >= N) sc[j][e] = dp[j][e] = 0.f;
    }
    uint32_t pa[PS][4], sa[PS][4];
#pragma unroll
    for (int kc = 0; kc < PS; ++kc) {
      const M::A p = M::a_from_acc(sc, kc);
      const M::A d = M::a_from_acc(dp, kc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kc][i] = p.r[i];
        sa[kc][i] = d.r[i];
      }
    }

    // dV += P^T dO, dK += (dS^T s) Q: A from registers, dO and Q
    // MN-major; then the next tile's S^T and dP^T behind them
    pfst::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < PS; ++kc)
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        pfst::wgmma_rs<W, 1>(slice<W>(dva, r), pa[kc],
                             pfst::desc_mn<D, QT>(dot, kc, r), 1);
        pfst::wgmma_rs<W, 1>(slice<W>(dka, r), sa[kc],
                             pfst::desc_mn<D, QT>(qt, kc, r), 1);
      }
    pfst::wgmma_commit();
    if (it + 1 < tiles) {
      const int s1 = (it + 1) % kStages;
      pfst::mbar_wait(full + s1, ((it + 1) / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        pfst::wgmma_ss<QT, 0>(sc, pfst::desc_k<T, D, L::kRows>(ks, kr, kk),
                              pfst::desc_k<T, D, QT>(qs + s1 * QT * D, 0, kk),
                              kk > 0);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        pfst::wgmma_ss<QT, 0>(dp, pfst::desc_k<T, D, L::kRows>(vs, kr, kk),
                              pfst::desc_k<T, D, QT>(dos + s1 * QT * D, 0, kk),
                              kk > 0);
      pfst::wgmma_commit();
      pfst::wgmma_wait<1>();  // dV and dK of this tile
    } else {
      pfst::wgmma_wait<0>();
    }
    pfst::fence_regs(dka);
    pfst::fence_regs(dva);
    pfst::fence_regs(pa);
    pfst::fence_regs(sa);
    pfst::mbar_arrive(empty + s);  // the stage is read
  }

  T* dkb = dk + b * st.t[4][0] + h * st.t[4][1];
  T* dvb = dv + b * st.t[5][0] + h * st.t[5][1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wr + (lane >> 2) + 8 * i;
    if (row < N) {
      T* dkr = dkb + row * st.t[4][2] + 2 * (lane & 3);
      T* dvr = dvb + row * st.t[5][2] + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < DB; ++e) {
        pfst::store2(dkr + 8 * e, dka[e][2 * i], dka[e][2 * i + 1]);
        pfst::store2(dvr + 8 * e, dva[e][2 * i], dva[e][2 * i + 1]);
      }
    }
  }
}

// ---- dQ on wgmma + TMA, bf16 and fp32 (as 3xTF32) (sm_90a) ----
//
// The dK/dV kernel's block with the queries as the block's side: one
// producer warpgroup and C consumer warpgroups of 64 query rows each. TMA
// brings the block's Q and dO rows once and streams K and V tiles through
// a ring of stages (full / empty mbarriers); each consumer loads the LSE
// and Di of its own rows once into registers. Per tile a consumer runs
// S = Q K^T and dP = dO V^T (shared x shared, all K-major), forms
// dS s = P (dP - Di) s on the accumulators (P = 0 for keys past N, on the
// last tile only), and runs dQ += (dS s) K with dS s as the register A
// operand; the next tile's S and dP are issued right behind it.
//
// * bf16: dS s is rounded to bf16 after its scale (Mma<bf16>::a_from_acc;
//   the TPU kernel's ds * sm_scale, then ds.astype(k.dtype)) and K is
//   read MN-major (desc_mn), as dK/dV reads Q.
// * fp32, 3xTF32: tf32 wgmma takes no transpose, so every shared operand
//   is K-major and dQ's K must be held transposed (keys along a row). TMA
//   cannot transpose, so the producer warpgroup's warps 1-3 (the split
//   warps) rewrite each K and V tile once it lands: every fp32 x becomes
//   hi = tf32(x) (to nearest, in place) and lo = tf32(x - hi) (a tile of
//   its own), as Mma<float>::split takes them, and K's hi and lo are also
//   written transposed (K^T hi, K^T lo). Each consumer warp splits its own
//   rows of Q and dO once: hi in place, lo into registers, the A operand
//   of the lo hi products (which saves 32 KB of shared memory per 64 rows
//   and, at N = KT, two thirds of those products' shared-memory reads).
//   Generic stores that wgmma reads next need fence.proxy.async before
//   the mbarrier arrival that the readers wait on. Each product is then
//   lo hi + hi lo + hi hi, accumulated in fp32, as Mma<float>::mma takes
//   it. dS s is split into hi and lo register A fragments straight from
//   the m16n8 accumulators: a tf32 A fragment wants k columns t and t + 4
//   where the accumulators hold keys 2 t and 2 t + 1, so column t stands
//   for key 2 t and t + 4 for 2 t + 1, and K^T's keys are written in the
//   same order (position (e / 2) + 4 (e % 2) for key e of each group of
//   8).
//
// Shared memory (bytes from a 1024-byte boundary): Q and dO (64 C rows
// each), then per stage K, V (bf16: 64 keys a tile, 32 at D = 128) and
// for fp32 also K lo, V lo, K^T hi, K^T lo, with 2048 / D keys a tile (a
// K^T row of 64 or 128 bytes, or two regions at D = 32): 48 KB a stage.
// As many stages as fit in 227 KB, at most three: bf16 three (C = 1: 64
// KB at D = 64); fp32 three (D = 64, C = 2: 64 KB + 3 x 48 KB = 208 KB;
// D = 128, C = 1: the same; D = 32, C = 2: 176 KB).

// Consumer warpgroups a block of dQ, bf16 and fp32 (fp32 D = 128 always
// runs one: its Q and dO lo parts take 128 registers a thread, which
// only a block of 256 threads alone on an SM can give), the faster
// counts on the H100 at the ViT shapes (PERF.md, section 6).
constexpr int kDqWG = 1, kDqWG32 = 2;

template <typename T, int D>
__host__ __device__ constexpr int dq_wg() {
  return sizeof(T) == 2 ? kDqWG : D == 128 ? 1 : kDqWG32;
}

template <typename T, int D, int C>
struct DqSmem {
  static constexpr bool kSplit = sizeof(T) == 4;  // 3xTF32 parts
  static constexpr int kRows = 64 * C;
  static constexpr int kKeys = kSplit ? 2048 / D : D == 128 ? 32 : 64;
  static constexpr int kRowTile = pfst::tile_bytes<T, D, kRows>();
  static constexpr int kKeyTile = pfst::tile_bytes<T, D, kKeys>();
  static constexpr int kQ = 0;
  static constexpr int kO = kRowTile;
  static constexpr int kRing = 2 * kRowTile;
  // a stage: K, V, then (fp32) K lo, V lo, K^T hi, K^T lo
  static constexpr int kStage = (kSplit ? 6 : 2) * kKeyTile;
  static constexpr int kMaxStages = 3;
  // Q and dO full, each consumer's rows split (two), per stage full,
  // split, empty
  static constexpr int kBarBytes = 8 * (3 + 3 * kMaxStages);
  static constexpr int kFit = (232448 - 1024 - kBarBytes - kRing) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kBytes = kBar + kBarBytes + 1024;
  static_assert(kStages >= 2, "DqSmem: two stages must fit");
};

__device__ __forceinline__ float4 as_float4(const uint32_t (&u)[4]) {
  return make_float4(__uint_as_float(u[0]), __uint_as_float(u[1]),
                     __uint_as_float(u[2]), __uint_as_float(u[3]));
}

// A consumer warp's split of its 16 rows r0 .. r0 + 15 of an fp32 R x D
// tile that TMA wrote: each element x of the lane's A fragments (k-step
// kk: rows g, g + 8, columns 8 kk + t, + 4) becomes hi = tf32(x) in place
// and lo = tf32(x - hi) in lo[kk], the register A operand of the lo hi
// product (Mma<float>::split).
template <int D, int R>
__device__ __forceinline__ void split_rows(float* tile,
                                           uint32_t (&lo)[D / 8][4], int r0,
                                           int lane) {
  char* base = reinterpret_cast<char*>(tile);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + (lane >> 2) + 8 * (i & 1);
      const int col = 8 * kk + (lane & 3) + 4 * (i >> 1);
      float* x = reinterpret_cast<float*>(
          base + pfst::tile_offset<float, D, R>(row, col));
      uint32_t hi;
      pfst::Mma<float>::split(*x, hi, lo[kk][i]);
      *reinterpret_cast<uint32_t*>(x) = hi;
    }
}

// Split warps: x = hi + lo (Mma<float>::split) for the 16-byte chunks
// i0, i0 + 96, ... of an fp32 tile of `bytes`: hi in place, lo at the
// same offset of `lo` (the same layout, so the swizzle does not matter).
__device__ __forceinline__ void split_tile(float* x, float* lo, int bytes,
                                           int i0) {
  for (int c = i0; c < bytes / 16; c += 96) {
    const float4 v = reinterpret_cast<float4*>(x)[c];
    const float e[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pfst::Mma<float>::split(e[i], h[i], l[i]);
    reinterpret_cast<float4*>(x)[c] = as_float4(h);
    reinterpret_cast<float4*>(lo)[c] = as_float4(l);
  }
}

// The same for a K tile (KT keys x D), whose hi and lo parts also go,
// transposed, into the D x KT tiles kth and ktl: key e of each group of
// 8 at position (e / 2) + 4 (e % 2) (the relabelled k of the A fragment).
template <int D, int KT>
__device__ __forceinline__ void split_keys(float* k, float* lo, float* kth,
                                           float* ktl, int i0) {
  using A = pfst::Atom<float, D>;
  constexpr int kRegion = KT * A::kBytes;
  char* th = reinterpret_cast<char*>(kth);
  char* tl = reinterpret_cast<char*>(ktl);
  for (int c = i0; c < KT * D / 4; c += 96) {
    // the chunk's key and first column, from its swizzled offset
    const int off = 16 * c;
    const int key = (off % kRegion) / A::kBytes;
    const int chunk = ((off % A::kBytes) >> 4) ^ (key & 7);
    const int col0 = (off / kRegion) * A::kCols + 4 * chunk;
    const int pos = (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2);
    const float4 v = reinterpret_cast<float4*>(k)[c];
    const float e[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pfst::Mma<float>::split(e[i], h[i], l[i]);
      const int t = pfst::tile_offset<float, KT, D>(col0 + i, pos);
      *reinterpret_cast<uint32_t*>(th + t) = h[i];
      *reinterpret_cast<uint32_t*>(tl + t) = l[i];
    }
    reinterpret_cast<float4*>(k)[c] = as_float4(h);
    reinterpret_cast<float4*>(lo)[c] = as_float4(l);
  }
}

// The tiles of stage s of dQ's ring (the last four fp32 only).
template <typename T, int D, int C>
struct DqStage {
  using L = DqSmem<T, D, C>;
  T* k;
  T* v;
  T* k_lo;
  T* v_lo;
  T* kt_hi;
  T* kt_lo;
  __device__ __forceinline__ DqStage(char* base, int s) {
    char* p = base + L::kRing + s * L::kStage;
    k = reinterpret_cast<T*>(p);
    v = reinterpret_cast<T*>(p + L::kKeyTile);
    k_lo = reinterpret_cast<T*>(p + 2 * L::kKeyTile);
    v_lo = reinterpret_cast<T*>(p + 3 * L::kKeyTile);
    kt_hi = reinterpret_cast<T*>(p + 4 * L::kKeyTile);
    kt_lo = reinterpret_cast<T*>(p + 5 * L::kKeyTile);
  }
};

// S = Q K^T into sc and dP = dO V^T into dp for the consumer's rows qr ..
// qr + 63 from stage t (asynchronous; the caller fences and commits):
// bf16 one product per k-step, fp32 three (lo hi + hi lo + hi hi, the lo
// parts of Q and dO from registers, ql and ol).
template <typename T, int D, int C, int NB, int LS>
__device__ __forceinline__ void dq_scores(float (&sc)[NB][4],
                                          float (&dp)[NB][4], const T* qs,
                                          const T* dos,
                                          const uint32_t (&ql)[LS][4],
                                          const uint32_t (&ol)[LS][4],
                                          const DqStage<T, D, C>& t, int qr) {
  using L = DqSmem<T, D, C>;
  constexpr int KT = L::kKeys;
  constexpr int KS = D / pfst::Atom<T, D>::kStep;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t q = pfst::desc_k<T, D, L::kRows>(qs, qr, kk);
    const uint64_t k = pfst::desc_k<T, D, KT>(t.k, 0, kk);
    if constexpr (L::kSplit) {
      pfst::wgmma_rs_tf32<KT>(sc, ql[kk], k, kk > 0);
      pfst::wgmma_ss_tf32<KT>(sc, q, pfst::desc_k<T, D, KT>(t.k_lo, 0, kk),
                              1);
      pfst::wgmma_ss_tf32<KT>(sc, q, k, 1);
    } else {
      pfst::wgmma_ss<KT, 0>(sc, q, k, kk > 0);
    }
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t o = pfst::desc_k<T, D, L::kRows>(dos, qr, kk);
    const uint64_t v = pfst::desc_k<T, D, KT>(t.v, 0, kk);
    if constexpr (L::kSplit) {
      pfst::wgmma_rs_tf32<KT>(dp, ol[kk], v, kk > 0);
      pfst::wgmma_ss_tf32<KT>(dp, o, pfst::desc_k<T, D, KT>(t.v_lo, 0, kk),
                              1);
      pfst::wgmma_ss_tf32<KT>(dp, o, v, 1);
    } else {
      pfst::wgmma_ss<KT, 0>(dp, o, v, kk > 0);
    }
  }
}

template <typename T, int D, int C, bool kBias>
// (bf16 with one consumer warpgroup: two blocks an SM; fp32's shared
// memory takes one SM)
__global__ void __launch_bounds__(128 * (C + 1),
                                  sizeof(T) == 2 && C == 1 ? 2 : 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              const float* __restrict__ ab,
                              T* __restrict__ dq, float* __restrict__ dab,
                              int H, int N, float scale, Strides st) {
  using L = DqSmem<T, D, C>;
  using S = DqStage<T, D, C>;
  constexpr bool kSplit = L::kSplit;
  constexpr int kStages = L::kStages;
  constexpr int KT = L::kKeys;
  constexpr int NB = KT / 8;                        // 8-key blocks of S, dP
  constexpr int PS = KT / pfst::Atom<T, D>::kStep;  // k-steps of (dS s) K
  constexpr int DB = D / 8;                         // 8-column blocks of dQ
  constexpr int W = pfst::Atom<T, D>::kCols;
  constexpr int RG = pfst::Atom<T, D>::kRegions;
  extern __shared__ __align__(16) float smem[];
  char* base = pfst::smem_align(smem);
  T* qs = reinterpret_cast<T*>(base + L::kQ);
  T* dos = reinterpret_cast<T*>(base + L::kO);
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* rows_split = qd_full + 1;  // one per consumer warpgroup
  uint64_t* full = rows_split + 2;
  uint64_t* split = full + kStages;
  uint64_t* empty = split + kStages;
  // what a consumer waits on before it reads a K, V tile: the TMA's
  // barrier, or for fp32 the split warps'
  uint64_t* ready = kSplit ? split : full;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * L::kRows;
  const int tiles = (N + KT - 1) / KT;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    pfst::mbar_init(qd_full, 1);
    for (int c = 0; c < C; ++c) pfst::mbar_init(rows_split + c, 128);
    for (int s = 0; s < kStages; ++s) {
      pfst::mbar_init(full + s, 1);
      pfst::mbar_init(split + s, 96);  // the split warps' threads
      pfst::mbar_init(empty + s, 128 * C);
    }
    pfst::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    pfst::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      pfst::mbar_expect_tx(qd_full, 2 * L::kRowTile);
      pfst::tma_tile<T, D, L::kRows>(qs, &tq, qd_full, row0, h, b);
      pfst::tma_tile<T, D, L::kRows>(dos, &tdo, qd_full, row0, h, b);
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kStages;
        const S t(base, s);
        pfst::mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        pfst::mbar_expect_tx(full + s, 2 * L::kKeyTile);
        pfst::tma_tile<T, D, KT>(t.k, &tk, full + s, it * KT, h, b);
        pfst::tma_tile<T, D, KT>(t.v, &tv, full + s, it * KT, h, b);
      }
    } else if constexpr (kSplit) {
      if (threadIdx.x >= 32) {  // the split warps
        const int i0 = threadIdx.x - 32;
        for (int it = 0; it < tiles; ++it) {
          const int s = it % kStages;
          const S t(base, s);
          pfst::mbar_wait(full + s, (it / kStages) & 1);
          split_keys<D, KT>(t.k, t.k_lo, t.kt_hi, t.kt_lo, i0);
          split_tile(t.v, t.v_lo, L::kKeyTile, i0);
          pfst::fence_proxy_async();
          pfst::mbar_arrive(split + s);
        }
      }
    }
    return;
  }

  pfst::setmaxnreg_inc<consumer_regs<C>()>();
  const int lane = threadIdx.x & 31;
  const int qr = (wg - 1) * 64;                       // the warpgroup's rows
  const int wr = qr + ((threadIdx.x >> 5) & 3) * 16;  // the warp's rows
  // LSE (times log2 e) and Di of the lane's rows g and g + 8
  const long long stat0 = (static_cast<long long>(b) * H + h) * N;
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wr + (lane >> 2) + 8 * i;
    lr[i] = row < N ? lse[stat0 + row] * kLog2e : 0.f;
    dr[i] = row < N ? di[stat0 + row] : 0.f;
  }
  float dqa[DB][4] = {};
  const float sl2 = scale * kLog2e;
  const float* abr[2];
  float* dabr[2];
  bias_rows(abr, ab, st, kAb, b, h, row0 + wr + (lane >> 2), N);
  bias_rows(dabr, dab, st, kDab, b, h, row0 + wr + (lane >> 2), N);

  // fp32: each warp splits its own rows of Q and dO, hi in place and lo
  // into registers; the warpgroup's wgmma reads all its 64 rows, so its
  // threads meet at their own mbarrier after the proxy fence
  uint32_t ql[kSplit ? D / 8 : 1][4], ol[kSplit ? D / 8 : 1][4];
  pfst::mbar_wait(qd_full, 0);
  if constexpr (kSplit) {
    split_rows<D, L::kRows>(qs, ql, wr, lane);
    split_rows<D, L::kRows>(dos, ol, wr, lane);
    pfst::fence_proxy_async();
    pfst::mbar_arrive(rows_split + wg - 1);
    pfst::mbar_wait(rows_split + wg - 1, 0);
  }

  // S and dP of tile 0; each later tile's are issued behind the dQ
  // product of the tile before
  float sc[NB][4], dp[NB][4];
  pfst::mbar_wait(ready, 0);
  pfst::wgmma_fence();
  dq_scores(sc, dp, qs, dos, ql, ol, S(base, 0), qr);
  pfst::wgmma_commit();
  for (int it = 0; it < tiles; ++it) {
    const int s = it % kStages;
    const S t(base, s);
    pfst::wgmma_wait<0>();  // S and dP of this tile
    pfst::fence_regs(sc);
    pfst::fence_regs(dp);

    // dS s on the fragments: query rows g, g + 8, keys it KT + 8 j + 2 t
    // + e % 2, the bias added first, the scale folded into one FMA before
    // 2^x; only the last tile holds keys past N (P = 0). dab = dS s in
    // fp32, before the rounding (bf16) or the split (fp32) that feeds the
    // dQ product, where the library's dQ kernel writes ds
    if constexpr (kBias) add_bias(sc, abr, it * KT + 2 * (lane & 3), N);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = pfst::ex2(fmaf(sc[j][e], sl2, -lr[e >> 1]));
        dp[j][e] = p * (dp[j][e] - dr[e >> 1]) * scale;
      }
    if ((it + 1) * KT > N) {
      const int c0 = it * KT + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * j + (e & 1) >= N) dp[j][e] = 0.f;
    }
    if constexpr (kBias) store_dab(dp, dabr, it * KT + 2 * (lane & 3), N);

    // dQ += (dS s) K, dS s from registers (fp32: hi in sa, lo in sl); then
    // the next tile's S and dP behind it
    uint32_t sa[PS][4], sl[kSplit ? PS : 1][4];
#pragma unroll
    for (int kc = 0; kc < PS; ++kc) {
      if constexpr (kSplit) {
        const float x[4] = {dp[kc][0], dp[kc][2], dp[kc][1], dp[kc][3]};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pfst::Mma<float>::split(x[i], sa[kc][i], sl[kc][i]);
      } else {
        const typename pfst::Mma<T>::A a = pfst::Mma<T>::a_from_acc(dp, kc);
#pragma unroll
        for (int i = 0; i < 4; ++i) sa[kc][i] = a.r[i];
      }
    }
    pfst::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < PS; ++kc) {
      if constexpr (kSplit) {
        const uint64_t hi = pfst::desc_k<T, KT, D>(t.kt_hi, 0, kc);
        pfst::wgmma_rs_tf32<D>(dqa, sl[kc], hi, 1);
        pfst::wgmma_rs_tf32<D>(dqa, sa[kc],
                               pfst::desc_k<T, KT, D>(t.kt_lo, 0, kc), 1);
        pfst::wgmma_rs_tf32<D>(dqa, sa[kc], hi, 1);
      } else {
#pragma unroll
        for (int r = 0; r < RG; ++r)
          pfst::wgmma_rs<W, 1>(slice<W>(dqa, r), sa[kc],
                               pfst::desc_mn<D, KT>(t.k, kc, r), 1);
      }
    }
    pfst::wgmma_commit();
    if (it + 1 < tiles) {
      const int s1 = (it + 1) % kStages;
      pfst::mbar_wait(ready + s1, ((it + 1) / kStages) & 1);
      dq_scores(sc, dp, qs, dos, ql, ol, S(base, s1), qr);
      pfst::wgmma_commit();
      pfst::wgmma_wait<1>();  // dQ of this tile
    } else {
      pfst::wgmma_wait<0>();
    }
    pfst::fence_regs(dqa);
    pfst::fence_regs(sa);
    if constexpr (kSplit) {
      pfst::fence_regs(sl);
      pfst::fence_regs(ql);
      pfst::fence_regs(ol);
    }
    pfst::mbar_arrive(empty + s);  // the stage is read
  }

  T* dqb = dq + b * st.t[4][0] + h * st.t[4][1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wr + (lane >> 2) + 8 * i;
    if (row < N) {
      T* dqr = dqb + row * st.t[4][2] + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < DB; ++e)
        pfst::store2(dqr + 8 * e, dqa[e][2 * i], dqa[e][2 * i + 1]);
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
  const float* ab;  // null: no bias
  void* out0;   // O, dK or dQ
  void* out1;   // dV
  float* lse_out;
  float* dab;   // null: not written
  int B, H, N;
  float scale;
  Strides st;
};

// cudaFuncSetAttribute for a kernel's dynamic shared memory, once per
// kernel instantiation (`done`, a static of the caller's) and device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int device,
                       std::atomic<unsigned long long>& done) {
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit)) {
    return cudaSuccess;
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// The wgmma kernels (bf16 forward and dK/dV): tensor maps of q, k, v (and
// dO), built on the host for each launch.
template <int D, bool kBias>
cudaError_t launch_wgmma(Kind kind, const Args& a, int device,
                         cudaStream_t stream) {
  using T = __nv_bfloat16;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if (kind == kForward) {
    using L = FwdSmem<D, kFwdWG>;
    const dim3 threads(128 * (kFwdWG + 1));
    static std::atomic<unsigned long long> done{0};
    const dim3 grid((a.N + L::kRows - 1) / L::kRows, a.H, a.B);
    err = pfst::bhnd_map<T, D, L::kRows>(&tq, a.q, a.B, a.H, a.N, a.st.t[0]);
    if (err == cudaSuccess)
      err = pfst::bhnd_map<T, D, L::kKeys>(&tk, a.k, a.B, a.H, a.N, a.st.t[1]);
    if (err == cudaSuccess)
      err = pfst::bhnd_map<T, D, L::kKeys>(&tv, a.v, a.B, a.H, a.N, a.st.t[2]);
    if (err == cudaSuccess)
      err = allow_smem(flash_fwd_wgmma_kernel<D, kFwdWG, kBias>, L::kBytes,
                       device,
                       done);
    if (err != cudaSuccess) return err;
    flash_fwd_wgmma_kernel<D, kFwdWG, kBias>
        <<<grid, threads, L::kBytes, stream>>>(
        tq, tk, tv, static_cast<T*>(a.out0), a.lse_out, a.ab, a.H, a.N,
        a.scale, a.st);
  } else {
    using L = DkvSmem<D, kDkvWG>;
    const dim3 threads(128 * (kDkvWG + 1));
    static std::atomic<unsigned long long> done{0};
    const dim3 grid((a.N + L::kRows - 1) / L::kRows, a.H, a.B);
    CUtensorMap tdo;
    err = pfst::bhnd_map<T, D, L::kQueries>(&tq, a.q, a.B, a.H, a.N, a.st.t[0]);
    if (err == cudaSuccess)
      err = pfst::bhnd_map<T, D, L::kRows>(&tk, a.k, a.B, a.H, a.N, a.st.t[1]);
    if (err == cudaSuccess)
      err = pfst::bhnd_map<T, D, L::kRows>(&tv, a.v, a.B, a.H, a.N, a.st.t[2]);
    if (err == cudaSuccess)
      err = pfst::bhnd_map<T, D, L::kQueries>(&tdo, a.dout, a.B, a.H, a.N,
                                           a.st.t[3]);
    if (err == cudaSuccess)
      err = allow_smem(flash_bwd_dkv_wgmma_kernel<D, kDkvWG, kBias>, L::kBytes,
                       device, done);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_wgmma_kernel<D, kDkvWG, kBias>
        <<<grid, threads, L::kBytes, stream>>>(
        tq, tk, tv, tdo, a.lse_in, a.di, a.ab, static_cast<T*>(a.out0),
        static_cast<T*>(a.out1), a.H, a.N, a.scale, a.st);
  }
  return cudaGetLastError();
}

// dQ, both types: tensor maps of q, k, v, dO, built on the host for each
// launch.
template <typename T, int D, bool kBias>
cudaError_t launch_dq(const Args& a, int device, cudaStream_t stream) {
  constexpr int C = dq_wg<T, D>();
  using L = DqSmem<T, D, C>;
  static std::atomic<unsigned long long> done{0};
  const dim3 grid((a.N + L::kRows - 1) / L::kRows, a.H, a.B);
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err =
      pfst::bhnd_map<T, D, L::kRows>(&tq, a.q, a.B, a.H, a.N, a.st.t[0]);
  if (err == cudaSuccess)
    err = pfst::bhnd_map<T, D, L::kKeys>(&tk, a.k, a.B, a.H, a.N, a.st.t[1]);
  if (err == cudaSuccess)
    err = pfst::bhnd_map<T, D, L::kKeys>(&tv, a.v, a.B, a.H, a.N, a.st.t[2]);
  if (err == cudaSuccess)
    err = pfst::bhnd_map<T, D, L::kRows>(&tdo, a.dout, a.B, a.H, a.N,
                                         a.st.t[3]);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_wgmma_kernel<T, D, C, kBias>, L::kBytes,
                     device,
                     done);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<T, D, C, kBias><<<grid, 128 * (C + 1), L::kBytes,
                                       stream>>>(
      tq, tk, tv, tdo, a.lse_in, a.di, a.ab, static_cast<T*>(a.out0), a.dab,
      a.H, a.N, a.scale, a.st);
  return cudaGetLastError();
}

// One launch: dQ and the bf16 forward and dK/dV on the wgmma kernels, the
// fp32 forward and dK/dV on the mma.sync kernels.
template <typename T, int D, bool kBias>
cudaError_t launch(Kind kind, const Args& a, int device,
                   cudaStream_t stream) {
  if (kind == kDq) return launch_dq<T, D, kBias>(a, device, stream);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_wgmma<D, kBias>(kind, a, device, stream);
  } else {
    const dim3 grid((a.N + kRows - 1) / kRows, a.H, a.B);
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    cudaError_t err;
    if (kind == kForward) {
      static std::atomic<unsigned long long> done{0};
      const size_t bytes = fwd_smem_bytes<T, D>();
      err = allow_smem(flash_fwd_kernel<T, D, kBias>, bytes, device, done);
      if (err != cudaSuccess) return err;
      flash_fwd_kernel<T, D, kBias><<<grid, kThreads, bytes, stream>>>(
          q, k, v, static_cast<T*>(a.out0), a.lse_out, a.ab, a.H, a.N,
          a.scale, a.st);
      return cudaGetLastError();
    }
    static std::atomic<unsigned long long> done{0};
    const size_t bytes = dkv_smem_bytes<T, D>();
    err = allow_smem(flash_bwd_dkv_kernel<T, D, kBias>, bytes, device, done);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<T, D, kBias><<<grid, kThreads, bytes, stream>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse_in, a.di, a.ab,
        static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.H, a.N, a.scale,
        a.st);
    return cudaGetLastError();
  }
}

template <typename T, bool kBias>
cudaError_t dispatch_d(Kind kind, int D, const Args& a, int device,
                       cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32, kBias>(kind, a, device, s);
    case 64: return launch<T, 64, kBias>(kind, a, device, s);
    case 128: return launch<T, 128, kBias>(kind, a, device, s);
    default: return cudaErrorInvalidValue;
  }
}

// Launch one kernel on `stream` on `device`, leaving the caller's current
// device as it was. `strides` holds n_tensors x (batch, head, row) strides,
// `bias_strides` those of ab and dab (may be null when both are).
int run(Kind kind, Args a, int D, const long long* strides, int n_tensors,
        const long long* bias_strides, int is_bf16, int device,
        void* stream) {
  if (a.B <= 0 || a.B > 65535 || a.H <= 0 || a.H > 65535 || a.N <= 0 ||
      strides == nullptr ||
      ((a.ab != nullptr || a.dab != nullptr) && bias_strides == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_tensors; ++i)
    for (int j = 0; j < 3; ++j) a.st.t[i][j] = strides[i * 3 + j];
  if (bias_strides != nullptr)
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 3; ++j)
        a.st.t[kAb + i][j] = bias_strides[i * 3 + j];
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // each kernel is built with and without the bias: without it, the
  // code of the kernels before the bias was added
  if (a.ab != nullptr || a.dab != nullptr)
    err = is_bf16 ? dispatch_d<__nv_bfloat16, true>(kind, D, a, device, s)
                  : dispatch_d<float, true>(kind, D, a, device, s);
  else
    err = is_bf16 ? dispatch_d<__nv_bfloat16, false>(kind, D, a, device, s)
                  : dispatch_d<float, false>(kind, D, a, device, s);
  const cudaError_t restored =
      prev != device ? cudaSetDevice(prev) : cudaSuccess;
  return static_cast<int>(err != cudaSuccess ? err : restored);
}

}  // namespace

// Forward: O (strides[9..11]) and LSE (B, H, N) fp32 from q, k, v
// (strides[0..8]) and the optional bias ab (null for none; its strides
// bias_strides[0..2]). Returns the cudaError_t of the launch; 0 means
// accepted.
extern "C" int pfst_flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const float* ab, int B, int H, int N, int D, const long long* strides,
    const long long* bias_strides, float scale, int is_bf16, int device,
    void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out0 = o;
  a.lse_out = lse;
  a.ab = ab;
  a.B = B;
  a.H = H;
  a.N = N;
  a.scale = scale;
  return run(kForward, a, D, strides, 4, bias_strides, is_bf16, device,
             stream);
}

// dK (strides[12..14]) and dV (strides[15..17]) from q, k, v, dO
// (strides[0..11]), the forward's LSE and Di = rowsum(dO * O), both
// (B, H, N) fp32, and the forward's ab (bias_strides[0..2]).
extern "C" int pfst_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, const float* ab, void* dk, void* dv,
    int B, int H, int N, int D, const long long* strides,
    const long long* bias_strides, float scale, int is_bf16, int device,
    void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.di = di;
  a.ab = ab;
  a.out0 = dk;
  a.out1 = dv;
  a.B = B;
  a.H = H;
  a.N = N;
  a.scale = scale;
  return run(kDkv, a, D, strides, 6, bias_strides, is_bf16, device, stream);
}

// dQ (strides[12..14]) from q, k, v, dO (strides[0..11]), LSE, Di and ab
// (bias_strides[0..2]); and dab = dS scale, fp32, where dab is not null
// (bias_strides[3..5]).
extern "C" int pfst_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, const float* ab, void* dq, float* dab,
    int B, int H, int N, int D, const long long* strides,
    const long long* bias_strides, float scale, int is_bf16, int device,
    void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.di = di;
  a.ab = ab;
  a.out0 = dq;
  a.dab = dab;
  a.B = B;
  a.H = H;
  a.N = N;
  a.scale = scale;
  return run(kDq, a, D, strides, 5, bias_strides, is_bf16, device, stream);
}

extern "C" const char* pfst_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
