// Warp tiles on the tensor cores for the flash-attention kernels: shared
// memory tiles filled by cp.async, operand fragments read by ldmatrix,
// and mma.sync in either input type.
//
// A warp computes a 16-row slab: d[j] += A B_j, A a 16 x k-step fragment,
// B_j the k-step x 8 block j. An accumulator d[j][4] holds, for lane l
// (g = l / 4, t = l % 4), rows g (d[j][0..1]) and g + 8 (d[j][2..3]),
// columns 8 j + 2 t and 8 j + 2 t + 1.
//
// Mma<T> is the product for one input type:
// * bf16: mma.m16n8k16, a k-step of 16, one product per step.
// * fp32: 3xTF32 on mma.m16n8k8, a k-step of 8. Each operand x is split
//   into hi = tf32(x) and lo = tf32(x - hi), and a b is taken as
//   lo_a hi_b + hi_a lo_b + hi_a hi_b, accumulated in fp32: about 2^-21
//   relative per product, against 2^-11 for one TF32 product.
// In bytes a k-step is 32 wide in both types, so the ldmatrix addressing
// is shared; only the B operand read transposed differs (ldmatrix.trans
// moves 16-bit elements, so fp32 reads it with scalar loads).
#pragma once
#include <cuda_bf16.h>

#include <cstdint>

#include "ptx.cuh"

namespace pfst {

// Row pitch (elements) of a tile of D-wide rows in shared memory. The
// 16 bytes of padding put row r at 16 (r * (D bytes / 16 + 1)) modulo
// 128 bytes: an odd multiple of 16, so the 8 rows of one ldmatrix phase
// fall into 8 distinct 16-byte bank groups. For fp32 the pitch is 4
// modulo 32 words, which keeps Mma<float>::load_b_trans's scalar loads
// free of bank conflicts as well.
template <typename T, int D>
__host__ __device__ constexpr int pitch() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// Rows row0 .. row0 + R - 1 of an (n, D) matrix with row stride rs
// (elements) into tile[R][pitch], 16 bytes per cp.async by the block's
// kThreads threads; rows at or past n are zero-filled. The source's base
// and row stride are multiples of 16 bytes (the wrapper sees to it).
template <typename T, int D, int R, int kThreads>
__device__ __forceinline__ void load_rows(T* tile, const T* src,
                                          long long rs, int row0, int n) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = D / kVec;  // per row
  for (int c = threadIdx.x; c < R * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int e = (c - r * kChunks) * kVec;
    const int row = row0 + r;
    const bool valid = row < n;
    cp_async16(tile + r * pitch<T, D>() + e, src + (valid ? row : 0) * rs + e,
               valid);
  }
}

// Elements row0 .. row0 + R - 1 of a length-n fp32 vector (zero past n),
// one thread each.
template <int R>
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int n) {
  const int i = threadIdx.x;
  if (i < R) {
    const bool valid = row0 + i < n;
    cp_async4(dst + i, src + (valid ? row0 + i : 0), valid);
  }
}

// The A fragment of rows r0 .. r0 + 15, k-step starting at element k0, of
// a row-major tile (Q in Q K^T, K in K Q^T): matrices (rows +0, +8) x
// (bytes +0, +16) of the k-step.
template <typename T, int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* tile,
                                       int r0, int k0, int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * LD + k0 +
                     (lane >> 4) * (16 / static_cast<int>(sizeof(T))));
}

// The B fragments of the n-blocks n0 (b[0..1]) and n0 + 8 (b[2..3]) for
// the k-step at k0, where the tile holds B transposed, one row per n (K
// in Q K^T, Q in K Q^T).
template <typename T, int LD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const T* tile,
                                       int n0, int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
                     ((lane >> 3) & 1) * (16 / static_cast<int>(sizeof(T))));
}

// Max and sum over the four lanes (one quad) that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static constexpr int kK = 16;  // k-step, elements
  struct A {
    uint32_t r[4];
  };

  __device__ static __forceinline__ A a(const uint32_t (&raw)[4]) {
    return A{{raw[0], raw[1], raw[2], raw[3]}};
  }

  // The A fragment of k-step kc from fp32 accumulators over the k
  // dimension (P from S): k-step kc is n-blocks 2 kc and 2 kc + 1, whose
  // layout is the A layout's; rounded to bf16 to nearest.
  template <int NB>
  __device__ static __forceinline__ A a_from_acc(const float (&s)[NB][4],
                                                 int kc) {
    return A{{pack(s[2 * kc][0], s[2 * kc][1]),
              pack(s[2 * kc][2], s[2 * kc][3]),
              pack(s[2 * kc + 1][0], s[2 * kc + 1][1]),
              pack(s[2 * kc + 1][2], s[2 * kc + 1][3])}};
  }

  // B fragments of the n-blocks n0, n0 + 8 for the k-step at k0, from a
  // tile that holds B row-major, one row per k (V in P V).
  template <int LD>
  __device__ static __forceinline__ void load_b_trans(
      uint32_t (&b)[4], const __nv_bfloat16* tile, int k0, int n0,
      int lane) {
    ldmatrix_x4_trans(b,
                      tile + (k0 + (lane & 15)) * LD + n0 + (lane >> 4) * 8);
  }

  __device__ static __forceinline__ void mma(float (&d)[4], const A& a,
                                             uint32_t b0, uint32_t b1) {
    mma_bf16_16816(d, a.r, b0, b1);
  }

 private:
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <>
struct Mma<float> {
  static constexpr int kK = 8;
  struct A {
    uint32_t hi[4], lo[4];
  };

  __device__ static __forceinline__ void split(float x, uint32_t& hi,
                                               uint32_t& lo) {
    hi = tf32_round(x);
    lo = tf32_round(x - __uint_as_float(hi));
  }

  __device__ static __forceinline__ A a(const uint32_t (&raw)[4]) {
    A x;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split(__uint_as_float(raw[i]), x.hi[i], x.lo[i]);
    return x;
  }

  // k-step kc is n-block kc. The m16n8k8 A layout wants columns t and
  // t + 4 where the accumulator holds 2 t and 2 t + 1, so the k index is
  // relabelled: column t stands for element 2 t, column t + 4 for 2 t + 1,
  // and load_b_trans reads B's rows in the same order. No shuffles.
  template <int NB>
  __device__ static __forceinline__ A a_from_acc(const float (&s)[NB][4],
                                                 int kc) {
    const uint32_t raw[4] = {
        __float_as_uint(s[kc][0]), __float_as_uint(s[kc][2]),
        __float_as_uint(s[kc][1]), __float_as_uint(s[kc][3])};
    return a(raw);
  }

  // B rows k0 + 2 t (b0) and k0 + 2 t + 1 (b1), column n0 + g and
  // n0 + 8 + g: the relabelled k of a_from_acc.
  template <int LD>
  __device__ static __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                                      const float* tile,
                                                      int k0, int n0,
                                                      int lane) {
    const float* p = tile + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
    b[0] = __float_as_uint(p[0]);
    b[1] = __float_as_uint(p[LD]);
    b[2] = __float_as_uint(p[8]);
    b[3] = __float_as_uint(p[LD + 8]);
  }

  __device__ static __forceinline__ void mma(float (&d)[4], const A& a,
                                             uint32_t b0, uint32_t b1) {
    uint32_t h0, l0, h1, l1;
    split(__uint_as_float(b0), h0, l0);
    split(__uint_as_float(b1), h1, l1);
    mma_tf32_1688(d, a.lo, h0, h1);
    mma_tf32_1688(d, a.hi, l0, l1);
    mma_tf32_1688(d, a.hi, h0, h1);
  }
};

}  // namespace pfst
