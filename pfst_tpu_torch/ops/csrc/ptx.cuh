// One inline-PTX wrapper per instruction that the tensor-core kernels use
// (built for sm_90a): asynchronous copies into shared memory, ldmatrix,
// and warp-level mma.sync in bf16 and TF32 (sm_80 and later); and
// Hopper's tensor copies (TMA), mbarriers, proxy fences, warpgroup
// products (wgmma, bf16 and TF32) and register reallocation (sm_90a).
// Fragment layouts are the PTX ISA's ("Matrix fragments for
// mma.m16n8k16 / mma.m16n8k8", "Register fragments and shared memory
// matrix layouts" of wgmma); mma.cuh builds the warp tiles from the first
// kind and wgmma.cuh the warpgroup tiles from the second.
#pragma once
#include <cuda.h>

#include <cstdint>

namespace pfst {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (the
// source is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 matrices of 16-bit elements; lanes 8i..8i+7 give the row
// addresses of matrix i, and lane l receives in r[i] the 32 bits at row
// l / 4, bytes 4 (l % 4) .. 4 (l % 4) + 3 of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, transposed: lane l receives elements (2 (l % 4), l / 4) and
// (2 (l % 4) + 1, l / 4) of matrix i, low half first.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: a 16x8 (row), b 8x8 (col), TF32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ uint32_t tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// ---- Hopper (sm_90a) ----

// mbarrier in shared memory: `count` arrivals complete a phase, once the
// bytes announced by expect_tx have landed too.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to the
// asynchronous proxy (TMA); before the block barrier that follows init.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also announces `bytes` more to land before the phase
// completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed. A phase that
// never completes (a fault in the kernel: bytes announced that no copy
// brings) traps after about 2^30 tries instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (tries == (1u << 30)) __trap();
  }
}

// TMA: the box of `map` at element coordinates (c0 innermost, ...) into
// shared memory at dst (zero-filled where it lies outside the tensor,
// swizzled as the map says); its bytes complete_tx on `bar`. One thread
// issues it. `map` is a __grid_constant__ kernel parameter.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 2^x, approximate (MUFU.EX2, flushing denormals to zero; about 2^-22
// relative), 0 for x = -inf.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Registers a warpgroup's threads may hold from here on (a multiple of 8
// in [24, 256]); all 128 threads of the warpgroup execute it.
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Orders this thread's earlier generic-proxy stores to shared memory
// before later asynchronous-proxy accesses (wgmma, TMA) ordered after it,
// e.g. through an mbarrier that the writer arrives on next.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Orders the warpgroup's register writes (accumulators, register A) before
// the wgmma that follows.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes in place for
// the compiler: no access moves across it (after wgmma_wait, before the
// next wgmma_fence).
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

#define PFST_ACC4(d, j) \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define PFST_ACC8(d, j) PFST_ACC4(d, j), PFST_ACC4(d, j + 1)
#define PFST_ACC16(d, j) \
  PFST_ACC4(d, j), PFST_ACC4(d, j + 1), PFST_ACC4(d, j + 2), \
      PFST_ACC4(d, j + 3)
#define PFST_REGS8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define PFST_REGS16 \
  PFST_REGS8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define PFST_REGS32                                                        \
  PFST_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
              "%27, %28, %29, %30, %31"
#define PFST_REGS64                                                        \
  PFST_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
              "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
              "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x N, fp32; accumulate ? d + A B : A B) with A (64 x 16) and B
// (16 x N) bf16 in shared memory, named by descriptors (wgmma.cuh). A is
// K-major; B is K-major (TransB = 0) or MN-major (TransB = 1). Asynchronous:
// d holds the result after wgmma_commit and wgmma_wait. Each warp w of the
// warpgroup holds rows 16 w .. 16 w + 15 of d as mma.sync's m16n8
// accumulators, one d[j] per 8 columns.
template <int N, int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a,
                                         uint64_t b, int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{" PFST_REGS16 "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : PFST_ACC16(d, 0)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TransB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" PFST_REGS32 "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : PFST_ACC16(d, 0), PFST_ACC16(d, 4)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TransB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" PFST_REGS64 "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : PFST_ACC16(d, 0), PFST_ACC16(d, 4), PFST_ACC16(d, 8),
          PFST_ACC16(d, 12)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TransB));
  }
}

// The same with A from registers: each warp gives its 16 rows of A as
// mma.m16n8k16's A fragment (a[0..3], bf16 pairs).
template <int N, int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  static_assert(N == 32 || N == 64, "wgmma_rs: N");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{" PFST_REGS16 "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : PFST_ACC16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(TransB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" PFST_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : PFST_ACC16(d, 0), PFST_ACC16(d, 4)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(TransB));
  }
}

// d (64 x N, fp32; accumulate ? d + A B : A B) with A (64 x 8) and B
// (8 x N) TF32 in shared memory, both K-major (tf32 wgmma has no
// transpose): each 32-bit input is read as TF32 (its top 19 bits), so the
// caller splits fp32 values into hi and lo parts (3xTF32). Asynchronous
// and laid out as wgmma_ss.
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[N / 8][4],
                                              uint64_t a, uint64_t b,
                                              int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "wgmma_ss_tf32: N");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{" PFST_REGS8 "}, %8, %9, p, 1, 1;\n}\n"
        : PFST_ACC8(d, 0)
        : "l"(a), "l"(b), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{" PFST_REGS16 "}, %16, %17, p, 1, 1;\n}\n"
        : PFST_ACC16(d, 0)
        : "l"(a), "l"(b), "r"(accumulate));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{" PFST_REGS32 "}, %32, %33, p, 1, 1;\n}\n"
        : PFST_ACC16(d, 0), PFST_ACC16(d, 4)
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{" PFST_REGS64 "}, %64, %65, p, 1, 1;\n}\n"
        : PFST_ACC16(d, 0), PFST_ACC16(d, 4), PFST_ACC16(d, 8),
          PFST_ACC16(d, 12)
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

// The same with A from registers: each warp gives its 16 rows of A as
// mma.m16n8k8's TF32 A fragment (a[0]: row g, column t; a[1]: row g + 8,
// column t; a[2], a[3]: the same rows, column t + 4; g = lane / 4,
// t = lane % 4).
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "wgmma_rs_tf32: N");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{" PFST_REGS8 "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : PFST_ACC8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{" PFST_REGS16 "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : PFST_ACC16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{" PFST_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : PFST_ACC16(d, 0), PFST_ACC16(d, 4)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{" PFST_REGS64 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : PFST_ACC16(d, 0), PFST_ACC16(d, 4), PFST_ACC16(d, 8),
          PFST_ACC16(d, 12)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
}

#undef PFST_ACC4
#undef PFST_ACC8
#undef PFST_ACC16
#undef PFST_REGS8
#undef PFST_REGS16
#undef PFST_REGS32
#undef PFST_REGS64

}  // namespace pfst
