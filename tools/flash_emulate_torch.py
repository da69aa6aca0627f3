#!/usr/bin/env python
"""Run the kernels of ``pfst_tpu_torch/ops/csrc`` that use shared memory,
warp collectives or the tensor cores on the CPU under an emulation of
CUDA: the flash-attention kernels (``flash_attention.cu``), without and
with the bias ``ab`` (``CASES``, ``CASES_AB``; the latter also two
launches bitwise equal), held to the plain versions with the limits of
``chip_smoke.py``'s phase 3c (``chip_smoke.flash_errors``), and the similarity forward and backward
(``neighborhood_sim.cu``), held with phase 3's and 3b's
(``chip_smoke.sim_errors``, ``chip_smoke.sim_bwd_errors``: against
autograd of the plain forward and the plain gather backward, and two
launches bitwise equal).

For a change to either source or its headers, before any run on a card
(needs ``g++`` with C++20; no ``nvcc``)::

    python3 tools/flash_emulate_torch.py
    python3 tools/flash_emulate_torch.py --only flash_attention --bias-only

How: the sources are copied into a temporary directory, where ``ptx.cuh``
(the inline-PTX wrappers) is replaced by C++ with the PTX ISA's semantics,
and a prelude stands in for the CUDA keywords and runtime. Each block runs
as one ``std::thread`` per CUDA thread: ``__syncthreads`` is a block
barrier, ``__syncwarp`` a warp barrier; a warp collective (shuffle,
``ldmatrix``, ``mma.sync``) publishes every lane's operands, meets at a
warp barrier, computes each lane's result from all lanes' operands, and
meets again. ``cp.async`` copies are queued per thread and done at the
``cp.async.wait_group`` that retires their group, so a read before its
wait sees stale data; shared memory starts as NaN, so a read of a slot
that no copy filled shows up. The TF32 product truncates its inputs to 10
mantissa bits, as the hardware reads them. Hopper's instructions: a
``cuda.h`` stand-in encodes tensor maps (checking what
``cuTensorMapEncodeTiled`` checks); a TMA box copy (zero past the
tensor, written through the 64/128-byte swizzle of the shared-memory
address) lands only when a thread waits on its mbarrier, which counts
arrivals and ``expect_tx`` bytes per phase; a ``wgmma`` (bf16, or TF32
read as its top 19 bits, with the ``m16n8k8`` register A fragment) reads
its shared-memory operands through the descriptor (start, leading and
stride offsets, swizzle; K- or MN-major B) at its issue and again at the
``wgmma.wait_group`` that retires its group (the two reads must agree, so
an operand not ready at issue or overwritten in flight faults) and
writes its accumulators at that wait, so an early read of the
accumulators shows up. ``wgmma`` reads shared memory as the asynchronous
proxy sees it: TMA writes reach it at once, a thread's generic stores
only at its ``fence.proxy.async``, so a tile rewritten in shared memory
and read without the fence is stale. ``setmaxnreg`` and the other fences
are no-ops. Shared memory starts 16 bytes past a 1024-byte boundary, as
it may on the card.
A launch's ``<<<...>>>`` becomes a loop over blocks. Each library is
built by ``g++`` and driven through its module's own wrappers
(``ops/attention.py``, ``ops/neighborhood_sim.py``) on CPU tensors.
Exits 1 if a case fails.
"""
import argparse
import ctypes
import importlib
import os
import os.path as osp
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (SIM_GEOMETRY_CASES, flash_bias,  # noqa: E402
                        flash_errors, sim_bwd_errors, sim_errors)
from pfst_tpu_torch.ops import build  # noqa: E402

# (shape (B, H, N, D), dtype, layout): every head dimension and type, N
# past a tile's edge (past a 128-row tile at every bf16 head dimension,
# and far enough that the forward's two-stage and dK/dV's three-stage
# rings wrap; fp32 dQ past its 128-row block and its 2048 / D-key tiles,
# its ring wrapping), 'qkv' strides as the ViT block gives them, and
# 'offset' views that the wrapper must copy
CASES = [((1, 2, 17, 64), torch.float32, 'qkv'),
         ((1, 2, 17, 64), torch.bfloat16, 'qkv'),
         ((1, 2, 130, 64), torch.bfloat16, 'qkv'),
         ((1, 1, 300, 64), torch.bfloat16, 'contiguous'),
         ((1, 1, 150, 32), torch.bfloat16, 'qkv'),
         ((1, 1, 140, 128), torch.bfloat16, 'qkv'),
         ((1, 1, 97, 64), torch.float32, 'qkv'),
         ((2, 1, 70, 32), torch.bfloat16, 'contiguous'),
         ((1, 2, 70, 32), torch.float32, 'offset'),
         ((1, 1, 80, 128), torch.bfloat16, 'offset'),
         ((1, 1, 80, 128), torch.float32, 'contiguous'),
         ((1, 2, 150, 64), torch.float32, 'offset'),
         ((1, 1, 37, 128), torch.float32, 'qkv')]
# with a bias (``chip_smoke.flash_bias``): BEiT's batch-shared table at N
# = 17 (4 x 4 + 1) and past a 64-key tile, Swin's windows with the shift
# mask (a 14 x 14 padded grid: 4 windows an image, 2 images), random
# asymmetric biases past a 128-row tile and at every head dimension,
# and one read through a row stride of N + 3; two launches bitwise equal
CASES_AB = [((2, 2, 17, 64), torch.float32, 'qkv', 'beit'),
            ((2, 2, 17, 64), torch.bfloat16, 'qkv', 'beit'),
            ((2, 1, 65, 32), torch.bfloat16, 'qkv', 'beit'),
            ((8, 3, 49, 32), torch.float32, 'qkv', ('swin', 14)),
            ((8, 3, 49, 32), torch.bfloat16, 'qkv', ('swin', 14)),
            ((1, 2, 130, 64), torch.bfloat16, 'qkv', 'random'),
            ((2, 1, 70, 32), torch.float32, 'contiguous', 'random'),
            ((1, 1, 80, 128), torch.bfloat16, 'offset', 'shared'),
            ((1, 1, 37, 128), torch.float32, 'qkv', 'strided'),
            ((1, 2, 97, 64), torch.float32, 'qkv', 'random')]
PRELUDE = r'''
#pragma once
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __align__(n) alignas(n)
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;

struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) {
  return __uint_as_float(uint32_t(h.x) << 16);
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}

enum cudaError_t {
  cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "emulated fault (see stderr)";
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}

namespace emu {
constexpr int kMaxThreads = 512;
struct Warp {
  std::barrier<> bar{32};
  const void* ptr[32];
  uint32_t a[32][4], b[32][2];
  float f[32];
};
// a TMA box copy, done when a thread waits on its mbarrier
struct TmaCopy {
  char* dst;
  unsigned char map[128];
  int c[5];
};
struct Mbar {
  int count = 0, pending = 0;
  long long tx = 0;
  unsigned phase = 0;  // phases completed
  std::vector<TmaCopy> copies;
};
// Shared memory is a window whose address 0 is 1024-byte aligned; the
// kernel's dynamic shared memory starts 16 bytes into it, as it may on the
// card, so a kernel that needs more alignment must make it. The
// asynchronous proxy (wgmma's reads) sees its own copy of the window:
// TMA writes both, and a thread's generic stores reach it only at the
// fence.proxy.async that follows them.
inline char* align1024(std::vector<char>& v) {
  return v.data() + (1024 - reinterpret_cast<uintptr_t>(v.data()) % 1024)
                        % 1024;
}
struct Block {
  explicit Block(int n, size_t bytes)
      : bar(n), raw(bytes + 2048), async_raw(bytes + 2048),
        size(bytes + 1024) {
    window = align1024(raw);
    async_window = align1024(async_raw);
  }
  std::barrier<> bar;
  Warp warps[kMaxThreads / 32];
  std::vector<char> raw, async_raw;
  size_t size;  // bytes of either window
  char* window;
  char* async_window;
  std::mutex mu;
  std::condition_variable cv;
  std::map<uint32_t, Mbar> bars;  // by shared-memory address
};
inline Block* g_block = nullptr;
inline std::atomic<int> g_fault{0};
inline std::atomic<bool> g_dead{false};
inline cudaError_t g_last = cudaSuccess;
inline Warp& warp() { return g_block->warps[threadIdx.x >> 5]; }
inline int lane() { return threadIdx.x & 31; }
inline float* smem() { return reinterpret_cast<float*>(g_block->window + 16); }
inline void fault(const char* what) {
  if (g_fault.exchange(1) == 0) std::fprintf(stderr, "emulation: %s\n", what);
}

template <class F>
void launch(dim3 grid, dim3 block, size_t bytes, cudaStream_t, F&& fn) {
  const int n = block.x;
  if (n > kMaxThreads || n % 32 || bytes > 232448) {
    g_last = cudaErrorInvalidValue;
    return;
  }
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        auto blk = std::make_unique<Block>(n, bytes);
        std::memset(blk->raw.data(), 0xff, blk->raw.size());  // NaN
        std::memset(blk->async_raw.data(), 0xff, blk->async_raw.size());
        g_block = blk.get();
        std::vector<std::thread> threads;
        for (int t = 0; t < n; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t, 0, 0);
            blockIdx = dim3(x, y, z);
            fn();
          });
        for (auto& th : threads) th.join();
      }
  g_dead = false;
  if (g_fault.exchange(0)) g_last = cudaErrorInvalidValue;
}
}  // namespace emu

inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu::g_last;
  emu::g_last = cudaSuccess;
  return e;
}
inline void __syncthreads() { emu::g_block->bar.arrive_and_wait(); }
inline void __syncwarp() { emu::warp().bar.arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  emu::Warp& w = emu::warp();
  const int l = emu::lane();
  w.f[l] = v;
  w.bar.arrive_and_wait();
  const float r = w.f[l ^ mask];
  w.bar.arrive_and_wait();
  return r;
}
'''

CUDA_H = r'''
#pragma once
// The driver API's tensor-map types and a host stand-in for
// cuTensorMapEncodeTiled that checks what the driver checks and keeps the
// map's fields for the emulated TMA (ptx.cuh's twin).
#include <cstdint>
#include <cstring>

typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUresult;
constexpr CUresult CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1;
struct alignas(64) CUtensorMap { unsigned long long opaque[16]; };
enum CUtensorMapDataType {
  CU_TENSOR_MAP_DATA_TYPE_FLOAT32 = 7, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9
};
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle {
  CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_32B,
  CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_SWIZZLE_128B
};
enum CUtensorMapL2promotion {
  CU_TENSOR_MAP_L2_PROMOTION_NONE = 0, CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B
};
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };

namespace emu {
struct TensorMap {
  const char* base;
  uint64_t dims[5], strides[5];  // strides in bytes, strides[0] = element
  uint32_t box[5];
  int rank, elem, span;  // span: swizzle bytes, 0 for none
};
static_assert(sizeof(TensorMap) <= sizeof(CUtensorMap), "TensorMap");
}  // namespace emu

inline CUresult emu_encode_tiled(
    CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank, void* base,
    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
    const cuuint32_t* elem_strides, CUtensorMapInterleave interleave,
    CUtensorMapSwizzle swizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill) {
  emu::TensorMap m{};
  m.base = static_cast<const char*>(base);
  m.rank = static_cast<int>(rank);
  m.elem = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  m.span = swizzle == CU_TENSOR_MAP_SWIZZLE_NONE ? 0 : 16 << swizzle;
  bool ok = rank >= 1 && rank <= 5 && interleave == 0 &&
            reinterpret_cast<uintptr_t>(base) % 16 == 0;
  for (cuuint32_t i = 0; ok && i < rank; ++i) {
    m.dims[i] = dims[i];
    m.strides[i] = i == 0 ? m.elem : strides[i - 1];
    m.box[i] = box[i];
    ok = dims[i] >= 1 && dims[i] <= (1ull << 32) && box[i] >= 1 &&
         box[i] <= 256 && elem_strides[i] == 1 &&
         (i == 0 || (strides[i - 1] % 16 == 0 && strides[i - 1] < (1ull << 40)));
  }
  const uint32_t row = ok ? m.box[0] * m.elem : 0;
  ok = ok && row % 16 == 0 && (m.span == 0 || row <= uint32_t(m.span));
  if (!ok) return CUDA_ERROR_INVALID_VALUE;
  std::memset(map, 0, sizeof(*map));
  std::memcpy(map, &m, sizeof(m));
  return CUDA_SUCCESS;
}

enum cudaDriverEntryPointQueryResult {
  cudaDriverEntryPointSuccess = 0, cudaDriverEntryPointSymbolNotFound = 1
};
constexpr unsigned long long cudaEnableDefault = 0;
inline cudaError_t cudaGetDriverEntryPoint(
    const char* name, void** fn, unsigned long long,
    cudaDriverEntryPointQueryResult* found) {
  const bool known = std::strcmp(name, "cuTensorMapEncodeTiled") == 0;
  *fn = known ? reinterpret_cast<void*>(&emu_encode_tiled) : nullptr;
  *found = known ? cudaDriverEntryPointSuccess
                 : cudaDriverEntryPointSymbolNotFound;
  return cudaSuccess;
}
'''

PTX = r'''
#pragma once
#include <cuda.h>

#include <cstdint>
#include <deque>
#include <vector>

namespace pfst {

struct EmuCopy { void* dst; const void* src; int bytes, size; };
inline thread_local std::vector<EmuCopy> t_open;
inline thread_local std::vector<std::vector<EmuCopy>> t_groups;

inline void cp_async(void* dst, const void* src, bool valid, int size) {
  if (reinterpret_cast<uintptr_t>(dst) % size ||
      reinterpret_cast<uintptr_t>(src) % size)
    emu::fault("cp.async address not aligned to its size");
  t_open.push_back({dst, src, valid ? size : 0, size});
}
inline void cp_async16(void* d, const void* s, bool v) { cp_async(d, s, v, 16); }
inline void cp_async4(void* d, const void* s, bool v) { cp_async(d, s, v, 4); }
inline void cp_async_commit() {
  t_groups.push_back(std::move(t_open));
  t_open.clear();
}
template <int N>
inline void cp_async_wait() {
  while (static_cast<int>(t_groups.size()) > N) {
    for (const EmuCopy& c : t_groups.front()) {
      std::memset(c.dst, 0, c.size);
      std::memcpy(c.dst, c.src, c.bytes);
    }
    t_groups.erase(t_groups.begin());
  }
}

inline void ldmatrix(uint32_t (&r)[4], const void* p, bool trans) {
  emu::Warp& w = emu::warp();
  const int l = emu::lane();
  if (reinterpret_cast<uintptr_t>(p) % 16)
    emu::fault("ldmatrix row address not 16-byte aligned");
  w.ptr[l] = p;
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    if (!trans) {
      std::memcpy(&r[i], static_cast<const char*>(w.ptr[8 * i + (l >> 2)])
                             + 4 * (l & 3), 4);
    } else {
      const auto* r0 = static_cast<const uint16_t*>(w.ptr[8 * i + 2 * (l & 3)]);
      const auto* r1 = static_cast<const uint16_t*>(w.ptr[8 * i + 2 * (l & 3) + 1]);
      r[i] = uint32_t(r0[l >> 2]) | (uint32_t(r1[l >> 2]) << 16);
    }
  }
  w.bar.arrive_and_wait();
}
inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) { ldmatrix(r, p, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) { ldmatrix(r, p, true); }

inline float bf16_half(uint32_t v, int hi) {
  return __uint_as_float(hi ? (v & 0xffff0000u) : (v << 16));
}
inline float tf32_in(uint32_t v) { return __uint_as_float(v & 0xffffe000u); }

// d[e] for lane l from the warp's A (M x K) and B (K x 8) operands
template <int K>
inline void mma_rows(float (&d)[4], const float (&A)[16][K],
                     const float (&B)[K][8], int l) {
  for (int e = 0; e < 4; ++e) {
    const int row = (l >> 2) + 8 * (e >> 1), col = 2 * (l & 3) + (e & 1);
    double sum = d[e];
    for (int k = 0; k < K; ++k) sum += double(A[row][k]) * B[k][col];
    d[e] = float(sum);
  }
}

inline void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                           uint32_t b0, uint32_t b1) {
  emu::Warp& w = emu::warp();
  const int l = emu::lane();
  for (int i = 0; i < 4; ++i) w.a[l][i] = a[i];
  w.b[l][0] = b0;
  w.b[l][1] = b1;
  w.bar.arrive_and_wait();
  float A[16][16], B[16][8];
  for (int L = 0; L < 32; ++L) {
    const int g = L >> 2, t = L & 3;
    for (int h = 0; h < 2; ++h) {
      A[g][2 * t + h] = bf16_half(w.a[L][0], h);
      A[g + 8][2 * t + h] = bf16_half(w.a[L][1], h);
      A[g][2 * t + 8 + h] = bf16_half(w.a[L][2], h);
      A[g + 8][2 * t + 8 + h] = bf16_half(w.a[L][3], h);
      B[2 * t + h][g] = bf16_half(w.b[L][0], h);
      B[2 * t + 8 + h][g] = bf16_half(w.b[L][1], h);
    }
  }
  w.bar.arrive_and_wait();
  mma_rows<16>(d, A, B, l);
}

inline void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4],
                          uint32_t b0, uint32_t b1) {
  emu::Warp& w = emu::warp();
  const int l = emu::lane();
  for (int i = 0; i < 4; ++i) w.a[l][i] = a[i];
  w.b[l][0] = b0;
  w.b[l][1] = b1;
  w.bar.arrive_and_wait();
  float A[16][8], B[8][8];
  for (int L = 0; L < 32; ++L) {
    const int g = L >> 2, t = L & 3;
    A[g][t] = tf32_in(w.a[L][0]);
    A[g + 8][t] = tf32_in(w.a[L][1]);
    A[g][t + 4] = tf32_in(w.a[L][2]);
    A[g + 8][t + 4] = tf32_in(w.a[L][3]);
    B[t][g] = tf32_in(w.b[L][0]);
    B[t + 4][g] = tf32_in(w.b[L][1]);
  }
  w.bar.arrive_and_wait();
  mma_rows<8>(d, A, B, l);
}

inline uint32_t tf32_round(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) == 0x7f800000u) return u;
  return (u + 0x1000u) & 0xffffe000u;  // to nearest, ties away from zero
}

// ---- Hopper: shared-memory addresses, swizzle, mbarrier, TMA, wgmma ----
inline unsigned smem_addr(const void* p) {
  return unsigned(static_cast<const char*>(p) - emu::g_block->window);
}

// The 128B / 64B / 32B swizzle (span bytes; 0: none) of a shared-memory
// address: its 16-byte chunk bits [4, 4 + log2(span / 16)) XORed with the
// bits [7, ...) above them, as TMA writes and wgmma descriptors read.
inline uint32_t swizzle(uint32_t addr, int span) {
  if (span == 0) return addr;
  const uint32_t mask = uint32_t(span / 16 - 1);
  return addr ^ (((addr >> 7) & mask) << 4);
}

inline emu::Mbar& mbar_of(uint64_t* bar) {  // the block's lock held
  auto it = emu::g_block->bars.find(smem_addr(bar));
  if (it == emu::g_block->bars.end()) {
    emu::fault("mbarrier used before mbarrier.init");
    it = emu::g_block->bars.emplace(smem_addr(bar), emu::Mbar{1, 1}).first;
  }
  return it->second;
}

inline void mbar_complete(emu::Mbar& m) {
  if (m.pending == 0 && m.tx == 0) {
    ++m.phase;
    m.pending = m.count;
    emu::g_block->cv.notify_all();
  }
}

inline void mbar_init(uint64_t* bar, int count) {
  if (smem_addr(bar) % 8) emu::fault("mbarrier not 8-byte aligned");
  std::lock_guard<std::mutex> lk(emu::g_block->mu);
  emu::g_block->bars[smem_addr(bar)] = emu::Mbar{count, count};
}
inline void mbar_init_fence() {}

inline void mbar_arrive_tx(uint64_t* bar, long long bytes) {
  std::lock_guard<std::mutex> lk(emu::g_block->mu);
  emu::Mbar& m = mbar_of(bar);
  if (m.pending <= 0) emu::fault("mbarrier arrival beyond its count");
  m.tx += bytes;
  --m.pending;
  mbar_complete(m);
}
inline void mbar_arrive(uint64_t* bar) { mbar_arrive_tx(bar, 0); }
inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  mbar_arrive_tx(bar, bytes);
}

// A queued TMA box into shared memory: elements outside the tensor are
// zero, rows of box[0] elements are dense and the whole is swizzled by
// address. Returns the bytes, which complete_tx credits.
inline long long tma_run(const emu::TmaCopy& t) {
  emu::TensorMap mp;
  std::memcpy(&mp, t.map, sizeof(mp));
  uint32_t n[5] = {1, 1, 1, 1, 1};
  for (int i = 0; i < mp.rank; ++i) n[i] = mp.box[i];
  const uint32_t dst = smem_addr(t.dst);
  long long bytes = 0;
  for (uint32_t i4 = 0; i4 < n[4]; ++i4)
  for (uint32_t i3 = 0; i3 < n[3]; ++i3)
  for (uint32_t i2 = 0; i2 < n[2]; ++i2)
  for (uint32_t i1 = 0; i1 < n[1]; ++i1)
  for (uint32_t i0 = 0; i0 < n[0]; ++i0) {
    const uint32_t idx[5] = {i0, i1, i2, i3, i4};
    bool in = true;
    long long off = 0;
    for (int d = 0; d < mp.rank; ++d) {
      const long long g = (long long)t.c[d] + idx[d];
      in = in && g >= 0 && g < (long long)mp.dims[d];
      off += g * (long long)mp.strides[d];
    }
    const uint32_t at = swizzle(dst + uint32_t(bytes), mp.span);
    for (char* out : {emu::g_block->window + at,
                      emu::g_block->async_window + at}) {
      if (in) std::memcpy(out, mp.base + off, mp.elem);
      else std::memset(out, 0, mp.elem);
    }
    bytes += mp.elem;
  }
  return bytes;
}

inline void tma_issue(void* dst, const CUtensorMap* map, uint64_t* bar,
                      int rank, std::initializer_list<int> c) {
  emu::TensorMap mp;
  std::memcpy(&mp, map, sizeof(mp));
  const uint32_t align = mp.span ? 8 * mp.span : 128;
  if (mp.rank != rank) emu::fault("TMA rank differs from its tensor map's");
  if (smem_addr(dst) % align)
    emu::fault("TMA destination not aligned to its swizzle atom (or 128 B)");
  emu::TmaCopy t{static_cast<char*>(dst), {}, {}};
  std::memcpy(t.map, map, sizeof(t.map));
  int i = 0;
  for (int x : c) t.c[i++] = x;
  std::lock_guard<std::mutex> lk(emu::g_block->mu);
  mbar_of(bar).copies.push_back(t);
  emu::g_block->cv.notify_all();
}
inline void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                        int c0, int c1, int c2, int c3) {
  tma_issue(dst, map, bar, 4, {c0, c1, c2, c3});
}

// The copies queued on a barrier land when a thread waits on it; a read
// of their destination before that wait sees what was there before.
inline void mbar_wait_locked(uint64_t* bar, int parity) {
  std::unique_lock<std::mutex> lk(emu::g_block->mu);
  const auto deadline =
      std::chrono::steady_clock::now() + std::chrono::seconds(60);
  for (;;) {
    emu::Mbar& m = mbar_of(bar);
    for (const emu::TmaCopy& t : m.copies) m.tx -= tma_run(t);
    m.copies.clear();
    mbar_complete(m);
    if (int(m.phase & 1) != parity || emu::g_dead) return;
    if (emu::g_block->cv.wait_until(lk, deadline) ==
        std::cv_status::timeout) {
      emu::fault("an mbarrier phase never completed (deadlock)");
      emu::g_dead = true;
      emu::g_block->cv.notify_all();
      return;
    }
  }
}

// The first warpgroup (the wgmma kernels' producer: TMA and split warps)
// then dawdles, so that a consumer that reads a stage before the barrier
// that guards it finds it unready.
inline void mbar_wait(uint64_t* bar, int parity) {
  mbar_wait_locked(bar, parity);
  if (threadIdx.x < 128)
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
}

// This thread's generic stores so far reach the asynchronous proxy (the
// whole window is copied: stores of other threads not yet fenced go along,
// which can hide their own missing fence but never a missing one here).
inline void fence_proxy_async() {
  std::lock_guard<std::mutex> lk(emu::g_block->mu);
  std::memcpy(emu::g_block->async_window, emu::g_block->window,
              emu::g_block->size);
}

inline float ex2(float x) { return std::exp2(x); }
template <int R> inline void setmaxnreg_inc() {}
template <int R> inline void setmaxnreg_dec() {}
template <int M> inline void fence_regs(float (&)[M][4]) {}
template <int M> inline void fence_regs(uint32_t (&)[M][4]) {}
inline void wgmma_fence() {}

// a wgmma of this thread: its 2 rows of A (register A) or A's descriptor,
// the input's bytes (2: bf16, 4: tf32), and the shared-memory operands it
// read at issue; done at the wgmma_wait that retires its group
struct WgOp {
  float* d;
  int n, trans_b, accumulate;
  bool reg_a;
  uint64_t a, b;
  float arow[2][16];
  int elem;
  std::vector<float> snap;
};
inline thread_local std::vector<WgOp> t_wg_open;
inline thread_local std::deque<std::vector<WgOp>> t_wg_groups;

// element (row, k) of a K-major operand, or (k, n) as (n, k) of an
// MN-major one (desc_mn, bf16 only), bf16 or tf32 (elem bytes) in shared
// memory as the asynchronous proxy sees it: the PTX ISA's canonical
// layouts (leading / stride byte offsets) under the descriptor's swizzle;
// a tf32 input is read as its top 19 bits
inline float desc_elem(uint64_t desc, int i, int k, bool mn_major,
                       int elem) {
  const uint32_t start = uint32_t(desc & 0x3FFF) << 4;
  const uint32_t lbo = uint32_t((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = uint32_t((desc >> 32) & 0x3FFF) << 4;
  const int layout = int(desc >> 62);
  if (layout == 0) emu::fault("wgmma descriptor without swizzle: not emulated");
  const int span = layout == 1 ? 128 : layout == 2 ? 64 : 32;
  uint32_t addr;
  if (!mn_major) {  // i: row (M or N), k contiguous
    addr = start + (i / 8) * sbo + (i % 8) * span + k * elem;
  } else {  // i: n, contiguous within an atom; k: rows
    if (elem != 2) emu::fault("MN-major tf32 wgmma operand");
    const int w = span / 2;
    addr = start + (i / w) * lbo + (i % w) * 2 + (k % 8) * span + (k / 8) * sbo;
  }
  const char* at = emu::g_block->async_window + swizzle(addr, span);
  if (elem == 4) {
    uint32_t u;
    std::memcpy(&u, at, 4);
    return tf32_in(u);
  }
  uint16_t h;
  std::memcpy(&h, at, 2);
  return __uint_as_float(uint32_t(h) << 16);
}

// The shared-memory operands that this thread's results read: its rows
// r0, r0 + 8 of A (unless A is in registers), then its columns 8 j + 2 t
// and 8 j + 2 t + 1 of B, a k-step each.
inline std::vector<float> wgmma_operands(const WgOp& op) {
  const int l = emu::lane(), t = l & 3;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (l >> 2);
  const int kn = 32 / op.elem;  // a k-step: 32 bytes
  std::vector<float> v;
  if (!op.reg_a)
    for (int i = 0; i < 2; ++i)
      for (int k = 0; k < kn; ++k)
        v.push_back(desc_elem(op.a, r0 + 8 * i, k, false, op.elem));
  for (int j = 0; j < op.n / 8; ++j)
    for (int c = 0; c < 2; ++c)
      for (int k = 0; k < kn; ++k)
        v.push_back(desc_elem(op.b, 8 * j + 2 * t + c, k, op.trans_b != 0,
                              op.elem));
  return v;
}

// A wgmma may read shared memory at any time from its issue to the
// wait_group that retires it: it reads it at both, and they must agree
// (an operand not ready at issue, or overwritten in flight, faults).
inline void wgmma_issue(WgOp op) {
  op.snap = wgmma_operands(op);
  t_wg_open.push_back(std::move(op));
}

inline void wgmma_run(const WgOp& op) {
  const std::vector<float> now = wgmma_operands(op);
  if (std::memcmp(now.data(), op.snap.data(), now.size() * 4) != 0)
    emu::fault("a wgmma operand in shared memory changed between its issue "
               "and its wait_group");
  const int kn = 32 / op.elem;
  const float* b = op.snap.data() + (op.reg_a ? 0 : 2 * kn);
  for (int j = 0; j < op.n / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const float* a = op.reg_a ? op.arow[e >> 1]
                                : op.snap.data() + (e >> 1) * kn;
      const float* bc = b + (2 * j + (e & 1)) * kn;
      double sum = op.accumulate ? op.d[4 * j + e] : 0.0;
      for (int k = 0; k < kn; ++k) sum += double(a[k]) * bc[k];
      op.d[4 * j + e] = float(sum);
    }
}

template <int N, int TransB>
inline void wgmma_ss(float (&d)[N / 8][4], uint64_t a, uint64_t b,
                     int accumulate) {
  wgmma_issue({&d[0][0], N, TransB, accumulate, false, a, b, {}, 2, {}});
}

template <int N, int TransB>
inline void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t b,
                     int accumulate) {
  emu::Warp& w = emu::warp();
  const int l = emu::lane();
  for (int i = 0; i < 4; ++i) w.a[l][i] = a[i];
  w.bar.arrive_and_wait();
  WgOp op{&d[0][0], N, TransB, accumulate, true, 0, b, {}, 2, {}};
  for (int t = 0; t < 4; ++t) {  // the quad of rows g, g + 8
    const uint32_t* q = w.a[4 * (l >> 2) + t];
    for (int h = 0; h < 2; ++h) {
      op.arow[0][2 * t + h] = bf16_half(q[0], h);
      op.arow[1][2 * t + h] = bf16_half(q[1], h);
      op.arow[0][2 * t + 8 + h] = bf16_half(q[2], h);
      op.arow[1][2 * t + 8 + h] = bf16_half(q[3], h);
    }
  }
  w.bar.arrive_and_wait();
  wgmma_issue(op);
}

template <int N>
inline void wgmma_ss_tf32(float (&d)[N / 8][4], uint64_t a, uint64_t b,
                          int accumulate) {
  wgmma_issue({&d[0][0], N, 0, accumulate, false, a, b, {}, 4, {}});
}

// register A as mma.m16n8k8's TF32 A fragment: a[0] (g, t), a[1]
// (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4), read as TF32
template <int N>
inline void wgmma_rs_tf32(float (&d)[N / 8][4], const uint32_t (&a)[4],
                          uint64_t b, int accumulate) {
  emu::Warp& w = emu::warp();
  const int l = emu::lane();
  for (int i = 0; i < 4; ++i) w.a[l][i] = a[i];
  w.bar.arrive_and_wait();
  WgOp op{&d[0][0], N, 0, accumulate, true, 0, b, {}, 4, {}};
  for (int t = 0; t < 4; ++t) {  // the quad of rows g, g + 8
    const uint32_t* q = w.a[4 * (l >> 2) + t];
    op.arow[0][t] = tf32_in(q[0]);
    op.arow[1][t] = tf32_in(q[1]);
    op.arow[0][t + 4] = tf32_in(q[2]);
    op.arow[1][t + 4] = tf32_in(q[3]);
  }
  w.bar.arrive_and_wait();
  wgmma_issue(op);
}

inline void wgmma_commit() {
  t_wg_groups.push_back(std::move(t_wg_open));
  t_wg_open.clear();
}

template <int N>
inline void wgmma_wait() {
  while (static_cast<int>(t_wg_groups.size()) > N) {
    for (const WgOp& op : t_wg_groups.front()) wgmma_run(op);
    t_wg_groups.pop_front();
  }
}

}  // namespace pfst
'''


# kernel launches per emulated source
LAUNCHES = {'flash_attention': 5, 'neighborhood_sim': 2}


def emulated_source(src, launches):
    """A ``.cu`` source with its launches and shared memory turned into
    the emulation's."""
    src = src.replace('extern __shared__ __align__(16) float smem[];',
                      'float* smem = emu::smem();')
    src, n = re.subn(r'(\w+<[\w, ]+>)\s*<<<(.*?)>>>\((.*?)\);',
                     r'emu::launch(\2, [&] { \1(\3); });', src,
                     flags=re.S)
    if n != launches:
        raise RuntimeError(f'expected {launches} kernel launches, found {n}')
    return src


def build_emulated(tmp, name):
    """Compile the emulated library of ``csrc/<name>.cu`` in ``tmp``;
    returns its path."""
    for fname in os.listdir(build.CSRC_DIR):
        if fname.endswith('.cuh') and fname != 'ptx.cuh':
            shutil.copy(osp.join(build.CSRC_DIR, fname), tmp)
    for fname, text in (('ptx.cuh', PTX), ('prelude.h', PRELUDE),
                        ('cuda.h', CUDA_H), ('cuda_bf16.h', ''),
                        ('cuda_runtime.h', '')):
        with open(osp.join(tmp, fname), 'w') as f:
            f.write(text)
    with open(osp.join(build.CSRC_DIR, f'{name}.cu')) as f:
        src = emulated_source(f.read(), LAUNCHES[name])
    with open(osp.join(tmp, f'{name}.cpp'), 'w') as f:
        f.write(src)
    out = osp.join(tmp, f'{name}_emulated.so')
    subprocess.run(['g++', '-std=c++20', '-O2', '-shared', '-fPIC', '-Wno-psabi',
                    '-pthread', '-I', tmp, '-include',
                    osp.join(tmp, 'prelude.h'),
                    osp.join(tmp, f'{name}.cpp'), '-o', out],
                   check=True)
    return out


def use_libraries(libs):
    """Point ``ops/attention.py`` and ``ops/neighborhood_sim.py`` at the
    emulated libraries ``libs`` (by source name) and let them launch on
    CPU tensors (device 0, no stream)."""
    attn = importlib.import_module('pfst_tpu_torch.ops.attention')
    sim = importlib.import_module('pfst_tpu_torch.ops.neighborhood_sim')
    build.load = lambda name: libs[name]

    def check_attn_input(q, k, v):
        attn._check_args(q, k, v)
        if q.dtype not in (torch.float32, torch.bfloat16) or \
                q.shape[-1] not in attn.HEAD_DIMS:
            raise ValueError(f'not a kernel input: {q.dtype} {q.shape}')

    def check_sim_input(x, kernel_size, dilation, sim_type):
        sim._check_args(x, kernel_size, dilation, sim_type)
        if x.dtype not in (torch.float32, torch.bfloat16) or \
                not x.is_contiguous():
            raise ValueError(f'not a kernel input: {x.dtype} {x.shape}')

    attn._check_kernel_input = check_attn_input
    sim._check_kernel_input = check_sim_input
    for module in (attn, sim):
        module._device_and_stream = lambda t: (0, None)


def inputs(shape, dtype, layout, gen):
    b, h, n, d = shape
    if layout == 'qkv':
        qkv = torch.randn((b, n, 3, h, d), generator=gen).to(dtype)
        return qkv.permute(2, 0, 3, 1, 4).unbind(0)
    if layout == 'offset':  # a base one element past 16-byte alignment
        flat = torch.randn(3 * b * h * n * d + 1, generator=gen).to(dtype)
        return flat[1:].view(3, b, h, n, d).unbind(0)
    return [torch.randn(shape, generator=gen).to(dtype) for _ in range(3)]


def run_flash(gen, cases=None):
    ok = True
    for shape, dtype, layout, *bias in cases or (
            [c + (None,) for c in CASES] + CASES_AB):
        q, k, v = inputs(shape, dtype, layout, gen)
        g = torch.randn(shape, generator=gen).to(dtype)
        ab = None if bias[0] is None else flash_bias(bias[0], shape, gen,
                                                     'cpu')
        t0 = time.time()
        try:
            _, _, err = flash_errors(q, k, v, g, shape[-1]**-0.5, ab,
                                     repeat=ab is not None)
        except RuntimeError as e:  # an emulated fault (on stderr)
            err = {'ok': False, 'launch': str(e)}
        ok = err['ok'] and ok
        print(f'{shape} {str(dtype)[6:]} {layout} bias {bias[0]}: '
              f'{"OK" if err["ok"] else "FAIL"} ({time.time() - t0:.1f}s) '
              + ' '.join(f'{k_} {v_:.2e}' if isinstance(v_, float)
                         else f'{k_}: {v_}' for k_, v_ in err.items()
                         if k_ != 'ok'), flush=True)
    return ok


def run_sim(gen):
    ok = True
    # chip_smoke's general geometries (k 3, 5, 7; d 1, 2, 33; odd W;
    # ragged channel splits), both similarity types and input types
    for shape, k, d in SIM_GEOMETRY_CASES:
        for sim_type in ('cosine', 'gaussian'):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(shape, generator=gen).to(dtype)
                g = torch.randn((shape[0], k * k, *shape[2:]), generator=gen)
                t0 = time.time()
                err = sim_errors(x, k, d, sim_type)
                try:
                    bwd, _ = sim_bwd_errors(x, g, k, d, sim_type)
                except RuntimeError as e:  # an emulated fault (on stderr)
                    bwd = dict(ok=False, max_abs_err=float('nan'),
                               err_beyond_rounding=float('nan'),
                               limit=float('nan'), launch=str(e))
                good = err['ok'] and bwd['ok']
                ok = good and ok
                print(f'similarity {shape} k{k} d{d} {sim_type} '
                      f'{str(dtype)[6:]}: {"OK" if good else "FAIL"} '
                      f'({time.time() - t0:.1f}s) forward max_abs_err '
                      f'{err["max_abs_err"]:.2e} norm_rel_err '
                      f'{err["norm_rel_err"]:.2e}; backward max_abs_err '
                      f'{bwd["max_abs_err"]:.2e} beyond rounding '
                      f'{bwd["err_beyond_rounding"]:.2e} (limit '
                      f'{bwd["limit"]:.1e}) repeat bitwise equal '
                      f'{bwd.get("repeat_bitwise_equal")}', flush=True)
    return ok


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--keep', help='build in this directory and keep it')
    parser.add_argument('--only', choices=sorted(LAUNCHES),
                        help='emulate one source only')
    parser.add_argument('--bias-only', action='store_true',
                        help='flash: only the cases with a bias')
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    tmp = args.keep or tempfile.mkdtemp()
    os.makedirs(tmp, exist_ok=True)
    names = [args.only] if args.only else sorted(LAUNCHES)
    try:
        t0 = time.time()
        libs = {name: ctypes.CDLL(build_emulated(tmp, name))
                for name in names}
        print(f'g++ build {time.time() - t0:.1f}s', flush=True)
        use_libraries(libs)
        gen = torch.Generator().manual_seed(0)
        ok = True
        if 'flash_attention' in libs:
            ok = run_flash(gen, CASES_AB if args.bias_only else None) \
                and ok
        if 'neighborhood_sim' in libs:
            ok = run_sim(gen) and ok
    finally:
        if not args.keep:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
