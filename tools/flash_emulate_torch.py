#!/usr/bin/env python
"""Run the kernels of ``pfst_tpu_torch/ops/csrc`` that use shared memory,
warp collectives or the tensor cores on the CPU under an emulation of
CUDA: the flash-attention kernels (``flash_attention.cu``), held to the
plain versions with the limits of ``chip_smoke.py``'s phase 3c
(``chip_smoke.flash_errors``), and the similarity forward
(``neighborhood_sim.cu``), held with phase 3's (``chip_smoke.sim_errors``).

For a change to either source or its headers, before any run on a card
(needs ``g++`` with C++20; no ``nvcc``)::

    python3 tools/flash_emulate_torch.py

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
mantissa bits, as the hardware reads them. A launch's ``<<<...>>>``
becomes a loop over blocks. Each library is built by ``g++`` and driven
through its module's own wrappers (``ops/attention.py``,
``ops/neighborhood_sim.py``) on CPU tensors. Exits 1 if a case fails.
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
from chip_smoke import flash_errors, sim_errors  # noqa: E402
from pfst_tpu_torch.ops import build  # noqa: E402

# (shape (B, H, N, D), dtype, layout): every head dimension and type, N
# past a tile's edge, 'qkv' strides as the ViT block gives them, and
# 'offset' views that the wrapper must copy
CASES = [((1, 2, 17, 64), torch.float32, 'qkv'),
         ((1, 2, 17, 64), torch.bfloat16, 'qkv'),
         ((1, 2, 130, 64), torch.bfloat16, 'qkv'),
         ((1, 1, 97, 64), torch.float32, 'qkv'),
         ((2, 1, 70, 32), torch.bfloat16, 'contiguous'),
         ((1, 2, 70, 32), torch.float32, 'offset'),
         ((1, 1, 80, 128), torch.bfloat16, 'offset'),
         ((1, 1, 80, 128), torch.float32, 'contiguous')]
# similarity forward: (shape (B, C, H, W), k, d), each for both similarity
# types and input types: W past a 32-pixel segment, odd W (unaligned bf16
# pairs), d = 2 with W a multiple of 8 (the compile-time geometry), C
# leaving warps without channels or with a ragged last stage, k = 7 (8
# warps a block) and d > 32 (windows side by side)
SIM_CASES = [((2, 20, 9, 37), 3, 1),
             ((1, 70, 11, 64), 3, 2),
             ((1, 8, 12, 40), 5, 1),
             ((1, 20, 10, 33), 5, 2),
             ((2, 36, 7, 48), 5, 2),
             ((1, 12, 9, 20), 7, 1),
             ((1, 10, 9, 24), 7, 2),
             ((1, 3, 37, 70), 3, 33)]

PRELUDE = r'''
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __align__(n) alignas(n)

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

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
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
struct Block {
  explicit Block(int n, size_t bytes) : bar(n), smem(bytes / 4 + 4) {}
  std::barrier<> bar;
  Warp warps[kMaxThreads / 32];
  std::vector<float> smem;
};
inline Block* g_block = nullptr;
inline std::atomic<int> g_fault{0};
inline cudaError_t g_last = cudaSuccess;
inline Warp& warp() { return g_block->warps[threadIdx.x >> 5]; }
inline int lane() { return threadIdx.x & 31; }
inline float* smem() { return g_block->smem.data(); }
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
        std::memset(blk->smem.data(), 0xff, blk->smem.size() * 4);  // NaN
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

PTX = r'''
#pragma once
#include <cstdint>
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

}  // namespace pfst
'''


# kernel launches per emulated source
LAUNCHES = {'flash_attention': 3, 'neighborhood_sim': 3}


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
                        ('cuda_bf16.h', ''), ('cuda_runtime.h', '')):
        with open(osp.join(tmp, fname), 'w') as f:
            f.write(text)
    with open(osp.join(build.CSRC_DIR, f'{name}.cu')) as f:
        src = emulated_source(f.read(), LAUNCHES[name])
    with open(osp.join(tmp, f'{name}.cpp'), 'w') as f:
        f.write(src)
    out = osp.join(tmp, f'{name}_emulated.so')
    subprocess.run(['g++', '-std=c++20', '-O2', '-shared', '-fPIC',
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


def run_flash(gen):
    ok = True
    for shape, dtype, layout in CASES:
        q, k, v = inputs(shape, dtype, layout, gen)
        g = torch.randn(shape, generator=gen).to(dtype)
        t0 = time.time()
        _, _, err = flash_errors(q, k, v, g, shape[-1]**-0.5)
        ok = err['ok'] and ok
        print(f'{shape} {str(dtype)[6:]} {layout}: '
              f'{"OK" if err["ok"] else "FAIL"} ({time.time() - t0:.1f}s) '
              + ' '.join(f'{k_} {v_:.2e}' for k_, v_ in err.items()
                         if k_ != 'ok'), flush=True)
    return ok


def run_sim(gen):
    ok = True
    for shape, k, d in SIM_CASES:
        for sim_type in ('cosine', 'gaussian'):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(shape, generator=gen).to(dtype)
                t0 = time.time()
                err = sim_errors(x, k, d, sim_type)
                ok = err['ok'] and ok
                print(f'similarity {shape} k{k} d{d} {sim_type} '
                      f'{str(dtype)[6:]}: '
                      f'{"OK" if err["ok"] else "FAIL"} '
                      f'({time.time() - t0:.1f}s) max_abs_err '
                      f'{err["max_abs_err"]:.2e} norm_rel_err '
                      f'{err["norm_rel_err"]:.2e}', flush=True)
    return ok


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--keep', help='build in this directory and keep it')
    parser.add_argument('--only', choices=sorted(LAUNCHES),
                        help='emulate one source only')
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
            ok = run_flash(gen) and ok
        if 'neighborhood_sim' in libs:
            ok = run_sim(gen) and ok
    finally:
        if not args.keep:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
