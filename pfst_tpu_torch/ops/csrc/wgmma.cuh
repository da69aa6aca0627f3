// Warpgroup tiles for the Hopper flash-attention kernels: bf16 or fp32
// tiles that TMA writes into shared memory (or that a kernel writes
// itself, in the same layout), in the swizzled layout that the wgmma
// descriptors name, and the host side of TMA (tensor maps).
//
// A tile holds R rows of D columns of T (2 or 4 bytes). Its rows are cut
// into atoms of W = min(D, 128 / sizeof(T)) columns (S = W sizeof(T) = 128
// or 64 bytes, the swizzle span): region r holds columns r W .. r W + W - 1
// of every row, R rows of S bytes, and the regions follow each other (bf16
// D = 128 has two, fp32 D = 64 two and D = 128 four). Within a region, the
// 16-byte chunk c of row i lies at chunk c ^ ((i / k) % (S / 16)) (k = 1
// for S = 128, 2 for S = 64), i.e. the chunk bits [4, 4 + log2(S / 16)) of
// the shared-memory address are XORed with the bits [7, ...) above them:
// the PTX ISA's 128B and 64B swizzle modes, which TMA
// (CU_TENSOR_MAP_SWIZZLE_128B / 64B) writes and the descriptors' layout
// type (1 / 2) reads. Both act on address bits, so every region starts at
// a multiple of 8 S bytes (one swizzle atom of 8 rows). A k-step of wgmma
// is 32 bytes in either type: 16 bf16 or 8 tf32 columns.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

#include "ptx.cuh"

namespace pfst {

template <typename T, int D>
struct Atom {
  static constexpr int kElem = static_cast<int>(sizeof(T));
  static constexpr int kCols = D * kElem < 128 ? D : 128 / kElem;  // W
  static constexpr int kBytes = kCols * kElem;  // S, one row's span
  static constexpr int kRegions = D / kCols;
  static constexpr int kStep = 32 / kElem;  // columns of a k-step
  static constexpr int kLayout = kBytes == 128 ? 1 : 2;  // descriptor type
  static constexpr CUtensorMapSwizzle kSwizzle =
      kBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  static_assert(kBytes == 128 || kBytes == 64, "Atom: a row of 64 or 128 "
                "bytes, or a multiple of 128");
};

// Bytes of an R x D tile; for R a multiple of 16 a multiple of 1024, so
// tiles laid one after another from a 1024-byte boundary keep every
// region on a swizzle atom.
template <typename T, int D, int R>
__host__ __device__ constexpr int tile_bytes() {
  return R * D * static_cast<int>(sizeof(T));
}

// Byte offset of element (row, col) in an R x D tile, swizzled: what TMA
// writes there, and where a kernel that writes a tile itself must put it.
template <typename T, int D, int R>
__device__ __forceinline__ int tile_offset(int row, int col) {
  using A = Atom<T, D>;
  const int c = col % A::kCols;
  const int chunk = (c * A::kElem) >> 4;
  const int swz = ((row * A::kBytes) >> 7) & (A::kBytes / 16 - 1);
  return (col / A::kCols) * R * A::kBytes + row * A::kBytes +
         ((chunk ^ swz) << 4) + ((c * A::kElem) & 15);
}

// The first 1024-byte boundary of shared memory at or after p (dynamic
// shared memory is only 16-byte aligned; launches ask for 1 KB more).
__device__ __forceinline__ char* smem_align(void* p) {
  const uint32_t a = smem_addr(p);
  return static_cast<char*>(p) + ((1024 - (a & 1023)) & 1023);
}

// A wgmma shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor
// Format"): start address, leading and stride byte offsets (all >> 4) and
// the swizzle layout type in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

// The K-major operand at rows r0 .. r0 + M - 1 (M = 64 for A, N for B),
// k-step ks (32 bytes: columns ks kStep .. ks kStep + kStep - 1) of an
// R x D tile: 8-row groups S * 8 bytes apart (SBO); within a swizzle atom
// the k-step is the start address plus its byte offset, which the swizzle
// then permutes as it permuted TMA's writes. The leading offset is unused
// in this mode.
template <typename T, int D, int R>
__device__ __forceinline__ uint64_t desc_k(const T* tile, int r0, int ks) {
  using A = Atom<T, D>;
  const int col = A::kStep * ks;
  const uint32_t addr = smem_addr(tile) +
                        (col / A::kCols) * R * A::kBytes + r0 * A::kBytes +
                        (col % A::kCols) * A::kElem;
  return make_desc(addr, 16, 8 * A::kBytes, A::kLayout);
}

// The MN-major operand B (TransB = 1, bf16 only: tf32 wgmma has no
// transpose) whose k runs down the tile's rows: rows 16 ks .. 16 ks + 15,
// the W columns of region `region`. One atom wide, so only the 8-row
// stride matters; it goes into both offsets (the leading offset, the
// stride between atoms along N, is then unused).
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn(const __nv_bfloat16* tile,
                                            int ks, int region) {
  using A = Atom<__nv_bfloat16, D>;
  const uint32_t addr =
      smem_addr(tile) + region * R * A::kBytes + 16 * ks * A::kBytes;
  return make_desc(addr, 8 * A::kBytes, 8 * A::kBytes, A::kLayout);
}

// Producer side: the R x D tile of rows row0 .. of head (b, h) through a
// (D, N, H, B) tensor map whose box is (W, R), one TMA per region.
template <typename T, int D, int R>
__device__ __forceinline__ void tma_tile(T* tile, const CUtensorMap* map,
                                         uint64_t* bar, int row0, int h,
                                         int b) {
  using A = Atom<T, D>;
#pragma unroll
  for (int r = 0; r < A::kRegions; ++r)
    tma_load_4d(reinterpret_cast<char*>(tile) + r * R * A::kBytes, map, bar,
                r * A::kCols, row0, h, b);
}

// Host side: cuTensorMapEncodeTiled, a driver-API function, through the
// runtime's entry-point query, so that the library links only cudart.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled's result as a cudaError_t; a refusal is also
// printed with the map's geometry, which no error code carries.
inline cudaError_t encoded(CUresult r, int rank, const cuuint64_t* dims,
                           const cuuint64_t* strides, const cuuint32_t* box) {
  if (r == CUDA_SUCCESS) return cudaSuccess;
  std::fprintf(stderr, "cuTensorMapEncodeTiled refused a rank-%d map "
               "(CUresult %d): dims", rank, static_cast<int>(r));
  for (int i = 0; i < rank; ++i)
    std::fprintf(stderr, " %llu", static_cast<unsigned long long>(dims[i]));
  std::fprintf(stderr, ", byte strides");
  for (int i = 0; i + 1 < rank; ++i)
    std::fprintf(stderr, " %llu",
                 static_cast<unsigned long long>(strides[i]));
  std::fprintf(stderr, ", box");
  for (int i = 0; i < rank; ++i) std::fprintf(stderr, " %u", box[i]);
  std::fprintf(stderr, "\n");
  return cudaErrorInvalidValue;
}

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a (B, H, N, D) tensor of T (bf16 or fp32) with element
// strides (batch, head, row) and a contiguous last dimension, box (W, R):
// zero-filled past N, swizzled as Atom<T, D>. A stride of a dimension of
// size 1 is never used; TMA still wants a multiple of 16, so it is
// replaced.
template <typename T, int D, int R>
cudaError_t bhnd_map(CUtensorMap* map, const void* base, int B, int H, int N,
                     const long long (&stride)[3]) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3];
  constexpr int kElem = static_cast<int>(sizeof(T));
  cuuint64_t span = D * kElem;
  for (int i = 0; i < 3; ++i) {
    const long long bytes = stride[2 - i] * kElem;  // row, head, batch
    span = (span + 15) / 16 * 16;
    strides[i] = dims[i + 1] == 1 ? span : static_cast<cuuint64_t>(bytes);
    span = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {Atom<T, D>::kCols, R, 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, kElem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, Atom<T, D>::kSwizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return encoded(r, 4, dims, strides, box);
}

}  // namespace pfst
