// Dilated-neighborhood similarity, forward and backward, for Hopper
// (sm_90a).
//
// The forward replaces the Pallas TPU kernel
// pfst_tpu/ops/pallas_sim.py::_sim_kernel (launched by
// pallas_neighborhood_similarity). For every pixel (b, h, w)
// of an NCHW map it computes, for each of the k*k dilated neighbors in
// row-major nn.Unfold order (center at k*k/2):
//   cosine:   dot(n, c) / max(sqrt(sum n^2) * sqrt(sum c^2), 1e-8)
//   gaussian: exp(-sum (n - c)^2 / sigma^2)
// Neighbors outside the map read as 0 (the zero padding of (k/2)*d).
// Output is (B, k*k, H, W) fp32; input is fp32 or bf16, widened to fp32.
// Given a (B, H, W) fp32 buffer, the cosine forward also writes there each
// pixel's norm sqrt(sum c^2), which it reduces anyway, for the backward.
//
// What bounds it: one read of the map and one write of the k*k planes,
// about 4*k*k flops per input element. At the serving shape
// (1, 512, 128, 128) that is 34 MB against 0.3 GFLOP, so the card's
// memory rate is the bound (10 us fp32 at 3.35 TB/s). The map fits the
// 50 MB L2, so what a design pays for is the traffic from L2 into the
// SMs: every staged row costs its halo, and a block that stages rows for
// one output row only re-reads each input row k times.
//
// Forward design. A block owns a row segment of 32 columns (one per lane)
// in RO output rows of one dilation coset, h and h + d (RO = 2; 1 for
// k = 7, whose 98 cosine partials fill the registers), and splits the
// channels across its warps: warp w takes channels [w cs, (w + 1) cs),
// cs = ceil(C / warps). Each warp streams its channels through its own
// ring of kStages stages in shared memory, a stage holding G channels:
// the k + RO - 1 rows h + (i - k/2) d of the segment and its halo, copied
// by cp.async (16-byte chunks where the row and base allow it, else 4
// bytes: one fp32 or a bf16 pair; plain loads for the bf16 cases whose
// pairs are not aligned) while the warp computes on an earlier stage,
// with only __syncwarp between them. Rows and columns outside the map are
// zero-filled. The two output rows share k - 1 of their staged rows, which
// cuts the L2 traffic and the shared-memory loads by a third against one
// output row a block. Each lane keeps its two pixels' k*k partial sums
// (2 k*k for cosine: dot and |n|^2; |c|^2 is the center's |n|^2) over its
// warp's channels in registers. The partials then meet in shared memory
// and are summed over the warps in a fixed order: deterministic, no
// atomics. The staged row is contiguous for d <= 32 (the segment, (k/2) d
// columns each side, a shift that aligns its start to the copy size): tap
// j is at column j d + shift + lane. For d > 32 the k windows of 32
// columns do not overlap and are staged side by side (tap j at 32 j +
// lane), which bounds a row at 32 k columns for any d. For d = 2, the
// dilation of the path, with 16-byte copies, the geometry is fixed at
// compile time (Fixed below): every tap offset is an immediate and each
// lane's copies are worked out once. 16 warps a block for k = 3, 8
// otherwise: (2, 512, 64, 64) gives 128 blocks of 16 warps,
// (1, 512, 128, 128) 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ptx.cuh"

namespace {

constexpr int kSeg = 32;       // columns of a block
constexpr int kMaxStage = 4;   // channels per stage, at most
constexpr int kStages = 2;     // stages of a forward warp's ring
constexpr int kRingBudget = 64 * 1024;  // bytes of a block's rings
constexpr int kFixedD = 2;     // the dilation with a compile-time geometry
constexpr int kFixedGroup = 4;  // forward channels per stage there

template <int K>
__host__ __device__ constexpr int fwd_warps() {
  return K == 3 ? 16 : 8;
}

// output rows of a block (a lane's pixels), forward and backward
template <int K>
__host__ __device__ constexpr int block_rows() {
  return K == 7 ? 1 : 2;
}

// The staging geometry of d = DS with 16-byte copies, at compile time.
template <typename T, int K, int DS>
struct Fixed {
  static constexpr int kUnit = 16 / static_cast<int>(sizeof(T));
  static constexpr int kShift = (kUnit - (K / 2 * DS) % kUnit) % kUnit;
  static constexpr int kChunks =
      (kShift + (K - 1) * DS + kSeg + kUnit - 1) / kUnit;
  static constexpr int kPitch = kChunks * kUnit;
  static constexpr int kCopies = (K + block_rows<K>() - 1) * kChunks;
  static constexpr int kSlots = (kCopies + 31) / 32;  // per lane
};

// The staging plan, the same for every block of a launch.
struct Plan {
  int span;    // staged columns between taps j and j + 1: d, or 32
  int shift;   // staged column of tap 0, lane 0
  int unit;    // elements per copy: 16 or 4 bytes by cp.async, or 1
               // (a bf16 element by a plain load)
  int chunks;  // copies per staged row
  int pitch;   // elements per staged row, a multiple of 16 bytes
  int group;   // channels per stage
  int cs;      // channels per warp
  bool fixed;  // d = kFixedD with 16-byte copies: Fixed's geometry
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One copy of u elements (u * sizeof(T) bytes) into shared memory, zero
// when !ok.
template <typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* src, bool ok,
                                           int u) {
  const int bytes = u * static_cast<int>(sizeof(T));
  if (bytes == 16) {
    pfst::cp_async16(dst, src, ok);
  } else if (bytes == 4) {
    pfst::cp_async4(dst, src, ok);
  } else {  // a bf16 element whose pair is not 4-byte aligned
    *reinterpret_cast<uint16_t*>(dst) =
        ok ? *reinterpret_cast<const uint16_t*>(src) : uint16_t{0};
  }
}

// One stage of a warp's ring: channels c, ..., c + group - 1 (those at or
// past c1 zero-filled), each as its SR staged rows h0 + (i - K/2) d.
template <typename T, int K, int SR>
__device__ __forceinline__ void stage_rows(T* buf, const T* x, const T* xb,
                                           long long hw, int c, int c1,
                                           int h0, int H, int W, int d,
                                           int lane, const int (&gcol)[K],
                                           const Plan& pl) {
  constexpr int R = K / 2;
  for (int g = 0; g < pl.group; ++g, ++c) {
    const T* xc = xb + (c < c1 ? c : 0) * hw;
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int hr = h0 + (i - R) * d;
      const bool row_ok = c < c1 && hr >= 0 && hr < H;
      const T* src = xc + (row_ok ? hr : 0) * static_cast<long long>(W);
      T* dst = buf + (g * SR + i) * pl.pitch;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int ch = lane + 32 * m;
        if (ch < pl.chunks) {
          const bool ok = row_ok && gcol[m] >= 0;
          stage_copy(dst + ch * pl.unit, ok ? src + gcol[m] : x, ok,
                     pl.unit);
        }
      }
    }
  }
}

// The same for the fixed geometry, G channels a stage: each lane issues
// its precomputed copies (source offset in the channel's plane, -1 for
// zero-fill; destination in the channel's slot of SR x pitch, -1 for
// none).
template <typename T, int S, int G>
__device__ __forceinline__ void stage_fixed(T* buf, const T* x, const T* xb,
                                            long long hw, int c, int c1,
                                            int slot, const int (&soff)[S],
                                            const int (&doff)[S]) {
#pragma unroll
  for (int g = 0; g < G; ++g, ++c) {
    const bool c_ok = c < c1;
    const T* xc = xb + (c_ok ? c : 0) * hw;
    T* dst = buf + g * slot;
#pragma unroll
    for (int m = 0; m < S; ++m) {
      if (doff[m] >= 0) {
        const bool ok = c_ok && soff[m] >= 0;
        pfst::cp_async16(dst + doff[m], ok ? xc + soff[m] : x, ok);
      }
    }
  }
}

// A lane's staging geometry for the block's segment at (h0, w0): Fixed's
// for DS (G channels a stage), else the plan's; with this lane's copies
// worked out once.
template <typename T, int K, int DS, int G>
struct Staging {
  using F = Fixed<T, K, DS ? DS : 1>;
  static constexpr int R = K / 2;
  static constexpr int SR = K + block_rows<K>() - 1;  // rows per channel
  static constexpr int S = DS ? F::kSlots : 1;
  int span, shift, pitch, group;
  int slot;  // a channel's rows in a stage
  // DS: this lane's copies of a channel; else the global column of each
  // of its copies in a staged row (-1 where the copy lies outside the map
  // or past the row's chunks)
  int soff[S], doff[S], gcol[DS ? 1 : K];

  __device__ __forceinline__ Staging(const Plan& pl, int h0, int w0, int H,
                                     int W, int d, int lane)
      : span(DS ? DS : pl.span),
        shift(DS ? F::kShift : pl.shift),
        pitch(DS ? F::kPitch : pl.pitch),
        group(DS ? G : pl.group),
        slot(SR * (DS ? F::kPitch : pl.pitch)) {
    if constexpr (DS != 0) {
#pragma unroll
      for (int m = 0; m < S; ++m) {
        const int e = lane + 32 * m;
        const int i = e / F::kChunks;
        const int ch = e - i * F::kChunks;
        const int hr = h0 + (i - R) * DS;
        const int col = w0 - R * DS - F::kShift + ch * F::kUnit;
        const bool in = e < F::kCopies;
        doff[m] = in ? i * F::kPitch + ch * F::kUnit : -1;
        soff[m] = in && hr >= 0 && hr < H && col >= 0 && col + F::kUnit <= W
                      ? hr * W + col
                      : -1;
      }
    } else {
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int ch = lane + 32 * m;
        const int o = ch * pl.unit - pl.shift;  // offset from tap 0, lane 0
        const int col = pl.span == d ? w0 - R * d + o
                                     : w0 + (o / 32 - R) * d + o % 32;
        gcol[m] = ch < pl.chunks && col >= 0 && col + pl.unit <= W ? col : -1;
      }
    }
  }

  __device__ __forceinline__ int stage_elems() const { return group * slot; }

  // channels c, ..., c + group - 1 of the image xb (those at or past c1
  // zero-filled) into the stage at buf
  __device__ __forceinline__ void copy(T* buf, const T* x, const T* xb,
                                       long long hw, int c, int c1, int h0,
                                       int H, int W, int d, int lane,
                                       const Plan& pl) const {
    if constexpr (DS != 0) {
      stage_fixed<T, S, G>(buf, x, xb, hw, c, c1, slot, soff, doff);
    } else {
      stage_rows<T, K, SR>(buf, x, xb, hw, c, c1, h0, H, W, d, lane, gcol,
                           pl);
    }
  }
};

// Streams channels [c0, c0 + cs) of the image xb (those at or past c1
// zero-filled) through this warp's ring of STAGES stages at ring: stage
// it + STAGES - 1 is copied by cp.async while stage it is computed, with
// only __syncwarp between the lanes. Calls ready() once, when the first
// stages' copies are in flight (every warp of the block calls it: cs is
// the same for all), and body(rows, c) for each channel c, where
// rows[i * pitch + j * span] is tap j of this lane's column in staged row
// i.
template <int STAGES, typename T, int K, int DS, int G, typename Ready,
          typename Body>
__device__ __forceinline__ void stream_channels(
    const Staging<T, K, DS, G>& st, T* ring, const T* x, const T* xb,
    long long hw, int c0, int c1, int cs, int h0, int H, int W, int d,
    int lane, const Plan& pl, Ready&& ready, Body&& body) {
  const int stage_elems = st.stage_elems();
  const int iters = (cs + st.group - 1) / st.group;
  for (int it = 1 - STAGES; it < iters; ++it) {
    // copy stage it + STAGES - 1 while stage it is computed; the first
    // STAGES - 1 rounds only copy
    const int next = it + STAGES - 1;
    if (next < iters) {
      st.copy(ring + next % STAGES * stage_elems, x, xb, hw,
              c0 + next * st.group, c1, h0, H, W, d, lane, pl);
    }
    pfst::cp_async_commit();
    if (it < 0) continue;
    if (it == 0) ready();
    pfst::cp_async_wait<STAGES - 1>();  // stage it, this lane's copies
    __syncwarp();                       // and every lane's
    const T* buf = ring + it % STAGES * stage_elems + st.shift + lane;
#pragma unroll
    for (int g = 0; g < st.group; ++g)
      body(buf + g * st.slot, c0 + it * st.group + g);
    __syncwarp();  // the stage is read; the next copy may overwrite it
  }
}

template <typename T, int K, bool COSINE, int DS>
__global__ void __launch_bounds__(fwd_warps<K>() * 32)
    neighborhood_sim_kernel(const T* __restrict__ x, float* __restrict__ out,
                            float* __restrict__ norms, int C, int H, int W,
                            int d, float sigma2, Plan pl) {
  constexpr int KK = K * K;
  constexpr int R = K / 2;
  constexpr int NW = fwd_warps<K>();
  constexpr int RO = block_rows<K>();
  constexpr int SR = K + RO - 1;           // staged rows per channel
  constexpr int V = COSINE ? 2 * KK : KK;  // partial sums per pixel
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int segs = (W + kSeg - 1) / kSeg;
  const int pair = blockIdx.x / segs;
  const int w0 = (blockIdx.x - pair * segs) * kSeg;
  // output rows h0 + r d, r < RO: pairs of one coset of rows modulo d
  const int h0 = pair / d * (RO * d) + pair % d;
  const int b = blockIdx.y;
  if (h0 >= H) return;  // the whole block
  const long long hw = static_cast<long long>(H) * W;

  const Staging<T, K, DS, kFixedGroup> st(pl, h0, w0, H, W, d, lane);
  // this warp's ring: [kStages][group][SR][pitch]
  T* ring = reinterpret_cast<T*>(smem) + warp * kStages * st.stage_elems();
  const int c0 = warp * pl.cs;
  const int c1 = c0 + pl.cs < C ? c0 + pl.cs : C;
  const T* xb = x + static_cast<long long>(b) * C * hw;

  float acc[RO][V];
#pragma unroll
  for (int r = 0; r < RO; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
  // channels past c1 were zero-filled and add nothing
  stream_channels<kStages>(
      st, ring, x, xb, hw, c0, c1, pl.cs, h0, H, W, d, lane, pl, [] {},
      [&](const T* rows, int) {
        float cv[RO];
#pragma unroll
        for (int r = 0; r < RO; ++r)
          cv[r] = widen(rows[(R + r) * st.pitch + R * st.span]);
        // staged row i is tap row i - r of output row r
#pragma unroll
        for (int i = 0; i < SR; ++i)
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const float nv = widen(rows[i * st.pitch + j * st.span]);
#pragma unroll
            for (int r = 0; r < RO; ++r) {
              const int q = (i - r) * K + j;
              if (i - r < 0 || i - r >= K) continue;
              if constexpr (COSINE) {
                acc[r][q] += nv * cv[r];
                acc[r][KK + q] += nv * nv;
              } else {
                const float df = nv - cv[r];
                acc[r][q] += df * df;
              }
            }
          }
      });

  // partials of all warps, [warp][RO][V][lane], over the rings
  pfst::cp_async_wait<0>();
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int r = 0; r < RO; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v)
      red[((warp * RO + r) * V + v) * 32 + lane] = acc[r][v];
  __syncthreads();
  for (int idx = threadIdx.x; idx < RO * KK * 32; idx += NW * 32) {
    const int r = idx / (KK * 32);
    const int q = (idx >> 5) - r * KK;
    const int l = idx & 31;
    const int h = h0 + r * d;
    const int w = w0 + l;
    if (h >= H || w >= W) continue;
    float sum = 0.f, nsq = 0.f, csq = 0.f;
#pragma unroll
    for (int wr = 0; wr < NW; ++wr) {
      const float* pr = red + (wr * RO + r) * V * 32 + l;
      sum += pr[q * 32];
      if constexpr (COSINE) {
        nsq += pr[(KK + q) * 32];
        csq += pr[(KK + KK / 2) * 32];
      }
    }
    const long long px = static_cast<long long>(h) * W + w;
    float s;
    if constexpr (COSINE) {
      const float cn = sqrtf(csq);
      s = sum / fmaxf(sqrtf(nsq) * cn, 1e-8f);
      if (q == KK / 2 && norms != nullptr) norms[b * hw + px] = cn;
    } else {
      s = expf(-sum / sigma2);
    }
    out[(static_cast<long long>(b) * KK + q) * hw + px] = s;
  }
}

// The staging plan of a launch whose blocks of nw warps split the
// channels, `stages` stages a warp's ring and fixed_group channels a stage
// on the fixed geometry; the bytes of a block's rings in *ring.
template <typename T, int K>
Plan make_plan(const void* x, int C, int W, int d, int nw, int stages,
               int fixed_group, size_t* ring) {
  constexpr int R = K / 2;
  constexpr int RO = block_rows<K>();
  constexpr int sz = static_cast<int>(sizeof(T));
  Plan pl{};
  pl.span = d <= kSeg ? d : kSeg;
  // the widest copy that the rows, the window starts and x's base allow
  pl.unit = 1;
  const int copies[2] = {16, 4};
  for (const int copy : copies) {
    const int u = copy / sz;
    if (W % u == 0 && (pl.span == d || d % u == 0) &&
        reinterpret_cast<uintptr_t>(x) % copy == 0) {
      pl.unit = u;
      break;
    }
  }
  // contiguous rows start at w0 - R d rounded down to a copy; w0 is a
  // multiple of 32, so the shift is the same in every block
  pl.shift = pl.span == d ? ((R * d) % pl.unit ? pl.unit - (R * d) % pl.unit
                                               : 0)
                          : 0;
  const int width = pl.shift + (K - 1) * pl.span + kSeg;
  pl.chunks = (width + pl.unit - 1) / pl.unit;
  const int align = 16 / sz;
  pl.pitch = (pl.chunks * pl.unit + align - 1) / align * align;
  pl.cs = (C + nw - 1) / nw;
  pl.fixed = d == kFixedD && pl.unit == align;
  const size_t per_channel =
      1ull * stages * nw * (K + RO - 1) * pl.pitch * sz;
  if (pl.fixed) {  // the same geometry as Fixed<T, K, kFixedD>
    pl.group = fixed_group;
  } else {
    int group = static_cast<int>(kRingBudget / per_channel);
    group = group < 1 ? 1 : group > kMaxStage ? kMaxStage : group;
    pl.group = group < pl.cs ? group : pl.cs;
  }
  *ring = per_channel * pl.group;
  return pl;
}

template <typename T, int K, bool COSINE, int DS>
cudaError_t start(dim3 grid, size_t bytes, cudaStream_t stream,
                  const T* x, float* out, float* norms, int C, int H, int W,
                  int d, float sigma2, const Plan& pl) {
  const cudaError_t err = cudaFuncSetAttribute(
      neighborhood_sim_kernel<T, K, COSINE, DS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  neighborhood_sim_kernel<T, K, COSINE, DS>
      <<<grid, fwd_warps<K>() * 32, bytes, stream>>>(x, out, norms, C, H, W,
                                                     d, sigma2, pl);
  return cudaGetLastError();
}

// blocks of a launch: (row pairs of one coset) x (segments of 32 columns)
template <int K>
int segments(int H, int W, int d) {
  constexpr int RO = block_rows<K>();
  const int pairs = (H + RO * d - 1) / (RO * d) * d;
  return pairs * ((W + kSeg - 1) / kSeg);
}

template <typename T, int K>
cudaError_t launch(const void* x, float* out, float* norms, int B, int C,
                   int H, int W, int d, int cosine, float sigma,
                   cudaStream_t stream) {
  size_t bytes = 0;
  const Plan pl = make_plan<T, K>(x, C, W, d, fwd_warps<K>(), kStages,
                                  kFixedGroup, &bytes);
  // the partials' reduction reuses the rings
  const size_t red = static_cast<size_t>(fwd_warps<K>()) * block_rows<K>() *
                     (cosine ? 2 : 1) * K * K * 32 * sizeof(float);
  bytes = bytes > red ? bytes : red;
  const dim3 grid(segments<K>(H, W, d), B);
  const T* xt = static_cast<const T*>(x);
  const float s2 = sigma * sigma;
  if (cosine)
    return pl.fixed ? start<T, K, true, kFixedD>(grid, bytes, stream, xt, out,
                                                 norms, C, H, W, d, s2, pl)
                    : start<T, K, true, 0>(grid, bytes, stream, xt, out,
                                           norms, C, H, W, d, s2, pl);
  return pl.fixed ? start<T, K, false, kFixedD>(grid, bytes, stream, xt, out,
                                                norms, C, H, W, d, s2, pl)
                  : start<T, K, false, 0>(grid, bytes, stream, xt, out,
                                          norms, C, H, W, d, s2, pl);
}

template <typename T>
cudaError_t dispatch_k(const void* x, float* out, float* norms, int B, int C,
                       int H, int W, int k, int d, int cosine, float sigma,
                       cudaStream_t stream) {
  switch (k) {
    case 3:
      return launch<T, 3>(x, out, norms, B, C, H, W, d, cosine, sigma,
                          stream);
    case 5:
      return launch<T, 5>(x, out, norms, B, C, H, W, d, cosine, sigma,
                          stream);
    case 7:
      return launch<T, 7>(x, out, norms, B, C, H, W, d, cosine, sigma,
                          stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------
// Backward. Replaces pfst_tpu/ops/pallas_sim.py::_pallas_sim_bwd, the
// custom VJP that differentiates the XLA shifted-slice formula on the TPU.
// Given x (B, C, H, W), the forward's sim and dL/dsim (B, k*k, H, W) fp32
// and, for cosine, the per-pixel norms (B, H, W) fp32 that the forward
// saved, it writes grad_x in gather form, with no atomics: each input
// pixel p collects its own k*k "center" terms g_q(p) ds_q(p)/dc and the
// k*k "neighbor" terms g_q(r) ds_q(r)/dn of the pixels r = p - o_q that
// have p as their q-th neighbor. As p - o_q = p + o_(k*k-1-q), both read
// the same k*k pixels:
//   grad_x(p)[c] = sum_j W_j x(p + o_j)[c]
// with per-pixel weights W_j built from g, s and (cosine) the norms, and
// -E folded into the center weight:
//   cosine, D = |n| |c|:  ds/dc = n / D - s c / |c|^2,
//                         ds/dn = c / D - s n / |n|^2   (D > 1e-8)
//                         n / 1e-8 and c / 1e-8         (D clamped)
//   gaussian:             ds/dc = 2 s (n - c) / sigma^2 = -ds/dn
// An out-of-map neighbor reads 0: its neighbor term is dropped, its
// center term is kept (nonzero for gaussian), and its weight is 0.
//
// What bounds it: one read of x and one write of grad_x, plus one read of
// sim, dL/dsim and the norms; about 2*k*k flops per element of x. At the
// training shape (2, 512, 64, 64) that is 34 MB (fp32; 17 MB bf16) against
// 0.08 GFLOP, so the memory rate is the bound (10.2 us fp32, 5.2 us bf16
// at the H100 SXM's 3.35 TB/s). The map fits the L2, so, as for the
// forward, what a design pays for is the traffic from L2 into the SMs and
// enough work in flight to cover its latency. The first design (one
// thread per pixel, each walking all C channels with 9 gathered loads
// and one store a channel) put 2 warps on an SM at that shape and ran at
// 15-50x the bound.
//
// Design: the forward's. A block owns the same row segment of 32 columns
// in RO output rows of one coset and splits the channels over its
// bwd_warps warps; (2, 512, 64, 64) gives 128 blocks of 16 warps, 32
// channels a warp (two blocks a segment, each with half the channels,
// measured a tie). The block first builds its pixels' k*k weights once:
// its threads share the RO * k*k * 32 (pixel, tap) terms, each reading
// sim and dL/dsim at p and at p + o_j and the norms at p and p + o_j (all
// L2-resident), and write W_j and each term's part of E to shared memory,
// while the warps' first stages are already in flight. Each lane then
// keeps its pixels' weights in registers, with -E folded into the center.
// Each warp streams its channels' k + RO - 1 staged rows through its
// cp.async ring (the forward's Staging and stream_channels, the same
// compile-time d = 2 geometry) and for each channel applies its pixels'
// weights to the staged taps and writes grad_x directly: a warp's stores
// of a channel's row are 32 consecutive elements. Each element is written
// once, by one lane, so the warps' sums never meet and two launches give
// bitwise-equal grad_x. Loading the taps from global memory through L1
// instead, with no staging, measured 1.5x slower. At the training shape
// this design runs at 1.5-1.6x the bound in fp32 and about 3x in bf16 on
// an H100 SXM; the staged copies alone take about three quarters of its
// fp32 time, and in bf16 the 2-byte taps and stores a lane most of the
// rest (PERF.md).
constexpr int kBwdStages = 2;  // stages of a warp's ring
constexpr int kBwdGroup = 4;   // channels per stage at d = kFixedD

template <int K>
__host__ __device__ constexpr int bwd_warps() {
  return K == 3 ? 16 : 8;
}

__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int K, bool COSINE, int DS>
__global__ void __launch_bounds__(bwd_warps<K>() * 32, 2)
    neighborhood_sim_bwd_kernel(const T* __restrict__ x,
                                const float* __restrict__ sim,
                                const float* __restrict__ grad,
                                const float* __restrict__ norms,
                                T* __restrict__ grad_x, int C, int H, int W,
                                int d, float sigma2, Plan pl) {
  constexpr int KK = K * K;
  constexpr int R = K / 2;
  constexpr int NW = bwd_warps<K>();
  constexpr int RO = block_rows<K>();
  constexpr int SR = K + RO - 1;  // staged rows per channel
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int segs = (W + kSeg - 1) / kSeg;
  const int pair = blockIdx.x / segs;
  const int w0 = (blockIdx.x - pair * segs) * kSeg;
  const int h0 = pair / d * (RO * d) + pair % d;
  const int b = blockIdx.y;
  if (h0 >= H) return;  // the whole block
  const long long hw = static_cast<long long>(H) * W;
  const int w = w0 + lane;
  // this lane's pixels: offset in a plane, -1 outside the map
  long long px[RO];
#pragma unroll
  for (int r = 0; r < RO; ++r)
    px[r] = h0 + r * d < H && w < W
                ? static_cast<long long>(h0 + r * d) * W + w
                : -1;

  // [RO][KK][32] weights W_j, then [RO][KK][32] parts of E; the rings
  // after them
  float* wsm = smem;
  float* esm = smem + RO * KK * 32;
  float wgt[RO][KK];
  auto build_weights = [&] {
    const float* s_b = sim + static_cast<long long>(b) * KK * hw;
    const float* g_b = grad + static_cast<long long>(b) * KK * hw;
    for (int idx = threadIdx.x; idx < RO * KK * 32; idx += NW * 32) {
      const int r = idx / (KK * 32);
      const int j = (idx >> 5) - r * KK;
      const int h = h0 + r * d;
      const int wl = w0 + (idx & 31);
      float wj = 0.f, ej = 0.f;
      if (h < H && wl < W) {
        const int hn = h + (j / K - R) * d;
        const int wn = wl + (j % K - R) * d;
        const bool in = hn >= 0 && hn < H && wn >= 0 && wn < W;
        const long long p = static_cast<long long>(h) * W + wl;
        const long long n = static_cast<long long>(hn) * W + wn;
        // plane j at p: p is the center, x(n) the neighbor; plane
        // KK - 1 - j at n = p + o_j: n is the center, x(p) its neighbor
        const long long pq = j * hw + p;
        const long long nq = (KK - 1 - j) * hw + n;
        if constexpr (COSINE) {
          const float* n_b = norms + static_cast<long long>(b) * hw;
          const float nc = n_b[p];
          const float inv_c2 = nc > 0.f ? 1.f / (nc * nc) : 0.f;
          const float prod = (in ? n_b[n] : 0.f) * nc;
          const float g = g_b[pq];
          wj = g / fmaxf(prod, 1e-8f);
          if (prod > 1e-8f) ej = g * s_b[pq] * inv_c2;
          if (in) {
            const float gr = g_b[nq];
            wj += gr / fmaxf(prod, 1e-8f);
            if (prod > 1e-8f) ej += gr * s_b[nq] * inv_c2;
          }
        } else {
          const float scale = 2.f / sigma2;
          wj = ej = g_b[pq] * s_b[pq] * scale;
          if (in) {
            const float a = g_b[nq] * s_b[nq] * scale;
            wj += a;
            ej += a;
          }
        }
        if (!in) wj = 0.f;
      }
      wsm[idx] = wj;
      esm[idx] = ej;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RO; ++r) {
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < KK; ++j) {
        wgt[r][j] = wsm[(r * KK + j) * 32 + lane];
        e += esm[(r * KK + j) * 32 + lane];
      }
      wgt[r][KK / 2] -= e;
    }
  };

  const int c0 = warp * pl.cs;
  const int c1 = c0 + pl.cs < C ? c0 + pl.cs : C;
  const T* xb = x + static_cast<long long>(b) * C * hw;
  T* gb = grad_x + static_cast<long long>(b) * C * hw;
  const Staging<T, K, DS, kBwdGroup> st(pl, h0, w0, H, W, d, lane);
  // this warp's ring: [kBwdStages][group][SR][pitch]
  T* ring = reinterpret_cast<T*>(smem + 2 * RO * KK * 32) +
            warp * kBwdStages * st.stage_elems();
  stream_channels<kBwdStages>(
      st, ring, x, xb, hw, c0, c1, pl.cs, h0, H, W, d, lane, pl,
      build_weights, [&](const T* rows, int c) {
        // grad_x of channel c at this lane's pixels
        float acc[RO];
#pragma unroll
        for (int r = 0; r < RO; ++r) acc[r] = 0.f;
        // staged row i is tap row i - r of output row r
#pragma unroll
        for (int i = 0; i < SR; ++i)
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const float v = widen(rows[i * st.pitch + j * st.span]);
#pragma unroll
            for (int r = 0; r < RO; ++r) {
              if (i - r < 0 || i - r >= K) continue;
              acc[r] += wgt[r][(i - r) * K + j] * v;
            }
          }
        if (c >= c1) return;
#pragma unroll
        for (int r = 0; r < RO; ++r)
          if (px[r] >= 0) narrow(gb + c * hw + px[r], acc[r]);
      });
}

template <typename T, int K, bool COSINE, int DS>
cudaError_t start_bwd(dim3 grid, size_t bytes, cudaStream_t stream,
                      const T* x, const float* sim, const float* grad,
                      const float* norms, T* grad_x, int C, int H, int W,
                      int d, float sigma2, const Plan& pl) {
  const cudaError_t err = cudaFuncSetAttribute(
      neighborhood_sim_bwd_kernel<T, K, COSINE, DS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  neighborhood_sim_bwd_kernel<T, K, COSINE, DS>
      <<<grid, bwd_warps<K>() * 32, bytes, stream>>>(
          x, sim, grad, norms, grad_x, C, H, W, d, sigma2, pl);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_bwd(const void* x, const float* sim, const float* norms,
                       const float* grad, void* grad_x, int B, int C, int H,
                       int W, int d, int cosine, float sigma,
                       cudaStream_t stream) {
  size_t ring = 0;
  const Plan pl = make_plan<T, K>(x, C, W, d, bwd_warps<K>(), kBwdStages,
                                  kBwdGroup, &ring);
  const size_t bytes =
      ring + 2ull * block_rows<K>() * K * K * 32 * sizeof(float);
  const dim3 grid(segments<K>(H, W, d), B);
  const T* xt = static_cast<const T*>(x);
  T* gt = static_cast<T*>(grad_x);
  const float s2 = sigma * sigma;
  if (cosine)
    return pl.fixed ? start_bwd<T, K, true, kFixedD>(
                          grid, bytes, stream, xt, sim, grad, norms, gt, C,
                          H, W, d, s2, pl)
                    : start_bwd<T, K, true, 0>(grid, bytes, stream, xt, sim,
                                               grad, norms, gt, C, H, W, d,
                                               s2, pl);
  return pl.fixed ? start_bwd<T, K, false, kFixedD>(grid, bytes, stream, xt,
                                                    sim, grad, norms, gt, C,
                                                    H, W, d, s2, pl)
                  : start_bwd<T, K, false, 0>(grid, bytes, stream, xt, sim,
                                              grad, norms, gt, C, H, W, d,
                                              s2, pl);
}

template <typename T>
cudaError_t dispatch_bwd_k(const void* x, const float* sim,
                           const float* norms, const float* grad,
                           void* grad_x, int B, int C, int H, int W, int k,
                           int d, int cosine, float sigma,
                           cudaStream_t stream) {
  switch (k) {
    case 3:
      return launch_bwd<T, 3>(x, sim, norms, grad, grad_x, B, C, H, W, d,
                              cosine, sigma, stream);
    case 5:
      return launch_bwd<T, 5>(x, sim, norms, grad, grad_x, B, C, H, W, d,
                              cosine, sigma, stream);
    case 7:
      return launch_bwd<T, 7>(x, sim, norms, grad, grad_x, B, C, H, W, d,
                              cosine, sigma, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer). `norms` is
// null, or for cosine a (B, H, W) fp32 buffer for the per-pixel norms.
// Returns the cudaError_t of the launch; 0 means it was accepted.
extern "C" int pfst_neighborhood_sim(const void* x, float* out, float* norms,
                                     int B, int C, int H, int W, int k, int d,
                                     int cosine, float sigma, int is_bf16,
                                     int device, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || H <= 0 || W <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // launch on the tensor's device, and leave the caller's current device
  // as it was
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? dispatch_k<__nv_bfloat16>(x, out, norms, B, C, H, W, k, d,
                                            cosine, sigma, s)
                : dispatch_k<float>(x, out, norms, B, C, H, W, k, d, cosine,
                                    sigma, s);
  const cudaError_t restored = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : restored);
}

// Backward: grad_x (B, C, H, W) in x's type (fp32, or bf16 when is_bf16)
// from x, sim and grad (B, k*k, H, W) fp32 and, for cosine, the forward's
// norms (B, H, W) fp32. One launch on `stream`. Returns the cudaError_t.
extern "C" int pfst_neighborhood_sim_backward(
    const void* x, const float* sim, const float* norms, const float* grad,
    void* grad_x, int B, int C, int H, int W, int k, int d, int cosine,
    float sigma, int is_bf16, int device, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || H <= 0 || W <= 0 || d <= 0 ||
      (cosine && norms == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? dispatch_bwd_k<__nv_bfloat16>(x, sim, norms, grad, grad_x,
                                                B, C, H, W, k, d, cosine,
                                                sigma, s)
                : dispatch_bwd_k<float>(x, sim, norms, grad, grad_x, B, C, H,
                                        W, k, d, cosine, sigma, s);
  const cudaError_t restored = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : restored);
}

extern "C" const char* pfst_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
