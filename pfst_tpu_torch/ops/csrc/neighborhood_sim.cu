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
// memory rate is the bound. Design: one thread per output pixel, with
// consecutive threads on consecutive w so every channel plane is read
// with coalesced loads; the k*k re-reads of a plane hit L1/L2, not
// device memory. The loop over C keeps k*k fp32 accumulators (2*k*k for
// cosine) in registers, so the unfolded (k*k x C) tensor never exists.
// Masked loads replace the padded copy the Pallas kernel makes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int K, bool COSINE>
__global__ void __launch_bounds__(kThreads)
    neighborhood_sim_kernel(const T* __restrict__ x, float* __restrict__ out,
                            float* __restrict__ norms, int C, int H, int W,
                            int d, float sigma2) {
  constexpr int KK = K * K;
  constexpr int R = K / 2;
  const int hw = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const int b = blockIdx.y;
  const int h = p / W;
  const int w = p - h * W;

  int off[KK];
  bool valid[KK];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int hh = h + (i - R) * d;
      const int ww = w + (j - R) * d;
      const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W;
      valid[i * K + j] = ok;
      off[i * K + j] = ok ? hh * W + ww : 0;
    }
  }

  float acc[KK];
  float nsq[KK];
  float csq = 0.f;
#pragma unroll
  for (int q = 0; q < KK; ++q) {
    acc[q] = 0.f;
    nsq[q] = 0.f;
  }

  const T* plane = x + static_cast<size_t>(b) * C * hw;
#pragma unroll 2
  for (int c = 0; c < C; ++c, plane += hw) {
    const float cv = widen(plane[p]);
    if constexpr (COSINE) csq += cv * cv;
#pragma unroll
    for (int q = 0; q < KK; ++q) {
      const float nv = valid[q] ? widen(plane[off[q]]) : 0.f;
      if constexpr (COSINE) {
        acc[q] += nv * cv;
        nsq[q] += nv * nv;
      } else {
        const float df = nv - cv;
        acc[q] += df * df;
      }
    }
  }

  float* o = out + static_cast<size_t>(b) * KK * hw + p;
  const float cn = sqrtf(csq);
#pragma unroll
  for (int q = 0; q < KK; ++q) {
    float s;
    if constexpr (COSINE) {
      s = acc[q] / fmaxf(sqrtf(nsq[q]) * cn, 1e-8f);
    } else {
      s = expf(-acc[q] / sigma2);
    }
    o[static_cast<size_t>(q) * hw] = s;
  }
  if constexpr (COSINE) {
    if (norms != nullptr) norms[static_cast<size_t>(b) * hw + p] = cn;
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, float* out, float* norms, int B, int C,
                   int H, int W, int d, int cosine, float sigma,
                   cudaStream_t stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  const T* xt = static_cast<const T*>(x);
  const float sigma2 = sigma * sigma;
  if (cosine) {
    neighborhood_sim_kernel<T, K, true>
        <<<grid, kThreads, 0, stream>>>(xt, out, norms, C, H, W, d, sigma2);
  } else {
    neighborhood_sim_kernel<T, K, false>
        <<<grid, kThreads, 0, stream>>>(xt, out, norms, C, H, W, d, sigma2);
  }
  return cudaGetLastError();
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
// saved, it writes grad_x in gather form, one thread per input pixel p and
// no atomics: p collects its own k*k "center" terms g_q(p) ds_q(p)/dc and
// the k*k "neighbor" terms g_q(r) ds_q(r)/dn of the pixels r = p - o_q
// that have p as their q-th neighbor. As p - o_q = p + o_(k*k-1-q), both
// read the same k*k pixels:
//   grad_x(p)[c] = sum_j W_j x(p + o_j)[c] - E x(p)[c]
// with per-pixel scalars W_j and E built from g, s and (cosine) the norms.
//   cosine, D = |n| |c|:  ds/dc = n / D - s c / |c|^2,
//                         ds/dn = c / D - s n / |n|^2   (D > 1e-8)
//                         n / 1e-8 and c / 1e-8         (D clamped)
//   gaussian:             ds/dc = 2 s (n - c) / sigma^2 = -ds/dn
// An out-of-map neighbor reads 0: its neighbor term is dropped, its
// center term is kept (nonzero for gaussian).
//
// What bounds it: one read of x and one write of grad_x, plus one read of
// sim, dL/dsim and the norms; about 2*k*k flops per element of x. At the
// training shape (2, 512, 64, 64) that is 34 MB (fp32; 17 MB bf16) against
// 0.08 GFLOP, so the memory rate is the bound (10.2 us fp32, 5.2 us bf16
// at the H100 SXM's 3.35 TB/s). Design: as the forward, one thread per
// pixel with consecutive threads on consecutive w (coalesced plane loads,
// the k*k re-reads hit L1/L2), the loop over C keeping one fp32
// accumulator; 64 threads a block so the 8,192 pixels of the training
// shape spread over 128 blocks.
constexpr int kBwdThreads = 64;

__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int K, bool COSINE>
__global__ void __launch_bounds__(kBwdThreads)
    neighborhood_sim_bwd_kernel(const T* __restrict__ x,
                                const float* __restrict__ sim,
                                const float* __restrict__ grad,
                                const float* __restrict__ norms,
                                T* __restrict__ grad_x, int C, int H, int W,
                                int d, float sigma2) {
  constexpr int KK = K * K;
  constexpr int R = K / 2;
  const int hw = H * W;
  const int p = blockIdx.x * kBwdThreads + threadIdx.x;
  if (p >= hw) return;
  const int b = blockIdx.y;
  const int h = p / W;
  const int w = p - h * W;

  int off[KK];
  bool valid[KK];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int hh = h + (i - R) * d;
      const int ww = w + (j - R) * d;
      const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W;
      valid[i * K + j] = ok;
      off[i * K + j] = ok ? hh * W + ww : 0;
    }
  }

  const float* s_b = sim + static_cast<size_t>(b) * KK * hw;
  const float* g_b = grad + static_cast<size_t>(b) * KK * hw;
  float wgt[KK];
#pragma unroll
  for (int q = 0; q < KK; ++q) wgt[q] = 0.f;
  float e = 0.f;
  if constexpr (COSINE) {
    const float* n_b = norms + static_cast<size_t>(b) * hw;
    const float nc = n_b[p];
    const float inv_c2 = nc > 0.f ? 1.f / (nc * nc) : 0.f;
#pragma unroll
    for (int q = 0; q < KK; ++q) {
      // center term: p is the center, x(p + o_q) the neighbor
      const float g = g_b[static_cast<size_t>(q) * hw + p];
      const float s = s_b[static_cast<size_t>(q) * hw + p];
      const float prod = (valid[q] ? n_b[off[q]] : 0.f) * nc;
      wgt[q] += g / fmaxf(prod, 1e-8f);
      if (prod > 1e-8f) e += g * s * inv_c2;
      // neighbor term: r = p - o_q = p + o_qf is the center
      const int qf = KK - 1 - q;
      if (valid[qf]) {
        const float gr = g_b[static_cast<size_t>(q) * hw + off[qf]];
        const float sr = s_b[static_cast<size_t>(q) * hw + off[qf]];
        const float prod_r = nc * n_b[off[qf]];
        wgt[qf] += gr / fmaxf(prod_r, 1e-8f);
        if (prod_r > 1e-8f) e += gr * sr * inv_c2;
      }
    }
  } else {
    const float scale = 2.f / sigma2;
#pragma unroll
    for (int q = 0; q < KK; ++q) {
      const float a = g_b[static_cast<size_t>(q) * hw + p] *
                      s_b[static_cast<size_t>(q) * hw + p] * scale;
      wgt[q] += a;
      e += a;
      const int qf = KK - 1 - q;
      if (valid[qf]) {
        const float a_r = g_b[static_cast<size_t>(q) * hw + off[qf]] *
                          s_b[static_cast<size_t>(q) * hw + off[qf]] * scale;
        wgt[qf] += a_r;
        e += a_r;
      }
    }
  }
  wgt[KK / 2] -= e;

  const T* plane = x + static_cast<size_t>(b) * C * hw;
  T* o = grad_x + static_cast<size_t>(b) * C * hw + p;
#pragma unroll 2
  for (int c = 0; c < C; ++c, plane += hw, o += hw) {
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < KK; ++q) {
      if (valid[q]) acc += wgt[q] * widen(plane[off[q]]);
    }
    narrow(o, acc);
  }
}

template <typename T, int K>
cudaError_t launch_bwd(const void* x, const float* sim, const float* norms,
                       const float* grad, void* grad_x, int B, int C, int H,
                       int W, int d, int cosine, float sigma,
                       cudaStream_t stream) {
  const dim3 grid((H * W + kBwdThreads - 1) / kBwdThreads, B);
  const T* xt = static_cast<const T*>(x);
  T* gt = static_cast<T*>(grad_x);
  if (cosine) {
    neighborhood_sim_bwd_kernel<T, K, true>
        <<<grid, kBwdThreads, 0, stream>>>(xt, sim, grad, norms, gt, C, H,
                                           W, d, sigma * sigma);
  } else {
    neighborhood_sim_bwd_kernel<T, K, false>
        <<<grid, kBwdThreads, 0, stream>>>(xt, sim, grad, norms, gt, C, H,
                                           W, d, sigma * sigma);
  }
  return cudaGetLastError();
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
