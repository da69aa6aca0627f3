// Dilated-neighborhood similarity, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pfst_tpu/ops/pallas_sim.py::_sim_kernel
// (launched by pallas_neighborhood_similarity). For every pixel (b, h, w)
// of an NCHW map it computes, for each of the k*k dilated neighbors in
// row-major nn.Unfold order (center at k*k/2):
//   cosine:   dot(n, c) / max(sqrt(sum n^2) * sqrt(sum c^2), 1e-8)
//   gaussian: exp(-sum (n - c)^2 / sigma^2)
// Neighbors outside the map read as 0 (the zero padding of (k/2)*d).
// Output is (B, k*k, H, W) fp32; input is fp32 or bf16, widened to fp32.
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
                            int C, int H, int W, int d, float sigma2) {
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
}

template <typename T, int K>
cudaError_t launch(const void* x, float* out, int B, int C, int H, int W,
                   int d, int cosine, float sigma, cudaStream_t stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  const T* xt = static_cast<const T*>(x);
  const float sigma2 = sigma * sigma;
  if (cosine) {
    neighborhood_sim_kernel<T, K, true>
        <<<grid, kThreads, 0, stream>>>(xt, out, C, H, W, d, sigma2);
  } else {
    neighborhood_sim_kernel<T, K, false>
        <<<grid, kThreads, 0, stream>>>(xt, out, C, H, W, d, sigma2);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_k(const void* x, float* out, int B, int C, int H,
                       int W, int k, int d, int cosine, float sigma,
                       cudaStream_t stream) {
  switch (k) {
    case 3: return launch<T, 3>(x, out, B, C, H, W, d, cosine, sigma, stream);
    case 5: return launch<T, 5>(x, out, B, C, H, W, d, cosine, sigma, stream);
    case 7: return launch<T, 7>(x, out, B, C, H, W, d, cosine, sigma, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer). Returns the
// cudaError_t of the launch; 0 means it was accepted.
extern "C" int pfst_neighborhood_sim(const void* x, float* out, int B, int C,
                                     int H, int W, int k, int d, int cosine,
                                     float sigma, int is_bf16, int device,
                                     void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || H <= 0 || W <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // launch on the tensor's device, and leave the caller's current device
  // as it was
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? dispatch_k<__nv_bfloat16>(x, out, B, C, H, W, k, d, cosine,
                                            sigma, s)
                : dispatch_k<float>(x, out, B, C, H, W, k, d, cosine, sigma,
                                    s);
  const cudaError_t restored = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : restored);
}

extern "C" const char* pfst_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
