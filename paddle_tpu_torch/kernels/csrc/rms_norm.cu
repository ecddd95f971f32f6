// RMSNorm forward for NVIDIA Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/rms_norm.py::_fwd (the Pallas body
// `_fwd_kernel`), y = x * rsqrt(mean(x^2) + eps) * w with f32 statistics and
// y in the input dtype. Forward only: serving needs no rstd, so the kernel
// does not write it (the backward comes with the training port).
//
// Bound on the H100: bytes. Every element of x is read once and every
// element of y written once; the weight vector is shared by all rows and
// stays in cache. The least time is 2 * rows * cols * sizeof(T) / 3.35 TB/s.
//
// Design: one block per row, sized so each thread has about four 16-byte
// vector loads (8 bf16 or 4 f32 each) in flight; the thread keeps its part
// of the row, and of the weight, in registers, so the
// scaling pass after the reduction reads nothing from device memory again.
// The sum of squares is taken in f32 with warp shuffles, then across warps
// through shared memory. At the decode shape (8 rows) the kernel is launch
// latency; at the prefill shape (thousands of rows) it streams.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxVecsPerThread = 8;
constexpr int kMaxThreads = 512;
constexpr int kVecsPerThread = 4;

template <typename T>
struct Pack;
template <>
struct Pack<float> {
  using V = float4;
  static constexpr int N = 4;
};
template <>
struct Pack<__nv_bfloat16> {
  using V = uint4;
  static constexpr int N = 8;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ y, int cols, float eps) {
  using V = typename Pack<T>::V;
  constexpr int N = Pack<T>::N;
  const int nvec = cols / N;
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  const V* xr = reinterpret_cast<const V*>(x + base);
  V* yr = reinterpret_cast<V*>(y + base);
  const V* wr = reinterpret_cast<const V*>(w);

  V cache[kMaxVecsPerThread];
  V wcache[kMaxVecsPerThread];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecsPerThread; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      cache[i] = xr[v];
      wcache[i] = wr[v];  // issued now, used after the reduction
      const T* e = reinterpret_cast<const T*>(&cache[i]);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  }

  __shared__ float partial[32];
  __shared__ float total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>(blockDim.x >> 5) ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) total = t;
  }
  __syncthreads();
  const float rstd = rsqrtf(total / static_cast<float>(cols) + eps);

#pragma unroll
  for (int i = 0; i < kMaxVecsPerThread; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      const T* e = reinterpret_cast<const T*>(&cache[i]);
      const T* we = reinterpret_cast<const T*>(&wcache[i]);
      V out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        o[j] = from_f32<T>(to_f32(e[j]) * rstd * to_f32(we[j]));
      }
      yr[v] = out;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int cols,
                   float eps, cudaStream_t stream) {
  const int nvec = cols / Pack<T>::N;
  if (cols % Pack<T>::N || nvec > kMaxThreads * kMaxVecsPerThread) {
    return cudaErrorInvalidValue;
  }
  // about kVecsPerThread loads in flight per thread, more rows per SM
  int threads = ((nvec + kVecsPerThread - 1) / kVecsPerThread + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  rms_norm_fwd_kernel<T><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      cols, eps);
  return cudaGetLastError();
}

}  // namespace

// y[rows, cols] = rms_norm(x[rows, cols]) * w[cols]; all three contiguous,
// 16-byte aligned, of one dtype (is_bf16: bfloat16, else float32). Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y, int rows,
                            int cols, float eps, int is_bf16, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, w, y, rows, cols, eps, s)
              : launch<float>(x, w, y, rows, cols, eps, s);
  return static_cast<int>(err);
}
