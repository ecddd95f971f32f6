// RMSNorm forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/rms_norm.py
// - rms_norm_fwd_kernel <- `_fwd` (the Pallas body `_fwd_kernel`):
//   y = x * rstd * w, rstd = rsqrt(mean(x^2) + eps), f32 statistics, y in
//   the input dtype; rstd ([rows] f32) is written only when asked for
//   (training saves it for the backward; serving passes null).
// - rms_norm_bwd_kernel + rms_norm_dw_kernel <- `_rms_bwd` (the Pallas body
//   `_bwd_kernel`): with xh = x * rstd and wg = g * w,
//   dx = rstd * (wg - xh * mean(wg * xh)), dw = sum over rows of g * xh.
//
// Bound on the H100: bytes. Forward: x read once, y written once, least time
// 2 * rows * cols * sizeof(T) / 3.35 TB/s. Backward: x and g read, dx
// written, 3 * rows * cols * sizeof(T) / 3.35 TB/s; w, rstd and dw are small.
//
// Forward design: one block per row, sized so each thread has about four
// 16-byte vector loads (8 bf16 or 4 f32 each) in flight; the thread keeps
// its part of the row, and of the weight, in registers, so the scaling pass
// after the reduction reads nothing from device memory again.
// The sum of squares is taken in f32 with warp shuffles, then across warps
// through shared memory. At the decode shape (8 rows) the kernel is launch
// latency; at the prefill shape (thousands of rows) it streams.
//
// Backward design: the Pallas kernel carries dw across its sequential grid
// in scratch; CUDA blocks run in no order, so each of n_part blocks walks
// rows blockIdx.x, + gridDim.x, ... keeping w and its columns' dw sums in
// registers, writes its f32 dw partial row, and a second small kernel sums
// the n_part partials of each column in a fixed order and casts to w's
// dtype: no atomics, the result is deterministic.

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

// sum of v over the block; partial holds 32 floats. Every thread returns
// the total.
__device__ __forceinline__ float block_sum(float v, float* partial,
                                           float* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>(blockDim.x >> 5) ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) *total = t;
  }
  __syncthreads();
  return *total;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ y, float* __restrict__ rstd_out,
                        int cols, float eps) {
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
  ss = block_sum(ss, partial, &total);
  const float rstd = rsqrtf(ss / static_cast<float>(cols) + eps);
  if (rstd_out != nullptr && threadIdx.x == 0) rstd_out[blockIdx.x] = rstd;

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

constexpr int kBwdMaxThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kBwdMaxThreads)
    rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ rstd,
                        const T* __restrict__ g, T* __restrict__ dx,
                        float* __restrict__ dw_part, int rows, int cols) {
  using V = typename Pack<T>::V;
  constexpr int N = Pack<T>::N;
  const int nvec = cols / N;
  const V* wr = reinterpret_cast<const V*>(w);
  V wcache[kMaxVecsPerThread];
  float dw[kMaxVecsPerThread][N];
#pragma unroll
  for (int i = 0; i < kMaxVecsPerThread; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) wcache[i] = wr[v];
#pragma unroll
    for (int j = 0; j < N; ++j) dw[i][j] = 0.f;
  }
  __shared__ float partial[32];
  __shared__ float total;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * cols;
    const V* xr = reinterpret_cast<const V*>(x + base);
    const V* gr = reinterpret_cast<const V*>(g + base);
    V* dxr = reinterpret_cast<V*>(dx + base);
    const float rs = rstd[row];
    V xc[kMaxVecsPerThread];
    V gc[kMaxVecsPerThread];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxVecsPerThread; ++i) {
      const int v = threadIdx.x + i * blockDim.x;
      if (v < nvec) {
        xc[i] = xr[v];
        gc[i] = gr[v];
        const T* xe = reinterpret_cast<const T*>(&xc[i]);
        const T* ge = reinterpret_cast<const T*>(&gc[i]);
        const T* we = reinterpret_cast<const T*>(&wcache[i]);
#pragma unroll
        for (int j = 0; j < N; ++j)
          dot += to_f32(ge[j]) * to_f32(we[j]) * (to_f32(xe[j]) * rs);
      }
    }
    const float mean = block_sum(dot, partial, &total) /
                       static_cast<float>(cols);
#pragma unroll
    for (int i = 0; i < kMaxVecsPerThread; ++i) {
      const int v = threadIdx.x + i * blockDim.x;
      if (v < nvec) {
        const T* xe = reinterpret_cast<const T*>(&xc[i]);
        const T* ge = reinterpret_cast<const T*>(&gc[i]);
        const T* we = reinterpret_cast<const T*>(&wcache[i]);
        V out;
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float xh = to_f32(xe[j]) * rs;
          const float gf = to_f32(ge[j]);
          o[j] = from_f32<T>(rs * (gf * to_f32(we[j]) - xh * mean));
          dw[i][j] += gf * xh;
        }
        dxr[v] = out;
      }
    }
  }
  float* part = dw_part + static_cast<size_t>(blockIdx.x) * cols;
#pragma unroll
  for (int i = 0; i < kMaxVecsPerThread; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
#pragma unroll
      for (int j = 0; j < N; ++j) part[v * N + j] = dw[i][j];
    }
  }
}

// dw[c] = sum over the n_part partial rows of column c, in a fixed order:
// blocks of 32 columns x 8 row strides, the 8 strides summed in order.
template <typename T>
__global__ void rms_norm_dw_kernel(const float* __restrict__ dw_part,
                                   T* __restrict__ dw, int n_part, int cols) {
  __shared__ float acc[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < cols) {
    for (int b = threadIdx.y; b < n_part; b += 8)
      s += dw_part[static_cast<size_t>(b) * cols + c];
  }
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y) t += acc[y][threadIdx.x];
    dw[c] = from_f32<T>(t);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* rstd,
                       const void* g, void* dx, void* dw, void* dw_part,
                       int rows, int cols, int n_part, cudaStream_t stream) {
  const int nvec = cols / Pack<T>::N;
  if (cols % Pack<T>::N || nvec > kBwdMaxThreads * kMaxVecsPerThread ||
      n_part <= 0 || n_part > rows) {
    return cudaErrorInvalidValue;
  }
  int threads = ((nvec + kVecsPerThread - 1) / kVecsPerThread + 31) / 32 * 32;
  if (threads > kBwdMaxThreads) threads = kBwdMaxThreads;
  if (threads < 32) threads = 32;
  if (nvec > threads * kMaxVecsPerThread) return cudaErrorInvalidValue;
  rms_norm_bwd_kernel<T><<<n_part, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(rstd), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<float*>(dw_part), rows, cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_norm_dw_kernel<T><<<(cols + 31) / 32, dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(dw_part), static_cast<T*>(dw), n_part, cols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, float* rstd,
                   int rows, int cols, float eps, cudaStream_t stream) {
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
      rstd, cols, eps);
  return cudaGetLastError();
}

}  // namespace

// y[rows, cols] = rms_norm(x[rows, cols]) * w[cols]; all three contiguous,
// 16-byte aligned, of one dtype (is_bf16: bfloat16, else float32); rstd:
// null, or [rows] float32 to receive rsqrt(mean(x^2) + eps). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y, void* rstd,
                            int rows, int cols, float eps, int is_bf16,
                            void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, w, y, r, rows, cols, eps, s)
              : launch<float>(x, w, y, r, rows, cols, eps, s);
  return static_cast<int>(err);
}

// dx[rows, cols] and dw[cols] of y = rms_norm(x) * w given g = dL/dy and the
// forward's rstd [rows] (float32). x, g, dx, w, dw contiguous, 16-byte
// aligned, of one dtype (is_bf16: bfloat16, else float32); dw_part is
// float32 scratch of [n_part, cols], 1 <= n_part <= rows (the number of
// blocks). Launches two kernels on `stream`; returns cudaGetLastError().
extern "C" int rms_norm_bwd(const void* x, const void* w, const void* rstd,
                            const void* g, void* dx, void* dw, void* dw_part,
                            int rows, int cols, int n_part, int is_bf16,
                            void* stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_bwd<__nv_bfloat16>(x, w, rstd, g, dx, dw, dw_part, rows,
                                          cols, n_part, s)
              : launch_bwd<float>(x, w, rstd, g, dx, dw, dw_part, rows, cols,
                                  n_part, s);
  return static_cast<int>(err);
}
