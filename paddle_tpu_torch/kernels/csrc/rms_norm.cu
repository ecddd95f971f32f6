// RMSNorm forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/rms_norm.py
// - rms_norm_fwd_ring / _stream <- `_fwd` (the Pallas body
//   `_fwd_kernel`): y = x * rstd * w, rstd = rsqrt(mean(x^2) + eps), f32
//   statistics, y in x's dtype; rstd ([rows] f32) is written only when asked
//   for (training saves it for the backward; serving passes null).
// - rms_norm_bwd_ring / _stream <- `_rms_bwd` (the Pallas body
//   `_bwd_kernel`): with xh = x * rstd and wg = g * w,
//   dx = rstd * (wg - xh * mean(wg * xh)), dw = sum over rows of g * xh,
//   dx and dw in one launch.
// x and g are float32, bfloat16 or float16 [rows, cols], any rows, cols >= 1
// and any element-aligned address; the weight [cols] is in x's dtype or
// float32 (dw in the weight's dtype), or none: a scale of 1 and no dw.
//
// Bound on the H100: bytes. Forward: x read once, y written once, least time
// 2 * rows * cols * sizeof(T) / 3.35 TB/s. Backward: x and g read, dx
// written, 3 * rows * cols * sizeof(T) / 3.35 TB/s; w, rstd and dw are small.
//
// Design: persistent blocks, as many as the SMs hold at once (at most one
// per row), block b taking rows b, b + grid, ...; each block loads the
// weight once, as f32, into shared memory, so a row's bytes cross L2 once.
// - Ring instances (every row of every array 16-byte aligned, at most
//   2048 16-byte vectors a row): thread 0 keeps the block's next rows in
//   flight by 1-D bulk copies (cp.async.bulk completing on one mbarrier per
//   buffer) into a ring of 2-4 row buffers (x, and g for the backward), up
//   to `stages` rows ahead. A row costs one block barrier: the threads
//   read their vectors into registers and add their squares (forward) or
//   wg * xh (backward); the barrier of that block sum also frees the
//   buffer, which thread 0 refills while the others scale and store.
// - Direct instances (the ring's arrays and a 16-byte aligned weight, at
//   most one row an SM, as at decode, where a block has no next row to
//   bring ahead): one row a block straight from device memory into
//   registers, the weight's 16-byte chunks loaded beside it.
// - Stream instances (any other width or alignment): the same walk without
//   the ring, two passes over each row from device memory (the second from
//   L2), 16 bytes at a time where the address allows and element by element
//   at the edges (`load_elems`). The backward's dw sums go to the block's
//   partial row in device memory.
// - dw in the same launch: each block writes the f32 sums of its rows as its
//   partial row of `part` [grid, cols] and takes a ticket. Every block then
//   waits until all grid partials are in (the grid is at most what the card
//   holds at once), sums the slice of the columns its ticket names over the
//   partials in block order and casts to the weight's dtype; the last to
//   finish resets the ticket to 0. (A single reducing block, the last to
//   take a ticket, measured 3x slower on the H100 at [4096, 4096]: one SM
//   then reads every partial.)
//   The sums run in a fixed order for a given grid: two calls are bitwise
//   equal, and the launch leaves the ticket as it found it (safe to replay
//   in a CUDA graph). Launches that share a ticket must not overlap.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sm90.cuh"

namespace {

// ring and direct: a thread's 16-byte vectors of a row, at most (2 up to
// 1024 vectors a row, then 4: more warps an SM at the model widths)
constexpr int kVptNarrow = 2;
constexpr int kVpt = 4;
constexpr int kMaxThreads = 512;
constexpr int kMaxStages = 4;
// a ring block's dynamic shared memory: the 227 KB a block may opt in to,
// less room for the static arrays (the block sums, the dw reduction's)
constexpr int kSmemMax = 232448 - 12288;

enum { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
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
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// 16 bytes of E <-> 16 / sizeof(E) floats
template <typename E>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const E* e = reinterpret_cast<const E*>(&u);
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(E)); ++j)
    f[j] = to_f32(e[j]);
}
template <typename E>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 u;
  E* e = reinterpret_cast<E*>(&u);
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(E)); ++j)
    e[j] = from_f32<E>(f[j]);
  return u;
}

// f[j] = row[e0 + j] for j < n, 0 outside [0, cols): 16-byte loads where the
// n elements lie in the row at a 16-byte aligned address, else one load per
// element (a row's edges, or an array whose rows are not 16-byte aligned)
template <typename E, int n>
__device__ __forceinline__ void load_elems(const E* __restrict__ row, int e0,
                                           int cols, float (&f)[n]) {
  static_assert(n * sizeof(E) % 16 == 0, "whole 16-byte chunks");
  constexpr int kPer = 16 / sizeof(E);
  const uintptr_t a = reinterpret_cast<uintptr_t>(row) +
                      static_cast<intptr_t>(e0) * sizeof(E);
  if (e0 >= 0 && e0 + n <= cols && (a & 15) == 0) {
    const uint4* p = reinterpret_cast<const uint4*>(a);
#pragma unroll
    for (int c = 0; c < n / kPer; ++c) unpack<E>(p[c], f + c * kPer);
  } else {
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const int e = e0 + j;
      f[j] = e >= 0 && e < cols ? to_f32(row[e]) : 0.f;
    }
  }
}

// row[e0 + j] = f[j] for the j < n with e0 + j in [0, cols), as load_elems
template <typename E, int n>
__device__ __forceinline__ void store_elems(E* __restrict__ row, int e0,
                                            int cols, const float (&f)[n]) {
  constexpr int kPer = 16 / sizeof(E);
  const uintptr_t a = reinterpret_cast<uintptr_t>(row) +
                      static_cast<intptr_t>(e0) * sizeof(E);
  if (e0 >= 0 && e0 + n <= cols && (a & 15) == 0) {
    uint4* p = reinterpret_cast<uint4*>(a);
#pragma unroll
    for (int c = 0; c < n / kPer; ++c) p[c] = pack<E>(f + c * kPer);
  } else {
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const int e = e0 + j;
      if (e >= 0 && e < cols) row[e] = from_f32<E>(f[j]);
    }
  }
}

// the weight's elements e0 .. e0 + n - 1 as f32 (1 where there is none)
template <typename TW, int n>
__device__ __forceinline__ void load_weight(const TW* __restrict__ w, int e0,
                                            int cols, float (&f)[n]) {
  if (w == nullptr) {
#pragma unroll
    for (int j = 0; j < n; ++j) f[j] = 1.f;
  } else {
    load_elems<TW, n>(w, e0, cols, f);
  }
}

// the weight as f32 into w_s[0, cols)
template <typename TW>
__device__ __forceinline__ void stage_weight(const TW* __restrict__ w,
                                             float* w_s, int cols) {
  for (int c = threadIdx.x * 8; c < cols; c += blockDim.x * 8) {
    float f[8];
    load_weight<TW, 8>(w, c, cols, f);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c + j < cols) w_s[c + j] = f[j];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum of v over the block, the same value in every thread (the warps'
// sums added in warp order). red: 32 floats, used by every other call (the
// callers alternate two), so that one barrier a call suffices.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  const int warps = blockDim.x >> 5;
  for (int i = 0; i < warps; ++i) t += red[i];
  return t;
}

// the threads' reads of a ring buffer (generic proxy), ordered by a block
// barrier, before the bulk copy that refills it (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// partial row b's unit u: 4 columns (a float4) where cols % 4 == 0, else 1
__device__ __forceinline__ float4 load_unit(const float* part, int b, int u,
                                            int cols, bool quads) {
  const float* row = part + static_cast<size_t>(b) * cols;
  if (quads) return __ldcg(reinterpret_cast<const float4*>(row) + u);
  return make_float4(__ldcg(row + u), 0.f, 0.f, 0.f);
}

template <typename TW>
__device__ __forceinline__ void store_unit(TW* dw, int u, bool quads,
                                           float4 s) {
  if (quads) {
    dw[4 * u] = from_f32<TW>(s.x);
    dw[4 * u + 1] = from_f32<TW>(s.y);
    dw[4 * u + 2] = from_f32<TW>(s.z);
    dw[4 * u + 3] = from_f32<TW>(s.w);
  } else {
    dw[u] = from_f32<TW>(s.x);
  }
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// dw = the sum over the grid's partial rows part[b], in the launch that
// wrote them (see the file's head). Every block calls it once its partial
// row is written; the t-th to take a ticket sums slice t of the columns,
// cut into units (4 columns, or 1 where cols % 4 != 0): `groups` threads a
// unit each sum one run of the partial rows, in order, 8 loads in flight,
// and the runs' sums are added in run order, a fixed order for a given
// grid whichever block takes the slice.
template <typename TW>
__device__ void reduce_dw(const float* part, TW* __restrict__ dw,
                          unsigned* ticket, int cols) {
  __shared__ unsigned taken;
  __shared__ float4 sums[kMaxThreads];
  const int nb = static_cast<int>(gridDim.x);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // the block's partial row (cumulative over the
                      // barrier), before its ticket
    taken = atomicAdd(ticket, 1u);
  }
  __syncthreads();
  const int slice = static_cast<int>(taken);
  if (threadIdx.x == 0) {
    // every block has taken its ticket: every partial is written; a wait
    // that never ends traps instead of hanging the card
    for (uint32_t spins = 0; ld_acquire(ticket) < static_cast<unsigned>(nb);
         ++spins) {
      if (spins == (1u << 24)) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
  const bool quads = cols % 4 == 0;
  const int units = quads ? cols / 4 : cols;
  const int per = (units + nb - 1) / nb;
  const int u0 = slice * per;
  const int span = min(units, u0 + per) - u0;
  if (span > 0) {
    const int threads = static_cast<int>(blockDim.x);
    const int groups = max(1, min(threads / span, nb));
    for (int t = threadIdx.x; t < span * groups; t += threads) {
      const int k = t / span;
      const int u = u0 + t % span;
      const int b1 = (k + 1) * nb / groups;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int b = k * nb / groups; b < b1; b += 8) {
        float4 v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (b + q < b1) v[q] = load_unit(part, b + q, u, cols, quads);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (b + q < b1) add4(s, v[q]);
      }
      if (groups == 1) {
        store_unit(dw, u, quads, s);
      } else {
        sums[t] = s;  // groups > 1: span * groups <= threads, one pass
      }
    }
    if (groups > 1) {
      __syncthreads();
      if (static_cast<int>(threadIdx.x) < span) {
        float4 s = sums[threadIdx.x];
        for (int k = 1; k < groups; ++k)
          add4(s, sums[k * span + threadIdx.x]);
        store_unit(dw, u0 + threadIdx.x, quads, s);
      }
    }
  }
  __syncthreads();
  // the last block past its wait resets the ticket for the next launch
  if (threadIdx.x == 0 &&
      atomicAdd(ticket, 1u) == static_cast<unsigned>(2 * nb - 1))
    atomicExch(ticket, 0u);
}

// the weight's elements v * n .. v * n + n - 1 from shared memory (f32)
template <int n>
__device__ __forceinline__ void weight_vec(const float* w_s, int v,
                                           float (&f)[n]) {
  const float4* p = reinterpret_cast<const float4*>(w_s + v * n);
#pragma unroll
  for (int q = 0; q < n / 4; ++q) {
    const float4 t = p[q];
    f[4 * q] = t.x;
    f[4 * q + 1] = t.y;
    f[4 * q + 2] = t.z;
    f[4 * q + 3] = t.w;
  }
}

// the direct instances' weight: vector v's 16-byte chunks as stored (w
// 16-byte aligned), loaded beside x's before the block sum, converted after
template <typename T, typename TW, int V>
struct WeightRegs {
  static constexpr int N = 16 / sizeof(T);
  static constexpr int kChunks = N * sizeof(TW) / 16;
  uint4 raw[V][kChunks];
  __device__ __forceinline__ void load(const TW* w, int k, int v) {
    if (w != nullptr) {
      const uint4* p = reinterpret_cast<const uint4*>(w + v * N);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) raw[k][c] = p[c];
    }
  }
  __device__ __forceinline__ void get(const TW* w, int k,
                                      float (&f)[N]) const {
    if (w == nullptr) {
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = 1.f;
    } else {
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        unpack<TW>(raw[k][c], f + c * (16 / sizeof(TW)));
    }
  }
};

// shared memory of a ring instance: the weight (f32), the row buffers, one
// mbarrier a buffer
struct Ring {
  float* w_s;
  unsigned char* buf;
  uint64_t* full;
  int slot;  // bytes a buffer
};
__device__ __forceinline__ Ring ring_layout(unsigned char* smem, int cols,
                                            int row_bytes, int rows_a_slot,
                                            int stages) {
  Ring r;
  r.w_s = reinterpret_cast<float*>(smem);
  r.buf = smem + round_up(cols * 4, 128);
  r.slot = round_up(row_bytes, 128) * rows_a_slot;
  r.full = reinterpret_cast<uint64_t*>(r.buf + stages * r.slot);
  return r;
}

// kDirect (a grid of one row a block, as at decode, where there is no next
// row to bring ahead): the row straight from device memory into registers
// and the weight beside it, no ring; else the ring
template <typename T, typename TW, bool kDirect, int V>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_fwd_ring(const T* __restrict__ x, const TW* __restrict__ w,
                      T* __restrict__ y, float* __restrict__ rstd, int rows,
                      int cols, float eps, int stages) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][32];
  const int tid = threadIdx.x;
  const int nv = cols / N;
  const int row_bytes = cols * static_cast<int>(sizeof(T));
  const Ring r = ring_layout(smem, cols, row_bytes, 1, stages);
  const int step = gridDim.x;
  const int n_rows = (rows - static_cast<int>(blockIdx.x) + step - 1) / step;
  auto fetch = [&](int i) {
    const int s = i % stages;
    const uint32_t bar = sm90::smem_u32(r.full + s);
    fence_proxy_async();
    sm90::mbar_expect_tx(bar, row_bytes);
    sm90::bulk_copy(
        sm90::smem_u32(r.buf + s * r.slot),
        x + static_cast<size_t>(blockIdx.x + i * step) * cols, row_bytes,
        bar);
  };
  if constexpr (!kDirect) {
    if (tid == 0) {
      for (int s = 0; s < stages; ++s)
        sm90::mbar_init(sm90::smem_u32(r.full + s), 1);
      sm90::mbar_init_fence();
      for (int i = 0; i < stages && i < n_rows; ++i) fetch(i);
    }
    stage_weight(w, r.w_s, cols);
    __syncthreads();
  }
  WeightRegs<T, TW, V> wr;  // direct: the weight, in registers
  for (int i = 0; i < n_rows; ++i) {
    const int row = blockIdx.x + i * step;
    const int s = i % stages;
    const uint4* src;
    if constexpr (kDirect) {
      src = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) *
                                                   cols);
    } else {
      src = reinterpret_cast<const uint4*>(r.buf + s * r.slot);
      sm90::mbar_wait(sm90::smem_u32(r.full + s), (i / stages) & 1);
    }
    uint4 xv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int v = tid + k * blockDim.x;
      if (v < nv) {
        xv[k] = src[v];
        if constexpr (kDirect) wr.load(w, k, v);
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int v = tid + k * blockDim.x;
      if (v < nv) {
        float f[N];
        unpack<T>(xv[k], f);
#pragma unroll
        for (int j = 0; j < N; ++j) ss += f[j] * f[j];
      }
    }
    ss = block_sum(ss, red[i & 1]);
    // every thread holds its vectors: the buffer takes the row `stages` on
    if constexpr (!kDirect) {
      if (tid == 0 && i + stages < n_rows) fetch(i + stages);
    }
    const float rs = rsqrtf(ss / static_cast<float>(cols) + eps);
    if (rstd != nullptr && tid == 0) rstd[row] = rs;
    uint4* yr = reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * cols);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int v = tid + k * blockDim.x;
      if (v < nv) {
        float f[N], wf[N];
        unpack<T>(xv[k], f);
        if constexpr (kDirect) {
          wr.get(w, k, wf);
        } else {
          weight_vec(r.w_s, v, wf);
        }
#pragma unroll
        for (int j = 0; j < N; ++j) f[j] = f[j] * rs * wf[j];
        yr[v] = pack<T>(f);
      }
    }
  }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_fwd_stream(const T* __restrict__ x, const TW* __restrict__ w,
                        T* __restrict__ y, float* __restrict__ rstd, int rows,
                        int cols, float eps) {
  constexpr int N = 16 / sizeof(T);
  __shared__ float red[2][32];
  int par = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, par ^= 1) {
    const T* xr = x + static_cast<size_t>(row) * cols;
    T* yr = y + static_cast<size_t>(row) * cols;
    // vectors aligned to x's row: vector v holds elements v * N - q ..
    const int q = static_cast<int>(reinterpret_cast<uintptr_t>(xr) & 15) /
                  static_cast<int>(sizeof(T));
    const int nv = (q + cols + N - 1) / N;
    float ss = 0.f;
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      float f[N];
      load_elems<T, N>(xr, v * N - q, cols, f);
#pragma unroll
      for (int j = 0; j < N; ++j) ss += f[j] * f[j];
    }
    ss = block_sum(ss, red[par]);
    const float rs = rsqrtf(ss / static_cast<float>(cols) + eps);
    if (rstd != nullptr && threadIdx.x == 0) rstd[row] = rs;
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      const int e0 = v * N - q;
      float f[N], wf[N];
      load_elems<T, N>(xr, e0, cols, f);
      load_weight<TW, N>(w, e0, cols, wf);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = f[j] * rs * wf[j];
      store_elems<T, N>(yr, e0, cols, f);
    }
  }
}

// kDirect as in rms_norm_fwd_ring
template <typename T, typename TW, bool kDirect, int V>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_bwd_ring(const T* __restrict__ x, const TW* __restrict__ w,
                      const float* __restrict__ rstd,
                      const T* __restrict__ g, T* __restrict__ dx,
                      TW* __restrict__ dw, float* __restrict__ part,
                      unsigned* ticket, int rows, int cols, int stages) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][32];
  const int tid = threadIdx.x;
  const int nv = cols / N;
  const int row_bytes = cols * static_cast<int>(sizeof(T));
  const Ring r = ring_layout(smem, cols, row_bytes, 2, stages);
  const int g_off = r.slot / 2;  // a buffer: x's row, then g's
  const int step = gridDim.x;
  const int n_rows = (rows - static_cast<int>(blockIdx.x) + step - 1) / step;
  auto fetch = [&](int i) {
    const int s = i % stages;
    const uint32_t bar = sm90::smem_u32(r.full + s);
    const size_t at = static_cast<size_t>(blockIdx.x + i * step) * cols;
    fence_proxy_async();
    sm90::mbar_expect_tx(bar, 2 * row_bytes);
    sm90::bulk_copy(sm90::smem_u32(r.buf + s * r.slot), x + at, row_bytes,
                    bar);
    sm90::bulk_copy(sm90::smem_u32(r.buf + s * r.slot + g_off), g + at,
                    row_bytes, bar);
  };
  if constexpr (!kDirect) {
    if (tid == 0) {
      for (int s = 0; s < stages; ++s)
        sm90::mbar_init(sm90::smem_u32(r.full + s), 1);
      sm90::mbar_init_fence();
      for (int i = 0; i < stages && i < n_rows; ++i) fetch(i);
    }
    stage_weight(w, r.w_s, cols);
    __syncthreads();
  }
  WeightRegs<T, TW, V> wr;  // direct: the weight, in registers
  float acc[V][N];
#pragma unroll
  for (int k = 0; k < V; ++k)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[k][j] = 0.f;
  for (int i = 0; i < n_rows; ++i) {
    const int row = blockIdx.x + i * step;
    const int s = i % stages;
    const float rs = rstd[row];
    const uint4 *sx, *sg;
    if constexpr (kDirect) {
      const size_t at = static_cast<size_t>(row) * cols;
      sx = reinterpret_cast<const uint4*>(x + at);
      sg = reinterpret_cast<const uint4*>(g + at);
    } else {
      sx = reinterpret_cast<const uint4*>(r.buf + s * r.slot);
      sg = reinterpret_cast<const uint4*>(r.buf + s * r.slot + g_off);
      sm90::mbar_wait(sm90::smem_u32(r.full + s), (i / stages) & 1);
    }
    uint4 xv[V], gv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int v = tid + k * blockDim.x;
      if (v < nv) {
        xv[k] = sx[v];
        gv[k] = sg[v];
        if constexpr (kDirect) wr.load(w, k, v);
      }
    }
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int v = tid + k * blockDim.x;
      if (v < nv) {
        float xf[N], gf[N], wf[N];
        unpack<T>(xv[k], xf);
        unpack<T>(gv[k], gf);
        if constexpr (kDirect) {
          wr.get(w, k, wf);
        } else {
          weight_vec(r.w_s, v, wf);
        }
#pragma unroll
        for (int j = 0; j < N; ++j) dot += (gf[j] * wf[j]) * (xf[j] * rs);
      }
    }
    const float mean = block_sum(dot, red[i & 1]) / static_cast<float>(cols);
    // every thread holds its vectors: the buffer takes the row `stages` on
    if constexpr (!kDirect) {
      if (tid == 0 && i + stages < n_rows) fetch(i + stages);
    }
    uint4* dxr = reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * cols);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int v = tid + k * blockDim.x;
      if (v < nv) {
        float xf[N], gf[N], wf[N], o[N];
        unpack<T>(xv[k], xf);
        unpack<T>(gv[k], gf);
        if constexpr (kDirect) {
          wr.get(w, k, wf);
        } else {
          weight_vec(r.w_s, v, wf);
        }
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float xh = xf[j] * rs;
          o[j] = rs * (gf[j] * wf[j] - xh * mean);
          acc[k][j] += gf[j] * xh;
        }
        dxr[v] = pack<T>(o);
      }
    }
  }
  if (dw == nullptr) return;
  float* mine = part + static_cast<size_t>(blockIdx.x) * cols;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int v = tid + k * blockDim.x;
    if (v < nv) {
      float4* p = reinterpret_cast<float4*>(mine + v * N);
#pragma unroll
      for (int q = 0; q < N / 4; ++q)
        p[q] = make_float4(acc[k][4 * q], acc[k][4 * q + 1],
                           acc[k][4 * q + 2], acc[k][4 * q + 3]);
    }
  }
  reduce_dw(part, dw, ticket, cols);
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_bwd_stream(const T* __restrict__ x, const TW* __restrict__ w,
                        const float* __restrict__ rstd,
                        const T* __restrict__ g, T* __restrict__ dx,
                        TW* __restrict__ dw, float* __restrict__ part,
                        unsigned* ticket, int rows, int cols) {
  constexpr int N = 16 / sizeof(T);
  __shared__ float red[2][32];
  float* mine = dw == nullptr
                    ? nullptr
                    : part + static_cast<size_t>(blockIdx.x) * cols;
  if (mine != nullptr)
    for (int c = threadIdx.x; c < cols; c += blockDim.x) mine[c] = 0.f;
  // (the first row's block sum orders these before any update)
  int par = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, par ^= 1) {
    const size_t at = static_cast<size_t>(row) * cols;
    const T* xr = x + at;
    const T* gr = g + at;
    T* dxr = dx + at;
    const int q = static_cast<int>(reinterpret_cast<uintptr_t>(xr) & 15) /
                  static_cast<int>(sizeof(T));
    const int nv = (q + cols + N - 1) / N;
    const float rs = rstd[row];
    float dot = 0.f;
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      const int e0 = v * N - q;
      float xf[N], gf[N], wf[N];
      load_elems<T, N>(xr, e0, cols, xf);
      load_elems<T, N>(gr, e0, cols, gf);
      load_weight<TW, N>(w, e0, cols, wf);
#pragma unroll
      for (int j = 0; j < N; ++j) dot += (gf[j] * wf[j]) * (xf[j] * rs);
    }
    const float mean = block_sum(dot, red[par]) / static_cast<float>(cols);
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      const int e0 = v * N - q;
      float xf[N], gf[N], wf[N], o[N], a[N];
      load_elems<T, N>(xr, e0, cols, xf);
      load_elems<T, N>(gr, e0, cols, gf);
      load_weight<TW, N>(w, e0, cols, wf);
      if (mine != nullptr) load_elems<float, N>(mine, e0, cols, a);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xh = xf[j] * rs;
        o[j] = rs * (gf[j] * wf[j] - xh * mean);
        if (mine != nullptr) a[j] += gf[j] * xh;
      }
      store_elems<T, N>(dxr, e0, cols, o);
      if (mine != nullptr) store_elems<float, N>(mine, e0, cols, a);
    }
  }
  if (mine != nullptr) reduce_dw(part, dw, ticket, cols);
}

// Op<T, TW>::run(a...) for x's dtype code and whether the weight is float32
template <template <typename, typename> class Op, typename... A>
cudaError_t dispatch(int dtype, int w_f32, A... a) {
  switch (dtype) {
    case kF32:
      return Op<float, float>::run(a...);
    case kBF16:
      return w_f32 ? Op<__nv_bfloat16, float>::run(a...)
                   : Op<__nv_bfloat16, __nv_bfloat16>::run(a...);
    case kF16:
      return w_f32 ? Op<__half, float>::run(a...)
                   : Op<__half, __half>::run(a...);
    default:
      return cudaErrorInvalidValue;
  }
}

enum { kStream = 0, kRing = 1, kDirectRows = 2 };  // a launch's instance

// the vectors a thread of the ring and direct instances takes at `cols`
template <typename T>
int vpt_for(int cols) {
  return cols / (16 / static_cast<int>(sizeof(T))) <=
                 kMaxThreads * kVptNarrow
             ? kVptNarrow
             : kVpt;
}

template <typename T, typename TW, int V>
const void* ring_kernel(int bwd, int direct) {
  if (bwd) {
    return direct ? reinterpret_cast<const void*>(
                        rms_norm_bwd_ring<T, TW, true, V>)
                  : reinterpret_cast<const void*>(
                        rms_norm_bwd_ring<T, TW, false, V>);
  }
  return direct ? reinterpret_cast<const void*>(
                      rms_norm_fwd_ring<T, TW, true, V>)
                : reinterpret_cast<const void*>(
                      rms_norm_fwd_ring<T, TW, false, V>);
}

template <typename T, typename TW>
const void* kernel_of(int bwd, int mode, int cols) {
  if (mode == kStream) {
    return bwd ? reinterpret_cast<const void*>(rms_norm_bwd_stream<T, TW>)
               : reinterpret_cast<const void*>(rms_norm_fwd_stream<T, TW>);
  }
  const int direct = mode == kDirectRows;
  return vpt_for<T>(cols) == kVptNarrow
             ? ring_kernel<T, TW, kVptNarrow>(bwd, direct)
             : ring_kernel<T, TW, kVpt>(bwd, direct);
}

// the ring instances may take the opt-in shared memory (set once)
template <typename T, typename TW>
cudaError_t allow_smem() {
  static const cudaError_t status = [] {
    for (int bwd = 0; bwd < 2; ++bwd) {
      for (const void* fn : {ring_kernel<T, TW, kVptNarrow>(bwd, 0),
                             ring_kernel<T, TW, kVpt>(bwd, 0)}) {
        const cudaError_t e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
        if (e != cudaSuccess) return e;
      }
    }
    return cudaSuccess;
  }();
  return status;
}

// the shared memory a ring instance needs at `stages` buffers
template <typename T>
int ring_smem(int bwd, int cols, int stages) {
  const int slot = round_up(cols * static_cast<int>(sizeof(T)), 128) *
                   (bwd ? 2 : 1);
  return round_up(cols * 4, 128) + stages * slot + stages * 8;
}

// threads a block of an instance (0: the ring instance does not take this
// width); ring and direct: vpt_for vectors a thread, stream: about four
template <typename T>
int threads_for(int mode, int cols) {
  constexpr int N = 16 / sizeof(T);
  if (mode != kStream) {
    const int v = vpt_for<T>(cols);
    if (cols % N || cols / N > kMaxThreads * v) return 0;
    return std::max(32, round_up((cols / N + v - 1) / v, 32));
  }
  const int nv = (cols + N - 1) / N + 1;  // + 1: a row's misaligned edges
  return std::min(kMaxThreads, std::max(32, round_up((nv + 3) / 4, 32)));
}

template <typename T, typename TW>
cudaError_t plan(int bwd, int mode, int cols, int* out) {
  const void* fn = kernel_of<T, TW>(bwd, mode, cols);
  const int threads = threads_for<T>(mode, cols);
  out[0] = out[1] = out[2] = out[3] = 0;
  if (threads == 0) return cudaSuccess;
  if (mode != kRing) {
    int per_sm = 0;
    const cudaError_t o =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, 0);
    if (o != cudaSuccess) return o;
    out[0] = threads;
    out[3] = per_sm;
    return cudaSuccess;
  }
  const cudaError_t e = allow_smem<T, TW>();
  if (e != cudaSuccess) return e;
  // the forward: the most bytes in flight an SM, then the most blocks; the
  // backward: two buffers and at most two blocks an SM (each block's dw
  // partial row costs the in-launch reduction; measured fastest on the
  // H100 at LLaMA's widths, PERF.md)
  const int slot = ring_smem<T>(bwd, cols, 1) - ring_smem<T>(bwd, cols, 0);
  long best = 0;
  for (int stages = bwd ? 2 : kMaxStages; stages >= 2; --stages) {
    const int smem = ring_smem<T>(bwd, cols, stages);
    if (smem > kSmemMax) continue;
    int per_sm = 0;
    const cudaError_t o = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, threads, smem);
    if (o != cudaSuccess) return o;
    if (bwd) per_sm = std::min(per_sm, 2);
    const long score = static_cast<long>(per_sm) * (stages - 1) * slot;
    if (per_sm > 0 && (score > best || (score == best && per_sm > out[3]))) {
      best = score;
      out[0] = threads;
      out[1] = stages;
      out[2] = smem;
      out[3] = per_sm;
    }
  }
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the launch's shape agrees with the instance's plan, and the ring's and
// the direct instance's arrays have every row 16-byte aligned (direct: the
// weight too, or none)
template <typename T>
bool launch_ok(int bwd, int mode, int rows, int cols, int grid, int threads,
               int stages, int smem, const void* a, const void* b,
               const void* c, const void* w) {
  if (mode < kStream || mode > kDirectRows || rows < 1 || cols < 1 ||
      grid < 1 || grid > rows || threads != threads_for<T>(mode, cols))
    return false;
  if (mode == kStream) return true;
  if (!aligned16(a) || !aligned16(b) || !aligned16(c) ||
      cols * sizeof(T) % 16 != 0)
    return false;
  if (mode == kDirectRows) return stages == 0 && smem == 0 && aligned16(w);
  return stages >= 2 && stages <= kMaxStages &&
         smem == ring_smem<T>(bwd, cols, stages);
}

template <typename T, typename TW, int V>
void fwd_ring(bool direct, int grid, int threads, int smem, cudaStream_t st,
              const T* x, const TW* w, T* y, float* rstd, int rows, int cols,
              float eps, int stages) {
  if (direct) {
    rms_norm_fwd_ring<T, TW, true, V><<<grid, threads, 0, st>>>(
        x, w, y, rstd, rows, cols, eps, 1);
  } else {
    rms_norm_fwd_ring<T, TW, false, V><<<grid, threads, smem, st>>>(
        x, w, y, rstd, rows, cols, eps, stages);
  }
}

template <typename T, typename TW, int V>
void bwd_ring(bool direct, int grid, int threads, int smem, cudaStream_t st,
              const T* x, const TW* w, const float* rstd, const T* g, T* dx,
              TW* dw, float* part, unsigned* ticket, int rows, int cols,
              int stages) {
  if (direct) {
    rms_norm_bwd_ring<T, TW, true, V><<<grid, threads, 0, st>>>(
        x, w, rstd, g, dx, dw, part, ticket, rows, cols, 1);
  } else {
    rms_norm_bwd_ring<T, TW, false, V><<<grid, threads, smem, st>>>(
        x, w, rstd, g, dx, dw, part, ticket, rows, cols, stages);
  }
}

template <typename T, typename TW>
struct PlanOp {
  static cudaError_t run(int bwd, int mode, int cols, int* out) {
    return plan<T, TW>(bwd, mode, cols, out);
  }
};

template <typename T, typename TW>
struct FwdOp {
  static cudaError_t run(const void* x, const void* w, void* y, void* rstd,
                         int rows, int cols, float eps, int mode, int grid,
                         int threads, int stages, int smem, cudaStream_t st) {
    if (!launch_ok<T>(0, mode, rows, cols, grid, threads, stages, smem, x,
                      y, y, w))
      return cudaErrorInvalidValue;
    const T* xp = static_cast<const T*>(x);
    const TW* wp = static_cast<const TW*>(w);
    T* yp = static_cast<T*>(y);
    float* rp = static_cast<float*>(rstd);
    if (mode != kStream) {
      const cudaError_t e = allow_smem<T, TW>();
      if (e != cudaSuccess) return e;
      const bool direct = mode == kDirectRows;
      if (vpt_for<T>(cols) == kVptNarrow) {
        fwd_ring<T, TW, kVptNarrow>(direct, grid, threads, smem, st, xp, wp,
                                    yp, rp, rows, cols, eps, stages);
      } else {
        fwd_ring<T, TW, kVpt>(direct, grid, threads, smem, st, xp, wp, yp,
                              rp, rows, cols, eps, stages);
      }
    } else {
      rms_norm_fwd_stream<T, TW><<<grid, threads, 0, st>>>(xp, wp, yp, rp,
                                                           rows, cols, eps);
    }
    return cudaGetLastError();
  }
};

template <typename T, typename TW>
struct BwdOp {
  static cudaError_t run(const void* x, const void* w, const void* rstd,
                         const void* g, void* dx, void* dw, void* part,
                         void* ticket, int rows, int cols, int mode, int grid,
                         int threads, int stages, int smem, cudaStream_t st) {
    if (!launch_ok<T>(1, mode, rows, cols, grid, threads, stages, smem, x,
                      g, dx, w) ||
        ((w == nullptr) != (dw == nullptr)) ||
        (dw != nullptr && (part == nullptr || ticket == nullptr)))
      return cudaErrorInvalidValue;
    const T* xp = static_cast<const T*>(x);
    const TW* wp = static_cast<const TW*>(w);
    const float* rp = static_cast<const float*>(rstd);
    const T* gp = static_cast<const T*>(g);
    T* dxp = static_cast<T*>(dx);
    TW* dwp = static_cast<TW*>(dw);
    float* pp = static_cast<float*>(part);
    unsigned* tp = static_cast<unsigned*>(ticket);
    if (mode != kStream) {
      const cudaError_t e = allow_smem<T, TW>();
      if (e != cudaSuccess) return e;
      const bool direct = mode == kDirectRows;
      if (vpt_for<T>(cols) == kVptNarrow) {
        bwd_ring<T, TW, kVptNarrow>(direct, grid, threads, smem, st, xp, wp,
                                    rp, gp, dxp, dwp, pp, tp, rows, cols,
                                    stages);
      } else {
        bwd_ring<T, TW, kVpt>(direct, grid, threads, smem, st, xp, wp, rp, gp,
                              dxp, dwp, pp, tp, rows, cols, stages);
      }
    } else {
      rms_norm_bwd_stream<T, TW><<<grid, threads, 0, st>>>(
          xp, wp, rp, gp, dxp, dwp, pp, tp, rows, cols);
    }
    return cudaGetLastError();
  }
};

}  // namespace

// The plan of one instance on the current device: out = {threads a block,
// ring buffers, dynamic shared memory bytes, blocks an SM holds}. bwd: the
// backward, else the forward; mode: 0 stream (any arrays), 1 ring, 2 direct
// (the ring's and the direct instance's arrays have every row 16-byte
// aligned; direct takes one row a block); dtype: x's (0 float32, 1
// bfloat16, 2 float16); w_f32: the weight is float32 (else x's dtype or
// none). threads 0: the instance does not take `cols`. Returns a CUDA
// error code (0 on success).
extern "C" int rms_norm_plan(int bwd, int mode, int cols, int dtype,
                             int w_f32, int* out) {
  if (cols < 1 || out == nullptr || mode < kStream || mode > kDirectRows)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      dispatch<PlanOp>(dtype, w_f32, bwd, mode, cols, out));
}

// y[rows, cols] = rms_norm(x[rows, cols]) * w[cols] (w null: no scale); rstd:
// null, or [rows] float32 to receive rsqrt(mean(x^2) + eps). x and y
// contiguous of x's dtype, w of x's dtype or float32 (w_f32). mode, grid (1
// .. rows), threads, stages, smem: from rms_norm_plan (direct: stages and
// smem 0). One launch on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y, void* rstd,
                            int rows, int cols, float eps, int dtype,
                            int w_f32, int mode, int grid, int threads,
                            int stages, int smem, void* stream) {
  return static_cast<int>(dispatch<FwdOp>(
      dtype, w_f32, x, w, y, rstd, rows, cols, eps, mode, grid, threads,
      stages, smem, static_cast<cudaStream_t>(stream)));
}

// dx[rows, cols] and dw[cols] of y = rms_norm(x) * w given g = dL/dy and the
// forward's rstd [rows] float32. x, g, dx contiguous of x's dtype; w and dw
// of x's dtype or float32 (w_f32), or both null (no weight: no dw). With a
// weight: part, float32 scratch [grid, cols], and ticket, one unsigned that
// is 0 (the launch leaves it 0). mode, grid (1 .. rows, at most the blocks the card holds at
// once), threads, stages, smem: from rms_norm_plan (direct: stages and smem
// 0). One launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int rms_norm_bwd(const void* x, const void* w, const void* rstd,
                            const void* g, void* dx, void* dw, void* part,
                            void* ticket, int rows, int cols, int dtype,
                            int w_f32, int mode, int grid, int threads,
                            int stages, int smem, void* stream) {
  return static_cast<int>(dispatch<BwdOp>(
      dtype, w_f32, x, w, rstd, g, dx, dw, part, ticket, rows, cols, mode,
      grid, threads, stages, smem, static_cast<cudaStream_t>(stream)));
}
