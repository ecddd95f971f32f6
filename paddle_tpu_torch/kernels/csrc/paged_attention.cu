// Paged decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/paged_attention.py::paged_attention (the
// Pallas body `_decode_kernel`, float pages and its `quant=True` int8
// pages). One new token per sequence attends the K/V already in its pages:
//   q            [batch, q_heads, D]            (q_heads = kv_heads * group)
//   k/v pages    [kv_heads, n_pages, page_size, D], q's dtype or int8
//   k/v scales   [kv_heads, n_pages, page_size] f32 (int8 pages only)
//   block_tables [batch, pages_per_seq] int32   (page ids of each sequence)
//   context_lens [batch] int32                  (tokens valid in the cache)
//   out          [batch, q_heads, D] in q's dtype, softmax and sums in f32.
// A row with context 0 writes zeros, as `_decode_epilogue` does. int8 pages
// are dequantized as `_decode_accumulate` does: each token's K scale
// multiplies its score after q . k_int8, its V scale multiplies its softmax
// weight before p . v_int8, and the normaliser sums the unscaled weights.
//
// Bound on the H100: bytes. Each (row, kv head) reads ctx * D K values and
// ctx * D V values once; at 8 rows, 32 kv heads, D=128 and a 4096-token
// context that is 537 MB of bf16 per layer, about 160 us at 3.35 TB/s; int8
// pages halve that (plus 8 bytes of scales per token and kv head).
// The arithmetic (4 * ctx * q_heads * D flops) is far below the card's rate.
//
// Design: one block of 8 warps per (batch row, kv head). The block holds
// that kv head's `group` queries, so K/V are read once for all of them
// (GQA). It walks only the positions below the context, so stale table
// entries past it are never read (the TPU kernel visits every page of the
// table). The warps split the context into 32-token slices and each warp
// keeps its own online softmax (m, l, acc) over its slices, so no block
// barrier sits inside the loop:
//   scores: lane j takes token j of the slice and reads its whole K row
//     with 16-byte loads, all issued before use, against the queries in
//     shared memory;
//   P.V:    the lanes split D; token by token the warp reads one V row
//     (coalesced), the probability broadcast by a shuffle.
// Keeping many independent loads in flight is what a decode kernel bound by
// memory latency needs. At the end the 8 warps' states are merged through
// shared memory. The group is a compile-time bucket (1, 2, 4, 8, 16) so the
// per-query state stays in registers. The page type is a template
// parameter: int8 pages are read 16 values to a 16-byte load and converted
// in registers, so one kernel body serves both formats. Split-KV across
// blocks, TMA staging and tensor-core products are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlice = 32;         // tokens per warp step, one per lane
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// N consecutive elements, loaded as one vector
template <typename T, int N>
struct alignas(sizeof(T) * N) Chunk {
  T v[N];
};

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;  // int8 pages only
  const float* v_scales;
  const int* block_tables;
  const int* context_lens;
  void* out;
  int n_pages, page_size, pages_per_seq, group;
  float scale;
};

template <int D, int G>
constexpr size_t smem_bytes() {
  return sizeof(float) * (G * D + kWarps * G * D + kWarps * G * 2);
}

// T: q and out; P: the pages (T, or int8_t with per-token scales)
template <typename T, typename P, int D, int G>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Args a) {
  constexpr bool kQuant = sizeof(P) == 1;
  constexpr int kVec = 16 / sizeof(P);  // page elements per 16-byte load
  constexpr int kChunks = D / kVec;
  constexpr int kPerLane = D / 32;      // output columns per lane
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int group = a.group;
  const int q_heads = gridDim.x * group;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const P* __restrict__ k_pages = static_cast<const P*>(a.k_pages);
  const P* __restrict__ v_pages = static_cast<const P*>(a.v_pages);

  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                    // [G][D] queries, f32
  float* sacc = sq + G * D;            // [kWarps][G][D] per-warp P.V
  float* sml = sacc + kWarps * G * D;  // [kWarps][G][2] per-warp (m, l)

  const T* qb = static_cast<const T*>(a.q) +
                (static_cast<size_t>(b) * q_heads +
                 static_cast<size_t>(h) * group) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    sq[i] = i < group * D ? to_f32(qb[i]) : 0.f;
  }
  __syncthreads();

  int limit = a.pages_per_seq * a.page_size;  // never read past the table
  if (a.context_lens[b] < limit) limit = a.context_lens[b];
  const int* table =
      a.block_tables + static_cast<size_t>(b) * a.pages_per_seq;
  const long long head_base = static_cast<long long>(h) * a.n_pages;

  float m[G], l[G], acc[G][kPerLane];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[g][i] = 0.f;
  }

  for (int s0 = warp * kSlice; s0 < limit; s0 += kWarps * kSlice) {
    const int n = min(kSlice, limit - s0);  // warp-uniform
    const bool valid = lane < n;
    long long off = 0;  // element offset of this lane's token in the pools
    float ksc = 0.f, vsc = 0.f;  // its scales (int8 pages)
    if (valid) {
      const int t = s0 + lane;
      const long long tok =
          (head_base + table[t / a.page_size]) * a.page_size +
          t % a.page_size;
      off = tok * D;
      if (kQuant) {
        ksc = a.k_scales[tok];
        vsc = a.v_scales[tok];
      }
    }

    // scores of this lane's token against every query
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.f;
    if (valid) {
      const Chunk<P, kVec>* kr =
          reinterpret_cast<const Chunk<P, kVec>*>(k_pages + off);
      Chunk<P, kVec> kc[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) kc[c] = kr[c];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float kf = to_f32(kc[c].v[i]);
#pragma unroll
          for (int g = 0; g < G; ++g) sc[g] += sq[g * D + c * kVec + i] * kf;
        }
      }
    }

    // fold the slice into this warp's online softmax
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float s =
          valid ? (kQuant ? sc[g] * a.scale * ksc : sc[g] * a.scale)
                : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(s));
      const float alpha = expf(m[g] - m_new);
      p[g] = valid ? expf(s - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) acc[g][i] *= alpha;
    }

    // acc += P.V, lanes split D
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const long long oj = __shfl_sync(kFull, off, j);
      const float vj = kQuant ? __shfl_sync(kFull, vsc, j) : 1.f;
      const Chunk<P, kPerLane> vc = *reinterpret_cast<const Chunk<P, kPerLane>*>(
          v_pages + oj + lane * kPerLane);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj =
            kQuant ? __shfl_sync(kFull, p[g], j) * vj : __shfl_sync(kFull, p[g], j);
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) acc[g][i] += pj * to_f32(vc.v[i]);
      }
    }
  }

  // merge the warps' states
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      sacc[(warp * G + g) * D + lane * kPerLane + i] = acc[g][i];
    }
    if (lane == 0) {
      sml[(warp * G + g) * 2] = m[g];
      sml[(warp * G + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();
  T* ob = static_cast<T*>(a.out) + (static_cast<size_t>(b) * q_heads +
                                    static_cast<size_t>(h) * group) * D;
  for (int idx = threadIdx.x; idx < group * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sml[(w * G + g) * 2]);
    float sum = 0.f, val = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sml[(w * G + g) * 2] - mx);
      sum += sml[(w * G + g) * 2 + 1] * e;
      val += sacc[(w * G + g) * D + d] * e;
    }
    ob[idx] = from_f32<T>(sum == 0.f ? 0.f : val / sum);
  }
}

template <typename T, typename P, int D, int G>
cudaError_t launch(const Args& a, int batch, int kv_heads,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, G>();
  auto kernel = paged_decode_kernel<T, P, D, G>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(kv_heads, batch), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename P, int D>
cudaError_t launch_group(const Args& a, int batch, int kv_heads,
                         cudaStream_t s) {
  if (a.group <= 1) return launch<T, P, D, 1>(a, batch, kv_heads, s);
  if (a.group <= 2) return launch<T, P, D, 2>(a, batch, kv_heads, s);
  if (a.group <= 4) return launch<T, P, D, 4>(a, batch, kv_heads, s);
  if (a.group <= 8) return launch<T, P, D, 8>(a, batch, kv_heads, s);
  return launch<T, P, D, 16>(a, batch, kv_heads, s);
}

template <typename T, typename P>
cudaError_t launch_dim(const Args& a, int batch, int kv_heads, int head_dim,
                       cudaStream_t s) {
  switch (head_dim) {
    case 32:
      return launch_group<T, P, 32>(a, batch, kv_heads, s);
    case 64:
      return launch_group<T, P, 64>(a, batch, kv_heads, s);
    case 128:
      return launch_group<T, P, 128>(a, batch, kv_heads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// q/out of T (is_bf16: bfloat16, else float32), pages of P
template <bool kQuant>
int decode(const Args& a, int batch, int kv_heads, int head_dim, int is_bf16,
           void* stream) {
  if (a.group < 1 || a.group > 16 || a.page_size < 1 || kv_heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kQuant) {
    err = is_bf16
              ? launch_dim<__nv_bfloat16, int8_t>(a, batch, kv_heads,
                                                  head_dim, s)
              : launch_dim<float, int8_t>(a, batch, kv_heads, head_dim, s);
  } else {
    err = is_bf16 ? launch_dim<__nv_bfloat16, __nv_bfloat16>(
                        a, batch, kv_heads, head_dim, s)
                  : launch_dim<float, float>(a, batch, kv_heads, head_dim, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// Decode attention over paged K/V (layouts above); all tensors contiguous,
// q/pages/out of one dtype (is_bf16: bfloat16, else float32), head_dim 32,
// 64 or 128, 1 <= group <= 16, page_size >= 1. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int paged_attention_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* context_lens, void* out, int batch,
    int kv_heads, int group, int n_pages, int page_size, int pages_per_seq,
    int head_dim, float scale, int is_bf16, void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(context_lens), out, n_pages, page_size,
               pages_per_seq, group, scale};
  return decode<false>(a, batch, kv_heads, head_dim, is_bf16, stream);
}

// The same over int8 pages with their f32 scales [kv_heads, n_pages,
// page_size]; q and out float32 or bfloat16 (is_bf16).
extern "C" int paged_attention_decode_q8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* context_lens, void* out, int batch, int kv_heads, int group,
    int n_pages, int page_size, int pages_per_seq, int head_dim, float scale,
    int is_bf16, void* stream) {
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(context_lens), out, n_pages, page_size,
               pages_per_seq, group, scale};
  return decode<true>(a, batch, kv_heads, head_dim, is_bf16, stream);
}
