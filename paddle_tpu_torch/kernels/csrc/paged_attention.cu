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
//
// The grouped-fetch kernel (paged_decode_grouped_kernel, below) replaces
// paddle_tpu/kernels/paged_attention.py::paged_attention_grouped (the Pallas
// body `_decode_grouped_kernel`): the same function over float 16-token
// pages at head_dim 128, with the row's pages staged in shared memory a
// group at a time. See its own note.

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

// ---------------------------------------------------------------------------
// Grouped-fetch decode
//
// The TPU kernel fetches 8 pages (128 tokens) per grid step by
// double-buffered async copies, because one 16-token page per step starves
// its matrix unit. Here the same idea hides memory latency: the per-page
// kernel above reads one dependent slice at a time, while this kernel keeps
// whole groups of pages in flight. One block of 4 warps per (batch row, kv
// head) walks the row's context in stages of 64 KB of K and V: 8 pages (128
// tokens) of bf16, or 4 pages (64 tokens, half a group) of f32, since a
// whole f32 group is 128 KB and two of them do not fit. Two stages live in
// shared memory; each is filled by cp.async from the block table while the
// block computes on the other (the TPU kernel's two-slot pipeline, group
// g + 2 issued into the slot group g has left). A page whose first token is
// at or past the row's context is never fetched (its rows are zero-filled),
// stale table entries past the context are never read, and the walk stops
// at the last stage holding a token below the context. Per stage:
//   scores: thread t takes token t, reads its K row from shared memory with
//     16-byte loads against the group's queries (f32, in shared memory),
//     scales and masks at the context with the TPU kernel's -1e30;
//   softmax: one warp per query row folds the stage into the row's running
//     (m, l), as `_decode_accumulate` does, and leaves the weights in
//     shared memory;
//   P.V: thread d owns output column d of every query of the group and
//     accumulates in f32, rescaled by the stage's alpha.
// All arithmetic is f32 on the CUDA cores: a decode step moves 2 bytes of
// K/V for every 1-16 multiply-adds, far below the rate at which they run.
// The query group is a compile-time bucket (1, 2, 4, 8, 16), the TPU
// kernel's pad of the group to 8 rows. Tensor-core products on the
// [16 x 128] score tile, TMA and split-KV are left for later work.

constexpr int kGThreads = 128;  // one per output column
constexpr int kGWarps = kGThreads / 32;
constexpr int kGPage = 16;      // page size
constexpr int kGD = 128;        // head_dim
constexpr int kGroupPages = 8;  // pages per group

template <typename T>
struct GStage {
  static constexpr int kTok = 64 * 1024 / (2 * kGD * sizeof(T));
  static constexpr int kLD = kGD + 16 / sizeof(T);  // row stride, padded
  static constexpr int kTileBytes = kTok * kLD * sizeof(T);
  static constexpr int kStageBytes = 2 * kTileBytes;  // K and V
};

template <typename T, int G>
constexpr size_t grouped_smem_bytes() {
  return 2 * GStage<T>::kStageBytes +
         sizeof(float) * (G * kGD + G * GStage<T>::kTok + 3 * G);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int G>
__global__ void __launch_bounds__(kGThreads)
    paged_decode_grouped_kernel(Args a) {
  using St = GStage<T>;
  constexpr int kTok = St::kTok;
  constexpr int kLD = St::kLD;
  constexpr int kVec = 16 / sizeof(T);            // elements per 16 bytes
  constexpr int kRowChunks = kGD / kVec;          // 16-byte chunks per row
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int group = a.group;
  const int q_heads = gridDim.x * group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* __restrict__ k_pages = static_cast<const T*>(a.k_pages);
  const T* __restrict__ v_pages = static_cast<const T*>(a.v_pages);

  extern __shared__ __align__(16) unsigned char gsmem[];
  float* sq = reinterpret_cast<float*>(gsmem + 2 * St::kStageBytes);
  float* sp = sq + G * kGD;    // [G][kTok] scores, then weights
  float* sm = sp + G * kTok;   // [G] running max
  float* sl = sm + G;          // [G] running sum
  float* salpha = sl + G;      // [G] this stage's rescale
  auto tile_k = [&](int s) {
    return reinterpret_cast<T*>(gsmem + s * St::kStageBytes);
  };
  auto tile_v = [&](int s) {
    return reinterpret_cast<T*>(gsmem + s * St::kStageBytes +
                                St::kTileBytes);
  };

  const T* qb = static_cast<const T*>(a.q) +
                (static_cast<size_t>(b) * q_heads +
                 static_cast<size_t>(h) * group) * kGD;
  for (int i = tid; i < G * kGD; i += kGThreads) {
    sq[i] = i < group * kGD ? to_f32(qb[i]) : 0.f;
  }
  if (tid < G) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
    salpha[tid] = 1.f;
  }

  int ctx = a.pages_per_seq * kGPage;  // never read past the table
  if (a.context_lens[b] < ctx) ctx = a.context_lens[b];
  const int n_stages = (ctx + kTok - 1) / kTok;
  const int* table =
      a.block_tables + static_cast<size_t>(b) * a.pages_per_seq;
  const long long head_base = static_cast<long long>(h) * a.n_pages;

  // stage i -> slot s; a page whose first token is at or past ctx is not
  // read, its rows zero-filled
  auto issue = [&](int i, int s) {
    T* kd = tile_k(s);
    T* vd = tile_v(s);
    for (int c = tid; c < kTok * kRowChunks; c += kGThreads) {
      const int t = c / kRowChunks;
      const int e = (c % kRowChunks) * kVec;
      const int pos = i * kTok + t;
      const int p = pos / kGPage;
      const bool live = p * kGPage < ctx;
      size_t off = 0;
      if (live) {
        off = (static_cast<size_t>(head_base + __ldg(table + p)) * kGPage +
               pos % kGPage) * kGD + e;
      }
      cp_async16(kd + t * kLD + e, k_pages + off, live ? 16 : 0);
      cp_async16(vd + t * kLD + e, v_pages + off, live ? 16 : 0);
    }
  };

  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  if (n_stages > 0) issue(0, 0);
  cp_async_commit();
  if (n_stages > 1) issue(1, 1);
  cp_async_commit();
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<1>();
    __syncthreads();  // stage i landed; the queries and state are set
    const int s = i & 1;
    const T* kt = tile_k(s);
    const T* vt = tile_v(s);
    const int base = i * kTok;

    // scores of token t against every query
    for (int t = tid; t < kTok; t += kGThreads) {
      float sc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) sc[g] = 0.f;
      const T* kr = kt + t * kLD;
#pragma unroll 4
      for (int c = 0; c < kGD; c += kVec) {
        const Chunk<T, kVec> kc = *reinterpret_cast<const Chunk<T, kVec>*>(
            kr + c);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float kf = to_f32(kc.v[j]);
#pragma unroll
          for (int g = 0; g < G; ++g) sc[g] += sq[g * kGD + c + j] * kf;
        }
      }
      const bool valid = base + t < ctx;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        sp[g * kTok + t] = valid ? sc[g] * a.scale : kNegInf;
      }
    }
    __syncthreads();

    // fold the stage into each query row's online softmax
    for (int g = warp; g < group; g += kGWarps) {
      float* row = sp + g * kTok;
      float mx = kNegInf;
      for (int t = lane; t < kTok; t += 32) mx = fmaxf(mx, row[t]);
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < kTok; t += 32) {
        const float p = base + t < ctx ? expf(row[t] - m_new) : 0.f;
        row[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        salpha[g] = alpha;
        sl[g] = sl[g] * alpha + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V, thread tid on column tid
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= salpha[g];
    for (int t = 0; t < kTok; t += 4) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = to_f32(vt[(t + j) * kLD + tid]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < group) {
          const float4 p = *reinterpret_cast<const float4*>(sp + g * kTok + t);
          acc[g] += p.x * v[0] + p.y * v[1] + p.z * v[2] + p.w * v[3];
        }
      }
    }
    __syncthreads();  // every thread is done with slot s and the weights
    if (i + 2 < n_stages) issue(i + 2, s);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // a row with no stage: the state's initial values

  T* ob = static_cast<T*>(a.out) + (static_cast<size_t>(b) * q_heads +
                                    static_cast<size_t>(h) * group) * kGD;
  for (int g = 0; g < group; ++g) {
    const float l = sl[g];
    ob[g * kGD + tid] = from_f32<T>(l == 0.f ? 0.f : acc[g] / l);
  }
}

template <typename T, int G>
cudaError_t launch_grouped(const Args& a, int batch, int kv_heads,
                           cudaStream_t stream) {
  constexpr size_t smem = grouped_smem_bytes<T, G>();
  static const cudaError_t status = cudaFuncSetAttribute(
      paged_decode_grouped_kernel<T, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (status != cudaSuccess) return status;
  paged_decode_grouped_kernel<T, G>
      <<<dim3(kv_heads, batch), kGThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_grouped_group(const Args& a, int batch, int kv_heads,
                                 cudaStream_t s) {
  if (a.group <= 1) return launch_grouped<T, 1>(a, batch, kv_heads, s);
  if (a.group <= 2) return launch_grouped<T, 2>(a, batch, kv_heads, s);
  if (a.group <= 4) return launch_grouped<T, 4>(a, batch, kv_heads, s);
  if (a.group <= 8) return launch_grouped<T, 8>(a, batch, kv_heads, s);
  return launch_grouped<T, 16>(a, batch, kv_heads, s);
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

// The grouped-fetch decode (layouts as paged_attention_decode) over float
// pages of q's dtype: page_size 16, head_dim 128, pages_per_seq a multiple
// of 8, 1 <= group <= 16. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int paged_attention_decode_grouped(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* context_lens, void* out, int batch,
    int kv_heads, int group, int n_pages, int page_size, int pages_per_seq,
    int head_dim, float scale, int is_bf16, void* stream) {
  if (group < 1 || group > 16 || page_size != kGPage || head_dim != kGD ||
      pages_per_seq < 1 || pages_per_seq % kGroupPages || kv_heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0) return 0;
  const Args a{q, k_pages, v_pages, nullptr, nullptr,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(context_lens), out, n_pages, page_size,
               pages_per_seq, group, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_grouped_group<__nv_bfloat16>(a, batch, kv_heads, s)
              : launch_grouped_group<float>(a, batch, kv_heads, s);
  return static_cast<int>(err);
}
