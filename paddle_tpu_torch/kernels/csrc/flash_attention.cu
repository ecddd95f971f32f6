// Flash attention for NVIDIA Hopper (sm_90a): the forward and the backward.
//
// Replaces the four kernel bodies of each of the three Pallas sites of
// paddle_tpu/kernels/flash_attention.py:
//   flash_fwd_kernel <- _fwd_kernel{,_seg,_drop,_seg_drop} via _flash_fwd
//                       (out, f32 row lse)
//   flash_bwd_kernel <- _bwd_dkv_kernel{,...} via _run_dkv_pass (dK, dV)
//                       and _bwd_dq_kernel{,...} via _run_dq_pass (dQ), in
//                       one kernel for bf16 inputs; float inputs keep two
//                       WMMA kernels, flash_dkv_kernel and flash_dq_kernel
// over q [bh, s_q, d], k/v [bh, s_kv, d] with d = 128. Each kernel is a
// template on <SEG, DROP>; this file built as it is gives the plain
// bodies (no segments, no dropout), and flash_attention_{seg,drop,seg_drop}.cu
// define FLASH_SEG / FLASH_DROP and include it, so the four variants build
// as four libraries in parallel, each with the same two entry points.
// Causal masking is bottom-right aligned: query i sees key j when
// i + (s_kv - s_q) >= j; a masked score is the finite NEG_INF = -1e30 and
// its probability is zeroed by the mask itself, so a fully masked row gives
// out 0 and lse -1e30, and leaks nothing into the gradients. The backward
// recomputes p = exp(s - lse) from the forward's lse and takes
// delta = rowsum(dO * O) (f32, less the lse cotangent) from the caller.
//
// SEG (varlen): int32 segment ids [b, s_q] and [b, s_kv], row bh reading
// batch bh / heads; query i sees key j only when their ids are equal (and
// the causal mask allows it); the mask zeroes p, not only the score. A
// tile is skipped when the id range [min, max] of its queries and that
// of its keys are disjoint (int2 ranges per 64-row tile from the
// caller): exact for any ids, and it keeps a packed stream's work near its
// block diagonal.
// DROP: inverted dropout of the softmax weights with the reference's
// counter-based mask, threefry2x32 (20 rounds) keyed by (seed, bh) over the
// counters (global query, global key), low 23 bits times 2^-23 >= rate
// (`_threefry2x32`, `_dropout_keep`), so every kernel regenerates the same
// bits whatever its tiling. The forward's l sums the undropped p; P V, and
// dV, take the dropped p times 1 / (1 - rate); dS = p * (dP' - delta) *
// scale with dP' the masked, scaled dO V^T and p undropped.
//
// Bound on the H100: operations. At [1, 4096, 32, 128] bf16 causal the
// forward is 137 GFLOP of products against 134 MB moved, far above the
// card's 295 FLOP/byte ridge, so the tensor cores (989 TFLOP/s bf16) are the
// limit. The dropout mask adds ~65 integer operations per visible score on
// the CUDA cores (see `keep`), which at 64 INT32 lanes per SM outweigh the
// products: the backward regenerates it once per visible pair.
//
// Forward: every product is a warp-level tensor-core product through the
// WMMA API on tiles staged in shared memory: bf16 operands with f32
// accumulation; for float inputs three TF32 products per step on the split
// a = hi + lo (hi*hi + hi*lo + lo*hi), which keeps close to f32 accuracy.
// The scores go to shared memory as f32; the masks and the online softmax
// run on the CUDA cores in f32; P is rounded to the input type before its
// product (bf16: one rounding, 2^-9 relative, of each weight; the reference
// multiplies in f32). One block of 4 warps per (bh, 64-row q tile), each
// warp owning 16 query rows: its own softmax state, and its O accumulator
// in fragments, rescaled in place (a probe load tells which row each
// fragment element holds); K/V tiles in the future of the whole q tile are
// skipped, the next K/V tile in flight by cp.async (two buffers for bf16)
// while the block computes on the current one; each warp keeps its bf16 Q
// rows in registers.
//
// Backward, bf16 (flash_bwd_kernel): one block of 8 warps per (bh, 128-key
// tile) computes the tile's dK and dV and its share of dQ, 5 products per
// (q tile, key tile) pair where the two passes of the reference take 7, and
// one threefry call per visible pair. The products are mma.sync m16n8k16
// (bf16 in, f32 accumulate) fed by ldmatrix, with the transposed operands
// by ldmatrix.trans. Each warp owns 16 key rows and computes, 32 queries at
// a time, S^T = K Q^T and dP^T = V dO^T into accumulator registers; the
// masks, the keep bit, p = exp(s * scale - lse) and ds = p * (dp - delta) *
// scale are applied there, each element's (key, query) from the lane id.
// The m16n8 accumulator layout of two adjacent n-tiles is the A-operand
// layout of one k16 step, so P^T and dS^T, rounded to bf16, feed
// dV += P^T dO and dK += dS^T Q from registers: no score tile goes through
// shared memory. dS^T is stored once in bf16 (two buffers); one q tile
// later, past the next barrier, the 8 warps read it back by ldmatrix.trans
// as the A operand of that tile's dQ += dS K (each warp 16 queries x 64
// columns) and add their partials into a zeroed f32 [bh, s_q, d]
// workspace with float2 atomics (the wrapper casts it to bf16). The order of those additions varies between
// runs, so dQ is not bitwise repeatable: its f32 sums differ by rounding
// (~1e-7 relative), a bf16 element at most by one ulp. K and V stay in
// shared memory; the Q, dO, lse and delta tiles (and their segment ids)
// stream in by cp.async, two buffers, the next tile in flight; one
// barrier per q tile. The loop over a tile's two 32-query halves is
// unrolled so that their work overlaps: 248-252 registers, no spills
// (ptxas). The grid is (bh, key tile) so that the key tiles at
// the start, which under the causal mask see the most queries, launch
// first. Float inputs keep the WMMA bodies of the first design: a dK/dV
// kernel of 8 warps per (bh, 64-key tile) and a dQ kernel per (bh, 64-row
// q tile), scores and probabilities through shared memory.
// Products are not wgmma and tiles are not moved by TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

// the variant this library's entry points launch (see the header)
#ifndef FLASH_SEG
#define FLASH_SEG 0
#endif
#ifndef FLASH_DROP
#define FLASH_DROP 0
#endif

namespace {

using namespace nvcuda;

constexpr int kD = 128;       // head_dim
constexpr int kBQ = 64;       // query rows per tile
constexpr int kBK = 64;       // key rows per tile
constexpr int kLD = kD + 8;   // shared row stride of q/k/v/dO tiles
constexpr int kLS = kBK + 4;  // shared row stride of f32 score tiles
constexpr int kLP = kBK + 8;  // shared row stride of P / dS tiles (input type)
constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;
constexpr float kNegInf = -1e30f;

template <typename L>
struct IsRow {
  static constexpr bool value = false;
};
template <>
struct IsRow<wmma::row_major> {
  static constexpr bool value = true;
};

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static constexpr int K = 16;
  template <typename L>
  using A = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, L>;
  template <typename L>
  using B = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, L>;
  using C = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  template <typename FA, typename FB>
  static __device__ __forceinline__ void step(C& c, FA& a, FB& b) {
    wmma::mma_sync(c, a, b, c);
  }
};

template <>
struct Mma<float> {
  static constexpr int K = 8;
  template <typename L>
  using A =
      wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, L>;
  template <typename L>
  using B =
      wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, L>;
  using C = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  template <typename F>
  static __device__ __forceinline__ void split(F& hi, F& lo) {
#pragma unroll
    for (int i = 0; i < hi.num_elements; ++i) {
      const float x = hi.x[i];
      const float h = wmma::__float_to_tf32(x);
      hi.x[i] = h;
      lo.x[i] = wmma::__float_to_tf32(x - h);
    }
  }
  template <typename FA, typename FB>
  static __device__ __forceinline__ void step(C& c, FA& a, FB& b) {
    FA a_lo;
    FB b_lo;
    split(a, a_lo);
    split(b, b_lo);
    wmma::mma_sync(c, a_lo, b, c);
    wmma::mma_sync(c, a, b_lo, c);
    wmma::mma_sync(c, a, b, c);
  }
};

// c += A[16 x kdim] * B[kdim x 16], both in shared memory; LA / LB give
// their layouts (row_major: element (r, c) at p[r * ld + c]; col_major: at
// p[c * ld + r]).
template <typename T, typename LA, typename LB>
__device__ __forceinline__ void mma_tile(typename Mma<T>::C& c, const T* a,
                                         int lda, const T* b, int ldb,
                                         int kdim) {
  using M = Mma<T>;
  typename M::template A<LA> fa;
  typename M::template B<LB> fb;
#pragma unroll 4
  for (int k = 0; k < kdim; k += M::K) {
    wmma::load_matrix_sync(fa, IsRow<LA>::value ? a + k : a + k * lda, lda);
    wmma::load_matrix_sync(fb, IsRow<LB>::value ? b + k * ldb : b + k, ldb);
    M::step(c, fa, fb);
  }
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store4(float* d, float4 v) {
  *reinterpret_cast<float4*>(d) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* d, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(d) = u;
}

// cp.async: 16-byte copies global -> shared that bypass registers; a block
// issues a tile, commits the group, and waits for it before a barrier.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x kD elements, global (row stride kD) -> shared (row stride kLD)
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kChunks = kD / kPer;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    cp_async16(dst + r * kLD + c, src + static_cast<size_t>(r) * kD + c);
  }
}

// kBQ floats (lse or delta of one q tile) -> shared
__device__ __forceinline__ void load_row_stats(float* dst, const float* src) {
  if (threadIdx.x < kBQ / 4) cp_async16(dst + 4 * threadIdx.x,
                                        src + 4 * threadIdx.x);
}

// n (a multiple of 4; by default one 64-row tile's) int32 segment ids
// -> shared
__device__ __forceinline__ void load_ids(int* dst, const int* src,
                                         int n = kBQ) {
  for (int c = threadIdx.x; c < n / 4; c += blockDim.x)
    cp_async16(dst + 4 * c, src + 4 * c);
}

// What the seg and drop bodies read besides q, k, v (unused by the plain
// bodies): segment ids [b, s] and the (min, max) id of each 64-row tile
// [b, s / 64] for queries and keys, the number of heads (bh / heads is the
// batch row), the dropout seed, rate and 1 / (1 - rate).
struct Variant {
  const int* seg_q;
  const int* seg_k;
  const int2* rng_q;
  const int2* rng_k;
  int heads;
  uint32_t seed;
  float rate;
  float inv;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32, 20 rounds, the first output word (`_threefry2x32`:
// uint32 arithmetic, which the reference's wrapping int32 lanes equal bit
// for bit)
__device__ __forceinline__ uint32_t threefry2x32(uint32_t k0, uint32_t k1,
                                                 uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl32(x1, r); \
  x1 ^= x0;
#define TF_ROUNDS_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROUNDS_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_ROUNDS_A x0 += k1; x1 += k2 + 1u;
  TF_ROUNDS_B x0 += k2; x1 += k0 + 2u;
  TF_ROUNDS_A x0 += k0; x1 += k1 + 3u;
  TF_ROUNDS_B x0 += k1; x1 += k2 + 4u;
  TF_ROUNDS_A x0 += k2; x1 += k0 + 5u;
#undef TF_ROUNDS_B
#undef TF_ROUNDS_A
#undef TF_ROUND
  return x0;
}

// `_dropout_keep` for one (query, key) pair of row bh: the low 23 bits as a
// uniform in [0, 1) (exact in f32), kept when >= rate
__device__ __forceinline__ bool keep(const Variant& var, int bh, int qpos,
                                     int kpos) {
  const uint32_t bits = threefry2x32(var.seed, static_cast<uint32_t>(bh),
                                     static_cast<uint32_t>(qpos),
                                     static_cast<uint32_t>(kpos));
  return static_cast<float>(bits & 0x7FFFFFu) * 1.1920928955078125e-07f >=
         var.rate;
}

// The first tile t in [t, end) whose id range meets [lo, hi], or end: each
// warp takes 32 tiles a step and ballots, so every thread of the block that
// calls it with the same arguments gets the same answer.
__device__ __forceinline__ int next_tile(int t, int end, const int2* rng,
                                         int lo, int hi) {
  const int lane = threadIdx.x & 31;
  for (int base = t; base < end; base += 32) {
    bool meets = false;
    if (base + lane < end) {
      const int2 r = rng[base + lane];
      meets = r.x <= hi && r.y >= lo;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, meets);
    if (hit) return base + __ffs(hit) - 1;
  }
  return end;
}

// pipeline depth of the streamed tiles in the forward and dK/dV passes: two
// buffers for bf16; one for f32, whose tiles are twice as large and would
// not fit twice in shared memory. The dQ pass keeps one buffer: a second
// (149 KB in all) leaves room for one block per SM instead of two, and
// measured slower on the H100.
template <typename T>
constexpr int kStages = sizeof(T) == 2 ? 2 : 1;
constexpr int kDqStages = 1;

// rows x kD floats, shared staging (row stride kLD) -> global T (stride kD)
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, const float* src,
                                           int rows) {
  constexpr int kChunks = kD / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    store4(dst + static_cast<size_t>(r) * kD + c,
           *reinterpret_cast<const float4*>(src + r * kLD + c));
  }
}

template <typename T>
constexpr size_t tile_bytes() {
  return static_cast<size_t>(kBQ) * kLD * sizeof(T);
}
constexpr size_t score_bytes() {
  return static_cast<size_t>(kBQ) * kLS * sizeof(float);
}
template <typename T>
constexpr size_t prob_bytes() {
  return static_cast<size_t>(kBQ) * kLP * sizeof(T);
}

// number of k tiles a causal q tile starting at q0 reaches
__device__ __forceinline__ int kv_tiles(int q0, int s_kv, int offset,
                                        int causal) {
  const int n_kv = s_kv / kBK;
  if (!causal) return n_kv;
  const int last = q0 + kBQ - 1 + offset;
  return last < 0 ? 0 : min(n_kv, last / kBK + 1);
}

// the shared memory of `tiles` tiles' segment ids (SEG only)
constexpr size_t ids_bytes(bool seg, int tiles) {
  return seg ? static_cast<size_t>(tiles) * kBQ * sizeof(int) : 0;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, bool SEG>
constexpr size_t fwd_smem() {
  return (1 + 2 * kStages<T>) * tile_bytes<T>() + score_bytes() +
         prob_bytes<T>() + kBQ * sizeof(float) + ids_bytes(SEG, kStages<T>);
}

template <typename T, bool SEG, bool DROP>
__global__ void __launch_bounds__(kFwdThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int s_q, int s_kv, float scale,
                     int causal, const Variant var) {
  using C = typename Mma<T>::C;
  constexpr int S = kStages<T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKV = sQ + kBQ * kLD;  // S x (K tile, V tile)
  float* sS = reinterpret_cast<float*>(sKV + 2 * S * kBK * kLD);
  T* sP = reinterpret_cast<T*>(sS + kBQ * kLS);
  float* sRow = reinterpret_cast<float*>(sP + kBQ * kLP);
  int* sIdK = reinterpret_cast<int*>(sRow + kBQ);  // SEG: S x (k tile ids)
  float* stage = reinterpret_cast<float*>(sKV);  // after the loop: kBQ x kLD

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int offset = s_kv - s_q;
  const T* kb = k + static_cast<size_t>(bh) * s_kv * kD;
  const T* vb = v + static_cast<size_t>(bh) * s_kv * kD;
  const int kv_end = kv_tiles(q0, s_kv, offset, causal);
  const int batch = SEG ? bh / var.heads : 0;
  int2 q_ids = make_int2(0, 0);  // SEG: the q tile's (min, max) id
  if constexpr (SEG) q_ids = var.rng_q[batch * (s_q / kBQ) + blockIdx.x];
  // the first k tile from j on that the q tile may see (SEG: skipping the
  // tiles whose ids cannot meet the q tile's)
  auto next = [&](int j) {
    if constexpr (SEG)
      return next_tile(j, kv_end, var.rng_k + batch * (s_kv / kBK), q_ids.x,
                       q_ids.y);
    else
      return j;
  };
  auto issue = [&](int j, int b) {  // K/V tile j (and its ids) into buffer b
    T* dst = sKV + b * 2 * kBK * kLD;
    load_tile(dst, kb + static_cast<size_t>(j) * kBK * kD, kBK);
    load_tile(dst + kBK * kLD, vb + static_cast<size_t>(j) * kBK * kD, kBK);
    if constexpr (SEG)
      load_ids(sIdK + b * kBK,
               var.seg_k + static_cast<size_t>(batch) * s_kv + j * kBK);
    cp_async_commit();
  };
  load_tile(sQ, q + (static_cast<size_t>(bh) * s_q + q0) * kD, kBQ);
  cp_async_commit();
  int j = next(0);
  if (j < kv_end) issue(j, 0);

  // the row (within the warp's 16) of each accumulator element
  float* strip = sS + warp * 16 * kLS;
  for (int i = lane; i < 256; i += 32)
    strip[(i >> 4) * kLS + (i & 15)] = i >> 4;
  __syncwarp();
  C probe;
  wmma::load_matrix_sync(probe, strip, kLS, wmma::mem_row_major);
  int rowof[C::num_elements];
#pragma unroll
  for (int i = 0; i < C::num_elements; ++i)
    rowof[i] = static_cast<int>(probe.x[i]);

  // bf16: the warp's 16 query rows stay in registers as A fragments
  typename Mma<T>::template A<wmma::row_major> qf[kBf16 ? kD / 16 : 1];
  if constexpr (kBf16) {
    if (j < kv_end) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * kLD + kk * 16, kLD);
  }

  C acc[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  // softmax: two lanes per row, each on alternate columns
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r;
  const int qpos = q0 + row;
  int q_id = 0;  // SEG: this row's segment id
  if constexpr (SEG) q_id = var.seg_q[static_cast<size_t>(batch) * s_q + qpos];
  float m = kNegInf, l = 0.f;

  for (int it = 0; j < kv_end; ++it) {
    const int j_next = next(j + 1);
    // a buffer is reused only after the barrier that ends the iteration
    // that read it
    if (S == 1 && it > 0) issue(j, 0);
    if (S == 2 && j_next < kv_end) {
      issue(j_next, (it + 1) % S);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sK = sKV + (it % S) * 2 * kBK * kLD;
    const T* sV = sK + kBK * kLD;
    const int* k_id = sIdK + (it % S) * kBK;
    // whether this row's score against column c of the tile is masked
    auto hidden = [&](int c) {
      bool h = causal && qpos + offset < j * kBK + c;
      if constexpr (SEG) h = h || q_id != k_id[c];
      return h;
    };
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      C s;
      wmma::fill_fragment(s, 0.f);
      if constexpr (kBf16) {
        typename Mma<T>::template B<wmma::col_major> fb;
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          wmma::load_matrix_sync(fb, sK + n * 16 * kLD + kk * 16, kLD);
          wmma::mma_sync(s, qf[kk], fb, s);
        }
      } else {
        mma_tile<T, wmma::row_major, wmma::col_major>(
            s, sQ + warp * 16 * kLD, kLD, sK + n * 16 * kLD, kLD, kD);
      }
      wmma::store_matrix_sync(strip + n * 16, s, kLS, wmma::mem_row_major);
    }
    __syncwarp();
    float sv[kBK / 2];
    float mx = kNegInf;
#pragma unroll
    for (int c2 = 0; c2 < kBK / 2; ++c2) {
      const int c = 2 * c2 + half;
      float x = strip[r * kLS + c] * scale;
      if (hidden(c)) x = kNegInf;
      sv[c2] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);
    float sum = 0.f;
    T* prow = sP + row * kLP;
#pragma unroll
    for (int c2 = 0; c2 < kBK / 2; ++c2) {
      const int c = 2 * c2 + half;
      const bool masked = hidden(c);
      const float p = masked ? 0.f : __expf(sv[c2] - m_new);
      sum += p;  // l sums the undropped weights
      float p_v = p;
      if constexpr (DROP)
        p_v = !masked && keep(var, bh, qpos, j * kBK + c) ? p * var.inv : 0.f;
      prow[c] = from_f<T>(p_v);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = alpha * l + sum;
    m = m_new;
    if (half == 0) sRow[row] = alpha;
    __syncwarp();
    float f[C::num_elements];
#pragma unroll
    for (int i = 0; i < C::num_elements; ++i)
      f[i] = sRow[warp * 16 + rowof[i]];
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
#pragma unroll
      for (int i = 0; i < C::num_elements; ++i) acc[n].x[i] *= f[i];
      mma_tile<T, wmma::row_major, wmma::row_major>(
          acc[n], sP + warp * 16 * kLP, kLP, sV + n * 16, kLD, kBK);
    }
    __syncthreads();  // every warp is done with this K/V buffer
    j = j_next;
  }
  cp_async_wait<0>();

  if (half == 0) {
    const float safe = l == 0.f ? 1.f : l;
    sRow[row] = safe;
    lse[static_cast<size_t>(bh) * s_q + qpos] = m + logf(safe);
  }
  __syncthreads();  // the K/V buffers become the output staging
  float f[C::num_elements];
#pragma unroll
  for (int i = 0; i < C::num_elements; ++i) f[i] = sRow[warp * 16 + rowof[i]];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
#pragma unroll
    for (int i = 0; i < C::num_elements; ++i) acc[n].x[i] /= f[i];
    wmma::store_matrix_sync(stage + warp * 16 * kLD + n * 16, acc[n], kLD,
                            wmma::mem_row_major);
  }
  __syncthreads();
  store_tile(o + (static_cast<size_t>(bh) * s_q + q0) * kD, stage, kBQ);
}

// ---------------------------------------------------------------------------
// backward, float inputs: the WMMA dK/dV and dQ kernels
// ---------------------------------------------------------------------------

// s = q k^T and dp = dO v^T for one q tile against one k tile (64 x 64
// each, 16 fragments each; warp w computes fragments 2w and 2w + 1)
template <typename T>
__device__ __forceinline__ void scores(const T* sQ, const T* sdO, const T* sK,
                                       const T* sV, float* sS, float* sdP,
                                       int warp) {
  using C = typename Mma<T>::C;
#pragma unroll
  for (int t = 2 * warp; t < 2 * warp + 2; ++t) {
    const int tr = t >> 2, tc = t & 3;
    C s;
    wmma::fill_fragment(s, 0.f);
    mma_tile<T, wmma::row_major, wmma::col_major>(
        s, sQ + tr * 16 * kLD, kLD, sK + tc * 16 * kLD, kLD, kD);
    wmma::store_matrix_sync(sS + tr * 16 * kLS + tc * 16, s, kLS,
                            wmma::mem_row_major);
    C dp;
    wmma::fill_fragment(dp, 0.f);
    mma_tile<T, wmma::row_major, wmma::col_major>(
        dp, sdO + tr * 16 * kLD, kLD, sV + tc * 16 * kLD, kLD, kD);
    wmma::store_matrix_sync(sdP + tr * 16 * kLS + tc * 16, dp, kLS,
                            wmma::mem_row_major);
  }
}

// p = exp(s * scale - lse) (0 where masked), ds = p * (dp - delta) * scale;
// q rows from q0, k columns from k0. sP may be null (the dQ pass). SEG:
// q_id / k_id hold the tile's segment ids. DROP: sP takes the dropped p
// times 1 / (1 - rate) (dV's weights), and dp is dropped and scaled the
// same way before ds, which keeps the undropped p.
template <typename T, bool SEG, bool DROP>
__device__ __forceinline__ void probs(const float* sS, const float* sdP,
                                      const float* sLse, const float* sDelta,
                                      T* sP, T* sdS, int q0, int k0,
                                      int offset, float scale, int causal,
                                      const int* q_id, const int* k_id,
                                      int bh, const Variant& var) {
  for (int e = threadIdx.x; e < kBQ * kBK; e += blockDim.x) {
    const int r = e / kBK, c = e % kBK;
    bool masked = causal && q0 + r + offset < k0 + c;
    if constexpr (SEG) masked = masked || q_id[r] != k_id[c];
    const float p = masked ? 0.f : __expf(sS[r * kLS + c] * scale - sLse[r]);
    float dp = sdP[r * kLS + c], p_d = p;
    if constexpr (DROP) {
      if (!masked && keep(var, bh, q0 + r, k0 + c)) {
        p_d = p * var.inv;
        dp *= var.inv;
      } else {
        p_d = dp = 0.f;
      }
    }
    const float ds = p * (dp - sDelta[r]) * scale;
    if (sP != nullptr) sP[r * kLP + c] = from_f<T>(p_d);
    sdS[r * kLP + c] = from_f<T>(ds);
  }
}

template <typename T, bool SEG>
constexpr size_t dkv_smem() {
  return (2 + 2 * kStages<T>) * tile_bytes<T>() + 2 * score_bytes() +
         2 * prob_bytes<T>() + kStages<T> * 2 * kBQ * sizeof(float) +
         ids_bytes(SEG, 1 + kStages<T>);
}

template <typename T, bool SEG, bool DROP>
__global__ void __launch_bounds__(kBwdThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int s_q, int s_kv, float scale,
                     int causal, const Variant var) {
  using C = typename Mma<T>::C;
  constexpr int S = kStages<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kBK * kLD;
  T* sQdO = sV + kBK * kLD;  // S x (Q tile, dO tile)
  float* sS = reinterpret_cast<float*>(sQdO + 2 * S * kBQ * kLD);
  float* sdP = sS + kBQ * kLS;
  T* sP = reinterpret_cast<T*>(sdP + kBQ * kLS);
  T* sdS = sP + kBQ * kLP;
  // S x (lse row, delta row)
  float* sStats = reinterpret_cast<float*>(sdS + kBQ * kLP);
  // SEG: the k tile's ids, then S x (q tile ids)
  int* sIdK = reinterpret_cast<int*>(sStats + S * 2 * kBQ);
  int* sIdQ = sIdK + kBK;
  float* stage = reinterpret_cast<float*>(sQdO);  // after the loop: kBK x kLD

  const int warp = threadIdx.x >> 5;
  const int rt = warp & 3, ch = warp >> 2;  // 16 key rows, 64 columns
  const int bh = blockIdx.y, k0 = blockIdx.x * kBK;
  const int offset = s_kv - s_q;
  const size_t kv_base = (static_cast<size_t>(bh) * s_kv + k0) * kD;
  const int n_q = s_q / kBQ;
  const int batch = SEG ? bh / var.heads : 0;
  int i0 = 0;  // the first q tile that sees a key of this k tile
  if (causal)
    while (i0 < n_q && k0 > i0 * kBQ + kBQ - 1 + offset) ++i0;
  int2 k_ids = make_int2(0, 0);  // SEG: the k tile's (min, max) id
  if constexpr (SEG) k_ids = var.rng_k[batch * (s_kv / kBK) + blockIdx.x];
  auto next = [&](int i) {  // the first q tile from i on that may see it
    if constexpr (SEG)
      return next_tile(i, n_q, var.rng_q + batch * n_q, k_ids.x, k_ids.y);
    else
      return i;
  };
  auto issue = [&](int i, int b) {  // q tile i into buffer b
    const size_t q_base = (static_cast<size_t>(bh) * s_q + i * kBQ) * kD;
    load_tile(sQdO + b * 2 * kBQ * kLD, q + q_base, kBQ);
    load_tile(sQdO + (b * 2 + 1) * kBQ * kLD, dout + q_base, kBQ);
    const size_t row = static_cast<size_t>(bh) * s_q + i * kBQ;
    load_row_stats(sStats + b * 2 * kBQ, lse + row);
    load_row_stats(sStats + (b * 2 + 1) * kBQ, delta + row);
    if constexpr (SEG)
      load_ids(sIdQ + b * kBQ,
               var.seg_q + static_cast<size_t>(batch) * s_q + i * kBQ);
    cp_async_commit();
  };
  load_tile(sK, k + kv_base, kBK);
  load_tile(sV, v + kv_base, kBK);
  if constexpr (SEG)
    load_ids(sIdK, var.seg_k + static_cast<size_t>(batch) * s_kv + k0);
  cp_async_commit();
  int i = next(i0);
  if (i < n_q) issue(i, 0);

  C dk_acc[4], dv_acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  for (int it = 0; i < n_q; ++it) {
    const int i_next = next(i + 1);
    // a buffer is reused only after the barrier that ends the iteration
    // that read it
    if (S == 1 && it > 0) issue(i, 0);
    if (S == 2 && i_next < n_q) {
      issue(i_next, (it + 1) % S);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int b = it % S;
    const T* sQ = sQdO + b * 2 * kBQ * kLD;
    const T* sdO = sQ + kBQ * kLD;
    const float* sLse = sStats + b * 2 * kBQ;
    scores<T>(sQ, sdO, sK, sV, sS, sdP, warp);
    __syncthreads();
    probs<T, SEG, DROP>(sS, sdP, sLse, sLse + kBQ, sP, sdS, i * kBQ, k0,
                        offset, scale, causal, sIdQ + b * kBQ, sIdK, bh, var);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      // dV += P^T dO, dK += dS^T Q (P^T, dS^T: col-major views of P, dS)
      mma_tile<T, wmma::col_major, wmma::row_major>(
          dv_acc[n], sP + rt * 16, kLP, sdO + ch * 64 + n * 16, kLD, kBQ);
      mma_tile<T, wmma::col_major, wmma::row_major>(
          dk_acc[n], sdS + rt * 16, kLP, sQ + ch * 64 + n * 16, kLD, kBQ);
    }
    __syncthreads();  // every warp is done with this buffer, P and dS
    i = i_next;
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(stage + rt * 16 * kLD + ch * 64 + n * 16,
                            dv_acc[n], kLD, wmma::mem_row_major);
  __syncthreads();
  store_tile(dv + kv_base, stage, kBK);
  __syncthreads();
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(stage + rt * 16 * kLD + ch * 64 + n * 16,
                            dk_acc[n], kLD, wmma::mem_row_major);
  __syncthreads();
  store_tile(dk + kv_base, stage, kBK);
}

template <typename T, bool SEG>
constexpr size_t dq_smem() {
  return (2 + 2 * kDqStages) * tile_bytes<T>() + 2 * score_bytes() +
         prob_bytes<T>() + 2 * kBQ * sizeof(float) +
         ids_bytes(SEG, 1 + kDqStages);
}

template <typename T, bool SEG, bool DROP>
__global__ void __launch_bounds__(kBwdThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int s_q, int s_kv, float scale, int causal,
                    const Variant var) {
  using C = typename Mma<T>::C;
  constexpr int S = kDqStages;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + kBQ * kLD;
  T* sKV = sdO + kBQ * kLD;  // S x (K tile, V tile)
  float* sS = reinterpret_cast<float*>(sKV + 2 * S * kBK * kLD);
  float* sdP = sS + kBQ * kLS;
  T* sdS = reinterpret_cast<T*>(sdP + kBQ * kLS);
  float* sLse = reinterpret_cast<float*>(sdS + kBQ * kLP);
  float* sDelta = sLse + kBQ;
  // SEG: the q tile's ids, then S x (k tile ids)
  int* sIdQ = reinterpret_cast<int*>(sDelta + kBQ);
  int* sIdK = sIdQ + kBQ;
  float* stage = reinterpret_cast<float*>(sKV);  // after the loop: kBQ x kLD

  const int warp = threadIdx.x >> 5;
  const int rt = warp & 3, ch = warp >> 2;  // 16 query rows, 64 columns
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int offset = s_kv - s_q;
  const size_t q_base = (static_cast<size_t>(bh) * s_q + q0) * kD;
  const T* kb = k + static_cast<size_t>(bh) * s_kv * kD;
  const T* vb = v + static_cast<size_t>(bh) * s_kv * kD;
  const int kv_end = kv_tiles(q0, s_kv, offset, causal);
  const int batch = SEG ? bh / var.heads : 0;
  int2 q_ids = make_int2(0, 0);  // SEG: the q tile's (min, max) id
  if constexpr (SEG) q_ids = var.rng_q[batch * (s_q / kBQ) + blockIdx.x];
  auto next = [&](int j) {  // the first k tile from j on that it may see
    if constexpr (SEG)
      return next_tile(j, kv_end, var.rng_k + batch * (s_kv / kBK), q_ids.x,
                       q_ids.y);
    else
      return j;
  };
  auto issue = [&](int j, int b) {  // K/V tile j (and its ids) into buffer b
    T* dst = sKV + b * 2 * kBK * kLD;
    load_tile(dst, kb + static_cast<size_t>(j) * kBK * kD, kBK);
    load_tile(dst + kBK * kLD, vb + static_cast<size_t>(j) * kBK * kD, kBK);
    if constexpr (SEG)
      load_ids(sIdK + b * kBK,
               var.seg_k + static_cast<size_t>(batch) * s_kv + j * kBK);
    cp_async_commit();
  };
  load_tile(sQ, q + q_base, kBQ);
  load_tile(sdO, dout + q_base, kBQ);
  load_row_stats(sLse, lse + static_cast<size_t>(bh) * s_q + q0);
  load_row_stats(sDelta, delta + static_cast<size_t>(bh) * s_q + q0);
  if constexpr (SEG)
    load_ids(sIdQ, var.seg_q + static_cast<size_t>(batch) * s_q + q0);
  cp_async_commit();
  int j = next(0);
  if (j < kv_end) issue(j, 0);

  C dq_acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(dq_acc[n], 0.f);

  for (int it = 0; j < kv_end; ++it) {
    const int j_next = next(j + 1);
    if (S == 1 && it > 0) issue(j, 0);
    if (S == 2 && j_next < kv_end) {
      issue(j_next, (it + 1) % S);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sK = sKV + (it % S) * 2 * kBK * kLD;
    const T* sV = sK + kBK * kLD;
    scores<T>(sQ, sdO, sK, sV, sS, sdP, warp);
    __syncthreads();
    probs<T, SEG, DROP>(sS, sdP, sLse, sDelta, static_cast<T*>(nullptr), sdS,
                        q0, j * kBK, offset, scale, causal, sIdQ,
                        sIdK + (it % S) * kBK, bh, var);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 4; ++n)  // dQ += dS K
      mma_tile<T, wmma::row_major, wmma::row_major>(
          dq_acc[n], sdS + rt * 16 * kLP, kLP, sK + ch * 64 + n * 16, kLD,
          kBK);
    __syncthreads();  // every warp is done with this buffer and dS
    j = j_next;
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(stage + rt * 16 * kLD + ch * 64 + n * 16,
                            dq_acc[n], kLD, wmma::mem_row_major);
  __syncthreads();
  store_tile(dq + q_base, stage, kBQ);
}

// ---------------------------------------------------------------------------
// backward, bf16 inputs: one mma.sync kernel for dK, dV and dQ
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kBwdKeys = 128;                  // key rows per block
constexpr int kBwdWarps = kBwdKeys / 16;       // 16 key rows per warp
constexpr int kBwdMmaThreads = kBwdWarps * 32;
constexpr int kBwdQ = 64;                      // query rows per q tile
constexpr int kLdT = kBwdQ + 8;                // row stride of the dS^T tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8 and receives, of matrix i, in r[i]: row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 (trans: column l / 4, rows 2 (l % 4)
// and 2 (l % 4) + 1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b over one m16n8k16 step: a the 16 x 16 row-major A fragment, b0 /
// b1 the two registers of the 16 x 8 B fragment; f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <bool SEG>
constexpr size_t bwd_smem() {
  return (2 * kBwdKeys + 2 * 2 * kBwdQ) * kLD * sizeof(bf16) +
         2 * kBwdKeys * kLdT * sizeof(bf16) + 2 * 2 * kBwdQ * sizeof(float) +
         (SEG ? (kBwdKeys + 2 * kBwdQ) * sizeof(int) : 0);
}

// dQ[q tile at q0] += dS K for one 128-key tile: dS^T [key][query] in sdS,
// K [key][d] in sK; warp w takes 16 queries x 64 columns over the 128 keys
// and adds its partial into the f32 workspace by float2 atomics.
__device__ __forceinline__ void dq_tile(const bf16* sdS, const bf16* sK,
                                        float* dq_acc, int bh, int s_q,
                                        int q0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bt_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int bt_col = (lane >> 4) * 8;
  const int qr = (warp & 3) * 16, dc = (warp >> 2) * 64;
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kBwdKeys / 16; ++kk) {
    uint32_t a[4], bk[4];
    // A = dS [query][key] from dS^T by .trans: lane l addresses key row
    // l % 8 + 8 (l / 16), query half (l / 8) % 2
    ldsm_x4_t(a, sdS + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdT +
                     qr + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      ldsm_x4_t(bk, sK + (kk * 16 + bt_row) * kLD + dc + np * 16 + bt_col);
      mma_bf16(acc[2 * np], a, bk[0], bk[1]);
      mma_bf16(acc[2 * np + 1], a, bk[2], bk[3]);
    }
  }
  float* dst =
      dq_acc + (static_cast<size_t>(bh) * s_q + q0 + qr + g) * kD + dc + 2 * t4;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    atomicAdd(reinterpret_cast<float2*>(dst + n * 8),
              make_float2(acc[n][0], acc[n][1]));
    atomicAdd(reinterpret_cast<float2*>(dst + 8 * kD + n * 8),
              make_float2(acc[n][2], acc[n][3]));
  }
}

// Fragment layouts (m16n8k16, g = lane / 4, t = lane % 4): an accumulator
// holds (row g, columns 2t, 2t + 1) and (row g + 8, the same columns); an
// A fragment the same rows at columns 2t, 2t + 1 and 2t + 8, 2t + 9; a B
// fragment (rows 2t, 2t + 1 | 2t + 8, 2t + 9, column g).
template <bool SEG, bool DROP>
__global__ void __launch_bounds__(kBwdMmaThreads, 1)
    flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_acc, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int s_q, int s_kv, float scale,
                     int causal, const Variant var) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kBwdKeys * kLD;
  bf16* sQdO = sV + kBwdKeys * kLD;  // 2 x (Q tile, dO tile)
  bf16* sdS = sQdO + 2 * 2 * kBwdQ * kLD;  // 2 x dS^T [key][query]
  // 2 x (lse row, delta row)
  float* sStats = reinterpret_cast<float*>(sdS + 2 * kBwdKeys * kLdT);
  // SEG: the key tile's ids, then 2 x (q tile ids)
  int* sIdK = reinterpret_cast<int*>(sStats + 2 * 2 * kBwdQ);
  int* sIdQ = sIdK + kBwdKeys;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, k0 = blockIdx.y * kBwdKeys;
  const int keys = min(kBwdKeys, s_kv - k0);  // 128, or 64 at the end
  const int offset = s_kv - s_q;
  const size_t kv_base = (static_cast<size_t>(bh) * s_kv + k0) * kD;
  const int n_q = s_q / kBwdQ;
  const int batch = SEG ? bh / var.heads : 0;
  int i0 = 0;  // the first q tile that sees a key of this tile
  if (causal)
    while (i0 < n_q && k0 > i0 * kBwdQ + kBwdQ - 1 + offset) ++i0;
  int2 k_ids = make_int2(0, 0);  // SEG: the key tile's (min, max) id
  if constexpr (SEG) {
    const int2* rk = var.rng_k + batch * (s_kv / kBK) + k0 / kBK;
    k_ids = rk[0];
    if (keys > kBK) {
      k_ids.x = min(k_ids.x, rk[1].x);
      k_ids.y = max(k_ids.y, rk[1].y);
    }
  }
  auto next = [&](int i) {  // the first q tile from i on that may see it
    if constexpr (SEG)
      return next_tile(i, n_q, var.rng_q + batch * n_q, k_ids.x, k_ids.y);
    else
      return i;
  };
  auto issue = [&](int i, int b) {  // q tile i into buffer b
    const size_t q_base = (static_cast<size_t>(bh) * s_q + i * kBwdQ) * kD;
    load_tile(sQdO + b * 2 * kBwdQ * kLD, q + q_base, kBwdQ);
    load_tile(sQdO + (b * 2 + 1) * kBwdQ * kLD, dout + q_base, kBwdQ);
    const size_t row = static_cast<size_t>(bh) * s_q + i * kBwdQ;
    load_row_stats(sStats + b * 2 * kBwdQ, lse + row);
    load_row_stats(sStats + (b * 2 + 1) * kBwdQ, delta + row);
    if constexpr (SEG)
      load_ids(sIdQ + b * kBwdQ,
               var.seg_q + static_cast<size_t>(batch) * s_q + i * kBwdQ);
    cp_async_commit();
  };
  load_tile(sK, k + kv_base, keys);
  load_tile(sV, v + kv_base, keys);
  if constexpr (SEG)
    load_ids(sIdK, var.seg_k + static_cast<size_t>(batch) * s_kv + k0,
             keys);
  cp_async_commit();
  // a half tile at the end: zero rows, so that dS K reads no stale values
  {
    constexpr int kChunks = kLD * sizeof(bf16) / 16;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int c = keys * kChunks + threadIdx.x; c < kBwdKeys * kChunks;
         c += blockDim.x) {
      reinterpret_cast<uint4*>(sK)[c] = zero;
      reinterpret_cast<uint4*>(sV)[c] = zero;
    }
  }
  int i = next(i0);
  if (i < n_q) issue(i, 0);

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int krow = warp * 16;  // this warp's key rows in the tile
  // ldmatrix row addresses: A from row-major rows (lane % 16, column half
  // lane / 16); B of two n-tiles from rows [n][k] (n lane % 8 + 8 (lane /
  // 16), k half (lane / 8) % 2), by .trans from rows [k][n] (k lane % 8 +
  // 8 ((lane / 8) % 2), n half lane / 16)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const int bt_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int bt_col = (lane >> 4) * 8;

  // One barrier per q tile. Iteration it computes tile i's dS^T into dS
  // buffer it % 2, then the dQ step of the tile before (buffer (it + 1) %
  // 2), whose dS^T every warp finished before this iteration's barrier;
  // the next iteration's barrier keeps that buffer from being overwritten
  // while a warp still reads it.
  int it = 0, q_prev = -1;  // the q tile whose dQ step is pending
  for (; i < n_q; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    // every warp is past the last iteration's reads of buffer (it + 1) % 2
    const int i_next = next(i + 1);
    if (i_next < n_q) issue(i_next, (it + 1) & 1);
    const int b = it & 1;
    bf16* sdS_cur = sdS + b * kBwdKeys * kLdT;
    const bf16* sQ = sQdO + b * 2 * kBwdQ * kLD;
    const bf16* sdO = sQ + kBwdQ * kLD;
    const float* sLse = sStats + b * 2 * kBwdQ;
    const float* sDelta = sLse + kBwdQ;
    const int* q_id = sIdQ + b * kBwdQ;
    const int q0 = i * kBwdQ;
    int k_id[2] = {0, 0};  // SEG: the ids of this thread's two key rows
    if constexpr (SEG) {
      k_id[0] = sIdK[krow + g];
      k_id[1] = sIdK[krow + g + 8];
    }

    // unrolled, so that the two halves' products and masks overlap
#pragma unroll
    for (int h = 0; h < kBwdQ / 32; ++h) {  // 32 queries at a time
      const int qh = h * 32;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries, over d
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t a[4], bq[4];
        ldsm_x4(a, sK + (krow + a_row) * kLD + kk * 16 + a_col);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          ldsm_x4(bq, sQ + (qh + np * 16 + b_row) * kLD + kk * 16 + b_col);
          mma_bf16(s[2 * np], a, bq[0], bq[1]);
          mma_bf16(s[2 * np + 1], a, bq[2], bq[3]);
        }
        ldsm_x4(a, sV + (krow + a_row) * kLD + kk * 16 + a_col);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          ldsm_x4(bq, sdO + (qh + np * 16 + b_row) * kLD + kk * 16 + b_col);
          mma_bf16(dp[2 * np], a, bq[0], bq[1]);
          mma_bf16(dp[2 * np + 1], a, bq[2], bq[3]);
        }
      }
      // in registers: s -> the weights of dV (p, or dropped and scaled),
      // dp -> ds = p * (dp - delta) * scale
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = qh + n * 8 + 2 * t4 + (e & 1);
          const int kr = krow + g + 8 * (e >> 1);
          const int qpos = q0 + ql, kpos = k0 + kr;
          bool masked = kpos >= s_kv || (causal && qpos + offset < kpos);
          if constexpr (SEG) masked = masked || q_id[ql] != k_id[e >> 1];
          const float p = masked ? 0.f : __expf(s[n][e] * scale - sLse[ql]);
          float dpv = dp[n][e], p_d = p;
          if constexpr (DROP) {
            if (!masked && keep(var, bh, qpos, kpos)) {
              p_d = p * var.inv;
              dpv *= var.inv;
            } else {
              p_d = dpv = 0.f;
            }
          }
          s[n][e] = p_d;
          dp[n][e] = p * (dpv - sDelta[ql]) * scale;
        }
      }
      // two adjacent n-tiles of the accumulators = one k16 A fragment
      uint32_t pa[2][4], da[2][4];
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        pa[kt][0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
        pa[kt][1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
        pa[kt][2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
        pa[kt][3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
        da[kt][0] = pack_bf16(dp[2 * kt][0], dp[2 * kt][1]);
        da[kt][1] = pack_bf16(dp[2 * kt][2], dp[2 * kt][3]);
        da[kt][2] = pack_bf16(dp[2 * kt + 1][0], dp[2 * kt + 1][1]);
        da[kt][3] = pack_bf16(dp[2 * kt + 1][2], dp[2 * kt + 1][3]);
        // dS^T to shared memory for the dQ product
        bf16* row0 = sdS_cur + (krow + g) * kLdT + qh + kt * 16 + 2 * t4;
        bf16* row8 = row0 + 8 * kLdT;
        *reinterpret_cast<uint32_t*>(row0) = da[kt][0];
        *reinterpret_cast<uint32_t*>(row8) = da[kt][1];
        *reinterpret_cast<uint32_t*>(row0 + 8) = da[kt][2];
        *reinterpret_cast<uint32_t*>(row8 + 8) = da[kt][3];
      }
      // dV += P^T dO, dK += dS^T Q over these 32 queries
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        const int qr = qh + kt * 16 + bt_row;
#pragma unroll
        for (int np = 0; np < kD / 16; ++np) {
          uint32_t bo[4];
          ldsm_x4_t(bo, sdO + qr * kLD + np * 16 + bt_col);
          mma_bf16(dv_acc[2 * np], pa[kt], bo[0], bo[1]);
          mma_bf16(dv_acc[2 * np + 1], pa[kt], bo[2], bo[3]);
          ldsm_x4_t(bo, sQ + qr * kLD + np * 16 + bt_col);
          mma_bf16(dk_acc[2 * np], da[kt], bo[0], bo[1]);
          mma_bf16(dk_acc[2 * np + 1], da[kt], bo[2], bo[3]);
        }
      }
    }
    if (q_prev >= 0)
      dq_tile(sdS + (b ^ 1) * kBwdKeys * kLdT, sK, dq_acc, bh, s_q, q_prev);
    q_prev = q0;
    i = i_next;
  }
  if (q_prev >= 0) {  // the last q tile's dQ step
    __syncthreads();
    dq_tile(sdS + ((it - 1) & 1) * kBwdKeys * kLdT, sK, dq_acc, bh, s_q,
            q_prev);
  }

  // dK and dV: this thread's two key rows, bf16 pairs
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = krow + g + 8 * r;
    if (k0 + kr >= s_kv) continue;
    const size_t base = kv_base + static_cast<size_t>(kr) * kD + 2 * t4;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + base + n * 8) =
          pack_bf16(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + n * 8) =
          pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr bool kSeg = FLASH_SEG != 0;
constexpr bool kDrop = FLASH_DROP != 0;

bool shapes_ok(int bh, int s_q, int s_kv, int head_dim) {
  return bh > 0 && s_q > 0 && s_kv > 0 && head_dim == kD && s_q % kBQ == 0 &&
         s_kv % kBK == 0;
}

// what this library's variant reads: segment ids and their tile ranges
// (SEG), a rate in (0, 1) (DROP)
bool variant_ok(const Variant& var, int bh) {
  if (kSeg && (var.seg_q == nullptr || var.seg_k == nullptr ||
               var.rng_q == nullptr || var.rng_k == nullptr ||
               var.heads <= 0 || bh % var.heads != 0))
    return false;
  return !kDrop || (var.rate > 0.f && var.rate < 1.f);
}

Variant make_variant(const void* seg_q, const void* seg_k, const void* rng_q,
                     const void* rng_k, int heads, int seed, float rate,
                     float inv) {
  return Variant{static_cast<const int*>(seg_q),
                 static_cast<const int*>(seg_k),
                 static_cast<const int2*>(rng_q),
                 static_cast<const int2*>(rng_k),
                 heads,
                 static_cast<uint32_t>(seed),
                 rate,
                 inv};
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int s_q, int s_kv, float scale, int causal,
                const Variant& var, cudaStream_t s) {
  constexpr size_t smem = fwd_smem<T, kSeg>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, kSeg, kDrop>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, kSeg, kDrop>
      <<<dim3(s_q / kBQ, bh), kFwdThreads, smem, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o),
          static_cast<float*>(lse), s_q, s_kv, scale, causal, var);
  return cudaGetLastError();
}

// the WMMA dK/dV and dQ kernels, float inputs
cudaError_t bwd_f32(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, void* dk, void* dv, int bh, int s_q, int s_kv,
                    float scale, int causal, const Variant& var,
                    cudaStream_t s) {
  constexpr size_t dkv_bytes = dkv_smem<float, kSeg>();
  cudaError_t err = allow_smem(flash_dkv_kernel<float, kSeg, kDrop>,
                               dkv_bytes);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<float, kSeg, kDrop>
      <<<dim3(s_kv / kBK, bh), kBwdThreads, dkv_bytes, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<float*>(dk), static_cast<float*>(dv), s_q, s_kv, scale,
          causal, var);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t dq_bytes = dq_smem<float, kSeg>();
  err = allow_smem(flash_dq_kernel<float, kSeg, kDrop>, dq_bytes);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<float, kSeg, kDrop>
      <<<dim3(s_q / kBQ, bh), kBwdThreads, dq_bytes, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<float*>(dq), s_q, s_kv, scale, causal, var);
  return cudaGetLastError();
}

// the mma.sync kernel, bf16 inputs: zero the dQ workspace, then one launch
cudaError_t bwd_bf16(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq_acc, void* dk, void* dv, int bh, int s_q,
                     int s_kv, float scale, int causal, const Variant& var,
                     cudaStream_t s) {
  constexpr size_t bytes = bwd_smem<kSeg>();
  cudaError_t err = allow_smem(flash_bwd_kernel<kSeg, kDrop>, bytes);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(dq_acc, 0,
                        static_cast<size_t>(bh) * s_q * kD * sizeof(float), s);
  if (err != cudaSuccess) return err;
  flash_bwd_kernel<kSeg, kDrop>
      <<<dim3(bh, (s_kv + kBwdKeys - 1) / kBwdKeys), kBwdMmaThreads, bytes,
         s>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
              static_cast<const float*>(lse), static_cast<const float*>(delta),
              static_cast<float*>(dq_acc), static_cast<bf16*>(dk),
              static_cast<bf16*>(dv), s_q, s_kv, scale, causal, var);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous, 16-byte aligned, on one device: q/o/dq [bh, s_q,
// 128], k/v/dk/dv [bh, s_kv, 128] of one dtype (is_bf16: bfloat16, else
// float32); lse, delta [bh, s_q] float32. s_q and s_kv multiples of 64.
// The variant arguments are read by this library's variant only (the
// plain one ignores them): seg_q [b, s_q], seg_k [b, s_kv] int32 with
// bh = b * heads, rng_q [b, s_q / 64, 2], rng_k [b, s_kv / 64, 2] int32,
// each tile's (min, max) id; the dropout seed (its 32 bits key the mask),
// rate in (0, 1) and inv = 1 / (1 - rate). Each launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, const void* seg_q, const void* seg_k,
                         const void* rng_q, const void* rng_k, int bh, int s_q,
                         int s_kv, int head_dim, int heads, float scale,
                         int causal, int seed, float rate, float inv,
                         int is_bf16, void* stream) {
  const Variant var =
      make_variant(seg_q, seg_k, rng_q, rng_k, heads, seed, rate, inv);
  if (!shapes_ok(bh, s_q, s_kv, head_dim) || !variant_ok(var, bh))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? fwd<__nv_bfloat16>(q, k, v, o, lse, bh, s_q, s_kv, scale,
                                   causal, var, s)
              : fwd<float>(q, k, v, o, lse, bh, s_q, s_kv, scale, causal, var,
                           s));
}

// dQ, dK, dV of attention: dq_acc [bh, s_q, 128] float32 receives dQ
// (bf16 inputs: summed there by atomics, the caller casts it; float
// inputs: written), dk/dv [bh, s_kv, 128] in the input dtype; the other
// arguments as flash_fwd's, with dout of q's shape and dtype and lse,
// delta [bh, s_q] float32. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq_acc, void* dk, void* dv, const void* seg_q,
                         const void* seg_k, const void* rng_q,
                         const void* rng_k, int bh, int s_q, int s_kv,
                         int head_dim, int heads, float scale, int causal,
                         int seed, float rate, float inv, int is_bf16,
                         void* stream) {
  const Variant var =
      make_variant(seg_q, seg_k, rng_q, rng_k, heads, seed, rate, inv);
  if (!shapes_ok(bh, s_q, s_kv, head_dim) || !variant_ok(var, bh))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? bwd_bf16(q, k, v, dout, lse, delta, dq_acc, dk, dv, bh, s_q,
                         s_kv, scale, causal, var, s)
              : bwd_f32(q, k, v, dout, lse, delta, dq_acc, dk, dv, bh, s_q,
                        s_kv, scale, causal, var, s));
}
