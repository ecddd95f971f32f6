// Paged decode attention for NVIDIA Hopper (sm_90a): split-KV in one
// launch, pages staged in shared memory by bulk copies.
//
// Replaces two TPU kernels of paddle_tpu/kernels/paged_attention.py:
// - `paged_attention` (the Pallas body `_decode_kernel`, float pages and
//   its `quant=True` int8 pages), by the entries paged_attention_decode and
//   paged_attention_decode_q8;
// - `paged_attention_grouped` (the Pallas body `_decode_grouped_kernel`,
//   8 pages a step by double-buffered copies), by the entry
//   paged_attention_decode_grouped.
// One new token per sequence attends the K/V already in its pages:
//   q            [batch, q_heads, D]            (q_heads = kv_heads * group)
//   k/v pages    [kv_heads, n_pages, page_size, D], q's dtype or int8
//   k/v scales   [kv_heads, n_pages, page_size] f32 (int8 pages only)
//   block_tables [batch, pages_per_seq] int32   (page ids of each sequence)
//   context_lens [batch] int32                  (tokens valid in the cache)
//   out          [batch, q_heads, D] in q's dtype, softmax and sums in f32.
// The function is `_decode_accumulate` with `_decode_epilogue`: masked
// scores at the TPU kernel's -1e30; for int8 pages each token's K scale
// multiplies its score after q . k_int8, its V scale multiplies its softmax
// weight before p . v_int8, and the normaliser sums the unscaled weights; a
// row with context 0 writes zeros; table entries past the context are never
// read.
//
// Bound on the H100: bytes. Each (row, kv head) reads ctx * D K values and
// ctx * D V values once (int8 pages: half of bf16, plus 8 bytes of scales
// a token); the arithmetic, 4 * ctx * q_heads * D flops, is far below the
// card's rate except at a multi-query group, where the K/V bytes are shared
// by 32 queries. What held the one-block-per-row kernels back was
// parallelism: a block walked its row's whole context, so the longest row's
// blocks (32 of them at 32 kv heads, 1-8 at GQA or MQA) set the time while
// most of the 132 SMs idled.
//
// Design:
// - Split-KV. A unit of work is (batch row, kv head, chunk of at most 8
//   queries, split); block (split, kv head * chunks + chunk, row). The
//   host picks `split_pages` and `n_splits` from the table's width, the
//   page size, the kv heads, the group and the SM count
//   (`paged_attention.split_plan`), so that one full-length row alone fills
//   the card; it never reads context_lens (no device sync, and the launch
//   captures in a CUDA graph). A row of context ctx has n_live =
//   ceil(ctx / (split_pages * page_size)) live units, over which the kernel
//   spreads the row's live pages evenly in whole pages; the other units
//   return at once.
// - Staging. A producer warp reads the unit's page ids from the block
//   table, all at once into shared memory, then brings its tokens in
//   32-token slices into a ring of R shared-memory slots on mbarriers: one
//   `cp.async.bulk` per page segment and tensor (a page of one kv head is
//   page_size * D contiguous elements, a multiple of 16 bytes at every
//   head_dim taken), a segment a lane. Only pages whose first token lies
//   below the context are read. The int8 scale rows come by bulk copy where
//   page_size % 4 == 0 and the pools are 16-byte aligned (16-byte rows and
//   offsets), else by plain loads of the producer's lanes (the second copy
//   path).
// - Compute from shared memory. W consumer warps take the unit's 32-token
//   slices in turn (slice j to warp j mod W), each keeping its own online
//   softmax (m, l, acc), so no block barrier sits in the loop. Scores: with
//   bf16 q at the 8-query bucket, `mma.sync` m16n8k16 (queries the rows,
//   tokens the columns, bf16 products exact in f32; int8 K is exact in
//   bf16); else on the CUDA cores, L lanes a token (L = G * D / 32, 4 to
//   32), each holding its share of the queries in registers and reading its
//   K row share by vector loads, a few shuffles to sum. P.V on the CUDA
//   cores with P in f32: the lanes split D, the weights read from the
//   warp's scratch, V rows from shared memory (independent loads, no
//   dependent chain through device memory).
// - Combine in the same launch. The W warps merge through shared memory.
//   A row whose context fits one split writes its output directly; else
//   each live unit writes its f32 (m, l, acc) partial to a workspace the
//   wrapper allocates, fences, and takes a ticket; the last of the
//   (row, kv head, chunk)'s live units sums the partials in split order
//   (deterministic; the splits' weights staged in shared memory, 8 loads of
//   acc in flight a thread) and resets the ticket (graph replay). Tickets
//   live in a __device__ array of this library: launches of it must not
//   overlap on two streams.
// Every entry runs one ring: 2 slots and 2 consumer warps (int8 pages 3
// and 3, the 8-query bucket 4 and 4), a warp a slot, several small blocks
// an SM keeping more slots in flight than a deeper ring per block did
// (measured on the H100). The grouped entry keeps its own contract and
// runs the same kernel: its reference's two-slot pipeline of 8-page
// stages, one 128 KB block an SM, measured slower on the H100 at 5 of the
// 6 shapes `chip_flash_ab.py --parts paged` times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kSlice = 32;                   // tokens a warp takes at once
constexpr int kPidCache = 256;               // page ids a unit stages
constexpr int kMaxSplits = 256;              // splits a row may be cut into
constexpr int kMaxGroup = 8;                 // queries a unit takes
constexpr int kMaxTickets = 1 << 16;         // (row, kv head, chunk) groups
constexpr float kNegInf = -1e30f;            // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// one ticket per (row, kv head, chunk), 0 between launches
__device__ unsigned g_tickets[kMaxTickets];

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

// N elements of P at p (N * sizeof(P)-byte aligned) as f32; int8 four to a
// word: a byte b becomes the float 2^23 + (b + 128) by a byte permute, less
// 2^23 + 128 (exact)
template <int N, typename P>
__device__ __forceinline__ void load_f32(const P* p, float* out) {
  if constexpr (sizeof(P) == 1 && N % 4 == 0) {
    const Chunk<uint32_t, N / 4> c =
        *reinterpret_cast<const Chunk<uint32_t, N / 4>*>(p);
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const uint32_t u = c.v[j] ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        out[4 * j + b] =
            __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + b)) -
            8388736.f;
      }
    }
  } else {
    const Chunk<P, N> c = *reinterpret_cast<const Chunk<P, N>*>(p);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(c.v[i]);
  }
}

// 8 elements of P at p as four bf16 pairs (int8: exact in bf16)
template <typename P>
__device__ __forceinline__ void load_bf16x8(const P* p, uint32_t (&w)[4]) {
  if constexpr (sizeof(P) == 2) {
    const Chunk<uint32_t, 4> c =
        *reinterpret_cast<const Chunk<uint32_t, 4>*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = c.v[i];
  } else {
    float f[8];
    load_f32<8>(p, f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 products exact in f32
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;  // int8 pages only
  const float* v_scales;
  const int* block_tables;
  const int* context_lens;
  void* out;
  float* ws;  // partials: [groups][n_splits][G][D] acc, then [..][G][2] m, l
  int n_pages, page_size, pages_per_seq, group;
  int split_pages, n_splits;
  float scale;
};

// the score lanes of a G-query, D-wide unit over pages of P
template <typename P, int D, int G>
struct Lanes {
  static constexpr int kWant = G * D / 32;
  static constexpr int L = kWant < 4 ? 4 : (kWant > 32 ? 32 : kWant);
  static constexpr int E = D / L;  // dims of a K row a lane takes
  static constexpr int kElt = static_cast<int>(sizeof(P));
  static constexpr int VE = E * kElt <= 16 ? E : 16 / kElt;
  static constexpr int NC = E / VE;    // its vector loads
  static constexpr int TPW = 32 / L;   // tokens a warp step takes
  static constexpr int EP = D / 32;    // dims of a V row a lane takes
};

// one slot of the ring: a slice's K and V rows (int8: and their scales)
template <typename P, int D, bool kQuant>
struct Slot {
  static constexpr int kRow = D * static_cast<int>(sizeof(P));
  static constexpr int kTile = kSlice * kRow;  // K or V
  static constexpr int kBytes = 2 * kTile + (kQuant ? 2 * kSlice * 4 : 0);
};

// shared memory: the ring (reused by the warps' merge and the combine's
// weights), the warps' weights, the unit's page ids, the barriers, a flag
template <typename P, int D, int G, int R, int W>
__host__ __device__ constexpr size_t ring_bytes() {
  constexpr bool kQuant = sizeof(P) == 1;
  constexpr size_t ring = static_cast<size_t>(R) * Slot<P, D, kQuant>::kBytes;
  constexpr size_t merge = sizeof(float) * (W * G * (D + 2) + 2 * G);
  constexpr size_t combine = sizeof(float) * (2 * kMaxSplits + 1) * G;
  constexpr size_t most = ring > merge ? ring : merge;
  return most > combine ? most : combine;
}
template <typename P, int D, int G, int R, int W>
__host__ __device__ constexpr size_t smem_bytes() {
  return ring_bytes<P, D, G, R, W>() + sizeof(float) * W * G * kSlice +
         sizeof(int) * kPidCache + 16 * R + 16;
}

// T: q and out; P: the pages (T, or int8_t with per-token scales); D
// head_dim; G the query bucket; R ring slots of kSlice tokens; W consumer
// warps (and one producer warp).
template <typename T, typename P, int D, int G, int R, int W>
__global__ void __launch_bounds__((W + 1) * 32)
    paged_decode_kernel(Args a) {
  constexpr int kThreads = (W + 1) * 32;
  constexpr bool kQuant = sizeof(P) == 1;
  using Ln = Lanes<P, D, G>;
  using Sl = Slot<P, D, kQuant>;
  constexpr int L = Ln::L, E = Ln::E, VE = Ln::VE, NC = Ln::NC;
  constexpr int TPW = Ln::TPW, EP = Ln::EP;
  // a warp's next slice in a slot must be that slot's next phase (a parity
  // wait cannot tell a phase from the one two ahead)
  static_assert(W <= R, "slots for every warp");
  // bf16 q at the 8-query bucket: scores on the tensor cores (queries the
  // rows of an m16n8k16 product, tokens its columns), else CUDA cores
  constexpr bool kMma = sizeof(T) == 2 && G == 8;
  static_assert(L * E == D && NC * VE == E, "score lanes");

  const int split = blockIdx.x;
  const int chunks = (a.group + G - 1) / G;
  const int h = blockIdx.y / chunks;
  const int g0 = (blockIdx.y % chunks) * G;  // this unit's first query
  const int ng = min(G, a.group - g0);       // its number of queries
  const int b = blockIdx.z;
  const int ps = a.page_size;
  const int q_heads = gridDim.y / chunks * a.group;

  int ctx = a.context_lens[b];
  ctx = max(0, min(ctx, a.pages_per_seq * ps));  // never past the table
  const int split_tok = a.split_pages * ps;
  const int n_live = max(1, (ctx + split_tok - 1) / split_tok);
  if (split >= n_live) return;  // no page of this unit lies below ctx
  // the row's live pages spread evenly over its n_live units, in whole
  // pages (each unit at most split_pages long)
  const int live_pages = (ctx + ps - 1) / ps;
  const int p0 = split * live_pages / n_live;  // its first table entry
  const int p1 = (split + 1) * live_pages / n_live;
  const int n_tok = min(ctx, p1 * ps) - p0 * ps;  // >= 0
  const int n_copy = (p1 - p0) * ps;              // whole live pages
  const int n_stages = (n_tok + kSlice - 1) / kSlice;

  extern __shared__ __align__(128) unsigned char smem[];
  constexpr size_t kRing = ring_bytes<P, D, G, R, W>();
  float* sp_all = reinterpret_cast<float*>(smem + kRing);  // [W][G][32]
  int* spid = reinterpret_cast<int*>(sp_all + W * G * kSlice);
  uint64_t* bars = reinterpret_cast<uint64_t*>(spid + kPidCache);
  int* sflag = reinterpret_cast<int*>(bars + 2 * R);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == 0) {
    for (int r = 0; r < R; ++r) {
      sm90::mbar_init(sm90::smem_u32(bars + r), 32);         // full
      sm90::mbar_init(sm90::smem_u32(bars + R + r), 1);      // empty
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int* table =
      a.block_tables + static_cast<size_t>(b) * a.pages_per_seq + p0;
  const long long head_base = static_cast<long long>(h) * a.n_pages;

  float m[G], l[G], acc[G][EP];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EP; ++e) acc[g][e] = 0.f;
  }

  if (warp == W) {
    // producer: the split's live page ids first (one round trip), then
    // stage st -> slot st % R, after its last reader released it
    const char* kp = static_cast<const char*>(a.k_pages);
    const char* vp = static_cast<const char*>(a.v_pages);
    const bool scale_bulk =
        (ps & 3) == 0 && ((reinterpret_cast<uintptr_t>(a.k_scales) |
                           reinterpret_cast<uintptr_t>(a.v_scales)) & 15) == 0;
    const int n_pid = n_copy / ps;
    const bool cached = n_pid <= kPidCache;
    if (cached) {
      for (int i = lane; i < n_pid; i += 32) spid[i] = table[i];
      __syncwarp();
    }
    const int* pids = cached ? spid : table;
    for (int st = 0; st < n_stages; ++st) {
      const int slot = st % R;
      if (st >= R) {
        sm90::mbar_wait(sm90::smem_u32(bars + R + slot), ((st / R) + 1) & 1);
      }
      unsigned char* dst = smem + static_cast<size_t>(slot) * Sl::kBytes;
      float* dks = reinterpret_cast<float*>(dst + 2 * Sl::kTile);
      float* dvs = dks + kSlice;
      const int t0 = st * kSlice;
      const int t1 = min(t0 + kSlice, n_copy);
      if (kQuant && !scale_bulk) {
        // second copy path: scale rows not 16-byte multiples or aligned
        for (int t = t0 + lane; t < t1; t += 32) {
          const long long tok =
              (head_base + pids[t / ps]) * ps + t % ps;
          dks[t - t0] = a.k_scales[tok];
          dvs[t - t0] = a.v_scales[tok];
        }
      }
      const uint32_t full = sm90::smem_u32(bars + slot);
      const int bytes =
          (t1 - t0) * (2 * Sl::kRow + (kQuant && scale_bulk ? 8 : 0));
      __syncwarp();
      if (lane == 0) sm90::mbar_expect_tx(full, bytes);  // lane 0's arrival
      __syncwarp();
      for (int pg = t0 / ps + lane; pg * ps < t1; pg += 32) {
        const int pid = pids[pg];
        const int r0 = max(t0, pg * ps) - pg * ps;
        const int r1 = min(t1, pg * ps + ps) - pg * ps;
        const long long src = (head_base + pid) * ps + r0;  // token index
        const int at = pg * ps + r0 - t0;                    // in the slot
        const int n = r1 - r0;
        sm90::bulk_copy(sm90::smem_u32(dst + at * Sl::kRow),
                        kp + src * Sl::kRow, n * Sl::kRow, full);
        sm90::bulk_copy(sm90::smem_u32(dst + Sl::kTile + at * Sl::kRow),
                        vp + src * Sl::kRow, n * Sl::kRow, full);
        if (kQuant && scale_bulk) {
          sm90::bulk_copy(sm90::smem_u32(dks + at), a.k_scales + src, n * 4,
                          full);
          sm90::bulk_copy(sm90::smem_u32(dvs + at), a.v_scales + src, n * 4,
                          full);
        }
      }
      if (lane != 0) sm90::mbar_arrive(full);
    }
  } else {
    // consumer warp: its query share in registers, lane sub of a token's L
    // lanes holding dims (c * L + sub) * VE + i
    const int sub = lane % L;
    const T* qb = static_cast<const T*>(a.q) +
                  (static_cast<size_t>(b) * q_heads +
                   static_cast<size_t>(h) * a.group + g0) * D;
    float qr[kMma ? 1 : G][kMma ? 1 : E];
    // kMma: the A fragments, the dims of 32-dim chunk c permuted alike in q
    // and K so that a lane's 16-byte K load feeds two products: half hf of
    // chunk c takes dims 32 c + 8 r + 4 hf + {0, 1} (word 0) and {2, 3}
    // (word 1) of query lane / 4, r = lane % 4
    uint32_t qa[kMma ? D / 8 : 1];
    if constexpr (kMma) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int dim = 32 * (i / 4) + 8 * (lane & 3) + 2 * (i % 4);
        qa[i] = (lane >> 2) < ng
                    ? *reinterpret_cast<const uint32_t*>(qb + (lane >> 2) * D +
                                                         dim)
                    : 0u;
      }
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
#pragma unroll
          for (int i = 0; i < VE; ++i) {
            qr[g][c * VE + i] =
                g < ng ? to_f32(qb[g * D + (c * L + sub) * VE + i]) : 0.f;
          }
        }
      }
    }
    float* sp = sp_all + warp * G * kSlice;  // this warp's weights [G][32]

    for (int st = warp; st < n_stages; st += W) {
      const int slot = st % R;
      sm90::mbar_wait(sm90::smem_u32(bars + slot), (st / R) & 1);
      const int n = min(kSlice, n_tok - st * kSlice);  // warp-uniform
      if (n > 0) {
        const unsigned char* base =
            smem + static_cast<size_t>(slot) * Sl::kBytes;
        const P* kt = reinterpret_cast<const P*>(base);
        const P* vt = reinterpret_cast<const P*>(base + Sl::kTile);
        const float* ks = reinterpret_cast<const float*>(base + 2 * Sl::kTile);
        const float* vs = ks + kSlice;

        // scores: lane t ends with token t's score against every query
        float s[G];
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] = 0.f;
        if constexpr (kMma) {
          // four 8-token tiles, each D / 16 products into the warp's
          // scratch [G][32], then read back a token a lane
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (nt * 8 >= n) break;  // warp-uniform
            float c[4] = {0.f, 0.f, 0.f, 0.f};
            const P* row = kt + (nt * 8 + (lane >> 2)) * D + 8 * (lane & 3);
#pragma unroll
            for (int cc = 0; cc < D / 32; ++cc) {
              uint32_t w[4];
              load_bf16x8(row + 32 * cc, w);
              mma_16816(c, qa[4 * cc], qa[4 * cc + 1], w[0], w[1]);
              mma_16816(c, qa[4 * cc + 2], qa[4 * cc + 3], w[2], w[3]);
            }
            *reinterpret_cast<float2*>(sp + (lane >> 2) * kSlice + nt * 8 +
                                       2 * (lane & 3)) =
                make_float2(c[0], c[1]);
          }
          __syncwarp();
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] = sp[g * kSlice + lane];
          __syncwarp();
        }
        if constexpr (!kMma) {
#pragma unroll 4
          for (int k = 0; k < L; ++k) {
            if (k * TPW >= n) break;  // warp-uniform
            const P* row = kt + (k * TPW + lane / L) * D;
            float part[G];
#pragma unroll
            for (int g = 0; g < G; ++g) part[g] = 0.f;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              float kf[VE];
              load_f32<VE>(row + (c * L + sub) * VE, kf);
#pragma unroll
              for (int i = 0; i < VE; ++i) {
#pragma unroll
                for (int g = 0; g < G; ++g)
                  part[g] += qr[g][c * VE + i] * kf[i];
              }
            }
#pragma unroll
            for (int o = L / 2; o > 0; o >>= 1) {
#pragma unroll
              for (int g = 0; g < G; ++g)
                part[g] += __shfl_xor_sync(kFull, part[g], o);
            }
            const int src = (lane % TPW) * L;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float v = __shfl_sync(kFull, part[g], src);
              if (lane / TPW == k) s[g] = v;
            }
          }
        }

        // fold the slice into this warp's online softmax
        const bool valid = lane < n;
        const float ksc = kQuant && valid ? ks[lane] : 1.f;
        const float vsc = kQuant && valid ? vs[lane] : 1.f;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float sc =
              valid ? (kQuant ? s[g] * a.scale * ksc : s[g] * a.scale)
                    : kNegInf;
          const float m_new = fmaxf(m[g], warp_max(sc));
          const float alpha = expf(m[g] - m_new);
          const float p = valid ? expf(sc - m_new) : 0.f;
          l[g] = l[g] * alpha + warp_sum(p);
          m[g] = m_new;
#pragma unroll
          for (int e = 0; e < EP; ++e) acc[g][e] *= alpha;
          sp[g * kSlice + lane] = kQuant ? p * vsc : p;
        }
        __syncwarp();

        // acc += P.V, the lanes splitting D; only the slice's n tokens
        for (int t0 = 0; t0 < n; t0 += 4) {
          float4 pw[G];
#pragma unroll
          for (int g = 0; g < G; ++g)
            pw[g] = *reinterpret_cast<const float4*>(sp + g * kSlice + t0);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (t0 + u < n) {
              float vf[EP];
              load_f32<EP>(vt + (t0 + u) * D + lane * EP, vf);
#pragma unroll
              for (int g = 0; g < G; ++g) {
                const float pu = u == 0   ? pw[g].x
                                 : u == 1 ? pw[g].y
                                 : u == 2 ? pw[g].z
                                          : pw[g].w;
#pragma unroll
                for (int e = 0; e < EP; ++e) acc[g][e] += pu * vf[e];
              }
            }
          }
        }
      }
      __syncwarp();  // every lane is done with the slot and the weights
      if (lane == 0) sm90::mbar_arrive(sm90::smem_u32(bars + R + slot));
    }
  }

  // merge the warps' states (the ring is free: every stage was waited for)
  __syncthreads();
  float* mm = reinterpret_cast<float*>(smem);  // [W][G] m, [W][G] l
  float* ml = mm + W * G;
  float* msum = ml + W * G;                    // [G] sum_w l_w e_w
  float* mmax = msum + G;                      // [G] max_w m_w
  float* macc = mmax + G;                      // [W][G][D]
  if (warp < W) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        mm[warp * G + g] = m[g];
        ml[warp * G + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < EP; ++e)
        macc[(warp * G + g) * D + lane * EP + e] = acc[g][e];
    }
  }
  __syncthreads();

  const int grp = blockIdx.z * gridDim.y + blockIdx.y;
  const size_t unit = static_cast<size_t>(grp) * a.n_splits + split;
  float* ws_acc = a.ws;
  float* ws_ml = a.ws + static_cast<size_t>(gridDim.z) * gridDim.y *
                            a.n_splits * G * D;
  T* ob = static_cast<T*>(a.out) + (static_cast<size_t>(b) * q_heads +
                                    static_cast<size_t>(h) * a.group + g0) *
                                       D;
  // each warp's weight e_w = exp(m_w - max m), and sum_w l_w e_w, a query
  // a thread, in place of m and l
  if (tid < ng) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, mm[w * G + tid]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float e = expf(mm[w * G + tid] - mx);
      sum += ml[w * G + tid] * e;
      mm[w * G + tid] = e;
    }
    msum[tid] = sum;
    mmax[tid] = mx;
  }
  __syncthreads();
  for (int idx = tid; idx < ng * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    const float sum = msum[g];
    const float mx = mmax[g];
    float val = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w)
      val += macc[(w * G + g) * D + d] * mm[w * G + g];
    if (n_live == 1) {
      ob[idx] = from_f32<T>(sum == 0.f ? 0.f : val / sum);
    } else {
      ws_acc[(unit * G + g) * D + d] = val;
      if (d == 0) {
        ws_ml[(unit * G + g) * 2] = mx;
        ws_ml[(unit * G + g) * 2 + 1] = sum;
      }
    }
  }
  if (n_live == 1) return;

  // the last live unit of (row, kv head, chunk) combines in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned t = atomicAdd(&g_tickets[grp], 1u);
    *sflag = t == static_cast<unsigned>(n_live - 1);
  }
  __syncthreads();
  if (!*sflag) return;
  __threadfence();
  // the weights e_s = exp(m_s - max m) and l_s e_s of every live split in
  // shared memory (a warp a query, its lanes over the splits), the
  // normalisers summed in split order, then each thread 4 columns of acc,
  // the splits in order with 8 loads in flight
  const size_t first = static_cast<size_t>(grp) * a.n_splits;
  float* cw = reinterpret_cast<float*>(smem);  // [n_live][G] e_s
  float* ce = cw + kMaxSplits * G;             // [n_live][G] l_s e_s
  float* cl = ce + kMaxSplits * G;             // [G] the normalisers
  for (int g = warp; g < ng; g += W + 1) {
    float mx = kNegInf;
    for (int s = lane; s < n_live; s += 32)
      mx = fmaxf(mx, __ldcg(ws_ml + ((first + s) * G + g) * 2));
    mx = warp_max(mx);
    for (int s = lane; s < n_live; s += 32) {
      const float e = expf(__ldcg(ws_ml + ((first + s) * G + g) * 2) - mx);
      cw[s * G + g] = e;
      ce[s * G + g] = __ldcg(ws_ml + ((first + s) * G + g) * 2 + 1) * e;
    }
  }
  __syncthreads();
  if (tid < ng) {
    float sum = 0.f;
    for (int s = 0; s < n_live; ++s) sum += ce[s * G + tid];
    cl[tid] = sum;
  }
  __syncthreads();
  for (int idx = tid; idx < ng * (D / 4); idx += kThreads) {
    const int g = idx / (D / 4);
    const int d = idx % (D / 4) * 4;
    const float* src = ws_acc + (first * G + g) * D + d;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    int s = 0;
    for (; s + 8 <= n_live; s += 8) {
      float4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        x[u] = __ldcg(reinterpret_cast<const float4*>(
            src + static_cast<size_t>(s + u) * G * D));
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float e = cw[(s + u) * G + g];
        v[0] += x[u].x * e;
        v[1] += x[u].y * e;
        v[2] += x[u].z * e;
        v[3] += x[u].w * e;
      }
    }
    for (; s < n_live; ++s) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          src + static_cast<size_t>(s) * G * D));
      const float e = cw[s * G + g];
      v[0] += x.x * e;
      v[1] += x.y * e;
      v[2] += x.z * e;
      v[3] += x.w * e;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) ob[g * D + d + i] = from_f32<T>(v[i] / cl[g]);
  }
  if (tid == 0) g_tickets[grp] = 0;
}

template <typename T, typename P, int D, int G, int R, int W>
cudaError_t launch(const Args& a, int batch, int kv_heads,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<P, D, G, R, W>();
  auto kernel = paged_decode_kernel<T, P, D, G, R, W>;
  static const cudaError_t status = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (status != cudaSuccess) return status;
  const int chunks = (a.group + G - 1) / G;
  kernel<<<dim3(a.n_splits, kv_heads * chunks, batch), (W + 1) * 32, smem,
           stream>>>(a);
  return cudaGetLastError();
}

// the per-page entries: 32-token slots and a consumer warp a slot, 2 of
// them (3 over int8 pages), 4 at the 8-query bucket where they fit in
// 128 KB (measured on the H100: small blocks, several an SM, beat 4-slot
// blocks at 1-4 queries a unit; the tensor-core bucket keeps 4 warps busy)
template <typename T, typename P, int D, int G>
cudaError_t launch_page(const Args& a, int batch, int kv_heads,
                        cudaStream_t s) {
  constexpr bool kQuant = sizeof(P) == 1;
  constexpr int kB = Slot<P, D, kQuant>::kBytes;
  constexpr int kR = G == kMaxGroup && 4 * kB <= 128 * 1024 ? 4
                     : sizeof(P) == 1                        ? 3
                                                             : 2;
  constexpr int kW = kR;
  return launch<T, P, D, G, kR, kW>(a, batch, kv_heads, s);
}

// the smallest bucket that holds the group, else chunks of kMaxGroup
template <typename T, typename P, int D>
cudaError_t launch_group(const Args& a, int batch, int kv_heads,
                         cudaStream_t s) {
  if (a.group <= 1) return launch_page<T, P, D, 1>(a, batch, kv_heads, s);
  if (a.group <= 2) return launch_page<T, P, D, 2>(a, batch, kv_heads, s);
  if (a.group <= 4) return launch_page<T, P, D, 4>(a, batch, kv_heads, s);
  return launch_page<T, P, D, kMaxGroup>(a, batch, kv_heads, s);
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
    case 256:
      return launch_group<T, P, 256>(a, batch, kv_heads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int bucket_of(int group) {
  return group <= 1 ? 1 : group <= 2 ? 2 : group <= 4 ? 4 : kMaxGroup;
}

// the split, grid and workspace agree with what the wrapper planned
bool plan_ok(const Args& a, int batch, int kv_heads, int head_dim,
             long long ws_floats) {
  // every page of the table in exactly n_splits splits: too many leave a
  // split empty, too few a live unit without a block (its ticket would
  // never close)
  const long long pps = a.pages_per_seq > 0 ? a.pages_per_seq : 1;
  if (a.group < 1 || a.page_size < 1 || kv_heads < 1 || a.split_pages < 1 ||
      a.n_splits < 1 || a.n_splits > kMaxSplits || a.pages_per_seq < 0 ||
      static_cast<long long>(a.n_splits - 1) * a.split_pages >= pps ||
      static_cast<long long>(a.n_splits) * a.split_pages < pps)
    return false;
  const int chunks = (a.group + kMaxGroup - 1) / kMaxGroup;
  const long long groups = static_cast<long long>(batch) * kv_heads * chunks;
  if (groups > kMaxTickets || kv_heads * chunks > 65535 || batch > 65535)
    return false;
  const long long need = a.n_splits == 1 ? 0
                                         : groups * a.n_splits *
                                               bucket_of(a.group) *
                                               (head_dim + 2);
  return ws_floats >= need && (need == 0 || a.ws != nullptr);
}

// q/out of T (is_bf16: bfloat16, else float32), pages of P
template <bool kQuant>
int decode(const Args& a, int batch, int kv_heads, int head_dim, int is_bf16,
           long long ws_floats, void* stream) {
  if (batch <= 0) return 0;
  if (!plan_ok(a, batch, kv_heads, head_dim, ws_floats))
    return static_cast<int>(cudaErrorInvalidValue);
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

// the grouped entry's contract: 16-token pages, head_dim 128, tables a
// multiple of 8 pages wide
constexpr int kGPage = 16;
constexpr int kGD = 128;
constexpr int kGroupPages = 8;

Args make_args(const void* q, const void* k_pages, const void* v_pages,
               const void* k_scales, const void* v_scales,
               const void* block_tables, const void* context_lens, void* out,
               void* ws, int group, int n_pages, int page_size,
               int pages_per_seq, int split_pages, int n_splits,
               float scale) {
  return Args{q,
              k_pages,
              v_pages,
              static_cast<const float*>(k_scales),
              static_cast<const float*>(v_scales),
              static_cast<const int*>(block_tables),
              static_cast<const int*>(context_lens),
              out,
              static_cast<float*>(ws),
              n_pages,
              page_size,
              pages_per_seq,
              group,
              split_pages,
              n_splits,
              scale};
}

}  // namespace

// Decode attention over paged K/V (layouts above); all tensors contiguous,
// q/pages/out of one dtype (is_bf16: bfloat16, else float32), head_dim 32,
// 64, 128 or 256, group >= 1, page_size >= 1. The context is cut into
// n_splits splits of split_pages pages (`paged_attention.split_plan`); ws
// holds ws_floats f32 (the partials; none needed where n_splits is 1).
// Launches one kernel on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int paged_attention_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* context_lens, void* out, void* ws,
    long long ws_floats, int batch, int kv_heads, int group, int n_pages,
    int page_size, int pages_per_seq, int head_dim, int split_pages,
    int n_splits, float scale, int is_bf16, void* stream) {
  const Args a = make_args(q, k_pages, v_pages, nullptr, nullptr,
                           block_tables, context_lens, out, ws, group,
                           n_pages, page_size, pages_per_seq, split_pages,
                           n_splits, scale);
  return decode<false>(a, batch, kv_heads, head_dim, is_bf16, ws_floats,
                       stream);
}

// The same over int8 pages with their f32 scales [kv_heads, n_pages,
// page_size]; q and out float32 or bfloat16 (is_bf16).
extern "C" int paged_attention_decode_q8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* context_lens, void* out, void* ws, long long ws_floats,
    int batch, int kv_heads, int group, int n_pages, int page_size,
    int pages_per_seq, int head_dim, int split_pages, int n_splits,
    float scale, int is_bf16, void* stream) {
  const Args a = make_args(q, k_pages, v_pages, k_scales, v_scales,
                           block_tables, context_lens, out, ws, group,
                           n_pages, page_size, pages_per_seq, split_pages,
                           n_splits, scale);
  return decode<true>(a, batch, kv_heads, head_dim, is_bf16, ws_floats,
                      stream);
}

// The grouped-fetch decode (layouts as paged_attention_decode) over float
// pages of q's dtype: page_size 16, head_dim 128, pages_per_seq a multiple
// of 8, group >= 1; the plan as paged_attention_decode's. Launches the
// per-page entry's kernel on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int paged_attention_decode_grouped(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* context_lens, void* out, void* ws,
    long long ws_floats, int batch, int kv_heads, int group, int n_pages,
    int page_size, int pages_per_seq, int head_dim, int split_pages,
    int n_splits, float scale, int is_bf16, void* stream) {
  if (page_size != kGPage || head_dim != kGD || pages_per_seq < 1 ||
      pages_per_seq % kGroupPages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return paged_attention_decode(q, k_pages, v_pages, block_tables,
                                context_lens, out, ws, ws_floats, batch,
                                kv_heads, group, n_pages, page_size,
                                pages_per_seq, head_dim, split_pages,
                                n_splits, scale, is_bf16, stream);
}
