// The matmul at decode (m <= 16 rows of x, bf16) for NVIDIA Hopper
// (sm_90a): y[m, n] = x[m, k] @ W[k, n], W stored as bf16, int8 or
// nibble-packed int4 with f32 scales (the weight type is the Traits
// parameter; quant_matmul.cu and matmul.cu instantiate it).
//
// Bound on the H100: the weight bytes (each is read once for at most 16
// multiply-adds; 5120 x 5120 int8 is 26.2 MB, 7.8 us at 3.35 TB/s). The
// card keeps ~3.35 TB/s x ~1 us / 132 SMs = 25 KB in flight per SM, so each
// SM must stream its share of the weight without gaps, in one launch.
//
// Design:
// - One launch per call. The weight is cut into column tiles of 128
//   columns and each tile's k rows into stages of 128 rows (16 KB of
//   int8). The (column tile, stage) units are numbered column tile by
//   column tile, k fastest, and block b of the grid's G walks units
//   [b U / G, (b+1) U / G). With G = tiles_n * s (the host's default: s the
//   SMs over the column tiles) every column tile is s equal k splits, and
//   the blocks of one split read the same weight rows at the same time
//   (measured on the H100: 132 blocks of staggered ranges were 10-15 %
//   slower than 120 or 108 of aligned ones). Any G up to U works; a
//   block's range may run across the end of one column tile into the next
//   (n / 128 above the SMs). A run of units in one column tile is a
//   segment.
// - Streaming. Warp 8, one lane, keeps a ring of kStages stages in flight
//   by TMA (cp.async.bulk.tensor, no swizzle): a stage is the weight tile
//   (128 k rows of 128 columns), the matching 128 columns of x's rows (rows
//   past m zero-filled by the copy) and the stage's scale rows, each
//   completing one mbarrier by transaction bytes. Rows past k (k % 128 ==
//   64) are zero-filled too. At least 64 KB are in flight per SM.
// - Products in registers. The weight is the 16-row operand of mma.sync
//   m16n8k16 and x the n8 side (y^T = W^T x^T): the <= 16 rows of x fill
//   one or two n8 tiles, where a 16-row x tile would waste half its rows
//   at m = 8. Warp w takes k rows 16 w .. 16 w + 15 of each stage. Within
//   a k16 step the order of k is free as long as both operands agree, so
//   thread (g = lane / 4, t = lane % 4) takes the 4 consecutive k rows
//   4t .. 4t+3 of its 16 columns: it reads them with 16-byte shared loads,
//   dequantizes in registers with the exact conversions of quant_matmul.cu
//   (bf16(q) x bf16(s), one rounding), and pairs rows (4t, 4t+1) and
//   (4t+2, 4t+3) of one column into the A fragment's k slots (2t, 2t+1)
//   and (2t+8, 2t+9) by byte permutes; its x fragment is then x[g][4t ..
//   4t+3], one 8-byte load. Its 16 columns are the rows g and g+8 of 8 m16
//   tiles. No weight tile is written back to shared memory and no block
//   barrier runs per stage: each warp releases the stage by one mbarrier
//   arrive. (A cheaper exact int8 conversion, 2.5 instructions a weight
//   instead of 3.75, measured no faster on the H100, and int4 weights,
//   half the bytes, run only ~10 % faster than int8: neither the bytes nor
//   the per-weight work alone paces the kernel.)
// - Reduction in the same launch. At the end of a segment the 8 warps add
//   their f32 sums in warp order through shared memory. A column tile that
//   one block covers whole is written at once. Otherwise each segment's
//   sums go to a partial slot in device memory; after a fence, the block
//   takes the column tile's ticket, and the last block of the tile to take
//   it adds the tile's partials in block order (= k order), rounds once to
//   bf16, writes y and resets the ticket to 0, so the launch leaves the
//   tickets as it found them (safe to replay in a CUDA graph). Sums are in
//   a fixed order for a given grid: two calls are bitwise equal. Launches
//   of one library must not overlap on one device (they share the
//   tickets).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace skinny {

constexpr int kBN = 128;     // output columns of a column tile
constexpr int kBK = 128;     // k rows of a stage, 16 per compute warp
constexpr int kWarps = 8;    // compute warps
constexpr int kThreads = 32 * (kWarps + 1);  // and the loader warp
constexpr int kMaxTiles = 1 << 16;  // tickets: n / 128 column tiles at most

struct Args {
  __nv_bfloat16* out;  // [m, n]
  float* part;         // [grid + tiles_n, NT * 1024] f32 partials
  unsigned* tickets;   // [tiles_n], 0 between launches
  int m, n, kt, tiles_n;
  int group_rows;      // k rows of a scale group
  int scale_rows;      // scale rows a stage's box holds (2 for groups of 64)
  long long units;     // tiles_n * kt
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// the A fragment of one m16 tile from four k rows' bf16 pairs of its two
// columns (r[i]: k row 4t + i, low half the tile's row g, high half g + 8)
__device__ __forceinline__ void pair_rows(uint32_t r0, uint32_t r1,
                                          uint32_t r2, uint32_t r3,
                                          uint32_t (&a)[4]) {
  a[0] = __byte_perm(r0, r1, 0x5410);  // row g: k slots 2t, 2t+1
  a[1] = __byte_perm(r0, r1, 0x7632);  // row g+8
  a[2] = __byte_perm(r2, r3, 0x5410);  // row g: k slots 2t+8, 2t+9
  a[3] = __byte_perm(r2, r3, 0x7632);  // row g+8
}

__device__ __forceinline__ unsigned owner(long long u, long long units,
                                          int grid) {
  return static_cast<unsigned>(((u + 1) * grid - 1) / units);
}

// Traits of a weight type: kElt (bytes of a stored element; int4: a byte
// of two k rows), kKPer (k rows a stored row holds: 2 for int4, else 1),
// kStages, kScaled; col(g, i) (the tile's column of the thread's i-th
// column, i < 16); frags(p, g, t, sp, a[8][4]) (the A fragments of the
// warp's 8 m16 tiles from its 16 k rows, p its first stored row, sp[j] the
// bf16 scales of the thread's columns 2j and 2j + 1; tile j's rows g and
// g + 8 are those two columns).
template <class Tr, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    skinny_kernel(const __grid_constant__ CUtensorMap tmw,
                  const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tms, const Args a) {
  constexpr int kRowBytes = kBN * Tr::kElt;
  constexpr int kWBytes = kBK / Tr::kKPer * kRowBytes;
  constexpr int kXBytes = NT * 8 * kBK * 2;
  constexpr int kSBytes = Tr::kScaled ? 2 * kBN * 4 : 0;
  constexpr int kStage = kWBytes + kXBytes + kSBytes;
  constexpr int S = Tr::kStages;
  constexpr int E = NT * 32;  // accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ int last_flag;
  const uint32_t base = (sm90::smem_u32(smem_raw) + 127) & ~127u;
  unsigned char* ring = smem_raw + (base - sm90::smem_u32(smem_raw));
  float* red = reinterpret_cast<float*>(ring + S * kStage);  // [8][E * 32]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      sm90::mbar_init(sm90::smem_u32(&full[i]), 1);
      sm90::mbar_init(sm90::smem_u32(&empty[i]), kWarps);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int grid = gridDim.x, b = blockIdx.x;
  const long long u0 = b * a.units / grid, u1 = (b + 1) * a.units / grid;
  const int kt = a.kt;
  if (warp == kWarps) {
    // ---- loader: one lane streams the block's stages ----
    if (lane != 0) return;
    int c = static_cast<int>(u0 / kt), kk = static_cast<int>(u0 % kt);
    const int bytes = kWBytes + kXBytes +
                      (Tr::kScaled ? a.scale_rows * kBN * 4 : 0);
    int st = 0;
    uint32_t phase = 0;
    for (long long u = u0; u < u1; ++u) {
      if (u - u0 >= S) sm90::mbar_wait(sm90::smem_u32(&empty[st]), phase ^ 1);
      const uint32_t bar = sm90::smem_u32(&full[st]);
      const uint32_t dst = base + st * kStage;
      sm90::mbar_expect_tx(bar, bytes);
      sm90::tma_2d(dst, &tmw, c * kBN, kk * (kBK / Tr::kKPer), bar);
      sm90::tma_2d(dst + kWBytes, &tmx, kk * kBK, 0, bar);
      if (Tr::kScaled)  // one division a stage (16 KB of int8)
        sm90::tma_2d(dst + kWBytes + kXBytes, &tms, c * kBN,
                     kk * kBK / a.group_rows, bar);
      if (++kk == kt) {
        kk = 0;
        ++c;
      }
      if (++st == S) {
        st = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- the 8 compute warps ----
  const int g = lane >> 2, t = lane & 3;
  float acc[NT][8][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // this warp's scale row within a stage's scale box
  const int srow = a.scale_rows == 2 ? warp * 16 / a.group_rows : 0;

  int c = static_cast<int>(u0 / kt), kk = static_cast<int>(u0 % kt);
  int st = 0;
  uint32_t phase = 0;
  for (long long u = u0; u < u1; ++u) {
    sm90::mbar_wait(sm90::smem_u32(&full[st]), phase);
    const unsigned char* wst = ring + st * kStage;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(wst + kWBytes);
    __nv_bfloat162 sp[8];
    if constexpr (Tr::kScaled) {
      const float* ss = reinterpret_cast<const float*>(wst + kWBytes +
                                                       kXBytes) +
                        srow * kBN;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sp[j] = __floats2bfloat162_rn(ss[Tr::col(g, 2 * j)],
                                      ss[Tr::col(g, 2 * j + 1)]);
    }
    uint32_t af[8][4];
    Tr::frags(wst + warp * (16 / Tr::kKPer) * kRowBytes, g, t, sp, af);
    uint2 bx[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i)
      bx[i] = *reinterpret_cast<const uint2*>(xs + (8 * i + g) * kBK +
                                              16 * warp + 4 * t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < NT; ++i) mma_bf16(acc[i][j], af[j], bx[i]);
    // the products have read every register loaded from the stage
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(sm90::smem_u32(&empty[st]));

    if (kk == kt - 1 || u == u1 - 1) {
      // ---- end of a segment of column tile c: the warps' sums in warp
      // order, then the tile's segments in block order ----
      float* mine = red + warp * (E * 32);
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mine[((i * 8 + j) * 4 + e) * 32 + lane] = acc[i][j][e];
            acc[i][j][e] = 0.f;
          }
      sm90::named_sync(1, kWarps * 32);
      constexpr int kPer = E * 32 / (kWarps * 32);
      float v[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int idx = tid + q * kWarps * 32;
        float s = red[idx];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += red[w * (E * 32) + idx];
        v[q] = s;
      }
      const long long first_unit = static_cast<long long>(c) * kt;
      const unsigned b_first = owner(first_unit, a.units, grid);
      const unsigned b_last = owner(first_unit + kt - 1, a.units, grid);
      // element idx of a segment: accumulator (i, j, e) = idx / 32 of
      // lane idx % 32 -> (column, row of y)
      auto store = [&](int idx, float s) {
        const int f = idx >> 5, ln = idx & 31;
        const int e = f & 3, j = (f >> 2) & 7, i = f >> 5;
        const int row = 8 * i + 2 * (ln & 3) + (e & 1);
        if (row < a.m)
          a.out[static_cast<size_t>(row) * a.n + c * kBN +
                Tr::col(ln >> 2, 2 * j + (e >> 1))] = __float2bfloat16_rn(s);
      };
      if (b_first == b_last) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) store(tid + q * kWarps * 32, v[q]);
      } else {
        float* slot = a.part + static_cast<size_t>(b + c) * (E * 32);
#pragma unroll
        for (int q = 0; q < kPer; ++q) slot[tid + q * kWarps * 32] = v[q];
        __threadfence();
        sm90::named_sync(1, kWarps * 32);
        if (tid == 0)
          last_flag = atomicAdd(&a.tickets[c], 1u) == b_last - b_first;
        sm90::named_sync(1, kWarps * 32);
        if (last_flag) {
          __threadfence();
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const int idx = tid + q * kWarps * 32;
            float s = 0.f;
            for (unsigned bb = b_first; bb <= b_last; ++bb)
              s += __ldcg(a.part + static_cast<size_t>(bb + c) * (E * 32) +
                          idx);
            store(idx, s);
          }
          if (tid == 0) a.tickets[c] = 0;
        }
      }
      sm90::named_sync(1, kWarps * 32);  // red and last_flag free again
    }
    if (++kk == kt) {
      kk = 0;
      ++c;
    }
    if (++st == S) {
      st = 0;
      phase ^= 1;
    }
  }
}

template <class Tr, int NT>
constexpr int smem_bytes() {
  return 128 /* alignment slack */ +
         Tr::kStages * (kBK / Tr::kKPer * kBN * Tr::kElt + NT * 8 * kBK * 2 +
                        (Tr::kScaled ? 2 * kBN * 4 : 0)) +
         kWarps * NT * 32 * 32 * 4;
}

// Launches the kernel: x [m, k] bf16 (1 <= m <= 16), w the weight's
// storage ([k / kKPer, n] of kElt bytes, TMA type `wtype`), s the scales
// ([k / group_rows, n] f32; unused where unscaled), `grid` blocks (1 ..
// the stages, shape_ok). part: [grid + n / 128, NT * 1024] f32 scratch.
template <class Tr, int NT>
cudaError_t launch_nt(CUtensorMapDataType wtype, const void* x,
                      const void* w, const float* s, __nv_bfloat16* out,
                      float* part, unsigned* tickets, int m, int k, int n,
                      int group_rows, int grid, cudaStream_t st) {
  CUtensorMap tmx, tmw, tms;
  const int scale_rows = Tr::kScaled && group_rows < kBK && k > 64 ? 2 : 1;
  if (!sm90::make_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, k,
                      NT * 8, kBK, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !sm90::make_map(&tmw, wtype, Tr::kElt, w, k / Tr::kKPer, n,
                      kBK / Tr::kKPer, kBN, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  if (Tr::kScaled &&
      !sm90::make_map(&tms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, s,
                      k / group_rows, n, scale_rows, kBN,
                      CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<Tr, NT>();
  static cudaError_t allowed = cudaFuncSetAttribute(
      skinny_kernel<Tr, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (allowed != cudaSuccess) return allowed;
  Args a;
  a.out = out;
  a.part = part;
  a.tickets = tickets;
  a.m = m;
  a.n = n;
  a.kt = (k + kBK - 1) / kBK;
  a.tiles_n = n / kBN;
  a.group_rows = group_rows;
  a.scale_rows = scale_rows;
  a.units = static_cast<long long>(a.tiles_n) * a.kt;
  skinny_kernel<Tr, NT><<<grid, kThreads, smem, st>>>(
      tmw, tmx, Tr::kScaled ? tms : tmw, a);
  return cudaGetLastError();
}

// one n8 tile of x's rows for m <= 8, two for m <= 16
template <class Tr>
cudaError_t launch(CUtensorMapDataType wtype, const void* x, const void* w,
                   const float* s, __nv_bfloat16* out, float* part,
                   unsigned* tickets, int m, int k, int n, int group_rows,
                   int grid, cudaStream_t st) {
  return m <= 8 ? launch_nt<Tr, 1>(wtype, x, w, s, out, part, tickets, m, k,
                                   n, group_rows, grid, st)
                : launch_nt<Tr, 2>(wtype, x, w, s, out, part, tickets, m, k,
                                   n, group_rows, grid, st);
}

// checks shared by the entry points: m in 1..16, k % 64, n % 128, a grid
// of 1 .. units blocks, at most kMaxTiles column tiles
inline bool shape_ok(int m, int k, int n, int grid) {
  if (m < 1 || m > 16 || k <= 0 || k % 64 || n <= 0 || n % kBN ||
      n / kBN > kMaxTiles || grid < 1)
    return false;
  const long long units =
      static_cast<long long>(n / kBN) * ((k + kBK - 1) / kBK);
  return grid <= units;
}

}  // namespace skinny
