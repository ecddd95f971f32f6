// Dense matmul for NVIDIA Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/matmul.py::_fused_call (the Pallas body
// `_mm_kernel`). y[m, n] = x[m, k] @ w[k, n] with
//   x   [m, k]  bfloat16 or float32, row-major
//   w   [k, n]  x's dtype, row-major (Paddle's [in, out] weight layout)
//   y   [m, n]  in x's dtype, summed in f32 and rounded once at the store.
//
// Bound on the H100: bytes at decode (m = 8: each weight element is read
// once for 8 multiply-adds; 4096 x 4096 bf16 is 33.6 MB, 10 us at
// 3.35 TB/s), operations at prefill and training (m in the thousands:
// 2mkn flops of bf16 products at 989 TFLOP/s).
//
// Four kernels, named by the host's variants (matmul.py `variants`):
//
// bf16, "128x256" and "128x128" (gemm_wgmma_kernel<BN>; any m, the default
// at m > 16): a persistent, warp-specialized kernel, one block of three
// warpgroups per SM walking 128 x BN output tiles in the band order of
// sm90::tile_of (bands of group_m row tiles, row tiles fastest, so that a
// band of x stays in the 50 MB L2 while the weight columns stream past
// it). Warpgroup 0 loads: one thread keeps a ring of kStages stages in
// flight by TMA (cp.async.bulk.tensor), each the 128 x 64 x tile (K-major,
// 128-byte swizzle, rows past m zero-filled by the copy) and the 64 x BN
// weight tile in the layout it is stored in (N-major: BN / 64 boxes of 64
// columns, each a 128-byte swizzled atom of 8 KB), completing one mbarrier
// by transaction bytes; weight atoms wholly past n (n % 256 == 128 at BN
// 256) are not loaded, and their columns are never stored. Warpgroups 1
// and 2 multiply: each owns 64 rows of the tile and keeps 64 x BN f32
// accumulators in registers (128 a thread at BN 256), and per k tile
// issues 4 asynchronous wgmma m64nBNk16 from shared memory, the weight
// read through the transpose bit, keeping one k tile's products in flight
// while it releases the stage before. No block-wide barrier runs in the
// mainloop; setmaxnreg moves registers from the loaders to the consumers.
// The epilogue rounds once to bf16 and stores through shared memory in
// 64-column chunks with 16-byte stores, rows past m and columns past n
// masked, while the loader already fills the ring for the next tile. The
// last round of tiles is not split (512 tiles of 128 x 256 at 4096 x 4096
// are 3.88 rounds on 132 SMs).
//
// bf16, "skinny" (m <= 16, the default there): the one-launch streaming
// decode kernel of skinny_matmul.cuh with bf16 weights (Bf16W below).
//
// bf16 "m16" and float32 "m16" / "m64" (matmul_kernel): one block of 8
// warps per (128-column tile, BM-row tile, k split). The block walks its k
// tiles (BK rows of w, BK columns of x) through a ring of kStages
// shared-memory stages filled by cp.async, so kStages - 1 tiles are in
// flight while the block multiplies the current one. Rows of x at or past
// m are zero-filled by the copy, and their outputs are not stored.
//   bf16 (BM = 16, decode's m of 1-16): WMMA 16x16x16 bf16 products with
//     f32 accumulators (8 warps of 16x16), BK = 64; the results go to
//     shared memory and out as bf16, rounded once.
//   f32: CUDA-core FMA in f32 (each thread a BM/16-row by 8-column patch),
//     BM = 16 or 64, BK = 32: exact f32 products, no TF32.
// At small m the n / 128 column tiles alone leave most of the 132 SMs
// idle, so the host splits k to fill one wave of resident blocks: each
// split writes f32 partials and a second kernel sums them in split order
// and rounds once (deterministic, no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "skinny_matmul.cuh"
#include "sm90.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kBN = 128;  // output columns per block

struct Args {
  const void* x;
  const void* w;
  void* out;    // [m, n] when splits == 1
  float* part;  // [splits, m, n] f32 partials when splits > 1
  int m, k, n, splits;
};

template <typename T, int BM>
struct Cfg;

template <int BM>
struct Cfg<__nv_bfloat16, BM> {
  static constexpr int BK = 64;
  static constexpr int kPad = 8;  // WMMA: a multiple of 8 bf16 per row
  static constexpr int kStages = 4;
  static constexpr int kWarpsM = 1;  // BM = 16 only: decode
};

template <int BM>
struct Cfg<float, BM> {
  static constexpr int BK = 32;
  static constexpr int kPad = 4;
  static constexpr int kStages = 3;
};

template <typename T, int BM>
struct Tile {
  using C = Cfg<T, BM>;
  static constexpr int BK = C::BK;
  static constexpr int kStages = C::kStages;
  static constexpr int LDX = BK + C::kPad;      // x tile row stride
  static constexpr int LDW = kBN + C::kPad;     // w tile row stride
  static constexpr int LDC = kBN + 4;           // f32 result row stride
  static constexpr int kPer = 16 / sizeof(T);   // elements per 16 bytes
  static constexpr int kXChunks = BM * BK / kPer;
  static constexpr int kWChunks = BK * kBN / kPer;
  static constexpr int kXBytes = BM * LDX * sizeof(T);
  static constexpr int kWBytes = BK * LDW * sizeof(T);
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kCBytes = sizeof(T) == 2 ? BM * LDC * 4 : 0;
  static constexpr int kLoopBytes = kStages * kStageBytes;
  static constexpr int kSmem = kLoopBytes > kCBytes ? kLoopBytes : kCBytes;
};

// cp.async: 16-byte copies global -> shared that bypass registers; `bytes`
// below 16 zero-fills the rest (0: the whole chunk)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes = 16) {
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

__device__ __forceinline__ void store_out(__nv_bfloat16* d, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(d) = u;
}
__device__ __forceinline__ void store_out(float* d, float4 v) {
  *reinterpret_cast<float4*>(d) = v;
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads) matmul_kernel(Args a) {
  using Tl = Tile<T, BM>;
  constexpr int BK = Tl::BK;
  constexpr int S = Tl::kStages;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int k_tiles = a.k / BK;
  const int t_begin = static_cast<int>(
      static_cast<long long>(split) * k_tiles / a.splits);
  const int t_end = static_cast<int>(
      static_cast<long long>(split + 1) * k_tiles / a.splits);
  const int nt = t_end - t_begin;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w = static_cast<const T*>(a.w);

  auto stage_x = [&](int st) {
    return reinterpret_cast<T*>(smem + st * Tl::kStageBytes);
  };
  auto stage_w = [&](int st) {
    return reinterpret_cast<T*>(smem + st * Tl::kStageBytes + Tl::kXBytes);
  };

  // k tile t -> stage st, by cp.async
  auto issue = [&](int t, int st) {
    const int k0 = t * BK;
    T* xs = stage_x(st);
    for (int i = tid; i < Tl::kXChunks; i += kThreads) {
      const int r = i / (BK / Tl::kPer);
      const int c = (i % (BK / Tl::kPer)) * Tl::kPer;
      const bool in = m0 + r < a.m;
      cp_async16(xs + r * Tl::LDX + c,
                 in ? x + static_cast<size_t>(m0 + r) * a.k + k0 + c : x,
                 in ? 16 : 0);
    }
    T* ws = stage_w(st);
    for (int i = tid; i < Tl::kWChunks; i += kThreads) {
      const int r = i / (kBN / Tl::kPer);
      const int c = (i % (kBN / Tl::kPer)) * Tl::kPer;
      cp_async16(ws + r * Tl::LDW + c,
                 w + static_cast<size_t>(k0 + r) * a.n + n0 + c);
    }
  };

  // the ring: S - 1 tiles in flight ahead of the one being multiplied
  auto pipeline = [&](auto&& multiply) {
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      if (i < nt) issue(t_begin + i, i);
      cp_async_commit();
    }
    for (int i = 0; i < nt; ++i) {
      cp_async_wait<S - 2>();
      __syncthreads();  // tile i landed; every warp is past tile i - 1
      if (i + S - 1 < nt) issue(t_begin + i + S - 1, (i + S - 1) % S);
      cp_async_commit();
      multiply(stage_x(i % S), stage_w(i % S));
    }
    cp_async_wait<0>();
    __syncthreads();
  };

  if constexpr (sizeof(T) == 2) {
    // bf16: WMMA on the tensor cores
    constexpr int kWarpsM = Cfg<T, BM>::kWarpsM;
    constexpr int kWarpsN = 8 / kWarpsM;
    constexpr int FM = BM / 16 / kWarpsM;
    constexpr int FN = kBN / 16 / kWarpsN;
    const int warp = tid >> 5;
    const int wm = warp / kWarpsN;
    const int wn = warp % kWarpsN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i) {
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    }
    pipeline([&](const T* xs, const T* ws) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fa[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fb[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          wmma::load_matrix_sync(
              fa[i], xs + ((wm * FM + i) * 16) * Tl::LDX + kk, Tl::LDX);
        }
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::load_matrix_sync(
              fb[j], ws + kk * Tl::LDW + (wn * FN + j) * 16, Tl::LDW);
        }
#pragma unroll
        for (int i = 0; i < FM; ++i) {
#pragma unroll
          for (int j = 0; j < FN; ++j) {
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
          }
        }
      }
    });
    // the f32 results through shared memory (over the drained ring)
    float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < FM; ++i) {
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::store_matrix_sync(
            cs + ((wm * FM + i) * 16) * Tl::LDC + (wn * FN + j) * 16,
            acc[i][j], Tl::LDC, wmma::mem_row_major);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < BM * kBN / 4; idx += kThreads) {
      const int r = idx / (kBN / 4);
      const int c = (idx % (kBN / 4)) * 4;
      if (m0 + r >= a.m) continue;
      const float4 v = *reinterpret_cast<const float4*>(cs + r * Tl::LDC + c);
      const size_t o = static_cast<size_t>(m0 + r) * a.n + n0 + c;
      if (a.splits == 1) {
        store_out(static_cast<T*>(a.out) + o, v);
      } else {
        *reinterpret_cast<float4*>(
            a.part + static_cast<size_t>(split) * a.m * a.n + o) = v;
      }
    }
  } else {
    // f32: FMA on the CUDA cores; thread (ty, tx) owns rows ty*RM.. and
    // columns tx*8..tx*8+7 of the block's tile
    constexpr int RM = BM / 16;
    const int tx = tid % 16;
    const int ty = tid / 16;
    float acc[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    pipeline([&](const T* xs, const T* ws) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(ws + kk * Tl::LDW + tx * 8);
        const float4 b1 =
            *reinterpret_cast<const float4*>(ws + kk * Tl::LDW + tx * 8 + 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float av = xs[(ty * RM + i) * Tl::LDX + kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    });
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = m0 + ty * RM + i;
      if (row >= a.m) continue;
      const size_t o = static_cast<size_t>(row) * a.n + n0 + tx * 8;
      float* dst = a.splits == 1
                       ? static_cast<float*>(a.out) + o
                       : a.part + static_cast<size_t>(split) * a.m * a.n + o;
      reinterpret_cast<float4*>(dst)[0] =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      reinterpret_cast<float4*>(dst)[1] =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

// out[i] = sum over splits of part[split][i], in split order, rounded once
template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_sum_kernel(const float* __restrict__ part, T* __restrict__ out,
                     long long quads, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= quads) return;
  const float4* p = reinterpret_cast<const float4*>(part);
  float4 v = p[i];
  for (int z = 1; z < splits; ++z) {
    const float4 u = p[static_cast<long long>(z) * quads + i];
    v.x += u.x;
    v.y += u.y;
    v.z += u.z;
    v.w += u.w;
  }
  store_out(out + 4 * i, v);
}

// ---------------------------------------------------------------------------
// bf16: the persistent warp-specialized wgmma kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kGBM = 128;        // output rows per tile
constexpr int kGBK = 64;         // k per stage: one 128-byte x row
constexpr int kGThreads = 384;   // the loader and 2 consumer warpgroups
constexpr int kGXTile = kGBM * kGBK * 2;  // 16 KB, 128-byte swizzled rows
constexpr int kAtom = kGBK * 64 * 2;      // 8 KB: 64 k rows of 64 columns
constexpr int kGLdO = 64 + 8;             // epilogue staging row stride
constexpr int kGOTile = 64 * kGLdO * 2;   // one consumer's staging chunk

template <int BN>
struct GCfg {
  static constexpr int kStage = kGXTile + (BN / 64) * kAtom;
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kSmem = 1024 /* alignment slack */ +
                               kStages * kStage + 2 * kGOTile;
};

struct GArgs {
  bf16* out;
  int m, k, n, tiles_m, tiles_n, group_m;
};

// registers after the shift (setmaxnreg): the launch gives 168 a thread
// (384 threads, one block per SM); the loaders give up 128 and each
// consumer thread takes 64 of them (the 128 accumulators at BN 256)
constexpr int kGLoaderRegs = 40;
constexpr int kGConsumerRegs = 232;

template <int BN>
__global__ void __launch_bounds__(kGThreads, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                      const __grid_constant__ CUtensorMap tmw,
                      const GArgs a) {
  using C = GCfg<BN>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  bf16* g_out = reinterpret_cast<bf16*>(
      smem_raw + (base - sm90::smem_u32(smem_raw)) + S * C::kStage);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      sm90::mbar_init(sm90::smem_u32(&full[i]), 1);
      sm90::mbar_init(sm90::smem_u32(&empty[i]), 8);  // the consumer warps
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int k_tiles = a.k / kGBK;
  const int tiles = a.tiles_m * a.tiles_n;
  const int my_tiles =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto tile = [&](int u, int* tm, int* tn) {  // this block's u-th tile
    sm90::tile_of(blockIdx.x + u * gridDim.x, a.tiles_m, a.tiles_n,
                  a.group_m, tm, tn);
  };

  if (wg == 0) {
    // ---- loader: one thread keeps the ring of x and weight tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kGLoaderRegs));
    if (t == 0) {
      int st = 0;
      uint32_t phase = 0;
      for (int u = 0, it = 0; u < my_tiles; ++u) {
        int tm, tn;
        tile(u, &tm, &tn);
        // the 64-column weight atoms inside n (all of them but at an n
        // tail)
        const int atoms = min(BN / 64, (a.n - tn * BN) / 64);
        const int bytes = kGXTile + atoms * kAtom;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          if (it >= S)
            sm90::mbar_wait(sm90::smem_u32(&empty[st]), phase ^ 1);
          const uint32_t bar = sm90::smem_u32(&full[st]);
          const uint32_t dst = base + st * C::kStage;
          sm90::mbar_expect_tx(bar, bytes);
          sm90::tma_2d(dst, &tmx, kt * kGBK, tm * kGBM, bar);
          for (int at = 0; at < atoms; ++at)
            sm90::tma_2d(dst + kGXTile + at * kAtom, &tmw,
                         tn * BN + at * 64, kt * kGBK, bar);
          if (++st == S) {
            st = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 rows 0-63, warpgroup 2 rows 64-127 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kGConsumerRegs));
    const int w = wg - 1;
    const int warp = t >> 5, lane = t & 31;
    bf16* stg = g_out + w * (64 * kGLdO);
    auto release = [&](int s) {
      if (lane == 0) sm90::mbar_arrive(sm90::smem_u32(&empty[s]));
    };
    float d[BN / 2];
    int st = 0;
    uint32_t phase = 0;
    for (int u = 0; u < my_tiles; ++u) {
      int tm, tn;
      tile(u, &tm, &tn);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
      int prev = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        sm90::mbar_wait(sm90::smem_u32(&full[st]), phase);
        __syncwarp();
        sm90::wgmma_fence();
        const uint32_t xa = base + st * C::kStage + w * 64 * 128;
        const uint32_t wb = base + st * C::kStage + kGXTile;
#pragma unroll
        for (int kk = 0; kk < kGBK / 16; ++kk) {
          // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart,
          // each k16 step 32 bytes on; B: N-major, the 64-column atoms 8 KB
          // apart (leading), 8-row k groups 1024 apart (stride), each k16
          // step two groups on
          const uint64_t da = sm90::gmma_desc(xa + kk * 32, 16, 1024);
          const uint64_t db = sm90::gmma_desc(wb + kk * 2048, kAtom, 1024);
          if constexpr (BN == 256)
            sm90::wgmma_m64n256k16(d, da, db);
          else
            sm90::wgmma_m64n128k16(d, da, db);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // k tile kt - 1's products are done
        if (kt > 0) release(prev);
        prev = st;
        if (++st == S) {
          st = 0;
          phase ^= 1;
        }
      }
      sm90::wgmma_wait<0>();
      release(prev);
      // epilogue: 64-column chunks of bf16 pairs -> staging -> 16-byte
      // rows of y
      const int r0 = warp * 16 + (lane >> 2);
      const int row_base = tm * kGBM + w * 64;
#pragma unroll
      for (int h = 0; h < BN / 64; ++h) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * h + jj;
          const int col = 8 * jj + 2 * (lane & 3);
          *reinterpret_cast<__nv_bfloat162*>(stg + r0 * kGLdO + col) =
              __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
          *reinterpret_cast<__nv_bfloat162*>(stg + (r0 + 8) * kGLdO + col) =
              __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
        }
        sm90::named_sync(1 + w, 128);
        const int col0 = tn * BN + 64 * h;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int idx = t + 128 * i;
          const int r = idx >> 3, ch = idx & 7;
          if (row_base + r < a.m && col0 < a.n) {
            *reinterpret_cast<uint4*>(
                a.out + static_cast<size_t>(row_base + r) * a.n + col0 +
                ch * 8) =
                *reinterpret_cast<const uint4*>(stg + r * kGLdO + ch * 8);
          }
        }
        sm90::named_sync(1 + w, 128);  // the staging chunk is free again
      }
    }
  }
}

template <int BN>
cudaError_t launch_gemm(const void* x, const void* w, void* out, int m,
                        int k, int n, int grid, int group_m,
                        cudaStream_t st) {
  CUtensorMap tmx, tmw;
  if (!sm90::make_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, k,
                      kGBM, kGBK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !sm90::make_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, k, n,
                      kGBK, 64, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  static cudaError_t allowed = cudaFuncSetAttribute(
      gemm_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GCfg<BN>::kSmem);
  if (allowed != cudaSuccess) return allowed;
  const GArgs a{static_cast<bf16*>(out), m, k, n, (m + kGBM - 1) / kGBM,
                (n + BN - 1) / BN, group_m};
  gemm_wgmma_kernel<BN><<<grid, kGThreads, GCfg<BN>::kSmem, st>>>(tmx, tmw,
                                                                  a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 decode: skinny_matmul.cuh's kernel on bf16 weights
// ---------------------------------------------------------------------------

// thread (g, t) reads stored rows 4t .. 4t + 3 of its warp's 16, columns
// 8 g .. 8 g + 7 and 64 + 8 g .. + 7 (16 bytes each, so that 8 lanes read
// one row's 128 bytes)
struct Bf16W {
  static constexpr int kElt = 2;
  static constexpr int kKPer = 1;
  static constexpr int kStages = 4;
  static constexpr bool kScaled = false;
  __device__ static int col(int g, int i) {
    return i < 8 ? 8 * g + i : 64 + 8 * g + (i - 8);
  }
  __device__ static void frags(const unsigned char* p, int g, int t,
                               const __nv_bfloat162*, uint32_t (&a)[8][4]) {
    constexpr int kRow = skinny::kBN * 2;
    p += 4 * t * kRow + 16 * g;
    uint32_t w[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint4 lo = *reinterpret_cast<const uint4*>(p + r * kRow);
      const uint4 hi = *reinterpret_cast<const uint4*>(p + r * kRow + 128);
      w[r][0] = lo.x;
      w[r][1] = lo.y;
      w[r][2] = lo.z;
      w[r][3] = lo.w;
      w[r][4] = hi.x;
      w[r][5] = hi.y;
      w[r][6] = hi.z;
      w[r][7] = hi.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      skinny::pair_rows(w[0][j], w[1][j], w[2][j], w[3][j], a[j]);
  }
};

// the column tiles' tickets of the decode kernel: 0 between launches
__device__ unsigned g_tickets[skinny::kMaxTiles];

// the kernel for (T, BM), its dynamic shared memory allowed once
template <typename T, int BM>
cudaError_t prepare(void (**fn)(Args), int* smem, int* bk) {
  static cudaError_t status = cudaFuncSetAttribute(
      matmul_kernel<T, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<T, BM>::kSmem);
  *fn = matmul_kernel<T, BM>;
  *smem = Tile<T, BM>::kSmem;
  *bk = Tile<T, BM>::BK;
  return status;
}

// row tiles: bf16 16; f32 16, 64
cudaError_t select(int tile, int is_bf16, void (**fn)(Args), int* smem,
                   int* bk) {
  if (is_bf16) {
    if (tile != 16) return cudaErrorInvalidValue;
    return prepare<__nv_bfloat16, 16>(fn, smem, bk);
  }
  switch (tile) {
    case 16:
      return prepare<float, 16>(fn, smem, bk);
    case 64:
      return prepare<float, 64>(fn, smem, bk);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Blocks of the kernel with row tile `tile` that one SM holds at once (the
// host sizes its k split from this), or -1 on a CUDA error.
extern "C" int matmul_blocks_per_sm(int tile, int is_bf16) {
  void (*fn)(Args) = nullptr;
  int smem = 0, bk = 0, blocks = 0;
  if (select(tile, is_bf16, &fn, &smem, &bk) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                    smem) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

// y = x @ w (layouts above); all pointers 16-byte aligned and contiguous;
// n % 128 == 0, k a multiple of the k tile (64 bf16, 32 f32), row tile
// `tile` (bf16: 16; f32: 16, 64), 1 <= splits <= k / k tile (part:
// [splits, m, n] f32 scratch when splits > 1, else unused). is_bf16: x, w
// and y bfloat16, else float32. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int matmul(const void* x, const void* w, void* out, void* part,
                      int m, int k, int n, int tile, int splits, int is_bf16,
                      void* stream) {
  void (*fn)(Args) = nullptr;
  int smem = 0, bk = 0;
  cudaError_t e = select(tile, is_bf16, &fn, &smem, &bk);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (m < 0 || k <= 0 || n <= 0 || k % bk || n % kBN || splits < 1 ||
      splits > k / bk || (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  const Args a{x, w, out, static_cast<float*>(part), m, k, n, splits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n / kBN, (m + tile - 1) / tile, splits);
  fn<<<grid, kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long long quads = static_cast<long long>(m) * n / 4;
  const unsigned blocks =
      static_cast<unsigned>((quads + kThreads - 1) / kThreads);
  if (is_bf16) {
    split_sum_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        a.part, static_cast<__nv_bfloat16*>(out), quads, splits);
  } else {
    split_sum_kernel<float><<<blocks, kThreads, 0, st>>>(
        a.part, static_cast<float*>(out), quads, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// The wgmma kernel: y = x @ w for bf16 x, w and y; m >= 1, k % 64 == 0, n %
// 128 == 0, 16-byte aligned contiguous arrays; bn 256 or 128 (the output
// tile's columns); `grid` persistent blocks (at most one per SM is
// resident) walk the ceil(m / 128) x ceil(n / bn) output tiles in bands of
// `group_m` row tiles (matmul.py's `band_schedule`). Launches on `stream`
// and returns cudaGetLastError() (0 on success; cudaErrorInvalidValue also
// where the CUDA tensor-map encoder is missing or refuses the arrays).
extern "C" int matmul_wgmma(const void* x, const void* w, void* out, int m,
                            int k, int n, int bn, int grid, int group_m,
                            void* stream) {
  if (m < 1 || k <= 0 || n <= 0 || k % kGBK || n % 128 || grid < 1 ||
      group_m < 1 || (bn != 256 && bn != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bn == 256 ? launch_gemm<256>(x, w, out, m, k, n, grid, group_m, st)
                : launch_gemm<128>(x, w, out, m, k, n, grid, group_m, st));
}

// The decode kernel: y = x @ w for bf16 x, w and y, 1 <= m <= 16, k % 64
// == 0, n % 128 == 0; `grid` blocks (1 .. n / 128 * ceil(k / 128)) share
// the weight's 128 x 128 stages evenly (skinny_matmul.cuh). part: [grid +
// n / 128, m <= 8 ? 1024 : 2048] f32 scratch. One launch on `stream`;
// returns cudaGetLastError() (0 on success; cudaErrorInvalidValue also
// where the CUDA tensor-map encoder is missing or refuses the arrays).
extern "C" int matmul_decode(const void* x, const void* w, void* out,
                             void* part, int m, int k, int n, int grid,
                             void* stream) {
  if (!skinny::shape_ok(m, k, n, grid) || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned* tickets = [] {
    void* p = nullptr;
    return cudaGetSymbolAddress(&p, g_tickets) == cudaSuccess
               ? static_cast<unsigned*>(p)
               : nullptr;
  }();
  if (tickets == nullptr) return static_cast<int>(cudaErrorInvalidSymbol);
  return static_cast<int>(skinny::launch<Bf16W>(
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, w, nullptr,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), tickets,
      m, k, n, k, grid, static_cast<cudaStream_t>(stream)));
}
