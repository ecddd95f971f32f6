// Weight-only dequant matmul for NVIDIA Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/quant_matmul.py::_fused_call (the Pallas body
// `_qmm_kernel`). y[m, n] = x[m, k] @ (q[k, n] * s) with
//   x   [m, k]      bfloat16 or float32, row-major
//   q   int8 [k, n]; int4: int8 [k/2, n], byte row r holding row 2r in its
//       low nibble and row 2r+1 in its high nibble (two's complement)
//   s   f32 [k / group_rows, n]: one scale row per group of group_rows rows
//       along k (group_rows = k for per-channel scales)
//   y   [m, n] in x's dtype, sums in f32.
// The weight is dequantized the way the reference's `dequantize` does it in
// x's dtype: bf16 inputs get w = bf16(q) * bf16(s) rounded once in bf16,
// f32 inputs w = q * s.
//
// Bound on the H100: bytes at decode (m = 8: each weight byte is read once
// for 16 multiply-adds), operations at prefill (m in the thousands: 2mkn
// flops of bf16 products, 989 TFLOP/s). The bf16 weight never exists in
// device memory: int8/int4 tiles are read and dequantized on the CUDA
// cores, into shared memory (prefill) or registers (decode), for the
// tensor-core products. The dequant is the other
// limit: int-to-float and float-to-bf16 conversions run at a quarter of the
// FMA rate, so the bf16 path converts with integer and FADD instructions
// instead (a byte b becomes the f32 2^23 + 128 + b by a byte permute, less
// 2^23 + 128; a nibble v the bf16 128 + (v + 8), less 136; both exact) and
// multiplies by the scales with bf16x2 multiplies, the reference's one
// rounding.
//
// The two bf16 designs share the dequant arithmetic.
//
// Prefill, bf16 x and m > 16 (qmm_wgmma_kernel): a persistent,
// warp-specialized wgmma kernel, one block of 4 warpgroups per SM walking
// 128 x 128 output tiles in an order the host picks (bands of group_m row
// tiles, row tiles fastest within a band, so that a band of x stays in the
// 50 MB L2 while the weight columns stream past it). Warpgroup 0 loads:
// one thread of warp 0 keeps a ring of kXRing x tiles in flight by TMA
// (cp.async.bulk.tensor, 128-byte swizzle, rows past m zero-filled by the
// copy), one thread of warp 1 a ring of kWRing raw int8/int4 weight tiles
// by TMA (no swizzle) with their scale rows by a bulk copy, each completing
// an mbarrier by transaction bytes; TMA spends no registers or
// instructions of the warps that compute, and a loader thread does
// nothing else (a wait of another role in its warp would stall its
// copies). Warpgroup 1 dequantizes each landed raw tile into a ring of
// kBRing bf16 weight tiles, written N-major in the 128-byte swizzled
// layout that the wgmma descriptor reads (transpose bit set), and signals
// an mbarrier. Warpgroups 2 and 3 multiply: each owns 64 rows of the tile
// and keeps 64 x 128 f32 accumulators in registers, and per k tile issues
// 4 asynchronous wgmma m64n128k16 from shared memory, keeping one k tile's
// products in flight while it releases the stages of the one before. No
// block-wide barrier runs in the mainloop: the dequant of the next tiles
// overlaps the products. setmaxnreg moves registers from the loaders and
// the dequant to the multiplying warpgroups. The epilogue rounds the
// accumulators to bf16 once and stores them through shared memory with
// 16-byte stores, rows past m masked. The tile count is not a multiple of
// 132 at every shape (800 tiles at n = 5120, 6.06 rounds): the tail is not
// split. Measured on the H100 (PERF.md): the load, dequant and product
// phases add up more than they overlap, near 3x the bound; a 128 x 256
// tile (4 rounds for 3.03 at n = 5120) and clusters of two CTAs sharing
// the x tile by TMA multicast measured no faster and are not kept.
//
// Decode, bf16 x and m <= 16 (quant_matmul_decode): the one-launch
// streaming kernel of skinny_matmul.cuh, instantiated here for int8 and
// int4 weights (Int8W, Int4W below): the weight is TMA-streamed through an
// mbarrier ring, dequantized in registers straight into mma.sync
// fragments, and the k split is reduced in the same launch by the last
// block of each column tile.
//
// float32 x (quant_matmul_kernel): one block of 8 warps per (128-column
// tile, BM-row tile, k split). The block walks its k tiles (BK rows; a
// tile never straddles a scale group, since group_rows % BK == 0) through
// a ring of kStages shared-memory stages filled by cp.async: each stage
// holds a tile's raw weight bytes, its x rows (zero-filled past m) and its
// scale row, so kStages - 1 tiles are in flight while the block
// dequantizes (q * s in f32) and multiplies the current one by CUDA-core
// FMA in f32 (each thread a 4- or 1-row by 8-column patch), so the f32
// path keeps f32 arithmetic (parity checks and the tiny f32 models). At
// small m the host splits k to fill one wave of blocks: each split writes
// f32 partials and a second kernel sums them in split order
// (deterministic, no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "skinny_matmul.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 256;
constexpr int kBN = 128;        // output columns per block
constexpr int kWPR = kBN / 16;  // 16-byte chunks per weight byte row

// ---------------------------------------------------------------------------
// float32 x: the split kernel
// ---------------------------------------------------------------------------

struct Args {
  const void* x;
  const int8_t* q;
  const float* s;
  void* out;    // [m, n] when splits == 1
  float* part;  // [splits, m, n] f32 partials when splits > 1
  int m, k, n, group_rows, splits;
};

// tile shapes by row tile (f32)
template <int BM>
struct Cfg {
  static constexpr int BK = 32;
  static constexpr int kPad = 4;
  static constexpr int kStages = 3;
};

template <int BM, bool kInt4>
struct Tile {
  using C = Cfg<BM>;
  static constexpr int BK = C::BK;
  static constexpr int kStages = C::kStages;
  static constexpr int LDX = BK + C::kPad;       // x tile row stride
  static constexpr int LDW = kBN + C::kPad;      // weight tile row stride
  static constexpr int kXPer = 4;                // x elements per chunk
  static constexpr int kXChunks = BM * BK / kXPer;
  static constexpr int kWRows = kInt4 ? BK / 2 : BK;  // byte rows per tile
  static constexpr int kWChunks = kWRows * kWPR;
  // one stage: x rows, raw weight bytes, the scale row
  static constexpr int kXBytes = BM * LDX * 4;
  static constexpr int kRawBytes = kWRows * kBN;
  static constexpr int kStageBytes = kXBytes + kRawBytes + kBN * 4;
  static constexpr int kWBytes = BK * LDW * 4;
  static constexpr int kSmem = kStages * kStageBytes + kWBytes;
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

__device__ __forceinline__ int sext4(int v) { return ((v & 0xF) ^ 8) - 8; }

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// 4 int8 weights (one word: columns c..c+3) times their bf16 scale pairs
// -> 4 bf16. 0x4B0000uu is the f32 2^23 + u with u = b + 128 (b ^ 0x80);
// subtracting 2^23 + 128 leaves b exactly, whose bf16 is the f32's upper
// half.
__device__ __forceinline__ uint2 dequant_i8(uint32_t w,
                                            const __nv_bfloat162* s) {
  const uint32_t wx = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7440 | i)) -
        8388736.f);
  }
  return make_uint2(bits(__hmul2(bf2(__byte_perm(f[0], f[1], 0x7632)), s[0])),
                    bits(__hmul2(bf2(__byte_perm(f[2], f[3], 0x7632)), s[1])));
}

// 4 packed int4 bytes (one word: columns c..c+3) -> the 4 bf16 weights of
// the even row (low nibbles) and of the odd row (high nibbles). The bf16
// 0x4300 | u is 128 + u; with u = v ^ 8 = v + 8 for the signed nibble v,
// subtracting 136 (0x4308) leaves v exactly.
__device__ __forceinline__ void dequant_i4(uint32_t w,
                                           const __nv_bfloat162* s,
                                           uint2* even, uint2* odd) {
  const __nv_bfloat162 k136 = bf2(0x43084308u);
  const uint32_t t01 = __byte_perm(w, 0u, 0x4140);  // bytes 0, 1 in lanes
  const uint32_t t23 = __byte_perm(w, 0u, 0x4342);  // bytes 2, 3
  auto nib = [&](uint32_t t, __nv_bfloat162 sc) {
    const uint32_t u = ((t & 0x000F000Fu) ^ 0x00080008u) | 0x43004300u;
    return bits(__hmul2(__hsub2(bf2(u), k136), sc));
  };
  *even = make_uint2(nib(t01, s[0]), nib(t23, s[1]));
  *odd = make_uint2(nib(t01 >> 4, s[0]), nib(t23 >> 4, s[1]));
}

// 16 floats -> shared memory
__device__ __forceinline__ void store16(float* d, const float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    reinterpret_cast<float4*>(d)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

__device__ __forceinline__ void store_out(float* d, float4 v) {
  *reinterpret_cast<float4*>(d) = v;
}

template <int BM, bool kInt4>
__global__ void __launch_bounds__(kThreads)
    quant_matmul_kernel(Args a) {
  using Tl = Tile<BM, kInt4>;
  constexpr int BK = Tl::BK;
  constexpr int S = Tl::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem + S * Tl::kStageBytes);

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
  const float* __restrict__ x = static_cast<const float*>(a.x);

  auto stage_x = [&](int st) {
    return reinterpret_cast<float*>(smem + st * Tl::kStageBytes);
  };
  auto stage_raw = [&](int st) {
    return smem + st * Tl::kStageBytes + Tl::kXBytes;
  };
  auto stage_scale = [&](int st) {
    return reinterpret_cast<float*>(smem + st * Tl::kStageBytes +
                                     Tl::kXBytes + Tl::kRawBytes);
  };

  // tile t -> stage st, by cp.async
  auto issue = [&](int t, int st) {
    const int k0 = t * BK;
    float* xs = stage_x(st);
    for (int i = tid; i < Tl::kXChunks; i += kThreads) {
      const int r = i / (BK / Tl::kXPer);
      const int c = (i % (BK / Tl::kXPer)) * Tl::kXPer;
      const bool in = m0 + r < a.m;
      cp_async16(xs + r * Tl::LDX + c,
                 in ? x + static_cast<size_t>(m0 + r) * a.k + k0 + c : x,
                 in ? 16 : 0);
    }
    unsigned char* raw = stage_raw(st);
    const int qrow0 = kInt4 ? k0 / 2 : k0;
    for (int i = tid; i < Tl::kWChunks; i += kThreads) {
      const int r = i / kWPR;
      const int c = (i % kWPR) * 16;
      cp_async16(raw + r * kBN + c,
                 a.q + static_cast<size_t>(qrow0 + r) * a.n + n0 + c);
    }
    if (tid < kBN / 4) {
      cp_async16(stage_scale(st) + 4 * tid,
                 a.s + static_cast<size_t>(k0 / a.group_rows) * a.n + n0 +
                     4 * tid);
    }
  };

  // the raw bytes of stage st -> the weight tile ws, q * s in f32
  auto dequant = [&](int st) {
    const unsigned char* raw = stage_raw(st);
    // every chunk of this thread covers the same 16 columns
    const int c = (tid % kWPR) * 16;
    const float* sc = stage_scale(st) + c;
    for (int i = tid; i < Tl::kWChunks; i += kThreads) {
      const int r = i / kWPR;
      const uint4 u = *reinterpret_cast<const uint4*>(raw + r * kBN + c);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&u);
      float v[16];
      if (kInt4) {
#pragma unroll
        for (int e = 0; e < 16; ++e) v[e] = sext4(b[e]) * sc[e];
        store16(ws + (2 * r) * Tl::LDW + c, v);
#pragma unroll
        for (int e = 0; e < 16; ++e) v[e] = sext4(b[e] >> 4) * sc[e];
        store16(ws + (2 * r + 1) * Tl::LDW + c, v);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          v[e] = static_cast<float>(static_cast<int8_t>(b[e])) * sc[e];
        }
        store16(ws + r * Tl::LDW + c, v);
      }
    }
  };

  // FMA on the CUDA cores; thread (ty, tx) owns rows ty*RM.. and columns
  // tx*8..tx*8+7 of the block's tile
  constexpr int RM = BM / 16;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  // the ring: S - 1 tiles in flight ahead of the one being multiplied
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < nt) issue(t_begin + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile i landed; every warp is past tile i - 1
    const int st = i % S;
    dequant(st);
    if (i + S - 1 < nt) issue(t_begin + i + S - 1, (i + S - 1) % S);
    cp_async_commit();
    __syncthreads();  // the weight tile is complete
    const float* xs = stage_x(st);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(ws + kk * Tl::LDW + tx * 8);
      const float4 b1 =
          *reinterpret_cast<const float4*>(ws + kk * Tl::LDW + tx * 8 + 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float av = xs[(ty * RM + r) * Tl::LDX + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av, bv[j], acc[r][j]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + ty * RM + i;
    if (row >= a.m) continue;
    const size_t o = static_cast<size_t>(row) * a.n + n0 + tx * 8;
    const float4 v0 = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    const float4 v1 = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    float* dst = a.splits == 1
                     ? static_cast<float*>(a.out) + o
                     : a.part + static_cast<size_t>(split) * a.m * a.n + o;
    reinterpret_cast<float4*>(dst)[0] = v0;
    reinterpret_cast<float4*>(dst)[1] = v1;
  }
}

// out[i] = sum over splits of part[split][i], in split order
__global__ void __launch_bounds__(kThreads)
    split_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
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
// decode, bf16 x and m <= 16: skinny_matmul.cuh's kernel on int8 / int4
// weights
// ---------------------------------------------------------------------------

// int8: thread (g, t) reads stored rows 4t .. 4t + 3 of its warp's 16,
// bytes 16 g .. 16 g + 15 (its 16 columns)
struct Int8W {
  static constexpr int kElt = 1;
  static constexpr int kKPer = 1;
  static constexpr int kStages = 6;
  static constexpr bool kScaled = true;
  __device__ static int col(int g, int i) { return 16 * g + i; }
  __device__ static void frags(const unsigned char* p, int g, int t,
                               const __nv_bfloat162* sp,
                               uint32_t (&a)[8][4]) {
    p += 4 * t * skinny::kBN + 16 * g;
    uint32_t w[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + r * skinny::kBN);
      w[r][0] = u.x;
      w[r][1] = u.y;
      w[r][2] = u.z;
      w[r][3] = u.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // columns 4i .. 4i + 3
      uint2 e[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) e[r] = dequant_i8(w[r][i], sp + 2 * i);
      skinny::pair_rows(e[0].x, e[1].x, e[2].x, e[3].x, a[2 * i]);
      skinny::pair_rows(e[0].y, e[1].y, e[2].y, e[3].y, a[2 * i + 1]);
    }
  }
};

// int4: thread (g, t) reads stored (byte) rows 2t and 2t + 1 of its warp's
// 8 (k rows 4t .. 4t + 3), bytes 16 g .. 16 g + 15 (its 16 columns)
struct Int4W {
  static constexpr int kElt = 1;
  static constexpr int kKPer = 2;
  static constexpr int kStages = 10;
  static constexpr bool kScaled = true;
  __device__ static int col(int g, int i) { return 16 * g + i; }
  __device__ static void frags(const unsigned char* p, int g, int t,
                               const __nv_bfloat162* sp,
                               uint32_t (&a)[8][4]) {
    p += 2 * t * skinny::kBN + 16 * g;
    const uint4 u0 = *reinterpret_cast<const uint4*>(p);
    const uint4 u1 = *reinterpret_cast<const uint4*>(p + skinny::kBN);
    const uint32_t w0[4] = {u0.x, u0.y, u0.z, u0.w};
    const uint32_t w1[4] = {u1.x, u1.y, u1.z, u1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // columns 4i .. 4i + 3
      uint2 r0, r1, r2, r3;  // k rows 4t .. 4t + 3
      dequant_i4(w0[i], sp + 2 * i, &r0, &r1);
      dequant_i4(w1[i], sp + 2 * i, &r2, &r3);
      skinny::pair_rows(r0.x, r1.x, r2.x, r3.x, a[2 * i]);
      skinny::pair_rows(r0.y, r1.y, r2.y, r3.y, a[2 * i + 1]);
    }
  }
};

// the column tiles' tickets of the decode kernel: 0 between launches
__device__ unsigned g_tickets[skinny::kMaxTiles];

// ---------------------------------------------------------------------------
// prefill, bf16 x and m > 16: the warp-specialized wgmma kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kPBM = 128;        // output rows per tile
constexpr int kPBK = 64;         // k per stage: one 128-byte x row
constexpr int kPThreads = 512;   // loaders, dequant, 2 consumer warpgroups
constexpr int kXTile = kPBM * kPBK * 2;  // 16 KB, 128-byte swizzled rows
constexpr int kBTile = kPBK * kBN * 2;   // 16 KB, N-major, swizzled
constexpr int kRawTile = kPBK * kBN;     // int8 bytes (int4: half used)
constexpr int kLdO = kBN + 8;            // epilogue staging row stride
constexpr int kOTile = 64 * kLdO * 2;    // one consumer's staging
constexpr int kXRing = 6;  // x tiles in flight
constexpr int kWRing = 4;  // raw weight tiles (and their scale rows)
constexpr int kBRing = 3;  // dequantized weight tiles
constexpr int kPSmem = 1024 /* alignment slack */ + kXRing * kXTile +
                       kBRing * kBTile + kWRing * (kRawTile + kBN * 4) +
                       2 * kOTile;

// byte offset of weight element (kr, n) in a dequantized tile: N-major,
// two 64-column halves of 8 KB, each 8 groups of 8 k rows of 128 bytes,
// the 16-byte chunk index XORed with kr % 8 (the 128-byte swizzle)
__device__ __forceinline__ uint32_t b_offset(int kr, int n) {
  return (n >> 6) * (kPBK * 128) + kr * 128 +
         ((((n & 63) >> 3) ^ (kr & 7)) << 4) + (n & 7) * 2;
}

struct PArgs {
  const float* s;
  bf16* out;
  int m, k, n, group_rows, tiles_m, tiles_n, group_m;
};

// registers after the shift (setmaxnreg): the launch gives 128 a thread
// (512 threads, one block per SM); the loaders and the dequant give up
// 88 and 32, and each consumer thread takes 56 of them
constexpr int kLoaderRegs = 40;
constexpr int kDequantRegs = 96;
constexpr int kConsumerRegs = 184;

template <bool kInt4>
__global__ void __launch_bounds__(kPThreads, 1)
    qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmq, const PArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_x[kXRing], empty_x[kXRing];
  __shared__ __align__(8) uint64_t full_w[kWRing], empty_w[kWRing];
  __shared__ __align__(8) uint64_t full_b[kBRing], empty_b[kBRing];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sx = base;                       // kXRing x tiles
  const uint32_t sb = sx + kXRing * kXTile;       // kBRing weight tiles
  const uint32_t sraw = sb + kBRing * kBTile;     // kWRing raw tiles
  const uint32_t ssc = sraw + kWRing * kRawTile;  // kWRing scale rows
  const uint32_t sout = ssc + kWRing * kBN * 4;   // 2 staging tiles
  unsigned char* g_b = gbase + (sb - base);
  const unsigned char* g_raw = gbase + (sraw - base);
  const float* g_sc = reinterpret_cast<const float*>(gbase + (ssc - base));
  bf16* g_out = reinterpret_cast<bf16*>(gbase + (sout - base));

  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;
  if (tid == 0) {
    for (int i = 0; i < kXRing; ++i) {
      mbar_init(smem_u32(&full_x[i]), 1);
      mbar_init(smem_u32(&empty_x[i]), 8);  // the 8 consumer warps
    }
    for (int i = 0; i < kWRing; ++i) {
      mbar_init(smem_u32(&full_w[i]), 1);
      mbar_init(smem_u32(&empty_w[i]), 128);  // every dequant thread
    }
    for (int i = 0; i < kBRing; ++i) {
      mbar_init(smem_u32(&full_b[i]), 128);
      mbar_init(smem_u32(&empty_b[i]), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int k_tiles = a.k / kPBK;
  const int tiles = a.tiles_m * a.tiles_n;
  const int my_tiles =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_tiles * k_tiles;  // k tiles this block walks
  auto tile = [&](int u, int* tm, int* tn) {  // this block's u-th tile
    tile_of(blockIdx.x + u * gridDim.x, a.tiles_m, a.tiles_n, a.group_m, tm,
            tn);
  };
  constexpr int kRawRows = kInt4 ? kPBK / 2 : kPBK;

  if (wg == 0) {
    // ---- loaders: warp 0 the x tiles, warp 1 the raw weight tiles and
    // their scales, each a ring of TMA loads freed by its consumers (the
    // products, the dequant); one lane of a warp that does nothing else,
    // so that no wait of another role stalls the copies ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoaderRegs));
    const int warp = t >> 5;
    if (warp <= 1 && (t & 31) == 0) {
      // the tile's coordinates change every k_tiles steps and the scale
      // row every group: a division per step on this one thread would
      // pace the copies
      int tm = 0, tn = 0, u = 0, k0 = 0, gk = 0, grp = 0;
      for (int it = 0; it < total; ++it, k0 += kPBK, gk += kPBK) {
        if (k0 == a.k) {
          k0 = 0;
          ++u;
        }
        if (gk == a.group_rows || k0 == 0) {
          gk = 0;
          grp = k0 == 0 ? 0 : grp + 1;
        }
        if (k0 == 0) tile(u, &tm, &tn);
        if (warp == 0) {
          const int st = it % kXRing;
          if (it >= kXRing)
            mbar_wait(smem_u32(&empty_x[st]), ((it / kXRing) & 1) ^ 1);
          const uint32_t bar = smem_u32(&full_x[st]);
          mbar_expect_tx(bar, kXTile);
          tma_2d(sx + st * kXTile, &tmx, k0, tm * kPBM, bar);
        } else {
          const int st = it % kWRing;
          if (it >= kWRing)
            mbar_wait(smem_u32(&empty_w[st]), ((it / kWRing) & 1) ^ 1);
          const uint32_t bar = smem_u32(&full_w[st]);
          mbar_expect_tx(bar, kRawRows * kBN + kBN * 4);
          tma_2d(sraw + st * kRawTile, &tmq, tn * kBN, kInt4 ? k0 / 2 : k0,
                 bar);
          bulk_copy(ssc + st * kBN * 4,
                    a.s + static_cast<size_t>(grp) * a.n + tn * kBN,
                    kBN * 4, bar);
        }
      }
    }
  } else if (wg == 1) {
    // ---- dequant: raw weight tiles -> bf16 weight tiles (128 threads) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kDequantRegs));
    // this thread's 16 weight columns and the rows it dequantizes: lanes
    // 0-3 of each 8 take chunks 0-3 of one raw row, lanes 4-7 chunks 4-7 of
    // the next, so that neither the 16-byte raw reads nor the swizzled
    // 16-byte writes of 8 lanes meet in a bank
    const int c = t & 7;
    const int row0 = ((t >> 2) & 1) + 2 * (t >> 3);  // 0..31
    for (int it = 0; it < total; ++it) {
      const int st = it % kWRing, b = it % kBRing;
      mbar_wait(smem_u32(&full_w[st]), (it / kWRing) & 1);
      if (it >= kBRing)
        mbar_wait(smem_u32(&empty_b[b]), ((it / kBRing) & 1) ^ 1);
      unsigned char* wt = g_b + b * kBTile;
      const unsigned char* raw = g_raw + st * kRawTile + c * 16;
      const float* srow = g_sc + st * kBN + c * 16;
      __nv_bfloat162 sp[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sp[j] = __floats2bfloat162_rn(srow[2 * j], srow[2 * j + 1]);
      constexpr int kTasks = kRawRows * 8 / 128;  // 4 (int8) or 2 (int4)
#pragma unroll
      for (int i = 0; i < kTasks; ++i) {
        // int8: rows row0 ^ (i / 2) and 32 more, so that each column chunk
        // sees every row; int4: the 32 byte rows, row0 ^ i
        const int r = kInt4 ? row0 ^ i : (row0 ^ (i >> 1)) + 32 * (i & 1);
        const uint4 u = *reinterpret_cast<const uint4*>(raw + r * kBN);
        const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
        uint2 e[4], o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kInt4) {
            dequant_i4(wd[j], sp + 2 * j, &e[j], &o[j]);
          } else {
            e[j] = dequant_i8(wd[j], sp + 2 * j);
          }
        }
        const int kr = kInt4 ? 2 * r : r;
        *reinterpret_cast<uint4*>(wt + b_offset(kr, c * 16)) =
            make_uint4(e[0].x, e[0].y, e[1].x, e[1].y);
        *reinterpret_cast<uint4*>(wt + b_offset(kr, c * 16 + 8)) =
            make_uint4(e[2].x, e[2].y, e[3].x, e[3].y);
        if (kInt4) {
          *reinterpret_cast<uint4*>(wt + b_offset(kr + 1, c * 16)) =
              make_uint4(o[0].x, o[0].y, o[1].x, o[1].y);
          *reinterpret_cast<uint4*>(wt + b_offset(kr + 1, c * 16 + 8)) =
              make_uint4(o[2].x, o[2].y, o[3].x, o[3].y);
        }
      }
      mbar_arrive(smem_u32(&empty_w[st]));  // the raw stage is read
      // the generic-proxy writes become visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(smem_u32(&full_b[b]));
    }
  } else {
    // ---- consumers: warpgroup 2 rows 0-63, warpgroup 3 rows 64-127 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int w = wg - 2;
    const int warp = t >> 5, lane = t & 31;
    bf16* stg = g_out + w * (64 * kLdO);
    auto release = [&](int i) {  // k tile i's x and weight stages
      if (lane != 0) return;
      mbar_arrive(smem_u32(&empty_x[i % kXRing]));
      mbar_arrive(smem_u32(&empty_b[i % kBRing]));
    };
    float d[64];
    int it = 0;
    for (int u = 0; u < my_tiles; ++u) {
      int tm, tn;
      tile(u, &tm, &tn);
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int sxs = it % kXRing, b = it % kBRing;
        mbar_wait(smem_u32(&full_x[sxs]), (it / kXRing) & 1);
        mbar_wait(smem_u32(&full_b[b]), (it / kBRing) & 1);
        __syncwarp();
        wgmma_fence();
        const uint32_t xa = sx + sxs * kXTile + w * 64 * 128;
        const uint32_t wb = sb + b * kBTile;
#pragma unroll
        for (int kk = 0; kk < kPBK / 16; ++kk) {
          // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart,
          // each k16 step 32 bytes on; B: N-major, the two 64-column atoms
          // 8 KB apart (leading), 8-row k groups 1024 apart (stride), each
          // k16 step two groups on
          wgmma_m64n128k16(d, gmma_desc(xa + kk * 32, 16, 1024),
                           gmma_desc(wb + kk * 2048, kPBK * 128, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();  // k tile it - 1's products are done
        if (kt > 0) release(it - 1);
      }
      wgmma_wait<0>();
      release(it - 1);
      // epilogue: bf16 pairs -> staging -> 16-byte rows of y
      const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(stg + r0 * kLdO + col) =
            __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(stg + (r0 + 8) * kLdO + col) =
            __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
      }
      named_sync(1 + w, 128);
      const int row_base = tm * kPBM + w * 64;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int idx = t + 128 * i;
        const int r = idx >> 4, ch = idx & 15;
        if (row_base + r < a.m) {
          *reinterpret_cast<uint4*>(
              a.out + static_cast<size_t>(row_base + r) * a.n + tn * kBN +
              ch * 8) =
              *reinterpret_cast<const uint4*>(stg + r * kLdO + ch * 8);
        }
      }
      named_sync(1 + w, 128);  // the staging tile is free again
    }
  }
}

template <bool kInt4>
cudaError_t launch_prefill(const void* x, const void* q, const float* s,
                           void* out, int m, int k, int n, int group_rows,
                           int grid, int group_m, cudaStream_t st) {
  CUtensorMap tmx, tmq;
  const int q_rows = kInt4 ? k / 2 : k;
  if (!make_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, k, kPBM,
                kPBK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&tmq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, q_rows, n,
                kInt4 ? kPBK / 2 : kPBK, kBN, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  static cudaError_t allowed = cudaFuncSetAttribute(
      qmm_wgmma_kernel<kInt4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kPSmem);
  if (allowed != cudaSuccess) return allowed;
  const PArgs a{s, static_cast<bf16*>(out), m, k, n, group_rows,
                (m + kPBM - 1) / kPBM, n / kBN, group_m};
  qmm_wgmma_kernel<kInt4><<<grid, kPThreads, kPSmem, st>>>(tmx, tmq, a);
  return cudaGetLastError();
}

bool layout_ok(int m, int k, int n, int group_rows) {
  return m >= 0 && k > 0 && n > 0 && k % 64 == 0 && n % kBN == 0 &&
         group_rows > 0 && group_rows % 64 == 0 && k % group_rows == 0;
}

// f32 row tiles: 16 rows for decode's m <= 16, 64 at larger m
constexpr int kSmallM = 16;
constexpr int kLargeF32 = 64;

template <int BM, bool kInt4>
cudaError_t prepare(void (**fn)(Args), int* smem) {
  static cudaError_t status = cudaFuncSetAttribute(
      quant_matmul_kernel<BM, kInt4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BM, kInt4>::kSmem);
  *fn = quant_matmul_kernel<BM, kInt4>;
  *smem = Tile<BM, kInt4>::kSmem;
  return status;
}

cudaError_t select_f32(int m, int is_int4, void (**fn)(Args), int* smem,
                       int* bm) {
  *bm = m <= kSmallM ? kSmallM : kLargeF32;
  if (m <= kSmallM)
    return is_int4 ? prepare<kSmallM, true>(fn, smem)
                   : prepare<kSmallM, false>(fn, smem);
  return is_int4 ? prepare<kLargeF32, true>(fn, smem)
                 : prepare<kLargeF32, false>(fn, smem);
}

}  // namespace

// Blocks of the f32 split kernel for (m, is_int4) that one SM holds at
// once (the host sizes its k split from this), or -1 on a CUDA error.
extern "C" int quant_matmul_blocks_per_sm(int m, int is_int4) {
  void (*fn)(Args) = nullptr;
  int smem = 0, bm = 0, blocks = 0;
  if (select_f32(m, is_int4, &fn, &smem, &bm) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                    smem) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

// The f32 split kernel: y = x @ dequant(q, s) (layouts above) for float32
// x and y at any m; all pointers 16-byte aligned and contiguous; k % 64 ==
// 0, n % 128 == 0, group_rows a multiple of 64 that divides k, 1 <= splits
// <= k / 64 (part: [splits, m, n] f32 scratch when splits > 1, else
// unused). Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int quant_matmul(const void* x, const void* q, const void* s,
                            void* out, void* part, int m, int k, int n,
                            int group_rows, int splits, int is_int4,
                            void* stream) {
  if (!layout_ok(m, k, n, group_rows) || splits < 1 || splits > k / 64 ||
      (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  void (*fn)(Args) = nullptr;
  int smem = 0, bm = 0;
  cudaError_t e = select_f32(m, is_int4, &fn, &smem, &bm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{x,      static_cast<const int8_t*>(q),
               static_cast<const float*>(s), out,
               static_cast<float*>(part), m, k, n, group_rows, splits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n / kBN, (m + bm - 1) / bm, splits);
  fn<<<grid, kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long long quads = static_cast<long long>(m) * n / 4;
  const unsigned blocks =
      static_cast<unsigned>((quads + kThreads - 1) / kThreads);
  split_sum_kernel<<<blocks, kThreads, 0, st>>>(
      a.part, static_cast<float*>(out), quads, splits);
  return static_cast<int>(cudaGetLastError());
}

// The decode kernel: y = x @ dequant(q, s) for bf16 x and y, 1 <= m <= 16,
// the layouts and conditions of quant_matmul, group_rows 64, 128 or k;
// `grid` blocks (1 .. n / 128 * ceil(k / 128)) share the weight's 128 x
// 128 stages evenly (skinny_matmul.cuh). part: [grid + n / 128, m <= 8 ?
// 1024 : 2048] f32 scratch. One launch on `stream`; returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue also where the
// CUDA tensor-map encoder is missing or refuses the arrays).
extern "C" int quant_matmul_decode(const void* x, const void* q,
                                   const void* s, void* out, void* part,
                                   int m, int k, int n, int group_rows,
                                   int is_int4, int grid, void* stream) {
  if (!layout_ok(m, k, n, group_rows) || !skinny::shape_ok(m, k, n, grid) ||
      (group_rows != k && group_rows != 64 && group_rows != 128) ||
      part == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static unsigned* tickets = [] {
    void* p = nullptr;
    return cudaGetSymbolAddress(&p, g_tickets) == cudaSuccess
               ? static_cast<unsigned*>(p)
               : nullptr;
  }();
  if (tickets == nullptr) return static_cast<int>(cudaErrorInvalidSymbol);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* y = static_cast<__nv_bfloat16*>(out);
  auto* p = static_cast<float*>(part);
  const auto* sc = static_cast<const float*>(s);
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return static_cast<int>(
      is_int4 ? skinny::launch<Int4W>(u8, x, q, sc, y, p, tickets, m, k, n,
                                      group_rows, grid, st)
              : skinny::launch<Int8W>(u8, x, q, sc, y, p, tickets, m, k, n,
                                      group_rows, grid, st));
}

// The prefill kernel: y = x @ dequant(q, s) for bf16 x and y, m > 16, the
// layouts and conditions of quant_matmul; `grid` persistent blocks (at
// most one per SM is resident) walk the ceil(m / 128) x n / 128 output
// tiles in bands of `group_m` row tiles (quant_matmul.py's
// `prefill_schedule`). Launches on `stream` and returns cudaGetLastError()
// (0 on success; cudaErrorInvalidValue also where the CUDA tensor-map
// encoder is missing or refuses the arrays).
extern "C" int quant_matmul_prefill(const void* x, const void* q,
                                    const void* s, void* out, int m, int k,
                                    int n, int group_rows, int is_int4,
                                    int grid, int group_m, void* stream) {
  if (!layout_ok(m, k, n, group_rows) || m <= kSmallM || grid < 1 ||
      group_m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(s);
  return static_cast<int>(
      is_int4 ? launch_prefill<true>(x, q, sc, out, m, k, n, group_rows, grid,
                                     group_m, st)
              : launch_prefill<false>(x, q, sc, out, m, k, n, group_rows,
                                      grid, group_m, st));
}
