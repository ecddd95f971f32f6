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
// device memory: int8/int4 tiles are read, dequantized on the CUDA cores
// and staged in shared memory for the products. The dequant is the other
// limit: int-to-float and float-to-bf16 conversions run at a quarter of the
// FMA rate, so the bf16 path converts with integer and FADD instructions
// instead (a byte b becomes the f32 2^23 + 128 + b by a byte permute, less
// 2^23 + 128; a nibble v the bf16 128 + (v + 8), less 136; both exact) and
// multiplies by the scales with bf16x2 multiplies, the reference's one
// rounding.
//
// Design: one block of 8 warps per (128-column tile, BM-row tile, k split).
// The block walks its k tiles (BK rows; a tile never straddles a scale
// group, since group_rows % BK == 0) through a ring of kStages shared-memory
// stages filled by cp.async: each stage holds a tile's raw weight bytes,
// its x rows (zero-filled past m) and its scale row, so kStages - 1 tiles
// are in flight while the block dequantizes and multiplies the current
// one. Per tile the block dequantizes the raw bytes into one bf16 (or f32)
// weight tile, then
//   bf16 x: WMMA 16x16x16 bf16 products with f32 accumulators; BM = 128
//     (4x2 warps of 32x64) for m > 16, BM = 16 (8 warps of 16x16) for
//     decode's m <= 16;
//   f32 x: CUDA-core FMA in f32 (each thread a 4- or 1-row by 8-column
//     patch), so the f32 path keeps f32 arithmetic.
// At decode, n / 128 column tiles alone leave most of the 132 SMs idle, so
// the host splits k to fill one wave of blocks: each split writes f32
// partials and a second kernel sums them in split order (deterministic, no
// atomics). TMA, wgmma and register-resident dequantized fragments are
// left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kBN = 128;        // output columns per block
constexpr int kWPR = kBN / 16;  // 16-byte chunks per weight byte row

struct Args {
  const void* x;
  const int8_t* q;
  const float* s;
  void* out;    // [m, n] when splits == 1
  float* part;  // [splits, m, n] f32 partials when splits > 1
  int m, k, n, group_rows, splits;
};

// tile shapes by input type and row tile
template <typename T, int BM>
struct Cfg;

template <int BM>
struct Cfg<__nv_bfloat16, BM> {
  static constexpr int BK = 64;
  static constexpr int kPad = 8;  // WMMA: a multiple of 8 bf16 per row
  static constexpr int kStages = BM == 16 ? 4 : 3;
  static constexpr int kWarpsM = BM == 16 ? 1 : 4;
};

template <int BM>
struct Cfg<float, BM> {
  static constexpr int BK = 32;
  static constexpr int kPad = 4;
  static constexpr int kStages = 3;
};

template <typename T, int BM, bool kInt4>
struct Tile {
  using C = Cfg<T, BM>;
  static constexpr int BK = C::BK;
  static constexpr int kStages = C::kStages;
  static constexpr int LDX = BK + C::kPad;       // x tile row stride
  static constexpr int LDW = kBN + C::kPad;      // weight tile row stride
  static constexpr int LDC = kBN + 4;            // f32 result row stride
  static constexpr int kXPer = 16 / sizeof(T);   // x elements per chunk
  static constexpr int kXChunks = BM * BK / kXPer;
  static constexpr int kWRows = kInt4 ? BK / 2 : BK;  // byte rows per tile
  static constexpr int kWChunks = kWRows * kWPR;
  // one stage: x rows, raw weight bytes, the scale row
  static constexpr int kXBytes = BM * LDX * sizeof(T);
  static constexpr int kRawBytes = kWRows * kBN;
  static constexpr int kStageBytes = kXBytes + kRawBytes + kBN * 4;
  static constexpr int kWBytes = BK * LDW * sizeof(T);
  static constexpr int kCBytes = sizeof(T) == 2 ? BM * LDC * 4 : 0;
  static constexpr int kLoopBytes = kStages * kStageBytes + kWBytes;
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

template <typename T, int BM, bool kInt4>
__global__ void __launch_bounds__(kThreads)
    quant_matmul_kernel(Args a) {
  using Tl = Tile<T, BM, kInt4>;
  constexpr int BK = Tl::BK;
  constexpr int S = Tl::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem + S * Tl::kStageBytes);

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

  auto stage_x = [&](int st) {
    return reinterpret_cast<T*>(smem + st * Tl::kStageBytes);
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
    T* xs = stage_x(st);
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

  // the raw bytes of stage st -> the weight tile ws, dequantized
  auto dequant = [&](int st) {
    const unsigned char* raw = stage_raw(st);
    const float* srow = stage_scale(st);
    // every chunk of this thread covers the same 16 columns
    const int c = (tid % kWPR) * 16;
    if constexpr (sizeof(T) == 2) {
      // bf16(q) * bf16(s): the scale pairs rounded once per tile
      __nv_bfloat162 sp[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sp[j] = __floats2bfloat162_rn(srow[c + 2 * j], srow[c + 2 * j + 1]);
      }
      for (int i = tid; i < Tl::kWChunks; i += kThreads) {
        const int r = i / kWPR;
        const uint4 u = *reinterpret_cast<const uint4*>(raw + r * kBN + c);
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
        const int row = kInt4 ? 2 * r : r;
        uint4* dst = reinterpret_cast<uint4*>(ws + row * Tl::LDW + c);
        dst[0] = make_uint4(e[0].x, e[0].y, e[1].x, e[1].y);
        dst[1] = make_uint4(e[2].x, e[2].y, e[3].x, e[3].y);
        if (kInt4) {
          dst = reinterpret_cast<uint4*>(ws + (row + 1) * Tl::LDW + c);
          dst[0] = make_uint4(o[0].x, o[0].y, o[1].x, o[1].y);
          dst[1] = make_uint4(o[2].x, o[2].y, o[3].x, o[3].y);
        }
      }
    } else {
      // f32: q * s in f32
      const float* sc = srow + c;
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
      const int st = i % S;
      dequant(st);
      if (i + S - 1 < nt) issue(t_begin + i + S - 1, (i + S - 1) % S);
      cp_async_commit();
      __syncthreads();  // the weight tile is complete
      multiply(stage_x(st));
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
    pipeline([&](const T* xs) {
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
    pipeline([&](const T* xs) {
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
      const float4 v0 = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      const float4 v1 = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      float* dst = a.splits == 1
                       ? static_cast<float*>(a.out) + o
                       : a.part + static_cast<size_t>(split) * a.m * a.n + o;
      reinterpret_cast<float4*>(dst)[0] = v0;
      reinterpret_cast<float4*>(dst)[1] = v1;
    }
  }
}

// out[i] = sum over splits of part[split][i], in split order
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

// the kernel for (T, BM, int4), its dynamic shared memory allowed once
template <typename T, int BM, bool kInt4>
cudaError_t prepare(void (**fn)(Args), int* smem) {
  static cudaError_t status = cudaFuncSetAttribute(
      quant_matmul_kernel<T, BM, kInt4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<T, BM, kInt4>::kSmem);
  *fn = quant_matmul_kernel<T, BM, kInt4>;
  *smem = Tile<T, BM, kInt4>::kSmem;
  return status;
}

// row tiles: 16 rows for decode's m <= 16, else 128 (bf16) or 64 (f32)
constexpr int kSmallM = 16;
template <typename T>
constexpr int kLargeTile = sizeof(T) == 2 ? 128 : 64;

template <typename T>
cudaError_t select(int m, bool int4, void (**fn)(Args), int* smem, int* bm) {
  constexpr int kLarge = kLargeTile<T>;
  *bm = m <= kSmallM ? kSmallM : kLarge;
  if (m <= kSmallM) {
    return int4 ? prepare<T, kSmallM, true>(fn, smem)
                : prepare<T, kSmallM, false>(fn, smem);
  }
  return int4 ? prepare<T, kLarge, true>(fn, smem)
              : prepare<T, kLarge, false>(fn, smem);
}

cudaError_t select_any(int m, int is_int4, int is_bf16, void (**fn)(Args),
                       int* smem, int* bm) {
  return is_bf16 ? select<__nv_bfloat16>(m, is_int4 != 0, fn, smem, bm)
                 : select<float>(m, is_int4 != 0, fn, smem, bm);
}

}  // namespace

// Blocks of the kernel for (m, is_int4, is_bf16) that one SM holds at once
// (the host sizes its k split from this), or -1 on a CUDA error.
extern "C" int quant_matmul_blocks_per_sm(int m, int is_int4, int is_bf16) {
  void (*fn)(Args) = nullptr;
  int smem = 0, bm = 0, blocks = 0;
  if (select_any(m, is_int4, is_bf16, &fn, &smem, &bm) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                    smem) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

// The row tile of the kernel for m: the host counts blocks with it.
extern "C" int quant_matmul_row_tile(int m, int is_bf16) {
  return m <= kSmallM ? kSmallM
                      : (is_bf16 ? kLargeTile<__nv_bfloat16> : kLargeTile<float>);
}

// y = x @ dequant(q, s) (layouts above); all pointers 16-byte aligned and
// contiguous; k % 64 == 0, n % 128 == 0, group_rows a multiple of 64 that
// divides k, 1 <= splits <= k / 64 (part: [splits, m, n] f32 scratch when
// splits > 1, else unused). is_bf16: x and y bfloat16, else float32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int quant_matmul(const void* x, const void* q, const void* s,
                            void* out, void* part, int m, int k, int n,
                            int group_rows, int splits, int is_int4,
                            int is_bf16, void* stream) {
  if (m < 0 || k <= 0 || n <= 0 || k % 64 || n % kBN || group_rows <= 0 ||
      group_rows % 64 || k % group_rows || splits < 1 || splits > k / 64 ||
      (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  void (*fn)(Args) = nullptr;
  int smem = 0, bm = 0;
  cudaError_t e = select_any(m, is_int4, is_bf16, &fn, &smem, &bm);
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
  if (is_bf16) {
    split_sum_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        a.part, static_cast<__nv_bfloat16*>(out), quads, splits);
  } else {
    split_sum_kernel<float><<<blocks, kThreads, 0, st>>>(
        a.part, static_cast<float*>(out), quads, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
