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
// Design: one block of 8 warps per (128-column tile, BM-row tile, k split).
// The block walks its k tiles (BK rows of w, BK columns of x) through a
// ring of kStages shared-memory stages filled by cp.async, so kStages - 1
// tiles are in flight while the block multiplies the current one. Rows of
// x at or past m are zero-filled by the copy (the m tail is masked, not
// padded by a copy of x), and their outputs are not stored.
//   bf16: WMMA 16x16x16 bf16 products with f32 accumulators; BM = 16 (8
//     warps of 16x16; decode's m of 1-16), 64 (2x4 warps of 32x32) or 128
//     (4x2 warps of 32x64), BK = 64; the results go to shared memory and
//     out as bf16, rounded once.
//   f32: CUDA-core FMA in f32 (each thread a BM/16-row by 8-column patch),
//     BM = 16 or 64, BK = 32: exact f32 products, no TF32.
// At decode the n / 128 column tiles alone leave most of the 132 SMs idle,
// so the host splits k to fill one wave of resident blocks: each split
// writes f32 partials and a second kernel sums them in split order and
// rounds once (deterministic, no atomics). TMA, wgmma and a persistent
// schedule are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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
  static constexpr int kStages = BM == 16 ? 4 : 3;
  static constexpr int kWarpsM = BM >= 32 ? BM / 32 : 1;
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

// row tiles: bf16 16, 64, 128; f32 16, 64
cudaError_t select(int tile, int is_bf16, void (**fn)(Args), int* smem,
                   int* bk) {
  if (is_bf16) {
    switch (tile) {
      case 16:
        return prepare<__nv_bfloat16, 16>(fn, smem, bk);
      case 64:
        return prepare<__nv_bfloat16, 64>(fn, smem, bk);
      case 128:
        return prepare<__nv_bfloat16, 128>(fn, smem, bk);
      default:
        return cudaErrorInvalidValue;
    }
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
// `tile` (bf16: 16, 64, 128; f32: 16, 64), 1 <= splits <= k / k tile (part:
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
