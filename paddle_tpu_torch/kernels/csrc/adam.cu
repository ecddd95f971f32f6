// Adam / AdamW parameter update in one pass, for NVIDIA Hopper (sm_90a).
//
// Replaces: no `pallas_call`. The reference's update is
// paddle_tpu/optimizer/optimizer.py::Adam._update_param (:248-273), which its
// compiled train step runs as one XLA loop fusion per parameter. The port's
// plain version (paddle_tpu_torch/kernels/adam.py::adam_update_ref) runs
// it as about ten elementwise PyTorch operations, each of which streams
// the whole tensors.
//
// Per element, in the reference's order, every f32 operation rounded on
// its own (the _rn intrinsics: nvcc may not contract them into FMAs):
//   work = master weight, or f32(p)
//   g    = f32(grad)                      (+ wd * work for Adam's L2)
//   m1   = m1 * beta1 + (1 - beta1) * g
//   m2   = m2 * beta2 + (1 - beta2) * (g * g)
//   work = work * decay                   (AdamW: decay = 1 - lr * coeff)
//   work = work - ((m1 / bc1) * lr) / (sqrt(m2 / bc2) + eps)
//   p    = work rounded once to p's dtype; master = work
// with bc1 = 1 - beta1^t and bc2 = 1 - beta2^t computed on the host, as the
// plain version computes them (f32), so the kernel reads no device scalar.
//
// p is float32, bfloat16 or float16; the gradient is p's dtype or float32;
// m1, m2 and the master weight (none for float32 p, or where the optimizer
// keeps none) are float32. All contiguous, any numel.
//
// Bound on the H100: bytes. Each element reads p, g, m1, m2 (and the
// master), and writes p, m1, m2 (and the master): for bf16 p without a
// master 2 + 2 + 8 + 2 + 8 = 22 bytes, least time 22 * numel / 3.35 TB/s.
// The arithmetic, ~15 f32 operations an element, is far below the card's
// 67 TFLOP/s f32.
//
// Design: a grid-stride loop over 8-element vectors, one vector a thread
// an iteration: p (and g) by one 16-byte load (bf16 / f16) or two (f32),
// each f32 array by two 16-byte loads, every load of a vector issued
// before the arithmetic; as many blocks as keep every SM full, at most one
// vector a thread. Where any pointer is not 16-byte aligned, or for the
// numel % 8 elements at the end, the same arithmetic element by element.
// One launch a tensor.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;
constexpr int kThreads = 256;

enum { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct Scalars {
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps;
  float lr, decay, wd, bc1, bc2;
  int decoupled;  // AdamW: work *= decay (Adam: wd != 0 adds wd * work to g)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// one element: returns the new working value; updates m1, m2 in place
__device__ __forceinline__ float update(float work, float g, float& m1,
                                        float& m2, const Scalars& s) {
  if (s.wd != 0.0f) g = __fadd_rn(g, __fmul_rn(s.wd, work));
  m1 = __fadd_rn(__fmul_rn(m1, s.beta1), __fmul_rn(s.one_minus_beta1, g));
  m2 = __fadd_rn(__fmul_rn(m2, s.beta2),
                 __fmul_rn(s.one_minus_beta2, __fmul_rn(g, g)));
  if (s.decoupled) work = __fmul_rn(work, s.decay);
  const float num = __fmul_rn(__fdiv_rn(m1, s.bc1), s.lr);
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(m2, s.bc2)), s.eps);
  return __fsub_rn(work, __fdiv_rn(num, den));
}

// kVec elements of T as raw 16-byte words: 1 for 2-byte T, 2 for float
template <typename T>
struct Pack {
  static constexpr int kWords = sizeof(T) * kVec / 16;
  uint4 w[kWords];
  __device__ __forceinline__ void load(const T* src) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = s[i];
  }
  __device__ __forceinline__ void store(T* dst) const {
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int i = 0; i < kWords; ++i) d[i] = w[i];
  }
  __device__ __forceinline__ T& operator[](int i) {
    return reinterpret_cast<T*>(w)[i];
  }
};

template <typename T, typename G, bool MASTER>
__global__ void __launch_bounds__(kThreads)
    adam_kernel(T* __restrict__ p, const G* __restrict__ g,
                float* __restrict__ m1, float* __restrict__ m2,
                float* __restrict__ master, int64_t n, Scalars s,
                int vectors) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t nvec = vectors ? n / kVec : 0;
  for (int64_t v = first; v < nvec; v += stride) {
    const int64_t o = v * kVec;
    Pack<T> pp;
    Pack<G> gg;
    Pack<float> a, b, w;
    pp.load(p + o);
    gg.load(g + o);
    a.load(m1 + o);
    b.load(m2 + o);
    if (MASTER) w.load(master + o);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float work = MASTER ? w[i] : to_f32(pp[i]);
      const float out = update(work, to_f32(gg[i]), a[i], b[i], s);
      if (MASTER) w[i] = out;
      pp[i] = from_f32<T>(out);
    }
    pp.store(p + o);
    a.store(m1 + o);
    b.store(m2 + o);
    if (MASTER) w.store(master + o);
  }
  // the elements no vector covers: the tail, or all of them when a pointer
  // is not 16-byte aligned
  for (int64_t i = nvec * kVec + first; i < n; i += stride) {
    float a = m1[i], b = m2[i];
    const float work = MASTER ? master[i] : to_f32(p[i]);
    const float out = update(work, to_f32(g[i]), a, b, s);
    m1[i] = a;
    m2[i] = b;
    if (MASTER) master[i] = out;
    p[i] = from_f32<T>(out);
  }
}

template <typename T, typename G, bool MASTER>
cudaError_t launch(void* p, const void* g, float* m1, float* m2,
                   float* master, int64_t n, const Scalars& s, int vectors,
                   int sms, cudaStream_t stream) {
  const int64_t work = vectors ? n / kVec + n % kVec : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  // 8 blocks of 256 threads fill an SM's 2048 thread slots
  const int64_t cap = static_cast<int64_t>(sms) * (2048 / kThreads);
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  adam_kernel<T, G, MASTER><<<static_cast<int>(blocks), kThreads, 0,
                              stream>>>(
      static_cast<T*>(p), static_cast<const G*>(g), m1, m2, master, n, s,
      vectors);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_g(int g_f32, int has_master, void* p, const void* g,
                       float* m1, float* m2, float* master, int64_t n,
                       const Scalars& s, int vectors, int sms,
                       cudaStream_t stream) {
  if (g_f32) {
    return has_master
               ? launch<T, float, true>(p, g, m1, m2, master, n, s, vectors,
                                        sms, stream)
               : launch<T, float, false>(p, g, m1, m2, master, n, s, vectors,
                                         sms, stream);
  }
  return has_master
             ? launch<T, T, true>(p, g, m1, m2, master, n, s, vectors, sms,
                                  stream)
             : launch<T, T, false>(p, g, m1, m2, master, n, s, vectors, sms,
                                   stream);
}

}  // namespace

// One Adam / AdamW update of a contiguous parameter p [n] (dtype: 0 f32,
// 1 bf16, 2 f16) from its gradient g [n] (p's dtype, or f32 with g_f32), in
// place on p, the f32 moments m1, m2 [n] and the f32 master weight [n]
// (null: none; never for f32 p). decoupled: AdamW's decay (work *= decay
// before the step); wd != 0: Adam's L2 weight decay on the gradient. bc1 = 1 - beta1^t,
// bc2 = 1 - beta2^t. vectors: every pointer 16-byte aligned (8-element
// vectors; else element by element). sms: the device's SM count. One
// launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int adam_update(void* p, const void* g, void* m1, void* m2,
                           void* master, long long n, int dtype, int g_f32,
                           int decoupled, float beta1, float one_minus_beta1,
                           float beta2, float one_minus_beta2, float eps,
                           float lr, float decay, float wd, float bc1,
                           float bc2, int vectors, int sms, void* stream) {
  if (n < 1) return 0;
  if (p == nullptr || g == nullptr || m1 == nullptr || m2 == nullptr ||
      (dtype == kF32 && master != nullptr) || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Scalars s{beta1, one_minus_beta1, beta2, one_minus_beta2, eps,
            lr,    decay,           wd,    bc1,             bc2,
            decoupled};
  float* a = static_cast<float*>(m1);
  float* b = static_cast<float*>(m2);
  float* w = static_cast<float*>(master);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch<float, float, false>(
          p, g, a, b, nullptr, n, s, vectors, sms, st));
    case kBF16:
      return static_cast<int>(dispatch_g<__nv_bfloat16>(
          g_f32, w != nullptr, p, g, a, b, w, n, s, vectors, sms, st));
    case kF16:
      return static_cast<int>(dispatch_g<__half>(
          g_f32, w != nullptr, p, g, a, b, w, n, s, vectors, sms, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
