// Fused Adam update with its low-precision cast, for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_adam_epilogue_kernel` launched by
// `fused_adam_step` through `_epilogue_call`
// (mxnet_tpu/ops/pallas_kernels.py:518, :603, :563), reached from
// `Optimizer.update_multi_precision` when the kernel tier is on.
//
// Computes, per element of one parameter tensor (lr_t is the
// bias-corrected learning rate, computed by the caller in f32):
//   g' = g + wd * w
//   m' = b1 * m + (1 - b1) * g'
//   v' = b2 * v + (1 - b2) * g' * g'
//   w' = w - lr_t * m' / (sqrt(v') + eps)
// and writes the f32 master w', m', v' and, unless the cast is f32,
// w' rounded once to bf16 or f16 (f16 weights are MXNet's usual
// multi_precision mode).  An f32 cast is the master's own bits (the
// reference's `nw.astype(f32)`): the caller then passes cast code 0, the
// kernel skips the cast store and the master is returned for both.  The
// grad is f32, bf16 or f16, widened exactly in registers.
//
// Rounding.  nvcc contracts a*b+c into one FMA by default, and the jitted
// reference's compiler contracts the same three multiply-adds; every step
// is therefore written as an intrinsic, so the roundings are pinned and
// match the reference and `fused_adam_step_plain` bit for bit:
//   __fmaf_rn(wd, w, g), __fmaf_rn(b1, m, (1-b1)*g'),
//   __fmaf_rn(b2, v, ((1-b2)*g')*g'), then w - (lr_t*m') / (sqrt(v')+eps)
// with IEEE division and square root.  Do not build with --use_fast_math.
//
// What bounds it on the H100: bytes.  It reads the f32 master, m and v and
// the grad (bf16 on the training path, f16 under an f16 multi_precision
// Trainer, or f32) and writes the master, m, v and the low-precision
// weight: 28 bytes per element with a 2-byte grad (32 with an f32 grad
// and no cast, the symbolic Module's step), against 3.35 TB/s.  One
// launch per parameter tensor; a grid-stride loop over 4-element vectors
// (16-byte f32 loads) with a scalar tail.  The inputs and outputs may
// alias (in-place update): each element is read before it is written, by
// the same thread.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

struct AdamArgs {
  float lr_t, wd, b1, b2, omb1, omb2, eps;
};

__device__ __forceinline__ float adam_one(float w, float g, float* m,
                                          float* v, const AdamArgs& a) {
  g = __fmaf_rn(a.wd, w, g);
  const float nm = __fmaf_rn(a.b1, *m, __fmul_rn(a.omb1, g));
  const float nv = __fmaf_rn(a.b2, *v, __fmul_rn(__fmul_rn(a.omb2, g), g));
  *m = nm;
  *v = nv;
  return __fsub_rn(
      w, __fdiv_rn(__fmul_rn(a.lr_t, nm), __fadd_rn(__fsqrt_rn(nv), a.eps)));
}

// dtype codes of the grad and the cast (cuda_kernels._DTYPE_CODE)
constexpr int kF32 = 0, kBf16 = 1, kF16 = 2;

__device__ __forceinline__ float grad_at(const void* g, int64_t i,
                                         int grad_code) {
  if (grad_code == kBf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(g)[i]);
  if (grad_code == kF16)
    return __half2float(static_cast<const __half*>(g)[i]);
  return static_cast<const float*>(g)[i];
}

// The cast store of one and of two neighbouring values, rounded once.
template <typename T> struct Cast;
template <> struct Cast<__nv_bfloat16> {
  typedef __nv_bfloat162 Pair;
  static __device__ __forceinline__ __nv_bfloat16 one(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ Pair two(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};
template <> struct Cast<__half> {
  typedef __half2 Pair;
  static __device__ __forceinline__ __half one(float x) {
    return __float2half_rn(x);
  }
  static __device__ __forceinline__ Pair two(float a, float b) {
    return __floats2half2_rn(a, b);
  }
};

// LP: the cast's element type, or void for no cast store (an f32 cast).
template <typename LP>
__global__ void __launch_bounds__(kThreads)
adam_step_kernel(const float* w, const void* g, const float* m,
                 const float* v, float* w_out, float* m_out, float* v_out,
                 void* lp_raw, int64_t n, int grad_code, AdamArgs a,
                 int vec) {
  constexpr bool kCast = !std::is_void<LP>::value;
  typedef typename std::conditional<kCast, LP, __nv_bfloat16>::type T;
  T* lp = static_cast<T*>(lp_raw);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nvec = vec ? n / 4 : 0;
  for (int64_t i = tid; i < nvec; i += stride) {
    const float4 w4 = reinterpret_cast<const float4*>(w)[i];
    float4 m4 = reinterpret_cast<const float4*>(m)[i];
    float4 v4 = reinterpret_cast<const float4*>(v)[i];
    float g4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) g4[e] = grad_at(g, 4 * i + e, grad_code);
    float4 o4;
    o4.x = adam_one(w4.x, g4[0], &m4.x, &v4.x, a);
    o4.y = adam_one(w4.y, g4[1], &m4.y, &v4.y, a);
    o4.z = adam_one(w4.z, g4[2], &m4.z, &v4.z, a);
    o4.w = adam_one(w4.w, g4[3], &m4.w, &v4.w, a);
    reinterpret_cast<float4*>(w_out)[i] = o4;
    reinterpret_cast<float4*>(m_out)[i] = m4;
    reinterpret_cast<float4*>(v_out)[i] = v4;
    if constexpr (kCast) {
      typedef typename Cast<T>::Pair Pair;
      reinterpret_cast<Pair*>(lp)[2 * i] = Cast<T>::two(o4.x, o4.y);
      reinterpret_cast<Pair*>(lp)[2 * i + 1] = Cast<T>::two(o4.z, o4.w);
    }
  }
  for (int64_t i = nvec * 4 + tid; i < n; i += stride) {
    float mi = m[i], vi = v[i];
    const float nw = adam_one(w[i], grad_at(g, i, grad_code), &mi, &vi, a);
    w_out[i] = nw;
    m_out[i] = mi;
    v_out[i] = vi;
    if constexpr (kCast) lp[i] = Cast<T>::one(nw);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// grad_code: the grad's dtype (0 f32, 1 bf16, 2 f16); cast_code: the
// cast's (1 bf16, 2 f16), or 0 for an f32 cast, which is the master
// itself and is not stored again.
extern "C" int mx_adam_step(const void* w, const void* g, const void* m,
                            const void* v, void* w_out, void* m_out,
                            void* v_out, void* lp, int64_t n, int grad_code,
                            int cast_code, float lr_t, float wd, float b1,
                            float b2, float omb1, float omb2, float eps,
                            void* stream) {
  if (n <= 0 || grad_code < kF32 || grad_code > kF16 || cast_code < kF32 ||
      cast_code > kF16)
    return (int)cudaErrorInvalidValue;
  const AdamArgs a{lr_t, wd, b1, b2, omb1, omb2, eps};
  // float4 over the f32 tensors, 2-byte pairs over the cast (when there
  // is one); the grad is read per element, so its base needs no
  // alignment.
  const int vec = aligned16(w) && aligned16(m) && aligned16(v) &&
                  aligned16(w_out) && aligned16(m_out) && aligned16(v_out) &&
                  (cast_code == kF32 ||
                   (reinterpret_cast<uintptr_t>(lp) & 7u) == 0);
  int64_t work = vec ? (n + 3) / 4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  // enough blocks to cover the 132 SMs many times over, and no more
  if (blocks > 132 * 16) blocks = 132 * 16;
  auto kernel = cast_code == kBf16  ? adam_step_kernel<__nv_bfloat16>
                : cast_code == kF16 ? adam_step_kernel<__half>
                                    : adam_step_kernel<void>;
  kernel<<<(unsigned)blocks, kThreads, 0,
           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), g, static_cast<const float*>(m),
      static_cast<const float*>(v), static_cast<float*>(w_out),
      static_cast<float*>(m_out), static_cast<float*>(v_out), lp, n,
      grad_code, a, vec);
  return (int)cudaGetLastError();
}

extern "C" const char* mx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
