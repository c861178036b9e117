// Fused per-feature scale, bias and ReLU, for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_scale_bias_relu_kernel` launched by the
// registered op `pallas_scale_bias_relu`
// (mxnet_tpu/ops/pallas_kernels.py:620, :626, :639).
//
// Computes y[r, c] = relu(x[r, c] * scale[c] + bias[c]) over x [n, d], with
// scale and bias [d] in x's dtype (f32, bf16 or f16), rounding exactly as
// the reference does:
//   f32:       fma(x, s, b), one rounding;
//   bf16/f16:  round(round(x * s) + b), each step in f32 and rounded to
//              the storage type (the product of two 16-bit values is exact
//              in f32, so round(x * s) is one rounding of the exact value);
// then a ReLU that propagates NaN and gives +0 for -0 (fmaxf(NaN, 0)
// would give 0, so it is not used).  Do not build with --use_fast_math.
//
// What bounds it on the H100: bytes, x read once and y written once (the
// 2 d values of scale and bias are noise).  The grid tiles [n, d] by
// columns: a block of 128 threads owns a tile of 128 16-byte vectors of
// columns (512 f32 or 1024 bf16/f16 columns), loads that tile's scale and
// bias once into registers, and walks rows r = blockIdx.y, + gridDim.y, ...
// Where a row is not 16-byte aligned (d * itemsize % 16 != 0, or a base
// pointer is not), each thread owns one column and loads scalars.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T> struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

__device__ __forceinline__ float relu_nan(float v) {
  return (v > 0.f || v != v) ? v : 0.f;
}

__device__ __forceinline__ float sbr(float x, float s, float b) {
  return relu_nan(__fmaf_rn(x, s, b));
}
__device__ __forceinline__ __nv_bfloat16 sbr(__nv_bfloat16 x,
                                             __nv_bfloat16 s,
                                             __nv_bfloat16 b) {
  const float p = __bfloat162float(__float2bfloat16_rn(
      __fmul_rn(__bfloat162float(x), __bfloat162float(s))));
  return __float2bfloat16_rn(relu_nan(__fadd_rn(p, __bfloat162float(b))));
}
__device__ __forceinline__ __half sbr(__half x, __half s, __half b) {
  const float p = __half2float(
      __float2half_rn(__fmul_rn(__half2float(x), __half2float(s))));
  return __float2half_rn(relu_nan(__fadd_rn(p, __half2float(b))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sbr_vec(const T* __restrict__ x, const T* __restrict__ scale,
        const T* __restrict__ bias, T* __restrict__ y, int64_t n,
        int64_t d) {
  constexpr int N = Vec<T>::N;
  const int64_t dv = d / N;
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= dv) return;
  const Vec<T> s = reinterpret_cast<const Vec<T>*>(scale)[c];
  const Vec<T> b = reinterpret_cast<const Vec<T>*>(bias)[c];
  const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
  Vec<T>* yv = reinterpret_cast<Vec<T>*>(y);
  for (int64_t r = blockIdx.y; r < n; r += gridDim.y) {
    const Vec<T> xi = xv[r * dv + c];
    Vec<T> o;
#pragma unroll
    for (int e = 0; e < N; ++e) o.v[e] = sbr(xi.v[e], s.v[e], b.v[e]);
    yv[r * dv + c] = o;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sbr_scalar(const T* __restrict__ x, const T* __restrict__ scale,
           const T* __restrict__ bias, T* __restrict__ y, int64_t n,
           int64_t d) {
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  const T s = scale[c], b = bias[c];
  for (int64_t r = blockIdx.y; r < n; r += gridDim.y)
    y[r * d + c] = sbr(x[r * d + c], s, b);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const void* x, const void* s, const void* b, void* y, int64_t n,
           int64_t d, cudaStream_t st) {
  const bool vec = (d * (int64_t)sizeof(T)) % 16 == 0 && aligned16(x) &&
                   aligned16(s) && aligned16(b) && aligned16(y);
  const int64_t cols = vec ? d / Vec<T>::N : d;
  const int64_t gx = (cols + kThreads - 1) / kThreads;
  if (gx >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  // about 8 blocks of rows per SM in all, at most one row a block
  int64_t gy = (132 * 8 + gx - 1) / gx;
  if (gy > n) gy = n;
  if (gy > 65535) gy = 65535;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(s);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  if (vec)
    sbr_vec<T><<<grid, kThreads, 0, st>>>(xp, sp, bp, yp, n, d);
  else
    sbr_scalar<T><<<grid, kThreads, 0, st>>>(xp, sp, bp, yp, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16.  x and y [n, d] contiguous; scale and bias
// [d] of the same dtype.
extern "C" int mx_scale_bias_relu(const void* x, const void* scale,
                                  const void* bias, void* y, int64_t n,
                                  int64_t d, int dtype, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, scale, bias, y, n, d, st);
    case 1: return launch<__nv_bfloat16>(x, scale, bias, y, n, d, st);
    case 2: return launch<__half>(x, scale, bias, y, n, d, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
