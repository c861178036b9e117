// Row softmax, forward and backward, for Hopper (sm_90a).
//
// Replaces: the Pallas kernels `_row_softmax_kernel` (forward) and
// `_row_softmax_bwd_kernel` (backward), launched by `_softmax_fwd_call`
// and `_softmax_bwd_call` (mxnet_tpu/ops/pallas_kernels.py:66, :80, :94,
// :112) behind the registered op `pallas_softmax` (:142) and its custom
// VJP (`_row_softmax`, :125).
//
// Forward, per row of x [n, d]:
//   m = max_j x_j,  l = sum_j exp(x_j - m),  y_j = exp(x_j - m) / l
// and writes y, m and l, all in x's dtype (f32, bf16 or f16); every step
// runs in f32.  The backward reads m and l as they were rounded, as the
// reference's does:
//   y_j = exp(x_j - m) / l,  dot = sum_j dy_j * y_j,  dx_j = y_j (dy_j - dot)
//
// What bounds it on the H100: bytes.  The forward reads x once and writes
// y once (plus 2 values a row); the backward reads x and dy and writes dx.
// Each kernel makes two passes over its row(s): pass 1 reduces (the
// forward an online (max, sum), the backward the dot), pass 2 writes.  The
// second read is left to L2: a block works on one row (at most 128 KB for
// a 32,000-column f32 row) and 132 SMs hold ~132-264 rows in flight,
// under the 50 MB L2, so pass 2 finds its row there; the row is not staged
// in shared memory.
//
// Two layouts of the work:
//   * d <= 1024: one warp per row, 8 rows per 256-thread block (a block
//     per row would leave most of its threads idle on LeNet's [64, 10]);
//     reductions by warp shuffles.
//   * d > 1024: one block per row (1024 threads); reductions by warp
//     shuffles, then through shared memory.
// Loads are 16 bytes wide (4 f32 or 8 bf16/f16) where a row is 16-byte
// aligned (d * itemsize % 16 == 0 and the bases aligned), else scalar.
// The online pass rescales once per 16-byte chunk (1.25 exp an element).
// exp is expf (no fast math: __expf would move the result off the plain
// version).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kWarpRowsThreads = 256;  // 8 warps, one row each
constexpr int kBlockRowThreads = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f(float v) {
  return __float2half_rn(v);
}

// 16 bytes of T, loaded and stored as one vector
template <typename T> struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// (max, sum of exp(x - max)) merged
__device__ __forceinline__ void merge(float& m, float& s, float om,
                                      float os) {
  const float nm = fmaxf(m, om);
  if (nm == -INFINITY) return;  // both empty (or all -inf so far)
  s = s * expf(m - nm) + os * expf(om - nm);
  m = nm;
}

// Fold a chunk of `k` values into the running (m, s).
template <int K>
__device__ __forceinline__ void fold(float& m, float& s, const float* x) {
  float cm = x[0];
#pragma unroll
  for (int e = 1; e < K; ++e) cm = fmaxf(cm, x[e]);
  const float nm = fmaxf(m, cm);
  if (nm == -INFINITY) return;
  float cs = 0.f;
#pragma unroll
  for (int e = 0; e < K; ++e) cs += expf(x[e] - nm);
  s = s * expf(m - nm) + cs;
  m = nm;
}

__device__ __forceinline__ void warp_merge(float& m, float& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float os = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, om, os);
  }
  // lane 0's result for all: a contracted multiply-add makes merge(a, b)
  // and merge(b, a) differ in the last bit
  m = __shfl_sync(0xffffffffu, m, 0);
  s = __shfl_sync(0xffffffffu, s, 0);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// Block-wide merge of (m, s) over all warps; every thread gets the result.
__device__ __forceinline__ void block_merge(float& m, float& s) {
  __shared__ float sm[32], ss[32];
  warp_merge(m, s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  m = lane < nwarps ? sm[lane] : -INFINITY;
  s = lane < nwarps ? ss[lane] : 0.f;
  warp_merge(m, s);
  __syncthreads();  // the shared slots may be reused by the caller
}

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float sv[32];
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) sv[warp] = v;
  __syncthreads();
  v = lane < nwarps ? sv[lane] : 0.f;
  v = warp_sum(v);
  __syncthreads();
  return v;
}

// ------------------------------------------------------------- forward
// One row, walked by `nthr` threads (a warp or a block), thread `t`.
template <typename T, bool VEC>
__device__ __forceinline__ void row_stats(const T* x, int64_t d, int t,
                                          int nthr, float& m, float& s) {
  m = -INFINITY;
  s = 0.f;
  if (VEC) {
    constexpr int N = Vec<T>::N;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
    const int64_t nv = d / N;
    for (int64_t i = t; i < nv; i += nthr) {
      const Vec<T> c = xv[i];
      float f[N];
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = to_f(c.v[e]);
      fold<N>(m, s, f);
    }
  } else {
    for (int64_t i = t; i < d; i += nthr) {
      const float f = to_f(x[i]);
      fold<1>(m, s, &f);
    }
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void row_write(const T* x, T* y, int64_t d,
                                          int t, int nthr, float m,
                                          float l) {
  if (VEC) {
    constexpr int N = Vec<T>::N;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
    Vec<T>* yv = reinterpret_cast<Vec<T>*>(y);
    const int64_t nv = d / N;
    for (int64_t i = t; i < nv; i += nthr) {
      const Vec<T> c = xv[i];
      Vec<T> o;
#pragma unroll
      for (int e = 0; e < N; ++e)
        o.v[e] = from_f<T>(expf(to_f(c.v[e]) - m) / l);
      yv[i] = o;
    }
  } else {
    for (int64_t i = t; i < d; i += nthr)
      y[i] = from_f<T>(expf(to_f(x[i]) - m) / l);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarpRowsThreads)
softmax_fwd_warp(const T* __restrict__ x, T* __restrict__ y,
                 T* __restrict__ mo, T* __restrict__ lo, int64_t n,
                 int64_t d) {
  const int64_t row = (int64_t)blockIdx.x * (kWarpRowsThreads / 32) +
                      (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * d;
  float m, s;
  row_stats<T, VEC>(xr, d, lane, 32, m, s);
  warp_merge(m, s);
  row_write<T, VEC>(xr, y + row * d, d, lane, 32, m, s);
  if (lane == 0) {
    mo[row] = from_f<T>(m);
    lo[row] = from_f<T>(s);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kBlockRowThreads)
softmax_fwd_block(const T* __restrict__ x, T* __restrict__ y,
                  T* __restrict__ mo, T* __restrict__ lo, int64_t d) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  float m, s;
  row_stats<T, VEC>(xr, d, threadIdx.x, blockDim.x, m, s);
  block_merge(m, s);
  row_write<T, VEC>(xr, y + row * d, d, threadIdx.x, blockDim.x, m, s);
  if (threadIdx.x == 0) {
    mo[row] = from_f<T>(m);
    lo[row] = from_f<T>(s);
  }
}

// ------------------------------------------------------------ backward
template <typename T, bool VEC>
__device__ __forceinline__ float row_dot(const T* x, const T* dy, int64_t d,
                                         int t, int nthr, float m, float l) {
  float acc = 0.f;
  if (VEC) {
    constexpr int N = Vec<T>::N;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
    const Vec<T>* gv = reinterpret_cast<const Vec<T>*>(dy);
    const int64_t nv = d / N;
    for (int64_t i = t; i < nv; i += nthr) {
      const Vec<T> c = xv[i], g = gv[i];
#pragma unroll
      for (int e = 0; e < N; ++e)
        acc += to_f(g.v[e]) * (expf(to_f(c.v[e]) - m) / l);
    }
  } else {
    for (int64_t i = t; i < d; i += nthr)
      acc += to_f(dy[i]) * (expf(to_f(x[i]) - m) / l);
  }
  return acc;
}

template <typename T, bool VEC>
__device__ __forceinline__ void row_dx(const T* x, const T* dy, T* dx,
                                       int64_t d, int t, int nthr, float m,
                                       float l, float dot) {
  if (VEC) {
    constexpr int N = Vec<T>::N;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
    const Vec<T>* gv = reinterpret_cast<const Vec<T>*>(dy);
    Vec<T>* ov = reinterpret_cast<Vec<T>*>(dx);
    const int64_t nv = d / N;
    for (int64_t i = t; i < nv; i += nthr) {
      const Vec<T> c = xv[i], g = gv[i];
      Vec<T> o;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float yv = expf(to_f(c.v[e]) - m) / l;
        o.v[e] = from_f<T>(yv * (to_f(g.v[e]) - dot));
      }
      ov[i] = o;
    }
  } else {
    for (int64_t i = t; i < d; i += nthr) {
      const float yv = expf(to_f(x[i]) - m) / l;
      dx[i] = from_f<T>(yv * (to_f(dy[i]) - dot));
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarpRowsThreads)
softmax_bwd_warp(const T* __restrict__ x, const T* __restrict__ mi,
                 const T* __restrict__ li, const T* __restrict__ dy,
                 T* __restrict__ dx, int64_t n, int64_t d) {
  const int64_t row = (int64_t)blockIdx.x * (kWarpRowsThreads / 32) +
                      (threadIdx.x >> 5);
  if (row >= n) return;
  const int lane = threadIdx.x & 31;
  const float m = to_f(mi[row]), l = to_f(li[row]);
  const int64_t off = row * d;
  const float dot = warp_sum(row_dot<T, VEC>(x + off, dy + off, d, lane, 32,
                                             m, l));
  row_dx<T, VEC>(x + off, dy + off, dx + off, d, lane, 32, m, l, dot);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kBlockRowThreads)
softmax_bwd_block(const T* __restrict__ x, const T* __restrict__ mi,
                  const T* __restrict__ li, const T* __restrict__ dy,
                  T* __restrict__ dx, int64_t d) {
  const int64_t row = blockIdx.x;
  const float m = to_f(mi[row]), l = to_f(li[row]);
  const int64_t off = row * d;
  const float dot = block_sum(row_dot<T, VEC>(x + off, dy + off, d,
                                              threadIdx.x, blockDim.x, m, l));
  row_dx<T, VEC>(x + off, dy + off, dx + off, d, threadIdx.x, blockDim.x, m,
                 l, dot);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch_fwd(const void* x, void* y, void* m, void* l, int64_t n,
               int64_t d, cudaStream_t st) {
  const bool vec = (d * (int64_t)sizeof(T)) % 16 == 0 && aligned16(x) &&
                   aligned16(y);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  T* mp = static_cast<T*>(m);
  T* lp = static_cast<T*>(l);
  if (d <= 1024) {
    const int64_t blocks = (n + 7) / 8;
    if (vec)
      softmax_fwd_warp<T, true><<<(unsigned)blocks, kWarpRowsThreads, 0,
                                  st>>>(xp, yp, mp, lp, n, d);
    else
      softmax_fwd_warp<T, false><<<(unsigned)blocks, kWarpRowsThreads, 0,
                                   st>>>(xp, yp, mp, lp, n, d);
  } else {
    if (vec)
      softmax_fwd_block<T, true><<<(unsigned)n, kBlockRowThreads, 0, st>>>(
          xp, yp, mp, lp, d);
    else
      softmax_fwd_block<T, false><<<(unsigned)n, kBlockRowThreads, 0, st>>>(
          xp, yp, mp, lp, d);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* m, const void* l, const void* dy,
               void* dx, int64_t n, int64_t d, cudaStream_t st) {
  const bool vec = (d * (int64_t)sizeof(T)) % 16 == 0 && aligned16(x) &&
                   aligned16(dy) && aligned16(dx);
  const T* xp = static_cast<const T*>(x);
  const T* mp = static_cast<const T*>(m);
  const T* lp = static_cast<const T*>(l);
  const T* gp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(dx);
  if (d <= 1024) {
    const int64_t blocks = (n + 7) / 8;
    if (vec)
      softmax_bwd_warp<T, true><<<(unsigned)blocks, kWarpRowsThreads, 0,
                                  st>>>(xp, mp, lp, gp, op, n, d);
    else
      softmax_bwd_warp<T, false><<<(unsigned)blocks, kWarpRowsThreads, 0,
                                   st>>>(xp, mp, lp, gp, op, n, d);
  } else {
    if (vec)
      softmax_bwd_block<T, true><<<(unsigned)n, kBlockRowThreads, 0, st>>>(
          xp, mp, lp, gp, op, d);
    else
      softmax_bwd_block<T, false><<<(unsigned)n, kBlockRowThreads, 0, st>>>(
          xp, mp, lp, gp, op, d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16.  n rows of d columns, contiguous; m and l
// hold n values of the same dtype.
extern "C" int mx_row_softmax_fwd(const void* x, void* y, void* m, void* l,
                                  int64_t n, int64_t d, int dtype,
                                  void* stream) {
  if (n <= 0 || d <= 0 || n >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fwd<float>(x, y, m, l, n, d, st);
    case 1: return launch_fwd<__nv_bfloat16>(x, y, m, l, n, d, st);
    case 2: return launch_fwd<__half>(x, y, m, l, n, d, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int mx_row_softmax_bwd(const void* x, const void* m,
                                  const void* l, const void* dy, void* dx,
                                  int64_t n, int64_t d, int dtype,
                                  void* stream) {
  if (n <= 0 || d <= 0 || n >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bwd<float>(x, m, l, dy, dx, n, d, st);
    case 1: return launch_bwd<__nv_bfloat16>(x, m, l, dy, dx, n, d, st);
    case 2: return launch_bwd<__half>(x, m, l, dy, dx, n, d, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
