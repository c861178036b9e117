// Fused SGD(+momentum) update with its cast, over a whole list of
// parameter tensors in one launch, for Hopper (sm_90a).
//
// Replaces: the Pallas kernels `_sgd_epilogue_kernel` and
// `_sgd_nomom_epilogue_kernel` launched by `fused_sgd_step` through
// `_epilogue_call` (mxnet_tpu/ops/pallas_kernels.py:495, :509, :576,
// :563), reached from `SPMDTrainer._build` and
// `Optimizer.update_multi_precision` when the kernel tier is on.  The
// multi-tensor launch mirrors the reference MXNet op
// `multi_mp_sgd_mom_update` (mxnet_tpu/ops/optim_ops.py:258).
//
// Computes, per element of every listed tensor (lr, wd per tensor):
//   g' = g + wd * w
//   m' = momentum * m + lr * g'        w' = w - m'     (momentum != 0)
//   w' = w - lr * g'                                   (momentum == 0)
// and writes the f32 master w' and momentum m' in place, plus w' cast to
// the tensor's out type (bf16 or f16, rounded once, or a separate f32
// copy) when it has one.  The grad is f32, bf16 or f16 (MXNet's
// multi_precision update over f16 weights), widened exactly.
//
// Rounding.  The jitted reference's compiler contracts the multiply-adds
// (and so does its Pallas body in interpret mode): g' = fma(wd, w, g),
// m' = fma(momentum, m, lr * g'), w' = w - m', and without momentum
// w' = fma(-lr, g', w).  Every step is written as an intrinsic so nvcc
// cannot choose otherwise; the result matches `fused_sgd_step_plain` and
// the reference bit for bit.  Do not build with --use_fast_math.
//
// What bounds it on the H100: bytes.  Per element it reads w, g (f32,
// bf16 or f16, widened exactly in registers) and m, and writes w and m:
// 20 bytes with an f32 grad (16 without momentum), plus 2 or 4 for a
// cast copy.  Against 3.35 TB/s.  The list is a device-side table of
// per-tensor entries (pointers, element count, lr, wd, flags, first
// block); block b finds its tensor by binary search over the entries'
// first blocks and walks one chunk of it, so the tiny BatchNorm vectors
// and the 2.4 M-element 3x3 convolutions share one grid and one launch.
// Inside a chunk: 16-byte vector loads where every pointer of the tensor
// is aligned, a scalar tail.  Updates are in place: each element is read before it is
// written, by the same thread.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// flags of a table entry
constexpr int kGradBf16 = 1;   // g is bf16
constexpr int kOutBf16 = 2;    // write w' as bf16 to `out`
constexpr int kOutF32 = 4;     // write w' as a separate f32 copy to `out`
constexpr int kVec = 8;        // every pointer aligned for 4-wide access
constexpr int kGradF16 = 16;   // g is f16 (neither bit: f32)
constexpr int kOutF16 = 32;    // write w' as f16 to `out`

// One table entry; 64 bytes, laid out as the wrapper's numpy record
// (cuda_kernels.SGD_LAYOUT).
struct Entry {
  uint64_t w, g, m, out;
  int64_t n;
  int32_t block0;  // first block of this tensor
  float lr, wd;
  int32_t flags;
  int64_t pad;
};
static_assert(sizeof(Entry) == 64, "table entry layout");
static_assert(offsetof(Entry, n) == 32 && offsetof(Entry, block0) == 40 &&
                  offsetof(Entry, lr) == 44 && offsetof(Entry, wd) == 48 &&
                  offsetof(Entry, flags) == 52,
              "table entry layout");

__device__ __forceinline__ float sgd_one(float w, float g, float* m,
                                         float lr, float wd, float momentum,
                                         int has_mom) {
  g = __fmaf_rn(wd, w, g);
  if (has_mom) {
    const float nm = __fmaf_rn(momentum, *m, __fmul_rn(lr, g));
    *m = nm;
    return __fsub_rn(w, nm);
  }
  return __fmaf_rn(-lr, g, w);
}

__device__ __forceinline__ float4 load_grad4(uint64_t g, int64_t i,
                                             int flags) {
  if (flags & kGradBf16) {
    const __nv_bfloat162* p =
        reinterpret_cast<const __nv_bfloat162*>(g) + 2 * (i / 4);
    const float2 lo = __bfloat1622float2(p[0]);
    const float2 hi = __bfloat1622float2(p[1]);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  if (flags & kGradF16) {
    const __half2* p = reinterpret_cast<const __half2*>(g) + 2 * (i / 4);
    const float2 lo = __half22float2(p[0]);
    const float2 hi = __half22float2(p[1]);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return reinterpret_cast<const float4*>(g)[i / 4];
}

__device__ __forceinline__ float load_grad(uint64_t g, int64_t i, int flags) {
  if (flags & kGradBf16)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(g)[i]);
  if (flags & kGradF16)
    return __half2float(reinterpret_cast<const __half*>(g)[i]);
  return reinterpret_cast<const float*>(g)[i];
}

__global__ void __launch_bounds__(kThreads)
sgd_multi_kernel(const Entry* __restrict__ table, int n_tensors,
                 int64_t chunk, float momentum, int has_mom) {
  __shared__ int s_tensor;
  if (threadIdx.x == 0) {
    // the last entry whose first block is <= blockIdx.x
    int lo = 0, hi = n_tensors - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (table[mid].block0 <= (int)blockIdx.x) lo = mid; else hi = mid - 1;
    }
    s_tensor = lo;
  }
  __syncthreads();
  const Entry e = table[s_tensor];
  const int64_t start = (int64_t)((int)blockIdx.x - e.block0) * chunk;
  const int64_t end = start + chunk < e.n ? start + chunk : e.n;
  float* w = reinterpret_cast<float*>(e.w);
  float* m = reinterpret_cast<float*>(e.m);
  // chunk is a multiple of 4, so a chunk of an aligned tensor starts aligned
  const int64_t vend = (e.flags & kVec) ? start + (end - start) / 4 * 4
                                        : start;
  for (int64_t i = start + 4 * (int64_t)threadIdx.x; i < vend;
       i += 4 * kThreads) {
    float4 w4 = *reinterpret_cast<const float4*>(w + i);
    const float4 g4 = load_grad4(e.g, i, e.flags);
    float4 m4 = has_mom ? *reinterpret_cast<const float4*>(m + i)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    w4.x = sgd_one(w4.x, g4.x, &m4.x, e.lr, e.wd, momentum, has_mom);
    w4.y = sgd_one(w4.y, g4.y, &m4.y, e.lr, e.wd, momentum, has_mom);
    w4.z = sgd_one(w4.z, g4.z, &m4.z, e.lr, e.wd, momentum, has_mom);
    w4.w = sgd_one(w4.w, g4.w, &m4.w, e.lr, e.wd, momentum, has_mom);
    *reinterpret_cast<float4*>(w + i) = w4;
    if (has_mom) *reinterpret_cast<float4*>(m + i) = m4;
    if (e.flags & kOutBf16) {
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(e.out) + i / 2;
      o[0] = __floats2bfloat162_rn(w4.x, w4.y);
      o[1] = __floats2bfloat162_rn(w4.z, w4.w);
    } else if (e.flags & kOutF16) {
      __half2* o = reinterpret_cast<__half2*>(e.out) + i / 2;
      o[0] = __floats2half2_rn(w4.x, w4.y);
      o[1] = __floats2half2_rn(w4.z, w4.w);
    } else if (e.flags & kOutF32) {
      reinterpret_cast<float4*>(e.out)[i / 4] = w4;
    }
  }
  for (int64_t i = vend + threadIdx.x; i < end; i += kThreads) {
    float mi = has_mom ? m[i] : 0.f;
    const float nw = sgd_one(w[i], load_grad(e.g, i, e.flags), &mi, e.lr, e.wd,
                             momentum, has_mom);
    w[i] = nw;
    if (has_mom) m[i] = mi;
    if (e.flags & kOutBf16) {
      reinterpret_cast<__nv_bfloat16*>(e.out)[i] = __float2bfloat16_rn(nw);
    } else if (e.flags & kOutF16) {
      reinterpret_cast<__half*>(e.out)[i] = __float2half_rn(nw);
    } else if (e.flags & kOutF32) {
      reinterpret_cast<float*>(e.out)[i] = nw;
    }
  }
}

}  // namespace

// table: device pointer to n_tensors Entry records; blocks: total blocks
// (the last entry's block0 plus its chunk count); chunk: elements per
// block, a multiple of 4.
extern "C" int mx_sgd_step_multi(const void* table, int n_tensors, int blocks,
                                 long long chunk, float momentum, int has_mom,
                                 void* stream) {
  if (n_tensors <= 0 || blocks <= 0 || chunk <= 0 || chunk % 4 != 0)
    return (int)cudaErrorInvalidValue;
  sgd_multi_kernel<<<(unsigned)blocks, kThreads, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const Entry*>(table), n_tensors, (int64_t)chunk, momentum,
      has_mom);
  return (int)cudaGetLastError();
}

extern "C" const char* mx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
