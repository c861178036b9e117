// Fused Adam update with its low-precision cast, over a whole list of
// parameter tensors in one launch, for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_adam_epilogue_kernel` launched by
// `fused_adam_step` through `_epilogue_call`
// (mxnet_tpu/ops/pallas_kernels.py:518, :603, :563), reached from
// `Optimizer.update_multi_precision` when the kernel tier is on.  The
// reference updates every tensor of a step inside one compiled program
// (SPMDTrainer's traced step), and MXNet has the multi-tensor op
// `multi_mp_adamw_update` (mxnet_tpu/ops/optim_ops.py:366); this is one
// launch over the list, as K1 (csrc/sgd_step.cu) is for SGD.
//
// Computes, per element of every listed tensor (lr_t, the bias-corrected
// learning rate computed by the caller in f32, and wd per tensor):
//   g' = g + wd * w
//   m' = b1 * m + (1 - b1) * g'
//   v' = b2 * v + (1 - b2) * g' * g'
//   w' = w - lr_t * m' / (sqrt(v') + eps)
// and writes the f32 master w', m', v' in place and, when the tensor has
// a cast, w' rounded once to bf16 or f16 (f16 weights are MXNet's usual
// multi_precision mode).  An f32 cast is the master's own bits (the
// reference's `nw.astype(f32)`): such a tensor has no cast pointer and
// the master is the result.  The grad is f32, bf16 or f16, widened
// exactly in registers.
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
// the grad and writes the master, m, v and the cast: 28 bytes an element
// with a 2-byte grad and a 2-byte cast (the training path), 32 with an f32
// grad and no cast (the symbolic Module's step), against 3.35 TB/s.  The
// design is for keeping that stream full across a whole step:
// - one launch for the list: a device-side table of per-tensor entries
//   (pointers, element count, lr_t, wd, flags, first block); block b finds
//   its tensor by binary search over the entries' first blocks and walks
//   one chunk of it, so the tiny LayerNorm vectors and the 24.6 M-element
//   embedding share one grid, with one fill and one tail a step;
// - each block dispatches once on its tensor's grad and cast types to a
//   loop compiled for that pair: no per-element branch on a dtype;
// - 16-byte streaming loads of w, m and v, one 8-byte load of four 2-byte
//   grads (16 bytes of an f32 grad), the cast stored as two converted
//   pairs in one 8-byte store; each thread issues the loads of kGroups
//   4-lane groups before it computes any of them;
// - a scalar loop for a tensor with a pointer not aligned to its 4-lane
//   access, and for the last n % 4 elements of an aligned one.
// Updates are in place: each element is read before it is written, by
// the same thread.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
// 4-lane groups a thread loads before it computes them
constexpr int kGroups = 2;

// flags of a table entry (the bits K1's entries use for the same things)
constexpr int kGradBf16 = 1;   // g is bf16
constexpr int kOutBf16 = 2;    // write w' as bf16 to `out`
constexpr int kVec = 8;        // every pointer aligned for 4-lane access
constexpr int kGradF16 = 16;   // g is f16 (neither grad bit: f32)
constexpr int kOutF16 = 32;    // write w' as f16 to `out` (neither: no cast)

// One table entry; 64 bytes, laid out as the wrapper's numpy record
// (cuda_kernels.ADAM_LAYOUT).
struct Entry {
  uint64_t w, g, m, v, out;
  int64_t n;
  int32_t block0;  // first block of this tensor
  float lr_t, wd;
  int32_t flags;
};
static_assert(sizeof(Entry) == 64, "table entry layout");
static_assert(offsetof(Entry, n) == 40 && offsetof(Entry, block0) == 48 &&
                  offsetof(Entry, lr_t) == 52 && offsetof(Entry, wd) == 56 &&
                  offsetof(Entry, flags) == 60,
              "table entry layout");

struct Betas {
  float b1, b2, omb1, omb2, eps;
};

__device__ __forceinline__ float adam_one(float w, float g, float* m,
                                          float* v, float lr_t, float wd,
                                          const Betas& a) {
  g = __fmaf_rn(wd, w, g);
  const float nm = __fmaf_rn(a.b1, *m, __fmul_rn(a.omb1, g));
  const float nv = __fmaf_rn(a.b2, *v, __fmul_rn(__fmul_rn(a.omb2, g), g));
  *m = nm;
  *v = nv;
  return __fsub_rn(
      w, __fdiv_rn(__fmul_rn(lr_t, nm), __fadd_rn(__fsqrt_rn(nv), a.eps)));
}

// The grad's element type: four lanes in one load, one lane widened.
template <typename G> struct Grad;
template <> struct Grad<float> {
  static __device__ __forceinline__ float4 four(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float one(const float* p) { return *p; }
};
template <> struct Grad<__nv_bfloat16> {
  static __device__ __forceinline__ float4 four(const __nv_bfloat16* p) {
    const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(p));
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};
template <> struct Grad<__half> {
  static __device__ __forceinline__ float4 four(const __half* p) {
    const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(p));
    const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
    const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ float one(const __half* p) {
    return __half2float(*p);
  }
};

// The cast's element type: four values as two rounded pairs in one 8-byte
// store, or one value.  void: no cast store (an f32 cast).
template <typename T> struct Cast;
template <> struct Cast<__nv_bfloat16> {
  static __device__ __forceinline__ void four(__nv_bfloat16* p, float4 x) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                      *reinterpret_cast<const unsigned*>(&hi)));
  }
  static __device__ __forceinline__ void one(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};
template <> struct Cast<__half> {
  static __device__ __forceinline__ void four(__half* p, float4 x) {
    const __half2 lo = __floats2half2_rn(x.x, x.y);
    const __half2 hi = __floats2half2_rn(x.z, x.w);
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                      *reinterpret_cast<const unsigned*>(&hi)));
  }
  static __device__ __forceinline__ void one(__half* p, float x) {
    *p = __float2half_rn(x);
  }
};

// One block's chunk [start, end) of one tensor, grad type G, cast type C.
template <typename G, typename C>
__device__ __forceinline__ void adam_chunk(const Entry& e, int64_t start,
                                           int64_t end, const Betas& a) {
  constexpr bool kCast = !std::is_void<C>::value;
  typedef typename std::conditional<kCast, C, __nv_bfloat16>::type T;
  float* __restrict__ w = reinterpret_cast<float*>(e.w);
  float* __restrict__ m = reinterpret_cast<float*>(e.m);
  float* __restrict__ v = reinterpret_cast<float*>(e.v);
  const G* __restrict__ g = reinterpret_cast<const G*>(e.g);
  T* __restrict__ out = reinterpret_cast<T*>(e.out);
  const float lr_t = e.lr_t, wd = e.wd;
  // the chunk is a multiple of 4 elements, so an aligned tensor's chunk
  // starts aligned
  const int64_t vend = (e.flags & kVec) ? start + (end - start) / 4 * 4
                                        : start;
  constexpr int64_t kStride = 4 * kThreads;
  for (int64_t base = start + 4 * (int64_t)threadIdx.x; base < vend;
       base += kStride * kGroups) {
    float4 w4[kGroups], m4[kGroups], v4[kGroups], g4[kGroups];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int64_t i = base + u * kStride;
      if (i < vend) {
        w4[u] = __ldcs(reinterpret_cast<const float4*>(w + i));
        m4[u] = __ldcs(reinterpret_cast<const float4*>(m + i));
        v4[u] = __ldcs(reinterpret_cast<const float4*>(v + i));
        g4[u] = Grad<G>::four(g + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int64_t i = base + u * kStride;
      if (i < vend) {
        float4 o;
        o.x = adam_one(w4[u].x, g4[u].x, &m4[u].x, &v4[u].x, lr_t, wd, a);
        o.y = adam_one(w4[u].y, g4[u].y, &m4[u].y, &v4[u].y, lr_t, wd, a);
        o.z = adam_one(w4[u].z, g4[u].z, &m4[u].z, &v4[u].z, lr_t, wd, a);
        o.w = adam_one(w4[u].w, g4[u].w, &m4[u].w, &v4[u].w, lr_t, wd, a);
        __stcs(reinterpret_cast<float4*>(w + i), o);
        __stcs(reinterpret_cast<float4*>(m + i), m4[u]);
        __stcs(reinterpret_cast<float4*>(v + i), v4[u]);
        if constexpr (kCast) Cast<T>::four(out + i, o);
      }
    }
  }
  for (int64_t i = vend + threadIdx.x; i < end; i += kThreads) {
    float mi = m[i], vi = v[i];
    const float nw = adam_one(w[i], Grad<G>::one(g + i), &mi, &vi, lr_t, wd,
                              a);
    w[i] = nw;
    m[i] = mi;
    v[i] = vi;
    if constexpr (kCast) Cast<T>::one(out + i, nw);
  }
}

template <typename G>
__device__ __forceinline__ void adam_cast(const Entry& e, int64_t start,
                                          int64_t end, const Betas& a) {
  if (e.flags & kOutBf16)
    adam_chunk<G, __nv_bfloat16>(e, start, end, a);
  else if (e.flags & kOutF16)
    adam_chunk<G, __half>(e, start, end, a);
  else
    adam_chunk<G, void>(e, start, end, a);
}

__global__ void __launch_bounds__(kThreads)
adam_multi_kernel(const Entry* __restrict__ table, int n_tensors,
                  int64_t chunk, Betas a) {
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
  if (e.flags & kGradBf16)
    adam_cast<__nv_bfloat16>(e, start, end, a);
  else if (e.flags & kGradF16)
    adam_cast<__half>(e, start, end, a);
  else
    adam_cast<float>(e, start, end, a);
}

}  // namespace

// table: device pointer to n_tensors Entry records; blocks: total blocks
// (the last entry's block0 plus its chunk count); chunk: elements per
// block, a multiple of 4.
extern "C" int mx_adam_step_multi(const void* table, int n_tensors,
                                  int blocks, long long chunk, float b1,
                                  float b2, float omb1, float omb2, float eps,
                                  void* stream) {
  if (n_tensors <= 0 || blocks <= 0 || chunk <= 0 || chunk % 4 != 0)
    return (int)cudaErrorInvalidValue;
  adam_multi_kernel<<<(unsigned)blocks, kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const Entry*>(table), n_tensors, (int64_t)chunk,
      Betas{b1, b2, omb1, omb2, eps});
  return (int)cudaGetLastError();
}

extern "C" const char* mx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
