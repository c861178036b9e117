// Paged-attention decode for Hopper (sm_90a): one query row per
// (batch, head) against its page-gathered context, bf16 or int8 K/V.
//
// Replaces: the Pallas kernel `_paged_attn_kernel` launched by
// `pallas_paged_attention` (mxnet_tpu/ops/pallas_kernels.py:386, :422),
// reached from `kernels.paged_attention` under every TransformerLM decode
// layer.  As there, pages are gathered outside the kernel
// (models/transformer.py decode_step); folding the page-table gather into
// the kernel is later work.
//
// Computes, per (b, h):
//   o = softmax(q . k_j * scale over valid[b, j]) . v_j        (bf16 out)
// int8 form: k_j = k8_j * k_scale[b, h, j] (f32), likewise v, dequantised
// in registers right after the load, so HBM carries int8 bytes only.
//
// What bounds it on the H100: HBM bytes.  Each valid key costs
// 2 * D * (2 bytes bf16 | 1 byte int8 + 4-byte scale) and only 4*D FLOPs,
// far below the ~295 FLOP/byte ridge, so the floor is
// B*H*valid*D*2*elem bytes over 3.35 TB/s.
//
// What the design does about it.  The Pallas block held a row's whole
// gathered context in VMEM; at K=2048 one (b, h) row's K and V no longer
// fit the way a single Hopper tile would want, and nothing carries over
// between blocks, so:
//   * one block of 4 warps per (b, h); inside it, groups of D/8 lanes each
//     take one key at a time, every lane loading 8 contiguous elements
//     (16 B bf16 / 8 B int8), so one key row is one coalesced segment;
//   * each group walks its keys in chunks of 4 with a running (max, sum)
//     in f32 (online softmax), issuing the chunk's 8 row loads before any
//     arithmetic so loads stay in flight;
//   * masked keys are never loaded (valid is a prefix on the serving
//     path, so the bytes read track the real context length), their score
//     is -inf, and a group whose running max is still -inf rescales
//     against 0: an all-masked chunk adds exact zeros, never exp(0) = 1;
//   * the block's 16 partial (max, sum, acc) triples (D=64) merge once
//     through shared memory at the end.
// Rounding: P stays f32 and the output is cast to bf16 once; the Pallas
// body rounded P to v.dtype and divided in it (pallas_kernels.py:417-419).
// Not yet: splitting one (b, h) over several blocks (96 blocks fill 96 of
// 132 SMs at B=8, H=12), TMA bulk loads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;     // elements per lane per key
constexpr int kChunk = 4;   // keys per group per step

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out,
                                         float) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_row(const int8_t* p, float* out,
                                         float s) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int8_t x = static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xff);
    out[i] = static_cast<float>(x) * s;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    __nv_bfloat16* __restrict__ o, int heads, int kctx,
                    float scale) {
  constexpr int kLanes = D / kVec;          // lanes per key
  constexpr int kGroupsW = 32 / kLanes;     // key groups per warp
  constexpr int kGroups = kWarps * kGroupsW;
  constexpr bool kQuant = sizeof(T) == 1;
  __shared__ float sm_m[kGroups];
  __shared__ float sm_l[kGroups];
  __shared__ float sm_acc[kGroups][D];

  const size_t bh = blockIdx.x;
  const int b = static_cast<int>(bh / heads);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % kLanes;
  const int gw = lane / kLanes;
  const int grp = warp * kGroupsW + gw;
  const int d0 = sub * kVec;

  float qv[kVec];
  load_row(q + bh * D + d0, qv, 1.f);
  const T* kb = k + bh * (size_t)kctx * D + d0;
  const T* vb = v + bh * (size_t)kctx * D + d0;
  const uint8_t* vmask = valid + (size_t)b * kctx;
  const float* ksb = kQuant ? k_scale + bh * (size_t)kctx : nullptr;
  const float* vsb = kQuant ? v_scale + bh * (size_t)kctx : nullptr;

  float m = -INFINITY, l = 0.f;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;

  // the trip count is uniform across a warp (shuffles need every lane)
  for (int base = warp * kGroupsW * kChunk; base < kctx;
       base += kWarps * kGroupsW * kChunk) {
    const int j0 = base + gw * kChunk;
    float kf[kChunk][kVec], vf[kChunk][kVec];
    bool ok[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int j = j0 + c;
      ok[c] = j < kctx && vmask[j] != 0;
      if (ok[c]) {
        load_row(kb + (size_t)j * D, kf[c], kQuant ? ksb[j] : 1.f);
        load_row(vb + (size_t)j * D, vf[c], kQuant ? vsb[j] : 1.f);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kf[c][i] = vf[c][i] = 0.f;
      }
    }
    float sc[kChunk];
    float cmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) part = fmaf(qv[i], kf[c][i], part);
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      sc[c] = ok[c] ? part * scale : -INFINITY;
      cmax = fmaxf(cmax, sc[c]);
    }
    const float mnew = fmaxf(m, cmax);
    const float mref = (mnew == -INFINITY) ? 0.f : mnew;
    const float corr = expf(m - mref);
    l *= corr;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] *= corr;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float p = expf(sc[c] - mref);
      l += p;
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(p, vf[c][i], acc[i]);
    }
    m = mnew;
  }

  // merge the groups' partial softmax states
#pragma unroll
  for (int i = 0; i < kVec; ++i) sm_acc[grp][d0 + i] = acc[i];
  if (sub == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float mx = -INFINITY;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) mx = fmaxf(mx, sm_m[gi]);
    const float mref = (mx == -INFINITY) ? 0.f : mx;
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const float w = expf(sm_m[gi] - mref);
      lt = fmaf(sm_l[gi], w, lt);
      at = fmaf(sm_acc[gi][d], w, at);
    }
    o[bh * D + d] = __float2bfloat16_rn(lt > 0.f ? at / lt : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid,
           const void* ks, const void* vs, void* o, int batch, int heads,
           int kctx, int d, float scale, cudaStream_t st) {
  const dim3 grid(batch * heads);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const uint8_t* mp = static_cast<const uint8_t*>(valid);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(o);
  // Head dim 64 only: the one head dim a served configuration has.
  if (d != 64) return (int)cudaErrorInvalidValue;
  paged_decode_kernel<T, 64><<<grid, kThreads, 0, st>>>(
      qp, kp, vp, mp, ksp, vsp, op, heads, kctx, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mx_paged_decode(const void* q, const void* k, const void* v,
                               const void* valid, const void* k_scale,
                               const void* v_scale, void* o, int batch,
                               int heads, int kctx, int d, int quant,
                               float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || kctx <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (quant) {
    if (k_scale == nullptr || v_scale == nullptr)
      return (int)cudaErrorInvalidValue;
    return launch<int8_t>(q, k, v, valid, k_scale, v_scale, o, batch, heads,
                          kctx, d, scale, st);
  }
  return launch<__nv_bfloat16>(q, k, v, valid, nullptr, nullptr, o, batch,
                               heads, kctx, d, scale, st);
}

extern "C" const char* mx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
