// Paged-attention decode for Hopper (sm_90a): one query row per
// (batch, head) against its context, read through the page table straight
// from the page pool, bf16 or int8 K/V, split over the keys.
//
// Replaces: the Pallas kernel `_paged_attn_kernel` launched by
// `pallas_paged_attention` (mxnet_tpu/ops/pallas_kernels.py:386, :422),
// reached from `kernels.paged_attention_pool` under every TransformerLM
// decode layer (and `kernels.paged_attention`, the reference-shaped entry
// over a gathered context).  The reference gathers the pages outside its
// kernel (mxnet_tpu/models/transformer.py decode_step), a fused XLA gather
// on the TPU; here that gather would be separate copies of the whole
// table width, so this kernel reads the pool itself.
//
// Computes, per (b, h), over keys j < lengths[b] (or where valid[b, j]):
//   o = softmax(q . k_j * scale) . v_j                      (bf16 out)
// where key j lives in page table[b, j / psz], slot j % psz of the pool.
// int8 form: k_j = k8_j * k_scale[page, slot, h] (f32), likewise v,
// dequantised in registers right after the load, so HBM carries int8
// bytes only.
//
// One kernel, two layouts: the addresses are page * page_stride +
// slot * slot_stride + h * head_stride, so the pool [pool, psz, H, D]
// (a slot holds all H heads; a page is one contiguous run) and a gathered
// [B, H, K, D] context (a "page" per sequence, no table) are both read in
// place.  A table entry outside [0, pool) is clamped into it, as the plain
// gather clamps; entries past a sequence's length are never read.
//
// What bounds it on the H100: HBM bytes.  Each valid key costs
// 2 * D * (2 bytes bf16 | 1 byte int8 + 4-byte scale) and only 4*D FLOPs,
// far below the ~295 FLOP/byte ridge, so the floor is
// sum_b lengths[b] * H * D * 2 * elem bytes over 3.35 TB/s.
//
// What the design does about it:
//   * split-K: a block takes one (b, h) and one range of keys_per_split
//     keys; the caller picks the split count so that B*H*splits blocks
//     cover the 132 SMs several times over at any batch and width.  Keys
//     past a sequence's length are skipped, so a block whose whole range
//     lies past it only records an empty partial;
//   * inside a block, groups of D/8 lanes each take one key at a time,
//     every lane loading 8 contiguous elements (16 B bf16 / 8 B int8), so
//     one key row is one coalesced segment; each group walks its keys in
//     chunks of 4 with a running (max, sum) in f32 (online softmax),
//     issuing the chunk's 8 row loads before any arithmetic, so loads stay
//     in flight;
//   * a masked key is never loaded, its score is -inf, and a group whose
//     running max is still -inf rescales against 0: an all-masked chunk
//     adds exact zeros, never exp(0) = 1;
//   * the block's 16 partial (max, sum, acc) triples (D=64) merge through
//     shared memory; with one split that is the output.  With several,
//     each block writes its partial to a workspace, and the last block of
//     a (b, h) to finish (an atomic count, reset by that block for the
//     next launch; the launcher keeps one count buffer a stream, so the
//     launches sharing one are ordered) merges all partials in split
//     order: the same bits
//     whichever block finishes last, so greedy decode stays deterministic.
// Rounding: scores and P stay f32 and the output is cast to bf16 once; the
// Pallas body rounded P to v.dtype and divided in it
// (pallas_kernels.py:417-419).
// Not yet: TMA bulk loads of whole pages into shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;      // head dim
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;     // elements per lane per key
constexpr int kChunk = 4;   // keys per group per step
constexpr int kLanes = kD / kVec;          // lanes per key
constexpr int kGroupsW = 32 / kLanes;     // key groups per warp
constexpr int kGroups = kWarps * kGroupsW;
constexpr int kPart = kD + 2;             // workspace floats per partial

// Where keys live, in elements: key (page, slot) of head h starts at
// page * page + slot * slot + h * head; scales likewise (s_*).
struct Geom {
  int heads, width, psz, pool, kctx, keys_per_split, nsplit;
  long long page, slot, head, s_page, s_slot, s_head;
};

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths,
                    const uint8_t* __restrict__ valid,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ part,
                    unsigned* __restrict__ counters, Geom geo, float scale) {
  constexpr bool kQuant = sizeof(T) == 1;
  __shared__ float sm_m[kGroups];
  __shared__ float sm_l[kGroups];
  __shared__ float sm_acc[kGroups][kD];
  __shared__ unsigned s_last;

  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / geo.heads;
  const int h = bh - b * geo.heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % kLanes;
  const int gw = lane / kLanes;
  const int grp = warp * kGroupsW + gw;
  const int d0 = sub * kVec;

  int n = geo.kctx;
  if (lengths != nullptr) n = min(max(lengths[b], 0), geo.kctx);
  const int j_lo = split * geo.keys_per_split;
  const int j_hi = min(j_lo + geo.keys_per_split, n);
  const int* trow = table != nullptr ? table + (size_t)b * geo.width : nullptr;
  const uint8_t* vrow = valid != nullptr ? valid + (size_t)b * geo.kctx
                                         : nullptr;

  float qv[kVec];
  load_row(q + (size_t)bh * kD + d0, qv, 1.f);
  float m = -INFINITY, l = 0.f;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;

  // the trip count is uniform across a warp (shuffles need every lane)
  for (int base = j_lo + warp * kGroupsW * kChunk; base < j_hi;
       base += kWarps * kGroupsW * kChunk) {
    const int j0 = base + gw * kChunk;
    float kf[kChunk][kVec], vf[kChunk][kVec];
    bool ok[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int j = j0 + c;
      ok[c] = j < j_hi && (vrow == nullptr || vrow[j] != 0);
      if (ok[c]) {
        const int pi = j / geo.psz;
        const int slot = j - pi * geo.psz;
        int page = trow != nullptr ? trow[pi] : b;
        page = min(max(page, 0), geo.pool - 1);
        const long long at = page * geo.page + slot * geo.slot +
                             h * geo.head + d0;
        float ks = 1.f, vs = 1.f;
        if (kQuant) {
          const long long sat =
              page * geo.s_page + slot * geo.s_slot + h * geo.s_head;
          ks = k_scale[sat];
          vs = v_scale[sat];
        }
        load_row(k + at, kf[c], ks);
        load_row(v + at, vf[c], vs);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kf[c][i] = vf[c][i] = 0.f;
      }
    }
    float sc[kChunk];
    float cmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot = fmaf(qv[i], kf[c][i], dot);
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      sc[c] = ok[c] ? dot * scale : -INFINITY;
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

  // merge the groups' partial softmax states into the block's
#pragma unroll
  for (int i = 0; i < kVec; ++i) sm_acc[grp][d0 + i] = acc[i];
  if (sub == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
  __syncthreads();
  const int d = threadIdx.x;   // one output column a thread (kD < kThreads)
  float bm = -INFINITY, bl = 0.f, ba = 0.f;
  if (d < kD) {
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) bm = fmaxf(bm, sm_m[gi]);
    const float mref = (bm == -INFINITY) ? 0.f : bm;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const float w = expf(sm_m[gi] - mref);
      bl = fmaf(sm_l[gi], w, bl);
      ba = fmaf(sm_acc[gi][d], w, ba);
    }
  }
  if (geo.nsplit == 1) {
    if (d < kD) o[(size_t)bh * kD + d] = __float2bfloat16_rn(
        bl > 0.f ? ba / bl : 0.f);
    return;
  }

  // several splits: publish this block's partial; the last block of the
  // (b, h) merges them all, in split order
  float* mine = part + ((size_t)bh * geo.nsplit + split) * kPart;
  if (d < kD) mine[d] = ba;
  if (d == 0) {
    mine[kD] = bm;
    mine[kD + 1] = bl;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&counters[bh], 1u) == (unsigned)(geo.nsplit - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (d < kD) {
    const float* all = part + (size_t)bh * geo.nsplit * kPart;
    float mx = -INFINITY;
    for (int s = 0; s < geo.nsplit; ++s)
      mx = fmaxf(mx, __ldcg(all + s * kPart + kD));
    const float mref = (mx == -INFINITY) ? 0.f : mx;
    float lt = 0.f, at = 0.f;
    for (int s = 0; s < geo.nsplit; ++s) {
      const float w = expf(__ldcg(all + s * kPart + kD) - mref);
      lt = fmaf(__ldcg(all + s * kPart + kD + 1), w, lt);
      at = fmaf(__ldcg(all + s * kPart + d), w, at);
    }
    o[(size_t)bh * kD + d] = __float2bfloat16_rn(lt > 0.f ? at / lt : 0.f);
  }
  if (threadIdx.x == 0) counters[bh] = 0u;   // ready for the next launch
}

}  // namespace

// q [B*H, 64] bf16; k/v and their f32 scales (int8 only) as Geom
// describes; table [B, width] int32 or null (page = b, the gathered
// layout); lengths [B] int32 or valid [B, width * psz] bool (exactly one);
// part [B*H, nsplit, 66] f32 and counters [B*H] u32 (zero) when nsplit > 1.
extern "C" int mx_paged_decode(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* lengths,
    const void* valid, void* o, void* part, void* counters, int batch,
    int heads, int width, int psz, int pool, int d, int keys_per_split,
    int nsplit, long long page, long long slot, long long head,
    long long s_page, long long s_slot, long long s_head, int quant,
    float scale, void* stream) {
  const long long kctx = (long long)width * psz;
  if (batch <= 0 || heads <= 0 || width <= 0 || psz <= 0 || pool <= 0 ||
      d != kD || kctx >= (1LL << 31) || (long long)batch * heads > 65535 ||
      keys_per_split <= 0 || nsplit <= 0 ||
      (long long)keys_per_split * nsplit < kctx ||
      (lengths == nullptr) == (valid == nullptr) ||
      (nsplit > 1 && (part == nullptr || counters == nullptr)) ||
      (quant && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Geom geo{heads,  width, psz,    pool,   (int)kctx, keys_per_split,
                 nsplit, page,  slot,   head,   s_page,    s_slot,
                 s_head};
  const dim3 grid(nsplit, batch * heads);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const float* ksp = static_cast<const float*>(k_scale);
  const float* vsp = static_cast<const float*>(v_scale);
  const int* tp = static_cast<const int*>(table);
  const int* lp = static_cast<const int*>(lengths);
  const uint8_t* mp = static_cast<const uint8_t*>(valid);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(o);
  float* pp = static_cast<float*>(part);
  unsigned* cp = static_cast<unsigned*>(counters);
  if (quant)
    paged_decode_kernel<int8_t><<<grid, kThreads, 0, st>>>(
        qp, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v), ksp,
        vsp, tp, lp, mp, op, pp, cp, geo, scale);
  else
    paged_decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        qp, static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), nullptr, nullptr, tp, lp, mp,
        op, pp, cp, geo, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* mx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
