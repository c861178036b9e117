// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces: the Pallas kernel `_flash_fwd_kernel` launched by
// `_flash_forward` (mxnet_tpu/ops/pallas_kernels.py:157, :253), reached from
// `kernels.attention` under every TransformerLM prefill layer and every
// layer of a training step.
//
// Computes, per (batch*head, query row):
//   o   = softmax(q k^T * scale  [+ causal mask]) v          (bf16 out)
//   lse = rowmax + log(rowsum)                  (natural log, f32 out)
// with P rounded to bf16 before the P.V product, as the Pallas body does
// (pallas_kernels.py:183).  The lse strip [B*H, Sq] is what the backward
// kernels (flash_bwd.cu) read.
//
// What bounds it on the H100: at long S the two matrix products,
// 4 * B*H * D * (S*S/2 causal pairs) FLOPs, against 989 TFLOP/s of bf16
// tensor-core rate; at short S the q/k/v/o bytes against 3.35 TB/s.  The
// tensor cores reach that rate only through wgmma, with the K/V tiles
// landing in shared memory while earlier products run, and with enough
// warpgroups on each SM that one's exp work overlaps another's products.
//
// What the design does about it (the machinery of flash_bwd.cu, shared
// through hopper.cuh):
//   * One warpgroup (4 warps, 128 threads) a block, over 64 query rows,
//     five blocks an SM.  (Two warpgroups a block sharing each K/V tile,
//     two blocks an SM, measured slower on the H100: PERF.md, PR 7.)
//   * Both products are wgmma m64n64k16 (bf16 x bf16 -> f32).  S = Q K^T
//     reads Q (loaded once per block) and the K tile from shared memory,
//     K-major, in the 128-byte swizzle TMA writes.  O += P V takes P from
//     the S accumulator's registers, rounded to bf16, as the A operand
//     (the accumulator layout is the A-operand layout), and reads the V
//     tile MN-major through the descriptor's transpose bit.
//   * K/V tiles stream through a ring of kStages slots in shared memory,
//     each with a "full" and an "empty" mbarrier.  Thread 0 issues the TMA
//     loads
//     (cp.async.bulk.tensor over tensor maps the launcher builds); the
//     warps wait on "full", run the tile and arrive on "empty", and that
//     thread refills the slot with the tile kStages ahead.  Rows past a
//     ragged end arrive as zeros (the tensor map's out-of-bounds fill).
//   * Online softmax with exp2 and scale * log2(e) folded into the scores;
//     a masked score is -inf and gives p = 0 exactly, and a row whose
//     running max is still -inf rescales against 0, so a fully masked
//     tile adds exact zeros.  lse goes back to natural log once per row.
//   * Causal: tiles wholly above the diagonal are never loaded; the mask
//     is evaluated only on diagonal and ragged tiles.
//     The grid runs the heaviest query blocks (the last) first, with
//     batch*head fastest.
//   * Registers: no spill at 5 warpgroups an SM; a spill of a register a
//     wgmma reads asynchronously is not safe, so chip_smoke.py refuses a
//     build of this file that spills.
//   * Stores are masked to the real rows; the lse strip is written by one
//     thread per row, since Sq * 4 bytes need not be a multiple of 16.
//   * Within a warpgroup the products and the softmax run in turn; the
//     overlap comes from the other warpgroups on the SM.  Issuing tile i's
//     S beside tile i-1's P V (FlashAttention-3's intra-warpgroup overlap,
//     with separate K and V rings) measured clearly slower on the H100:
//     it needs 127 registers a thread, and so fewer warpgroups an SM.
// Not yet: head dims other than 64; a producer warpgroup with setmaxnreg.
#include "hopper.cuh"
#include "nan_max.cuh"

namespace {

constexpr int kStages = 2;   // ring depth
constexpr float kLn2 = 0.6931471805599453f;

struct FwdSmem {
  bf16 q[kTile * kD];
  bf16 k[kStages][kTile * kD];
  bf16 v[kStages][kTile * kD];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t resident;
};

// One K and one V tile into ring slot it % kStages (the loading thread).
__device__ __forceinline__ void kv_load(FwdSmem& sm, const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int it,
                                        int bh) {
  const int s = it % kStages;
  mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
  tma_load_tile(sm.k[s], tm_k, &sm.full[s], it * kTile, bh);
  tma_load_tile(sm.v[s], tm_v, &sm.full[s], it * kTile, bh);
}

// Five blocks an SM (96 registers a thread, 41 KB of shared memory each;
// faster on the H100 than four at 109 registers).
__global__ void __launch_bounds__(128, 5)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 bf16* __restrict__ o, float* __restrict__ lse, int sq,
                 int skv, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(align1024(smem_raw));
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  // heaviest first: with causal masking the last query blocks see the
  // most keys
  const int nqb = gridDim.y;
  const int q0 = (causal ? nqb - 1 - (int)blockIdx.y : (int)blockIdx.y) *
                 kTile;
  const int ntiles = ((causal ? min(skv, q0 + kTile) : skv) + kTile - 1) /
                     kTile;
  const bool loader = tid == 0;

  if (loader) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4);   // one arrival a warp
    }
    mbar_init(&sm.resident, 1);
    mbar_fence_init();
    mbar_expect_tx(&sm.resident, kTileBytes);
    tma_load_tile(sm.q, &tm_q, &sm.resident, q0, bh);
    for (int it = 0; it < min(kStages, ntiles); ++it)
      kv_load(sm, &tm_k, &tm_v, it, bh);
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = q0 + warp * 16 + g;   // this thread's rows: r0, r0 + 8
  const float scale2 = scale * kLog2e;
  const uint64_t dsc_q = sw128_desc(sm.q);
  float oacc[32];
  zero(oacc);
  float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
  float l[2] = {0.f, 0.f};               // this thread's share of the sum
  mbar_wait(&sm.resident, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    const int k0 = it * kTile;
    mbar_wait(&sm.full[s], (it / kStages) & 1);

    float sacc[32];
    zero(sacc);
    wg_fence();
    const uint64_t dsc_k = sw128_desc(sm.k[s]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // S = Q K^T
      wgmma_ss(sacc, dsc_q + kk * kStepK, dsc_k + kk * kStepK);
    wg_commit();
    wg_wait<0>();
    fence_acc(sacc);

    // the mask only where a tile crosses the diagonal or the ragged end
    const bool edge = (causal && k0 + kTile > q0) || k0 + kTile > skv;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float x = sacc[i] * scale2;
      if (edge) {
        const int row = r0 + 8 * h;
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (!(key < skv && (!causal || key <= row))) x = -INFINITY;
      }
      sacc[i] = x;
      mt[h] = fmax_nan(mt[h], x);
    }
    float mref[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmax_nan(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmax_nan(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float mnew = fmax_nan(m[h], mt[h]);
      // all masked so far: rescale against 0, so exp2(-inf - 0) = 0
      mref[h] = mnew == -INFINITY ? 0.f : mnew;
      const float corr = ex2(m[h] - mref[h]);
      l[h] *= corr;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        oacc[4 * n + 2 * h] *= corr;
        oacc[4 * n + 2 * h + 1] *= corr;
      }
      m[h] = mnew;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const float p = ex2(sacc[i] - mref[h]);
      l[h] += p;
      sacc[i] = p;
    }
    uint32_t pa[4][4];
    to_a_frag(pa, sacc);
    wg_fence();
    const uint64_t dsc_v = sw128_desc(sm.v[s]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // O += P V
      wgmma_rs_mn(oacc, pa[kk], dsc_v + kk * kStepMN);
    wg_commit();
    wg_wait<0>();
    fence_acc(oacc);
    fence_frag(pa);
    // release the slot; once every warp has, the loader refills it
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
    if (loader && it + kStages < ntiles) {
      mbar_wait(&sm.empty[s], (it / kStages) & 1);
      kv_load(sm, &tm_k, &tm_v, it + kStages, bh);
    }
    __syncwarp();
  }

  // row sums across the 4 threads of a group, normalise, store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float li = l[(i >> 1) & 1];
    // a NaN sum passes through, as the reference's divide lets it
    oacc[i] = li == 0.f ? 0.f : oacc[i] / li;
  }
  store_rows(o + (size_t)bh * sq * kD, oacc, r0, sq, t);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row < sq) lse[(size_t)bh * sq + row] = m[h] * kLn2 + logf(l[h]);
    }
  }
}

}  // namespace

extern "C" int mx_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int bh, int sq, int skv,
                                 int d, int causal, float scale,
                                 void* stream) {
  if (bad_dims(bh, sq, skv, d, causal)) return (int)cudaErrorInvalidValue;
  if (misaligned(q) || misaligned(k) || misaligned(v))
    return (int)cudaErrorMisalignedAddress;
  if (encode_fn() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tile_map(&tq, q, bh, sq) || !tile_map(&tk, k, bh, skv) ||
      !tile_map(&tv, v, bh, skv))
    return (int)cudaErrorInvalidValue;
  const int err = set_smem<FwdSmem>(flash_fwd_kernel);
  if (err != 0) return err;
  const dim3 grid(bh, (sq + kTile - 1) / kTile);
  flash_fwd_kernel<<<grid, 128, sizeof(FwdSmem) + 1024,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), sq, skv,
      causal, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* mx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
