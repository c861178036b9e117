// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulate:
// two kernels, dq (K2dq) and dk/dv (K2dkv).
//
// Replaces: the Pallas kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` launched by `_flash_backward`
// (mxnet_tpu/ops/pallas_kernels.py:190, :220, :279), reached from the
// flash-attention custom VJP under every TransformerLM layer of a
// training step (`kernels.attention` with the tier on).
//
// Computes, per (batch*head), from the forward's natural-log row lse
// (flash_fwd.cu) and delta = rowsum(dO * O), which the caller computes:
//   p  = exp(q k^T * scale - lse)        (0 where the causal mask is off)
//   dv = p^T dO
//   ds = p * (dO v^T - delta) * scale
//   dq = ds k,  dk = ds^T q
// The Pallas bodies keep p and ds in f32; here the products that take them
// run on the tensor cores, so p and ds are rounded to bf16 as the register
// A operand (the forward rounds p the same way).  Everything else is f32.
//
// What bounds it on the H100: at long S the matrix products -- dq does 3
// (q k^T, dO v^T, ds k), dk/dv 4 (k q^T, v dO^T, p^T dO, ds^T q), each
// 2 * D FLOPs per (query, key) pair -- against 989 TFLOP/s of bf16
// tensor-core rate; at short S the bytes of q, k, v, dO and the outputs.
// The tensor cores reach that rate only through wgmma, with the operand
// tiles landing in shared memory while earlier products run, and with
// enough warpgroups on each SM that one's exp and mask work overlaps
// another's products.
//
// What the design does about it.  The Pallas split stays: each output row
// is written by exactly one block, with no atomics, so the result is
// deterministic.
//   * Every product is wgmma m64n64k16 (bf16 x bf16 -> f32), issued by one
//     warpgroup (4 warps, 64 rows) per block.
//   * An asynchronous ring of kStages tile slots in shared memory, each
//     with a "full" and an "empty" mbarrier.  Thread 0 issues TMA loads
//     (cp.async.bulk.tensor over tensor maps the launcher builds, 128-byte
//     swizzle, which the wgmma descriptors read as it lands); the warps
//     wait on "full", run the tile's products and arrive on "empty", and
//     thread 0 then refills that slot with the tile kStages ahead, so the
//     next tile is in flight while this one computes.  Rows past the end of
//     a ragged tile arrive as zeros (the tensor map's out-of-bounds fill).
//     There is no separate producer warp: a block's register allocation is
//     per thread, and a fifth warp would cost the dq kernel its fourth and
//     the dk/dv kernel its third resident block per SM, which measured
//     slower than the loads it would take off thread 0.
//   * dq: one block per (64 query rows, batch*head).  Q and dO stay in
//     shared memory for the whole block (loaded once); the ring streams
//     64-key tiles of K and V (keys <= the block's last row when causal).
//     S = Q K^T and dP = dO V^T read both operands from shared memory
//     (K-major); dS is formed in registers, rounded to bf16 and fed as the
//     register A operand of dQ += dS K, whose B operand is the same K tile
//     read MN-major through the descriptor's transpose bit.
//   * dk/dv: one block per (64 keys, batch*head).  K and V stay in shared
//     memory; the ring streams 64-query tiles of Q and dO with their lse
//     and delta strips (queries >= the block's first key when causal).
//     S^T = K Q^T and dP^T = V dO^T come from shared memory; P^T and dS^T
//     are fed from registers to dV += P^T dO and dK += dS^T Q, whose B
//     operands (the dO and Q tiles) are read MN-major.
//   * The wgmma accumulator layout of S (rows x 64 keys) is the register
//     layout of the A operand, so P and dS never leave registers.
//   * The two score products commit as separate groups: exp (and P^T's
//     product) runs while dP (dP^T) is still on the tensor cores.
//   * exp2 with scale * log2(e) folded in; lse is converted once per row.
//   * Causal: tiles wholly above the diagonal are never loaded; the mask is
//     evaluated only on the diagonal tile and on ragged edge tiles, where a
//     masked (query, key) pair gets p = 0 exactly, so it adds exact zeros
//     to every product.  The grid runs the heaviest blocks first (dq: the
//     last query blocks; dk/dv: the first key blocks), batch*head fastest.
//   * Registers: 4 dq blocks and 3 dk/dv blocks fit on an SM with no
//     spill; a spill of a register a wgmma reads asynchronously is not
//     safe, so chip_smoke.py refuses a build of this file that spills.
//   * Stores are masked to the real rows.
// Not yet: head dims other than 64, 128-row blocks of two warpgroups.
#include "hopper.cuh"

namespace {

constexpr int kStages = 2;      // ring depth
constexpr int kThreads = 128;  // one warpgroup

// ------------------------------------------------------------ dq kernel
struct DqSmem {
  bf16 q[kTile * kD];
  bf16 dout[kTile * kD];
  bf16 k[kStages][kTile * kD];
  bf16 v[kStages][kTile * kD];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t resident;
};

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          uint64_t* resident) {
  for (int s = 0; s < kStages; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], kThreads / 32);
  }
  mbar_init(resident, 1);
  mbar_fence_init();
}

// One tile of K and V into ring slot it % kStages (thread 0 only).
__device__ __forceinline__ void dq_load(DqSmem& sm, const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int it,
                                        int bh) {
  const int s = it % kStages;
  mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
  tma_load_tile(sm.k[s], tm_k, &sm.full[s], it * kTile, bh);
  tma_load_tile(sm.v[s], tm_v, &sm.full[s], it * kTile, bh);
}

__global__ void __launch_bounds__(kThreads, 4)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int sq, int skv, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(align1024(smem_raw));
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  // heaviest first: with causal masking the last query blocks see the
  // most keys
  const int nqb = gridDim.y;
  const int q0 = (causal ? nqb - 1 - (int)blockIdx.y : (int)blockIdx.y) *
                 kTile;
  const int kend = causal ? min(skv, q0 + kTile) : skv;
  const int ntiles = (kend + kTile - 1) / kTile;

  if (tid == 0) {
    init_ring(sm.full, sm.empty, &sm.resident);
    mbar_expect_tx(&sm.resident, 2 * kTileBytes);
    tma_load_tile(sm.q, &tm_q, &sm.resident, q0, bh);
    tma_load_tile(sm.dout, &tm_do, &sm.resident, q0, bh);
    for (int it = 0; it < min(kStages, ntiles); ++it)
      dq_load(sm, &tm_k, &tm_v, it, bh);
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = q0 + warp * 16 + g;   // this thread's rows: r0, r0 + 8
  const float scale2 = scale * kLog2e;
  float lse2[2], drow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    lse2[h] = row < sq ? lse[(size_t)bh * sq + row] * kLog2e : 0.f;
    drow[h] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }
  const uint64_t dsc_q = sw128_desc(sm.q);
  const uint64_t dsc_do = sw128_desc(sm.dout);
  float acc[32];
  zero(acc);
  mbar_wait(&sm.resident, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    const int k0 = it * kTile;
    const uint64_t dsc_k = sw128_desc(sm.k[s]);
    const uint64_t dsc_v = sw128_desc(sm.v[s]);
    mbar_wait(&sm.full[s], (it / kStages) & 1);

    float sacc[32], dpacc[32];
    zero(sacc);
    zero(dpacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // S = Q K^T
      wgmma_ss(sacc, dsc_q + kk * kStepK, dsc_k + kk * kStepK);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // dP = dO V^T
      wgmma_ss(dpacc, dsc_do + kk * kStepK, dsc_v + kk * kStepK);
    wg_commit();
    wg_wait<1>();   // S is in; P is formed while dP runs
    fence_acc(sacc);

    // the mask only where a tile crosses the diagonal or an edge
    const bool edge = (causal && k0 + kTile > q0) || k0 + kTile > skv ||
                      q0 + kTile > sq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float p = ex2(sacc[i] * scale2 - lse2[h]);
      if (edge) {
        const int row = r0 + 8 * h;
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (!(row < sq && key < skv && (!causal || key <= row))) p = 0.f;
      }
      sacc[i] = p;
    }
    wg_wait<0>();
    fence_acc(dpacc);
#pragma unroll
    for (int i = 0; i < 32; ++i)   // dS
      sacc[i] = sacc[i] * (dpacc[i] - drow[(i >> 1) & 1]) * scale;
    uint32_t ds[4][4];
    to_a_frag(ds, sacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // dQ += dS K
      wgmma_rs_mn(acc, ds[kk], dsc_k + kk * kStepMN);
    wg_commit();
    wg_wait<0>();
    fence_acc(acc);
    fence_frag(ds);
    // release the slot; once every warp has, thread 0 refills it
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
    if (tid == 0 && it + kStages < ntiles) {
      mbar_wait(&sm.empty[s], (it / kStages) & 1);
      dq_load(sm, &tm_k, &tm_v, it + kStages, bh);
    }
    __syncwarp();
  }
  store_rows(dq + (size_t)bh * sq * kD, acc, r0, sq, t);
}

// --------------------------------------------------------- dk/dv kernel
struct DkvSmem {
  bf16 k[kTile * kD];
  bf16 v[kTile * kD];
  bf16 q[kStages][kTile * kD];
  bf16 dout[kStages][kTile * kD];
  float lse[kStages][kTile];
  float delta[kStages][kTile];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t resident;
};

// One tile of Q and dO, with its lse and delta strips, into ring slot
// it % kStages (thread 0 only).  The strips are cut from a flat [BH * Sq]:
// past this head's last query they read the next head's values (or zeros
// past the end), which the mask discards.
__device__ __forceinline__ void dkv_load(DkvSmem& sm, const CUtensorMap* tm_q,
                                         const CUtensorMap* tm_do,
                                         const CUtensorMap* tm_lse,
                                         const CUtensorMap* tm_delta, int it,
                                         int qstart, int bh, int sq) {
  const int s = it % kStages;
  const int i0 = qstart + it * kTile;
  mbar_expect_tx(&sm.full[s], 2 * kTileBytes + 2 * kTile * 4);
  tma_load_tile(sm.q[s], tm_q, &sm.full[s], i0, bh);
  tma_load_tile(sm.dout[s], tm_do, &sm.full[s], i0, bh);
  tma_load_strip(sm.lse[s], tm_lse, &sm.full[s], bh * sq + i0);
  tma_load_strip(sm.delta[s], tm_delta, &sm.full[s], bh * sq + i0);
}

__global__ void __launch_bounds__(kThreads, 3)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_lse,
                     const __grid_constant__ CUtensorMap tm_delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int sq,
                     int skv, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(align1024(smem_raw));
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  // heaviest first: with causal masking the first key blocks see the most
  // queries
  const int k0 = blockIdx.y * kTile;
  const int qstart = causal ? k0 : 0;
  const int ntiles = sq > qstart ? (sq - qstart + kTile - 1) / kTile : 0;

  if (tid == 0) {
    init_ring(sm.full, sm.empty, &sm.resident);
    mbar_expect_tx(&sm.resident, 2 * kTileBytes);
    tma_load_tile(sm.k, &tm_k, &sm.resident, k0, bh);
    tma_load_tile(sm.v, &tm_v, &sm.resident, k0, bh);
    for (int it = 0; it < min(kStages, ntiles); ++it)
      dkv_load(sm, &tm_q, &tm_do, &tm_lse, &tm_delta, it, qstart, bh, sq);
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int c0 = k0 + warp * 16 + g;   // this thread's keys: c0, c0 + 8
  const float scale2 = scale * kLog2e;
  float dka[32], dva[32];
  zero(dka);
  zero(dva);
  const uint64_t dsc_k = sw128_desc(sm.k);
  const uint64_t dsc_v = sw128_desc(sm.v);
  mbar_wait(&sm.resident, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    const int i0 = qstart + it * kTile;
    const uint64_t dsc_q = sw128_desc(sm.q[s]);
    const uint64_t dsc_do = sw128_desc(sm.dout[s]);
    mbar_wait(&sm.full[s], (it / kStages) & 1);

    float st[32], dpt[32];
    zero(st);
    zero(dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // S^T = K Q^T
      wgmma_ss(st, dsc_k + kk * kStepK, dsc_q + kk * kStepK);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // dP^T = V dO^T
      wgmma_ss(dpt, dsc_v + kk * kStepK, dsc_do + kk * kStepK);
    wg_commit();
    wg_wait<1>();   // S^T is in; P^T and dV go while dP^T runs
    fence_acc(st);

    const bool edge = (causal && i0 < k0 + kTile) || i0 + kTile > sq ||
                      k0 + kTile > skv;
    const float* ls = sm.lse[s];
    const float* dl = sm.delta[s];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qi = 8 * (i >> 2) + 2 * t + (i & 1);   // query i0 + qi
      float p = ex2(st[i] * scale2 - ls[qi] * kLog2e);
      if (edge) {
        const int key = c0 + 8 * ((i >> 1) & 1);
        const int query = i0 + qi;
        if (!(query < sq && key < skv && (!causal || key <= query)))
          p = 0.f;
      }
      st[i] = p;
    }
    uint32_t pa[4][4], dsa[4][4];
    to_a_frag(pa, st);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // dV += P^T dO
      wgmma_rs_mn(dva, pa[kk], dsc_do + kk * kStepMN);
    wg_commit();
    wg_wait<1>();   // dP^T is in (dV may still run)
    fence_acc(dpt);
#pragma unroll
    for (int i = 0; i < 32; ++i) {   // dS^T
      const int qi = 8 * (i >> 2) + 2 * t + (i & 1);
      dpt[i] = st[i] * (dpt[i] - dl[qi]) * scale;
    }
    to_a_frag(dsa, dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // dK += dS^T Q
      wgmma_rs_mn(dka, dsa[kk], dsc_q + kk * kStepMN);
    wg_commit();
    wg_wait<0>();
    fence_acc(dva);
    fence_acc(dka);
    fence_frag(pa);
    fence_frag(dsa);
    // release the slot; once every warp has, thread 0 refills it
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
    if (tid == 0 && it + kStages < ntiles) {
      mbar_wait(&sm.empty[s], (it / kStages) & 1);
      dkv_load(sm, &tm_q, &tm_do, &tm_lse, &tm_delta, it + kStages, qstart,
               bh, sq);
    }
    __syncwarp();
  }
  store_rows(dk + (size_t)bh * skv * kD, dka, c0, skv, t);
  store_rows(dv + (size_t)bh * skv * kD, dva, c0, skv, t);
}

}  // namespace

extern "C" int mx_flash_bwd_dq_bf16(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int bh, int sq, int skv, int d,
                                    int causal, float scale, void* stream) {
  if (bad_dims(bh, sq, skv, d, causal)) return (int)cudaErrorInvalidValue;
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout))
    return (int)cudaErrorMisalignedAddress;
  if (encode_fn() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!tile_map(&tq, q, bh, sq) || !tile_map(&tk, k, bh, skv) ||
      !tile_map(&tv, v, bh, skv) || !tile_map(&tdo, dout, bh, sq))
    return (int)cudaErrorInvalidValue;
  const int err = set_smem<DqSmem>(flash_bwd_dq_kernel);
  if (err != 0) return err;
  const dim3 grid(bh, (sq + kTile - 1) / kTile);
  flash_bwd_dq_kernel<<<grid, kThreads, sizeof(DqSmem) + 1024,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), sq, skv,
      causal, scale);
  return (int)cudaGetLastError();
}

extern "C" int mx_flash_bwd_dkv_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int bh, int sq,
                                     int skv, int d, int causal, float scale,
                                     void* stream) {
  if (bad_dims(bh, sq, skv, d, causal)) return (int)cudaErrorInvalidValue;
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout) ||
      misaligned(lse) || misaligned(delta))
    return (int)cudaErrorMisalignedAddress;
  if (encode_fn() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo, tl, td;
  if (!tile_map(&tq, q, bh, sq) || !tile_map(&tk, k, bh, skv) ||
      !tile_map(&tv, v, bh, skv) || !tile_map(&tdo, dout, bh, sq) ||
      !strip_map(&tl, lse, (size_t)bh * sq) ||
      !strip_map(&td, delta, (size_t)bh * sq))
    return (int)cudaErrorInvalidValue;
  const int err = set_smem<DkvSmem>(flash_bwd_dkv_kernel);
  if (err != 0) return err;
  const dim3 grid(bh, (skv + kTile - 1) / kTile);
  flash_bwd_dkv_kernel<<<grid, kThreads, sizeof(DkvSmem) + 1024,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, tl, td, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sq, skv, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* mx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
