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
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head dim: one 128-byte row of bf16
constexpr int kTile = 64;       // rows per tile (queries or keys)
constexpr int kStages = 2;      // ring depth
constexpr int kThreads = 128;  // one warpgroup
constexpr int kTileBytes = kTile * kD * 2;  // 8 KB, one TMA box
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_u32(bar))
      : "memory");
}

// Spins on the phase; a wait that never ends (a load that never lands)
// traps after ~2^26 polls, so a fault fails the launch instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (polls == (1u << 26)) asm volatile("trap;");
  }
}

// 3-D tile [1 head][64 rows][64 cols] of a [BH, rows, 64] bf16 tensor.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row,
                                              int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(row), "r"(head)
      : "memory");
}

// 1-D strip of 64 f32 from a flat [BH * S] tensor.
__device__ __forceinline__ void tma_load_strip(void* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int start) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(start)
      : "memory");
}

// wgmma shared-memory descriptor of a [64 rows][64 bf16] tile written by
// TMA with the 128-byte swizzle (1024-byte aligned): 8-row groups 1024 bytes
// apart (SBO); LBO names the next 64-wide atom, which a 64-wide tile never
// reaches.  K-major use steps 32 bytes along a row per k16 slice (+2 in
// 16-byte units); MN-major use steps 16 rows (+128).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)(kTileBytes >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
constexpr uint64_t kStepK = 32 >> 4;          // K-major k16 slice
constexpr uint64_t kStepMN = (16 * 128) >> 4;  // MN-major k16 slice

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most kPending committed groups are still running.
template <int kPending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// Keep the compiler from touching an accumulator across an async wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define MX_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define MX_OUT32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// D[64 x 64] += A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MX_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MX_OUT32(d)
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B MN-major in
// shared memory (the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MX_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MX_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// The accumulator of a [64 x 64] product, rounded to bf16, as the A
// operand of the next product over its 64 columns: k16 slice kk holds
// column tiles 2kk and 2kk + 1.
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4][4],
                                          const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// acc[i] sits at row (16 * warp + g + 8 * ((i >> 1) & 1)) and column
// (8 * (i >> 2) + 2 * t + (i & 1)) of the [64 x 64] block it accumulates.
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[32],
                                           int r0, int rows, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= rows) continue;
    bf16* orow = out + (size_t)row * kD;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t * 2) =
          pack_bf16(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
  }
}

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

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          uint64_t* resident) {
  for (int s = 0; s < kStages; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], kThreads / 32);
  }
  mbar_init(resident, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// ------------------------------------------------------------ host side
bool bad_dims(int bh, int sq, int skv, int d, int causal) {
  // Head dim 64 only, the one head dim a configuration has today; causal
  // attention aligns query i with key i, so it needs Sq == Skv.
  return bh <= 0 || sq <= 0 || skv <= 0 || bh > 65535 || d != 64 ||
         (causal && sq != skv);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no link against libcuda.
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// [BH, rows, 64] bf16 in 64 x 64 boxes, 128-byte swizzle, zeros past the
// last row of each head.
bool tile_map(CUtensorMap* map, const void* base, int bh, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)kD * 2,
                                 (cuuint64_t)rows * kD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kD, (cuuint32_t)kTile, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                     const_cast<void*>(base), dims, strides, box, estride,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// flat [n] f32 in strips of 64.
bool strip_map(CUtensorMap* map, const void* base, size_t n) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};   // unused at rank 1
  const cuuint32_t box[1] = {(cuuint32_t)kTile};
  const cuuint32_t estride[1] = {1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                     const_cast<void*>(base), dims, strides, box, estride,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_NONE,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

template <typename Smem, typename Kernel>
int set_smem(Kernel kernel) {
  return (int)cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)sizeof(Smem) + 1024);
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
