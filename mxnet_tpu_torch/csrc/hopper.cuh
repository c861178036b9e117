// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): mbarriers, TMA tile loads over tensor maps
// the host encodes, and wgmma m64n64k16 (bf16 x bf16 -> f32) with its
// shared-memory descriptors, for [64 rows][64 bf16] tiles of a
// [batch*head, rows, 64] tensor written by TMA with the 128-byte swizzle.
//
// Everything here sits in an anonymous namespace: each source that
// includes it builds into its own library with its own copy.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head dim: one 128-byte row of bf16
constexpr int kTile = 64;       // rows per tile (queries or keys)
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

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
// (8 * (i >> 2) + 2 * t + (i & 1)) of the [64 x 64] block it accumulates
// (warp: the warp within its warpgroup; g = lane / 4, t = lane % 4).
// Rows at or past `rows` are not stored.
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

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// ------------------------------------------------------------ host side
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no link against libcuda.
inline EncodeTiledFn encode_fn() {
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
inline bool tile_map(CUtensorMap* map, const void* base, int bh, int rows) {
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
inline bool strip_map(CUtensorMap* map, const void* base, size_t n) {
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

inline bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

// Head dim 64 only, the one head dim a configuration has today; causal
// attention aligns query i with key i, so it needs Sq == Skv.
inline bool bad_dims(int bh, int sq, int skv, int d, int causal) {
  return bh <= 0 || sq <= 0 || skv <= 0 || bh > 65535 || d != 64 ||
         (causal && sq != skv);
}

template <typename Smem, typename Kernel>
inline int set_smem(Kernel kernel) {
  return (int)cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)sizeof(Smem) + 1024);
}

}  // namespace
