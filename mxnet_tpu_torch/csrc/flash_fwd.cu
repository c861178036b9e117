// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces: the Pallas kernel `_flash_fwd_kernel` launched by
// `_flash_forward` (mxnet_tpu/ops/pallas_kernels.py:157, :253), reached from
// `kernels.attention` under every TransformerLM prefill layer.
//
// Computes, per (batch*head, query row):
//   o   = softmax(q k^T * scale  [+ causal -inf mask]) v     (bf16 out)
//   lse = rowmax + log(rowsum)                               (f32 out)
// with P rounded to bf16 before the P.V product, as the Pallas body does
// (pallas_kernels.py:183).  The lse strip is what the backward kernels of
// the training slice read.
//
// What bounds it on the H100: at long S the two matrix products,
// 4 * B*H * D * (S*S/2 causal pairs) FLOPs, against 989 TFLOP/s of bf16
// tensor-core rate; at short S the q/k/v/o bytes against 3.35 TB/s.
//
// What the design does about it.  The Pallas step kept a head's whole K
// and V in VMEM (512 KB at S=2048, D=64); a Hopper block has at most
// 227 KB of shared memory, so this kernel walks K/V in 64-key tiles with an
// online (FlashAttention-2) softmax rescale instead:
//   * one block per (64 query rows, batch*head); 4 warps, 16 rows each;
//   * the warp's Q fragments stay in registers for the whole key loop;
//   * each 64-key K/V tile is staged once in shared memory and read by all
//     four warps;
//   * both products run on the tensor cores through mma.sync m16n8k16
//     (bf16 x bf16 -> f32); the S accumulator is re-packed in registers as
//     the A operand of P.V, so the score tile never leaves registers;
//   * causal: key tiles wholly above the diagonal are never loaded;
//   * a masked score is -inf and a row whose running max is still -inf
//     rescales against 0, so a fully masked tile adds exact zeros (never
//     exp(0) = 1 terms).
// Not yet: wgmma, TMA, a multi-stage cp.async ring (later work).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block (4 warps x 16)
constexpr int kBlockN = 64;   // keys per tile
constexpr int kThreads = 128;
constexpr int kPad = 8;       // smem row padding (bf16): conflict-free B loads

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(16x8 f32) += A(16x16 bf16, row) * B(16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base,
                                              int row, int col, int rows,
                                              int d) {
  if (row >= rows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)row * d + col);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int sq, int skv, int causal, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockN][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockN][D + kPad];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma group: rows g and g + 8
  const int t = lane & 3;    // thread in group: column pair t * 2
  const int q0 = blockIdx.x * kBlockM;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qb = q + bh * (size_t)sq * D;
  const __nv_bfloat16* kb = k + bh * (size_t)skv * D;
  const __nv_bfloat16* vb = v + bh * (size_t)skv * D;
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;

  // A fragments of this warp's 16 query rows, all D/16 slices.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    qf[kk][0] = load_pair(qb, r0, c, sq, D);
    qf[kk][1] = load_pair(qb, r1, c, sq, D);
    qf[kk][2] = load_pair(qb, r0, c + 8, sq, D);
    qf[kk][3] = load_pair(qb, r1, c + 8, sq, D);
  }

  float oacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  // causal: keys past the block's last row are above the diagonal
  const int kend = causal ? min(skv, q0 + kBlockM) : skv;
  for (int k0 = 0; k0 < kend; k0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < kBlockN * D / 8; c += kThreads) {
      const int row = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (k0 + row < skv) {
        kx = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + row) * D +
                                             col);
        vx = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + row) * D +
                                             col);
      }
      *reinterpret_cast<uint4*>(&ks[row][col]) = kx;
      *reinterpret_cast<uint4*>(&vs[row][col]) = vx;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(
            &ks[j * 8 + g][kk * 16 + t * 2]);
        b[1] = *reinterpret_cast<const uint32_t*>(
            &ks[j * 8 + g][kk * 16 + t * 2 + 8]);
        mma_bf16(s[j], qf[kk], b);
      }
    }

    // scale, mask, tile row max
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e < 2) ? r0 : r1;
        const int key = k0 + j * 8 + t * 2 + (e & 1);
        const bool ok = key < skv && (!causal || key <= row);
        s[j][e] = ok ? s[j][e] * scale : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
    }
    float mref[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float mnew = fmaxf(m[i], mt[i]);
      // all-masked so far: rescale against 0 so exp(-inf - 0) = 0
      mref[i] = (mnew == -INFINITY) ? 0.f : mnew;
      const float corr = expf(m[i] - mref[i]);
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        oacc[n][2 * i] *= corr;
        oacc[n][2 * i + 1] *= corr;
      }
      m[i] = mnew;
    }
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mref[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    }

    // O += P V: P (bf16) re-packed from the S accumulator as A operand
#pragma unroll
    for (int kt = 0; kt < kBlockN / 16; ++kt) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      a[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      a[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      a[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
      const int key = kt * 16 + t * 2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int d = n * 8 + g;
        uint32_t b[2];
        b[0] = pack_raw(vs[key][d], vs[key + 1][d]);
        b[1] = pack_raw(vs[key + 8][d], vs[key + 9][d]);
        mma_bf16(oacc[n], a, b);
      }
    }
  }

  // finish: row sums across the 4 threads of a group, normalise, store
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? r1 : r0;
    if (row >= sq) continue;
    const float li = l[i];
    __nv_bfloat16* orow = o + (bh * (size_t)sq + row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = li > 0.f ? oacc[n][2 * i] / li : 0.f;
      const float x1 = li > 0.f ? oacc[n][2 * i + 1] / li : 0.f;
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t * 2) = pack_bf16(x0, x1);
    }
    if (t == 0) lse[bh * (size_t)sq + row] = m[i] + logf(li);
  }
}

}  // namespace

extern "C" int mx_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int bh, int sq, int skv,
                                 int d, int causal, float scale,
                                 void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(o);
  float* lp = static_cast<float*>(lse);
  // Head dim 64 only: the one head dim a served configuration has.
  if (d != 64) return (int)cudaErrorInvalidValue;
  flash_fwd_kernel<64><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, lp, sq,
                                                  skv, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* mx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
