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
// The Pallas bodies keep p and ds in f32; here both products that take
// them run on the tensor cores, so p and ds are rounded to bf16 as the A
// operand (the forward rounds p the same way).  Everything else is f32.
//
// What bounds it on the H100: at long S the matrix products — dq does 3
// (q k^T, dO v^T, ds k), dk/dv 4 (k q^T, v dO^T, p^T dO, ds^T q), each
// 2 * D FLOPs per (query, key) pair — against 989 TFLOP/s of bf16
// tensor-core rate; at short S the bytes of q, k, v, dO and the outputs.
//
// What the design does about it.  The Pallas split stays: each output is
// written by exactly one block, with no atomics, so the result is
// deterministic.
//   * dq: one block per (64 query rows, batch*head), 4 warps x 16 rows; the
//     warp's Q and dO fragments stay in registers; it walks 64-key tiles of
//     K and V staged in shared memory (keys <= the block's last row when
//     causal), and keeps S, dP and dS in registers: the dS accumulator is
//     re-packed as the A operand of dS K.
//   * dk/dv: one block per (64 keys, batch*head), 4 warps x 16 keys; the
//     warp's K and V fragments stay in registers; it walks 64-query tiles
//     of Q, dO, lse and delta staged in shared memory (queries >= the
//     block's first key when causal), computes the transposed scores, and
//     re-packs P^T and dS^T as the A operands of P^T dO and dS^T Q.
//   * mma.sync m16n8k16 (bf16 x bf16 -> f32), padded shared-memory rows,
//     64 x 64 tiles: K2f's building blocks.
//   * a masked or padded (query, key) pair gets p = 0 exactly, so it adds
//     exact zeros to every product.
// Not yet: wgmma, TMA, a cp.async pipeline, head dims other than 64.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per tile
constexpr int kBlockN = 64;   // keys per tile (== kBlockM: causal tiling)
constexpr int kThreads = 128;
constexpr int kPad = 8;       // smem row padding (bf16)

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

// A fragments of 16 rows (r0 and r0 + 8 per thread), all D/16 slices.
template <int D>
__device__ __forceinline__ void load_a(uint32_t f[D / 16][4],
                                       const __nv_bfloat16* base, int r0,
                                       int rows, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    f[kk][0] = load_pair(base, r0, c, rows, D);
    f[kk][1] = load_pair(base, r0 + 8, c, rows, D);
    f[kk][2] = load_pair(base, r0, c + 8, rows, D);
    f[kk][3] = load_pair(base, r0 + 8, c + 8, rows, D);
  }
}

// Stage rows [r0, r0 + 64) of two [rows, D] operands in shared memory,
// zero-filling rows past the end.
template <int D>
__device__ __forceinline__ void stage2(__nv_bfloat16 (*xs)[D + kPad],
                                       __nv_bfloat16 (*ys)[D + kPad],
                                       const __nv_bfloat16* xb,
                                       const __nv_bfloat16* yb, int r0,
                                       int rows, int tid) {
  for (int c = tid; c < 64 * D / 8; c += kThreads) {
    const int row = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0), y = make_uint4(0, 0, 0, 0);
    if (r0 + row < rows) {
      x = *reinterpret_cast<const uint4*>(xb + (size_t)(r0 + row) * D + col);
      y = *reinterpret_cast<const uint4*>(yb + (size_t)(r0 + row) * D + col);
    }
    *reinterpret_cast<uint4*>(&xs[row][col]) = x;
    *reinterpret_cast<uint4*>(&ys[row][col]) = y;
  }
}

// C[16 x 64] = A[16 x D] . B^T, B rows staged in shared memory: the
// 8 n-tiles of 8 B rows, each against all D/16 slices of A.
template <int D>
__device__ __forceinline__ void rows_dot(float c[8][4],
                                         const uint32_t a[D / 16][4],
                                         const __nv_bfloat16 (*bs)[D + kPad],
                                         int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[2];
      b[0] = *reinterpret_cast<const uint32_t*>(
          &bs[j * 8 + g][kk * 16 + t * 2]);
      b[1] = *reinterpret_cast<const uint32_t*>(
          &bs[j * 8 + g][kk * 16 + t * 2 + 8]);
      mma_bf16(c[j], a[kk], b);
    }
  }
}

// acc[16 x D] += X[16 x 64] . Y[64 x D]: X from the f32 accumulator
// layout of rows_dot (rounded to bf16 as the A operand), Y staged in
// shared memory row-major.
template <int D>
__device__ __forceinline__ void acc_dot(float acc[D / 8][4],
                                        const float x[8][4],
                                        const __nv_bfloat16 (*ys)[D + kPad],
                                        int g, int t) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kt][0], x[2 * kt][1]);
    a[1] = pack_bf16(x[2 * kt][2], x[2 * kt][3]);
    a[2] = pack_bf16(x[2 * kt + 1][0], x[2 * kt + 1][1]);
    a[3] = pack_bf16(x[2 * kt + 1][2], x[2 * kt + 1][3]);
    const int r = kt * 16 + t * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int d = n * 8 + g;
      uint32_t b[2];
      b[0] = pack_raw(ys[r][d], ys[r + 1][d]);
      b[1] = pack_raw(ys[r + 8][d], ys[r + 9][d]);
      mma_bf16(acc[n], a, b);
    }
  }
}

// Rows r0 and r0 + 8 of a [rows, D] bf16 output from the accumulator.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float acc[D / 8][4], int r0,
                                           int rows, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= rows) continue;
    __nv_bfloat16* orow = out + (size_t)row * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t * 2) =
          pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int sq, int skv,
                    int causal, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockN][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockN][D + kPad];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlockM;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* kb = k + bh * (size_t)skv * D;
  const __nv_bfloat16* vb = v + bh * (size_t)skv * D;
  const int r0 = q0 + warp * 16 + g;   // this thread's rows: r0, r0 + 8

  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a<D>(qf, q + bh * (size_t)sq * D, r0, sq, t);
  load_a<D>(df, dout + bh * (size_t)sq * D, r0, sq, t);
  float lrow[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    lrow[i] = row < sq ? lse[bh * (size_t)sq + row] : 0.f;
    drow[i] = row < sq ? delta[bh * (size_t)sq + row] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // causal: keys past the block's last row are above the diagonal
  const int kend = causal ? min(skv, q0 + kBlockM) : skv;
  for (int k0 = 0; k0 < kend; k0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    stage2<D>(ks, vs, kb, vb, k0, skv, tid);
    __syncthreads();

    float s[8][4], dp[8][4];
    rows_dot<D>(s, qf, ks, g, t);    // S  = Q K^T
    rows_dot<D>(dp, df, vs, g, t);   // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1);
        const int key = k0 + j * 8 + t * 2 + (e & 1);
        const bool ok = row < sq && key < skv && (!causal || key <= row);
        const float p = ok ? expf(s[j][e] * scale - lrow[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - drow[e >> 1]) * scale;   // dS
      }
    }
    acc_dot<D>(acc, s, ks, g, t);    // dQ += dS K
  }
  store_rows<D>(dq + bh * (size_t)sq * D, acc, r0, sq, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int sq, int skv,
                     int causal, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBlockM][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 dos[kBlockM][D + kPad];
  __shared__ float lse_s[kBlockM];
  __shared__ float dl_s[kBlockM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kBlockN;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qb = q + bh * (size_t)sq * D;
  const __nv_bfloat16* db = dout + bh * (size_t)sq * D;
  const int c0 = k0 + warp * 16 + g;   // this thread's keys: c0, c0 + 8

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, k + bh * (size_t)skv * D, c0, skv, t);
  load_a<D>(vf, v + bh * (size_t)skv * D, c0, skv, t);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  // causal: queries before the block's first key never see its keys
  const int qstart = causal ? k0 : 0;
  for (int i0 = qstart; i0 < sq; i0 += kBlockM) {
    __syncthreads();  // every warp is done with the previous tile
    stage2<D>(qs, dos, qb, db, i0, sq, tid);
    if (tid < kBlockM) {
      const bool in = i0 + tid < sq;
      lse_s[tid] = in ? lse[bh * (size_t)sq + i0 + tid] : 0.f;
      dl_s[tid] = in ? delta[bh * (size_t)sq + i0 + tid] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];
    rows_dot<D>(st, kf, qs, g, t);    // S^T  = K Q^T
    rows_dot<D>(dpt, vf, dos, g, t);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + 8 * (e >> 1);
        const int qi = j * 8 + t * 2 + (e & 1);
        const int query = i0 + qi;
        const bool ok = query < sq && key < skv && (!causal || key <= query);
        const float p = ok ? expf(st[j][e] * scale - lse_s[qi]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dl_s[qi]) * scale;   // dS^T
      }
    }
    acc_dot<D>(dva, st, dos, g, t);   // dV += P^T dO
    acc_dot<D>(dka, dpt, qs, g, t);   // dK += dS^T Q
  }
  store_rows<D>(dk + bh * (size_t)skv * D, dka, c0, skv, t);
  store_rows<D>(dv + bh * (size_t)skv * D, dva, c0, skv, t);
}

bool bad_dims(int bh, int sq, int skv, int d, int causal) {
  // Head dim 64 only, the one head dim a configuration has today; causal
  // attention aligns query i with key i, so it needs Sq == Skv.
  return bh <= 0 || sq <= 0 || skv <= 0 || bh > 65535 || d != 64 ||
         (causal && sq != skv);
}

}  // namespace

extern "C" int mx_flash_bwd_dq_bf16(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int bh, int sq, int skv, int d,
                                    int causal, float scale, void* stream) {
  if (bad_dims(bh, sq, skv, d, causal)) return (int)cudaErrorInvalidValue;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  flash_bwd_dq_kernel<64><<<grid, kThreads, 0,
                            reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), sq, skv, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" int mx_flash_bwd_dkv_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int bh, int sq,
                                     int skv, int d, int causal, float scale,
                                     void* stream) {
  if (bad_dims(bh, sq, skv, d, causal)) return (int)cudaErrorInvalidValue;
  const dim3 grid((skv + kBlockN - 1) / kBlockN, bh);
  flash_bwd_dkv_kernel<64><<<grid, kThreads, 0,
                             reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sq,
      skv, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* mx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
