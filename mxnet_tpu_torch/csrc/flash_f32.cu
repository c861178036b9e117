// Flash attention in f32 for Hopper (sm_90a): the forward and the two
// backward kernels at head dim 64, f32 operands with f32 accumulation on
// the CUDA cores (FFMA).  No TF32: TF32 keeps 10 mantissa bits, which is
// not the f32 the reference's kernels compute in.
//
// Replaces: for f32 inputs, the Pallas kernels `_flash_fwd_kernel`
// (launched by `_flash_forward`), `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` (launched by `_flash_backward`)
// (mxnet_tpu/ops/pallas_kernels.py:157, :190, :220; :265, :293, :305),
// reached from `kernels.attention` in every layer of an f32 model (BERT's
// `--dtype float32` pretraining).  bf16 inputs go to flash_fwd.cu and
// flash_bwd.cu.
//
// Computes, per (batch*head, query row), as those kernels do in f32:
//   forward:  o = softmax(q k^T * scale [causal: -1e30 above the
//             diagonal]) v, lse = rowmax + log(rowsum) (natural log);
//   dq:       p = exp(s*scale - lse), ds = p * (dO v^T - delta) * scale,
//             dq = ds k;
//   dk, dv:   dv = p^T dO, dk = ds^T q;
// with delta = rowsum(dO * O) computed outside (cuda_kernels.flash_delta).
//
// What bounds it on the H100: the products, 2 (forward) to 4 (dk/dv)
// f32 products of 2 * 64 FLOPs per (query, key) pair, against 67 TFLOP/s
// of f32 FMA rate outside the tensor cores; at BERT's S = 128 the
// q/k/v/o bytes against 3.35 TB/s come close.
//
// The design is the simple one: a block of 256 threads owns one 64-row
// tile (64 queries in the forward and dq, 64 keys in dk/dv) and walks the
// other side in 64-row tiles staged in shared memory (rows padded to 65
// floats, so both the row-wise and the column-wise reads of a tile are
// free of bank conflicts).  Each thread holds a 4x4 micro-tile of every
// 64x64 product (rows ty + 16i, columns tx + 16j) and accumulates it with
// FFMA.  The forward keeps the online softmax's running max and sum per
// row in registers; a row's 16 threads sit in one half-warp and reduce
// with shuffles.  Causal: tiles wholly above the diagonal are skipped
// (they add exact zeros); keys past a ragged end get p = 0 and rows past
// it are neither used nor stored.  No atomics: two launches give the same
// bits.  Not yet: tensor cores (3xTF32 split products), head dims other
// than 64.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;         // tile rows
constexpr int kD = 64;         // head dim
constexpr int kLd = kD + 1;    // padded shared-memory row (floats)
constexpr int kThreads = 256;
constexpr int kTileFloats = kT * kLd;
constexpr float kNeg = -1e30f;  // the reference's masked score

// Rows [r0, r0 + 64) of a row-major [n, 64] matrix into a padded tile;
// rows past n are zero.
__device__ __forceinline__ void load_tile(float* sm, const float* g, int r0,
                                          int n) {
  for (int i = threadIdx.x; i < kT * kD / 4; i += kThreads) {
    const int r = i / (kD / 4);
    const int c = (i % (kD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      x = *reinterpret_cast<const float4*>(g + (size_t)(r0 + r) * kD + c);
    float* d = sm + r * kLd + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// acc[i][j] = sum_d A[ty + 16i][d] * B[tx + 16j][d]   (A B^T)
__device__ __forceinline__ void mm_nt(float acc[4][4], const float* A,
                                      const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k P[ty + 16i][k] * X[k][tx + 16j]   (P X)
__device__ __forceinline__ void mm_nn_acc(float acc[4][4], const float* P,
                                          const float* X, int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < kT; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[(ty + 16 * i) * kLd + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = X[k * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_q P[q][ty + 16i] * X[q][tx + 16j]   (P^T X)
__device__ __forceinline__ void mm_tn_acc(float acc[4][4], const float* P,
                                          const float* X, int ty, int tx) {
#pragma unroll 8
  for (int q = 0; q < kT; ++q) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[q * kLd + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = X[q * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Max / sum over the 16 threads (one half-warp) that share a row.
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The 4x4 micro-tile of a 64x64 block written to a padded tile.
__device__ __forceinline__ void put(float* sm, const float v[4][4], int ty,
                                    int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sm[(ty + 16 * i) * kLd + tx + 16 * j] = v[i][j];
}

// Rows r0 + ty + 16i (< n) of a row-major [n, 64] output.
__device__ __forceinline__ void store_rows(float* g, const float v[4][4],
                                           int r0, int n, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) g[(size_t)r * kD + tx + 16 * j] = v[i][j];
  }
}

// Key tiles a causal query tile at q0 reads: those with a key <= its last
// query.
__device__ __forceinline__ int kv_tiles(int q0, int skv, int causal) {
  const int n = (skv + kT - 1) / kT;
  return causal ? min(n, q0 / kT + 1) : n;
}

__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int sq, int skv, int causal,
                         float scale) {
  extern __shared__ float sm[];
  float* qs = sm;
  float* ks = qs + kTileFloats;
  float* vs = ks + kTileFloats;
  float* ps = vs + kTileFloats;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* kb = k + (size_t)bh * skv * kD;
  const float* vb = v + (size_t)bh * skv * kD;
  load_tile(qs, q + (size_t)bh * sq * kD, q0, sq);
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const int nt = kv_tiles(q0, skv, causal);
  for (int it = 0; it < nt; ++it) {
    const int k0 = it * kT;
    __syncthreads();  // the last tile's reads of ks, vs and ps are done
    load_tile(ks, kb, k0, skv);
    load_tile(vs, vb, k0, skv);
    __syncthreads();
    float s[4][4];
    mm_nt(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= skv)
          x = -INFINITY;  // past the ragged end: not a key
        else if (causal && col > row)
          x = kNeg;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      const float mn = fmaxf(m[i], row_max16(mt));
      const float alpha = expf(m[i] - mn);  // 0 at the first tile
      m[i] = mn;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum16(rs);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    put(ps, s, ty, tx);
    __syncthreads();
    mm_nn_acc(acc, ps, vs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] / l[i];
    if (tx == 0 && row < sq) lse[(size_t)bh * sq + row] = m[i] + logf(l[i]);
  }
  store_rows(o + (size_t)bh * sq * kD, acc, q0, sq, ty, tx);
}

// p and ds of one 64x64 (query, key) block from its scores and dO v^T;
// rows past sq and keys past skv get 0.
__device__ __forceinline__ void probs(float s[4][4], float dp[4][4],
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta,
                                      int q0, int k0, int sq, int skv,
                                      int causal, float scale, int ty,
                                      int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool live = row < sq;
    const float ls = live ? lse[row] : 0.f;
    const float dl = live ? delta[row] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      float x = s[i][j] * scale;
      if (causal && col > row) x = kNeg;
      const float p = (live && col < skv) ? expf(x - ls) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl) * scale;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int sq, int skv,
                            int causal, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;
  float* dos = qs + kTileFloats;
  float* ks = dos + kTileFloats;
  float* vs = ks + kTileFloats;
  float* dss = vs + kTileFloats;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* kb = k + (size_t)bh * skv * kD;
  const float* vb = v + (size_t)bh * skv * kD;
  load_tile(qs, q + (size_t)bh * sq * kD, q0, sq);
  load_tile(dos, dout + (size_t)bh * sq * kD, q0, sq);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int nt = kv_tiles(q0, skv, causal);
  for (int it = 0; it < nt; ++it) {
    const int k0 = it * kT;
    __syncthreads();
    load_tile(ks, kb, k0, skv);
    load_tile(vs, vb, k0, skv);
    __syncthreads();
    float s[4][4], ds[4][4];
    mm_nt(s, qs, ks, ty, tx);
    mm_nt(ds, dos, vs, ty, tx);
    probs(s, ds, lse + (size_t)bh * sq, delta + (size_t)bh * sq, q0, k0, sq,
          skv, causal, scale, ty, tx);
    put(dss, ds, ty, tx);
    __syncthreads();
    mm_nn_acc(acc, dss, ks, ty, tx);  // dq += ds k
  }
  store_rows(dq + (size_t)bh * sq * kD, acc, q0, sq, ty, tx);
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int sq, int skv, int causal, float scale) {
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + kTileFloats;
  float* qs = vs + kTileFloats;
  float* dos = qs + kTileFloats;
  float* ps = dos + kTileFloats;
  float* dss = ps + kTileFloats;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* qb = q + (size_t)bh * sq * kD;
  const float* db = dout + (size_t)bh * sq * kD;
  load_tile(ks, k + (size_t)bh * skv * kD, k0, skv);
  load_tile(vs, v + (size_t)bh * skv * kD, k0, skv);
  float dka[4][4], dva[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;
  const int nq = (sq + kT - 1) / kT;
  // causal: query tiles from the one holding query k0 (Sq == Skv)
  for (int t = causal ? k0 / kT : 0; t < nq; ++t) {
    const int q0 = t * kT;
    __syncthreads();
    load_tile(qs, qb, q0, sq);
    load_tile(dos, db, q0, sq);
    __syncthreads();
    float s[4][4], ds[4][4];
    mm_nt(s, qs, ks, ty, tx);   // rows: queries, columns: keys
    mm_nt(ds, dos, vs, ty, tx);
    probs(s, ds, lse + (size_t)bh * sq, delta + (size_t)bh * sq, q0, k0, sq,
          skv, causal, scale, ty, tx);
    put(ps, s, ty, tx);
    put(dss, ds, ty, tx);
    __syncthreads();
    mm_tn_acc(dva, ps, dos, ty, tx);  // dv += p^T dO
    mm_tn_acc(dka, dss, qs, ty, tx);  // dk += ds^T q
  }
  store_rows(dk + (size_t)bh * skv * kD, dka, k0, skv, ty, tx);
  store_rows(dv + (size_t)bh * skv * kD, dva, k0, skv, ty, tx);
}

inline bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

// Head dim 64 only; causal aligns query i with key i, so Sq == Skv.
inline bool bad_dims(int bh, int sq, int skv, int d, int causal) {
  return bh <= 0 || sq <= 0 || skv <= 0 || bh > 65535 || d != kD ||
         (causal && sq != skv) || (sq + kT - 1) / kT > 65535 ||
         (skv + kT - 1) / kT > 65535;
}

template <typename Kernel>
inline int set_smem(Kernel kernel, int tiles) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tiles * kTileFloats * (int)sizeof(float));
}

}  // namespace

extern "C" int mx_flash_fwd_f32(const void* q, const void* k, const void* v,
                                void* o, void* lse, int bh, int sq, int skv,
                                int d, int causal, float scale,
                                void* stream) {
  if (bad_dims(bh, sq, skv, d, causal)) return (int)cudaErrorInvalidValue;
  if (misaligned(q) || misaligned(k) || misaligned(v))
    return (int)cudaErrorMisalignedAddress;
  const int err = set_smem(flash_fwd_f32_kernel, 4);
  if (err != 0) return err;
  const dim3 grid(bh, (sq + kT - 1) / kT);
  flash_fwd_f32_kernel<<<grid, kThreads, 4 * kTileFloats * sizeof(float),
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), sq, skv, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" int mx_flash_bwd_dq_f32(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int bh, int sq, int skv, int d,
                                   int causal, float scale, void* stream) {
  if (bad_dims(bh, sq, skv, d, causal)) return (int)cudaErrorInvalidValue;
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout))
    return (int)cudaErrorMisalignedAddress;
  const int err = set_smem(flash_bwd_dq_f32_kernel, 5);
  if (err != 0) return err;
  const dim3 grid(bh, (sq + kT - 1) / kT);
  flash_bwd_dq_f32_kernel<<<grid, kThreads, 5 * kTileFloats * sizeof(float),
                            reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), sq, skv, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" int mx_flash_bwd_dkv_f32(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int bh, int sq,
                                    int skv, int d, int causal, float scale,
                                    void* stream) {
  if (bad_dims(bh, sq, skv, d, causal)) return (int)cudaErrorInvalidValue;
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout))
    return (int)cudaErrorMisalignedAddress;
  const int err = set_smem(flash_bwd_dkv_f32_kernel, 6);
  if (err != 0) return err;
  const dim3 grid(bh, (skv + kT - 1) / kT);
  flash_bwd_dkv_f32_kernel<<<grid, kThreads, 6 * kTileFloats * sizeof(float),
                             reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), sq, skv, causal,
      scale);
  return (int)cudaGetLastError();
}

extern "C" const char* mx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
