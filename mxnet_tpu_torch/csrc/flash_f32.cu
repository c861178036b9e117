// Flash attention in f32 for Hopper (sm_90a) at head dims 32 and 64: the
// forward (K2f f32) and the two backward kernels (K2dq f32, K2dkv f32).
//
// Replaces: for f32 inputs, the Pallas kernels `_flash_fwd_kernel`
// (launched by `_flash_forward`), `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` (launched by `_flash_backward`)
// (mxnet_tpu/ops/pallas_kernels.py:157, :190, :220; :265, :293, :305),
// reached from `kernels.attention` in every layer of an f32 model (BERT's
// `--dtype float32` pretraining at head dim 64; the f32 TransformerLM of
// bench.py's `transformer_kernels_config` at head dim 32).  bf16 inputs
// go to flash_fwd.cu and flash_bwd.cu.
//
// Computes, per (batch*head, query row), as those kernels do in f32:
//   forward:  o = softmax(q k^T * scale [causal: -1e30 above the
//             diagonal]) v, lse = rowmax + log(rowsum) (natural log);
//   dq:       p = exp(s*scale - lse), ds = p * (dO v^T - delta) * scale,
//             dq = ds k;
//   dk, dv:   dv = p^T dO, dk = ds^T q;
// with delta = rowsum(dO * O) computed outside (cuda_kernels.flash_delta).
//
// What bounds them: the forward does 2 products (q k^T, p v), dq 3
// (q k^T, dO v^T, ds k) and dk/dv 4 (k q^T, v dO^T, p^T dO, ds^T q), each
// 2 * D FLOPs per (query, key) pair.  An f32-accurate product on the
// tensor cores is three TF32 products, so the card's rate for it is
// 495 / 3 = 165 TFLOP/s; at BERT's S = 128 the bytes of the inputs and
// outputs against 3.35 TB/s bound them instead.
//
// 3xTF32.  Each operand x is split as x = big + small, big = tf32(x),
// small = tf32(x - big), both rounded with cvt.rna.tf32.f32 (a tf32 mma
// reads an f32 register by dropping its low 13 bits, which would give
// small the wrong value); the product is small*big + big*small + big*big,
// accumulated in f32 (small terms first).  The dropped small*small term
// and the rounding of small are ~2^-22 of each product: the f32
// accumulation's own error dominates.  Where the split happens: once per
// element of a tile in shared memory, by the whole block, into a split
// tile (the tile's big parts, then its small parts, each laid out as
// below).  Splitting at fragment load instead, as CUTLASS's FastF32 does,
// splits every B element once per warp and orientation (8 times for K in
// dq), and ran about a third slower in a development A/B on the H100:
// the conversions, not the products, set its pace.  Only the operands
// that are accumulators of an earlier product (P, dS) are split in
// registers.
//
// Instruction: mma.sync.m16n8k8 tf32.  wgmma reads a tf32 operand from
// shared memory only K-major, and four of the nine products (p v, ds k,
// p^T dO, ds^T q) have a B operand that is MN-major in its row-major
// tile; mma.sync takes fragments from registers, loaded in either
// orientation.  The k index of a product may be permuted as long as A
// and B agree, so the accumulator of S (thread (g, t) = (lane / 4,
// lane % 4) holds columns 2t and 2t + 1 of each 8-column group) is used as
// the A fragment of the next product directly, with logical k = t taken
// as column 2t and k = t + 4 as column 2t + 1; B is read at the same two
// rows.  P and dS never leave registers.
//
// Bank conflicts.  The big and the small part of a tile are each stored
// unpadded (D floats a row: 16 chunks of 16 bytes at D = 64, 8 at D = 32)
// with 16-byte chunk c of row r at chunk c ^ (r & 7), and read with 4-byte
// loads.  A bank is 4 bytes; 32 of them are 8 chunks, so a float's bank is
// (4 (stored chunk & 7) + its place in the chunk) at either D (a D = 64
// row spans the banks twice, and the swizzle leaves bit 3 of its chunk
// index alone).  Fragments read a tile two ways:
//   along rows (A fragments; B of q k^T, k q^T, dO v^T, v dO^T): lanes
//   (g, t) read row r0 + g, column 8s + t (+4): chunk 2s (+1), place t.
//   r & 7 = g, so the 8 rows land on stored chunks (2s [+1]) ^ g, 8
//   distinct chunks mod 8, and t picks the bank in each: 32 banks.
//   down columns (B of p v, ds k, p^T dO, ds^T q): lanes read row
//   8j + 2t (+1), column 8n + g: chunk 2n + (g >> 2), place g & 3.  The
//   stored chunk is (2n + (g >> 2)) ^ (2t [+1]): its low bit
//   (g >> 2) [^ 1], its bits 1-2 (n ^ t) & 3, so 8 distinct chunks mod 8
//   over (t, g >> 2), and g & 3 picks the bank: 32 banks.
// Both are conflict-free at D = 64 and D = 32 alike (n < D / 8 keeps a
// D = 32 chunk index below 8), and the split pass's 16-byte stores (8
// chunks of one row, or of one half row at D = 64, a quarter-warp) are
// too.  Big and small side by side in one row, read with 8-byte loads,
// ran slower in the same A/B.
//
// Overlap, a two-stage ring: the streamed tiles (K and V in the forward
// and dq; Q, dO and their lse and delta strips in dk/dv) land raw in a
// landing buffer by cp.async (16-byte copies, zero-filled past a ragged
// end) while the split tile before them is multiplied; each iteration
// splits the landed tile, issues the next copy, then multiplies.  The
// block's own tiles (Q in the forward, Q and dO in dq, K and V in dk/dv)
// land once, in the streamed split tiles' place, and are split before the
// first iteration.
//
// The forward: per 32-key tile, S = q k^T (3xTF32), the online softmax in
// registers (the running max and sum of the two rows a lane holds,
// reduced over the row's 4 lanes with shuffles; the accumulator rescaled
// by exp(m_old - m_new)), then o += P v with P split in registers.  At the
// end o = acc / l and lse = m + log(l).  Keys past a ragged end score
// -inf, causal pairs above the diagonal -1e30 (the reference's), so both
// get p = 0 exactly; every row sees key 0, so its running max is finite
// from the first tile on.
//
// Blocks and tiles: 128 threads (4 warps, 16 rows each), 64 rows a block
// (queries in the forward and dq, keys in dk/dv), streamed tiles of 32
// rows, at both head dims (the tile heights were kept at D = 32).  At
// D = 64 the forward holds split Q (32 KB), a split K and V tile (32 KB)
// and the landing buffer (16 KB): 80 KB, two blocks an SM; dq split Q and
// dO (64 KB), a split K and V tile (32 KB) and the landing buffer (16 KB);
// dk/dv split K and V, a split Q and dO tile, the landing buffer and the
// strips: 112 KB each, two blocks an SM (the 32-row streamed tile is what
// makes the split tiles fit twice).  At D = 32 every tile is half as
// large.  Both checked D = 64 grids (B=8 H=12 S=128 and B=1 H=12 S=1024
// causal) have 192 blocks: all resident at once on 132 SMs, one wave with
// no tail.  Registers are not the limit (<= 255 a thread at two 128-thread
// blocks).  Causal: tiles wholly above the diagonal are skipped; the grid
// runs the heaviest blocks first (forward and dq: the last query blocks;
// dk/dv: the first key blocks), batch*head fastest.  A masked or ragged
// (query, key) pair gets p = 0 exactly; rows past the end are not stored.
// No atomics: a second launch gives the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;   // the reference's masked score
constexpr int kThreads = 128;    // 4 warps of 16 rows
constexpr int kRows = 64;        // own rows: queries (forward, dq), keys
constexpr int kStream = 32;      // rows of a streamed tile
constexpr int kSc = kStream / 8; // column groups of a streamed tile

// Shared memory of each kernel at head dim D; a split tile of R rows is
// R * 2D floats (big, then small).
template <int D>
struct FwdSmem {
  float q[kRows * 2 * D];     // split Q
  float k[kStream * 2 * D];   // split K tile (where Q lands raw)
  float v[kStream * 2 * D];   // split V tile
  float raw[2][kStream * D];  // the next K and V tiles as they land
};

template <int D>
struct DqSmem {
  float q[kRows * 2 * D];     // split Q
  float dout[kRows * 2 * D];  // split dO
  float k[kStream * 2 * D];   // split K tile (where Q lands raw)
  float v[kStream * 2 * D];   // split V tile (where dO lands raw)
  float raw[2][kStream * D];  // the next K and V tiles as they land
};

template <int D>
struct DkvSmem {
  float k[kRows * 2 * D];        // split K
  float v[kRows * 2 * D];        // split V
  float q[kStream * 2 * D];      // split Q tile (where K lands raw)
  float dout[kStream * 2 * D];   // split dO tile (where V lands raw)
  float raw[2][kStream * D];     // the next Q and dO tiles as they land
  float lse[2][kStream];         // ring of the tiles' lse and delta
  float delta[2][kStream];
};

static_assert(2 * (sizeof(DkvSmem<64>) + 1024) <= 233472 &&
                  2 * (sizeof(DqSmem<64>) + 1024) <= 233472 &&
                  2 * (sizeof(FwdSmem<64>) + 1024) <= 233472,
              "two blocks of each kernel must fit an SM's shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the bytes past `bytes` (0 or 16) zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + rows) of a row-major [n, D] matrix into a plain
// row-major tile; rows past n are zero.  D / 4 threads copy one row.
template <int D>
__device__ __forceinline__ void async_rows(float* tile, const float* g,
                                           int r0, int rows, int n) {
  constexpr int kPerRow = D / 4;
  const int c4 = threadIdx.x % kPerRow;
  for (int r = threadIdx.x / kPerRow; r < rows; r += kThreads / kPerRow) {
    const bool in = r0 + r < n;
    cp_async16(tile + r * D + 4 * c4,
               g + (size_t)(in ? r0 + r : 0) * D + 4 * c4, in ? 16 : 0);
  }
}

// Entry i of [r0, r0 + kStream) of a flat f32 strip (lse or delta of one
// head), zero past n.  4-byte copies: a head's strip need not be 16-byte
// aligned.
__device__ __forceinline__ void async_strip(float* strip, const float* g,
                                            int r0, int n, int i) {
  const bool in = r0 + i < n;
  cp_async4(strip + i, g + (in ? r0 + i : 0), in ? 4 : 0);
}

// x = big + small, both tf32 (cvt.rna: to nearest, ties away from zero).
// big's low 13 bits are cleared, so its f32 reading is its tf32 value.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  uint32_t b;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(b) : "f"(x));
  b &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(x - __uint_as_float(b)));
  big = b;
}

// A split tile of R rows: big at [0, DR), small at [DR, 2DR), each with
// 16-byte chunk j of row r at chunk j ^ (r & 7).
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + (((c >> 2) ^ (r & 7)) << 2) + (c & 3);
}

template <int R, int D>
__device__ __forceinline__ void load_split(const float* tile, int r, int c,
                                           uint32_t& big, uint32_t& small) {
  big = __float_as_uint(tile[swz<D>(r, c)]);
  small = __float_as_uint(tile[R * D + swz<D>(r, c)]);
}

// rows x D plain f32 -> split tile, each element once, by the block.
template <int D>
__device__ __forceinline__ void split_tile(float* dst, const float* raw,
                                           int rows) {
  for (int i = threadIdx.x; i < rows * D / 4; i += kThreads) {
    const int r = i / (D / 4), j = i % (D / 4);
    const float4 x = *reinterpret_cast<const float4*>(raw + r * D + 4 * j);
    uint4 b, s;
    split(x.x, b.x, s.x);
    split(x.y, b.y, s.y);
    split(x.z, b.z, s.z);
    split(x.w, b.w, s.w);
    const int o = r * D + ((j ^ (r & 7)) << 2);
    *reinterpret_cast<uint4*>(dst + o) = b;
    *reinterpret_cast<uint4*>(dst + rows * D + o) = s;
  }
}

// d[16 x 8] += a[16 x 8] b[8 x 8], one tf32 mma.  a: (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); b: (t, g), (t + 4, g); d: (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)  (row, column), g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32 over N column groups: acc[n] += a b[n] as small*big, then
// big*small, then big*big (each group of N independent mmas in a row).
template <int N>
__device__ __forceinline__ void mma3(float (&acc)[N][4],
                                     const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[N][2],
                                     const uint32_t (&bs)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], as, bb[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], ab, bs[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], ab, bb[n]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[n][i] = 0.f;
}

// acc[16 x 8N] = A B^T over the D columns of both: A rows ra .. ra + 15
// of the block's split tile `a` (kRows rows), B rows 0 .. 8N - 1 of the
// streamed split tile `b` (kStream rows; column group n of acc is rows
// 8n .. 8n + 7 of b); both read along their rows.
template <int N, int D>
__device__ __forceinline__ void mm_abt(float (&acc)[N][4], const float* a,
                                       int ra, const float* b, int g, int t) {
  zero(acc);
#pragma unroll
  for (int s = 0; s < D / 8; ++s) {
    uint32_t ab[4], as[4], bb[N][2], bs[N][2];
    load_split<kRows, D>(a, ra + g, 8 * s + t, ab[0], as[0]);
    load_split<kRows, D>(a, ra + g + 8, 8 * s + t, ab[1], as[1]);
    load_split<kRows, D>(a, ra + g, 8 * s + t + 4, ab[2], as[2]);
    load_split<kRows, D>(a, ra + g + 8, 8 * s + t + 4, ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      load_split<kStream, D>(b, 8 * n + g, 8 * s + t, bb[n][0], bs[n][0]);
      load_split<kStream, D>(b, 8 * n + g, 8 * s + t + 4, bb[n][1],
                             bs[n][1]);
    }
    mma3(acc, ab, as, bb, bs);
  }
}

// acc[16 x D] += X B: X the [16 x 8K] accumulator of an earlier product
// (its 8K columns are the reduction), B rows 0 .. 8K - 1 of the streamed
// split tile `b` read down its columns.  Step j takes X's column group j
// as the A fragment with logical k = t at column 8j + 2t and k = t + 4 at
// 8j + 2t + 1, so B's rows are 8j + 2t and 8j + 2t + 1.
template <int K, int D>
__device__ __forceinline__ void mm_xb(float (&acc)[D / 8][4],
                                      const float (&x)[K][4], const float* b,
                                      int g, int t) {
  constexpr int N = D / 8;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    uint32_t ab[4], as[4], bb[N][2], bs[N][2];
    split(x[j][0], ab[0], as[0]);
    split(x[j][2], ab[1], as[1]);
    split(x[j][1], ab[2], as[2]);
    split(x[j][3], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      load_split<kStream, D>(b, 8 * j + 2 * t, 8 * n + g, bb[n][0],
                             bs[n][0]);
      load_split<kStream, D>(b, 8 * j + 2 * t + 1, 8 * n + g, bb[n][1],
                             bs[n][1]);
    }
    mma3(acc, ab, as, bb, bs);
  }
}

// Rows row0 and row0 + 8 (< n) of a row-major [n, D] output from a
// [16 x D] accumulator.
template <int D>
__device__ __forceinline__ void store_acc(float* out,
                                          const float (&acc)[D / 8][4],
                                          int row0, int n, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(out + (size_t)row * D + 8 * c + 2 * t) =
          make_float2(acc[c][2 * h], acc[c][2 * h + 1]);
  }
}

// Max / sum over the 4 lanes (t = 0 .. 3) that hold one row of an
// accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Streamed key tiles a query block at q0 reads: causal, those up to the
// one holding its last query.
__device__ __forceinline__ int key_tiles(int q0, int skv, int causal) {
  const int n = (skv + kStream - 1) / kStream;
  return causal ? min(n, (q0 + kRows - 1) / kStream + 1) : n;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int sq, int skv, int causal,
                         float scale) {
  extern __shared__ __align__(16) float smem_fwd[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(smem_fwd);
  const int bh = blockIdx.x;
  // causal: the last query blocks (the most key tiles) first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = 16 * (threadIdx.x >> 5);  // the warp's rows in the block
  const float* kb = k + (size_t)bh * skv * D;
  const float* vb = v + (size_t)bh * skv * D;
  // Q lands raw in the K tile's place, key tile 0 in the ring
  async_rows<D>(sm.k, q + (size_t)bh * sq * D, q0, kRows, sq);
  async_rows<D>(sm.raw[0], kb, 0, kStream, skv);
  async_rows<D>(sm.raw[1], vb, 0, kStream, skv);
  cp_commit();
  const int nt = key_tiles(q0, skv, causal);
  cp_wait_all();
  __syncthreads();
  split_tile<D>(sm.q, sm.k, kRows);
  __syncthreads();
  float acc[D / 8][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = 0; it < nt; ++it) {
    split_tile<D>(sm.k, sm.raw[0], kStream);
    split_tile<D>(sm.v, sm.raw[1], kStream);
    __syncthreads();
    if (it + 1 < nt) {
      async_rows<D>(sm.raw[0], kb, (it + 1) * kStream, kStream, skv);
      async_rows<D>(sm.raw[1], vb, (it + 1) * kStream, kStream, skv);
      cp_commit();
    }
    const int k0 = it * kStream;
    float s[kSc][4];
    mm_abt<kSc, D>(s, sm.q, rw, sm.k, g, t);  // q k^T
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kSc; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + rw + g + 8 * (i >> 1);
        const int col = k0 + 8 * n + 2 * t + (i & 1);
        float x = s[n][i] * scale;
        if (col >= skv)
          x = -INFINITY;  // past the ragged end: not a key
        else if (causal && col > row)
          x = kNeg;
        s[n][i] = x;
        mt[i >> 1] = fmaxf(mt[i >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(mt[h]));
      alpha[h] = expf(m[h] - mn);  // 0 at the first tile
      m[h] = mn;
    }
#pragma unroll
    for (int n = 0; n < kSc; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = expf(s[n][i] - m[i >> 1]);
        rs[i >> 1] += s[n][i];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(rs[h]);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][i] *= alpha[i >> 1];
    mm_xb<kSc, D>(acc, s, sm.v, g, t);  // o += p v
    cp_wait_all();
    __syncthreads();  // every warp is done with the split tiles
  }
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = acc[c][i] / l[i >> 1];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rw + g + 8 * h;
    if (t == 0 && row < sq) lse[(size_t)bh * sq + row] = m[h] + logf(l[h]);
  }
  store_acc<D>(o + (size_t)bh * sq * D, acc, q0 + rw + g, sq, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int sq, int skv,
                            int causal, float scale) {
  extern __shared__ __align__(16) float smem_dq[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(smem_dq);
  const int bh = blockIdx.x;
  // causal: the last query blocks (the most key tiles) first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = 16 * (threadIdx.x >> 5);  // the warp's rows in the block
  const float* kb = k + (size_t)bh * skv * D;
  const float* vb = v + (size_t)bh * skv * D;
  // Q and dO land raw in the K and V tiles' place, tile 0 in the ring
  async_rows<D>(sm.k, q + (size_t)bh * sq * D, q0, kRows, sq);
  async_rows<D>(sm.v, dout + (size_t)bh * sq * D, q0, kRows, sq);
  async_rows<D>(sm.raw[0], kb, 0, kStream, skv);
  async_rows<D>(sm.raw[1], vb, 0, kStream, skv);
  cp_commit();
  float ls[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rw + g + 8 * h;
    ls[h] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
    dl[h] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }
  const int nt = key_tiles(q0, skv, causal);
  cp_wait_all();
  __syncthreads();
  split_tile<D>(sm.q, sm.k, kRows);
  split_tile<D>(sm.dout, sm.v, kRows);
  __syncthreads();
  float acc[D / 8][4];
  zero(acc);
  for (int it = 0; it < nt; ++it) {
    // the split K and V tiles take tile it; tile it + 1 lands in the
    // landing buffer while this one is multiplied
    split_tile<D>(sm.k, sm.raw[0], kStream);
    split_tile<D>(sm.v, sm.raw[1], kStream);
    __syncthreads();
    if (it + 1 < nt) {
      async_rows<D>(sm.raw[0], kb, (it + 1) * kStream, kStream, skv);
      async_rows<D>(sm.raw[1], vb, (it + 1) * kStream, kStream, skv);
      cp_commit();
    }
    const int k0 = it * kStream;
    float s[kSc][4], ds[kSc][4];
    mm_abt<kSc, D>(s, sm.q, rw, sm.k, g, t);      // q k^T
    mm_abt<kSc, D>(ds, sm.dout, rw, sm.v, g, t);  // dO v^T
#pragma unroll
    for (int n = 0; n < kSc; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + rw + g + 8 * (i >> 1);
        const int col = k0 + 8 * n + 2 * t + (i & 1);
        float x = s[n][i] * scale;
        if (causal && col > row) x = kNeg;
        const float p = (row < sq && col < skv) ? expf(x - ls[i >> 1]) : 0.f;
        ds[n][i] = p * (ds[n][i] - dl[i >> 1]) * scale;
      }
    mm_xb<kSc, D>(acc, ds, sm.k, g, t);  // dq += ds k
    cp_wait_all();
    __syncthreads();  // every warp is done with the split tiles
  }
  store_acc<D>(dq + (size_t)bh * sq * D, acc, q0 + rw + g, sq, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int sq, int skv, int causal, float scale) {
  extern __shared__ __align__(16) float smem_dkv[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(smem_dkv);
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;  // causal: the first key blocks first
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = 16 * (threadIdx.x >> 5);
  const float* qb = q + (size_t)bh * sq * D;
  const float* db = dout + (size_t)bh * sq * D;
  const float* lb = lse + (size_t)bh * sq;
  const float* eb = delta + (size_t)bh * sq;
  // causal: query tiles from the one holding key k0 (Sq == Skv)
  const int first = causal ? k0 / kStream : 0;
  const int nq = (sq + kStream - 1) / kStream;
  auto load = [&](int it) {  // tile it of Q, dO, lse and delta
    async_rows<D>(sm.raw[0], qb, it * kStream, kStream, sq);
    async_rows<D>(sm.raw[1], db, it * kStream, kStream, sq);
    const int s = (it - first) & 1;
    if (threadIdx.x < kStream)
      async_strip(sm.lse[s], lb, it * kStream, sq, threadIdx.x);
    else if (threadIdx.x < 2 * kStream)
      async_strip(sm.delta[s], eb, it * kStream, sq, threadIdx.x - kStream);
    cp_commit();
  };
  // K and V land raw in the Q and dO tiles' place
  async_rows<D>(sm.q, k + (size_t)bh * skv * D, k0, kRows, skv);
  async_rows<D>(sm.dout, v + (size_t)bh * skv * D, k0, kRows, skv);
  load(first);
  cp_wait_all();
  __syncthreads();
  split_tile<D>(sm.k, sm.q, kRows);
  split_tile<D>(sm.v, sm.dout, kRows);
  __syncthreads();
  float dka[D / 8][4], dva[D / 8][4];
  zero(dka);
  zero(dva);
  for (int it = first; it < nq; ++it) {
    split_tile<D>(sm.q, sm.raw[0], kStream);
    split_tile<D>(sm.dout, sm.raw[1], kStream);
    __syncthreads();
    if (it + 1 < nq) load(it + 1);
    const int s = (it - first) & 1;
    const int q0 = it * kStream;
    float p[kSc][4], ds[kSc][4];
    mm_abt<kSc, D>(p, sm.k, rw, sm.q, g, t);  // s^T = k q^T (keys x queries)
#pragma unroll
    for (int n = 0; n < kSc; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + rw + g + 8 * (i >> 1);
        const int c = 8 * n + 2 * t + (i & 1);
        float x = p[n][i] * scale;
        if (causal && key > q0 + c) x = kNeg;
        p[n][i] = (q0 + c < sq && key < skv) ? expf(x - sm.lse[s][c]) : 0.f;
      }
    mm_xb<kSc, D>(dva, p, sm.dout, g, t);         // dv += p^T dO
    mm_abt<kSc, D>(ds, sm.v, rw, sm.dout, g, t);  // dP^T = v dO^T
#pragma unroll
    for (int n = 0; n < kSc; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * n + 2 * t + (i & 1);
        ds[n][i] = p[n][i] * (ds[n][i] - sm.delta[s][c]) * scale;
      }
    mm_xb<kSc, D>(dka, ds, sm.q, g, t);  // dk += ds^T q
    cp_wait_all();
    __syncthreads();
  }
  store_acc<D>(dk + (size_t)bh * skv * D, dka, k0 + rw + g, skv, t);
  store_acc<D>(dv + (size_t)bh * skv * D, dva, k0 + rw + g, skv, t);
}

inline bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

// Head dims 32 and 64; causal aligns query i with key i, so Sq == Skv.
inline bool bad_dims(int bh, int sq, int skv, int d, int causal) {
  return bh <= 0 || sq <= 0 || skv <= 0 || bh > 65535 ||
         (d != 32 && d != 64) || (causal && sq != skv) ||
         (sq + kRows - 1) / kRows > 65535 || (skv + kRows - 1) / kRows > 65535;
}

// The dynamic shared memory a launch asks for, and the whole shared
// capacity of the SM as the carveout, so two blocks fit.
template <typename Kernel>
inline int set_smem(Kernel kernel, size_t bytes) {
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != 0) return err;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, int bh, int sq, int skv, int causal, float scale,
               cudaStream_t stream) {
  const int err = set_smem(flash_fwd_f32_kernel<D>, sizeof(FwdSmem<D>));
  if (err != 0) return err;
  const dim3 grid(bh, (sq + kRows - 1) / kRows);
  flash_fwd_f32_kernel<D><<<grid, kThreads, sizeof(FwdSmem<D>), stream>>>(
      q, k, v, o, lse, sq, skv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, int bh, int sq, int skv, int causal, float scale,
              cudaStream_t stream) {
  const int err = set_smem(flash_bwd_dq_f32_kernel<D>, sizeof(DqSmem<D>));
  if (err != 0) return err;
  const dim3 grid(bh, (sq + kRows - 1) / kRows);
  flash_bwd_dq_f32_kernel<D><<<grid, kThreads, sizeof(DqSmem<D>), stream>>>(
      q, k, v, dout, lse, delta, dq, sq, skv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, int bh, int sq, int skv, int causal,
               float scale, cudaStream_t stream) {
  const int err = set_smem(flash_bwd_dkv_f32_kernel<D>, sizeof(DkvSmem<D>));
  if (err != 0) return err;
  const dim3 grid(bh, (skv + kRows - 1) / kRows);
  flash_bwd_dkv_f32_kernel<D>
      <<<grid, kThreads, sizeof(DkvSmem<D>), stream>>>(
          q, k, v, dout, lse, delta, dk, dv, sq, skv, causal, scale);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int blocks_per_sm(Kernel kernel, size_t bytes) {
  int blocks = 0;
  int err = set_smem(kernel, bytes);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kThreads, bytes);
  return err == 0 ? blocks : -err;
}

template <int D>
int blocks_per_sm_at(int which) {
  if (which == 0)
    return blocks_per_sm(flash_fwd_f32_kernel<D>, sizeof(FwdSmem<D>));
  if (which == 1)
    return blocks_per_sm(flash_bwd_dq_f32_kernel<D>, sizeof(DqSmem<D>));
  return blocks_per_sm(flash_bwd_dkv_f32_kernel<D>, sizeof(DkvSmem<D>));
}

}  // namespace

extern "C" int mx_flash_fwd_f32(const void* q, const void* k, const void* v,
                                void* o, void* lse, int bh, int sq, int skv,
                                int d, int causal, float scale,
                                void* stream) {
  if (bad_dims(bh, sq, skv, d, causal)) return (int)cudaErrorInvalidValue;
  if (misaligned(q) || misaligned(k) || misaligned(v))
    return (int)cudaErrorMisalignedAddress;
  auto launch = d == 32 ? &launch_fwd<32> : &launch_fwd<64>;
  return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o),
                static_cast<float*>(lse), bh, sq, skv, causal, scale,
                reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int mx_flash_bwd_dq_f32(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int bh, int sq, int skv, int d,
                                   int causal, float scale, void* stream) {
  if (bad_dims(bh, sq, skv, d, causal)) return (int)cudaErrorInvalidValue;
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout))
    return (int)cudaErrorMisalignedAddress;
  auto launch = d == 32 ? &launch_dq<32> : &launch_dq<64>;
  return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<float*>(dq), bh,
                sq, skv, causal, scale,
                reinterpret_cast<cudaStream_t>(stream));
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
  auto launch = d == 32 ? &launch_dkv<32> : &launch_dkv<64>;
  return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<float*>(dk),
                static_cast<float*>(dv), bh, sq, skv, causal, scale,
                reinterpret_cast<cudaStream_t>(stream));
}

// Resident blocks an SM of the forward (0), dq (1) or dk/dv (2) kernel at
// head dim d (32 or 64), at the launches' block size and shared memory;
// negative on an error.
extern "C" int mx_flash_f32_blocks_per_sm(int which, int d) {
  if (d != 32 && d != 64) return -(int)cudaErrorInvalidValue;
  return d == 32 ? blocks_per_sm_at<32>(which) : blocks_per_sm_at<64>(which);
}

extern "C" const char* mx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
