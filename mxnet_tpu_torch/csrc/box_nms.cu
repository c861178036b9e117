// Greedy non-maximum suppression over score-sorted boxes, for Hopper
// (sm_90a).
//
// Replaces: no TPU kernel.  The reference computes NMS with plain XLA ops
// (`_nms_one`, mxnet_tpu/ops/contrib.py:54-87): a dense N x N IoU matrix
// and a lax.scan of N sequential steps, a form that exists only because
// XLA needs static shapes.  At SSD-512's 65,280 anchors an image that
// matrix is 17 GB in f32, and a PyTorch loop over the scan launches
// several ops at each of the 65,280 steps, so box_nms, MultiBoxDetection
// and Proposal need the scan as a kernel.
//
// Input, per image b of B: n rows already sorted by score (descending,
// stable), each with its corners [x1, y1, x2, y2] (f32), its class id
// (f32, read only when class_aware) and whether it may be kept (`valid`,
// with the caller's topk already applied).  Output: keep[b, i], the keep
// mask of the reference's greedy scan: row i is kept when it is valid and
// no earlier kept row j suppresses it, where j suppresses i when
//     (class_aware && cls[j] != cls[i] ? 0 : iou(j, i)) > thresh.
//
// Segments.  When classes split the scan (a class id given and thresh
// >= 0: rows of other classes never suppress, since 0 > thresh is false)
// the wrapper (cuda_kernels.nms_sort) sorts each image's rows, stably, by
// a key: NaN for an invalid row, else the class id with -0.0 read as 0.0.
// A segment is then a run of equal non-NaN keys, in score order; a valid
// row of NaN class is a segment of one (it equals no row, itself
// included, so it is always kept).  Otherwise nothing is sorted and an
// image is one segment, its invalid rows skipped where they are staged.
// Segments are independent scans.
//
// One launch, a persistent grid of 512-thread blocks (cooperative when an
// image holds more than `block_rows` rows, for step 2's grid barriers):
//   1. Blocks take 512 positions at a time from a device counter (reset
//      by cudaMemsetAsync on the stream) and find the segments that start
//      there (one read of a row's valid flag and key).  A segment's end
//      is a binary search over the equal keys.  A segment of at most
//      `block_rows` positions (or an image of at most that many valid
//      rows) is staged (its valid rows, compacted) and resolved by that
//      block in shared memory (`walk`); a longer one goes on the device's
//      list of big segments.
//   2. After a grid barrier, each big segment is taken `block_rows`
//      positions (a chunk) at a time: (a) the blocks share the chunk's
//      64-row tiles and test each, as walk's (a) does, against the rows
//      kept in the segment's earlier chunks (a list in device memory),
//      marking the rows removed; a grid barrier; (b) one block a segment
//      stages the chunk's rows left and walks them, and appends what it
//      keeps to the list; a grid barrier.
//   walk, over the staged rows in 64-row tiles, three block barriers a
//   tile: (a) each warp tests every 16th row of the kept list (indices
//   into shared memory) against the tile's 64 rows, a lane two rows;
//   (b) the pairs of the tile's rows that (a) left, 63 to each 16
//   threads, set a row's bits of the later rows it suppresses; (c) one
//   warp resolves the tile: the first row neither removed nor decided is
//   kept, its bits (a shuffle from the lane that holds them) remove the
//   later rows, and so on, and the kept rows join the list.
//
// What bounds it on the H100: the IoUs the greedy scan needs, at the
// least each kept row against the kept rows before it in its segment and
// one for each row it suppresses (NMS_PAIR_OPS = 15 f32 operations
// each), over 67 TFLOP/s; with few valid rows the 22 bytes a row of
// input and output instead.  What the design does about the first
// kernel's costs (a mask kernel over all n x n/64 words, a walk on one
// SM an image): (1) an invalid row costs one read; no bit mask exists,
// and the scratch is 25 bytes a row (the big segments' kept lists and
// removed flags), not n^2 / 8; (2) with classes and thresh >= 0 a
// segment holds one class, so no IoU across classes is computed; (3) a
// row is tested against the rows kept before it and the rows its tile
// left, not against every later row; (4) segments run in parallel
// across the SMs, a big one's tests on every SM, and a tile is resolved
// by one warp through shuffles, not by thread 0.
//
// Bitwise: the IoU rounds as the plain version (cuda_kernels.
// box_nms_sorted_plain) and the reference's `_corner_iou` write it, one
// rounding an operation: max/min corners, clip(br - tl, 0), inter = w * h,
// each area clip(x2 - x1, 0) * clip(y2 - y1, 0), then
// inter / max((area_a + area_b) - inter, 1e-12), compared with the f32
// threshold, the earlier row as operand a.  Every product, sum and
// difference is an explicit _rn intrinsic, so nvcc contracts nothing
// into an FMA; max, min and clip propagate NaN as torch.maximum /
// torch.clamp do.  The quotient is never formed: two products decide
// whether it would round above the threshold, and an exact test in
// double the pairs they leave (quotient_above).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;        // rows a tile: one 64-bit word of bits
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItem = kThreads;  // sorted positions a work item of step 1
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// max, min and clip at 0 that return NaN when an operand is NaN, as
// torch.maximum / torch.minimum / torch.clamp do (one instruction each;
// which zero they return for -0.0 and 0.0 cannot change a comparison
// below: every difference is clipped, and +-0 areas sum to +0)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float clip0(float x) { return max_nan(x, 0.f); }

__device__ __forceinline__ float area_of(float4 a) {
  return __fmul_rn(clip0(__fsub_rn(a.z, a.x)), clip0(__fsub_rn(a.w, a.y)));
}

// fl(x / y) > thresh for the quotients of iou_above (x = inter, y = den:
// neither negative), without dividing.  With m the midpoint of thresh
// and the next float up, a correctly rounded quotient exceeds thresh
// exactly when x / y > m, or x / y == m and that next float is even
// (ties to even).  m has 25 significant bits and y 24, so m * y is
// exact in double and so is the comparison.  Host-computed: mid = m,
// tie_up, and the answers for x / y = 0 and = inf.
struct Above {
  double mid;
  int tie_up, zero_above, inf_above;
  // x > hi * y proves the quotient above thresh and x < lo * y proves it
  // not (thresh * (1 +- 2^-20), each product rounding within 2^-24);
  // NaN, so that nothing is proved, unless 2^-80 <= thresh <= 2^40 (the
  // products of a den >= 1e-12 are then normal floats)
  float lo, hi;
};

__device__ __forceinline__ bool quotient_above(const Above& t, float x,
                                               float y) {
  // branch-free: both answers are computed and one is selected
  const double p = t.mid * (double)y;
  const bool exact = ((double)x > p) | (((double)x == p) & (t.tie_up != 0));
  const bool finite = (fabsf(x) < INFINITY) & (fabsf(y) < INFINITY);
  const bool special = !is_nan(x) & !is_nan(y) & !(isinf(x) & isinf(y)) &
                       ((isinf(x) ? t.inf_above : t.zero_above) != 0);
  return finite ? exact : special;
}

// iou(a, b) > thresh for earlier row a (area aa) and later row b (area
// ab), the IoU inter / max((aa + ab) - inter, 1e-12): two products decide
// almost every pair, the exact test the rest
__device__ __forceinline__ bool iou_above(const Above& t, float4 a, float aa,
                                          float4 b, float ab) {
  const float w = clip0(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)));
  const float h = clip0(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)));
  const float inter = __fmul_rn(w, h);
  const float den = max_nan(__fsub_rn(__fadd_rn(aa, ab), inter), 1e-12f);
  const bool above = inter > __fmul_rn(t.hi, den);
  if (above | (inter < __fmul_rn(t.lo, den))) return above;
  return quotient_above(t, inter, den);
}

struct Big {  // a segment longer than block_rows, positions [lo, hi)
  int lo, hi, nk, pad;  // nk: its rows kept so far (the list at kbox + lo)
};

__device__ __forceinline__ Big load_big(const Big* big, int g) {
  const int4 v = __ldcg(reinterpret_cast<const int4*>(big) + g);
  return Big{v.x, v.y, v.z, v.w};
}

struct Args {
  const float4* boxes;    // [B * n]
  const float* cls;       // [B * n], read only when class_aware
  const uint8_t* valid;   // [B * n]
  const float* skey;      // [B * n] the keys sorted (stable), or null
  const int64_t* perm;    // [B * n] the row at each position, or null
  uint8_t* keep;          // [B * n], zeroed by mx_box_nms
  int* counters;          // [0] step 1's next item, [1] big segments
  Big* big;               // [max_big]
  float4* kbox;           // [B * n] kept lists of big segments ...
  float* karea;           // ... by position
  float* kcls;
  uint8_t* removed;       // [B * n] step 2(a)'s flags by position
  unsigned long long* pairs;  // IoUs computed, or null
  int total, n, block_rows, may_big;
  Above above;  // the threshold
  int class_aware;
};

struct Smem {  // the dynamic part: block_rows staged rows
  float4* box;
  float* area;
  uint16_t* kidx;  // the kept list: indices into box
  uint16_t* pos;   // a staged row's offset from the first staged position
  float* cls;      // only when class_aware
};

struct Static {
  unsigned long long tmask[kTile];  // row r's bits of later rows of a tile
  unsigned tsup[2];                 // tile rows a kept row suppresses
  int nkept, item, nstarts, hi;
  int wsum[kWarps];
  int starts[kItem];
};

// the row at position q: sorted (skey given) or the position itself
__device__ __forceinline__ int64_t row_of(const Args& A, int q) {
  return A.perm ? A.perm[q] : (int64_t)q;
}

// does earlier row (a, aa, ca) suppress later row (b, ab, cb)?  (the
// IoU of rows of other classes, when class_aware, is computed and
// replaced by 0, so no branch splits a warp)
__device__ __forceinline__ bool suppresses(const Args& A, float4 a, float aa,
                                           float ca, float4 b, float ab,
                                           float cb) {
  const bool above = iou_above(A.above, a, aa, b, ab);
  return (A.class_aware & !(ca == cb)) ? A.above.zero_above != 0 : above;
}

struct SmemList {  // a walk's kept list: indices into the staged rows
  const Smem& s;
  int class_aware;
  __device__ void get(int k, float4& b, float& a, float& c) const {
    const int i = s.kidx[k];
    b = s.box[i];
    a = s.area[i];
    c = class_aware ? s.cls[i] : 0.f;
  }
};

struct GlobalList {  // a big segment's kept list, written in this launch
  const float4* box;
  const float* area;
  const float* cls;
  __device__ void get(int k, float4& b, float& a, float& c) const {
    b = __ldcg(box + k);
    a = __ldcg(area + k);
    c = __ldcg(cls + k);
  }
};

// A tile's rows lane and lane + 32 (b, ab, cb; v: a row is there)
// against the nk rows of list L: warp w tests every 16th entry, a lane
// its two rows, and the rows found suppressed are ORed into st.tsup.
template <class List>
__device__ void against_list(const Args& A, const List& L, int nk,
                             const float4 (&b)[2], const float (&ab)[2],
                             const float (&cb)[2], bool v0, bool v1,
                             Static& st, unsigned long long& pairs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= nk) return;
  bool s0 = false, s1 = false;
#pragma unroll 2
  for (int k = warp; k < nk; k += kWarps) {
    float4 a;
    float aa, ca;
    L.get(k, a, aa, ca);
    s0 |= suppresses(A, a, aa, ca, b[0], ab[0], cb[0]);
    s1 |= suppresses(A, a, aa, ca, b[1], ab[1], cb[1]);
  }
  pairs += (unsigned)((nk - warp + kWarps - 1) / kWarps) * (v0 + v1);
  const unsigned w0 = __ballot_sync(kFull, s0 & v0);
  const unsigned w1 = __ballot_sync(kFull, s1 & v1);
  if (lane == 0) {
    if (w0) atomicOr(&st.tsup[0], w0);
    if (w1) atomicOr(&st.tsup[1], w1);
  }
}

// Stage the live rows among the m positions [q0, q0 + m) in shared
// memory, in order: a row is live when it is valid (positions unsorted)
// and, when `removed`, step 2(a) did not remove it.  Returns how many.
__device__ int stage(const Args& A, const Smem& s, Static& st, int q0,
                     int m, bool removed) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int count = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int i = base + t;
    int64_t row = 0;
    bool live = i < m;
    if (live) {
      row = row_of(A, q0 + i);
      live = (A.perm || A.valid[row]) &&
             !(removed && __ldcg(A.removed + q0 + i));
    }
    const unsigned bal = __ballot_sync(kFull, live);
    if (lane == 0) st.wsum[warp] = __popc(bal);
    __syncthreads();
    int before = 0, all = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? st.wsum[w] : 0;
      all += st.wsum[w];
    }
    if (live) {
      const int at = count + before + __popc(bal & ((1u << lane) - 1u));
      const float4 b = A.boxes[row];
      s.box[at] = b;
      s.area[at] = area_of(b);
      s.pos[at] = (uint16_t)i;
      if (A.class_aware) s.cls[at] = A.cls[row];
    }
    count += all;
    __syncthreads();
  }
  return count;
}

// The greedy scan of the m staged rows (staged from position q0): leaves
// the kept rows' indices in s.kidx, in order, and sets their keep flags
// once the scan is done.  Returns how many were kept.
__device__ int walk(const Args& A, const Smem& s, Static& st, int q0, int m,
                    unsigned long long& pairs) {
  const int t = threadIdx.x, lane = t & 31;
  int nkept = 0;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int rows = min(kTile, m - t0);
    // (a) the tile's rows against the kept list
    {
      float4 b[2];
      float ab[2], cb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = t0 + lane + 32 * h;  // past the tile: never read out
        b[h] = s.box[i];
        ab[h] = s.area[i];
        cb[h] = A.class_aware ? s.cls[i] : 0.f;
      }
      against_list(A, SmemList{s, A.class_aware}, nkept, b, ab, cb,
                   lane < rows, lane + 32 < rows, st, pairs);
    }
    __syncthreads();
    // (b) the tile's own bits among the rows (a) left: the pairs (r, c),
    // c > r, of rows g and 63 - g (63 pairs) on the 16 threads of g
    const unsigned long long tail = rows < kTile ? ~0ull << rows : 0ull;
    const unsigned long long left =
        ~(st.tsup[0] | (unsigned long long)st.tsup[1] << 32 | tail);
    {
      const int g = t >> 4;
      unsigned* tmask = reinterpret_cast<unsigned*>(st.tmask);
      for (int p = t & 15; p < kTile - 1; p += 16) {
        const int r = p < kTile - 1 - g ? g : kTile - 1 - g;
        const int c = p < kTile - 1 - g ? g + 1 + p : p + 1;
        if (!((left >> r) & (left >> c) & 1ull)) continue;
        const int i = t0 + r, j = t0 + c;
        if (suppresses(A, s.box[i], s.area[i],
                       A.class_aware ? s.cls[i] : 0.f, s.box[j], s.area[j],
                       A.class_aware ? s.cls[j] : 0.f))
          atomicOr(tmask + 2 * r + (c >> 5), 1u << (c & 31));
        ++pairs;
      }
    }
    __syncthreads();
    if (t < 32) {
      const unsigned long long lo = st.tmask[lane], hi = st.tmask[lane + 32];
      st.tmask[lane] = st.tmask[lane + 32] = 0ull;
      unsigned long long alive = left, kept = 0ull;
      while (alive) {
        const int k = __ffsll((long long)alive) - 1;
        kept |= 1ull << k;
        const unsigned long long mk = __shfl_sync(kFull, k < 32 ? lo : hi,
                                                  k & 31);
        alive &= ~(mk | (1ull << k));
      }
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        if ((kept >> c) & 1ull) {
          const int at = nkept + __popcll(kept & ((1ull << c) - 1ull));
          s.kidx[at] = (uint16_t)(t0 + c);
        }
      }
      if (lane == 0) {
        st.nkept = nkept + __popcll(kept);
        st.tsup[0] = st.tsup[1] = 0u;
      }
    }
    __syncthreads();
    nkept = st.nkept;
  }
  for (int k = t; k < nkept; k += kThreads)
    A.keep[row_of(A, q0 + s.pos[s.kidx[k]])] = 1;
  return nkept;
}

// A segment, with sorted keys: a valid row that differs from the one
// before it in key or image starts one, and it ends at the first position
// whose key or image differs (equal keys hold their rows in flat order,
// so each image's rows of a key are one run).  Without keys an image is
// one segment.
__device__ __forceinline__ bool same_run(const Args& A, int q, float k,
                                         int64_t img) {
  return A.skey[q] == k && A.perm[q] / A.n == img;
}

__device__ __forceinline__ bool starts_segment(const Args& A, int q) {
  if (!A.skey) return q % A.n == 0;
  const int64_t row = A.perm[q];
  return A.valid[row] &&
         (q == 0 || !same_run(A, q - 1, A.skey[q], row / A.n));
}

// the end of the segment that starts at position p: a binary search
__device__ int segment_end(const Args& A, int p) {
  if (!A.skey) return p + A.n;
  const float k = A.skey[p];
  if (is_nan(k)) return p + 1;
  const int64_t img = A.perm[p] / A.n;
  int lo = p + 1, hi = A.total;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (same_run(A, mid, k, img))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads, 1)
nms_segments(Args A) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Static st;
  const int R = A.block_rows;
  Smem s;
  s.box = reinterpret_cast<float4*>(dyn);
  s.area = reinterpret_cast<float*>(s.box + R);
  s.kidx = reinterpret_cast<uint16_t*>(s.area + R);
  s.pos = s.kidx + R;
  s.cls = reinterpret_cast<float*>(s.pos + R);
  const int t = threadIdx.x;
  unsigned long long pairs = 0;
  if (t == 0) st.tsup[0] = st.tsup[1] = 0u;
  if (t < kTile) st.tmask[t] = 0ull;
  // step 1: find the segments; resolve the ones that fit
  const int items = (A.total + kItem - 1) / kItem;
  for (;;) {
    if (t == 0) {
      st.item = atomicAdd(&A.counters[0], 1);
      st.nstarts = 0;
    }
    __syncthreads();
    const int item = st.item;
    if (item >= items) break;
    const int q = item * kItem + t;
    if (q < A.total && starts_segment(A, q))
      st.starts[atomicAdd(&st.nstarts, 1)] = q;
    __syncthreads();
    const int nstarts = st.nstarts;
    for (int k = 0; k < nstarts; ++k) {
      const int p = st.starts[k];
      if (t == 0) st.hi = segment_end(A, p);
      __syncthreads();
      const int len = st.hi - p;
      // an image's positions (no keys) may hold more than R rows and
      // still fit: staging takes only its valid rows
      bool fits = len <= R;
      if (!fits && !A.perm && len <= 65535) {
        int live = 0;
        for (int i = t; i - t < len; i += kThreads)
          live += __syncthreads_count(i < len && A.valid[p + i]);
        fits = live <= R;
      }
      if (!fits) {
        if (t == 0) {
          const int g = atomicAdd(&A.counters[1], 1);
          A.big[g] = Big{p, p + len, 0, 0};
        }
      } else if (len == 1) {
        if (t == 0 && (A.perm || A.valid[p])) A.keep[row_of(A, p)] = 1;
      } else {
        const int m = stage(A, s, st, p, len, false);
        walk(A, s, st, p, m, pairs);
      }
      __syncthreads();
    }
  }
  // step 2: the big segments, a chunk of block_rows positions at a time
  if (A.may_big) {
    cg::this_grid().sync();
    const int nbig = __ldcg(A.counters + 1);
    int chunks = 0;
    for (int g = 0; g < nbig; ++g) {
      const Big bg = load_big(A.big, g);
      chunks = max(chunks, (bg.hi - bg.lo + R - 1) / R);
    }
    const int lane = t & 31;
    for (int c = 0; c < chunks; ++c) {
      if (c > 0) {
        // (a) the chunk's rows against the rows kept in earlier chunks
        int tiles = 0;
        for (int g = 0; g < nbig; ++g) {
          const Big bg = load_big(A.big, g);
          const int q0 = bg.lo + c * R;
          if (q0 < bg.hi) tiles += (min(R, bg.hi - q0) + kTile - 1) / kTile;
        }
        for (int it = blockIdx.x; it < tiles; it += gridDim.x) {
          int g = 0, left = it, q0 = 0, end = 0;
          Big bg;
          for (;; ++g) {
            bg = load_big(A.big, g);
            q0 = bg.lo + c * R;
            if (q0 >= bg.hi) continue;
            end = min(q0 + R, bg.hi);
            const int n_t = (end - q0 + kTile - 1) / kTile;
            if (left < n_t) break;
            left -= n_t;
          }
          float4 b[2];
          float ab[2], cb[2];
          bool v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = q0 + left * kTile + lane + 32 * h;
            const int64_t row = row_of(A, q < end ? q : q0);
            v[h] = q < end && (A.perm || A.valid[row]);
            b[h] = A.boxes[row];
            ab[h] = area_of(b[h]);
            cb[h] = A.class_aware ? A.cls[row] : 0.f;
          }
          against_list(
              A, GlobalList{A.kbox + bg.lo, A.karea + bg.lo, A.kcls + bg.lo},
              bg.nk, b, ab, cb, v[0], v[1], st, pairs);
          __syncthreads();
          if (t < 32) {
            const unsigned sup[2] = {st.tsup[0], st.tsup[1]};
            __syncwarp();
            if (lane == 0) st.tsup[0] = st.tsup[1] = 0u;
            for (int h = 0; h < 2; ++h) {
              const int q = q0 + left * kTile + lane + 32 * h;
              if (q < end) A.removed[q] = (sup[h] >> lane) & 1u;
            }
          }
          __syncthreads();
        }
        cg::this_grid().sync();
      }
      // (b) one block a segment walks the chunk and extends its list
      for (int g = blockIdx.x; g < nbig; g += gridDim.x) {
        const Big bg = load_big(A.big, g);
        const int q0 = bg.lo + c * R;
        if (q0 >= bg.hi) continue;
        const int m = stage(A, s, st, q0, min(R, bg.hi - q0), c > 0);
        const int kept = walk(A, s, st, q0, m, pairs);
        for (int k = t; k < kept; k += kThreads) {
          const int i = s.kidx[k];
          const int at = bg.lo + bg.nk + k;
          A.kbox[at] = s.box[i];
          A.karea[at] = s.area[i];
          A.kcls[at] = A.class_aware ? s.cls[i] : 0.f;
        }
        __syncthreads();
        if (t == 0) A.big[g].nk = bg.nk + kept;
      }
      if (c + 1 < chunks) cg::this_grid().sync();
    }
  }
  if (A.pairs != nullptr) {
    for (int o = 16; o > 0; o >>= 1)
      pairs += __shfl_xor_sync(kFull, pairs, o);
    if ((t & 31) == 0 && pairs) atomicAdd(A.pairs, pairs);
  }
}

size_t dyn_smem(int block_rows, int class_aware) {
  return (size_t)block_rows * (16 + 4 + 2 + 2 + (class_aware ? 4 : 0));
}

struct DeviceInfo {  // per device: SMs, the shared memory opted into,
  int sms, per_sm;    // and the blocks an SM holds at smem_seen
  size_t smem_set, smem_seen;
};
DeviceInfo g_devices[64];

}  // namespace

// The scratch mx_box_nms needs, bytes (16-byte aligned).
extern "C" long long mx_box_nms_scratch_bytes(int batch, int n,
                                              int block_rows) {
  const long long total = (long long)batch * n;
  const long long max_big = total / (block_rows + 1) + 1;
  long long bytes = 16 + 16 * max_big;
  if (n > block_rows) bytes += 25 * total;
  return bytes;
}

// boxes [B, n, 4] f32 (16-byte aligned), cls [B, n] f32 (null unless
// class_aware), valid [B, n] bool, skey [B * n] f32 and perm [B * n]
// int64 from the stable sort of the segment keys (both null: each image
// is one segment of its valid rows), keep [B, n] bool out (zeroed here),
// scratch of mx_box_nms_scratch_bytes; all contiguous.  pairs: a zeroed
// u64 that counts the IoUs computed, or null.  block_rows: the positions
// a block stages in shared memory, a multiple of 64 in [64, 8192].
extern "C" int mx_box_nms(const void* boxes, const void* cls,
                          const void* valid, const void* skey,
                          const void* perm, void* keep, void* scratch,
                          long long scratch_bytes, void* pairs, int batch,
                          int n, int block_rows, float thresh,
                          int class_aware, void* stream) {
  const long long total = (long long)batch * n;
  if (batch <= 0 || n <= 0 || total >= (1ll << 31) - kItem ||
      block_rows < kTile || block_rows > 8192 || block_rows % kTile ||
      (skey == nullptr) != (perm == nullptr))
    return (int)cudaErrorInvalidValue;
  if (scratch_bytes < mx_box_nms_scratch_bytes(batch, n, block_rows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long max_big = total / (block_rows + 1) + 1;
  unsigned char* p = static_cast<unsigned char*>(scratch);
  Args a;
  a.boxes = static_cast<const float4*>(boxes);
  a.cls = static_cast<const float*>(cls);
  a.valid = static_cast<const uint8_t*>(valid);
  a.skey = static_cast<const float*>(skey);
  a.perm = static_cast<const int64_t*>(perm);
  a.keep = static_cast<uint8_t*>(keep);
  a.counters = reinterpret_cast<int*>(p);
  a.big = reinterpret_cast<Big*>(p + 16);
  unsigned char* lists = p + 16 + 16 * max_big;
  a.may_big = n > block_rows;
  a.kbox = a.may_big ? reinterpret_cast<float4*>(lists) : nullptr;
  a.karea = a.may_big ? reinterpret_cast<float*>(lists + 16 * total)
                      : nullptr;
  a.kcls = a.may_big ? a.karea + total : nullptr;
  a.removed = a.may_big ? reinterpret_cast<uint8_t*>(a.kcls + total)
                        : nullptr;
  a.pairs = static_cast<unsigned long long*>(pairs);
  a.total = (int)total;
  a.n = n;
  // a segment that fits never spans more positions than an image holds
  a.block_rows = a.may_big ? block_rows : ((n + kTile - 1) / kTile) * kTile;
  // the midpoint of thresh and the next float up, exact in double; at
  // FLT_MAX the next is inf, and the quotients that round to inf are
  // those from FLT_MAX plus half its ulp (a tie: FLT_MAX is odd)
  const float up = nextafterf(thresh, INFINITY);
  a.above.mid = isinf(up) && !isinf(thresh)
                    ? (double)FLT_MAX + ldexp(1.0, 103)
                    : ((double)thresh + (double)up) / 2;
  unsigned up_bits;
  memcpy(&up_bits, &up, sizeof(up_bits));
  a.above.tie_up = isinf(up) || (up_bits & 1u) == 0;
  a.above.zero_above = 0.f > thresh;
  a.above.inf_above = INFINITY > thresh;
  const bool fast = thresh >= ldexpf(1.f, -80) && thresh <= ldexpf(1.f, 40);
  a.above.lo = fast ? (float)((double)thresh * (1 - ldexp(1.0, -20))) : NAN;
  a.above.hi = fast ? (float)((double)thresh * (1 + ldexp(1.0, -20))) : NAN;
  a.class_aware = class_aware;
  const size_t smem = dyn_smem(a.block_rows, class_aware);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  DeviceInfo& info = g_devices[dev];
  if (info.sms == 0) {
    e = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
  }
  if (smem > info.smem_set) {
    e = cudaFuncSetAttribute(nms_segments,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    info.smem_set = smem;
  }
  if (smem != info.smem_seen) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info.per_sm, nms_segments, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    info.smem_seen = smem;
  }
  const int per_sm = info.per_sm;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (total + kItem - 1) / kItem;
  const long long most = (long long)per_sm * info.sms;
  const int grid = (int)(items < most ? items : most);
  if ((e = cudaMemsetAsync(a.counters, 0, 2 * sizeof(int), st)) !=
          cudaSuccess ||
      (e = cudaMemsetAsync(keep, 0, (size_t)total, st)) != cudaSuccess)
    return (int)e;
  if (a.may_big) {  // step 2's grid barriers need every block resident
    void* args[] = {&a};
    e = cudaLaunchCooperativeKernel((const void*)nms_segments, dim3(grid),
                                    dim3(kThreads), args, smem, st);
    if (e != cudaSuccess) return (int)e;
  } else {
    nms_segments<<<grid, kThreads, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
