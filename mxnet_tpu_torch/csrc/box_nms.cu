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
// Two kernels:
//   nms_mask  one 64-thread block a (row tile, column tile) pair with the
//             column tile at or after the row tile, grid.z the image:
//             thread t writes word (i, cb) of the suppression bit mask,
//             bit k set when row i suppresses row cb*64 + k > i and that
//             row is valid.  n x ceil(n/64) 64-bit words an image (533 MB
//             at n = 65,280); words left of the diagonal are not written
//             and never read.
//   nms_walk  one block an image walks the 64-row tiles in order.  The
//             removed set (one bit a row) lives in shared memory.  Thread
//             0 resolves a tile's 64 rows in order from the tile's
//             diagonal words; then every thread ORs the kept rows' words
//             into the removed words after the tile.
//
// Bitwise: the IoU rounds as the plain version (cuda_kernels.
// box_nms_sorted_plain) and the reference's `_corner_iou` write it, one
// rounding an operation: max/min corners, clip(br - tl, 0), inter = w * h,
// each area clip(x2 - x1, 0) * clip(y2 - y1, 0), then
// inter / max((area_a + area_b) - inter, 1e-12), compared with the f32
// threshold.  Every product, sum and quotient is an explicit _rn
// intrinsic, so nvcc contracts nothing into an FMA.  max, min and clip
// propagate NaN as torch.maximum / torch.clamp do.
//
// What bounds it on the H100: operations.  The greedy scan needs, for
// each kept row, the IoU with every later valid row (of its class when
// class_aware); the bytes (20 in and 1 out a row) are noise.  This first
// kernel computes every pair of the upper triangle instead (n^2 / 2 IoUs
// an image, ~15 f32 operations each), writes the bit mask to device
// memory and walks it on one SM an image; both are candidates for a
// redesign.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kWalkThreads = 512;

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

__device__ __forceinline__ float max_nan(float a, float b) {
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  return a > b ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  return a < b ? a : b;
}

__device__ __forceinline__ float clip0(float x) {
  return (is_nan(x) || x > 0.f) ? x : 0.f;
}

__device__ __forceinline__ float area_of(float4 a) {
  return __fmul_rn(clip0(__fsub_rn(a.z, a.x)), clip0(__fsub_rn(a.w, a.y)));
}

// iou of earlier row a (area aa) and later row b (area ab)
__device__ __forceinline__ float iou(float4 a, float aa, float4 b,
                                     float ab) {
  const float w = clip0(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)));
  const float h = clip0(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)));
  const float inter = __fmul_rn(w, h);
  const float den = max_nan(__fsub_rn(__fadd_rn(aa, ab), inter), 1e-12f);
  return __fdiv_rn(inter, den);
}

__global__ void __launch_bounds__(kTile)
nms_mask(const float4* __restrict__ boxes, const float* __restrict__ cls,
         const uint8_t* __restrict__ valid,
         unsigned long long* __restrict__ mask, int n, int words,
         float thresh, int class_aware) {
  const int cb = blockIdx.x, rb = blockIdx.y;
  if (cb < rb) return;
  const int64_t base = (int64_t)blockIdx.z * n;
  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  __shared__ float ccls[kTile];
  __shared__ uint8_t cvalid[kTile];
  const int t = threadIdx.x;
  const int cols = min(kTile, n - cb * kTile);
  if (t < cols) {
    const int64_t j = base + cb * kTile + t;
    const float4 c = boxes[j];
    cbox[t] = c;
    carea[t] = area_of(c);
    ccls[t] = class_aware ? cls[j] : 0.f;
    cvalid[t] = valid[j];
  }
  __syncthreads();
  const int i = rb * kTile + t;
  if (i >= n) return;
  unsigned long long bits = 0;
  if (valid[base + i]) {
    const float4 a = boxes[base + i];
    const float aa = area_of(a);
    const float ca = class_aware ? cls[base + i] : 0.f;
    for (int k = (cb == rb) ? t + 1 : 0; k < cols; ++k) {
      if (!cvalid[k]) continue;
      float v = iou(a, aa, cbox[k], carea[k]);
      if (class_aware && !(ccls[k] == ca)) v = 0.f;
      if (v > thresh) bits |= 1ull << k;
    }
  }
  mask[(base + i) * words + cb] = bits;
}

__global__ void __launch_bounds__(kWalkThreads)
nms_walk(const unsigned long long* __restrict__ mask,
         const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
         int n, int words) {
  extern __shared__ unsigned long long removed[];  // words
  __shared__ unsigned long long diag[kTile];
  __shared__ uint8_t dvalid[kTile];
  __shared__ unsigned long long kept_bits;
  const int64_t base = (int64_t)blockIdx.x * n;
  const unsigned long long* m = mask + base * words;
  const int t = threadIdx.x;
  for (int w = t; w < words; w += kWalkThreads) removed[w] = 0ull;
  __syncthreads();
  for (int nb = 0; nb < words; ++nb) {
    const int i0 = nb * kTile;
    const int rows = min(kTile, n - i0);
    if (t < rows) {
      const uint8_t v = valid[base + i0 + t];
      dvalid[t] = v;
      diag[t] = v ? m[(int64_t)(i0 + t) * words + nb] : 0ull;
    }
    __syncthreads();
    if (t == 0) {
      unsigned long long cur = removed[nb], kb = 0ull;
      for (int k = 0; k < rows; ++k) {
        if (dvalid[k] && !((cur >> k) & 1ull)) {
          kb |= 1ull << k;
          cur |= diag[k];
        }
      }
      kept_bits = kb;
    }
    __syncthreads();
    const unsigned long long kb = kept_bits;
    if (t < rows) keep[base + i0 + t] = (uint8_t)((kb >> t) & 1ull);
    if (kb) {
      for (int w = nb + 1 + t; w < words; w += kWalkThreads) {
        unsigned long long acc = removed[w];
        unsigned long long left = kb;
        while (left) {
          const int k = __ffsll((long long)left) - 1;
          left &= left - 1;
          acc |= m[(int64_t)(i0 + k) * words + w];
        }
        removed[w] = acc;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// boxes [B, n, 4] f32, cls [B, n] f32 (null unless class_aware), valid
// [B, n] bool, mask [B, n, words] u64 scratch (words = ceil(n / 64)); all
// contiguous, boxes 16-byte aligned.
extern "C" int mx_box_nms_mask(const void* boxes, const void* cls,
                               const void* valid, void* mask, int batch,
                               int n, float thresh, int class_aware,
                               void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int words = (n + kTile - 1) / kTile;
  if (words > 65535 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)words, (unsigned)words, (unsigned)batch);
  nms_mask<<<grid, kTile, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(cls),
      static_cast<const uint8_t*>(valid),
      static_cast<unsigned long long*>(mask), n, words, thresh,
      class_aware);
  return (int)cudaGetLastError();
}

// mask as written by mx_box_nms_mask; valid [B, n] bool; keep [B, n]
// bool out.
extern "C" int mx_box_nms_walk(const void* mask, const void* valid,
                               void* keep, int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int words = (n + kTile - 1) / kTile;
  const size_t smem = (size_t)words * sizeof(unsigned long long);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  nms_walk<<<batch, kWalkThreads, smem, st>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), n,
      words);
  return (int)cudaGetLastError();
}

extern "C" const char* mx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
