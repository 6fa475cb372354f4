// Exact greedy NMS keep mask on Hopper (sm_90a).
//
// Replaces the TPU kernel greedy_nms_mask_pallas / _nms_kernel
// (yolov4_tpu/ops/nms_pallas.py:37-191). Same function: candidate i of a
// score-sorted image is dropped iff a higher-ranked, kept, valid j has
// inter / max(union, 1e-12) >= t.
//
// The TPU kernel walks its (image, row-block) grid in order and carries the
// running keep vector in scratch from one grid step to the next; blocks on a
// GPU run in no order, so this design splits the work in two launches:
//
//   1. nms_mask_kernel, grid (ceil(K/64), ceil(K/64), B), 64 threads: each
//      thread owns one suppressor row j and writes ONE 64-bit word — which
//      of the 64 targets i > j of its column block it overlaps at IoU >= t.
//      Blocks strictly below the diagonal hold no pair j < i and return at
//      once, so half the grid does no work. The [B, K, ceil(K/64)] bit mask
//      (8 MiB at B=16, K=2048) goes through device memory.
//   2. nms_scan_kernel, one warp per image: the `removed` bitset
//      (ceil(K/64) words, 256 B at K=2048) lives in shared memory; lane 0
//      walks i in rank order, i is kept iff valid and not removed, and the
//      lanes OR row i's words into `removed`, one word per lane.
//
// What bounds it on this card: the pair test is ~14 float32 operations for
// each of B*K*(K-1)/2 pairs (0.44 GFLOP at B=16, K=2048: ~7 us at 67
// TFLOP/s), and the bytes it must move are tiny (boxes in, keep out). The
// serial scan is what this simple design pays for instead: K dependent
// steps on only B busy SMs, plus a round trip of the bit mask through
// device memory. Making it fast is later work.
//
// Numerics: the IoU is the Pallas formula operation for operation, with
// IEEE round-to-nearest intrinsics so that nvcc cannot contract
// `area_s + area_t - iw*ih` into an FMA (the class offset lifts coordinates
// to ~1e5, where one ulp flips decisions near t). Build with -fmad=false
// and never with --use_fast_math.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWord = 64;  // targets per mask word = threads per mask block

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes,
                                unsigned long long* __restrict__ mask,
                                int k, int n_words, float thresh) {
  const int cb = blockIdx.x;  // target (column) block
  const int rb = blockIdx.y;  // suppressor (row) block
  if (cb < rb) return;        // every target precedes every suppressor
  const float4* img = boxes + static_cast<size_t>(blockIdx.z) * k;

  __shared__ float4 tbox[kWord];
  __shared__ float tarea[kWord];
  const int t = threadIdx.x;
  const int i0 = cb * kWord;
  if (i0 + t < k) {
    const float4 b = img[i0 + t];
    tbox[t] = b;
    tarea[t] = box_area(b);
  }
  __syncthreads();

  const int j = rb * kWord + t;
  if (j >= k) return;
  const float4 s = img[j];
  const float sarea = box_area(s);
  const int n = min(kWord, k - i0);
  unsigned long long bits = 0ull;
  for (int u = 0; u < n; ++u) {
    if (i0 + u <= j) continue;
    const float4 tb = tbox[u];
    const float iw = fmaxf(__fsub_rn(fminf(s.z, tb.z), fmaxf(s.x, tb.x)), 0.0f);
    const float ih = fmaxf(__fsub_rn(fminf(s.w, tb.w), fmaxf(s.y, tb.y)), 0.0f);
    const float inter = __fmul_rn(iw, ih);
    const float uni =
        fmaxf(__fsub_rn(__fadd_rn(sarea, tarea[u]), inter), 1e-12f);
    if (__fdiv_rn(inter, uni) >= thresh) bits |= 1ull << u;
  }
  mask[(static_cast<size_t>(blockIdx.z) * k + j) * n_words + cb] = bits;
}

// One warp per image. Only words w >= i/64 of row i are read: those are
// exactly the words the mask kernel wrote (column block >= row block).
__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ keep, int k,
                                int n_words) {
  extern __shared__ unsigned long long removed[];
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  for (int w = lane; w < n_words; w += 32) removed[w] = 0ull;
  __syncwarp();

  const unsigned long long* rows = mask + b * k * n_words;
  const uint8_t* v = valid + b * k;
  uint8_t* out = keep + b * k;
  for (int i = 0; i < k; ++i) {
    const int wi = i / kWord;
    int kept = 0;
    if (lane == 0) {
      kept = v[i] && !((removed[wi] >> (i % kWord)) & 1ull);
      out[i] = static_cast<uint8_t>(kept);
    }
    // the shuffle orders lane 0's read of removed[wi] before any update
    kept = __shfl_sync(0xffffffffu, kept, 0);
    if (kept) {
      const unsigned long long* row = rows + static_cast<size_t>(i) * n_words;
      for (int w = wi + lane; w < n_words; w += 32) removed[w] |= row[w];
    }
    __syncwarp();
  }
}

}  // namespace

// boxes: [B, K, 4] float32 xyxy, 16-byte aligned, score-sorted along K.
// valid: [B, K] bool (one byte each). mask: [B, K, ceil(K/64)] 64-bit
// scratch. keep: [B, K] bool output. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launches.
extern "C" int nms_keep_mask(const void* boxes, const void* valid, void* mask,
                             void* keep, int batch, int k, float thresh,
                             void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  const int n_words = (k + kWord - 1) / kWord;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_words, n_words, batch);
  nms_mask_kernel<<<grid, kWord, 0, s>>>(
      static_cast<const float4*>(boxes),
      static_cast<unsigned long long*>(mask), k, n_words, thresh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<batch, 32, n_words * sizeof(unsigned long long), s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k,
      n_words);
  return static_cast<int>(cudaGetLastError());
}
