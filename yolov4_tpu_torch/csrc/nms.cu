// Exact greedy NMS keep mask on Hopper (sm_90a).
//
// Replaces the TPU kernel greedy_nms_mask_pallas / _nms_kernel
// (yolov4_tpu/ops/nms_pallas.py:37-191). Same function: candidate i of a
// score-sorted image is dropped iff a higher-ranked, kept, valid j has
// inter / max(union, 1e-12) >= t.
//
// The TPU kernel walks its (image, row-block) grid in order and carries the
// running keep vector in scratch from one grid step to the next; blocks on a
// GPU run in no order, so the work is split in two launches. Both are held
// on the CPU by ops/nms.py: pair_mask_words is the mask this kernel writes,
// scan_mask_words the scan, step for step.
//
//   1. nms_mask_kernel: the pair bit mask [B, 64 * n_words, n_words] (rows
//      padded to whole row blocks; n_words = ceil(K/64)). Bit u of word w of
//      row j is set iff target i = 64w + u > j, i < K and IoU(j, i) >= t.
//      Only the triangle of (row block, column block) tiles with column >=
//      row is launched, through a 1-D index over n_words(n_words+1)/2 tiles
//      an image, four 64-row tiles to a 256-thread block with the targets'
//      boxes and areas staged in shared memory; each thread writes one word.
//      Words below the diagonal are never written and never read. With
//      t > 0 a disjoint pair (inter == 0) cannot reach t, whatever the
//      union (even +inf), so it skips the division; most pairs of the class-
//      offset main path are disjoint. At t <= 0 a disjoint pair does
//      suppress, and the guard keeps the division.
//   2. nms_scan_kernel, one 256-thread block an image, walks the K/64 row
//      blocks in order. The `removed` bitset (n_words words in shared
//      memory) starts as the invalid candidates and the bits past K. For row
//      block r:
//        - its mask rows (one contiguous slab of 64 * n_words words) are
//          already in a ring of kSlots shared-memory slots: one
//          cp.async.bulk a slab, completed on the slot's mbarrier, issued
//          kSlots - 1 blocks ahead of use;
//        - warp 0 resolves the block's 64 candidates (not in removed[r])
//          from the 64 diagonal words, two a lane, in registers: those that
//          no candidate can suppress and that suppress no candidate are
//          kept at once (two warp reductions and two ballots); the rest go
//          in rank order, lowest first, each kept one clearing its targets
//          with one 64-bit shuffle. The result is one keep word;
//        - every thread owns words w > r and ORs in the kept rows' words
//          from the slot, independent shared-memory loads;
//        - 64 keep bytes go out as one coalesced store.
//      K/64 serial steps an image (32 at K=2048), none waiting on device
//      memory unless a slab is late. Where the ring does not fit in 227 KB
//      (K above about 14.4k) the same walk reads the rows straight from
//      device memory (kStaged = false).
//
// What bounds it on this card: the pair test is ~14 float32 operations for
// each of B*K*(K-1)/2 pairs (0.44 GFLOP at B=16, K=2048: ~7 us at 67
// TFLOP/s), and the bytes it must move are tiny (boxes in, keep out). The
// serial scan and the round trip of the bit mask through L2 are what the
// design pays on top of that.
//
// Numerics: the IoU is the Pallas formula operation for operation, with
// IEEE round-to-nearest intrinsics so that nvcc cannot contract
// `area_s + area_t - iw*ih` into an FMA (the class offset lifts coordinates
// to ~1e5, where one ulp flips decisions near t). Build with -fmad=false
// and never with --use_fast_math. Bits are `1ull << u`: bit 63 is a target.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

using u64 = unsigned long long;
using namespace ptx;

constexpr int kWord = 64;                  // targets per mask word
constexpr int kMaskThreads = 256;          // four 64-row tiles a block
constexpr int kTilesPerBlock = kMaskThreads / kWord;
constexpr int kScanThreads = 256;
// slabs in the scan's ring: at K=2048 two timed 2% faster than three on an
// H100 (tools/nms_ring_depth.py); a build may set another depth to time it
#ifndef NMS_SCAN_SLOTS
#define NMS_SCAN_SLOTS 2
#endif
constexpr int kSlots = NMS_SCAN_SLOTS;
static_assert(kSlots >= 2, "the ring needs a slot in use and one filling");
constexpr int kSmemLimit = 232448;         // 227 KB a block on sm_90
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// tile t of an image's triangle, column by column: t = cb(cb+1)/2 + rb with
// rb <= cb
__device__ __forceinline__ void triangle_tile(int t, int& rb, int& cb) {
  int c = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (c > 0 && c * (c + 1) / 2 > t) --c;
  while ((c + 1) * (c + 2) / 2 <= t) ++c;
  cb = c;
  rb = t - c * (c + 1) / 2;
}

__global__ void __launch_bounds__(kMaskThreads)
    nms_mask_kernel(const float4* __restrict__ boxes, u64* __restrict__ mask,
                    int k, int n_words, int n_tiles, float thresh) {
  __shared__ float4 tbox[kTilesPerBlock][kWord];
  __shared__ float tarea[kTilesPerBlock][kWord];
  const int sub = threadIdx.x / kWord;
  const int lane = threadIdx.x % kWord;
  const int tile = blockIdx.x * kTilesPerBlock + sub;
  const size_t img = blockIdx.y;
  const float4* bx = boxes + img * k;
  const bool live = tile < n_tiles;
  int rb = 0, cb = 0;
  if (live) {
    triangle_tile(tile, rb, cb);
    const int i = cb * kWord + lane;
    if (i < k) {
      const float4 b = bx[i];
      tbox[sub][lane] = b;
      tarea[sub][lane] = box_area(b);
    }
  }
  __syncthreads();

  const int j = rb * kWord + lane;
  if (!live || j >= k) return;
  const float4 s = bx[j];
  const float sarea = box_area(s);
  const int n = min(kWord, k - cb * kWord);
  const bool skip_disjoint = thresh > 0.0f;
  u64 bits = 0ull;
  for (int u = cb == rb ? lane + 1 : 0; u < n; ++u) {
    const float4 tb = tbox[sub][u];
    const float iw = fmaxf(__fsub_rn(fminf(s.z, tb.z), fmaxf(s.x, tb.x)), 0.0f);
    const float ih = fmaxf(__fsub_rn(fminf(s.w, tb.w), fmaxf(s.y, tb.y)), 0.0f);
    const float inter = __fmul_rn(iw, ih);
    if (inter == 0.0f && skip_disjoint) continue;
    const float uni =
        fmaxf(__fsub_rn(__fadd_rn(sarea, tarea[sub][u]), inter), 1e-12f);
    if (__fdiv_rn(inter, uni) >= thresh) bits |= 1ull << u;
  }
  mask[(img * n_words * kWord + j) * n_words + cb] = bits;
}

// The keep word of one row block, by the 32 lanes of a warp together.
// cand: the block's candidates still standing (valid, not removed); lane l
// holds the diagonal words of rows l (d0) and l + 32 (d1), zero past K.
__device__ __forceinline__ u64 resolve_block(u64 cand, u64 d0, u64 d1,
                                             int lane) {
  const u64 mine = (((cand >> lane) & 1ull) ? d0 : 0ull) |
                   (((cand >> (lane + 32)) & 1ull) ? d1 : 0ull);
  // targets some candidate might suppress
  const u64 hit =
      (static_cast<u64>(__reduce_or_sync(~0u, static_cast<unsigned>(mine >> 32)))
       << 32) |
      __reduce_or_sync(~0u, static_cast<unsigned>(mine));
  // candidates whose rows suppress no candidate
  const u64 quiet =
      (static_cast<u64>(__ballot_sync(~0u, (d1 & cand) == 0ull)) << 32) |
      __ballot_sync(~0u, (d0 & cand) == 0ull);
  u64 keep = cand & ~hit & quiet;
  u64 left = cand & ~keep;
  while (left) {  // warp-uniform: lowest undecided candidate is kept
    const int u = __ffsll(static_cast<long long>(left)) - 1;
    const u64 du = __shfl_sync(~0u, u < 32 ? d0 : d1, u & 31);
    keep |= 1ull << u;
    left &= ~(du | (1ull << u));
  }
  return keep;
}

template <bool kStaged>
__global__ void __launch_bounds__(kScanThreads)
    nms_scan_kernel(const u64* __restrict__ mask,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep, int k, int n_words) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ u64 keep_word;
  const size_t slab_words = static_cast<size_t>(kWord) * n_words;
  u64* const slab = reinterpret_cast<u64*>(smem);
  u64* const removed = slab + (kStaged ? kSlots * slab_words : 0);
  u64* const bars = removed + n_words;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t b = blockIdx.x;
  const u64* rows = mask + b * slab_words * n_words;
  const uint8_t* v = valid + b * k;
  uint8_t* out = keep + b * k;

  // slab of row block r into slot r % kSlots
  auto issue = [&](int r) {
    const int slot = r % kSlots;
    const uint32_t bar = smem_u32(bars + slot);
    const uint32_t bytes = static_cast<uint32_t>(slab_words * sizeof(u64));
    fence_proxy_async();  // the slot's last reads before the copy's writes
    mbar_expect_tx(bar, bytes);
    bulk_copy(smem_u32(slab + slot * slab_words), rows + r * slab_words,
              bytes, bar);
  };
  if (kStaged && tid == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(smem_u32(bars + s), 1);
    fence_mbar_init();
    for (int r = 0; r < kSlots - 1 && r < n_words; ++r) issue(r);
  }
  // removed starts as the invalid candidates and the bits past K
  for (int w = warp; w < n_words; w += kScanThreads / 32) {
    const int i = w * kWord + lane;
    const unsigned lo = __ballot_sync(~0u, i < k && v[i]);
    const unsigned hi = __ballot_sync(~0u, i + 32 < k && v[i + 32]);
    if (lane == 0) removed[w] = ~((static_cast<u64>(hi) << 32) | lo);
  }
  __syncthreads();

  for (int r = 0; r < n_words; ++r) {
    const u64* src;
    if constexpr (kStaged) {
      // the slot of block r + kSlots - 1 was last read in step r - 1
      if (tid == 0 && r + kSlots - 1 < n_words) issue(r + kSlots - 1);
      const int slot = r % kSlots;
      mbar_wait(smem_u32(bars + slot), (r / kSlots) & 1);
      src = slab + slot * slab_words;
    } else {
      src = rows + r * slab_words;
    }
    const int i0 = r * kWord;
    if (warp == 0) {
      const u64 d0 = i0 + lane < k ? src[lane * n_words + r] : 0ull;
      const u64 d1 = i0 + lane + 32 < k ? src[(lane + 32) * n_words + r] : 0ull;
      const u64 kw = resolve_block(~removed[r], d0, d1, lane);
      if (lane == 0) keep_word = kw;
    }
    __syncthreads();
    const u64 kw = keep_word;
    for (int w = r + 1 + tid; w < n_words; w += kScanThreads) {
      // branch-free: 64 independent loads, each masked by its keep bit
      u64 acc = 0ull;
#pragma unroll
      for (int u = 0; u < kWord; ++u)
        acc |= src[u * n_words + w] & (0ull - ((kw >> u) & 1ull));
      removed[w] |= acc;
    }
    if (tid < kWord && i0 + tid < k)
      out[i0 + tid] = static_cast<uint8_t>((kw >> tid) & 1ull);
    __syncthreads();  // removed[r + 1] and keep_word settled, slot read
  }
}

int words_of(int k) { return (k + kWord - 1) / kWord; }

// the ring (kSlots slabs and their mbarriers) and the removed bitset
long long staged_smem_of(int k) {
  const long long nw = words_of(k);
  return kSlots * (kWord * nw * 8 + 8) + nw * 8;
}

bool staged(int k) { return staged_smem_of(k) <= kSmemLimit; }

long long scan_smem_of(int k) {
  return staged(k) ? staged_smem_of(k) : words_of(k) * 8ll;
}

}  // namespace

// Dynamic shared memory of the scan launch at this K (bytes), and the
// number of slabs in its ring (0: the rows come from device memory).
extern "C" int nms_scan_smem(int k) { return static_cast<int>(scan_smem_of(k)); }
extern "C" int nms_scan_slots(int k) { return staged(k) ? kSlots : 0; }

// boxes: [B, K, 4] float32 xyxy, 16-byte aligned, score-sorted along K.
// mask: [B, 64 * ceil(K/64), ceil(K/64)] 64-bit words, 16-byte aligned.
extern "C" int nms_pair_mask(const void* boxes, void* mask, int batch, int k,
                             float thresh, void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  const int nw = words_of(k);
  const int n_tiles = nw * (nw + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const dim3 grid((n_tiles + kTilesPerBlock - 1) / kTilesPerBlock,
                    std::min(kMaxGridY, batch - b0));
    nms_mask_kernel<<<grid, kMaskThreads, 0, s>>>(
        static_cast<const float4*>(boxes) + static_cast<size_t>(b0) * k,
        static_cast<u64*>(mask) + static_cast<size_t>(b0) * kWord * nw * nw,
        k, nw, n_tiles, thresh);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// mask as nms_pair_mask writes it; valid: [B, K] bool (one byte each);
// keep: [B, K] bool output.
extern "C" int nms_scan(const void* mask, const void* valid, void* keep,
                        int batch, int k, void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  const int nw = words_of(k);
  const int smem = static_cast<int>(scan_smem_of(k));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* kernel = staged(k) ? nms_scan_kernel<true> : nms_scan_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, kScanThreads, smem, s>>>(
      static_cast<const u64*>(mask), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, nw);
  return static_cast<int>(cudaGetLastError());
}

// Both launches, in order, on `stream`; no synchronisation. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int nms_keep_mask(const void* boxes, const void* valid, void* mask,
                             void* keep, int batch, int k, float thresh,
                             void* stream) {
  const int err = nms_pair_mask(boxes, mask, batch, k, thresh, stream);
  if (err != 0) return err;
  return nms_scan(mask, valid, keep, batch, k, stream);
}
