// Eval-time CSP stage body on Hopper (sm_90a): every conv + folded-BN bias +
// algebraic Mish of a CSPDarknet53 stage after its base conv.
//
// Replaces the TPU kernel fused_csp_stage (yolov4_tpu/ops/csp_pallas.py:344,
// bodies _csp0_kernel :236 and _csp_kernel :281). Same function and the same
// rounding points as ops/csp.py::fused_csp_stage_plain, which is the
// reference this kernel is held against.
//
// What bounds it on this card. At 608/b16 the three stage bodies are 121.1,
// 87.8 and 269.5 GFLOP of bf16 products: 0.12, 0.09 and 0.27 ms at 989
// TFLOP/s. Counting only x and out, their bytes take 0.11, 0.06 and
// 0.06 ms at 3.35 TB/s. A Hopper block has 227 KB of shared memory and
// stage 3's halo'd window (the TPU kernel's ~11 MB VMEM design) is
// >= 640 KB, so some intermediates go through memory. With the plan below
// they bring stage 1 to ~1.33 GB (0.40 ms) and stage 2 to ~0.66 GB
// (0.20 ms): stages 1-2 are bound by bytes, stage 3 by operations.
//
// bfloat16, the main path:
//   * Launch plan (ops/csp.py::launch_plan, followed here in the same
//     order): each 1x1 conv after the first runs chained in the epilogue of
//     the conv before it, as a second GEMM whose A operand is the first
//     one's output rounded to bf16 in registers (wgmma with A from
//     registers). That rounding is the plain version's store and reload, so
//     every rounding point holds. csp0 takes 2 launches, csp nb + 1: 14 per
//     608 forward instead of 31. Stored: what a later launch reads at
//     neighbouring pixels (the 3x3 inputs t and p, p in two buffers used in
//     turn) or at its own pixels (a, h, x1), and out.
//   * Each launch is a persistent implicit GEMM over 128-pixel tiles
//     (M = B*H*W), one block per SM. A producer warpgroup (setmaxnreg down to
//     64 registers) fills a 4-stage ring in dynamic shared memory and runs on
//     into the next tile during an epilogue; two consumer warpgroups (216
//     registers, 64 rows each) run wgmma.mma_async m64nNk16 with float32
//     accumulators, N the conv's full output width, so that A is gathered
//     once per conv. Full and empty mbarriers pass the slots.
//   * The producer brings A 64 channels (128 bytes) of K per slot with
//     16-byte cp.async, per tap for a 3x3, zero-filled (src-size 0) at image
//     borders, for rows past M and past K; and the slot's B chunk with one
//     bulk copy (cp.async.bulk): ops/csp.py::pack_weights stores each weight
//     transposed, zero-padded and already in wgmma's 128-byte swizzle.
//   * The epilogue works on the accumulator registers: bias, Mish, csp0's
//     sum or csp's residual, the chained GEMM; stores go through a padded
//     staging buffer in shared memory as 16-byte row stores. Mish takes one
//     MUFU operation an element (mish_wg): with two (e^x and a division),
//     the special-function unit was the bound of the whole launch.
//   * Widths are template parameters: a stage with C channels runs the
//     instance of the smallest CP >= C (ops/csp.py::KERNEL_WIDTHS: up to 128
//     for csp0, whose first GEMM is 2C wide, and 256 otherwise) with its
//     channels zero-padded, so ragged widths take the same design; the
//     padded channels compute mish(0) = 0 and are never stored to out.
//
// float32 keeps the earlier scalar design: one scalar-FMA implicit GEMM tile
// per conv (5 launches for csp0, 2*nb + 3 for csp, no chaining: its GEMMs
// are those of the plan, launched one by one), so that it can be held to
// 1e-4 of the plain version with TF32 off. It is not on the main path; its
// weights are plain [K, N] matrices.

#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

// kernel launches enqueued, both dtypes; atomic, since ctypes releases the
// GIL and two serving buckets' host threads may run csp_stage at once
std::atomic<long long> g_conv_launches{0};

// ---------------------------------------------------------------------------
// float32: one scalar-FMA implicit GEMM per conv
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 64, BK = 32, THREADS = 256;
constexpr int LDC = BN + 4;  // float32 epilogue tile stride
constexpr int EPI_NONE = 0, EPI_SUM = 1, EPI_RESID = 2;

// Shared-memory row strides (elements): 16-byte aligned rows.
template <typename T> struct Tile {
  static constexpr int lda = BK + 4;
  static constexpr int ldb = BN;
  static constexpr int bytes_ab = (BM * lda + BK * ldb) * (int)sizeof(T);
};
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kSmemBytes = cmax(Tile<float>::bytes_ab, BM * LDC * 4);
static_assert(kSmemBytes <= 48 * 1024, "static shared memory limit");

template <typename T> struct ConvArgs {
  const T* a0; long long lda0; int k0;  // first K range (the only one of a 3x3)
  const T* a1; long long lda1; int k1;  // second K range of a 1x1, k1 may be 0
  const T* w; const float* bias; int n; // w [K, n] row-major, bias [n]
  const T* res; long long ldres;        // EPI_SUM / EPI_RESID operand
  T* out; long long ldo;
  long long m; int h, width;            // m = B*H*W pixels of an H x W image
};

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// Algebraic Mish, the formula of models/layers.py: x * a / (a + 2) with
// a = e^x (e^x + 2), x itself above 20.
__device__ __forceinline__ float mish(float x) {
  float e = expf(fminf(x, 20.0f));
  float a = e * (e + 2.0f);
  return x > 20.0f ? x : x * a / (a + 2.0f);
}

template <typename T, int VEC>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src) {
  if constexpr (VEC == 1) {
    *dst = *src;
  } else {  // 8 float = 2 x 16 bytes
    reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
    reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void zero_chunk(T* dst) {
  if constexpr (VEC == 1) {
    *dst = from_f32<T>(0.0f);
  } else {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(dst)[0] = z;
    reinterpret_cast<float4*>(dst)[1] = z;
  }
}

// One K step's A [BM, BK] and B [BK, BN] tiles into shared memory, zeros
// outside the matrices and at the 3x3's image borders. A host check makes
// every VEC chunk lie inside one K range and one tap.
template <typename T, int KS, int VEC, int A_CHUNKS>
__device__ __forceinline__ void load_tiles(const ConvArgs<T>& p, int K, int kt,
                                           int n0, T* As, T* Bs,
                                           const long long (&am)[A_CHUNKS],
                                           const int (&ay)[A_CHUNKS],
                                           const int (&ax)[A_CHUNKS]) {
  constexpr int A_CPR = BK / VEC, B_CPR = BN / VEC;
  constexpr int B_CHUNKS = BK * B_CPR / THREADS;
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < A_CHUNKS; ++j) {
    const int idx = tid + j * THREADS;
    const int r = idx / A_CPR, kc = idx % A_CPR;
    const int k = kt + kc * VEC;
    const long long m = am[j];
    const T* src = nullptr;
    if (m < p.m && k < K) {
      if constexpr (KS == 1) {
        src = k < p.k0 ? p.a0 + m * p.lda0 + k
                       : p.a1 + m * p.lda1 + (k - p.k0);
      } else {
        const int tap = k / p.k0, c = k - tap * p.k0;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        const int yy = ay[j] + dy, xx = ax[j] + dx;
        if (yy >= 0 && yy < p.h && xx >= 0 && xx < p.width)
          src = p.a0 + (m + dy * p.width + dx) * p.lda0 + c;
      }
    }
    T* dst = As + r * Tile<T>::lda + kc * VEC;
    if (src) copy_chunk<T, VEC>(dst, src); else zero_chunk<T, VEC>(dst);
  }
#pragma unroll
  for (int j = 0; j < B_CHUNKS; ++j) {
    const int idx = tid + j * THREADS;
    const int kr = idx / B_CPR, nc = idx % B_CPR;
    const int k = kt + kr, n = n0 + nc * VEC;
    T* dst = Bs + kr * Tile<T>::ldb + nc * VEC;
    if (k < K && n < p.n) copy_chunk<T, VEC>(dst, p.w + (long long)k * p.n + n);
    else zero_chunk<T, VEC>(dst);
  }
}

template <typename T, int KS, int EPI, int VEC>
__global__ void __launch_bounds__(THREADS) csp_conv_kernel(ConvArgs<T> p) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + BM * Tile<T>::lda * sizeof(T));
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  constexpr int A_CHUNKS = BM * (BK / VEC) / THREADS;
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = KS == 1 ? p.k0 + p.k1 : 9 * p.k0;

  // each thread loads the same tile rows at every K step
  long long am[A_CHUNKS];
  int ay[A_CHUNKS], ax[A_CHUNKS];
  const long long hw = (long long)p.h * p.width;
#pragma unroll
  for (int j = 0; j < A_CHUNKS; ++j) {
    am[j] = m0 + (tid + j * THREADS) / (BK / VEC);
    const int rem = (int)(am[j] % hw);
    ay[j] = rem / p.width;
    ax[j] = rem % p.width;
  }

  constexpr int LDA = Tile<T>::lda, LDB = Tile<T>::ldb;
  const int tx = tid % 16, ty = tid / 16;  // 8 rows x 4 columns each
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int kt = 0; kt < K; kt += BK) {
    load_tiles<T, KS, VEC, A_CHUNKS>(p, K, kt, n0, As, Bs, am, ay, ax);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(Bs + k * LDB + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = As[(ty * 8 + i) * LDA + k];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[(ty * 8 + i) * LDC + tx * 4 + j] = acc[i][j];
  __syncthreads();

  // epilogue: bias + Mish in float32, consecutive threads on consecutive
  // channels of one pixel
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const long long m = m0 + r;
    const int n = n0 + c;
    if (m >= p.m || n >= p.n) continue;
    const float y = mish(Cs[r * LDC + c] + p.bias[n]);
    T* o = p.out + m * p.ldo + n;
    if constexpr (EPI == EPI_NONE) {
      *o = from_f32<T>(y);
    } else if constexpr (EPI == EPI_SUM) {   // csp0: s = dtype(f32(a) + u)
      *o = from_f32<T>(to_f32(p.res[m * p.ldres + n]) + y);
    } else {                                 // csp: h = h + dtype(q)
      *o = from_f32<T>(to_f32(p.res[m * p.ldres + n]) + to_f32(from_f32<T>(y)));
    }
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

template <typename T, int KS, int EPI>
void launch(const ConvArgs<T>& p, bool vec8, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.m + BM - 1) / BM), (unsigned)((p.n + BN - 1) / BN));
  if (vec8) csp_conv_kernel<T, KS, EPI, 8><<<grid, THREADS, 0, stream>>>(p);
  else csp_conv_kernel<T, KS, EPI, 1><<<grid, THREADS, 0, stream>>>(p);
  ++g_conv_launches;
}

template <typename T>
struct Stage {
  const void* const* w;
  const float* const* b;
  long long m;
  int h, width;
  cudaStream_t stream;

  // one fused conv: out[:, :n] = epi(mish(A @ w[wi] + b[wi])); returns the
  // CUDA error of the launch
  int conv(int ks, int epi, const T* a0, long long lda0, int k0, const T* a1,
           long long lda1, int k1, int wi, int n, const T* res,
           long long ldres, T* out, long long ldo) const {
    ConvArgs<T> p{a0, lda0, k0, a1, lda1, k1,
                  static_cast<const T*>(w[wi]), b[wi], n,
                  res, ldres, out, ldo, m, h, width};
    const bool vec8 = k0 % 8 == 0 && k1 % 8 == 0 && lda0 % 8 == 0 &&
                      (k1 == 0 || lda1 % 8 == 0) && n % 8 == 0 &&
                      aligned16(a0) && (k1 == 0 || aligned16(a1)) &&
                      aligned16(p.w);
    if (ks == 1) launch<T, 1, EPI_NONE>(p, vec8, stream);
    else if (epi == EPI_SUM) launch<T, 3, EPI_SUM>(p, vec8, stream);
    else launch<T, 3, EPI_RESID>(p, vec8, stream);
    return (int)cudaGetLastError();
  }
};

#define CSP_TRY(call)          \
  do {                         \
    const int err_ = (call);   \
    if (err_ != 0) return err_; \
  } while (0)

// Buffers (row-major [M, cols], M = B*H*W): csp0 P [M, 2C] = [a | x1],
// t [M, C/2], x2 [M, C]; csp P [M, C] = [h | x1], t (p) [M, C/2], x2 [M, C/2].
template <typename T>
int run_stage(const T* x, T* out, T* P, T* t, T* x2, const void* const* w,
              const float* const* b, int B, int H, int W, int C, int nb,
              cudaStream_t stream) {
  const Stage<T> s{w, b, (long long)B * H * W, H, W, stream};
  const int c2 = C / 2;
  if (nb == 0) {
    T* a = P;           // a, then s over it
    const T* x1 = P + C;
    CSP_TRY(s.conv(1, EPI_NONE, x, C, C, nullptr, 0, 0, 0, 2 * C, nullptr, 0, P, 2 * C));
    CSP_TRY(s.conv(1, EPI_NONE, a, 2 * C, C, nullptr, 0, 0, 1, c2, nullptr, 0, t, c2));
    CSP_TRY(s.conv(3, EPI_SUM, t, c2, c2, nullptr, 0, 0, 2, C, a, 2 * C, a, 2 * C));
    CSP_TRY(s.conv(1, EPI_NONE, a, 2 * C, C, nullptr, 0, 0, 3, C, nullptr, 0, x2, C));
    CSP_TRY(s.conv(1, EPI_NONE, x2, C, C, x1, 2 * C, C, 4, C, nullptr, 0, out, C));
    return 0;
  }
  T* h = P;
  const T* x1 = P + c2;
  CSP_TRY(s.conv(1, EPI_NONE, x, C, C, nullptr, 0, 0, 0, C, nullptr, 0, P, C));
  for (int i = 0; i < nb; ++i) {
    CSP_TRY(s.conv(1, EPI_NONE, h, C, c2, nullptr, 0, 0, 1 + 2 * i, c2, nullptr, 0, t, c2));
    CSP_TRY(s.conv(3, EPI_RESID, t, c2, c2, nullptr, 0, 0, 2 + 2 * i, c2, h, C, h, C));
  }
  CSP_TRY(s.conv(1, EPI_NONE, h, C, c2, nullptr, 0, 0, 1 + 2 * nb, c2, nullptr, 0, x2, c2));
  CSP_TRY(s.conv(1, EPI_NONE, x2, c2, c2, x1, C, c2, 2 + 2 * nb, C, nullptr, 0, out, C));
  return 0;
}


// ---------------------------------------------------------------------------
// bfloat16: the wgmma launch plan
// ---------------------------------------------------------------------------
namespace wg {

constexpr int TILE_M = 128;                 // two consumer warpgroups of 64 rows
constexpr int CONSUMER_THREADS = 256;
constexpr int PRODUCER_THREADS = 128;       // one warpgroup
constexpr int THREADS = CONSUMER_THREADS + PRODUCER_THREADS;
// Registers a thread. 384 threads launch with 168 each (3 warps on each of
// the SM's 4 register files); setmaxnreg then moves them from the producer
// to the consumers within that pool, so a producer warp and two consumer
// warps must fit in 3 x 168 (more would wait for registers forever). 64 keeps
// the producer's gathers free of spills.
constexpr int PRODUCER_REGS = 64, CONSUMER_REGS = 216;
static_assert(PRODUCER_REGS + 2 * CONSUMER_REGS <= 3 * 168, "register pool");
constexpr int STAGES = 4;
constexpr int A_BYTES = TILE_M * 128;       // 64 bf16 of K per row
// full barrier: the producer threads' cp.async arrivals + one expect_tx
constexpr unsigned FULL_ARRIVALS = PRODUCER_THREADS + 1;
constexpr unsigned EMPTY_ARRIVALS = CONSUMER_THREADS / 32;  // one per warp

// launch kinds, in the order of ops/csp.py::launch_plan
enum Kind { CSP0_FIRST, CSP0_LAST, CSP_FIRST, CSP_MID, CSP_LAST };

using namespace ptx;  // smem_u32, mbar_*, bulk_copy (ptx.cuh)

// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar)
               : "memory");
}

// 16 bytes, or zeros where src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// K-major operand of 128-byte rows in the 128-byte swizzle: 8-row groups
// 1024 bytes apart (SBO), the leading offset unused (1), layout 1 = SW128
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

template <int N> struct Wgmma;
template <> struct Wgmma<16> {
  __device__ __forceinline__ static void ss(float (&d)[8], uint64_t a,
                                            uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7}, "
                 "%8, %9, p, 1, 1, 0, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
                 : "l"(a), "l"(b), "r"(1));
  }
  __device__ __forceinline__ static void rs(float (&d)[8], const uint32_t* a,
                                            uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7}, "
                 "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<32> {
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t a,
                                            uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
                 "%16, %17, p, 1, 1, 0, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                 : "l"(a), "l"(b), "r"(1));
  }
  __device__ __forceinline__ static void rs(float (&d)[16], const uint32_t* a,
                                            uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
                 "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<64> {
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                            uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
                 "%32, %33, p, 1, 1, 0, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
                   "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
                 : "l"(a), "l"(b), "r"(1));
  }
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t* a,
                                            uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
                 "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
                   "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<128> {
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,
                                            uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
                 "%64, %65, p, 1, 1, 0, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
                   "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
                   "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
                   "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                   "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
                   "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
                   "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
                 : "l"(a), "l"(b), "r"(1));
  }
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t* a,
                                            uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
                 "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
                   "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
                   "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
                   "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                   "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
                   "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
                   "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<256> {
  __device__ __forceinline__ static void ss(float (&d)[128], uint64_t a,
                                            uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
                 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
                 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
                 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
                 "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
                 "%128, %129, p, 1, 1, 0, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
                   "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
                   "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
                   "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                   "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
                   "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
                   "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
                   "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
                   "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
                   "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
                   "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
                   "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
                   "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
                   "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
                   "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
                   "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
                   "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
                   "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
                   "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
                   "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
                   "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
                   "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
                   "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
                 : "l"(a), "l"(b), "r"(1));
  }
  __device__ __forceinline__ static void rs(float (&d)[128], const uint32_t* a,
                                            uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
                 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
                 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
                 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
                 "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
                 "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
                   "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
                   "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
                   "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                   "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
                   "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
                   "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
                   "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
                   "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
                   "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
                   "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
                   "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
                   "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
                   "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
                   "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
                   "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
                   "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
                   "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
                   "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
                   "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
                   "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
                   "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
                   "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

struct Params {
  const bf16* x;          // [M, c]
  bf16* out;              // [M, c]
  bf16* P;                // csp0 [M, 2 CP] = [a | x1]; csp [M, CP] = [h | x1]
  bf16* t;                // csp0 t [M, C2P]
  const bf16* p_in;       // csp p_{i-1} [M, C2P]
  bf16* p_out;            // csp p_i [M, C2P]
  const bf16* w[3];       // this launch's GEMMs (ops/csp.py::pack_weights)
  const float* b[3];
  long long m;
  int h, width, c;
  int x_vec16;            // x rows in 16-byte pieces (c % 8 == 0)
};

// Ring slots: [A tile 128 x 128 B | B chunk NMAX x 128 B], 1024-aligned.
template <int SLOT>
struct Ring {
  uint32_t base, bars;
  __device__ uint32_t slot(int it) const { return base + (it % STAGES) * SLOT; }
  __device__ uint32_t full(int it) const { return bars + 8 * (it % STAGES); }
  __device__ uint32_t empty(int it) const {
    return bars + 8 * (STAGES + it % STAGES);
  }
  __device__ uint32_t parity(int it) const { return (it / STAGES) & 1; }
};

// the epilogue stages STAGE_COLS columns of a warpgroup's 64 rows in shared
// memory (rows padded by 16 bytes: conflict-free) and stores them 16 bytes
// a thread, whole rows at a time
constexpr int STAGE_COLS = 64;
constexpr int STAGE_BYTES = 64 * (STAGE_COLS * 2 + 16);

template <int KIND, int CP>
struct Shape {
  static constexpr int C2P = CP / 2;
  static constexpr int NMAX = KIND == CSP0_FIRST ? 2 * CP : KIND == CSP_MID ? C2P : CP;
  static constexpr int SLOT = A_BYTES + NMAX * 128;
  static constexpr int STAGING = 16 * STAGES;  // after the ring's barriers
  static constexpr int SMEM = 1024 + STAGES * SLOT + STAGING + 2 * STAGE_BYTES;
  static_assert(NMAX <= 256 && C2P % 16 == 0, "wgmma widths");
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

__host__ __device__ constexpr int chunks(int k) { return (k + 63) / 64; }

// ---- producer: one warpgroup ---------------------------------------------

// Thread t fills the 16-byte group t % 8 of rows t / 8 + 16 i (i < 8) of an A
// tile; group g of row r sits at g ^ (r % 8) (the 128-byte swizzle).
constexpr int ROWS_PER_THREAD = TILE_M * 8 / PRODUCER_THREADS;

struct Producer {
  int grp, row0;
  long long m0;
  __device__ uint32_t a_dst(uint32_t tile, int i) const {
    const int r = row0 + 16 * i;
    return tile + r * 128 + ((grp ^ (r & 7)) << 4);
  }

  // K chunk kc of a 1x1 source: channels [kc*64, kc*64 + 64) of rows
  // src + m*ld, zeros at channels >= valid and rows >= M
  __device__ void load_1x1(uint32_t tile, const bf16* src, long long ld,
                           int valid, int kc, long long M, bool vec16) const {
    const int k = kc * 64 + grp * 8;
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const long long m = m0 + row0 + 16 * i;
      const bf16* s = src + m * ld + k;
      const uint32_t dst = a_dst(tile, i);
      if (vec16) {
        cp_async16(dst, m < M && k < valid ? s : src, m < M && k < valid ? 16 : 0);
      } else {  // an even channel count: 4-byte pieces
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = m < M && k + 2 * e < valid;
          cp_async4(dst + 4 * e, ok ? s + 2 * e : src, ok ? 4 : 0);
        }
      }
    }
  }

  // K chunk kc of a 3x3 over src [M, C2P]: K index = tap * C2P + channel,
  // taps gathered at (y + dy, x + dx), zeros outside the image and past K
  template <int C2P>
  __device__ void load_3x3(uint32_t tile, const bf16* src, int kc,
                           const int (&py)[ROWS_PER_THREAD],
                           const int (&px)[ROWS_PER_THREAD],
                           int h, int width) const {
    const int k = kc * 64 + grp * 8;
    const int tap = k / C2P, c = k - tap * C2P;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const bool in_k = k < 9 * C2P;
    const long long shift = (long long)dy * width + dx;
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const bool ok = in_k && (unsigned)(py[i] + dy) < (unsigned)h &&
                      (unsigned)(px[i] + dx) < (unsigned)width;
      const long long m = m0 + row0 + 16 * i;
      cp_async16(a_dst(tile, i), ok ? src + (m + shift) * C2P + c : src,
                 ok ? 16 : 0);
    }
  }
};

// ---- consumers: two warpgroups -------------------------------------------

template <int SLOT>
__device__ __forceinline__ void release(const Ring<SLOT>& ring, int it) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(ring.empty(it));
}

// issue STEPS k16 steps of d += A (shared) x B on ring item `it`
template <int N, int STEPS, int SLOT>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], const Ring<SLOT>& ring,
                                       int it, uint32_t a_off) {
  mbar_wait(ring.full(it), ring.parity(it));
  // A came through cp.async (the generic proxy), wgmma reads it through the
  // async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  wgmma_fence();
  const uint32_t a = ring.slot(it) + a_off, b = ring.slot(it) + A_BYTES;
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
    Wgmma<N>::ss(d, desc(a + 32 * s), desc(b + 32 * s));
  wgmma_commit();
}

// d += A (shared, this warpgroup's 64 rows at a_off) x B over KSTEPS k16
// steps; each item is released once the wgmma of the next one is issued
template <int N, int KSTEPS, int SLOT>
__device__ __forceinline__ void gemm_ss(float (&d)[N / 2], const Ring<SLOT>& ring,
                                        int& it, uint32_t a_off) {
  constexpr int FULL = KSTEPS / 4, TAIL = KSTEPS % 4;
#pragma unroll 1
  for (int c = 0; c < FULL; ++c) {
    mma_ss<N, 4>(d, ring, it, a_off);
    wgmma_wait<1>();
    if (c > 0) release(ring, it - 1);
    ++it;
  }
  if constexpr (TAIL > 0) {
    mma_ss<N, TAIL>(d, ring, it, a_off);
    wgmma_wait<1>();
    if (FULL > 0) release(ring, it - 1);
    ++it;
  }
  wgmma_wait<0>();
  release(ring, it - 1);
  fence_regs(d);
}

// d += A (registers: KSTEPS fragments of 4 bf16x2) x B
template <int N, int KSTEPS, int SLOT>
__device__ __forceinline__ void gemm_rs(float (&d)[N / 2], const uint32_t* af,
                                        const Ring<SLOT>& ring, int& it) {
  constexpr int CH = (KSTEPS + 3) / 4;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    mbar_wait(ring.full(it), ring.parity(it));
    wgmma_fence();
    const uint32_t b = ring.slot(it) + A_BYTES;
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (4 * c + s < KSTEPS)
        Wgmma<N>::rs(d, af + 4 * (4 * c + s), desc(b + 32 * s));
    wgmma_commit();
    wgmma_wait<1>();
    if (c > 0) release(ring, it - 1);
    ++it;
  }
  wgmma_wait<0>();
  release(ring, it - 1);
  fence_regs(d);
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.0f;
  fence_regs(d);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The accumulator of m64nNk16: this thread holds rows r0 and r0 + 8 (i), and
// columns 8j + 2q, 8j + 2q + 1 of each 8-column block j, at d[4j + 2i + e].
// As bf16x2 pairs pk[2j + i], four consecutive pairs are the A fragment of
// k16 step j / 2: the chained GEMM reads them as they are.
struct Frag {
  long long m_lo;  // row r0; m_lo + 8 the other
  int q;
  long long row0;  // the warpgroup's first row
  int rloc, tid, g;  // r0 - row0, thread and warpgroup index
  unsigned char* stage;  // the warpgroup's staging buffer
};

__device__ __forceinline__ void wg_sync(int g) {
  asm volatile("bar.sync %0, 128;" ::"r"(g + 1) : "memory");
}

// Mish with e^x on the MUFU (__expf) and the reciprocal of a + 2 by three
// Newton steps from a bit-trick estimate (1.5e-7 relative) on the FMA pipe:
// one MUFU operation an element instead of two, which more than halves the
// epilogue. Same formula as mish() above.
__device__ __forceinline__ float mish_wg(float x) {
  const float e = __expf(fminf(x, 20.0f));
  const float a = e * (e + 2.0f), den = a + 2.0f;
  float r = __int_as_float(0x7EF311C3 - __float_as_int(den));
  r = r * (2.0f - den * r);
  r = r * (2.0f - den * r);
  r = r * (2.0f - den * r);
  return x > 20.0f ? x : x * a * r;
}

template <int N>
__device__ __forceinline__ void bias_mish(float (&d)[N / 2], const float* bias,
                                          int q) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * q);
    d[4 * j + 0] = mish_wg(d[4 * j + 0] + bb.x);
    d[4 * j + 1] = mish_wg(d[4 * j + 1] + bb.y);
    d[4 * j + 2] = mish_wg(d[4 * j + 2] + bb.x);
    d[4 * j + 3] = mish_wg(d[4 * j + 3] + bb.y);
  }
}

template <int N>
__device__ __forceinline__ void pack(const float (&d)[N / 2], uint32_t (&pk)[N / 4]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) pk[i] = pack2(d[2 * i], d[2 * i + 1]);
}

// pk's columns [0, N) to dst[m, 0 .. ncols) (rows < M), through the
// warpgroup's staging buffer STAGE_COLS columns at a time: 16-byte stores of
// whole rows (4-byte pieces where ncols or ld is not a multiple of 8)
template <int N>
__device__ __forceinline__ void store(const uint32_t* pk, bf16* dst, long long ld,
                                      int ncols, long long M, const Frag& f) {
  constexpr int NB = N < STAGE_COLS ? N : STAGE_COLS;
  constexpr int SROW = NB * 2 + 16;
  const bool vec = ncols % 8 == 0 && ld % 8 == 0;
#pragma unroll
  for (int cb = 0; cb < N / NB; ++cb) {
#pragma unroll
    for (int jj = 0; jj < NB / 8; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(f.stage + (f.rloc + 8 * i) * SROW +
                                     (8 * jj + 2 * f.q) * 2) =
            pk[2 * (cb * NB / 8 + jj) + i];
    wg_sync(f.g);
#pragma unroll
    for (int k = 0; k < NB / 16; ++k) {
      const int e = f.tid + 128 * k;
      const int r = e / (NB / 8), c8 = e % (NB / 8);
      const long long m = f.row0 + r;
      const int col = cb * NB + c8 * 8;
      if (m < M && col < ncols) {
        const unsigned char* src = f.stage + r * SROW + c8 * 16;
        bf16* o = dst + m * ld + col;
        if (vec) {
          *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int e2 = 0; e2 < 4; ++e2)
            if (col + 2 * e2 < ncols)
              reinterpret_cast<uint32_t*>(o)[e2] =
                  reinterpret_cast<const uint32_t*>(src)[e2];
        }
      }
    }
    wg_sync(f.g);
  }
}

// dst[m, 0 .. N) in the accumulator's layout (zeros at rows >= M)
template <int N>
__device__ __forceinline__ void load_pairs(uint32_t (&pk)[N / 4], const bf16* src,
                                           long long ld, long long M,
                                           const Frag& f) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long m = f.m_lo + 8 * i;
      pk[2 * j + i] = m < M ? *reinterpret_cast<const uint32_t*>(
                                  src + m * ld + 8 * j + 2 * f.q)
                            : 0u;
    }
}

template <int KIND, int CP>
__global__ void __launch_bounds__(THREADS, 1)
    csp_wgmma_kernel(const __grid_constant__ Params p) {
  using S = Shape<KIND, CP>;
  constexpr int C2P = S::C2P;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const staging =
      smem_raw + (base - smem_u32(smem_raw)) + STAGES * S::SLOT + S::STAGING;
  const Ring<S::SLOT> ring{base, base + STAGES * S::SLOT};
  // persistent: block b takes tiles b, b + gridDim.x, ...; the ring runs on
  // across tiles, so the producer loads the next tile during an epilogue
  const int tiles = (int)((p.m + TILE_M - 1) / TILE_M);
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full(s), FULL_ARRIVALS);
      mbar_init(ring.empty(s), EMPTY_ARRIVALS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_THREADS / 32) {
    // ======== producer ========
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    const int pt = threadIdx.x - CONSUMER_THREADS;
    Producer pr{pt & 7, pt >> 3, 0};
    int it = 0;
    // one ring item: wait for the slot, fill its A tile (load_a), bring the
    // B chunk, arrive
    auto item = [&](const bf16* w, int n_rows, int kc, auto&& load_a) {
      mbar_wait(ring.empty(it), ring.parity(it) ^ 1);
      load_a(ring.slot(it));
      if (pt == 0) {
        mbar_expect_tx(ring.full(it), n_rows * 128);
        bulk_copy(ring.slot(it) + A_BYTES, w + (long long)kc * n_rows * 64,
                  n_rows * 128, ring.full(it));
      }
      cp_async_arrive(ring.full(it));
      ++it;
    };
    auto no_a = [](uint32_t) {};
    const bool vec16 = p.x_vec16 != 0;
    auto x_chunk = [&](int kc) {
      return [&, kc](uint32_t tile) {
        pr.load_1x1(tile, p.x, p.c, p.c, kc, p.m, vec16);
      };
    };
    int py[ROWS_PER_THREAD], px[ROWS_PER_THREAD];
    auto tap_chunk = [&](const bf16* src, int kc) {
      return [&, src, kc](uint32_t tile) {
        pr.load_3x3<C2P>(tile, src, kc, py, px, p.h, p.width);
      };
    };

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      pr.m0 = (long long)tile * TILE_M;
      // pixel coordinates of this thread's rows, for the 3x3 gathers
      if constexpr (KIND == CSP0_LAST || KIND == CSP_MID || KIND == CSP_LAST) {
        const long long hw = (long long)p.h * p.width;
#pragma unroll
        for (int i = 0; i < ROWS_PER_THREAD; ++i) {
          const long long m = pr.m0 + pr.row0 + 16 * i;
          const int rem = (int)(m % hw);
          py[i] = m < p.m ? rem / p.width : -(1 << 20);
          px[i] = rem % p.width;
        }
      }

      if constexpr (KIND == CSP0_FIRST) {
        for (int kc = 0; kc < chunks(CP); ++kc) item(p.w[0], 2 * CP, kc, x_chunk(kc));
        for (int kc = 0; kc < chunks(CP); ++kc) item(p.w[1], C2P, kc, no_a);
      } else if constexpr (KIND == CSP_FIRST) {
        for (int kc = 0; kc < chunks(CP); ++kc) item(p.w[0], CP, kc, x_chunk(kc));
        for (int kc = 0; kc < chunks(C2P); ++kc) item(p.w[1], C2P, kc, no_a);
      } else if constexpr (KIND == CSP0_LAST) {
        for (int kc = 0; kc < chunks(9 * C2P); ++kc)
          item(p.w[0], CP, kc, tap_chunk(p.t, kc));
        for (int kc = 0; kc < chunks(CP); ++kc) item(p.w[1], CP, kc, no_a);
        for (int kc = 0; kc < chunks(CP); ++kc) item(p.w[2], CP, kc, no_a);
        for (int kc = 0; kc < chunks(CP); ++kc)   // x1 = P[:, CP:2CP]
          item(p.w[2], CP, chunks(CP) + kc, [&, kc](uint32_t tile) {
            pr.load_1x1(tile, p.P + CP, 2 * CP, CP, kc, p.m, true);
          });
      } else {  // CSP_MID, CSP_LAST
        for (int kc = 0; kc < chunks(9 * C2P); ++kc)
          item(p.w[0], C2P, kc, tap_chunk(p.p_in, kc));
        for (int kc = 0; kc < chunks(C2P); ++kc) item(p.w[1], C2P, kc, no_a);
        if constexpr (KIND == CSP_LAST) {
          for (int kc = 0; kc < chunks(C2P); ++kc) item(p.w[2], CP, kc, no_a);
          for (int kc = 0; kc < chunks(C2P); ++kc)   // x1 = P[:, C2P:CP]
            item(p.w[2], CP, chunks(C2P) + kc, [&, kc](uint32_t tile) {
              pr.load_1x1(tile, p.P + C2P, CP, C2P, kc, p.m, true);
            });
        }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    // ======== consumers ========
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int g = warp / 4, lane = threadIdx.x & 31;
    const uint32_t a_off = g * 64 * 128;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const long long row0 = (long long)tile * TILE_M + g * 64;
      const Frag f{row0 + (warp % 4) * 16 + lane / 4, lane & 3, row0,
                   (warp % 4) * 16 + lane / 4, (int)threadIdx.x % 128, g,
                   staging + g * STAGE_BYTES};

      if constexpr (KIND == CSP0_FIRST) {
        // [a | x1] = cba(x); t = cba(a) chained
        float d0[CP];
        zero(d0);
        gemm_ss<2 * CP, CP / 16>(d0, ring, it, a_off);
        bias_mish<2 * CP>(d0, p.b[0], f.q);
        uint32_t pk0[CP / 2];
        pack<2 * CP>(d0, pk0);
        store<2 * CP>(pk0, p.P, 2 * CP, 2 * CP, p.m, f);
        float d1[C2P / 2];
        zero(d1);
        gemm_rs<C2P, CP / 16>(d1, pk0, ring, it);
        bias_mish<C2P>(d1, p.b[1], f.q);
        uint32_t pk1[C2P / 4];
        pack<C2P>(d1, pk1);
        store<C2P>(pk1, p.t, C2P, C2P, p.m, f);
      } else if constexpr (KIND == CSP_FIRST) {
        // [h | x1] = cba(x); p0 = cba(h) chained
        float d0[CP / 2];
        zero(d0);
        gemm_ss<CP, CP / 16>(d0, ring, it, a_off);
        bias_mish<CP>(d0, p.b[0], f.q);
        uint32_t pk0[CP / 4];
        pack<CP>(d0, pk0);
        store<CP>(pk0, p.P, CP, CP, p.m, f);
        float d1[C2P / 2];
        zero(d1);
        gemm_rs<C2P, C2P / 16>(d1, pk0, ring, it);
        bias_mish<C2P>(d1, p.b[1], f.q);
        uint32_t pk1[C2P / 4];
        pack<C2P>(d1, pk1);
        store<C2P>(pk1, p.p_out, C2P, C2P, p.m, f);
      } else if constexpr (KIND == CSP0_LAST) {
        // s = dtype(f32(a) + cba3(t)); x2 = cba(s); out = cba([x2 | x1])
        uint32_t ra[CP / 4];
        load_pairs<CP>(ra, p.P, 2 * CP, p.m, f);
        float d0[CP / 2];
        zero(d0);
        gemm_ss<CP, 9 * C2P / 16>(d0, ring, it, a_off);
        bias_mish<CP>(d0, p.b[0], f.q);
        uint32_t ps[CP / 4];
#pragma unroll
        for (int i = 0; i < CP / 4; ++i) {
          const float2 a = unpack2(ra[i]);
          ps[i] = pack2(a.x + d0[2 * i], a.y + d0[2 * i + 1]);
        }
        float d1[CP / 2];
        zero(d1);
        gemm_rs<CP, CP / 16>(d1, ps, ring, it);
        bias_mish<CP>(d1, p.b[1], f.q);
        uint32_t px2[CP / 4];
        pack<CP>(d1, px2);
        float d2[CP / 2];
        zero(d2);
        gemm_rs<CP, CP / 16>(d2, px2, ring, it);
        gemm_ss<CP, CP / 16>(d2, ring, it, a_off);
        bias_mish<CP>(d2, p.b[2], f.q);
        uint32_t po[CP / 4];
        pack<CP>(d2, po);
        store<CP>(po, p.out, p.c, p.c, p.m, f);
      } else {
        // h = h + dtype(cba3(p)); then p_i = cba(h), or x2 = cba(h) and
        // out = cba([x2 | x1])
        uint32_t rh[C2P / 4];
        load_pairs<C2P>(rh, p.P, CP, p.m, f);
        float d0[C2P / 2];
        zero(d0);
        gemm_ss<C2P, 9 * C2P / 16>(d0, ring, it, a_off);
        bias_mish<C2P>(d0, p.b[0], f.q);
        uint32_t ph[C2P / 4];
#pragma unroll
        for (int i = 0; i < C2P / 4; ++i) {
          const float2 h = unpack2(rh[i]);
          const float2 q = unpack2(pack2(d0[2 * i], d0[2 * i + 1]));
          ph[i] = pack2(h.x + q.x, h.y + q.y);
        }
        float d1[C2P / 2];
        if constexpr (KIND == CSP_MID) {
          // in place: each pixel's h is read (above) and written only by the
          // thread that owns it, and no tile reads h at another's pixels
          store<C2P>(ph, p.P, CP, C2P, p.m, f);
          zero(d1);
          gemm_rs<C2P, C2P / 16>(d1, ph, ring, it);
          bias_mish<C2P>(d1, p.b[1], f.q);
          uint32_t pk1[C2P / 4];
          pack<C2P>(d1, pk1);
          store<C2P>(pk1, p.p_out, C2P, C2P, p.m, f);
        } else {
          zero(d1);
          gemm_rs<C2P, C2P / 16>(d1, ph, ring, it);
          bias_mish<C2P>(d1, p.b[1], f.q);
          uint32_t px2[C2P / 4];
          pack<C2P>(d1, px2);
          float d2[CP / 2];
          zero(d2);
          gemm_rs<CP, C2P / 16>(d2, px2, ring, it);
          gemm_ss<CP, C2P / 16>(d2, ring, it, a_off);
          bias_mish<CP>(d2, p.b[2], f.q);
          uint32_t po[CP / 4];
          pack<CP>(d2, po);
          store<CP>(po, p.out, p.c, p.c, p.m, f);
        }
      }
    }
  }
}

template <int KIND, int CP>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = Shape<KIND, CP>::SMEM;
  auto kernel = csp_wgmma_kernel<KIND, CP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // one persistent block per SM; threads that race here all store the
  // same count
  static std::atomic<int> g_sms{0};
  int sms = g_sms.load(std::memory_order_relaxed);
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    g_sms.store(sms, std::memory_order_relaxed);
  }
  const long long tiles = (p.m + TILE_M - 1) / TILE_M;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  ++g_conv_launches;
  return (int)cudaGetLastError();
}

// The launch plan of ops/csp.py::launch_plan at widths (CP, CP / 2).
// Buffers (row-major [M, cols]): csp0 P [M, 2 CP] = [a | x1], t [M, C2P];
// csp P [M, CP] = [h | x1], p0 / p1 [M, C2P] (p_i in buffer i % 2).
Params common(const bf16* x, bf16* out, bf16* P, long long m, int H, int W,
              int C) {
  Params p{};
  p.x = x;
  p.out = out;
  p.P = P;
  p.m = m;
  p.h = H;
  p.width = W;
  p.c = C;
  p.x_vec16 = C % 8 == 0 && aligned16(x);
  return p;
}

void use(Params& p, const void* const* w, const float* const* b, int first,
         int n) {
  for (int i = 0; i < 3; ++i) {
    p.w[i] = i < n ? static_cast<const bf16*>(w[first + i]) : nullptr;
    p.b[i] = i < n ? b[first + i] : nullptr;
  }
}

template <int CP>
int run_csp0(Params p, bf16* t, const void* const* w, const float* const* b,
             cudaStream_t stream) {
  p.t = t;
  use(p, w, b, 0, 2);
  CSP_TRY((launch<CSP0_FIRST, CP>(p, stream)));
  use(p, w, b, 2, 3);
  return launch<CSP0_LAST, CP>(p, stream);
}

template <int CP>
int run_csp(Params p, bf16* p0, bf16* p1, const void* const* w,
            const float* const* b, int nb, cudaStream_t stream) {
  bf16* pbuf[2] = {p0, p1};
  p.p_out = pbuf[0];
  use(p, w, b, 0, 2);
  CSP_TRY((launch<CSP_FIRST, CP>(p, stream)));
  for (int i = 1; i < nb; ++i) {
    p.p_in = pbuf[(i - 1) % 2];
    p.p_out = pbuf[i % 2];
    use(p, w, b, 2 * i, 2);
    CSP_TRY((launch<CSP_MID, CP>(p, stream)));
  }
  p.p_in = pbuf[(nb - 1) % 2];
  p.p_out = nullptr;
  use(p, w, b, 2 * nb, 3);
  return launch<CSP_LAST, CP>(p, stream);
}

// widths as ops/csp.py::KERNEL_WIDTHS; -1 past the widest instance
int run_stage(const bf16* x, bf16* out, bf16* P, bf16* s0, bf16* s1,
              const void* const* w, const float* const* b, int B, int H, int W,
              int C, int nb, cudaStream_t stream) {
  const Params p = common(x, out, P, (long long)B * H * W, H, W, C);
  if (nb == 0) {
    if (C <= 32) return run_csp0<32>(p, s0, w, b, stream);
    if (C <= 64) return run_csp0<64>(p, s0, w, b, stream);
    if (C <= 128) return run_csp0<128>(p, s0, w, b, stream);
    return -1;
  }
  if (C <= 32) return run_csp<32>(p, s0, s1, w, b, nb, stream);
  if (C <= 64) return run_csp<64>(p, s0, s1, w, b, nb, stream);
  if (C <= 128) return run_csp<128>(p, s0, s1, w, b, nb, stream);
  if (C <= 256) return run_csp<256>(p, s0, s1, w, b, nb, stream);
  return -1;
}

template <int KIND, int... W>
int smem_of(int cp) {
  int bytes = -1;
  ((cp == W ? (bytes = Shape<KIND, W>::SMEM) : 0), ...);
  return bytes;
}

}  // namespace wg

}  // namespace

// One stage body on NHWC x [B, H, W, C] -> out [B, H, W, C], enqueued on
// `stream`; w / b hold ops/csp.py::pack_weights' list for x's dtype, one
// pair per GEMM of the launch plan. Scratch: bf16 P and the two C/2 buffers
// of the plan (t, or p0 and p1), float32 P, t and x2 (widths in
// ops/csp_cuda.py). Returns 0, the first CUDA error, or -1 for a bf16 width
// past the widest instance.
extern "C" int csp_stage(int is_bf16, const void* x, void* out, void* P,
                         void* t, void* x2, const void* const* w,
                         const float* const* b, int B, int H, int W, int C,
                         int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return wg::run_stage(static_cast<const bf16*>(x), static_cast<bf16*>(out),
                         static_cast<bf16*>(P), static_cast<bf16*>(t),
                         static_cast<bf16*>(x2), w, b, B, H, W, C, nb, s);
  return run_stage<float>(static_cast<const float*>(x), static_cast<float*>(out),
                          static_cast<float*>(P), static_cast<float*>(t),
                          static_cast<float*>(x2), w, b, B, H, W, C, nb, s);
}

// Conv kernel launches enqueued by csp_stage since the library was loaded.
extern "C" long long csp_conv_launches(void) { return g_conv_launches.load(); }

// Dynamic shared memory of the bf16 kernel of launch kind `kind` (the order
// of wg::Kind) at width `cp`, or -1 where no such instance exists.
extern "C" int csp_wgmma_smem(int kind, int cp) {
  using namespace wg;
  switch (kind) {
    case CSP0_FIRST: return smem_of<CSP0_FIRST, 32, 64, 128>(cp);
    case CSP0_LAST: return smem_of<CSP0_LAST, 32, 64, 128>(cp);
    case CSP_FIRST: return smem_of<CSP_FIRST, 32, 64, 128, 256>(cp);
    case CSP_MID: return smem_of<CSP_MID, 32, 64, 128, 256>(cp);
    case CSP_LAST: return smem_of<CSP_LAST, 32, 64, 128, 256>(cp);
    default: return -1;
  }
}
