// Eval-time CSP stage body on Hopper (sm_90a): every conv + folded-BN bias +
// algebraic Mish of a CSPDarknet53 stage after its base conv.
//
// Replaces the TPU kernel fused_csp_stage (yolov4_tpu/ops/csp_pallas.py:344,
// bodies _csp0_kernel :236 and _csp_kernel :281). Same function and the same
// rounding points as ops/csp.py::fused_csp_stage_plain, which is the
// reference this kernel is held against.
//
// Why not the TPU design. The TPU kernel keeps a halo'd window of rows of
// every intermediate in ~11 MB of VMEM and walks it in order. A Hopper block
// has 227 KB of shared memory, and stage 3 at 608/b16 needs >= 640 KB for one
// such window of one buffer. So this first design is simple and right:
//
//   * One C entry per stage call (csp_stage) launches on the caller's stream
//     a short sequence of fused conv kernels, 5 for csp0 and 2*nb + 3 for csp.
//   * Each launch is an implicit GEMM, M = B*H*W pixels, N = co, K = ci (1x1)
//     or 9*ci (3x3, the taps gathered from NHWC with zero padding at image
//     borders), with bias + Mish in the epilogue, in float32.
//   * Epilogue variants: plain store; csp0's s = dtype(f32(a) + u); csp's
//     residual h = h + dtype(q) (the last two written in place over a / h).
//   * The 1x1 convs that both read x share one launch (N = 2C or C); the
//     transition reads x2 and x1 as two K ranges, with no concat buffer.
//   * bfloat16 runs on the tensor cores (nvcuda::wmma 16x16x16, float32
//     accumulators); float32 runs a scalar-FMA tile, so that it can be held
//     tightly against the plain version.
//   * Tiles are 128 x 64 x 32 with 256 threads, single-buffered, loaded with
//     16-byte vectors where every channel count and offset is a multiple of
//     8 and element by element otherwise; ragged tiles are masked.
//   * Intermediates are scratch buffers the caller allocates (at 608/b16
//     stage 3's largest is 47 MB, inside the 50 MB L2).
//
// What bounds it on this card: operations. At 608/b16 the three stage bodies
// are 121.1, 87.8 and 269.5 GFLOP of bf16 products against 378, 189 and
// 189 MB of x + out: ~0.12, 0.09 and 0.27 ms at 989 TFLOP/s, far above the
// bytes' ~0.11, 0.06, 0.06 ms at 3.35 TB/s. This design does not reach that:
// no wgmma, no TMA, no pipelining, and every intermediate goes through L2 or
// device memory. Those are later work; chip_smoke.py records the time.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 64, BK = 32, THREADS = 256;
constexpr int LDC = BN + 4;  // float32 epilogue tile stride
constexpr int EPI_NONE = 0, EPI_SUM = 1, EPI_RESID = 2;

// Shared-memory row strides (elements): 16-byte aligned rows, and for bf16 the
// multiples of 8 that wmma::load_matrix_sync needs.
template <typename T> struct Tile {
  static constexpr int lda = sizeof(T) == 2 ? BK + 8 : BK + 4;
  static constexpr int ldb = sizeof(T) == 2 ? BN + 8 : BN;
  static constexpr int bytes_ab = (BM * lda + BK * ldb) * (int)sizeof(T);
};
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kSmemBytes =
    cmax(cmax(Tile<float>::bytes_ab, Tile<bf16>::bytes_ab), BM * LDC * 4);
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
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

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
  } else if constexpr (sizeof(T) == 2) {  // 8 bf16 = 16 bytes
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {                                // 8 float = 2 x 16 bytes
    reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
    reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void zero_chunk(T* dst) {
  if constexpr (VEC == 1) {
    *dst = from_f32<T>(0.0f);
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
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

  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    constexpr int LDA = Tile<T>::lda, LDB = Tile<T>::ldb;
    const int warp = tid / 32, wm = warp % 4, wn = warp / 4;  // 4 x 2 warps
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int kt = 0; kt < K; kt += BK) {
      load_tiles<T, KS, VEC, A_CHUNKS>(p, K, kt, n0, As, Bs, am, ay, ax);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
  } else {
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
  }
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

}  // namespace

// One stage body on NHWC x [B, H, W, C] -> out [B, H, W, C], enqueued on
// `stream`; w / b hold the packed weights of ops/csp.py::pack_weights in
// launch order (5 pairs for csp0, 2*nb + 3 for csp). Returns 0 or the first
// CUDA launch error.
extern "C" int csp_stage(int is_bf16, const void* x, void* out, void* P,
                         void* t, void* x2, const void* const* w,
                         const float* const* b, int B, int H, int W, int C,
                         int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return run_stage<bf16>(static_cast<const bf16*>(x), static_cast<bf16*>(out),
                           static_cast<bf16*>(P), static_cast<bf16*>(t),
                           static_cast<bf16*>(x2), w, b, B, H, W, C, nb, s);
  return run_stage<float>(static_cast<const float*>(x), static_cast<float*>(out),
                          static_cast<float*>(P), static_cast<float*>(t),
                          static_cast<float*>(x2), w, b, B, H, W, C, nb, s);
}
