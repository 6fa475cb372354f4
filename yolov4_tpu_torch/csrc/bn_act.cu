// Eval-mode BatchNorm and Mish / leaky ReLU in one pass on Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses BN and the activation into
// the conv's epilogue by itself, while PyTorch's eager eval forward runs
// them as separate passes after cuDNN's conv (BN's transform, then about
// nine elementwise kernels for Mish: clamp, exp, add, mul, add, mul, div,
// gt, where). Each pass reads and writes the whole activation. This kernel
// does the same arithmetic in one pass, for models/layers.ConvBNAct's eval
// forward without autograd (ops/bn_act_cuda.py, the custom op
// yolov4_tpu_torch::batch_norm_act).
//
// What it computes, element by element, in float32:
//   scale = weight / sqrt(var + eps),  shift = bias - mean * scale
//   v     = x * scale + shift
//   mish:  e = exp(min(v, 20)), a = e (e + 2), out = v > 20 ? v : v a / (a + 2)
//   leaky: out = v > 0 ? v : 0.1 v
// and one rounding of `out` to x's dtype (bfloat16 or float32). Every step
// is the IEEE operation the plain version (ops/bn_act.py) does in the same
// order: build with -fmad=false (no contraction of x * scale + shift into an
// FMA) and never with --use_fast_math (IEEE sqrt and division, accurate
// expf).
//
// What bounds it on this card: 2 bytes read and 2 written an element in
// bfloat16 (4 + 4 in float32), at 3.35 TB/s. The arithmetic (~40 float32
// instructions an element for Mish) does not: with __expf and __fdividef
// the stem's pass at 608/b64 timed the same (73.9 against 73.6 % of its
// bound), and leaky ReLU's reached only 81 %. What the design answers:
//   - bytes: one 16-byte load and one 16-byte store for each 8 bfloat16 or
//     4 float32 values, where the layout lets a vector share its BN terms;
//   - latency: each thread issues kUnroll loads before it computes and
//     stores any (at most 64 registers, so that four blocks of 256 threads
//     stay resident on an SM), on a persistent grid of one wave of
//     resident blocks;
//   - BN's terms: worked out once per thread, in registers, from the BN's
//     own parameters: no extra launch and no folded copy that could go
//     stale.
//   - Channels-last (NHWC in memory; channel = i % C): a vector is VEC
//     neighbouring channels of one pixel. A block is gx x gy threads; thread
//     (tx, ty) owns channel group g = tx (+ k gx while g < C / VEC) and walks
//     pixels ty, ty + gy, ... of the block's share, so its VEC scales and
//     shifts are computed once and held in registers for the whole walk.
//   - Contiguous NCHW (channel = (i / HW) % C): a block takes one chunk of
//     kThreads * kUnroll vectors of one (image, channel) plane; every thread
//     works out that one channel's terms.
// A vector of 16 bytes needs C (channels-last) or H*W (NCHW) divisible by
// VEC and 16-byte-aligned pointers; otherwise the same kernels run with
// VEC = 1.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMish = 0;
constexpr int kLeaky = 1;
constexpr int kThreads = 256;
// vectors a thread loads before it computes and stores any: four 16-byte
// loads in flight a thread (an H100 at 608/b64: the stem's pass 73.6 % of
// its bound with one, 82.9 % with four; stage 4's 62.6 and 71.4 %)
constexpr int kUnroll = 4;
// resident blocks an SM is built for: caps a thread at 64 registers
constexpr int kMinBlocks = 4;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == kMish) {
    const float e = expf(fminf(v, 20.0f));
    const float a = e * (e + 2.0f);
    return v > 20.0f ? v : v * a / (a + 2.0f);
  }
  return v > 0.0f ? v : v * 0.1f;
}

// BN's per-channel terms, as ops/bn_act.bn_terms
__device__ __forceinline__ void bn_terms(const float* __restrict__ weight,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ mean,
                                         const float* __restrict__ var,
                                         float eps, int c, float& scale,
                                         float& shift) {
  scale = weight[c] * (1.0f / sqrtf(var[c] + eps));
  shift = bias[c] - mean[c] * scale;
}

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load_vec(const T* __restrict__ p) {
  return *reinterpret_cast<const Vec<T, VEC>*>(p);
}

template <typename T, int VEC, int ACT>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const Vec<T, VEC>& in,
                                          const float* scale,
                                          const float* shift) {
  Vec<T, VEC> out;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    out.v[j] = from_float<T>(
        activate<ACT>(to_float(in.v[j]) * scale[j] + shift[j]));
  }
  *reinterpret_cast<Vec<T, VEC>*>(p) = out;
}

// Channels-last: `rows` pixels of `groups` vectors (C = groups * VEC).
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
batch_norm_act_nhwc_kernel(
    const T* __restrict__ x, T* __restrict__ y,
    const float* __restrict__ weight, const float* __restrict__ bias,
    const float* __restrict__ mean, const float* __restrict__ var, float eps,
    long long rows, int groups) {
  const long long row_step = (long long)gridDim.x * blockDim.y;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float scale[VEC], shift[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      bn_terms(weight, bias, mean, var, eps, g * VEC + j, scale[j], shift[j]);
    }
    long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
    for (; r + (kUnroll - 1) * row_step < rows; r += kUnroll * row_step) {
      Vec<T, VEC> in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        in[u] = load_vec<T, VEC>(x + ((r + u * row_step) * groups + g) * VEC);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        store_vec<T, VEC, ACT>(y + ((r + u * row_step) * groups + g) * VEC,
                               in[u], scale, shift);
      }
    }
    for (; r < rows; r += row_step) {
      store_vec<T, VEC, ACT>(y + (r * groups + g) * VEC,
                             load_vec<T, VEC>(x + (r * groups + g) * VEC),
                             scale, shift);
    }
  }
}

// Contiguous NCHW: `planes` (image, channel) planes of `inner` vectors
// (H*W = inner * VEC), each cut into chunks of kThreads * kUnroll
// vectors; block b takes chunk b % chunks of plane b / chunks.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
batch_norm_act_nchw_kernel(
    const T* __restrict__ x, T* __restrict__ y,
    const float* __restrict__ weight, const float* __restrict__ bias,
    const float* __restrict__ mean, const float* __restrict__ var, float eps,
    int channels, long long inner, long long chunks) {
  const long long plane = blockIdx.x / chunks;
  const long long first =
      (blockIdx.x % chunks) * (kThreads * kUnroll) + threadIdx.x;
  const T* xp = x + plane * inner * VEC;
  T* yp = y + plane * inner * VEC;
  float s, t;
  bn_terms(weight, bias, mean, var, eps, (int)(plane % channels), s, t);
  float scale[VEC], shift[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    scale[j] = s;
    shift[j] = t;
  }
  if (first + (kUnroll - 1) * kThreads < inner) {
    Vec<T, VEC> in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      in[u] = load_vec<T, VEC>(xp + (first + u * kThreads) * VEC);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      store_vec<T, VEC, ACT>(yp + (first + u * kThreads) * VEC, in[u], scale,
                             shift);
    }
    return;
  }
  for (long long i = first; i < inner; i += kThreads) {
    store_vec<T, VEC, ACT>(yp + i * VEC, load_vec<T, VEC>(xp + i * VEC),
                           scale, shift);
  }
}

int sm_count(int device) {
  static int counts[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (counts[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || n <= 0) {
      n = 132;
    }
    counts[device] = n;
  }
  return counts[device];
}

// Blocks of kThreads that one SM holds at once, for this kernel instance
// (its registers decide): the persistent grid is one wave of them.
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                    0) != cudaSuccess ||
      blocks <= 0) {
    blocks = 1;
  }
  return blocks;
}

template <typename T, int VEC, int ACT>
cudaError_t launch(int device, bool nhwc, const void* x, void* y,
                   const float* w, const float* b, const float* m,
                   const float* v, float eps, long long n, int channels,
                   long long hw, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (nhwc) {
    const int groups = channels / VEC;
    const int gx = groups < kThreads ? groups : kThreads;
    const int gy = kThreads / gx;
    const long long rows = n / channels;
    const long long want = (rows + gy - 1) / gy;
    static const int per_sm =
        resident_blocks(batch_norm_act_nhwc_kernel<T, VEC, ACT>);
    const long long cap = (long long)sm_count(device) * per_sm;
    const int blocks = (int)(want < cap ? want : cap);
    batch_norm_act_nhwc_kernel<T, VEC, ACT><<<blocks, dim3(gx, gy), 0,
                                              stream>>>(
        xt, yt, w, b, m, v, eps, rows, groups);
  } else {
    const long long inner = hw / VEC;
    const long long per_block = (long long)kThreads * kUnroll;
    const long long chunks = (inner + per_block - 1) / per_block;
    const long long blocks = (n / hw) * chunks;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    batch_norm_act_nchw_kernel<T, VEC, ACT><<<(unsigned)blocks, kThreads, 0,
                                              stream>>>(
        xt, yt, w, b, m, v, eps, channels, inner, chunks);
  }
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t dispatch_vec(int device, bool nhwc, const void* x, void* y,
                         const float* w, const float* b, const float* m,
                         const float* v, float eps, long long n, int channels,
                         long long hw, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  const long long span = nhwc ? channels : hw;
  if (aligned && span % kVec == 0) {
    return launch<T, kVec, ACT>(device, nhwc, x, y, w, b, m, v, eps, n,
                                channels, hw, stream);
  }
  return launch<T, 1, ACT>(device, nhwc, x, y, w, b, m, v, eps, n, channels,
                           hw, stream);
}

template <typename T>
cudaError_t dispatch_act(int act, int device, bool nhwc, const void* x,
                         void* y, const float* w, const float* b,
                         const float* m, const float* v, float eps,
                         long long n, int channels, long long hw,
                         cudaStream_t stream) {
  if (act == kMish) {
    return dispatch_vec<T, kMish>(device, nhwc, x, y, w, b, m, v, eps, n,
                                  channels, hw, stream);
  }
  return dispatch_vec<T, kLeaky>(device, nhwc, x, y, w, b, m, v, eps, n,
                                 channels, hw, stream);
}

}  // namespace

// y = act(BN(x)) over n = N*C*H*W elements of x, on `device`'s `stream`.
// is_bf16: 1 bfloat16, 0 float32 (x and y); act: 0 Mish, 1 leaky ReLU 0.1;
// nhwc: 1 channels-last, 0 contiguous NCHW; hw = H*W. weight, bias, mean
// and var: float32 [C]. Returns the launch's CUDA error (0 on success);
// enqueues nothing for n == 0.
extern "C" int bn_act(int is_bf16, int act, int nhwc, const void* x, void* y,
                      const float* weight, const float* bias,
                      const float* mean, const float* var, float eps,
                      long long n, int channels, long long hw, int device,
                      void* stream) {
  if (n == 0) return 0;
  if (channels <= 0 || hw <= 0 || n % ((long long)channels * hw) != 0 ||
      (act != kMish && act != kLeaky)) {
    return cudaErrorInvalidValue;
  }
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? dispatch_act<__nv_bfloat16>(act, device, nhwc != 0, x, y,
                                              weight, bias, mean, var, eps, n,
                                              channels, hw, s)
                : dispatch_act<float>(act, device, nhwc != 0, x, y, weight,
                                      bias, mean, var, eps, n, channels, hw,
                                      s);
  if (current != device) cudaSetDevice(current);
  return err;
}
