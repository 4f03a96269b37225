// The sum of binary cross-entropy with logits (K6b) and its backward, for Hopper (sm_90a).
//
// Replaces the XLA ops of yololite_tpu/utils/loss.py:284 `bce_sum` (its custom vjp: forward :297, backward
// :301). Its plain versions are ops/loss_kernels.py `bce_sum_plain` and `bce_sum_backward_plain`.
//
// Inputs: logits x (rows, C), fp32, bf16 or fp64 (the float64 reference step), read through a row stride (the
// loss's class logits are the last 80 columns of the (B, A, 144) Detect maps, row stride 144); labels y (rows, C),
// fp32 or bf16 (the amp path's target scores), through their own row stride; for the backward the incoming
// gradient g, one fp32 on the card.
//
// What it computes, as the plain versions do:
//   forward   sum over every element of max(x, 0) - x * y + log1p(exp(-|x|)), each term in fp32 from x and y
//             rounded to fp32, with torch's rounding at every step (no FMA contraction); a fp32 scalar;
//   backward  (sigmoid(x) - y) * g in x's type: sigmoid as torch computes it (1 / (1 + expf(-x)) in fp32, or
//             fp64), each step rounded to x's type as torch's elementwise ops round (sigmoid, then y converted,
//             the difference, g converted, the product), written (rows, C) contiguous.
// The terms equal the plain version's bit for bit; the sum adds them in another order than torch's, so it
// agrees within a relative bound (chip_smoke.py, tests/test_torch_kernels.py), and is the same bits on every
// run: no float atomics.
//
// Design: a warp per row, its lanes across the C columns (coalesced 128-byte reads at fp32); a fixed grid of
// kBlocks blocks walks the rows in a grid stride, each thread adding its terms in fp32 in a fixed order, the
// block folding its threads' sums in a fixed tree into one partial; a second launch of one block adds the
// kBlocks partials in a fixed tree. The grid depends on nothing but the constant kBlocks, so the sum has the same
// bits on every run and every card, and a CUDA graph captures both launches. The backward is one elementwise
// pass on the same walk.
//
// Bound on an H100 SXM at the train step's shapes (B 16, A 8,400, C 80: 10.75 M terms; chip_smoke.py
// loss_tail_bound_ms): the forward reads the logits and the labels once, 86 MB in fp32, about 26 us at 3.35 TB/s;
// the backward also writes dx, 129 MB, about 39 us; bf16 halves them.
//
// C interface, bound with ctypes: launches on the caller's stream of the caller's device, allocates nothing (the
// partials are the caller's), does not synchronise, and returns the first CUDA error, that of the launches
// included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 1024;  // the fixed grid of the forward's first launch, and its count of partials
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }
template <>
__device__ __forceinline__ float to_float<double>(double v) { return __double2float_rn(v); }

// a label (type 0 fp32, 1 bf16) as a float, exact; the backward of fp64 logits widens it (labels.to(fp64))
__device__ __forceinline__ float load_label(const void* p, int type, long long i) {
  return type == 0 ? static_cast<const float*>(p)[i] : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// one term of the forward from the fp32 logit and label: max(x, 0) - x * y + log1p(exp(-|x|)), torch's steps
__device__ __forceinline__ float bce_term(float x, float y) {
  const float relu = isnan(x) ? x : fmaxf(x, 0.0f);
  return __fadd_rn(__fsub_rn(relu, __fmul_rn(x, y)), log1pf(expf(-fabsf(x))));
}

// the backward's element in x's type T: sigmoid(x) rounded to T, y converted to T, their difference rounded to
// T, times g converted to T, rounded to T
template <typename T>
struct Grad;
template <>
struct Grad<float> {
  static __device__ __forceinline__ float of(float x, float y, float g) {
    const float s = __frcp_rn(__fadd_rn(1.0f, expf(-x)));
    return __fmul_rn(__fsub_rn(s, y), g);
  }
};
template <>
struct Grad<double> {
  static __device__ __forceinline__ double of(double x, float y, float g) {
    const double s = __drcp_rn(__dadd_rn(1.0, exp(-x)));
    return __dmul_rn(__dsub_rn(s, (double)y), (double)g);
  }
};
template <>
struct Grad<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 of(__nv_bfloat16 x, float y, float g) {
    const float s = __bfloat162float(__float2bfloat16_rn(__frcp_rn(__fadd_rn(1.0f, expf(-__bfloat162float(x))))));
    const float yt = __bfloat162float(__float2bfloat16_rn(y));
    const float d = __bfloat162float(__float2bfloat16_rn(__fsub_rn(s, yt)));
    return __float2bfloat16_rn(__fmul_rn(d, __bfloat162float(__float2bfloat16_rn(g))));
  }
};

struct Args {
  const void* x;
  long long xrs;
  const void* y;
  long long yrs;
  int y_type;
  long long rows;
  int cols;
  const float* g;
  void* out;  // the forward's kBlocks partials; the backward's dx (rows, cols) in x's type
};

template <typename T>
__global__ void __launch_bounds__(kThreads) bce_partial(Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  float acc = 0.0f;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < a.rows; r += (long long)gridDim.x * kWarps) {
#pragma unroll 4
    for (int c = lane; c < a.cols; c += 32)
      acc = __fadd_rn(acc, bce_term(to_float<T>(x[r * a.xrs + c]), load_label(a.y, a.y_type, r * a.yrs + c)));
  }
  // the block's sum in a fixed tree: a shuffle-down tree in each warp, then the warps' sums in order
  __shared__ float warp_sum[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, o));
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = warp_sum[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, warp_sum[w]);
    static_cast<float*>(a.out)[blockIdx.x] = s;
  }
}

// the kBlocks partials into out[0]: thread t adds t, t + kThreads, ... in order, then the same fixed tree
__global__ void __launch_bounds__(kThreads) bce_final(const float* __restrict__ partials, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < kBlocks; i += kThreads) acc = __fadd_rn(acc, partials[i]);
  __shared__ float warp_sum[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, o));
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = warp_sum[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, warp_sum[w]);
    out[0] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bce_backward_kernel(Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  T* __restrict__ dx = static_cast<T*>(a.out);
  const float g = a.g[0];
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < a.rows; r += (long long)gridDim.x * kWarps) {
#pragma unroll 4
    for (int c = lane; c < a.cols; c += 32)
      dx[r * a.cols + c] =
          Grad<T>::of(x[r * a.xrs + c], load_label(a.y, a.y_type, r * a.yrs + c), g);
  }
}

template <typename T>
cudaError_t launch(int backward, const Args& a, float* out, cudaStream_t st) {
  if (backward) {
    bce_backward_kernel<T><<<kBlocks, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  bce_partial<T><<<kBlocks, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bce_final<<<1, kThreads, 0, st>>>(static_cast<const float*>(a.out), out);
  return cudaGetLastError();
}

int run(int backward, const void* x, long long x_rs, int x_type, const void* y, long long y_rs, int y_type,
        long long rows, int cols, const void* g, void* partials_or_dx, void* out, int device, void* stream) {
  if (rows < 0 || cols < 0 || x_type < 0 || x_type > 2 || y_type < 0 || y_type > 1 || x_rs < cols || y_rs < cols)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);  // nvcc's own runtime: its current device is not PyTorch's
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{x, x_rs, y, y_rs, y_type, rows, cols, static_cast<const float*>(g), partials_or_dx};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (x_type) {
    case 0: return static_cast<int>(launch<float>(backward, a, o, st));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(backward, a, o, st));
    default: return static_cast<int>(launch<double>(backward, a, o, st));
  }
}

}  // namespace

// the partials the forward needs: the caller allocates them (fp32)
extern "C" int bce_sum_partials() { return kBlocks; }

extern "C" int bce_sum_forward(const void* x, long long x_rs, int x_type, const void* y, long long y_rs, int y_type,
                               long long rows, int cols, void* partials, void* out, int device, void* stream) {
  return run(0, x, x_rs, x_type, y, y_rs, y_type, rows, cols, nullptr, partials, out, device, stream);
}

extern "C" int bce_sum_backward(const void* x, long long x_rs, int x_type, const void* y, long long y_rs, int y_type,
                                long long rows, int cols, const void* g, void* dx, int device, void* stream) {
  return run(1, x, x_rs, x_type, y, y_rs, y_type, rows, cols, g, dx, nullptr, device, stream);
}

extern "C" const char* bce_sum_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
