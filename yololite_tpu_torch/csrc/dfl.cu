// The DFL expectation (K5) and the DFL cross-entropy (K6a), each with its backward, for Hopper (sm_90a).
//
// Replaces the XLA ops of yololite_tpu/ops/decode.py:75 `dfl_expectation_mm` (its custom vjp: forward :100,
// backward :105) and yololite_tpu/utils/loss.py:238 `dfl_ce_mean` (forward :254, backward :259, body :197
// `_dfl_ce_parts`). Their plain versions are ops/loss_kernels.py `dfl_expectation_plain`,
// `dfl_expectation_backward_plain`, `dfl_ce_plain` and `dfl_ce_backward_plain`.
//
// Inputs: x, (rows, 4R) logits, R = reg_max, fp32, bf16 or fp64 (the float64 reference step), read through a
// row stride (the loss's box logits are the first 64 columns of the (B, A, 144) Detect maps, row stride 144);
// targets (rows, 4) fp32 contiguous; the incoming gradients g, (rows, 4) (K5) or (rows, 1) (K6a) fp32
// contiguous.
//
// What it computes, as the plain versions do, per side of 4:
//   K5 forward   m = max (NaN propagating), e_j = expf(x_j - m), z = sum(e), E = sum(e_j * j) / z, the sums in
//                torch's CUDA order (csrc/dfl_math.cuh, shared with K3's decode), out (rows, 4) fp32;
//   K5 backward  dx_j = ((e_j / z) * (j - E)) * g, rounded once to x's type at the end;
//   K6a forward  t = clamp(target, 0, R - 1 - 0.01), tl = (int)t, tr = tl + 1, wl = tr - t, wr = 1 - wl,
//                lse = logf(z) + m, ce = (lse - x_tl) * wl + (lse - x_tr') * wr with tr' = min(tr, R - 1), the
//                mean of the 4 sides as torch's CUDA mean takes it ((c0 + c2) + (c1 + c3)) * 0.25, out (rows, 1);
//   K6a backward dx_j = ((e_j / z) - y_j) * (g * 0.25), y the two-hot target (wl at tl, then wr added at tr').
// Every step rounds where torch's elementwise ops round (no FMA contraction: __f*_rn), so the fp32 results, and
// the bf16 ones (the math runs in fp32 from the exact upcast, one rounding at the end), equal the plain versions
// bit for bit.
//
// Design: one thread an (anchor row, side), the four sides of a row on four neighbouring lanes, so a warp reads
// 8 rows' 4R logits as 32 runs of R; at R = 16 the run is loaded with 16-byte vector loads when the pointer and
// the row stride allow, and held in registers. The backward recomputes m, z and E with the forward's code
// instead of reading saved (rows, 4) tensors, and writes dx (rows, 4R) contiguous in x's type in 16-byte
// stores. K6a's mean gathers the four sides' terms with warp shuffles.
//
// Bound on an H100 SXM at the train step's shapes (B 16, A 8,400: 134,400 rows, R 16; chip_smoke.py
// loss_tail_bound_ms), each input read once and each output written once: K5 forward 34.4 MB of fp32 logits and
// 2.2 MB out, about 11 us at 3.35 TB/s; its backward the logits, g and dx, 71 MB, about 21 us; K6a the same plus
// the 2.2 MB of targets; bf16 logits halve those bytes. The arithmetic (an expf, a division and some ten more
// flops a logit) stays under the memory time.
//
// C interface, bound with ctypes (pointers and the stream are void*, ints are int, sizes and strides long
// long): launches on the caller's stream of the caller's device, allocates nothing, does not synchronise, and
// returns the first CUDA error, that of the launch included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dfl_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }
template <>
__device__ __forceinline__ float to_float<double>(double v) { return __double2float_rn(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ double from_float<double>(float v) { return (double)v; }

// one side's R logits from p as floats: at RM = 16 with `vec`, 16-byte loads (p 16-byte aligned)
template <typename T, int RM>
__device__ __forceinline__ void load_side(const T* __restrict__ p, float* v, int R, bool vec) {
  constexpr int kCap = RM ? RM : kMaxReg;
  if (RM == 16 && vec) {
    constexpr int kPer = 16 / sizeof(T);  // values a 16-byte load carries
#pragma unroll
    for (int i = 0; i < 16 / kPer; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[i * kPer + j] = to_float<T>(t[j]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kCap; ++j) {
    if (j >= R) break;
    v[j] = to_float<T>(p[j]);
  }
}

// one side's R gradients into p in T: at RM = 16, 16-byte stores (dx is contiguous, each side's run aligned)
template <typename T, int RM>
__device__ __forceinline__ void store_side(T* __restrict__ p, const float* v, int R) {
  constexpr int kCap = RM ? RM : kMaxReg;
  if (RM == 16) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < 16 / kPer; ++i) {
      uint4 u;
      T* t = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) t[j] = from_float<T>(v[i * kPer + j]);
      reinterpret_cast<uint4*>(p)[i] = u;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kCap; ++j) {
    if (j >= R) break;
    p[j] = from_float<T>(v[j]);
  }
}

struct Args {
  const void* x;
  long long rs;    // x's row stride in elements
  long long rows;
  int R;
  int vec;         // x's side runs may be read with 16-byte loads
  const float* target;  // (rows, 4), K6a
  const float* g;       // (rows, 4) K5, (rows, 1) K6a
  void* out;            // (rows, 4) or (rows, 1) fp32 forward; (rows, 4R) in x's type backward
};

// the side's target split as the plain version splits it: the clamped t, its two bins and their weights
struct TwoHot {
  int tl, tr;  // tr already limited to R - 1 (tr' above)
  float wl, wr;
};

__device__ __forceinline__ TwoHot two_hot(float target, int R) {
  const float hi = (float)((double)(R - 1) - 0.01);  // torch rounds the Python float to the tensor's type
  const float t = isnan(target) ? target : fminf(fmaxf(target, 0.0f), hi);
  TwoHot h;
  h.tl = isnan(t) ? -1 : (int)t;  // target.long(): truncation, t >= 0
  const int tr = h.tl + 1;
  h.wl = __fsub_rn((float)tr, t);
  h.wr = __fsub_rn(1.0f, h.wl);
  h.tr = min(tr, R - 1);
  return h;
}

template <typename T, int RM>
__global__ void __launch_bounds__(kThreads) dfl_expectation_fwd(Args a) {
  constexpr int kCap = RM ? RM : kMaxReg;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long r = t >> 2;
  const int side = (int)(t & 3), R = RM ? RM : a.R;
  if (r >= a.rows) return;
  float v[kCap], e[kCap];
  load_side<T, RM>(static_cast<const T*>(a.x) + r * a.rs + side * R, v, R, a.vec);
  const float z = dfl_side_exp_sum<RM>(v, e, R, dfl_side_max<RM>(v, R));
  static_cast<float*>(a.out)[r * 4 + side] = dfl_side_expectation<RM>(e, v, R, z);
}

template <typename T, int RM>
__global__ void __launch_bounds__(kThreads) dfl_expectation_bwd(Args a) {
  constexpr int kCap = RM ? RM : kMaxReg;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long r = t >> 2;
  const int side = (int)(t & 3), R = RM ? RM : a.R;
  if (r >= a.rows) return;
  float v[kCap], e[kCap];
  load_side<T, RM>(static_cast<const T*>(a.x) + r * a.rs + side * R, v, R, a.vec);
  const float z = dfl_side_exp_sum<RM>(v, e, R, dfl_side_max<RM>(v, R));
  const float E = dfl_side_expectation<RM>(e, v, R, z);
  const float g = a.g[r * 4 + side];
#pragma unroll
  for (int j = 0; j < kCap; ++j)
    if (j < R) v[j] = __fmul_rn(__fmul_rn(__fdiv_rn(e[j], z), __fsub_rn((float)j, E)), g);
  store_side<T, RM>(static_cast<T*>(a.out) + (r * 4 + side) * R, v, R);
}

template <typename T, int RM>
__global__ void __launch_bounds__(kThreads) dfl_ce_fwd(Args a) {
  constexpr int kCap = RM ? RM : kMaxReg;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long r = t >> 2;
  const int side = (int)(t & 3), R = RM ? RM : a.R;
  const bool live = r < a.rows;  // every lane reaches the shuffles below
  float term = 0.0f;
  if (live) {
    float v[kCap], e[kCap];
    load_side<T, RM>(static_cast<const T*>(a.x) + r * a.rs + side * R, v, R, a.vec);
    const float m = dfl_side_max<RM>(v, R);
    const float z = dfl_side_exp_sum<RM>(v, e, R, m);
    const TwoHot h = two_hot(a.target[r * 4 + side], R);
    float xl = __int_as_float(0x7fc00000), xr = xl;  // NaN unless the bins are in range
#pragma unroll
    for (int j = 0; j < kCap; ++j) {
      if (j >= R) break;
      if (j == h.tl) xl = v[j];
      if (j == h.tr) xr = v[j];
    }
    const float lse = __fadd_rn(logf(z), m);
    term = __fadd_rn(__fmul_rn(__fsub_rn(lse, xl), h.wl), __fmul_rn(__fsub_rn(lse, xr), h.wr));
  }
  float c[4];
  const int base = (threadIdx.x & 31) & ~3;
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = __shfl_sync(kFull, term, base + i);
  if (live && side == 0) static_cast<float*>(a.out)[r] = __fmul_rn(row_sum(c, 4), 0.25f);
}

template <typename T, int RM>
__global__ void __launch_bounds__(kThreads) dfl_ce_bwd(Args a) {
  constexpr int kCap = RM ? RM : kMaxReg;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long r = t >> 2;
  const int side = (int)(t & 3), R = RM ? RM : a.R;
  if (r >= a.rows) return;
  float v[kCap], e[kCap];
  load_side<T, RM>(static_cast<const T*>(a.x) + r * a.rs + side * R, v, R, a.vec);
  const float z = dfl_side_exp_sum<RM>(v, e, R, dfl_side_max<RM>(v, R));
  const TwoHot h = two_hot(a.target[r * 4 + side], R);
  const float gq = __fmul_rn(a.g[r], 0.25f);
#pragma unroll
  for (int j = 0; j < kCap; ++j) {
    if (j >= R) break;
    float y = 0.0f;
    if (j == h.tl) y = h.wl;
    if (j == h.tr) y = __fadd_rn(y, h.wr);
    v[j] = __fmul_rn(__fsub_rn(__fdiv_rn(e[j], z), y), gq);
  }
  store_side<T, RM>(static_cast<T*>(a.out) + (r * 4 + side) * R, v, R);
}

enum Kind { kExpFwd = 0, kExpBwd = 1, kCeFwd = 2, kCeBwd = 3 };

template <typename T, int RM>
cudaError_t launch_rm(int kind, const Args& a, cudaStream_t st) {
  const long long threads = a.rows * 4;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  switch (kind) {
    case kExpFwd: dfl_expectation_fwd<T, RM><<<blocks, kThreads, 0, st>>>(a); break;
    case kExpBwd: dfl_expectation_bwd<T, RM><<<blocks, kThreads, 0, st>>>(a); break;
    case kCeFwd: dfl_ce_fwd<T, RM><<<blocks, kThreads, 0, st>>>(a); break;
    default: dfl_ce_bwd<T, RM><<<blocks, kThreads, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int kind, Args a, cudaStream_t st) {
  a.vec = a.R == 16 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0 && (a.rs * (long long)sizeof(T)) % 16 == 0;
  return a.R == 16 ? launch_rm<T, 16>(kind, a, st) : launch_rm<T, 0>(kind, a, st);
}

// x_type: 0 fp32, 1 bf16, 2 fp64
int run(int kind, const void* x, long long row_stride, long long rows, int reg_max, int x_type, const void* target,
        const void* g, void* out, int device, void* stream) {
  if (rows < 0 || reg_max < 1 || reg_max > kMaxReg || x_type < 0 || x_type > 2 || row_stride < 4 * reg_max ||
      rows * 4 / kThreads >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaError_t err = cudaSetDevice(device);  // nvcc's own runtime: its current device is not PyTorch's
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{x, row_stride, rows, reg_max, 0, static_cast<const float*>(target), static_cast<const float*>(g), out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_type) {
    case 0: return static_cast<int>(launch_t<float>(kind, a, st));
    case 1: return static_cast<int>(launch_t<__nv_bfloat16>(kind, a, st));
    default: return static_cast<int>(launch_t<double>(kind, a, st));
  }
}

}  // namespace

extern "C" int dfl_expectation_forward(const void* x, long long row_stride, long long rows, int reg_max, int x_type,
                                       void* out, int device, void* stream) {
  return run(kExpFwd, x, row_stride, rows, reg_max, x_type, nullptr, nullptr, out, device, stream);
}

extern "C" int dfl_expectation_backward(const void* x, long long row_stride, long long rows, int reg_max, int x_type,
                                        const void* g, void* dx, int device, void* stream) {
  return run(kExpBwd, x, row_stride, rows, reg_max, x_type, nullptr, g, dx, device, stream);
}

extern "C" int dfl_ce_forward(const void* x, long long row_stride, long long rows, int reg_max, int x_type,
                              const void* target, void* out, int device, void* stream) {
  return run(kCeFwd, x, row_stride, rows, reg_max, x_type, target, nullptr, out, device, stream);
}

extern "C" int dfl_ce_backward(const void* x, long long row_stride, long long rows, int reg_max, int x_type,
                               const void* target, const void* g, void* dx, int device, void* stream) {
  return run(kCeBwd, x, row_stride, rows, reg_max, x_type, target, g, dx, device, stream);
}

extern "C" const char* dfl_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
