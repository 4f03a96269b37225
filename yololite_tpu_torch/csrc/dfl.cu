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
//                torch's CUDA order (`row_sum` of csrc/dfl_math.cuh, K3's; at R 16 the same order across two
//                lanes), out (rows, 4) fp32;
//   K5 backward  dx_j = ((e_j / z) * (j - E)) * g, rounded once to x's type at the end;
//   K6a forward  t = clamp(target, 0, R - 1 - 0.01), tl = (int)t, tr = tl + 1, wl = tr - t, wr = 1 - wl,
//                lse = logf(z) + m, ce = (lse - x_tl) * wl + (lse - x_tr') * wr with tr' = min(tr, R - 1), the
//                mean of the 4 sides as torch's CUDA mean takes it ((c0 + c2) + (c1 + c3)) * 0.25, out (rows, 1);
//   K6a backward dx_j = ((e_j / z) - y_j) * (g * 0.25), y the two-hot target (wl at tl, then wr added at tr').
// Every step rounds where torch's elementwise ops round (no FMA contraction: __f*_rn), so the fp32 results, and
// the bf16 ones (the math runs in fp32 from the exact upcast, one rounding at the end), equal the plain versions
// bit for bit.
//
// Design at R = 16, K5 and K6a alike (`dfl_expectation_fwd16`, `_bwd16`, `dfl_ce_fwd16`, `_bwd16`): a row on 8
// neighbouring lanes, two a side, each lane holding 8 consecutive bins (its half of the side), so a warp reads 4 rows'
// 64 logits as 4 runs of 256 bytes (fp32) or 128 (bf16) in 16-byte loads, every load of a lane started before it
// computes. The side's max is a max over the lane's bins and one shuffle; z keeps torch's order (`row_sum` at 16: a
// tree of offsets 8, 4, 2, 1): one shuffle swaps the two halves, each lane adds bin t and bin t + 8 (the tree's first
// level; an IEEE add is commutative, so both lanes get the same bits) and runs the levels 4, 2, 1 in registers. K5's
// numerator sum(e_j * j) takes the same tree over the lane's products, so E = num / z has the same bits on both lanes
// of a side; its forward gathers the row's four E on the row's first lane (two rounds of shuffles) and writes them in
// one 16-byte store; its backward reads g once a side and stores the lane's 8 bins of dx in 16-byte stores. K6a's
// forward reads the two-hot's logits again (the row is in L1) and takes the row's mean ((c0 + c2) + (c1 + c3)) * 0.25
// in two shuffles; its backward stores like K5's. What a side does once (the two-hot, the log, the term) runs on both
// of its lanes: splitting it, one lane a row over two rows, measured no faster cold on an H100 (PERF.md). A layout
// that 16-byte loads cannot read (`vec` 0, chosen by the wrapper, ops/loss_kernels.py `dfl_plan`) takes the same
// kernels with scalar loads; another R takes the generic kernels: a thread a side, R read at run time, the softmax in
// csrc/dfl_math.cuh's code (K3's), the backward recomputing m, z and E instead of reading saved tensors. The R = 16
// softmax and expectation (`Side16`, `expectation16`) live in csrc/dfl_math.cuh too: K3's decode runs them.
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

// the generic kernels' side of R logits from p as floats, and R gradients into p in T
template <typename T>
__device__ __forceinline__ void load_side(const T* __restrict__ p, float* v, int R) {
#pragma unroll
  for (int j = 0; j < kMaxReg; ++j) {
    if (j >= R) break;
    v[j] = to_float<T>(p[j]);
  }
}

template <typename T>
__device__ __forceinline__ void store_side(T* __restrict__ p, const float* v, int R) {
#pragma unroll
  for (int j = 0; j < kMaxReg; ++j) {
    if (j >= R) break;
    p[j] = from_float<T>(v[j]);
  }
}

struct Args {
  const void* x;
  long long rs;    // x's row stride in elements
  long long rows;
  int R;
  int vec;         // R 16: x's half-side runs are read with 16-byte loads (the wrapper's route)
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

// the generic kernels (R != 16): one thread an (anchor row, side), the four sides of a row on neighbouring lanes
template <typename T>
__global__ void __launch_bounds__(kThreads) dfl_expectation_fwd(Args a) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long r = t >> 2;
  const int side = (int)(t & 3), R = a.R;
  if (r >= a.rows) return;
  float v[kMaxReg], e[kMaxReg];
  load_side<T>(static_cast<const T*>(a.x) + r * a.rs + side * R, v, R);
  const float z = dfl_side_exp_sum<0>(v, e, R, dfl_side_max<0>(v, R));
  static_cast<float*>(a.out)[r * 4 + side] = dfl_side_expectation<0>(e, v, R, z);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dfl_expectation_bwd(Args a) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long r = t >> 2;
  const int side = (int)(t & 3), R = a.R;
  if (r >= a.rows) return;
  float v[kMaxReg], e[kMaxReg];
  load_side<T>(static_cast<const T*>(a.x) + r * a.rs + side * R, v, R);
  const float z = dfl_side_exp_sum<0>(v, e, R, dfl_side_max<0>(v, R));
  const float E = dfl_side_expectation<0>(e, v, R, z);
  const float g = a.g[r * 4 + side];
#pragma unroll
  for (int j = 0; j < kMaxReg; ++j)
    if (j < R) v[j] = __fmul_rn(__fmul_rn(__fdiv_rn(e[j], z), __fsub_rn((float)j, E)), g);
  store_side<T>(static_cast<T*>(a.out) + (r * 4 + side) * R, v, R);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dfl_ce_fwd(Args a) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long r = t >> 2;
  const int side = (int)(t & 3), R = a.R;
  const bool live = r < a.rows;  // every lane reaches the shuffles below
  float term = 0.0f;
  if (live) {
    float v[kMaxReg], e[kMaxReg];
    load_side<T>(static_cast<const T*>(a.x) + r * a.rs + side * R, v, R);
    const float m = dfl_side_max<0>(v, R);
    const float z = dfl_side_exp_sum<0>(v, e, R, m);
    const TwoHot h = two_hot(a.target[r * 4 + side], R);
    float xl = __int_as_float(0x7fc00000), xr = xl;  // NaN unless the bins are in range
#pragma unroll
    for (int j = 0; j < kMaxReg; ++j) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads) dfl_ce_bwd(Args a) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long r = t >> 2;
  const int side = (int)(t & 3), R = a.R;
  if (r >= a.rows) return;
  float v[kMaxReg], e[kMaxReg];
  load_side<T>(static_cast<const T*>(a.x) + r * a.rs + side * R, v, R);
  const float z = dfl_side_exp_sum<0>(v, e, R, dfl_side_max<0>(v, R));
  const TwoHot h = two_hot(a.target[r * 4 + side], R);
  const float gq = __fmul_rn(a.g[r], 0.25f);
#pragma unroll
  for (int j = 0; j < kMaxReg; ++j) {
    if (j >= R) break;
    float y = 0.0f;
    if (j == h.tl) y = h.wl;
    if (j == h.tr) y = __fadd_rn(y, h.wr);
    v[j] = __fmul_rn(__fsub_rn(__fdiv_rn(e[j], z), y), gq);
  }
  store_side<T>(static_cast<T*>(a.out) + (r * 4 + side) * R, v, R);
}

// R = 16: the lane's 8 consecutive bins of its side as floats, from p (32-byte aligned with `vec`: 16-byte
// loads; else one element at a time)
template <typename T>
__device__ __forceinline__ void load_half(const T* __restrict__ p, float (&v)[8], bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);  // values a 16-byte load carries
#pragma unroll
    for (int i = 0; i < 8 / kPer; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[i * kPer + j] = to_float<T>(t[j]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = to_float<T>(p[j]);
}

// the lane's 8 bins of dx into p in T (dx contiguous: each half-side run is 16-byte aligned)
template <typename T>
__device__ __forceinline__ void store_half(T* __restrict__ p, const float (&v)[8]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < 8 / kPer; ++i) {
    uint4 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < kPer; ++j) t[j] = from_float<T>(v[i * kPer + j]);
    reinterpret_cast<uint4*>(p)[i] = u;
  }
}

// R = 16: a warp takes 4 rows, a group of 8 lanes one; lane bit 0 is the half of the side, bits 1-2 the side
struct Lane16 {
  long long r;  // the lane's row
  bool live;
  int lane, side, half;

  __device__ __forceinline__ explicit Lane16(long long rows) {
    const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
    r = t >> 3;
    live = r < rows;
    lane = threadIdx.x & 31;
    side = (lane >> 1) & 3;
    half = lane & 1;
  }
};

// the lane's half-side (0 past the last row), and its side's softmax
template <typename T>
__device__ __forceinline__ Side16 side16(const Args& a, const Lane16& w, float (&v)[8]) {
  if (w.live) {
    load_half<T>(static_cast<const T*>(a.x) + w.r * a.rs + w.side * 16 + w.half * 8, v, a.vec);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.0f;
  }
  Side16 s;
  s.of(v);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dfl_expectation_fwd16(Args a) {
  const Lane16 w(a.rows);  // every lane reaches the shuffles below
  float v[8];
  const float E = expectation16(side16<T>(a, w, v), w.half);
  // the row's four E on its first lane: lane xor 2 holds side ^ 1, lane xor 4 side ^ 2
  const float e1 = __shfl_xor_sync(kFull, E, 2);
  const float e2 = __shfl_xor_sync(kFull, E, 4), e3 = __shfl_xor_sync(kFull, e1, 4);
  if (w.live && (w.lane & 7) == 0) reinterpret_cast<float4*>(a.out)[w.r] = make_float4(E, e1, e2, e3);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dfl_expectation_bwd16(Args a) {
  const Lane16 w(a.rows);
  const float g = w.live ? a.g[w.r * 4 + w.side] : 0.0f;  // loaded beside the logits
  float v[8];
  const Side16 s = side16<T>(a, w, v);
  const float E = expectation16(s, w.half);
  if (!w.live) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = __fmul_rn(__fmul_rn(__fdiv_rn(s.e[j], s.z), __fsub_rn((float)(w.half * 8 + j), E)), g);
  store_half<T>(static_cast<T*>(a.out) + w.r * 64 + w.side * 16 + w.half * 8, v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dfl_ce_fwd16(Args a) {
  const Lane16 w(a.rows);  // every lane reaches the shuffles below
  const float target = w.live ? a.target[w.r * 4 + w.side] : 0.0f;  // loaded beside the logits
  float v[8];
  const Side16 s = side16<T>(a, w, v);
  const TwoHot h = two_hot(target, 16);
  float xl = __int_as_float(0x7fc00000), xr = 0.0f;  // a NaN target (tl -1): NaN
  if (w.live) {  // the two-hot's logits, read again (the row is in L1)
    const T* side_p = static_cast<const T*>(a.x) + w.r * a.rs + w.side * 16;
    if (h.tl >= 0) xl = to_float<T>(__ldg(side_p + h.tl));
    xr = to_float<T>(__ldg(side_p + h.tr));
  }
  const float lse = __fadd_rn(logf(s.z), s.m);
  const float term = __fadd_rn(__fmul_rn(__fsub_rn(lse, xl), h.wl), __fmul_rn(__fsub_rn(lse, xr), h.wr));
  // the row's mean ((c0 + c2) + (c1 + c3)) * 0.25: lane xor 4 pairs side s with s ^ 2, xor 2 with s ^ 1; an IEEE
  // add is commutative, so every lane of the row gets the same bits
  const float u = __fadd_rn(term, __shfl_xor_sync(kFull, term, 4));
  const float mean = __fmul_rn(__fadd_rn(u, __shfl_xor_sync(kFull, u, 2)), 0.25f);
  if (w.live && (w.lane & 7) == 0) static_cast<float*>(a.out)[w.r] = mean;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dfl_ce_bwd16(Args a) {
  const Lane16 w(a.rows);
  const float target = w.live ? a.target[w.r * 4 + w.side] : 0.0f, g = w.live ? a.g[w.r] : 0.0f;
  float v[8];
  const Side16 s = side16<T>(a, w, v);
  if (!w.live) return;
  const TwoHot h = two_hot(target, 16);
  const float gq = __fmul_rn(g, 0.25f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int bin = w.half * 8 + j;
    float y = 0.0f;
    if (bin == h.tl) y = h.wl;
    if (bin == h.tr) y = __fadd_rn(y, h.wr);
    v[j] = __fmul_rn(__fsub_rn(__fdiv_rn(s.e[j], s.z), y), gq);
  }
  store_half<T>(static_cast<T*>(a.out) + w.r * 64 + w.side * 16 + w.half * 8, v);
}

enum Kind { kExpFwd = 0, kExpBwd = 1, kCeFwd = 2, kCeBwd = 3 };

// another R: a thread a side
template <typename T>
cudaError_t launch_generic(int kind, const Args& a, cudaStream_t st) {
  const long long threads = a.rows * 4;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  switch (kind) {
    case kExpFwd: dfl_expectation_fwd<T><<<blocks, kThreads, 0, st>>>(a); break;
    case kExpBwd: dfl_expectation_bwd<T><<<blocks, kThreads, 0, st>>>(a); break;
    case kCeFwd: dfl_ce_fwd<T><<<blocks, kThreads, 0, st>>>(a); break;
    default: dfl_ce_bwd<T><<<blocks, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

// R = 16: 8 lanes a row
template <typename T>
cudaError_t launch_lanes(int kind, const Args& a, cudaStream_t st) {
  const long long threads = a.rows * 8;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  switch (kind) {
    case kExpFwd: dfl_expectation_fwd16<T><<<blocks, kThreads, 0, st>>>(a); break;
    case kExpBwd: dfl_expectation_bwd16<T><<<blocks, kThreads, 0, st>>>(a); break;
    case kCeFwd: dfl_ce_fwd16<T><<<blocks, kThreads, 0, st>>>(a); break;
    default: dfl_ce_bwd16<T><<<blocks, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

// the wrapper's route: R 16 takes the lanes kernels, with 16-byte loads where vec is 1 (refused unless x and its row
// stride are 16-byte aligned); K5's forward stores a row's 4 E in one 16-byte store and the backwards store dx in
// 16-byte pieces, so out must be 16-byte aligned there
template <typename T>
cudaError_t launch_t(int kind, Args a, cudaStream_t st) {
  if (a.R != 16) return a.vec ? cudaErrorInvalidValue : launch_generic<T>(kind, a, st);
  if (a.vec && (reinterpret_cast<uintptr_t>(a.x) % 16 != 0 || (a.rs * (long long)sizeof(T)) % 16 != 0))
    return cudaErrorMisalignedAddress;
  if (kind != kCeFwd && reinterpret_cast<uintptr_t>(a.out) % 16 != 0) return cudaErrorMisalignedAddress;
  return launch_lanes<T>(kind, a, st);
}

// x_type: 0 fp32, 1 bf16, 2 fp64
int run(int kind, const void* x, long long row_stride, long long rows, int reg_max, int x_type, int vec,
        const void* target, const void* g, void* out, int device, void* stream) {
  if (rows < 0 || reg_max < 1 || reg_max > kMaxReg || x_type < 0 || x_type > 2 || row_stride < 4 * reg_max ||
      rows * 8 / kThreads >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaError_t err = cudaSetDevice(device);  // nvcc's own runtime: its current device is not PyTorch's
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{x, row_stride, rows, reg_max, vec, static_cast<const float*>(target), static_cast<const float*>(g),
               out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_type) {
    case 0: return static_cast<int>(launch_t<float>(kind, a, st));
    case 1: return static_cast<int>(launch_t<__nv_bfloat16>(kind, a, st));
    default: return static_cast<int>(launch_t<double>(kind, a, st));
  }
}

}  // namespace

// every entry takes the wrapper's route (ops/loss_kernels.py dfl_plan): vec 1 for 16-byte loads at R = 16 (x 16-byte
// aligned, its row stride too), 0 for scalar loads and for another R
extern "C" int dfl_expectation_forward(const void* x, long long row_stride, long long rows, int reg_max, int x_type,
                                       int vec, void* out, int device, void* stream) {
  return run(kExpFwd, x, row_stride, rows, reg_max, x_type, vec, nullptr, nullptr, out, device, stream);
}

extern "C" int dfl_expectation_backward(const void* x, long long row_stride, long long rows, int reg_max, int x_type,
                                        int vec, const void* g, void* dx, int device, void* stream) {
  return run(kExpBwd, x, row_stride, rows, reg_max, x_type, vec, nullptr, g, dx, device, stream);
}

extern "C" int dfl_ce_forward(const void* x, long long row_stride, long long rows, int reg_max, int x_type, int vec,
                              const void* target, void* out, int device, void* stream) {
  return run(kCeFwd, x, row_stride, rows, reg_max, x_type, vec, target, nullptr, out, device, stream);
}

extern "C" int dfl_ce_backward(const void* x, long long row_stride, long long rows, int reg_max, int x_type, int vec,
                               const void* target, const void* g, void* dx, int device, void* stream) {
  return run(kCeBwd, x, row_stride, rows, reg_max, x_type, vec, target, g, dx, device, stream);
}

extern "C" const char* dfl_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
