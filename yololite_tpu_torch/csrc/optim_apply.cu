// The train step's apply (K10): the gradient clip, the optimizer's update rule, the zeroing of the gradients and
// the EMA of the weights and BN statistics, for Hopper (sm_90a).
//
// It replaces no Pallas kernel. It is the port of the JAX package's jitted `apply_step`
// (yololite_tpu/engine/trainer.py:342-350) and of `fused_step`'s tail (:374-378): `clip_by_global_norm` and the 7
// update rules of yololite_tpu/engine/optim.py:67-281, then `ema_update` (yololite_tpu/utils/ema.py:18-26), one XLA
// program there. It was added because torch.optim reads the momentum (SGD's, the Adam family's beta1) as a Python
// float: a CUDA graph of torch.optim's step cannot follow the warmup ramp's momentum, so every warmup apply ran
// eagerly. Here lr, the momentum, the step and the EMA decay are device scalars, written before the launch or
// advanced on the device, and one graph serves the whole run. Its plain version is ops/optim_kernels.py
// `optim_apply_plain`.
//
// Inputs: a table of rows (ops/optim_kernels.py `ApplyTable`, built once on the host and uploaded), one a tensor,
// 64 bytes each: pointers p, g, mu, nu, ema, the count n, the group (0 biases, 1 weights: the decay group, 2 BN
// weights), the kind and a vector flag. Kind 0 is a trainable parameter: p, its gradient g, the moments mu and nu,
// and its EMA. Kind 1 is a floating state_dict entry that only the EMA follows (a BN running statistic, a frozen
// parameter): p the model's tensor, read, ema its EMA. The floating tensors of a table are all fp32 (training) or
// all fp64 (the float64 reference step of the checks, where each step rounds in fp64 and the vector route is off). Kind 2 is an integer entry (a BN batch
// counter): n bytes copied from p to ema. A list of items (row, chunk) cuts the rows into chunks of kChunk elements,
// kind 0's items first. hyper = (lr of groups 0, 1, 2, momentum); s = the step's scalars, computed once on the
// device by torch ops (ops/optim_kernels.py `step_scalars`) and read by this kernel and the plain version
// alike: (b1t, b2t, NAdam's c1 and c2, RAdam's rect, use_rect and sqrt(b2t), 1 - momentum); d and 1 - d, the EMA's
// decay (utils/ema.py `ModelEMA.advance`).
//
// What it computes, as the JAX package does, in fp32 (or fp64) with each step rounded (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn: nvcc contracts no FMA that the plain version does not have):
//   1. total = the l2 norm of every kind-0 gradient; scale = min(1, 10 / (total + 1e-6)). The squares are summed in
//      fp64 (exact products) in a fixed partition and fixed trees, and the root rounded to fp32 once, so the norm
//      has the same bits on every run and every card and lies within an ulp or so of the exact norm;
//   2. per element of a kind-0 row: g = g * scale, the rule's update of p, mu and nu in the JAX package's order of
//      operations, g zeroed (JAX's fresh zero gradient sum), then ema = ema * d + (1 - d) * p on the new p;
//      kind 1: ema = ema * d + (1 - d) * p; kind 2: the copy.
// Given the same scale, p, mu, nu, ema and g equal the plain version's bit for bit (chip_smoke.py, the card tests).
//
// Design: three launches an apply, with grids that depend on the table alone, so a CUDA graph captures them. (a)
// `norm_partial`, a block per kind-0 item, thread t its float4s t, t + 256, .. of the chunk (or elements, on a row
// that is not 16-byte aligned), a warp-shuffle tree then the 8 warps' sums in order: one fp64 partial an item; (b)
// `norm_finish`, one block, adds the partials in a fixed tree and writes (total, scale); (c) `apply_kernel`, a
// block per item, templated on the rule: 16-byte loads and stores of p, g, mu, nu and ema where the row's pointers
// allow (the vector flag, set by the host), an element a thread for the row's last n % 4 elements.
//
// What bounds it, on an H100 SXM for yolo11n (255 trainable tensors, 2,624,064 values; 417 floating state_dict
// entries, 2,639,728 values; chip_smoke.py k10_bound_ms): bytes. The function reads p, g, mu, nu and ema once and
// writes p, mu, nu, ema and the zeroed g once (AdamW): about 105.2 MB, 0.0314 ms at 3.35 TB/s; SGD touches no nu:
// about 84.2 MB, 0.0251 ms. This design reads g a second time, in (a) before (c); that read (10.5 MB, which the
// 50 MB L2 may partly serve) is one reason the kernel sits above its bound. The arithmetic, some 20 operations an
// element, is far under the card's rate.
//
// C interface, bound with ctypes (dtype 0 fp32, 1 fp64): launches on the caller's stream of the caller's device, allocates nothing (the
// partials and the (total, scale) pair are the caller's), does not synchronise, and returns the first CUDA error,
// that of the launches included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQuads = 4;                                // float4s a thread takes in a chunk
constexpr int kChunk = kThreads * kQuads * 4;            // elements an item: 4,096 (must equal OPTIM_CHUNK)
constexpr int kPerThread = kChunk / kThreads;            // elements a thread takes on the scalar route
constexpr int kFinishThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

enum Rule { kSGD = 0, kAdam = 1, kAdamax = 2, kAdamW = 3, kNAdam = 4, kRAdam = 5, kRMSProp = 6 };

// the JAX package's constants, as the float32 values its weakly typed Python floats become
constexpr float kBeta2 = 0.999f;
constexpr float kOneMinusBeta2 = (float)(1.0 - 0.999);  // Python's 1 - 0.999, then rounded: not 1.0f - 0.999f
constexpr float kAlpha = 0.99f;                          // RMSProp
constexpr float kOneMinusAlpha = (float)(1.0 - 0.99);
constexpr float kEps = 1e-8f;
constexpr float kMaxNorm = 10.0f;
constexpr float kNormEps = 1e-6f;

struct Row {
  void* p;
  void* g;
  void* mu;
  void* nu;
  void* ema;
  long long n;
  int group;
  int kind;
  int vec;
  int pad;
};
static_assert(sizeof(Row) == 64, "a row is 8 words (ops/optim_kernels.py ApplyTable)");

struct Args {
  const Row* rows;
  const int2* items;  // (row, chunk)
  const float* hyper;
  const float* s;
  const float* d;
  const float* omd;
  float wd;
  double* partials;
  float* clip;  // (total, scale)
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
// jnp.maximum: NaN if either is NaN
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) { return (isnan(a) || isnan(b)) ? a + b : (a > b ? a : b); }

// the per-step scalars in the tensors' type T: fp32 values, exact in fp64 (the float64 reference step)
template <typename T>
struct Scalars {
  T lr, b1, wd, scale, d, omd;
  T b1t, b2t, c1, c2, rect, use_rect, sqb2t, omb1;
  T decay_mul, lr_b1t;  // AdamW's 1 - lr * wd and Adamax's lr / b1t, scalar products the JAX step takes in fp32
  bool decay;
};

// one element's update in the JAX package's order of operations (yololite_tpu/engine/optim.py); g is the raw
// gradient, clipped here; T is fp32, or fp64 for the float64 reference step (the constants are the fp32 values)
template <int R, typename T>
__device__ __forceinline__ void update(T& p, T graw, T& m, T& v, const Scalars<T>& c) {
  const T beta2 = kBeta2, omb2 = kOneMinusBeta2, alpha = kAlpha, oma = kOneMinusAlpha, eps = kEps;
  T g = mul(graw, c.scale);
  if constexpr (R == kSGD) {  // g += wd * p (decay group); buf = mu * buf + g; p -= lr * (g + mu * buf)
    if (c.decay) g = add(g, mul(c.wd, p));
    m = add(mul(c.b1, m), g);
    p = sub(p, mul(c.lr, add(g, mul(c.b1, m))));
  } else if constexpr (R == kAdamW) {  // decoupled decay, then bias-corrected moments
    if (c.decay) p = mul(p, c.decay_mul);
    m = add(mul(c.b1, m), mul(c.omb1, g));
    v = add(mul(beta2, v), mul(mul(omb2, g), g));
    const T mhat = dvd(m, c.b1t), vhat = dvd(v, c.b2t);
    p = sub(p, dvd(mul(c.lr, mhat), add(root(vhat), eps)));
  } else if constexpr (R == kRMSProp) {
    if (c.decay) g = add(g, mul(c.wd, p));
    v = add(mul(alpha, v), mul(mul(oma, g), g));
    m = add(mul(c.b1, m), dvd(g, add(root(v), eps)));
    p = sub(p, mul(c.lr, m));
  } else if constexpr (R == kAdamax) {
    if (c.decay) g = add(g, mul(c.wd, p));
    m = add(mul(c.b1, m), mul(c.omb1, g));
    v = max_nan(mul(beta2, v), add(fabs(g), eps));
    p = sub(p, dvd(mul(c.lr_b1t, m), v));
  } else {  // Adam, NAdam, RAdam: L2 decay folded into the gradient, then the moments
    if (c.decay) g = add(g, mul(c.wd, p));
    m = add(mul(c.b1, m), mul(c.omb1, g));
    v = add(mul(beta2, v), mul(mul(omb2, g), g));
    if constexpr (R == kAdam) {
      p = sub(p, dvd(mul(c.lr, dvd(m, c.b1t)), add(root(dvd(v, c.b2t)), eps)));
    } else if constexpr (R == kNAdam) {
      const T denom = add(root(dvd(v, c.b2t)), eps);
      const T num = add(mul(c.c1, g), mul(c.c2, m));
      p = sub(p, dvd(mul(c.lr, num), denom));
    } else {  // RAdam: the rectified step where use_rect, else the SGD-momentum one
      const T mhat = dvd(m, c.b1t);
      const T adaptive = dvd(mul(mul(c.rect, mhat), c.sqb2t), add(root(v), eps));
      p = sub(p, mul(c.lr, c.use_rect != T(0) ? adaptive : mhat));
    }
  }
}

template <typename T>
__device__ __forceinline__ T ema_of(T e, T x, const Scalars<T>& c) { return add(mul(e, c.d), mul(c.omd, x)); }

// ---- (a) the partial sums of g^2, one an item of a kind-0 row ----

__device__ __forceinline__ double block_sum(double x, double* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += warp_sums[w];
  return total;  // thread 0's
}

template <typename T>
__global__ void __launch_bounds__(kThreads) norm_partial(Args a) {
  __shared__ double warp_sums[kThreads / 32];
  const int2 it = a.items[blockIdx.x];
  const Row r = a.rows[it.x];
  const long long start = (long long)it.y * kChunk;
  const int len = (int)min((long long)kChunk, r.n - start);
  const T* g = static_cast<const T*>(r.g) + start;
  double acc = 0.0;
  bool vec = false;
  if constexpr (sizeof(T) == 4) vec = r.vec;  // fp32 rows only
  if (vec) {
    const int nq = len >> 2;
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      const int q = threadIdx.x + k * kThreads;
      if (q < nq) {
        const float4 v = reinterpret_cast<const float4*>(g)[q];
        acc += (double)v.x * v.x;
        acc += (double)v.y * v.y;
        acc += (double)v.z * v.z;
        acc += (double)v.w * v.w;
      }
    }
    if ((int)threadIdx.x < (len & 3)) {
      const double x = g[(nq << 2) + threadIdx.x];
      acc += x * x;
    }
  } else {
    for (int k = 0; k < kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < len) {
        const double x = g[i];
        acc += x * x;
      }
    }
  }
  const double total = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) a.partials[blockIdx.x] = total;
}

// ---- (b) the norm and the clip's scale ----

__global__ void __launch_bounds__(kFinishThreads) norm_finish(Args a, int n_partials) {
  __shared__ double warp_sums[kFinishThreads / 32];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n_partials; i += kFinishThreads) acc += a.partials[i];
  const double sq = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) {
    const float total = (float)sqrt(sq);
    const float x = dvd(kMaxNorm, add(total, kNormEps));
    a.clip[0] = total;
    a.clip[1] = isnan(x) ? x : fminf(1.0f, x);  // jnp.minimum(1.0, x)
  }
}

// ---- (c) the update, the zeroing and the EMA ----

template <int R>
__device__ __forceinline__ void update4(float4& p, const float4& g, float4& m, float4& v, float4& e,
                                        const Scalars<float>& c) {
  update<R, float>(p.x, g.x, m.x, v.x, c);
  update<R, float>(p.y, g.y, m.y, v.y, c);
  update<R, float>(p.z, g.z, m.z, v.z, c);
  update<R, float>(p.w, g.w, m.w, v.w, c);
  e = make_float4(ema_of(e.x, p.x, c), ema_of(e.y, p.y, c), ema_of(e.z, p.z, c), ema_of(e.w, p.w, c));
}

template <int R, typename T>
__device__ __forceinline__ void update1(T* pp, T* gp, T* mp, T* np, T* ep, long long i, const Scalars<T>& c) {
  constexpr bool kNu = R != kSGD;
  T p = pp[i], m = mp[i], v = kNu ? np[i] : T(0);
  update<R, T>(p, gp[i], m, v, c);
  pp[i] = p;
  mp[i] = m;
  if (kNu) np[i] = v;
  gp[i] = T(0);
  ep[i] = ema_of(ep[i], p, c);
}

template <int R, typename T>
__global__ void __launch_bounds__(kThreads) apply_kernel(Args a) {
  constexpr bool kNu = R != kSGD;  // SGD keeps no second moment: nu is neither read nor written
  const int2 it = a.items[blockIdx.x];
  const Row r = a.rows[it.x];
  const long long start = (long long)it.y * kChunk;
  const int len = (int)min((long long)kChunk, r.n - start);
  Scalars<T> c;
  c.d = *a.d;
  c.omd = *a.omd;
  if (r.kind == 2) {  // an integer entry: its bytes copied
    const char* src = static_cast<const char*>(r.p) + start;
    char* dst = static_cast<char*>(r.ema) + start;
    for (int i = threadIdx.x; i < len; i += kThreads) dst[i] = src[i];
    return;
  }
  if (r.kind == 1) {  // a statistic or a frozen parameter: the EMA alone
    const T* x = static_cast<const T*>(r.p) + start;
    T* e = static_cast<T*>(r.ema) + start;
    if constexpr (sizeof(T) == 4) {
      if (r.vec) {  // float4 loads and stores
        const int nq = len >> 2;
        for (int q = threadIdx.x; q < nq; q += kThreads) {
          const float4 xv = reinterpret_cast<const float4*>(x)[q];
          float4 ev = reinterpret_cast<float4*>(e)[q];
          ev = make_float4(ema_of(ev.x, xv.x, c), ema_of(ev.y, xv.y, c), ema_of(ev.z, xv.z, c),
                           ema_of(ev.w, xv.w, c));
          reinterpret_cast<float4*>(e)[q] = ev;
        }
        if ((int)threadIdx.x < (len & 3)) {
          const int i = (nq << 2) + threadIdx.x;
          e[i] = ema_of(e[i], x[i], c);
        }
        return;
      }
    }
    for (int i = threadIdx.x; i < len; i += kThreads) e[i] = ema_of(e[i], x[i], c);
    return;
  }
  const float lr = a.hyper[r.group];
  c.lr = lr;
  c.b1 = a.hyper[3];
  c.wd = a.wd;
  c.decay_mul = __fsub_rn(1.0f, __fmul_rn(lr, a.wd));
  c.lr_b1t = __fdiv_rn(lr, a.s[0]);
  c.decay = r.group == 1;
  c.scale = a.clip[1];
  c.b1t = a.s[0];
  c.b2t = a.s[1];
  c.c1 = a.s[2];
  c.c2 = a.s[3];
  c.rect = a.s[4];
  c.use_rect = a.s[5];
  c.sqb2t = a.s[6];
  c.omb1 = a.s[7];
  T* pp = static_cast<T*>(r.p) + start;
  T* gp = static_cast<T*>(r.g) + start;
  T* mp = static_cast<T*>(r.mu) + start;
  T* np = static_cast<T*>(r.nu) + start;
  T* ep = static_cast<T*>(r.ema) + start;
  if constexpr (sizeof(T) == 4) {
    if (r.vec) {  // float4 loads and stores
      float4* p = reinterpret_cast<float4*>(pp);
      float4* g = reinterpret_cast<float4*>(gp);
      float4* mu = reinterpret_cast<float4*>(mp);
      float4* nu = reinterpret_cast<float4*>(np);
      float4* e = reinterpret_cast<float4*>(ep);
      const int nq = len >> 2;
#pragma unroll
      for (int k = 0; k < kQuads; ++k) {
        const int q = threadIdx.x + k * kThreads;
        if (q < nq) {
          float4 pv = p[q], mv = mu[q], ev = e[q];
          const float4 gv = g[q];
          float4 vv = kNu ? nu[q] : make_float4(0.f, 0.f, 0.f, 0.f);
          update4<R>(pv, gv, mv, vv, ev, c);
          p[q] = pv;
          mu[q] = mv;
          if (kNu) nu[q] = vv;
          g[q] = make_float4(0.f, 0.f, 0.f, 0.f);
          e[q] = ev;
        }
      }
      if ((int)threadIdx.x < (len & 3)) update1<R, T>(pp, gp, mp, np, ep, (nq << 2) + threadIdx.x, c);
      return;
    }
  }
  for (int k = 0; k < kPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < len) update1<R, T>(pp, gp, mp, np, ep, i, c);
  }
}

template <int R, typename T>
cudaError_t launch_apply(const Args& a, int n_items, cudaStream_t st) {
  if (n_items) apply_kernel<R, T><<<(unsigned)n_items, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const Args& a, int n_norm_items, int n_items, int rule, cudaStream_t st) {
  if (n_norm_items) {
    norm_partial<T><<<(unsigned)n_norm_items, kThreads, 0, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  norm_finish<<<1, kFinishThreads, 0, st>>>(a, n_norm_items);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (rule) {
    case kSGD: return launch_apply<kSGD, T>(a, n_items, st);
    case kAdam: return launch_apply<kAdam, T>(a, n_items, st);
    case kAdamax: return launch_apply<kAdamax, T>(a, n_items, st);
    case kAdamW: return launch_apply<kAdamW, T>(a, n_items, st);
    case kNAdam: return launch_apply<kNAdam, T>(a, n_items, st);
    case kRAdam: return launch_apply<kRAdam, T>(a, n_items, st);
    default: return launch_apply<kRMSProp, T>(a, n_items, st);
  }
}

}  // namespace

extern "C" int optim_apply(const void* rows, const void* items, int n_norm_items, int n_items, int rule, int dtype,
                           const void* hyper, const void* s, const void* d, const void* omd, float wd,
                           void* partials, void* clip, int chunk, int device, void* stream) {
  if (chunk != kChunk) return static_cast<int>(cudaErrorInvalidValue);  // the wrapper's plan disagrees
  if (n_norm_items < 0 || n_items < n_norm_items || rule < 0 || rule > kRMSProp || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(rows) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaSetDevice(device);  // nvcc's own runtime: its current device is not PyTorch's
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{};
  a.rows = static_cast<const Row*>(rows);
  a.items = static_cast<const int2*>(items);
  a.hyper = static_cast<const float*>(hyper);
  a.s = static_cast<const float*>(s);
  a.d = static_cast<const float*>(d);
  a.omd = static_cast<const float*>(omd);
  a.wd = wd;
  a.partials = static_cast<double*>(partials);
  a.clip = static_cast<float*>(clip);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? launch_all<float>(a, n_norm_items, n_items, rule, st)
                                     : launch_all<double>(a, n_norm_items, n_items, rule, st));
}

extern "C" const char* optim_apply_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
