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
// run and every card: a fixed partition and fixed trees, no float atomics.
//
// Design. The (rows, C) elements, flattened row-major (e = r * C + c), are cut into pieces of G = 16 / sizeof(x)
// consecutive elements (4 fp32, 8 bf16, 2 fp64 logits: 16 bytes), and the pieces into chunks of kChunk: a block
// of kThreads threads takes one chunk, thread t its pieces t, t + kThreads, ... (kPer of them), so a warp's loads
// are 32 neighbouring 16-byte pieces. A thread starts all its loads, logits and labels, before it computes any
// term; it adds its terms in piece order, then the block folds its threads' sums in a fixed tree into the chunk's
// partial, and a second launch of one block adds the partials in a fixed tree. The partition depends on the
// element count and x's type alone, so the sum has the same bits on every run and every card, and a CUDA graph
// captures both launches. The vector route (`vec`, chosen by the wrapper, ops/loss_kernels.py `bce_sum_plan`)
// needs C a multiple of G and the rows 16-byte aligned (the train step's class slice starts at byte 256 of a
// 576-byte fp32 row, 128 of a 288-byte bf16 one; the labels are (rows, 80) contiguous); any other layout takes
// the scalar route of the same kernel, one element at a time, with the same pieces, so the same sum. The
// backward walks the same pieces and stores dx (rows, C) contiguous, 16 bytes a piece on the vector route.
//
// Bound on an H100 SXM at the train step's shapes (B 16, A 8,400, C 80: 10.75 M terms; chip_smoke.py
// loss_tail_bound_ms): the forward reads the logits and the labels once, 86 MB in fp32, about 26 us at 3.35 TB/s;
// the backward also writes dx, 129 MB, about 39 us; bf16 halves them. A forward term costs some 40 instructions
// (expf and log1pf), about 15 us at the card's full instruction rate: under the fp32 bytes, over bf16's.
//
// C interface, bound with ctypes: launches on the caller's stream of the caller's device, allocates nothing (the
// partials are the caller's), does not synchronise, and returns the first CUDA error, that of the launches
// included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                   // pieces a thread takes, all loaded before any term is computed
constexpr int kChunk = kThreads * kPer;   // pieces a block takes: the partition's unit, one partial each
constexpr int kFinalThreads = 512;        // the second launch's block
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }
template <>
__device__ __forceinline__ float to_float<double>(double v) { return __double2float_rn(v); }

// element j of a piece held as 32-bit words
template <typename T>
__device__ __forceinline__ T elem(const uint32_t* w, int j);
template <>
__device__ __forceinline__ float elem<float>(const uint32_t* w, int j) { return __uint_as_float(w[j]); }
template <>
__device__ __forceinline__ __nv_bfloat16 elem<__nv_bfloat16>(const uint32_t* w, int j) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(w[j >> 1] >> ((j & 1) * 16)));
}
template <>
__device__ __forceinline__ double elem<double>(const uint32_t* w, int j) {
  return __hiloint2double(static_cast<int>(w[2 * j + 1]), static_cast<int>(w[2 * j]));
}

template <typename T>
__device__ __forceinline__ void put(uint32_t* w, int j, T v);
template <>
__device__ __forceinline__ void put<float>(uint32_t* w, int j, float v) { w[j] = __float_as_uint(v); }
template <>
__device__ __forceinline__ void put<__nv_bfloat16>(uint32_t* w, int j, __nv_bfloat16 v) {
  const uint32_t b = __bfloat16_as_ushort(v);
  w[j >> 1] = (j & 1) ? (w[j >> 1] | (b << 16)) : b;
}
template <>
__device__ __forceinline__ void put<double>(uint32_t* w, int j, double v) {
  w[2 * j] = static_cast<uint32_t>(__double2loint(v));
  w[2 * j + 1] = static_cast<uint32_t>(__double2hiint(v));
}

// NB bytes from p (aligned to min(NB, 16)) into 32-bit words: 16-byte loads, or one 8- or 4-byte load
template <int NB>
__device__ __forceinline__ void load_words(const void* p, uint32_t* w) {
  if constexpr (NB >= 16) {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i) {
      const uint4 u = __ldg(static_cast<const uint4*>(p) + i);
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  } else if constexpr (NB == 8) {
    const uint2 u = __ldg(static_cast<const uint2*>(p));
    w[0] = u.x;
    w[1] = u.y;
  } else {
    w[0] = __ldg(static_cast<const unsigned*>(p));
  }
}

// a label (type L: fp32 or bf16) as a float, exact
template <typename L>
__device__ __forceinline__ float label(L v) { return to_float<L>(v); }

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
  long long xrs;      // x's row stride, elements
  const void* y;
  long long yrs;      // y's row stride, elements
  long long rows;
  int cols;
  long long n;        // rows * cols
  long long pieces;   // ceil(n / G)
  int vec;            // the vector route: 16-byte pieces
  int ppr;            // pieces a row on the vector route (cols / G); a step of kThreads pieces is dr rows, dq pieces
  int dr, dq;
  long long chunks;   // ceil(pieces / kChunk): a block each
  const float* g;
  void* out;          // the forward's partials, one a chunk; the backward's dx (rows, cols) in x's type
};

// a block's threads' sums folded in a fixed tree: a shuffle-down tree in each warp, then the warps' sums in order
template <int kBlock>
__device__ __forceinline__ float block_sum(float acc) {
  __shared__ float warp_sum[kBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, o));
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  float s = warp_sum[0];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kBlock / 32; ++w) s = __fadd_rn(s, warp_sum[w]);
  }
  return s;  // thread 0's is the block's sum
}

// the vector route's walk: thread t's kPer pieces of chunk c, each as (row, piece in the row), loaded into words
// before any is used; live[i] false past the last piece
template <typename T, typename L>
struct Pieces {
  static constexpr int G = 16 / sizeof(T);
  static constexpr int YB = G * sizeof(L);  // a piece's label bytes
  uint32_t xw[kPer][4];
  uint32_t yw[kPer][YB >= 4 ? YB / 4 : 1];
  int row[kPer], col[kPer];
  bool live[kPer];

  __device__ __forceinline__ void load(const Args& a, unsigned c) {
    const unsigned p0 = c * kChunk + threadIdx.x;
    unsigned r = p0 / static_cast<unsigned>(a.ppr);
    int q = static_cast<int>(p0 - r * static_cast<unsigned>(a.ppr));
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      live[i] = static_cast<long long>(p0) + static_cast<long long>(i) * kThreads < a.pieces;
      row[i] = static_cast<int>(r);
      col[i] = q * G;
      if (live[i]) {
        load_words<16>(static_cast<const T*>(a.x) + r * a.xrs + q * G, xw[i]);
        load_words<YB>(static_cast<const L*>(a.y) + r * a.yrs + q * G, yw[i]);
      }
      r += a.dr;
      q += a.dq;
      if (q >= a.ppr) {
        q -= a.ppr;
        ++r;
      }
    }
  }
};

template <typename T, typename L>
__global__ void __launch_bounds__(kThreads) bce_partial(Args a) {
  constexpr int G = 16 / sizeof(T);
  const long long c = blockIdx.x;
  float acc = 0.0f;
  if (a.vec) {
    Pieces<T, L> pc;
    pc.load(a, static_cast<unsigned>(c));
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (!pc.live[i]) continue;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        acc = __fadd_rn(acc, bce_term(to_float<T>(elem<T>(pc.xw[i], j)), label<L>(elem<L>(pc.yw[i], j))));
      }
    }
  } else {
    const T* __restrict__ x = static_cast<const T*>(a.x);
    const L* __restrict__ y = static_cast<const L*>(a.y);
    const long long p0 = c * kChunk + threadIdx.x;
    for (int i = 0; i < kPer; ++i) {
      const long long p = p0 + (long long)i * kThreads;
      for (int j = 0; j < G; ++j) {
        const long long e = p * G + j;
        if (e >= a.n) break;
        const long long r = e / a.cols, col = e - r * a.cols;
        acc = __fadd_rn(acc, bce_term(to_float<T>(x[r * a.xrs + col]), label<L>(y[r * a.yrs + col])));
      }
    }
  }
  const float s = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) static_cast<float*>(a.out)[c] = s;
}

// the count partials into out[0]: thread t adds t, t + kFinalThreads, ... in order, then the same fixed tree
__global__ void __launch_bounds__(kFinalThreads) bce_final(const float* __restrict__ partials, long long count,
                                                           float* __restrict__ out) {
  float acc = 0.0f;
#pragma unroll 4
  for (long long i = threadIdx.x; i < count; i += kFinalThreads) acc = __fadd_rn(acc, partials[i]);
  const float s = block_sum<kFinalThreads>(acc);
  if (threadIdx.x == 0) out[0] = s;
}

template <typename T, typename L>
__global__ void __launch_bounds__(kThreads) bce_backward_kernel(Args a) {
  constexpr int G = 16 / sizeof(T);
  T* __restrict__ dx = static_cast<T*>(a.out);
  const float g = a.g[0];
  const long long c = blockIdx.x;
  if (a.vec) {
    Pieces<T, L> pc;
    pc.load(a, static_cast<unsigned>(c));
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (!pc.live[i]) continue;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < G; ++j) put<T>(w, j, Grad<T>::of(elem<T>(pc.xw[i], j), label<L>(elem<L>(pc.yw[i], j)), g));
      *reinterpret_cast<uint4*>(dx + (long long)pc.row[i] * a.cols + pc.col[i]) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    const T* __restrict__ x = static_cast<const T*>(a.x);
    const L* __restrict__ y = static_cast<const L*>(a.y);
    const long long p0 = c * kChunk + threadIdx.x;
    for (int i = 0; i < kPer; ++i) {
      const long long p = p0 + (long long)i * kThreads;
      for (int j = 0; j < G; ++j) {
        const long long e = p * G + j;
        if (e >= a.n) break;
        const long long r = e / a.cols, col = e - r * a.cols;
        dx[e] = Grad<T>::of(x[r * a.xrs + col], label<L>(y[r * a.yrs + col]), g);
      }
    }
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename T, typename L>
cudaError_t launch(int backward, Args a, long long partials, float* out, cudaStream_t st) {
  constexpr int G = 16 / sizeof(T);
  a.pieces = (a.n + G - 1) / G;
  a.chunks = (a.pieces + kChunk - 1) / kChunk;
  if (!backward && partials != a.chunks) return cudaErrorInvalidValue;  // the wrapper's plan (BCE_CHUNK) disagrees
  if (a.vec) {  // the wrapper chose the vector route: hold it to what the route needs
    if (a.cols % G != 0 || !aligned(a.x, 16) || (a.xrs * (long long)sizeof(T)) % 16 != 0 ||
        !aligned(a.y, G * sizeof(L) < 16 ? G * sizeof(L) : 16) || a.yrs % G != 0 || a.pieces >= (1ll << 31) ||
        (backward && !aligned(a.out, 16)))
      return cudaErrorMisalignedAddress;
    a.ppr = a.cols / G;
    a.dr = kThreads / a.ppr;
    a.dq = kThreads % a.ppr;
  }
  const long long grid = a.chunks;
  if (grid >= (1ll << 31)) return cudaErrorInvalidValue;
  if (backward) {
    if (grid) bce_backward_kernel<T, L><<<(unsigned)grid, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (grid) {
    bce_partial<T, L><<<(unsigned)grid, kThreads, 0, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  bce_final<<<1, kFinalThreads, 0, st>>>(static_cast<const float*>(a.out), a.chunks, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int backward, const Args& a, int y_type, long long partials, float* out, cudaStream_t st) {
  return y_type == 0 ? launch<T, float>(backward, a, partials, out, st)
                     : launch<T, __nv_bfloat16>(backward, a, partials, out, st);
}

int run(int backward, const void* x, long long x_rs, int x_type, const void* y, long long y_rs, int y_type,
        long long rows, int cols, int vec, const void* g, void* partials_or_dx, long long partials, void* out,
        int device, void* stream) {
  if (rows < 0 || cols < 0 || x_type < 0 || x_type > 2 || y_type < 0 || y_type > 1 || x_rs < cols || y_rs < cols)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);  // nvcc's own runtime: its current device is not PyTorch's
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{};
  a.x = x;
  a.xrs = x_rs;
  a.y = y;
  a.yrs = y_rs;
  a.rows = rows;
  a.cols = cols;
  a.n = rows * cols;
  a.vec = vec;
  a.g = static_cast<const float*>(g);
  a.out = partials_or_dx;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (x_type) {
    case 0: return static_cast<int>(launch_t<float>(backward, a, y_type, partials, o, st));
    case 1: return static_cast<int>(launch_t<__nv_bfloat16>(backward, a, y_type, partials, o, st));
    default: return static_cast<int>(launch_t<double>(backward, a, y_type, partials, o, st));
  }
}

}  // namespace

extern "C" int bce_sum_forward(const void* x, long long x_rs, int x_type, const void* y, long long y_rs, int y_type,
                               long long rows, int cols, int vec, void* partials, long long n_partials, void* out,
                               int device, void* stream) {
  return run(0, x, x_rs, x_type, y, y_rs, y_type, rows, cols, vec, nullptr, partials, n_partials, out, device, stream);
}

extern "C" int bce_sum_backward(const void* x, long long x_rs, int x_type, const void* y, long long y_rs, int y_type,
                                long long rows, int cols, int vec, const void* g, void* dx, int device, void* stream) {
  return run(1, x, x_rs, x_type, y, y_rs, y_type, rows, cols, vec, g, dx, 0, nullptr, device, stream);
}

extern "C" const char* bce_sum_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
