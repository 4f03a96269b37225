// The compact-K foreground gather of the train loss (K9) and its backward, for Hopper (sm_90a).
//
// Replaces the XLA ops of yololite_tpu/utils/loss.py:162-172, the compact box/DFL branch (COMPACT_BOX_LOSS :68):
// `idx = lax.top_k(fg, K)` over the assigner's (B, A) foreground mask and the one-hot contraction
// `einsum("bka,bar->bkr", one_hot(idx, A), pred_distri)` that gathers the K rows of the DFL logits, with the
// transpose of that contraction as its backward. Its plain versions are ops/loss_kernels.py `compact_rows_plain`
// (ops/boxes.py `topk_stable` of fg as floats, then torch.gather) and `compact_rows_backward_plain` (zeros, the rows
// put back at idx).
//
// Inputs: x (B, A, C) logits, fp32, bf16 or fp64 (the float64 reference step), read through a row stride (the
// loss's box logits are the first 64 columns of the (B, A, 144) Detect maps, row stride 144); fg (B, A) bool,
// contiguous; K <= A. Outputs: rows (B, K, C) in x's type, contiguous, an exact copy; idx (B, K) int64; pos (B, A)
// int32, the inverse map (the position of row a among the K, or -1), which the backward reads. Backward: the
// gradient g (B, K, C) of rows, contiguous, -> dx (B, A, C) contiguous in g's type: row a gets g's row pos[a], or
// +0.0 where pos[a] is -1. The picked rows are distinct, so dx is exact, with no atomics and no zero-fill launch.
//
// The order is lax.top_k's over fg as 0.0 / 1.0: first the foreground rows in increasing index order, at most K of
// them, then the first K - nfg other rows in increasing index order. So the foreground row a with f foreground rows
// before it goes to position f, and the other row a to nfg + (a - f); a position below K is picked. idx, rows, pos
// and dx equal the plain versions' bit for bit.
//
// Design. Two launches on the forward, one on the backward; the launches depend on the shapes alone, so a CUDA
// graph captures them (no host sync, no allocation).
//  1. scan: a block of kScan threads an image, walking A in tiles of kScan * kPer entries, thread t the kPer
//     consecutive entries t * kPer.. of a tile, its kPer loads issued before any is used. Pass 1 counts the image's
//     foreground rows; pass 2 walks the same tiles again (from L1), a block-wide exclusive scan of the threads'
//     counts (warp shuffles, then the warps' totals) carrying the running count from tile to tile, so any A fits
//     (2,100 at imgsz 320, 8,400 at 640, 33,600 at 1,280). Each entry writes its pos, and a picked one its idx. fg
//     is B * A bytes: 134 KB at B 16, A 8,400.
//  2. copy: a grid over the B * K rows' pieces, 16 bytes a thread where the wrapper's plan allows (ops/loss_kernels.py
//     `compact_rows_plan`: x's pointer and row stride in bytes, and the row's bytes, multiples of 16), a warp
//     reading two fp32 rows of 256 bytes as 32 neighbouring pieces; any other layout takes the scalar route, an
//     element a thread.
//  3. backward: a grid over the B * A rows of dx, in pieces as in 2 (g and dx 16-byte aligned and the row's bytes a
//     multiple of 16) or an element a thread: each piece of row a reads pos[a], then g's piece or nothing.
//
// Bound on an H100 SXM at the train step's shapes (B 16, A 8,400, C 64, M 32: K 320; chip_smoke.py
// compact_rows_bound_ms, the function's bytes): the forward reads fg and the K rows it needs and writes rows and
// idx: 2.8 MB in fp32 (1.5 in bf16), about 0.83 us at 3.35 TB/s (0.44 in bf16); the backward reads g and idx and
// writes the dense dx: 35.8 MB in fp32 (17.9 in bf16), about 10.7 us (5.3). The inverse map pos, which this design
// writes in the forward and reads in the backward (B * A * 4 bytes each way), is not counted. No arithmetic to speak
// of: bytes bound both.
//
// C interface, bound with ctypes: launches on the caller's stream of the caller's device, allocates nothing, does
// not synchronise, and returns the first CUDA error, that of the launches included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScan = 1024;               // threads of the scan's block: an image
constexpr int kScanWarps = kScan / 32;
constexpr int kPer = 8;                   // consecutive entries a thread takes in a tile
constexpr int kTile = kScan * kPer;
constexpr int kThreads = 256;             // threads of a copy block
constexpr long long kMaxBlocks = 132 * 64; // a grid-stride grid: enough blocks to fill the card, no more
constexpr unsigned kFull = 0xffffffffu;

// v's exclusive prefix over the block's threads in thread order; *total gets the block's sum (every thread)
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kScanWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kScanWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += n;
    }
    if (lane < kScanWarps) warp_sums[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  const int before = (warp ? warp_sums[warp - 1] : 0) + inc - v;
  *total = warp_sums[kScanWarps - 1];
  __syncthreads();  // warp_sums is the next call's
  return before;
}

__global__ void __launch_bounds__(kScan) compact_scan(const uint8_t* __restrict__ fg, long long a, long long k,
                                                      long long* __restrict__ idx, int* __restrict__ pos) {
  const long long b = blockIdx.x;
  const uint8_t* f = fg + b * a;
  int* p_out = pos + b * a;
  long long* i_out = idx + b * k;
  // pass 1: the image's foreground count, a tile's kPer loads of a thread issued before any is used (pass 2 reads
  // the same bytes again from L1)
  int count = 0;
  for (long long base = 0; base < a; base += kTile) {
    const long long first = base + static_cast<long long>(threadIdx.x) * kPer;
    uint8_t v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = first + j < a ? __ldg(f + first + j) : 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) count += v[j] != 0;
  }
  int nfg;
  block_exclusive_scan(count, &nfg);
  long long carry = 0;  // foreground entries before the tile
  for (long long base = 0; base < a; base += kTile) {
    const long long first = base + static_cast<long long>(threadIdx.x) * kPer;
    uint8_t v[kPer];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = first + j < a ? __ldg(f + first + j) : 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = v[j] != 0;
      mine += v[j];
    }
    int tile_total;
    long long before = carry + block_exclusive_scan(mine, &tile_total);  // foreground entries before `first`
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long e = first + j;
      if (e >= a) break;
      const long long p = v[j] ? before : nfg + (e - before);
      before += v[j];
      if (p < k) {
        p_out[e] = static_cast<int>(p);
        i_out[p] = e;
      } else {
        p_out[e] = -1;
      }
    }
    carry += tile_total;
  }
}

// rows[r] = x's row idx[r] of its image, in 16-byte pieces (ppr a row)
__global__ void __launch_bounds__(kThreads) compact_copy_vec(const char* __restrict__ x, long long x_row_bytes,
                                                             long long a, const long long* __restrict__ idx,
                                                             long long k, int ppr, long long n,
                                                             uint4* __restrict__ rows) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = i / ppr;
    const int q = static_cast<int>(i - r * ppr);
    const long long src = (r / k) * a + idx[r];
    rows[i] = __ldg(reinterpret_cast<const uint4*>(x + src * x_row_bytes) + q);
  }
}

// the same an element at a time (U: an element's bits)
template <typename U>
__global__ void __launch_bounds__(kThreads) compact_copy_scalar(const U* __restrict__ x, long long x_rs, long long a,
                                                                const long long* __restrict__ idx, long long k,
                                                                int cols, long long n, U* __restrict__ rows) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = i / cols;
    const int c = static_cast<int>(i - r * cols);
    rows[i] = x[((r / k) * a + idx[r]) * x_rs + c];
  }
}

// dx's row r = b * A + a: g's row b * K + pos[r], or zeros
__global__ void __launch_bounds__(kThreads) compact_backward_vec(const uint4* __restrict__ g,
                                                                 const int* __restrict__ pos, long long a,
                                                                 long long k, int ppr, long long n,
                                                                 uint4* __restrict__ dx) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = i / ppr;
    const int q = static_cast<int>(i - r * ppr);
    const int p = pos[r];
    dx[i] = p >= 0 ? __ldg(g + ((r / a) * k + p) * ppr + q) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename U>
__global__ void __launch_bounds__(kThreads) compact_backward_scalar(const U* __restrict__ g,
                                                                    const int* __restrict__ pos, long long a,
                                                                    long long k, int cols, long long n,
                                                                    U* __restrict__ dx) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = i / cols;
    const int p = pos[r];
    dx[i] = p >= 0 ? g[((r / a) * k + p) * cols + (i - r * cols)] : U(0);
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename U>
cudaError_t copy_scalar(const void* x, long long x_rs, long long a, const long long* idx, long long k, int cols,
                        long long n, void* rows, cudaStream_t st) {
  compact_copy_scalar<U><<<grid_for(n), kThreads, 0, st>>>(static_cast<const U*>(x), x_rs, a, idx, k, cols, n,
                                                           static_cast<U*>(rows));
  return cudaGetLastError();
}

template <typename U>
cudaError_t backward_scalar(const void* g, const int* pos, long long a, long long k, int cols, long long n, void* dx,
                            cudaStream_t st) {
  compact_backward_scalar<U><<<grid_for(n), kThreads, 0, st>>>(static_cast<const U*>(g), pos, a, k, cols, n,
                                                               static_cast<U*>(dx));
  return cudaGetLastError();
}

bool valid_shapes(long long b, long long a, long long k, int cols, int es) {
  return b >= 0 && b < (1ll << 31) && a >= 0 && a < (1ll << 31) && k >= 0 && k <= a && cols >= 1 &&
         (es == 2 || es == 4 || es == 8);
}

}  // namespace

extern "C" int compact_rows_forward(const void* x, long long x_rs, long long b, long long a, int cols, int es, int vec,
                                    const void* fg, long long k, void* rows, void* idx, void* pos, int device,
                                    void* stream) {
  if (!valid_shapes(b, a, k, cols, es) || x_rs < cols) return static_cast<int>(cudaErrorInvalidValue);
  const int row_bytes = cols * es;
  if (vec && (row_bytes % 16 != 0 || !aligned(x, 16) || (x_rs * es) % 16 != 0 || !aligned(rows, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);  // the wrapper's plan chose a route the layout refuses
  cudaError_t err = cudaSetDevice(device);  // nvcc's own runtime: its current device is not PyTorch's
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || a == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* id = static_cast<long long*>(idx);
  compact_scan<<<static_cast<unsigned>(b), kScan, 0, st>>>(static_cast<const uint8_t*>(fg), a, k, id,
                                                           static_cast<int*>(pos));
  err = cudaGetLastError();
  if (err != cudaSuccess || k == 0) return static_cast<int>(err);
  if (vec) {
    const int ppr = row_bytes / 16;
    const long long n = b * k * ppr;
    compact_copy_vec<<<grid_for(n), kThreads, 0, st>>>(static_cast<const char*>(x), x_rs * es, a, id, k, ppr, n,
                                                       static_cast<uint4*>(rows));
    return static_cast<int>(cudaGetLastError());
  }
  const long long n = b * k * cols;
  switch (es) {
    case 2: return static_cast<int>(copy_scalar<uint16_t>(x, x_rs, a, id, k, cols, n, rows, st));
    case 4: return static_cast<int>(copy_scalar<uint32_t>(x, x_rs, a, id, k, cols, n, rows, st));
    default: return static_cast<int>(copy_scalar<unsigned long long>(x, x_rs, a, id, k, cols, n, rows, st));
  }
}

extern "C" int compact_rows_backward(const void* g, long long b, long long k, long long a, int cols, int es, int vec,
                                     const void* pos, void* dx, int device, void* stream) {
  if (!valid_shapes(b, a, k, cols, es)) return static_cast<int>(cudaErrorInvalidValue);
  const int row_bytes = cols * es;
  if (vec && (row_bytes % 16 != 0 || !aligned(g, 16) || !aligned(dx, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || a == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (vec) {
    const int ppr = row_bytes / 16;
    const long long n = b * a * ppr;
    compact_backward_vec<<<grid_for(n), kThreads, 0, st>>>(static_cast<const uint4*>(g), p, a, k, ppr, n,
                                                           static_cast<uint4*>(dx));
    return static_cast<int>(cudaGetLastError());
  }
  const long long n = b * a * cols;
  switch (es) {
    case 2: return static_cast<int>(backward_scalar<uint16_t>(g, p, a, k, cols, n, dx, st));
    case 4: return static_cast<int>(backward_scalar<uint32_t>(g, p, a, k, cols, n, dx, st));
    default: return static_cast<int>(backward_scalar<unsigned long long>(g, p, a, k, cols, n, dx, st));
  }
}

extern "C" const char* compact_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
