// The task-aligned assigner's per-GT top-k (K7) for Hopper (sm_90a): the k largest values of every row and their
// indices, in lax.top_k's order.
//
// Replaces the XLA ops of yololite_tpu/utils/tal.py:61 `topk_blockmax_gather` (the default, TOPK_MODE :34) and
// :97 `topk_hierarchical`, the TPU's ways round a sort of each (b, m) row of A anchors, called at :243. Its plain
// version is ops/boxes.py `topk_stable` (a stable descending sort, then the first k).
//
// Inputs: x (rows, n), fp32 or fp64 (the float64 reference step), read through a row stride (the assigner's
// (B, M, A) align metrics); k <= 32 and k <= n (the wrapper passes min(k, n)). Outputs: vals (rows, k) in x's
// type and idx (rows, k) int64, contiguous.
//
// The order: values descending, compared as numbers (so -0.0 ties 0.0), a tie to the lower index, NaN first
// (above every number, NaNs among themselves by index): the order of torch.sort(descending=True, stable=True),
// and lax.top_k's on every input without NaN. So vals and idx equal the plain version's bit for bit.
//
// Design: a block of 8 warps a row. Each warp walks its share of the row in chunks of 32 (one element a lane,
// coalesced; four chunks' loads issued before they are used) and keeps its own top k across its lanes, lane i
// holding the i-th entry in registers. Its first chunk fills the list with a bitonic sort of the 32 lanes; a
// later chunk costs one compare with the current k-th entry and a ballot, and each lane that beats it is
// inserted in index order: a ballot finds its place, a shuffle up makes room. Random rows insert some
// k ln(n / 8k) times a warp; a zero metric behind k earlier zeros never inserts. Then the eight lists (staged in
// shared memory) merge in one step: each entry's rank is counted by binary searches in the other lists, and
// the entries of rank < k are written, their values read back from the row (so NaN payloads survive). The
// launch depends only on the shapes, so a CUDA graph captures it; nothing is allocated and nothing read back.
//
// Bound on an H100 SXM at the train step's shapes (B 16, A 8,400; chip_smoke.py loss_tail_bound_ms): the rows
// are read once, 17.2 MB at M 32, 34.4 MB at M 64: about 5 and 10 us at 3.35 TB/s; the outputs (12 bytes an
// entry) are small.
//
// C interface, bound with ctypes: launches on the caller's stream of the caller's device, allocates nothing, does
// not synchronise, and returns the first CUDA error, that of the launch included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;
constexpr int kUnroll = 4;  // chunks whose loads a warp issues before it compares them
constexpr unsigned kFull = 0xffffffffu;

// (a, ia) comes before (b, ib): a larger number, NaN above every number, equal values (NaN equals NaN) by index
template <typename C>
__device__ __forceinline__ bool before(C a, int ia, C b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// a warp's top-k list: lane i holds the i-th entry (v, i) when i < cnt
template <typename C>
struct List {
  C v;
  int idx;
  int cnt;
};

// insert the candidates of the lanes in `mask` (lane l offering (cv, ci)) into the list, in lane order
template <typename C>
__device__ __forceinline__ void insert(List<C>& L, unsigned mask, C cv, int ci, int k, int lane) {
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const C xv = __shfl_sync(kFull, cv, src);
    const int xi = __shfl_sync(kFull, ci, src);
    if (L.cnt == k) {
      const C kv = __shfl_sync(kFull, L.v, k - 1);
      const int ki = __shfl_sync(kFull, L.idx, k - 1);
      if (!before(xv, xi, kv, ki)) continue;
    }
    const int pos = __popc(__ballot_sync(kFull, lane < L.cnt && before(L.v, L.idx, xv, xi)));
    const C pv = __shfl_up_sync(kFull, L.v, 1);
    const int pi = __shfl_up_sync(kFull, L.idx, 1);
    if (lane > pos) {
      L.v = pv;
      L.idx = pi;
    }
    if (lane == pos) {
      L.v = xv;
      L.idx = xi;
    }
    L.cnt = min(L.cnt + 1, k);
  }
}

// an empty list takes a chunk whole: a bitonic sort of the 32 lanes' candidates (invalid ones last), then its
// first k
template <typename C>
__device__ __forceinline__ void fill(List<C>& L, bool valid, C cv, int ci, int k, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const C ov = __shfl_xor_sync(kFull, cv, stride);
      const int oi = __shfl_xor_sync(kFull, ci, stride);
      const bool ovalid = __shfl_xor_sync(kFull, valid, stride);
      const bool self_first = valid && (!ovalid || before(cv, ci, ov, oi));
      const bool descending = (lane & size) == 0, lower = (lane & stride) == 0;
      if ((lower == descending) != self_first) {  // this lane takes the other's entry
        cv = ov;
        ci = oi;
        valid = ovalid;
      }
    }
  }
  L.v = cv;
  L.idx = ci;
  L.cnt = min(__popc(__ballot_sync(kFull, valid)), k);
}

// offer one candidate a lane (valid ones only) to the list: the lanes that beat the current k-th entry
template <typename C>
__device__ __forceinline__ void offer(List<C>& L, bool valid, C cv, int ci, int k, int lane) {
  if (L.cnt == 0) {
    fill(L, valid, cv, ci, k, lane);
    return;
  }
  bool beats = valid;
  if (L.cnt == k) {
    const C kv = __shfl_sync(kFull, L.v, k - 1);
    const int ki = __shfl_sync(kFull, L.idx, k - 1);
    beats = valid && before(cv, ci, kv, ki);
  }
  const unsigned mask = __ballot_sync(kFull, beats);
  if (mask) insert(L, mask, cv, ci, k, lane);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) topk_rows_kernel(const T* __restrict__ x, long long rs, int n, int k,
                                                             T* __restrict__ vals, long long* __restrict__ idx) {
  __shared__ T sv[kWarps][kMaxK];
  __shared__ int si[kWarps][kMaxK];
  __shared__ int scnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = blockIdx.x;
  const T* p = x + row * rs;
  List<T> L{T(0), 0, 0};
  const int chunks = (n + 31) / 32;
  // warp w takes chunks w, w + 8, ...: kUnroll of them loaded, then offered in index order
  for (int c0 = warp; c0 < chunks; c0 += kWarps * kUnroll) {
    T cv[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = (c0 + u * kWarps) * 32 + lane;
      ok[u] = c0 + u * kWarps < chunks && i < n;
      cv[u] = ok[u] ? p[i] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u * kWarps >= chunks) break;  // uniform across the warp
      offer(L, ok[u], cv[u], (c0 + u * kWarps) * 32 + lane, k, lane);
    }
  }
  sv[warp][lane] = L.v;  // lanes past the list's count hold nothing of it; they are never read
  si[warp][lane] = L.idx;
  if (lane == 0) scnt[warp] = L.cnt;
  __syncthreads();
  // the merge: each entry's rank among all the warps' entries (distinct under `before`) is its place in its own
  // list plus, in each other sorted list, the length of the prefix that comes before it (a binary search); the
  // entries of rank < k are the row's top k. The value is read back from x, so its bits are the input's
  if (lane >= L.cnt) return;
  int rank = lane;
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) continue;
    int lo = 0, hi = scnt[w];
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (before(sv[w][mid], si[w][mid], L.v, L.idx))
        lo = mid + 1;
      else
        hi = mid;
    }
    rank += lo;
  }
  if (rank < k) {
    vals[row * k + rank] = p[L.idx];
    idx[row * k + rank] = L.idx;
  }
}

template <typename T>
cudaError_t launch(const void* x, long long rs, long long rows, int n, int k, void* vals, void* idx, cudaStream_t st) {
  topk_rows_kernel<T><<<(unsigned)rows, kThreads, 0, st>>>(static_cast<const T*>(x), rs, n, k, static_cast<T*>(vals),
                                                           static_cast<long long*>(idx));
  return cudaGetLastError();
}

}  // namespace

// x_type: 0 fp32, 1 fp64; k is the output's width, min(k, n), at most 32
extern "C" int topk_rows(const void* x, long long row_stride, long long rows, int n, int x_type, int k, void* vals,
                         void* idx, int device, void* stream) {
  if (rows < 0 || rows >= (1ll << 31) || n < 0 || k < 0 || k > kMaxK || k > n || x_type < 0 || x_type > 1 ||
      (rows > 1 && row_stride < n))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || k == 0) return 0;
  cudaError_t err = cudaSetDevice(device);  // nvcc's own runtime: its current device is not PyTorch's
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_type) {
    case 0: return static_cast<int>(launch<float>(x, row_stride, rows, n, k, vals, idx, st));
    default: return static_cast<int>(launch<double>(x, row_stride, rows, n, k, vals, idx, st));
  }
}

extern "C" const char* topk_rows_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
