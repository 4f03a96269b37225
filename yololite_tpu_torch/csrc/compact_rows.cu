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
// Design. One launch on the forward, one on the backward; each launch's grid depends on the shapes alone, so a CUDA
// graph captures it (no host sync, no allocation).
//  1. forward: a grid of (B, S) blocks of kThreads, S fixed by (B, K) in the wrapper (ops/loss_kernels.py
//     `compact_rows_shares`: about 132 blocks, at least 32 positions a block; S 8 at B 16, K 320). Block (b, s)
//     owns the K positions [s * share, (s + 1) * share), share = ceil(K / S), and the slice [s * ceil(A / S), ..) of
//     A for its pos writes, so every pos entry is written once, by one block. Each block reads its image's whole fg
//     row itself (B * A bytes: 134 KB at B 16, A 8,400; L2 serves the S - 1 re-reads), in tiles of kTile entries,
//     thread t the 64 entries 64t.. of a tile as four 16-byte loads issued before any is used (the row's first and
//     last piece, where fg's rows are not 16-byte aligned, a byte at a time: A 2,100 at imgsz 320). A thread packs
//     its entries into two 32-bit words of flags, one block scan (warp shuffles, then every thread adds the 8
//     warps' totals) gives each word its foreground count before it, and the words go to shared memory. Then a
//     thread writes pos for entries of the block's slice, A / S of them coalesced, and resolves one of the block's
//     positions p: a foreground position (p < nfg) by a binary search for the word holding the p-th foreground entry
//     and a select of the bit; another by the same search over the other entries' counts. The anchors go to a list
//     in shared memory; the block writes idx for its share and copies the share's rows, 16 bytes a thread where
//     the wrapper's plan allows (`compact_rows_plan`: x's pointer and row stride in bytes, and the row's bytes,
//     multiples of 16), kBatch pieces loaded before any is stored; an element a thread on any other layout. A row
//     longer than a tile (A 33,600 at imgsz 1,280) first counts nfg over its tiles, then carries the count from
//     tile to tile; a share longer than kThreads is walked in chunks of the list.
//  2. backward: a grid over the B * A rows of dx, in 16-byte pieces (g and dx 16-byte aligned and the row's bytes a
//     multiple of 16) or an element a thread: each piece of row a reads pos[a], then g's piece or nothing.
//
// What bounds it, on an H100 SXM at the train step's shapes (B 16, A 8,400, C 64, M 32: K 320; chip_smoke.py
// compact_rows_bound_ms, the function's bytes): the forward reads fg and the K rows it needs and writes rows and
// idx: 2.8 MB in fp32 (1.5 in bf16), about 0.83 us at 3.35 TB/s (0.44 in bf16), below the cost of one launch
// (chip_smoke.py compact_rows_numbers times an empty kernel on the same grid, `compact_rows_empty`). So the
// forward is bound by its launches and by the chain of dependent steps inside a block. Hence one launch, the copy
// inside it, and B * S blocks over the card (128 at B 16, where one block an image would work 16 SMs), each with a
// short chain: the fg row's load, one block scan, the searches, the rows' load.
// The backward reads g and idx and writes the dense dx: 35.8 MB in fp32 (17.9 in bf16), about 10.7 us (5.3). The
// inverse map pos, which this design writes in the forward and reads in the backward (B * A * 4 bytes each way),
// is not counted. No arithmetic to speak of: bytes bound both.
//
// C interface, bound with ctypes: launches on the caller's stream of the caller's device, allocates nothing, does
// not synchronise, and returns the first CUDA error, that of the launches included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // threads of a block, forward and backward
constexpr int kWarps = kThreads / 32;
constexpr int kWords = 2;                   // 32-entry words of fg a forward thread takes in a tile: 4 16-byte loads
constexpr int kTileWords = kThreads * kWords;
constexpr long long kTile = kTileWords * 32LL;  // fg entries a tile: 16,384
constexpr int kBatch = 4;                   // row pieces a thread loads before it stores any
constexpr long long kMaxBlocks = 132 * 64;  // a grid-stride grid: enough blocks to fill the card, no more
constexpr unsigned kFull = 0xffffffffu;

// the 4 bytes of w as 4 bits: bit j set where byte j is not 0
__device__ __forceinline__ uint32_t byte_flags(uint32_t w) {
  const uint32_t t = __vsetne4(w, 0u);  // 1 in each byte that is not 0
  return (t | t >> 7 | t >> 14 | t >> 21) & 0xfu;
}

// the position of m's r-th set bit (from 0), r < popc(m)
__device__ __forceinline__ int nth_set_bit(uint32_t m, int r) {
  int at = 0;
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    const int c = __popc(m & ((1u << width) - 1u));
    if (r >= c) {
      r -= c;
      m >>= width;
      at += width;
    }
  }
  return at;
}

// The flags of the fg row as 32-bit words in the row's 16-byte-aligned frame: entry e of the row is bit (e + head)
// of the frame, head = the row pointer's offset in its 16-byte piece; bits outside the row are 0. Reads thread t's
// kWords words of tile `tile`, its 16-byte pieces issued together; a piece that holds bytes outside the row (the
// row's first and last, where the row is not aligned) reads only the row's bytes, one at a time.
__device__ __forceinline__ void load_words(const uint8_t* __restrict__ frame, long long head, long long end,
                                           long long tile, uint32_t (&m)[kWords]) {
  constexpr int kPieces = kWords * 2;
  const long long first = (tile * kTileWords + static_cast<long long>(threadIdx.x) * kWords) * 2;  // piece index
  uint4 v[kPieces];
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const long long g = (first + j) * 16;
    v[j] = g >= head && g + 16 <= end ? __ldg(reinterpret_cast<const uint4*>(frame) + first + j)
                                      : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const long long g = (first + j) * 16;
    if ((g < head || g + 16 > end) && g + 16 > head && g < end) {  // a piece the row holds in part
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      for (int i = 0; i < 16; ++i)
        if (g + i >= head && g + i < end) w[i >> 2] |= static_cast<uint32_t>(__ldg(frame + g + i)) << (8 * (i & 3));
      v[j] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    uint32_t bits = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 p = v[2 * j + h];
      bits |= (byte_flags(p.x) | byte_flags(p.y) << 4 | byte_flags(p.z) << 8 | byte_flags(p.w) << 12) << (16 * h);
    }
    m[j] = bits;
  }
}

// v's exclusive prefix over the block's threads in thread order; *total gets the block's sum (every thread).
// warp_sums: kWarps ints of shared memory that no thread reads from the previous call on
__device__ __forceinline__ int block_exclusive_scan(int v, int* total, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = inc - v, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    sum += s;
  }
  *total = sum;
  return before;
}

// The last word w of [0, kTileWords) with key(w) <= q (key nondecreasing, key(0) <= q)
template <typename Key>
__device__ __forceinline__ int last_word_at_most(long long q, Key key) {
  int lo = 0, hi = kTileWords - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (key(mid) <= q) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// P: a piece of a row that a thread copies (uint4 on the 16-byte route, else one element's bits); ppr pieces a row,
// xs x's row stride in pieces
template <typename P>
__global__ void __launch_bounds__(kThreads) compact_forward(const P* __restrict__ x, long long xs, int ppr,
                                                            const uint8_t* __restrict__ fg, long long a, long long k,
                                                            long long share, long long slice, P* __restrict__ rows,
                                                            long long* __restrict__ idx, int* __restrict__ pos) {
  __shared__ uint32_t words[kTileWords];  // the tile's flags
  __shared__ int before[kTileWords];      // foreground entries of the row before each word
  __shared__ int anchor[kThreads];        // the row of each position of the chunk
  __shared__ int sums[2][kWarps];         // the block scan's warp totals: [0] the count pass, [1] the tiles
  const long long b = blockIdx.x, s = blockIdx.y;
  const uint8_t* row = fg + b * a;
  const long long head = static_cast<long long>(reinterpret_cast<uintptr_t>(row) & 15u);
  const uint8_t* frame = row - head;
  const long long end = head + a;  // the row's end in the frame
  const int tiles = static_cast<int>((end + kTile - 1) / kTile);
  const long long lo = s * share < k ? s * share : k, hi = lo + share < k ? lo + share : k;
  const long long p0 = s * slice < a ? s * slice : a, p1 = p0 + slice < a ? p0 + slice : a;
  int* p_out = pos + b * a;
  long long* i_out = idx + b * k;
  const int t = threadIdx.x;
  // foreground entries of the row; a row of one tile gets it from its scan below
  int nfg = 0;
  if (tiles > 1) {
    int count = 0;
    for (int tile = 0; tile < tiles; ++tile) {
      uint32_t m[kWords];
      load_words(frame, head, end, tile, m);
#pragma unroll
      for (int j = 0; j < kWords; ++j) count += __popc(m[j]);
    }
    block_exclusive_scan(count, &nfg, sums[0]);
  }
  // the share in chunks of kThreads positions (one chunk unless the share is longer); the first also writes pos
  for (long long c0 = lo; c0 == lo || c0 < hi; c0 += kThreads) {
    const long long p = c0 + t;  // this thread's position
    int mine = -1;               // its row
    int carry = 0;               // foreground entries before the tile
    for (int tile = 0; tile < tiles; ++tile) {
      uint32_t m[kWords];
      load_words(frame, head, end, tile, m);
      int count = 0;
#pragma unroll
      for (int j = 0; j < kWords; ++j) count += __popc(m[j]);
      int in_tile;
      int f = carry + block_exclusive_scan(count, &in_tile, sums[1]);
      if (tiles == 1) nfg = in_tile;
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        words[t * kWords + j] = m[j];
        before[t * kWords + j] = f;
        f += __popc(m[j]);
      }
      __syncthreads();
      const long long t0 = tile * kTile;  // the tile's first entry in the frame
      if (c0 == lo) {  // pos over the block's slice of A within the tile, coalesced
        const long long e0 = p0 > t0 - head ? p0 : t0 - head, e1 = p1 < t0 + kTile - head ? p1 : t0 + kTile - head;
        for (long long e = e0 + t; e < e1; e += kThreads) {
          const long long g = e + head - t0;
          const int w = static_cast<int>(g >> 5), i = static_cast<int>(g & 31);
          const uint32_t mw = words[w];
          const long long fb = before[w] + __popc(mw & ((1u << i) - 1u));  // foreground entries before e
          const long long q = (mw >> i) & 1u ? fb : nfg + (e - fb);
          p_out[e] = q < k ? static_cast<int>(q) : -1;
        }
      }
      if (p < hi) {  // this thread's position, if its row lies in the tile
        const long long bg0 = (t0 - head > 0 ? t0 - head : 0) - carry;  // other entries before the tile
        const long long in_end = (t0 + kTile - head < a ? t0 + kTile - head : a);
        const long long bg1 = in_end - carry - in_tile;                 // ... before the next tile
        if (p < nfg && p >= carry && p < carry + in_tile) {
          const int w = last_word_at_most(p, [&](int u) { return static_cast<long long>(before[u]); });
          mine = static_cast<int>(t0 + 32LL * w + nth_set_bit(words[w], static_cast<int>(p - before[w])) - head);
        } else if (p >= nfg && p - nfg >= bg0 && p - nfg < bg1) {
          const long long q = p - nfg;
          // other entries of the row before word u: the row's entries before it less its foreground ones
          auto others = [&](int u) {
            const long long e = t0 + 32LL * u - head;
            return (e < 0 ? 0 : e < a ? e : a) - before[u];
          };
          const int w = last_word_at_most(q, others);
          const long long e = t0 + 32LL * w - head;  // the word's first entry (negative in the row's first piece)
          const uint32_t valid = (e >= 0 ? kFull : kFull << -e) & (a - e >= 32 ? kFull : (1u << (a - e)) - 1u);
          mine = static_cast<int>(e + nth_set_bit(~words[w] & valid, static_cast<int>(q - others(w))));
        }
      }
      carry += in_tile;
      if (tile + 1 < tiles) __syncthreads();  // words and before are the next tile's
    }
    if (p < hi) {
      anchor[t] = mine;
      i_out[p] = mine;
    }
    __syncthreads();
    // the chunk's rows: piece i of the chunk is piece i % ppr of its row i / ppr
    const long long n = ((hi - c0 < kThreads ? hi - c0 : kThreads)) * ppr;
    P* out = rows + (b * k + c0) * ppr;
    for (long long i0 = t; i0 < n; i0 += kThreads * kBatch) {
      P v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const long long i = i0 + j * kThreads;
        if (i < n) {
          const long long r = i / ppr;
          v[j] = __ldg(x + (b * a + anchor[r]) * xs + (i - r * ppr));
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (i0 + j * kThreads < n) out[i0 + j * kThreads] = v[j];
    }
  }
}

// an empty kernel on the forward's grid: chip_smoke.py times it as the floor one launch costs
__global__ void __launch_bounds__(kThreads) compact_empty() {}

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

// the forward on (B, S) blocks, P a piece of a row (see compact_forward); xs and ppr in pieces
template <typename P>
cudaError_t forward(const void* x, long long xs, int ppr, const void* fg, long long b, long long a, long long k,
                    long long shares, void* rows, void* idx, void* pos, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(b), static_cast<unsigned>(shares));
  compact_forward<P><<<grid, kThreads, 0, st>>>(static_cast<const P*>(x), xs, ppr, static_cast<const uint8_t*>(fg), a,
                                                k, (k + shares - 1) / shares, (a + shares - 1) / shares,
                                                static_cast<P*>(rows), static_cast<long long*>(idx),
                                                static_cast<int*>(pos));
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

// shares: S, the blocks an image (ops/loss_kernels.py compact_rows_shares), 1 to 65,535
extern "C" int compact_rows_forward(const void* x, long long x_rs, long long b, long long a, int cols, int es, int vec,
                                    const void* fg, long long k, long long shares, void* rows, void* idx, void* pos,
                                    int device, void* stream) {
  if (!valid_shapes(b, a, k, cols, es) || x_rs < cols || shares < 1 || shares > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_bytes = cols * es;
  if (vec && (row_bytes % 16 != 0 || !aligned(x, 16) || (x_rs * es) % 16 != 0 || !aligned(rows, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);  // the wrapper's plan chose a route the layout refuses
  cudaError_t err = cudaSetDevice(device);  // nvcc's own runtime: its current device is not PyTorch's
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || a == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) return static_cast<int>(forward<uint4>(x, x_rs * es / 16, row_bytes / 16, fg, b, a, k, shares, rows, idx,
                                                  pos, st));
  switch (es) {
    case 2: return static_cast<int>(forward<uint16_t>(x, x_rs, cols, fg, b, a, k, shares, rows, idx, pos, st));
    case 4: return static_cast<int>(forward<uint32_t>(x, x_rs, cols, fg, b, a, k, shares, rows, idx, pos, st));
    default:
      return static_cast<int>(forward<unsigned long long>(x, x_rs, cols, fg, b, a, k, shares, rows, idx, pos, st));
  }
}

// the empty kernel on the forward's grid of (b, shares) blocks: the floor of one launch, for timing
extern "C" int compact_rows_empty(long long b, long long shares, int device, void* stream) {
  if (b < 1 || b >= (1ll << 31) || shares < 1 || shares > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(b), static_cast<unsigned>(shares));
  compact_empty<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
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
