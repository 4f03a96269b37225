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
// Design: a block of 256 threads takes a row and reads it from HBM once, in 16-byte loads where the wrapper's plan
// allows (ops/loss_kernels.py `topk_rows_plan`: the route, and the values a thread holds), every load of a thread
// issued before the first is used, and holds it in registers. Values are ordered by order-preserving unsigned keys
// (NaN on top, -0.0 folded onto 0.0; 32 bits for fp32, 64 for fp64), but only the few that need one are converted.
// Then, never reading the row again:
//  1. a lower bound t0 of the row's k-th key (`threshold_t0`): the k-th largest of the threads' maxima as keys. k
//     threads hold a key >= t0, so the k-th key is >= t0;
//  2. the values above t0 (one compare each against t0's value, NaN counting as above) go to shared memory as keys
//     with their values and indices, a warp's slots taken by one atomic. Only the threads whose maximum is above t0
//     hold any, at most k - 1 of them, so at most (k - 1) * values a thread; a warp without such a thread skips it;
//  3. in the same pass, each thread whose maximum reaches t0 counts its values of key t0 in each load step, and one
//     scan of the counts (packed 11 bits a step) takes them across the block; then, after one barrier,
//  4. each key above t0 is ranked by a count over the others (key descending, index ascending) and written at its
//     rank if that is below k; if fewer than k lie above t0, the k-th key is t0 itself, and the values of key t0
//     fill the other slots in index order (the steps visit the row in index order) from the scan. Every value
//     written is the one read, so its bits (a NaN's payload, -0.0) are the input's.
// The scan takes rounds of 10 load steps, the fill going on round after round until the slots are full: a register
// tile on the vector route is one round (at most 9 steps), the scalar route's up to four.
// A row longer than the largest tile (9,216 values) is streamed (ITEMS 0: every pass loads its values again, from L2
// after the first), and where at least k keys lie above t0 it is raised to the k-th key itself, by a radix select
// over those keys in 11-bit digits with warp-aggregated histograms in shared memory (`radix_raise`): then fewer than
// k values lie above it, so the shared memory of step 2 does not grow with the row. A radix select over the whole
// row in place of step 1 took 2.3-2.7x the threshold's time on the register tiles at B 16, A 8,400 and 3.5x on a
// streamed row at A 33,600 on an H100 (PERF.md, PR 16).
// The launch depends only on the shapes, so a CUDA graph captures it; nothing is allocated and nothing read back.
//
// Bound on an H100 SXM at the train step's shapes (B 16, A 8,400; chip_smoke.py loss_tail_bound_ms): the rows
// are read once, 17.2 MB at M 32, 34.4 MB at M 64: about 5 and 10 us at 3.35 TB/s; the outputs (12 bytes an
// entry) are small.
//
// C interface, bound with ctypes: launches on the caller's stream of the caller's device, allocates nothing, does
// not synchronise, and returns the first CUDA error, that of the launch included.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // a block takes a row
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDigit = 11;  // a radix digit's bits
constexpr int kBins = 1 << kDigit;
constexpr int kPer = kBins / kThreads;  // bins a thread scans

template <typename T>
struct KeyType {
  using U = unsigned;
};
template <>
struct KeyType<double> {
  using U = unsigned long long;
};

// order-preserving keys: a larger number, a larger key; NaN above every number; -0.0 and 0.0 one key
__device__ __forceinline__ unsigned key_of(float v) {
  if (isnan(v)) return 0xffffffffu;
  const unsigned u = v == 0.0f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long key_of(double v) {
  if (isnan(v)) return ~0ull;
  const unsigned long long u = v == 0.0 ? 0ull : static_cast<unsigned long long>(__double_as_longlong(v));
  return (u >> 63) ? ~u : (u | (1ull << 63));
}

// the number a key stands for (not the NaN key)
__device__ __forceinline__ float value_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ double value_of(unsigned long long key) {
  return __longlong_as_double(static_cast<long long>((key >> 63) ? (key & ~(1ull << 63)) : ~key));
}

// the larger of a running maximum m and v, NaN winning (the key of any NaN is the top key)
__device__ __forceinline__ float max_nan(float m, float v) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), "f"(v));
  return r;
}

__device__ __forceinline__ double max_nan(double m, double v) { return (v > m || isnan(v)) ? v : m; }

template <typename T>
__device__ __forceinline__ T neg_inf();
template <>
__device__ __forceinline__ float neg_inf<float>() { return __uint_as_float(0xff800000u); }
template <>
__device__ __forceinline__ double neg_inf<double>() {
  return __longlong_as_double(static_cast<long long>(0xfff0000000000000ull));
}

// the V values of one load step
template <typename T, int V>
struct Step {
  T v[V];
};

// the block's row: each thread holding ITEMS values in registers (ITEMS 0: none, every pass loads its values again),
// in load steps of V consecutive values (V = 16 / sizeof(T) on the vector route, else 1): thread t's step s holds
// values (s * kThreads + t) * V + j, j < V, so the steps taken in order visit the row in index order.
// A place past the row's end holds -inf, which no maximum and no count of values above t0 takes for a value
template <typename T, int ITEMS, int V>
struct Row {
  static constexpr int kSteps = ITEMS / V;
  const T* __restrict__ p;
  int n, steps;  // steps: the load steps of a thread
  T val[ITEMS ? ITEMS : 1];

  __device__ __forceinline__ Row(const T* row, int n_) : p(row), n(n_) {
    steps = ITEMS ? kSteps : (n + kThreads * V - 1) / (kThreads * V);
  }

  __device__ __forceinline__ int index(int s, int j) const { return (s * kThreads + (int)threadIdx.x) * V + j; }

  // step s lies in the row (on the vector route n % V == 0: a step lies wholly in or out)
  __device__ __forceinline__ bool in(int s) const { return index(s, 0) < n; }

  // step s's values from the row, -inf past its end
  __device__ __forceinline__ Step<T, V> load(int s) const {
    Step<T, V> out;
    const bool live = in(s);
    if constexpr (V == 1) {
      out.v[0] = live ? __ldg(p + index(s, 0)) : neg_inf<T>();
    } else {
      uint4 u = make_uint4(0, 0, 0, 0);
      if (live) u = __ldg(reinterpret_cast<const uint4*>(p + index(s, 0)));
      const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) out.v[j] = live ? v[j] : neg_inf<T>();
    }
    return out;
  }

  // ITEMS > 0: the thread's share of the row into val[], every load issued before the first value is used
  __device__ __forceinline__ void fill() {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const Step<T, V> st = load(s);
#pragma unroll
      for (int j = 0; j < V; ++j) val[s * V + j] = st.v[j];
    }
  }

  // step s's values: from the registers (s a constant once the caller's loop is unrolled), or loaded again
  __device__ __forceinline__ Step<T, V> values(int s) const {
    if constexpr (ITEMS > 0) {
      Step<T, V> out;
#pragma unroll
      for (int j = 0; j < V; ++j) out.v[j] = val[s * V + j];
      return out;
    } else {
      return load(s);
    }
  }
};

// t0 on a register tile: the k-th largest of the threads' maxima (each thread's `mine`). The warp's maxima are sorted
// (a bitonic sort of the lanes) and ranked across the warps by searches in shared memory. k threads hold a key >= t0,
// so the row's k-th key is >= t0, and only the k - 1 threads whose maximum lies above t0 hold values above it
template <typename U>
__device__ __forceinline__ U threshold_t0(U mine, int k) {
  __shared__ U smax[kWarps][32];
  __shared__ U s_t0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  U m = mine;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {  // a bitonic sort of the warp's maxima, descending
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const U o = __shfl_xor_sync(kFull, m, stride);
      const bool keep_larger = ((lane & stride) == 0) == ((lane & size) == 0);
      m = keep_larger ? (o > m ? o : m) : (o < m ? o : m);
    }
  }
  smax[warp][lane] = m;
  __syncthreads();
  // the k-th of all lies among the first k of each list: candidate c (list c / k, place c % k) goes to thread c, so
  // the searches fill as few warps as they can. Its rank: its place in its list, and in each other list the entries
  // before it (larger keys; equal keys of a lower list), a prefix of the sorted list whose length five halvings and a
  // last look find; the lists' searches are independent, so their loads overlap
  if (threadIdx.x < kWarps * k) {
    const int w0 = threadIdx.x / k, place = threadIdx.x - w0 * k;
    const U me = smax[w0][place];
    int rank = place;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == w0) continue;
      const auto before = [&](U o) { return o > me || (o == me && w < w0); };
      int lo = 0;
#pragma unroll
      for (int half = 16; half > 0; half >>= 1) lo += before(smax[w][lo + half - 1]) ? half : 0;
      rank += lo + before(smax[w][lo]);
    }
    if (rank == k - 1) s_t0 = me;
  }
  __syncthreads();
  return s_t0;
}

// On a streamed row the values above `threshold_t0`'s t0 grow with the row (at most k - 1 threads hold them, but each
// holds a share that grows with it), so t0 is raised to the row's k-th key itself where at least k keys lie above
// it, by a radix select over the keys above t0, a digit of kDigit bits at a time from the top: the keys above t0
// that carry the prefix so far are counted by their next digit into a histogram in shared memory (the lanes of a
// warp with one digit added by one atomic of their leader), then a block scan over the bins, highest first, finds
// the bin that holds the left-th largest. Fewer than k keys above t0: the first pass's count shows it, and t0 stays.
// Only the threads whose maximum lies above t0 and carries the prefix load their share again (from L2), and a warp
// of none skips the pass. Afterwards fewer than k values lie above t0, whatever the row's length
template <typename T, int V, typename U>
__device__ __forceinline__ U radix_raise(const Row<T, 0, V>& r, U mine, int k, U t0) {
  constexpr int kKeyBits = 8 * sizeof(U);
  __shared__ unsigned hist[kBins];
  __shared__ unsigned s_warp[kWarps];
  __shared__ unsigned s_digit, s_left;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int top = kBins - 1 - (int)threadIdx.x * kPer;  // the thread's run of bins, highest first
#pragma unroll
  for (int i = 0; i < kPer; ++i) hist[top - i] = 0;
  __syncthreads();
  U prefix = 0, mask = 0;
  unsigned left = (unsigned)k;  // the keys the prefix still has to give
#pragma unroll
  for (int hi = kKeyBits; hi > 0; hi -= kDigit) {  // the digit: bits [lo, hi)
    const int lo = hi > kDigit ? hi - kDigit : 0;
    const unsigned dmask = (1u << (hi - lo)) - 1u;
    const bool may = mine > t0 && (mine & mask) >= prefix;
    if (__any_sync(kFull, may)) {
      for (int s = 0; s < r.steps; ++s) {
        Step<T, V> st{};
        if (may) st = r.load(s);
        const bool live = may && r.in(s);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const U key = key_of(st.v[j]);
          const bool take = live && key > t0 && (key & mask) == prefix;
          const unsigned act = __ballot_sync(kFull, take);
          if (take) {
            const unsigned d = (unsigned)(key >> lo) & dmask;
            const unsigned peers = __match_any_sync(act, d);
            if (lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
          }
        }
      }
    }
    __syncthreads();
    unsigned c[kPer], sum = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {  // read and clear the run for the next digit
      c[i] = hist[top - i];
      hist[top - i] = 0;
      sum += c[i];
    }
    unsigned incl = sum;  // inclusive scan over the threads, in thread order
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      incl += w < warp ? s_warp[w] : 0u;
      total += s_warp[w];
    }
    if (hi == kKeyBits && total < left) return t0;  // uniform: fewer than k keys above t0
    unsigned cum = incl - sum;  // keys in higher bins
    if (cum < left && left <= incl) {  // the one thread whose run reaches the left-th
      bool found = false;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (found) continue;
        if (cum + c[i] >= left) {
          s_digit = (unsigned)(top - i);
          s_left = left - cum;
          found = true;
        } else {
          cum += c[i];
        }
      }
    }
    __syncthreads();
    prefix |= (U)s_digit << lo;
    mask |= (U)dmask << lo;
    left = s_left;
  }
  return prefix;
}

// fp32 blocks on the vector route keep to 64 registers a thread, so 4 blocks share an SM: at M 32 (512 rows) one
// wave
template <typename T, int ITEMS, int V>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 && V > 1 ? 4 : 1)
    topk_select(const T* __restrict__ x, long long rs, int n, int k, int cap, T* __restrict__ vals,
                long long* __restrict__ idx) {
  using U = typename KeyType<T>::U;
  using R = Row<T, ITEMS, V>;
  constexpr U kNaN = ~U(0);  // the key of every NaN
  constexpr int kRound = 10, kFields = 5, kBits = 11;
  constexpr unsigned long long kField = (1ull << kBits) - 1;
  __shared__ unsigned long long wsum[2][2][kWarps];
  __shared__ int s_above;
  extern __shared__ __align__(16) unsigned char dyn[];
  U* above_key = reinterpret_cast<U*>(dyn);                 // cap keys above t0
  T* above_val = reinterpret_cast<T*>(above_key + cap);      // their values
  int* above_idx = reinterpret_cast<int*>(above_val + cap);  // and their indices
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = blockIdx.x;
  if (threadIdx.x == 0) s_above = 0;  // read after step 1's barriers
  R r(x + row * rs, n);
  if constexpr (ITEMS > 0) r.fill();
  const int steps = ITEMS ? R::kSteps : r.steps;

  // 1. t0, a lower bound of the row's k-th key: the thread's largest value (NaN winning) taken as a key, then
  // `threshold_t0`, on a streamed row raised by `radix_raise`
  T mv = neg_inf<T>();
#pragma unroll
  for (int s = 0; s < steps; ++s) {
    const Step<T, V> st = r.values(s);
#pragma unroll
    for (int j = 0; j < V; ++j) mv = max_nan(mv, st.v[j]);
  }
  const U mine = key_of(mv);
  U t0 = threshold_t0(mine, k);
  if constexpr (ITEMS == 0) {
    if (__syncthreads_or(mine > t0)) t0 = radix_raise(r, mine, k, t0);  // else no key lies above t0
  }
  const T t = t0 == kNaN ? T(0) : value_of(t0);  // the values above t0: !(v <= t), so NaN too

  // 2. the values above t0 (fewer than k; none if t0 is NaN's key) into shared memory, as keys with their values and
  // indices: only a thread whose maximum is above t0 holds any, so a warp without one skips the pass
  if (__any_sync(kFull, mine > t0)) {
#pragma unroll
    for (int s = 0; s < steps; ++s) {
      const Step<T, V> st = r.values(s);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const bool above = mine > t0 && !(st.v[j] <= t);
        const unsigned b = __ballot_sync(kFull, above);
        if (b) {
          const int leader = __ffs(b) - 1;
          int slot = 0;
          if (lane == leader) slot = atomicAdd(&s_above, __popc(b));
          slot = __shfl_sync(kFull, slot, leader) + __popc(b & ((1u << lane) - 1u));
          if (above) {
            above_key[slot] = key_of(st.v[j]);
            above_val[slot] = st.v[j];
            above_idx[slot] = r.index(s, j);
          }
        }
      }
    }
  }

  // 3 and 4 share their barriers. A round of kRound load steps counts the values of key t0 (v == t, or NaN for NaN's
  // key) of each thread in each step, 11 bits a step in two 64-bit words (a step's block-wide count is at most
  // kThreads * V = 1,024), and scans the counts across the block; only a thread whose maximum reaches t0 compares.
  // After the first round's barrier every key above t0 is in shared memory: each is ranked by a count over the
  // others (key descending, index ascending) and written at its rank if that is below k. If fewer than k lie above
  // t0, the k-th key is t0 itself, and the values of key t0 fill the other slots in index order (the steps visit
  // the row in index order), round after round until the slots are full (one round on the vector route's tiles)
  const bool nan0 = t0 == kNaN, holds = mine >= t0;
  const auto equal = [&](T v) { return nan0 ? isnan(v) : v == t; };
  T* out_v = vals + row * k;
  long long* out_i = idx + row * k;
  int n_above = 0, need = 0, base = 0;  // base: values of key t0 in the rounds before, block-wide
#pragma unroll
  for (int g = 0; g < steps; g += kRound) {
    Step<T, V> st[kRound];
    unsigned long long cnt[2] = {0, 0};
#pragma unroll
    for (int d = 0; d < kRound; ++d) {
      if (g + d >= steps) break;
      if (holds) {
        st[d] = r.values(g + d);
        int c = 0;
#pragma unroll
        for (int j = 0; j < V; ++j) c += r.in(g + d) && equal(st[d].v[j]);
        cnt[d / kFields] |= (unsigned long long)c << (kBits * (d % kFields));
      }
    }
    unsigned long long incl[2] = {cnt[0], cnt[1]};  // the warp's inclusive scan, then the warps' totals in order
    if (__any_sync(kFull, holds)) {  // else every count of the warp is 0
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned long long y = __shfl_up_sync(kFull, incl[h], o);
          if (lane >= o) incl[h] += y;
        }
      }
    }
    const int buf = (g / kRound) & 1;  // two buffers: the next round writes the other before its barrier
    if (lane == 31) {
      wsum[buf][0][warp] = incl[0];
      wsum[buf][1][warp] = incl[1];
    }
    __syncthreads();
    if (g == 0) {
      n_above = s_above;
      need = k - n_above;
      for (int e = threadIdx.x; e < n_above; e += kThreads) {
        const U ke = above_key[e];
        const int ie = above_idx[e];
        int rank = 0;
        for (int q = 0; q < n_above; ++q) {
          const U kq = above_key[q];
          rank += kq > ke || (kq == ke && above_idx[q] < ie);
        }
        if (rank < k) {
          out_v[rank] = above_val[e];
          out_i[rank] = ie;
        }
      }
    }
    if (base >= need) break;  // uniform across the block
    if (!holds && g + kRound >= steps) break;  // the last round: no barrier follows, and the thread fills no slot
    unsigned long long before[2] = {incl[0] - cnt[0], incl[1] - cnt[1]}, total[2] = {0, 0};
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned long long c = wsum[buf][h][w];
        before[h] += w < warp ? c : 0;
        total[h] += c;
      }
    }
#pragma unroll
    for (int d = 0; d < kRound; ++d) {
      if (g + d >= steps) break;
      const int shift = kBits * (d % kFields);
      int pos = base + (int)((before[d / kFields] >> shift) & kField);  // the thread's first slot in this step
      if (holds && ((cnt[d / kFields] >> shift) & kField) && pos < need) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (!equal(st[d].v[j])) continue;
          if (pos < need) {
            out_v[n_above + pos] = st[d].v[j];
            out_i[n_above + pos] = r.index(g + d, j);
          }
          ++pos;
        }
      }
      base += (int)((total[d / kFields] >> shift) & kField);
    }
    if (base >= need) break;
  }
}

struct Launch {
  const void* x;
  long long rs, rows;
  int n, k, items;
  void* vals;
  void* idx;
};

template <typename T, int ITEMS, int V>
cudaError_t launch_config(const Launch& a, cudaStream_t st) {
  using U = typename KeyType<T>::U;
  const int cap = (a.k - 1) * (ITEMS ? ITEMS : 1);  // the values above t0, at most: 31 * 36 * 20 bytes below 48 KB
  const size_t bytes = (size_t)cap * (sizeof(U) + sizeof(T) + sizeof(int));
  topk_select<T, ITEMS, V><<<(unsigned)a.rows, kThreads, bytes, st>>>(static_cast<const T*>(a.x), a.rs, a.n, a.k, cap,
                                                                      static_cast<T*>(a.vals),
                                                                      static_cast<long long*>(a.idx));
  return cudaGetLastError();
}

// the plan's values a thread holds: ops/loss_kernels.py TOPK_ITEMS, and 0 to stream
template <typename T, int V>
cudaError_t launch_route(const Launch& a, cudaStream_t st) {
  switch (a.items) {
    case 0: return launch_config<T, 0, V>(a, st);
    case 12: return launch_config<T, 12, V>(a, st);
    case 36: return launch_config<T, 36, V>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const Launch& a, int vec, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (!vec) return launch_route<T, 1>(a, st);
  if (reinterpret_cast<uintptr_t>(a.x) % 16 != 0 || (a.rs * (long long)sizeof(T)) % 16 != 0 || a.n % kVec != 0)
    return cudaErrorMisalignedAddress;
  return launch_route<T, kVec>(a, st);
}

}  // namespace

// x_type: 0 fp32, 1 fp64; k is the output's width, min(k, n), at most 32; vec and items are the wrapper's plan
// (ops/loss_kernels.py topk_rows_plan): vec 1 for 16-byte loads (x and its row stride 16-byte aligned, n a multiple
// of the values a load carries), items the values a thread holds, 0 to stream a row longer than 256 * 36
extern "C" int topk_rows(const void* x, long long row_stride, long long rows, int n, int x_type, int k, int vec,
                         int items, void* vals, void* idx, int device, void* stream) {
  if (rows < 0 || rows >= (1ll << 31) || n < 0 || k < 0 || k > kMaxK || k > n || x_type < 0 || x_type > 1 ||
      (rows > 1 && row_stride < n) || (items > 0 && (long long)kThreads * items < n))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || k == 0) return 0;
  cudaError_t err = cudaSetDevice(device);  // nvcc's own runtime: its current device is not PyTorch's
  if (err != cudaSuccess) return static_cast<int>(err);
  const Launch a{x, row_stride, rows, n, k, items, vals, idx};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_type) {
    case 0: return static_cast<int>(launch_t<float>(a, vec, st));
    default: return static_cast<int>(launch_t<double>(a, vec, st));
  }
}

extern "C" const char* topk_rows_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
