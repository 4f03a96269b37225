// Candidate select + DFL decode for Hopper (sm_90a): steps 1-4 of nms_from_feats over the raw Detect maps (K3).
//
// Replaces the XLA ops of yololite_tpu/ops/nms.py:357 `nms_from_feats`,
// steps 1-4 (:409-494): the per-level sigmoid, max/argmax and gate, the
// per-level and merge `lax.top_k`, the candidates' box-logit gather
// (`ops/decode.py:44 take_rows_blocked`, a TPU workaround: here a direct
// read) and `ops/decode.py:76 dfl_expectation_mm`, and the anchors rebuilt
// from the index. Its plain version is ops/kernels.py `select_decode_plain`.
//
// Inputs: L per-level maps (B, H, W, 4R + nc), R = reg_max, of one dtype
// (fp32, bf16 or fp16), each read through its own pointer and element
// strides, so the NHWC views of NCHW outputs are read where they lie; the
// per-level strides in pixels; an optional (nc) bool class mask. Outputs,
// K = min(max_cand, N) rows per image, N = anchors (single-label) or
// anchors x nc (multi-label): vals (B, K) fp32, bidx (B, K) int64, cls
// (B, K) fp32, boxes and shifted (B, K, 4) fp32, valid (B, K) bool.
//
// What it computes, as the plain version does:
//   score  = sigmoid(logit) as torch computes it, 1 / (1 + expf(-x)) in fp32
//            (IEEE division, no fast math), rounded to bf16 or fp16 when the
//            plain version's sigmoid runs in that type (half with such maps);
//            masked classes score 0;
//   single-label: the max and first argmax over the classes, NaN first as
//            torch's amax/argmax; multi-label: every (anchor, class) entry
//            at flat index anchor * nc + class;
//   gate   = score > thr ? score : -1 (thr rounded to the score type by the
//            wrapper, as torch rounds a Python float it compares with);
//   top K  = the K largest gated scores, ties to the lowest index (lax.top_k,
//            the plain version's stable sort), -1 fillers included;
//   decode = each candidate's 4R box logits, per side the max m (NaN
//            propagating), e = expf(x - m), E = sum(e * j) / sum(e), with
//            the sums in the order of torch's CUDA sum over a row of R
//            (`row_sum`), so the boxes equal the plain version's bit for
//            bit; anchors (x + 0.5, y + 0.5) and the level's stride from the
//            index; boxes ((ax - l) s, (ay - t) s, (ax + r) s,
//            (ay + b) s), no FMA contraction; shifted = boxes + cls * 7680
//            (+ 0 with agnostic); valid = val > max(conf, 0) (also rounded).
//
// Design: kernels on the caller's stream, no host sync, every buffer in one
// workspace that the wrapper allocates with torch; the level descriptors
// travel by value in the launches' parameters. One of three routes, picked on
// the host from the shapes alone (`plan`, reported by select_decode_plan;
// select_decode_pick runs a named one, for timing and the card tests):
//
// finish (a row of N <= kFinishCap entries: predict's 8,400 anchors, any
//   single-label row at 640 and below): two launches.
//   score:   one pass over the class logits (below), writing each entry's
//            32-bit order key of its gated score (and, single-label, the
//            argmax class) and counting the keys' top 11 bits in a
//            shared-memory histogram (warp-aggregated with __match_any_sync:
//            ties are the rule at low conf), added into a per-image
//            histogram in device memory after a memset;
//   finish:  `reps` CTAs an image (the card's SMs over B, at most 8), each
//            reading the image's key row into shared memory and selecting on
//            its own (the same answer in each): a radix select over the
//            composite (key << ib) | (N - 1 - index) in 11-bit digits, all in
//            shared memory (all composites differ, so it ends on exactly K
//            entries, the lowest indices winning ties), the K winners
//            collected and bitonic-sorted in shared memory, then each CTA
//            decodes every reps-th winner, a thread a (candidate, side).
// cluster (longer rows with K <= kClusterMaxK: val's and the EMA val's
//   multi-label rows of 400,000-670,000 entries at K 8,192; not NCHW planes
//   whose candidates are a quarter of the anchors or more, which the passes
//   route's dense decode reads coalesced): two launches.
//   score:   as above;
//   select:  one thread-block cluster of C CTAs of 1,024 threads an image, C
//            the largest size of which the card runs all B clusters at once
//            (cudaOccupancyMaxActiveClusters; `cluster_for`, as K4's). Each
//            CTA reads its slice of the key row once and lists, in row order
//            in its shared memory, the composites above the first digit's bin
//            b0 of the K-th entry and those in it; the CTAs exchange their
//            counts through distributed shared memory (DSMEM), and
//            barrier.cluster takes the place of a kernel boundary. Where b0
//            holds one key (the -1 fillers when fewer than K entries pass the
//            gate) and the row lies in index order, its winners are its lowest
//            indices, found by a prefix count of the CTAs' ties, with no radix
//            pass; else, while the entries at or above the decided bits number
//            more than K + slack, a later digit from per-CTA histograms of the
//            listed ties summed through DSMEM. Those entries are put in order
//            by one more digit (buckets summed through DSMEM, each bucket's
//            entries sent to the one CTA that holds it, each one's place its
//            count of larger ones there, or, where those counts would cost
//            more than sorting the CTA's slots (keys that many entries share),
//            its place in the CTA's sorted slots: a bitonic network, so the
//            step is at most O(n log^2 n) whatever the keys' ties); the places
//            below K are the rows, and each CTA decodes its
//            rows from each candidate's own box logits, 8 lanes a row. A CTA
//            whose tie list overflows reads its key slice again for each later
//            digit (at most ceil((21 + ib) / 11): four for val's rows) and
//            once to collect, inside the one kernel: correct, only slower.
// passes (K past the cluster route's capacity, those NCHW planes and those
//   batches): the memset, then
//   score:   as above, and the last CTA of an image (`last_to_arrive`) finds
//            the bin that holds the K-th largest entry;
//   select:  a pass per later digit (`hist`), each skipped once its image is
//            decided. After the first digit, an image whose entries at or
//            above the K-th entry's bin number at most N / 4 lists their
//            composites (`compact`): the later passes and the collection
//            read that list, not the key row;
//   collect: every entry with composite >= the threshold into a K-slot list
//            (warp-aggregated atomics);
//   sort:    the K composites descending: a bitonic sort of each chunk of
//            1,024 by a CTA (shuffles within a warp, shared memory past it),
//            then each entry's rank from its place in its chunk and a binary
//            search in every other chunk (all composites differ), written to
//            that rank: any K, a CTA for each chunk of each image;
//   decode:  one thread per (candidate, side): the side's distance and box
//            coordinate, and the candidate's other outputs. The distances
//            come from a dense pass over every (anchor, side) (`dfl_all`) when
//            K >= A / 4, else from the candidate's own R logits of the side
//            (at reg_max 16 the loads unrolled into registers).
// The score pass reads the class logits in the order they lie: multi-label,
// one thread an entry with anchors along the threads for NCHW planes (in a
// class-major order of the row), one thread a 16-byte run of an anchor's
// classes for channel-contiguous maps (the row's own order); single-label,
// one thread V neighbouring anchors of an NCHW plane, each class's V logits in
// one 16-byte load (`score_plane`: predict's fp32 maps), or one thread an
// anchor looping over its classes, 16 bytes at a time where they lie
// contiguous and aligned (`score_anchor_vec`: the bf16 maps); each thread
// issues the loads of several classes before their compare chains.
//
// Bound on an H100 SXM (chip_smoke.py k3_bound_ms): the function reads each
// class logit once, the 4R box logits of each distinct candidate anchor and
// writes 49 bytes per candidate: at predict's B 32 fp32 (640 x 640) some 86
// MB of class logits, 27 us at 3.35 TB/s. The score pass also writes the keys
// (4 bytes an entry) and, single-label, the classes, which the finish and
// cluster routes read once more; the passes route reads them again per digit
// where the list would be long; a candidate's box logits in NCHW planes are
// 64 separate sectors (PERF.md; tools/k3_profile.py splits the time by kernel).
//
// C interface, bound with ctypes (pointers and the stream are void*, ints are
// int): launches on the caller's stream of the caller's device, allocates
// nothing, does not synchronise, and returns the first CUDA error, that of
// the launches included.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "dfl_math.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kDigit = 11;             // bits a radix pass decides
constexpr int kBins = 1 << kDigit;     // histogram bins a pass
constexpr int kThreads = 256;          // threads of the streaming kernels
constexpr int kPerCtaRow = 4096;       // entries a CTA of the key passes takes
constexpr int kPerCtaAnchor = 256;     // anchors a CTA of the single-label score pass takes: one a thread
constexpr int kMaxLevels = 16;         // level descriptors the launches' parameters carry
constexpr int kChunk = 1024;           // candidates a CTA of the sort orders
constexpr int kFinishThreads = 512;    // threads of a finishing CTA
constexpr int kFinishCap = 16384;      // entries of a row the finish route holds in shared memory
constexpr int kMaxReps = 8;            // finishing CTAs an image, at most
constexpr int kMaxSmem = 232448;       // shared memory a block can have on Hopper
constexpr unsigned kFull = 0xffffffffu;

struct Level {
  const void* ptr;           // the level's (B, H, W, C) map
  long long sb, sh, sw, sc;  // its element strides
  int h, w;
  int off;                   // its first anchor in the image's anchor order
  float stride;              // its stride in pixels
};

struct Image {                // one image's select state (the passes route), zeroed by a memset
  unsigned long long prefix;  // the composite's bits decided so far (the threshold once done)
  unsigned int taken;         // entries taken above the decided prefix (K - taken still to take)
  unsigned int done;          // 1 once the threshold is final
  unsigned int count;         // entries collected
  unsigned int compact;       // 1 when the passes after the first read the compacted list, not the key row
  unsigned int listed;        // entries in the compacted list
  unsigned int arrived;       // CTAs of the running pass that have added their histogram
};

struct Params {
  Level levels[kMaxLevels];
  int n_levels;
  int map_type;    // 0 fp32, 1 bf16, 2 fp16
  int score_type;  // the type the sigmoid rounds to, the same codes
  int b, nc, reg_max, ml, k, p2;
  int a;           // anchors an image
  int n;           // entries an image's row holds (< 2^31)
  int ib;          // bits of an entry's index in the composite
  int total_bits;  // 32 + ib
  int class_major; // row storage: level, class, anchor (else the flat index order)
  float thr, valid_thr;
  const uint8_t* mask;
  int agnostic;
  uint32_t* keys;          // (B, N)
  int32_t* cls_of;         // (B, A) single-label argmax
  float* dist;             // (B, A, 4) every anchor's DFL distances, when `dense`
  int dense;               // decode every anchor once (K >= A / 4), else each candidate (the passes route)
  int box_vec;             // every level's box logits contiguous and on 16 bytes (the cluster route's 16-byte loads)
  int passes;              // the passes route (else finish): the score pass's last CTA of an image selects
  Image* img;              // (B)
  uint32_t* hist;          // (B, kBins)
  unsigned long long* cand;  // (B, P2): the collected composites, then sorted chunk by chunk
  unsigned long long* sorted;  // (B, K): the composites in order
  unsigned long long* list;  // (B, list_cap): the composites at or above the first digit's bin
  int list_cap;              // N / 4: a longer list is not made (the passes read the key row)
  float* vals;
  long long* bidx;
  float* cls;
  float* boxes;
  float* shifted;
  uint8_t* valid;
};

__device__ __forceinline__ float load_map(const Level& L, int type, long long o) {
  if (type == 0) return static_cast<const float*>(L.ptr)[o];
  if (type == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(L.ptr)[o]);
  return __half2float(static_cast<const __half*>(L.ptr)[o]);
}

__device__ __forceinline__ long long offset_of(const Level& L, int b, int y, int x, int c) {
  return b * L.sb + y * L.sh + x * L.sw + c * L.sc;
}

// torch's CUDA sigmoid: one / (one + std::exp(-x)) in fp32 (the correctly rounded reciprocal is that IEEE quotient),
// rounded to the output type
__device__ __forceinline__ float torch_sigmoid(float x, int score_type) {
  const float s = __frcp_rn(__fadd_rn(1.0f, expf(-x)));
  if (score_type == 1) return __bfloat162float(__float2bfloat16_rn(s));
  if (score_type == 2) return __half2float(__float2half_rn(s));
  return s;
}

// a monotone map of floats to uint32 (larger float, larger key), and back
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ int level_of_anchor(const Params& P, int a) {
  int l = 0;
  while (l + 1 < P.n_levels && a >= P.levels[l + 1].off) ++l;
  return l;
}

// the level, class and anchor within the level of the entry stored at position p of an image's class-major row
__device__ __forceinline__ int class_major_entry(const Params& P, int p, int* c, int* local) {
  int l = 0;
  while (l + 1 < P.n_levels && p >= P.levels[l + 1].off * P.nc) ++l;
  const Level& L = P.levels[l];
  const int hw = L.h * L.w, q = p - L.off * P.nc;
  *c = q / hw;
  *local = q - *c * hw;
  return l;
}

// the flat index (anchor * nc + class, or the anchor) of the entry stored at position p of an image's row
__device__ __forceinline__ int flat_index(const Params& P, int p) {
  if (!P.class_major) return p;
  int c, local;
  const int l = class_major_entry(P, p, &c, &local);
  return (P.levels[l].off + local) * P.nc + c;
}

__device__ __forceinline__ unsigned long long composite(const Params& P, uint32_t key, int i) {
  return ((unsigned long long)key << P.ib) | (unsigned long long)(P.n - 1 - i);
}

// one count per lane into a shared-memory histogram, lanes with the same bin added by one of them;
// bin < 0 counts nothing. Every lane of the warp calls it.
__device__ __forceinline__ void count_bin(uint32_t* s_hist, int bin) {
  const unsigned peers = __match_any_sync(kFull, bin);
  if (bin >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&s_hist[bin], __popc(peers));
}

__device__ __forceinline__ void zero_shared(uint32_t* s, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = 0;
}

__device__ __forceinline__ void flush_hist(const uint32_t* s_hist, uint32_t* g_hist, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (s_hist[i]) atomicAdd(&g_hist[i], s_hist[i]);
}

// gated score of an entry, from its score
__device__ __forceinline__ float gate(const Params& P, float s) { return s > P.thr ? s : -1.0f; }

// the composite bits [lo, hi) of pass `pass`: bits above hi are decided
__device__ __forceinline__ void pass_bits(const Params& P, int pass, int* hi, int* lo) {
  *hi = P.total_bits - pass * kDigit;
  *lo = max(*hi - kDigit, 0);
}

// whether this CTA is the last of its pass for image b to have added its histogram; the last one resets the count
// for the next pass. Every thread of the CTA calls it.
__device__ __forceinline__ bool last_to_arrive(Image* im) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(&im->arrived, 1u) == gridDim.x - 1;
    if (s_last) im->arrived = 0;
  }
  __syncthreads();
  return s_last;
}

// run by the last CTA of a pass for image b (every CTA's histogram added): the histogram into shared memory s_h
// (and cleaned in device memory for the next pass); each thread sums a run of bins, the highest first, a block scan
// finds the one thread whose run holds the need-th largest entry, and it decides the prefix; after the first pass it
// also decides whether the image is compacted
__device__ void select_bin(const Params& P, int b, int pass, uint32_t* s_h) {
  __shared__ unsigned s_warp[kThreads / 32];
  Image* im = P.img + b;
  __threadfence();
  if (im->done) return;
  const unsigned need = (unsigned)P.k - im->taken;  // read before the one thread that finds the bin changes it
  int hi, lo;
  pass_bits(P, pass, &hi, &lo);
  const int nb = 1 << (hi - lo);
  uint32_t* h = P.hist + (size_t)b * kBins;
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    s_h[i] = __ldcg(h + i);
    h[i] = 0;
  }
  __syncthreads();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (nb + kThreads - 1) / kThreads;  // bins a thread sums, thread 0 the highest
  const int top = nb - 1 - t * per;
  unsigned sum = 0;
  for (int j = 0; j < per; ++j)
    if (top - j >= 0) sum += s_h[top - j];
  unsigned incl = sum;  // inclusive scan over the threads, in thread order
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += s_warp[w];
  if (incl - sum < need && need <= incl) {  // the first thread whose run reaches need: one exactly
    unsigned cum = incl - sum;  // entries in higher bins
    int bin = top;
    for (int j = 0; j < per; ++j) {
      bin = top - j;
      if (cum + s_h[bin] >= need) break;
      cum += s_h[bin];
    }
    const unsigned left = need - cum;
    im->prefix |= (unsigned long long)bin << lo;
    im->taken = (unsigned)P.k - left;
    if (s_h[bin] == left || lo == 0)
      im->done = 1;  // every entry of the bin is taken: the threshold is the prefix
    else if (pass == 0 && cum + s_h[bin] <= (unsigned)P.list_cap)
      im->compact = 1;  // the entries at or above this bin, few enough to list
  }
}

// The score pass's end for one CTA: its histogram of the keys' top digit added into the image's; on the passes
// route the image's last CTA then selects the first digit's bin (the finish route's finishing CTAs do that)
__device__ __forceinline__ void score_done(const Params& P, uint32_t* s_hist) {
  const int b = blockIdx.y;
  __syncthreads();
  flush_hist(s_hist, P.hist + (size_t)b * kBins, kBins);
  if (P.passes && last_to_arrive(P.img + b)) select_bin(P, b, 0, s_hist);
}

__device__ __forceinline__ bool masked_class(const Params& P, int c) { return P.mask && !P.mask[c]; }

// The max and first argmax of an anchor's class scores, as torch's amax / argmax of where(mask, sigmoid(x), 0)
// (NaN first), fed the logits class by class. The score function torch_sigmoid is monotone non-decreasing over
// every fp32 (`sigmoid_monotone_check`, run by the card tests; rounding to bf16 or fp16 keeps it so), so the pass
// computes no sigmoid: it keeps the kTop (2 or 3) largest logits (ties in the order of the classes), and then max
// f(x_c) = f(m0), and a class ties it only if its logit is at least the smallest with that score: where the last
// kept logit scores below f(m0) the ties are among the kept ones, the first of them wins; else (a tie reaching below
// them, rare) the classes before the first tie found are scored again, in order.
template <int kTop>
struct ClassMax {
  float best, m0, m1, m2;
  int arg, i0, i1, i2, n, nan_i, zero_i;

  __device__ __forceinline__ ClassMax() {
    best = 0.0f;
    arg = 0;
    m0 = m1 = m2 = 0.0f;
    i0 = i1 = i2 = 0;
    n = 0;
    nan_i = zero_i = -1;
  }

  __device__ __forceinline__ void add(const Params& P, float x, int c, bool masked) {
    if (masked) {
      if (zero_i < 0) zero_i = c;
    } else if (isnan(x)) {
      if (nan_i < 0) nan_i = c;
    } else if (n < kTop || x > (kTop == 3 ? m2 : m1)) {  // into the kept ones, after every one at least as large
      if (n < 1 || x > m0) {
        if (kTop == 3) {
          m2 = m1;
          i2 = i1;
        }
        m1 = m0; i1 = i0;
        m0 = x; i0 = c;
      } else if (n < 2 || x > m1) {
        if (kTop == 3) {
          m2 = m1;
          i2 = i1;
        }
        m1 = x; i1 = c;
      } else {
        m2 = x; i2 = c;
      }
      n = min(n + 1, kTop);
    }
  }

  // best and arg from what was added; first_tie(limit, best) scans the classes before `limit` again (their loads
  // several at a time) for the first unmasked one that scores best, or returns limit: the rescan of a tie that
  // reaches below every kept logit
  template <typename FirstTie>
  __device__ __forceinline__ void done(const Params& P, FirstTie first_tie) {
    if (nan_i >= 0) {  // a NaN score: the first one wins
      best = __int_as_float(0x7fffffff);
      arg = nan_i;
      return;
    }
    if (n == 0) {  // every class masked: all score 0
      best = 0.0f;
      arg = zero_i;
      return;
    }
    best = torch_sigmoid(m0, P.score_type);
    arg = i0;
    if (n >= 2 && torch_sigmoid(m1, P.score_type) == best) {
      arg = min(i0, i1);
      if (n >= kTop && (kTop == 2 || torch_sigmoid(m2, P.score_type) == best))  // may reach further down: scan
        arg = min(arg, first_tie(arg, best));
    }
    if (best == 0.0f && zero_i >= 0 && zero_i < arg) arg = zero_i;  // a masked class's 0 ties a score of 0
  }
};

// the logits ClassMax keeps (2 or 3): an fp32 score's ties are rare (logits a few ulps apart), a bf16 or fp16 one's
// coarse rounding ties neighbouring logits often (near 1, logits a few tenths apart): a third kept logit spares
// most of their rescans
template <typename T>
struct TopOf {
  static constexpr int value = sizeof(T) == 4 ? 2 : 3;
};

// single-label: one thread an anchor, the classes in turn: key of the gated max, the argmax, digit 0
__global__ void __launch_bounds__(kThreads) score_anchor(const __grid_constant__ Params P) {
  __shared__ uint32_t s_hist[kBins];
  zero_shared(s_hist, kBins);
  __syncthreads();
  const int b = blockIdx.y;
  const int shift = 32 - kDigit;
  const int start = blockIdx.x * kPerCtaAnchor;
  const int end = min(start + kPerCtaAnchor, P.a);
  const int c0 = 4 * P.reg_max;
  for (int base = start; base < end; base += kThreads) {
    const int a = base + threadIdx.x;
    int bin = -1;
    if (a < end) {
      const Level& L = P.levels[level_of_anchor(P, a)];
      const int local = a - L.off, y = local / L.w, x = local - y * L.w;
      const long long o = offset_of(L, b, y, x, c0);
      ClassMax<3> cm;
#pragma unroll 8
      for (int c = 0; c < P.nc; ++c) cm.add(P, load_map(L, P.map_type, o + c * L.sc), c, masked_class(P, c));
      cm.done(P, [&](int limit, float best) {
        for (int c0 = 0; c0 < limit; c0 += 8) {
          float x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) x[u] = c0 + u < limit ? load_map(L, P.map_type, o + (c0 + u) * L.sc) : 0.0f;
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (c0 + u < limit && !masked_class(P, c0 + u) && torch_sigmoid(x[u], P.score_type) == best) return c0 + u;
        }
        return limit;
      });
      const uint32_t key = order_key(gate(P, cm.best));
      P.keys[(size_t)b * P.n + a] = key;
      P.cls_of[(size_t)b * P.a + a] = cm.arg;
      bin = (int)(key >> shift);
    }
    count_bin(s_hist, bin);
  }
  score_done(P, s_hist);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// The single-label score passes' shape: 16-byte loads, four of them in flight a thread (of a channels-last row in
// score_anchor_vec, of four class planes in score_plane): four plane loads took fewer registers, so more threads an
// SM, than eight, and timed faster on predict's maps; two channels-last loads timed slower on the net's maps
constexpr int kLoadsAhead = 4;
constexpr int kPlaneBytes = 16;

// single-label over channel-contiguous maps whose class logits start on 16 bytes: one thread an anchor, its class
// logits read 16 bytes at a time, kLoadsAhead loads in flight (so each sector a warp fetches is used at once, not
// re-read after other warps have evicted it: thread-per-anchor scalar reads of such maps ran some 3x slower)
template <typename T>
__global__ void __launch_bounds__(kThreads) score_anchor_vec(const __grid_constant__ Params P) {
  constexpr int kPer = 16 / sizeof(T);  // logits a load
  __shared__ uint32_t s_hist[kBins];
  zero_shared(s_hist, kBins);
  __syncthreads();
  const int b = blockIdx.y;
  const int shift = 32 - kDigit;
  const int a = blockIdx.x * kThreads + threadIdx.x;
  int bin = -1;
  if (a < P.a) {
    const Level& L = P.levels[level_of_anchor(P, a)];
    const int local = a - L.off, y = local / L.w, x = local - y * L.w;
    const T* row = static_cast<const T*>(L.ptr) + offset_of(L, b, y, x, 4 * P.reg_max);
    ClassMax<TopOf<T>::value> cm;
    for (int v0 = 0; v0 < P.nc; v0 += kLoadsAhead * kPer) {
      uint4 raw[kLoadsAhead];
#pragma unroll
      for (int q = 0; q < kLoadsAhead; ++q)
        if (v0 + q * kPer < P.nc) raw[q] = __ldg(reinterpret_cast<const uint4*>(row + v0 + q * kPer));
#pragma unroll
      for (int q = 0; q < kLoadsAhead; ++q) {
        if (v0 + q * kPer >= P.nc) break;
        const T* vals = reinterpret_cast<const T*>(&raw[q]);
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int c = v0 + q * kPer + u;
          cm.add(P, to_float(vals[u]), c, masked_class(P, c));
        }
      }
    }
    cm.done(P, [&](int limit, float best) {
      for (int v0 = 0; v0 < limit; v0 += kLoadsAhead * kPer) {
        uint4 raw[kLoadsAhead];
#pragma unroll
        for (int q = 0; q < kLoadsAhead; ++q)
          if (v0 + q * kPer < limit) raw[q] = __ldg(reinterpret_cast<const uint4*>(row + v0 + q * kPer));
#pragma unroll
        for (int q = 0; q < kLoadsAhead; ++q) {
          const T* vals = reinterpret_cast<const T*>(&raw[q]);
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int c = v0 + q * kPer + u;
            if (c < limit && !masked_class(P, c) && torch_sigmoid(to_float(vals[u]), P.score_type) == best) return c;
          }
        }
      }
      return limit;
    });
    const uint32_t key = order_key(gate(P, cm.best));
    P.keys[(size_t)b * P.n + a] = key;
    P.cls_of[(size_t)b * P.a + a] = cm.arg;
    bin = (int)(key >> shift);
  }
  count_bin(s_hist, bin);
  score_done(P, s_hist);
}


// single-label over NCHW planes (each level's anchors contiguous in a class plane, in aligned runs of V anchors):
// one thread V = kPlaneBytes / sizeof(T) neighbouring anchors of one level, each class plane's V logits in one
// load, the loads of kLoadsAhead classes issued before their compare chains; the V keys and classes stored
// together. (One thread an anchor with 4-byte loads read predict's fp32 planes at about 1.5 TB/s.)
template <typename T>
__global__ void __launch_bounds__(kThreads) score_plane(const __grid_constant__ Params P) {
  constexpr int V = kPlaneBytes / sizeof(T);  // 4 or 8
  __shared__ uint32_t s_hist[kBins];
  zero_shared(s_hist, kBins);
  __syncthreads();
  const int b = blockIdx.y;
  const int shift = 32 - kDigit;
  const int a0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  uint32_t keys[V];
  const bool in = a0 < P.a;
  if (in) {
    const Level& L = P.levels[level_of_anchor(P, a0)];
    const T* base = static_cast<const T*>(L.ptr) + b * L.sb + (a0 - L.off) + 4 * P.reg_max * L.sc;
    ClassMax<TopOf<T>::value> cm[V];
    for (int c0 = 0; c0 < P.nc; c0 += kLoadsAhead) {
      uint4 raw[kLoadsAhead];
#pragma unroll
      for (int u = 0; u < kLoadsAhead; ++u)
        if (c0 + u < P.nc) raw[u] = __ldg(reinterpret_cast<const uint4*>(base + (long long)(c0 + u) * L.sc));
#pragma unroll
      for (int u = 0; u < kLoadsAhead; ++u) {
        const int c = c0 + u;
        if (c >= P.nc) break;
        const bool masked = masked_class(P, c);
        const T* vals = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int v = 0; v < V; ++v) cm[v].add(P, to_float(vals[v]), c, masked);
      }
    }
    int arg[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      cm[v].done(P, [&](int limit, float best) {
        for (int c0 = 0; c0 < limit; c0 += 8) {
          float x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) x[u] = c0 + u < limit ? to_float(base[(long long)(c0 + u) * L.sc + v]) : 0.0f;
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (c0 + u < limit && !masked_class(P, c0 + u) && torch_sigmoid(x[u], P.score_type) == best) return c0 + u;
        }
        return limit;
      });
      keys[v] = order_key(gate(P, cm[v].best));
      arg[v] = cm[v].arg;
    }
    uint4* kd = reinterpret_cast<uint4*>(P.keys + (size_t)b * P.n + a0);
    uint4* cd = reinterpret_cast<uint4*>(P.cls_of + (size_t)b * P.a + a0);
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      kd[q] = make_uint4(keys[4 * q], keys[4 * q + 1], keys[4 * q + 2], keys[4 * q + 3]);
      cd[q] = make_uint4(arg[4 * q], arg[4 * q + 1], arg[4 * q + 2], arg[4 * q + 3]);
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) count_bin(s_hist, in ? (int)(keys[v] >> shift) : -1);
  score_done(P, s_hist);
}

// whether torch_sigmoid (fp32) is monotone non-decreasing over every non-NaN float: the order keys from -inf's
// (0x007fffff) to +inf's (0xff800000), 4,096 consecutive ones a thread, each score compared with the one before
// (a thread's first with its predecessor's); any decrease sets *bad
__global__ void __launch_bounds__(256) sigmoid_monotone_check(unsigned* bad) {
  constexpr unsigned long long kLo = 0x007fffffull, kHi = 0xff800000ull;
  const unsigned long long start = kLo + (unsigned long long)(blockIdx.x * 256 + threadIdx.x) * 4096;
  if (start > kHi) return;
  float prev = torch_sigmoid(key_value((uint32_t)(start == kLo ? kLo : start - 1)), 0);
  bool ok = true;
  for (unsigned long long k = start; k < start + 4096 && k <= kHi; ++k) {
    const float s = torch_sigmoid(key_value((uint32_t)k), 0);
    ok &= !(s < prev);
    prev = s;
  }
  if (!ok) atomicOr(bad, 1u);
}

// multi-label: one thread an entry, in storage order: key of the gated score, digit 0
__global__ void __launch_bounds__(kThreads) score_entry(const __grid_constant__ Params P) {
  __shared__ uint32_t s_hist[kBins];
  zero_shared(s_hist, kBins);
  __syncthreads();
  const int b = blockIdx.y;
  const int shift = 32 - kDigit;
  const int start = blockIdx.x * kPerCtaRow;
  const int end = min(start + kPerCtaRow, P.n);
  const int c0 = 4 * P.reg_max;
  for (int base = start; base < end; base += kThreads) {
    const int p = base + threadIdx.x;
    int bin = -1;
    if (p < end) {
      int c, local, l;
      if (P.class_major) {
        l = class_major_entry(P, p, &c, &local);
      } else {
        const int a = p / P.nc;
        c = p - a * P.nc;
        l = level_of_anchor(P, a);
        local = a - P.levels[l].off;
      }
      const Level& L = P.levels[l];
      const int y = local / L.w, x = local - y * L.w;
      float s = torch_sigmoid(load_map(L, P.map_type, offset_of(L, b, y, x, c0 + c)), P.score_type);
      if (P.mask && !P.mask[c]) s = 0.0f;
      const uint32_t key = order_key(gate(P, s));
      P.keys[(size_t)b * P.n + p] = key;
      bin = (int)(key >> shift);
    }
    count_bin(s_hist, bin);
  }
  score_done(P, s_hist);
}

// multi-label over channel-contiguous maps whose class logits start on 16 bytes: one thread a 16-byte run of one
// anchor's class logits (the row's own order), its keys stored 16 bytes at a time
template <typename T>
__global__ void __launch_bounds__(kThreads) score_entry_vec(const __grid_constant__ Params P) {
  constexpr int kPer = 16 / sizeof(T);  // entries a load
  __shared__ uint32_t s_hist[kBins];
  zero_shared(s_hist, kBins);
  __syncthreads();
  const int b = blockIdx.y;
  const int shift = 32 - kDigit;
  const int start = blockIdx.x * kPerCtaRow;
  for (int base = start; base < start + kPerCtaRow; base += kThreads * kPer) {
    const int p = base + threadIdx.x * kPer;  // the run's first entry
    uint32_t keys[kPer];
    const bool in = p < P.n;
    if (in) {
      const int a = p / P.nc, c0 = p - a * P.nc;
      const Level& L = P.levels[level_of_anchor(P, a)];
      const int local = a - L.off, y = local / L.w, x = local - y * L.w;
      // evict-first: the class logits are read once, and the keys written here are read again (the cluster route's
      // listing, the passes) while they are still in L2
      const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(static_cast<const T*>(L.ptr) +
                                                             offset_of(L, b, y, x, 4 * P.reg_max + c0)));
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        float sc = torch_sigmoid(to_float(vals[u]), P.score_type);
        if (P.mask && !P.mask[c0 + u]) sc = 0.0f;
        keys[u] = order_key(gate(P, sc));
      }
      uint4* dst = reinterpret_cast<uint4*>(P.keys + (size_t)b * P.n + p);
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q)
        dst[q] = make_uint4(keys[4 * q], keys[4 * q + 1], keys[4 * q + 2], keys[4 * q + 3]);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) count_bin(s_hist, in ? (int)(keys[u] >> shift) : -1);
  }
  score_done(P, s_hist);
}

// a later radix pass: counts the digit of each entry (of the list, or the key row) whose decided bits match the
// prefix; the pass's last CTA selects
__global__ void __launch_bounds__(kThreads) hist_pass(const __grid_constant__ Params P, int pass) {
  __shared__ uint32_t s_hist[kBins];
  const int b = blockIdx.y;
  const Image im = P.img[b];
  if (im.done) return;  // decided: every CTA of the image returns, none selects
  const int n = im.compact ? (int)im.listed : P.n;
  const int start = blockIdx.x * kPerCtaRow;
  int hi, lo;
  pass_bits(P, pass, &hi, &lo);
  const int nb = 1 << (hi - lo);
  if (start < n) {  // (a CTA past the list only arrives)
    zero_shared(s_hist, nb);
    __syncthreads();
    const unsigned long long prefix_hi = im.prefix >> hi;
    const int end = min(start + kPerCtaRow, n);
    for (int base = start; base < end; base += kThreads) {
      const int p = base + threadIdx.x;
      int bin = -1;
      if (p < end) {
        const unsigned long long c = im.compact ? P.list[(size_t)b * P.list_cap + p]
                                                : composite(P, P.keys[(size_t)b * P.n + p], flat_index(P, p));
        if ((c >> hi) == prefix_hi) bin = (int)((c >> lo) & (unsigned long long)(nb - 1));
      }
      count_bin(s_hist, bin);
    }
    __syncthreads();
    flush_hist(s_hist, P.hist + (size_t)b * kBins, nb);
  }
  if (last_to_arrive(P.img + b)) select_bin(P, b, pass, s_hist);
}

// this warp's first slot of an append: the CTA's warps' counts get consecutive slots from *counter with one atomic
// a CTA (a warp a launch on the same counter serialised val's appends); every thread of the CTA calls it
__device__ __forceinline__ unsigned cta_slots(unsigned warp_count, unsigned* counter) {
  __shared__ unsigned s_cnt[kThreads / 32], s_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_cnt[warp] = warp_count;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const unsigned c = s_cnt[w];
      s_cnt[w] = total;
      total += c;
    }
    s_base = total ? atomicAdd(counter, total) : 0u;
  }
  __syncthreads();
  return s_base + s_cnt[warp];
}

constexpr int kIter = kPerCtaRow / kThreads;  // entries a thread of a row pass takes

// after the first pass, when the image is to be compacted: every entry at or above the K-th entry's first-digit
// bin (key >> 21 >= that bin) into the image's list, which the later passes and the collection read instead of the
// key row
__global__ void __launch_bounds__(kThreads) compact(const __grid_constant__ Params P) {
  const int b = blockIdx.y;
  const Image im = P.img[b];
  if (im.done || !im.compact) return;
  const uint32_t floor_bin = (uint32_t)(im.prefix >> (P.total_bits - kDigit));
  const int start = blockIdx.x * kPerCtaRow, lane = threadIdx.x & 31;
  uint32_t keys[kIter];
  unsigned masks[kIter], count = 0;
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    const int p = start + it * kThreads + threadIdx.x;
    keys[it] = p < P.n ? P.keys[(size_t)b * P.n + p] : 0u;
    masks[it] = __ballot_sync(kFull, p < P.n && (keys[it] >> (32 - kDigit)) >= floor_bin);
    count += __popc(masks[it]);
  }
  unsigned slot = cta_slots(count, &P.img[b].listed);
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    const unsigned m = masks[it];
    if ((m >> lane) & 1u) {
      const int p = start + it * kThreads + threadIdx.x;
      P.list[(size_t)b * P.list_cap + slot + __popc(m & ((1u << lane) - 1))] = composite(P, keys[it],
                                                                                       flat_index(P, p));
    }
    slot += __popc(m);
  }
}

// every entry at or above the threshold (from the list or the key row) into the image's K slots
__global__ void __launch_bounds__(kThreads) collect(const __grid_constant__ Params P) {
  const int b = blockIdx.y;
  const Image im = P.img[b];
  const int n = im.compact ? (int)im.listed : P.n;  // the compacted list, or the key row
  const int start = blockIdx.x * kPerCtaRow, lane = threadIdx.x & 31;
  unsigned long long c[kIter];
  unsigned masks[kIter], count = 0;
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    const int p = start + it * kThreads + threadIdx.x;
    c[it] = p >= n ? 0ull
                   : im.compact ? P.list[(size_t)b * P.list_cap + p]
                                : composite(P, P.keys[(size_t)b * P.n + p], flat_index(P, p));
    masks[it] = __ballot_sync(kFull, p < n && c[it] >= im.prefix);
    count += __popc(masks[it]);
  }
  unsigned slot = cta_slots(count, &P.img[b].count);
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    const unsigned m = masks[it];
    const unsigned at = slot + __popc(m & ((1u << lane) - 1));
    if (((m >> lane) & 1u) && at < (unsigned)P.k) P.cand[(size_t)b * P.p2 + at] = c[it];
    slot += __popc(m);
  }
}

// one CTA a chunk of 1,024 of an image's K composites: a bitonic sort, descending (the padding, 0, last), one entry a
// thread; partners within a warp exchange by shuffles, farther ones through shared memory
__global__ void __launch_bounds__(kChunk) sort_chunks(const __grid_constant__ Params P) {
  __shared__ unsigned long long s_c[kChunk];
  const int b = blockIdx.y, t = threadIdx.x;
  const int gi = blockIdx.x * kChunk + t;
  unsigned long long* g = P.cand + (size_t)b * P.p2;
  unsigned long long r = gi < P.k ? g[gi] : 0ull;
  for (int k = 2; k <= kChunk; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long o;
      if (j < 32) {
        o = __shfl_xor_sync(kFull, r, j);
      } else {
        s_c[t] = r;
        __syncthreads();
        o = s_c[t ^ j];
        __syncthreads();
      }
      const bool keep_max = ((t & j) == 0) == ((t & k) == 0);  // the lower index keeps the larger where descending
      r = keep_max ? (r > o ? r : o) : (r < o ? r : o);
    }
  }
  g[gi] = r;
}

// each entry's rank among the image's K: its place in its own sorted chunk plus, in every other chunk, the number
// of entries greater than it (a binary search: the chunks are descending and all composites differ); the entry is
// written to that rank of P.sorted
__global__ void __launch_bounds__(kChunk) rank_chunks(const __grid_constant__ Params P) {
  const int b = blockIdx.y, chunk = blockIdx.x, t = threadIdx.x;
  const unsigned long long* g = P.cand + (size_t)b * P.p2;
  const unsigned long long x = g[chunk * kChunk + t];
  if (x == 0ull) return;  // padding
  int rank = t;
  const int chunks = P.p2 / kChunk;
  for (int q = 0; q < chunks; ++q) {
    if (q == chunk) continue;
    const unsigned long long* c = g + (size_t)q * kChunk;
    int lo = 0, hi = kChunk;  // c[0, lo) > x >= c[hi, kChunk)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (c[mid] > x)
        lo = mid + 1;
      else
        hi = mid;
    }
    rank += lo;
  }
  P.sorted[(size_t)b * P.k + rank] = x;
}

// one side's DFL distance of the anchor whose box logits start at element o of level L: the side's max m (NaN
// propagating), e = expf(x - m), sum(e * j) / sum(e) with torch's summation order (csrc/dfl_math.cuh). RM is
// reg_max when it is known at compile time (16, every model the repo builds: the loads unrolled, in registers),
// else 0 (read from P)
template <int RM>
__device__ __forceinline__ float dfl_side(const Params& P, const Level& L, long long o, int side) {
  constexpr int kCap = RM ? RM : kMaxReg;
  const int R = RM ? RM : P.reg_max;
  float v[kCap], e[kCap];
#pragma unroll
  for (int j = 0; j < kCap; ++j) {
    if (j >= R) break;
    v[j] = load_map(L, P.map_type, o + (side * R + j) * L.sc);
  }
  const float z = dfl_side_exp_sum<RM>(v, e, R, dfl_side_max<RM>(v, R));
  return dfl_side_expectation<RM>(e, v, R, z);
}

// every anchor's DFL distances into P.dist, one thread an (anchor, side): neighbouring anchors on neighbouring
// thread groups, coalesced reads of NCHW planes
template <int RM>
__global__ void __launch_bounds__(128) dfl_all(const __grid_constant__ Params P) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int a = t >> 2, side = t & 3;
  if (a >= P.a) return;
  const Level& L = P.levels[level_of_anchor(P, a)];
  const int local = a - L.off, y = local / L.w, x = local - y * L.w;
  P.dist[((size_t)b * P.a + a) * 4 + side] = dfl_side<RM>(P, L, offset_of(L, b, y, x, 0), side);
}

// the outputs of row r of image b, whose composite is c, for one side: the side's DFL distance (read from P.dist
// when dense, else computed) and its box coordinate (x1 from the left distance, y1 the top, x2 the right, y2 the
// bottom); side 0 also writes the value, index, class and valid
template <int RM>
__device__ __forceinline__ void decode_side(const Params& P, int b, int r, int side, unsigned long long c) {
  const size_t row = (size_t)b * P.k + r;
  const uint32_t key = (uint32_t)(c >> P.ib);
  const int idx = P.n - 1 - (int)(c & ((1ull << P.ib) - 1));
  int a, cl;
  if (P.ml) {
    a = idx / P.nc;
    cl = idx - a * P.nc;
  } else {
    a = idx;
    cl = P.cls_of[(size_t)b * P.a + a];
  }
  const Level& L = P.levels[level_of_anchor(P, a)];
  const int local = a - L.off, y = local / L.w, x = local - y * L.w;
  const float d = P.dense ? P.dist[((size_t)b * P.a + a) * 4 + side]
                          : dfl_side<RM>(P, L, offset_of(L, b, y, x, 0), side);
  const float center = __fadd_rn((float)(side & 1 ? y : x), 0.5f);
  const float box = __fmul_rn(side < 2 ? __fsub_rn(center, d) : __fadd_rn(center, d), L.stride);
  const float fcl = (float)cl;
  P.boxes[row * 4 + side] = box;
  P.shifted[row * 4 + side] = __fadd_rn(box, P.agnostic ? 0.0f : __fmul_rn(fcl, 7680.0f));
  if (side == 0) {
    const float val = key_value(key);
    P.vals[row] = val;
    P.bidx[row] = a;
    P.cls[row] = fcl;
    P.valid[row] = val > P.valid_thr;
  }
}

// one thread a (candidate, side) of the sorted composites
template <int RM>
__global__ void __launch_bounds__(128) decode(const __grid_constant__ Params P) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = t >> 2;
  if (r >= P.k) return;
  decode_side<RM>(P, b, r, t & 3, P.sorted[(size_t)b * P.k + r]);
}

// ---------------- the finish route: select, sort and decode an image in shared memory ----------------

// the bin of the composites counted in s_hist (nb bins, the digit at bits [lo, lo + log2 nb)) that holds the
// *need-th largest of them: each of the CTA's kT threads sums a run of bins, the highest first, a block scan finds
// the one thread whose run holds it, and that thread adds the bin to *prefix, sets *need to what the bin still has
// to give and *done when every entry of the bin is taken (or the digit is the last). Every thread of the CTA calls
// it.
template <int kT>
__device__ void finish_bin(const uint32_t* s_hist, int nb, int lo, unsigned long long* prefix, unsigned* need,
                           unsigned* done) {
  __shared__ unsigned s_warp[kT / 32];
  const unsigned want = *need;  // read before the one thread that finds the bin changes it
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (nb + kT - 1) / kT;  // bins a thread sums, thread 0 the highest
  const int top = nb - 1 - t * per;
  unsigned sum = 0;
  for (int j = 0; j < per; ++j)
    if (top - j >= 0) sum += s_hist[top - j];
  unsigned incl = sum;  // inclusive scan over the threads, in thread order
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += s_warp[w];
  if (incl - sum < want && want <= incl) {  // the first thread whose run reaches need: one exactly
    unsigned cum = incl - sum;  // entries in higher bins
    int bin = top;
    for (int j = 0; j < per; ++j) {
      bin = top - j;
      if (cum + s_hist[bin] >= want) break;
      cum += s_hist[bin];
    }
    const unsigned left = want - cum;
    *prefix |= (unsigned long long)bin << lo;
    *need = left;
    *done = s_hist[bin] == left || lo == 0;
  }
  __syncthreads();
}

constexpr int kTieCap = 4096;   // entries of the K-th entry's first-digit bin a finishing CTA lists
constexpr int kRankCap = 2048;  // entries at or above that bin that the finishing CTAs rank directly

// `reps` CTAs an image (blockIdx.x = image * reps + rep). Each reads the first digit's counts (the keys' top 11
// bits, counted by the score pass) and finds the bin b0 of the K-th entry, and reads the image's key row into
// shared memory. Where the entries at or above b0 number more than kRankCap, it counts the next 11 bits of b0's
// entries and finds the K-th entry's bin b1 there. Then, where the candidates (the entries above b0, and b0's at or
// above b1) number at most kRankCap, the rank route: they are listed as composites, each CTA counts for each of
// its own (every rep-th position) how many listed ones are larger (four threads a candidate), and a candidate
// whose count r is below K is output row r, decoded by the same CTA: no sort. Otherwise the radix route: the
// entries above b0 are taken as winners and those in b0 (the ties of the first digit) listed, up to kTieCap of them
// (else the later passes scan the row); the later digits' radix passes run over the list; the list's entries at or
// above the threshold are taken; the K winners are bitonic-sorted in p2 = the power of two >= K slots; rows rep,
// rep + reps, ... are decoded. Either way a thread a (row, side) decodes.
template <int RM>
__global__ void __launch_bounds__(kFinishThreads, 1) finish(const __grid_constant__ Params P, int reps, int p2) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned long long s_prefix;
  __shared__ unsigned long long s_prefix1;
  __shared__ unsigned s_need, s_done, s_count, s_ties, s_rows_n, s_need1, s_done1;
  const int n = P.n, t = threadIdx.x, lane = t & 31;
  const int shift = 32 - kDigit;
  uint32_t* s_key = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_hist = s_key + ((n + 3) & ~3);
  unsigned long long* s_win = reinterpret_cast<unsigned long long*>(s_hist + kBins);
  uint16_t* s_tie = reinterpret_cast<uint16_t*>(s_win + p2);
  unsigned long long* s_cand = reinterpret_cast<unsigned long long*>(s_tie + kTieCap);
  const int b = blockIdx.x / reps, rep = blockIdx.x - b * reps;
  const uint32_t* keys = P.keys + (size_t)b * n;
  for (int i = t; i < kBins; i += kFinishThreads) s_hist[i] = __ldcg(P.hist + (size_t)b * kBins + i);
  if (t == 0) {
    s_prefix = 0;
    s_need = (unsigned)P.k;
    s_done = 0;
    s_count = 0;
    s_ties = 0;
    s_rows_n = 0;
  }
  __syncthreads();
  // the first digit, which the score pass counted
  finish_bin<kFinishThreads>(s_hist, kBins, P.total_bits - kDigit, &s_prefix, &s_need, &s_done);
  const int b0 = (int)(s_prefix >> (P.total_bits - kDigit));
  const int listed_all = P.k - (int)s_need + (int)s_hist[b0];  // the entries at or above b0
  // the key row into shared memory, 8 loads a thread in flight
  constexpr int kAhead = 8;
  for (int base = 0; base < n; base += kAhead * kFinishThreads) {
    uint32_t k8[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int p = base + u * kFinishThreads + t;
      k8[u] = p < n ? __ldcg(keys + p) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int p = base + u * kFinishThreads + t;
      if (p < n) s_key[p] = k8[u];
    }
  }
  __syncthreads();
  // where too many entries lie at or above b0 (scores that crowd one quarter binade), the second digit (the key's
  // bits 10-20) of b0's entries: those at or above its K-th entry's bin b1, with the entries above b0, are the
  // candidates
  int b1 = -1, listed = listed_all;
  if (listed_all > kRankCap) {
    zero_shared(s_hist, kBins);
    if (t == 0) {
      s_prefix1 = s_prefix;
      s_need1 = s_need;
      s_done1 = 0;
    }
    __syncthreads();
    for (int p = t; p < n; p += kFinishThreads)
      if ((int)(s_key[p] >> shift) == b0) atomicAdd(&s_hist[(s_key[p] >> 10) & (kBins - 1)], 1u);
    __syncthreads();
    finish_bin<kFinishThreads>(s_hist, kBins, P.total_bits - 2 * kDigit, &s_prefix1, &s_need1, &s_done1);
    b1 = (int)((s_prefix1 >> (P.total_bits - 2 * kDigit)) & (kBins - 1));
    listed = P.k - (int)s_need1 + (int)s_hist[b1];
  }
  const bool rank = listed <= kRankCap;
  if (rank) {  // the candidates listed as composites (in an order that differs from CTA to CTA), and this CTA's
               // own ones (those at positions rep, rep + reps, ...) by their slot in that list
    for (int base = 0; base < n; base += kFinishThreads) {
      const int p = base + t;
      const uint32_t key = p < n ? s_key[p] : 0u;
      const int bin = (int)(key >> shift);
      const bool in = p < n && (bin > b0 || (bin == b0 && (b1 < 0 || (int)((key >> 10) & (kBins - 1)) >= b1)));
      const bool own = in && p % reps == rep;
      const unsigned m = __ballot_sync(kFull, in), m_own = __ballot_sync(kFull, own);
      unsigned at = 0, at_own = 0;
      if (lane == 0 && m) at = atomicAdd(&s_count, (unsigned)__popc(m));
      if (lane == 0 && m_own) at_own = atomicAdd(&s_ties, (unsigned)__popc(m_own));
      at = __shfl_sync(kFull, at, 0);
      at_own = __shfl_sync(kFull, at_own, 0);
      const unsigned before = (1u << lane) - 1, slot = at + __popc(m & before);
      if (in) s_cand[slot] = composite(P, key, flat_index(P, p));
      if (own) s_tie[at_own + __popc(m_own & before)] = (uint16_t)slot;
    }
    __syncthreads();
  }
  if (rank) {  // the rank route: a candidate's count of larger ones is its output row
    uint16_t* s_rows = reinterpret_cast<uint16_t*>(s_hist);  // this CTA's rows (the histogram is done with)
    const int mine = (int)s_ties;
    for (int base = 0; base < mine; base += kFinishThreads / 4) {
      const int j = base + (t >> 2);
      const unsigned long long c = j < mine ? s_cand[s_tie[j]] : ~0ull;
      unsigned above = 0;
      for (int i = t & 3; i < listed; i += 4) above += s_cand[i] > c;
      above += __shfl_xor_sync(kFull, above, 1);
      above += __shfl_xor_sync(kFull, above, 2);
      if ((t & 3) == 0 && j < mine && above < (unsigned)P.k) {  // output row `above`
        s_win[above] = c;
        s_rows[atomicAdd(&s_rows_n, 1u)] = (uint16_t)above;
      }
    }
    __syncthreads();
    for (int q = t; q < 4 * (int)s_rows_n; q += kFinishThreads) {
      const int r = s_rows[q >> 2];
      decode_side<RM>(P, b, r, q & 3, s_win[r]);
    }
    return;
  }
  // the radix route: the winners above the K-th entry's bin into s_win, its bin's entries into the tie list
  for (int base = 0; base < n; base += kFinishThreads) {
    const int p = base + t;
    const int bin = p < n ? (int)(s_key[p] >> shift) : -1;
    const bool above = bin > b0, tie = bin == b0;
    const unsigned m_above = __ballot_sync(kFull, above), m_tie = __ballot_sync(kFull, tie);
    unsigned at = 0, at_tie = 0;
    if (lane == 0) {
      if (m_above) at = atomicAdd(&s_count, (unsigned)__popc(m_above));
      if (m_tie) at_tie = atomicAdd(&s_ties, (unsigned)__popc(m_tie));
    }
    at = __shfl_sync(kFull, at, 0);
    at_tie = __shfl_sync(kFull, at_tie, 0);
    const unsigned before = (1u << lane) - 1;
    if (above) s_win[at + __popc(m_above & before)] = composite(P, s_key[p], flat_index(P, p));
    const unsigned slot = at_tie + __popc(m_tie & before);
    if (tie && slot < kTieCap) s_tie[slot] = (uint16_t)p;
  }
  __syncthreads();
  const bool tie_listed = s_ties <= kTieCap;  // the later passes read the list, else the row
  const int span = tie_listed ? (int)s_ties : n;
  // the later digits over the entries of the tie bin whose decided bits match the prefix
  for (int pass = 1; !s_done; ++pass) {
    int hi, lo;
    pass_bits(P, pass, &hi, &lo);
    const int nb = 1 << (hi - lo);
    zero_shared(s_hist, nb);
    __syncthreads();
    const unsigned long long prefix_hi = s_prefix >> hi;
    for (int base = 0; base < span; base += kFinishThreads) {
      const int i = base + t;
      int bin = -1;
      if (i < span) {
        const int p = tie_listed ? s_tie[i] : i;
        const unsigned long long c = composite(P, s_key[p], flat_index(P, p));
        if ((c >> hi) == prefix_hi) bin = (int)((c >> lo) & (unsigned long long)(nb - 1));
      }
      count_bin(s_hist, bin);
    }
    __syncthreads();
    finish_bin<kFinishThreads>(s_hist, nb, lo, &s_prefix, &s_need, &s_done);
  }
  // the tie bin's entries at or above the threshold join the winners; the rest of s_win is padding
  const unsigned long long thr = s_prefix;
  for (int base = 0; base < span; base += kFinishThreads) {
    const int i = base + t;
    unsigned long long c = 0ull;
    if (i < span) {
      const int p = tie_listed ? s_tie[i] : i;
      if ((int)(s_key[p] >> shift) == b0) c = composite(P, s_key[p], flat_index(P, p));
    }
    const bool take = c != 0ull && c >= thr;
    const unsigned m = __ballot_sync(kFull, take);
    unsigned at = 0;
    if (lane == 0 && m) at = atomicAdd(&s_count, (unsigned)__popc(m));
    at = __shfl_sync(kFull, at, 0);
    if (take) s_win[at + __popc(m & ((1u << lane) - 1))] = c;
  }
  for (int i = P.k + t; i < p2; i += kFinishThreads) s_win[i] = 0ull;  // padding sorts last (every key > 0)
  __syncthreads();
  // bitonic sort, descending: the pair (i, i | j) of each step, the lower index keeping the larger where the
  // k-block is descending
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = t; q < p2 / 2; q += kFinishThreads) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const unsigned long long x = s_win[i], y = s_win[i | j];
        if ((x < y) == ((i & k) == 0)) {
          s_win[i] = y;
          s_win[i | j] = x;
        }
      }
      __syncthreads();
    }
  }
  const int rows = (P.k - rep + reps - 1) / reps;  // this CTA's rows: rep, rep + reps, ...
  for (int q = t; q < 4 * rows; q += kFinishThreads) {
    const int r = rep + (q >> 2) * reps;
    decode_side<RM>(P, b, r, q & 3, s_win[r]);
  }
}

// ---------------- the cluster route: an image's select, order and decode in one thread-block cluster ----------------

constexpr int kClusterThreads = 1024;                 // threads of a cluster CTA
constexpr int kMaxCluster = 16;                       // CTAs a cluster, at most (above 8: the non-portable size)
constexpr int kClusterMaxK = 8192;                    // candidates an image the cluster route takes, at most
constexpr int kKeysAThread = 8;                       // keys a thread reads a step of its slice: two 16-byte loads
constexpr int kSlack = 4096;                          // candidates past K the order may take (no more digit passes)
constexpr int kSortStepReads = 16;                    // a count's reads a thread that a step of the sort costs (H100)
constexpr int kTileKeys = kKeysAThread * kClusterThreads;  // keys a CTA reads a step
constexpr int kMaxDevices = 64;

typedef unsigned long long u64;

struct SliceCounts {     // a cluster CTA's counts after listing its slice, read by the others through DSMEM
  u64 top;               // the largest composite it listed (0 where none)
  u64 bottom;            // the least composite above b0's bin it listed (~0 where none)
  unsigned ties;         // entries in b0's bin
  unsigned tie_min;      // the least and greatest key in b0's bin (~0 and 0 where it has none)
  unsigned tie_max;
};

// exclusive scan of v over the CTA's threads in thread order; *total gets the sum. Every thread calls it.
__device__ __forceinline__ unsigned cta_scan(unsigned v, unsigned* s_warp, unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned x = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += x;
  }
  __syncthreads();  // every thread has read the previous call's s_warp
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned w = s_warp[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned x = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += x;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[31];
  return incl - v + (warp ? s_warp[warp - 1] : 0u);
}

// keys[p, p + 8) of an image's key row (those at or past `end` read as 0): two 16-byte loads where the row's
// length is a multiple of 4 (every slice then starts on 16 bytes), else one load a key
__device__ __forceinline__ void load_keys(const uint32_t* keys, int p, int end, bool vec, uint32_t* k) {
  if (vec && p + kKeysAThread <= end) {
#pragma unroll
    for (int q = 0; q < kKeysAThread / 4; ++q) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(keys + p) + q);
      k[4 * q] = a.x;
      k[4 * q + 1] = a.y;
      k[4 * q + 2] = a.z;
      k[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kKeysAThread; ++u) k[u] = p + u < end ? __ldg(keys + p + u) : 0u;
  }
}

// the slice [lo, hi) of an image's key row again, 8 keys a thread a step: f(k, p0) for the keys at p0 .. p0 + 7
// (past hi: 0). The path of a CTA whose tie list overflowed. Every thread calls it.
template <typename F>
__device__ __forceinline__ void each_key(const uint32_t* keys, int lo, int hi, bool vec, F f) {
  for (int base = lo; base < hi; base += kTileKeys) {
    uint32_t k[kKeysAThread];
    const int p0 = base + kKeysAThread * threadIdx.x;
    load_keys(keys, p0, hi, vec, k);
    f(k, p0);
  }
}

// s[0, n) in descending order, in place: a bitonic network whose every comparator puts the larger of its pair first
// (a merge's first stage pairs mirrored places, so that every stage sorts one way), over the 2^k >= n places; the
// places past n, which it never touches, act as the least values, so a comparator that reaches one is skipped. The
// composites all differ. Every thread calls it.
__device__ void sort_descending(u64* s, int n) {
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p2 >> 1; i += blockDim.x) {
        const int lo = i / stride * 2 * stride + i % stride;
        const int hi = stride == size >> 1 ? lo - i % stride + 2 * stride - 1 - i % stride : lo + stride;
        if (hi < n && s[lo] < s[hi]) {
          const u64 x = s[lo];
          s[lo] = s[hi];
          s[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// the composite c into the list s at the warp's next slots (*count the list's length); every lane calls it
__device__ __forceinline__ void append(u64* s, unsigned* count, bool take, u64 c) {
  const unsigned m = __ballot_sync(kFull, take);
  const int lane = threadIdx.x & 31;
  unsigned at = 0;
  if (lane == 0 && m) at = atomicAdd(count, (unsigned)__popc(m));
  at = __shfl_sync(kFull, at, 0);
  if (take) s[at + __popc(m & ((1u << lane) - 1))] = c;
}

// the sum over the cluster's C CTAs of word i of the shared-memory array a (the same address in each), the loads
// issued together
__device__ __forceinline__ unsigned cluster_sum(cg::cluster_group& cluster, const uint32_t* a, int i, int C,
                                                unsigned* before, int rank) {
  unsigned x[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) x[q] = q < C ? cluster.map_shared_rank(a, q)[i] : 0u;
  unsigned v = 0, b = 0;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) {
    if (q == rank) b = v;
    v += x[q];
  }
  if (before) *before = b;  // the CTAs' below this one
  return v;
}

// the lane's 8 bins (half `half` of side `side`) of the anchor whose box logits start at element o of level L:
// 16-byte loads where P.box_vec (the box logits contiguous and aligned), else one a bin
template <typename T>
__device__ __forceinline__ void load_half_side(const Params& P, const Level& L, long long o, int side, int half,
                                               float (&v)[8]) {
  const T* p = static_cast<const T*>(L.ptr) + o;
  const long long first = (long long)(side * 16 + half * 8);
  if (P.box_vec) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < 8 / kPer; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p + first) + i);
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[i * kPer + j] = to_float(t[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = to_float(p[(first + j) * L.sc]);
  }
}

// one output row as its decode reads it, worked out once from its composite (the 8 lanes of the row share it)
struct RowInfo {
  long long o;       // the element offset of the anchor's box logits in its level's map
  float cx, cy, s;   // the anchor's centre (x + 0.5, y + 0.5) and its level's stride
  int a, cl, l;      // the anchor, the class and the level
  uint32_t key;      // the order key of the score
};

__device__ __forceinline__ RowInfo row_info(const Params& P, int b, u64 c) {
  RowInfo r;
  r.key = (uint32_t)(c >> P.ib);
  const int idx = P.n - 1 - (int)(c & ((1ull << P.ib) - 1));
  if (P.ml) {
    r.a = idx / P.nc;
    r.cl = idx - r.a * P.nc;
  } else {
    r.a = idx;
    r.cl = P.cls_of[(size_t)b * P.a + r.a];
  }
  r.l = level_of_anchor(P, r.a);
  const Level& L = P.levels[r.l];
  const int local = r.a - L.off, y = local / L.w, x = local - y * L.w;
  r.o = offset_of(L, b, y, x, 0);
  r.cx = __fadd_rn((float)x, 0.5f);
  r.cy = __fadd_rn((float)y, 0.5f);
  r.s = L.stride;
  return r;
}

// R = 16: output rows row0 + j, j < rows, of image b, whose composites are s_row[j], a chunk at a time. Each row's
// RowInfo into `info`, a thread a row; with `table` (the image's anchors, multi-label), the first row of each anchor
// claims it, and only those rows' anchors are decoded: a multi-label row repeats an anchor over its classes (val's
// 8,192 candidates lie on some 75 anchors an image of its net's maps). The decode: 8 lanes a row, two a side (the
// lane's 8 bins), every lane reaching the shuffles, two rows a lane group a step with the loads of both issued before
// either's math, the side's distance (csrc/dfl_math.cuh `Side16`, `expectation16`: K5's arithmetic) into `dist`. Then a thread a row writes its outputs from its anchor's
// distances.
template <typename T>
__device__ void decode_rows16(const Params& P, int b, int row0, int rows, const u64* s_row, RowInfo* info,
                              float4* dist, int* todo, int* table, int chunk) {
  constexpr int kStep = kClusterThreads / 8;  // rows a CTA takes at once
  __shared__ unsigned s_todo;
  const int lane = threadIdx.x & 31, side = (lane >> 1) & 3, half = lane & 1;
  for (int c0 = 0; c0 < rows; c0 += chunk) {
    const int n = min(chunk, rows - c0);
    if (table)
      for (int i = threadIdx.x; i < P.a; i += kClusterThreads) table[i] = -1;
    if (threadIdx.x == 0) s_todo = 0;
    __syncthreads();
    for (int base = 0; base < n; base += kClusterThreads) {  // (every lane reaches the ballot in append)
      const int j = base + threadIdx.x;
      bool first = j < n;
      if (first) {
        info[j] = row_info(P, b, s_row[c0 + j]);
        if (table) first = atomicCAS(&table[info[j].a], -1, j) == -1;
      }
      const unsigned m = __ballot_sync(kFull, first);
      unsigned at = 0;
      if (lane == 0 && m) at = atomicAdd(&s_todo, (unsigned)__popc(m));
      at = __shfl_sync(kFull, at, 0);
      if (first) todo[at + __popc(m & ((1u << lane) - 1))] = j;
    }
    __syncthreads();
    const int m = (int)s_todo;
    for (int base = 0; base < m; base += 2 * kStep) {
      float v[2][8];
      int j[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = base + h * kStep + (threadIdx.x >> 3);
        j[h] = q < m ? todo[q] : -1;
        if (j[h] >= 0) {
          const RowInfo& r = info[j[h]];
          load_half_side<T>(P, P.levels[r.l], r.o, side, half, v[h]);
        } else {
#pragma unroll
          for (int u = 0; u < 8; ++u) v[h][u] = 0.0f;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Side16 side16;
        side16.of(v[h]);
        const float d = expectation16(side16, half);
        if (j[h] >= 0 && half == 0) reinterpret_cast<float*>(dist + j[h])[side] = d;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kClusterThreads) {
      const RowInfo& r = info[j];
      const float4 d = dist[table ? table[r.a] : j];
      const size_t row = (size_t)b * P.k + row0 + c0 + j;
      const float fcl = (float)r.cl, shift = P.agnostic ? 0.0f : __fmul_rn(fcl, 7680.0f);
      const float4 box = make_float4(__fmul_rn(__fsub_rn(r.cx, d.x), r.s), __fmul_rn(__fsub_rn(r.cy, d.y), r.s),
                                     __fmul_rn(__fadd_rn(r.cx, d.z), r.s), __fmul_rn(__fadd_rn(r.cy, d.w), r.s));
      reinterpret_cast<float4*>(P.boxes)[row] = box;
      reinterpret_cast<float4*>(P.shifted)[row] = make_float4(__fadd_rn(box.x, shift), __fadd_rn(box.y, shift),
                                                              __fadd_rn(box.z, shift), __fadd_rn(box.w, shift));
      const float val = key_value(r.key);
      P.vals[row] = val;
      P.bidx[row] = r.a;
      P.cls[row] = fcl;
      P.valid[row] = val > P.valid_thr;
    }
    __syncthreads();  // the chunk's info, dist and table read before the next chunk's are written
  }
}

// One cluster of C CTAs an image (blockIdx.x = image * C + rank). Each CTA finds the first digit's bin b0 of the
// K-th entry (the score pass's counts) and reads its slice of the image's key row once, listing in shared memory,
// in row order, the composites above b0's bin (all winners; at most K - need of them in the whole row) and those in
// it (the ties; the first tie_cap of them). Then, the counts shared through DSMEM:
//   every entry of b0's bin wins (need = its count): nothing to resolve;
//   the bin holds one key and the row is stored in index order (the rule when fewer than K entries pass the gate:
//     b0 is the bin of the -1 fillers): the bin's winners are its `need` lowest indices, the first ones in row order,
//     so each CTA takes the first ones of its tie list that a prefix count of the CTAs' ties leaves it: their rows
//     follow from that count;
//   else, where the entries at or above b0's bin number at most K + slack, nothing more either (they are ordered
//     and those past row K dropped); else the later digits, each a histogram of the ties whose decided bits match
//     (from the tie list, or the key slice where the list overflowed), summed over the cluster through DSMEM (one
//     key: its index bits alone), until the entries at or above the decided bits number at most K + slack.
// Those entries (the group; but for the shortcut's winners of b0's bin) are put in order by one more digit, the 11
// bits below those that all of them share: its histograms summed over the cluster give each bucket its first place,
// each entry goes to a slot of its bucket in the CTA that holds the bucket (the one whose even share of the places
// holds the bucket's first place: a bucket never spans two CTAs), and each CTA moves each of its slots to the place
// its count of larger ones in the bucket gives: places below K are the output rows (CTA r holds rows [r R, r R + R),
// R = ceil(K / C)). Each CTA decodes its rows from the candidates' own box logits (at reg_max 16 on 8 lanes a row).
template <int RM>
__global__ void __launch_bounds__(kClusterThreads, 1)
    cluster_select(const __grid_constant__ Params P, int win_cap, int row_cap, int tie_cap, int slack) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int b = blockIdx.x / C, t = threadIdx.x;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_hist = reinterpret_cast<uint32_t*>(smem);      // three arrays of kBins: counts, starts, slots
  u64* s_win = reinterpret_cast<u64*>(s_hist + 3 * kBins);   // win_cap: the entries above b0, then the group's
  u64* s_row = s_win + win_cap;                               // row_cap: the rows rank R .. rank R + R - 1
  u64* s_tie = s_row + row_cap;                               // tie_cap: the ties, then this CTA's slots
  __shared__ SliceCounts s_mine, s_all[kMaxCluster];
  __shared__ unsigned s_warp[32];
  __shared__ unsigned s_need, s_done, s_count, s_group;
  __shared__ int s_first[kMaxCluster + 1];
  __shared__ u64 s_prefix;
  const int n = P.n, shift = 32 - kDigit, lo0 = P.total_bits - kDigit;
  const uint32_t* keys = P.keys + (size_t)b * n;
  const bool vec = (n & 3) == 0;

  // the first digit: the bin b0 that holds the K-th largest entry, from the score pass's counts
  for (int i = t; i < kBins; i += kClusterThreads) s_hist[i] = __ldcg(P.hist + (size_t)b * kBins + i);
  if (t == 0) {
    s_prefix = 0;
    s_need = (unsigned)P.k;
    s_done = 0;
    s_group = (unsigned)P.k;
    s_mine.top = 0;
    s_mine.bottom = ~0ull;
    s_mine.tie_min = ~0u;
    s_mine.tie_max = 0;
  }
  __syncthreads();
  finish_bin<kClusterThreads>(s_hist, kBins, lo0, &s_prefix, &s_need, &s_done);
  const uint32_t b0 = (uint32_t)(s_prefix >> lo0);
  const unsigned need0 = s_need, group0 = (unsigned)P.k - need0 + s_hist[b0];  // the entries at or above b0's bin
  const bool done0 = s_done;

  // this CTA's slice, read once (the next step's keys loaded while a step is listed): the entries above b0 into
  // s_win and those in it into s_tie, in row order
  const int per = (int)((((long long)n + C - 1) / C + kKeysAThread - 1) / kKeysAThread * kKeysAThread);
  const int lo_p = (int)min((long long)rank * per, (long long)n);
  const int hi_p = (int)min((long long)lo_p + per, (long long)n);
  unsigned n_above = 0, n_tie = 0, tmin = ~0u, tmax = 0;
  u64 top = 0, bottom = ~0ull;
  const uint32_t lo_key = b0 << shift;  // the least key of b0's bin
  uint32_t next[kKeysAThread];
  load_keys(keys, lo_p + kKeysAThread * t, hi_p, vec, next);
  for (int base = lo_p; base < hi_p; base += kTileKeys) {
    uint32_t k[kKeysAThread];
#pragma unroll
    for (int u = 0; u < kKeysAThread; ++u) k[u] = next[u];
    if (base + kTileKeys < hi_p) load_keys(keys, base + kTileKeys + kKeysAThread * t, hi_p, vec, next);
    const int p0 = base + kKeysAThread * t;
    unsigned above = 0, tie = 0;  // the thread's keys above b0's bin and in it, a bit a key
    unsigned in = 0;              // those at or above b0's bin: one compare a key
#pragma unroll
    for (int u = 0; u < kKeysAThread; ++u) in |= (unsigned)(k[u] >= lo_key) << u;
    in &= p0 + kKeysAThread <= hi_p ? (1u << kKeysAThread) - 1u : (1u << max(0, hi_p - p0)) - 1u;  // none past hi_p
    if (in) {
#pragma unroll
      for (int u = 0; u < kKeysAThread; ++u) {
        const uint32_t bin = k[u] >> shift;
        above |= (unsigned)((in >> u & 1u) && bin > b0) << u;
        tie |= (unsigned)((in >> u & 1u) && bin == b0) << u;
      }
    }
    unsigned total;
    const unsigned off = cta_scan(__popc(above) | (__popc(tie) << 16), s_warp, &total);  // at most 8,192 of each
    if (above | tie) {
      unsigned ao = n_above + (off & 0xffffu), to = n_tie + (off >> 16);
#pragma unroll
      for (int u = 0; u < kKeysAThread; ++u) {
        if (!((above | tie) >> u & 1u)) continue;
        const u64 c = composite(P, k[u], flat_index(P, p0 + u));
        top = c > top ? c : top;
        if (above >> u & 1u) {
          bottom = c < bottom ? c : bottom;
          s_win[ao++] = c;
        } else {
          tmin = min(tmin, k[u]);
          tmax = max(tmax, k[u]);
          if (to < (unsigned)tie_cap) s_tie[to] = c;
          ++to;
        }
      }
    }
    n_above += total & 0xffffu;
    n_tie += total >> 16;
  }
  tmin = __reduce_min_sync(kFull, tmin);
  tmax = __reduce_max_sync(kFull, tmax);
  for (int o = 16; o > 0; o >>= 1) {
    const u64 x = __shfl_xor_sync(kFull, top, o), y = __shfl_xor_sync(kFull, bottom, o);
    top = x > top ? x : top;
    bottom = y < bottom ? y : bottom;
  }
  if ((t & 31) == 0) {
    atomicMin(&s_mine.tie_min, tmin);
    atomicMax(&s_mine.tie_max, tmax);
    atomicMax(&s_mine.top, top);
    atomicMin(&s_mine.bottom, bottom);
  }
  if (t == 0) {
    s_mine.ties = n_tie;
  }
  const bool tie_over = n_tie > (unsigned)tie_cap;
  cluster.sync();  // every CTA has listed its slice (and has started: the first access to another's memory follows)
  if (t < C) s_all[t] = *cluster.map_shared_rank(&s_mine, t);
  __syncthreads();

  // the bin's keys and each CTA's share of its winners, the same in every thread of the cluster
  unsigned tie_before = 0, tie_lo = ~0u, tie_hi = 0, before = 0;
  u64 top_all = 0, bottom_all = ~0ull;
  for (int q = 0; q < C; ++q) {
    const SliceCounts& s = s_all[q];
    if (q == rank) tie_before = before;
    before += s.ties;
    tie_lo = min(tie_lo, s.tie_min);
    tie_hi = max(tie_hi, s.tie_max);
    top_all = s.top > top_all ? s.top : top_all;
    bottom_all = s.bottom < bottom_all ? s.bottom : bottom_all;
  }
  // the shortcut: a CTA's winners of the bin (at most need <= K) are the first ones of its tie list, which holds K +
  // slack of them
  const bool one_key = tie_lo == tie_hi;
  const bool by_index = !done0 && one_key && !P.class_major;
  const unsigned m_mine = need0 > tie_before ? min(need0 - tie_before, n_tie) : 0u;

  // the later digits over the ties whose decided bits match (one key: all of them, its index bits alone), until the
  // entries at or above the decided bits (the group) number at most K + slack: none where the first digit's do
  if (!done0 && !by_index && group0 <= (unsigned)(P.k + slack)) {
    if (t == 0) s_group = group0;
    __syncthreads();
  } else if (!done0 && !by_index) {
    int hi = lo0;
    if (one_key) {
      if (t == 0) s_prefix = (u64)tie_lo << P.ib;
      hi = P.ib;
    }
    __syncthreads();
    for (int pass = 0; !s_done; ++pass) {
      const int lo = max(hi - kDigit, 0), nb = 1 << (hi - lo);
      uint32_t* cnt = s_hist + (pass & 1) * kBins;        // this CTA's counts, read by the others
      uint32_t* sum = s_hist + ((pass + 1) & 1) * kBins;  // the cluster's, the others done with it (last pass)
      zero_shared(cnt, nb);
      __syncthreads();
      const u64 want = s_prefix >> hi;
      const u64 mask = (u64)(nb - 1);
      if (!tie_over) {  // (the ties' digits rarely collide: one atomic an entry)
        for (unsigned i = t; i < n_tie; i += kClusterThreads) {
          const u64 c = s_tie[i];
          if ((c >> hi) == want) atomicAdd(&cnt[(int)((c >> lo) & mask)], 1u);
        }
      } else {
        each_key(keys, lo_p, hi_p, vec, [&](const uint32_t* k, int p0) {
#pragma unroll
          for (int u = 0; u < kKeysAThread; ++u) {
            int bin = -1;
            if (p0 + u < hi_p && (k[u] >> shift) == b0) {
              const u64 c = composite(P, k[u], flat_index(P, p0 + u));
              if ((c >> hi) == want) bin = (int)((c >> lo) & mask);
            }
            count_bin(cnt, bin);
          }
        });
      }
      cluster.sync();  // every CTA's counts of this digit are in
      for (int i = t; i < nb; i += kClusterThreads) sum[i] = cluster_sum(cluster, cnt, i, C, nullptr, rank);
      __syncthreads();
      finish_bin<kClusterThreads>(sum, nb, lo, &s_prefix, &s_need, &s_done);
      if (t == 0 && !s_done) {  // the entries at or above the bin: few enough to order, the rest past row K
        const unsigned group = (unsigned)P.k - s_need + sum[(int)((s_prefix >> lo) & mask)];
        if (group <= (unsigned)(P.k + slack)) {
          s_group = group;
          s_done = 1;
        }
      }
      __syncthreads();
      hi = lo;
    }
  }

  // this CTA's share of the group: the entries above b0, then (but for the shortcut's, whose rows follow from the
  // prefix count) those of b0's bin at or above the decided bits
  if (t == 0) s_count = n_above;
  __syncthreads();
  if (!by_index) {
    const u64 thr = s_prefix;
    if (!tie_over) {
      for (unsigned base = 0; base < n_tie; base += kClusterThreads) {
        const unsigned i = base + t;
        const u64 c = i < n_tie ? s_tie[i] : 0ull;
        append(s_win, &s_count, i < n_tie && c >= thr, c);
      }
    } else {
      each_key(keys, lo_p, hi_p, vec, [&](const uint32_t* k, int p0) {
#pragma unroll
        for (int u = 0; u < kKeysAThread; ++u) {
          const bool tie = p0 + u < hi_p && (k[u] >> shift) == b0;
          const u64 c = tie ? composite(P, k[u], flat_index(P, p0 + u)) : 0ull;
          append(s_win, &s_count, tie && c >= thr, c);
        }
      });
    }
  }
  // the ordering digit: the 11 bits below those that every entry of the group shares (they lie in [lowest,
  // top_all]); the group takes places [0, group)
  const int group = by_index ? P.k - (int)need0 : (int)s_group;
  const u64 lowest = by_index ? bottom_all : s_prefix;
  const int span = top_all > lowest ? 64 - __clzll((long long)(top_all ^ lowest)) : 0;
  const int dlo = max(span - kDigit, 0), nd = 1 << (span - dlo);
  uint32_t* cnt = s_hist + 2 * kBins;  // this CTA's group by digit, read by the others (the digits' two arrays may
                                       // still be read: they are written after the next cluster barrier)
  uint32_t* start = s_hist;            // each bucket's first place: the group's entries of the larger digits
  uint32_t* slot = s_hist + kBins;     // this CTA's next slot in each bucket
  zero_shared(cnt, nd);
  __syncthreads();
  const int n_win = (int)s_count;
  for (int i = t; i < n_win; i += kClusterThreads) atomicAdd(&cnt[(int)((s_win[i] >> dlo) & (u64)(nd - 1))], 1u);
  const int R = row_cap, RS = (group + C - 1) / C;  // rows, and slots, a CTA
  for (unsigned j = t; j < (by_index ? m_mine : 0u); j += kClusterThreads) {  // the shortcut's rows
    const unsigned row = (unsigned)group + tie_before + j;
    *cluster.map_shared_rank(s_row + row % R, (int)(row / R)) = s_tie[j];
  }
  cluster.sync();  // every CTA's digit counts are in, and its tie list is free

  // each bucket's first place (the buckets of larger digits first) and this CTA's first slot in it (after the CTAs
  // below it); each entry to a slot of its bucket, in the CTA that holds that slot
  {
    const int d0 = nd - 1 - 2 * t;  // this thread's two buckets, the larger digit first
    unsigned h0 = 0, h1 = 0, below0 = 0, below1 = 0;
    if (d0 >= 0) h0 = cluster_sum(cluster, cnt, d0, C, &below0, rank);
    if (d0 >= 1) h1 = cluster_sum(cluster, cnt, d0 - 1, C, &below1, rank);
    unsigned total;
    const unsigned first = cta_scan(h0 + h1, s_warp, &total);
    if (d0 >= 0) {
      start[d0] = first;
      slot[d0] = first + below0;
    }
    if (d0 >= 1) {
      start[d0 - 1] = first + h0;
      slot[d0 - 1] = first + h0 + below1;
    }
  }
  // the slots: a bucket's all in one CTA, the one whose share of RS places holds the bucket's first place; CTA q's
  // slots are the places [first[q], first[q + 1]), first[q] the first bucket start at or past q RS (start[] does not
  // increase with the digit: a binary search)
  if (t <= C) {
    int d = -1;  // the largest digit whose start is at or past t RS
    for (int lo = 0, hi = nd - 1; lo <= hi;) {
      const int mid = (lo + hi) >> 1;
      if ((int)start[mid] >= t * RS) {
        d = mid;
        lo = mid + 1;
      } else {
        hi = mid - 1;
      }
    }
    s_first[t] = t < C && d >= 0 ? min((int)start[d], group) : group;
  }
  __syncthreads();
  for (int i = t; i < n_win; i += kClusterThreads) {
    const u64 c = s_win[i];
    const int d = (int)((c >> dlo) & (u64)(nd - 1)), q = (int)start[d] / RS;
    const unsigned at = atomicAdd(&slot[d], 1u);
    *cluster.map_shared_rank(s_tie + (at - s_first[q]), q) = c;
  }
  cluster.sync();  // every entry of the group is in its bucket's slots
  // each slot's entry to its place: its bucket's first place plus the bucket's entries larger than it (the bucket's
  // slots, all in this CTA: from its first place to the next smaller digit's); a place below K is a row. That count
  // reads a bucket's size an entry, the squares of the buckets' sizes in all: where keys that many entries share
  // (bf16 logits near a bias) make that cost more than sorting the CTA's slots (its bitonic network's steps, each
  // worth kSortStepReads reads a thread), the CTA sorts them instead, and a slot's place is f0 plus its own (its
  // buckets are the places [f0, f0 + slots), the larger digits first)
  const int f0 = s_first[rank], slots = s_first[rank + 1] - f0;
  unsigned work = 0;
  for (int j = t; j < slots; j += kClusterThreads) {
    const int d = (int)((s_tie[j] >> dlo) & (u64)(nd - 1));
    work += (unsigned)((d > 0 ? (int)start[d - 1] : group) - (int)start[d]);
  }
  unsigned reads;
  cta_scan(work, s_warp, &reads);
  int p2 = 1, lg = 0;
  while (p2 < slots) {
    p2 <<= 1;
    ++lg;
  }
  const long long steps = (long long)lg * (lg + 1) / 2 * ((p2 / 2 + kClusterThreads - 1) / kClusterThreads);
  if ((long long)reads > (long long)kSortStepReads * kClusterThreads * steps) {
    sort_descending(s_tie, slots);
    for (int j = t; j < slots; j += kClusterThreads)
      if (f0 + j < P.k) *cluster.map_shared_rank(s_row + (f0 + j) % R, (f0 + j) / R) = s_tie[j];
  } else {
    for (int j = t; j < slots; j += kClusterThreads) {
      const u64 c = s_tie[j];
      const int d = (int)((c >> dlo) & (u64)(nd - 1));
      const int first = (int)start[d], end = d > 0 ? (int)start[d - 1] : group;
      int larger = 0;
      for (int p = first - f0; p < end - f0; ++p) larger += s_tie[p] > c;
      const int row = first + larger;
      if (row < P.k) *cluster.map_shared_rank(s_row + row % R, row / R) = c;
    }
  }
  cluster.sync();  // every row is in its CTA; no CTA reads another's memory after this

  // this CTA's rows: their RowInfo, distances and the rows to decode, a chunk at a time, over the free tie list; the
  // anchors' table over the free s_win where it holds the image's anchors
  const int row0 = rank * R, mine = max(0, min(R, P.k - row0));
  if (RM == 16) {
    constexpr int kRowBytes = sizeof(RowInfo) + sizeof(float4) + sizeof(int);
    const int chunk = (int)(((long long)tie_cap * sizeof(u64) - 16) / kRowBytes);
    RowInfo* info = reinterpret_cast<RowInfo*>(s_tie);
    float4* dist = reinterpret_cast<float4*>((reinterpret_cast<uintptr_t>(info + chunk) + 15) & ~uintptr_t(15));
    int* todo = reinterpret_cast<int*>(dist + chunk);
    int* table = P.ml && (long long)P.a * sizeof(int) <= (long long)win_cap * sizeof(u64)
                     ? reinterpret_cast<int*>(s_win) : nullptr;
    if (P.map_type == 0)
      decode_rows16<float>(P, b, row0, mine, s_row, info, dist, todo, table, chunk);
    else if (P.map_type == 1)
      decode_rows16<__nv_bfloat16>(P, b, row0, mine, s_row, info, dist, todo, table, chunk);
    else
      decode_rows16<__half>(P, b, row0, mine, s_row, info, dist, todo, table, chunk);
  } else {
    for (int q = t; q < 4 * mine; q += kClusterThreads) decode_side<RM>(P, b, row0 + (q >> 2), q & 3, s_row[q >> 2]);
  }
}

int bit_length(long long v) {
  int n = 0;
  while (v > 0) {
    ++n;
    v >>= 1;
  }
  return n;
}

long long round_up(long long v, long long to) { return (v + to - 1) / to * to; }

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

struct Layout {
  long long img, hist, keys, cls_of, dist, list, cand, sorted, total;
};

Layout layout(int b, long long a, int nc, int ml, int k) {
  const long long n = ml ? a * nc : a;
  const long long p2 = round_up(k, kChunk);  // whole chunks for the sort
  Layout w;
  long long at = 0;
  w.img = at;  // img and hist: the passes route's state, zeroed by one memset
  at = round_up(at + (long long)b * sizeof(Image), 256);
  w.hist = at;
  at = round_up(at + (long long)b * kBins * 4, 256);
  w.keys = at;
  at = round_up(at + (long long)b * n * 4, 256);
  w.cls_of = at;
  at = round_up(at + (ml ? 0 : (long long)b * a * 4), 256);
  w.dist = at;  // reserved whether or not the launch decodes densely
  at = round_up(at + (long long)b * a * 16, 256);
  w.list = at;
  at = round_up(at + (long long)b * (n / 4) * 8, 256);
  w.cand = at;
  at = round_up(at + (long long)b * p2 * 8, 256);
  w.sorted = at;
  at = round_up(at + (long long)b * k * 8, 256);
  w.total = at;
  return w;
}

// whether every level's class logits lie contiguous and start on 16 bytes, nc a whole number of 16-byte loads
bool vec_classes(int n_levels, const unsigned long long* ptrs, const long long* strides, int map_type, int nc,
                 int reg_max) {
  const long long elt = map_type == 0 ? 4 : 2;
  if ((nc * elt) % 16 || (4 * reg_max * elt) % 16) return false;
  for (int l = 0; l < n_levels; ++l) {
    const long long* s = strides + 4 * l;
    if (s[3] != 1 || ptrs[l] % 16 || (s[0] * elt) % 16 || (s[1] * elt) % 16 || (s[2] * elt) % 16) return false;
  }
  return true;
}

// whether every level's box logits lie contiguous (channel stride 1) and each anchor's start on 16 bytes
bool vec_boxes(int n_levels, const unsigned long long* ptrs, const long long* strides, int map_type) {
  const long long elt = map_type == 0 ? 4 : 2;
  for (int l = 0; l < n_levels; ++l) {
    const long long* s = strides + 4 * l;
    if (s[3] != 1 || ptrs[l] % 16 || (s[0] * elt) % 16 || (s[1] * elt) % 16 || (s[2] * elt) % 16) return false;
  }
  return true;
}

// whether every level is a set of NCHW planes whose anchors lie contiguous (x stride 1, y stride W) in runs of
// V = kPlaneBytes / element that start on that many bytes in every class plane of every image
bool plane_classes(int n_levels, const unsigned long long* ptrs, const long long* strides, const int* hw,
                   int map_type) {
  const long long v = kPlaneBytes / (map_type == 0 ? 4 : 2);
  for (int l = 0; l < n_levels; ++l) {
    const long long* s = strides + 4 * l;
    const long long h = hw[2 * l], w = hw[2 * l + 1];
    if (s[2] != 1 || s[1] != w || (h * w) % v || s[0] % v || s[3] % v || ptrs[l] % kPlaneBytes) return false;
  }
  return true;
}

enum Score { kScoreAnchor = 0, kScoreAnchorVec = 1, kScorePlane = 2, kScoreEntry = 3, kScoreEntryVec = 4 };
enum Route { kPasses = 0, kFinish = 1, kCluster = 2 };

// The route of a call, from its shapes and strides alone: finish (two launches) where an image's row fits the
// finishing CTA's shared memory, else cluster (two launches) where K does, else the passes; the score pass's
// kernel; the finishing CTAs an image and their dynamic shared memory; the cluster's CTAs an image, their dynamic
// shared memory and cudaOccupancyMaxActiveClusters at that size
struct Plan {
  int route, score, reps, p2, smem, launches, cluster, max_active;
};

int finish_smem(long long n, int p2) {  // keys, histogram, winners, tie list (or rows), candidates
  return (int)(round_up(n, 4) * 4 + kBins * 4 + (long long)p2 * 8 + kTieCap * 2 + kRankCap * 8);
}

bool finish_fits(long long n, int p2) { return n <= kFinishCap && finish_smem(n, p2) <= kMaxSmem - 1024; }

int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (!cached[device] && cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    cached[device] = 0;
  return cached[device];
}

// ---- the cluster kernel's launch: its shared memory, attributes and cluster size, asked once per device ----

struct ClusterDevice {
  int smem = 0;                          // dynamic shared memory of a CTA: all the card offers past the static
  bool set[2] = {};                      // cluster_select<16>'s and <0>'s attributes set
  int known[kMaxCluster + 1] = {};       // cudaOccupancyMaxActiveClusters + 1 by cluster size; 0: not asked yet
};

ClusterDevice cluster_devices[kMaxDevices];

template <int RM>
cudaError_t configure_cluster(int device) {
  ClusterDevice& d = cluster_devices[device % kMaxDevices];
  cudaError_t err = cudaSuccess;
  if (!d.smem) {
    int optin = 0;
    cudaFuncAttributes fa16, fa0;
    if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != cudaSuccess ||
        (err = cudaFuncGetAttributes(&fa16, cluster_select<16>)) != cudaSuccess ||
        (err = cudaFuncGetAttributes(&fa0, cluster_select<0>)) != cudaSuccess)
      return err;
    d.smem = optin - (int)(fa16.sharedSizeBytes > fa0.sharedSizeBytes ? fa16.sharedSizeBytes : fa0.sharedSizeBytes);
  }
  if (!d.set[RM ? 0 : 1]) {
    if ((err = cudaFuncSetAttribute(cluster_select<RM>, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(cluster_select<RM>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
            cudaSuccess)
      return err;
    d.set[RM ? 0 : 1] = true;
  }
  return err;
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int b, int cluster, int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)b * cluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// cudaOccupancyMaxActiveClusters for clusters of c CTAs (0 where the card cannot run them), asked once per device
int max_active_clusters(int device, int c) {
  ClusterDevice& d = cluster_devices[device % kMaxDevices];
  int& slot = d.known[c];
  if (slot == 0) {
    int n = 0;
    cudaError_t err = configure_cluster<16>(device);
    if (err == cudaSuccess) {
      cudaLaunchAttribute attr[1];
      const cudaLaunchConfig_t cfg = cluster_config(attr, 1, c, d.smem, nullptr);
      err = cudaOccupancyMaxActiveClusters(&n, cluster_select<16>, &cfg);
    }
    if (err != cudaSuccess) {
      cudaGetLastError();  // a size the card cannot co-schedule: not an error of a launch
      n = 0;
    }
    slot = n + 1;
  }
  return slot - 1;
}

// The cluster size for a batch of b images, as K4's: the largest C <= 16 of which the card holds b clusters at once,
// else 1 (the clusters then run in waves); 0 where the card runs no cluster of this kernel
int cluster_for(int b, int device) {
  for (int c = kMaxCluster; c > 1; --c)
    if (max_active_clusters(device, c) >= b) return c;
  return max_active_clusters(device, 1) > 0 ? 1 : 0;
}

// the cluster kernel's capacities in composites: a CTA's share of the group (at most K + slack), its output rows R
// = ceil(K / C), its tie list (later its slots; at least K + slack, so that a CTA whose tie list overflows still
// holds its winners of the bin), with slack the most of kSlack that fits; slack < 0 where K does not fit
void cluster_caps(int k, int cluster, int smem, int* win_cap, int* row_cap, int* tie_cap, int* slack) {
  *row_cap = (k + cluster - 1) / cluster;
  const long long left = ((long long)smem - 3LL * kBins * 4 - 8LL * *row_cap) / 8;  // composites for the two lists
  const long long most = left / 2 - k;
  *slack = most < 0 ? -1 : (int)(most < kSlack ? most : kSlack);
  *win_cap = k + (*slack > 0 ? *slack : 0);
  *tie_cap = (int)(left - *win_cap);
}

Plan plan(int n_levels, const unsigned long long* ptrs, const long long* strides, const int* hw, int map_type,
          int b, int nc, int reg_max, int ml, int k, long long a, int device, int pick) {
  const long long n = ml ? a * nc : a;
  Plan pl{};
  const bool vec = vec_classes(n_levels, ptrs, strides, map_type, nc, reg_max);
  pl.score = ml ? (vec ? kScoreEntryVec : kScoreEntry)
                : vec ? kScoreAnchorVec : plane_classes(n_levels, ptrs, strides, hw, map_type) ? kScorePlane
                                                                                               : kScoreAnchor;
  pl.p2 = pow2_at_least(k);
  // the cluster route decodes each candidate from its own box logits: where they lie in NCHW planes (64 scattered
  // sectors a candidate) and the candidates are a quarter of the anchors or more, the passes route's dense decode
  // (coalesced over the anchors) is the faster (PERF.md)
  const bool finish = finish_fits(n, pl.p2),
             cluster = k <= kClusterMaxK && (vec_boxes(n_levels, ptrs, strides, map_type) || 4LL * k < a);
  // clusters of one CTA (a batch past what the card holds in clusters of two at once: B > 66 on an H100) read an
  // image's key row on one SM: there the passes route, spread over the card, is the faster (PERF.md)
  pl.route = pick >= 0 ? pick : finish ? kFinish : cluster && cluster_for(b, device) >= 2 ? kCluster : kPasses;
  if ((pl.route == kFinish && !finish) || (pl.route == kCluster && !cluster) || pl.route < 0 || pl.route > 2) {
    pl.route = -1;  // a route these shapes cannot take
    return pl;
  }
  if (pl.route == kFinish) {
    pl.reps = sm_count(device) / (b > 0 ? b : 1);  // a finishing CTA an SM
    pl.reps = pl.reps < 1 ? 1 : pl.reps > kMaxReps ? kMaxReps : pl.reps;
    if (pl.reps > k) pl.reps = k > 0 ? k : 1;
    pl.smem = finish_smem(n, pl.p2);
    pl.launches = 2;
  } else if (pl.route == kCluster) {
    pl.cluster = cluster_for(b, device);
    pl.max_active = pl.cluster ? max_active_clusters(device, pl.cluster) : 0;
    pl.smem = cluster_devices[device % kMaxDevices].smem;
    pl.launches = 2;
  } else {
    const int ib = bit_length(n - 1) > 0 ? bit_length(n - 1) : 1;
    const int passes = (32 + ib + kDigit - 1) / kDigit;
    // score, compact, a hist pass per later digit, collect, sort, rank, the dense DFL pass, decode
    pl.launches = 2 + (passes - 1) + 3 + (4LL * k >= a ? 1 : 0) + 1;
  }
  return pl;
}

cudaError_t launch_score(const Params& P, int score, int b, long long a, long long n, cudaStream_t st) {
  const dim3 rows((unsigned)((n + kPerCtaRow - 1) / kPerCtaRow), b);
  switch (score) {
    case kScoreEntryVec:
      if (P.map_type == 0)
        score_entry_vec<float><<<rows, kThreads, 0, st>>>(P);
      else if (P.map_type == 1)
        score_entry_vec<__nv_bfloat16><<<rows, kThreads, 0, st>>>(P);
      else
        score_entry_vec<__half><<<rows, kThreads, 0, st>>>(P);
      break;
    case kScoreEntry:
      score_entry<<<rows, kThreads, 0, st>>>(P);
      break;
    case kScoreAnchorVec: {
      const dim3 grid((unsigned)((a + kThreads - 1) / kThreads), b);
      if (P.map_type == 0)
        score_anchor_vec<float><<<grid, kThreads, 0, st>>>(P);
      else if (P.map_type == 1)
        score_anchor_vec<__nv_bfloat16><<<grid, kThreads, 0, st>>>(P);
      else
        score_anchor_vec<__half><<<grid, kThreads, 0, st>>>(P);
      break;
    }
    case kScorePlane: {
      const long long v = kPlaneBytes / (P.map_type == 0 ? 4 : 2);  // anchors a thread
      const dim3 grid((unsigned)((a / v + kThreads - 1) / kThreads), b);
      if (P.map_type == 0)
        score_plane<float><<<grid, kThreads, 0, st>>>(P);
      else if (P.map_type == 1)
        score_plane<__nv_bfloat16><<<grid, kThreads, 0, st>>>(P);
      else
        score_plane<__half><<<grid, kThreads, 0, st>>>(P);
      break;
    }
    default:
      score_anchor<<<dim3((unsigned)((a + kPerCtaAnchor - 1) / kPerCtaAnchor), b), kThreads, 0, st>>>(P);
  }
  return cudaGetLastError();
}

template <int RM>
cudaError_t launch_finish(const Params& P, const Plan& pl, int b, cudaStream_t st) {
  if (pl.smem > 48 * 1024) {  // the dynamic shared-memory limit raised to what this launch takes
    const cudaError_t err = cudaFuncSetAttribute(finish<RM>, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return err;
  }
  finish<RM><<<(unsigned)(b * pl.reps), kFinishThreads, pl.smem, st>>>(P, pl.reps, pl.p2);
  return cudaGetLastError();
}

template <int RM>
cudaError_t launch_cluster(const Params& P, const Plan& pl, int b, int device, cudaStream_t st) {
  int win_cap, row_cap, tie_cap, slack;
  if (pl.cluster < 1) return cudaErrorInvalidConfiguration;  // the card runs no cluster of this kernel
  cluster_caps(P.k, pl.cluster, pl.smem, &win_cap, &row_cap, &tie_cap, &slack);
  if (slack < 0) return cudaErrorInvalidValue;
  cudaError_t err = configure_cluster<RM>(device);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, b, pl.cluster, pl.smem, st);
  if ((err = cudaLaunchKernelEx(&cfg, cluster_select<RM>, P, win_cap, row_cap, tie_cap, slack)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" long long select_decode_workspace_bytes(int n_levels, int b, long long a, int nc, int ml, int k) {
  return layout(b, a, nc, ml, k).total;
}

// The route a call with these arguments takes (select_decode's leading arguments, then the device and the route to
// take, -1 for plan's pick, as select_decode_pick's): route (0 passes, 1 finish, 2 cluster; -1 where the named route
// cannot take these shapes), the score pass's kernel (0 anchor, 1 anchor_vec, 2 plane, 3 entry, 4 entry_vec), the
// kernel launches of one call, the finishing CTAs an image, the dynamic shared memory of a finishing or cluster CTA in
// bytes, the cluster's CTAs an image, cudaOccupancyMaxActiveClusters at that size, and a cluster CTA's tie list and
// slack in composites (`cluster_caps`), written to plan_out[0..8]
extern "C" int select_decode_plan(int n_levels, const unsigned long long* ptrs, const long long* strides,
                                  const int* hw, int map_type, int b, int nc, int reg_max, int ml, int k, int device,
                                  int pick, int* plan_out) {
  cudaError_t err = cudaSetDevice(device);  // the occupancy queries ask the current device
  if (err != cudaSuccess) return static_cast<int>(err);
  long long a = 0;
  for (int l = 0; l < n_levels; ++l) a += (long long)hw[2 * l] * hw[2 * l + 1];
  const Plan pl = plan(n_levels, ptrs, strides, hw, map_type, b, nc, reg_max, ml, k, a, device, pick);
  plan_out[0] = pl.route;
  plan_out[1] = pl.score;
  plan_out[2] = pl.launches;
  plan_out[3] = pl.route == kFinish ? pl.reps : 0;
  plan_out[4] = pl.route == kFinish || pl.route == kCluster ? pl.smem : 0;
  plan_out[5] = pl.cluster;
  plan_out[6] = pl.max_active;
  int win_cap = 0, row_cap = 0, tie_cap = 0, slack = 0;
  if (pl.route == kCluster && pl.cluster > 0)
    cluster_caps(k, pl.cluster, pl.smem, &win_cap, &row_cap, &tie_cap, &slack);
  plan_out[7] = tie_cap;
  plan_out[8] = slack;
  return 0;
}

// Writes 1 to *bad (an int the caller zeroed) unless torch_sigmoid is monotone non-decreasing over every non-NaN
// fp32, which the single-label score pass assumes (ClassMax): one launch of some 4.3 billion scores, run by the card
// tests and chip_smoke.py
extern "C" int select_decode_sigmoid_check(void* bad, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long keys = 0xff800000ull - 0x007fffffull + 1;
  const unsigned blocks = (unsigned)((keys + 4096ull * 256 - 1) / (4096ull * 256));
  sigmoid_monotone_check<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<unsigned*>(bad));
  return static_cast<int>(cudaGetLastError());
}

namespace {

// one call's launches down route `pick` (-1: plan's); score_only: the memset and the score pass alone. *taken (where
// not null) gets the route run.
int run(int n_levels, const unsigned long long* ptrs, const long long* strides, const int* hw, const float* stride_px,
        int map_type, int b, int nc, int reg_max, int ml, int k, float thr, float valid_thr, int score_type,
        const void* mask, int agnostic, void* workspace, long long workspace_bytes, void* vals, void* bidx, void* cls,
        void* boxes, void* shifted, void* valid, int device, void* stream, bool score_only, int pick, int* taken) {
  if (n_levels < 1 || n_levels > kMaxLevels || b < 0 || nc < 1 || reg_max < 1 || reg_max > kMaxReg || k < 0 ||
      map_type < 0 || map_type > 2 || score_type < 0 || score_type > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  long long a = 0;
  for (int l = 0; l < n_levels; ++l) a += (long long)hw[2 * l] * hw[2 * l + 1];
  const long long n = ml ? a * nc : a;
  if (k > n || n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || k == 0) return 0;
  const Layout w = layout(b, a, nc, ml, k);
  if (workspace_bytes < w.total) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);  // nvcc's own runtime: its current device is not PyTorch's
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* ws = static_cast<char*>(workspace);
  const Plan pl = plan(n_levels, ptrs, strides, hw, map_type, b, nc, reg_max, ml, k, a, device, pick);
  if (pl.route < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (taken) *taken = pl.route;

  Params P;
  long long off = 0;
  for (int l = 0; l < n_levels; ++l) {  // the level descriptors, by value in every launch's parameters
    Level& L = P.levels[l];
    L.ptr = reinterpret_cast<const void*>(ptrs[l]);
    L.sb = strides[4 * l];
    L.sh = strides[4 * l + 1];
    L.sw = strides[4 * l + 2];
    L.sc = strides[4 * l + 3];
    L.h = hw[2 * l];
    L.w = hw[2 * l + 1];
    L.off = (int)off;
    L.stride = stride_px[l];
    off += (long long)L.h * L.w;
  }
  P.n_levels = n_levels;
  P.map_type = map_type;
  P.score_type = score_type;
  P.b = b;
  P.nc = nc;
  P.reg_max = reg_max;
  P.ml = ml;
  P.k = k;
  P.p2 = (int)round_up(k, kChunk);
  P.a = (int)a;
  P.n = (int)n;
  P.ib = bit_length(n - 1) > 0 ? bit_length(n - 1) : 1;
  P.total_bits = 32 + P.ib;
  // class-major storage when a level's classes lie farther apart than its neighbouring anchors (NCHW planes)
  P.class_major = ml && strides[3] > strides[2];
  P.thr = thr;
  P.valid_thr = valid_thr;
  P.mask = static_cast<const uint8_t*>(mask);
  P.agnostic = agnostic;
  P.img = reinterpret_cast<Image*>(ws + w.img);
  P.hist = reinterpret_cast<uint32_t*>(ws + w.hist);
  P.keys = reinterpret_cast<uint32_t*>(ws + w.keys);
  P.cls_of = reinterpret_cast<int32_t*>(ws + w.cls_of);
  P.dist = reinterpret_cast<float*>(ws + w.dist);
  P.list = reinterpret_cast<unsigned long long*>(ws + w.list);
  P.list_cap = (int)(n / 4);
  // the passes route decodes every anchor once when the candidates are at least a quarter of the anchors (val's
  // 8,192 of 5,040-8,400), each candidate's own logits when they are fewer (predict's 512 of 8,400: the dense pass
  // took twice as long); the finish and cluster routes decode each candidate's own
  P.dense = pl.route == kPasses && 4LL * k >= a;
  P.box_vec = vec_boxes(n_levels, ptrs, strides, map_type);
  P.cand = reinterpret_cast<unsigned long long*>(ws + w.cand);
  P.sorted = reinterpret_cast<unsigned long long*>(ws + w.sorted);
  P.vals = static_cast<float*>(vals);
  P.bidx = static_cast<long long*>(bidx);
  P.cls = static_cast<float*>(cls);
  P.boxes = static_cast<float*>(boxes);
  P.shifted = static_cast<float*>(shifted);
  P.valid = static_cast<uint8_t*>(valid);

  P.passes = pl.route == kPasses;
  // the per-image state and the histograms zeroed, then the score pass, which counts the first digit
  if ((err = cudaMemsetAsync(ws + w.img, 0, w.keys - w.img, st)) != cudaSuccess) return static_cast<int>(err);
  if ((err = launch_score(P, pl.score, b, a, n, st)) != cudaSuccess || score_only) return static_cast<int>(err);
  if (pl.route == kFinish) {  // then a finishing CTA group an image
    err = reg_max == 16 ? launch_finish<16>(P, pl, b, st) : launch_finish<0>(P, pl, b, st);
    return static_cast<int>(err);
  }
  if (pl.route == kCluster) {  // then a cluster an image
    err = reg_max == 16 ? launch_cluster<16>(P, pl, b, device, st) : launch_cluster<0>(P, pl, b, device, st);
    return static_cast<int>(err);
  }
  // the passes: the score pass's last CTA of each image selected the first digit; the list of the entries at or
  // above that bin, then the later digits, each pass's last CTA selecting
  const unsigned row_ctas = (unsigned)((n + kPerCtaRow - 1) / kPerCtaRow);
  compact<<<dim3(row_ctas, b), kThreads, 0, st>>>(P);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int passes = (P.total_bits + kDigit - 1) / kDigit;
  for (int pass = 1; pass < passes; ++pass) {
    hist_pass<<<dim3(row_ctas, b), kThreads, 0, st>>>(P, pass);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  collect<<<dim3(row_ctas, b), kThreads, 0, st>>>(P);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const dim3 sort_grid((unsigned)(P.p2 / kChunk), b);
  sort_chunks<<<sort_grid, kChunk, 0, st>>>(P);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  rank_chunks<<<sort_grid, kChunk, 0, st>>>(P);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (P.dense) {
    const dim3 grid((unsigned)((4 * a + 127) / 128), b);
    if (reg_max == 16)
      dfl_all<16><<<grid, 128, 0, st>>>(P);
    else
      dfl_all<0><<<grid, 128, 0, st>>>(P);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 decode_grid((unsigned)((4LL * k + 127) / 128), b);
  if (reg_max == 16)
    decode<16><<<decode_grid, 128, 0, st>>>(P);
  else
    decode<0><<<decode_grid, 128, 0, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One call of K3 down the route the shapes pick (`plan`); *taken gets the route run (0 passes, 1 finish, 2 cluster),
// which the wrapper counts
extern "C" int select_decode(int n_levels, const unsigned long long* ptrs, const long long* strides, const int* hw,
                             const float* stride_px, int map_type, int b, int nc, int reg_max, int ml, int k,
                             float thr, float valid_thr, int score_type, const void* mask, int agnostic,
                             void* workspace, long long workspace_bytes, void* vals, void* bidx, void* cls,
                             void* boxes, void* shifted, void* valid, int device, void* stream, int* taken) {
  return run(n_levels, ptrs, strides, hw, stride_px, map_type, b, nc, reg_max, ml, k, thr, valid_thr, score_type,
             mask, agnostic, workspace, workspace_bytes, vals, bidx, cls, boxes, shifted, valid, device, stream, false,
             -1, taken);
}

// select_decode down a named route (0 passes, 1 finish, 2 cluster; -1 plan's pick), cudaErrorInvalidValue where the
// route cannot take these shapes; *taken gets the route run. For timing the routes on the same inputs
// (chip_smoke.py, tools/k3_profile.py) and for the card tests; the path calls select_decode.
extern "C" int select_decode_pick(int n_levels, const unsigned long long* ptrs, const long long* strides,
                                  const int* hw, const float* stride_px, int map_type, int b, int nc, int reg_max,
                                  int ml, int k, float thr, float valid_thr, int score_type, const void* mask,
                                  int agnostic, void* workspace, long long workspace_bytes, void* vals, void* bidx,
                                  void* cls, void* boxes, void* shifted, void* valid, int device, void* stream,
                                  int route, int* taken) {
  return run(n_levels, ptrs, strides, hw, stride_px, map_type, b, nc, reg_max, ml, k, thr, valid_thr, score_type,
             mask, agnostic, workspace, workspace_bytes, vals, bidx, cls, boxes, shifted, valid, device, stream, false,
             route, taken);
}

// select_decode's memset and score pass alone (down route `route`, as select_decode_pick's: the passes route's
// score pass also selects the first digit), for timing the score pass; the outputs are not written
extern "C" int select_decode_score(int n_levels, const unsigned long long* ptrs, const long long* strides,
                                   const int* hw, const float* stride_px, int map_type, int b, int nc, int reg_max,
                                   int ml, int k, float thr, float valid_thr, int score_type, const void* mask,
                                   int agnostic, void* workspace, long long workspace_bytes, void* vals, void* bidx,
                                   void* cls, void* boxes, void* shifted, void* valid, int device, void* stream,
                                   int route, int* taken) {
  return run(n_levels, ptrs, strides, hw, stride_px, map_type, b, nc, reg_max, ml, k, thr, valid_thr, score_type,
             mask, agnostic, workspace, workspace_bytes, vals, bidx, cls, boxes, shifted, valid, device, stream, true,
             route, taken);
}

extern "C" const char* select_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
