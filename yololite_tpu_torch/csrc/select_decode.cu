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
// Design: a sequence of kernels on the caller's stream, no host sync, every
// buffer in one workspace that the wrapper allocates with torch:
//   store:   the level descriptors, passed by value (32 a launch), written
//            into the workspace (no host-to-device copy, so a CUDA graph
//            captures it);
//   score:   one pass over the class logits, read in the order they lie:
//            multi-label, one thread an entry with anchors along the threads
//            for NCHW planes (in a class-major order of the row), one thread
//            a 16-byte run of an anchor's classes for channel-contiguous maps
//            (the row's own order);
//            single-label, one thread an anchor looping over the classes
//            (16-byte loads where the classes lie contiguous and aligned).
//            Writes each entry's 32-bit order key of its gated score (and,
//            single-label, the argmax class) and counts the keys' top
//            11 bits in a shared-memory histogram (warp-aggregated with
//            __match_any_sync: ties are the rule at low conf), added into a
//            per-image histogram in device memory;
//   select:  per image, the last CTA of a pass to add its histogram reads
//            it into shared memory and one warp finds the bin that holds the
//            K-th largest entry, on the composite (key << ib) | (N - 1 -
//            index):
//            all composites differ, so a radix select over them in digits of
//            11 bits (5 passes at N < 2^20) ends on exactly K entries, the
//            lowest indices winning ties. A pass per digit (`hist`), each
//            skipped once its image is decided. After the first digit, an
//            image whose entries at or above the K-th entry's bin number at
//            most N / 4 lists their composites (`compact`): the later passes
//            and the collection read that list, not the key row;
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
//
// Bound on an H100 SXM (chip_smoke.py k3_bound_ms): the function reads each
// class logit once, the 4R box logits of each distinct candidate anchor and
// writes 49 bytes per candidate: at predict's B 32 fp32 (640 x 640) some 86
// MB of class logits, 27 us at 3.35 TB/s. This design moves more: the keys
// (4 bytes an entry) are written once and read by the first list and, when
// the list would be long, by every radix pass and the collection; a
// candidate's box logits in NCHW planes are 64 separate sectors. It runs at
// 5-18x the bound, mostly in the score pass and in the launch and latency of
// the later passes (PERF.md; tools/k3_profile.py splits it by kernel).
//
// C interface, bound with ctypes (pointers and the stream are void*, ints are
// int): launches on the caller's stream of the caller's device, allocates
// nothing, does not synchronise, and returns the first CUDA error, that of
// the launches included.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dfl_math.cuh"

namespace {

constexpr int kDigit = 11;             // bits a radix pass decides
constexpr int kBins = 1 << kDigit;     // histogram bins a pass
constexpr int kThreads = 256;          // threads of the streaming kernels
constexpr int kPerCtaRow = 4096;       // entries a CTA of the key passes takes
constexpr int kPerCtaAnchor = 256;     // anchors a CTA of the single-label score pass takes: one a thread
constexpr int kLevelsPerStore = 32;    // level descriptors a store launch carries
constexpr int kChunk = 1024;           // candidates a CTA of the sort orders
constexpr unsigned kFull = 0xffffffffu;

struct Level {
  const void* ptr;           // the level's (B, H, W, C) map
  long long sb, sh, sw, sc;  // its element strides
  int h, w;
  int off;                   // its first anchor in the image's anchor order
  float stride;              // its stride in pixels
};

struct LevelChunk {
  Level lv[kLevelsPerStore];
  int first, n;
};

struct Image {                // one image's select state
  unsigned long long prefix;  // the composite's bits decided so far (the threshold once done)
  unsigned int need;          // entries still to take at the decided prefix
  unsigned int done;          // 1 once the threshold is final
  unsigned int count;         // entries collected
  unsigned int compact;       // 1 when the passes after the first read the compacted list, not the key row
  unsigned int listed;        // entries in the compacted list
  unsigned int arrived;       // CTAs of the running pass that have added their histogram
};

struct Params {
  const Level* levels;
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
  int dense;               // decode every anchor once (K >= A / 4), else each candidate
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

__global__ void store_levels(LevelChunk chunk, Level* levels) {
  if ((int)threadIdx.x < chunk.n) levels[chunk.first + threadIdx.x] = chunk.lv[threadIdx.x];
}

__global__ void init_images(Params P) {
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    Image im;
    im.prefix = 0;
    im.need = (unsigned)P.k;
    im.done = 0;
    im.count = 0;
    im.compact = 0;
    im.listed = 0;
    im.arrived = 0;
    P.img[b] = im;
  }
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) P.hist[(size_t)b * kBins + i] = 0;
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
  const unsigned need = im->need;
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
    im->need = left;
    if (s_h[bin] == left || lo == 0)
      im->done = 1;  // every entry of the bin is taken: the threshold is the prefix
    else if (pass == 0 && cum + s_h[bin] <= (unsigned)P.list_cap)
      im->compact = 1;  // the entries at or above this bin, few enough to list
  }
}

// single-label: one thread an anchor, the classes in turn: key of the gated max, the argmax, digit 0
__global__ void __launch_bounds__(kThreads) score_anchor(Params P) {
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
      float best = 0.0f;
      int arg = 0;
#pragma unroll 8
      for (int c = 0; c < P.nc; ++c) {
        float s = torch_sigmoid(load_map(L, P.map_type, o + c * L.sc), P.score_type);
        if (P.mask && !P.mask[c]) s = 0.0f;
        if (c == 0 || (!isnan(best) && (isnan(s) || s > best))) {  // amax / argmax: NaN first, then the first max
          best = s;
          arg = c;
        }
      }
      const uint32_t key = order_key(gate(P, best));
      P.keys[(size_t)b * P.n + a] = key;
      P.cls_of[(size_t)b * P.a + a] = arg;
      bin = (int)(key >> shift);
    }
    count_bin(s_hist, bin);
  }
  __syncthreads();
  flush_hist(s_hist, P.hist + (size_t)b * kBins, kBins);
  if (last_to_arrive(P.img + b)) select_bin(P, b, 0, s_hist);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// single-label over channel-contiguous maps whose class logits start on 16 bytes: one thread an anchor, its class
// logits read 16 bytes at a time (so each sector a warp fetches is used at once, not re-read after other warps
// have evicted it: thread-per-anchor scalar reads of such maps ran some 3x slower)
template <typename T>
__global__ void __launch_bounds__(kThreads) score_anchor_vec(Params P) {
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
    float best = 0.0f;
    int arg = 0;
    for (int v0 = 0; v0 < P.nc; v0 += kPer) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + v0);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int c = v0 + u;
        float s = torch_sigmoid(to_float(vals[u]), P.score_type);
        if (P.mask && !P.mask[c]) s = 0.0f;
        if (c == 0 || (!isnan(best) && (isnan(s) || s > best))) {  // amax / argmax: NaN first, then the first max
          best = s;
          arg = c;
        }
      }
    }
    const uint32_t key = order_key(gate(P, best));
    P.keys[(size_t)b * P.n + a] = key;
    P.cls_of[(size_t)b * P.a + a] = arg;
    bin = (int)(key >> shift);
  }
  count_bin(s_hist, bin);
  __syncthreads();
  flush_hist(s_hist, P.hist + (size_t)b * kBins, kBins);
  if (last_to_arrive(P.img + b)) select_bin(P, b, 0, s_hist);
}

// multi-label: one thread an entry, in storage order: key of the gated score, digit 0
__global__ void __launch_bounds__(kThreads) score_entry(Params P) {
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
  __syncthreads();
  flush_hist(s_hist, P.hist + (size_t)b * kBins, kBins);
  if (last_to_arrive(P.img + b)) select_bin(P, b, 0, s_hist);
}

// multi-label over channel-contiguous maps whose class logits start on 16 bytes: one thread a 16-byte run of one
// anchor's class logits (the row's own order), its keys stored 16 bytes at a time
template <typename T>
__global__ void __launch_bounds__(kThreads) score_entry_vec(Params P) {
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
      const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const T*>(L.ptr) +
                                                        offset_of(L, b, y, x, 4 * P.reg_max + c0));
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
  __syncthreads();
  flush_hist(s_hist, P.hist + (size_t)b * kBins, kBins);
  if (last_to_arrive(P.img + b)) select_bin(P, b, 0, s_hist);
}

// a later radix pass: counts the digit of each entry (of the list, or the key row) whose decided bits match the
// prefix; the pass's last CTA selects
__global__ void __launch_bounds__(kThreads) hist_pass(Params P, int pass) {
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
__global__ void __launch_bounds__(kThreads) compact(Params P) {
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
__global__ void __launch_bounds__(kThreads) collect(Params P) {
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
__global__ void __launch_bounds__(kChunk) sort_chunks(Params P) {
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
__global__ void __launch_bounds__(kChunk) rank_chunks(Params P) {
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
__global__ void __launch_bounds__(128) dfl_all(Params P) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int a = t >> 2, side = t & 3;
  if (a >= P.a) return;
  const Level& L = P.levels[level_of_anchor(P, a)];
  const int local = a - L.off, y = local / L.w, x = local - y * L.w;
  P.dist[((size_t)b * P.a + a) * 4 + side] = dfl_side<RM>(P, L, offset_of(L, b, y, x, 0), side);
}

// one thread a (candidate, side): the side's DFL distance (read from P.dist when dense, else computed) and its box
// coordinate (x1 from the left distance, y1 the top, x2 the right, y2 the bottom); the side-0 thread writes the
// value, index, class and valid
template <int RM>
__global__ void __launch_bounds__(128) decode(Params P) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = t >> 2, side = t & 3;
  if (r >= P.k) return;
  const size_t row = (size_t)b * P.k + r;
  const unsigned long long c = P.sorted[row];
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

int bit_length(long long v) {
  int n = 0;
  while (v > 0) {
    ++n;
    v >>= 1;
  }
  return n;
}

long long round_up(long long v, long long to) { return (v + to - 1) / to * to; }

struct Layout {
  long long levels, img, hist, keys, cls_of, dist, list, cand, sorted, total;
};

Layout layout(int n_levels, int b, long long a, int nc, int ml, int k) {
  const long long n = ml ? a * nc : a;
  const long long p2 = round_up(k, kChunk);  // whole chunks for the sort
  Layout w;
  long long at = 0;
  w.levels = at;
  at = round_up(at + (long long)n_levels * sizeof(Level), 256);
  w.img = at;
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

template <typename T>
void launch_score_vec_t(const Params& P, bool entries, dim3 grid, cudaStream_t st) {
  if (entries)
    score_entry_vec<T><<<grid, kThreads, 0, st>>>(P);
  else
    score_anchor_vec<T><<<grid, kThreads, 0, st>>>(P);
}

// the 16-byte score pass of a map type: multi-label (`entries`) or single-label
cudaError_t launch_score_vec(const Params& P, int map_type, bool entries, dim3 grid, cudaStream_t st) {
  if (map_type == 0)
    launch_score_vec_t<float>(P, entries, grid, st);
  else if (map_type == 1)
    launch_score_vec_t<__nv_bfloat16>(P, entries, grid, st);
  else
    launch_score_vec_t<__half>(P, entries, grid, st);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long select_decode_workspace_bytes(int n_levels, int b, long long a, int nc, int ml, int k) {
  return layout(n_levels, b, a, nc, ml, k).total;
}

extern "C" int select_decode(int n_levels, const unsigned long long* ptrs, const long long* strides, const int* hw,
                             const float* stride_px, int map_type, int b, int nc, int reg_max, int ml, int k,
                             float thr, float valid_thr, int score_type, const void* mask, int agnostic,
                             void* workspace, long long workspace_bytes, void* vals, void* bidx, void* cls,
                             void* boxes, void* shifted, void* valid, int device, void* stream) {
  if (n_levels < 1 || b < 0 || nc < 1 || reg_max < 1 || reg_max > kMaxReg || k < 0 || map_type < 0 ||
      map_type > 2 || score_type < 0 || score_type > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  long long a = 0;
  for (int l = 0; l < n_levels; ++l) a += (long long)hw[2 * l] * hw[2 * l + 1];
  const long long n = ml ? a * nc : a;
  if (k > n || n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || k == 0) return 0;
  const Layout w = layout(n_levels, b, a, nc, ml, k);
  if (workspace_bytes < w.total) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);  // nvcc's own runtime: its current device is not PyTorch's
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* ws = static_cast<char*>(workspace);

  Params P;
  P.levels = reinterpret_cast<const Level*>(ws + w.levels);
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
  // decode every anchor once when the candidates are at least a quarter of the anchors (val's 8,192 of 5,040-8,400),
  // each candidate's own logits when they are fewer (predict's 512 of 8,400: the dense pass took twice as long)
  P.dense = 4LL * k >= a;
  P.cand = reinterpret_cast<unsigned long long*>(ws + w.cand);
  P.sorted = reinterpret_cast<unsigned long long*>(ws + w.sorted);
  P.vals = static_cast<float*>(vals);
  P.bidx = static_cast<long long*>(bidx);
  P.cls = static_cast<float*>(cls);
  P.boxes = static_cast<float*>(boxes);
  P.shifted = static_cast<float*>(shifted);
  P.valid = static_cast<uint8_t*>(valid);

  // the level descriptors into the workspace, by value through the launches
  long long off = 0;
  for (int first = 0; first < n_levels; first += kLevelsPerStore) {
    LevelChunk chunk;
    chunk.first = first;
    chunk.n = n_levels - first < kLevelsPerStore ? n_levels - first : kLevelsPerStore;
    for (int i = 0; i < chunk.n; ++i) {
      const int l = first + i;
      Level& L = chunk.lv[i];
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
    store_levels<<<1, kLevelsPerStore, 0, st>>>(chunk, const_cast<Level*>(P.levels));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  init_images<<<b, 256, 0, st>>>(P);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const unsigned row_ctas = (unsigned)((n + kPerCtaRow - 1) / kPerCtaRow);
  const bool vec = vec_classes(n_levels, ptrs, strides, map_type, nc, reg_max);
  if (ml && vec)
    err = launch_score_vec(P, map_type, true, dim3(row_ctas, b), st);
  else if (ml)
    score_entry<<<dim3(row_ctas, b), kThreads, 0, st>>>(P);
  else if (vec)
    err = launch_score_vec(P, map_type, false, dim3((unsigned)((a + kThreads - 1) / kThreads), b), st);
  else
    score_anchor<<<dim3((unsigned)((a + kPerCtaAnchor - 1) / kPerCtaAnchor), b), kThreads, 0, st>>>(P);
  if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // the score pass counted the first digit and its last CTA selected; list the entries at or above that bin, then
  // the later digits, each pass's last CTA selecting
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

extern "C" const char* select_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
