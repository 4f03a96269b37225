// Exact greedy NMS for K > 1024 candidates plus the compaction of the kept rows, for Hopper (sm_90a), in one kernel.
//
// Replaces the XLA ops of yololite_tpu/ops/nms.py:164 `_blocked_keep` (as
// `_keep_large_k`, :245, picks it) followed by :281 `_finalize`, as
// `nms_from_feats` step 5 (:496-507) and `non_max_suppression` (:347-350)
// call them when K > 1024. Inputs, per image of the batch, all contiguous:
// `shifted` (B, K, 4) fp32 class-offset xyxy boxes, score-sorted; `boxes`
// (B, K, 4) fp32, the same boxes unshifted; `vals` (B, K) fp32 scores; `cls`
// (B, K) fp32 classes; `valid` (B, K) bool. Output `out` (B, max_det, 6) fp32
// rows [x1, y1, x2, y2, score, class]: the kept candidates with score > 0, in
// candidate order, then rows of zeros. `workspace` (B, K, 4) fp32 holds the
// kept boxes that do not fit in shared memory. Walking the candidates in
// order, a kept one drops every later one with iou > thr (strict, fp32); the
// output is bit-equal to
// _finalize(boxes, vals, cls, _blocked_keep(shifted, valid, thr), max_det).
//
// Bound on an H100 SXM (chip_smoke.py k4_bound_ms, computed from each run's
// inputs): the function reads 41 bytes per candidate up to the walk's stop
// and writes 24 per output row, and the data needs the IoU of each kept row
// with the later candidates up to the stop (some 14 fp32 operations each).
// On val's inputs (B 16, K 8,192, max_det 300, the 300th row out at candidate
// 779 of each image) that is 0.4 us, by operations. What bounds a real kernel
// is the walk's chain of dependent steps and barriers, not either rate.
//
// Design: a thread-block cluster of C CTAs of 1024 threads per image, walking
// the candidates in steps of S = 512 with no host sync. C is the largest size
// (up to 16) of which the card runs all B clusters at once
// (cudaOccupancyMaxActiveClusters; `cluster_for`): 6 at val's B 16 on an H100,
// 16 at B 1. Each step:
//   load:    every CTA puts the step's S boxes and areas into its own shared
//            memory, with the valid and score > 0 bits (a ballot per 32); the
//            next step's are loaded into registers meanwhile, and the step's
//            unshifted boxes and classes go to shared memory by cp.async for
//            the compaction.
//   cross:   the kept boxes of earlier steps are dealt round robin to the
//            cluster's CTAs (kept row g to rank g % C, in shared memory, the
//            overflow past 100 KB in `workspace`), so each CTA tests every
//            valid candidate of the step against its own share, 2 threads a
//            candidate, each stopping at its first suppressor. Each CTA writes
//            its hits into a slot of every CTA (distributed shared memory, two
//            slot sets used in turn); after a cluster barrier every CTA ORs the
//            slots into the step's removed words.
//   phase A: row i of the step's suppression bitmask goes to rank i % C (the
//            triangle balanced), a warp a row and a ballot per 32 columns, as
//            in K1; rows removed on entry are not built. Each row is stored
//            into the bitmask of rank 0 (st.shared::cluster through
//            `map_shared_rank`); then a cluster barrier.
//   phase B: one warp of rank 0 resolves the keep words from its local
//            bitmask (`resolve_keep`: a warp-wide OR fixpoint per word of 32,
//            no remote load) with the counts the compaction needs, and writes
//            them into every CTA; then a cluster barrier.
//   compact: the kept boxes join their rank's share, and the emitted rows go to
//            the output at their rank (row e by rank e % C).
// The walk stops after the step in which max_det rows have been emitted:
// suppression only acts forward, so later candidates change none of the
// first max_det rows. Every decision that ends a step early or skips a phase
// is taken from data that every CTA of the cluster holds, so all of them meet
// every barrier.
//
// What that does about the design it replaced (one CTA of 1024 per image,
// walking blocks of 1024, 0.14-0.18 ms on these inputs, PERF.md): (1) one SM
// per image left 116 of 132 SMs idle at B 16; the cluster spreads an image
// over C SMs. (2) Phase A built the whole 1,024-row triangle even when the
// walk stops at candidate 779 (val) or 330 (the crowded scene at iou 0.7);
// steps of 512 stop within 512 candidates of the walk's end. (3) The cross
// pass tested each candidate against all kept boxes in one thread on one SM;
// it is split over the C shares. (4) Phase B walked the kept rows one by one,
// a shared-memory load in each link of the chain; the fixpoint settles a word
// of 32 rows in a few warp ORs. (5) The IoU test (`iou_above` below) decides
// almost every pair with two fused multiply-adds, keeping the bits of the
// IEEE quotient's comparison.
//
// C interface, bound with ctypes (pointers and the stream are void*, ints are
// int): launches on the caller's stream of the caller's device, allocates
// nothing, does not synchronise, and returns the first CUDA error, that of
// the launch included. `blocked_nms_finalize_ex` takes the cluster size
// (1-16; 0 chooses it from B), for measurements and tests;
// `blocked_nms_plan` reports what a launch uses, with
// cudaOccupancyMaxActiveClusters. Built with -DK4_PHASE_CLOCKS, the kernel
// writes thread 0's clock64 per phase into the workspace
// (tools/k4_timing.py --phases).

#include <cooperative_groups.h>

#include <algorithm>
#include <cmath>
#include <limits>

#include "nms_device.cuh"

namespace cg = cooperative_groups;

namespace {

using nms::kFull;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;                  // 8 is portable; 16 needs the non-portable attribute
constexpr int kStep = 512;                       // candidates a step (256 ran slower on an H100 at B 1-16, PERF.md)
constexpr size_t kShareBytes = 100 * 1024;       // shared memory for a CTA's share of the kept boxes
constexpr int kShareCap = kShareBytes / (sizeof(float4) + sizeof(float));
constexpr int kMaxDevices = 64;

// Dynamic shared memory of one CTA with `cap` kept boxes in its share.
size_t smem_bytes(int cap) {
  constexpr int S = kStep, H = S / 32;
  return (2 * S + (size_t)cap) * sizeof(float4) + (3 * S + (size_t)cap) * sizeof(float) +
         ((size_t)S * (H + 1) + (2 * kMaxCluster + 7) * H + 2) * sizeof(uint32_t);
}

// iou(a, b) > thr with the bits of box_iou's `> thr` (the same w, h, inter, area sum and 1e-7, as nms::iou_above
// forms them), mostly without the division: for den > 0 the fused multiply-add rounds once, so the sign of
// fma(-thr, den, inter) is the sign of inter / den - thr, and that of fma(-thr_up, den, inter) the sign of
// inter / den - thr_up, thr_up the float after thr. Below thr the quotient rounds to at most thr; above thr_up it
// rounds to at least thr_up. The one-ulp band between them, den <= 0, and NaN operands take the IEEE division.
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b, float area_b, float thr, float thr_up) {
  const float w = nms::max_nan(__fsub_rn(nms::min_nan(a.z, b.z), nms::max_nan(a.x, b.x)), 0.0f);
  const float h = nms::max_nan(__fsub_rn(nms::min_nan(a.w, b.w), nms::max_nan(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f);
  const float below = __fmaf_rn(-thr, den, inter), above = __fmaf_rn(-thr_up, den, inter);
  bool hit = above > 0.0f;
  if (!((den > 0.0f) & ((below < 0.0f) | hit))) hit = __fdiv_rn(inter, den) > thr;  // one branch, rarely taken
  return hit;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}

// Phase B, one whole warp: the keep words of a step from its removed words and its bitmask (row i at
// s_sup32[i * (H + 1)], 32-bit words from the one that holds i; the odd stride keeps a column's reads free of bank
// conflicts). Word by word, every lane holding every word's removed rows: lane j takes row 32 w + j's words when
// that row is alive, and the word's keep is the fixpoint of keep = alive & ~OR(rows in keep), one warp OR a round
// (a fixpoint of this triangular recurrence is the greedy keep, and round n settles row n at least); then one warp
// OR for each later word takes the kept rows' words into its removed rows. The word loop is unrolled (the words
// live in registers, and one word's ORs overlap the next one's loads); the rounds loop is not: unrolled too, the
// kernel's code grew several times over and phase B ran slower whenever that code was not in the instruction cache.
// Then s_info gets, for the compaction: [0, H) the keep words, [H, 2H) the kept rows before each word, [2H, 3H) the
// emitted rows (kept with score > 0, s_pos) before each word, [3H] and [3H + 1] the step's kept and emitted rows.
template <int H>
__device__ __forceinline__ void resolve_keep(const uint32_t* s_sup32, const uint32_t* s_removed32,
                                             const uint32_t* s_pos, uint32_t* s_info) {
  const int lane = threadIdx.x & 31;
  uint32_t removed[H];
  uint32_t kept_word = 0;
#pragma unroll
  for (int w = 0; w < H; ++w) removed[w] = s_removed32[w];
#pragma unroll
  for (int w = 0; w < H; ++w) {
    const uint32_t alive = ~removed[w];
    if (alive == 0) continue;
    const bool mine = (alive >> lane) & 1u;
    const uint32_t* row = s_sup32 + (size_t)(32 * w + lane) * (H + 1);
    uint32_t r[H];
#pragma unroll
    for (int l = w; l < H; ++l) r[l] = mine ? row[l] : 0u;
    uint32_t keep = alive;
#pragma unroll 1
    for (int round = 0; round < 32; ++round) {  // round n settles row n at least: 31 rounds reach the greedy keep
      const uint32_t next = alive & ~__reduce_or_sync(kFull, ((keep >> lane) & 1u) ? r[w] : 0u);
      if (next == keep) break;
      keep = next;
    }
    if (lane == w) kept_word = keep;
    const bool kept = (keep >> lane) & 1u;
#pragma unroll
    for (int l = w + 1; l < H; ++l) removed[l] |= __reduce_or_sync(kFull, kept ? r[l] : 0u);
  }
  if (lane < H) s_info[lane] = kept_word;
  int kept = __popc(kept_word), emit = __popc(kept_word & (lane < H ? s_pos[lane] : 0u));
  for (int d = 1; d < 32; d <<= 1) {  // inclusive prefix over the words
    const int kd = __shfl_up_sync(kFull, kept, d), ed = __shfl_up_sync(kFull, emit, d);
    if (lane >= d) {
      kept += kd;
      emit += ed;
    }
  }
  const int kept_before = __shfl_up_sync(kFull, kept, 1), emit_before = __shfl_up_sync(kFull, emit, 1);
  if (lane < H) {
    s_info[H + lane] = lane ? kept_before : 0;
    s_info[2 * H + lane] = lane ? emit_before : 0;
  }
  if (lane == H - 1) {
    s_info[3 * H] = kept;
    s_info[3 * H + 1] = emit;
  }
}

#ifdef K4_PHASE_CLOCKS  // tools/k4_timing.py --phases: thread 0's clock64 per phase, summed over the steps
#define K4_CLOCK(i)                        \
  if (t == 0) {                            \
    const long long now = clock64();       \
    clocks[i] += now - clock_last;         \
    clock_last = now;                      \
  }
#else
#define K4_CLOCK(i)
#endif

__global__ void __launch_bounds__(kThreads, 1)
blocked_nms_cluster_kernel(const float4* __restrict__ shifted, const float4* __restrict__ boxes,
                           const float* __restrict__ vals, const float* __restrict__ cls,
                           const uint8_t* __restrict__ valid, float* __restrict__ out, float4* __restrict__ spill,
                           int k, float thr, float thr_up, int max_det, int cap) {
  constexpr int S = kStep;
  constexpr int H = S / 32;        // 32-bit words of one step's bits
  constexpr int P = kThreads / S;  // threads a candidate in the cross pass
  static_assert(P >= 1 && H <= 32, "a step is at most 1024 candidates");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank()), n_ranks = static_cast<int>(cluster.num_blocks());

  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_box = reinterpret_cast<float4*>(smem);
  float4* s_out_box = s_box + S;     // the step's unshifted boxes, score and class (cp.async), for the output rows
  float4* s_share = s_out_box + S;  // this rank's kept boxes: kept row m * C + rank
  float* s_area = reinterpret_cast<float*>(s_share + cap);
  float* s_share_area = s_area + S;
  float* s_out_val = s_share_area + cap;
  float* s_out_cls = s_out_val + S;
  uint32_t* s_sup32 = reinterpret_cast<uint32_t*>(s_out_cls + S);  // S rows of H + 1; rank 0's is used
  uint32_t* s_slots = s_sup32 + (size_t)S * (H + 1);  // [2][kMaxCluster][H] the cross pass's hits by rank
  uint32_t* s_removed32 = s_slots + 2 * kMaxCluster * H;
  uint32_t* s_info = s_removed32 + H;  // 3 H + 2 words from phase B (resolve_keep)
  uint32_t* s_valid = s_info + 3 * H + 2;
  uint32_t* s_pos = s_valid + H;  // score > 0
  uint32_t* s_cross = s_pos + H;  // this rank's cross-pass hits
  uint32_t* lead_sup32 = cluster.map_shared_rank(s_sup32, 0);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t b = blockIdx.x / n_ranks;
#ifdef K4_PHASE_CLOCKS
  long long* clock_out = reinterpret_cast<long long*>(spill);  // image 0's workspace: rank r's 10 clocks at 10 r
  long long clock_start = clock64(), clock_last = clock_start, clocks[8] = {}, steps = 0;
#endif
  shifted += b * k;
  boxes += b * k;
  vals += b * k;
  cls += b * k;
  valid += b * k;
  spill += b * k;
  out += b * (size_t)max_det * 6;

  // candidate lo + t of the next step, loaded a step ahead (threads t < S) and compared only when it is used
  float4 next_q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  uint8_t next_valid = 0;
  float next_val = 0.0f;
  auto fetch = [&](int lo) {
    const int j = lo + t;
    if (t < S && j < k) {
      next_q = shifted[j];
      next_valid = valid[j];
      next_val = vals[j];
    } else {
      next_q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      next_valid = 0;
      next_val = 0.0f;
    }
  };
  fetch(0);
  cluster.sync();  // every CTA of the cluster has started before any reaches into another's shared memory
  K4_CLOCK(0)

  int n_kept = 0, n_emit = 0, pass = 0;  // the same in every thread of the cluster
  for (int lo = 0; lo < k && n_emit < max_det; lo += S) {
    const int kb = min(S, k - lo);  // candidates in this step

    // ---- load ----
    const bool ok = next_valid != 0;
    if (t < S) {
      s_box[t] = next_q;
      s_area[t] = nms::box_area(next_q);
      s_out_val[t] = next_val;
      const unsigned vb = __ballot_sync(kFull, ok), pb = __ballot_sync(kFull, next_val > 0.0f);
      if (lane == 0) {
        s_valid[warp] = vb;
        s_pos[warp] = pb;
        s_cross[warp] = 0;
      }
      if (t < kb) {  // waited for by this thread alone, in the compaction (or here, in the next step)
        asm volatile("cp.async.wait_all;" ::: "memory");  // a step that ended early left its copies in flight
        cp_async(s_out_box + t, boxes + lo + t, 16);
        cp_async(s_out_cls + t, cls + lo + t, 4);
      }
    }
    fetch(lo + S);
    if (!__syncthreads_or(ok)) continue;  // nothing valid: nothing kept, nothing suppressed
    K4_CLOCK(1)

    // ---- cross pass against this rank's share of the boxes kept in earlier steps ----
    if (n_kept > 0) {
      const int n_share = (n_kept + n_ranks - 1 - rank) / n_ranks;
      const int c = t / P;
      if ((s_valid[c >> 5] >> (c & 31)) & 1u) {
        const float4 q = s_box[c];
        const float qa = s_area[c];
        for (int m = t % P; m < n_share; m += P) {
          float4 p;
          float pa;
          if (m < cap) {
            p = s_share[m];
            pa = s_share_area[m];
          } else {
            p = __ldcg(spill + (size_t)m * n_ranks + rank);
            pa = nms::box_area(p);
          }
          if (iou_above(p, pa, q, qa, thr, thr_up)) {
            atomicOr(&s_cross[c >> 5], 1u << (c & 31));
            break;
          }
        }
      }
      __syncthreads();
      uint32_t* slots = s_slots + (pass & 1) * kMaxCluster * H;  // a slot set is rewritten two passes later
      if (t < n_ranks * H) *cluster.map_shared_rank(slots + rank * H + t % H, t / H) = s_cross[t % H];
      cluster.sync();
      if (t < H) {
        uint32_t hit = 0;
        for (int i = 0; i < n_ranks; ++i) hit |= slots[i * H + t];
        s_removed32[t] = ~s_valid[t] | hit;
      }
      ++pass;
    } else if (t < H) {
      s_removed32[t] = ~s_valid[t];
    }
    __syncthreads();
    const bool alive = t < S && !((s_removed32[t >> 5] >> (t & 31)) & 1u);
    if (!__syncthreads_or(alive)) continue;  // every valid candidate suppressed
    K4_CLOCK(2)

    // ---- phase A: row i by rank i % C, stored into rank 0's bitmask ----
    for (int i = rank + n_ranks * warp; i < kb; i += n_ranks * kWarps) {
      if ((s_removed32[i >> 5] >> (i & 31)) & 1u) continue;  // the same in every lane
      const float4 bi = s_box[i];
      const float ai = s_area[i];
      uint32_t mine = 0;
      for (int c = i >> 5; c < H; ++c) {  // the row's words from the one that holds i, as phase B reads them
        const int j = 32 * c + lane;
        const bool hit = (j > i) & (j < kb) & iou_above(bi, ai, s_box[j], s_area[j], thr, thr_up);
        const unsigned bits = __ballot_sync(kFull, hit);
        if (lane == c) mine = bits;
      }
      if (lane >= (i >> 5) && lane < H) lead_sup32[(size_t)i * (H + 1) + lane] = mine;
    }
    K4_CLOCK(3)
    cluster.sync();
    K4_CLOCK(4)

    // ---- phase B: one warp of rank 0 on its local bitmask; the keep words to every rank ----
    if (rank == 0 && warp == 0) {
      resolve_keep<H>(s_sup32, s_removed32, s_pos, s_info);
      __syncwarp();
      constexpr int kInfo = 3 * H + 2;
      for (int i = lane; i < (n_ranks - 1) * kInfo; i += 32)
        *cluster.map_shared_rank(s_info + i % kInfo, 1 + i / kInfo) = s_info[i % kInfo];
    }
    K4_CLOCK(5)
    cluster.sync();
    K4_CLOCK(6)

    // ---- compaction: kept boxes to their rank's share, kept rows with score > 0 to the output ----
    asm volatile("cp.async.wait_all;" ::: "memory");
    const int w = t >> 5;
    const uint32_t kw = t < S ? s_info[w] : 0u, below = (1u << (t & 31)) - 1u;
    if (t < kb && ((kw >> (t & 31)) & 1u)) {
      const int g = n_kept + s_info[H + w] + __popc(kw & below);
      if (g % n_ranks == rank) {
        const int m = g / n_ranks;
        if (m < cap) {
          s_share[m] = s_box[t];
          s_share_area[m] = s_area[t];
        } else {
          spill[g] = s_box[t];
        }
      }
      const int e = n_emit + s_info[2 * H + w] + __popc(kw & s_pos[w] & below);
      if (((s_pos[w] >> (t & 31)) & 1u) && e < max_det && e % n_ranks == rank) {
        const float4 bx = s_out_box[t];
        float* o = out + (size_t)e * 6;
        o[0] = bx.x;
        o[1] = bx.y;
        o[2] = bx.z;
        o[3] = bx.w;
        o[4] = s_out_val[t];
        o[5] = s_out_cls[t];
      }
    }
    n_kept += s_info[3 * H];
    n_emit += s_info[3 * H + 1];
    __syncthreads();  // the share and the spill written before the next cross pass reads them
    K4_CLOCK(7)
#ifdef K4_PHASE_CLOCKS
    ++steps;
#endif
  }

  asm volatile("cp.async.wait_all;" ::: "memory");  // no copy lands in shared memory after the CTA has left

  // ---- the rows past the last emitted one are zeros ----
  const int filled = min(n_emit, max_det);
  for (size_t i = (size_t)filled * 6 + (size_t)rank * kThreads + t; i < (size_t)max_det * 6;
       i += (size_t)n_ranks * kThreads)
    out[i] = 0.0f;
  cluster.sync();  // no CTA leaves while another may still address its shared memory
#ifdef K4_PHASE_CLOCKS
  if (t == 0 && b == 0) {
    for (int i = 0; i < 8; ++i) clock_out[10 * rank + i] = clocks[i];
    clock_out[10 * rank + 8] = steps;
    clock_out[10 * rank + 9] = clock64() - clock_start;
  }
#endif
}

int share_cap(int k, int cluster) { return std::min((k + cluster - 1) / cluster, kShareCap); }

cudaError_t configure(int device, int cluster, size_t smem) {
  // the kernel's attributes on this device, set once: the largest dynamic shared memory asked so far, and whether
  // clusters above 8 are allowed (a host call each, which a launch of a few microseconds should not repeat)
  static size_t smem_set[kMaxDevices] = {};
  static bool large_clusters[kMaxDevices] = {};
  cudaError_t err = cudaSuccess;
  if (smem > smem_set[device % kMaxDevices]) {
    err = cudaFuncSetAttribute(blocked_nms_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) smem_set[device % kMaxDevices] = smem;
  }
  if (err == cudaSuccess && cluster > 8 && !large_clusters[device % kMaxDevices]) {
    err = cudaFuncSetAttribute(blocked_nms_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    large_clusters[device % kMaxDevices] = err == cudaSuccess;
  }
  return err;
}

cudaLaunchConfig_t launch_config(cudaLaunchAttribute* attr, int b, int cluster, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * cluster);
  cfg.blockDim = dim3(kThreads);
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

int max_active_clusters(int device, int cluster, int cap) {
  const size_t smem = smem_bytes(cap);
  int n = 0;
  cudaError_t err = configure(device, cluster, smem);
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config(attr, 1, cluster, smem, nullptr);
    err = cudaOccupancyMaxActiveClusters(&n, blocked_nms_cluster_kernel, &cfg);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // a size the card cannot co-schedule: not an error of the launch to come
    return 0;
  }
  return n;
}

// The cluster size for a batch of b images: the largest C <= 16 of which the card holds b clusters at once
// (cudaOccupancyMaxActiveClusters at the largest shared memory a CTA asks for, so K does not change it; asked once
// per device and C), else 1: every image gets as many SMs as fit with all images in one wave.
int cluster_for(int b, int device) {
  static int known[kMaxDevices][kMaxCluster + 1] = {};  // max active clusters + 1; 0: not asked yet
  for (int c = kMaxCluster; c > 1; --c) {
    int& slot = known[device % kMaxDevices][c];
    if (slot == 0) slot = 1 + max_active_clusters(device, c, kShareCap);
    if (slot - 1 >= b) return c;
  }
  return 1;
}

cudaError_t launch(const void* shifted, const void* boxes, const void* vals, const void* cls, const void* valid,
                   void* out, void* workspace, int b, int k, float thr, int max_det, int cluster, int device,
                   cudaStream_t stream) {
  const int cap = share_cap(k, cluster);
  const size_t smem = smem_bytes(cap);
  cudaError_t err = configure(device, cluster, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(attr, b, cluster, smem, stream);
  return cudaLaunchKernelEx(&cfg, blocked_nms_cluster_kernel, static_cast<const float4*>(shifted),
                            static_cast<const float4*>(boxes), static_cast<const float*>(vals),
                            static_cast<const float*>(cls), static_cast<const uint8_t*>(valid),
                            static_cast<float*>(out), static_cast<float4*>(workspace), k, thr,
                            std::nextafter(thr, std::numeric_limits<float>::infinity()), max_det, cap);
}

// The cluster size a launch uses: 0 picks it from the batch. Returns false for a size not offered.
bool resolve(int b, int device, int* cluster) {
  if (*cluster == 0) *cluster = cluster_for(b, device);
  return *cluster >= 1 && *cluster <= kMaxCluster;
}

}  // namespace

extern "C" int blocked_nms_finalize_ex(const void* shifted, const void* boxes, const void* vals, const void* cls,
                                       const void* valid, void* out, void* workspace, int b, int k, float thr,
                                       int max_det, int cluster, int device, void* stream) {
  if (b < 0 || k < 0 || max_det < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || max_det == 0) return 0;
  // nvcc links this library with its own CUDA runtime, whose current device is not PyTorch's
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!resolve(b, device, &cluster)) return static_cast<int>(cudaErrorInvalidValue);
  err = launch(shifted, boxes, vals, cls, valid, out, workspace, b, k, thr, max_det, cluster, device,
               static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int blocked_nms_finalize(const void* shifted, const void* boxes, const void* vals, const void* cls,
                                    const void* valid, void* out, void* workspace, int b, int k, float thr,
                                    int max_det, int device, void* stream) {
  return blocked_nms_finalize_ex(shifted, boxes, vals, cls, valid, out, workspace, b, k, thr, max_det, 0, device,
                                 stream);
}

// What a launch for (b, k) at this cluster size (0: chosen from b) uses: plan[0] the cluster size, [1] the step,
// [2] the dynamic shared memory of a CTA in bytes, [3] the kept boxes a CTA holds in shared memory, [4]
// cudaOccupancyMaxActiveClusters, [5] threads a CTA.
extern "C" int blocked_nms_plan(int b, int k, int cluster, int device, int* plan) {
  if (b < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!resolve(b, device, &cluster)) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = share_cap(k, cluster);
  plan[0] = cluster;
  plan[1] = kStep;
  plan[2] = static_cast<int>(smem_bytes(cap));
  plan[3] = cap;
  plan[4] = max_active_clusters(device, cluster, cap);
  plan[5] = kThreads;
  return 0;
}

extern "C" const char* blocked_nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
