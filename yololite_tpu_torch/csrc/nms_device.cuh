// Device code of the exact greedy NMS kernels for Hopper (sm_90a):
// csrc/greedy_nms_keep.cu (K1) and csrc/blocked_nms.cu (K4). K4 uses the
// min/max and area helpers; its own walk and IoU test are in blocked_nms.cu.
//
// K1 resolves up to 1024 score-sorted candidates in one block of 1024
// threads with two phases (see greedy_nms_keep.cu for the design):
//   phase A (`build_suppression`): the upper-triangular suppression bitmask
//            sup[i][w] in shared memory, 64-bit words, a warp per row and a
//            ballot per 32 columns;
//   phase B (`scan_keep`): one warp resolves the keep word by word from the
//            removed words and the bitmask.
//
// Exactness: every IoU has the bits of yololite_tpu_torch/ops/boxes.py box_iou
// (and so of yololite_tpu/ops/boxes.py:162), in the same operation order:
// w = max(min(ax2, bx2) - max(ax1, bx1), 0), h likewise, inter = w*h,
// area = (x2-x1)*(y2-y1), iou = inter / (((area_a + area_b) - inter) + 1e-7f).
// The arithmetic is written with __fsub_rn/__fmul_rn/__fadd_rn/__fdiv_rn,
// which nvcc never contracts into an FMA, and IEEE division; min and max are
// PTX min.NaN/max.NaN, which propagate NaN as torch.minimum/maximum/clamp do.
// Never build this with --use_fast_math. One shortcut is exact: inter == 0
// makes the IoU +-0 or NaN, never above a threshold >= 0, so the division is
// skipped there.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nms {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// (x2 - x1) * (y2 - y1), as box_iou forms each area
__device__ __forceinline__ float box_area(float4 q) { return __fmul_rn(__fsub_rn(q.z, q.x), __fsub_rn(q.w, q.y)); }

// iou(a, b) > thr, with the bits of box_iou (a is the earlier, higher-scored box)
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b, float area_b, float thr) {
  const float w = max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 0.0f);
  const float h = max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  if (inter == 0.0f && thr >= 0.0f) return false;
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f);
  return __fdiv_rn(inter, den) > thr;
}

// Phase A: sup[i][w], bit j set when j > i and iou(i, j) > thr, for the k candidates in s_box; `words` 64-bit
// words per row, written from the word that holds i to the end, so phase B reads nothing unwritten. With
// kSkipRemoved, rows whose bit in the removed words is set are not built: phase B reads a row only once the
// row is kept, and a row removed on entry never is.
template <bool kSkipRemoved>
__device__ __forceinline__ void build_suppression(const float4* s_box, const float* s_area, uint32_t* s_sup32,
                                                  const uint32_t* s_removed32, int k, int words, float thr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int i = warp; i < k; i += warps) {
    if (kSkipRemoved && ((s_removed32[i >> 5] >> (i & 31)) & 1u)) continue;  // the same in every lane
    const float4 bi = s_box[i];
    const float ai = s_area[i];
    uint32_t* row = s_sup32 + (size_t)i * 2 * words;
    for (int c = 2 * (i >> 6); c < 2 * words; ++c) {
      const int j = 32 * c + lane;
      const bool hit = j > i && j < k && iou_above(bi, ai, s_box[j], s_area[j], thr);
      const unsigned bits = __ballot_sync(kFull, hit);
      if (lane == 0) row[c] = bits;
    }
  }
}

// Phase B, called by one whole warp: the keep words from the removed words (at most 32, one per lane) and the
// bitmask. For word w it resolves the word's rows in registers, jumping from one not-removed row to the next
// (ffs) and OR-ing in the row's diagonal word sup[i][w]; for each row just kept, every lane l > w ORs sup[i][l]
// into its own word. Shared memory only: no chain of barriers and no device-memory load in the chain.
__device__ __forceinline__ void scan_keep(const uint64_t* s_sup, const uint64_t* s_removed, uint64_t* s_kept,
                                          int words) {
  const int lane = threadIdx.x & 31;
  uint64_t removed = lane < words ? s_removed[lane] : 0;  // lane l: removed rows of word l
  uint64_t kept_word = 0;
  for (int w = 0; w < words; ++w) {
    uint64_t rw = __shfl_sync(kFull, removed, w);  // final: every kept row before word w is applied
    uint64_t kept = 0;
    uint64_t cand = ~rw;
    while (cand) {  // the same value in every lane
      const int t = __ffsll(static_cast<long long>(cand)) - 1;
      const uint64_t* r = s_sup + (size_t)(64 * w + t) * words;
      rw |= r[w];
      if (lane > w && lane < words) removed |= r[lane];
      kept |= 1ull << t;
      cand = ~rw & ~((2ull << t) - 1);  // rows after t not removed yet (t = 63 leaves none)
    }
    if (lane == w) kept_word = kept;
  }
  if (lane < words) s_kept[lane] = kept_word;
}

}  // namespace nms
