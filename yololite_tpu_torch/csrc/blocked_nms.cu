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
// candidate order, then rows of zeros. `workspace` (B, K, 4) fp32 is scratch.
// Walking the candidates in order, a kept one drops every later one with
// iou > thr (strict, fp32); the output is bit-equal to
// _finalize(boxes, vals, cls, _blocked_keep(shifted, valid, thr), max_det).
//
// Design: one block of 1024 threads per image walks the candidates in
// blocks of 1024, thread t on candidate lo + t, with no host sync:
//   (a) cross pass: a candidate still valid is tested against every box kept
//       in the earlier blocks, which are appended in order to the workspace
//       and streamed through shared memory in tiles of 4096; a thread stops
//       at its first suppressor, and the pass ends once no candidate of the
//       block is alive. One ballot per warp gives the block's removed words.
//   (b) in-block greedy: csrc/nms_device.cuh's phases A and B, as in K1
//       (greedy_nms_keep.cu), on the block's boxes in shared memory, phase A
//       building only the rows alive on entry. A block with no alive
//       candidate skips it.
//   (c) compaction: the block's kept rows are appended to the workspace and
//       the kept rows with score > 0 to the output, at their rank (a ballot
//       and a prefix over the 32 warps' counts).
// The walk stops after the block in which max_det rows have been emitted:
// suppression only acts forward, so later candidates change none of the
// first max_det rows. The tail of the output is zeroed by the kernel.
//
// Shared memory: the block's boxes and areas (20 KB), the bitmask (128 KB,
// also the cross pass's tile), removed and kept words: 148.5 KB, so the launch
// raises the dynamic shared-memory limit.
//
// Bound on an H100 SXM: the function reads 41 bytes per candidate up to the
// stop (16 + 16 of boxes, 4 + 4 of score and class, 1 of valid) and writes 24
// per output row; the data needs the IoU of each kept row with the later
// candidates up to the stop, some 14 fp32 operations each. At val's B = 16,
// K = 8192 that is some 2-20 us. This design runs 16 of the 132 SMs at that
// batch, tests each candidate against the kept boxes one by one in its own
// thread, and in phase A builds every alive row's pairs: it is bound by the
// instruction rate of the SM that holds an image, not by memory.
//
// C interface, bound with ctypes (pointers and the stream are void*, ints are
// int): launches on the caller's stream of the caller's device, allocates
// nothing, does not synchronise, and returns the first CUDA error, that of
// the launch included.

#include "nms_device.cuh"

namespace {

using nms::kFull;

constexpr int kBlock = 1024;              // candidates per block = threads per CTA
constexpr int kWarps = kBlock / 32;
constexpr int kMaxWords = kBlock / 64;    // 64-bit words of one bitmask row
constexpr int kTile = 4096;               // kept boxes per tile of the cross pass

constexpr size_t kSmemBytes = kBlock * sizeof(float4) + kBlock * sizeof(float) +
                              (size_t)kBlock * kMaxWords * sizeof(uint64_t) + 2 * kMaxWords * sizeof(uint64_t) +
                              2 * kWarps * sizeof(int);
static_assert(kTile * (sizeof(float4) + sizeof(float)) <= (size_t)kBlock * kMaxWords * sizeof(uint64_t),
              "the cross pass's tile lives in the bitmask's space");

__global__ void __launch_bounds__(kBlock, 1)
blocked_nms_kernel(const float4* __restrict__ shifted, const float4* __restrict__ boxes,
                   const float* __restrict__ vals, const float* __restrict__ cls, const uint8_t* __restrict__ valid,
                   float* __restrict__ out, float4* __restrict__ kept_boxes, int k, float thr, int max_det) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_box = reinterpret_cast<float4*>(smem);
  float* s_area = reinterpret_cast<float*>(s_box + kBlock);
  uint64_t* s_sup = reinterpret_cast<uint64_t*>(s_area + kBlock);  // kBlock rows x words
  uint64_t* s_removed = s_sup + (size_t)kBlock * kMaxWords;
  uint64_t* s_kept = s_removed + kMaxWords;
  int* s_warp_kept = reinterpret_cast<int*>(s_kept + kMaxWords);
  int* s_warp_emit = s_warp_kept + kWarps;
  float4* s_tile = reinterpret_cast<float4*>(s_sup);  // the cross pass's tile, in the bitmask's space
  float* s_tile_area = reinterpret_cast<float*>(s_tile + kTile);
  uint32_t* s_sup32 = reinterpret_cast<uint32_t*>(s_sup);
  uint32_t* s_removed32 = reinterpret_cast<uint32_t*>(s_removed);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t b = blockIdx.x;
  shifted += b * k;
  boxes += b * k;
  vals += b * k;
  cls += b * k;
  valid += b * k;
  kept_boxes += b * k;
  out += b * (size_t)max_det * 6;

  int n_kept = 0, n_emit = 0;  // kept and emitted rows so far, the same in every thread
  for (int lo = 0; lo < k && n_emit < max_det; lo += kBlock) {
    const int kb = min(kBlock, k - lo);  // candidates in this block
    const int words = (kb + 63) / 64;
    const int j = lo + t;
    const float4 q = t < kb ? shifted[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float qa = nms::box_area(q);
    bool alive = t < kb && valid[j] != 0;

    // ---- (a) cross pass against the boxes kept in earlier blocks ----
    for (int base = 0; base < n_kept; base += kTile) {
      if (!__syncthreads_or(alive)) break;  // the same in every thread; the last tile's readers are done
      const int n = min(kTile, n_kept - base);
      for (int i = t; i < n; i += kBlock) {
        const float4 p = kept_boxes[base + i];
        s_tile[i] = p;
        s_tile_area[i] = nms::box_area(p);
      }
      __syncthreads();
      if (alive) {
        for (int i = 0; i < n; ++i) {
          if (nms::iou_above(s_tile[i], s_tile_area[i], q, qa, thr)) {
            alive = false;
            break;
          }
        }
      }
    }
    __syncthreads();  // the tile's readers are done before the bitmask overwrites it
    s_box[t] = q;
    s_area[t] = qa;
    const unsigned dead = __ballot_sync(kFull, !alive);
    if (lane == 0) s_removed32[warp] = dead;
    if (!__syncthreads_or(alive)) continue;  // nothing alive: nothing kept, nothing suppressed

    // ---- (b) in-block greedy: K1's phases A and B ----
    nms::build_suppression<true>(s_box, s_area, s_sup32, s_removed32, kb, words, thr);
    __syncthreads();
    if (warp == 0) nms::scan_keep(s_sup, s_removed, s_kept, words);
    __syncthreads();

    // ---- (c) compaction: kept boxes to the workspace, kept rows with score > 0 to the output ----
    const bool kept = t < kb && ((s_kept[t >> 6] >> (t & 63)) & 1);
    const bool emit = kept && vals[j] > 0.0f;
    const unsigned kept_bits = __ballot_sync(kFull, kept), emit_bits = __ballot_sync(kFull, emit);
    if (lane == 0) {
      s_warp_kept[warp] = __popc(kept_bits);
      s_warp_emit[warp] = __popc(emit_bits);
    }
    __syncthreads();
    int kept_before = 0, emit_before = 0, kept_total = 0, emit_total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int nk = s_warp_kept[w], ne = s_warp_emit[w];
      kept_before += w < warp ? nk : 0;
      emit_before += w < warp ? ne : 0;
      kept_total += nk;
      emit_total += ne;
    }
    const unsigned below = (1u << lane) - 1u;
    if (kept) kept_boxes[n_kept + kept_before + __popc(kept_bits & below)] = q;
    if (emit) {
      const int r = n_emit + emit_before + __popc(emit_bits & below);
      if (r < max_det) {
        const float4 bx = boxes[j];
        float* o = out + (size_t)r * 6;
        o[0] = bx.x;
        o[1] = bx.y;
        o[2] = bx.z;
        o[3] = bx.w;
        o[4] = vals[j];
        o[5] = cls[j];
      }
    }
    n_kept += kept_total;
    n_emit += emit_total;
    __syncthreads();  // the warp counts are read, the workspace's new rows visible, before the next block
  }

  // ---- the rows past the last emitted one are zeros ----
  const int filled = min(n_emit, max_det);
  for (size_t i = (size_t)filled * 6 + t; i < (size_t)max_det * 6; i += kBlock) out[i] = 0.0f;
}

}  // namespace

extern "C" int blocked_nms_finalize(const void* shifted, const void* boxes, const void* vals, const void* cls,
                                    const void* valid, void* out, void* workspace, int b, int k, float thr,
                                    int max_det, int device, void* stream) {
  if (b < 0 || k < 0 || max_det < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || max_det == 0) return 0;
  // nvcc links this library with its own CUDA runtime, whose current device is not PyTorch's
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(blocked_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  blocked_nms_kernel<<<b, kBlock, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(shifted), static_cast<const float4*>(boxes), static_cast<const float*>(vals),
      static_cast<const float*>(cls), static_cast<const uint8_t*>(valid), static_cast<float*>(out),
      static_cast<float4*>(workspace), k, thr, max_det);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* blocked_nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
