// Exact greedy NMS keep mask for Hopper (sm_90a): boxes in, keep mask out, in one kernel.
//
// Replaces the TPU kernel yololite_tpu/ops/pallas_kernels.py:51
// `greedy_nms_keep_pallas` (body `_nms_kernel_with_valid`, :33) and absorbs
// the `box_iou` that feeds it (yololite_tpu/ops/nms.py:344): it computes
// box_iou + greedy_nms_keep_pallas together, which is also `_greedy_keep`
// (nms.py:27) and `_fixpoint_keep` (nms.py:97). Candidates arrive sorted by
// score; walking i = 0..K-1, a row i that is still kept drops every later j
// with iou(i, j) > thr (strict, float32). Input `boxes` (B, K, 4) float32
// contiguous class-offset xyxy and `valid` (B, K) bool; output `keep` (B, K)
// bool; K <= 1024.
//
// Design: one block of 1024 threads per image, everything between the boxes
// and the keep mask in shared memory, nothing in device memory.
//   load:    the K boxes (16 B each, zero-padded to whole 64-bit words),
//            their K areas, and the "removed" words seeded with ~valid and
//            the ragged tail past K (one ballot per 32 candidates).
//   phase A: the upper-triangular suppression bitmask sup[i][w], ceil(K/64)
//            64-bit words per row (128 KB at K = 1024), built in parallel:
//            a warp takes (row i, 32 consecutive columns), each lane computes
//            one IoU, and __ballot_sync packs `j > i && j < K && iou > thr`
//            into half a word. A row's words are written from the word that
//            holds i to the end, so phase B reads nothing unwritten.
//   phase B: one warp holds the removed words, one per lane (at most 16).
//            For word w it resolves the word's rows in registers, jumping from
//            one not-removed row to the next (ffs) and OR-ing in the row's
//            diagonal word sup[i][w]; for each row just kept, every lane
//            l > w ORs sup[i][l] into its own word. Shared memory only: no
//            K-step chain of barriers and no device-memory load in the chain.
//   store:   the keep bytes, coalesced.
// Above 48 KB of dynamic shared memory (K > 520) the launch needs
// cudaFuncAttributeMaxDynamicSharedMemorySize, set before such a launch.
//
// Exactness: every IoU has the bits of box_iou, as csrc/nms_device.cuh
// sets out (no FMA contraction, IEEE division, NaN-propagating min/max);
// never build this with --use_fast_math. The inter == 0 shortcut there made
// this kernel 20-40% faster on an H100 (PERF.md).
//
// Bound on an H100 SXM: the function reads 16 + 1 bytes and writes 1 byte per
// candidate, and the data needs the IoU of each kept row right of the
// diagonal, some 14 fp32 operations each; at the predict path's B = 32,
// K = 512 that is well under a microsecond either way. This design computes
// every pair right of the diagonal (phase A), not only the kept rows', and is
// bound by the instruction throughput of the one SM that holds an image: its
// time grows with K^2 per image, and at B < 132 only B of the 132 SMs get
// work. Phase B is one warp, serial over the kept rows. Splitting phase A over
// more blocks (a cluster with distributed shared memory, or a grid-wide
// pass) is the next speed question (PERF.md, Open questions).
//
// C interface, bound with ctypes (pointers and the stream are void*, ints are
// int): launches on the caller's stream of the caller's device, allocates
// nothing, does not synchronise, and returns the first CUDA error, that of
// the launch included.

#include "nms_device.cuh"

namespace {

using nms::kFull;

constexpr int kMaxK = 1024;   // the predict path's K is <= 1024 (larger K runs in csrc/blocked_nms.cu)
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// dynamic shared memory of one block: boxes, bitmask, removed and kept words, areas
size_t smem_bytes(int k) {
  const size_t words = (k + 63) / 64, kp = words * 64;
  return kp * sizeof(float4) + (size_t)k * words * sizeof(uint64_t) + 2 * words * sizeof(uint64_t) +
         kp * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 1)
greedy_nms_keep_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                       uint8_t* __restrict__ keep, int k, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 63) / 64;  // 64-bit words per bitmask row
  const int kp = words * 64;        // K padded to whole words
  float4* s_box = reinterpret_cast<float4*>(smem);
  uint64_t* s_sup = reinterpret_cast<uint64_t*>(s_box + kp);  // k rows x words
  uint64_t* s_removed = s_sup + (size_t)k * words;
  uint64_t* s_kept = s_removed + words;
  float* s_area = reinterpret_cast<float*>(s_kept + words);
  uint32_t* s_sup32 = reinterpret_cast<uint32_t*>(s_sup);  // the same bitmask in half-words
  uint32_t* s_removed32 = reinterpret_cast<uint32_t*>(s_removed);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t b = blockIdx.x;
  const float* boxes_b = boxes + b * (size_t)k * 4;
  const uint8_t* valid_b = valid + b * (size_t)k;

  // ---- load ----
  float* s_boxf = reinterpret_cast<float*>(s_box);
  for (int t = threadIdx.x; t < kp * 4; t += kThreads) s_boxf[t] = t < k * 4 ? boxes_b[t] : 0.0f;
  for (int c = warp; c < 2 * words; c += kWarps) {
    const int j = 32 * c + lane;
    const unsigned bits = __ballot_sync(kFull, j >= k || valid_b[j] == 0);
    if (lane == 0) s_removed32[c] = bits;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kp; j += kThreads) {
    const float4 q = s_box[j];
    s_area[j] = nms::box_area(q);
  }
  __syncthreads();

  // ---- phase A: sup[i][w], bit j set when j > i and iou(i, j) > thr ----
  nms::build_suppression<false>(s_box, s_area, s_sup32, s_removed32, k, words, thr);
  __syncthreads();

  // ---- phase B: the word scan, one warp ----
  if (warp == 0) nms::scan_keep(s_sup, s_removed, s_kept, words);
  __syncthreads();

  // ---- store ----
  for (int j = threadIdx.x; j < k; j += kThreads) keep[b * k + j] = (s_kept[j >> 6] >> (j & 63)) & 1;
}

}  // namespace

extern "C" int greedy_nms_keep(const void* boxes, const void* valid, void* keep, int b, int k, float thr,
                               int device, void* stream) {
  if (b < 0 || k < 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || k == 0) return 0;
  // nvcc links this library with its own CUDA runtime, whose current device is not PyTorch's
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_bytes(k);
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(greedy_nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  greedy_nms_keep_kernel<<<b, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k, thr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* greedy_nms_keep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
