// Exact greedy NMS keep mask for Hopper (sm_90a).
//
// Replaces the TPU kernel yololite_tpu/ops/pallas_kernels.py:51
// `greedy_nms_keep_pallas` (body `_nms_kernel_with_valid`, :33) and computes
// the same function: candidates arrive sorted by score; walking i = 0..K-1,
// a row i that is still kept drops every later j with iou[b, i, j] > thr
// (strict). Input `iou` (B, K, K) float32 contiguous and `valid` (B, K) bool;
// output `keep` (B, K) bool.
//
// Design: one block per image; the keep vector lives in shared memory (K
// bytes); the block walks i in order with one barrier per step, and when
// keep[i] is set its threads clear keep[j] for j > i, reading row i of the
// IoU matrix coalesced (neighbouring threads, neighbouring j). A step only
// writes entries j > i and reads entry i after the barrier that ends step
// i - 1, so one barrier per step orders every read after the writes it
// depends on.
//
// Bound on an H100 SXM: the function reads at most B*K*K*4 bytes of IoU once
// (134 MB at B=128, K=512: 40 us at 3.35 TB/s; on real data only the kept
// rows right of the diagonal, far less) and does one compare per entry read,
// far below the card's rate, so bytes bound it. This simple design is instead
// bounded by its serial chain: K barrier steps per block, each waiting on
// the latency of one row load when keep[i] is set, so its time grows with K
// and not with the bytes. A later version removes the chain: either a
// suppression bitmask built in parallel (each block marks, for its rows,
// the later columns above the threshold) followed by a serial scan over
// 64-bit words, or the IoU computed inside the kernel from the (K, 4) boxes
// so the (B, K, K) matrix never touches device memory.
//
// C interface, bound with ctypes (pointers and the stream are void*, ints are
// int): launches on the caller's stream of the caller's device, allocates
// nothing, does not synchronise, and returns the first CUDA error, that of
// the launch included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;   // the predict path's K is <= 1024 (larger K runs in blocks of 1024)
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
greedy_nms_keep_kernel(const float* __restrict__ iou, const uint8_t* __restrict__ valid,
                       uint8_t* __restrict__ keep, int k, float thr) {
  __shared__ uint8_t s_keep[kMaxK];
  const size_t b = blockIdx.x;
  const float* iou_b = iou + b * (size_t)k * (size_t)k;
  for (int j = threadIdx.x; j < k; j += kThreads) s_keep[j] = valid[b * k + j] != 0;
  for (int i = 0; i < k; ++i) {
    __syncthreads();
    if (s_keep[i]) {  // the same value for every thread of the block
      const float* row = iou_b + (size_t)i * k;
      for (int j = i + 1 + threadIdx.x; j < k; j += kThreads) {
        if (row[j] > thr) s_keep[j] = 0;
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += kThreads) keep[b * k + j] = s_keep[j];
}

}  // namespace

extern "C" int greedy_nms_keep(const void* iou, const void* valid, void* keep, int b, int k, float thr,
                               int device, void* stream) {
  if (b < 0 || k < 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || k == 0) return 0;
  // nvcc links this library with its own CUDA runtime, whose current device is not PyTorch's
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_nms_keep_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(iou), static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k, thr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* greedy_nms_keep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
