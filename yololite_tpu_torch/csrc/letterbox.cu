// Batched letterbox for Hopper (sm_90a): uint8 NHWC frames -> the model's input, in one pass (K2).
//
// Replaces yololite_tpu/ops/pallas_kernels.py:89 `device_letterbox` (with
// `_interp_matrix`, :73), whose resize runs as two matmuls on the TPU's
// matrix unit. Its plain version is ops/kernels.py `device_letterbox_plain`.
// Input `images` (B, H0, W0, 3) uint8 contiguous, RGB, or BGR with `bgr` (the
// channels are reversed as they are read). Output (B, S, S, 3) values in
// [0, 1], written NCHW-contiguous ((B, 3, S, S) storage, the layout the
// float nets' first conv reads) or channels-last ((B, S, S, 3) storage), in
// fp32, bf16 or fp16. The geometry (new_h, new_w, top, left) comes from the
// wrapper (ops/kernels.py letterbox_geometry).
//
// Each output pixel inside the resized window is cv2's INTER_LINEAR with
// half-pixel centres as `_interp_matrix` weighs it: a source row pair
// (lo, hi) with weights (1 - w, w), w = c - floor(c), c = (i + 0.5) * src /
// dst - 0.5 in double, both indices clamped into the image and the two
// weights summed in fp32 where they meet (an edge), the same for columns;
// the row pass first, then the column pass, in fp32. Without a resize the
// value is the pixel itself. Outside the window it is 114. Then
// v * float(1 / 255) (the plain version's x * (1.0 / 255.0), which rounds
// as XLA lowers the JAX package's x / 255: the pad's bits match JAX) and a
// round-to-nearest-even cast to the output type. The resize is exact to
// fp32 rounding; the plain version's matmuls add the zero-weight taps in
// their own order, so the two agree within 1e-5 (no resize: bit for bit).
//
// Bound on an H100 SXM (chip_smoke.py k2_bound_ms): the function reads each
// input byte once and writes each output element once: at B 32, 480 x 640 to
// 640 that is 29.5 MB in and 157.3 MB out in fp32, 56 us at 3.35 TB/s. One
// thread per output pixel, its three channels together; the row and column
// weights are recomputed per pixel (a few double operations), the 2 x 2
// taps read through the L1 cache. NCHW stores are coalesced per plane.
//
// C interface, bound with ctypes (pointers and the stream are void*, ints are
// int): launches on the caller's stream of the caller's device, allocates
// nothing, does not synchronise, and returns the first CUDA error, that of
// the launch included.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Taps {
  int lo, hi;   // source indices, clamped
  float wlo, whi;  // their weights; whi is 0 when the taps meet at an edge (wlo holds their sum)
};

// `_interp_matrix`'s row `i` of a (dst, src) resize: the weights in double, stored as float32, summed in float32
// where the two indices meet (m[i, lo] += 1 - w; m[i, hi] += w on a float32 array)
__device__ __forceinline__ Taps taps(int i, int dst, int src) {
  const double scale = (double)src / (double)dst;
  const double c = __dadd_rn(__dmul_rn(__dadd_rn((double)i, 0.5), scale), -0.5);
  const double fl = floor(c);
  const int lo = (int)fl;
  const double w_hi = __dadd_rn(c, -fl);
  Taps t;
  t.lo = min(max(lo, 0), src - 1);
  t.hi = min(max(lo + 1, 0), src - 1);
  const float w_lo = __double2float_rn(__dadd_rn(1.0, -w_hi));
  if (t.lo == t.hi) {  // numpy 2 adds a float32 element and a Python float in float32
    t.wlo = __fadd_rn(w_lo, __double2float_rn(w_hi));
    t.whi = 0.0f;
  } else {
    t.wlo = w_lo;
    t.whi = __double2float_rn(w_hi);
  }
  return t;
}

template <typename T>
__device__ __forceinline__ T cast_out(float v);
template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half cast_out<__half>(float v) { return __float2half_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
letterbox_kernel(const uint8_t* __restrict__ images, T* __restrict__ out, int h0, int w0, int s, int new_h, int new_w,
                 int top, int left, int bgr, int channels_last) {
  const int b = blockIdx.z;
  const int y = blockIdx.y;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= s) return;
  const float inv = (float)(1.0 / 255.0);
  float v[3] = {114.0f, 114.0f, 114.0f};
  const int yy = y - top, xx = x - left;
  if (yy >= 0 && yy < new_h && xx >= 0 && xx < new_w) {
    const uint8_t* img = images + (size_t)b * h0 * w0 * 3;
    if (new_h == h0 && new_w == w0) {
      const uint8_t* p = img + ((size_t)yy * w0 + xx) * 3;
      for (int c = 0; c < 3; ++c) v[c] = (float)p[c];
    } else {
      const Taps ty = taps(yy, new_h, h0), tx = taps(xx, new_w, w0);
      const int cols[2] = {tx.lo, tx.hi};
      float col[2][3];
      for (int k = 0; k < 2; ++k) {  // the row pass at the two source columns
        const uint8_t* plo = img + ((size_t)ty.lo * w0 + cols[k]) * 3;
        const uint8_t* phi = img + ((size_t)ty.hi * w0 + cols[k]) * 3;
        for (int c = 0; c < 3; ++c)
          col[k][c] = __fadd_rn(__fmul_rn(ty.wlo, (float)plo[c]), __fmul_rn(ty.whi, (float)phi[c]));
      }
      for (int c = 0; c < 3; ++c)  // the column pass
        v[c] = __fadd_rn(__fmul_rn(tx.wlo, col[0][c]), __fmul_rn(tx.whi, col[1][c]));
    }
  }
  const size_t plane = (size_t)s * s;
  for (int c = 0; c < 3; ++c) {
    const T o = cast_out<T>(__fmul_rn(v[bgr ? 2 - c : c], inv));
    if (channels_last)
      out[(((size_t)b * s + y) * s + x) * 3 + c] = o;
    else
      out[((size_t)b * 3 + c) * plane + (size_t)y * s + x] = o;
  }
}

template <typename T>
cudaError_t launch(const void* images, void* out, int b, int h0, int w0, int s, int new_h, int new_w, int top,
                   int left, int bgr, int channels_last, cudaStream_t st) {
  const dim3 grid((s + kThreads - 1) / kThreads, s, b);
  letterbox_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const uint8_t*>(images), static_cast<T*>(out), h0, w0,
                                                 s, new_h, new_w, top, left, bgr, channels_last);
  return cudaGetLastError();
}

}  // namespace

extern "C" int device_letterbox(const void* images, void* out, int b, int h0, int w0, int s, int new_h, int new_w,
                                int top, int left, int out_type, int bgr, int channels_last, int device,
                                void* stream) {
  if (b < 0 || h0 < 1 || w0 < 1 || s < 1 || new_h < 0 || new_w < 0 || top < 0 || left < 0 || top + new_h > s ||
      left + new_w > s || b > 65535 || out_type < 0 || out_type > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  cudaError_t err = cudaSetDevice(device);  // nvcc's own runtime: its current device is not PyTorch's
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_type == 0) return static_cast<int>(launch<float>(images, out, b, h0, w0, s, new_h, new_w, top, left, bgr,
                                                           channels_last, st));
  if (out_type == 1)
    return static_cast<int>(launch<__nv_bfloat16>(images, out, b, h0, w0, s, new_h, new_w, top, left, bgr,
                                                  channels_last, st));
  return static_cast<int>(launch<__half>(images, out, b, h0, w0, s, new_h, new_w, top, left, bgr, channels_last,
                                         st));
}

extern "C" const char* device_letterbox_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
