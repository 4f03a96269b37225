// int8 convolution with its epilogue, for Hopper (sm_90a): K8 of the port.
//
// Replaces the int8 serving convolution of yololite_tpu/models/modules.py:176-185
// (Conv's quantized branch): the int32-accumulated `conv2d(..., pet=jnp.int32)`
// of :63-83, which XLA lowers for the TPU's int8 matrix unit, and its epilogue
// `acc * (sin * sw) + b` -> bf16 -> SiLU -> `quantize_act` (:86-88). PyTorch has
// no int8 convolution on CUDA, so this op has no library counterpart to call.
//
// What it computes, per output element (b, oy, ox, o):
//   acc = sum over taps and the group's input channels of x * w    (int32)
//   y   = float(acc) * scale[o] + bias[o]    (fp32, rounded after each op)
//   y   = bf16(y); SiLU (or ReLU, or nothing) as torch rounds it on bf16:
//         bf16(float(y) / (1 + exp(-float(y))))
//   out = int8(clamp(rint(float(y) / sout), -127, 127)) when the consumer is
//         quantized (sout > 0), else the bf16 y.
// scale = sin * sw is formed in fp32 by the caller, as the JAX package does.
// Every fp32 operation of the epilogue is an __f*_rn intrinsic, which nvcc never
// contracts into an FMA, and the division is IEEE, so the epilogue has the bits
// of the plain torch version (ops/kernels.py int8_conv_plain). Never build this
// with --use_fast_math.
//
// Layouts: x is int8 NHWC (B, H, W, Cin), the channels-last form of the port's
// int8 edges; w is int8 OHWI (Cout, KH, KW, Cin/groups); scale and bias fp32
// (Cout); out NHWC (B, Ho, Wo, Cout), int8 or bf16. Any stride, padding and
// groups; dilation 1.
//
// Design, simple first: one thread per output pixel and kOCT = 8 consecutive
// output channels, 128 pixels per block, the block's weights tile (8 output
// channels x taps x Cin/groups bytes) in shared memory. Where every tile lies in
// one group and Cin/groups is a multiple of 4 (all of yolo11's convolutions but
// the 3-channel stem and the depthwise ones), 4 channels pack into one 32-bit
// word: the thread loads one word of its input pixel and feeds it to __dp4a
// against the 8 channels' weight words (two 16-byte shared-memory loads, the
// same address for the whole warp). Otherwise a scalar loop over the group's
// channels (the stem's 3 channels, the depthwise convolutions' 1).
//
// Bound on an H100 SXM: the conv reads x and w once and writes out once, and
// does 2 * Cout * Ho * Wo * B * taps * Cin/groups int8 operations; at 1,979
// TOP/s int8 (tensor cores) the bytes bound most of yolo11n's convolutions.
// This design uses no tensor core (IMMA/wgmma), no TMA, and re-reads each input
// pixel once per 8 output channels through L1/L2, so it is bound by the
// __dp4a instruction rate and those loads; tensor-core tiles, TMA and a fused
// quantize of a bf16 input are later work (PERF.md).
//
// C interface, bound with ctypes: launches on the caller's stream of the
// caller's device, allocates nothing, does not synchronise, and returns the
// first CUDA error, that of the launch included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOCT = 8;        // output channels per thread
constexpr int kThreads = 128;  // output pixels per block

struct Conv {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* out;
  int b, h, w_in, cin, ho, wo, cout, kh, kw, stride, pad, groups, act;
  float sout;  // > 0: requantize to int8 at this scale; else write bf16
};

__device__ __forceinline__ void store(const Conv& p, size_t pix, int o, int acc) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), p.scale[o]), p.bias[o]);
  __nv_bfloat16 yb = __float2bfloat16_rn(y);
  if (p.act == 1) {  // SiLU as torch computes it on bf16: in fp32, one rounding to bf16
    const float v = __bfloat162float(yb);
    yb = __float2bfloat16_rn(__fdiv_rn(v, __fadd_rn(1.0f, expf(-v))));
  } else if (p.act == 2) {  // ReLU
    if (!(__bfloat162float(yb) > 0.0f)) yb = __float2bfloat16_rn(0.0f);
  }
  const size_t idx = pix * p.cout + o;
  if (p.sout > 0.0f) {
    float q = rintf(__fdiv_rn(__bfloat162float(yb), p.sout));  // round half to even, as torch.round
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    static_cast<int8_t*>(p.out)[idx] = static_cast<int8_t>(static_cast<int>(q));
  } else {
    static_cast<__nv_bfloat16*>(p.out)[idx] = yb;
  }
}

// One output pixel per thread, kOCT output channels from blockIdx.y * kOCT.
template <bool kDp4a>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(Conv p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cin_g = p.cin / p.groups, cout_g = p.cout / p.groups;
  const int taps = p.kh * p.kw;
  const int row = taps * cin_g;  // weight bytes of one output channel
  const int oc0 = blockIdx.y * kOCT;

  // ---- the weights tile ----
  if (kDp4a) {  // words: s_w[(tap * cin4 + c4) * kOCT + o]
    const int cin4 = cin_g / 4, words = taps * cin4;
    int* s_w = reinterpret_cast<int*>(smem);
    for (int t = threadIdx.x; t < words * kOCT; t += kThreads) {
      const int o = t % kOCT, r = t / kOCT;
      s_w[t] = oc0 + o < p.cout ? reinterpret_cast<const int*>(p.w + (size_t)(oc0 + o) * row)[r] : 0;
    }
  } else {  // bytes: s_w[o * row + tap * cin_g + c]
    int8_t* s_w = reinterpret_cast<int8_t*>(smem);
    for (int t = threadIdx.x; t < row * kOCT; t += kThreads) {
      const int o = t / row, r = t % row;
      s_w[t] = oc0 + o < p.cout ? p.w[(size_t)(oc0 + o) * row + r] : 0;
    }
  }
  __syncthreads();

  const size_t npix = (size_t)p.b * p.ho * p.wo;
  const size_t pix = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (pix >= npix) return;
  const int ox = pix % p.wo;
  const int oy = (pix / p.wo) % p.ho;
  const size_t bi = pix / ((size_t)p.wo * p.ho);

  int acc[kOCT];
#pragma unroll
  for (int o = 0; o < kOCT; ++o) acc[o] = 0;

  for (int ky = 0; ky < p.kh; ++ky) {
    const int iy = oy * p.stride - p.pad + ky;
    if (iy < 0 || iy >= p.h) continue;
    for (int kx = 0; kx < p.kw; ++kx) {
      const int ix = ox * p.stride - p.pad + kx;
      if (ix < 0 || ix >= p.w_in) continue;  // zero padding adds nothing
      const int tap = ky * p.kw + kx;
      const int8_t* xp = p.x + ((bi * p.h + iy) * p.w_in + ix) * p.cin;
      if (kDp4a) {
        const int cin4 = cin_g / 4;
        const int* xw = reinterpret_cast<const int*>(xp + (oc0 / cout_g) * cin_g);  // the tile's one group
        const int4* s_w = reinterpret_cast<const int4*>(smem) + (size_t)tap * cin4 * (kOCT / 4);
        for (int c4 = 0; c4 < cin4; ++c4) {
          const int xv = xw[c4];
          const int4 w0 = s_w[2 * c4], w1 = s_w[2 * c4 + 1];
          acc[0] = __dp4a(xv, w0.x, acc[0]);
          acc[1] = __dp4a(xv, w0.y, acc[1]);
          acc[2] = __dp4a(xv, w0.z, acc[2]);
          acc[3] = __dp4a(xv, w0.w, acc[3]);
          acc[4] = __dp4a(xv, w1.x, acc[4]);
          acc[5] = __dp4a(xv, w1.y, acc[5]);
          acc[6] = __dp4a(xv, w1.z, acc[6]);
          acc[7] = __dp4a(xv, w1.w, acc[7]);
        }
      } else {
        const int8_t* s_w = reinterpret_cast<const int8_t*>(smem);
#pragma unroll
        for (int o = 0; o < kOCT; ++o) {
          const int oc = oc0 + o;
          if (oc >= p.cout) break;
          const int8_t* xg = xp + (oc / cout_g) * cin_g;
          const int8_t* wr = s_w + o * row + tap * cin_g;
          int a = acc[o];
          for (int c = 0; c < cin_g; ++c) a += static_cast<int>(xg[c]) * static_cast<int>(wr[c]);
          acc[o] = a;
        }
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kOCT; ++o)
    if (oc0 + o < p.cout) store(p, pix, oc0 + o, acc[o]);
}

template <bool kDp4a>
cudaError_t launch(const Conv& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(int8_conv_kernel<kDp4a>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const size_t npix = (size_t)p.b * p.ho * p.wo;
  const dim3 grid(static_cast<unsigned>((npix + kThreads - 1) / kThreads), (p.cout + kOCT - 1) / kOCT);
  int8_conv_kernel<kDp4a><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int int8_conv(const void* x, const void* w, const void* scale, const void* bias, void* out, int b, int h,
                         int w_in, int cin, int ho, int wo, int cout, int kh, int kw, int stride, int pad, int groups,
                         int act, float sout, int device, void* stream) {
  if (b < 0 || h <= 0 || w_in <= 0 || cin <= 0 || ho <= 0 || wo <= 0 || cout <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || pad < 0 || groups <= 0 || cin % groups || cout % groups || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  if ((size_t)b * ho * wo > (size_t)0x7fffffff * kThreads || (cout + kOCT - 1) / kOCT > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  // nvcc links this library with its own CUDA runtime, whose current device is not PyTorch's
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Conv p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(scale),
               static_cast<const float*>(bias), out, b, h, w_in, cin, ho, wo, cout, kh, kw, stride, pad, groups, act,
               sout};
  const int cin_g = cin / groups, cout_g = cout / groups;
  const size_t smem = (size_t)kOCT * kh * kw * cin_g;
  const bool words = cin_g % 4 == 0 && cin % 4 == 0 && (groups == 1 || cout_g % kOCT == 0) &&
                     reinterpret_cast<uintptr_t>(x) % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(words ? launch<true>(p, smem, s) : launch<false>(p, smem, s));
}

extern "C" const char* int8_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
