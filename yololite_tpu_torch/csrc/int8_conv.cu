// int8 convolution with its epilogue, for Hopper (sm_90a): K8 of the port.
//
// Replaces the int8 serving convolution of yololite_tpu/models/modules.py:176-185
// (Conv's quantized branch): the int32-accumulated `conv2d(..., pet=jnp.int32)`
// of :63-83, which XLA lowers for the TPU's int8 matrix unit, its epilogue
// `acc * (sin * sw) + b` -> bf16 -> SiLU -> `quantize_act` (:86-88), and the
// `quantize_act` of a float input before it (:178-179). PyTorch has no int8
// convolution on CUDA, so this op has no library counterpart to call.
//
// What it computes, per output element (b, oy, ox, o):
//   xq  = x when x is int8, else int8(clamp(rint(float(x) / sin), -127, 127))
//   acc = sum over taps and the group's input channels of xq * w    (int32)
//   y   = float(acc) * scale[o] + bias[o]    (fp32, rounded after each op)
//   y   = bf16(y); SiLU (or ReLU, or nothing) as torch rounds it on bf16:
//         bf16(float(y) / (1 + exp(-float(y))))
//   out = int8(clamp(rint(float(y) / sout), -127, 127)) when the consumer is
//         quantized (sout > 0), else the bf16 y.
// scale = sin * sw is formed in fp32 by the caller, as the JAX package does.
// Every fp32 operation is an __f*_rn intrinsic, which nvcc never contracts
// into an FMA, and the divisions are IEEE, so the kernel has the bits of the
// plain torch version (ops/kernels.py int8_conv_plain) on every output; the
// int32 sum is exact in any order (|acc| <= 127^2 * 4,608 < 2^31). Never build
// this with --use_fast_math.
//
// Layouts: x is NHWC (B, H, W, Cin) with its pixels `pitch` elements apart (Cin, or more for a channel slice of a
// wider channels-last tensor, as C3k2's and C2PSA's split halves are: read in place), int8, bf16 or fp32; w is int8
// OHWI (Cout, KH, KW, Cin/groups); scale and bias fp32 (Cout); out NHWC (B, Ho, Wo, Cout), int8 or bf16. Any
// stride, padding and groups; dilation 1.
//
// Bound on an H100 SXM: x and w read once, out written once, 2 * B * Ho * Wo *
// Cout * taps * Cin/groups int8 operations at 1,979 TOP/s (tensor cores). At
// yolo11n's widths the bytes bound 73 of the 76 convs; at yolo11m's the
// operations bound most 3x3 and wide 1x1 convs. A bytes-bound conv moves about
// one byte per output, so the epilogue's arithmetic (expf and two IEEE
// divisions, some 45 instructions an output) costs more than the bytes: an
// int8 output's activation + requant is a table lookup (see kTabBase). Four
// routes, one launch each (numbered as plan() codes them, 4 = gemm1x1):
//
// 1. gemm (groups 1, Cin and Cout multiples of 8): an implicit GEMM on the int8
//    tensor cores. M = B * Ho * Wo output pixels, N = Cout, K = taps * Cin,
//    walked flat (k = (ky * kw + kx) * Cin + c, so a 3x3 conv of Cin 16 takes
//    3 steps, not 9) in steps of two 32-byte chunks. A tile is 64 * WG output
//    pixels (WG consumer warpgroups, one m64 row block each; WG = 1 where
//    128-pixel tiles would not fill the card twice) by an N tile of Cout up to
//    128 (Cout 256 and 512 run as 2 and 4 N tiles: measured faster than one of
//    256, whose 128 accumulators a thread leave one block an SM). The grid is
//    persistent: each block walks its tiles' K steps as one stream. Each step's
//    A (tile rows x 32 bytes a chunk) and B (N tile x 32 bytes a chunk) land in
//    a ring of kStages shared-memory slots in the 32-byte swizzle layout,
//    fetched by cp.async with zero-fill: src-size 0 for a tap outside the frame
//    (the padding) or K past the end; 8-byte copies where Cin is not a multiple
//    of 16; stride and pixel pitch in the address. A bf16 or fp32 x is loaded
//    into registers, quantized and stored to the slot as int8 instead. Each warpgroup issues a
//    wgmma.m64nNk32.s32.s8.s8 a chunk, asynchronously, while the copies of the
//    step two ahead are in flight. At a tile's last step the epilogue runs on
//    the accumulators in registers, stages the tile in shared memory and writes
//    it out in 16-byte coalesced stores, while the next tile's copies fly. It
//    keeps the 3x3 convs: a warp-specialised design (a producer warp
//    TMA-loading each output tile's input once for its 9 taps) ran at
//    0.42-0.98x its speed on most yolo11 3x3 convs (PERF.md, PR 21).
// 4. gemm1x1 (kernel 1x1, stride 1, no padding, groups 1, Cin a multiple of 16,
//    Cout of 8, a pixel pitch of whole 16 bytes, where prefer_1x1 finds it
//    faster than route 1: the float edges, and int8 convs by how its work items
//    fill the card): the GEMM out = x w^T with A the (M, Cin) NHWC matrix, rows
//    `pitch` elements apart, fed by TMA. Warp-specialised: one
//    producer warp issues every load (2-D tensor maps, the 32-byte swizzle the
//    wgmma descriptors read, zero fill past M and Cin) into mbarrier-tracked
//    slots, and two consumer warpgroups (64 rows each of a 128-pixel M tile)
//    issue the wgmma.m64nNk32.s32.s8.s8. An M tile's A stays in shared memory
//    (one slot per 64-byte K step, two sets where they fit so the next tile's
//    A loads during this one) while its N tiles walk Cout, so A is read once;
//    B streams through a 4-slot ring. A bf16 or fp32 x is TMA-loaded raw into
//    a 2-slot staging ring, and each consumer warpgroup quantizes its own 64
//    rows (quantize8's arithmetic) into the A slot at the tile's first N tile,
//    while the wgmmas of the step before run. The grid is persistent (one M
//    tile after another per block), and a tile's epilogue (the same
//    arithmetic, staged in shared memory, 16-byte stores) overlaps the loads of
//    the next. An N tile of 128 (64 accumulators a thread) fits one block an
//    SM in registers; where two fit in shared memory and the items span three
//    rounds or more, an instance built for two blocks an SM runs instead, one
//    block's epilogue under the other's loads and wgmmas (plan_1x1). Cin of 8
//    but not 16 stays on route 1: a tensor map's row pitch must be a multiple
//    of 16 bytes.
// 2. depthwise (groups == Cin == Cout, a multiple of 16, 3x3): nothing for a
//    tensor core (K = 9 per channel). One thread per output pixel and 16
//    channels: the 9 taps' 16-byte loads in flight together, the 144 weight
//    bytes in registers, the same epilogue, 16-byte stores.
// 3. direct (everything else): one thread per output pixel and 16 output
//    channels, the block's weights in shared memory, a float input quantized
//    as it is loaded. For groups 1 and taps x Cin <= 32 (the 3-channel stem, fp32
//    or bf16 in) all loads go out first and the K values pack into 8 words for
//    8 __dp4a an output.
//
// C interface, bound with ctypes: launches on the caller's stream of the
// caller's device, allocates nothing, does not synchronise, and returns the
// first CUDA error, that of the launch included.

#include <cuda.h>  // CUtensorMap and its enums (the encoder lives in libcuda, found at run time: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum XType { kInt8 = 0, kBf16 = 1, kFp32 = 2 };

constexpr int kStages = 4;  // ring slots: the step in the tensor cores, the one before it, two in flight
constexpr int kChunk = 32;   // K bytes of one wgmma k32
constexpr int kChunks = 2;   // chunks a step holds: up to two wgmmas a barrier

struct Conv {
  const void* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* out;
  int b, h, w_in, cin, ho, wo, cout, kh, kw, stride, pad, groups, act, xtype;
  float sout;  // > 0: requantize to int8 at this scale; else write bf16
  float sin;   // the scale at which a bf16 or fp32 x is quantized
  const uint8_t* table;  // int8 out: the activation + requant table at (act, sout), or null
  float inv_sin;         // fl(1 / sin); inf for sin 0, which the quantize then treats as the division does
  int pitch;             // x elements from one pixel to the next: Cin, or more for a channel-split view
};


__host__ __device__ __forceinline__ int xbytes(int xtype) { return xtype == kInt8 ? 1 : xtype == kBf16 ? 2 : 4; }

// ---------------- the epilogue and the quantize, shared by every route ----------------

__device__ __forceinline__ __nv_bfloat16 affine(int acc, float scale, float bias) {  // bf16(acc * scale + bias)
  return __float2bfloat16_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias));
}

__device__ __forceinline__ __nv_bfloat16 activate(__nv_bfloat16 yb, int act) {
  if (act == 1) {  // SiLU as torch computes it on bf16: v / (1 + exp(-v)) in fp32, one rounding to bf16
    const float v = __bfloat162float(yb);
    return __float2bfloat16_rn(__fdiv_rn(v, __fadd_rn(1.0f, expf(-v))));
  }
  if (act == 2 && !(__bfloat162float(yb) > 0.0f)) return __float2bfloat16_rn(0.0f);  // ReLU
  return yb;
}

__device__ __forceinline__ __nv_bfloat16 epilogue(int acc, float scale, float bias, int act) {
  return activate(affine(acc, scale, bias), act);
}

// activate's bf16 with the SiLU's IEEE division replaced by a multiply with the approximate reciprocal where that
// cannot change the bf16: q = v * rcp.approx(d) lies within 4 fp32 ulps of fl(v / d), so both round to the same
// bf16 unless q's low 16 bits lie within 8 of the rounding point 0x8000; there (about one value in 4,000), and for
// |v| >= 64 (d near overflow), the IEEE division decides. The same bits as activate, in fewer instructions.
__device__ __forceinline__ __nv_bfloat16 activate_fast(__nv_bfloat16 yb, int act) {
  if (act != 1) return activate(yb, act);
  const float v = __bfloat162float(yb);
  const float d = __fadd_rn(1.0f, expf(-v));
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  const float q = __fmul_rn(v, r);
  const uint32_t low = __float_as_uint(q) & 0xffffu;
  if (!(fabsf(v) < 64.0f) || (low >= 0x8000u - 8 && low <= 0x8000u + 8)) return __float2bfloat16_rn(__fdiv_rn(v, d));
  return __float2bfloat16_rn(q);
}

// int8(clamp(rint(v / s), -127, 127)) as torch computes it: rint rounds half to even (torch.round), the
// division is IEEE, and a NaN stays NaN through the clamp and converts to 0
__device__ __forceinline__ uint32_t quantize(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  return static_cast<uint32_t>(q != q ? 0 : static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f))) & 0xffu;
}

// quantize(v, s) from t = v * fl(1 / s), which is within 2^-14.8 of fl(v / s) while |t| <= 200 (two roundings
// of 2^-24 each): the same rint unless t lies within 2^-13 of a half-integer, where the IEEE division decides
// (about one value in 4,000); above 200 both clamp to +-127, and NaN and inf fail the test and stay as they are
__device__ __forceinline__ uint32_t quantize_fast(float v, float s, float inv_s) {
  const float t = __fmul_rn(v, inv_s);
  float q = rintf(t);
  if (fabsf(t) <= 200.0f && 0.5f - fabsf(__fsub_rn(t, q)) <= 0x1p-13f) q = rintf(__fdiv_rn(v, s));
  return static_cast<uint32_t>(q != q ? 0 : static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f))) & 0xffu;
}

__device__ __forceinline__ uint32_t requant(__nv_bfloat16 yb, float sout) {
  return quantize(__bfloat162float(yb), sout);
}

// The requantizing epilogue's tail, activation then requant, as a table over the bf16 y: about 45
// instructions an output (expf and two IEEE divisions) become one shared-memory load, which matters
// because the bytes-bound convs move one byte per output. Index: sign, then the exponent field e in slots
// (0: e <= 110, |y| < 2^-16; 1-24: e = 111..134, one per binade; 25: e = 135..254, |y| >= 2^8; 26: e = 255,
// inf and NaN), then the 7 mantissa bits. The table kernel evaluates all 65,536 bf16 values and marks the
// table invalid (its last word) unless every y in slot 0 or 25 gives the value of its slot's entry; an
// invalid table sends the conv to the arithmetic. So a table read has the bits of the arithmetic always.
constexpr int kTabBase = 110;
constexpr int kTabSlots = 27;
constexpr int kTabBytes = 2 * kTabSlots * 128;  // 6,912; the validity word follows
// gemm1x1 reads the same function uncompressed where its shared memory has room: one byte for every bf16 y (its
// 16 bits the index, no arithmetic), after the compressed table and its validity word
constexpr int kTabFullOff = kTabBytes + 16;
constexpr int kTabFullBytes = 1 << 16;

__device__ __forceinline__ int table_index(__nv_bfloat16 yb) {
  const int bits = __bfloat16_as_ushort(yb);
  const int e = (bits >> 7) & 0xff;
  const int slot = min(max(e - kTabBase, 0), kTabSlots - 2) + ((e + 1) >> 8);
  return ((bits >> 15) * kTabSlots + slot) * 128 + (bits & 0x7f);
}

// whether the conv's output goes through the table: int8 out and a valid table (uniform for the launch)
__device__ __forceinline__ bool use_table(const Conv& p) {
  return p.table != nullptr && p.sout > 0.0f && __ldg(reinterpret_cast<const int*>(p.table + kTabBytes)) == 0;
}

__device__ __forceinline__ uint32_t bf16x2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return a | (b << 8) | (c << 16) | (d << 24);
}

// the 8 floats of 8 channels of a bf16 x (the 16 bytes of a) or an fp32 x (the 32 bytes of a, b)
__device__ __forceinline__ void unpack8(uint4 a, uint4 b, int xtype, float (&v)[8]) {
  if (xtype == kBf16) {
    const uint32_t words[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its fp32
      v[2 * i] = __uint_as_float(words[i] << 16);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  } else {
    v[0] = __uint_as_float(a.x); v[1] = __uint_as_float(a.y); v[2] = __uint_as_float(a.z); v[3] = __uint_as_float(a.w);
    v[4] = __uint_as_float(b.x); v[5] = __uint_as_float(b.y); v[6] = __uint_as_float(b.z); v[7] = __uint_as_float(b.w);
  }
}

// 8 channels of a bf16 x (the 16 bytes of a) or an fp32 x (the 32 bytes of a, b), quantized at s: 8 int8 in
// two words
__device__ __forceinline__ uint2 quantize8(uint4 a, uint4 b, int xtype, float s) {
  float v[8];
  unpack8(a, b, xtype, v);
  uint32_t q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = quantize(v[i], s);
  return make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
}

// the same from memory: 8 channels at src
__device__ __forceinline__ uint2 quantize8(const void* src, int xtype, float s) {
  const uint4* v = static_cast<const uint4*>(src);
  return quantize8(v[0], xtype == kFp32 ? v[1] : v[0], xtype, s);
}

// quantize8's int8 by quantize_fast (its bits: the IEEE division where the multiply by fl(1 / s) could round
// otherwise), from memory
__device__ __forceinline__ uint2 quantize8_fast(const void* src, int xtype, float s, float inv_s) {
  const uint4* m = static_cast<const uint4*>(src);
  float v[8];
  unpack8(m[0], xtype == kFp32 ? m[1] : m[0], xtype, v);
  uint32_t q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = quantize_fast(v[i], s, inv_s);
  return make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
}

__device__ __forceinline__ int sbyte(uint32_t word, int i) {  // the i-th int8 of a word, sign-extended
  return static_cast<int>(word << (24 - 8 * i)) >> 24;
}

// ---------------- PTX: cp.async, wgmma ----------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy `bytes` (16 or 0) from src and zero-fill the rest of the 16
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

// copy `bytes` (8 or 0) from src and zero-fill the rest of the 8
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory writes of the generic proxy (cp.async, st.shared) made visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a wgmma
template <int R>
__device__ __forceinline__ void fence_operands(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 32-byte swizzle layout (layout type 3, bits
// 62-63): each row's 32 K bytes contiguous, 8-row groups 256 bytes apart (stride byte offset, in 16-byte
// units), the two 16-byte halves of rows 4-7 of each group swapped (address bit 4 ^= bit 7). The leading
// byte offset is unused: a step's 32 K bytes are one swizzle atom wide. Measured faster than the
// unswizzled 8 x 16-byte core-matrix layout (PERF.md).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (static_cast<uint64_t>(3) << 62);
}

// byte offset of (row, K byte k) of an operand tile in its slot (slots start 256-byte aligned)
__device__ __forceinline__ int swizzled_offset(int row, int k) {
  const int off = row * kChunk + k;
  return off ^ (((off >> 7) & 1) << 4);
}

#define K8_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define K8_R8(i) K8_R4(i), K8_R4(i + 4)

// wgmma.mma_async m64nNk32, s32 += s8 * s8, A and B K-major in shared memory, d += A * B^T.
// The accumulator of thread t of the warpgroup: d[4j + e] is row 16 * (t / 32) + (t % 32) / 4 + 8 * (e / 2),
// column 8j + 2 * (t % 4) + e % 2.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p;\n}\n"
        : K8_R4(0)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p;\n}\n"
        : K8_R8(0)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p;\n}\n"
        : K8_R8(0), K8_R8(8)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : K8_R8(0), K8_R8(8), K8_R8(16), K8_R8(24)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<80> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[40], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39}, "
        "%40, %41, p;\n}\n"
        : K8_R8(0), K8_R8(8), K8_R8(16), K8_R8(24),
          K8_R8(32)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : K8_R8(0), K8_R8(8), K8_R8(16), K8_R8(24),
          K8_R8(32), K8_R8(40), K8_R8(48), K8_R8(56)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef K8_R8
#undef K8_R4

// ---------------- route 1: the implicit GEMM ----------------

template <int BN, int WG>
struct GemmTile {
  static constexpr int kBM = 64 * WG;  // output pixels
  static constexpr int kThreads = 128 * WG;
  static constexpr int kSlotA = kChunks * kBM * kChunk;  // a step's A: kChunks sub-tiles of kBM rows x 32 bytes
  static constexpr int kSlotB = kChunks * BN * kChunk;
  static constexpr int kBTasks = (2 * BN * kChunks + kThreads - 1) / kThreads;  // B copies a thread issues
  static constexpr int kRing = kStages * (kSlotA + kSlotB);
  static constexpr int kStageRow = BN * 2 + 16;  // a staged output row: bf16 at most, 16 bytes apart
  static constexpr int kTable = kRing + kBM * kStageRow;  // after the ring and the staged tile
  static constexpr int kParams = kTable + kTabBytes;      // then scale and bias of every output channel
  static constexpr int smem(int cout) { return kParams + 8 * cout; }
};

// Persistent: block b takes tiles b, b + grid, ... (tile = M tile * N tiles + N tile) and walks their K steps
// as one stream, so the copies of the next tile's first steps are in flight during a tile's epilogue.
template <int BN, int WG>
__global__ void __launch_bounds__(128 * WG, 1) int8_conv_gemm(Conv p, int granule) {
  using T = GemmTile<BN, WG>;
  extern __shared__ __align__(1024) uint8_t smem[];
  float* s_scale = reinterpret_cast<float*>(smem + T::kParams);
  float* s_bias = s_scale + p.cout;
  const uint8_t* s_tab = smem + T::kTable;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int hw = p.ho * p.wo, M = p.b * hw;
  const int n_tiles = p.cout / BN;
  const int tiles = (M + T::kBM - 1) / T::kBM * n_tiles;
  const int K = p.kh * p.kw * p.cin;  // walked flat, k = (ky * kw + kx) * Cin + c, in steps of kChunks chunks
  const int tile_steps = (K + kChunks * kChunk - 1) / (kChunks * kChunk);
  const int steps = (static_cast<int>(blockIdx.x) < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0) * tile_steps;
  const int xes = xbytes(p.xtype);

  for (int i = tid; i < p.cout; i += T::kThreads) {
    s_scale[i] = p.scale[i];
    s_bias[i] = p.bias[i];
  }
  const bool tab = use_table(p);
  if (tab)
    for (int i = tid; i < kTabBytes / 16; i += T::kThreads)
      reinterpret_cast<uint4*>(smem + T::kTable)[i] = reinterpret_cast<const uint4*>(p.table)[i];

  // The loader. A: the thread's output pixel (row) and 16-byte K half of each chunk, whose tap and channel
  // follow from k (a K half lies in one tap: Cin is a multiple of 16, or of 8 with 8-byte pieces); B: the
  // weight row n and K half of each of the thread's copies, OHWI viewed as Cout x K.
  const int row = tid >> 1, half = tid & 1;
  const int a_dst = swizzled_offset(row, half * 16);
  const uint32_t m_cin = 0xffffffffu / p.cin + 1, m_kw = p.kw > 1 ? 0xffffffffu / p.kw + 1 : 0;
  int b_row[T::kBTasks], b_dst[T::kBTasks], b_k[T::kBTasks];
#pragma unroll
  for (int i = 0; i < T::kBTasks; ++i) {
    const int task = tid + i * T::kThreads;
    const int kc = task / (2 * BN), n = (task >> 1) % BN, hb = task & 1;
    b_k[i] = task < 2 * BN * kChunks ? kc * kChunk + hb * 16 : 1 << 30;  // K offset in the step
    b_row[i] = n * K;
    b_dst[i] = kc * (T::kSlotB / kChunks) + swizzled_offset(n, hb * 16);
  }
  // the load position: tile and step in it
  int ld_tile = blockIdx.x, ld_step = 0;
  bool ld_ok = false;
  int ld_iy0 = 0, ld_ix0 = 0, ld_wbase = 0;
  long long ld_xrow = 0;  // element offset of the thread's pixel at tap (0, 0)
  auto set_tile = [&]() {
    const int mt = ld_tile / n_tiles;
    const int m = mt * T::kBM + row;
    ld_ok = m < M;
    const int bi = ld_ok ? m / hw : 0, rem = ld_ok ? m - bi * hw : 0;
    const int oy = rem / p.wo, ox = rem - oy * p.wo;
    ld_iy0 = oy * p.stride - p.pad;
    ld_ix0 = ox * p.stride - p.pad;
    ld_xrow = ((long long)(bi * p.h + ld_iy0) * p.w_in + ld_ix0) * p.pitch;
    ld_wbase = (ld_tile - mt * n_tiles) * BN * K;
  };
  set_tile();
  // the x offset of K index k for this thread's pixel, or -1 where it is zero (past K, or padding)
  auto x_offset = [&](int k) -> long long {
    if (k >= K || !ld_ok) return -1;
    const int tap = __umulhi(k, m_cin), c = k - tap * p.cin;
    const int ky = p.kw > 1 ? __umulhi(tap, m_kw) : tap, kx = tap - ky * p.kw;
    const int iy = ld_iy0 + ky, ix = ld_ix0 + kx;
    if (iy < 0 || iy >= p.h || ix < 0 || ix >= p.w_in) return -1;
    return ld_xrow + (long long)(ky * p.w_in + kx) * p.pitch + c;
  };
  auto load_next = [&](int slot) {
    const int k0 = ld_step * kChunks * kChunk;  // the step's first K index
    uint8_t* sa = smem + slot * T::kSlotA;
    const uint8_t* xb = static_cast<const uint8_t*>(p.x);
#pragma unroll
    for (int kc = 0; kc < kChunks; ++kc) {
      const int k = k0 + kc * kChunk + half * 16;
      if (k0 + kc * kChunk >= K) break;  // a chunk past K: its wgmma is not issued
      uint8_t* dst = sa + kc * (T::kSlotA / kChunks) + a_dst;
      const long long o0 = x_offset(k), o1 = granule == 16 ? (o0 < 0 ? -1 : o0 + 8) : x_offset(k + 8);
      if (p.xtype == kInt8) {
        if (granule == 16) {
          cp_async16(smem_addr(dst), o0 < 0 ? p.x : xb + o0, o0 < 0 ? 0 : 16);
        } else {
          cp_async8(smem_addr(dst), o0 < 0 ? p.x : xb + o0, o0 < 0 ? 0 : 8);
          cp_async8(smem_addr(dst + 8), o1 < 0 ? p.x : xb + o1, o1 < 0 ? 0 : 8);
        }
      } else {  // bf16 or fp32: quantize in registers, store int8
        const uint2 zero = make_uint2(0u, 0u);
        const uint2 lo = o0 < 0 ? zero : quantize8(xb + o0 * xes, p.xtype, p.sin);
        const uint2 hi = o1 < 0 ? zero : quantize8(xb + o1 * xes, p.xtype, p.sin);
        *reinterpret_cast<uint4*>(dst) = make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
    }
    uint8_t* sb = smem + kStages * T::kSlotA + slot * T::kSlotB;
    const int8_t* wrow = p.w + ld_wbase + k0;
#pragma unroll
    for (int i = 0; i < T::kBTasks; ++i) {
      const int k = k0 + b_k[i];
      if (k - b_k[i] % kChunk < K) {  // the copy's chunk has K indices (b_k is past them all without a task)
        const uint32_t dst = smem_addr(sb + b_dst[i]);
        const int8_t* src = wrow + b_row[i] + b_k[i];
        if (granule == 16) {
          cp_async16(dst, k < K ? src : p.w, k < K ? 16 : 0);
        } else {
          cp_async8(dst, k < K ? src : p.w, k < K ? 8 : 0);
          cp_async8(dst + 8, k + 8 < K ? src + 8 : p.w, k + 8 < K ? 8 : 0);
        }
      }
    }
    if (++ld_step == tile_steps) {
      ld_step = 0;
      ld_tile += gridDim.x;
      set_tile();
    }
  };

  uint32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0u;

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < steps) load_next(s);
    cp_async_commit();
  }
  const bool q8 = p.sout > 0.0f;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  int tile = blockIdx.x, tile_step = 0;  // the computed step's tile and index in the tile
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kStages - 3>();  // this thread's copies of step kt have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have, every warpgroup is done with step kt - 2's slot, the staged tile is out
    const int slot = kt % kStages;
    const uint32_t a = smem_addr(smem + slot * T::kSlotA + wg * 64 * kChunk);
    const uint32_t b = smem_addr(smem + kStages * T::kSlotA + slot * T::kSlotB);
    const int chunks = min(kChunks, (K - tile_step * kChunks * kChunk + kChunk - 1) / kChunk);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kChunks; ++kc)
      if (kc < chunks)
        Wgmma<BN>::mma(acc, smem_desc(a + kc * (T::kSlotA / kChunks)), smem_desc(b + kc * (T::kSlotB / kChunks)));
    wgmma_commit();
    if (kt + kStages - 2 < steps) load_next((kt + kStages - 2) % kStages);  // into the slot of step kt - 2
    cp_async_commit();
    if (++tile_step < tile_steps) {
      wgmma_wait<1>();  // step kt - 1 is done
      fence_operands(acc);
      continue;
    }
    // the tile's last step: its epilogue in registers, into the staged tile (row stride kStageRow), while
    // the copies of the next tile's first steps are in flight
    tile_step = 0;
    wgmma_wait<0>();
    fence_operands(acc);
    const int mt = tile / n_tiles;
    const int m0 = mt * T::kBM, n0 = (tile - mt * n_tiles) * BN;
    uint8_t* staged = smem + T::kRing;
    if (tab) {  // int8 out through the table
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = r0 + 8 * (e >> 1), col = n0 + 8 * j + c0;
          const uint32_t q0 = s_tab[table_index(affine(static_cast<int>(acc[4 * j + e]), s_scale[col], s_bias[col]))];
          const uint32_t q1 = s_tab[table_index(
              affine(static_cast<int>(acc[4 * j + e + 1]), s_scale[col + 1], s_bias[col + 1]))];
          *reinterpret_cast<uint16_t*>(staged + r * T::kStageRow + col - n0) = static_cast<uint16_t>(q0 | (q1 << 8));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = r0 + 8 * (e >> 1), col = n0 + 8 * j + c0;
          const __nv_bfloat16 y0 = epilogue(static_cast<int>(acc[4 * j + e]), s_scale[col], s_bias[col], p.act);
          const __nv_bfloat16 y1 =
              epilogue(static_cast<int>(acc[4 * j + e + 1]), s_scale[col + 1], s_bias[col + 1], p.act);
          uint8_t* dst = staged + r * T::kStageRow;
          if (q8)
            *reinterpret_cast<uint16_t*>(dst + col - n0) =
                static_cast<uint16_t>(requant(y0, p.sout) | (requant(y1, p.sout) << 8));
          else
            *reinterpret_cast<uint32_t*>(dst + 2 * (col - n0)) = bf16x2(y0, y1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0u;
    __syncthreads();
    // the tile out: rows of BN * esize bytes, each at (m * Cout + n0) * esize, in 16- (or 8-) byte stores
    const int es = q8 ? 1 : 2;
    const int vec = BN * es % 16 == 0 ? 16 : 8;
    const int per_row = BN * es / vec;
    for (int v = tid; v < T::kBM * per_row; v += T::kThreads) {
      const int r = v / per_row, cv = v - r * per_row;
      if (m0 + r >= M) break;  // rows ascend with v
      uint8_t* dst = static_cast<uint8_t*>(p.out) + ((size_t)(m0 + r) * p.cout + n0) * es + cv * vec;
      const uint8_t* src = staged + r * T::kStageRow + cv * vec;
      if (vec == 16)
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      else
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    }
    tile += gridDim.x;
  }
  cp_async_wait<0>();
}

// ---------------- route 4: 1x1 convs by TMA, warp-specialised ----------------

constexpr int k1BM = 128;          // output pixels of an M tile: two consumer warpgroups of 64 rows
constexpr int k1Threads = 288;     // the two consumer warpgroups (threads 0-255) and the producer warp
constexpr int k1Step = 64;         // K bytes a step: two wgmma k32 chunks
constexpr int k1SlotA = k1BM * k1Step;  // an A slot: chunk c's 128 rows x 32 bytes at c * 4,096
constexpr int k1BStages = 4;       // B ring slots
constexpr int k1RawStages = 2;     // staging slots of a float x's raw tile (128 rows x 64 elements)

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive and add `bytes` of TMA transactions to the phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// until the phase of this parity has completed (a fresh barrier's phase "before 0", parity 1, counts as complete);
// a wait of more than 2^32 cycles (seconds: a fault, never a slow load) traps, so the launch fails, not hangs
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1LL << 32)) __trap();
  } while (!done);
}

// a 2-D TMA load of the box at (column c0, row c1) of the tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The shared memory of a gemm1x1 block: A slots (a_sets x k_steps), the B ring, the raw ring (float x), the staged
// output tile (rows of BN outputs of `oes` bytes), the requant table, scale and bias, then the barriers (a_full,
// a_empty per A slot; b_full, b_empty; raw_full, raw_empty)
struct Smem1x1 {
  int a, b, raw, staged, table, params, bars, total;
};

__host__ __device__ inline int stage_row_1x1(int bn, int oes) { return bn * oes + 16; }

__host__ __device__ inline Smem1x1 smem_1x1(int bn, int xes, int oes, int k_steps, int a_sets, int cout,
                                             int full_tab) {
  Smem1x1 L;
  int at = 0;
  L.a = at;
  at += a_sets * k_steps * k1SlotA;
  L.b = at;
  at += k1BStages * bn * k1Step;
  L.raw = at;
  at += xes == 1 ? 0 : k1RawStages * k1BM * k1Step * xes;
  L.staged = at;
  at += k1BM * stage_row_1x1(bn, oes);
  L.table = at;
  at += full_tab ? kTabFullBytes : kTabBytes;
  L.params = at;
  at += 8 * cout;
  L.bars = (at + 7) / 8 * 8;
  at = L.bars + 8 * (2 * a_sets * k_steps + 2 * k1BStages + 2 * k1RawStages);
  L.total = at;
  return L;
}

// Persistent: block i takes work items i, i + grid, ...; item w is M tile w / groups and the w % groups-th group
// of its N tiles (groups > 1 only where the M tiles alone would leave the card's blocks idle); an item walks its N
// tiles (tile nt covers output channels nt * BN ...), each N tile its K steps. A of an item (k_steps slots) is
// loaded once, at its first N tile; B of every (N tile, K step) goes through the ring. MINB 2: the instance held
// to the registers of two blocks an SM (N tiles of 128 need more for one).
template <int BN, int MINB = 1>
__global__ void __launch_bounds__(k1Threads, MINB)
    int8_conv_1x1(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b, Conv p,
                  int a_sets, int groups, int full_tab) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  const int M = p.b * p.ho * p.wo;
  const int m_tiles = (M + k1BM - 1) / k1BM, per_group = p.cout / BN / groups, items = m_tiles * groups;
  const int k_steps = (p.cin + k1Step - 1) / k1Step;
  const int xes = xbytes(p.xtype);
  const bool quant = p.xtype != kInt8, q8 = p.sout > 0.0f;
  // int8 out by the table: whole (every bf16 y's entry computed, no compression to check) where planned, else the
  // compressed one where its check passed
  const bool whole = full_tab && p.table != nullptr && q8, tab = whole || use_table(p);
  const Smem1x1 L = smem_1x1(BN, xes, q8 ? 1 : 2, k_steps, a_sets, p.cout, whole);
  float* s_scale = reinterpret_cast<float*>(smem + L.params);
  float* s_bias = s_scale + p.cout;
  const uint8_t* s_tab = smem + L.table;
  const uint32_t bars = smem_addr(smem + L.bars);
  const int n_a = a_sets * k_steps;
  auto a_full = [&](int i) { return bars + 8 * i; };
  auto a_empty = [&](int i) { return bars + 8 * (n_a + i); };
  auto b_full = [&](int i) { return bars + 8 * (2 * n_a + i); };
  auto b_empty = [&](int i) { return bars + 8 * (2 * n_a + k1BStages + i); };
  auto raw_full = [&](int i) { return bars + 8 * (2 * n_a + 2 * k1BStages + i); };
  auto raw_empty = [&](int i) { return bars + 8 * (2 * n_a + 2 * k1BStages + k1RawStages + i); };

  for (int i = tid; i < p.cout; i += k1Threads) {
    s_scale[i] = p.scale[i];
    s_bias[i] = p.bias[i];
  }
  if (tab)
    for (int i = tid; i < (whole ? kTabFullBytes : kTabBytes) / 16; i += k1Threads)
      reinterpret_cast<uint4*>(smem + L.table)[i] =
          reinterpret_cast<const uint4*>(p.table + (whole ? kTabFullOff : 0))[i];
  if (tid == 0) {
    for (int i = 0; i < n_a; ++i) {
      mbar_init(a_full(i), 1);   // the producer's expect_tx
      mbar_init(a_empty(i), 8);  // lane 0 of each consumer warp, after its wgmma wait
    }
    for (int i = 0; i < k1BStages; ++i) {
      mbar_init(b_full(i), 1);
      mbar_init(b_empty(i), 8);
    }
    for (int i = 0; i < k1RawStages; ++i) {
      mbar_init(raw_full(i), 1);
      mbar_init(raw_empty(i), 2);  // one thread of each consumer warpgroup, after its named barrier
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp: one lane issues every load, in the order the consumers take them
    if (tid == 256) {
      int bi = 0, ri = 0, mi = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x, ++mi) {
        const int mt = w / groups, nt0 = (w - mt * groups) * per_group;
        const int set = mi % a_sets;
        const uint32_t a_parity = (mi / a_sets) & 1;
        for (int nt = nt0; nt < nt0 + per_group; ++nt) {
          for (int ks = 0; ks < k_steps; ++ks) {
            const int chunks = min(2, (p.cin - ks * k1Step + kChunk - 1) / kChunk);
            if (nt == nt0 && !quant) {  // A's step into its slot, once per item
              const int slot = set * k_steps + ks;
              mbar_wait(a_empty(slot), a_parity ^ 1);
              mbar_expect(a_full(slot), chunks * k1BM * kChunk);
              for (int c = 0; c < chunks; ++c)
                tma_load(smem_addr(smem + L.a + slot * k1SlotA + c * (k1BM * kChunk)), &map_a,
                         ks * k1Step + c * kChunk, mt * k1BM, a_full(slot));
            } else if (nt == nt0) {  // a float x's raw step into the staging ring
              const int slot = ri % k1RawStages;
              mbar_wait(raw_empty(slot), ((ri / k1RawStages) & 1) ^ 1);
              mbar_expect(raw_full(slot), k1BM * k1Step * xes);
              tma_load(smem_addr(smem + L.raw + slot * k1BM * k1Step * xes), &map_a, ks * k1Step, mt * k1BM,
                       raw_full(slot));
              ++ri;
            }
            const int slot = bi % k1BStages;
            mbar_wait(b_empty(slot), ((bi / k1BStages) & 1) ^ 1);
            mbar_expect(b_full(slot), chunks * BN * kChunk);
            for (int c = 0; c < chunks; ++c)
              tma_load(smem_addr(smem + L.b + slot * BN * k1Step + c * (BN * kChunk)), &map_b,
                       ks * k1Step + c * kChunk, nt * BN, b_full(slot));
            ++bi;
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows wg * 64 ... of each M tile
  const int wg = tid >> 7, wt = tid & 127;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  const int stage_row = stage_row_1x1(BN, q8 ? 1 : 2);
  uint8_t* staged = smem + L.staged + wg * 64 * stage_row;
  uint32_t acc[BN / 2];
  int bi = 0, ri = 0, mi = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x, ++mi) {
    const int mt = w / groups, nt0 = (w - mt * groups) * per_group;
    const int set = quant ? 0 : mi % a_sets;
    const uint32_t a_parity = (mi / a_sets) & 1;
    for (int nt = nt0; nt < nt0 + per_group; ++nt) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0u;
      const bool last_nt = nt == nt0 + per_group - 1;
      for (int ks = 0; ks < k_steps; ++ks) {
        const int chunks = min(2, (p.cin - ks * k1Step + kChunk - 1) / kChunk);
        const int a_slot = set * k_steps + ks;
        uint8_t* sa = smem + L.a + a_slot * k1SlotA;
        if (nt == nt0 && quant) {  // this warpgroup's 64 rows of the raw step, quantized into the A slot
          const int slot = ri % k1RawStages;
          mbar_wait(raw_full(slot), (ri / k1RawStages) & 1);
          const uint8_t* raw = smem + L.raw + slot * k1BM * k1Step * xes;
          for (int g = wt; g < 64 * 8; g += 128) {  // 8 elements (a 16- or 32-byte run of a row) at a time
            const int r = wg * 64 + (g >> 3), kg = g & 7;
            const uint2 q = quantize8_fast(raw + (r * k1Step + kg * 8) * xes, p.xtype, p.sin, p.inv_sin);
            *reinterpret_cast<uint2*>(sa + (kg >> 2) * (k1BM * kChunk) + swizzled_offset(r, (kg & 3) * 8)) = q;
          }
          fence_proxy_async();  // the stores, visible to the wgmmas
          named_sync(1 + wg, 128);
          if (wt == 0) mbar_arrive(raw_empty(slot));
          ++ri;
        } else if (nt == nt0) {
          mbar_wait(a_full(a_slot), a_parity);
        }
        const int b_slot = bi % k1BStages;
        mbar_wait(b_full(b_slot), (bi / k1BStages) & 1);
        const uint32_t a = smem_addr(sa + wg * 64 * kChunk);
        const uint32_t b = smem_addr(smem + L.b + b_slot * BN * k1Step);
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (c < chunks)
            Wgmma<BN>::mma(acc, smem_desc(a + c * (k1BM * kChunk)), smem_desc(b + c * (BN * kChunk)));
        wgmma_commit();
        wgmma_wait<1>();  // the step before is done: its slots go back
        fence_operands(acc);
        if (ks > 0 && lane == 0) {
          mbar_arrive(b_empty((bi - 1) % k1BStages));
          if (last_nt && !quant) mbar_arrive(a_empty(a_slot - 1));
        }
        ++bi;
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) {
        mbar_arrive(b_empty((bi - 1) % k1BStages));
        if (last_nt && !quant) mbar_arrive(a_empty(set * k_steps + k_steps - 1));
      }
      // the epilogue in registers, into this warpgroup's 64 staged rows, then out in 16- (or 8-) byte stores
      const int n0 = nt * BN;
      if (whole) {  // int8 out: the table's byte at y's 16 bits
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int r = r0 + 8 * (e >> 1), col = n0 + 8 * j + c0;
            const uint32_t q0 = s_tab[__bfloat16_as_ushort(
                affine(static_cast<int>(acc[4 * j + e]), s_scale[col], s_bias[col]))];
            const uint32_t q1 = s_tab[__bfloat16_as_ushort(
                affine(static_cast<int>(acc[4 * j + e + 1]), s_scale[col + 1], s_bias[col + 1]))];
            *reinterpret_cast<uint16_t*>(staged + r * stage_row + col - n0) = static_cast<uint16_t>(q0 | (q1 << 8));
          }
        }
      } else if (tab) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int r = r0 + 8 * (e >> 1), col = n0 + 8 * j + c0;
            const uint32_t q0 = s_tab[table_index(affine(static_cast<int>(acc[4 * j + e]), s_scale[col], s_bias[col]))];
            const uint32_t q1 = s_tab[table_index(
                affine(static_cast<int>(acc[4 * j + e + 1]), s_scale[col + 1], s_bias[col + 1]))];
            *reinterpret_cast<uint16_t*>(staged + r * stage_row + col - n0) = static_cast<uint16_t>(q0 | (q1 << 8));
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int r = r0 + 8 * (e >> 1), col = n0 + 8 * j + c0;
            const __nv_bfloat16 y0 =
                activate_fast(affine(static_cast<int>(acc[4 * j + e]), s_scale[col], s_bias[col]), p.act);
            const __nv_bfloat16 y1 =
                activate_fast(affine(static_cast<int>(acc[4 * j + e + 1]), s_scale[col + 1], s_bias[col + 1]), p.act);
            uint8_t* dst = staged + r * stage_row;
            if (q8)
              *reinterpret_cast<uint16_t*>(dst + col - n0) =
                  static_cast<uint16_t>(requant(y0, p.sout) | (requant(y1, p.sout) << 8));
            else
              *reinterpret_cast<uint32_t*>(dst + 2 * (col - n0)) = bf16x2(y0, y1);
          }
        }
      }
      named_sync(1 + wg, 128);
      const int es = q8 ? 1 : 2;
      const int vec = BN * es % 16 == 0 ? 16 : 8;
      const int per_row = BN * es / vec;
      const int m0 = mt * k1BM + wg * 64;
      for (int v = wt; v < 64 * per_row; v += 128) {
        const int r = v / per_row, cv = v - r * per_row;
        if (m0 + r >= M) break;  // rows ascend with v
        uint8_t* dst = static_cast<uint8_t*>(p.out) + ((size_t)(m0 + r) * p.cout + n0) * es + cv * vec;
        const uint8_t* src = staged + r * stage_row + cv * vec;
        if (vec == 16)
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        else
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      }
      named_sync(1 + wg, 128);  // the staged rows are free for the next tile
    }
  }
}

// ---------------- route 2: depthwise 3x3 ----------------

constexpr int kDwThreads = 256;

__global__ void __launch_bounds__(kDwThreads) int8_conv_depthwise(Conv p) {
  const int groups16 = p.cin / 16;
  const size_t idx = (size_t)blockIdx.x * kDwThreads + threadIdx.x;
  const size_t total = (size_t)p.b * p.ho * p.wo * groups16;
  if (idx >= total) return;
  const int g = static_cast<int>(idx % groups16);
  const size_t pix = idx / groups16;
  const int ox = static_cast<int>(pix % p.wo), oy = static_cast<int>((pix / p.wo) % p.ho);
  const size_t bi = pix / ((size_t)p.wo * p.ho);
  const int c0 = g * 16;
  // the 16 channels' 3x3 weights, OHWI with I = 1: 144 bytes from w + 9 * c0, channel c's tap t at 9c + t
  uint32_t wr[36];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const uint4 v = reinterpret_cast<const uint4*>(p.w + 9 * c0)[i];
    wr[4 * i] = v.x; wr[4 * i + 1] = v.y; wr[4 * i + 2] = v.z; wr[4 * i + 3] = v.w;
  }
  const int es = xbytes(p.xtype);
  // the 9 taps' 16 channels as int8: for an int8 x all 9 loads go out before the first use
  uint32_t xv[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int iy = oy * p.stride - p.pad + t / 3, ix = ox * p.stride - p.pad + t % 3;
    const bool in = iy >= 0 && iy < p.h && ix >= 0 && ix < p.w_in;  // zero padding adds nothing
    const uint8_t* src = static_cast<const uint8_t*>(p.x) + (((bi * p.h + iy) * p.w_in + ix) * p.pitch + c0) * es;
    if (p.xtype == kInt8) {
      const uint4 v = in ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
      xv[t][0] = v.x; xv[t][1] = v.y; xv[t][2] = v.z; xv[t][3] = v.w;
    } else {
      const uint2 zero = make_uint2(0u, 0u);
      const uint2 lo = in ? quantize8(src, p.xtype, p.sin) : zero;
      const uint2 hi = in ? quantize8(src + 8 * es, p.xtype, p.sin) : zero;
      xv[t][0] = lo.x; xv[t][1] = lo.y; xv[t][2] = hi.x; xv[t][3] = hi.y;
    }
  }
  int acc[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) acc[c] = 0;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[c] += sbyte(xv[t][c >> 2], c & 3) * sbyte(wr[(9 * c + t) >> 2], (9 * c + t) & 3);
  }
  uint8_t* out = static_cast<uint8_t*>(p.out);
  if (p.sout > 0.0f) {
    uint32_t q[16];
    if (use_table(p)) {
#pragma unroll
      for (int c = 0; c < 16; ++c) q[c] = __ldg(p.table + table_index(affine(acc[c], p.scale[c0 + c], p.bias[c0 + c])));
    } else {
#pragma unroll
      for (int c = 0; c < 16; ++c) q[c] = requant(epilogue(acc[c], p.scale[c0 + c], p.bias[c0 + c], p.act), p.sout);
    }
    *reinterpret_cast<uint4*>(out + pix * p.cout + c0) =
        make_uint4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]), pack4(q[8], q[9], q[10], q[11]),
                   pack4(q[12], q[13], q[14], q[15]));
  } else {
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = bf16x2(epilogue(acc[2 * i], p.scale[c0 + 2 * i], p.bias[c0 + 2 * i], p.act),
                    epilogue(acc[2 * i + 1], p.scale[c0 + 2 * i + 1], p.bias[c0 + 2 * i + 1], p.act));
    uint4* dst = reinterpret_cast<uint4*>(out + (pix * p.cout + c0) * 2);
    dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
    dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// ---------------- route 3: direct ----------------

constexpr int kOC = 16;            // output channels per thread
constexpr int kDirectThreads = 128;  // output pixels per block

__device__ __forceinline__ int load_q(const Conv& p, size_t i) {  // x[i] as int8, quantized if float
  if (p.xtype == kInt8) return static_cast<const int8_t*>(p.x)[i];
  const float v = p.xtype == kBf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.x)[i])
                                   : static_cast<const float*>(p.x)[i];
  return static_cast<int>(quantize_fast(v, p.sin, p.inv_sin) << 24) >> 24;
}

// the epilogue of output channels oc0..oc0 + 15 (those below Cout) of pixel pix, stored at (pix, oc0)
__device__ __forceinline__ void store16(const Conv& p, const int (&acc)[kOC], size_t pix, int oc0) {
  const size_t idx = pix * p.cout + oc0;
  if (p.sout > 0.0f) {
    int8_t* out = static_cast<int8_t*>(p.out);
    const bool tab = use_table(p);
    uint32_t q[kOC];
#pragma unroll
    for (int o = 0; o < kOC; ++o) {
      const int oc = min(oc0 + o, p.cout - 1);
      const __nv_bfloat16 y = affine(acc[o], p.scale[oc], p.bias[oc]);
      q[o] = tab ? __ldg(p.table + table_index(y)) : requant(activate(y, p.act), p.sout);
    }
    if (p.cout % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
      *reinterpret_cast<uint4*>(out + idx) =
          make_uint4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]), pack4(q[8], q[9], q[10], q[11]),
                     pack4(q[12], q[13], q[14], q[15]));
    } else {
#pragma unroll
      for (int o = 0; o < kOC; ++o)
        if (oc0 + o < p.cout) out[idx + o] = static_cast<int8_t>(q[o]);
    }
  } else {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
    for (int o = 0; o < kOC; ++o)
      if (oc0 + o < p.cout) out[idx + o] = epilogue(acc[o], p.scale[oc0 + o], p.bias[oc0 + o], p.act);
  }
}

__global__ void __launch_bounds__(kDirectThreads) int8_conv_direct(Conv p) {
  extern __shared__ __align__(16) unsigned char smem_w[];
  const int8_t* s_w = reinterpret_cast<const int8_t*>(smem_w);  // s_w[o * row + tap * cin_g + c]
  const int cin_g = p.cin / p.groups, cout_g = p.cout / p.groups;
  const int taps = p.kh * p.kw, row = taps * cin_g;
  const int oc0 = blockIdx.y * kOC;
  for (int t = threadIdx.x; t < row * kOC; t += kDirectThreads) {
    const int o = t / row, r = t - o * row;
    smem_w[t] = oc0 + o < p.cout ? p.w[(size_t)(oc0 + o) * row + r] : 0;
  }
  __syncthreads();

  const size_t npix = (size_t)p.b * p.ho * p.wo;
  const size_t pix = (size_t)blockIdx.x * kDirectThreads + threadIdx.x;
  if (pix >= npix) return;
  const int ox = static_cast<int>(pix % p.wo), oy = static_cast<int>((pix / p.wo) % p.ho);
  const size_t bi = pix / ((size_t)p.wo * p.ho);
  const bool one_group = (oc0 / cout_g) == (min(oc0 + kOC, p.cout) - 1) / cout_g;  // one input load for all 16

  int acc[kOC];
#pragma unroll
  for (int o = 0; o < kOC; ++o) acc[o] = 0;
  for (int ky = 0; ky < p.kh; ++ky) {
    const int iy = oy * p.stride - p.pad + ky;
    if (iy < 0 || iy >= p.h) continue;
    for (int kx = 0; kx < p.kw; ++kx) {
      const int ix = ox * p.stride - p.pad + kx;
      if (ix < 0 || ix >= p.w_in) continue;  // zero padding adds nothing
      const int tap = ky * p.kw + kx;
      const size_t base = ((bi * p.h + iy) * p.w_in + ix) * p.pitch;
      if (one_group) {
        const size_t xg = base + (size_t)(oc0 / cout_g) * cin_g;
        for (int c = 0; c < cin_g; ++c) {
          const int xv = load_q(p, xg + c);
#pragma unroll
          for (int o = 0; o < kOC; ++o) acc[o] += xv * s_w[o * row + tap * cin_g + c];
        }
      } else {
#pragma unroll
        for (int o = 0; o < kOC; ++o) {
          if (oc0 + o >= p.cout) break;
          const size_t xg = base + (size_t)((oc0 + o) / cout_g) * cin_g;
          int a = acc[o];
          for (int c = 0; c < cin_g; ++c) a += load_q(p, xg + c) * s_w[o * row + tap * cin_g + c];
          acc[o] = a;
        }
      }
    }
  }
  store16(p, acc, pix, oc0);
}

constexpr int kStemTW = 32, kStemTH = 4;  // the stem kernel's output tile: one pixel a thread

// The direct route for groups 1 and taps x Cin <= 32 (the 3-channel stem, fp32 or bf16 in): the block
// quantizes its input tile once into shared memory, reading whole rows (coalesced; each input value serves
// up to 9 outputs), then each thread packs its K values into 8 words and takes 8 __dp4a an output, for
// every output channel.
__global__ void __launch_bounds__(kStemTW * kStemTH) int8_conv_stem(Conv p) {
  extern __shared__ __align__(16) unsigned char smem_s[];
  const int K = p.kh * p.kw * p.cin;
  const int row_bytes = ((kStemTW - 1) * p.stride + p.kw) * p.cin, rows = (kStemTH - 1) * p.stride + p.kh;
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem_s);  // s_w[o * 8 + word]: K zero-padded to 32
  int8_t* s_x = reinterpret_cast<int8_t*>(smem_s + p.cout * 32);  // s_x[r * row_bytes + column * Cin + c]
  const int ox0 = blockIdx.x * kStemTW, oy0 = blockIdx.y * kStemTH, bi = blockIdx.z;
  const int ixc0 = (ox0 * p.stride - p.pad) * p.cin, iy0 = oy0 * p.stride - p.pad;
  for (int t = threadIdx.x; t < p.cout * 8; t += kStemTW * kStemTH) {
    const int o = t >> 3, k = 4 * (t & 7);
    uint32_t word = 0;
    for (int i = 0; i < 4; ++i)
      if (k + i < K) word |= static_cast<uint32_t>(static_cast<uint8_t>(p.w[o * K + k + i])) << (8 * i);
    s_w[t] = word;
  }
  for (int t = threadIdx.x; t < rows * row_bytes; t += kStemTW * kStemTH) {
    const int r = t / row_bytes, iy = iy0 + r, ixc = ixc0 + (t - r * row_bytes);  // ixc = ix * Cin + c
    const bool in = iy >= 0 && iy < p.h && ixc >= 0 && ixc < p.w_in * p.cin;  // zero padding stays 0
    const size_t row = (static_cast<size_t>(bi) * p.h + iy) * p.w_in;  // a pixel row: x's ixc-th element, at its pitch
    const int ix = p.pitch == p.cin || !in ? 0 : ixc / p.cin;
    s_x[t] = static_cast<int8_t>(
        in ? load_q(p, p.pitch == p.cin ? row * p.cin + ixc : (row + ix) * p.pitch + ixc - ix * p.cin) : 0);
  }
  __syncthreads();
  const int tx = threadIdx.x % kStemTW, ty = threadIdx.x / kStemTW;
  const int ox = ox0 + tx, oy = oy0 + ty;
  if (ox >= p.wo || oy >= p.ho) return;
  uint32_t xw[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) xw[i] = 0u;
  int c = 0, kx = 0, ky = 0;  // k = (ky * kw + kx) * Cin + c
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (k < K) {
      const int8_t v = s_x[(ty * p.stride + ky) * row_bytes + (tx * p.stride + kx) * p.cin + c];
      xw[k >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * (k & 3));
      if (++c == p.cin) {
        c = 0;
        if (++kx == p.kw) {
          kx = 0;
          ++ky;
        }
      }
    }
  }
  const size_t pix = (static_cast<size_t>(bi) * p.ho + oy) * p.wo + ox;
  for (int oc0 = 0; oc0 < p.cout; oc0 += kOC) {
    int acc[kOC];
#pragma unroll
    for (int o = 0; o < kOC; ++o) {
      const uint4* w = reinterpret_cast<const uint4*>(s_w + min(oc0 + o, p.cout - 1) * 8);
      const uint4 w0 = w[0], w1 = w[1];
      int a = __dp4a(static_cast<int>(xw[0]), static_cast<int>(w0.x), 0);
      a = __dp4a(static_cast<int>(xw[1]), static_cast<int>(w0.y), a);
      a = __dp4a(static_cast<int>(xw[2]), static_cast<int>(w0.z), a);
      a = __dp4a(static_cast<int>(xw[3]), static_cast<int>(w0.w), a);
      a = __dp4a(static_cast<int>(xw[4]), static_cast<int>(w1.x), a);
      a = __dp4a(static_cast<int>(xw[5]), static_cast<int>(w1.y), a);
      a = __dp4a(static_cast<int>(xw[6]), static_cast<int>(w1.z), a);
      acc[o] = __dp4a(static_cast<int>(xw[7]), static_cast<int>(w1.w), a);
    }
    store16(p, acc, pix, oc0);
  }
}

// ---------------- the requant table ----------------

__global__ void __launch_bounds__(256) int8_conv_table_kernel(uint8_t* table, int act, float sout) {
  const int bits = blockIdx.x * 256 + threadIdx.x;  // every bf16 value
  const int e = (bits >> 7) & 0xff;
  const uint32_t q = requant(activate(__ushort_as_bfloat16(static_cast<unsigned short>(bits)), act), sout);
  table[kTabFullOff + bits] = static_cast<uint8_t>(q);
  // slots 0 and 25 hold many exponents: the first of each writes the entry, the rest must equal it
  const int first = e <= kTabBase ? 0 : e >= kTabBase + kTabSlots - 2 && e < 255 ? kTabBase + kTabSlots - 2 : e;
  if (e == first) {
    table[table_index(__ushort_as_bfloat16(static_cast<unsigned short>(bits)))] = static_cast<uint8_t>(q);
  } else {
    const int rep = (bits & 0x807f) | (first << 7);
    if (requant(activate(__ushort_as_bfloat16(static_cast<unsigned short>(rep)), act), sout) != q)
      atomicOr(reinterpret_cast<int*>(table + kTabBytes), 1);  // the table is invalid
  }
}

// ---------------- the plan and the launches ----------------

enum RouteCode { kRouteGemm = 0, kRouteDepthwise = 1, kRouteDirect = 2, kRoute1x1 = 3 };

struct Plan {
  int route, bn, wg, granule;
  int a_sets, groups, blocks, whole;  // gemm1x1's A sets, N groups, blocks an SM, and whether the table is whole
  int minb;                           // gemm1x1's instance: 2 for int8_conv_1x1<128, 2>, else 1
};

constexpr Plan kNoPlan{-1, 0, 0, 0, 0, 0, 0, 0, 1};

bool aligned(const void* ptr, int n) { return reinterpret_cast<uintptr_t>(ptr) % n == 0; }

constexpr int kMaxSmem = 232448;  // what a block can have on Hopper

int n_tile(int cout) {
  // Cout itself up to 128, else the widest that divides it (Cout 256 and 512 run as 2 and 4 N tiles of 128:
  // measured faster on route 1 than one N tile of 256, whose 128 accumulators a thread allow one block an SM)
  static const int kBN[] = {128, 80, 64, 32, 16, 8};  // instantiated N tiles, widest first
  for (int n : kBN)
    if (n == cout || (cout > n && cout % n == 0)) return n;
  return 8;
}

int device_sms() {  // the current device's SM count, asked once per device
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!sms[dev] && cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) sms[dev] = 0;
  return sms[dev];
}

// blocks of int8_conv_1x1<BN, MINB> an SM holds at this dynamic shared memory (the limit raised first), asked once
// per (device, size); 0 where the query fails
template <int BN, int MINB>
int blocks_1x1_t(int smem) {
  static int raised[64] = {0}, sizes[64][16] = {{0}}, blocks[64][16] = {{0}};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!raised[dev]) {
    if (cudaFuncSetAttribute(int8_conv_1x1<BN, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) !=
        cudaSuccess)
      return 0;
    raised[dev] = 1;
  }
  for (int i = 0; i < 16 && sizes[dev][i]; ++i)
    if (sizes[dev][i] == smem) return blocks[dev][i];
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, int8_conv_1x1<BN, MINB>, k1Threads, smem) != cudaSuccess)
    return 0;
  for (int i = 0; i < 16; ++i)
    if (!sizes[dev][i]) {
      sizes[dev][i] = smem;
      blocks[dev][i] = n;
      break;
    }
  return n;
}

int blocks_1x1(int bn, int minb, int smem) {
  switch (bn) {
    case 128: return minb == 2 ? blocks_1x1_t<128, 2>(smem) : blocks_1x1_t<128, 1>(smem);
    case 80: return blocks_1x1_t<80, 1>(smem);
    case 64: return blocks_1x1_t<64, 1>(smem);
    case 32: return blocks_1x1_t<32, 1>(smem);
    case 16: return blocks_1x1_t<16, 1>(smem);
    default: return blocks_1x1_t<8, 1>(smem);
  }
}

// Whether gemm1x1 (its plan q) takes a conv it can run, from how q's items (an M tile of 128 pixels and a group
// of N tiles) fill the card's block slots (SMs x q.blocks) and in how many rounds; by chip_smoke.py's per-conv
// tables of yolo11n's and yolo11m's 1x1 convs on both routes at batch 32 and batch 1 (NVIDIA H100 80GB HBM3, 700 W):
// - a float x: always (its quantize leaves the loads' path: 0.41-0.62x the time of the route before);
// - an int8 x in whole 32-byte chunks of Cin (a K tail inside a chunk: 0.82-1.07x), either two blocks an SM (an
//   N tile of at most 80, or of 128 on the two-block instance) over three rounds or more (one block's epilogue
//   overlaps the other's loads: 0.80-0.96x; N tiles of 128, 0.85-1.00x),
//   or one block an SM, one N tile an item and at most two rounds (the N groups spread few M tiles over idle SMs
//   and each block reads its A once: 0.63-0.96x).
// Elsewhere the route before it (more and smaller blocks: M tiles of 64 where they are few) keeps the conv: two
// blocks an SM in one or two rounds (0.86-1.22x on gemm1x1, slower on 18 of 30 convs, 3% faster or more on 5, 1%
// slower summed), one block an SM walking two N tiles or more an item (0.98-1.21x), or one N tile an item over three
// rounds or more (1.00-1.16x). Blocks an SM other than 1 or 2 were not measured: those convs keep it too. PR 21's
// tables (tools/k8_routes.py --pick gemm1x1) kept the rule: it puts 13 of the 170 1x1 convs of both models at both
// batches on the slower route, by 0.0001-0.0043 ms (0.0122 ms summed), and no quantity of the plan separates them
// (one block walking two N tiles: gemm1x1 1.5-3% faster at 2 and 13 rounds, 10-18% slower at 4).
bool prefer_1x1(const Conv& p, const Plan& q) {
  if (p.xtype != kInt8) return true;
  const long long m_tiles = ((long long)p.b * p.ho * p.wo + k1BM - 1) / k1BM, items = m_tiles * q.groups;
  const long long slots = (long long)device_sms() * q.blocks, rounds = (items + slots - 1) / slots;
  const int per_item = p.cout / q.bn / q.groups;  // N tiles an item walks
  return p.cin % 32 == 0 &&
         ((q.blocks == 2 && rounds >= 3) || (q.blocks == 1 && per_item == 1 && rounds <= 2));
}

// gemm1x1's plan for a conv it can run (kernel 1x1, stride 1, no padding, groups 1, Cin a multiple of 16, Cout of
// 8, 16-byte aligned, a pixel pitch of whole 16 bytes, shared memory that fits), else kNoPlan
Plan plan_1x1(const Conv& p, bool a16) {
  if (!(p.groups == 1 && p.kh == 1 && p.kw == 1 && p.stride == 1 && p.pad == 0 && p.cin % 16 == 0 &&
        p.cout % 8 == 0 && a16 && (long long)p.pitch * xbytes(p.xtype) % 16 == 0))
    return kNoPlan;
  // two sets of A slots let an int8 x's next item load during this one's N tiles (a float x's A slots are written
  // by the consumers); the N tiles split into groups (powers of two) while the M tiles alone would not give every
  // block of the card one item
  const int bn = n_tile(p.cout), k_steps = (p.cin + k1Step - 1) / k1Step, xes = xbytes(p.xtype);
  const int oes = p.sout > 0.0f ? 1 : 2;
  const long long m_tiles = ((long long)p.b * p.ho * p.wo + k1BM - 1) / k1BM, n_tiles = p.cout / bn;
  // instance minb's plan: the most blocks an SM (a block's epilogue, which bounds these convs, overlaps another's
  // loads and wgmmas), then the whole table (it spares some 12 instructions an int8 output), then two sets of A
  // slots; and the rounds of its items over the card's block slots
  long long rounds = 0;
  auto best = [&](int minb) {
    Plan q = kNoPlan;
    for (int whole = oes == 1 ? 1 : 0; whole >= 0; --whole)
      for (int sets = p.xtype == kInt8 ? 2 : 1; sets >= 1; --sets) {
        const int bytes = smem_1x1(bn, xes, oes, k_steps, sets, p.cout, whole).total;
        const int blocks = bytes <= kMaxSmem ? blocks_1x1(bn, minb, bytes) : 0;
        if (blocks > q.blocks) q = {kRoute1x1, bn, 2, 16, sets, 1, blocks, whole, minb};
      }
    if (q.blocks > 0) {
      const long long slots = (long long)device_sms() * q.blocks;
      while (2 * q.groups <= n_tiles && n_tiles % (2 * q.groups) == 0 && m_tiles * q.groups < slots) q.groups *= 2;
      rounds = (m_tiles * q.groups + slots - 1) / slots;
    }
    return q;
  };
  // An N tile of 128 (64 accumulators a thread) holds one block an SM in registers. The instance built for two
  // takes an int8 x in whole 64-byte K steps where two of its blocks fit an SM and its items span three rounds or
  // more of the card's slots: 0.86-0.95x the time of one block an SM there, 0.85-1.00x route 1's (yolo11m's
  // 160x160 and 80x80 convs at batch 32; tools/k8_routes.py --pick gemm1x1, NVIDIA H100 80GB HBM3, 700 W). Fewer
  // rounds, a 32-byte K step or a float x keep one block (an N tile of 128 with Cin 96 at 80x80: 1.06x route 1's).
  if (bn == 128 && p.xtype == kInt8 && p.cin % k1Step == 0) {
    const Plan q = best(2);
    if (q.blocks == 2 && rounds >= 3) return q;
  }
  return best(1);
}

// which route plan() may take: its own choice, or the one named (route 1 or gemm1x1; none where it cannot run):
// int8_conv_pick, for timing the routes side by side
enum Pick { kPickPlan = 0, kPickGemm = 1, kPick1x1 = 2 };

// the route of a conv
Plan plan(const Conv& p, int pick = kPickPlan) {
  const int xes = xbytes(p.xtype);
  const bool a16 = aligned(p.x, 16) && aligned(p.w, 16) && aligned(p.out, 16);
  if (pick == kPickPlan || pick == kPick1x1) {
    const Plan q = plan_1x1(p, a16);
    if (q.route == kRoute1x1 && (pick == kPick1x1 || prefer_1x1(p, q))) return q;
    if (pick == kPick1x1) return kNoPlan;
  }
  const int granule = p.cin % 16 == 0 ? 16 : 8;
  if (p.groups == 1 && p.cin % 8 == 0 && p.cout % 8 == 0 && a16 &&
      (long long)p.pitch * xes % (p.xtype == kInt8 ? granule : 16) == 0) {
    const int bn = n_tile(p.cout);
    const long long m = (long long)p.b * p.ho * p.wo;
    const long long tiles128 = (m + 127) / 128 * (p.cout / bn);
    return {kRouteGemm, bn, tiles128 >= 2 * 132 ? 2 : 1, granule, 0, 0, 0, 0, 1};
  }
  if (pick == kPickGemm) return kNoPlan;
  if (p.groups == p.cin && p.cin == p.cout && p.cin % 16 == 0 && p.kh == 3 && p.kw == 3 && a16 &&
      (long long)p.pitch * xes % 16 == 0)
    return {kRouteDepthwise, 0, 0, 0, 0, 0, 0, 0, 1};
  return {kRouteDirect, 0, 0, 0, 0, 0, 0, 0, 1};
}

int gemm_smem(int bn, int wg, int cout) {
  switch (bn) {
    case 128: return wg == 2 ? GemmTile<128, 2>::smem(cout) : GemmTile<128, 1>::smem(cout);
    case 80: return wg == 2 ? GemmTile<80, 2>::smem(cout) : GemmTile<80, 1>::smem(cout);
    case 64: return wg == 2 ? GemmTile<64, 2>::smem(cout) : GemmTile<64, 1>::smem(cout);
    case 32: return wg == 2 ? GemmTile<32, 2>::smem(cout) : GemmTile<32, 1>::smem(cout);
    case 16: return wg == 2 ? GemmTile<16, 2>::smem(cout) : GemmTile<16, 1>::smem(cout);
    default: return wg == 2 ? GemmTile<8, 2>::smem(cout) : GemmTile<8, 1>::smem(cout);
  }
}

int stem_smem(const Conv& p) {  // the stem kernel's packed weights and input tile
  return p.cout * 32 + ((kStemTH - 1) * p.stride + p.kh) * ((kStemTW - 1) * p.stride + p.kw) * p.cin;
}

bool stem(const Conv& p) { return p.groups == 1 && p.kh * p.kw * p.cin <= 32 && stem_smem(p) <= 48 * 1024; }

int direct_smem(const Conv& p) { return stem(p) ? stem_smem(p) : kOC * p.kh * p.kw * (p.cin / p.groups); }

// the dynamic shared memory of a plan's launch
int plan_smem(const Conv& p, const Plan& pl) {
  const int xes = xbytes(p.xtype), oes = p.sout > 0.0f ? 1 : 2;
  switch (pl.route) {
    case kRoute1x1:
      return smem_1x1(pl.bn, xes, oes, (p.cin + k1Step - 1) / k1Step, pl.a_sets, p.cout, pl.whole).total;
    case kRouteGemm: return gemm_smem(pl.bn, pl.wg, p.cout);
    case kRouteDirect: return direct_smem(p);
    default: return 0;
  }
}

template <int BN, int WG>
cudaError_t launch_gemm(const Conv& p, int granule, cudaStream_t stream) {
  using T = GemmTile<BN, WG>;
  static int sms = 0;  // raise the shared-memory limit and read the SM count once per instantiation
  if (!sms) {
    cudaError_t err =
        cudaFuncSetAttribute(int8_conv_gemm<BN, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    if (err != cudaSuccess) return err;
  }
  const int smem = T::smem(p.cout);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // blocks an SM holds at this shared memory (it varies with Cout only): asked once per size
  static int cached_smem[8] = {0}, cached_blocks[8] = {0};
  int per_sm = 0;
  for (int i = 0; i < 8 && cached_smem[i]; ++i)
    if (cached_smem[i] == smem) per_sm = cached_blocks[i];
  if (!per_sm) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int8_conv_gemm<BN, WG>, T::kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    for (int i = 0; i < 8; ++i)
      if (!cached_smem[i]) {
        cached_smem[i] = smem;
        cached_blocks[i] = per_sm;
        break;
      }
  }
  const long long m = (long long)p.b * p.ho * p.wo;
  const long long tiles = (m + T::kBM - 1) / T::kBM * (p.cout / BN);
  const unsigned grid = static_cast<unsigned>(tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms);
  int8_conv_gemm<BN, WG><<<grid, T::kThreads, smem, stream>>>(p, granule);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from libcuda, through the runtime's entry-point query (so the library needs no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a (rows, cols) matrix of `es`-byte elements at ptr, rows `pitch` elements apart, as a 2-D tensor map with boxes
// of (box_rows, box_cols); out of bounds reads as zero
bool tensor_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int es, long long rows, long long cols,
                long long pitch, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch * es)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

CUtensorMapDataType x_type(int xtype) {
  return xtype == kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                        : xtype == kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

template <int BN, int MINB>
cudaError_t launch_1x1(const Conv& p, const Plan& pl, cudaStream_t stream) {
  const long long m = (long long)p.b * p.ho * p.wo;
  const int xes = xbytes(p.xtype);
  CUtensorMap map_a, map_b;
  const bool ok =
      (p.xtype == kInt8 ? tensor_map(&map_a, p.x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, m, p.cin, p.pitch, k1BM, kChunk,
                                     CU_TENSOR_MAP_SWIZZLE_32B)
                        : tensor_map(&map_a, p.x, x_type(p.xtype), xes, m, p.cin, p.pitch, k1BM, k1Step,
                                     CU_TENSOR_MAP_SWIZZLE_NONE)) &&
      tensor_map(&map_b, p.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.cout, p.cin, p.cin, BN, kChunk,
                 CU_TENSOR_MAP_SWIZZLE_32B);
  if (!ok) return cudaErrorInvalidValue;
  const long long items = (m + k1BM - 1) / k1BM * pl.groups, slots = (long long)device_sms() * pl.blocks;
  const unsigned grid = static_cast<unsigned>(items < slots ? items : slots);
  int8_conv_1x1<BN, MINB>
      <<<grid, k1Threads, plan_smem(p, pl), stream>>>(map_a, map_b, p, pl.a_sets, pl.groups, pl.whole);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_gemm_bn(const Conv& p, const Plan& pl, cudaStream_t stream) {
  return pl.wg == 2 ? launch_gemm<BN, 2>(p, pl.granule, stream) : launch_gemm<BN, 1>(p, pl.granule, stream);
}

template <template <int> class L>
cudaError_t launch_bn(const Conv& p, const Plan& pl, cudaStream_t stream) {
  switch (pl.bn) {
    case 128: return L<128>::run(p, pl, stream);
    case 80: return L<80>::run(p, pl, stream);
    case 64: return L<64>::run(p, pl, stream);
    case 32: return L<32>::run(p, pl, stream);
    case 16: return L<16>::run(p, pl, stream);
    default: return L<8>::run(p, pl, stream);
  }
}

template <int BN>
struct Launch1x1 {
  static cudaError_t run(const Conv& p, const Plan& pl, cudaStream_t s) { return launch_1x1<BN, 1>(p, pl, s); }
};

template <int BN>
struct LaunchGemm {
  static cudaError_t run(const Conv& p, const Plan& pl, cudaStream_t s) { return launch_gemm_bn<BN>(p, pl, s); }
};

cudaError_t launch(const Conv& p, const Plan& pl, cudaStream_t stream) {
  const long long npix = (long long)p.b * p.ho * p.wo;
  if (pl.route == kRoute1x1 && pl.minb == 2)
    return pl.bn == 128 ? launch_1x1<128, 2>(p, pl, stream) : cudaErrorInvalidValue;
  if (pl.route == kRoute1x1) return launch_bn<Launch1x1>(p, pl, stream);
  if (pl.route == kRouteGemm) return launch_bn<LaunchGemm>(p, pl, stream);
  if (pl.route == kRouteDepthwise) {
    const unsigned blocks = static_cast<unsigned>((npix * (p.cin / 16) + kDwThreads - 1) / kDwThreads);
    int8_conv_depthwise<<<blocks, kDwThreads, 0, stream>>>(p);
    return cudaGetLastError();
  }
  if (pl.route != kRouteDirect) return cudaErrorInvalidValue;
  const int smem = direct_smem(p);
  if (stem(p)) {
    const dim3 grid((p.wo + kStemTW - 1) / kStemTW, (p.ho + kStemTH - 1) / kStemTH, p.b);
    int8_conv_stem<<<grid, kStemTW * kStemTH, smem, stream>>>(p);
    return cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(int8_conv_direct, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>((npix + kDirectThreads - 1) / kDirectThreads), (p.cout + kOC - 1) / kOC);
  int8_conv_direct<<<grid, kDirectThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool valid(const Conv& p) {
  return p.b >= 0 && p.h > 0 && p.w_in > 0 && p.cin > 0 && p.ho > 0 && p.wo > 0 && p.cout > 0 && p.kh > 0 &&
         p.kw > 0 && p.stride > 0 && p.pad >= 0 && p.groups > 0 && p.cin % p.groups == 0 &&
         p.cout % p.groups == 0 && p.act >= 0 && p.act <= 2 && p.xtype >= kInt8 && p.xtype <= kFp32 &&
         (p.xtype == kInt8 || p.sin >= 0.0f) && (long long)p.b * p.ho * p.wo < 0x7fffffffLL &&
         p.pitch >= p.cin && (long long)p.b * p.h * p.w_in * p.pitch < 0x7fffffffLL &&
         p.kh * p.kw * (p.cin / p.groups) < 65536 &&  // the loader's division by Cin is exact below 2^16
         (p.cout + kOC - 1) / kOC <= 65535 && p.b <= 65535;
}

Conv make_conv(const void* x, const void* w, const void* scale, const void* bias, void* out, int b, int h, int w_in,
               int cin, int pitch, int ho, int wo, int cout, int kh, int kw, int stride, int pad, int groups, int act,
               int xtype, float sout, float sin, const void* table) {
  return Conv{x,    static_cast<const int8_t*>(w), static_cast<const float*>(scale), static_cast<const float*>(bias),
              out,  b, h, w_in, cin, ho, wo, cout, kh, kw, stride, pad, groups, act, xtype, sout, sin,
              static_cast<const uint8_t*>(table), 1.0f / sin, pitch};  // sin 0 (an all-zero calibration): inf
}

int run(const Conv& p, int device, void* stream, int pick) {
  if (!valid(p) || pick < kPickPlan || pick > kPick1x1) return static_cast<int>(cudaErrorInvalidValue);
  // nvcc links this library with its own CUDA runtime, whose current device is not PyTorch's
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan pl = plan(p, pick);
  if (pl.route < 0) return static_cast<int>(cudaErrorInvalidValue);  // the route picked cannot take this conv
  if (p.b == 0) return 0;
  err = launch(p, pl, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // namespace

extern "C" int int8_conv(const void* x, const void* w, const void* scale, const void* bias, void* out, int b, int h,
                         int w_in, int cin, int pitch, int ho, int wo, int cout, int kh, int kw, int stride, int pad,
                         int groups, int act, int xtype, float sout, float sin, const void* table, int device,
                         void* stream) {
  return run(make_conv(x, w, scale, bias, out, b, h, w_in, cin, pitch, ho, wo, cout, kh, kw, stride, pad, groups, act,
                       xtype, sout, sin, table),
             device, stream, kPickPlan);
}

// int8_conv on a route the caller picks (1: route 1, 2: gemm1x1; an error where it cannot run),
// for timing the routes side by side (chip_smoke.py); the same outputs
extern "C" int int8_conv_pick(const void* x, const void* w, const void* scale, const void* bias, void* out, int b,
                              int h, int w_in, int cin, int pitch, int ho, int wo, int cout, int kh, int kw, int stride,
                              int pad, int groups, int act, int xtype, float sout, float sin, const void* table,
                              int device, void* stream, int pick) {
  return run(make_conv(x, w, scale, bias, out, b, h, w_in, cin, pitch, ho, wo, cout, kh, kw, stride, pad, groups, act,
                       xtype, sout, sin, table),
             device, stream, pick);
}

// Fills `table` (int8_conv_table_bytes(), zeroed by the caller) with the activation + requant table at
// (act, sout), compressed and whole: one thread per bf16 value.
extern "C" int int8_conv_table(void* table, int act, float sout, int device, void* stream) {
  if (act < 0 || act > 2 || !(sout > 0.0f)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_conv_table_kernel<<<256, 256, 0, s>>>(static_cast<uint8_t*>(table), act, sout);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int int8_conv_table_bytes() { return kTabFullOff + kTabFullBytes; }

// The route a call with these arguments takes, on the given device (pick as int8_conv_pick's, 0: int8_conv's own),
// written to plan_out[0..9]: route (0 gemm, 1 depthwise, 2 direct, 3 gemm1x1, -1 none: the route picked cannot
// run), N tile, consumer warpgroups, route 1's copy granule, the launch's dynamic shared memory in bytes, gemm1x1's
// sets of A slots, groups of N tiles and blocks an SM, the whole table (1) or the compressed one (0), and the M tile
// (64 a consumer warpgroup).
extern "C" int int8_conv_plan(const void* x, const void* w, void* out, int b, int h, int w_in, int cin, int pitch,
                              int ho, int wo, int cout, int kh, int kw, int stride, int pad, int groups, int xtype,
                              float sout, int pick, int device, int* plan_out) {
  const Conv p = make_conv(x, w, nullptr, nullptr, out, b, h, w_in, cin, pitch, ho, wo, cout, kh, kw, stride, pad,
                           groups, 0, xtype, sout, 1.0f, nullptr);
  if (!valid(p) || pick < kPickPlan || pick > kPick1x1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan pl = plan(p, pick);
  const int vals[10] = {pl.route,  pl.bn,     pl.wg,     pl.granule, pl.route < 0 ? 0 : plan_smem(p, pl),
                        pl.a_sets, pl.groups, pl.blocks, pl.whole,   64 * pl.wg};
  for (int i = 0; i < 10; ++i) plan_out[i] = vals[i];
  return 0;
}

extern "C" const char* int8_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
