// The DFL arithmetic shared by K3 (csrc/select_decode.cu, the candidates' decode) and K5/K6a (csrc/dfl.cu): one
// side's softmax over its R bins with torch's CUDA rounding and summation order, so that every kernel built on it
// equals the plain versions (ops/loss_kernels.py `_dfl_mm_parts`, `_dfl_ce_parts`) bit for bit on the card.
#pragma once

constexpr int kMaxReg = 64;  // reg_max the generic forms take (RM = 0)

// torch's CUDA sum over a contiguous row of r floats: block_width = the largest power of two <= r (at most 32)
// threads, thread t summing t, t + bw, ... in four accumulators, then a shuffle-down tree over the threads with
// the offset halving from bw / 2 (at r = 16: ((x0 + x8) + (x4 + x12)) + ((x2 + x10) + (x6 + x14)) + ...; at r = 4:
// (x0 + x2) + (x1 + x3)); with it the boxes equal the plain version's bit for bit (chip_smoke.py phase 2,
// tests/test_torch_kernels.py)
__device__ __forceinline__ float row_sum(const float* v, int r) {
  int bw = 1;
  while (bw * 2 <= r && bw < 32) bw *= 2;
  float part[32];
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    if (t >= bw) break;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int idx = t;
    while (idx + 3 * bw < r) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], v[idx + i * bw]);
      idx += 4 * bw;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (idx + i * bw < r) acc[i] = __fadd_rn(acc[i], v[idx + i * bw]);
    part[t] = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o >= bw) continue;
#pragma unroll
    for (int t = 0; t < o; ++t) part[t] = __fadd_rn(part[t], part[t + o]);
  }
  return part[0];
}

// one side's max over its R logits v, NaN propagating (torch's amax). RM is reg_max when it is known at compile
// time (16, every model the repo builds: the loops unrolled, in registers), else 0 (R read at run time, <= kMaxReg)
template <int RM>
__device__ __forceinline__ float dfl_side_max(const float* v, int R) {
  constexpr int kCap = RM ? RM : kMaxReg;
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < kCap; ++j) {
    if (j >= R) break;
    if (j == 0 || (!isnan(m) && (isnan(v[j]) || v[j] > m))) m = v[j];
  }
  return m;
}

// e_j = expf(v_j - m) into e, and returns z = sum(e) in torch's order
template <int RM>
__device__ __forceinline__ float dfl_side_exp_sum(const float* v, float* e, int R, float m) {
  constexpr int kCap = RM ? RM : kMaxReg;
#pragma unroll
  for (int j = 0; j < kCap; ++j)
    if (j < R) e[j] = expf(__fsub_rn(v[j], m));
  return row_sum(e, R);
}

// the expectation sum(e_j * j) / z; w is scratch for the products
template <int RM>
__device__ __forceinline__ float dfl_side_expectation(const float* e, float* w, int R, float z) {
  constexpr int kCap = RM ? RM : kMaxReg;
#pragma unroll
  for (int j = 0; j < kCap; ++j)
    if (j < R) w[j] = __fmul_rn(e[j], (float)j);
  return __fdiv_rn(row_sum(w, R), z);
}

// ---- R = 16 on two lanes a side (lane bit 0 the half, each lane holding 8 consecutive bins): K5's and K6a's
// layout in csrc/dfl.cu, and K3's decode in csrc/select_decode.cu ----

// NaN-propagating max (torch's amax: any NaN makes the max NaN; which NaN does not matter, every use of m is
// arithmetic and gives the canonical NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// one side's softmax at R = 16 across its two lanes (lane bit 0 = the half): the lane's bins v, the side's max m,
// the lane's e_j = expf(v_j - m), the other lane's (o), and z in torch's order, the same bits on both lanes
struct Side16 {
  float e[8], o[8];
  float m, z;

  __device__ __forceinline__ void of(const float (&v)[8]) {
    m = v[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) m = max_nan(m, v[j]);
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, 1));
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = expf(__fsub_rn(v[j], m));
    float p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j] = __shfl_xor_sync(0xffffffffu, e[j], 1);
      p[j] = __fadd_rn(e[j], o[j]);  // bins j and j + 8
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = __fadd_rn(p[j], p[j + 4]);
#pragma unroll
    for (int j = 0; j < 2; ++j) p[j] = __fadd_rn(p[j], p[j + 2]);
    z = __fadd_rn(p[0], p[1]);
  }
};

// R = 16 (K5, and K3's decode): the side's expectation sum(e_j * j) / z across its two lanes, the numerator in
// torch's order (the tree of `Side16::of` over the products e_j * j, each lane forming the other half's products
// from its e), the same bits on both lanes
__device__ __forceinline__ float expectation16(const Side16& s, int half) {
  float p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)  // bins j and j + 8
    p[j] = __fadd_rn(__fmul_rn(s.e[j], (float)(half * 8 + j)), __fmul_rn(s.o[j], (float)((1 - half) * 8 + j)));
#pragma unroll
  for (int j = 0; j < 4; ++j) p[j] = __fadd_rn(p[j], p[j + 4]);
#pragma unroll
  for (int j = 0; j < 2; ++j) p[j] = __fadd_rn(p[j], p[j + 2]);
  return __fdiv_rn(__fadd_rn(p[0], p[1]), s.z);
}
