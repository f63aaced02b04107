// Fixed-point Goldschmidt device helpers for the int8 kernels (gs_fixed.cu).
//
// Twins of the plain datapath in src/repro_torch/core/fixed_point_torch.py
// (FixedPointTorch and its IEEE-754 boundary), which the tests hold
// register for register against the reference's FixedPointJax and numpy
// emulation:
//
//   msb32          <-> msb32                 leading-one detect (0 for 0)
//   mult           <-> FixedPointTorch.mult  w x w -> w truncating multiply
//   mitchell_mult  <-> .mitchell_mult        Mitchell log-multiplier
//   complement     <-> .complement           K = 2 - r
//   divide         <-> .divide               both variants, ROM-seeded k1
//   rsqrt_reg      <-> .rsqrt_reg            coupled g/h iteration, y0 seed
//   mantissa_with_one <-> _peel's mantissa   the f32 mantissa 1.f
//   mant_to_reg    <-> _mant_to_reg          f32 mantissa into a register
//   reg_to_f32     <-> _reg_to_f32           register value as f32
//
// Registers are uint32_t with F = frac_bits fraction bits (F <= 30), so
// every value below 4.0 fits.  The multiplier is the low 32 bits of
// floor(a*b / 2^F) from one 64-bit product: the value the reference's
// 16-bit-limb construction gives.  Every shift amount stays in [0, 31]
// (C++ leaves wider shifts undefined where XLA defines them as 0):
// shl32() returns 0 for amounts >= 32, and the Mitchell right shift is
// clamped to 31 as in the reference.  The ROM is an indexed load of the
// integer words, left-aligned to F by the host, from shared memory.
#pragma once

#include <cstdint>

#include "gs_common.cuh"

namespace gsf {

// One launch's datapath settings; `words` is the block's shared-memory copy
// of the 2^p ROM words.
struct Datapath {
  const uint32_t* words;
  int F;
  int p;
  int iters;
  int pipelined;
  int mitchell_iters;
};

// Copies the 2^p ROM words into shared memory; ends with a barrier.
__device__ __forceinline__ void stage_words(uint32_t* dst, const uint32_t* src, int p) {
  for (int i = threadIdx.x; i < (1 << p); i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

__device__ __forceinline__ uint32_t msb32(uint32_t x) {
  return x == 0u ? 0u : 31u - static_cast<uint32_t>(__clz(x));
}

__device__ __forceinline__ uint32_t shl32(uint32_t x, uint32_t s) {
  return s >= 32u ? 0u : (x << s);
}

__device__ __forceinline__ uint32_t mult(uint32_t a, uint32_t b, int F) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> F);
}

__device__ __forceinline__ uint32_t mitchell_mult(uint32_t a, uint32_t b, int F) {
  const uint32_t f = static_cast<uint32_t>(F);
  const uint32_t ea = msb32(a), eb = msb32(b);
  const uint32_t fa = a - (1u << ea), fb = b - (1u << eb);
  const uint32_t fa_s = ea <= f ? shl32(fa, f - ea) : fa >> (ea - f);
  const uint32_t fb_s = eb <= f ? shl32(fb, f - eb) : fb >> (eb - f);
  const uint32_t s = fa_s + fb_s;
  const uint32_t e2 = ea + eb + (s >> f);
  const uint32_t base = (1u << f) + (s & ((1u << f) - 1u));
  const uint32_t two_f = 2u * f;
  const uint32_t res = e2 >= two_f ? shl32(base, e2 - two_f)
                                   : base >> min(two_f - e2, 31u);
  return (a == 0u || b == 0u) ? 0u : res;
}

__device__ __forceinline__ uint32_t complement(uint32_t r, int F) {
  return (2u << F) - r;
}

// One Goldschmidt pass: K = 2 - r; q *= K; r *= K unless it is the last.
__device__ __forceinline__ void divide_pass(uint32_t& q, uint32_t& r, int i,
                                            const Datapath& dp) {
  const uint32_t k = complement(r, dp.F);
  const bool mitchell = i < dp.mitchell_iters;
  q = mitchell ? mitchell_mult(q, k, dp.F) : mult(q, k, dp.F);
  if (i != dp.iters - 1) r = mitchell ? mitchell_mult(r, k, dp.F) : mult(r, k, dp.F);
}

// q = n / d on registers from the ROM word k1: MULT 1 and 2, then `iters`
// passes; the first `mitchell_iters` passes multiply with Mitchell's block.
// feedback: one pass body in a runtime loop; pipelined: a full unroll.
__device__ __forceinline__ uint32_t divide(uint32_t n, uint32_t d, uint32_t k1,
                                           const Datapath& dp) {
  uint32_t q = mult(n, k1, dp.F);
  uint32_t r = mult(d, k1, dp.F);
  if (dp.pipelined) {
#pragma unroll
    for (int i = 0; i < gs::kMaxPipelinedIters; ++i)
      if (i < dp.iters) divide_pass(q, r, i, dp);
  } else {
#pragma unroll 1
    for (int i = 0; i < dp.iters; ++i) divide_pass(q, r, i, dp);
  }
  return q;
}

// 2h -> 1/sqrt(m) for the register m in [1, 4), from the rsqrt ROM word y0.
// The residual 0.5 - g*h is kept as magnitude and direction.
__device__ __forceinline__ uint32_t rsqrt_reg(uint32_t m, uint32_t y0, int F, int iters) {
  uint32_t g = mult(m, y0, F);
  uint32_t h = y0 >> 1;
  const uint32_t half = 1u << (F - 1);
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    const uint32_t gh = mult(g, h, F);
    const bool pos = gh <= half;
    const uint32_t rmag = pos ? half - gh : gh - half;
    const uint32_t gd = mult(g, rmag, F), hd = mult(h, rmag, F);
    g = pos ? g + gd : g - gd;
    h = pos ? h + hd : h - hd;
  }
  return h << 1;
}

// The 24-bit mantissa 1.f of an f32 as a register with F fraction bits:
// exact for F >= 23, truncating below.
__device__ __forceinline__ uint32_t mant_to_reg(uint32_t mant, int F) {
  return F >= 23 ? mant << (F - 23) : mant >> (23 - F);
}

__device__ __forceinline__ uint32_t mantissa_with_one(float x) {
  return (static_cast<uint32_t>(__float_as_int(x)) & 0x7FFFFFu) | 0x800000u;
}

__device__ __forceinline__ float reg_to_f32(uint32_t reg, int F) {
  return __fmul_rn(__uint2float_rn(reg), __int_as_float((127 - F) << 23));
}

}  // namespace gsf
