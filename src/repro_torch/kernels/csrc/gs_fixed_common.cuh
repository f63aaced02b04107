// Fixed-point Goldschmidt device helpers for the int8 kernels (gs_fixed.cu,
// gs_fixed_softmax.cu, gs_fixed_rmsnorm.cu).
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
// integer words, left-aligned to F by the host, through the read-only
// cache: one word a code in gs_fixed.cu, one word a row in
// gs_fixed_softmax.cu and gs_fixed_rmsnorm.cu.
#pragma once

#include <cstdint>

#include "gs_common.cuh"

namespace gsf {

// One launch's datapath settings; `words` holds left-aligned ROM words in
// device memory: all 2^p in gs_fixed_softmax.cu, the int8-reachable
// subsample (every 2^(p - 6)th word) in gs_fixed.cu.
struct Datapath {
  const uint32_t* words;
  int F;
  int p;
  int iters;
  int pipelined;
  int mitchell_iters;
};

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

// q = n / d on registers from the ROM word k1, for N independent chains
// side by side: MULT 1 and 2, then `iters` passes, each advancing every
// chain; the first `mitchell_iters` passes multiply with Mitchell's block.
// feedback: one pass body in a runtime loop; pipelined: a full unroll.
template <int N>
__device__ __forceinline__ void divide(const uint32_t (&n)[N], const uint32_t (&d)[N],
                                       const uint32_t (&k1)[N], const Datapath& dp,
                                       uint32_t (&q)[N]) {
  uint32_t r[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    q[j] = mult(n[j], k1[j], dp.F);
    r[j] = mult(d[j], k1[j], dp.F);
  }
  if (dp.pipelined) {
#pragma unroll
    for (int i = 0; i < gs::kMaxPipelinedIters; ++i)
      if (i < dp.iters) {
#pragma unroll
        for (int j = 0; j < N; ++j) divide_pass(q[j], r[j], i, dp);
      }
  } else {
#pragma unroll 1
    for (int i = 0; i < dp.iters; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) divide_pass(q[j], r[j], i, dp);
    }
  }
}

// One chain of divide<N>.
__device__ __forceinline__ uint32_t divide(uint32_t n, uint32_t d, uint32_t k1,
                                           const Datapath& dp) {
  const uint32_t nn[1] = {n}, dd[1] = {d}, kk[1] = {k1};
  uint32_t q[1];
  divide<1>(nn, dd, kk, dp, q);
  return q[0];
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
