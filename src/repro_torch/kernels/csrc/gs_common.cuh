// Goldschmidt device helpers shared by the hand-written Hopper kernels.
//
// Twin of src/repro_torch/kernels/common.py (and of the TPU helpers in
// src/repro/kernels/common.py): the IEEE-754 field peel, the ROM read, the
// reciprocal and coupled rsqrt iterations, and their epilogue forms.
//
// * ROM read: on the TPU a one-hot x table matmul; here an indexed load
//   from the block's shared-memory copy of the 2^p-entry f32 table
//   (stage_rom), which the host builds from core/lut.py, or, in the
//   elementwise and rmsnorm kernels, from the table itself through the
//   read-only cache.
//   p is a runtime argument (5..12).
// * feedback variant: one (q, r) register pair in a runtime loop
//   (#pragma unroll 1 over the trip count).  pipelined: a full unroll up to
//   kMaxPipelinedIters passes, one pair per pass in the program text.
// * Every multiply and add of the peel and the iterations is __fmul_rn /
//   __fadd_rn / __fsub_rn, which nvcc never contracts into an FMA, so the
//   results match the plain PyTorch version bit for bit.  Build without
//   --use_fast_math: it would flush subnormals and contract.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gs {

constexpr int kExpMask = 0xFF;
constexpr int kMantMask = 0x007FFFFF;
constexpr int kOneBits = 0x3F800000;
constexpr int kMaxPipelinedIters = 4;
constexpr float kNegInf = -1e30f;  // the kernels' finite mask value

// The ROM and the datapath settings of one launch.
struct Rom {
  const float* table;  // 2^p entries: a shared-memory copy, or the table itself
  int p;
  int iters;
  int pipelined;
  float rsqrt_scale;  // f32(2^p / 3): the rsqrt ROM's bucket index scale
};

// Copies the 2^p-entry table into shared memory; ends with a barrier.
__device__ __forceinline__ void stage_rom(float* dst, const float* src, int p) {
  for (int i = threadIdx.x; i < (1 << p); i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

__device__ __forceinline__ int biased_exp(float x) {
  return (__float_as_int(x) >> 23) & kExpMask;
}

__device__ __forceinline__ int mantissa_bits(float x) {
  return __float_as_int(x) & kMantMask;
}

__device__ __forceinline__ float mantissa_to_m(int mant) {
  return __int_as_float(kOneBits | mant);
}

// 2^(e - 127) for e clamped to [0, 254]; e == 0 gives +0.
__device__ __forceinline__ float pow2_from_biased(int e) {
  return __int_as_float(min(max(e, 0), 254) << 23);
}

__device__ __forceinline__ void recip_step(float& q, float& r) {
  const float k = __fsub_rn(2.0f, r);  // 2's complement block
  q = __fmul_rn(q, k);                 // MULT X
  r = __fmul_rn(r, k);                 // MULT Y
}

__device__ __forceinline__ void rsqrt_step(float& g, float& h) {
  const float r = __fsub_rn(0.5f, __fmul_rn(g, h));
  g = __fadd_rn(g, __fmul_rn(g, r));
  h = __fadd_rn(h, __fmul_rn(h, r));
}

// 1/m for m in [1, 2) given its mantissa bits.
__device__ __forceinline__ float gs_recip_core(float m, int mant, const Rom& rom) {
  const float k1 = rom.table[mant >> (23 - rom.p)];
  float q = k1;
  float r = __fmul_rn(m, k1);
  if (rom.pipelined) {
#pragma unroll
    for (int i = 0; i < kMaxPipelinedIters; ++i)
      if (i < rom.iters) recip_step(q, r);
  } else {
#pragma unroll 1
    for (int i = 0; i < rom.iters; ++i) recip_step(q, r);
  }
  return q;
}

// (g, h) with g -> sqrt(m) and 2h -> 1/sqrt(m), for m in [1, 4).
// kReadOnly: rom.table is the table in device memory, read through the
// read-only cache (__ldg), not a shared-memory copy.
template <bool kReadOnly = false>
__device__ __forceinline__ void gs_rsqrt_core(float m, const Rom& rom, float& g,
                                              float& h) {
  int idx = static_cast<int>(floorf(__fmul_rn(__fsub_rn(m, 1.0f), rom.rsqrt_scale)));
  idx = min(max(idx, 0), (1 << rom.p) - 1);
  const float y0 = kReadOnly ? __ldg(rom.table + idx) : rom.table[idx];
  g = __fmul_rn(m, y0);
  h = __fmul_rn(0.5f, y0);
  if (rom.pipelined) {
#pragma unroll
    for (int i = 0; i < kMaxPipelinedIters; ++i)
      if (i < rom.iters) rsqrt_step(g, h);
  } else {
#pragma unroll 1
    for (int i = 0; i < rom.iters; ++i) rsqrt_step(g, h);
  }
}

// 1/x for strictly positive normal f32 x.
__device__ __forceinline__ float recip_positive(float x, const Rom& rom) {
  const int mant = mantissa_bits(x);
  const float q = gs_recip_core(mantissa_to_m(mant), mant, rom);
  return __fmul_rn(q, pow2_from_biased(254 - biased_exp(x)));
}

// 1/sqrt(x) for strictly positive normal f32 x: an odd exponent folds into
// m in [1, 4).  kReadOnly as for gs_rsqrt_core.
template <bool kReadOnly = false>
__device__ __forceinline__ float rsqrt_positive(float x, const Rom& rom) {
  float m = mantissa_to_m(mantissa_bits(x));
  const int e = biased_exp(x) - 127;
  const bool odd = (e & 1) != 0;
  if (odd) m = __fmul_rn(m, 2.0f);
  const int half_e = (odd ? e - 1 : e) >> 1;
  float g, h;
  gs_rsqrt_core<kReadOnly>(m, rom, g, h);
  return __fmul_rn(__fmul_rn(2.0f, h), pow2_from_biased(127 - half_e));
}

// sqrt(x) for strictly positive normal f32 x: the g-sequence of the same
// iteration (rsqrt_positive(..., mode="sqrt") of the reference).
__device__ __forceinline__ float sqrt_positive(float x, const Rom& rom) {
  float m = mantissa_to_m(mantissa_bits(x));
  const int e = biased_exp(x) - 127;
  const bool odd = (e & 1) != 0;
  if (odd) m = __fmul_rn(m, 2.0f);
  const int half_e = (odd ? e - 1 : e) >> 1;
  float g, h;
  gs_rsqrt_core(m, rom, g, h);
  return __fmul_rn(g, pow2_from_biased(127 + half_e));
}

// Block-wide reduction of one value per thread over a block of kThreads
// threads; every thread gets the result.  `part` holds kThreads / 32 values.
// The warps combine in a fixed order, so a launch's result does not depend on
// scheduling.
template <int kThreads, typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, T* part, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // part may still be read from a previous reduction
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = part[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) v = op(v, part[w]);
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace gs
