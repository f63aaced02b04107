// Fixed-point Goldschmidt epilogues over int8 operands, for sm_90a.
//
// Replaces two of the three pallas_calls of src/repro/kernels/gs_fixed.py
// (the third, gs_fixed_rmsnorm, is gs_fixed_rmsnorm.cu):
//
//   gs_fixed_recip    (_recip_kernel)    1/(x*scale) elementwise; |x| in
//                     [1, 127] normalized by msb32, the fixed divide with
//                     n = 1, sign restored, x == 0 -> +inf
//   gs_fixed_softmax  (_softmax_kernel)  softmax(x*scale) per row; f32 max,
//                     exp and sum, the sum's mantissa peeled into a
//                     register, its fixed reciprocal scales the row
//
// Operands are int8 with a per-tensor f32 scale, read from a one-element
// device operand so the host never waits for it; outputs are f32.  Every
// division site runs the narrow integer datapath of gs_fixed_common.cuh;
// the float arithmetic around it is __fmul_rn / __fadd_rn in the
// reference's order, so recip agrees with its plain version bit for bit.
// The softmax's expf and sum order differ from torch's, so it is held to a
// bound.
//
// Bound on this card: device memory, and at the (256, 128) benchmark shape
// the launch.  The datapath is a few dozen integer ops per row (softmax) or
// per element (recip).
//
// Design: softmax runs one 256-thread block per row, the ragged edge masked
// in the loops (no padding to 128 lanes); one thread runs the datapath and
// broadcasts the result through shared memory.  recip is a grid-stride
// elementwise pass.  The ROM words (2^p uint32, left-aligned to frac_bits
// by the host) are staged in shared memory.
#include <cstdint>

#include "gs_fixed_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads)
gs_fixed_recip_kernel(const int8_t* __restrict__ x, const float* __restrict__ inv_scale,
                      const uint32_t* __restrict__ words_g, float* __restrict__ out,
                      int64_t n, int F, int p, int iters, int pipelined,
                      int mitchell_iters) {
  extern __shared__ uint32_t s_words[];
  gsf::stage_words(s_words, words_g, p);
  const gsf::Datapath dp{s_words, F, p, iters, pipelined, mitchell_iters};
  const float s = *inv_scale;
  const uint32_t one = 1u << F;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int xi = x[i];
    const uint32_t a = static_cast<uint32_t>(max(abs(xi), 1));
    const uint32_t e = gsf::msb32(a);  // 0..6
    const uint32_t m_reg = a << (F - e);  // m in [1, 2)
    const uint32_t idx = min((m_reg - one) >> (F - p), (1u << p) - 1u);
    const uint32_t q = gsf::divide(one, m_reg, s_words[idx], dp);
    const float mag = __fmul_rn(
        __fmul_rn(gsf::reg_to_f32(q, F), gs::pow2_from_biased(127 - static_cast<int>(e))), s);
    out[i] = xi == 0 ? __int_as_float(0x7F800000) : (xi < 0 ? -mag : mag);
  }
}

__global__ void __launch_bounds__(kThreads)
gs_fixed_softmax_kernel(const int8_t* __restrict__ x, const float* __restrict__ scale,
                        const uint32_t* __restrict__ words_g, float* __restrict__ out,
                        int d, int F, int p, int iters, int pipelined, int mitchell_iters) {
  extern __shared__ uint32_t s_words[];
  __shared__ float s_part[kWarps];
  __shared__ float s_inv;
  gsf::stage_words(s_words, words_g, p);
  const gsf::Datapath dp{s_words, F, p, iters, pipelined, mitchell_iters};
  const float sc = *scale;
  const int64_t row = blockIdx.x;
  const int8_t* xr = x + row * d;
  float m = -__int_as_float(0x7F800000);
  for (int i = threadIdx.x; i < d; i += kThreads)
    m = fmaxf(m, __fmul_rn(static_cast<float>(xr[i]), sc));
  m = gs::block_reduce<kThreads>(m, s_part, [](float a, float b) { return fmaxf(a, b); });
  float acc = 0.0f;
  for (int i = threadIdx.x; i < d; i += kThreads)
    acc = __fadd_rn(acc, expf(__fsub_rn(__fmul_rn(static_cast<float>(xr[i]), sc), m)));
  acc = gs::block_reduce<kThreads>(acc, s_part, [](float a, float b) { return __fadd_rn(a, b); });
  if (threadIdx.x == 0) {  // the row sum is in [1, d]: a positive normal
    const uint32_t mant = gsf::mantissa_with_one(acc);
    const uint32_t idx = min((mant & 0x7FFFFFu) >> (23 - p), (1u << p) - 1u);
    const uint32_t q = gsf::divide(1u << F, gsf::mant_to_reg(mant, F), s_words[idx], dp);
    s_inv = __fmul_rn(gsf::reg_to_f32(q, F), gs::pow2_from_biased(254 - gs::biased_exp(acc)));
  }
  __syncthreads();
  const float inv = s_inv;
  float* orow = out + row * d;
  for (int i = threadIdx.x; i < d; i += kThreads)
    orow[i] = __fmul_rn(expf(__fsub_rn(__fmul_rn(static_cast<float>(xr[i]), sc), m)), inv);
}

int grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// x: (n,) int8; inv_scale: (1,) f32 = 1/scale; words: (2^p,) uint32 reciprocal
// ROM words left-aligned to F; out: (n,) f32.  Returns cudaGetLastError().
extern "C" int gs_fixed_recip_launch(const void* x, const void* inv_scale, const void* words,
                                     void* out, long long n, int F, int p, int iters,
                                     int pipelined, int mitchell_iters, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  gs_fixed_recip_kernel<<<grid_for(n), kThreads, (1u << p) * sizeof(uint32_t),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(inv_scale),
      static_cast<const uint32_t*>(words), static_cast<float*>(out), n, F, p, iters,
      pipelined, mitchell_iters);
  return static_cast<int>(cudaGetLastError());
}

// x, out: (rows, d) int8 -> f32; scale: (1,) f32; words: the reciprocal ROM.
extern "C" int gs_fixed_softmax_launch(const void* x, const void* scale, const void* words,
                                       void* out, int rows, int d, int F, int p, int iters,
                                       int pipelined, int mitchell_iters, void* stream) {
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  gs_fixed_softmax_kernel<<<rows, kThreads, (1u << p) * sizeof(uint32_t),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(scale),
      static_cast<const uint32_t*>(words), static_cast<float*>(out), d, F, p, iters,
      pipelined, mitchell_iters);
  return static_cast<int>(cudaGetLastError());
}
