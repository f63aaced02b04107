// Fixed-point Goldschmidt reciprocal over int8 operands, for sm_90a.
//
// Replaces one of the three pallas_calls of src/repro/kernels/gs_fixed.py
// (gs_fixed_softmax is gs_fixed_softmax.cu, gs_fixed_rmsnorm is
// gs_fixed_rmsnorm.cu):
//
//   gs_fixed_recip    (_recip_kernel)    1/(x*scale) elementwise; |x| in
//                     [1, 127] normalized by msb32, the fixed divide with
//                     n = 1, sign restored, x == 0 -> +inf
//
// Operands are int8 with a per-tensor f32 scale, read from a one-element
// device operand so the host never waits for it; outputs are f32.  Every
// division runs the narrow integer datapath of gs_fixed_common.cuh; the
// float arithmetic around it is __fmul_rn in the reference's order, so recip
// agrees with its plain version bit for bit.
//
// Bound on this card: device memory, and at the (256, 128) benchmark shape
// the launch.  The datapath is a few dozen integer ops per element.
//
// Design: a grid-stride elementwise pass.  The ROM words (2^p uint32,
// left-aligned to frac_bits by the host) are staged in shared memory.
#include <cstdint>

#include "gs_fixed_common.cuh"

namespace {

constexpr int kThreads = 256;
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
