// Row softmax with a Goldschmidt reciprocal of the row sum, for sm_90a.
//
// Replaces: src/repro/kernels/gs_softmax.py::_kernel (the pallas_call in
// _run): per row of the last axis, in f32, m = max(x), e = exp(x - m),
// s = sum(e) (>= 1: the max element gives exp(0)), then e * GS(1/s) in the
// input's dtype.  The TPU kernel pads the columns to a lane multiple with
// -inf; here the loops stop at the real width.
//
// Bound on this card: device memory.  A row is read twice (the second read
// mostly from L2) and written once, with ~4 flops and one expf per element
// per pass.  At the benchmark's (16, 384) a launch moves ~49 KB, so the
// launch itself binds; at the sampler width (8, 32000) one block per row
// keeps 8 of the 132 SMs busy and the row's length binds.  Splitting a long
// row across blocks is left to a later change.
//
// Design: one 256-thread block per row, rows of any width (a loop over the
// row; nothing is staged whole in shared memory).  The max and the sum are
// reduced with warp shuffles and one shared-memory pass across warps
// (gs::block_reduce); every thread then runs recip_positive on the same sum
// from the shared-memory ROM, so no broadcast is needed.  The exp is expf
// (not __expf) and the adds are __fadd_rn in the block's order, so the
// kernel is held to its plain version within a stated tolerance, not bit
// for bit.
#include <cstdint>

#include "gs_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gs_softmax_kernel(const T* __restrict__ x, const float* __restrict__ rom_g,
                  T* __restrict__ out, int d, int p, int iters, int pipelined) {
  extern __shared__ float s_rom[];
  __shared__ float s_part[kThreads / 32];
  gs::stage_rom(s_rom, rom_g, p);
  const gs::Rom rom{s_rom, p, iters, pipelined, 0.0f};
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  float m = -__int_as_float(0x7F800000);
  for (int i = threadIdx.x; i < d; i += kThreads) m = fmaxf(m, gs::to_f32(xr[i]));
  m = gs::block_reduce<kThreads>(m, s_part, [](float a, float b) { return fmaxf(a, b); });
  float acc = 0.0f;
  for (int i = threadIdx.x; i < d; i += kThreads)
    acc = __fadd_rn(acc, expf(__fsub_rn(gs::to_f32(xr[i]), m)));
  acc = gs::block_reduce<kThreads>(acc, s_part,
                                   [](float a, float b) { return __fadd_rn(a, b); });
  const float inv = gs::recip_positive(acc, rom);
  T* orow = out + row * d;
  for (int i = threadIdx.x; i < d; i += kThreads)
    orow[i] = gs::from_f32<T>(__fmul_rn(expf(__fsub_rn(gs::to_f32(xr[i]), m)), inv));
}

}  // namespace

// x, out: (rows, d) contiguous f32 or bf16 (is_bf16); rom: (2^p,) f32
// reciprocal table.  Returns cudaGetLastError().
extern "C" int gs_softmax_launch(const void* x, const void* rom, void* out, int rows, int d,
                                 int p, int iters, int pipelined, int is_bf16,
                                 void* stream) {
  if (rows == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = (1u << p) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    gs_softmax_kernel<__nv_bfloat16><<<rows, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(rom),
        static_cast<__nv_bfloat16*>(out), d, p, iters, pipelined);
  } else {
    gs_softmax_kernel<float><<<rows, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(rom),
        static_cast<float*>(out), d, p, iters, pipelined);
  }
  return static_cast<int>(cudaGetLastError());
}
