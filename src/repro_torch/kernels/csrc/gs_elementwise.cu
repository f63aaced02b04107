// Elementwise Goldschmidt reciprocal and coupled rsqrt / sqrt, for sm_90a.
//
// Replaces two pallas_calls:
//
//   gs_recip   src/repro/kernels/gs_recip.py::_kernel (the call in _run):
//              1/x per element.  Biased exponent 0 (zero or subnormal)
//              gives +-inf, +-inf gives +-0, NaN propagates; a result below
//              2^-126 is produced, not flushed (the TPU flushes it).
//   gs_rsqrt   src/repro/kernels/gs_rsqrt.py::_kernel (the call in _run):
//              the coupled iteration of g -> sqrt(m), 2h -> 1/sqrt(m) over
//              m in [1, 4) (an odd exponent folds into m).  mode 0 writes
//              rsqrt, mode 1 sqrt, mode 2 ("sqrt_both") sqrt and its rsqrt
//              co-output in one launch, for gs_sqrt's backward.  x < 0 or
//              NaN gives NaN; zero or subnormal gives inf / 0; inf gives
//              0 / inf.
//
// Operands are f32 or bf16 (read, computed in f32, stored in the input's
// dtype), any shape, flattened by the wrapper; the TPU kernels' padding to
// (block_rows, 128) tiles is gone: the loop stops at n.
//
// Bound on this card: device memory.  Each element reads 4 (or 2) bytes and
// writes 4 (or 2) per output for ~10 flops of datapath per pass, far below
// the ~20 flops per byte where the fp32 units would bind.
//
// Design: one grid-stride pass of 256-thread blocks, at most a few waves
// over the 132 SMs; the 2^p-entry f32 ROM is staged in shared memory and
// read by index (the TPU's one-hot matmul).  Every multiply and add of the
// peel and the iterations is __fmul_rn / __fadd_rn (gs_common.cuh), so each
// kernel agrees bit for bit with its plain PyTorch version (kernels/ref.py
// reciprocal, rsqrt).  The specials are selected after the datapath, as the
// reference's jnp.where chain selects them.
#include <cstdint>

#include "gs_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // a few waves over the card's 132 SMs
constexpr int kSignBit = static_cast<int>(0x80000000u);
constexpr int kInfBits = 0x7F800000;
constexpr int kNanBits = 0x7FC00000;  // the canonical NaN torch and jnp write

template <typename T>
__global__ void __launch_bounds__(kThreads)
gs_recip_kernel(const T* __restrict__ x, const float* __restrict__ rom_g,
                T* __restrict__ out, int64_t n, int p, int iters, int pipelined) {
  extern __shared__ float s_rom[];
  gs::stage_rom(s_rom, rom_g, p);
  const gs::Rom rom{s_rom, p, iters, pipelined, 0.0f};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < n;
       i += stride) {
    const float xv = gs::to_f32(x[i]);
    const int sign = __float_as_int(xv) & kSignBit;
    const int e = gs::biased_exp(xv);
    const int mant = gs::mantissa_bits(xv);
    const float q = gs::gs_recip_core(gs::mantissa_to_m(mant), mant, rom);
    // 1/x = q * 2^-E: the biased exponent of 2^-E is 254 - e
    float o = __int_as_float(__float_as_int(__fmul_rn(q, gs::pow2_from_biased(254 - e))) | sign);
    if (e == 0) o = __int_as_float(sign | kInfBits);
    if (e == 255) o = __int_as_float(mant == 0 ? sign : kNanBits);
    out[i] = gs::from_f32<T>(o);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gs_rsqrt_kernel(const T* __restrict__ x, const float* __restrict__ rom_g,
                T* __restrict__ out0, T* __restrict__ out1, int64_t n, int p, int iters,
                int pipelined, float rsqrt_scale, int mode) {
  extern __shared__ float s_rom[];
  gs::stage_rom(s_rom, rom_g, p);
  const gs::Rom rom{s_rom, p, iters, pipelined, rsqrt_scale};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < n;
       i += stride) {
    const float xv = gs::to_f32(x[i]);
    const int e = gs::biased_exp(xv);
    const int mant = gs::mantissa_bits(xv);
    float m = gs::mantissa_to_m(mant);
    const int E = e - 127;
    const bool odd = (E & 1) != 0;
    if (odd) m = __fmul_rn(m, 2.0f);
    const int half_e = (odd ? E - 1 : E) >> 1;  // arithmetic: floor(E / 2)
    float g, h;
    gs::gs_rsqrt_core(m, rom, g, h);
    float rs = __fmul_rn(__fmul_rn(2.0f, h), gs::pow2_from_biased(127 - half_e));
    float sq = __fmul_rn(g, gs::pow2_from_biased(127 + half_e));
    if (e == 0) {
      rs = __int_as_float(kInfBits);
      sq = 0.0f;
    }
    if (e == 255 && mant == 0) {
      rs = 0.0f;
      sq = __int_as_float(kInfBits);
    }
    if ((e == 255 && mant != 0) || xv < 0.0f) rs = sq = __int_as_float(kNanBits);
    if (mode == 0) {
      out0[i] = gs::from_f32<T>(rs);
    } else {
      out0[i] = gs::from_f32<T>(sq);
      if (mode == 2) out1[i] = gs::from_f32<T>(rs);
    }
  }
}

int grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// x, out: n contiguous f32 or bf16 (is_bf16); rom: (2^p,) f32 reciprocal
// table.  Returns cudaGetLastError().
extern "C" int gs_recip_launch(const void* x, const void* rom, void* out, long long n,
                               int p, int iters, int pipelined, int is_bf16,
                               void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = (1u << p) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    gs_recip_kernel<__nv_bfloat16><<<grid_for(n), kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(rom),
        static_cast<__nv_bfloat16*>(out), n, p, iters, pipelined);
  } else {
    gs_recip_kernel<float><<<grid_for(n), kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(rom),
        static_cast<float*>(out), n, p, iters, pipelined);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, out0, out1: n contiguous f32 or bf16; rom: (2^p,) f32 rsqrt table;
// rsqrt_scale = f32(2^p / 3); mode 0 rsqrt -> out0, 1 sqrt -> out0, 2 sqrt
// -> out0 and rsqrt -> out1 (out1 is unused otherwise).  Returns
// cudaGetLastError().
extern "C" int gs_rsqrt_launch(const void* x, const void* rom, void* out0, void* out1,
                               long long n, int p, int iters, int pipelined,
                               float rsqrt_scale, int mode, int is_bf16, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = (1u << p) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    gs_rsqrt_kernel<__nv_bfloat16><<<grid_for(n), kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(rom),
        static_cast<__nv_bfloat16*>(out0), static_cast<__nv_bfloat16*>(out1), n, p, iters,
        pipelined, rsqrt_scale, mode);
  } else {
    gs_rsqrt_kernel<float><<<grid_for(n), kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(rom),
        static_cast<float*>(out0), static_cast<float*>(out1), n, p, iters, pipelined,
        rsqrt_scale, mode);
  }
  return static_cast<int>(cudaGetLastError());
}
