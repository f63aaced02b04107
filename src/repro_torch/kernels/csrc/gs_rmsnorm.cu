// Fused RMSNorm with a Goldschmidt rsqrt, for sm_90a.
//
// Replaces: src/repro/kernels/gs_rmsnorm.py::_kernel (the pallas_call in
// _run): y = x * rsqrt(mean(x^2) + eps) * gain per row, fp32 statistics,
// the mean over the real width d, optionally the (rows, 1) rsqrt column.
//
// Bound on this card: device memory.  The kernel moves rows*d*(in + out
// bytes) + 4d bytes and does ~4 flops per element, far below the ~20 flops
// per byte where the H100's fp32 units would bind.  At decode rows =
// n_slots (4 at d = 2048), so each launch moves ~64 KB and is bound by the
// launch itself, not by bytes.
//
// Design: one block of 256 threads per row, no padding to 128 lanes (the
// loop masks the ragged edge).  The sum of squares is fp32, reduced with
// warp shuffles and one shared-memory pass across warps; then ms * (1/d),
// one Goldschmidt rsqrt_positive(ms + eps) per row from the shared-memory
// ROM, and a second sweep writes x * inv * gain in the input dtype (the
// row's second read comes from L1/L2).
#include <cstdint>

#include "gs_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gs_rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ gain,
                  const float* __restrict__ rom_g, T* __restrict__ out,
                  float* __restrict__ inv_out, int d, float inv_d, float eps,
                  int p, int iters, int pipelined, float rsqrt_scale) {
  extern __shared__ float smem[];
  float* s_rom = smem;             // 2^p ROM entries
  float* s_part = smem + (1 << p); // one partial sum per warp
  gs::stage_rom(s_rom, rom_g, p);

  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = gs::to_f32(xr[i]);
    acc = fmaf(v, v, acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? s_part[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) s_part[0] = acc;
  }
  __syncthreads();

  const gs::Rom rom{s_rom, p, iters, pipelined, rsqrt_scale};
  const float ms = __fmul_rn(s_part[0], inv_d);
  const float inv = gs::rsqrt_positive(__fadd_rn(ms, eps), rom);
  if (inv_out != nullptr && threadIdx.x == 0) inv_out[row] = inv;

  T* orow = out + row * d;
  for (int i = threadIdx.x; i < d; i += kThreads)
    orow[i] = gs::from_f32<T>(__fmul_rn(__fmul_rn(gs::to_f32(xr[i]), inv), gain[i]));
}

}  // namespace

// x, out: (rows, d) f32 or bf16 (is_bf16); gain: (d,) f32; rom: (2^p,) f32
// rsqrt table; inv_out: (rows,) f32 or null.  Returns cudaGetLastError().
extern "C" int gs_rmsnorm_launch(const void* x, const void* gain, const void* rom,
                                 void* out, void* inv_out, int rows, int d,
                                 float inv_d, float eps, int p, int iters,
                                 int pipelined, float rsqrt_scale, int is_bf16,
                                 void* stream) {
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = ((1u << p) + kThreads / 32) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    gs_rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gain),
        static_cast<const float*>(rom), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(inv_out), d, inv_d, eps, p, iters, pipelined, rsqrt_scale);
  } else {
    gs_rmsnorm_kernel<float><<<rows, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gain),
        static_cast<const float*>(rom), static_cast<float*>(out),
        static_cast<float*>(inv_out), d, inv_d, eps, p, iters, pipelined, rsqrt_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
