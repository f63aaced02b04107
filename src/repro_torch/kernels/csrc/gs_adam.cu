// Fused AdamW step with a Goldschmidt sqrt and reciprocal, for sm_90a.
//
// Replaces: src/repro/kernels/gs_adam.py::_kernel (the pallas_call in
// gs_adam_update): per element, in the reference's order,
//
//   m' = b1*m + (1-b1)*g,  v' = b2*v + (1-b2)*g*g
//   s  = GS sqrt(max(v'*bc2, 1e-38)),  u = (m'*bc1) * GS(1/(s + eps))
//   p' = p - lr*(u + wd*p)
//
// with bc1 = 1/(1-b1^t), bc2 = 1/(1-b2^t) and lr read from a 3-float device
// operand (they change every step, so they are data, not constants).  This
// is the one division of every training step (the paper's division site #5)
// and runs on the multiply-only datapath: no sqrt or divide instruction.
//
// Bound on this card: device memory.  Each element moves 28 bytes (read p,
// g, m, v; write p, m, v) for ~30 flops, far below the ~20 flops per byte
// where the fp32 units would bind.
//
// Design: one elementwise grid-stride pass, 256 threads a block; both
// 2^p-entry ROMs (reciprocal and rsqrt) are staged in shared memory.  Every
// multiply and add is __fmul_rn / __fadd_rn / __fsub_rn, so the kernel
// agrees bit for bit with the plain PyTorch version (kernels/ref.py
// adam_update), which runs the same operations one tensor op at a time.
// The TPU kernel's padding to (rows, 128) tiles is gone: the loop stops at
// n.  The wrapper writes fresh p, m and v, as the reference returns new
// arrays.
#include <cstdint>

#include "gs_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // a few waves over the card's 132 SMs

struct Hyper {
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps, weight_decay;
};

__global__ void __launch_bounds__(kThreads)
gs_adam_kernel(const float* param, const float* grad, const float* m_in,
               const float* v_in, const float* __restrict__ bc,
               const float* __restrict__ rom_recip, const float* __restrict__ rom_rsqrt,
               float* p_out, float* m_out, float* v_out, int64_t n, Hyper hp, int p,
               int iters, int pipelined, float rsqrt_scale) {
  extern __shared__ float smem[];
  float* s_recip = smem;              // 2^p reciprocal ROM entries
  float* s_rsqrt = smem + (1 << p);   // 2^p rsqrt ROM entries
  for (int i = threadIdx.x; i < (1 << p); i += blockDim.x) {
    s_recip[i] = rom_recip[i];
    s_rsqrt[i] = rom_rsqrt[i];
  }
  __syncthreads();
  const gs::Rom recip{s_recip, p, iters, pipelined, 0.0f};
  const gs::Rom rsqrt{s_rsqrt, p, iters, pipelined, rsqrt_scale};
  const float bc1 = bc[0], bc2 = bc[1], lr = bc[2];

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float w = param[i], g = grad[i];
    const float m = __fadd_rn(__fmul_rn(hp.beta1, m_in[i]), __fmul_rn(hp.one_minus_beta1, g));
    const float v = __fadd_rn(__fmul_rn(hp.beta2, v_in[i]),
                              __fmul_rn(__fmul_rn(hp.one_minus_beta2, g), g));
    const float v_hat = fmaxf(__fmul_rn(v, bc2), 1e-38f);
    const float s = gs::sqrt_positive(v_hat, rsqrt);
    const float inv = gs::recip_positive(__fadd_rn(s, hp.eps), recip);
    const float update = __fmul_rn(__fmul_rn(m, bc1), inv);
    p_out[i] = __fsub_rn(w, __fmul_rn(lr, __fadd_rn(update, __fmul_rn(hp.weight_decay, w))));
    m_out[i] = m;
    v_out[i] = v;
  }
}

}  // namespace

// param, grad, m, v, p_out, m_out, v_out: n contiguous f32; bc: 3 f32 on the
// device (bc1, bc2, lr); rom_recip / rom_rsqrt: (2^p,) f32 tables;
// rsqrt_scale = f32(2^p / 3).  Returns cudaGetLastError().
extern "C" int gs_adam_launch(const void* param, const void* grad, const void* m,
                              const void* v, const void* bc, const void* rom_recip,
                              const void* rom_rsqrt, void* p_out, void* m_out,
                              void* v_out, long long n, float beta1,
                              float one_minus_beta1, float beta2,
                              float one_minus_beta2, float eps, float weight_decay,
                              int p, int iters, int pipelined, float rsqrt_scale,
                              void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const size_t smem = 2 * (1u << p) * sizeof(float);
  const Hyper hp{beta1, one_minus_beta1, beta2, one_minus_beta2, eps, weight_decay};
  gs_adam_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(param), static_cast<const float*>(grad),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<const float*>(bc), static_cast<const float*>(rom_recip),
      static_cast<const float*>(rom_rsqrt), static_cast<float*>(p_out),
      static_cast<float*>(m_out), static_cast<float*>(v_out), n, hp, p, iters, pipelined,
      rsqrt_scale);
  return static_cast<int>(cudaGetLastError());
}
