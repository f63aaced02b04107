// Causal GQA flash-attention forward with a Goldschmidt epilogue, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel (the forward
// pallas_call in _fwd_call): online-softmax attention over
// q (B, H, S, D), k/v (B, KH, S, D), GQA via kv_head = h / (H / KH), output
// acc * GS(1 / max(l, 1e-30)); when asked (the differentiated forward), also
// the (B, H, S) f32 row statistics m (running max of sm_scale * q k^T, masked
// logits at -1e30) and l (the unguarded sum of exp(s - m)), the residuals
// of the backward kernels in flash_attention_bwd.cu.
//
// Bound on this card: at prefill (S ~ 100-500, H 32, D 64) the work is
// 4*H*S^2*D/2 causal flops against (q + k + v + o) bytes, ~S/4 flops per
// f32 byte: past the fp32 units' ~20 flops per byte from S ~ 80 up, so the
// operations bind, not the bytes.  This first kernel runs its products on
// the fp32 FMA pipes (no tensor cores), so its own ceiling is the card's
// fp32 rate; wgmma, TMA and a pipelined K/V ring are later work.
//
// Design: where the TPU grid walks the kv axis in sequence with acc/m/l in
// VMEM scratch, here one block owns a (b, h, 64-row q block) tile and loops
// over the kv blocks itself; acc, m and l live in registers.  Two threads
// share a query row, each holding half of the D feature dims (interleaved,
// so the pair reads neighbouring shared-memory banks); their partial dot
// products meet through one shuffle.  D is a template parameter (16, 32,
// 64: the smoke and the full-width tinyllama configs).  K and V tiles (64 keys) are staged
// in shared memory as f32.  Causal: kv blocks wholly above the diagonal are
// never loaded; inside the diagonal block, and past the end of a ragged S,
// logits are masked to -1e30 (no divisor shrink of the block size).
// Scores are taken 16 keys at a time into registers, then one rescale of
// the accumulator per 16 keys.
#include <cstdint>

#include "gs_common.cuh"

namespace {

constexpr int kBlockQ = 64;        // query rows per block
constexpr int kBlockKV = 64;       // keys per staged tile
constexpr int kSub = 16;           // keys per register chunk
constexpr int kThreads = 2 * kBlockQ;

// kD: the head dim (16, 32 or 64); each thread holds kD / 2 of them.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ rom_g,
                 T* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int H, int KH, int S, float sm_scale,
                 int causal, int p, int iters, int pipelined) {
  constexpr int kHalf = kD / 2;
  extern __shared__ float smem[];
  float* s_k = smem;                   // [kBlockKV][kD]
  float* s_v = s_k + kBlockKV * kD;    // [kBlockKV][kD]
  float* s_rom = s_v + kBlockKV * kD;  // 2^p ROM entries
  gs::stage_rom(s_rom, rom_g, p);

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tid = threadIdx.x, half = tid & 1;
  const int row = qb * kBlockQ + (tid >> 1);
  const bool valid_row = row < S;
  const T* qp = q + ((int64_t)b * H + h) * S * kD;
  const T* kp = k + ((int64_t)b * KH + kvh) * S * kD;
  const T* vp = v + ((int64_t)b * KH + kvh) * S * kD;

  float qr[kHalf], acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    qr[i] = valid_row ? gs::to_f32(qp[(int64_t)row * kD + 2 * i + half]) : 0.0f;
    acc[i] = 0.0f;
  }
  float m = gs::kNegInf, l = 0.0f;

  const int kv_end = causal ? min(S, (qb + 1) * kBlockQ) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockKV) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBlockKV * kD; idx += kThreads) {
      const int col = kv0 + idx / kD;
      const int64_t off = (int64_t)col * kD + idx % kD;
      s_k[idx] = col < S ? gs::to_f32(kp[off]) : 0.0f;
      s_v[idx] = col < S ? gs::to_f32(vp[off]) : 0.0f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kBlockKV; j0 += kSub) {
      float s[kSub];
      float m_cur = gs::kNegInf;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float* kr = s_k + (j0 + jj) * kD + half;
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < kHalf; ++i) dot = fmaf(qr[i], kr[2 * i], dot);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        const int col = kv0 + j0 + jj;
        const bool masked = col >= S || (causal && col > row);
        s[jj] = masked ? gs::kNegInf : dot * sm_scale;
        m_cur = fmaxf(m_cur, s[jj]);
      }
      const float m_new = fmaxf(m, m_cur);
      const float alpha = expf(m - m_new);
      float l_cur = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        l_cur += s[jj];
      }
      l = l * alpha + l_cur;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) acc[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float* vr = s_v + (j0 + jj) * kD + half;
#pragma unroll
        for (int i = 0; i < kHalf; ++i) acc[i] = fmaf(s[jj], vr[2 * i], acc[i]);
      }
      m = m_new;
    }
  }

  const gs::Rom rom{s_rom, p, iters, pipelined, 0.0f};
  const float inv = gs::recip_positive(fmaxf(l, 1e-30f), rom);
  if (valid_row) {
    T* op = out + ((int64_t)b * H + h) * S * kD + (int64_t)row * kD;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) op[2 * i + half] = gs::from_f32<T>(acc[i] * inv);
    // both threads of a pair hold the same m and l; one writes them
    if (m_out != nullptr && half == 0) {
      const int64_t r = ((int64_t)b * H + h) * S + row;
      m_out[r] = m;
      l_out[r] = l;
    }
  }
}

template <typename T, int kD>
void launch(const void* q, const void* k, const void* v, const void* rom, void* out,
            void* m_out, void* l_out, int B, int H, int KH, int S, float sm_scale,
            int causal, int p, int iters, int pipelined, cudaStream_t stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  const size_t smem = (2 * kBlockKV * kD + (1u << p)) * sizeof(float);
  flash_fwd_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(rom), static_cast<T*>(out), static_cast<float*>(m_out),
      static_cast<float*>(l_out), H, KH, S, sm_scale, causal, p, iters, pipelined);
}

template <typename T>
int launch_for_dim(int D, const void* q, const void* k, const void* v, const void* rom,
                   void* out, void* m_out, void* l_out, int B, int H, int KH, int S,
                   float sm_scale, int causal, int p, int iters, int pipelined,
                   cudaStream_t stream) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, rom, out, m_out, l_out, B, H, KH, S, sm_scale, causal, p, iters, pipelined, stream); break;
    case 32: launch<T, 32>(q, k, v, rom, out, m_out, l_out, B, H, KH, S, sm_scale, causal, p, iters, pipelined, stream); break;
    case 64: launch<T, 64>(q, k, v, rom, out, m_out, l_out, B, H, KH, S, sm_scale, causal, p, iters, pipelined, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, H, S, D); k, v: (B, KH, S, D), all contiguous, f32 or bf16
// (is_bf16), D in {16, 32, 64}; rom: (2^p,) f32 reciprocal table; m_out,
// l_out: (B, H, S) f32, both null or both set.
// Returns cudaGetLastError() (cudaErrorInvalidValue for another D).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* rom, void* out, void* m_out, void* l_out,
                                   int B, int H, int KH, int S, int D, float sm_scale,
                                   int causal, int p, int iters, int pipelined,
                                   int is_bf16, void* stream) {
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_for_dim<__nv_bfloat16>(D, q, k, v, rom, out, m_out, l_out, B, H, KH,
                                         S, sm_scale, causal, p, iters, pipelined, s);
  return launch_for_dim<float>(D, q, k, v, rom, out, m_out, l_out, B, H, KH, S, sm_scale,
                               causal, p, iters, pipelined, s);
}
