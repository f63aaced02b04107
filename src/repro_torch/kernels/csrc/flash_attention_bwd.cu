// Causal GQA flash-attention backward (dq; per-q-head dk, dv) with the
// Goldschmidt recompute of 1/l, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the two pallas_calls of _bwd_call), with _p_tile's
// recompute of the probabilities from the forward's saved row statistics:
//
//   p_ij  = exp(s_ij - m_i) * GS(1 / max(l_i, 1e-30)),  s = sm_scale * q k^T
//   ds_ij = p_ij * (do_i . v_j - delta_i) * sm_scale,  delta_i = do_i . out_i
//   dq_i  = sum_j ds_ij k_j         (flash_bwd_dq_kernel)
//   dv_j  = sum_i p_ij do_i,  dk_j = sum_i ds_ij q_i   (flash_bwd_dkv_kernel)
//
// 1/l is one Goldschmidt reciprocal (gs::recip_positive) per query row, the
// same datapath as the forward's epilogue, not exp(s - logsumexp).  delta,
// the GQA group-sum of the per-q-head dk/dv and the casts stay torch ops
// outside, as in the reference; the two kernels write disjoint outputs, so
// there are no atomics and the result does not depend on block order.
//
// Bound on this card: like the forward, the work is matmul-shaped (dq: three
// S^2*D products, dk/dv: four, halved for causal) against O(S*D) bytes, so
// the operations bind.  These first kernels run every product on the fp32
// FMA pipes (no tensor cores); wgmma, TMA and a pipelined ring are later
// work.
//
// Design: the TPU grid walks its inner axis in sequence with the
// accumulators in VMEM scratch; here each block owns its output tile and
// loops over the other axis itself, accumulators in registers.
// * dq: one block per (b, h, 64-row q tile); two threads per query row hold
//   interleaved halves of q, do and the dq accumulator; K and V tiles of 64
//   keys are staged in shared memory as f32; 1/l is computed once per row.
// * dk/dv: one block per (b, h, 64-key kv tile); two threads per key hold
//   halves of k, v and both accumulators; Q and dO tiles of 64 rows are
//   staged with their rows' m, GS(1/l) and delta.
// The pair's partial dot products meet through one shuffle.  Causal: tiles
// wholly above the diagonal are never visited; inside the diagonal tile
// p = 0 for col > row.  A ragged S is masked (the loops stop at S) instead
// of shrinking the block to a divisor of S.
#include <cstdint>

#include "gs_common.cuh"

namespace {

constexpr int kBlockQ = 64;   // query rows per q tile
constexpr int kBlockKV = 64;  // keys per kv tile (== kBlockQ: causal tile math)
constexpr int kThreads = 128; // two threads per row (dq) or per key (dk/dv)

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ m_in, const float* __restrict__ l_in,
                    const float* __restrict__ delta_in, const float* __restrict__ rom_g,
                    T* __restrict__ dq, int H, int KH, int S, float sm_scale,
                    int causal, int p, int iters, int pipelined) {
  constexpr int kHalf = kD / 2;
  extern __shared__ float smem[];
  float* s_k = smem;                   // [kBlockKV][kD]
  float* s_v = s_k + kBlockKV * kD;    // [kBlockKV][kD]
  float* s_rom = s_v + kBlockKV * kD;  // 2^p ROM entries
  gs::stage_rom(s_rom, rom_g, p);
  const gs::Rom rom{s_rom, p, iters, pipelined, 0.0f};

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tid = threadIdx.x, half = tid & 1;
  const int row = qb * kBlockQ + (tid >> 1);
  const bool valid_row = row < S;
  const int64_t bh = (int64_t)b * H + h;
  const T* qp = q + bh * S * kD;
  const T* dop = dout + bh * S * kD;
  const T* kp = k + ((int64_t)b * KH + kvh) * S * kD;
  const T* vp = v + ((int64_t)b * KH + kvh) * S * kD;

  float qr[kHalf], dor[kHalf], acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const int64_t off = (int64_t)row * kD + 2 * i + half;
    qr[i] = valid_row ? gs::to_f32(qp[off]) : 0.0f;
    dor[i] = valid_row ? gs::to_f32(dop[off]) : 0.0f;
    acc[i] = 0.0f;
  }
  float m = 0.0f, inv = 0.0f, delta = 0.0f;
  if (valid_row) {
    m = m_in[bh * S + row];
    inv = gs::recip_positive(fmaxf(l_in[bh * S + row], 1e-30f), rom);
    delta = delta_in[bh * S + row];
  }

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

    const int j_end = min(kBlockKV, kv_end - kv0);  // uniform across the block
    for (int j = 0; j < j_end; ++j) {
      const float* kr = s_k + j * kD + half;
      const float* vr = s_v + j * kD + half;
      float dot = 0.0f, dp = 0.0f;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        dot = fmaf(qr[i], kr[2 * i], dot);
        dp = fmaf(dor[i], vr[2 * i], dp);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const bool masked = causal && kv0 + j > row;
      const float pr = masked ? 0.0f : expf(dot * sm_scale - m) * inv;
      const float ds = pr * (dp - delta) * sm_scale;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) acc[i] = fmaf(ds, kr[2 * i], acc[i]);
    }
  }

  if (valid_row) {
    T* out = dq + bh * S * kD + (int64_t)row * kD;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) out[2 * i + half] = gs::from_f32<T>(acc[i]);
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ m_in, const float* __restrict__ l_in,
                     const float* __restrict__ delta_in, const float* __restrict__ rom_g,
                     float* __restrict__ dk, float* __restrict__ dv, int H, int KH, int S,
                     float sm_scale, int causal, int p, int iters, int pipelined) {
  constexpr int kHalf = kD / 2;
  extern __shared__ float smem[];
  float* s_q = smem;                    // [kBlockQ][kD]
  float* s_do = s_q + kBlockQ * kD;     // [kBlockQ][kD]
  float* s_m = s_do + kBlockQ * kD;     // [kBlockQ] row max
  float* s_inv = s_m + kBlockQ;         // [kBlockQ] GS(1 / max(l, 1e-30))
  float* s_delta = s_inv + kBlockQ;     // [kBlockQ]
  float* s_rom = s_delta + kBlockQ;     // 2^p ROM entries
  gs::stage_rom(s_rom, rom_g, p);
  const gs::Rom rom{s_rom, p, iters, pipelined, 0.0f};

  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tid = threadIdx.x, half = tid & 1;
  const int col = kb * kBlockKV + (tid >> 1);
  const bool valid_col = col < S;
  const int64_t bh = (int64_t)b * H + h;
  const T* qp = q + bh * S * kD;
  const T* dop = dout + bh * S * kD;
  const T* kp = k + ((int64_t)b * KH + kvh) * S * kD;
  const T* vp = v + ((int64_t)b * KH + kvh) * S * kD;

  float kr[kHalf], vr[kHalf], dk_acc[kHalf], dv_acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const int64_t off = (int64_t)col * kD + 2 * i + half;
    kr[i] = valid_col ? gs::to_f32(kp[off]) : 0.0f;
    vr[i] = valid_col ? gs::to_f32(vp[off]) : 0.0f;
    dk_acc[i] = 0.0f;
    dv_acc[i] = 0.0f;
  }

  // causal: rows below this tile's first key see none of its keys
  const int q_begin = causal ? kb * kBlockKV : 0;
  for (int q0 = q_begin; q0 < S; q0 += kBlockQ) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBlockQ * kD; idx += kThreads) {
      const int row = q0 + idx / kD;
      const int64_t off = (int64_t)row * kD + idx % kD;
      s_q[idx] = row < S ? gs::to_f32(qp[off]) : 0.0f;
      s_do[idx] = row < S ? gs::to_f32(dop[off]) : 0.0f;
    }
    for (int r = tid; r < kBlockQ; r += kThreads) {
      const int row = q0 + r;
      const bool ok = row < S;
      s_m[r] = ok ? m_in[bh * S + row] : 0.0f;
      s_inv[r] = ok ? gs::recip_positive(fmaxf(l_in[bh * S + row], 1e-30f), rom) : 0.0f;
      s_delta[r] = ok ? delta_in[bh * S + row] : 0.0f;
    }
    __syncthreads();

    const int i_end = min(kBlockQ, S - q0);  // uniform across the block
    for (int i = 0; i < i_end; ++i) {
      const float* qrow = s_q + i * kD + half;
      const float* dorow = s_do + i * kD + half;
      float dot = 0.0f, dp = 0.0f;
#pragma unroll
      for (int t = 0; t < kHalf; ++t) {
        dot = fmaf(qrow[2 * t], kr[t], dot);
        dp = fmaf(dorow[2 * t], vr[t], dp);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const bool masked = causal && col > q0 + i;
      const float pr = masked ? 0.0f : expf(dot * sm_scale - s_m[i]) * s_inv[i];
      const float ds = pr * (dp - s_delta[i]) * sm_scale;
#pragma unroll
      for (int t = 0; t < kHalf; ++t) {
        dv_acc[t] = fmaf(pr, dorow[2 * t], dv_acc[t]);
        dk_acc[t] = fmaf(ds, qrow[2 * t], dk_acc[t]);
      }
    }
  }

  if (valid_col) {
    const int64_t base = bh * S * kD + (int64_t)col * kD;
#pragma unroll
    for (int t = 0; t < kHalf; ++t) {
      dk[base + 2 * t + half] = dk_acc[t];
      dv[base + 2 * t + half] = dv_acc[t];
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *m, *l, *delta, *rom;
  int B, H, KH, S;
  float sm_scale;
  int causal, p, iters, pipelined;
  cudaStream_t stream;
};

template <typename T, int kD>
int launch_dq(const Args& a, void* dq) {
  const dim3 grid((a.S + kBlockQ - 1) / kBlockQ, a.H, a.B);
  const size_t smem = (2 * kBlockKV * kD + (1u << a.p)) * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<T, kD>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.m),
      static_cast<const float*>(a.l), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.rom), static_cast<T*>(dq), a.H, a.KH, a.S, a.sm_scale,
      a.causal, a.p, a.iters, a.pipelined);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int launch_dkv(const Args& a, void* dk, void* dv) {
  const dim3 grid((a.S + kBlockKV - 1) / kBlockKV, a.H, a.B);
  const size_t smem = (2 * kBlockQ * kD + 3 * kBlockQ + (1u << a.p)) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, kD>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.m),
      static_cast<const float*>(a.l), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.rom), static_cast<float*>(dk), static_cast<float*>(dv),
      a.H, a.KH, a.S, a.sm_scale, a.causal, a.p, a.iters, a.pipelined);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dq_for_dim(int D, const Args& a, void* dq) {
  switch (D) {
    case 16: return launch_dq<T, 16>(a, dq);
    case 32: return launch_dq<T, 32>(a, dq);
    case 64: return launch_dq<T, 64>(a, dq);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dkv_for_dim(int D, const Args& a, void* dk, void* dv) {
  switch (D) {
    case 16: return launch_dkv<T, 16>(a, dk, dv);
    case 32: return launch_dkv<T, 32>(a, dk, dv);
    case 64: return launch_dkv<T, 64>(a, dk, dv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, dout: (B, H, S, D); k, v: (B, KH, S, D), contiguous, one dtype, f32 or
// bf16 (is_bf16), D in {16, 32, 64}; m, l, delta: (B, H, S) f32 (the
// forward's residuals and sum(dout * out, -1)); rom: (2^p,) f32 reciprocal
// table.  dq: (B, H, S, D) in the input dtype.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for another D).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* m, const void* l,
                                      const void* delta, const void* rom, void* dq,
                                      int B, int H, int KH, int S, int D,
                                      float sm_scale, int causal, int p, int iters,
                                      int pipelined, int is_bf16, void* stream) {
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const Args a{q, k, v, dout, m, l, delta, rom, B, H, KH, S, sm_scale, causal, p, iters,
               pipelined, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dq_for_dim<__nv_bfloat16>(D, a, dq) : dq_for_dim<float>(D, a, dq);
}

// As flash_attention_bwd_dq; dk, dv: (B, H, S, D) f32, one per QUERY head
// (the caller sums each GQA group onto its KV head).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* m, const void* l,
                                       const void* delta, const void* rom, void* dk,
                                       void* dv, int B, int H, int KH, int S, int D,
                                       float sm_scale, int causal, int p, int iters,
                                       int pipelined, int is_bf16, void* stream) {
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const Args a{q, k, v, dout, m, l, delta, rom, B, H, KH, S, sm_scale, causal, p, iters,
               pipelined, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dkv_for_dim<__nv_bfloat16>(D, a, dk, dv)
                 : dkv_for_dim<float>(D, a, dk, dv);
}
