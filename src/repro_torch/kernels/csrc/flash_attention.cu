// Causal GQA flash-attention forward with a Goldschmidt epilogue, for
// sm_90a: both products on the tensor cores, f32-accurate through a TF32
// hi/lo split.
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel (:59), the forward
// pallas_call of _fwd_call (:142): online-softmax attention over
// q (B, H, S, D), k/v (B, KH, S, D), GQA via kv_head = h / (H / KH), output
// acc * GS(1 / max(l, 1e-30)); when asked (the differentiated forward), also
// the (B, H, S) f32 row statistics m (running max of sm_scale * q k^T, masked
// logits at -1e30) and l (the unguarded sum of exp(s - m)), the residuals
// of the backward kernels in flash_attention_bwd.cu.
//
// Bound on this card: the work is two S^2*D products (halved for causal)
// against O(S*D) bytes, ~S/4 flops per f32 byte.  An f32-accurate product
// costs three TF32 tensor-core passes (flash_mma.cuh: lo*hi + hi*lo +
// hi*hi), so the least time is 3x the products' flops at the 495 TFLOP/s
// TF32 rate, 2.5x below the bound of the same products on the fp32 FMA
// pipes (67 TFLOP/s); at that rate the operations bind from S ~ 200 up
// (the serving prefills, S <= 333, sit near the ridge).  bf16 inputs are
// exact in TF32: q k^T takes one pass, p v two (p is f32).
//
// Design:
// * mma.sync m16n8k8 TF32, one warp per 16 query rows, four warps per
//   64-row block, one block per (b, h, 64-row q tile), the tiles longest
//   (causal) first.  The block's q rows are staged once in shared memory
//   beside a 2-stage cp.async ring of K and V tiles (tile t + 1 lands while
//   tile t computes), all in the input dtype, widened at the fragment read.
// * Per 64-key tile a warp takes S = q k^T (16 x 64) in accumulators,
//   scales and masks it, and runs the online softmax in registers: a row's
//   max and its sum of exp(s - m) meet across the row's four lanes by two
//   shuffles (the max with max.NaN: a NaN score makes m NaN, as jnp.max
//   does); m and l stay f32 in registers, summed tile by tile in key order.  P = exp(s - m) is fed back as the A operand of O += P V through
//   the k-permutation of flash_mma.cuh, so P never goes through shared
//   memory.  P V sums over keys, so each k-step's passes are summed apart
//   (mma_step's kSum); q k^T, over the head dim, accumulates in the tensor
//   cores.
// * Epilogue: one Goldschmidt reciprocal of max(l, 1e-30) per row
//   (gs::recip_positive, ROM in shared memory), the rows scaled and stored.
// * Causal: kv tiles wholly above the block's diagonal are never loaded,
//   nor a warp's tile wholly above its rows computed; inside, and past the
//   end of a ragged S, logits are masked to -1e30.  A ragged S is masked
//   (zero-filled copies), not padded by the caller.
#include <cstdint>

#include "flash_mma.cuh"
#include "gs_common.cuh"

namespace {

using flash_mma::FragA;
using flash_mma::FragB;

constexpr int kBlock = flash_mma::kTileRows;  // q rows per block == keys per kv tile
constexpr int kWarps = 4;                     // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = 5;  // staged tiles: the K and V rings and the block's q rows

// The max (kMax) or the sum of x over the four lanes that hold one row.
template <bool kMax>
__device__ __forceinline__ float quad_reduce(float x) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? flash_mma::max_nan(x, y) : x + y;
  }
  return x;
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ rom_g,
                 T* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int H, int KH, int S, float sm_scale,
                 int causal, int p, int iters, int pipelined) {
  constexpr bool kExact = flash_mma::IsExact<T>::value;
  constexpr int kPassQK = kExact ? 1 : 3;  // q k^T
  constexpr int kPassP = kExact ? 2 : 3;   // p v: p is f32
  constexpr int kPitch = flash_mma::pitch<T, kD>();
  constexpr int kTile = kBlock * kPitch;
  constexpr int kK = kD / 8;      // k-steps over the head dim
  constexpr int kN = kBlock / 8;  // 8-key blocks per kv tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);  // [2][kBlock][kPitch]: the K ring
  T* s_v = s_k + 2 * kTile;             // [2][kBlock][kPitch]: the V ring
  T* s_q = s_v + 2 * kTile;             // [kBlock][kPitch]: this block's q rows
  float* s_rom = reinterpret_cast<float*>(s_q + kTile);  // 2^p ROM entries

  const int qb = gridDim.z - 1 - blockIdx.z;  // longest (causal) first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t bh = (int64_t)b * H + h;
  const T* kp = k + ((int64_t)b * KH + kvh) * S * kD;
  const T* vp = v + ((int64_t)b * KH + kvh) * S * kD;

  const int kv_end = causal ? min(S, (qb + 1) * kBlock) : S;
  const int n_tiles = (kv_end + kBlock - 1) / kBlock;
  flash_mma::load_tile_async<T, kD, kThreads>(s_q, q + bh * S * kD, qb * kBlock, S);
  flash_mma::load_tile_async<T, kD, kThreads>(s_k, kp, 0, S);
  flash_mma::load_tile_async<T, kD, kThreads>(s_v, vp, 0, S);
  flash_mma::cp_async_commit();
  gs::stage_rom(s_rom, rom_g, p);

  const int row0 = qb * kBlock + 16 * warp;  // the warp's first query row
  const int rows[2] = {row0 + gid, row0 + gid + 8};
  float m[2] = {gs::kNegInf, gs::kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[kK][4];
#pragma unroll
  for (int nd = 0; nd < kK; ++nd)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nd][r] = 0.0f;

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    flash_mma::cp_async_wait_all();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      flash_mma::load_tile_async<T, kD, kThreads>(s_k + nxt * kTile, kp, (t + 1) * kBlock, S);
      flash_mma::load_tile_async<T, kD, kThreads>(s_v + nxt * kTile, vp, (t + 1) * kBlock, S);
      flash_mma::cp_async_commit();
    }
    const T* tk = s_k + (t & 1) * kTile;
    const T* tv = s_v + (t & 1) * kTile;
    const int key0 = t * kBlock;
    // warp-uniform: every row of this warp past S, or (causal) before every
    // key of the tile; the warp still meets the next tile's barrier
    if (row0 >= S || (causal && key0 > row0 + 15)) continue;

    // s = q k^T over the tile's 64 keys
    float s[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const FragA a = flash_mma::load_a<T, kPitch>(s_q + 16 * warp * kPitch + 8 * kk);
#pragma unroll
      for (int n = 0; n < kN; n += 2) {
        FragB y[2];
        flash_mma::load_b2<T, kPitch>(y, tk + 8 * n * kPitch + 8 * kk);
        flash_mma::mma_step<kPassQK, false>(s[n], a, y[0]);
        flash_mma::mma_step<kPassQK, false>(s[n + 1], a, y[1]);
      }
    }

    // the online softmax: lane values r = 0, 1 belong to row gid, r = 2, 3
    // to row gid + 8
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = key0 + 8 * n + 2 * tig + (r & 1);
        const bool masked = key >= S || (causal && key > rows[r >> 1]);
        s[n][r] = masked ? gs::kNegInf : s[n][r] * sm_scale;
        m_new[r >> 1] = flash_mma::max_nan(m_new[r >> 1], s[n][r]);
      }
    float alpha[2], l_tile[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = quad_reduce<true>(m_new[i]);
      alpha[i] = expf(m[i] - m_new[i]);
      m[i] = m_new[i];
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[n][r] = expf(s[n][r] - m[r >> 1]);
        l_tile[r >> 1] += s[n][r];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_reduce<false>(l_tile[i]);
#pragma unroll
    for (int nd = 0; nd < kK; ++nd)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nd][r] *= alpha[r >> 1];

    // acc += p v over the tile's keys, each k-step's passes summed apart
#pragma unroll
    for (int kc = 0; kc < kN; ++kc) {
      const FragA ap = flash_mma::a_from_acc(s[kc]);
#pragma unroll
      for (int nd = 0; nd < kK; ++nd)
        flash_mma::mma_step<kPassP, true>(
            acc[nd], ap, flash_mma::load_b_perm<T, kPitch>(tv + 8 * kc * kPitch + 8 * nd));
    }
  }

  const gs::Rom rom{s_rom, p, iters, pipelined, 0.0f};
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = gs::recip_positive(flash_mma::max_nan(l[i], 1e-30f), rom);
#pragma unroll
  for (int nd = 0; nd < kK; ++nd)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nd][r] *= inv[r >> 1];
  flash_mma::store_rows<T, kD>(out + bh * S * kD, acc, row0, S);
  // the four lanes of a row hold the same m and l; one writes them
  if (m_out != nullptr && tig == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < S) {
        m_out[bh * S + rows[i]] = m[i];
        l_out[bh * S + rows[i]] = l[i];
      }
  }
}

struct Args {
  const void *q, *k, *v, *rom;
  void *out, *m_out, *l_out;
  int B, H, KH, S;
  float sm_scale;
  int causal, p, iters, pipelined;
  cudaStream_t stream;
};

template <typename T, int kD>
int launch(const Args& a) {
  const size_t smem = kTiles * kBlock * flash_mma::pitch<T, kD>() * sizeof(T) +
                      (1u << a.p) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, kD>;
  const cudaError_t err = flash_mma::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // (H, B, q tiles): the q tile is the grid's slowest axis
  const dim3 grid(a.H, a.B, (a.S + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.rom), static_cast<T*>(a.out), static_cast<float*>(a.m_out),
      static_cast<float*>(a.l_out), a.H, a.KH, a.S, a.sm_scale, a.causal, a.p, a.iters,
      a.pipelined);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_dim(int D, const Args& a) {
  switch (D) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: (B, H, S, D); k, v: (B, KH, S, D), contiguous and 16-byte
// aligned, one dtype, f32 or bf16 (is_bf16), D in {16, 32, 64}; rom: (2^p,)
// f32 reciprocal table; m_out, l_out: (B, H, S) f32, both null or both set.
// Returns cudaGetLastError() (cudaErrorInvalidValue for another D).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* rom, void* out, void* m_out, void* l_out,
                                   int B, int H, int KH, int S, int D, float sm_scale,
                                   int causal, int p, int iters, int pipelined,
                                   int is_bf16, void* stream) {
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const Args a{q, k, v, rom, out, m_out, l_out, B, H, KH, S, sm_scale, causal, p, iters,
               pipelined, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? launch_for_dim<__nv_bfloat16>(D, a) : launch_for_dim<float>(D, a);
}
