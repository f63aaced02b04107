// Causal GQA flash-attention backward (dq; per-q-head dk, dv) with the
// Goldschmidt recompute of 1/l, for sm_90a: the seven products on the
// tensor cores, f32-accurate through a TF32 hi/lo split.
//
// Replaces: src/repro/kernels/flash_attention.py::_bwd_dq_kernel (:205) and
// ::_bwd_dkv_kernel (:243), the two pallas_calls of _bwd_call (:311, :338),
// with _p_tile's recompute of the probabilities from the forward's saved
// row statistics:
//
//   p_ij  = exp(s_ij - m_i) * GS(1 / max(l_i, 1e-30)),  s = sm_scale * q k^T
//   ds_ij = p_ij * (do_i . v_j - delta_i) * sm_scale,  delta_i = do_i . out_i
//   dq_i  = sum_j ds_ij k_j         (flash_bwd_dq_kernel)
//   dv_j  = sum_i p_ij do_i,  dk_j = sum_i ds_ij q_i   (flash_bwd_dkv_kernel)
//
// 1/l is one Goldschmidt reciprocal (gs::recip_positive, ROM in shared
// memory) per query row, the forward epilogue's datapath, not
// exp(s - logsumexp).  delta, the GQA group-sum of the per-q-head dk/dv and
// the casts stay torch ops outside, as in the reference.  Each block owns
// its output tile: no atomics, and the result does not depend on block
// order, which is why this is two kernels and not one with an atomic dq.
//
// Bound on this card: the work is seven S^2*D products (dq three, dk/dv
// four; halved for causal) against O(S*D) bytes, so the operations bind.
// An f32-accurate product costs three TF32 tensor-core passes (flash_mma.cuh:
// lo*hi + hi*lo + hi*hi), so the least time is 3x the products' flops at
// the 495 TFLOP/s TF32 rate: 2.5x below the bound of the same products on
// the fp32 FMA pipes (67 TFLOP/s).  bf16 inputs are exact in TF32:
// q k^T and do v^T take one pass, the products with p or ds two.
//
// Design:
// * mma.sync m16n8k8 TF32, one warp per 16 rows (dq: query rows; dk/dv:
//   keys), four warps per 64-row block.  Scores are taken a chunk of
//   columns at a time (64 keys for dq, 16 queries for dk/dv, which holds
//   two accumulator tiles) in accumulators, turned into p and ds in
//   registers, and fed back as the A operand of the next product through
//   the k-permutation of flash_mma.cuh, so P and dS never go through
//   shared memory.  The products over the sequence (ds k, p^T do, ds^T q)
//   sum each k-step's passes apart (mma_step's kSum), the ones over the
//   head dim accumulate in the tensor cores.  wgmma is not used: it takes
//   TF32 operands K-major only, and those three products contract over the
//   sequence axis.
// * dq: one block per (b, h, 64-row q tile).  Its q and do rows are staged
//   once in shared memory beside a 2-stage cp.async ring of K and V tiles
//   (tile t + 1 lands while tile t computes), all in the input dtype,
//   widened at the fragment read; held in registers instead, q and do
//   spilled at D = 64.  m, GS(1/l) and delta of a lane's two rows live in
//   registers.
// * dk/dv: one block per (b, h, 64-key kv tile); S^T = K Q^T and
//   dP^T = V dO^T put keys on the rows.  Its k and v rows are staged, Q
//   and dO tiles stream through the same ring, and each tile's m, GS(1/l)
//   and delta are fetched a tile ahead by the first 64 threads and written
//   to a double-buffered shared-memory row before the tile's barrier.
// * Causal: tiles wholly above the diagonal are never visited, nor a
//   warp's chunks wholly above it; inside, p = 0 for col > row.  The
//   grid's slowest axis walks the tiles longest first (dq: the last q
//   tile; dk/dv: the first kv tile).  A ragged S is masked (zero-filled
//   copies, p = 0 past S), not padded by the caller.
#include <cstdint>

#include "flash_mma.cuh"
#include "gs_common.cuh"

namespace {

using flash_mma::allow_smem;
using flash_mma::FragA;
using flash_mma::FragB;
using flash_mma::store_rows;

constexpr int kBlock = flash_mma::kTileRows;  // q rows per q tile == keys per kv tile
constexpr int kWarps = 4;                     // 16 rows (dq) or keys (dk/dv) each
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = 6;  // staged tiles: two 2-stage rings and the block's own rows
// Score columns taken at a time: keys (dq) and queries (dk/dv).  dk/dv
// holds two accumulator tiles, so its chunk is narrower: at 32 it spills.
constexpr int kChunkDq = 64;
constexpr int kChunkDkv = 16;

// acc1 = a1 b^T, acc2 = a2 c^T over kD, for the 16 rows of a warp whose A
// rows start at `a1`, `a2` (staged tiles) and the kN 8-row blocks of the B
// tiles `b`, `c` that start at row `col0`: the score products (s = q k^T,
// dp = do v^T, or their transposes), f32 accumulators from zero.
template <typename T, int kD, int kN, int kPasses>
__device__ __forceinline__ void score_products(float (&acc1)[kN][4], float (&acc2)[kN][4],
                                               const T* a1, const T* a2, const T* b,
                                               const T* c, int col0) {
  constexpr int kPitch = flash_mma::pitch<T, kD>();
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc1[n][r] = acc2[n][r] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const FragA x1 = flash_mma::load_a<T, kPitch>(a1 + 8 * kk);
    const FragA x2 = flash_mma::load_a<T, kPitch>(a2 + 8 * kk);
#pragma unroll
    for (int n = 0; n < kN; n += 2) {
      FragB y1[2], y2[2];
      const int off = (col0 + 8 * n) * kPitch + 8 * kk;
      flash_mma::load_b2<T, kPitch>(y1, b + off);
      flash_mma::load_b2<T, kPitch>(y2, c + off);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        flash_mma::mma_step<kPasses, false>(acc1[n + i], x1, y1[i]);
        flash_mma::mma_step<kPasses, false>(acc2[n + i], x2, y2[i]);
      }
    }
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ m_in, const float* __restrict__ l_in,
                    const float* __restrict__ delta_in, const float* __restrict__ rom_g,
                    T* __restrict__ dq, int H, int KH, int S, float sm_scale,
                    int causal, int p, int iters, int pipelined) {
  constexpr bool kExact = flash_mma::IsExact<T>::value;
  constexpr int kPassQK = kExact ? 1 : 3;  // q k^T, do v^T
  constexpr int kPassP = kExact ? 2 : 3;   // ds k: ds is f32
  constexpr int kPitch = flash_mma::pitch<T, kD>();
  constexpr int kTile = kBlock * kPitch;
  constexpr int kK = kD / 8;        // k-steps over the head dim
  constexpr int kN = kChunkDq / 8;  // 8-key blocks per chunk
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);  // [2][kBlock][kPitch]: the K ring
  T* s_v = s_k + 2 * kTile;             // [2][kBlock][kPitch]: the V ring
  T* s_q = s_v + 2 * kTile;             // [kBlock][kPitch]: this block's q rows
  T* s_do = s_q + kTile;                // [kBlock][kPitch]: and its do rows
  float* s_rom = reinterpret_cast<float*>(s_do + kTile);  // 2^p ROM entries

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
  flash_mma::load_tile_async<T, kD, kThreads>(s_do, dout + bh * S * kD, qb * kBlock, S);
  flash_mma::load_tile_async<T, kD, kThreads>(s_k, kp, 0, S);
  flash_mma::load_tile_async<T, kD, kThreads>(s_v, vp, 0, S);
  flash_mma::cp_async_commit();
  gs::stage_rom(s_rom, rom_g, p);
  const gs::Rom rom{s_rom, p, iters, pipelined, 0.0f};

  const int row0 = qb * kBlock + 16 * warp;  // the warp's first query row
  const int rows[2] = {row0 + gid, row0 + gid + 8};
  float m[2], inv[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = rows[i] < S;
    m[i] = ok ? m_in[bh * S + rows[i]] : 0.0f;
    inv[i] = ok ? gs::recip_positive(flash_mma::max_nan(l_in[bh * S + rows[i]], 1e-30f), rom) : 0.0f;
    delta[i] = ok ? delta_in[bh * S + rows[i]] : 0.0f;
  }
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
#pragma unroll 1
    for (int c0 = 0; c0 < kBlock; c0 += kChunkDq) {
      const int key0 = t * kBlock + c0;
      // warp-uniform: past S, or (causal) past every row of this warp
      if (key0 >= S || (causal && key0 > row0 + 15)) break;
      float s[kN][4], dp[kN][4];
      score_products<T, kD, kN, kPassQK>(s, dp, s_q + 16 * warp * kPitch,
                                         s_do + 16 * warp * kPitch, tk, tv, c0);
      // p, then ds in place of s
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = r >> 1;
          const int key = key0 + 8 * n + 2 * tig + (r & 1);
          const bool masked = key >= S || (causal && key > rows[i]);
          const float pr = masked ? 0.0f : expf(s[n][r] * sm_scale - m[i]) * inv[i];
          s[n][r] = pr * (dp[n][r] - delta[i]) * sm_scale;
        }
      // dq += ds k over the chunk's keys, each k-step's passes summed apart
#pragma unroll
      for (int kc = 0; kc < kN; ++kc) {
        const FragA ads = flash_mma::a_from_acc(s[kc]);
#pragma unroll
        for (int nd = 0; nd < kK; ++nd)
          flash_mma::mma_step<kPassP, true>(
              acc[nd], ads, flash_mma::load_b_perm<T, kPitch>(tk + (c0 + 8 * kc) * kPitch + 8 * nd));
      }
    }
  }
  store_rows<T, kD>(dq + bh * S * kD, acc, row0, S);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ m_in, const float* __restrict__ l_in,
                     const float* __restrict__ delta_in, const float* __restrict__ rom_g,
                     float* __restrict__ dk, float* __restrict__ dv, int H, int KH, int S,
                     float sm_scale, int causal, int p, int iters, int pipelined) {
  constexpr bool kExact = flash_mma::IsExact<T>::value;
  constexpr int kPassQK = kExact ? 1 : 3;  // k q^T, v do^T
  constexpr int kPassP = kExact ? 2 : 3;   // p^T do, ds^T q: p and ds are f32
  constexpr int kPitch = flash_mma::pitch<T, kD>();
  constexpr int kTile = kBlock * kPitch;
  constexpr int kK = kD / 8;         // k-steps over the head dim
  constexpr int kN = kChunkDkv / 8;  // 8-query blocks per chunk
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);  // [2][kBlock][kPitch]: the Q ring
  T* s_do = s_q + 2 * kTile;            // [2][kBlock][kPitch]: the dO ring
  T* s_k = s_do + 2 * kTile;            // [kBlock][kPitch]: this block's k rows
  T* s_v = s_k + kTile;                 // [kBlock][kPitch]: and its v rows
  float* s_m = reinterpret_cast<float*>(s_v + kTile);  // [2][kBlock] row max
  float* s_inv = s_m + 2 * kBlock;      // [2][kBlock] GS(1 / max(l, 1e-30))
  float* s_delta = s_inv + 2 * kBlock;  // [2][kBlock]
  float* s_rom = s_delta + 2 * kBlock;  // 2^p ROM entries

  const int kb = blockIdx.z;  // causal: the first kv tiles see the most rows
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t bh = (int64_t)b * H + h;
  const T* qp = q + bh * S * kD;
  const T* dop = dout + bh * S * kD;

  // causal: rows below this tile's first key see none of its keys
  const int q_begin = causal ? kb * kBlock : 0;
  const int n_tiles = (S - q_begin + kBlock - 1) / kBlock;
  const int64_t kvh_off = ((int64_t)b * KH + kvh) * S * kD;
  flash_mma::load_tile_async<T, kD, kThreads>(s_k, k + kvh_off, kb * kBlock, S);
  flash_mma::load_tile_async<T, kD, kThreads>(s_v, v + kvh_off, kb * kBlock, S);
  flash_mma::load_tile_async<T, kD, kThreads>(s_q, qp, q_begin, S);
  flash_mma::load_tile_async<T, kD, kThreads>(s_do, dop, q_begin, S);
  flash_mma::cp_async_commit();
  gs::stage_rom(s_rom, rom_g, p);
  const gs::Rom rom{s_rom, p, iters, pipelined, 0.0f};

  // The next q tile's row statistics, one row per thread of the first two
  // warps, fetched a tile ahead and written out before the tile's barrier.
  const int r_own = threadIdx.x;
  bool st_ok = false;
  float st_m = 0.0f, st_l = 1.0f, st_delta = 0.0f;
  auto fetch_stats = [&](int q0) {
    if (r_own < kBlock) {
      const int row = q0 + r_own;
      st_ok = row < S;
      if (st_ok) {
        st_m = m_in[bh * S + row];
        st_l = l_in[bh * S + row];
        st_delta = delta_in[bh * S + row];
      }
    }
  };
  fetch_stats(q_begin);

  const int key0 = kb * kBlock + 16 * warp;  // the warp's first key
  const int keys[2] = {key0 + gid, key0 + gid + 8};
  float dk_acc[kK][4], dv_acc[kK][4];
#pragma unroll
  for (int nd = 0; nd < kK; ++nd)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk_acc[nd][r] = dv_acc[nd][r] = 0.0f;

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (r_own < kBlock) {  // readers of this stage finished before the last barrier
      s_m[stage * kBlock + r_own] = st_ok ? st_m : 0.0f;
      s_inv[stage * kBlock + r_own] =
          st_ok ? gs::recip_positive(flash_mma::max_nan(st_l, 1e-30f), rom) : 0.0f;
      s_delta[stage * kBlock + r_own] = st_ok ? st_delta : 0.0f;
    }
    flash_mma::cp_async_wait_all();
    __syncthreads();  // tile t and its statistics are in; tile t - 1 is consumed
    const int q0 = q_begin + t * kBlock;
    if (t + 1 < n_tiles) {
      const int nxt = stage ^ 1;
      flash_mma::load_tile_async<T, kD, kThreads>(s_q + nxt * kTile, qp, q0 + kBlock, S);
      flash_mma::load_tile_async<T, kD, kThreads>(s_do + nxt * kTile, dop, q0 + kBlock, S);
      flash_mma::cp_async_commit();
      fetch_stats(q0 + kBlock);
    }
    const T* tq = s_q + stage * kTile;
    const T* tdo = s_do + stage * kTile;
    const float* sm = s_m + stage * kBlock;
    const float* sinv = s_inv + stage * kBlock;
    const float* sdelta = s_delta + stage * kBlock;
#pragma unroll 1
    for (int c0 = 0; c0 < kBlock; c0 += kChunkDkv) {
      const int qc = q0 + c0;
      if (qc >= S) break;  // warp-uniform
      if (causal && qc + kChunkDkv - 1 < key0) continue;  // every row before the warp's keys
      float sp[kN][4], dsp[kN][4];  // S^T -> P^T and dP^T -> dS^T
      score_products<T, kD, kN, kPassQK>(sp, dsp, s_k + 16 * warp * kPitch,
                                         s_v + 16 * warp * kPitch, tq, tdo, c0);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int ql = c0 + 8 * n + 2 * tig;  // this lane's two query columns
        const float2 mq = *reinterpret_cast<const float2*>(sm + ql);
        const float2 iq = *reinterpret_cast<const float2*>(sinv + ql);
        const float2 dl = *reinterpret_cast<const float2*>(sdelta + ql);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = r & 1;
          const int query = q0 + ql + j;
          const bool masked = query >= S || (causal && keys[r >> 1] > query);
          const float pr =
              masked ? 0.0f : expf(sp[n][r] * sm_scale - (j ? mq.y : mq.x)) * (j ? iq.y : iq.x);
          sp[n][r] = pr;
          dsp[n][r] = pr * (dsp[n][r] - (j ? dl.y : dl.x)) * sm_scale;
        }
      }
      // dv += p^T do, dk += ds^T q over the chunk's queries, each k-step's
      // passes summed apart
#pragma unroll
      for (int kc = 0; kc < kN; ++kc) {
        const FragA ap = flash_mma::a_from_acc(sp[kc]);
        const FragA ads = flash_mma::a_from_acc(dsp[kc]);
        const int off = (c0 + 8 * kc) * kPitch;
#pragma unroll
        for (int nd = 0; nd < kK; ++nd) {
          flash_mma::mma_step<kPassP, true>(
              dv_acc[nd], ap, flash_mma::load_b_perm<T, kPitch>(tdo + off + 8 * nd));
          flash_mma::mma_step<kPassP, true>(
              dk_acc[nd], ads, flash_mma::load_b_perm<T, kPitch>(tq + off + 8 * nd));
        }
      }
    }
  }
  store_rows<float, kD>(dk + bh * S * kD, dk_acc, key0, S);
  store_rows<float, kD>(dv + bh * S * kD, dv_acc, key0, S);
}

struct Args {
  const void *q, *k, *v, *dout, *m, *l, *delta, *rom;
  int B, H, KH, S;
  float sm_scale;
  int causal, p, iters, pipelined;
  cudaStream_t stream;
};

// (H, B, tiles): the tile index is the grid's slowest axis, so the blocks
// are issued tile by tile over every (b, h).
dim3 grid_of(const Args& a) { return dim3(a.H, a.B, (a.S + kBlock - 1) / kBlock); }

template <typename T, int kD>
size_t ring_bytes() {
  return kTiles * kBlock * flash_mma::pitch<T, kD>() * sizeof(T);
}

template <typename T, int kD>
int launch_dq(const Args& a, void* dq) {
  const size_t smem = ring_bytes<T, kD>() + (1u << a.p) * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<T, kD>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid_of(a), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.m),
      static_cast<const float*>(a.l), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.rom), static_cast<T*>(dq), a.H, a.KH, a.S, a.sm_scale,
      a.causal, a.p, a.iters, a.pipelined);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int launch_dkv(const Args& a, void* dk, void* dv) {
  const size_t smem = ring_bytes<T, kD>() + (6 * kBlock + (1u << a.p)) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, kD>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid_of(a), kThreads, smem, a.stream>>>(
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

// q, dout: (B, H, S, D); k, v: (B, KH, S, D), contiguous and 16-byte
// aligned, one dtype, f32 or bf16 (is_bf16), D in {16, 32, 64}; m, l,
// delta: (B, H, S) f32 (the forward's residuals and sum(dout * out, -1));
// rom: (2^p,) f32 reciprocal table.  dq: (B, H, S, D) in the input dtype.
// Returns cudaGetLastError() (cudaErrorInvalidValue for another D).
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
