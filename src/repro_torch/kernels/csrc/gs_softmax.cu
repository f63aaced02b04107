// Row softmax with a Goldschmidt reciprocal of the row sum, for sm_90a.
//
// Replaces: src/repro/kernels/gs_softmax.py::_kernel (the pallas_call in
// _run): per row of the last axis, in f32, m = max(x), e = exp(x - m),
// s = sum(e) (>= 1 for a finite row: the max element gives exp(0)), then
// e * GS(1/s) in the input's dtype.  The TPU kernel pads the columns to a
// lane multiple with -inf and gathers the ROM by a one-hot matmul; here the
// loops stop at the real width and the ROM is one indexed load a row.
//
// Bound on this card: device memory.  A call moves rows*d*(in + out) bytes
// and does ~5 flops and one expf an element, far below where the fp32 units
// would bind.  At the benchmark's (16, 384) a launch moves 49 KB and the
// launch and one dependent chain bind (the loads, two reductions, one ROM
// entry, the stores); at a sampler's (8, 32000) the rows are too few for one
// block a row to fill the card, and at (256, 32000) the bytes bind.
//
// Design (the launch plan is the wrapper's, kernels/gs_softmax.py):
// * The row in registers, read once: thread t of a row's group holds the
//   kVecs vectors t, t + row_threads, ... of its row (kWidth elements each:
//   one 16-byte vector, 4 f32 or 8 bf16, when d is a multiple of the width
//   and x and out are 16-byte aligned, else one element), converted to f32.
//   It takes their max, and after the row's max overwrites them with
//   e = expf(x - M), sums those, and after the row's sum stores e * inv from
//   the same registers (streaming 16-byte stores).  expf runs once an
//   element.  The group's next row is loaded ahead, before this row's
//   reductions.
// * Block instances (kCluster false): a row belongs to a group of
//   row_threads threads (a multiple of 32), a block holds blockDim /
//   row_threads groups and walks the rows in a grid-stride loop, the grid
//   sized to the card (gs_rmsnorm's row plan: up to 16384 elements a row in
//   16-byte vectors, 4096 in single elements).
// * Cluster instances (kCluster true), for wider rows of 16-byte vectors: a
//   row is split into as many contiguous chunks as the thread-block cluster
//   has CTAs (a launch attribute, at most kMaxCluster; the plan takes 8), one
//   chunk a CTA at kClusterElements a thread, and the clusters walk the rows.
//   The CTAs exchange their warps' sums and maxima through distributed shared
//   memory: lane r of every warp pushes its warp's (sum, max) into rank r's
//   shared memory (st.async, counted in bytes on rank r's mbarrier), and
//   every thread waits on its own CTA's mbarrier only, then folds the pairs
//   of every warp of every rank in one fixed order itself, so every CTA of a
//   row holds the same M, s and inv bit for bit (no atomics, no barrier among
//   a CTA's own warps).  One exchange a row: exchange j carries row j - 1's
//   sums and row j's maxima (taken from the row loaded ahead), so a row's sum
//   and the next row's max travel together; the exchanges alternate between
//   two buffers, each with its mbarrier.  A cluster-wide barrier at the start
//   (the mbarriers initialised before any push) and one at the end (no CTA
//   leaves while its pushes may be in flight; arrived at after the last
//   exchange, waited on after the stores) are the only ones: a CTA never
//   waits at a cluster-wide barrier between rows (a barrier.cluster pair for
//   each reduction was slower, PERF.md's gs_softmax section).  Rows wider
//   than 8 CTAs of 1024 threads hold, and single-element rows wider than the
//   block plan, take the looping instance.
// * The looping instance (kVecs == 0, block): reads x for the max, again
//   for the sum and again for the output, exp twice an element.
// * The reductions: the max with max.NaN (a NaN anywhere makes M NaN, as
//   torch.amax does; exact in any order), the sum with __fadd_rn: each
//   thread's elements in order, an xor butterfly over the warp (both lanes
//   of a pair add the same two values, so every lane ends with the same
//   bits), then in a block the row's warps in order, in a cluster warp w of
//   rank r at entry r * warps + w, lane l adding entries l, l + 32, ... in
//   order and an xor butterfly over the lanes.  Rows of several warps in a
//   block take one barrier for the max partials and one for the sum
//   partials; between one row's reads of a buffer and the next row's writes
//   to it lies the other reduction's barrier, so one buffer of each
//   suffices.  Shared memory holds those partials and the two exchanges and
//   nothing else.
// * One ROM entry a row, read from the table in device memory through the
//   read-only cache (no shared-memory copy of the 2^p-entry table), by every
//   thread of the row: no broadcast.  The peel and iterations are
//   gs_common.cuh's, so inv is the plain version's recip_positive of s bit
//   for bit; the sum's order and expf differ from torch's, so the kernel is
//   held to its plain version within a stated tolerance.
#include <cooperative_groups.h>

#include <cstdint>
#include <cstring>

#include "gs_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;          // gs_softmax.BLOCK_THREADS: block instances
constexpr int kMaxClusterThreads = 1024;  // gs_softmax.CLUSTER_THREADS: a CTA of a cluster
constexpr int kMaxWarps = kMaxClusterThreads / 32;
constexpr int kMaxCluster = 8;            // the portable limit; gs_softmax.CLUSTER takes it
constexpr int kClusterElements = 16;      // gs_softmax.CLUSTER_ELEMENTS: a thread's, in a cluster

// kWidth elements of T, one 16-byte vector when kWidth > 1.
template <typename T, int kWidth>
struct Vec {
  alignas(sizeof(T) * kWidth) T e[kWidth];
};

template <typename T, int kWidth>
__device__ __forceinline__ Vec<T, kWidth> load_vec(const T* __restrict__ x, int v) {
  Vec<T, kWidth> out;
  if constexpr (kWidth == 1) {
    out.e[0] = __ldg(x + v);
  } else {
    static_assert(sizeof(Vec<T, kWidth>) == sizeof(uint4), "a vector is 16 bytes");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x) + v);
    memcpy(&out, &raw, sizeof(raw));
  }
  return out;
}

// e * inv of a vector's e values into out, as streaming stores for a
// 16-byte vector (the kernel never reads out back).
template <typename T, int kWidth>
__device__ __forceinline__ void store_vec(T* __restrict__ out, int v, const float (&e)[kWidth],
                                          float inv) {
  Vec<T, kWidth> val;
#pragma unroll
  for (int j = 0; j < kWidth; ++j) val.e[j] = gs::from_f32<T>(__fmul_rn(e[j], inv));
  if constexpr (kWidth == 1) {
    out[v] = val.e[0];
  } else {
    uint4 raw;
    memcpy(&raw, &val, sizeof(raw));
    __stcs(reinterpret_cast<uint4*>(out) + v, raw);
  }
}

// max(a, b), NaN if either is NaN (fmaxf would drop it).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return max_nan(a, b); }
  __device__ __forceinline__ float identity() const { return -__int_as_float(0x7F800000); }
};
struct AddOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
  __device__ __forceinline__ float identity() const { return 0.0f; }
};

template <typename T, int kWidth>
__device__ __forceinline__ float vec_max(const Vec<T, kWidth>& v, float m) {
#pragma unroll
  for (int j = 0; j < kWidth; ++j) m = max_nan(m, gs::to_f32(v.e[j]));
  return m;
}

// An xor butterfly over the warp: every lane ends with the same bits.
template <typename Op>
__device__ __forceinline__ float warp_reduce(float v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The row's value from each warp's value v: for a row of `warps` > 1 warps,
// the per-warp values in part after one barrier, combined by `op` in every
// thread from the row's first warp on.  `warps` is the same in every thread
// of the block, so the barrier is reached by all of them or by none.
template <typename Op>
__device__ __forceinline__ float across_warps(float v, float* part, int warps, int warp0,
                                              Op op) {
  if (warps == 1) return v;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = part[warp0];
  for (int w = 1; w < warps; ++w) v = op(v, part[warp0 + w]);
  return v;
}

// -- the cluster's exchange ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of `addr` (a shared::cta address of this CTA) in the CTA of
// cluster rank `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// A (sum, max) pair from each warp of every rank, pushed into every rank's
// `vals` (st.async, counted in bytes on the receiver's mbarrier `bar`): a CTA
// waits for its peers' pairs, and never for a barrier of its own threads or
// of the cluster.
struct Exchange {
  float2 vals[kMaxCluster * kMaxWarps];
  uint64_t bar;

  // Before any peer pushes: one arrival a phase (the arming thread's).
  __device__ __forceinline__ void init() {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar)) : "memory");
  }

  // (s, m) (a warp's, the same in each of its lanes) from every warp of
  // every rank, combined into the same bits in every thread: lane r < ranks
  // of each warp pushes the pair into rank r's vals[rank * warps + warp];
  // thread 0 arms this CTA's barrier for all their bytes; every thread
  // waits for the phase of `parity`, then lane l folds entries l, l + 32,
  // ... in that order (the sums with __fadd_rn, the maxima with max.NaN)
  // and an xor butterfly combines the lanes.
  __device__ __forceinline__ float2 combine(float s, float m, int ranks, int rank, int warps,
                                            uint32_t parity) {
    const int lane = threadIdx.x & 31;
    const int n = ranks * warps;
    const uint32_t bar_addr = smem_addr(&bar);
    if (lane < ranks)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];" ::
              "r"(peer_addr(smem_addr(vals + rank * warps + (threadIdx.x >> 5)), lane)),
          "f"(s), "f"(m), "r"(peer_addr(bar_addr, lane))
          : "memory");
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_addr),
                   "r"(n * static_cast<int>(sizeof(float2)))
                   : "memory");
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done)
          : "r"(bar_addr), "r"(parity)
          : "memory");
    s = AddOp{}.identity();
    m = MaxOp{}.identity();
    for (int i = lane; i < n; i += 32) {
      s = AddOp{}(s, vals[i].x);
      m = MaxOp{}(m, vals[i].y);
    }
    return make_float2(warp_reduce(s, AddOp{}), warp_reduce(m, MaxOp{}));
  }
};

// 1/s on the plain version's datapath (gs_common.cuh recip_positive) with
// the one ROM entry read through the read-only cache.
__device__ __forceinline__ float row_inv(float s, const float* __restrict__ rom, int p,
                                         int iters, int pipelined) {
  const int mant = gs::mantissa_bits(s);
  float q = __ldg(rom + (mant >> (23 - p)));
  float r = __fmul_rn(gs::mantissa_to_m(mant), q);
  if (pipelined) {
#pragma unroll
    for (int i = 0; i < gs::kMaxPipelinedIters; ++i)
      if (i < iters) gs::recip_step(q, r);
  } else {
#pragma unroll 1
    for (int i = 0; i < iters; ++i) gs::recip_step(q, r);
  }
  return __fmul_rn(q, gs::pow2_from_biased(254 - gs::biased_exp(s)));
}

// Row `row`'s vectors lo + t, lo + t + row_threads, ... below hi into xv
// (none past the last row).
template <typename T, int kWidth, int kVecs>
__device__ __forceinline__ void load_row(Vec<T, kWidth> (&xv)[kVecs], const T* __restrict__ x,
                                         int64_t row, int rows, int d, int lo, int hi, int t,
                                         int row_threads) {
  if (row >= rows) return;
  const T* xr = x + row * d;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = lo + t + k * row_threads;
    if (v < hi) xv[k] = load_vec<T, kWidth>(xr, v);
  }
}

// The f32 values of the vectors a thread loaded.
template <typename T, int kWidth, int kVecs>
__device__ __forceinline__ void widen(const Vec<T, kWidth> (&xv)[kVecs],
                                       float (&f)[kVecs][kWidth]) {
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
#pragma unroll
    for (int j = 0; j < kWidth; ++j) f[k][j] = gs::to_f32(xv[k].e[j]);
}

// kVecs > 0: the row (kCluster: the CTA's chunk of it) in registers, kVecs
// vectors a thread, the next row's loaded ahead; kVecs == 0: the looping
// instance (a block instance).
template <typename T, int kWidth, int kVecs, bool kCluster>
__global__ void __launch_bounds__(kCluster ? kMaxClusterThreads : kMaxThreads)
gs_softmax_kernel(const T* __restrict__ x, const float* __restrict__ rom, T* __restrict__ out,
                  int rows, int d, int p, int iters, int pipelined, int row_threads) {
  static_assert(kVecs > 0 || !kCluster, "the looping instance is a block instance");
  __shared__ float part_max[kMaxWarps];
  __shared__ float part_sum[kMaxWarps];
  __shared__ Exchange ex[2];  // a cluster's exchanges, in turn
  const int nvec = d / kWidth;
  int ranks = 1, rank = 0;  // a cluster's CTAs are consecutive blocks
  if constexpr (kCluster) {
    const cg::cluster_group cluster = cg::this_cluster();
    ranks = static_cast<int>(cluster.dim_blocks().x);
    rank = static_cast<int>(cluster.block_rank());
  }
  const int groups = blockDim.x / row_threads;  // rows a block (1 in a cluster)
  const int group = threadIdx.x / row_threads;
  const int t = threadIdx.x - group * row_threads;
  const int warps = row_threads >> 5;  // warps a row (a chunk in a cluster)
  const int warp0 = group * warps;
  const int chunk = (nvec + ranks - 1) / ranks;  // vectors a CTA of a row
  const int lo = rank * chunk;
  const int hi = min(nvec, lo + chunk);
  const int64_t first = static_cast<int64_t>(blockIdx.x / ranks) * groups;
  const int64_t stride = static_cast<int64_t>(gridDim.x / ranks) * groups;
  const float neg_inf = -__int_as_float(0x7F800000);
  constexpr int kHeld = kVecs > 0 ? kVecs : 1;
  Vec<T, kWidth> ahead[kHeld];  // the group's next row, loaded ahead
  if constexpr (kVecs > 0)
    load_row<T, kWidth, kVecs>(ahead, x, first + group, rows, d, lo, hi, t, row_threads);

  if constexpr (kCluster) {
    if (threadIdx.x == 0) {
      ex[0].init();
      ex[1].init();
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // every rank's barriers are initialised before any rank pushes
    cluster_arrive_relaxed();
    cluster_wait();
    if (first >= rows) return;  // the same in every CTA of the cluster
    // Exchange j carries row j - 1's sums and row j's maxima (exchange 0
    // the first row's maxima alone), so a row takes one exchange; it uses
    // ex[j & 1], whose barrier is then in phase (j >> 1) & 1.
    float f[kVecs][kWidth];  // x, then e in its place
    widen(ahead, f);
    load_row<T, kWidth, kVecs>(ahead, x, first + stride, rows, d, lo, hi, t, row_threads);
    float m = neg_inf;
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
      if (lo + t + k * row_threads < hi)
#pragma unroll
        for (int j = 0; j < kWidth; ++j) m = max_nan(m, f[k][j]);
    float row_max = ex[0].combine(0.0f, warp_reduce(m, MaxOp{}), ranks, rank, warps, 0).y;
    uint32_t j = 1;
    for (int64_t row = first; row < rows; row += stride, ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
        if (lo + t + k * row_threads < hi) {
#pragma unroll
          for (int i = 0; i < kWidth; ++i) {
            f[k][i] = expf(__fsub_rn(f[k][i], row_max));
            acc = __fadd_rn(acc, f[k][i]);
          }
        }
      const bool next = row + stride < rows;  // the same in every CTA of the cluster
      m = neg_inf;
      if (next) {
#pragma unroll
        for (int k = 0; k < kVecs; ++k)
          if (lo + t + k * row_threads < hi)
#pragma unroll
            for (int i = 0; i < kWidth; ++i) m = max_nan(m, gs::to_f32(ahead[k].e[i]));
      }
      const float2 sm = ex[j & 1].combine(warp_reduce(acc, AddOp{}), warp_reduce(m, MaxOp{}),
                                          ranks, rank, warps, (j >> 1) & 1);
      // after the last exchange every push to this CTA has landed; peers
      // stay until this CTA's pushes to them have too
      if (!next) cluster_arrive_relaxed();
      const float inv = row_inv(sm.x, rom, p, iters, pipelined);
      T* orow = out + row * d;
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const int v = lo + t + k * row_threads;
        if (v < hi) store_vec<T, kWidth>(orow, v, f[k], inv);
      }
      if (next) {
        widen(ahead, f);
        load_row<T, kWidth, kVecs>(ahead, x, row + 2 * stride, rows, d, lo, hi, t,
                                   row_threads);
        row_max = sm.y;
      }
    }
    cluster_wait();
  } else {
    // every thread of the block runs the same trips: a group past the last
    // row still reaches the barriers
    for (int64_t base = first; base < rows; base += stride) {
      const int64_t row = base + group;
      const bool live = row < rows;
      const T* xr = x + row * d;
      T* orow = out + row * d;
      float m = neg_inf;
      if constexpr (kVecs > 0) {
        float f[kVecs][kWidth];  // x, then e in its place
        widen(ahead, f);
        load_row<T, kWidth, kVecs>(ahead, x, row + stride, rows, d, lo, hi, t, row_threads);
#pragma unroll
        for (int k = 0; k < kVecs; ++k)
          if (live && t + k * row_threads < nvec)
#pragma unroll
            for (int j = 0; j < kWidth; ++j) m = max_nan(m, f[k][j]);
        m = across_warps(warp_reduce(m, MaxOp{}), part_max, warps, warp0, MaxOp{});
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kVecs; ++k)
          if (live && t + k * row_threads < nvec) {
#pragma unroll
            for (int j = 0; j < kWidth; ++j) {
              f[k][j] = expf(__fsub_rn(f[k][j], m));
              acc = __fadd_rn(acc, f[k][j]);
            }
          }
        const float s = across_warps(warp_reduce(acc, AddOp{}), part_sum, warps, warp0, AddOp{});
        if (!live) continue;  // the same in every thread of a group
        const float inv = row_inv(s, rom, p, iters, pipelined);
#pragma unroll
        for (int k = 0; k < kVecs; ++k) {
          const int v = t + k * row_threads;
          if (v < nvec) store_vec<T, kWidth>(orow, v, f[k], inv);
        }
      } else {
        if (live)
          for (int v = t; v < nvec; v += row_threads)
            m = vec_max(load_vec<T, kWidth>(xr, v), m);
        m = across_warps(warp_reduce(m, MaxOp{}), part_max, warps, warp0, MaxOp{});
        float acc = 0.0f;
        if (live)
          for (int v = t; v < nvec; v += row_threads) {
            const Vec<T, kWidth> xv = load_vec<T, kWidth>(xr, v);
#pragma unroll
            for (int j = 0; j < kWidth; ++j)
              acc = __fadd_rn(acc, expf(__fsub_rn(gs::to_f32(xv.e[j]), m)));
          }
        const float s = across_warps(warp_reduce(acc, AddOp{}), part_sum, warps, warp0, AddOp{});
        if (!live) continue;
        const float inv = row_inv(s, rom, p, iters, pipelined);
        for (int v = t; v < nvec; v += row_threads) {
          const Vec<T, kWidth> xv = load_vec<T, kWidth>(xr, v);
          float e[kWidth];
#pragma unroll
          for (int j = 0; j < kWidth; ++j) e[j] = expf(__fsub_rn(gs::to_f32(xv.e[j]), m));
          store_vec<T, kWidth>(orow, v, e, inv);
        }
      }
    }
  }
}

template <typename T>
using Kernel = void (*)(const T*, const float*, T*, int, int, int, int, int, int);

// The instance for (vector, vecs, cluster), or nullptr for one the plan
// never takes.  Block instances: vecs 0 (the loop), 1, 2, 4, 8, at most 32
// elements a thread (bf16 vectors stop at 4).  Cluster instances: 16-byte
// vectors at kClusterElements a thread only.
template <typename T>
Kernel<T> instance(int vector, int vecs, bool cluster) {
  constexpr int kVec = sizeof(uint4) / sizeof(T);
  constexpr int kClusterVecs = kClusterElements / kVec;
  if (cluster) {
    if (vector && vecs == kClusterVecs) return gs_softmax_kernel<T, kVec, kClusterVecs, true>;
    return nullptr;
  }
  if (vector) {
    switch (vecs) {
      case 0: return gs_softmax_kernel<T, kVec, 0, false>;
      case 1: return gs_softmax_kernel<T, kVec, 1, false>;
      case 2: return gs_softmax_kernel<T, kVec, 2, false>;
      case 4: return gs_softmax_kernel<T, kVec, 4, false>;
      case 8:
        if constexpr (kVec * 8 <= 32) return gs_softmax_kernel<T, kVec, 8, false>;
        return nullptr;
      default: return nullptr;
    }
  }
  switch (vecs) {
    case 0: return gs_softmax_kernel<T, 1, 0, false>;
    case 1: return gs_softmax_kernel<T, 1, 1, false>;
    case 2: return gs_softmax_kernel<T, 1, 2, false>;
    case 4: return gs_softmax_kernel<T, 1, 4, false>;
    case 8: return gs_softmax_kernel<T, 1, 8, false>;
    default: return nullptr;
  }
}

// The cluster launch's configuration: `grid` CTAs of `threads` in clusters of
// `cluster` along x.
void cluster_config(int grid, int threads, int cluster, cudaStream_t s, cudaLaunchConfig_t* cfg,
                    cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = 0;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Whether the plan is one the kernels take: whole warps a row, a block of at
// most its instance's threads, a cluster of 1..kMaxCluster CTAs of one row
// each, and a register plan whose threads x vectors cover the row (its
// chunk).
bool valid_plan(int d, int width, int vecs, int row_threads, int rows_per_block, int cluster,
                int grid) {
  const int threads = row_threads * rows_per_block;
  if (grid < 1 || row_threads < 32 || row_threads % 32 != 0 || rows_per_block < 1) return false;
  if (cluster > 0) {
    if (cluster > kMaxCluster || rows_per_block != 1 || threads > kMaxClusterThreads ||
        grid % cluster != 0)
      return false;
  } else if (threads > kMaxThreads) {
    return false;
  }
  const int parts = cluster > 0 ? cluster : 1;
  const int64_t chunk = (d / width + parts - 1) / parts;
  return vecs == 0 || static_cast<int64_t>(row_threads) * vecs >= chunk;
}

template <typename T>
int launch(const void* x, const void* rom, void* out, int rows, int d, int p, int iters,
           int pipelined, int vector, int vecs, int row_threads, int rows_per_block,
           int cluster, int grid, cudaStream_t s) {
  const Kernel<T> kernel = instance<T>(vector, vecs, cluster > 0);
  const int width = vector ? static_cast<int>(sizeof(uint4) / sizeof(T)) : 1;
  if (kernel == nullptr ||
      !valid_plan(d, width, vecs, row_threads, rows_per_block, cluster, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const float* romf = static_cast<const float*>(rom);
  T* outt = static_cast<T*>(out);
  if (cluster == 0) {
    kernel<<<grid, row_threads * rows_per_block, 0, s>>>(xt, romf, outt, rows, d, p, iters,
                                                          pipelined, row_threads);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(grid, row_threads, cluster, s, &cfg, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, xt, romf, outt, rows, d, p, iters,
                                             pipelined, row_threads);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error behind
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int vector, int vecs, int cluster, int threads, int* units) {
  const Kernel<T> kernel = instance<T>(vector, vecs, cluster > 0);
  const int limit = cluster > 0 ? kMaxClusterThreads : kMaxThreads;
  if (kernel == nullptr || threads < 32 || threads > limit || threads % 32 != 0 ||
      cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster == 0)
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(units, kernel, threads, 0));
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(cluster, threads, cluster, nullptr, &cfg, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(units, kernel, &cfg));
}

}  // namespace

// x, out: (rows, d) contiguous f32 or bf16 (is_bf16); rom: (2^p,) f32
// reciprocal table.  The launch plan (the wrapper's): vector (16-byte
// vectors: d a multiple of the width, x and out 16-byte aligned), vecs
// (vectors a thread holds; 0 the loop), row_threads (a multiple of 32),
// rows_per_block, cluster (0: a block instance; 1..8: the CTAs of a
// cluster instance that split a row, rows_per_block 1), grid >= 1 (a
// multiple of cluster).  Returns the launch's cudaError_t.
extern "C" int gs_softmax_launch(const void* x, const void* rom, void* out, int rows, int d,
                                 int p, int iters, int pipelined, int is_bf16, int vector,
                                 int vecs, int row_threads, int rows_per_block, int cluster,
                                 int grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, rom, out, rows, d, p, iters, pipelined, vector, vecs,
                                 row_threads, rows_per_block, cluster, grid, s);
  return launch<float>(x, rom, out, rows, d, p, iters, pipelined, vector, vecs, row_threads,
                       rows_per_block, cluster, grid, s);
}

// For a block instance (cluster 0): the blocks of `threads` threads one SM
// holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor); for a
// cluster instance: the clusters of `cluster` CTAs of `threads` threads the
// device holds at once (cudaOccupancyMaxActiveClusters), into *units, on the
// current device.  Returns its cudaError_t.
extern "C" int gs_softmax_occupancy(int is_bf16, int vector, int vecs, int cluster, int threads,
                                    int* units) {
  return is_bf16 ? occupancy<__nv_bfloat16>(vector, vecs, cluster, threads, units)
                 : occupancy<float>(vector, vecs, cluster, threads, units);
}
