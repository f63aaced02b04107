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
// latency of one launch and one dependent chain (x, the reduction, one ROM
// entry, the store), not by bytes.
//
// Design (the launch plan is the wrapper's, kernels/gs_rmsnorm.py):
// * A row belongs to a group of row_threads threads (a multiple of 32); a
//   block holds blockDim / row_threads groups, one row each, and walks the
//   rows in a grid-stride loop, the grid sized to the card.
// * The row in registers, read once: thread t of a group holds the kVecs
//   vectors t, t + row_threads, ... of its row (kWidth elements each: one
//   16-byte vector, 4 f32 or 8 bf16, when d is a multiple of the width and
//   every pointer is 16-byte aligned, else one element), squares and sums
//   them, and after the reduction writes x * inv * gain from the same
//   registers.  gain (f32, float4 loads at both dtypes) is loaded once a
//   block, before the first row, and stays in registers for every row.
//   Which d go which way (the wrapper's row_plan, at most 32 elements and
//   512 threads a row): up to 16384 at 16-byte vectors (f32 kVecs 1-8, bf16
//   1-4) and 4096 at one element (kVecs 1-8) hold the row; wider rows take
//   the kVecs = 0 instance, a loop that reads x a second time for the
//   output (from the L2 at these sizes).
// * The reduction: fp32 products summed in each thread, warp shuffles, and
//   for a row of several warps one barrier: each warp's lane 0 writes its
//   partial, then every thread adds its row's partials in warp order itself
//   (the same order in every thread, so every thread gets the same sum) and
//   computes the row's Goldschmidt rsqrt_positive(ms + eps).  The partials
//   alternate between two buffers from one row to the next, so a warp that
//   runs ahead to the next row never overwrites partials another warp is
//   still reading: one barrier a row, none for a row of one warp.  Shared
//   memory holds those partials and nothing else.
// * One ROM entry a row, read from the table in device memory through the
//   read-only cache (no shared-memory copy of the 2^p-entry table).
// * Every multiply and add of the epilogue is __fmul_rn / __fadd_rn: ms =
//   sum * (1/d), inv = rsqrt_positive(ms + eps), y = (x * inv) * gain, as
//   the plain version (kernels/ref.py rmsnorm) orders them; the sum of
//   squares takes another order than torch.sum.
#include <cstdint>
#include <cstring>

#include "gs_common.cuh"

namespace {

constexpr int kMaxThreads = 512;  // gs_rmsnorm.MAX_THREADS
constexpr int kMaxWarps = kMaxThreads / 32;

// kWidth elements of T, one 16-byte vector when kWidth > 1.
template <typename T, int kWidth>
struct Vec {
  alignas(sizeof(T) * kWidth) T e[kWidth];
};

template <typename T, int kWidth>
__device__ __forceinline__ Vec<T, kWidth> load_vec(const T* __restrict__ x, int64_t v) {
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

template <typename T, int kWidth>
__device__ __forceinline__ void store_vec(T* __restrict__ out, int64_t v,
                                          const Vec<T, kWidth>& val) {
  if constexpr (kWidth == 1) {
    out[v] = val.e[0];
  } else {
    uint4 raw;
    memcpy(&raw, &val, sizeof(raw));
    reinterpret_cast<uint4*>(out)[v] = raw;
  }
}

// gain's kWidth f32 elements of vector v: float4 loads for a 16-byte x vector.
template <int kWidth>
__device__ __forceinline__ void load_gain(const float* __restrict__ gain, int v,
                                          float (&g)[kWidth]) {
  if constexpr (kWidth == 1) {
    g[0] = __ldg(gain + v);
  } else {
#pragma unroll
    for (int h = 0; h < kWidth / 4; ++h) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(gain) + v * (kWidth / 4) + h);
      g[4 * h] = f.x;
      g[4 * h + 1] = f.y;
      g[4 * h + 2] = f.z;
      g[4 * h + 3] = f.w;
    }
  }
}

template <typename T, int kWidth>
__device__ __forceinline__ float sum_squares(const Vec<T, kWidth>& v, float acc) {
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    const float f = gs::to_f32(v.e[j]);
    acc = fmaf(f, f, acc);
  }
  return acc;
}

template <typename T, int kWidth>
__device__ __forceinline__ Vec<T, kWidth> scale(const Vec<T, kWidth>& v, float inv,
                                                const float (&g)[kWidth]) {
  Vec<T, kWidth> out;
#pragma unroll
  for (int j = 0; j < kWidth; ++j)
    out.e[j] = gs::from_f32<T>(__fmul_rn(__fmul_rn(gs::to_f32(v.e[j]), inv), g[j]));
  return out;
}

// The row's sum of the threads' `acc`: warp shuffles, then, for a row of
// `warps` > 1 warps, the partials in part[buf] after one barrier, added in
// warp order by every thread.  `warps` is the same in every thread of the
// block, so the barrier is reached by all of them or by none.
__device__ __forceinline__ float row_sum(float acc, float* part, int warps, int warp0) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (warps == 1) return acc;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  acc = part[warp0];
  for (int w = 1; w < warps; ++w) acc += part[warp0 + w];
  return acc;
}

// kVecs > 0: the row in registers (kVecs vectors a thread); kVecs == 0: the
// looping instance for rows wider than the register plan.
template <typename T, int kWidth, int kVecs>
__global__ void __launch_bounds__(kMaxThreads)
gs_rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ gain,
                  const float* __restrict__ rom_g, T* __restrict__ out,
                  float* __restrict__ inv_out, int rows, int d, float inv_d, float eps,
                  int p, int iters, int pipelined, float rsqrt_scale, int row_threads) {
  __shared__ float part[2][kMaxWarps];  // each warp's partial, two rows in turn
  const int groups = blockDim.x / row_threads;  // rows a block
  const int group = threadIdx.x / row_threads;
  const int t = threadIdx.x - group * row_threads;
  const int warps = row_threads >> 5;  // warps a row
  const int nvec = d / kWidth;
  const gs::Rom rom{rom_g, p, iters, pipelined, rsqrt_scale};

  float g[kVecs > 0 ? kVecs : 1][kWidth];
  if constexpr (kVecs > 0) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
      if (t + k * row_threads < nvec) load_gain<kWidth>(gain, t + k * row_threads, g[k]);
  }
  int buf = 0;
  // every thread of the block runs the same trips: a group past the last
  // row still reaches the barrier
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * groups; base < rows;
       base += static_cast<int64_t>(gridDim.x) * groups, buf ^= 1) {
    const int64_t row = base + group;
    const bool live = row < rows;
    const T* xr = x + row * d;
    float acc = 0.0f;
    Vec<T, kWidth> xv[kVecs > 0 ? kVecs : 1];
    if constexpr (kVecs > 0) {
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
        if (live && t + k * row_threads < nvec)
          xv[k] = load_vec<T, kWidth>(xr, t + k * row_threads);
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
        if (live && t + k * row_threads < nvec) acc = sum_squares(xv[k], acc);
    } else {
      if (live)
        for (int v = t; v < nvec; v += row_threads)
          acc = sum_squares(load_vec<T, kWidth>(xr, v), acc);
    }
    const float sum = row_sum(acc, part[buf], warps, group * warps);
    const float ms = __fmul_rn(sum, inv_d);
    const float inv = gs::rsqrt_positive<true>(__fadd_rn(ms, eps), rom);
    if (!live) continue;
    if (inv_out != nullptr && t == 0) inv_out[row] = inv;
    T* orow = out + row * d;
    if constexpr (kVecs > 0) {
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
        if (t + k * row_threads < nvec)
          store_vec<T, kWidth>(orow, t + k * row_threads, scale(xv[k], inv, g[k]));
    } else {
      for (int v = t; v < nvec; v += row_threads) {
        float gv[kWidth];
        load_gain<kWidth>(gain, v, gv);
        store_vec<T, kWidth>(orow, v, scale(load_vec<T, kWidth>(xr, v), inv, gv));
      }
    }
  }
}

template <typename T>
using Kernel = void (*)(const T*, const float*, const float*, T*, float*, int, int, float,
                        float, int, int, int, float, int);

// The instance for (vector, vecs), or nullptr for a pair the plan never
// takes: vecs 0 (the loop), 1, 2, 4, 8, at most 32 elements a thread (bf16
// vectors stop at 4).
template <typename T>
Kernel<T> instance(int vector, int vecs) {
  constexpr int kVec = sizeof(uint4) / sizeof(T);
  if (vector) {
    switch (vecs) {
      case 0: return gs_rmsnorm_kernel<T, kVec, 0>;
      case 1: return gs_rmsnorm_kernel<T, kVec, 1>;
      case 2: return gs_rmsnorm_kernel<T, kVec, 2>;
      case 4: return gs_rmsnorm_kernel<T, kVec, 4>;
      case 8:
        if constexpr (kVec * 8 <= 32) return gs_rmsnorm_kernel<T, kVec, 8>;
        return nullptr;
      default: return nullptr;
    }
  }
  switch (vecs) {
    case 0: return gs_rmsnorm_kernel<T, 1, 0>;
    case 1: return gs_rmsnorm_kernel<T, 1, 1>;
    case 2: return gs_rmsnorm_kernel<T, 1, 2>;
    case 4: return gs_rmsnorm_kernel<T, 1, 4>;
    case 8: return gs_rmsnorm_kernel<T, 1, 8>;
    default: return nullptr;
  }
}

template <typename T>
int launch(const void* x, const void* gain, const void* rom, void* out, void* inv_out,
           int rows, int d, float inv_d, float eps, int p, int iters, int pipelined,
           float rsqrt_scale, int vector, int vecs, int row_threads, int rows_per_block,
           int grid, cudaStream_t s) {
  const Kernel<T> kernel = instance<T>(vector, vecs);
  const int threads = row_threads * rows_per_block;
  if (kernel == nullptr || grid < 1 || row_threads < 32 || row_threads % 32 != 0 ||
      rows_per_block < 1 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(gain),
      static_cast<const float*>(rom), static_cast<T*>(out), static_cast<float*>(inv_out),
      rows, d, inv_d, eps, p, iters, pipelined, rsqrt_scale, row_threads);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int vector, int vecs, int threads, int* blocks) {
  const Kernel<T> kernel = instance<T>(vector, vecs);
  if (kernel == nullptr || threads < 32 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, 0));
}

}  // namespace

// x, out: (rows, d) f32 or bf16 (is_bf16); gain: (d,) f32; rom: (2^p,) f32
// rsqrt table; inv_out: (rows,) f32 or null.  The launch plan (the
// wrapper's): vector (16-byte vectors: d a multiple of the width, x, gain
// and out 16-byte aligned), vecs (vectors a thread holds; 0 the loop),
// row_threads (a multiple of 32), rows_per_block, grid >= 1.  Returns
// cudaGetLastError().
extern "C" int gs_rmsnorm_launch(const void* x, const void* gain, const void* rom,
                                 void* out, void* inv_out, int rows, int d,
                                 float inv_d, float eps, int p, int iters,
                                 int pipelined, float rsqrt_scale, int is_bf16, int vector,
                                 int vecs, int row_threads, int rows_per_block, int grid,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, gain, rom, out, inv_out, rows, d, inv_d, eps, p, iters,
                                 pipelined, rsqrt_scale, vector, vecs, row_threads,
                                 rows_per_block, grid, s);
  return launch<float>(x, gain, rom, out, inv_out, rows, d, inv_d, eps, p, iters, pipelined,
                       rsqrt_scale, vector, vecs, row_threads, rows_per_block, grid, s);
}

// The blocks of `threads` threads of the (is_bf16, vector, vecs) instance
// that one SM holds at once, into *blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current device).
// Returns its cudaError_t.
extern "C" int gs_rmsnorm_occupancy(int is_bf16, int vector, int vecs, int threads,
                                    int* blocks) {
  return is_bf16 ? occupancy<__nv_bfloat16>(vector, vecs, threads, blocks)
                 : occupancy<float>(vector, vecs, threads, blocks);
}
