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
// Every multiply and add of the peel and the iterations is __fmul_rn /
// __fadd_rn (gs_common.cuh), so each kernel agrees bit for bit with its
// plain PyTorch version (kernels/ref.py reciprocal, rsqrt).  The specials
// are selected after the datapath, as the reference's jnp.where chain
// selects them.
//
// gs_recip_kernel: one element a thread in a grid-stride pass of 256-thread
// blocks, at most a few waves over the 132 SMs; each block stages the
// 2^p-entry f32 ROM in shared memory and reads it by index (the TPU's
// one-hot matmul).
//
// gs_rsqrt_kernel, redesigned for Hopper:
// * Each thread takes one 16-byte vector (4 f32 or 8 bf16) a trip, loaded
//   through the read-only path, and runs every element of it as an
//   independent chain: the feedback loop's trips each advance all of the
//   vector's (g, h) pairs.  The next trip's vector is loaded before this
//   one is computed, so two loads a thread are in flight.  The host takes
//   this instance only when x and the outputs are 16-byte aligned, and
//   otherwise the same kernel at width 1.
// * The grid is min(vectors / threads, SMs x resident blocks), from the
//   device's SM count and the instance's occupancy (the wrapper's plan), so
//   a block lives for the whole grid-stride loop.
// * The ROM is read straight from device memory through the read-only
//   cache, where the 2^p-entry table stays in each SM's L1: no copy, no
//   barrier, no shared memory.  On an H100 this was as fast as a shared
//   copy filled once a block at p 7 and 12, or faster (PERF.md, PR 22).
// * mode is a template parameter: each instance stores only what it writes.
#include <cstdint>
#include <cstring>

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

// -- gs_rsqrt_kernel -----------------------------------------------------------

constexpr int kRsqrtThreads = 128;  // gs_elementwise.RSQRT_THREADS

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

struct RsqrtArgs {
  float last;         // 2^p - 1, the largest ROM index
  int iters;
  int pipelined;
  float rsqrt_scale;  // f32(2^p / 3): the ROM's bucket index scale
};

// The coupled iteration on the kWidth elements of `in`, each an independent
// chain; out0 (and, in mode 2, out1) get the mode's outputs.  Bit for bit
// the reference's arithmetic (ref.rsqrt, gs_common.cuh gs_rsqrt_core),
// with fewer integer and conversion instructions:
// * m is x's mantissa under the exponent field 127 for an even E = e - 127
//   (bit 23 of x set) and 128 for an odd one: m or exactly 2m in [1, 4);
// * the ROM index floor((m - 1) * scale), clamped to 2^p - 1, is the low
//   bits of a round-down add of 2^23 to the product clamped as a float
//   (the bound is an integer, so clamping first changes nothing);
// * sqrt = g * 2^floor(E/2), rsqrt = 2h * 2^-floor(E/2) = h * 2^(1 -
//   floor(E/2)): the scales' biased exponents are (e + 127) >> 1 and
//   (384 - e) >> 1, in [63, 192] for every e, and a power of two moves no
//   rounding of a normal result;
// * a vector that holds an input other than a positive normal number takes
//   the specials' branch, in the reference's order.
template <int kMode, typename T, int kWidth>
__device__ __forceinline__ void rsqrt_vec(const Vec<T, kWidth>& in,
                                          const float* __restrict__ table,
                                          const RsqrtArgs& a, Vec<T, kWidth>& out0,
                                          Vec<T, kWidth>& out1) {
  unsigned bits[kWidth];
  float g[kWidth], h[kWidth];
  bool special = false;
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    bits[j] = __float_as_uint(gs::to_f32(in.e[j]));
    const float m = __uint_as_float(((bits[j] & 0x00FFFFFFu) ^ 0x00800000u) + 0x3F800000u);
    const float v = fminf(__fmul_rn(__fsub_rn(m, 1.0f), a.rsqrt_scale), a.last);
    const int idx = __float_as_int(__fadd_rd(v, 8388608.0f)) & gs::kMantMask;
    const float y0 = __ldg(table + idx);
    g[j] = __fmul_rn(m, y0);
    h[j] = __fmul_rn(0.5f, y0);
    special |= bits[j] - 0x00800000u >= 0x7F000000u;
  }
  if (a.pipelined) {
#pragma unroll
    for (int i = 0; i < gs::kMaxPipelinedIters; ++i)
      if (i < a.iters) {
#pragma unroll
        for (int j = 0; j < kWidth; ++j) gs::rsqrt_step(g[j], h[j]);
      }
  } else {
#pragma unroll 1
    for (int i = 0; i < a.iters; ++i) {
#pragma unroll
      for (int j = 0; j < kWidth; ++j) gs::rsqrt_step(g[j], h[j]);
    }
  }
  float rs[kWidth], sq[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    const unsigned e = bits[j] >> 23;  // the biased exponent, x >= 0
    rs[j] = __fmul_rn(h[j], __uint_as_float(((384u - e) << 22) & 0xFF800000u));
    sq[j] = __fmul_rn(g[j], __uint_as_float(((e + 127u) << 22) & 0xFF800000u));
  }
  if (special) {
#pragma unroll
    for (int j = 0; j < kWidth; ++j) {
      const unsigned e = (bits[j] >> 23) & gs::kExpMask;
      const unsigned mant = bits[j] & gs::kMantMask;
      if (e == 0) {
        rs[j] = __int_as_float(kInfBits);
        sq[j] = 0.0f;
      }
      if (e == 255 && mant == 0) {
        rs[j] = 0.0f;
        sq[j] = __int_as_float(kInfBits);
      }
      if ((e == 255 && mant != 0) || __uint_as_float(bits[j]) < 0.0f)
        rs[j] = sq[j] = __int_as_float(kNanBits);
    }
  }
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    out0.e[j] = gs::from_f32<T>(kMode == 0 ? rs[j] : sq[j]);
    if constexpr (kMode == 2) out1.e[j] = gs::from_f32<T>(rs[j]);
  }
}

template <typename T, int kMode, int kWidth>
__global__ void __launch_bounds__(kRsqrtThreads)
gs_rsqrt_kernel(const T* __restrict__ x, const float* __restrict__ rom_g,
                T* __restrict__ out0, T* __restrict__ out1, int64_t n, int p, int iters,
                int pipelined, float rsqrt_scale) {
  const RsqrtArgs args{static_cast<float>((1 << p) - 1), iters, pipelined, rsqrt_scale};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRsqrtThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRsqrtThreads + threadIdx.x;
  const int64_t nvec = n / kWidth;
  Vec<T, kWidth> cur, nxt, o0, o1;
  if (first < nvec) cur = load_vec<T, kWidth>(x, first);
  for (int64_t v = first; v < nvec; v += stride) {
    if (v + stride < nvec) nxt = load_vec<T, kWidth>(x, v + stride);
    rsqrt_vec<kMode>(cur, rom_g, args, o0, o1);
    store_vec<T, kWidth>(out0, v, o0);
    if constexpr (kMode == 2) store_vec<T, kWidth>(out1, v, o1);
    cur = nxt;
  }
  // the n % kWidth elements after the last whole vector
  const int64_t i = nvec * kWidth + first;
  if (kWidth > 1 && i < n) {
    Vec<T, 1> t0, t1;
    rsqrt_vec<kMode>(load_vec<T, 1>(x, i), rom_g, args, t0, t1);
    store_vec<T, 1>(out0, i, t0);
    if constexpr (kMode == 2) store_vec<T, 1>(out1, i, t1);
  }
}

template <typename T>
using RsqrtKernel = void (*)(const T*, const float*, T*, T*, int64_t, int, int, int, float);

// The instance for (mode, vector), or nullptr for a mode out of range.
// vector: 16-byte vectors (4 f32 or 8 bf16 a thread), else width 1.
template <typename T>
RsqrtKernel<T> rsqrt_instance(int mode, int vector) {
  constexpr int kVec = sizeof(uint4) / sizeof(T);
  switch (mode * 2 + (vector ? 1 : 0)) {
    case 0: return gs_rsqrt_kernel<T, 0, 1>;
    case 1: return gs_rsqrt_kernel<T, 0, kVec>;
    case 2: return gs_rsqrt_kernel<T, 1, 1>;
    case 3: return gs_rsqrt_kernel<T, 1, kVec>;
    case 4: return gs_rsqrt_kernel<T, 2, 1>;
    case 5: return gs_rsqrt_kernel<T, 2, kVec>;
    default: return nullptr;
  }
}

template <typename T>
int rsqrt_launch(const void* x, const void* rom, void* out0, void* out1, long long n, int p,
                 int iters, int pipelined, float rsqrt_scale, int mode, int vector, int grid,
                 cudaStream_t s) {
  const RsqrtKernel<T> kernel = rsqrt_instance<T>(mode, vector);
  if (kernel == nullptr || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, kRsqrtThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(rom), static_cast<T*>(out0),
      static_cast<T*>(out1), n, p, iters, pipelined, rsqrt_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rsqrt_occupancy(int mode, int vector, int* blocks) {
  const RsqrtKernel<T> kernel = rsqrt_instance<T>(mode, vector);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kRsqrtThreads, 0));
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

// x, out0, out1: n >= 1 contiguous f32 or bf16 (is_bf16); rom: (2^p,) f32
// rsqrt table; rsqrt_scale = f32(2^p / 3); mode 0 rsqrt ->
// out0, 1 sqrt -> out0, 2 sqrt -> out0 and rsqrt -> out1 (out1 is unused
// otherwise).  vector: x, out0 and out1 are 16-byte aligned and the kernel
// moves 16-byte vectors; grid: blocks of kRsqrtThreads (the wrapper's plan).
// Returns cudaGetLastError().
extern "C" int gs_rsqrt_launch(const void* x, const void* rom, void* out0, void* out1,
                               long long n, int p, int iters, int pipelined,
                               float rsqrt_scale, int mode, int is_bf16, int vector, int grid,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return rsqrt_launch<__nv_bfloat16>(x, rom, out0, out1, n, p, iters, pipelined,
                                       rsqrt_scale, mode, vector, grid, s);
  return rsqrt_launch<float>(x, rom, out0, out1, n, p, iters, pipelined, rsqrt_scale, mode,
                             vector, grid, s);
}

// The blocks of the (mode, is_bf16, vector) instance of gs_rsqrt_kernel that
// one SM holds at once, into *blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current device).
// Returns its cudaError_t.
extern "C" int gs_rsqrt_occupancy(int mode, int is_bf16, int vector, int* blocks) {
  return is_bf16 ? rsqrt_occupancy<__nv_bfloat16>(mode, vector, blocks)
                 : rsqrt_occupancy<float>(mode, vector, blocks);
}
