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
// the ~20 flops per byte where the fp32 units would bind.  Below a few MB,
// where the L2 serves the bytes, the instructions an element issue bind.
//
// Every multiply and add of the peel and the iterations is __fmul_rn /
// __fadd_rn / __fsub_rn (gs_common.cuh), so each kernel agrees bit for bit
// with its plain PyTorch version (kernels/ref.py reciprocal, rsqrt).  The
// specials are selected after the datapath, as the reference's jnp.where
// chain selects them.
//
// Both kernels are instances of one grid-stride loop (vector_loop) with a
// per-vector operation (recip_vec, rsqrt_vec):
// * Each thread takes one 16-byte vector (4 f32 or 8 bf16) a trip, loaded
//   through the read-only path, and runs every element of it as an
//   independent chain: the feedback loop's trips each advance all of the
//   vector's pairs.  The next trip's vector is loaded before this one is
//   computed, so two loads a thread are in flight.  The host takes this
//   instance only when x and the outputs are 16-byte aligned, and otherwise
//   the same kernel at width 1; a vector launch's n % width tail runs at
//   width 1.
// * The grid is min(vectors / threads, SMs x resident blocks), from the
//   device's SM count and the instance's occupancy (the wrapper's plan), so
//   a block lives for the whole grid-stride loop.
// * The ROM is read straight from device memory through the read-only
//   cache, where the 2^p-entry table stays in each SM's L1: no copy, no
//   barrier, no shared memory.  On an H100 this was as fast as a shared
//   copy filled once a block at p 7 and 12, or faster (PERF.md, PR 22).
// * The operation (and rsqrt's mode) is a template parameter: each instance
//   stores only what it writes.
#include <cstdint>
#include <cstring>

#include "gs_common.cuh"

namespace {

constexpr int kThreads = 128;  // gs_elementwise.THREADS
constexpr unsigned kSignBit = 0x80000000u;
constexpr int kInfBits = 0x7F800000;
constexpr int kNanBits = 0x7FC00000;  // the canonical NaN torch and jnp write

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

// `iters` passes of `step` over kWidth independent (a, b) chains: feedback in
// a runtime loop, pipelined unrolled up to gs::kMaxPipelinedIters.
template <int kWidth, typename Step>
__device__ __forceinline__ void iterate(int iters, int pipelined, float (&a)[kWidth],
                                        float (&b)[kWidth], Step step) {
  if (pipelined) {
#pragma unroll
    for (int i = 0; i < gs::kMaxPipelinedIters; ++i)
      if (i < iters) {
#pragma unroll
        for (int j = 0; j < kWidth; ++j) step(a[j], b[j]);
      }
  } else {
#pragma unroll 1
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int j = 0; j < kWidth; ++j) step(a[j], b[j]);
    }
  }
}

// The grid-stride loop every kernel here runs over x's n elements: thread t
// takes the kWidth-element vectors t, t + stride, ..., loads the next before
// op(vector, v) computes and stores vector v, and a vector launch's last
// n % kWidth elements go one a thread at width 1.
template <int kWidth, typename T, typename Op>
__device__ __forceinline__ void vector_loop(const T* __restrict__ x, int64_t n, const Op& op) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t nvec = n / kWidth;
  Vec<T, kWidth> cur, nxt;
  if (first < nvec) cur = load_vec<T, kWidth>(x, first);
  for (int64_t v = first; v < nvec; v += stride) {
    if (v + stride < nvec) nxt = load_vec<T, kWidth>(x, v + stride);
    op(cur, v);
    cur = nxt;
  }
  const int64_t i = nvec * kWidth + first;
  if (kWidth > 1 && i < n) op(load_vec<T, 1>(x, i), i);
}

// -- recip ---------------------------------------------------------------------

struct RecipArgs {
  const float* table;  // the ROM, moved back by 127 * 2^p entries (recip_vec)
  int shift;           // 23 - p
  int iters;
  int pipelined;
};

// 1/x on the kWidth elements of `in`, each an independent chain.  Bit for
// bit the reference's arithmetic (ref.reciprocal, gs_common.cuh
// gs_recip_core), with few integer instructions:
// * se = x's sign and exponent bits, and m = x's bits ^ se ^ the exponent
//   field 127: the mantissa under exponent 0, in [1, 2);
// * the ROM index (bits >> (23 - p)) & (2^p - 1) is m's bits >> (23 - p)
//   less 127 * 2^p, the exponent field 127 above the index bits: the kernel
//   moves the table pointer back by 127 * 2^p entries once, and no element
//   pays for the mask;
// * 1/x = q * 2^(127 - e) with x's sign, q in (1/2, 1].  The scale's biased
//   exponent 254 - e lies in [0, 253] for e in [1, 254], so 0x7F000000 - se
//   is the scale with no clamp, and it carries x's sign: for x < 0 the
//   subtraction borrows into the sign bit (0x7F000000 - 0x80000000 -
//   (e << 23) = 0x80000000 | (254 - e) << 23).  A product with -s is the
//   product with s, rounded alike and negated: the reference's sign OR.
//   e = 254 gives the ±0 that pow2_from_biased(0) gives; at e = 253 the
//   product is the subnormal that the reference also rounds to;
// * bits 24-30 of the scale are all set only for e = 0 (0x7F000000 or
//   0xFF000000) and e = 255 (0xFF800000 or 0x7F800000): for e in [1, 254]
//   the scale's magnitude is at most 253 << 23.  So one test finds a zero,
//   subnormal, inf or NaN, and only a vector that holds one takes the
//   specials' branch, which applies them in the reference's order.
template <typename T, int kWidth>
__device__ __forceinline__ Vec<T, kWidth> recip_vec(const Vec<T, kWidth>& in,
                                                    const RecipArgs& a) {
  unsigned bits[kWidth];
  float q[kWidth], r[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    bits[j] = __float_as_uint(gs::to_f32(in.e[j]));
    const unsigned se = bits[j] & 0xFF800000u;
    const unsigned m = bits[j] ^ se ^ gs::kOneBits;
    q[j] = __ldg(a.table + (m >> a.shift));
    r[j] = __fmul_rn(__uint_as_float(m), q[j]);
  }
  iterate<kWidth>(a.iters, a.pipelined, q, r, [](float& qj, float& rj) {
    gs::recip_step(qj, rj);
  });
  float o[kWidth];
  bool special = false;
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    const unsigned scale = 0x7F000000u - (bits[j] & 0xFF800000u);
    special |= (~scale & 0x7F000000u) == 0;
    o[j] = __fmul_rn(q[j], __uint_as_float(scale));
  }
  if (special) {
#pragma unroll
    for (int j = 0; j < kWidth; ++j) {
      const unsigned e = (bits[j] >> 23) & gs::kExpMask;
      const unsigned mant = bits[j] & gs::kMantMask;
      const unsigned sign = bits[j] & kSignBit;
      if (e == 0) o[j] = __uint_as_float(sign | kInfBits);
      if (e == 255 && mant == 0) o[j] = __uint_as_float(sign);
      if (e == 255 && mant != 0) o[j] = __int_as_float(kNanBits);
    }
  }
  Vec<T, kWidth> out;
#pragma unroll
  for (int j = 0; j < kWidth; ++j) out.e[j] = gs::from_f32<T>(o[j]);
  return out;
}

template <typename T>
struct RecipOp {
  T* out;
  RecipArgs a;

  template <int kWidth>
  __device__ __forceinline__ void operator()(const Vec<T, kWidth>& in, int64_t v) const {
    store_vec<T, kWidth>(out, v, recip_vec(in, a));
  }
};

// -- rsqrt / sqrt --------------------------------------------------------------

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
  iterate<kWidth>(a.iters, a.pipelined, g, h, [](float& gj, float& hj) {
    gs::rsqrt_step(gj, hj);
  });
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

template <typename T, int kMode>
struct RsqrtOp {
  const float* table;
  T* out0;
  T* out1;
  RsqrtArgs a;

  template <int kWidth>
  __device__ __forceinline__ void operator()(const Vec<T, kWidth>& in, int64_t v) const {
    Vec<T, kWidth> o0, o1;
    rsqrt_vec<kMode>(in, table, a, o0, o1);
    store_vec<T, kWidth>(out0, v, o0);
    if constexpr (kMode == 2) store_vec<T, kWidth>(out1, v, o1);
  }
};

// -- the kernels ---------------------------------------------------------------

// Every instance takes the same arguments, so that one table (instance)
// serves the launch and the occupancy query; gs_recip_kernel ignores out1
// and rsqrt_scale.
template <typename T, int kWidth>
__global__ void __launch_bounds__(kThreads)
gs_recip_kernel(const T* __restrict__ x, const float* __restrict__ rom_g,
                T* __restrict__ out, T* __restrict__, int64_t n, int p, int iters,
                int pipelined, float) {
  // rom_g - 127 * 2^p entries, as an address: it lies outside the table
  const auto base = reinterpret_cast<uintptr_t>(rom_g) - (uintptr_t{127} << p) * sizeof(float);
  const RecipArgs args{reinterpret_cast<const float*>(base), 23 - p, iters, pipelined};
  vector_loop<kWidth>(x, n, RecipOp<T>{out, args});
}

template <typename T, int kMode, int kWidth>
__global__ void __launch_bounds__(kThreads)
gs_rsqrt_kernel(const T* __restrict__ x, const float* __restrict__ rom_g,
                T* __restrict__ out0, T* __restrict__ out1, int64_t n, int p, int iters,
                int pipelined, float rsqrt_scale) {
  const RsqrtArgs args{static_cast<float>((1 << p) - 1), iters, pipelined, rsqrt_scale};
  vector_loop<kWidth>(x, n, RsqrtOp<T, kMode>{rom_g, out0, out1, args});
}

template <typename T>
using Kernel = void (*)(const T*, const float*, T*, T*, int64_t, int, int, int, float);

// The instance for (op, vector), or nullptr for an op out of range.  op: 0
// recip, 1 rsqrt, 2 sqrt, 3 sqrt_both (gs_elementwise.OPS); vector: 16-byte
// vectors (4 f32 or 8 bf16 a thread), else width 1.
template <typename T>
Kernel<T> instance(int op, int vector) {
  constexpr int kVec = sizeof(uint4) / sizeof(T);
  switch (op * 2 + (vector ? 1 : 0)) {
    case 0: return gs_recip_kernel<T, 1>;
    case 1: return gs_recip_kernel<T, kVec>;
    case 2: return gs_rsqrt_kernel<T, 0, 1>;
    case 3: return gs_rsqrt_kernel<T, 0, kVec>;
    case 4: return gs_rsqrt_kernel<T, 1, 1>;
    case 5: return gs_rsqrt_kernel<T, 1, kVec>;
    case 6: return gs_rsqrt_kernel<T, 2, 1>;
    case 7: return gs_rsqrt_kernel<T, 2, kVec>;
    default: return nullptr;
  }
}

template <typename T>
int launch(int op, const void* x, const void* rom, void* out0, void* out1, long long n, int p,
           int iters, int pipelined, float rsqrt_scale, int vector, int grid,
           cudaStream_t s) {
  const Kernel<T> kernel = instance<T>(op, vector);
  if (kernel == nullptr || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(rom), static_cast<T*>(out0),
      static_cast<T*>(out1), n, p, iters, pipelined, rsqrt_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int op, int vector, int* blocks) {
  const Kernel<T> kernel = instance<T>(op, vector);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kThreads, 0));
}

}  // namespace

// op: 0 recip (rom: the (2^p,) f32 reciprocal table; out0), 1 rsqrt, 2 sqrt,
// 3 sqrt and rsqrt -> out0, out1 (rom: the rsqrt table; rsqrt_scale =
// f32(2^p / 3)).  x and the outputs: n >= 1 contiguous f32 or bf16
// (is_bf16); out1 is unused but for op 3.  vector: x and every output are
// 16-byte aligned and the kernel moves 16-byte vectors; grid: blocks of
// kThreads (the wrapper's plan).  Returns cudaGetLastError().
extern "C" int gs_elementwise_launch(int op, const void* x, const void* rom, void* out0,
                                     void* out1, long long n, int p, int iters, int pipelined,
                                     float rsqrt_scale, int is_bf16, int vector, int grid,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(op, x, rom, out0, out1, n, p, iters, pipelined, rsqrt_scale,
                                 vector, grid, s);
  return launch<float>(op, x, rom, out0, out1, n, p, iters, pipelined, rsqrt_scale, vector,
                       grid, s);
}

// The blocks of the (op, is_bf16, vector) instance that one SM holds at
// once, into *blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the
// current device).  Returns its cudaError_t.
extern "C" int gs_elementwise_occupancy(int op, int is_bf16, int vector, int* blocks) {
  return is_bf16 ? occupancy<__nv_bfloat16>(op, vector, blocks)
                 : occupancy<float>(op, vector, blocks);
}
