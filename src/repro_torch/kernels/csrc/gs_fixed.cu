// Fixed-point Goldschmidt reciprocal over int8 operands, for sm_90a.
//
// Replaces: src/repro/kernels/gs_fixed.py::gs_fixed_recip (the pallas_call
// over _recip_kernel; gs_fixed_softmax is gs_fixed_softmax.cu,
// gs_fixed_rmsnorm is gs_fixed_rmsnorm.cu).  1/(x * scale) elementwise for
// int8 x of any shape, flattened by the wrapper, f32 out: |x| clamped to at
// least 1 and normalized by msb32 (m = |x| * 2^-e in [1, 2), e in 0..7), the
// fixed divide with n = 1 seeded by the recip ROM word of m
// (gsf::divide, both variants, Mitchell passes included), then
// (q * 2^-F * 2^-e) * (1/scale), the sign restored, x == 0 -> +inf.
//
// The float arithmetic is __fmul_rn in the plain version's order
// (kernels/ref.py fixed_recip), and 1/scale is __frcp_rn of the one-element
// scale operand: correctly rounded, as torch's 1.0 / scale and the
// reference's 1.0 / jnp.asarray(scale) are.  So the kernel agrees with its
// plain version bit for bit, and a call is one launch.
//
// Bound on this card: device memory.  An element reads 1 byte and writes 4:
// at (65536, 128) 8.4 MB of int8 and 33.6 MB of f32, 12.52 us at 3.35 TB/s.
// At the (256, 128) benchmark shape a launch moves 164 KB and is bound by
// the launch and one dependent chain.  The datapath is a few dozen integer
// instructions an element, below the bytes' time at any shape.
//
// Design (the launch plan is the wrapper's, kernels/gs_fixed.py
// recip_launch):
// * A lane takes 32-bit words of four codes (when n >= 4, x is 4-byte and
//   out 16-byte aligned) and writes each word's four results as one float4,
//   a streaming store (the kernel never reads out back).  A warp's lanes
//   take consecutive words, so each load instruction moves 128 contiguous
//   bytes and each store 512.  A launch's n % 4 tail, and operands that are
//   not aligned, run one code a lane (the kWidth = 1 instance).
// * kWords words a lane in flight (1 or 4, a template parameter the
//   wrapper picks by size: 4 when its trips fill two waves of resident
//   blocks, as at (65536, 128), else 1, as at (256, 128)), and the next
//   trip's words loaded before this trip's are computed.  The grid is
//   min(words / (threads * kWords), SMs x resident blocks) from the
//   instance's occupancy, so a block lives for the whole grid-stride loop.
//   The words of a trip are unrolled: a loop over them, one copy of the
//   datapath, ran 12-15% slower at (65536, 128) on an H100.
// * Every code runs the datapath in its lane; the codes of a word are four
//   independent chains whose passes advance together.  The ROM word of each
//   code is read through the read-only cache from device memory, from the
//   words an int8 code can reach: a magnitude has at most 7 significant
//   bits, so for p >= 6 its index is j << (p - 6) with j < 64, and the
//   wrapper passes words[j << (p - 6)] (all 2^p words for p < 6), 256
//   bytes at any p.  Read from the whole ROM, the 64 words at p 12 lie in
//   64 lines of 16 KB, and (256, 128) took 7% longer than at p 8 on an
//   H100; from the 64 words, 1%.  No shared memory, no barrier.
#include <cstdint>

#include "gs_fixed_common.cuh"

namespace {

constexpr int kThreads = 128;  // gs_fixed.RECIP_THREADS
constexpr int kWordCodes = 4;  // int8 codes in a 32-bit word
constexpr int kInfBits = 0x7F800000;

// kWidth codes as one register: a word of four codes, or one code
// sign-extended.
template <int kWidth>
__device__ __forceinline__ uint32_t load_codes(const int8_t* __restrict__ x, int64_t v) {
  static_assert(kWidth == 1 || kWidth == kWordCodes, "one code or one 32-bit word");
  if constexpr (kWidth == 1) {
    return static_cast<uint32_t>(static_cast<int>(__ldg(x + v)));
  } else {
    return __ldg(reinterpret_cast<const uint32_t*>(x) + v);
  }
}

// Code j of a register load_codes filled.
template <int kWidth>
__device__ __forceinline__ int code(uint32_t w, int j) {
  if constexpr (kWidth == 1) {
    return static_cast<int>(w);
  } else {
    return static_cast<int8_t>(w >> (8 * j));
  }
}

// 1/(c * scale) for each of a register's kWidth codes c into r, inv_s =
// 1/scale: each code's m and ROM word, the fixed divide of the kWidth chains
// side by side (gsf::divide<kWidth>), then (q * 2^-F * 2^-e) * inv_s.
// q * 2^-F * 2^-e is one multiply by 2^-(F + e): both scalings are exact
// (q >= 1 and F + e <= 37 keep every product normal), so it equals the
// plain version's two.
template <int kWidth>
__device__ __forceinline__ void recip_codes(uint32_t w, float inv_s, const gsf::Datapath& dp,
                                            float (&r)[kWidth]) {
  const uint32_t one = 1u << dp.F;
  const int rom_shift = max(dp.p - 6, 0);  // dp.words holds every 2^(p - 6)th ROM word
  uint32_t ones[kWidth], m[kWidth], k1[kWidth], e[kWidth], q[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    const uint32_t a = static_cast<uint32_t>(max(abs(code<kWidth>(w, j)), 1));
    e[j] = gsf::msb32(a);  // 0..7
    m[j] = a << (dp.F - e[j]);  // m in [1, 2)
    const uint32_t idx = min((m[j] - one) >> (dp.F - dp.p), (1u << dp.p) - 1u);
    k1[j] = __ldg(dp.words + (idx >> rom_shift));
    ones[j] = one;
  }
  gsf::divide<kWidth>(ones, m, k1, dp, q);
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    const int c = code<kWidth>(w, j);
    const float pow2 = __int_as_float((127 - dp.F - static_cast<int>(e[j])) << 23);
    const float mag = __fmul_rn(__fmul_rn(__uint2float_rn(q[j]), pow2), inv_s);
    r[j] = c == 0 ? __int_as_float(kInfBits) : (c < 0 ? -mag : mag);
  }
}

// out of vector v: a float4 for a word, one f32 for a code, as streaming
// stores.
template <int kWidth>
__device__ __forceinline__ void store_out(float* __restrict__ out, int64_t v,
                                          const float (&r)[kWidth]) {
  if constexpr (kWidth == 1) {
    __stcs(out + v, r[0]);
  } else {
    __stcs(reinterpret_cast<float4*>(out) + v, make_float4(r[0], r[1], r[2], r[3]));
  }
}

// A trip's kWords vectors of thread t: base + t + k * kThreads.
template <int kWidth, int kWords>
__device__ __forceinline__ void load_trip(uint32_t (&w)[kWords], const int8_t* __restrict__ x,
                                          int64_t base, int64_t nvec) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int64_t v = base + k * kThreads;
    if (v < nvec) w[k] = load_codes<kWidth>(x, v);
  }
}

template <int kWidth, int kWords>
__global__ void __launch_bounds__(kThreads)
gs_fixed_recip_kernel(const int8_t* __restrict__ x, const float* __restrict__ scale,
                      const uint32_t* __restrict__ words, float* __restrict__ out, int64_t n,
                      int F, int p, int iters, int pipelined, int mitchell_iters) {
  const gsf::Datapath dp{words, F, p, iters, pipelined, mitchell_iters};
  const float inv_s = __frcp_rn(__ldg(scale));
  const int64_t nvec = n / kWidth;
  const int64_t chunk = static_cast<int64_t>(kThreads) * kWords;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * chunk;
  const int64_t first = blockIdx.x * chunk + threadIdx.x;
  uint32_t cur[kWords], nxt[kWords];
  load_trip<kWidth, kWords>(cur, x, first, nvec);
  for (int64_t base = first; base < nvec; base += stride) {
    load_trip<kWidth, kWords>(nxt, x, base + stride, nvec);
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int64_t v = base + k * kThreads;
      if (v < nvec) {
        float r[kWidth];
        recip_codes<kWidth>(cur[k], inv_s, dp, r);
        store_out<kWidth>(out, v, r);
      }
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) cur[k] = nxt[k];
  }
  // a word launch's last n % 4 codes, one a thread of the first block
  const int64_t i = nvec * kWidth + threadIdx.x;
  if (kWidth > 1 && blockIdx.x == 0 && i < n) {
    float r[1];
    recip_codes<1>(load_codes<1>(x, i), inv_s, dp, r);
    store_out<1>(out, i, r);
  }
}

using Kernel = void (*)(const int8_t*, const float*, const uint32_t*, float*, int64_t, int, int,
                        int, int, int);

// The instance for (vector, words a lane), or nullptr for a pair the plan
// never takes: words 1 and 4 at 32-bit words, 1 at single codes.
Kernel instance(int vector, int lane_words) {
  if (!vector) return lane_words == 1 ? gs_fixed_recip_kernel<1, 1> : nullptr;
  switch (lane_words) {
    case 1: return gs_fixed_recip_kernel<kWordCodes, 1>;
    case 4: return gs_fixed_recip_kernel<kWordCodes, 4>;
    default: return nullptr;
  }
}

}  // namespace

// x: (n,) int8; scale: (1,) f32; words: the reciprocal ROM words an int8
// code reaches, left-aligned to F (words[j << (p - 6)], j < 64, for p >= 6;
// all 2^p for p < 6); out: (n,) f32.  The launch plan (the wrapper's): vector
// (32-bit words of four codes: n >= 4, x 4-byte and out 16-byte aligned),
// lane_words (words a lane in flight), grid >= 1.  Returns
// cudaGetLastError().
extern "C" int gs_fixed_recip_launch(const void* x, const void* scale, const void* words,
                                     void* out, long long n, int F, int p, int iters,
                                     int pipelined, int mitchell_iters, int vector,
                                     int lane_words, int grid, void* stream) {
  const Kernel kernel = instance(vector, lane_words);
  if (kernel == nullptr || grid < 1 || n < 1 || (vector && n < kWordCodes))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(scale),
      static_cast<const uint32_t*>(words), static_cast<float*>(out), n, F, p, iters, pipelined,
      mitchell_iters);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of `threads` threads of the (vector, lane_words) instance that
// one SM holds at once, into *blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// on the current device).  Returns its cudaError_t.
extern "C" int gs_fixed_recip_occupancy(int vector, int lane_words, int threads, int* blocks) {
  const Kernel kernel = instance(vector, lane_words);
  if (kernel == nullptr || threads != kThreads) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, 0));
}
