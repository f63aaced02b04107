// Row softmax of int8 codes with the fixed-point Goldschmidt reciprocal, for
// sm_90a.
//
// Replaces: src/repro/kernels/gs_fixed.py::gs_fixed_softmax (the
// pallas_call over _softmax_kernel).  Per row of int8 x with an f32
// per-tensor scale: v = x * scale, m = max v, e = exp(v - m), s = sum e (in
// [1, d]: a positive normal); s's mantissa peeled into a register, the
// recip ROM word at (mant & 0x7FFFFF) >> (23 - p), the fixed divide
// (gsf::divide, both variants, Mitchell passes included), inv = (q * 2^-F)
// * 2^(127 - eb) with eb s's biased exponent; out = e * inv as f32.
//
// Bound on this card: device memory.  A row moves d bytes in and 4d out: at
// (65536, 128) 8.4 MB of int8 and 33.6 MB of f32, 12.52 us at 3.35 TB/s.
// At (256, 128) a launch moves 164 KB and is bound by the launch and one
// dependent chain: x's loads, the max, the exps and their sum, one ROM
// word, the stores.  The datapath is a few dozen integer operations a row.
//
// Design (the launch plan is the wrapper's, kernels/gs_fixed.py
// softmax_plan):
// * A row belongs to a group of row_threads threads: a power of two up to
//   32 (a segment of a warp, 32 / row_threads rows a warp) or a multiple of
//   32.  A block holds blockDim / row_threads groups, one row each, and walks
//   the rows in a grid-stride loop, the grid sized to the card.  At d 128
//   a row is one warp and every lane holds one 32-bit word of four codes: a
//   warp's load is 128 contiguous bytes and its float4 stores 512.  When
//   the rows fill a wave of blocks the wrapper packs a narrow row into
//   fewer lanes (at d 128 eight words in each of 4 lanes, eight rows a
//   warp): a trip then has eight rows' loads in flight, and their
//   reductions and datapaths run side by side.
// * The row in registers, read once: thread t of a group holds the kVecs
//   vectors t, t + row_threads, ... of its row (kWidth codes each: a 32-bit
//   word of four codes when d is a multiple of 4, x is 4-byte and out
//   16-byte aligned, else one code), then their e values, and writes out
//   from those registers (a float4 a word, as streaming stores: 2% faster
//   at (65536, 128) on an H100).  exp runs once a code.  The
//   register instances load the block's next row before they reduce this
//   one.  Rows wider than the register plan (16384 codes in words, 4096 in
//   single codes) take the kVecs = 0 instance, a loop that reads x three
//   times (for the max, the sum and the output) and runs exp twice a code.
// * An exact max on the codes: rounding is monotone, so for scale > 0 the
//   largest fl(code * scale) is fl(max code * scale), and for scale < 0
//   fl(min code * scale).  The lanes take the integer max of code (or of
//   -code for a negative scale) and the row does one multiply: the same bits
//   as the plain version's amax for every finite non-zero scale (at scale 0
//   only a zero's sign can differ, and exp(v - m) is 1 either way).
// * The reductions leave the same bits in every lane: the max key by
//   __reduce_max_sync (a whole warp) or an xor butterfly (a segment), the sum
//   by an xor butterfly of __fadd_rn, whose two lanes of a pair add the same
//   two values (IEEE addition commutes).  A row of several warps takes one
//   barrier for the max partials and one for the sum partials, and every
//   thread combines its row's partials itself in the same order.  Between
//   one row's reads of a buffer and the next row's writes to it lies the
//   other reduction's barrier, so one buffer of each suffices.
// * Every thread of a row runs the datapath itself: no thread waits on
//   another and no broadcast barrier follows.  The one ROM word a row comes
//   from the left-aligned words in device memory through the read-only
//   cache; shared memory holds the per-warp partials and nothing else.
//   scale is read once a block.
// * The float arithmetic is __fmul_rn / __fsub_rn / __fadd_rn in the plain
//   version's order (kernels/ref.py fixed_softmax); the sum's order and
//   expf differ from torch's, so the kernel is held to a bound.
#include <cstdint>

#include "gs_fixed_common.cuh"

namespace {

constexpr int kMaxThreads = 512;  // gs_fixed.SOFTMAX_MAX_THREADS, the plan's limit
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kWordCodes = 4;  // int8 codes in a 32-bit word
constexpr int kNoKey = -256;  // below every code's key (keys lie in [-127, 128])

// kWidth codes of a row as one register: a word of four codes, or one code
// sign-extended.
template <int kWidth>
__device__ __forceinline__ uint32_t load_codes(const int8_t* __restrict__ xr, int v) {
  static_assert(kWidth == 1 || kWidth == kWordCodes, "one code or one 32-bit word");
  if constexpr (kWidth == 1) {
    return static_cast<uint32_t>(static_cast<int>(__ldg(xr + v)));
  } else {
    return __ldg(reinterpret_cast<const uint32_t*>(xr) + v);
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

// Row `row`'s vectors t, t + row_threads, ... into xv (none past the last row).
template <int kWidth, int kVecs>
__device__ __forceinline__ void load_row(uint32_t (&xv)[kVecs], const int8_t* __restrict__ x,
                                         unsigned row, int rows, int d, int t, int row_threads,
                                         int nvec) {
  if (row >= static_cast<unsigned>(rows)) return;
  const int8_t* xr = x + static_cast<int64_t>(row) * d;
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    if (t + k * row_threads < nvec) xv[k] = load_codes<kWidth>(xr, t + k * row_threads);
}

// The largest key of a vector's codes and `key`: code, or -code when the
// scale is negative.
template <int kWidth>
__device__ __forceinline__ int max_key(uint32_t w, bool neg, int key) {
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    const int c = code<kWidth>(w, j);
    key = max(key, neg ? -c : c);
  }
  return key;
}

__device__ __forceinline__ float shifted_exp(int c, float sc, float m) {
  return expf(__fsub_rn(__fmul_rn(static_cast<float>(c), sc), m));
}

// out of a vector's e values: a float4 for a word, one f32 for a code, as
// streaming stores (the kernel never reads out back).
template <int kWidth>
__device__ __forceinline__ void store_out(float* __restrict__ orow, int v,
                                          const float (&e)[kWidth], float inv) {
  if constexpr (kWidth == 1) {
    __stcs(orow + v, __fmul_rn(e[0], inv));
  } else {
    __stcs(reinterpret_cast<float4*>(orow) + v,
           make_float4(__fmul_rn(e[0], inv), __fmul_rn(e[1], inv), __fmul_rn(e[2], inv),
                       __fmul_rn(e[3], inv)));
  }
}

// The max of v over a group's `lanes` lanes (32, or a power of two below),
// the same in each of them.  Every lane of the warp takes part.
__device__ __forceinline__ int lanes_max(int v, int lanes) {
  if (lanes == 32) return __reduce_max_sync(0xffffffffu, v);
  for (int o = lanes >> 1; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The sum of v over a group's lanes by an xor butterfly: the two lanes of a
// pair add the same two values, so every lane ends with the same bits.
__device__ __forceinline__ float lanes_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The row's value from each lane's group value v (lanes_max or lanes_sum):
// for a row of `warps` > 1 warps, the per-warp values in part after one
// barrier, combined by `op` in every thread from the row's first warp on.
// `warps` is the same in every thread of the block, so the barrier is
// reached by all of them or by none.
template <typename T, typename Op>
__device__ __forceinline__ T across_warps(T v, T* part, int warps, int warp0, Op op) {
  if (warps == 1) return v;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = part[warp0];
  for (int w = 1; w < warps; ++w) v = op(v, part[warp0 + w]);
  return v;
}

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return max(a, b); }
};
struct AddOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};

// inv = 1/s on the fixed datapath: s's mantissa into a register, the recip
// ROM word through the read-only cache, then 2^(127 - eb).
__device__ __forceinline__ float row_inv(float s, const uint32_t* __restrict__ words,
                                         const gsf::Datapath& dp) {
  const uint32_t mant = gsf::mantissa_with_one(s);
  const uint32_t idx = min((mant & 0x7FFFFFu) >> (23 - dp.p), (1u << dp.p) - 1u);
  const uint32_t q = gsf::divide(1u << dp.F, gsf::mant_to_reg(mant, dp.F), __ldg(words + idx), dp);
  return __fmul_rn(gsf::reg_to_f32(q, dp.F), gs::pow2_from_biased(254 - gs::biased_exp(s)));
}

// kVecs > 0: the row in registers (kVecs vectors a thread); kVecs == 0: the
// looping instance for rows wider than the register plan.
template <int kWidth, int kVecs>
__global__ void __launch_bounds__(kMaxThreads)
gs_fixed_softmax_kernel(const int8_t* __restrict__ x, const float* __restrict__ scale,
                        const uint32_t* __restrict__ words, float* __restrict__ out, int rows,
                        int d, int F, int p, int iters, int pipelined, int mitchell_iters,
                        int row_threads) {
  __shared__ int part_max[kMaxWarps];
  __shared__ float part_sum[kMaxWarps];
  const gsf::Datapath dp{words, F, p, iters, pipelined, mitchell_iters};
  const int groups = blockDim.x / row_threads;  // rows a block
  const int group = threadIdx.x / row_threads;
  const int t = threadIdx.x - group * row_threads;
  const int lanes = min(row_threads, 32);
  const int warps = max(row_threads >> 5, 1);  // warps a row
  const int warp0 = group * warps;  // the row's first warp (rows of whole warps)
  const int nvec = d / kWidth;
  const float sc = __ldg(scale);
  const bool neg = sc < 0.0f;
  const unsigned stride = gridDim.x * groups;
  constexpr int kHeld = kVecs > 0 ? kVecs : 1;
  uint32_t ahead[kHeld];
  if constexpr (kVecs > 0)
    load_row<kWidth, kVecs>(ahead, x, blockIdx.x * groups + group, rows, d, t, row_threads, nvec);
  // every thread of the block runs the same trips: a group past the last
  // row still reaches the shuffles and barriers (rows < 2^31 and a stride
  // below 2^31 keep base and the next row below 2^32)
  for (unsigned base = blockIdx.x * groups; base < static_cast<unsigned>(rows); base += stride) {
    const unsigned row = base + group;
    const bool live = row < static_cast<unsigned>(rows);
    const int8_t* xr = x + static_cast<int64_t>(row) * d;
    float* orow = out + static_cast<int64_t>(row) * d;
    int key = kNoKey;
    if constexpr (kVecs > 0) {
      uint32_t xv[kVecs];
#pragma unroll
      for (int k = 0; k < kVecs; ++k) xv[k] = ahead[k];
      load_row<kWidth, kVecs>(ahead, x, row + stride, rows, d, t, row_threads, nvec);
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
        if (live && t + k * row_threads < nvec) key = max_key<kWidth>(xv[k], neg, key);
      key = across_warps(lanes_max(key, lanes), part_max, warps, warp0, MaxOp{});
      const float m = __fmul_rn(static_cast<float>(neg ? -key : key), sc);
      float e[kVecs][kWidth];
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
        if (live && t + k * row_threads < nvec) {
#pragma unroll
          for (int j = 0; j < kWidth; ++j) {
            e[k][j] = shifted_exp(code<kWidth>(xv[k], j), sc, m);
            acc = __fadd_rn(acc, e[k][j]);
          }
        }
      const float s = across_warps(lanes_sum(acc, lanes), part_sum, warps, warp0, AddOp{});
      if (!live) continue;  // the same in every thread of a group
      const float inv = row_inv(s, words, dp);
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
        if (t + k * row_threads < nvec) store_out<kWidth>(orow, t + k * row_threads, e[k], inv);
    } else {
      if (live)
        for (int v = t; v < nvec; v += row_threads)
          key = max_key<kWidth>(load_codes<kWidth>(xr, v), neg, key);
      key = across_warps(lanes_max(key, lanes), part_max, warps, warp0, MaxOp{});
      const float m = __fmul_rn(static_cast<float>(neg ? -key : key), sc);
      float acc = 0.0f;
      if (live)
        for (int v = t; v < nvec; v += row_threads) {
          const uint32_t w = load_codes<kWidth>(xr, v);
#pragma unroll
          for (int j = 0; j < kWidth; ++j)
            acc = __fadd_rn(acc, shifted_exp(code<kWidth>(w, j), sc, m));
        }
      const float s = across_warps(lanes_sum(acc, lanes), part_sum, warps, warp0, AddOp{});
      if (!live) continue;
      const float inv = row_inv(s, words, dp);
      for (int v = t; v < nvec; v += row_threads) {
        const uint32_t w = load_codes<kWidth>(xr, v);
        float e[kWidth];
#pragma unroll
        for (int j = 0; j < kWidth; ++j) e[j] = shifted_exp(code<kWidth>(w, j), sc, m);
        store_out<kWidth>(orow, v, e, inv);
      }
    }
  }
}

using Kernel = void (*)(const int8_t*, const float*, const uint32_t*, float*, int, int, int, int,
                        int, int, int, int);

// The instance for (vector, vecs), or nullptr for a pair the plan never
// takes: vecs 0 (the loop), 1, 2, 4, 8 at either width.
template <int kWidth>
Kernel instance_of(int vecs) {
  switch (vecs) {
    case 0: return gs_fixed_softmax_kernel<kWidth, 0>;
    case 1: return gs_fixed_softmax_kernel<kWidth, 1>;
    case 2: return gs_fixed_softmax_kernel<kWidth, 2>;
    case 4: return gs_fixed_softmax_kernel<kWidth, 4>;
    case 8: return gs_fixed_softmax_kernel<kWidth, 8>;
    default: return nullptr;
  }
}

Kernel instance(int vector, int vecs) {
  return vector ? instance_of<kWordCodes>(vecs) : instance_of<1>(vecs);
}

// row_threads a power of two up to 32 or a multiple of 32, and blocks of
// whole warps: every lane of a warp reaches the shuffles.
bool valid_block(int row_threads, int threads) {
  const bool shape = row_threads <= 32 ? row_threads > 0 && (row_threads & (row_threads - 1)) == 0
                                       : row_threads % 32 == 0;
  return shape && threads % row_threads == 0 && threads % 32 == 0 && threads > 0 &&
         threads <= kMaxThreads;
}

}  // namespace

// x, out: (rows, d) int8 -> f32; scale: (1,) f32; words: (2^p,) uint32
// reciprocal ROM words left-aligned to F.  The launch plan (the wrapper's):
// vector (32-bit words of four codes: d a multiple of 4, x 4-byte and out
// 16-byte aligned), vecs (vectors a thread holds; 0 the loop), row_threads,
// rows_per_block, grid >= 1.  Returns cudaGetLastError().
extern "C" int gs_fixed_softmax_launch(const void* x, const void* scale, const void* words,
                                       void* out, int rows, int d, int F, int p, int iters,
                                       int pipelined, int mitchell_iters, int vector, int vecs,
                                       int row_threads, int rows_per_block, int grid,
                                       void* stream) {
  const Kernel kernel = instance(vector, vecs);
  const int threads = row_threads * rows_per_block;
  if (kernel == nullptr || grid < 1 || rows_per_block < 1 || !valid_block(row_threads, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(scale),
      static_cast<const uint32_t*>(words), static_cast<float*>(out), rows, d, F, p, iters,
      pipelined, mitchell_iters, row_threads);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of `threads` threads of the (vector, vecs) instance that one SM
// holds at once, into *blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// on the current device).  Returns its cudaError_t.
extern "C" int gs_fixed_softmax_occupancy(int vector, int vecs, int threads, int* blocks) {
  const Kernel kernel = instance(vector, vecs);
  if (kernel == nullptr || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, 0));
}
