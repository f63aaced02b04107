// Fused RMSNorm of int8 codes with the fixed-point Goldschmidt rsqrt, for
// sm_90a.
//
// Replaces: src/repro/kernels/gs_fixed.py::gs_fixed_rmsnorm (the
// pallas_call over _rmsnorm_kernel).  Per row of int8 x with an f32
// per-tensor scale: ss = sum x^2, exact in integers; ms = ss * scale^2 *
// (1/d) + eps in f32; the peel of ms into m in [1, 4) and half_e; the rsqrt
// ROM word at t / 3; rsqrt_reg with `iters` passes; inv = h2 * 2^-half_e;
// y = ((x * scale) * inv) * gain as f32.
//
// Bound on this card: device memory.  A row moves d bytes in and 4d out
// (gain's 4d once a block): at (333, 2048) 0.7 MB of int8 and 2.7 MB of
// f32, 1.02 us at 3.35 TB/s.  At decode (4, 2048) a launch moves 41 KB and
// is bound by one dependent chain: x's loads, the sum, one ROM word, the
// stores.  The datapath is a few dozen integer operations a row.
//
// Design (the launch plan is the wrapper's, kernels/gs_fixed.py, on
// gs_rmsnorm.py's row plan at one byte an element):
// * A row belongs to a group of row_threads threads (a multiple of 32); a
//   block holds blockDim / row_threads groups, one row each, and walks the
//   rows in a grid-stride loop, the grid sized to the card.
// * The row in registers, read once: thread t of a group holds the kVecs
//   vectors t, t + row_threads, ... of its row (kWidth codes each: one
//   16-byte vector of 16 codes when d is a multiple of 16 and x, gain and
//   out are 16-byte aligned, else one code), sums their squares, and after
//   the reduction writes y from the same registers as float4 stores (four
//   for a 16-code vector).  A 16-code vector's outputs are 64 contiguous
//   bytes, so before its stores a warp moves its words with four shuffles
//   (to_store_layout): each float4 store of the warp then writes 512
//   contiguous bytes, where stores straight from the loaded layout would
//   fill half of every sector they touch.  gain is loaded once a block
//   (float4 loads, in the store layout), before the first row, and stays
//   in registers for every row.  Which d go which way: up to 16384 at
//   16-byte vectors (kVecs 1-2) and 4096 at one code (kVecs 1-8) hold the
//   row; wider rows take the kVecs = 0 instance, a loop that reads x a
//   second time for the output.  The 16-byte instances load the block's
//   next row before they reduce this one, so a block's trips overlap.
// * The sum of squares is exact: __dp4a(w, w, acc) on each 32-bit word of
//   four codes, then __reduce_add_sync across the warp.  Every partial is an
//   integer below 2^32 (128^2 * 2^17 = 2^31 for d <= 2^17; the wrapper
//   refuses wider rows), held as uint32, so any order gives the same sum.
//   A row of several warps takes one barrier: each warp's lane 0 writes its
//   partial, then every thread adds its row's partials itself.  The partials
//   alternate between two buffers from one row to the next, so a warp that
//   runs ahead to the next row never overwrites partials another warp is
//   still reading; a row of one warp takes no barrier.
// * Every thread of a row runs the datapath itself (ms, the peel, the
//   index, rsqrt_reg): no thread waits on another and no broadcast barrier
//   follows.  The one ROM word a row comes from the left-aligned words in
//   device memory through the read-only cache; shared memory holds the
//   per-warp partials and nothing else.  scale is read once a block.
// * Every multiply and add is __fmul_rn / __fadd_rn in the plain version's
//   order (kernels/ref.py fixed_rmsnorm), so the two agree bit for bit.
#include <cstdint>

#include "gs_fixed_common.cuh"

namespace {

constexpr int kMaxThreads = 512;  // gs_rmsnorm.MAX_THREADS, the plan's limit
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kVecCodes = 16;  // int8 codes in a 16-byte vector

// kWidth codes of a row: a 16-byte vector as four words of four codes, or
// one code sign-extended into w[0].
template <int kWidth>
struct Codes {
  static_assert(kWidth == 1 || kWidth == kVecCodes, "one code or one 16-byte vector");
  uint32_t w[kWidth == 1 ? 1 : 4];
};

template <int kWidth>
__device__ __forceinline__ Codes<kWidth> load_codes(const int8_t* __restrict__ xr, int v) {
  Codes<kWidth> c;
  if constexpr (kWidth == 1) {
    c.w[0] = static_cast<uint32_t>(static_cast<int>(__ldg(xr + v)));
  } else {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr) + v);
    c.w[0] = raw.x;
    c.w[1] = raw.y;
    c.w[2] = raw.z;
    c.w[3] = raw.w;
  }
  return c;
}

// Row `row`'s vectors t, t + row_threads, ... into xv (none past the last row).
template <int kWidth, int kVecs>
__device__ __forceinline__ void load_row(Codes<kWidth> (&xv)[kVecs],
                                         const int8_t* __restrict__ x, unsigned row, int rows,
                                         int d, int t, int row_threads, int nvec) {
  if (row >= static_cast<unsigned>(rows)) return;
  const int8_t* xr = x + static_cast<int64_t>(row) * d;
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    if (t + k * row_threads < nvec) xv[k] = load_codes<kWidth>(xr, t + k * row_threads);
}

// Adds the codes' squares to acc; uint32 holds the exact sum (see above).
template <int kWidth>
__device__ __forceinline__ uint32_t sum_squares(const Codes<kWidth>& c, uint32_t acc) {
  if constexpr (kWidth == 1) {
    const int v = static_cast<int>(c.w[0]);
    return acc + static_cast<uint32_t>(v * v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = static_cast<int>(c.w[j]);
      acc = static_cast<uint32_t>(__dp4a(w, w, static_cast<int>(acc)));
    }
    return acc;
  }
}

__device__ __forceinline__ float norm(int code, float sc, float inv, float g) {
  return __fmul_rn(__fmul_rn(__fmul_rn(static_cast<float>(code), sc), inv), g);
}

// y of four codes packed in a word, as one float4.
__device__ __forceinline__ float4 norm4(uint32_t w, float sc, float inv, float4 g) {
  return make_float4(norm(static_cast<int8_t>(w), sc, inv, g.x),
                     norm(static_cast<int8_t>(w >> 8), sc, inv, g.y),
                     norm(static_cast<int8_t>(w >> 16), sc, inv, g.z),
                     norm(static_cast<int8_t>(w >> 24), sc, inv, g.w));
}

// The store layout of 16-byte vectors.  The 32 lanes of a warp hold 32
// consecutive vectors, 128 words of four codes: lane L words 4L..4L+3, whose
// outputs are 64 contiguous bytes.  Stored from there, each float4 store of
// the warp would write 16 bytes every 64 and fill half of each sector.  So
// the words move across the warp first: store j of lane L writes word
// 32j + L, and each store covers 512 contiguous bytes.  gain is loaded in
// the same layout.

// Rotates four words left by r (0-3, per lane) with selects, so that they
// stay in registers: w[i] <- w[(i + r) & 3].
__device__ __forceinline__ void rotate4(uint32_t (&w)[4], int r) {
  if (r & 1) {
    const uint32_t w0 = w[0];
    w[0] = w[1];
    w[1] = w[2];
    w[2] = w[3];
    w[3] = w0;
  }
  if (r & 2) {
    const uint32_t w0 = w[0], w1 = w[1];
    w[0] = w[2];
    w[1] = w[3];
    w[2] = w0;
    w[3] = w1;
  }
}

// Lane L's words 4L..4L+3 of the warp's 128 in, words 32j + L (j = 0..3) out.
// Word 32j + L is word L & 3 of lane 8j + (L >> 2).  In round r lane L reads
// from lane (L >> 2) + 8 * ((r + (L & 3)) & 3), so the four lanes that read
// one lane in a round want four different stores' words, each lane is read
// once a round, and a lane S sends its word ((S >> 3) - r) & 3: after a
// rotation by S >> 3, the same register in every lane.  Every lane of the
// warp takes part.
__device__ __forceinline__ void to_store_layout(uint32_t (&w)[4]) {
  const int lane = threadIdx.x & 31;
  rotate4(w, lane >> 3);
  uint32_t got[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    got[r] = __shfl_sync(0xffffffffu, w[(4 - r) & 3], (lane >> 2) + 8 * ((r + lane) & 3));
  // got[r] is the word of store (r + (lane & 3)) & 3
  rotate4(got, (4 - lane) & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = got[j];
}

// The gain a thread applies to one vector's codes: one f32, or for a 16-byte
// vector the float4 of each of its four stores (the store layout).
template <int kWidth>
struct Gain {
  float4 g[4];
};
template <>
struct Gain<1> {
  float g;
};

// Store j's float4 of a 16-byte vector v is word 4 * (v - lane) + 32j + lane
// of the row, a word of vector (v - lane) + 8j + (lane >> 2).
__device__ __forceinline__ bool store_in_row(int v, int j, int nvec) {
  const int lane = threadIdx.x & 31;
  return v - lane + 8 * j + (lane >> 2) < nvec;
}

__device__ __forceinline__ int store_word(int v, int j) {
  const int lane = threadIdx.x & 31;
  return 4 * (v - lane) + 32 * j + lane;
}

template <int kWidth>
__device__ __forceinline__ Gain<kWidth> load_gain(const float* __restrict__ gain, int v,
                                                  int nvec) {
  Gain<kWidth> g;
  if constexpr (kWidth == 1) {
    if (v < nvec) g.g = __ldg(gain + v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (store_in_row(v, j, nvec))
        g.g[j] = __ldg(reinterpret_cast<const float4*>(gain) + store_word(v, j));
  }
  return g;
}

// y of vector v's codes into the output row.  A 16-byte vector is moved to
// the store layout first, so every lane of the warp calls this for the same
// warp of vectors (v - lane < nvec).
template <int kWidth>
__device__ __forceinline__ void store_norm(float* __restrict__ orow, int v, Codes<kWidth> c,
                                           float sc, float inv, const Gain<kWidth>& g,
                                           int nvec) {
  if constexpr (kWidth == 1) {
    if (v < nvec) orow[v] = norm(static_cast<int>(c.w[0]), sc, inv, g.g);
  } else {
    to_store_layout(c.w);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (store_in_row(v, j, nvec))
        reinterpret_cast<float4*>(orow)[store_word(v, j)] = norm4(c.w[j], sc, inv, g.g[j]);
  }
}

// The row's sum of the threads' `acc`: the warp's sum, then, for a row of
// `warps` > 1 warps, the partials in part[buf] after one barrier, added by
// every thread.  `warps` is the same in every thread of the block, so the
// barrier is reached by all of them or by none.
__device__ __forceinline__ uint32_t row_sum(uint32_t acc, uint32_t* part, int warps,
                                            int warp0) {
  acc = __reduce_add_sync(0xffffffffu, acc);
  if (warps == 1) return acc;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  acc = part[warp0];
  for (int w = 1; w < warps; ++w) acc += part[warp0 + w];
  return acc;
}

// inv = rsqrt(ss * scale^2 * (1/d) + eps) on the fixed datapath, from one ROM
// word read through the read-only cache.
__device__ __forceinline__ float row_inv(uint32_t ss, float sc2, float inv_d, float eps,
                                         const uint32_t* __restrict__ words, int F, int p,
                                         int iters) {
  const float ms = __fadd_rn(__fmul_rn(__fmul_rn(__uint2float_rn(ss), sc2), inv_d), eps);
  const int ebits = gs::biased_exp(ms) - 127;
  const int half_e = ebits >> 1;  // arithmetic floor
  const int rem = ebits - (half_e << 1);  // 0 or 1: fold into m in [1, 4)
  const uint32_t m_reg = gsf::mant_to_reg(gsf::mantissa_with_one(ms), F) << rem;
  const uint32_t t = (m_reg - (1u << F)) >> (F - p);
  const uint32_t idx = min(t / 3u, (1u << p) - 1u);
  const uint32_t h2 = gsf::rsqrt_reg(m_reg, __ldg(words + idx), F, iters);
  return __fmul_rn(gsf::reg_to_f32(h2, F), gs::pow2_from_biased(127 - half_e));
}

// kVecs > 0: the row in registers (kVecs vectors a thread); kVecs == 0: the
// looping instance for rows wider than the register plan.
template <int kWidth, int kVecs>
__global__ void __launch_bounds__(kMaxThreads)
gs_fixed_rmsnorm_kernel(const int8_t* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ gain, const uint32_t* __restrict__ words,
                        float* __restrict__ out, int rows, int d, float inv_d, float eps,
                        int F, int p, int iters, int row_threads) {
  __shared__ uint32_t part[2][kMaxWarps];  // each warp's partial, two rows in turn
  const int groups = blockDim.x / row_threads;  // rows a block
  const int group = threadIdx.x / row_threads;
  const int t = threadIdx.x - group * row_threads;
  const int t0 = t - (threadIdx.x & 31);  // the warp's first thread of the group
  const int warps = row_threads >> 5;  // warps a row
  const int nvec = d / kWidth;

  Gain<kWidth> g[kVecs > 0 ? kVecs : 1];
  if constexpr (kVecs > 0) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) g[k] = load_gain<kWidth>(gain, t + k * row_threads, nvec);
  }
  const float sc = __ldg(scale);
  const float sc2 = __fmul_rn(sc, sc);
  const unsigned stride = gridDim.x * groups;
  // the 16-byte instances load the block's next row while this one is
  // reduced and stored, so the trips of the grid-stride loop overlap
  constexpr bool kAhead = kVecs > 0 && kWidth == kVecCodes;
  Codes<kWidth> ahead[kVecs > 0 ? kVecs : 1];
  if constexpr (kAhead)
    load_row(ahead, x, blockIdx.x * groups + group, rows, d, t, row_threads, nvec);
  int buf = 0;
  // every thread of the block runs the same trips: a group past the last
  // row still reaches the barrier (rows < 2^31 and a stride below 2^31 keep
  // base and the next row below 2^32)
  for (unsigned base = blockIdx.x * groups; base < static_cast<unsigned>(rows);
       base += stride, buf ^= 1) {
    const unsigned row = base + group;
    const bool live = row < static_cast<unsigned>(rows);
    const int8_t* xr = x + static_cast<int64_t>(row) * d;
    uint32_t acc = 0u;
    Codes<kWidth> xv[kVecs > 0 ? kVecs : 1];
    if constexpr (kVecs > 0) {
      if constexpr (kAhead) {
#pragma unroll
        for (int k = 0; k < kVecs; ++k) xv[k] = ahead[k];
        load_row(ahead, x, row + stride, rows, d, t, row_threads, nvec);
      } else {
        load_row(xv, x, row, rows, d, t, row_threads, nvec);
      }
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
        if (live && t + k * row_threads < nvec) acc = sum_squares(xv[k], acc);
    } else {
      if (live)
        for (int v = t; v < nvec; v += row_threads)
          acc = sum_squares(load_codes<kWidth>(xr, v), acc);
    }
    const uint32_t ss = row_sum(acc, part[buf], warps, group * warps);
    if (!live) continue;  // the same in every thread of a group: whole warps
    const float inv = row_inv(ss, sc2, inv_d, eps, words, F, p, iters);
    float* orow = out + static_cast<int64_t>(row) * d;
    // the stores run by whole warps (t0 + ... < nvec), each lane masked
    if constexpr (kVecs > 0) {
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
        if (t0 + k * row_threads < nvec)
          store_norm<kWidth>(orow, t + k * row_threads, xv[k], sc, inv, g[k], nvec);
    } else {
      for (int v = t; v - t + t0 < nvec; v += row_threads) {
        const Codes<kWidth> c = v < nvec ? load_codes<kWidth>(xr, v) : Codes<kWidth>{};
        store_norm<kWidth>(orow, v, c, sc, inv, load_gain<kWidth>(gain, v, nvec), nvec);
      }
    }
  }
}

using Kernel = void (*)(const int8_t*, const float*, const float*, const uint32_t*, float*,
                        int, int, float, float, int, int, int, int);

// The instance for (vector, vecs), or nullptr for a pair the plan never
// takes: vecs 0 (the loop), 1, 2 at 16-byte vectors, and 0, 1, 2, 4, 8 at
// one code (at most 32 codes a thread).
Kernel instance(int vector, int vecs) {
  if (vector) {
    switch (vecs) {
      case 0: return gs_fixed_rmsnorm_kernel<kVecCodes, 0>;
      case 1: return gs_fixed_rmsnorm_kernel<kVecCodes, 1>;
      case 2: return gs_fixed_rmsnorm_kernel<kVecCodes, 2>;
      default: return nullptr;
    }
  }
  switch (vecs) {
    case 0: return gs_fixed_rmsnorm_kernel<1, 0>;
    case 1: return gs_fixed_rmsnorm_kernel<1, 1>;
    case 2: return gs_fixed_rmsnorm_kernel<1, 2>;
    case 4: return gs_fixed_rmsnorm_kernel<1, 4>;
    case 8: return gs_fixed_rmsnorm_kernel<1, 8>;
    default: return nullptr;
  }
}

}  // namespace

// x, out: (rows, d) int8 -> f32; scale: (1,) f32; gain: (d,) f32; words:
// (2^p,) uint32 rsqrt ROM words left-aligned to F.  The launch plan (the
// wrapper's): vector (16-byte vectors: d a multiple of 16, x, gain and out
// 16-byte aligned), vecs (vectors a thread holds; 0 the loop), row_threads
// (a multiple of 32), rows_per_block, grid >= 1.  Returns
// cudaGetLastError().
extern "C" int gs_fixed_rmsnorm_launch(const void* x, const void* scale, const void* gain,
                                       const void* words, void* out, int rows, int d,
                                       float inv_d, float eps, int F, int p, int iters,
                                       int vector, int vecs, int row_threads,
                                       int rows_per_block, int grid, void* stream) {
  const Kernel kernel = instance(vector, vecs);
  const int threads = row_threads * rows_per_block;
  if (kernel == nullptr || grid < 1 || row_threads < 32 || row_threads % 32 != 0 ||
      rows_per_block < 1 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(gain), static_cast<const uint32_t*>(words),
      static_cast<float*>(out), rows, d, inv_d, eps, F, p, iters, row_threads);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of `threads` threads of the (vector, vecs) instance that one SM
// holds at once, into *blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// on the current device).  Returns its cudaError_t.
extern "C" int gs_fixed_rmsnorm_occupancy(int vector, int vecs, int threads, int* blocks) {
  const Kernel kernel = instance(vector, vecs);
  if (kernel == nullptr || threads < 32 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, 0));
}
