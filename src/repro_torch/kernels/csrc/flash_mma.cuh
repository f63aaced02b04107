// Tensor-core fragments for the flash-attention kernels, for sm_90a: f32
// products on TF32 mma.sync with an error-compensating hi/lo split
// ("3xTF32"), and the cp.async staging of row tiles.
//
// * mma: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, D = A B + C
//   with A 16x8 (row), B 8x8 (col), f32 accumulators.  Per lane, with
//   gid = lane / 4 and tig = lane % 4:
//     A: a0 (gid, tig)  a1 (gid+8, tig)  a2 (gid, tig+4)  a3 (gid+8, tig+4)
//     B: b0 (k = tig, n = gid)  b1 (k = tig+4, n = gid)
//     C: c0 (gid, 2tig)  c1 (gid, 2tig+1)  c2 (gid+8, 2tig)  c3 (gid+8, 2tig+1)
// * The split: x = hi + lo with hi = rna_tf32(x), lo = rna_tf32(x - hi);
//   x - hi is exact, and hi + lo carries 22 of x's 24 significand bits.
//   a b ~ a.lo b.hi + a.hi b.lo + a.hi b.hi, the small terms first; a.lo
//   b.lo (~2^-22 relative) is dropped.  A single pass (a.hi b.hi) keeps
//   about 11 bits and is never taken on f32 data.  An operand that is exact
//   in TF32 (bf16 widened to f32: 8 significand bits) has lo = 0, so its
//   products drop the terms with its lo: kPasses = 1 when both operands
//   are exact, 2 when only B is (A's lo.hi, then hi.hi), 3 otherwise.
// * Accumulation: the tensor cores round the f32 sum inside each mma, and
//   not to nearest, so over a sum of hundreds of keys the error grows
//   several-fold past a plain f32 product's.  mma_step's kSum form sums a
//   k-step's passes from zero and adds them to the accumulator in one
//   round-to-nearest f32 add; the long sums (over the sequence) take it,
//   the short ones (over the head dim) do not.
// * C -> A without data movement: the k index of a product is a summation
//   index, so any permutation applied to A's columns and B's rows alike
//   leaves the result unchanged.  Taking logical k = tig <-> column 2tig
//   and k = tig+4 <-> column 2tig+1 of an 8-wide block, an accumulator
//   tile (c0, c1, c2, c3) is the A fragment (c0, c2, c1, c3) of a product
//   over its columns, and the B operand's rows are read at 2tig and 2tig+1
//   (load_b_perm).  P and dS never leave the registers.
// * Shared-memory tiles keep rows of kD elements at a pitch of kD + 16
//   bytes: both B reads (rows n0 + gid at column k0 + tig, and rows
//   k0 + 2tig (+1) at column n0 + gid) then hit 32 distinct banks for f32,
//   and distinct or shared (broadcast) words for bf16; rows stay 16-byte
//   aligned for cp.async and ldmatrix.  An f32 tile's 8 x 4 blocks are
//   exactly the fragments' (gid, tig) layout of ldmatrix's 8 x 8 b16
//   matrices, so A and the unpermuted B load four registers a lane with one
//   ldmatrix.x4; bf16 tiles (16-bit elements) and the permuted B are read
//   element by element.
#pragma once

#include <cstdint>

#include "gs_common.cuh"

namespace flash_mma {

constexpr int kTileRows = 64;  // rows of a staged tile

// max(a, b), NaN if either is NaN (fmaxf would drop it), as jnp.maximum and
// torch.amax keep it: the row max and the guard max(l, 1e-30) of the flash
// kernels.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <typename T>
struct IsExact {  // TF32 holds the type's values exactly
  static constexpr bool value = false;
};
template <>
struct IsExact<__nv_bfloat16> {
  static constexpr bool value = true;
};

// The row pitch (elements) of a staged (kTileRows, kD) tile of T.
template <typename T, int kD>
__host__ __device__ constexpr int pitch() {
  return kD + 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// hi and lo of x; x itself (lo = 0) when x is exact in TF32.  lo is dead
// code for the passes that do not read it.
template <bool kExact>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (kExact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = tf32_rna(x);
    lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
  }
}

template <bool kExact>
__device__ __forceinline__ FragA make_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split<kExact>(a0, f.hi[0], f.lo[0]);
  split<kExact>(a1, f.hi[1], f.lo[1]);
  split<kExact>(a2, f.hi[2], f.lo[2]);
  split<kExact>(a3, f.hi[3], f.lo[3]);
  return f;
}

// The A fragment of an accumulator tile taken as the left operand of a
// product over its 8 columns, under the permutation above.
__device__ __forceinline__ FragA a_from_acc(const float (&c)[4]) {
  return make_a<false>(c[0], c[2], c[1], c[3]);
}

template <bool kExact>
__device__ __forceinline__ FragB make_b(float b0, float b1) {
  FragB f;
  split<kExact>(b0, f.hi[0], f.lo[0]);
  split<kExact>(b1, f.hi[1], f.lo[1]);
  return f;
}

// Four 8 x 4 blocks of f32 (rows of 16 bytes) in one ldmatrix: lanes
// 8j..8j+7 give the row addresses of block j, and lane t receives row t / 4,
// column t % 4 of block j in r[j], the fragments' (gid, tig) element.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* row) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

template <typename T>
constexpr bool kLdmatrix = sizeof(T) == 4;  // 32-bit elements: f32 tiles

// The A fragment of the 16 x 8 block of a staged tile whose first element
// is `at`.
template <typename T, int kPitch>
__device__ __forceinline__ FragA load_a(const T* at) {
  const int lane = threadIdx.x & 31;
  if constexpr (kLdmatrix<T>) {
    const int j = lane >> 3, r = lane & 7;
    uint32_t w[4];
    ldmatrix_x4(w, at + (r + 8 * (j & 1)) * kPitch + 4 * (j >> 1));
    return make_a<false>(__uint_as_float(w[0]), __uint_as_float(w[1]), __uint_as_float(w[2]),
                         __uint_as_float(w[3]));
  } else {
    at += (lane >> 2) * kPitch + (lane & 3);
    return make_a<IsExact<T>::value>(gs::to_f32(at[0]), gs::to_f32(at[8 * kPitch]),
                                     gs::to_f32(at[4]), gs::to_f32(at[8 * kPitch + 4]));
  }
}

// B fragments with k along the tile's columns, for the two 8-row blocks
// (n) of the 16 x 8 block whose first element is `at`: b0, b1 at row
// gid, columns tig and tig + 4 of each.
template <typename T, int kPitch>
__device__ __forceinline__ void load_b2(FragB (&b)[2], const T* at) {
  constexpr bool kExact = IsExact<T>::value;
  const int lane = threadIdx.x & 31;
  if constexpr (kLdmatrix<T>) {
    const int j = lane >> 3, r = lane & 7;
    uint32_t w[4];
    ldmatrix_x4(w, at + (r + 8 * (j >> 1)) * kPitch + 4 * (j & 1));
    b[0] = make_b<false>(__uint_as_float(w[0]), __uint_as_float(w[1]));
    b[1] = make_b<false>(__uint_as_float(w[2]), __uint_as_float(w[3]));
  } else {
    at += (lane >> 2) * kPitch + (lane & 3);
    b[0] = make_b<kExact>(gs::to_f32(at[0]), gs::to_f32(at[4]));
    b[1] = make_b<kExact>(gs::to_f32(at[8 * kPitch]), gs::to_f32(at[8 * kPitch + 4]));
  }
}

// The B fragment with k along the tile's rows, permuted, for the 8 x 8
// block whose first element is `at`: b0, b1 at rows 2tig and 2tig + 1,
// column gid.
template <typename T, int kPitch>
__device__ __forceinline__ FragB load_b_perm(const T* at) {
  const int lane = threadIdx.x & 31;
  at += 2 * (lane & 3) * kPitch + (lane >> 2);
  return make_b<IsExact<T>::value>(gs::to_f32(at[0]), gs::to_f32(at[kPitch]));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a b over one k-step in kPasses TF32 products (see above).
template <int kPasses>
__device__ __forceinline__ void mma_split(float (&acc)[4], const FragA& a, const FragB& b) {
  static_assert(kPasses >= 1 && kPasses <= 3, "1, 2 or 3 passes");
  if (kPasses >= 2) mma(acc, a.lo, b.hi);
  if (kPasses == 3) mma(acc, a.hi, b.lo);
  mma(acc, a.hi, b.hi);
}

// acc += a b over one k-step.  kSum: the step's passes start from zero and
// meet acc in one round-to-nearest f32 add, so a long sum is not rounded
// inside the tensor cores.
template <int kPasses, bool kSum>
__device__ __forceinline__ void mma_step(float (&acc)[4], const FragA& a, const FragB& b) {
  if (kSum) {
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_split<kPasses>(t, a, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], t[i]);
  } else {
    mma_split<kPasses>(acc, a, b);
  }
}

// -- cp.async staging ----------------------------------------------------------

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issues the copies of rows [row0, row0 + kTileRows) of a row-major (S, kD)
// matrix into a tile of pitch<T, kD>(); rows at or past S are zero-filled.
// The caller commits the group.
template <typename T, int kD, int kThreads>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, int row0, int S) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements per copy
  constexpr int kPerRow = kD / kPer;
  constexpr int kPitch = pitch<T, kD>();
  static_assert(kTileRows * kPerRow % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < kTileRows * kPerRow / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kPerRow, c = (idx % kPerRow) * kPer;
    const int row = row0 + r;
    const bool ok = row < S;
    cp_async16(dst + r * kPitch + c, ok ? src + (int64_t)row * kD + c : src, ok ? 16 : 0);
  }
}

// -- launch and store ----------------------------------------------------------

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Stores a 16 x kD accumulator tile (rows row0.., C layout) to a row-major
// (S, kD) matrix of U, rows past S skipped.
template <typename U, int kD>
__device__ __forceinline__ void store_rows(U* dst, const float (&acc)[kD / 8][4], int row0,
                                           int S) {
  const int gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + gid + 8 * i;
    if (row >= S) continue;
    U* out = dst + (int64_t)row * kD + 2 * tig;
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      out[8 * nd] = gs::from_f32<U>(acc[nd][2 * i]);
      out[8 * nd + 1] = gs::from_f32<U>(acc[nd][2 * i + 1]);
    }
  }
}

}  // namespace flash_mma
