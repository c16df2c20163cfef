// Building blocks of the tiled attention kernels for Hopper (sm_90a):
// float32-accurate products on the tensor cores, fragment loads from padded
// shared-memory tiles, asynchronous staging of row tiles, and the mask test.
// Used by attention_bwd.cu (dq, dk/dv); written so that the forward of the
// scaled-dot-product attention and the four kernels of the rel-pose
// attention can be built from the same pieces.
//
// The products. A warp multiplies 16 x 8 by 8 x 8 fragments with
// mma.sync.aligned.m16n8k8 on TF32 operands and float32 accumulators. TF32
// keeps 10 bits of mantissa, so one such product is good to about three
// digits only. Each float32 operand x is therefore split into a TF32 head
// big (x rounded to 10 bits of mantissa) and a TF32 remainder small (x -
// big, which is exact and of either sign; the tensor cores cut it to 10
// bits), and a product a * b is done as three: a.small * b.big, a.big *
// b.small, a.big * b.big (the small terms first, so that they are not lost
// against the large sum). What is dropped, a.small * b.small and the cut of
// the remainders, is of relative size 2^-22 and of no fixed sign. The head
// is rounded with integer instructions (add half a place, mask): three
// instructions a value with the subtraction. The conversion instruction
// (cvt.rna.tf32.f32) gives the same errors but runs in a slow pipe: the
// whole kernel measured 1.35 times slower with it. A head cut without the
// rounding is 7% faster still, but then every remainder has its value's
// sign, every product is short by up to 2^-21, and sums that should cancel
// (a key that is the only one its 600 rows see) came out twice as far from
// the plain version. The tensor cores ignore the 13 low bits of a TF32
// operand, and the compiler drops a mask whose only reader is an mma.
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k = t, n = g)         b1 (k = t + 4, n = g)
//   C (16 x 8):      c0 (g, 2t) c1 (g, 2t+1)   c2 (g + 8, 2t) c3 (g + 8, 2t+1)
//
// An accumulator tile becomes the A operand of the next product without a
// shuffle: a sum over k may take its terms in any order, so A's column t is
// given the accumulator's column 2t and A's column t + 4 the column 2t + 1
// (a0 = c0, a1 = c2, a2 = c1, a3 = c3), and B is read with the same
// permutation of its k index (load_b_rows_k).
//
// The tiles. A staged tile holds rows of D floats at a stride of D + 4.
// With that stride the two fragment patterns, (row g, column t) and (row
// 2t, column g), both fall on 32 different banks; the stride keeps rows
// 16-byte aligned for cp.async.

#ifndef APS_TPU_TORCH_CSRC_ATTN_TILES_CUH_
#define APS_TPU_TORCH_CSRC_ATTN_TILES_CUH_

#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_tiles {

constexpr float kLseDead = 1.0e30f;  // lse of a row without a visible key

// row stride, in floats, of a staged tile of D-wide rows
__host__ __device__ constexpr int tile_ld(int D) { return D + 4; }

// key s is visible to query row l: inside the batch entry's keys, inside
// the queries, and not after l under a causal mask (aligned top-left)
__device__ __forceinline__ bool visible(int l, int s, int Tq, int klen,
                                        int causal) {
  return l < Tq && s < klen && (!causal || s <= l);
}

// ---- float32 products from three TF32 products ----

// sign, exponent and the 10 leading bits of the mantissa: a TF32 value;
// half of its last place, added before the cut, rounds to nearest
constexpr uint32_t kTf32Mask = 0xffffe000u;
constexpr uint32_t kTf32Half = 0x00001000u;

// N floats as TF32 heads and TF32 remainders
template <int N>
struct Split {
  uint32_t big[N];
  uint32_t small[N];

  __device__ __forceinline__ void set(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      big[i] = (__float_as_uint(x[i]) + kTf32Half) & kTf32Mask;
      small[i] = __float_as_uint(x[i] - __uint_as_float(big[i])) & kTf32Mask;
    }
  }
};

using FragA = Split<4>;
using FragB = Split<2>;

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[i] += a * b[i] to float32 accuracy, N independent accumulators. The
// three products of one accumulator depend on each other; sent pass by
// pass across the N tiles they overlap in the tensor pipes.
template <int N>
__device__ __forceinline__ void mma_f32(float (&c)[N][4], const FragA& a,
                                        const FragB (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[i], a.small, b[i].big);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[i], a.big, b[i].small);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[i], a.big, b[i].big);
}

// ---- fragment loads from a staged tile (row stride LD) ----

// A = tile[r0 .. r0 + 16, c0 .. c0 + 8]
template <int LD>
__device__ __forceinline__ void load_a(FragA& a, const float* tile, int r0,
                                       int c0, int g, int t) {
  const float* p = tile + (r0 + g) * LD + c0 + t;
  const float x[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
  a.set(x);
}

// an accumulator tile as the A operand (see the note on the k permutation)
__device__ __forceinline__ void acc_as_a(FragA& a, const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  a.set(x);
}

// B[k][n] = tile[n0 + n][k0 + k]: the tile's rows are the product's columns
// (q . k^T with k staged row by row)
template <int LD>
__device__ __forceinline__ void load_b_rows_n(FragB& b, const float* tile,
                                              int n0, int k0, int g, int t) {
  const float* p = tile + (n0 + g) * LD + k0 + t;
  const float x[2] = {p[0], p[4]};
  b.set(x);
}

// B[k][n] = tile[k0 + perm(k)][n0 + n], perm(t) = 2t, perm(t + 4) = 2t + 1:
// the tile's rows are summed over, in the order acc_as_a gives A's columns
template <int LD>
__device__ __forceinline__ void load_b_rows_k(FragB& b, const float* tile,
                                              int k0, int n0, int g, int t) {
  const float* p = tile + (k0 + 2 * t) * LD + n0 + g;
  const float x[2] = {p[0], p[LD]};
  b.set(x);
}

// ---- asynchronous staging ----

// 16 bytes global -> shared; zeros when !valid (src must still be mapped)
__device__ __forceinline__ void cp_async_16(float* dst, const float* src,
                                            bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows [first, first + ROWS) of a (limit x D) matrix -> tile, zeros past
// limit; 16 bytes a thread, neighbouring threads on neighbouring addresses,
// THREADS / (D / 4) rows a pass. first >= 0 and limit >= 1.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows_async(float* tile,
                                                 const float* __restrict__ src,
                                                 int first, int limit,
                                                 int tid) {
  constexpr int LD = tile_ld(D);
  constexpr int kChunks = D / 4;  // 16-byte pieces of a row
  constexpr int kPassRows = THREADS / kChunks;
  static_assert(THREADS % kChunks == 0 && ROWS % kPassRows == 0,
                "a pass of all threads covers whole rows of the tile");
  const int r = tid / kChunks;
  const int c = (tid - r * kChunks) * 4;
  float* dst = tile + r * LD + c;
  const float* from = src + static_cast<size_t>(first + r) * D + c;
#pragma unroll
  for (int i = 0; i < ROWS / kPassRows; ++i) {
    const bool ok = first + r + i * kPassRows < limit;
    cp_async_16(dst + i * kPassRows * LD, ok ? from + i * kPassRows * D : src,
                ok);
  }
}

}  // namespace attn_tiles

#endif  // APS_TPU_TORCH_CSRC_ATTN_TILES_CUH_
