// Building blocks of the tiled kernels for Hopper (sm_90a): float32-accurate
// products on the tensor cores, fragment loads from padded shared-memory
// tiles, asynchronous staging of row tiles, the mask test and the online
// softmax on accumulator fragments. Used by attention.cu (forward),
// attention_bwd.cu (dq, dk/dv), rel_attention_bwd.cu (dq, dpose) and tcn.cu
// (the TCN block's two products).
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
// The tiles. A staged tile holds rows of D floats at a stride of D + 4. A
// head narrower than the tile (stage_rows_ragged, K2 at widths other than
// 16, 32, 64 and 128) is staged at its own row stride in device memory and
// zero-filled to D: the zero columns add nothing to a product.
// With that stride the two fragment patterns, (row g, column t) and (row
// 2t, column g), both fall on 32 different banks; the stride keeps rows
// 16-byte aligned for cp.async. A B operand read as (row t, column g) of a
// k-major tile (load_b_kn) wants a stride of 8 modulo 32 instead. A tile
// that a warp writes from accumulators and reads back as pairs (row g,
// columns 2t and 2t + 1: load_a_acc) wants a stride of 24 modulo 32
// (skew_ld).
//
// The online softmax. Of each 16 x 8 accumulator tile a thread holds rows g
// (c0, c1) and g + 8 (c2, c3), and the four lanes of a group (t = 0..3)
// share those two rows. RowSoftmax keeps, for the two rows, the running
// maximum (reduced across the four lanes with __shfl_xor_sync by 1 and 2,
// so that all four agree) and the thread's own share of the running sum,
// which is reduced across the four lanes once, after the last tile: the
// factor exp(m_old - m_new) that rescales it is the same on all four. A
// row that has seen no visible score keeps the maximum -inf; its p are 0
// and its sum stays 0.

#ifndef APS_TPU_TORCH_CSRC_ATTN_TILES_CUH_
#define APS_TPU_TORCH_CSRC_ATTN_TILES_CUH_

#include <cuda_runtime.h>
#include <math.h>
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

// A = tile[r0 .. r0 + 16, c0 .. c0 + 8] of a tile that holds accumulator
// values, read with acc_as_a's permutation of k (B: load_b_rows_k); two
// float2 loads. LD = 24 mod 32: no bank conflicts.
template <int LD>
__device__ __forceinline__ void load_a_acc(FragA& a, const float* tile,
                                           int r0, int c0, int g, int t) {
  const float2 lo =
      *reinterpret_cast<const float2*>(tile + (r0 + g) * LD + c0 + 2 * t);
  const float2 hi = *reinterpret_cast<const float2*>(
      tile + (r0 + g + 8) * LD + c0 + 2 * t);
  const float x[4] = {lo.x, hi.x, lo.y, hi.y};
  a.set(x);
}

// the stride, in floats, of a tile of at least n columns that a warp writes
// as accumulator pairs and reads with load_a_acc: 24 modulo 32
__host__ __device__ constexpr int skew_ld(int n) {
  return n + ((24 - n) % 32 + 32) % 32;
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

// B[k][n] = tile[k0 + k][n0 + n]: a k-major tile (row stride LD = 8 mod 32)
template <int LD>
__device__ __forceinline__ void load_b_kn(FragB& b, const float* tile, int k0,
                                          int n0, int g, int t) {
  const float* p = tile + (k0 + t) * LD + n0 + g;
  const float x[2] = {p[0], p[4 * LD]};
  b.set(x);
}

// ---- the online softmax of a warp's 16 rows ----

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows g (index 0) and g + 8 (index 1) of a thread; every call is made by
// the whole warp
struct RowSoftmax {
  float m[2];  // running maximum of the visible scores, -inf: none yet
  float l[2];  // this thread's share of the sum of exp(score - m)

  __device__ __forceinline__ void init() {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // x: the scores of a 16 x 8N tile, -inf where masked. Replaced by p =
  // exp(x - m_new); alpha = exp(m_old - m_new) rescales what was summed
  // before (1 while the row has no visible score).
  template <int N>
  __device__ __forceinline__ void update(float (&x)[N][4], float (&alpha)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        mx = fmaxf(mx, fmaxf(x[j][2 * h], x[j][2 * h + 1]));
      }
      mx = quad_max(mx);
      const bool none = mx == -INFINITY;
      alpha[h] = none ? 1.f : __expf(m[h] - mx);
      m[h] = mx;
      float sum = l[h] * alpha[h];
#pragma unroll
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int c = 2 * h; c < 2 * h + 2; ++c) {
          const float p = none ? 0.f : __expf(x[j][c] - mx);
          x[j][c] = p;
          sum += p;
        }
      }
      l[h] = sum;
    }
  }

  // the rows' sums, the same on the four lanes of a group
  __device__ __forceinline__ void finish(float (&sum)[2]) const {
    sum[0] = quad_sum(l[0]);
    sum[1] = quad_sum(l[1]);
  }
};

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

__device__ __forceinline__ void cp_async_8(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
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

// rows [first, first + ROWS) of a (limit x D) matrix -> tile, zeros for
// rows outside [0, limit): first may be negative (a window that starts
// before the matrix) and ROWS need not fill whole passes of all threads
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_window_async(
    float* tile, const float* __restrict__ src, int first, int limit,
    int tid) {
  constexpr int LD = tile_ld(D);
  constexpr int kChunks = D / 4;  // 16-byte pieces of a row
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 4;
    const int row = first + r;
    const bool ok = row >= 0 && row < limit;
    cp_async_16(tile + r * LD + c,
                ok ? src + static_cast<size_t>(row) * D + c : src, ok);
  }
}

// stage_rows_async for a head narrower than the tile it runs in: rows
// [first, first + ROWS) of a (limit x dim) matrix, dim <= D -> tile (row
// stride tile_ld(D)), zeros past limit and in the columns [dim, D), each
// thread at a fixed 4-float piece of a row as in stage_rows_async (where
// the pieces of a row do not divide the threads, as at D = 96, the threads
// stride over the pieces instead). vec (dim % 4 == 0 and src 16-byte
// aligned): 16 bytes a copy; else the rows leave the 16-byte grid and each
// float is a copy of its own (cp_async_4).
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows_ragged(
    float* tile, const float* __restrict__ src, int first, int limit,
    int dim, bool vec, int tid) {
  constexpr int LD = tile_ld(D);
  constexpr int kChunks = D / 4;  // 4-float pieces of a tile row
  // a copy of the piece at column c of a row that starts at from (zeros
  // where the row is past limit or the columns past dim)
  auto piece = [&](float* dst, const float* from, int c, bool live) {
    if (vec) {
      const bool ok = live && c < dim;
      cp_async_16(dst, ok ? from : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = live && c + e < dim;
        cp_async_4(dst + e, ok ? from + e : src, ok);
      }
    }
  };
  if constexpr (THREADS % kChunks != 0) {
    for (int i = tid; i < ROWS * kChunks; i += THREADS) {
      const int r = i / kChunks;
      const int c = (i - r * kChunks) * 4;
      piece(tile + r * LD + c, src + static_cast<size_t>(first + r) * dim + c,
            c, first + r < limit);
    }
  } else {
    constexpr int kPassRows = THREADS / kChunks;
    static_assert(ROWS % kPassRows == 0,
                  "a pass of all threads covers whole rows of the tile");
    const int r = tid / kChunks;
    const int c = (tid - r * kChunks) * 4;
    const float* from = src + static_cast<size_t>(first + r) * dim + c;
    const size_t step = static_cast<size_t>(kPassRows) * dim;
#pragma unroll
    for (int i = 0; i < ROWS / kPassRows; ++i) {
      piece(tile + (r + i * kPassRows) * LD + c, from + i * step, c,
            first + r + i * kPassRows < limit);
    }
  }
}

// rows of a head dim columns wide into tiles built for D, chosen at compile
// time: kRagged false (dim == D, 16-byte aligned rows) is stage_rows_async
// as it is, so a built width compiles to the code it had before the ragged
// variant existed
template <bool kRagged, int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows_of(float* tile,
                                              const float* __restrict__ src,
                                              int first, int limit, int dim,
                                              bool vec, int tid) {
  if constexpr (kRagged) {
    stage_rows_ragged<D, ROWS, THREADS>(tile, src, first, limit, dim, vec,
                                        tid);
  } else {
    stage_rows_async<D, ROWS, THREADS>(tile, src, first, limit, tid);
  }
}

// the tile width a head of dim columns (1 <= dim <= 128) other than 16,
// 32, 64 and 128 runs in (the ragged variant): the next of those, and 96
// for 65 to 96, where the tiles of 128 read 1.29 times the time of a head
// of 128 (their registers spill more at the 255 a thread may have)
__host__ __device__ constexpr int tile_width(int dim) {
  return dim <= 16 ? 16 : dim <= 32 ? 32 : dim <= 64 ? 64 : dim <= 96 ? 96
                                                                     : 128;
}

}  // namespace attn_tiles

#endif  // APS_TPU_TORCH_CSRC_ATTN_TILES_CUH_
