// Flash attention (K2) and flash attention with relative-position scores
// (K3) for heads wider than 128, forward and backward, Hopper (sm_90a),
// float32.
//
// K2's kernels here replace aps_tpu/ops/pallas/attention.py's
// flash_attention (the TPU kernels _fwd_kernel, _dq_kernel and
// _dkv_kernel; its _dbias_kernel is attention_dbias.cu's, at every width)
// at heads over 128, K3's replace
// aps_tpu/ops/pallas/rel_attention.py's flash_attention_rel (_fwd_kernel,
// _dq_kernel, _dkv_kernel, _dpose_kernel) there. The tiled kernels of
// attention.cu, attention_bwd.cu, rel_attention.cu and rel_attention_bwd.cu
// are built for head widths 16, 32, 64 and 128: their tiles sit whole in
// shared memory and their fragments in registers, and at D = 128 a block
// already takes one SM. aps_tpu's kernels take any width, so the wrappers
// send a head over 128 here. Semantics are theirs:
//
//   K2: score[l,s] = q[l] . k[s] * scale (+ bias[h,l,s])
//   K3: score[l,s] = (q_c[l] . k[s] + q_p[l] . pose[hp, s-l+T-1]) * scale
//
// with keys s >= k_len[b] masked, under `causal` also s > l, and a row
// without a visible key giving 0 (lse kLseDead). With p = exp(score - lse),
// dp[l,s] = do[l] . v[s], delta[l] = do[l] . o[l] and
// ds = p (dp - delta) scale:
//
//   dq[l] = sum_s ds k[s]            (K3 also dq_p[l] = sum_s ds pose[..])
//   dk[s] = sum_l ds q[l]            dv[s] = sum_l p do[l]
//   K3 dpose[hp,r]  = sum over b (and h for a shared table) and l of
//                     ds[l, l + r - (T-1)] q_p[l]
//
// What bounds them: 4 (forward), 6 (dq) and 8 (dk/dv) Tq Tk D operations a
// head on a few T D floats: arithmetic, not device memory, as at D <= 128.
//
// K2's forward, dq and dk/dv: the tensor cores, built from attn_tiles.cuh
// as the D <= 128 kernels are (every float32 product as three TF32
// mma.sync m16n8k8 on split operands, cp.async staging, the online softmax
// in registers). A head over 128 does not fit one warp's registers (16 x D
// accumulators, twice for dk/dv) nor a D <= 128 block's shared memory, so:
//
//   - the head is split across the block's two warpgroups. A block of 8
//     warps owns 64 rows (query rows: forward, dq; key rows: dk/dv); warp w
//     owns rows 16 (w % 4).. of them and one half (w / 4) of a span of at
//     most kPass = 256 head columns, at most 128: the per-warp state of the
//     D = 128 kernels. A span of w columns is cut at 8 ceil(w / 16), so
//     both halves hold the same number of 8-column fragments (the columns
//     past D are zeros, staged as such);
//   - the two warps of a row group each form the partial score tile s (and
//     dp in the backward) over their own half and add the other's through
//     shared memory (pair_sync: a named barrier of the two warps). A sum of
//     two floats does not depend on their order, so both warps hold the
//     same bits and run the same softmax: no score is computed twice, and
//     the forward walks the keys once;
//   - up to 256 columns (kStream false) the owned operands are staged once
//     and the other side streams through a two-stage cp.async ring (forward:
//     32 keys a tile; dq, dk/dv: 16 rows a tile, as their owned operands
//     are two); 211 KB of shared memory, one block an SM. A wider head
//     (kStream true) has its output columns cut in passes of 256, a block
//     a pass (the grid's z: ceil(D / 256) blocks a row tile), and each
//     recomputes the scores over spans of 256 columns, staging the owned
//     rows' span beside the streamed rows' at every tile, without overlap
//     of copies and products (such widths are for correctness first);
//   - rows are staged 16 bytes a copy when D % 4 == 0 and the operands are
//     16-byte aligned, else 4 bytes a copy (cp_async_4): no padded copy of
//     an operand for any width;
//   - dq forms delta = do . out over the whole head for its 64 rows, in one
//     fixed order, and writes it for dk/dv (launched after it);
//   - no atomics, every sum in a fixed order: two launches give the same
//     bits.
//
// At D = 256 on an H100 they run at 5.5 to 5.9 times the tensor cores'
// bound for three TF32 passes (PERF.md section 6): one block of 8 warps an
// SM hides little of mma.sync's latency.
//
// K3's forward, dq, dk/dv and dpose: the tensor cores too (k3tc), with the
// relative term of the D <= 128 kernels (rel_attention.cu,
// rel_attention_bwd.cu): entry (l, s) reads pose row s - l + T - 1, so a
// 16-row tile meets a band of 31 pose rows, g = q_p . band^T is formed
// over them (16 x 32) and read back along the diagonal through a skew tile
// in shared memory. Shared memory is where the trouble lies. At D = 256
// k2tc's block (64 owned rows) would stage q_c and q_p (130 KB), a 16-key
// K and V stage (33 KB) and the band of a 64 x 16 tile (79 rows, 80 KB):
// more than the 227 KB a block may take, before any second stage. Of the
// ways out (fewer owned rows; one owned operand streamed per tile; passes
// of 128 columns) the kernels take fewer owned rows, the only one that
// neither restages an operand at every tile from L2 nor splits the head's
// products across passes:
//
//   - a block of 8 warps owns 32 rows (query rows: forward, dq; key rows:
//     dk/dv; table rows: dpose), two row groups of 16, and each row group's
//     four warps take a quarter of a span of at most kPass = 256 columns
//     (at most 64: accumulators of 16 x 64 a warp, half of k2tc's). The
//     four quarters' partial tiles meet in shared memory (sum4, behind a
//     named barrier of the row group), each warp reading all four in the
//     same order, so all four hold the same bits;
//   - the streamed side moves in tiles of 16 rows: K and V (forward, dq),
//     q_c, q_p, do and the row statistics (dk/dv, dpose), through a
//     two-stage cp.async ring; the band, 48 rows for 32 x 16 (dpose: the
//     48 keys of the window a 16-row query tile meets), lives in a ring of
//     16-row chunks, so a tile stages one new chunk. Up to 256 columns the
//     owned rows are staged once, and where a third owned operand has no
//     room (do in dq, v in dk/dv, the pose rows in dpose) each warp holds
//     its 16 x 64 share in registers: 215 to 223 KB, one block an SM. A
//     wider head runs k2tc's passes: a block a pass of 256 output columns
//     (grid z), the scores over spans of 256 staged at every tile, without
//     overlap;
//   - the relative term: a warp forms g over its quarter, adds it along the
//     diagonal to its partial scores (forward, dq) or transposed scores
//     (dk/dv) in its skew tile, and the row group sums the quarters. dq
//     writes ds un-skewed into the same tile for dq_p += dg . band. dpose's
//     content scores q_c . k^T and do . v^T over the window do not depend
//     on the table row: the two warps of a quarter split the window's six
//     fragments into the quarter's tiles, each adds its relative partial
//     pose . q_p^T to the cells its rows read (the two row groups' cells
//     are disjoint), and each warp reads its diagonal summed over the
//     quarters;
//   - dpose sums per-(b, h) partial tables, as rel_attention_bwd.cu does:
//     dpose_sum_kernel adds them over b (and h for a shared table) in one
//     fixed order. No atomics anywhere: two launches give the same bits.
//
// No model of the repo has such a head, so no path launches them.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "attn_tiles.cuh"

namespace {

constexpr float kLseDead = 1.0e30f;     // lse of a row without a visible key
constexpr unsigned kFull = 0xffffffffu;

// Operands of either attention. K2 leaves q_p and pose null (Hp 0) and may
// pass a bias; K3 passes no bias and Tq == Tk == T.
struct Args {
  const float* q;     // B x H x Tq x D (K3: q_c)
  const float* q_p;   // B x H x T x D or null
  const float* k;     // B x H x Tk x D
  const float* v;     // B x H x Tk x D
  const float* pose;  // Hp x (2T-1) x D or null
  const float* bias;  // H x Tq x Tk or null
  const int* k_len;   // B
  const float* dout;  // B x H x Tq x D (backward)
  const float* lse;   // B x H x Tq (backward)
  const float* delta; // B x H x Tq (dk/dv, dpose)
  int B, H, Hp, Tq, Tk, D;
  float scale;
  int causal;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(kFull, x, m);
  return x;
}

// dpose[hp, r, d] = sum over b, then h (all h for Hp == 1, h = hp else) of
// partial[b * H + h, r, d], in that order
__global__ void dpose_sum_kernel(const float* __restrict__ partial, int B,
                                 int H, int Hp, int R, int D,
                                 float* __restrict__ dpose) {
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long per = static_cast<long>(R) * D;
  if (idx >= Hp * per) return;
  const int hp = idx / per;
  const long rd = idx % per;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) {
    if (Hp == 1) {
      for (int h = 0; h < H; ++h)
        acc += partial[(static_cast<long>(b) * H + h) * per + rd];
    } else {
      acc += partial[(static_cast<long>(b) * H + hp) * per + rd];
    }
  }
  dpose[idx] = acc;
}

// ---- K2 on the tensor cores (see the note at the top) ----

namespace k2tc {

using attn_tiles::FragA;
using attn_tiles::FragB;
using attn_tiles::RowSoftmax;
using attn_tiles::acc_as_a;
using attn_tiles::cp_async_16;
using attn_tiles::cp_async_4;
using attn_tiles::cp_async_commit;
using attn_tiles::cp_async_wait;
using attn_tiles::load_a;
using attn_tiles::load_b_rows_k;
using attn_tiles::load_b_rows_n;
using attn_tiles::mma_f32;
using attn_tiles::mma_tf32;

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kOwn = 64;               // owned rows a block, 16 a row group
constexpr int kPass = 256;             // head columns a span: two warps' 128
constexpr int kMaxFrags = kPass / 16;  // 8-column fragments a warp
constexpr int kLd = attn_tiles::tile_ld(kPass);  // staged row stride
constexpr int kFwdKeys = 32;           // keys a forward tile
constexpr int kBwdRows = 16;           // streamed rows a backward tile
constexpr int kMaxSmemBytes = 232448;  // a block's shared memory, sm_90

// floats of dynamic shared memory. Forward: Q, two stages of K and V, the
// row groups' exchange of s. Backward: the two owned operands, two stages
// of the two streamed ones, the streamed rows' lse and delta (dk/dv), the
// owned rows' delta (dq), the exchange of s and dp.
constexpr int kFwdSmemFloats =
    (kOwn + 4 * kFwdKeys) * kLd + kTcWarps * kFwdKeys * 4 * 4;
constexpr int kBwdSmemFloats = (2 * kOwn + 4 * kBwdRows) * kLd +
                               4 * kBwdRows + kOwn +
                               kTcWarps * 2 * kBwdRows * 4 * 4;
static_assert(kFwdSmemFloats * 4 <= kMaxSmemBytes &&
                  kBwdSmemFloats * 4 <= kMaxSmemBytes,
              "a block's tiles fit its shared memory");

// 8-column fragments a warp holds of a span of w head columns
__device__ __forceinline__ int frags_of(int w) { return (w + 15) / 16; }

// rows [first, first + ROWS) of a (limit x D) matrix, columns [c0, c0 +
// ncols) -> tile (row stride kLd), zeros for rows outside [0, limit) (K3's
// bands start before the table) and past D. vec: D % 4 == 0 and src
// 16-byte aligned, 16 bytes a copy; else 4 bytes a copy.
template <int ROWS>
__device__ __forceinline__ void stage(float* tile,
                                      const float* __restrict__ src,
                                      int first, int limit, int D, int c0,
                                      int ncols, bool vec, int tid) {
  if (vec) {
    constexpr int kPieces = kPass / 4;  // 16-byte pieces of a span's row
    constexpr int kStep = kTcThreads / kPieces;
    static_assert(ROWS % kStep == 0, "whole passes of all threads");
    const int c = (tid % kPieces) * 4;
    if (c >= ncols) return;
#pragma unroll
    for (int i = 0; i < ROWS / kStep; ++i) {
      const int r = tid / kPieces + i * kStep;
      const int row = first + r, col = c0 + c;
      const bool ok = row >= 0 && row < limit && col < D;
      cp_async_16(tile + r * kLd + c,
                  ok ? src + static_cast<size_t>(row) * D + col : src, ok);
    }
  } else {
    static_assert(kTcThreads == kPass, "a thread a column of the span");
    const int c = tid;
    if (c >= ncols) return;
    for (int r = 0; r < ROWS; ++r) {
      const int row = first + r, col = c0 + c;
      const bool ok = row >= 0 && row < limit && col < D;
      cp_async_4(tile + r * kLd + c,
                 ok ? src + static_cast<size_t>(row) * D + col : src, ok);
    }
  }
}

// s[j] += A1(rows r0.., columns c0 + 8 kk) . B1(rows 8 j.., the same
// columns)^T over the warp's nf fragments, and with kTwo dp from A2 and
// B2: a warp's partial of the scores over its share of a span
template <int NT, bool kTwo>
__device__ __forceinline__ void partial(float (&s)[NT][4],
                                        float (&dp)[NT][4], const float* a1,
                                        const float* a2, int r0,
                                        const float* b1, const float* b2,
                                        int c0, int nf, int g, int t) {
#pragma unroll 2
  for (int kk = 0; kk < nf; ++kk) {
    const int c = c0 + 8 * kk;
    FragA fa1, fa2;
    FragB fb1[NT], fb2[NT];
    load_a<kLd>(fa1, a1, r0, c, g, t);
    if constexpr (kTwo) load_a<kLd>(fa2, a2, r0, c, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      load_b_rows_n<kLd>(fb1[j], b1, 8 * j, c, g, t);
      if constexpr (kTwo) load_b_rows_n<kLd>(fb2[j], b2, 8 * j, c, g, t);
    }
    mma_f32<NT>(s, fa1, fb1);
    if constexpr (kTwo) mma_f32<NT>(dp, fa2, fb2);
  }
}

// acc[n] += A . B_n for n < nf <= N, B_n[k][c] = tile[k0 + perm(k)][c0 +
// 8 n + c] (load_b_rows_k), eight fragments at a time, the three TF32
// products of mma_f32 sent pass by pass across them
template <int N>
__device__ __forceinline__ void accumulate(float (&acc)[N][4],
                                           const FragA& a, const float* tile,
                                           int k0, int c0, int nf, int g,
                                           int t) {
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += 8) {
    if (n0 >= nf) break;
    FragB b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (n0 + i < nf) {
        load_b_rows_k<kLd>(b[i], tile, k0, c0 + 8 * (n0 + i), g, t);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (n0 + i < nf) mma_tf32(acc[n0 + i], a.small, b[i].big);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (n0 + i < nf) mma_tf32(acc[n0 + i], a.big, b[i].small);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (n0 + i < nf) mma_tf32(acc[n0 + i], a.big, b[i].big);
    }
  }
}

// the two warps (64 threads) of row group rg: barrier 1 + rg (0 is
// __syncthreads')
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + rg), "r"(2 * 32) : "memory");
}

// a warp's tile to its exchange slot, a float a lane: no bank conflicts
template <int NT>
__device__ __forceinline__ void put(const float (&x)[NT][4], float* slot,
                                    int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) slot[(4 * j + c) * 32 + lane] = x[j][c];
  }
}

// x += the other warp's partial from its slot: both warps then hold the
// same sum
template <int NT>
__device__ __forceinline__ void add(float (&x)[NT][4], const float* slot,
                                    int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) x[j][c] += slot[(4 * j + c) * 32 + lane];
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) x[j][c] = 0.f;
  }
}

// rows g and g + 8 of a warp's accumulator tile, times f0 and f1, to rows
// row0.. (those below rows) and columns p0 + c0.. (those below D) of a
// (rows x D) matrix
template <int N>
__device__ __forceinline__ void write_tile(float* __restrict__ dst,
                                           const float (&acc)[N][4],
                                           int row0, int rows, int D, int p0,
                                           int c0, int nf, float f0, float f1,
                                           int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= rows) continue;
    float* at = dst + static_cast<size_t>(row) * D + p0 + c0;
    const float fh = h == 0 ? f0 : f1;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (n >= nf) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (p0 + c0 + col < D) at[col] = acc[n][2 * h + e] * fh;
      }
    }
  }
}

// Forward: a block owns query rows l0.. of head bh and streams the keys in
// tiles of kFwdKeys; writes out (and lse, unless null) as attention.cu does
template <bool kStream>
__global__ void __launch_bounds__(kTcThreads, 1)
    k2_fwd_kernel(Args a, bool vec, float* __restrict__ out,
                  float* __restrict__ lse) {
  constexpr int BK = kFwdKeys;
  constexpr int NT = BK / 8;  // 8-wide fragments across a key tile
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* skv = sq + kOwn * kLd;    // [stage][k, v][BK][kLd]
  float* sx = skv + 4 * BK * kLd;  // [warp][NT * 4][32]

  const int D = a.D;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int l0 = blockIdx.x * kOwn;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % 4, half = warp / 4;
  const int wrow = 16 * rg;  // the warp's first row in the block
  const int row0 = l0 + wrow;
  const float* q_h = a.q + static_cast<size_t>(bh) * a.Tq * D;
  const float* k_h = a.k + static_cast<size_t>(bh) * a.Tk * D;
  const float* v_h = a.v + static_cast<size_t>(bh) * a.Tk * D;
  // the bias is indexed by the head alone: every batch entry reads the same
  const float* bias_h =
      a.bias == nullptr
          ? nullptr
          : a.bias + static_cast<size_t>(bh % a.H) * a.Tq * a.Tk;
  const int klen = min(a.Tk, a.k_len[b]);
  // keys the block's rows can see; the row group's, none after its last
  // row under causal
  int kend = klen;
  if (a.causal) kend = min(kend, l0 + kOwn);
  const int nt = kend > 0 ? (kend + BK - 1) / BK : 0;
  const int wend = a.causal ? min(kend, row0 + 16) : kend;
  float* mine = sx + warp * NT * 4 * 32;
  const float* other = sx + (warp ^ 4) * NT * 4 * 32;
  // the output columns this block writes: with kStream a block a pass of
  // kPass columns (blockIdx.z), each recomputing the scores
  const int pass = blockIdx.z;
  const int p0 = pass * kPass;
  const int pf = frags_of(min(kPass, D - p0));  // fragments a warp holds
  const int pc = half * 8 * pf;  // its first column in the pass
  float o[kMaxFrags][4];
  zero<kMaxFrags>(o);
  RowSoftmax sm;
  sm.init();

  // the row group's scores of key tile s0 from the warp's partial s,
  // scaled and masked; the online softmax; o += p . v over the tile's V
  // rows tv
  auto finish = [&](float (&s)[NT][4], int s0, const float* tv) {
    put<NT>(s, mine, lane);
    pair_sync(rg);
    add<NT>(s, other, lane);
    const int s_hi = s0 + BK - 1;
    const bool inside = bias_h == nullptr && row0 + 15 < a.Tq &&
                        s_hi < klen && (!a.causal || s_hi <= row0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[j][c] * a.scale;
        if (!inside) {
          const int l = row0 + g + 8 * (c / 2);
          const int sk = s0 + 8 * j + 2 * t + (c & 1);
          if (!attn_tiles::visible(l, sk, a.Tq, klen, a.causal)) {
            x = -INFINITY;
          } else if (bias_h != nullptr) {
            x += bias_h[static_cast<size_t>(l) * a.Tk + sk];
          }
        }
        s[j][c] = x;
      }
    }
    float alpha[2];
    sm.update<NT>(s, alpha);
#pragma unroll
    for (int n = 0; n < kMaxFrags; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragA ap;
      acc_as_a(ap, s[j]);
      accumulate(o, ap, tv, 8 * j, pc, pf, g, t);
    }
  };

  if constexpr (!kStream) {
    // Q once; K and V through the two-stage ring, one barrier a tile
    auto stage_kv = [&](int tile, int st) {
      float* dst = skv + st * 2 * BK * kLd;
      stage<BK>(dst, k_h, tile * BK, a.Tk, D, 0, 16 * pf, vec, tid);
      stage<BK>(dst + BK * kLd, v_h, tile * BK, a.Tk, D, 0, 16 * pf, vec, tid);
    };
    stage<kOwn>(sq, q_h, l0, a.Tq, D, 0, 16 * pf, vec, tid);
    if (nt > 0) stage_kv(0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int tile = 0; tile < nt; ++tile) {
      if (tile > 0) {
        // this tile has landed, and every warp is done with the last one
        cp_async_wait<0>();
        __syncthreads();
      }
      if (tile + 1 < nt) {
        stage_kv(tile + 1, (tile + 1) & 1);
        cp_async_commit();
      }
      const int s0 = tile * BK;
      if (s0 >= wend || row0 >= a.Tq) continue;  // the row group sees none
      const float* tk = skv + (tile & 1) * 2 * BK * kLd;
      float s[NT][4];
      zero<NT>(s);
      partial<NT, false>(s, s, sq, nullptr, wrow, tk, nullptr, pc, pf, g,
                         t);
      finish(s, s0, tk + BK * kLd);
    }
  } else {
    // each key tile: the scores over spans of kPass columns, Q's and K's
    // span staged together, V's columns of this pass with the first span
    float* sk = skv;
    float* sv = skv + BK * kLd;
    for (int tile = 0; tile < nt; ++tile) {
      const int s0 = tile * BK;
      const bool on = s0 < wend && row0 < a.Tq;
      float s[NT][4];
      zero<NT>(s);
      for (int sp = 0; sp * kPass < D; ++sp) {
        const int c0 = sp * kPass;
        const int cf = frags_of(min(kPass, D - c0));
        __syncthreads();  // every warp is done with the staged tiles
        stage<kOwn>(sq, q_h, l0, a.Tq, D, c0, 16 * cf, vec, tid);
        stage<BK>(sk, k_h, s0, a.Tk, D, c0, 16 * cf, vec, tid);
        if (sp == 0) stage<BK>(sv, v_h, s0, a.Tk, D, p0, 16 * pf, vec, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (on) {
          partial<NT, false>(s, s, sq, nullptr, wrow, sk, nullptr,
                             half * 8 * cf, cf, g, t);
        }
      }
      if (on) finish(s, s0, sv);
    }
  }

  float sum[2];
  sm.finish(sum);
  write_tile(out + static_cast<size_t>(bh) * a.Tq * D, o, row0, a.Tq, D,
             p0, pc, pf, sum[0] > 0.f ? 1.f / sum[0] : 0.f,
             sum[1] > 0.f ? 1.f / sum[1] : 0.f, g, t);
  if (lse != nullptr && pass == 0 && half == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = row0 + g + 8 * h;
      if (l < a.Tq) {
        lse[static_cast<size_t>(bh) * a.Tq + l] =
            sum[h] > 0.f ? sm.m[h] + logf(sum[h]) : kLseDead;
      }
    }
  }
}

// dq (kDKV false): the block owns query rows own0.. of q and do and streams
// k and v; its tile is s[l,s] with l owned. g1 = dq; it also forms delta
// from do and out and writes it to delta_out.
// dk/dv (kDKV true): the block owns key rows own0.. of k and v and streams
// q, do, lse and delta; its tile is the transposed s[s,l] with s owned.
// g1 = dk, g2 = dv.
template <bool kDKV, bool kStream>
__global__ void __launch_bounds__(kTcThreads, 1)
    k2_bwd_kernel(Args a, bool vec, const float* __restrict__ out,
                  float* __restrict__ delta_out, float* __restrict__ g1,
                  float* __restrict__ g2) {
  constexpr int BS = kBwdRows;
  constexpr int NT = BS / 8;  // 8-wide fragments across the streamed rows
  constexpr int kSlot = NT * 4 * 32;  // floats of one exchanged tile
  extern __shared__ __align__(16) float smem[];
  float* sx1 = smem;                 // owned: q (dq) or k (dk/dv)
  float* sx2 = sx1 + kOwn * kLd;     // owned: do or v
  float* sy = sx2 + kOwn * kLd;      // [stage][k, v or q, do][BS][kLd]
  float* sstat = sy + 4 * BS * kLd;  // dk/dv: [stage][lse, delta][BS]
  float* sdelta = sstat + 4 * BS;    // dq: delta of the owned rows
  float* sx = sdelta + kOwn;         // [warp][s, dp][kSlot]

  const int D = a.D;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int own0 = blockIdx.x * kOwn;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % 4, half = warp / 4;
  const int wrow = 16 * rg;
  const int own_lo = own0 + wrow;  // the warp's first owned row
  const size_t qhead = static_cast<size_t>(bh) * a.Tq * D;
  const size_t khead = static_cast<size_t>(bh) * a.Tk * D;
  const size_t shead = static_cast<size_t>(bh) * a.Tq;
  const float* bias_h =
      a.bias == nullptr
          ? nullptr
          : a.bias + static_cast<size_t>(bh % a.H) * a.Tq * a.Tk;
  const int klen = min(a.Tk, a.k_len[b]);

  const float* x1 = kDKV ? a.k + khead : a.q + qhead;
  const float* x2 = kDKV ? a.v + khead : a.dout + qhead;
  const float* y1 = kDKV ? a.q + qhead : a.k + khead;
  const float* y2 = kDKV ? a.dout + qhead : a.v + khead;
  const int t_own = kDKV ? a.Tk : a.Tq;
  const int t_str = kDKV ? a.Tq : a.Tk;

  // the streamed rows [beg, end) that the owned rows can see. dk/dv: a key
  // block past k_len sees no query (its gradients are exactly 0), and under
  // causal only rows l >= s see key s. dq: keys below k_len, and under
  // causal none after the block's last row.
  int beg = 0, end;
  if (kDKV) {
    end = own0 < klen ? a.Tq : 0;
    if (a.causal) beg = (own0 / BS) * BS;
  } else {
    end = klen;
    if (a.causal) end = min(end, own0 + kOwn);
  }
  const int nt = end > beg ? (end - beg + BS - 1) / BS : 0;
  // the row group sees something of the streamed tile at str0
  auto live = [&](int str0) {
    if (kDKV) return own_lo < klen && (!a.causal || str0 + BS - 1 >= own_lo);
    return own_lo < a.Tq && (!a.causal || str0 <= own_lo + 15);
  };
  float* mine = sx + warp * 2 * kSlot;
  const float* other = sx + (warp ^ 4) * 2 * kSlot;

  auto stage_stats = [&](int r0, int st) {
    if (kDKV && tid < 2 * BS) {
      const int which = tid / BS;  // 0 lse, 1 delta
      const int l = r0 + tid - which * BS;
      const bool ok = l < a.Tq;
      cp_async_4(sstat + st * 2 * BS + tid,
                 (which ? a.delta : a.lse) + shead + (ok ? l : 0), ok);
    }
  };

  // dq: delta = do . out of the owned rows over the whole head, a warp 8
  // rows, its lanes across the head, summed in one fixed order; every pass's
  // block forms the same bits, the first writes them
  auto form_delta = [&]() {
    for (int r = 8 * warp; r < 8 * warp + 8; ++r) {
      const int l = own0 + r;
      float part = 0.f;
      if (l < a.Tq) {
        const float* dorow = a.dout + qhead + static_cast<size_t>(l) * D;
        const float* orow = out + qhead + static_cast<size_t>(l) * D;
        for (int d = lane; d < D; d += 32) part += dorow[d] * orow[d];
      }
      part = warp_sum(part);
      if (lane == 0) {
        sdelta[r] = part;
        if (l < a.Tq && blockIdx.z == 0) delta_out[shead + l] = part;
      }
    }
  };

  // dq: lse and delta of this thread's two rows (g and g + 8 of its warp),
  // after a barrier that follows form_delta
  float row_lse[2] = {kLseDead, kLseDead};
  float row_delta[2] = {0.f, 0.f};
  auto read_row_stats = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wrow + g + 8 * h;
      if (own0 + row < a.Tq) row_lse[h] = a.lse[shead + own0 + row];
      row_delta[h] = sdelta[row];
    }
  };

  float acc1[kMaxFrags][4];  // dq, or dk
  float acc2[kMaxFrags][4];  // dv (dk/dv only)

  // the row group's s and dp of the streamed tile at str0 from the warp's
  // partials; p and ds in place; the gradient products into columns [pc,
  // pc + 8 pf) of the pass, from the tiles ty1 (k; q) and ty2 (do)
  auto finish = [&](float (&s)[NT][4], float (&dp)[NT][4], int str0,
                    const float* ty1, const float* ty2, const float* tstat,
                    int pc, int pf) {
    put<NT>(s, mine, lane);
    put<NT>(dp, mine + kSlot, lane);
    pair_sync(rg);
    add<NT>(s, other, lane);
    add<NT>(dp, other + kSlot, lane);
    const int l_hi = kDKV ? str0 + BS - 1 : own_lo + 15;
    const int l_lo = kDKV ? str0 : own_lo;
    const int s_hi = kDKV ? own_lo + 15 : str0 + BS - 1;
    const bool inside = bias_h == nullptr && l_hi < a.Tq && s_hi < klen &&
                        (!a.causal || s_hi <= l_lo);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c / 2;
        const int col = 8 * j + 2 * t + (c & 1);
        const float row_l = kDKV ? tstat[col] : row_lse[h];
        const float row_d = kDKV ? tstat[BS + col] : row_delta[h];
        float x = s[j][c] * a.scale;
        bool ok = true;
        if (!inside) {
          const int own = own_lo + g + 8 * h;
          const int str = str0 + col;
          const int l = kDKV ? str : own;
          const int sk = kDKV ? own : str;
          ok = attn_tiles::visible(l, sk, a.Tq, klen, a.causal);
          if (ok && bias_h != nullptr) {
            x += bias_h[static_cast<size_t>(l) * a.Tk + sk];
          }
        }
        const float p = ok ? __expf(x - row_l) : 0.f;
        s[j][c] = p;
        dp[j][c] = p * (dp[j][c] - row_d) * a.scale;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragA ads;
      acc_as_a(ads, dp[j]);
      accumulate(acc1, ads, ty1, 8 * j, pc, pf, g, t);
      if constexpr (kDKV) {
        FragA ap;
        acc_as_a(ap, s[j]);
        accumulate(acc2, ap, ty2, 8 * j, pc, pf, g, t);
      }
    }
  };

  auto write = [&](int p0, int pc, int pf) {
    const size_t ohead = kDKV ? khead : qhead;
    write_tile(g1 + ohead, acc1, own_lo, t_own, D, p0, pc, pf, 1.f, 1.f, g,
               t);
    if constexpr (kDKV) {
      write_tile(g2 + ohead, acc2, own_lo, t_own, D, p0, pc, pf, 1.f, 1.f,
                 g, t);
    }
  };

  if constexpr (!kStream) {
    // the owned rows once; the streamed ones through the two-stage ring
    const int nf = frags_of(D);
    const int pc = half * 8 * nf;
    auto stage_stream = [&](int tile, int st) {
      const int r0 = beg + tile * BS;
      float* dst = sy + st * 2 * BS * kLd;
      stage<BS>(dst, y1, r0, t_str, D, 0, 16 * nf, vec, tid);
      stage<BS>(dst + BS * kLd, y2, r0, t_str, D, 0, 16 * nf, vec, tid);
      stage_stats(r0, st);
    };
    stage<kOwn>(sx1, x1, own0, t_own, D, 0, 16 * nf, vec, tid);
    stage<kOwn>(sx2, x2, own0, t_own, D, 0, 16 * nf, vec, tid);
    if (nt > 0) stage_stream(0, 0);
    cp_async_commit();
    if constexpr (!kDKV) form_delta();
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (!kDKV) read_row_stats();
    zero<kMaxFrags>(acc1);
    if constexpr (kDKV) zero<kMaxFrags>(acc2);
    for (int tile = 0; tile < nt; ++tile) {
      if (tile > 0) {
        // this tile has landed, and every warp is done with the last one
        cp_async_wait<0>();
        __syncthreads();
      }
      if (tile + 1 < nt) {
        stage_stream(tile + 1, (tile + 1) & 1);
        cp_async_commit();
      }
      const int str0 = beg + tile * BS;
      if (!live(str0)) continue;
      const int st = tile & 1;
      const float* ty1 = sy + st * 2 * BS * kLd;
      const float* ty2 = ty1 + BS * kLd;
      float s[NT][4], dp[NT][4];
      zero<NT>(s);
      zero<NT>(dp);
      partial<NT, true>(s, dp, sx1, sx2, wrow, ty1, ty2, pc, nf, g, t);
      finish(s, dp, str0, ty1, ty2, sstat + st * 2 * BS, pc, nf);
    }
    write(0, pc, nf);
  } else {
    // each streamed tile: s and dp over spans of kPass columns, the owned
    // rows' span staged beside the streamed rows'; with the first span the
    // streamed rows' columns of this pass and their statistics
    if constexpr (!kDKV) form_delta();
    __syncthreads();
    if constexpr (!kDKV) read_row_stats();
    float* sy1 = sy;  // the span: y1, y2
    float* sy2 = sy + BS * kLd;
    float* sp1 = sy + 2 * BS * kLd;  // the pass: k (dq); q, do (dk/dv)
    float* sp2 = sy + 3 * BS * kLd;
    // the output columns this block writes: a block a pass of kPass
    // columns (blockIdx.z), each recomputing s and dp
    const int pass = blockIdx.z;
    const int p0 = pass * kPass;
    const int pf = frags_of(min(kPass, D - p0));
    const int pc = half * 8 * pf;
    zero<kMaxFrags>(acc1);
    if constexpr (kDKV) zero<kMaxFrags>(acc2);
    for (int tile = 0; tile < nt; ++tile) {
      const int str0 = beg + tile * BS;
      const bool on = live(str0);
      float s[NT][4], dp[NT][4];
      zero<NT>(s);
      zero<NT>(dp);
      for (int sp = 0; sp * kPass < D; ++sp) {
        const int c0 = sp * kPass;
        const int cf = frags_of(min(kPass, D - c0));
        __syncthreads();  // every warp is done with the staged tiles
        stage<kOwn>(sx1, x1, own0, t_own, D, c0, 16 * cf, vec, tid);
        stage<kOwn>(sx2, x2, own0, t_own, D, c0, 16 * cf, vec, tid);
        stage<BS>(sy1, y1, str0, t_str, D, c0, 16 * cf, vec, tid);
        stage<BS>(sy2, y2, str0, t_str, D, c0, 16 * cf, vec, tid);
        if (sp == 0) {
          stage<BS>(sp1, y1, str0, t_str, D, p0, 16 * pf, vec, tid);
          if constexpr (kDKV) {
            stage<BS>(sp2, y2, str0, t_str, D, p0, 16 * pf, vec, tid);
          }
          stage_stats(str0, 0);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (on) {
          partial<NT, true>(s, dp, sx1, sx2, wrow, sy1, sy2, half * 8 * cf,
                            cf, g, t);
        }
      }
      if (on) finish(s, dp, str0, sp1, sp2, sstat, pc, pf);
    }
    write(p0, pc, pf);
  }
}

// A function's attributes belong to a device: set once for each kernel and
// device, at its first launch or query there (setting them twice does no
// harm). The kernels take more than 48 KB of dynamic shared memory, and the
// SM's split between shared memory and L1 goes to shared memory.
constexpr int kMaxDevices = 64;

cudaError_t set_attributes(const void* kernel, int bytes,
                           std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            bytes);
  if (rc != cudaSuccess) return rc;
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributePreferredSharedMemoryCarveout,
                            cudaSharedmemCarveoutMaxShared);
  if (rc == cudaSuccess && known) {
    done[dev].store(true, std::memory_order_release);
  }
  return rc;
}

template <bool kStream>
const void* fwd_fn() {
  return reinterpret_cast<const void*>(k2_fwd_kernel<kStream>);
}

template <bool kDKV, bool kStream>
const void* bwd_fn() {
  return reinterpret_cast<const void*>(k2_bwd_kernel<kDKV, kStream>);
}

template <bool kStream>
cudaError_t fwd_attributes() {
  static std::atomic<bool> done[kMaxDevices];
  return set_attributes(fwd_fn<kStream>(), kFwdSmemFloats * 4, done);
}

template <bool kDKV, bool kStream>
cudaError_t bwd_attributes() {
  static std::atomic<bool> done[kMaxDevices];
  return set_attributes(bwd_fn<kDKV, kStream>(), kBwdSmemFloats * 4, done);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 16-byte copies: every row of every staged operand starts on the 16-byte
// grid (K3's q_p and pose too)
bool vec_rows(const Args& a, const float* out) {
  auto ok = [](const void* p) { return p == nullptr || aligned16(p); };
  return a.D % 4 == 0 && aligned16(a.q) && aligned16(a.k) &&
         aligned16(a.v) && ok(a.q_p) && ok(a.pose) && ok(a.dout) && ok(out);
}

// blocks a row tile: one a pass of kPass columns of the output
int passes(int D) { return (D + kPass - 1) / kPass; }

template <bool kStream>
cudaError_t launch_fwd(const Args& a, float* out, float* lse,
                       cudaStream_t st) {
  const cudaError_t rc = fwd_attributes<kStream>();
  if (rc != cudaSuccess) return rc;
  const dim3 grid((a.Tq + kOwn - 1) / kOwn, a.B * a.H, passes(a.D));
  k2_fwd_kernel<kStream><<<grid, kTcThreads, kFwdSmemFloats * 4, st>>>(
      a, vec_rows(a, nullptr), out, lse);
  return cudaGetLastError();
}

template <bool kDKV, bool kStream>
cudaError_t launch_bwd(const Args& a, const float* out, float* delta_out,
                       float* g1, float* g2, cudaStream_t st) {
  const cudaError_t rc = bwd_attributes<kDKV, kStream>();
  if (rc != cudaSuccess) return rc;
  const dim3 grid(((kDKV ? a.Tk : a.Tq) + kOwn - 1) / kOwn, a.B * a.H,
                  passes(a.D));
  k2_bwd_kernel<kDKV, kStream>
      <<<grid, kTcThreads, kBwdSmemFloats * 4, st>>>(a, vec_rows(a, out),
                                                     out, delta_out, g1, g2);
  return cudaGetLastError();
}

}  // namespace k2tc

// ---- K3 on the tensor cores (see the note at the top) ----

namespace k3tc {

using attn_tiles::FragA;
using attn_tiles::FragB;
using attn_tiles::RowSoftmax;
using attn_tiles::acc_as_a;
using attn_tiles::cp_async_4;
using attn_tiles::cp_async_commit;
using attn_tiles::cp_async_wait;
using attn_tiles::load_a;
using attn_tiles::load_a_acc;
using attn_tiles::load_b_rows_n;
using attn_tiles::mma_f32;
using k2tc::accumulate;
using k2tc::put;
using k2tc::stage;
using k2tc::write_tile;
using k2tc::zero;

constexpr int kWarps3 = 8;
constexpr int kThreads3 = 32 * kWarps3;
constexpr int kQuarters = 4;              // warps a row group
constexpr int kOwn = 16 * kWarps3 / kQuarters;  // owned rows a block: 32
constexpr int kPass = 256;                // head columns a span or a pass
constexpr int kFrags = kPass / 32;        // 8-column fragments a warp: 8
constexpr int kLd = attn_tiles::tile_ld(kPass);  // staged row stride
constexpr int kRows = 16;                 // streamed rows a tile
constexpr int NT = kRows / 8;             // 8-wide fragments across them
constexpr int kBand = 32;                 // band rows a 16 x 16 tile meets
constexpr int NG = kBand / 8;
constexpr int kChunk = 16;                // rows a chunk of a ring
constexpr int kSkewLd = kBand + 8;        // 8 mod 32: two-way conflicts
constexpr int kSlot = 16 * kSkewLd;       // a warp's skew tile / exchange
constexpr int kStagedRows = 192;          // staged rows of any kernel
constexpr int kStatFloats = 64;           // two stages of lse and delta
// dpose: the window of keys a query tile meets, split between the two
// warps of a quarter, and its tiles of content scores and dp a quarter
constexpr int kWin = kOwn + kRows;
constexpr int kWinFrags = kWin / 16;
constexpr int kWinLd = attn_tiles::skew_ld(kWin);
constexpr int kWinFloats = kQuarters * 2 * kRows * kWinLd;
// floats of dynamic shared memory: the staged rows, the row statistics,
// and a skew tile a warp (dpose: the quarters' window tiles)
constexpr int kSmemFloats =
    kStagedRows * kLd + kStatFloats + kWarps3 * kSlot;
constexpr int kPoseSmemFloats = kStagedRows * kLd + kStatFloats + kWinFloats;
static_assert(kSmemFloats * 4 <= k2tc::kMaxSmemBytes &&
                  kPoseSmemFloats * 4 <= k2tc::kMaxSmemBytes,
              "a block's tiles fit its shared memory");
static_assert(2 * NT * 4 * 32 <= kSlot, "two exchanged tiles fit a slot");
static_assert(kThreads3 == kPass, "a thread a column of a 4-byte copy");

// 8-column fragments a warp holds of a span of w head columns: a quarter,
// cut at 32 ceil(w / 32) columns (zeros past D)
__device__ __forceinline__ int frags_of(int w) { return (w + 31) / 32; }

// a warp's A operand held in registers: rows row0 + g and row0 + g + 8 of
// a (limit x D) matrix at columns c + 8 kk + t and + 4 (load_a's pattern),
// kk < nf, read once from device memory; zeros outside
__device__ __forceinline__ void hold(float (&h)[kFrags][4],
                                     const float* __restrict__ src, int row0,
                                     int limit, int D, int c, int nf, int g,
                                     int t) {
#pragma unroll
  for (int kk = 0; kk < kFrags; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e & 1);
      const int col = c + 8 * kk + t + 4 * (e >> 1);
      h[kk][e] = kk < nf && row < limit && col < D
                     ? src[static_cast<size_t>(row) * D + col]
                     : 0.f;
    }
  }
}

// x[j] += A . B_j^T over the warp's nf fragments of columns c..: A the 16
// rows at a (stride kLd), B_j the 8 rows at b[j]
template <int N>
__device__ __forceinline__ void dot_rows(float (&x)[N][4], const float* a,
                                         const float* const (&b)[N], int c,
                                         int nf, int g, int t) {
#pragma unroll 2
  for (int kk = 0; kk < nf; ++kk) {
    const int col = c + 8 * kk;
    FragA fa;
    FragB fb[N];
    load_a<kLd>(fa, a, 0, col, g, t);
#pragma unroll
    for (int j = 0; j < N; ++j) load_b_rows_n<kLd>(fb[j], b[j], 0, col, g, t);
    mma_f32<N>(x, fa, fb);
  }
}

// the same with A held in registers (hold)
template <int N>
__device__ __forceinline__ void dot_held(float (&x)[N][4],
                                         const float (&h)[kFrags][4],
                                         const float* const (&b)[N], int c,
                                         int nf, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kFrags; ++kk) {
    if (kk >= nf) break;
    const int col = c + 8 * kk;
    FragA fa;
    FragB fb[N];
    fa.set(h[kk]);
#pragma unroll
    for (int j = 0; j < N; ++j) load_b_rows_n<kLd>(fb[j], b[j], 0, col, g, t);
    mma_f32<N>(x, fa, fb);
  }
}

// a warp's 16 x kBand accumulator tile to its skew tile (stride kSkewLd)
__device__ __forceinline__ void put_skew(const float (&x)[NG][4], float* sk,
                                         int g, int t) {
#pragma unroll
  for (int j = 0; j < NG; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(sk + (g + 8 * h) * kSkewLd + 8 * j + 2 * t) =
          make_float2(x[j][2 * h], x[j][2 * h + 1]);
    }
  }
}

// the four warps (128 threads) of row group rg: barrier 1 + rg (0 is
// __syncthreads')
__device__ __forceinline__ void group_sync(int rg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + rg), "r"(kQuarters * 32)
               : "memory");
}

// the two warps (64 threads) of quarter qt: barriers 1 + qt (dpose)
__device__ __forceinline__ void quarter_sync(int qt) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + qt), "r"(2 * 32) : "memory");
}

// x = the sum of the row group's four partials, read from their slots in
// the order of the warps: every warp of the group holds the same bits
template <int N>
__device__ __forceinline__ void sum4(float (&x)[N][4], const float* group,
                                     int lane) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = (4 * j + c) * 32 + lane;
      x[j][c] = ((group[i] + group[kSlot + i]) + group[2 * kSlot + i]) +
                group[3 * kSlot + i];
    }
  }
}

// Where a thread sits: warp w takes rows 16 rg.. of the block's kOwn and
// quarter qt of each span
struct Place {
  int tid, lane, warp, g, t, rg, qt, wrow;
  __device__ __forceinline__ Place()
      : tid(threadIdx.x),
        lane(tid % 32),
        warp(tid / 32),
        g(lane / 4),
        t(lane % 4),
        rg(warp / kQuarters),
        qt(warp % kQuarters),
        wrow(16 * (warp / kQuarters)) {}
};

// Forward: a block owns query rows l0.. of head bh and streams the keys in
// tiles of kRows with the kOwn + kRows pose rows a tile meets (the band):
// up to 256 columns q_c and q_p are staged once, K and V through a
// two-stage ring, the band through a ring of kChunk-row chunks (a tile
// stages one new chunk); a wider head a block a pass of kPass output
// columns (blockIdx.z), its scores over spans of kPass columns staged at
// every tile. Writes out (and lse, unless null) as rel_attention.cu does.
template <bool kStream>
__global__ void __launch_bounds__(kThreads3, 1)
    k3_fwd_kernel(Args a, bool vec, float* __restrict__ out,
                  float* __restrict__ lse) {
  extern __shared__ __align__(16) float smem[];
  float* slots = smem + kStagedRows * kLd + kStatFloats;
  const Place w;
  const int D = a.D, T = a.Tq, P = 2 * T - 1;
  const int bh = blockIdx.y, b = bh / a.H;
  const int hp = a.Hp == 1 ? 0 : bh % a.H;
  const int l0 = blockIdx.x * kOwn;
  const int row0 = l0 + w.wrow;  // the warp's first row
  const size_t head = static_cast<size_t>(bh) * T * D;
  const float* pose_h = a.pose + static_cast<size_t>(hp) * P * D;
  const int klen = min(T, a.k_len[b]);
  // keys the block's rows can see; the row group's, none after its last
  // row under causal
  int kend = klen;
  if (a.causal) kend = min(kend, l0 + kOwn);
  const int nt = kend > 0 ? (kend + kRows - 1) / kRows : 0;
  const int wend = a.causal ? min(kend, row0 + 16) : kend;
  // key tile s0 meets pose rows s0 + band0 .. (band row i): entry (row0 +
  // li, s0 + sj) reads band row kOwn - 16 - wrow + (sj - li + 15)
  const int band0 = T - kOwn - l0;
  const int wband = kOwn - 16 - w.wrow;  // the warp's first band row
  float* slot = slots + w.warp * kSlot;
  const float* group = slots + kQuarters * w.rg * kSlot;
  const int pass = blockIdx.z;
  const int p0 = pass * kPass;
  const int pf = frags_of(min(kPass, D - p0));  // fragments a warp holds
  const int pc = w.qt * 8 * pf;  // its first column in the pass
  float o[kFrags][4];
  zero<kFrags>(o);
  RowSoftmax sm;
  sm.init();

  // the row group's scores of key tile s0: the warp's partial s plus its
  // partial relative term g read along the diagonal, summed over the four
  // quarters; scaled and masked; the online softmax; o += p . v over the
  // tile's V rows tv
  auto finish = [&](float (&s)[NT][4], const float (&gq)[NG][4], int s0,
                    const float* tv) {
    put_skew(gq, slot, w.g, w.t);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int li = w.g + 8 * (c / 2);
        const int sj = 8 * j + 2 * w.t + (c & 1);
        s[j][c] += slot[li * kSkewLd + sj - li + 15];
      }
    }
    __syncwarp();
    put<NT>(s, slot, w.lane);
    group_sync(w.rg);
    sum4<NT>(s, group, w.lane);
    const int s_hi = s0 + kRows - 1;
    const bool inside =
        row0 + 15 < T && s_hi < klen && (!a.causal || s_hi <= row0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[j][c] * a.scale;
        if (!inside) {
          const int l = row0 + w.g + 8 * (c / 2);
          const int sk = s0 + 8 * j + 2 * w.t + (c & 1);
          if (!attn_tiles::visible(l, sk, T, klen, a.causal)) x = -INFINITY;
        }
        s[j][c] = x;
      }
    }
    float alpha[2];
    sm.update<NT>(s, alpha);
#pragma unroll
    for (int n = 0; n < kFrags; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragA ap;
      acc_as_a(ap, s[j]);
      accumulate(o, ap, tv, 8 * j, pc, pf, w.g, w.t);
    }
  };

  if constexpr (!kStream) {
    const int ncols = 32 * pf;
    float* sqc = smem;
    float* sqp = sqc + kOwn * kLd;
    float* skv = sqp + kOwn * kLd;       // [stage][k, v][kRows][kLd]
    float* sband = skv + 4 * kRows * kLd;  // [4 chunks][kChunk][kLd]
    auto chunk = [&](int m) { return sband + (m % 4) * kChunk * kLd; };
    auto stage_tile = [&](int tile) {
      float* dst = skv + (tile & 1) * 2 * kRows * kLd;
      stage<kRows>(dst, a.k + head, tile * kRows, T, D, 0, ncols, vec, w.tid);
      stage<kRows>(dst + kRows * kLd, a.v + head, tile * kRows, T, D, 0,
                   ncols, vec, w.tid);
      // the chunk the tile's band ends with
      stage<kChunk>(chunk(tile + 2), pose_h, band0 + kChunk * (tile + 2), P,
                    D, 0, ncols, vec, w.tid);
    };
    stage<kOwn>(sqc, a.q + head, l0, T, D, 0, ncols, vec, w.tid);
    stage<kOwn>(sqp, a.q_p + head, l0, T, D, 0, ncols, vec, w.tid);
    if (nt > 0) {
      stage<kChunk>(chunk(0), pose_h, band0, P, D, 0, ncols, vec, w.tid);
      stage<kChunk>(chunk(1), pose_h, band0 + kChunk, P, D, 0, ncols, vec,
                    w.tid);
      stage_tile(0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int tile = 0; tile < nt; ++tile) {
      if (tile > 0) {
        // this tile has landed, and every warp is done with the last one
        cp_async_wait<0>();
        __syncthreads();
      }
      if (tile + 1 < nt) {
        stage_tile(tile + 1);
        cp_async_commit();
      }
      const int s0 = tile * kRows;
      if (s0 >= wend || row0 >= T) continue;  // the row group sees none
      const float* tk = skv + (tile & 1) * 2 * kRows * kLd;
      float s[NT][4], gq[NG][4];
      zero<NT>(s);
      zero<NG>(gq);
      const float* kb[NT] = {tk, tk + 8 * kLd};
      dot_rows<NT>(s, sqc + w.wrow * kLd, kb, pc, pf, w.g, w.t);
      const float* bb[NG];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int r = wband + 8 * j;
        bb[j] = chunk(tile + r / kChunk) + (r % kChunk) * kLd;
      }
      dot_rows<NG>(gq, sqp + w.wrow * kLd, bb, pc, pf, w.g, w.t);
      finish(s, gq, s0, tk + kRows * kLd);
    }
  } else {
    // each key tile: the scores over spans of kPass columns, q_c's, q_p's,
    // K's and the band's span staged together; then V's columns of this
    // pass
    float* sqc = smem;
    float* sqp = sqc + kOwn * kLd;
    float* sk = sqp + kOwn * kLd;
    float* sband = sk + kRows * kLd;  // 3 chunks
    float* sv = smem;
    for (int tile = 0; tile < nt; ++tile) {
      const int s0 = tile * kRows;
      const bool on = s0 < wend && row0 < T;
      float s[NT][4], gq[NG][4];
      zero<NT>(s);
      zero<NG>(gq);
      for (int sp = 0; sp * kPass < D; ++sp) {
        const int c0 = sp * kPass;
        const int cf = frags_of(min(kPass, D - c0));
        __syncthreads();  // every warp is done with the staged tiles
        stage<kOwn>(sqc, a.q + head, l0, T, D, c0, 32 * cf, vec, w.tid);
        stage<kOwn>(sqp, a.q_p + head, l0, T, D, c0, 32 * cf, vec, w.tid);
        stage<kRows>(sk, a.k + head, s0, T, D, c0, 32 * cf, vec, w.tid);
        stage<3 * kChunk>(sband, pose_h, band0 + s0, P, D, c0, 32 * cf, vec,
                          w.tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (on) {
          const float* kb[NT] = {sk, sk + 8 * kLd};
          const float* bb[NG] = {sband + wband * kLd,
                                 sband + (wband + 8) * kLd,
                                 sband + (wband + 16) * kLd,
                                 sband + (wband + 24) * kLd};
          dot_rows<NT>(s, sqc + w.wrow * kLd, kb, w.qt * 8 * cf, cf, w.g,
                       w.t);
          dot_rows<NG>(gq, sqp + w.wrow * kLd, bb, w.qt * 8 * cf, cf, w.g,
                       w.t);
        }
      }
      __syncthreads();
      stage<kRows>(sv, a.v + head, s0, T, D, p0, 32 * pf, vec, w.tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (on) finish(s, gq, s0, sv);
    }
  }

  float sum[2];
  sm.finish(sum);
  write_tile(out + head, o, row0, T, D, p0, pc, pf,
             sum[0] > 0.f ? 1.f / sum[0] : 0.f,
             sum[1] > 0.f ? 1.f / sum[1] : 0.f, w.g, w.t);
  if (lse != nullptr && pass == 0 && w.qt == 0 && w.t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = row0 + w.g + 8 * h;
      if (l < T) {
        lse[static_cast<size_t>(bh) * T + l] =
            sum[h] > 0.f ? sm.m[h] + logf(sum[h]) : kLseDead;
      }
    }
  }
}

// dq_c and dq_p of the block's query rows l0..; also delta = do . out of
// those rows, written to delta_out. K, V and the band stream as in the
// forward; do is held in registers (up to 256 columns), as shared memory
// has no room for a third owned operand beside the two rings.
template <bool kStream>
__global__ void __launch_bounds__(kThreads3, 1)
    k3_dq_kernel(Args a, bool vec, const float* __restrict__ out,
                 float* __restrict__ delta_out, float* __restrict__ dq_c,
                 float* __restrict__ dq_p) {
  extern __shared__ __align__(16) float smem[];
  float* sdelta = smem + kStagedRows * kLd;
  float* slots = sdelta + kStatFloats;
  const Place w;
  const int D = a.D, T = a.Tq, P = 2 * T - 1;
  const int bh = blockIdx.y, b = bh / a.H;
  const int hp = a.Hp == 1 ? 0 : bh % a.H;
  const int l0 = blockIdx.x * kOwn;
  const int row0 = l0 + w.wrow;
  const size_t head = static_cast<size_t>(bh) * T * D;
  const size_t shead = static_cast<size_t>(bh) * T;
  const float* pose_h = a.pose + static_cast<size_t>(hp) * P * D;
  const int klen = min(T, a.k_len[b]);
  int kend = klen;
  if (a.causal) kend = min(kend, l0 + kOwn);
  const int nt = kend > 0 ? (kend + kRows - 1) / kRows : 0;
  const int band0 = T - kOwn - l0;
  const int wband = kOwn - 16 - w.wrow;
  float* slot = slots + w.warp * kSlot;
  const float* group = slots + kQuarters * w.rg * kSlot;
  const int pass = blockIdx.z;
  const int p0 = pass * kPass;
  const int pf = frags_of(min(kPass, D - p0));
  const int pc = w.qt * 8 * pf;
  // the row group sees something of key tile s0
  auto live = [&](int s0) {
    return row0 < T && (!a.causal || s0 <= row0 + 15);
  };

  // delta = do . out of the owned rows over the whole head, a warp 4 rows,
  // its lanes across the head, summed in one fixed order; every pass's
  // block forms the same bits, the first writes them
  for (int r = 4 * w.warp; r < 4 * w.warp + 4; ++r) {
    const int l = l0 + r;
    float part = 0.f;
    if (l < T) {
      const float* dorow = a.dout + head + static_cast<size_t>(l) * D;
      const float* orow = out + head + static_cast<size_t>(l) * D;
      for (int d = w.lane; d < D; d += 32) part += dorow[d] * orow[d];
    }
    part = warp_sum(part);
    if (w.lane == 0) {
      sdelta[r] = part;
      if (l < T && pass == 0) delta_out[shead + l] = part;
    }
  }
  __syncthreads();
  float row_lse[2] = {kLseDead, kLseDead};
  float row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w.wrow + w.g + 8 * h;
    if (l0 + row < T) row_lse[h] = a.lse[shead + l0 + row];
    row_delta[h] = sdelta[row];
  }

  float acc_c[kFrags][4], acc_p[kFrags][4];
  zero<kFrags>(acc_c);
  zero<kFrags>(acc_p);

  // the row group's s and dp of key tile s0 from the warp's partials (the
  // relative term g folded into s along the diagonal); p and ds in place;
  // dq_c += ds . k over the tile's K rows tk, dq_p += dg . band with dg the
  // un-skewed ds and bb the band's fragments
  auto finish = [&](float (&s)[NT][4], float (&dp)[NT][4],
                    const float (&gq)[NG][4], int s0, const float* tk,
                    const float* const (&bb)[NG]) {
    put_skew(gq, slot, w.g, w.t);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int li = w.g + 8 * (c / 2);
        const int sj = 8 * j + 2 * w.t + (c & 1);
        s[j][c] += slot[li * kSkewLd + sj - li + 15];
      }
    }
    __syncwarp();
    put<NT>(s, slot, w.lane);
    put<NT>(dp, slot + NT * 4 * 32, w.lane);
    group_sync(w.rg);
    sum4<NT>(s, group, w.lane);
    sum4<NT>(dp, group + NT * 4 * 32, w.lane);
    group_sync(w.rg);  // the group is done with the slots
    const int s_hi = s0 + kRows - 1;
    const bool inside =
        row0 + 15 < T && s_hi < klen && (!a.causal || s_hi <= row0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c / 2;
        bool ok = true;
        if (!inside) {
          ok = attn_tiles::visible(row0 + w.g + 8 * h,
                                   s0 + 8 * j + 2 * w.t + (c & 1), T, klen,
                                   a.causal);
        }
        const float p = ok ? __expf(s[j][c] * a.scale - row_lse[h]) : 0.f;
        dp[j][c] = p * (dp[j][c] - row_delta[h]) * a.scale;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragA ads;
      acc_as_a(ads, dp[j]);
      accumulate(acc_c, ads, tk, 8 * j, pc, pf, w.g, w.t);
    }
    // dg[li][sj - li + 15] = ds[li][sj], zeros in the 16 other columns of
    // each row, [0, 15 - li) and [31 - li, 32)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int li = w.g + 8 * (c / 2);
        const int sj = 8 * j + 2 * w.t + (c & 1);
        slot[li * kSkewLd + sj - li + 15] = dp[j][c];
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = w.lane * 8 + i;
      const int li = e / 16;
      const int k = e % 16;
      slot[li * kSkewLd + (k < 15 - li ? k : k + kRows)] = 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      FragA adg;
      load_a_acc<kSkewLd>(adg, slot, 0, 8 * j, w.g, w.t);
      accumulate(acc_p, adg, bb[j], 0, pc, pf, w.g, w.t);
    }
  };

  if constexpr (!kStream) {
    const int ncols = 32 * pf;
    float* sqc = smem;
    float* sqp = sqc + kOwn * kLd;
    float* skv = sqp + kOwn * kLd;       // [stage][k, v][kRows][kLd]
    float* sband = skv + 4 * kRows * kLd;  // [4 chunks][kChunk][kLd]
    auto chunk = [&](int m) { return sband + (m % 4) * kChunk * kLd; };
    auto stage_tile = [&](int tile) {
      float* dst = skv + (tile & 1) * 2 * kRows * kLd;
      stage<kRows>(dst, a.k + head, tile * kRows, T, D, 0, ncols, vec, w.tid);
      stage<kRows>(dst + kRows * kLd, a.v + head, tile * kRows, T, D, 0,
                   ncols, vec, w.tid);
      stage<kChunk>(chunk(tile + 2), pose_h, band0 + kChunk * (tile + 2), P,
                    D, 0, ncols, vec, w.tid);
    };
    float hdo[kFrags][4];  // the warp's do, held
    hold(hdo, a.dout + head, row0, T, D, pc, pf, w.g, w.t);
    stage<kOwn>(sqc, a.q + head, l0, T, D, 0, ncols, vec, w.tid);
    stage<kOwn>(sqp, a.q_p + head, l0, T, D, 0, ncols, vec, w.tid);
    if (nt > 0) {
      stage<kChunk>(chunk(0), pose_h, band0, P, D, 0, ncols, vec, w.tid);
      stage<kChunk>(chunk(1), pose_h, band0 + kChunk, P, D, 0, ncols, vec,
                    w.tid);
      stage_tile(0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int tile = 0; tile < nt; ++tile) {
      if (tile > 0) {
        cp_async_wait<0>();
        __syncthreads();
      }
      if (tile + 1 < nt) {
        stage_tile(tile + 1);
        cp_async_commit();
      }
      const int s0 = tile * kRows;
      if (!live(s0)) continue;
      const float* tk = skv + (tile & 1) * 2 * kRows * kLd;
      const float* tv = tk + kRows * kLd;
      float s[NT][4], dp[NT][4], gq[NG][4];
      zero<NT>(s);
      zero<NT>(dp);
      zero<NG>(gq);
      const float* kb[NT] = {tk, tk + 8 * kLd};
      const float* vb[NT] = {tv, tv + 8 * kLd};
      const float* bb[NG];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int r = wband + 8 * j;
        bb[j] = chunk(tile + r / kChunk) + (r % kChunk) * kLd;
      }
      dot_rows<NT>(s, sqc + w.wrow * kLd, kb, pc, pf, w.g, w.t);
      dot_held<NT>(dp, hdo, vb, pc, pf, w.g, w.t);
      dot_rows<NG>(gq, sqp + w.wrow * kLd, bb, pc, pf, w.g, w.t);
      finish(s, dp, gq, s0, tk, bb);
    }
  } else {
    // each key tile: s, dp and g over spans of kPass columns, the owned
    // rows' span staged beside the streamed rows'; then K's and the band's
    // columns of this pass
    float* sqc = smem;
    float* sqp = sqc + kOwn * kLd;
    float* sdo = sqp + kOwn * kLd;
    float* sk = sdo + kOwn * kLd;
    float* sv = sk + kRows * kLd;
    float* sband = sv + kRows * kLd;  // 3 chunks
    float* pk = smem;                 // the pass: K, then the band
    float* pband = pk + kRows * kLd;
    for (int tile = 0; tile < nt; ++tile) {
      const int s0 = tile * kRows;
      const bool on = live(s0);
      float s[NT][4], dp[NT][4], gq[NG][4];
      zero<NT>(s);
      zero<NT>(dp);
      zero<NG>(gq);
      for (int sp = 0; sp * kPass < D; ++sp) {
        const int c0 = sp * kPass;
        const int cf = frags_of(min(kPass, D - c0));
        const int nc = 32 * cf;
        __syncthreads();
        stage<kOwn>(sqc, a.q + head, l0, T, D, c0, nc, vec, w.tid);
        stage<kOwn>(sqp, a.q_p + head, l0, T, D, c0, nc, vec, w.tid);
        stage<kOwn>(sdo, a.dout + head, l0, T, D, c0, nc, vec, w.tid);
        stage<kRows>(sk, a.k + head, s0, T, D, c0, nc, vec, w.tid);
        stage<kRows>(sv, a.v + head, s0, T, D, c0, nc, vec, w.tid);
        stage<3 * kChunk>(sband, pose_h, band0 + s0, P, D, c0, nc, vec,
                          w.tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (on) {
          const float* kb[NT] = {sk, sk + 8 * kLd};
          const float* vb[NT] = {sv, sv + 8 * kLd};
          const float* bb[NG] = {sband + wband * kLd,
                                 sband + (wband + 8) * kLd,
                                 sband + (wband + 16) * kLd,
                                 sband + (wband + 24) * kLd};
          const int c = w.qt * 8 * cf;
          dot_rows<NT>(s, sqc + w.wrow * kLd, kb, c, cf, w.g, w.t);
          dot_rows<NT>(dp, sdo + w.wrow * kLd, vb, c, cf, w.g, w.t);
          dot_rows<NG>(gq, sqp + w.wrow * kLd, bb, c, cf, w.g, w.t);
        }
      }
      __syncthreads();
      stage<kRows>(pk, a.k + head, s0, T, D, p0, 32 * pf, vec, w.tid);
      stage<3 * kChunk>(pband, pose_h, band0 + s0, P, D, p0, 32 * pf, vec,
                        w.tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (on) {
        const float* bb[NG] = {pband + wband * kLd, pband + (wband + 8) * kLd,
                               pband + (wband + 16) * kLd,
                               pband + (wband + 24) * kLd};
        finish(s, dp, gq, s0, pk, bb);
      }
    }
  }
  write_tile(dq_c + head, acc_c, row0, T, D, p0, pc, pf, 1.f, 1.f, w.g, w.t);
  write_tile(dq_p + head, acc_p, row0, T, D, p0, pc, pf, 1.f, 1.f, w.g, w.t);
}

// dk and dv of the block's key rows own0.. (zeros past k_len). A query tile
// of kRows rows streams through a two-stage ring with q_c, q_p, do, lse
// and delta, the kOwn + kRows pose rows the block's keys meet through a
// ring of chunks; k is staged once and v held in registers (up to 256
// columns). Each warp forms the transposed tiles k . q_c^T and v . do^T
// and its relative term g = q_p . band^T, read back along the diagonal.
template <bool kStream>
__global__ void __launch_bounds__(kThreads3, 1)
    k3_dkv_kernel(Args a, bool vec, float* __restrict__ dk,
                  float* __restrict__ dv) {
  extern __shared__ __align__(16) float smem[];
  float* sstat = smem + kStagedRows * kLd;  // [stage][lse, delta][kRows]
  float* slots = sstat + kStatFloats;
  const Place w;
  const int D = a.D, T = a.Tq, P = 2 * T - 1;
  const int bh = blockIdx.y, b = bh / a.H;
  const int hp = a.Hp == 1 ? 0 : bh % a.H;
  const int own0 = blockIdx.x * kOwn;
  const int sw = own0 + w.wrow;  // the warp's first key row
  const size_t head = static_cast<size_t>(bh) * T * D;
  const size_t shead = static_cast<size_t>(bh) * T;
  const float* pose_h = a.pose + static_cast<size_t>(hp) * P * D;
  const int klen = min(T, a.k_len[b]);
  // the query tiles the block's keys can see: none past k_len (their
  // gradients are exactly 0), under causal from the tile of row own0 on
  const int beg = a.causal ? own0 : 0;
  const int end = own0 < klen ? T : 0;
  const int nt = end > beg ? (end - beg + kRows - 1) / kRows : 0;
  // query tile n (rows beg + kRows n ..) meets pose rows band0 - kRows n ..
  // (band row i): entry (sw + sj, l0 + li) reads band row wrow + (sj - li +
  // 15)
  const int band0 = own0 - beg + T - kRows;
  float* slot = slots + w.warp * kSlot;
  const float* group = slots + kQuarters * w.rg * kSlot;
  const int pass = blockIdx.z;
  const int p0 = pass * kPass;
  const int pf = frags_of(min(kPass, D - p0));
  const int pc = w.qt * 8 * pf;
  auto live = [&](int l0) {
    return sw < klen && !(a.causal && sw > l0 + kRows - 1);
  };
  auto stage_stats = [&](int l0, float* dst) {
    if (w.tid < 2 * kRows) {
      const int which = w.tid / kRows;  // 0 lse, 1 delta
      const int l = l0 + w.tid - which * kRows;
      const bool ok = l < T;
      cp_async_4(dst + w.tid, (which ? a.delta : a.lse) + shead + (ok ? l : 0),
                 ok);
    }
  };

  float acc_k[kFrags][4], acc_v[kFrags][4];
  zero<kFrags>(acc_k);
  zero<kFrags>(acc_v);

  // the row group's s^T and dp^T of query tile l0 from the warp's partials
  // (g folded into s^T along the diagonal); p^T and ds^T in place; dv +=
  // p^T . do, dk += ds^T . q_c over the tile's rows tdo and tqc
  auto finish = [&](float (&s)[NT][4], float (&dp)[NT][4],
                    const float (&gq)[NG][4], int l0, const float* tqc,
                    const float* tdo, const float* tstat) {
    put_skew(gq, slot, w.g, w.t);  // g[li][j], li the query
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int sj = w.g + 8 * (c / 2);
        const int li = 8 * j + 2 * w.t + (c & 1);
        s[j][c] += slot[li * kSkewLd + sj - li + 15];
      }
    }
    __syncwarp();
    put<NT>(s, slot, w.lane);
    put<NT>(dp, slot + NT * 4 * 32, w.lane);
    group_sync(w.rg);
    sum4<NT>(s, group, w.lane);
    sum4<NT>(dp, group + NT * 4 * 32, w.lane);
    const bool inside = l0 + kRows - 1 < T && sw + 15 < klen &&
                        (!a.causal || sw + 15 <= l0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int sj = w.g + 8 * (c / 2);
        const int li = 8 * j + 2 * w.t + (c & 1);
        bool ok = true;
        if (!inside) {
          ok = attn_tiles::visible(l0 + li, sw + sj, T, klen, a.causal);
        }
        const float p = ok ? __expf(s[j][c] * a.scale - tstat[li]) : 0.f;
        s[j][c] = p;
        dp[j][c] = p * (dp[j][c] - tstat[kRows + li]) * a.scale;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragA ap, ads;
      acc_as_a(ap, s[j]);
      accumulate(acc_v, ap, tdo, 8 * j, pc, pf, w.g, w.t);
      acc_as_a(ads, dp[j]);
      accumulate(acc_k, ads, tqc, 8 * j, pc, pf, w.g, w.t);
    }
  };

  if constexpr (!kStream) {
    const int ncols = 32 * pf;
    constexpr int kStage = 3 * kRows * kLd;  // q_c, q_p, do
    float* sk = smem;
    float* sring = sk + kOwn * kLd;          // [stage][q_c, q_p, do]
    float* sband = sring + 2 * kStage;       // [4 chunks][kChunk][kLd]
    // band chunk m (rows band0 + kChunk m ..; m <= 2, the ring moves down)
    auto chunk = [&](int m) {
      return sband + (((m % 4) + 4) % 4) * kChunk * kLd;
    };
    auto stage_tile = [&](int tile) {
      const int l0 = beg + tile * kRows;
      float* dst = sring + (tile & 1) * kStage;
      stage<kRows>(dst, a.q + head, l0, T, D, 0, ncols, vec, w.tid);
      stage<kRows>(dst + kRows * kLd, a.q_p + head, l0, T, D, 0, ncols, vec,
                   w.tid);
      stage<kRows>(dst + 2 * kRows * kLd, a.dout + head, l0, T, D, 0, ncols,
                   vec, w.tid);
      stage_stats(l0, sstat + (tile & 1) * 2 * kRows);
      // the chunk the tile's band starts with
      stage<kChunk>(chunk(-tile), pose_h, band0 - kChunk * tile, P, D, 0,
                    ncols, vec, w.tid);
    };
    float hv[kFrags][4];  // the warp's v, held
    hold(hv, a.v + head, sw, T, D, pc, pf, w.g, w.t);
    stage<kOwn>(sk, a.k + head, own0, T, D, 0, ncols, vec, w.tid);
    if (nt > 0) {
      stage<kChunk>(chunk(1), pose_h, band0 + kChunk, P, D, 0, ncols, vec,
                    w.tid);
      stage<kChunk>(chunk(2), pose_h, band0 + 2 * kChunk, P, D, 0, ncols,
                    vec, w.tid);
      stage_tile(0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int tile = 0; tile < nt; ++tile) {
      if (tile > 0) {
        cp_async_wait<0>();
        __syncthreads();
      }
      if (tile + 1 < nt) {
        stage_tile(tile + 1);
        cp_async_commit();
      }
      const int l0 = beg + tile * kRows;
      if (!live(l0)) continue;
      const float* tqc = sring + (tile & 1) * kStage;
      const float* tqp = tqc + kRows * kLd;
      const float* tdo = tqp + kRows * kLd;
      float s[NT][4], dp[NT][4], gq[NG][4];
      zero<NT>(s);
      zero<NT>(dp);
      zero<NG>(gq);
      const float* qb[NT] = {tqc, tqc + 8 * kLd};
      const float* db[NT] = {tdo, tdo + 8 * kLd};
      const float* bb[NG];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int r = w.wrow + 8 * j;
        bb[j] = chunk(r / kChunk - tile) + (r % kChunk) * kLd;
      }
      dot_rows<NT>(s, sk + w.wrow * kLd, qb, pc, pf, w.g, w.t);
      dot_held<NT>(dp, hv, db, pc, pf, w.g, w.t);
      dot_rows<NG>(gq, tqp, bb, pc, pf, w.g, w.t);
      finish(s, dp, gq, l0, tqc, tdo, sstat + (tile & 1) * 2 * kRows);
    }
  } else {
    // each query tile: s^T, dp^T and g over spans of kPass columns, the
    // owned rows' span staged beside the streamed rows'; then q_c's and
    // do's columns of this pass
    float* sk = smem;
    float* sv = sk + kOwn * kLd;
    float* sqc = sv + kOwn * kLd;
    float* sqp = sqc + kRows * kLd;
    float* sdo = sqp + kRows * kLd;
    float* sband = sdo + kRows * kLd;  // 3 chunks
    float* pqc = smem;                 // the pass: q_c, do
    float* pdo = pqc + kRows * kLd;
    for (int tile = 0; tile < nt; ++tile) {
      const int l0 = beg + tile * kRows;
      const bool on = live(l0);
      float s[NT][4], dp[NT][4], gq[NG][4];
      zero<NT>(s);
      zero<NT>(dp);
      zero<NG>(gq);
      for (int sp = 0; sp * kPass < D; ++sp) {
        const int c0 = sp * kPass;
        const int cf = frags_of(min(kPass, D - c0));
        const int nc = 32 * cf;
        __syncthreads();
        stage<kOwn>(sk, a.k + head, own0, T, D, c0, nc, vec, w.tid);
        stage<kOwn>(sv, a.v + head, own0, T, D, c0, nc, vec, w.tid);
        stage<kRows>(sqc, a.q + head, l0, T, D, c0, nc, vec, w.tid);
        stage<kRows>(sqp, a.q_p + head, l0, T, D, c0, nc, vec, w.tid);
        stage<kRows>(sdo, a.dout + head, l0, T, D, c0, nc, vec, w.tid);
        stage<3 * kChunk>(sband, pose_h, band0 - kChunk * tile, P, D, c0, nc,
                          vec, w.tid);
        if (sp == 0) stage_stats(l0, sstat);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (on) {
          const float* qb[NT] = {sqc, sqc + 8 * kLd};
          const float* db[NT] = {sdo, sdo + 8 * kLd};
          const float* bb[NG] = {sband + w.wrow * kLd,
                                 sband + (w.wrow + 8) * kLd,
                                 sband + (w.wrow + 16) * kLd,
                                 sband + (w.wrow + 24) * kLd};
          const int c = w.qt * 8 * cf;
          dot_rows<NT>(s, sk + w.wrow * kLd, qb, c, cf, w.g, w.t);
          dot_rows<NT>(dp, sv + w.wrow * kLd, db, c, cf, w.g, w.t);
          dot_rows<NG>(gq, sqp, bb, c, cf, w.g, w.t);
        }
      }
      __syncthreads();
      stage<kRows>(pqc, a.q + head, l0, T, D, p0, 32 * pf, vec, w.tid);
      stage<kRows>(pdo, a.dout + head, l0, T, D, p0, 32 * pf, vec, w.tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (on) finish(s, dp, gq, l0, pqc, pdo, sstat);
    }
  }
  write_tile(dk + head, acc_k, sw, T, D, p0, pc, pf, 1.f, 1.f, w.g, w.t);
  write_tile(dv + head, acc_v, sw, T, D, p0, pc, pf, 1.f, 1.f, w.g, w.t);
}

// dpose's per-(b, h) partial table: the block owns table rows r0..; for a
// query tile of kRows rows l0.. the entries of its rows r read the keys l +
// r - (T-1), a window of kWin keys that moves kRows a tile. The query tile
// streams through a two-stage ring with q_c, q_p, do, lse and delta, the
// window's K and V through rings of three chunks (the chunk that leaves is
// replaced once every warp has formed its content scores); the pose rows
// are held in registers (up to 256 columns). The content scores q_c . k^T
// and dp = do . v^T of the window do not depend on the table row, so the
// two warps of a quarter split its six fragments into the quarter's tiles
// in shared memory, each warp adds its relative partial pose . q_p^T to
// the cells its table rows read (those of the two row groups are
// disjoint), and each warp reads its 16 x 16 entries along the diagonal,
// summed over the four quarters in order: no window product is formed
// twice. Then dpose += ds^T . q_p.
template <bool kStream>
__global__ void __launch_bounds__(kThreads3, 1)
    k3_dpose_kernel(Args a, bool vec, float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  float* sstat = smem + kStagedRows * kLd;  // [stage][lse, delta][kRows]
  float* swin = sstat + kStatFloats;  // [quarter][c, dp][kRows][kWinLd]
  const Place w;
  const int D = a.D, T = a.Tq, P = 2 * T - 1;
  const int bh = blockIdx.y, b = bh / a.H;
  const int hp = a.Hp == 1 ? 0 : bh % a.H;
  const int r0 = blockIdx.x * kOwn;
  const int rw = r0 + w.wrow;  // the warp's first table row
  const size_t head = static_cast<size_t>(bh) * T * D;
  const size_t shead = static_cast<size_t>(bh) * T;
  const float* pose_h = a.pose + static_cast<size_t>(hp) * P * D;
  const int kend = min(T, a.k_len[b]);
  // entry (l, r) is key s = l + r - (T-1): rows l with a valid key for
  // some r of this block are T-1-r1 <= l < kend + T-1 - r0; under causal
  // only diagonals r <= T-1 (s <= l) carry anything
  const int r1 = min(r0 + kOwn, P) - 1;
  const int llo = max(0, T - 1 - r1);
  int lhi = min(T, kend + T - 1 - r0);
  if (kend == 0 || (a.causal && r0 > T - 1)) lhi = 0;
  const int lfirst = (llo / kRows) * kRows;
  const int nt = lhi > lfirst ? (lhi - lfirst + kRows - 1) / kRows : 0;
  // query tile n meets keys wb0 + kRows n + x, x < kWin (the window);
  // entry (rw + rj, l0 + li) reads window key wrow + li + rj
  const int wb0 = lfirst + r0 - (T - 1);
  const int wfrag = kWinFrags * w.rg;  // the warp's first window fragment
  float* qc_win = swin + w.qt * 2 * kRows * kWinLd;  // the quarter's c
  const int pass = blockIdx.z;
  const int p0 = pass * kPass;
  const int pf = frags_of(min(kPass, D - p0));
  const int pc = w.qt * 8 * pf;
  auto stage_stats = [&](int l0, float* dst) {
    if (w.tid < 2 * kRows) {
      const int which = w.tid / kRows;  // 0 lse, 1 delta
      const int l = l0 + w.tid - which * kRows;
      const bool ok = l < T;
      cp_async_4(dst + w.tid, (which ? a.delta : a.lse) + shead + (ok ? l : 0),
                 ok);
    }
  };

  float acc[kFrags][4];
  zero<kFrags>(acc);

  // the warp's window fragments (partials over its quarter) to the
  // quarter's tiles, its relative partial added along the diagonal; once
  // every quarter's tiles are complete (one barrier, which finish leaves
  // to the caller), `read` forms ds^T and adds ds^T . q_p over tqp
  auto publish = [&](const float (&cs)[kWinFrags][4],
                     const float (&cd)[kWinFrags][4],
                     const float (&rel)[NT][4]) {
#pragma unroll
    for (int i = 0; i < kWinFrags; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = (w.g + 8 * h) * kWinLd + 8 * (wfrag + i) + 2 * w.t;
        *reinterpret_cast<float2*>(qc_win + at) =
            make_float2(cs[i][2 * h], cs[i][2 * h + 1]);
        *reinterpret_cast<float2*>(qc_win + kRows * kWinLd + at) =
            make_float2(cd[i][2 * h], cd[i][2 * h + 1]);
      }
    }
    quarter_sync(w.qt);  // the quarter's c is whole
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rj = w.g + 8 * (c / 2);
        const int li = 8 * j + 2 * w.t + (c & 1);
        qc_win[li * kWinLd + li + rj + w.wrow] += rel[j][c];
      }
    }
  };
  auto read = [&](int l0, const float* tqp, const float* tstat) {
    float x[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rj = w.g + 8 * (c / 2);
        const int li = 8 * j + 2 * w.t + (c & 1);
        const int at = li * kWinLd + li + rj + w.wrow;
        constexpr int kQ = 2 * kRows * kWinLd;  // a quarter's tiles
        const float sc = ((swin[at] + swin[kQ + at]) + swin[2 * kQ + at]) +
                         swin[3 * kQ + at];
        const int dpa = kRows * kWinLd + at;
        const float dp = ((swin[dpa] + swin[kQ + dpa]) + swin[2 * kQ + dpa]) +
                         swin[3 * kQ + dpa];
        const int l = l0 + li;
        const int r = rw + rj;
        const int s = l + r - (T - 1);
        const bool ok = l < T && r < P && s >= 0 && s < kend &&
                        (!a.causal || s <= l);
        const float p = ok ? __expf(sc * a.scale - tstat[li]) : 0.f;
        x[j][c] = p * (dp - tstat[kRows + li]) * a.scale;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragA ads;
      acc_as_a(ads, x[j]);
      accumulate(acc, ads, tqp, 8 * j, pc, pf, w.g, w.t);
    }
  };

  if constexpr (!kStream) {
    const int ncols = 32 * pf;
    constexpr int kStage = 3 * kRows * kLd;  // q_c, q_p, do
    constexpr int kRing = 3 * kChunk * kLd;  // a window of three chunks
    float* sring = smem;                     // [stage][q_c, q_p, do]
    float* sk = sring + 2 * kStage;
    float* sv = sk + kRing;
    auto stage_q = [&](int tile) {
      const int l0 = lfirst + tile * kRows;
      float* dst = sring + (tile & 1) * kStage;
      stage<kRows>(dst, a.q + head, l0, T, D, 0, ncols, vec, w.tid);
      stage<kRows>(dst + kRows * kLd, a.q_p + head, l0, T, D, 0, ncols, vec,
                   w.tid);
      stage<kRows>(dst + 2 * kRows * kLd, a.dout + head, l0, T, D, 0, ncols,
                   vec, w.tid);
      stage_stats(l0, sstat + (tile & 1) * 2 * kRows);
    };
    // window chunk m: keys wb0 + kChunk m .., ring slot m % 3
    auto stage_chunk = [&](int m) {
      const int at = (m % 3) * kChunk * kLd;
      stage<kChunk>(sk + at, a.k + head, wb0 + kChunk * m, T, D, 0, ncols,
                    vec, w.tid);
      stage<kChunk>(sv + at, a.v + head, wb0 + kChunk * m, T, D, 0, ncols,
                    vec, w.tid);
    };
    float hp_rows[kFrags][4];  // the warp's pose rows, held
    hold(hp_rows, pose_h, rw, P, D, pc, pf, w.g, w.t);
    if (nt > 0) {
      stage_q(0);
      stage_chunk(0);
      stage_chunk(1);
      stage_chunk(2);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int tile = 0; tile < nt; ++tile) {
      if (tile > 0) {
        // this tile has landed, and every warp is done with the last one
        cp_async_wait<0>();
        __syncthreads();
      }
      if (tile + 1 < nt) {
        stage_q(tile + 1);
        cp_async_commit();
      }
      const int l0 = lfirst + tile * kRows;
      const float* tqc = sring + (tile & 1) * kStage;
      const float* tqp = tqc + kRows * kLd;
      const float* tdo = tqp + kRows * kLd;
      float cs[kWinFrags][4], cd[kWinFrags][4], rel[NT][4];
      zero<kWinFrags>(cs);
      zero<kWinFrags>(cd);
      zero<NT>(rel);
      const float* kb[kWinFrags];
      const float* vb[kWinFrags];
#pragma unroll
      for (int i = 0; i < kWinFrags; ++i) {
        const int x = 8 * (wfrag + i);
        const int at = ((tile + x / kChunk) % 3) * kChunk * kLd +
                       (x % kChunk) * kLd;
        kb[i] = sk + at;
        vb[i] = sv + at;
      }
      dot_rows<kWinFrags>(cs, tqc, kb, pc, pf, w.g, w.t);
      dot_rows<kWinFrags>(cd, tdo, vb, pc, pf, w.g, w.t);
      const float* qb[NT] = {tqp, tqp + 8 * kLd};
      dot_held<NT>(rel, hp_rows, qb, pc, pf, w.g, w.t);
      publish(cs, cd, rel);
      // every quarter's tiles are whole, and every warp is done with the
      // window's first chunk
      __syncthreads();
      if (tile + 1 < nt) {
        stage_chunk(tile + 3);
        cp_async_commit();
      }
      read(l0, tqp, sstat + (tile & 1) * 2 * kRows);
    }
  } else {
    // each query tile: the content partials and the relative term over
    // spans of kPass columns; then q_p's columns of this pass
    float* sqc = smem;
    float* sqp = sqc + kRows * kLd;
    float* sdo = sqp + kRows * kLd;
    float* sk = sdo + kRows * kLd;  // the window
    float* sv = sk + kWin * kLd;
    float* spose = sv + kWin * kLd;  // the block's table rows
    float* pqp = smem;               // the pass: q_p
    for (int tile = 0; tile < nt; ++tile) {
      const int l0 = lfirst + tile * kRows;
      float cs[kWinFrags][4], cd[kWinFrags][4], rel[NT][4];
      zero<kWinFrags>(cs);
      zero<kWinFrags>(cd);
      zero<NT>(rel);
      for (int sp = 0; sp * kPass < D; ++sp) {
        const int c0 = sp * kPass;
        const int cf = frags_of(min(kPass, D - c0));
        const int nc = 32 * cf;
        __syncthreads();
        stage<kRows>(sqc, a.q + head, l0, T, D, c0, nc, vec, w.tid);
        stage<kRows>(sqp, a.q_p + head, l0, T, D, c0, nc, vec, w.tid);
        stage<kRows>(sdo, a.dout + head, l0, T, D, c0, nc, vec, w.tid);
        stage<kWin>(sk, a.k + head, wb0 + kRows * tile, T, D, c0, nc, vec,
                    w.tid);
        stage<kWin>(sv, a.v + head, wb0 + kRows * tile, T, D, c0, nc, vec,
                    w.tid);
        stage<kOwn>(spose, pose_h, r0, P, D, c0, nc, vec, w.tid);
        if (sp == 0) stage_stats(l0, sstat);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        const float* kb[kWinFrags] = {sk + 8 * wfrag * kLd,
                                      sk + 8 * (wfrag + 1) * kLd,
                                      sk + 8 * (wfrag + 2) * kLd};
        const float* vb[kWinFrags] = {sv + 8 * wfrag * kLd,
                                      sv + 8 * (wfrag + 1) * kLd,
                                      sv + 8 * (wfrag + 2) * kLd};
        const float* qb[NT] = {sqp, sqp + 8 * kLd};
        const int c = w.qt * 8 * cf;
        dot_rows<kWinFrags>(cs, sqc, kb, c, cf, w.g, w.t);
        dot_rows<kWinFrags>(cd, sdo, vb, c, cf, w.g, w.t);
        dot_rows<NT>(rel, spose + w.wrow * kLd, qb, c, cf, w.g, w.t);
      }
      __syncthreads();
      stage<kRows>(pqp, a.q_p + head, l0, T, D, p0, 32 * pf, vec, w.tid);
      cp_async_commit();
      publish(cs, cd, rel);
      cp_async_wait<0>();
      __syncthreads();  // the quarters' tiles are whole, the pass landed
      read(l0, pqp, sstat);
    }
  }
  write_tile(partial + static_cast<size_t>(bh) * P * D, acc, rw, P, D, p0,
             pc, pf, 1.f, 1.f, w.g, w.t);
}

enum Kernel { kFwd = 0, kDq = 1, kDkv = 2, kDpose = 3 };

template <Kernel K, bool kStream>
const void* kernel_fn() {
  if constexpr (K == kFwd) {
    return reinterpret_cast<const void*>(k3_fwd_kernel<kStream>);
  } else if constexpr (K == kDq) {
    return reinterpret_cast<const void*>(k3_dq_kernel<kStream>);
  } else if constexpr (K == kDkv) {
    return reinterpret_cast<const void*>(k3_dkv_kernel<kStream>);
  } else {
    return reinterpret_cast<const void*>(k3_dpose_kernel<kStream>);
  }
}

// bytes of dynamic shared memory of kernel K
constexpr int smem_bytes(Kernel K) {
  return 4 * (K == kDpose ? kPoseSmemFloats : kSmemFloats);
}

template <Kernel K, bool kStream>
cudaError_t attributes() {
  static std::atomic<bool> done[k2tc::kMaxDevices];
  return k2tc::set_attributes(kernel_fn<K, kStream>(), smem_bytes(K), done);
}

// the grid of kernel K: a block kOwn rows (table rows for dpose) of a head,
// one a pass of kPass columns over 256
dim3 grid_of(Kernel K, const Args& a) {
  const int rows = K == kDpose ? 2 * a.Tq - 1 : a.Tq;
  return dim3((rows + kOwn - 1) / kOwn, a.B * a.H, k2tc::passes(a.D));
}

// the operands' rows are copied 16 bytes at a time where they allow it
bool vec_rows(const Args& a) { return k2tc::vec_rows(a, nullptr); }

template <bool kStream>
cudaError_t launch_fwd(const Args& a, float* out, float* lse,
                       cudaStream_t st) {
  const cudaError_t rc = attributes<kFwd, kStream>();
  if (rc != cudaSuccess) return rc;
  k3_fwd_kernel<kStream><<<grid_of(kFwd, a), kThreads3, smem_bytes(kFwd),
                           st>>>(a, vec_rows(a), out, lse);
  return cudaGetLastError();
}

template <bool kStream>
cudaError_t launch_dq(const Args& a, const float* out, float* delta,
                      float* dq_c, float* dq_p, cudaStream_t st) {
  const cudaError_t rc = attributes<kDq, kStream>();
  if (rc != cudaSuccess) return rc;
  k3_dq_kernel<kStream><<<grid_of(kDq, a), kThreads3, smem_bytes(kDq),
                          st>>>(a, vec_rows(a), out, delta, dq_c, dq_p);
  return cudaGetLastError();
}

template <bool kStream>
cudaError_t launch_dkv(const Args& a, float* dk, float* dv, cudaStream_t st) {
  const cudaError_t rc = attributes<kDkv, kStream>();
  if (rc != cudaSuccess) return rc;
  k3_dkv_kernel<kStream><<<grid_of(kDkv, a), kThreads3, smem_bytes(kDkv),
                           st>>>(a, vec_rows(a), dk, dv);
  return cudaGetLastError();
}

template <bool kStream>
cudaError_t launch_dpose(const Args& a, float* partial, cudaStream_t st) {
  const cudaError_t rc = attributes<kDpose, kStream>();
  if (rc != cudaSuccess) return rc;
  k3_dpose_kernel<kStream><<<grid_of(kDpose, a), kThreads3,
                             smem_bytes(kDpose), st>>>(a, vec_rows(a),
                                                       partial);
  return cudaGetLastError();
}

}  // namespace k3tc

int status() { return static_cast<int>(cudaGetLastError()); }

bool bad(int B, int H, int Tq, int Tk, int D) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0;
}

Args k2_args(const float* q, const float* k, const float* v,
             const float* bias, const int* k_len, const float* dout,
             const float* lse, const float* delta, int B, int H, int Tq,
             int Tk, int D, float scale, int causal) {
  return Args{q, nullptr, k, v, nullptr, bias, k_len, dout, lse, delta,
              B, H, 0, Tq, Tk, D, scale, causal};
}

Args k3_args(const float* q_c, const float* q_p, const float* k,
             const float* v, const float* pose, const int* k_len,
             const float* dout, const float* lse, const float* delta, int B,
             int H, int Hp, int T, int D, float scale, int causal) {
  return Args{q_c, q_p, k, v, pose, nullptr, k_len, dout, lse, delta,
              B, H, Hp, T, T, D, scale, causal};
}

}  // namespace

extern "C" const char* aps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ---- K2: the entry points take attention.cu's / attention_bwd.cu's
// arguments (any D > 0; the wrapper sends D > 128 here). The forward, dq
// and dk/dv run the tensor-core tiles (k2tc; in passes over 256 columns).

extern "C" int aps_attention_wide_fwd(const float* q, const float* k,
                                      const float* v, const float* bias,
                                      const int* k_len, int B, int H, int Tq,
                                      int Tk, int D, float scale, int causal,
                                      float* out, float* lse, void* stream) {
  if (bad(B, H, Tq, Tk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = k2_args(q, k, v, bias, k_len, nullptr, nullptr, nullptr, B,
                         H, Tq, Tk, D, scale, causal);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D > k2tc::kPass
                              ? k2tc::launch_fwd<true>(a, out, lse, st)
                              : k2tc::launch_fwd<false>(a, out, lse, st));
}

// dq: out0 = dq, out1 = the forward's output (delta formed and written);
// dkv: out0 = dk, out1 = dv
extern "C" int aps_attention_wide_dq(const float* q, const float* k,
                                     const float* v, const float* bias,
                                     const int* k_len, const float* dout,
                                     const float* lse, float* delta, int B,
                                     int H, int Tq, int Tk, int D,
                                     float scale, int causal, float* dq,
                                     const float* out, void* stream) {
  if (bad(B, H, Tq, Tk, D) || out == nullptr || delta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = k2_args(q, k, v, bias, k_len, dout, lse, nullptr, B, H, Tq,
                         Tk, D, scale, causal);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      D > k2tc::kPass
          ? k2tc::launch_bwd<false, true>(a, out, delta, dq, nullptr, st)
          : k2tc::launch_bwd<false, false>(a, out, delta, dq, nullptr, st));
}

extern "C" int aps_attention_wide_dkv(const float* q, const float* k,
                                      const float* v, const float* bias,
                                      const int* k_len, const float* dout,
                                      const float* lse, const float* delta,
                                      int B, int H, int Tq, int Tk, int D,
                                      float scale, int causal, float* dk,
                                      float* dv, void* stream) {
  if (bad(B, H, Tq, Tk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = k2_args(q, k, v, bias, k_len, dout, lse, delta, B, H, Tq,
                         Tk, D, scale, causal);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      D > k2tc::kPass
          ? k2tc::launch_bwd<true, true>(a, nullptr, nullptr, dk, dv, st)
          : k2tc::launch_bwd<true, false>(a, nullptr, nullptr, dk, dv, st));
}

// ---- K3: the entry points take rel_attention.cu's /
// rel_attention_bwd.cu's arguments (any D > 0; the wrapper sends D > 128
// here) and run the tensor-core tiles (k3tc; up to 256 columns the owned
// rows resident, over 256 a block a pass of 256 columns)

extern "C" int aps_rel_attention_wide_fwd(
    const float* q_c, const float* q_p, const float* k, const float* v,
    const float* pose, const int* k_len, int B, int H, int Hp, int T, int D,
    float scale, int causal, float* out, float* lse, void* stream) {
  if (bad(B, H, T, T, D) || (Hp != 1 && Hp != H))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = k3_args(q_c, q_p, k, v, pose, k_len, nullptr, nullptr,
                         nullptr, B, H, Hp, T, D, scale, causal);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D > k3tc::kPass
                              ? k3tc::launch_fwd<true>(a, out, lse, st)
                              : k3tc::launch_fwd<false>(a, out, lse, st));
}

extern "C" int aps_rel_attention_wide_dq(
    const float* q_c, const float* q_p, const float* k, const float* v,
    const float* pose, const int* k_len, const float* dout, const float* lse,
    float* delta, int B, int H, int Hp, int T, int D, float scale,
    int causal, float* dq_c, float* dq_p, const float* out, void* stream) {
  if (bad(B, H, T, T, D) || (Hp != 1 && Hp != H) || out == nullptr ||
      delta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = k3_args(q_c, q_p, k, v, pose, k_len, dout, lse, nullptr, B,
                         H, Hp, T, D, scale, causal);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      D > k3tc::kPass
          ? k3tc::launch_dq<true>(a, out, delta, dq_c, dq_p, st)
          : k3tc::launch_dq<false>(a, out, delta, dq_c, dq_p, st));
}

extern "C" int aps_rel_attention_wide_dkv(
    const float* q_c, const float* q_p, const float* k, const float* v,
    const float* pose, const int* k_len, const float* dout, const float* lse,
    const float* delta, int B, int H, int Hp, int T, int D, float scale,
    int causal, float* dk, float* dv, void* stream) {
  if (bad(B, H, T, T, D) || (Hp != 1 && Hp != H))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = k3_args(q_c, q_p, k, v, pose, k_len, dout, lse, delta, B, H,
                         Hp, T, D, scale, causal);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D > k3tc::kPass
                              ? k3tc::launch_dkv<true>(a, dk, dv, st)
                              : k3tc::launch_dkv<false>(a, dk, dv, st));
}

// partial: scratch of B*H x (2T-1) x D floats (the per-(b, h) tables);
// dpose: Hp x (2T-1) x D, their sum over b (and h for a shared table) in a
// fixed order
extern "C" int aps_rel_attention_wide_dpose(
    const float* q_c, const float* q_p, const float* k, const float* v,
    const float* pose, const int* k_len, const float* dout, const float* lse,
    const float* delta, int B, int H, int Hp, int T, int D, float scale,
    int causal, float* partial, float* dpose, void* stream) {
  if (bad(B, H, T, T, D) || (Hp != 1 && Hp != H))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = k3_args(q_c, q_p, k, v, pose, k_len, dout, lse, delta, B, H,
                         Hp, T, D, scale, causal);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = D > k3tc::kPass
                             ? k3tc::launch_dpose<true>(a, partial, st)
                             : k3tc::launch_dpose<false>(a, partial, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int R = 2 * T - 1;
  const long n = static_cast<long>(Hp) * R * D;
  dpose_sum_kernel<<<static_cast<int>((n + 255) / 256), 256, 0, st>>>(
      partial, B, H, Hp, R, D, dpose);
  return status();
}

// How kernel `kernel` sits on an SM: 0 K2 forward, 1 K2 dq, 2 K2 dk/dv, 3
// K3 forward, 4 K3 dq, 5 K3 dk/dv, 6 K3 dpose's partial tables (the
// tensor-core tiles, heads up to 256), 7 K2 forward, 8 K2 dq, 9 K2 dk/dv,
// 10 K3 forward, 11 K3 dq, 12 K3 dk/dv, 13 K3 dpose (the tiles in passes,
// heads over 256); info = {registers a thread, bytes of local memory a
// thread (spills), bytes of shared memory a block (static and dynamic),
// resident blocks an SM, head columns a pass, threads a block}.
extern "C" int aps_wide_attention_occupancy(int kernel, int* info) {
  using k3tc::kDkv;
  using k3tc::kDpose;
  using k3tc::kDq;
  using k3tc::kFwd;
  const void* fns[] = {k2tc::fwd_fn<false>(),
                       k2tc::bwd_fn<false, false>(),
                       k2tc::bwd_fn<true, false>(),
                       k3tc::kernel_fn<kFwd, false>(),
                       k3tc::kernel_fn<kDq, false>(),
                       k3tc::kernel_fn<kDkv, false>(),
                       k3tc::kernel_fn<kDpose, false>(),
                       k2tc::fwd_fn<true>(),
                       k2tc::bwd_fn<false, true>(),
                       k2tc::bwd_fn<true, true>(),
                       k3tc::kernel_fn<kFwd, true>(),
                       k3tc::kernel_fn<kDq, true>(),
                       k3tc::kernel_fn<kDkv, true>(),
                       k3tc::kernel_fn<kDpose, true>()};
  constexpr int kKernels = sizeof(fns) / sizeof(fns[0]);
  if (kernel < 0 || kernel >= kKernels)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool k3 = (kernel >= 3 && kernel <= 6) || kernel >= 10;
  int dynamic = 0, threads = 0;
  cudaError_t err = cudaSuccess;
  switch (kernel) {
    case 0: err = k2tc::fwd_attributes<false>(); break;
    case 1: err = k2tc::bwd_attributes<false, false>(); break;
    case 2: err = k2tc::bwd_attributes<true, false>(); break;
    case 3: err = k3tc::attributes<kFwd, false>(); break;
    case 4: err = k3tc::attributes<kDq, false>(); break;
    case 5: err = k3tc::attributes<kDkv, false>(); break;
    case 6: err = k3tc::attributes<kDpose, false>(); break;
    case 7: err = k2tc::fwd_attributes<true>(); break;
    case 8: err = k2tc::bwd_attributes<false, true>(); break;
    case 9: err = k2tc::bwd_attributes<true, true>(); break;
    case 10: err = k3tc::attributes<kFwd, true>(); break;
    case 11: err = k3tc::attributes<kDq, true>(); break;
    case 12: err = k3tc::attributes<kDkv, true>(); break;
    default: err = k3tc::attributes<kDpose, true>(); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k3) {
    dynamic = k3tc::smem_bytes(kernel == 6 || kernel == 13 ? kDpose : kFwd);
    threads = k3tc::kThreads3;
  } else {
    dynamic = 4 * (kernel == 0 || kernel == 7 ? k2tc::kFwdSmemFloats
                                              : k2tc::kBwdSmemFloats);
    threads = k2tc::kTcThreads;
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fns[kernel]);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[kernel],
                                                      threads, dynamic);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes) + dynamic;
  info[3] = blocks;
  info[4] = k2tc::kPass;
  info[5] = threads;
  return 0;
}
