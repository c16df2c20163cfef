// Flash attention (K2) and flash attention with relative-position scores
// (K3) for heads wider than 128, forward and backward, Hopper (sm_90a),
// float32.
//
// K2's kernels here replace aps_tpu/ops/pallas/attention.py's
// flash_attention (the TPU kernels _fwd_kernel, _dq_kernel, _dkv_kernel and
// _dbias_kernel) at heads over 128, K3's replace
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
//   K2 dbias[h,l,s] = sum_b p (dp - delta)
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
// K3's kernels and K2's dbias (no model passes a bias): one warp a row of
// the output on the CUDA cores, the lanes striding over the head (lane j
// holds columns j, j + 32, ...). A dot product over D is a lane sum and a
// butterfly of shuffles, so every lane holds the same bits of it. A warp's
// accumulators are kCols = 32 * kPer columns in registers; a wider head
// runs its columns in passes of kCols, each recomputing the scores it
// needs. The forward first walks the visible keys for the row's max and
// sum (lse), then each pass adds exp(score - lse) v[s] into its columns, so
// no pass rescales. The operands stream from global memory through L1.
// Every warp owns the sums it writes and adds in a fixed order:
//
//   forward: a warp a query row (b, h, l): lse, then out in passes;
//   dq:      a warp a query row: delta = do . o (written), then dq and
//            dq_p in passes;
//   dk/dv:   a warp a key row (b, h, s), over the query rows that see it;
//   dbias:   a warp an entry (h, l, s), the batch summed in order;
//   dpose:   a warp a table row of a per-(b, h) partial table, over its
//            diagonal of (l, s) pairs; a second kernel sums the partial
//            tables over b (and h for a shared table) in order, as
//            rel_attention_bwd.cu does.
//
// No model of the repo has such a head, so no path launches them.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "attn_tiles.cuh"

namespace {

constexpr int kWarps = 4;               // rows a block
constexpr int kPer = 8;                 // columns a lane holds in a pass
constexpr int kCols = 32 * kPer;        // columns of a pass
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
  const float* delta; // B x H x Tq (dk/dv, dbias, dpose)
  int B, H, Hp, Tq, Tk, D;
  float scale;
  int causal;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(kFull, x, m);
  return x;
}

// a . b over D, the same bits in every lane
__device__ __forceinline__ float dot(const float* __restrict__ a,
                                     const float* __restrict__ b, int D,
                                     int lane) {
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(__ldg(a + d), __ldg(b + d), acc);
  return warp_sum(acc);
}

// number of keys row l sees (they are 0 ... end-1)
__device__ __forceinline__ int key_end(const Args& a, int b, int l) {
  int end = min(a.k_len[b], a.Tk);
  if (a.causal) end = min(end, l + 1);
  return max(end, 0);
}

__device__ __forceinline__ bool visible(const Args& a, int b, int l, int s) {
  return s < a.k_len[b] && (!a.causal || s <= l);
}

// The scaled score of (l, s) in head (b, h) of flat index bh = b * H + h.
template <bool kRel>
__device__ __forceinline__ float score(const Args& a, int bh, int h, int l,
                                       int s, int lane) {
  const size_t D = a.D;
  const float* qrow = a.q + (static_cast<size_t>(bh) * a.Tq + l) * D;
  const float* krow = a.k + (static_cast<size_t>(bh) * a.Tk + s) * D;
  if constexpr (kRel) {
    const int T = a.Tq;
    const int hp = a.Hp == 1 ? 0 : h;
    const float* qp = a.q_p + (static_cast<size_t>(bh) * T + l) * D;
    const float* prow =
        a.pose + (static_cast<size_t>(hp) * (2 * T - 1) + (s - l + T - 1)) * D;
    float c = 0.f, p = 0.f;
    for (int d = lane; d < a.D; d += 32) {
      c = fmaf(__ldg(qrow + d), __ldg(krow + d), c);
      p = fmaf(__ldg(qp + d), __ldg(prow + d), p);
    }
    return (warp_sum(c) + warp_sum(p)) * a.scale;
  } else {
    float sc = dot(qrow, krow, a.D, lane) * a.scale;
    if (a.bias != nullptr)
      sc += __ldg(a.bias + (static_cast<size_t>(h) * a.Tq + l) * a.Tk + s);
    return sc;
  }
}

// K3's p and ds of a visible (l, s), given the row's lse and delta
__device__ __forceinline__ void p_ds(const Args& a, int bh, int h, int l,
                                     int s, float row_lse, float row_delta,
                                     int lane, float* p, float* ds) {
  const size_t D = a.D;
  *p = expf(score<true>(a, bh, h, l, s, lane) - row_lse);
  const float dp = dot(a.dout + (static_cast<size_t>(bh) * a.Tq + l) * D,
                       a.v + (static_cast<size_t>(bh) * a.Tk + s) * D, a.D,
                       lane);
  *ds = *p * (dp - row_delta) * a.scale;
}

__global__ void __launch_bounds__(kWarps * 32)
    fwd_kernel(Args a, float* __restrict__ out, float* __restrict__ lse) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= static_cast<long>(a.B) * a.H * a.Tq) return;
  const int l = row % a.Tq;
  const int bh = row / a.Tq;
  const int b = bh / a.H, h = bh % a.H;
  const int end = key_end(a, b, l);
  float m = -INFINITY, sum = 0.f;
  for (int s = 0; s < end; ++s) {
    const float sc = score<true>(a, bh, h, l, s, lane);
    if (sc > m) {
      sum = sum * expf(m - sc) + 1.f;
      m = sc;
    } else {
      sum += expf(sc - m);
    }
  }
  const float row_lse = sum > 0.f ? m + logf(sum) : kLseDead;
  if (lse != nullptr && lane == 0) lse[row] = row_lse;
  const size_t D = a.D;
  float* orow = out + static_cast<size_t>(row) * D;
  for (int c0 = 0; c0 < a.D; c0 += kCols) {
    float acc[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
    for (int s = 0; s < end; ++s) {
      const float p = expf(score<true>(a, bh, h, l, s, lane) - row_lse);
      const float* vrow = a.v + (static_cast<size_t>(bh) * a.Tk + s) * D;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int d = c0 + lane + 32 * j;
        if (d < a.D) acc[j] = fmaf(p, __ldg(vrow + d), acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int d = c0 + lane + 32 * j;
      if (d < a.D) orow[d] = acc[j];
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    dq_kernel(Args a, const float* __restrict__ out, float* __restrict__ delta,
              float* __restrict__ dq, float* __restrict__ dq_p) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= static_cast<long>(a.B) * a.H * a.Tq) return;
  const int l = row % a.Tq;
  const int bh = row / a.Tq;
  const int b = bh / a.H, h = bh % a.H;
  const size_t D = a.D;
  const float row_delta =
      dot(a.dout + row * D, out + row * D, a.D, lane);
  if (lane == 0) delta[row] = row_delta;
  const float row_lse = a.lse[row];
  const int end = key_end(a, b, l);
  const int T = a.Tq;
  const int hp = a.Hp == 1 ? 0 : h;
  for (int c0 = 0; c0 < a.D; c0 += kCols) {
    float acc[kPer], accp[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] = accp[j] = 0.f;
    for (int s = 0; s < end; ++s) {
      float p, ds;
      p_ds(a, bh, h, l, s, row_lse, row_delta, lane, &p, &ds);
      const float* krow = a.k + (static_cast<size_t>(bh) * a.Tk + s) * D;
      const float* prow = a.pose + (static_cast<size_t>(hp) * (2 * T - 1) +
                                    (s - l + T - 1)) * D;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int d = c0 + lane + 32 * j;
        if (d < a.D) {
          acc[j] = fmaf(ds, __ldg(krow + d), acc[j]);
          accp[j] = fmaf(ds, __ldg(prow + d), accp[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int d = c0 + lane + 32 * j;
      if (d < a.D) {
        dq[row * D + d] = acc[j];
        dq_p[row * D + d] = accp[j];
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    dkv_kernel(Args a, float* __restrict__ dk, float* __restrict__ dv) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= static_cast<long>(a.B) * a.H * a.Tk) return;
  const int s = row % a.Tk;
  const int bh = row / a.Tk;
  const int b = bh / a.H, h = bh % a.H;
  const size_t D = a.D;
  // the query rows that see key s: all of them unless it is padding,
  // l >= s under causal
  const bool live = s < a.k_len[b];
  const int l0 = a.causal ? s : 0;
  for (int c0 = 0; c0 < a.D; c0 += kCols) {
    float acck[kPer], accv[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) acck[j] = accv[j] = 0.f;
    for (int l = live ? l0 : a.Tq; l < a.Tq; ++l) {
      const size_t qr = static_cast<size_t>(bh) * a.Tq + l;
      float p, ds;
      p_ds(a, bh, h, l, s, a.lse[qr], a.delta[qr], lane, &p, &ds);
      const float* qrow = a.q + qr * D;
      const float* drow = a.dout + qr * D;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int d = c0 + lane + 32 * j;
        if (d < a.D) {
          acck[j] = fmaf(ds, __ldg(qrow + d), acck[j]);
          accv[j] = fmaf(p, __ldg(drow + d), accv[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int d = c0 + lane + 32 * j;
      if (d < a.D) {
        dk[row * D + d] = acck[j];
        dv[row * D + d] = accv[j];
      }
    }
  }
}

// K2 only: a warp an entry (h, l, s) of dbias
__global__ void __launch_bounds__(kWarps * 32)
    dbias_kernel(Args a, float* __restrict__ dbias) {
  const int lane = threadIdx.x & 31;
  const long idx = static_cast<long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (idx >= static_cast<long>(a.H) * a.Tq * a.Tk) return;
  const int s = idx % a.Tk;
  const int l = (idx / a.Tk) % a.Tq;
  const int h = idx / (static_cast<long>(a.Tk) * a.Tq);
  float acc = 0.f;
  for (int b = 0; b < a.B; ++b) {
    if (!visible(a, b, l, s)) continue;
    const int bh = b * a.H + h;
    const size_t qr = static_cast<size_t>(bh) * a.Tq + l;
    const float p = expf(score<false>(a, bh, h, l, s, lane) - a.lse[qr]);
    const float dp = dot(a.dout + qr * a.D,
                         a.v + (static_cast<size_t>(bh) * a.Tk + s) * a.D,
                         a.D, lane);
    acc += p * (dp - a.delta[qr]);
  }
  if (lane == 0) dbias[idx] = acc;
}

// K3 only: a warp a row r of the partial table of (b, h)
__global__ void __launch_bounds__(kWarps * 32)
    dpose_partial_kernel(Args a, float* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const int T = a.Tq, R = 2 * T - 1;
  const long row = static_cast<long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= static_cast<long>(a.B) * a.H * R) return;
  const int r = row % R;
  const int bh = row / R;
  const int b = bh / a.H, h = bh % a.H;
  const size_t D = a.D;
  // pairs (l, s = l + r - (T-1)) with 0 <= s < T
  const int lbeg = max(0, T - 1 - r), lend = min(T, 2 * T - 1 - r);
  for (int c0 = 0; c0 < a.D; c0 += kCols) {
    float acc[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
    for (int l = lbeg; l < lend; ++l) {
      const int s = l + r - (T - 1);
      if (!visible(a, b, l, s)) continue;
      const size_t qr = static_cast<size_t>(bh) * T + l;
      float p, ds;
      p_ds(a, bh, h, l, s, a.lse[qr], a.delta[qr], lane, &p, &ds);
      const float* qp = a.q_p + qr * D;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int d = c0 + lane + 32 * j;
        if (d < a.D) acc[j] = fmaf(ds, __ldg(qp + d), acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int d = c0 + lane + 32 * j;
      if (d < a.D) partial[row * D + d] = acc[j];
    }
  }
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
// 16 nf) -> tile (row stride kLd), zeros past limit and past D. vec: D % 4
// == 0 and src 16-byte aligned, 16 bytes a copy; else 4 bytes a copy.
template <int ROWS>
__device__ __forceinline__ void stage(float* tile,
                                      const float* __restrict__ src,
                                      int first, int limit, int D, int c0,
                                      int nf, bool vec, int tid) {
  const int ncols = 16 * nf;
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
      const bool ok = row < limit && col < D;
      cp_async_16(tile + r * kLd + c,
                  ok ? src + static_cast<size_t>(row) * D + col : src, ok);
    }
  } else {
    static_assert(kTcThreads == kPass, "a thread a column of the span");
    const int c = tid;
    if (c >= ncols) return;
    for (int r = 0; r < ROWS; ++r) {
      const int row = first + r, col = c0 + c;
      const bool ok = row < limit && col < D;
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

// acc[n] += A . B_n for n < nf, B_n[k][c] = tile[k0 + perm(k)][c0 + 8 n +
// c] (load_b_rows_k), eight fragments at a time, the three TF32 products
// of mma_f32 sent pass by pass across them
__device__ __forceinline__ void accumulate(float (&acc)[kMaxFrags][4],
                                           const FragA& a, const float* tile,
                                           int k0, int c0, int nf, int g,
                                           int t) {
#pragma unroll
  for (int n0 = 0; n0 < kMaxFrags; n0 += 8) {
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

// rows g and g + 8 of a warp's accumulator tile, times f0 and f1, to rows row0.. (those below rows) and columns p0 + c0.. (those below
// D) of a (rows x D) matrix
__device__ __forceinline__ void write_tile(float* __restrict__ dst,
                                           const float (&acc)[kMaxFrags][4],
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
    for (int n = 0; n < kMaxFrags; ++n) {
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
      stage<BK>(dst, k_h, tile * BK, a.Tk, D, 0, pf, vec, tid);
      stage<BK>(dst + BK * kLd, v_h, tile * BK, a.Tk, D, 0, pf, vec, tid);
    };
    stage<kOwn>(sq, q_h, l0, a.Tq, D, 0, pf, vec, tid);
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
        stage<kOwn>(sq, q_h, l0, a.Tq, D, c0, cf, vec, tid);
        stage<BK>(sk, k_h, s0, a.Tk, D, c0, cf, vec, tid);
        if (sp == 0) stage<BK>(sv, v_h, s0, a.Tk, D, p0, pf, vec, tid);
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
      stage<BS>(dst, y1, r0, t_str, D, 0, nf, vec, tid);
      stage<BS>(dst + BS * kLd, y2, r0, t_str, D, 0, nf, vec, tid);
      stage_stats(r0, st);
    };
    stage<kOwn>(sx1, x1, own0, t_own, D, 0, nf, vec, tid);
    stage<kOwn>(sx2, x2, own0, t_own, D, 0, nf, vec, tid);
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
        stage<kOwn>(sx1, x1, own0, t_own, D, c0, cf, vec, tid);
        stage<kOwn>(sx2, x2, own0, t_own, D, c0, cf, vec, tid);
        stage<BS>(sy1, y1, str0, t_str, D, c0, cf, vec, tid);
        stage<BS>(sy2, y2, str0, t_str, D, c0, cf, vec, tid);
        if (sp == 0) {
          stage<BS>(sp1, y1, str0, t_str, D, p0, pf, vec, tid);
          if constexpr (kDKV) {
            stage<BS>(sp2, y2, str0, t_str, D, p0, pf, vec, tid);
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
// grid
bool vec_rows(const Args& a, const float* out) {
  return a.D % 4 == 0 && aligned16(a.q) && aligned16(a.k) &&
         aligned16(a.v) && (a.dout == nullptr || aligned16(a.dout)) &&
         (out == nullptr || aligned16(out));
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

int blocks_of(long rows) {
  return static_cast<int>((rows + kWarps - 1) / kWarps);
}

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

constexpr int kThreads = kWarps * 32;

}  // namespace

extern "C" const char* aps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ---- K2: the entry points take attention.cu's / attention_bwd.cu's
// arguments (any D > 0; the wrapper sends D > 128 here). The forward, dq
// and dk/dv run the tensor-core tiles (k2tc; in passes over 256 columns),
// dbias the CUDA-core kernel.

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
// dkv: out0 = dk, out1 = dv; dbias: out0 = dbias (H x Tq x Tk)
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

extern "C" int aps_attention_wide_dbias(const float* q, const float* k,
                                        const float* v, const float* bias,
                                        const int* k_len, const float* dout,
                                        const float* lse, const float* delta,
                                        int B, int H, int Tq, int Tk, int D,
                                        float scale, int causal,
                                        float* dbias, float* unused,
                                        void* stream) {
  (void)unused;
  if (bad(B, H, Tq, Tk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = k2_args(q, k, v, bias, k_len, dout, lse, delta, B, H, Tq,
                         Tk, D, scale, causal);
  dbias_kernel<<<blocks_of(static_cast<long>(H) * Tq * Tk), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a, dbias);
  return status();
}

// ---- K3: the entry points take rel_attention.cu's /
// rel_attention_bwd.cu's arguments

extern "C" int aps_rel_attention_wide_fwd(
    const float* q_c, const float* q_p, const float* k, const float* v,
    const float* pose, const int* k_len, int B, int H, int Hp, int T, int D,
    float scale, int causal, float* out, float* lse, void* stream) {
  if (bad(B, H, T, T, D) || (Hp != 1 && Hp != H))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = k3_args(q_c, q_p, k, v, pose, k_len, nullptr, nullptr,
                         nullptr, B, H, Hp, T, D, scale, causal);
  fwd_kernel<<<blocks_of(static_cast<long>(B) * H * T), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, out, lse);
  return status();
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
  dq_kernel<<<blocks_of(static_cast<long>(B) * H * T), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, out, delta, dq_c,
                                                         dq_p);
  return status();
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
  dkv_kernel<<<blocks_of(static_cast<long>(B) * H * T), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, dk, dv);
  return status();
}

// partial: scratch of B*H x (2T-1) x D floats; dpose: Hp x (2T-1) x D
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
  const int R = 2 * T - 1;
  dpose_partial_kernel<<<blocks_of(static_cast<long>(B) * H * R), kThreads,
                         0, st>>>(a, partial);
  const long n = static_cast<long>(Hp) * R * D;
  dpose_sum_kernel<<<static_cast<int>((n + 255) / 256), 256, 0, st>>>(
      partial, B, H, Hp, R, D, dpose);
  return status();
}

// How kernel `kernel` sits on an SM: 0 K2 forward, 1 K2 dq, 2 K2 dk/dv
// (the tensor-core tiles, heads up to 256), 3 K2 dbias, 4 K3 forward, 5 K3
// dq, 6 K3 dk/dv, 7 K3 dpose's partial tables, 8 K2 forward, 9 K2 dq, 10
// K2 dk/dv (the tiles in passes, heads over 256); info = {registers a
// thread, bytes of local memory a thread (spills), bytes of shared memory a
// block (static and dynamic), resident blocks an SM, head columns a pass,
// threads a block}.
extern "C" int aps_wide_attention_occupancy(int kernel, int* info) {
  using namespace k2tc;
  const void* fns[] = {fwd_fn<false>(),
                       bwd_fn<false, false>(),
                       bwd_fn<true, false>(),
                       reinterpret_cast<const void*>(dbias_kernel),
                       reinterpret_cast<const void*>(fwd_kernel),
                       reinterpret_cast<const void*>(dq_kernel),
                       reinterpret_cast<const void*>(dkv_kernel),
                       reinterpret_cast<const void*>(dpose_partial_kernel),
                       fwd_fn<true>(),
                       bwd_fn<false, true>(),
                       bwd_fn<true, true>()};
  constexpr int kKernels = sizeof(fns) / sizeof(fns[0]);
  if (kernel < 0 || kernel >= kKernels)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tiles = kernel < 3 || kernel >= 8;
  const bool fwd = kernel == 0 || kernel == 8;
  int dynamic = 0;
  cudaError_t err = cudaSuccess;
  if (tiles) {
    dynamic = 4 * (fwd ? kFwdSmemFloats : kBwdSmemFloats);
    switch (kernel) {
      case 0: err = fwd_attributes<false>(); break;
      case 1: err = bwd_attributes<false, false>(); break;
      case 2: err = bwd_attributes<true, false>(); break;
      case 8: err = fwd_attributes<true>(); break;
      case 9: err = bwd_attributes<false, true>(); break;
      default: err = bwd_attributes<true, true>(); break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = tiles ? kTcThreads : kThreads;
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
  info[4] = tiles ? kPass : kCols;
  info[5] = threads;
  return 0;
}
