// Backward of flash attention with relative-position scores, Hopper
// (sm_90a), float32: three kernels plus a reduction.
//
// Replaces the backward of aps_tpu/ops/pallas/rel_attention.py::
// flash_attention_rel (the TPU kernels _dq_kernel, _dkv_kernel and
// _dpose_kernel launched by _bwd). With the forward's
//
//   score[l,s] = (q_c[l] . k[s] + q_p[l] . pose[hp, s-l+T-1]) * scale
//   p[l,s]     = mask(l,s) ? exp(score[l,s] - lse[l]) : 0
//
// and dp[l,s] = do[l] . v[s], delta[l] = do[l] . o[l] and
// ds = p * (dp - delta) * scale, the gradients are
//
//   dq_c[l] = sum_s ds[l,s] k[s]        dq_p[l] = sum_s ds[l,s] pose[s-l+T-1]
//   dk[s]   = sum_l ds[l,s] q_c[l]      dv[s]   = sum_l p[l,s] do[l]
//   dpose[hp, r] = sum over b (and h when the table is shared) and over l
//                  of ds[l, l + r - (T-1)] q_p[l]
//
// The mask is the forward's: keys s >= k_len[b] (suffix padding), s > l
// under causal. Rows without a valid key carry lse = 1e30 from the forward,
// so p and every gradient from them are exactly 0. The dq kernel forms
// delta from do and the forward's output and writes it; dk/dv and dpose
// run after it on the same stream and read it.
//
// The TPU kernels carry their sums in scratch memory from one grid step to
// the next, because the TPU's grid runs in order on one core, and the dpose
// kernel keeps the whole table resident while a 4-d grid adds bands into
// it. Blocks run in parallel and in no order here, so each kernel keeps the
// reduction it owns inside the block, without atomics (two launches give
// the same bits):
//
//   dq:    one block per (64 query rows, b*h), loop over key tiles;
//   dk/dv: one block per (64 key rows, b*h), loop over query tiles;
//   dpose: one block per (64 table rows r, b*h), loop over query tiles. Row
//          r of the table gathers one diagonal of ds, so for a tile of
//          diagonals the pose rows are fixed and query tile l0 meets the
//          keys l0 + r0 - (T-1) ... of K and V. Each block writes its rows
//          of a per-(b,h) partial table; a second kernel sums the partial
//          tables over b (and over h for a shared table) in a fixed order.
//          The partial tables take B*H*(2T-1)*D floats: 15 MB at the
//          flagship step (B = 32, H = 4, T = 231, D = 64), written once and
//          read once, some 10 us at 3.35 TB/s.
//
// What bounds them: per head dq does 5 products of T * T * D multiply-adds
// (the scores' two, dp, ds.k, ds.pose), dpose 4 and dk/dv 5 (the scores'
// two, dp, p.do, ds.q_c), on a few T D floats: arithmetic, not device
// memory. On the CUDA cores from shared memory (one thread per score, two
// shared loads per multiply-add, tiles restaged between barriers) they ran
// at a tenth of the float32 rate. All three now run every product on the
// tensor cores with the pieces of attn_tiles.cuh that K2's kernels are
// built from: mma.sync m16n8k8 on TF32 operands split in three (head and
// remainder of either operand, float32 accumulators: float32's accuracy),
// operands streamed through a cp.async ring (zero fill past the ends of the
// rows and of the table, one barrier a tile), score tiles kept in registers
// and turned into p and ds in place, p and ds fed back as A operands
// (acc_as_a).
//
// The relative term is what the scaled-dot-product kernels do not have.
// Entry (l, s) reads pose row s - l + T - 1, which depends on the row of
// the A operand, so it is not one product. The TPU kernels multiply q_p
// by the band of pose rows a tile meets and realign the result with lane
// rotates (_rel_shift, _rel_unshift in aps_tpu/ops/pallas/
// rel_attention.py); here the realignment is a per-row offset into a small
// tile in shared memory:
//
//   dq: a warp owns 16 query rows l = row0 + li and meets, for a key tile
//     s = s0 + sj, the 16 + kKeys - 1 pose rows s0 - row0 + T - 16 + j.
//     It computes g = q_p . band^T (16 x (kKeys + 16), 1.25 times the
//     entries it needs with 64-key tiles), writes g to its skew tile and
//     reads it back skewed, score(li, sj) += g[li][sj - li + 15]. For
//     dq_p it writes ds un-skewed into the same tile, dg[li][sj - li + 15]
//     = ds[li][sj], zeros elsewhere, and does one product, dq_p += dg .
//     band. Band rows outside [0, 2T - 1) are staged as zeros.
//   dk/dv: K2's dk/dv (attention_bwd.cu) with this relative term. A warp
//     owns 16 key rows s = sw + sj and keeps dk and dv (16 x D each) in
//     registers; a query tile of kDkvQ rows l = l0 + li streams through the
//     ring with q_c, q_p, do, lse, delta and the kDkvKeys + kDkvQ pose rows
//     the block's keys meet. Each warp computes the transposed tiles k .
//     q_c^T and v . do^T, turns them into p^T and ds^T in place and feeds
//     them back: dv += p^T . do, dk += ds^T . q_c. The relative term of
//     entry (sj, li) reads pose row sw + sj - l0 - li + T - 1, which
//     depends on both the A row and the B column; the block computes G =
//     q_p . band^T (kDkvQ x (kDkvKeys + kDkvQ), 1.25 times the entries
//     needed) once a tile, each warp a share of the 8-column fragments,
//     into a shared tile, and each warp reads its 16 x kDkvQ entries back
//     along the diagonal: one barrier more a tile. (A skew tile a warp, as
//     dq's, computes 32 band rows x 16 queries for each 16-query sub-block:
//     twice the entries, no second barrier.)
//   dpose: a warp owns 16 table rows r = rw + rj; for a query tile of 16
//     rows l = l0 + li the relative term is a plain product, pose_w .
//     q_p^T, with the warp's pose fragments split once and held in
//     registers. The content score and dp are the skewed ones: entry (rj,
//     li) reads key l0 + li + rw + rj - (T-1). The block computes q_c .
//     k^T and do . v^T over the 16 + 64 keys the tile meets (16 x 80, 1.25
//     times the entries needed), each warp a share of the 8-key fragments,
//     into shared memory; each warp reads its 16 x 16 entries back along
//     the diagonal, forms ds^T in registers and adds ds^T . q_p. The keys
//     of consecutive query tiles overlap in all but 16 rows, so K and V
//     live in a ring of 16-row chunks and each tile stages one new chunk.
//
// Sizes at D = 64. dq: the block stages q_c, q_p and do once (52 KB) and
// streams 64 keys of K and V and the 128-row pose band through two stages
// (139 KB), plus a skew tile a warp (22 KB): 214 KB and 239 registers, so
// one block of four warps an SM; 512 blocks at the flagship step. dpose:
// the query ring (26 KB), the key ring of six chunks (52 KB) and the two
// score tiles (11 KB): 90 KB and 202 registers, two blocks an SM; 1024
// blocks. Measured at the flagship step on the H100 (PERF.md, parent's
// 0.61 and 0.59 ms): dq 0.221 ms with 64-key tiles against 0.234 with 32
// (200 registers, 154 KB), and 0.267 with 32-key tiles whose owned
// operands are split into TF32 head and remainder once and kept as pairs
// in shared memory (206 KB) instead of at every tile: reading twice the
// bytes from shared memory costs more than the split's integer
// instructions saves. dpose 0.192 ms with 64 table rows a block against
// 0.212 with 32 (two warps, the window 1.5 times the entries needed).
// dk/dv: K and V of the block's 64 keys (35 KB), two stages of 16 query
// rows of q_c, q_p and do with their 80 band rows and row statistics (70
// KB), the shared G (6 KB): 110336 bytes and 147 registers, two blocks an
// SM; 512 blocks at the flagship step. Measured there: 0.158 ms against
// the CUDA-core loop's 0.50, and 0.228 ms with a skew tile a warp instead
// of the shared G (117 KB: one block an SM).
//
// Sizes at D = 128, one block an SM each: dq with 16-key tiles (DqTiles)
// 229,888 bytes; dk/dv 208,640 bytes; dpose 163,584 bytes. The
// accumulators and held fragments double with D, so registers, not shared
// memory, decide what spills there (compare_kernels reads it).

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <type_traits>

#include "attn_tiles.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kLseDead = attn_tiles::kLseDead;

// dq: a block of kWarps warps owns kDqRows query rows, 16 a warp, and
// streams DqTiles<D>::kKeys keys a tile with the kBand pose rows the tile
// meets (one spare row). A warp's relative term covers kWarpBand pose rows
// (one spare) in a skew tile of kSkewLd floats a row. At D = 128 64-key
// tiles would take 394,240 bytes of shared memory, more than a block may
// have (232,448): the key tiles are 16 rows there, and the skew tile's
// stride is 40 floats (8 modulo 32: two-way bank conflicts on its pair
// writes) instead of skew_ld's 56, which would take 233,984 bytes.
constexpr int kDqRows = 16 * kWarps;

template <int D>
struct DqTiles {
  static constexpr int kKeys = D <= 64 ? 64 : 16;
  static constexpr int kBand = kDqRows + kKeys;
  static constexpr int kStage = 2 * kKeys + kBand;  // K, V and band rows
  static constexpr int kWarpBand = 16 + kKeys;
  static constexpr int kSkewLd =
      D <= 64 ? attn_tiles::skew_ld(kWarpBand) : kWarpBand + 8;
  static_assert(kKeys % 8 == 0, "key tiles are whole 8-row fragments");
};

// dpose: a block of kPoseWarps warps owns kPoseRows table rows, 16 a warp;
// a query tile of 16 rows meets kPoseKeys keys (one spare), which a ring
// of kPoseChunks chunks of 16 rows holds with the next tile's new chunk
constexpr int kPoseWarps = 4;
constexpr int kPoseThreads = 32 * kPoseWarps;
constexpr int kPoseRows = 16 * kPoseWarps;
constexpr int kPoseKeys = kPoseRows + 16;
constexpr int kPoseChunks = kPoseKeys / 16 + 1;
constexpr int kPoseFrags = kPoseKeys / 8;
constexpr int kPoseFragsPerWarp = (kPoseFrags + kPoseWarps - 1) / kPoseWarps;
constexpr int kPoseLd = attn_tiles::skew_ld(kPoseKeys);

// dk/dv: a block of kWarps warps owns kDkvKeys key rows, 16 a warp, and
// streams kDkvQ query rows a tile with the kDkvBand pose rows the block's
// keys meet (one spare). The tile's relative term G = q_p . band^T, kDkvQ
// x kDkvBand, is computed once by the block, warp w taking 8-column
// fragments w, w + kWarps, ..., into a shared tile of kDkvGLd floats a row.
constexpr int kDkvKeys = 16 * kWarps;
constexpr int kDkvQ = 16;
constexpr int kDkvBand = kDkvKeys + kDkvQ;
constexpr int kDkvFrags = kDkvBand / 8;
constexpr int kDkvGLd = attn_tiles::skew_ld(kDkvBand);
static_assert(kDkvQ % 8 == 0 && 2 * kDkvQ <= kThreads,
              "query tiles are whole 8-row fragments; one thread stages one "
              "row statistic");

struct Args {
  const float *q_c, *q_p, *k, *v, *pose;
  const int* k_len;
  const float *dout, *lse, *delta;
  int B, H, Hp, T;
  float scale;
  int causal;
};

// floats of dynamic shared memory of the dq kernel: the owned q_c, q_p and
// do, two ring stages of K, V and the pose band, a skew tile a warp
template <int D>
constexpr int dq_smem_floats() {
  return (3 * kDqRows + 2 * DqTiles<D>::kStage) * attn_tiles::tile_ld(D) +
         kWarps * 16 * DqTiles<D>::kSkewLd;
}

// the dpose kernel's: two stages of q_c, q_p, do (16 rows each), lse and
// delta; the K and V rings; the window's content scores and dp
template <int D>
constexpr int dpose_smem_floats() {
  return 2 * (3 * 16 * attn_tiles::tile_ld(D) + 32) +
         2 * kPoseChunks * 16 * attn_tiles::tile_ld(D) + 2 * 16 * kPoseLd;
}

// the dk/dv kernel's: the owned K and V; two stages of q_c, q_p, do, the
// band and the row statistics (lse, delta); the tile's relative term G
template <int D>
__host__ __device__ constexpr int dkv_stage_floats() {
  return (3 * kDkvQ + kDkvBand) * attn_tiles::tile_ld(D) + 2 * kDkvQ;
}

template <int D>
constexpr int dkv_smem_floats() {
  return 2 * kDkvKeys * attn_tiles::tile_ld(D) + 2 * dkv_stage_floats<D>() +
         kDkvQ * kDkvGLd;
}

constexpr int kMaxSmemBytes = 232448;  // a block's limit on sm_90
static_assert(dq_smem_floats<64>() * 4 <= kMaxSmemBytes &&
                  dpose_smem_floats<64>() * 4 <= kMaxSmemBytes &&
                  dq_smem_floats<128>() * 4 <= kMaxSmemBytes &&
                  dpose_smem_floats<128>() * 4 <= kMaxSmemBytes &&
                  dkv_smem_floats<128>() * 4 <= kMaxSmemBytes,
              "a block fits in the SM's shared memory");
// up to D = 64 two dk/dv blocks share an SM (233472 bytes, 1 KB of it
// reserved a block); at D = 128 one does (208,640 bytes)
template <int D>
constexpr int dkv_blocks_per_sm() {
  return D <= 64 ? 2 : 1;
}
static_assert(2 * (dkv_smem_floats<64>() * 4 + 1024) <= 233472,
              "two dk/dv blocks fit in an SM's shared memory");

// dq_c and dq_p of the block's query rows own0 .. own0 + kDqRows; also
// delta = sum(do * out, -1) of those rows, written to delta_out
template <int D>
__global__ void __launch_bounds__(kThreads)
rel_attn_dq_kernel(Args a, const float* __restrict__ out,
                   float* __restrict__ delta_out, float* __restrict__ dq_c,
                   float* __restrict__ dq_p) {
  using namespace attn_tiles;
  constexpr int BS = DqTiles<D>::kKeys;
  constexpr int kDqBand = DqTiles<D>::kBand;
  constexpr int kDqStage = DqTiles<D>::kStage;
  constexpr int kDqWarpBand = DqTiles<D>::kWarpBand;
  constexpr int kDqSkewLd = DqTiles<D>::kSkewLd;
  constexpr int LD = tile_ld(D);
  constexpr int NT = BS / 8;            // 8-wide fragments across a key tile
  constexpr int NG = kDqWarpBand / 8;   // ... across a warp's pose band
  constexpr int ND = D / 8;             // ... across the head dim
  extern __shared__ __align__(16) float smem[];
  float* sqc = smem;
  float* sqp = sqc + kDqRows * LD;
  float* sdo = sqp + kDqRows * LD;
  float* sring = sdo + kDqRows * LD;  // [stage][k, v, band][rows][LD]
  float* sskew = sring + 2 * kDqStage * LD;

  const int T = a.T;
  const int P = 2 * T - 1;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int hp = (a.Hp == 1) ? 0 : bh % a.H;
  const int own0 = blockIdx.x * kDqRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = warp * 16;
  const int row0 = own0 + wrow;  // the warp's first query row
  const size_t head = static_cast<size_t>(bh) * T * D;
  const size_t shead = static_cast<size_t>(bh) * T;
  const float* pose_h = a.pose + static_cast<size_t>(hp) * P * D;
  const int klen = min(T, a.k_len[b]);
  float* skew = sskew + warp * 16 * kDqSkewLd;

  // keys below k_len; under causal none after the block's last row
  int kend = klen;
  if (a.causal) kend = min(kend, own0 + kDqRows);
  const int nt = kend > 0 ? (kend + BS - 1) / BS : 0;

  // key tile s0 meets pose rows s0 - own0 + T - kDqRows .. (band row i);
  // the warp's rows s0 - row0 + T - 16 .. start at band row kDqRows - 16 -
  // wrow
  auto stage_stream = [&](int tile, int st) {
    const int s0 = tile * BS;
    float* dst = sring + st * kDqStage * LD;
    stage_window_async<D, BS, kThreads>(dst, a.k + head, s0, T, tid);
    stage_window_async<D, BS, kThreads>(dst + BS * LD, a.v + head, s0, T,
                                        tid);
    stage_window_async<D, kDqBand, kThreads>(
        dst + 2 * BS * LD, pose_h, s0 - own0 + T - kDqRows, P, tid);
  };

  stage_window_async<D, kDqRows, kThreads>(sqc, a.q_c + head, own0, T, tid);
  stage_window_async<D, kDqRows, kThreads>(sqp, a.q_p + head, own0, T, tid);
  stage_window_async<D, kDqRows, kThreads>(sdo, a.dout + head, own0, T, tid);
  if (nt > 0) stage_stream(0, 0);
  cp_async_commit();
  // delta of the warp's 16 rows from device memory (the sum of each row
  // is on every lane after the butterfly); rows g and g + 8 are kept
  float row_lse[2] = {kLseDead, kLseDead};
  float row_delta[2] = {0.f, 0.f};
  for (int r = 0; r < 16; ++r) {
    const int l = row0 + r;
    float part = 0.f;
    if (l < T) {
      const size_t at = head + static_cast<size_t>(l) * D;
      for (int d = lane; d < D; d += 32) part += a.dout[at + d] * out[at + d];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, off);
    }
    if (lane == 0 && l < T) delta_out[shead + l] = part;
    if (r == g) row_delta[0] = part;
    if (r == g + 8) row_delta[1] = part;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = row0 + g + 8 * h;
    if (l < T) row_lse[h] = a.lse[shead + l];
  }

  float acc_c[ND][4], acc_p[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc_c[n][c] = 0.f;
      acc_p[n][c] = 0.f;
    }
  }

  cp_async_wait<0>();
  __syncthreads();
  for (int tile = 0; tile < nt; ++tile) {
    if (tile > 0) {
      // this tile has landed, and every warp is done with the previous one
      cp_async_wait<0>();
      __syncthreads();
    }
    if (tile + 1 < nt) {
      stage_stream(tile + 1, (tile + 1) & 1);
      cp_async_commit();
    }
    const int s0 = tile * BS;
    // nothing visible to the warp: rows past T, or keys after its last row
    if (row0 >= T || (a.causal && s0 > row0 + 15)) continue;
    const float* tk = sring + (tile & 1) * kDqStage * LD;
    const float* tv = tk + BS * LD;
    const float* tband = tv + BS * LD + (kDqRows - 16 - wrow) * LD;

    // s = q_c . k^T and dp = do . v^T, 16 x BS
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = 0.f;
        dp[j][c] = 0.f;
      }
    }
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 8) {
      FragA ac, ad;
      FragB bk[NT], bv[NT];
      load_a<LD>(ac, sqc, wrow, k0, g, t);
      load_a<LD>(ad, sdo, wrow, k0, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        load_b_rows_n<LD>(bk[j], tk, 8 * j, k0, g, t);
        load_b_rows_n<LD>(bv[j], tv, 8 * j, k0, g, t);
      }
      mma_f32<NT>(s, ac, bk);
      mma_f32<NT>(dp, ad, bv);
    }

    // the relative term: g = q_p . band^T over the warp's pose rows, then
    // score (li, sj) += g[li][sj - li + 15] through the skew tile
    {
      float gq[NG][4];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) gq[j][c] = 0.f;
      }
#pragma unroll 2
      for (int k0 = 0; k0 < D; k0 += 8) {
        FragA ap;
        FragB bb[NG];
        load_a<LD>(ap, sqp, wrow, k0, g, t);
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          load_b_rows_n<LD>(bb[j], tband, 8 * j, k0, g, t);
        }
        mma_f32<NG>(gq, ap, bb);
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float2*>(skew + (g + 8 * h) * kDqSkewLd + 8 * j +
                                     2 * t) =
              make_float2(gq[j][2 * h], gq[j][2 * h + 1]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int li = g + 8 * (c / 2);
          const int sj = 8 * j + 2 * t + (c & 1);
          s[j][c] += skew[li * kDqSkewLd + sj - li + 15];
        }
      }
      __syncwarp();
    }

    // in place: s -> p, dp -> ds = p * (dp - delta) * scale. A warp whose
    // 16 x BS tile lies wholly inside the mask skips the tests.
    const int s_hi = s0 + BS - 1;
    const bool inside =
        row0 + 15 < T && s_hi < klen && (!a.causal || s_hi <= row0);
    auto soften = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int h = c / 2;
          bool ok = true;
          if (kMasked) {
            ok = visible(row0 + g + 8 * h, s0 + 8 * j + 2 * t + (c & 1), T,
                         klen, a.causal);
          }
          const float p = ok ? __expf(s[j][c] * a.scale - row_lse[h]) : 0.f;
          s[j][c] = p;
          dp[j][c] = p * (dp[j][c] - row_delta[h]) * a.scale;
        }
      }
    };
    if (inside) {
      soften(std::false_type{});
    } else {
      soften(std::true_type{});
    }

    // ds un-skewed into the skew tile, dg[li][sj - li + 15] = ds[li][sj],
    // and zeros in the 16 other columns of each row, [0, 15 - li) and
    // [15 - li + BS, BS + 16)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int li = g + 8 * (c / 2);
        const int sj = 8 * j + 2 * t + (c & 1);
        skew[li * kDqSkewLd + sj - li + 15] = dp[j][c];
      }
    }
    constexpr int kZeros = 16 * (kDqWarpBand - BS) / 32;  // a lane's
#pragma unroll
    for (int i = 0; i < kZeros; ++i) {
      const int e = lane * kZeros + i;
      const int li = e / (kDqWarpBand - BS);
      const int k = e - li * (kDqWarpBand - BS);
      skew[li * kDqSkewLd + (k < 15 - li ? k : k + BS)] = 0.f;
    }
    __syncwarp();

    // dq_c += ds . k (ds as it lies in the registers)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragA ads;
      FragB bf[ND];
      acc_as_a(ads, dp[j]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        load_b_rows_k<LD>(bf[n], tk, 8 * j, 8 * n, g, t);
      }
      mma_f32<ND>(acc_c, ads, bf);
    }
    // dq_p += dg . band
#pragma unroll 2
    for (int j = 0; j < NG; ++j) {
      FragA adg;
      FragB bf[ND];
      load_a_acc<kDqSkewLd>(adg, skew, 0, 8 * j, g, t);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        load_b_rows_k<LD>(bf[n], tband, 8 * j, 8 * n, g, t);
      }
      mma_f32<ND>(acc_p, adg, bf);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = row0 + g + 8 * h;
    if (l >= T) continue;
    const size_t at = head + static_cast<size_t>(l) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(dq_c + at + 8 * n) =
          make_float2(acc_c[n][2 * h], acc_c[n][2 * h + 1]);
      *reinterpret_cast<float2*>(dq_p + at + 8 * n) =
          make_float2(acc_p[n][2 * h], acc_p[n][2 * h + 1]);
    }
  }
}

// dk and dv of the block's key rows own0 .. own0 + kDkvKeys (zeros for keys
// past k_len)
template <int D>
__global__ void __launch_bounds__(kThreads, dkv_blocks_per_sm<D>())
rel_attn_dkv_kernel(Args a, float* __restrict__ dk, float* __restrict__ dv) {
  using namespace attn_tiles;
  constexpr int LD = tile_ld(D);
  constexpr int NQ = kDkvQ / 8;  // 8-wide fragments across a query tile
  constexpr int ND = D / 8;      // ... across the head dim
  constexpr int kStage = dkv_stage_floats<D>();
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sv = sk + kDkvKeys * LD;
  float* sring = sv + kDkvKeys * LD;  // [stage][q_c, q_p, do, band, stats]
  float* sg = sring + 2 * kStage;     // [kDkvQ][kDkvGLd]: G of the tile

  const int T = a.T;
  const int P = 2 * T - 1;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int hp = (a.Hp == 1) ? 0 : bh % a.H;
  const int own0 = blockIdx.x * kDkvKeys;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = warp * 16;
  const int sw = own0 + wrow;  // the warp's first key row
  const size_t head = static_cast<size_t>(bh) * T * D;
  const size_t shead = static_cast<size_t>(bh) * T;
  const float* pose_h = a.pose + static_cast<size_t>(hp) * P * D;
  const int klen = min(T, a.k_len[b]);

  // the query tiles the block's keys can see: none past k_len (their
  // gradients are exactly 0), and under causal only rows l >= s see key s,
  // so the first tile is the one that holds row own0
  const int beg = a.causal ? own0 : 0;
  const int end = own0 < klen ? T : 0;
  const int nt = end > beg ? (end - beg + kDkvQ - 1) / kDkvQ : 0;

  // query tile l0 meets pose rows own0 - l0 - kDkvQ + T .. (band row i):
  // entry (sw + sj, l0 + li) is band row wrow + sj - li + kDkvQ - 1
  auto stage_stream = [&](int tile, int st) {
    const int l0 = beg + tile * kDkvQ;
    float* dst = sring + st * kStage;
    stage_window_async<D, kDkvQ, kThreads>(dst, a.q_c + head, l0, T, tid);
    stage_window_async<D, kDkvQ, kThreads>(dst + kDkvQ * LD, a.q_p + head,
                                           l0, T, tid);
    stage_window_async<D, kDkvQ, kThreads>(dst + 2 * kDkvQ * LD,
                                           a.dout + head, l0, T, tid);
    stage_window_async<D, kDkvBand, kThreads>(
        dst + 3 * kDkvQ * LD, pose_h, own0 - l0 - kDkvQ + T, P, tid);
    if (tid < 2 * kDkvQ) {
      const int which = tid / kDkvQ;  // 0 lse, 1 delta
      const int l = l0 + tid - which * kDkvQ;
      const bool ok = l < T;
      cp_async_4(dst + (3 * kDkvQ + kDkvBand) * LD + tid,
                 (which ? a.delta : a.lse) + shead + (ok ? l : 0), ok);
    }
  };

  stage_window_async<D, kDkvKeys, kThreads>(sk, a.k + head, own0, T, tid);
  stage_window_async<D, kDkvKeys, kThreads>(sv, a.v + head, own0, T, tid);
  if (nt > 0) stage_stream(0, 0);
  cp_async_commit();

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc_k[n][c] = 0.f;
      acc_v[n][c] = 0.f;
    }
  }

  // this warp's share of G: fragments warp, warp + kWarps, ... (the first
  // kDkvFrags % kWarps warps take one more)
  auto rel_share = [&](const float* tqp, const float* tband, auto count) {
    constexpr int NW = decltype(count)::value;
    float gq[NW][4];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) gq[i][c] = 0.f;
    }
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 8) {
      FragA ap;
      FragB bb[NW];
      load_a<LD>(ap, tqp, 0, k0, g, t);
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        load_b_rows_n<LD>(bb[i], tband, 8 * (warp + kWarps * i), k0, g, t);
      }
      mma_f32<NW>(gq, ap, bb);
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(sg + (g + 8 * h) * kDkvGLd +
                                   8 * (warp + kWarps * i) + 2 * t) =
            make_float2(gq[i][2 * h], gq[i][2 * h + 1]);
      }
    }
  };

  for (int tile = 0; tile < nt; ++tile) {
    // this tile has landed, and every warp is done with the previous one
    // (its G included)
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < nt) {
      stage_stream(tile + 1, (tile + 1) & 1);
      cp_async_commit();
    }
    const float* tqc = sring + (tile & 1) * kStage;
    const float* tqp = tqc + kDkvQ * LD;
    const float* tdo = tqp + kDkvQ * LD;
    const float* tband = tdo + kDkvQ * LD;
    const float* tstat = tband + kDkvBand * LD;  // lse [kDkvQ], delta
    const int l0 = beg + tile * kDkvQ;
    // nothing visible to the warp: keys past k_len, or (causal) keys after
    // the tile's last row
    const bool live = sw < klen && !(a.causal && sw > l0 + kDkvQ - 1);

    if (warp < kDkvFrags % kWarps) {
      rel_share(tqp, tband,
                std::integral_constant<int, kDkvFrags / kWarps + 1>{});
    } else {
      rel_share(tqp, tband, std::integral_constant<int, kDkvFrags / kWarps>{});
    }

    // s^T = k . q_c^T and dp^T = v . do^T, 16 keys x kDkvQ queries a warp
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = 0.f;
        dp[j][c] = 0.f;
      }
    }
    if (live) {
#pragma unroll 2
      for (int k0 = 0; k0 < D; k0 += 8) {
        FragA ak, av;
        FragB bq[NQ], bd[NQ];
        load_a<LD>(ak, sk, wrow, k0, g, t);
        load_a<LD>(av, sv, wrow, k0, g, t);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          load_b_rows_n<LD>(bq[j], tqc, 8 * j, k0, g, t);
          load_b_rows_n<LD>(bd[j], tdo, 8 * j, k0, g, t);
        }
        mma_f32<NQ>(s, ak, bq);
        mma_f32<NQ>(dp, av, bd);
      }
    }
    __syncthreads();  // G is in place
    if (!live) continue;

    // in place: s^T plus G read along the diagonal -> p^T, dp^T -> ds^T =
    // p^T * (dp^T - delta) * scale. A warp whose 16 x kDkvQ tile lies
    // wholly inside the mask skips the tests.
    const bool inside = l0 + kDkvQ - 1 < T && sw + 15 < klen &&
                        (!a.causal || sw + 15 <= l0);
    auto soften = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int sj = g + 8 * (c / 2);
          const int li = 8 * j + 2 * t + (c & 1);
          const float x =
              (s[j][c] + sg[li * kDkvGLd + wrow + sj - li + kDkvQ - 1]) *
              a.scale;
          bool ok = true;
          if (kMasked) ok = visible(l0 + li, sw + sj, T, klen, a.causal);
          const float p = ok ? __expf(x - tstat[li]) : 0.f;
          s[j][c] = p;
          dp[j][c] = p * (dp[j][c] - tstat[kDkvQ + li]) * a.scale;
        }
      }
    };
    if (inside) {
      soften(std::false_type{});
    } else {
      soften(std::true_type{});
    }

    // dv += p^T . do and dk += ds^T . q_c: the tile is the A operand, the
    // tile's query rows are summed over
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      FragA ap, ads;
      FragB bf[ND];
      acc_as_a(ap, s[j]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        load_b_rows_k<LD>(bf[n], tdo, 8 * j, 8 * n, g, t);
      }
      mma_f32<ND>(acc_v, ap, bf);
      acc_as_a(ads, dp[j]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        load_b_rows_k<LD>(bf[n], tqc, 8 * j, 8 * n, g, t);
      }
      mma_f32<ND>(acc_k, ads, bf);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = sw + g + 8 * h;
    if (s >= T) continue;
    const size_t at = head + static_cast<size_t>(s) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(dk + at + 8 * n) =
          make_float2(acc_k[n][2 * h], acc_k[n][2 * h + 1]);
      *reinterpret_cast<float2*>(dv + at + 8 * n) =
          make_float2(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
    }
  }
}

// partial: (B*H) x (2T-1) x D; this block writes rows r0 .. r0 + kPoseRows
// of head bh (zeros where no entry reaches them)
template <int D>
__global__ void __launch_bounds__(kPoseThreads)
rel_attn_dpose_kernel(Args a, float* __restrict__ partial) {
  using namespace attn_tiles;
  constexpr int LD = tile_ld(D);
  constexpr int ND = D / 8;
  constexpr int NW = kPoseFragsPerWarp;
  constexpr int kQStage = 3 * 16 * LD + 32;  // q_c, q_p, do; lse, delta
  constexpr int kRing = kPoseChunks * 16 * LD;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;              // [stage][kQStage]
  float* sk = sq + 2 * kQStage;  // [kPoseChunks * 16][LD]
  float* sv = sk + kRing;
  float* sc = sv + kRing;        // [16][kPoseLd]: q_c . k^T of the window
  float* sdp = sc + 16 * kPoseLd;  // do . v^T

  const int T = a.T;
  const int P = 2 * T - 1;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int hp = (a.Hp == 1) ? 0 : bh % a.H;
  const int r0 = blockIdx.x * kPoseRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rw = r0 + 16 * warp;  // the warp's first table row
  const size_t head = static_cast<size_t>(bh) * T * D;
  const size_t shead = static_cast<size_t>(bh) * T;
  const float* pose_h = a.pose + static_cast<size_t>(hp) * P * D;
  const int kend = min(T, a.k_len[b]);

  // entry (l, r) is key s = l + r - (T-1): rows l with a valid key for
  // some r of this block are T-1-r1 <= l < kend + T-1 - r0; under causal
  // only diagonals r <= T-1 (s <= l) carry anything
  const int r1 = min(r0 + kPoseRows, P) - 1;
  const int llo = max(0, T - 1 - r1);
  int lhi = min(T, kend + T - 1 - r0);
  if (kend == 0 || (a.causal && r0 > T - 1)) lhi = 0;
  const int lfirst = (llo / 16) * 16;
  const int nt = lhi > lfirst ? (lhi - lfirst + 15) / 16 : 0;
  // query tile n meets keys sb0 + 16 n .. + kPoseKeys; key sb0 + i lies in
  // chunk (i / 16) mod kPoseChunks of the ring
  const int sb0 = lfirst + r0 - (T - 1);
  const bool live = rw < P && !(a.causal && rw > T - 1);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  }

  if (nt > 0) {
    auto stage_q = [&](int tile, int st) {
      const int l0 = lfirst + 16 * tile;
      float* dst = sq + st * kQStage;
      stage_window_async<D, 16, kPoseThreads>(dst, a.q_c + head, l0, T, tid);
      stage_window_async<D, 16, kPoseThreads>(dst + 16 * LD, a.q_p + head,
                                              l0, T, tid);
      stage_window_async<D, 16, kPoseThreads>(dst + 32 * LD, a.dout + head,
                                              l0, T, tid);
      if (tid < 32) {
        const int l = l0 + tid % 16;
        const bool ok = l < T;
        cp_async_4(dst + 48 * LD + tid,
                   (tid < 16 ? a.lse : a.delta) + shead + (ok ? l : 0), ok);
      }
    };
    stage_q(0, 0);
    stage_window_async<D, kPoseKeys, kPoseThreads>(sk, a.k + head, sb0, T,
                                                   tid);
    stage_window_async<D, kPoseKeys, kPoseThreads>(sv, a.v + head, sb0, T,
                                                   tid);
    cp_async_commit();

    // the warp's 16 pose rows as A fragments, split once (rows past the
    // table are 0)
    FragA pa[ND];
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const int ra = rw + g;
      const int rb = ra + 8;
      const float* pa_row = pose_h + static_cast<size_t>(ra) * D + 8 * kk + t;
      const float* pb_row = pa_row + 8 * D;
      const float x[4] = {ra < P ? pa_row[0] : 0.f, rb < P ? pb_row[0] : 0.f,
                          ra < P ? pa_row[4] : 0.f, rb < P ? pb_row[4] : 0.f};
      pa[kk].set(x);
    }

    for (int tile = 0; tile < nt; ++tile) {
      // this tile has landed, and every warp is done with the previous one
      cp_async_wait<0>();
      __syncthreads();
      if (tile + 1 < nt) {
        stage_q(tile + 1, (tile + 1) & 1);
        // the next tile's one new chunk, in the slot the previous tile
        // alone used
        const int chunk = tile + kPoseChunks - 1;
        const int slot = (chunk % kPoseChunks) * 16 * LD;
        stage_window_async<D, 16, kPoseThreads>(sk + slot, a.k + head,
                                                sb0 + 16 * chunk, T, tid);
        stage_window_async<D, 16, kPoseThreads>(sv + slot, a.v + head,
                                                sb0 + 16 * chunk, T, tid);
        cp_async_commit();
      }
      const float* tqc = sq + (tile & 1) * kQStage;
      const float* tqp = tqc + 16 * LD;
      const float* tdo = tqp + 16 * LD;
      const float* tstat = tdo + 16 * LD;  // lse [16], delta [16]
      const int l0 = lfirst + 16 * tile;

      // q_c . k^T and do . v^T over the window, 16 x kPoseKeys: this warp
      // takes fragments warp, warp + kPoseWarps, ... (the last index
      // repeated where the fragments run out; not stored)
      {
        float cs[NW][4], cd[NW][4];
        int krow[NW];  // ring row of the key of fragment column g
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          const int j = min(warp + kPoseWarps * i, kPoseFrags - 1);
          krow[i] = ((tile + j / 2) % kPoseChunks) * 16 + 8 * (j & 1) + g;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            cs[i][c] = 0.f;
            cd[i][c] = 0.f;
          }
        }
#pragma unroll 2
        for (int k0 = 0; k0 < D; k0 += 8) {
          FragA ac, ad;
          FragB bk[NW], bv[NW];
          load_a<LD>(ac, tqc, 0, k0, g, t);
          load_a<LD>(ad, tdo, 0, k0, g, t);
#pragma unroll
          for (int i = 0; i < NW; ++i) {
            const float* pk = sk + krow[i] * LD + k0 + t;
            const float* pv = sv + krow[i] * LD + k0 + t;
            const float xk[2] = {pk[0], pk[4]};
            const float xv[2] = {pv[0], pv[4]};
            bk[i].set(xk);
            bv[i].set(xv);
          }
          mma_f32<NW>(cs, ac, bk);
          mma_f32<NW>(cd, ad, bv);
        }
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          const int j = warp + kPoseWarps * i;
          if (j >= kPoseFrags) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int at = (g + 8 * h) * kPoseLd + 8 * j + 2 * t;
            *reinterpret_cast<float2*>(sc + at) =
                make_float2(cs[i][2 * h], cs[i][2 * h + 1]);
            *reinterpret_cast<float2*>(sdp + at) =
                make_float2(cd[i][2 * h], cd[i][2 * h + 1]);
          }
        }
      }

      // the relative term, a plain product: pose_w . q_p^T, 16 table rows
      // x 16 query rows
      float rel[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int c = 0; c < 4; ++c) rel[jj][c] = 0.f;
      }
      if (live) {
#pragma unroll
        for (int kk = 0; kk < ND; ++kk) {
          FragB bq[2];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            load_b_rows_n<LD>(bq[jj], tqp, 8 * jj, 8 * kk, g, t);
          }
          mma_f32<2>(rel, pa[kk], bq);
        }
      }
      __syncthreads();  // the window's content scores and dp are in place
      if (!live) continue;

      // ds^T in place of rel: entry (rj, li) reads key l0 + li + rw + rj -
      // (T-1), column li + rj + 16 warp of the window
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int rj = g + 8 * (c / 2);
          const int li = 8 * jj + 2 * t + (c & 1);
          const int col = li + rj + 16 * warp;
          const int l = l0 + li;
          const int r = rw + rj;
          const int s = l + r - (T - 1);
          const bool ok = l < T && r < P && s >= 0 && s < kend &&
                          (!a.causal || s <= l);
          const float x = (rel[jj][c] + sc[li * kPoseLd + col]) * a.scale;
          const float p = ok ? __expf(x - tstat[li]) : 0.f;
          rel[jj][c] =
              p * (sdp[li * kPoseLd + col] - tstat[16 + li]) * a.scale;
        }
      }
      // dpose += ds^T . q_p
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        FragA ads;
        FragB bf[ND];
        acc_as_a(ads, rel[jj]);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          load_b_rows_k<LD>(bf[n], tqp, 8 * jj, 8 * n, g, t);
        }
        mma_f32<ND>(acc, ads, bf);
      }
    }
  }

  float* out = partial + static_cast<size_t>(bh) * P * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rw + g + 8 * h;
    if (row >= P) continue;
    float* at = out + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(at + 8 * n) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// dpose[hp, i] = sum of partial[b*H + h, i] over b, and over h when the table
// is shared (Hp == 1), in a fixed order. n = (2T-1) * D floats per table.
__global__ void rel_attn_dpose_reduce_kernel(const float* __restrict__ partial,
                                             int B, int H, int Hp, int n,
                                             float* __restrict__ dpose) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int hp = blockIdx.y;
  if (i >= n) return;
  float sum = 0.f;
  if (Hp == 1) {
    for (int g = 0; g < B * H; ++g) {
      sum += partial[static_cast<size_t>(g) * n + i];
    }
  } else {
    for (int g = 0; g < B; ++g) {
      sum += partial[static_cast<size_t>(g * H + hp) * n + i];
    }
  }
  dpose[static_cast<size_t>(hp) * n + i] = sum;
}

// The three kernels take more than 48 KB of dynamic shared memory, and the
// SM's split between shared memory and L1 goes to shared memory. A
// function's attributes belong to a device: set once for each kernel and
// device, at its first launch or query there (setting them twice does no
// harm)
constexpr int kMaxDevices = 64;

// the kernels, in the order of the occupancy entry's argument
enum Kernel { kDq = 0, kDkv = 1, kDpose = 2 };

template <int D, Kernel K>
struct Tiles {
  static constexpr int kBytes =
      (K == kDq ? dq_smem_floats<D>()
                : K == kDkv ? dkv_smem_floats<D>() : dpose_smem_floats<D>()) *
      static_cast<int>(sizeof(float));
  static constexpr int kThreadsOf = K == kDpose ? kPoseThreads : kThreads;
  static const void* kernel() {
    if (K == kDq) return reinterpret_cast<const void*>(rel_attn_dq_kernel<D>);
    if (K == kDkv) return reinterpret_cast<const void*>(rel_attn_dkv_kernel<D>);
    return reinterpret_cast<const void*>(rel_attn_dpose_kernel<D>);
  }
  static cudaError_t attributes() {
    static std::atomic<bool> done[kMaxDevices];
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return rc;
    const bool known = dev >= 0 && dev < kMaxDevices;
    if (known && done[dev].load(std::memory_order_acquire)) {
      return cudaSuccess;
    }
    rc = cudaFuncSetAttribute(kernel(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kBytes);
    if (rc != cudaSuccess) return rc;
    rc = cudaFuncSetAttribute(kernel(),
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
    if (rc == cudaSuccess && known) {
      done[dev].store(true, std::memory_order_release);
    }
    return rc;
  }
};

template <int D>
cudaError_t launch_dq(const Args& a, const float* out, float* delta_out,
                      float* dq_c, float* dq_p, cudaStream_t s) {
  using Dq = Tiles<D, kDq>;
  const cudaError_t rc = Dq::attributes();
  if (rc != cudaSuccess) return rc;
  dim3 grid((a.T + kDqRows - 1) / kDqRows, a.B * a.H);
  rel_attn_dq_kernel<D><<<grid, kThreads, Dq::kBytes, s>>>(a, out, delta_out,
                                                           dq_c, dq_p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, float* dk, float* dv, cudaStream_t s) {
  using Dkv = Tiles<D, kDkv>;
  const cudaError_t rc = Dkv::attributes();
  if (rc != cudaSuccess) return rc;
  dim3 grid((a.T + kDkvKeys - 1) / kDkvKeys, a.B * a.H);
  rel_attn_dkv_kernel<D><<<grid, kThreads, Dkv::kBytes, s>>>(a, dk, dv);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dpose(const Args& a, float* partial, float* dpose,
                         cudaStream_t s) {
  using Pose = Tiles<D, kDpose>;
  cudaError_t rc = Pose::attributes();
  if (rc != cudaSuccess) return rc;
  const int P = 2 * a.T - 1;
  dim3 grid((P + kPoseRows - 1) / kPoseRows, a.B * a.H);
  rel_attn_dpose_kernel<D><<<grid, kPoseThreads, Pose::kBytes, s>>>(
      a, partial);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const int n = P * D;
  dim3 rgrid((n + 255) / 256, a.Hp);
  rel_attn_dpose_reduce_kernel<<<rgrid, 256, 0, s>>>(partial, a.B, a.H, a.Hp,
                                                     n, dpose);
  return cudaGetLastError();
}

// registers a thread, bytes of local memory a thread (spills), bytes of
// dynamic shared memory and resident blocks an SM of kernel K
template <int D, Kernel K>
cudaError_t tiles_occupancy(int* info) {
  using Kn = Tiles<D, K>;
  cudaError_t rc = Kn::attributes();
  if (rc != cudaSuccess) return rc;
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, Kn::kernel());
  if (rc != cudaSuccess) return rc;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = Kn::kBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      info + 3, Kn::kernel(), Kn::kThreadsOf, Kn::kBytes);
}

template <int D>
cudaError_t occupancy(int kernel, int* info) {
  info[4] = kernel == kDq ? DqTiles<D>::kKeys
                          : kernel == kDkv ? kDkvQ : kPoseRows;
  switch (kernel) {
    case kDq: return tiles_occupancy<D, kDq>(info);
    case kDkv: return tiles_occupancy<D, kDkv>(info);
    case kDpose: return tiles_occupancy<D, kDpose>(info);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_dims(int B, int H, int Hp, int T) {
  return B <= 0 || H <= 0 || T <= 0 || (Hp != 1 && Hp != H);
}

}  // namespace

extern "C" const char* aps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define APS_DISPATCH_D(D, fn, ...)                                \
  switch (D) {                                                    \
    case 16: return static_cast<int>(fn<16>(__VA_ARGS__));        \
    case 32: return static_cast<int>(fn<32>(__VA_ARGS__));        \
    case 64: return static_cast<int>(fn<64>(__VA_ARGS__));        \
    case 128: return static_cast<int>(fn<128>(__VA_ARGS__));      \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }

// Shapes as in the forward: q_c, q_p, k, v, dout, out and the outputs B x H
// x T x D; pose Hp x (2T-1) x D; k_len B int32; lse, delta B x H x T. All
// float32 (k_len int32), contiguous, on the device, 16-byte aligned. D in
// {16, 32, 64, 128}. dq reads the forward's output `out` and WRITES delta =
// sum(dout * out, -1); dk/dv and dpose read that delta, so dq is launched
// first.
extern "C" int aps_rel_attention_dq(
    const float* q_c, const float* q_p, const float* k, const float* v,
    const float* pose, const int* k_len, const float* dout, const float* lse,
    float* delta, int B, int H, int Hp, int T, int D, float scale,
    int causal, float* dq_c, float* dq_p, const float* out, void* stream) {
  if (bad_dims(B, H, Hp, T) || out == nullptr || delta == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q_c, q_p, k, v, pose, k_len, dout, lse, nullptr,
               B, H, Hp, T, scale, causal};
  APS_DISPATCH_D(D, launch_dq, a, out, delta, dq_c, dq_p,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int aps_rel_attention_dkv(
    const float* q_c, const float* q_p, const float* k, const float* v,
    const float* pose, const int* k_len, const float* dout, const float* lse,
    const float* delta, int B, int H, int Hp, int T, int D, float scale,
    int causal, float* dk, float* dv, void* stream) {
  if (bad_dims(B, H, Hp, T)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q_c, q_p, k, v, pose, k_len, dout, lse, delta,
               B, H, Hp, T, scale, causal};
  APS_DISPATCH_D(D, launch_dkv, a, dk, dv, static_cast<cudaStream_t>(stream));
}

// partial: scratch of B*H x (2T-1) x D floats; dpose: Hp x (2T-1) x D.
extern "C" int aps_rel_attention_dpose(
    const float* q_c, const float* q_p, const float* k, const float* v,
    const float* pose, const int* k_len, const float* dout, const float* lse,
    const float* delta, int B, int H, int Hp, int T, int D, float scale,
    int causal, float* partial, float* dpose, void* stream) {
  if (bad_dims(B, H, Hp, T)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q_c, q_p, k, v, pose, k_len, dout, lse, delta,
               B, H, Hp, T, scale, causal};
  APS_DISPATCH_D(D, launch_dpose, a, partial, dpose,
                 static_cast<cudaStream_t>(stream));
}

// How the dq (kernel 0), dk/dv (1) or dpose (2) kernel sits on an SM at
// head dim D: info = {registers a thread, bytes of local memory a thread,
// bytes of dynamic shared memory a block, resident blocks an SM, key rows of
// a dq tile, query rows of a dk/dv tile or table rows of a dpose block}.
extern "C" int aps_rel_attention_bwd_occupancy(int D, int kernel, int* info) {
  APS_DISPATCH_D(D, occupancy, kernel, info);
}
