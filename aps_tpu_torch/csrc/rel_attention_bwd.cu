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
//   dk/dv: one block per (32 key rows, b*h), loop over query tiles;
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
// (the scores' two, dp, ds.k, ds.pose), dpose 4 and dk/dv 5, on a few T D
// floats: arithmetic, not device memory. dk/dv still runs them on the CUDA
// cores from shared memory (one thread per score, two shared loads per
// multiply-add, 16 x 32 tiles restaged between barriers), at a tenth of the
// float32 rate. dq and dpose run every product on the tensor cores with
// the pieces of attn_tiles.cuh that K2's kernels are built from: mma.sync
// m16n8k8 on TF32 operands split in three (head and remainder of either
// operand, float32 accumulators: float32's accuracy), operands streamed
// through a cp.async ring (zero fill past the ends of the keys and of the
// table, one barrier a tile), score tiles kept in registers and turned
// into p and ds in place, ds fed back as an A operand (acc_as_a).
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
//     s = s0 + sj, the 16 + kDqKeys - 1 pose rows s0 - row0 + T - 16 + j.
//     It computes g = q_p . band^T (16 x (kDqKeys + 16), 1.25 times the
//     entries it needs with 64-key tiles), writes g to its skew tile and
//     reads it back skewed, score(li, sj) += g[li][sj - li + 15]. For
//     dq_p it writes ds un-skewed into the same tile, dg[li][sj - li + 15]
//     = ds[li][sj], zeros elsewhere, and does one product, dq_p += dg .
//     band. Band rows outside [0, 2T - 1) are staged as zeros.
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

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <type_traits>

#include "attn_tiles.cuh"

namespace {

// dk/dv: 16 x 32 tiles on the CUDA cores
constexpr int kBQ = 16;   // query rows of a tile
constexpr int kBK = 32;   // key rows of a tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKRowsPerWarp = kBK / kWarps;
constexpr int kBand = kBQ + kBK - 1;
constexpr float kLseDead = attn_tiles::kLseDead;

// dq: a block of kWarps warps owns kDqRows query rows, 16 a warp, and
// streams kDqKeys keys a tile with the kDqBand pose rows the tile meets
// (one spare row). A warp's relative term covers kDqWarpBand pose rows
// (one spare) in a skew tile of kDqSkewLd floats a row.
constexpr int kDqRows = 16 * kWarps;
constexpr int kDqKeys = 64;
constexpr int kDqBand = kDqRows + kDqKeys;
constexpr int kDqStage = 2 * kDqKeys + kDqBand;  // K, V and band rows
constexpr int kDqWarpBand = 16 + kDqKeys;
constexpr int kDqSkewLd = attn_tiles::skew_ld(kDqWarpBand);
static_assert(kDqKeys % 8 == 0, "key tiles are whole 8-row fragments");

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

// rows [first, first + rows) of a (limit x D) matrix -> dst, zeros outside
template <int D>
__device__ __forceinline__ void stage_rows(float (*dst)[D + 1],
                                           const float* __restrict__ src,
                                           int first, int rows, int limit,
                                           int tid) {
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int g = first + r;
    dst[r][d] = (g >= 0 && g < limit)
                    ? src[static_cast<size_t>(g) * D + d]
                    : 0.f;
  }
}

__device__ __forceinline__ void stage_row_stats(float* slse, float* sdelta,
                                                const float* __restrict__ lse,
                                                const float* __restrict__ delta,
                                                int l0, int T, int tid) {
  if (tid < kBQ) {
    const bool ok = l0 + tid < T;
    slse[tid] = ok ? lse[l0 + tid] : kLseDead;
    sdelta[tid] = ok ? delta[l0 + tid] : 0.f;
  }
}

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
  return (3 * kDqRows + 2 * kDqStage) * attn_tiles::tile_ld(D) +
         kWarps * 16 * kDqSkewLd;
}

// the dpose kernel's: two stages of q_c, q_p, do (16 rows each), lse and
// delta; the K and V rings; the window's content scores and dp
template <int D>
constexpr int dpose_smem_floats() {
  return 2 * (3 * 16 * attn_tiles::tile_ld(D) + 32) +
         2 * kPoseChunks * 16 * attn_tiles::tile_ld(D) + 2 * 16 * kPoseLd;
}

constexpr int kMaxSmemBytes = 232448;  // a block's limit on sm_90
static_assert(dq_smem_floats<64>() * 4 <= kMaxSmemBytes &&
                  dpose_smem_floats<64>() * 4 <= kMaxSmemBytes,
              "a block fits in the SM's shared memory");

// dq_c and dq_p of the block's query rows own0 .. own0 + kDqRows; also
// delta = sum(do * out, -1) of those rows, written to delta_out
template <int D>
__global__ void __launch_bounds__(kThreads)
rel_attn_dq_kernel(Args a, const float* __restrict__ out,
                   float* __restrict__ delta_out, float* __restrict__ dq_c,
                   float* __restrict__ dq_p) {
  using namespace attn_tiles;
  constexpr int BS = kDqKeys;
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

template <int D>
__global__ void rel_attn_dkv_kernel(
    const float* __restrict__ q_c, const float* __restrict__ q_p,
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ pose, const int* __restrict__ k_len,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, int H, int Hp, int T, float scale,
    int causal, float* __restrict__ dk, float* __restrict__ dv) {
  constexpr int DP = D + 1;
  constexpr int DPL = (D + 31) / 32;
  __shared__ float sqc[kBQ][DP];
  __shared__ float sqp[kBQ][DP];
  __shared__ float sdo[kBQ][DP];
  __shared__ float sk[kBK][DP];
  __shared__ float sv[kBK][DP];
  __shared__ float sband[kBand][DP];
  __shared__ float sp[kBQ][kBK + 1];
  __shared__ float sds[kBQ][kBK + 1];
  __shared__ float slse[kBQ];
  __shared__ float sdelta[kBQ];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hp = (Hp == 1) ? 0 : bh % H;
  const int s0 = blockIdx.x * kBK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t head = static_cast<size_t>(bh) * T * D;
  const float* pose_h = pose + static_cast<size_t>(hp) * (2 * T - 1) * D;
  const int klen = k_len[b];

  float acc_k[kKRowsPerWarp][DPL], acc_v[kKRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kKRowsPerWarp; ++r) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc_k[r][i] = 0.f;
      acc_v[r][i] = 0.f;
    }
  }

  // a key tile past k_len has no valid key: its gradients are exactly 0
  if (s0 < min(T, klen)) {
    stage_rows<D>(sk, k + head, s0, kBK, T, tid);
    stage_rows<D>(sv, v + head, s0, kBK, T, tid);
    // under causal only rows l >= s see key s
    const int lbeg = causal ? (s0 / kBQ) * kBQ : 0;
    for (int l0 = lbeg; l0 < T; l0 += kBQ) {
      __syncthreads();  // the previous tile's readers are done
      stage_rows<D>(sqc, q_c + head, l0, kBQ, T, tid);
      stage_rows<D>(sqp, q_p + head, l0, kBQ, T, tid);
      stage_rows<D>(sdo, dout + head, l0, kBQ, T, tid);
      stage_row_stats(slse, sdelta, lse + static_cast<size_t>(bh) * T,
                      delta + static_cast<size_t>(bh) * T, l0, T, tid);
      stage_rows<D>(sband, pose_h, s0 - l0 - kBQ + T, kBand, 2 * T - 1, tid);
      __syncthreads();

      for (int e = tid; e < kBQ * kBK; e += kThreads) {
        const int li = e / kBK;
        const int sj = e - li * kBK;
        const float* band = sband[sj - li + kBQ - 1];
        float a = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          a = fmaf(sqc[li][d], sk[sj][d], a);
          a = fmaf(sqp[li][d], band[d], a);
          dp = fmaf(sdo[li][d], sv[sj][d], dp);
        }
        const int l = l0 + li;
        const int s = s0 + sj;
        const bool ok = l < T && s < T && s < klen && (!causal || s <= l);
        const float p = ok ? expf(a * scale - slse[li]) : 0.f;
        sp[li][sj] = p;
        sds[li][sj] = p * (dp - sdelta[li]) * scale;
      }
      __syncthreads();

#pragma unroll
      for (int r = 0; r < kKRowsPerWarp; ++r) {
        const int sj = warp * kKRowsPerWarp + r;
        for (int li = 0; li < kBQ; ++li) {
          const float p = sp[li][sj];
          const float ds = sds[li][sj];
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < D) {
              acc_v[r][i] = fmaf(p, sdo[li][d], acc_v[r][i]);
              acc_k[r][i] = fmaf(ds, sqc[li][d], acc_k[r][i]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kKRowsPerWarp; ++r) {
    const int s = s0 + warp * kKRowsPerWarp + r;
    if (s >= T) continue;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        dk[head + static_cast<size_t>(s) * D + d] = acc_k[r][i];
        dv[head + static_cast<size_t>(s) * D + d] = acc_v[r][i];
      }
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

// dq and dpose may take more than 48 KB of dynamic shared memory, and the
// SM's split between shared memory and L1 goes to shared memory. A
// function's attributes belong to a device: set once for each kernel and
// device, at its first launch or query there (setting them twice does no
// harm)
constexpr int kMaxDevices = 64;

template <int D, bool kPose>
struct Tiles {
  static constexpr int kBytes =
      (kPose ? dpose_smem_floats<D>() : dq_smem_floats<D>()) *
      static_cast<int>(sizeof(float));
  static constexpr int kThreadsOf = kPose ? kPoseThreads : kThreads;
  static const void* kernel() {
    return kPose ? reinterpret_cast<const void*>(rel_attn_dpose_kernel<D>)
                 : reinterpret_cast<const void*>(rel_attn_dq_kernel<D>);
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
  using Dq = Tiles<D, false>;
  const cudaError_t rc = Dq::attributes();
  if (rc != cudaSuccess) return rc;
  dim3 grid((a.T + kDqRows - 1) / kDqRows, a.B * a.H);
  rel_attn_dq_kernel<D><<<grid, kThreads, Dq::kBytes, s>>>(a, out, delta_out,
                                                           dq_c, dq_p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, float* dk, float* dv, cudaStream_t s) {
  dim3 grid((a.T + kBK - 1) / kBK, a.B * a.H);
  rel_attn_dkv_kernel<D><<<grid, kThreads, 0, s>>>(
      a.q_c, a.q_p, a.k, a.v, a.pose, a.k_len, a.dout, a.lse, a.delta, a.H,
      a.Hp, a.T, a.scale, a.causal, dk, dv);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dpose(const Args& a, float* partial, float* dpose,
                         cudaStream_t s) {
  using Pose = Tiles<D, true>;
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
// dynamic shared memory and resident blocks an SM of the dq (pose 0) or
// dpose (pose 1) kernel
template <int D, bool kPose>
cudaError_t tiles_occupancy(int* info) {
  using K = Tiles<D, kPose>;
  cudaError_t rc = K::attributes();
  if (rc != cudaSuccess) return rc;
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, K::kernel());
  if (rc != cudaSuccess) return rc;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = K::kBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      info + 3, K::kernel(), K::kThreadsOf, K::kBytes);
}

template <int D>
cudaError_t occupancy(int pose, int* info) {
  return pose ? tiles_occupancy<D, true>(info)
              : tiles_occupancy<D, false>(info);
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
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }

// Shapes as in the forward: q_c, q_p, k, v, dout, out and the outputs B x H
// x T x D; pose Hp x (2T-1) x D; k_len B int32; lse, delta B x H x T. All
// float32 (k_len int32), contiguous, on the device, 16-byte aligned. D in
// {16, 32, 64}. dq reads the forward's output `out` and WRITES delta =
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

// How the dq (pose 0) or dpose (pose 1) kernel sits on an SM at head dim D:
// info = {registers a thread, bytes of local memory a thread, bytes of
// dynamic shared memory a block, resident blocks an SM, key rows of a dq
// tile or table rows of a dpose block}.
extern "C" int aps_rel_attention_bwd_occupancy(int D, int pose, int* info) {
  info[4] = pose ? kPoseRows : kDqKeys;
  APS_DISPATCH_D(D, occupancy, pose, info);
}
