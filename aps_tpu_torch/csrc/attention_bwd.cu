// Backward of flash attention (scaled dot product), Hopper (sm_90a),
// float32: three kernels.
//
// Replaces the backward of aps_tpu/ops/pallas/attention.py::flash_attention
// (the TPU kernels _dq_kernel, _dkv_kernel and _dbias_kernel launched by
// _bwd). With the forward's
//
//   score[l,s] = q[l] . k[s] * scale (+ bias[h,l,s])
//   p[l,s]     = mask(l,s) ? exp(score[l,s] - lse[l]) : 0
//
// and dp[l,s] = do[l] . v[s], delta[l] = do[l] . o[l] and
// ds = p * (dp - delta) * scale, the gradients are
//
//   dq[l] = sum_s ds[l,s] k[s]
//   dk[s] = sum_l ds[l,s] q[l]          dv[s] = sum_l p[l,s] do[l]
//   dbias[h,l,s] = sum over b of p[l,s] * (dp[l,s] - delta[l])
//
// dbias carries no trailing scale: the bias is added after the scaling.
// The mask is the forward's: keys s >= k_len[b] (suffix padding), s > l
// under causal (aligned top-left when Tq != Tk). Rows without a visible key
// carry lse = 1e30 from the forward, so p and every gradient from them are
// exactly 0.
//
// The TPU kernels carry their sums in scratch memory from one grid step to
// the next, because the TPU's grid runs in order on one core; the dbias
// kernel makes the batch its last, sequential grid axis. Blocks run in
// parallel and in no order here, so each kernel keeps the reduction it owns
// inside the block, without atomics, and gives the same bits at every run:
//
//   dq:    one block per (64 query rows, b*h), loop over key tiles;
//   dk/dv: one block per (64 key rows, b*h), loop over query tiles;
//   dbias: one block per (32 key columns, 16 query rows, h) that loops over
//          the batch in order and writes its tile once. By design it
//          recomputes the tile's scores and dp once per batch entry.
//
// Ragged Tq and Tk, k_len, causal and skipped tiles are handled by bounds;
// no padded copy of an operand is made.
//
// dq and dk/dv: what bounds them and what the design does about it. Per
// head the work is 6 (dq) or 8 (dk/dv) Tq Tk D operations on a few T D
// floats: arithmetic, not device memory. On the CUDA cores from shared
// memory (one thread per score, two shared loads per multiply-add, 16 x 32
// tiles restaged between barriers) they ran at a tenth of the float32 rate.
// Both are now one kernel template, attn_bwd_tiles_kernel, built from
// attn_tiles.cuh:
//
//   - a block of four warps owns 64 rows (q and do for dq, k and v for
//     dk/dv), staged once; each warp owns 16 of them and keeps its
//     gradient tiles (16 x D; two of them for dk/dv) in registers for the
//     whole loop;
//   - the other side streams through in tiles of kStreamRows rows, copied
//     with cp.async (16 bytes a thread) into a ring of two stages, so the
//     next tile's loads are in flight while this one is computed: one
//     barrier a tile;
//   - all products run on the tensor cores (mma.sync m16n8k8, TF32). A
//     single TF32 product keeps three digits, which the training step's
//     gradients do not survive, so every product is the three-term split
//     of attn_tiles.cuh (head and remainder of either operand, float32
//     accumulators): float32's accuracy at a third of the TF32 rate, still
//     2.5 times the CUDA cores' peak. The register-tiled float32 FMA design
//     was the fallback had the split not held the tolerances; it does;
//   - the scores never leave the registers: the accumulator tile of s and
//     dp becomes p and ds in place and is fed back as the A operand of the
//     gradient products (dk/dv computes the transposed tile k . q^T, so its
//     gradients are again A . B with B streamed);
//   - rows are padded to D + 4 floats: both fragment patterns are free of
//     bank conflicts;
//   - dq forms delta = sum(do * out) for its 64 rows in its prologue and
//     writes it for dk/dv and dbias, which run after it on the same stream.
//
// They still recompute s and dp in both kernels (14 Tq Tk D in all where a
// fused pass needs 10); dbias is as it was (no model passes a bias).

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <type_traits>

#include "attn_tiles.cuh"

namespace {

// dbias: 16 x 32 tiles, one thread per entry
constexpr int kBQ = 16;   // query rows of a tile
constexpr int kBK = 32;   // key rows of a tile
constexpr int kThreads = 128;
constexpr int kPerThread = kBQ * kBK / kThreads;  // tile entries of a thread
constexpr float kLseDead = attn_tiles::kLseDead;

// dq and dk/dv: a block of four warps owns kOwnRows rows, each warp 16; the
// other side streams through in tiles of kStreamRows rows. With 32 streamed
// rows a block needs 70 KB of shared memory at D = 64 and the kernels are
// held to 168 registers, so three blocks share an SM (shared memory and
// registers both end there) and the 352 blocks of the training shape (32
// heads x 11 tiles of 64 of T = 690) are resident at once on 132 SMs. With
// dk/dv left to 181 registers (two blocks an SM) it measured 3% slower
// there; with 64 streamed rows (two blocks an SM, 105 KB and about 200
// registers) dq measured 15% slower at the training shape and the pair 2%
// faster at B = 16, T = 1024. Both kernels are bound by the schedulers'
// rate (about one instruction a cycle and scheduler, a fifth of them mma), so
// what pays is fewer instructions, not more blocks.
constexpr int kOwnRows = 64;
constexpr int kStreamRows = 32;
constexpr int kBlocksPerSM = 3;
constexpr int kWarpRows = kOwnRows / (kThreads / 32);
static_assert(kWarpRows == 16, "a warp owns one 16-row fragment");
static_assert(kStreamRows % 8 == 0 && 2 * kStreamRows <= kThreads,
              "streamed tiles are whole 8-row fragments; one thread stages "
              "one row statistic");

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
                                                int l0, int Tq, int tid) {
  if (tid < kBQ) {
    const bool ok = l0 + tid < Tq;
    slse[tid] = ok ? lse[l0 + tid] : kLseDead;
    sdelta[tid] = ok ? delta[l0 + tid] : 0.f;
  }
}

struct Args {
  const float *q, *k, *v, *bias;
  const int* k_len;
  const float *dout, *lse, *delta;
  int B, H, Tq, Tk;
  float scale;
  int causal;
};

// p[l,s] and dp[l,s] - delta[l] of tile entry (li, sj): the score is
// recomputed from the staged rows, the bias (if any) read from device memory
template <int D>
__device__ __forceinline__ void tile_entry(
    float (*sq)[D + 1], float (*sdo)[D + 1], float (*sk)[D + 1],
    float (*sv)[D + 1], const float* slse,
    const float* sdelta, const float* __restrict__ bias_h, int li, int sj,
    int l, int s, int Tq, int Tk, int klen, float scale, int causal, float* p,
    float* dpd) {
  float a = 0.f, dp = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) {
    a = fmaf(sq[li][d], sk[sj][d], a);
    dp = fmaf(sdo[li][d], sv[sj][d], dp);
  }
  const bool ok = l < Tq && s < klen && (!causal || s <= l);
  a *= scale;
  if (ok && bias_h != nullptr) a += bias_h[static_cast<size_t>(l) * Tk + s];
  *p = ok ? expf(a - slse[li]) : 0.f;
  *dpd = dp - sdelta[li];
}

// floats of dynamic shared memory: the owned operands, the ring of two
// stages of two streamed operands, and the row statistics (dk/dv: lse and
// delta of either stage; dq: delta of the owned rows)
template <int D, bool kDKV>
constexpr int tiles_smem_floats() {
  return (2 * kOwnRows + 4 * kStreamRows) * attn_tiles::tile_ld(D) +
         (kDKV ? 4 * kStreamRows : kOwnRows);
}

// dq (kDKV false): the block owns query rows own0.. of q and do and streams
// k and v; its tile is s[l,s] with l owned. g1 = dq; it also forms delta from
// do and out and writes it to delta_out.
// dk/dv (kDKV true): the block owns key rows own0.. of k and v and streams q,
// do, lse and delta; its tile is the transposed s[s,l] with s owned. g1 = dk,
// g2 = dv.
template <int D, bool kDKV>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
attn_bwd_tiles_kernel(Args a, const float* __restrict__ out,
                      float* __restrict__ delta_out, float* __restrict__ g1,
                      float* __restrict__ g2) {
  using namespace attn_tiles;
  constexpr int BS = kStreamRows;
  constexpr int LD = tile_ld(D);
  constexpr int NT = BS / 8;  // 8-wide fragments across the streamed rows
  constexpr int ND = D / 8;   // 8-wide fragments across the head dim
  extern __shared__ __align__(16) float smem[];
  float* sx1 = smem;                 // owned: q (dq) or k (dk/dv)
  float* sx2 = sx1 + kOwnRows * LD;  // owned: do or v
  float* sy = sx2 + kOwnRows * LD;   // [stage][k, v or q, do][BS][LD]
  float* sstat = sy + 4 * BS * LD;

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int own0 = blockIdx.x * kOwnRows;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = (tid / 32) * kWarpRows;
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
  // tile past k_len sees no query (its gradients are exactly 0), and under
  // causal only rows l >= s see key s. dq: keys below k_len, and under
  // causal none after the tile's last row.
  int beg = 0, end;
  if (kDKV) {
    end = own0 < klen ? a.Tq : 0;
    if (a.causal) beg = (own0 / BS) * BS;
  } else {
    end = klen;
    if (a.causal) end = min(end, own0 + kOwnRows);
  }
  const int nt = end > beg ? (end - beg + BS - 1) / BS : 0;

  auto stage_stream = [&](int tile, int stage) {
    const int r0 = beg + tile * BS;
    float* dst = sy + stage * 2 * BS * LD;
    stage_rows_async<D, BS, kThreads>(dst, y1, r0, t_str, tid);
    stage_rows_async<D, BS, kThreads>(dst + BS * LD, y2, r0, t_str, tid);
    if (kDKV && tid < 2 * BS) {
      const int which = tid / BS;  // 0 lse, 1 delta
      const int l = r0 + tid - which * BS;
      const bool ok = l < a.Tq;
      cp_async_4(sstat + stage * 2 * BS + tid,
                 (which ? a.delta : a.lse) + shead + (ok ? l : 0), ok);
    }
  };

  stage_rows_async<D, kOwnRows, kThreads>(sx1, x1, own0, t_own, tid);
  stage_rows_async<D, kOwnRows, kThreads>(sx2, x2, own0, t_own, tid);
  if (nt > 0) stage_stream(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // dq: lse and delta of this thread's two rows (g and g + 8 of its warp)
  float row_lse[2] = {kLseDead, kLseDead};
  float row_delta[2] = {0.f, 0.f};
  if (!kDKV) {
    for (int r = 0; r < kWarpRows; ++r) {
      const int row = wrow + r;
      const int l = own0 + row;
      float part = 0.f;
      if (l < a.Tq) {
        for (int d = lane; d < D; d += 32) {
          part = fmaf(sx2[row * LD + d],
                      out[qhead + static_cast<size_t>(l) * D + d], part);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      if (lane == 0) {
        sstat[row] = part;
        if (l < a.Tq) delta_out[shead + l] = part;
      }
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wrow + g + 8 * h;
      if (own0 + row < a.Tq) row_lse[h] = a.lse[shead + own0 + row];
      row_delta[h] = sstat[row];
    }
  }

  float acc1[ND][4];  // dq, or dk
  float acc2[ND][4];  // dv (dk/dv only)
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc1[n][c] = 0.f;
      if constexpr (kDKV) acc2[n][c] = 0.f;
    }
  }

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
    const int stage = tile & 1;
    const float* ty1 = sy + stage * 2 * BS * LD;
    const float* ty2 = ty1 + BS * LD;
    const float* tstat = sstat + stage * 2 * BS;
    const int str0 = beg + tile * BS;

    // s = x1 . y1^T and dp = x2 . y2^T, 16 x BS a warp
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
      FragA a1, a2;
      FragB b1[NT], b2[NT];
      load_a<LD>(a1, sx1, wrow, k0, g, t);
      load_a<LD>(a2, sx2, wrow, k0, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        load_b_rows_n<LD>(b1[j], ty1, 8 * j, k0, g, t);
        load_b_rows_n<LD>(b2[j], ty2, 8 * j, k0, g, t);
      }
      mma_f32<NT>(s, a1, b1);
      mma_f32<NT>(dp, a2, b2);
    }

    // in place: s -> p, dp -> ds = p * (dp - delta) * scale. A warp whose
    // 16 x BS tile lies wholly inside the mask (and has no bias) skips the
    // tests. __expf: its argument carries the score's own rounding error
    // (1e-5 at |score| 30), far above the approximation's.
    const int own_lo = own0 + wrow;
    const int l_hi = kDKV ? str0 + BS - 1 : own_lo + kWarpRows - 1;
    const int l_lo = kDKV ? str0 : own_lo;
    const int s_hi = kDKV ? own_lo + kWarpRows - 1 : str0 + BS - 1;
    const bool inside = bias_h == nullptr && l_hi < a.Tq && s_hi < klen &&
                        (!a.causal || s_hi <= l_lo);
    auto soften = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int h = c / 2;
          const int col = 8 * j + 2 * t + (c & 1);
          const float lse = kDKV ? tstat[col] : row_lse[h];
          const float delta = kDKV ? tstat[BS + col] : row_delta[h];
          float x = s[j][c] * a.scale;
          bool ok = true;
          if (kMasked) {
            const int own = own_lo + g + 8 * h;
            const int str = str0 + col;
            const int l = kDKV ? str : own;
            const int sk = kDKV ? own : str;
            ok = visible(l, sk, a.Tq, klen, a.causal);
            if (ok && bias_h != nullptr) {
              x += bias_h[static_cast<size_t>(l) * a.Tk + sk];
            }
          }
          const float p = ok ? __expf(x - lse) : 0.f;
          s[j][c] = p;
          dp[j][c] = p * (dp[j][c] - delta) * a.scale;
        }
      }
    };
    if (inside) {
      soften(std::false_type{});
    } else {
      soften(std::true_type{});
    }

    // dq += ds . k; or dk += ds^T . q and dv += p^T . do: the tile is the A
    // operand, the streamed rows are summed over
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragA ads, ap;
      FragB bf[ND];
      acc_as_a(ads, dp[j]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        load_b_rows_k<LD>(bf[n], ty1, 8 * j, 8 * n, g, t);
      }
      mma_f32<ND>(acc1, ads, bf);
      if constexpr (kDKV) {
        acc_as_a(ap, s[j]);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          load_b_rows_k<LD>(bf[n], ty2, 8 * j, 8 * n, g, t);
        }
        mma_f32<ND>(acc2, ap, bf);
      }
    }
  }

  const size_t ohead = kDKV ? khead : qhead;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = own0 + wrow + g + 8 * h;
    if (row >= t_own) continue;
    const size_t at = ohead + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(g1 + at + 8 * n) =
          make_float2(acc1[n][2 * h], acc1[n][2 * h + 1]);
      if constexpr (kDKV) {
        *reinterpret_cast<float2*>(g2 + at + 8 * n) =
            make_float2(acc2[n][2 * h], acc2[n][2 * h + 1]);
      }
    }
  }
}

// dbias: H x Tq x Tk; this block owns tile (rows l0.., columns s0..) of
// head h and sums it over the batch in order
template <int D>
__global__ void attn_dbias_kernel(Args a, float* __restrict__ dbias) {
  constexpr int DP = D + 1;
  __shared__ float sq[kBQ][DP];
  __shared__ float sdo[kBQ][DP];
  __shared__ float sk[kBK][DP];
  __shared__ float sv[kBK][DP];
  __shared__ float slse[kBQ];
  __shared__ float sdelta[kBQ];

  const int h = blockIdx.z;
  const int l0 = blockIdx.y * kBQ;
  const int s0 = blockIdx.x * kBK;
  const int tid = threadIdx.x;
  const float* bias_h = a.bias + static_cast<size_t>(h) * a.Tq * a.Tk;

  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;

  // under causal a tile wholly above the diagonal sees nothing
  const bool live = !a.causal || s0 <= l0 + kBQ - 1;
  for (int b = 0; live && b < a.B; ++b) {
    const int klen = min(a.Tk, a.k_len[b]);
    if (s0 >= klen) continue;  // the same for every thread of the block
    const int bh = b * a.H + h;
    const size_t qhead = static_cast<size_t>(bh) * a.Tq * D;
    const size_t khead = static_cast<size_t>(bh) * a.Tk * D;
    __syncthreads();  // the previous batch entry's readers are done
    stage_rows<D>(sq, a.q + qhead, l0, kBQ, a.Tq, tid);
    stage_rows<D>(sdo, a.dout + qhead, l0, kBQ, a.Tq, tid);
    stage_row_stats(slse, sdelta, a.lse + static_cast<size_t>(bh) * a.Tq,
                    a.delta + static_cast<size_t>(bh) * a.Tq, l0, a.Tq, tid);
    stage_rows<D>(sk, a.k + khead, s0, kBK, a.Tk, tid);
    stage_rows<D>(sv, a.v + khead, s0, kBK, a.Tk, tid);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kThreads;
      const int li = e / kBK;
      const int sj = e - li * kBK;
      float p, dpd;
      tile_entry<D>(sq, sdo, sk, sv, slse, sdelta, bias_h, li, sj, l0 + li,
                    s0 + sj, a.Tq, a.Tk, klen, a.scale, a.causal, &p, &dpd);
      acc[i] += p * dpd;
    }
  }

  float* out = dbias + static_cast<size_t>(h) * a.Tq * a.Tk;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = tid + i * kThreads;
    const int li = e / kBK;
    const int l = l0 + li;
    const int s = s0 + e - li * kBK;
    if (l < a.Tq && s < a.Tk) out[static_cast<size_t>(l) * a.Tk + s] = acc[i];
  }
}

// the kernel may take more than 48 KB of dynamic shared memory, and the SM's
// split between shared memory and L1 goes to shared memory. A function's
// attributes belong to a device: set once for each instantiation and device,
// at its first launch or query there (setting them twice does no harm)
constexpr int kMaxDevices = 64;

template <int D, bool kDKV>
cudaError_t tiles_attributes() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  auto kernel = attn_bwd_tiles_kernel<D, kDKV>;
  rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tiles_smem_floats<D, kDKV>() * static_cast<int>(sizeof(float)));
  if (rc != cudaSuccess) return rc;
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributePreferredSharedMemoryCarveout,
                            cudaSharedmemCarveoutMaxShared);
  if (rc == cudaSuccess && known) {
    done[dev].store(true, std::memory_order_release);
  }
  return rc;
}

template <int D, bool kDKV>
cudaError_t launch_tiles(const Args& a, const float* out, float* delta_out,
                         float* g1, float* g2, cudaStream_t s) {
  constexpr int kBytes = tiles_smem_floats<D, kDKV>() * sizeof(float);
  const cudaError_t rc = tiles_attributes<D, kDKV>();
  if (rc != cudaSuccess) return rc;
  dim3 grid(((kDKV ? a.Tk : a.Tq) + kOwnRows - 1) / kOwnRows, a.B * a.H);
  attn_bwd_tiles_kernel<D, kDKV>
      <<<grid, kThreads, kBytes, s>>>(a, out, delta_out, g1, g2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, const float* out, float* delta_out,
                      float* dq, cudaStream_t s) {
  return launch_tiles<D, false>(a, out, delta_out, dq, nullptr, s);
}

template <int D>
cudaError_t launch_dkv(const Args& a, float* dk, float* dv, cudaStream_t s) {
  return launch_tiles<D, true>(a, nullptr, nullptr, dk, dv, s);
}

// registers a thread, bytes of local memory a thread (spills), bytes of
// dynamic shared memory and resident blocks an SM of the dq (kDKV false) or
// dk/dv kernel
template <int D, bool kDKV>
cudaError_t tiles_occupancy(int* info) {
  auto kernel = attn_bwd_tiles_kernel<D, kDKV>;
  constexpr int kBytes = tiles_smem_floats<D, kDKV>() * sizeof(float);
  cudaError_t rc = tiles_attributes<D, kDKV>();
  if (rc != cudaSuccess) return rc;
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return rc;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = kBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(info + 3, kernel,
                                                       kThreads, kBytes);
}

template <int D>
cudaError_t occupancy(int dkv, int* info) {
  return dkv ? tiles_occupancy<D, true>(info) : tiles_occupancy<D, false>(info);
}

template <int D>
cudaError_t launch_dbias(const Args& a, float* dbias, cudaStream_t s) {
  dim3 grid((a.Tk + kBK - 1) / kBK, (a.Tq + kBQ - 1) / kBQ, a.H);
  attn_dbias_kernel<D><<<grid, kThreads, 0, s>>>(a, dbias);
  return cudaGetLastError();
}

bool bad_dims(int B, int H, int Tq, int Tk) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0;
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

// Shapes as in the forward: q, dout, out, dq B x H x Tq x D; k, v, dk, dv B
// x H x Tk x D; bias H x Tq x Tk or null; k_len B int32; lse, delta B x H x
// Tq. All float32 (k_len int32), contiguous, on the device. D in {16, 32,
// 64}. The three entries take the same list of pointers. dq reads the
// forward's output `out` and WRITES delta = sum(dout * out, -1); dk/dv and
// dbias read that delta, so dq is launched first.
extern "C" int aps_attention_dq(
    const float* q, const float* k, const float* v, const float* bias,
    const int* k_len, const float* dout, const float* lse, float* delta,
    int B, int H, int Tq, int Tk, int D, float scale, int causal, float* dq,
    const float* out, void* stream) {
  if (bad_dims(B, H, Tq, Tk) || out == nullptr || delta == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, bias, k_len, dout, lse, nullptr,
               B, H, Tq, Tk, scale, causal};
  APS_DISPATCH_D(D, launch_dq, a, out, delta, dq,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int aps_attention_dkv(
    const float* q, const float* k, const float* v, const float* bias,
    const int* k_len, const float* dout, const float* lse, const float* delta,
    int B, int H, int Tq, int Tk, int D, float scale, int causal, float* dk,
    float* dv, void* stream) {
  if (bad_dims(B, H, Tq, Tk)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, bias, k_len, dout, lse, delta,
               B, H, Tq, Tk, scale, causal};
  APS_DISPATCH_D(D, launch_dkv, a, dk, dv, static_cast<cudaStream_t>(stream));
}

extern "C" int aps_attention_dbias(
    const float* q, const float* k, const float* v, const float* bias,
    const int* k_len, const float* dout, const float* lse, const float* delta,
    int B, int H, int Tq, int Tk, int D, float scale, int causal,
    float* dbias, float* unused, void* stream) {
  if (bad_dims(B, H, Tq, Tk) || bias == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, bias, k_len, dout, lse, delta,
               B, H, Tq, Tk, scale, causal};
  APS_DISPATCH_D(D, launch_dbias, a, dbias,
                 static_cast<cudaStream_t>(stream));
}

// How the dq (dkv 0) or dk/dv (dkv 1) kernel sits on an SM at head dim D:
// info = {registers a thread, bytes of local memory a thread, bytes of
// dynamic shared memory a block, resident blocks an SM, streamed rows a
// tile}.
extern "C" int aps_attention_bwd_occupancy(int D, int dkv, int* info) {
  info[4] = kStreamRows;
  APS_DISPATCH_D(D, occupancy, dkv, info);
}
