// Backward of flash attention (scaled dot product), Hopper (sm_90a),
// float32: dq and dk/dv at heads up to 128.
//
// Replaces the backward of aps_tpu/ops/pallas/attention.py::flash_attention
// (the TPU kernels _dq_kernel and _dkv_kernel launched by _bwd; its
// _dbias_kernel is attention_dbias.cu's, at every width). With the
// forward's
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
// the next, because the TPU's grid runs in order on one core. Blocks run in
// parallel and in no order here, so each kernel keeps the reduction it owns
// inside the block, without atomics, and gives the same bits at every run:
//
//   dq:    one block per (64 query rows, b*h), loop over key tiles;
//   dk/dv: one block per (64 key rows, b*h), loop over query tiles.
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
// fused pass needs 10).
//
// A head of another width up to 128 runs the tiles of the next built width
// (65 to 96: those of 96) without a padded copy, as the forward does
// (attention.cu): rows staged at
// their own stride and zero-filled to the tile's width, s and dp over the
// fragments that hold the true columns (the gradient products over all of
// the tile's, as the forward's p . v), those columns written. The variant
// is chosen at compile time (kRagged); the built widths compile to the code
// they had.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <type_traits>

#include "attn_tiles.cuh"

namespace {

constexpr int kThreads = 128;
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
//
// At D = 128 the same tiles take 135 KB of shared memory, one block an SM,
// so the kernels are held to no register count below the 255 a thread may
// have (what spills is read through compare_kernels and kept in PERF.md).
constexpr int kOwnRows = 64;
constexpr int kStreamRows = 32;
constexpr int kBlocksPerSM = 3;

// blocks an SM that the register count is held to at head dim D
template <int D>
constexpr int blocks_per_sm() {
  return D <= 64 ? kBlocksPerSM : 1;
}
constexpr int kWarpRows = kOwnRows / (kThreads / 32);
static_assert(kWarpRows == 16, "a warp owns one 16-row fragment");
static_assert(kStreamRows % 8 == 0 && 2 * kStreamRows <= kThreads,
              "streamed tiles are whole 8-row fragments; one thread stages "
              "one row statistic");

struct Args {
  const float *q, *k, *v, *bias;
  const int* k_len;
  const float *dout, *lse, *delta;
  int B, H, Tq, Tk;
  float scale;
  int causal;
};

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
// kRagged: a head of dim < D columns (rows dim floats apart in device
// memory; vec: 16-byte copies); else dim == D and both are unused.
template <int D, bool kDKV, bool kRagged>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<D>())
attn_bwd_tiles_kernel(Args a, const float* __restrict__ out,
                      float* __restrict__ delta_out, float* __restrict__ g1,
                      float* __restrict__ g2, int dim, bool vec) {
  using namespace attn_tiles;
  constexpr int BS = kStreamRows;
  const int W = kRagged ? dim : D;  // row stride in device memory
  // 8-column fragments that hold the head's columns (the rest are zeros)
  const int nd = kRagged ? (dim + 7) / 8 : D / 8;
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
  const size_t qhead = static_cast<size_t>(bh) * a.Tq * W;
  const size_t khead = static_cast<size_t>(bh) * a.Tk * W;
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
    stage_rows_of<kRagged, D, BS, kThreads>(dst, y1, r0, t_str, dim, vec,
                                            tid);
    stage_rows_of<kRagged, D, BS, kThreads>(dst + BS * LD, y2, r0, t_str,
                                            dim, vec, tid);
    if (kDKV && tid < 2 * BS) {
      const int which = tid / BS;  // 0 lse, 1 delta
      const int l = r0 + tid - which * BS;
      const bool ok = l < a.Tq;
      cp_async_4(sstat + stage * 2 * BS + tid,
                 (which ? a.delta : a.lse) + shead + (ok ? l : 0), ok);
    }
  };

  stage_rows_of<kRagged, D, kOwnRows, kThreads>(sx1, x1, own0, t_own, dim,
                                                vec, tid);
  stage_rows_of<kRagged, D, kOwnRows, kThreads>(sx2, x2, own0, t_own, dim,
                                                vec, tid);
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
        for (int d = lane; d < W; d += 32) {
          part = fmaf(sx2[row * LD + d],
                      out[qhead + static_cast<size_t>(l) * W + d], part);
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
    for (int k0 = 0; k0 < 8 * nd; k0 += 8) {
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
    const size_t at = ohead + static_cast<size_t>(row) * W + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if constexpr (kRagged) {
        // the true columns only, a float at a time
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * n + 2 * t + e >= dim) continue;
          g1[at + 8 * n + e] = acc1[n][2 * h + e];
          if constexpr (kDKV) g2[at + 8 * n + e] = acc2[n][2 * h + e];
        }
      } else {
        *reinterpret_cast<float2*>(g1 + at + 8 * n) =
            make_float2(acc1[n][2 * h], acc1[n][2 * h + 1]);
        if constexpr (kDKV) {
          *reinterpret_cast<float2*>(g2 + at + 8 * n) =
              make_float2(acc2[n][2 * h], acc2[n][2 * h + 1]);
        }
      }
    }
  }
}

// the kernel may take more than 48 KB of dynamic shared memory, and the SM's
// split between shared memory and L1 goes to shared memory. A function's
// attributes belong to a device: set once for each instantiation and device,
// at its first launch or query there (setting them twice does no harm)
constexpr int kMaxDevices = 64;

template <int D, bool kDKV, bool kRagged>
cudaError_t tiles_attributes() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  auto kernel = attn_bwd_tiles_kernel<D, kDKV, kRagged>;
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

template <int D, bool kDKV, bool kRagged>
cudaError_t launch_tiles(const Args& a, const float* out, float* delta_out,
                         float* g1, float* g2, cudaStream_t s, int dim,
                         bool vec) {
  constexpr int kBytes = tiles_smem_floats<D, kDKV>() * sizeof(float);
  const cudaError_t rc = tiles_attributes<D, kDKV, kRagged>();
  if (rc != cudaSuccess) return rc;
  dim3 grid(((kDKV ? a.Tk : a.Tq) + kOwnRows - 1) / kOwnRows, a.B * a.H);
  attn_bwd_tiles_kernel<D, kDKV, kRagged>
      <<<grid, kThreads, kBytes, s>>>(a, out, delta_out, g1, g2, dim, vec);
  return cudaGetLastError();
}

// kRagged: a head of dim < D columns in the tiles built for D
template <int D, bool kRagged = false>
cudaError_t launch_dq(const Args& a, const float* out, float* delta_out,
                      float* dq, cudaStream_t s, int dim, bool vec) {
  return launch_tiles<D, false, kRagged>(a, out, delta_out, dq, nullptr, s,
                                         dim, vec);
}

template <int D, bool kRagged = false>
cudaError_t launch_dkv(const Args& a, float* dk, float* dv, cudaStream_t s,
                       int dim, bool vec) {
  return launch_tiles<D, true, kRagged>(a, nullptr, nullptr, dk, dv, s, dim,
                                        vec);
}

// registers a thread, bytes of local memory a thread (spills), bytes of
// dynamic shared memory and resident blocks an SM of the dq (kDKV false) or
// dk/dv kernel
template <int D, bool kDKV, bool kRagged>
cudaError_t tiles_occupancy(int* info) {
  auto kernel = attn_bwd_tiles_kernel<D, kDKV, kRagged>;
  constexpr int kBytes = tiles_smem_floats<D, kDKV>() * sizeof(float);
  cudaError_t rc = tiles_attributes<D, kDKV, kRagged>();
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

template <int D, bool kRagged = false>
cudaError_t occupancy(int dkv, int* info) {
  return dkv ? tiles_occupancy<D, true, kRagged>(info)
             : tiles_occupancy<D, false, kRagged>(info);
}

bool bad_dims(int B, int H, int Tq, int Tk) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 16-byte copies of the rows of a ragged head: D % 4 == 0 and every staged
// operand on the 16-byte grid
bool vec_rows(int D, const Args& a) {
  return D % 4 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
         aligned16(a.dout);
}

}  // namespace

extern "C" const char* aps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the built widths as they are; any other D up to 128 in the ragged tiles
// of attn_tiles::tile_width(D) (kRagged)
#define APS_DISPATCH_D(D, fn, ...)                                \
  switch (D) {                                                    \
    case 16: return static_cast<int>(fn<16>(__VA_ARGS__));        \
    case 32: return static_cast<int>(fn<32>(__VA_ARGS__));        \
    case 64: return static_cast<int>(fn<64>(__VA_ARGS__));        \
    case 128: return static_cast<int>(fn<128>(__VA_ARGS__));      \
    default: break;                                               \
  }                                                               \
  switch (D < 1 || D > 128 ? 0 : attn_tiles::tile_width(D)) {    \
    case 16: return static_cast<int>(fn<16, true>(__VA_ARGS__));  \
    case 32: return static_cast<int>(fn<32, true>(__VA_ARGS__));  \
    case 64: return static_cast<int>(fn<64, true>(__VA_ARGS__));  \
    case 96: return static_cast<int>(fn<96, true>(__VA_ARGS__));  \
    case 128: return static_cast<int>(fn<128, true>(__VA_ARGS__)); \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }

// Shapes as in the forward: q, dout, out, dq B x H x Tq x D; k, v, dk, dv B
// x H x Tk x D; bias H x Tq x Tk or null; k_len B int32; lse, delta B x H x
// Tq. All float32 (k_len int32), contiguous, on the device. 1 <= D <= 128
// (another width than 16, 32, 64 and 128 in the tiles of the next one, its
// rows copied 4 bytes at a time where they leave the 16-byte grid). The
// two entries take the same list of pointers. dq reads the forward's
// output `out` and WRITES delta = sum(dout * out, -1); dk/dv and dbias
// (attention_dbias.cu) read that delta, so dq is launched first.
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
                 static_cast<cudaStream_t>(stream), D, vec_rows(D, a));
}

extern "C" int aps_attention_dkv(
    const float* q, const float* k, const float* v, const float* bias,
    const int* k_len, const float* dout, const float* lse, const float* delta,
    int B, int H, int Tq, int Tk, int D, float scale, int causal, float* dk,
    float* dv, void* stream) {
  if (bad_dims(B, H, Tq, Tk)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, bias, k_len, dout, lse, delta,
               B, H, Tq, Tk, scale, causal};
  APS_DISPATCH_D(D, launch_dkv, a, dk, dv, static_cast<cudaStream_t>(stream),
                 D, vec_rows(D, a));
}

// How the dq (dkv 0) or dk/dv (dkv 1) kernel sits on an SM at head dim D
// (another width than 16, 32, 64 and 128: the ragged tiles it runs):
// info = {registers a thread, bytes of local memory a thread, bytes of
// dynamic shared memory a block, resident blocks an SM, streamed rows a
// tile}.
extern "C" int aps_attention_bwd_occupancy(int D, int dkv, int* info) {
  info[4] = kStreamRows;
  APS_DISPATCH_D(D, occupancy, dkv, info);
}
