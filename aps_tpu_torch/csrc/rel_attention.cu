// Flash attention forward with relative-position scores, Hopper (sm_90a),
// float32, on the tensor cores.
//
// Replaces the forward of aps_tpu/ops/pallas/rel_attention.py::
// flash_attention_rel (the TPU kernel _fwd_kernel launched by _fwd).
// Semantics:
//
//   score[b,h,l,s] = (q_c[b,h,l] . k[b,h,s] + q_p[b,h,l] . pose[hp, s-l+T-1])
//                    * scale,
//
// hp = 0 when the table is shared (Hp == 1) else h, keys s >= k_len[b]
// masked (suffix padding), optional causal mask (s <= l), and rows with no
// visible key give 0. When `lse` is not null the kernel also writes the
// row-wise log-sum-exp of the masked scores (max + log(sum)), B x H x T,
// which the backward kernels (rel_attention_bwd.cu) read; rows with no
// visible key get kLseDead, a large positive value, so that exp(score -
// lse) is 0 there.
//
// What bounds it on the card: three products of T * T * D multiply-adds a
// head (q_c . k^T, q_p . pose band^T, p . v) on a few T D floats:
// arithmetic, not device memory. The first port ran them on the CUDA cores
// from shared memory (16 x 32 tiles, one thread per score, two shared loads
// per multiply-add, p broadcast by shuffles, every key tile restaged
// between three barriers) at 5-8% of the float32 rate. This design is K2's
// forward (attention.cu) with the relative term of K3's dq
// (rel_attention_bwd.cu), all from attn_tiles.cuh:
//
//   - a block of kWarps warps owns kQRows query rows, 16 a warp. q_c and q_p
//     are staged once; each warp splits its q_c fragments into TF32 head
//     and remainder once and keeps them in registers, and splits q_p's from
//     shared memory at every tile (both held would take 128 registers at D
//     = 64);
//   - K, V and the kQRows + kKeys pose rows a key tile meets (the band,
//     zeros before row 0 and past row 2T - 2) stream through a ring of two
//     cp.async stages, one barrier a tile;
//   - s = q_c . k^T, g = q_p . band^T and o += p . v run as three-pass TF32
//     mma.sync products: float32's accuracy at a third of the TF32 rate;
//   - the relative term: entry (l, s) reads pose row s - l + T - 1, which
//     depends on the A operand's row, so a warp multiplies q_p by the 16 +
//     kKeys band rows its 16 rows meet (1.5 times the entries it needs with
//     32-key tiles), writes g to a per-warp tile in shared memory and reads
//     it back skewed, score(li, sj) += g[li][sj - li + 15]; the tile's
//     stride is skew_ld's, as in dq;
//   - the online softmax stays in registers (attn_tiles::RowSoftmax), and
//     the tile of p becomes the A operand of p . v where it lies (acc_as_a,
//     load_b_rows_k);
//   - key tiles past k_len, and past the block's last row under causal,
//     are not staged; a warp with nothing visible in a tile skips it, and a
//     warp whose tile lies wholly inside the mask skips the tests;
//   - no atomics: two launches give the same bits.
//
// Sizes at D = 64: q_c and q_p (34 KB), two stages of 32 keys of K and V
// and 96 band rows (87 KB), a skew tile a warp (14 KB): 133 KB, one block
// an SM. At D = 128 (Tiles<128>): q_c and q_p (66 KB), two stages of 16
// keys of K and V and 80 band rows (116 KB), a skew tile a warp (14 KB):
// 196 KB.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "attn_tiles.cuh"

namespace {

// A block of kWarps warps owns kQRows query rows and streams the keys in
// tiles of Tiles<D>::kKeys with the kBand pose rows a tile meets (one
// spare). A warp's relative term covers kWarpBand band rows (one spare) in a
// skew tile of kSkewLd floats a row. 32-row blocks (two warps, 92 KB, two
// blocks an SM) measured 8-15% slower at the decode shape (B = 8, T = 233:
// 256 blocks against 128) and 8-12% at the training step's (PERF.md).
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQRows = 16 * kWarps;
constexpr float kLseDead = attn_tiles::kLseDead;

// The tiles at head dim D. Up to D = 64: 32-key tiles, q_c's fragments
// split once and held in registers. At D = 128 32-key tiles would take
// 250,880 bytes of shared memory, more than a block may have (232,448), so
// the key tiles are 16 rows (200,192 bytes), and q_c's fragments, 128
// registers a thread there, are split from shared memory at every tile as
// q_p's are.
template <int D>
struct Tiles {
  static constexpr int kKeys = D <= 64 ? 32 : 16;
  static constexpr bool kHoldQ = D <= 64;
  static constexpr int kBand = kQRows + kKeys;
  static constexpr int kStage = 2 * kKeys + kBand;  // K, V and band rows
  static constexpr int kWarpBand = 16 + kKeys;
  static constexpr int kSkewLd = attn_tiles::skew_ld(kWarpBand);
  static_assert(kKeys % 8 == 0, "key tiles are whole 8-row fragments");
};

// floats of dynamic shared memory: q_c and q_p, two ring stages, a skew
// tile a warp
template <int D>
constexpr int smem_floats() {
  return (2 * kQRows + 2 * Tiles<D>::kStage) * attn_tiles::tile_ld(D) +
         kWarps * 16 * Tiles<D>::kSkewLd;
}

static_assert(smem_floats<64>() * 4 <= 232448 &&
                  smem_floats<128>() * 4 <= 232448,
              "a block fits in the SM's shared memory");

template <int D>
__global__ void __launch_bounds__(kThreads)
rel_attn_fwd_kernel(const float* __restrict__ q_c,
                    const float* __restrict__ q_p,
                    const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ pose,
                    const int* __restrict__ k_len, int H, int Hp, int T,
                    float scale, int causal, float* __restrict__ out,
                    float* __restrict__ lse) {
  using namespace attn_tiles;
  constexpr int kKeys = Tiles<D>::kKeys;
  constexpr int kBand = Tiles<D>::kBand;
  constexpr int kStage = Tiles<D>::kStage;
  constexpr int kWarpBand = Tiles<D>::kWarpBand;
  constexpr int kSkewLd = Tiles<D>::kSkewLd;
  constexpr int LD = tile_ld(D);
  constexpr int NT = kKeys / 8;     // 8-wide fragments across a key tile
  constexpr int NG = kWarpBand / 8;  // ... across a warp's pose band
  constexpr int ND = D / 8;         // ... across the head dim
  extern __shared__ __align__(16) float smem[];
  float* sqc = smem;
  float* sqp = sqc + kQRows * LD;
  float* sring = sqp + kQRows * LD;  // [stage][k, v, band][rows][LD]
  float* sskew = sring + 2 * kStage * LD;

  const int P = 2 * T - 1;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hp = (Hp == 1) ? 0 : bh % H;
  const int l0 = blockIdx.x * kQRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = warp * 16;
  const int row0 = l0 + wrow;  // this warp's first row
  const size_t head = static_cast<size_t>(bh) * T * D;
  const float* pose_h = pose + static_cast<size_t>(hp) * P * D;
  const int klen = min(T, k_len[b]);
  float* skew = sskew + warp * 16 * kSkewLd;

  // keys the block's rows can see: below k_len, under causal none after
  // its last row; the warp's rows, none after the warp's last row
  int kend = klen;
  if (causal) kend = min(kend, l0 + kQRows);
  const int nt = kend > 0 ? (kend + kKeys - 1) / kKeys : 0;
  const int wend = causal ? min(kend, row0 + 16) : kend;

  // key tile s0 meets pose rows s0 - l0 + T - kQRows .. (band row i); the
  // warp's rows s0 - row0 + T - 16 .. start at band row kQRows - 16 - wrow
  auto stage = [&](int tile, int st) {
    const int s0 = tile * kKeys;
    float* dst = sring + st * kStage * LD;
    stage_window_async<D, kKeys, kThreads>(dst, k + head, s0, T, tid);
    stage_window_async<D, kKeys, kThreads>(dst + kKeys * LD, v + head, s0, T,
                                           tid);
    stage_window_async<D, kBand, kThreads>(dst + 2 * kKeys * LD, pose_h,
                                           s0 - l0 + T - kQRows, P, tid);
  };
  stage_window_async<D, kQRows, kThreads>(sqc, q_c + head, l0, T, tid);
  stage_window_async<D, kQRows, kThreads>(sqp, q_p + head, l0, T, tid);
  if (nt > 0) stage(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // q_c's fragments, held where they fit (kHoldQ); else split at each tile
  FragA qa[Tiles<D>::kHoldQ ? ND : 1];
  if constexpr (Tiles<D>::kHoldQ) {
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      load_a<LD>(qa[kk], sqc, wrow, 8 * kk, g, t);
    }
  }
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  }
  RowSoftmax sm;
  sm.init();

  for (int tile = 0; tile < nt; ++tile) {
    if (tile > 0) {
      // this tile has landed, and every warp is done with the previous one
      cp_async_wait<0>();
      __syncthreads();
    }
    if (tile + 1 < nt) {
      stage(tile + 1, (tile + 1) & 1);
      cp_async_commit();
    }
    const int s0 = tile * kKeys;
    if (s0 >= wend || row0 >= T) continue;  // nothing visible to the warp
    const float* tk = sring + (tile & 1) * kStage * LD;
    const float* tv = tk + kKeys * LD;
    const float* tband = tv + kKeys * LD + (kQRows - 16 - wrow) * LD;

    // s = q_c . k^T, 16 x kKeys a warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      FragB bk[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        load_b_rows_n<LD>(bk[j], tk, 8 * j, 8 * kk, g, t);
      }
      if constexpr (Tiles<D>::kHoldQ) {
        mma_f32<NT>(s, qa[kk], bk);
      } else {
        load_a<LD>(qa[0], sqc, wrow, 8 * kk, g, t);
        mma_f32<NT>(s, qa[0], bk);
      }
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
          *reinterpret_cast<float2*>(skew + (g + 8 * h) * kSkewLd + 8 * j +
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
          s[j][c] += skew[li * kSkewLd + sj - li + 15];
        }
      }
      __syncwarp();
    }

    // scale and mask: -inf where a key is not visible
    const int s_hi = s0 + kKeys - 1;
    const bool inside =
        row0 + 15 < T && s_hi < klen && (!causal || s_hi <= row0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[j][c] * scale;
        if (!inside) {
          const int l = row0 + g + 8 * (c / 2);
          const int sk = s0 + 8 * j + 2 * t + (c & 1);
          if (!visible(l, sk, T, klen, causal)) x = -INFINITY;
        }
        s[j][c] = x;
      }
    }

    // s -> p in place; rescale what o summed so far; o += p . v
    float alpha[2];
    sm.update<NT>(s, alpha);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragA ap;
      FragB bv[ND];
      acc_as_a(ap, s[j]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        load_b_rows_k<LD>(bv[n], tv, 8 * j, 8 * n, g, t);
      }
      mma_f32<ND>(o, ap, bv);
    }
  }

  float sum[2];
  sm.finish(sum);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = row0 + g + 8 * h;
    if (l >= T) continue;
    const float inv = sum[h] > 0.f ? 1.f / sum[h] : 0.f;
    float* at = out + head + static_cast<size_t>(l) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(at + 8 * n) =
          make_float2(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    }
    if (lse != nullptr && t == 0) {
      lse[static_cast<size_t>(bh) * T + l] =
          sum[h] > 0.f ? sm.m[h] + logf(sum[h]) : kLseDead;
    }
  }
}

// the kernel takes more than 48 KB of dynamic shared memory, and the SM's
// split between shared memory and L1 goes to shared memory. A function's
// attributes belong to a device: set once for each instantiation and device,
// at its first launch or query there (setting them twice does no harm)
constexpr int kMaxDevices = 64;

template <int D>
cudaError_t fwd_attributes() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  auto kernel = rel_attn_fwd_kernel<D>;
  rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats<D>() * static_cast<int>(sizeof(float)));
  if (rc != cudaSuccess) return rc;
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributePreferredSharedMemoryCarveout,
                            cudaSharedmemCarveoutMaxShared);
  if (rc == cudaSuccess && known) {
    done[dev].store(true, std::memory_order_release);
  }
  return rc;
}

template <int D>
cudaError_t launch(const float* q_c, const float* q_p, const float* k,
                   const float* v, const float* pose, const int* k_len, int B,
                   int H, int Hp, int T, float scale, int causal, float* out,
                   float* lse, cudaStream_t stream) {
  constexpr int kBytes = smem_floats<D>() * sizeof(float);
  const cudaError_t rc = fwd_attributes<D>();
  if (rc != cudaSuccess) return rc;
  dim3 grid((T + kQRows - 1) / kQRows, B * H);
  rel_attn_fwd_kernel<D><<<grid, kThreads, kBytes, stream>>>(
      q_c, q_p, k, v, pose, k_len, H, Hp, T, scale, causal, out, lse);
  return cudaGetLastError();
}

// registers a thread, bytes of local memory a thread (spills), bytes of
// dynamic shared memory and resident blocks an SM
template <int D>
cudaError_t occupancy(int* info) {
  auto kernel = rel_attn_fwd_kernel<D>;
  constexpr int kBytes = smem_floats<D>() * sizeof(float);
  cudaError_t rc = fwd_attributes<D>();
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

// q_c, q_p, k, v, out: B x H x T x D; pose: Hp x (2T-1) x D; k_len: B int32;
// lse: B x H x T or null (inference). All float32 (k_len int32), contiguous,
// on the device, 16-byte aligned. D in {16, 32, 64, 128}.
extern "C" int aps_rel_attention_fwd(const float* q_c, const float* q_p,
                                     const float* k, const float* v,
                                     const float* pose, const int* k_len,
                                     int B, int H, int Hp, int T, int D,
                                     float scale, int causal, float* out,
                                     float* lse, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || (Hp != 1 && Hp != H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  APS_DISPATCH_D(D, launch, q_c, q_p, k, v, pose, k_len, B, H, Hp, T, scale,
                 causal, out, lse, static_cast<cudaStream_t>(stream));
}

// How the forward sits on an SM at head dim D: info = {registers a thread,
// bytes of local memory a thread, bytes of dynamic shared memory a block,
// resident blocks an SM, query rows a block}.
extern "C" int aps_rel_attention_fwd_occupancy(int D, int* info) {
  info[4] = kQRows;
  APS_DISPATCH_D(D, occupancy, info);
}
