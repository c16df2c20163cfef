// Flash attention forward (scaled dot product, online softmax), Hopper
// (sm_90a), float32.
//
// Replaces the forward of aps_tpu/ops/pallas/attention.py::flash_attention
// (the TPU kernel _fwd_kernel). Semantics:
//
//   score[b,h,l,s] = q[b,h,l] . k[b,h,s] * scale (+ bias[h,l,s]),
//
// the bias, when given, is H x Tq x Tk, shared over the batch and added
// after the scaling. Keys s >= k_len[b] are masked (suffix padding), with
// `causal` also keys s > l (aligned top-left when Tq != Tk); a row with no
// visible key gives 0. When `lse` is not null the kernel also writes the
// row-wise log-sum-exp of the masked scores (max + log(sum)), B x H x Tq,
// which the backward kernels (attention_bwd.cu) read; rows with no visible
// key get kLseDead, a large positive value, so that exp(score - lse) is 0
// there.
//
// The TPU kernel walks a (b*h, q-block, k-block) grid in order and carries
// the running max, sum and accumulator in scratch memory from one k-block
// to the next, over inputs padded to block multiples. Blocks run in
// parallel and in no order here, so the k loop is inside the block, and the
// ragged ends of Tq and Tk are handled by bounds instead of padded copies.
//
// What bounds it on the card: 4 Tq Tk D operations a head on a few T D
// floats: arithmetic, not device memory. The first port ran them on the
// CUDA cores from shared memory (one thread per score, two shared loads per
// multiply-add, p broadcast by shuffles, 16 x 32 tiles restaged between two
// barriers) at a tenth of the float32 rate. This design takes the pieces of
// attn_tiles.cuh that the backward (attention_bwd.cu) is built from:
//
//   - a block of kWarps warps owns kQRows query rows, 16 a warp. Q is
//     staged once; each warp splits its Q fragments into TF32 head and
//     remainder once and keeps them in registers for every key tile;
//   - K and V stream through in tiles of kKRows rows, copied with cp.async
//     (16 bytes a thread, zeros past the end) into a ring of two stages:
//     the next tile's loads are in flight while this one is computed, one
//     barrier a tile;
//   - s = q . k^T and o += p . v run on the tensor cores (mma.sync
//     m16n8k8) as three TF32 products of the split operands: float32's
//     accuracy at a third of the TF32 rate;
//   - the online softmax stays in registers (attn_tiles::RowSoftmax: row
//     maxima across the four lanes that share a fragment row), and the
//     tile of p becomes the A operand of p . v where it lies (acc_as_a,
//     load_b_rows_k): no trip through shared memory;
//   - a warp whose 16 x kKRows tile lies wholly inside the mask (and has no
//     bias) skips the tests; a warp with nothing visible in a tile skips it;
//   - no atomics: two launches give the same bits.
//
// A head of another width up to 128 (8 in the tests' SepFormer, 96) runs the
// tiles of the next built width (a head of 65 to 96 those of 96, a width
// the ragged variant alone is built for), without a padded copy: its
// rows are staged at their own stride and zero-filled to the tile's width
// (attn_tiles::stage_rows_ragged, 16 bytes a copy where the width is a
// multiple of 4, else 4), q . k^T skips the 8-column fragments past the
// width (all zeros), and only the true columns of the output are written.
// (p . v runs over all of the tile's fragments: skipped behind a runtime
// bound, its 16 accumulators at D = 128 spilled 448 bytes and the kernel
// ran twice as long.) That variant is selected at
// compile time (kRagged), so the built widths compile to the code they had.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "attn_tiles.cuh"

namespace {

// A block of kWarps warps owns kQRows query rows and streams the keys in
// tiles of kKRows. At D = 64 it takes 175 registers and 52 KB: two blocks
// an SM. At D = 128 the same tiles take 99 KB (Q and two stages of K and V
// at a stride of 132 floats); the register count decides how many blocks
// share an SM (compare_kernels reads it). 32-row blocks (two warps)
// measured 1-2% slower at the long-form decode shape (B = 4, H = 4, T =
// 710: 368 blocks against 192 of 64 rows), 10% at the training shape and
// 2-7% at B = 16, T = 1024 (PERF.md): the grid's extra blocks buy less than
// the K and V tiles staged twice as often cost.
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQRows = 16 * kWarps;
constexpr int kKRows = 32;
constexpr float kLseDead = attn_tiles::kLseDead;

// floats of dynamic shared memory: Q, and two stages of K and V
template <int D>
constexpr int smem_floats() {
  return (kQRows + 4 * kKRows) * attn_tiles::tile_ld(D);
}

// kRagged: a head of dim < D columns (rows dim floats apart in device
// memory; vec: 16-byte copies); else dim == D and both are unused
template <int D, bool kRagged>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                const int* __restrict__ k_len, int H, int Tq, int Tk,
                float scale, int causal, float* __restrict__ out,
                float* __restrict__ lse, int dim, bool vec) {
  using namespace attn_tiles;
  constexpr int LD = tile_ld(D);
  const int W = kRagged ? dim : D;  // row stride in device memory
  // 8-column fragments that hold the head's columns (the rest are zeros)
  const int nd = kRagged ? (dim + 7) / 8 : D / 8;
  constexpr int NT = kKRows / 8;  // 8-wide fragments across a key tile
  constexpr int ND = D / 8;       // 8-wide fragments across the head dim
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* skv = sq + kQRows * LD;  // [stage][k, v][kKRows][LD]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int l0 = blockIdx.x * kQRows;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = l0 + (tid / 32) * 16;  // this warp's first row
  const float* q_h = q + static_cast<size_t>(bh) * Tq * W;
  const float* k_h = k + static_cast<size_t>(bh) * Tk * W;
  const float* v_h = v + static_cast<size_t>(bh) * Tk * W;
  // the bias is indexed by the head alone: every batch entry reads the same
  const float* bias_h =
      bias == nullptr ? nullptr
                      : bias + static_cast<size_t>(bh % H) * Tq * Tk;
  const int klen = min(Tk, k_len[b]);

  // keys the block's rows can see: below k_len, under causal none after
  // its last row; the warp's rows, none after the warp's last row
  int kend = klen;
  if (causal) kend = min(kend, l0 + kQRows);
  const int nt = kend > 0 ? (kend + kKRows - 1) / kKRows : 0;
  const int wend = causal ? min(kend, row0 + 16) : kend;

  auto stage = [&](int tile, int st) {
    float* dst = skv + st * 2 * kKRows * LD;
    stage_rows_of<kRagged, D, kKRows, kThreads>(dst, k_h, tile * kKRows, Tk,
                                                dim, vec, tid);
    stage_rows_of<kRagged, D, kKRows, kThreads>(
        dst + kKRows * LD, v_h, tile * kKRows, Tk, dim, vec, tid);
  };
  stage_rows_of<kRagged, D, kQRows, kThreads>(sq, q_h, l0, Tq, dim, vec, tid);
  if (nt > 0) stage(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  FragA qa[ND];
#pragma unroll
  for (int kk = 0; kk < ND; ++kk) {
    if (kRagged && kk >= nd) break;
    load_a<LD>(qa[kk], sq, row0 - l0, 8 * kk, g, t);
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
    const int s0 = tile * kKRows;
    if (s0 >= wend || row0 >= Tq) continue;  // nothing visible to the warp
    const float* tk = skv + (tile & 1) * 2 * kKRows * LD;
    const float* tv = tk + kKRows * LD;

    // s = q . k^T, 16 x kKRows a warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      if (kRagged && kk >= nd) break;
      FragB bk[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        load_b_rows_n<LD>(bk[j], tk, 8 * j, 8 * kk, g, t);
      }
      mma_f32<NT>(s, qa[kk], bk);
    }

    // scale, bias and mask: -inf where a key is not visible
    const int s_hi = s0 + kKRows - 1;
    const bool inside = bias_h == nullptr && row0 + 15 < Tq && s_hi < klen &&
                        (!causal || s_hi <= row0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[j][c] * scale;
        if (!inside) {
          const int l = row0 + g + 8 * (c / 2);
          const int sk = s0 + 8 * j + 2 * t + (c & 1);
          if (!visible(l, sk, Tq, klen, causal)) {
            x = -INFINITY;
          } else if (bias_h != nullptr) {
            x += bias_h[static_cast<size_t>(l) * Tk + sk];
          }
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
    if (l >= Tq) continue;
    const float inv = sum[h] > 0.f ? 1.f / sum[h] : 0.f;
    float* at = out + (static_cast<size_t>(bh) * Tq + l) * W + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if constexpr (kRagged) {
        // the true columns only, a float at a time (rows may leave the
        // 8-byte grid)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * n + 2 * t + e < dim) at[8 * n + e] = o[n][2 * h + e] * inv;
        }
      } else {
        *reinterpret_cast<float2*>(at + 8 * n) =
            make_float2(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
      }
    }
    if (lse != nullptr && t == 0) {
      lse[static_cast<size_t>(bh) * Tq + l] =
          sum[h] > 0.f ? sm.m[h] + logf(sum[h]) : kLseDead;
    }
  }
}

// the kernel may take more than 48 KB of dynamic shared memory, and the SM's
// split between shared memory and L1 goes to shared memory. A function's
// attributes belong to a device: set once for each instantiation and device,
// at its first launch or query there (setting them twice does no harm)
constexpr int kMaxDevices = 64;

template <int D, bool kRagged>
cudaError_t fwd_attributes() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  auto kernel = attn_fwd_kernel<D, kRagged>;
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

// kRagged: a head of dim < D columns in the tiles built for D
template <int D, bool kRagged = false>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, const int* k_len, int B, int H, int Tq,
                   int Tk, float scale, int causal, float* out, float* lse,
                   cudaStream_t stream, int dim, bool vec) {
  constexpr int kBytes = smem_floats<D>() * sizeof(float);
  const cudaError_t rc = fwd_attributes<D, kRagged>();
  if (rc != cudaSuccess) return rc;
  dim3 grid((Tq + kQRows - 1) / kQRows, B * H);
  attn_fwd_kernel<D, kRagged><<<grid, kThreads, kBytes, stream>>>(
      q, k, v, bias, k_len, H, Tq, Tk, scale, causal, out, lse, dim, vec);
  return cudaGetLastError();
}

// registers a thread, bytes of local memory a thread (spills), bytes of
// dynamic shared memory and resident blocks an SM
template <int D, bool kRagged = false>
cudaError_t occupancy(int* info) {
  auto kernel = attn_fwd_kernel<D, kRagged>;
  constexpr int kBytes = smem_floats<D>() * sizeof(float);
  cudaError_t rc = fwd_attributes<D, kRagged>();
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// q, out: B x H x Tq x D; k, v: B x H x Tk x D; bias: H x Tq x Tk or null;
// k_len: B int32; lse: B x H x Tq or null (inference). All float32 (k_len
// int32), contiguous, on the device. 1 <= D <= 128; at D in {16, 32, 64,
// 128} q, k and v are 16-byte aligned (rows of another width are copied 4
// bytes at a time where they leave the 16-byte grid).
extern "C" int aps_attention_fwd(const float* q, const float* k,
                                 const float* v, const float* bias,
                                 const int* k_len, int B, int H, int Tq,
                                 int Tk, int D, float scale, int causal,
                                 float* out, float* lse, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  APS_DISPATCH_D(D, launch, q, k, v, bias, k_len, B, H, Tq, Tk, scale, causal,
                 out, lse, static_cast<cudaStream_t>(stream), D, vec);
}

// How the forward sits on an SM at head dim D (another width than 16, 32, 64
// and 128: the ragged tiles it runs): info = {registers a thread, bytes of
// local memory a thread, bytes of dynamic shared memory a block, resident
// blocks an SM, query rows a block}.
extern "C" int aps_attention_fwd_occupancy(int D, int* info) {
  info[4] = kQRows;
  APS_DISPATCH_D(D, occupancy, info);
}
