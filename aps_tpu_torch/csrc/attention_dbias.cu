// The bias gradient of flash attention (K2's dbias), Hopper (sm_90a),
// float32: one tiled kernel for every head width.
//
// Replaces aps_tpu/ops/pallas/attention.py::_dbias_kernel (launched by _bwd
// on the grid (H, nq, nk, B), the batch its last, sequential axis). With
// the forward's
//
//   score[l,s] = q[l] . k[s] * scale + bias[h,l,s]
//   p[l,s]     = mask(l,s) ? exp(score[l,s] - lse[l]) : 0
//
// and dp[l,s] = do[l] . v[s], delta[l] = do[l] . o[l] (formed by the dq
// kernel, attention_bwd.cu or wide_attention.cu, which runs first):
//
//   dbias[h,l,s] = sum over b of p[l,s] * (dp[l,s] - delta[l])
//
// with no trailing scale (the bias is added after the scaling). Key s
// counts for row l only if s < k_len[b] and, under causal, s <= l (aligned
// top-left when Tq != Tk); a row without a visible key has lse = kLseDead,
// so its p is exactly 0.
//
// What bounds it: a batch entry's visible pair costs two dot products of
// the head (4 D operations) on q, k, v and do, which are read once; the
// bias is read and dbias written once (2 H Tq Tk floats). At the
// long-form training step (B = 8, H = 4, T = 690, D = 64) that is 3.4
// GFLOP on 30 MB: arithmetic, as for dq and dk/dv. The first port ran
// each entry as two D-long loops on the CUDA cores, a thread (D <= 128)
// or a warp (wider heads) an entry, every batch entry's rows restaged.
//
// The design:
//
//   - a block of 8 warps owns a tile of 64 query rows x 64 key columns of
//     one head and loops over the batch in order, writing its tile once:
//     no atomics, the same bits at every run. This loop replaces the TPU's
//     sequential batch axis. A batch entry whose keys all lie below the
//     tile's first column (s0 >= k_len[b]) is skipped by the whole block;
//     a tile wholly above the causal diagonal does no work but still
//     writes its zeros (the wrapper allocates dbias uninitialised);
//   - the head is a streamed reduction axis: s = q . k^T and dp = do . v^T
//     accumulate over chunks of kChunk = 32 columns. Each chunk of q, do,
//     k and v is copied by cp.async into a ring of kStages stages that
//     runs across the whole (batch entry, chunk) sequence, so the next
//     loads are in flight while the products run: one barrier a chunk. A
//     ragged last chunk is zero-filled, and its 8-column steps past the
//     head are not computed; rows off the 16-byte grid (D % 4 != 0 or an
//     unaligned operand) are copied 4 bytes at a time. One template serves
//     every width from 1 up;
//   - the products run on the tensor cores, mma.sync m16n8k8 with every
//     float32 product split into three TF32 products (attn_tiles.cuh): a
//     single TF32 pass keeps three digits, which the gradient tolerances
//     do not survive. Warp w holds rows 16 (w % 4).. and columns
//     32 (w / 4).. of the tile. A chunk's products go to accumulators of
//     their own and are added to s and dp with rounding: the tensor cores
//     truncate as they accumulate, and dbias, unlike dq and dk/dv, carries
//     no factor scale = D^-1/2 that would shrink the drift of a sum kept
//     in their accumulators over the whole head;
//   - s, dp, the dbias accumulator and the block's bias tile stay in
//     registers in the accumulator layout; the bias tile is read once per
//     block. After a batch entry's last chunk s and dp become p (dp -
//     delta) and are added to the accumulator; lse and delta of the entry
//     are loaded at its first chunk, so their latency hides behind the
//     products;
//   - where H ceil(Tq / 64) ceil(Tk / 64) blocks are too few for the card
//     (heads of 8 in SepFormer's chunks: B = 144, H = 2, T = 16 gives two
//     blocks and 144 entries in series), the wrapper cuts the batch into
//     `groups` contiguous ranges, a block each (grid z): each writes a
//     partial tile and dbias_sum_kernel adds the partials in group order.
//     The result is still the same at every run.
//
// 3 stages x 4 operands x 64 rows x 36 floats take 108 KB of shared
// memory: two blocks (16 warps) an SM, the registers held to 128 a
// thread (ptxas for sm_90a spills 12 bytes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "attn_tiles.cuh"

namespace {

constexpr int kRows = 64;    // query rows and key columns of a block's tile
constexpr int kChunk = 32;   // head columns a stage holds
constexpr int kStages = 3;   // depth of the cp.async ring
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSM = 2;
constexpr int kLd = attn_tiles::tile_ld(kChunk);  // row stride of a tile
constexpr int kNT = kRows / 2 / 8;  // 8-column fragments a warp holds
constexpr int kTileFloats = kRows * kLd;
constexpr int kStageFloats = 4 * kTileFloats;  // q, do, k, v
constexpr int kSmemBytes = kStages * kStageFloats * sizeof(float);
constexpr int kMaxDevices = 64;
static_assert(kRows == 16 * (kWarps / 2) && kNT * 8 * 2 == kRows,
              "four row groups of 16 rows, two halves of 32 columns");
static_assert(kBlocksPerSM * (kSmemBytes + 1024) <= 233472,
              "two blocks share an SM's 228 KB");
static_assert(kRows * kChunk / 4 % kThreads == 0,
              "a chunk is whole passes of 16-byte pieces");

struct Args {
  const float *q, *k, *v, *bias;
  const int* k_len;
  const float *dout, *lse, *delta;
  int B, H, Tq, Tk, D;
  float scale;
  int causal;
};

// rows [r0, r0 + kRows) x head columns [c0, c0 + kChunk) of a (limit x D)
// row-major matrix -> tile (row stride kLd), zeros for rows at or past
// limit and columns at or past D. vec (D % 4 == 0 and src 16-byte
// aligned): 16 bytes a copy; else a float a copy.
__device__ __forceinline__ void stage_chunk(float* tile,
                                            const float* __restrict__ src,
                                            int r0, int limit, int c0, int D,
                                            bool vec, int tid) {
  using namespace attn_tiles;
  constexpr int kPieces = kChunk / 4;  // 16-byte pieces of a tile row
#pragma unroll
  for (int n = 0; n < kRows * kPieces / kThreads; ++n) {
    const int i = tid + n * kThreads;
    const int r = i / kPieces;
    const int c = (i - r * kPieces) * 4;
    const bool live = r0 + r < limit;
    const float* from = src + static_cast<size_t>(r0 + r) * D + c0 + c;
    float* dst = tile + r * kLd + c;
    if (vec) {
      const bool ok = live && c0 + c < D;
      cp_async_16(dst, ok ? from : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = live && c0 + c + e < D;
        cp_async_4(dst + e, ok ? from + e : src, ok);
      }
    }
  }
}

// the block: tile (rows l0.., columns s0..) of head h, batch entries of
// group z / H (of `groups` contiguous ranges) summed in order into `out`
// (dbias, or group z / H's partial tile when groups > 1)
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    attn_dbias_tiles_kernel(Args a, int groups, bool vec,
                            float* __restrict__ out) {
  using namespace attn_tiles;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rg = tid / 32 % 4;  // the warp's row group
  const int half = tid / 128;   // the warp's half of the columns
  const int s0 = blockIdx.x * kRows;
  const int l0 = blockIdx.y * kRows;
  const int h = blockIdx.z % a.H;
  const int group = blockIdx.z / a.H;
  const int b_beg = static_cast<int>(static_cast<long>(a.B) * group / groups);
  const int b_end =
      static_cast<int>(static_cast<long>(a.B) * (group + 1) / groups);
  const int wl = l0 + 16 * rg;   // the warp's first row
  const int ws = s0 + 32 * half;  // the warp's first column
  const int nchunks = (a.D + kChunk - 1) / kChunk;

  // the block's bias tile and the dbias accumulator, in the accumulator
  // layout: c0 (row g, column 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3
  const float* bias_h = a.bias + static_cast<size_t>(h) * a.Tq * a.Tk;
  float bias[kNT][4], acc[kNT][4], s[kNT][4], dp[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int l = wl + g + 8 * (c / 2);
      const int sk = ws + 8 * j + 2 * t + (c & 1);
      bias[j][c] = l < a.Tq && sk < a.Tk
                       ? bias_h[static_cast<size_t>(l) * a.Tk + sk]
                       : 0.f;
      acc[j][c] = s[j][c] = dp[j][c] = 0.f;
    }
  }

  auto klen_of = [&](int b) { return min(a.Tk, a.k_len[b]); };
  // the first batch entry from b on that sees a key of the tile
  auto next_live = [&](int b) {
    while (b < b_end && s0 >= klen_of(b)) ++b;
    return b;
  };
  // under causal a tile wholly above the diagonal sees nothing
  const bool dead = a.causal && s0 > l0 + kRows - 1;
  const int first = dead ? b_end : next_live(b_beg);

  // the producer's place in the (batch entry, chunk) sequence
  int pb = first, pc = 0;
  auto stage_next = [&](int stage) {
    if (pb < b_end) {
      float* tile = smem + stage * kStageFloats;
      const size_t bh = static_cast<size_t>(pb) * a.H + h;
      const size_t qhead = bh * a.Tq * a.D;
      const size_t khead = bh * a.Tk * a.D;
      const int c0 = pc * kChunk;
      const int klen = klen_of(pb);
      stage_chunk(tile, a.q + qhead, l0, a.Tq, c0, a.D, vec, tid);
      stage_chunk(tile + kTileFloats, a.dout + qhead, l0, a.Tq, c0, a.D, vec,
                  tid);
      stage_chunk(tile + 2 * kTileFloats, a.k + khead, s0, klen, c0, a.D,
                  vec, tid);
      stage_chunk(tile + 3 * kTileFloats, a.v + khead, s0, klen, c0, a.D,
                  vec, tid);
      if (++pc == nchunks) {
        pc = 0;
        pb = next_live(pb + 1);
      }
    }
    cp_async_commit();  // past the end an empty group keeps the count
  };
#pragma unroll 1
  for (int i = 0; i < kStages - 1; ++i) stage_next(i);

  float row_lse[2] = {kLseDead, kLseDead}, row_delta[2] = {0.f, 0.f};
  int cb = first, cc = 0;
#pragma unroll 1
  for (int step = 0; cb < b_end; ++step) {
    // this step's chunk has landed, and every warp is done with the
    // stage the next copy overwrites
    cp_async_wait<kStages - 2>();
    __syncthreads();
    stage_next((step + kStages - 1) % kStages);
    if (cc == 0) {
      const size_t srow = (static_cast<size_t>(cb) * a.H + h) * a.Tq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int l = wl + g + 8 * r;
        row_lse[r] = l < a.Tq ? a.lse[srow + l] : kLseDead;
        row_delta[r] = l < a.Tq ? a.delta[srow + l] : 0.f;
      }
    }
    const float* tq = smem + (step % kStages) * kStageFloats;
    const float* tdo = tq + kTileFloats;
    const float* tk = tq + 2 * kTileFloats;
    const float* tv = tq + 3 * kTileFloats;
    const int width = a.D - cc * kChunk;  // head columns of this chunk
    // sum += this chunk's a . b^T, formed in accumulators of its own and
    // added with rounding: the tensor cores truncate as they accumulate,
    // so a sum carried in their accumulators over a long head drifts
    // toward zero (on an H100 at D = 1100, by 1e-3 on dbias entries of
    // 30), where a chunk's 12 products (3 passes of 4 steps) drift little
    // and the chunks' drifts have no common sign
    auto product = [&](float(&sum)[kNT][4], const float* ta,
                       const float* tb) {
      float part[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) part[j][c] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 8) {
        if (kk < width) {
          FragA fa;
          FragB fb[kNT];
          load_a<kLd>(fa, ta, 16 * rg, kk, g, t);
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            load_b_rows_n<kLd>(fb[j], tb, 32 * half + 8 * j, kk, g, t);
          mma_f32<kNT>(part, fa, fb);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) sum[j][c] += part[j][c];
      }
    };
    product(s, tq, tk);
    product(dp, tdo, tv);
    if (++cc < nchunks) continue;

    // batch entry cb's products are whole: acc += p (dp - delta). A warp
    // whose 16 x 32 tile lies wholly inside the mask skips the tests.
    // __expf: its argument carries the score's own rounding error, far
    // above the approximation's
    const int klen = klen_of(cb);
    const bool inside = wl + 15 < a.Tq && ws + 31 < klen &&
                        (!a.causal || ws + 31 <= wl);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c / 2;
        const int l = wl + g + 8 * r;
        const int sk = ws + 8 * j + 2 * t + (c & 1);
        const bool ok = inside || visible(l, sk, a.Tq, klen, a.causal);
        const float p =
            ok ? __expf(s[j][c] * a.scale + bias[j][c] - row_lse[r]) : 0.f;
        acc[j][c] += p * (dp[j][c] - row_delta[r]);
        s[j][c] = dp[j][c] = 0.f;
      }
    }
    cc = 0;
    cb = next_live(cb + 1);
  }
  cp_async_wait<0>();

  float* dst = out + (static_cast<size_t>(group) * a.H + h) * a.Tq * a.Tk;
  const bool pairs = a.Tk % 2 == 0;  // float2 stores stay aligned
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int l = wl + g + 8 * r;
    if (l >= a.Tq) continue;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int sk = ws + 8 * j + 2 * t;
      float* at = dst + static_cast<size_t>(l) * a.Tk + sk;
      if (pairs && sk + 1 < a.Tk) {
        *reinterpret_cast<float2*>(at) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      } else {
        if (sk < a.Tk) at[0] = acc[j][2 * r];
        if (sk + 1 < a.Tk) at[1] = acc[j][2 * r + 1];
      }
    }
  }
}

// dbias[i] = sum over the groups, in order, of partial[group][i]
__global__ void dbias_sum_kernel(const float* __restrict__ partial,
                                 int groups, long n,
                                 float* __restrict__ dbias) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int group = 0; group < groups; ++group) acc += partial[group * n + i];
  dbias[i] = acc;
}

// the kernel takes more than 48 KB of dynamic shared memory, and the SM's
// split between shared memory and L1 goes to shared memory. A function's
// attributes belong to a device: set once for each device, at the first
// launch or query there (setting them twice does no harm)
cudaError_t tiles_attributes() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  rc = cudaFuncSetAttribute(attn_dbias_tiles_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kSmemBytes);
  if (rc != cudaSuccess) return rc;
  rc = cudaFuncSetAttribute(attn_dbias_tiles_kernel,
                            cudaFuncAttributePreferredSharedMemoryCarveout,
                            cudaSharedmemCarveoutMaxShared);
  if (rc == cudaSuccess && known) {
    done[dev].store(true, std::memory_order_release);
  }
  return rc;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" const char* aps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shapes as attention_bwd.cu's entries take them: q, dout B x H x Tq x D;
// k, v B x H x Tk x D; bias and dbias H x Tq x Tk; k_len B int32; lse,
// delta B x H x Tq (delta formed by the dq kernel). Any D >= 1. All float32
// (k_len int32), contiguous, on the device. groups (1 <= groups <= B):
// contiguous ranges of the batch, a block each; for groups > 1, partial is
// scratch of groups x H x Tq x Tk floats (else unused).
extern "C" int aps_attention_dbias(
    const float* q, const float* k, const float* v, const float* bias,
    const int* k_len, const float* dout, const float* lse, const float* delta,
    int B, int H, int Tq, int Tk, int D, float scale, int causal, int groups,
    float* dbias, float* partial, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || bias == nullptr ||
      groups < 1 || groups > B || (groups > 1 && partial == nullptr) ||
      static_cast<long>(H) * groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t rc = tiles_attributes();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const Args a{q, k, v, bias, k_len, dout, lse, delta,
               B, H, Tq, Tk, D, scale, causal};
  const bool vec = D % 4 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(dout);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((Tk + kRows - 1) / kRows, (Tq + kRows - 1) / kRows,
                  H * groups);
  attn_dbias_tiles_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      a, groups, vec, groups == 1 ? dbias : partial);
  rc = cudaGetLastError();
  if (rc != cudaSuccess || groups == 1) return static_cast<int>(rc);
  const long n = static_cast<long>(H) * Tq * Tk;
  dbias_sum_kernel<<<static_cast<int>((n + 255) / 256), 256, 0, st>>>(
      partial, groups, n, dbias);
  return static_cast<int>(cudaGetLastError());
}

// How the kernel sits on an SM (the same at every head width): info =
// {registers a thread, bytes of local memory a thread (spills), bytes of
// dynamic shared memory a block, resident blocks an SM, head columns a
// chunk, threads a block, stages of the ring}.
extern "C" int aps_attention_dbias_occupancy(int* info) {
  cudaError_t rc = tiles_attributes();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, attn_dbias_tiles_kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = kSmemBytes;
  info[4] = kChunk;
  info[5] = kThreads;
  info[6] = kStages;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      info + 3, attn_dbias_tiles_kernel, kThreads, kSmemBytes));
}
