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
// and dp[l,s] = do[l] . v[s], delta[l] = do[l] . o[l] (given by the caller)
// and ds = p * (dp - delta) * scale, the gradients are
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
// inside the block, without atomics:
//
//   dq:    one block per (16 query rows, b*h), loop over key tiles;
//   dk/dv: one block per (32 key rows, b*h), loop over query tiles;
//   dbias: one block per (32 key columns, 16 query rows, h) that loops over
//          the batch in order and writes its tile once, so the result is
//          the same from run to run. By design it recomputes the tile's
//          scores and dp once per batch entry: B times per tile.
//
// Ragged Tq and Tk, k_len, causal and skipped tiles are handled by bounds;
// no padded copy of an operand is made.
//
// What bounds them on the card: each kernel recomputes the score tile and
// dp (4 Tq Tk D operations per head) and then its own products (2 to 4 Tq Tk
// D more, none for dbias) on the CUDA cores in float32 from shared memory;
// the bytes are a few T D floats per head (dbias: the H x Tq x Tk tile once,
// read and written). They are bound by float32 arithmetic and shared-memory
// bandwidth, not by device memory. Tensor cores (wgmma on tf32/bf16 tiles),
// larger tiles and one fused pass are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 16;   // query rows of a tile
constexpr int kBK = 32;   // key rows of a tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kQRowsPerWarp = kBQ / kWarps;
constexpr int kKRowsPerWarp = kBK / kWarps;
constexpr int kPerThread = kBQ * kBK / kThreads;  // tile entries of a thread
constexpr float kLseDead = 1.0e30f;

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

template <int D>
__global__ void attn_dq_kernel(Args a, float* __restrict__ dq) {
  constexpr int DP = D + 1;
  constexpr int DPL = (D + 31) / 32;
  __shared__ float sq[kBQ][DP];
  __shared__ float sdo[kBQ][DP];
  __shared__ float sk[kBK][DP];
  __shared__ float sv[kBK][DP];
  __shared__ float sds[kBQ][kBK + 1];
  __shared__ float slse[kBQ];
  __shared__ float sdelta[kBQ];

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int l0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t qhead = static_cast<size_t>(bh) * a.Tq * D;
  const size_t khead = static_cast<size_t>(bh) * a.Tk * D;
  const float* bias_h =
      a.bias == nullptr
          ? nullptr
          : a.bias + static_cast<size_t>(bh % a.H) * a.Tq * a.Tk;
  const int klen = min(a.Tk, a.k_len[b]);

  stage_rows<D>(sq, a.q + qhead, l0, kBQ, a.Tq, tid);
  stage_rows<D>(sdo, a.dout + qhead, l0, kBQ, a.Tq, tid);
  stage_row_stats(slse, sdelta, a.lse + static_cast<size_t>(bh) * a.Tq,
                  a.delta + static_cast<size_t>(bh) * a.Tq, l0, a.Tq, tid);

  float acc[kQRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kQRowsPerWarp; ++r) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  int kend = klen;
  if (a.causal) kend = min(kend, l0 + kBQ);
  for (int s0 = 0; s0 < kend; s0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D>(sk, a.k + khead, s0, kBK, a.Tk, tid);
    stage_rows<D>(sv, a.v + khead, s0, kBK, a.Tk, tid);
    __syncthreads();

    for (int e = tid; e < kBQ * kBK; e += kThreads) {
      const int li = e / kBK;
      const int sj = e - li * kBK;
      float p, dpd;
      tile_entry<D>(sq, sdo, sk, sv, slse, sdelta, bias_h, li, sj, l0 + li,
                    s0 + sj, a.Tq, a.Tk, klen, a.scale, a.causal, &p, &dpd);
      sds[li][sj] = p * dpd * a.scale;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kQRowsPerWarp; ++r) {
      const int li = warp * kQRowsPerWarp + r;
      for (int sj = 0; sj < kBK; ++sj) {
        const float ds = sds[li][sj];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[r][i] = fmaf(ds, sk[sj][d], acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kQRowsPerWarp; ++r) {
    const int l = l0 + warp * kQRowsPerWarp + r;
    if (l >= a.Tq) continue;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dq[qhead + static_cast<size_t>(l) * D + d] = acc[r][i];
    }
  }
}

template <int D>
__global__ void attn_dkv_kernel(Args a, float* __restrict__ dk,
                                float* __restrict__ dv) {
  constexpr int DP = D + 1;
  constexpr int DPL = (D + 31) / 32;
  __shared__ float sq[kBQ][DP];
  __shared__ float sdo[kBQ][DP];
  __shared__ float sk[kBK][DP];
  __shared__ float sv[kBK][DP];
  __shared__ float sp[kBQ][kBK + 1];
  __shared__ float sds[kBQ][kBK + 1];
  __shared__ float slse[kBQ];
  __shared__ float sdelta[kBQ];

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int s0 = blockIdx.x * kBK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t qhead = static_cast<size_t>(bh) * a.Tq * D;
  const size_t khead = static_cast<size_t>(bh) * a.Tk * D;
  const float* bias_h =
      a.bias == nullptr
          ? nullptr
          : a.bias + static_cast<size_t>(bh % a.H) * a.Tq * a.Tk;
  const int klen = min(a.Tk, a.k_len[b]);

  float acc_k[kKRowsPerWarp][DPL], acc_v[kKRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kKRowsPerWarp; ++r) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc_k[r][i] = 0.f;
      acc_v[r][i] = 0.f;
    }
  }

  // a key tile past k_len has no visible key: its gradients are exactly 0
  if (s0 < klen) {
    stage_rows<D>(sk, a.k + khead, s0, kBK, a.Tk, tid);
    stage_rows<D>(sv, a.v + khead, s0, kBK, a.Tk, tid);
    // under causal only rows l >= s see key s
    const int lbeg = a.causal ? (s0 / kBQ) * kBQ : 0;
    for (int l0 = lbeg; l0 < a.Tq; l0 += kBQ) {
      __syncthreads();  // the previous tile's readers are done
      stage_rows<D>(sq, a.q + qhead, l0, kBQ, a.Tq, tid);
      stage_rows<D>(sdo, a.dout + qhead, l0, kBQ, a.Tq, tid);
      stage_row_stats(slse, sdelta, a.lse + static_cast<size_t>(bh) * a.Tq,
                      a.delta + static_cast<size_t>(bh) * a.Tq, l0, a.Tq,
                      tid);
      __syncthreads();

      for (int e = tid; e < kBQ * kBK; e += kThreads) {
        const int li = e / kBK;
        const int sj = e - li * kBK;
        float p, dpd;
        tile_entry<D>(sq, sdo, sk, sv, slse, sdelta, bias_h, li, sj, l0 + li,
                      s0 + sj, a.Tq, a.Tk, klen, a.scale, a.causal, &p, &dpd);
        sp[li][sj] = p;
        sds[li][sj] = p * dpd * a.scale;
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
              acc_k[r][i] = fmaf(ds, sq[li][d], acc_k[r][i]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kKRowsPerWarp; ++r) {
    const int s = s0 + warp * kKRowsPerWarp + r;
    if (s >= a.Tk) continue;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        dk[khead + static_cast<size_t>(s) * D + d] = acc_k[r][i];
        dv[khead + static_cast<size_t>(s) * D + d] = acc_v[r][i];
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

template <int D>
void launch_dq(const Args& a, float* dq, cudaStream_t s) {
  dim3 grid((a.Tq + kBQ - 1) / kBQ, a.B * a.H);
  attn_dq_kernel<D><<<grid, kThreads, 0, s>>>(a, dq);
}

template <int D>
void launch_dkv(const Args& a, float* dk, float* dv, cudaStream_t s) {
  dim3 grid((a.Tk + kBK - 1) / kBK, a.B * a.H);
  attn_dkv_kernel<D><<<grid, kThreads, 0, s>>>(a, dk, dv);
}

template <int D>
void launch_dbias(const Args& a, float* dbias, cudaStream_t s) {
  dim3 grid((a.Tk + kBK - 1) / kBK, (a.Tq + kBQ - 1) / kBQ, a.H);
  attn_dbias_kernel<D><<<grid, kThreads, 0, s>>>(a, dbias);
}

bool bad_dims(int B, int H, int Tq, int Tk) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0;
}

}  // namespace

extern "C" const char* aps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define APS_DISPATCH_D(D, fn, ...)                      \
  switch (D) {                                          \
    case 16: fn<16>(__VA_ARGS__); break;                \
    case 32: fn<32>(__VA_ARGS__); break;                \
    case 64: fn<64>(__VA_ARGS__); break;                \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// Shapes as in the forward: q, dout, dq B x H x Tq x D; k, v, dk, dv B x H x
// Tk x D; bias H x Tq x Tk or null; k_len B int32; lse, delta B x H x Tq.
// All float32 (k_len int32), contiguous, on the device. D in {16, 32, 64}.
// Every entry takes two output pointers; dq and dbias use the first only.
extern "C" int aps_attention_dq(
    const float* q, const float* k, const float* v, const float* bias,
    const int* k_len, const float* dout, const float* lse, const float* delta,
    int B, int H, int Tq, int Tk, int D, float scale, int causal, float* dq,
    float* unused, void* stream) {
  if (bad_dims(B, H, Tq, Tk)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, bias, k_len, dout, lse, delta,
               B, H, Tq, Tk, scale, causal};
  APS_DISPATCH_D(D, launch_dq, a, dq, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
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
  return static_cast<int>(cudaGetLastError());
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
  return static_cast<int>(cudaGetLastError());
}
