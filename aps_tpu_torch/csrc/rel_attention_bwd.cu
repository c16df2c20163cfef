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
// and dp[l,s] = do[l] . v[s], delta[l] = do[l] . o[l] (given by the caller)
// and ds = p * (dp - delta) * scale, the gradients are
//
//   dq_c[l] = sum_s ds[l,s] k[s]        dq_p[l] = sum_s ds[l,s] pose[s-l+T-1]
//   dk[s]   = sum_l ds[l,s] q_c[l]      dv[s]   = sum_l p[l,s] do[l]
//   dpose[hp, r] = sum over b (and h when the table is shared) and over l
//                  of ds[l, l + r - (T-1)] q_p[l]
//
// The mask is the forward's: keys s >= k_len[b] (suffix padding), s > l
// under causal. Rows without a valid key carry lse = 1e30 from the forward,
// so p and every gradient from them are exactly 0.
//
// The TPU kernels carry their sums in scratch memory from one grid step to
// the next, because the TPU's grid runs in order on one core, and the dpose
// kernel keeps the whole table resident while a 4-d grid adds bands into
// it. Blocks run in parallel and in no order here, so each kernel keeps the
// reduction it owns inside the block:
//
//   dq:    one block per (16 query rows, b*h), loop over key tiles;
//   dk/dv: one block per (32 key rows, b*h), loop over query tiles;
//   dpose: one block per (32 table rows r, b*h), loop over query tiles. Row
//          r of the table gathers one diagonal of ds, so for a tile of
//          diagonals the pose rows are fixed (staged once) and query tile l0
//          meets the 47 key rows l0 + r0 - (T-1) ... of K and V. Each block
//          writes its rows of a per-(b,h) partial table, without atomics;
//          a second kernel sums the partial tables over b (and over h for a
//          shared table) in a fixed order, so the result is the same from
//          run to run. The partial table takes B*H*(2T-1)*D floats.
//
// The relative term is, as in the forward, a per-row index into pose rows
// in shared memory (rows padded to D+1 floats against bank conflicts); no
// shift or un-shift of a band product is needed. Ragged T, k_len, causal
// and skipped tiles are handled by bounds.
//
// What bounds them on the card: each kernel recomputes the score tile and
// dp (4 T^2 D multiply-adds per head) and then its own products (2 to 4
// T^2 D more) on the CUDA cores in float32 from shared memory; the bytes
// are a few T D floats per head. They are bound by float32 arithmetic and
// shared-memory bandwidth, not by device memory. Tensor cores (wgmma on
// tf32/bf16 tiles), larger tiles and one fused pass are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 16;   // query rows of a tile
constexpr int kBK = 32;   // key rows (dq, dk/dv) or table rows (dpose)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kQRowsPerWarp = kBQ / kWarps;
constexpr int kKRowsPerWarp = kBK / kWarps;
constexpr int kBand = kBQ + kBK - 1;
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
                                                int l0, int T, int tid) {
  if (tid < kBQ) {
    const bool ok = l0 + tid < T;
    slse[tid] = ok ? lse[l0 + tid] : kLseDead;
    sdelta[tid] = ok ? delta[l0 + tid] : 0.f;
  }
}

template <int D>
__global__ void rel_attn_dq_kernel(
    const float* __restrict__ q_c, const float* __restrict__ q_p,
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ pose, const int* __restrict__ k_len,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, int H, int Hp, int T, float scale,
    int causal, float* __restrict__ dq_c, float* __restrict__ dq_p) {
  constexpr int DP = D + 1;
  constexpr int DPL = (D + 31) / 32;
  __shared__ float sqc[kBQ][DP];
  __shared__ float sqp[kBQ][DP];
  __shared__ float sdo[kBQ][DP];
  __shared__ float sk[kBK][DP];
  __shared__ float sv[kBK][DP];
  __shared__ float sband[kBand][DP];
  __shared__ float sds[kBQ][kBK + 1];
  __shared__ float slse[kBQ];
  __shared__ float sdelta[kBQ];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hp = (Hp == 1) ? 0 : bh % H;
  const int l0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t head = static_cast<size_t>(bh) * T * D;
  const float* pose_h = pose + static_cast<size_t>(hp) * (2 * T - 1) * D;
  const int klen = k_len[b];

  stage_rows<D>(sqc, q_c + head, l0, kBQ, T, tid);
  stage_rows<D>(sqp, q_p + head, l0, kBQ, T, tid);
  stage_rows<D>(sdo, dout + head, l0, kBQ, T, tid);
  stage_row_stats(slse, sdelta, lse + static_cast<size_t>(bh) * T,
                  delta + static_cast<size_t>(bh) * T, l0, T, tid);

  float acc_c[kQRowsPerWarp][DPL], acc_p[kQRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kQRowsPerWarp; ++r) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc_c[r][i] = 0.f;
      acc_p[r][i] = 0.f;
    }
  }

  int kend = min(T, klen);
  if (causal) kend = min(kend, l0 + kBQ);
  for (int s0 = 0; s0 < kend; s0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D>(sk, k + head, s0, kBK, T, tid);
    stage_rows<D>(sv, v + head, s0, kBK, T, tid);
    // band row r holds pose[s0 - l0 - kBQ + T + r]: entry (li, sj) reads row
    // sj - li + kBQ - 1, i.e. offset (s0 + sj) - (l0 + li) + T - 1
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
      sds[li][sj] = p * (dp - sdelta[li]) * scale;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kQRowsPerWarp; ++r) {
      const int li = warp * kQRowsPerWarp + r;
      for (int sj = 0; sj < kBK; ++sj) {
        const float ds = sds[li][sj];
        const float* band = sband[sj - li + kBQ - 1];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            acc_c[r][i] = fmaf(ds, sk[sj][d], acc_c[r][i]);
            acc_p[r][i] = fmaf(ds, band[d], acc_p[r][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kQRowsPerWarp; ++r) {
    const int l = l0 + warp * kQRowsPerWarp + r;
    if (l >= T) continue;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        dq_c[head + static_cast<size_t>(l) * D + d] = acc_c[r][i];
        dq_p[head + static_cast<size_t>(l) * D + d] = acc_p[r][i];
      }
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

// partial: (B*H) x (2T-1) x D, rows [r0, r0 + kBK) of head bh by this block
template <int D>
__global__ void rel_attn_dpose_kernel(
    const float* __restrict__ q_c, const float* __restrict__ q_p,
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ pose, const int* __restrict__ k_len,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, int H, int Hp, int T, float scale,
    int causal, float* __restrict__ partial) {
  constexpr int DP = D + 1;
  constexpr int DPL = (D + 31) / 32;
  __shared__ float sqc[kBQ][DP];
  __shared__ float sqp[kBQ][DP];
  __shared__ float sdo[kBQ][DP];
  __shared__ float sk[kBand][DP];
  __shared__ float sv[kBand][DP];
  __shared__ float spose[kBK][DP];
  __shared__ float sds[kBQ][kBK + 1];
  __shared__ float slse[kBQ];
  __shared__ float sdelta[kBQ];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hp = (Hp == 1) ? 0 : bh % H;
  const int r0 = blockIdx.x * kBK;
  const int P = 2 * T - 1;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t head = static_cast<size_t>(bh) * T * D;
  const float* pose_h = pose + static_cast<size_t>(hp) * P * D;
  const int kend = min(T, k_len[b]);

  float acc[kKRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kKRowsPerWarp; ++r) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  // entry (l, r) is key s = l + r - (T-1): rows l with a valid key for
  // some r of this tile are T-1-r1 <= l < kend + T-1 - r0; under causal
  // only diagonals r <= T-1 (s <= l) carry anything
  const int r1 = min(r0 + kBK, P) - 1;
  const int llo = max(0, T - 1 - r1);
  int lhi = min(T, kend + T - 1 - r0);
  if (kend == 0 || (causal && r0 > T - 1)) lhi = 0;
  if (llo < lhi) stage_rows<D>(spose, pose_h, r0, kBK, P, tid);
  for (int l0 = (llo / kBQ) * kBQ; l0 < lhi; l0 += kBQ) {
    // entry (li, rj) of this tile reads local key row li + rj
    const int sbase = l0 + r0 - (T - 1);
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D>(sqc, q_c + head, l0, kBQ, T, tid);
    stage_rows<D>(sqp, q_p + head, l0, kBQ, T, tid);
    stage_rows<D>(sdo, dout + head, l0, kBQ, T, tid);
    stage_row_stats(slse, sdelta, lse + static_cast<size_t>(bh) * T,
                    delta + static_cast<size_t>(bh) * T, l0, T, tid);
    stage_rows<D>(sk, k + head, sbase, kBand, T, tid);
    stage_rows<D>(sv, v + head, sbase, kBand, T, tid);
    __syncthreads();

    for (int e = tid; e < kBQ * kBK; e += kThreads) {
      const int li = e / kBK;
      const int rj = e - li * kBK;
      const int kr = li + rj;
      float a = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        a = fmaf(sqc[li][d], sk[kr][d], a);
        a = fmaf(sqp[li][d], spose[rj][d], a);
        dp = fmaf(sdo[li][d], sv[kr][d], dp);
      }
      const int l = l0 + li;
      const int s = sbase + kr;
      const bool ok = l < T && r0 + rj < P && s >= 0 && s < kend &&
                      (!causal || s <= l);
      const float p = ok ? expf(a * scale - slse[li]) : 0.f;
      sds[li][rj] = p * (dp - sdelta[li]) * scale;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kKRowsPerWarp; ++r) {
      const int rj = warp * kKRowsPerWarp + r;
      for (int li = 0; li < kBQ; ++li) {
        const float ds = sds[li][rj];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[r][i] = fmaf(ds, sqp[li][d], acc[r][i]);
        }
      }
    }
  }

  float* out = partial + static_cast<size_t>(bh) * P * D;
#pragma unroll
  for (int r = 0; r < kKRowsPerWarp; ++r) {
    const int row = r0 + warp * kKRowsPerWarp + r;
    if (row >= P) continue;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[static_cast<size_t>(row) * D + d] = acc[r][i];
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

struct Args {
  const float *q_c, *q_p, *k, *v, *pose;
  const int* k_len;
  const float *dout, *lse, *delta;
  int B, H, Hp, T;
  float scale;
  int causal;
};

template <int D>
void launch_dq(const Args& a, float* dq_c, float* dq_p, cudaStream_t s) {
  dim3 grid((a.T + kBQ - 1) / kBQ, a.B * a.H);
  rel_attn_dq_kernel<D><<<grid, kThreads, 0, s>>>(
      a.q_c, a.q_p, a.k, a.v, a.pose, a.k_len, a.dout, a.lse, a.delta, a.H,
      a.Hp, a.T, a.scale, a.causal, dq_c, dq_p);
}

template <int D>
void launch_dkv(const Args& a, float* dk, float* dv, cudaStream_t s) {
  dim3 grid((a.T + kBK - 1) / kBK, a.B * a.H);
  rel_attn_dkv_kernel<D><<<grid, kThreads, 0, s>>>(
      a.q_c, a.q_p, a.k, a.v, a.pose, a.k_len, a.dout, a.lse, a.delta, a.H,
      a.Hp, a.T, a.scale, a.causal, dk, dv);
}

template <int D>
void launch_dpose(const Args& a, float* partial, cudaStream_t s) {
  dim3 grid((2 * a.T - 1 + kBK - 1) / kBK, a.B * a.H);
  rel_attn_dpose_kernel<D><<<grid, kThreads, 0, s>>>(
      a.q_c, a.q_p, a.k, a.v, a.pose, a.k_len, a.dout, a.lse, a.delta, a.H,
      a.Hp, a.T, a.scale, a.causal, partial);
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

// Shapes as in the forward: q_c, q_p, k, v, dout and the outputs B x H x T x
// D; pose Hp x (2T-1) x D; k_len B int32; lse, delta B x H x T. All float32
// (k_len int32), contiguous, on the device. D in {16, 32, 64}.
extern "C" int aps_rel_attention_dq(
    const float* q_c, const float* q_p, const float* k, const float* v,
    const float* pose, const int* k_len, const float* dout, const float* lse,
    const float* delta, int B, int H, int Hp, int T, int D, float scale,
    int causal, float* dq_c, float* dq_p, void* stream) {
  const Args a{q_c, q_p, k, v, pose, k_len, dout, lse, delta,
               B, H, Hp, T, scale, causal};
  APS_DISPATCH_D(D, launch_dq, a, dq_c, dq_p,
                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int aps_rel_attention_dkv(
    const float* q_c, const float* q_p, const float* k, const float* v,
    const float* pose, const int* k_len, const float* dout, const float* lse,
    const float* delta, int B, int H, int Hp, int T, int D, float scale,
    int causal, float* dk, float* dv, void* stream) {
  const Args a{q_c, q_p, k, v, pose, k_len, dout, lse, delta,
               B, H, Hp, T, scale, causal};
  APS_DISPATCH_D(D, launch_dkv, a, dk, dv, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// partial: scratch of B*H x (2T-1) x D floats; dpose: Hp x (2T-1) x D.
extern "C" int aps_rel_attention_dpose(
    const float* q_c, const float* q_p, const float* k, const float* v,
    const float* pose, const int* k_len, const float* dout, const float* lse,
    const float* delta, int B, int H, int Hp, int T, int D, float scale,
    int causal, float* partial, float* dpose, void* stream) {
  const Args a{q_c, q_p, k, v, pose, k_len, dout, lse, delta,
               B, H, Hp, T, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APS_DISPATCH_D(D, launch_dpose, a, partial, s);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int n = (2 * T - 1) * D;
  dim3 grid((n + 255) / 256, Hp);
  rel_attn_dpose_reduce_kernel<<<grid, 256, 0, s>>>(partial, B, H, Hp, n,
                                                    dpose);
  return static_cast<int>(cudaGetLastError());
}
