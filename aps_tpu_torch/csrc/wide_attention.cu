// Flash attention (K2) and flash attention with relative-position scores
// (K3) for heads wider than 128, forward and backward, Hopper (sm_90a),
// float32.
//
// The tensor-core kernels of attention.cu, attention_bwd.cu,
// rel_attention.cu and rel_attention_bwd.cu are built for head widths 16,
// 32, 64 and 128: their Q, K, V and pose tiles sit whole in shared memory
// and their fragments in registers, and at D = 128 a block already takes
// one SM. aps_tpu's flash_attention and flash_attention_rel take any width,
// so the wrappers send a head over 128 here. Semantics are theirs:
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
// Design: one warp a row of the output, the lanes striding over the head
// (lane j holds columns j, j + 32, ...). A dot product over D is a lane sum
// and a butterfly of shuffles, so every lane holds the same bits of it. A
// warp's accumulators are kCols = 32 * kPer columns in registers; a wider
// head runs its columns in passes of kCols, each recomputing the scores it
// needs (no width has a ceiling, and none spills). The forward first walks
// the visible keys for the row's max and sum (lse), then each pass adds
// exp(score - lse) v[s] into its columns, so no pass rescales. The operands
// stream from global memory through L1: a block's kWarps warps own
// consecutive rows of one (b, h) and read the same key rows in the same
// order. Every warp owns the sums it writes and adds in a fixed order, no
// atomics: two launches give the same bits.
//
//   forward: a warp a query row (b, h, l): lse, then out in passes;
//   dq:      a warp a query row: delta = do . o (written), then dq (and
//            dq_p) in passes;
//   dk/dv:   a warp a key row (b, h, s), over the query rows that see it;
//   dbias:   a warp an entry (h, l, s), the batch summed in order;
//   dpose:   a warp a table row of a per-(b, h) partial table, over its
//            diagonal of (l, s) pairs; a second kernel sums the partial
//            tables over b (and h for a shared table) in order, as
//            rel_attention_bwd.cu does.
//
// These are CUDA-core loops at a fraction of the card's rate; no model of
// the repo has such a head, so no path launches them.

#include <cuda_runtime.h>
#include <math.h>

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

// p and ds of a visible (l, s), given the row's lse and delta
template <bool kRel>
__device__ __forceinline__ void p_ds(const Args& a, int bh, int h, int l,
                                     int s, float row_lse, float row_delta,
                                     int lane, float* p, float* ds) {
  const size_t D = a.D;
  *p = expf(score<kRel>(a, bh, h, l, s, lane) - row_lse);
  const float dp = dot(a.dout + (static_cast<size_t>(bh) * a.Tq + l) * D,
                       a.v + (static_cast<size_t>(bh) * a.Tk + s) * D, a.D,
                       lane);
  *ds = *p * (dp - row_delta) * a.scale;
}

template <bool kRel>
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
    const float sc = score<kRel>(a, bh, h, l, s, lane);
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
      const float p = expf(score<kRel>(a, bh, h, l, s, lane) - row_lse);
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

template <bool kRel>
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
      p_ds<kRel>(a, bh, h, l, s, row_lse, row_delta, lane, &p, &ds);
      const float* krow = a.k + (static_cast<size_t>(bh) * a.Tk + s) * D;
      const float* prow =
          kRel ? a.pose + (static_cast<size_t>(hp) * (2 * T - 1) +
                           (s - l + T - 1)) * D
               : nullptr;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int d = c0 + lane + 32 * j;
        if (d < a.D) {
          acc[j] = fmaf(ds, __ldg(krow + d), acc[j]);
          if constexpr (kRel) accp[j] = fmaf(ds, __ldg(prow + d), accp[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int d = c0 + lane + 32 * j;
      if (d < a.D) {
        dq[row * D + d] = acc[j];
        if constexpr (kRel) dq_p[row * D + d] = accp[j];
      }
    }
  }
}

template <bool kRel>
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
      p_ds<kRel>(a, bh, h, l, s, a.lse[qr], a.delta[qr], lane, &p, &ds);
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
      p_ds<true>(a, bh, h, l, s, a.lse[qr], a.delta[qr], lane, &p, &ds);
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
// arguments (any D > 0; the wrapper sends D > 128 here)

extern "C" int aps_attention_wide_fwd(const float* q, const float* k,
                                      const float* v, const float* bias,
                                      const int* k_len, int B, int H, int Tq,
                                      int Tk, int D, float scale, int causal,
                                      float* out, float* lse, void* stream) {
  if (bad(B, H, Tq, Tk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = k2_args(q, k, v, bias, k_len, nullptr, nullptr, nullptr, B,
                         H, Tq, Tk, D, scale, causal);
  fwd_kernel<false><<<blocks_of(static_cast<long>(B) * H * Tq), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a, out, lse);
  return status();
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
  dq_kernel<false><<<blocks_of(static_cast<long>(B) * H * Tq), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, out, delta, dq,
                                                          nullptr);
  return status();
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
  dkv_kernel<false><<<blocks_of(static_cast<long>(B) * H * Tk), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a, dk, dv);
  return status();
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
  fwd_kernel<true><<<blocks_of(static_cast<long>(B) * H * T), kThreads, 0,
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
  dq_kernel<true><<<blocks_of(static_cast<long>(B) * H * T), kThreads, 0,
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
  dkv_kernel<true><<<blocks_of(static_cast<long>(B) * H * T), kThreads, 0,
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

// Registers and bytes of local memory (spills) a thread of kernel `kernel`:
// 0 K2 forward, 1 K2 dq, 2 K2 dk/dv, 3 K2 dbias, 4 K3 forward, 5 K3 dq,
// 6 K3 dk/dv, 7 K3 dpose's partial tables; info = {registers, local bytes,
// static shared bytes, resident blocks an SM, columns a pass}.
extern "C" int aps_wide_attention_occupancy(int kernel, int* info) {
  const void* fns[] = {
      reinterpret_cast<const void*>(fwd_kernel<false>),
      reinterpret_cast<const void*>(dq_kernel<false>),
      reinterpret_cast<const void*>(dkv_kernel<false>),
      reinterpret_cast<const void*>(dbias_kernel),
      reinterpret_cast<const void*>(fwd_kernel<true>),
      reinterpret_cast<const void*>(dq_kernel<true>),
      reinterpret_cast<const void*>(dkv_kernel<true>),
      reinterpret_cast<const void*>(dpose_partial_kernel)};
  if (kernel < 0 || kernel >= 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fns[kernel]);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[kernel],
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = blocks;
  info[4] = kCols;
  return 0;
}
