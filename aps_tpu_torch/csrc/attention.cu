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
// Layout: one block per (q-tile of kBQ rows, batch*head), kThreads threads.
// For each key tile of kBK rows the block stages K and V in shared memory
// (rows padded to D+1 floats so lanes that read neighbouring rows hit
// distinct banks), writes the kBQ x kBK score tile, and each warp runs the
// online softmax for kBQ/4 rows with the row state (max, sum, D/32
// accumulators per lane) held in registers. Key tiles past k_len (and past
// the tile's last row under causal) are skipped.
//
// What bounds it on the card: 4 Tq Tk D operations per head on the CUDA
// cores in float32 from shared memory against a few T D floats of traffic,
// so it is bound by float32 arithmetic and shared-memory bandwidth, not by
// device memory; tensor cores (wgmma) and larger tiles are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 16;
constexpr int kBK = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr float kLseDead = 1.0e30f;

template <int D>
__global__ void attn_fwd_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ bias,
                                const int* __restrict__ k_len, int H, int Tq,
                                int Tk, float scale, int causal,
                                float* __restrict__ out,
                                float* __restrict__ lse) {
  constexpr int DP = D + 1;
  constexpr int DPL = (D + 31) / 32;
  __shared__ float sq[kBQ][DP];
  __shared__ float sk[kBK][DP];
  __shared__ float sv[kBK][D];
  __shared__ float ss[kBQ][kBK + 1];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int l0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float* q_h = q + static_cast<size_t>(bh) * Tq * D;
  const float* k_h = k + static_cast<size_t>(bh) * Tk * D;
  const float* v_h = v + static_cast<size_t>(bh) * Tk * D;
  // the bias is indexed by the head alone: every batch entry reads the same
  const float* bias_h =
      bias == nullptr ? nullptr
                      : bias + static_cast<size_t>(bh % H) * Tq * Tk;
  const int klen = min(Tk, k_len[b]);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    sq[r][d] = (l0 + r < Tq) ? q_h[static_cast<size_t>(l0 + r) * D + d] : 0.f;
  }

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  int kend = klen;
  if (causal) kend = min(kend, l0 + kBQ);
  for (int s0 = 0; s0 < kend; s0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const bool ok = s0 + r < Tk;
      sk[r][d] = ok ? k_h[static_cast<size_t>(s0 + r) * D + d] : 0.f;
      sv[r][d] = ok ? v_h[static_cast<size_t>(s0 + r) * D + d] : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < kBQ * kBK; e += kThreads) {
      const int li = e / kBK;
      const int sj = e - li * kBK;
      float a = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) a = fmaf(sq[li][d], sk[sj][d], a);
      a *= scale;
      if (bias_h != nullptr && l0 + li < Tq && s0 + sj < Tk) {
        a += bias_h[static_cast<size_t>(l0 + li) * Tk + s0 + sj];
      }
      ss[li][sj] = a;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int li = warp * kRowsPerWarp + r;
      const int l = l0 + li;
      const int s = s0 + lane;
      const bool ok = l < Tq && s < klen && (!causal || s <= l);
      const float x = ok ? ss[li][lane] : -INFINITY;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m_i[r], mx);
      const float p = ok ? expf(x - m_new) : 0.f;
      const float alpha = (m_new == -INFINITY) ? 1.f : expf(m_i[r] - m_new);
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      }
      l_i[r] = l_i[r] * alpha + psum;
      m_i[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[r][i] = fmaf(pj, sv[j][d], acc[r][i]);
        }
      }
    }
  }

  float* out_h = out + static_cast<size_t>(bh) * Tq * D;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int l = l0 + warp * kRowsPerWarp + r;
    if (l >= Tq) continue;
    const float inv = l_i[r] > 0.f ? 1.f / l_i[r] : 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out_h[static_cast<size_t>(l) * D + d] = acc[r][i] * inv;
    }
    if (lse != nullptr && lane == 0) {
      lse[static_cast<size_t>(bh) * Tq + l] =
          l_i[r] > 0.f ? m_i[r] + logf(l_i[r]) : kLseDead;
    }
  }
}

template <int D>
void launch(const float* q, const float* k, const float* v,
            const float* bias, const int* k_len, int B, int H, int Tq, int Tk,
            float scale, int causal, float* out, float* lse,
            cudaStream_t stream) {
  dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  attn_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      q, k, v, bias, k_len, H, Tq, Tk, scale, causal, out, lse);
}

}  // namespace

extern "C" const char* aps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, out: B x H x Tq x D; k, v: B x H x Tk x D; bias: H x Tq x Tk or null;
// k_len: B int32; lse: B x H x Tq or null (inference). All float32 (k_len
// int32), contiguous, on the device. D in {16, 32, 64}.
extern "C" int aps_attention_fwd(const float* q, const float* k,
                                 const float* v, const float* bias,
                                 const int* k_len, int B, int H, int Tq,
                                 int Tk, int D, float scale, int causal,
                                 float* out, float* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Tq <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
    case 16:
      launch<16>(q, k, v, bias, k_len, B, H, Tq, Tk, scale, causal, out, lse,
                 s);
      break;
    case 32:
      launch<32>(q, k, v, bias, k_len, B, H, Tq, Tk, scale, causal, out, lse,
                 s);
      break;
    case 64:
      launch<64>(q, k, v, bias, k_len, B, H, Tq, Tk, scale, causal, out, lse,
                 s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
