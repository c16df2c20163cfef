// Flash attention forward with relative-position scores, Hopper (sm_90a),
// float32.
//
// Replaces the forward of aps_tpu/ops/pallas/rel_attention.py::
// flash_attention_rel (the TPU kernel _fwd_kernel). Semantics:
//
//   score[b,h,l,s] = (q_c[b,h,l] . k[b,h,s] + q_p[b,h,l] . pose[hp, s-l+T-1])
//                    * scale,
//
// hp = 0 when the table is shared (Hp == 1) else h, keys s >= k_len[b]
// masked (suffix padding), optional causal mask, and rows with no valid key
// give 0. When `lse` is not null the kernel also writes the row-wise
// log-sum-exp of the masked scores (max + log(sum)), B x H x T, which the
// backward kernels (rel_attention_bwd.cu) read; rows with no valid key get
// kLseDead, a large positive value, so that exp(score - lse) is 0 there.
// The TPU kernel realigns a (b, 2b) band product with log2(b) lane
// rotates because Mosaic has no per-row dynamic shift; here the relative
// term is a per-row index offset into a band of the pose table staged in
// shared memory, so no shift is needed.
//
// Layout: one block per (q-tile of kBQ rows, batch*head), kThreads threads.
// For each key tile of kBK rows the block stages K, V and the kBQ+kBK-1 pose
// rows the tile needs in shared memory (rows padded to D+1 floats so lanes
// that read neighbouring rows hit distinct banks), writes the kBQ x kBK
// score tile, and each warp runs the online softmax for kBQ/4 rows with the
// row state (max, sum, D/32 accumulators per lane) held in registers.
// Key tiles past k_len (and past the last row under causal) are skipped.
//
// What bounds it on the card: at the encoder's shapes (T ~ 200, D = 64)
// the work is ~6 T^2 D flops per head on the CUDA cores, so it is
// latency- and occupancy-bound, not bandwidth-bound; tensor cores (wgmma)
// and larger tiles are later work.

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
__global__ void rel_attn_fwd_kernel(const float* __restrict__ q_c,
                                    const float* __restrict__ q_p,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    const float* __restrict__ pose,
                                    const int* __restrict__ k_len, int H,
                                    int Hp, int T, float scale, int causal,
                                    float* __restrict__ out,
                                    float* __restrict__ lse) {
  constexpr int DP = D + 1;
  constexpr int DPL = (D + 31) / 32;
  __shared__ float sqc[kBQ][DP];
  __shared__ float sqp[kBQ][DP];
  __shared__ float sk[kBK][DP];
  __shared__ float sv[kBK][D];
  __shared__ float sband[kBQ + kBK - 1][DP];
  __shared__ float ss[kBQ][kBK + 1];

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

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const bool ok = l0 + r < T;
    sqc[r][d] = ok ? q_c[head + static_cast<size_t>(l0 + r) * D + d] : 0.f;
    sqp[r][d] = ok ? q_p[head + static_cast<size_t>(l0 + r) * D + d] : 0.f;
  }

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  int kend = min(T, klen);
  if (causal) kend = min(kend, l0 + kBQ);
  for (int s0 = 0; s0 < kend; s0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const bool ok = s0 + r < T;
      sk[r][d] = ok ? k[head + static_cast<size_t>(s0 + r) * D + d] : 0.f;
      sv[r][d] = ok ? v[head + static_cast<size_t>(s0 + r) * D + d] : 0.f;
    }
    // band row r holds pose[base + r]: entry (li, sj) reads row
    // sj - li + kBQ - 1, i.e. offset (s0 + sj) - (l0 + li) + T - 1
    const int base = s0 - l0 - kBQ + T;
    for (int i = tid; i < (kBQ + kBK - 1) * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const int p = base + r;
      sband[r][d] = (p >= 0 && p < 2 * T - 1)
                        ? pose_h[static_cast<size_t>(p) * D + d]
                        : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < kBQ * kBK; e += kThreads) {
      const int li = e / kBK;
      const int sj = e - li * kBK;
      const float* band = sband[sj - li + kBQ - 1];
      float a = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        a = fmaf(sqc[li][d], sk[sj][d], a);
        a = fmaf(sqp[li][d], band[d], a);
      }
      ss[li][sj] = a * scale;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int li = warp * kRowsPerWarp + r;
      const int l = l0 + li;
      const int s = s0 + lane;
      const bool ok = l < T && s < T && s < klen && (!causal || s <= l);
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

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int l = l0 + warp * kRowsPerWarp + r;
    if (l >= T) continue;
    const float inv = l_i[r] > 0.f ? 1.f / l_i[r] : 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[head + static_cast<size_t>(l) * D + d] = acc[r][i] * inv;
    }
    if (lse != nullptr && lane == 0) {
      lse[static_cast<size_t>(bh) * T + l] =
          l_i[r] > 0.f ? m_i[r] + logf(l_i[r]) : kLseDead;
    }
  }
}

template <int D>
void launch(const float* q_c, const float* q_p, const float* k,
            const float* v, const float* pose, const int* k_len, int B,
            int H, int Hp, int T, float scale, int causal, float* out,
            float* lse, cudaStream_t stream) {
  dim3 grid((T + kBQ - 1) / kBQ, B * H);
  rel_attn_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      q_c, q_p, k, v, pose, k_len, H, Hp, T, scale, causal, out, lse);
}

}  // namespace

extern "C" const char* aps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q_c, q_p, k, v, out: B x H x T x D; pose: Hp x (2T-1) x D; k_len: B int32;
// lse: B x H x T or null (inference). All float32 (k_len int32), contiguous,
// on the device. D in {16, 32, 64}.
extern "C" int aps_rel_attention_fwd(const float* q_c, const float* q_p,
                                     const float* k, const float* v,
                                     const float* pose, const int* k_len,
                                     int B, int H, int Hp, int T, int D,
                                     float scale, int causal, float* out,
                                     float* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      launch<16>(q_c, q_p, k, v, pose, k_len, B, H, Hp, T, scale, causal,
                 out, lse, s);
      break;
    case 32:
      launch<32>(q_c, q_p, k, v, pose, k_len, B, H, Hp, T, scale, causal,
                 out, lse, s);
      break;
    case 64:
      launch<64>(q_c, q_p, k, v, pose, k_len, B, H, Hp, T, scale, causal,
                 out, lse, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
