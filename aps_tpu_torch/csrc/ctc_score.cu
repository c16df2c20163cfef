// One CTC prefix-scorer step over flat candidate lanes, Hopper (sm_90a),
// float32.
//
// Replaces aps_tpu/ops/pallas/ctc_score.py::ctc_score_step (the TPU kernel
// _ctc_score_kernel). For each lane l (one candidate extension of one beam)
// and t = 0..T-1:
//
//   a_0 = is_first ? p_c[0] : MIN_F32
//   a_t = logaddexp(gamma_bx[t-1], repeat_ok ? gamma_nx[t-1] : MIN_F32)
//         + p_c[t]
//   gamma_n[t] = max(logaddexp(gamma_n[t-1] + p_c[t], a_t), MIN_F32)
//   gamma_b[t] = max(logaddexp(gamma_b[t-1] + p_blank[t],
//                              gamma_n[t-1] + p_blank[t]), MIN_F32)
//   score = eos ? logaddexp(gamma_bx[T-1], gamma_nx[T-1])
//               : max(logsumexp_t a_t, MIN_F32)
//   delta = score - old_score
//
// with gamma_n[0] = max(a_0, MIN_F32) and gamma_b[0] = MIN_F32. The MIN_F32
// clamps keep impossible states finite, as the TPU kernel's _blocked_rec
// does. The TPU kernel solves the recursions in closed form over 32-frame
// blocks with Hillis-Steele scans because a T-step sequential loop is
// latency-bound on its vector unit; here one thread walks its lane through
// T exactly, and the lanes fill the card. The TPU's lane blocking and VMEM
// budget gate have no counterpart: any T is taken.
//
// p_blank is T x G with G dividing L: lane l reads column l / (L / G), so
// one blank column per utterance (G = N) or one shared column (G = 1) is
// broadcast inside the kernel rather than materialised to T x L.
//
// What bounds it on the card: 4 T L floats read and 2 T L written, each
// once and coalesced across lanes; at L ~ 6k lanes the T-step dependent
// chain per thread (two logaddexp per step) makes it latency-bound.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kMinF32 = -3.402823466e38f;
constexpr int kThreads = 64;

__device__ __forceinline__ float log_add(float a, float b) {
  const float m = fmaxf(a, b);
  if (m == -INFINITY) return m;
  return m + log1pf(expf(-fabsf(a - b)));
}

__global__ void ctc_score_kernel(const float* __restrict__ p_c,
                                 const float* __restrict__ gamma_nx,
                                 const float* __restrict__ gamma_bx,
                                 const float* __restrict__ p_blank, int G,
                                 const float* __restrict__ repeat_ok,
                                 const float* __restrict__ eos_mask,
                                 const float* __restrict__ old_score,
                                 const float* __restrict__ is_first, int T,
                                 int L, float* __restrict__ gamma_n,
                                 float* __restrict__ gamma_b,
                                 float* __restrict__ score,
                                 float* __restrict__ delta) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int g = l / (L / G);
  const bool rep_ok = repeat_ok[l] > 0.f;
  float x_prev = kMinF32;  // gamma_n[t-1]
  float y_prev = kMinF32;  // gamma_b[t-1]
  float m = -INFINITY;     // running max of a_t
  float sum = 0.f;         // running sum of exp(a_t - m)
  for (int t = 0; t < T; ++t) {
    const size_t o = static_cast<size_t>(t) * L + l;
    const float pc = p_c[o];
    float a, x, y;
    if (t == 0) {
      a = is_first[0] > 0.f ? pc : kMinF32;
      x = fmaxf(a, kMinF32);
      y = kMinF32;
    } else {
      const float pb = p_blank[static_cast<size_t>(t) * G + g];
      const float phi =
          log_add(gamma_bx[o - L], rep_ok ? gamma_nx[o - L] : kMinF32);
      a = phi + pc;
      x = fmaxf(log_add(x_prev + pc, a), kMinF32);
      y = fmaxf(log_add(y_prev + pb, x_prev + pb), kMinF32);
    }
    gamma_n[o] = x;
    gamma_b[o] = y;
    if (a > m) {
      sum = sum * expf(m - a) + 1.f;
      m = a;
    } else {
      sum += expf(a - m);
    }
    x_prev = x;
    y_prev = y;
  }
  float sc = fmaxf(m + logf(sum), kMinF32);
  if (eos_mask[l] > 0.f) {
    const size_t last = static_cast<size_t>(T - 1) * L + l;
    sc = log_add(gamma_bx[last], gamma_nx[last]);
  }
  score[l] = sc;
  delta[l] = sc - old_score[l];
}

}  // namespace

extern "C" const char* aps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// p_c, gamma_nx, gamma_bx, gamma_n, gamma_b: T x L; p_blank: T x G;
// repeat_ok, eos_mask, old_score, score, delta: 1 x L; is_first: 1 x 1.
// All float32, contiguous, on the device.
extern "C" int aps_ctc_score_step(const float* p_c, const float* gamma_nx,
                                  const float* gamma_bx, const float* p_blank,
                                  int G, const float* repeat_ok,
                                  const float* eos_mask,
                                  const float* old_score,
                                  const float* is_first, int T, int L,
                                  float* gamma_n, float* gamma_b, float* score,
                                  float* delta, void* stream) {
  const int blocks = (L + kThreads - 1) / kThreads;
  ctc_score_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p_c, gamma_nx, gamma_bx, p_blank, G, repeat_ok, eos_mask, old_score,
      is_first, T, L, gamma_n, gamma_b, score, delta);
  return static_cast<int>(cudaGetLastError());
}
