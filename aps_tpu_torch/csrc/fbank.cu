// Fused log-(mel-)filterbank for Hopper (sm_90a), float32.
//
// Replaces aps_tpu/ops/pallas/fbank.py::fused_logmel (the TPU kernel
// _fbank_kernel). One block owns kFrames consecutive frames of one
// utterance: it stages the frames' samples in shared memory with the
// pre-emphasis head-sample rule and the window applied, accumulates the
// real DFT against cos/sin tables (W x F, built once per configuration by
// the wrapper and read from global memory / L2), forms power or magnitude,
// projects onto the mel filterbank (F x M) and writes only the N x T x M
// floored-log features. The frame matrix never reaches device memory.
//
// What bounds it on the card: the DFT is 4*W*F flops per frame on the
// CUDA cores (no tensor cores in this first version) and each block
// re-reads the 2*W*F table floats from L2; kFrames = 16 frames per block
// amortise each table read over 16 frames. Wgmma/TF32 for the two DFT
// products is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFrames = 16;

__global__ void fbank_kernel(const float* __restrict__ wav, int S, int T,
                             const float* __restrict__ window, int W, int hop,
                             const float* __restrict__ dft_cos,
                             const float* __restrict__ dft_sin, int F,
                             const float* __restrict__ mel, int M,
                             float pre_emphasis, int use_power, float mag_eps,
                             float log_lower_bound, float log_eps,
                             float* __restrict__ out) {
  extern __shared__ float smem[];
  float* frames = smem;                // kFrames x W
  float* spec = smem + kFrames * W;    // kFrames x F
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, T - t0);
  const float* x = wav + static_cast<size_t>(n) * S;

  // 1) frames: pre-emphasis inside each frame (its first sample is scaled
  //    by 1 - p, the others take x[i] - p x[i-1]), then the window
  for (int i = threadIdx.x; i < kFrames * W; i += blockDim.x) {
    const int f = i / W;
    const int j = i - f * W;
    float v = 0.f;
    if (f < nf) {
      const int s = (t0 + f) * hop + j;
      v = x[s];
      if (pre_emphasis > 0.f) {
        v = (j == 0) ? v * (1.f - pre_emphasis) : v - pre_emphasis * x[s - 1];
      }
      v *= window[j];
    }
    frames[i] = v;
  }
  __syncthreads();

  // 2) one-sided real DFT: a thread per bin, kFrames accumulators each
  for (int k = threadIdx.x; k < F; k += blockDim.x) {
    float re[kFrames], im[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    for (int j = 0; j < W; ++j) {
      const float c = __ldg(dft_cos + static_cast<size_t>(j) * F + k);
      const float s = __ldg(dft_sin + static_cast<size_t>(j) * F + k);
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        const float v = frames[f * W + j];
        re[f] = fmaf(v, c, re[f]);
        im[f] = fmaf(v, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const float p = re[f] * re[f] + im[f] * im[f];
      spec[f * F + k] = use_power ? p : sqrtf(p + mag_eps);
    }
  }
  __syncthreads();

  // 3) mel projection (identity when mel is null) and the floored log
  for (int i = threadIdx.x; i < nf * M; i += blockDim.x) {
    const int f = i / M;
    const int m = i - f * M;
    float acc;
    if (mel != nullptr) {
      acc = 0.f;
      const float* col = mel + m;
      for (int k = 0; k < F; ++k) {
        acc = fmaf(spec[f * F + k], __ldg(col + static_cast<size_t>(k) * M),
                   acc);
      }
    } else {
      acc = spec[f * F + m];
    }
    acc = (log_lower_bound > 0.f) ? logf(log_lower_bound + acc)
                                  : logf(fmaxf(acc, log_eps));
    out[(static_cast<size_t>(n) * T + t0 + f) * M + m] = acc;
  }
}

}  // namespace

extern "C" const char* aps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// wav N x S, window W, dft_cos/dft_sin W x F, mel F x M (or null with
// M == F), out N x T x M; all float32, contiguous, on the device.
extern "C" int aps_fused_logmel(const float* wav, int N, int S, int T,
                                const float* window, int W, int hop,
                                const float* dft_cos, const float* dft_sin,
                                int F, const float* mel, int M,
                                float pre_emphasis, int use_power,
                                float mag_eps, float log_lower_bound,
                                float log_eps, float* out, void* stream) {
  const size_t smem = sizeof(float) * kFrames * (W + F);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = min(1024, ((F + 31) / 32) * 32);
  dim3 grid((T + kFrames - 1) / kFrames, N);
  fbank_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      wav, S, T, window, W, hop, dft_cos, dft_sin, F, mel, M, pre_emphasis,
      use_power, mag_eps, log_lower_bound, log_eps, out);
  return static_cast<int>(cudaGetLastError());
}
