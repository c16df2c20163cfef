// Fused log-(mel-)filterbank for Hopper (sm_90a), float32, by a fast
// Fourier transform in shared memory.
//
// Replaces aps_tpu/ops/pallas/fbank.py::fused_logmel (the TPU kernel
// _fbank_kernel). On the TPU the DFT is a dense product on the matrix unit.
// Here a dense DFT of W samples to F = n/2 + 1 bins (n = fft_size) costs 4 W
// F operations a frame, 20 to 50 times an FFT's, and its tables (2 W F
// floats) are read again by every block: the first port ran it on the CUDA
// cores at 1-3% of the bound. What bounds the function is device memory
// (the waveform in, the features out); per frame an FFT and the mel
// product are a few thousand operations.
//
// A block owns up to kMaxFrames consecutive frames of one utterance:
//
//   1. it stages the contiguous span of samples the frames cover, (frames
//      - 1) hop + W of them (the frames overlap W / hop times), the window
//      and the twiddle table in shared memory;
//   2. it applies the pre-emphasis of each frame (its first sample scaled
//      by 1 - p, the others x[i] - p x[i-1]) and the window in float32, as
//      the plain version does, zero-pads each frame to n samples and packs
//      it as n/2 complex points, z[m] = x[2m] + i x[2m + 1];
//   3. it runs the complex FFT of n/2 points as Stockham stages (autosort,
//      natural order in and out) between two buffers in shared memory, of
//      the radices the wrapper passes (ops/fbank.py::fft_plan: 4 while 4
//      divides what is left, then 3, then 5, and a final 2; 3 bits a stage,
//      the first in the low bits); each butterfly's inputs go to registers,
//      are multiplied by their twiddles, transformed and written to the
//      other buffer; one barrier a stage;
//   4. the split step: with Z the transform of z, bin k of the real frame
//      is E[k] + w^k O[k], E[k] = (Z[k] + conj Z[n/2 - k]) / 2, O[k] = (Z[k]
//      - conj Z[n/2 - k]) / 2i, w = exp(-2 pi i / n), for k = 0 .. n/2; the
//      power rounded to float32, or the magnitude from it;
//   5. the mel product over each filter's band of nonzero bins only
//      ([lo_m, hi_m), the same terms in the same order as the dense sum
//      minus exact zeros), or the identity; the floored log; the N x T x M
//      features are written. No frame and no spectrum reach device memory.
//
// Non-finite values keep the plain version's meaning. The log's floor
// keeps a NaN (torch.clamp_min), where fmaxf would return the floor. A
// frame with an inf or NaN sample has non-finite bins (each bin sums every
// sample); the dense mel product multiplies them by the zero coefficients
// outside each band, inf * 0 = NaN, so every band of such a frame is NaN:
// step 4 marks the frames with a non-finite bin and step 5 writes NaN for
// their bands. The identity (no mel matrix) keeps each bin's own value.
//
// Steps 3 and 4 run in float64. An FFT's rounding error is about the same
// in every bin, a few float32 ulps of the frame's level, where the dense
// DFT's error in a bin follows that bin's own partial sums. After
// pre-emphasis a band of the lowest bins can lie four orders of magnitude
// below the frame's level (log power -15.5 beside -6 on white noise), and
// there float32 stages put the log 1.6e-3 from the float64 value (the
// packing's split step cancels the aliased top bins there), beyond the
// tolerance of 1e-3 (PERF.md; the numpy emulation in
// tests/test_torch_fbank.py). float64 stages leave the float32 frame and
// mel product as the only roundings: within 4e-4. A copy with float32
// stages measured 1.7 times faster on the H100, and 1.4e-3 from the plain
// version at the long-form step's batch (PERF.md).
//
// The twiddle table holds exp(-2 pi i m / n) for m < n, made by the wrapper
// in float64: stage twiddles (of the n/2-point transform) are its even
// entries, the split step's its first n/2 + 1. n must be even, at most
// 4096, and the radices' product n/2 (the entry refuses other plans).

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFrames = 16;
constexpr int kMaxFft = 4096;
// frames a block: its two buffers of frames x n / 2 complex float64 points
// take at most 64 KB. At n = 512 that is 8 frames, 75776 bytes with the
// twiddles and the window: three blocks an SM. Measured at the flagship's
// shapes on the H100 (PERF.md): 16 frames (141 KB, one block an SM)
// 1.41-1.54 times slower; 4 frames (43 KB, five blocks) 5% faster at the
// decode's batch and 1-3% slower at the three others; 128 or 512 threads a
// block 7-22% slower. The stages wait on latency, which resident warps
// hide.
constexpr int kBufferBytes = 32768;
constexpr int kMaxSmemBytes = 232448;  // a block's limit on sm_90
// the static flags of step 4 (a frame with a non-finite bin) come out of
// that limit
constexpr int kMaxDynamicBytes = kMaxSmemBytes - 4 * kMaxFrames;

struct Args {
  const float* wav;  // N x S
  int S, T;
  const float* window;  // W
  int W, hop, n;        // n: fft_size
  const double2* twiddle;  // n entries exp(-2 pi i m / n)
  unsigned radices;        // the stages' radices, 3 bits each
  const float* mel_vals;  // the mel bands' coefficients, packed
  const int* mel_bands;   // M x 3: lo, hi, offset into mel_vals; or null
  int M;
  float pre_emphasis;
  int use_power;
  float mag_eps, log_lower_bound, log_eps;
  int frames;  // frames a block
  float* out;  // N x T x M
};

__host__ __device__ int frames_of(int n) {
  const int f = kBufferBytes / (8 * n);
  return f < 1 ? 1 : (f > kMaxFrames ? kMaxFrames : f);
}

// complex points of the second buffer, which first holds the staged
// samples (floats)
__host__ __device__ int buffer1_points(int frames, int n, int W, int hop) {
  const int span = (frames - 1) * hop + W;
  const int points = frames * (n / 2);
  return (span + 3) / 4 > points ? (span + 3) / 4 : points;
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

// -i z
__device__ __forceinline__ double2 mul_mi(double2 z) {
  return make_double2(z.y, -z.x);
}

// v <- its DFT of R points, y_k = sum_r v_r exp(-2 pi i r k / R)
template <int R>
__device__ __forceinline__ void butterfly(double2 (&v)[R]) {
  if constexpr (R == 2) {
    const double2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  } else if constexpr (R == 4) {
    const double2 a0 = cadd(v[0], v[2]);
    const double2 a1 = csub(v[0], v[2]);
    const double2 a2 = cadd(v[1], v[3]);
    const double2 a3 = mul_mi(csub(v[1], v[3]));
    v[0] = cadd(a0, a2);
    v[1] = cadd(a1, a3);
    v[2] = csub(a0, a2);
    v[3] = csub(a1, a3);
  } else if constexpr (R == 3) {
    constexpr double kS = 0.866025403784438647;  // sin(2 pi / 3)
    const double2 t = cadd(v[1], v[2]);
    const double2 d = csub(v[1], v[2]);
    const double2 m = make_double2(v[0].x - 0.5 * t.x, v[0].y - 0.5 * t.y);
    const double2 e = make_double2(kS * d.y, -kS * d.x);  // -i sin(2 pi/3) d
    v[0] = cadd(v[0], t);
    v[1] = cadd(m, e);
    v[2] = csub(m, e);
  } else {
    static_assert(R == 5, "radix 2, 3, 4 or 5");
    constexpr double kC1 = 0.309016994374947424;   // cos(2 pi / 5)
    constexpr double kC2 = -0.809016994374947424;  // cos(4 pi / 5)
    constexpr double kS1 = 0.951056516295153572;   // sin(2 pi / 5)
    constexpr double kS2 = 0.587785252292473129;   // sin(4 pi / 5)
    const double2 t1 = cadd(v[1], v[4]);
    const double2 t2 = cadd(v[2], v[3]);
    const double2 d1 = csub(v[1], v[4]);
    const double2 d2 = csub(v[2], v[3]);
    const double2 a1 = make_double2(v[0].x + kC1 * t1.x + kC2 * t2.x,
                                  v[0].y + kC1 * t1.y + kC2 * t2.y);
    const double2 a2 = make_double2(v[0].x + kC2 * t1.x + kC1 * t2.x,
                                  v[0].y + kC2 * t1.y + kC1 * t2.y);
    const double2 b1 = make_double2(kS1 * d1.x + kS2 * d2.x,
                                  kS1 * d1.y + kS2 * d2.y);
    const double2 b2 = make_double2(kS2 * d1.x - kS1 * d2.x,
                                  kS2 * d1.y - kS1 * d2.y);
    v[0] = make_double2(v[0].x + t1.x + t2.x, v[0].y + t1.y + t2.y);
    v[1] = cadd(a1, mul_mi(b1));  // a1 - i b1
    v[4] = csub(a1, mul_mi(b1));  // a1 + i b1
    v[2] = cadd(a2, mul_mi(b2));
    v[3] = csub(a2, mul_mi(b2));
  }
}

// One Stockham stage of radix R over nf frames of nh complex points each:
// Ns points of each sub-transform are done. Butterfly j of a frame reads
// points j + r nh / R, multiplies them by exp(-2 pi i k r / (Ns R)), k = j
// mod Ns (twiddle m = k r n / (Ns R) of the table), and writes its outputs
// to points (j - k) R + k + r Ns.
template <int R>
__device__ __forceinline__ void fft_stage(const double2* __restrict__ src,
                                          double2* __restrict__ dst, int nh,
                                          int Ns, int nf,
                                          const double2* __restrict__ tw,
                                          int n) {
  const int nb = nh / R;
  const int step = n / (Ns * R);
  for (int i = threadIdx.x; i < nf * nb; i += kThreads) {
    const int f = i / nb;
    const int j = i - f * nb;
    const double2* x = src + f * nh;
    double2* y = dst + f * nh;
    double2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = x[j + r * nb];
    const int k = j % Ns;
    if (k != 0) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[k * r * step]);
    }
    butterfly<R>(v);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) y[base + r * Ns] = v[r];
  }
}

__global__ void __launch_bounds__(kThreads) fbank_fft_kernel(Args a) {
  extern __shared__ __align__(16) double2 smem[];
  const int n = a.n;
  const int nh = n / 2;
  const int F = nh + 1;
  const int frames = a.frames;
  double2* buf0 = smem;
  double2* buf1 = buf0 + frames * nh;
  float* samples = reinterpret_cast<float*>(buf1);
  double2* tw = buf1 + buffer1_points(frames, n, a.W, a.hop);
  float* win = reinterpret_cast<float*>(tw + n);

  const int utt = blockIdx.y;
  const int t0 = blockIdx.x * frames;
  const int nf = min(frames, a.T - t0);
  const int tid = threadIdx.x;
  // frames of the block with a non-finite bin (step 4 sets them)
  __shared__ int bad[kMaxFrames];
  static_assert(sizeof(bad) == kMaxSmemBytes - kMaxDynamicBytes,
                "the static flags' bytes");
  if (tid < kMaxFrames) bad[tid] = 0;

  // 1. the frames' span of samples, the twiddles and the window
  const float* x = a.wav + static_cast<size_t>(utt) * a.S +
                   static_cast<size_t>(t0) * a.hop;
  const int span = (nf - 1) * a.hop + a.W;
  for (int i = tid; i < span; i += kThreads) samples[i] = x[i];
  for (int i = tid; i < n; i += kThreads) tw[i] = a.twiddle[i];
  for (int i = tid; i < a.W; i += kThreads) win[i] = a.window[i];
  __syncthreads();

  // 2. pre-emphasis within each frame, the window, zeros past W; packed as
  //    n/2 complex points a frame
  const float pre = a.pre_emphasis;
  auto sample = [&](int f, int j) {
    if (j >= a.W) return 0.f;
    const float* s = samples + f * a.hop + j;
    float v = s[0];
    if (pre > 0.f) v = (j == 0) ? v * (1.f - pre) : v - pre * s[-1];
    return v * win[j];
  };
  for (int i = tid; i < nf * nh; i += kThreads) {
    const int f = i / nh;
    const int m = i - f * nh;
    buf0[i] = make_double2(sample(f, 2 * m), sample(f, 2 * m + 1));
  }
  __syncthreads();

  // 3. the complex FFT of n/2 points, stage by stage between the buffers
  double2* src = buf0;
  double2* dst = buf1;
  int Ns = 1;
  for (unsigned plan = a.radices; plan != 0; plan >>= 3) {
    const int R = plan & 7;
    switch (R) {
      case 4: fft_stage<4>(src, dst, nh, Ns, nf, tw, n); break;
      case 3: fft_stage<3>(src, dst, nh, Ns, nf, tw, n); break;
      case 5: fft_stage<5>(src, dst, nh, Ns, nf, tw, n); break;
      default: fft_stage<2>(src, dst, nh, Ns, nf, tw, n); break;
    }
    __syncthreads();
    double2* done = dst;
    dst = src;
    src = done;
    Ns *= R;
  }

  // 4. the split step to the F bins of the real frame, power or magnitude
  float* spec = reinterpret_cast<float*>(dst);  // frames x F floats
  for (int i = tid; i < nf * F; i += kThreads) {
    const int f = i / F;
    const int k = i - f * F;
    const double2* Z = src + f * nh;
    const double2 zk = Z[k == nh ? 0 : k];
    const double2 zr = Z[k == 0 ? 0 : nh - k];
    const double2 zc = make_double2(zr.x, -zr.y);
    const double2 e = make_double2(0.5 * (zk.x + zc.x), 0.5 * (zk.y + zc.y));
    const double2 d = csub(zk, zc);
    const double2 o = make_double2(0.5 * d.y, -0.5 * d.x);  // d / 2i
    const double2 X = cadd(e, cmul(tw[k], o));
    const float p = static_cast<float>(X.x * X.x + X.y * X.y);
    const float v = a.use_power ? p : sqrtf(p + a.mag_eps);
    if (!isfinite(v)) bad[f] = 1;
    spec[i] = v;
  }
  __syncthreads();

  // 5. mel product over each filter's band (or the identity), floored log
  const int M = a.M;
  float* out = a.out + (static_cast<size_t>(utt) * a.T + t0) * M;
  for (int i = tid; i < nf * M; i += kThreads) {
    const int f = i / M;
    const int m = i - f * M;
    const float* sf = spec + f * F;
    float acc;
    if (a.mel_bands != nullptr) {
      const int lo = __ldg(a.mel_bands + 3 * m);
      const int hi = __ldg(a.mel_bands + 3 * m + 1);
      const float* coef = a.mel_vals + __ldg(a.mel_bands + 3 * m + 2) - lo;
      acc = 0.f;
      for (int k = lo; k < hi; ++k) acc = fmaf(sf[k], __ldg(coef + k), acc);
    } else {
      acc = sf[m];
    }
    if (a.mel_bands != nullptr && bad[f]) acc = NAN;
    // the floor as torch.clamp_min: a NaN stays NaN
    out[i] = (a.log_lower_bound > 0.f)
                 ? logf(a.log_lower_bound + acc)
                 : logf(acc > a.log_eps || acc != acc ? acc : a.log_eps);
  }
}

// the kernel may take more than 48 KB of dynamic shared memory. A function's
// attributes belong to a device: set once for each device, at its first
// launch there (setting them twice does no harm)
constexpr int kMaxDevices = 64;

cudaError_t attributes() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  rc = cudaFuncSetAttribute(fbank_fft_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kMaxDynamicBytes);
  if (rc == cudaSuccess && known) {
    done[dev].store(true, std::memory_order_release);
  }
  return rc;
}

// n even and at most kMaxFft, every radix 2, 3, 4 or 5, their product n/2
bool plan_ok(int n, unsigned radices) {
  if (n < 2 || n % 2 != 0 || n > kMaxFft) return false;
  int points = 1;
  for (; radices != 0 && points <= n / 2; radices >>= 3) {
    const int R = radices & 7;
    if (R < 2 || R > 5) return false;
    points *= R;
  }
  return radices == 0 && points == n / 2;
}

// bytes of dynamic shared memory a block of `frames` frames takes
size_t smem_bytes(int frames, int n, int W, int hop) {
  return sizeof(double2) * (frames * (n / 2) +
                            buffer1_points(frames, n, W, hop) + n) +
         sizeof(float) * W;
}

}  // namespace

extern "C" const char* aps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// wav N x S, window W, twiddle fft_size x 2 float64 (exp(-2 pi i m /
// fft_size) as cos, sin), radices: the FFT's stages, 3 bits each, the first
// in the low bits, mel_vals and mel_bands (M x 3 int32: lo, hi, offset of
// mel[lo, m] in mel_vals) or both null with M == fft_size / 2 + 1, out N x
// T x M; all float32 but twiddle and mel_bands, contiguous, on the device.
// fft_size even, at most 4096, the radices 2 to 5 with product fft_size /
// 2; W <= fft_size.
extern "C" int aps_fused_logmel(const float* wav, int N, int S, int T,
                                const float* window, int W, int hop,
                                int fft_size, const double* twiddle,
                                int radices, const float* mel_vals,
                                const int* mel_bands,
                                int M, float pre_emphasis, int use_power,
                                float mag_eps, float log_lower_bound,
                                float log_eps, float* out, void* stream) {
  if (!plan_ok(fft_size, static_cast<unsigned>(radices)) || W > fft_size ||
      W < 1 || hop < 1 || N < 1 || T < 1 || (T - 1) * hop + W > S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int frames = frames_of(fft_size);
  const size_t smem = smem_bytes(frames, fft_size, W, hop);
  if (smem > static_cast<size_t>(kMaxDynamicBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t rc = attributes();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const Args a{wav, S, T, window, W, hop, fft_size,
               reinterpret_cast<const double2*>(twiddle),
               static_cast<unsigned>(radices), mel_vals, mel_bands, M,
               pre_emphasis, use_power, mag_eps, log_lower_bound, log_eps,
               frames, out};
  dim3 grid((T + frames - 1) / frames, N);
  fbank_fft_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
