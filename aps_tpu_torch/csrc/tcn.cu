// One eval-mode Conv-TasNet TCN block with folded weights, Hopper (sm_90a),
// float32 or bfloat16 activations and kernels, float32 accumulation.
//
// Replaces aps_tpu/ops/pallas/tcn.py::tcn_block_fused (the TPU kernel
// _tcn_block_kernel). For x: N x T x B, kernel1: B x H, pack: 11 x H rows
// [c1, g1, h1, w0, w1, w2, cb, g2, h2, a1, a2], kernel2: H x B, bias2: B and a
// dilation d with (pad_l, pad_r) = (d, d), or (2d, 0) when causal:
//
//   y[t]  = prelu(x[t] . kernel1 + c1, a1) * g1 + h1   for 0 <= t < T, else 0
//   y2[t] = prelu(w0 y[t - pad_l] + w1 y[t - pad_l + d] + w2 y[t - pad_l + 2d]
//                 + cb, a2) * g2 + h2
//   out[t] = round(y2[t]) . kernel2 + bias2 + x[t]
//
// where round() takes y2 to the kernels' type before the second product, the
// residual is added in float32 and out has x's type. Rows of y outside [0, T)
// are zero: the padding is applied to the intermediate, after PReLU and the
// affine. Both products run inside this kernel, on the CUDA cores.
//
// The TPU kernel keeps a whole T x B row in its fast memory and sweeps it in
// slabs, with a budget gate and a fall-back for long inputs. Here one block
// owns 32 output rows of one batch row, at any T:
//
//   1. It stages the rows of x that its outputs need in shared memory. The
//      three taps need y at rows t - pad_l, t - pad_l + d, t - pad_l + 2d. For
//      d <= 32 these are taken as one contiguous run of 32 + 2d rows; for
//      larger d as three separate runs of 32 rows, which caps the first
//      product at 3x its least size at every dilation (a contiguous halo at
//      d = 128 would cost 9x).
//   2. It walks H in passes of 128 channels. In a pass each thread forms
//      two channels of y for up to 24 staged rows (kernel1 streamed from L2,
//      x broadcast from shared memory, eight multiply-adds per shared load),
//      the stencil and second activation give a 32 x 128 tile of y2 in shared
//      memory, and each thread adds that tile's share to 16 rows of its two
//      (at B > 256: four) output columns, kept in registers (kernel2 streamed
//      from L2, y2 broadcast from shared memory).
//   3. It adds bias2 and the residual from the staged x and writes its rows.
//
// What bounds it on the card: operations. At B = 256, H = 512 the two
// products are 2 * 2 * B * H operations per frame against 2 * B * itemsize
// bytes, far above the card's float32 balance; without tensor cores and with
// the first product done 1.25x (40 staged rows, d <= 4), 2x (64 rows,
// d <= 16) or 3x (96 rows) over, it stays well under that bound (PERF.md has
// the times). Tensor-core tiles (wgmma) and TMA staging are the later rewrite.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTM = 32;  // output rows per block
constexpr int kThreads = 256;
// first product: 64 channel lanes x 4 row groups, 2 channels per thread
constexpr int kLanes = 64;
constexpr int kCPT = 2;
constexpr int kHC = kLanes * kCPT;  // hidden channels per pass
constexpr int kRowGroups = kThreads / kLanes;
// second product: 128 column lanes x 2 slices of the block's rows
constexpr int kColLanes = 128;
constexpr int kSlice = kTM / (kThreads / kColLanes);  // rows per thread
constexpr int kMaxShared = 232448;  // bytes a block may use on sm_90

// pack rows
enum PackRow {
  kC1, kG1, kH1, kW0, kW1, kW2, kCb, kG2, kH2, kA1, kA2
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four consecutive elements as float32 (16 or 8 aligned bytes)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float prelu(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// RPT: staged rows per thread in the first product (4 * RPT rows staged);
// NC: output columns per thread in the second (NC * 128 >= B). The instances
// of 40 and 64 staged rows keep to 128 registers, so that two blocks fit an
// SM, which runs them faster than one block with more registers; at 96 rows
// the shared memory allows one block, which takes the registers it wants.
// R staged rows are in use; staged row r holds time
//   lo - pad_l + r                       (contiguous)
//   lo - pad_l + (r / 32) * d + r % 32   (three runs)
// and tap j of output row i is staged row i + j * off (off = d or 32).
template <typename T, int RPT, int NC>
__global__ void __launch_bounds__(kThreads, RPT <= 16 ? 2 : 1)
    tcn_block_kernel(const T* __restrict__ x, const T* __restrict__ k1,
                     const float* __restrict__ pack,
                     const T* __restrict__ k2,
                     const float* __restrict__ bias2, T* __restrict__ out,
                     int Tlen, int B, int H, int d, int pad_l, int R, int off,
                     int contiguous, int center, int tiles) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RA = RPT * kRowGroups;
  float* xs = smem;            // RA x B
  float* ys = xs + RA * B;     // RA x kHC
  float* y2s = ys + RA * kHC;  // kTM x kHC

  const int tid = threadIdx.x;
  const int n = blockIdx.x / tiles;
  const int lo = (blockIdx.x % tiles) * kTM;
  const T* xn = x + static_cast<size_t>(n) * Tlen * B;
  const int t0 = lo - pad_l;

  const int B4 = B / 4;
  for (int idx = tid; idx < RA * B4; idx += kThreads) {
    const int r = idx / B4;
    const int c4 = idx - r * B4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < R) {
      const int t = contiguous ? t0 + r : t0 + (r / kTM) * d + (r % kTM);
      if (t >= 0 && t < Tlen) {
        v = load4(xn + static_cast<size_t>(t) * B + 4 * c4);
      }
    }
    reinterpret_cast<float4*>(xs)[idx] = v;
  }
  __syncthreads();

  // first product and activations: channel lane hc (channels h0 + hc and
  // h0 + hc + 64 of a pass) x row group rg (staged rows rg, rg + 4, ...)
  const int hc = tid % kLanes;
  const int rg = tid / kLanes;
  // second product: column lane ct (columns ct, ct + 128, ...) x row slice rh
  const int ct = tid % kColLanes;
  const int rh = tid / kColLanes;
  float o[NC][kSlice];
#pragma unroll
  for (int jc = 0; jc < NC; ++jc) {
#pragma unroll
    for (int i = 0; i < kSlice; ++i) o[jc][i] = 0.f;
  }

  for (int h0 = 0; h0 < H; h0 += kHC) {
    bool hok[kCPT];
#pragma unroll
    for (int c = 0; c < kCPT; ++c) hok[c] = h0 + hc + c * kLanes < H;

    float acc[kCPT][RPT];
#pragma unroll
    for (int c = 0; c < kCPT; ++c) {
#pragma unroll
      for (int j = 0; j < RPT; ++j) acc[c][j] = 0.f;
    }
    if (hok[0]) {
      const T* kcol = k1 + h0 + hc;
      for (int k = 0; k < B; k += 4) {
        float w[kCPT][4];
#pragma unroll
        for (int c = 0; c < kCPT; ++c) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            w[c][q] = hok[c] ? to_f32(kcol[static_cast<size_t>(k + q) * H +
                                           c * kLanes])
                             : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(
              xs + (rg + kRowGroups * j) * B + k);
#pragma unroll
          for (int c = 0; c < kCPT; ++c) {
            acc[c][j] = fmaf(xv.x, w[c][0], acc[c][j]);
            acc[c][j] = fmaf(xv.y, w[c][1], acc[c][j]);
            acc[c][j] = fmaf(xv.z, w[c][2], acc[c][j]);
            acc[c][j] = fmaf(xv.w, w[c][3], acc[c][j]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCPT; ++c) {
      const int h = h0 + hc + c * kLanes;
      float c1 = 0.f, g1 = 0.f, h1 = 0.f, a1 = 0.f;
      if (hok[c]) {
        c1 = pack[kC1 * H + h];
        g1 = pack[kG1 * H + h];
        h1 = pack[kH1 * H + h];
        a1 = pack[kA1 * H + h];
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = rg + kRowGroups * j;
        const int t = contiguous ? t0 + r : t0 + (r / kTM) * d + (r % kTM);
        float y = 0.f;
        if (hok[c] && r < R && t >= 0 && t < Tlen) {
          y = prelu(acc[c][j] + c1, a1) * g1 + h1;
        }
        ys[r * kHC + hc + c * kLanes] = y;
      }
    }
    __syncthreads();

    // stencil and second activation: a kTM x kHC tile of y2
#pragma unroll
    for (int c = 0; c < kCPT; ++c) {
      const int col = hc + c * kLanes;
      const int h = h0 + col;
      float w0 = 0.f, w1 = 0.f, w2 = 0.f, cb = 0.f, g2 = 0.f, h2 = 0.f,
            a2 = 0.f;
      if (hok[c]) {
        w0 = pack[kW0 * H + h];
        w1 = pack[kW1 * H + h];
        w2 = pack[kW2 * H + h];
        cb = pack[kCb * H + h];
        g2 = pack[kG2 * H + h];
        h2 = pack[kH2 * H + h];
        a2 = pack[kA2 * H + h];
      }
      for (int i = rg; i < kTM; i += kRowGroups) {
        float v = 0.f;
        if (hok[c]) {
          v = w0 * ys[i * kHC + col] + w1 * ys[(i + off) * kHC + col] +
              w2 * ys[(i + 2 * off) * kHC + col] + cb;
          v = prelu(v, a2) * g2 + h2;
          v = to_f32(from_f32<T>(v));
        }
        y2s[i * kHC + col] = v;
      }
    }
    __syncthreads();

    // second product: this pass's share of the thread's kSlice rows of its
    // output columns
    const int hcnt = min(kHC, H - h0);
    for (int hh = 0; hh < hcnt; hh += 4) {
      float w[NC][4];
#pragma unroll
      for (int jc = 0; jc < NC; ++jc) {
        const int c = ct + jc * kColLanes;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          w[jc][q] = c < B ? to_f32(k2[static_cast<size_t>(h0 + hh + q) * B +
                                       c])
                           : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kSlice; ++i) {
        const float4 yv = *reinterpret_cast<const float4*>(
            y2s + (rh * kSlice + i) * kHC + hh);
#pragma unroll
        for (int jc = 0; jc < NC; ++jc) {
          o[jc][i] = fmaf(yv.x, w[jc][0], o[jc][i]);
          o[jc][i] = fmaf(yv.y, w[jc][1], o[jc][i]);
          o[jc][i] = fmaf(yv.z, w[jc][2], o[jc][i]);
          o[jc][i] = fmaf(yv.w, w[jc][3], o[jc][i]);
        }
      }
    }
    // the next pass writes ys only after its own first product and y2s only
    // after the barrier that follows; every thread has left this pass's
    // reads of both by then
  }

  T* outn = out + static_cast<size_t>(n) * Tlen * B;
#pragma unroll
  for (int jc = 0; jc < NC; ++jc) {
    const int c = ct + jc * kColLanes;
    if (c >= B) continue;
    const float b2 = bias2[c];
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      const int row = rh * kSlice + i;
      const int t = lo + row;
      if (t < Tlen) {
        const float v = o[jc][i] + b2 + xs[(row + center) * B + c];
        outn[static_cast<size_t>(t) * B + c] = from_f32<T>(v);
      }
    }
  }
}

template <typename T, int RPT, int NC>
cudaError_t launch(const T* x, const T* k1, const float* pack, const T* k2,
                   const float* bias2, T* out, int N, int Tlen, int B, int H,
                   int d, int causal, int R, int contiguous,
                   cudaStream_t stream) {
  constexpr int RA = RPT * kRowGroups;
  const size_t shared =
      sizeof(float) * (static_cast<size_t>(RA) * B + RA * kHC + kTM * kHC);
  if (shared > kMaxShared) return cudaErrorInvalidValue;
  auto kernel = tcn_block_kernel<T, RPT, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const int tiles = (Tlen + kTM - 1) / kTM;
  const int off = contiguous ? d : kTM;
  const int pad_l = causal ? 2 * d : d;
  const int center = (causal ? 2 : 1) * off;
  kernel<<<static_cast<unsigned>(N) * tiles, kThreads, shared, stream>>>(
      x, k1, pack, k2, bias2, out, Tlen, B, H, d, pad_l, R, off, contiguous,
      center, tiles);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t dispatch_rows(const T* x, const T* k1, const float* pack,
                          const T* k2, const float* bias2, T* out, int N,
                          int Tlen, int B, int H, int d, int causal,
                          cudaStream_t stream) {
  // a contiguous run of 32 + 2d staged rows, or three runs of 32
  const int contiguous = d <= kTM;
  const int R = contiguous ? kTM + 2 * d : 3 * kTM;
#define APS_TCN_ROWS(RPT)                                                  \
  if (R <= RPT * kRowGroups)                                               \
    return launch<T, RPT, NC>(x, k1, pack, k2, bias2, out, N, Tlen, B, H, d, \
                              causal, R, contiguous, stream);
  // 40, 64 or 96 staged rows (an instance of 48 is not worth its build time)
  APS_TCN_ROWS(10)
  APS_TCN_ROWS(16)
  APS_TCN_ROWS(24)
#undef APS_TCN_ROWS
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* k1, const float* pack,
                     const void* k2, const float* bias2, void* out, int N,
                     int Tlen, int B, int H, int d, int causal,
                     cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* k1t = static_cast<const T*>(k1);
  const T* k2t = static_cast<const T*>(k2);
  T* outt = static_cast<T*>(out);
  if (B <= 2 * kColLanes) {
    return dispatch_rows<T, 2>(xt, k1t, pack, k2t, bias2, outt, N, Tlen, B, H,
                               d, causal, stream);
  }
  return dispatch_rows<T, 4>(xt, k1t, pack, k2t, bias2, outt, N, Tlen, B, H,
                             d, causal, stream);
}

}  // namespace

extern "C" const char* aps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, out: N x T x B; kernel1: B x H; kernel2: H x B (float32, or bfloat16 when
// is_bf16); pack: 11 x H and bias2: B, float32. All contiguous, on the device.
// B and H multiples of 4, B <= 512, dilation >= 1.
extern "C" int aps_tcn_block_fused(const void* x, const void* kernel1,
                                   const float* pack, const void* kernel2,
                                   const float* bias2, void* out, int N, int T,
                                   int B, int H, int dilation, int causal,
                                   int is_bf16, void* stream) {
  if (N <= 0 || T <= 0) return 0;
  if (B % 4 != 0 || H % 4 != 0 || B > 4 * kColLanes || dilation < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(x, kernel1, pack, kernel2, bias2, out,
                                        N, T, B, H, dilation, causal, s)
              : dispatch<float>(x, kernel1, pack, kernel2, bias2, out, N, T, B,
                                H, dilation, causal, s);
  return static_cast<int>(err);
}
