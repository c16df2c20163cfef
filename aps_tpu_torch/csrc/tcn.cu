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
// affine.
//
// The TPU kernel keeps a whole T x B row in its fast memory and sweeps it in
// slabs, with a budget gate and a fall-back for long inputs. Here a block
// owns 64 output rows of one batch row and 256 output columns, at any T.
//
// What bounds it on the card: operations. At B = 256, H = 512 the two 1x1
// products are 2 * 2 * B * H operations a frame against 2 * B * itemsize
// bytes, far above the card's balance, so they belong on the tensor cores.
// The first port ran both on the CUDA cores, streamed kernel1 and kernel2
// from L2 into every thread and did the first product 1.25x to 3x over for
// the taps. This design:
//
//   - Both products run on the tensor cores (mma.sync). bfloat16: m16n8k16
//     on bf16 operands with float32 accumulators, exact in the products.
//     float32: m16n8k8 as three TF32 products of split operands
//     (attn_tiles.cuh), float32's accuracy at a third of the TF32 rate.
//   - The operands reach shared memory by cp.async (16-byte pieces; 8 for
//     bfloat16 widths that are no multiple of 8) in k-slices 256 bytes deep
//     (64 float32 or 128 bfloat16 channels) through a ring of two stages:
//     for the first product a slice of input channels of the staged rows of
//     x and of kernel1's 128 hidden channels of the pass, for the second a
//     slice of hidden channels of kernel2 across the block's 256 columns;
//     one barrier a slice, the next slice in flight while this one is
//     multiplied. The pass's 11 pack rows land beside them.
//   - H is walked in passes of 128 hidden channels. The first product's
//     accumulators take c1, PReLU and the affine (zero outside [0, T)) into
//     a float32 tile y; the stencil and the second activation give the tile
//     y2 (rounded to the kernels' type), which is the A operand of the
//     second product. The 64 x 256 output tile stays in the registers of
//     the block's sixteen warps over all passes; y and y2 never leave the
//     SM. One block an SM (at most 128 registers a thread, 204-220 KB).
//   - The staged rows. Below d = 16 the block's 64 rows are contiguous and
//     need 64 + 2d rows of y (80 or 96 staged: the first product's repeat is
//     1.25x up to d = 8). From d = 16 on the block owns a chain of four
//     16-row tiles one dilation apart (t0 + j d + i, j < 4, i < 16), whose
//     taps fall on six 16-row runs t0 - pad_l + u d + i (u < 6): each staged
//     run feeds up to three output tiles and the repeat is 6/4 = 1.5x at
//     every dilation (the first port's three separate runs gave 3x).
//     Blocks tile [0, T) in periods of 4d: d / 16 chains a period, rows of a
//     16-row tile past the dilation belong to the next chain and are not
//     written (dilations that are no multiple of 16 waste those rows).
//   - Ragged edges (T, B, H) by bounds and zero fill. No atomics: two
//     launches give the same bits.
//
// What still bounds it (PERF.md): not the tensor cores' rate. With one
// block an SM its phases (copies, the two products, the activations and the
// stencil) follow each other between barriers: leaving out any one of them
// saves 6% to 42% of the time, and with no copies issued at all the kernel
// still takes more than three quarters of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

#include "attn_tiles.cuh"

namespace {

constexpr int kThreads = 512;  // sixteen warps
constexpr int kOutRows = 64;   // output rows of a block: four 16-row tiles
constexpr int kCols = 256;     // output columns of a block
constexpr int kHC = 128;       // hidden channels of a pass
constexpr int kStages = 2;     // depth of the ring
constexpr int kMaxRows = 96;   // staged rows of y, at most
// A slice of either product is 256 bytes of each row deep: 64 float32 or
// 128 bfloat16 channels. Three stages of 128-byte slices measured 11%
// (float32) and 20% (bfloat16) slower at the separation shape (PERF.md):
// half as many barriers pay more than a slice more in flight.
template <typename T>
constexpr int slice_depth() {
  return 256 / static_cast<int>(sizeof(T));
}
constexpr int kChainFrom = 16;  // dilations from here on take the chain
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ float prelu(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// ---- the tensor-core product of one element type ----
//
// A tiles are row-major (k contiguous) at a row stride of kPadA elements
// past a multiple of 32 words' worth, B tiles k-major (n contiguous) at
// kPadB past; both strides keep the fragment loads free of bank conflicts
// and rows 16-byte aligned.

template <typename T>
struct Tc;

template <>
struct Tc<float> {
  static constexpr int kK = 8;  // depth of one mma
  static constexpr int kPadA = 4;
  static constexpr int kPadB = 8;
  using A = attn_tiles::FragA;
  using B = attn_tiles::FragB;

  template <int LD>
  static __device__ __forceinline__ void load_a(A& a, const float* tile,
                                                int r0, int k0, int lane) {
    attn_tiles::load_a<LD>(a, tile, r0, k0, lane / 4, lane % 4);
  }
  // n8 tiles n0 and n0 + 8 of a k-major tile
  template <int LD>
  static __device__ __forceinline__ void load_b2(B* b, const float* tile,
                                                 int k0, int n0, int lane) {
    attn_tiles::load_b_kn<LD>(b[0], tile, k0, n0, lane / 4, lane % 4);
    attn_tiles::load_b_kn<LD>(b[1], tile, k0, n0 + 8, lane / 4, lane % 4);
  }
  template <int N>
  static __device__ __forceinline__ void mma(float (&c)[N][4], const A& a,
                                             const B (&b)[N]) {
    attn_tiles::mma_f32<N>(c, a, b);
  }
};

template <>
struct Tc<__nv_bfloat16> {
  static constexpr int kK = 16;
  static constexpr int kPadA = 8;
  static constexpr int kPadB = 8;
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };

  // m16n8k16 A: (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)
  template <int LD>
  static __device__ __forceinline__ void load_a(A& a,
                                                const __nv_bfloat16* tile,
                                                int r0, int k0, int lane) {
    const __nv_bfloat16* p = tile + (r0 + lane / 4) * LD + k0 + 2 * (lane % 4);
    a.r[0] = *reinterpret_cast<const uint32_t*>(p);
    a.r[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    a.r[2] = *reinterpret_cast<const uint32_t*>(p + 8);
    a.r[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
  }
  // B (k 2t, 2t + 1 | 2t + 8, 2t + 9; n g) of n8 tiles n0 and n0 + 8 from a
  // k-major tile, transposed by ldmatrix: lanes 0-15 address rows k0.. of
  // columns n0.., lanes 16-31 the same rows at n0 + 8
  template <int LD>
  static __device__ __forceinline__ void load_b2(B* b,
                                                 const __nv_bfloat16* tile,
                                                 int k0, int n0, int lane) {
    const __nv_bfloat16* p = tile + (k0 + lane % 16) * LD + n0 + 8 * (lane / 16);
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(b[0].r[0]), "=r"(b[0].r[1]), "=r"(b[1].r[0]), "=r"(b[1].r[1])
        : "r"(s));
  }
  template <int N>
  static __device__ __forceinline__ void mma(float (&c)[N][4], const A& a,
                                             const B (&b)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
          : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]),
            "r"(b[i].r[0]), "r"(b[i].r[1]));
    }
  }
};

// ---- shared memory ----

template <typename T>
struct Layout {
  static constexpr int kKS = slice_depth<T>();
  static constexpr int kLdX = kKS + Tc<T>::kPadA;     // x slice [row][k]
  static constexpr int kLdK1 = kHC + Tc<T>::kPadB;    // kernel1 slice [k][h]
  static constexpr int kLdK2 = kCols + Tc<T>::kPadB;  // kernel2 slice [h][c]
  static constexpr int kLdY = kHC + 4;                 // y [row][h], float
  static constexpr int kLdY2 = kHC + Tc<T>::kPadA;    // y2 [row][h]
  static constexpr int kStage1 =
      (kMaxRows * kLdX + kKS * kLdK1) * static_cast<int>(sizeof(T));
  static constexpr int kStage2 = kKS * kLdK2 * static_cast<int>(sizeof(T));
  static constexpr int kStage = kStage1 > kStage2 ? kStage1 : kStage2;
  static constexpr int kY = kMaxRows * kLdY * 4;
  static constexpr int kY2 = kOutRows * kLdY2 * static_cast<int>(sizeof(T));
  static constexpr int kPack = 11 * kHC * 4;  // the pass's pack columns
  static constexpr int kBytes = kStages * kStage + kY + kY2 + kPack;
  // the pack of pass p + 1 lands in the one pack tile while pass p's
  // second product runs: its stencil must be done by then
  static_assert(kHC / kKS >= kStages - 1,
                "a pass has at least kStages - 1 second-product slices");
};

// P elements global -> shared, 16 or 8 bytes; zeros when !ok
template <int P, typename T>
__device__ __forceinline__ void cp_piece(T* dst, const T* src, bool ok) {
  if constexpr (P * sizeof(T) == 16) {
    attn_tiles::cp_async_16(reinterpret_cast<float*>(dst),
                            reinterpret_cast<const float*>(src), ok);
  } else {
    static_assert(P * sizeof(T) == 8, "a piece is 16 or 8 bytes");
    attn_tiles::cp_async_8(dst, src, ok);
  }
}

struct Args {
  const void* x;
  const void* k1;
  const float* pack;
  const void* k2;
  const float* bias2;
  void* out;
  int T, B, H, d, causal;
  int chain;      // d >= kChainFrom
  int rows;       // staged rows of y (multiple of 16, <= kMaxRows)
  int per_row;    // blocks of a batch row
  int wide;       // B and H allow 16-byte pieces (bfloat16: multiples of 8)
};

// blockIdx.x = n * per_row + i; blockIdx.y = group of kCols columns
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) tcn_block_kernel(Args a) {
  using L = Layout<T>;
  using M = Tc<T>;
  constexpr int KK = M::kK;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KS = L::kKS;
  float* sy = reinterpret_cast<float*>(smem + kStages * L::kStage);
  T* sy2 = reinterpret_cast<T*>(smem + kStages * L::kStage + L::kY);
  float* spack = reinterpret_cast<float*>(smem + kStages * L::kStage + L::kY +
                                          L::kY2);

  const T* x = static_cast<const T*>(a.x);
  const T* k1 = static_cast<const T*>(a.k1);
  const T* k2 = static_cast<const T*>(a.k2);
  const int Tlen = a.T, B = a.B, H = a.H, d = a.d;
  const int n = blockIdx.x / a.per_row;
  const int blk = blockIdx.x - n * a.per_row;
  const int col0 = blockIdx.y * kCols;
  // where the block's rows lie: output row o at t0 + (o / 16) * S + o % 16
  // (owned when o % 16 < seg), staged row r at t0 - pad_l + (r / 16) * S +
  // r % 16, tap m of output row o at staged row o + m * off
  int t0, S, off, seg;
  if (a.chain) {
    const int nseg = (d + 15) / 16;
    const int c = blk % nseg;
    t0 = (blk / nseg) * 4 * d + 16 * c;
    S = d;
    off = 16;
    seg = min(16, d - 16 * c);
  } else {
    t0 = blk * kOutRows;
    S = 16;
    off = d;
    seg = 16;
  }
  if (t0 >= Tlen) return;  // the whole block: no barrier passed yet
  const int pad_l = a.causal ? 2 * d : d;
  const int tbase = t0 - pad_l;
  const T* xn = x + static_cast<size_t>(n) * Tlen * B;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int mtiles = a.rows / 16;

  const int s1 = (B + KS - 1) / KS;  // first-product slices a pass
  constexpr int s2 = kHC / KS;       // second-product slices a pass
  const int per_pass = s1 + s2;
  const int steps = ((H + kHC - 1) / kHC) * per_pass;

  // the copies of step s into ring stage st
  auto issue = [&](int s, int st) {
    unsigned char* base = smem + st * L::kStage;
    const int h0 = (s / per_pass) * kHC;
    const int sub = s % per_pass;
    if (sub == 0) {
      constexpr int kQp = kHC / 4;
      for (int i = tid; i < 11 * kQp; i += kThreads) {
        const int r = i / kQp;
        const int c = (i - r * kQp) * 4;
        const bool ok = h0 + c < H;
        attn_tiles::cp_async_16(spack + r * kHC + c,
                                ok ? a.pack + r * H + h0 + c : a.pack, ok);
      }
    }
    // rows cut into pieces of P elements, 16 bytes (8 for bfloat16 widths
    // that are multiples of 4 only)
    auto slices = [&](auto piece) {
      constexpr int P = decltype(piece)::value;
      if (sub < s1) {
        const int k0 = sub * KS;
        T* sx = reinterpret_cast<T*>(base);
        T* sk = sx + kMaxRows * L::kLdX;
        constexpr int kQ = KS / P;  // pieces of a row
        for (int i = tid; i < a.rows * kQ; i += kThreads) {
          const int r = i / kQ;
          const int c = (i - r * kQ) * P;
          const int time = tbase + (r / 16) * S + r % 16;
          const bool ok = time >= 0 && time < Tlen && k0 + c < B;
          cp_piece<P>(sx + r * L::kLdX + c,
                      ok ? xn + static_cast<size_t>(time) * B + k0 + c : x,
                      ok);
        }
        constexpr int kQ1 = kHC / P;
        for (int i = tid; i < KS * kQ1; i += kThreads) {
          const int r = i / kQ1;
          const int c = (i - r * kQ1) * P;
          const bool ok = k0 + r < B && h0 + c < H;
          cp_piece<P>(sk + r * L::kLdK1 + c,
                      ok ? k1 + static_cast<size_t>(k0 + r) * H + h0 + c : k1,
                      ok);
        }
      } else {
        const int j0 = h0 + (sub - s1) * KS;
        T* sk = reinterpret_cast<T*>(base);
        constexpr int kQ2 = kCols / P;
        for (int i = tid; i < KS * kQ2; i += kThreads) {
          const int r = i / kQ2;
          const int c = (i - r * kQ2) * P;
          const bool ok = j0 + r < H && col0 + c < B;
          cp_piece<P>(sk + r * L::kLdK2 + c,
                      ok ? k2 + static_cast<size_t>(j0 + r) * B + col0 + c
                         : k2,
                      ok);
        }
      }
    };
    if (a.wide) {
      slices(std::integral_constant<int, 16 / sizeof(T)>{});
    } else {
      slices(std::integral_constant<int, 4>{});
    }
  };

  // first product: warp (mg, ng) owns m-tiles mg, mg + 2, mg + 4 of the
  // staged rows and the hidden columns 16 ng .. 16 ng + 15 of the pass
  const int mg = warp / 8;
  const int ng = warp % 8;
  float acc1[3][2][4];
  // second product: warp (m2, n2) owns output rows 32 m2 .. 32 m2 + 31 and
  // columns 32 n2 .. 32 n2 + 31 of the block
  const int m2 = warp / 8;
  const int n2 = warp % 8;
  float acc2[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc2[i][j][c] = 0.f;
    }
  }

  // the ring: step s in stage s % kStages, kStages - 1 steps in flight; a
  // group is committed for every step, empty past the last
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s, s);
    attn_tiles::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    // step s has landed, and every warp is done with step s - 1
    attn_tiles::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int ahead = s + kStages - 1;
    if (ahead < steps) issue(ahead, ahead % kStages);
    attn_tiles::cp_async_commit();
    const unsigned char* base = smem + (s % kStages) * L::kStage;
    const int h0 = (s / per_pass) * kHC;
    const int sub = s % per_pass;
    if (sub < s1) {
      if (sub == 0) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc1[i][j][c] = 0.f;
          }
        }
      }
      const T* sx = reinterpret_cast<const T*>(base);
      const T* sk = sx + kMaxRows * L::kLdX;
#pragma unroll
      for (int k0 = 0; k0 < KS; k0 += KK) {
        typename M::B bk[2];
        M::template load_b2<L::kLdK1>(bk, sk, k0, 16 * ng, lane);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int mt = mg + 2 * i;
          if (mt < mtiles) {
            typename M::A ax;
            M::template load_a<L::kLdX>(ax, sx, 16 * mt, k0, lane);
            M::template mma<2>(acc1[i], ax, bk);
          }
        }
      }
      if (sub == s1 - 1) {
        // y = prelu(x . kernel1 + c1, a1) * g1 + h1 inside [0, T), else 0
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 16 * ng + 8 * j + 2 * t + e;
            const bool live = h0 + col < H;
            const float c1 = spack[kC1 * kHC + col];
            const float g1 = spack[kG1 * kHC + col];
            const float h1 = spack[kH1 * kHC + col];
            const float a1 = spack[kA1 * kHC + col];
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              const int mt = mg + 2 * i;
              if (mt >= mtiles) continue;
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int r = 16 * mt + g + 8 * hh;
                const int time = tbase + (r / 16) * S + r % 16;
                float y = 0.f;
                if (live && time >= 0 && time < Tlen) {
                  y = prelu(acc1[i][j][2 * hh + e] + c1, a1) * g1 + h1;
                }
                sy[r * L::kLdY + col] = y;
              }
            }
          }
        }
        __syncthreads();
        // y2 = round(prelu(w0 y[o] + w1 y[o + off] + w2 y[o + 2 off] + cb,
        // a2) * g2 + h2): one hidden column a thread, every fourth row
        {
          const int col = tid % kHC;
          const bool live = h0 + col < H;
          const float w0 = spack[kW0 * kHC + col];
          const float w1 = spack[kW1 * kHC + col];
          const float w2 = spack[kW2 * kHC + col];
          const float cb = spack[kCb * kHC + col];
          const float g2 = spack[kG2 * kHC + col];
          const float h2 = spack[kH2 * kHC + col];
          const float a2 = spack[kA2 * kHC + col];
          for (int o = tid / kHC; o < kOutRows; o += kThreads / kHC) {
            float v = w0 * sy[o * L::kLdY + col] +
                      w1 * sy[(o + off) * L::kLdY + col] +
                      w2 * sy[(o + 2 * off) * L::kLdY + col] + cb;
            v = prelu(v, a2) * g2 + h2;
            sy2[o * L::kLdY2 + col] = from_f32<T>(live ? v : 0.f);
          }
        }
        __syncthreads();
      }
    } else {
      // out += y2[:, slice] . kernel2[slice, :]
      const T* sk = reinterpret_cast<const T*>(base);
      const int kh = (sub - s1) * KS;
#pragma unroll
      for (int k0 = 0; k0 < KS; k0 += KK) {
        typename M::B bk[4];
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          M::template load_b2<L::kLdK2>(bk + j, sk, k0, 32 * n2 + 8 * j,
                                        lane);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          typename M::A ay;
          M::template load_a<L::kLdY2>(ay, sy2, 32 * m2 + 16 * i, kh + k0,
                                       lane);
          M::template mma<4>(acc2[i], ay, bk);
        }
      }
    }
  }

  // out = acc + bias2 + x, the rows the block owns
  T* outn = static_cast<T*>(a.out) + static_cast<size_t>(n) * Tlen * B;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int o = 32 * m2 + 16 * i + g + 8 * hh;
      const int time = t0 + (o / 16) * S + o % 16;
      if (o % 16 >= seg || time >= Tlen) continue;
      const size_t at = static_cast<size_t>(time) * B;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + 32 * n2 + 8 * j + 2 * t;
        if (c >= B) continue;  // B is even: c + 1 < B as well
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc2[i][j][2 * hh + e] + __ldg(a.bias2 + c + e) +
                          to_f32(xn[at + c + e]);
          outn[at + c + e] = from_f32<T>(v);
        }
      }
    }
  }
}

// The plan of a launch: the first product's staged rows, blocks a batch
// row, column groups
struct Plan {
  int chain, rows, per_row, groups;
};

Plan plan_of(int T, int B, int d) {
  Plan p;
  p.chain = d >= kChainFrom;
  if (p.chain) {
    p.rows = 96;  // six 16-row runs for four output tiles
    p.per_row = ((T + 4 * d - 1) / (4 * d)) * ((d + 15) / 16);
  } else {
    p.rows = ((kOutRows + 2 * d + 15) / 16) * 16;
    p.per_row = (T + kOutRows - 1) / kOutRows;
  }
  p.groups = (B + kCols - 1) / kCols;
  return p;
}

// the kernel takes more than 48 KB of dynamic shared memory: set once for
// each instantiation and device
template <typename T>
cudaError_t attributes() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  auto kernel = tcn_block_kernel<T>;
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            Layout<T>::kBytes);
  if (rc != cudaSuccess) return rc;
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributePreferredSharedMemoryCarveout,
                            cudaSharedmemCarveoutMaxShared);
  if (rc == cudaSuccess && known) {
    done[dev].store(true, std::memory_order_release);
  }
  return rc;
}

template <typename T>
cudaError_t launch(Args a, int N, cudaStream_t stream) {
  const cudaError_t rc = attributes<T>();
  if (rc != cudaSuccess) return rc;
  const Plan p = plan_of(a.T, a.B, a.d);
  a.chain = p.chain;
  a.rows = p.rows;
  a.per_row = p.per_row;
  a.wide = 16 / sizeof(T) == 4 || (a.B % 8 == 0 && a.H % 8 == 0);
  dim3 grid(static_cast<unsigned>(N) * p.per_row, p.groups);
  tcn_block_kernel<T><<<grid, kThreads, Layout<T>::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(int* info) {
  auto kernel = tcn_block_kernel<T>;
  cudaError_t rc = attributes<T>();
  if (rc != cudaSuccess) return rc;
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return rc;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = Layout<T>::kBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      info + 3, kernel, kThreads, Layout<T>::kBytes);
}

}  // namespace

extern "C" const char* aps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, out: N x T x B; kernel1: B x H; kernel2: H x B (float32, or bfloat16 when
// is_bf16); pack: 11 x H and bias2: B, float32. All contiguous, on the
// device, x, kernel1, pack and kernel2 aligned to 16 bytes. B and H multiples of
// 4, B <= 512, dilation >= 1.
extern "C" int aps_tcn_block_fused(const void* x, const void* kernel1,
                                   const float* pack, const void* kernel2,
                                   const float* bias2, void* out, int N, int T,
                                   int B, int H, int dilation, int causal,
                                   int is_bf16, void* stream) {
  if (N <= 0 || T <= 0) return 0;
  if (B % 4 != 0 || H % 4 != 0 || B <= 0 || H <= 0 || B > 2 * kCols ||
      dilation < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x, kernel1, pack, kernel2, bias2, out, T, B, H, dilation,
               causal, 0, 0, 0, 0};
  const cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(a, N, s)
                                  : launch<float>(a, N, s);
  return static_cast<int>(err);
}

// The launch at (T, B, dilation) and how the instance sits on an SM: info =
// {staged rows of y a block, output rows a block, blocks a batch row, column
// groups, registers a thread, bytes of local memory a thread, bytes of
// dynamic shared memory a block, resident blocks an SM}. Staged rows times
// blocks over T is the first product's repeat.
extern "C" int aps_tcn_block_fused_plan(int T, int B, int dilation,
                                        int is_bf16, int* info) {
  if (T <= 0 || B <= 0 || dilation < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan_of(T, B, dilation);
  info[0] = p.rows;
  info[1] = kOutRows;
  info[2] = p.per_row;
  info[3] = p.groups;
  return static_cast<int>(is_bf16 ? occupancy<__nv_bfloat16>(info + 4)
                                  : occupancy<float>(info + 4));
}
