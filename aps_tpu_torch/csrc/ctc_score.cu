// One CTC prefix-scorer step over flat candidate lanes, Hopper (sm_90a),
// float32: a chunked parallel scan over T.
//
// Replaces aps_tpu/ops/pallas/ctc_score.py::_ctc_score_lanes (the TPU
// kernel _ctc_score_kernel, entry ctc_score_step). For each lane l (one
// candidate extension of one beam) and t = 0..T-1:
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
// with gamma_n[-1] = gamma_b[-1] = -inf, which gives gamma_n[0] =
// max(a_0, MIN_F32) and gamma_b[0] = MIN_F32. The MIN_F32 clamps keep
// impossible states finite, as the TPU kernel's _blocked_rec does.
//
// Operands. p_c, gamma_n and gamma_b are T x L. gamma_nx and gamma_bx are
// T x P and old_score 1 x P, with P dividing L: lane l reads column
// l / (L / P), so the parent beam's gammas are read in place (P = L / C
// for C candidates a beam) or already expanded (P = L). p_blank is T x G
// with G dividing L, read the same way (one column per utterance, or one
// shared column).
//
// What bounds it on the card. The work is T L floats of p_c read, 2 T L
// written and a few T P read (a microsecond or two of device memory at the
// decode's shapes) and a handful of operations a frame, but the recursion
// is a dependent chain over T: the first port walked each lane through T
// in one thread, one load round trip and two dependent logaddexp a frame,
// 0.17 ms at T = 233 and 0.47 ms at T = 710 on grids of 6 to 12 blocks. It
// is bound by the latency of that chain.
//
// The design shortens the chain. Both recursions are affine in the
// (logaddexp, +) semiring: with s_t = (x_t, y_t) = (gamma_n[t], gamma_b[t])
//
//   x_t = (x_{t-1} + p_c[t]) (+) a_t
//   y_t = (y_{t-1} + p_b[t]) (+) (x_{t-1} + p_b[t])
//
// so a frame is a lower-triangular 2 x 2 map with an offset, five floats
// (xx, yx, yy, vx, vy), and maps compose associatively. A block holds
// kLanes lanes x kChunks = 32 chunks, a thread each; chunk j is ceil(T /
// 32) consecutive frames (8 at T = 233, 23 at T = 710).
//
//   1. Each thread composes its chunk's frame maps and takes the chunk's
//      (max, sum) of a_t for the extension score.
//   2. The maps go through shared memory to the warp of their lane, which
//      scans its 32 chunks with shuffles (Hillis-Steele, log2 32 levels);
//      chunk j's carried-in state is the offset of chunks 0..j-1 composed
//      (applied to s_{-1} = (-inf, -inf)). The same warp reduces the
//      chunks' (max, sum) and writes the lane's score and delta.
//   3. Each thread walks its chunk again from the carried state with the
//      serial recurrence itself, the MIN_F32 clamp at every frame, and
//      writes gamma_n and gamma_b.
//
// The dependent chain drops from T frames to 2 ceil(T / 32) frames and
// five compositions. In phases 1 and 3 the loads of kGroup frames are
// sent without a branch (frames past the chunk read its last one), and
// the next group's while this one is computed. logaddexp runs on the fast
// exp2 and log2 units. kLanes = 8 (256 threads, 96 blocks at L = 768)
// spreads the grid over the SMs: measured on the H100 (PERF.md), 32 lanes
// a block (a warp's width, 1024 threads, 24 blocks) took 0.028 and 0.061
// ms at T = 233 and 710 with launches queued, 16 lanes 0.020 and 0.042, 8
// lanes 0.017 and 0.039, 4 lanes 0.019 and 0.039; the fast logaddexp
// brought 8 lanes to 0.014 and 0.029, the loads sent a group ahead to
// 0.013 and 0.022. A phase still takes 650-800 cycles a frame (clock64 in
// one thread), several times the logaddexp chain's latency; why is not
// measured.
//
// Numerics. The maps are composed in the semiring, never as a difference
// of cumulative sums (the TPU's w - P form, which loses digits as P
// grows), and -inf + -inf inside a map stays -inf: log_add returns m when
// m is -inf. Clamped and impossible values inside a chunk behave as in the
// plain version, since phase 3 is the plain recurrence. No atomics and
// fixed reduction orders: two launches give the same bits.
//
// The ablation: the serial walk (one thread a lane through all T frames,
// 32 lanes a block) with the same loads a group ahead took 0.080 and 0.234
// ms queued, 5.5x and 10x the scan, and 1.6-1.7x faster than the first
// port's walk (PERF.md; an edited copy of this file timed with
// aps_tpu_torch.cmd.compare_kernels --ctc): of the gain at T = 710, 1.7x is
// latency hidden and 10x is the scan.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kMinF32 = -3.402823466e38f;
constexpr int kChunks = 32;  // a chunk per thread of the scanning warp
constexpr int kLanes = 8;    // lanes a block
constexpr int kThreads = kLanes * kChunks;
constexpr int kGroup = 8;  // frames whose loads are sent together
static_assert(kChunks == 32 && kThreads / 32 == kLanes,
              "warp w scans the 32 chunks of block lane w");

// logaddexp on the fast exp2 and log2 units: log(1 + e) with e = exp(-|a -
// b|) in (0, 1] is off by at most ~4e-7 absolute (log1pf(expf()), the
// accurate pair, runs some forty dependent instructions). A NaN operand
// gives NaN, as torch.logaddexp: fmaxf returns the other operand, and
// where that is -inf, a + b is NaN (and -inf for two -inf)
__device__ __forceinline__ float log_add(float a, float b) {
  const float m = fmaxf(a, b);
  if (m == -INFINITY) return a + b;
  return m + __logf(1.f + __expf(-fabsf(a - b)));
}

// max(v, kMinF32) that keeps a NaN, as torch.clamp_min (fmaxf would
// return the floor)
__device__ __forceinline__ float floor_min(float v) {
  return v > kMinF32 || v != v ? v : kMinF32;
}

// x -> (xx + x) (+) vx;  y -> (yx + x) (+) (yy + y) (+) vy
struct Map {
  float xx, yx, yy, vx, vy;

  __device__ __forceinline__ void identity() {
    xx = yy = 0.f;
    yx = vx = vy = -INFINITY;
  }

  // this map after frame t's (p_c, p_blank, a)
  __device__ __forceinline__ void then_frame(float pc, float pb, float a) {
    yx = pb + log_add(xx, yx);
    vy = pb + log_add(vx, vy);
    vx = log_add(pc + vx, a);
    xx += pc;
    yy += pb;
  }

  // this map (the later one) after `e` (the earlier one)
  __device__ __forceinline__ void after(const Map& e) {
    const float nyx = log_add(yx + e.xx, yy + e.yx);
    const float nvy = log_add(log_add(yx + e.vx, yy + e.vy), vy);
    vx = log_add(xx + e.vx, vx);
    vy = nvy;
    yx = nyx;
    xx += e.xx;
    yy += e.yy;
  }

  __device__ __forceinline__ void shfl_up(const Map& m, int off) {
    xx = __shfl_up_sync(0xffffffffu, m.xx, off);
    yx = __shfl_up_sync(0xffffffffu, m.yx, off);
    yy = __shfl_up_sync(0xffffffffu, m.yy, off);
    vx = __shfl_up_sync(0xffffffffu, m.vx, off);
    vy = __shfl_up_sync(0xffffffffu, m.vy, off);
  }
};

// running (max, sum of exp(a - max)) of the extension score's terms
struct LogSum {
  float m = -INFINITY;
  float s = 0.f;

  __device__ __forceinline__ void add(float a) {
    if (a == -INFINITY) return;
    if (a > m) {
      s = s * __expf(m - a) + 1.f;
      m = a;
    } else {
      s += __expf(a - m);
    }
  }

  // m is never NaN (a NaN term fails a > m and goes into s); with no
  // finite term s is 0, or NaN after a NaN term, and s * exp(-inf - mm)
  // is 0 or NaN, as logsumexp keeps a NaN
  __device__ __forceinline__ void merge(float m2, float s2) {
    const float mm = fmaxf(m, m2);
    if (mm == -INFINITY) {
      s += s2;
      return;
    }
    s = s * __expf(m - mm) + s2 * __expf(m2 - mm);
    m = mm;
  }
};

struct Args {
  const float *p_c, *gamma_nx, *gamma_bx, *p_blank, *repeat_ok, *eos_mask,
      *old_score, *is_first;
  int T, L, P, G;
  float *gamma_n, *gamma_b, *score, *delta;
};

// kGroup frames of a lane's operands: p_c[t], p_blank[t], gamma_bx[t - 1]
// and gamma_nx[t - 1]
struct Frames {
  float pc[kGroup], pb[kGroup], bx[kGroup], nx[kGroup];
};

// a lane's view of the operands: its columns of the parent's gammas and of
// the blank table
struct Lane {
  const float *pc, *gnx, *gbx, *pb;
  int L, P, G;
  bool rep_ok, first;

  // frames t0 .. t0 + kGroup - 1; those at or past t1 read frame t1 - 1
  // (t0 < t1), so that every load is sent without a branch, ahead of the
  // arithmetic that waits for it
  __device__ __forceinline__ void fetch(int t0, int t1, Frames& f) const {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int t = min(t0 + i, t1 - 1);
      const int s = max(t - 1, 0);
      f.pc[i] = pc[static_cast<size_t>(t) * L];
      f.pb[i] = pb[static_cast<size_t>(t) * G];
      f.bx[i] = gbx[static_cast<size_t>(s) * P];
      f.nx[i] = gnx[static_cast<size_t>(s) * P];
    }
  }

  // a_t of frame t0 + i
  __device__ __forceinline__ float a(const Frames& f, int t0, int i) const {
    if (t0 + i == 0) return first ? f.pc[i] : kMinF32;
    return log_add(f.bx[i], rep_ok ? f.nx[i] : kMinF32) + f.pc[i];
  }
};

__global__ void __launch_bounds__(kThreads) ctc_score_kernel(Args g) {
  const int lane = threadIdx.x % kLanes;
  const int chunk = threadIdx.x / kLanes;
  const int l = blockIdx.x * kLanes + lane;
  const bool live = l < g.L;
  const int lc = live ? l : g.L - 1;  // lanes past L read lane L - 1
  const int col = lc / (g.L / g.P);
  const int grp = lc / (g.L / g.G);
  const Lane in{g.p_c + lc,         g.gamma_nx + col, g.gamma_bx + col,
                g.p_blank + grp,    g.L,              g.P,
                g.G,                g.repeat_ok[lc] > 0.f,
                g.is_first[0] > 0.f};
  const int T = g.T;
  const int per = (T + kChunks - 1) / kChunks;
  const int t0 = min(T, chunk * per);
  const int t1 = min(T, t0 + per);
  // two groups of frames in registers: the next group's loads are in
  // flight while this one is computed
  Frames cur, next;
  LogSum sum;

  // phase 1: the chunk's composed map and its (max, sum) of a_t
  Map map;
  map.identity();
  if (t0 < t1) in.fetch(t0, t1, cur);
  for (int tb = t0; tb < t1; tb += kGroup) {
    in.fetch(min(tb + kGroup, t1 - 1), t1, next);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float a = in.a(cur, tb, i);
      Map m = map;
      m.then_frame(cur.pc[i], cur.pb[i], a);
      if (tb + i < t1) {
        map = m;
        sum.add(a);
      }
    }
    cur = next;
  }
  // phase 2: to the warp of the lane (row: chunk, padded to an odd
  // stride against bank conflicts), scan over the chunks, carried states
  // back
  __shared__ float smap[7][kChunks][kLanes + 1];
  smap[0][chunk][lane] = map.xx;
  smap[1][chunk][lane] = map.yx;
  smap[2][chunk][lane] = map.yy;
  smap[3][chunk][lane] = map.vx;
  smap[4][chunk][lane] = map.vy;
  smap[5][chunk][lane] = sum.m;
  smap[6][chunk][lane] = sum.s;
  __syncthreads();
  {
    // warp w scans the chunks of block lane w: its thread k holds chunk k
    const int w = threadIdx.x / 32;
    const int k = threadIdx.x % 32;
    Map m{smap[0][k][w], smap[1][k][w], smap[2][k][w], smap[3][k][w],
          smap[4][k][w]};
#pragma unroll
    for (int off = 1; off < kChunks; off *= 2) {
      Map e;
      e.shfl_up(m, off);
      if (k >= off) m.after(e);
    }
    // chunk k's carried-in state: chunks 0..k-1 applied to (-inf, -inf)
    float cx = __shfl_up_sync(0xffffffffu, m.vx, 1);
    float cy = __shfl_up_sync(0xffffffffu, m.vy, 1);
    if (k == 0) cx = cy = -INFINITY;
    LogSum total;
    total.m = smap[5][k][w];
    total.s = smap[6][k][w];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, total.m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, total.s, off);
      total.merge(m2, s2);
    }
    __syncthreads();  // every warp has read its column of smap
    smap[0][k][w] = cx;
    smap[1][k][w] = cy;
    const int lw = blockIdx.x * kLanes + w;
    if (k == 0 && lw < g.L) {
      float sc = floor_min(total.m + logf(total.s));
      const int cw = lw / (g.L / g.P);
      if (g.eos_mask[lw] > 0.f) {
        const size_t last = static_cast<size_t>(T - 1) * g.P + cw;
        sc = log_add(g.gamma_bx[last], g.gamma_nx[last]);
      }
      g.score[lw] = sc;
      g.delta[lw] = sc - g.old_score[cw];
    }
  }
  __syncthreads();
  float x = smap[0][chunk][lane];  // the state carried into the chunk
  float y = smap[1][chunk][lane];

  // phase 3: the serial recurrence over the chunk from the carried state
  if (t0 < t1) in.fetch(t0, t1, cur);
  for (int tb = t0; tb < t1; tb += kGroup) {
    in.fetch(min(tb + kGroup, t1 - 1), t1, next);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int t = tb + i;
      const float a = in.a(cur, tb, i);
      const float yn = floor_min(log_add(y + cur.pb[i], x + cur.pb[i]));
      const float xn = floor_min(log_add(x + cur.pc[i], a));
      if (t < t1) {
        x = xn;
        y = yn;
        if (live) {
          g.gamma_n[static_cast<size_t>(t) * g.L + l] = x;
          g.gamma_b[static_cast<size_t>(t) * g.L + l] = y;
        }
      }
    }
    cur = next;
  }
}

}  // namespace

extern "C" const char* aps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// p_c, gamma_n, gamma_b: T x L; gamma_nx, gamma_bx: T x P; p_blank: T x G;
// repeat_ok, eos_mask, score, delta: 1 x L; old_score: 1 x P; is_first:
// 1 x 1; P and G divide L. All float32, contiguous, on the device.
extern "C" int aps_ctc_score_step(const float* p_c, const float* gamma_nx,
                                  const float* gamma_bx, const float* p_blank,
                                  int G, const float* repeat_ok,
                                  const float* eos_mask,
                                  const float* old_score,
                                  const float* is_first, int T, int L, int P,
                                  float* gamma_n, float* gamma_b, float* score,
                                  float* delta, void* stream) {
  if (T <= 0 || L <= 0 || P <= 0 || G <= 0 || L % P != 0 || L % G != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{p_c,       gamma_nx, gamma_bx, p_blank, repeat_ok,
                  eos_mask,  old_score, is_first, T,      L,
                  P,         G,         gamma_n,  gamma_b, score,
                  delta};
  const int blocks = (L + kLanes - 1) / kLanes;
  ctc_score_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}
