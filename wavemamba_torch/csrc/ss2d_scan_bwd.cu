// K2 on Hopper: the backward of K1, the fused SS2D projection + selective scan
// of one direction pair.
//
// Replaces the TPU kernel `wavemamba_tpu/ops/scan_pallas.py:_fused_bwd_kernel`
// (`ss2d_scan_fused_bwd`). Given x, the six weights, the forward's chunk-entry
// states and chunk decays, and dy (B, 2, L, D), it computes, per direction k
// in that direction's processing order (see ss2d_scan.cu for the forward):
//   z_t  = x_dbl_t[:R] . dtw[k] + bias[k],  da_t = softplus(z_t),  a_t = exp(da_t A)
//   h_t  = a_t h_{t-1} + da_t x_t B_t                       (recomputed)
//   g_t  = a_{t+1} g_{t+1} + C_t (x) dy_t                   (the adjoint, reverse)
//   common = g_t h_t - g_t da_t x_t B_t                     (= g_t a_t h_{t-1})
//   dda  = sum_n common A + (sum_n g_t B_t) x_t,   dz = dda * sigmoid(z_t)
//   du   = da_t sum_n g_t B_t + dsk dy_t
//   dB_t = sum_d g_t da_t x_t,   dC_t = sum_d dy_t h_t
//   dx_t = [dz . dtw^T | dB_t | dC_t] . wx^T + du           (summed over the pair)
// and the sums over tokens and batch: dwx = x^T [dz.dtw^T | dB | dC],
// ddtw = x_dbl[:R]^T dz, dbias = sum dz, dA = sum common da, ddsk = sum dy x.
// Every product stays in the kernel.
//
// What bounds it on an H100 (`chip_smoke.py:k2_bound`): the FMA pipe. Per
// token and direction the recompute of h, the adjoint and the sums take some
// 20 float32 operations per (n, d) plus the projections: 0.547 ms for a
// training step's level 1 (8 x 65,536 tokens). The special-function units do
// N*D + 3D exp per token and direction and pass (about a quarter of the FMA
// pipe's time for one pass), and the 12*D bytes of x and dy read and 4*D bytes
// of dx written per token are far less again.
//
// Design. As K1 it is parallel over L in chunks of T tokens, which K1 has left
// the entering states of. The adjoint g obeys a linear recurrence with the
// same decays as h, so three phases serve again:
//   1. bwd_local: one block per (chunk, batch) runs the adjoint backwards over
//      the chunk from g = 0 and writes what leaves it, a_first * g_first.
//   2. bwd_prefix: per (b, k, n, d), a prefix over the chunks in reverse
//      processing order (a chunk's decay is exp(A * sumda), saved by K1) turns
//      that into what enters each chunk.
//   3. bwd_main: the gradients. g runs backwards but needs h_t at every token,
//      so a forward pass over the chunk keeps h at every S-th token in shared
//      memory; then, sub-tile by sub-tile from the last, h is recomputed for S
//      tokens into registers and g sweeps back over them. The recurrence is
//      never inverted.
//
// The first design ran one thread per (direction, channel): 128 threads
// that held all 16 states each, and 198 KB of shared memory, so one block of
// 4 warps an SM, where every exp, shared-memory load and dependent FMA of the
// serial recurrence waited its full latency. Its grid was two waves of long
// serial blocks; its sums over channels were 64-long serial loops, one
// thread per (token, n) row; it read wx again for every token. What this
// version does about each:
//   - Occupancy. A quad of threads holds one (direction, channel), 4 states
//     each: 512 threads a block. bwd_main keeps 16 warps an SM: its ~228 KB
//     of shared memory and its 128 registers a thread allow one block, and two
//     would leave 64 registers, fewer than a sub-tile's h history (32) and
//     the accumulators need. bwd_local (85 KB, at most 64 registers)
//     keeps 32. The sums over n (g.B, dda) are two xor-shuffles in the quad.
//   - The grid. bwd_main's blocks stride over all B * nc chunks, as many as
//     reside at once: one whole wave (`ops/scan_cuda.py:k2_plan`).
//   - The serial chains. The h history of a sub-tile stays in registers; the
//     sums over channels (dB, dC and the dt part of dz . dtw^T) are a
//     transposing butterfly over the warp's 8 channels (7 + 3 shuffles a
//     token) and one 8-term sum over the warps; da and sigmoid(z) of a chunk
//     are computed once, in parallel over (token, channel), before the serial
//     passes; dy comes from shared memory, staged for the chunk (bwd_local) or
//     fetched for the next sub-tile while the sweep runs (bwd_main); a decay
//     is one ex2.approx.ftz of da times A log2(e), in place of expf's longer
//     sequence; bwd_prefix loads four chunks' values before it uses them.
//   - The weights. wx sits in shared memory, staged once per block; the
//     projection takes 4 tokens by 4-5 columns a thread; each thread keeps its
//     quarter of its channel's row of wx, and its dt weights, in registers,
//     so the dx loop reads no weight from memory.
// The exp of the recurrence is still computed four times (phase 1, and three
// passes of phase 3): keeping a_t of a sub-tile beside h would take 32 more
// registers a thread, and registers are what hold bwd_main to one block an
// SM. Each block writes one set of partial sums and bwd_reduce adds them up
// in a fixed order; every shuffle sum has a fixed order too, so the result is
// the same bits every run.
//
// Token streams in float32 or bf16: x and dx of type TX, dy of type TDY, both
// widened on load. Three pairs are built, as K1's: (float32, float32),
// (bf16, bf16), and bf16 x with float32 dy, which `compute_dtype: bfloat16`
// with the default `scan_dtype: float32` gives. Each member's dx is rounded to
// x's dtype, the two are added in float32 in shared memory (two adds onto
// zero: the same bits in either order) and the sum is rounded again: the TPU
// kernel's bf16 dx, one rounding per member and a bf16 add, whatever dy's
// dtype. Weights, their gradients and every operation stay float32.

#include <cuda_runtime.h>
#include <math.h>

#include "stream_dtype.cuh"

namespace {

constexpr int kRPad = 4;            // x_dbl row: [dt (R <= 4, padded) | B (N) | C (N)]
constexpr int kSub = 8;             // tokens per sub-tile of bwd_main
constexpr int kPrefixWorkers = 32;  // workers per lane in bwd_prefix
constexpr int kDMax = 64;           // channels a block holds; D <= kDMax
constexpr int kTMax = 64;           // tokens a chunk holds; T <= kTMax
constexpr int kDP = kDMax + 1;      // padded row of the x and dx tiles
constexpr int kQuad = 4;            // threads per (direction, channel)
constexpr int kThreads = 2 * kDMax * kQuad;  // 512
constexpr int kWarpsPerDir = kDMax / 8;      // 8 channels a warp
constexpr unsigned kFull = 0xffffffffu;
static_assert(2 * kSub * kDMax == 2 * kThreads, "a sub-tile's dy is two elements a thread");
constexpr float kLog2e = 1.4426950408889634f;  // exp(v) = exp2(v log2 e)
constexpr float kLn2 = 0.6931471805599453f;

// 2^v in one SFU instruction. Results below 2^-126 flush to zero: they are
// far below what the float32 sums they enter can resolve.
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// softplus(v) (torch.nn.functional.softplus, threshold 20, as in K1) and
// sigmoid(v) from one exp.
__device__ __forceinline__ void softplus_sigmoid(float v, float& sp, float& sg) {
  const float e = expf(v);
  sp = v > 20.f ? v : log1pf(e);
  sg = v > 20.f ? 1.f : e * __frcp_rn(1.f + e);
}

// Where a thread sits: direction k (threads 0-255 and 256-511), channel d =
// 8 * (warp within the direction) + lane / 4, and q = lane % 4, the quarter
// of the states (n = 4q .. 4q+3) it holds. Channels d >= D are idle lanes
// that compute on zeros and write nothing.
struct Lane {
  int k, d, q, dl, wd;
  bool active;
};

__device__ __forceinline__ Lane lane_of(int D) {
  Lane l;
  const int tid = threadIdx.x;
  l.k = tid >> 8;
  l.wd = (tid >> 5) & (kWarpsPerDir - 1);
  l.q = tid & 3;
  l.dl = (tid >> 2) & 7;
  l.d = l.wd * 8 + l.dl;
  l.active = l.d < D;
  return l;
}

// The sum over a quad's four lanes; every lane gets the same bits.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// v[0..7] of each lane summed over the 8 lanes of the warp that share q
// (lanes 4 apart): lane dl returns the sum of value dl. 7 shuffles.
__device__ __forceinline__ float transpose_sum8(const float (&v)[8], int dl) {
  const bool h2 = dl & 4, h1 = dl & 2, h0 = dl & 1;
  float a[4], c[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = (h2 ? v[i + 4] : v[i]) + __shfl_xor_sync(kFull, h2 ? v[i] : v[i + 4], 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    c[i] = (h1 ? a[i + 2] : a[i]) + __shfl_xor_sync(kFull, h1 ? a[i] : a[i + 2], 8);
  }
  return (h0 ? c[1] : c[0]) + __shfl_xor_sync(kFull, h0 ? c[0] : c[1], 4);
}

// wx (2, D, J) into wxs [2][kDMax][J], zero beyond D.
template <int J>
__device__ __forceinline__ void stage_wx(const float* __restrict__ wx, float* wxs, int D) {
  for (int i = threadIdx.x; i < 2 * kDMax * J; i += kThreads) {
    const int k = i / (kDMax * J), rem = i - k * kDMax * J;
    const int d = rem / J;
    wxs[i] = d < D ? wx[((size_t)k * D + d) * J + rem - d * J] : 0.f;
  }
}

// Stages the chunk's x tile in xs [T][kDP] (zero beyond D) and x_dbl of both
// directions in xd [2][T][JP] from the staged wx. A thread takes 4 tokens
// (tq + 16i) by 4-5 columns (g + 8m) over half the channels: 20 FMAs for 9
// shared-memory loads; the two halves' sums meet by a shuffle.
template <int N, int R, typename TX>
__device__ __forceinline__ void load_and_project(
    const TX* __restrict__ xb, const float* wxs, float* xs, float* xd, int tc, int D, int T) {
  constexpr int J = R + 2 * N;
  constexpr int JP = kRPad + 2 * N;
  for (int i = threadIdx.x; i < tc * kDMax; i += kThreads) {
    const int t = i / kDMax, d = i - t * kDMax;
    xs[t * kDP + d] = d < D ? load_f32(xb + (size_t)t * D + d) : 0.f;
  }
  __syncthreads();
  constexpr int MG = (J + 7) / 8;
  const int g = threadIdx.x & 7, hf = (threadIdx.x >> 3) & 1, tq = (threadIdx.x >> 4) & 15;
  const int k = threadIdx.x >> 8;
  const float* w = wxs + k * kDMax * J + g;
  float acc[4][MG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < MG; ++m) acc[i][m] = 0.f;
  const int d0 = hf * 32, d1 = min(D, d0 + 32);
#pragma unroll 2
  for (int d = d0; d < d1; ++d) {
    float xv[4], wv[MG];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = xs[min(tq + 16 * i, tc - 1) * kDP + d];
#pragma unroll
    for (int m = 0; m < MG; ++m) wv[m] = g + 8 * m < J ? w[d * J + 8 * m] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < MG; ++m) acc[i][m] = fmaf(xv[i], wv[m], acc[i][m]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tq + 16 * i;
    float* o = xd + (k * T + t) * JP;
#pragma unroll
    for (int m = 0; m < MG; ++m) {
      const float v = acc[i][m] + __shfl_xor_sync(kFull, acc[i][m], 8);
      const int j = g + 8 * m;
      if (hf == 0 && j < J && t < tc) o[j < R ? j : kRPad + j - R] = v;
    }
  }
  __syncthreads();
}

// da (and, where sgs is given, sigmoid(z)) of every (direction, token,
// channel) of the chunk into [2][T][kDMax], zero beyond D. Element i of the
// loop has channel i % kDMax = threadIdx.x % kDMax, whose dt weights and bias
// of both directions the caller holds in wdt2 and bias2.
template <int R, int JP>
__device__ __forceinline__ void prepare_da(const float* xd, const float (&wdt2)[2][R],
                                           const float (&bias2)[2], float* das, float* sgs,
                                           int tc, int D, int T) {
  for (int i = threadIdx.x; i < 2 * tc * kDMax; i += kThreads) {
    const int k = i / (tc * kDMax), rem = i - k * tc * kDMax;
    const int t = rem / kDMax, d = rem - t * kDMax;
    const float* q = xd + (k * T + t) * JP;
    float dt = k ? bias2[1] : bias2[0];
#pragma unroll
    for (int r = 0; r < R; ++r) dt = fmaf(q[r], k ? wdt2[1][r] : wdt2[0][r], dt);
    const bool on = d < D;
    float sp, sg;
    softplus_sigmoid(dt, sp, sg);
    das[(k * T + t) * kDMax + d] = on ? sp : 0.f;
    if (sgs) sgs[(k * T + t) * kDMax + d] = on ? sg : 0.f;
  }
  __syncthreads();
}

// The dt weights and biases of channel threadIdx.x % kDMax, both directions.
template <int R>
__device__ __forceinline__ void load_dt_weights(const float* __restrict__ dtw,
                                                const float* __restrict__ bias, int D,
                                                float (&wdt2)[2][R], float (&bias2)[2]) {
  const int d = threadIdx.x & (kDMax - 1);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    bias2[k] = d < D ? bias[k * D + d] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) wdt2[k][r] = d < D ? dtw[((size_t)k * R + r) * D + d] : 0.f;
  }
}

// bwd_local's region that holds wx and x, then dy.
__host__ __device__ constexpr int local_dy_floats(int J, int T) {
  return 2 * kDMax * J + T * kDP > 2 * T * kDMax ? 2 * kDMax * J + T * kDP : 2 * T * kDMax;
}

size_t local_smem(int N, int R, int T) {
  const int J = R + 2 * N, JP = kRPad + 2 * N;
  return sizeof(float) * ((size_t)2 * T * JP + local_dy_floats(J, T) + (size_t)2 * T * kDMax);
}

size_t main_smem(int N, int R, int T) {
  const int J = R + 2 * N, JP = kRPad + 2 * N;
  return sizeof(float) * ((size_t)2 * kDMax * J + (size_t)2 * T * JP + (size_t)2 * T * kDP +
                          (size_t)(T / kSub) * 2 * kDMax * N + (size_t)4 * T * kDMax +
                          (size_t)2 * kWarpsPerDir * kSub * J + (size_t)2 * kSub * J +
                          (size_t)4 * kSub * kDMax);
}

// Phase 1: what the adjoint carries out of each chunk when nothing enters it.
template <int N, int R, typename TX, typename TDY>
__global__ void __launch_bounds__(kThreads, 2) bwd_local(
    const TX* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ dtw, const float* __restrict__ bias,
    const float* __restrict__ A, const TDY* __restrict__ dy,
    float* __restrict__ gcar, int L, int D, int T, int nc) {
  constexpr int J = R + 2 * N;
  constexpr int JP = kRPad + 2 * N;
  constexpr int NQ = N / kQuad;
  extern __shared__ float4 smem4[];
  float* xd = reinterpret_cast<float*>(smem4);  // [2][T][JP]
  float* wxs = xd + 2 * T * JP;                 // [2][kDMax][J], then dy
  float* xs = wxs + 2 * kDMax * J;              // [T][kDP], then dy
  float* dys = wxs;                             // [2][T][kDMax] once x_dbl is made
  float* das = wxs + local_dy_floats(J, T);     // [2][T][kDMax]
  const int c = blockIdx.x, b = blockIdx.y;
  const int l0 = c * T;
  const int tc = min(T, L - l0);
  float wdt2[2][R], bias2[2];
  load_dt_weights<R>(dtw, bias, D, wdt2, bias2);
  stage_wx<J>(wx, wxs, D);
  load_and_project<N, R>(x + ((size_t)b * L + l0) * D, wxs, xs, xd, tc, D, T);
  // dy of the chunk, both directions, where wx and x were.
  const TDY* dyc = dy + ((size_t)b * 2 * L + l0) * D;
  for (int i = threadIdx.x; i < 2 * tc * kDMax; i += kThreads) {
    const int k = i / (tc * kDMax), rem = i - k * tc * kDMax;
    const int t = rem / kDMax, d = rem - t * kDMax;
    dys[(k * T + t) * kDMax + d] = d < D ? load_f32(dyc + ((size_t)k * L + t) * D + d) : 0.f;
  }
  prepare_da<R, JP>(xd, wdt2, bias2, das, nullptr, tc, D, T);  // its barrier covers dys

  const Lane ln = lane_of(D);
  const int k = ln.k, d = ln.d;
  float An[NQ], ga[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    An[i] = ln.active ? A[((size_t)k * N + kQuad * ln.q + i) * D + d] * kLog2e : 0.f;
    ga[i] = 0.f;  // a_{t+1} g_{t+1}
  }
  // Backwards over the chunk.
#pragma unroll 4
  for (int s = tc - 1; s >= 0; --s) {
    const int t = k == 0 ? s : tc - 1 - s;
    const int row = (k * T + t);
    const float da = das[row * kDMax + d], dyv = dys[row * kDMax + d];
    const float4 cv = *reinterpret_cast<const float4*>(xd + row * JP + kRPad + N + kQuad * ln.q);
    const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int j = 0; j < NQ; ++j) ga[j] = ex2(da * An[j]) * fmaf(cs[j], dyv, ga[j]);
  }
  if (ln.active) {
    float* go = gcar + (((size_t)b * 2 + k) * nc + c) * N * D + d;
#pragma unroll
    for (int j = 0; j < NQ; ++j) go[(size_t)(kQuad * ln.q + j) * D] = ga[j];
  }
}

// Phase 2: what enters every chunk, in place of what leaves it. As K1's
// chunk_prefix, over the chunks in the reverse of the processing order.
__global__ void __launch_bounds__(32 * kPrefixWorkers) bwd_prefix(
    const float* __restrict__ A, float* __restrict__ gcar,
    const float* __restrict__ sumda, int ND, int D, int nc) {
  __shared__ float agg_a[kPrefixWorkers][32];
  __shared__ float agg_g[kPrefixWorkers][32];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int nd = blockIdx.x * 32 + lane;
  const int k = blockIdx.y, b = blockIdx.z;
  const bool valid = nd < ND;
  const int d = nd % D;
  const float a_nd = valid ? A[(size_t)k * ND + nd] : 0.f;
  const size_t base = ((size_t)b * 2 + k) * nc;
  const int seg = (nc + kPrefixWorkers - 1) / kPrefixWorkers;
  const int p0 = min(nc, w * seg), p1 = min(nc, p0 + seg);

  // Each pass loads kBatch chunks' values before it uses them: the loads
  // overlap, and the writes of the second pass cannot hold them back.
  constexpr int kBatch = 4;
  float pa = 1.f, pg = 0.f;
  if (valid) {
    for (int p = p0; p < p1; p += kBatch) {
      float a[kBatch], ge[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const size_t ci = base + (k == 0 ? nc - 1 - (p + u) : p + u);
        a[u] = p + u < p1 ? expf(a_nd * sumda[ci * D + d]) : 1.f;
        ge[u] = p + u < p1 ? gcar[ci * ND + nd] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        pg = fmaf(a[u], pg, ge[u]);
        pa *= a[u];
      }
    }
  }
  agg_a[w][lane] = pa;
  agg_g[w][lane] = pg;
  __syncthreads();
  if (!valid) return;

  float gc = 0.f;
  for (int v = 0; v < w; ++v) gc = fmaf(agg_a[v][lane], gc, agg_g[v][lane]);
  for (int p = p0; p < p1; p += kBatch) {
    float a[kBatch], ge[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const size_t ci = base + (k == 0 ? nc - 1 - (p + u) : p + u);
      a[u] = p + u < p1 ? expf(a_nd * sumda[ci * D + d]) : 1.f;
      ge[u] = p + u < p1 ? gcar[ci * ND + nd] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (p + u < p1) {
        gcar[(base + (k == 0 ? nc - 1 - (p + u) : p + u)) * ND + nd] = gc;
        gc = fmaf(a[u], gc, ge[u]);
      }
    }
  }
}

// dy of element e of a sub-tile's [2][kSub][kDMax] tile: tokens s0 .. s0+cnt-1
// of the processing order, zero beyond them and beyond D.
template <typename TDY>
__device__ __forceinline__ float sub_tile_dy(const TDY* dyg, int e, int s0, int cnt, int tc,
                                             int L, int D) {
  const int kk = e / (kSub * kDMax), si = (e / kDMax) % kSub, dd = e % kDMax;
  const int s = s0 + si;
  const int t = kk == 0 ? s : tc - 1 - s;
  return si < cnt && dd < D ? load_f32(dyg + ((size_t)kk * L + t) * D + dd) : 0.f;
}

// Phase 3: the gradients. The gridDim.x blocks stride over the B * nc chunks.
// part: [gridDim.x][P][2D] partial sums, P = (R+2N) + R + 1 + N + 1 rows:
// dwx, ddtw, dbias, dA, ddsk.
template <int N, int R, typename TX, typename TDY>
__global__ void __launch_bounds__(kThreads, 1) bwd_main(
    const TX* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ dtw, const float* __restrict__ bias,
    const float* __restrict__ A, const float* __restrict__ dsk,
    const float* __restrict__ state, const float* __restrict__ gcar,
    const TDY* __restrict__ dy, TX* __restrict__ dx,
    float* __restrict__ part, int B, int L, int D, int T, int nc) {
  constexpr int J = R + 2 * N;
  constexpr int JP = kRPad + 2 * N;
  constexpr int S = kSub;
  constexpr int NQ = N / kQuad;
  constexpr int M = (J + kQuad - 1) / kQuad;
  extern __shared__ float4 smem4[];
  float* wxs = reinterpret_cast<float*>(smem4);  // [2][kDMax][J] wx
  float* xd = wxs + 2 * kDMax * J;               // [2][T][JP] x_dbl
  float* xs = xd + 2 * T * JP;                   // [T][kDP] x
  float* dxs = xs + T * kDP;                     // [T][kDP] dx of both directions
  float* hb = dxs + T * kDP;                     // [T/S][2][kDMax][N] h entering each sub-tile
  float* das = hb + (T / S) * 2 * kDMax * N;     // [2][T][kDMax] da
  float* sgs = das + 2 * T * kDMax;              // [2][T][kDMax] sigmoid(z)
  float* red = sgs + 2 * T * kDMax;              // [2][warps][S][J] the warps' sums over d
  float* dxd = red + 2 * kWarpsPerDir * S * J;   // [2][S][J] gradient of x_dbl
  float* dys = dxd + 2 * S * J;                  // [2][S][kDMax] dy
  float* dus = dys + 2 * S * kDMax;              // [2][S][kDMax] du

  const int tid = threadIdx.x;
  const Lane ln = lane_of(D);
  const int k = ln.k, d = ln.d, q = ln.q;
  float wdt2[2][R], bias2[2];
  load_dt_weights<R>(dtw, bias, D, wdt2, bias2);
  stage_wx<J>(wx, wxs, D);  // before load_and_project's first barrier
  float An[NQ], wrow[M];
#pragma unroll
  for (int i = 0; i < NQ; ++i) An[i] = ln.active ? A[((size_t)k * N + kQuad * q + i) * D + d] * kLog2e : 0.f;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int j = q + kQuad * m;
    wrow[m] = ln.active && j < J ? wx[((size_t)k * D + d) * J + j] : 0.f;
  }
  const float wdtq = ln.active && q < R ? dtw[((size_t)k * R + q) * D + d] : 0.f;
  const float dk = ln.active ? dsk[k * D + d] : 0.f;

  float dwx_acc[M], dA_acc[NQ];
  float ddtw_acc = 0.f, dbias_acc = 0.f, ddsk_acc = 0.f;
#pragma unroll
  for (int m = 0; m < M; ++m) dwx_acc[m] = 0.f;
#pragma unroll
  for (int i = 0; i < NQ; ++i) dA_acc[i] = 0.f;

  for (int item = blockIdx.x; item < B * nc; item += gridDim.x) {
    const int b = item / nc, c = item - b * nc;
    const int l0 = c * T;
    const int tc = min(T, L - l0);
    __syncthreads();  // the previous chunk's tiles are free
    for (int i = tid; i < tc * kDP; i += kThreads) dxs[i] = 0.f;
    load_and_project<N, R>(x + ((size_t)b * L + l0) * D, wxs, xs, xd, tc, D, T);
    const TDY* dyg = dy + (size_t)b * 2 * L * D + (size_t)l0 * D;
    const int nsub = (tc + S - 1) / S;
    // dy of the last sub-tile; each later one is fetched during the sweep before it.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dys[tid + r * kThreads] = sub_tile_dy(dyg, tid + r * kThreads, (nsub - 1) * S,
                                            tc - (nsub - 1) * S, tc, L, D);
    }
    prepare_da<R, JP>(xd, wdt2, bias2, das, sgs, tc, D, T);  // its barrier covers dys

    const size_t ci = ((size_t)b * 2 + k) * nc + c;
    float h[NQ], ga[NQ];

    // h at the head of every sub-tile, from the chunk's entering state; each
    // thread keeps its own four states there.
#pragma unroll
    for (int i = 0; i < NQ; ++i) h[i] = ln.active ? state[(ci * N + kQuad * q + i) * D + d] : 0.f;
    for (int s = 0; s < tc; ++s) {
      if (s % S == 0) {
        *reinterpret_cast<float4*>(hb + (((s / S) * 2 + k) * kDMax + d) * N + kQuad * q) =
            make_float4(h[0], h[1], h[2], h[3]);
      }
      const int t = k == 0 ? s : tc - 1 - s;
      const float da = das[(k * T + t) * kDMax + d];
      const float du = da * xs[t * kDP + d];
      const float4 bv = *reinterpret_cast<const float4*>(xd + (k * T + t) * JP + kRPad + kQuad * q);
      const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < NQ; ++i) h[i] = fmaf(ex2(da * An[i]), h[i], du * bs[i]);
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) ga[i] = ln.active ? gcar[(ci * N + kQuad * q + i) * D + d] : 0.f;

    for (int j = nsub - 1; j >= 0; --j) {
      const int s0 = j * S;
      const int cnt = min(S, tc - s0);

      // h of the sub-tile's tokens, into registers.
      float hh[S][NQ];
      {
        const float4 v = *reinterpret_cast<const float4*>(hb + ((j * 2 + k) * kDMax + d) * N + kQuad * q);
        h[0] = v.x, h[1] = v.y, h[2] = v.z, h[3] = v.w;
      }
#pragma unroll
      for (int si = 0; si < S; ++si) {
        if (si < cnt) {
          const int s = s0 + si;
          const int t = k == 0 ? s : tc - 1 - s;
          const float da = das[(k * T + t) * kDMax + d];
          const float du = da * xs[t * kDP + d];
          const float4 bv = *reinterpret_cast<const float4*>(xd + (k * T + t) * JP + kRPad + kQuad * q);
          const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            h[i] = fmaf(ex2(da * An[i]), h[i], du * bs[i]);
            hh[si][i] = h[i];
          }
        }
      }
      // dy of the sub-tile before, fetched while the sweep runs (only the
      // chunk's last sub-tile can be short).
      float dy_next[2] = {0.f, 0.f};
      if (j > 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) dy_next[r] = sub_tile_dy(dyg, tid + r * kThreads, s0 - S, S, tc, L, D);
      }

      // The adjoint sweeps back over the sub-tile; the sums over the warp's
      // channels of g da u (dB), dy h (dC) and dz dtw go to red.
#pragma unroll
      for (int si = S - 1; si >= 0; --si) {
        if (si < cnt) {
          const int s = s0 + si;
          const int t = k == 0 ? s : tc - 1 - s;
          const int row = k * T + t;
          const float da = das[row * kDMax + d];
          const float sig = sgs[row * kDMax + d];
          const float u = xs[t * kDP + d];
          const float dau = da * u;
          const float dyv = dys[(k * S + si) * kDMax + d];
          const float* xq = xd + row * JP;
          const float4 bv = *reinterpret_cast<const float4*>(xq + kRPad + kQuad * q);
          const float4 cv = *reinterpret_cast<const float4*>(xq + kRPad + N + kQuad * q);
          const float bs[4] = {bv.x, bv.y, bv.z, bv.w}, cs[4] = {cv.x, cv.y, cv.z, cv.w};
          float gB = 0.f, dda = 0.f, vals[8];
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            const float g = fmaf(cs[i], dyv, ga[i]);
            const float gdau = g * dau;
            const float common = fmaf(g, hh[si][i], -gdau * bs[i]);
            gB = fmaf(g, bs[i], gB);
            dda = fmaf(common, An[i], dda);
            dA_acc[i] = fmaf(common, da, dA_acc[i]);
            ga[i] = ex2(da * An[i]) * g;
            vals[i] = gdau;
            vals[NQ + i] = dyv * hh[si][i];
          }
          gB = quad_sum(gB);
          dda = fmaf(gB, u, quad_sum(dda) * kLn2);  // An holds A log2 e
          const float ddr = dda * sig;
          dbias_acc += ddr;
          ddsk_acc = fmaf(dyv, u, ddsk_acc);
          if (q < R) ddtw_acc = fmaf(xq[q], ddr, ddtw_acc);
          if (q == 0) dus[(k * S + si) * kDMax + d] = fmaf(da, gB, dk * dyv);
          const float v = transpose_sum8(vals, ln.dl);
          float xr = ddr * wdtq;
          xr += __shfl_xor_sync(kFull, xr, 4);
          xr += __shfl_xor_sync(kFull, xr, 8);
          xr += __shfl_xor_sync(kFull, xr, 16);
          float* rr = red + ((k * kWarpsPerDir + ln.wd) * S + si) * J;
          rr[ln.dl < NQ ? R + kQuad * q + ln.dl : R + N + kQuad * q + ln.dl - NQ] = v;
          if (ln.dl == 0 && q < R) rr[q] = xr;
        }
      }
      __syncthreads();
      if (j > 0) {  // the sweep has read dys
        dys[tid] = dy_next[0];
        dys[tid + kThreads] = dy_next[1];
      }

      // dxd = the sum of the warps' sums, in warp order.
      for (int o = tid; o < 2 * S * J; o += kThreads) {
        const int kk = o / (S * J);
        const float* rp = red + kk * kWarpsPerDir * S * J + (o - kk * S * J);
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarpsPerDir; ++w) acc += rp[w * S * J];
        dxd[o] = acc;
      }
      __syncthreads();

      // dx = dxd . wx^T + du, and dwx += x^T dxd; a quad shares the row.
#pragma unroll
      for (int si = 0; si < S; ++si) {
        if (si < cnt) {
          const int s = s0 + si;
          const int t = k == 0 ? s : tc - 1 - s;
          const float* rowp = dxd + (k * S + si) * J + q;
          const float xv = xs[t * kDP + d];
          float acc = 0.f;
#pragma unroll
          for (int m = 0; m < M; ++m) {
            if (q + kQuad * m < J) {
              const float v = rowp[kQuad * m];
              acc = fmaf(v, wrow[m], acc);
              dwx_acc[m] = fmaf(xv, v, dwx_acc[m]);
            }
          }
          acc = quad_sum(acc);
          if (q == 0 && ln.active) {
            atomicAdd(dxs + t * kDP + d, round_like(dx, acc + dus[(k * S + si) * kDMax + d]));
          }
        }
      }
    }
    __syncthreads();
    TX* dxb = dx + ((size_t)b * L + l0) * D;
    for (int i = tid; i < tc * D; i += kThreads) store_f32(dxb + i, dxs[(i / D) * kDP + i % D]);
  }

  if (!ln.active) return;
  const int D2 = 2 * D;
  float* po = part + (size_t)blockIdx.x * (J + R + N + 2) * D2 + k * D + d;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (q + kQuad * m < J) po[(size_t)(q + kQuad * m) * D2] = dwx_acc[m];
  }
  if (q < R) po[(size_t)(J + q) * D2] = ddtw_acc;
  if (q == 0) {
    po[(size_t)(J + R) * D2] = dbias_acc;
    po[(size_t)(J + R + 1 + N) * D2] = ddsk_acc;
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i) po[(size_t)(J + R + 1 + kQuad * q + i) * D2] = dA_acc[i];
}

// out[i] = sum over the blocks' partial sums, in block order.
__global__ void bwd_reduce(const float* __restrict__ part, float* __restrict__ out,
                           int rows, int width) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= width) return;
  float acc = 0.f;
  for (int r = 0; r < rows; ++r) acc += part[(size_t)r * width + i];
  out[i] = acc;
}

template <int N, int R, typename TX, typename TDY>
cudaError_t set_smem(int T) {
  cudaError_t e = cudaFuncSetAttribute(bwd_local<N, R, TX, TDY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)local_smem(N, R, T));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(bwd_main<N, R, TX, TDY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)main_smem(N, R, T));
}

template <int N, int R, typename TX, typename TDY>
cudaError_t launch(const TX* x, const float* wx, const float* dtw,
                   const float* bias, const float* A, const float* dsk,
                   const float* state, const float* sumda, const TDY* dy,
                   TX* dx, float* gcar, float* part, float* sums,
                   int B, int L, int D, int T, int gx, cudaStream_t stream) {
  const int nc = (L + T - 1) / T;
  cudaError_t e = set_smem<N, R, TX, TDY>(T);
  if (e != cudaSuccess) return e;
  bwd_local<N, R, TX, TDY><<<dim3(nc, B), kThreads, local_smem(N, R, T), stream>>>(
      x, wx, dtw, bias, A, dy, gcar, L, D, T, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 pgrid((N * D + 31) / 32, 2, B), pblock(32, kPrefixWorkers);
  bwd_prefix<<<pgrid, pblock, 0, stream>>>(A, gcar, sumda, N * D, D, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_main<N, R, TX, TDY><<<gx, kThreads, main_smem(N, R, T), stream>>>(
      x, wx, dtw, bias, A, dsk, state, gcar, dy, dx, part, B, L, D, T, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int width = (R + 2 * N + R + N + 2) * 2 * D;
  bwd_reduce<<<(width + 255) / 256, 256, 0, stream>>>(part, sums, gx, width);
  return cudaGetLastError();
}

template <typename TX, typename TDY>
cudaError_t launch_r(const void* x, const void* wx, const void* dtw, const void* bias,
                     const void* A, const void* dsk, const void* state, const void* sumda,
                     const void* dy, void* dx, void* gcar, void* part, void* sums,
                     int B, int L, int D, int R, int T, int gx, cudaStream_t s) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  const TX* xt = static_cast<const TX*>(x);
  const TDY* dyt = static_cast<const TDY*>(dy);
  TX* dxt = static_cast<TX*>(dx);
#define WM_LAUNCH(RR)                                                                         \
  return launch<16, RR>(xt, f(wx), f(dtw), f(bias), f(A), f(dsk), f(state), f(sumda), dyt, dxt, \
                        m(gcar), m(part), m(sums), B, L, D, T, gx, s)
  switch (R) {
    case 1: WM_LAUNCH(1);
    case 2: WM_LAUNCH(2);
    case 3: WM_LAUNCH(3);
    case 4: WM_LAUNCH(4);
    default: return cudaErrorInvalidValue;
  }
#undef WM_LAUNCH
}

// out: threads a block, shared memory of bwd_local and bwd_main, and the
// blocks of each that the runtime lets reside on one SM.
template <int N, int R, typename TX, typename TDY>
cudaError_t occupancy(int T, int* out) {
  cudaError_t e = set_smem<N, R, TX, TDY>(T);
  if (e != cudaSuccess) return e;
  out[0] = kThreads;
  out[1] = (int)local_smem(N, R, T);
  out[2] = (int)main_smem(N, R, T);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, bwd_local<N, R, TX, TDY>, kThreads, out[1]);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 4, bwd_main<N, R, TX, TDY>, kThreads, out[2]);
}

template <typename TX, typename TDY>
cudaError_t occupancy_r(int R, int T, int* out) {
  switch (R) {
    case 1: return occupancy<16, 1, TX, TDY>(T, out);
    case 2: return occupancy<16, 2, TX, TDY>(T, out);
    case 3: return occupancy<16, 3, TX, TDY>(T, out);
    case 4: return occupancy<16, 4, TX, TDY>(T, out);
    default: return cudaErrorInvalidValue;
  }
}

// The stream dtypes a call takes: x, dy and dx float32 (0), all bf16 (1), or
// x and dx bf16 with float32 dy (2). float32 x with bf16 dy is refused: no
// preset or yml asks for it.
int stream_pair(int x_bf16, int dy_bf16) {
  if (!x_bf16) return dy_bf16 ? -1 : 0;
  return dy_bf16 ? 1 : 2;
}

}  // namespace

extern "C" {

// x (B, L, D) and dx (B, L, D), bf16 if x_bf16 else f32; dy (B, 2, L, D),
// bf16 if dy_bf16 else f32, one of the pairs `stream_pair` takes; wx (2, D,
// R+2N); dtw (2, R, D); bias, dsk (2, D); A (2, N, D); state (B, 2, nc, N, D)
// and sumda (B, 2, nc, D) as K1 left them, nc = ceil(L / T). Outputs: dx;
// sums (P, 2, D), P = (R+2N) + R + 1 + N + 1 rows [dwx | ddtw | dbias | dA |
// ddsk], each row (direction, channel).
// Scratch: gcar (B, 2, nc, N, D); part (gx, P, 2, D), gx <= B * nc the number
// of bwd_main's blocks, which stride over all the chunks. All but x, dy and dx
// f32; all contiguous, on the device of `stream`. Returns a cudaError_t; the
// caller has checked N == 16, 1 <= R <= 4, D <= 64 and T <= 64 a multiple of 8.
int ss2d_scan_pair_bwd(const void* x, const void* wx, const void* dtw,
                       const void* bias, const void* A, const void* dsk,
                       const void* state, const void* sumda, const void* dy,
                       void* dx, void* gcar, void* part, void* sums,
                       int B, int L, int D, int N, int R, int T, int gx,
                       int x_bf16, int dy_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N != 16 || D > kDMax || T % kSub != 0 || T > kTMax || gx < 1) return cudaErrorInvalidValue;
#define WM_ARGS x, wx, dtw, bias, A, dsk, state, sumda, dy, dx, gcar, part, sums, B, L, D, R, T, gx, s
  switch (stream_pair(x_bf16, dy_bf16)) {
    case 0: return launch_r<float, float>(WM_ARGS);
    case 1: return launch_r<__nv_bfloat16, __nv_bfloat16>(WM_ARGS);
    case 2: return launch_r<__nv_bfloat16, float>(WM_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef WM_ARGS
}

// The launch geometry on the current device for the stream pair (x_bf16,
// dy_bf16): out[0] threads a block (both kernels), out[1] / out[2] dynamic
// shared memory of bwd_local / bwd_main, out[3] / out[4] their resident
// blocks an SM as cudaOccupancyMaxActiveBlocksPerMultiprocessor reports them
// (registers included). Returns a cudaError_t.
int ss2d_scan_bwd_occupancy(int N, int R, int T, int x_bf16, int dy_bf16, int* out) {
  if (N != 16 || T % kSub != 0 || T > kTMax) return cudaErrorInvalidValue;
  switch (stream_pair(x_bf16, dy_bf16)) {
    case 0: return occupancy_r<float, float>(R, T, out);
    case 1: return occupancy_r<__nv_bfloat16, __nv_bfloat16>(R, T, out);
    case 2: return occupancy_r<__nv_bfloat16, float>(R, T, out);
    default: return cudaErrorInvalidValue;
  }
}

const char* ss2d_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
