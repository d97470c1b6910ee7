// K1 on Hopper: the fused SS2D projection + selective scan of one direction pair.
//
// Replaces the TPU kernel `wavemamba_tpu/ops/scan_pallas.py:_fused_kernel`
// (`ss2d_scan_fused`, variant 'twopass'). For each direction k of the pair
// (k = 0 scans the tokens forward, k = 1 in reverse; both write y in token
// order), with f32 state:
//   x_dbl_t = x_t . wx[k]                                   (D -> R + 2N)
//   da_t    = softplus(x_dbl_t[:R] . dtw[k] + bias[k])
//   h_t     = exp(da_t * A[k]) * h_{t-1} + da_t * x_t * B_t   (h: N x D)
//   y_t     = sum_n C_t[n] * h_t[n] + dsk[k] * x_t
// where B_t = x_dbl_t[R:R+N] and C_t = x_dbl_t[R+N:].
//
// What bounds it on an H100 (`chip_smoke.py:k1_bound`): the special-function
// units. Per token and direction the recurrence needs N*D exp (16 per SM per
// clock against 128 FMA lanes), ~1.6x the time of the ~11 k FMA-pipe flops of
// the projection and recurrence and ~2.3x that of x read and y written: 0.287
// ms at a 1080p forward's level 1 (552,960 tokens). That bound counts each exp
// once. A design parallel over L cannot: the replay's correction of a chunk by
// the state entering it, C . (exp(A cumsum(da)) h_enter), costs the same exp
// per (n, d, token) as the recurrence itself. So the design floor is two SFU
// passes over the tokens, ~0.57 ms at level 1.
//
// Design. One call holds only B*2*N*D scalar recurrences, far too few to fill
// 132 SMs, so the kernel is parallel over L in chunks of T <= 64 tokens:
//   1. chunk_scan<false>: one block per (chunk, batch, 64-channel group), both
//      directions. The block stages its x tile and wx in shared memory,
//      computes x_dbl of both directions (a thread takes 4 tokens by 5
//      columns, 9 float4 loads for 80 FMAs), writes it to the scratch `xdbl`
//      for the replay, computes da of every (direction, token, channel) in
//      parallel, and scans the chunk from h = 0. It writes the chunk's end
//      state and its sum of da (the chunk's decay is exp(A * sum da)).
//   2. chunk_prefix: for each (b, k, n, d), a prefix over the chunks in
//      processing order gives each chunk's entering state, written over the
//      end states. A block holds 16 lanes; 64 workers a lane each take a run
//      of chunks, loading 16 chunks' values before they use them, and the
//      runs' transitions are combined in worker order.
//   3. chunk_scan<true>: reads the chunk's x_dbl back, reruns the chunk from
//      its entering state and writes y + dsk * x in token order.
// A quad of threads holds two adjacent channels of one direction, four of the
// 16 states each (256 threads a block): a token's B and C, read from shared
// memory once a thread, serve 8 states, so the shared-memory traffic a state
// stays under the SFU's time. y's sums over n are two xor-shuffles in the
// quad that leave each of the pair's sums on its own lanes, a fixed order:
// the same inputs give the same bits. A decay is one ex2.approx.ftz of
// da * (A log2 e). The token loop walks its rows by pointer steps, so that a
// token costs ~64 instructions a warp in the replay (45 in pass 1) against
// the 64 cycles its 8 ex2 take on the SFU.
// A block takes ~68 KB of shared memory, so three reside on an SM (24 warps),
// as `ops/scan_cuda.py:k1_plan` computes; the launch refuses other sums.
// The TPU kernel's antidiagonal-permutation reversal, two-direction lane
// packing and zero padding to whole chunks are TPU layout devices: here the
// reverse direction is index arithmetic and the last chunk is ragged.
//
// Token streams in float32 or bf16: x of type TX is widened as it is staged;
// y of type TY is written rounded once from the float32 value (the TPU rounds
// the reverse member's y before it un-reverses it, which moves the same
// values). Three pairs are built: (float32, float32) for the parity route,
// (bf16, bf16) for the bf16 presets, and (bf16, float32) for
// `compute_dtype: bfloat16` with the default `scan_dtype: float32`, as the
// proc ymls train. Weights, state, the scratch and every operation stay
// float32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stream_dtype.cuh"

namespace {

constexpr int kRPad = 4;        // x_dbl row: [dt (R <= 4, padded) | B (N) | C (N)]
constexpr int kGroup = 64;      // channels a block scans; D <= 128 takes two groups
constexpr int kQuad = 4;        // threads per channel pair: N / 4 states each
constexpr int kPairs = kGroup / 2;
constexpr int kThreads = 2 * kPairs * kQuad;  // 256, both directions
constexpr int kScanBlocks = 3;  // resident blocks an SM the launch bounds ask for
constexpr int kTMax = 64;       // tokens a chunk holds; the projection tiles 16 x 4 of them
constexpr int kPrefixLanes = 16;     // (n, d) lanes a chunk_prefix block holds
constexpr int kPrefixWorkers = 64;   // workers a lane, each a run of chunks
constexpr int kPrefixThreads = kPrefixLanes * kPrefixWorkers;
constexpr int kBatch = 16;           // chunks a chunk_prefix worker loads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;  // exp(v) = exp2(v log2 e)

// 2^v in one SFU instruction. Results below 2^-126 flush to zero: far below
// what the float32 sums they enter can resolve.
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// torch.nn.functional.softplus (threshold 20): above it log1p(exp(v)) == v in
// f32. log1pf keeps da's relative precision where da is small, as it is in a
// freshly initialised model (dt 0.001-0.1). lg2.approx of 1 + e has an
// absolute error of ~2^-22 instead, which moved the whole model's gradients
// 4x further from the plain route's.
__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// Row width of the x tile and of the staged wx: every channel of the block's
// groups, zero beyond D, and 4 more, so that rows 4 floats apart fall on
// other banks for the float4 loads.
__host__ __device__ constexpr int tile_width(int D) {
  return kGroup * ((D + kGroup - 1) / kGroup) + 4;
}

// Shared memory of chunk_scan (both passes): the x tile [T][W], x_dbl
// [2][T][JP], and a region that holds wx [2][J][W] (pass 1, until x_dbl is
// made) and then da [2][T][kGroup].
__host__ __device__ constexpr int scan_smem_floats(int D, int N, int R, int T) {
  return T * tile_width(D) + 2 * T * (kRPad + 2 * N) +
         (2 * (R + 2 * N) * tile_width(D) > 2 * T * kGroup ? 2 * (R + 2 * N) * tile_width(D)
                                                            : 2 * T * kGroup);
}

// Four consecutive stream values, widened: 16 bytes of float32 or 8 of bf16.
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Zero the columns [D, W) of `rows` rows of width W.
__device__ __forceinline__ void zero_pad(float* rowsp, int rows, int D, int W) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    for (int d = D; d < W; ++d) rowsp[r * W + d] = 0.f;
  }
}

// The x tile [T][W] from token l0 of batch b, zero beyond D: four channels a
// thread where D is a multiple of 4 (rows then start 16 or 8 bytes aligned).
template <typename TX>
__device__ __forceinline__ void stage_x(const TX* __restrict__ xb, float* xs, int tc, int D, int W) {
  if ((D & 3) == 0) {
    const int D4 = D >> 2;
    for (int i = threadIdx.x; i < tc * D4; i += kThreads) {
      const int t = i / D4, c = 4 * (i - t * D4);
      *reinterpret_cast<float4*>(xs + t * W + c) = load4(xb + (size_t)t * D + c);
    }
  } else {
    for (int i = threadIdx.x; i < tc * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      xs[t * W + d] = load_f32(xb + i);
    }
  }
  zero_pad(xs, tc, D, W);
}

// x_dbl of both directions for the chunk's tokens into xd [2][T][JP], from the
// x tile and wx staged as [2][J][W]. A thread takes 4 tokens (tq + 16i) by 5
// columns (g + 8m) of direction k, over all channels, 4 at a time: 9 float4
// loads for 80 FMAs.
template <int N, int R>
__device__ __forceinline__ void project(const float* xs, const float* wxs, float* xd, int tc,
                                        int D, int W, int T) {
  constexpr int J = R + 2 * N;
  constexpr int JP = kRPad + 2 * N;
  constexpr int MG = (J + 7) / 8;
  const int g = threadIdx.x & 7, tq = (threadIdx.x >> 3) & 15, k = threadIdx.x >> 7;
  const float* w = wxs + (k * J + g) * W;
  int row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) row[i] = min(tq + 16 * i, tc - 1) * W;
  float acc[4][MG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < MG; ++m) acc[i][m] = 0.f;
  for (int d = 0; d < D; d += 4) {
    float4 xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = *reinterpret_cast<const float4*>(xs + row[i] + d);
#pragma unroll
    for (int m = 0; m < MG; ++m) {
      if (g + 8 * m < J) {
        const float4 wv = *reinterpret_cast<const float4*>(w + 8 * m * W + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = acc[i][m];
          a = fmaf(xv[i].x, wv.x, a);
          a = fmaf(xv[i].y, wv.y, a);
          a = fmaf(xv[i].z, wv.z, a);
          acc[i][m] = fmaf(xv[i].w, wv.w, a);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tq + 16 * i;
    float* o = xd + (k * T + t) * JP;
#pragma unroll
    for (int m = 0; m < MG; ++m) {
      const int j = g + 8 * m;
      if (j < J && t < tc) o[j < R ? j : kRPad + j - R] = acc[i][m];
    }
  }
}

// da of every (direction, token, channel of the group) into das [2][T][kGroup],
// zero beyond D. A thread takes channel threadIdx.x % kGroup, whose dt weights
// and bias of both directions it holds in wdt2 and bias2, every fourth token.
template <int R, int JP>
__device__ __forceinline__ void prepare_da(const float* xd, const float (&wdt2)[2][R],
                                           const float (&bias2)[2], float* das, int tc, int T,
                                           bool on) {
  constexpr int kRows = kThreads / kGroup;
  const int dl = threadIdx.x % kGroup, t0 = threadIdx.x / kGroup;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float* q = xd + (k * T + t0) * JP;
    float* o = das + (k * T + t0) * kGroup + dl;
    for (int t = t0; t < tc; t += kRows, q += kRows * JP, o += kRows * kGroup) {
      float dt = bias2[k];
#pragma unroll
      for (int r = 0; r < R; ++r) dt = fmaf(q[r], wdt2[k][r], dt);
      *o = on ? softplus(dt) : 0.f;
    }
  }
}

template <int N, int R, bool REPLAY, typename TX, typename TY>
__global__ void __launch_bounds__(kThreads, kScanBlocks) chunk_scan(
    const TX* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ dtw, const float* __restrict__ bias,
    const float* __restrict__ A, const float* __restrict__ dsk,
    float* __restrict__ state, float* __restrict__ sumda, float* __restrict__ xdbl,
    TY* __restrict__ y, int L, int D, int T, int nc) {
  constexpr int J = R + 2 * N;
  constexpr int JP = kRPad + 2 * N;
  constexpr int NQ = N / kQuad;
  static_assert(NQ == 4, "a thread holds 4 states of each of its 2 channels");
  extern __shared__ float4 smem4[];
  const int W = tile_width(D);
  float* xs = reinterpret_cast<float*>(smem4);  // [T][W] x
  float* xd = xs + T * W;                       // [2][T][JP] x_dbl
  float* wxs = xd + 2 * T * JP;                 // [2][J][W] wx, then
  float* das = wxs;                             // [2][T][kGroup] da
  const int c = blockIdx.x, b = blockIdx.y, g0 = blockIdx.z * kGroup;
  const int l0 = c * T;
  const int tc = min(T, L - l0);
  const int tid = threadIdx.x;

  // The dt weights and bias of channel g0 + tid % kGroup, both directions.
  const int dp = g0 + (tid & (kGroup - 1));
  float wdt2[2][R], bias2[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    bias2[k] = dp < D ? bias[k * D + dp] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) wdt2[k][r] = dp < D ? dtw[((size_t)k * R + r) * D + dp] : 0.f;
  }

  stage_x(x + ((size_t)b * L + l0) * D, xs, tc, D, W);
  float* xg = xdbl + ((size_t)b * 2 * L + l0) * JP;  // direction k's tile at + k * L * JP
  constexpr int JP4 = JP / 4;
  if (!REPLAY) {
    // wx (2, D, J) in 16-byte loads, each value to column d of row (k, j).
    const unsigned DJ = D * J, n4 = 2 * DJ / 4;
    auto put = [&](unsigned e, float v) {
      const unsigned k = e >= DJ;
      wxs[(k * J + e % J) * W + e / J - k * D] = v;
    };
    for (unsigned i = tid; i < n4; i += kThreads) {
      const float4 v = reinterpret_cast<const float4*>(wx)[i];
      put(4 * i, v.x);
      put(4 * i + 1, v.y);
      put(4 * i + 2, v.z);
      put(4 * i + 3, v.w);
    }
    for (unsigned e = 4 * n4 + tid; e < 2 * DJ; e += kThreads) put(e, wx[e]);
    zero_pad(wxs, 2 * J, D, W);
    __syncthreads();
    project<N, R>(xs, wxs, xd, tc, D, W, T);
    __syncthreads();
    if (blockIdx.z == 0) {  // x_dbl for the replay
      for (int i = tid; i < 2 * tc * JP4; i += kThreads) {
        const int k = i >= tc * JP4, e = i - k * tc * JP4;
        reinterpret_cast<float4*>(xg + (size_t)k * L * JP)[e] =
            reinterpret_cast<const float4*>(xd + k * T * JP)[e];
      }
    }
  } else {
    for (int i = tid; i < 2 * tc * JP4; i += kThreads) {
      const int k = i >= tc * JP4, e = i - k * tc * JP4;
      reinterpret_cast<float4*>(xd + k * T * JP)[e] =
          reinterpret_cast<const float4*>(xg + (size_t)k * L * JP)[e];
    }
    __syncthreads();
  }
  prepare_da<R, JP>(xd, wdt2, bias2, das, tc, T, dp < D);
  __syncthreads();

  // Direction k, channels g0 + 2p and g0 + 2p + 1, states 4q .. 4q + 3.
  const int k = tid >> 7, q = tid & 3, p = (tid >> 2) & (kPairs - 1);
  const int dl = 2 * p;
  const size_t ci = ((size_t)b * 2 + k) * nc + c;  // (b, k, chunk)
  float An[2][NQ], h[2][NQ], dk[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int d = g0 + dl + e;
    const bool on = d < D;
    dk[e] = on ? dsk[k * D + d] : 0.f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const size_t n = kQuad * q + i;
      An[e][i] = on ? A[((size_t)k * N + n) * D + d] * kLog2e : 0.f;
      h[e][i] = REPLAY && on ? state[(ci * N + n) * D + d] : 0.f;
    }
  }
  const bool writer = q < 2 && g0 + dl + (q & 1) < D;
  float sda[2] = {0.f, 0.f};
  // Token t0 first, then one row on (forward) or back (reverse) a token.
  const int t0 = k == 0 ? 0 : tc - 1, dir = k == 0 ? 1 : -1;
  const float* dap = das + (k * T + t0) * kGroup + dl;
  const float* up = xs + t0 * W + g0 + dl;
  const float* xq = xd + (k * T + t0) * JP + kRPad + kQuad * q;
  TY* yp = y + (((size_t)b * 2 + k) * L + l0 + t0) * D + g0 + dl + (q & 1);
  const int dstep = dir * kGroup, ustep = dir * W, xstep = dir * JP, ystep = dir * D;

#pragma unroll 2
  for (int s = 0; s < tc; ++s) {
    const float2 da = *reinterpret_cast<const float2*>(dap);
    const float2 u = *reinterpret_cast<const float2*>(up);
    const float4 bv = *reinterpret_cast<const float4*>(xq);
    const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
    const float du0 = da.x * u.x, du1 = da.y * u.y;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      h[0][i] = fmaf(ex2(da.x * An[0][i]), h[0][i], du0 * bs[i]);
      h[1][i] = fmaf(ex2(da.y * An[1][i]), h[1][i], du1 * bs[i]);
    }
    if (REPLAY) {
      const float4 cv = *reinterpret_cast<const float4*>(xq + N);
      const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        a0 = fmaf(cs[i], h[0][i], a0);
        a1 = fmaf(cs[i], h[1][i], a1);
      }
      // Lanes q = 0, 2 end with channel 0's sum over the quad, q = 1, 3 with
      // channel 1's; the two lanes of a channel add the same pairs.
      const bool odd = q & 1;
      float sum = (odd ? a1 : a0) + __shfl_xor_sync(kFull, odd ? a0 : a1, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      const float yv = fmaf(odd ? dk[1] : dk[0], odd ? u.y : u.x, sum);
      if (writer) store_f32(yp, yv);
      yp += ystep;
    } else {
      sda[0] += da.x;
      sda[1] += da.y;
    }
    dap += dstep;
    up += ustep;
    xq += xstep;
  }
  if (!REPLAY) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = g0 + dl + e;
      if (d >= D) continue;
#pragma unroll
      for (int i = 0; i < NQ; ++i) state[(ci * N + kQuad * q + i) * D + d] = h[e][i];
      if (q == 0) sumda[ci * D + d] = sda[e];
    }
  }
}

// Entering state of every chunk, in place of its end state. Lane = one
// (n, d); the chunks of a (b, k) are split among kPrefixWorkers workers, each
// a run of consecutive chunks in processing order, whose transitions are
// combined in worker order.
__global__ void __launch_bounds__(kPrefixThreads) chunk_prefix(
    const float* __restrict__ A, float* __restrict__ state,
    const float* __restrict__ sumda, int ND, int D, int nc) {
  __shared__ float agg_a[kPrefixWorkers][kPrefixLanes];
  __shared__ float agg_h[kPrefixWorkers][kPrefixLanes];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int nd = blockIdx.x * kPrefixLanes + lane;
  const int k = blockIdx.y, b = blockIdx.z;
  const bool valid = nd < ND;
  const int d = nd % D;
  const float a_nd = valid ? A[(size_t)k * ND + nd] * kLog2e : 0.f;
  const int seg = (nc + kPrefixWorkers - 1) / kPrefixWorkers;
  const int p0 = min(nc, w * seg), n = min(nc, p0 + seg) - p0;
  // The run's first chunk, and one chunk on in processing order.
  const size_t c0 = ((size_t)b * 2 + k) * nc + (k == 0 ? p0 : nc - 1 - p0);
  const ptrdiff_t dir = k == 0 ? 1 : -1, sstep = dir * D, hstep = dir * ND;
  const float* sp = sumda + c0 * D + d;
  float* hp = state + c0 * ND + nd;

  float pa = 1.f, ph = 0.f;  // this worker's run of chunks as one transition
  if (valid) {
    const float* s = sp;
    const float* h = hp;
    for (int i = 0; i < n; i += kBatch, s += kBatch * sstep, h += kBatch * hstep) {
      float a[kBatch], he[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool in = i + u < n;
        a[u] = in ? ex2(a_nd * s[u * sstep]) : 1.f;
        he[u] = in ? h[u * hstep] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        ph = fmaf(a[u], ph, he[u]);
        pa *= a[u];
      }
    }
  }
  agg_a[w][lane] = pa;
  agg_h[w][lane] = ph;
  __syncthreads();
  if (!valid) return;

  float hc = 0.f;  // state entering this worker's first chunk
  for (int v = 0; v < w; ++v) hc = fmaf(agg_a[v][lane], hc, agg_h[v][lane]);
  for (int i = 0; i < n; i += kBatch, sp += kBatch * sstep, hp += kBatch * hstep) {
    float a[kBatch], he[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool in = i + u < n;
      a[u] = in ? ex2(a_nd * sp[u * sstep]) : 1.f;
      he[u] = in ? hp[u * hstep] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i + u < n) {
        hp[u * hstep] = hc;
        hc = fmaf(a[u], hc, he[u]);
      }
    }
  }
}

template <int N, int R, typename TX, typename TY>
cudaError_t set_smem(int D, int T) {
  const int smem = (int)sizeof(float) * scan_smem_floats(D, N, R, T);
  cudaError_t e = cudaFuncSetAttribute(chunk_scan<N, R, false, TX, TY>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(chunk_scan<N, R, true, TX, TY>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int N, int R, typename TX, typename TY>
cudaError_t launch(const TX* x, const float* wx, const float* dtw,
                   const float* bias, const float* A, const float* dsk,
                   TY* y, float* state, float* sumda, float* xdbl,
                   int B, int L, int D, int T, cudaStream_t stream) {
  const int nc = (L + T - 1) / T;
  const size_t smem = sizeof(float) * scan_smem_floats(D, N, R, T);
  cudaError_t e = set_smem<N, R, TX, TY>(D, T);
  if (e != cudaSuccess) return e;
  const dim3 grid(nc, B, (D + kGroup - 1) / kGroup);
  chunk_scan<N, R, false, TX, TY><<<grid, kThreads, smem, stream>>>(
      x, wx, dtw, bias, A, dsk, state, sumda, xdbl, y, L, D, T, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 pgrid((N * D + kPrefixLanes - 1) / kPrefixLanes, 2, B);
  chunk_prefix<<<pgrid, dim3(kPrefixLanes, kPrefixWorkers), 0, stream>>>(A, state, sumda, N * D, D, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chunk_scan<N, R, true, TX, TY><<<grid, kThreads, smem, stream>>>(
      x, wx, dtw, bias, A, dsk, state, sumda, xdbl, y, L, D, T, nc);
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t launch_r(const void* x, const void* wx, const void* dtw, const void* bias,
                     const void* A, const void* dsk, void* y, void* state, void* sumda,
                     void* xdbl, int B, int L, int D, int R, int T, cudaStream_t s) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  const TX* xt = static_cast<const TX*>(x);
  TY* yt = static_cast<TY*>(y);
#define WM_LAUNCH(RR) \
  return launch<16, RR>(xt, f(wx), f(dtw), f(bias), f(A), f(dsk), yt, m(state), m(sumda), m(xdbl), B, L, D, T, s)
  switch (R) {
    case 1: WM_LAUNCH(1);
    case 2: WM_LAUNCH(2);
    case 3: WM_LAUNCH(3);
    case 4: WM_LAUNCH(4);
    default: return cudaErrorInvalidValue;
  }
#undef WM_LAUNCH
}

// out: threads a block and dynamic shared memory of chunk_scan, the blocks of
// chunk_scan<false> and chunk_scan<true> that the runtime lets reside on one
// SM, then threads a block and resident blocks of chunk_prefix.
template <int N, int R, typename TX, typename TY>
cudaError_t occupancy(int D, int T, int* out) {
  cudaError_t e = set_smem<N, R, TX, TY>(D, T);
  if (e != cudaSuccess) return e;
  out[0] = kThreads;
  out[1] = (int)sizeof(float) * scan_smem_floats(D, N, R, T);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, chunk_scan<N, R, false, TX, TY>, kThreads, out[1]);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, chunk_scan<N, R, true, TX, TY>, kThreads, out[1]);
  if (e != cudaSuccess) return e;
  out[4] = kPrefixThreads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 5, chunk_prefix, kPrefixThreads, 0);
}

template <typename TX, typename TY>
cudaError_t occupancy_r(int R, int D, int T, int* out) {
  switch (R) {
    case 1: return occupancy<16, 1, TX, TY>(D, T, out);
    case 2: return occupancy<16, 2, TX, TY>(D, T, out);
    case 3: return occupancy<16, 3, TX, TY>(D, T, out);
    case 4: return occupancy<16, 4, TX, TY>(D, T, out);
    default: return cudaErrorInvalidValue;
  }
}

bool takes(int N, int R, int D, int T) {
  return N == 16 && R >= 1 && R <= 4 && D >= 1 && D <= 2 * kGroup && T >= 4 && T <= kTMax && T % 4 == 0;
}

// The stream dtypes a call takes: x and y float32 (0), both bf16 (1), or x
// bf16 and y float32 (2). float32 x with bf16 y is refused: no preset or yml
// asks for it.
int stream_pair(int x_bf16, int y_bf16) {
  if (!x_bf16) return y_bf16 ? -1 : 0;
  return y_bf16 ? 1 : 2;
}

}  // namespace

extern "C" {

// x (B, L, D) and y (B, 2, L, D), each bf16 if x_bf16 / y_bf16 else f32, one
// of the pairs `stream_pair` takes; wx (2, D, R+2N); dtw (2, R, D);
// bias, dsk (2, D); A (2, N, D); outputs beside y: state (B, 2, nc, N, D),
// sumda (B, 2, nc, D) with nc = ceil(L / T); scratch: xdbl (B, 2, L, 4 + 2N).
// All but x and y f32; all contiguous, on the device of `stream`; x and wx
// start on a 16-byte boundary. `smem` is the dynamic shared memory the caller
// planned for chunk_scan: the launch is refused unless it is this source's.
// Takes N == 16, 1 <= R <= 4, D <= 128 and T <= 64 a multiple of 4. Returns a
// cudaError_t.
int ss2d_scan_pair(const void* x, const void* wx, const void* dtw,
                   const void* bias, const void* A, const void* dsk,
                   void* y, void* state, void* sumda, void* xdbl,
                   int B, int L, int D, int N, int R, int T, int smem, int x_bf16, int y_bf16,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!takes(N, R, D, T) || smem != (int)sizeof(float) * scan_smem_floats(D, N, R, T)) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wx) % 16) {
    return cudaErrorMisalignedAddress;
  }
#define WM_ARGS x, wx, dtw, bias, A, dsk, y, state, sumda, xdbl, B, L, D, R, T, s
  switch (stream_pair(x_bf16, y_bf16)) {
    case 0: return launch_r<float, float>(WM_ARGS);
    case 1: return launch_r<__nv_bfloat16, __nv_bfloat16>(WM_ARGS);
    case 2: return launch_r<__nv_bfloat16, float>(WM_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef WM_ARGS
}

// The launch geometry on the current device for the stream pair (x_bf16,
// y_bf16): out[0] threads a block of chunk_scan, out[1] its dynamic shared
// memory, out[2] / out[3] the resident blocks an SM of pass 1 / the replay,
// out[4] threads a block of chunk_prefix, out[5] its resident blocks an SM, as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor reports them (registers
// included). Returns a cudaError_t.
int ss2d_scan_occupancy(int N, int R, int D, int T, int x_bf16, int y_bf16, int* out) {
  if (!takes(N, R, D, T)) return cudaErrorInvalidValue;
  switch (stream_pair(x_bf16, y_bf16)) {
    case 0: return occupancy_r<float, float>(R, D, T, out);
    case 1: return occupancy_r<__nv_bfloat16, __nv_bfloat16>(R, D, T, out);
    case 2: return occupancy_r<__nv_bfloat16, float>(R, D, T, out);
    default: return cudaErrorInvalidValue;
  }
}

const char* ss2d_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
