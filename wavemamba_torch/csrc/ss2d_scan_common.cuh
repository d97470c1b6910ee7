// Device code shared by K1 (ss2d_scan.cu) and K5 (ss2d_scan_ssd.cu): the
// constants of their layout, the staging of a chunk (x tile, projection to
// x_dbl, da), the chunk prefix, and what a call may take. Both kernels run a
// block per (chunk of T <= 64 tokens, batch element, 64-channel group), both
// directions, a quad of threads per channel pair; `ss2d_scan.cu`'s note says
// why.

#pragma once

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

// Shared memory of chunk_scan and chunk_scan_ssd (both passes): the x tile
// [T][W], x_dbl [2][T][JP], and a region that holds wx [2][J][W] (pass 1,
// until x_dbl is made) and then da [2][T][kGroup].
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

// The chunk's tiles in shared memory, for chunk l0 / T of batch b and the
// channel group from g0, in both passes: the x tile xs [T][W] (zero beyond D),
// x_dbl of both directions xd [2][T][JP], which pass 1 projects from wx staged
// in `wxs` and leaves in the scratch `xdbl` for the replay to read back, and da
// [2][T][kGroup] over `wxs`. Ends with the block synchronised.
template <int N, int R, bool REPLAY, typename TX>
__device__ __forceinline__ void stage_chunk(
    const TX* __restrict__ x, const float* __restrict__ wx, const float* __restrict__ dtw,
    const float* __restrict__ bias, float* __restrict__ xdbl, float* xs, float* xd, float* wxs,
    int b, int l0, int tc, int g0, int L, int D, int T, int W) {
  constexpr int J = R + 2 * N;
  constexpr int JP = kRPad + 2 * N;
  float* das = wxs;
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
