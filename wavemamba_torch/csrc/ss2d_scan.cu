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
// What bounds it on an H100: per token and direction the kernel does the
// 2*D*(R+2N) flops of the projection and ~6 FMA-pipe flops per (n, d) of the
// recurrence, plus D*N + D exp(), against 4*D bytes of x read and 8*D bytes
// of y written. exp() runs on the special-function units, 16 per SM per
// clock against 128 FMAs. At the shipped widths (D=64, N=16, R=2) the 1,088
// exp() per token and direction take ~1.6x as long as the ~11 k FMA-pipe
// flops and ~2.3x as long as the bytes: the SFU bounds it.
//
// Design. One call holds only B*2*N*D scalar recurrences, far too few to fill
// 132 SMs, so the kernel is parallel over L in chunks of T tokens:
//   1. chunk_scan<false>: one block per (chunk, batch). Threads [0, D) run
//      direction 0, threads [D, 2D) direction 1, one channel d each with h[N]
//      in registers. The block stages its x tile in shared memory (read once
//      for both directions), computes x_dbl of both directions cooperatively,
//      and scans the chunk from h = 0. It writes the chunk's end state and its
//      sum of da (the chunk's decay is exp(A * sum da)).
//   2. chunk_prefix: for each (b, k, n, d), a prefix over the chunks in
//      processing order gives each chunk's entering state, written over the
//      end states. 32 workers split the chunks and combine in shared memory.
//   3. chunk_scan<true>: reruns every chunk from its entering state and
//      writes y + dsk * x in token order.
// The TPU kernel's antidiagonal-permutation reversal, two-direction lane
// packing and zero padding to whole chunks are TPU layout devices: here the
// reverse direction is index arithmetic and the last chunk is ragged.
// The exp() of the recurrence is computed twice (passes 1 and 3); halving
// that is work for a later version.
//
// Token streams in float32 or bf16 (the bf16 presets), x and y alike: x is
// widened as it is staged; y is written in the streams' dtype, rounded once
// from the float32 value (the TPU rounds the reverse member's y before it
// un-reverses it, which moves the same values). Weights, state and every operation stay
// float32. The tile is staged with coalesced element loads: a warp reads 64
// contiguous bf16 values (one 128-byte row at D = 64) per pass; the stream is
// a small share of the bytes next to the SFU's work.

#include <cuda_runtime.h>
#include <math.h>

#include "stream_dtype.cuh"

namespace {

constexpr int kRPad = 4;            // x_dbl row: [dt (R <= 4, padded) | B (N) | C (N)]
constexpr int kPrefixWorkers = 32;  // workers per lane in chunk_prefix

__device__ __forceinline__ float softplus(float v) {
  // torch.nn.functional.softplus (threshold 20): above it log1p(exp(v)) == v in f32.
  return v > 20.f ? v : log1pf(expf(v));
}

template <int N, int R, bool REPLAY, typename TS>
__global__ void __launch_bounds__(256) chunk_scan(
    const TS* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ dtw, const float* __restrict__ bias,
    const float* __restrict__ A, const float* __restrict__ dsk,
    float* __restrict__ state, float* __restrict__ sumda, TS* __restrict__ y,
    int L, int D, int T, int nc) {
  constexpr int J = R + 2 * N;        // projection width
  constexpr int JP = kRPad + 2 * N;   // padded x_dbl row, 16-byte aligned B and C
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xd = smem;                   // [2][T][JP] x_dbl of both directions
  float* xs = smem + 2 * T * JP;      // [T][D+1] x tile, padded row: conflict-free
  const int DP = D + 1;
  const int c = blockIdx.x, b = blockIdx.y;
  const int l0 = c * T;
  const int tc = min(T, L - l0);

  const TS* xb = x + ((size_t)b * L + l0) * D;
  for (int i = threadIdx.x; i < tc * D; i += blockDim.x) {
    xs[(i / D) * DP + i % D] = load_f32(xb + i);
  }
  __syncthreads();

  // x_dbl for every (direction, token) of the chunk: one row per thread pass.
  for (int p = threadIdx.x; p < 2 * tc; p += blockDim.x) {
    const int k = p / tc, t = p - k * tc;
    const float* w = wx + (size_t)k * D * J;
    const float* xr = xs + t * DP;
    float acc[J];
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float xv = xr[d];
#pragma unroll
      for (int j = 0; j < J; ++j) acc[j] = fmaf(xv, __ldg(w + d * J + j), acc[j]);
    }
    float* o = xd + (k * T + t) * JP;
#pragma unroll
    for (int j = 0; j < R; ++j) o[j] = acc[j];
#pragma unroll
    for (int j = 0; j < 2 * N; ++j) o[kRPad + j] = acc[R + j];
  }
  __syncthreads();

  const int k = threadIdx.x / D, d = threadIdx.x - k * D;
  float An[N], h[N], wdt[R];
#pragma unroll
  for (int n = 0; n < N; ++n) An[n] = A[((size_t)k * N + n) * D + d];
#pragma unroll
  for (int r = 0; r < R; ++r) wdt[r] = dtw[((size_t)k * R + r) * D + d];
  const float bk = bias[k * D + d];
  const float dk = dsk[k * D + d];
  const size_t ci = ((size_t)b * 2 + k) * nc + c;  // (b, k, chunk)
  float* st = state + ci * N * D + d;
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = REPLAY ? st[(size_t)n * D] : 0.f;
  TS* yb = y + (((size_t)b * 2 + k) * L + l0) * D + d;
  float sda = 0.f;

  for (int s = 0; s < tc; ++s) {
    const int t = k == 0 ? s : tc - 1 - s;
    const float* q = xd + (k * T + t) * JP;
    float dt = bk;
#pragma unroll
    for (int r = 0; r < R; ++r) dt = fmaf(q[r], wdt[r], dt);
    const float da = softplus(dt);
    const float u = xs[t * DP + d];
    const float du = da * u;
    const float4* bq = reinterpret_cast<const float4*>(q + kRPad);
    const float4* cq = reinterpret_cast<const float4*>(q + kRPad + N);
    float acc = 0.f;
#pragma unroll
    for (int n4 = 0; n4 < N / 4; ++n4) {
      const float4 bv = bq[n4];
      const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
      float cs[4];
      if (REPLAY) {
        const float4 cv = cq[n4];
        cs[0] = cv.x; cs[1] = cv.y; cs[2] = cv.z; cs[3] = cv.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 4 * n4 + i;
        h[n] = fmaf(expf(da * An[n]), h[n], du * bs[i]);
        if (REPLAY) acc = fmaf(cs[i], h[n], acc);
      }
    }
    if (REPLAY) {
      store_f32(yb + (size_t)t * D, fmaf(dk, u, acc));
    } else {
      sda += da;
    }
  }
  if (!REPLAY) {
#pragma unroll
    for (int n = 0; n < N; ++n) st[(size_t)n * D] = h[n];
    sumda[ci * D + d] = sda;
  }
}

// Entering state of every chunk, in place of its end state. Lane = one
// (n, d); the chunks of a (b, k) are split among kPrefixWorkers workers.
__global__ void __launch_bounds__(32 * kPrefixWorkers) chunk_prefix(
    const float* __restrict__ A, float* __restrict__ state,
    const float* __restrict__ sumda, int ND, int D, int nc) {
  __shared__ float agg_a[kPrefixWorkers][32];
  __shared__ float agg_h[kPrefixWorkers][32];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int nd = blockIdx.x * 32 + lane;
  const int k = blockIdx.y, b = blockIdx.z;
  const bool valid = nd < ND;
  const int d = nd % D;
  const float a_nd = valid ? A[(size_t)k * ND + nd] : 0.f;
  const size_t base = ((size_t)b * 2 + k) * nc;
  const int seg = (nc + kPrefixWorkers - 1) / kPrefixWorkers;
  const int p0 = min(nc, w * seg), p1 = min(nc, p0 + seg);

  float pa = 1.f, ph = 0.f;  // this worker's segment as one transition
  if (valid) {
    for (int p = p0; p < p1; ++p) {
      const size_t ci = base + (k == 0 ? p : nc - 1 - p);
      const float a = expf(a_nd * sumda[ci * D + d]);
      ph = fmaf(a, ph, state[ci * ND + nd]);
      pa *= a;
    }
  }
  agg_a[w][lane] = pa;
  agg_h[w][lane] = ph;
  __syncthreads();
  if (!valid) return;

  float hc = 0.f;  // state entering this worker's first chunk
  for (int v = 0; v < w; ++v) hc = fmaf(agg_a[v][lane], hc, agg_h[v][lane]);
  for (int p = p0; p < p1; ++p) {
    const size_t ci = base + (k == 0 ? p : nc - 1 - p);
    const float a = expf(a_nd * sumda[ci * D + d]);
    const float he = state[ci * ND + nd];
    state[ci * ND + nd] = hc;
    hc = fmaf(a, hc, he);
  }
}

template <int N, int R, typename TS>
cudaError_t launch(const TS* x, const float* wx, const float* dtw,
                   const float* bias, const float* A, const float* dsk,
                   TS* y, float* state, float* sumda,
                   int B, int L, int D, int T, cudaStream_t stream) {
  const int nc = (L + T - 1) / T;
  const size_t smem = sizeof(float) * ((size_t)2 * T * (kRPad + 2 * N) + (size_t)T * (D + 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(chunk_scan<N, R, false, TS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(chunk_scan<N, R, true, TS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(nc, B);
  chunk_scan<N, R, false, TS><<<grid, 2 * D, smem, stream>>>(
      x, wx, dtw, bias, A, dsk, state, sumda, y, L, D, T, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 pgrid((N * D + 31) / 32, 2, B), pblock(32, kPrefixWorkers);
  chunk_prefix<<<pgrid, pblock, 0, stream>>>(A, state, sumda, N * D, D, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chunk_scan<N, R, true, TS><<<grid, 2 * D, smem, stream>>>(
      x, wx, dtw, bias, A, dsk, state, sumda, y, L, D, T, nc);
  return cudaGetLastError();
}

template <typename TS>
cudaError_t launch_r(const void* x, const void* wx, const void* dtw, const void* bias,
                     const void* A, const void* dsk, void* y, void* state, void* sumda,
                     int B, int L, int D, int R, int T, cudaStream_t s) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  const TS* xt = static_cast<const TS*>(x);
  TS* yt = static_cast<TS*>(y);
  switch (R) {
    case 1: return launch<16, 1>(xt, f(wx), f(dtw), f(bias), f(A), f(dsk), yt, m(state), m(sumda), B, L, D, T, s);
    case 2: return launch<16, 2>(xt, f(wx), f(dtw), f(bias), f(A), f(dsk), yt, m(state), m(sumda), B, L, D, T, s);
    case 3: return launch<16, 3>(xt, f(wx), f(dtw), f(bias), f(A), f(dsk), yt, m(state), m(sumda), B, L, D, T, s);
    case 4: return launch<16, 4>(xt, f(wx), f(dtw), f(bias), f(A), f(dsk), yt, m(state), m(sumda), B, L, D, T, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (B, L, D) and y (B, 2, L, D), both bf16 if bf16 else both f32; wx (2, D,
// R+2N); dtw (2, R, D); bias, dsk (2, D); A (2, N, D); scratch:
// state (B, 2, nc, N, D), sumda (B, 2, nc, D) with nc = ceil(L / T). All but
// x and y f32; all contiguous, on the device of `stream`. Returns a
// cudaError_t; the caller has checked N == 16, 1 <= R <= 4 and 2 * D <= 256.
int ss2d_scan_pair(const void* x, const void* wx, const void* dtw,
                   const void* bias, const void* A, const void* dsk,
                   void* y, void* state, void* sumda,
                   int B, int L, int D, int N, int R, int T, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N != 16) return cudaErrorInvalidValue;
  if (bf16) return launch_r<__nv_bfloat16>(x, wx, dtw, bias, A, dsk, y, state, sumda, B, L, D, R, T, s);
  return launch_r<float>(x, wx, dtw, bias, A, dsk, y, state, sumda, B, L, D, R, T, s);
}

const char* ss2d_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
