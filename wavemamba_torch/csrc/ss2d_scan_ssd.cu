// K5 on Hopper: the fused SS2D projection + selective scan of one direction
// pair, the recurrence evaluated in the segment-local (SSD) factorization.
//
// Replaces the TPU kernel `wavemamba_tpu/ops/scan_pallas.py:_fused_kernel_ssd`
// (`ss2d_scan_fused(variant='ssd')`). K1's contract (ss2d_scan.cu): the same
// inputs, the same y, the same carries. Within each segment of S tokens, in
// processing order (k = 0 forward, k = 1 in reverse), with f32 state:
//   clocal_t = sum of da over the segment up to t   (inclusive)
//   G_t      = exp(clocal_t * A)                    (n, d)
//   bhat_t   = (da_t * u_t * B_t) / G_t             a divide, not exp(-m)
//   cums_t   = sum of bhat over the segment up to t
//   h_t      = G_t * (H + cums_t),  H the state entering the segment
//   y_t      = sum_n C_t[n] * h_t[n] + dsk * u_t
// and the segment hands on h at its last token, G_last * (H + cums_last).
// Mathematically h_t is K1's; the rounding differs. f32 bounds the form:
// max |A| * (sum of da over a segment) must stay below ~88, or G underflows
// and bhat overflows (scan_pallas.py:567-575). Nothing here clamps or
// rescales: that would compute another function.
//
// What bounds it on an H100: per token, direction and (n, d) one exp and one
// reciprocal (inside the IEEE divide) on the special-function units, 16 per
// SM per clock, against ~8 FMA-pipe operations; the SFU sets the bound, twice
// K1's.
//
// Design: K1's three phases and layouts. chunk_scan_ssd<false> scans each
// chunk of T tokens from h = 0 segment by segment and writes its end state
// and its sum of da; chunk_prefix (as in K1) turns end states into entering
// states; chunk_scan_ssd<true> replays every chunk from its entering state
// and writes y. The reverse member is index arithmetic; a ragged chunk is
// masked, and its segments start at its first processed token (the true tail
// of the stream for the reverse member: the TPU kernel pads L at the end
// instead, so its reverse member's first segment begins on pad tokens; the
// two differ in rounding only).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRPad = 4;            // x_dbl row: [dt (R <= 4, padded) | B (N) | C (N)]
constexpr int kPrefixWorkers = 32;  // workers per lane in chunk_prefix

__device__ __forceinline__ float softplus(float v) {
  // torch.nn.functional.softplus (threshold 20): above it log1p(exp(v)) == v in f32.
  return v > 20.f ? v : log1pf(expf(v));
}

template <int N, int R, bool REPLAY>
__global__ void __launch_bounds__(256) chunk_scan_ssd(
    const float* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ dtw, const float* __restrict__ bias,
    const float* __restrict__ A, const float* __restrict__ dsk,
    float* __restrict__ state, float* __restrict__ sumda, float* __restrict__ y,
    int L, int D, int T, int S, int nc) {
  constexpr int J = R + 2 * N;
  constexpr int JP = kRPad + 2 * N;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xd = smem;                   // [2][T][JP] x_dbl of both directions
  float* xs = smem + 2 * T * JP;      // [T][D+1] x tile
  const int DP = D + 1;
  const int c = blockIdx.x, b = blockIdx.y;
  const int l0 = c * T;
  const int tc = min(T, L - l0);

  const float* xb = x + ((size_t)b * L + l0) * D;
  for (int i = threadIdx.x; i < tc * D; i += blockDim.x) {
    xs[(i / D) * DP + i % D] = xb[i];
  }
  __syncthreads();

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
  float An[N], H[N], cums[N], wdt[R];
#pragma unroll
  for (int n = 0; n < N; ++n) An[n] = A[((size_t)k * N + n) * D + d];
#pragma unroll
  for (int r = 0; r < R; ++r) wdt[r] = dtw[((size_t)k * R + r) * D + d];
  const float bk = bias[k * D + d];
  const float dk = dsk[k * D + d];
  const size_t ci = ((size_t)b * 2 + k) * nc + c;
  float* st = state + ci * N * D + d;
#pragma unroll
  for (int n = 0; n < N; ++n) H[n] = REPLAY ? st[(size_t)n * D] : 0.f;
  float* yb = y + (((size_t)b * 2 + k) * L + l0) * D + d;
  float sda = 0.f, cl = 0.f;

  for (int s = 0; s < tc; ++s) {
    if (s % S == 0) {  // a segment starts
      cl = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) cums[n] = 0.f;
    }
    const int t = k == 0 ? s : tc - 1 - s;
    const float* q = xd + (k * T + t) * JP;
    float dt = bk;
#pragma unroll
    for (int r = 0; r < R; ++r) dt = fmaf(q[r], wdt[r], dt);
    const float da = softplus(dt);
    const float u = xs[t * DP + d];
    const float w = da * u;
    cl += da;
    sda += da;
    const bool last = s % S == S - 1 || s == tc - 1;  // the segment ends here
    float acc = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float G = expf(cl * An[n]);
      cums[n] += (w * q[kRPad + n]) / G;
      if (REPLAY || last) {
        const float h = G * (H[n] + cums[n]);
        if (REPLAY) acc = fmaf(q[kRPad + N + n], h, acc);
        if (last) H[n] = h;
      }
    }
    if (REPLAY) yb[(size_t)t * D] = fmaf(dk, u, acc);
  }
  if (!REPLAY) {
#pragma unroll
    for (int n = 0; n < N; ++n) st[(size_t)n * D] = H[n];
    sumda[ci * D + d] = sda;
  }
}

// Entering state of every chunk, in place of its end state: K1's chunk_prefix.
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

  float pa = 1.f, ph = 0.f;
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

  float hc = 0.f;
  for (int v = 0; v < w; ++v) hc = fmaf(agg_a[v][lane], hc, agg_h[v][lane]);
  for (int p = p0; p < p1; ++p) {
    const size_t ci = base + (k == 0 ? p : nc - 1 - p);
    const float a = expf(a_nd * sumda[ci * D + d]);
    const float he = state[ci * ND + nd];
    state[ci * ND + nd] = hc;
    hc = fmaf(a, hc, he);
  }
}

template <int N, int R>
cudaError_t launch(const float* x, const float* wx, const float* dtw,
                   const float* bias, const float* A, const float* dsk,
                   float* y, float* state, float* sumda,
                   int B, int L, int D, int T, int S, cudaStream_t stream) {
  const int nc = (L + T - 1) / T;
  const size_t smem = sizeof(float) * ((size_t)2 * T * (kRPad + 2 * N) + (size_t)T * (D + 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(chunk_scan_ssd<N, R, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(chunk_scan_ssd<N, R, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(nc, B);
  chunk_scan_ssd<N, R, false><<<grid, 2 * D, smem, stream>>>(
      x, wx, dtw, bias, A, dsk, state, sumda, y, L, D, T, S, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 pgrid((N * D + 31) / 32, 2, B), pblock(32, kPrefixWorkers);
  chunk_prefix<<<pgrid, pblock, 0, stream>>>(A, state, sumda, N * D, D, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chunk_scan_ssd<N, R, true><<<grid, 2 * D, smem, stream>>>(
      x, wx, dtw, bias, A, dsk, state, sumda, y, L, D, T, S, nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// As ss2d_scan_pair_f32 (ss2d_scan.cu), plus S, the segment length
// (1 <= S <= T). Returns a cudaError_t; the caller has checked N == 16,
// 1 <= R <= 4 and 2 * D <= 256.
int ss2d_scan_pair_ssd_f32(const void* x, const void* wx, const void* dtw,
                           const void* bias, const void* A, const void* dsk,
                           void* y, void* state, void* sumda,
                           int B, int L, int D, int N, int R, int T, int S, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(wx);
  const float* tf = static_cast<const float*>(dtw);
  const float* bf = static_cast<const float*>(bias);
  const float* af = static_cast<const float*>(A);
  const float* sf = static_cast<const float*>(dsk);
  float* yf = static_cast<float*>(y);
  float* stf = static_cast<float*>(state);
  float* df = static_cast<float*>(sumda);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N != 16 || S < 1 || S > T) return cudaErrorInvalidValue;
  switch (R) {
    case 1: return launch<16, 1>(xf, wf, tf, bf, af, sf, yf, stf, df, B, L, D, T, S, s);
    case 2: return launch<16, 2>(xf, wf, tf, bf, af, sf, yf, stf, df, B, L, D, T, S, s);
    case 3: return launch<16, 3>(xf, wf, tf, bf, af, sf, yf, stf, df, B, L, D, T, S, s);
    case 4: return launch<16, 4>(xf, wf, tf, bf, af, sf, yf, stf, df, B, L, D, T, S, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* ss2d_scan_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
