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
// What bounds it on an H100: the FMA pipe. Per token and direction the
// recompute of h, the adjoint and the sums take some 20 float32 operations per
// (n, d) plus the projections; the special-function units do N*D + 3D exp
// (a_t, the softplus, the sigmoid and its reciprocal), about half the FMA
// pipe's time, and the 12*D bytes of x and dy read and 4*D bytes of dx written
// per token are far less again.
//
// Design. As K1 it is parallel over L in chunks of T tokens, which K1 has left
// the entering states of. The adjoint g obeys a linear recurrence with the
// same decays as h, so three phases serve again:
//   1. bwd_local: one block per (chunk, batch), thread = (direction, channel)
//      with g[N] in registers. Runs the adjoint backwards over the chunk from
//      g = 0 and writes what leaves the chunk, a_first * g_first.
//   2. bwd_prefix: per (b, k, n, d), a prefix over the chunks in reverse
//      processing order (a chunk's decay is exp(A * sumda), saved by K1) turns
//      that into what enters each chunk.
//   3. bwd_main: the gradients. g runs backwards but needs h_t at every token,
//      and a chunk's h (T*N*2D floats) fits neither registers nor shared
//      memory. So a forward pass over the chunk keeps h at every S-th token in
//      shared memory; then, sub-tile by sub-tile from the last, h is recomputed
//      for S tokens into a shared-memory history and g sweeps back over it.
//      The recurrence is never inverted. The sums over channels (dB, dC, the
//      dt projection) are taken over the history tile after each sweep, one
//      (token, n) row per thread; the history's rows are padded to 2D+1 floats
//      so those reads do not collide. dx of the two directions meets in a
//      shared tile (two adds onto zero: the same bits in either order).
//      Blocks stride over the chunks and keep the weight sums in registers;
//      each block writes one set of partial sums and bwd_reduce adds them up
//      in a fixed order, so the result is the same bits every run.
// The exp() of the recurrence is computed four times (phase 1, and three
// passes of phase 3); fewer passes are work for a later version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRPad = 4;            // x_dbl row: [dt (R <= 4, padded) | B (N) | C (N)]
constexpr int kSub = 8;             // tokens per sub-tile of bwd_main
constexpr int kPrefixWorkers = 32;  // workers per lane in bwd_prefix

__device__ __forceinline__ float softplus(float v) {
  // torch.nn.functional.softplus (threshold 20), as in K1.
  return v > 20.f ? v : log1pf(expf(v));
}

// Stages the chunk's x tile in xs [T][D+1] and x_dbl of both directions in
// xd [2][T][JP], as K1 does.
template <int N, int R>
__device__ __forceinline__ void load_and_project(
    const float* __restrict__ xb, const float* __restrict__ wx,
    float* xs, float* xd, int tc, int D, int T) {
  constexpr int J = R + 2 * N;
  constexpr int JP = kRPad + 2 * N;
  const int DP = D + 1;
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
}

// Phase 1: what the adjoint carries out of each chunk when nothing enters it.
template <int N, int R>
__global__ void __launch_bounds__(128) bwd_local(
    const float* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ dtw, const float* __restrict__ bias,
    const float* __restrict__ A, const float* __restrict__ dy,
    float* __restrict__ gcar, int L, int D, int T, int nc) {
  constexpr int JP = kRPad + 2 * N;
  extern __shared__ float4 smem4[];
  float* xd = reinterpret_cast<float*>(smem4);  // [2][T][JP]
  float* xs = xd + 2 * T * JP;                  // [T][D+1]
  const int c = blockIdx.x, b = blockIdx.y;
  const int l0 = c * T;
  const int tc = min(T, L - l0);
  load_and_project<N, R>(x + ((size_t)b * L + l0) * D, wx, xs, xd, tc, D, T);

  const int k = threadIdx.x / D, d = threadIdx.x - k * D;
  float An[N], ga[N], wdt[R];
#pragma unroll
  for (int n = 0; n < N; ++n) An[n] = A[((size_t)k * N + n) * D + d];
#pragma unroll
  for (int r = 0; r < R; ++r) wdt[r] = dtw[((size_t)k * R + r) * D + d];
  const float bk = bias[k * D + d];
#pragma unroll
  for (int n = 0; n < N; ++n) ga[n] = 0.f;  // a_{t+1} g_{t+1}
  const float* dyb = dy + (((size_t)b * 2 + k) * L + l0) * D + d;

  for (int s = tc - 1; s >= 0; --s) {
    const int t = k == 0 ? s : tc - 1 - s;
    const float* q = xd + (k * T + t) * JP;
    float dt = bk;
#pragma unroll
    for (int r = 0; r < R; ++r) dt = fmaf(q[r], wdt[r], dt);
    const float da = softplus(dt);
    const float dyv = dyb[(size_t)t * D];
    const float4* cq = reinterpret_cast<const float4*>(q + kRPad + N);
#pragma unroll
    for (int n4 = 0; n4 < N / 4; ++n4) {
      const float4 cv = cq[n4];
      const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 4 * n4 + i;
        ga[n] = expf(da * An[n]) * fmaf(cs[i], dyv, ga[n]);
      }
    }
  }
  float* go = gcar + (((size_t)b * 2 + k) * nc + c) * N * D + d;
#pragma unroll
  for (int n = 0; n < N; ++n) go[(size_t)n * D] = ga[n];
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

  float pa = 1.f, pg = 0.f;
  if (valid) {
    for (int p = p0; p < p1; ++p) {
      const size_t ci = base + (k == 0 ? nc - 1 - p : p);
      const float a = expf(a_nd * sumda[ci * D + d]);
      pg = fmaf(a, pg, gcar[ci * ND + nd]);
      pa *= a;
    }
  }
  agg_a[w][lane] = pa;
  agg_g[w][lane] = pg;
  __syncthreads();
  if (!valid) return;

  float gc = 0.f;
  for (int v = 0; v < w; ++v) gc = fmaf(agg_a[v][lane], gc, agg_g[v][lane]);
  for (int p = p0; p < p1; ++p) {
    const size_t ci = base + (k == 0 ? nc - 1 - p : p);
    const float a = expf(a_nd * sumda[ci * D + d]);
    const float ge = gcar[ci * ND + nd];
    gcar[ci * ND + nd] = gc;
    gc = fmaf(a, gc, ge);
  }
}

// Phase 3: the gradients. part: [gridDim.y * gridDim.x][P][2D] partial sums,
// P = (R+2N) + R + 1 + N + 1 rows: dwx, ddtw, dbias, dA, ddsk.
template <int N, int R>
__global__ void __launch_bounds__(128) bwd_main(
    const float* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ dtw, const float* __restrict__ bias,
    const float* __restrict__ A, const float* __restrict__ dsk,
    const float* __restrict__ state, const float* __restrict__ gcar,
    const float* __restrict__ dy, float* __restrict__ dx,
    float* __restrict__ part, int L, int D, int T, int nc) {
  constexpr int J = R + 2 * N;
  constexpr int JP = kRPad + 2 * N;
  constexpr int S = kSub;
  const int D2 = 2 * D, HP = 2 * D + 1, DP = D + 1;
  extern __shared__ float4 smem4[];
  float* xd = reinterpret_cast<float*>(smem4);  // [2][T][JP]
  float* xs = xd + 2 * T * JP;                  // [T][DP] x
  float* dxs = xs + T * DP;                     // [T][DP] dx of both directions
  float* hb = dxs + T * DP;                     // [T/S][N][2D] h entering each sub-tile
  float* hist = hb + (T / S) * N * D2;          // [S][N][HP] h, then g da u, of a sub-tile
  float* dys = hist + S * N * HP;               // [S][2D] dy
  float* ddrs = dys + S * D2;                   // [S][2D] dz
  float* dus = ddrs + S * D2;                   // [S][2D] du
  float* dxd = dus + S * D2;                    // [S][2][JP] gradient of x_dbl

  const int tid = threadIdx.x;
  const int k = tid / D, d = tid - k * D;
  const int b = blockIdx.y;
  float An[N], wdt[R];
#pragma unroll
  for (int n = 0; n < N; ++n) An[n] = A[((size_t)k * N + n) * D + d];
#pragma unroll
  for (int r = 0; r < R; ++r) wdt[r] = dtw[((size_t)k * R + r) * D + d];
  const float bk = bias[k * D + d];
  const float dk = dsk[k * D + d];
  const float* wrow = wx + ((size_t)k * D + d) * J;

  float dwx_acc[J], ddtw_acc[R], dA_acc[N];
  float dbias_acc = 0.f, ddsk_acc = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) dwx_acc[j] = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) ddtw_acc[r] = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) dA_acc[n] = 0.f;

  for (int c = blockIdx.x; c < nc; c += gridDim.x) {
    const int l0 = c * T;
    const int tc = min(T, L - l0);
    __syncthreads();  // the previous chunk's tiles are free
    for (int i = tid; i < tc * DP; i += blockDim.x) dxs[i] = 0.f;
    load_and_project<N, R>(x + ((size_t)b * L + l0) * D, wx, xs, xd, tc, D, T);

    const size_t ci = ((size_t)b * 2 + k) * nc + c;
    const float* dyb = dy + (((size_t)b * 2 + k) * L + l0) * D + d;
    float h[N], ga[N];

    // h at the head of every sub-tile, from the chunk's entering state.
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = state[(ci * N + n) * D + d];
    for (int s = 0; s < tc; ++s) {
      if (s % S == 0) {
        float* o = hb + (s / S) * N * D2 + tid;
#pragma unroll
        for (int n = 0; n < N; ++n) o[n * D2] = h[n];
      }
      const int t = k == 0 ? s : tc - 1 - s;
      const float* q = xd + (k * T + t) * JP;
      float dt = bk;
#pragma unroll
      for (int r = 0; r < R; ++r) dt = fmaf(q[r], wdt[r], dt);
      const float da = softplus(dt);
      const float du = da * xs[t * DP + d];
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = fmaf(expf(da * An[n]), h[n], du * q[kRPad + n]);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) ga[n] = gcar[(ci * N + n) * D + d];

    const int nsub = (tc + S - 1) / S;
    for (int j = nsub - 1; j >= 0; --j) {
      const int s0 = j * S;
      const int cnt = min(S, tc - s0);

      // h of the sub-tile's tokens into the history, and dy beside it.
      {
        const float* o = hb + j * N * D2 + tid;
#pragma unroll
        for (int n = 0; n < N; ++n) h[n] = o[n * D2];
      }
      for (int si = 0; si < cnt; ++si) {
        const int s = s0 + si;
        const int t = k == 0 ? s : tc - 1 - s;
        const float* q = xd + (k * T + t) * JP;
        float dt = bk;
#pragma unroll
        for (int r = 0; r < R; ++r) dt = fmaf(q[r], wdt[r], dt);
        const float da = softplus(dt);
        const float du = da * xs[t * DP + d];
        float* o = hist + si * N * HP + tid;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = fmaf(expf(da * An[n]), h[n], du * q[kRPad + n]);
          o[n * HP] = h[n];
        }
        dys[si * D2 + tid] = dyb[(size_t)t * D];
      }
      __syncthreads();

      // dC[si][kk][n] = sum_d dy h: one (si, n) row per thread and direction.
      for (int o = tid; o < 2 * S * N; o += blockDim.x) {
        const int kk = o / (S * N), row = o - kk * S * N;
        const int si = row / N, n = row - si * N;
        if (si < cnt) {
          const float* hr = hist + row * HP + kk * D;
          const float* dr = dys + si * D2 + kk * D;
          float acc = 0.f;
          for (int dd = 0; dd < D; ++dd) acc = fmaf(hr[dd], dr[dd], acc);
          dxd[(si * 2 + kk) * JP + kRPad + N + n] = acc;
        }
      }
      __syncthreads();

      // The adjoint sweeps back over the sub-tile; g da u replaces h in the history.
      for (int si = cnt - 1; si >= 0; --si) {
        const int s = s0 + si;
        const int t = k == 0 ? s : tc - 1 - s;
        const float* q = xd + (k * T + t) * JP;
        float dt = bk;
#pragma unroll
        for (int r = 0; r < R; ++r) dt = fmaf(q[r], wdt[r], dt);
        const float da = softplus(dt);
        const float sig = 1.f / (1.f + expf(-dt));
        const float u = xs[t * DP + d];
        const float dau = da * u;
        const float dyv = dys[si * D2 + tid];
        float* o = hist + si * N * HP + tid;
        float gB = 0.f, dda = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float bn = q[kRPad + n], cn = q[kRPad + N + n];
          const float hn = o[n * HP];
          const float g = fmaf(cn, dyv, ga[n]);
          const float gdau = g * dau;
          const float common = fmaf(g, hn, -gdau * bn);
          gB = fmaf(g, bn, gB);
          dda = fmaf(common, An[n], dda);
          dA_acc[n] = fmaf(common, da, dA_acc[n]);
          ga[n] = expf(da * An[n]) * g;
          o[n * HP] = gdau;
        }
        dda = fmaf(gB, u, dda);
        const float ddr = dda * sig;
        ddrs[si * D2 + tid] = ddr;
        dus[si * D2 + tid] = fmaf(da, gB, dk * dyv);
        dbias_acc += ddr;
        ddsk_acc = fmaf(dyv, u, ddsk_acc);
#pragma unroll
        for (int r = 0; r < R; ++r) ddtw_acc[r] = fmaf(q[r], ddr, ddtw_acc[r]);
      }
      __syncthreads();

      // dB[si][kk][n] = sum_d g da u, and the dt part dz . dtw^T.
      for (int o = tid; o < 2 * S * N; o += blockDim.x) {
        const int kk = o / (S * N), row = o - kk * S * N;
        const int si = row / N, n = row - si * N;
        if (si < cnt) {
          const float* gr = hist + row * HP + kk * D;
          float acc = 0.f;
          for (int dd = 0; dd < D; ++dd) acc += gr[dd];
          dxd[(si * 2 + kk) * JP + kRPad + n] = acc;
        }
      }
      for (int o = tid; o < 2 * S * R; o += blockDim.x) {
        const int kk = o / (S * R), row = o - kk * S * R;
        const int si = row / R, r = row - si * R;
        if (si < cnt) {
          const float* zr = ddrs + si * D2 + kk * D;
          const float* wr = dtw + ((size_t)kk * R + r) * D;
          float acc = 0.f;
          for (int dd = 0; dd < D; ++dd) acc = fmaf(zr[dd], __ldg(wr + dd), acc);
          dxd[(si * 2 + kk) * JP + r] = acc;
        }
      }
      __syncthreads();

      // dx = dxd . wx^T + du, and dwx += x^T dxd.
      for (int si = 0; si < cnt; ++si) {
        const int s = s0 + si;
        const int t = k == 0 ? s : tc - 1 - s;
        const float* row = dxd + (si * 2 + k) * JP;
        const float xv = xs[t * DP + d];
        float acc = dus[si * D2 + tid];
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          acc = fmaf(row[jj], __ldg(wrow + jj), acc);
          dwx_acc[jj] = fmaf(xv, row[jj], dwx_acc[jj]);
        }
#pragma unroll
        for (int jj = 0; jj < 2 * N; ++jj) {
          acc = fmaf(row[kRPad + jj], __ldg(wrow + R + jj), acc);
          dwx_acc[R + jj] = fmaf(xv, row[kRPad + jj], dwx_acc[R + jj]);
        }
        atomicAdd(dxs + t * DP + d, acc);
      }
      __syncthreads();  // before the next sub-tile reuses hist, dys and dxd
    }

    float* dxb = dx + ((size_t)b * L + l0) * D;
    for (int i = tid; i < tc * D; i += blockDim.x) dxb[i] = dxs[(i / D) * DP + i % D];
  }

  float* po = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * (J + R + N + 2) * D2 + tid;
  int row = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) po[(size_t)(row++) * D2] = dwx_acc[j];
#pragma unroll
  for (int r = 0; r < R; ++r) po[(size_t)(row++) * D2] = ddtw_acc[r];
  po[(size_t)(row++) * D2] = dbias_acc;
#pragma unroll
  for (int n = 0; n < N; ++n) po[(size_t)(row++) * D2] = dA_acc[n];
  po[(size_t)row * D2] = ddsk_acc;
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

size_t main_smem(int N, int D, int T) {
  const int JP = kRPad + 2 * N, D2 = 2 * D;
  return sizeof(float) * ((size_t)2 * T * JP + 2 * (size_t)T * (D + 1) +
                          (size_t)(T / kSub) * N * D2 + (size_t)kSub * N * (D2 + 1) +
                          3 * (size_t)kSub * D2 + (size_t)kSub * 2 * JP);
}

template <int N, int R>
cudaError_t launch(const float* x, const float* wx, const float* dtw,
                   const float* bias, const float* A, const float* dsk,
                   const float* state, const float* sumda, const float* dy,
                   float* dx, float* gcar, float* part, float* sums,
                   int B, int L, int D, int T, int gx, cudaStream_t stream) {
  const int nc = (L + T - 1) / T;
  const size_t smem_local = sizeof(float) * ((size_t)2 * T * (kRPad + 2 * N) + (size_t)T * (D + 1));
  const size_t smem_main = main_smem(N, D, T);
  cudaError_t e = cudaFuncSetAttribute(bwd_local<N, R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_local);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_main<N, R>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_main);
  if (e != cudaSuccess) return e;

  bwd_local<N, R><<<dim3(nc, B), 2 * D, smem_local, stream>>>(
      x, wx, dtw, bias, A, dy, gcar, L, D, T, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 pgrid((N * D + 31) / 32, 2, B), pblock(32, kPrefixWorkers);
  bwd_prefix<<<pgrid, pblock, 0, stream>>>(A, gcar, sumda, N * D, D, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_main<N, R><<<dim3(gx, B), 2 * D, smem_main, stream>>>(
      x, wx, dtw, bias, A, dsk, state, gcar, dy, dx, part, L, D, T, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int width = (R + 2 * N + R + N + 2) * 2 * D;
  bwd_reduce<<<(width + 255) / 256, 256, 0, stream>>>(part, sums, gx * B, width);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, L, D); wx (2, D, R+2N); dtw (2, R, D); bias, dsk (2, D); A (2, N, D);
// state (B, 2, nc, N, D) and sumda (B, 2, nc, D) as K1 left them, nc =
// ceil(L / T); dy (B, 2, L, D). Outputs: dx (B, L, D); sums (P, 2, D), P =
// (R+2N) + R + 1 + N + 1 rows [dwx | ddtw | dbias | dA | ddsk], each row
// (direction, channel). Scratch: gcar (B, 2, nc, N, D); part (B * gx, P, 2, D),
// gx <= nc the number of blocks that share a batch element's chunks. All f32,
// contiguous, on the device of `stream`. Returns a cudaError_t; the caller has
// checked N == 16, 1 <= R <= 4, D <= 64 and T a multiple of 8.
int ss2d_scan_pair_bwd_f32(const void* x, const void* wx, const void* dtw,
                           const void* bias, const void* A, const void* dsk,
                           const void* state, const void* sumda, const void* dy,
                           void* dx, void* gcar, void* part, void* sums,
                           int B, int L, int D, int N, int R, int T, int gx, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N != 16 || D > 64 || T % kSub != 0 || gx < 1) return cudaErrorInvalidValue;
#define WM_LAUNCH(RR)                                                                   \
  return launch<16, RR>(f(x), f(wx), f(dtw), f(bias), f(A), f(dsk), f(state), f(sumda), \
                        f(dy), m(dx), m(gcar), m(part), m(sums), B, L, D, T, gx, s)
  switch (R) {
    case 1: WM_LAUNCH(1);
    case 2: WM_LAUNCH(2);
    case 3: WM_LAUNCH(3);
    case 4: WM_LAUNCH(4);
    default: return cudaErrorInvalidValue;
  }
#undef WM_LAUNCH
}

const char* ss2d_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
