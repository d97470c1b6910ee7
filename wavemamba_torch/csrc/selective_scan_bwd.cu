// K4 on Hopper: the backward of K3, the unfused selective scan.
//
// Replaces the TPU kernel `wavemamba_tpu/ops/scan_pallas.py:_scan_bwd_kernel`
// (`selective_scan_pallas_bwd`). Given K3's inputs, the chunk-entry states and
// chunk sums of da it left behind, and dy, it computes per stream g = (b, k):
//   z_t  = delta_t + bias[k],  da_t = softplus(z_t),  a_t = exp(da_t A[k])
//   h_t  = a_t h_{t-1} + da_t u_t B_t                        (recomputed)
//   g_t  = a_{t+1} g_{t+1} + C_t (x) dy_t                    (the adjoint, reverse)
//   common = g_t h_t - g_t da_t u_t B_t                      (= g_t a_t h_{t-1})
//   gB   = sum_n g_t B_t
//   du_t = da_t gB + D_skip[k] dy_t
//   ddelta_t = (sum_n common A[k] + gB u_t) * sigmoid(z_t)   (before the softplus)
//   dB_t = sum_d g_t da_t u_t,   dC_t = sum_d dy_t h_t
// and, summed over tokens and batch, dA = sum common da, dD_skip = sum dy u,
// dbias = sum ddelta.
//
// What bounds it on an H100: the bytes, by a margin. Per token and stream it
// reads u, delta, dy, B, C and writes du, ddelta, dB, dC: 4(5D + 4N) bytes,
// 1.0 ms at 8 x 4 x 65,536 tokens (D=64, N=16); the recompute of h, the
// adjoint and the sums take some 20 float32 operations per (n, d), 0.66 ms on
// the FMA pipe; the special-function units do N*D + 3D exp (a_t, the
// softplus, the sigmoid and its reciprocal), 0.61 ms.
//
// Design. The TPU kernel sweeps a stream's chunks in reverse grid order with g
// in a scratch: B*K busy blocks here. As K2 (ss2d_scan_bwd.cu) it is parallel
// over L in chunks of T tokens, whose entering states K3 has left:
//   1. bwd_local: one block per (chunk, stream), thread = channel d with g[N]
//      in registers. Runs the adjoint backwards over the chunk from g = 0 and
//      writes what leaves the chunk, a_first * g_first.
//   2. chunk_prefix<true>: that becomes what enters each chunk, by a prefix
//      over the chunks from the last (selective_scan_common.cuh).
//   3. bwd_main: a forward pass over the chunk keeps h at every 8th token in
//      shared memory; then, sub-tile by sub-tile from the last, h is
//      recomputed for 8 tokens into a shared history and g sweeps back over
//      it; the recurrence is never inverted. dC and dB (sums over the
//      channels) are taken over the history tile before and after the sweep,
//      one (token, n) row per thread, rows padded to D+1 floats. Blocks stride
//      over a stream's chunks and keep dA, dD_skip and dbias in registers.
//   4. bwd_reduce adds the blocks' partial sums over blocks and batch in a
//      fixed order: no float atomics, the same bits every run.
// u, delta and dy are loaded 8 tokens at a time into registers; only B and C
// of the chunk are staged. 75 KB of shared memory at D = 64 leave three
// 64-thread blocks per SM, and the exp() of the recurrence is computed four
// times: the kernel is far from the bound, and bound by the SM, not the bytes.

#include "selective_scan_common.cuh"

namespace {

using namespace wm;

constexpr int kSub = kTokens;  // tokens per sub-tile of bwd_main

// Phase 1: what the adjoint carries out of each chunk when nothing enters it.
template <int N>
__global__ void __launch_bounds__(128) bwd_local(
    const float* __restrict__ delta, const float* __restrict__ A,
    const float* __restrict__ Cs, const float* __restrict__ bias,
    const float* __restrict__ dy, float* __restrict__ gcar,
    int K, int L, int D, int T, int nc) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);  // [T][N]
  const int c = blockIdx.x, g = blockIdx.y, k = g % K;
  const int l0 = c * T;
  const int tc = min(T, L - l0);
  const int d = threadIdx.x;
  stage_rows(Cs + ((size_t)g * L + l0) * N, cs, tc, N, N);
  __syncthreads();

  float An[N], ga[N];
#pragma unroll
  for (int n = 0; n < N; ++n) An[n] = A[((size_t)k * D + d) * N + n];
  const float bk = bias[k * D + d];
#pragma unroll
  for (int n = 0; n < N; ++n) ga[n] = 0.f;  // a_{t+1} g_{t+1}
  const size_t off = ((size_t)g * L + l0) * D + d;
  const float* dg = delta + off;
  const float* dyg = dy + off;

  for (int s0 = (tc - 1) / kTokens * kTokens; s0 >= 0; s0 -= kTokens) {
    float dd[kTokens], dyv[kTokens];
#pragma unroll
    for (int i = 0; i < kTokens; ++i) {
      const bool ok = s0 + i < tc;
      dd[i] = ok ? dg[(size_t)(s0 + i) * D] : 0.f;
      dyv[i] = ok ? dyg[(size_t)(s0 + i) * D] : 0.f;
    }
#pragma unroll
    for (int i = kTokens - 1; i >= 0; --i) {
      const int t = s0 + i;
      if (t < tc) {
        const float da = softplus(dd[i] + bk);
        const float4* cq = reinterpret_cast<const float4*>(cs + t * N);
#pragma unroll
        for (int n4 = 0; n4 < N / 4; ++n4) {
          const float4 cv = cq[n4];
          const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = 4 * n4 + j;
            ga[n] = expf(da * An[n]) * fmaf(cc[j], dyv[i], ga[n]);
          }
        }
      }
    }
  }
  float* go = gcar + ((size_t)g * nc + c) * N * D + d;
#pragma unroll
  for (int n = 0; n < N; ++n) go[(size_t)n * D] = ga[n];
}

// Phase 3: the gradients. part: [G][gridDim.x][N + 2][D] partial sums of a
// block: dA (N rows), dD_skip, dbias.
template <int N>
__global__ void __launch_bounds__(128) bwd_main(
    const float* __restrict__ u, const float* __restrict__ delta,
    const float* __restrict__ A, const float* __restrict__ Bs,
    const float* __restrict__ Cs, const float* __restrict__ dsk,
    const float* __restrict__ bias, const float* __restrict__ state,
    const float* __restrict__ gcar, const float* __restrict__ dy,
    float* __restrict__ du, float* __restrict__ ddelta,
    float* __restrict__ dB, float* __restrict__ dC, float* __restrict__ part,
    int K, int L, int D, int T, int nc) {
  constexpr int S = kSub;
  const int HP = D + 1;
  extern __shared__ float4 smem4[];
  float* bc = reinterpret_cast<float*>(smem4);  // [T][2N]: B_t | C_t
  float* hb = bc + T * 2 * N;                   // [T/S][N][D] h entering each sub-tile
  float* hist = hb + (T / S) * N * D;           // [S][N][HP] h, then g da u, of a sub-tile
  float* dys = hist + S * N * HP;               // [S][D] dy

  const int d = threadIdx.x;
  const int g = blockIdx.y, k = g % K;
  float An[N], dA_acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    An[n] = A[((size_t)k * D + d) * N + n];
    dA_acc[n] = 0.f;
  }
  const float bk = bias[k * D + d];
  const float dk = dsk[k * D + d];
  float dbias_acc = 0.f, ddsk_acc = 0.f;

  for (int c = blockIdx.x; c < nc; c += gridDim.x) {
    const int l0 = c * T;
    const int tc = min(T, L - l0);
    __syncthreads();  // the previous chunk's tiles are free
    stage_rows(Bs + ((size_t)g * L + l0) * N, bc, tc, N, 2 * N);
    stage_rows(Cs + ((size_t)g * L + l0) * N, bc + N, tc, N, 2 * N);
    __syncthreads();

    const size_t ci = (size_t)g * nc + c;
    const size_t off = ((size_t)g * L + l0) * D + d;
    const float* ug = u + off;
    const float* dg = delta + off;
    const float* dyg = dy + off;
    float h[N], ga[N];

    // h at the head of every sub-tile, from the chunk's entering state.
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = state[(ci * N + n) * D + d];
    const int nsub = (tc + S - 1) / S;
    for (int j = 0; j < nsub; ++j) {
      const int s0 = j * S;
      float* o = hb + j * N * D + d;
#pragma unroll
      for (int n = 0; n < N; ++n) o[n * D] = h[n];
      float uu[S], dd[S];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const bool ok = s0 + i < tc;
        uu[i] = ok ? ug[(size_t)(s0 + i) * D] : 0.f;
        dd[i] = ok ? dg[(size_t)(s0 + i) * D] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int t = s0 + i;
        if (t < tc) {
          const float da = softplus(dd[i] + bk);
          const float dau = da * uu[i];
          const float* q = bc + t * 2 * N;
#pragma unroll
          for (int n = 0; n < N; ++n) h[n] = fmaf(expf(da * An[n]), h[n], dau * q[n]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n) ga[n] = gcar[(ci * N + n) * D + d];

    for (int j = nsub - 1; j >= 0; --j) {
      const int s0 = j * S;
      const int cnt = min(S, tc - s0);
      float uu[S], dd[S], dyv[S];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const bool ok = i < cnt;
        uu[i] = ok ? ug[(size_t)(s0 + i) * D] : 0.f;
        dd[i] = ok ? dg[(size_t)(s0 + i) * D] : 0.f;
        dyv[i] = ok ? dyg[(size_t)(s0 + i) * D] : 0.f;
      }

      // h of the sub-tile's tokens into the history, and dy beside it.
      {
        const float* o = hb + j * N * D + d;
#pragma unroll
        for (int n = 0; n < N; ++n) h[n] = o[n * D];
      }
#pragma unroll
      for (int i = 0; i < S; ++i) {
        if (i < cnt) {
          const float da = softplus(dd[i] + bk);
          const float dau = da * uu[i];
          const float* q = bc + (s0 + i) * 2 * N;
          float* o = hist + i * N * HP + d;
#pragma unroll
          for (int n = 0; n < N; ++n) {
            h[n] = fmaf(expf(da * An[n]), h[n], dau * q[n]);
            o[n * HP] = h[n];
          }
          dys[i * D + d] = dyv[i];
        }
      }
      __syncthreads();

      // dC[t][n] = sum_d dy h: one (token, n) row per thread.
      for (int o = d; o < cnt * N; o += blockDim.x) {
        const float* hr = hist + o * HP;
        const float* dr = dys + (o / N) * D;
        float acc = 0.f;
        for (int e = 0; e < D; ++e) acc = fmaf(hr[e], dr[e], acc);
        dC[((size_t)g * L + l0 + s0) * N + o] = acc;
      }
      __syncthreads();

      // The adjoint sweeps back over the sub-tile; g da u replaces h in the history.
#pragma unroll
      for (int i = S - 1; i >= 0; --i) {
        if (i < cnt) {
          const int t = s0 + i;
          const float z = dd[i] + bk;
          const float da = softplus(z);
          const float sig = 1.f / (1.f + expf(-z));
          const float uv = uu[i];
          const float dau = da * uv;
          const float dyi = dys[i * D + d];
          const float* q = bc + t * 2 * N;
          float* o = hist + i * N * HP + d;
          float gB = 0.f, dda = 0.f;
#pragma unroll
          for (int n = 0; n < N; ++n) {
            const float bn = q[n], cn = q[N + n];
            const float hn = o[n * HP];
            const float gv = fmaf(cn, dyi, ga[n]);
            const float gdau = gv * dau;
            const float common = fmaf(gv, hn, -gdau * bn);
            gB = fmaf(gv, bn, gB);
            dda = fmaf(common, An[n], dda);
            dA_acc[n] = fmaf(common, da, dA_acc[n]);
            ga[n] = expf(da * An[n]) * gv;
            o[n * HP] = gdau;
          }
          dda = fmaf(gB, uv, dda);
          const float ddr = dda * sig;
          ddelta[off + (size_t)t * D] = ddr;
          du[off + (size_t)t * D] = fmaf(da, gB, dk * dyi);
          dbias_acc += ddr;
          ddsk_acc = fmaf(dyi, uv, ddsk_acc);
        }
      }
      __syncthreads();

      // dB[t][n] = sum_d g da u.
      for (int o = d; o < cnt * N; o += blockDim.x) {
        const float* gr = hist + o * HP;
        float acc = 0.f;
        for (int e = 0; e < D; ++e) acc += gr[e];
        dB[((size_t)g * L + l0 + s0) * N + o] = acc;
      }
      __syncthreads();  // before the next sub-tile reuses hist and dys
    }
  }

  float* po = part + ((size_t)g * gridDim.x + blockIdx.x) * (N + 2) * D + d;
#pragma unroll
  for (int n = 0; n < N; ++n) po[(size_t)n * D] = dA_acc[n];
  po[(size_t)N * D] = ddsk_acc;
  po[(size_t)(N + 1) * D] = dbias_acc;
}

// out[k][i] = sum over the batch, then over a stream's blocks, of the partial
// sums, in that fixed order. width = (N + 2) * D.
__global__ void bwd_reduce(const float* __restrict__ part, float* __restrict__ out,
                           int B, int K, int gx, int width) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (i >= width) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = part + ((size_t)b * K + k) * gx * width + i;
    for (int r = 0; r < gx; ++r) acc += p[(size_t)r * width];
  }
  out[(size_t)k * width + i] = acc;
}

size_t main_smem(int N, int D, int T) {
  return sizeof(float) * ((size_t)T * 2 * N + (size_t)(T / kSub) * N * D +
                          (size_t)kSub * N * (D + 1) + (size_t)kSub * D);
}

template <int N>
cudaError_t launch(const float* u, const float* delta, const float* A, const float* Bs,
                   const float* Cs, const float* dsk, const float* bias,
                   const float* state, const float* sumda, const float* dy,
                   float* du, float* ddelta, float* dB, float* dC,
                   float* gcar, float* part, float* sums,
                   int B, int K, int L, int D, int T, int gx, cudaStream_t stream) {
  const int nc = (L + T - 1) / T;
  const int G = B * K;
  const size_t smem_local = sizeof(float) * (size_t)T * N;
  const size_t smem_main = main_smem(N, D, T);
  cudaError_t e = cudaFuncSetAttribute(bwd_main<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_main);
  if (e != cudaSuccess) return e;

  bwd_local<N><<<dim3(nc, G), D, smem_local, stream>>>(
      delta, A, Cs, bias, dy, gcar, K, L, D, T, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 pgrid((N * D + 31) / 32, G), pblock(32, kPrefixWorkers);
  chunk_prefix<true><<<pgrid, pblock, 0, stream>>>(A, gcar, sumda, K, N, D, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_main<N><<<dim3(gx, G), D, smem_main, stream>>>(
      u, delta, A, Bs, Cs, dsk, bias, state, gcar, dy, du, ddelta, dB, dC, part,
      K, L, D, T, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int width = (N + 2) * D;
  bwd_reduce<<<dim3((width + 255) / 256, K), 256, 0, stream>>>(part, sums, B, K, gx, width);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// u, delta, dy (B, K, L, D); A (K, D, N); Bs, Cs (B, K, L, N); dsk, bias
// (K, D); state (B, K, nc, N, D) and sumda (B, K, nc, D) as K3 left them, nc =
// ceil(L / T). Outputs: du, ddelta (B, K, L, D); dB, dC (B, K, L, N); sums
// (K, N + 2, D): rows [dA (n-major) | dD_skip | dbias]. Scratch: gcar
// (B, K, nc, N, D); part (B * K, gx, N + 2, D), gx <= nc the number of blocks
// that share a stream's chunks. All f32, contiguous, on the device of
// `stream`. Returns a cudaError_t; the caller has checked N == 16, D <= 128,
// B * K <= 65535, T <= 128 and T a multiple of 8.
int selective_scan_bwd_f32(const void* u, const void* delta, const void* A,
                           const void* Bs, const void* Cs, const void* dsk,
                           const void* bias, const void* state, const void* sumda,
                           const void* dy, void* du, void* ddelta, void* dB, void* dC,
                           void* gcar, void* part, void* sums,
                           int B, int K, int L, int D, int N, int T, int gx, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  if (N != 16 || D < 1 || D > 128 || T % kSub != 0 || gx < 1 || B * K > 65535) {
    return cudaErrorInvalidValue;
  }
  return launch<16>(f(u), f(delta), f(A), f(Bs), f(Cs), f(dsk), f(bias), f(state), f(sumda),
                    f(dy), m(du), m(ddelta), m(dB), m(dC), m(gcar), m(part), m(sums),
                    B, K, L, D, T, gx, static_cast<cudaStream_t>(stream));
}

const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
