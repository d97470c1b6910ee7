// K3 on Hopper: the unfused selective scan (Mamba S6 recurrence) over
// pre-projected inputs, the `mamba_ssm.selective_scan_fn` contract.
//
// Replaces the TPU kernel `wavemamba_tpu/ops/scan_pallas.py:_scan_kernel`
// (`selective_scan_pallas`). For each stream g = (b, k), with f32 state:
//   da_t = softplus(delta_t + bias[k])
//   h_t  = exp(da_t * A[k]) * h_{t-1} + da_t * u_t * B_t      (h: N x D)
//   y_t  = sum_n C_t[n] * h_t[n] + D_skip[k] * u_t
// Streams run forward only: the caller materialises a reversed direction as a
// flipped stream. A, D_skip and bias are indexed per direction (k = g % K),
// not broadcast over the batch as the TPU wrapper does.
//
// What bounds it on an H100: per token and stream it reads u, delta (2D
// floats), B, C (2N floats) and writes y (D floats), 4(3D + 2N) bytes, against
// ~6 FMA-pipe flops and one exp() per (n, d). At the shipped widths (D=64,
// N=16) the exp() on the special-function units (16 per SM per clock) and the
// bytes take about the same time, each more than the FMA pipe.
//
// Design. The TPU kernel walks a stream's chunks in sequence with h in a
// scratch that survives grid steps; here that would leave B*K blocks busy. As
// K1 (ss2d_scan.cu), the kernel is parallel over L in chunks of T tokens:
//   1. scan_chunk<false>: one block per (chunk, stream), thread = channel d
//      with h[N] in registers; B of the chunk is staged in shared memory, u
//      and delta are loaded 8 tokens at a time into registers. Scans the chunk
//      from h = 0, writes its end state and its sum of da.
//   2. chunk_prefix: end states -> entering states (selective_scan_common.cuh).
//   3. scan_chunk<true>: reruns every chunk from its entering state and
//      writes y. The last chunk is ragged, not padded.
// The entering states and the sums of da stay behind for K4. The exp() of the
// recurrence is computed twice; halving that is work for a later version.

#include "selective_scan_common.cuh"

namespace {

using namespace wm;

template <int N, bool REPLAY>
__global__ void __launch_bounds__(256) scan_chunk(
    const float* __restrict__ u, const float* __restrict__ delta,
    const float* __restrict__ A, const float* __restrict__ Bs,
    const float* __restrict__ Cs, const float* __restrict__ dsk,
    const float* __restrict__ bias, float* __restrict__ state,
    float* __restrict__ sumda, float* __restrict__ y,
    int K, int L, int D, int T, int nc) {
  extern __shared__ float4 smem4[];
  float* bc = reinterpret_cast<float*>(smem4);  // [T][2N]: B_t | C_t
  const int c = blockIdx.x, g = blockIdx.y, k = g % K;
  const int l0 = c * T;
  const int tc = min(T, L - l0);
  const int d = threadIdx.x;

  stage_rows(Bs + ((size_t)g * L + l0) * N, bc, tc, N, 2 * N);
  if (REPLAY) stage_rows(Cs + ((size_t)g * L + l0) * N, bc + N, tc, N, 2 * N);
  __syncthreads();

  float An[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) An[n] = A[((size_t)k * D + d) * N + n];
  const float bk = bias[k * D + d];
  const float dk = dsk[k * D + d];
  const size_t ci = (size_t)g * nc + c;
  float* st = state + ci * N * D + d;
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = REPLAY ? st[(size_t)n * D] : 0.f;
  const size_t off = ((size_t)g * L + l0) * D + d;
  const float* ug = u + off;
  const float* dg = delta + off;
  float* yg = y + off;
  float sda = 0.f;

  for (int s0 = 0; s0 < tc; s0 += kTokens) {
    float uu[kTokens], dd[kTokens];
#pragma unroll
    for (int i = 0; i < kTokens; ++i) {
      const bool ok = s0 + i < tc;
      uu[i] = ok ? ug[(size_t)(s0 + i) * D] : 0.f;
      dd[i] = ok ? dg[(size_t)(s0 + i) * D] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kTokens; ++i) {
      const int t = s0 + i;
      if (t < tc) {
        const float da = softplus(dd[i] + bk);
        const float du = da * uu[i];
        const float4* bq = reinterpret_cast<const float4*>(bc + t * 2 * N);
        const float4* cq = reinterpret_cast<const float4*>(bc + t * 2 * N + N);
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
          for (int j = 0; j < 4; ++j) {
            const int n = 4 * n4 + j;
            h[n] = fmaf(expf(da * An[n]), h[n], du * bs[j]);
            if (REPLAY) acc = fmaf(cs[j], h[n], acc);
          }
        }
        if (REPLAY) {
          yg[(size_t)t * D] = fmaf(dk, uu[i], acc);
        } else {
          sda += da;
        }
      }
    }
  }
  if (!REPLAY) {
#pragma unroll
    for (int n = 0; n < N; ++n) st[(size_t)n * D] = h[n];
    sumda[ci * D + d] = sda;
  }
}

template <int N>
cudaError_t launch(const float* u, const float* delta, const float* A, const float* Bs,
                   const float* Cs, const float* dsk, const float* bias,
                   float* y, float* state, float* sumda,
                   int B, int K, int L, int D, int T, cudaStream_t stream) {
  const int nc = (L + T - 1) / T;
  const int G = B * K;
  const size_t smem = sizeof(float) * (size_t)T * 2 * N;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(nc, G);
  scan_chunk<N, false><<<grid, D, smem, stream>>>(
      u, delta, A, Bs, Cs, dsk, bias, state, sumda, y, K, L, D, T, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 pgrid((N * D + 31) / 32, G), pblock(32, kPrefixWorkers);
  chunk_prefix<false><<<pgrid, pblock, 0, stream>>>(A, state, sumda, K, N, D, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  scan_chunk<N, true><<<grid, D, smem, stream>>>(
      u, delta, A, Bs, Cs, dsk, bias, state, sumda, y, K, L, D, T, nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// u, delta (B, K, L, D); A (K, D, N); Bs, Cs (B, K, L, N); dsk, bias (K, D);
// y (B, K, L, D); scratch that K4 reads: state (B, K, nc, N, D) and sumda
// (B, K, nc, D) with nc = ceil(L / T). All f32, contiguous, on the device of
// `stream`. Returns a cudaError_t; the caller has checked N == 16, D <= 256,
// B * K <= 65535 and T <= 128.
int selective_scan_fwd_f32(const void* u, const void* delta, const void* A,
                           const void* Bs, const void* Cs, const void* dsk,
                           const void* bias, void* y, void* state, void* sumda,
                           int B, int K, int L, int D, int N, int T, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  if (N != 16 || D < 1 || D > 256 || B * K > 65535) return cudaErrorInvalidValue;
  return launch<16>(f(u), f(delta), f(A), f(Bs), f(Cs), f(dsk), f(bias), m(y), m(state),
                    m(sumda), B, K, L, D, T, static_cast<cudaStream_t>(stream));
}

const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
