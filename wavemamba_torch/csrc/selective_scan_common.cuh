// Device code shared by K3 (selective_scan.cu) and K4 (selective_scan_bwd.cu).
//
// Layouts, all f32 and contiguous, G = B * K streams, stream g uses the
// weights of direction k = g % K:
//   u, delta, y, dy : (G, L, D)      Bs, Cs : (G, L, N)
//   A : (K, D, N)                    D_skip, bias : (K, D)
//   carries : (G, nc, N, D)          sumda : (G, nc, D),  nc = ceil(L / T)

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace wm {

constexpr int kTokens = 8;          // tokens whose u, delta, dy a thread loads at once
constexpr int kPrefixWorkers = 32;  // workers per lane in chunk_prefix

__device__ __forceinline__ float softplus(float v) {
  // torch.nn.functional.softplus (threshold 20): above it log1p(exp(v)) == v in f32.
  return v > 20.f ? v : log1pf(expf(v));
}

// Stages `rows` (tokens, N) of a (G, L, N) stream into shared memory at
// dst[t * stride + n].
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, float* dst,
                                           int rows, int N, int stride) {
  for (int i = threadIdx.x; i < rows * N; i += blockDim.x) {
    dst[(i / N) * stride + i % N] = src[i];
  }
}

// A chunk acts on what enters it as x -> exp(A * sumda) * x + carry, where
// `carry` is what leaves the chunk when nothing enters it. This turns every
// chunk's `carry` into what enters it, in place: a prefix over the chunks
// from the first (the forward state h) or, with REVERSE, from the last (the
// adjoint g). Lane = one (n, d) of a stream; the chunks are split among
// kPrefixWorkers workers, which combine in shared memory.
template <bool REVERSE>
__global__ void __launch_bounds__(32 * kPrefixWorkers) chunk_prefix(
    const float* __restrict__ A, float* __restrict__ carry,
    const float* __restrict__ sumda, int K, int N, int D, int nc) {
  __shared__ float agg_a[kPrefixWorkers][32];
  __shared__ float agg_x[kPrefixWorkers][32];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int nd = blockIdx.x * 32 + lane;
  const int g = blockIdx.y, k = g % K;
  const int ND = N * D;
  const bool valid = nd < ND;
  const int n = nd / D, d = nd - n * D;
  const float a_nd = valid ? A[((size_t)k * D + d) * N + n] : 0.f;
  const size_t base = (size_t)g * nc;
  const int seg = (nc + kPrefixWorkers - 1) / kPrefixWorkers;
  const int p0 = min(nc, w * seg), p1 = min(nc, p0 + seg);

  float pa = 1.f, px = 0.f;  // this worker's segment as one transition
  if (valid) {
    for (int p = p0; p < p1; ++p) {
      const size_t ci = base + (REVERSE ? nc - 1 - p : p);
      const float a = expf(a_nd * sumda[ci * D + d]);
      px = fmaf(a, px, carry[ci * ND + nd]);
      pa *= a;
    }
  }
  agg_a[w][lane] = pa;
  agg_x[w][lane] = px;
  __syncthreads();
  if (!valid) return;

  float xc = 0.f;  // what enters this worker's first chunk
  for (int v = 0; v < w; ++v) xc = fmaf(agg_a[v][lane], xc, agg_x[v][lane]);
  for (int p = p0; p < p1; ++p) {
    const size_t ci = base + (REVERSE ? nc - 1 - p : p);
    const float a = expf(a_nd * sumda[ci * D + d]);
    const float xe = carry[ci * ND + nd];
    carry[ci * ND + nd] = xc;
    xc = fmaf(a, xc, xe);
  }
}

}  // namespace wm
