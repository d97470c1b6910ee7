// K5 on Hopper: the fused SS2D projection + selective scan of one direction
// pair, the recurrence evaluated in the segment-local (SSD) factorization.
//
// Replaces the TPU kernel `wavemamba_tpu/ops/scan_pallas.py:_fused_kernel_ssd`
// (`ss2d_scan_fused(variant='ssd')`). K1's contract (ss2d_scan.cu): the same
// inputs, the same y, the same carries. Within each segment of S tokens, in
// processing order (k = 0 forward, k = 1 in reverse), with f32 state:
//   clocal_t = sum of da over the segment up to t   (inclusive)
//   G_t      = exp(clocal_t * A)                    (n, d)
//   bhat_t   = da_t * u_t * B_t / G_t
//   cums_t   = sum of bhat over the segment up to t
//   h_t      = G_t * (H + cums_t),  H the state entering the segment
//   y_t      = sum_n C_t[n] * h_t[n] + dsk * u_t
// and the segment hands on h at its last token, G_last * (H + cums_last).
// Mathematically h_t is K1's; the rounding differs. f32 bounds the form:
// max |A| * (sum of da over a segment) must stay below ~88, or G underflows
// and 1 / G overflows (scan_pallas.py:567-575). Nothing here clamps or
// rescales: that would compute another function.
//
// What bounds it on an H100 (`chip_smoke.py:k5_bound`): the special-function
// units, 16 results per SM per clock against 128 FMA lanes. The form needs G
// and 1 / G per token, direction and (n, d), twice K1's exps. A design
// parallel over L needs more: pass 1 takes 1 / G at every token and G at each
// segment's last (1 + 1/S), the replay both at every token, 3.125 SFU results
// a (token, direction, n, d) at S = 8 against the bound's 2: ~0.86 ms at a
// 1080p forward's level 1, 1.55x the bound.
//
// Design: K1's (ss2d_scan.cu), whose staging, projection, da and chunk prefix
// it shares through ss2d_scan_common.cuh. chunk_scan_ssd<false> stages the x
// tile and wx, projects x_dbl of both directions once and leaves it in the
// scratch `xdbl`, computes da in parallel, and scans each chunk of T tokens
// from h = 0 segment by segment; it writes the chunk's end state and its sum
// of da. chunk_prefix turns end states into entering states; chunk_scan_ssd
// <true> reads x_dbl back, replays every chunk from its entering state and
// writes y. A quad of threads holds a channel pair of one direction, four of
// the 16 states each: a token's B and C, read once a thread, serve 8 states,
// and y's sums over n are two xor-shuffles in the quad in a fixed order (the
// same inputs give the same bits). Each exponential is one ex2.approx.ftz:
// G = 2^(clocal * A log2 e) and 1 / G = 2^-(clocal * A log2 e), no divide
// (the TPU kernel divides by G to spare its vector unit an exp; the value
// and the overflow bound are the same), and pass 1 takes G only at a
// segment's last token. The token loop, unrolled by 4, issues ~5.5
// instructions a MUFU in either pass, under the 8 cycles a warp's MUFU holds
// the SFU. The segments of a chunk start at its
// first processed token: for the reverse member of a ragged chunk that is
// the stream's true tail (the TPU kernel pads L at the end, so its reverse
// member's first segment begins on pad tokens; the two differ in rounding
// only).
//
// Token streams as K1's: x float32 or bf16, widened as it is staged; y
// float32 or bf16, rounded once. Built for (f32, f32), (bf16, bf16) and
// (bf16 x, f32 y); f32 x with bf16 y is refused. Weights, state, the scratch
// and every operation stay float32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ss2d_scan_common.cuh"

namespace {

constexpr int kScanBlocks = 3;  // resident blocks an SM the launch bounds ask for

template <int N, int R, bool REPLAY, typename TX, typename TY>
__global__ void __launch_bounds__(kThreads, kScanBlocks) chunk_scan_ssd(
    const TX* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ dtw, const float* __restrict__ bias,
    const float* __restrict__ A, const float* __restrict__ dsk,
    float* __restrict__ state, float* __restrict__ sumda, float* __restrict__ xdbl,
    TY* __restrict__ y, int L, int D, int T, int S, int nc) {
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

  stage_chunk<N, R, REPLAY>(x, wx, dtw, bias, xdbl, xs, xd, wxs, b, l0, tc, g0, L, D, T, W);

  // Direction k, channels g0 + 2p and g0 + 2p + 1, states 4q .. 4q + 3.
  const int k = tid >> 7, q = tid & 3, p = (tid >> 2) & (kPairs - 1);
  const int dl = 2 * p;
  const size_t ci = ((size_t)b * 2 + k) * nc + c;  // (b, k, chunk)
  float An[2][NQ], H[2][NQ], dk[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int d = g0 + dl + e;
    const bool on = d < D;
    dk[e] = on ? dsk[k * D + d] : 0.f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const size_t n = kQuad * q + i;
      An[e][i] = on ? A[((size_t)k * N + n) * D + d] * kLog2e : 0.f;
      H[e][i] = REPLAY && on ? state[(ci * N + n) * D + d] : 0.f;
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

  for (int s0 = 0; s0 < tc; s0 += S) {  // a segment: S tokens, fewer at a ragged chunk's end
    const int s1 = min(tc, s0 + S);
    float cl[2] = {0.f, 0.f};  // clocal of each channel
    float cums[2][NQ], h[2][NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) cums[0][i] = cums[1][i] = 0.f;
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
      const float2 da = *reinterpret_cast<const float2*>(dap);
      const float2 u = *reinterpret_cast<const float2*>(up);
      const float4 bv = *reinterpret_cast<const float4*>(xq);
      const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
      cl[0] += da.x;
      cl[1] += da.y;
      const float w[2] = {da.x * u.x, da.y * u.y};
      float m[2][NQ];  // clocal * A log2 e: G = 2^m, 1 / G = 2^-m
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          m[e][i] = cl[e] * An[e][i];
          cums[e][i] = fmaf(w[e] * bs[i], ex2(-m[e][i]), cums[e][i]);
        }
      }
      if (REPLAY) {
        const float4 cv = *reinterpret_cast<const float4*>(xq + N);
        const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
        float a[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            h[e][i] = ex2(m[e][i]) * (H[e][i] + cums[e][i]);
            a[e] = fmaf(cs[i], h[e][i], a[e]);
          }
        }
        // Lanes q = 0, 2 end with channel 0's sum over the quad, q = 1, 3 with
        // channel 1's; the two lanes of a channel add the same pairs.
        const bool odd = q & 1;
        float sum = (odd ? a[1] : a[0]) + __shfl_xor_sync(kFull, odd ? a[0] : a[1], 1);
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
    // The segment hands on h at its last token: the replay has it, pass 1
    // takes its one G here.
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        H[e][i] = REPLAY ? h[e][i] : ex2(cl[e] * An[e][i]) * (H[e][i] + cums[e][i]);
      }
    }
  }
  if (!REPLAY) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = g0 + dl + e;
      if (d >= D) continue;
#pragma unroll
      for (int i = 0; i < NQ; ++i) state[(ci * N + kQuad * q + i) * D + d] = H[e][i];
      if (q == 0) sumda[ci * D + d] = sda[e];
    }
  }
}

template <int N, int R, typename TX, typename TY>
cudaError_t set_smem(int D, int T) {
  const int smem = (int)sizeof(float) * scan_smem_floats(D, N, R, T);
  cudaError_t e = cudaFuncSetAttribute(chunk_scan_ssd<N, R, false, TX, TY>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(chunk_scan_ssd<N, R, true, TX, TY>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int N, int R, typename TX, typename TY>
cudaError_t launch(const TX* x, const float* wx, const float* dtw,
                   const float* bias, const float* A, const float* dsk,
                   TY* y, float* state, float* sumda, float* xdbl,
                   int B, int L, int D, int T, int S, cudaStream_t stream) {
  const int nc = (L + T - 1) / T;
  const size_t smem = sizeof(float) * scan_smem_floats(D, N, R, T);
  cudaError_t e = set_smem<N, R, TX, TY>(D, T);
  if (e != cudaSuccess) return e;
  const dim3 grid(nc, B, (D + kGroup - 1) / kGroup);
  chunk_scan_ssd<N, R, false, TX, TY><<<grid, kThreads, smem, stream>>>(
      x, wx, dtw, bias, A, dsk, state, sumda, xdbl, y, L, D, T, S, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 pgrid((N * D + kPrefixLanes - 1) / kPrefixLanes, 2, B);
  chunk_prefix<<<pgrid, dim3(kPrefixLanes, kPrefixWorkers), 0, stream>>>(A, state, sumda, N * D, D, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chunk_scan_ssd<N, R, true, TX, TY><<<grid, kThreads, smem, stream>>>(
      x, wx, dtw, bias, A, dsk, state, sumda, xdbl, y, L, D, T, S, nc);
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t launch_r(const void* x, const void* wx, const void* dtw, const void* bias,
                     const void* A, const void* dsk, void* y, void* state, void* sumda,
                     void* xdbl, int B, int L, int D, int R, int T, int S, cudaStream_t s) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  const TX* xt = static_cast<const TX*>(x);
  TY* yt = static_cast<TY*>(y);
#define WM_LAUNCH(RR)                                                                       \
  return launch<16, RR>(xt, f(wx), f(dtw), f(bias), f(A), f(dsk), yt, m(state), m(sumda), \
                        m(xdbl), B, L, D, T, S, s)
  switch (R) {
    case 1: WM_LAUNCH(1);
    case 2: WM_LAUNCH(2);
    case 3: WM_LAUNCH(3);
    case 4: WM_LAUNCH(4);
    default: return cudaErrorInvalidValue;
  }
#undef WM_LAUNCH
}

// out: as ss2d_scan_occupancy's (ss2d_scan.cu), for chunk_scan_ssd.
template <int N, int R, typename TX, typename TY>
cudaError_t occupancy(int D, int T, int* out) {
  cudaError_t e = set_smem<N, R, TX, TY>(D, T);
  if (e != cudaSuccess) return e;
  out[0] = kThreads;
  out[1] = (int)sizeof(float) * scan_smem_floats(D, N, R, T);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, chunk_scan_ssd<N, R, false, TX, TY>,
                                                    kThreads, out[1]);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, chunk_scan_ssd<N, R, true, TX, TY>,
                                                    kThreads, out[1]);
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

}  // namespace

extern "C" {

// As ss2d_scan_pair (ss2d_scan.cu), plus S, the segment length, which divides
// T. `smem` is the dynamic shared memory the caller planned for
// chunk_scan_ssd (`scan_cuda.k5_plan`): the launch is refused unless it is
// this source's. Returns a cudaError_t.
int ss2d_scan_pair_ssd(const void* x, const void* wx, const void* dtw,
                       const void* bias, const void* A, const void* dsk,
                       void* y, void* state, void* sumda, void* xdbl,
                       int B, int L, int D, int N, int R, int T, int S, int smem, int x_bf16,
                       int y_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!takes(N, R, D, T) || S < 1 || T % S ||
      smem != (int)sizeof(float) * scan_smem_floats(D, N, R, T)) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wx) % 16) {
    return cudaErrorMisalignedAddress;
  }
#define WM_ARGS x, wx, dtw, bias, A, dsk, y, state, sumda, xdbl, B, L, D, R, T, S, s
  switch (stream_pair(x_bf16, y_bf16)) {
    case 0: return launch_r<float, float>(WM_ARGS);
    case 1: return launch_r<__nv_bfloat16, __nv_bfloat16>(WM_ARGS);
    case 2: return launch_r<__nv_bfloat16, float>(WM_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef WM_ARGS
}

// As ss2d_scan_occupancy (ss2d_scan.cu), for K5's kernels.
int ss2d_scan_ssd_occupancy(int N, int R, int D, int T, int x_bf16, int y_bf16, int* out) {
  if (!takes(N, R, D, T)) return cudaErrorInvalidValue;
  switch (stream_pair(x_bf16, y_bf16)) {
    case 0: return occupancy_r<float, float>(R, D, T, out);
    case 1: return occupancy_r<__nv_bfloat16, __nv_bfloat16>(R, D, T, out);
    case 2: return occupancy_r<__nv_bfloat16, float>(R, D, T, out);
    default: return cudaErrorInvalidValue;
  }
}

const char* ss2d_scan_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
