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
#include <stdint.h>

#include "ss2d_scan_common.cuh"

namespace {

constexpr int kScanBlocks = 3;  // resident blocks an SM the launch bounds ask for

template <int N, int R, bool REPLAY, typename TX, typename TY>
__global__ void __launch_bounds__(kThreads, kScanBlocks) chunk_scan(
    const TX* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ dtw, const float* __restrict__ bias,
    const float* __restrict__ A, const float* __restrict__ dsk,
    float* __restrict__ state, float* __restrict__ sumda, float* __restrict__ xdbl,
    TY* __restrict__ y, int L, int D, int T, int nc) {
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
