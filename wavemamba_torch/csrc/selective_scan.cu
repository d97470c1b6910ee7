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
// What bounds it on an H100 (`chip_smoke.py:k3_bound`): per token and stream
// it reads u, delta (2D floats), B, C (2N floats) and writes y (D floats),
// 4(3D + 2N) bytes, against one exp per (n, d) on the special-function units
// (16 per SM per clock): at the shipped widths (D=64, N=16) the two bounds
// are about equal. A design parallel over L computes that exp twice, as K1
// does (ss2d_scan.cu): the design floor is two SFU passes.
//
// Design. The TPU kernel walks a stream's chunks in sequence with h in a
// scratch that survives grid steps; here that would leave B*K blocks busy. As
// K1, the kernel is parallel over L in chunks of T <= 64 tokens:
//   1. selective_chunk<false>: one block per (chunk, stream, 64-channel
//      group). It stages B of the chunk and (da, u) of every (token, channel)
//      in shared memory, then scans the chunk from h = 0 and writes its end
//      state and its sum of da (the chunk's decay is exp(A * sum da)).
//   2. selective_prefix: for each (g, n, d), a prefix over the chunks gives
//      each chunk's entering state, written over the end states. A block
//      holds 16 lanes; a worker a lane for every 8 chunks (at most 64) takes
//      a run of chunks, loading 8 chunks' values before it uses them, and the
//      runs' transitions are combined in worker order.
//   3. selective_chunk<true>: stages B, C and (da, u) again, reruns the chunk
//      from its entering state and writes y. The last chunk is ragged, not
//      padded.
// The entering states and the sums of da stay behind for K4, in its layouts.
//
// The first design ran one thread per channel (blocks of D threads) holding
// all 16 states, with an accurate expf per decay in both passes (~8
// instructions around each SFU op), B and C staged one float at a time with
// a divide and a modulo each, and a prefix of 32 serial, unbatched walks a
// lane. What this version does:
//   - A quad of threads holds one channel, 4 of the 16 states each: a block
//     of 256 threads scans 64 channels, and its launch bounds ask for four
//     blocks (32 warps) an SM, by its 40 KB of shared memory and at most 64
//     registers a thread (`ops/scan_cuda.py:k3_plan`). A token's B and C
//     (one float4 each a lane) and its (da, u) (one float2) are read from
//     shared memory by broadcast.
//   - A decay is one ex2.approx.ftz of da * (A log2 e), A log2 e held in
//     registers. softplus stays log1pf(expf) (`wm::softplus`): an approximate
//     one moved K1's model gradients 4x.
//   - Staging: B and C arrive as one 16-byte load a thread each, u and delta
//     as 16-byte loads of 4 channels, 4 tokens a thread, every load in flight
//     before the first is used (4-byte loads where D is not a multiple of 4).
//     da is computed once per (token, channel) and pass, in parallel, before
//     the serial walk, which steps its rows by pointer.
//   - The replay sums y over n four tokens at a time: a transposing
//     butterfly in the quad leaves each token's sum on one lane, 3 shuffles
//     for 4 tokens where one token at a time takes 8, and each lane writes
//     one y.
//   - The token loop is compiled apart for a whole chunk, with a trip count
//     the compiler knows, and for a ragged last one.
// Tried on an H100 in kernel-only A/B calls and dropped (PERF.md §6): a
// quad per channel pair (K1's layout) in 128-thread blocks, whose walk alone
// (staging taken out) was faster but which with its staging was no faster
// and spilled at 96 registers; persistent blocks that stage the next half
// chunk by cp.async during the walk, slower; five resident blocks of this
// layout, which spill at 48 registers, slower in the replay.

#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

#include "selective_scan_common.cuh"

namespace {

constexpr int kGroup = 64;                // channels a block scans; D > 64 takes more groups
constexpr int kQuad = 4;                  // threads a channel: N / 4 states each
constexpr int kThreads = kGroup * kQuad;  // 256
constexpr int kScanBlocks = 4;            // resident blocks an SM the launch bounds ask for
constexpr int kTMax = 64;                 // tokens a chunk holds; T <= kTMax
constexpr int kPrefixLanes = 16;          // (n, d) lanes a selective_prefix block holds
constexpr int kPrefixWorkers = 64;        // workers a lane at most, each a run of chunks
constexpr int kPrefixThreads = kPrefixLanes * kPrefixWorkers;
constexpr int kPrefixBlocks = 2;          // resident blocks an SM its launch bounds ask for
constexpr int kBatch = 8;                 // chunks a selective_prefix worker loads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;  // exp(v) = exp2(v log2 e)

// 2^v in one SFU instruction. Results below 2^-126 flush to zero: far below
// what the float32 sums they enter can resolve.
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Shared memory of selective_chunk (both passes): B | C of the chunk's tokens
// [T][2N], and (da, u) of each (token, channel of the group) [T][kGroup].
__host__ __device__ constexpr int scan_smem_floats(int N, int T) {
  return T * 2 * N + 2 * T * kGroup;
}

// (da, u) of the chunk's tc tokens and the group's channels g0 .. g0 + 63
// into dau [T][kGroup], da zero beyond D. ug, zg: u and delta of the chunk's
// first token; bias_k: the bias of the stream's direction.
__device__ __forceinline__ void stage_dau(const float* __restrict__ ug,
                                          const float* __restrict__ zg,
                                          const float* __restrict__ bias_k, float2* dau,
                                          int tc, int D, int g0) {
  const int tid = threadIdx.x;
  if ((D & 3) == 0) {
    // A thread takes 4 channels (one 16-byte load of u and of delta) of 4
    // tokens, 16 rows apart.
    constexpr int kCols = kGroup / 4;
    constexpr int kRows = kTMax * kCols / kThreads;
    const int c = 4 * (tid % kCols), t0 = tid / kCols;
    const int d = g0 + c;
    const bool on = d < D;  // all four channels, as D is a multiple of 4
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 bk = on ? *reinterpret_cast<const float4*>(bias_k + d) : zero;
    float4 uv[kRows], zv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = t0 + r * (kThreads / kCols);
      const bool ok = on && t < tc;
      uv[r] = ok ? *reinterpret_cast<const float4*>(ug + (size_t)t * D + d) : zero;
      zv[r] = ok ? *reinterpret_cast<const float4*>(zg + (size_t)t * D + d) : zero;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = t0 + r * (kThreads / kCols);
      if (t >= tc) continue;
      const float4 u = uv[r], z = zv[r];
      float4* o = reinterpret_cast<float4*>(dau + t * kGroup + c);
      o[0] = make_float4(on ? wm::softplus(z.x + bk.x) : 0.f, u.x,
                         on ? wm::softplus(z.y + bk.y) : 0.f, u.y);
      o[1] = make_float4(on ? wm::softplus(z.z + bk.z) : 0.f, u.z,
                         on ? wm::softplus(z.w + bk.w) : 0.f, u.w);
    }
  } else {
    // A thread takes one channel of 16 tokens, 4 rows apart.
    constexpr int kRows = kTMax * kGroup / kThreads;
    const int dl = tid % kGroup, t0 = tid / kGroup;
    const int d = g0 + dl;
    const bool on = d < D;
    const float bk = on ? bias_k[d] : 0.f;
    float uu[kRows], zz[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = t0 + r * (kThreads / kGroup);
      const bool ok = on && t < tc;
      uu[r] = ok ? ug[(size_t)t * D + d] : 0.f;
      zz[r] = ok ? zg[(size_t)t * D + d] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = t0 + r * (kThreads / kGroup);
      if (t < tc) dau[t * kGroup + dl] = make_float2(on ? wm::softplus(zz[r] + bk) : 0.f, uu[r]);
    }
  }
}

// The serial walk of one lane over `count` tokens: one channel, states
// 4q .. 4q + 3 (h, and An = A log2 e). dp: (da, u) of the first token; bq:
// the lane's 4 values of its B row (C follows at + N); yp: the channel's y,
// which the replay writes where the channel is `on` (< D). Pass 1 sums da in
// token order into sda.
template <int N, bool REPLAY>
__device__ __forceinline__ void walk(int count, const float2* dp, const float* bq, float* yp,
                                     int D, int q, float (&h)[4], const float (&An)[4], float dk,
                                     bool on, float& sda) {
  int s = 0;
  if (REPLAY) {
    // Four tokens a round: each lane sums C . h over its 4 states for every
    // token, and a transposing butterfly over the quad (3 shuffles) leaves
    // the sum of token 4r + q on lane q, which writes its y.
    const bool h1 = q & 2, h0 = q & 1;
#pragma unroll 1
    for (; s + 4 <= count; s += 4) {
      float acc[4], uu[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 p = dp[j * kGroup];
        const float4 bv = *reinterpret_cast<const float4*>(bq + j * 2 * N);
        const float du = p.x * p.y;
        h[0] = fmaf(ex2(p.x * An[0]), h[0], du * bv.x);
        h[1] = fmaf(ex2(p.x * An[1]), h[1], du * bv.y);
        h[2] = fmaf(ex2(p.x * An[2]), h[2], du * bv.z);
        h[3] = fmaf(ex2(p.x * An[3]), h[3], du * bv.w);
        const float4 cv = *reinterpret_cast<const float4*>(bq + j * 2 * N + N);
        float a = cv.x * h[0];
        a = fmaf(cv.y, h[1], a);
        a = fmaf(cv.z, h[2], a);
        acc[j] = fmaf(cv.w, h[3], a);
        uu[j] = p.y;
      }
      // Each token's sum is taken once, on one lane, in a fixed order: the
      // same inputs give the same bits.
      const float a0 = (h1 ? acc[2] : acc[0]) + __shfl_xor_sync(kFull, h1 ? acc[0] : acc[2], 2);
      const float a1 = (h1 ? acc[3] : acc[1]) + __shfl_xor_sync(kFull, h1 ? acc[1] : acc[3], 2);
      const float sum = (h0 ? a1 : a0) + __shfl_xor_sync(kFull, h0 ? a0 : a1, 1);
      const float uq = h1 ? (h0 ? uu[3] : uu[2]) : (h0 ? uu[1] : uu[0]);
      if (on) yp[q * D] = fmaf(dk, uq, sum);
      dp += 4 * kGroup;
      bq += 4 * 2 * N;
      yp += 4 * D;
    }
  }
  // Pass 1, and the replay's last count % 4 tokens, one token a round.
#pragma unroll 4
  for (; s < count; ++s) {
    const float2 p = *dp;
    const float4 bv = *reinterpret_cast<const float4*>(bq);
    const float du = p.x * p.y;
    h[0] = fmaf(ex2(p.x * An[0]), h[0], du * bv.x);
    h[1] = fmaf(ex2(p.x * An[1]), h[1], du * bv.y);
    h[2] = fmaf(ex2(p.x * An[2]), h[2], du * bv.z);
    h[3] = fmaf(ex2(p.x * An[3]), h[3], du * bv.w);
    if (REPLAY) {
      const float4 cv = *reinterpret_cast<const float4*>(bq + N);
      float acc = cv.x * h[0];
      acc = fmaf(cv.y, h[1], acc);
      acc = fmaf(cv.z, h[2], acc);
      acc = fmaf(cv.w, h[3], acc);
      // (own + lane q ^ 1's) + (the other pair's): every lane of the quad
      // adds the same pairs, so each holds the same bits.
      acc += __shfl_xor_sync(kFull, acc, 1);
      acc += __shfl_xor_sync(kFull, acc, 2);
      if (on && q == 0) *yp = fmaf(dk, p.y, acc);
      yp += D;
    } else {
      sda += p.x;
    }
    dp += kGroup;
    bq += 2 * N;
  }
}

template <int N, bool REPLAY>
__global__ void __launch_bounds__(kThreads, kScanBlocks) selective_chunk(
    const float* __restrict__ u, const float* __restrict__ delta,
    const float* __restrict__ A, const float* __restrict__ Bs,
    const float* __restrict__ Cs, const float* __restrict__ dsk,
    const float* __restrict__ bias, float* __restrict__ state,
    float* __restrict__ sumda, float* __restrict__ y,
    int K, int L, int D, int T, int nc) {
  static_assert(N == 4 * kQuad, "a lane holds 4 states, one float4 of B and of C");
  extern __shared__ float4 smem4[];
  float* bc = reinterpret_cast<float*>(smem4);              // [T][2N]: B_t | C_t
  float2* dau = reinterpret_cast<float2*>(bc + T * 2 * N);  // [T][kGroup]: (da, u)
  const int c = blockIdx.x, g = blockIdx.y, g0 = blockIdx.z * kGroup, k = g % K;
  const int l0 = c * T;
  const int tc = min(T, L - l0);
  const int tid = threadIdx.x;

  // B (and C) of the chunk: tc rows of N floats, N / 4 float4 a row.
  constexpr int kRow4 = N / 4;
  const size_t row0 = (size_t)g * L + l0;
  if (tid < tc * kRow4) {
    const int t = tid / kRow4, e = 4 * (tid % kRow4);
    *reinterpret_cast<float4*>(bc + t * 2 * N + e) =
        reinterpret_cast<const float4*>(Bs + row0 * N)[tid];
    if (REPLAY) {
      *reinterpret_cast<float4*>(bc + t * 2 * N + N + e) =
          reinterpret_cast<const float4*>(Cs + row0 * N)[tid];
    }
  }
  stage_dau(u + row0 * D, delta + row0 * D, bias + (size_t)k * D, dau, tc, D, g0);

  // Channel g0 + dl, states 4q .. 4q + 3.
  const int dl = tid / kQuad, q = tid % kQuad;
  const int d = g0 + dl;
  const bool on = d < D;
  const size_t ci = (size_t)g * nc + c;
  float An[4], h[4];
  const float4 a = on ? *reinterpret_cast<const float4*>(A + ((size_t)k * D + d) * N + kQuad * q)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  An[0] = a.x * kLog2e;
  An[1] = a.y * kLog2e;
  An[2] = a.z * kLog2e;
  An[3] = a.w * kLog2e;
  float* st = state + (ci * N + kQuad * q) * D + d;  // state[ci][4q + i][d] at + i D
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = REPLAY && on ? st[(size_t)i * D] : 0.f;
  const float dk = on ? dsk[k * D + d] : 0.f;
  float sda = 0.f;
  __syncthreads();

  const float2* dp = dau + dl;
  const float* bq = bc + kQuad * q;
  float* yp = y + row0 * D + d;
  if (tc == kTMax) {
    walk<N, REPLAY>(kTMax, dp, bq, yp, D, q, h, An, dk, on, sda);
  } else {
    walk<N, REPLAY>(tc, dp, bq, yp, D, q, h, An, dk, on, sda);
  }
  if (!REPLAY && on) {
#pragma unroll
    for (int i = 0; i < 4; ++i) st[(size_t)i * D] = h[i];
    if (q == 0) sumda[ci * D + d] = sda;
  }
}

// Entering state of every chunk, in place of its end state. A chunk acts on
// what enters it as h -> exp(A * sumda) * h + end, where `end` is its state
// when nothing enters it. Lane = one (n, d) of a stream; the stream's chunks
// are split among blockDim.y workers (`prefix_workers`), each a run of
// consecutive chunks, whose transitions are combined in worker order. The
// launch bounds hold it to 32 registers: two blocks of 64 workers an SM.
__global__ void __launch_bounds__(kPrefixThreads, kPrefixBlocks) selective_prefix(
    const float* __restrict__ A, float* __restrict__ state,
    const float* __restrict__ sumda, int K, int N, int D, int nc) {
  __shared__ float agg_a[kPrefixWorkers][kPrefixLanes];
  __shared__ float agg_h[kPrefixWorkers][kPrefixLanes];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int ND = N * D;
  const int nd = blockIdx.x * kPrefixLanes + lane;
  const int g = blockIdx.y, k = g % K;
  const bool valid = nd < ND;
  const int n = nd / D, d = nd - n * D;
  const float a_nd = valid ? A[((size_t)k * D + d) * N + n] * kLog2e : 0.f;
  const int seg = (nc + (int)blockDim.y - 1) / (int)blockDim.y;
  const int p0 = min(nc, w * seg), cnt = min(nc, p0 + seg) - p0;
  const size_t c0 = (size_t)g * nc + p0;  // the run's first chunk
  const float* sp = sumda + c0 * D + d;
  float* hp = state + c0 * ND + nd;

  float pa = 1.f, ph = 0.f;  // this worker's run of chunks as one transition
  if (valid) {
    const float* s = sp;
    const float* e = hp;
    for (int i = 0; i < cnt; i += kBatch, s += kBatch * D, e += (size_t)kBatch * ND) {
      float a[kBatch], he[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const bool in = i + j < cnt;
        a[j] = in ? ex2(a_nd * s[j * D]) : 1.f;
        he[j] = in ? e[(size_t)j * ND] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        ph = fmaf(a[j], ph, he[j]);
        pa *= a[j];
      }
    }
  }
  agg_a[w][lane] = pa;
  agg_h[w][lane] = ph;
  __syncthreads();
  if (!valid) return;

  float hc = 0.f;  // state entering this worker's first chunk
  for (int v = 0; v < w; ++v) hc = fmaf(agg_a[v][lane], hc, agg_h[v][lane]);
  for (int i = 0; i < cnt; i += kBatch, sp += kBatch * D, hp += (size_t)kBatch * ND) {
    float a[kBatch], he[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool in = i + j < cnt;
      a[j] = in ? ex2(a_nd * sp[j * D]) : 1.f;
      he[j] = in ? hp[(size_t)j * ND] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (i + j < cnt) {
        hp[(size_t)j * ND] = hc;
        hc = fmaf(a[j], hc, he[j]);
      }
    }
  }
}

// Workers a lane of selective_prefix: one for every kBatch chunks, at most
// kPrefixWorkers.
int prefix_workers(int nc) { return min(kPrefixWorkers, (nc + kBatch - 1) / kBatch); }

template <int N>
cudaError_t set_smem(int T) {
  const int smem = (int)sizeof(float) * scan_smem_floats(N, T);
  cudaError_t e = cudaFuncSetAttribute(selective_chunk<N, false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(selective_chunk<N, true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int N>
cudaError_t launch(const float* u, const float* delta, const float* A, const float* Bs,
                   const float* Cs, const float* dsk, const float* bias,
                   float* y, float* state, float* sumda,
                   int B, int K, int L, int D, int T, cudaStream_t stream) {
  const int nc = (L + T - 1) / T;
  const int G = B * K;
  const size_t smem = sizeof(float) * scan_smem_floats(N, T);
  cudaError_t e = set_smem<N>(T);
  if (e != cudaSuccess) return e;
  const dim3 grid(nc, G, (D + kGroup - 1) / kGroup);
  selective_chunk<N, false><<<grid, kThreads, smem, stream>>>(
      u, delta, A, Bs, Cs, dsk, bias, state, sumda, y, K, L, D, T, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 pgrid((N * D + kPrefixLanes - 1) / kPrefixLanes, G);
  selective_prefix<<<pgrid, dim3(kPrefixLanes, prefix_workers(nc)), 0, stream>>>(
      A, state, sumda, K, N, D, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  selective_chunk<N, true><<<grid, kThreads, smem, stream>>>(
      u, delta, A, Bs, Cs, dsk, bias, state, sumda, y, K, L, D, T, nc);
  return cudaGetLastError();
}

bool takes(int N, int D, int T) {
  return N == 16 && D >= 1 && D <= 4 * kGroup && T >= 1 && T <= kTMax;
}

}  // namespace

extern "C" {

// u, delta (B, K, L, D); A (K, D, N); Bs, Cs (B, K, L, N); dsk, bias (K, D);
// y (B, K, L, D); what K4 reads: state (B, K, nc, N, D), the state entering
// each chunk, and sumda (B, K, nc, D), each chunk's sum of da, nc = ceil(L /
// T). All f32, contiguous, on the device of `stream`; u, delta, A, Bs, Cs and
// bias start on a 16-byte boundary. `smem` is the dynamic shared memory the
// caller planned for selective_chunk: the launch is refused unless it is this
// source's. Takes N == 16, D <= 256, B * K <= 65535 and T <= 64. Returns a
// cudaError_t.
int selective_scan_fwd_f32(const void* u, const void* delta, const void* A,
                           const void* Bs, const void* Cs, const void* dsk,
                           const void* bias, void* y, void* state, void* sumda,
                           int B, int K, int L, int D, int N, int T, int smem, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  if (!takes(N, D, T) || B * K > 65535 || smem != (int)sizeof(float) * scan_smem_floats(N, T)) {
    return cudaErrorInvalidValue;
  }
  for (const void* p : {u, delta, A, Bs, Cs, bias}) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  }
  return launch<16>(f(u), f(delta), f(A), f(Bs), f(Cs), f(dsk), f(bias), m(y), m(state),
                    m(sumda), B, K, L, D, T, static_cast<cudaStream_t>(stream));
}

// The launch geometry on the current device for D channels and L tokens a
// stream: out[0] threads a block of selective_chunk, out[1] its dynamic
// shared memory, out[2] / out[3] the resident blocks an SM of pass 1 / the
// replay, out[4] threads a block of selective_prefix, out[5] its resident
// blocks an SM, as cudaOccupancyMaxActiveBlocksPerMultiprocessor reports them
// (registers included). Returns a cudaError_t.
int selective_scan_occupancy(int N, int D, int L, int T, int* out) {
  if (!takes(N, D, T) || L < 1) return cudaErrorInvalidValue;
  cudaError_t e = set_smem<16>(T);
  if (e != cudaSuccess) return e;
  out[0] = kThreads;
  out[1] = (int)sizeof(float) * scan_smem_floats(16, T);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, selective_chunk<16, false>, kThreads,
                                                    out[1]);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, selective_chunk<16, true>, kThreads,
                                                    out[1]);
  if (e != cudaSuccess) return e;
  out[4] = kPrefixLanes * prefix_workers((L + T - 1) / T);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 5, selective_prefix, out[4], 0);
}

const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
