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
// What bounds it on an H100 (`chip_smoke.py:k4_bound`): the bytes. Per token
// and stream it reads u, delta, dy, B, C and writes du, ddelta, dB, dC:
// 4(5D + 4N) bytes, 1.0 ms at 8 x 4 x 65,536 tokens (D=64, N=16). The
// recompute of h, the adjoint and the sums take some 20 float32 operations
// per (n, d), 0.66 ms on the FMA pipe; one pass of the special-function units
// over every (token, n, d) takes 0.58 ms. In practice the issue of bwd_main's
// sweep sets the pace: ~100 instructions a warp a token, 25 of them the
// butterfly and the quad sums.
//
// Design. The TPU kernel sweeps a stream's chunks in reverse grid order with g
// in a scratch: B*K busy blocks here. As K2 (ss2d_scan_bwd.cu) it is parallel
// over L in chunks of T tokens, whose entering states K3 has left:
//   1. bwd_local: one block per (chunk, stream) runs the adjoint backwards
//      over the chunk from g = 0 and writes what leaves it, a_first * g_first.
//   2. bwd_prefix: that becomes what enters each chunk, by a prefix over the
//      chunks from the last.
//   3. bwd_main: a forward pass over the chunk keeps h at the head of every
//      sub-tile of kSub tokens in shared memory; then, sub-tile by sub-tile
//      from the last, h is recomputed for kSub tokens into registers and g
//      sweeps back over them. The recurrence is never inverted.
//   4. bwd_reduce adds the blocks' partial sums in a fixed order.
//
// The first design ran one thread per (stream, channel) in 64-thread blocks
// with 75 KB of shared memory: 6 resident warps an SM, where every exp,
// shared-memory load and dependent FMA of the serial recurrence waited its
// full latency; a grid of two waves and a tail; sums over channels as 64-long
// serial loops; the exp computed four times with expf. What this version
// does about each:
//   - Occupancy. A quad of threads holds one channel, 4 of the 16 states
//     each: a block holds DM = 64 (or 128) channels, 4 * DM threads. At DM =
//     64 bwd_main keeps two blocks (16 warps) an SM, by its 112 KB of shared
//     memory and its 128 registers a thread; bwd_local (36 KB, at most 64
//     registers) keeps four (32 warps). The sums over n (g.B, dda) are two
//     xor-shuffles in the quad.
//   - The grid. bwd_main runs gx blocks for each direction k, as many in all
//     as reside at once (`ops/scan_cuda.py:k4_plan`): one whole wave. Each
//     strides over the B * nc (batch, chunk) pairs of its k, so its partial
//     sums of dA, dD_skip and dbias belong to one k.
//   - The channel sums. dB and dC of a token are a transposing butterfly over
//     the warp's 8 channels (7 shuffles for 8 values a lane) and one sum over
//     the warps in warp order, in place of 64-long serial loops.
//   - Compute once. da, u, sigmoid(z) and dy of the chunk are staged once, in
//     parallel over (token, channel), before the serial passes, as one float4
//     per (token, channel), with every load of a thread in flight at once;
//     du and ddelta take their token's place there during the sweep and leave
//     in whole rows after it. The checkpoint pass stops at the last
//     sub-tile's head. A decay is one ex2.approx.ftz of da * (A log2 e);
//     softplus stays log1pf(expf): an approximate one moved K1's model
//     gradients 4x. The sweep recomputes its decays: keeping a sub-tile's
//     beside h takes 32 more registers, which spill at bwd_main's 128.
//   - The sub-tile's recompute and sweep are compiled apart for a whole
//     sub-tile, without the token guards that kept the compiler from
//     interleaving tokens, and for a chunk's ragged last one.
//   - bwd_prefix holds 16 lanes of a stream a block, up to 64 workers a lane
//     (one for every 16 chunks), each loading 16 chunks' values before it
//     uses them, as K1's chunk_prefix.
// Sums over tokens are taken per chunk, then over a block's chunks, then over
// the blocks in bwd_reduce, each in a fixed order; every shuffle sum has a
// fixed order too, so the result is the same bits every run. No float atomics.

#include <stddef.h>

#include <type_traits>

#include "selective_scan_common.cuh"

namespace {

constexpr int kSub = 8;    // tokens per sub-tile of bwd_main
constexpr int kTMax = 64;  // tokens a chunk holds; T <= kTMax
constexpr int kQuad = 4;   // threads per channel
constexpr int kPrefixLanes = 16;    // (n, d) lanes a bwd_prefix block holds
constexpr int kPrefixWorkers = 64;  // workers a lane, each a run of chunks
constexpr int kPrefixThreads = kPrefixLanes * kPrefixWorkers;
constexpr int kBatch = 16;          // chunks a bwd_prefix worker loads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;  // exp(v) = exp2(v log2 e)
constexpr float kLn2 = 0.6931471805599453f;

// 2^v in one SFU instruction. Results below 2^-126 flush to zero: they are
// far below what the float32 sums they enter can resolve.
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// softplus(v) (torch.nn.functional.softplus, threshold 20, as K3) and
// sigmoid(v) from one exp.
__device__ __forceinline__ void softplus_sigmoid(float v, float& sp, float& sg) {
  const float e = expf(v);
  sp = v > 20.f ? v : log1pf(e);
  sg = v > 20.f ? 1.f : e * __frcp_rn(1.f + e);
}

// Where a thread sits: channel d = 8 * warp + lane / 4, and q = lane % 4, the
// quarter of the states (n = 4q .. 4q+3) it holds. Channels d >= D are idle
// lanes that compute on zeros and write nothing.
struct Lane {
  int d, q, dl, w;
  bool active;
};

__device__ __forceinline__ Lane lane_of(int D) {
  Lane l;
  const int tid = threadIdx.x;
  l.w = tid >> 5;
  l.q = tid & 3;
  l.dl = (tid >> 2) & 7;
  l.d = l.w * 8 + l.dl;
  l.active = l.d < D;
  return l;
}

// The sum over a quad's four lanes; every lane gets the same bits.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// v[0..7] of each lane summed over the 8 lanes of the warp that share q
// (lanes 4 apart): lane dl returns the sum of value dl. 7 shuffles.
__device__ __forceinline__ float transpose_sum8(const float (&v)[8], int dl) {
  const bool h2 = dl & 4, h1 = dl & 2, h0 = dl & 1;
  float a[4], c[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = (h2 ? v[i + 4] : v[i]) + __shfl_xor_sync(kFull, h2 ? v[i] : v[i + 4], 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    c[i] = (h1 ? a[i + 2] : a[i]) + __shfl_xor_sync(kFull, h1 ? a[i] : a[i + 2], 8);
  }
  return (h0 ? c[1] : c[0]) + __shfl_xor_sync(kFull, h0 ? c[0] : c[1], 4);
}

size_t local_smem(int N, int DM, int T) {
  return sizeof(float) * ((size_t)T * N + (size_t)2 * T * DM);
}

size_t main_smem(int N, int DM, int T) {
  return sizeof(float) * ((size_t)T * 2 * N + (size_t)4 * T * DM + (size_t)(T / kSub) * DM * N +
                          (size_t)(DM / 8) * kSub * 2 * N);
}

// Phase 1: what the adjoint carries out of each chunk when nothing enters it.
// The launch bounds ask for 256 / DM blocks an SM (32 warps): at most 64
// registers a thread.
template <int N, int DM>
__global__ void __launch_bounds__(kQuad * DM, 256 / DM) bwd_local(
    const float* __restrict__ delta, const float* __restrict__ A,
    const float* __restrict__ Cs, const float* __restrict__ bias,
    const float* __restrict__ dy, float* __restrict__ gcar,
    int K, int L, int D, int T, int nc) {
  constexpr int kThreads = kQuad * DM;
  constexpr int NQ = N / kQuad;
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);                // [T][N] C
  float2* dd = reinterpret_cast<float2*>(cs + T * N);         // [T][DM] (da, dy)
  const int c = blockIdx.x, g = blockIdx.y, k = g % K;
  const int l0 = c * T;
  const int tc = min(T, L - l0);
  const int tid = threadIdx.x;

  const float* cg = Cs + ((size_t)g * L + l0) * N;
  for (int i = tid; i < tc * N; i += kThreads) cs[i] = cg[i];
  {
    // Each thread stages kRows tokens of one channel: every load is in flight
    // before the first is used.
    constexpr int kRows = kTMax * DM / kThreads;
    const int dch = tid % DM;
    const bool on = dch < D;
    const float bk = on ? bias[k * D + dch] : 0.f;
    const size_t off = ((size_t)g * L + l0) * D + dch;
    float zs[kRows], ys[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = tid / DM + r * (kThreads / DM);
      const bool ok = on && t < tc;
      zs[r] = ok ? delta[off + (size_t)t * D] : 0.f;
      ys[r] = ok ? dy[off + (size_t)t * D] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = tid / DM + r * (kThreads / DM);
      if (t < tc) dd[t * DM + dch] = make_float2(on ? wm::softplus(zs[r] + bk) : 0.f, ys[r]);
    }
  }
  __syncthreads();

  const Lane ln = lane_of(D);
  float An[NQ], ga[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    An[i] = ln.active ? A[((size_t)k * D + ln.d) * N + kQuad * ln.q + i] * kLog2e : 0.f;
    ga[i] = 0.f;  // a_{t+1} g_{t+1}
  }
#pragma unroll 4
  for (int t = tc - 1; t >= 0; --t) {
    const float2 p = dd[t * DM + ln.d];
    const float4 cv = *reinterpret_cast<const float4*>(cs + t * N + kQuad * ln.q);
    const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int i = 0; i < NQ; ++i) ga[i] = ex2(p.x * An[i]) * fmaf(cc[i], p.y, ga[i]);
  }
  if (ln.active) {
    float* go = gcar + ((size_t)g * nc + c) * N * D + ln.d;
#pragma unroll
    for (int i = 0; i < NQ; ++i) go[(size_t)(kQuad * ln.q + i) * D] = ga[i];
  }
}

// Phase 2: what enters every chunk, in place of what leaves it. A chunk acts
// on what enters it as g -> exp(A * sumda) * g + carry, so a prefix over the
// chunks from the last turns each chunk's carry into what enters it. A block
// holds kPrefixLanes (n, d) lanes of one stream; blockDim.y workers a lane
// (up to kPrefixWorkers, one a kBatch chunks) each take a run of chunks,
// loading kBatch chunks' values before they use them, and the runs'
// transitions are combined in worker order.
__global__ void __launch_bounds__(kPrefixThreads) bwd_prefix(
    const float* __restrict__ A, float* __restrict__ gcar,
    const float* __restrict__ sumda, int K, int N, int D, int nc) {
  __shared__ float agg_a[kPrefixWorkers][kPrefixLanes];
  __shared__ float agg_g[kPrefixWorkers][kPrefixLanes];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int ND = N * D;
  const int nd = blockIdx.x * kPrefixLanes + lane;
  const int g = blockIdx.y, k = g % K;
  const bool valid = nd < ND;
  const int n = nd / D, d = nd - n * D;
  const float a_nd = valid ? A[((size_t)k * D + d) * N + n] * kLog2e : 0.f;
  const int workers = blockDim.y;
  const int seg = (nc + workers - 1) / workers;
  const int p0 = min(nc, w * seg), cnt = min(nc, p0 + seg) - p0;
  // The run's first chunk, counted from the last, and the chunks before it.
  const size_t c0 = (size_t)g * nc + (cnt > 0 ? nc - 1 - p0 : 0);
  const ptrdiff_t sstep = -(ptrdiff_t)D, gstep = -(ptrdiff_t)ND;
  const float* sp = sumda + c0 * D + d;
  float* gp = gcar + c0 * ND + nd;

  float pa = 1.f, pg = 0.f;  // this worker's run of chunks as one transition
  if (valid) {
    const float* s = sp;
    const float* q = gp;
    for (int i = 0; i < cnt; i += kBatch, s += kBatch * sstep, q += kBatch * gstep) {
      float a[kBatch], ge[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool in = i + u < cnt;
        a[u] = in ? ex2(a_nd * s[u * sstep]) : 1.f;
        ge[u] = in ? q[u * gstep] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        pg = fmaf(a[u], pg, ge[u]);
        pa *= a[u];
      }
    }
  }
  agg_a[w][lane] = pa;
  agg_g[w][lane] = pg;
  __syncthreads();
  if (!valid) return;

  float gc = 0.f;  // what enters this worker's first chunk
  for (int v = 0; v < w; ++v) gc = fmaf(agg_a[v][lane], gc, agg_g[v][lane]);
  for (int i = 0; i < cnt; i += kBatch, sp += kBatch * sstep, gp += kBatch * gstep) {
    float a[kBatch], ge[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool in = i + u < cnt;
      a[u] = in ? ex2(a_nd * sp[u * sstep]) : 1.f;
      ge[u] = in ? gp[u * gstep] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i + u < cnt) {
        gp[u * gstep] = gc;
        gc = fmaf(a[u], gc, ge[u]);
      }
    }
  }
}

// Phase 3: the gradients. Block (x, k) strides over the B * nc (batch, chunk)
// pairs of direction k. The launch bounds ask for 128 / DM blocks an SM (16
// warps): at most 128 registers a thread. part: [K][gridDim.x][N + 2][D] partial sums of a
// block: dA (N rows), dD_skip, dbias.
template <int N, int DM>
__global__ void __launch_bounds__(kQuad * DM, 128 / DM) bwd_main(
    const float* __restrict__ u, const float* __restrict__ delta,
    const float* __restrict__ A, const float* __restrict__ Bs,
    const float* __restrict__ Cs, const float* __restrict__ dsk,
    const float* __restrict__ bias, const float* __restrict__ state,
    const float* __restrict__ gcar, const float* __restrict__ dy,
    float* __restrict__ du, float* __restrict__ ddelta,
    float* __restrict__ dB, float* __restrict__ dC, float* __restrict__ part,
    int B, int K, int L, int D, int T, int nc) {
  constexpr int kThreads = kQuad * DM;
  constexpr int S = kSub;
  constexpr int NQ = N / kQuad;
  constexpr int W = DM / 8;  // warps of a block
  constexpr int kRows = kTMax * DM / kThreads;  // tokens of a chunk a thread stages
  static_assert(NQ == 4, "a lane holds 4 states, one float4 of B and of C");
  static_assert(kThreads >= S * 2 * N, "a thread a (token, n) of a sub-tile's dB and dC");
  extern __shared__ float4 smem4[];
  float* bc = reinterpret_cast<float*>(smem4);        // [T][2N]: B_t | C_t
  float4* pk = reinterpret_cast<float4*>(bc + T * 2 * N);  // [T][DM]: da, u, sigmoid(z), dy
  float* hb = reinterpret_cast<float*>(pk + T * DM);  // [T/S][DM][N] h entering each sub-tile
  float* red = hb + (T / S) * DM * N;                 // [W][S][2N] the warps' sums over d

  const int tid = threadIdx.x;
  const int k = blockIdx.y;
  const Lane ln = lane_of(D);
  const int d = ln.d, q = ln.q;
  const int dch = tid % DM;  // the channel this thread stages
  const bool on = dch < D;
  const float bk = on ? bias[k * D + dch] : 0.f;
  float An[NQ], dA_acc[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    An[i] = ln.active ? A[((size_t)k * D + d) * N + kQuad * q + i] * kLog2e : 0.f;
    dA_acc[i] = 0.f;
  }
  const float dk = ln.active ? dsk[k * D + d] : 0.f;
  float dbias_acc = 0.f, ddsk_acc = 0.f;

  for (int item = blockIdx.x; item < B * nc; item += gridDim.x) {
    const int b = item / nc, c = item - b * nc;
    const int g = b * K + k;
    const int l0 = c * T;
    const int tc = min(T, L - l0);
    const size_t ci = (size_t)g * nc + c;
    // The chunk's entering state and adjoint, loaded while the tiles stage.
    float h[NQ], ga[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const size_t o = (ci * N + kQuad * q + i) * D + d;
      h[i] = ln.active ? state[o] : 0.f;
      ga[i] = ln.active ? gcar[o] : 0.f;
    }
    __syncthreads();  // the previous chunk's tiles are free
    {
      const float* bg = Bs + ((size_t)g * L + l0) * N;
      const float* cg = Cs + ((size_t)g * L + l0) * N;
      for (int i = tid; i < tc * N; i += kThreads) {
        const int t = i / N, n = i - t * N;
        bc[t * 2 * N + n] = bg[i];
        bc[t * 2 * N + N + n] = cg[i];
      }
      // Each thread stages kRows tokens of its channel: every load is in
      // flight before the first is used.
      const size_t off = ((size_t)g * L + l0) * D + dch;
      float zs[kRows], us[kRows], ys[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int t = tid / DM + r * (kThreads / DM);
        const bool ok = on && t < tc;
        const size_t o = off + (size_t)t * D;
        zs[r] = ok ? delta[o] : 0.f;
        us[r] = ok ? u[o] : 0.f;
        ys[r] = ok ? dy[o] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int t = tid / DM + r * (kThreads / DM);
        if (t < tc) {
          float sp, sg;
          softplus_sigmoid(zs[r] + bk, sp, sg);
          pk[t * DM + dch] = on ? make_float4(sp, us[r], sg, ys[r]) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    __syncthreads();

    const int nsub = (tc + S - 1) / S;
    // h at the head of every sub-tile, from the chunk's entering state; each
    // thread keeps its own four states there. The pass stops at the last head.
    for (int j = 0;; ++j) {
      *reinterpret_cast<float4*>(hb + (j * DM + d) * N + kQuad * q) = make_float4(h[0], h[1], h[2], h[3]);
      if (j == nsub - 1) break;
#pragma unroll
      for (int si = 0; si < S; ++si) {
        const int t = j * S + si;
        const float4 p = pk[t * DM + d];
        const float dau = p.x * p.y;
        const float4 bv = *reinterpret_cast<const float4*>(bc + t * 2 * N + kQuad * q);
        const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < NQ; ++i) h[i] = fmaf(ex2(p.x * An[i]), h[i], dau * bs[i]);
      }
    }
    float dA_c[NQ], dbias_c = 0.f, ddsk_c = 0.f;  // this chunk's sums
#pragma unroll
    for (int i = 0; i < NQ; ++i) dA_c[i] = 0.f;
    const size_t tok0 = (size_t)g * L + l0;  // the chunk's first token in the stream layout
    for (int j = nsub - 1; j >= 0; --j) {
      const int s0 = j * S;
      const int cnt = min(S, tc - s0);

      // The sub-tile's recompute and sweep, compiled apart for a whole
      // sub-tile (no token guards) and for the chunk's ragged last one.
      auto sub_tile = [&](auto whole) {
        constexpr bool kWhole = decltype(whole)::value;
        // h of the sub-tile's tokens, into registers.
        float hh[S][NQ];
        {
          const float4 v = *reinterpret_cast<const float4*>(hb + (j * DM + d) * N + kQuad * q);
          h[0] = v.x, h[1] = v.y, h[2] = v.z, h[3] = v.w;
        }
#pragma unroll
        for (int si = 0; si < S; ++si) {
          if (kWhole || si < cnt) {
            const int t = s0 + si;
            const float4 p = pk[t * DM + d];
            const float dau = p.x * p.y;
            const float4 bv = *reinterpret_cast<const float4*>(bc + t * 2 * N + kQuad * q);
            const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < NQ; ++i) {
              h[i] = fmaf(ex2(p.x * An[i]), h[i], dau * bs[i]);
              hh[si][i] = h[i];
            }
          }
        }

        // The adjoint sweeps back over the sub-tile; the sums over the warp's
        // channels of g da u (dB) and dy h (dC) go to red.
#pragma unroll
        for (int si = S - 1; si >= 0; --si) {
          if (kWhole || si < cnt) {
            const int t = s0 + si;
            const float4 p = pk[t * DM + d];
            const float da = p.x, uv = p.y, sig = p.z, dyv = p.w;
            const float dau = da * uv;
            const float* q2 = bc + t * 2 * N + kQuad * q;
            const float4 bv = *reinterpret_cast<const float4*>(q2);
            const float4 cv = *reinterpret_cast<const float4*>(q2 + N);
            const float bs[4] = {bv.x, bv.y, bv.z, bv.w}, cs[4] = {cv.x, cv.y, cv.z, cv.w};
            float gB = 0.f, dda = 0.f, vals[8];
#pragma unroll
            for (int i = 0; i < NQ; ++i) {
              const float gv = fmaf(cs[i], dyv, ga[i]);
              const float gdau = gv * dau;
              const float common = fmaf(gv, hh[si][i], -gdau * bs[i]);
              gB = fmaf(gv, bs[i], gB);
              dda = fmaf(common, An[i], dda);
              dA_c[i] = fmaf(common, da, dA_c[i]);
              ga[i] = ex2(da * An[i]) * gv;
              vals[i] = gdau;
              vals[NQ + i] = dyv * hh[si][i];
            }
            gB = quad_sum(gB);
            dda = fmaf(gB, uv, quad_sum(dda) * kLn2);  // An holds A log2 e
            const float ddr = dda * sig;
            dbias_c += ddr;
            ddsk_c = fmaf(dyv, uv, ddsk_c);
            // du and ddelta take the token's place in pk, which no later step reads.
            if (q == 0) *reinterpret_cast<float2*>(pk + t * DM + d) = make_float2(fmaf(da, gB, dk * dyv), ddr);
            const float v = transpose_sum8(vals, ln.dl);
            const int col = ln.dl < NQ ? kQuad * q + ln.dl : N + kQuad * q + ln.dl - NQ;
            red[(ln.w * S + si) * 2 * N + col] = v;
          }
        }
      };
      if (cnt == S) {
        sub_tile(std::true_type{});
      } else {
        sub_tile(std::false_type{});
      }
      __syncthreads();

      // dB and dC of the sub-tile: the warps' sums added in warp order.
      if (tid < cnt * 2 * N) {
        const int si = tid / (2 * N), col = tid - si * 2 * N;
        const float* rp = red + si * 2 * N + col;
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) acc += rp[w * S * 2 * N];
        const size_t row = (tok0 + s0 + si) * N;
        if (col < N) dB[row + col] = acc;
        else dC[row + col - N] = acc;
      }
      __syncthreads();  // before the next sub-tile's sweep writes red
    }
    // du and ddelta of the chunk, written out whole rows at a time.
    if (on) {
      const size_t off = tok0 * D + dch;
#pragma unroll 4
      for (int t = tid / DM; t < tc; t += kThreads / DM) {
        const float2 v = *reinterpret_cast<const float2*>(pk + t * DM + dch);
        du[off + (size_t)t * D] = v.x;
        ddelta[off + (size_t)t * D] = v.y;
      }
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) dA_acc[i] += dA_c[i];
    dbias_acc += dbias_c;
    ddsk_acc += ddsk_c;
  }

  if (!ln.active) return;
  float* po = part + ((size_t)k * gridDim.x + blockIdx.x) * (N + 2) * D + d;
#pragma unroll
  for (int i = 0; i < NQ; ++i) po[(size_t)(kQuad * q + i) * D] = dA_acc[i];
  if (q == 0) {
    po[(size_t)N * D] = ddsk_acc;
    po[(size_t)(N + 1) * D] = dbias_acc;
  }
}

// out[k][i] = the sum over direction k's blocks of their partial sums, in
// block order. width = (N + 2) * D.
__global__ void bwd_reduce(const float* __restrict__ part, float* __restrict__ out,
                           int gx, int width) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (i >= width) return;
  const float* p = part + (size_t)k * gx * width + i;
  float acc = 0.f;
  for (int r = 0; r < gx; ++r) acc += p[(size_t)r * width];
  out[(size_t)k * width + i] = acc;
}

template <int N, int DM>
cudaError_t set_smem(int T) {
  cudaError_t e = cudaFuncSetAttribute(bwd_local<N, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)local_smem(N, DM, T));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(bwd_main<N, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)main_smem(N, DM, T));
}

template <int N, int DM>
cudaError_t launch(const float* u, const float* delta, const float* A, const float* Bs,
                   const float* Cs, const float* dsk, const float* bias,
                   const float* state, const float* sumda, const float* dy,
                   float* du, float* ddelta, float* dB, float* dC,
                   float* gcar, float* part, float* sums,
                   int B, int K, int L, int D, int T, int gx, cudaStream_t stream) {
  const int nc = (L + T - 1) / T;
  const int G = B * K;
  cudaError_t e = set_smem<N, DM>(T);
  if (e != cudaSuccess) return e;
  bwd_local<N, DM><<<dim3(nc, G), kQuad * DM, local_smem(N, DM, T), stream>>>(
      delta, A, Cs, bias, dy, gcar, K, L, D, T, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int workers = min(kPrefixWorkers, (nc + kBatch - 1) / kBatch);
  const dim3 pgrid((N * D + kPrefixLanes - 1) / kPrefixLanes, G), pblock(kPrefixLanes, workers);
  bwd_prefix<<<pgrid, pblock, 0, stream>>>(A, gcar, sumda, K, N, D, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_main<N, DM><<<dim3(gx, K), kQuad * DM, main_smem(N, DM, T), stream>>>(
      u, delta, A, Bs, Cs, dsk, bias, state, gcar, dy, du, ddelta, dB, dC, part,
      B, K, L, D, T, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int width = (N + 2) * D;
  bwd_reduce<<<dim3((width + 255) / 256, K), 256, 0, stream>>>(part, sums, gx, width);
  return cudaGetLastError();
}

// out: threads a block, shared memory of bwd_local and bwd_main, and the
// blocks of each that the runtime lets reside on one SM.
template <int N, int DM>
cudaError_t occupancy(int T, int* out) {
  cudaError_t e = set_smem<N, DM>(T);
  if (e != cudaSuccess) return e;
  out[0] = kQuad * DM;
  out[1] = (int)local_smem(N, DM, T);
  out[2] = (int)main_smem(N, DM, T);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, bwd_local<N, DM>, out[0], out[1]);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 4, bwd_main<N, DM>, out[0], out[2]);
}

bool takes(int N, int D, int T) {
  return N == 16 && D >= 1 && D <= 128 && T >= kSub && T <= kTMax && T % kSub == 0;
}

}  // namespace

extern "C" {

// u, delta, dy (B, K, L, D); A (K, D, N); Bs, Cs (B, K, L, N); dsk, bias
// (K, D); state (B, K, nc, N, D) and sumda (B, K, nc, D) as K3 left them, nc =
// ceil(L / T). Outputs: du, ddelta (B, K, L, D); dB, dC (B, K, L, N); sums
// (K, N + 2, D): rows [dA (n-major) | dD_skip | dbias]. Scratch: gcar
// (B, K, nc, N, D); part (K, gx, N + 2, D), gx the blocks of bwd_main for
// each direction, which stride over its B * nc chunks. A block holds 64
// channels where D <= 64, else 128. All f32, contiguous, on the device of
// `stream`. Returns a cudaError_t; the caller has checked N == 16, D <= 128,
// B * K <= 65535 and T <= 64 a multiple of 8.
int selective_scan_bwd_f32(const void* u, const void* delta, const void* A,
                           const void* Bs, const void* Cs, const void* dsk,
                           const void* bias, const void* state, const void* sumda,
                           const void* dy, void* du, void* ddelta, void* dB, void* dC,
                           void* gcar, void* part, void* sums,
                           int B, int K, int L, int D, int N, int T, int gx, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  if (!takes(N, D, T) || gx < 1 || B * K > 65535) return cudaErrorInvalidValue;
#define WM_LAUNCH(DM)                                                                           \
  launch<16, DM>(f(u), f(delta), f(A), f(Bs), f(Cs), f(dsk), f(bias), f(state), f(sumda), f(dy), \
                 m(du), m(ddelta), m(dB), m(dC), m(gcar), m(part), m(sums), B, K, L, D, T, gx,  \
                 static_cast<cudaStream_t>(stream))
  return D <= 64 ? WM_LAUNCH(64) : WM_LAUNCH(128);
#undef WM_LAUNCH
}

// The launch geometry on the current device for D channels: out[0] threads a
// block (both kernels), out[1] / out[2] dynamic shared memory of bwd_local /
// bwd_main, out[3] / out[4] their resident blocks an SM as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor reports them (registers
// included). Returns a cudaError_t.
int selective_scan_bwd_occupancy(int N, int D, int T, int* out) {
  if (!takes(N, D, T)) return cudaErrorInvalidValue;
  return D <= 64 ? occupancy<16, 64>(T, out) : occupancy<16, 128>(T, out);
}

const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
