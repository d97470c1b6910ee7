// P1-P5 on Hopper: the throughput probes of the SS2D scan's op patterns.
//
// Replace the TPU probes of `scripts/tpu_vpu_probe.py` (`probe_flat`,
// `probe_shaped`, `probe_exp`, `probe_nsum`, `probe_mxu_seg`), which measure
// what a kernel sustains for each op pattern that K1 uses, at K1's shapes: a
// block g of (T, N*D2) = (512, 16*128) float32 per grid step, GRID blocks.
// Each kernel here computes the TPU probe's function over all blocks at once:
//
//   P1 probe_flat     y = x[g]; K times y = y*a + x[g]         one FMA per step
//   P2 probe_shaped   over the (R, S, N*D2) view, K times, for i in 1..S-1:
//                     pa *= x[:, i]; pb = x[:, i]*pb + x[:, i]; out pa + pb
//   P3 probe_exp      y = x[g]; K times y = exp(y*a)            expf: ex2 on the SFU
//   P4 probe_nsum     acc(t, d) += sum_n x(t, n, d) * (c(t, n) + k), k < K,
//                     written to every n of (T, N, D2)
//   P5 probe_mxu_seg  the inclusive prefix over s within each segment of S = 8
//                     tokens, on the tensor cores: mma.sync m16n8k8 TF32 with
//                     A = 16 columns x 8 s and B = tril^T (8 x 8)
//
// What bounds them on an H100: at the TPU probes' K (48, 6, 16, 24) every
// block is 4 MB in device memory, not VMEM, so P1, P2, P4 and P5 are bound by
// bytes (each element read and written once) and P3 by the SFU. The probes'
// own K, made larger, moves P1-P4 to their pipes; P5 has no K and stays bound
// by bytes. Design: the whole chain of an element in registers, so each byte
// crosses the bus once. P1 and P3 (see `stream_tiles`) stream: persistent
// blocks, as many as the card holds resident, walk tiles of 4 g x 4
// consecutive elements a thread and load the next tile while the current
// one's 16 independent chains run, so the bytes overlap the arithmetic and
// no step waits on its predecessor's latency; P1's four g share an a, which
// its FFMAs take from the operand reuse cache; P3 steps as exp(y a) = ex2(y a
// log2 e), one FMUL and one `ex2.approx` (MUFU.EX2), what K1's and K3's
// decays issue. P2 one (r, n, d) and P4 eight d of one (g, t) (see `nsum`)
// per thread; P5 one warp per 16 columns of a segment. The K loops are
// unrolled (the TPU probes' Python loops unroll at trace time), so the
// loop's own counter and branch do not take the issue slots the probed
// operations need. P5 splits x into hi + lo, both TF32 (the 0/1 triangle is
// exact in TF32, so the two products are what 3xTF32 needs): the prefix then
// agrees with the float32 one to its rounding, not to TF32's 10-bit
// mantissa, at no cost a bytes-bound kernel would notice.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kS = 8;   // tokens per segment (P2, P5)
constexpr int kN = 16;  // states (P4)
constexpr int kNsumThreads = 128;  // P4: threads a block
constexpr int kNsumBlocks = 3;     // P4: resident blocks an SM its launch bounds ask for
constexpr int kNsumV = 8;          // P4: d a thread owns, two 16-byte chunks
constexpr int kNsumKTile = 192;    // P4: values of k a block tabulates c + k for at once
constexpr int kStreamThreads = 256;  // P1, P3: threads a block
constexpr int kStreamBlocks = 3;     // P1, P3: resident blocks an SM their launch bounds ask for
constexpr int kStreamV = 4;          // P1, P3: consecutive elements of a g a thread, one float4
constexpr int kStreamGs = 4;         // P1, P3: g a tile holds, at the same in-block offsets
constexpr int kStreamTile = kStreamThreads * kStreamV;  // in-block offsets a tile covers
constexpr int kStreamUnroll = 16;    // P1, P3: steps of the K loop between two of its tests

// P1 and P3 over the T x ND elements of each g, as tiles of kStreamGs g by
// kStreamTile in-block offsets (the last group of g and the last offsets
// ragged). Thread i of tile (p, j) holds the kStreamV consecutive elements at
// in-block offset j kStreamTile + kStreamV i of g = kStreamGs p + h, h <
// kStreamGs: one 16-byte access of x[g] and out[g] each, one of a for all of
// them, and the a offset is the in-block offset itself. Tile (p, j) is number
// p tiles_per_g + j; block b walks b, b + gridDim.x, ... (as
// `scripts/gpu_probe.py:stream_plan` plans them), carrying j into p, so the
// walk takes 32-bit adds and no division beyond two at its start. The next
// tile's x and a are loaded before the current tile's chains run and are in
// flight while they do: with as many blocks as the card holds resident (the
// grid) each SM keeps 48-64 KB of x in flight, more than HBM's rate times its
// latency asks, at K = 48 (P1) and 16 (P3), where the bytes bound. A thread's
// kStreamGs x kStreamV elements are as many independent chains (see
// `FmaChains`, `ExpChains` for their order). x and out stream past L2
// (`.cs`), which keeps the 4 MB of a that every g reads.
struct Tile {
  float4 x[kStreamGs], a;
};

__device__ __forceinline__ Tile load_tile(const float* __restrict__ x, const float* __restrict__ a,
                                          int G, int per_g, int p, int off) {
  Tile t;
  t.a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int h = 0; h < kStreamGs; ++h) t.x[h] = t.a;
  if (off < per_g) {
    t.a = __ldg(reinterpret_cast<const float4*>(a + off));
#pragma unroll
    for (int h = 0; h < kStreamGs; ++h) {
      const int g = p * kStreamGs + h;
      if (g < G) t.x[h] = __ldcs(reinterpret_cast<const float4*>(x + (size_t)g * per_g + off));
    }
  }
  return t;
}

template <class Chains>
__device__ __forceinline__ void stream_tiles(const float* __restrict__ x, const float* __restrict__ a,
                                             float* __restrict__ out, int G, int per_g,
                                             int tiles_per_g, int K) {
  const int P = (G + kStreamGs - 1) / kStreamGs;  // g groups
  const int lane = threadIdx.x * kStreamV;        // the thread's offset in a tile
  const int dp = gridDim.x / tiles_per_g, dj = gridDim.x - dp * tiles_per_g;  // one step of the walk
  int p = blockIdx.x / tiles_per_g, j = blockIdx.x - p * tiles_per_g;  // the first tile: p < P
  int off = j * kStreamTile + lane;
  Tile cur = load_tile(x, a, G, per_g, p, off);
  while (p < P) {
    int pn = p + dp, jn = j + dj;
    if (jn >= tiles_per_g) {
      jn -= tiles_per_g;
      ++pn;
    }
    const int offn = jn * kStreamTile + lane;
    const Tile next = load_tile(x, a, G, per_g, pn, offn);  // past the last group: a only
    if (off < per_g) {
      float4 y[kStreamGs];
      Chains::run(y, cur.x, cur.a, K);
#pragma unroll
      for (int h = 0; h < kStreamGs; ++h) {
        const int g = p * kStreamGs + h;
        if (g < G) __stcs(reinterpret_cast<float4*>(out + (size_t)g * per_g + off), y[h]);
      }
    }
    p = pn;
    j = jn;
    off = offn;
    cur = next;
  }
}

// P1: y = x; K times y = y a + x. The kStreamGs chains of one component
// (one in-block offset, so one a) run together, K steps at a time,
// kStreamUnroll steps between two tests of the loop: each FFMA waits on the
// one kStreamGs = 4 instructions back, what its latency asks, and a stays in
// the operand reuse cache for all of them, so an FFMA reads y and x, in
// registers of the two banks, not three registers (three fresh reads held
// an FFMA to ~2/3 of the pipe).
struct FmaChains {
  __device__ static __forceinline__ void run(float4 (&y)[kStreamGs], const float4 (&x)[kStreamGs],
                                             const float4& a, int K) {
    float yc[4][kStreamGs], xc[4][kStreamGs];
#pragma unroll
    for (int h = 0; h < kStreamGs; ++h) {
      xc[0][h] = x[h].x;
      xc[1][h] = x[h].y;
      xc[2][h] = x[h].z;
      xc[3][h] = x[h].w;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float ac = c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
#pragma unroll
      for (int h = 0; h < kStreamGs; ++h) yc[c][h] = xc[c][h];
      int k = K;
      for (; k >= kStreamUnroll; k -= kStreamUnroll) {
#pragma unroll
        for (int u = 0; u < kStreamUnroll; ++u)
#pragma unroll
          for (int h = 0; h < kStreamGs; ++h) yc[c][h] = fmaf(yc[c][h], ac, xc[c][h]);
      }
#pragma unroll 1
      for (; k > 0; --k)
#pragma unroll
        for (int h = 0; h < kStreamGs; ++h) yc[c][h] = fmaf(yc[c][h], ac, xc[c][h]);
    }
#pragma unroll
    for (int h = 0; h < kStreamGs; ++h) y[h] = make_float4(yc[0][h], yc[1][h], yc[2][h], yc[3][h]);
  }
};

__device__ __forceinline__ float ex2(float v) {  // 2^v on the SFU: MUFU.EX2, a few ulp
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// P3: y = x; K times y = exp(y a) = 2^(y b), b = a log2(e) once an element:
// an FMUL and a MUFU.EX2 a step, all 4 kStreamGs chains a step, kStreamUnroll
// steps between two tests of the loop, so the SFU, not the issue slots or
// the ex2's latency, sets the pace. y a lies in [-0.5, 0] for the probe's
// inputs, so the chain contracts and ex2's few-ulp error does not grow with K.
struct ExpChains {
  __device__ static __forceinline__ void step(float4 (&y)[kStreamGs], const float4& b) {
#pragma unroll
    for (int h = 0; h < kStreamGs; ++h) {
      y[h].x = ex2(y[h].x * b.x);
      y[h].y = ex2(y[h].y * b.y);
      y[h].z = ex2(y[h].z * b.z);
      y[h].w = ex2(y[h].w * b.w);
    }
  }
  __device__ static __forceinline__ void run(float4 (&y)[kStreamGs], const float4 (&x)[kStreamGs],
                                             const float4& a, int K) {
    constexpr float kLog2e = 1.4426950408889634f;
    const float4 b = make_float4(a.x * kLog2e, a.y * kLog2e, a.z * kLog2e, a.w * kLog2e);
#pragma unroll
    for (int h = 0; h < kStreamGs; ++h) y[h] = x[h];
    int k = K;
    for (; k >= kStreamUnroll; k -= kStreamUnroll) {
#pragma unroll
      for (int u = 0; u < kStreamUnroll; ++u) step(y, b);
    }
#pragma unroll 1
    for (; k > 0; --k) step(y, b);
  }
};

__global__ void __launch_bounds__(kStreamThreads, kStreamBlocks) flat(
    const float* __restrict__ x, const float* __restrict__ a, float* __restrict__ out, int G,
    int per_g, int tiles_per_g, int K) {
  stream_tiles<FmaChains>(x, a, out, G, per_g, tiles_per_g, K);
}

__global__ void __launch_bounds__(kThreads) shaped(
    const float* __restrict__ x, float* __restrict__ out, size_t n, int R, int ND, int K) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;  // (g, r, nd)
  if (i >= n) return;
  const size_t nd = i % ND, gr = i / ND;  // gr = g * R + r: segment gr starts at token row gr * S
  const float* xs = x + gr * kS * ND + nd;
  float xi[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) xi[s] = xs[(size_t)s * ND];
  float pa = xi[0], pb = xi[0];
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int s = 1; s < kS; ++s) {
      pa *= xi[s];
      pb = fmaf(xi[s], pb, xi[s]);
    }
  }
  out[i] = pa + pb;
}

__global__ void __launch_bounds__(kStreamThreads, kStreamBlocks) expchain(
    const float* __restrict__ x, const float* __restrict__ a, float* __restrict__ out, int G,
    int per_g, int tiles_per_g, int K) {
  stream_tiles<ExpChains>(x, a, out, G, per_g, tiles_per_g, K);
}

// P4. A block holds one t and `gpb` g (g_per_block = kNsumThreads / (D2 /
// kNsumV)), a thread kNsumV d of one (g, t) as kNsumV / 4 float4 chunks,
// chunk v at d = 4 (col + v cols) with cols = D2 / kNsumV, so that each
// 16-byte load or store of a warp covers runs of consecutive bytes; its 16 x
// rows (16 x 32 bytes) sit in registers for the whole K loop.
// c(t, n) + k is the same for every thread of the block, so the block
// tabulates it in shared memory, kNsumKTile values of k at a time, and each
// thread reads four n of it in one 16-byte broadcast load that feeds 4 *
// kNsumV = 32 FFMAs: ~1.05 issued instructions a multiply-add (the inner
// loop's SASS, `scripts/gpu_probe.py:sass_loop`), where a thread of one d took
// an FADD (c + k) and an FFMA per term and an FADD per k (~2.06). Every one
// of the K x 16 multiply-adds is still done; the sums run straight into two
// accumulators a d (even and odd n), 16 independent FFMA chains a thread,
// added at the end. At 4 d a thread (16 FFMAs a load) the loop ran no faster
// with its memory traffic taken out: the shared-memory loads, not the bytes
// or the occupancy, held it back; 8 d halve them, at the price of ~170
// registers and 12 warps an SM.
__global__ void __launch_bounds__(kNsumThreads, kNsumBlocks) nsum(
    const float* __restrict__ x, const float* __restrict__ c, float* __restrict__ out,
    int G, int T, int D2, int K) {
  constexpr int V4 = kNsumV / 4;               // float4 chunks of a row a thread
  __shared__ float4 ck4[kNsumKTile * kN / 4];  // c(t, n) + k0 + kk at [kk][n]
  float* ck = reinterpret_cast<float*>(ck4);
  const int t = blockIdx.x;
  const int cols = D2 / kNsumV, gpb = kNsumThreads / cols;
  const int gl = threadIdx.x / cols, col = threadIdx.x - gl * cols;
  const int g = blockIdx.y * gpb + gl;
  const bool on = gl < gpb && g < G;
  // Entry e of a tile is (kk, n) = (e / 16, e % 16); e = threadIdx.x + i *
  // kNsumThreads, so n is the thread's own throughout.
  const float ctn = __ldg(c + (size_t)t * kN + threadIdx.x % kN);
  const size_t row = ((size_t)g * T + t) * kN * D2 + (size_t)col * 4;  // (g, t, 0, chunk 0)
  float4 xv[kN][V4];
  if (on) {
#pragma unroll
    for (int m = 0; m < kN; ++m)
#pragma unroll
      for (int v = 0; v < V4; ++v)
        xv[m][v] = *reinterpret_cast<const float4*>(x + row + (size_t)m * D2 + 4 * v * cols);
  }
  float4 a0[V4], a1[V4];
#pragma unroll
  for (int v = 0; v < V4; ++v) a0[v] = a1[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < K; k0 += kNsumKTile) {
    const int kt = min(kNsumKTile, K - k0);
    __syncthreads();  // every thread has read the previous tile
    for (int e = threadIdx.x; e < kt * kN; e += kNsumThreads) ck[e] = ctn + (float)(k0 + e / kN);
    __syncthreads();
    if (!on) continue;
#pragma unroll 2
    for (int kk = 0; kk < kt; ++kk) {
#pragma unroll
      for (int q = 0; q < kN / 4; ++q) {
        const float4 w = ck4[kk * (kN / 4) + q];
#pragma unroll
        for (int v = 0; v < V4; ++v) {
          const float4 x0 = xv[4 * q][v], x1 = xv[4 * q + 1][v];
          const float4 x2 = xv[4 * q + 2][v], x3 = xv[4 * q + 3][v];
          a0[v].x = fmaf(x0.x, w.x, a0[v].x); a0[v].y = fmaf(x0.y, w.x, a0[v].y);
          a0[v].z = fmaf(x0.z, w.x, a0[v].z); a0[v].w = fmaf(x0.w, w.x, a0[v].w);
          a1[v].x = fmaf(x1.x, w.y, a1[v].x); a1[v].y = fmaf(x1.y, w.y, a1[v].y);
          a1[v].z = fmaf(x1.z, w.y, a1[v].z); a1[v].w = fmaf(x1.w, w.y, a1[v].w);
          a0[v].x = fmaf(x2.x, w.z, a0[v].x); a0[v].y = fmaf(x2.y, w.z, a0[v].y);
          a0[v].z = fmaf(x2.z, w.z, a0[v].z); a0[v].w = fmaf(x2.w, w.z, a0[v].w);
          a1[v].x = fmaf(x3.x, w.w, a1[v].x); a1[v].y = fmaf(x3.y, w.w, a1[v].y);
          a1[v].z = fmaf(x3.z, w.w, a1[v].z); a1[v].w = fmaf(x3.w, w.w, a1[v].w);
        }
      }
    }
  }
  if (!on) return;
#pragma unroll
  for (int v = 0; v < V4; ++v) {
    const float4 acc = make_float4(a0[v].x + a1[v].x, a0[v].y + a1[v].y, a0[v].z + a1[v].z,
                                   a0[v].w + a1[v].w);
#pragma unroll
    for (int m = 0; m < kN; ++m)
      *reinterpret_cast<float4*>(out + row + (size_t)m * D2 + 4 * v * cols) = acc;
  }
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp per (segment, 16 columns): D (16 x 8) = A (16 x 8) . B (8 x 8) with
// A[m][k] = x[seg, s = k, j0 + m] and B[k][n] = (k <= n), so D[m][n] is the
// prefix through token n. Fragments of m16n8k8 (PTX ISA): lane = 4 * gid +
// tig; A a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4), a3 (gid + 8,
// tig + 4); B b0 (k = tig, n = gid), b1 (k = tig + 4, n = gid); D d0 (gid,
// 2 tig), d1 (gid, 2 tig + 1), d2 (gid + 8, 2 tig), d3 (gid + 8, 2 tig + 1).
__global__ void __launch_bounds__(kThreads) mxu_seg(
    const float* __restrict__ x, float* __restrict__ out, size_t tiles, int ND) {
  const size_t w = ((size_t)blockIdx.x * kThreads + threadIdx.x) / 32;
  if (w >= tiles) return;
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const int per_seg = ND / 16;
  const size_t seg = w / per_seg;
  const int j0 = (int)(w % per_seg) * 16;
  const float* xs = x + seg * kS * ND + j0;
  float* os = out + seg * kS * ND + j0;
  const float av[4] = {xs[(size_t)tig * ND + gid], xs[(size_t)tig * ND + gid + 8],
                       xs[(size_t)(tig + 4) * ND + gid], xs[(size_t)(tig + 4) * ND + gid + 8]};
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = to_tf32(av[i]);
    lo[i] = to_tf32(av[i] - __uint_as_float(hi[i]));
  }
  const uint32_t one = __float_as_uint(1.f);
  const uint32_t b0 = tig <= gid ? one : 0u, b1 = tig + 4 <= gid ? one : 0u;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, lo, b0, b1);
  mma_tf32(d, hi, b0, b1);
  os[(size_t)(2 * tig) * ND + gid] = d[0];
  os[(size_t)(2 * tig + 1) * ND + gid] = d[1];
  os[(size_t)(2 * tig) * ND + gid + 8] = d[2];
  os[(size_t)(2 * tig + 1) * ND + gid + 8] = d[3];
}

unsigned blocks(size_t threads) { return (unsigned)((threads + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Every array float32, contiguous, on the device of `stream`; G blocks of
// (T, ND) with ND = N * D2. Each returns a cudaError_t; the caller has checked
// the shapes (P2, P5: T a multiple of 8; P4: N == 16; P5: ND a multiple of 16).

// P1's and P3's geometry on the current device: out[0] threads a block, out[1]
// consecutive elements of a g a thread, out[2] the resident blocks an SM of
// `expchain` (exp != 0) or `flat` as cudaOccupancyMaxActiveBlocksPerMultiprocessor
// reports them (registers included), out[3] the device's SMs, out[4] the g a
// tile holds. Returns a cudaError_t.
int gpu_probe_stream_occupancy(int exp, int* out) {
  out[0] = kStreamThreads;
  out[1] = kStreamV;
  out[4] = kStreamGs;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out + 3, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return exp ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, expchain, kStreamThreads, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, flat, kStreamThreads, 0);
}

// P1 and P3: x, out (G, T, ND), a (T, ND), each starting on a 16-byte
// boundary; T ND a multiple of kStreamV. `threads`, `V`, `gs` and `grid` are the
// launch as the caller planned it (`scripts/gpu_probe.py:stream_plan`): it is
// refused unless they are this source's block, elements of a g a thread, g a
// tile, and the tiles or the blocks the device holds resident, whichever is fewer. The
// occupancy query is made once a kernel and device.
static int stream_launch(int exp, const void* x, const void* a, void* out, int G, int T, int ND,
                         int K, int threads, int V, int gs, int grid, void* stream) {
  const long long per_g = (long long)T * ND, tiles_per_g = (per_g + kStreamTile - 1) / kStreamTile;
  const long long tiles = (G + kStreamGs - 1) / kStreamGs * tiles_per_g;
  if (G < 1 || T < 1 || ND < 1 || K < 0 || per_g % kStreamV || per_g > INT_MAX - kStreamTile ||
      G > INT_MAX - kStreamGs || tiles > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  constexpr int kDevices = 64;
  static int resident[2][kDevices];  // blocks the device holds resident, 0 until queried
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (!resident[exp][dev]) {
    int occ[5];
    err = static_cast<cudaError_t>(gpu_probe_stream_occupancy(exp, occ));
    if (err != cudaSuccess) return err;
    resident[exp][dev] = occ[2] * occ[3];
  }
  if (threads != kStreamThreads || V != kStreamV || gs != kStreamGs ||
      grid != (tiles < resident[exp][dev] ? tiles : resident[exp][dev])) {
    return cudaErrorInvalidConfiguration;
  }
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorMisalignedAddress;
  }
  const auto kernel = exp ? expchain : flat;
  kernel<<<grid, kStreamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<float*>(out), G,
      (int)per_g, (int)tiles_per_g, K);
  return cudaGetLastError();
}

// P1: x, out (G, T, ND); a (T, ND).
int gpu_probe_flat(const void* x, const void* a, void* out, int G, int T, int ND, int K,
                   int threads, int V, int gs, int grid, void* stream) {
  return stream_launch(0, x, a, out, G, T, ND, K, threads, V, gs, grid, stream);
}

// P2: x (G, T, ND); out (G, T / 8, ND).
int gpu_probe_shaped(const void* x, void* out, int G, int T, int ND, int K, void* stream) {
  if (T % kS) return cudaErrorInvalidValue;
  const size_t n = (size_t)G * (T / kS) * ND;
  shaped<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, T / kS, ND, K);
  return cudaGetLastError();
}

// P3: x, out (G, T, ND); a (T, ND).
int gpu_probe_exp(const void* x, const void* a, void* out, int G, int T, int ND, int K,
                  int threads, int V, int gs, int grid, void* stream) {
  return stream_launch(1, x, a, out, G, T, ND, K, threads, V, gs, grid, stream);
}

// P4: x, out (G, T, N, D2), both starting on a 16-byte boundary; c (T, N).
// Takes N == 16 and D2 a multiple of 8 up to 8 * 128. `gpb` is the g a block
// holds as the caller planned it (`scripts/gpu_probe.py:nsum_plan`): the
// launch is refused unless it is this source's.
int gpu_probe_nsum(const void* x, const void* c, void* out, int G, int T, int N, int D2, int K,
                   int gpb, void* stream) {
  if (N != kN || D2 % kNsumV || D2 < kNsumV || D2 / kNsumV > kNsumThreads ||
      gpb != kNsumThreads / (D2 / kNsumV) || G < 1 || T < 1 || (G + gpb - 1) / gpb > 65535) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorMisalignedAddress;
  }
  const dim3 grid(T, (G + gpb - 1) / gpb);
  nsum<<<grid, kNsumThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(c), static_cast<float*>(out), G, T,
      D2, K);
  return cudaGetLastError();
}

// P4's geometry on the current device: out[0] threads a block, out[1] its
// static shared memory, out[2] the resident blocks an SM as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor reports them (registers
// included). Returns a cudaError_t.
int gpu_probe_nsum_occupancy(int* out) {
  out[0] = kNsumThreads;
  out[1] = (int)(sizeof(float) * kNsumKTile * kN);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, nsum, kNsumThreads, 0);
}

// P5: x, out (G, T, ND).
int gpu_probe_mxu_seg(const void* x, void* out, int G, int T, int ND, void* stream) {
  if (T % kS || ND % 16) return cudaErrorInvalidValue;
  const size_t tiles = (size_t)G * (T / kS) * (ND / 16);
  mxu_seg<<<blocks(tiles * 32), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), tiles, ND);
  return cudaGetLastError();
}

const char* gpu_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
