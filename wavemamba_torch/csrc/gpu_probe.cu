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
// by bytes. Design: one element (P1, P3), one (r, n, d) (P2) or four d of one
// (g, t) (P4, see `nsum`) per thread with the whole chain in registers, so
// each byte crosses the bus once; P5 one warp per 16 columns of a segment.
// The K loops are unrolled (the TPU probes' Python loops unroll at trace
// time), so the loop's own counter and branch do not take the issue slots the
// probed operations need. P5 splits x into hi + lo, both TF32 (the 0/1
// triangle is exact in TF32, so the two products are what 3xTF32 needs): the
// prefix then agrees with the float32 one to its rounding, not to TF32's
// 10-bit mantissa, at no cost a bytes-bound kernel would notice.

#include <cuda_runtime.h>
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

__global__ void __launch_bounds__(kThreads) flat(
    const float* __restrict__ x, const float* __restrict__ a, float* __restrict__ out,
    size_t n, size_t block, int K) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i], av = a[i % block];
  float y = xv;
#pragma unroll 8
  for (int k = 0; k < K; ++k) y = fmaf(y, av, xv);
  out[i] = y;
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

__global__ void __launch_bounds__(kThreads) expchain(
    const float* __restrict__ x, const float* __restrict__ a, float* __restrict__ out,
    size_t n, size_t block, int K) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float av = a[i % block];
  float y = x[i];
#pragma unroll 8
  for (int k = 0; k < K; ++k) y = expf(y * av);
  out[i] = y;
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

// P1: x, out (G, T, ND); a (T, ND).
int gpu_probe_flat(const void* x, const void* a, void* out, int G, int T, int ND, int K,
                   void* stream) {
  const size_t block = (size_t)T * ND, n = (size_t)G * block;
  flat<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<float*>(out), n,
      block, K);
  return cudaGetLastError();
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
                  void* stream) {
  const size_t block = (size_t)T * ND, n = (size_t)G * block;
  expchain<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<float*>(out), n,
      block, K);
  return cudaGetLastError();
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
