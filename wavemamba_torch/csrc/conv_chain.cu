// K6 / K7 on Hopper: a static chain of convolution stages over an image, in
// one launch, on tiles with a halo, with the 1x1 and dense 3x3 products on the
// tensor cores.
//
// Replaces two TPU kernels of `wavemamba_tpu/experimental/conv_fused.py`:
// `_chain_kernel` (`fused_chain`, 2-D tiles read as a 3x3 block neighbourhood)
// and `_band_kernel` (`fused_chain_band`, full-width row bands). Both compute
// one function: the chain of stages below over the whole image, with SAME zero
// padding at its border. They differ only in how the TPU cut the image for its
// VMEM, so here one kernel serves both: `fused_chain` launches it on
// (tile_h, tile_w) tiles, `fused_chain_band` on band_h-row tiles, the width
// chosen to fit shared memory in both cases (a 1,920-pixel band does not).
//
// Stages (the DSL of conv_fused.py:33-44), walked from a descriptor array, so
// any chain the DSL allows runs:
//   pw      1x1 conv cin -> cout           bf16 operands, f32 sums (+ bias)
//   dense   3x3 conv cin -> cout           bf16 operands, f32 sums (+ bias)
//   dw      depthwise 3x3                  f32 (+ bias)
//   act     gelu (tanh form) | silu | sigmoid, f32
//   glu     act(first half) * second half
//   mulsig0 y *= sigmoid(x0 . w + b)       bf16 operands on the chain input x0
//   ln      LayerNorm over channels, two-pass f32 statistics
//   res0    y += [scale *] x0
// x (and so y) is float32 or bf16: x is widened to f32 as it is read, every
// stage runs in f32 as on the TPU (its working dtype), and y is rounded once
// into x's dtype. A bf16 operand is the f32 value rounded to nearest even, so
// the product of two is exact in f32: only the order of the f32 sums differs
// from the TPU's.
//
// What bounds it on an H100 (`chip_smoke.py:chain_bound`): per output pixel a
// chain moves (cin + cout) activations and does sum(cin * cout * taps) bf16
// multiply-adds, up to 59 k a pixel in paconv_chain: the products, which want
// the tensor cores (989 TFLOP/s), and the bytes (3.35 TB/s) bound it by turns.
// The design, point by point:
//   * Products on the tensor cores. Every pw / dense / mulsig0 stage is an
//     implicit GEMM on `mma.sync.m16n8k16` bf16 x bf16 -> f32: M = the output
//     pixels of the tile, N = output channels, K = input channels x taps. A
//     warp item is 32 pixels (16 where registers are short) x 32 channels:
//     per 16-channel step one ldmatrix a 16-pixel tile, two 16-byte loads of
//     B and four mma a tile, with no branch between them.
//   * One order of the sums. Taps in order, 16 channels a step, chained on
//     the accumulators (C). No split, no atomics: a pixel's sums do not depend
//     on the tile it lies in, so K6 and K7 give the same bits, and a second
//     call the same bits as the first. A product whose output is rounded to
//     bf16 for a following product (paconv_chain's first 3x3) chains each tap
//     apart and joins the taps by compensated addition: the tensor cores
//     truncate what they align, and one chain over all taps flipped that bf16
//     rounding, against the exact sum, on more of paconv_chain's outputs than
//     `chip_smoke.py`'s check allows.
//   * Operand layout. The input of a product stage lies in shared memory in
//     bf16, pixel-major, channels contiguous and padded with zeros to a
//     multiple of 16, plus an 8-channel skew: the 8 rows of an ldmatrix land
//     on distinct banks. Rounding there changes no bits (the stage rounds its
//     input to bf16 anyway). A buffer that feeds dw, ln, act or glu stays f32,
//     channel-major, with a row pitch of 4 mod 32 words so the accumulators'
//     stores do not collide. Cin = 3 (conv_01) pads to 16; the output tiles
//     pad to a multiple of 4 with zero weights (cout = 3 of `last` to 32).
//   * Weights once per block. Each product stage's weights are rounded to bf16
//     once and staged into shared memory in the order the B fragments read
//     them, with its bias and the epilogue's vectors; a dw stage's too.
//   * Epilogues in registers. Bias, the mulsig0 gate (its own 1x1 product over
//     x0, accumulated beside the main one), activations and res0 (x0 loaded
//     before the products) apply to the accumulators before the store, which
//     writes bf16 for a following product stage, f32 otherwise.
//   * Wider tiles. One block of 512 threads an SM, up to 227 KB of shared
//     memory: the host walks the chain (`plan_chain`) into ops, gives their
//     outputs three slots by liveness (the chain input stays in one only while
//     a gate still reads it), and takes the widest core that fits. The other
//     ops walk the tile a thread per pixel, channels in the thread's loop.
// Not done here: wgmma and TMA, which the card's full tensor rate needs, and
// overlap of a tile's loads with the previous tile's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "stream_dtype.cuh"

namespace {

constexpr int kMaxStages = 12;
constexpr int kMaxOps = 40;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemBudget = 227 * 1024;  // bytes a block may take: one block an SM
constexpr int kSlots = 3;

enum Kind { kPw = 0, kDense = 1, kDw = 2, kAct = 3, kGlu = 4, kMulSig0 = 5, kLn = 6, kRes0 = 7 };
enum Act { kGelu = 0, kSilu = 1, kSigmoid = 2 };
enum OpKind { opLoad, opMask, opPack, opGemm, opDw, opAct, opGlu, opLn, opRes0, opStore };
enum Fmt { kF32 = 0, kBF16 = 1 };

// One stage. `w`, `b` are f32 and contiguous in the PyTorch layouts:
//   pw, mulsig0 (cout, cin[, 1, 1]); dense (cout, cin, 3, 3); dw (c, 1, 3, 3);
//   ln: w = gamma, b = beta; res0: w = scale (c0) or null. b may be null.
struct Stage {
  int kind, cin, cout, act;
  const float* w;
  const float* b;
  float eps;
};

struct Chain {
  int n;     // number of stages
  int halo;  // number of 3x3 stages
  int c0;    // channels of the chain's input
  int cout;  // channels of its output
  Stage s[kMaxStages];
};

// One step of the block's walk over the chain (see `plan_chain`).
struct Op {
  int kind;
  int stage;    // the stage it runs; opGemm: the product, or -1 for a gate alone
  int gate;     // opGemm: the mulsig0 stage among its epilogue stages, or -1
  int nepi;     // opGemm: stages applied to the accumulators after the bias, in order
  int epi[3];
  int src, dst;  // slots
  int fmt;       // opLoad, opMask: the buffer's format; opGemm: the output's
  int cin, cout;
  int ring;      // rings around the core of the op's input region
  int ntiles;    // opGemm: output tiles of 8 channels
};

struct Plan {
  int nops;
  int xslot;  // the slot holding the chain input in bf16 for the gates, or -1
  int slot_off[kSlots];
  int w_off;  // staged weights
  int bytes;
  Op op[kMaxOps];
};

__host__ __device__ inline int cpad16(int c) { return (c + 15) / 16 * 16; }
// f32 buffers: channel-major, floats a channel (4 mod 32: see the header note).
__host__ __device__ inline int fpitch(int np) { return (np + 31) / 32 * 32 + 4; }
// bf16 buffers: pixel-major, bf16 values a pixel (16 bytes times an odd number).
__host__ __device__ inline int bpitch(int c) { return cpad16(c) + 8; }
__host__ __device__ inline long long buf_bytes(int fmt, int c, long long np) {
  return fmt == kF32 ? 4LL * c * fpitch((int)np) : 2LL * np * bpitch(c);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float activate(int act, float v) {
  if (act == kGelu) {
    // jax.nn.gelu(approximate=True), the form the TPU kernel uses (conv_fused.py:70-75)
    return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  }
  if (act == kSilu) return v * sigmoid(v);
  return sigmoid(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// d += a . b on the tensor cores: a 16 x 16 bf16 (rows = pixels), b 16 x 8
// bf16 (columns = output channels), d 16 x 8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The geometry of a block's working tile: the region `rows` x `cols` whose
// top-left pixel is the image's (y0, x0).
struct Region {
  int rows, cols, y0, x0;
  __device__ int size() const { return rows * cols; }
};

__device__ __forceinline__ bool inside(int gy, int gx, int H, int W) {
  return gy >= 0 && gy < H && gx >= 0 && gx < W;
}

// x0 through the read-only cache, widened to f32 as `load_f32` widens it.
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// The chain input x0, widened to f32, 0 outside the image.
template <typename T>
struct Input {
  const T* x;  // this image's first element
  long long sc, sh, sw;
  int H, W;
  __device__ float at(int c, int gy, int gx) const {
    return inside(gy, gx, H, W) ? ldg_f32(x + c * sc + gy * sh + gx * sw) : 0.f;
  }
};

// A product stage's weights (cout, cin, taps) as bf16 B fragments: for each
// (tap, 16 input channels, two 8-channel output tiles), 32 lanes x one
// 16-byte load {b0 b1 of the first tile, b0 b1 of the second}; zero past cin
// and cout, `pairs` tile pairs (the tiles padded to a multiple of 4). The
// caller zeroes `dst` first (`zero_words`) and syncs. A thread takes one
// (output, input) channel pair and reads its taps: a warp's loads cover
// consecutive weights, and each bf16 goes to its place in the fragments.
__device__ void stage_weights(uint4* dst, const float* __restrict__ w, int cout, int cin,
                              int taps, int kc, int pairs) {
  __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
  const int tap_words = kc * pairs * 32 * 4;  // 32-bit words of one tap's fragments
  for (int nk = threadIdx.x; nk < cout * cin; nk += blockDim.x) {
    const int n = nk / cin, k = nk - n * cin;
    const int kk = k & 15, lane = (n & 7) * 4 + ((kk & 7) >> 1);
    const int word = (((k >> 4) * pairs + (n >> 4)) * 32 + lane) * 4 + ((n >> 3) & 1) * 2 + (kk >> 3);
    const float* src = w + (size_t)nk * taps;
    for (int t = 0; t < taps; ++t) {
      d[(word + t * tap_words) * 2 + (kk & 1)] = __float2bfloat16_rn(__ldg(src + t));
    }
  }
}

__device__ void zero_words(uint4* dst, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = make_uint4(0, 0, 0, 0);
}

// v[0 .. n) = w[0 .. n) past which `fill`, n rounded up; w may be null.
__device__ void stage_vector(float* dst, const float* __restrict__ w, int n, int padded,
                             float fill) {
  for (int i = threadIdx.x; i < padded; i += blockDim.x) dst[i] = w && i < n ? __ldg(w + i) : fill;
}

// One product op, as the warps see it.
struct Gemm {
  bool has_main;            // a pw / dense product (else a gate alone, in place)
  uint32_t src;             // its bf16 input (shared address), region ri
  Region ri, ro;            // input and output regions
  int src_pitch, taps, kc;  // bf16 a pixel; 1 or 9; 16-channel steps
  const uint4* w;           // its B fragments
  uint32_t xs;              // the gate's bf16 x0 (shared address), region rx
  Region rx;
  int x_pitch, kcg;
  const uint4* wg;          // the gate's B fragments
  int nt, pairs, cout;      // output tiles, tile pairs (padded), channels
  const float* vec;         // bias, then one vector per epilogue stage (4 x 8 * 2 * pairs)
  int nepi, epi_kind[3], epi_act[3];
  char* out;                // f32 channel-major or bf16 pixel-major, region ro
  bool out_bf16;
  int out_pitch;
};

// acc (kMT 16-pixel tiles x 4 output tiles) += A . B over `kc` 16-channel
// steps of one tap: A from the ldmatrix row addresses `base`, B the tap's
// fragments from tile pair p0. The chains of tensor-core sums run on C.
template <int kMT>
__device__ __forceinline__ void product(float (&acc)[kMT][4][4], const uint32_t (&base)[kMT],
                                        int kc, const uint4* w, int pairs, int p0, int lane) {
  const uint4* wb = w + p0 * 32 + lane;
#pragma unroll 2
  for (int k = 0; k < kc; ++k) {
    uint32_t a[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) ldsm_x4(a[mt], base[mt] + k * 32);
    const uint4 b01 = wb[k * pairs * 32], b23 = wb[k * pairs * 32 + 32];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      mma_bf16(acc[mt][0], a[mt], b01.x, b01.y);
      mma_bf16(acc[mt][1], a[mt], b01.z, b01.w);
      mma_bf16(acc[mt][2], a[mt], b23.x, b23.y);
      mma_bf16(acc[mt][3], a[mt], b23.z, b23.w);
    }
  }
}

// One warp item: 16 * kMT output pixels by 32 output channels (4 tiles of 8).
// kExact: the taps' sums join by compensated addition (the op's output is
// rounded to bf16 for a following product); kGate: an epilogue stage is a
// gate, whose product runs here too; kRes0: one adds x0, whose values the
// item loads before its products.
template <int kMT, bool kExact, bool kGate, bool kRes0, typename T>
__device__ __forceinline__ void gemm_item(const Gemm& g, const Input<T>& x0, int item, int lane) {
  const int chunks = g.pairs / 2;
  const int m0 = (item / chunks) * 16 * kMT, nt0 = (item % chunks) * 4;
  const int ntn = min(4, g.nt - nt0);
  const int npo = g.ro.size();
  const int r = lane >> 2, cpair = (lane & 3) * 2;  // the accumulators' pixel and channels
  float xv[kMT][2][4][2] = {};
  if constexpr (kRes0) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = min(m0 + mt * 16 + r + h * 8, npo - 1);
        const int gy = g.ro.y0 + q / g.ro.cols, gx = g.ro.x0 + q % g.ro.cols;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = (nt0 + j) * 8 + cpair + e;
            xv[mt][h][j][e] = c < g.cout ? x0.at(c, gy, gx) : 0.f;
          }
      }
  }
  // ldmatrix: lane l gives the row address of pixel l % 16 of each tile
  // (clamped to the region), channels 8 * (l / 16) on.
  const int kofs = (lane >> 4) * 8;
  int q_row[kMT];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) q_row[mt] = min(m0 + mt * 16 + (lane & 15), npo - 1);
  float acc[kMT][4][4] = {}, comp[kMT][4][4] = {}, gacc[kMT][4][4] = {};
  if (g.has_main) {
    uint32_t base[kMT];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int pin = (q_row[mt] / g.ro.cols) * g.ri.cols + q_row[mt] % g.ro.cols;
      base[mt] = g.src + (pin * g.src_pitch + kofs) * 2;
    }
    // Taps in order, each a chain over its channels 16 at a time (`product`).
    for (int t = 0; t < g.taps; ++t) {
      const uint32_t step = ((t / 3) * g.ri.cols + t % 3) * g.src_pitch * 2;
      uint32_t tb[kMT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) tb[mt] = base[mt] + step;
      const uint4* wt = g.w + t * g.kc * g.pairs * 32;
      if constexpr (kExact) {
        // Each tap's sum joins by Kahan's compensated addition (comp holds
        // what the f32 sum lost): the tensor cores align and truncate the
        // terms of each instruction, so one chain over all taps loses low
        // bits at every step, enough to flip the bf16 rounding that follows.
        float tap[kMT][4][4] = {};
        product<kMT>(tap, tb, g.kc, wt, g.pairs, nt0 / 2, lane);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float y = tap[mt][j][e] - comp[mt][j][e];
              const float s = acc[mt][j][e] + y;
              comp[mt][j][e] = (s - acc[mt][j][e]) - y;
              acc[mt][j][e] = s;
            }
      } else {
        product<kMT>(acc, tb, g.kc, wt, g.pairs, nt0 / 2, lane);
      }
    }
  }
  if constexpr (kGate) {
    const int oy = g.ro.y0 - g.rx.y0, ox = g.ro.x0 - g.rx.x0;
    uint32_t xb[kMT];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int pin = (q_row[mt] / g.ro.cols + oy) * g.rx.cols + q_row[mt] % g.ro.cols + ox;
      xb[mt] = g.xs + (pin * g.x_pitch + kofs) * 2;
    }
    product<kMT>(gacc, xb, g.kcg, g.wg, g.pairs, nt0 / 2, lane);
  }

  // The epilogue: lane holds pixels r and r + 8 of each 16, output channels
  // 2 * (lane % 4) and the next of each 8-channel tile.
  const int width = g.pairs * 16;  // the vectors' length
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = m0 + mt * 16 + r + h * 8;
      if (q >= npo) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= ntn) continue;
        const int n = (nt0 + j) * 8 + cpair;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n + e, i = h * 2 + e;
          float val = 0.f;
          if (c < g.cout) {
            val = g.has_main ? (acc[mt][j][i] - comp[mt][j][i]) + g.vec[c]
                             : reinterpret_cast<const float*>(g.out)[(size_t)c * g.out_pitch + q];
#pragma unroll
            for (int u = 0; u < 3; ++u) {
              if (u >= g.nepi) break;
              const float p = g.vec[(u + 1) * width + c];  // the stage's bias or scale
              if (g.epi_kind[u] == kAct) {
                val = activate(g.epi_act[u], val);
              } else if (g.epi_kind[u] == kMulSig0) {
                if constexpr (kGate) val *= sigmoid(gacc[mt][j][i] + p);
              } else {  // kRes0
                if constexpr (kRes0) val += xv[mt][h][j][e] * p;
              }
            }
          }
          v[e] = val;
        }
        if (g.out_bf16) {
          reinterpret_cast<uint32_t*>(g.out)[((size_t)q * g.out_pitch + n) / 2] = pack_bf16(v[0], v[1]);
        } else {
          float* o = reinterpret_cast<float*>(g.out);
          if (n < g.cout) o[(size_t)n * g.out_pitch + q] = v[0];
          if (n + 1 < g.cout) o[(size_t)(n + 1) * g.out_pitch + q] = v[1];
        }
      }
    }
  }
}

template <int kMT, bool kExact, bool kGate, bool kRes0, typename T>
__device__ __forceinline__ void gemm_loop(const Gemm& g, const Input<T>& x0, int lane, int warp) {
  const int items = (g.ro.size() + 16 * kMT - 1) / (16 * kMT) * (g.pairs / 2);
  for (int it = warp; it < items; it += kWarps) gemm_item<kMT, kExact, kGate, kRes0>(g, x0, it, lane);
}

// The warps' items of one product op. A product whose output a following
// product reads in bf16 sums exactly; one that leaves in f32 chains all its
// taps on C, over two 16-pixel tiles a warp item where the registers allow
// (no gate, no x0 to add).
template <bool kRes0, typename T>
__device__ __forceinline__ void gemm_items(const Gemm& g, const Input<T>& x0, bool gate, int lane,
                                           int warp) {
  if (gate) {
    if (g.out_bf16) gemm_loop<1, true, true, kRes0>(g, x0, lane, warp);
    else gemm_loop<1, false, true, kRes0>(g, x0, lane, warp);
  } else if (g.out_bf16) {
    gemm_loop<1, true, false, kRes0>(g, x0, lane, warp);
  } else if (kRes0) {
    gemm_loop<1, false, false, kRes0>(g, x0, lane, warp);
  } else {
    gemm_loop<2, false, false, false>(g, x0, lane, warp);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) chain_kernel(
    const __grid_constant__ Chain ch, const __grid_constant__ Plan pl, const T* __restrict__ x,
    long long sb, long long sc, long long sh, long long sw, T* __restrict__ y, int H, int W,
    int th, int tw) {
  extern __shared__ uint4 smem[];
  char* sm = reinterpret_cast<char*>(smem);
  const int b = blockIdx.z;
  const int ty = blockIdx.y * th, tx = blockIdx.x * tw;  // the core's top-left pixel
  const Input<T> x0{x + b * sb, sc, sh, sw, H, W};
  const bool border = ty < ch.halo || tx < ch.halo || ty + th + ch.halo > H ||
                      tx + tw + ch.halo > W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto region = [&](int ring) { return Region{th + 2 * ring, tw + 2 * ring, ty - ring, tx - ring}; };
  char* wsm = sm + pl.w_off;

  // Every op but the products walks the region a thread per pixel, channels
  // in its loop: consecutive threads read consecutive pixels, one division a
  // pixel.
  for (int oi = 0; oi < pl.nops; ++oi) {
    const Op& op = pl.op[oi];
    const Region r = region(op.ring);
    const int np = r.size(), fp = fpitch(np);
    float* fsrc = reinterpret_cast<float*>(sm + pl.slot_off[op.src]);
    char* dst = sm + pl.slot_off[op.dst];
    switch (op.kind) {
      case opLoad: {
        const int c = op.cout;
        if (op.fmt == kF32) {
          for (int p = threadIdx.x; p < np; p += blockDim.x) {
            const int gy = r.y0 + p / r.cols, gx = r.x0 + p % r.cols;
            const bool in = inside(gy, gx, H, W);
            const T* xp = x0.x + (in ? gy * sh + gx * sw : 0);
            float* d = reinterpret_cast<float*>(dst) + p;
#pragma unroll 16
            for (int ci = 0; ci < c; ++ci) d[(size_t)ci * fp] = in ? ldg_f32(xp + ci * sc) : 0.f;
          }
        } else {  // items of 8 channels of a pixel, one 16-byte store each (faster on bf16 x
                  // than a thread per pixel)
          const int groups = cpad16(c) / 8, bp = bpitch(c);
          for (int i = threadIdx.x; i < groups * np; i += blockDim.x) {
            const int g = i / np, p = i - g * np;
            const int gy = r.y0 + p / r.cols, gx = r.x0 + p % r.cols;
            float v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) v[u] = g * 8 + u < c ? x0.at(g * 8 + u, gy, gx) : 0.f;
            *reinterpret_cast<uint4*>(dst + ((size_t)p * bp + g * 8) * 2) =
                make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                           pack_bf16(v[6], v[7]));
          }
        }
        break;
      }
      case opMask: {  // SAME padding: zero what lies outside the image
        if (!border) break;
        for (int p = threadIdx.x; p < np; p += blockDim.x) {
          if (inside(r.y0 + p / r.cols, r.x0 + p % r.cols, H, W)) continue;
          if (op.fmt == kF32) {
            for (int ci = 0; ci < op.cin; ++ci) fsrc[(size_t)ci * fp + p] = 0.f;
          } else {
            uint4* s = reinterpret_cast<uint4*>(sm + pl.slot_off[op.src] + (size_t)p * bpitch(op.cin) * 2);
            for (int g = 0; g < cpad16(op.cin) / 8; ++g) s[g] = make_uint4(0, 0, 0, 0);
          }
        }
        break;
      }
      case opPack: {  // f32 channel-major -> bf16 pixel-major, the input of a product
        const int c = op.cin;
        for (int p = threadIdx.x; p < np; p += blockDim.x) {
          uint4* d = reinterpret_cast<uint4*>(dst + (size_t)p * bpitch(c) * 2);
          for (int g = 0; g < cpad16(c) / 8; ++g) {
            float v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) v[u] = g * 8 + u < c ? fsrc[(size_t)(g * 8 + u) * fp + p] : 0.f;
            d[g] = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                              pack_bf16(v[6], v[7]));
          }
        }
        break;
      }
      case opGemm: {
        const bool has_main = op.stage >= 0;
        const bool dense = has_main && ch.s[op.stage].kind == kDense;
        Gemm g;
        g.has_main = has_main;
        g.ri = r;
        g.ro = dense ? region(op.ring - 1) : r;
        g.taps = dense ? 9 : 1;
        g.kc = cpad16(op.cin) / 16;
        g.nt = op.ntiles;
        g.pairs = (op.ntiles + 3) / 4 * 2;
        g.cout = op.cout;
        g.src = static_cast<uint32_t>(__cvta_generic_to_shared(sm + pl.slot_off[op.src]));
        g.src_pitch = bpitch(op.cin);
        g.kcg = cpad16(ch.c0) / 16;
        g.rx = region(ch.halo);
        g.x_pitch = bpitch(ch.c0);
        g.xs = pl.xslot >= 0
                   ? static_cast<uint32_t>(__cvta_generic_to_shared(sm + pl.slot_off[pl.xslot]))
                   : 0u;
        // Staged: the product's fragments, the gate's, then the bias and one
        // vector per epilogue stage (a gate's bias, a res0's scale).
        uint4* w = reinterpret_cast<uint4*>(wsm);
        const int main_words = has_main ? g.taps * g.kc * g.pairs * 32 : 0;
        uint4* wg = w + main_words;
        float* vec = reinterpret_cast<float*>(wg + (op.gate >= 0 ? g.kcg * g.pairs * 32 : 0));
        const int width = g.pairs * 16;
        zero_words(w, static_cast<int>(reinterpret_cast<uint4*>(vec) - w));
        __syncthreads();
        if (has_main) {
          stage_weights(w, ch.s[op.stage].w, op.cout, op.cin, g.taps, g.kc, g.pairs);
          stage_vector(vec, ch.s[op.stage].b, op.cout, width, 0.f);
        }
        if (op.gate >= 0) stage_weights(wg, ch.s[op.gate].w, op.cout, ch.c0, 1, g.kcg, g.pairs);
        bool res0 = false;
        g.nepi = op.nepi;
        for (int u = 0; u < 3; ++u) {
          const Stage& es = ch.s[u < op.nepi ? op.epi[u] : 0];
          g.epi_kind[u] = es.kind;
          g.epi_act[u] = es.act;
          if (u < op.nepi && es.kind == kRes0) {
            res0 = true;
            stage_vector(vec + (u + 1) * width, es.w, op.cout, width, 1.f);
          } else if (u < op.nepi && es.kind == kMulSig0) {
            stage_vector(vec + (u + 1) * width, es.b, op.cout, width, 0.f);
          }
        }
        g.w = w;
        g.wg = wg;
        g.vec = vec;
        g.out = dst;
        g.out_bf16 = op.fmt == kBF16;
        g.out_pitch = g.out_bf16 ? bpitch(op.cout) : fpitch(g.ro.size());
        __syncthreads();  // the staged weights
        if (res0) {
          gemm_items<true>(g, x0, op.gate >= 0, lane, warp);
        } else {
          gemm_items<false>(g, x0, op.gate >= 0, lane, warp);
        }
        break;
      }
      case opDw: {  // out (c, ro) = depthwise 3x3 of in (c, r) (+ bias), the weights staged
        const Stage& st = ch.s[op.stage];
        const int c = op.cin;
        float* wk = reinterpret_cast<float*>(wsm);
        for (int i = threadIdx.x; i < 10 * c; i += blockDim.x) {
          wk[i] = i < 9 * c ? __ldg(st.w + i) : (st.b ? __ldg(st.b + i - 9 * c) : 0.f);
        }
        __syncthreads();
        const Region ro = region(op.ring - 1);
        const int npo = ro.size(), po = fpitch(npo);
        float* out = reinterpret_cast<float*>(dst);
        for (int q = threadIdx.x; q < npo; q += blockDim.x) {
          const float* in = fsrc + (q / ro.cols) * r.cols + q % ro.cols;
          for (int ci = 0; ci < c; ++ci) {
            const float* p = in + (size_t)ci * fp;
            const float* k = wk + ci * 9;
            float acc = 0.f;
#pragma unroll
            for (int t = 0; t < 9; ++t) acc = fmaf(p[(t / 3) * r.cols + t % 3], k[t], acc);
            out[(size_t)ci * po + q] = acc + wk[9 * c + ci];
          }
        }
        break;
      }
      case opAct: {
        const int act = ch.s[op.stage].act;
        for (int p = threadIdx.x; p < np; p += blockDim.x) {
          for (int ci = 0; ci < op.cin; ++ci) {
            float& v = fsrc[(size_t)ci * fp + p];
            v = activate(act, v);
          }
        }
        break;
      }
      case opGlu: {
        const int act = ch.s[op.stage].act, half = op.cin / 2;
        for (int p = threadIdx.x; p < np; p += blockDim.x) {
          for (int ci = 0; ci < half; ++ci) {
            float& v = fsrc[(size_t)ci * fp + p];
            v = activate(act, v) * fsrc[(size_t)(ci + half) * fp + p];
          }
        }
        break;
      }
      case opLn: {
        const Stage& st = ch.s[op.stage];
        const int c = op.cin;
        for (int p = threadIdx.x; p < np; p += blockDim.x) {
          float s = 0.f;
          for (int i = 0; i < c; ++i) s += fsrc[(size_t)i * fp + p];
          const float mu = s / c;
          float v = 0.f;
          for (int i = 0; i < c; ++i) {
            const float d = fsrc[(size_t)i * fp + p] - mu;
            v += d * d;
          }
          const float rs = 1.f / sqrtf(v / c + st.eps);
          for (int i = 0; i < c; ++i) {
            float& e = fsrc[(size_t)i * fp + p];
            e = (e - mu) * rs * __ldg(st.w + i) + __ldg(st.b + i);
          }
        }
        break;
      }
      case opRes0: {
        const float* scale = ch.s[op.stage].w;
        for (int p = threadIdx.x; p < np; p += blockDim.x) {
          const int gy = r.y0 + p / r.cols, gx = r.x0 + p % r.cols;
          for (int ci = 0; ci < op.cin; ++ci) {
            const float v = x0.at(ci, gy, gx);
            fsrc[(size_t)ci * fp + p] += scale ? v * __ldg(scale + ci) : v;
          }
        }
        break;
      }
      default: {  // opStore: the core (every ring consumed), what lies inside the image
        T* yb = y + (size_t)b * op.cin * H * W;
        for (int p = threadIdx.x; p < np; p += blockDim.x) {
          const int gy = ty + p / tw, gx = tx + p % tw;
          if (gy >= H || gx >= W) continue;
          T* yp = yb + (size_t)gy * W + gx;
#pragma unroll 8
          for (int ci = 0; ci < op.cin; ++ci) store_f32(yp + (size_t)ci * H * W, fsrc[(size_t)ci * fp + p]);
        }
      }
    }
    __syncthreads();
  }
}

// The block's walk over the chain for a th x tw core: ops, the slots their
// outputs take (by liveness, three at most), the weights' bytes. Returns 0,
// or cudaErrorInvalidValue for a chain of more ops than kMaxOps.
int plan_chain(const Chain& ch, int th, int tw, Plan* out) {
  Plan& p = *out;
  p = Plan{};
  long long size[kSlots] = {0, 0, 0}, wbytes = 0;
  auto np_of = [&](int ring) { return (long long)(th + 2 * ring) * (tw + 2 * ring); };
  auto need = [&](int slot, int fmt, int c, int ring) {
    size[slot] = std::max(size[slot], buf_bytes(fmt, c, np_of(ring)));
  };
  bool ok = true;
  auto emit = [&](Op o) {
    if (p.nops >= kMaxOps) ok = false; else p.op[p.nops++] = o;
  };
  auto op_of = [](int kind, int stage, int src, int dst, int fmt, int c, int ring) {
    Op o{};
    o.kind = kind, o.stage = stage, o.gate = -1, o.src = src, o.dst = dst, o.fmt = fmt;
    o.cin = o.cout = c, o.ring = ring;
    return o;
  };
  auto is_product = [&](int i) { return i < ch.n && (ch.s[i].kind == kPw || ch.s[i].kind == kDense); };
  int last_gate = -1;
  for (int i = 0; i < ch.n; ++i) if (ch.s[i].kind == kMulSig0) last_gate = i;
  const int xslot = last_gate >= 0 ? 2 : -1;
  bool x_live = xslot >= 0;
  auto pick = [&](int src) {  // a free slot, the largest so far
    int best = -1;
    for (int s = 0; s < kSlots; ++s) {
      if (s == src || (x_live && s == xslot)) continue;
      if (best < 0 || size[s] > size[best]) best = s;
    }
    return best;
  };

  int ring = ch.halo, c = ch.c0, cur = 0, fmt = is_product(0) ? kBF16 : kF32;
  bool fresh = true;  // the buffer is the load's: zero outside the image
  if (xslot >= 0) {
    emit(op_of(opLoad, -1, 0, xslot, kBF16, c, ring));
    need(xslot, kBF16, c, ring);
  }
  if (xslot >= 0 && fmt == kBF16) {
    cur = xslot;
  } else {
    emit(op_of(opLoad, -1, 0, 0, fmt, c, ring));
    need(0, fmt, c, ring);
  }
  for (int i = 0; i < ch.n;) {
    const Stage& st = ch.s[i];
    if (st.kind == kPw || st.kind == kDense || st.kind == kMulSig0) {
      Op o = op_of(opGemm, i, cur, cur, kF32, c, ring);
      int j = i + 1;
      if (st.kind == kMulSig0) {  // a gate alone: in place on the f32 buffer
        o.stage = -1;
        o.gate = i;
        o.epi[o.nepi++] = i;
      } else {
        if (fmt != kBF16) {
          const int d = pick(cur);
          emit(op_of(opPack, i, cur, d, kBF16, c, ring));
          need(d, kBF16, c, ring);
          cur = d;
          fmt = kBF16;
        }
        if (st.kind == kDense && !fresh) emit(op_of(opMask, i, cur, cur, kBF16, c, ring));
        o.src = cur;
        o.cout = st.cout;
      }
      for (; j < ch.n && o.nepi < 3; ++j) {  // what the accumulators take before the store
        const int k = ch.s[j].kind;
        if (k == kMulSig0 && o.gate < 0) o.gate = j;
        else if (k != kAct && k != kRes0) break;
        o.epi[o.nepi++] = j;
      }
      const int ring_out = st.kind == kDense ? ring - 1 : ring;
      o.fmt = o.stage >= 0 && is_product(j) ? kBF16 : kF32;  // a gate alone stays in place
      o.ntiles = (o.fmt == kBF16 ? cpad16(o.cout) : (o.cout + 7) / 8 * 8) / 8;
      o.dst = o.stage < 0 ? cur : pick(cur);
      if (o.gate == last_gate) x_live = false;  // after the pick: the op itself reads x0
      need(o.dst, o.fmt, o.cout, ring_out);
      const int taps = st.kind == kDense ? 9 : 1;
      const long long pairs = (o.ntiles + 3) / 4 * 2;  // as the kernel stages them
      long long wb = o.stage < 0 ? 0 : 512LL * taps * (cpad16(o.cin) / 16) * pairs;
      if (o.gate >= 0) wb += 512LL * (cpad16(ch.c0) / 16) * pairs;
      wbytes = std::max(wbytes, wb + 4LL * 4 * 16 * pairs);  // + the bias and epilogue vectors
      emit(o);
      cur = o.dst, fmt = o.fmt, c = o.cout, ring = ring_out, fresh = false, i = j;
    } else if (st.kind == kDw) {
      if (!fresh) emit(op_of(opMask, i, cur, cur, kF32, c, ring));
      const int d = pick(cur);
      emit(op_of(opDw, i, cur, d, kF32, c, ring));
      wbytes = std::max(wbytes, 40LL * c);  // its weights and bias, staged
      need(d, kF32, c, ring - 1);
      cur = d, ring -= 1, fresh = false, ++i;
    } else {  // act, glu, ln, res0: in place on the f32 buffer
      const int kind = st.kind == kAct ? opAct : st.kind == kGlu ? opGlu : st.kind == kLn ? opLn : opRes0;
      emit(op_of(kind, i, cur, cur, kF32, c, ring));
      if (st.kind == kGlu) c /= 2;
      fresh = false, ++i;
    }
  }
  emit(op_of(opStore, -1, cur, cur, kF32, c, ring));
  p.xslot = xslot;
  long long off = 0;
  for (int s = 0; s < kSlots; ++s) {
    p.slot_off[s] = (int)off;
    off += size[s];  // every size is a multiple of 16 bytes
  }
  p.w_off = (int)off;
  const long long bytes = off + wbytes;
  p.bytes = bytes > (1LL << 30) ? (1 << 30) : (int)bytes;
  return ok && ring == 0 && fmt == kF32 ? 0 : (int)cudaErrorInvalidValue;
}

// The widest core <= tw_max whose plan fits kSmemBudget (the bytes grow with
// the width), planned into *pl; returns the width, or 0.
int choose(const Chain& ch, int th, int tw_max, Plan* pl) {
  int lo = 0, hi = tw_max;  // lo fits (or is 0), hi + 1 does not (or is past tw_max)
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (plan_chain(ch, th, mid, pl) == 0 && pl->bytes <= kSmemBudget) lo = mid; else hi = mid - 1;
  }
  if (lo > 0) plan_chain(ch, th, lo, pl);
  return lo;
}

bool valid(const Chain& ch) { return ch.n >= 1 && ch.n <= kMaxStages; }

template <typename T>
int launch(const Chain& ch, const void* x, long long sb, long long sc, long long sh, long long sw,
           void* y, int B, int H, int W, int th, int tw_max, cudaStream_t stream) {
  Plan pl;
  const int tw = choose(ch, th, tw_max, &pl);
  if (tw == 0) return cudaErrorInvalidValue;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       pl.bytes);
  if (e != cudaSuccess) return e;
  chain_kernel<T><<<grid, kThreads, pl.bytes, stream>>>(ch, pl, static_cast<const T*>(x), sb, sc, sh,
                                                        sw, static_cast<T*>(y), H, W, th, tw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The core width and shared-memory bytes the kernel takes for this chain at
// tile height th, the width at most tw_max; returns 0, or cudaErrorInvalidValue
// when not even one column fits.
int conv_chain_plan(const void* chain, int th, int tw_max, int* tw, int* smem_bytes) {
  const Chain& ch = *static_cast<const Chain*>(chain);
  Plan pl;
  *tw = valid(ch) && th >= 1 && tw_max >= 1 ? choose(ch, th, tw_max, &pl) : 0;
  *smem_bytes = *tw > 0 ? pl.bytes : 0;
  return *tw > 0 ? 0 : (int)cudaErrorInvalidValue;
}

// x: (B, c0, H, W) with element strides (sb, sc, sh, sw), float32 (bf16 = 0)
// or bf16 (bf16 = 1); y: (B, cout, H, W) contiguous, in x's dtype; the chain's
// weights float32 on the same device. One launch on PyTorch's stream, tiles of
// th rows by the widest width <= tw_max that fits. Returns a cudaError_t.
int conv_chain(const void* chain, const void* x, long long sb, long long sc, long long sh,
               long long sw, void* y, int B, int H, int W, int th, int tw_max, int bf16,
               void* stream) {
  const Chain& ch = *static_cast<const Chain*>(chain);
  if (!valid(ch) || th < 1 || tw_max < 1 || B < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(ch, x, sb, sc, sh, sw, y, B, H, W, th, tw_max, s)
              : launch<float>(ch, x, sb, sc, sh, sw, y, B, H, W, th, tw_max, s);
}

const char* conv_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
