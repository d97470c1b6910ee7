// K6 / K7 on Hopper: a static chain of convolution stages over an image, in
// one launch, on tiles with a halo.
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
// A bf16 operand is the f32 value rounded to nearest even: the product of two
// is exact in f32, so CUDA-core FMAs give the TPU's products; only the order of
// the sums differs.
//
// Layout. Activations are NCHW (the input may have any strides; the output is
// contiguous). A block computes a th x tw core of one image. It loads the
// input over the core plus `halo` rings (one per 3x3 stage, zero outside the
// image) into shared memory, channel-major, and every stage reads one buffer
// and writes the other, or works in place; each 3x3 stage consumes one ring.
// Every 3x3 stage's input is zeroed outside the image first (a stage with a
// bias, an LN or a sigmoid maps the padding's zeros to other values), which is
// SAME padding. mulsig0 and res0 read x0 from device memory (L2), so x0 needs
// no buffer of its own. The host sizes the two buffers for the chain and
// shrinks the tile's width until they fit `kSmemBudget`, two blocks per SM.
//
// What bounds it on an H100: per output pixel a chain moves 4 * (cin + cout)
// bytes and does sum(cin * cout * taps) multiply-adds, which for the model's
// chains (up to 59 k a pixel in paconv_chain) puts it on the compute side.
// The tensor cores would take the bf16 products at 989 TFLOP/s; this first
// version runs them on the FMA pipe (67 TFLOP/s), four output channels by
// four pixels a thread, weights through L1 / L2. wgmma with TMA-fed tiles is
// the work of a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxStages = 12;
constexpr int kThreads = 256;
constexpr int kCoT = 4;  // output channels a thread sums in pw / dense / mulsig0
constexpr int kPxT = 4;  // pixels a thread computes in pw / dense / dw / mulsig0
constexpr int kSmemBudget = 112 * 1024;  // bytes: two blocks on an SM's 228 KB

enum Kind { kPw = 0, kDense = 1, kDw = 2, kAct = 3, kGlu = 4, kMulSig0 = 5, kLn = 6, kRes0 = 7 };
enum Act { kGelu = 0, kSilu = 1, kSigmoid = 2 };

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

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// The geometry of a block's working tile: the region `rows` x `cols` whose
// top-left pixel is the image's (y0, x0).
struct Region {
  int rows, cols, y0, x0;
  __device__ int size() const { return rows * cols; }
};

__device__ __forceinline__ bool inside(int gy, int gx, int H, int W) {
  return gy >= 0 && gy < H && gx >= 0 && gx < W;
}

// buf (c, region) = 0 wherever the pixel lies outside the image.
__device__ void mask_outside(float* buf, int c, Region r, int H, int W) {
  const int np = r.size();
  for (int i = threadIdx.x; i < c * np; i += blockDim.x) {
    const int p = i % np;
    if (!inside(r.y0 + p / r.cols, r.x0 + p % r.cols, H, W)) buf[i] = 0.f;
  }
}

// in (c, r) = bf16(in), in place: a pw or dense stage's input, which nothing
// reads in f32 after the stage.
__device__ void round_bf16(float* buf, int c, Region r) {
  for (int i = threadIdx.x; i < c * r.size(); i += blockDim.x) buf[i] = bf16r(buf[i]);
}

// out (cout, ro) = sum over cin and the KS x KS taps of in * bf16(w) (+ bias),
// in (cin, ri) already rounded to bf16, ri = ro grown by (KS - 1) / 2 rings. Thread item:
// kCoT output channels by kPxT pixels, the pixels strided by a quarter of the
// region so that a warp reads consecutive words.
template <int KS>
__device__ void stage_matmul(const float* __restrict__ in, float* __restrict__ out,
                             int cin, int cout, Region ri, Region ro,
                             const float* __restrict__ w, const float* __restrict__ bias) {
  const int npo = ro.size(), npi = ri.size();
  const int groups = (npo + kPxT - 1) / kPxT;
  const int cgs = (cout + kCoT - 1) / kCoT;
  constexpr int taps = KS * KS;
  for (int item = threadIdx.x; item < cgs * groups; item += blockDim.x) {
    const int cg = item / groups, pg = item - cg * groups;
    const int co0 = cg * kCoT;
    int base[kPxT];
    bool ok[kPxT];
#pragma unroll
    for (int k = 0; k < kPxT; ++k) {
      const int q = pg + k * groups;
      ok[k] = q < npo;
      base[k] = ok[k] ? (q / ro.cols) * ri.cols + q % ro.cols : 0;
    }
    float acc[kCoT][kPxT];
#pragma unroll
    for (int j = 0; j < kCoT; ++j)
#pragma unroll
      for (int k = 0; k < kPxT; ++k) acc[j][k] = 0.f;
    for (int ci = 0; ci < cin; ++ci) {
      const float* inc = in + (size_t)ci * npi;
#pragma unroll
      for (int t = 0; t < taps; ++t) {
        const int off = (t / KS) * ri.cols + t % KS;
        float v[kPxT], wv[kCoT];
#pragma unroll
        for (int k = 0; k < kPxT; ++k) v[k] = inc[base[k] + off];
#pragma unroll
        for (int j = 0; j < kCoT; ++j) {
          const int co = co0 + j;
          wv[j] = co < cout ? bf16r(__ldg(w + ((size_t)co * cin + ci) * taps + t)) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kCoT; ++j)
#pragma unroll
          for (int k = 0; k < kPxT; ++k) acc[j][k] = fmaf(wv[j], v[k], acc[j][k]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCoT; ++j) {
      const int co = co0 + j;
      if (co >= cout) break;
      const float bj = bias ? __ldg(bias + co) : 0.f;
#pragma unroll
      for (int k = 0; k < kPxT; ++k) {
        if (ok[k]) out[(size_t)co * npo + pg + k * groups] = acc[j][k] + bj;
      }
    }
  }
}

// out (c, ro) = depthwise 3x3 of in (c, ri) (+ bias), f32.
__device__ void stage_dw(const float* __restrict__ in, float* __restrict__ out, int c,
                         Region ri, Region ro, const float* __restrict__ w,
                         const float* __restrict__ bias) {
  const int npo = ro.size(), npi = ri.size();
  const int groups = (npo + kPxT - 1) / kPxT;
  for (int item = threadIdx.x; item < c * groups; item += blockDim.x) {
    const int ch = item / groups, pg = item - ch * groups;
    float wk[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wk[t] = __ldg(w + ch * 9 + t);
    const float bc = bias ? __ldg(bias + ch) : 0.f;
    const float* inc = in + (size_t)ch * npi;
#pragma unroll
    for (int k = 0; k < kPxT; ++k) {
      const int q = pg + k * groups;
      if (q >= npo) break;
      const float* p = inc + (q / ro.cols) * ri.cols + q % ro.cols;
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) acc = fmaf(p[(t / 3) * ri.cols + t % 3], wk[t], acc);
      out[(size_t)ch * npo + q] = acc + bc;
    }
  }
}

// The chain input x0 at a pixel of the region, 0 outside the image.
struct Input {
  const float* x;  // this image's first element
  long long sc, sh, sw;
  int H, W;
  __device__ float at(int c, int gy, int gx) const {
    return inside(gy, gx, H, W) ? x[c * sc + gy * sh + gx * sw] : 0.f;
  }
};

// buf (cout, r) *= sigmoid(bf16(x0) . bf16(w) + b), x0 over the same region.
__device__ void stage_mulsig0(float* buf, int cin, int cout, Region r, const Input& x0,
                              const float* __restrict__ w, const float* __restrict__ bias) {
  const int np = r.size();
  const int groups = (np + kPxT - 1) / kPxT;
  const int cgs = (cout + kCoT - 1) / kCoT;
  for (int item = threadIdx.x; item < cgs * groups; item += blockDim.x) {
    const int cg = item / groups, pg = item - cg * groups;
    const int co0 = cg * kCoT;
    int gy[kPxT], gx[kPxT];
#pragma unroll
    for (int k = 0; k < kPxT; ++k) {
      const int q = min(pg + k * groups, np - 1);
      gy[k] = r.y0 + q / r.cols;
      gx[k] = r.x0 + q % r.cols;
    }
    float acc[kCoT][kPxT];
#pragma unroll
    for (int j = 0; j < kCoT; ++j)
#pragma unroll
      for (int k = 0; k < kPxT; ++k) acc[j][k] = 0.f;
    for (int ci = 0; ci < cin; ++ci) {
      float v[kPxT], wv[kCoT];
#pragma unroll
      for (int k = 0; k < kPxT; ++k) v[k] = bf16r(x0.at(ci, gy[k], gx[k]));
#pragma unroll
      for (int j = 0; j < kCoT; ++j) {
        const int co = co0 + j;
        wv[j] = co < cout ? bf16r(__ldg(w + (size_t)co * cin + ci)) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kCoT; ++j)
#pragma unroll
        for (int k = 0; k < kPxT; ++k) acc[j][k] = fmaf(wv[j], v[k], acc[j][k]);
    }
#pragma unroll
    for (int j = 0; j < kCoT; ++j) {
      const int co = co0 + j;
      if (co >= cout) break;
      const float bj = bias ? __ldg(bias + co) : 0.f;
#pragma unroll
      for (int k = 0; k < kPxT; ++k) {
        const int q = pg + k * groups;
        if (q < np) buf[(size_t)co * np + q] *= sigmoid(acc[j][k] + bj);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) chain_kernel(
    const Chain ch, const float* __restrict__ x, long long sb, long long sc, long long sh,
    long long sw, float* __restrict__ y, int H, int W, int th, int tw, int size_a) {
  extern __shared__ float4 smem4[];
  float* cur = reinterpret_cast<float*>(smem4);
  float* oth = cur + size_a;
  const int b = blockIdx.z;
  const int ty = blockIdx.y * th, tx = blockIdx.x * tw;  // the core's top-left pixel
  const Input x0{x + b * sb, sc, sh, sw, H, W};
  const bool border = ty < ch.halo || tx < ch.halo || ty + th + ch.halo > H ||
                      tx + tw + ch.halo > W;

  int ring = ch.halo, c = ch.c0;
  Region r{th + 2 * ring, tw + 2 * ring, ty - ring, tx - ring};
  for (int i = threadIdx.x; i < c * r.size(); i += blockDim.x) {
    const int p = i % r.size();
    cur[i] = x0.at(i / r.size(), r.y0 + p / r.cols, r.x0 + p % r.cols);
  }
  __syncthreads();

  for (int si = 0; si < ch.n; ++si) {
    const Stage& st = ch.s[si];
    const int np = r.size();
    if (st.kind == kPw || st.kind == kDense) {
      round_bf16(cur, c, r);
      __syncthreads();
    }
    if (st.kind == kDense || st.kind == kDw) {
      if (border) {
        mask_outside(cur, c, r, H, W);
        __syncthreads();
      }
      const Region ro{r.rows - 2, r.cols - 2, r.y0 + 1, r.x0 + 1};
      if (st.kind == kDense) {
        stage_matmul<3>(cur, oth, c, st.cout, r, ro, st.w, st.b);
        c = st.cout;
      } else {
        stage_dw(cur, oth, c, r, ro, st.w, st.b);
      }
      r = ro;
      float* t = cur;
      cur = oth;
      oth = t;
    } else if (st.kind == kPw) {
      stage_matmul<1>(cur, oth, c, st.cout, r, r, st.w, st.b);
      c = st.cout;
      float* t = cur;
      cur = oth;
      oth = t;
    } else if (st.kind == kAct) {
      for (int i = threadIdx.x; i < c * np; i += blockDim.x) cur[i] = activate(st.act, cur[i]);
    } else if (st.kind == kGlu) {
      const int half = c / 2;
      for (int i = threadIdx.x; i < half * np; i += blockDim.x) {
        cur[i] = activate(st.act, cur[i]) * cur[i + half * np];
      }
      c = half;
    } else if (st.kind == kMulSig0) {
      stage_mulsig0(cur, ch.c0, c, r, x0, st.w, st.b);
    } else if (st.kind == kLn) {
      for (int p = threadIdx.x; p < np; p += blockDim.x) {
        float s = 0.f;
        for (int i = 0; i < c; ++i) s += cur[i * np + p];
        const float mu = s / c;
        float v = 0.f;
        for (int i = 0; i < c; ++i) {
          const float d = cur[i * np + p] - mu;
          v += d * d;
        }
        const float rs = 1.f / sqrtf(v / c + st.eps);
        for (int i = 0; i < c; ++i) {
          cur[i * np + p] = (cur[i * np + p] - mu) * rs * __ldg(st.w + i) + __ldg(st.b + i);
        }
      }
    } else {  // kRes0
      for (int i = threadIdx.x; i < c * np; i += blockDim.x) {
        const int ci = i / np, p = i - ci * np;
        const float v = x0.at(ci, r.y0 + p / r.cols, r.x0 + p % r.cols);
        cur[i] += st.w ? v * __ldg(st.w + ci) : v;
      }
    }
    __syncthreads();
  }

  // r is the core now (every ring consumed); store what lies inside the image.
  float* yb = y + (size_t)b * c * H * W;
  const int np = r.size();
  for (int i = threadIdx.x; i < c * np; i += blockDim.x) {
    const int ci = i / np, p = i - ci * np;
    const int gy = ty + p / tw, gx = tx + p % tw;
    if (gy < H && gx < W) yb[((size_t)ci * H + gy) * W + gx] = cur[i];
  }
}

// Floats of the two buffers for a th x tw core: the host mirror of the
// kernel's walk (each out-of-place stage writes the other buffer).
void plan(const Chain& ch, int th, int tw, int* size_a, int* size_b) {
  int ring = ch.halo, c = ch.c0, buf = 0;
  long long need[2] = {(long long)c * (th + 2 * ring) * (tw + 2 * ring), 0};
  for (int si = 0; si < ch.n; ++si) {
    const Stage& st = ch.s[si];
    if (st.kind == kPw || st.kind == kDense || st.kind == kDw) {
      if (st.kind != kPw) --ring;
      if (st.kind != kDw) c = st.cout;
      buf ^= 1;
      const long long n = (long long)c * (th + 2 * ring) * (tw + 2 * ring);
      if (n > need[buf]) need[buf] = n;
    } else if (st.kind == kGlu) {
      c /= 2;
    }
  }
  *size_a = (int)((need[0] + 3) / 4 * 4);  // keeps the second buffer 16-byte aligned
  *size_b = (int)need[1];
}

size_t plan_bytes(const Chain& ch, int th, int tw, int* size_a) {
  int b;
  plan(ch, th, tw, size_a, &b);
  return sizeof(float) * ((size_t)*size_a + b);
}

// The widest core <= tw_max whose buffers fit kSmemBudget (the bytes grow
// with the width): (tw, the first buffer's floats, bytes), or tw 0.
void choose(const Chain& ch, int th, int tw_max, int* tw, int* size_a, size_t* bytes) {
  int lo = 0, hi = tw_max;  // lo fits (or is 0), hi + 1 does not (or is past tw_max)
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    int a;
    if (plan_bytes(ch, th, mid, &a) <= kSmemBudget) lo = mid; else hi = mid - 1;
  }
  *tw = lo;
  if (lo > 0) *bytes = plan_bytes(ch, th, lo, size_a);
}

}  // namespace

extern "C" {

// The core width and shared-memory bytes the kernel takes for this chain at
// tile height th, the width at most tw_max; returns 0, or cudaErrorInvalidValue
// when not even one column fits.
int conv_chain_plan(const void* chain, int th, int tw_max, int* tw, int* smem_bytes) {
  const Chain& ch = *static_cast<const Chain*>(chain);
  int a;
  size_t bytes = 0;
  choose(ch, th, tw_max, tw, &a, &bytes);
  *smem_bytes = (int)bytes;
  return *tw > 0 ? 0 : (int)cudaErrorInvalidValue;
}

// x: (B, c0, H, W) f32 with element strides (sb, sc, sh, sw); y: (B, cout, H, W)
// f32 contiguous; the chain's weights on the same device. One launch on
// PyTorch's stream, tiles of th rows by the widest width <= tw_max that fits.
// Returns a cudaError_t.
int conv_chain_f32(const void* chain, const void* x, long long sb, long long sc, long long sh,
                   long long sw, void* y, int B, int H, int W, int th, int tw_max,
                   void* stream) {
  const Chain& ch = *static_cast<const Chain*>(chain);
  if (ch.n < 1 || ch.n > kMaxStages || th < 1 || tw_max < 1 || B < 1 || H < 1 || W < 1) {
    return cudaErrorInvalidValue;
  }
  int tw, size_a;
  size_t bytes;
  choose(ch, th, tw_max, &tw, &size_a, &bytes);
  if (tw == 0) return cudaErrorInvalidValue;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return e;
  chain_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      ch, static_cast<const float*>(x), sb, sc, sh, sw, static_cast<float*>(y), H, W, th, tw,
      size_a);
  return cudaGetLastError();
}

const char* conv_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
