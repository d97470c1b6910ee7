// ART's attention on Hopper, without a gradient: for each group b and head h
//   out[b, i, h*32 + :] = softmax_j(q[b,h,i] . k[b,h,j] + table[idx(i,j), h] + key_bias[j]) v[b,h,j]
// in one launch a call, float32-accurate, never holding the scores.
//
// It replaces no TPU kernel: the JAX package computes ART's attention with XLA
// einsums (`wavemamba_tpu/models/art.py`). On the card the route it replaces
// was torch's float32 memory-efficient attention (an sm80 SIMT build), which
// read the position bias as a dense (heads, N, N) mask: 25.6 GB of mask
// traffic in each sparse call of a 2176x3840 bucket.
//
// The bias. ART's dynamic position bias is the bias MLP's table of
// (2gh-1)(2gw-1) offsets by heads (`models/art.py:Attention.pos`), indexed by
// the offset between a query token (yq, xq) and a key token (yk, xk) of the
// group's gh x gw grid: (yq-yk+gh-1)(2gw-1) + (xq-xk+gw-1). That is
// lin(q) - lin(k) + C with lin(t) = y(t)(2gw-1) + x(t), so each block stages
// its head's column of the table (31.9 KB at gh=34, gw=60) and lin(k) of
// every key in shared memory, and each score looks its bias up there.
//
// What bounds it on an H100 (`cardbench/roofline_art.attention_bound`):
//   * sparse groups (256 x 6 heads x 2,040 tokens at the 4K bucket): the
//     products, 4 B heads N^2 hd FLOPs at the rate of a float32-accurate
//     product, three TF32 products (495 / 3 TFLOP/s): 4.96 ms;
//   * dense windows (8,160 x 6 x 64 tokens): the bytes, q, k, v read and the
//     output written once, 1.6 GB: 0.48 ms.
// The design, point by point:
//   * Three TF32 products. Each operand is split into a high TF32 part
//     (rounded to nearest) and the remainder, and each product is
//     lo*hi + hi*lo + hi*hi on the tensor cores (`wgmma` m64nNk8 .tf32, the
//     small terms first); q's and K's and V's remainders are rounded to TF32,
//     P's is left to the tensor cores, which drop its low bits. The online
//     softmax is float32, its exponentials `ex2.approx.ftz.f32`. Each tile's
//     p . v is a fresh sum, added to the rows' output in float32.
//   * `wgmma` with A from registers, 64 query rows a warpgroup: q's
//     fragments (high and low) stay in registers for the whole pass; so does
//     P, split in registers into the A fragments of p . v. The scores'
//     accumulator layout gives a thread columns 2t, 2t+1 of each 8 keys,
//     where an A fragment wants t, t+4: rather than shuffle, the keys of
//     each 8 are permuted in V's shared tile (logical key t <-> 2t,
//     t+4 <-> 2t+1), which leaves the sum unchanged.
//   * K and V pass through shared memory 64 keys a tile, split into high
//     and low once, in `wgmma`'s 128-byte swizzled K-major layout (a
//     32-float row is one swizzle row): K as loaded, V transposed (key-major
//     for p . v). The last tile of a ragged N is masked (keys >= N score
//     -inf and load as 0).
//   * Sparse groups (N > 64, `art_attention_group_kernel`): one block a
//     (group, head, 128 query rows), warp-specialised. A producer warpgroup
//     loads the tiles, splits them and fills a ring of two tile sets; two
//     consumer warpgroups share each tile (so a tile is split once for 128
//     rows), each issuing the previous tile's p . v with this tile's
//     q . k^T and running a tile's softmax while the other's products run.
//     The products' instruction shapes (n64, and n32 for p . v at a head
//     width of 32) hold them near half the tensor cores' rate.
//   * Dense windows (N <= 64, `art_attention_window_kernel`): one tile, one
//     warpgroup a (window, head), three blocks an SM to keep the loads in
//     flight; the output goes straight into the (B, N, heads * 32) layout
//     that the projection reads, as in the group kernel.
//
// q, k, v: (B, H, N, 32) float32 with any strides but a unit stride in the
// head dimension (the permuted views of the qkv output are read as they are);
// k and v 16-byte aligned. q is already scaled. key_bias: (N,) float32 or
// null. rows: (B,) int32 group indices or null: block b reads and writes
// group rows[b], so one launch serves one pad class of a grouping.
// Built with `ops/scan_cuda.py:build`, bound with ctypes
// (`ops/art_attention.py`).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kHd = 32;       // head width the kernel is built for
constexpr int kBM = 64;       // query rows a block: one warpgroup
constexpr int kBN = 64;       // keys a tile
constexpr int kThreads = 128;
constexpr int kTileBytes = kBN * kHd * 4;  // one of K hi, K lo, V hi, V lo: 8 KB
constexpr int kStages = 2;                 // tile sets in the ring of the group kernel
constexpr int kAlign = 1024;               // the 128-byte swizzle's period
constexpr int kSmemMax = 232448;           // a block's shared memory on an H100
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  const float* table;  // (offsets, H): element (o, h) at o * t_so + h * t_sh
  long long t_so, t_sh;
  const float* key_bias;  // (N,) or null
  const int* rows;        // (B,) or null
  float* out;             // (rows of the grouping, N, H * 32): (b, i, h*32 + d)
  long long o_sb, o_sn;
  int B, H, N, gh, gw;
};

__host__ __device__ inline int n_offsets(int gh, int gw) { return (2 * gh - 1) * (2 * gw - 1); }
__host__ __device__ inline int n_pad(int n) { return (n + kBN - 1) / kBN * kBN; }

// Dynamic shared memory: the alignment slack, the four tiles (N <= 64) or a
// ring of kStages sets and its barriers, 4 lin(k) of every key (padded to a
// whole tile) and the table's column.
inline long long smem_bytes(int gh, int gw, int n) {
  const long long tiles = n <= kBN ? 4LL * kTileBytes : kStages * (4LL * kTileBytes) + 64;
  return kAlign + tiles + 4LL * n_offsets(gh, gw) + 4LL * n_pad(n);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The high TF32 part of x, rounded to nearest (ties away): x's top 19 bits.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1,024 bytes apart (the leading offset is unused).
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy stores to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// 2^x on the special-function unit (a result below 2^-126 flushes to 0, far
// under a softmax row's sum of at least 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64) += a (64 x 8, registers) . b (8 x 64, shared, K-major); scale_d 0 overwrites.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 32) += a (64 x 8, registers) . b (8 x 32, shared, K-major); scale_d 0 overwrites.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The tiles in shared memory (base 1,024-aligned): K hi, K lo as (key, d)
// rows of 128 bytes; V hi, V lo transposed, (d, key) in two 32-key atoms of
// 4 KB. The 16-byte chunk c of row r sits at chunk c ^ (r % 8).
struct Tiles {
  unsigned char* base;
  __device__ float* k(int part) const { return reinterpret_cast<float*>(base + part * kTileBytes); }
  __device__ float* v(int part) const {
    return reinterpret_cast<float*>(base + (2 + part) * kTileBytes);
  }
};

__device__ __forceinline__ int k_offset(int key, int d) {  // in floats
  return key * kHd + ((((d >> 2) ^ (key & 7)) << 2) | (d & 3));
}
// V's logical key c (the order p . v reads) of physical key p of the tile.
__device__ __forceinline__ int v_logical(int p) {
  const int q = p & 7;
  return (p & ~7) | ((q >> 1) + ((q & 1) << 2));
}
__device__ __forceinline__ int v_offset(int c, int d) {  // in floats
  const int cc = c & 31;
  return (c >> 5) * (32 * kHd) + d * 32 + ((((cc >> 2) ^ (d & 7)) << 2) | (cc & 3));
}

// One tile of raw K and V in registers, 4 float4 of each a thread. Warp w
// holds keys 16w..16w+15. K: 4 keys an instruction, 8 lanes a 128-byte row
// (4 cache lines a load); a row's 8 stores land in its 8 swizzled chunks.
// V: 16 keys by 2 chunks an instruction, so that the transposed scalar
// stores of the 32 lanes fall in 32 banks.
struct Raw {
  float4 k[4], v[4];
};

__device__ __forceinline__ int k_key(int i) {
  return 16 * (threadIdx.x >> 5) + 4 * i + ((threadIdx.x & 31) >> 3);
}
__device__ __forceinline__ int k_chunk() { return threadIdx.x & 7; }
__device__ __forceinline__ int v_key() { return 16 * (threadIdx.x >> 5) + (threadIdx.x & 15); }
__device__ __forceinline__ int v_chunk(int i) { return ((threadIdx.x & 31) >> 4) + 2 * i; }

__device__ __forceinline__ void load_tile(Raw& r, const Params& p, const float* kb,
                                          const float* vb, int key0) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int vk = key0 + v_key();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = key0 + k_key(i);
    r.k[i] = kk < p.N ? __ldg(reinterpret_cast<const float4*>(kb + kk * p.k_sn) + k_chunk()) : zero;
    r.v[i] = vk < p.N ? __ldg(reinterpret_cast<const float4*>(vb + vk * p.v_sn) + v_chunk(i)) : zero;
  }
}

__device__ __forceinline__ void store_tile(const Raw& r, const Tiles& t) {
  const int c = v_logical(v_key());
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x[4] = {r.k[i].x, r.k[i].y, r.k[i].z, r.k[i].w};
    float hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = tf32_hi(x[e]);
      lo[e] = tf32_hi(x[e] - hi[e]);
    }
    const int off = k_offset(k_key(i), 4 * k_chunk());
    *reinterpret_cast<float4*>(t.k(0) + off) = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(t.k(1) + off) = make_float4(lo[0], lo[1], lo[2], lo[3]);
    const float y[4] = {r.v[i].x, r.v[i].y, r.v[i].z, r.v[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = tf32_hi(y[e]);
      const int o = v_offset(c, 4 * v_chunk(i) + e);
      t.v(0)[o] = h;
      t.v(1)[o] = tf32_hi(y[e] - h);
    }
  }
}

// q's A fragments, high and low, for the 4 steps of 8 over d: rows r0 and
// r0 + 8, columns t and t + 4 of each step (rows past N read 0).
__device__ __forceinline__ void load_q(uint32_t (&qh)[4][4], uint32_t (&ql)[4][4],
                                       const Params& p, const float* qb, int r0, int t) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 8 * (j & 1);
      const int d = 8 * ks + t + 4 * (j >> 1);
      const float x = r < p.N ? __ldg(qb + r * p.q_sn + d) : 0.f;
      const float h = tf32_hi(x);
      qh[ks][j] = __float_as_uint(h);
      ql[ks][j] = __float_as_uint(tf32_hi(x - h));
    }
  }
}

// s (64 x 64) = q . k^T of the tile in shared memory, three TF32 products,
// issued (the caller fences, commits and waits).
__device__ __forceinline__ void issue_scores(float (&s)[32], const uint32_t (&qh)[4][4],
                                             const uint32_t (&ql)[4][4], const Tiles& t) {
  const uint32_t kh = smem_addr(t.k(0)), kl = smem_addr(t.k(1));
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_n64(s, ql[ks], desc_b128(kh + 32 * ks), ks > 0);
    wgmma_n64(s, qh[ks], desc_b128(kl + 32 * ks), 1);
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_n64(s, qh[ks], desc_b128(kh + 32 * ks), 1);
}

// o (64 x 32) = p . v of the tile, p split into A fragments (ph, pl),
// issued. A fresh sum each tile: the tensor cores truncate what they add,
// which over the 32 tiles of a 2,040-token group cost 8x the float32
// formula's error when o ran on across tiles; the tiles' sums are added in
// float32.
__device__ __forceinline__ void issue_values(float (&o)[16], const uint32_t (&ph)[8][4],
                                             const uint32_t (&pl)[8][4], const Tiles& t) {
  const uint32_t vh = smem_addr(t.v(0)), vl = smem_addr(t.v(1));
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = (kk >> 2) * (32 * kHd * 4) + (kk & 3) * 32;
    wgmma_n32(o, pl[kk], desc_b128(vh + off), kk > 0);
    wgmma_n32(o, ph[kk], desc_b128(vl + off), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = (kk >> 2) * (32 * kHd * 4) + (kk & 3) * 32;
    wgmma_n32(o, ph[kk], desc_b128(vh + off), 1);
  }
}

// One warpgroup's 64 query rows through the online softmax: q's fragments,
// the two rows of this thread (r0 = q0 + 16 w + lane / 4 and r0 + 8), their
// bias base lin(q) + C, running max (natural units), partial sum of
// exponentials, output accumulator; and the tile in flight: its scores,
// P's A fragments (high, and the remainder whose low bits the tensor cores
// drop) and the rescale of the rows' sums that it brings.
struct Rows {
  uint32_t qh[4][4], ql[4][4];
  int base[2];
  float m[2], l[2], o[16];
  float s[32], ot[16], corr[2];
  uint32_t ph[8][4], pl[8][4];
};

__device__ __forceinline__ void rows_init(Rows& R, const Params& p, const float* qb, int q0,
                                          int w, int lane) {
  load_q(R.qh, R.ql, p, qb, q0 + 16 * w + (lane >> 2), lane & 3);
  const int wide = 2 * p.gw - 1;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = min(q0 + 16 * w + (lane >> 2) + 8 * e, p.N - 1);
    R.base[e] = (r / p.gw) * wide + r % p.gw + (p.gh - 1) * wide + p.gw - 1;
    R.m[e] = -CUDART_INF_F;
    R.l[e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) R.o[i] = 0.f;
}

// The scores of the tile from key0 (in R.s) to P: the bias, the key bias,
// the tail's mask, the softmax's update, P split into R.ph, R.pl.
template <bool kKeyBias>
__device__ __forceinline__ void softmax_tile(Rows& R, const float* tab, const int* klin, int key0,
                                             const Params& p, int lane) {
  float(&s)[32] = R.s;
  const int tq = lane & 3;
  // The bias of (row, key) sits 4 lin(key) bytes below the row's base in
  // the table: klin holds 4 lin(k), two keys a load.
  const unsigned char* row[2] = {reinterpret_cast<const unsigned char*>(tab + R.base[0]),
                                 reinterpret_cast<const unsigned char*>(tab + R.base[1])};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = key0 + 8 * j + 2 * tq;
    const int2 kl = *reinterpret_cast<const int2*>(klin + key);
    float2 add = make_float2(0.f, 0.f);
    if constexpr (kKeyBias) {
      add.x = key < p.N ? __ldg(p.key_bias + key) : 0.f;
      add.y = key + 1 < p.N ? __ldg(p.key_bias + key + 1) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float b0 = *reinterpret_cast<const float*>(row[r] - kl.x);
      const float b1 = *reinterpret_cast<const float*>(row[r] - kl.y);
      if constexpr (kKeyBias) {
        s[4 * j + 2 * r] += b0 + add.x;
        s[4 * j + 2 * r + 1] += b1 + add.y;
      } else {
        s[4 * j + 2 * r] += b0;
        s[4 * j + 2 * r + 1] += b1;
      }
    }
  }
  if (key0 + kBN > p.N) {  // the tail: keys past N take no weight
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (key0 + 8 * j + 2 * tq + (i & 1) >= p.N) s[4 * j + i] = -CUDART_INF_F;
      }
    }
  }
  float mx[2] = {R.m[0], R.m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float mscaled[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    R.corr[r] = ex2((R.m[r] - mx[r]) * kLog2e);
    R.m[r] = mx[r];
    mscaled[r] = mx[r] * kLog2e;
    R.l[r] *= R.corr[r];
  }
  // s[4j + {0,1,2,3}] hold (r0, 2t), (r0, 2t+1), (r1, 2t), (r1, 2t+1) of
  // keys 8j..8j+7; the A fragment's columns t, t+4 are the logical keys
  // that V's tile puts there.
  constexpr int kOrder[4] = {0, 2, 1, 3};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + kOrder[e];
      const float pv = ex2(fmaf(s[i], kLog2e, -mscaled[kOrder[e] >> 1]));
      R.l[kOrder[e] >> 1] += pv;
      const float h = tf32_hi(pv);
      R.ph[j][e] = __float_as_uint(h);
      R.pl[j][e] = __float_as_uint(pv - h);
    }
  }
}

// The finished tile's p . v (in R.ot) into the rows' output.
__device__ __forceinline__ void accumulate(Rows& R) {
#pragma unroll
  for (int i = 0; i < 16; ++i) R.o[i] = fmaf(R.o[i], R.corr[(i >> 1) & 1], R.ot[i]);
}

template <typename... F>
__device__ __forceinline__ void fence_all(F&... regs) {
  (fence_regs(regs), ...);
}

// The rows' output, o / l, into (b, row, h*32 + d).
__device__ __forceinline__ void rows_store(Rows& R, const Params& p, long long b, int h, int q0,
                                           int w, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    R.l[r] += __shfl_xor_sync(0xffffffffu, R.l[r], 1);
    R.l[r] += __shfl_xor_sync(0xffffffffu, R.l[r], 2);
    R.l[r] = 1.f / R.l[r];
  }
  float* ob = p.out + b * p.o_sb + h * kHd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * w + (lane >> 2) + 8 * r;
    if (row < p.N) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float2*>(ob + row * p.o_sn + 8 * j + 2 * (lane & 3)) =
            make_float2(R.o[4 * j + 2 * r] * R.l[r], R.o[4 * j + 2 * r + 1] * R.l[r]);
      }
    }
  }
}

// The head's column of the table and 4 lin(k) of every key (0 past N), by
// `threads` threads from thread `tid`.
__device__ __forceinline__ void stage_bias(float* tab, int* klin, const Params& p, int h,
                                           int tid, int threads) {
  const int n_off = n_offsets(p.gh, p.gw), np = n_pad(p.N), wide = 2 * p.gw - 1;
  for (int o = tid; o < n_off; o += threads) tab[o] = __ldg(p.table + o * p.t_so + h * p.t_sh);
  for (int j = tid; j < np; j += threads) klin[j] = j < p.N ? 4 * ((j / p.gw) * wide + j % p.gw) : 0;
}

struct Work {  // a block's group, head and first query row
  long long b;
  int h, q0;
};

__device__ __forceinline__ Work work_of(const Params& p, int rows_a_block) {
  const int nq = (p.N + rows_a_block - 1) / rows_a_block;
  const int rest = static_cast<int>(blockIdx.x) / nq;
  const int bi = rest / p.H;
  return {p.rows ? p.rows[bi] : bi, rest % p.H, static_cast<int>(blockIdx.x % nq) * rows_a_block};
}

// The dynamic shared memory from its first 1,024-byte boundary, reached by
// arithmetic on the shared array itself, so that the compiler keeps every
// pointer derived from it in the shared space (32-bit addresses, LDS / STS).
__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ unsigned char smem_raw[];
  return smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
}

// N <= 64 (the dense windows): one tile, one warpgroup a (group, head).
// Bound by bytes: three blocks an SM keep their loads in flight together.
// Shared memory: the tiles, 4 lin(k), the table's column.
template <bool kKeyBias>
__global__ void __launch_bounds__(kThreads, 3) art_attention_window_kernel(const Params p) {
  unsigned char* base = aligned_smem();
  const Tiles tiles{base};
  int* klin = reinterpret_cast<int*>(base + 4 * kTileBytes);
  float* tab = reinterpret_cast<float*>(klin + n_pad(p.N));
  const Work wk = work_of(p, kBM);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  Raw raw;
  load_tile(raw, p, p.k + wk.b * p.k_sb + wk.h * p.k_sh, p.v + wk.b * p.v_sb + wk.h * p.v_sh, 0);
  stage_bias(tab, klin, p, wk.h, tid, kThreads);
  Rows R;
  rows_init(R, p, p.q + wk.b * p.q_sb + wk.h * p.q_sh, 0, w, lane);
  store_tile(raw, tiles);
  fence_async_smem();
  __syncthreads();
  fence_all(R.s);
  wgmma_fence();
  issue_scores(R.s, R.qh, R.ql, tiles);
  wgmma_commit();
  wgmma_wait_all();
  fence_all(R.s);
  softmax_tile<kKeyBias>(R, tab, klin, 0, p, lane);
  fence_all(R.ot);
  wgmma_fence();
  issue_values(R.ot, R.ph, R.pl, tiles);
  wgmma_commit();
  wgmma_wait_all();
  fence_all(R.ot);
  accumulate(R);
  rows_store(R, p, wk.b, wk.h, 0, w, lane);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}
// N > 64 (the sparse groups): a producer warpgroup loads K and V, splits
// them and stores them into a ring of kStages tile sets; two consumer
// warpgroups, 64 query rows each, take every tile of the ring, so a tile is
// split once for 128 rows and the consumers never wait on a load or a
// split. full[s] counts the producer's 128 arrivals, empty[s] the
// consumers' 256. Registers move to the consumers (`setmaxnreg`).
// A consumer issues the previous tile's p . v and this tile's q . k^T
// together and runs a tile's softmax while the other consumer's products
// run. Shared memory: the ring, the barriers, 4 lin(k), the table's column.
// The block starts with 384 x 168 registers; the producer hands its share over.
constexpr int kProducerRegs = 88, kConsumerRegs = 208;  // 128 x 88 + 256 x 208 <= 384 x 168

template <bool kKeyBias>
__global__ void __launch_bounds__(3 * kThreads, 1) art_attention_group_kernel(const Params p) {
  unsigned char* base = aligned_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * 4 * kTileBytes);
  uint64_t* empty = full + kStages;
  int* klin = reinterpret_cast<int*>(empty + kStages);
  float* tab = reinterpret_cast<float*>(klin + n_pad(p.N));
  const Work wk = work_of(p, 2 * kBM);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, w = (tid >> 5) & 3;
  const int nt = n_pad(p.N) / kBN;
  const float* kb = p.k + wk.b * p.k_sb + wk.h * p.k_sh;
  const float* vb = p.v + wk.b * p.v_sb + wk.h * p.v_sh;
  auto ring = [&](int kt) { return Tiles{base + (kt % kStages) * 4 * kTileBytes}; };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kThreads);
      mbar_init(empty + s, 2 * kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  Raw raw;
  Rows R;
  const int q0 = wk.q0 + kBM * (wg - 1);
  if (wg == 0) {
    load_tile(raw, p, kb, vb, 0);
  } else {
    rows_init(R, p, p.q + wk.b * p.q_sb + wk.h * p.q_sh, q0, w, lane);
  }
  stage_bias(tab, klin, p, wk.h, tid, 3 * kThreads);
  __syncthreads();
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    for (int kt = 0; kt < nt; ++kt) {
      const int use = kt / kStages;
      if (use > 0) mbar_wait(empty + kt % kStages, (use - 1) & 1);
      store_tile(raw, ring(kt));
      fence_async_smem();
      mbar_arrive(full + kt % kStages);
      if (kt + 1 < nt) load_tile(raw, p, kb, vb, (kt + 1) * kBN);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  mbar_wait(full, 0);
  fence_all(R.s);
  wgmma_fence();
  issue_scores(R.s, R.qh, R.ql, ring(0));
  wgmma_commit();
  wgmma_wait_all();
  fence_all(R.s);
  softmax_tile<kKeyBias>(R, tab, klin, 0, p, lane);
  for (int kt = 1; kt < nt; ++kt) {
    mbar_wait(full + kt % kStages, (kt / kStages) & 1);
    fence_all(R.s, R.ot);
    wgmma_fence();
    issue_values(R.ot, R.ph, R.pl, ring(kt - 1));
    issue_scores(R.s, R.qh, R.ql, ring(kt));
    wgmma_commit();
    wgmma_wait_all();
    fence_all(R.s, R.ot);
    mbar_arrive(empty + (kt - 1) % kStages);
    accumulate(R);
    softmax_tile<kKeyBias>(R, tab, klin, kt * kBN, p, lane);
  }
  fence_all(R.ot);
  wgmma_fence();
  issue_values(R.ot, R.ph, R.pl, ring(nt - 1));
  wgmma_commit();
  wgmma_wait_all();
  fence_all(R.ot);
  mbar_arrive(empty + (nt - 1) % kStages);
  accumulate(R);
  rows_store(R, p, wk.b, wk.h, q0, w, lane);
}

template <bool kKeyBias>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long long bytes = smem_bytes(p.gh, p.gw, p.N);
  const bool window = p.N <= kBN;
  auto kernel = window ? art_attention_window_kernel<kKeyBias> : art_attention_group_kernel<kKeyBias>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int rows_a_block = window ? kBM : 2 * kBM;
  const long long blocks = static_cast<long long>((p.N + rows_a_block - 1) / rows_a_block) * p.H * p.B;
  kernel<<<static_cast<unsigned>(blocks), window ? kThreads : 3 * kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes a block takes for a gh x gw grid of n tokens.
long long art_attention_smem(int gh, int gw, int n) { return smem_bytes(gh, gw, n); }

// One launch on `stream` (PyTorch's). Returns a cudaError_t.
int art_attention(const void* params, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  if (p.B < 1 || p.H < 1 || p.N < 1 || p.gh < 1 || p.gw < 1 || p.gh * p.gw != p.N ||
      smem_bytes(p.gh, p.gw, p.N) > kSmemMax ||
      static_cast<long long>((p.N + kBM - 1) / kBM) * p.H * p.B > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p.key_bias ? launch<true>(p, s) : launch<false>(p, s));
}

const char* art_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
