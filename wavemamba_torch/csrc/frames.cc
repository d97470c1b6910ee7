// The serving request path's two frame conversions, host C++ for
// `wavemamba_torch/utils/img_util.py`'s `img2batch` / `batch2img`: one pass
// each over a frame, rows split over std::threads, the bits of the numpy
// route they replace.
//
// Built with g++ by `wavemamba_torch/utils/frames.py` (through
// `utils/cxx.py`) into build/wavemamba_torch/libwmframes_<hash>.so and
// loaded with ctypes. Neither pass has a multiply followed by an add for
// floating-point contraction to fuse; fast-math would break the bits.

#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Rows [0, h) in `n_threads` contiguous blocks, block(y0, y1) on a
// std::thread each (the first on the caller's).
template <class Block>
void over_rows(int h, int n_threads, Block block) {
  if (n_threads > h) n_threads = h;
  if (n_threads <= 1) {
    block(0, h);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads - 1);
  for (int t = 1; t < n_threads; ++t)
    threads.emplace_back(block, (int)((int64_t)h * t / n_threads),
                         (int)((int64_t)h * (t + 1) / n_threads));
  block(0, h / n_threads);
  for (auto& th : threads) th.join();
}

// numpy's `clip(x, 0, 1) * 255.0` in float32, `.round()` (half to even) and
// `.astype(uint8)`. NaN gives 0, as numpy's cast gives on x86-64.
inline uint8_t unit_to_u8(float x) {
  x = x > 0.0f ? x : 0.0f;  // NaN fails the comparison: 0
  x = x < 1.0f ? x : 1.0f;
  return (uint8_t)(int)std::nearbyint(x * 255.0f);
}

// One row of `rgb_f32_to_bgr_u8`: each channel to uint8 into its plane of
// `planes` (3 x w; contiguous loads vectorise where pixel_stride is 1), then
// the planes interleaved into `q`, blue first. Arguments are locals here: a
// uint8 store may alias a captured variable, which keeps a loop in the
// caller's lambda from vectorising.
void rgb_row_to_bgr_u8(const float* row, int64_t pixel_stride,
                       int64_t channel_stride, int w, uint8_t* planes,
                       uint8_t* q) {
  for (int c = 0; c < 3; ++c) {
    const float* p = row + c * channel_stride;
    uint8_t* o = planes + (size_t)c * w;
    if (pixel_stride == 1) {
      for (int x = 0; x < w; ++x) o[x] = unit_to_u8(p[x]);
    } else {
      for (int x = 0; x < w; ++x) o[x] = unit_to_u8(p[x * pixel_stride]);
    }
  }
  const uint8_t* r = planes;
  const uint8_t* g = planes + w;
  const uint8_t* b = planes + 2 * (size_t)w;
  for (int x = 0; x < w; ++x) {
    q[3 * x] = b[x];
    q[3 * x + 1] = g[x];
    q[3 * x + 2] = r[x];
  }
}

}  // namespace

extern "C" {

// Image -> batch: uint8 (h, w, 3) BGR, its element at (y, x, c) at
// src[y * row_stride + x * pixel_stride + c * channel_stride] -> float32
// (h, w, 3) RGB, dense. The bits of numpy's `img.astype(float32) / 255.0`:
// a table of IEEE float32 divisions (`u * (1.0f / 255.0f)` can differ in
// the last bit). Rows split over `n_threads` threads.
void bgr_u8_to_rgb_f32(const uint8_t* src, int64_t row_stride,
                       int64_t pixel_stride, int64_t channel_stride, int h,
                       int w, float* dst, int n_threads) {
  float table[256];
  for (int u = 0; u < 256; ++u) table[u] = (float)u / 255.0f;
  over_rows(h, n_threads, [=, &table](int y0, int y1) {
    for (int y = y0; y < y1; ++y) {
      const uint8_t* blue = src + y * row_stride;
      const uint8_t* green = blue + channel_stride;
      const uint8_t* red = green + channel_stride;
      float* q = dst + (size_t)y * w * 3;
      for (int x = 0; x < w; ++x) {
        q[3 * x] = table[red[x * pixel_stride]];
        q[3 * x + 1] = table[green[x * pixel_stride]];
        q[3 * x + 2] = table[blue[x * pixel_stride]];
      }
    }
  });
}

// Batch -> image: float32 (h, w, 3) RGB, strided as `bgr_u8_to_rgb_f32`'s
// source (the model's output is channel-planar) -> uint8 (h, w, 3) BGR,
// dense: `unit_to_u8` of each value. Rows split over `n_threads` threads.
void rgb_f32_to_bgr_u8(const float* src, int64_t row_stride,
                       int64_t pixel_stride, int64_t channel_stride, int h,
                       int w, uint8_t* dst, int n_threads) {
  over_rows(h, n_threads, [=](int y0, int y1) {
    std::vector<uint8_t> planes(3 * (size_t)w);
    for (int y = y0; y < y1; ++y)
      rgb_row_to_bgr_u8(src + y * row_stride, pixel_stride, channel_stride, w,
                        planes.data(), dst + (size_t)y * w * 3);
  });
}

}  // extern "C"
