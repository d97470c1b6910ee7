// Device code shared by K3 (selective_scan.cu) and K4 (selective_scan_bwd.cu).
//
// Layouts, all f32 and contiguous, G = B * K streams, stream g uses the
// weights of direction k = g % K:
//   u, delta, y, dy : (G, L, D)      Bs, Cs : (G, L, N)
//   A : (K, D, N)                    D_skip, bias : (K, D)
//   carries : (G, nc, N, D)          sumda : (G, nc, D),  nc = ceil(L / T)

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace wm {

__device__ __forceinline__ float softplus(float v) {
  // torch.nn.functional.softplus (threshold 20): above it log1p(exp(v)) == v in f32.
  return v > 20.f ? v : log1pf(expf(v));
}

}  // namespace wm
