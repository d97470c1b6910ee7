// Loads and stores of the token streams that K1 and K2 take in float32 or bf16
// (x, y, dy, dx). Every value is widened to float32 on load and rounded to
// nearest even on store; all arithmetic between is float32.
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// v rounded to the precision of the stream `p` points into, kept in float32.
__device__ __forceinline__ float round_like(const float*, float v) { return v; }
__device__ __forceinline__ float round_like(const __nv_bfloat16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
