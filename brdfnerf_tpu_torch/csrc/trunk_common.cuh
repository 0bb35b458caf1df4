// The trunk kernels' shared constants, the polynomial-sine activation and
// softplus (every csrc/trunk_* source).  The kernels' machinery lives in
// sm90_common.cuh (TMA, mbarriers, wgmma) and sm90_trunk.cuh (the warp
// roles, the weight ring and the products).
//
// Weight matrices are stored (out, in) row-major in global memory (the
// nn.Linear layout).  The weights of the whole trunk are 4.6 MB in bf16, so
// they stay in the 50 MB L2 while every block streams through them once per
// tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace trunk {

typedef __nv_bfloat16 bf16;

constexpr int F = 512;           // trunk width
constexpr int EP = 128;          // encoding width, padded
constexpr int T = 64;            // points per tile
constexpr int HID = F / 2;       // the flagship heads' hidden width
constexpr int HEAD_COLS = 8;     // packed head logits per point

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ------------------------------------------------------------- activations

// Polynomial sine of the JAX package's ops/fast_math.py (same constants,
// same expression order; rintf rounds half to even like jnp.round).
constexpr double C1 = 9.999845867745e-01;
constexpr double C3 = -1.666325820430e-01;
constexpr double C5 = 8.312382933817e-03;
constexpr double C7 = -1.931618219602e-04;
constexpr double C9 = 2.173210068083e-06;
constexpr double TWO_PI = 6.283185307179586;
constexpr double INV_2PI = 0.15915494309189535;

// h = sin(w0 * z) by the polynomial, and d1 = d h / d z (the polynomial's
// derivative; range reduction has unit slope).
//
// TRUNK_IDENTITY_ACT (measurement only, never built by the package) swaps
// the activation for h = w0 * z, d1 = w0, leaving every load, store and
// product in place, so that brdfnerf_tpu_torch/tools/epilogue_share.py can
// time what the polynomial costs inside the kernels.
__device__ __forceinline__ void act_eval(float z, float w0, float& h,
                                         float& d1) {
  const float x = w0 * z;
#ifdef TRUNK_IDENTITY_ACT
  h = x;
  d1 = w0;
#else
  const float v = x - (float)TWO_PI * rintf(x * (float)INV_2PI);
  const float v2 = v * v;
  h = v * ((float)C1 +
           v2 * ((float)C3 +
                 v2 * ((float)C5 + v2 * ((float)C7 + v2 * (float)C9))));
  const float p1 =
      (float)C1 +
      v2 * ((float)(3 * C3) +
            v2 * ((float)(5 * C5) +
                  v2 * ((float)(7 * C7) + v2 * 9.f * (float)C9)));
  d1 = w0 * p1;
#endif
}

__device__ __forceinline__ float softplus(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
}

// The bias of trunk layer i (packed as in ops/fused_mlp.pack_trunk_weights).
__device__ __forceinline__ const float* layer_bias(int i, int skip,
                                                   const float* b0,
                                                   const float* bmid,
                                                   const float* bskip) {
  if (i == 0) return b0;
  if (i == skip) return bskip;
  return bmid + (size_t)(i < skip ? i - 1 : i - 2) * F;
}

}  // namespace trunk

// Each library built from a source that includes this header exports it.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
