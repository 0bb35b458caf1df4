// The trunk's activation (polynomial sine, exact sine or ReLU, per
// library) and softplus, shared by both trunk kernel families: the fused
// kernels (trunk_common.cuh includes this header) and the layer-major ones
// (trunk_layers.cu), which take any width and so cannot include
// trunk_common.cuh's width constants.

#pragma once

#include <cuda_runtime.h>

namespace trunk {

// Polynomial sine of the JAX package's ops/fast_math.py (same constants,
// same expression order; rintf rounds half to even like jnp.round).
constexpr double C1 = 9.999845867745e-01;
constexpr double C3 = -1.666325820430e-01;
constexpr double C5 = 8.312382933817e-03;
constexpr double C7 = -1.931618219602e-04;
constexpr double C9 = 2.173210068083e-06;
constexpr double TWO_PI = 6.283185307179586;
constexpr double INV_2PI = 0.15915494309189535;

// The activation, one of three, chosen per library at compile time
// (ops/cuda_build.ACTS), as pallas_trunk_vjp._act_all chooses it:
//   TRUNK_ACT 0  the polynomial sine (fast_sin, every package build of old)
//   TRUNK_ACT 1  the exact sine: x = w0 z in f32, sin x and w0 cos x to
//                about an ulp (sincos_exact below)
//   TRUNK_ACT 2  ReLU: max(z, 0), act' = (z > 0), act'' = 0; w0 is ignored,
//                the first layer's too
// The heads' hidden activations (w0 = 1) take the same choice.
#ifndef TRUNK_ACT
#define TRUNK_ACT 0
#endif
static_assert(TRUNK_ACT >= 0 && TRUNK_ACT <= 2, "TRUNK_ACT is 0, 1 or 2");

// sin x and cos x for f32 x, to within an ulp or two of the correctly
// rounded values for |x| <= 105,615 (the library's own fast-path range;
// the trunk's w0 z stays below ~10^3, and beyond that range the reduction
// loses bits): x is reduced by the nearest multiple j of pi/2 in three
// FMAs (Cody-Waite, pi/2 as three f32 terms), sin and cos of r, |r| <= pi/4,
// come from their Taylor polynomials in f32 (truncated past r^9 and r^10:
// 2e-9 and 1e-10 at pi/4), and j mod 4 picks the quadrant.  Branch-free
// and without local memory.  Not sincosf: the library's float path inlines
// its Payne-Hanek reduction (a loop over the bits of 2/pi and a local
// array) at every call, and the epilogues call the activation from fully
// unrolled loops, 128 sites an epilogue; so built, K2's library took
// ptxas ~320 s (the polynomial's 45 s) and spilled 740 B (288 B).  A
// reduction in double throughout spilled 1,968 B, and a branch to it for
// large |x| cost as much again (chip_smoke.py on the H100: K2 +54%, K3
// +77% over the polynomial).
__device__ __forceinline__ void sincos_exact(float x, float& s, float& c) {
  const float j = rintf(x * 0.636619772f);           // x / (pi / 2)
  float r = fmaf(j, -1.57079637e+00f, x);
  r = fmaf(j, 4.37113883e-08f, r);
  r = fmaf(j, 1.71512451e-15f, r);
  const int q = (int)j & 3;
  const float r2 = r * r;
  float ps = fmaf(r2, 2.7557319e-6f, -1.9841270e-4f);   // 1/9!, -1/7!
  ps = fmaf(ps, r2, 8.3333333e-3f);                     // 1/5!
  ps = fmaf(ps, r2, -1.6666667e-1f);                    // -1/3!
  const float sr = fmaf(ps * r2, r, r);
  float pc = fmaf(r2, -2.7557319e-7f, 2.4801587e-5f);   // -1/10!, 1/8!
  pc = fmaf(pc, r2, -1.3888889e-3f);                    // -1/6!
  pc = fmaf(pc, r2, 4.1666668e-2f);                     // 1/4!
  pc = fmaf(pc, r2, -0.5f);
  const float cr = fmaf(pc, r2, 1.0f);
  // x = r + q pi/2: sin x = sin r, cos r, -sin r, -cos r for q = 0..3
  const float a = (q & 1) ? cr : sr, b = (q & 1) ? sr : cr;
  s = (q & 2) ? -a : a;
  c = ((q + 1) & 2) ? -b : b;
}

// h = act(z) at frequency w0 and d1 = d h / d z (for the polynomial, its
// derivative; range reduction has unit slope).
//
// TRUNK_IDENTITY_ACT (measurement only, never built by the package) swaps
// the activation for h = w0 * z, d1 = w0, leaving every load, store and
// product in place, so that brdfnerf_tpu_torch/tools/epilogue_share.py can
// time what the polynomial costs inside the kernels.
__device__ __forceinline__ void act_eval(float z, float w0, float& h,
                                         float& d1) {
#ifdef TRUNK_IDENTITY_ACT
  h = w0 * z;
  d1 = w0;
#elif TRUNK_ACT == 1
  float s, c;
  sincos_exact(w0 * z, s, c);
  h = s;
  d1 = w0 * c;
#elif TRUNK_ACT == 2
  h = fmaxf(z, 0.f);
  d1 = z > 0.f ? 1.f : 0.f;
#else
  const float x = w0 * z;
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

// h, act' and act'' (the JAX package's pallas_trunk_vjp._act_all with
// want_d2, same expression order).
__device__ __forceinline__ void act_eval2(float z, float w0, float& h,
                                          float& d1, float& d2) {
#ifdef TRUNK_IDENTITY_ACT
  h = w0 * z;
  d1 = w0;
  d2 = 0.f;
#elif TRUNK_ACT == 1
  float s, c;
  sincos_exact(w0 * z, s, c);
  h = s;
  d1 = w0 * c;
  d2 = -(w0 * w0) * s;
#elif TRUNK_ACT == 2
  h = fmaxf(z, 0.f);
  d1 = z > 0.f ? 1.f : 0.f;
  d2 = 0.f;
#else
  const float x = w0 * z;
  const float v = x - (float)TWO_PI * rintf(x * (float)INV_2PI);
  const float v2 = v * v;
  h = v * ((float)C1 +
           v2 * ((float)C3 +
                 v2 * ((float)C5 + v2 * ((float)C7 + v2 * (float)C9))));
  d1 = w0 * ((float)C1 +
             v2 * ((float)(3 * C3) +
                   v2 * ((float)(5 * C5) +
                         v2 * ((float)(7 * C7) + v2 * 9.f * (float)C9))));
  d2 = (w0 * w0) * v *
       ((float)(6 * C3) +
        v2 * ((float)(20 * C5) +
              v2 * ((float)(42 * C7) + v2 * 72.f * (float)C9)));
#endif
}

__device__ __forceinline__ float softplus(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
}

}  // namespace trunk
