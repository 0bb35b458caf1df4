// The fused trunk kernels' shared constants (every csrc/trunk_* source but
// trunk_layers.cu); the activation (polynomial sine, exact sine or ReLU,
// per library) and softplus come from trunk_act.cuh.  The kernels'
// machinery lives in sm90_common.cuh (TMA, mbarriers, wgmma) and
// sm90_trunk.cuh (the warp roles, the weight ring and the products).
//
// Weight matrices are stored (out, in) row-major in global memory (the
// nn.Linear layout).  The weights of the whole trunk are 4.6 MB in bf16 at
// width 512, so they stay in the 50 MB L2 while every block streams through
// them once per tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_act.cuh"

namespace trunk {

typedef __nv_bfloat16 bf16;

// The trunk width, per library (ops/cuda_build.library_key): 512, the
// flagship's, unless -DTRUNK_F gives 64, 128 or 256.  Each of the two
// consumer warpgroups owns F / 2 columns of every trunk product (a wgmma N
// of 32..256), and activation tiles are 64-column blocks.
#ifndef TRUNK_F
#define TRUNK_F 512
#endif
constexpr int F = TRUNK_F;       // trunk width
static_assert(F == 64 || F == 128 || F == 256 || F == 512,
              "TRUNK_F is 64, 128, 256 or 512");
constexpr int EP = 128;          // encoding width, padded
constexpr int T = 64;            // points per tile
constexpr int HID = F / 2;       // the flagship heads' hidden width
constexpr int HEAD_COLS = 8;     // packed head logits per point

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Element i of a head's second-layer weights: bf16, or with SPLIT f32 (the
// heads' W_2 are row reductions on the CUDA cores, which take f32 as is).
template <bool SPLIT>
__device__ __forceinline__ float w2_at(const void* w, int i) {
  if constexpr (SPLIT)
    return static_cast<const float*>(w)[i];
  else
    return __bfloat162float(static_cast<const bf16*>(w)[i]);
}

// The activations (sincos_exact, act_eval, act_eval2) and softplus live
// in trunk_act.cuh, which the layer-major family shares.

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
