// Kernel K2: the siren trunk forward plus the reverse chain of
// g = d sigma / d x_enc, for the main pass of a spsbrdf render (sigma, the
// features for the heads, and the analytic normals); in training it also
// saves what the backward kernel K3 (trunk_bwd.cu) reads.
//
// Replaces: brdfnerf_tpu/ops/pallas_trunk_vjp.py::_fwd_kernel (pallas_call
// at pallas_trunk_vjp.py:409), both with and without the zs/us outputs.
//
// What bounds it: tensor-core operations.  A point costs the forward's
// 1.897 M multiply-adds plus about as many for the reverse chain (7.59 MFLOP
// in all), against 512 bytes of input and about 1.5 KB of output (16 KB
// more with zs/us).
//
// The kernel body, shared with K4, and its design (a warp-specialised
// persistent kernel on wgmma, fed through a TMA ring by a producer warp,
// sm90_trunk.cuh) are in trunk_fwd_grad.cuh.

#include "trunk_fwd_grad.cuh"

using namespace trunk;

// x (n_rows, 128) f32 with n_rows % 64 == 0; weights as trunk_sigma_launch
// (with split: f32 operands, the weights as hi and lo planes), at the
// library's width F (TRUNK_F).  Outputs sigma (n_rows,) f32, feats
// (n_rows, F) bf16 when feats_bf16 else f32, gx (n_rows, 128) f32, and,
// when zs is not null, zs and us (n_rows, layers * F), f32 when zs_f32
// else bf16.  scratch holds n_blocks * (layers-1) * 64 * F floats.
// Returns a cudaError_t.
extern "C" int trunk_fwd_grad_launch(
    const float* x, int n_rows, int n_blocks, const void* w0, const float* b0,
    const void* wmid, const float* bmid, const void* wskip,
    const float* bskip, const float* wsig, const float* bsig, float* sigma,
    void* feats, int feats_bf16, float* gx, float* scratch, void* zs,
    void* us, int zs_f32, int split, int layers, int skip, void* stream) {
  FwdArgs p = {};
  p.x = x;
  p.n_tiles = n_rows / T;
  p.w0 = static_cast<const bf16*>(w0);
  p.b0 = b0;
  p.wmid = static_cast<const bf16*>(wmid);
  p.bmid = bmid;
  p.wskip = static_cast<const bf16*>(wskip);
  p.bskip = bskip;
  p.wsig = wsig;
  p.bsig = bsig;
  p.sigma = sigma;
  p.feats = feats;
  p.feats_bf16 = feats_bf16;
  p.gx = gx;
  p.scratch = scratch;
  if (zs_f32) {
    p.zsf = static_cast<float*>(zs);
    p.usf = static_cast<float*>(us);
  } else {
    p.zs = static_cast<bf16*>(zs);
    p.us = static_cast<bf16*>(us);
  }
  p.split = split;
  p.layers = layers;
  p.skip = skip;
  return launch_fwd<false>(p, n_rows, n_blocks, stream);
}

// The dynamic shared memory a block of the kernel takes (for the tools).
extern "C" int trunk_fwd_grad_smem() { return fwd_smem(); }
