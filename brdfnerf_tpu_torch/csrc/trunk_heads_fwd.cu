// Kernel K4: kernel K2's trunk and its reverse chain of g = d sigma / d x_enc,
// plus the flagship head block on each tile's features: xf = h W_f^T + b_f,
// the rgb head and the three RPV(111) heads, which leave as packed logits
// [softplus sigma, rgb x3, k, theta, rhoc, 0] (n, 8) f32 beside gx.  The
// features never reach device memory.  In training it also saves zs for the
// backward kernel K5 (trunk_heads_bwd.cu), exactly as K2 does, and, like the
// Pallas kernel, nothing else: K5 rebuilds the u chain from zs.
//
// Replaces: brdfnerf_tpu/ops/pallas_trunk_heads.py::_fwd_kernel_h
// (pallas_call at pallas_trunk_heads.py:364), with and without zs.
//
// What bounds it: tensor-core operations.  At width 512 a point costs K2's
// 7,586,816 FLOP plus 787,968 multiply-adds for the heads (9.16 MFLOP in
// all), against 512 bytes of input and 544 bytes of output (8 KB more with
// zs).  The heads add 3 F^2 + 3 F multiply-adds a point at width F (12,480
// at 64, 49,536 at 128, 197,376 at 256); tools/width_check.trunk_work
// counts every width's bytes and operations.
//
// Design (trunk_fwd_grad.cuh, on sm90_trunk.cuh): K2's warp-specialised
// tile loop.  After the last trunk layer h replaces the layer's input in the
// activation tile and act'(z_{L-1}) goes to the block's scratch, so that the
// registers of the pre-activations are free for the head products; xf then
// replaces h in the same tile.  The first head layers run as four
// HID-column products, HID = F / 2 (rgb, then k, theta and rho_c from the
// merged W_1p), each warpgroup taking HID / 2 columns (wgmma n128 at width
// 512, n16 at 64), each followed by its activation; the second layers
// have 3 output columns in all, so each logit is a row reduction of
// bf16(hidden) against its weight row (as the sigma head is), and no
// hidden activation reaches shared memory.  Rounding points are the
// Pallas kernel's: bf16 operands (h, xf, the hidden activations) with f32
// sums.  At compute_dtype float32 (split) every product of f32 operands
// runs as three on their bf16 hi and lo terms, the head weights W_f, W_1r
// and W_1p as hi and lo planes and W_2 in f32, as K2's float32
// instantiation does (trunk_fwd_grad.cuh).  Deterministic: fixed
// summation orders.

#include "trunk_fwd_grad.cuh"

using namespace trunk;

// x (n_rows, 128) f32 with n_rows % 64 == 0; trunk weights as
// trunk_fwd_grad_launch; heads as ops/fused_trunk_heads.pack_head_weights
// at the library's width F (bf16 weights, f32 biases; with split, wf, w1r
// and w1p as (2, ...) hi and lo planes and w2r, w2p f32).  Outputs out (n_rows, 8)
// f32, gx (n_rows, 128) f32, and, when zs is not null, zs (n_rows, layers
// * F), f32 when zs_f32 (the mixed bfloat16 and float32 contracts) else
// bf16.  scratch holds n_blocks * layers * 64 * F floats.
// Returns a cudaError_t.
extern "C" int trunk_heads_fwd_launch(
    const float* x, int n_rows, int n_blocks, const void* w0, const float* b0,
    const void* wmid, const float* bmid, const void* wskip,
    const float* bskip, const float* wsig, const float* bsig, const void* wf,
    const float* bf, const void* w1r, const float* b1r, const void* w2r,
    const float* b2r, const void* w1p, const float* b1p, const void* w2p,
    const float* b2p, float* out, float* gx, float* scratch, void* zs,
    int zs_f32, int split, int layers, int skip, void* stream) {
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
  p.wf = static_cast<const bf16*>(wf);
  p.bf = bf;
  p.w1r = static_cast<const bf16*>(w1r);
  p.b1r = b1r;
  p.w2r = w2r;
  p.b2r = b2r;
  p.w1p = static_cast<const bf16*>(w1p);
  p.b1p = b1p;
  p.w2p = w2p;
  p.b2p = b2p;
  p.out = out;
  p.gx = gx;
  p.scratch = scratch;
  if (zs_f32)
    p.zsf = static_cast<float*>(zs);
  else
    p.zs = static_cast<bf16*>(zs);
  p.split = split;
  p.layers = layers;
  p.skip = skip;
  return launch_fwd<true>(p, n_rows, n_blocks, stream);
}

// The dynamic shared memory a block of the kernel takes (for the tools).
extern "C" int trunk_heads_fwd_smem() { return fwd_smem(); }
