// Kernel K5: the backward of K4 for the training step.  With cotangents of
// the packed logits (c_sigma in column 0, the rgb, k, theta, rho_c logits'
// in columns 1..6) and c_g of the gradient output, it returns K3's trunk
// grads and the grads of the flagship head block: dW_f, db_f, dW_1r, db_1r,
// dW_2r, db_2r, dW_1p, db_1p, dW_2p, db_2p.
//
// Replaces: brdfnerf_tpu/ops/pallas_trunk_heads.py::_bwd_kernel_h
// (pallas_call at pallas_trunk_heads.py:416).
//
// What bounds it: tensor-core operations.  A point costs K3's 15,051,776 FLOP
// plus 4,727,808 for the heads (their recompute from zs, the a_xf and a_h
// products, and the outer products of dW_f and dW_1), 19.8 MFLOP in all,
// against about 18 KB of input: 2.6 ms at 131,072 points.  What holds it
// back on the card is K3's memory traffic (trunk_bwd.cuh) plus ~14 KB a
// point of the heads' operands through device memory.
//
// Design (trunk_bwd.cuh): K3's sweep, weight-gradient and reduce kernels.
// Between the sigma head and the reverse sweep, the sweep recomputes the
// head block from h_{L-1} (xf, then the first head layers in four
// 256-column passes, all on K3's wgmma path and weight ring), writes
// c_z1 = act'(z1) (c_z2 W_2) of each pass to global memory by TMA stores
// from its swizzled tile, with the per-tile column sums of db_1 and dW_2
// (the second layers have 3 output columns, so their weight grads are
// column sums too), reloads c_z1 one 64 x 256 chunk at a time by TMA as the
// A operand of a_xf = sum c_z1 W_1 (the tile of the encoding's tangent,
// idle by then, grows to hold the chunk), and seeds the trunk's a_h with
// a_xf W_f in place of K3's c_feats.  The weight-gradient kernel takes 24
// more 128 x 256 tiles, dW_f = h^T a_xf and [dW_1r | dW_1p] = xf^T
// [c_z1r | c_z1p] with K = points, in their own number of slices.  No
// atomics: the result is deterministic.
//
// The b_th chain: the Pallas kernel rebuilds it in f32 from w_sigma; K5, like
// K3, loads the bf16 u states K4 saved (us).  That is the same function with
// one more bf16 rounding of b_th, so K5 differs from its twin by somewhat
// more than K3 does from its own.

#include "trunk_bwd.cuh"

using namespace trunk;

// x, cg (n_rows, 128) f32, cot (n_rows, 8) f32, zs/us (n_rows, layers * 512)
// bf16, with n_rows % 64 == 0; trunk weights as trunk_bwd_launch, heads as
// trunk_heads_fwd_launch.  Scratch: K3's (part (n/64, (layers+1) * 512 +
// HEAD_PART) f32, wpart_tiles = (8 layers - 4) x splits_trunk + 24 x
// splits_heads partial tiles in wpart), then hl, xfb, axf (n, 512) and cz1
// (n, 1024) bf16.  Outputs f32 in (in, out) layout: K3's, then dwf (512,
// 512), dbf (512,), dw1 (512, 1024) = [dW_1r | dW_1p], db1 (1024,), dw2r
// (256, 128), db2r (128,), dw2p (768, 128), db2p (128,), whose columns >= 3
// the kernels leave as they find them.  Three kernels on the stream;
// returns a cudaError_t.
extern "C" int trunk_heads_bwd_launch(
    const float* x, const float* cot, const float* cg, const void* zs,
    const void* us, int n_rows, int n_blocks, const void* w0,
    const void* wmid, const void* wskip, const float* wsig,
    const float* bsig, const void* wf, const float* bf, const void* w1r,
    const float* b1r, const void* w2r, const void* w1p, const float* b1p,
    const void* w2p, void* xt, void* hth, void* azbtz, float* part,
    float* pbs, float* tzsc, float* wpart, int splits_trunk,
    int splits_heads, int wpart_tiles, void* hl, void* xfb, void* axf,
    void* cz1, float* dw0, float* db0, float* dwm, float* dbm, float* dwst,
    float* dwsb, float* dbs, float* dwsig, float* dbsig, float* dwf,
    float* dbf, float* dw1, float* db1, float* dw2r, float* db2r,
    float* dw2p, float* db2p, int layers, int skip, void* stream) {
  BwdArgs p = {};
  p.x = x;
  p.cot = cot;
  p.cg = cg;
  p.zs = static_cast<const bf16*>(zs);
  p.us = static_cast<const bf16*>(us);
  p.n = n_rows;
  p.n_tiles = n_rows / T;
  p.w0 = static_cast<const bf16*>(w0);
  p.wmid = static_cast<const bf16*>(wmid);
  p.wskip = static_cast<const bf16*>(wskip);
  p.wsig = wsig;
  p.bsig = bsig;
  p.wf = static_cast<const bf16*>(wf);
  p.bf = bf;
  p.w1r = static_cast<const bf16*>(w1r);
  p.b1r = b1r;
  p.w2r = static_cast<const bf16*>(w2r);
  p.w1p = static_cast<const bf16*>(w1p);
  p.b1p = b1p;
  p.w2p = static_cast<const bf16*>(w2p);
  p.xt = static_cast<bf16*>(xt);
  p.hth = static_cast<bf16*>(hth);
  p.azbtz = static_cast<bf16*>(azbtz);
  p.part = part;
  p.pbs = pbs;
  p.tzsc = tzsc;
  p.wpart = wpart;
  p.splits_trunk = splits_trunk;
  p.splits_heads = splits_heads;
  p.wpart_tiles = wpart_tiles;
  p.hl = static_cast<bf16*>(hl);
  p.xfb = static_cast<bf16*>(xfb);
  p.axf = static_cast<bf16*>(axf);
  p.cz1 = static_cast<bf16*>(cz1);
  p.dw0 = dw0;
  p.db0 = db0;
  p.dwm = dwm;
  p.dbm = dbm;
  p.dwst = dwst;
  p.dwsb = dwsb;
  p.dbs = dbs;
  p.dwsig = dwsig;
  p.dbsig = dbsig;
  p.dwf = dwf;
  p.dbf = dbf;
  p.dw1 = dw1;
  p.db1 = db1;
  p.dw2r = dw2r;
  p.db2r = db2r;
  p.dw2p = dw2p;
  p.db2p = db2p;
  p.layers = layers;
  p.skip = skip;
  return launch_bwd<true>(p, n_blocks, stream);
}
