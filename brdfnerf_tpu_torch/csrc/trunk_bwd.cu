// Kernel K3: the trunk's hand-derived second-order backward, for the
// training step.  With cotangents c_sigma, c_feats, c_g of the outputs of K2
// it returns dS/dW and dS/db of every trunk layer and of the sigma head, for
// S = <c_sigma, sigma> + <c_feats, feats> + <c_g, g>.
//
// Replaces: brdfnerf_tpu/ops/pallas_trunk_vjp.py::_bwd_kernel (pallas_call
// at pallas_trunk_vjp.py:477).
//
// What bounds it: tensor-core operations.  A point costs the tangent
// forward's 1.90 M multiply-adds, the a chain's 7 x 512^2 and the two outer
// products of every layer's weight gradient (3.79 M), about 7.5 M in all,
// against about 18 KB of input: 2.0 ms at the training step's 131,072
// points.  What holds it back on the card is memory traffic: the weights
// streamed from L2 for every 64-point tile, and ~84 KB a point of zs, us,
// the f32 tz round trip and the weight-gradient operands through device
// memory (~11 GB a call).
//
// The math and the design (a sweep, a weight-gradient and a reduce kernel,
// shared with K5, on wgmma and TMA rings) are in trunk_bwd.cuh.

#include "trunk_bwd.cuh"

using namespace trunk;

// At the library's width F (TRUNK_F): x, cg (n_rows, 128) f32, cs
// (n_rows,) f32, cf (n_rows, F) bf16 when cf_bf16 else f32, zs/us (n_rows,
// layers * F), f32 when zs_f32 else bf16, with n_rows % 64 == 0; weights
// as trunk_fwd_grad_launch (split: the float32 instantiation, f32 zs/us
// and the weights as hi and lo planes).  Scratch: xt (P, n, 128) bf16, hth
// (layers-1, P, n, F) bf16, azbtz (layers, P, n, F) bf16 with P = 2
// planes, [x | h | a_z] and [t | th | b_tz] (split: P = 4, the hi planes,
// then the lo ones), part (n/64, layers+1, F) f32, pbs (n/64,) f32, tzsc
// (n_blocks, layers, 64 * F) f32, wpart (wpart_tiles, 128 * min(F, 256))
// f32, the weight-gradient blocks' partial tiles (ops/fused_trunk_vjp.
// wgrad_tiles times the splits from wgrad_splits, whose K axis is three
// times as long with split).  Outputs f32 in (in, out) layout: dw0
// (128, F), db0 (F,), dwm (layers-2, F, F), dbm (layers-2, F), dwst
// (128, F), dwsb (F, F), dbs (F,), dwsig (F,), dbsig (1,).
// Three kernels on the stream; returns a cudaError_t.
extern "C" int trunk_bwd_launch(
    const float* x, const float* cs, const void* cf, int cf_bf16,
    const float* cg, const void* zs, const void* us, int n_rows,
    int n_blocks, const void* w0, const void* wmid, const void* wskip,
    const float* wsig, const float* bsig, void* xt, void* hth, void* azbtz,
    float* part, float* pbs, float* tzsc, float* wpart, int splits,
    int wpart_tiles, float* dw0, float* db0, float* dwm, float* dbm,
    float* dwst, float* dwsb, float* dbs, float* dwsig, float* dbsig,
    int zs_f32, int split, int layers, int skip, void* stream) {
  BwdArgs p = {};
  p.x = x;
  p.cs = cs;
  p.cf = cf;
  p.cf_bf16 = cf_bf16;
  p.cg = cg;
  if (zs_f32) {
    p.zsf = static_cast<const float*>(zs);
    p.usf = static_cast<const float*>(us);
  } else {
    p.zs = static_cast<const bf16*>(zs);
    p.us = static_cast<const bf16*>(us);
  }
  p.split = split;
  p.n = n_rows;
  p.n_tiles = n_rows / T;
  p.w0 = static_cast<const bf16*>(w0);
  p.wmid = static_cast<const bf16*>(wmid);
  p.wskip = static_cast<const bf16*>(wskip);
  p.wsig = wsig;
  p.bsig = bsig;
  p.xt = static_cast<bf16*>(xt);
  p.hth = static_cast<bf16*>(hth);
  p.azbtz = static_cast<bf16*>(azbtz);
  p.part = part;
  p.pbs = pbs;
  p.tzsc = tzsc;
  p.wpart = wpart;
  p.splits_trunk = splits;
  p.wpart_tiles = wpart_tiles;
  p.dw0 = dw0;
  p.db0 = db0;
  p.dwm = dwm;
  p.dbm = dbm;
  p.dwst = dwst;
  p.dwsb = dwsb;
  p.dbs = dbs;
  p.dwsig = dwsig;
  p.dbsig = dbsig;
  p.layers = layers;
  p.skip = skip;
  return launch_bwd<false>(p, n_blocks, stream);
}
