// Kernel K5: the backward of K4 for the training step.  With cotangents of
// the packed logits (c_sigma in column 0, the rgb, k, theta, rho_c logits'
// in columns 1..6) and c_g of the gradient output, it returns K3's trunk
// grads and the grads of the flagship head block: dW_f, db_f, dW_1r, db_1r,
// dW_2r, db_2r, dW_1p, db_1p, dW_2p, db_2p.
//
// Replaces: brdfnerf_tpu/ops/pallas_trunk_heads.py::_bwd_kernel_h
// (pallas_call at pallas_trunk_heads.py:416).
//
// What bounds it: tensor-core operations.  At width 512 a point costs K3's
// 15,051,776 FLOP plus 4,727,808 for the heads (their recompute from zs,
// the a_xf and a_h products, and the outer products of dW_f and dW_1) and
// 3,670,016 for the rebuilt b_th chain, 23.4 MFLOP in all, against about
// 10 KB of input: 3.1 ms at 131,072 points (tools/width_check.trunk_work
// counts every width).  What holds it back on the card is K3's memory
// traffic (trunk_bwd.cuh) plus ~14 KB a point of the heads' operands and
// 16 KB of the f32 b_th chain through device memory.
//
// Design (trunk_bwd.cuh): K3's sweep, weight-gradient and reduce kernels.
// Between the sigma head and the reverse sweep, the sweep recomputes the
// head block from h_{L-1} (xf, then the first head layers in four
// HID-column passes, HID = F / 2, all on K3's wgmma path and weight ring),
// writes c_z1 = act'(z1) (c_z2 W_2) of each pass to global memory by TMA
// stores from its swizzled tile (at width 64, whose 32-column heads are
// narrower than a TMA box, by plain stores), with the per-tile column sums
// of db_1 and dW_2 (the second layers have 3 output columns, so their
// weight grads are column sums too), reloads c_z1 one 64 x HID chunk at a
// time by TMA as the A operand of a_xf = sum c_z1 W_1 (the tile of the
// encoding's tangent, idle by then, grows to hold the chunk), and seeds
// the trunk's a_h with a_xf W_f in place of K3's c_feats.  The
// weight-gradient kernel takes dW_f = h^T a_xf and [dW_1r | dW_1p] = xf^T
// [c_z1r | c_z1p] with K = points, in 128 x min(F, 256) tiles of their own
// (24 at width 512, 3 at 64, whose second 64 rows are masked), in their
// own number of slices.  No atomics: the result is deterministic.
//
// The b_th chain: the Pallas kernel rebuilds it in f32 from w_sigma and the
// saved zs, and so does K5, in a fourth kernel launched before the sweep:
// b_th_{L-1} = bf16(sigmoid(zsig)) w_sigma with zsig from h_{L-1} =
// act(z_{L-1}), then b_th_{l-1} = bf16(act'(z_l) b_th_l) W_l, the reverse
// products of K2's chain on the same ring and wgmma path (a persistent grid
// of 64-point tiles; z of each layer through the ring in 64 x 64 boxes).
// It writes b_th of every layer in f32, in the layout of the sweep's tz
// scratch (uc: element j, e of consumer thread c of layer l of tile t at
// ((t L + l) F / 4 + 4 j + e) 256 + c), and the sweep reads it through its
// ring where K3 reads K2's bf16 us (with f32 zs, ZF32, each thread reads
// its own elements of it from device memory).  The forward's u chain is no substitute:
// it runs on f32 z where this one runs on the bf16 zs (the Pallas
// _bwd_kernel_h's arithmetic), and at the flagship size the two differ by
// ~7e-3 relative (tools/uchain_gap.py).
//
// At compute_dtype float32 (split) every product of f32 operands runs as
// three on their bf16 hi and lo terms (sm90_trunk.cuh consume_s): the
// trunk's and the heads' W_f, W_1r, W_1p as hi and lo planes, W_2 in f32,
// the heads' weight-gradient operands (h, xf, a_xf, c_z1) as hi and lo
// planes, nothing rounded to bf16.  The sweep then keeps K3's 64 x 128 t
// tile and takes the c_z1 chunks 128 columns at most (in halves at width
// 512: trunk_bwd.cuh head_kh); the chain kernel holds b_tz as hi and lo
// tiles beside a two-stage ring.

#include "trunk_bwd.cuh"

namespace trunk {

// shared memory of the chain kernel: the activation tile (b_tz, the A
// operand of b_th = b_tz W; SPLIT: its lo tile after it), the ring (SPLIT:
// two stages), barriers, per-row vectors
template <bool SPLIT>
__host__ __device__ constexpr int uc_lo() {
  return SPLIT ? FA * ACT_BLOCK : 0;
}
template <bool SPLIT>
__host__ __device__ constexpr int uc_ring_n() {
  return SPLIT ? 2 : RING_N;
}
template <bool SPLIT>
__host__ __device__ constexpr int uc_ring() {
  return FA * ACT_BLOCK + uc_lo<SPLIT>();
}
template <bool SPLIT>
__host__ __device__ constexpr int uc_rows() {
  return uc_ring<SPLIT>() + uc_ring_n<SPLIT>() * RING_STAGE + 128;
}
template <bool SPLIT>
__host__ __device__ constexpr int uc_smem() {
  return uc_rows<SPLIT>() + 3 * T * 4;
}
static_assert(uc_smem<true>() <= 232448, "the SPLIT chain's shared memory");

// ZF32: zs in f32 (the mixed bfloat16 and float32 contracts), read from
// device memory instead of through the ring.  SPLIT (float32): the
// products of f32 operands as three, sigmoid(zsig) and h unrounded.
template <bool ZF32, bool SPLIT>
__global__ void __launch_bounds__(NTB, 1)
    trunk_heads_uchain_kernel(const __grid_constant__ SweepMaps maps,
                              const BwdArgs p, float* __restrict__ uc) {
  static_assert(!SPLIT || ZF32, "the split chain reads f32 zs");
  constexpr int NS = uc_ring_n<SPLIT>();
  constexpr int LO = uc_lo<SPLIT>();
  typedef RingN<NS> R;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* act = smem;
  unsigned char* ring = smem + uc_ring<SPLIT>();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * RING_STAGE);
  uint64_t* empty = full + NS;
  float* rz = reinterpret_cast<float*>(smem + uc_rows<SPLIT>());  // [2][64]
  float* rowv = rz + 2 * T;                  // bf16(sigmoid(zsig))
  const int layers = p.layers, skip = p.skip, last = layers - 1;
  const int tid = threadIdx.x;
  // SPLIT: rows from a weight's hi plane to its lo plane
  const int lo_f = F, lo_mid = (layers - 2) * F;
  auto rnd = [](float v) { return SPLIT ? v : bf16_round(v); };

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);     // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NC) {
    // ------------------------------------------------------- producer
    sm90::setmaxnreg_dec<40>();
    if (tid != NC) return;
    R r = {0, 0};
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const int row0 = tile * T;
      if (!ZF32) produce_fwd_data(maps, last, row0, r, full, empty, ring);
      for (int i = last; i >= 1; --i) {
        if (i == skip)
          produce_s<SPLIT>(&maps.wskipm, true, F / KSL, 0, EP, F, lo_f, r,
                           full, empty, ring);
        else
          produce_s<SPLIT>(&maps.wmidm, true, F / KSL,
                           (i < skip ? i - 1 : i - 2) * F, 0, F, lo_mid, r,
                           full, empty, ring);
        if (!ZF32 && i > 1)
          produce_fwd_data(maps, i - 1, row0, r, full, empty, ring);
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  sm90::setmaxnreg_inc<232>();
  const int wg = tid >> 7, t = tid & 127, w = t >> 5, l = t & 31;
  const bool leader = l == 0;
  const int r0 = w * 16 + (l >> 2);          // rows r0 and r0 + 8
  const int cb = wg * NWG + 2 * (l & 3);     // column of j = 0, e = 0
  const float* __restrict__ wsig = p.wsig;
  R r = {0, 0};
  float acc[NWG / 2];

  // z of accumulators 4j..4j+3 (rows r0 and r0 + 8) of layer i from the
  // ring stage that holds them: JPS j-groups a stage, both warpgroups'
  // 64 x 64 blocks side by side, or at width 64 one block for both
  // (produce_fwd_data, trunk_bwd.cuh); ZF32: from zsf
  const size_t lf = (size_t)layers * F;
  size_t zrow = 0;                           // ZF32: the tile's rows r0
  auto z_of = [&](int j, int i) {
    float2 za, zb;
    if constexpr (ZF32) {
      const float* zp = p.zsf + zrow + (size_t)i * F + cb + 8 * j;
      za = glob_f2(zp);
      zb = glob_f2(zp + 8 * lf);
    } else {
      const unsigned char* zb4 = ring + r.stage * RING_STAGE +
                                 ((j / JJ) % JPS) * ZB * ACT_BLOCK +
                                 zb_of(wg) * ACT_BLOCK;
      const int cz = zc_of(wg) + 8 * (j % JJ) + 2 * (l & 3);
      za = stage_bf2(zb4 + sm90::sw128_offset(r0, cz, 0));
      zb = stage_bf2(zb4 + sm90::sw128_offset(r0 + 8, cz, 0));
    }
    return make_float4(za.x, za.y, zb.x, zb.y);
  };
  // accumulators 4j..4j+3 into the tile as bf16 (SPLIT: hi and lo)
  auto put4 = [&](int j) {
    const int col = cb + 8 * j;
    put2_s<SPLIT, LO>(act, r0, col, acc[4 * j], acc[4 * j + 1]);
    put2_s<SPLIT, LO>(act, r0 + 8, col, acc[4 * j + 2], acc[4 * j + 3]);
  };

  // a stage of z holds JPS j-groups of JJ j each
  constexpr int JS = JPS * JJ;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    float* out = uc + (size_t)tile * layers * (NWG / 2) * NC + tid;
    zrow = ((size_t)tile * T + r0) * lf;
    // ------- zsig from h_{L-1} = act(z_{L-1}), as the sweep computes it;
    // act'(z_{L-1}) into acc
    float pz[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NWG / 8; ++j) {
      if (!ZF32 && j % JS == 0) sm90::mbar_wait(&full[r.stage], r.phase);
      const float4 z4 = z_of(j, last);
      const float zz[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float h;
        act_eval(zz[e], 1.f, h, acc[4 * j + e]);
        pz[e >> 1] += rnd(h) * wsig[cb + 8 * j + (e & 1)];
      }
      if (!ZF32 && j % JS == JS - 1) {
        release(empty, r.stage);
        r.advance();
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = pz[hf];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((l & 3) == 0) rz[wg * T + r0 + 8 * hf] = v;
    }
    sm90::named_sync(BAR_C, NC);     // rz; the last product read act
    if (tid < T) {
      const float zsig = (rz[tid] + rz[T + tid]) + p.bsig[0];
      rowv[tid] = rnd(1.f / (1.f + expf(-zsig)));
    }
    sm90::named_sync(BAR_C, NC);
    // ------- b_th_{L-1} = bf16(sigmoid(zsig)) w_sigma; b_tz = act' b_th
    {
      float* o = out + (size_t)last * (NWG / 2) * NC;
      const float s0 = rowv[r0], s1 = rowv[r0 + 8];
#pragma unroll
      for (int j = 0; j < NWG / 8; ++j) {
        const float2 ws = *reinterpret_cast<const float2*>(wsig + cb + 8 * j);
        const float bt[4] = {s0 * ws.x, s0 * ws.y, s1 * ws.x, s1 * ws.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          __stcs(o + (4 * j + e) * NC, bt[e]);
          acc[4 * j + e] *= bt[e];
        }
        put4(j);
      }
    }
    sm90::fence_async_smem();
    sm90::named_sync(BAR_C, NC);     // b_tz is the next product's A
    // --------------------- b_th_{i-1} = b_tz_i W_i, i = L-1 down to 1
    for (int i = last; i >= 1; --i) {
      consume_s<NWG, 1, SPLIT, LO>(acc, act, F, act, F / KSL, false, r, full,
                                   empty, ring, wg, leader);
      float* o = out + (size_t)(i - 1) * (NWG / 2) * NC;
#pragma unroll
      for (int k = 0; k < NWG / 2; ++k) __stcs(o + k * NC, acc[k]);
      if (i == 1) break;
      sm90::named_sync(BAR_C, NC);   // both products read act
      // b_tz_{i-1} = act'(z_{i-1}) b_th_{i-1}, z from the ring
#pragma unroll
      for (int j = 0; j < NWG / 8; ++j) {
        if (!ZF32 && j % JS == 0) sm90::mbar_wait(&full[r.stage], r.phase);
        const float4 z4 = z_of(j, i - 1);
        const float zz[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float h, d;
          act_eval(zz[e], 1.f, h, d);
          acc[4 * j + e] *= d;
        }
        put4(j);
        if (!ZF32 && j % JS == JS - 1) {
          release(empty, r.stage);
          r.advance();
        }
      }
      sm90::fence_async_smem();
      sm90::named_sync(BAR_C, NC);
    }
  }
}

}  // namespace trunk

using namespace trunk;

// x, cg (n_rows, 128) f32, cot (n_rows, 8) f32, zs (n_rows, layers * F),
// f32 when zs_f32 (the mixed bfloat16 contract) else bf16, with
// n_rows % 64 == 0; trunk weights as trunk_bwd_launch, heads as
// trunk_heads_fwd_launch (split: the float32 instantiation, f32 zs, the
// weights as hi and lo planes, w2r and w2p f32), all at the library's
// width F, HID = F / 2.  Scratch: uc (n_rows * layers * F f32, the rebuilt
// b_th chain), K3's (part (n/64, (layers+1) * F + HEAD_PART) f32,
// wpart_tiles partial tiles in wpart: ops/fused_trunk_vjp.wgrad_tiles
// with the heads, times splits_trunk and splits_heads), then hl, xfb, axf
// (P, n, F) and cz1 (P, n, 4 HID) bf16, P = 1 plane (split: 2, hi then
// lo).  Outputs f32 in (in, out) layout: K3's, then dwf (F, F), dbf (F,),
// dw1 (F, 4 HID) = [dW_1r | dW_1p], db1 (4 HID,), dw2r (HID, 128), db2r
// (128,), dw2p (3 HID, 128), db2p (128,), whose columns >= 3 the kernels
// leave as they find them.  Four kernels on the stream (the
// b_th chain, then K3's three); returns a cudaError_t.
extern "C" int trunk_heads_bwd_launch(
    const float* x, const float* cot, const float* cg, const void* zs,
    float* uc, int n_rows, int n_blocks, const void* w0,
    const void* wmid, const void* wskip, const float* wsig,
    const float* bsig, const void* wf, const float* bf, const void* w1r,
    const float* b1r, const void* w2r, const void* w1p, const float* b1p,
    const void* w2p, void* xt, void* hth, void* azbtz, float* part,
    float* pbs, float* tzsc, float* wpart, int splits_trunk,
    int splits_heads, int wpart_tiles, void* hl, void* xfb, void* axf,
    void* cz1, float* dw0, float* db0, float* dwm, float* dbm, float* dwst,
    float* dwsb, float* dbs, float* dwsig, float* dbsig, float* dwf,
    float* dbf, float* dw1, float* db1, float* dw2r, float* db2r,
    float* dw2p, float* db2p, int zs_f32, int split, int layers, int skip,
    void* stream) {
  BwdArgs p = {};
  p.x = x;
  p.cot = cot;
  p.cg = cg;
  if (zs_f32)
    p.zsf = static_cast<const float*>(zs);
  else
    p.zs = static_cast<const bf16*>(zs);
  p.uc = uc;
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
  p.w2r = w2r;
  p.w1p = static_cast<const bf16*>(w1p);
  p.b1p = b1p;
  p.w2p = w2p;
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
  p.split = split;
  p.layers = layers;
  p.skip = skip;
  if (n_rows <= 0 || n_rows % T != 0 || n_blocks <= 0 || layers < 3 ||
      skip <= 0 || skip >= layers || (split && !zs_f32))
    return (int)cudaErrorInvalidValue;
  SweepMaps maps;
  if (!sweep_maps<true>(p, &maps)) return (int)cudaErrorInvalidValue;
  auto uchain = split    ? trunk_heads_uchain_kernel<true, true>
                : zs_f32 ? trunk_heads_uchain_kernel<true, false>
                         : trunk_heads_uchain_kernel<false, false>;
  const int smem = split ? uc_smem<true>() : uc_smem<false>();
  cudaError_t e = cudaFuncSetAttribute(
      uchain, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  uchain<<<n_blocks, NTB, smem, static_cast<cudaStream_t>(stream)>>>(
      maps, p, uc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_bwd<true>(p, n_blocks, stream);
}
