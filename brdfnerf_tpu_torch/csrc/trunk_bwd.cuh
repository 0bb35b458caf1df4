// The kernels shared by K3 (trunk_bwd.cu: the trunk's hand-derived
// second-order backward) and K5 (trunk_heads_bwd.cu: the same, seeded by the
// first-order backward of the flagship head block).
//
// Math (ops/fused_trunk_vjp.py): a tangent forward seeded by t = c_g gives
// tz_l = th_{l-1} W_l^T and th_l = act'(z_l) tz_l; the reverse sweep then
// runs the first-order recurrence over the (primal, tangent) pairs,
//     a_z = act'(z) a_h + act''(z) tz b_th,  b_tz = act'(z) b_th,
//     dW_l = h_{l-1}^T a_z + th_{l-1}^T b_tz,  db_l = sum_rows a_z,
//     a_h <- a_z W_l,
// with z_l and b_th_l = u_l loaded from what the forward saved (zs, us).
// K3 seeds the last layer's a_h with c_feats; K5 with a_xf W_f, from the
// heads' backward (ops/fused_trunk_heads.py):
//     c_z1 = act'(z1) (c_z2 W_2),   a_xf = c_z1r W_1r + c_z1p W_1p,
//     dW_2 = h1^T c_z2,  dW_1 = xf^T c_z1,  dW_f = h_{L-1}^T a_xf.
//
// Design.  On the TPU the grid runs in order and carries dW in VMEM from one
// tile to the next.  Here blocks run in parallel and one set of weight grads
// (8.5 MB of f32 for the trunk, 4.1 MB more for the heads) fits in no block,
// so the work is two kernels, both deterministic (a fixed summation order,
// no atomics):
//   1. sweep: a persistent grid of blocks of 8 warps, one 64-point tile at a
//      time, as K2 (trunk_common.cuh): the tangent forward and the a chain on
//      the tensor cores, with the tile's tz_l kept in a per-block f32 scratch.
//      It writes the bf16 operands of every weight-gradient product (the
//      Pallas _outer rounds exactly these to bf16, so nothing is lost),
//      per-tile column sums in f32 (the biases, and for K5 the heads'
//      3-column second layers), and the sigma head's per-tile grads.
//   2. wgrad: one block per 128 x 128 tile of every dW (120 tiles at 8 x 512,
//      48 more for K5's dW_f and dW_1), walking all points in order:
//      dW = [h; th]^T [a_z; b_tz] with K = 2 x points (K = points for the
//      heads); both operands are read point-major and transposed by
//      ldmatrix.trans.  Further blocks sum the per-tile partials over the
//      tiles, in tile order.
// Rows beyond the caller's points carry zero cotangents and add exactly 0.

#pragma once

#include "trunk_common.cuh"

namespace trunk {

// per-tile partials of K5's heads, after K3's (layers + 1) x 512: db_f,
// db_1 (rgb | rpv), dW_2 for the 3 logit columns over the 4 x 256 hidden
// units of [rgb | k | theta | rho_c], db_2 (6, padded to 8)
constexpr int HP_DBF = 0;
constexpr int HP_DB1 = HP_DBF + F;
constexpr int HP_DW2 = HP_DB1 + 4 * HID;
constexpr int HP_DB2 = HP_DW2 + 3 * 4 * HID;
constexpr int HEAD_PART = HP_DB2 + 8;

struct BwdArgs {
  const float* x;
  const float* cs;         // K3: c_sigma
  const void* cf;          // K3: c_feats
  int cf_bf16;
  const float* cot;        // K5: the packed logits' cotangents (n, 8)
  const float* cg;
  const bf16* zs;
  const bf16* us;
  int n, n_tiles;
  const bf16* w0;
  const bf16* wmid;
  const bf16* wskip;
  const float* wsig;
  const float* bsig;
  // K5: the heads, packed as in ops/fused_trunk_heads.pack_head_weights
  const bf16* wf;
  const float* bf;
  const bf16* w1r;
  const float* b1r;
  const bf16* w2r;
  const bf16* w1p;
  const float* b1p;
  const bf16* w2p;
  // scratch
  bf16* xt;
  bf16* hth;
  bf16* azbtz;
  float* part;
  float* pbs;
  float* tzsc;
  bf16* hl;                // K5: h_{L-1}, xf, a_xf (n, 512), c_z1 (n, 1024)
  bf16* xfb;
  bf16* axf;
  bf16* cz1;
  // outputs, f32, (in, out) layout
  float *dw0, *db0, *dwm, *dbm, *dwst, *dwsb, *dbs, *dwsig, *dbsig;
  float *dwf, *dbf, *dw1, *db1, *dw2r, *db2r, *dw2p, *db2p;
  int layers, skip;
};

// h, act' and act'' of the polynomial sine (the JAX package's
// pallas_trunk_vjp._act_all with want_d2, same expression order).
__device__ __forceinline__ void act_eval2(float z, float w0, float& h,
                                          float& d1, float& d2) {
  const float x = w0 * z;
#ifdef TRUNK_IDENTITY_ACT
  h = x;
  d1 = w0;
  d2 = 0.f;
#else
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

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Sum a column partial over the tile's 64 rows (the lanes sharing a column
// differ in lane bits 2..4); lanes 0..3 get the sums.
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// shared memory of the K3 sweep: K2's carve-up plus a second row vector
constexpr int OFF_ROW2 = SMEM_BYTES;
constexpr int SMEM_SWEEP = OFF_ROW2 + T * 4;
// of the K5 sweep: the tile of the encoding's tangent grows into a 64 x 256
// tile of c_z1 (the A operand of a_xf), and the tile's logit cotangents
constexpr int SC = HID + 8;
constexpr int OFFH_W = OFF_X + T * SC * 2;
constexpr int OFFH_RED = OFFH_W + NSTAGE * STAGE * 2;
constexpr int OFFH_ROW = OFFH_RED + 8 * T * 4;
constexpr int OFFH_ROW2 = OFFH_ROW + T * 4;
constexpr int OFFH_COT = OFFH_ROW2 + T * 4;
constexpr int SMEM_SWEEP_H = OFFH_COT + T * HEAD_COLS * 4;

// ------------------------------------------------------------------ sweep
//
// Scratch written (n = rows, F = 512, L = layers):
//   xt    (2, n, 128)      bf16  x, then t = c_g
//   hth   (L-1, 2, n, F)   bf16  slot l-1: h_{l-1}, then th_{l-1} (layer l)
//   azbtz (L, 2, n, F)     bf16  slot l: a_z_l, then b_tz_l
//   part  (tiles, W)       f32   per tile: column sums of a_z_l (l < L),
//                                 the sigma head's dW, then (K5) the heads'
//                                 partials; W = (L+1) F [+ HEAD_PART]
//   pbs   (tiles,)         f32   per tile: the sigma head's db
//   tzsc  (blocks, L, 64 x 512) f32: the block's tz_l, per-thread layout
//   K5: hl, xfb, axf (n, F) and cz1 (n, 4 x 256) bf16
// The pointers are the kernel's own __restrict__ parameters (and not a
// BwdArgs, as for the other kernels): with them the compiler may move the
// loads of zs, us and the tz scratch past the stores of the sweep.
template <bool HEADS>
__global__ void __launch_bounds__(NT, 1) trunk_bwd_sweep_kernel(
    const float* __restrict__ x, const float* __restrict__ cs,
    const void* __restrict__ cf, int cf_bf16, const float* __restrict__ cot,
    const float* __restrict__ cg, const bf16* __restrict__ zs,
    const bf16* __restrict__ us, int n, int n_tiles,
    const bf16* __restrict__ w0, const bf16* __restrict__ wmid,
    const bf16* __restrict__ wskip, const float* __restrict__ wsig,
    const float* __restrict__ bsig, const bf16* __restrict__ wf,
    const float* __restrict__ bf, const bf16* __restrict__ w1r,
    const float* __restrict__ b1r, const bf16* __restrict__ w2r,
    const bf16* __restrict__ w1p, const float* __restrict__ b1p,
    const bf16* __restrict__ w2p, bf16* __restrict__ xt,
    bf16* __restrict__ hth, bf16* __restrict__ azbtz,
    float* __restrict__ part, float* __restrict__ pbs,
    float* __restrict__ tzsc, bf16* __restrict__ hl, bf16* __restrict__ xfb,
    bf16* __restrict__ axf, bf16* cz1, int layers, int skip) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem + OFF_ACT);
  bf16* ts = reinterpret_cast<bf16*>(smem + OFF_X);
  bf16* chunk = ts;   // K5, once the tangent forward is done
  bf16* stage = reinterpret_cast<bf16*>(smem + (HEADS ? OFFH_W : OFF_W));
  float* red = reinterpret_cast<float*>(smem + (HEADS ? OFFH_RED : OFF_RED));
  float* row_a = reinterpret_cast<float*>(smem + (HEADS ? OFFH_ROW : OFF_ROW));
  float* row_b =
      reinterpret_cast<float*>(smem + (HEADS ? OFFH_ROW2 : OFF_ROW2));
  float* rowc = reinterpret_cast<float*>(smem + OFFH_COT);   // K5 only
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int last = layers - 1;
  const size_t ld = (size_t)layers * F;
  const size_t nF = (size_t)n * F;
  const int row_w = (layers + 1) * F + (HEADS ? HEAD_PART : 0);
  float* tzb = tzsc + (size_t)blockIdx.x * layers * ACC * NT + tid;
  // the last layer's h (K3) or th (K5), bf16, staged in the (idle) weight
  // ring
  bf16* ring_tile = stage;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * T;
    load_x_tile(cg + row0 * EP, ts);
    for (int i = tid; i < T * EP / 4; i += NT) {
      const float4 a = reinterpret_cast<const float4*>(x + row0 * EP)[i];
      const float4 b = reinterpret_cast<const float4*>(cg + row0 * EP)[i];
      __nv_bfloat162* xa =
          reinterpret_cast<__nv_bfloat162*>(xt + row0 * EP) + 2 * i;
      __nv_bfloat162* xb = reinterpret_cast<__nv_bfloat162*>(
                               xt + (size_t)n * EP + row0 * EP) + 2 * i;
      xa[0] = __floats2bfloat162_rn(a.x, a.y);
      xa[1] = __floats2bfloat162_rn(a.z, a.w);
      xb[0] = __floats2bfloat162_rn(b.x, b.y);
      xb[1] = __floats2bfloat162_rn(b.z, b.w);
    }
    if (HEADS)
      for (int i = tid; i < T * HEAD_COLS; i += NT)
        rowc[i] = cot[row0 * HEAD_COLS + i];
    float acc[MT][8][4];

    // ------------------------------------------- tangent forward, t = c_g
    float pz[MT][2], pt[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) pz[mt][0] = pz[mt][1] = pt[mt][0] =
        pt[mt][1] = 0.f;
    for (int i = 0; i < layers; ++i) {
      forward_layer(acc, i, skip, ts, act, w0, wmid, wskip, stage);
      const float w0s = i == 0 ? 30.f : 1.f;
      float* tzl = tzb + (size_t)i * ACC * NT;
      bf16* hd = hth + (size_t)(2 * i) * nF + row0 * F;      // layer i+1
      bf16* thd = hd + nF;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nf = 0; nf < 8; ++nf)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            int row, col;
            acc_pos<8>(mt, nf, 2 * hf, row, col);
            const float2 z = ld_bf2(zs + (row0 + row) * ld + (size_t)i * F +
                                    col);
            float h0, h1, d0, d1;
            act_eval(z.x, w0s, h0, d0);
            act_eval(z.y, w0s, h1, d1);
            const float tz0 = acc[mt][nf][2 * hf];
            const float tz1 = acc[mt][nf][2 * hf + 1];
            const float th0 = d0 * tz0, th1 = d1 * tz1;
            const int j = (mt * 8 + nf) * 4 + 2 * hf;
            tzl[j * NT] = tz0;
            tzl[(j + 1) * NT] = tz1;
            if (i < last) {
              st_bf2(act + row * SA + col, th0, th1);
              st_bf2(hd + row * F + col, h0, h1);
              st_bf2(thd + row * F + col, th0, th1);
            } else {
              if (HEADS) {
                // h stays in the tile for the head products
                st_bf2(act + row * SA + col, h0, h1);
                st_bf2(ring_tile + row * SA + col, th0, th1);
                st_bf2(hl + (row0 + row) * F + col, h0, h1);
              } else {
                st_bf2(act + row * SA + col, th0, th1);
                st_bf2(ring_tile + row * SA + col, h0, h1);
              }
              pz[mt][hf] += bf16_round(h0) * wsig[col] +
                            bf16_round(h1) * wsig[col + 1];
              pt[mt][hf] += bf16_round(th0) * wsig[col] +
                            bf16_round(th1) * wsig[col + 1];
            }
          }
    }

    // ------------------------------------------------------- sigma head
    // zsig = h . wsig + b, tzsig = th . wsig; a = cs sp' + sp'' tzsig on
    // zsig, b = sp' on tzsig
    const float s_z = sigma_rows(pz, red);
    __syncthreads();
    const float s_t = sigma_rows(pt, red);
    if (tid < T) {
      const float zsig = s_z + bsig[0];
      const float sp1 = 1.f / (1.f + expf(-zsig));
      const float sp2 = sp1 * (1.f - sp1);
      const float c_s = HEADS ? rowc[tid * HEAD_COLS] : cs[row0 + tid];
      row_a[tid] = c_s * sp1 + sp2 * s_t;
      row_b[tid] = sp1;
    }
    __syncthreads();
    float* pt_tile = part + (size_t)tile * row_w;
    if (tid == 0) {
      float s = 0.f;
      for (int r = 0; r < T; ++r) s += row_a[r];
      pbs[tile] = s;
    }
    {
      const bf16* hsrc = HEADS ? act : ring_tile;
      const bf16* tsrc = HEADS ? ring_tile : act;
      for (int c = tid; c < F; c += NT) {
        float sh = 0.f, st = 0.f;
        for (int r = 0; r < T; ++r) {
          sh += __bfloat162float(hsrc[r * SA + c]) * bf16_round(row_a[r]);
          st += __bfloat162float(tsrc[r * SA + c]) * bf16_round(row_b[r]);
        }
        pt_tile[(size_t)layers * F + c] = sh + st;
      }
    }
    __syncthreads();

    if constexpr (HEADS) {
      float* hp_tile = pt_tile + (size_t)(layers + 1) * F;
      bf16* xfd = xfb + row0 * F;
      bf16* czd = cz1 + row0 * 4 * HID;
      // ---------------------------------------- xf = h W_f^T + b_f
      zero<8>(acc);
      gemm<8, false>(acc, act, SA, F, nullptr, 0, 0, wf, F, 0, stage);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nf = 0; nf < 8; ++nf)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            int row, col;
            acc_pos<8>(mt, nf, 2 * hf, row, col);
            const float v0 = acc[mt][nf][2 * hf] + bf[col];
            const float v1 = acc[mt][nf][2 * hf + 1] + bf[col + 1];
            st_bf2(act + row * SA + col, v0, v1);
            st_bf2(xfd + row * F + col, v0, v1);
          }

      // ---- the first head layers in 256-column passes (q = 0: rgb,
      // 1..3: k, theta, rho_c): c_z1 = act'(z1) (c_z2 W_2) to global, with
      // its column sums (db_1) and the dW_2 partials h1^T c_z2
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        const bf16* w1 = q == 0 ? w1r : w1p;
        const float* b1 = q == 0 ? b1r : b1p + (q - 1) * HID;
        const int cb = q == 0 ? 1 : 4;          // first c_z2 column of q
        float a[MT][4][4];
        zero<4>(a);
        gemm<4, false>(a, act, SA, F, nullptr, 0, 0, w1, F,
                       q == 0 ? 0 : (q - 1) * HID, stage);
        float csum[4][2], w2s[3][4][2];
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            csum[nf][e] = 0.f;
#pragma unroll
            for (int c = 0; c < 3; ++c) w2s[c][nf][e] = 0.f;
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nf = 0; nf < 4; ++nf)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              int row, col;
              acc_pos<4>(mt, nf, 2 * hf, row, col);
              const int k = q * HID + col;      // hidden unit of 1,024
              float h[2], d[2];
              act_eval(a[mt][nf][2 * hf] + b1[col], 1.f, h[0], d[0]);
              act_eval(a[mt][nf][2 * hf + 1] + b1[col + 1], 1.f, h[1], d[1]);
              float cc[3];
#pragma unroll
              for (int c = 0; c < 3; ++c)
                cc[c] = bf16_round(rowc[row * HEAD_COLS + cb + c]);
              float cz[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float s;
                if (q == 0)
                  s = cc[0] * __bfloat162float(w2r[col + e]) +
                      cc[1] * __bfloat162float(w2r[HID + col + e]) +
                      cc[2] * __bfloat162float(w2r[2 * HID + col + e]);
                else   // w2p row q-1, column k - HID of the merged 768
                  s = cc[q - 1] * __bfloat162float(
                                      w2p[(q - 1) * 3 * HID + k - HID + e]);
                cz[e] = d[e] * s;
                csum[nf][e] += cz[e];
                const float hb = bf16_round(h[e]);
#pragma unroll
                for (int c = 0; c < 3; ++c) w2s[c][nf][e] += hb * cc[c];
              }
              st_bf2(czd + (size_t)row * 4 * HID + k, cz[0], cz[1]);
            }
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = q * HID + warp * 32 + nf * 8 + lane * 2 + e;
            const float v = col_sum(csum[nf][e]);
            float w[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) w[c] = col_sum(w2s[c][nf][e]);
            if (lane < 4) {
              hp_tile[HP_DB1 + k] = v;
#pragma unroll
              for (int c = 0; c < 3; ++c)
                hp_tile[HP_DW2 + c * 4 * HID + k] = w[c];
            }
          }
      }
      if (tid < 8) {
        float s = 0.f;
        if (tid < 6)
          for (int r = 0; r < T; ++r) s += rowc[r * HEAD_COLS + 1 + tid];
        hp_tile[HP_DB2 + tid] = s;
      }
      __syncthreads();   // c_z1 of the tile is in global memory

      // ------------- a_xf = sum_q c_z1_q W_1q, one 64 x 256 chunk at a time
      zero<8>(acc);
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        for (int s = tid; s < T * HID / 8; s += NT) {
          const int r = s / (HID / 8), c8 = (s % (HID / 8)) * 8;
          *reinterpret_cast<uint4*>(chunk + r * SC + c8) =
              *reinterpret_cast<const uint4*>(czd + (size_t)r * 4 * HID +
                                              q * HID + c8);
        }
        const bf16* w1 =
            q == 0 ? w1r : w1p + (size_t)(q - 1) * HID * F;
        gemm<8, true>(acc, chunk, SC, HID, nullptr, 0, 0, w1, F, 0, stage);
      }
      {
        bf16* axd = axf + row0 * F;
        float csum[8][2];
#pragma unroll
        for (int nf = 0; nf < 8; ++nf) csum[nf][0] = csum[nf][1] = 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nf = 0; nf < 8; ++nf)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              int row, col;
              acc_pos<8>(mt, nf, 2 * hf, row, col);
              const float v0 = acc[mt][nf][2 * hf];
              const float v1 = acc[mt][nf][2 * hf + 1];
              csum[nf][0] += v0;
              csum[nf][1] += v1;
              st_bf2(act + row * SA + col, v0, v1);
              st_bf2(axd + row * F + col, v0, v1);
            }
#pragma unroll
        for (int nf = 0; nf < 8; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = col_sum(csum[nf][e]);
            if (lane < 4)
              hp_tile[HP_DBF + warp * 64 + nf * 8 + lane * 2 + e] = v;
          }
      }
      // ------------------------------------ a_h from the heads: a_xf W_f
      zero<8>(acc);
      gemm<8, true>(acc, act, SA, F, nullptr, 0, 0, wf, F, 0, stage);
    }

    // a_h of the last layer: a . wsig + c_feats (K3), + a_xf W_f (K5)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nf = 0; nf < 8; ++nf)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          int row, col;
          acc_pos<8>(mt, nf, 2 * hf, row, col);
          const float a = bf16_round(row_a[row]);
          float2 f;
          if (HEADS) {
            f = make_float2(acc[mt][nf][2 * hf], acc[mt][nf][2 * hf + 1]);
          } else {
            const size_t o = (row0 + row) * F + col;
            if (cf_bf16)
              f = ld_bf2(static_cast<const bf16*>(cf) + o);
            else
              f = *reinterpret_cast<const float2*>(
                  static_cast<const float*>(cf) + o);
          }
          acc[mt][nf][2 * hf] = a * wsig[col] + f.x;
          acc[mt][nf][2 * hf + 1] = a * wsig[col + 1] + f.y;
        }

    // ------------------------------------------------------ reverse sweep
    for (int i = last; i >= 0; --i) {
      const float w0s = i == 0 ? 30.f : 1.f;
      const float* tzl = tzb + (size_t)i * ACC * NT;
      bf16* azd = azbtz + (size_t)(2 * i) * nF + row0 * F;
      bf16* btd = azd + nF;
      float csum[8][2];
#pragma unroll
      for (int nf = 0; nf < 8; ++nf) csum[nf][0] = csum[nf][1] = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nf = 0; nf < 8; ++nf)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            int row, col;
            acc_pos<8>(mt, nf, 2 * hf, row, col);
            const size_t o = (row0 + row) * ld + (size_t)i * F + col;
            const float2 z = ld_bf2(zs + o);
            const float2 u = ld_bf2(us + o);
            float h, d10, d20, d11, d21;
            act_eval2(z.x, w0s, h, d10, d20);
            act_eval2(z.y, w0s, h, d11, d21);
            const int j = (mt * 8 + nf) * 4 + 2 * hf;
            const float az0 = d10 * acc[mt][nf][2 * hf] +
                              d20 * tzl[j * NT] * u.x;
            const float az1 = d11 * acc[mt][nf][2 * hf + 1] +
                              d21 * tzl[(j + 1) * NT] * u.y;
            csum[nf][0] += az0;
            csum[nf][1] += az1;
            st_bf2(act + row * SA + col, az0, az1);
            st_bf2(azd + row * F + col, az0, az1);
            st_bf2(btd + row * F + col, d10 * u.x, d11 * u.y);
          }
      // column sums over the tile's 64 rows
#pragma unroll
      for (int nf = 0; nf < 8; ++nf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = col_sum(csum[nf][e]);
          if (lane < 4)
            pt_tile[(size_t)i * F + warp * 64 + nf * 8 + lane * 2 + e] = v;
        }
      if (i == 0) break;
      // a_h_{i-1} = a_z_i . W_i
      zero<8>(acc);
      if (i == skip) {
        gemm<8, true>(acc, act, SA, F, nullptr, 0, 0, wskip, EP + F, EP,
                      stage);
      } else {
        const int mid = i < skip ? i - 1 : i - 2;
        gemm<8, true>(acc, act, SA, F, nullptr, 0, 0,
                      wmid + (size_t)mid * F * F, F, 0, stage);
      }
    }
    __syncthreads();   // the next tile reloads ts and restages the ring
  }
}

// ------------------------------------------------------------------ wgrad

constexpr int WT = 128;             // output tile edge
constexpr int KW = 64;              // points per staged chunk
constexpr int SK = WT + 8;          // chunk row stride (bf16)
constexpr int CHUNK = 2 * KW * SK;  // elements per stage buffer (A then B)
constexpr int WSTAGE = 3;
constexpr int SMEM_WGRAD = WSTAGE * CHUNK * 2;

// Stage chunk c of the K axis: A rows [a0 | a1] (K = 2n, the second half
// from a1; K = n where a1 is null) and B likewise, each a (KW x 128) window
// at column offsets ma / nb of row strides lda / ldb.
__device__ __forceinline__ void stage_wgrad(bf16* sb, const bf16* a0,
                                            const bf16* a1, int lda, int ma,
                                            const bf16* b0, const bf16* b1,
                                            int ldb, int nb, int n, int c) {
  const int k0 = c * KW;
  const bool second = k0 >= n;
  const bf16* a = second ? a1 : a0;
  const bf16* b = second ? b1 : b0;
  const size_t r0 = second ? k0 - n : k0;
#pragma unroll
  for (int j = 0; j < KW * WT / 8 / NT; ++j) {
    const int s = threadIdx.x + j * NT;
    const int r = s / (WT / 8), part = s % (WT / 8);
    cp_async16(sb + r * SK + part * 8,
               a + (r0 + r) * lda + ma + part * 8);
    cp_async16(sb + KW * SK + r * SK + part * 8,
               b + (r0 + r) * ldb + nb + part * 8);
  }
}

template <bool HEADS>
__global__ void __launch_bounds__(NT, 1)
    trunk_bwd_wgrad_kernel(const BwdArgs p) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int layers = p.layers, skip = p.skip, n = p.n;
  const size_t nF = (size_t)n * F;
  // which output tile: layers in order, the skip layer's top (x, t) part
  // before its bottom part, 4 column tiles per 128 rows; then (K5) dW_f,
  // 4 x 4 tiles, and dW_1 = [dW_1r | dW_1p], 4 x 8 tiles
  int b = blockIdx.x;
  bool found = false;
  const bf16 *a0 = nullptr, *a1 = nullptr, *b0 = nullptr, *b1 = nullptr;
  float* out = nullptr;
  int lda = F, ldb = F, ldo = F, ncol = 4;
  for (int i = 0; i < layers && !found; ++i) {
    const bf16* bh = i == 0 ? nullptr : p.hth + (size_t)(2 * (i - 1)) * nF;
    b0 = p.azbtz + (size_t)(2 * i) * nF;
    b1 = b0 + nF;
    if (i == 0 || i == skip) {
      if (b < 4) {
        a0 = p.xt, a1 = p.xt + (size_t)n * EP, lda = EP;
        out = i == 0 ? p.dw0 : p.dwst;
        found = true;
        break;
      }
      b -= 4;
      if (i == 0) continue;
    }
    if (b < 16) {
      a0 = bh, a1 = bh + nF, lda = F;
      out = i == skip ? p.dwsb
                      : p.dwm + (size_t)(i < skip ? i - 1 : i - 2) * F * F;
      found = true;
      break;
    }
    b -= 16;
  }
  if (HEADS && !found) {
    a1 = b1 = nullptr;
    if (b < 16) {
      a0 = p.hl, b0 = p.axf, out = p.dwf;
      found = true;
    } else if (b < 48) {
      b -= 16;
      a0 = p.xfb, b0 = p.cz1, ldb = ldo = 4 * HID, ncol = 8, out = p.dw1;
      found = true;
    } else {
      b -= 48;
    }
  }

  if (!found) {
    // partial sums over the tiles, in tile order: the bias grads, the
    // sigma head's dW, (K5) the heads' partials, then the sigma head's db
    const int j = b * NT + tid;
    const int trunk_cols = (layers + 1) * F;
    const int cols = trunk_cols + (HEADS ? HEAD_PART : 0);
    if (j > cols) return;
    float s = 0.f;
    if (j == cols) {
      for (int t = 0; t < p.n_tiles; ++t) s += p.pbs[t];
      p.dbsig[0] = s;
      return;
    }
    for (int t = 0; t < p.n_tiles; ++t) s += p.part[(size_t)t * cols + j];
    if (j < trunk_cols) {
      const int slot = j / F, c = j % F;
      if (slot == layers)
        p.dwsig[c] = s;
      else if (slot == 0)
        p.db0[c] = s;
      else if (slot == skip)
        p.dbs[c] = s;
      else
        p.dbm[(size_t)(slot < skip ? slot - 1 : slot - 2) * F + c] = s;
      return;
    }
    if (HEADS) {
      const int h = j - trunk_cols;
      if (h < HP_DB1) {
        p.dbf[h - HP_DBF] = s;
      } else if (h < HP_DW2) {
        p.db1[h - HP_DB1] = s;
      } else if (h < HP_DB2) {
        const int c = (h - HP_DW2) / (4 * HID), k = (h - HP_DW2) % (4 * HID);
        if (k < HID)
          p.dw2r[(size_t)k * 128 + c] = s;
        else
          p.dw2p[(size_t)(k - HID) * 128 + c] = s;
      } else {
        const int c = h - HP_DB2;
        if (c < 3)
          p.db2r[c] = s;
        else if (c < 6)
          p.db2p[c - 3] = s;
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int mb = (b / ncol) * WT, nb = (b % ncol) * WT;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile 64 x 32
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nf][e] = 0.f;

  const int nk = (a1 ? 2 * n : n) / KW;
  stage_wgrad(ring, a0, a1, lda, mb, b0, b1, ldb, nb, n, 0);
  cp_async_commit();
  if (nk > 1)
    stage_wgrad(ring + CHUNK, a0, a1, lda, mb, b0, b1, ldb, nb, n, 1);
  cp_async_commit();
  int buf = 0;
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<1>();
    __syncthreads();
    if (c + 2 < nk)
      stage_wgrad(ring + ((buf + 2) % WSTAGE) * CHUNK, a0, a1, lda, mb, b0,
                  b1, ldb, nb, n, c + 2);
    cp_async_commit();
    const bf16* as = ring + buf * CHUNK;
    const bf16* bs = as + KW * SK;
    buf = buf + 1 == WSTAGE ? 0 : buf + 1;
#pragma unroll
    for (int ks = 0; ks < KW; ks += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4_t(af[mt], as + (ks + (lane & 7) + ((lane >> 4) & 1) * 8) * SK +
                              wm * 64 + mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, bs + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * SK +
                           wn * 32 + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma16816(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          mma16816(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = mb + wm * 64 + mt * 16 + (lane >> 2) + hf * 8;
        const int col = nb + wn * 32 + nf * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(out + (size_t)row * ldo + col) =
            make_float2(acc[mt][nf][2 * hf], acc[mt][nf][2 * hf + 1]);
      }
}

// Launch the sweep and the weight-gradient kernel of K3 (HEADS = false) or
// K5 on `stream`; returns a cudaError_t.
template <bool HEADS>
int launch_bwd(const BwdArgs& p, int n_blocks, void* stream) {
  if (p.n <= 0 || p.n % T != 0 || n_blocks <= 0 || p.layers < 3 ||
      p.skip <= 0 || p.skip >= p.layers)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem_sweep = HEADS ? SMEM_SWEEP_H : SMEM_SWEEP;
  cudaError_t e = cudaFuncSetAttribute(
      trunk_bwd_sweep_kernel<HEADS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_sweep);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(trunk_bwd_wgrad_kernel<HEADS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_WGRAD);
  if (e != cudaSuccess) return (int)e;
  trunk_bwd_sweep_kernel<HEADS><<<n_blocks, NT, smem_sweep, st>>>(
      p.x, p.cs, p.cf, p.cf_bf16, p.cot, p.cg, p.zs, p.us, p.n, p.n_tiles,
      p.w0, p.wmid, p.wskip, p.wsig, p.bsig, p.wf, p.bf, p.w1r, p.b1r, p.w2r,
      p.w1p, p.b1p, p.w2p, p.xt, p.hth, p.azbtz, p.part, p.pbs, p.tzsc, p.hl,
      p.xfb, p.axf, p.cz1, p.layers, p.skip);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // 4 tiles for layer 0, 4 + 16 for the skip layer, 16 for each other one
  // (+ 48 for K5's heads); then the partial sums, one column each
  const int n_wt = 8 + 16 * (p.layers - 1) + (HEADS ? 48 : 0);
  const int cols = (p.layers + 1) * F + (HEADS ? HEAD_PART : 0);
  const int n_red = (cols + 1 + NT - 1) / NT;
  trunk_bwd_wgrad_kernel<HEADS><<<n_wt + n_red, NT, SMEM_WGRAD, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace trunk
