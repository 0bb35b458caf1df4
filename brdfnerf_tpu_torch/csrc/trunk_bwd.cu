// Kernel K3: the trunk's hand-derived second-order backward, for the
// training step.  With cotangents c_sigma, c_feats, c_g of the outputs of K2
// it returns dS/dW and dS/db of every trunk layer and of the sigma head, for
// S = <c_sigma, sigma> + <c_feats, feats> + <c_g, g>.
//
// Replaces: brdfnerf_tpu/ops/pallas_trunk_vjp.py::_bwd_kernel (pallas_call
// at pallas_trunk_vjp.py:477).
//
// Math (ops/fused_trunk_vjp.py): a tangent forward seeded by t = c_g gives
// tz_l = th_{l-1} W_l^T and th_l = act'(z_l) tz_l; the reverse sweep then
// runs the first-order recurrence over the (primal, tangent) pairs,
//     a_z = act'(z) a_h + act''(z) tz b_th,  b_tz = act'(z) b_th,
//     dW_l = h_{l-1}^T a_z + th_{l-1}^T b_tz,  db_l = sum_rows a_z,
//     a_h <- a_z W_l,
// with z_l and b_th_l = u_l loaded from what K2 saved (zs, us).
//
// What bounds it: tensor-core operations.  A point costs the tangent
// forward's 1.90 M multiply-adds, the a chain's 7 x 512^2 and the two outer
// products of every layer's weight gradient (3.79 M), about 7.5 M in all,
// against about 18 KB of input.
//
// Design.  On the TPU the grid runs in order and carries dW in VMEM from one
// tile to the next.  Here blocks run in parallel and one set of weight grads
// (8.5 MB of f32) fits in no block, so the work is two kernels, both
// deterministic (a fixed summation order, no atomics):
//   1. sweep: a persistent grid of blocks of 8 warps, one 64-point tile at a
//      time, as K2 (trunk_common.cuh): the tangent forward and the a chain on
//      the tensor cores, with the tile's tz_l kept in a per-block f32 scratch.
//      It writes the bf16 operands of every layer's weight-gradient products
//      (x | t, h_{l-1} | th_{l-1} and a_z | b_tz: the Pallas _outer rounds
//      exactly these to bf16, so nothing is lost), per-tile column sums of
//      a_z in f32 (the bias grads), and the sigma head's per-tile grads.
//   2. wgrad: one block per 128 x 128 tile of every layer's dW (120 tiles at
//      8 x 512, enough for the 132 SMs without splitting the point axis),
//      walking all points in order: dW = [h; th]^T [a_z; b_tz] with
//      K = 2 x points; both operands are read point-major and transposed by
//      ldmatrix.trans.  Further blocks sum the per-tile partials of the
//      biases and the sigma head over the tiles, in tile order.
// Rows beyond the caller's points carry zero cotangents and add exactly 0.

#include "trunk_common.cuh"

using namespace trunk;

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

// shared memory of the sweep: K2's carve-up plus a second row vector
constexpr int OFF_ROW2 = SMEM_BYTES;
constexpr int SMEM_SWEEP = OFF_ROW2 + T * 4;

// ------------------------------------------------------------------ sweep
//
// Scratch written (n = rows, F = 512, L = layers):
//   xt    (2, n, 128)      bf16  x, then t = c_g
//   hth   (L-1, 2, n, F)   bf16  slot l-1: h_{l-1}, then th_{l-1} (layer l)
//   azbtz (L, 2, n, F)     bf16  slot l: a_z_l, then b_tz_l
//   part  (tiles, L+1, F)  f32   per tile: column sums of a_z_l (l < L),
//                                 then the sigma head's dW
//   pbs   (tiles,)         f32   per tile: the sigma head's db
//   tzsc  (blocks, L, 64 x 512) f32: the block's tz_l, per-thread layout
__global__ void __launch_bounds__(NT, 1)
    trunk_bwd_sweep_kernel(const float* __restrict__ x,
                           const float* __restrict__ cs,
                           const void* __restrict__ cf, int cf_bf16,
                           const float* __restrict__ cg,
                           const bf16* __restrict__ zs,
                           const bf16* __restrict__ us, int n, int n_tiles,
                           const bf16* __restrict__ w0,
                           const bf16* __restrict__ wmid,
                           const bf16* __restrict__ wskip,
                           const float* __restrict__ wsig,
                           const float* __restrict__ bsig,
                           bf16* __restrict__ xt, bf16* __restrict__ hth,
                           bf16* __restrict__ azbtz, float* __restrict__ part,
                           float* __restrict__ pbs, float* __restrict__ tzsc,
                           int layers, int skip) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem + OFF_ACT);
  bf16* ts = reinterpret_cast<bf16*>(smem + OFF_X);
  bf16* stage = reinterpret_cast<bf16*>(smem + OFF_W);
  float* red = reinterpret_cast<float*>(smem + OFF_RED);
  float* row_a = reinterpret_cast<float*>(smem + OFF_ROW);
  float* row_b = reinterpret_cast<float*>(smem + OFF_ROW2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int last = layers - 1;
  const size_t ld = (size_t)layers * F;
  const size_t nF = (size_t)n * F;
  float* tzb = tzsc + (size_t)blockIdx.x * layers * ACC * NT + tid;
  // the last layer's h, bf16, staged in the (idle) weight ring
  bf16* h_last = stage;

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
      bf16* hd = hth + (size_t)(2 * i) * nF + row0 * F;        // layer i+1
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
            st_bf2(act + row * SA + col, th0, th1);
            if (i < last) {
              st_bf2(hd + row * F + col, h0, h1);
              st_bf2(thd + row * F + col, th0, th1);
            } else {
              st_bf2(h_last + row * SA + col, h0, h1);
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
      row_a[tid] = cs[row0 + tid] * sp1 + sp2 * s_t;
      row_b[tid] = sp1;
    }
    __syncthreads();
    float* pt_tile = part + (size_t)tile * (layers + 1) * F;
    if (tid == 0) {
      float s = 0.f;
      for (int r = 0; r < T; ++r) s += row_a[r];
      pbs[tile] = s;
    }
    for (int c = tid; c < F; c += NT) {
      float sh = 0.f, st = 0.f;
      for (int r = 0; r < T; ++r) {
        sh += __bfloat162float(h_last[r * SA + c]) * bf16_round(row_a[r]);
        st += __bfloat162float(act[r * SA + c]) * bf16_round(row_b[r]);
      }
      pt_tile[(size_t)layers * F + c] = sh + st;
    }
    __syncthreads();

    // a_h of the last layer: a . wsig + c_feats
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nf = 0; nf < 8; ++nf)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          int row, col;
          acc_pos<8>(mt, nf, 2 * hf, row, col);
          const float a = bf16_round(row_a[row]);
          const size_t o = (row0 + row) * F + col;
          float2 f;
          if (cf_bf16)
            f = ld_bf2(static_cast<const bf16*>(cf) + o);
          else
            f = *reinterpret_cast<const float2*>(
                static_cast<const float*>(cf) + o);
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
      // column sums over the tile's 64 rows: the lanes sharing a column
      // differ in lane bits 2..4
#pragma unroll
      for (int nf = 0; nf < 8; ++nf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = csum[nf][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
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
// from a1) and B likewise, each a (KW x 128) window at column offsets
// ma / nb of row strides lda / ldb.
__device__ __forceinline__ void stage_wgrad(bf16* sb, const bf16* a0,
                                            const bf16* a1, int lda, int ma,
                                            const bf16* b0, const bf16* b1,
                                            int nb, int n, int c) {
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
               b + (r0 + r) * F + nb + part * 8);
  }
}

__global__ void __launch_bounds__(NT, 1)
    trunk_bwd_wgrad_kernel(const bf16* __restrict__ xt,
                           const bf16* __restrict__ hth,
                           const bf16* __restrict__ azbtz, int n, int n_tiles,
                           const float* __restrict__ part,
                           const float* __restrict__ pbs,
                           float* __restrict__ dw0, float* __restrict__ db0,
                           float* __restrict__ dwm, float* __restrict__ dbm,
                           float* __restrict__ dwst, float* __restrict__ dwsb,
                           float* __restrict__ dbs,
                           float* __restrict__ dwsig,
                           float* __restrict__ dbsig, int layers, int skip) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t nF = (size_t)n * F;
  // which output tile: layers in order, the skip layer's top (x, t) part
  // before its bottom part; 4 column tiles per 128 rows
  int b = blockIdx.x, layer = -1;
  const bf16 *a0 = nullptr, *a1 = nullptr;
  float* out = nullptr;
  int lda = F;
  for (int i = 0; i < layers && layer < 0; ++i) {
    const bf16* bh = i == 0 ? nullptr : hth + (size_t)(2 * (i - 1)) * nF;
    float* o_top = i == 0 ? dw0 : dwst;
    if (i == 0 || i == skip) {
      if (b < 4) {
        layer = i, a0 = xt, a1 = xt + (size_t)n * EP, lda = EP, out = o_top;
        break;
      }
      b -= 4;
      if (i == 0) continue;
    }
    if (b < 16) {
      layer = i, a0 = bh, a1 = bh + nF, lda = F;
      out = i == skip ? dwsb
                      : dwm + (size_t)(i < skip ? i - 1 : i - 2) * F * F;
      break;
    }
    b -= 16;
  }

  if (layer < 0) {
    // partial sums over the tiles, in tile order: the bias grads, the
    // sigma head's dW, then its db
    const int j = b * NT + tid;
    const int cols = (layers + 1) * F;
    if (j > cols) return;
    float s = 0.f;
    if (j == cols) {
      for (int t = 0; t < n_tiles; ++t) s += pbs[t];
      dbsig[0] = s;
      return;
    }
    for (int t = 0; t < n_tiles; ++t) s += part[(size_t)t * cols + j];
    const int slot = j / F, c = j % F;
    if (slot == layers)
      dwsig[c] = s;
    else if (slot == 0)
      db0[c] = s;
    else if (slot == skip)
      dbs[c] = s;
    else
      dbm[(size_t)(slot < skip ? slot - 1 : slot - 2) * F + c] = s;
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int mb = (b / 4) * WT, nb = (b % 4) * WT;
  const bf16* b0 = azbtz + (size_t)(2 * layer) * nF;
  const bf16* b1 = b0 + nF;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile 64 x 32
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nf][e] = 0.f;

  const int nk = 2 * n / KW;
  stage_wgrad(ring, a0, a1, lda, mb, b0, b1, nb, n, 0);
  cp_async_commit();
  if (nk > 1) stage_wgrad(ring + CHUNK, a0, a1, lda, mb, b0, b1, nb, n, 1);
  cp_async_commit();
  int buf = 0;
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<1>();
    __syncthreads();
    if (c + 2 < nk)
      stage_wgrad(ring + ((buf + 2) % WSTAGE) * CHUNK, a0, a1, lda, mb, b0,
                  b1, nb, n, c + 2);
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
        *reinterpret_cast<float2*>(out + (size_t)row * F + col) =
            make_float2(acc[mt][nf][2 * hf], acc[mt][nf][2 * hf + 1]);
      }
}

// x, cg (n_rows, 128) f32, cs (n_rows,) f32, cf (n_rows, 512) bf16 when
// cf_bf16 else f32, zs/us (n_rows, layers * 512) bf16, with n_rows % 64 == 0;
// weights as trunk_fwd_grad_launch.  Scratch: xt (2, n, 128) bf16, hth
// (layers-1, 2, n, 512) bf16, azbtz (layers, 2, n, 512) bf16, part
// (n/64, layers+1, 512) f32, pbs (n/64,) f32, tzsc (n_blocks, layers,
// 64 * 512) f32.  Outputs f32 in (in, out) layout: dw0 (128, 512), db0
// (512,), dwm (layers-2, 512, 512), dbm (layers-2, 512), dwst (128, 512),
// dwsb (512, 512), dbs (512,), dwsig (512,), dbsig (1,).  Two kernels on
// the stream; returns a cudaError_t.
extern "C" int trunk_bwd_launch(
    const float* x, const float* cs, const void* cf, int cf_bf16,
    const float* cg, const void* zs, const void* us, int n_rows,
    int n_blocks, const void* w0, const void* wmid, const void* wskip,
    const float* wsig, const float* bsig, void* xt, void* hth, void* azbtz,
    float* part, float* pbs, float* tzsc, float* dw0, float* db0, float* dwm,
    float* dbm, float* dwst, float* dwsb, float* dbs, float* dwsig,
    float* dbsig, int layers, int skip, void* stream) {
  if (n_rows <= 0 || n_rows % T != 0 || n_blocks <= 0 || layers < 3 ||
      skip <= 0 || skip >= layers)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      trunk_bwd_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_SWEEP);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(trunk_bwd_wgrad_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_WGRAD);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = n_rows / T;
  trunk_bwd_sweep_kernel<<<n_blocks, NT, SMEM_SWEEP, st>>>(
      x, cs, cf, cf_bf16, cg, static_cast<const bf16*>(zs),
      static_cast<const bf16*>(us), n_rows, n_tiles,
      static_cast<const bf16*>(w0), static_cast<const bf16*>(wmid),
      static_cast<const bf16*>(wskip), wsig, bsig, static_cast<bf16*>(xt),
      static_cast<bf16*>(hth), static_cast<bf16*>(azbtz), part, pbs, tzsc,
      layers, skip);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // 4 tiles for layer 0, 4 + 16 for the skip layer, 16 for each other one;
  // then the partial sums, (layers + 1) * 512 + 1 columns
  const int n_wt = 8 + 16 * (layers - 1);
  const int n_red = ((layers + 1) * F + 1 + NT - 1) / NT;
  trunk_bwd_wgrad_kernel<<<n_wt + n_red, NT, SMEM_WGRAD, st>>>(
      static_cast<const bf16*>(xt), static_cast<const bf16*>(hth),
      static_cast<const bf16*>(azbtz), n_rows, n_tiles, part, pbs, dw0, db0,
      dwm, dbm, dwst, dwsb, dbs, dwsig, dbsig, layers, skip);
  return (int)cudaGetLastError();
}
