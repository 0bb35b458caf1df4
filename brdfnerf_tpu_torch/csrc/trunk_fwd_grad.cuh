// The kernel body shared by K2 (trunk_fwd_grad.cu: the trunk forward and
// the reverse chain of g = d sigma / d x_enc, returning sigma and the
// features) and K4 (trunk_heads_fwd.cu: the same trunk and chain, then the
// flagship head block on the tile's features, returning packed logits).
//
// Design (trunk_common.cuh): 8 warps per 64-point tile, activations in
// shared memory as bf16, weights staged from L2, mma.sync with f32
// accumulators; both operands of every product are bf16, as in the Pallas
// kernels' _mm.  The reverse chain needs act'(z_l) of every layer; 8 layers
// of a 64 x 512 tile do not fit in shared memory, so the forward writes
// act'(z_l) (f32) to a global scratch buffer owned by the block and the
// reverse chain reads it back.  K2 keeps the last layer's pre-activations
// in registers across the sigma head and recomputes act'(z_{L-1}) from
// them; K4 needs those registers for the head products, so it writes
// act'(z_{L-1}) to one more scratch slot.  The grid is persistent (one
// block per SM), which bounds the scratch to L x 128 KB per SM.  Each
// thread reads back exactly the elements it wrote, in a coalesced
// per-thread layout.  There is no reduction across blocks: the result is
// deterministic.
//
// With ZS (the training instantiations) the kernel also saves, per point and
// layer, the pre-activation z_l and the chain state u_l (the value the
// reverse chain meets at layer l, before the act' multiply) in bf16: each
// tile of them goes through the weight-stage ring, which is idle between
// two products, and leaves in 16-byte stores of whole rows.  The serving
// instantiations (ZS = false) have none of that code.
//
// gx leaves at the padded width 128; its padded lanes are exactly 0
// because the padded columns of w0 and the top of wskip are zero.

#pragma once

#include "trunk_common.cuh"

namespace trunk {

// K4's shared memory: K2's carve-up, then the row partials of the 7 head
// columns (sigma, rgb x3, k, theta, rhoc) of each warp
constexpr int OFF_HRED = SMEM_BYTES;
constexpr int SMEM_HEADS = OFF_HRED + 7 * 8 * T * 4;

struct FwdArgs {
  const float* x;
  int n_tiles;
  // the trunk, packed as in ops/fused_mlp.pack_trunk_weights
  const bf16* w0;
  const float* b0;
  const bf16* wmid;
  const float* bmid;
  const bf16* wskip;
  const float* bskip;
  const float* wsig;
  const float* bsig;
  // K2's outputs
  float* sigma;
  void* feats;
  int feats_bf16;
  // K4: the heads, packed as in ops/fused_trunk_heads.pack_head_weights,
  // and the packed logits
  const bf16* wf;
  const float* bf;
  const bf16* w1r;
  const float* b1r;
  const bf16* w2r;
  const float* b2r;
  const bf16* w1p;
  const float* b1p;
  const bf16* w2p;
  const float* b2p;
  float* out;
  // both
  float* gx;
  float* scratch;
  bf16* zs;
  bf16* us;
  int layers, skip;
};

template <bool ZS, bool HEADS>
__global__ void __launch_bounds__(NT, 1)
    trunk_fwd_grad_kernel(const FwdArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem + OFF_ACT);
  bf16* xs = reinterpret_cast<bf16*>(smem + OFF_X);
  bf16* stage = reinterpret_cast<bf16*>(smem + OFF_W);
  float* red = reinterpret_cast<float*>(smem + OFF_RED);
  float* rowv = reinterpret_cast<float*>(smem + OFF_ROW);
  const int tid = threadIdx.x;
  const int layers = p.layers, skip = p.skip;
  const float* __restrict__ wsig = p.wsig;
  // act'(z) of layers 0..L-2 (K4: 0..L-1): element j of thread tid of
  // layer l at d1s[(l * ACC + j) * NT + tid]
  const int slots = HEADS ? layers : layers - 1;
  float* d1s = p.scratch + (size_t)blockIdx.x * slots * ACC * NT;
  const int last = layers - 1;
  // zs/us rows hold layers x 512 values; a tile of one layer is staged at
  // row stride SA in the (idle) weight-stage ring
  const size_t ld = (size_t)layers * F;
  bf16* zst = stage;

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * T;
    load_x_tile(p.x + row0 * EP, xs);
    float acc[MT][8][4];

    // ---------------------------------------------------------- forward
    for (int i = 0; i < last; ++i) {
      forward_layer(acc, i, skip, xs, act, p.w0, p.wmid, p.wskip, stage);
      const float* b = layer_bias(i, skip, p.b0, p.bmid, p.bskip);
      const float w0s = i == 0 ? 30.f : 1.f;
      float* d1l = d1s + (size_t)i * ACC * NT + tid;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nf = 0; nf < 8; ++nf)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            int row, col;
            acc_pos<8>(mt, nf, 2 * hf, row, col);
            float h0, h1, d0, d1;
            const float z0 = acc[mt][nf][2 * hf] + b[col];
            const float z1 = acc[mt][nf][2 * hf + 1] + b[col + 1];
            act_eval(z0, w0s, h0, d0);
            act_eval(z1, w0s, h1, d1);
            *reinterpret_cast<__nv_bfloat162*>(act + row * SA + col) =
                __floats2bfloat162_rn(h0, h1);
            if (ZS)
              *reinterpret_cast<__nv_bfloat162*>(zst + row * SA + col) =
                  __floats2bfloat162_rn(z0, z1);
            const int j = (mt * 8 + nf) * 4 + 2 * hf;
            d1l[j * NT] = d0;
            d1l[(j + 1) * NT] = d1;
          }
      if (ZS) {
        __syncthreads();
        store_tile(zst, p.zs + row0 * ld + (size_t)i * F, ld);
        __syncthreads();   // the next product restages the ring
      }
    }
    forward_layer(acc, last, skip, xs, act, p.w0, p.wmid, p.wskip, stage);
    {
      const float* b = layer_bias(last, skip, p.b0, p.bmid, p.bskip);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nf = 0; nf < 8; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int row, col;
            acc_pos<8>(mt, nf, e, row, col);
            acc[mt][nf][e] += b[col];
            if (ZS) zst[row * SA + col] = __float2bfloat16_rn(acc[mt][nf][e]);
          }
      if (ZS) {
        __syncthreads();
        store_tile(zst, p.zs + row0 * ld + (size_t)last * F, ld);
      }
    }

    if constexpr (!HEADS) {
      // ----------------------------------- features and the sigma head
      float part[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) part[mt][0] = part[mt][1] = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nf = 0; nf < 8; ++nf)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            int row, col;
            acc_pos<8>(mt, nf, 2 * hf, row, col);
            float h0, h1, d;
            act_eval(acc[mt][nf][2 * hf], 1.f, h0, d);
            act_eval(acc[mt][nf][2 * hf + 1], 1.f, h1, d);
            const size_t o = (row0 + row) * F + col;
            if (p.feats_bf16)
              *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.feats) +
                                                 o) =
                  __floats2bfloat162_rn(h0, h1);
            else
              *reinterpret_cast<float2*>(static_cast<float*>(p.feats) + o) =
                  make_float2(h0, h1);
            part[mt][hf] += bf16_round(h0) * wsig[col] +
                            bf16_round(h1) * wsig[col + 1];
          }
      const float s = sigma_rows(part, red);
      if (tid < T) {
        const float z = s + p.bsig[0];
        p.sigma[row0 + tid] = softplus(z);
        rowv[tid] = bf16_round(1.f / (1.f + expf(-z)));   // softplus'(z)
      }
      __syncthreads();

      // -------------- reverse chain, seeded g_{L-1} = act' * sig' * wsig
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nf = 0; nf < 8; ++nf)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            int row, col;
            acc_pos<8>(mt, nf, 2 * hf, row, col);
            float h, d0, d1;
            act_eval(acc[mt][nf][2 * hf], 1.f, h, d0);
            act_eval(acc[mt][nf][2 * hf + 1], 1.f, h, d1);
            const float u = rowv[row];
            const float u0 = u * wsig[col], u1 = u * wsig[col + 1];
            *reinterpret_cast<__nv_bfloat162*>(act + row * SA + col) =
                __floats2bfloat162_rn(d0 * u0, d1 * u1);
            if (ZS)
              *reinterpret_cast<__nv_bfloat162*>(zst + row * SA + col) =
                  __floats2bfloat162_rn(u0, u1);
          }
    } else {
      // ------------------------------- the last layer and the sigma head
      float* hred = reinterpret_cast<float*>(smem + OFF_HRED);
      float* d1l = d1s + (size_t)last * ACC * NT + tid;
      {
        float part[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) part[mt][0] = part[mt][1] = 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nf = 0; nf < 8; ++nf)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              int row, col;
              acc_pos<8>(mt, nf, 2 * hf, row, col);
              float h0, h1, d0, d1;
              act_eval(acc[mt][nf][2 * hf], 1.f, h0, d0);
              act_eval(acc[mt][nf][2 * hf + 1], 1.f, h1, d1);
              *reinterpret_cast<__nv_bfloat162*>(act + row * SA + col) =
                  __floats2bfloat162_rn(h0, h1);
              const int j = (mt * 8 + nf) * 4 + 2 * hf;
              d1l[j * NT] = d0;
              d1l[(j + 1) * NT] = d1;
              part[mt][hf] += bf16_round(h0) * wsig[col] +
                              bf16_round(h1) * wsig[col + 1];
            }
        quad_rows(part, hred);
      }
      __syncthreads();   // h is published; the zs store is done with the ring

      // ------------------------------------------ xf = h W_f^T + b_f
      zero<8>(acc);
      gemm<8, false>(acc, act, SA, F, nullptr, 0, 0, p.wf, F, 0, stage);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nf = 0; nf < 8; ++nf)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            int row, col;
            acc_pos<8>(mt, nf, 2 * hf, row, col);
            *reinterpret_cast<__nv_bfloat162*>(act + row * SA + col) =
                __floats2bfloat162_rn(acc[mt][nf][2 * hf] + p.bf[col],
                                      acc[mt][nf][2 * hf + 1] + p.bf[col + 1]);
          }

      // ------ the rgb head (q = 0) and the three RPV heads (q = 1..3):
      // hidden = act(xf W_1^T + b_1) in 256-column passes; each logit is a
      // row reduction of bf16(hidden) against its second-layer row
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        const bf16* w1 = q == 0 ? p.w1r : p.w1p;
        const float* b1 = q == 0 ? p.b1r : p.b1p + (q - 1) * HID;
        float a[MT][4][4];
        zero<4>(a);
        gemm<4, false>(a, act, SA, F, nullptr, 0, 0, w1, F,
                       q == 0 ? 0 : (q - 1) * HID, stage);
        float pr[3][MT][2];
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) pr[c][mt][0] = pr[c][mt][1] = 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nf = 0; nf < 4; ++nf)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              int row, col;
              acc_pos<4>(mt, nf, 2 * hf, row, col);
              float h0, h1, d;
              act_eval(a[mt][nf][2 * hf] + b1[col], 1.f, h0, d);
              act_eval(a[mt][nf][2 * hf + 1] + b1[col + 1], 1.f, h1, d);
              const float hb0 = bf16_round(h0), hb1 = bf16_round(h1);
              if (q == 0) {
#pragma unroll
                for (int c = 0; c < 3; ++c)
                  pr[c][mt][hf] +=
                      hb0 * __bfloat162float(p.w2r[c * HID + col]) +
                      hb1 * __bfloat162float(p.w2r[c * HID + col + 1]);
              } else {
                const bf16* w2 = p.w2p + (q - 1) * 3 * HID + (q - 1) * HID;
                pr[0][mt][hf] += hb0 * __bfloat162float(w2[col]) +
                                 hb1 * __bfloat162float(w2[col + 1]);
              }
            }
        if (q == 0) {
#pragma unroll
          for (int c = 0; c < 3; ++c) quad_rows(pr[c], hred + (1 + c) * 8 * T);
        } else {
          quad_rows(pr[0], hred + (3 + q) * 8 * T);
        }
      }
      __syncthreads();
      if (tid < T) {
        float s[7];
#pragma unroll
        for (int c = 0; c < 7; ++c) {
          s[c] = 0.f;
          for (int w = 0; w < 8; ++w) s[c] += hred[(c * 8 + w) * T + tid];
        }
        const float z = s[0] + p.bsig[0];
        float4* o = reinterpret_cast<float4*>(p.out + (row0 + tid) * HEAD_COLS);
        o[0] = make_float4(softplus(z), s[1] + p.b2r[0], s[2] + p.b2r[1],
                           s[3] + p.b2r[2]);
        o[1] = make_float4(s[4] + p.b2p[0], s[5] + p.b2p[1], s[6] + p.b2p[2],
                           0.f);
        rowv[tid] = bf16_round(1.f / (1.f + expf(-z)));   // softplus'(z)
      }
      __syncthreads();

      // -------------- reverse chain, seeded g_{L-1} = act' * sig' * wsig
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nf = 0; nf < 8; ++nf)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            int row, col;
            acc_pos<8>(mt, nf, 2 * hf, row, col);
            const int j = (mt * 8 + nf) * 4 + 2 * hf;
            const float d0 = d1l[j * NT], d1 = d1l[(j + 1) * NT];
            const float u = rowv[row];
            const float u0 = u * wsig[col], u1 = u * wsig[col + 1];
            *reinterpret_cast<__nv_bfloat162*>(act + row * SA + col) =
                __floats2bfloat162_rn(d0 * u0, d1 * u1);
            if (ZS)
              *reinterpret_cast<__nv_bfloat162*>(zst + row * SA + col) =
                  __floats2bfloat162_rn(u0, u1);
          }
    }
    if (ZS) {
      __syncthreads();
      store_tile(zst, p.us + row0 * ld + (size_t)last * F, ld);
      __syncthreads();
    }

    for (int i = last; i >= 1; --i) {
      if (i == skip) {
        // the encoding's share through the skip input: gx = g . Wskip_top
        float c[MT][2][4];
        zero<2>(c);
        gemm<2, true>(c, act, SA, F, nullptr, 0, 0, p.wskip, EP + F, 0,
                      stage);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nf = 0; nf < 2; ++nf)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              int row, col;
              acc_pos<2>(mt, nf, 2 * hf, row, col);
              *reinterpret_cast<float2*>(p.gx + (row0 + row) * EP + col) =
                  make_float2(c[mt][nf][2 * hf], c[mt][nf][2 * hf + 1]);
            }
        zero<8>(acc);
        gemm<8, true>(acc, act, SA, F, nullptr, 0, 0, p.wskip, EP + F, EP,
                      stage);
      } else {
        const int mid = i < skip ? i - 1 : i - 2;
        zero<8>(acc);
        gemm<8, true>(acc, act, SA, F, nullptr, 0, 0,
                      p.wmid + (size_t)mid * F * F, F, 0, stage);
      }
      // g_{i-1} = act'(z_{i-1}) * u_{i-1}
      const float* d1l = d1s + (size_t)(i - 1) * ACC * NT + tid;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nf = 0; nf < 8; ++nf)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            int row, col;
            acc_pos<8>(mt, nf, 2 * hf, row, col);
            const int j = (mt * 8 + nf) * 4 + 2 * hf;
            const float d0 = d1l[j * NT];
            const float d1 = d1l[(j + 1) * NT];
            *reinterpret_cast<__nv_bfloat162*>(act + row * SA + col) =
                __floats2bfloat162_rn(d0 * acc[mt][nf][2 * hf],
                                      d1 * acc[mt][nf][2 * hf + 1]);
            if (ZS)
              *reinterpret_cast<__nv_bfloat162*>(zst + row * SA + col) =
                  __floats2bfloat162_rn(acc[mt][nf][2 * hf],
                                        acc[mt][nf][2 * hf + 1]);
          }
      if (ZS) {
        __syncthreads();
        store_tile(zst, p.us + row0 * ld + (size_t)(i - 1) * F, ld);
        __syncthreads();
      }
    }

    // layer 0: gx += g_0 . w0
    float c[MT][2][4];
    zero<2>(c);
    gemm<2, true>(c, act, SA, F, nullptr, 0, 0, p.w0, EP, 0, stage);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nf = 0; nf < 2; ++nf)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          int row, col;
          acc_pos<2>(mt, nf, 2 * hf, row, col);
          float2* o = reinterpret_cast<float2*>(p.gx + (row0 + row) * EP + col);
          const float2 v = *o;
          *o = make_float2(v.x + c[mt][nf][2 * hf],
                           v.y + c[mt][nf][2 * hf + 1]);
        }
  }
}

// Launch K2 (HEADS = false) or K4 on `stream`; returns a cudaError_t.
template <bool HEADS>
int launch_fwd(const FwdArgs& p, int n_rows, int n_blocks, void* stream) {
  if (n_rows <= 0 || n_rows % T != 0 || n_blocks <= 0 || p.layers < 3 ||
      p.skip <= 0 || p.skip >= p.layers || (p.zs == nullptr) != (p.us == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = p.zs ? trunk_fwd_grad_kernel<true, HEADS>
                     : trunk_fwd_grad_kernel<false, HEADS>;
  const int smem = HEADS ? SMEM_HEADS : SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace trunk
