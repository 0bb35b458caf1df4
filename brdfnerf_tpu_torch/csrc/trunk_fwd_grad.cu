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
// Design: as kernel K1 (trunk_common.cuh): 8 warps per 64-point tile,
// activations in shared memory as bf16, weights staged from L2, mma.sync
// with f32 accumulators.  Both operands of every product are bf16, as in
// the Pallas kernel's _mm.  The reverse chain needs act'(z_l) of every layer;
// 8 layers of a 64 x 512 tile do not fit in shared memory, so the forward
// writes act'(z_l) of layers 0..L-2 (f32) to a global scratch buffer owned
// by the block and the reverse chain reads it back; act'(z_{L-1}) is
// recomputed from the last layer's pre-activations, which stay in registers
// while the sigma head is reduced.  The grid is persistent (one block per
// SM), which bounds the scratch to (L-1) x 128 KB per SM.  Each thread
// reads back exactly the elements it wrote, in a coalesced per-thread
// layout.  There is no reduction across blocks: the result is
// deterministic.
//
// With ZS (the training instantiation) the kernel also saves, per point and
// layer, the pre-activation z_l and the chain state u_l (the value the
// reverse chain meets at layer l, before the act' multiply) in bf16: each
// tile of them goes through the weight-stage ring, which is idle between
// two products, and leaves in 16-byte stores of whole rows.  The serving
// instantiation (ZS = false) has none of that code.
//
// gx leaves at the padded width 128; its padded lanes are exactly 0
// because the padded columns of w0 and the top of wskip are zero.

#include "trunk_common.cuh"

using namespace trunk;

template <bool ZS>
__global__ void __launch_bounds__(NT, 1)
    trunk_fwd_grad_kernel(const float* __restrict__ x, int n_tiles,
                          const bf16* __restrict__ w0,
                          const float* __restrict__ b0,
                          const bf16* __restrict__ wmid,
                          const float* __restrict__ bmid,
                          const bf16* __restrict__ wskip,
                          const float* __restrict__ bskip,
                          const float* __restrict__ wsig,
                          const float* __restrict__ bsig,
                          float* __restrict__ sigma, void* __restrict__ feats,
                          int feats_bf16, float* __restrict__ gx,
                          float* __restrict__ scratch,
                          bf16* __restrict__ zs, bf16* __restrict__ us,
                          int layers, int skip) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem + OFF_ACT);
  bf16* xs = reinterpret_cast<bf16*>(smem + OFF_X);
  bf16* stage = reinterpret_cast<bf16*>(smem + OFF_W);
  float* red = reinterpret_cast<float*>(smem + OFF_RED);
  float* rowv = reinterpret_cast<float*>(smem + OFF_ROW);
  const int tid = threadIdx.x;
  // act'(z) of layers 0..L-2: element j of thread tid of layer l at
  // d1s[(l * ACC + j) * NT + tid]
  float* d1s = scratch + (size_t)blockIdx.x * (layers - 1) * ACC * NT;
  const int last = layers - 1;
  // zs/us rows hold layers x 512 values; a tile of one layer is staged at
  // row stride SA in the (idle) weight-stage ring
  const size_t ld = (size_t)layers * F;
  bf16* zst = stage;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * T;
    load_x_tile(x + row0 * EP, xs);
    float acc[MT][8][4];

    // ---------------------------------------------------------- forward
    for (int i = 0; i < last; ++i) {
      forward_layer(acc, i, skip, xs, act, w0, wmid, wskip, stage);
      const float* b = layer_bias(i, skip, b0, bmid, bskip);
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
        store_tile(zst, zs + row0 * ld + (size_t)i * F, ld);
        __syncthreads();   // the next product restages the ring
      }
    }
    forward_layer(acc, last, skip, xs, act, w0, wmid, wskip, stage);
    {
      const float* b = layer_bias(last, skip, b0, bmid, bskip);
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
        store_tile(zst, zs + row0 * ld + (size_t)last * F, ld);
      }
    }

    // ------------------------------------- features and the sigma head
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
          if (feats_bf16)
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(feats) +
                                               o) =
                __floats2bfloat162_rn(h0, h1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(feats) + o) =
                make_float2(h0, h1);
          part[mt][hf] += bf16_round(h0) * wsig[col] +
                          bf16_round(h1) * wsig[col + 1];
        }
    const float s = sigma_rows(part, red);
    if (tid < T) {
      const float z = s + bsig[0];
      sigma[row0 + tid] = softplus(z);
      rowv[tid] = bf16_round(1.f / (1.f + expf(-z)));   // softplus'(z)
    }
    __syncthreads();

    // ---------------- reverse chain, seeded g_{L-1} = act' * sig' * wsig
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
    if (ZS) {
      __syncthreads();
      store_tile(zst, us + row0 * ld + (size_t)last * F, ld);
      __syncthreads();
    }

    for (int i = last; i >= 1; --i) {
      if (i == skip) {
        // the encoding's share through the skip input: gx = g . Wskip_top
        float c[MT][2][4];
        zero<2>(c);
        gemm<2, true>(c, act, SA, F, nullptr, 0, 0, wskip, EP + F, 0, stage);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nf = 0; nf < 2; ++nf)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              int row, col;
              acc_pos<2>(mt, nf, 2 * hf, row, col);
              *reinterpret_cast<float2*>(gx + (row0 + row) * EP + col) =
                  make_float2(c[mt][nf][2 * hf], c[mt][nf][2 * hf + 1]);
            }
        zero<8>(acc);
        gemm<8, true>(acc, act, SA, F, nullptr, 0, 0, wskip, EP + F, EP,
                      stage);
      } else {
        const int mid = i < skip ? i - 1 : i - 2;
        zero<8>(acc);
        gemm<8, true>(acc, act, SA, F, nullptr, 0, 0,
                      wmid + (size_t)mid * F * F, F, 0, stage);
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
        store_tile(zst, us + row0 * ld + (size_t)(i - 1) * F, ld);
        __syncthreads();
      }
    }

    // layer 0: gx += g_0 . w0
    float c[MT][2][4];
    zero<2>(c);
    gemm<2, true>(c, act, SA, F, nullptr, 0, 0, w0, EP, 0, stage);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nf = 0; nf < 2; ++nf)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          int row, col;
          acc_pos<2>(mt, nf, 2 * hf, row, col);
          float2* o = reinterpret_cast<float2*>(gx + (row0 + row) * EP + col);
          const float2 v = *o;
          *o = make_float2(v.x + c[mt][nf][2 * hf],
                           v.y + c[mt][nf][2 * hf + 1]);
        }
  }
}

// x (n_rows, 128) f32 with n_rows % 64 == 0; weights as trunk_sigma_launch.
// Outputs sigma (n_rows,) f32, feats (n_rows, 512) bf16 when feats_bf16
// else f32, gx (n_rows, 128) f32, and, when zs is not null, zs and us
// (n_rows, layers * 512) bf16.  scratch holds
// n_blocks * (layers-1) * 64 * 512 floats.  Returns a cudaError_t.
extern "C" int trunk_fwd_grad_launch(
    const float* x, int n_rows, int n_blocks, const void* w0, const float* b0,
    const void* wmid, const float* bmid, const void* wskip,
    const float* bskip, const float* wsig, const float* bsig, float* sigma,
    void* feats, int feats_bf16, float* gx, float* scratch, void* zs,
    void* us, int layers, int skip, void* stream) {
  if (n_rows <= 0 || n_rows % T != 0 || n_blocks <= 0 || layers < 3 ||
      skip <= 0 || skip >= layers || (zs == nullptr) != (us == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = zs ? trunk_fwd_grad_kernel<true> : trunk_fwd_grad_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_blocks, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      x, n_rows / T, static_cast<const bf16*>(w0), b0,
      static_cast<const bf16*>(wmid), bmid, static_cast<const bf16*>(wskip),
      bskip, wsig, bsig, sigma, feats, feats_bf16, gx, scratch,
      static_cast<bf16*>(zs), static_cast<bf16*>(us), layers, skip);
  return (int)cudaGetLastError();
}
