// The layer-major trunk kernels: K1 (trunk + sigma), K2 (trunk + the
// reverse chain of d sigma / d x_enc), K3 (K2's hand-derived second-order
// backward), and K4 and K5 (K2 and K3 with the flagship head block) at any
// trunk width and any encoding width, where the fused kernels
// (trunk_sigma.cu, trunk_fwd_grad.cu, trunk_bwd.cu, trunk_heads_fwd.cu,
// trunk_heads_bwd.cu) take the widths 64..512 and 128 lanes.  They replace
// the same Pallas kernels: brdfnerf_tpu/ops/pallas_mlp.py _trunk_kernel
// (K1), brdfnerf_tpu/ops/pallas_trunk_vjp.py _fwd_kernel (K2) and
// _bwd_kernel (K3), brdfnerf_tpu/ops/pallas_trunk_heads.py _fwd_kernel_h
// (K4) and _bwd_kernel_h (K5), and compute what those compute (the twins
// in ops/fused_mlp.py, ops/fused_trunk_vjp.py and ops/fused_trunk_heads.py
// give the arithmetic).
//
// Why a second family: the fused kernels keep a 64-point tile on chip
// through every layer and stream the whole trunk's weights from L2 for
// each tile.  At width 2048 neither holds: the 12-layer trunk's bf16
// weights are ~93 MB (L2: 50 MB), one 64 x 2048 bf16 tile is 256 KB
// (shared memory: 227 KB), and a warpgroup's accumulators would be 1,024
// f32 a thread.  Here each launch is one layer's product over a block of
// points: one layer's weights (8 MB at 2048) stay in L2 while every point
// tile of the block passes through (the grid walks the output columns of
// one row tile together), and activations and the chain state go through
// device memory: ~4 KB of bf16 a point in and out per layer against 8.4
// MFLOP a point, so the products stay above the H100's FLOP/byte ridge.
//
// One call of an entry point below is one launch of K1..K5 (its wrapper
// counts it once): it walks the call's points in blocks of D_BLOCK rows,
// and for each block enqueues every layer's kernels on the stream.
// The wrapper (ops/trunk_layers.py) sizes D_BLOCK so that the state kept for
// the reverse chain (every layer's act'(z), K2 and K4) and for K3 and K5
// (every layer's tz, h and th; K5 also the rebuilt b_th chain) fits its
// scratch budget, and allocates all scratch.
//
// The products: layers_product_kernel, a tiled mma.sync GEMM (bf16
// operands, f32 accumulators, 128 x 128 x 32 tiles, a 3-stage cp.async
// ring, 8 warps of 64 x 32), over a list of K segments so that the skip
// layer's [x | h] and the float32 instantiations' three products (A_hi
// B_hi + A_lo B_hi + A_hi B_lo on the bf16 hi and lo terms,
// ops/fused_mlp.split3_mm) run into one accumulator.  Its epilogues are
// fused and chosen at compile time:
//   EPI_FWD    bias, activation: h (the next product's operand planes),
//              act'(z), z (zs), feats, and on the last layer the sigma
//              head's row partials
//   EPI_CHAIN  K2's reverse product u = g W: gx (layer 0 and the skip
//              layer's x columns), us, and the next g = act'(z) u (act'
//              from the saved z where K5 rebuilds the chain)
//   EPI_TAN    K3's tangent forward: th = act'(z) tz, h from the saved z,
//              tz, and the head's row partials of h and th
//   EPI_ADJ    K3's reverse product a_h = a_z W: a_z = act' a_h + act''
//              tz b_th, b_tz = act' b_th (fused_trunk_vjp._reverse_sweep)
//              and the column partials of a_z (the bias gradient)
//   EPI_WGRAD  the weight gradients [h | th]^T [a_z | b_tz], whose K axis
//              runs over the points: split-K into slices of at most
//              WG_SLICE points' products, each slice's tile written whole
//              and summed in a fixed order by layers_colsum_kernel, so that two
//              launches give the same bits (no atomics).
//   EPI_PLAIN  (optional) bias, no activation: operand planes, f32 values
//              and column partials (the heads' xf = h W_f^T + b_f, a_xf =
//              c_z1 W_1 and a_xf W_f)
//   EPI_LOGITS K4's merged first head layers z1 = xf [W_1r | W_1p]^T + b_1,
//              the activation at w0 = 1, and the row partials of the six
//              logits against the second layers (6 x 4 HID, block-diagonal)
//   EPI_HEADS  K5's recompute of z1 and the heads' first-order backward:
//              c_z1 = act'(z1) (c_z2 W_2), its operand planes and column
//              partials (db_1), and the column partials of dW_2 = act(z1)^T
//              c_z2 (3 logit columns a hidden unit)
// Every product of the Pallas kernels' bodies runs here; nothing goes to
// cuBLAS.
//
// The heads (K4, K5), HID = F / 2 a head: K4 is K2 with, after the last
// trunk layer, the products xf and z1 (one product over the merged first
// layers, 4 HID = 2 F columns) and a finish kernel that writes the packed
// (n, 8) logits [softplus sigma, rgb x3, k, theta, rho_c, 0]; like the
// Pallas kernel it saves zs and never us.  K5 rebuilds the b_th chain from
// zs in f32 at every dtype (K2's seed and EPI_CHAIN products over the
// block), recomputes xf and z1 from the saved z, runs the heads' backward
// (dW_1 = xf^T c_z1, a_xf = c_z1 W_1, dW_f = h^T a_xf, a_xf W_f) and hands
// a_xf W_f to K3's head and sweep as c_feats, with the rebuilt chain as us.
//
// Sizes: the wrapper pads the width F and the encoding E to multiples of
// 128 (zero rows and columns, exact: a padded column has z = 0, h = 0,
// u = 0 and every padded gradient 0) and the points to a multiple of 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_act.cuh"

namespace trunk {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128, BN = 128, BK = 32;  // a block's output tile and k step
constexpr int STAGES = 3;                   // cp.async ring depth
constexpr int NT = 256;                     // 8 warps: 2 (rows) x 4 (columns)
constexpr int PAD = 8;                      // bf16 of padding a smem row
// one operand's stage: [BM][BK + PAD] (K-major) or [BK][BM + PAD]
constexpr int TILE = BM * (BK + PAD);
static_assert(BK * (BM + PAD) <= TILE, "an MN-major tile fits a stage");
constexpr int SMEM = STAGES * 2 * TILE * (int)sizeof(bf16);  // 61,440 B
constexpr int MAXSEG = 6;
// points whose products one accumulator of the weight gradients sums: the
// f32 accumulation's error grows with K (ops/fused_trunk_vjp
// WGRAD_F32_CHUNKS: 128 chunks of 64 points)
constexpr int WG_SLICE = 8192;
constexpr int SLICE_CHUNKS = WG_SLICE / BK;
// the float32 instantiations (FLUSH) add the tensor cores' accumulator
// into a second f32 sum on the CUDA cores, rounded to nearest, every
// FLUSH_CHUNKS k-chunks (512 products, the fused family's K at width
// 512): the tensor cores' f32 accumulation errs with the length of its K
// and not at random (csrc/trunk_bwd.cuh's weight gradients cap their K
// for it), so a 12 x 2048 float32 product of K = 3 x 2,048 in one
// accumulator sat ~4x further from the exact twin than the 512 rows (gx
// 1.26e-4, measured on an H100)
constexpr int FLUSH_CHUNKS = 16;

enum {
  EPI_FWD, EPI_CHAIN, EPI_TAN, EPI_ADJ, EPI_WGRAD, EPI_PLAIN, EPI_LOGITS,
  EPI_HEADS
};
// the heads' logits: rgb x3, k, theta, rho_c (the packed columns 1..6)
constexpr int LOGITS = 6;
constexpr int HEAD_COLS = 8;

// The pointer slots and dimensions of an entry point's arguments, in the
// order of ops/trunk_layers.PTRS and DIMS.
enum {
  P_X, P_W0, P_W0_LO, P_W_MID, P_W_MID_LO, P_W_SKIP, P_W_SKIP_LO, P_B0,
  P_B_MID, P_B_SKIP, P_W_SIGMA, P_B_SIGMA, P_SIGMA, P_FEATS, P_GX, P_ZS,
  P_US, P_CS, P_CF, P_CG, P_DW0,
  P_DB0, P_DWM, P_DBM, P_DWST, P_DWSB, P_DBS, P_DWSIG, P_DBSIG, S_XS, S_CGS,
  S_H0, S_H1, S_D1, S_HS, S_THS, S_TZ, S_AZ0, S_AZ1, S_BTZ0, S_BTZ1,
  S_SPART, S_SPART2, S_ZSIG, S_CPART, S_DWSP, S_BSP, S_WPART, P_COT, P_OUT,
  P_WF, P_WF_LO, P_BF, P_W1, P_W1_LO, P_B1, P_W2, P_B2, P_DWF, P_DBF, P_DW1,
  P_DBW2, P_DB2, S_HPART, S_XF, S_AXF, S_CZ1, S_CFH, S_UC, S_HCP, S_B2P,
  N_PTR
};
enum {
  D_N, D_E, D_F, D_LAYERS, D_SKIP, D_SPLIT, D_BLOCK, D_FEATS_F32, D_SAVED_F32,
  D_WSLICES, N_DIM
};

// A product's K segment: C += A B over k, A (M x k) at a with leading
// dimension lda, B (k x N) at b with ldb, each in the kernel's layout.
struct Seg {
  const bf16* a;
  const bf16* b;
  long long lda, ldb;
  int k;
};

// Operand planes an epilogue writes: one (rounded to bf16) or two (the hi
// and lo terms of an f32 value, `plane` elements apart); n = 0 writes none.
struct Planes {
  bf16* p;
  long long plane;
  int ld, n;
};

// A tensor in the saved dtype (zs, us, feats): bf16, or f32 with f32 set.
struct Saved {
  void* p;
  int ld, f32;
};

struct Epi {
  float w0;                  // the activation's frequency at this layer
  const float* bias;         // FWD
  Planes o1, o2;             // FWD h; CHAIN g; TAN th, h; ADJ a_z, b_tz
  float* f_out;              // FWD act'(z); TAN tz
  int f_ld;
  Saved s1, s2;              // FWD zs, feats; CHAIN us
  const float* f_in;         // CHAIN act'(z) of the layer below; ADJ tz
  int f_in_ld;
  Saved z_in, u_in;          // TAN, ADJ: zs; ADJ: us (b_th)
  const float* wsig;         // the sigma head (its bf16-rounded values)
  float* sig1;               // row partials [N / BN][M]: h . w_sigma
  float* sig2;               // TAN: th . w_sigma
  int sig_round;             // round h (th) to bf16 first
  float* gx;                 // CHAIN: columns below gx_cols go to gx
  int gx_ld, gx_cols, gx_add;
  float* col_part;           // ADJ, PLAIN: column sums [M / BM][N];
                             // HEADS: [M / BM][4][N] (c_z1, dW_2 x3)
  float* part;               // WGRAD: [slices][M][N]
  const float* w2;           // LOGITS, HEADS: W_2 (LOGITS x N) f32
  const float* cot;          // HEADS: the logit cotangents (M x 8)
  int hid;                   // HEADS: the rgb block's columns (HID)
};

struct Gemm {
  Seg seg[MAXSEG];
  int nseg, M, N;
  Epi e;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(s)),
               "l"(g));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm4(uint32_t* r, const void* s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(s)));
}
__device__ __forceinline__ void ldsm4t(uint32_t* r, const void* s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(s)));
}
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two adjacent columns into operand planes.
__device__ __forceinline__ void put2(const Planes& o, size_t i, float x0,
                                     float x1) {
  const bf16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  *reinterpret_cast<__nv_bfloat162*>(o.p + i) = __halves2bfloat162(h0, h1);
  if (o.n == 2)
    *reinterpret_cast<__nv_bfloat162*>(o.p + o.plane + i) =
        __halves2bfloat162(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                           __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}
__device__ __forceinline__ void put1(const Planes& o, size_t i, float x) {
  const bf16 h = __float2bfloat16_rn(x);
  o.p[i] = h;
  if (o.n == 2) o.p[o.plane + i] = __float2bfloat16_rn(x - __bfloat162float(h));
}
__device__ __forceinline__ void store2(const Saved& s, size_t i, float a,
                                       float b) {
  if (s.f32)
    *reinterpret_cast<float2*>(static_cast<float*>(s.p) + i) =
        make_float2(a, b);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(s.p) + i) =
        __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load2(const Saved& s, size_t i) {
  if (s.f32) return *reinterpret_cast<const float2*>(
      static_cast<const float*>(s.p) + i);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      static_cast<const bf16*>(s.p) + i));
}
__device__ __forceinline__ float load1(const Saved& s, size_t i) {
  if (s.f32) return static_cast<const float*>(s.p)[i];
  return __bfloat162float(static_cast<const bf16*>(s.p)[i]);
}
__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

// C (M x N) = sum over the segments of A B, then the epilogue EPI.  AK: A
// is stored [M][K] (else [K][M]); BKM: B is stored [N][K] (else [K][N]);
// FLUSH: the sum taken in FLUSH_CHUNKS pieces (the float32 instantiations).
// Block (x, y, z) computes the output tile (rows y BM.., columns x BN..)
// over the whole K, or for EPI_WGRAD over slice z of SLICE_CHUNKS chunks.
// M and N are multiples of 128, every segment's k of 32.
template <int EPI, bool AK, bool BKM, bool FLUSH>
__global__ void __launch_bounds__(NT)
    layers_product_kernel(const __grid_constant__ Gemm p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  int total = 0;
  for (int s = 0; s < p.nseg; ++s) total += p.seg[s].k / BK;
  int c0 = 0, c1 = total;
  if (EPI == EPI_WGRAD) {
    c0 = blockIdx.z * SLICE_CHUNKS;
    c1 = min(total, c0 + SLICE_CHUNKS);
  }
  const int nch = c1 - c0;

  float acc[4][4][4], tot[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = tot[i][j][k] = 0.f;
  // tot += acc, acc = 0 (FLUSH)
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          tot[i][j][k] += acc[i][j][k];
          acc[i][j][k] = 0.f;
        }
  };

  auto load = [&](int stage, int c) {
    int s = 0;
    while (c >= p.seg[s].k / BK) {
      c -= p.seg[s].k / BK;
      ++s;
    }
    const Seg& g = p.seg[s];
    const int k = c * BK;
    bf16* sa = sm + stage * 2 * TILE;
    bf16* sb = sa + TILE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * NT;
      if constexpr (AK) {
        const int r = q >> 2, kc = (q & 3) * 8;
        cp16(sa + r * (BK + PAD) + kc,
             g.a + (size_t)(m0 + r) * g.lda + k + kc);
      } else {
        const int r = q >> 4, mc = (q & 15) * 8;
        cp16(sa + r * (BM + PAD) + mc,
             g.a + (size_t)(k + r) * g.lda + m0 + mc);
      }
      if constexpr (BKM) {
        const int r = q >> 2, kc = (q & 3) * 8;
        cp16(sb + r * (BK + PAD) + kc,
             g.b + (size_t)(n0 + r) * g.ldb + k + kc);
      } else {
        const int r = q >> 4, nc = (q & 15) * 8;
        cp16(sb + r * (BN + PAD) + nc,
             g.b + (size_t)(k + r) * g.ldb + n0 + nc);
      }
    }
  };

  auto compute = [&](int stage) {
    const bf16* sa = sm + stage * 2 * TILE;
    const bf16* sb = sa + TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfg[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int mb = wm * 64 + mi * 16;
        if constexpr (AK) {
          ldsm4(af[mi], sa + (mb + (lane & 15)) * (BK + PAD) + kk +
                            (lane >> 4) * 8);
        } else {
          const int j = lane >> 3;
          ldsm4t(af[mi], sa + (kk + (j >> 1) * 8 + (lane & 7)) * (BM + PAD) +
                             mb + (j & 1) * 8);
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int nb = wn * 32 + np * 16;
        uint32_t r[4];
        if constexpr (BKM) {
          ldsm4(r, sb + (nb + (lane >> 4) * 8 + (lane & 7)) * (BK + PAD) + kk +
                       ((lane >> 3) & 1) * 8);
        } else {
          ldsm4t(r, sb +
                        (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * (BN + PAD) +
                        nb + (lane >> 4) * 8);
        }
        bfg[2 * np][0] = r[0];
        bfg[2 * np][1] = r[1];
        bfg[2 * np + 1][0] = r[2];
        bfg[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af[mi], bfg[ni]);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nch) load(s, c0 + s);
    cp_commit();
  }
  for (int i = 0; i < nch; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nx = i + STAGES - 1;
    if (nx < nch) load(nx % STAGES, c0 + nx);
    cp_commit();
    compute(i % STAGES);
    if constexpr (FLUSH) {
      if ((i + 1) % FLUSH_CHUNKS == 0) flush();
    }
  }
  if constexpr (FLUSH) {
    flush();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = tot[i][j][k];
  }
  cp_wait<0>();
  __syncthreads();

  // ---------------------------------------------------------- epilogue
  const Epi& e = p.e;
  const int rq = lane >> 2, cq = (lane & 3) * 2;
  float rs1[8], rs2[8], cs[8], rl[LOGITS][8], cw[3][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    rs1[j] = rs2[j] = cs[j] = 0.f;
#pragma unroll
    for (int k = 0; k < LOGITS; ++k) rl[k][j] = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) cw[k][j] = 0.f;
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * 64 + mi * 16 + rq + h * 8;
        const int c = n0 + wn * 32 + ni * 8 + cq;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if constexpr (EPI == EPI_FWD) {
          const float z0 = v0 + e.bias[c], z1 = v1 + e.bias[c + 1];
          float h0, d0, h1, d1;
          act_eval(z0, e.w0, h0, d0);
          act_eval(z1, e.w0, h1, d1);
          if (e.o1.n) put2(e.o1, (size_t)r * e.o1.ld + c, h0, h1);
          if (e.f_out)
            *reinterpret_cast<float2*>(e.f_out + (size_t)r * e.f_ld + c) =
                make_float2(d0, d1);
          if (e.s1.p) store2(e.s1, (size_t)r * e.s1.ld + c, z0, z1);
          if (e.s2.p) store2(e.s2, (size_t)r * e.s2.ld + c, h0, h1);
          if (e.sig1) {
            const float a0 = e.sig_round ? rnd(h0) : h0;
            const float a1 = e.sig_round ? rnd(h1) : h1;
            rs1[mi * 2 + h] += a0 * e.wsig[c] + a1 * e.wsig[c + 1];
          }
        } else if constexpr (EPI == EPI_CHAIN) {
          if (c < e.gx_cols) {
            float2* g = reinterpret_cast<float2*>(e.gx + (size_t)r * e.gx_ld +
                                                  c);
            if (e.gx_add) {
              float2 o = *g;
              o.x += v0;
              o.y += v1;
              *g = o;
            } else {
              *g = make_float2(v0, v1);
            }
          } else {
            const int cc = c - e.gx_cols;
            if (e.s1.p) store2(e.s1, (size_t)r * e.s1.ld + cc, v0, v1);
            if (e.o1.n) {
              float2 d;
              if (e.z_in.p) {
                // act' of the layer below from its saved z (K5's chain)
                const float2 z = load2(e.z_in, (size_t)r * e.z_in.ld + cc);
                float hz;
                act_eval(z.x, e.w0, hz, d.x);
                act_eval(z.y, e.w0, hz, d.y);
              } else {
                d = *reinterpret_cast<const float2*>(
                    e.f_in + (size_t)r * e.f_in_ld + cc);
              }
              put2(e.o1, (size_t)r * e.o1.ld + cc, d.x * v0, d.y * v1);
            }
          }
        } else if constexpr (EPI == EPI_TAN) {
          const float2 z = load2(e.z_in, (size_t)r * e.z_in.ld + c);
          float h0, d0, h1, d1;
          act_eval(z.x, e.w0, h0, d0);
          act_eval(z.y, e.w0, h1, d1);
          const float t0 = d0 * v0, t1 = d1 * v1;
          if (e.o1.n) put2(e.o1, (size_t)r * e.o1.ld + c, t0, t1);
          if (e.o2.n) put2(e.o2, (size_t)r * e.o2.ld + c, h0, h1);
          *reinterpret_cast<float2*>(e.f_out + (size_t)r * e.f_ld + c) =
              make_float2(v0, v1);
          if (e.sig1) {
            const float w0 = e.wsig[c], w1 = e.wsig[c + 1];
            rs1[mi * 2 + h] += (e.sig_round ? rnd(h0) : h0) * w0 +
                               (e.sig_round ? rnd(h1) : h1) * w1;
            rs2[mi * 2 + h] += (e.sig_round ? rnd(t0) : t0) * w0 +
                               (e.sig_round ? rnd(t1) : t1) * w1;
          }
        } else if constexpr (EPI == EPI_ADJ) {
          const float2 z = load2(e.z_in, (size_t)r * e.z_in.ld + c);
          const float2 bth = load2(e.u_in, (size_t)r * e.u_in.ld + c);
          const float2 tz = *reinterpret_cast<const float2*>(
              e.f_in + (size_t)r * e.f_in_ld + c);
          float h0, d10, d20, h1, d11, d21;
          act_eval2(z.x, e.w0, h0, d10, d20);
          act_eval2(z.y, e.w0, h1, d11, d21);
          const float a0 = d10 * v0 + d20 * tz.x * bth.x;
          const float a1 = d11 * v1 + d21 * tz.y * bth.y;
          put2(e.o1, (size_t)r * e.o1.ld + c, a0, a1);
          put2(e.o2, (size_t)r * e.o2.ld + c, d10 * bth.x, d11 * bth.y);
          cs[ni * 2] += a0;
          cs[ni * 2 + 1] += a1;
        } else if constexpr (EPI == EPI_WGRAD) {
          *reinterpret_cast<float2*>(
              e.part + ((size_t)blockIdx.z * p.M + r) * p.N + c) =
              make_float2(v0, v1);
        } else if constexpr (EPI == EPI_PLAIN) {
          float z0 = v0, z1 = v1;
          if (e.bias) {
            z0 += e.bias[c];
            z1 += e.bias[c + 1];
          }
          if (e.o1.n) put2(e.o1, (size_t)r * e.o1.ld + c, z0, z1);
          if (e.f_out)
            *reinterpret_cast<float2*>(e.f_out + (size_t)r * e.f_ld + c) =
                make_float2(z0, z1);
          cs[ni * 2] += z0;
          cs[ni * 2 + 1] += z1;
        } else if constexpr (EPI == EPI_LOGITS) {
          float a0, d0, a1, d1;
          act_eval(v0 + e.bias[c], e.w0, a0, d0);
          act_eval(v1 + e.bias[c + 1], e.w0, a1, d1);
          if (e.sig_round) {
            a0 = rnd(a0);
            a1 = rnd(a1);
          }
#pragma unroll
          for (int j = 0; j < LOGITS; ++j)
            rl[j][mi * 2 + h] += a0 * e.w2[(size_t)j * p.N + c] +
                                 a1 * e.w2[(size_t)j * p.N + c + 1];
        } else {  // EPI_HEADS
          float a0, d0, a1, d1;
          act_eval(v0 + e.bias[c], e.w0, a0, d0);
          act_eval(v1 + e.bias[c + 1], e.w0, a1, d1);
          // c_z2 of the row (the cotangents of the six logits, rounded to
          // the products' operand dtype), c_z2 W_2 at both columns
          const float* cr = e.cot + (size_t)r * HEAD_COLS;
          float q[LOGITS], s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int j = 0; j < LOGITS; ++j) {
            q[j] = e.sig_round ? rnd(cr[1 + j]) : cr[1 + j];
            s0 += q[j] * e.w2[(size_t)j * p.N + c];
            s1 += q[j] * e.w2[(size_t)j * p.N + c + 1];
          }
          const float g0 = d0 * s0, g1 = d1 * s1;
          put2(e.o1, (size_t)r * e.o1.ld + c, g0, g1);
          cs[ni * 2] += g0;
          cs[ni * 2 + 1] += g1;
          if (e.sig_round) {
            a0 = rnd(a0);
            a1 = rnd(a1);
          }
          // dW_2: the rgb block against the rgb logits, the RPV blocks
          // against the RPV logits (c and c + 1 lie in one block)
          const int base = c < e.hid ? 0 : 3;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            cw[j][ni * 2] += a0 * q[base + j];
            cw[j][ni * 2 + 1] += a1 * q[base + j];
          }
        }
      }

  float* red = reinterpret_cast<float*>(smem);
  // row partials: the quad's 4 lanes, then the 4 column warps in order
  auto reduce_rows = [&](float(&rs)[8], float* out) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 1);
      rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 2);
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red[wn * BM + wm * 64 + (j >> 1) * 16 + rq + (j & 1) * 8] = rs[j];
    }
    __syncthreads();
    if (tid < BM)
      out[(size_t)blockIdx.x * p.M + m0 + tid] =
          ((red[tid] + red[BM + tid]) + red[2 * BM + tid]) + red[3 * BM + tid];
    __syncthreads();
  };
  // column partials: the 8 row lanes of each column, then the 2 row warps;
  // out[row tile * stride + column]
  auto reduce_cols = [&](float(&cv)[8], float* out, size_t stride) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cv[j] += __shfl_xor_sync(0xffffffffu, cv[j], 4);
      cv[j] += __shfl_xor_sync(0xffffffffu, cv[j], 8);
      cv[j] += __shfl_xor_sync(0xffffffffu, cv[j], 16);
    }
    if (rq == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red[wm * BN + wn * 32 + (j >> 1) * 8 + cq + (j & 1)] = cv[j];
    }
    __syncthreads();
    if (tid < BN)
      out[(size_t)blockIdx.y * stride + n0 + tid] = red[tid] + red[BN + tid];
    __syncthreads();
  };
  if ((EPI == EPI_FWD || EPI == EPI_TAN) && e.sig1) {
    reduce_rows(rs1, e.sig1);
    if (EPI == EPI_TAN) reduce_rows(rs2, e.sig2);
  }
  if constexpr (EPI == EPI_LOGITS) {
    // logit j's partials at sig1 + j (N / BN) M
#pragma unroll
    for (int j = 0; j < LOGITS; ++j)
      reduce_rows(rl[j], e.sig1 + (size_t)j * (p.N / BN) * p.M);
  }
  if (EPI == EPI_ADJ || (EPI == EPI_PLAIN && e.col_part))
    reduce_cols(cs, e.col_part, p.N);
  if constexpr (EPI == EPI_HEADS) {
    reduce_cols(cs, e.col_part, 4 * (size_t)p.N);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      reduce_cols(cw[j], e.col_part + (size_t)(j + 1) * p.N,
                  4 * (size_t)p.N);
  }
}

// f32 x -> bf16 planes: bf16(x), and with planes = 2 also bf16(x - hi).
__global__ void layers_split_kernel(const float* __restrict__ x,
                                    long long n, bf16* __restrict__ out,
                                    long long plane, int planes) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = x[i];
    const bf16 h = __float2bfloat16_rn(v);
    out[i] = h;
    if (planes == 2)
      out[plane + i] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
}

// out[c] (+)= sum over t of part[t][c], t in order: the deterministic
// reduction of every partial (the sigma head's rows: layers_sigma_finish).
__global__ void layers_colsum_kernel(const float* __restrict__ part,
                                     int ntiles, long long ncols,
                                     float* __restrict__ out,
                                     int accumulate) {
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       c < ncols; c += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < ntiles; ++t) s += part[(size_t)t * ncols + c];
    out[c] = accumulate ? out[c] + s : s;
  }
}

// zsig = sum of the row partials (+ b_sigma), sigma = softplus(zsig).
__global__ void layers_sigma_finish(const float* __restrict__ part,
                                    int nparts, int m, const float* bsig,
                                    float* zsig, float* sigma) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  float s = 0.f;
  for (int j = 0; j < nparts; ++j) s += part[(size_t)j * m + r];
  if (bsig) s += bsig[0];
  zsig[r] = s;
  if (sigma) sigma[r] = softplus(s);
}

// K2's seed of the reverse chain at the last layer: u = sigmoid(zsig)
// w_sigma (sigmoid rounded to bf16 with round), us, and g = act'(z) u,
// act'(z) read from d1 or, where z.p is set (K5's rebuilt chain), computed
// from the saved z at frequency w0.
__global__ void layers_k2_seed(int m, int F, const float* __restrict__ zsig,
                               const float* __restrict__ wsig, int round,
                               const float* __restrict__ d1, Saved z,
                               float w0, Saved us, Planes g) {
  const long long n2 = (long long)m * (F / 2);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n2;
       i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / (F / 2)), c = (int)(i % (F / 2)) * 2;
    float s = sigmoid(zsig[r]);
    if (round) s = rnd(s);
    const float u0 = s * wsig[c], u1 = s * wsig[c + 1];
    if (us.p) store2(us, (size_t)r * us.ld + c, u0, u1);
    float2 d;
    if (z.p) {
      const float2 zz = load2(z, (size_t)r * z.ld + c);
      float hz;
      act_eval(zz.x, w0, hz, d.x);
      act_eval(zz.y, w0, hz, d.y);
    } else {
      d = *reinterpret_cast<const float2*>(d1 + (size_t)r * F + c);
    }
    put2(g, (size_t)r * g.ld + c, d.x * u0, d.y * u1);
  }
}

// K4's packed logits of rows 0..m: [softplus(zsig), the six logits (the
// sum of their row partials [LOGITS][nparts][m] in order, + b2), 0].
__global__ void layers_heads_finish(const float* __restrict__ part,
                                    int nparts, int m,
                                    const float* __restrict__ zsig,
                                    const float* __restrict__ b2,
                                    float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  float* o = out + (size_t)r * HEAD_COLS;
  o[0] = softplus(zsig[r]);
  for (int j = 0; j < LOGITS; ++j) {
    float s = 0.f;
    for (int t = 0; t < nparts; ++t)
      s += part[((size_t)j * nparts + t) * m + r];
    o[1 + j] = s + b2[j];
  }
  o[HEAD_COLS - 1] = 0.f;
}

// part[t][c] = the sum of rows t BM .. (t + 1) BM - 1 of column c of x
// (m x ld, m a multiple of BM), in order: the per-tile sums of K5's logit
// cotangents (db_2), reduced over the tiles by layers_colsum_kernel.
__global__ void layers_tile_rows(const float* __restrict__ x, int ld,
                                 float* __restrict__ part) {
  const int c = threadIdx.x;
  if (c >= ld) return;
  const float* xt = x + (size_t)blockIdx.x * BM * ld + c;
  float s = 0.f;
  for (int i = 0; i < BM; ++i) s += xt[(size_t)i * ld];
  part[(size_t)blockIdx.x * ld + c] = s;
}

// K3's sigma head and its last layer (fused_trunk_vjp._trunk_bwd_plain's
// head cotangents, then _reverse_sweep's first step): per row zsig,
// tzsig, a_zsig = c_sigma sp1 + sp2 tzsig; per element a_h = a_zsig
// w_sigma + c_feats, a_z, b_tz, and the column partials of a_z (db),
// h^T a_zsig + th^T sp1 (dw_sigma), and per row tile the sum of a_zsig
// (db_sigma).
struct Head {
  int m, F, nparts, round, cf_f32;
  int cs_ld;                 // c_sigma's row stride (K5: the cotangents')
  const float* sp1;          // row partials of h . w_sigma
  const float* sp2;          // ... of th . w_sigma
  const float* bsig;
  const float* cs;
  const void* cf;
  const float* wsig;
  const float* tz;
  Saved z, u;
  float w0;
  Planes az, btz;
  float* db_part;            // [m / BM][F]
  float* dws_part;           // [m / BM][F]
  float* bs_part;            // [m / BM]
};

__global__ void __launch_bounds__(NT)
    layers_k3_head(const __grid_constant__ Head p) {
  __shared__ float s_az[BM], s_sp[BM];
  __shared__ float red[3][2][BN];
  const int t = threadIdx.x, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (t < BM) {
    const int r = m0 + t;
    float zs = 0.f, tzs = 0.f;
    for (int j = 0; j < p.nparts; ++j) {
      zs += p.sp1[(size_t)j * p.m + r];
      tzs += p.sp2[(size_t)j * p.m + r];
    }
    zs += p.bsig[0];
    const float s1 = sigmoid(zs), s2 = s1 * (1.f - s1);
    s_az[t] = p.cs[(size_t)r * p.cs_ld] * s1 + s2 * tzs;
    s_sp[t] = s1;
  }
  __syncthreads();
  if (blockIdx.x == 0 && t == 0) {
    float b = 0.f;
    for (int i = 0; i < BM; ++i) b += s_az[i];
    p.bs_part[blockIdx.y] = b;
  }
  const int cl = t & (BN - 1), half = t / BN, c = n0 + cl;
  const float ws = p.wsig[c];
  float db = 0.f, dw1 = 0.f, dw2 = 0.f;
  for (int i = 0; i < BM / 2; ++i) {
    const int rl = half * (BM / 2) + i, r = m0 + rl;
    const float az = p.round ? rnd(s_az[rl]) : s_az[rl];
    const float sp = p.round ? rnd(s_sp[rl]) : s_sp[rl];
    const size_t ix = (size_t)r * p.F + c;
    const float cf =
        p.cf_f32 ? static_cast<const float*>(p.cf)[ix]
                 : __bfloat162float(static_cast<const bf16*>(p.cf)[ix]);
    const float ah = az * ws + cf;
    float h, d1, d2;
    act_eval2(load1(p.z, (size_t)r * p.z.ld + c), p.w0, h, d1, d2);
    const float tz = p.tz[ix];
    const float bth = load1(p.u, (size_t)r * p.u.ld + c);
    const float a = d1 * ah + d2 * tz * bth;
    put1(p.az, ix, a);
    put1(p.btz, ix, d1 * bth);
    db += a;
    const float th = d1 * tz;
    dw1 += (p.round ? rnd(h) : h) * az;
    dw2 += (p.round ? rnd(th) : th) * sp;
  }
  red[0][half][cl] = db;
  red[1][half][cl] = dw1;
  red[2][half][cl] = dw2;
  __syncthreads();
  if (t < BN) {
    p.db_part[(size_t)blockIdx.y * p.F + n0 + t] = red[0][0][t] + red[0][1][t];
    p.dws_part[(size_t)blockIdx.y * p.F + n0 + t] =
        (red[1][0][t] + red[1][1][t]) + (red[2][0][t] + red[2][1][t]);
  }
}

// ------------------------------------------------------------------ host

// The packed trunk (ops/fused_mlp.pack_trunk_weights, padded): weights in
// (out, in) layout, hi and (float32) lo planes.
struct Trunk {
  int n, E, F, L, skip, split, B;
  const bf16* w0[2];
  const bf16* wm[2];
  const bf16* ws[2];
  const float *b0, *bm, *bs, *wsig, *bsig;
  Trunk(const long long* P, const int* D)
      : n(D[D_N]), E(D[D_E]), F(D[D_F]), L(D[D_LAYERS]), skip(D[D_SKIP]),
        split(D[D_SPLIT]), B(D[D_BLOCK]) {
    w0[0] = reinterpret_cast<const bf16*>(P[P_W0]);
    w0[1] = reinterpret_cast<const bf16*>(P[P_W0_LO]);
    wm[0] = reinterpret_cast<const bf16*>(P[P_W_MID]);
    wm[1] = reinterpret_cast<const bf16*>(P[P_W_MID_LO]);
    ws[0] = reinterpret_cast<const bf16*>(P[P_W_SKIP]);
    ws[1] = reinterpret_cast<const bf16*>(P[P_W_SKIP_LO]);
    b0 = reinterpret_cast<const float*>(P[P_B0]);
    bm = reinterpret_cast<const float*>(P[P_B_MID]);
    bs = reinterpret_cast<const float*>(P[P_B_SKIP]);
    wsig = reinterpret_cast<const float*>(P[P_W_SIGMA]);
    bsig = reinterpret_cast<const float*>(P[P_B_SIGMA]);
  }
  int mid(int i) const { return i < skip ? i - 1 : i - 2; }
  // layer i's weight plane pl from column col (null where absent)
  const bf16* w(int i, int pl, int col = 0) const {
    const bf16* b = i == 0 ? w0[pl] : i == skip ? ws[pl] : wm[pl];
    if (!b) return nullptr;
    if (i != 0 && i != skip) b += (size_t)mid(i) * F * F;
    return b + col;
  }
  int ldw(int i) const { return i == 0 ? E : i == skip ? E + F : F; }
  const float* bias(int i) const {
    return i == 0 ? b0 : i == skip ? bs : bm + (size_t)mid(i) * F;
  }
  bool ok() const {
    return n > 0 && n % BM == 0 && B % BM == 0 && B > 0 && E % BN == 0 &&
           F % BN == 0 && L >= 3 && skip > 0 && skip < L;
  }
};

// Append the products of A (planes a, a + ap) and B (b_hi, b_lo) over k:
// mode 1 A_hi B_hi (bf16 operands); 2 + A_lo B_hi (K1's f32 activations);
// 3 + A_lo B_hi + A_hi B_lo (float32: split3_mm).
void add(Gemm& g, const bf16* a, long long ap, long long lda, const bf16* bh,
         const bf16* bl, long long ldb, int k, int mode) {
  g.seg[g.nseg++] = Seg{a, bh, lda, ldb, k};
  if (mode >= 2) g.seg[g.nseg++] = Seg{a + ap, bh, lda, ldb, k};
  if (mode == 3) g.seg[g.nseg++] = Seg{a, bl, lda, ldb, k};
}

template <int EPI, bool AK, bool BKM>
int run(const Gemm& g, int slices, bool flush, cudaStream_t st) {
  auto k = flush ? layers_product_kernel<EPI, AK, BKM, true>
                 : layers_product_kernel<EPI, AK, BKM, false>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  k<<<dim3(g.N / BN, g.M / BM, slices), NT, SMEM, st>>>(g);
  return cudaGetLastError();
}

int blocks_for(long long n) {
  long long b = (n + 255) / 256;
  return (int)(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

int split_x(const float* x, long long n, bf16* out, long long plane,
            int planes, cudaStream_t st) {
  layers_split_kernel<<<blocks_for(n), 256, 0, st>>>(x, n, out, plane, planes);
  return cudaGetLastError();
}

int colsum(const float* part, int ntiles, long long ncols, float* out,
           int accumulate, cudaStream_t st) {
  layers_colsum_kernel<<<blocks_for(ncols), 256, 0, st>>>(
      part, ntiles, ncols, out, accumulate);
  return cudaGetLastError();
}

int finish(const float* part, int nparts, int m, const float* bsig,
           float* zsig, float* sigma, cudaStream_t st) {
  layers_sigma_finish<<<(m + 255) / 256, 256, 0, st>>>(part, nparts, m,
                                                       bsig, zsig, sigma);
  return cudaGetLastError();
}

#define CK(x)                 \
  do {                        \
    const int e_ = (x);       \
    if (e_) return e_;        \
  } while (0)

template <class T>
T* ptr(const long long* P, int i) {
  return reinterpret_cast<T*>(P[i]);
}

// The forward of one point block (rows b0.., m of them) from the input
// planes xs: every layer's product, its epilogue writing h into the ping-
// pong planes hb, and per layer `extra` filling the rest of the epilogue.
template <class Extra>
int forward(const Trunk& t, int m, const bf16* xs, bf16* hb[2], int h_planes,
            int mode, Extra extra, cudaStream_t st) {
  const long long xp = (long long)t.B * t.E, hp = (long long)t.B * t.F;
  int cur = 0;
  for (int i = 0; i < t.L; ++i) {
    Gemm g = {};
    g.M = m;
    g.N = t.F;
    if (i == 0 || i == t.skip)
      add(g, xs, xp, t.E, t.w(i, 0), t.w(i, 1), t.ldw(i), t.E, mode);
    if (i > 0) {
      const int col = i == t.skip ? t.E : 0;
      add(g, hb[cur], hp, t.F, t.w(i, 0, col), t.w(i, 1, col), t.ldw(i), t.F,
          mode);
    }
    g.e.w0 = i == 0 ? 30.f : 1.f;
    g.e.bias = t.bias(i);
    if (i < t.L - 1) g.e.o1 = Planes{hb[cur ^ 1], hp, t.F, h_planes};
    extra(g.e, i);
    CK((run<EPI_FWD, true, true>(g, 1, t.split, st)));
    cur ^= 1;
  }
  return 0;
}

// The heads' packed weights (ops/fused_trunk_heads.pack_head_weights at a
// layer-major width): W_f (F, F) and the merged first layers W_1 = [W_1r |
// W_1p] (4 HID = 2 F, F) in (out, in) layout, hi and (float32) lo planes;
// b_f, b_1 f32; W_2 (LOGITS, 2 F) f32, the second layers laid over the
// merged hidden columns (zeros off each head's block); b_2 (LOGITS,) f32.
struct Heads {
  const bf16* wf[2];
  const bf16* w1[2];
  const float *bf, *b1, *w2, *b2;
  explicit Heads(const long long* P) {
    wf[0] = reinterpret_cast<const bf16*>(P[P_WF]);
    wf[1] = reinterpret_cast<const bf16*>(P[P_WF_LO]);
    w1[0] = reinterpret_cast<const bf16*>(P[P_W1]);
    w1[1] = reinterpret_cast<const bf16*>(P[P_W1_LO]);
    bf = reinterpret_cast<const float*>(P[P_BF]);
    b1 = reinterpret_cast<const float*>(P[P_B1]);
    w2 = reinterpret_cast<const float*>(P[P_W2]);
    b2 = reinterpret_cast<const float*>(P[P_B2]);
  }
  bool ok() const { return wf[0] && w1[0] && bf && b1 && w2 && b2; }
};

// K2 (heads false): sigma, feats (saved dtype), gx (n, E) f32, and with
// zs/us non-null every layer's z and chain state u (n, L F, saved dtype).
// K4 (heads true): the packed logits out (n, 8) f32 in place of sigma and
// feats, gx, and with zs non-null zs (us is never written).
int fwd_grad(const long long* P, const int* D, void* stream, bool heads) {
  const Trunk t(P, D);
  const Heads hw(P);
  if (!t.ok() || (heads && !hw.ok())) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pl = t.split ? 2 : 1, mode = t.split ? 3 : 1;
  const int saved_f32 = D[D_SAVED_F32], feats_f32 = D[D_FEATS_F32];
  const float* x = ptr<const float>(P, P_X);
  float* sigma = ptr<float>(P, P_SIGMA);
  char* feats = ptr<char>(P, P_FEATS);
  float* gx = ptr<float>(P, P_GX);
  char* zs = ptr<char>(P, P_ZS);
  char* us = heads ? nullptr : ptr<char>(P, P_US);
  float* out = ptr<float>(P, P_OUT);
  bf16* xs = ptr<bf16>(P, S_XS);
  bf16* hb[2] = {ptr<bf16>(P, S_H0), ptr<bf16>(P, S_H1)};
  float* d1 = ptr<float>(P, S_D1);
  float* spart = ptr<float>(P, S_SPART);
  float* zsig = ptr<float>(P, S_ZSIG);
  float* hpart = ptr<float>(P, S_HPART);
  const int es = saved_f32 ? 4 : 2, fs = feats_f32 ? 4 : 2;
  const long long hp = (long long)t.B * t.F, LF = (long long)t.L * t.F;
  // the saved tensor's (rows b0.., layer i) start
  auto at = [&](char* base, int b0, int i) -> void* {
    return base ? base + ((size_t)b0 * LF + (size_t)i * t.F) * es : nullptr;
  };
  // K4: the last layer's h planes, then xf's, in the ping-pong buffers
  const int hl = t.L % 2;
  for (int b0 = 0; b0 < t.n; b0 += t.B) {
    const int m = t.n - b0 < t.B ? t.n - b0 : t.B;
    CK(split_x(x + (size_t)b0 * t.E, (long long)m * t.E, xs,
               (long long)t.B * t.E, pl, st));
    CK(forward(
        t, m, xs, hb, pl, mode,
        [&](Epi& e, int i) {
          e.f_out = d1 + (size_t)i * hp;
          e.f_ld = t.F;
          e.s1 = Saved{at(zs, b0, i), (int)LF, saved_f32};
          if (i < t.L - 1) return;
          if (feats)
            e.s2 = Saved{feats + (size_t)b0 * t.F * fs, t.F, feats_f32};
          if (heads) e.o1 = Planes{hb[hl], hp, t.F, pl};
          e.wsig = t.wsig;
          e.sig1 = spart;
          e.sig_round = !t.split;
        },
        st));
    CK(finish(spart, t.F / BN, m, t.bsig, zsig, heads ? nullptr : sigma + b0,
              st));
    if (heads) {
      // xf = h W_f^T + b_f, then z1 = xf W_1^T + b_1 with the logits' row
      // partials, then the packed logits
      Gemm gf = {};
      gf.M = m;
      gf.N = t.F;
      add(gf, hb[hl], hp, t.F, hw.wf[0], hw.wf[1], t.F, t.F, mode);
      gf.e.bias = hw.bf;
      gf.e.o1 = Planes{hb[hl ^ 1], hp, t.F, pl};
      CK((run<EPI_PLAIN, true, true>(gf, 1, t.split, st)));
      Gemm g1 = {};
      g1.M = m;
      g1.N = 2 * t.F;
      add(g1, hb[hl ^ 1], hp, t.F, hw.w1[0], hw.w1[1], t.F, t.F, mode);
      g1.e.w0 = 1.f;
      g1.e.bias = hw.b1;
      g1.e.w2 = hw.w2;
      g1.e.sig1 = hpart;
      g1.e.sig_round = !t.split;
      CK((run<EPI_LOGITS, true, true>(g1, 1, t.split, st)));
      layers_heads_finish<<<(m + 255) / 256, 256, 0, st>>>(
          hpart, 2 * t.F / BN, m, zsig, hw.b2, out + (size_t)b0 * HEAD_COLS);
      CK(cudaGetLastError());
    }
    layers_k2_seed<<<blocks_for((long long)m * t.F / 2), 256, 0, st>>>(
        m, t.F, zsig, t.wsig, !t.split, d1 + (size_t)(t.L - 1) * hp, Saved{},
        1.f, Saved{at(us, b0, t.L - 1), (int)LF, saved_f32},
        Planes{hb[0], hp, t.F, pl});
    CK(cudaGetLastError());
    int cur = 0;
    for (int i = t.L - 1; i >= 0; --i) {
      Gemm g = {};
      g.M = m;
      g.N = i == 0 ? t.E : i == t.skip ? t.E + t.F : t.F;
      add(g, hb[cur], hp, t.F, t.w(i, 0), t.w(i, 1), t.ldw(i), t.F, mode);
      Epi& e = g.e;
      e.gx = gx + (size_t)b0 * t.E;
      e.gx_ld = t.E;
      e.gx_cols = i == 0 ? t.E : i == t.skip ? t.E : 0;
      e.gx_add = i == 0;
      if (i > 0) {
        e.f_in = d1 + (size_t)(i - 1) * hp;
        e.f_in_ld = t.F;
        e.s1 = Saved{at(us, b0, i - 1), (int)LF, saved_f32};
        e.o1 = Planes{hb[cur ^ 1], hp, t.F, pl};
      }
      CK((run<EPI_CHAIN, true, false>(g, 1, t.split, st)));
      cur ^= 1;
    }
  }
  return 0;
}

// K3 (heads false): the packed weight gradients (in, out) of S =
// <c_sigma, sigma> + <c_feats, feats> + <c_g, gx> from x, c_sigma, c_feats
// (saved dtype or f32), c_g and the saved zs/us, summed over the point
// blocks in order.  K5 (heads true): from x, the logit cotangents cot (n,
// 8) f32, c_g and zs alone, the same trunk gradients with c_sigma = cot's
// column 0, c_feats the heads' a_xf W_f and us the b_th chain rebuilt from
// zs in f32, and the heads' gradients dW_f (F, F), db_f, dW_1 (F, 2 F),
// [db_1; dW_2] (4, 2 F) (dW_2's row j: logit column j of every hidden unit,
// the rgb logits' over the rgb block, the RPV logits' over the RPV blocks)
// and the cotangents' column sums (8,) (db_2 at 1..6).
int bwd(const long long* P, const int* D, void* stream, bool heads) {
  const Trunk t(P, D);
  const Heads hw(P);
  if (!t.ok() || (heads && !hw.ok())) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pl = t.split ? 2 : 1, mode = t.split ? 3 : 1;
  const int saved_f32 = D[D_SAVED_F32];
  const int cf_f32 = heads ? 1 : D[D_FEATS_F32];
  const int es = saved_f32 ? 4 : 2, cfs = cf_f32 ? 4 : 2;
  const float* x = ptr<const float>(P, P_X);
  const float* cs = ptr<const float>(P, P_CS);
  const char* cf = ptr<const char>(P, P_CF);
  const float* cg = ptr<const float>(P, P_CG);
  const float* cot = ptr<const float>(P, P_COT);
  char* zs = ptr<char>(P, P_ZS);
  char* us = ptr<char>(P, P_US);
  float* dw0 = ptr<float>(P, P_DW0);
  float* db0 = ptr<float>(P, P_DB0);
  float* dwm = ptr<float>(P, P_DWM);
  float* dbm = ptr<float>(P, P_DBM);
  float* dwst = ptr<float>(P, P_DWST);
  float* dwsb = ptr<float>(P, P_DWSB);
  float* dbs = ptr<float>(P, P_DBS);
  float* dwsig = ptr<float>(P, P_DWSIG);
  float* dbsig = ptr<float>(P, P_DBSIG);
  float* dwf = ptr<float>(P, P_DWF);
  float* dbf = ptr<float>(P, P_DBF);
  float* dw1 = ptr<float>(P, P_DW1);
  float* dbw2 = ptr<float>(P, P_DBW2);
  float* db2 = ptr<float>(P, P_DB2);
  bf16* xs = ptr<bf16>(P, S_XS);
  bf16* cgs = ptr<bf16>(P, S_CGS);
  bf16* hs = ptr<bf16>(P, S_HS);
  bf16* ths = ptr<bf16>(P, S_THS);
  float* tz = ptr<float>(P, S_TZ);
  bf16* az[2] = {ptr<bf16>(P, S_AZ0), ptr<bf16>(P, S_AZ1)};
  bf16* btz[2] = {ptr<bf16>(P, S_BTZ0), ptr<bf16>(P, S_BTZ1)};
  float* spart = ptr<float>(P, S_SPART);
  float* spart2 = ptr<float>(P, S_SPART2);
  float* zsig = ptr<float>(P, S_ZSIG);
  float* cpart = ptr<float>(P, S_CPART);
  float* dwsp = ptr<float>(P, S_DWSP);
  float* bsp = ptr<float>(P, S_BSP);
  float* wpart = ptr<float>(P, S_WPART);
  bf16* xf = ptr<bf16>(P, S_XF);
  bf16* axf = ptr<bf16>(P, S_AXF);
  bf16* cz1 = ptr<bf16>(P, S_CZ1);
  float* cfh = ptr<float>(P, S_CFH);
  float* uc = ptr<float>(P, S_UC);
  float* hcp = ptr<float>(P, S_HCP);
  float* b2p = ptr<float>(P, S_B2P);
  if (heads && !(cot && dwf && dbf && dw1 && dbw2 && db2 && xf && axf &&
                 cz1 && cfh && uc && hcp && b2p))
    return cudaErrorInvalidValue;
  const long long hp = (long long)t.B * t.F, xp = (long long)t.B * t.E;
  const long long LF = (long long)t.L * t.F;
  auto slot = [&](bf16* base, int i) { return base + (size_t)i * pl * hp; };
  auto saved = [&](char* base, int b0, int i) {
    return Saved{base + ((size_t)b0 * LF + (size_t)i * t.F) * es, (int)LF,
                 saved_f32};
  };
  // the b_th state of layer j: K3's saved us, K5's rebuilt chain (f32)
  auto bth = [&](int b0, int j) {
    return heads ? Saved{uc + (size_t)j * t.F, (int)LF, 1} : saved(us, b0, j);
  };
  auto db_of = [&](int i) {
    return i == 0 ? db0 : i == t.skip ? dbs : dbm + (size_t)t.mid(i) * t.F;
  };
  for (int b0 = 0; b0 < t.n; b0 += t.B) {
    const int m = t.n - b0 < t.B ? t.n - b0 : t.B;
    const int acc = b0 > 0;
    // the weight gradient out (+)= a1^T b1 (+ a2^T b2) over the block's
    // points: a (points x M, planes ap apart), b (points x N, bp apart)
    auto wgrad = [&](const bf16* a1, const bf16* b1, const bf16* a2,
                     const bf16* b2, long long ap, long long bp, int M, int N,
                     float* wout) -> int {
      Gemm g = {};
      g.M = M;
      g.N = N;
      add(g, a1, ap, M, b1, b1 + bp, N, m, mode);
      if (a2) add(g, a2, ap, M, b2, b2 + bp, N, m, mode);
      const int chunks = g.nseg * (m / BK);
      const int slices = (chunks + SLICE_CHUNKS - 1) / SLICE_CHUNKS;
      if (slices > D[D_WSLICES]) return cudaErrorInvalidValue;
      g.e.part = wpart;
      CK((run<EPI_WGRAD, false, false>(g, slices, t.split, st)));
      return colsum(wpart, slices, (long long)M * N, wout, acc, st);
    };
    CK(split_x(x + (size_t)b0 * t.E, (long long)m * t.E, xs, xp, pl, st));
    CK(split_x(cg + (size_t)b0 * t.E, (long long)m * t.E, cgs, xp, pl, st));
    // the tangent forward, seeded by t = c_g
    for (int i = 0; i < t.L; ++i) {
      Gemm g = {};
      g.M = m;
      g.N = t.F;
      if (i == 0 || i == t.skip)
        add(g, cgs, xp, t.E, t.w(i, 0), t.w(i, 1), t.ldw(i), t.E, mode);
      if (i > 0) {
        const int col = i == t.skip ? t.E : 0;
        add(g, slot(ths, i - 1), hp, t.F, t.w(i, 0, col), t.w(i, 1, col),
            t.ldw(i), t.F, mode);
      }
      Epi& e = g.e;
      e.w0 = i == 0 ? 30.f : 1.f;
      e.z_in = saved(zs, b0, i);
      e.f_out = tz + (size_t)i * hp;
      e.f_ld = t.F;
      if (i < t.L - 1) {
        e.o1 = Planes{slot(ths, i), hp, t.F, pl};
        e.o2 = Planes{slot(hs, i), hp, t.F, pl};
      } else {
        // K5: the last layer's h planes too, the heads' input
        if (heads) e.o2 = Planes{slot(hs, i), hp, t.F, pl};
        e.wsig = t.wsig;
        e.sig1 = spart;
        e.sig2 = spart2;
        e.sig_round = !t.split;
      }
      CK((run<EPI_TAN, true, true>(g, 1, t.split, st)));
    }
    if (heads) {
      // the b_th chain rebuilt from zs (fused_trunk_heads.uchain_plain):
      // zsig from the tangent forward's row partials of h, K2's seed, then
      // u_{i-1} = (act'(z_i) u_i) W_i, every u kept in f32
      CK(finish(spart, t.F / BN, m, t.bsig, zsig, nullptr, st));
      layers_k2_seed<<<blocks_for((long long)m * t.F / 2), 256, 0, st>>>(
          m, t.F, zsig, t.wsig, !t.split, nullptr, saved(zs, b0, t.L - 1),
          t.L - 1 == 0 ? 30.f : 1.f, bth(b0, t.L - 1),
          Planes{az[0], hp, t.F, pl});
      CK(cudaGetLastError());
      int cur = 0;
      for (int i = t.L - 1; i >= 1; --i) {
        const int col = i == t.skip ? t.E : 0;
        Gemm g = {};
        g.M = m;
        g.N = t.F;
        add(g, az[cur], hp, t.F, t.w(i, 0, col), t.w(i, 1, col), t.ldw(i),
            t.F, mode);
        Epi& e = g.e;
        e.s1 = bth(b0, i - 1);
        if (i > 1) {
          e.w0 = i - 1 == 0 ? 30.f : 1.f;
          e.z_in = saved(zs, b0, i - 1);
          e.o1 = Planes{az[cur ^ 1], hp, t.F, pl};
        }
        CK((run<EPI_CHAIN, true, false>(g, 1, t.split, st)));
        cur ^= 1;
      }
      // the heads: xf, then z1 with c_z1 and its column partials
      const bf16* hl = slot(hs, t.L - 1);
      Gemm gf = {};
      gf.M = m;
      gf.N = t.F;
      add(gf, hl, hp, t.F, hw.wf[0], hw.wf[1], t.F, t.F, mode);
      gf.e.bias = hw.bf;
      gf.e.o1 = Planes{xf, hp, t.F, pl};
      CK((run<EPI_PLAIN, true, true>(gf, 1, t.split, st)));
      Gemm g1 = {};
      g1.M = m;
      g1.N = 2 * t.F;
      add(g1, xf, hp, t.F, hw.w1[0], hw.w1[1], t.F, t.F, mode);
      g1.e.w0 = 1.f;
      g1.e.bias = hw.b1;
      g1.e.w2 = hw.w2;
      g1.e.cot = cot + (size_t)b0 * HEAD_COLS;
      g1.e.hid = t.F / 2;
      g1.e.sig_round = !t.split;
      g1.e.o1 = Planes{cz1, 2 * hp, 2 * t.F, pl};
      g1.e.col_part = hcp;
      CK((run<EPI_HEADS, true, true>(g1, 1, t.split, st)));
      CK(colsum(hcp, m / BM, 4LL * 2 * t.F, dbw2, acc, st));
      // dW_1 = xf^T c_z1; a_xf = c_z1 W_1 with its column sums (db_f);
      // dW_f = h^T a_xf; the seed a_xf W_f (f32, K3's c_feats)
      CK(wgrad(xf, cz1, nullptr, nullptr, hp, 2 * hp, t.F, 2 * t.F, dw1));
      Gemm ga = {};
      ga.M = m;
      ga.N = t.F;
      add(ga, cz1, 2 * hp, 2 * t.F, hw.w1[0], hw.w1[1], t.F, 2 * t.F, mode);
      ga.e.o1 = Planes{axf, hp, t.F, pl};
      ga.e.col_part = cpart;
      CK((run<EPI_PLAIN, true, false>(ga, 1, t.split, st)));
      CK(colsum(cpart, m / BM, t.F, dbf, acc, st));
      CK(wgrad(hl, axf, nullptr, nullptr, hp, hp, t.F, t.F, dwf));
      Gemm gc = {};
      gc.M = m;
      gc.N = t.F;
      add(gc, axf, hp, t.F, hw.wf[0], hw.wf[1], t.F, t.F, mode);
      gc.e.f_out = cfh;
      gc.e.f_ld = t.F;
      CK((run<EPI_PLAIN, true, false>(gc, 1, t.split, st)));
      // db_2: the cotangents' column sums, per row tile then in order
      layers_tile_rows<<<m / BM, 32, 0, st>>>(cot + (size_t)b0 * HEAD_COLS,
                                              HEAD_COLS, b2p);
      CK(cudaGetLastError());
      CK(colsum(b2p, m / BM, HEAD_COLS, db2, acc, st));
    }
    // the sigma head and the last layer's a_z, b_tz
    {
      Head h = {};
      h.m = m;
      h.F = t.F;
      h.nparts = t.F / BN;
      h.round = !t.split;
      h.cf_f32 = cf_f32;
      h.cs_ld = heads ? HEAD_COLS : 1;
      h.sp1 = spart;
      h.sp2 = spart2;
      h.bsig = t.bsig;
      h.cs = heads ? cot + (size_t)b0 * HEAD_COLS : cs + b0;
      h.cf = heads ? static_cast<const void*>(cfh)
                   : cf + (size_t)b0 * t.F * cfs;
      h.wsig = t.wsig;
      h.tz = tz + (size_t)(t.L - 1) * hp;
      h.z = saved(zs, b0, t.L - 1);
      h.u = bth(b0, t.L - 1);
      h.w0 = t.L - 1 == 0 ? 30.f : 1.f;
      h.az = Planes{az[0], hp, t.F, pl};
      h.btz = Planes{btz[0], hp, t.F, pl};
      h.db_part = cpart;
      h.dws_part = dwsp;
      h.bs_part = bsp;
      layers_k3_head<<<dim3(t.F / BN, m / BM), NT, 0, st>>>(h);
      CK(cudaGetLastError());
      CK(colsum(cpart, m / BM, t.F, db_of(t.L - 1), acc, st));
      CK(colsum(dwsp, m / BM, t.F, dwsig, acc, st));
      CK(colsum(bsp, m / BM, 1, dbsig, acc, st));
    }
    // the reverse sweep: each layer's weight gradient, then a_h below it
    int cur = 0;
    for (int i = t.L - 1; i >= 0; --i) {
      if (i == 0 || i == t.skip)
        CK(wgrad(xs, az[cur], cgs, btz[cur], xp, hp, t.E, t.F,
                 i == 0 ? dw0 : dwst));
      if (i == 0) break;
      CK(wgrad(slot(hs, i - 1), az[cur], slot(ths, i - 1), btz[cur], hp, hp,
               t.F, t.F,
               i == t.skip ? dwsb : dwm + (size_t)t.mid(i) * t.F * t.F));
      const int j = i - 1, col = i == t.skip ? t.E : 0;
      Gemm g = {};
      g.M = m;
      g.N = t.F;
      add(g, az[cur], hp, t.F, t.w(i, 0, col), t.w(i, 1, col), t.ldw(i), t.F,
          mode);
      Epi& e = g.e;
      e.w0 = j == 0 ? 30.f : 1.f;
      e.z_in = saved(zs, b0, j);
      e.u_in = bth(b0, j);
      e.f_in = tz + (size_t)j * hp;
      e.f_in_ld = t.F;
      e.o1 = Planes{az[cur ^ 1], hp, t.F, pl};
      e.o2 = Planes{btz[cur ^ 1], hp, t.F, pl};
      e.col_part = cpart;
      CK((run<EPI_ADJ, true, false>(g, 1, t.split, st)));
      CK(colsum(cpart, m / BM, t.F, db_of(j), acc, st));
      cur ^= 1;
    }
  }
  return 0;
}

}  // namespace trunk

using namespace trunk;

extern "C" {

const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// K1: sigma (and feats, f32) of x (n, E) f32.  Activations in f32 as two
// bf16 planes (hi, lo), each product two (bf16 weights) or three (float32)
// on the tensor cores, as the fused K1 (ops/fused_mlp._trunk_sigma_split).
int tl_sigma(const long long* P, const int* D, void* stream) {
  const Trunk t(P, D);
  if (!t.ok()) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = ptr<const float>(P, P_X);
  float* sigma = ptr<float>(P, P_SIGMA);
  float* feats = ptr<float>(P, P_FEATS);
  bf16* xs = ptr<bf16>(P, S_XS);
  bf16* hb[2] = {ptr<bf16>(P, S_H0), ptr<bf16>(P, S_H1)};
  float* spart = ptr<float>(P, S_SPART);
  float* zsig = ptr<float>(P, S_ZSIG);
  const int mode = t.split ? 3 : 2;
  for (int b0 = 0; b0 < t.n; b0 += t.B) {
    const int m = t.n - b0 < t.B ? t.n - b0 : t.B;
    CK(split_x(x + (size_t)b0 * t.E, (long long)m * t.E, xs,
               (long long)t.B * t.E, 2, st));
    CK(forward(
        t, m, xs, hb, 2, mode,
        [&](Epi& e, int i) {
          if (i < t.L - 1) return;
          if (feats) e.s2 = Saved{feats + (size_t)b0 * t.F, t.F, 1};
          e.wsig = t.wsig;
          e.sig1 = spart;
          e.sig_round = 0;
        },
        st));
    CK(finish(spart, t.F / BN, m, t.bsig, zsig, sigma + b0, st));
  }
  return 0;
}

// K2: sigma, feats (saved dtype), gx (n, E) f32, and with zs/us non-null
// every layer's z and chain state u (n, L F, saved dtype).
int tl_fwd_grad(const long long* P, const int* D, void* stream) {
  return fwd_grad(P, D, stream, false);
}

// K4: the packed logits (n, 8) f32, gx (n, E) f32 and, with zs non-null,
// zs (n, L F, saved dtype).
int tl_fwd_grad_heads(const long long* P, const int* D, void* stream) {
  return fwd_grad(P, D, stream, true);
}

// K3: the packed weight gradients (in, out) of the trunk, summed over the
// point blocks in order.
int tl_bwd(const long long* P, const int* D, void* stream) {
  return bwd(P, D, stream, false);
}

// K5: the trunk's and the heads' gradients from the logit cotangents, c_g
// and zs (the b_th chain rebuilt from zs).
int tl_bwd_heads(const long long* P, const int* D, void* stream) {
  return bwd(P, D, stream, true);
}

}  // extern "C"
