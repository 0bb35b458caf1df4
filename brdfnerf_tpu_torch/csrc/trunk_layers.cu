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
// The products: layers_product_kernel, a warp-specialised wgmma GEMM
// (bf16 operands, f32 accumulators, 128 x 128 output tiles, k-steps of
// 64): a producer thread loads A's and B's tiles by TMA into a 4-stage
// ring, one warpgroup runs wgmma m64n128k16 on them and hands its
// accumulators over through shared memory to two epilogue warpgroups, so
// that a tile's epilogue runs beside the next tile's products; the blocks
// are persistent (one an SM) and walk the output tiles.  A product
// is a list of K segments, each with its own tensor maps, so that the skip
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

#include "sm90_common.cuh"
#include "trunk_act.cuh"

namespace trunk {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128, BN = 128, BK = 64;  // a block's output tile and k step
// A k-step of 64 bf16 is one 128-byte row of the swizzled layout (SW128,
// sm90_common.cuh).  A ring stage holds A's tile, then B's (128 x 64 each,
// 16 KB), each as two 8 KB halves: the 64 rows of one m64 product
// (K-major) or one TMA box of 64 k x 64 m or n (MN-major).
constexpr int HALF = 64 * BK * 2;
constexpr int STAGE = 4 * HALF;             // 32 KB
constexpr int STAGES = 4;                   // the TMA ring
// A block: warpgroup 0 runs the products, warpgroup 1 loads the ring (one
// thread), warpgroups 2 and 3 run the epilogue.
constexpr int NT = 512;
// The accumulators go from the products' warpgroup to the epilogue's
// through a staging tile of BM rows of f32, SLD floats apart (8 of
// padding: the fragments' float2 stores take two wavefronts a warp).
constexpr int SLD = BN + 8;
constexpr int STG = BM * SLD * 4;
// the column partials' 4 quantities x 8 epilogue warps x BN floats
constexpr int RED = 4 * 8 * BN * 4;
// the ring, the staging tile, the partials, the ring's and the staging
// tile's barriers, and 1 KB to align the ring to the swizzle's 1,024 bytes
constexpr int SMEM = 1024 + STAGES * STAGE + STG + RED + (2 * STAGES + 2) * 8;
static_assert(SMEM <= 232448, "a block's shared memory");
constexpr int NT_HEAD = 256;                // layers_k3_head's threads
constexpr int MAXSEG = 6;
// points whose products one accumulator of the weight gradients sums: the
// f32 accumulation's error grows with K (ops/fused_trunk_vjp
// WGRAD_F32_CHUNKS: 128 chunks of 64 points)
constexpr int WG_SLICE = 8192;
constexpr int SLICE_CHUNKS = WG_SLICE / BK;
static_assert(WG_SLICE % BK == 0, "a slice is whole k-steps");
// the float32 instantiations (FLUSH) add the tensor cores' accumulator
// into a second f32 sum, rounded to nearest, every FLUSH_CHUNKS k-steps
// (512 products, the fused family's K at width 512): the tensor cores'
// f32 accumulation errs with the length of its K and not at random
// (csrc/trunk_bwd.cuh's weight gradients cap their K for it), so a 12 x
// 2048 float32 product of K = 3 x 2,048 in one accumulator sat ~4x
// further from the exact twin than the 512 rows (gx 1.26e-4, measured on
// an H100).  The second sum is the staging tile itself.
constexpr int FLUSH_CHUNKS = 8;
static_assert(FLUSH_CHUNKS * BK == 512, "the flush every 512 products");

enum {
  EPI_FWD, EPI_CHAIN, EPI_TAN, EPI_ADJ, EPI_WGRAD, EPI_PLAIN, EPI_LOGITS,
  EPI_HEADS,
  EPI_NONE   // writes nothing: the measurement build's (LAYERS_PROBE) bare
             // mainloop
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

// A launch's products as the kernel takes them: a TMA tensor map of each
// segment's A and B (boxes of 128 rows x 64 k K-major, of 64 k x 64 m or
// n MN-major), each segment's k-steps, the output tiles (row tiles x
// column tiles x split-K slices) and the epilogue's arguments.
struct Prod {
  CUtensorMap ma[MAXSEG], mb[MAXSEG];
  int chunks[MAXSEG];
  int nseg, M, N, tiles_m, tiles_n, tiles;
  int slice_chunks;          // k-steps of a split-K slice (or the whole K)
  Epi e;
};

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
// Four adjacent columns (i a multiple of 4) into operand planes.
__device__ __forceinline__ void put4(const Planes& o, size_t i,
                                     const float (&x)[4]) {
  __nv_bfloat162 h[2], l[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
    l[k] = __floats2bfloat162_rn(x[2 * k] - __low2float(h[k]),
                                 x[2 * k + 1] - __high2float(h[k]));
  }
  *reinterpret_cast<uint2*>(o.p + i) =
      make_uint2(*reinterpret_cast<uint32_t*>(&h[0]),
                 *reinterpret_cast<uint32_t*>(&h[1]));
  if (o.n == 2)
    *reinterpret_cast<uint2*>(o.p + o.plane + i) =
        make_uint2(*reinterpret_cast<uint32_t*>(&l[0]),
                   *reinterpret_cast<uint32_t*>(&l[1]));
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
__device__ __forceinline__ void store4(const Saved& s, size_t i,
                                       const float (&x)[4]) {
  if (s.f32) {
    *reinterpret_cast<float4*>(static_cast<float*>(s.p) + i) =
        make_float4(x[0], x[1], x[2], x[3]);
  } else {
    __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(static_cast<bf16*>(s.p) + i) =
        make_uint2(*reinterpret_cast<uint32_t*>(&a),
                   *reinterpret_cast<uint32_t*>(&b));
  }
}
__device__ __forceinline__ float2 load2(const Saved& s, size_t i) {
  if (s.f32) return *reinterpret_cast<const float2*>(
      static_cast<const float*>(s.p) + i);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      static_cast<const bf16*>(s.p) + i));
}
__device__ __forceinline__ void load4(const Saved& s, size_t i,
                                      float (&x)[4]) {
  if (s.f32) {
    const float4 v =
        *reinterpret_cast<const float4*>(static_cast<const float*>(s.p) + i);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    const uint2 v =
        *reinterpret_cast<const uint2*>(static_cast<const bf16*>(s.p) + i);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    x[0] = a.x;
    x[1] = a.y;
    x[2] = b.x;
    x[3] = b.y;
  }
}
__device__ __forceinline__ void ld4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void st4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ float load1(const Saved& s, size_t i) {
  if (s.f32) return static_cast<const float*>(s.p)[i];
  return __bfloat162float(static_cast<const bf16*>(s.p)[i]);
}
__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}
// Ask for the line holding p in L2 (the epilogue's inputs, while the
// products of their tile still run).
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}
// the sum over a warp's lanes, in a fixed order (every lane gets it)
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// C (M x N) = sum over the segments of A B, then the epilogue EPI.  AK: A
// is stored [M][K] (else [K][M]); BKM: B is stored [N][K] (else [K][N]);
// FLUSH: the sum taken in FLUSH_CHUNKS pieces (the float32 instantiations).
// M and N are multiples of 128, every segment's k of 64.
//
// Each block walks the output tiles blockIdx.x, + gridDim.x, ..., tile t
// being slice t / (tiles_m tiles_n) of the split-K weight gradients (else
// 0), then row tile, then column tile: the blocks in flight cover the
// column tiles of a few row tiles, so one layer's weights stay in L2 while
// the row tiles pass.  Three roles, each walking the same tiles:
//   * warpgroup 1, the producer: one thread walks the tiles' k-steps
//     through the segments and loads A's and B's tiles by TMA into a ring
//     of STAGES stages (full / empty mbarriers);
//   * warpgroup 0, the products: per k-step, for each 64-row half of the
//     tile, four wgmma m64n128k16 (acc[2][64]: thread t holds rows 16 (t /
//     32) + (t % 32) / 4 + 8 h of each half, columns 8 j + 2 (t % 4) +
//     {0, 1}, j < 16), then the accumulators into the staging tile (with
//     FLUSH, added into it every FLUSH_CHUNKS k-steps) and on to the next
//     tile;
//   * warpgroups 2 and 3, the epilogue: warp W takes the staging tile's
//     rows 16 W.. and lane l their columns 4 l..4 l + 3, so that each
//     warp's loads and stores run along rows of the outputs; row partials
//     are warp sums, column partials this lane's 16 rows, then the 8
//     warps in order.
// The staging tile is handed over by two mbarriers (sfull: written,
// sempty: read), so one tile's epilogue runs beside the next tile's
// products.
template <int EPI, bool AK, bool BKM, bool FLUSH>
__global__ void __launch_bounds__(NT, 1)
    layers_product_kernel(const __grid_constant__ Prod p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  float* stg = reinterpret_cast<float*>(smem + STAGES * STAGE);
  float* red = reinterpret_cast<float*>(smem + STAGES * STAGE + STG);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + STAGES * STAGE + STG + RED);
  uint64_t* empty = full + STAGES;
  uint64_t* sfull = empty + STAGES;
  uint64_t* sempty = sfull + 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::mbar_init(sfull, 128);
    sm90::mbar_init(sempty, 256);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  int total = 0;
  for (int s = 0; s < p.nseg; ++s) total += p.chunks[s];
  const int tiles_mn = p.tiles_m * p.tiles_n;
  const int wg = tid >> 7;

  if (wg == 1) {
    // ------------------------------------------------------------ producer
    sm90::setmaxnreg_dec<40>();
    if (tid != 128) return;
    uint32_t stage = 0, phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int rem = t % tiles_mn;
      const int m0 = (rem / p.tiles_n) * BM, n0 = (rem % p.tiles_n) * BN;
      const int c0 = (t / tiles_mn) * p.slice_chunks;
      const int c1 = min(total, c0 + p.slice_chunks);
      int s = 0, base = 0;   // the segment of k-step c, its first k-step
      for (int c = c0; c < c1; ++c) {
        while (c >= base + p.chunks[s]) base += p.chunks[s++];
        const int k = (c - base) * BK;
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * STAGE;
        uint64_t* f = &full[stage];
        sm90::mbar_expect_tx(f, STAGE);
        if constexpr (AK) {
          sm90::tma_load_2d(st, &p.ma[s], f, k, m0);
        } else {
          sm90::tma_load_2d(st, &p.ma[s], f, m0, k);
          sm90::tma_load_2d(st + HALF, &p.ma[s], f, m0 + 64, k);
        }
        if constexpr (BKM) {
          sm90::tma_load_2d(st + 2 * HALF, &p.mb[s], f, k, n0);
        } else {
          sm90::tma_load_2d(st + 2 * HALF, &p.mb[s], f, n0, k);
          sm90::tma_load_2d(st + 3 * HALF, &p.mb[s], f, n0 + 64, k);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  if (wg == 0) {
    // ------------------------------------------------------------ products
    sm90::setmaxnreg_inc<184>();
    const int lane = tid & 31, w = tid >> 5;
    const int rq = lane >> 2, cq = (lane & 3) * 2;
    uint32_t stage = 0, phase = 0, sphase = 0;
    float acc[2][64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
    // acc into (add: added to) the staging tile
    auto to_stage = [&](bool add) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* d = reinterpret_cast<float2*>(
                stg + (mi * 64 + 16 * w + rq + 8 * h) * SLD + 8 * j + cq);
            float2 v = make_float2(acc[mi][4 * j + 2 * h],
                                   acc[mi][4 * j + 2 * h + 1]);
            if (add) {
              const float2 o = *d;
              v.x += o.x;
              v.y += o.y;
            }
            *d = v;
          }
    };
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int c0 = (t / tiles_mn) * p.slice_chunks;
      const int nch = min(total, c0 + p.slice_chunks) - c0;
      // fresh: the next product overwrites acc (a tile's first, and with
      // FLUSH the first after each fold into the staging tile)
      bool fresh = true, folded = false;
      uint32_t prev = 0;
      for (int i = 0; i < nch; ++i) {
        sm90::mbar_wait(&full[stage], phase);
        const unsigned char* st = smem + stage * STAGE;
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          // K-major: 16 k a step is 32 bytes inside the 128-byte rows, 8
          // rows 1,024 bytes apart; MN-major: 16 k-rows of 128 bytes a
          // step, the 64-wide halves one box (HALF) apart
          const uint64_t db =
              BKM ? sm90::make_desc(st + 2 * HALF + ks * 32, 16, 1024, 1)
                  : sm90::make_desc(st + 2 * HALF + ks * 2048, HALF, 1024,
                                    1);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const uint64_t da =
                AK ? sm90::make_desc(st + mi * HALF + ks * 32, 16, 1024, 1)
                   : sm90::make_desc(st + mi * HALF + ks * 2048, HALF, 1024,
                                     1);
            sm90::wgmma_n128<AK ? 0 : 1, BKM ? 0 : 1>(
                acc[mi], da, db, (fresh && ks == 0) ? 0 : 1);
          }
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        if (i > 0 && tid == 0) sm90::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
        fresh = false;
        if constexpr (FLUSH) {
          if ((i + 1) % FLUSH_CHUNKS == 0 || i + 1 == nch) {
            // the staging tile += acc (= acc at the tile's first fold,
            // once the epilogue has read the last tile), then restart
            sm90::wgmma_wait<0>();
            sm90::fence_acc(acc[0]);
            sm90::fence_acc(acc[1]);
            if (!folded) {
              sm90::mbar_wait(sempty, sphase ^ 1);
              sphase ^= 1;
            }
            to_stage(folded);
            folded = true;
            fresh = true;
          }
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_acc(acc[0]);
      sm90::fence_acc(acc[1]);
      if (tid == 0) sm90::mbar_arrive(&empty[prev]);
      if constexpr (!FLUSH) {
        sm90::mbar_wait(sempty, sphase ^ 1);
        sphase ^= 1;
        to_stage(false);
      }
      sm90::mbar_arrive(sfull);
    }
    return;
  }

  // -------------------------------------------------------------- epilogue
  // 128 registers a thread at launch; the producer's 88 spare go to the
  // products' warpgroup (56) and here (16)
  sm90::setmaxnreg_inc<144>();
  const int et = tid - 256, W = et >> 5, lane = et & 31, cl = 4 * lane;
  const Epi& e = p.e;
  uint32_t sphase = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int z = t / tiles_mn, rem = t % tiles_mn;
    const int ty = rem / p.tiles_n, tx = rem % p.tiles_n;
    const int m0 = ty * BM, n0 = tx * BN, c = n0 + cl;
    // this lane's columns' constants
    float bias[4] = {0.f, 0.f, 0.f, 0.f}, ws[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (EPI == EPI_FWD || EPI == EPI_PLAIN || EPI == EPI_LOGITS ||
                  EPI == EPI_HEADS) {
      if (e.bias) ld4(e.bias + c, bias);
    }
    if constexpr (EPI == EPI_FWD || EPI == EPI_TAN) {
      if (e.sig1) ld4(e.wsig + c, ws);
    }
    // column partials: this lane's 4 columns over its warp's 16 rows
    float cs[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k) cs[q][k] = 0.f;
    // the inputs of this tile's epilogue into L2 while its products run
    // (K3's adjoint, which reads three, measured slower with it:
    // tools/product_share.py)
    if constexpr (EPI == EPI_TAN || EPI == EPI_CHAIN) {
      const int cc = EPI == EPI_CHAIN ? c - e.gx_cols : c;
      if (cc >= 0) {
        for (int i = 0; i < 16; ++i) {
          const size_t r = m0 + 16 * W + i;
          if (e.z_in.p)
            prefetch_l2(static_cast<const char*>(e.z_in.p) +
                        (r * e.z_in.ld + cc) * (e.z_in.f32 ? 4 : 2));
          if (EPI == EPI_CHAIN && e.f_in)
            prefetch_l2(e.f_in + r * e.f_in_ld + cc);
        }
      }
    }
    sm90::mbar_wait(sfull, sphase);
    sphase ^= 1;
    if constexpr (EPI == EPI_ADJ) {
      // K3's adjoint reads three inputs a row: four rows' loads go out
      // before their first store, which the compiler may not move loads
      // across (the outputs could alias them); 6% faster a product than a
      // row at a time (tools/product_share.py)
#pragma unroll 1
      for (int i0 = 0; i0 < 16; i0 += 4) {
        float v[4][4], zz[4][4], bth[4][4], tz[4][4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const size_t r = m0 + 16 * W + i0 + b;
          ld4(stg + (16 * W + i0 + b) * SLD + cl, v[b]);
          load4(e.z_in, r * e.z_in.ld + c, zz[b]);
          load4(e.u_in, r * e.u_in.ld + c, bth[b]);
          ld4(e.f_in + r * e.f_in_ld + c, tz[b]);
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const size_t r = m0 + 16 * W + i0 + b;
          float a[4], bt[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float h, d1, d2;
            act_eval2(zz[b][k], e.w0, h, d1, d2);
            a[k] = d1 * v[b][k] + d2 * tz[b][k] * bth[b][k];
            bt[k] = d1 * bth[b][k];
            cs[0][k] += a[k];
          }
          put4(e.o1, r * e.o1.ld + c, a);
          put4(e.o2, r * e.o2.ld + c, bt);
        }
      }
    } else {
#pragma unroll 8
      for (int i = 0; i < 16; ++i) {
        const int r = m0 + 16 * W + i;
        float v[4];
        ld4(stg + (16 * W + i) * SLD + cl, v);
        if constexpr (EPI == EPI_FWD) {
          float zv[4], h[4], d[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            zv[k] = v[k] + bias[k];
            act_eval(zv[k], e.w0, h[k], d[k]);
          }
          if (e.o1.n) put4(e.o1, (size_t)r * e.o1.ld + c, h);
          if (e.f_out) st4(e.f_out + (size_t)r * e.f_ld + c, d);
          if (e.s1.p) store4(e.s1, (size_t)r * e.s1.ld + c, zv);
          if (e.s2.p) store4(e.s2, (size_t)r * e.s2.ld + c, h);
          if (e.sig1) {
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              s += (e.sig_round ? rnd(h[k]) : h[k]) * ws[k];
            s = warp_sum(s);
            if (lane == 0) e.sig1[(size_t)tx * p.M + r] = s;
          }
        } else if constexpr (EPI == EPI_CHAIN) {
          if (c < e.gx_cols) {
            float* g = e.gx + (size_t)r * e.gx_ld + c;
            if (e.gx_add) {
              float o[4];
              ld4(g, o);
#pragma unroll
              for (int k = 0; k < 4; ++k) v[k] += o[k];
            }
            st4(g, v);
          } else {
            const int cc = c - e.gx_cols;
            if (e.s1.p) store4(e.s1, (size_t)r * e.s1.ld + cc, v);
            if (e.o1.n) {
              float d[4];
              if (e.z_in.p) {
                // act' of the layer below from its saved z (K5's chain)
                float zz[4], hz;
                load4(e.z_in, (size_t)r * e.z_in.ld + cc, zz);
#pragma unroll
                for (int k = 0; k < 4; ++k) act_eval(zz[k], e.w0, hz, d[k]);
              } else {
                ld4(e.f_in + (size_t)r * e.f_in_ld + cc, d);
              }
#pragma unroll
              for (int k = 0; k < 4; ++k) d[k] *= v[k];
              put4(e.o1, (size_t)r * e.o1.ld + cc, d);
            }
          }
        } else if constexpr (EPI == EPI_TAN) {
          float zz[4], h[4], d[4], th[4];
          load4(e.z_in, (size_t)r * e.z_in.ld + c, zz);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            act_eval(zz[k], e.w0, h[k], d[k]);
            th[k] = d[k] * v[k];
          }
          if (e.o1.n) put4(e.o1, (size_t)r * e.o1.ld + c, th);
          if (e.o2.n) put4(e.o2, (size_t)r * e.o2.ld + c, h);
          st4(e.f_out + (size_t)r * e.f_ld + c, v);
          if (e.sig1) {
            float s1 = 0.f, s2 = 0.f;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              s1 += (e.sig_round ? rnd(h[k]) : h[k]) * ws[k];
              s2 += (e.sig_round ? rnd(th[k]) : th[k]) * ws[k];
            }
            s1 = warp_sum(s1);
            s2 = warp_sum(s2);
            if (lane == 0) {
              e.sig1[(size_t)tx * p.M + r] = s1;
              e.sig2[(size_t)tx * p.M + r] = s2;
            }
          }
        } else if constexpr (EPI == EPI_WGRAD) {
          st4(e.part + ((size_t)z * p.M + r) * p.N + c, v);
        } else if constexpr (EPI == EPI_PLAIN) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[k] += bias[k];
            cs[0][k] += v[k];
          }
          if (e.o1.n) put4(e.o1, (size_t)r * e.o1.ld + c, v);
          if (e.f_out) st4(e.f_out + (size_t)r * e.f_ld + c, v);
        } else if constexpr (EPI == EPI_LOGITS) {
          float a[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float d;
            act_eval(v[k] + bias[k], e.w0, a[k], d);
            if (e.sig_round) a[k] = rnd(a[k]);
          }
#pragma unroll
          for (int q = 0; q < LOGITS; ++q) {
            float w2[4];
            ld4(e.w2 + (size_t)q * p.N + c, w2);
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < 4; ++k) s += a[k] * w2[k];
            s = warp_sum(s);
            if (lane == 0)
              e.sig1[((size_t)q * (p.N / BN) + tx) * p.M + r] = s;
          }
        } else if constexpr (EPI == EPI_HEADS) {
          // c_z2 of the row (the cotangents of the six logits, rounded to
          // the products' operand dtype), c_z2 W_2 at this lane's columns
          const float* cr = e.cot + (size_t)r * HEAD_COLS;
          float qv[LOGITS], a[4], d[4], s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < LOGITS; ++q)
            qv[q] = e.sig_round ? rnd(cr[1 + q]) : cr[1 + q];
#pragma unroll
          for (int q = 0; q < LOGITS; ++q) {
            float w2[4];
            ld4(e.w2 + (size_t)q * p.N + c, w2);
#pragma unroll
            for (int k = 0; k < 4; ++k) s[k] += qv[q] * w2[k];
          }
          float g[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            act_eval(v[k] + bias[k], e.w0, a[k], d[k]);
            g[k] = d[k] * s[k];
            cs[0][k] += g[k];
            if (e.sig_round) a[k] = rnd(a[k]);
          }
          put4(e.o1, (size_t)r * e.o1.ld + c, g);
          // dW_2: the rgb block against the rgb logits, the RPV blocks
          // against the RPV logits (the 4 columns lie in one block)
          const int base = c < e.hid ? 0 : 3;
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int k = 0; k < 4; ++k) cs[1 + q][k] += a[k] * qv[base + q];
        }
      }
    }
    // the staging tile is read: the products may fill it again
    sm90::mbar_arrive(sempty);
    // column partials out[row tile * stride + q N + column]: the 8 warps'
    // sums in order
    constexpr int NQ = EPI == EPI_HEADS ? 4
                       : (EPI == EPI_ADJ || EPI == EPI_PLAIN) ? 1 : 0;
    if constexpr (NQ > 0) {
      if (e.col_part) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) st4(red + (q * 8 + W) * BN + cl, cs[q]);
        sm90::named_sync(1, 256);
        if (et < BN) {
          const size_t stride = EPI == EPI_HEADS ? 4 * (size_t)p.N : p.N;
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const float* rd = red + q * 8 * BN + et;
            float s = rd[0];
#pragma unroll
            for (int x = 1; x < 8; ++x) s += rd[x * BN];
            e.col_part[ty * stride + (size_t)q * p.N + n0 + et] = s;
          }
        }
        sm90::named_sync(1, 256);
      }
    }
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

__global__ void __launch_bounds__(NT_HEAD)
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

// Launch one product: the segments' tensor maps (an error where
// cuTensorMapEncodeTiled refuses one) and a grid of one block an SM,
// each walking its tiles; plain (the measurement build's comparison,
// tools/product_share.py) launches a block a tile instead.
template <int EPI, bool AK, bool BKM, bool FLUSH>
int launch(const Gemm& g, int slices, bool plain, cudaStream_t st) {
  using sm90host::map_2d;
  static_assert(sizeof(Prod) <= 4096, "a launch's parameters");
  if (g.nseg < 1 || g.nseg > MAXSEG || g.M % BM || g.N % BN || slices < 1)
    return cudaErrorInvalidValue;
  Prod p = {};
  int total = 0;
  for (int s = 0; s < g.nseg; ++s) {
    const Seg& sg = g.seg[s];
    if (sg.k <= 0 || sg.k % BK) return cudaErrorInvalidValue;
    p.chunks[s] = sg.k / BK;
    total += p.chunks[s];
    const bool ok =
        (AK ? map_2d(&p.ma[s], sg.a, g.M, sg.k, sg.lda, BM, BK, 128)
            : map_2d(&p.ma[s], sg.a, sg.k, g.M, sg.lda, BK, 64, 128)) &&
        (BKM ? map_2d(&p.mb[s], sg.b, g.N, sg.k, sg.ldb, BN, BK, 128)
             : map_2d(&p.mb[s], sg.b, sg.k, g.N, sg.ldb, BK, 64, 128));
    if (!ok) return cudaErrorInvalidValue;
  }
  p.slice_chunks = slices > 1 ? SLICE_CHUNKS : total;
  if ((slices - 1) * p.slice_chunks >= total) return cudaErrorInvalidValue;
  p.nseg = g.nseg;
  p.M = g.M;
  p.N = g.N;
  p.tiles_m = g.M / BM;
  p.tiles_n = g.N / BN;
  p.tiles = p.tiles_m * p.tiles_n * slices;
  p.e = g.e;
  auto k = layers_product_kernel<EPI, AK, BKM, FLUSH>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  int grid = p.tiles;
  if (!plain) {
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
    if (grid > sms) grid = sms;
  }
  k<<<grid, NT, SMEM, st>>>(p);
  return cudaGetLastError();
}

template <int EPI, bool AK, bool BKM>
int run(const Gemm& g, int slices, bool flush, cudaStream_t st,
        bool plain = false) {
  return flush ? launch<EPI, AK, BKM, true>(g, slices, plain, st)
               : launch<EPI, AK, BKM, false>(g, slices, plain, st);
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
      layers_k3_head<<<dim3(t.F / BN, m / BM), NT_HEAD, 0, st>>>(h);
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

#ifdef LAYERS_PROBE
// Measurement only (tools/product_share.py builds the library with
// -DLAYERS_PROBE): one product of layer 2 over the first point block of a
// K3 call's arguments under epilogue epi (EPI_FWD, EPI_CHAIN, EPI_TAN,
// EPI_ADJ or EPI_WGRAD) with the operands and outputs the main path gives
// it, or with none set the same product under EPI_NONE, which writes
// nothing; with plain set on a grid of one block a tile instead of the
// SMs' worth of blocks walking the tiles.  The scratch's values are the
// caller's.
int product_probe(const long long* P, const int* D, int epi, int none,
                  int plain, cudaStream_t st) {
  const Trunk t(P, D);
  const int i = 2;
  if (!t.ok() || t.skip == i || t.skip == i - 1 || t.L < 4)
    return cudaErrorInvalidValue;
  const int pl = t.split ? 2 : 1, mode = t.split ? 3 : 1, m = t.B;
  const long long hp = (long long)t.B * t.F, LF = (long long)t.L * t.F;
  const int saved_f32 = D[D_SAVED_F32], es = saved_f32 ? 4 : 2;
  bf16* hs = ptr<bf16>(P, S_HS);
  bf16* ths = ptr<bf16>(P, S_THS);
  float* tz = ptr<float>(P, S_TZ);
  bf16* az[2] = {ptr<bf16>(P, S_AZ0), ptr<bf16>(P, S_AZ1)};
  bf16* btz[2] = {ptr<bf16>(P, S_BTZ0), ptr<bf16>(P, S_BTZ1)};
  auto slot = [&](bf16* base, int j) { return base + (size_t)j * pl * hp; };
  auto saved = [&](int slot_p, int j) {
    return Saved{ptr<char>(P, slot_p) + (size_t)j * t.F * es, (int)LF,
                 saved_f32};
  };
  Gemm g = {};
  g.M = m;
  g.N = t.F;
  Epi& e = g.e;
  e.w0 = 1.f;
  int slices = 1;
  if (epi == EPI_FWD || epi == EPI_TAN) {
    add(g, epi == EPI_FWD ? slot(hs, i - 1) : slot(ths, i - 1), hp, t.F,
        t.w(i, 0), t.w(i, 1), t.ldw(i), t.F, mode);
    e.f_out = tz + (size_t)i * hp;
    e.f_ld = t.F;
    if (epi == EPI_FWD) {
      e.bias = t.bias(i);
      e.o1 = Planes{slot(hs, i), hp, t.F, pl};
      e.s1 = saved(P_ZS, i);
    } else {
      e.z_in = saved(P_ZS, i);
      e.o1 = Planes{slot(ths, i), hp, t.F, pl};
      e.o2 = Planes{slot(hs, i), hp, t.F, pl};
    }
  } else if (epi == EPI_CHAIN || epi == EPI_ADJ) {
    add(g, az[0], hp, t.F, t.w(i, 0), t.w(i, 1), t.ldw(i), t.F, mode);
    e.f_in = tz + (size_t)(i - 1) * hp;
    e.f_in_ld = t.F;
    e.o1 = Planes{az[1], hp, t.F, pl};
    if (epi == EPI_CHAIN) {
      e.s1 = saved(P_US, i - 1);
    } else {
      e.z_in = saved(P_ZS, i - 1);
      e.u_in = saved(P_US, i - 1);
      e.o2 = Planes{btz[1], hp, t.F, pl};
      e.col_part = ptr<float>(P, S_CPART);
    }
  } else if (epi == EPI_WGRAD) {
    g.M = t.F;
    add(g, slot(hs, i - 1), hp, t.F, az[0], az[0] + hp, t.F, m, mode);
    add(g, slot(ths, i - 1), hp, t.F, btz[0], btz[0] + hp, t.F, m, mode);
    const int chunks = g.nseg * (m / BK);
    slices = (chunks + SLICE_CHUNKS - 1) / SLICE_CHUNKS;
    if (slices > D[D_WSLICES]) return cudaErrorInvalidValue;
    e.part = ptr<float>(P, S_WPART);
  } else {
    return cudaErrorInvalidValue;
  }
  const bool ak = epi != EPI_WGRAD, bkm = epi == EPI_FWD || epi == EPI_TAN;
  if (none) {
    if (ak && bkm)
      return run<EPI_NONE, true, true>(g, slices, t.split, st, plain);
    if (ak) return run<EPI_NONE, true, false>(g, slices, t.split, st, plain);
    return run<EPI_NONE, false, false>(g, slices, t.split, st, plain);
  }
  switch (epi) {
    case EPI_FWD:
      return run<EPI_FWD, true, true>(g, slices, t.split, st, plain);
    case EPI_TAN:
      return run<EPI_TAN, true, true>(g, slices, t.split, st, plain);
    case EPI_CHAIN:
      return run<EPI_CHAIN, true, false>(g, slices, t.split, st, plain);
    case EPI_ADJ:
      return run<EPI_ADJ, true, false>(g, slices, t.split, st, plain);
    default:
      return run<EPI_WGRAD, false, false>(g, slices, t.split, st, plain);
  }
}
#endif

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

#ifdef LAYERS_PROBE
int tl_product_probe(const long long* P, const int* D, int epi, int none,
                     int plain, void* stream) {
  return product_probe(P, D, epi, none, plain,
                       static_cast<cudaStream_t>(stream));
}
#endif

}  // extern "C"
