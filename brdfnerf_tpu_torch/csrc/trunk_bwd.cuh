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
// with z_l loaded from what the forward saved (zs) and b_th_l: K3 loads
// u_l, which K2 saved (us, bf16); K5 rebuilds the chain from zs in f32, as
// the Pallas _bwd_kernel_h does (trunk_heads_bwd.cu).
// K3 seeds the last layer's a_h with c_feats; K5 with a_xf W_f, from the
// heads' backward (ops/fused_trunk_heads.py):
//     c_z1 = act'(z1) (c_z2 W_2),   a_xf = c_z1r W_1r + c_z1p W_1p,
//     dW_2 = h1^T c_z2,  dW_1 = xf^T c_z1,  dW_f = h_{L-1}^T a_xf.
//
// What bounds them on the H100.  Their bound is tensor-core operations
// (K3 15.05 MFLOP a point against ~18 KB of input, 1.995 ms at the
// training step's 131,072 points), but what holds the sweep back is memory
// traffic: a 64-point tile streams the trunk's 7.4 MB of weight slices from
// L2 twice over (64 FLOP a weight byte), and its epilogues move ~5.4 MB a
// tile through device memory (zs twice, us, the f32 tz round trip, the
// bf16 operands of the weight gradients), ~11 GB a call, 3.3 ms at
// 3.35 TB/s.  The weight gradients read ~4.3 GB of bf16 operands (K5
// ~5 GB), 1.3 ms at that rate.
//
// Design (sm90_common.cuh for the building blocks, sm90_trunk.cuh for the
// warp roles, the ring and the products, shared with K2/K4): three
// kernels, all deterministic (fixed summation orders, no atomics).
//   1. sweep: a persistent grid, one 64-point tile at a time per block of
//      three warpgroups.  A producer warp streams, in the order the
//      consumers need them, every weight slice of the tile's products (TMA;
//      K-major boxes for the forward products, MN-major boxes for the
//      reverse a_h = a_z W, so no operand is transposed by the threads) and
//      every epilogue's saved data (zs and us in 64 x 64 boxes, K5's rebuilt
//      b_th in 32 KB bulk copies) through one ring of four 32 KB stages,
//      running ahead across epilogues and tiles: the epilogues read shared
//      memory, and their device-memory traffic overlaps the products.  Two
//      consumer warpgroups each own F / 2 of the F output columns of every
//      product (at width 512: wgmma m64n256k16, 128 f32 accumulators a
//      thread, setmaxnreg 232) and read A from one 64 x F activation tile kept K-major with the
//      128-byte swizzle, which the epilogues write in that layout; th_l,
//      a_z_l, h_l and b_tz_l leave by TMA stores of the tile.  tz_l goes to
//      a per-block f32 scratch and each thread reads its own elements back
//      in the reverse sweep: recomputing it there would keep a_h and tz (256
//      accumulators a thread) or a 128 KB f32 tile live at once.  (Through
//      the ring, as a bulk copy of what the consumers had just stored, two
//      launches at 131,072 points once differed in a stage's last column
//      group; a thread reading its own writes needs no proxy fence, no
//      barrier and no ring stage.)  The sweep writes the
//      bf16 operands of every weight-gradient product (the Pallas _outer
//      rounds exactly these to bf16, so nothing is lost), per-tile column
//      sums in f32 (the biases, the sigma head's dW, and for K5 the heads'
//      3-column second layers), and the sigma head's per-tile db.
//   2. wgrad: dW = [h; th]^T [a_z; b_tz] (K = 2 x points; the heads'
//      K = points) in 128 x min(F, 256) output tiles, each K axis cut into
//      contiguous slices of whole 64-point chunks (the plan from
//      ops/fused_trunk_vjp.wgrad_splits: K3 takes 2, one wave of 120
//      blocks).  A producer warp feeds a four-stage TMA ring with MN-major
//      boxes of both operands (both lie point-major), two consumer
//      warpgroups run wgmma, and each block writes its f32 partial tile.
//   3. reduce: sums each output tile's slice partials in slice order, and
//      the sweep's per-tile column partials in tile order.
// A 2-CTA cluster multicasting every weight slice to both was measured
// slower (PERF.md): each ring slot then waits on both CTAs' warps.
// Rows beyond the caller's points carry zero cotangents and add exactly 0.

#pragma once

#include "sm90_trunk.cuh"

namespace trunk {

// per-tile partials of K5's heads, after K3's (layers + 1) x F: db_f,
// db_1 (rgb | rpv), dW_2 for the 3 logit columns over the 4 x HID hidden
// units of [rgb | k | theta | rho_c], db_2 (6, padded to 8); the layout of
// ops/fused_trunk_heads.head_part(F)
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
  const bf16* us;          // K3: u_l as K2 saved them
  const float* zsf;        // ZF32: zs and (K3) us in f32
  const float* usf;
  const float* uc;         // K5: the rebuilt b_th chain (trunk_heads_bwd.cu)
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
  const void* w2r;         // bf16, or f32 with split
  const bf16* w1p;
  const float* b1p;
  const void* w2p;
  // scratch
  bf16* xt;
  bf16* hth;
  bf16* azbtz;
  float* part;
  float* pbs;
  float* tzsc;
  float* wpart;            // the weight-gradient blocks' partial tiles
  bf16* hl;                // K5: h_{L-1}, xf, a_xf (n, 512), c_z1 (n, 1024)
  bf16* xfb;
  bf16* axf;
  bf16* cz1;
  // outputs, f32, (in, out) layout
  float *dw0, *db0, *dwm, *dbm, *dwst, *dwsb, *dbs, *dwsig, *dbsig;
  float *dwf, *dbf, *dw1, *db1, *dw2r, *db2r, *dw2p, *db2p;
  int layers, skip;
  int splits_trunk, splits_heads;   // K slices per weight-gradient tile
  int wpart_tiles;                  // partial tiles wpart holds
  int split;                        // float32: the SPLIT instantiation
};

// two bf16 of a read-only input (c_feats) through the non-coherent path
__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// float4s of tz a consumer thread loads ahead in the reverse epilogue
constexpr int TZB = 4;

// The epilogues' zs and us (K5: zs and b_th) come through the ring (below).
// BWD_NO_EPILOGUE_LOADS (measurement only, never built by the package;
// tools/bwd_variants.py) loads none of them and reads constants instead,
// so that the time the epilogues spend on their data can be read off (tz,
// which each thread reads back from its own scratch, stays).
#ifdef BWD_NO_EPILOGUE_LOADS
constexpr bool EPI_DATA = false;
__device__ __forceinline__ float2 stage_bf2(const unsigned char*) {
  return make_float2(0.5f, -0.25f);
}
__device__ __forceinline__ float stage_f32(const unsigned char*) {
  return 0.125f;
}
__device__ __forceinline__ float2 glob_f2(const float*) {
  return make_float2(0.5f, -0.25f);
}
#else
constexpr bool EPI_DATA = true;
__device__ __forceinline__ float2 stage_bf2(const unsigned char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float stage_f32(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}
// ZF32: two f32 of zs or us straight from device memory
__device__ __forceinline__ float2 glob_f2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
#endif

// Sum a column partial over the 8 row groups of a warp's 16 rows (lanes
// sharing a column differ in lane bits 2..4); lanes 0..3 get the sums.
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// ================================================================== sweep

// (the block's warp roles, the ring and the products: sm90_trunk.cuh)
// shared memory: the activation tile (64 x F, F / 64 blocks), the tile of
// t = c_g (64 x 128; K5: 64 x 256, the c_z1 chunk once the tangent forward
// is done; both double as reduction space), with SPLIT both again for the
// lo terms (sm_lo bytes past the hi ones), the ring (weight slices and the
// epilogues' data: four stages, SPLIT two), then barriers and per-row
// vectors.  K5 SPLIT keeps K3's 64 x 128 t tile (a 64 x 256 one with its lo
// terms is 32 KB over the limit beside the ring): its c_z1 leaves from the
// registers and comes back in chunks of at most 128 columns, hi and lo
// (head_kh, cz1_regs below)
constexpr int SM_ACT = 0;
constexpr int SM_TS = SM_ACT + FA * ACT_BLOCK;
template <bool SPLIT>
__host__ __device__ constexpr int sm_lo() {
  return SPLIT ? (FA + 2) * ACT_BLOCK : 0;
}
template <bool SPLIT>
__host__ __device__ constexpr int sm_ring_n() {
  return SPLIT ? 2 : RING_N;
}
template <bool HEADS, bool SPLIT = false>
__host__ __device__ constexpr int sm_ring() {
  return SM_TS + (HEADS && !SPLIT ? 4 : 2) * ACT_BLOCK + sm_lo<SPLIT>();
}
template <bool HEADS, bool SPLIT = false>
__host__ __device__ constexpr int sm_bar() {
  return sm_ring<HEADS, SPLIT>() + sm_ring_n<SPLIT>() * RING_STAGE;
}
template <bool HEADS, bool SPLIT = false>
__host__ __device__ constexpr int sm_rows() {
  return sm_bar<HEADS, SPLIT>() + 128;
}
template <bool HEADS, bool SPLIT = false>
__host__ __device__ constexpr int sweep_smem() {
  return sm_rows<HEADS, SPLIT>() + 2 * T * 4 +
         (HEADS ? T * HEAD_COLS * 4 : 0);
}
static_assert(sweep_smem<true>() <= 232448, "K5 sweep's shared memory");
static_assert(sweep_smem<true, true>() <= 232448,
              "K5 SPLIT sweep's shared memory");
static_assert(4 * 2 * 4 * HWG * 4 <= 2 * ACT_BLOCK, "K5's column sums in t");

// K5's a_xf reloads c_z1 one chunk of KH columns at a time, in 64-column
// TMA boxes, as the A operand of its products: a head's HID columns in
// the 4-block t tile, with SPLIT (hi and lo tiles of 2 blocks each) in
// halves where HID is 256.  At width 64 a chunk (32 columns) is narrower
// than a box: the box brings the next head's columns beside it (zeros past
// the last), which no product reads.
template <bool SPLIT>
__host__ __device__ constexpr int head_kh() {
  return HID < (SPLIT ? 128 : 256) ? HID : (SPLIT ? 128 : 256);
}
// c_z1 leaves by plain stores from the registers (then every chunk is
// reloaded) with SPLIT, whose t tile has no room for a whole head beside
// its lo terms, and at width 64, where a head's 32 columns are narrower
// than a TMA box; otherwise by TMA stores from the t tile (whose last head
// stays there as the first chunk)
template <bool SPLIT>
__host__ __device__ constexpr bool cz1_regs() {
  return SPLIT || HID < 64;
}

// The weight tensors the sweep streams, as TMA maps: K-major boxes (32 k x
// BOX_N n rows) for the forward products, MN-major boxes (32 n x 32 k) for
// the reverse ones; zs and us (boxes of 64 rows x 64 columns, SW128); and
// the bf16 outputs it stores from the activation or chunk tile (boxes of
// 64 x 64, SW128).
struct SweepMaps {
  CUtensorMap w0k, wmidk, wskipk, wmidm, wskipm, zs, us;
  CUtensorMap hth, azbtz;
  CUtensorMap wfk, wfm, w1rk, w1pk, w1rm, w1pm;   // K5
  CUtensorMap hl, xfb, axf, cz1;                  // K5
};

// The epilogues read their data in j-groups: JG columns of each
// warpgroup (JJ consecutive j of its accumulators 4j..4j+3), as 64 x 64
// boxes (SW128), one per warpgroup (ZB = 2), or at width 64, where a
// warpgroup owns 32 columns, one box for both (ZB = 1, the warpgroup's
// columns from zc_of(wg) in it); NJG j-groups a warpgroup, JPS of them in
// a forward epilogue's stage.  At width 512: 64 columns, 4 j-groups, 2 a
// stage.
constexpr int JG = NWG < 64 ? NWG : 64;
constexpr int JJ = JG / 8;
constexpr int ZB = NWG < 64 ? 1 : 2;
constexpr int NJG = NWG / JG;
constexpr int JPS = NJG < 2 ? NJG : 2;
// a warpgroup's box in a j-group, and its first column in that box
__device__ __forceinline__ int zb_of(int wg) { return ZB == 2 ? wg : 0; }
__device__ __forceinline__ int zc_of(int wg) { return ZB == 2 ? 0 : wg * NWG; }
// K5: the bytes of a j-group's rebuilt b_th (JG / 2 accumulators of each
// of the 256 consumer threads, f32), one ring stage
constexpr int UC_STAGE = JG / 2 * NC * 4;
static_assert(UC_STAGE <= RING_STAGE, "a j-group's b_th in a stage");

// Producer: the ring stages of an epilogue's data, in j-groups.  Forward
// epilogue of layer i: z of the tile's 64 rows, JPS j-groups a stage, both
// warpgroups' boxes side by side.  Reverse epilogue: for every j-group a
// stage of z and u (K5: z alone), then (K5) a stage of the rebuilt b_th of
// layer i (ucl: NWG / 2 accumulators x 256 threads f32, the j-group's JG / 2
// of them a stage, UC_STAGE bytes: 32 KB, 16 KB at width 64).
// K5's z stage fills only part of its 32 KB (ZB 64 x 64 bf16 blocks):
// rebuilding b_th inside the sweep would drop the chain kernel, its f32
// scratch and this extra stage (not done).
template <class R>
__device__ __forceinline__ void produce_fwd_data(const SweepMaps& maps,
                                                 int i, int row0, R& r,
                                                 uint64_t* full,
                                                 uint64_t* empty,
                                                 unsigned char* ring) {
  for (int s = 0; s < NJG / JPS; ++s) {
    sm90::mbar_wait(&empty[r.stage], r.phase ^ 1);
    unsigned char* st = ring + r.stage * RING_STAGE;
    sm90::mbar_expect_tx(&full[r.stage], JPS * ZB * ACT_BLOCK);
    for (int b = 0; b < JPS * ZB; ++b)   // j-group JPS s + b / ZB, box b % ZB
      sm90::tma_load_2d(st + b * ACT_BLOCK, &maps.zs, &full[r.stage],
                        i * F + (b % ZB) * NWG + 64 * (JPS * s + b / ZB),
                        row0);
    r.advance();
  }
}

template <bool HEADS, class R>
__device__ __forceinline__ void produce_rev_data(const SweepMaps& maps,
                                                 const float* ucl, int i,
                                                 int row0, R& r,
                                                 uint64_t* full,
                                                 uint64_t* empty,
                                                 unsigned char* ring) {
  for (int g = 0; g < NJG; ++g) {
    sm90::mbar_wait(&empty[r.stage], r.phase ^ 1);
    unsigned char* st = ring + r.stage * RING_STAGE;
    sm90::mbar_expect_tx(&full[r.stage], (HEADS ? 1 : 2) * ZB * ACT_BLOCK);
    for (int b = 0; b < (HEADS ? 1 : 2) * ZB; ++b)   // z boxes, then u's
      sm90::tma_load_2d(st + b * ACT_BLOCK, b < ZB ? &maps.zs : &maps.us,
                        &full[r.stage], i * F + (b % ZB) * NWG + 64 * g,
                        row0);
    r.advance();
    if (HEADS) {
      sm90::mbar_wait(&empty[r.stage], r.phase ^ 1);
      sm90::mbar_expect_tx(&full[r.stage], UC_STAGE);
      sm90::bulk_load(ring + r.stage * RING_STAGE,
                      ucl + (size_t)g * (JG / 2) * NC, UC_STAGE,
                      &full[r.stage]);
      r.advance();
    }
  }
}

// Column sums over the tile's rows: red holds [4 warps][NW] floats per
// warpgroup, filled by the caller's col_sum lanes; the consumers sum the
// warps in order and write out[wg * NW + c].
template <int NW>
__device__ __forceinline__ void col_finish(const float* red, float* out) {
  sm90::named_sync(BAR_C, NC);
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const float* rw = red + wg * 4 * NW;
  for (int c = t; c < NW; c += 128)
    out[wg * NW + c] =
        ((rw[c] + rw[NW + c]) + rw[2 * NW + c]) + rw[3 * NW + c];
}

// tz: each thread reads back its own writes of the block's scratch, as K2
// reads its act'(z).  ZF32: zs and us (K5: zs) in f32 (the mixed bfloat16
// and float32 contracts), read by the epilogues from device memory, and so
// is K5's rebuilt b_th: the ring carries the weights alone, and no stage
// of it is read by the threads.  SPLIT (K3 and K5 at float32): every
// product as three on the hi and lo terms of its f32 operands
// (sm90_trunk.cuh consume_s), the operands of the weight gradients written
// as hi and lo planes, nothing rounded to bf16, the heads' W_2 in f32.
template <bool HEADS, bool ZF32, bool SPLIT>
__global__ void __launch_bounds__(NTB, 1)
    trunk_bwd_sweep_kernel(const __grid_constant__ SweepMaps maps,
                           const BwdArgs p) {
  static_assert(!SPLIT || ZF32, "the split sweep reads f32 zs");
  constexpr int NS = sm_ring_n<SPLIT>();
  constexpr int LO = sm_lo<SPLIT>();
  // the weight-gradient operands' planes a layer slot: [x | h, t | th]
  // (SPLIT: hi, then lo)
  constexpr int PL = SPLIT ? 4 : 2;
  // z, u (K5: b_th) through the ring; otherwise from device memory
  constexpr bool ZRING = EPI_DATA && !ZF32;
  typedef RingN<NS> R;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* act = smem + SM_ACT;
  unsigned char* ts = smem + SM_TS;
  unsigned char* ring = smem + sm_ring<HEADS, SPLIT>();
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + sm_bar<HEADS, SPLIT>());
  uint64_t* empty = full + NS;
  uint64_t* cbar = empty + NS;                           // K5 chunk loads
  float* row_a = reinterpret_cast<float*>(smem + sm_rows<HEADS, SPLIT>());
  float* row_b = row_a + T;
  float* rowc = row_b + T;                               // K5 only
  const int layers = p.layers, skip = p.skip, last = layers - 1;
  const int tid = threadIdx.x;
  // SPLIT: rows from a weight's hi plane to its lo plane
  const int lo_f = F, lo_mid = (layers - 2) * F;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);     // one arrival per consumer warp
    }
    sm90::mbar_init(cbar, 1);
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
      for (int i = 0; i < layers; ++i) {
        if (i == 0)
          produce_s<SPLIT>(&maps.w0k, false, EP / KSL, 0, 0, F, lo_f, r,
                           full, empty, ring);
        else if (i == skip)
          produce_s<SPLIT>(&maps.wskipk, false, (EP + F) / KSL, 0, 0, F,
                           lo_f, r, full, empty, ring);
        else
          produce_s<SPLIT>(&maps.wmidk, false, F / KSL,
                           (i < skip ? i - 1 : i - 2) * F, 0, F, lo_mid, r,
                           full, empty, ring);
        if (ZRING) produce_fwd_data(maps, i, row0, r, full, empty, ring);
      }
      if constexpr (HEADS) {
        produce_s<SPLIT>(&maps.wfk, false, F / KSL, 0, 0, F, F, r, full,
                         empty, ring);
        for (int q = 0; q < 4; ++q)
          produce_s<SPLIT>(q == 0 ? &maps.w1rk : &maps.w1pk, false, F / KSL,
                           q == 0 ? 0 : (q - 1) * HID, 0, HID,
                           q == 0 ? HID : 3 * HID, r, full, empty, ring);
        // a_xf's products: per q, the chunk's K (head_kh)
        constexpr int KH = head_kh<SPLIT>();
        for (int q = 3; q >= 0; --q)
          for (int hk = 0; hk < HID; hk += KH)
            produce_s<SPLIT>(q == 0 ? &maps.w1rm : &maps.w1pm, true,
                             KH / KSL, (q == 0 ? 0 : (q - 1) * HID) + hk, 0,
                             F, q == 0 ? HID : 3 * HID, r, full, empty,
                             ring);
        produce_s<SPLIT>(&maps.wfm, true, F / KSL, 0, 0, F, F, r, full, empty,
                         ring);
      }
      for (int i = last; i >= 0; --i) {
        if (ZRING)
          produce_rev_data<HEADS>(
              maps,
              HEADS ? p.uc + ((size_t)tile * layers + i) * (NWG / 2) * NC
                    : nullptr,
              i, row0, r, full, empty, ring);
        if (i == 0) break;
        if (i == skip)
          produce_s<SPLIT>(&maps.wskipm, true, F / KSL, 0, EP, F, lo_f, r,
                           full, empty, ring);
        else
          produce_s<SPLIT>(&maps.wmidm, true, F / KSL,
                           (i < skip ? i - 1 : i - 2) * F, 0, F, lo_mid, r,
                           full, empty, ring);
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  sm90::setmaxnreg_inc<232>();
  const int wg = tid >> 7, t = tid & 127, w = t >> 5, l = t & 31;
  const bool leader = l == 0, issuer = tid == 0;
  const int r0 = w * 16 + (l >> 2);          // rows r0 and r0 + 8
  const int cb = wg * NWG + 2 * (l & 3);     // column of j = 0, e = 0
  const int row_w = (layers + 1) * F + (HEADS ? HEAD_PART : 0);
  const float* __restrict__ wsig = p.wsig;
  // tz of layer l: accumulators 4j..4j+3 of consumer thread c as the
  // float4 (l * NWG / 8 + j) * NC + c of the block's scratch (a warp writes
  // and reads 512 contiguous bytes), streamed both ways, each thread
  // reading back its own writes
  float4* tzb = reinterpret_cast<float4*>(
                    p.tzsc + (size_t)blockIdx.x * layers * (NWG / 2) * NC) +
                tid;
  float4 tzn[TZB];                             // the next batch of tz
  float* red = reinterpret_cast<float*>(ts);   // when ts is free
  const size_t lf = (size_t)layers * F;        // ZF32: zs / us row stride
  // the bf16 rounding of a product's operand (none with SPLIT)
  auto rnd = [](float v) { return SPLIT ? v : bf16_round(v); };
  R r = {0, 0};
  uint32_t cphase = 0;
  float acc[NWG / 2];

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int row0 = tile * T;
    const size_t grow0 = (size_t)row0;
    float* pt_tile = p.part + (size_t)tile * row_w;
    tiles_free(issuer);                        // ts and act out of use
    // t = c_g into ts as bf16; x and t to xt as the bf16 operands of the
    // layer-0 and skip-top weight gradients (SPLIT: their hi terms, and
    // the lo terms into ts's lo tile and xt's lo plane)
    for (int i = tid; i < T * EP / 4; i += NC) {
      const int rr = (i * 4) / EP, c = (i * 4) % EP;
      const float4 a = reinterpret_cast<const float4*>(p.x + grow0 * EP)[i];
      const float4 b = reinterpret_cast<const float4*>(p.cg + grow0 * EP)[i];
      const uint2 bv = make_uint2(sm90::pack_bf2(b.x, b.y),
                                  sm90::pack_bf2(b.z, b.w));
      const uint32_t o = sm90::sw128_offset(rr, c, ACT_BLOCK);
      *reinterpret_cast<uint2*>(ts + o) = bv;
      reinterpret_cast<uint2*>(p.xt + grow0 * EP)[i] =
          make_uint2(sm90::pack_bf2(a.x, a.y), sm90::pack_bf2(a.z, a.w));
      reinterpret_cast<uint2*>(p.xt + (size_t)p.n * EP + grow0 * EP)[i] = bv;
      if constexpr (SPLIT) {
        const uint2 bl = make_uint2(
            sm90::pack_bf2(b.x - bf16_round(b.x), b.y - bf16_round(b.y)),
            sm90::pack_bf2(b.z - bf16_round(b.z), b.w - bf16_round(b.w)));
        *reinterpret_cast<uint2*>(ts + LO + o) = bl;
        reinterpret_cast<uint2*>(p.xt + (size_t)(2 * p.n + row0) * EP)[i] =
            make_uint2(
                sm90::pack_bf2(a.x - bf16_round(a.x), a.y - bf16_round(a.y)),
                sm90::pack_bf2(a.z - bf16_round(a.z), a.w - bf16_round(a.w)));
        reinterpret_cast<uint2*>(p.xt + (size_t)(3 * p.n + row0) * EP)[i] =
            bl;
      }
    }
    if (HEADS)
      for (int i = tid; i < T * HEAD_COLS; i += NC)
        rowc[i] = p.cot[grow0 * HEAD_COLS + i];
    sm90::fence_async_smem();
    sm90::named_sync(BAR_C, NC);

    // ------------------------------------------- tangent forward, t = c_g
    float pz[2] = {0.f, 0.f}, pt[2] = {0.f, 0.f};
    for (int i = 0; i < layers; ++i) {
      if (i == 0)
        consume_s<NWG, 0, SPLIT, LO>(acc, ts, EP, ts, EP / KSL, false, r,
                                     full, empty, ring, wg, leader);
      else if (i == skip)
        consume_s<NWG, 0, SPLIT, LO>(acc, ts, EP, act, (EP + F) / KSL, false,
                                     r, full, empty, ring, wg, leader);
      else
        consume_s<NWG, 0, SPLIT, LO>(acc, act, F, act, F / KSL, false, r,
                                     full, empty, ring, wg, leader);
      tiles_free(issuer);                      // both products read act
      const float w0s = i == 0 ? 30.f : 1.f;
      float4* tzl = tzb + (size_t)i * (NWG / 8) * NC;
#pragma unroll
      for (int j = 0; j < NWG / 8; ++j) {
        // z of rows r0 / r0 + 8 from the ring: JPS j-groups a stage
        // (ZF32: from device memory)
        if (ZRING && j % (JPS * JJ) == 0)
          sm90::mbar_wait(&full[r.stage], r.phase);
        float2 za, zb;
        if constexpr (ZF32) {
          const float* zp = p.zsf + (grow0 + r0) * lf + (size_t)i * F + cb +
                            8 * j;
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
        const float z4[4] = {za.x, za.y, zb.x, zb.y};
        float h4[4];
        __stcs(tzl + j * NC, make_float4(acc[4 * j], acc[4 * j + 1],
                                         acc[4 * j + 2], acc[4 * j + 3]));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float d;
          act_eval(z4[e], w0s, h4[e], d);
          const float tz = acc[4 * j + e];
          const float th = d * tz;
          if (i == last) {
            const float ws = wsig[cb + 8 * j + (e & 1)];
            pz[e >> 1] += rnd(h4[e]) * ws;
            pt[e >> 1] += rnd(th) * ws;
          }
          acc[4 * j + e] = th;       // h takes the tile first; acc keeps th
        }
        // rows r0 / r0 + 8, columns 8j + 2 (l%4) + {0, 1}
        const int col = cb + 8 * j;
        put2_s<SPLIT, LO>(act, r0, col, h4[0], h4[1]);
        put2_s<SPLIT, LO>(act, r0 + 8, col, h4[2], h4[3]);
        if (ZRING && j % (JPS * JJ) == JPS * JJ - 1) {
          release(empty, r.stage);
          r.advance();
        }
      }
      if (i < last) {
        // h_i, then th_i, to hth's slot of layer i + 1 (SPLIT: hi and lo)
        tile_to_global(&maps.hth, act, FA, 0, (PL * i) * p.n + row0, issuer);
        if (SPLIT)
          tile_to_global(&maps.hth, act + LO, FA, 0,
                         (PL * i + 2) * p.n + row0, issuer);
        tiles_free(issuer);
        store_tile_s<NWG, SPLIT, LO>(act, wg * NWG,
                                     [&](int k) { return acc[k]; });
        tile_to_global(&maps.hth, act, FA, 0, (PL * i + 1) * p.n + row0,
                       issuer);
        if (SPLIT)
          tile_to_global(&maps.hth, act + LO, FA, 0,
                         (PL * i + 3) * p.n + row0, issuer);
      } else {
        // act keeps h_{L-1} (K5: the A operand of xf, and hl); acc th
        sm90::fence_async_smem();
        sm90::named_sync(BAR_C, NC);
        if (HEADS && issuer) {
          for (int pl = 0; pl < (SPLIT ? 2 : 1); ++pl)
            for (int b = 0; b < FA; ++b)
              sm90::tma_store_2d(&maps.hl, act + pl * LO + b * ACT_BLOCK,
                                 b * 64, pl * p.n + row0);
          sm90::bulk_commit();
        }
      }
    }

    // ------------------------------------------------------- sigma head
    // zsig = h . wsig + b, tzsig = th . wsig; a = cs sp' + sp'' tzsig on
    // zsig, b = sp' on tzsig
    {
      float* rz = red;               // [2 warpgroups][64 rows], z then t
      float* rt = red + 2 * T;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float vz = pz[hf], vt = pt[hf];
        vz += __shfl_xor_sync(0xffffffffu, vz, 1);
        vz += __shfl_xor_sync(0xffffffffu, vz, 2);
        vt += __shfl_xor_sync(0xffffffffu, vt, 1);
        vt += __shfl_xor_sync(0xffffffffu, vt, 2);
        if ((l & 3) == 0) {
          rz[wg * T + r0 + 8 * hf] = vz;
          rt[wg * T + r0 + 8 * hf] = vt;
        }
      }
      sm90::named_sync(BAR_C, NC);
      if (tid < T) {
        const float s_z = rz[tid] + rz[T + tid];
        const float s_t = rt[tid] + rt[T + tid];
        const float zsig = s_z + p.bsig[0];
        const float sp1 = 1.f / (1.f + expf(-zsig));
        const float sp2 = sp1 * (1.f - sp1);
        const float c_s = HEADS ? rowc[tid * HEAD_COLS] : p.cs[grow0 + tid];
        row_a[tid] = c_s * sp1 + sp2 * s_t;
        row_b[tid] = sp1;
      }
      // SPLIT reads h as hi + lo and th unrounded below
      sm90::named_sync(BAR_C, NC);
      if (tid == 0) {
        float s = 0.f;
        for (int rr = 0; rr < T; ++rr) s += row_a[rr];
        p.pbs[tile] = s;
      }
      // the sigma head's dW: sum_rows bf16(h) bf16(a) + bf16(th) bf16(b)
      // (SPLIT: h as hi + lo from the tiles, th, a and b in f32)
      const float a0 = rnd(row_a[r0]), a1 = rnd(row_a[r0 + 8]);
      const float b0 = rnd(row_b[r0]), b1 = rnd(row_b[r0 + 8]);
      float* cred = red + 4 * T;     // [2][4][NWG]
      auto h_at = [&](int row, int col) {
        const uint32_t o = sm90::sw128_offset(row, col, ACT_BLOCK);
        float2 h = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(act + o));
        if constexpr (SPLIT) {
          const float2 hl = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(act + LO + o));
          h = make_float2(h.x + hl.x, h.y + hl.y);
        }
        return h;
      };
#pragma unroll
      for (int j = 0; j < NWG / 8; ++j) {
        const int col = cb + 8 * j;
        const float2 h0 = h_at(r0, col), h1 = h_at(r0 + 8, col);
        float v0 = (h0.x * a0 + h1.x * a1) +
                   (rnd(acc[4 * j]) * b0 + rnd(acc[4 * j + 2]) * b1);
        float v1 = (h0.y * a0 + h1.y * a1) +
                   (rnd(acc[4 * j + 1]) * b0 + rnd(acc[4 * j + 3]) * b1);
        v0 = col_sum(v0);
        v1 = col_sum(v1);
        if (l < 4) {
          cred[(wg * 4 + w) * NWG + 8 * j + 2 * l] = v0;
          cred[(wg * 4 + w) * NWG + 8 * j + 2 * l + 1] = v1;
        }
      }
      col_finish<NWG>(cred, pt_tile + (size_t)layers * F);
    }

    if constexpr (HEADS) {
      float* hp_tile = pt_tile + (size_t)(layers + 1) * F;
      // ---------------------------------------- xf = h W_f^T + b_f
      consume_s<NWG, 0, SPLIT, LO>(acc, act, F, act, F / KSL, false, r, full,
                                   empty, ring, wg, leader);
      tiles_free(issuer);            // act (h) read by both, hl stored
      const float* __restrict__ bfv = p.bf;
      store_tile_s<NWG, SPLIT, LO>(act, wg * NWG, [&acc, bfv, cb](int k) {
        return acc[k] + bfv[cb + 8 * (k >> 2) + (k & 1)];
      });
      tile_to_global(&maps.xfb, act, FA, 0, row0, issuer);
      if (SPLIT)
        tile_to_global(&maps.xfb, act + LO, FA, 0, p.n + row0, issuer);

      // ---- the first head layers in HID-column passes, HWG columns a
      // warpgroup (q = 0: rgb, 1..3: k, theta, rho_c): c_z1 = act'(z1)
      // (c_z2 W_2) to global, with its column sums (db_1) and the dW_2
      // partials h1^T c_z2 (SPLIT: c_z1 as hi and lo planes; cz1_regs:
      // stored from the registers)
      constexpr bool CZR = cz1_regs<SPLIT>();
      float (&ah)[HWG / 2] = *reinterpret_cast<float(*)[HWG / 2]>(acc);
      const int cq = wg * HWG + 2 * (l & 3);   // column of j = 0 in a pass
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        consume_s<HWG, 0, SPLIT, LO>(ah, act, F, act, F / KSL, false, r,
                                     full, empty, ring, wg, leader);
        tiles_free(issuer);          // the chunk's last store is read
        const float* b1 = q == 0 ? p.b1r : p.b1p + (q - 1) * HID;
        const int c2 = q == 0 ? 1 : 4;           // first c_z2 column of q
        float cc[2][3];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            cc[hf][c] = rnd(rowc[(r0 + 8 * hf) * HEAD_COLS + c2 + c]);
        float* qred = red;           // [4 sums][2 wg][4 warps][HWG]
#pragma unroll
        for (int j = 0; j < HWG / 8; ++j) {
          float sum[4][2];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int col = cq + 8 * j + e2;       // 0..HID-1 within q
            float s0 = 0.f, s1 = 0.f;   // c_z2 W_2 for rows r0, r0 + 8
            if (q == 0) {
              const float w20 = w2_at<SPLIT>(p.w2r, col);
              const float w21 = w2_at<SPLIT>(p.w2r, HID + col);
              const float w22 = w2_at<SPLIT>(p.w2r, 2 * HID + col);
              s0 = cc[0][0] * w20 + cc[0][1] * w21 + cc[0][2] * w22;
              s1 = cc[1][0] * w20 + cc[1][1] * w21 + cc[1][2] * w22;
            } else {    // w2p row q-1, column k - HID of the merged 768
              const float w2 = w2_at<SPLIT>(
                  p.w2p, (q - 1) * 3 * HID + (q - 1) * HID + col);
              s0 = cc[0][q - 1] * w2;
              s1 = cc[1][q - 1] * w2;
            }
            float h[2], d[2];
            act_eval(ah[4 * j + e2] + b1[col], 1.f, h[0], d[0]);
            act_eval(ah[4 * j + 2 + e2] + b1[col], 1.f, h[1], d[1]);
            const float cz0 = d[0] * s0, cz1v = d[1] * s1;
            ah[4 * j + e2] = cz0;
            ah[4 * j + 2 + e2] = cz1v;
            sum[0][e2] = cz0 + cz1v;
            const float hb0 = rnd(h[0]), hb1 = rnd(h[1]);
#pragma unroll
            for (int c = 0; c < 3; ++c)
              sum[1 + c][e2] = hb0 * cc[0][c] + hb1 * cc[1][c];
          }
#pragma unroll
          for (int s = 0; s < 4; ++s)
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const float v = col_sum(sum[s][e2]);
              if (l < 4)
                qred[((s * 2 + wg) * 4 + w) * HWG + 8 * j + 2 * l + e2] = v;
            }
        }
        sm90::named_sync(BAR_C, NC);
        if (t < HWG) {
          const int k = q * HID + wg * HWG + t;  // hidden unit of 4 HID
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float* rw = qred + (s * 2 + wg) * 4 * HWG;
            const float v =
                ((rw[t] + rw[HWG + t]) + rw[2 * HWG + t]) + rw[3 * HWG + t];
            hp_tile[s == 0 ? HP_DB1 + k : HP_DW2 + (s - 1) * 4 * HID + k] =
                v;
          }
        }
        sm90::named_sync(BAR_C, NC);             // qred read
        if constexpr (CZR) {
          // rows r0 / r0 + 8, columns cq + 8 j + {0, 1} of pass q (SPLIT:
          // hi and lo planes); the chunk loads below read them by TMA
#pragma unroll
          for (int j = 0; j < HWG / 8; ++j)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const float a = ah[4 * j + 2 * hf], b = ah[4 * j + 2 * hf + 1];
              const size_t o = (grow0 + r0 + 8 * hf) * (4 * HID) + q * HID +
                               cq + 8 * j;
              *reinterpret_cast<uint32_t*>(p.cz1 + o) = sm90::pack_bf2(a, b);
              if constexpr (SPLIT)
                *reinterpret_cast<uint32_t*>(p.cz1 + (size_t)p.n * 4 * HID +
                                             o) =
                    sm90::pack_bf2(a - bf16_round(a), b - bf16_round(b));
            }
        } else {
          store_tile_sw<HWG>(ts, wg * HWG, [&](int k) { return ah[k]; });
          tile_to_global(&maps.cz1, ts, HID / 64, q * HID, row0, issuer);
        }
      }
      if (CZR) sm90::fence_async_global();
      if (tid < 8) {
        float s = 0.f;
        if (tid < 6)
          for (int rr = 0; rr < T; ++rr) s += rowc[rr * HEAD_COLS + 1 + tid];
        hp_tile[HP_DB2 + tid] = s;
      }

      // ---- a_xf = sum_q c_z1_q W_1q, q = 3 (in the chunk) down to 0
      // (reloaded from what the passes stored, KH columns a chunk in NBX
      // boxes a plane; SPLIT: each chunk with its lo terms)
      constexpr int KH = head_kh<SPLIT>();
      constexpr int NBX = (KH + 63) / 64;
      constexpr int NPL = SPLIT ? 2 : 1;
#pragma unroll 1
      for (int q = 3; q >= 0; --q) {
#pragma unroll 1
        for (int hk = 0; hk < HID; hk += KH) {
          if (CZR || q < 3) {
            sm90::named_sync(BAR_C, NC);         // the chunk is read
            if (issuer) {
              sm90::bulk_wait<0>();              // c_z1 is in memory
              sm90::mbar_expect_tx(cbar, NPL * NBX * ACT_BLOCK);
              for (int b = 0; b < NPL * NBX; ++b)   // plane b / NBX
                sm90::tma_load_2d(
                    ts + (b / NBX) * LO + (b % NBX) * ACT_BLOCK, &maps.cz1,
                    cbar, q * HID + hk + (b % NBX) * 64,
                    (b / NBX) * p.n + row0);
            }
            sm90::mbar_wait(cbar, cphase);
            cphase ^= 1;
          }
          consume_s<NWG, 1, SPLIT, LO>(acc, ts, KH, ts, KH / KSL,
                                       q < 3 || hk > 0, r, full, empty, ring,
                                       wg, leader);
        }
      }
      tiles_free(issuer);            // act (xf) and the chunk are free
      {
        float* cred = red;
#pragma unroll
        for (int j = 0; j < NWG / 8; ++j) {
          const float v0 = col_sum(acc[4 * j] + acc[4 * j + 2]);
          const float v1 = col_sum(acc[4 * j + 1] + acc[4 * j + 3]);
          if (l < 4) {
            cred[(wg * 4 + w) * NWG + 8 * j + 2 * l] = v0;
            cred[(wg * 4 + w) * NWG + 8 * j + 2 * l + 1] = v1;
          }
        }
        col_finish<NWG>(cred, hp_tile + HP_DBF);
      }
      store_tile_s<NWG, SPLIT, LO>(act, wg * NWG,
                                   [&](int k) { return acc[k]; });
      tile_to_global(&maps.axf, act, FA, 0, row0, issuer);
      if (SPLIT)
        tile_to_global(&maps.axf, act + LO, FA, 0, p.n + row0, issuer);
      // ------------------------------------ a_h from the heads: a_xf W_f
      consume_s<NWG, 1, SPLIT, LO>(acc, act, F, act, F / KSL, false, r, full,
                                   empty, ring, wg, leader);
    }

    // the last layer's first batch of tz, in flight while a_h is formed
#pragma unroll
    for (int b = 0; b < TZB; ++b)
      tzn[b] = __ldcs(tzb + (size_t)last * (NWG / 8) * NC + b * NC);
    // a_h of the last layer: a . wsig + c_feats (K3), + a_xf W_f (K5)
    {
      const float a0 = rnd(row_a[r0]), a1 = rnd(row_a[r0 + 8]);
#pragma unroll
      for (int j = 0; j < NWG / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int col = cb + 8 * j, k = 4 * j + 2 * hf;
          float2 f;
          if (HEADS) {
            f = make_float2(acc[k], acc[k + 1]);
          } else {
            const size_t o = (grow0 + r0 + 8 * hf) * F + col;
            f = p.cf_bf16 ? ld_bf2(static_cast<const bf16*>(p.cf) + o)
                          : *reinterpret_cast<const float2*>(
                                static_cast<const float*>(p.cf) + o);
          }
          const float a = hf ? a1 : a0;
          acc[k] = a * wsig[col] + f.x;
          acc[k + 1] = a * wsig[col + 1] + f.y;
        }
    }

    // ------------------------------------------------------ reverse sweep
    for (int i = last; i >= 0; --i) {
      const float w0s = i == 0 ? 30.f : 1.f;
      tiles_free(issuer);            // act read by both products, stored
      uint32_t zu_stage = 0;
      // this thread's tz of layer i (its own writes), in batches of TZB
      // float4 loaded one batch ahead (the first during the product before
      // the epilogue); ZF32: K5's b_th
      const float4* tzl = tzb + (size_t)i * (NWG / 8) * NC;
      float4 tzc[TZB];
      const float* ucl =
          HEADS ? p.uc + ((size_t)tile * layers + i) * (NWG / 2) * NC + tid
                : nullptr;
#pragma unroll
      for (int j = 0; j < NWG / 8; ++j) {
        // j-group j / JJ: a ring stage of z and u (K5: z, then one of the
        // rebuilt b_th); ZF32: none
        if (ZRING && j % JJ == 0) {
          sm90::mbar_wait(&full[r.stage], r.phase);
          zu_stage = r.stage;
          if (HEADS) {
            r.advance();
            sm90::mbar_wait(&full[r.stage], r.phase);
          }
        }
        if (j % TZB == 0) {
#pragma unroll
          for (int b = 0; b < TZB; ++b) {
            tzc[b] = tzn[b];
            if (j + TZB < NWG / 8)
              tzn[b] = __ldcs(tzl + (j + TZB + b) * NC);
          }
        }
        const float4 t4 = tzc[j % TZB];
        const float tzv[4] = {t4.x, t4.y, t4.z, t4.w};
        const unsigned char* zu = ring + zu_stage * RING_STAGE;
        const int cz = zc_of(wg) + 8 * (j % JJ) + 2 * (l & 3);
        const int o0 = sm90::sw128_offset(r0, cz, 0);
        const int o1 = sm90::sw128_offset(r0 + 8, cz, 0);
        const size_t zo = (grow0 + r0) * lf + (size_t)i * F + cb + 8 * j;
        float2 za, zb;
        if constexpr (ZF32) {
          za = glob_f2(p.zsf + zo);
          zb = glob_f2(p.zsf + zo + 8 * lf);
        } else {
          za = stage_bf2(zu + zb_of(wg) * ACT_BLOCK + o0);
          zb = stage_bf2(zu + zb_of(wg) * ACT_BLOCK + o1);
        }
        const float z4[4] = {za.x, za.y, zb.x, zb.y};
        float u4[4];
        if (HEADS) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            u4[e] = ZF32 ? ucl[(4 * j + e) * NC]
                         : stage_f32(ring + r.stage * RING_STAGE +
                                     ((4 * (j % JJ) + e) * NC + tid) * 4);
        } else {
          float2 ua, ub;
          if constexpr (ZF32) {
            ua = glob_f2(p.usf + zo);
            ub = glob_f2(p.usf + zo + 8 * lf);
          } else {
            ua = stage_bf2(zu + (ZB + zb_of(wg)) * ACT_BLOCK + o0);
            ub = stage_bf2(zu + (ZB + zb_of(wg)) * ACT_BLOCK + o1);
          }
          u4[0] = ua.x;
          u4[1] = ua.y;
          u4[2] = ub.x;
          u4[3] = ub.y;
        }
        float bt[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float h, d1, d2;
          act_eval2(z4[e], w0s, h, d1, d2);
          const float tz = tzv[e];
          acc[4 * j + e] = d1 * acc[4 * j + e] + d2 * tz * u4[e];
          bt[e] = d1 * u4[e];
        }
        const int col = cb + 8 * j;
        put2_s<SPLIT, LO>(act, r0, col, bt[0], bt[1]);
        put2_s<SPLIT, LO>(act, r0 + 8, col, bt[2], bt[3]);
        if (ZRING && j % JJ == JJ - 1) {
          if (HEADS) release(empty, zu_stage);
          release(empty, r.stage);
          r.advance();
        }
      }
      tile_to_global(&maps.azbtz, act, FA, 0, (PL * i + 1) * p.n + row0,
                     issuer);
      if (SPLIT)
        tile_to_global(&maps.azbtz, act + LO, FA, 0,
                       (PL * i + 3) * p.n + row0, issuer);
      // column sums of a_z over the tile's 64 rows
      {
        float* cred = red;
#pragma unroll
        for (int j = 0; j < NWG / 8; ++j) {
          const float v0 = col_sum(acc[4 * j] + acc[4 * j + 2]);
          const float v1 = col_sum(acc[4 * j + 1] + acc[4 * j + 3]);
          if (l < 4) {
            cred[(wg * 4 + w) * NWG + 8 * j + 2 * l] = v0;
            cred[(wg * 4 + w) * NWG + 8 * j + 2 * l + 1] = v1;
          }
        }
        col_finish<NWG>(cred, pt_tile + (size_t)i * F);
      }
      tiles_free(issuer);            // b_tz stored, red read
      store_tile_s<NWG, SPLIT, LO>(act, wg * NWG,
                                   [&](int k) { return acc[k]; });
      tile_to_global(&maps.azbtz, act, FA, 0, (PL * i) * p.n + row0, issuer);
      if (SPLIT)
        tile_to_global(&maps.azbtz, act + LO, FA, 0,
                       (PL * i + 2) * p.n + row0, issuer);
      if (i == 0) break;
#pragma unroll
      for (int b = 0; b < TZB; ++b)
        tzn[b] = __ldcs(tzb + (size_t)(i - 1) * (NWG / 8) * NC + b * NC);
      // a_h_{i-1} = a_z_i . W_i
      consume_s<NWG, 1, SPLIT, LO>(acc, act, F, act, F / KSL, false, r, full,
                                   empty, ring, wg, leader);
    }
  }
  if (issuer) sm90::bulk_wait<0>();
}

// ============================================================ wgrad, reduce

// output tile WM x WN (WN: the width, at most 256), points a chunk; a
// group whose M (the width 64) is less than WM masks the tile's second
// 64 rows: its second warpgroup loads and multiplies nothing
constexpr int WM = 128, WN = F < 256 ? F : 256, WK = 64;
constexpr int WRING_N = 4;
constexpr int WSTAGE_BYTES = (WM + WN) * WK * 2;       // 48 KB
constexpr int WGRAD_SMEM = WRING_N * WSTAGE_BYTES + 128;
constexpr int WTILE = WM * WN;                         // floats a partial
constexpr int MAX_GROUPS = 16;

// The bf16 operands of the weight gradients, point-major, as TMA maps with
// boxes of 64 features x 64 points (SW128): xt, hth, azbtz; K5 hl, xfb,
// axf, cz1.
struct WgradMaps {
  CUtensorMap m[7];
};

// One weight-gradient product out (m rows) = A^T B over K = chunks x 64
// points: A from rows a_row.. of map a_map, B from rows b_row.. of b_map,
// in m_tiles x n_tiles output tiles of WM x WN, each K axis cut into
// `splits` slices.  Its blocks are first_block.. in the order (slice,
// tile), so that the tiles of one slice run side by side.  The split
// instantiation's operands are hi and lo planes, the lo plane a_lo (b_lo)
// rows past the hi one: its K axis is three segments of seg_chunks chunks,
// A_hi^T B_hi, A_lo^T B_hi and A_hi^T B_lo (otherwise one segment).
struct WgradGroup {
  int a_map, b_map, a_row, b_row;
  int m_tiles, n_tiles, chunks, splits, first_block;
  float* out;
  int ldo;
  int seg_chunks, a_lo, b_lo;
  int m;
};

struct WgradPlan {
  WgradGroup g[MAX_GROUPS];
  int n_groups, n_blocks, n_tile_elems;   // n_tile_elems: partial float4s
};

template <bool HEADS>
__global__ void __launch_bounds__(NTB, 1)
    trunk_bwd_wgrad_kernel(const __grid_constant__ WgradMaps maps,
                           const __grid_constant__ WgradPlan plan,
                           float* __restrict__ wpart) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WRING_N * WSTAGE_BYTES);
  uint64_t* empty = full + WRING_N;
  const int tid = threadIdx.x;
  int gi = 0;
  while (gi + 1 < plan.n_groups &&
         (int)blockIdx.x >= plan.g[gi + 1].first_block)
    ++gi;
  const WgradGroup& g = plan.g[gi];
  const int local = blockIdx.x - g.first_block;
  const int tiles = g.m_tiles * g.n_tiles;
  const int slice = local / tiles, tl = local % tiles;
  const int m0 = (tl / g.n_tiles) * WM, n0 = (tl % g.n_tiles) * WN;
  const int c0 = (int)((long long)slice * g.chunks / g.splits);
  const int c1 = (int)((long long)(slice + 1) * g.chunks / g.splits);

  if (tid == 0) {
    for (int s = 0; s < WRING_N; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // the tile's 64-row halves inside the output (the masked one: none)
  const int a_blocks = g.m - m0 < WM ? (g.m - m0) / 64 : WM / 64;
  if (tid >= NC) {
    sm90::setmaxnreg_dec<40>();
    if (tid != NC) return;
    Ring r = {0, 0};
    const CUtensorMap* ma = &maps.m[g.a_map];
    const CUtensorMap* mb = &maps.m[g.b_map];
    for (int c = c0; c < c1; ++c) {
      sm90::mbar_wait(&empty[r.stage], r.phase ^ 1);
      unsigned char* s = smem + r.stage * WSTAGE_BYTES;
      uint64_t* f = &full[r.stage];
      sm90::mbar_expect_tx(f, (a_blocks * 64 + WN) * WK * 2);
      const int seg = c / g.seg_chunks, cc = c - seg * g.seg_chunks;
      const int a_row = g.a_row + (seg == 1 ? g.a_lo : 0) + cc * WK;
      const int b_row = g.b_row + (seg == 2 ? g.b_lo : 0) + cc * WK;
      for (int b = 0; b < a_blocks; ++b)
        sm90::tma_load_2d(s + b * ACT_BLOCK, ma, f, m0 + b * 64, a_row);
      for (int b = 0; b < WN / 64; ++b)
        sm90::tma_load_2d(s + (WM / 64 + b) * ACT_BLOCK, mb, f, n0 + b * 64,
                          b_row);
      r.advance();
    }
    return;
  }

  sm90::setmaxnreg_inc<232>();
  const int wg = tid >> 7;
  const bool leader = (tid & 127) == 0;
  Ring r = {0, 0};
  if (wg >= a_blocks) {
    // the masked half: release every stage, write nothing
    for (int c = c0; c < c1; ++c) {
      sm90::mbar_wait(&full[r.stage], r.phase);
      if (leader) sm90::mbar_arrive(&empty[r.stage]);
      r.advance();
    }
    return;
  }
  float acc[WN / 2];
  uint32_t prev = 0;
  for (int c = c0; c < c1; ++c) {
    sm90::mbar_wait(&full[r.stage], r.phase);
    const unsigned char* s = smem + r.stage * WSTAGE_BYTES;
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < WK / 16; ++ks) {
      // both MN-major SW128: 16 k-rows of 128 bytes a step; B's 64-wide n
      // blocks one box (8 KB) apart
      const uint64_t da =
          sm90::make_desc(s + wg * ACT_BLOCK + ks * 2048, ACT_BLOCK, 1024, 1);
      const uint64_t db = sm90::make_desc(
          s + (WM / 64) * ACT_BLOCK + ks * 2048, ACT_BLOCK, 1024, 1);
      sm90::wgmma_n<WN, 1, 1>(acc, da, db, (c > c0 || ks > 0) ? 1 : 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    if (c > c0 && leader) sm90::mbar_arrive(&empty[prev]);
    prev = r.stage;
    r.advance();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_acc(acc);
  // the partial tile in the accumulator layout, float4 i of thread tid at
  // (i * 256 + tid): each warp writes 512 contiguous bytes
  float4* dst = reinterpret_cast<float4*>(wpart + (size_t)blockIdx.x * WTILE) +
                tid;
#pragma unroll
  for (int i = 0; i < WN / 8; ++i)
    dst[i * NC] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                              acc[4 * i + 3]);
}

// Blocks [0, n_tile_elems / 256): one float4 of one output tile a thread,
// summed over the tile's slices in order; then blocks of 32 columns of the
// sweep's per-tile partials, summed over the tiles in order (8 warps take
// every 8th tile, then one warp adds the 8 in order).
template <bool HEADS>
__global__ void __launch_bounds__(256)
    trunk_bwd_reduce_kernel(const __grid_constant__ WgradPlan plan,
                            const BwdArgs p) {
  const int tid = threadIdx.x;
  const int nb_tiles = plan.n_tile_elems / 256;
  if ((int)blockIdx.x < nb_tiles) {
    int q = blockIdx.x * 256 + tid;
    int gi = 0;
    for (; gi < plan.n_groups; ++gi) {
      const int e = plan.g[gi].m_tiles * plan.g[gi].n_tiles * (WTILE / 4);
      if (q < e) break;
      q -= e;
    }
    const WgradGroup& g = plan.g[gi];
    const int tiles = g.m_tiles * g.n_tiles;
    const int tl = q / (WTILE / 4), e4 = q % (WTILE / 4);
    const float4* src = reinterpret_cast<const float4*>(p.wpart) + e4;
    float4 s = src[(size_t)(g.first_block + tl) * (WTILE / 4)];
    for (int sl = 1; sl < g.splits; ++sl) {
      const float4 v =
          src[(size_t)(g.first_block + sl * tiles + tl) * (WTILE / 4)];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    // float4 i of consumer thread c: accumulators 4i..4i+3 of warpgroup
    // c / 128 (rows 64 (c/128) + ...), see sm90_common.cuh
    const int i = e4 / NC, c = e4 % NC;
    const int cw = c & 127, ww = cw >> 5, ll = cw & 31;
    const int row =
        (tl / g.n_tiles) * WM + (c >> 7) * 64 + ww * 16 + (ll >> 2);
    if (row >= g.m) return;          // the masked half of a tile
    const int col = (tl % g.n_tiles) * WN + 8 * i + 2 * (ll & 3);
    *reinterpret_cast<float2*>(g.out + (size_t)row * g.ldo + col) =
        make_float2(s.x, s.y);
    *reinterpret_cast<float2*>(g.out + (size_t)(row + 8) * g.ldo + col) =
        make_float2(s.z, s.w);
    return;
  }

  // the bias grads, the sigma head's dW, (K5) the heads' partials, then the
  // sigma head's db
  __shared__ float red[8][32];
  const int layers = p.layers, skip = p.skip;
  const int trunk_cols = (layers + 1) * F;
  const int cols = trunk_cols + (HEADS ? HEAD_PART : 0);
  const int w = tid >> 5, lane = tid & 31;
  const int j = (blockIdx.x - nb_tiles) * 32 + lane;
  float s = 0.f;
  if (j < cols)
    for (int t = w; t < p.n_tiles; t += 8) s += p.part[(size_t)t * cols + j];
  else if (j == cols)
    for (int t = w; t < p.n_tiles; t += 8) s += p.pbs[t];
  red[w][lane] = s;
  __syncthreads();
  if (w != 0 || j > cols) return;
  s = red[0][lane];
  for (int k = 1; k < 8; ++k) s += red[k][lane];
  if (j == cols) {
    p.dbsig[0] = s;
    return;
  }
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
}

// ------------------------------------------------------------------- host

// The sweep's tensor maps; false where cuTensorMapEncodeTiled refuses
// one.  With p.split the weights are (2, ...) hi and lo planes and the
// operands of the weight gradients 4 planes a layer slot; with f32 zs/us
// (p.zsf) their maps are not made (the epilogues read them from device
// memory).
template <bool HEADS>
bool sweep_maps(const BwdArgs& p, SweepMaps* m) {
  using sm90host::map_2d;
  const uint64_t planes = p.split ? 2 : 1, pl = 2 * planes;
  const uint64_t mids = (uint64_t)(p.layers - 2) * F * planes;
  const uint64_t fp = F * planes;
  const uint64_t n = p.n;
  bool ok = map_2d(&m->w0k, p.w0, fp, EP, EP, BOX_N, KSL, 64) &&
            map_2d(&m->wmidk, p.wmid, mids, F, F, BOX_N, KSL, 64) &&
            map_2d(&m->wskipk, p.wskip, fp, EP + F, EP + F, BOX_N, KSL, 64) &&
            map_2d(&m->wmidm, p.wmid, mids, F, F, KSL, 32, 64) &&
            map_2d(&m->wskipm, p.wskip, fp, EP + F, EP + F, KSL, 32, 64) &&
            (p.zsf != nullptr ||
             (map_2d(&m->zs, p.zs, n, p.layers * F, p.layers * F, T, 64,
                     128) &&
              (HEADS || map_2d(&m->us, p.us, n, p.layers * F, p.layers * F,
                               T, 64, 128)))) &&
            map_2d(&m->hth, p.hth, (uint64_t)(p.layers - 1) * pl * n, F, F,
                   T, 64, 128) &&
            map_2d(&m->azbtz, p.azbtz, (uint64_t)p.layers * pl * n, F, F, T,
                   64, 128);
  if (HEADS)
    ok = ok && map_2d(&m->wfk, p.wf, fp, F, F, BOX_N, KSL, 64) &&
         map_2d(&m->wfm, p.wf, fp, F, F, KSL, 32, 64) &&
         map_2d(&m->w1rk, p.w1r, HID * planes, F, F, BOX_N, KSL, 64) &&
         map_2d(&m->w1pk, p.w1p, 3 * HID * planes, F, F, BOX_N, KSL, 64) &&
         map_2d(&m->w1rm, p.w1r, HID * planes, F, F, KSL, 32, 64) &&
         map_2d(&m->w1pm, p.w1p, 3 * HID * planes, F, F, KSL, 32, 64) &&
         map_2d(&m->hl, p.hl, n * planes, F, F, T, 64, 128) &&
         map_2d(&m->xfb, p.xfb, n * planes, F, F, T, 64, 128) &&
         map_2d(&m->axf, p.axf, n * planes, F, F, T, 64, 128) &&
         map_2d(&m->cz1, p.cz1, n * planes, 4 * HID, 4 * HID, T, 64, 128);
  return ok;
}

// The weight-gradient products in block order: layer 0 (x | t), layers
// 1.. (h | th; the skip layer's bottom part), the skip layer's top part;
// then (K5) dW_f and [dW_1r | dW_1p].  Map indices as in WgradMaps.
template <bool HEADS>
bool wgrad_plan(const BwdArgs& p, WgradMaps* maps, WgradPlan* plan) {
  using sm90host::map_2d;
  const uint64_t n = p.n;
  const int L = p.layers;
  const int pl = p.split ? 4 : 2;      // planes a layer slot
  bool ok = map_2d(&maps->m[0], p.xt, pl * n, EP, EP, 64, 64, 128) &&
            map_2d(&maps->m[1], p.hth, (uint64_t)(L - 1) * pl * n, F, F, 64,
                   64, 128) &&
            map_2d(&maps->m[2], p.azbtz, (uint64_t)L * pl * n, F, F, 64, 64,
                   128);
  const uint64_t hp = p.split ? 2 : 1;   // the heads' operand planes
  if (HEADS)
    ok = ok && map_2d(&maps->m[3], p.hl, hp * n, F, F, 64, 64, 128) &&
         map_2d(&maps->m[4], p.xfb, hp * n, F, F, 64, 64, 128) &&
         map_2d(&maps->m[5], p.axf, hp * n, F, F, 64, 64, 128) &&
         map_2d(&maps->m[6], p.cz1, hp * n, 4 * HID, 4 * HID, 64, 64, 128);
  if (!ok) return false;
  // the trunk's K: [h; th] of every point; the heads' K: every point
  // (SPLIT: three segments of each, the lo planes lo / hlo rows on)
  const int seg = 2 * p.n / WK, ct = (p.split ? 3 : 1) * seg;
  const int ch = p.n / WK, cth = (p.split ? 3 : 1) * ch;
  const int lo = p.split ? 2 * p.n : 0, hlo = p.split ? p.n : 0;
  int k = 0, blocks = 0, elems = 0;
  // a product of m x n outputs (m a multiple of 64, n of WN)
  auto add = [&](int am, int ar, int bm, int br, int m, int n, int chunks,
                 int splits, float* out, int ldo, int sc, int l) {
    const int mt = (m + WM - 1) / WM, nt = n / WN;
    WgradGroup& g = plan->g[k++];
    g = {am, bm, ar, br, mt, nt, chunks, splits, blocks, out, ldo, sc, l, l,
         m};
    blocks += mt * nt * splits;
    elems += mt * nt * (WTILE / 4);
  };
  const int st = p.splits_trunk, sh = p.splits_heads;
  add(0, 0, 2, 0, EP, F, ct, st, p.dw0, F, seg, lo);
  for (int i = 1; i < L; ++i)
    add(1, (i - 1) * pl * p.n, 2, i * pl * p.n, F, F, ct, st,
        i == p.skip ? p.dwsb
                    : p.dwm + (size_t)(i < p.skip ? i - 1 : i - 2) * F * F,
        F, seg, lo);
  add(0, 0, 2, p.skip * pl * p.n, EP, F, ct, st, p.dwst, F, seg, lo);
  if (HEADS) {
    add(3, 0, 5, 0, F, F, cth, sh, p.dwf, F, ch, hlo);
    add(4, 0, 6, 0, F, 4 * HID, cth, sh, p.dw1, 4 * HID, ch, hlo);
  }
  plan->n_groups = k;
  plan->n_blocks = blocks;
  plan->n_tile_elems = elems;
  return k <= MAX_GROUPS;
}

template <bool HEADS, bool ZF32, bool SPLIT>
int launch_sweep(const SweepMaps& smaps, const BwdArgs& p, int n_blocks,
                 cudaStream_t st) {
  auto kernel = trunk_bwd_sweep_kernel<HEADS, ZF32, SPLIT>;
  const int smem = sweep_smem<HEADS, SPLIT>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_blocks, NTB, smem, st>>>(smaps, p);
  return (int)cudaGetLastError();
}

// Launch the sweep, the weight-gradient and the reduce kernels of K3
// (HEADS = false) or K5 on `stream`; returns a cudaError_t.  zs/us are bf16
// (p.zs, p.us) or f32 (p.zsf, p.usf; K5 reads no us); p.split takes f32
// zs/us.
template <bool HEADS>
int launch_bwd(const BwdArgs& p, int n_blocks, void* stream) {
  const bool zf = p.zsf != nullptr;
  const int ct = (p.split ? 3 : 1) * 2 * p.n / WK;
  if (p.n <= 0 || p.n % T != 0 || n_blocks <= 0 || p.layers < 3 ||
      p.layers + 3 > MAX_GROUPS || p.skip <= 0 || p.skip >= p.layers ||
      p.splits_trunk < 1 || p.splits_trunk > ct ||
      (HEADS && (p.splits_heads < 1 ||
                 p.splits_heads > (p.split ? 3 : 1) * p.n / WK)) ||
      zf == (p.zs != nullptr) ||
      (!HEADS && (zf ? p.usf == nullptr : p.us == nullptr)) ||
      (p.split && !zf))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SweepMaps smaps;
  WgradMaps wmaps;
  WgradPlan plan;
  if (!sweep_maps<HEADS>(p, &smaps) || !wgrad_plan<HEADS>(p, &wmaps, &plan) ||
      plan.n_blocks != p.wpart_tiles)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if constexpr (HEADS)
    e = (cudaError_t)(p.split ? launch_sweep<true, true, true>(smaps, p,
                                                               n_blocks, st)
                      : zf ? launch_sweep<true, true, false>(smaps, p,
                                                             n_blocks, st)
                           : launch_sweep<true, false, false>(smaps, p,
                                                              n_blocks, st));
  else
    e = (cudaError_t)(p.split ? launch_sweep<false, true, true>(smaps, p,
                                                                n_blocks, st)
                      : zf ? launch_sweep<false, true, false>(smaps, p,
                                                              n_blocks, st)
                           : launch_sweep<false, false, false>(smaps, p,
                                                               n_blocks, st));
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(trunk_bwd_wgrad_kernel<HEADS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           WGRAD_SMEM);
  if (e != cudaSuccess) return (int)e;
  trunk_bwd_wgrad_kernel<HEADS><<<plan.n_blocks, NTB, WGRAD_SMEM, st>>>(
      wmaps, plan, p.wpart);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int cols = (p.layers + 1) * F + (HEADS ? HEAD_PART : 0);
  trunk_bwd_reduce_kernel<HEADS>
      <<<plan.n_tile_elems / 256 + (cols + 1 + 31) / 32, 256, 0, st>>>(plan,
                                                                       p);
  return (int)cudaGetLastError();
}

}  // namespace trunk
