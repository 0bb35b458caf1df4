// The kernel body shared by K2 (trunk_fwd_grad.cu: the trunk forward and
// the reverse chain of g = d sigma / d x_enc, returning sigma and the
// features) and K4 (trunk_heads_fwd.cu: the same trunk and chain, then the
// flagship head block on the tile's features, returning packed logits).
//
// Math (ops/fused_trunk_vjp.py): z_l = h_{l-1} W_l^T + b_l, h_l = act(z_l);
// zsig = h_{L-1} . w_sigma + b, sigma = softplus(zsig); the chain is seeded
// with u_{L-1} = softplus'(zsig) w_sigma and runs g_l = act'(z_l) u_l,
// u_{l-1} = g_l W_l (the skip layer also sends g W_top to gx), gx += g_0 W_0.
// Rounding points are the Pallas kernels': every product on bf16 operands
// with f32 sums, act'(z) kept in f32 (pallas_trunk_vjp.py:185-186).
//
// What bounds it on the H100: tensor-core operations (K2 7.59 MFLOP a point
// against ~1.5 KB of traffic; 5.0 ms at the serving chunk's 655,360 points).
// What holds it back is the same as in K3's sweep: per 64-point tile it
// streams the trunk's 3.9 MB of bf16 weights from L2 twice (forward and
// reverse), and it moves act'(z) of 7 layers (14.3 KB a point) through a
// per-block f32 scratch in device memory, because 8 layers of a 64 x 512
// tile do not fit on chip.
//
// Design (sm90_trunk.cuh, as K3's sweep, trunk_bwd.cuh): a persistent grid,
// one 64-point tile at a time per block of three warpgroups.  A producer
// warp streams through one ring of four 32 KB stages, in the order the
// consumers take them, the tile's x (f32, one bulk copy) and every weight
// slice of the tile's products (K-major boxes for z = h W^T, MN-major boxes
// for u = g W), running ahead across epilogues and tiles.  Two consumer
// warpgroups each own F / 2 of the F output columns of every trunk product
// (at 512: wgmma m64n256k16, 128 f32 accumulators a thread; the gx
// products, 128 columns, m64n64 each) and read A from one 64 x F activation
// tile kept K-major with the 128-byte swizzle; the x tile sits beside it as bf16 for
// layer 0 and the skip layer's [x | h].  The epilogues write h and g into
// the tile.  act'(z) goes to the scratch as float4s in the accumulator
// layout (a warp writes 512 contiguous bytes) and comes back to the thread
// that wrote it, straight into registers, in batches issued one ahead of
// their use, the first while the product before the epilogue runs: the
// ring then carries weights only, and no barrier is needed (a thread reads
// its own writes).  zs, us and the bf16 feats leave by TMA stores of the
// tile before the epilogue overwrites it; gx leaves from the accumulators
// at the padded width 128 (its padded lanes are exactly 0: the padded
// columns of w0 and of wskip's top are zero).
//
// K2 keeps the last layer's pre-activations in registers across the sigma
// head and recomputes act'(z_{L-1}) from them; K4 needs the registers for
// the head products (xf = h W_f^T + b_f as one more F / 2-column product
// per warpgroup, then the four HID-column first head layers, HID = F / 2,
// as HID / 2-column products, n128 at width 512 and n16 at 64, each
// followed by its activation and, for the 3-column second layers, row
// reductions), so it puts act'(z_{L-1}) in one more scratch slot.  The
// trunk and the chain are one body for both, so K4 gives K2's sigma and gx
// bit for bit.  Row sums (sigma, the logits) add the two warpgroups'
// halves in a fixed order: there is no reduction across blocks, and the
// result is deterministic.
//
// With ZS (the training instantiations) the kernel also saves, per point and
// layer, z_l, and K2 the chain state u_l (before the act' multiply): the
// residuals K3 reads, in bf16 under bfloat16_all, and with ZF32 (float32 and
// the mixed bfloat16, whose activations are f32) in f32, stored from the
// accumulators as streaming float2 rows (a quad of threads fills a 32-byte
// sector), with no tile of their own.  K5 rebuilds the u chain from zs, as
// the Pallas _bwd_kernel_h does, so K4 saves zs alone.  The serving
// instantiations have none of that.
//
// SPLIT (K2 and K4 at compute_dtype float32: f32 operands and f32 weights)
// runs every product as three on bf16 tensor cores (sm90_trunk.cuh
// consume_s): the activation and x tiles hold hi and lo bf16 terms, the
// weights (the heads' W_f, W_1r and W_1p too) come as hi and lo planes
// through the ring, and nothing rounds to bf16 (the sigma head, softplus'
// and the heads' 3-column second layers take the f32 values, W_2 in f32).
// Shared memory: the two activation tiles and x tiles take 160 KB, so its
// ring has two 32 KB stages where the bf16 instantiations have four
// (fs_ring_n); K4's per-row logit halves live in the x tile, which no
// product reads after the skip layer's.

#pragma once

#include "sm90_trunk.cuh"

namespace trunk {

// The act'(z) scratch: each consumer thread writes its accumulators' act'
// and reads them back itself, once, so both go streaming (evict-first):
// ~1 MB a tile and block that L2 need not keep.  Measurement builds (never
// built by the package; tools/fwd_variants.py): FWD_NO_SCRATCH writes
// nothing and reads a constant, FWD_NO_SCRATCH_HINTS uses plain loads and
// stores.
__device__ __forceinline__ void scratch_st(float4* p, float4 v) {
#if defined(FWD_NO_SCRATCH)
#elif defined(FWD_NO_SCRATCH_HINTS)
  *p = v;
#else
  __stcs(p, v);
#endif
}

__device__ __forceinline__ float4 scratch_ld(const float4* p) {
#if defined(FWD_NO_SCRATCH)
  return make_float4(0.5f, 0.5f, 0.5f, 0.5f);
#elif defined(FWD_NO_SCRATCH_HINTS)
  return *p;
#else
  return __ldcs(p);
#endif
}

// Producer: one product's weight slices (sm90_trunk.cuh produce).
// Measurement builds (never built by the package; tools/fwd_variants.py):
// FWD_NO_WEIGHT_LOADS loads no slice, FWD_HALF_WEIGHT_LOADS every other one
// (the weight stream a point would pay in a 128-point block); a stage left
// unloaded completes empty and the products multiply whatever the ring
// holds, so that the time the weight stream from L2 costs can be read off.
template <class R>
__device__ __forceinline__ void produce_w(const CUtensorMap* map, bool mn,
                                          int nk, int row0, int col0, int nw,
                                          R& r, uint64_t* full,
                                          uint64_t* empty,
                                          unsigned char* ring) {
#if defined(FWD_NO_WEIGHT_LOADS) || defined(FWD_HALF_WEIGHT_LOADS)
  for (int c = 0; c < nk; ++c) {
#ifdef FWD_HALF_WEIGHT_LOADS
    if (c % 2 == 0) {
      produce(map, mn, 1, mn ? row0 + c * KSL : row0,
              mn ? col0 : col0 + c * KSL, nw, r, full, empty, ring);
      continue;
    }
#endif
    sm90::mbar_wait(&empty[r.stage], r.phase ^ 1);
    sm90::mbar_arrive(&full[r.stage]);
    r.advance();
  }
#else
  produce(map, mn, nk, row0, col0, nw, r, full, empty, ring);
#endif
}

// produce_w of the hi plane, and with SPLIT of the lo plane lo_rows below
// (sm90_trunk.cuh produce_s).
template <bool SPLIT, class R>
__device__ __forceinline__ void produce_ws(const CUtensorMap* map, bool mn,
                                           int nk, int row0, int col0,
                                           int nw, int lo_rows, R& r,
                                           uint64_t* full, uint64_t* empty,
                                           unsigned char* ring) {
  produce_w(map, mn, nk, row0, col0, nw, r, full, empty, ring);
  if constexpr (SPLIT)
    produce_w(map, mn, nk, row0 + lo_rows, col0, nw, r, full, empty, ring);
}

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
  const void* w2r;      // bf16, or f32 with split
  const float* b2r;
  const bf16* w1p;
  const float* b1p;
  const void* w2p;
  const float* b2p;
  float* out;
  // both
  float* gx;
  float* scratch;
  bf16* zs;            // bf16 zs/us (bfloat16_all), stored from the tile
  bf16* us;
  float* zsf;          // f32 zs/us (float32, mixed bfloat16), from registers
  float* usf;
  int split;           // float32: weights as hi and lo planes, SPLIT
  int layers, skip;
};

// The tensor maps: the weights as K-major boxes (BOX_N n rows x 32 k) and
// MN-major boxes (32 k rows x 32 n), SW64; zs, us and the bf16 feats as
// boxes of 64 rows x 64 columns, SW128, stored from the activation tile.
struct FwdMaps {
  CUtensorMap w0k, wmidk, wskipk, w0m, wmidm, wskipm;
  CUtensorMap zs, us, feats;
  CUtensorMap wfk, w1rk, w1pk;   // K4
};

// shared memory: the activation tile (64 x F, F / 64 SW128 blocks), the x
// tile (64 x 128 bf16, 2 blocks), with SPLIT both again for the lo terms
// (fs_lo bytes past the hi ones), the ring, barriers, then per-row vectors:
// the sigma head's warpgroup halves and softplus'(zsig).  K4's 6 logits'
// warpgroup halves (6 x 2 x 64 f32) take the x tile's place once the skip
// layer has read x for the last time: in the head passes (with SPLIT there
// is no room for them beside the ring: 896 B short)
constexpr int FS_ACT = 0;
constexpr int FS_X = FS_ACT + FA * ACT_BLOCK;
template <bool SPLIT>
__host__ __device__ constexpr int fs_lo() {
  return SPLIT ? (FA + 2) * ACT_BLOCK : 0;
}
// (FWD_RING_2, measurement only, never built by the package: every
// instantiation gets SPLIT's two stages, so that tools/fwd_variants.py can
// time what the shallow ring costs the bf16 ones)
template <bool SPLIT>
__host__ __device__ constexpr int fs_ring_n() {
#ifdef FWD_RING_2
  return 2;
#else
  return SPLIT ? 2 : RING_N;
#endif
}
template <bool SPLIT>
__host__ __device__ constexpr int fs_ring() {
  return FS_X + 2 * ACT_BLOCK + fs_lo<SPLIT>();
}
template <bool SPLIT>
__host__ __device__ constexpr int fs_rows() {
  return fs_ring<SPLIT>() + fs_ring_n<SPLIT>() * RING_STAGE + 128;
}
template <bool SPLIT = false>
__host__ __device__ constexpr int fwd_smem() {
  return fs_rows<SPLIT>() + 3 * T * 4;
}
static_assert(6 * 2 * T * 4 <= 2 * ACT_BLOCK, "K4's logit halves in x");
static_assert(fwd_smem<true>() <= 232448, "SPLIT's shared memory");

// Rows r0 and r0 + 8 of this thread's accumulator columns, v(4j + e), into
// an f32 matrix at p (row stride ld, from the thread's row and column 0 of
// its warpgroup's first column cb), as streaming float2 stores.
template <class V>
__device__ __forceinline__ void rows_out(float* p, size_t ld, V v) {
#pragma unroll
  for (int j = 0; j < NWG / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      __stcs(reinterpret_cast<float2*>(p + hf * 8 * ld + 8 * j),
             make_float2(v(4 * j + 2 * hf), v(4 * j + 2 * hf + 1)));
}

// Write v4 (accumulators 4j..4j+3: rows r0, r0 + 8, columns col, col + 1)
// as bf16 into the activation tile, and with SPLIT their lo terms into the
// lo tile LO bytes past it.
template <bool SPLIT = false, int LO = 0>
__device__ __forceinline__ void put4(unsigned char* act, int r0, int col,
                                     const float (&v4)[4]) {
  put2_s<SPLIT, LO>(act, r0, col, v4[0], v4[1]);
  put2_s<SPLIT, LO>(act, r0 + 8, col, v4[2], v4[3]);
}

// Sum a row partial over the 4 lanes that share the row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The act'(z) of one layer that a consumer thread reads back from its
// scratch slot dl: accumulators 4j..4j+3 in d[j], loaded in batches of SB
// float4, each batch issued one batch ahead of its use (the first before
// the product that precedes the epilogue), so that device memory's latency
// hides behind the product and the epilogue.
constexpr int SB = NWG / 8 < 8 ? NWG / 8 : 8;

__device__ __forceinline__ void scratch_batch(float4 (&d)[SB],
                                              const float4* dl, int b) {
#pragma unroll
  for (int jj = 0; jj < SB; ++jj) d[jj] = scratch_ld(dl + (SB * b + jj) * NC);
}

// g = act'(z) u into the activation tile (with SPLIT its hi and lo terms)
// for the NWG / 2 accumulators of u in acc, act'(z) from the thread's scratch
// slot dl, whose first batch is in dn; acc keeps u.
template <bool SPLIT, int LO>
__device__ __forceinline__ void g_from_scratch(const float (&acc)[NWG / 2],
                                               float4 (&dn)[SB],
                                               const float4* dl,
                                               unsigned char* act, int r0,
                                               int cb) {
#pragma unroll
  for (int b = 0; b < NWG / 8 / SB; ++b) {
    float4 d[SB];
#pragma unroll
    for (int jj = 0; jj < SB; ++jj) d[jj] = dn[jj];
    if (b < NWG / 8 / SB - 1) scratch_batch(dn, dl, b + 1);
#pragma unroll
    for (int jj = 0; jj < SB; ++jj) {
      const int j = SB * b + jj;
      const float g4[4] = {d[jj].x * acc[4 * j], d[jj].y * acc[4 * j + 1],
                           d[jj].z * acc[4 * j + 2], d[jj].w * acc[4 * j + 3]};
      put4<SPLIT, LO>(act, r0, cb + 8 * j, g4);
    }
  }
}

// gx columns of this warpgroup (64 of 128) from the n64 accumulators: set
// (add = false) or add to what the tile's skip layer wrote.
__device__ __forceinline__ void gx_out(const float (&c)[32], float* gx,
                                       size_t row0, int r0, int wg, int l,
                                       bool add) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float2* o = reinterpret_cast<float2*>(
          gx + (row0 + r0 + 8 * hf) * EP + wg * 64 + 8 * j + 2 * (l & 3));
      float2 v = make_float2(c[4 * j + 2 * hf], c[4 * j + 2 * hf + 1]);
      if (add) {
        const float2 w = *o;
        v = make_float2(w.x + v.x, w.y + v.y);
      }
      *o = v;
    }
}

template <bool ZS, bool HEADS, bool ZF32, bool SPLIT>
__global__ void __launch_bounds__(NTB, 1)
    trunk_fwd_grad_kernel(const __grid_constant__ FwdMaps maps,
                          const FwdArgs p) {
  constexpr int NS = fs_ring_n<SPLIT>();
  constexpr int LO = fs_lo<SPLIT>();
  typedef RingN<NS> R;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* act = smem + FS_ACT;
  unsigned char* xs = smem + FS_X;
  unsigned char* ring = smem + fs_ring<SPLIT>();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * RING_STAGE);
  uint64_t* empty = full + NS;
  float* rz = reinterpret_cast<float*>(smem + fs_rows<SPLIT>());  // [2][64]
  float* rowv = rz + 2 * T;                               // softplus'(zsig)
  // K4: [6 logits][2 wg][64], in the x tile (free in the head passes)
  float* hred = reinterpret_cast<float*>(xs);
  const int layers = p.layers, skip = p.skip, last = layers - 1;
  const int tid = threadIdx.x;
  // SPLIT: rows from a weight's hi plane to its lo plane
  const int lo_f = F, lo_mid = (layers - 2) * F;
  // act'(z) of layers 0..L-2 (K4: 0..L-1): accumulators 4j..4j+3 of
  // consumer thread c of layer s as the float4 (s * NWG / 8 + j) * NC + c
  // of slot_base, so that a warp writes 512 contiguous bytes
  const int slots = HEADS ? layers : layers - 1;
  float* slot_base =
      p.scratch + (size_t)blockIdx.x * slots * (NWG / 2) * NC;

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
      produce_copy(p.x + (size_t)row0 * EP, r, full, empty, ring);
      for (int i = 0; i < layers; ++i) {
        if (i == 0)
          produce_ws<SPLIT>(&maps.w0k, false, EP / KSL, 0, 0, F, lo_f, r,
                            full, empty, ring);
        else if (i == skip)
          produce_ws<SPLIT>(&maps.wskipk, false, (EP + F) / KSL, 0, 0, F,
                            lo_f, r, full, empty, ring);
        else
          produce_ws<SPLIT>(&maps.wmidk, false, F / KSL,
                            (i < skip ? i - 1 : i - 2) * F, 0, F, lo_mid, r,
                            full, empty, ring);
      }
      if constexpr (HEADS) {
        produce_ws<SPLIT>(&maps.wfk, false, F / KSL, 0, 0, F, F, r, full,
                          empty, ring);
        for (int q = 0; q < 4; ++q)
          produce_ws<SPLIT>(q == 0 ? &maps.w1rk : &maps.w1pk, false, F / KSL,
                            q == 0 ? 0 : (q - 1) * HID, 0, HID,
                            q == 0 ? HID : 3 * HID, r, full, empty, ring);
      }
      for (int i = last; i >= 1; --i) {
        if (i == skip) {
          produce_ws<SPLIT>(&maps.wskipm, true, F / KSL, 0, 0, EP, lo_f, r,
                            full, empty, ring);
          produce_ws<SPLIT>(&maps.wskipm, true, F / KSL, 0, EP, F, lo_f, r,
                            full, empty, ring);
        } else {
          produce_ws<SPLIT>(&maps.wmidm, true, F / KSL,
                            (i < skip ? i - 1 : i - 2) * F, 0, F, lo_mid, r,
                            full, empty, ring);
        }
      }
      produce_ws<SPLIT>(&maps.w0m, true, F / KSL, 0, 0, EP, lo_f, r, full,
                        empty, ring);
    }
    return;
  }

  // --------------------------------------------------------- consumers
  sm90::setmaxnreg_inc<232>();
  const int wg = tid >> 7, t = tid & 127, w = t >> 5, l = t & 31;
  const bool leader = l == 0, issuer = tid == 0;
  const int r0 = w * 16 + (l >> 2);          // rows r0 and r0 + 8
  const int cb = wg * NWG + 2 * (l & 3);     // column of j = 0, e = 0
  const float* __restrict__ wsig = p.wsig;
  float4* dsc = reinterpret_cast<float4*>(slot_base) + tid;
  // ZF32: where this thread's rows of a layer's zs / us begin
  const size_t lf = (size_t)layers * F;
  R r = {0, 0};
  // the trunk products' accumulators; the gx products' 32 share the first
  // of them (at width 64 the trunk's 16 are fewer)
  float accs[NWG / 2 > 32 ? NWG / 2 : 32];
  float (&acc)[NWG / 2] = *reinterpret_cast<float(*)[NWG / 2]>(accs);

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int row0 = tile * T;
    const size_t grow0 = (size_t)row0;
    // x (f32, from the ring) into the x tile as bf16 (SPLIT: hi and lo)
    sm90::mbar_wait(&full[r.stage], r.phase);
    {
      const float4* x4 =
          reinterpret_cast<const float4*>(ring + r.stage * RING_STAGE);
      for (int i = tid; i < T * EP / 4; i += NC) {
        const int rr = (i * 4) / EP, c = (i * 4) % EP;
        const float4 v = x4[i];
        const uint32_t o = sm90::sw128_offset(rr, c, ACT_BLOCK);
        *reinterpret_cast<uint2*>(xs + o) =
            make_uint2(sm90::pack_bf2(v.x, v.y), sm90::pack_bf2(v.z, v.w));
        if constexpr (SPLIT)
          *reinterpret_cast<uint2*>(xs + LO + o) = make_uint2(
              sm90::pack_bf2(v.x - bf16_round(v.x), v.y - bf16_round(v.y)),
              sm90::pack_bf2(v.z - bf16_round(v.z), v.w - bf16_round(v.w)));
      }
    }
    release(empty, r.stage);
    r.advance();
    sm90::fence_async_smem();
    tiles_free(issuer);                        // xs written, act's stores read

    // ----------------------------------------------------------- forward
    for (int i = 0; i < layers; ++i) {
      if (i == 0)
        consume_s<NWG, 0, SPLIT, LO>(acc, xs, EP, xs, EP / KSL, false, r,
                                     full, empty, ring, wg, leader);
      else if (i == skip)
        consume_s<NWG, 0, SPLIT, LO>(acc, xs, EP, act, (EP + F) / KSL, false,
                                     r, full, empty, ring, wg, leader);
      else
        consume_s<NWG, 0, SPLIT, LO>(acc, act, F, act, F / KSL, false, r,
                                     full, empty, ring, wg, leader);
      tiles_free(issuer);                      // both products read act
      const float* __restrict__ b = layer_bias(i, skip, p.b0, p.bmid,
                                               p.bskip);
#pragma unroll
      for (int j = 0; j < NWG / 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(b + cb + 8 * j);
        acc[4 * j] += bb.x;
        acc[4 * j + 1] += bb.y;
        acc[4 * j + 2] += bb.x;
        acc[4 * j + 3] += bb.y;
      }
      if constexpr (ZS && ZF32) {
        rows_out(p.zsf + (grow0 + r0) * lf + (size_t)i * F + cb, lf,
                 [&](int k) { return acc[k]; });
      } else if constexpr (ZS) {
        store_tile_sw<NWG>(act, wg * NWG, [&](int k) { return acc[k]; });
        tile_to_global(&maps.zs, act, FA, i * F, row0, issuer);
        tiles_free(issuer);
      }
      if (i == last) break;
      const float w0s = i == 0 ? 30.f : 1.f;
      float4* dl = dsc + (size_t)i * (NWG / 8) * NC;
#pragma unroll
      for (int j = 0; j < NWG / 8; ++j) {
        float h4[4], d4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          act_eval(acc[4 * j + e], w0s, h4[e], d4[e]);
        scratch_st(dl + j * NC, make_float4(d4[0], d4[1], d4[2], d4[3]));
        put4<SPLIT, LO>(act, r0, cb + 8 * j, h4);
      }
      sm90::fence_async_smem();
      sm90::named_sync(BAR_C, NC);             // h is the next product's A
    }

    // ------------------------ the last layer's h and the sigma head; acc
    // holds z_{L-1}
    {
      float pz[2] = {0.f, 0.f};
      float4* dl = dsc + (size_t)last * (NWG / 8) * NC;
#pragma unroll
      for (int j = 0; j < NWG / 8; ++j) {
        float h4[4], d4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          act_eval(acc[4 * j + e], 1.f, h4[e], d4[e]);
          pz[e >> 1] += (SPLIT ? h4[e] : bf16_round(h4[e])) *
                        wsig[cb + 8 * j + (e & 1)];
        }
        if (HEADS)
          scratch_st(dl + j * NC, make_float4(d4[0], d4[1], d4[2], d4[3]));
        if (!HEADS && !p.feats_bf16) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<float2*>(
                static_cast<float*>(p.feats) +
                (grow0 + r0 + 8 * hf) * F + cb + 8 * j) =
                make_float2(h4[2 * hf], h4[2 * hf + 1]);
        } else {
          put4<SPLIT, LO>(act, r0, cb + 8 * j, h4);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float v = quad_sum(pz[hf]);
        if ((l & 3) == 0) rz[wg * T + r0 + 8 * hf] = v;
      }
    }
    if (!HEADS && p.feats_bf16)
      tile_to_global(&maps.feats, act, FA, 0, row0, issuer);
    else
      sm90::fence_async_smem();
    sm90::named_sync(BAR_C, NC);               // rz, and h in act
    float sp = 0.f;                            // softplus(zsig), tid < 64
    if (tid < T) {
      const float z = (rz[tid] + rz[T + tid]) + p.bsig[0];
      sp = softplus(z);
      if (!HEADS) p.sigma[grow0 + tid] = sp;
      const float sg = 1.f / (1.f + expf(-z));            // softplus'(zsig)
      rowv[tid] = SPLIT ? sg : bf16_round(sg);
    }

    if constexpr (HEADS) {
      // ---------------------------------------------- xf = h W_f^T + b_f
      consume_s<NWG, 0, SPLIT, LO>(acc, act, F, act, F / KSL, false, r, full,
                                   empty, ring, wg, leader);
      tiles_free(issuer);
      const float* __restrict__ bfv = p.bf;
      store_tile_s<NWG, SPLIT, LO>(act, wg * NWG, [&](int k) {
        return acc[k] + bfv[cb + 8 * (k >> 2) + (k & 1)];
      });
      sm90::fence_async_smem();
      sm90::named_sync(BAR_C, NC);

      // ------ the rgb head (q = 0) and the three RPV heads (q = 1..3):
      // hidden = act(xf W_1^T + b_1) in HID-column passes, HWG columns a
      // warpgroup; each logit is a row reduction of bf16(hidden) against
      // its second-layer row (SPLIT: of the f32 hidden against the f32 row)
      float (&ah)[HWG / 2] = *reinterpret_cast<float(*)[HWG / 2]>(acc);
      const int cq = wg * HWG + 2 * (l & 3);   // column of j = 0 in a pass
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        consume_s<HWG, 0, SPLIT, LO>(ah, act, F, act, F / KSL, false, r,
                                     full, empty, ring, wg, leader);
        const float* __restrict__ b1 = q == 0 ? p.b1r : p.b1p + (q - 1) * HID;
        float pr[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
        for (int j = 0; j < HWG / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = cq + 8 * j + (e & 1);
            float h, d;
            act_eval(ah[4 * j + e] + b1[col], 1.f, h, d);
            const float hb = SPLIT ? h : bf16_round(h);
            if (q == 0) {
#pragma unroll
              for (int c = 0; c < 3; ++c)
                pr[c][e >> 1] += hb * w2_at<SPLIT>(p.w2r, c * HID + col);
            } else {
              pr[0][e >> 1] +=
                  hb * w2_at<SPLIT>(p.w2p, (q - 1) * 3 * HID +
                                               (q - 1) * HID + col);
            }
          }
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            if (q > 0 && c > 0) continue;
            const float v = quad_sum(pr[c][hf]);
            if ((l & 3) == 0)
              hred[((q == 0 ? c : 2 + q) * 2 + wg) * T + r0 + 8 * hf] = v;
          }
      }
      // act'(z_{L-1}) for the chain's seed below
      float4 dn[SB];
      const float4* dl = dsc + (size_t)last * (NWG / 8) * NC;
      scratch_batch(dn, dl, 0);
      tiles_free(issuer);                      // hred; act (xf) read
      if (tid < T) {
        float s[6];
#pragma unroll
        for (int c = 0; c < 6; ++c)
          s[c] = hred[(c * 2) * T + tid] + hred[(c * 2 + 1) * T + tid];
        float4* o = reinterpret_cast<float4*>(p.out + (grow0 + tid) *
                                                          HEAD_COLS);
        o[0] = make_float4(sp, s[0] + p.b2r[0], s[1] + p.b2r[1],
                           s[2] + p.b2r[2]);
        o[1] = make_float4(s[3] + p.b2p[0], s[4] + p.b2p[1], s[5] + p.b2p[2],
                           0.f);
      }
      // ------ the chain's seed: g_{L-1} = act'(z_{L-1}) u, with act' from
      // the scratch
#pragma unroll
      for (int k = 0; k < NWG / 2; ++k)
        acc[k] = rowv[r0 + 8 * ((k >> 1) & 1)] *
                 wsig[cb + 8 * (k >> 2) + (k & 1)];
      g_from_scratch<SPLIT, LO>(acc, dn, dl, act, r0, cb);
    } else {
      // ------ the chain's seed: g_{L-1} = act'(z_{L-1}) u, act' recomputed
      // from z_{L-1} in acc
      tiles_free(issuer);                      // rowv; the feats stores read
      auto u_of = [&](int k) {
        return rowv[r0 + 8 * ((k >> 1) & 1)] *
               wsig[cb + 8 * (k >> 2) + (k & 1)];
      };
      if constexpr (ZS && ZF32) {
        rows_out(p.usf + (grow0 + r0) * lf + (size_t)last * F + cb, lf,
                 u_of);
      } else if constexpr (ZS) {
        store_tile_sw<NWG>(act, wg * NWG, u_of);
        tile_to_global(&maps.us, act, FA, last * F, row0, issuer);
        tiles_free(issuer);
      }
#pragma unroll
      for (int j = 0; j < NWG / 8; ++j) {
        float g4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float h, d;
          act_eval(acc[4 * j + e], 1.f, h, d);
          g4[e] = d * u_of(4 * j + e);
        }
        put4<SPLIT, LO>(act, r0, cb + 8 * j, g4);
      }
    }
    sm90::fence_async_smem();
    sm90::named_sync(BAR_C, NC);               // g is the next product's A

    // -------------------------------------------------- the reverse chain
    for (int i = last; i >= 1; --i) {
      // act'(z_{i-1}) for this step's epilogue: its first batch is in
      // flight while the product runs
      float4 dn[SB];
      const float4* dl = dsc + (size_t)(i - 1) * (NWG / 8) * NC;
      scratch_batch(dn, dl, 0);
      if (i == skip) {
        // the encoding's share through the skip input: gx = g . Wskip_top
        // (in the first 32 accumulators, which the next product overwrites)
        float (&c)[32] = *reinterpret_cast<float(*)[32]>(accs);
        consume_s<64, 1, SPLIT, LO>(c, act, F, act, F / KSL, false, r, full,
                                    empty, ring, wg, leader);
        gx_out(c, p.gx, grow0, r0, wg, l, false);
      }
      consume_s<NWG, 1, SPLIT, LO>(acc, act, F, act, F / KSL, false, r, full,
                                   empty, ring, wg, leader);
      tiles_free(issuer);                      // act (g) read by both
      if constexpr (ZS && ZF32 && !HEADS) {
        rows_out(p.usf + (grow0 + r0) * lf + (size_t)(i - 1) * F + cb, lf,
                 [&](int k) { return acc[k]; });
      } else if constexpr (ZS && !HEADS) {
        store_tile_sw<NWG>(act, wg * NWG, [&](int k) { return acc[k]; });
        tile_to_global(&maps.us, act, FA, (i - 1) * F, row0, issuer);
        tiles_free(issuer);
      }
      // g_{i-1} = act'(z_{i-1}) * u_{i-1}
      g_from_scratch<SPLIT, LO>(acc, dn, dl, act, r0, cb);
      sm90::fence_async_smem();
      sm90::named_sync(BAR_C, NC);
    }
    // layer 0: gx += g_0 . w0
    {
      float (&c)[32] = *reinterpret_cast<float(*)[32]>(accs);
      consume_s<64, 1, SPLIT, LO>(c, act, F, act, F / KSL, false, r, full,
                                  empty, ring, wg, leader);
      gx_out(c, p.gx, grow0, r0, wg, l, true);
    }
  }
  if (issuer) sm90::bulk_wait<0>();
}

// The kernel's tensor maps; false where the driver refuses one.
template <bool HEADS>
bool fwd_maps(const FwdArgs& p, FwdMaps* m) {
  using sm90host::map_2d;
  const uint64_t planes = p.split ? 2 : 1;
  const uint64_t mids = (uint64_t)(p.layers - 2) * F * planes;
  const uint64_t fp = F * planes;
  const uint64_t n = (uint64_t)p.n_tiles * T, lf = (uint64_t)p.layers * F;
  bool ok = map_2d(&m->w0k, p.w0, fp, EP, EP, BOX_N, KSL, 64) &&
            map_2d(&m->wmidk, p.wmid, mids, F, F, BOX_N, KSL, 64) &&
            map_2d(&m->wskipk, p.wskip, fp, EP + F, EP + F, BOX_N, KSL, 64) &&
            map_2d(&m->w0m, p.w0, fp, EP, EP, KSL, 32, 64) &&
            map_2d(&m->wmidm, p.wmid, mids, F, F, KSL, 32, 64) &&
            map_2d(&m->wskipm, p.wskip, fp, EP + F, EP + F, KSL, 32, 64);
  if (p.zs)
    ok = ok && map_2d(&m->zs, p.zs, n, lf, lf, T, 64, 128) &&
         (HEADS || map_2d(&m->us, p.us, n, lf, lf, T, 64, 128));
  if (!HEADS && p.feats_bf16)
    ok = ok && map_2d(&m->feats, p.feats, n, F, F, T, 64, 128);
  if (HEADS)
    ok = ok && map_2d(&m->wfk, p.wf, fp, F, F, BOX_N, KSL, 64) &&
         map_2d(&m->w1rk, p.w1r, HID * planes, F, F, BOX_N, KSL, 64) &&
         map_2d(&m->w1pk, p.w1p, 3 * HID * planes, F, F, BOX_N, KSL, 64);
  return ok;
}

template <bool ZS, bool HEADS, bool ZF32, bool SPLIT>
int launch_fwd_kernel(const FwdArgs& p, const FwdMaps& maps, int n_blocks,
                      void* stream) {
  auto kernel = trunk_fwd_grad_kernel<ZS, HEADS, ZF32, SPLIT>;
  const int smem = fwd_smem<SPLIT>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_blocks, NTB, smem, static_cast<cudaStream_t>(stream)>>>(maps, p);
  return (int)cudaGetLastError();
}

// Launch K2 (HEADS = false) or K4 on `stream`; returns a cudaError_t.  zs
// and us are bf16 (p.zs, p.us), f32 (p.zsf, p.usf) or neither; K4 saves no
// us, and the split instantiations no bf16 zs/us or feats (their contract
// stores f32).
template <bool HEADS>
int launch_fwd(const FwdArgs& p, int n_rows, int n_blocks, void* stream) {
  const bool zb = p.zs != nullptr, zf = p.zsf != nullptr;
  const bool ub = p.us != nullptr, uf = p.usf != nullptr;
  if (n_rows <= 0 || n_rows % T != 0 || n_blocks <= 0 || p.layers < 3 ||
      p.skip <= 0 || p.skip >= p.layers || (zb && zf) ||
      (HEADS ? (ub || uf) : (zb != ub || zf != uf)) ||
      (p.split && (zb || p.feats_bf16)))
    return (int)cudaErrorInvalidValue;
  FwdMaps maps;
  if (!fwd_maps<HEADS>(p, &maps)) return (int)cudaErrorInvalidValue;
  if constexpr (HEADS) {
    if (p.split)
      return zf ? launch_fwd_kernel<true, true, true, true>(p, maps, n_blocks,
                                                            stream)
                : launch_fwd_kernel<false, true, false, true>(p, maps,
                                                              n_blocks,
                                                              stream);
    if (zf) return launch_fwd_kernel<true, true, true, false>(p, maps,
                                                              n_blocks, stream);
    if (zb) return launch_fwd_kernel<true, true, false, false>(p, maps,
                                                               n_blocks, stream);
    return launch_fwd_kernel<false, true, false, false>(p, maps, n_blocks,
                                                        stream);
  } else {
    if (p.split)
      return zf ? launch_fwd_kernel<true, false, true, true>(p, maps, n_blocks,
                                                             stream)
                : launch_fwd_kernel<false, false, false, true>(p, maps,
                                                               n_blocks,
                                                               stream);
    if (zf) return launch_fwd_kernel<true, false, true, false>(p, maps,
                                                               n_blocks, stream);
    if (zb) return launch_fwd_kernel<true, false, false, false>(p, maps,
                                                                n_blocks, stream);
    return launch_fwd_kernel<false, false, false, false>(p, maps, n_blocks,
                                                         stream);
  }
}

}  // namespace trunk
