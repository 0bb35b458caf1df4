// The warp-specialised machinery shared by the trunk kernels built on
// sm90_common.cuh: K1 (trunk_sigma.cu), the forward of K2/K4
// (trunk_fwd_grad.cuh) and the sweep of K3/K5 (trunk_bwd.cuh).  A block is three warpgroups: two consumer
// warpgroups, each owning NWG = F / 2 of the F output columns of every
// trunk product (wgmma, f32 accumulators), and a producer warpgroup of
// which one thread issues every TMA load into one ring of RING_N stages, in
// the order the consumers take them.  A product's A operand is a 64-row
// activation tile kept K-major with the 128-byte swizzle (64-column blocks
// of ACT_BLOCK bytes); its B operand is the weight slices in the ring:
// K-major boxes (32 k x BOX_N n, 64-byte swizzle) for z = h W^T, MN-major
// boxes (32 n x 32 k) for u = g W, so that no thread transposes an
// operand.  Tiles written by the
// epilogues leave by TMA stores.  The float32 instantiations (SPLIT) keep
// a lo tile beside each A tile and stream each weight as a hi and a lo
// plane: consume_s runs a product of f32 operands as three bf16 products.

#pragma once

#include "sm90_common.cuh"
#include "trunk_common.cuh"

namespace trunk {

constexpr int NC = 256;                  // consumer threads (2 warpgroups)
constexpr int NTB = NC + 128;            // + the producer warpgroup
constexpr int BAR_C = 1;                 // named barrier of the consumers
constexpr int KSL = 32;                  // k-slice of a weight stage
// 32 KB: a weight slice of 32 k x 512 n (SW64; at a smaller width the
// slice fills the stage's first F * KSL * 2 bytes), or a tile's x (64 x 128
// f32, one bulk copy)
constexpr int RING_STAGE = 32768;
static_assert(F * KSL * 2 <= RING_STAGE && T * EP * 4 == RING_STAGE,
              "a ring stage holds a weight slice or a tile's x");
constexpr int NWG = F / 2;               // columns of a consumer warpgroup
// columns of a consumer warpgroup in one of K4/K5's head passes (a head's
// HID = F / 2 hidden units, halved): a wgmma N of 16..128
constexpr int HWG = HID / 2;
constexpr int FA = F / 64;               // blocks of an F-wide tile
// rows of a K-major weight box: a warpgroup's columns, at most 256 (TMA)
constexpr int BOX_N = NWG < 256 ? NWG : 256;
constexpr int RING_N = 4;                // stages (K1: K1_RING_N)
constexpr int ACT_BLOCK = T * 64 * 2;    // one 64 x 64 SW128 block, 8 KB

// A position in a ring of NS stages: the stage and its phase parity.
template <int NS>
struct RingN {
  uint32_t stage, phase;
  __device__ __forceinline__ void advance() {
    if (++stage == NS) {
      stage = 0;
      phase ^= 1;
    }
  }
};
typedef RingN<RING_N> Ring;

// Producer: the nk k-slices of one product's B into the ring.  K-major
// (mn = false): B[k][n] = W[row0 + n][col0 + k], nw rows of n; MN-major:
// B[k][n] = W[row0 + k][col0 + n], nw columns of n.
template <class R>
__device__ __forceinline__ void produce(const CUtensorMap* map, bool mn,
                                        int nk, int row0, int col0, int nw,
                                        R& r, uint64_t* full,
                                        uint64_t* empty, unsigned char* ring) {
  for (int c = 0; c < nk; ++c) {
    sm90::mbar_wait(&empty[r.stage], r.phase ^ 1);
    unsigned char* s = ring + r.stage * RING_STAGE;
    sm90::mbar_expect_tx(&full[r.stage], nw * KSL * 2);
    if (!mn) {
      for (int h = 0; h < nw / BOX_N; ++h)
        sm90::tma_load_2d(s + h * BOX_N * KSL * 2, map, &full[r.stage],
                          col0 + c * KSL, row0 + h * BOX_N);
    } else {
      for (int nb = 0; nb < nw / 32; ++nb)
        sm90::tma_load_2d(s + nb * 32 * KSL * 2, map, &full[r.stage],
                          col0 + nb * 32, row0 + c * KSL);
    }
    r.advance();
  }
}

// Producer: one ring stage of contiguous global memory from src (16-byte
// aligned), one bulk copy.
template <class R>
__device__ __forceinline__ void produce_copy(const void* src, R& r,
                                             uint64_t* full, uint64_t* empty,
                                             unsigned char* ring) {
  sm90::mbar_wait(&empty[r.stage], r.phase ^ 1);
  sm90::mbar_expect_tx(&full[r.stage], RING_STAGE);
  sm90::bulk_load(ring + r.stage * RING_STAGE, src, RING_STAGE,
                  &full[r.stage]);
  r.advance();
}

// Consumers: release a ring stage, one arrival per warp.
__device__ __forceinline__ void release(uint64_t* empty, uint32_t stage) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) sm90::mbar_arrive(&empty[stage]);
}

// Producer: a product's B, and with SPLIT (the f32 instantiations, whose
// weights are packed as a hi and a lo bf16 plane, the lo plane lo_rows rows
// below the hi one in the same tensor map) the hi slices, then the lo ones.
template <bool SPLIT, class R>
__device__ __forceinline__ void produce_s(const CUtensorMap* map, bool mn,
                                          int nk, int row0, int col0, int nw,
                                          int lo_rows, R& r, uint64_t* full,
                                          uint64_t* empty,
                                          unsigned char* ring) {
  produce(map, mn, nk, row0, col0, nw, r, full, empty, ring);
  if constexpr (SPLIT)
    produce(map, mn, nk, row0 + lo_rows, col0, nw, r, full, empty, ring);
}

// K-major SW128 descriptor of k position kk (a multiple of 16) in a tile
// of 64-column blocks
__device__ __forceinline__ uint64_t a_desc(const unsigned char* tile,
                                           int kk) {
  return sm90::make_desc(tile + (kk >> 6) * ACT_BLOCK + ((kk & 63) >> 4) * 32,
                         16, 1024, 1);
}

// Consumer: acc (+)= A . B over nk slices from the ring, this warpgroup's
// NW columns.  A: the tile a0 for k < ka0, then a1 (each K-major SW128).
// accumulate = false overwrites acc.  LO > 0 (K1) adds a second product
// on the same B for every k16 step, with A read LO bytes past the first:
// the low bf16 halves of a split f32 operand.  Returns with every product
// of both warpgroups issued by this one complete; the caller syncs the
// consumers before it rewrites A.
template <int NW, int TB, int LO = 0, class R>
__device__ __forceinline__ void consume(float (&acc)[NW / 2],
                                        const unsigned char* a0, int ka0,
                                        const unsigned char* a1, int nk,
                                        bool accumulate, R& r,
                                        uint64_t* full, uint64_t* empty,
                                        const unsigned char* ring, int wg,
                                        bool leader) {
  uint32_t prev = 0;
  for (int c = 0; c < nk; ++c) {
    sm90::mbar_wait(&full[r.stage], r.phase);
    const unsigned char* s = ring + r.stage * RING_STAGE;
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int kk = c * KSL + ks * 16;
      const uint64_t da = kk < ka0 ? a_desc(a0, kk) : a_desc(a1, kk - ka0);
      const uint64_t db =
          TB == 0 ? sm90::make_desc(s + wg * NW * KSL * 2 + ks * 32, 16, 512,
                                    2)
                  : sm90::make_desc(s + wg * (NW / 32) * 2048 + ks * 1024,
                                    2048, 512, 2);
      const int sc = (accumulate || c > 0 || ks > 0) ? 1 : 0;
      sm90::wgmma_n<NW, 0, TB>(acc, da, db, sc);
      // (the descriptor's start address is bits 0-13, in 16-byte units)
      if constexpr (LO > 0)
        sm90::wgmma_n<NW, 0, TB>(acc, da + (uint64_t)(LO >> 4), db, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    if (c > 0 && leader) sm90::mbar_arrive(&empty[prev]);
    prev = r.stage;
    r.advance();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_acc(acc);
  if (leader) sm90::mbar_arrive(&empty[prev]);
}

// Consumer: consume(), and with SPLIT the product of f32 operands on bf16
// tensor cores: A as hi and lo bf16 terms (A_lo LO bytes past A_hi), B as
// the hi and lo planes (produce_s), three products into one f32
// accumulator: A_hi . B_hi + A_lo . B_hi over the hi slices, then
// A_hi . B_lo over the lo slices.  The dropped A_lo . B_lo and the
// split's residuals are about 2^-17 of each product.
template <int NW, int TB, bool SPLIT, int LO, class R>
__device__ __forceinline__ void consume_s(float (&acc)[NW / 2],
                                          const unsigned char* a0, int ka0,
                                          const unsigned char* a1, int nk,
                                          bool accumulate, R& r,
                                          uint64_t* full, uint64_t* empty,
                                          const unsigned char* ring, int wg,
                                          bool leader) {
  if constexpr (SPLIT) {
    consume<NW, TB, LO>(acc, a0, ka0, a1, nk, accumulate, r, full, empty,
                        ring, wg, leader);
    consume<NW, TB>(acc, a0, ka0, a1, nk, true, r, full, empty, ring, wg,
                    leader);
  } else {
    consume<NW, TB>(acc, a0, ka0, a1, nk, accumulate, r, full, empty, ring,
                    wg, leader);
  }
}

// Write this warpgroup's accumulator columns (NW of them from colbase), as
// bf16 of v(i) for accumulator i, into a K-major SW128 tile with stmatrix.
template <int NW, class V>
__device__ __forceinline__ void store_tile_sw(unsigned char* tile,
                                              int colbase, V v) {
  const int t = threadIdx.x & 127, w = t >> 5, l = t & 31;
  const int mi = l >> 3;
  const int row = w * 16 + (mi & 1) * 8 + (l & 7);
#pragma unroll
  for (int jj = 0; jj < NW / 16; ++jj) {
    const int j = 2 * jj;
    const int col = colbase + 8 * (j + (mi >> 1));
    sm90::stmatrix_x4(tile + sm90::sw128_offset(row, col, ACT_BLOCK),
                      sm90::pack_bf2(v(4 * j), v(4 * j + 1)),
                      sm90::pack_bf2(v(4 * j + 2), v(4 * j + 3)),
                      sm90::pack_bf2(v(4 * j + 4), v(4 * j + 5)),
                      sm90::pack_bf2(v(4 * j + 6), v(4 * j + 7)));
  }
}

// store_tile_sw of v's bf16 terms: hi = bf16(v) into tile and, with
// SPLIT, lo = bf16(v - hi) into the tile LO bytes past it.
template <int NW, bool SPLIT, int LO, class V>
__device__ __forceinline__ void store_tile_s(unsigned char* tile,
                                             int colbase, V v) {
  store_tile_sw<NW>(tile, colbase, v);
  if constexpr (SPLIT)
    store_tile_sw<NW>(tile + LO, colbase,
                      [&](int k) { return v(k) - bf16_round(v(k)); });
}

// Two values a, b (columns col, col + 1 of row `row`) into a K-major SW128
// tile as bf16, and with SPLIT their lo terms LO bytes past it.
template <bool SPLIT, int LO>
__device__ __forceinline__ void put2_s(unsigned char* tile, int row, int col,
                                       float a, float b) {
  const uint32_t o = sm90::sw128_offset(row, col, ACT_BLOCK);
  *reinterpret_cast<uint32_t*>(tile + o) = sm90::pack_bf2(a, b);
  if constexpr (SPLIT)
    *reinterpret_cast<uint32_t*>(tile + LO + o) =
        sm90::pack_bf2(a - bf16_round(a), b - bf16_round(b));
}

// Consumers: hand the tile just written to the async proxy and store its
// nb 64-column blocks to global rows row0.. of `map` from column col0.
__device__ __forceinline__ void tile_to_global(const CUtensorMap* map,
                                               const unsigned char* tile,
                                               int nb, int col0, int row0,
                                               bool issuer) {
  sm90::fence_async_smem();
  sm90::named_sync(BAR_C, NC);
  if (issuer) {
    for (int b = 0; b < nb; ++b)
      sm90::tma_store_2d(map, tile + b * ACT_BLOCK, col0 + b * 64, row0);
    sm90::bulk_commit();
  }
}

// Consumers: wait until every TMA store has read its tile, then sync.
__device__ __forceinline__ void tiles_free(bool issuer) {
  if (issuer) sm90::bulk_wait_read<0>();
  sm90::named_sync(BAR_C, NC);
}

}  // namespace trunk
