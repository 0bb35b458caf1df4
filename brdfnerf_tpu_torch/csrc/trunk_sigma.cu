// Kernel K1: the siren trunk + sigma head, forward only, for the two
// sigma-only passes of a spsbrdf render (the guided depth probe and the
// analytic sun march).
//
// Replaces: brdfnerf_tpu/ops/pallas_mlp.py::_trunk_kernel (pallas_call at
// pallas_mlp.py:201).
//
// Rounding: the Pallas kernel multiplies f32 activations (and the f32
// encoded input) by bf16 weights, since jnp.dot promotes them, and so does
// the plain twin ops/fused_mlp.py::_trunk_sigma_plain.  This kernel keeps
// that arithmetic on bf16 tensor cores by splitting every f32 operand a
// into two bf16 terms, hi = bf16(a) and lo = bf16(a - hi), and running two
// products on the same weight slice, A_hi . B + A_lo . B, into one f32
// accumulator: hi + lo holds a to about 2^-16 relative, the products of
// bf16 terms are exact, and the sums are f32 (ops/fused_mlp.split_bf16 and
// _trunk_sigma_split are the plain emulation the tests hold to the twin).
//
// What bounds it on the H100: tensor-core operations.  A point costs 1.897
// M multiply-adds through 8 layers of width 512, and the split doubles
// them (7.59 MFLOP a point issued; 2.49 PFLOP at the serving pass's
// 327,680 points, 2.51 ms at 989 TFLOP/s, against 1.26 ms for the products
// themselves) while it reads 516 bytes a point.  What holds it back: the
// weight stream from L2 (3.93 MB a 64-point tile) and epilogues that do not
// overlap the products (both warpgroups work on one tile).
//
// Design (sm90_trunk.cuh, as K2's forward): a persistent grid, one 64-point
// tile at a time per block of three warpgroups.  A producer warp streams,
// in the order the consumers take them, the tile's x (f32, one bulk copy)
// and every weight slice (K-major boxes, 32 k x F n) through a ring of
// three 32 KB stages.  Two consumer warpgroups each own F / 2 of the F
// output columns (at 512: wgmma m64n256k16, 128 f32 accumulators a thread,
// setmaxnreg 232) and read A from two 64 x max(F, 128) activation tiles, hi
// and lo, kept K-major with the 128-byte swizzle; the epilogue applies bias and
// activation in registers and writes both tiles with stmatrix.  x has no
// tile of its own: at layer 0 the consumers split it into the first 128
// columns of A; at the skip layer they run the h part first (K = 512), then
// split x into A again (h has been read) and run the x part (K = 128) into
// the same accumulators, so x comes through the ring twice a tile.  The
// sigma head is a per-row reduction of the last layer's f32 activations,
// the two warpgroups' halves added in a fixed order; feats (optional) are
// stored f32 from the registers.
//
// At compute_dtype float32 the weights are f32 as well (the reference's
// exact f32 products): the split instantiation (SPLIT) takes them packed as
// a hi and a lo bf16 plane (ops/fused_mlp.pack_trunk_weights) and runs each
// product as three, A_hi . B_hi + A_lo . B_hi over the hi slices of the
// ring, then A_hi . B_lo over the lo slices (sm90_trunk.cuh consume_s): the
// same tiles and ring, twice the weight stream and 1.5 times the products
// (3.8 ms of tensor-core time at 327,680 points).
//
// TRUNK_SIGMA_HI_ONLY (measurement only, never built by the package) runs
// A_hi alone, the bf16-activation arithmetic of the design before the
// split, so that one call can time what the split costs.

#include "sm90_trunk.cuh"

namespace trunk {

constexpr int K1_RING_N = 3;              // 32 KB stages
// A's 64-column SW128 blocks: h (F columns) or x (EP)
constexpr int K1_AB = (F > EP ? F : EP) / 64;
constexpr int K1_HI = 0;                  // A_hi: K1_AB blocks, 64 KB at 512
constexpr int K1_LO_TILE = K1_AB * ACT_BLOCK;  // A_lo, the same
constexpr int K1_RING = 2 * K1_AB * ACT_BLOCK;
constexpr int K1_BAR = K1_RING + K1_RING_N * RING_STAGE;
constexpr int K1_ROWS = K1_BAR + 128;     // the sigma head's [2 wg][64 rows]
constexpr int K1_SMEM = K1_ROWS + 2 * T * 4;
static_assert(K1_SMEM <= 232448, "K1's shared memory");
#ifdef TRUNK_SIGMA_HI_ONLY
constexpr int K1_LO = 0;
#else
constexpr int K1_LO = K1_LO_TILE - K1_HI;  // bytes from A_hi to A_lo
#endif
typedef RingN<K1_RING_N> K1Ring;

struct SigmaArgs {
  const float* x;
  int n_tiles;
  const float* b0;
  const float* bmid;
  const float* bskip;
  const float* wsig;
  const float* bsig;
  float* sigma;
  float* feats;
  int layers, skip;
};

// The weights as K-major boxes (BOX_N n rows x 32 k, SW64).
struct SigmaMaps {
  CUtensorMap w0k, wmidk, wskipk;
};

// Consumers: take the tile's x (f32, 64 x 128) from the ring and write its
// hi and lo terms into the first two blocks of A_hi and A_lo, then hand
// them to the products.  The caller has synced the consumers after the
// last product that read those blocks.
__device__ __forceinline__ void x_to_tiles(unsigned char* act, K1Ring& r,
                                           uint64_t* full, uint64_t* empty,
                                           const unsigned char* ring) {
  sm90::mbar_wait(&full[r.stage], r.phase);
  const float4* x4 =
      reinterpret_cast<const float4*>(ring + r.stage * RING_STAGE);
  for (int i = threadIdx.x; i < T * EP / 4; i += NC) {
    const int rr = (i * 4) / EP, c = (i * 4) % EP;
    const float4 v = x4[i];
    const uint32_t o = sm90::sw128_offset(rr, c, ACT_BLOCK);
    *reinterpret_cast<uint2*>(act + K1_HI + o) =
        make_uint2(sm90::pack_bf2(v.x, v.y), sm90::pack_bf2(v.z, v.w));
    if constexpr (K1_LO > 0)
      *reinterpret_cast<uint2*>(act + K1_LO_TILE + o) = make_uint2(
          sm90::pack_bf2(v.x - bf16_round(v.x), v.y - bf16_round(v.y)),
          sm90::pack_bf2(v.z - bf16_round(v.z), v.w - bf16_round(v.w)));
  }
  release(empty, r.stage);
  r.advance();
  sm90::fence_async_smem();
  sm90::named_sync(BAR_C, NC);
}

template <bool SPLIT>
__global__ void __launch_bounds__(NTB, 1)
    trunk_sigma_kernel(const __grid_constant__ SigmaMaps maps,
                       const SigmaArgs p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* act = smem;
  unsigned char* ring = smem + K1_RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + K1_BAR);
  uint64_t* empty = full + K1_RING_N;
  float* rz = reinterpret_cast<float*>(smem + K1_ROWS);   // [2 wg][64 rows]
  const int layers = p.layers, skip = p.skip, last = layers - 1;
  const int tid = threadIdx.x;
  // SPLIT: rows from a weight's hi plane to its lo plane
  const int lo_f = F, lo_mid = (layers - 2) * F;

  if (tid == 0) {
    for (int s = 0; s < K1_RING_N; ++s) {
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
    K1Ring r = {0, 0};
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const float* xt = p.x + (size_t)tile * T * EP;
      produce_copy(xt, r, full, empty, ring);
      produce_s<SPLIT>(&maps.w0k, false, EP / KSL, 0, 0, F, lo_f, r, full,
                       empty, ring);
      for (int i = 1; i < layers; ++i) {
        if (i == skip) {
          // h . W_bot, then x again for x . W_top
          produce_s<SPLIT>(&maps.wskipk, false, F / KSL, 0, EP, F, lo_f, r,
                           full, empty, ring);
          produce_copy(xt, r, full, empty, ring);
          produce_s<SPLIT>(&maps.wskipk, false, EP / KSL, 0, 0, F, lo_f, r,
                           full, empty, ring);
        } else {
          produce_s<SPLIT>(&maps.wmidk, false, F / KSL,
                           (i < skip ? i - 1 : i - 2) * F, 0, F, lo_mid, r,
                           full, empty, ring);
        }
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
  K1Ring r = {0, 0};
  float acc[NWG / 2];

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const size_t grow0 = (size_t)tile * T;
    x_to_tiles(act, r, full, empty, ring);
    for (int i = 0; i < layers; ++i) {
      // (split_mm: A_hi . B + A_lo . B, and with SPLIT + A_hi . B_lo)
      auto split_mm = [&](int k, bool accumulate) {
        if constexpr (SPLIT)
          consume_s<NWG, 0, true, K1_LO>(acc, act, k, act, k / KSL,
                                         accumulate, r, full, empty, ring,
                                         wg, leader);
        else
          consume<NWG, 0, K1_LO>(acc, act, k, act, k / KSL, accumulate, r,
                                 full, empty, ring, wg, leader);
      };
      if (i == 0) {
        split_mm(EP, false);
      } else if (i == skip) {
        split_mm(F, false);
        sm90::named_sync(BAR_C, NC);           // both products read h
        x_to_tiles(act, r, full, empty, ring);
        split_mm(EP, true);
      } else {
        split_mm(F, false);
      }
      sm90::named_sync(BAR_C, NC);             // both products read A
      const float* __restrict__ b = layer_bias(i, skip, p.b0, p.bmid,
                                               p.bskip);
      const float w0s = i == 0 ? 30.f : 1.f;
#pragma unroll
      for (int j = 0; j < NWG / 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(b + cb + 8 * j);
        float d;
        act_eval(acc[4 * j] + bb.x, w0s, acc[4 * j], d);
        act_eval(acc[4 * j + 1] + bb.y, w0s, acc[4 * j + 1], d);
        act_eval(acc[4 * j + 2] + bb.x, w0s, acc[4 * j + 2], d);
        act_eval(acc[4 * j + 3] + bb.y, w0s, acc[4 * j + 3], d);
      }
      if (i == last) break;
      // h into A as hi and lo terms, the next product's operand
      store_tile_sw<NWG>(act + K1_HI, wg * NWG,
                         [&](int k) { return acc[k]; });
      if constexpr (K1_LO > 0)
        store_tile_sw<NWG>(act + K1_LO_TILE, wg * NWG, [&](int k) {
          return acc[k] - bf16_round(acc[k]);
        });
      sm90::fence_async_smem();
      sm90::named_sync(BAR_C, NC);
    }

    // ------------- the sigma head from the last layer's f32 activations,
    // and the features
    const float* __restrict__ wsig = p.wsig;
    float pz[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NWG / 8; ++j) {
      const float2 ws = *reinterpret_cast<const float2*>(wsig + cb + 8 * j);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        pz[hf] += acc[4 * j + 2 * hf] * ws.x;
        pz[hf] += acc[4 * j + 2 * hf + 1] * ws.y;
        if (p.feats != nullptr)
          *reinterpret_cast<float2*>(p.feats + (grow0 + r0 + 8 * hf) * F +
                                     cb + 8 * j) =
              make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = pz[hf];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((l & 3) == 0) rz[wg * T + r0 + 8 * hf] = v;
    }
    sm90::named_sync(BAR_C, NC);
    if (tid < T)
      p.sigma[grow0 + tid] = softplus((rz[tid] + rz[T + tid]) + p.bsig[0]);
    // the next tile's first barrier (in x_to_tiles) orders these reads of
    // rz before its rewrite
  }
}

}  // namespace trunk

using namespace trunk;

// x (n_rows, 128) f32 with n_rows % 64 == 0; w0 (F, 128), wmid
// (layers-2, F, F), wskip (F, 128 + F) bf16 in (out, in) layout (F the
// library's TRUNK_F), or with split (the float32 instantiation) each as
// (2, ...): its hi and lo planes; biases f32; wsig (F,) f32; bsig (1,)
// f32.  Outputs sigma (n_rows,) f32 and, when feats is not null, feats
// (n_rows, F) f32.  One block per SM at
// most (a persistent grid).  Returns a cudaError_t.
extern "C" int trunk_sigma_launch(const float* x, int n_rows, const void* w0,
                                  const float* b0, const void* wmid,
                                  const float* bmid, const void* wskip,
                                  const float* bskip, const float* wsig,
                                  const float* bsig, float* sigma,
                                  float* feats, int layers, int skip,
                                  int split, void* stream) {
  if (n_rows <= 0 || n_rows % T != 0 || layers < 3 || skip <= 0 ||
      skip >= layers)
    return (int)cudaErrorInvalidValue;
  SigmaMaps maps;
  using sm90host::map_2d;
  const uint64_t planes = split ? 2 : 1;
  const uint64_t mids = (uint64_t)(layers - 2) * F;
  if (!(map_2d(&maps.w0k, w0, planes * F, EP, EP, BOX_N, KSL, 64) &&
        map_2d(&maps.wmidk, wmid, planes * mids, F, F, BOX_N, KSL, 64) &&
        map_2d(&maps.wskipk, wskip, planes * F, EP + F, EP + F, BOX_N, KSL,
               64)))
    return (int)cudaErrorInvalidValue;
  auto kernel = split ? trunk_sigma_kernel<true> : trunk_sigma_kernel<false>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K1_SMEM);
  if (e != cudaSuccess) return (int)e;
  const SigmaArgs p = {x,     n_rows / T, b0,    bmid,   bskip, wsig,
                       bsig,  sigma,      feats, layers, skip};
  const int n_tiles = n_rows / T;
  kernel<<<n_tiles < sms ? n_tiles : sms, NTB, K1_SMEM,
           static_cast<cudaStream_t>(stream)>>>(maps, p);
  return (int)cudaGetLastError();
}
