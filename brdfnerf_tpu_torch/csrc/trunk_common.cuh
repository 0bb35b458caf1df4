// The trunk kernels' shared constants and activation (every csrc/trunk_*
// source), and the machinery of K1 (trunk_sigma.cu): one thread block of 8
// warps takes a tile of 64 points through the whole 8x512 siren trunk,
// keeping the tile's current activations in shared memory as bf16 and
// multiplying on the tensor cores with mma.sync m16n8k16 (bf16 operands,
// f32 accumulation).  K2-K5 run on sm90_trunk.cuh instead.
//
// Layout of one layer product Z[64 x N] = A[64 x K] . B[K x N]:
//   * A (activations) lives in shared memory, row-major, bf16;
//   * B is a weight matrix stored (out, in) row-major in global memory (the
//     nn.Linear layout).  Forward products read it as B[k][n] = W[n][k]
//     (ldmatrix without .trans); the reverse products of the gradient chain
//     read B[k][n] = W[k][n] (ldmatrix .trans).  Slices of 32 k are staged
//     into shared memory with cp.async through a ring of 3 buffers, two
//     slices in flight, one barrier per slice;
//   * warp w owns output columns [w*N/8, (w+1)*N/8) of all 64 rows, so each
//     weight element is read from shared memory by one warp only, and a
//     thread owns the same (row, col) set in every product of width 512.
//
// The weights of the whole trunk are 4.6 MB in bf16, so they stay in the
// 50 MB L2 while every block streams through them once per tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace trunk {

typedef __nv_bfloat16 bf16;

constexpr int F = 512;           // trunk width
constexpr int EP = 128;          // encoding width, padded
constexpr int T = 64;            // points per tile
constexpr int NT = 256;          // threads per block (8 warps)
constexpr int KC = 32;           // k-slice of a staged weight chunk
constexpr int SA = F + 8;        // activation row stride (bf16); +8 keeps
constexpr int SX = EP + 8;       //   ldmatrix rows on distinct banks
constexpr int SWF = KC + 8;      // forward stage: [n < 512][k < 32]
constexpr int STAGE = F * SWF;   // elements per stage buffer (>= 32 * 520)
constexpr int NSTAGE = 3;        // stage buffers in the ring
constexpr int MT = T / 16;       // m16 tiles per warp
constexpr int ACC = MT * 8 * 4;  // f32 accumulators per thread at N = 512
constexpr int HID = F / 2;       // the flagship heads' hidden width
constexpr int HEAD_COLS = 8;     // packed head logits per point

// shared-memory carve-up (bytes)
constexpr int OFF_ACT = 0;
constexpr int OFF_X = OFF_ACT + T * SA * 2;
constexpr int OFF_W = OFF_X + T * SX * 2;
constexpr int OFF_RED = OFF_W + NSTAGE * STAGE * 2;
constexpr int OFF_ROW = OFF_RED + 8 * T * 4;
constexpr int SMEM_BYTES = OFF_ROW + T * 4;

// ------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                   "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ------------------------------------------------------------- activations

// Polynomial sine of the JAX package's ops/fast_math.py (same constants,
// same expression order; rintf rounds half to even like jnp.round).
constexpr double C1 = 9.999845867745e-01;
constexpr double C3 = -1.666325820430e-01;
constexpr double C5 = 8.312382933817e-03;
constexpr double C7 = -1.931618219602e-04;
constexpr double C9 = 2.173210068083e-06;
constexpr double TWO_PI = 6.283185307179586;
constexpr double INV_2PI = 0.15915494309189535;

// h = sin(w0 * z) by the polynomial, and d1 = d h / d z (the polynomial's
// derivative; range reduction has unit slope).
//
// TRUNK_IDENTITY_ACT (measurement only, never built by the package) swaps
// the activation for h = w0 * z, d1 = w0, leaving every load, store and
// product in place, so that brdfnerf_tpu_torch/tools/epilogue_share.py can
// time what the polynomial costs inside the kernels.
__device__ __forceinline__ void act_eval(float z, float w0, float& h,
                                         float& d1) {
  const float x = w0 * z;
#ifdef TRUNK_IDENTITY_ACT
  h = x;
  d1 = w0;
#else
  const float v = x - (float)TWO_PI * rintf(x * (float)INV_2PI);
  const float v2 = v * v;
  h = v * ((float)C1 +
           v2 * ((float)C3 +
                 v2 * ((float)C5 + v2 * ((float)C7 + v2 * (float)C9))));
  const float p1 =
      (float)C1 +
      v2 * ((float)(3 * C3) +
            v2 * ((float)(5 * C5) +
                  v2 * ((float)(7 * C7) + v2 * 9.f * (float)C9)));
  d1 = w0 * p1;
#endif
}

__device__ __forceinline__ float softplus(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
}

// ------------------------------------------------------------------ tiles

// Load a tile of 64 encoded points (f32, 128 wide) into xs as bf16.
__device__ __forceinline__ void load_x_tile(const float* __restrict__ x,
                                            bf16* xs) {
  const float4* src = reinterpret_cast<const float4*>(x);
  for (int i = threadIdx.x; i < T * EP / 4; i += NT) {
    const float4 v = src[i];
    const int r = (i * 4) / EP, c = (i * 4) % EP;
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(xs + r * SX + c);
    d[0] = __floats2bfloat162_rn(v.x, v.y);
    d[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

// The (row, col) of accumulator element e (0..3) of fragment (mt, nf) for
// this thread, in a product whose warp w owns NF n8-fragments.
template <int NF>
__device__ __forceinline__ void acc_pos(int mt, int nf, int e, int& row,
                                        int& col) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  row = mt * 16 + (lane >> 2) + (e >> 1) * 8;
  col = warp * NF * 8 + nf * 8 + (lane & 3) * 2 + (e & 1);
}

// Stage k-slice `c` of B into `sb`.  TRANS=false: B[k][n] = W[n_off+n][k]
// (forward); TRANS=true: B[k][n] = W[k][n_off+n] (reverse).  N = 64*NF.
template <int NF, bool TRANS>
__device__ __forceinline__ void stage_chunk(bf16* sb,
                                            const bf16* __restrict__ W,
                                            int ldw, int n_off, int c) {
  constexpr int N = 64 * NF;
  constexpr int SEGS = N * KC / 8;          // 16-byte segments
  const int k0 = c * KC;
#pragma unroll
  for (int j = 0; j < SEGS / NT; ++j) {
    const int s = threadIdx.x + j * NT;
    if (!TRANS) {
      const int n = s / (KC / 8), part = s % (KC / 8);
      cp_async16(sb + n * SWF + part * 8,
                 W + (size_t)(n_off + n) * ldw + k0 + part * 8);
    } else {
      const int k = s / (N / 8), part = s % (N / 8);
      cp_async16(sb + k * (N + 8) + part * 8,
                 W + (size_t)(k0 + k) * ldw + n_off + part * 8);
    }
  }
}

// acc += A . B over K = K0 + K1, A taken from a0 (k < K0) then a1.
// K0 and K1 are multiples of 32.  Slice c + 2 is staged while slice c is
// multiplied; the barrier at the top of iteration c both publishes slice c
// and retires slice c - 1, whose buffer slice c + 2 then reuses.  Ends with
// a barrier, so the caller may overwrite A (and the stage ring) after.
template <int NF, bool TRANS>
__device__ __forceinline__ void gemm(float (&acc)[MT][NF][4], const bf16* a0,
                                     int lda0, int K0, const bf16* a1,
                                     int lda1, int K1,
                                     const bf16* __restrict__ W, int ldw,
                                     int n_off, bf16* stage) {
  constexpr int N = 64 * NF;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nk = (K0 + K1) / KC;
  stage_chunk<NF, TRANS>(stage, W, ldw, n_off, 0);
  cp_async_commit();
  if (nk > 1) stage_chunk<NF, TRANS>(stage + STAGE, W, ldw, n_off, 1);
  cp_async_commit();                     // (empty when nk == 1)
  int buf = 0;
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<1>();                  // this thread's copies of slice c
    __syncthreads();
    if (c + 2 < nk)
      stage_chunk<NF, TRANS>(stage + ((buf + 2) % NSTAGE) * STAGE, W, ldw,
                             n_off, c + 2);
    cp_async_commit();                   // (empty past the last slice)
    const bf16* sb = stage + buf * STAGE;
    buf = buf + 1 == NSTAGE ? 0 : buf + 1;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      const int k = c * KC + ks;
      const bf16* ab = k < K0 ? a0 : a1;
      const int lda = k < K0 ? lda0 : lda1;
      const int kk = k < K0 ? k : k - K0;
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[mt], ab + (mt * 16 + (lane & 15)) * lda + kk +
                            (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NF / 2; ++np) {
        const int n0 = warp * NF * 8 + np * 16;
        uint32_t bfr[4];
        if (!TRANS)
          ldsm_x4(bfr, sb + (n0 + (lane & 7) + (lane >> 4) * 8) * SWF + ks +
                           ((lane >> 3) & 1) * 8);
        else
          ldsm_x4_t(bfr, sb + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  (N + 8) +
                              n0 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          mma16816(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
  }
  __syncthreads();
}

template <int NF>
__device__ __forceinline__ void zero(float (&acc)[MT][NF][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nf][e] = 0.f;
}

// The forward pre-activation of trunk layer i into acc (bias not added):
// layer 0 reads the encoded tile xs, the skip layer [xs | act], the rest act.
// Packed weights: w0 (512, 128), wmid (L-2, 512, 512), wskip (512, 640).
__device__ __forceinline__ void forward_layer(
    float (&acc)[MT][8][4], int i, int skip, const bf16* xs, const bf16* act,
    const bf16* __restrict__ w0, const bf16* __restrict__ wmid,
    const bf16* __restrict__ wskip, bf16* stage) {
  zero<8>(acc);
  if (i == 0) {
    gemm<8, false>(acc, xs, SX, EP, nullptr, 0, 0, w0, EP, 0, stage);
  } else if (i == skip) {
    gemm<8, false>(acc, xs, SX, EP, act, SA, F, wskip, EP + F, 0, stage);
  } else {
    const int mid = i < skip ? i - 1 : i - 2;
    gemm<8, false>(acc, act, SA, F, nullptr, 0, 0, wmid + (size_t)mid * F * F,
                   F, 0, stage);
  }
}

__device__ __forceinline__ const float* layer_bias(int i, int skip,
                                                   const float* b0,
                                                   const float* bmid,
                                                   const float* bskip) {
  if (i == 0) return b0;
  if (i == skip) return bskip;
  return bmid + (size_t)(i < skip ? i - 1 : i - 2) * F;
}

// Sum the per-thread row partials `part[mt][half]` across the 4 lanes
// sharing a row, and leave each warp's row sums in red[warp * 64 + row].
__device__ __forceinline__ void quad_rows(float (&part)[MT][2], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = part[mt][hf];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0) red[warp * T + mt * 16 + (lane >> 2) + hf * 8] = v;
    }
}

// Sum the per-thread row partials `part[mt][half]` of the sigma head over
// the tile's 512 columns: across the 4 lanes sharing a row, then across the
// 8 warps in a fixed order (deterministic).  Returns, for threads < 64, the
// row sum of row threadIdx.x; red is 8 x 64 floats of shared memory.
__device__ __forceinline__ float sigma_rows(float (&part)[MT][2], float* red) {
  quad_rows(part, red);
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < T)
    for (int w = 0; w < 8; ++w) s += red[w * T + threadIdx.x];
  return s;
}

}  // namespace trunk

// Each library built from a source that includes this header exports it.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
