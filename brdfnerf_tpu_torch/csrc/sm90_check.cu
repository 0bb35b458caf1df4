// A check of sm90_common.cuh on the card: one warpgroup loads A and B with
// TMA in the layouts the backward kernels use, runs wgmma over K = 64 and
// writes D = A . B (f32, row-major) from the accumulator layout.  The layout
// parameters (lbo, sbo) come from the caller, so that
// brdfnerf_tpu_torch/tools/sm90_check.py can hold every layout against
// torch.matmul.
//
// Modes (A is 64 x 64, B is 64 x N, both bf16 row-major in global memory
// as given: a holds A (K-major) or A^T (MN-major), b holds B^T (K-major)
// or B (MN-major)):
//   0  A K-major SW128, B K-major SW64, N = 256  (the sweep's forward)
//   1  A K-major SW128, B MN-major SW64, N = 256 (the sweep's reverse)
//   2  A MN-major SW128, B MN-major SW128, N = 256 (the weight gradients)
//   3  A K-major SW128, B K-major SW64, N = 128  (K5's head passes)

#include "sm90_common.cuh"

namespace {

__global__ void __launch_bounds__(128, 1)
    sm90_check_kernel(const __grid_constant__ CUtensorMap ma,
                      const __grid_constant__ CUtensorMap mb, float* d,
                      int mode, int lbo, int sbo) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sa = smem;                 // 8 KB
  unsigned char* sb = smem + 8192;          // 32 KB
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 8192 + 32768);
  const int tid = threadIdx.x;
  const int n = mode == 3 ? 128 : 256;
  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(bar, 8192 + 64 * n * 2);
    sm90::tma_load_2d(sa, &ma, bar, 0, 0);
    if (mode == 0 || mode == 3) {          // boxes 32 k x n rows
      sm90::tma_load_2d(sb, &mb, bar, 0, 0);
      sm90::tma_load_2d(sb + n * 64, &mb, bar, 32, 0);
    } else if (mode == 1) {                // boxes 32 n x 32 k
      for (int kh = 0; kh < 2; ++kh)
        for (int nb = 0; nb < 8; ++nb)
          sm90::tma_load_2d(sb + (kh * 8 + nb) * 2048, &mb, bar, nb * 32,
                            kh * 32);
    } else {                               // boxes 64 n x 64 k
      for (int nb = 0; nb < 4; ++nb)
        sm90::tma_load_2d(sb + nb * 8192, &mb, bar, nb * 64, 0);
    }
  }
  sm90::mbar_wait(bar, 0);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  sm90::wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint64_t da, db;
    if (mode == 2)
      da = sm90::make_desc(sa + s * 2048, lbo, sbo, 1);
    else
      da = sm90::make_desc(sa + s * 32, lbo, 1024, 1);
    if (mode == 0 || mode == 3)
      db = sm90::make_desc(sb + (s >> 1) * n * 64 + (s & 1) * 32, lbo, 512,
                           2);
    else if (mode == 1)
      db = sm90::make_desc(sb + (s >> 1) * 16384 + (s & 1) * 1024, lbo, sbo,
                           2);
    else
      db = sm90::make_desc(sb + s * 2048, lbo, sbo, 1);
    if (mode == 0) sm90::wgmma_n256<0, 0>(acc, da, db, 1);
    if (mode == 1) sm90::wgmma_n256<0, 1>(acc, da, db, 1);
    if (mode == 2) sm90::wgmma_n256<1, 1>(acc, da, db, 1);
    if (mode == 3) {
      float (&a64)[64] = *reinterpret_cast<float(*)[64]>(acc);
      sm90::wgmma_n128<0, 0>(a64, da, db, 1);
    }
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_acc(acc);
  const int w = tid >> 5, l = tid & 31;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (j * 8 >= n) continue;
      const int row = w * 16 + (l >> 2) + 8 * (e >> 1);
      const int col = j * 8 + 2 * (l & 3) + (e & 1);
      d[row * n + col] = acc[j * 4 + e];
    }
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// a, b as in the modes above; d (64, N) f32.  Returns a cudaError_t (or
// cudaErrorInvalidValue where a tensor map is refused).
extern "C" int sm90_check_launch(const void* a, const void* b, float* d,
                                 int mode, int lbo, int sbo, void* stream) {
  CUtensorMap ma, mb;
  bool ok = sm90host::map_2d(&ma, a, 64, 64, 64, 64, 64, 128);
  const int n = mode == 3 ? 128 : 256;
  if (mode == 0 || mode == 3)
    ok = ok && sm90host::map_2d(&mb, b, n, 64, 64, n, 32, 64);
  else if (mode == 1)
    ok = ok && sm90host::map_2d(&mb, b, 64, 256, 256, 32, 32, 64);
  else
    ok = ok && sm90host::map_2d(&mb, b, 64, 256, 256, 64, 64, 128);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int smem = 8192 + 32768 + 64;
  cudaError_t e = cudaFuncSetAttribute(
      sm90_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sm90_check_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      ma, mb, d, mode, lbo, sbo);
  return (int)cudaGetLastError();
}
