// Streaming tall-apply C = A B: tall f32 A (M x K), small f32 B (K x N).
//
// Replaces: src/repro/kernels/matvec.py, _tall_apply_kernel / tall_apply
// (Pallas, TPU).
//
// What bounds it on the H100: 2 M K N flops against 4 M (K + N) bytes.  At
// the main path's planar shape (M x 144) . (144 x 144) that is 36 flops per
// byte, above the f32 ridge of 20, so the f32 FMA rate bounds it.
//
// Design: as on the TPU, the grid runs over row tiles of A and the small B
// stays on chip: block (i, j) stages the K x 64 column slab j of B in
// dynamic shared memory once (K = 144 gives 36 KB), then streams its 64-row
// tile of A through 16-deep steps.  Wider B is tiled over N by grid.y; a K
// too deep for the slab to fit in shared memory is refused by the Python
// wrapper before launch.  Above 48 KB the kernel's dynamic shared-memory
// limit is raised with cudaFuncSetAttribute.  Rows of the slab beyond K are
// zero, so the inner step needs no bounds check.
#include "tile.cuh"

namespace repro {

__global__ void __launch_bounds__(THREADS)
tall_apply_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int m, int k, int kpad, int n,
                  int bf16) {
  extern __shared__ float smem[];
  float* Bs = smem;              // [kpad][BN]: Bs[k][j] = B[k][j0 + j]
  float* As = smem + kpad * BN;  // [BK][BM + PAD]: As[k][i] = A[i0 + i][k0 + k]
  const int i0 = blockIdx.x * BM, j0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int idx = threadIdx.x; idx < kpad * BN; idx += THREADS) {
    const int kk = idx / BN, jj = idx % BN;
    float v = 0.f;
    if (kk < k && j0 + jj < n) v = b[(size_t)kk * n + j0 + jj];
    Bs[idx] = round_operand(v, bf16);
  }

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[r][q] = 0.f;

  for (int k0 = 0; k0 < kpad; k0 += BK) {
    for (int idx = threadIdx.x; idx < BK * BM; idx += THREADS) {
      const int ii = idx / BK, kk = idx % BK;
      float v = 0.f;
      if (i0 + ii < m && k0 + kk < k) v = a[(size_t)(i0 + ii) * k + k0 + kk];
      As[kk * (BM + PAD) + ii] = round_operand(v, bf16);
    }
    __syncthreads();
    tile_step(As, BM + PAD, Bs + k0 * BN, BN, tx, ty, acc);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int j = j0 + tx + 16 * q;
      if (i < m && j < n) c[(size_t)i * n + j] = acc[r][q];
    }
  }
}

}  // namespace repro

// Shared memory the launch needs for a reduction depth k (bytes).
extern "C" int repro_tall_apply_smem_bytes(int k) {
  using namespace repro;
  const int kpad = (k + BK - 1) / BK * BK;
  return (kpad * BN + BK * (BM + PAD)) * static_cast<int>(sizeof(float));
}

// a: (m, k) f32 row-major; b: (k, n) f32 row-major; c: (m, n) f32.
// Returns cudaGetLastError (or the attribute call's error).
extern "C" int repro_tall_apply_f32(const void* a, const void* b, void* c,
                                   int m, int k, int n, int bf16,
                                   void* stream) {
  using namespace repro;
  const int kpad = (k + BK - 1) / BK * BK;
  const int smem = repro_tall_apply_smem_bytes(k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tall_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  tall_apply_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), m, k, kpad, n, bf16);
  return static_cast<int>(cudaGetLastError());
}
