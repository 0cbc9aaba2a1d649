// Streaming Gram matrix G = A^T A for a tall f32 operand A (M x N), N small.
//
// Replaces: src/repro/kernels/gram.py, _gram_kernel / gram (Pallas, TPU).
//
// What bounds it on the H100: the symmetric product needs M N (N + 1) flops
// against 4 M N bytes read, (N + 1) / 4 flops per byte.  The f32 ridge is
// 67 TFLOP/s / 3.35 TB/s = 20 flops per byte, so at the main path's N = 72
// (M up to 82,944) the least time is set by the bytes, by a small margin.
// The plain FMA tile below reaches a fraction of the f32 peak, so in
// practice its instruction rate bounds it.
//
// Design: the TPU kernel is one sequential reduction over M on one core.
// Here M is split into `splits` fixed row ranges; block (t, s) computes the
// 64 x 64 output tile t of rows s, for the tiles on or above the diagonal
// only (G is symmetric: half the work), and writes a private partial.  A
// second pass sums the partials in a fixed order and mirrors the upper
// triangle, so the result is exactly symmetric and bit-identical from run
// to run.  No atomics.  With N = 72 there are only 3 upper tiles, so the
// split over M is what fills the 132 SMs.
#include "tile.cuh"

namespace repro {

__global__ void __launch_bounds__(THREADS)
gram_partial_kernel(const float* __restrict__ a, float* __restrict__ work,
                    int m, int n, int chunk, int bf16) {
  const int ntile = (n + BN - 1) / BN;
  // decode the upper-triangular tile index into (ti, tj), ti <= tj
  int ti = 0, rem = blockIdx.x;
  while (rem >= ntile - ti) {
    rem -= ntile - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const int i0 = ti * BM, j0 = tj * BN;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(m, r0 + chunk);

  __shared__ float As[BK][BM + PAD];  // As[k][i] = A[r0 + k][i0 + i]
  __shared__ float Bs[BK][BN + PAD];  // Bs[k][j] = A[r0 + k][j0 + j]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  for (int k0 = r0; k0 < r1; k0 += BK) {
    for (int idx = threadIdx.x; idx < BK * BM; idx += THREADS) {
      const int kk = idx / BM, ii = idx % BM;
      const int row = k0 + kk;
      float va = 0.f, vb = 0.f;
      if (row < r1) {
        const float* arow = a + (size_t)row * n;
        if (i0 + ii < n) va = arow[i0 + ii];
        if (j0 + ii < n) vb = arow[j0 + ii];
      }
      As[kk][ii] = round_operand(va, bf16);
      Bs[kk][ii] = round_operand(vb, bf16);
    }
    __syncthreads();
    tile_step(&As[0][0], BM + PAD, &Bs[0][0], BN + PAD, tx, ty, acc);
    __syncthreads();
  }

  float* out = work + (size_t)blockIdx.y * n * n;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int j = j0 + tx + 16 * c;
      if (i < n && j < n) out[(size_t)i * n + j] = acc[r][c];
    }
  }
}

// G[i][j] = sum over splits (in order) of partial[lo][hi], lo = min(i, j).
__global__ void gram_reduce_kernel(const float* __restrict__ work,
                                   float* __restrict__ g, int n, int splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * n) return;
  const int i = idx / n, j = idx % n;
  const size_t off = (size_t)min(i, j) * n + max(i, j);
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += work[(size_t)p * n * n + off];
  g[idx] = s;
}

}  // namespace repro

// a: (m, n) f32 row-major; g: (n, n) f32; work: (splits, n, n) f32 scratch.
// Rows [s * chunk, (s + 1) * chunk) go to split s.  Returns cudaGetLastError.
extern "C" int repro_gram_f32(const void* a, void* g, void* work, int m,
                              int n, int splits, int chunk, int bf16,
                              void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntile = (n + BN - 1) / BN;
  dim3 grid(ntile * (ntile + 1) / 2, splits);
  gram_partial_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(a), static_cast<float*>(work), m, n, chunk,
      bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n * n;
  gram_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(work), static_cast<float*>(g), n, splits);
  return static_cast<int>(cudaGetLastError());
}
