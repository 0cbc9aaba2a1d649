// General tiled GEMM C = op(A) B in f32, with a deterministic split-K.
//
// Replaces: src/repro/kernels/tiled_matmul.py, _matmul_kernel /
// tiled_matmul (Pallas, TPU).
//
// What bounds it on the H100: on the main path it computes the cross term
// (Re A)^T (Im A) of the complex Gram: a 72 x 72 output with K = 82,944.
// That is 2 * 72 * 72 * K flops against 2 * 72 * K * 4 bytes, 18 flops per
// byte, just under the f32 ridge of 20: the bytes bound it, by a small
// margin.
//
// Design: the TPU kernel carries one f32 accumulator across a sequential K
// grid axis.  Here a block owns a 64 x 64 output tile and loops over its K
// range inside the block; because a 72 x 72 output has only 4 tiles, K is
// also split into `splits` fixed ranges, each block writes a private
// partial, and a second pass sums the partials in a fixed order (no
// atomics: the result is the same from run to run).  With splits = 1 the
// block writes C directly.  op(A) = A^T is read from A's own row-major
// storage (a_trans), so the cross term needs no transposed copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// Tile geometry: a block of 256 threads (16 x 16) owns a 64 x 64 output
// tile; each thread keeps a 4 x 4 register accumulator whose rows and
// columns are strided by 16, so a warp reads one shared-memory row of A as
// a broadcast and 16 consecutive words of B (no bank conflicts).  The
// reduction dimension is staged through shared memory 16 deep.  Plain FMA
// in f32: no TF32 and no tensor cores, so an f32 operand never loses
// precision.

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 16;        // reduction depth staged per step
constexpr int THREADS = 256;  // 16 x 16
constexpr int TM = 4;         // accumulator rows per thread (stride 16)
constexpr int TN = 4;         // accumulator columns per thread (stride 16)
constexpr int PAD = 4;        // shared-memory row padding (words)

// Round a multiplicand to bf16 and back when the mixed policy asks for it;
// products of two bf16 values are exact in f32, so accumulation stays f32.
__device__ __forceinline__ float round_operand(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// acc[r][c] += sum_kk As[kk][ty + 16 r] * Bs[kk][tx + 16 c] over one staged
// BK-deep step.  As rows have stride lda_s, Bs rows stride ldb_s (words).
__device__ __forceinline__ void tile_step(const float* As, int lda_s,
                                          const float* Bs, int ldb_s,
                                          int tx, int ty,
                                          float acc[TM][TN]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float av[TM], bv[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) av[r] = As[kk * lda_s + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < TN; ++c) bv[c] = Bs[kk * ldb_s + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <bool TRANS_A>
__global__ void __launch_bounds__(THREADS)
matmul_partial_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int m, int k, int n, int chunk,
                      int bf16) {
  const int i0 = blockIdx.x * BM, j0 = blockIdx.y * BN;
  const int r0 = blockIdx.z * chunk;
  const int r1 = min(k, r0 + chunk);
  __shared__ float As[BK][BM + PAD];  // As[kk][i] = op(A)[i0 + i][k0 + kk]
  __shared__ float Bs[BK][BN + PAD];  // Bs[kk][j] = B[k0 + kk][j0 + j]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  for (int k0 = r0; k0 < r1; k0 += BK) {
    for (int idx = threadIdx.x; idx < BK * BM; idx += THREADS) {
      int kk, ii;
      if (TRANS_A) {  // A stored (k, m): consecutive threads walk i
        kk = idx / BM;
        ii = idx % BM;
      } else {        // A stored (m, k): consecutive threads walk k
        ii = idx / BK;
        kk = idx % BK;
      }
      float v = 0.f;
      if (k0 + kk < r1 && i0 + ii < m)
        v = TRANS_A ? a[(size_t)(k0 + kk) * m + i0 + ii]
                    : a[(size_t)(i0 + ii) * k + k0 + kk];
      As[kk][ii] = round_operand(v, bf16);
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
      const int kk = idx / BN, jj = idx % BN;
      float v = 0.f;
      if (k0 + kk < r1 && j0 + jj < n) v = b[(size_t)(k0 + kk) * n + j0 + jj];
      Bs[kk][jj] = round_operand(v, bf16);
    }
    __syncthreads();
    tile_step(&As[0][0], BM + PAD, &Bs[0][0], BN + PAD, tx, ty, acc);
    __syncthreads();
  }

  float* dst = out + (size_t)blockIdx.z * m * n;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int j = j0 + tx + 16 * c;
      if (i < m && j < n) dst[(size_t)i * n + j] = acc[r][c];
    }
  }
}

__global__ void splitk_reduce_kernel(const float* __restrict__ work,
                                     float* __restrict__ c, size_t total,
                                     int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += work[(size_t)p * total + idx];
  c[idx] = s;
}

}  // namespace repro

// c = op(a) b with op(a) of shape (m, k): a stored (m, k) row-major, or
// (k, m) row-major when a_trans.  b: (k, n); c: (m, n).  With splits > 1,
// work holds (splits, m, n) partials and K range s is [s chunk, (s+1) chunk).
// Returns cudaGetLastError.
extern "C" int repro_tiled_matmul_f32(const void* a, const void* b, void* c,
                                     void* work, int m, int k, int n,
                                     int a_trans, int splits, int chunk,
                                     int bf16, void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, splits);
  float* dst = static_cast<float*>(splits > 1 ? work : c);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  if (a_trans)
    matmul_partial_kernel<true><<<grid, THREADS, 0, st>>>(pa, pb, dst, m, k, n,
                                                          chunk, bf16);
  else
    matmul_partial_kernel<false><<<grid, THREADS, 0, st>>>(pa, pb, dst, m, k,
                                                           n, chunk, bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = (size_t)m * n;
  splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(work), static_cast<float*>(c), total, splits);
  return static_cast<int>(cudaGetLastError());
}
