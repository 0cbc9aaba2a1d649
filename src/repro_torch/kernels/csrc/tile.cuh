// Shared tile geometry of the three hand-written f32 GEMM-shaped kernels.
//
// A block of 256 threads (16 x 16) owns a 64 x 64 output tile; each thread
// keeps a 4 x 4 register accumulator whose rows and columns are strided by
// 16, so a warp reads one shared-memory row of A as a broadcast and 16
// consecutive words of B (no bank conflicts).  The reduction dimension is
// staged through shared memory 16 deep.  Plain FMA in f32: no TF32 and no
// tensor cores, so an f32 operand never loses precision (the reference's
// "f32 accumulate, never lose operand precision" contract).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

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

}  // namespace repro
